"""Command line (reference src/input/CLI.cpp:4-126).

    python -m real_time_ray_tracing_engine_tpu_torch --scene cornell_box

renders the scene at its own settings (the reference default: 600x600,
100 spp, depth 50; CLI.hpp:11-13) on the GPU and writes
output/<--output>.ppm. Every builtin scene renders on the GPU: the
Cornell-class ones through the unrolled kernel, bouncing_spheres (the
reference's final scene, 1200x675, 100 spp, depth 50) and textured_spheres
through the chunk scan (K6); so does a scene JSON of up to 16,384
primitives (past 64 quads through K7). -b/--bvh compiles the scene with
the SAH BVH (the reference's -b), which lifts that bound; the kernel a -b
render takes is the JAX package's choice: the chunk scan by default,
RTX_BVH_STACK=1 the stack BVH walk (K11), RTX_LANE_BVH=1 the lane BVH walk
(K12; scenes without quads, else the stack walk or the chunk scan).

The other modes, after the JAX package's CLI:
  --camera dynamic          progressive accumulation (the reference's
                            DynamicCamera): one stratum a step through the
                            same kernels, until converged or --frames
                            steps; --checkpoint f.npz resumes from f.npz
                            when it exists and saves the state there at
                            the end (refused for another scene, image
                            shape, depth or sample count)
  --camera dynamic --view   the same loop drawn live in the terminal
                            (ANSI half blocks; WASD moves, +/- samples,
                            q quits; non-interactive without a TTY)
  -d/--debug                writes logs/flat_scene_debug.json (the compiled
                            scene, golden_json) and
                            logs/scene_complexity_debug.txt before the
                            render
  -p/--parallel             the static render sharded over ranks, rows on
                            "tile" and samples on "sample"
                            (parallel/mesh.py::render_on_mesh, the JAX
                            package's default layout): under torchrun
                            (python -m torch.distributed.run
                            --nproc-per-node N -m
                            real_time_ray_tracing_engine_tpu_torch -p) the
                            launched world, else one rank per visible GPU
                            (one rank in this process on one GPU or with
                            --device cpu); rank 0 writes the PPM
--frames, --checkpoint and --view need --camera dynamic; -p needs the
static camera. --device cpu runs any mode on the CPU instead (the plain
torch engine; a -b scene through the BVH oracle); without it a missing GPU
is an error.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

# the progressive loop's flags, which need --camera dynamic
DYNAMIC_ONLY = {"view": "--view", "checkpoint": "--checkpoint",
                "frames": "--frames"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="real_time_ray_tracing_engine_tpu_torch",
        description="Monte-Carlo path tracer on PyTorch + CUDA")
    p.add_argument("--camera", choices=["static", "dynamic"], default="static",
                   help="static: render to PPM; dynamic: progressive "
                        "accumulation loop")
    p.add_argument("--output", default="output_image",
                   help="output file stem (written to output/<name>.ppm)")
    p.add_argument("--scene", default="cornell_box",
                   help="builtin scene name or scene JSON path")
    p.add_argument("--width", type=int, default=None,
                   help="image width (default: scene's, reference default 600)")
    p.add_argument("--samples", type=int, default=None,
                   help="samples per pixel (reference default 100)")
    p.add_argument("--depth", type=int, default=None,
                   help="max bounce depth (reference default 50)")
    p.add_argument("--engine", choices=["auto", "cuda", "torch"],
                   default="auto",
                   help="compute path: the CUDA megakernel or the plain "
                        "torch integrator (auto: the kernel on a GPU, where "
                        "a scene outside its gate is an error; the plain "
                        "integrator on the CPU)")
    p.add_argument("--schedule", choices=["auto", "single", "compacted"],
                   default="auto",
                   help="kernel schedule: single pass or capped + "
                        "lane-compacted (auto: compacted for >=8 samples "
                        "per pass; the static render's batches)")
    p.add_argument("--caps", type=str, default=None,
                   help="explicit compacted-schedule phase caps, e.g. "
                        "'20,20'")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    p.add_argument("-p", "--parallel", action="store_true",
                   help="shard the static render over ranks (tile x "
                        "sample): the torchrun world, else one rank per "
                        "visible GPU")
    p.add_argument("-b", "--bvh", action="store_true",
                   help="build the SAH BVH (traversed by the stack or lane "
                        "BVH kernel under RTX_BVH_STACK=1 / RTX_LANE_BVH=1, "
                        "else by the chunk scan)")
    p.add_argument("-d", "--debug", action="store_true",
                   help="dump the compiled scene (golden JSON) and a "
                        "complexity report to logs/")
    p.add_argument("--view", action="store_true",
                   help="dynamic mode: live ANSI terminal display with WASD "
                        "camera movement (the SDL-window analogue)")
    p.add_argument("--checkpoint", default=None,
                   help="dynamic mode: save/resume accumulation state (.npz)")
    p.add_argument("--frames", type=int, default=None,
                   help="dynamic mode: max steps to accumulate this run")
    return p


def load_scene_arg(name: str):
    from ..scene import builders
    from ..scene.schema import load_scene
    if name in builders.BUILTIN_SCENES:
        return builders.BUILTIN_SCENES[name]()
    if os.path.exists(name):
        return load_scene(name)
    raise SystemExit(
        f"unknown scene {name!r}; builtins: "
        f"{', '.join(sorted(builders.BUILTIN_SCENES))}")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.parallel and args.camera == "dynamic":
        parser.error("-p/--parallel shards the static render; it does not "
                     "run with --camera dynamic")
    if args.camera != "dynamic":
        wrong = [msg for flag, msg in DYNAMIC_ONLY.items()
                 if getattr(args, flag) not in (False, None)]
        if wrong:
            parser.error(f"{', '.join(wrong)} "
                         f"need{'s' if len(wrong) == 1 else ''} "
                         "--camera dynamic")

    import torch
    from ..models.render import render, resolve_device
    from ..utils.color import write_ppm

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.exit(2, f"{parser.prog}: error: {e}\n")

    scene = load_scene_arg(args.scene)
    if args.width:
        scene.camera.image_width = args.width
    if args.samples:
        scene.camera.samples_per_pixel = args.samples
    if args.depth:
        scene.camera.max_depth = args.depth
    caps = (tuple(int(c) for c in args.caps.split(","))
            if args.caps else None)

    os.makedirs("output", exist_ok=True)
    out_path = os.path.join("output", args.output + ".ppm")

    if args.debug:
        from ..scene.compile import compile_scene, golden_json
        from ..scene.analyze import dump_report
        os.makedirs("logs", exist_ok=True)
        flat = compile_scene(scene, use_bvh=args.bvh, device=device)
        with open("logs/flat_scene_debug.json", "w") as f:
            f.write(golden_json(flat))
        dump_report(scene, flat, "logs/scene_complexity_debug.txt")
        print("[DEBUG] wrote logs/flat_scene_debug.json and "
              "logs/scene_complexity_debug.txt", file=sys.stderr)

    if args.parallel:
        return _parallel(args, scene, device, caps, out_path)
    t0 = time.time()
    if args.camera == "static":
        # batch size follows the schedule: auto/compacted need >= 8 samples
        # per pass to take the compacted schedule
        spb = 4 if args.schedule == "single" else 16
        img = render(scene, device=device, seed=args.seed, use_bvh=args.bvh,
                     engine=args.engine, schedule=args.schedule,
                     samples_per_batch=spb, caps=caps,
                     progress=lambda s, t: print(f"\r[INFO] sample {s}/{t}",
                                                 end="", file=sys.stderr))
        print(file=sys.stderr)
    else:
        from ..models.render import CheckpointMismatch
        try:
            prog = _dynamic(args, scene, device)
        except CheckpointMismatch as e:
            parser.exit(2, f"{parser.prog}: error: {e}\n")
        img = prog.image()
    finite = bool(torch.isfinite(img).all())
    write_ppm(out_path, img)
    dt = time.time() - t0
    print(f"[INFO] wrote {out_path} in {dt:.1f}s", file=sys.stderr)
    if not finite:
        print("[ERROR] the image holds non-finite radiance", file=sys.stderr)
        return 1
    return 0


def _parallel(args, scene, device, caps, out_path) -> int:
    """-p: under torchrun (WORLD_SIZE set) this process is one rank of the
    launched world; otherwise one rank per visible GPU, spawned
    (parallel/distributed.py::spawn_ranks), or this process alone on one
    GPU or the CPU. Returns the exit code."""
    import torch
    if os.environ.get("WORLD_SIZE") is not None:
        return _parallel_rank(args, scene, device.type, caps, out_path)
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n <= 1:
        return _parallel_rank(args, scene, device.type, caps, out_path)
    from ..parallel.distributed import spawn_ranks
    return max(spawn_ranks(_spawned_rank, n, args, scene, caps, out_path,
                           timeout_s=None))


def _spawned_rank(rank, n, init_method, args, scene, caps, out_path) -> int:
    from ..parallel.distributed import initialize
    initialize(device="cuda", init_method=init_method, rank=rank,
               world_size=n, local_rank=rank, local_world_size=n)
    return _parallel_rank(args, scene, "cuda", caps, out_path)


def _parallel_rank(args, scene, device, caps, out_path) -> int:
    """One rank of -p: start the group (parallel/distributed.py::
    initialize; nothing for one process), compile the scene and take rank
    0's tables (replicate), render_on_mesh, report the rank's shard, its
    kernel launches and plain passes, and on rank 0 write the PPM."""
    import torch
    import torch.distributed as dist
    from ..models import camera as cam_mod
    from ..models import render as rd
    from ..ops import wavefront_cuda as wc
    from ..parallel import distributed as pdist
    from ..parallel.mesh import make_render_mesh, mesh_strata, render_on_mesh
    from ..scene.compile import compile_scene
    from ..utils.color import write_ppm

    t0 = time.time()
    pdist.initialize(device=device)
    try:
        mesh = make_render_mesh()
        rank = dist.get_rank() if dist.is_initialized() else 0
        if rank == 0:
            print(f"[INFO] -p: {pdist.describe(mesh, device)}",
                  file=sys.stderr)
        flat = pdist.replicate(compile_scene(scene, use_bvh=args.bvh,
                                             device=device), mesh)
        def plain_calls():
            return wc.render_pass_reference.calls + rd._render_pass.calls
        launches, plain = wc.render_pass_kernel.launches, plain_calls()
        img = render_on_mesh(flat, scene.camera, mesh=mesh, seed=args.seed,
                             engine=args.engine, schedule=args.schedule,
                             caps=caps)
        width, height = cam_mod.image_size(scene.camera)
        n_strata = mesh_strata(cam_mod.sqrt_spp(scene.camera), mesh.n_sample)
        row0, rows, s0, spp = mesh.shard(
            -(-height // mesh.n_tile) * mesh.n_tile, n_strata * n_strata)
        print(f"[INFO] -p rank {rank}: tile {mesh.tile} rows [{row0}, "
              f"{row0 + rows}), sample {mesh.sample} samples [{s0}, "
              f"{s0 + spp}); {wc.render_pass_kernel.launches - launches} "
              f"forward kernel launches, {plain_calls() - plain} plain "
              "passes", file=sys.stderr)
        if rank != 0:
            return 0
        finite = bool(torch.isfinite(img).all())
        write_ppm(out_path, img)
        print(f"[INFO] wrote {out_path} in {time.time() - t0:.1f}s",
              file=sys.stderr)
        if not finite:
            print("[ERROR] the image holds non-finite radiance",
                  file=sys.stderr)
            return 1
        return 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dynamic(args, scene, device):
    """The progressive loop (the reference's DynamicCamera): the terminal
    viewer under --view, else one stratum a step to convergence or
    --frames steps, resumed from and saved to --checkpoint. Returns the
    ProgressiveRenderer."""
    from ..models.render import ProgressiveRenderer
    if args.view:
        from ..models.viewer import run_viewer
        return run_viewer(scene, device=device, use_bvh=args.bvh,
                          seed=args.seed, engine=args.engine,
                          max_frames=args.frames, checkpoint=args.checkpoint)
    prog = ProgressiveRenderer(scene, device=device, use_bvh=args.bvh,
                               seed=args.seed, engine=args.engine)
    if args.checkpoint and os.path.exists(args.checkpoint):
        prog.load(args.checkpoint)
        print(f"[INFO] resumed at {prog.samples_taken} samples",
              file=sys.stderr)
    frames = 0
    t_frame = time.time()
    while prog.step():
        frames += 1
        now = time.time()
        fps = 1.0 / max(now - t_frame, 1e-9)
        t_frame = now
        conv = " [Converged]" if prog.converged else ""
        print(f"\r[INFO] stratum {prog.samples_taken}/{prog.n_strata ** 2} "
              f"{fps:5.1f} fps{conv}", end="", file=sys.stderr)
        if args.frames and frames >= args.frames:
            break
    print(file=sys.stderr)
    if args.checkpoint:
        prog.save(args.checkpoint)
    return prog
