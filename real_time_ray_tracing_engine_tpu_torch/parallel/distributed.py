"""Multi-process bring-up, the global mesh, shard checkpoints and scaling.

Port of the JAX package's parallel/distributed.py (42-173) onto
torch.distributed, one process a GPU:

  - `initialize()`       — the process group, from torchrun's environment
                           (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
                           LOCAL_RANK, LOCAL_WORLD_SIZE) or explicit
                           arguments; a no-op for one process, so every
                           entry point can call it. The backend is a rule
                           fixed in advance (`choose_backend`): NCCL where
                           each rank has a GPU of its own, gloo on the CPU
                           or where ranks share a GPU (NCCL refuses two
                           ranks on one device). The group's timeout is
                           short, so a rank that fails cannot hang the
                           others for long.
  - `make_global_mesh()` — nodes on "tile" (no collective crosses nodes
                           while a pass renders), the GPUs of a node on
                           "sample" (its all_reduce stays inside a node).
  - `replicate()`        — rank 0's compiled tables on every rank.
  - shard checkpoints    — each rank's rows of a progressive accumulation
                           in an atomic shard_{rank:05d}.npz, with the
                           scene's fingerprint and settings, refused on a
                           mismatch (CheckpointMismatch names the field;
                           the JAX shards check nothing).
  - `scaling_report()`   — throughput against rank count on one workload,
                           counting only ranks with a GPU each.
  - `spawn_ranks()`      — n spawned ranks over a file store, joined within
                           a time limit; `dryrun_multichip(n)` runs one
                           full-family training step on n gloo ranks on the
                           CPU (the JAX __graft_entry__.py:27-87).
"""
from __future__ import annotations

import copy
import dataclasses
import datetime
import math
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..models import camera as cam_mod
from ..models.render import CheckpointMismatch, resolve_device
from ..scene.compile import compile_scene
from ..scene.flat import FlatScene
from .mesh import RenderMesh, make_render_mesh, mesh_strata, render_on_mesh

# seconds a collective or the rendezvous waits for the other ranks
GROUP_TIMEOUT_S = 60
# seconds scaling_report waits for the ranks of one count
SCALING_TIMEOUT_S = 600


def _env_int(name: str, value) -> int | None:
    if value is not None:
        return int(value)
    got = os.environ.get(name)
    return int(got) if got not in (None, "") else None


def choose_backend(device, local_world_size: int) -> str:
    """"nccl" when the ranks run on CUDA and each rank of a node has a GPU
    of its own; "gloo" on the CPU, or when a node's ranks outnumber its
    GPUs and so share one (NCCL refuses two ranks on one device). A rule
    fixed before the group starts, not a retry after a failure."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(*, device="cuda", init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               local_rank: int | None = None,
               local_world_size: int | None = None) -> bool:
    """Start this process's group; True if a group of more than one rank
    runs (or already ran), False for one process, which needs nothing.

    Each argument falls back to torchrun's variable (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE; init_method "env://" reads MASTER_ADDR
    and MASTER_PORT). On CUDA the process takes GPU LOCAL_RANK (modulo the
    GPUs there are) before the group starts; the backend is
    choose_backend's, the timeout GROUP_TIMEOUT_S."""
    world_size = _env_int("WORLD_SIZE", world_size) or 1
    if world_size <= 1:
        return False
    if dist.is_initialized():
        return True
    rank = _env_int("RANK", rank)
    if rank is None:
        raise ValueError("a world of several ranks needs RANK (or rank=)")
    local_rank = _env_int("LOCAL_RANK", local_rank)
    local_rank = rank if local_rank is None else local_rank
    local_world_size = _env_int("LOCAL_WORLD_SIZE", local_world_size) \
        or world_size
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        choose_backend(dev, local_world_size),
        init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return True


def describe(mesh: RenderMesh, device) -> str:
    """The mesh and the backend its collectives use, for a log line."""
    layout = f"mesh {mesh.n_tile} x {mesh.n_sample} (tile x sample)"
    if mesh.device_mesh is None:
        return f"{layout}, one process, no collectives"
    backend = dist.get_backend()
    why = ("each rank has a GPU of its own" if backend == "nccl"
           else "the ranks share a GPU" if torch.device(device).type
           == "cuda" else "the CPU")
    return (f"{layout} over {dist.get_world_size()} rank(s), backend "
            f"{backend} ({why})")


def make_global_mesh() -> RenderMesh:
    """The ("tile", "sample") mesh of a multi-node world: nodes on "tile",
    the LOCAL_WORLD_SIZE ranks of a node (its GPUs) on "sample", as
    torchrun numbers ranks node by node (JAX make_global_mesh, 71-89). One
    process, or a world that sets no LOCAL_WORLD_SIZE, takes
    make_render_mesh's layout."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = _env_int("LOCAL_WORLD_SIZE", None)
    if world == 1 or local is None or local == world:
        return make_render_mesh()
    if world % local:
        raise ValueError(f"{world} ranks do not fill nodes of {local}")
    return make_render_mesh(world // local, local)


def replicate(flat: FlatScene, mesh: RenderMesh) -> FlatScene:
    """Rank 0's compiled tables on every rank of `mesh`, on this rank's
    device (broadcast_object_list of its tensors on the CPU), so that ranks
    that compiled another scene, or another BVH, still split one image.
    Returns `flat` itself on a mesh without collectives."""
    group = mesh.world_group()
    if group is None:
        return flat
    # the tables travel as numpy arrays: pickled tensors do not load back
    # through broadcast_object_list on every torch build
    box = [{f.name: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(flat)
            for v in (getattr(flat, f.name),)}
           if dist.get_rank() == 0 else None]
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else None
    dist.broadcast_object_list(box, src=0, group=group, device=dev)
    return FlatScene(**{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                            else v) for k, v in box[0].items()}
                     ).to(flat.device)


# ------------------------------------------------------ shard checkpoints
def shard_settings(mesh: RenderMesh, *, width: int, height: int,
                   n_strata: int, max_depth: int,
                   sky_gradient: bool) -> dict:
    """What a shard checkpoint's accumulation was rendered under: the
    settings ProgressiveRenderer.load checks (n_strata, width, height,
    max_depth, sky_gradient) and the shard's place (the mesh's layout and
    this rank's tile and sample)."""
    return {"n_strata": n_strata, "width": width, "height": height,
            "max_depth": max_depth, "sky_gradient": bool(sky_gradient),
            "n_tile": mesh.n_tile, "n_sample": mesh.n_sample,
            "tile": mesh.tile, "sample": mesh.sample}


def _shard_path(ckpt_dir, rank) -> Path:
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return Path(ckpt_dir) / f"shard_{rank:05d}.npz"


def save_progressive_shard(ckpt_dir, acc_local, samples_taken: int,
                           seed: int, *, fingerprint: str, settings: dict,
                           rank: int | None = None) -> str:
    """Write this rank's rows of a progressive accumulation (acc_local, the
    radiance sum of samples_taken samples under `seed`) to
    ckpt_dir/shard_{rank:05d}.npz, atomically (a temporary file renamed),
    with the scene's fingerprint (models/render.py::scene_fingerprint)
    and `settings` (shard_settings). Returns the path."""
    path = _shard_path(ckpt_dir, rank)
    path.parent.mkdir(parents=True, exist_ok=True)
    acc = acc_local.detach().cpu().numpy() \
        if isinstance(acc_local, torch.Tensor) else np.asarray(acc_local)
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, acc=acc, samples_taken=int(samples_taken),
             seed=int(seed), fingerprint=fingerprint, **settings)
    os.replace(tmp, path)
    return str(path)


def load_progressive_shard(ckpt_dir, *, fingerprint: str, settings: dict,
                           rank: int | None = None):
    """(acc, samples_taken, seed) of this rank's shard in ckpt_dir, or None
    when it has none. Raises CheckpointMismatch naming the field when the
    shard has no fingerprint, another setting or place (settings), another
    scene (fingerprint), or an accumulation not of the shard's rows."""
    path = _shard_path(ckpt_dir, rank)
    if not path.exists():
        return None
    with np.load(path) as d:
        if "fingerprint" not in d:
            raise CheckpointMismatch(
                f"{path}: no fingerprint (a shard without one cannot be "
                "matched to a scene)")
        for name, want in settings.items():
            got = d[name].item() if name in d else None
            if got != want:
                raise CheckpointMismatch(f"{path}: {name} is {got}, this "
                                         f"render's is {want}")
        if str(d["fingerprint"]) != fingerprint:
            raise CheckpointMismatch(f"{path}: fingerprint of another scene "
                                     "(its compiled tables differ)")
        acc = d["acc"]
        rows = settings["height"] // settings["n_tile"]
        if acc.shape != (rows, settings["width"], 3):
            raise CheckpointMismatch(f"{path}: acc is {acc.shape}, a shard "
                                     f"holds ({rows}, {settings['width']}, "
                                     "3)")
        return acc, int(d["samples_taken"]), int(d["seed"])


# --------------------------------------------------------- spawned ranks
def _rank_entry(fn, rank: int, n: int, init_file: str, out_file: str,
                threads: int | None, args: tuple):
    if threads:
        torch.set_num_threads(threads)
    result = fn(rank, n, f"file://{init_file}", *args)
    torch.save(result, out_file)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_ranks(fn, n: int, *args, timeout_s: float | None = 300.0,
                threads: int | None = None, work_dir=None) -> list:
    """Run fn(rank, n, init_method, *args) in n spawned processes and
    return each rank's result (what fn returns, through a file). The ranks
    meet through a file store in a fresh directory (work_dir, else a
    temporary one): init_method is its file:// URL, for initialize. The
    processes are joined within timeout_s (None: no limit; a rank that
    fails still stops the others): at the limit, or as soon as a rank
    fails, every one still alive is killed and this raises. threads sets
    torch's thread count in each rank."""
    ctx = multiprocessing.get_context("spawn")
    own = work_dir is None
    root = Path(tempfile.mkdtemp(prefix="rtx_ranks_") if own else work_dir)
    root.mkdir(parents=True, exist_ok=True)
    init_file = root / "store"
    outs = [root / f"rank_{r}.pt" for r in range(n)]
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, n, str(init_file), str(outs[r]),
                               threads, args), daemon=True)
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + (math.inf if timeout_s is None
                                       else timeout_s)
        while True:
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0][0]} of {n} exited with "
                                   f"code {bad[0][1]}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{sum(c is None for c in codes)} of {n} "
                                   f"ranks still running after {timeout_s} s")
            time.sleep(0.05)
        return [torch.load(o, weights_only=False) for o in outs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        if own:
            shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------- scaling harness
def _timed_render(scene, mesh, device, reps: int) -> float:
    """Seconds of one render_on_mesh of `scene` (a warm-up first), the
    host clock after the device's work."""
    def run(seed):
        img = render_on_mesh(scene, mesh=mesh, seed=seed, device=device)
        if img.is_cuda:
            torch.cuda.synchronize()
    run(0)
    if dist.is_initialized():
        dist.barrier()
    t0 = time.perf_counter()
    for r in range(reps):
        run(r + 1)
    return (time.perf_counter() - t0) / reps


def _scaling_rank(rank, n, init_method, scene, reps):
    initialize(device="cuda", init_method=init_method, rank=rank,
               world_size=n, local_rank=rank, local_world_size=n)
    mesh = make_render_mesh()
    return (_timed_render(scene, mesh, "cuda", reps), mesh.n_tile,
            mesh.n_sample)


def scaling_report(scene=None, *, width: int = 128, n_strata: int = 2,
                   max_depth: int = 4, device="cuda", rank_counts=None,
                   reps: int = 2) -> list[dict]:
    """Throughput against the rank count on one workload, render_on_mesh
    of `scene` (default the Cornell box) at `width`, n_strata^2 samples and
    max_depth: [{ranks, seconds, mesh, mpaths_s, efficiency}], mpaths_s
    the paths of the image asked for (width x height x n_strata^2: not the
    rows or strata a mesh pads), efficiency against linear scaling from
    the first count. The caller's scene is not changed. Only ranks with a GPU each are
    counted (NCCL, one GPU a rank; ranks that share a card measure
    contention, not scaling): the counts default to the powers of two up
    to the GPUs there are, one on the CPU or a one-card machine, where the
    report is the one-rank row. A count of more than one rank spawns its
    ranks (spawn_ranks)."""
    from ..scene import builders
    dev = resolve_device(device)
    scene = (copy.deepcopy(scene) if scene is not None
             else builders.cornell_box())
    scene.camera.image_width = width
    scene.camera.samples_per_pixel = n_strata * n_strata
    scene.camera.max_depth = max_depth
    gpus = torch.cuda.device_count() if dev.type == "cuda" else 1
    if rank_counts is None:
        rank_counts, c = [], 1
        while c <= gpus:
            rank_counts.append(c)
            c *= 2
    if max(rank_counts) > gpus:
        raise ValueError(f"scaling_report counts ranks with a GPU each: "
                         f"{max(rank_counts)} ranks, {gpus} on {dev.type}")
    w, h = cam_mod.image_size(scene.camera)
    rows = []
    for n in rank_counts:
        if n == 1:
            sec, n_tile, n_sample = (_timed_render(scene, RenderMesh(), dev,
                                                   reps), 1, 1)
        else:
            sec, n_tile, n_sample = spawn_ranks(
                _scaling_rank, n, scene, reps, timeout_s=SCALING_TIMEOUT_S)[0]
        rows.append({"ranks": n, "seconds": sec, "mesh": (n_tile, n_sample),
                     "mpaths_s": w * h * n_strata * n_strata / sec / 1e6})
    for r in rows:
        r["efficiency"] = (r["mpaths_s"] / rows[0]["mpaths_s"]
                           * rows[0]["ranks"] / r["ranks"])
    return rows


# ------------------------------------------------------------ the dry run
DRYRUN_WIDTH = 16
# the JAX dry run's depth is 2, where Cornell's glass gives the hard
# families no gradient (no path reaches the light through it); at 4 every
# family but fuzz (no metal) has one
DRYRUN_DEPTH = 4
DRYRUN_LR = 1e-2


def _dryrun_problem(n_tile: int, n_sample: int):
    """The dry run's scene, camera and shapes (JAX __graft_entry__.py
    67-76): the Cornell box 16 px wide, its height padded to the tile
    axis, n_strata 1 (2 with a sample axis) raised until the sample axis
    divides its square, depth DRYRUN_DEPTH."""
    from ..scene import builders
    scene = builders.cornell_box()
    scene.camera.image_width = DRYRUN_WIDTH
    flat = compile_scene(scene, device="cpu")
    cam = cam_mod.derive(scene.camera)
    height = -(-DRYRUN_WIDTH // n_tile) * n_tile
    n_strata = mesh_strata(1 if n_sample == 1 else 2, n_sample)
    kw = dict(width=DRYRUN_WIDTH, height=height, n_strata=n_strata,
              max_depth=DRYRUN_DEPTH)
    return flat, cam, kw


def _dryrun_step(flat, cam, kw, mesh):
    """One Adam step over every trainable family against a black target;
    (loss, {field: gradient}, {field: params after the step})."""
    from . import train
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in train.get_params(flat).items()}
    step = train.make_train_step(
        torch.optim.Adam(params.values(), lr=DRYRUN_LR), flat=flat,
        engine="torch", mesh=mesh, **kw)
    target = torch.zeros(kw["height"], kw["width"], 3)
    loss = step(params, cam, 0, target)
    return (float(loss), {k: v.grad.clone() for k, v in params.items()},
            {k: v.detach().clone() for k, v in params.items()})


def _dryrun_rank(rank, n, init_method, n_tile, n_sample):
    initialize(device="cpu", init_method=init_method, rank=rank,
               world_size=n, local_rank=rank, local_world_size=n)
    mesh = make_render_mesh(n_tile, n_sample)
    gmesh = make_global_mesh()
    if gmesh.size != n:
        raise RuntimeError(f"the global mesh covers {gmesh.size} of {n}")
    flat, cam, kw = _dryrun_problem(n_tile, n_sample)
    loss, grads, params = _dryrun_step(replicate(flat, mesh), cam, kw, mesh)
    return {"rank": rank, "mesh": (mesh.tile, mesh.sample), "loss": loss,
            "grads": grads, "params": params}


def dryrun_multichip(n: int, *, timeout_s: float = 180.0,
                     work_dir=None) -> dict:
    """One full-family training step on n gloo ranks on the CPU, over the
    JAX dry run's mesh (n_sample 2 on an even n) and at its tiny size
    (_dryrun_problem; the plain engine), held against the same step in
    this process. Raises unless every rank's parameters after the step
    are equal bit for bit, each rank's loss is the one-process loss to
    1e-5 of it and each family's gradient the one-process gradient to 1e-4
    of its largest entry. Returns what it compared."""
    n_sample = 2 if n % 2 == 0 and n > 1 else 1
    n_tile = n // n_sample
    with ThreadPoolExecutor(1) as pool:
        # the ranks run while this process takes its own step
        spawned = pool.submit(spawn_ranks, _dryrun_rank, n, n_tile,
                              n_sample, timeout_s=timeout_s, threads=1,
                              work_dir=work_dir)
        flat, cam, kw = _dryrun_problem(n_tile, n_sample)
        loss, grads, params = _dryrun_step(flat, cam, kw, None)
        ranks = spawned.result()
    ranks_equal = all(torch.equal(r["params"][k], ranks[0]["params"][k])
                      for r in ranks for k in params)
    loss_err = max(abs(r["loss"] - loss) for r in ranks)
    grad_err = {k: max(float((r["grads"][k] - g).abs().max())
                       for r in ranks) for k, g in grads.items()}
    grad_scale = {k: float(g.abs().max()) for k, g in grads.items()}
    report = {"ranks": n, "mesh": {"tile": n_tile, "sample": n_sample},
              "shards": [r["mesh"] for r in ranks],
              "losses": [r["loss"] for r in ranks], "one_process_loss": loss,
              "params_equal_on_every_rank": ranks_equal,
              "grad_max_abs_err": grad_err, "grad_scale": grad_scale}
    print(f"dryrun_multichip({n}): mesh={report['mesh']} loss={loss:.6f} "
          f"(one process) ranks {report['losses']} "
          f"params equal: {ranks_equal} [gloo on the CPU, plain engine]",
          file=sys.stderr)
    if not ranks_equal:
        raise RuntimeError("the ranks' parameters differ after the step")
    if loss_err > 1e-5 * abs(loss):
        raise RuntimeError(f"a rank's loss is {loss_err} from the "
                           f"one-process loss {loss}")
    for k, e in grad_err.items():
        if e > 1e-4 * grad_scale[k]:
            raise RuntimeError(f"the {k} gradient is {e} from the "
                               f"one-process gradient (scale "
                               f"{grad_scale[k]})")
    return report
