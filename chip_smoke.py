#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit (nvcc). It builds the port's CUDA kernel from
real_time_ray_tracing_engine_tpu_torch/csrc/, checks it against its plain
torch version on the card, drives the port's main path (the CLI's Cornell
box render at 600x600, 100 spp, depth 50) and checks the image against the
reference engine's goldens. Every phase prints one JSON line; any failure
raises and the script exits non-zero. The last lines are the kernel table,
the card's name and power limit, and {"ok": true, "device": {...}}.

It never imports JAX: the port stands alone on the GPU machine.
"""
from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "real_time_ray_tracing_engine_tpu_torch"
KERNEL_SOURCE = f"{PKG}/csrc/wavefront.cu"
TPU_KERNEL = "real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py:3604"
GOLDEN_DIR = ROOT / "tests" / "goldens" / "reference"

# the per-pixel rule of tests/test_pallas.py::_assert_close: the two sides
# draw identical PCG4D streams, so all but a few branch-flip pixels agree
FLIP_ATOL, FLIP_FRAC, MEAN_TOL = 1e-3, 0.01, 2e-3
# compacted vs single pass: the same paths, radiance summed in two parts
# (np.allclose with its default rtol, as test_pallas.py does)
COMPACT_ATOL = 1e-5
# pooled reference-image rule of tests/test_reference_images.py
CELL, ALLCLOSE_TOL = 10, 0.04
REF_SCENES = {"cornell_box": (36, 0.015, 0.95),
              "cornell_smoke": (36, 0.015, 0.95)}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(torch, fn, reps: int = 3, warmup: int = 1) -> float:
    """Best of `reps` CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def per_pixel(kern, plain) -> dict:
    """The _assert_close statistics of a kernel image against the plain
    one (both radiance sums)."""
    import numpy as np
    k = kern.detach().cpu().numpy()
    p = plain.detach().cpu().numpy()
    diff = np.abs(k - p)
    return {"max_abs_err": float(diff.max()),
            "flipped_frac": float((diff > FLIP_ATOL).mean()),
            "mean_diff": float(abs(k.mean() - p.mean())),
            "finite": bool(np.isfinite(k).all())}


def assert_close(name: str, stats: dict):
    check(stats["finite"], f"{name}: kernel image is not finite")
    check(stats["flipped_frac"] < FLIP_FRAC,
          f"{name}: {stats['flipped_frac']:.4f} of pixels differ by more "
          f"than {FLIP_ATOL} (limit {FLIP_FRAC})")
    check(stats["mean_diff"] < MEAN_TOL,
          f"{name}: mean differs by {stats['mean_diff']:.2e} "
          f"(limit {MEAN_TOL})")


def materials_scene(pt):
    """tests/test_pallas.py::test_materials_scene_matches_oracle: lambertian,
    metal, dielectric, checker, sphere light, defocus and motion blur."""
    cam = pt.CameraConfig(aspect_ratio=16 / 9, image_width=64,
                          samples_per_pixel=16, max_depth=16, vfov=20,
                          lookfrom=(13, 2, 3), lookat=(0, 0, 0),
                          defocus_angle=0.6, focus_dist=10.0,
                          background=(0.7, 0.8, 1.0))
    checker = pt.Checker(2.0, pt.SolidColor((0.2, 0.3, 0.1)),
                         pt.SolidColor((0.9, 0.9, 0.9)))
    light = pt.Sphere((0, 6, 0), 2.0,
                      pt.DiffuseLight(pt.SolidColor((4, 4, 4))))
    return pt.Scene(objects=[
        pt.Sphere((0, -1000, 0), 1000.0, pt.Lambertian(checker)),
        pt.Sphere((0, 1, 0), 1.0, pt.Dielectric(1.5)),
        pt.Sphere((-4, 1, 0), 1.0,
                  pt.Lambertian(pt.SolidColor((0.4, 0.2, 0.1))),
                  center2=(-4, 1.3, 0)),
        pt.Sphere((4, 1, 0), 1.0, pt.Metal((0.7, 0.6, 0.5), fuzz=0.1)),
        light], lights=[light], camera=cam, name="materials")


def nested_checker_scene(pt):
    """tests/test_pallas.py::test_nested_checker_matches_oracle: a depth-2
    checker DAG over solid and Perlin-marble leaves, under a sky
    gradient."""
    inner = pt.Checker(0.31, pt.SolidColor((0.9, 0.1, 0.1)),
                       pt.SolidColor((0.1, 0.1, 0.9)))
    tex = pt.Checker(1.1, inner, pt.Noise(3.0))
    cam = pt.CameraConfig(aspect_ratio=1.0, image_width=64,
                          samples_per_pixel=16, max_depth=16,
                          lookfrom=(0, 2, 6), lookat=(0, 1, 0),
                          sky_gradient=True)
    return pt.Scene(objects=[
        pt.Quad((-8, 0.513, -8), (16, 0, 0), (0, 0, 16), pt.Lambertian(tex)),
        pt.Sphere((0, 1.5, 0), 1.0, pt.Lambertian(tex))], camera=cam,
        name="nested_checker")


def builtin(pt, name, width, spp, depth):
    scene = pt.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = width
    scene.camera.samples_per_pixel = spp
    scene.camera.max_depth = depth
    return scene


def pass_args(pt, scene, dev):
    """(flat, cam, kw) for one whole-image pass of every stratum."""
    from real_time_ray_tracing_engine_tpu_torch.models import camera as cm
    cfg = scene.camera
    flat = pt.compile_scene(scene, device=dev)
    cam = cm.derive(cfg, device=dev)
    w, h = cm.image_size(cfg)
    n_strata = cm.sqrt_spp(cfg)
    kw = dict(width=w, height=h, n_strata=n_strata, max_depth=cfg.max_depth,
              n_samples=n_strata * n_strata, sky_gradient=cfg.sky_gradient)
    return flat, cam, kw


def pool(img, cell):
    h, w, _ = img.shape
    hc, wc = h // cell * cell, w // cell * cell
    x = img[:hc, :wc].reshape(hc // cell, cell, wc // cell, cell, 3)
    return x.mean(axis=(1, 3))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import real_time_ray_tracing_engine_tpu_torch as pt
    from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
    from real_time_ray_tracing_engine_tpu_torch.models import render as rd
    from real_time_ray_tracing_engine_tpu_torch.utils import cli
    check("jax" not in sys.modules, "the port imported jax")
    dev = torch.device("cuda", 0)

    # 1. device
    card = gpu_line()
    print(card, flush=True)
    emit("device", card=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # 2. build the kernel library from the checkout's sources
    lib = wc.load_library()
    regs = [ln.strip() for ln in lib.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    emit("build", seconds=lib.build_seconds,
         library=os.path.relpath(lib.path, ROOT), ptxas=regs)

    # 3. kernel vs plain torch on the card, per pixel
    parity = [("cornell_box", builtin(pt, "cornell_box", 128, 16, 50)),
              ("cornell_smoke", builtin(pt, "cornell_smoke", 96, 4, 16)),
              ("materials", materials_scene(pt)),
              ("nested_checker", nested_checker_scene(pt)),
              ("simple_sphere", builtin(pt, "simple_sphere", 128, 16, 16))]
    for name, scene in parity:
        flat, cam, kw = pass_args(pt, scene, dev)
        kern = wc.render_pass_kernel(flat, cam, 7, 0, **kw)
        plain = wc.render_pass_reference(flat, cam, 7, 0, **kw)
        torch.cuda.synchronize()
        stats = per_pixel(kern, plain)
        emit("parity", scene=name, **{k: v for k, v in kw.items()
                                      if k != "sky_gradient"}, **stats)
        assert_close(name, stats)

    # 4. compacted vs single pass, both on the kernel
    for name in ("cornell_box", "cornell_smoke"):
        flat, cam, kw = pass_args(pt, builtin(pt, name, 40, 4, 8), dev)
        one = wc.render_pass_kernel(flat, cam, 7, 3, **kw).cpu().numpy()
        for sched in ({"cap": 6}, {"cap": 6, "phases": 3},
                      {"caps": (4, 4)}):
            two = wc.render_pass_compacted(flat, cam, 7, 3, **sched,
                                           **kw).cpu().numpy()
            err = float(np.abs(one - two).max())
            emit("compacted", scene=name, schedule=str(sched),
                 max_abs_err=err)
            check(np.allclose(one, two, atol=COMPACT_ATOL),
                  f"{name} {sched}: compacted differs from single by {err}")

    # 5. the main path: the CLI's default Cornell render on the kernel
    out_ppm = Path("output") / "output_image.ppm"
    if out_ppm.exists():
        out_ppm.unlink()
    wc.render_pass_kernel.launches = 0
    wc.render_pass_reference.calls = 0
    rd._render_pass.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["--scene", "cornell_box"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = wc.render_pass_kernel.launches
    plain_calls = wc.render_pass_reference.calls + rd._render_pass.calls
    check(rc == 0, f"cli.main returned {rc}")
    check(out_ppm.exists(), f"{out_ppm} was not written")
    ppm = pt.read_ppm(out_ppm)
    check(ppm.shape == (600, 600, 3), f"PPM shape {ppm.shape}")
    check(launches > 0, "the main path never launched the kernel")
    check(plain_calls == 0, "the main path ran the plain torch engine")
    # the same render as the CLI's, timed without the PPM encoding
    scene = pt.builders.cornell_box()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = pt.render(scene, device=dev, samples_per_batch=16,
                    progress=lambda s, t: None)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    check(bool(torch.isfinite(img).all()), "main-path image not finite")
    paths = 600 * 600 * 100
    emit("main_path", argv=["--scene", "cornell_box"], ppm=str(out_ppm),
         ppm_mean_byte=float(ppm.mean()), kernel_launches=launches,
         plain_calls=plain_calls, cli_wall_s=cli_s, render_s=render_s,
         mpaths_per_s=paths / render_s / 1e6)

    # 6. reference images (tests/test_reference_images.py's pooled rule)
    for name, (spp, mean_tol, min_rate) in REF_SCENES.items():
        gold = np.load(GOLDEN_DIR / f"{name}.npz")["image"]
        meta = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
        scene = pt.load_scene(str(GOLDEN_DIR / f"{name}_scene.json"))
        scene.camera.image_width = meta["width"]
        scene.camera.max_depth = meta["depth"]
        ours = pt.to_bytes(pt.render(scene, device=dev, spp=spp, seed=11,
                                     engine="cuda"))
        check(ours.shape == gold.shape, f"{name}: {ours.shape} vs "
              f"{gold.shape}")
        a = pool(gold.astype(np.float32) / 255.0, CELL)
        b = pool(ours.astype(np.float32) / 255.0, CELL)
        diff = np.abs(a - b).mean(axis=-1)
        rate = float((diff < ALLCLOSE_TOL).mean())
        mean_diff = float(diff.mean())
        emit("reference_image", scene=name, spp=spp, cell_mean_diff=mean_diff,
             allclose_rate=rate, mean_tol=mean_tol, min_rate=min_rate)
        check(mean_diff < mean_tol, f"{name}: cell mean diff {mean_diff}")
        check(rate >= min_rate, f"{name}: allclose rate {rate}")

    # 7. times at the main path's shapes: Cornell 600x600, depth 50. The
    # scene is packed for the kernel once, as a render does, and the
    # packing is timed on its own. Each compacted image (the schedule the
    # main path's 16-sample batches run) is held against the single pass,
    # and at spp 16 against the plain version's compacted schedule.
    times = {}
    main_err = None
    for spp in (16, 100):
        flat, cam, kw = pass_args(
            pt, builtin(pt, "cornell_box", 600, spp, 50), dev)
        prepare_ms = math.inf
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prep = wc.prepare_kernel(flat, cam)
            torch.cuda.synchronize()
            prepare_ms = min(prepare_ms, (time.perf_counter() - t0) * 1e3)
        kernel_pass = functools.partial(wc.render_pass_kernel, prepared=prep)
        out = {}

        def single():
            out["kernel"] = kernel_pass(flat, cam, 0, 0, **kw)

        def compacted():
            out["compacted"] = wc.render_pass_compacted(
                flat, cam, 0, 0, pass_fn=kernel_pass, **kw)

        t_single = cuda_ms(torch, single)
        t_comp = cuda_ms(torch, compacted)
        one = out["kernel"].cpu().numpy()
        comp = out["compacted"].cpu().numpy()
        comp_err = float(np.abs(one - comp).max())
        n = 600 * 600 * spp
        times[spp] = {"single_ms": t_single, "compacted_ms": t_comp}
        rec = {"spp": spp, "single_ms": t_single, "compacted_ms": t_comp,
               "single_mpaths_per_s": n / t_single / 1e3,
               "compacted_mpaths_per_s": n / t_comp / 1e3,
               "prepare_ms": prepare_ms,
               "compacted_vs_single_max_abs_err": comp_err}
        if spp == 16:
            def plain():
                out["plain"] = wc.render_pass_reference(flat, cam, 0, 0,
                                                        **kw)

            def plain_compacted():
                out["plain_compacted"] = wc.render_pass_compacted(
                    flat, cam, 0, 0, pass_fn=wc.render_pass_reference, **kw)
            t_plain = cuda_ms(torch, plain, reps=1, warmup=0)
            t_plain_comp = cuda_ms(torch, plain_compacted, reps=1, warmup=0)
            times[spp]["plain_ms"] = t_plain
            stats = per_pixel(out["kernel"], out["plain"])
            comp_stats = per_pixel(out["compacted"], out["plain_compacted"])
            main_err = max(stats["max_abs_err"], comp_stats["max_abs_err"])
            rec.update(plain_ms=t_plain,
                       plain_mpaths_per_s=n / t_plain / 1e3,
                       plain_compacted_ms=t_plain_comp, parity=stats,
                       compacted_parity=comp_stats)
        emit("times", card=card, **rec)
        check(np.allclose(one, comp, atol=COMPACT_ATOL),
              f"600x600 spp{spp}: compacted differs from single by "
              f"{comp_err}")
        if spp == 16:
            assert_close("cornell_box 600x600 spp16 d50", stats)
            assert_close("cornell_box 600x600 spp16 d50 compacted",
                         comp_stats)

    print(json.dumps({"kernels": [{
        "name": "wavefront_forward_kernel", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "launches": launches, "max_abs_err": main_err,
        "ms": times[16]["single_ms"], "plain_ms": times[16]["plain_ms"]}]}),
        flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
