#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit (nvcc). It builds the port's CUDA kernels from
real_time_ray_tracing_engine_tpu_torch/csrc/, checks each against its plain
torch version on the card, and drives the port's main paths: the CLI's
Cornell box render (600x600, 100 spp, depth 50), checked against the
reference engine's goldens; the training step (Cornell 1920x1080, 64 spp,
depth 50, Adam) over tex_color alone and over all five trainable families,
whose loss must fall; the CLI's large-scene render, bouncing_spheres at
its own 1200x675, 100 spp, depth 50 through the chunk scan (K6), and a
301-quad city scene file through its quad chunks (K7); and large-scene
training, make_train_step on bouncing_spheres at 1200x675 spp16 d50 over
tex_color (the suffix-radiance kernel K8) and tex_color + IOR (K4v riding
K8), the suffix tier's gradient equal bit for bit over two runs (K8, K8 +
K4v, the BVH walks' tiers), with the chunk scan's weight planes (K3v, the
planes of the rows each path has scattered on, up to 32 rows; equal bit
for bit over two runs, and in a closed room where paths hold many rows)
and tangent bundles (K4v) at their full-size shapes on the JAX tests'
scenes and a 28-row scene, and K3v with 30 of K4v's slots beside 31 rows
timed against the adjoint (K9) on the same request; and full-family
training at scale, make_train_step over all five families of
bouncing_spheres (2,013 hard slots) through the adjoint backward (K9), at
the JAX bench line's 400x225 spp9 d50 and at 1200x675 spp16 d50 under the
sky gradient, with K9 held against its plain version on five scenes and
against the forward-mode kernels (K4v, K8, K4, K3); and the same training
through the adjoint's segmented-regeneration sweep (K10, adjoint_seg=8, the
JAX package's sweep past depth 12), with K10 held against its plain
version on seven cases and against K9 at both shapes, and K9 and K10 timed
in turns at both shapes and on the 4,913-sphere grid; and the SAH BVH (-b)
with its opt-in walks, K11 (the stack BVH) and K12 (the lane BVH): held
against the plain pass and the chunk scan on four scenes up to a
32,768-sphere grid and timed beside the chunk scan, the CLI's -b on
bouncing_spheres at 1200x675 spp100 d50 and on the grid's scene file in
the three modes, tex_color training through each walk and a full-family
step on a stack-mode scene (the adjoint); and the dynamic camera: the
CLI's --camera dynamic on the Cornell box at 600x600 spp100 d50, stopped
at 40 strata with --frames and resumed from its --checkpoint, one forward
launch a stratum, its PPM and acc / 100 equal bit for bit to render() in
passes of one sample, and the Cornell golden through ProgressiveRenderer;
ProgressiveRenderer on bouncing_spheres at 1200x675 spp100 d50 through
the chunk scan, steps doubling to 8 (the compacted schedule), a camera
move, then steps of 16 equal bit for bit to render() at the moved camera,
its checkpoint saved, loaded and refused by another scene; the terminal
viewer (run_viewer, no TTY); one step's wall and kernel time at 1, 4 and
16 strata; and the CLI's -d dump; and the sharded layer: every kernel
instance at an image shard (row0 > 0) against its plain version and the
forward's whole-image rows, the shards of four (tile, sample) layouts
summed in one process against one pass (tile-only layouts bit for bit)
and their gradients through make_kernel_render(mesh=), two ranks sharing
the card over gloo (render_on_mesh, three full-family make_train_step
(mesh=) steps at Cornell 1920x1080 spp64 d50 against the one-process
steps, a bouncing adjoint step), a one-rank NCCL group, and the CLI's -p
on one rank and on two under torch.distributed.run; and the profiling layer:
render() of Cornell 600x600 and bouncing_spheres 1200x675 at spp16 d50
under timed (rays/s, the fp32 roofline share) and profiler_trace (the
kernel's events and the program's spans in the chrome trace, the
device's busy share, the forward's bounce counter), Cornell's path
lengths (summed, equal to the kernel's bounces) and the C++
and numpy P3 encoders' bytes. The forward's persistent
threads take lane slots from a counter zeroed for each launch: two
launches in a row on one stream give the same outputs bit for bit
(refill_repeat). Every phase prints
one JSON line; any failure raises and the script exits non-zero. The last
lines are each phase's seconds, the kernel table, the card's name and power
limit, and {"ok": true, "device": {...}}.

It never imports JAX: the port stands alone on the GPU machine.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "real_time_ray_tracing_engine_tpu_torch"
KERNEL_SOURCE = f"{PKG}/csrc/wavefront.cu"
# the JAX package's one pl.pallas_call; the forward kernel replaces its K1/K2
# variants, the grad kernel its grad_tex weight-plane variant (K3, K5) and,
# with hard slots, its tangent-bundle variant (K4)
TPU_KERNEL = "real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py:3604"
# the chunk scan's variants inside it: vscan_select (K6) and the quad-chunk
# walk from qtest_rows (K7)
TPU_VSCAN = "real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py:1378"
TPU_VQUAD = "real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py:1538"
# the grad variants on the chunk scan's selection: the weight planes past
# the unrolled bounds (K3v, MAX_GRAD_TEXS), the tangent bundles' post-gather
# theta aliasing (K4v, vscan_record) and the suffix-radiance tier (K8,
# grad_suffix)
TPU_K3V = "real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py:348"
TPU_K4V = "real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py:1614"
TPU_K8 = "real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py:914"
# the adjoint backward's per-sample sweep (K9: grad_adjoint, 2664-2957,
# 3094-3217)
TPU_K9 = "real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py:2664"
# its segmented-regeneration sweep (K10: adj_seg, 2958-3092)
TPU_K10 = "real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py:2958"
# the opt-in BVH walks: closest_hit_scan's shared-stack bvh_mode branch
# (K11: 1200, 1272-1360, tables 3392-3400) and the per-lane skip-link walk
# (K12: closest_hit_lane 1755-1873, _pack_lane_tables 703-750)
TPU_K11 = "real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py:1272"
TPU_K12 = "real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py:1755"
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
              "cornell_smoke": (36, 0.015, 0.95),
              "simple_sphere": (36, 0.010, 0.97),
              "three_spheres": (36, 0.012, 0.97),
              "bouncing_spheres": (25, 0.015, 0.93),
              "textured_spheres": (25, 0.020, 0.85)}
# tests/test_reference_images.py::test_textured_marble_distributional: the
# marble sphere's region of textured_spheres (the reference's noise tables
# are random), its mean within MARBLE_TOL of the golden's
MARBLE_REGION, MARBLE_TOL = (slice(8, 38), slice(88, 124)), 0.08
# dG_tex, kernel against plain and compacted against single: within 1e-4 of
# its largest entry. The sums over lanes run in another order (per-block
# shuffle trees and a sum of block rows against one torch sum; phases), so
# they agree to rounding, not bit for bit.
DG_RTOL = 1e-4
# the adjoint (K9) against its plain version at the large-scene training
# shape, bouncing_spheres 1200x675 spp16 d50: there single lanes carry
# derivatives several times a family's largest entry through near-tangent
# roots (a grazing hit on the radius-1000 ground, where the root formula's
# two terms agree to 1e-4; a path that grazes a metal sphere), and every
# two float32 routes part on such a lane by about 1e-4 of its own size.
# K9's hand-written reverse (its sphere root in double) parts from the plain
# version there by at most 1.04e-4 of a family's largest entry (IOR; fuzz
# 2.34e-5, the rest at most 1.8e-5) on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md §6); the bound is about twice that. The phase prints the gaps
# beside K4v's on the entries that part most
ADJ_MAIN_RTOL = 2e-4
# the training main path: Cornell at the JAX package's fwd+bwd benchmark
# shape (bench.py:122-198), tex_color only, from the three wall rows dimmed
TRAIN_W, TRAIN_H, TRAIN_SPP, TRAIN_DEPTH = 1920, 1080, 64, 50
TRAIN_STEPS, TRAIN_LR, TRAIN_SEED = 4, 0.02, 0
WALL_ROWS = [0, 1, 2]     # Cornell's green, red and white texture rows
# the full-family step: Adam at TRAIN_LR for tex_color, IOR and fuzz and at
# GEOM_LR for sphere centers and radii (Cornell's units are ~555), from the
# dimmed walls and the glass sphere (and its light-list copy) at IOR 1.4
# and radius 85
GEOM_LR, START_IOR, START_RADIUS = 1.0, 1.4, 85.0
# the large-scene training main path: Adam steps on bouncing_spheres at its
# own 1200x675 spp16 d50
LARGE_STEPS = 4
# the adjoint's training main path (K9): all five families of
# bouncing_spheres, Adam at TRAIN_LR for tex_color, IOR and fuzz and at
# ADJ_GEOM_LR for the 485 spheres' centers and radii: Adam moves every
# parameter with a nonzero gradient by about its rate, whatever the
# gradient's size, so at TRAIN_LR every sphere would move 0.02 a step (a
# tenth of a small sphere's radius) and the loss rise
# (scripts/adjoint_conditioning.py runs both rates, on the kernel and on
# its plain version)
ADJ_GEOM_LR = 1e-4
# the segmented adjoint (K10) on the main path: the JAX package's SEG past
# depth 12 (parallel/train.py:100-110)
ADJ_SEG = 8
# K10 against K9: each lane runs K9's arithmetic in K9's order, so the
# images and bounces are equal and each family sums the same float
# contributions in double in another order: within 1e-6 of its largest
# entry. The images are equal bit for bit (the phases print whether they
# are); the gate is 1e-6
SEG_VS_K9_RTOL = 1e-6
SEG_IMAGE_ATOL = 1e-6


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


# Scenes past the unrolled bounds, for the chunk scan (K6, K7). Each takes
# the scene API module, this package's or the JAX package's (tests build
# both from one definition); numpy is imported inside.
def multichunk_scene(api):
    """tests/test_pallas.py::test_vscan_multichunk_matches_oracle: 300
    spheres in 3 Morton chunks (every 11th moving) under a sphere light."""
    import numpy as np
    rng = np.random.default_rng(3)
    objs = []
    for i in range(300):
        c = tuple(map(float, rng.uniform(-6, 6, 3)))
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        c2 = (c[0], c[1] + 0.3, c[2]) if i % 11 == 0 else None
        objs.append(api.Sphere(c, 0.35, api.Lambertian(api.SolidColor(albedo)),
                               center2=c2))
    light = api.Sphere((0, 10, 0), 2.0,
                       api.DiffuseLight(api.SolidColor((5, 5, 5))))
    objs.append(light)
    return api.Scene(objects=objs, lights=[light], camera=api.CameraConfig(
        image_width=32, aspect_ratio=1.0, samples_per_pixel=4, max_depth=3,
        vfov=40, lookfrom=(0, 2, 14), lookat=(0, 0, 0),
        background=(0.5, 0.6, 0.8)), name="vscan_multichunk")


def vquad_scene(api):
    """tests/test_pallas.py::test_vquad_chunks_match_oracle: 90 quads (past
    MAX_QUADS_VSCAN, so in quad chunks: K7), 40 spheres and a sphere
    light."""
    import numpy as np
    rng = np.random.default_rng(17)
    objs = []
    for _ in range(90):
        c = rng.uniform(-5.0, 5.0, 3)
        u = rng.uniform(0.4, 1.2, 3) * np.array([1.0, 0.0, 1.0])
        v = rng.uniform(0.4, 1.2, 3) * np.array([0.0, 1.0, 1.0])
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        objs.append(api.Quad(tuple(map(float, c)), tuple(map(float, u)),
                             tuple(map(float, v)),
                             api.Lambertian(api.SolidColor(albedo))))
    for i in range(40):
        c = tuple(map(float, rng.uniform(-5, 5, 3)))
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        m = (api.Metal(albedo, fuzz=0.3) if i % 6 == 0
             else api.Lambertian(api.SolidColor(albedo)))
        objs.append(api.Sphere(c, 0.4, m))
    light = api.Sphere((0, 9, 0), 2.0,
                       api.DiffuseLight(api.SolidColor((5, 5, 5))))
    objs.append(light)
    return api.Scene(objects=objs, lights=[light], camera=api.CameraConfig(
        image_width=40, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        vfov=50, lookfrom=(0, 2, 12), lookat=(0, 0, 0),
        background=(0.4, 0.5, 0.7)), name="vquad")


def vscan_nested_checker_scene(api):
    """tests/test_pallas.py::test_vscan_nested_checker_matches_oracle: a
    depth-2 checker DAG over solid and Perlin-marble leaves on 78 spheres
    and a ground quad, under a sky gradient."""
    import numpy as np
    inner = api.Checker(0.31, api.SolidColor((0.9, 0.1, 0.1)),
                        api.SolidColor((0.1, 0.1, 0.9)))
    tex = api.Checker(1.1, inner, api.Noise(3.0))
    rng = np.random.default_rng(13)
    objs = [api.Quad((-10, 0.513, -10), (20, 0, 0), (0, 0, 20),
                     api.Lambertian(tex))]
    for i in range(78):
        c = tuple(map(float, rng.uniform(-5, 5, 2)))
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        m = api.Lambertian(tex if i % 4 == 0 else api.SolidColor(albedo))
        objs.append(api.Sphere((c[0], 1.1, c[1]), 0.35, m))
    return api.Scene(objects=objs, camera=api.CameraConfig(
        aspect_ratio=1.0, image_width=32, samples_per_pixel=4, max_depth=3,
        lookfrom=(0, 3, 9), lookat=(0, 1, 0), sky_gradient=True),
        name="vscan_nested_checker")


def mis_medium_scene(api):
    """120 spheres (lambertian, metal, glass) on a ground sphere under a
    sphere light and a quad light sampled by MIS, with a fog ball (a
    constant medium) among them: the chunk scan beside every material, both
    light kinds and a medium."""
    import numpy as np
    rng = np.random.default_rng(29)
    objs = [api.Sphere((0, -1000, 0), 1000.0,
                       api.Lambertian(api.SolidColor((0.5, 0.5, 0.5))))]
    for i in range(120):
        c = (float(rng.uniform(-6, 6)), 0.3, float(rng.uniform(-6, 6)))
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        m = (api.Metal(albedo, fuzz=0.2) if i % 5 == 0 else
             api.Dielectric(1.5) if i % 7 == 0 else
             api.Lambertian(api.SolidColor(albedo)))
        objs.append(api.Sphere(c, 0.3, m))
    objs.append(api.ConstantMedium(
        api.Sphere((1.0, 1.2, 1.0), 1.1,
                   api.Lambertian(api.SolidColor((1, 1, 1)))),
        0.6, api.SolidColor((0.8, 0.8, 0.9))))
    sun = api.Sphere((0, 7, 0), 1.5,
                     api.DiffuseLight(api.SolidColor((6, 6, 6))))
    panel = api.Quad((-2, 5, -5), (4, 0, 0), (0, 2, 0),
                     api.DiffuseLight(api.SolidColor((4, 4, 4))))
    objs += [sun, panel]
    return api.Scene(objects=objs, lights=[sun, panel],
                     camera=api.CameraConfig(
                         aspect_ratio=16 / 9, image_width=64,
                         samples_per_pixel=4, max_depth=8, vfov=40,
                         lookfrom=(9, 4, 9), lookat=(0, 0.5, 0),
                         background=(0.05, 0.05, 0.08)),
                     name="vscan_mis_medium")


def grid_scene(api, n=17):
    """scripts/bench_large.py:46-62 (grid_scene): n^3 lambertian spheres
    under a sky; 17^3 = 4,913, the >4,096-primitive regime."""
    import numpy as np
    objs = []
    rng = np.random.default_rng(0)
    for i in range(n):
        for j in range(n):
            for k in range(n):
                albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
                objs.append(api.Sphere(
                    (i * 2.0, j * 2.0, k * 2.0), 0.45,
                    api.Lambertian(api.SolidColor(albedo))))
    cam = api.CameraConfig(aspect_ratio=16 / 9, image_width=400,
                           samples_per_pixel=9, max_depth=8, vfov=40,
                           lookfrom=(n * 3.0, n * 2.2, n * 3.0),
                           lookat=(n * 1.0, n * 1.0, n * 1.0),
                           background=(0.7, 0.8, 1.0))
    return api.Scene(objects=objs, lights=[], camera=cam, name="grid")


def bvh_mixed_scene(api):
    """tests/test_pallas.py::test_bvh_mode_matches_oracle (132): 60 spheres
    (every fourth metal) and 45 quads in mixed BVH leaves under a sphere
    light, 48 px, spp4, d4: the stack BVH's (K11) leaves of both kinds."""
    import numpy as np
    rng = np.random.default_rng(7)
    objs = []
    for i in range(60):
        c = tuple(map(float, rng.uniform(-5, 5, 3)))
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        m = (api.Lambertian(api.SolidColor(albedo)) if i % 4
             else api.Metal(albedo, fuzz=0.3))
        objs.append(api.Sphere(c, 0.45, m))
    for i in range(45):
        c = rng.uniform(-5.0, 5.0, 3)
        u = rng.uniform(0.4, 1.3, 3) * np.array([1.0, 0.0, 1.0])
        v = rng.uniform(0.4, 1.3, 3) * np.array([0.0, 1.0, 1.0])
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        objs.append(api.Quad(tuple(map(float, c)), tuple(map(float, u)),
                             tuple(map(float, v)),
                             api.Lambertian(api.SolidColor(albedo))))
    light = api.Sphere((0, 9, 0), 2.0,
                       api.DiffuseLight(api.SolidColor((5, 5, 5))))
    objs.append(light)
    return api.Scene(objects=objs, lights=[light], camera=api.CameraConfig(
        image_width=48, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        vfov=45, lookfrom=(0, 2, 12), lookat=(0, 0, 0),
        background=(0.4, 0.5, 0.7)), name="bvh_mixed")


def bvh_sphere_scene(api):
    """tests/test_pallas.py::test_lane_bvh_mode_matches_oracle (211): 90
    spheres (every third metal, every seventh moving) under a sphere light,
    48 px, spp4, d4: the lane BVH's (K12) all-sphere case with movers."""
    import numpy as np
    rng = np.random.default_rng(11)
    objs = []
    for i in range(90):
        c = tuple(map(float, rng.uniform(-5, 5, 3)))
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        m = (api.Lambertian(api.SolidColor(albedo)) if i % 3
             else api.Metal(albedo, fuzz=0.2))
        c2 = (c[0], c[1] + 0.3, c[2]) if i % 7 == 0 else None
        objs.append(api.Sphere(c, 0.45, m, center2=c2))
    light = api.Sphere((0, 9, 0), 2.0,
                       api.DiffuseLight(api.SolidColor((5, 5, 5))))
    objs.append(light)
    return api.Scene(objects=objs, lights=[light], camera=api.CameraConfig(
        image_width=48, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        vfov=45, lookfrom=(0, 2, 12), lookat=(0, 0, 0),
        background=(0.4, 0.5, 0.7)), name="bvh_spheres")


def bvh_chain_scene(api, n=40):
    """n spheres along the x axis at doubling distances and radii, seen
    along the axis, beside a 6 x 5 block of small spheres (past the
    unrolled bound of 64 primitives), 48 px, spp4, d4: the SAH tree peels
    the far spheres off level by level, so the stack walk (K11) goes down a
    chain with every far child met (the boxes' pad grows with the scene's
    largest coordinate) and pushed, its stack more than 8 entries deep."""
    objs = []
    for i in range(n):
        x = float(2.0 ** i) - 1.0
        albedo = (0.3 + 0.6 * ((i * 7) % 10) / 10.0, 0.5, 0.6)
        objs.append(api.Sphere((x, 0.1 * (i % 3), 0.0), 0.3 * 1.5 ** i,
                               api.Lambertian(api.SolidColor(albedo))))
    for i in range(30):
        objs.append(api.Sphere((float(i % 6), -4.0, 2.0 + float(i // 6)),
                               0.3, api.Metal((0.8, 0.8, 0.7), fuzz=0.1)))
    return api.Scene(objects=objs, lights=[], camera=api.CameraConfig(
        image_width=48, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        vfov=60, lookfrom=(-6, 0.5, 0.5), lookat=(10, -1, 1),
        background=(0.4, 0.5, 0.7)), name="bvh_chain")


def city_scene(api, n_boxes=50):
    """scripts/bench_large.py:30-43 (city_scene): 6 n_boxes + 1 quads, the
    quad-chunk regime (K7): 301 at 50 boxes."""
    import numpy as np
    rng = np.random.default_rng(3)
    objs = []
    for _ in range(n_boxes):
        x, z = rng.uniform(-20, 20, 2)
        hgt = float(rng.uniform(1, 6))
        albedo = tuple(map(float, rng.uniform(0.3, 0.9, 3)))
        objs.append(api.Box((x, 0, z), (x + 1.5, hgt, z + 1.5),
                            api.Lambertian(api.SolidColor(albedo))))
    objs.append(api.Quad((-40, 0, -40), (80, 0, 0), (0, 0, 80),
                         api.Lambertian(api.SolidColor((0.5, 0.5, 0.5)))))
    cam = api.CameraConfig(aspect_ratio=16 / 9, image_width=400,
                           samples_per_pixel=9, max_depth=6,
                           lookfrom=(30, 12, 30), lookat=(0, 2, 0),
                           sky_gradient=True)
    return api.Scene(objects=objs, camera=cam, name="city")


# Scenes of the chunk scan's grad tiers (K3v, K4v, K8), from the JAX
# package's tests of them (tests/test_grad.py); each takes the scene API
# module, as above.
def scan_tex_scene(api):
    """tests/test_grad.py::test_scan_mode_fused_tex_grad_matches_kernel_fd
    (427): 80 spheres of 4 materials (a checker among them) and a quad
    light, 7 texture rows: the weight planes on the chunk scan (K3v)."""
    import numpy as np
    rng = np.random.default_rng(2)
    mats = [api.Lambertian(api.SolidColor((.8, .3, .2))),
            api.Lambertian(api.SolidColor((.2, .7, .4))),
            api.Lambertian(api.Checker(0.8, api.SolidColor((.9, .9, .1)),
                                       api.SolidColor((.1, .1, .8)))),
            api.Metal((.9, .8, .7), 0.2)]
    objs = [api.Sphere(tuple(map(float, rng.uniform(-4, 4, 3))), 0.35,
                       mats[i % len(mats)]) for i in range(80)]
    objs.append(api.Quad((-6, -6, -7), (12, 0, 0), (0, 12, 0),
                         api.DiffuseLight(api.SolidColor((4., 4., 4.)))))
    cam = api.CameraConfig(aspect_ratio=1.0, image_width=16,
                           samples_per_pixel=4, max_depth=3, vfov=60,
                           lookfrom=(0, 0, 9), lookat=(0, 0, 0),
                           background=(0.2, 0.25, 0.3))
    return api.Scene(objects=objs, lights=[], camera=cam, name="scan_grad")


def vscan_slots_scene(api):
    """tests/test_grad.py::test_vscan_hard_slots_match_kernel_fd (595): 78
    spheres (metals, one glass, lambertians) and a sphere light; with
    vscan_slots, one hard slot per family on the chunk scan (K4v)."""
    import numpy as np
    rng = np.random.default_rng(21)
    objs = []
    for i in range(78):
        c = tuple(map(float, rng.uniform(-4, 4, 3)))
        albedo = tuple(map(float, rng.uniform(0.25, 0.9, 3)))
        m = (api.Metal(albedo, fuzz=0.25) if i % 9 == 0 else
             api.Dielectric(1.5) if i == 4 else
             api.Lambertian(api.SolidColor(albedo)))
        objs.append(api.Sphere(c, 0.5, m))
    light = api.Sphere((0, 8, 0), 2.0,
                       api.DiffuseLight(api.SolidColor((6., 6., 6.))))
    objs.append(light)
    return api.Scene(objects=objs, lights=[light], camera=api.CameraConfig(
        image_width=24, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        vfov=45, lookfrom=(0, 2, 11), lookat=(0, 0, 0),
        background=(0.3, 0.4, 0.6)), name="vscan_slots")


def adjoint_seg_scene(api):
    """tests/test_grad.py::test_adjoint_segmented_matches_per_sample (1181):
    78 spheres (a metal every ninth, a glass, the rest lambertian) and a
    sphere light, 10 px, spp4, d4."""
    import numpy as np
    rng = np.random.default_rng(21)
    objs = []
    for i in range(78):
        c = tuple(map(float, rng.uniform(-4, 4, 3)))
        albedo = tuple(map(float, rng.uniform(0.25, 0.9, 3)))
        mat = (api.Metal(albedo, fuzz=0.25) if i % 9 == 0 else
               api.Dielectric(1.5) if i == 4 else
               api.Lambertian(api.SolidColor(albedo)))
        objs.append(api.Sphere(c, 0.5, mat))
    light = api.Sphere((0, 8, 0), 2.0,
                       api.DiffuseLight(api.SolidColor((6., 6., 6.))))
    objs.append(light)
    return api.Scene(objects=objs, lights=[light], camera=api.CameraConfig(
        image_width=10, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        vfov=45, lookfrom=(0, 2, 11), lookat=(0, 0, 0),
        background=(0.3, 0.4, 0.6)))


def vscan_slots(mat_type, mat_metal: int, mat_diel: int) -> tuple:
    """The JAX test's 4 slots of vscan_slots_scene: the first metal's fuzz,
    the glass's IOR, sphere 7's center y and its radius."""
    import numpy as np
    mt = np.asarray(mat_type)
    return (("fuzz", int(np.where(mt == mat_metal)[0][0])),
            ("ior", int(np.where(mt == mat_diel)[0][0])),
            ("sphc", 7, 1), ("sphr", 7))


def rows_scene(api):
    """79 spheres over 27 materials (24 lambertian albedos, 2 metals, a
    glass) and a sphere light: 28 texture rows, between MAX_TEXS and
    MAX_GRAD_TEXS (K3v past the register planes' bound, its Gp summed in
    lane order)."""
    import numpy as np
    rng = np.random.default_rng(31)
    mats = ([api.Lambertian(api.SolidColor(tuple(map(
        float, rng.uniform(0.2, 0.9, 3))))) for _ in range(24)]
        + [api.Metal(tuple(map(float, rng.uniform(0.5, 0.9, 3))), 0.2)
           for _ in range(2)] + [api.Dielectric(1.5)])
    objs = [api.Sphere(tuple(map(float, rng.uniform(-4, 4, 3))), 0.5,
                       mats[i % len(mats)]) for i in range(79)]
    light = api.Sphere((0, 8, 0), 2.0,
                       api.DiffuseLight(api.SolidColor((6., 6., 6.))))
    objs.append(light)
    return api.Scene(objects=objs, lights=[light], camera=api.CameraConfig(
        image_width=24, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        vfov=45, lookfrom=(0, 2, 11), lookat=(0, 0, 0),
        background=(0.3, 0.4, 0.6)), name="rows_grad")


def room_scene(api):
    """rows_scene inside a closed room of six gray lambertian walls (29
    texture rows): no path escapes to the sky, so paths run to depth or to
    the light and scatter on many rows: K3v's planes of a path hold
    several rows (csrc/wavefront.cu, WpRows)."""
    scene = rows_scene(api)
    wall = api.Lambertian(api.SolidColor((0.75, 0.75, 0.75)))
    lo, hi = (-8.0, -6.0, -8.0), (8.0, 12.0, 14.0)
    dx, dy, dz = (hi[0] - lo[0], 0, 0), (0, hi[1] - lo[1], 0), \
        (0, 0, hi[2] - lo[2])
    scene.objects += [
        api.Quad(lo, dx, dz, wall),
        api.Quad((lo[0], hi[1], lo[2]), dx, dz, wall),
        api.Quad(lo, dx, dy, wall),
        api.Quad((lo[0], lo[1], hi[2]), dx, dy, wall),
        api.Quad(lo, dz, dy, wall),
        api.Quad((hi[0], lo[1], lo[2]), dz, dy, wall)]
    scene.name = "room"
    return scene


def metals_scene(api):
    """tests/test_torch_large_grad.py::_metals_scene's materials in view:
    80 unit spheres in a 10 x 8 wall, the first 30 metals of their own
    albedos (fuzz 0.3), the rest lambertians of one albedo that no metal
    shares: 31 texture rows and 30 fuzz slots. tex_color with those slots
    took the adjoint (K9) while the planes of 17 to 32 rows were in shared
    memory (a block could not hold them beside 30 tangent bundles), and
    runs K3v with K4v's slots since. Under the sky gradient, so the fuzz
    moves the radiance (no light)."""
    lam = api.Lambertian(api.SolidColor((0.45, 0.45, 0.45)))
    objs = [api.Sphere((2.5 * (i % 10) - 11.25, 2.5 * (i // 10) - 8.75,
                        -1.5 * ((i * 7) % 3)), 1.0,
                       api.Metal((0.5, 0.4 + 0.01 * i, 0.5), 0.3)
                       if i < 30 else lam) for i in range(80)]
    return api.Scene(objects=objs, camera=api.CameraConfig(
        image_width=24, aspect_ratio=16 / 9, samples_per_pixel=4,
        max_depth=4, vfov=50, lookfrom=(0, 4, 26), lookat=(0, 0, 0),
        sky_gradient=True), name="metals31")


def suffix_scene(api):
    """tests/test_grad.py::test_suffix_tex_grad_matches_weight_planes
    (493): 40 spheres of their own albedos (every fifth metal) and a sphere
    light, 41 texture rows: past MAX_GRAD_TEXS, so the suffix tier (K8)."""
    import numpy as np
    rng = np.random.default_rng(5)
    objs = []
    for i in range(40):
        c = tuple(map(float, rng.uniform(-4, 4, 3)))
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        m = (api.Metal(albedo, fuzz=0.2) if i % 5 == 0
             else api.Lambertian(api.SolidColor(albedo)))
        objs.append(api.Sphere(c, 0.5, m))
    light = api.Sphere((0, 8, 0), 2.0,
                       api.DiffuseLight(api.SolidColor((6., 6., 6.))))
    objs.append(light)
    return api.Scene(objects=objs, lights=[light], camera=api.CameraConfig(
        image_width=24, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        vfov=45, lookfrom=(0, 2, 11), lookat=(0, 0, 0),
        background=(0.3, 0.4, 0.6)), name="suffix_grad")


def nt16_scene(api):
    """15 spheres of their own albedos and a sphere light under a dark sky,
    16 texture rows: the unrolled tex grad instance at its NTMAX 16."""
    import numpy as np
    rng = np.random.default_rng(3)
    objs = [api.Sphere(tuple(map(float, rng.uniform(-3, 3, 3))), 0.7,
                       api.Lambertian(api.SolidColor(
                           tuple(map(float, rng.uniform(0.2, 0.9, 3))))))
            for _ in range(15)]
    light = api.Sphere((0, 6, 0), 1.5,
                       api.DiffuseLight(api.SolidColor((5., 5., 5.))))
    return api.Scene(objects=objs + [light], lights=[light],
                     camera=api.CameraConfig(
                         image_width=64, aspect_ratio=1.0, vfov=50,
                         lookfrom=(0, 1, 10), lookat=(0, 0, 0),
                         background=(0.1, 0.1, 0.15)), name="nt16")


def wide(scene, width, spp, depth):
    """sized() at 16:9, width x width * 9/16 (1200x675 at 1200)."""
    scene.camera.aspect_ratio = 16 / 9
    return sized(scene, width, spp, depth)


def sized(scene, width, spp, depth):
    scene.camera.image_width = width
    scene.camera.samples_per_pixel = spp
    scene.camera.max_depth = depth
    return scene


def builtin(pt, name, width, spp, depth):
    scene = pt.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = width
    scene.camera.samples_per_pixel = spp
    scene.camera.max_depth = depth
    return scene


def pass_args(pt, scene, dev, use_bvh=False):
    """(flat, cam, kw) for one whole-image pass of every stratum."""
    from real_time_ray_tracing_engine_tpu_torch.models import camera as cm
    cfg = scene.camera
    flat = pt.compile_scene(scene, use_bvh=use_bvh, device=dev)
    cam = cm.derive(cfg, device=dev)
    w, h = cm.image_size(cfg)
    n_strata = cm.sqrt_spp(cfg)
    kw = dict(width=w, height=h, n_strata=n_strata, max_depth=cfg.max_depth,
              n_samples=n_strata * n_strata, sky_gradient=cfg.sky_gradient)
    return flat, cam, kw


def cornell_1080p(pt, spp, depth):
    """Cornell at 1920x1080 (bench.py:132-137)."""
    scene = builtin(pt, "cornell_box", TRAIN_W, spp, depth)
    scene.camera.aspect_ratio = TRAIN_W / TRAIN_H
    return scene


def cotangent(torch, kw, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(kw["height"], kw["width"], 3, generator=gen,
                       device=dev)


# The reverse bounce's branches (adjoint_bounce_probe): per branch a scene,
# its sky, and rays aimed at the branch from seeded numpy draws; the lanes
# whose plain bounce takes the branch (probe_labels) are held against
# _bounce_vjp. Each case: (branch, scene name, sky_gradient, origin, aim
# point and jitter of the aim, aim offset from the sphere's silhouette for
# the grazing rays).
PROBE_LANES = 96
PROBE_USE = 24            # lanes of a branch held against the plain VJP
# the kernel's reverse bounce against torch autograd of the bounce, per
# branch: the largest difference over its lanes' entries (the state's
# cotangent and every accumulator entry) within PROBE_RTOL of the largest
# entry (two float32 reverses of the same operations in other orders; on
# the CPU the same C++ differs from torch by at most 3.8e-5 of a lane's
# largest entry, on the sphere-light scene's ground sphere of radius 1000)
PROBE_RTOL = 1e-4
PROBE_CASES = (
    ("miss_flat_sky", "simple_sphere", False, (0, 2, 0), (0, 10, 0), 6.0),
    ("miss_sky_gradient", "simple_sphere", True, (0, 2, 0), (0, 10, 0),
     6.0),
    ("emission", "cornell_box", False, (278, 278, 278), (278, 554, 279),
     50.0),
    ("mis_sphere_light", "materials", False, (0, 3, 5), (0, 0, 2.3), 0.6),
    ("mis_quad_light", "cornell_box", False, (278, 400, 100),
     (130, 0, 420), 80.0),
    ("isotropic_medium", "cornell_smoke", False, (183, 82, -300),
     (183, 82, 169), 40.0),
    ("metal", "materials", False, (8, 1.2, 3), (4, 1, 0), 0.3),
    ("dielectric_reflect", "materials", False, None, None, 0.0),
    ("dielectric_refract", "materials", False, (0, 1, 5), (0, 1, 0), 0.2),
    ("noise_texture", "nested_checker", True, (0, 2, 6), (0, 0.513, 1),
     3.0),
    ("grazing_sphere", "simple_sphere", True, (0, 0, 1), None, 0.0),
)


def probe_scene(pt, name):
    if name == "materials":
        return materials_scene(pt)
    if name == "nested_checker":
        return nested_checker_scene(pt)
    return pt.builders.BUILTIN_SCENES[name]()


def probe_rays(torch, case, dev, n=PROBE_LANES, seed=3):
    """(o, d, th, tm, pix, sample, bounce) of one probe case's n lanes."""
    import numpy as np
    name, _, _, org, aim, jit = case
    g = np.random.default_rng(seed)
    if name == "dielectric_reflect":
        # inside materials' glass sphere (center (0, 1, 0), radius 1), 0.9
        # from the center, across: the surface is met at sin 0.9 > 1/1.5,
        # total internal reflection
        ang = g.uniform(0, 2 * np.pi, n)
        side = np.stack([np.cos(ang), np.zeros(n), np.sin(ang)], 1)
        o = np.array([0.0, 1.0, 0.0]) + 0.9 * side \
            + g.normal(0, 0.01, (n, 3))
        d = np.cross(side, [0.0, 1.0, 0.0]) + g.normal(0, 0.05, (n, 3))
    elif name == "grazing_sphere":
        # past simple_sphere's ball (center (0, 0, -1), radius 0.5), aimed
        # 1e-4 to 1e-2 of a radius inside its silhouette
        ang = g.uniform(0, 2 * np.pi, n)
        side = np.stack([np.cos(ang), np.sin(ang), np.zeros(n)], 1)
        eps = 10.0 ** g.uniform(-4, -2, n)
        o = np.tile(np.asarray(org, float), (n, 1))
        target = np.array([0.0, 0.0, -1.0]) + 0.5 * (1 - eps)[:, None] * side
        d = target - o
    else:
        o = np.tile(np.asarray(org, float), (n, 1))
        d = np.asarray(aim, float) + g.uniform(-jit, jit, (n, 3)) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    th = g.uniform(0.2, 1.0, (n, 3))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    i64 = lambda a: torch.tensor(a, dtype=torch.int64, device=dev)
    return (f32(o), f32(d), f32(th), f32(g.uniform(0, 1, n)),
            i64(np.arange(n)), i64(g.integers(0, 16, n)),
            i64(g.integers(0, 3, n)))


def probe_labels(torch, flat, o, d, th, tm, pix, sample, bounce, seed,
                 sky_gradient, background):
    """Each lane's branch under the plain bounce (the probe's names;
    "lambertian_mis" for a lambertian hit, "other" elsewhere)."""
    from real_time_ray_tracing_engine_tpu_torch.ops import integrator as ig
    from real_time_ray_tracing_engine_tpu_torch.ops import textures as tx
    from real_time_ray_tracing_engine_tpu_torch.utils import rng
    from real_time_ray_tracing_engine_tpu_torch.scene import flat as fl
    keys = rng.ray_keys(seed, pix, sample)
    u = rng.bounce_uniforms(keys, bounce)
    u_med = ig.medium_uniforms(flat, keys, bounce)
    with torch.no_grad():
        rec = ig.resolve_hit(flat, o, d, tm, u_med)
        _, _, d2, _, alive = ig.bounce_step(flat, o, d, tm, th,
                                            torch.ones_like(rec.hit), u,
                                            u_med, background, sky_gradient)
        mt = flat.mat_type[rec.mat]
        eff = tx.effective_row(flat, flat.mat_tex[rec.mat], rec.point)
        cos_in = (d * rec.normal).sum(1)
        cos_out = (d2 * rec.normal).sum(1)
    out = []
    for i in range(o.shape[0]):
        if not bool(rec.hit[i]):
            lab = "miss"
        elif int(mt[i]) == fl.MAT_DIFFUSE_LIGHT:
            lab = "emission" if bool(rec.front_face[i]) else "other"
        elif not bool(alive[i]):
            lab = "other"
        elif int(mt[i]) == fl.MAT_ISOTROPIC:
            lab = "isotropic_medium"
        elif int(mt[i]) == fl.MAT_METAL:
            lab = "metal"
        elif int(mt[i]) == fl.MAT_DIELECTRIC:
            lab = ("dielectric_refract"
                   if float(cos_in[i]) * float(cos_out[i]) > 0.0
                   else "dielectric_reflect")
        elif int(eff[i]) < 0:
            lab = "noise_texture"
        else:
            lab = "lambertian_mis"
        out.append(lab)
    return out


def probe_run(torch, pt, ac, case, dev, pass_fn, seed=7):
    """(lanes used, their labels, lam_in, rows) of one probe case through
    pass_fn (ac.adjoint_bounce_probe or its plain version): the case's rays
    on the card, the lanes of its branch (at most PROBE_USE), seeded
    cotangents."""
    import numpy as np
    from real_time_ray_tracing_engine_tpu_torch.models import camera as cm
    scene = probe_scene(pt, case[1])
    flat = pt.compile_scene(scene, device=dev)
    cam = cm.derive(scene.camera, device=dev)
    o, d, th, tm, pix, sample, bounce = probe_rays(torch, case, dev)
    labels = probe_labels(torch, flat, o, d, th, tm, pix, sample, bounce,
                          seed, case[2], cam.background)
    idx = torch.tensor([i for i, lab in enumerate(labels)
                        if lab == probe_wanted(case)][:PROBE_USE],
                       device=dev)
    gen = np.random.default_rng(11)
    g = torch.tensor(gen.standard_normal((idx.numel(), 3)),
                     dtype=torch.float32, device=dev)
    lam = torch.tensor(gen.standard_normal((idx.numel(), 9)),
                       dtype=torch.float32, device=dev)
    lam_in, rows = pass_fn(flat, cam, o[idx], d[idx], th[idx], tm[idx],
                           pix[idx], sample[idx], bounce[idx], g, lam,
                           seed=seed, sky_gradient=case[2])[:2]
    return idx, lam_in, rows


def probe_wanted(case) -> str:
    """The label a case's lanes are held at (probe_labels')."""
    name = case[0]
    if name.startswith("miss"):
        return "miss"
    if name.startswith("mis_") or name == "grazing_sphere":
        return "lambertian_mis"
    return name


def adjoint_errors(got, want) -> dict:
    """Per family of the adjoint's grads: the largest |got - want| and the
    largest |want|."""
    return {f: {"max_abs_err": float((got[f] - want[f]).abs().max()),
                "scale": float(want[f].abs().max())} for f in want}


def full_family_start(wc, train, flat):
    """full_train_main_path's start on Cornell: (its hard slots, the glass
    material rows, the glass sphere rows, every family's parameters, the
    three wall rows dimmed to 0.7 and the glass at START_IOR and
    START_RADIUS; detached copies)."""
    slots = wc.hard_param_slots(flat)
    glass_mats = [sl[1] for sl in slots if sl[0] == "ior"]
    glass_rows = [sl[1] for sl in slots if sl[0] == "sphr"]
    params = {k: v.detach().clone() for k, v in train.get_params(flat).items()}
    params["tex_color"][WALL_ROWS] *= 0.7
    params["mat_ior"][glass_mats] = START_IOR
    params["sph_radius"][glass_rows] = START_RADIUS
    return slots, glass_mats, glass_rows, params


def full_family_adam(torch, params):
    """Adam at TRAIN_LR for tex_color, IOR and fuzz and at GEOM_LR for the
    sphere centers and radii."""
    return torch.optim.Adam([
        {"params": [params["tex_color"], params["mat_ior"],
                    params["mat_fuzz"]], "lr": TRAIN_LR},
        {"params": [params["sph_center"], params["sph_radius"]],
         "lr": GEOM_LR}])


def adjoint_training_start(torch, train, wc, flat, cam, kw, engine):
    """The adjoint's 1200x675 training start on bouncing_spheres under the
    sky gradient: (params, target), the target the render at the true
    parameters, the params (all five families, requiring grad) the glass
    at START_IOR, the three large spheres' centers moved by 3% of their
    radius and their radii grown 3%, and large-scene training's rows (the
    ground checker's leaves and the two last spheres' colors) at 0.7."""
    target = train.make_kernel_render(flat, engine=engine, **kw)(
        {"tex_color": flat.tex_color}, cam, TRAIN_SEED).detach()
    params = {k: v.detach().clone() for k, v in train.get_params(flat).items()}
    S = flat.sph_center.shape[0]
    mtex = flat.mat_tex[flat.sph_mat.long()].tolist()
    rows = [int(flat.tex_child_even[mtex[0]]),
            int(flat.tex_child_odd[mtex[0]]), mtex[S - 2], mtex[S - 1]]
    params["tex_color"][rows] *= 0.7
    params["mat_ior"][[s[1] for s in wc.hard_param_slots(
        flat, {"mat_ior"})]] = START_IOR
    hero = torch.argsort(flat.sph_radius, descending=True)[1:4]
    params["sph_center"][hero] += 0.03 * flat.sph_radius[hero][:, None] * \
        torch.tensor([1.0, 0.0, -1.0], device=flat.device)
    params["sph_radius"][hero] *= 1.03
    for v in params.values():
        v.requires_grad_(True)
    return params, target


def adjoint_optimizer(torch, params, geom_lr):
    """Adam over all five families: TRAIN_LR for tex_color, IOR and fuzz,
    geom_lr for the sphere centers and radii."""
    return torch.optim.Adam([
        {"params": [params["tex_color"], params["mat_ior"],
                    params["mat_fuzz"]], "lr": TRAIN_LR},
        {"params": [params["sph_center"], params["sph_radius"]],
         "lr": geom_lr}])


def ptxas_table(log: str) -> dict:
    """Per kernel of an nvcc build log (-Xptxas -v): its registers, stack
    frame and spill stores, as ptxas prints them."""
    lines = log.splitlines()
    out = {}
    for i, ln in enumerate(lines[:-2]):
        if "Function properties for " in ln:
            name = ln.split("Function properties for ")[-1].strip()
            regs = lines[i + 2].split("Used ")[-1].split(",")[0]
            out[name] = f"{regs}; {lines[i + 1].strip()}"
    return out


# the redesigned instances' symbols (patterns of the mangled names): K3,
# the tex grad's own kernel (wavefront_tex_grad_kernel<8|16>), and K8, the
# suffix tier on the chunk scan with and without K4v's slots
# (wavefront_grad_vscan_kernel<0, *, true, false>)
K3_SYMBOL = "_Z25wavefront_tex_grad_kernelILi"
K8_SYMBOL = "_Z27wavefront_grad_vscan_kernelILi0ELb[01]ELb1EE"
# K3v, the chunk scan's row planes (wavefront_planes_vscan_kernel<HARD>):
# alone, and with K4v's tangent bundles (True)
K3V_SYMBOL = {False: "_Z29wavefront_planes_vscan_kernelILb0E",
              True: "_Z29wavefront_planes_vscan_kernelILb1E"}


def ptxas_prefix(log: str, pattern: str) -> dict:
    """ptxas_table's entries whose kernel names start with `pattern` (a
    regular expression)."""
    pat = re.compile(pattern)
    return {k: v for k, v in ptxas_table(log).items() if pat.match(k)}


def ptxas_hard(log: str, kernel: str) -> dict:
    """ptxas_table's entries of a grad kernel's instances with tangent
    bundles (its second template argument, HARD, true)."""
    pat = re.compile(rf"\d{{2}}{kernel}ILi\d+ELb1E")
    return {k: v for k, v in ptxas_table(log).items() if pat.search(k)}


@contextlib.contextmanager
def kernel_mode_env(mode: str):
    """The kernel-mode knobs (ops/wavefront_cuda.py::kernel_env) set for
    `mode` while the block runs: "stack" RTX_BVH_STACK=1 (K11), "lane"
    RTX_LANE_BVH=1 (K12), "vscan" neither (the JAX rule's default)."""
    keys = ("RTX_BVH_STACK", "RTX_LANE_BVH")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ["RTX_BVH_STACK"] = "1" if mode == "stack" else "0"
    os.environ["RTX_LANE_BVH"] = "1" if mode == "lane" else "0"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def family_errors(slots, got, want) -> dict:
    """Per hard family: the largest |got - want| and the largest |want|."""
    out = {}
    for fam in ("fuzz", "ior", "sphc", "sphr"):
        idx = [k for k, s in enumerate(slots) if s[0] == fam]
        if idx:
            out[fam] = {"max_abs_err": float((got[idx] - want[idx]).abs()
                                             .max()),
                        "scale": float(want[idx].abs().max())}
    return out


def counted_bounces(torch, run, n_lanes, dev) -> int:
    """Bounces a kernel run traces, from the wrappers' iteration counter
    (an untimed run; the counter is off in the timed ones)."""
    iters = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    run(iters)
    return int(iters.sum())


class SplitClock:
    """Wall seconds per named step of one call: each wrapped function adds
    the time of its calls (the card synchronised on entry and exit) to its
    entry of `seconds`; restore() puts the originals back."""

    def __init__(self, torch, targets):
        self.seconds = {key: 0.0 for key, _, _ in targets}
        self.saved = []
        for key, owner, attr in targets:
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(torch, key, fn))

    def _wrap(self, torch, key, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.seconds[key] += time.perf_counter() - t0
        return timed

    def restore(self):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)


def pool(img, cell):
    h, w, _ = img.shape
    hc, wc = h // cell * cell, w // cell * cell
    x = img[:hc, :wc].reshape(hc // cell, cell, wc // cell, cell, 3)
    return x.mean(axis=(1, 3))


def pooled_rule(np, gold, ours) -> tuple:
    """tests/test_reference_images.py's pooled comparison of two byte
    images: (the mean of the cells' differences, the share of cells within
    ALLCLOSE_TOL)."""
    a = pool(gold.astype(np.float32) / 255.0, CELL)
    b = pool(ours.astype(np.float32) / 255.0, CELL)
    diff = np.abs(a - b).mean(axis=-1)
    return float(diff.mean()), float((diff < ALLCLOSE_TOL).mean())


def golden_scene(pt, np, name):
    """A reference golden's image, and its scene at the golden's width and
    depth."""
    gold = np.load(GOLDEN_DIR / f"{name}.npz")["image"]
    meta = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    scene = pt.load_scene(str(GOLDEN_DIR / f"{name}_scene.json"))
    scene.camera.image_width = meta["width"]
    scene.camera.max_depth = meta["depth"]
    return gold, scene


# the dynamic camera's move in progressive_large (lookfrom and lookat)
LARGE_MOVE = (0.5, 0.25, -1.0)
# progressive_times: a step of each k, wall median of PROG_REPS after one
# warm-up; the kernel reps start behind PROG_SLEEP_CYCLES of
# torch.cuda._sleep (a few ms), so the host has queued the step's launches
# before the card reaches them and the events bracket only their work
PROG_KS, PROG_REPS, PROG_SLEEP_CYCLES = (1, 4, 16), 5, 10_000_000


class CallCount:
    """Counts the calls of owner.attr while installed; restore() puts the
    original back."""

    def __init__(self, owner, attr):
        self.owner, self.attr, self.fn = owner, attr, getattr(owner, attr)
        self.calls = 0

        def counted(*args, **kwargs):
            self.calls += 1
            return self.fn(*args, **kwargs)
        setattr(owner, attr, counted)

    def restore(self):
        setattr(self.owner, self.attr, self.fn)


def reset_forward_counts(wc, rd):
    wc.render_pass_kernel.launches = 0
    wc.render_pass_kernel.launches_vscan = 0
    wc.render_pass_kernel.launches_vquad = 0
    wc.render_pass_reference.calls = 0
    rd._render_pass.calls = 0


def plain_calls(wc, rd) -> int:
    return wc.render_pass_reference.calls + rd._render_pass.calls


def progressive_phases(torch, np, pt, wc, rd, cli, dev, card, done) -> dict:
    """The dynamic camera on the card (models/render.py::
    ProgressiveRenderer, models/viewer.py, the CLI's --camera dynamic,
    --checkpoint, --frames, --view, -d): five phases, each a JSON line.
    Returns the launch counts the kernels line reads."""
    import io
    from real_time_ray_tracing_engine_tpu_torch.models import viewer
    from real_time_ray_tracing_engine_tpu_torch.utils import color
    out = {}
    Path("output").mkdir(exist_ok=True)

    # 12. the CLI's dynamic camera on cornell_box at its own 600x600 spp100
    # d50: 40 strata with --frames 40 --checkpoint, then a second run that
    # resumes at 40 and converges at 100, one forward launch a stratum and
    # no plain pass; its PPM and its final checkpoint's acc / 100 equal
    # render() in passes of one sample (the same passes summed in the same
    # order) bit for bit. Then the progressive renderer on the cornell_box
    # golden's scene meets reference_images' pooled rule.
    ckpt = Path("output") / "progressive_cornell.npz"
    ppm_path = Path("output") / "progressive_cornell.ppm"
    for f in (ckpt, ppm_path):
        if f.exists():
            f.unlink()
    argv = ["--scene", "cornell_box", "--camera", "dynamic", "--checkpoint",
            str(ckpt), "--output", "progressive_cornell"]
    reset_forward_counts(wc, rd)
    walls = []
    for extra in (["--frames", "40"], []):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv + extra)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(rc == 0, f"cli.main({argv + extra}) returned {rc}")
        with np.load(ckpt) as d:
            taken = int(d["samples_taken"])
            acc = d["acc"]
        check(taken == (40 if extra else 100),
              f"the checkpoint holds {taken} strata after {extra or 'resume'}")
    launches = wc.render_pass_kernel.launches
    plain = plain_calls(wc, rd)
    check(launches == 100, f"the dynamic CLI launched the forward kernel "
          f"{launches} times for 100 strata")
    check(plain == 0, "the dynamic CLI ran the plain engine")
    img = pt.render(pt.builders.cornell_box(), device=dev,
                    samples_per_batch=1, schedule="single",
                    progress=lambda s, t: None)
    same_ppm = ppm_path.read_bytes() == color.encode_ppm_p3(
        color.to_bytes(img))
    same_acc = bool(torch.equal(torch.from_numpy(acc).to(dev) / 100, img))
    check(same_ppm, "the resumed dynamic CLI's PPM differs from render() "
          "in passes of one sample")
    check(same_acc, "the final checkpoint's acc / 100 differs from render() "
          "in passes of one sample")
    gold, gscene = golden_scene(pt, np, "cornell_box")
    spp, mean_tol, min_rate = REF_SCENES["cornell_box"]
    gscene.camera.samples_per_pixel = spp
    prog = pt.ProgressiveRenderer(gscene, device=dev, seed=11)
    while prog.step(4):
        pass
    mean_diff, rate = pooled_rule(np, gold, pt.to_bytes(prog.image()))
    out["main"] = {"launches": launches}
    emit("progressive_main_path", card=card, argv=argv,
         shape="600x600 spp100 d50", frames_then_resume=[40, 60],
         kernel_launches=launches, plain_calls=plain,
         cli_wall_s=walls, strata_per_s=[40 / walls[0], 60 / walls[1]],
         ppm_equal_render=same_ppm, acc_equal_render=same_acc,
         golden={"scene": "cornell_box", "spp": spp,
                 "cell_mean_diff": mean_diff, "allclose_rate": rate,
                 "mean_tol": mean_tol, "min_rate": min_rate})
    check(mean_diff < mean_tol and rate >= min_rate,
          f"progressive cornell_box golden: cell mean diff {mean_diff}, "
          f"allclose rate {rate}")
    done("progressive_main_path")

    # 12b. ProgressiveRenderer on bouncing_spheres at its own 1200x675
    # spp100 d50 through the chunk scan (K6): steps doubling as
    # AdaptiveWork's k does at a high frame rate (1, 2, 4, 8: the 8 on the
    # compacted schedule, K2 over K6) until 10 strata are passed (15), one
    # move_camera, then steps of 16 to convergence, which equal render()
    # of the moved scene in batches of 16 bit for bit (the camera-only
    # repack against a fresh packing). Then save, load into a fresh
    # renderer, and a checkpoint refused by another scene.
    import dataclasses
    scene = pt.builders.bouncing_spheres()
    reset_forward_counts(wc, rd)
    compacted = CallCount(rd, "render_pass_compacted")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog = pt.ProgressiveRenderer(scene, device=dev)
        ctrl, ks = viewer.AdaptiveWork(), []
        while prog.samples_taken < 10:
            ks.append(ctrl.k)
            prog.step(ctrl.k)
            ctrl.update(math.inf)
        before_move = prog.samples_taken
        prog.move_camera(LARGE_MOVE)
        while not prog.converged:
            ks.append(min(16, 100 - prog.samples_taken))
            prog.step(16)
        torch.cuda.synchronize()
        prog_s = time.perf_counter() - t0
    finally:
        compacted.restore()
    vscan = wc.render_pass_kernel.launches_vscan
    launches = wc.render_pass_kernel.launches
    plain = plain_calls(wc, rd)
    check(vscan > 0, "progressive bouncing_spheres never launched the chunk "
          "scan")
    check(vscan == launches, f"{launches - vscan} launches off the chunk "
          "scan")
    check(plain == 0, "progressive bouncing_spheres ran the plain engine")
    check(compacted.calls > 0, "no compacted step (K2) in progressive "
          "bouncing_spheres")
    moved = pt.builders.bouncing_spheres()
    c = moved.camera
    moved.camera = dataclasses.replace(
        c, lookfrom=tuple(a + b for a, b in zip(c.lookfrom, LARGE_MOVE)),
        lookat=tuple(a + b for a, b in zip(c.lookat, LARGE_MOVE)))
    check(moved.camera == prog.cfg, "the moved camera's configuration")
    img = pt.render(moved, device=dev, samples_per_batch=16,
                    progress=lambda s, t: None)
    same = bool(torch.equal(prog.image(), img))
    check(same, "progressive bouncing_spheres after move_camera differs "
          "from render() at the moved camera in batches of 16")
    path = Path("output") / "progressive_bouncing.npz"
    prog.save(str(path))
    again = pt.ProgressiveRenderer(pt.builders.bouncing_spheres(),
                                   device=dev)
    again.load(str(path))
    check(again.cfg == prog.cfg and again.samples_taken == 100
          and bool(torch.equal(again.acc, prog.acc)),
          "the loaded checkpoint differs from the saved renderer")
    other = pt.builders.bouncing_spheres()
    other.objects = other.objects[:-1]
    refused = None
    try:
        pt.ProgressiveRenderer(other, device=dev).load(str(path))
    except rd.CheckpointMismatch as e:
        refused = str(e)
    check(refused is not None and "another scene" in refused,
          "a checkpoint of bouncing_spheres loaded into another scene")
    out["large"] = {"launches_vscan": vscan, "compacted_steps":
                    compacted.calls}
    emit("progressive_large", card=card, shape="1200x675 spp100 d50",
         steps=ks, strata_before_move=before_move, move=LARGE_MOVE,
         launches=launches, launches_vscan=vscan,
         compacted_steps=compacted.calls, plain_calls=plain,
         progressive_s=prog_s, equal_render_after_move=same,
         checkpoint_mib=path.stat().st_size / 2**20,
         refused_other_scene=refused)
    done("progressive_large")

    # 12c. the terminal viewer: run_viewer on cornell_box 600x600 spp100
    # d50 with a non-TTY stdin, its frames into a StringIO, at most 30
    # frames, adaptive steps; its preview equals the host's downsample of
    # image() byte for byte
    steps = []
    step_fn = rd.ProgressiveRenderer.step

    def step(self, k=1):
        steps.append((k, time.perf_counter()))
        return step_fn(self, k)
    reset_forward_counts(wc, rd)
    compacted = CallCount(rd, "render_pass_compacted")
    stdin, rd.ProgressiveRenderer.step = sys.stdin, step
    sys.stdin = io.StringIO()
    buf = io.StringIO()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog = viewer.run_viewer(pt.builders.cornell_box(), device=dev,
                                 max_frames=30, out=buf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sys.stdin, rd.ProgressiveRenderer.step = stdin, step_fn
        compacted.restore()
    launches = wc.render_pass_kernel.launches
    plain = plain_calls(wc, rd)
    got = prog.preview(80, 44)
    want = viewer._downsample(pt.to_bytes(prog.image()), 80, 44)
    same = bool(np.array_equal(got, want))
    frames = len(steps)
    fps = (frames - 1) / (steps[-1][1] - steps[0][1]) if frames > 1 else None
    emit("viewer", card=card, shape="600x600 spp100 d50", frames=frames,
         frames_per_s=fps, wall_s=wall, ks=[k for k, _ in steps],
         largest_k=max(k for k, _ in steps),
         samples_taken=prog.samples_taken, converged=prog.converged,
         kernel_launches=launches, compacted_steps=compacted.calls,
         plain_calls=plain, text_bytes=len(buf.getvalue()),
         preview_equal=same)
    check(launches > 0 and plain == 0, "the viewer's kernel launches "
          f"{launches}, plain calls {plain}")
    check(same, "the viewer's preview differs from the downsampled image")
    check("fps" in buf.getvalue(), "the viewer drew no frame")
    done("viewer")

    # 12d. one step's times: wall (host clock after torch.cuda.synchronize,
    # median of PROG_REPS after a warm-up), the forward launches' time in
    # the same step (CUDA events around each launch, behind a queued
    # torch.cuda._sleep) and the host's share of the wall, 1 - kernel /
    # wall; and preview(80, 44)
    times = {}
    for name, scene in (("cornell_box_600x600_d50", pt.builders.cornell_box()),
                        ("bouncing_spheres_1200x675_d50",
                         pt.builders.bouncing_spheres())):
        prog = pt.ProgressiveRenderer(scene, device=dev)
        run_pass, events = prog._run_pass, []

        def timed(*args, **kwargs):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            r = run_pass(*args, **kwargs)
            e.record()
            events.append((s, e))
            return r
        rec = {}
        for k in PROG_KS:
            walls, kerns = [], []
            for rep in range(PROG_REPS + 1):
                prog.reset()
                prog._run_pass = run_pass
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prog.step(k)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                prog.reset()
                prog._run_pass, events = timed, []
                torch.cuda.synchronize()
                torch.cuda._sleep(PROG_SLEEP_CYCLES)
                prog.step(k)
                torch.cuda.synchronize()
                kerns.append(sum(s.elapsed_time(e) for s, e in events))
            prog._run_pass = run_pass
            wall, kern = (float(np.median(v[1:])) for v in (walls, kerns))
            rec[f"k{k}"] = {"wall_ms": wall, "kernel_ms": kern,
                            "host_share": 1.0 - kern / wall,
                            "launches": len(events),
                            "wall_ms_runs": walls[1:],
                            "kernel_ms_runs": kerns[1:]}
        prev = []
        for rep in range(PROG_REPS + 1):
            t0 = time.perf_counter()
            prog.preview(80, 44)
            prev.append((time.perf_counter() - t0) * 1e3)
        rec["preview_80x44_ms"] = float(np.median(prev[1:]))
        rec["mode"] = wc.kernel_mode(prog.flat)[0]
        times[name] = rec
        emit("progressive_times", card=card, scene=name, **rec)
    out["times"] = times
    done("progressive_times")

    # 12e. the CLI's -d on bouncing_spheres -b: the flat-scene dump equals
    # golden_json of the same compile, and the complexity report is written
    logs = [Path("logs") / "flat_scene_debug.json",
            Path("logs") / "scene_complexity_debug.txt"]
    for f in logs:
        if f.exists():
            f.unlink()
    argv = ["--scene", "bouncing_spheres", "-b", "-d", "--samples", "16",
            "--output", "debug_dump"]
    rc = cli.main(argv)
    check(rc == 0, f"cli.main({argv}) returned {rc}")
    check(all(f.exists() for f in logs), f"-d wrote {logs}")
    want = pt.golden_json(pt.compile_scene(pt.builders.bouncing_spheres(),
                                           use_bvh=True))
    same = logs[0].read_text() == want
    report = logs[1].read_text()
    emit("debug_dump", argv=argv, json_bytes=logs[0].stat().st_size,
         json_equal_golden=same, report_head=report.splitlines()[:9])
    check(same, "-d's flat_scene_debug.json differs from golden_json")
    check("Scene Complexity: bouncing_spheres" in report,
          "-d's complexity report")
    done("debug_dump")
    return out


# ----------------------------------------------------------- the sharded layer
MESH_LAYOUTS = ((2, 1), (4, 1), (1, 2), (2, 2))
# a mesh's image against the one-process pass of the same samples: a
# tile-only layout under the single schedule bit for bit (a pixel's samples
# are summed by one thread, in order), any other within MESH_RTOL of the
# image's largest entry (the same samples summed in another order)
MESH_RTOL = 1e-5
# mesh_ranks: make_train_step(mesh=) steps over all five families. Each is
# held against the one-process step from the same parameters and Adam
# state, not against the one-process trajectory from the start: a mesh
# sums a gradient's parts in another order, which can round a parameter
# one float32 ulp away after Adam's update, and one ulp of the glass
# sphere's center moves its gradient row by 30-96% of its largest entry and
# the loss after 3 steps by 2.5-10% in one process (NVIDIA H100 80GB HBM3,
# 700 W; scripts/port_mesh_divergence.py, PERF.md §6). The phase
# prints full_train_main_path's losses, the one-process trajectory, beside
MESH_STEPS = 3
RANKS_S = 900              # the time limit of a spawned world or a CLI run
PPM_BYTE_TOL = 1           # a -p PPM against the one-process CLI's


def shard_sum(torch, mesh_mod, run_pass, flat, cam, layout, *, width,
              height, n_strata, max_depth, sky_gradient, schedule) -> tuple:
    """(the (height, width, 3) sum of every shard of `layout` rendered in
    this process, each shard's ms): render_shard of each, timed alone, the
    sample shards of a tile added in order, the tiles stacked, the padding
    of the last tile cropped."""
    n_tile, n_sample = layout
    total = n_strata * n_strata
    hp = -(-height // n_tile) * n_tile
    tiles, times = [], []
    for t in range(n_tile):
        acc = None
        for s in range(n_sample):
            row0, h, s0, spp = mesh_mod.local_shard(
                n_tile, n_sample, t, s).shard(hp, total)
            out = {}

            def one():
                out["img"] = mesh_mod.render_shard(
                    flat, cam, 7, width=width, h_local=h, row0=row0,
                    n_strata=n_strata, spp_local=spp, sample0=s0,
                    max_depth=max_depth, sky_gradient=sky_gradient,
                    schedule=schedule, run_pass=run_pass)
            times.append(cuda_ms(torch, one, reps=1, warmup=0))
            acc = out["img"] if acc is None else acc + out["img"]
        tiles.append(acc)
    return torch.cat(tiles)[:height], times


def mesh_train_steps(torch, train, flat, cam, kw, target, start, mesh,
                     dev) -> dict:
    """MESH_STEPS make_train_step(mesh=) steps over all five families of
    Cornell from `start` (full_family_adam): per step the loss, the step's
    seconds, its gradients (summed over the ranks) and the parameters and
    Adam state it started from; and the parameters after the last, all on
    the CPU."""
    params = {k: v.to(dev).clone().requires_grad_(True)
              for k, v in start.items()}
    opt = full_family_adam(torch, params)
    step = train.make_train_step(opt, flat=flat, engine="cuda", mesh=mesh,
                                 **kw)
    steps = []
    for _ in range(MESH_STEPS):
        before = {"params": {k: v.detach().cpu().clone()
                             for k, v in params.items()},
                  "adam": {k: {s: t.detach().cpu().clone() for s, t in
                               opt.state[v].items()}
                           for k, v in params.items() if opt.state[v]}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(params, cam, TRAIN_SEED, target))
        torch.cuda.synchronize()
        steps.append({"loss": loss, "s": time.perf_counter() - t0,
                      "grads": {k: v.grad.detach().cpu()
                                for k, v in params.items()}, **before})
    return {"steps": steps, "params": {k: v.detach().cpu()
                                       for k, v in params.items()}}


def one_process_step(torch, train, flat, cam, kw, target, before, dev):
    """The one-process step from a mesh step's starting point: (loss,
    gradients, parameters after full_family_adam's update), the Adam state
    `before["adam"]` restored."""
    params = {k: v.to(dev).clone().requires_grad_(True)
              for k, v in before["params"].items()}
    opt = full_family_adam(torch, params)
    for k, st in before["adam"].items():
        opt.state[params[k]] = {s: t.to(dev) if s != "step" else t.clone()
                                for s, t in st.items()}
    step = train.make_train_step(opt, flat=flat, engine="cuda", **kw)
    loss = float(step(params, cam, TRAIN_SEED, target))
    return (loss, {k: v.grad.detach().cpu() for k, v in params.items()},
            {k: v.detach().cpu() for k, v in params.items()})


def mesh_rank_worker(rank, n, init_method, job):
    """One of the ranks of mesh_ranks, on the card with the others (gloo):
    render_on_mesh of Cornell 600^2 spp16 d50 on each layout, MESH_STEPS
    make_train_step(mesh=) steps over all five families at Cornell
    1920x1080 spp64 d50 from full_train_main_path's start (mesh_train_
    steps), and on the (1, 2) layout one all-family adjoint step on
    bouncing_spheres 1200x675 spp16 d50 under the sky gradient. Returns
    its images, losses, parameters, gradients, times and the kernels'
    launch counts."""
    import torch
    sys.path.insert(0, str(ROOT))
    import real_time_ray_tracing_engine_tpu_torch as pt
    from real_time_ray_tracing_engine_tpu_torch.models import render as rd
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
    from real_time_ray_tracing_engine_tpu_torch.parallel import distributed
    from real_time_ray_tracing_engine_tpu_torch.parallel import mesh as pm
    from real_time_ray_tracing_engine_tpu_torch.parallel import train
    distributed.initialize(device="cuda", init_method=init_method, rank=rank,
                           world_size=n, local_rank=rank, local_world_size=n)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"backend": torch.distributed.get_backend(), "layouts": {}}

    def counts():
        return {"forward": wc.render_pass_kernel.launches,
                "grad": wc.render_pass_grad_kernel.launches,
                "hard_grad": wc.render_pass_grad_kernel.hard_launches,
                "adjoint": ac.render_pass_adjoint_kernel.launches,
                "plain": (wc.render_pass_reference.calls
                          + wc.render_pass_grad_reference.calls
                          + rd._render_pass.calls
                          + ac.render_pass_adjoint_reference.calls)}

    def reset():
        for fn, names in ((wc.render_pass_kernel, ("launches",)),
                          (wc.render_pass_grad_kernel,
                           ("launches", "hard_launches")),
                          (ac.render_pass_adjoint_kernel, ("launches",)),
                          (wc.render_pass_reference, ("calls",)),
                          (wc.render_pass_grad_reference, ("calls",)),
                          (rd._render_pass, ("calls",)),
                          (ac.render_pass_adjoint_reference, ("calls",))):
            for a in names:
                setattr(fn, a, 0)

    tflat, tcam, tkw = pass_args(
        pt, cornell_1080p(pt, TRAIN_SPP, TRAIN_DEPTH), dev)
    tkw.pop("n_samples")
    target = train.make_kernel_render(tflat, engine="cuda", **tkw)(
        {"tex_color": tflat.tex_color}, tcam, TRAIN_SEED).detach()
    for layout in job["layouts"]:
        mesh = pm.make_render_mesh(*layout)
        rec = {"shard": [mesh.tile, mesh.sample]}
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pm.render_on_mesh(builtin(pt, "cornell_box", 600, 16, 50),
                                mesh=mesh, device=dev)
        torch.cuda.synchronize()
        rec["render_s"] = time.perf_counter() - t0
        rec["render_counts"] = counts()
        rec["image"] = img.cpu()
        reset()
        rec.update(mesh_train_steps(torch, train, tflat, tcam, tkw, target,
                                    job["start"], mesh, dev))
        rec["train_counts"] = counts()
        out["layouts"][layout] = rec
    if job["adjoint"]:
        mesh = pm.make_render_mesh(1, 2)
        bflat, bcam, bkw = pass_args(
            pt, builtin(pt, "bouncing_spheres", 1200, 16, 50), dev)
        bkw.pop("n_samples")
        bkw["sky_gradient"] = True
        bparams, btarget = adjoint_training_start(torch, train, wc, bflat,
                                                  bcam, bkw, "cuda")
        bstep = train.make_train_step(
            adjoint_optimizer(torch, bparams, ADJ_GEOM_LR), flat=bflat,
            engine="cuda", mesh=mesh, **bkw)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(bstep(bparams, bcam, TRAIN_SEED, btarget))
        torch.cuda.synchronize()
        out["adjoint"] = {"loss": loss, "step_s": time.perf_counter() - t0,
                          "counts": counts(), "shard": [mesh.tile,
                                                        mesh.sample],
                          "grads": {k: v.grad.cpu()
                                    for k, v in bparams.items()}}
    return out


def cli_ranks(text: str) -> list:
    """The -p rank lines of a CLI run's standard error: (rank, forward
    kernel launches, plain passes)."""
    pat = re.compile(r"-p rank (\d+): .*; (\d+) forward kernel launches, "
                     r"(\d+) plain passes")
    return [tuple(int(x) for x in m.groups()) for m in pat.finditer(text)]


def sharded_phases(torch, np, pt, wc, rd, train, dev, card, done,
                   cli_ppm, full_losses) -> dict:
    """The sharded layer on the card (parallel/mesh.py, parallel/
    distributed.py, make_train_step(mesh=), the CLI's -p): four phases,
    each a JSON line. cli_ppm is the one-process CLI's Cornell PPM
    (main_path), full_losses full_train_main_path's losses (the
    one-process trajectory from the mesh steps' start). Returns the launch
    counts the kernels line reads."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    from real_time_ray_tracing_engine_tpu_torch.parallel import mesh as pm
    from real_time_ray_tracing_engine_tpu_torch.parallel import distributed
    out = {}

    # 13. row_offset: every kernel instance at a shard of row0 > 0 against
    # its plain version at the same shard, under the rules of the parity
    # phases (the image per pixel, the bounces, each gradient within
    # DG_RTOL of its largest entry); the forward instances also against
    # the same rows of their whole-image pass, bit for bit
    cases = []
    cornell = builtin(pt, "cornell_box", 64, 4, 16)
    bouncing = wide(pt.builders.bouncing_spheres(), 192, 4, 16)
    bouncing.camera.sky_gradient = True
    for name, scene, row0, h, use_bvh, modes in (
            ("cornell_box", cornell, 24, 16, False, ("K1", "K2", "K3",
                                                    "K4")),
            ("bouncing_spheres", bouncing, 40, 32, False, ("K6", "K8", "K9",
                                                          "K10")),
            ("bouncing_spheres -b", bouncing, 40, 32, True, ("K11", "K12"))):
        flat, cam, kw = pass_args(pt, scene, dev, use_bvh=use_bvh)
        whole_h = kw["height"]
        kw["height"] = h
        g = cotangent(torch, kw, dev, 5)
        n_lanes = wc.lane_count(kw["width"] * h)
        cases.append((name, flat, cam, kw, row0, whole_h, g, n_lanes,
                      modes))

    def bounce_counts(run_k, run_p, n_lanes):
        it_k = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        it_p = torch.zeros_like(it_k)
        return run_k(it_k), run_p(it_p), int(it_k.sum()), int(it_p.sum())

    for name, flat, cam, kw, row0, whole_h, g, n_lanes, modes in cases:
        for mode in modes:
            rec = {"kernel": mode, "scene": name, "row0": row0,
                   "shape": f"{kw['width']}x{kw['height']} of "
                            f"{kw['width']}x{whole_h} spp{kw['n_samples']}"
                            f" d{kw['max_depth']}"}
            if mode in ("K1", "K6", "K11", "K12"):
                env = {"K11": "stack", "K12": "lane"}.get(mode, "vscan")
                with kernel_mode_env(env):
                    prep = wc.prepare_kernel(flat, cam)
                    img_k, img_p, bk, bp = bounce_counts(
                        lambda it: wc.render_pass_kernel(
                            flat, cam, 7, 0, row0=row0, iters=it,
                            prepared=prep, **kw),
                        lambda it: wc.render_pass_reference(
                            flat, cam, 7, 0, row0=row0, iters=it, **kw),
                        n_lanes)
                    whole = wc.render_pass_kernel(
                        flat, cam, 7, 0, prepared=prep,
                        **{**kw, "height": whole_h})
                rec["mode"] = prep.mode
                rec["equal_to_whole_rows"] = bool(torch.equal(
                    img_k, whole[row0:row0 + kw["height"]]))
                check(rec["equal_to_whole_rows"], f"row_offset {mode} "
                      f"{name}: the shard differs from its rows of the "
                      "whole image's pass")
            elif mode == "K2":
                img_k = wc.render_pass_compacted(flat, cam, 7, 0, row0=row0,
                                                 caps=(6,), **kw)
                img_p = wc.render_pass_compacted(
                    flat, cam, 7, 0, row0=row0, caps=(6,),
                    pass_fn=wc.render_pass_reference, **kw)
                single = wc.render_pass_kernel(flat, cam, 7, 0, row0=row0,
                                               **kw)
                rec["vs_single_max_abs_err"] = float(
                    (img_k - single).abs().max())
                check(torch.allclose(img_k, single, atol=COMPACT_ATOL),
                      f"row_offset K2 {name}: compacted against single "
                      f"{rec['vs_single_max_abs_err']}")
                bk = bp = None
            elif mode in ("K3", "K4", "K8"):
                slots = (wc.hard_param_slots(flat) if mode == "K4" else ())
                (img_k, dt_k, dh_k), (img_p, dt_p, dh_p), bk, bp = \
                    bounce_counts(
                        lambda it: wc.render_pass_grad_kernel(
                            flat, cam, 7, 0, row0=row0, cotangent=g,
                            hard_slots=slots, iters=it, **kw),
                        lambda it: wc.render_pass_grad_reference(
                            flat, cam, 7, 0, row0=row0, cotangent=g,
                            hard_slots=slots, iters=it, **kw), n_lanes)
                errs = {"tex_color": {
                    "max_abs_err": float((dt_k - dt_p).abs().max()),
                    "scale": float(dt_p.abs().max())}}
                if slots:
                    errs.update(family_errors(slots, dh_k, dh_p))
                rec["grads"] = errs
            else:
                seg = ADJ_SEG if mode == "K10" else 0
                plain = (functools.partial(
                    ac.render_pass_adjoint_seg_reference, seg=seg) if seg
                    else ac.render_pass_adjoint_reference)
                (img_k, gr_k), (img_p, gr_p), bk, bp = bounce_counts(
                    lambda it: ac.render_pass_adjoint_kernel(
                        flat, cam, 7, 0, row0=row0, cotangent=g, seg=seg,
                        iters=it, **kw),
                    lambda it: plain(flat, cam, 7, 0, row0=row0,
                                     cotangent=g, iters=it, **kw), n_lanes)
                rec["grads"] = adjoint_errors(gr_k, gr_p)
            rec.update(per_pixel(img_k, img_p))
            rec["kernel_bounces"], rec["plain_bounces"] = bk, bp
            emit("row_offset", **rec)
            assert_close(f"row_offset {mode} {name}", rec)
            # the plain suffix tier (K8) traces each sample twice
            twice = 2 if mode == "K8" else 1
            check(bk is None or bk * twice == bp, f"row_offset {mode} "
                  f"{name}: the kernel traced {bk} bounces, the plain "
                  f"version {bp} (x{twice})")
            for fam, e in rec.get("grads", {}).items():
                check(e["max_abs_err"] <= DG_RTOL * e["scale"],
                      f"row_offset {mode} {name}: {fam} differs by "
                      f"{e['max_abs_err']} (limit {DG_RTOL} x "
                      f"{e['scale']})")
            check(rec.get("grads", {}).get("tex_color", {"scale": 1.0})[
                "scale"] > 0.0, f"row_offset {mode} {name}: no gradient")
    torch.cuda.empty_cache()
    done("row_offset")

    # 14. mesh_shards: in this process, every shard of each layout rendered
    # by render_shard and summed against the one-process pass of the same
    # samples: Cornell 600^2 spp16 d50 (K1) and bouncing 1200x675 spp16 d50
    # (K6), single schedule (tile-only layouts bit for bit) and the auto
    # schedule (compacted from 8 samples a shard); then the gradients of a
    # fixed cotangent, the per-shard gradients of the mesh training render
    # (make_kernel_render(mesh=local_shard(...))) summed against the
    # one-process render's: Cornell 1920x1080 spp64 d50 over all five
    # families (K3 + K4 under K5) and bouncing 1200x675 spp16 d50 over all
    # five (K9; its layouts divide its 675 rows)
    for name, scene in (
            ("cornell_box 600x600 spp16 d50",
             builtin(pt, "cornell_box", 600, 16, 50)),
            ("bouncing_spheres 1200x675 spp16 d50",
             builtin(pt, "bouncing_spheres", 1200, 16, 50))):
        flat, cam, kw = pass_args(pt, scene, dev)
        prep = wc.prepare_kernel(flat, cam)
        run_pass = wc.pass_function(flat, cam, prep)
        common = {k: v for k, v in kw.items() if k != "n_samples"}
        for schedule in ("single", "auto"):
            ones = {}

            def one():
                ones["img"] = rd._pass_sum(
                    "cuda", flat, cam, run_pass, 7, 0, kw["n_samples"],
                    schedule=schedule, caps=None, tile_rows=1, **common)
            one_ms = cuda_ms(torch, one, reps=1, warmup=1)
            whole = ones["img"]
            scale = float(whole.abs().max())
            for layout in MESH_LAYOUTS:
                img, times = shard_sum(torch, pm, run_pass, flat, cam,
                                       layout, schedule=schedule, **common)
                diff = float((img - whole).abs().max())
                rec = {"scene": name, "mode": prep.mode, "layout": layout,
                       "schedule": schedule, "equal": bool(
                           torch.equal(img, whole)),
                       "max_abs_diff": diff, "scale": scale,
                       "one_process_ms": one_ms, "shard_ms": times,
                       "card": card}
                emit("mesh_shards", **rec)
                if schedule == "single" and layout[1] == 1:
                    check(rec["equal"], f"mesh_shards {name} {layout}: a "
                          f"tile-only layout differs by {diff}")
                check(diff <= MESH_RTOL * scale, f"mesh_shards {name} "
                      f"{layout} {schedule}: {diff} (limit {MESH_RTOL} x "
                      f"{scale})")
    grad_cases = (
        ("cornell_box 1920x1080 spp64 d50", cornell_1080p(pt, TRAIN_SPP,
                                                          TRAIN_DEPTH),
         False, MESH_LAYOUTS, DG_RTOL),
        ("bouncing_spheres 1200x675 spp16 d50, sky gradient",
         builtin(pt, "bouncing_spheres", 1200, 16, 50), True,
         ((1, 2), (3, 1), (3, 2)), ADJ_MAIN_RTOL))
    for name, scene, sky, layouts, rtol in grad_cases:
        flat, cam, kw = pass_args(pt, scene, dev)
        kw.pop("n_samples")
        kw["sky_gradient"] = kw["sky_gradient"] or sky
        g = cotangent(torch, {**kw}, dev, 5)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in train.get_params(flat).items()}

        def grads_of(mesh, rows):
            render = train.make_kernel_render(flat, engine="cuda", mesh=mesh,
                                              **kw)
            img = render(params, cam, TRAIN_SEED)
            return torch.autograd.grad((img * g[rows]).sum(),
                                       list(params.values()))
        t0 = time.perf_counter()
        want = grads_of(None, slice(None))
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        for layout in layouts:
            n_tile, n_sample = layout
            h = kw["height"] // n_tile
            got = [torch.zeros_like(p) for p in params.values()]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(n_tile):
                for s in range(n_sample):
                    for i, d in enumerate(grads_of(
                            pm.local_shard(n_tile, n_sample, t, s),
                            slice(t * h, (t + 1) * h))):
                        got[i] += d
            torch.cuda.synchronize()
            fams = {f: {"max_abs_err": float((a - b).abs().max()),
                        "scale": float(b.abs().max())}
                    for f, a, b in zip(params, got, want)}
            rec = {"scene": name, "layout": layout, "families": fams,
                   "rtol": rtol, "one_process_s": one_s,
                   "shards_s": time.perf_counter() - t0, "card": card}
            emit("mesh_shards", **rec)
            for f, e in fams.items():
                check(e["max_abs_err"] <= rtol * e["scale"],
                      f"mesh_shards {name} {layout}: {f} differs by "
                      f"{e['max_abs_err']} (limit {rtol} x {e['scale']})")
            check(fams["tex_color"]["scale"] > 0.0
                  and fams["sph_radius"]["scale"] > 0.0,
                  f"mesh_shards {name}: no gradient")
    del params, want, got
    torch.cuda.empty_cache()
    done("mesh_shards")

    # 15. mesh_ranks: two processes share the card over gloo (NCCL refuses
    # two ranks on one device; parallel/distributed.py::choose_backend),
    # layouts (2, 1) and (1, 2): render_on_mesh of Cornell 600^2 spp16 d50
    # against the one-process image; MESH_STEPS make_train_step(mesh=)
    # steps over all five families at Cornell 1920x1080 spp64 d50 from
    # full_train_main_path's start, each against the one-process step from
    # its starting point (loss, gradients and the parameters after Adam's
    # update; MESH_STEPS says why not the trajectory, whose losses
    # full_train_main_path took and the phase prints beside), parameters
    # equal across the ranks, the loss falling; one all-family adjoint
    # step on
    # bouncing 1200x675 spp16 d50 at (1, 2) against the same step in this
    # process. Times from two ranks on one card measure contention, not
    # scaling. Then a one-rank NCCL group in this process: render_on_mesh,
    # its all_reduce and all_gather launched on the card
    tflat, tcam, tkw = pass_args(
        pt, cornell_1080p(pt, TRAIN_SPP, TRAIN_DEPTH), dev)
    tkw.pop("n_samples")
    target = train.make_kernel_render(tflat, engine="cuda", **tkw)(
        {"tex_color": tflat.tex_color}, tcam, TRAIN_SEED).detach()
    fstart = full_family_start(wc, train, tflat)[3]
    one_img = pm.render_on_mesh(builtin(pt, "cornell_box", 600, 16, 50),
                                device=dev)
    bflat, bcam, bkw = pass_args(
        pt, builtin(pt, "bouncing_spheres", 1200, 16, 50), dev)
    bkw.pop("n_samples")
    bkw["sky_gradient"] = True
    bparams, btarget = adjoint_training_start(torch, train, wc, bflat, bcam,
                                              bkw, "cuda")
    bstep = train.make_train_step(
        adjoint_optimizer(torch, bparams, ADJ_GEOM_LR), flat=bflat,
        engine="cuda", **bkw)
    bloss = float(bstep(bparams, bcam, TRAIN_SEED, btarget))
    bgrads = {k: v.grad.detach().clone() for k, v in bparams.items()}
    del bparams, bstep
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = distributed.spawn_ranks(
        mesh_rank_worker, 2, {"layouts": ((2, 1), (1, 2)),
                              "start": {k: v.cpu() for k, v in
                                        fstart.items()},
                              "adjoint": True},
        timeout_s=RANKS_S)
    ranks_s = time.perf_counter() - t0
    img_scale = float(one_img.abs().max())
    ranks_rec = {"card": card, "ranks": 2, "backend": ranks[0]["backend"],
                 "wall_s": ranks_s, "times": "two ranks on one card: "
                 "contention, not scaling", "layouts": {}}
    # the checks run after the phase's line is printed
    deferred = []

    def later(ok, msg):
        deferred.append((bool(ok), msg))
    later(all(r["backend"] == "gloo" for r in ranks),
          f"two ranks on one card took {ranks[0]['backend']}")
    for layout in ((2, 1), (1, 2)):
        recs = [r["layouts"][layout] for r in ranks]
        img_diff = max(float((r["image"].to(dev) - one_img).abs().max())
                       for r in recs)
        # each step against the one-process step from its starting point
        # (rank 0's; the ranks' parameters are equal, checked below)
        steps = recs[0]["steps"]
        after = [st["params"] for st in steps[1:]] + [recs[0]["params"]]
        per_step = []
        for st, nxt in zip(steps, after):
            loss, grads, params = one_process_step(
                torch, train, tflat, tcam, tkw, target, st, dev)
            per_step.append({
                "loss": [st["loss"], loss],
                "loss_rel_err": abs(st["loss"] - loss) / loss,
                "grads": {f: {"max_abs_err": float((st["grads"][f] - g)
                                                   .abs().max()),
                              "scale": float(g.abs().max())}
                          for f, g in grads.items()},
                "params": {f: {"max_abs_err": float((nxt[f] - p).abs()
                                                    .max()),
                               "scale": float(p.abs().max())}
                           for f, p in params.items()}})
        same = all(torch.equal(recs[0]["params"][f], recs[1]["params"][f])
                   for f in recs[0]["params"])
        counts = [r["train_counts"] for r in recs]
        losses = [[st["loss"] for st in r["steps"]] for r in recs]
        lrec = {"shards": [r["shard"] for r in recs],
                "render_max_abs_diff": img_diff, "render_scale": img_scale,
                "render_equal": all(torch.equal(r["image"].to(dev), one_img)
                                    for r in recs),
                "render_s": [r["render_s"] for r in recs],
                "render_counts": [r["render_counts"] for r in recs],
                "losses": losses, "per_step": per_step,
                "one_process_trajectory_losses": full_losses[:MESH_STEPS],
                "params_equal_across_ranks": same,
                "step_s": [[st["s"] for st in r["steps"]] for r in recs],
                "train_counts": counts}
        ranks_rec["layouts"][str(layout)] = lrec
        later(img_diff <= MESH_RTOL * img_scale, f"mesh_ranks {layout}: the "
              f"image differs by {img_diff}")
        for i, ps in enumerate(per_step):
            later(ps["loss_rel_err"] <= DG_RTOL, f"mesh_ranks {layout} step "
                  f"{i}: the loss differs by {ps['loss_rel_err']} of the "
                  "one-process step's")
            for what in ("grads", "params"):
                for f, e in ps[what].items():
                    later(e["max_abs_err"] <= DG_RTOL * e["scale"],
                          f"mesh_ranks {layout} step {i}: {f} ({what}) "
                          f"differs by {e['max_abs_err']} (limit {DG_RTOL}"
                          f" x {e['scale']})")
        later(same, f"mesh_ranks {layout}: the ranks' parameters differ")
        later(all(ls[-1] < ls[0] for ls in losses),
              f"mesh_ranks {layout}: the loss did not fall {losses}")
        for c in counts + [r["render_counts"] for r in recs]:
            later(c["forward"] > 0 and c["plain"] == 0,
                  f"mesh_ranks {layout}: launches {c}")
        later(all(c["hard_grad"] >= MESH_STEPS for c in counts),
              f"mesh_ranks {layout}: the hard-slot grad kernel ran {counts}")
    adj = [r["adjoint"] for r in ranks]
    afams = {f: {"max_abs_err": max(float((a["grads"][f].to(dev)
                                           - bgrads[f]).abs().max())
                                    for a in adj),
                 "scale": float(bgrads[f].abs().max())} for f in bgrads}
    ranks_rec["adjoint"] = {
        "layout": (1, 2), "shards": [a["shard"] for a in adj],
        "losses": [a["loss"] for a in adj], "one_process_loss": bloss,
        "families": afams, "step_s": [a["step_s"] for a in adj],
        "counts": [a["counts"] for a in adj]}
    for a in adj:
        later(abs(a["loss"] - bloss) <= DG_RTOL * bloss,
              f"mesh_ranks adjoint: loss {a['loss']} against {bloss}")
        later(a["counts"]["adjoint"] >= 1 and a["counts"]["plain"] == 0,
              f"mesh_ranks adjoint: launches {a['counts']}")
    for f, e in afams.items():
        later(e["max_abs_err"] <= ADJ_MAIN_RTOL * e["scale"],
              f"mesh_ranks adjoint: {f} differs by {e['max_abs_err']} "
              f"(limit {ADJ_MAIN_RTOL} x {e['scale']})")
    launches = {k: sum(lr[c][k] for r in ranks
                       for lr in r["layouts"].values()
                       for c in ("render_counts", "train_counts"))
                for k in ("forward", "grad", "hard_grad")}
    launches["adjoint"] = sum(a["counts"]["adjoint"] for a in adj)
    ranks_rec["launches"] = launches
    emit("mesh_ranks", **ranks_rec)
    # the one-rank NCCL group
    import tempfile
    store = Path(tempfile.mkdtemp(prefix="rtx_nccl_")) / "store"
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        mesh = pm.make_render_mesh()
        nccl = {"backend": torch.distributed.get_backend(),
                "mesh": [mesh.n_tile, mesh.n_sample]}
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            img = pm.render_on_mesh(builtin(pt, "cornell_box", 600, 16, 50),
                                    mesh=mesh, device=dev)
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if "nccl" in e.key.lower()})
        nccl.update(equal=bool(torch.equal(img, one_img)),
                    profiled_nccl=names)
    finally:
        torch.distributed.destroy_process_group()
    emit("mesh_ranks_nccl", card=card, **nccl)
    for ok, msg in deferred:
        check(ok, msg)
    check(nccl["backend"] == "nccl" and nccl["equal"],
          f"mesh_ranks: the one-rank NCCL render {nccl}")
    out["mesh_ranks"] = ranks_rec
    torch.cuda.empty_cache()
    done("mesh_ranks")

    # 16. cli_parallel: the CLI's -p at its Cornell default (600x600 spp100
    # d50), one rank on the card and two under torch.distributed.run
    # sharing it (gloo), each rank's forward launches and plain passes from
    # its -p line; the PPM against the one-process CLI's (main_path) within
    # PPM_BYTE_TOL (a shard's pass sums the same samples in another order
    # than the CLI's batches of 16)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cli_rec = {}
    for name, launcher, n in (
            ("one_rank", [], 1),
            ("torchrun_2", ["-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", "2"], 2)):
        ppm_path = Path("output") / f"cli_parallel_{name}.ppm"
        if ppm_path.exists():
            ppm_path.unlink()
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, *launcher, "-m", PKG, "-p", "--output",
             ppm_path.stem], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=RANKS_S)
        wall = time.perf_counter() - t0
        lines = cli_ranks(run.stderr)
        rec = {"card": card, "argv": launcher + ["-m", PKG, "-p"],
               "rc": run.returncode, "wall_s": wall, "ranks": lines,
               "mesh": [ln for ln in run.stderr.splitlines()
                        if "[INFO] -p:" in ln]}
        if run.returncode == 0 and ppm_path.exists():
            ppm = pt.read_ppm(ppm_path).astype(np.int64)
            rec["ppm_max_byte_diff"] = int(np.abs(
                ppm - cli_ppm.astype(np.int64)).max())
            rec["ppm_bytes_differing"] = int((ppm != cli_ppm).sum())
        if n == 2:
            rec["times"] = "two ranks on one card: contention, not scaling"
        cli_rec[name] = rec
        emit("cli_parallel", name=name, **rec)
        check(run.returncode == 0, f"cli_parallel {name}: rc "
              f"{run.returncode}: {run.stderr[-2000:]}")
        check(sorted(r for r, _, _ in lines) == list(range(n)),
              f"cli_parallel {name}: rank lines {lines}")
        check(all(k > 0 and p == 0 for _, k, p in lines),
              f"cli_parallel {name}: launches, plain passes {lines}")
        check(run.stderr.count("[INFO] wrote") == 1,
              f"cli_parallel {name}: the PPM written "
              f"{run.stderr.count('[INFO] wrote')} times")
        check(rec.get("ppm_max_byte_diff", 99) <= PPM_BYTE_TOL,
              f"cli_parallel {name}: the PPM differs by "
              f"{rec.get('ppm_max_byte_diff')}")
    out["cli_parallel"] = cli_rec
    out["launches"] = {**launches, "cli_forward": sum(
        k for rec in cli_rec.values() for _, k, _ in rec["ranks"])}
    done("cli_parallel")
    return out


# the profiling phase's renders: (label, builtin scene, width, the launch
# counter of its kernel, the kernel's name in a profiler trace)
PROFILED = (("cornell_box 600x600 spp16 d50", "cornell_box", 600,
             "launches", "wavefront_forward_kernel"),
            ("bouncing_spheres 1200x675 spp16 d50", "bouncing_spheres", 1200,
             "launches_vscan", "wavefront_forward_vscan_kernel"))


def profiling_phase(torch, pt, wc, rd, dev, card, done) -> dict:
    """The profiling layer (utils/profiling.py) on the card.

    timed: render() of Cornell 600^2 spp16 d50 (K1 under K2) and bouncing
    1200x675 spp16 d50 (K6 under K2), each after a warm render, with the
    kernel's own bounce count of the pass over its paths as avg_depth; the
    render's rays/s and fp32 roofline share (bounce_ops, vscan_bounce_ops)
    beside the pass's CUDA-event time and its bound; no plain pass.
    profiler_trace: one more render of each; the chrome trace holds the
    kernel's events and the program's spans, and the device's busy share
    of the window of the outermost span; the forward's bounce counter
    (render_pass_kernel.bounces) of that render against the kernel's own
    count of the pass (the lanes past the image, which repeat its last
    pixel, at most max_depth bounces a sample more). Cornell's path
    lengths on the card's plain trace: summed over the image, equal to
    the kernel's bounces on the image's lanes (a path's length is the
    bounces it traces), and the compacted schedule's measured gain.
    The P3 encoders on the bouncing render's 1200x675 image: equal bytes,
    both timed."""
    from real_time_ray_tracing_engine_tpu_torch.utils import color
    from real_time_ray_tracing_engine_tpu_torch.utils import profiling as prof
    log_dir = str(Path("logs") / "torch_trace")
    # CUPTI starts with the first profile: a throwaway one keeps its set-up
    # out of the traced renders' windows
    with prof.profiler_trace(log_dir):
        torch.ones(1, device=dev).add_(1)
    out = {}
    for label, name, width, counter, kernel in PROFILED:
        scene = builtin(pt, name, width, 16, 50)
        flat, cam, kw = pass_args(pt, scene, dev)
        ops = (prof.bounce_ops(flat) if counter == "launches"
               else prof.vscan_bounce_ops(flat))
        n_pix = kw["width"] * kw["height"]
        iters = torch.zeros(wc.lane_count(n_pix), dtype=torch.int32,
                            device=dev)
        wc.render_pass_kernel(flat, cam, 0, 0, iters=iters, **kw)
        bounces = int(iters[:n_pix].sum())      # the image's paths only
        paths = n_pix * kw["n_samples"]
        prep = wc.prepare_kernel(flat, cam)
        kernel_pass = functools.partial(wc.render_pass_kernel, prepared=prep)
        single_ms = cuda_ms(torch, lambda: kernel_pass(flat, cam, 0, 0, **kw))
        pass_ms = cuda_ms(torch, lambda: wc.render_pass_compacted(
            flat, cam, 0, 0, pass_fn=kernel_pass, **kw))
        bound = ops * bounces / prof.PEAK_FP32 * 1e3
        pt.render(scene, device=dev)
        reset_forward_counts(wc, rd)
        with prof.timed(dict(width=kw["width"], height=kw["height"],
                             spp=kw["n_samples"],
                             avg_depth=bounces / paths)) as get:
            img = pt.render(scene, device=dev)
        stats = get()
        launches = getattr(wc.render_pass_kernel, counter)
        plain = plain_calls(wc, rd)
        rec = {"shape": label, "wall_s": stats.wall_s,
               "device_kind": stats.device_kind,
               "paths_per_s": stats.paths_per_s,
               "rays_per_s": stats.rays_per_s, "avg_depth": stats.avg_depth,
               "bounces": bounces, "ops_per_bounce": ops,
               "roofline_fraction": stats.roofline_fraction(
                   ops_per_bounce=ops), "pass_ms": pass_ms,
               "pass_schedule": "compacted, default_caps",
               "single_ms": single_ms, "bound_ms": bound,
               "pass_roofline_fraction": bound / pass_ms,
               counter: launches, "plain_calls": plain}
        emit("profiling_timed", card=card, **rec)
        check(launches > 0, f"{label}: render() under timed never launched "
              f"its kernel ({counter} = 0)")
        check(plain == 0, f"{label}: render() under timed ran a plain pass")
        check(bool(torch.isfinite(img).all()), f"{label}: image not finite")

        reset_forward_counts(wc, rd)
        wc.render_pass_kernel.bounces = 0
        with prof.profiler_trace(log_dir) as tr:
            img = pt.render(scene, device=dev)
        launches = getattr(wc.render_pass_kernel, counter)
        plain = plain_calls(wc, rd)
        counted = int(wc.render_pass_kernel.bounces)
        extra = (wc.lane_count(n_pix) - n_pix) * kw["n_samples"] \
            * kw["max_depth"]
        check(os.path.exists(tr.path), f"{label}: no trace at {tr.path}")
        busy = prof.device_busy(tr.path)
        found = {n: k for n, k in busy["kernels"].items() if kernel in n}
        with open(tr.path) as f:
            spans = sorted({e["name"] for e in json.load(f)["traceEvents"]
                            if e.get("cat") == "user_annotation"
                            and e["name"].startswith("rt.")})
        emit("profiling_trace", card=card, shape=label, trace=tr.path,
             window_ms=busy["window_ms"], busy_ms=busy["busy_ms"],
             busy_share=busy["busy_share"],
             idle_share=1.0 - busy["busy_share"],
             kernel_events=sum(k["launches"]
                               for k in busy["kernels"].values()),
             traced_kernel=found, top_kernels={
                 n[:60]: k for n, k in sorted(busy["kernels"].items(),
                                              key=lambda nk: -nk[1]["ms"])[:4]},
             spans=spans, counted_bounces=counted, pass_bounces=bounces,
             counted_per_path=counted / paths,
             **{counter: launches}, plain_calls=plain)
        check(bool(found), f"{label}: the profiler trace holds no CUDA "
              f"kernel event named {kernel} (its kernels: "
              f"{sorted(busy['kernels'])[:8]})")
        check(sum(k["launches"] for k in found.values()) == launches,
              f"{label}: {launches} launches counted, the trace holds "
              f"{found}")
        check({"rt.render", "rt.compile", "rt.pack", "rt.launch",
               "rt.compact"} <= set(spans),
              f"{label}: the trace's program spans are {spans}")
        check(bounces <= counted <= bounces + extra,
              f"{label}: the traced render counted {counted} bounces, the "
              f"pass's image lanes {bounces} (+ at most {extra} past it)")
        check(plain == 0, f"{label}: the traced render ran a plain pass")
        out[name] = {"timed": rec, "busy": busy, "iters": iters[:n_pix],
                     "flat": flat, "scene": scene, "kw": kw, "img": img}

    # Cornell's path lengths on the card's plain trace
    c = out["cornell_box"]
    kw, cfg = c["kw"], c["scene"].camera
    t0 = time.perf_counter()
    lengths = prof.path_lengths(c["flat"], cfg, n_samples=kw["n_samples"],
                                max_depth=kw["max_depth"])
    trace_s = time.perf_counter() - t0
    per_pixel_k = c["iters"].cpu().numpy()
    per_pixel_l = lengths.sum(axis=0)
    t = c["timed"]
    emit("profiling_lengths", card=card, shape=PROFILED[0][0],
         trace_s=trace_s, lengths_sum=int(per_pixel_l.sum()),
         kernel_bounces=t["bounces"],
         pixels_differing=int((per_pixel_l != per_pixel_k).sum()),
         measured_single_ms=t["single_ms"], measured_compacted_ms=t["pass_ms"],
         measured_compaction_gain=t["single_ms"] / t["pass_ms"])
    check(int(per_pixel_l.sum()) == t["bounces"],
          f"the plain trace's lengths sum to {int(per_pixel_l.sum())}, the "
          f"kernel traced {t['bounces']} bounces for the image's paths")

    # the P3 encoders on the CLI's bouncing_spheres image, each warmed once
    b = color.to_bytes(out["bouncing_spheres"]["img"])
    enc = {}
    for key, fn in (("native", color.encode_ppm_p3_native),
                    ("numpy", color.encode_ppm_p3_numpy)):
        best, data = math.inf, fn(b)
        for _ in range(3):
            t0 = time.perf_counter()
            data = fn(b)
            best = min(best, time.perf_counter() - t0)
        enc[key] = (best, data)
    emit("profiling_encoder", shape=list(b.shape),
         bytes=len(enc["numpy"][1]), native_s=enc["native"][0],
         numpy_s=enc["numpy"][0],
         equal=enc["native"][1] == enc["numpy"][1])
    check(enc["native"][1] is not None, "the C++ P3 encoder did not build")
    check(enc["native"][1] == enc["numpy"][1],
          "the C++ and numpy P3 encoders wrote different bytes")
    done("profiling")
    return out


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
    from real_time_ray_tracing_engine_tpu_torch.parallel import train
    # the operation bounds of every kernel (PERF.md §6, "Bounds")
    from real_time_ray_tracing_engine_tpu_torch.utils.profiling import (
        OPS_PLANES_BOUNCE, OPS_ROUTE, OPS_SLOT, PEAK_FP32, adjoint_bounce_ops,
        bound_ms, bounce_ops, vscan_bound_ms, vscan_bounce_ops)
    check("jax" not in sys.modules, "the port imported jax")
    dev = torch.device("cuda", 0)
    phase_s = {}
    clock = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    # 1. device
    card = gpu_line()
    print(card, flush=True)
    emit("device", card=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    done("device")

    # 2. build the kernel library from the checkout's sources
    lib = wc.load_library()
    regs = [ln.strip() for ln in lib.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    emit("build", seconds=lib.build_seconds,
         library=os.path.relpath(lib.path, ROOT), ptxas=regs)
    done("build")

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
    done("parity")

    # 3b. the grad kernel (K3) vs its plain version on the card: the image
    # per pixel (and bit for bit the forward kernel's), dG_tex to DG_RTOL of
    # its largest entry, and the bounces each traced. The last case is the
    # training main path's image and depth at 4 of its 64 samples: the
    # plain version would take minutes at 64.
    grad_parity = [
        ("cornell_box", builtin(pt, "cornell_box", 128, 16, 50)),
        ("cornell_smoke", builtin(pt, "cornell_smoke", 96, 4, 16)),
        ("cornell_box_1920x1080", cornell_1080p(pt, 4, 50))]
    grad_err = {}
    for name, scene in grad_parity:
        flat, cam, kw = pass_args(pt, scene, dev)
        g = cotangent(torch, kw, dev, 5)
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        it_k = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        it_p = torch.zeros_like(it_k)
        img_k, dg_k, _ = wc.render_pass_grad_kernel(flat, cam, 7, 0,
                                                    cotangent=g, iters=it_k,
                                                    **kw)
        fwd = wc.render_pass_kernel(flat, cam, 7, 0, **kw)
        out = {}

        def plain():
            out["plain"] = wc.render_pass_grad_reference(
                flat, cam, 7, 0, cotangent=g, iters=it_p, **kw)
        plain_ms = cuda_ms(torch, plain, reps=1, warmup=0)
        img_p, dg_p, _ = out["plain"]
        stats = per_pixel(img_k, img_p)
        scale = float(dg_p.abs().max())
        dg_err = float((dg_k - dg_p).abs().max())
        vs_fwd = float((img_k - fwd).abs().max())
        bk, bp = int(it_k.sum()), int(it_p.sum())
        rec = {"scene": name, **{k: v for k, v in kw.items()
                                 if k != "sky_gradient"}, **stats,
               "dg_max_abs_err": dg_err, "dg_scale": scale,
               "vs_forward_max_abs_err": vs_fwd, "kernel_bounces": bk,
               "plain_bounces": bp, "plain_ms": plain_ms}
        if name == "cornell_box":
            def kern():
                wc.render_pass_grad_kernel(flat, cam, 7, 0, cotangent=g,
                                           **kw)
            rec["kernel_ms"] = cuda_ms(torch, kern)
            grad_err["plain_ms"] = plain_ms
            grad_err["plain_ms_at"] = "cornell_box 128x128 spp16 d50"

            # the compacted grad driver (K5) over the plain version
            def plain_compacted():
                wc.render_pass_grad_compacted(
                    flat, cam, 7, 0, cotangent=g,
                    pass_fn=wc.render_pass_grad_reference, **kw)
            rec["plain_compacted_ms"] = cuda_ms(torch, plain_compacted,
                                                reps=1, warmup=0)
            grad_err["plain_compacted_ms"] = rec["plain_compacted_ms"]
        grad_err[name] = {"image": stats["max_abs_err"], "dg": dg_err}
        emit("grad_parity", **rec)
        assert_close(f"{name} grad", stats)
        check(bool(torch.isfinite(dg_k).all()), f"{name}: dG_tex not finite")
        check(scale > 0.0, f"{name}: the plain dG_tex is all zero")
        check(dg_err <= DG_RTOL * scale,
              f"{name}: dG_tex differs by {dg_err} (limit {DG_RTOL} x "
              f"{scale})")
        check(vs_fwd <= 1e-6, f"{name}: the grad pass's image differs "
              f"from the forward kernel's by {vs_fwd}")
        check(abs(bk - bp) <= 1e-4 * bp,
              f"{name}: kernel traced {bk} bounces, plain {bp}")
    done("grad_parity")

    # 3c. the grad kernel with hard slots (K4) vs its plain version on the
    # card: Cornell (9 slots: the glass IOR, the glass sphere and its
    # light-list copy) and three_spheres (23: 1 fuzz, 2 IOR, 5 spheres'
    # centers and radii). The image per pixel and the forward kernel's, the
    # bounces, dG_hard to DG_RTOL of its largest entry per family (the sums
    # over lanes run in another order, and the kernel's dual numbers round
    # apart from torch.func.jvp's forward AD, formula by formula), dG_tex to
    # DG_RTOL of the plain version's and equal to the tex-only kernel's. The
    # last case is the full-family training main path's image and depth at
    # 4 of its 64 samples, paths of up to 50 bounces through the glass.
    hard_parity = [
        ("cornell_box", builtin(pt, "cornell_box", 64, 4, 16)),
        ("three_spheres", builtin(pt, "three_spheres", 64, 4, 8)),
        ("cornell_box_1920x1080", cornell_1080p(pt, 4, 50))]
    hard_err = {}
    for name, scene in hard_parity:
        flat, cam, kw = pass_args(pt, scene, dev)
        slots = wc.hard_param_slots(flat)
        g = cotangent(torch, kw, dev, 5)
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        it_k = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        it_p = torch.zeros_like(it_k)
        img_k, dgt_k, dgh_k = wc.render_pass_grad_kernel(
            flat, cam, 7, 0, cotangent=g, hard_slots=slots, iters=it_k,
            **kw)
        _, dgt_tex, _ = wc.render_pass_grad_kernel(flat, cam, 7, 0,
                                                   cotangent=g, **kw)
        fwd = wc.render_pass_kernel(flat, cam, 7, 0, **kw)
        out = {}

        def plain():
            out["plain"] = wc.render_pass_grad_reference(
                flat, cam, 7, 0, cotangent=g, hard_slots=slots, iters=it_p,
                **kw)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = cuda_ms(torch, plain, reps=1, warmup=0)
        plain_gib = torch.cuda.max_memory_allocated() / 2**30
        img_p, dgt_p, dgh_p = out["plain"]
        stats = per_pixel(img_k, img_p)
        fams = family_errors(slots, dgh_k, dgh_p)
        tex_scale = float(dgt_p.abs().max())
        tex_err = float((dgt_k - dgt_p).abs().max())
        vs_tex_only = float((dgt_k - dgt_tex).abs().max())
        vs_fwd = float((img_k - fwd).abs().max())
        bk, bp = int(it_k.sum()), int(it_p.sum())
        rec = {"scene": name, "slots": len(slots),
               **{k: v for k, v in kw.items() if k != "sky_gradient"},
               **stats, "dg_hard": fams,
               "dg_hard_max_abs_err": float((dgh_k - dgh_p).abs().max()),
               "dg_tex_max_abs_err": tex_err, "dg_tex_scale": tex_scale,
               "dg_tex_vs_tex_only": vs_tex_only,
               "vs_forward_max_abs_err": vs_fwd, "kernel_bounces": bk,
               "plain_bounces": bp, "plain_ms": plain_ms,
               "plain_peak_gib": plain_gib}
        hard_err[name] = rec
        emit("hard_grad_parity", **rec)
        assert_close(f"{name} hard grad", stats)
        check(bool(torch.isfinite(dgh_k).all()),
              f"{name}: dG_hard not finite")
        for fam, e in fams.items():
            check(e["scale"] > 0.0, f"{name}: plain dG_hard[{fam}] is zero")
            check(e["max_abs_err"] <= DG_RTOL * e["scale"],
                  f"{name}: dG_hard[{fam}] differs by {e['max_abs_err']} "
                  f"(limit {DG_RTOL} x {e['scale']})")
        check(tex_err <= DG_RTOL * tex_scale,
              f"{name}: dG_tex differs by {tex_err} (limit {DG_RTOL} x "
              f"{tex_scale})")
        check(vs_tex_only <= DG_RTOL * tex_scale,
              f"{name}: dG_tex with hard slots differs from the tex-only "
              f"pass by {vs_tex_only}")
        check(vs_fwd <= 1e-6, f"{name}: the hard grad pass's image differs "
              f"from the forward kernel's by {vs_fwd}")
        check(bk == bp, f"{name}: kernel traced {bk} bounces, plain {bp}")
    del out
    torch.cuda.empty_cache()
    done("hard_grad_parity")

    # 3d. the chunk-scan forward (K6; K7 on the city's quad chunks) vs the
    # plain pass on the card, which tests every primitive: per pixel (0
    # flipped pixels expected: the selection is exact), bounce for bounce,
    # and the chunk scan's compacted schedule against its single pass. The
    # first case is one pass of the large-scene main path (the CLI's
    # bouncing_spheres at 1200x675 d50 renders in passes of 16 samples, on
    # the compacted schedule), whose compacted image is held against the
    # plain pass too
    vscan_parity = [
        ("bouncing_spheres_1200x675",
         builtin(pt, "bouncing_spheres", 1200, 16, 50)),
        ("bouncing_spheres", builtin(pt, "bouncing_spheres", 400, 4, 50)),
        ("grid4913", sized(grid_scene(pt), 128, 4, 8)),
        ("city301", sized(city_scene(pt), 400, 9, 6)),
        ("vscan_nested_checker", sized(vscan_nested_checker_scene(pt), 64,
                                       16, 8)),
        ("vscan_mis_medium", sized(mis_medium_scene(pt), 128, 16, 16)),
        ("vscan_multichunk", sized(multichunk_scene(pt), 64, 16, 8)),
        ("vquad", sized(vquad_scene(pt), 64, 16, 8))]
    vscan_err, kept_plain = {}, {}
    wc.render_pass_kernel.launches_vscan = 0
    wc.render_pass_kernel.launches_vquad = 0
    for name, scene in vscan_parity:
        flat, cam, kw = pass_args(pt, scene, dev)
        mode = wc.kernel_mode(flat)
        check(mode[0] == "vscan", f"{name}: kernel mode {mode}")
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        it_k = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        it_p = torch.zeros_like(it_k)
        kern = wc.render_pass_kernel(flat, cam, 7, 0, iters=it_k, **kw)
        out = {}

        def plain():
            out["plain"] = wc.render_pass_reference(flat, cam, 7, 0,
                                                    iters=it_p, **kw)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = cuda_ms(torch, plain, reps=1, warmup=0)
        plain_gib = torch.cuda.max_memory_allocated() / 2**30
        stats = per_pixel(kern, out["plain"])
        flipped = int(((kern - out["plain"]).abs() > FLIP_ATOL).sum())
        bk, bp = int(it_k.sum()), int(it_p.sum())
        rec = {"scene": name, "vquad": mode[1], "prims": flat.n_prims,
               **{k: v for k, v in kw.items() if k != "sky_gradient"},
               **stats, "flipped_values": flipped, "kernel_bounces": bk,
               "plain_bounces": bp, "plain_ms": plain_ms,
               "plain_peak_gib": plain_gib}
        if name.startswith("bouncing_spheres"):
            two = wc.render_pass_compacted(flat, cam, 7, 0, **kw)
            rec["caps"] = list(wc.default_caps(flat, kw["n_samples"],
                                               kw["max_depth"]))
            rec["compacted_vs_single_max_abs_err"] = float(
                (kern - two).abs().max())
            check(np.allclose(kern.cpu().numpy(), two.cpu().numpy(),
                              atol=COMPACT_ATOL),
                  f"{name}: compacted differs from single by "
                  f"{rec['compacted_vs_single_max_abs_err']}")
            comp = per_pixel(two, out["plain"])
            rec["compacted_vs_plain"] = {
                **comp, "flipped_values": int(
                    ((two - out["plain"]).abs() > FLIP_ATOL).sum())}
            assert_close(f"{name} vscan compacted", comp)
        vscan_err[name] = rec
        if name.startswith("bouncing_spheres"):
            # bvh_parity holds the BVH walks against these plain passes:
            # the plain version selects over every primitive in every mode
            kept_plain[name] = (out["plain"], bp)
        emit("vscan_parity", **rec)
        assert_close(f"{name} vscan", stats)
        check(bk == bp, f"{name}: kernel traced {bk} bounces, plain {bp}")
    check(wc.render_pass_kernel.launches_vscan >= len(vscan_parity),
          "the vscan parity cases did not run the chunk-scan instance")
    check(wc.render_pass_kernel.launches_vquad >= 1,
          "the city did not run the quad chunks")
    del out
    torch.cuda.empty_cache()
    done("vscan_parity")

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
    done("compacted")

    # 4b. the forward's persistent threads (K1, K2) take lane slots from a
    # counter the wrapper zeroes on the launch's stream: two launches in a
    # row on one stream, with no synchronisation between them, give the
    # same radiance, carry and bounces bit for bit, single and capped, at
    # the forward's timed shape (600x600 spp16 d50, 2,813 blocks' worth of
    # slots) and on fewer slots than the card's resident threads
    refill = {}
    for name, scene in (
            ("cornell_600x600_spp16_d50",
             builtin(pt, "cornell_box", 600, 16, 50)),
            ("cornell_100x100_spp4_d50",
             sized(pt.builders.cornell_box(), 100, 4, 50))):
        flat, cam, kw = pass_args(pt, scene, dev)
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        prep = wc.prepare_kernel(flat, cam)
        runs = []
        for _ in range(2):
            it1 = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
            it2 = torch.zeros_like(it1)
            img = wc.render_pass_kernel(flat, cam, 7, 0, iters=it1,
                                        prepared=prep, **kw)
            rad, carry = wc.render_pass_kernel(flat, cam, 7, 0, cap=40,
                                               iters=it2, prepared=prep,
                                               **kw)
            runs.append((img, it1, rad, carry, it2))
        torch.cuda.synchronize()
        same = [bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
                for a, b in zip(*runs)]
        refill[name] = all(same)
        emit("refill_repeat", scene=name, lanes=n_lanes,
             equal=dict(zip(("image", "bounces", "capped_rad",
                             "capped_carry", "capped_bounces"), same)))
        check(all(same), f"{name}: two launches of the forward in a row "
              f"differ ({same})")
        check(int(runs[0][1].sum()) > 0, f"{name}: no bounces counted")
    done("refill_repeat")

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
    main_launches = wc.render_pass_kernel.launches
    plain_calls = wc.render_pass_reference.calls + rd._render_pass.calls
    check(rc == 0, f"cli.main returned {rc}")
    check(out_ppm.exists(), f"{out_ppm} was not written")
    ppm = pt.read_ppm(out_ppm)
    cli_ppm = ppm             # the -p runs' reference (cli_parallel)
    check(ppm.shape == (600, 600, 3), f"PPM shape {ppm.shape}")
    check(main_launches > 0, "the main path never launched the kernel")
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
         ppm_mean_byte=float(ppm.mean()), kernel_launches=main_launches,
         plain_calls=plain_calls, cli_wall_s=cli_s, render_s=render_s,
         mpaths_per_s=paths / render_s / 1e6)
    done("main_path")

    # 5d. the large-scene main path: the CLI at bouncing_spheres' own
    # settings (1200x675, 100 spp, depth 50: the reference engine's final
    # scene) through the chunk scan (K6), and the CLI on a scene file, the
    # 301-quad city, through the quad chunks (K7). The CLI's wall time is
    # split into its steps: the scene's build (or load), render() (of which
    # compile_scene, the kernel's packing and the passes), the PPM's
    # conversion to bytes, its P3 text encoding and write, and the rest
    # (argument parsing, the finite check, messages); then a second, warm
    # render() call of the same scene is timed on its own
    from real_time_ray_tracing_engine_tpu_torch.utils import color
    large = {}
    for name, argv, shape, counter in (
            ("bouncing_spheres", ["--scene", "bouncing_spheres",
                                  "--output", "bouncing_spheres"],
             (675, 1200, 3), "launches_vscan"),
            ("city301", None, (225, 400, 3), "launches_vquad")):
        if argv is None:
            path = Path("output") / "city301.json"
            path.parent.mkdir(exist_ok=True)
            pt.save_scene(city_scene(pt), str(path))
            argv = ["--scene", str(path), "--output", "city301"]
        ppm_path = Path("output") / f"{argv[-1]}.ppm"
        if ppm_path.exists():
            ppm_path.unlink()
        wc.render_pass_kernel.launches = 0
        wc.render_pass_kernel.launches_vscan = 0
        wc.render_pass_kernel.launches_vquad = 0
        wc.render_pass_reference.calls = 0
        rd._render_pass.calls = 0
        split_clock = SplitClock(torch, (
            ("scene_s", cli, "load_scene_arg"),
            ("render_s", rd, "render"),
            ("compile_s", rd, "compile_scene"),
            ("pack_s", rd, "pass_function"),
            ("write_ppm_s", color, "write_ppm"),
            ("to_bytes_s", color, "to_bytes"),
            ("encode_s", color, "encode_ppm_p3")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            rc = cli.main(argv)
            torch.cuda.synchronize()
        finally:
            split_clock.restore()
        wall = time.perf_counter() - t0
        split = dict(split_clock.seconds)
        split["passes_s"] = (split["render_s"] - split["compile_s"]
                             - split["pack_s"])
        split["file_write_s"] = (split["write_ppm_s"] - split["to_bytes_s"]
                                 - split["encode_s"])
        split["other_s"] = (wall - split["scene_s"] - split["render_s"]
                            - split["write_ppm_s"])
        count = getattr(wc.render_pass_kernel, counter)
        all_launches = wc.render_pass_kernel.launches
        plain_calls = wc.render_pass_reference.calls + rd._render_pass.calls
        check(rc == 0, f"cli.main({argv}) returned {rc}")
        ppm = pt.read_ppm(ppm_path)
        check(ppm.shape == shape, f"{name}: PPM shape {ppm.shape}")
        check(count > 0, f"{name}: the CLI never launched the chunk scan "
              f"({counter} = 0)")
        check(plain_calls == 0, f"{name}: the CLI ran the plain engine")
        scene = (pt.builders.bouncing_spheres() if name != "city301"
                 else city_scene(pt))
        w, h = scene.camera.image_width, shape[0]
        spp = scene.camera.samples_per_pixel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pt.render(scene, device=dev, samples_per_batch=16,
                        progress=lambda s, t: None)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        check(bool(torch.isfinite(img).all()), f"{name}: image not finite")
        paths = w * h * spp
        large[name] = {"launches": count}
        emit("large_main_path", scene=name, argv=argv,
             shape=f"{w}x{h} spp{spp} d{scene.camera.max_depth}",
             ppm=str(ppm_path), ppm_mean_byte=float(ppm.mean()),
             kernel_launches=all_launches, **{counter: count},
             plain_calls=plain_calls, cli_wall_s=wall,
             cli_mpaths_per_s=paths / wall / 1e6, cli_split=split,
             warm_render_s=warm_s, warm_mpaths_per_s=paths / warm_s / 1e6)
    done("large_main_path")

    # 5b. the second main path: tex_color training at 1920x1080 spp64 d50
    # through make_train_step on the kernels (forward K1/K2 compacted, grad
    # K3 under the compacted driver K5), Adam from the wall rows dimmed to
    # 0.7 toward the kernel's image at the true colors. Step i's loss is
    # the loss after i updates.
    tflat, tcam, tkw = pass_args(
        pt, cornell_1080p(pt, TRAIN_SPP, TRAIN_DEPTH), dev)
    tkw.pop("n_samples")
    target = train.make_kernel_render(tflat, engine="cuda", **tkw)(
        {"tex_color": tflat.tex_color}, tcam, TRAIN_SEED).detach()
    tc = tflat.tex_color.clone()
    tc[WALL_ROWS] *= 0.7
    params = {"tex_color": tc.requires_grad_(True)}
    step = train.make_train_step(
        torch.optim.Adam(params.values(), lr=TRAIN_LR), flat=tflat,
        engine="cuda", **tkw)
    losses, step_s = [], []
    wc.render_pass_kernel.launches = 0
    wc.render_pass_grad_kernel.launches = 0
    wc.render_pass_reference.calls = 0
    wc.render_pass_grad_reference.calls = 0
    rd._render_pass.calls = 0
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(params, tcam, TRAIN_SEED, target)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        check(bool(torch.isfinite(params["tex_color"].grad).all()),
              "training: a gradient is not finite")
    train_fwd = wc.render_pass_kernel.launches
    train_grad = wc.render_pass_grad_kernel.launches
    train_plain = (wc.render_pass_reference.calls
                   + wc.render_pass_grad_reference.calls
                   + rd._render_pass.calls)
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    train_paths = TRAIN_W * TRAIN_H * TRAIN_SPP
    emit("train_main_path", shape=f"{TRAIN_W}x{TRAIN_H} spp{TRAIN_SPP} "
         f"d{TRAIN_DEPTH}", fields=["tex_color"], optimizer="Adam",
         lr=TRAIN_LR, losses=losses, step_s=step_s, median_step_s=steady,
         fwd_bwd_mpaths_per_s=train_paths / steady / 1e6,
         first_step_mpaths_per_s=train_paths / step_s[0] / 1e6,
         forward_launches=train_fwd, grad_launches=train_grad,
         plain_calls=train_plain,
         tex_color=params["tex_color"].detach().cpu().tolist())
    check(all(math.isfinite(x) for x in losses), "training: loss not finite")
    check(losses[-1] < losses[0], f"training: the loss did not fall {losses}")
    check(train_grad >= TRAIN_STEPS, "training: the grad kernel ran "
          f"{train_grad} times in {TRAIN_STEPS} steps")
    check(train_fwd >= TRAIN_STEPS, "training: the forward kernel ran "
          f"{train_fwd} times in {TRAIN_STEPS} steps")
    check(train_plain == 0, "training ran the plain torch engine")
    done("train_main_path")

    # 5c. the full-family training main path: the same shape and target,
    # all five trainable families through make_train_step on the kernels
    # (forward K1/K2 compacted, grad K3 + K4 under the compacted driver K5;
    # the JAX north star, bench.py:122-198), Adam at TRAIN_LR for tex_color,
    # IOR and fuzz and GEOM_LR for sphere geometry, from the dimmed walls
    # and the glass sphere at START_IOR and START_RADIUS
    slots, glass_mats, glass_rows, fparams = full_family_start(wc, train,
                                                               tflat)
    for v in fparams.values():
        v.requires_grad_(True)
    fstep = train.make_train_step(full_family_adam(torch, fparams),
                                  flat=tflat, engine="cuda", **tkw)
    flosses, fstep_s, first_grads = [], [], None
    wc.render_pass_kernel.launches = 0
    wc.render_pass_grad_kernel.launches = 0
    wc.render_pass_grad_kernel.hard_launches = 0
    wc.render_pass_reference.calls = 0
    wc.render_pass_grad_reference.calls = 0
    rd._render_pass.calls = 0
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fstep(fparams, tcam, TRAIN_SEED, target)
        torch.cuda.synchronize()
        fstep_s.append(time.perf_counter() - t0)
        flosses.append(float(loss))
        for k, v in fparams.items():
            check(bool(torch.isfinite(v.grad).all()),
                  f"full-family training: the {k} gradient is not finite")
        if first_grads is None:
            first_grads = {
                "mat_ior": fparams["mat_ior"].grad[glass_mats].tolist(),
                "sph_center": fparams["sph_center"].grad[glass_rows]
                .tolist(),
                "sph_radius": fparams["sph_radius"].grad[glass_rows]
                .tolist()}
    ftrain_fwd = wc.render_pass_kernel.launches
    ftrain_grad = wc.render_pass_grad_kernel.launches
    ftrain_hard = wc.render_pass_grad_kernel.hard_launches
    ftrain_plain = (wc.render_pass_reference.calls
                    + wc.render_pass_grad_reference.calls
                    + rd._render_pass.calls)
    fsteady = sorted(fstep_s[1:])[len(fstep_s[1:]) // 2]
    emit("full_train_main_path", shape=f"{TRAIN_W}x{TRAIN_H} spp{TRAIN_SPP} "
         f"d{TRAIN_DEPTH}", fields=list(train.TRAINABLE_FIELDS),
         slots=[list(sl) for sl in slots], optimizer="Adam",
         lr={"tex_color, mat_ior, mat_fuzz": TRAIN_LR,
             "sph_center, sph_radius": GEOM_LR},
         losses=flosses, step_s=fstep_s, median_step_s=fsteady,
         fwd_bwd_mpaths_per_s=train_paths / fsteady / 1e6,
         first_step_mpaths_per_s=train_paths / fstep_s[0] / 1e6,
         forward_launches=ftrain_fwd, grad_launches=ftrain_grad,
         hard_grad_launches=ftrain_hard, plain_calls=ftrain_plain,
         first_step_glass_grads=first_grads,
         params={k: v.detach().cpu().tolist() for k, v in fparams.items()
                 if k != "tex_color"})
    check(all(math.isfinite(x) for x in flosses),
          "full-family training: loss not finite")
    check(flosses[-1] < flosses[0],
          f"full-family training: the loss did not fall {flosses}")
    check(len(glass_mats) == 1 and len(glass_rows) == 2,
          f"Cornell's hard slots changed: {slots}")
    for k, v in first_grads.items():
        check(all(x != 0.0 for x in np.ravel(v)),
              f"full-family training: a glass {k} gradient is zero: {v}")
    check(ftrain_hard >= TRAIN_STEPS, "full-family training: the hard-slot "
          f"grad kernel ran {ftrain_hard} times in {TRAIN_STEPS} steps")
    check(ftrain_fwd >= TRAIN_STEPS, "full-family training: the forward "
          f"kernel ran {ftrain_fwd} times in {TRAIN_STEPS} steps")
    check(ftrain_plain == 0, "full-family training ran the plain engine")
    done("full_train_main_path")

    # 6. reference images (tests/test_reference_images.py's pooled rule)
    for name, (spp, mean_tol, min_rate) in REF_SCENES.items():
        gold, scene = golden_scene(pt, np, name)
        ours = pt.to_bytes(pt.render(scene, device=dev, spp=spp, seed=11,
                                     engine="cuda"))
        check(ours.shape == gold.shape, f"{name}: {ours.shape} vs "
              f"{gold.shape}")
        mean_diff, rate = pooled_rule(np, gold, ours)
        rec = {}
        if name == "textured_spheres":
            g = float(gold[MARBLE_REGION].astype(np.float32).mean()) / 255.0
            o = float(ours[MARBLE_REGION].astype(np.float32).mean()) / 255.0
            rec = {"marble_golden": g, "marble_ours": o}
            check(abs(g - o) < MARBLE_TOL, f"{name}: marble region {o} "
                  f"against the golden's {g}")
        emit("reference_image", scene=name, spp=spp, cell_mean_diff=mean_diff,
             allclose_rate=rate, mean_tol=mean_tol, min_rate=min_rate, **rec)
        check(mean_diff < mean_tol, f"{name}: cell mean diff {mean_diff}")
        check(rate >= min_rate, f"{name}: allclose rate {rate}")
    done("reference_images")

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
    done("times")

    # 7b. the grad kernel at the training main path's shape, 1920x1080
    # spp64 d50: single and compacted (K5, the default grad caps), timed,
    # and the compacted image and dG_tex held against the single pass; the
    # forward's compacted schedule beside it, the other half of a step
    gflat, gcam, gkw = pass_args(
        pt, cornell_1080p(pt, TRAIN_SPP, TRAIN_DEPTH), dev)
    gprep = wc.prepare_kernel(gflat, gcam)
    grad_pass = functools.partial(wc.render_pass_grad_kernel,
                                  prepared=gprep)
    g = cotangent(torch, gkw, dev, 6)
    out = {}

    def grad_single():
        out["single"] = grad_pass(gflat, gcam, 0, 0, cotangent=g, **gkw)

    def grad_compacted():
        out["compacted"] = wc.render_pass_grad_compacted(
            gflat, gcam, 0, 0, cotangent=g, pass_fn=grad_pass, **gkw)

    def forward_compacted():
        wc.render_pass_compacted(
            gflat, gcam, 0, 0, pass_fn=functools.partial(
                wc.render_pass_kernel, prepared=gprep), **gkw)

    t_gsingle = cuda_ms(torch, grad_single)
    t_gcomp = cuda_ms(torch, grad_compacted)
    t_fcomp = cuda_ms(torch, forward_compacted)
    (img1, dg1, _), (img2, dg2, _) = out["single"], out["compacted"]
    k5_img_err = float((img1 - img2).abs().max())
    k5_scale = float(dg1.abs().max())
    k5_dg_err = float((dg1 - dg2).abs().max())
    n_lanes = wc.lane_count(gkw["width"] * gkw["height"])
    g_bounces = counted_bounces(
        torch, lambda it: grad_pass(gflat, gcam, 0, 0, cotangent=g,
                                    iters=it, **gkw), n_lanes, dev)
    g_bound = bound_ms(gflat, True, g_bounces)
    emit("grad_times", card=card, shape=f"{TRAIN_W}x{TRAIN_H} spp"
         f"{TRAIN_SPP} d{TRAIN_DEPTH}",
         caps=list(wc.default_grad_caps(gflat, TRAIN_W, TRAIN_H, TRAIN_SPP,
                                        TRAIN_DEPTH)),
         single_ms=t_gsingle, compacted_ms=t_gcomp,
         forward_compacted_ms=t_fcomp,
         single_mpaths_per_s=train_paths / t_gsingle / 1e3,
         compacted_mpaths_per_s=train_paths / t_gcomp / 1e3,
         compacted_vs_single_image_max_abs_err=k5_img_err,
         compacted_vs_single_dg_max_abs_err=k5_dg_err, dg_scale=k5_scale,
         bounces=g_bounces, ops_per_bounce=bounce_ops(gflat, True),
         bound_ms=g_bound)
    check(np.allclose(img1.cpu().numpy(), img2.cpu().numpy(),
                      atol=COMPACT_ATOL),
          f"1920x1080 spp64 grad: compacted image differs from single by "
          f"{k5_img_err}")
    check(k5_dg_err <= DG_RTOL * k5_scale,
          f"1920x1080 spp64 grad: compacted dG_tex differs by {k5_dg_err} "
          f"(limit {DG_RTOL} x {k5_scale})")
    done("grad_times")

    # 7c. the full-family grad kernel (K3 + K4) at the same shape, single
    # and under K5 (the default grad caps), timed, the compacted image,
    # dG_tex and dG_hard held against the single pass. It traces the tex
    # grad pass's paths (3c holds the images and bounce counts equal), so
    # its bound uses that pass's bounce count.
    hslots = wc.hard_param_slots(gflat)
    hprep = wc.prepare_kernel(gflat, gcam, hslots)
    hard_pass = functools.partial(wc.render_pass_grad_kernel, prepared=hprep)

    def hard_single():
        out["hard_single"] = hard_pass(gflat, gcam, 0, 0, cotangent=g,
                                       hard_slots=hslots, **gkw)

    def hard_compacted():
        out["hard_compacted"] = wc.render_pass_grad_compacted(
            gflat, gcam, 0, 0, cotangent=g, hard_slots=hslots,
            pass_fn=hard_pass, **gkw)

    t_hsingle = cuda_ms(torch, hard_single)
    t_hcomp = cuda_ms(torch, hard_compacted)
    (himg1, ht1, hh1), (himg2, ht2, hh2) = (out["hard_single"],
                                            out["hard_compacted"])
    hk5 = {"image_max_abs_err": float((himg1 - himg2).abs().max()),
           "dg_tex_max_abs_err": float((ht1 - ht2).abs().max()),
           "dg_tex_scale": float(ht1.abs().max()),
           "dg_hard_max_abs_err": float((hh1 - hh2).abs().max()),
           "dg_hard_scale": float(hh1.abs().max())}
    h_bound = bound_ms(gflat, True, g_bounces, len(hslots))
    emit("hard_grad_times", card=card, shape=f"{TRAIN_W}x{TRAIN_H} spp"
         f"{TRAIN_SPP} d{TRAIN_DEPTH}", slots=len(hslots),
         single_ms=t_hsingle, compacted_ms=t_hcomp,
         single_mpaths_per_s=train_paths / t_hsingle / 1e3,
         compacted_mpaths_per_s=train_paths / t_hcomp / 1e3,
         compacted_vs_single=hk5, bounces=g_bounces,
         ops_per_bounce=bounce_ops(gflat, True, len(hslots)),
         bound_ms=h_bound)
    check(bool(torch.isfinite(hh1).all()) and bool(torch.isfinite(hh2).all()),
          "1920x1080 spp64 hard grad: dG_hard not finite")
    check(np.allclose(himg1.cpu().numpy(), himg2.cpu().numpy(),
                      atol=COMPACT_ATOL),
          f"1920x1080 spp64 hard grad: compacted image differs from single "
          f"by {hk5['image_max_abs_err']}")
    for part in ("dg_tex", "dg_hard"):
        check(hk5[f"{part}_max_abs_err"] <= DG_RTOL * hk5[f"{part}_scale"],
              f"1920x1080 spp64 hard grad: compacted {part} differs by "
              f"{hk5[f'{part}_max_abs_err']} (limit {DG_RTOL} x "
              f"{hk5[f'{part}_scale']})")
    # K9 at the same shape, beside K4: the every-family adjoint against the
    # tangent bundles on 9 slots (the JAX tier rule takes the bundles below
    # 33 slots, a TPU choice; this is the H100's measurement for the PR that
    # decides the rule), the scene packed on the chunk scan's tables
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    k9prep = wc.prepare_kernel(gflat, gcam, chunk_scan=True)
    k9pass = functools.partial(ac.render_pass_adjoint_kernel, cotangent=g,
                               prepared=k9prep, **gkw)
    t_k9c = cuda_ms(torch, lambda: k9pass(gflat, gcam, 0, 0))
    k9c_bounces = counted_bounces(
        torch, lambda it: k9pass(gflat, gcam, 0, 0, iters=it),
        wc.lane_count(TRAIN_W * TRAIN_H), dev)
    emit("hard_grad_times_k9", card=card, shape=f"cornell_box {TRAIN_W}x"
         f"{TRAIN_H} spp{TRAIN_SPP} d{TRAIN_DEPTH}", k9_ms=t_k9c,
         k4_ms=t_hsingle, k4_slots=len(hslots), k9_bounces=k9c_bounces,
         k9_bound_ms=adjoint_bounce_ops(gflat) * k9c_bounces / PEAK_FP32
         * 1e3)
    del k9prep
    done("hard_grad_times")

    # the forward kernel's bounds: at its timed shape (600x600 spp16 d50),
    # at the CLI's 100 samples, and at the training shape (the grad pass's
    # paths, 7b)
    f_bounds = {}
    for spp in (16, 100):
        fflat, fcam, fkw = pass_args(
            pt, builtin(pt, "cornell_box", 600, spp, 50), dev)
        f_bounces = counted_bounces(
            torch, lambda it: wc.render_pass_kernel(fflat, fcam, 0, 0,
                                                    iters=it, **fkw),
            wc.lane_count(fkw["width"] * fkw["height"]), dev)
        f_bounds[spp] = bound_ms(fflat, False, f_bounces)
        emit("forward_bound", shape=f"600x600 spp{spp} d50",
             bounces=f_bounces, ops_per_bounce=bounce_ops(fflat, False),
             bound_ms=f_bounds[spp])
    emit("forward_bound", shape=f"{TRAIN_W}x{TRAIN_H} spp{TRAIN_SPP} "
         f"d{TRAIN_DEPTH}", bounces=g_bounces,
         ops_per_bounce=bounce_ops(gflat, False),
         bound_ms=bound_ms(gflat, False, g_bounces))
    f_bound = f_bounds[16]
    done("bounds")

    # 7d. the chunk scan's times: one CLI pass of bouncing_spheres (1200x675
    # spp16 d50) and the JAX repo's large-scene shapes
    # (scripts/bench_large.py): bouncing 400x225 spp9 d50, the 4,913-sphere
    # grid 400x225 spp9 d8, the 301-quad city 400x225 spp9 d6 (K7); single
    # pass and the compacted schedule, the scene packed once, the compacted
    # image held against the single pass, the operation bound from the
    # run's own bounces
    large_times = {}
    for name, scene in (
            ("bouncing_1200x675_spp16_d50",
             builtin(pt, "bouncing_spheres", 1200, 16, 50)),
            ("bouncing_400x225_spp9_d50",
             builtin(pt, "bouncing_spheres", 400, 9, 50)),
            ("grid4913_400x225_spp9_d8", sized(grid_scene(pt), 400, 9, 8)),
            ("city301_400x225_spp9_d6", sized(city_scene(pt), 400, 9, 6))):
        flat, cam, kw = pass_args(pt, scene, dev)
        t0 = time.perf_counter()
        prep = wc.prepare_kernel(flat, cam)
        torch.cuda.synchronize()
        prepare_ms = (time.perf_counter() - t0) * 1e3
        kernel_pass = functools.partial(wc.render_pass_kernel, prepared=prep)
        out = {}

        def single():
            out["single"] = kernel_pass(flat, cam, 0, 0, **kw)

        def compacted():
            out["compacted"] = wc.render_pass_compacted(
                flat, cam, 0, 0, pass_fn=kernel_pass, **kw)

        t_single = cuda_ms(torch, single)
        t_comp = cuda_ms(torch, compacted)
        err = float((out["single"] - out["compacted"]).abs().max())
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        bounces = counted_bounces(
            torch, lambda it: kernel_pass(flat, cam, 0, 0, iters=it, **kw),
            n_lanes, dev)
        n = kw["width"] * kw["height"] * kw["n_samples"]
        rec = {"single_ms": t_single, "compacted_ms": t_comp,
               "single_mpaths_per_s": n / t_single / 1e3,
               "compacted_mpaths_per_s": n / t_comp / 1e3,
               "caps": list(wc.default_caps(flat, kw["n_samples"],
                                            kw["max_depth"])),
               "vquad": prep.vfields["Cq"] > 0, "prepare_ms": prepare_ms,
               "compacted_vs_single_max_abs_err": err, "bounces": bounces,
               "ops_per_bounce": vscan_bounce_ops(flat),
               "bound_ms": vscan_bound_ms(flat, bounces)}
        large_times[name] = rec
        emit("large_times", card=card, shape=name, **rec)
        check(np.allclose(out["single"].cpu().numpy(),
                          out["compacted"].cpu().numpy(), atol=COMPACT_ATOL),
              f"{name}: compacted differs from single by {err}")
    del out
    done("large_times")

    # 8. the chunk scan's grad instances (K3v weight planes, K4v tangent
    # bundles, K8 the suffix-radiance tier) against the plain grad pass on
    # the card, at the large-scene training path's image and depth
    # (1200x675 d50) at 4 of its 16 samples: the grad image equal to the
    # forward kernel's, the bounces the forward's (the plain suffix tier
    # traces each sample twice, phase A's bounces the forward's, the
    # kernel once), dG_tex and dG_hard (per family) within DG_RTOL of their
    # largest entries (the two sum the lanes in other orders), and the
    # compacted schedule (K5) against the single pass. bouncing's IOR
    # slot is taken under the sky gradient: under its own constant
    # background no radiance depends on a direction, so every hard
    # gradient of the scene is exactly 0 (both versions give 0). The weight
    # planes (K3v) run twice, equal bit for bit, and count the paths whose
    # planes came to hold a second row (csrc/wavefront.cu, WpRows): in the
    # closed room (29 rows, depth 50) there must be some, held to the plain
    # version like the rest. K3v with 30 fuzz slots beside 31 rows (the
    # request the adjoint took while the planes of 17 to 32 rows lived in
    # shared memory) is held to the plain version at 320x180.
    large_grad = [
        ("k8_bouncing", builtin(pt, "bouncing_spheres", 1200, 4, 50), (),
         True, False),
        ("k8_k4v_bouncing_ior_sky", builtin(pt, "bouncing_spheres", 1200, 4,
                                            50), "mat_ior", True, True),
        ("k3v_scan_tex", wide(scan_tex_scene(pt), 1200, 4, 50), (), True,
         False),
        ("k3v_k4v_scan_tex_fuzz_sky", wide(scan_tex_scene(pt), 1200, 4, 50),
         "mat_fuzz", True, True),
        ("k3v_rows28", wide(rows_scene(pt), 1200, 4, 50), (), True, False),
        ("k3v_k4v_rows28", wide(rows_scene(pt), 1200, 4, 50),
         "mat_fuzz,mat_ior", True, False),
        ("k3v_room29", wide(room_scene(pt), 400, 4, 50), (), True, False),
        ("k3v_k4v_metals31_fuzz30", wide(metals_scene(pt), 320, 4, 50),
         "mat_fuzz", True, False),
        ("k4v_vscan_slots", wide(vscan_slots_scene(pt), 1200, 4, 50),
         "jax_test", False, False),
        ("k8_k4v_vscan_slots", wide(vscan_slots_scene(pt), 1200, 4, 50),
         "jax_test", True, False)]
    from real_time_ray_tracing_engine_tpu_torch.scene.flat import (
        MAT_DIELECTRIC, MAT_METAL)

    def bits(t):
        return t.contiguous().view(torch.int32)

    lg_err = {}
    for name, scene, slots, want_tex, sky in large_grad:
        flat, cam, kw = pass_args(pt, scene, dev)
        kw["sky_gradient"] = kw["sky_gradient"] or sky
        if slots == "jax_test":
            slots = vscan_slots(flat.mat_type.cpu(), MAT_METAL,
                                MAT_DIELECTRIC)
        elif slots:
            slots = wc.hard_param_slots(flat, set(slots.split(",")))
        form = wc.tex_form(flat, want_tex)
        g = cotangent(torch, kw, dev, 5)
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        it_k = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        it_f = torch.zeros_like(it_k)
        it_p = torch.zeros_like(it_k)
        gkw = dict(cotangent=g, hard_slots=slots, want_tex=want_tex, **kw)
        multi = torch.zeros(1, dtype=torch.int32, device=dev)
        img_k, dgt_k, dgh_k = wc.render_pass_grad_kernel(
            flat, cam, 7, 0, iters=it_k, multi_rows=multi, **gkw)
        again = (wc.render_pass_grad_kernel(flat, cam, 7, 0, **gkw)
                 if form == "planes" else None)
        fwd = wc.render_pass_kernel(flat, cam, 7, 0, iters=it_f, **kw)
        img_c, dgt_c, dgh_c = wc.render_pass_grad_compacted(flat, cam, 7, 0,
                                                            **gkw)
        out = {}

        def plain():
            out["plain"] = wc.render_pass_grad_reference(flat, cam, 7, 0,
                                                         iters=it_p, **gkw)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = cuda_ms(torch, plain, reps=1, warmup=0)
        plain_gib = torch.cuda.max_memory_allocated() / 2**30
        img_p, dgt_p, dgh_p = out["plain"]
        stats = per_pixel(img_k, img_p)
        bk, bf, bp = int(it_k.sum()), int(it_f.sum()), int(it_p.sum())
        rec = {"case": name, "form": form, "slots": [list(s) for s in slots],
               "shape": f"{kw['width']}x{kw['height']} spp{kw['n_samples']} "
                        f"d{kw['max_depth']}", "textures":
               flat.tex_type.shape[0], "sky_gradient": kw["sky_gradient"],
               **stats, "vs_forward_max_abs_err":
               float((img_k - fwd).abs().max()),
               "compacted_image_max_abs_err":
               float((img_c - img_k).abs().max()), "kernel_bounces": bk,
               "forward_bounces": bf, "plain_bounces": bp,
               "plain_ms": plain_ms, "plain_peak_gib": plain_gib}
        if again is not None:
            rec["multi_row_paths"] = int(multi)
            rec["paths"] = kw["width"] * kw["height"] * kw["n_samples"]
            rec["same_bits_twice"] = all(
                bool(torch.equal(bits(x), bits(y))) for x, y in
                zip((img_k, dgt_k, dgh_k), again) if x is not None)
        if want_tex:
            rec["dg_tex_scale"] = float(dgt_p.abs().max())
            rec["dg_tex_max_abs_err"] = float((dgt_k - dgt_p).abs().max())
            rec["dg_tex_compacted_max_abs_err"] = float(
                (dgt_c - dgt_k).abs().max())
        if slots:
            rec["dg_hard"] = family_errors(slots, dgh_k, dgh_p)
            rec["dg_hard_compacted_max_abs_err"] = float(
                (dgh_c - dgh_k).abs().max())
        # the BVH walks' grad instances (K11, K12) on the same inputs, the
        # scene compiled with -b: the same plain version (it selects over
        # every primitive in every mode), the forward's image and bounces
        bvh_modes = {"k8_bouncing": ("stack", "lane"),
                     "k3v_scan_tex": ("stack",),
                     "k3v_rows28": ("stack", "lane")}.get(name, ())
        if bvh_modes:
            bflat = pt.compile_scene(scene, use_bvh=True, device=dev)
            rec["bvh"] = {}
        for mode in bvh_modes:
            with kernel_mode_env(mode):
                check(wc.kernel_mode(bflat)[0] == mode, f"{name}: {mode}")
                it_b = torch.zeros_like(it_k)
                img_b, dgt_b, _ = wc.render_pass_grad_kernel(
                    bflat, cam, 7, 0, iters=it_b, **gkw)
            rec["bvh"][mode] = {
                "vs_forward_max_abs_err": float((img_b - fwd).abs().max()),
                "dg_tex_max_abs_err": float((dgt_b - dgt_p).abs().max()),
                "kernel_bounces": int(it_b.sum())}
        lg_err[name] = rec
        emit("large_grad_parity", **rec)
        for mode, r in rec.get("bvh", {}).items():
            check(r["vs_forward_max_abs_err"] <= 1e-6 and r["kernel_bounces"]
                  == bk, f"{name} {mode}: the BVH grad instance's image or "
                  f"bounces differ from the chunk scan's: {r}")
            check(r["dg_tex_max_abs_err"] <= DG_RTOL * rec["dg_tex_scale"],
                  f"{name} {mode}: dG_tex differs from the plain version's "
                  f"by {r['dg_tex_max_abs_err']} (limit {DG_RTOL} x "
                  f"{rec['dg_tex_scale']})")
        assert_close(f"{name} grad", stats)
        if again is not None:
            check(rec["same_bits_twice"], f"{name}: two runs of the weight "
                  "planes differ")
        if name == "k3v_room29":
            check(rec["multi_row_paths"] > 0, f"{name}: no path's weight "
                  "planes held two rows")
        check(rec["vs_forward_max_abs_err"] <= 1e-6, f"{name}: the grad "
              f"image differs from the forward kernel's by "
              f"{rec['vs_forward_max_abs_err']}")
        check(np.allclose(img_c.cpu().numpy(), img_k.cpu().numpy(),
                          atol=COMPACT_ATOL),
              f"{name}: compacted image differs from single by "
              f"{rec['compacted_image_max_abs_err']}")
        twice = 2 if form == "suffix" else 1
        check(bk == bf and bp == twice * bf, f"{name}: kernel traced {bk} "
              f"bounces, forward {bf}, plain {bp} (x{twice})")
        if want_tex:
            check(rec["dg_tex_scale"] > 0.0, f"{name}: plain dG_tex is 0")
            for key in ("dg_tex_max_abs_err", "dg_tex_compacted_max_abs_err"):
                check(rec[key] <= DG_RTOL * rec["dg_tex_scale"],
                      f"{name}: {key} {rec[key]} (limit {DG_RTOL} x "
                      f"{rec['dg_tex_scale']})")
        for fam, e in rec.get("dg_hard", {}).items():
            check(e["scale"] > 0.0, f"{name}: plain dG_hard[{fam}] is 0")
            check(e["max_abs_err"] <= DG_RTOL * e["scale"],
                  f"{name}: dG_hard[{fam}] differs by {e['max_abs_err']} "
                  f"(limit {DG_RTOL} x {e['scale']})")
        if slots:
            check(rec["dg_hard_compacted_max_abs_err"] <= DG_RTOL * max(
                e["scale"] for e in rec["dg_hard"].values()),
                f"{name}: compacted dG_hard differs by "
                f"{rec['dg_hard_compacted_max_abs_err']}")
    del out
    torch.cuda.empty_cache()
    done("large_grad_parity")

    # 8b. the large-scene training main path: make_train_step on
    # bouncing_spheres at its own 1200x675, 16 spp, depth 50 on the kernels
    # (forward K6 under K2's compacted schedule; backward K8 under K5),
    # LARGE_STEPS Adam steps at TRAIN_LR from the ground checker's leaves
    # and the two textured hero spheres' rows at 0.7 toward the kernels'
    # image at the true colors; then tex_color and the one IOR slot (K4v
    # riding K8) under the sky gradient (see 8), from the glass at
    # START_IOR. Each step's loss must fall, and no plain pass run.
    bflat, bcam, bkw = pass_args(pt, builtin(pt, "bouncing_spheres", 1200, 16,
                                             50), dev)
    bkw.pop("n_samples")
    S = bflat.sph_center.shape[0]
    mtex = bflat.mat_tex[bflat.sph_mat.long()].tolist()
    ground = mtex[0]
    dim_rows = [int(bflat.tex_child_even[ground]),
                int(bflat.tex_child_odd[ground]), mtex[S - 2], mtex[S - 1]]
    large_train = {}
    for name, fields, sky in (("tex_color", ("tex_color",), False),
                              ("tex_color+mat_ior", ("tex_color", "mat_ior"),
                               True)):
        kw_ = dict(bkw, sky_gradient=sky)
        target = train.make_kernel_render(bflat, engine="cuda", **kw_)(
            {"tex_color": bflat.tex_color}, bcam, TRAIN_SEED).detach()
        params = {f: getattr(bflat, f).detach().clone() for f in fields}
        params["tex_color"][dim_rows] *= 0.7
        ior_slots = wc.hard_param_slots(bflat, {"mat_ior"})
        if "mat_ior" in params:
            params["mat_ior"][[s[1] for s in ior_slots]] = START_IOR
        for v in params.values():
            v.requires_grad_(True)
        step = train.make_train_step(
            torch.optim.Adam(params.values(), lr=TRAIN_LR), flat=bflat,
            engine="cuda", **kw_)
        counters = ("launches", "hard_launches", "vscan_tex_launches",
                    "vscan_hard_launches", "suffix_launches")
        for c in counters:
            setattr(wc.render_pass_grad_kernel, c, 0)
        wc.render_pass_kernel.launches = 0
        wc.render_pass_kernel.launches_vscan = 0
        wc.render_pass_reference.calls = 0
        wc.render_pass_grad_reference.calls = 0
        rd._render_pass.calls = 0
        losses, step_s, first_grads = [], [], None
        for _ in range(LARGE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(params, bcam, TRAIN_SEED, target)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
            for f, v in params.items():
                check(bool(torch.isfinite(v.grad).all()),
                      f"large training {name}: the {f} gradient is not "
                      "finite")
            if first_grads is None and "mat_ior" in params:
                first_grads = params["mat_ior"].grad[
                    [s[1] for s in ior_slots]].tolist()
        launched = {c: getattr(wc.render_pass_grad_kernel, c)
                    for c in counters}
        launched["forward_vscan"] = wc.render_pass_kernel.launches_vscan
        plain_calls = (wc.render_pass_reference.calls
                       + wc.render_pass_grad_reference.calls
                       + rd._render_pass.calls)
        steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
        paths = 1200 * 675 * 16
        large_train[name] = {"launches": launched, "median_step_s": steady}
        emit("large_train_main_path", fields=list(fields),
             shape="bouncing_spheres 1200x675 spp16 d50",
             sky_gradient=sky, dimmed_rows=dim_rows, optimizer="Adam",
             lr=TRAIN_LR, losses=losses, step_s=step_s,
             median_step_s=steady, median_step_ms=steady * 1e3,
             fwd_bwd_mpaths_per_s=paths / steady / 1e6,
             first_step_ior_grad=first_grads, **launched,
             plain_calls=plain_calls,
             mat_ior=(params["mat_ior"][[s[1] for s in ior_slots]].tolist()
                      if "mat_ior" in params else None))
        check(all(math.isfinite(x) for x in losses),
              f"large training {name}: loss not finite")
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"large training {name}: the loss did not fall at every step "
              f"{losses}")
        check(launched["suffix_launches"] >= LARGE_STEPS,
              f"large training {name}: the suffix kernel ran "
              f"{launched['suffix_launches']} times")
        check(launched["forward_vscan"] >= LARGE_STEPS,
              f"large training {name}: the chunk-scan forward ran "
              f"{launched['forward_vscan']} times")
        if "mat_ior" in params:
            check(launched["vscan_hard_launches"] >= LARGE_STEPS,
                  f"large training {name}: K4v ran "
                  f"{launched['vscan_hard_launches']} times")
            check(all(x != 0.0 for x in first_grads),
                  f"large training {name}: the IOR gradient is 0")
        check(plain_calls == 0, f"large training {name} ran the plain "
              "engine")
    done("large_train_main_path")

    # 8c. K3v's and K4v's full-size shapes, which no builtin scene has
    # (every builtin chunk-scan scene has more than 32 texture rows): the
    # JAX tests' 80-sphere scene at 1200x675 spp16 d50, one render_loss_grad
    # over tex_color on the kernels (K6 forward, K3v backward, both under
    # the compacted schedule), the same on the 28-row scene, and on it -b
    # under each BVH walk (their row planes, wavefront_planes_bvh_kernel),
    # and the 79-sphere scene's 4 slots through the compacted grad driver,
    # one pass each
    sflat, scam, skw = pass_args(pt, wide(scan_tex_scene(pt), 1200, 16, 50),
                                 dev)
    skw.pop("n_samples")
    star = train.make_kernel_render(sflat, engine="cuda", **skw)(
        {"tex_color": sflat.tex_color}, scam, TRAIN_SEED).detach()
    dark = train.set_params(sflat, {"tex_color": sflat.tex_color * 0.7})
    wc.render_pass_grad_kernel.vscan_tex_launches = 0
    wc.render_pass_grad_kernel.vscan_hard_launches = 0
    wc.render_pass_reference.calls = 0
    wc.render_pass_grad_reference.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sloss, sgrads = train.render_loss_grad(dark, scam, TRAIN_SEED, star,
                                           engine="cuda", **skw)
    torch.cuda.synchronize()
    k3v_s = time.perf_counter() - t0
    k3v_launches = wc.render_pass_grad_kernel.vscan_tex_launches
    rflat, rcam, rkw = pass_args(pt, wide(rows_scene(pt), 1200, 16, 50), dev)
    rkw.pop("n_samples")
    rtar = train.make_kernel_render(rflat, engine="cuda", **rkw)(
        {"tex_color": rflat.tex_color}, rcam, TRAIN_SEED).detach()
    wc.render_pass_grad_kernel.vscan_tex_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rloss, rgrads = train.render_loss_grad(
        train.set_params(rflat, {"tex_color": rflat.tex_color * 0.7}), rcam,
        TRAIN_SEED, rtar, engine="cuda", **rkw)
    torch.cuda.synchronize()
    rows_s = time.perf_counter() - t0
    rows_launches = wc.render_pass_grad_kernel.vscan_tex_launches
    rbflat = pt.compile_scene(wide(rows_scene(pt), 1200, 16, 50),
                              use_bvh=True, device=dev)
    rows_bvh = {}
    for mode in ("stack", "lane"):
        with kernel_mode_env(mode):
            for c in ("stack_launches", "lane_launches", "suffix_launches"):
                setattr(wc.render_pass_grad_kernel, c, 0)
            _, bgrads = train.render_loss_grad(
                train.set_params(rbflat, {"tex_color":
                                          rbflat.tex_color * 0.7}), rcam,
                TRAIN_SEED, rtar, engine="cuda", **rkw)
            torch.cuda.synchronize()
        rows_bvh[mode] = {
            "launches": getattr(wc.render_pass_grad_kernel,
                                f"{mode}_launches"),
            "suffix_launches": wc.render_pass_grad_kernel.suffix_launches,
            "dg_tex_max_abs": float(bgrads["tex_color"].abs().max()),
            "finite": bool(torch.isfinite(bgrads["tex_color"]).all())}
    vflat, vcam, vkw = pass_args(pt, wide(vscan_slots_scene(pt), 1200, 16,
                                          50), dev)
    vslots = vscan_slots(vflat.mat_type.cpu(), MAT_METAL, MAT_DIELECTRIC)
    vg = cotangent(torch, vkw, dev, 6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, vdg = wc.render_pass_grad_compacted(vflat, vcam, 0, 0, cotangent=vg,
                                              hard_slots=vslots,
                                              want_tex=False, **vkw)
    torch.cuda.synchronize()
    k4v_s = time.perf_counter() - t0
    k4v_launches = wc.render_pass_grad_kernel.vscan_hard_launches
    plain_calls = (wc.render_pass_reference.calls
                   + wc.render_pass_grad_reference.calls)
    emit("large_grad_main_shapes", k3v={
        "scene": "scan_tex 1200x675 spp16 d50", "loss": float(sloss),
        "seconds": k3v_s, "launches": k3v_launches,
        "dg_tex_max_abs": float(sgrads["tex_color"].abs().max())},
        k3v_rows28={"scene": "rows (28 rows) 1200x675 spp16 d50",
                    "loss": float(rloss), "seconds": rows_s,
                    "launches": rows_launches, "dg_tex_max_abs":
                    float(rgrads["tex_color"].abs().max()),
                    "bvh": rows_bvh},
        k4v={"scene": "vscan_slots 1200x675 spp16 d50",
             "slots": [list(s) for s in vslots], "seconds": k4v_s,
             "launches": k4v_launches, "dg_hard": vdg.tolist()},
        plain_calls=plain_calls)
    check(k3v_launches >= 1 and rows_launches >= 1 and k4v_launches >= 1,
          f"K3v ran {k3v_launches} and {rows_launches} (28 rows), K4v "
          f"{k4v_launches} times")
    check(bool(torch.isfinite(rgrads["tex_color"]).all())
          and float(rgrads["tex_color"].abs().max()) > 0.0,
          "K3v 28-row main shape: dG_tex not finite or all zero")
    for mode, r in rows_bvh.items():
        check(r["launches"] >= 1 and r["suffix_launches"] == 0
              and r["finite"] and r["dg_tex_max_abs"] > 0.0,
              f"the {mode} walk's row planes at the 28-row main shape: {r}")
    check(bool(torch.isfinite(sgrads["tex_color"]).all())
          and float(sgrads["tex_color"].abs().max()) > 0.0,
          "K3v main shape: dG_tex not finite or all zero")
    check(bool(torch.isfinite(vdg).all()) and bool((vdg != 0).all()),
          f"K4v main shape: dG_hard {vdg.tolist()}")
    check(plain_calls == 0, "the K3v/K4v main shapes ran a plain pass")
    done("large_grad_main_shapes")

    # 8d. the chunk scan's grad kernels' times at the main path's shape
    # (1200x675 spp16 d50): K8 on bouncing (and with its IOR slot, K4v, under
    # the sky gradient), K3v on the 80-sphere scene and the 28-row scene
    # (alone and with K4v's fuzz and IOR slots), K3v with K4v's 30 fuzz
    # slots on the 31-row metals scene beside the adjoint (K9) on the same
    # request, K4v on the 79-sphere scene's 4 slots; single pass and the
    # compacted schedule (the default grad caps), the scene packed once;
    # bounds from the run's own bounces (the forward's, which the suffix
    # tier traces once)
    large_grad_times = {}
    for name, scene, slots, want_tex, sky in (
            ("k8", builtin(pt, "bouncing_spheres", 1200, 16, 50), (), True,
             False),
            ("k8_k4v_ior", builtin(pt, "bouncing_spheres", 1200, 16, 50),
             "mat_ior", True, True),
            ("k3v", wide(scan_tex_scene(pt), 1200, 16, 50), (), True, False),
            ("k3v_rows28", wide(rows_scene(pt), 1200, 16, 50), (), True,
             False),
            ("k3v_k4v_rows28", wide(rows_scene(pt), 1200, 16, 50),
             "mat_fuzz,mat_ior", True, False),
            ("k3v_k4v_metals31", wide(metals_scene(pt), 1200, 16, 50),
             "mat_fuzz", True, False),
            ("k4v", wide(vscan_slots_scene(pt), 1200, 16, 50), "jax_test",
             False, False)):
        flat, cam, kw = pass_args(pt, scene, dev)
        kw["sky_gradient"] = kw["sky_gradient"] or sky
        if slots == "jax_test":
            slots = vscan_slots(flat.mat_type.cpu(), MAT_METAL,
                                MAT_DIELECTRIC)
        elif slots:
            slots = wc.hard_param_slots(flat, set(slots.split(",")))
        prep = wc.prepare_kernel(flat, cam, slots)
        gpass = functools.partial(wc.render_pass_grad_kernel, prepared=prep)
        g = cotangent(torch, kw, dev, 6)
        gkw = dict(cotangent=g, hard_slots=slots, want_tex=want_tex, **kw)
        t_single = cuda_ms(torch, lambda: gpass(flat, cam, 0, 0, **gkw))
        t_comp = cuda_ms(torch, lambda: wc.render_pass_grad_compacted(
            flat, cam, 0, 0, pass_fn=gpass, **gkw))
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        bounces = counted_bounces(
            torch, lambda it: wc.render_pass_kernel(flat, cam, 0, 0, iters=it,
                                                    **kw), n_lanes, dev)
        form = wc.tex_form(flat, want_tex)
        ops = vscan_bounce_ops(flat) + OPS_SLOT * len(slots)
        if form == "suffix":
            ops += OPS_ROUTE
        elif form == "planes":
            ops += OPS_PLANES_BOUNCE
        n = kw["width"] * kw["height"] * kw["n_samples"]
        rec = {"form": form, "slots": len(slots), "single_ms": t_single,
               "compacted_ms": t_comp,
               "single_mpaths_per_s": n / t_single / 1e3,
               "compacted_mpaths_per_s": n / t_comp / 1e3,
               "caps": list(wc.default_grad_caps(
                   flat, kw["width"], kw["height"], kw["n_samples"],
                   kw["max_depth"])),
               "forward_bounces": bounces, "ops_per_bounce": ops,
               "bound_ms": ops * bounces / PEAK_FP32 * 1e3,
               "sky_gradient": kw["sky_gradient"]}
        # the BVH walks' grad instances (K11, K12) at the same shape, the
        # scene compiled with -b: the same work, the same bound
        bvh_modes = {"k8": ("stack", "lane"), "k3v": ("stack",),
                     "k3v_rows28": ("stack", "lane")}.get(name, ())
        if bvh_modes:
            bflat = pt.compile_scene(scene, use_bvh=True, device=dev)
            rec["bvh"] = {}
        for mode in bvh_modes:
            with kernel_mode_env(mode):
                bpass = functools.partial(
                    wc.render_pass_grad_kernel,
                    prepared=wc.prepare_kernel(bflat, cam))
                rec["bvh"][mode] = {
                    "single_ms": cuda_ms(torch, lambda: bpass(
                        bflat, cam, 0, 0, **gkw)),
                    "compacted_ms": cuda_ms(
                        torch, lambda: wc.render_pass_grad_compacted(
                            bflat, cam, 0, 0, pass_fn=bpass, **gkw))}
        if form == "planes":
            # the row planes' instance (with K4v's slots, its own): its
            # ptxas figures and the blocks an SM the card keeps of it
            hard = bool(slots)
            occ = ctypes.c_int(0)
            check(lib.vgrad_planes_blocks[hard](
                wc.grad_smem_bytes(flat, len(slots)), ctypes.byref(occ))
                == 0, f"{name}: the occupancy query failed")
            rec["blocks_per_sm"] = occ.value
            rec["ptxas"] = ptxas_prefix(lib.build_log, K3V_SYMBOL[hard])
        if name == "k3v_k4v_metals31":
            # the adjoint on the same request (its one sweep serves every
            # family), which the request took before the weight planes of
            # 17 to 32 rows left shared memory
            aprep = wc.prepare_kernel(flat, cam, chunk_scan=True)
            rec["k9_ms"] = cuda_ms(
                torch, lambda: ac.render_pass_adjoint_kernel(
                    flat, cam, 0, 0, cotangent=g, prepared=aprep, **kw))
        large_grad_times[name] = rec
        emit("large_grad_times", card=card, shape=f"{name} 1200x675 spp16 "
             "d50", **rec)
    done("large_grad_times")

    # 8e. the suffix tier's sums are the same on every run: K8 launched
    # twice at the large-scene training shape (bouncing_spheres 1200x675
    # spp16 d50), single pass and under the compacted schedule (a path's
    # records ride the carry across the passes), its image and dG_tex equal
    # bit for bit between the runs; the same for K8 with the IOR slot (K4v
    # riding it, under the sky gradient; dG_hard too) and for the BVH
    # walks' suffix tiers (K11, K12) on the -b scene. The routes are summed
    # in an order the data fixes (csrc/wavefront.cu, suffix_routes), so a
    # walk's dG_tex is also the chunk scan's on the same scene, bit for bit
    # (printed)
    det_scene = builtin(pt, "bouncing_spheres", 1200, 16, 50)
    dflat, dcam, dkw = pass_args(pt, det_scene, dev)
    dbflat = pt.compile_scene(det_scene, use_bvh=True, device=dev)
    suffix_det, det_tex = {}, {}
    for name, mode, slots, sky in (
            ("k8", "vscan", (), False),
            ("k8_k4v_ior", "vscan", "mat_ior", True),
            ("k8_b", "vscan", (), False),
            ("k11", "stack", (), False),
            ("k12", "lane", (), False)):
        f = dbflat if name in ("k8_b", "k11", "k12") else dflat
        kwd = dict(dkw, sky_gradient=dkw["sky_gradient"] or sky)
        with kernel_mode_env(mode):
            check(wc.kernel_mode(f)[0] == mode, f"suffix_determinism {name}")
            sl = wc.hard_param_slots(f, {slots}) if slots else ()
            gpass = functools.partial(wc.render_pass_grad_kernel,
                                      prepared=wc.prepare_kernel(f, dcam, sl))
            g = cotangent(torch, kwd, dev, 6)
            gkw = dict(cotangent=g, hard_slots=sl, **kwd)
            check(wc.tex_form(f) == "suffix", f"{name}: not the suffix tier")
            rec = {"mode": mode, "slots": len(sl)}
            for sched in ("single", "compacted"):
                if sched == "single":
                    runs = [gpass(f, dcam, 0, 0, **gkw) for _ in range(2)]
                else:
                    runs = [wc.render_pass_grad_compacted(
                        f, dcam, 0, 0, pass_fn=gpass, **gkw)
                        for _ in range(2)]
                torch.cuda.synchronize()
                a, b = runs
                rec[sched] = {
                    part: bool(torch.equal(bits(x), bits(y)))
                    for part, x, y in zip(("image", "dg_tex", "dg_hard"), a,
                                          b) if x is not None and x.numel()}
                rec[sched]["dg_tex_scale"] = float(a[1].abs().max())
                if sched == "single":
                    det_tex[name] = a[1]
        if name in ("k11", "k12"):
            rec["dg_tex_equals_chunk_scan"] = bool(torch.equal(
                bits(det_tex[name]), bits(det_tex["k8_b"])))
        suffix_det[name] = rec
        emit("suffix_determinism", case=name,
             shape="bouncing_spheres 1200x675 spp16 d50"
                   + (" -b" if f is dbflat else ""), **rec)
        for sched in ("single", "compacted"):
            r = rec[sched]
            check(r["dg_tex_scale"] > 0.0, f"{name} {sched}: dG_tex is 0")
            check(all(v for k, v in r.items() if k != "dg_tex_scale"),
                  f"suffix_determinism {name} {sched}: two runs differ {r}")
    del det_tex
    done("suffix_determinism")

    # 9. the adjoint (K9) against its plain version on the card: bouncing
    # at the main path's two shapes, 400x225 spp9 d50 and 1200x675 spp16
    # d50, under the sky gradient (the flat sky gives every hard family an
    # exact 0), the 79-sphere scene (metals, a glass and a sphere
    # light: the light rows' routing), Cornell (quads, a sphere light; the
    # forward runs it unrolled, the adjoint on the chunk scan),
    # cornell_smoke (mediums) and the city (quad chunks). The image equal to
    # the chunk-scan forward's (K6) within 1e-5, phase F's bounces equal to
    # the forward's, each family within DG_RTOL of its largest entry (the
    # two sum in other orders; ADJ_MAIN_RTOL at 1200x675), the plain pass's
    # time and peak memory
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    adjoint_cases = [
        ("bouncing_sky", builtin(pt, "bouncing_spheres", 400, 9, 50), True,
         DG_RTOL),
        ("bouncing_sky_1200x675", builtin(pt, "bouncing_spheres", 1200, 16,
                                          50), True, ADJ_MAIN_RTOL),
        ("vscan_slots", sized(vscan_slots_scene(pt), 192, 4, 16), False,
         DG_RTOL),
        ("cornell_box", builtin(pt, "cornell_box", 128, 4, 16), False,
         DG_RTOL),
        ("cornell_smoke", builtin(pt, "cornell_smoke", 96, 4, 16), False,
         DG_RTOL),
        ("city301", sized(city_scene(pt), 200, 4, 6), False, DG_RTOL)]
    adj_err = {}
    for name, scene, sky, rtol in adjoint_cases:
        flat, cam, kw = pass_args(pt, scene, dev)
        kw["sky_gradient"] = kw["sky_gradient"] or sky
        g = cotangent(torch, kw, dev, 5)
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        it_k = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        it_f = torch.zeros_like(it_k)
        it_p = torch.zeros_like(it_k)
        img_k, gr_k = ac.render_pass_adjoint_kernel(flat, cam, 7, 0,
                                                    cotangent=g, iters=it_k,
                                                    **kw)
        prep = wc.prepare_kernel(flat, cam, chunk_scan=True)
        fwd = wc.render_pass_kernel(flat, cam, 7, 0, iters=it_f,
                                    prepared=prep, **kw)
        out = {}

        def plain():
            out["plain"] = ac.render_pass_adjoint_reference(
                flat, cam, 7, 0, cotangent=g, iters=it_p, **kw)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = cuda_ms(torch, plain, reps=1, warmup=0)
        plain_gib = torch.cuda.max_memory_allocated() / 2**30
        img_p, gr_p = out["plain"]
        fams = adjoint_errors(gr_k, gr_p)
        bk, bf, bp = int(it_k.sum()), int(it_f.sum()), int(it_p.sum())
        rec = {"scene": name, "shape": f"{kw['width']}x{kw['height']} spp"
               f"{kw['n_samples']} d{kw['max_depth']}",
               "sky_gradient": kw["sky_gradient"],
               "vs_forward_max_abs_err": float((img_k - fwd).abs().max()),
               **per_pixel(img_k, img_p), "families": fams,
               "kernel_bounces": bk, "forward_bounces": bf,
               "plain_bounces": bp, "plain_ms": plain_ms,
               "plain_peak_gib": plain_gib, "rtol": rtol}
        if rtol != DG_RTOL:
            # the two float32 references on K9's worst entries: the plain
            # version against the forward-mode kernel (K4v), up to 8 a
            # hard family
            worst, hard = [], set(wc.hard_param_slots(flat))
            for fam in ("mat_fuzz", "mat_ior", "sph_center", "sph_radius"):
                gap = (gr_k[fam] - gr_p[fam]).abs().reshape(-1)
                for e in torch.argsort(gap, descending=True)[:8].tolist():
                    slot = {"mat_fuzz": ("fuzz", e), "mat_ior": ("ior", e),
                            "sph_radius": ("sphr", e),
                            "sph_center": ("sphc", e // 3, e % 3)}[fam]
                    if gap[e] > 0.0 and slot in hard:
                        worst.append(slot)
            _, _, k4v = wc.render_pass_grad_kernel(
                flat, cam, 7, 0, cotangent=g, hard_slots=tuple(worst),
                want_tex=False, **kw)
            rec["worst_entries"] = []
            for slot, v in zip(worst, k4v.tolist()):
                fam, i = wc.slot_index(slot)
                rec["worst_entries"].append({
                    "slot": list(slot), "k9": float(gr_k[fam][i]),
                    "plain": float(gr_p[fam][i]), "k4v": v,
                    "family_scale": fams[fam]["scale"]})
        adj_err[name] = rec
        if name == "bouncing_sky_1200x675":
            # kept for K10 at the same shape and inputs (adjoint_seg_parity)
            main_plain = {"image": img_p, "grads": gr_p, "bounces": bp}
        emit("adjoint_parity", **rec)
        check(rec["vs_forward_max_abs_err"] <= 1e-5, f"{name}: the adjoint's "
              f"image differs from the forward's by "
              f"{rec['vs_forward_max_abs_err']}")
        assert_close(f"{name} adjoint", rec)
        check(bk == bf == bp, f"{name}: the adjoint traced {bk} bounces, the "
              f"forward {bf}, the plain adjoint {bp}")
        check(fams["tex_color"]["scale"] > 0.0, f"{name}: tex_color's "
              "gradient is 0")
        for fam, e in fams.items():
            check(bool(torch.isfinite(gr_k[fam]).all()),
                  f"{name}: the adjoint's {fam} is not finite")
            check(e["max_abs_err"] <= rtol * e["scale"],
                  f"{name}: the adjoint's {fam} differs by "
                  f"{e['max_abs_err']} (limit {rtol} x {e['scale']})")
    for name in ("bouncing_sky", "bouncing_sky_1200x675"):
        check(adj_err[name]["families"]["sph_center"]["scale"] > 0.0,
              f"{name}: no sphere gradient")
    del out
    torch.cuda.empty_cache()
    done("adjoint_parity")

    # 9b. two differentiation mechanisms on the card (the JAX package's own
    # check, tests/test_grad.py:804-882): K9 against the forward-mode
    # kernels on the same estimator, at rtol 1e-3, atol 1e-4 x the largest
    # entry: on the 79-sphere scene at 1200x675 spp4 d50 its 4 slots
    # against K4v and its tex_color against K8 (more than 32 rows); on
    # Cornell at 600x600 spp4 d50 its 9 slots against K4 and its tex_color
    # against K3, paths that graze the inside of the glass sphere for 45
    # bounces included (scripts/adjoint_conditioning.py)
    for name, scene, slots in (
            ("vscan_slots_1200x675", wide(vscan_slots_scene(pt), 1200, 4, 50),
             "jax_test"),
            ("cornell_box_600x600_d50", builtin(pt, "cornell_box", 600, 4, 50),
             "all")):
        flat, cam, kw = pass_args(pt, scene, dev)
        slots = (vscan_slots(flat.mat_type.cpu(), MAT_METAL, MAT_DIELECTRIC)
                 if slots == "jax_test" else wc.hard_param_slots(flat))
        g = cotangent(torch, kw, dev, 6)
        _, gr = ac.render_pass_adjoint_kernel(flat, cam, 7, 0, cotangent=g,
                                              **kw)
        _, dgt, dgh = wc.render_pass_grad_kernel(
            flat, cam, 7, 0, cotangent=g, hard_slots=slots, **kw)
        got = torch.stack([gr[wc.slot_index(s)[0]][wc.slot_index(s)[1]]
                           for s in slots])
        emit("adjoint_vs_forward_mode", scene=name,
             tex_form=wc.tex_form(flat), slots=[list(s) for s in slots],
             adjoint_slots=got.tolist(), forward_mode_slots=dgh.tolist(),
             tex_max_abs_err=float((gr["tex_color"] - dgt).abs().max()),
             tex_scale=float(dgt.abs().max()))
        for what, a, b in (("slots", got, dgh),
                           ("tex_color", gr["tex_color"], dgt)):
            scale = float(b.abs().max())
            bad = (a - b).abs() > 1e-3 * b.abs() + 1e-4 * scale
            check(scale > 0.0 and not bool(bad.any()),
                  f"{name}: the adjoint's {what} differs from the "
                  f"forward-mode kernels' beyond rtol 1e-3, atol 1e-4 x "
                  f"{scale}")
    done("adjoint_vs_forward_mode")

    # 9b'. the reverse bounce alone (adj_reverse_bounce, the hand-written
    # VJP that K9 and K10 run) against torch autograd of the bounce, per
    # lane, on each branch of PROBE_CASES: a miss under the flat sky and the
    # sky gradient, an emission, lambertian MIS with a sphere light and with
    # a quad light, isotropic inside a medium, metal, dielectric reflection
    # and refraction, a marble (noise) texture, a grazing sphere root. The
    # largest difference of each branch within PROBE_RTOL of its largest
    # entry.
    probe = {}
    for case in PROBE_CASES:
        idx, lam_k, rows_k = probe_run(torch, pt, ac, case, dev,
                                       ac.adjoint_bounce_probe)
        _, lam_p, rows_p = probe_run(torch, pt, ac, case, dev,
                                     ac.adjoint_bounce_probe_reference)
        got = torch.cat([lam_k.double(), rows_k], 1)
        want = torch.cat([lam_p.double(), rows_p], 1)
        rec = {"lanes": int(idx.numel()),
               "max_abs_err": float((got - want).abs().max()),
               "scale": float(want.abs().max())}
        probe[case[0]] = rec
        emit("adjoint_bounce_probe", branch=case[0], scene=case[1],
             sky_gradient=case[2], rtol=PROBE_RTOL, **rec)
        check(rec["lanes"] >= 8, f"probe {case[0]}: {rec['lanes']} lanes")
        check(rec["scale"] > 0.0 and bool(torch.isfinite(got).all()),
              f"probe {case[0]}: no finite nonzero cotangent")
        check(rec["max_abs_err"] <= PROBE_RTOL * rec["scale"],
              f"probe {case[0]}: the reverse bounce differs by "
              f"{rec['max_abs_err']} (limit {PROBE_RTOL} x {rec['scale']})")
    done("adjoint_bounce_probe")

    # 9c. the adjoint's times: bouncing at the JAX bench line's 400x225 spp9
    # d50 (flat sky) and at its own training shape 1200x675 spp16 d50 (sky
    # gradient), the scene packed once; bounces from the run's own counter;
    # the operation bound (adjoint_bounce_ops); ptxas
    adj_times = {}
    for name, width, spp, sky in (("bouncing_400x225_spp9_d50", 400, 9,
                                   False),
                                  ("bouncing_1200x675_spp16_d50", 1200, 16,
                                   True)):
        flat, cam, kw = pass_args(
            pt, builtin(pt, "bouncing_spheres", width, spp, 50), dev)
        kw["sky_gradient"] = sky
        prep = wc.prepare_kernel(flat, cam, chunk_scan=True)
        g = cotangent(torch, kw, dev, 6)
        apass = functools.partial(ac.render_pass_adjoint_kernel, cotangent=g,
                                  prepared=prep, **kw)
        t_k = cuda_ms(torch, lambda: apass(flat, cam, 0, 0))
        bounces = counted_bounces(
            torch, lambda it: apass(flat, cam, 0, 0, iters=it),
            wc.lane_count(kw["width"] * kw["height"]), dev)
        ops = adjoint_bounce_ops(flat)
        n = kw["width"] * kw["height"] * kw["n_samples"]
        rec = {"ms": t_k, "mpaths_per_s": n / t_k / 1e3, "bounces": bounces,
               "ops_per_bounce": ops,
               "bound_ms": ops * bounces / PEAK_FP32 * 1e3,
               "sky_gradient": sky}
        adj_times[name] = rec
        emit("adjoint_times", card=card, shape=name, **rec)
    adj_ptxas = ptxas_table(lib.build_log).get("wavefront_adjoint_kernel")
    emit("adjoint_build", ptxas=adj_ptxas,
         plain_ms={n: adj_err[n]["plain_ms"]
                   for n in ("bouncing_sky", "bouncing_sky_1200x675")},
         library_ms=None)
    check(adj_ptxas is not None, "no ptxas lines for the adjoint kernel")
    done("adjoint_times")

    # 9d. the adjoint's training main path: make_train_step over all five
    # families of bouncing_spheres (2,013 hard slots: the adjoint) on the
    # kernels, forward K6 under K2's compacted schedule, backward K9. First
    # the JAX package's bench line (bench.py:201-249): 400x225, 9 spp,
    # depth 50, flat sky, a zero target, train.get_params(flat), Adam at
    # TRAIN_LR; then the scene's own 1200x675 spp16 d50 under the sky
    # gradient from adjoint_training_start, Adam at TRAIN_LR (geometry at
    # ADJ_GEOM_LR). The loss must fall at every step and no plain pass
    # run.
    wc.render_pass_kernel.launches = 0
    wc.render_pass_grad_kernel.launches = 0
    ac.render_pass_adjoint_kernel.launches = 0
    wc.render_pass_reference.calls = 0
    wc.render_pass_grad_reference.calls = 0
    ac.render_pass_adjoint_reference.calls = 0
    rd._render_pass.calls = 0
    adj_train = {}
    for name, width, spp, sky in (
            ("bouncing_400x225_spp9_d50_fwd_bwd_full_params_adjoint_2013_"
             "slots", 400, 9, False),
            ("bouncing_1200x675_spp16_d50_sky_full_params_adjoint", 1200, 16,
             True)):
        aflat, acam, akw = pass_args(
            pt, builtin(pt, "bouncing_spheres", width, spp, 50), dev)
        akw.pop("n_samples")
        akw["sky_gradient"] = sky
        if sky:
            params, target = adjoint_training_start(
                torch, train, wc, aflat, acam, akw, "cuda")
            opt = adjoint_optimizer(torch, params, ADJ_GEOM_LR)
        else:
            params = {k: v.detach().clone().requires_grad_(True)
                      for k, v in train.get_params(aflat).items()}
            target = torch.zeros(akw["height"], akw["width"], 3, device=dev)
            opt = torch.optim.Adam(params.values(), lr=TRAIN_LR)
        slots = wc.hard_param_slots(aflat)
        step = train.make_train_step(opt, flat=aflat, engine="cuda", **akw)
        launches = ac.render_pass_adjoint_kernel.launches
        losses, step_s = [], []
        for _ in range(LARGE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(params, acam, TRAIN_SEED, target)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
            for f, v in params.items():
                check(bool(torch.isfinite(v.grad).all()),
                      f"adjoint training {name}: the {f} gradient is not "
                      "finite")
        steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
        paths = akw["width"] * akw["height"] * spp
        rec = {"slots": len(slots), "sky_gradient": sky,
               "lr": ({"tex_color, mat_ior, mat_fuzz": TRAIN_LR,
                       "sph_center, sph_radius": ADJ_GEOM_LR}
                      if sky else TRAIN_LR),
               "losses": losses, "step_s": step_s, "median_step_s": steady,
               "median_step_ms": steady * 1e3,
               "fwd_bwd_mpaths_per_s": paths / steady / 1e6,
               "adjoint_launches": ac.render_pass_adjoint_kernel.launches
               - launches}
        adj_train[name] = rec
        emit("adjoint_train_main_path", card=card, metric=name, **rec)
        check(len(slots) == 2013, f"bouncing's hard slots: {len(slots)}")
        check(rec["adjoint_launches"] == LARGE_STEPS,
              f"adjoint training {name}: K9 ran {rec['adjoint_launches']} "
              f"times in {LARGE_STEPS} steps")
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"adjoint training {name}: the loss did not fall at every "
              f"step {losses}")
    adj_launches = ac.render_pass_adjoint_kernel.launches
    adj_fwd = wc.render_pass_kernel.launches
    adj_plain = (wc.render_pass_reference.calls
                 + wc.render_pass_grad_reference.calls
                 + ac.render_pass_adjoint_reference.calls
                 + rd._render_pass.calls)
    emit("adjoint_train_counts", adjoint_launches=adj_launches,
         forward_launches=adj_fwd,
         grad_launches=wc.render_pass_grad_kernel.launches,
         plain_calls=adj_plain)
    check(adj_fwd >= 2 * LARGE_STEPS, f"adjoint training: the forward kernel "
          f"ran {adj_fwd} times")
    check(wc.render_pass_grad_kernel.launches == 0,
          "adjoint training ran a forward-mode grad pass")
    check(adj_plain == 0, "adjoint training ran a plain pass")
    done("adjoint_train_main_path")

    # 10. the segmented adjoint (K10) against its plain version on the card:
    # tests/test_grad.py:1181's scene at SEG 6 and SEG 1, K9's four small
    # parity scenes at their K9 sizes (SEG 8), and the bench line's
    # bouncing 400x225 spp9 d50 under the sky gradient (SEG 8, every family
    # within DG_RTOL of its largest entry, K9's gate at that shape): the
    # image equal to the chunk-scan forward's, sweep 1's bounces equal to
    # the forward's and the plain version's. Then K10 against K9 at both
    # main shapes (400x225 spp9 d50 and 1200x675 spp16 d50, sky gradient):
    # images and bounces equal, each family within SEG_VS_K9_RTOL; at
    # 1200x675 K10 also against the plain version itself, adjoint_parity's
    # plain result on the same inputs, under K9's rule there (the image's
    # _assert_close statistics, equal bounces, each family within
    # ADJ_MAIN_RTOL of its largest entry)
    seg_cases = [
        ("adjoint_seg_scene_seg6", sized(adjoint_seg_scene(pt), 10, 4, 4), 6,
         False),
        ("adjoint_seg_scene_seg1", sized(adjoint_seg_scene(pt), 10, 4, 4), 1,
         False),
        ("vscan_slots", sized(vscan_slots_scene(pt), 192, 4, 16), ADJ_SEG,
         False),
        ("cornell_box", builtin(pt, "cornell_box", 128, 4, 16), ADJ_SEG,
         False),
        ("cornell_smoke", builtin(pt, "cornell_smoke", 96, 4, 16), ADJ_SEG,
         False),
        ("city301", sized(city_scene(pt), 200, 4, 6), ADJ_SEG, False),
        ("bouncing_sky", builtin(pt, "bouncing_spheres", 400, 9, 50), ADJ_SEG,
         True)]
    seg_err = {}
    for name, scene, seg, sky in seg_cases:
        flat, cam, kw = pass_args(pt, scene, dev)
        kw["sky_gradient"] = kw["sky_gradient"] or sky
        g = cotangent(torch, kw, dev, 5)
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        it_k = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        it_f = torch.zeros_like(it_k)
        it_p = torch.zeros_like(it_k)
        img_k, gr_k = ac.render_pass_adjoint_kernel(
            flat, cam, 7, 0, cotangent=g, iters=it_k, seg=seg, **kw)
        fwd = wc.render_pass_kernel(
            flat, cam, 7, 0, iters=it_f,
            prepared=wc.prepare_kernel(flat, cam, chunk_scan=True), **kw)
        out = {}

        def plain():
            out["plain"] = ac.render_pass_adjoint_seg_reference(
                flat, cam, 7, 0, cotangent=g, iters=it_p, seg=seg, **kw)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = cuda_ms(torch, plain, reps=1, warmup=0)
        plain_gib = torch.cuda.max_memory_allocated() / 2**30
        img_p, gr_p = out["plain"]
        fams = adjoint_errors(gr_k, gr_p)
        bk, bf, bp = int(it_k.sum()), int(it_f.sum()), int(it_p.sum())
        rec = {"scene": name, "seg": seg,
               "shape": f"{kw['width']}x{kw['height']} spp{kw['n_samples']} "
                        f"d{kw['max_depth']}",
               "sky_gradient": kw["sky_gradient"],
               "vs_forward_max_abs_err": float((img_k - fwd).abs().max()),
               "vs_forward_equal": bool(torch.equal(img_k, fwd)),
               **per_pixel(img_k, img_p), "families": fams,
               "kernel_bounces": bk, "forward_bounces": bf,
               "plain_bounces": bp, "plain_ms": plain_ms,
               "plain_peak_gib": plain_gib, "rtol": DG_RTOL}
        seg_err[name] = rec
        emit("adjoint_seg_parity", **rec)
        check(rec["vs_forward_max_abs_err"] <= SEG_IMAGE_ATOL,
              f"{name}: K10's image differs from the forward's by "
              f"{rec['vs_forward_max_abs_err']}")
        assert_close(f"{name} K10", rec)
        check(bk == bf == bp, f"{name}: K10 traced {bk} bounces, the forward "
              f"{bf}, its plain version {bp}")
        check(fams["tex_color"]["scale"] > 0.0, f"{name}: tex_color's "
              "gradient is 0")
        for fam, e in fams.items():
            check(bool(torch.isfinite(gr_k[fam]).all()),
                  f"{name}: K10's {fam} is not finite")
            check(e["max_abs_err"] <= DG_RTOL * e["scale"],
                  f"{name}: K10's {fam} differs from its plain version by "
                  f"{e['max_abs_err']} (limit {DG_RTOL} x {e['scale']})")
    check(seg_err["bouncing_sky"]["families"]["sph_center"]["scale"] > 0.0,
          "bouncing_sky: no sphere gradient under K10")
    del out
    torch.cuda.empty_cache()
    seg_vs_k9 = {}
    for name, width, spp in (("bouncing_sky", 400, 9),
                             ("bouncing_sky_1200x675", 1200, 16)):
        flat, cam, kw = pass_args(
            pt, builtin(pt, "bouncing_spheres", width, spp, 50), dev)
        kw["sky_gradient"] = True
        g = cotangent(torch, kw, dev, 5)
        prep = wc.prepare_kernel(flat, cam, chunk_scan=True)
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        it9 = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        it10 = torch.zeros_like(it9)
        img9, gr9 = ac.render_pass_adjoint_kernel(
            flat, cam, 7, 0, cotangent=g, iters=it9, prepared=prep, **kw)
        img10, gr10 = ac.render_pass_adjoint_kernel(
            flat, cam, 7, 0, cotangent=g, iters=it10, prepared=prep,
            seg=ADJ_SEG, **kw)
        fams = adjoint_errors(gr10, gr9)
        rec = {"scene": name, "seg": ADJ_SEG,
               "shape": f"{kw['width']}x{kw['height']} spp{kw['n_samples']} "
                        f"d{kw['max_depth']}",
               "images_equal": bool(torch.equal(img9, img10)),
               "image_max_abs_err": float((img9 - img10).abs().max()),
               "k9_bounces": int(it9.sum()), "k10_bounces": int(it10.sum()),
               "families": fams, "rtol": SEG_VS_K9_RTOL}
        if name == "bouncing_sky_1200x675":
            vs = adjoint_errors(gr10, main_plain["grads"])
            rec["vs_plain"] = {**per_pixel(img10, main_plain["image"]),
                               "families": vs,
                               "plain_bounces": main_plain["bounces"],
                               "rtol": ADJ_MAIN_RTOL}
            assert_close(f"{name} K10 against the plain version",
                         rec["vs_plain"])
            check(rec["k10_bounces"] == main_plain["bounces"],
                  f"{name}: K10 traced {rec['k10_bounces']} bounces, the "
                  f"plain version {main_plain['bounces']}")
            for fam, e in vs.items():
                check(e["max_abs_err"] <= ADJ_MAIN_RTOL * e["scale"],
                      f"{name}: K10's {fam} differs from the plain version "
                      f"by {e['max_abs_err']} (limit {ADJ_MAIN_RTOL} x "
                      f"{e['scale']})")
        seg_vs_k9[name] = rec
        emit("adjoint_seg_vs_k9", **rec)
        check(rec["image_max_abs_err"] <= SEG_IMAGE_ATOL,
              f"{name}: K10's image differs from K9's by "
              f"{rec['image_max_abs_err']}")
        check(rec["k9_bounces"] == rec["k10_bounces"], f"{name}: K9 traced "
              f"{rec['k9_bounces']} bounces, K10 {rec['k10_bounces']}")
        for fam, e in fams.items():
            check(e["max_abs_err"] <= SEG_VS_K9_RTOL * e["scale"],
                  f"{name}: K10's {fam} differs from K9's by "
                  f"{e['max_abs_err']} (limit {SEG_VS_K9_RTOL} x "
                  f"{e['scale']})")
    done("adjoint_seg_parity")

    # 10b. K9 and K10 (SEG 8) on the card, each by CUDA events, best of 3
    # after one warm-up, in turns: bouncing at the JAX bench line's 400x225
    # spp9 d50 (flat sky, every family), at 1200x675 spp16 d50 (sky
    # gradient) and the 4,913-sphere grid at 400x225 spp9 d8, the JAX
    # package's own comparison points (parallel/train.py:100-110); each
    # kernel's operation bound from the run's own bounces, Mpaths/s
    seg_times = {}
    for name, scene, sky in (
            ("bouncing_400x225_spp9_d50",
             builtin(pt, "bouncing_spheres", 400, 9, 50), False),
            ("bouncing_1200x675_spp16_d50",
             builtin(pt, "bouncing_spheres", 1200, 16, 50), True),
            ("grid4913_400x225_spp9_d8", sized(grid_scene(pt), 400, 9, 8),
             False)):
        flat, cam, kw = pass_args(pt, scene, dev)
        kw["sky_gradient"] = kw["sky_gradient"] or sky
        prep = wc.prepare_kernel(flat, cam, chunk_scan=True)
        g = cotangent(torch, kw, dev, 6)
        k9 = functools.partial(ac.render_pass_adjoint_kernel, cotangent=g,
                               prepared=prep, **kw)
        k10 = functools.partial(k9, seg=ADJ_SEG)
        t9 = cuda_ms(torch, lambda: k9(flat, cam, 0, 0))
        t10 = cuda_ms(torch, lambda: k10(flat, cam, 0, 0))
        bounces = counted_bounces(
            torch, lambda it: k10(flat, cam, 0, 0, iters=it),
            wc.lane_count(kw["width"] * kw["height"]), dev)
        n = kw["width"] * kw["height"] * kw["n_samples"]
        rec = {"k9_ms": t9, "k10_ms": t10, "k10_over_k9": t10 / t9,
               "k9_mpaths_per_s": n / t9 / 1e3,
               "k10_mpaths_per_s": n / t10 / 1e3, "bounces": bounces,
               "k9_bound_ms": adjoint_bounce_ops(flat) * bounces
               / PEAK_FP32 * 1e3,
               # K10 computes K9's function: the same bound (its re-run
               # of each segment is K10's own overhead, not the function's)
               "k10_bound_ms": adjoint_bounce_ops(flat) * bounces
               / PEAK_FP32 * 1e3,
               "sky_gradient": kw["sky_gradient"], "seg": ADJ_SEG,
               "default_sweep": ac.adjoint_sweep()}
        seg_times[name] = rec
        emit("adjoint_seg_times", card=card, shape=name, **rec)
    seg_ptxas = ptxas_table(lib.build_log).get(
        "wavefront_adjoint_seg_kernel")
    emit("adjoint_seg_build", ptxas=seg_ptxas,
         plain_ms=seg_err["bouncing_sky"]["plain_ms"], library_ms=None)
    check(seg_ptxas is not None, "no ptxas lines for the segmented adjoint")
    done("adjoint_seg_times")

    # 10c. the segmented adjoint's training main path: make_train_step over
    # all five families of bouncing_spheres with adjoint_seg=ADJ_SEG, the
    # two setups of 9d (the bench line's 400x225 spp9 d50 under the flat sky
    # from a zero target; 1200x675 spp16 d50 under the sky gradient from
    # adjoint_training_start, the geometry at ADJ_GEOM_LR): the loss falls
    # at every step, K10 runs once a step and K9, the forward-mode grad
    # kernels and every plain version never
    seg_train = {}
    for name, width, spp, sky in (
            ("bouncing_400x225_spp9_d50_fwd_bwd_full_params_adjoint_seg8",
             400, 9, False),
            ("bouncing_1200x675_spp16_d50_sky_full_params_adjoint_seg8", 1200,
             16, True)):
        aflat, acam, akw = pass_args(
            pt, builtin(pt, "bouncing_spheres", width, spp, 50), dev)
        akw.pop("n_samples")
        akw["sky_gradient"] = sky
        if sky:
            params, target = adjoint_training_start(
                torch, train, wc, aflat, acam, akw, "cuda")
            opt = adjoint_optimizer(torch, params, ADJ_GEOM_LR)
        else:
            params = {k: v.detach().clone().requires_grad_(True)
                      for k, v in train.get_params(aflat).items()}
            target = torch.zeros(akw["height"], akw["width"], 3, device=dev)
            opt = torch.optim.Adam(params.values(), lr=TRAIN_LR)
        step = train.make_train_step(opt, flat=aflat, engine="cuda",
                                     adjoint_seg=ADJ_SEG, **akw)
        wc.render_pass_kernel.launches = 0
        wc.render_pass_grad_kernel.launches = 0
        ac.render_pass_adjoint_kernel.launches = 0
        ac.render_pass_adjoint_kernel.seg_launches = 0
        wc.render_pass_reference.calls = 0
        wc.render_pass_grad_reference.calls = 0
        ac.render_pass_adjoint_reference.calls = 0
        ac.render_pass_adjoint_seg_reference.calls = 0
        rd._render_pass.calls = 0
        losses, step_s = [], []
        for _ in range(LARGE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(params, acam, TRAIN_SEED, target)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
            for f, v in params.items():
                check(bool(torch.isfinite(v.grad).all()),
                      f"K10 training {name}: the {f} gradient is not finite")
        counts = {
            "k10_launches": ac.render_pass_adjoint_kernel.seg_launches,
            "k9_launches": ac.render_pass_adjoint_kernel.launches,
            "forward_launches": wc.render_pass_kernel.launches,
            "grad_launches": wc.render_pass_grad_kernel.launches,
            "plain_calls": (wc.render_pass_reference.calls
                            + wc.render_pass_grad_reference.calls
                            + ac.render_pass_adjoint_reference.calls
                            + ac.render_pass_adjoint_seg_reference.calls
                            + rd._render_pass.calls)}
        steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
        paths = akw["width"] * akw["height"] * spp
        rec = {"sky_gradient": sky, "seg": ADJ_SEG, "losses": losses,
               "step_s": step_s, "median_step_ms": steady * 1e3,
               "fwd_bwd_mpaths_per_s": paths / steady / 1e6, **counts}
        seg_train[name] = rec
        emit("adjoint_seg_train_main_path", card=card, metric=name, **rec)
        check(counts["k10_launches"] == LARGE_STEPS,
              f"K10 training {name}: K10 ran {counts['k10_launches']} times "
              f"in {LARGE_STEPS} steps")
        check(counts["k9_launches"] == 0 and counts["grad_launches"] == 0
              and counts["plain_calls"] == 0,
              f"K10 training {name}: K9, a forward-mode grad pass or a plain "
              f"pass ran ({counts})")
        check(counts["forward_launches"] >= LARGE_STEPS,
              f"K10 training {name}: the forward kernel ran "
              f"{counts['forward_launches']} times")
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"K10 training {name}: the loss did not fall at every step "
              f"{losses}")
    seg_launches = sum(r["k10_launches"] for r in seg_train.values())
    done("adjoint_seg_train_main_path")
    # 11. the SAH BVH (ops/bvh.py, -b) and the BVH walks (K11 the stack
    # BVH, K12 the lane BVH), opt-in as in the JAX package: RTX_BVH_STACK=1,
    # RTX_LANE_BVH=1 (kernel_mode_env). The build: the walks' instances'
    # ptxas lines, the builder that ran, and the BVH build's seconds on
    # bouncing_spheres and the 32,768-sphere grid (scripts/bench_large.py's
    # grid_scene(32), the >16k regime)
    from real_time_ray_tracing_engine_tpu_torch.ops import bvh as pbvh
    t0 = time.perf_counter()
    native = pbvh._native_library()
    builder_s = time.perf_counter() - t0
    bvh_build = {}
    for name, scene in (("bouncing_spheres", pt.builders.bouncing_spheres()),
                        ("grid32768", grid_scene(pt, 32))):
        flat = pt.compile_scene(scene)
        t0 = time.perf_counter()
        flat = pbvh.build_bvh(flat)
        bvh_build[name] = {
            "build_s": time.perf_counter() - t0, "prims": flat.n_prims,
            "nodes": flat.bvh_left.shape[0],
            "depth": pbvh.tree_depth(flat.bvh_left.numpy(),
                                     flat.bvh_right.numpy(),
                                     flat.bvh_leaf.numpy())}
    # the walks' forward and grad instances (not the selection probe,
    # bvh_select_probe_kernel, which only the GPU tests launch)
    bvh_ptxas = {k: v for k, v in ptxas_table(lib.build_log).items()
                 if "_bvh_kernel" in k}
    emit("bvh_build", builder="C++ (csrc/bvh_builder.cpp)" if native
         else "numpy", builder_compile_s=builder_s, scenes=bvh_build,
         ptxas=bvh_ptxas)
    check(native is not None, "the C++ BVH builder did not build")
    # a walk's forward and its two tex_color grad tiers (the row planes,
    # the suffix tier), for each of the two walks
    check(len(bvh_ptxas) == 6, f"K11/K12 instances: {sorted(bvh_ptxas)}")
    done("bvh_build")

    # 11b. the walks against the plain pass (every primitive) and the chunk
    # scan (K6) on the same -b scene: the JAX tests' mixed sphere / quad
    # scene (K11) and sphere scene with movers (both), one pass of the -b
    # main path (the CLI's bouncing_spheres at 1200x675 renders in spp16 d50
    # passes on the compacted schedule) and bouncing_spheres at 400x225
    # spp4 d50 (both the plain passes of 3d), and the 32,768-sphere grid at
    # scripts/bench_large.py's bigcheck shape (120 wide, spp4, d4); images
    # per pixel (0 flipped values expected: the winners are exact), bounce
    # for bounce, and the compacted schedule against the single pass and
    # the plain pass
    bvh_cases = [
        ("bvh_mixed", bvh_mixed_scene(pt), ("vscan", "stack")),
        ("bvh_spheres", bvh_sphere_scene(pt), ("vscan", "stack", "lane")),
        ("bouncing_spheres_1200x675",
         builtin(pt, "bouncing_spheres", 1200, 16, 50),
         ("vscan", "stack", "lane")),
        ("bouncing_spheres", builtin(pt, "bouncing_spheres", 400, 4, 50),
         ("vscan", "stack", "lane")),
        ("grid32768", sized(grid_scene(pt, 32), 120, 4, 4),
         ("vscan", "stack", "lane"))]
    bvh_err = {}
    for name, scene, modes in bvh_cases:
        flat, cam, kw = pass_args(pt, scene, dev, use_bvh=True)
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        if name in kept_plain:
            plain, bp = kept_plain.pop(name)
            plain_ms = vscan_err[name]["plain_ms"]
        else:
            it_p = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
            out = {}

            def run_plain():
                out["plain"] = wc.render_pass_reference(flat, cam, 7, 0,
                                                        iters=it_p, **kw)
            plain_ms = cuda_ms(torch, run_plain, reps=1, warmup=0)
            plain, bp = out.pop("plain"), int(it_p.sum())
        rec = {"scene": name, "prims": flat.n_prims,
               **{k: v for k, v in kw.items() if k != "sky_gradient"},
               "plain_bounces": bp, "plain_ms": plain_ms}
        images = {}
        for mode in modes:
            with kernel_mode_env(mode):
                check(wc.kernel_mode(flat)[0] == mode, f"{name}: {mode}")
                prep = wc.prepare_kernel(flat, cam)
                kpass = functools.partial(wc.render_pass_kernel,
                                          prepared=prep)
                it_k = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
                kern = kpass(flat, cam, 7, 0, iters=it_k, **kw)
                comp = wc.render_pass_compacted(flat, cam, 7, 0,
                                                pass_fn=kpass, **kw)
            images[mode] = kern
            stats = per_pixel(kern, plain)
            rec[mode] = {
                **stats, "flipped_values": int(
                    ((kern - plain).abs() > FLIP_ATOL).sum()),
                "differing_values": int((kern != plain).sum()),
                "vs_vscan_differing_values": int(
                    (kern != images["vscan"]).sum()),
                "kernel_bounces": int(it_k.sum()),
                "compacted_vs_single_max_abs_err": float(
                    (kern - comp).abs().max()),
                "compacted_vs_plain": {
                    **per_pixel(comp, plain), "flipped_values": int(
                        ((comp - plain).abs() > FLIP_ATOL).sum())}}
            del kern, comp
        bvh_err[name] = rec
        emit("bvh_parity", **rec)
        for mode in modes:
            r = rec[mode]
            assert_close(f"{name} {mode}", r)
            assert_close(f"{name} {mode} compacted", r["compacted_vs_plain"])
            check(r["kernel_bounces"] == bp, f"{name} {mode}: the kernel "
                  f"traced {r['kernel_bounces']} bounces, plain {bp}")
            check(r["compacted_vs_single_max_abs_err"] <= COMPACT_ATOL,
                  f"{name} {mode}: compacted differs from single by "
                  f"{r['compacted_vs_single_max_abs_err']}")
    del images, plain
    torch.cuda.empty_cache()
    done("bvh_parity")

    # 11c. the walks' times beside the chunk scan's on the same -b scene:
    # bouncing_spheres 1200x675 spp16 d50 (the CLI's pass), the 301-quad
    # city 400x225 spp9 d6 (K7; no K12: quads), the 4,913- and
    # 32,768-sphere grids 400x225 spp9 d8; single pass and the compacted
    # schedule, the scene packed once, each image held against the chunk
    # scan's (the same winners: equal images and bounces), the operation
    # bound from the run's own bounces (vscan_bounce_ops: a BVH descent)
    bvh_times = {}
    for name, scene, modes in (
            ("bouncing_1200x675_spp16_d50",
             builtin(pt, "bouncing_spheres", 1200, 16, 50),
             ("vscan", "stack", "lane")),
            ("city301_400x225_spp9_d6", sized(city_scene(pt), 400, 9, 6),
             ("vscan", "stack")),
            ("grid4913_400x225_spp9_d8", sized(grid_scene(pt), 400, 9, 8),
             ("vscan", "stack", "lane")),
            ("grid32768_400x225_spp9_d8", sized(grid_scene(pt, 32), 400, 9,
                                                8),
             ("vscan", "stack", "lane"))):
        flat, cam, kw = pass_args(pt, scene, dev, use_bvh=True)
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        n = kw["width"] * kw["height"] * kw["n_samples"]
        rec, first = {}, {}
        for mode in modes:
            with kernel_mode_env(mode):
                kpass = functools.partial(
                    wc.render_pass_kernel,
                    prepared=wc.prepare_kernel(flat, cam))
                out = {}

                def single():
                    out["single"] = kpass(flat, cam, 0, 0, **kw)

                def compacted():
                    out["compacted"] = wc.render_pass_compacted(
                        flat, cam, 0, 0, pass_fn=kpass, **kw)
                t_single = cuda_ms(torch, single)
                t_comp = cuda_ms(torch, compacted)
                bounces = counted_bounces(
                    torch, lambda it: kpass(flat, cam, 0, 0, iters=it, **kw),
                    n_lanes, dev)
            first.setdefault("image", out["single"])
            first.setdefault("bounces", bounces)
            rec[mode] = {
                "single_ms": t_single, "compacted_ms": t_comp,
                "single_mpaths_per_s": n / t_single / 1e3,
                "compacted_mpaths_per_s": n / t_comp / 1e3,
                "bounces": bounces, "bound_ms": vscan_bound_ms(flat, bounces),
                "vs_vscan_differing_values": int(
                    (out["single"] != first["image"]).sum()),
                "vs_vscan_max_abs_err": float(
                    (out["single"] - first["image"]).abs().max()),
                "compacted_vs_single_max_abs_err": float(
                    (out["single"] - out["compacted"]).abs().max())}
            rec[mode]["vs_vscan_stats"] = per_pixel(out["single"],
                                                    first["image"])
        for mode in modes[1:]:
            rec[mode]["speedup_vs_vscan"] = (rec["vscan"]["single_ms"]
                                             / rec[mode]["single_ms"])
        bvh_times[name] = rec
        emit("bvh_times", card=card, shape=name,
             ops_per_bounce=vscan_bounce_ops(flat), **rec)
        for mode in modes:
            assert_close(f"{name} {mode} vs vscan",
                         rec[mode]["vs_vscan_stats"])
            check(rec[mode]["bounces"] == first["bounces"],
                  f"{name} {mode}: {rec[mode]['bounces']} bounces, the chunk "
                  f"scan {first['bounces']}")
            check(rec[mode]["compacted_vs_single_max_abs_err"]
                  <= COMPACT_ATOL, f"{name} {mode}: compacted differs from "
                  f"single by {rec[mode]['compacted_vs_single_max_abs_err']}")
    del out, first
    torch.cuda.empty_cache()
    done("bvh_times")

    # 11d. the BVH main path: the CLI with -b on bouncing_spheres at its own
    # 1200x675 spp100 d50 and on the 32,768-sphere grid as a scene file at
    # its bench shape (400x225 spp9 d8), each in the three modes: the chunk
    # scan by default, K11 under RTX_BVH_STACK=1, K12 under RTX_LANE_BVH=1.
    # Each run's launch counts (zeroed just before it) show the kernel that
    # ran and no plain pass; every mode writes the same PPM
    grid_path = Path("output") / "grid32768.json"
    grid_path.parent.mkdir(exist_ok=True)
    pt.save_scene(grid_scene(pt, 32), str(grid_path))
    bvh_main = {}
    for name, argv0, shape in (
            ("bouncing_spheres", ["--scene", "bouncing_spheres"],
             (675, 1200, 3)),
            ("grid32768", ["--scene", str(grid_path)], (225, 400, 3))):
        ppms = {}
        for mode in ("vscan", "stack", "lane"):
            argv = argv0 + ["-b", "--output", f"bvh_{name}_{mode}"]
            ppm_path = Path("output") / f"bvh_{name}_{mode}.ppm"
            if ppm_path.exists():
                ppm_path.unlink()
            counters = ("launches", "launches_vscan", "launches_stack",
                        "launches_lane")
            for c in counters:
                setattr(wc.render_pass_kernel, c, 0)
            wc.render_pass_reference.calls = 0
            rd._render_pass.calls = 0
            with kernel_mode_env(mode):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = cli.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = {c: getattr(wc.render_pass_kernel, c) for c in counters}
            plain_calls = (wc.render_pass_reference.calls
                           + rd._render_pass.calls)
            check(rc == 0, f"cli.main({argv}) returned {rc}")
            ppms[mode] = ppm_path.read_bytes()
            ppm = pt.read_ppm(ppm_path)
            check(ppm.shape == shape, f"{name} {mode}: PPM shape {ppm.shape}")
            check(counts[f"launches_{mode}"] > 0
                  and counts[f"launches_{mode}"] == counts["launches"],
                  f"{name} {mode}: launches {counts}")
            check(plain_calls == 0, f"{name} {mode}: the CLI ran the plain "
                  "engine")
            h, w, _ = shape
            paths = w * h * (100 if name == "bouncing_spheres" else 9)
            bvh_main[(name, mode)] = counts[f"launches_{mode}"]
            emit("bvh_main_path", scene=name, mode=mode, argv=argv,
                 ppm=str(ppm_path), ppm_mean_byte=float(ppm.mean()),
                 **counts, plain_calls=plain_calls, cli_wall_s=wall,
                 cli_mpaths_per_s=paths / wall / 1e6)
        check(ppms["stack"] == ppms["vscan"] and ppms["lane"] == ppms["vscan"],
              f"{name}: the three modes wrote different PPMs")
    done("bvh_main_path")

    # 11e. the BVH training main path: make_train_step over tex_color on
    # bouncing_spheres -b at 1200x675 spp16 d50 (large training's start and
    # target), LARGE_STEPS Adam steps under K11 and under K12: forward and
    # the suffix tier (K8's) on the walk's selection; the loss falls at
    # every step, the walk's grad launches counted, no plain pass. The
    # first step's gradient, by render_loss_grad, equals K8's on the chunk
    # scan (same paths, the same routes summed in the same order):
    # within 1e-5 of its largest entry. Then one step over all five
    # families on the stack-mode scene at 400x225 spp9 d50 from the dimmed
    # rows: the hard slots take the adjoint (K9, on the chunk scan's
    # tables), the forward K11
    bflat, bcam, bkw = pass_args(pt, builtin(pt, "bouncing_spheres", 1200, 16,
                                             50), dev, use_bvh=True)
    bkw.pop("n_samples")
    target = train.make_kernel_render(bflat, engine="cuda", **bkw)(
        {"tex_color": bflat.tex_color}, bcam, TRAIN_SEED).detach()
    start = bflat.tex_color.detach().clone()
    start[dim_rows] *= 0.7
    ref_grad = None
    bvh_train = {}
    for mode in ("vscan", "stack", "lane"):
        with kernel_mode_env(mode):
            _, g0 = train.render_loss_grad(
                dataclasses.replace(bflat, tex_color=start), bcam,
                TRAIN_SEED, target, engine="cuda", **bkw)
            if mode == "vscan":
                ref_grad = g0["tex_color"]
                continue
            params = {"tex_color": start.clone().requires_grad_(True)}
            step = train.make_train_step(
                torch.optim.Adam(params.values(), lr=TRAIN_LR), flat=bflat,
                engine="cuda", **bkw)
            for c in ("launches", "stack_launches", "lane_launches",
                      "suffix_launches", "vscan_tex_launches"):
                setattr(wc.render_pass_grad_kernel, c, 0)
            for c in ("launches", "launches_vscan", "launches_stack",
                      "launches_lane"):
                setattr(wc.render_pass_kernel, c, 0)
            wc.render_pass_reference.calls = 0
            wc.render_pass_grad_reference.calls = 0
            losses, step_s = [], []
            for _ in range(LARGE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(params, bcam, TRAIN_SEED, target)))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
        launched = {
            "forward": getattr(wc.render_pass_kernel, f"launches_{mode}"),
            "forward_vscan": wc.render_pass_kernel.launches_vscan,
            "grad": getattr(wc.render_pass_grad_kernel, f"{mode}_launches"),
            "suffix": wc.render_pass_grad_kernel.suffix_launches,
            "plain_calls": wc.render_pass_reference.calls
            + wc.render_pass_grad_reference.calls}
        steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
        scale = float(ref_grad.abs().max())
        err = float((g0["tex_color"] - ref_grad).abs().max())
        bvh_train[mode] = {"launches": launched, "median_step_s": steady}
        emit("bvh_train_main_path", mode=mode,
             shape="bouncing_spheres -b 1200x675 spp16 d50", losses=losses,
             step_s=step_s, median_step_ms=steady * 1e3,
             fwd_bwd_mpaths_per_s=1200 * 675 * 16 / steady / 1e6,
             grad_vs_k8_max_abs_err=err, grad_scale=scale, **launched)
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"BVH training {mode}: the loss did not fall at every step "
              f"{losses}")
        check(launched["grad"] >= LARGE_STEPS and launched["suffix"]
              == launched["grad"] and launched["forward"] >= LARGE_STEPS
              and launched["forward_vscan"] == 0
              and launched["plain_calls"] == 0,
              f"BVH training {mode}: launches {launched}")
        check(err <= 1e-5 * scale, f"BVH training {mode}: the gradient "
              f"differs from K8's on the chunk scan by {err} (limit 1e-5 x "
              f"{scale})")
    fflat, fcam, fkw = pass_args(pt, builtin(pt, "bouncing_spheres", 400, 9,
                                             50), dev, use_bvh=True)
    fkw.pop("n_samples")
    with kernel_mode_env("stack"):
        ftarget = train.make_kernel_render(fflat, engine="cuda", **fkw)(
            {"tex_color": fflat.tex_color}, fcam, TRAIN_SEED).detach()
        params = {k: v.detach().clone()
                  for k, v in train.get_params(fflat).items()}
        params["tex_color"][dim_rows] *= 0.7
        for v in params.values():
            v.requires_grad_(True)
        step = train.make_train_step(adjoint_optimizer(
            torch, params, ADJ_GEOM_LR), flat=fflat, engine="cuda", **fkw)
        adj0 = ac.render_pass_adjoint_kernel.launches
        grad0 = wc.render_pass_grad_kernel.launches
        fwd0 = wc.render_pass_kernel.launches_stack
        loss = float(step(params, fcam, TRAIN_SEED, ftarget))
    full = {"adjoint": ac.render_pass_adjoint_kernel.launches - adj0,
            "grad": wc.render_pass_grad_kernel.launches - grad0,
            "forward_stack": wc.render_pass_kernel.launches_stack - fwd0}
    emit("bvh_full_family_step", shape="bouncing_spheres -b 400x225 spp9 d50",
         mode="stack", loss=loss, **full)
    check(full["adjoint"] == 1 and full["grad"] == 0
          and full["forward_stack"] >= 1 and math.isfinite(loss)
          and loss > 0.0,
          f"BVH full-family step: {full}, {loss}")
    done("bvh_train_main_path")
    prog = progressive_phases(torch, np, pt, wc, rd, cli, dev, card, done)
    sharded = sharded_phases(torch, np, pt, wc, rd, train, dev, card, done,
                             cli_ppm, flosses)
    profiling_phase(torch, pt, wc, rd, dev, card, done)
    emit("phase_seconds", **phase_s)

    hard_main = hard_err["cornell_box_1920x1080"]
    k3_ptxas = ptxas_prefix(lib.build_log, K3_SYMBOL)
    k8_ptxas = ptxas_prefix(lib.build_log, K8_SYMBOL)
    # K6 and K7: one instance, the chunk scan's forward
    vscan_ptxas = ptxas_prefix(lib.build_log,
                               "wavefront_forward_vscan_kernel$")
    check(len(k3_ptxas) == 2 and len(k8_ptxas) == 2
          and len(vscan_ptxas) == 1,
          f"ptxas figures of K3 {k3_ptxas}, K8 {k8_ptxas} and K6 "
          f"{vscan_ptxas}")
    print(json.dumps({"kernels": [{
        "name": "wavefront_forward_kernel", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "launches": main_launches, "max_abs_err": main_err,
        "ms": times[16]["single_ms"], "plain_ms": times[16]["plain_ms"],
        "bound_ms": f_bound, "bound_by": "operations", "library_ms": None,
        "ms_at": "cornell_box 600x600 spp16 d50",
        "launches_at": "main_path, the CLI's cornell_box",
        "progressive_launches": prog["main"]["launches"],
        "progressive_launches_at": "progressive_main_path, the CLI's "
                                   "cornell_box --camera dynamic, 40 strata "
                                   "and a resume to 100",
        "compacted_ms": times[16]["compacted_ms"],
        "spp100_ms": {k: times[100][k] for k in ("single_ms",
                                                 "compacted_ms")},
        "spp100_bound_ms": f_bounds[100],
        "train_launches": {"tex_color": train_fwd,
                           "full_family": ftrain_fwd},
        "sharded_launches": {"mesh_ranks": sharded["launches"]["forward"],
                             "cli_parallel":
                                 sharded["launches"]["cli_forward"]},
        "sharded_launches_at": "mesh_ranks (two ranks: render_on_mesh and "
                               "3 full-family steps at each of 2 layouts); "
                               "cli_parallel (-p on one and on two ranks)",
        "two_launches_equal": refill,
        "ptxas": ptxas_prefix(lib.build_log,
                              "wavefront_forward_kernel$")}, {
        "name": "wavefront_grad_kernel", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "launches": train_grad,
        "max_abs_err": grad_err["cornell_box_1920x1080"]["dg"],
        "ms": t_gsingle, "plain_ms": grad_err["plain_ms"],
        "bound_ms": g_bound, "bound_by": "operations", "library_ms": None,
        "ms_at": f"cornell_box {TRAIN_W}x{TRAIN_H} spp{TRAIN_SPP} "
                 f"d{TRAIN_DEPTH}",
        "plain_ms_at": grad_err["plain_ms_at"],
        "plain_compacted_ms": grad_err["plain_compacted_ms"],
        "compacted_ms": t_gcomp,
        "ptxas": k3_ptxas}, {
        "name": "wavefront_grad_kernel[hard_slots]", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "launches": ftrain_hard,
        "max_abs_err": hard_main["dg_hard_max_abs_err"],
        "ms": t_hsingle, "plain_ms": hard_main["plain_ms"],
        "bound_ms": h_bound, "bound_by": "operations", "library_ms": None,
        "ms_at": f"cornell_box {TRAIN_W}x{TRAIN_H} spp{TRAIN_SPP} "
                 f"d{TRAIN_DEPTH}, {len(hslots)} hard slots",
        "plain_ms_at": f"cornell_box {TRAIN_W}x{TRAIN_H} spp4 d{TRAIN_DEPTH}"
                       f", {len(hslots)} hard slots",
        "max_abs_err_at": f"dG_hard, cornell_box {TRAIN_W}x{TRAIN_H} spp4 "
                          f"d{TRAIN_DEPTH}",
        "compacted_ms": t_hcomp,
        "sharded_launches": sharded["launches"]["hard_grad"],
        "sharded_launches_at": "mesh_ranks (two ranks, 3 full-family steps "
                               "at each of 2 layouts)",
        "ptxas": ptxas_hard(lib.build_log, "wavefront_grad_kernel")}, {
        "name": "wavefront_forward_vscan_kernel", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_VSCAN,
        "launches": large["bouncing_spheres"]["launches"],
        "max_abs_err": vscan_err["bouncing_spheres_1200x675"]["max_abs_err"],
        "ms": large_times["bouncing_1200x675_spp16_d50"]["single_ms"],
        "plain_ms": vscan_err["bouncing_spheres_1200x675"]["plain_ms"],
        "bound_ms": large_times["bouncing_1200x675_spp16_d50"]["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "ms_at": "bouncing_spheres 1200x675 spp16 d50",
        "plain_ms_at": "bouncing_spheres 1200x675 spp16 d50",
        "progressive_launches": prog["large"]["launches_vscan"],
        "progressive_launches_at": "progressive_large, bouncing_spheres "
                                   "1200x675 spp100 d50, a move after 15 "
                                   "strata",
        "compacted_ms":
            large_times["bouncing_1200x675_spp16_d50"]["compacted_ms"],
        "ptxas": vscan_ptxas}, {
        "name": "wavefront_forward_vscan_kernel[vquad]", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_VQUAD,
        "launches": large["city301"]["launches"],
        "max_abs_err": vscan_err["city301"]["max_abs_err"],
        "ms": large_times["city301_400x225_spp9_d6"]["single_ms"],
        "plain_ms": vscan_err["city301"]["plain_ms"],
        "bound_ms": large_times["city301_400x225_spp9_d6"]["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "ms_at": "city301 400x225 spp9 d6",
        "plain_ms_at": "city301 400x225 spp9 d6",
        "compacted_ms":
            large_times["city301_400x225_spp9_d6"]["compacted_ms"],
        "ptxas": vscan_ptxas}, {
        "name": "wavefront_planes_vscan_kernel[7_rows]", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_K3V,
        "launches": k3v_launches,
        "max_abs_err": lg_err["k3v_scan_tex"]["dg_tex_max_abs_err"],
        "ms": large_grad_times["k3v"]["single_ms"],
        "plain_ms": lg_err["k3v_scan_tex"]["plain_ms"],
        "bound_ms": large_grad_times["k3v"]["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "ms_at": "scan_tex (80 spheres, 7 rows) 1200x675 spp16 d50",
        "plain_ms_at": "scan_tex 1200x675 spp4 d50",
        "max_abs_err_at": "dG_tex, scan_tex 1200x675 spp4 d50",
        "compacted_ms": large_grad_times["k3v"]["compacted_ms"],
        "blocks_per_sm": large_grad_times["k3v"]["blocks_per_sm"],
        "ptxas": large_grad_times["k3v"]["ptxas"],
        "same_bits_twice": lg_err["k3v_scan_tex"]["same_bits_twice"]}, {
        "name": "wavefront_planes_vscan_kernel[28_rows]",
        "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_K3V,
        "launches": rows_launches,
        "max_abs_err": lg_err["k3v_rows28"]["dg_tex_max_abs_err"],
        "ms": large_grad_times["k3v_rows28"]["single_ms"],
        "plain_ms": lg_err["k3v_rows28"]["plain_ms"],
        "bound_ms": large_grad_times["k3v_rows28"]["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "ms_at": "rows (79 spheres, 28 rows) 1200x675 spp16 d50",
        "plain_ms_at": "rows 1200x675 spp4 d50",
        "max_abs_err_at": "dG_tex, rows 1200x675 spp4 d50",
        "compacted_ms": large_grad_times["k3v_rows28"]["compacted_ms"],
        "blocks_per_sm": large_grad_times["k3v_rows28"]["blocks_per_sm"],
        "ptxas": large_grad_times["k3v_rows28"]["ptxas"],
        "with_fuzz_ior_slots_ms":
            large_grad_times["k3v_k4v_rows28"]["single_ms"],
        "with_fuzz_ior_slots_blocks_per_sm":
            large_grad_times["k3v_k4v_rows28"]["blocks_per_sm"],
        "with_fuzz_ior_slots_ptxas":
            large_grad_times["k3v_k4v_rows28"]["ptxas"],
        "metals31_with_30_fuzz_slots_ms":
            large_grad_times["k3v_k4v_metals31"]["single_ms"],
        "metals31_with_30_fuzz_slots_k9_ms":
            large_grad_times["k3v_k4v_metals31"]["k9_ms"],
        "metals31_with_30_fuzz_slots_max_abs_err": {
            "dg_tex": lg_err["k3v_k4v_metals31_fuzz30"]["dg_tex_max_abs_err"],
            "dg_hard": lg_err["k3v_k4v_metals31_fuzz30"]["dg_hard"]["fuzz"][
                "max_abs_err"]},
        "room_multi_row_paths": lg_err["k3v_room29"]["multi_row_paths"],
        "room_paths": lg_err["k3v_room29"]["paths"],
        "room_max_abs_err": lg_err["k3v_room29"]["dg_tex_max_abs_err"],
        "same_bits_twice": all(lg_err[c]["same_bits_twice"] for c in (
            "k3v_rows28", "k3v_k4v_rows28", "k3v_room29",
            "k3v_k4v_metals31_fuzz30"))}, {
        "name": "wavefront_grad_vscan_kernel[hard_slots]", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_K4V,
        "launches": large_train["tex_color+mat_ior"]["launches"][
            "vscan_hard_launches"],
        "max_abs_err": max(e["max_abs_err"] for e in lg_err[
            "k4v_vscan_slots"]["dg_hard"].values()),
        "ms": large_grad_times["k4v"]["single_ms"],
        "plain_ms": lg_err["k4v_vscan_slots"]["plain_ms"],
        "bound_ms": large_grad_times["k4v"]["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "ms_at": "vscan_slots (79 spheres) 1200x675 spp16 d50, 4 slots",
        "plain_ms_at": "vscan_slots 1200x675 spp4 d50, 4 slots",
        "max_abs_err_at": "dG_hard, vscan_slots 1200x675 spp4 d50",
        "launches_at": "bouncing_spheres tex_color + mat_ior training",
        "compacted_ms": large_grad_times["k4v"]["compacted_ms"],
        "ptxas": ptxas_hard(lib.build_log, "wavefront_grad_vscan_kernel")}, {
        "name": "wavefront_grad_vscan_kernel[suffix]", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_K8,
        "launches": large_train["tex_color"]["launches"]["suffix_launches"],
        "max_abs_err": lg_err["k8_bouncing"]["dg_tex_max_abs_err"],
        "ms": large_grad_times["k8"]["single_ms"],
        "plain_ms": lg_err["k8_bouncing"]["plain_ms"],
        "bound_ms": large_grad_times["k8"]["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "ms_at": "bouncing_spheres 1200x675 spp16 d50",
        "plain_ms_at": "bouncing_spheres 1200x675 spp4 d50",
        "max_abs_err_at": "dG_tex, bouncing_spheres 1200x675 spp4 d50",
        "compacted_ms": large_grad_times["k8"]["compacted_ms"],
        "with_ior_slot_ms": large_grad_times["k8_k4v_ior"]["single_ms"],
        "same_on_every_run": all(
            all(v for k, v in r[sched].items() if k != "dg_tex_scale")
            for r in suffix_det.values()
            for sched in ("single", "compacted")),
        "ptxas": k8_ptxas}, {
        "name": "wavefront_adjoint_kernel", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_K9,
        "launches": adj_launches,
        "max_abs_err": max(e["max_abs_err"] for e in adj_err[
            "bouncing_sky_1200x675"]["families"].values()),
        "ms": adj_times["bouncing_1200x675_spp16_d50"]["ms"],
        "plain_ms": adj_err["bouncing_sky_1200x675"]["plain_ms"],
        "bound_ms": adj_times["bouncing_1200x675_spp16_d50"]["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "ms_at": "bouncing_spheres 1200x675 spp16 d50, sky gradient",
        "plain_ms_at": "bouncing_spheres 1200x675 spp16 d50, sky gradient",
        "max_abs_err_at": "the largest family's, bouncing_spheres 1200x675 "
                          "spp16 d50",
        "launches_at": "adjoint_train_main_path (2 x 4 steps)",
        "sharded_launches": sharded["launches"]["adjoint"],
        "sharded_launches_at": "mesh_ranks (two ranks, one step at (1, 2))",
        "ptxas": adj_ptxas}, {
        "name": "wavefront_adjoint_seg_kernel", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_K10,
        "launches": seg_launches,
        "max_abs_err": max(e["max_abs_err"] for e in seg_vs_k9[
            "bouncing_sky_1200x675"]["vs_plain"]["families"].values()),
        "ms": seg_times["bouncing_1200x675_spp16_d50"]["k10_ms"],
        "plain_ms": seg_err["bouncing_sky"]["plain_ms"],
        "bound_ms": seg_times["bouncing_1200x675_spp16_d50"]["k10_bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "ms_at": f"bouncing_spheres 1200x675 spp16 d50, sky gradient, SEG "
                 f"{ADJ_SEG}",
        "plain_ms_at": f"bouncing_spheres 400x225 spp9 d50, sky gradient, "
                       f"SEG {ADJ_SEG}",
        "max_abs_err_at": "the largest family's against the plain "
                          "(per-sample) version, bouncing_spheres 1200x675 "
                          "spp16 d50",
        "launches_at": "adjoint_seg_train_main_path (2 x 4 steps)",
        "ms_400x225": seg_times["bouncing_400x225_spp9_d50"]["k10_ms"],
        "ptxas": seg_ptxas}] + [{
        "name": f"wavefront_forward_bvh_kernel[{mode}]", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": tpu,
        "launches": bvh_main[("bouncing_spheres", mode)],
        "max_abs_err": max(
            bvh_err["bouncing_spheres_1200x675"][mode]["max_abs_err"],
            bvh_err["bouncing_spheres_1200x675"][mode]["compacted_vs_plain"][
                "max_abs_err"]),
        "ms": bvh_times["bouncing_1200x675_spp16_d50"][mode]["single_ms"],
        "plain_ms": bvh_err["bouncing_spheres_1200x675"]["plain_ms"],
        "bound_ms": bvh_times["bouncing_1200x675_spp16_d50"][mode][
            "bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "ms_at": "bouncing_spheres -b 1200x675 spp16 d50",
        "plain_ms_at": "bouncing_spheres 1200x675 spp16 d50",
        "max_abs_err_at": "bouncing_spheres -b 1200x675 spp16 d50, single "
                          "and compacted, against the plain pass",
        "launches_at": "bvh_main_path, the CLI's bouncing_spheres -b",
        "compacted_ms":
            bvh_times["bouncing_1200x675_spp16_d50"][mode]["compacted_ms"],
        "ptxas": {k: v for k, v in bvh_ptxas.items()
                  if "forward" in k and f"ILi{sel}E" in k}}
        for mode, tpu, sel in (("stack", TPU_K11, 2), ("lane", TPU_K12, 3))]
        + [{
        "name": f"wavefront_grad_bvh_kernel[{mode}]", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": tpu,
        "launches": bvh_train[mode]["launches"]["grad"],
        "max_abs_err": lg_err["k8_bouncing"]["bvh"][mode][
            "dg_tex_max_abs_err"],
        "ms": large_grad_times["k8"]["bvh"][mode]["single_ms"],
        "plain_ms": lg_err["k8_bouncing"]["plain_ms"],
        "bound_ms": large_grad_times["k8"]["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "ms_at": "bouncing_spheres -b 1200x675 spp16 d50, the suffix tier",
        "plain_ms_at": "bouncing_spheres 1200x675 spp4 d50",
        "max_abs_err_at": "dG_tex, bouncing_spheres -b 1200x675 spp4 d50",
        "launches_at": "bvh_train_main_path (4 steps)",
        "compacted_ms": large_grad_times["k8"]["bvh"][mode]["compacted_ms"],
        "ptxas": {k: v for k, v in bvh_ptxas.items()
                  if "grad" in k and f"ILi{sel}E" in k}}
        for mode, tpu, sel in (("stack", TPU_K11, 2), ("lane", TPU_K12, 3))]
        + [{
        "name": f"wavefront_planes_bvh_kernel[{mode}]", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": tpu,
        "launches": rows_bvh[mode]["launches"],
        "max_abs_err": lg_err["k3v_rows28"]["bvh"][mode][
            "dg_tex_max_abs_err"],
        "ms": large_grad_times["k3v_rows28"]["bvh"][mode]["single_ms"],
        "plain_ms": lg_err["k3v_rows28"]["plain_ms"],
        "bound_ms": large_grad_times["k3v_rows28"]["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "ms_at": "rows (28 rows) -b 1200x675 spp16 d50, the row planes",
        "plain_ms_at": "rows 1200x675 spp4 d50",
        "max_abs_err_at": "dG_tex, rows -b 1200x675 spp4 d50",
        "launches_at": "large_grad_main_shapes, one render_loss_grad on "
                       "rows -b 1200x675 spp16 d50",
        "compacted_ms":
            large_grad_times["k3v_rows28"]["bvh"][mode]["compacted_ms"],
        "ptxas": {k: v for k, v in bvh_ptxas.items()
                  if "planes" in k and f"ILi{sel}E" in k}}
        for mode, tpu, sel in (("stack", TPU_K11, 2), ("lane", TPU_K12, 3))]}),
        flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
