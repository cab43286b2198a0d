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
K8), with the chunk scan's weight planes (K3v, in registers and for 17 to
32 rows in shared memory) and tangent bundles (K4v) at their full-size
shapes on the JAX tests' scenes and a 28-row scene. Every phase prints
one JSON line; any failure raises and the script exits non-zero. The last
lines are each phase's seconds, the kernel table, the card's name and power
limit, and {"ok": true, "device": {...}}.

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

# Operations of one bounce of the kernel on a Lambertian hit, counted by
# hand from csrc/wavefront.cu (each add, multiply, divide, compare, min/max,
# sqrt and transcendental is one; the RNG's 32-bit integer ops are counted
# at the same rate). Ray generation (once per sample) is left out, and so is
# everything a bounce does not need on Cornell's walls: a lower bound.
OPS_RNG = 126             # 9 draws: 3 PCG4D blocks of 32 ops, +10 each
OPS_HIT = 17              # dot(d, d), the hit point and normal
OPS_SPHERE = 37           # moving center, roots, nearest-root selection
OPS_QUAD = 59             # plane t, the inside test, range compares
OPS_SHADE = 91            # ONB (40), cosine sample (35), pdfs and MIS
                          # weight (10), throughput update (6)
OPS_LIGHT_PDF = {"sphere": 55, "quad": 62}       # per light, every bounce
OPS_LIGHT_SAMPLE = {"sphere": 100, "quad": 25}   # one light, half the time
OPS_PLANE = 4             # grad: one weight plane's update at a scatter
# grad, hard slots: the tangent work of one slot on a Lambertian bounce off
# Cornell's walls, beside the float bounce that computes every value once
# (as jax.linearize does; the kernel's physics<Dual> redoes the values per
# slot). Counted from csrc/wavefront.cu: a tangent add 1, a product or
# quotient with a constant 1, of two duals 3, a sqrt 2, a min/max/abs 1;
# only tangents that reach the outputs (alpha, beta and the roots are read
# as values only), and none through the wall's normal (a table constant, so
# the ONB and the cosine sample carry no tangent). The hit point 25; half
# the bounces sample a light, the glass sphere's copy 158 or the quad 23
# (45.25); then that direction's clamped cosine 7, the sampled light's pdf
# (sphere 30, quad 27), the mixture 6 and the MIS weight 3 (22.25); the
# throughput 12. The other lights' pdfs along a cosine-sampled direction
# are left out, where it hits them: a lower bound.
OPS_SLOT = 104.5
# the chunk scan's bound counts the intersection as what these inputs need
# at least: a binary BVH descent, the reference engine's own per-thread
# traversal (BVHNode.cu:9-31), 2 ceil(log2 N) box tests (AABB::hit, about
# 10 operations an axis) and 2 primitive tests. A chunk scan does more.
OPS_BOX = 30
# the suffix tier (K8): phase B replays each phase-A bounce (a second
# vscan_bounce_ops) and routes its hit's events: per channel the suffix
# T - P, |at| against 1e-8, the division, the emission select, the sum,
# the cotangent product and the accumulator add (7), and the prefix add
OPS_ROUTE = 3 * 8
PEAK_FP32 = 67e12         # H100 SXM fp32 outside the tensor cores (with
                          # FMA counted as two; the kernel is built
                          # --fmad=false, so it can reach half of this)


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
    MAX_GRAD_TEXS, so the chunk scan's weight planes in shared memory (K3v,
    NT 17-32)."""
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


def cornell_1080p(pt, spp, depth):
    """Cornell at 1920x1080 (bench.py:132-137)."""
    scene = builtin(pt, "cornell_box", TRAIN_W, spp, depth)
    scene.camera.aspect_ratio = TRAIN_W / TRAIN_H
    return scene


def cotangent(torch, kw, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(kw["height"], kw["width"], 3, generator=gen,
                       device=dev)


def light_ops(flat) -> float:
    """Every light's pdf, and half the bounces one light's sample."""
    kinds = ["sphere" if bool(x) else "quad" for x in
             (flat.light_prim[:flat.n_lights]
              < flat.sph_center.shape[0]).tolist()]
    if not kinds:
        return 0.0
    return (sum(OPS_LIGHT_PDF[k] for k in kinds)
            + 0.5 * sum(OPS_LIGHT_SAMPLE[k] for k in kinds) / len(kinds))


def bounce_ops(flat, grad: bool, n_slots: int = 0) -> float:
    """Operations of one Lambertian bounce on `flat`, with the weight
    planes (grad) and n_slots hard-slot evaluations (see OPS_*)."""
    ops = (OPS_RNG + OPS_HIT + OPS_SHADE
           + OPS_SPHERE * int(flat.sph_active.sum())
           + OPS_QUAD * int(flat.quad_active.sum()) + light_ops(flat))
    if grad:
        ops += OPS_PLANE * 3 * flat.tex_type.shape[0]
    return float(ops + OPS_SLOT * n_slots)


def vscan_bounce_ops(flat) -> float:
    """Operations of one Lambertian bounce on a large scene, its
    intersection counted as a BVH descent (OPS_BOX): a lower bound."""
    n_sph = int(flat.sph_active.sum())
    n = n_sph + int(flat.quad_active.sum())
    prim = OPS_SPHERE if n_sph else OPS_QUAD
    return float(OPS_RNG + OPS_HIT + OPS_SHADE + light_ops(flat)
                 + 2 * math.ceil(math.log2(max(n, 2))) * OPS_BOX + 2 * prim)


def bound_ms(flat, grad: bool, bounces: int, n_slots: int = 0) -> float:
    """The least time the card could take for `bounces` bounces: operations
    over the fp32 peak. Bytes are negligible beside it (a few floats per
    lane, tables in shared memory)."""
    return bounce_ops(flat, grad, n_slots) * bounces / PEAK_FP32 * 1e3


def vscan_bound_ms(flat, bounces: int) -> float:
    """bound_ms for the chunk scan's forward (vscan_bounce_ops). Bytes stay
    negligible: the tables (under 1 MB) are read once into L2."""
    return vscan_bounce_ops(flat) * bounces / PEAK_FP32 * 1e3


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
    vscan_err = {}
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
    slots = wc.hard_param_slots(tflat)
    glass_mats = [sl[1] for sl in slots if sl[0] == "ior"]
    glass_rows = [sl[1] for sl in slots if sl[0] == "sphr"]
    fparams = {k: v.detach().clone()
               for k, v in train.get_params(tflat).items()}
    fparams["tex_color"][WALL_ROWS] *= 0.7
    fparams["mat_ior"][glass_mats] = START_IOR
    fparams["sph_radius"][glass_rows] = START_RADIUS
    for v in fparams.values():
        v.requires_grad_(True)
    fstep = train.make_train_step(torch.optim.Adam([
        {"params": [fparams["tex_color"], fparams["mat_ior"],
                    fparams["mat_fuzz"]], "lr": TRAIN_LR},
        {"params": [fparams["sph_center"], fparams["sph_radius"]],
         "lr": GEOM_LR}]), flat=tflat, engine="cuda", **tkw)
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
    # forward kernel's, the bounces (the suffix tier traces each sample
    # twice: twice the forward's, and the plain pass's), dG_tex and dG_hard
    # (per family) within DG_RTOL of their largest entries (the suffix
    # tier's accumulators add with float atomics, in no fixed order), and
    # the compacted schedule (K5) against the single pass. bouncing's IOR
    # slot is taken under the sky gradient: under its own constant
    # background no radiance depends on a direction, so every hard
    # gradient of the scene is exactly 0 (both versions give 0).
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
        ("k4v_vscan_slots", wide(vscan_slots_scene(pt), 1200, 4, 50),
         "jax_test", False, False),
        ("k8_k4v_vscan_slots", wide(vscan_slots_scene(pt), 1200, 4, 50),
         "jax_test", True, False)]
    from real_time_ray_tracing_engine_tpu_torch.scene.flat import (
        MAT_DIELECTRIC, MAT_METAL)
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
        img_k, dgt_k, dgh_k = wc.render_pass_grad_kernel(flat, cam, 7, 0,
                                                         iters=it_k, **gkw)
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
        if want_tex:
            rec["dg_tex_scale"] = float(dgt_p.abs().max())
            rec["dg_tex_max_abs_err"] = float((dgt_k - dgt_p).abs().max())
            rec["dg_tex_compacted_max_abs_err"] = float(
                (dgt_c - dgt_k).abs().max())
        if slots:
            rec["dg_hard"] = family_errors(slots, dgh_k, dgh_p)
            rec["dg_hard_compacted_max_abs_err"] = float(
                (dgh_c - dgh_k).abs().max())
        lg_err[name] = rec
        emit("large_grad_parity", **rec)
        assert_close(f"{name} grad", stats)
        check(rec["vs_forward_max_abs_err"] <= 1e-6, f"{name}: the grad "
              f"image differs from the forward kernel's by "
              f"{rec['vs_forward_max_abs_err']}")
        check(np.allclose(img_c.cpu().numpy(), img_k.cpu().numpy(),
                          atol=COMPACT_ATOL),
              f"{name}: compacted image differs from single by "
              f"{rec['compacted_image_max_abs_err']}")
        twice = 2 if form == "suffix" else 1
        check(bk == bp == twice * bf, f"{name}: kernel traced {bk} "
              f"bounces, plain {bp}, forward {bf} (x{twice})")
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
    # the compacted schedule), the same on the 28-row scene (K3v's planes
    # in shared memory), and the 79-sphere scene's 4 slots through the
    # compacted grad driver, one pass each
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
                    float(rgrads["tex_color"].abs().max())},
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
    check(bool(torch.isfinite(sgrads["tex_color"]).all())
          and float(sgrads["tex_color"].abs().max()) > 0.0,
          "K3v main shape: dG_tex not finite or all zero")
    check(bool(torch.isfinite(vdg).all()) and bool((vdg != 0).all()),
          f"K4v main shape: dG_hard {vdg.tolist()}")
    check(plain_calls == 0, "the K3v/K4v main shapes ran a plain pass")
    done("large_grad_main_shapes")

    # 8d. the chunk scan's grad kernels' times at the main path's shape
    # (1200x675 spp16 d50): K8 on bouncing (and with its IOR slot, K4v, under
    # the sky gradient), K3v on the 80-sphere scene, K4v on the 79-sphere
    # scene's 4 slots; single pass and the compacted schedule (the default
    # grad caps), the scene packed once; bounds from the run's own bounces
    # (the forward's: the suffix tier's phase-A bounces)
    large_grad_times = {}
    for name, scene, slots, want_tex, sky in (
            ("k8", builtin(pt, "bouncing_spheres", 1200, 16, 50), (), True,
             False),
            ("k8_k4v_ior", builtin(pt, "bouncing_spheres", 1200, 16, 50),
             "mat_ior", True, True),
            ("k3v", wide(scan_tex_scene(pt), 1200, 16, 50), (), True, False),
            ("k3v_rows28", wide(rows_scene(pt), 1200, 16, 50), (), True,
             False),
            ("k4v", wide(vscan_slots_scene(pt), 1200, 16, 50), "jax_test",
             False, False)):
        flat, cam, kw = pass_args(pt, scene, dev)
        kw["sky_gradient"] = kw["sky_gradient"] or sky
        if slots == "jax_test":
            slots = vscan_slots(flat.mat_type.cpu(), MAT_METAL,
                                MAT_DIELECTRIC)
        elif slots:
            slots = wc.hard_param_slots(flat, {slots})
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
            ops += vscan_bounce_ops(flat) + OPS_ROUTE
        elif form == "planes":
            ops += OPS_PLANE * 3 * flat.tex_type.shape[0]
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
        large_grad_times[name] = rec
        emit("large_grad_times", card=card, shape=f"{name} 1200x675 spp16 "
             "d50", **rec)
    done("large_grad_times")
    emit("phase_seconds", **phase_s)

    hard_main = hard_err["cornell_box_1920x1080"]
    print(json.dumps({"kernels": [{
        "name": "wavefront_forward_kernel", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "launches": launches, "max_abs_err": main_err,
        "ms": times[16]["single_ms"], "plain_ms": times[16]["plain_ms"],
        "bound_ms": f_bound, "bound_by": "operations", "library_ms": None,
        "ms_at": "cornell_box 600x600 spp16 d50"}, {
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
        "compacted_ms": t_gcomp}, {
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
        "compacted_ms": t_hcomp}, {
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
        "compacted_ms":
            large_times["bouncing_1200x675_spp16_d50"]["compacted_ms"]}, {
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
            large_times["city301_400x225_spp9_d6"]["compacted_ms"]}, {
        "name": "wavefront_grad_vscan_kernel[planes]", "route": "cuda",
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
        "compacted_ms": large_grad_times["k3v"]["compacted_ms"]}, {
        "name": "wavefront_grad_vscan_kernel[shared_planes]",
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
        "compacted_ms": large_grad_times["k3v_rows28"]["compacted_ms"]}, {
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
        "compacted_ms": large_grad_times["k4v"]["compacted_ms"]}, {
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
        "compacted_ms": large_grad_times["k8"]["compacted_ms"]}]}),
        flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
