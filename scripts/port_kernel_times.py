#!/usr/bin/env python3
"""Kernel times of one checkout of the PyTorch + CUDA port on one GPU, and
its outputs for a bit-for-bit comparison with another checkout's.

    python3 scripts/port_kernel_times.py ROOT [--outputs FILE | --forward]
    python3 scripts/port_kernel_times.py ROOT --outputs-only FILE PREFIXES
    python3 scripts/port_kernel_times.py --compare FILE_A FILE_B
    python3 scripts/port_kernel_times.py --sass ROOT_A ROOT_B PATTERN...

ROOT is the directory that holds the real_time_ray_tracing_engine_tpu_torch
package to time (its kernels build into ROOT/build/kernels). The scenes and
the timer are chip_smoke.py's (CUDA events, best of 3 after one warm-up,
the scene packed once outside the timed calls): the forward kernel at
Cornell 600x600 spp16 and spp100 d50 and 1920x1080 spp64 d50 (single pass
and the compacted schedule) and the CLI's render (Cornell 600x600 spp100
d50 in batches of 16, pt.render), the tex_color grad kernel at Cornell 1920x1080
spp64 d50 (single pass and the compacted schedule) and on a 16-row scene
at 1080x1080 spp64 d50 (its NTMAX 16 instance) and, where the checkout
has hard slots, the full-family grad kernel there (single pass); where it
has the chunk scan, its forward at bouncing_spheres 400x225 spp9 d50 and
1200x675 spp16 d50, the 4,913-sphere grid 400x225 spp9 d8, the 301-quad
city 400x225 spp9 d6 and K4v's 79-sphere scene at 1200x675 spp16 d50
(single pass); where it has the
suffix-radiance tier, that grad kernel (K8) at bouncing_spheres 1200x675
spp16 d50 (single pass), and the chunk scan's other grad tiers at
chip_smoke.py's large_grad_times shapes (1200x675 spp16 d50): K8 with the
IOR slot (K4v) under the sky gradient, the weight planes (K3v) on the
80-sphere scene and on the 28-row scene, with K4v's fuzz slot (sky
gradient) and fuzz and IOR slots on them, and the tangent bundles alone
(K4v) on the 79-sphere scene's 4 slots; where it has the
adjoint, K9 there under the sky gradient and at 400x225 spp9 d50 under the
flat sky (the JAX bench line's shape); where it has the segmented adjoint,
K10 (SEG 8) at both; where it has the BVH walks, K11 (RTX_BVH_STACK=1) and
K12 (RTX_LANE_BVH=1) on bouncing_spheres -b at 400x225 spp9 d50 and
1200x675 spp16 d50 and on the 4,913- and 32,768-sphere grids -b at 400x225
spp9 d8, K11 on the city -b (single pass), their suffix tiers' grad
instances on bouncing_spheres -b at 1200x675 spp16 d50 and their weight
planes on K3v's two scenes -b at the same shape. With the times it
prints each kernel's ptxas registers, stack and spills from the library's
build. Prints one JSON line. With --forward it times the unrolled
forward's shapes and the CLI's render alone (any checkout whose
forward takes prepare_kernel, commit 55b6ee0's among them).

With --outputs it also saves (torch.save) the grad kernels' outputs, the
image, dG_tex and dG_hard of single passes at seed 7: K3's at Cornell
1920x1080 spp64 d50 and on chip_smoke.py's grad parity scenes (Cornell
128x128 spp16 d50, cornell_smoke, Cornell 1920x1080 spp4 d50) and a 16-row
scene (its NTMAX 16); K3v's on the 80-sphere scene and the 28-row
scene at 1200x675 spp4 d50, with K4v's fuzz slot (80 spheres, sky
gradient) and fuzz and IOR slots (28 rows), and in the closed room at
400x225 spp4 d50 (paths holding many rows); K4's at Cornell
1920x1080 spp64 d50 (9 slots) and on chip_smoke.py's hard-slot parity
scenes (Cornell, three_spheres, Cornell 1920x1080 spp4 d50) and on a
sphere-light scene (materials, 26 slots) and a medium scene
(cornell_smoke); K4v's at its shape and on the MIS + medium scene (both
light kinds, a medium; 9 slots: a fuzz, the ground sphere, the sphere
light); K8's on bouncing_spheres at 1200x675 spp16 d50, with the IOR slot
(K4v) at 400x225 spp4 d50, and on the suffix scene; the BVH walks' suffix
tiers (K11, K12) on bouncing_spheres -b at 1200x675 spp4 d50 and their
weight planes on the 28-row scene -b (K11 also on the 80-sphere scene
-b); each chunk-scan and walk case
also under the compacted schedule. The unrolled forward's (K1) image and
bounces of a single pass, radiance, carry and bounces of a capped pass
(cap 40) and of the capped pass resumed from its carry under a lane
permutation (K2), and compacted image, on Cornell 600x600 spp16 d50,
Cornell 100x100 spp4 d50 (10,000 pixels, not a multiple of 128) and
cornell_smoke. The forward kernels' image and bounces (single pass) and
compacted image: K6 on bouncing_spheres 1200x675 spp4 d50 and the
4,913-sphere grid, K7 on the city, K11 and K12 on bouncing_spheres -b and
the 4,913- and 32,768-sphere grids -b, K11 on the city -b and on a chain
of spheres whose walk outgrows its short stack. The adjoint's image and
grads dict, K9 and K10 (SEG 8), on bouncing_spheres 400x225 spp9 d50 under
the sky gradient. --outputs-only saves the grad cases whose names start
with one of the comma-separated PREFIXES and times nothing. --compare
prints, per output of two such files, whether
they are equal bit for bit and otherwise the largest difference, and how
many are equal.

--sass builds both roots' libraries (each in a process of its own) and
says, per kernel whose mangled name contains a PATTERN, whether the two
builds' SASS (`cuobjdump -sass`, addresses and comments dropped) is the
same instruction for instruction, and each one's instruction count.

To compare two checkouts on one card, unpack the other one (git archive)
under a git-ignored directory and time both roots in one run, in turns:
parent, change, change, parent.
"""
from __future__ import annotations

import functools
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)


def kernel_times(root: str, forward_only: bool = False) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import real_time_ray_tracing_engine_tpu_torch as pt
    from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
    cs.check(wc.__file__.startswith(root + os.sep),
             f"timed {wc.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = wc.load_library()
    out = {"root": root, "build_s": time.perf_counter() - t0,
           "ptxas": {k: v for k, v in cs.ptxas_table(lib.build_log).items()
                     if not forward_only or k == "wavefront_forward_kernel"}}

    for name, scene in (
            ("600_spp16", cs.builtin(pt, "cornell_box", 600, 16, 50)),
            ("600_spp100", cs.builtin(pt, "cornell_box", 600, 100, 50)),
            ("1080_spp64", cs.cornell_1080p(pt, cs.TRAIN_SPP,
                                            cs.TRAIN_DEPTH))):
        flat, cam, kw = cs.pass_args(pt, scene, dev)
        fwd = functools.partial(wc.render_pass_kernel,
                                prepared=wc.prepare_kernel(flat, cam))
        out[f"forward_{name}_ms"] = cs.cuda_ms(
            torch, lambda: fwd(flat, cam, 0, 0, **kw))
        out[f"forward_{name}_compacted_ms"] = cs.cuda_ms(
            torch, lambda: wc.render_pass_compacted(flat, cam, 0, 0,
                                                    pass_fn=fwd, **kw))
    # the CLI's render: Cornell 600x600 spp100 d50 in batches of 16
    scene = pt.builders.cornell_box()
    out["cli_render_600_spp100_ms"] = cs.cuda_ms(
        torch, lambda: pt.render(scene, device=dev, samples_per_batch=16,
                                 progress=lambda s, t: None))
    if forward_only:
        return out

    flat, cam, kw = cs.pass_args(
        pt, cs.cornell_1080p(pt, cs.TRAIN_SPP, cs.TRAIN_DEPTH), dev)
    g = cs.cotangent(torch, kw, dev, 6)
    grad = functools.partial(wc.render_pass_grad_kernel,
                             prepared=wc.prepare_kernel(flat, cam))
    out["grad_1080_single_ms"] = cs.cuda_ms(
        torch, lambda: grad(flat, cam, 0, 0, cotangent=g, **kw))
    out["grad_1080_compacted_ms"] = cs.cuda_ms(
        torch, lambda: wc.render_pass_grad_compacted(
            flat, cam, 0, 0, cotangent=g, pass_fn=grad, **kw))
    # K3's NTMAX 16 instance: 16 texture rows at 1080x1080 spp64 d50
    nf, nc, nkw = cs.pass_args(pt, cs.sized(cs.nt16_scene(pt), 1080, 64, 50),
                               dev)
    ng = cs.cotangent(torch, nkw, dev, 6)
    ngrad = functools.partial(wc.render_pass_grad_kernel,
                              prepared=wc.prepare_kernel(nf, nc))
    out["grad_nt16_1080_single_ms"] = cs.cuda_ms(
        torch, lambda: ngrad(nf, nc, 0, 0, cotangent=ng, **nkw))
    if hasattr(wc, "hard_param_slots"):
        slots = wc.hard_param_slots(flat)
        hard = functools.partial(wc.render_pass_grad_kernel,
                                 prepared=wc.prepare_kernel(flat, cam, slots))
        out["hard_grad_1080_single_ms"] = cs.cuda_ms(
            torch, lambda: hard(flat, cam, 0, 0, cotangent=g,
                                hard_slots=slots, **kw))
    if hasattr(wc, "pack_vscan_tables"):
        for name, scene in (
                ("vscan_bouncing_400_spp9", cs.builtin(
                    pt, "bouncing_spheres", 400, 9, 50)),
                ("vscan_bouncing_1200_spp16", cs.builtin(
                    pt, "bouncing_spheres", 1200, 16, 50)),
                ("vscan_grid4913_400_spp9_d8", cs.sized(
                    cs.grid_scene(pt), 400, 9, 8)),
                ("vquad_city_400_spp9", cs.sized(cs.city_scene(pt), 400, 9,
                                                 6)),
                ("vscan_slots_1200_spp16", cs.wide(
                    cs.vscan_slots_scene(pt), 1200, 16, 50))):
            flat, cam, kw = cs.pass_args(pt, scene, dev)
            fwd = functools.partial(wc.render_pass_kernel,
                                    prepared=wc.prepare_kernel(flat, cam))
            out[f"{name}_ms"] = cs.cuda_ms(
                torch, lambda: fwd(flat, cam, 0, 0, **kw))
    if hasattr(wc, "tex_form"):
        for name, scene, slots, want_tex, sky in _vscan_grad_cases(pt):
            vf, vc, vkw = cs.pass_args(pt, scene, dev)
            vkw["sky_gradient"] = vkw["sky_gradient"] or sky
            slots = _slots(wc, vf, slots)
            vg = cs.cotangent(torch, vkw, dev, 6)
            vgrad = functools.partial(
                wc.render_pass_grad_kernel,
                prepared=wc.prepare_kernel(vf, vc, slots))
            out[f"{name}_ms"] = cs.cuda_ms(
                torch, lambda: vgrad(vf, vc, 0, 0, cotangent=vg,
                                     hard_slots=slots, want_tex=want_tex,
                                     **vkw))
        flat, cam, kw = cs.pass_args(
            pt, cs.builtin(pt, "bouncing_spheres", 1200, 16, 50), dev)
        g = cs.cotangent(torch, kw, dev, 6)
        grad = functools.partial(wc.render_pass_grad_kernel,
                                 prepared=wc.prepare_kernel(flat, cam))
        out["suffix_bouncing_1200_spp16_ms"] = cs.cuda_ms(
            torch, lambda: grad(flat, cam, 0, 0, cotangent=g, **kw))
        try:
            from real_time_ray_tracing_engine_tpu_torch.ops import \
                adjoint_cuda as ac
        except ImportError:
            ac = None
        if ac is not None:
            kw["sky_gradient"] = True
            # K9 and, where the checkout has it, K10 at SEG 8
            sweeps = ((("adjoint", {}), ("adjoint_seg8", {"seg": 8}))
                      if hasattr(ac, "adjoint_sweep")
                      else (("adjoint", {}),))
            for shape, (flat, cam, kw, g) in (
                    ("bouncing_1200_spp16_sky", (flat, cam, kw, g)),
                    ("bouncing_400_spp9", _bouncing_400(torch, pt, dev))):
                prep = wc.prepare_kernel(flat, cam, chunk_scan=True)
                for name, extra in sweeps:
                    adj = functools.partial(ac.render_pass_adjoint_kernel,
                                            prepared=prep, **extra)
                    out[f"{name}_{shape}_ms"] = cs.cuda_ms(
                        torch, lambda: adj(flat, cam, 0, 0, cotangent=g,
                                           **kw))
    if hasattr(wc, "pack_bvh_tables"):
        for name, scene, modes in (
                ("bouncing_400_spp9", cs.builtin(
                    pt, "bouncing_spheres", 400, 9, 50), ("stack", "lane")),
                ("bouncing_1200_spp16", cs.builtin(
                    pt, "bouncing_spheres", 1200, 16, 50),
                 ("stack", "lane")),
                ("grid4913_400_spp9_d8", cs.sized(cs.grid_scene(pt), 400, 9,
                                                  8), ("stack", "lane")),
                ("grid32768_400_spp9_d8", cs.sized(cs.grid_scene(pt, 32),
                                                   400, 9, 8),
                 ("stack", "lane")),
                ("city_400_spp9", cs.sized(cs.city_scene(pt), 400, 9, 6),
                 ("stack",))):
            flat, cam, kw = cs.pass_args(pt, scene, dev, use_bvh=True)
            for mode in modes:
                with cs.kernel_mode_env(mode):
                    fwd = functools.partial(
                        wc.render_pass_kernel,
                        prepared=wc.prepare_kernel(flat, cam))
                    out[f"bvh_{mode}_{name}_ms"] = cs.cuda_ms(
                        torch, lambda: fwd(flat, cam, 0, 0, **kw))
        flat, cam, kw = cs.pass_args(
            pt, cs.builtin(pt, "bouncing_spheres", 1200, 16, 50), dev,
            use_bvh=True)
        g = cs.cotangent(torch, kw, dev, 6)
        for mode in ("stack", "lane"):
            with cs.kernel_mode_env(mode):
                grad = functools.partial(
                    wc.render_pass_grad_kernel,
                    prepared=wc.prepare_kernel(flat, cam))
                out[f"bvh_{mode}_suffix_bouncing_1200_spp16_ms"] = \
                    cs.cuda_ms(torch, lambda: grad(flat, cam, 0, 0,
                                                   cotangent=g, **kw))
        # the walks' weight-plane tiers (K3v's scenes compiled with -b)
        for name, scene in (
                ("scan_tex", cs.wide(cs.scan_tex_scene(pt), 1200, 16, 50)),
                ("rows28", cs.wide(cs.rows_scene(pt), 1200, 16, 50))):
            flat, cam, kw = cs.pass_args(pt, scene, dev, use_bvh=True)
            g = cs.cotangent(torch, kw, dev, 6)
            for mode in ("stack", "lane"):
                with cs.kernel_mode_env(mode):
                    grad = functools.partial(
                        wc.render_pass_grad_kernel,
                        prepared=wc.prepare_kernel(flat, cam))
                    out[f"bvh_{mode}_planes_{name}_1200_spp16_ms"] = \
                        cs.cuda_ms(torch, lambda: grad(flat, cam, 0, 0,
                                                       cotangent=g, **kw))
    return out


def _vscan_grad_cases(pt):
    """chip_smoke.py's large_grad_times cases past K8 alone: (name, scene,
    slots, want_tex, sky gradient)."""
    return (("k8_k4v_ior_1200_spp16_sky",
             cs.builtin(pt, "bouncing_spheres", 1200, 16, 50), "mat_ior",
             True, True),
            ("k3v_scan_tex_1200_spp16",
             cs.wide(cs.scan_tex_scene(pt), 1200, 16, 50), (), True, False),
            ("k3v_rows28_1200_spp16",
             cs.wide(cs.rows_scene(pt), 1200, 16, 50), (), True, False),
            ("k3v_k4v_scan_tex_fuzz_1200_spp16_sky",
             cs.wide(cs.scan_tex_scene(pt), 1200, 16, 50), "mat_fuzz", True,
             True),
            ("k3v_k4v_rows28_fuzz_ior_1200_spp16",
             cs.wide(cs.rows_scene(pt), 1200, 16, 50), "mat_fuzz,mat_ior",
             True, False),
            ("k4v_vscan_slots_1200_spp16",
             cs.wide(cs.vscan_slots_scene(pt), 1200, 16, 50), "jax_test",
             False, False))


def _slots(wc, flat, slots):
    """A case's hard slots: "jax_test" (chip_smoke.vscan_slots), "all",
    "mixed9" (the first material slot, the first sphere's 4 and the last
    sphere's 4: the ground and the sphere light of the MIS + medium scene),
    field names joined by commas (their slots), or ()."""
    from real_time_ray_tracing_engine_tpu_torch.scene.flat import (
        MAT_DIELECTRIC, MAT_METAL)
    if slots == "jax_test":
        return cs.vscan_slots(flat.mat_type.cpu(), MAT_METAL, MAT_DIELECTRIC)
    if slots == "mixed9":
        every = wc.hard_param_slots(flat)
        mats = [x for x in every if x[0] in ("fuzz", "ior")]
        sph = [x for x in every if x[0] in ("sphc", "sphr")]
        return tuple(mats[:1] + sph[:4] + sph[-4:])
    if slots == "all":
        return wc.hard_param_slots(flat)
    if slots:
        return wc.hard_param_slots(flat, set(slots.split(",")))
    return ()


def kernel_outputs(root: str, only: tuple = ()) -> dict:
    """{name: {part: tensor}} on the cases the module docstring lists, at
    seed 7: the grad kernels' image, dG_tex and dG_hard of single passes
    (and, on the chunk scan's and the walks' cases, of the compacted
    schedule); the forward kernels' image and bounces of single passes and
    image of the compacted schedule; the adjoint sweeps' image and grads
    dict. `only` (name prefixes) keeps the grad cases whose names start
    with one of them, and nothing else."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import real_time_ray_tracing_engine_tpu_torch as pt
    from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    dev = torch.device("cuda", 0)
    cases = (
        ("k4_cornell_1920x1080_spp64_d50",
         cs.cornell_1080p(pt, cs.TRAIN_SPP, cs.TRAIN_DEPTH), "all", False),
        ("k4_cornell_64_spp4_d16", cs.builtin(pt, "cornell_box", 64, 4, 16),
         "all", False),
        ("k4_three_spheres_64_spp4_d8",
         cs.builtin(pt, "three_spheres", 64, 4, 8), "all", False),
        ("k4_cornell_1920x1080_spp4_d50", cs.cornell_1080p(pt, 4, 50), "all",
         False),
        ("k4_materials_sphere_light_64_spp4_d16",
         cs.sized(cs.materials_scene(pt), 64, 4, 16), "all", False),
        ("k4_cornell_smoke_medium_96_spp4_d16",
         cs.builtin(pt, "cornell_smoke", 96, 4, 16), "all", False),
        ("k4v_vscan_slots_1200x675_spp16_d50",
         cs.wide(cs.vscan_slots_scene(pt), 1200, 16, 50), "jax_test",
         False),
        ("k4v_mis_medium_128_spp4_d8",
         cs.sized(cs.mis_medium_scene(pt), 128, 4, 8), "mixed9", False),
        ("k8_k4v_ior_bouncing_400x225_spp4_d50_sky",
         cs.builtin(pt, "bouncing_spheres", 400, 4, 50), "mat_ior", True),
        ("k3_cornell_1920x1080_spp64_d50",
         cs.cornell_1080p(pt, cs.TRAIN_SPP, cs.TRAIN_DEPTH), (), False),
        ("k3_cornell_128_spp16_d50",
         cs.builtin(pt, "cornell_box", 128, 16, 50), (), False),
        ("k3_cornell_smoke_96_spp4_d16",
         cs.builtin(pt, "cornell_smoke", 96, 4, 16), (), False),
        ("k3_cornell_1920x1080_spp4_d50", cs.cornell_1080p(pt, 4, 50), (),
         False),
        ("k3_nt16_64_spp4_d8", cs.sized(cs.nt16_scene(pt), 64, 4, 8), (),
         False),
        ("k3v_scan_tex_1200x675_spp4_d50",
         cs.wide(cs.scan_tex_scene(pt), 1200, 4, 50), (), False),
        ("k3v_rows28_1200x675_spp4_d50",
         cs.wide(cs.rows_scene(pt), 1200, 4, 50), (), False),
        ("k8_bouncing_1200x675_spp16_d50",
         cs.builtin(pt, "bouncing_spheres", 1200, 16, 50), (), False),
        ("k8_suffix_scene_256_spp16_d8",
         cs.sized(cs.suffix_scene(pt), 256, 16, 8), (), False),
        ("k11_suffix_bouncing_1200x675_spp4_d50",
         cs.builtin(pt, "bouncing_spheres", 1200, 4, 50), (), False),
        ("k12_suffix_bouncing_1200x675_spp4_d50",
         cs.builtin(pt, "bouncing_spheres", 1200, 4, 50), (), False),
        ("k11_rows28_1200x675_spp4_d50",
         cs.wide(cs.rows_scene(pt), 1200, 4, 50), (), False),
        ("k12_rows28_1200x675_spp4_d50",
         cs.wide(cs.rows_scene(pt), 1200, 4, 50), (), False),
        ("k11_scan_tex_1200x675_spp4_d50",
         cs.wide(cs.scan_tex_scene(pt), 1200, 4, 50), (), False),
        ("k3v_k4v_scan_tex_fuzz_1200x675_spp4_d50_sky",
         cs.wide(cs.scan_tex_scene(pt), 1200, 4, 50), "mat_fuzz", True),
        ("k3v_k4v_rows28_fuzz_ior_1200x675_spp4_d50",
         cs.wide(cs.rows_scene(pt), 1200, 4, 50), "mat_fuzz,mat_ior",
         False),
        ("k3v_room_400x225_spp4_d50",
         cs.wide(cs.room_scene(pt), 400, 4, 50), (), False))
    if only:
        cases = tuple(c for c in cases if c[0].startswith(only))
    out = {}
    for name, scene, slots, sky in cases:
        mode = {"k11": "stack", "k12": "lane"}.get(name[:3], "vscan")
        flat, cam, kw = cs.pass_args(pt, scene, dev,
                                     use_bvh=mode != "vscan")
        kw["sky_gradient"] = kw["sky_gradient"] or sky
        slots = _slots(wc, flat, slots)
        g = cs.cotangent(torch, kw, dev, 5)
        want_tex = not name.startswith("k4v_vscan")
        with cs.kernel_mode_env(mode):
            parts = dict(zip(("image", "dg_tex", "dg_hard"),
                             wc.render_pass_grad_kernel(
                                 flat, cam, 7, 0, cotangent=g,
                                 hard_slots=slots, want_tex=want_tex, **kw)))
            if wc.kernel_mode(flat)[0] != "unrolled":
                parts.update(zip(
                    ("compacted_image", "compacted_dg_tex",
                     "compacted_dg_hard"),
                    wc.render_pass_grad_compacted(
                        flat, cam, 7, 0, cotangent=g, hard_slots=slots,
                        want_tex=want_tex, **kw)))
        out[name] = _cpu(torch, parts)
        del parts
        torch.cuda.empty_cache()
    if only:
        return out
    # the unrolled forward (K1) and its capped / resumed passes (K2): the
    # image and bounces of a single pass; the radiance, carry and bounces
    # of a capped pass and of a capped pass resumed from its carry under a
    # lane permutation; the compacted image
    for name, scene in (
            ("k1_cornell_600x600_spp16_d50",
             cs.builtin(pt, "cornell_box", 600, 16, 50)),
            ("k1_cornell_100x100_spp4_d50",
             cs.sized(pt.builders.cornell_box(), 100, 4, 50)),
            ("k1_cornell_smoke_96_spp4_d16",
             cs.builtin(pt, "cornell_smoke", 96, 4, 16))):
        flat, cam, kw = cs.pass_args(pt, scene, dev)
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        its = [torch.zeros(n_lanes, dtype=torch.int32, device=dev)
               for _ in range(3)]
        img = wc.render_pass_kernel(flat, cam, 7, 0, iters=its[0], **kw)
        rad_c, carry_c = wc.render_pass_kernel(flat, cam, 7, 0, cap=40,
                                               iters=its[1], **kw)
        perm = torch.randperm(n_lanes, generator=torch.Generator()
                              .manual_seed(3)).to(dev)
        pix = wc._identity_pixels(n_lanes, kw["width"] * kw["height"],
                                  dev)[perm]
        rad_r, carry_r = wc.render_pass_kernel(
            flat, cam, 7, 0, cap=40, carry=carry_c[:, perm], pix_lanes=pix,
            iters=its[2], **kw)
        two = wc.render_pass_compacted(flat, cam, 7, 0, **kw)
        out[name] = _cpu(torch, {
            "image": img, "bounces": its[0], "capped_rad": rad_c,
            "capped_carry": carry_c, "capped_bounces": its[1],
            "resumed_rad": rad_r, "resumed_carry": carry_r,
            "resumed_bounces": its[2], "compacted_image": two})
    # the forward kernels: K6, K7 (the city's quad chunks), K11, K12
    forwards = (
        ("k6_bouncing_1200x675_spp4_d50", "vscan",
         cs.builtin(pt, "bouncing_spheres", 1200, 4, 50)),
        ("k6_grid4913_400x225_spp9_d8", "vscan",
         cs.sized(cs.grid_scene(pt), 400, 9, 8)),
        ("k7_city301_400x225_spp9_d6", "vscan",
         cs.sized(cs.city_scene(pt), 400, 9, 6)),
        ("k11_bouncing_1200x675_spp4_d50", "stack",
         cs.builtin(pt, "bouncing_spheres", 1200, 4, 50)),
        ("k12_bouncing_1200x675_spp4_d50", "lane",
         cs.builtin(pt, "bouncing_spheres", 1200, 4, 50)),
        ("k11_city301_400x225_spp9_d6", "stack",
         cs.sized(cs.city_scene(pt), 400, 9, 6)),
        ("k11_grid4913_400x225_spp9_d8", "stack",
         cs.sized(cs.grid_scene(pt), 400, 9, 8)),
        ("k12_grid4913_400x225_spp9_d8", "lane",
         cs.sized(cs.grid_scene(pt), 400, 9, 8)),
        ("k11_grid32768_400x225_spp4_d8", "stack",
         cs.sized(cs.grid_scene(pt, 32), 400, 4, 8)),
        ("k12_grid32768_400x225_spp4_d8", "lane",
         cs.sized(cs.grid_scene(pt, 32), 400, 4, 8)),
        ("k11_chain_48_spp4_d4", "stack", cs.bvh_chain_scene(pt)))
    for name, mode, scene in forwards:
        flat, cam, kw = cs.pass_args(pt, scene, dev,
                                     use_bvh=mode != "vscan")
        with cs.kernel_mode_env(mode):
            n_lanes = wc.lane_count(kw["width"] * kw["height"])
            iters = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
            img = wc.render_pass_kernel(flat, cam, 7, 0, iters=iters, **kw)
            two = wc.render_pass_compacted(flat, cam, 7, 0, **kw)
        out[name] = _cpu(torch, {"image": img, "bounces": iters,
                                 "compacted_image": two})
    # the adjoint's sweeps (K9; K10 at SEG 8) on bouncing_spheres at the
    # JAX bench line's shape under the sky gradient
    flat, cam, kw = cs.pass_args(
        pt, cs.builtin(pt, "bouncing_spheres", 400, 9, 50), dev)
    kw["sky_gradient"] = True
    g = cs.cotangent(torch, kw, dev, 5)
    prep = wc.prepare_kernel(flat, cam, chunk_scan=True)
    for name, seg in (("k9_bouncing_400x225_spp9_d50_sky", 0),
                      ("k10_seg8_bouncing_400x225_spp9_d50_sky", 8)):
        img, grads = ac.render_pass_adjoint_kernel(
            flat, cam, 7, 0, cotangent=g, prepared=prep, seg=seg, **kw)
        out[name] = _cpu(torch, {"image": img, **{
            f"grad_{k}": v for k, v in sorted(grads.items())}})
    return out


def _cpu(torch, parts: dict) -> dict:
    return {k: torch.empty(0) if v is None else v.detach().cpu()
            for k, v in parts.items()}


def compare(path_a: str, path_b: str) -> dict:
    """Per output of two kernel_outputs files: bit-for-bit equality, else
    the largest absolute difference and the largest entry."""
    import torch
    a, b = torch.load(path_a), torch.load(path_b)
    rep = {}
    for name in sorted(set(a) | set(b)):
        if name not in a or name not in b:
            rep[name] = "missing"
            continue
        for part in sorted(set(a[name]) | set(b[name])):
            key = f"{name}.{part}"
            if part not in a[name] or part not in b[name]:
                rep[key] = "missing"
                continue
            x, y = a[name][part], b[name][part]
            if x.shape != y.shape:
                rep[key] = f"shapes {tuple(x.shape)} vs {tuple(y.shape)}"
            elif torch.equal(x.view(torch.int32) if x.numel() else x,
                             y.view(torch.int32) if y.numel() else y):
                rep[key] = "equal bit for bit"
            else:
                rep[key] = {"max_abs_diff": float((x - y).abs().max()),
                            "scale": float(y.abs().max()),
                            "equal_as_floats": bool(torch.equal(x, y))}
    n_equal = sum(v == "equal bit for bit" for v in rep.values())
    rep["summary"] = f"{n_equal} of {len(rep)} outputs equal bit for bit"
    return rep


def _library_path(root: str) -> str:
    """The kernel library of the package under root, built if need be, in
    a process of its own (two roots' packages share a module name)."""
    import subprocess
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from "
            "real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda"
            " as wc; print(wc.load_library().path)")
    out = subprocess.run([sys.executable, "-c", code, os.path.abspath(root)],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def _sass(lib: str) -> dict:
    """{kernel: [instruction, ...]} of a library (cuobjdump -sass)."""
    import re
    import subprocess
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and m:
            out[name].append(m.group(1))
    return out


def compare_sass(root_a: str, root_b: str, patterns) -> dict:
    """Per kernel matching a pattern: same SASS or not, and the counts."""
    a, b = (_sass(_library_path(r)) for r in (root_a, root_b))
    rep = {}
    for name in sorted(set(a) | set(b)):
        if not any(p in name for p in patterns):
            continue
        x, y = a.get(name, []), b.get(name, [])
        rep[name] = {"same": x == y, "instructions": [len(x), len(y)]}
    return rep


def _bouncing_400(torch, pt, dev):
    """(flat, cam, kw, cotangent) of bouncing_spheres at the JAX bench
    line's 400x225 spp9 d50, flat sky."""
    flat, cam, kw = cs.pass_args(
        pt, cs.builtin(pt, "bouncing_spheres", 400, 9, 50), dev)
    return flat, cam, kw, cs.cotangent(torch, kw, dev, 6)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        print(json.dumps(compare(sys.argv[2], sys.argv[3])), flush=True)
    elif sys.argv[1] == "--sass":
        print(json.dumps(compare_sass(sys.argv[2], sys.argv[3],
                                      sys.argv[4:])), flush=True)
    elif len(sys.argv) > 4 and sys.argv[2] == "--outputs-only":
        import torch
        torch.save(kernel_outputs(sys.argv[1], tuple(sys.argv[4].split(","))),
                   sys.argv[3])
    else:
        print(json.dumps(kernel_times(sys.argv[1], "--forward" in sys.argv)),
              flush=True)
        if len(sys.argv) > 3 and sys.argv[2] == "--outputs":
            import torch
            torch.save(kernel_outputs(sys.argv[1]), sys.argv[3])
