#!/usr/bin/env python3
"""Kernel times of one checkout of the PyTorch + CUDA port on one GPU.

    python3 scripts/port_kernel_times.py ROOT

ROOT is the directory that holds the real_time_ray_tracing_engine_tpu_torch
package to time (its kernels build into ROOT/build/kernels). The scenes and
the timer are chip_smoke.py's (CUDA events, best of 3 after one warm-up,
the scene packed once outside the timed calls): the forward kernel at
Cornell 600x600 spp16 d50, the tex_color grad kernel at Cornell 1920x1080
spp64 d50 (single pass and the compacted schedule) and, where the checkout
has hard slots, the full-family grad kernel there (single pass); where it
has the chunk scan, its forward at bouncing_spheres 400x225 spp9 d50 and
the 301-quad city 400x225 spp9 d6 (single pass); where it has the
suffix-radiance tier, that grad kernel (K8) at bouncing_spheres 1200x675
spp16 d50 (single pass); where it has the adjoint, K9 there under the sky
gradient and at 400x225 spp9 d50 under the flat sky (the JAX bench line's
shape); where it has the segmented adjoint, K10 (SEG 8) at both; where it
has the BVH walks, K11 (RTX_BVH_STACK=1) and K12 (RTX_LANE_BVH=1) on
bouncing_spheres -b at 400x225 spp9 d50 and K11 on the city -b (single
pass). With the times it prints each kernel's ptxas registers, stack and
spills from the library's build. Prints one JSON line.

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


def kernel_times(root: str) -> dict:
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
           "ptxas": cs.ptxas_table(lib.build_log)}

    flat, cam, kw = cs.pass_args(
        pt, cs.builtin(pt, "cornell_box", 600, 16, 50), dev)
    fwd = functools.partial(wc.render_pass_kernel,
                            prepared=wc.prepare_kernel(flat, cam))
    out["forward_600_spp16_ms"] = cs.cuda_ms(
        torch, lambda: fwd(flat, cam, 0, 0, **kw))

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
                ("vquad_city_400_spp9", cs.sized(cs.city_scene(pt), 400, 9,
                                                 6))):
            flat, cam, kw = cs.pass_args(pt, scene, dev)
            fwd = functools.partial(wc.render_pass_kernel,
                                    prepared=wc.prepare_kernel(flat, cam))
            out[f"{name}_ms"] = cs.cuda_ms(
                torch, lambda: fwd(flat, cam, 0, 0, **kw))
    if hasattr(wc, "tex_form"):
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
    return out


def _bouncing_400(torch, pt, dev):
    """(flat, cam, kw, cotangent) of bouncing_spheres at the JAX bench
    line's 400x225 spp9 d50, flat sky."""
    flat, cam, kw = cs.pass_args(
        pt, cs.builtin(pt, "bouncing_spheres", 400, 9, 50), dev)
    return flat, cam, kw, cs.cotangent(torch, kw, dev, 6)


if __name__ == "__main__":
    print(json.dumps(kernel_times(sys.argv[1])), flush=True)
