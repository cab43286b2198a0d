"""Render driver: the static (batch) render.

Port of the static half of the JAX package's models/render.py (reference
StaticCamera.cpp:25-131). `render` compiles the scene, picks the engine and
accumulates the image pass by pass:

  - "cuda": the forward megakernel (ops/wavefront_cuda.py), single pass or
    capped + compacted: its unrolled instance for Cornell-class scenes, its
    chunk-scan instance (K6 vscan, K7 vquad) for larger ones (past
    MAX_PRIMS_SCAN primitives on a scene compiled with use_bvh), and on a
    use_bvh scene that opts in, the BVH walks (RTX_BVH_STACK=1: K11;
    RTX_LANE_BVH=1: K12, spheres only); the mode (kernel_mode) is read when
    the render packs the scene, once for all its passes;
  - "torch": `_render_pass`, the plain torch integrator sample by sample —
    the engine for the CPU, and on the card only when asked for by name.

Nothing falls back: a scene outside the kernel's gate, or a kernel that
fails to build or launch, raises.
The progressive renderer is not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import sys

import torch

from ..scene.schema import CameraConfig, Scene
from ..scene.flat import FlatScene
from ..scene.compile import compile_scene
from ..utils import rng
from ..ops.integrator import trace
from ..ops.wavefront_cuda import (kernel_gate_reason, pass_function,
                                  render_pass_compacted)
from . import camera as cam_mod


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device that is not there raises
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; ask for the CPU explicitly "
                           "(device='cpu', or --device cpu)")
    return dev


def default_tile_rows(width: int, height: int, n_prims: int) -> int:
    """Bound the (rays x prims) intersection table to ~32M entries."""
    budget = 32 * 1024 * 1024
    rows = max(1, budget // max(1, width * max(n_prims, 1)))
    return int(min(rows, height))


def _render_pass(scene: FlatScene, cam: cam_mod.CameraState, seed,
                 sample_start, *, width: int, height: int, tile_rows: int,
                 n_strata: int, max_depth: int, sky_gradient: bool,
                 n_samples: int) -> torch.Tensor:
    """Sum of `n_samples` consecutive stratified samples for the whole
    image by the plain torch integrator; (height, width, 3), not averaged.
    Rows past the image in the last tile render the last pixel's rays and
    are cropped."""
    _render_pass.calls += 1
    device = scene.device
    n_tiles = -(-height // tile_rows)
    out = torch.zeros(n_tiles * tile_rows * width, 3, dtype=torch.float32,
                      device=device)
    for tile in range(n_tiles):
        pix = torch.arange(tile * tile_rows * width,
                           (tile + 1) * tile_rows * width, device=device)
        pixc = torch.clamp(pix, max=width * height - 1)
        acc = torch.zeros(pix.shape[0], 3, dtype=torch.float32,
                          device=device)
        for k in range(n_samples):
            s = int(sample_start) + k
            keys = rng.ray_keys(seed, pixc, s)
            org, dr, tm = cam_mod.generate_rays(
                cam, width, pixc, torch.full_like(pixc, s), n_strata, keys)
            acc = acc + trace(scene, org, dr, tm, keys, cam.background,
                              max_depth=max_depth, sky_gradient=sky_gradient)
        out[pix] = acc
    return out.reshape(n_tiles * tile_rows, width, 3)[:height]


_render_pass.calls = 0


def pick_engine(flat: FlatScene, engine: str = "auto") -> str:
    """Resolve the compute path: "cuda" (the forward megakernel) or "torch"
    (the plain integrator).

    On a CUDA device "auto" is the kernel, and raises, as engine="cuda"
    does, for a scene outside kernel_gate_reason (more than 4 mediums or 32
    lights; past MAX_PRIMS_SCAN primitives without use_bvh, -b): the plain
    engine runs on the card only when engine="torch" asks for it. On the
    CPU "auto" is the plain engine (on a use_bvh scene through the BVH
    oracle, ops/bvh.py::closest_hit_bvh), and engine="cuda" raises."""
    on_cuda = flat.device.type == "cuda"
    if engine == "torch" or (engine == "auto" and not on_cuda):
        return "torch"
    if engine not in ("auto", "cuda"):
        raise ValueError(f"unknown engine {engine!r} (auto | cuda | torch)")
    if not on_cuda:
        raise ValueError(f"engine='cuda' needs a CUDA device; the scene "
                         f"is on {flat.device}")
    reason = kernel_gate_reason(flat)
    if reason is not None:
        raise ValueError(f"scene outside the CUDA kernel's gate: {reason}; "
                         f"engine='torch' (--engine torch) runs the plain "
                         f"torch engine on {flat.device}")
    return "cuda"


def render(scene: Scene | FlatScene, cfg: CameraConfig | None = None, *,
           device="cuda", seed: int = 0, use_bvh: bool = False,
           tile_rows: int | None = None, samples_per_batch: int = 4,
           spp: int | None = None, progress=None, engine: str = "auto",
           schedule: str = "auto", caps: tuple | None = None
           ) -> torch.Tensor:
    """Render a full image; returns (H, W, 3) linear float32 on `device`.

    Accepts a schema Scene (compiled here) or a FlatScene plus an explicit
    CameraConfig. engine: "auto" | "cuda" | "torch" (pick_engine).

    schedule (cuda engine only): "auto" | "single" | "compacted". "auto"
    takes the capped + lane-compacted schedule for passes of >= 8 samples.
    caps overrides the compacted schedule's per-phase iteration caps."""
    dev = resolve_device(device)
    if schedule not in ("auto", "single", "compacted"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if isinstance(scene, Scene):
        cfg = cfg or scene.camera
        flat = compile_scene(scene, use_bvh=use_bvh, device=dev)
    else:
        if cfg is None:
            raise ValueError("a FlatScene needs an explicit CameraConfig")
        flat = scene.to(dev)

    width, height = cam_mod.image_size(cfg)
    n_strata = cam_mod.sqrt_spp(
        cfg if spp is None else
        CameraConfig(**{**cfg.__dict__, "samples_per_pixel": spp}))
    total = n_strata * n_strata
    cam = cam_mod.derive(cfg, device=dev)
    eng = pick_engine(flat, engine)
    tr = tile_rows or default_tile_rows(width, height, flat.n_prims)
    if eng == "cuda" and progress is None:
        # lane regeneration amortizes dead-lane waste across samples: the
        # fewer passes, the better
        samples_per_batch = total

    common = dict(width=width, height=height, n_strata=n_strata,
                  max_depth=cfg.max_depth, sky_gradient=cfg.sky_gradient)
    # the kernel's tables and scalars are packed once for the whole render
    run_pass = pass_function(flat, cam) if eng == "cuda" else None
    acc = torch.zeros(height, width, 3, dtype=torch.float32, device=dev)
    caps_noted = False
    s = 0
    while s < total:
        k = min(samples_per_batch, total - s)
        if eng == "cuda":
            compacted = (schedule == "compacted"
                         or (schedule == "auto" and k >= 8))
            if caps is not None and not compacted and not caps_noted:
                print("[INFO] caps= ignored for single-pass batches "
                      f"(schedule={schedule!r}, {k} samples this pass)",
                      file=sys.stderr)
                caps_noted = True
            if compacted:
                acc = acc + render_pass_compacted(
                    flat, cam, seed, s, n_samples=k, caps=caps,
                    pass_fn=run_pass, **common)
            else:
                acc = acc + run_pass(flat, cam, seed, s, n_samples=k,
                                     **common)
        else:
            acc = acc + _render_pass(flat, cam, seed, s, tile_rows=tr,
                                     n_samples=k, **common)
        s += k
        if progress is not None:
            progress(s, total)
    return acc / total
