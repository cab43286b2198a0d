"""What the drivers share: the run's context, seed derivation, and the
reference's view of a cell's scene and pixels."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from reference import camera as ref_cam
from reference import scene as ref_scene


@dataclass
class Context:
    """One run of one cell. `shrink` replaces camera or mix settings (a
    tiny image for the CPU tests); the benchmark's runs leave it empty."""
    cell: object                  # harness.loader.Cell
    seed: int
    device: torch.device
    shrink: dict = field(default_factory=dict)


def derive(seed: int, i: int) -> int:
    """The i-th seed of a run (a SplitMix64 step, in [0, 2^31)): any
    whole --seed, however large, gives its own stream."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (i + 7) * 0xBF58476D1CE4E5B9) \
        % (1 << 64)
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) % (1 << 64)
    x ^= x >> 29
    return x % (1 << 31)


def cpu_generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(derive(seed, -1000) % (1 << 62))


def camera_of(scene, ctx: Context):
    """The scene's camera with the context's shrink applied."""
    keys = {f.name for f in dataclasses.fields(scene.camera)}
    cfg = dataclasses.replace(scene.camera, **{
        k: v for k, v in ctx.shrink.items() if k in keys})
    return cfg


def reference_scene(ctx: Context, **camera):
    """(flat, camera config) of the cell's scene file as the reference
    reads and compiles it, on the run's device; `camera` replaces camera
    settings."""
    sc = ref_scene.load_scene(str(ctx.cell.config_path))
    cfg = camera_of(sc, ctx)
    cfg = dataclasses.replace(cfg, **camera)
    return ref_scene.compile_scene(sc, device=ctx.device), cfg


def sample_pixels(n_pix: int, count: int, gen: torch.Generator):
    """`count` distinct pixel ids of [0, n_pix), drawn from gen."""
    return torch.randperm(n_pix, generator=gen)[:min(count, n_pix)]


def reference_pixels(flat, cfg, pix, samples, seed: int, device,
                     dtype=None):
    """The reference's mean radiance of pixels `pix` over `samples`, in
    float32 or (the control) in `dtype`."""
    from reference import render as ref_render
    cam = ref_cam.derive(cfg, device=device)
    if dtype is not None:
        flat, cam = flat.to(dtype=dtype), cam.to(dtype=dtype)
    w, _ = ref_cam.image_size(cfg)
    s = ref_render.pixel_sums(flat, cam, width=w, pix=pix.to(device),
                              samples=list(samples), seed=seed,
                              n_strata=ref_cam.sqrt_spp(cfg),
                              max_depth=cfg.max_depth,
                              sky_gradient=cfg.sky_gradient)
    return s / len(samples)
