"""Render drivers: the static (batch) render and progressive accumulation.

Port of the JAX package's models/render.py (reference StaticCamera.cpp:
25-131 and the accumulation core of DynamicCamera.cpp:105-175). `render`
compiles the scene, picks the engine and accumulates the image pass by
pass; `ProgressiveRenderer` packs the scene once and accumulates one
stratum (or k) a `step`, with camera moves that reset the image and the
accumulation buffer + sample counter as a checkpoint. Both run each pass
through `_pass_sum` on one of two engines:

  - "cuda": the forward megakernel (ops/wavefront_cuda.py), single pass or
    capped + compacted: its unrolled instance for Cornell-class scenes, its
    chunk-scan instance (K6 vscan, K7 vquad) for larger ones (past
    MAX_PRIMS_SCAN primitives on a scene compiled with use_bvh), and on a
    use_bvh scene that opts in, the BVH walks (RTX_BVH_STACK=1: K11;
    RTX_LANE_BVH=1: K12, spheres only); the mode (kernel_mode) is read when
    the scene is packed, once for all its passes;
  - "torch": `_render_pass`, the plain torch integrator sample by sample —
    the engine for the CPU, and on the card only when asked for by name.

Nothing falls back: a scene outside the kernel's gate, or a kernel that
fails to build or launch, raises (out of `ProgressiveRenderer.step` too,
with the accumulated state unchanged).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import sys

import numpy as np
import torch

from ..scene.schema import CameraConfig, Scene
from ..scene.flat import FlatScene
from ..scene.compile import compile_scene, golden_json
from ..utils import rng
from ..utils.profiling import recording, spanned
from ..utils.color import to_bytes
from ..ops.integrator import trace
from ..ops.wavefront_cuda import (kernel_gate_reason, pass_function,
                                  prepare_kernel, render_pass_compacted,
                                  with_camera)
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
                 n_samples: int, row0: int = 0) -> torch.Tensor:
    """Sum of `n_samples` consecutive stratified samples for the whole
    image by the plain torch integrator; (height, width, 3), not averaged.
    Rows past the image in the last tile render the last pixel's rays and
    are cropped. row0 > 0 renders rows [row0, row0 + height) of an image
    `width` wide (a tile shard, parallel/mesh.py): the pixel ids that key
    the draws and place the rays are absolute, as the kernels' are. While
    a profiler records, the bounces of the image's paths are added to
    _render_pass.bounces."""
    _render_pass.calls += 1
    count = recording()
    device = scene.device
    n_tiles = -(-height // tile_rows)
    out = torch.zeros(n_tiles * tile_rows * width, 3, dtype=torch.float32,
                      device=device)
    for tile in range(n_tiles):
        pix = torch.arange(tile * tile_rows * width,
                           (tile + 1) * tile_rows * width, device=device)
        pixc = torch.clamp(pix, max=width * height - 1) + row0 * width
        acc = torch.zeros(pix.shape[0], 3, dtype=torch.float32,
                          device=device)
        for k in range(n_samples):
            s = int(sample_start) + k
            keys = rng.ray_keys(seed, pixc, s)
            org, dr, tm = cam_mod.generate_rays(
                cam, width, pixc, torch.full_like(pixc, s), n_strata, keys)
            rad = trace(scene, org, dr, tm, keys, cam.background,
                        max_depth=max_depth, sky_gradient=sky_gradient,
                        return_lengths=count)
            if count:
                rad, length = rad
                _render_pass.bounces = _render_pass.bounces + length[
                    pix < width * height].to(torch.int64).sum()
            acc = acc + rad
        out[pix] = acc
    return out.reshape(n_tiles * tile_rows, width, 3)[:height]


_render_pass.calls = 0
# the image's bounces traced while a profiler records (utils/profiling.py):
# a device-side total, as the kernel's render_pass_kernel.bounces is
_render_pass.bounces = 0


def pick_engine(flat: FlatScene, engine: str = "auto",
                device=None) -> str:
    """Resolve the compute path on `device` (None: the scene's): "cuda"
    (the forward megakernel) or "torch" (the plain integrator).

    On a CUDA device "auto" is the kernel, and raises, as engine="cuda"
    does, for a scene outside kernel_gate_reason (more than 4 mediums or 32
    lights; past MAX_PRIMS_SCAN primitives without use_bvh, -b): the plain
    engine runs on the card only when engine="torch" asks for it. On the
    CPU "auto" is the plain engine (on a use_bvh scene through the BVH
    oracle, ops/bvh.py::closest_hit_bvh), and engine="cuda" raises."""
    dev = flat.device if device is None else torch.device(device)
    on_cuda = dev.type == "cuda"
    if engine == "torch" or (engine == "auto" and not on_cuda):
        return "torch"
    if engine not in ("auto", "cuda"):
        raise ValueError(f"unknown engine {engine!r} (auto | cuda | torch)")
    if not on_cuda:
        raise ValueError(f"engine='cuda' needs a CUDA device; the scene "
                         f"is on {dev}")
    reason = kernel_gate_reason(flat)
    if reason is not None:
        raise ValueError(f"scene outside the CUDA kernel's gate: {reason}; "
                         f"engine='torch' (--engine torch) runs the plain "
                         f"torch engine on {dev}")
    return "cuda"


def _compacted(schedule: str, k: int) -> bool:
    """Whether a kernel pass of k samples takes the capped + compacted
    schedule: "auto" from 8 samples on (lane regeneration amortizes
    dead-lane waste across samples), else as `schedule` says."""
    return schedule == "compacted" or (schedule == "auto" and k >= 8)


def _pass_sum(eng: str, flat: FlatScene, cam: cam_mod.CameraState,
              run_pass, seed, sample_start: int, k: int, *, schedule: str,
              caps, tile_rows: int, **common) -> torch.Tensor:
    """Radiance sum of samples [sample_start, sample_start + k) over the
    whole image, (height, width, 3): on the kernel ("cuda") run_pass (the
    scene packed once, pass_function) as one pass or under the compacted
    schedule (_compacted), on the plain engine ("torch") _render_pass in
    tiles of tile_rows rows. The one pass body of render,
    ProgressiveRenderer.step and a mesh shard (parallel/mesh.py::
    render_shard, which passes its row0 in `common`)."""
    if eng != "cuda":
        return _render_pass(flat, cam, seed, sample_start,
                            tile_rows=tile_rows, n_samples=k, **common)
    if _compacted(schedule, k):
        return render_pass_compacted(flat, cam, seed, sample_start,
                                     n_samples=k, caps=caps,
                                     pass_fn=run_pass, **common)
    return run_pass(flat, cam, seed, sample_start, n_samples=k, **common)


@spanned("rt.render")
def render(scene: Scene | FlatScene, cfg: CameraConfig | None = None, *,
           device="cuda", seed: int = 0, use_bvh: bool = False,
           tile_rows: int | None = None, samples_per_batch: int = 4,
           spp: int | None = None, progress=None, engine: str = "auto",
           schedule: str = "auto", caps: tuple | None = None
           ) -> torch.Tensor:
    """Render a full image; returns (H, W, 3) linear float32 on `device`.

    Accepts a schema Scene (compiled here, on the host) or a FlatScene plus
    an explicit CameraConfig. engine: "auto" | "cuda" | "torch"
    (pick_engine). On the kernel, a scene on the host is packed there and
    sent to the card in one copy, and one on the card is packed there
    (prepare_kernel); the plain engine moves the scene to `device`.

    schedule (cuda engine only): "auto" | "single" | "compacted". "auto"
    takes the capped + lane-compacted schedule for passes of >= 8 samples.
    caps overrides the compacted schedule's per-phase iteration caps."""
    dev = resolve_device(device)
    if schedule not in ("auto", "single", "compacted"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if isinstance(scene, Scene):
        cfg = cfg or scene.camera
        flat = compile_scene(scene, use_bvh=use_bvh)
    else:
        if cfg is None:
            raise ValueError("a FlatScene needs an explicit CameraConfig")
        flat = scene
    eng = pick_engine(flat, engine, dev)
    if eng != "cuda" or flat.device.type != "cpu":
        flat = flat.to(dev)

    width, height = cam_mod.image_size(cfg)
    n_strata = cam_mod.sqrt_spp(
        cfg if spp is None else
        CameraConfig(**{**cfg.__dict__, "samples_per_pixel": spp}))
    total = n_strata * n_strata
    # beside the scene: on the host, the packing takes its floats there
    cam = cam_mod.derive(cfg, device=flat.device)
    tr = tile_rows or default_tile_rows(width, height, flat.n_prims)
    if eng == "cuda" and progress is None:
        # lane regeneration amortizes dead-lane waste across samples: the
        # fewer passes, the better
        samples_per_batch = total

    common = dict(width=width, height=height, n_strata=n_strata,
                  max_depth=cfg.max_depth, sky_gradient=cfg.sky_gradient)
    # the kernel's tables and scalars are packed once for the whole render
    run_pass = (pass_function(flat, cam, prepare_kernel(flat, cam,
                                                        device=dev))
                if eng == "cuda" else None)
    acc = torch.zeros(height, width, 3, dtype=torch.float32, device=dev)
    caps_noted = False
    s = 0
    while s < total:
        k = min(samples_per_batch, total - s)
        if (eng == "cuda" and caps is not None and not caps_noted
                and not _compacted(schedule, k)):
            print("[INFO] caps= ignored for single-pass batches "
                  f"(schedule={schedule!r}, {k} samples this pass)",
                  file=sys.stderr)
            caps_noted = True
        acc = acc + _pass_sum(eng, flat, cam, run_pass, seed, s, k,
                              schedule=schedule, caps=caps, tile_rows=tr,
                              **common)
        s += k
        if progress is not None:
            progress(s, total)
    return acc / total


class CheckpointMismatch(ValueError):
    """A checkpoint that ProgressiveRenderer.load (or a shard checkpoint,
    parallel/distributed.py::load_progressive_shard) refuses: of another
    scene, image shape, depth or sample count, or without a fingerprint."""


def scene_fingerprint(flat: FlatScene, width: int, height: int,
                      max_depth: int, sky_gradient: bool) -> str:
    """sha256 of the compiled scene (golden_json) with the image's width,
    height, max_depth and sky_gradient: what an accumulation was rendered
    against, the camera aside."""
    h = hashlib.sha256(golden_json(flat).encode())
    h.update(json.dumps([width, height, max_depth,
                         bool(sky_gradient)]).encode())
    return h.hexdigest()


def _camera_from_json(text: str) -> CameraConfig:
    """CameraConfig from json.dumps(dataclasses.asdict(cfg)), vectors as
    tuples (the scene JSON's rule, scene/schema.py::scene_from_json)."""
    return CameraConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in json.loads(text).items()})


class ProgressiveRenderer:
    """Progressive accumulation with camera motion and checkpoints.

    DynamicCamera's loop state (DynamicCamera.cpp:105-175): an accumulation
    buffer and samples_taken, one stratum a step, reset on a camera move
    (:271-277) or a change of samples per pixel (:239-252). The scene is
    compiled and packed for the kernel once; a move re-derives the camera
    and swaps only its fields in the packing (wavefront_cuda.with_camera).
    Every pass runs through `_pass_sum`, render's pass body, with
    sample_start = samples_taken, so a run of steps of k samples equals
    render(..., samples_per_batch=k, progress=...) at the same camera bit
    for bit. A pass
    that fails to build or launch raises out of `step` and leaves the
    state as it was; nothing falls back to the plain engine.

    save/load write the JAX package's checkpoint keys (acc, samples_taken,
    seed, n_strata) with a fingerprint of the scene and image settings and
    the camera at save time; load refuses another scene, image shape,
    depth or sample count, and restores the saved camera."""

    def __init__(self, scene: Scene, *, device="cuda", use_bvh: bool = False,
                 seed: int = 0, tile_rows: int | None = None,
                 engine: str = "auto"):
        self.device = resolve_device(device)
        self.cfg = scene.camera
        self.flat = compile_scene(scene, use_bvh=use_bvh, device=self.device)
        self.seed = seed
        self.width, self.height = cam_mod.image_size(self.cfg)
        self.n_strata = cam_mod.sqrt_spp(self.cfg)
        self.tile_rows = tile_rows or default_tile_rows(
            self.width, self.height, self.flat.n_prims)
        self.engine = pick_engine(self.flat, engine)
        self._prepared = None
        self._fingerprint = None
        self._set_camera(self.cfg)
        self.reset()

    # ------------------------------------------------------------ state
    def reset(self):
        self.acc = torch.zeros(self.height, self.width, 3,
                               dtype=torch.float32, device=self.device)
        self.samples_taken = 0

    @property
    def converged(self) -> bool:
        return self.samples_taken >= self.n_strata * self.n_strata

    @spanned("rt.frame.step")
    def step(self, k: int = 1) -> bool:
        """Accumulate k strata (clamped to what remains) in one pass;
        False once converged. k >= 8 takes the compacted schedule on the
        kernel, as render's batches do; the adaptive viewer raises k when
        the frame rate allows (the reference's FPS-keyed tile resizing,
        DynamicCamera.cpp:190-193)."""
        if self.converged:
            return False
        k = max(1, min(int(k), self.n_strata * self.n_strata
                       - self.samples_taken))
        self.acc = self.acc + _pass_sum(
            self.engine, self.flat, self.cam, self._run_pass, self.seed,
            self.samples_taken, k, schedule="auto", caps=None,
            tile_rows=self.tile_rows, width=self.width, height=self.height,
            n_strata=self.n_strata, max_depth=self.cfg.max_depth,
            sky_gradient=self.cfg.sky_gradient)
        self.samples_taken += k
        return True

    @spanned("rt.frame.image")
    def image(self) -> torch.Tensor:
        return self.acc / max(1, self.samples_taken)

    def preview(self, cols: int, rows: int) -> np.ndarray:
        """(rows, cols, 3) uint8 frame for a terminal, made on the device:
        nearest-row and nearest-column select of the accumulation, then the
        gamma/clamp byte rule (utils/color.to_bytes). Only rows x cols x 3
        bytes reach the host, never the float image. Selection commutes
        with the per-pixel byte rule, so the frame equals
        viewer._downsample(to_bytes(image()), cols, rows)."""
        h, w = self.height, self.width
        yi = torch.clamp(torch.arange(rows, device=self.device) * h // rows,
                         max=h - 1)
        xi = torch.clamp(torch.arange(cols, device=self.device) * w // cols,
                         max=w - 1)
        return to_bytes(self.acc[yi[:, None], xi[None, :]]
                        / max(1, self.samples_taken))

    # ----------------------------------------------------- camera motion
    @spanned("rt.frame.camera")
    def _set_camera(self, cfg: CameraConfig):
        """Derive `cfg`'s camera on the device and, on the kernel, swap its
        fields into the packing (packed here the first time)."""
        self.cfg = cfg
        self.cam = cam_mod.derive(cfg, device=self.device)
        if self.engine != "cuda":
            self._run_pass = None
            return
        self._prepared = (prepare_kernel(self.flat, self.cam)
                          if self._prepared is None
                          else with_camera(self._prepared, self.cam))
        self._run_pass = pass_function(self.flat, self.cam, self._prepared)

    def move_camera(self, delta):
        """Translate lookfrom and lookat by delta (DynamicCamera's WASD,
        DynamicCamera.cpp:204-278) and reset the accumulation."""
        d = tuple(float(x) for x in delta)
        c = self.cfg
        self._set_camera(dataclasses.replace(
            c, lookfrom=tuple(a + b for a, b in zip(c.lookfrom, d)),
            lookat=tuple(a + b for a, b in zip(c.lookat, d))))
        self.reset()

    def set_spp(self, spp: int):
        """+/- samples control (DynamicCamera.cpp:239-252); resets."""
        self.cfg = dataclasses.replace(self.cfg, samples_per_pixel=spp)
        self.n_strata = cam_mod.sqrt_spp(self.cfg)
        self.reset()

    # ------------------------------------------------------- checkpoint
    def fingerprint(self) -> str:
        """scene_fingerprint of the renderer's scene and image settings:
        what a checkpoint's accumulation was rendered against."""
        if self._fingerprint is None:
            self._fingerprint = scene_fingerprint(
                self.flat, self.width, self.height, self.cfg.max_depth,
                self.cfg.sky_gradient)
        return self._fingerprint

    def _settings(self) -> dict:
        return {"n_strata": self.n_strata, "width": self.width,
                "height": self.height, "max_depth": self.cfg.max_depth,
                "sky_gradient": bool(self.cfg.sky_gradient)}

    def restore(self, acc, samples_taken: int, seed: int,
                cfg: CameraConfig | None = None):
        """Take over an accumulation of this scene: acc (height, width, 3)
        float32, the radiance sum of samples_taken strata drawn under
        `seed` at the camera `cfg` (None: the renderer's own)."""
        acc = torch.from_numpy(np.array(acc))
        if tuple(acc.shape) != (self.height, self.width, 3) \
                or acc.dtype != torch.float32:
            raise ValueError(f"acc: {tuple(acc.shape)} {acc.dtype}, this "
                             f"renderer accumulates ({self.height}, "
                             f"{self.width}, 3) float32")
        total = self.n_strata * self.n_strata
        if not 0 <= int(samples_taken) <= total:
            raise ValueError(f"samples_taken: {int(samples_taken)} outside "
                             f"[0, {total}]")
        if cfg is not None:
            self._set_camera(cfg)
        self.acc = acc.to(self.device)
        self.samples_taken = int(samples_taken)
        self.seed = int(seed)

    def save(self, path: str):
        np.savez(path, acc=self.acc.cpu().numpy(),
                 samples_taken=self.samples_taken, seed=self.seed,
                 fingerprint=self.fingerprint(),
                 camera=json.dumps(dataclasses.asdict(self.cfg)),
                 **self._settings())

    def load(self, path: str):
        """Resume from save(path). Raises CheckpointMismatch (a ValueError)
        naming the field when the checkpoint is of another scene or image
        shape, depth or sample count, or has no fingerprint; restores the
        saved camera."""
        with np.load(path) as d:
            if "fingerprint" not in d or "camera" not in d:
                raise CheckpointMismatch(
                    f"{path}: no fingerprint (a checkpoint without one "
                    "cannot be matched to a scene)")
            for name, want in self._settings().items():
                got = d[name].item() if name in d else None
                if got != want:
                    raise CheckpointMismatch(f"{path}: {name} is {got}, "
                                             f"this renderer's is {want}")
            if str(d["fingerprint"]) != self.fingerprint():
                raise CheckpointMismatch(
                    f"{path}: fingerprint of another scene (its compiled "
                    "tables differ)")
            self.restore(d["acc"], int(d["samples_taken"]), int(d["seed"]),
                         _camera_from_json(str(d["camera"])))
