"""Profiling: the rays/s meter, torch.profiler traces, an fp32 roofline and
the schedule replays.

Port of the JAX package's utils/profiling.py. The reference's only
instrumentation is a per-scanline progress log (StaticCamera.cpp:63-65)
and a once-per-second FPS overlay that doubles as the adaptive-tile control
signal (DynamicCamera.cpp:182-194). SURVEY.md §5 asks for more: profiler
traces, a rays/s meter derived from (W*H*spp*avg_depth)/wall and a
roofline comparison. Here:

  - the roofline's peak is the card's float32 rate outside the tensor
    cores (_PEAK_FP32_FLOPS, keyed by a prefix of the CUDA device's name);
  - the operations of a bounce come from the kernels' source, counted by
    hand (OPS_*, bounce_ops and the rest: the bounds chip_smoke.py prints
    for every kernel), or from the plain trace's aten ops
    (measured_ops_per_bounce);
  - profiler_trace is torch.profiler around a block, writing a chrome
    trace; device_busy reads the card's busy share out of one;
  - the replays (wavefront_utilization, schedule_utilization) model the
    JAX kernel's tiles on per-path lengths from the plain trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from . import rng

# The float32 rate of one NVIDIA H100 SXM outside the tensor cores, FMA
# counted as two operations (NVIDIA's data sheet, at the 700 W limit). The
# kernels are built --fmad=false, so they can reach half of it.
PEAK_FP32 = 67e12
# peak float32 operations/s by a prefix of torch.cuda.get_device_name()
_PEAK_FP32_FLOPS = {
    "NVIDIA H100 80GB HBM3": PEAK_FP32,
}

# Fallback cost of one wavefront bounce per ray lane, in float32 op
# equivalents (the JAX package's anchor). Prefer bounce_ops (the kernels'
# source, counted) or measured_ops_per_bounce (the plain trace, counted).
DEFAULT_OPS_PER_BOUNCE = 1200.0

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
# the weight planes a bounce must update at the least: the scattering hit's
# own eff row (3 planes). A path's other rows hold nonzero planes only
# where it scattered on them before (1.14 and 1.63 rows at a scatter on
# K3v's two scenes, PERF.md), and a radiance event's reads are left out: a
# lower bound of the tex_color gradient's work, whatever the tier
OPS_PLANES_BOUNCE = 3 * OPS_PLANE
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
# the suffix tier (K8): a forward bounce (vscan_bounce_ops) and the routes
# of its hit's events: per channel the suffix T - P, |at| against 1e-8,
# the division, the emission select, the sum, the cotangent product and the
# accumulator add (7), and the path total's add. The JAX kernel's phase B,
# which replays each bounce to learn P, is not work the function needs (the
# kernel keeps P from its one trace)
OPS_ROUTE = 3 * 8
# the adjoint (K9): phase F is a forward bounce (vscan_bounce_ops); phase R
# draws the bounce's numbers again (OPS_RNG) and pushes the cotangents back
# through what the bounce differentiates, the winner's root, its hit
# record, the shading and the light pdf and sample, at two operations for
# each forward one (a product's adjoint is two products), and adds the
# parameter rows' cotangents (OPS_ADJ_ROWS: tex_color 3, the winner
# sphere's 4, a fuzz or IOR, with their routing). The second phase's
# selection is left out: the winner is stored in phase F, not re-derived.
OPS_ADJ_ROWS = 16


def light_ops(flat) -> float:
    """Every light's pdf, and half the bounces one light's sample."""
    kinds = ["sphere" if bool(x) else "quad" for x in
             (flat.light_prim[:flat.n_lights]
              < flat.sph_center.shape[0]).tolist()]
    if not kinds:
        return 0.0
    return (sum(OPS_LIGHT_PDF[k] for k in kinds)
            + 0.5 * sum(OPS_LIGHT_SAMPLE[k] for k in kinds) / len(kinds))


def bounce_ops(flat, grad: bool = False, n_slots: int = 0) -> float:
    """Operations of one Lambertian bounce on `flat`, with the weight
    planes (grad) and n_slots hard-slot evaluations (see OPS_*)."""
    ops = (OPS_RNG + OPS_HIT + OPS_SHADE
           + OPS_SPHERE * int(flat.sph_active.sum())
           + OPS_QUAD * int(flat.quad_active.sum()) + light_ops(flat))
    if grad:
        ops += OPS_PLANES_BOUNCE
    return float(ops + OPS_SLOT * n_slots)


def vscan_bounce_ops(flat) -> float:
    """Operations of one Lambertian bounce on a large scene, its
    intersection counted as a BVH descent (OPS_BOX): a lower bound."""
    n_sph = int(flat.sph_active.sum())
    n = n_sph + int(flat.quad_active.sum())
    prim = OPS_SPHERE if n_sph else OPS_QUAD
    return float(OPS_RNG + OPS_HIT + OPS_SHADE + light_ops(flat)
                 + 2 * math.ceil(math.log2(max(n, 2))) * OPS_BOX + 2 * prim)


def adjoint_bounce_ops(flat) -> float:
    """Operations of one bounce of the adjoint (K9) on a large scene, phase
    F and phase R (see OPS_ADJ_ROWS): a lower bound."""
    shade = OPS_HIT + OPS_SHADE + light_ops(flat) + OPS_SPHERE
    return vscan_bounce_ops(flat) + OPS_RNG + 2 * shade + OPS_ADJ_ROWS


def bound_ms(flat, grad: bool, bounces: int, n_slots: int = 0) -> float:
    """The least time an H100 could take for `bounces` bounces: operations
    over PEAK_FP32. Bytes are negligible beside it (a few floats per lane,
    tables in shared memory)."""
    return bounce_ops(flat, grad, n_slots) * bounces / PEAK_FP32 * 1e3


def vscan_bound_ms(flat, bounces: int) -> float:
    """bound_ms for the chunk scan's forward (vscan_bounce_ops). Bytes stay
    negligible: the tables (under 1 MB) are read once into L2."""
    return vscan_bounce_ops(flat) * bounces / PEAK_FP32 * 1e3


class _OpCount(TorchDispatchMode):
    """Counts the arithmetic of the aten ops run under it (see
    measured_ops_per_bounce)."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.Tag.pointwise in func.tags:
            self.ops += sum(t.numel() for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor))
        elif torch.Tag.reduction in func.tags:
            self.ops += next(t.numel() for t in tree_leaves(args)
                             if isinstance(t, torch.Tensor))
        return out


def measured_ops_per_bounce(flat, cam_cfg, *, width=64, max_depth=8,
                            seed=0) -> float | None:
    """Arithmetic operations per wavefront bounce iteration of the plain
    trace (ops/integrator.py), counted on the device of `flat`.

    The rays are one sample of a `width`-pixel-wide image of cam_cfg's
    camera (the JAX package's version reads cam_cfg's own width). Torch
    has no cost model of an eager function (the JAX package reads XLA's
    cost_analysis()["flops"]), so the aten ops the trace runs are counted
    under a TorchDispatchMode: an op tagged pointwise (arithmetic,
    comparisons, selects, bitwise and logical ops, casts of values such as
    floor, transcendental functions) counts one operation an element of
    its output, an op tagged reduction (sum, any, amin, argmin, ...) one
    an element of its input, and nothing else counts (indexing, gathers,
    copies, dtype conversions, views, allocation). The count is divided by
    the rays times the bounce iterations the loop ran: it stops once every
    path has ended, so that is the longest path's length, not max_depth.
    Returns None where nothing was counted."""
    from ..models import camera as cam_mod
    from ..ops.integrator import trace

    cfg = dataclasses.replace(cam_cfg, image_width=width)
    dev = flat.device
    cam = cam_mod.derive(cfg, device=dev)
    w, h = cam_mod.image_size(cfg)
    pix = torch.arange(w * h, device=dev)
    keys = rng.ray_keys(seed, pix, 0)
    org, dr, tm = cam_mod.generate_rays(cam, w, pix, 0, 1, keys)
    kw = dict(max_depth=max_depth, sky_gradient=cfg.sky_gradient)
    _, length = trace(flat, org, dr, tm, keys, cam.background,
                      return_lengths=True, **kw)
    iters = int(length.max())
    with _OpCount() as count:
        trace(flat, org, dr, tm, keys, cam.background, **kw)
    if count.ops == 0 or iters == 0:
        return None
    return count.ops / (w * h * iters)


@dataclasses.dataclass
class RenderStats:
    """Throughput report for one render (or bench rep)."""
    width: int
    height: int
    spp: int
    wall_s: float
    avg_depth: float = 6.0          # mean path length, not max_depth
    device_kind: str = ""

    @property
    def paths(self) -> int:
        return self.width * self.height * self.spp

    @property
    def paths_per_s(self) -> float:
        return self.paths / self.wall_s

    @property
    def rays_per_s(self) -> float:
        """Bounce rays per second: paths * average bounce count / wall."""
        return self.paths * self.avg_depth / self.wall_s

    def roofline_fraction(self,
                          ops_per_bounce: float = DEFAULT_OPS_PER_BOUNCE
                          ) -> float | None:
        """Fraction of the card's float32 peak this render achieved, given
        the per-bounce op cost model. None when the device is unknown."""
        peak = None
        for k, v in _PEAK_FP32_FLOPS.items():
            if self.device_kind.startswith(k):
                peak = v
                break
        if peak is None:
            return None
        return self.rays_per_s * ops_per_bounce / peak

    def report(self) -> str:
        lines = [
            f"{self.width}x{self.height} @ {self.spp}spp in "
            f"{self.wall_s:.3f}s",
            f"  {self.paths_per_s / 1e6:.2f} Mpaths/s, "
            f"{self.rays_per_s / 1e6:.2f} Mrays/s "
            f"(avg depth {self.avg_depth:.1f})",
        ]
        frac = self.roofline_fraction()
        if frac is not None:
            lines.append(f"  ~{100 * frac:.1f}% of {self.device_kind} "
                         f"fp32 roofline")
        return "\n".join(lines)


def device_kind() -> str:
    """The CUDA device's name, or "cpu" without one."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(stats_kwargs: dict):
    """Context manager yielding a RenderStats filled with wall time:

        with timed(dict(width=w, height=h, spp=s)) as get:
            render(...)
        print(get().report())

    With a CUDA device the card is synchronised before the clock starts and
    after the block, so the wall holds the block's device work, not only
    its launches."""
    box = {}
    _sync()
    t0 = time.perf_counter()

    def get() -> RenderStats:
        return box["stats"]

    yield get
    _sync()
    box["stats"] = RenderStats(wall_s=time.perf_counter() - t0,
                               device_kind=device_kind(), **stats_kwargs)


@dataclasses.dataclass
class Trace:
    """What profiler_trace yields: the running torch.profiler.profile, and
    once the block has ended, the chrome trace's path."""
    profile: torch.profiler.profile
    path: str | None = None


@contextlib.contextmanager
def profiler_trace(log_dir: str = "logs/torch_trace"):
    """torch.profiler around a render: CPU activity, and the CUDA device's
    (its kernels and copies, through CUPTI) whenever CUDA is available. On
    exit the chrome trace is written into log_dir (open it in Perfetto or
    chrome://tracing; device_busy reads it)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    out = Trace(torch.profiler.profile(activities=acts))
    try:
        with out.profile:
            yield out
    finally:
        out.path = os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        out.profile.export_chrome_trace(out.path)


def device_busy(path: str) -> dict:
    """The device's busy share of a chrome trace written by profiler_trace:
    the union of its kernels' intervals over the traced window (from the
    trace's first complete event to the end of its last, host events
    included), with each kernel's summed time and launches by name. A
    trace with no kernel event (the CPU's) is busy 0."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events if e.get("cat") == "kernel")
    busy_us, end = 0.0, -math.inf
    by_name = {}
    for t0, t1, name in kernels:
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        k = by_name.setdefault(name, {"ms": 0.0, "launches": 0})
        k["ms"] += (t1 - t0) / 1e3
        k["launches"] += 1
    window_us = (max(float(e["ts"]) + float(e["dur"]) for e in events)
                 - min(float(e["ts"]) for e in events)) if events else 0.0
    return {"window_ms": window_us / 1e3, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / window_us if window_us > 0 else 0.0,
            "kernels": by_name}


def _scene_flat(flat, cam_cfg, scene, width, device):
    """(flat, cam_cfg), compiling `scene` at `width` on `device` where it
    is given (the JAX package's replays set its camera's width too)."""
    if scene is None:
        return flat, cam_cfg
    from ..models.render import resolve_device
    from ..scene.compile import compile_scene
    scene.camera.image_width = width
    return (compile_scene(scene, device=resolve_device(device)),
            scene.camera)


def path_lengths(flat, cam_cfg, *, n_samples=16, max_depth=50, seed=0):
    """(n_samples, n_pix) float64 path lengths of samples 0..n_samples-1
    of every pixel of cam_cfg's image: the plain trace's return_lengths on
    the device of `flat`, from the streams a kernel pass of n_samples
    draws (seed, pixel, sample), so that each pixel's sum is the bounces
    the pass traces for it. The replays trace them where they are not
    given (lengths=); one trace serves replays of several schedules."""
    from ..models import camera as cam_mod
    from ..ops.integrator import trace

    dev = flat.device
    cam = cam_mod.derive(cam_cfg, device=dev)
    w, h = cam_mod.image_size(cam_cfg)
    n_strata = max(1, int(np.sqrt(n_samples)))
    pix = torch.arange(w * h, device=dev)
    L = np.zeros((n_samples, w * h), np.float64)
    for s in range(n_samples):
        keys = rng.ray_keys(seed, pix, s)
        org, dr, tm = cam_mod.generate_rays(cam, w, pix, s, n_strata, keys)
        _, ln = trace(flat, org, dr, tm, keys, cam.background,
                      max_depth=max_depth,
                      sky_gradient=getattr(cam_cfg, "sky_gradient", False),
                      return_lengths=True)
        L[s] = ln.cpu().numpy()
    return L


def _replay_lengths(flat, cam_cfg, lengths, n_samples, max_depth, seed):
    """(lengths, width, height): the given lengths, checked against the
    image and sample count, or path_lengths traced here."""
    from ..models import camera as cam_mod
    w, h = cam_mod.image_size(cam_cfg)
    if lengths is None:
        lengths = path_lengths(flat, cam_cfg, n_samples=n_samples,
                               max_depth=max_depth, seed=seed)
    elif np.shape(lengths) != (n_samples, w * h):
        raise ValueError(f"lengths of shape {np.shape(lengths)}; this "
                         f"replay needs ({n_samples}, {w * h})")
    return np.asarray(lengths, np.float64), w, h


def wavefront_utilization(flat, cam_cfg=None, *, scene=None, width=128,
                          n_samples=16, max_depth=50, rows_per_tile=None,
                          seed=0, device="cuda", lengths=None):
    """Lane-occupancy analysis of the JAX kernel's persistent-wavefront
    schedule (ROADMAP ray-sorting/compaction lever).

    That megakernel regenerates a dead lane on its pixel's next stratified
    sample, so a lane is busy for sum_s L(pixel, sample_s) bounce iterations
    (L = path length) and a TILE of rows_per_tile x 128 lanes runs until
    its slowest lane finishes. Utilization = total productive
    lane-iterations / total lane-iterations executed = mean(lane_work) /
    mean-over-tiles(max(lane_work)), computed exactly from per-path lengths
    traced by the plain integrator (ops/integrator.py::trace(return_lengths
    =True), the kernels' RNG streams) on the device of `flat` (with
    `scene`: compiled on `device`), or given as `lengths` (path_lengths of
    the same arguments). The port's forward (K1) is not tiled
    so: its persistent threads take lane slots from a counter as they
    finish, so its tail is the last slots' work, not each tile's maximum;
    this replays the JAX schedule, as the JAX package's does.

    Returns dict(utilization, mean_path_len, tail_fraction, ...)."""
    flat, cam_cfg = _scene_flat(flat, cam_cfg, scene, width, device)
    L, w, h = _replay_lengths(flat, cam_cfg, lengths, n_samples, max_depth,
                              seed)
    lane_work = L.sum(axis=0)

    if rows_per_tile is None:
        rows_per_tile = 32 if flat.n_prims <= 64 else 16
    lanes = rows_per_tile * 128

    def util_of(order):
        """Exact schedule utilization for pixel->lane assignment `order`."""
        work = lane_work[order] if order is not None else lane_work
        pad = (-work.size) % lanes
        tiles = np.pad(work, (0, pad)).reshape(-1, lanes)
        per_tile = tiles.max(axis=1)     # a tile runs to its slowest lane
        return (float(work.sum() / max(per_tile.sum() * lanes, 1.0)),
                float(per_tile.mean()))

    n_pix = w * h
    utilization, mean_iters = util_of(None)
    # candidate re-assignments: stride-permuted interleave (spread image
    # regions across each tile) and the oracle upper bound (lanes sorted
    # by total work, the assignment that minimizes sum-of-tile-maxima)
    n_tiles = -(-n_pix // lanes)
    stride_order = np.argsort(np.arange(n_pix) % n_tiles, kind="stable")
    util_stride, _ = util_of(stride_order)
    util_sorted, _ = util_of(np.argsort(lane_work, kind="stable"))
    return dict(
        utilization=utilization,
        utilization_stride=util_stride,
        utilization_sorted=util_sorted,
        mean_path_len=float(lane_work.sum() / (n_pix * n_samples)),
        mean_tile_iters=mean_iters,
        tail_fraction=float(1.0 - utilization),
        rows_per_tile=rows_per_tile, n_samples=n_samples,
        max_depth=max_depth, width=w, height=h)


def schedule_utilization(flat=None, cam_cfg=None, *, scene=None, width=128,
                         n_samples=16, max_depth=50, rows_per_tile=16,
                         caps=(), key="samples", seed=0, device="cuda",
                         lengths=None):
    """Exact replay of the capped + compacted schedule
    (ops/wavefront_cuda.py::render_pass_compacted, the JAX package's
    render_pass_pallas_compacted) on the plain trace's per-(pixel, sample)
    path lengths, in the JAX kernel's tiles of rows_per_tile x 128 lanes
    that each run to their slowest lane (see wavefront_utilization: the
    port's K1 is not tiled so); `lengths` as there. This is the tool that
    selected the JAX package's cap schedules, which default_caps carries
    over.

    Phases run `caps` bounce-iteration caps, re-sorting lanes between
    phases by `key`:
      "samples" - remaining-sample count, the only quantity the real
        schedule can know (sample streams are stochastic);
      "oracle"  - exact remaining work, the unreachable upper bound.

    Returns dict(utilization, per-phase iters, mean_path_len, ...)."""
    flat, cam_cfg = _scene_flat(flat, cam_cfg, scene, width, device)
    L, w, h = _replay_lengths(flat, cam_cfg, lengths, n_samples, max_depth,
                              seed)
    lanes = rows_per_tile * 128
    n_pix = w * h
    work = L.sum(axis=0)
    pad = (-n_pix) % lanes
    rem = np.pad(work, (0, pad))
    cum = np.pad(np.cumsum(L, axis=0), ((0, 0), (0, pad)),
                 constant_values=0.0)
    w0 = rem.copy()
    total = 0.0
    phase_iters = []
    for cap in caps:
        tiles = rem.reshape(-1, lanes)
        iters = np.minimum(tiles.max(axis=1), cap)
        total += iters.sum() * lanes
        phase_iters.append(float(iters.mean()))
        rem = np.maximum(rem - cap, 0.0)
        consumed = w0 - rem
        if key == "oracle":
            k = np.where(rem > 0, rem, -1.0)
        else:
            s_done = (cum <= consumed[None, :] + 1e-9).sum(axis=0)
            k = np.where(rem > 0, (n_samples - s_done).astype(float), -1.0)
        order = np.argsort(-k, kind="stable")
        rem, w0, cum = rem[order], w0[order], cum[:, order]
    tiles = rem.reshape(-1, lanes)
    total += tiles.max(axis=1).sum() * lanes
    phase_iters.append(float(tiles.max(axis=1).mean()))
    return dict(
        utilization=float(work.sum() / max(total, 1.0)),
        phase_mean_iters=phase_iters,
        mean_path_len=float(work.sum() / (n_pix * n_samples)),
        caps=tuple(caps), key=key, rows_per_tile=rows_per_tile,
        n_samples=n_samples, max_depth=max_depth, width=w, height=h)
