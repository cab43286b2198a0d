"""Profiling: spans on the profiler's clock, the rays/s meter,
torch.profiler traces and an fp32 roofline.

Port of the JAX package's utils/profiling.py. The reference's only
instrumentation is a per-scanline progress log (StaticCamera.cpp:63-65)
and a once-per-second FPS overlay that doubles as the adaptive-tile control
signal (DynamicCamera.cpp:182-194). SURVEY.md §5 asks for more: profiler
traces, a rays/s meter derived from (W*H*spp*avg_depth)/wall and a
roofline comparison. Here:

  - span(name) marks a step of the program (rt.*, listed there) as a
    torch.profiler.record_function range while a profiler records, and
    costs one flag check otherwise; the spans share the trace's clock with
    the CUPTI kernel and copy intervals, and a span's parent is the span
    that encloses it on its thread;
  - while a profiler records, the forward kernel's wrapper counts the
    bounces it traces (ops/wavefront_cuda.py::render_pass_kernel.bounces,
    a device-side total beside its launch counters; the plain engine's in
    models/render.py::_render_pass.bounces);
  - the roofline's peak is the card's float32 rate outside the tensor
    cores (_PEAK_FP32_FLOPS, keyed by a prefix of the CUDA device's name);
  - the operations of a bounce come from the kernels' source, counted by
    hand (OPS_*, bounce_ops and the rest: the bounds chip_smoke.py prints
    for every kernel);
  - profiler_trace is torch.profiler around a block, writing a chrome
    trace; device_busy reads the card's busy share out of one;
  - path_lengths gives the plain trace's per-path lengths, which the
    kernels' bounce counts are held against.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import time

import numpy as np
import torch

from . import rng

# whether a profiler records on this thread: one flag read
recording = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A record_function range named `name` while a profiler records
    (recording()); otherwise a shared no-op context: nothing is built,
    allocated, synchronised or read back. The program's spans:

      rt.render        models/render.py::render, the whole call
      rt.compile       scene/compile.py::compile_scene
      rt.pack          ops/wavefront_cuda.py::prepare_kernel: the tables,
                       the chunk scan's and the BVH's packing, the camera's
                       and Perlin seed's readback from a scene on the card,
                       the one copy of a scene packed on the host
      rt.launch        ops/wavefront_cuda.py::_launch and the launch of
                       ops/adjoint_cuda.py::render_pass_adjoint_kernel:
                       checks, parameters, scratch, the library call
      rt.compact       ops/wavefront_cuda.py::_compacted_schedule: the sort
                       and permutation between phases
      rt.memcheck      ops/wavefront_cuda.py::check_free (cudaMemGetInfo)
      rt.frame.camera  ProgressiveRenderer._set_camera: derive, with_camera
                       and its readback
      rt.frame.step, rt.frame.image   ProgressiveRenderer.step, .image
      rt.train.step    parallel/train.py::make_train_step's step, around
                       rt.train.forward (the render and loss),
                       rt.train.backward (loss.backward(), around
                       rt.train.scatter: _scatter_grads) and
                       rt.train.optimizer (zero_grad; optimizer.step())"""
    if not recording():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


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
# source, counted).
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
    the union of its kernels' intervals over the traced window, with each
    kernel's summed time and launches by name. The window runs from the
    start of the first outermost program span (rt.*, span) to the end of
    the last one, or of the last kernel if that ends later, so that the
    profiler's own start and stop stay outside it; a trace without such a
    span takes its first event to the end of its last. A trace with no
    kernel event (the CPU's) is busy 0."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events if e.get("cat") == "kernel")
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("rt.")]
    ends = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in (spans or events)]
    lo = min((s for s, _ in ends), default=0.0)
    hi = max([e for _, e in ends] + ([kernels[-1][1]] if spans and kernels
                                     else []), default=0.0)
    busy_us, end = 0.0, lo
    by_name = {}
    for t0, t1, name in kernels:
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        k = by_name.setdefault(name, {"ms": 0.0, "launches": 0})
        k["ms"] += (t1 - t0) / 1e3
        k["launches"] += 1
    window_us = hi - lo
    return {"window_ms": window_us / 1e3, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / window_us if window_us > 0 else 0.0,
            "kernels": by_name}


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
