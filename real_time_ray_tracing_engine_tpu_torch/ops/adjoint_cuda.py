"""The adjoint (reverse-mode) backward (K9, K10) and its plain torch versions.

Port of the JAX package's grad_adjoint (ops/wavefront_pallas.py: adj_ctx
2693-2755, adj_record 2757-2840, adj_step 2842-2892, scatter_rows and
apply_vjp 2894-2956; the wrapper 3350-3357, 3532-3547, 3594-3626): one pass
that returns the radiance-sum image and d<g, radiance sum>/d theta for
every trainable family at once, the grads dict of the JAX package's keys
(ADJOINT_FIELDS), at a cost that does not grow with the number of
parameters. Training takes it from ADJOINT_MIN_SLOTS hard slots, or where
the forward-mode tiers cannot serve a request (parallel/train.py).

Per lane and sample, the forward traces the path and keeps each bounce's
inputs (the ray state o, d, th and the discrete context: the winner of the
selection, the material and texture rows, the branch taken); the reverse
walks the bounces backward, chaining the state cotangent lam = d<g, L>/d(o,
d, th) of what follows from 0, and at each bounce adds (g, lam) .
d(radiance increment, o', d', th')/d(theta) into the parameter accumulators
and takes (g, lam) . d(...)/d(o, d, th) as the next lam. The discrete
context is held fixed: the estimator's detached-sampling derivative,
reparameterized through the winner's t, as every grad tier of the port.

Two sweeps order those bounces (adjoint_sweep picks one):
  - the per-sample sweep (K9, sample_body 3094-3209): per sample, the path
    forward, then its bounces backward;
  - the segmented-regeneration sweep (K10, adj_seg 2958-3092): each lane
    runs its samples in one regenerating wavefront to the end, keeping a
    snapshot of its state every SEG iterations (sweep 1, the image), then
    takes the segments last to first, re-running each from its snapshot
    and reversing its bounces, lam carried across segments and cut to 0
    where a lane regenerated (sweep 2). The same bounces and the same VJPs:
    the same image and gradients, summed in another order.

  - `render_pass_adjoint_kernel`: the CUDA kernels (csrc/wavefront.cu part
    4, wavefront_adjoint_kernel, K9; part 5, wavefront_adjoint_seg_kernel,
    K10, with `seg`), always on the chunk scan's tables
    (prepare_kernel(..., chunk_scan=True)), Cornell-class scenes and the
    scenes that kernel_mode puts in a BVH mode included (the JAX package
    forces the same, wavefront_pallas.py:3353-3356), one uncapped pass;
    their scratch in device memory (K9: ADJ_STORE floats a bounce a lane;
    K10: seg_scratch), their accumulators doubles in a block's shared
    memory with atomics, rounded to float32 at the end (only the order of
    the double sums differs between runs).
  - `render_pass_adjoint_reference` / `render_pass_adjoint_seg_reference`:
    the plain versions of the two sweeps over every lane at once on the
    port's plain integrator (the all-primitive selection of
    ops/intersect.py, in every kernel mode); each bounce's VJP
    (_bounce_vjp, shared) is torch.autograd.grad of
    ops/integrator.py::bounce_step as a function of (o, d, th) and the
    trainable tables, so the memory stays at one bounce's graph.
  - `adjoint_sweep`: the sweep of a request; `adjoint_pass_function`: the
    kernel for a scene on a CUDA device, the plain version on the CPU;
    `adjoint_gate_reason`: what the kernels take.

Accumulator layout (one row, `adjoint_layout`; double in the kernel): 3*NT
tex_color, then 4*S sphere (center xyz, radius), then 2*NM material (fuzz,
IOR); light rows that copy a sphere add into that sphere's rows (the JAX
kernel's adj_light_slots).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..scene.flat import FlatScene
from ..models.camera import CameraState, generate_rays
from ..utils import rng
from ..utils.profiling import span
from ..utils.vecmath import normalize
from .integrator import bounce_step, medium_uniforms
from . import wavefront_cuda as wc

# the families of the grads dict, the JAX package's keys (3615-3626)
ADJOINT_FIELDS = ("tex_color", "sph_center", "sph_radius", "mat_fuzz",
                  "mat_ior")
# floats of the kernel's bounce store per bounce and lane (csrc/wavefront.cu
# ADJ_STORE): o xyz, d xyz, th xyz, winner, t, material, eff, flags, MIS
# weight
ADJ_STORE = 15
# the segmented sweep's (K10) floats per lane: a record, ADJ_STORE and the
# regeneration flag, bounce, absolute sample and ray time; a snapshot, o, d,
# th, alive, bounce, local sample and ray time (csrc/wavefront.cu ADJ_REC,
# ADJ_SNAP)
ADJ_REC = ADJ_STORE + 4
ADJ_SNAP = 13


def adjoint_gate_reason(flat: FlatScene) -> str | None:
    """Why the adjoint kernel cannot run on this scene (None = it can): the
    forward kernel's gate, as the JAX package's pallas_adjoint_gate_reason
    (366-378) is its base gate. The adjoint always runs on the chunk scan,
    whose tables stay in global memory, and has no slot bound."""
    return wc.kernel_gate_reason(flat)


def adjoint_sweep(adjoint_seg: int | None = None) -> int:
    """The adjoint sweep a pass takes: 0 the per-sample sweep (K9), n > 0
    the segmented-regeneration sweep at SEG = n (K10), at any depth (the
    JAX package's RTX_ADJOINT_SEG, as an argument); a negative value
    raises. None is the port's default, the per-sample sweep. The JAX
    package takes SEG 8 past depth 12 (parallel/train.py:100-110), a
    choice for the TPU's lock-step tiles. On the H100 K10 at SEG 8 was
    slower than K9 while both reversed a bounce by dual columns; with the
    hand-written reverse bounce it is faster than K9 at both of
    bouncing_spheres' d50 shapes (PERF.md §5-6). The default stays K9 at
    every depth until the change that re-decides the sweep rule (ROADMAP,
    queue 2)."""
    if adjoint_seg is None:
        return 0
    if int(adjoint_seg) != adjoint_seg or adjoint_seg < 0:
        raise ValueError(f"adjoint_seg must be None, 0 (the per-sample "
                         f"sweep) or a positive SEG, got {adjoint_seg!r}")
    return int(adjoint_seg)


def adjoint_layout(flat: FlatScene) -> tuple:
    """(NT, S, NM): the accumulator row holds 3*NT tex_color, 4*S sphere
    and 2*NM material floats, in that order."""
    return (flat.tex_type.shape[0], flat.sph_center.shape[0],
            flat.mat_type.shape[0])


def grads_from_row(flat: FlatScene, row: torch.Tensor) -> dict:
    """The grads dict of one accumulator row (adjoint_layout), each family
    shaped as its FlatScene table."""
    NT, S, NM = adjoint_layout(flat)
    tex = row[:3 * NT].reshape(NT, 3)
    sph = row[3 * NT:3 * NT + 4 * S].reshape(S, 4)
    mat = row[3 * NT + 4 * S:3 * NT + 4 * S + 2 * NM].reshape(NM, 2)
    return {"tex_color": tex, "sph_center": sph[:, :3].contiguous(),
            "sph_radius": sph[:, 3].contiguous(),
            "mat_fuzz": mat[:, 0].contiguous(),
            "mat_ior": mat[:, 1].contiguous()}


# ---------------------------------------------------- plain torch version
def _bounce_vjp(flat: FlatScene, tables: dict, o, d, th, tm, live, u, u_med,
                g, lam, background, sky_gradient: bool):
    """The VJP of one bounce over its lanes: torch.autograd.grad of
    bounce_step as a function of (o, d, th) and the trainable tables (the
    draws, the ray time and the selection's outcome held fixed) at the
    cotangents (g, lam) of (radiance increment, o', d', th'). Returns (the
    cotangent (n, 9) of (o, d, th), {field: the tables' gradient or
    None})."""
    state = [x.detach().requires_grad_(True) for x in (o, d, th)]
    params = {f: t.detach().requires_grad_(True) for f, t in tables.items()}
    with torch.enable_grad():
        out = bounce_step(dataclasses.replace(flat, **params), state[0],
                          state[1], tm, state[2], live, u, u_med, background,
                          sky_gradient)[:4]
    got = torch.autograd.grad(out, state + list(params.values()),
                              (g, lam[:, 0:3], lam[:, 3:6], lam[:, 6:9]),
                              allow_unused=True)
    return torch.cat(got[:3], dim=1), dict(zip(params, got[3:]))


def _add_grads(grads: dict, got: dict) -> None:
    for f, gr in got.items():
        if gr is not None:
            grads[f] += gr


def _adjoint_setup(flat: FlatScene, cotangent, width: int, height: int,
                   iters, row0: int = 0):
    """What both plain sweeps start from: (n_lanes, the lanes' pixels, the
    cotangent lanes (n_lanes, 3), the trainable tables, zero grads, zero
    radiance (n_lanes, 3)), in the dtype of the scene's tables. The lanes
    are the shard's (height rows); their pixels are absolute, row0 * width
    added, as the kernels' are."""
    device = flat.device
    n_pix = width * height
    n_lanes = wc.lane_count(n_pix)
    wc._check_iters(iters, n_lanes, device)
    dt = flat.sph_center.dtype
    g = wc.cotangent_lanes(cotangent, width=width, height=height).to(
        device=device, dtype=dt).T                           # (n_lanes, 3)
    pix = (wc._identity_pixels(n_lanes, n_pix, device)
           + wc._check_row0(row0) * width)
    tables = {f: getattr(flat, f).detach() for f in ADJOINT_FIELDS}
    grads = {f: torch.zeros_like(t) for f, t in tables.items()}
    rad = torch.zeros(n_lanes, 3, dtype=dt, device=device)
    return n_lanes, pix, g, tables, grads, rad


def render_pass_adjoint_reference(flat: FlatScene, cam: CameraState, seed,
                                  sample_start, *, width: int, height: int,
                                  n_strata: int, max_depth: int,
                                  n_samples: int, cotangent,
                                  sky_gradient: bool = False, iters=None,
                                  row0: int = 0):
    """The plain version of the adjoint kernel's per-sample sweep (K9):
    (image, grads) with image the (height, width, 3) radiance sum of
    n_samples samples a pixel (the forward pass's) and grads the dict of
    d<g, image>/d table for each of ADJOINT_FIELDS, g the (height, width,
    3) cotangent.

    Per sample, over every lane at once: phase F runs bounce_step without
    a graph and keeps each bounce's live lanes, ray state and draws; phase
    R walks them backward, and at each bounce the bounce's VJP
    (_bounce_vjp) takes the cotangents (g, lam) of (radiance increment, o',
    d', th') to the parameter gradients and the next lam. Light rows read
    the sphere tables, so a light sphere's cotangents land in its rows.
    iters, when given, counts each lane's phase-F bounces. The lanes'
    radiance, cotangents and gradients take the dtype of the scene's tables
    (float32; float64 tables give a float64 reference past the camera's
    float32 rays). row0 > 0 renders the image rows [row0, row0 + height)
    of a tile shard (render_pass_reference's), the cotangent the shard's.
    Each call adds one to render_pass_adjoint_reference.calls."""
    render_pass_adjoint_reference.calls += 1
    flat = wc.all_primitive(flat)
    device = flat.device
    n_lanes, pix, g, tables, grads, rad = _adjoint_setup(
        flat, cotangent, width, height, iters, row0)
    dt = rad.dtype
    sample_start = int(sample_start)
    background = cam.background
    for s in range(n_samples):
        keys = rng.ray_keys(seed, pix, sample_start + s)
        org, dr, tm = generate_rays(cam, width, pix, sample_start + s,
                                    n_strata, keys)
        idx = torch.arange(n_lanes, device=device)
        o, d = org.to(dt), normalize(dr).to(dt)
        th = torch.ones_like(o)
        # phase F: the path forward, each bounce's live lanes kept
        tape = []
        for b in range(max_depth):
            if idx.numel() == 0:
                break
            u = rng.bounce_uniforms(keys[idx], b)
            u_med = medium_uniforms(flat, keys[idx], b)
            live = torch.ones(idx.numel(), dtype=torch.bool, device=device)
            tape.append((idx, o, d, th, tm[idx], live, u, u_med))
            with torch.no_grad():
                drad, o, d, th, alive = bounce_step(
                    flat, o, d, tm[idx], th, live, u, u_med, background,
                    sky_gradient)
            rad[idx] += drad
            if iters is not None:
                iters[idx] += 1
            if b + 1 == max_depth:
                break
            idx, o, d, th = idx[alive], o[alive], d[alive], th[alive]
        # phase R: the bounces backward, lam from 0
        lam = torch.zeros(n_lanes, 9, dtype=dt, device=device)
        for idx, o, d, th, t_, live, u, u_med in reversed(tape):
            lam[idx], got = _bounce_vjp(flat, tables, o, d, th, t_, live, u,
                                        u_med, g[idx], lam[idx], background,
                                        sky_gradient)
            _add_grads(grads, got)
    return wc._image_from_lanes(rad.T, width, height), grads


render_pass_adjoint_reference.calls = 0


def seg_scratch(n_lanes: int, n_samples: int, max_depth: int,
                seg: int) -> tuple:
    """(snapshot bound NSEG_MAX, record floats, snapshot floats) of the
    segmented sweep (K10; wavefront_pallas.py:3594-3599): NSEG_MAX =
    ceil(n_samples * max_depth / seg) + 1 snapshots of ADJ_SNAP floats a
    lane, and seg records of ADJ_REC floats a lane."""
    nseg_max = -(-(n_samples * max_depth) // seg) + 1
    return (nseg_max, seg * ADJ_REC * n_lanes,
            nseg_max * ADJ_SNAP * n_lanes)


def render_pass_adjoint_seg_reference(flat: FlatScene, cam: CameraState,
                                      seed, sample_start, *, width: int,
                                      height: int, n_strata: int,
                                      max_depth: int, n_samples: int,
                                      cotangent, seg: int,
                                      sky_gradient: bool = False,
                                      iters=None, row0: int = 0):
    """The plain version of the adjoint kernel's segmented-regeneration
    sweep (K10, wavefront_pallas.py 2958-3092): render_pass_adjoint_
    reference's arguments and results, by another orchestration of the same
    bounces, over every lane at once.

    Each lane runs its pixel's samples in turn in one regenerating
    wavefront (`advance`: a lane whose path ended and that has samples left
    takes the next sample's camera ray; every live lane runs one
    bounce_step at its own bounce and sample). Sweep 1 runs it to the end,
    accumulating the image and keeping a snapshot of the lane state every
    `seg` iterations while any lane has work left (at most NSEG_MAX,
    seg_scratch). Sweep 2 takes the snapshots last to first: it re-runs
    the segment's `seg` iterations keeping each iteration's live lanes,
    state, draws and regeneration flags, then reverses them with the
    per-sample sweep's bounce VJP (_bounce_vjp), lam carried across
    segments and set to 0 where a lane regenerated. iters, when given,
    counts sweep 1's bounces; row0 as render_pass_adjoint_reference's.
    Each call adds one to
    render_pass_adjoint_seg_reference.calls."""
    render_pass_adjoint_seg_reference.calls += 1
    if seg < 1:
        raise ValueError(f"seg must be positive, got {seg}")
    flat = wc.all_primitive(flat)
    device = flat.device
    n_lanes, pix, g, tables, grads, rad = _adjoint_setup(
        flat, cotangent, width, height, iters, row0)
    dt = rad.dtype
    sample_start = int(sample_start)
    background = cam.background
    nseg_max = seg_scratch(n_lanes, n_samples, max_depth, seg)[0]

    def camera(lanes, s):
        s_abs = sample_start + s
        keys = rng.ray_keys(seed, pix[lanes], s_abs)
        org, dr, tm = generate_rays(cam, width, pix[lanes], s_abs, n_strata,
                                    keys)
        return org.to(dt), normalize(dr).to(dt), tm

    def advance(st, tape=None):
        o, d, th, tm, alive, b, s = st
        # new tensors: the snapshots hold the old ones
        o, d, th, tm, b = o.clone(), d.clone(), th.clone(), tm.clone(), \
            b.clone()
        regen = ~alive & (s + 1 < n_samples)
        s = s + regen.long()
        r = regen.nonzero()[:, 0]
        if r.numel():
            o[r], d[r], tm[r] = camera(r, s[r])
            th[r] = 1.0
            b[r] = 0
        alive = alive | regen
        idx = alive.nonzero()[:, 0]
        if idx.numel() == 0:
            return o, d, th, tm, alive, b + 1, s
        keys = rng.ray_keys(seed, pix[idx], sample_start + s[idx])
        u = rng.bounce_uniforms(keys, b[idx])
        u_med = medium_uniforms(flat, keys, b[idx])
        live = torch.ones(idx.numel(), dtype=torch.bool, device=device)
        if tape is not None:
            tape.append((idx, o[idx], d[idx], th[idx], tm[idx], live, u,
                         u_med, regen[idx]))
        elif iters is not None:
            iters[idx] += 1
        with torch.no_grad():
            drad, o[idx], d[idx], th[idx], go_on = bounce_step(
                flat, o[idx], d[idx], tm[idx], th[idx], live, u, u_med,
                background, sky_gradient)
        if tape is None:
            rad[idx] += drad
        alive = torch.zeros_like(alive)
        alive[idx] = go_on & (b[idx] + 1 < max_depth)
        return o, d, th, tm, alive, b + 1, s

    # sweep 1: the regenerating forward, a snapshot every seg iterations
    zeros = torch.zeros(n_lanes, dtype=torch.long, device=device)
    o, d, tm = camera(torch.arange(n_lanes, device=device), zeros)
    st = (o, d, torch.ones_like(o), tm,
          torch.ones(n_lanes, dtype=torch.bool, device=device), zeros, zeros)
    snaps = []
    while len(snaps) < nseg_max and bool(
            (st[4] | (st[6] + 1 < n_samples)).any()):
        snaps.append(st)
        for _ in range(seg):
            st = advance(st)
    # sweep 2: the segments last to first, re-run, then reversed
    lam = torch.zeros(n_lanes, 9, dtype=dt, device=device)
    for st in reversed(snaps):
        tape = []
        for _ in range(seg):
            st = advance(st, tape)
        for idx, o, d, th, t_, live, u, u_med, regen in reversed(tape):
            lam_b, got = _bounce_vjp(flat, tables, o, d, th, t_, live, u,
                                     u_med, g[idx], lam[idx], background,
                                     sky_gradient)
            lam[idx] = torch.where(regen[:, None], 0.0, lam_b)
            _add_grads(grads, got)
    return wc._image_from_lanes(rad.T, width, height), grads


render_pass_adjoint_seg_reference.calls = 0


# ------------------------------------------------------------- the kernel
def render_pass_adjoint_kernel(flat: FlatScene, cam: CameraState, seed,
                               sample_start, *, width: int, height: int,
                               n_strata: int, max_depth: int, n_samples: int,
                               cotangent, sky_gradient: bool = False,
                               prepared: wc.KernelInputs | None = None,
                               iters=None, seg: int = 0, row0: int = 0):
    """The adjoint kernel's wrapper: render_pass_adjoint_reference's
    signature and results, on a CUDA device; seg = 0 launches the
    per-sample sweep (K9), seg > 0 the segmented-regeneration sweep with
    SEG = seg (K10, render_pass_adjoint_seg_reference's results); row0 a
    tile shard's first row, its lanes, scratch and cotangent the shard's.
    `prepared` is prepare_kernel(flat, cam, chunk_scan=True), packed here
    when not given. Launches on the current stream; raises, before the
    launch, if the scene is outside adjoint_gate_reason, the inputs are
    malformed or the sweep's scratch does not fit the device's free memory,
    and after it if the launch fails. Each launch adds one to
    render_pass_adjoint_kernel.launches (K9) or .seg_launches (K10)."""
    device = flat.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    reason = adjoint_gate_reason(flat)
    if reason is not None:
        raise ValueError(f"scene outside the adjoint kernel's gate: {reason}")
    if prepared is None:
        prepared = wc.prepare_kernel(flat, cam, chunk_scan=True)
    elif prepared.mode != "vscan":
        raise ValueError("the adjoint kernel runs on the chunk scan's tables:"
                         " prepare_kernel(flat, cam, chunk_scan=True)")
    with span("rt.launch"):
        n_pix = width * height
        n_lanes = wc.lane_count(n_pix)
        wc._check_iters(iters, n_lanes, device)
        if n_strata * n_strata + int(sample_start) >= 1 << 24:
            raise ValueError("sample indices must stay below 2^24")
        if max_depth < 1 or n_samples < 1:
            raise ValueError("max_depth and n_samples must be positive")
        if seg < 0:
            raise ValueError(f"seg must be 0 (K9) or positive (K10), got "
                             f"{seg}")
        cot = wc.cotangent_lanes(cotangent, width=width, height=height).to(
            device=device, dtype=torch.float32).contiguous()
        NT, S, NM = adjoint_layout(flat)
        if seg:
            nseg_max, n_rec, n_snap = seg_scratch(n_lanes, n_samples,
                                                  max_depth, seg)
        else:
            n_rec, n_snap = max_depth * ADJ_STORE * n_lanes, 0
        sweep = f"K10 SEG {seg}" if seg else "K9"
        wc.check_free(device, 4 * (n_rec + n_snap),
                      f"the adjoint's scratch ({sweep}, {n_lanes} lanes, "
                      f"{n_samples} samples, depth {max_depth})")
        p = wc._Params(
            n_lanes=n_lanes, n_pix=n_pix, width=width, n_strata=n_strata,
            max_depth=max_depth, n_samples=n_samples,
            sample_start=int(sample_start), row0=wc._check_row0(row0),
            seed_mix=rng.mix_seed(seed),
            sky_gradient=int(bool(sky_gradient)), cap=0, K=0, want_tex=0,
            suffix=0, inv_strata=float(np.float32(1.0 / n_strata)),
            **prepared.fields)
        rad = torch.empty(3, n_lanes, dtype=torch.float32, device=device)
        acc = torch.zeros(3 * NT + 4 * S + 2 * NM, dtype=torch.float64,
                          device=device)
        store = torch.empty(n_rec, dtype=torch.float32, device=device)
        snap = torch.empty(n_snap, dtype=torch.float32, device=device)

        def ptr(t):
            return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

        lib = wc.load_library()
        vp = wc._VsParams(**prepared.vfields)
        with torch.cuda.device(device):
            stream = ctypes.c_void_p(torch.cuda.current_stream(device)
                                     .cuda_stream)
            if seg:
                err = lib.adjoint_seg(ctypes.byref(p), ctypes.byref(vp),
                                      ptr(prepared.tables), ptr(prepared.vtab),
                                      ptr(cot), ptr(rad), ptr(acc), ptr(store),
                                      ptr(snap), ptr(iters), NM, seg, nseg_max,
                                      stream)
            else:
                err = lib.adjoint(ctypes.byref(p), ctypes.byref(vp),
                                  ptr(prepared.tables), ptr(prepared.vtab),
                                  ptr(cot), ptr(rad), ptr(acc), ptr(store),
                                  ptr(iters), NM, stream)
        if err != 0:
            raise RuntimeError(f"adjoint kernel ({'K10' if seg else 'K9'}) "
                               f"launch failed: CUDA error {err}")
    if seg:
        render_pass_adjoint_kernel.seg_launches += 1
    else:
        render_pass_adjoint_kernel.launches += 1
    return (wc._image_from_lanes(rad, width, height),
            grads_from_row(flat, acc.to(torch.float32)))


render_pass_adjoint_kernel.launches = 0
render_pass_adjoint_kernel.seg_launches = 0


# ------------------------------------------------- the reverse bounce alone
def _probe_inputs(flat: FlatScene, o, d, th, tm, pix, sample, bounce):
    n = o.shape[0]
    if not (d.shape == th.shape == o.shape == (n, 3)
            and tm.shape == pix.shape == sample.shape == bounce.shape
            == (n,)):
        raise ValueError("the probe takes o, d, th (n, 3) and tm, pix, "
                         "sample, bounce (n,)")


def row_from_grads(flat: FlatScene, grads: dict) -> torch.Tensor:
    """The accumulator row (adjoint_layout) of a grads dict, float64: the
    inverse of grads_from_row; a family of None is zero."""
    NT, S, NM = adjoint_layout(flat)
    dev = flat.device

    def fam(f, shape):
        g = grads.get(f)
        return (torch.zeros(shape, dtype=torch.float64, device=dev)
                if g is None else g.detach().to(torch.float64))
    sph = torch.cat([fam("sph_center", (S, 3)),
                     fam("sph_radius", (S,))[:, None]], dim=1)
    mat = torch.stack([fam("mat_fuzz", (NM,)), fam("mat_ior", (NM,))], 1)
    return torch.cat([fam("tex_color", (NT, 3)).reshape(-1), sph.reshape(-1),
                      mat.reshape(-1)])


def adjoint_bounce_probe_reference(flat: FlatScene, cam: CameraState, o, d,
                                   th, tm, pix, sample, bounce, g, lam, *,
                                   seed, sky_gradient: bool = False):
    """The plain version of adjoint_bounce_probe: per lane, _bounce_vjp of
    the one bounce from (o, d, th) at ray time tm with the draws of bounce
    `bounce` of sample `sample` of pixel `pix` (the all-primitive
    selection), at the cotangents g (n, 3) and lam (n, 9). Returns (the
    cotangent (n, 9) of (o, d, th), the lanes' accumulator rows (n, 3NT +
    4S + 2NM) float64), one autograd call a lane."""
    _probe_inputs(flat, o, d, th, tm, pix, sample, bounce)
    flat = wc.all_primitive(flat)
    tables = {f: getattr(flat, f).detach() for f in ADJOINT_FIELDS}
    keys = rng.ray_keys(seed, pix, sample)
    lam_out, rows = [], []
    for i in range(o.shape[0]):
        k = keys[i:i + 1]
        u = rng.bounce_uniforms(k, bounce[i:i + 1])
        u_med = medium_uniforms(flat, k, bounce[i:i + 1])
        live = torch.ones(1, dtype=torch.bool, device=flat.device)
        li, got = _bounce_vjp(flat, tables, o[i:i + 1], d[i:i + 1],
                              th[i:i + 1], tm[i:i + 1], live, u, u_med,
                              g[i:i + 1], lam[i:i + 1], cam.background,
                              sky_gradient)
        lam_out.append(li[0])
        rows.append(row_from_grads(flat, got))
    return torch.stack(lam_out), torch.stack(rows)


def adjoint_bounce_probe(flat: FlatScene, cam: CameraState, o, d, th, tm,
                         pix, sample, bounce, g, lam, *, seed,
                         sky_gradient: bool = False,
                         prepared: wc.KernelInputs | None = None):
    """The adjoint kernels' reverse bounce alone on the card
    (csrc/wavefront.cu adjoint_probe_kernel, part 4): per lane, the one
    bounce of adjoint_bounce_probe_reference through adj_forward_bounce
    (the chunk scan's selection and the float bounce, its record stored)
    and adj_reverse_bounce. Returns (the cotangent (n, 9) of (o, d, th),
    the lanes' accumulator rows (n, 3NT + 4S + 2NM) float64, the records
    (n, ADJ_STORE): o, d, th, winner, t, material, eff, flags, MIS weight).
    Each launch adds one to adjoint_bounce_probe.launches."""
    device = flat.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    _probe_inputs(flat, o, d, th, tm, pix, sample, bounce)
    if prepared is None:
        prepared = wc.prepare_kernel(flat, cam, chunk_scan=True)
    n = o.shape[0]
    N = wc.lane_count(n)
    NT, S, NM = adjoint_layout(flat)

    def lanes(x, rows, dtype):
        out = torch.zeros(rows, N, dtype=dtype, device=device)
        out[:, :n] = x.T.to(dtype)
        return out.contiguous()
    state = lanes(torch.cat([o, d, th, tm[:, None]], 1), 10, torch.float32)
    keys = lanes(torch.stack([pix, sample, bounce], 1), 3, torch.int32)
    cot = lanes(g, 3, torch.float32)
    lam_io = lanes(lam, 9, torch.float32)
    rad = torch.empty(3, N, dtype=torch.float32, device=device)
    acc = torch.zeros(N, 3 * NT + 4 * S + 2 * NM, dtype=torch.float64,
                      device=device)
    store = torch.empty(ADJ_STORE, N, dtype=torch.float32, device=device)
    p = wc._Params(
        n_lanes=N, n_pix=n, width=n, n_strata=1, max_depth=1, n_samples=1,
        sample_start=0, seed_mix=rng.mix_seed(seed),
        sky_gradient=int(bool(sky_gradient)), cap=0, K=0, want_tex=0,
        suffix=0, inv_strata=1.0, **prepared.fields)
    vp = wc._VsParams(**prepared.vfields)
    lib = wc.load_library()
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device)
                                 .cuda_stream)
        err = lib.adjoint_probe(
            ctypes.byref(p), ctypes.byref(vp),
            *[ctypes.c_void_p(t.data_ptr()) for t in (
                prepared.tables, prepared.vtab, state, keys, cot, lam_io,
                rad, acc, store)], NM, stream)
    if err != 0:
        raise RuntimeError(f"adjoint probe launch failed: CUDA error {err}")
    adjoint_bounce_probe.launches += 1
    return lam_io[:, :n].T, acc[:n], store[:, :n].T


adjoint_bounce_probe.launches = 0


def adjoint_pass_function(flat: FlatScene, cam: CameraState,
                          prepared: wc.KernelInputs | None = None,
                          seg: int = 0):
    """The adjoint pass of sweep `seg` (adjoint_sweep: 0 the per-sample
    sweep, n > 0 the segmented one at SEG = n) for the scene's device: the
    kernel, with the scene packed once on the chunk scan's tables (or
    `prepared`), for a scene on a CUDA device; the plain version for a
    scene on the CPU."""
    if flat.device.type == "cuda":
        if prepared is None or prepared.mode != "vscan":
            prepared = wc.prepare_kernel(flat, cam, chunk_scan=True)
        return functools.partial(render_pass_adjoint_kernel,
                                 prepared=prepared, seg=seg)
    if flat.device.type == "cpu":
        return plain_adjoint_pass(seg)
    raise ValueError(f"no adjoint pass for device {flat.device}")


def plain_adjoint_pass(seg: int = 0):
    """The plain version of sweep `seg`, on any device."""
    if seg:
        return functools.partial(render_pass_adjoint_seg_reference, seg=seg)
    return render_pass_adjoint_reference
