"""The adjoint (reverse-mode) backward (K9) and its plain torch version.

Port of the JAX package's grad_adjoint per-sample sweep
(ops/wavefront_pallas.py: sample_body 3094-3209, adj_ctx 2693-2755,
adj_record 2757-2840, adj_step 2842-2892, scatter_rows and apply_vjp
2894-2956; the wrapper 3350-3357, 3532-3547, 3600-3626): one pass that
returns the radiance-sum image and d<g, radiance sum>/d theta for every
trainable family at once, the grads dict of the JAX package's keys
(ADJOINT_FIELDS), at a cost that does not grow with the number of
parameters. Training takes it from ADJOINT_MIN_SLOTS hard slots, or where
the forward-mode tiers cannot serve a request (parallel/train.py).

Per lane and sample, phase F traces the path forward and keeps each
bounce's inputs (the ray state o, d, th and the discrete context: the
winner of the selection, the material and texture rows, the branch taken);
phase R walks the bounces backward, chaining the state cotangent
lam = d<g, L>/d(o, d, th) of what follows from 0, and at each bounce adds
(g, lam) . d(radiance increment, o', d', th')/d(theta) into the parameter
accumulators and takes (g, lam) . d(...)/d(o, d, th) as the next lam. The
discrete context is held fixed: the estimator's detached-sampling
derivative, reparameterized through the winner's t, as every grad tier of
the port.

  - `render_pass_adjoint_kernel`: the CUDA kernel (csrc/wavefront.cu part 4,
    wavefront_adjoint_kernel), always on the chunk scan's tables
    (prepare_kernel(..., chunk_scan=True)), Cornell-class scenes included,
    one uncapped pass; its bounce store in device scratch (ADJ_STORE floats
    a bounce a lane), its accumulators doubles in a block's shared memory
    with atomics, rounded to float32 at the end (only the order of the
    double sums differs between runs).
  - `render_pass_adjoint_reference`: the plain version, the same per-sample
    F/R sweep over every lane at once on the port's plain integrator (the
    all-primitive selection of ops/intersect.py); each bounce's VJP is
    torch.autograd.grad of ops/integrator.py::bounce_step as a function of
    (o, d, th) and the trainable tables, so its memory stays at one
    bounce's graph.
  - `adjoint_pass_function`: the kernel for a scene on a CUDA device, the
    plain version on the CPU; `adjoint_gate_reason`: what the kernel takes.

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


def adjoint_gate_reason(flat: FlatScene) -> str | None:
    """Why the adjoint kernel cannot run on this scene (None = it can): the
    forward kernel's gate, as the JAX package's pallas_adjoint_gate_reason
    (366-378) is its base gate. The adjoint always runs on the chunk scan,
    whose tables stay in global memory, and has no slot bound."""
    return wc.kernel_gate_reason(flat)


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
def render_pass_adjoint_reference(flat: FlatScene, cam: CameraState, seed,
                                  sample_start, *, width: int, height: int,
                                  n_strata: int, max_depth: int,
                                  n_samples: int, cotangent,
                                  sky_gradient: bool = False, iters=None):
    """The plain version of the adjoint kernel: (image, grads) with image
    the (height, width, 3) radiance sum of n_samples samples a pixel (the
    forward pass's) and grads the dict of d<g, image>/d table for each of
    ADJOINT_FIELDS, g the (height, width, 3) cotangent.

    Per sample, over every lane at once: phase F runs bounce_step without
    a graph and keeps each bounce's live lanes, ray state and draws; phase
    R walks them backward, and at each bounce torch.autograd.grad of
    bounce_step (a function of o, d, th and the trainable tables; the
    draws, the ray time and the selection's outcome held fixed) takes the
    cotangents (g, lam) of (radiance increment, o', d', th') to the
    parameter gradients and the next lam. Light rows read the sphere
    tables, so a light sphere's cotangents land in its rows. iters, when
    given, counts each lane's phase-F bounces. The lanes' radiance,
    cotangents and gradients take the dtype of the scene's tables (float32;
    float64 tables give a float64 reference past the camera's float32
    rays). Each call adds one to render_pass_adjoint_reference.calls."""
    render_pass_adjoint_reference.calls += 1
    device = flat.device
    n_pix = width * height
    n_lanes = wc.lane_count(n_pix)
    wc._check_iters(iters, n_lanes, device)
    dt = flat.sph_center.dtype
    g = wc.cotangent_lanes(cotangent, width=width, height=height).to(
        device=device, dtype=dt).T                           # (n_lanes, 3)
    pix = wc._identity_pixels(n_lanes, n_pix, device)
    sample_start = int(sample_start)
    background = cam.background
    tables = {f: getattr(flat, f).detach() for f in ADJOINT_FIELDS}
    grads = {f: torch.zeros_like(t) for f, t in tables.items()}
    rad = torch.zeros(n_lanes, 3, dtype=dt, device=device)
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
            state = [x.detach().requires_grad_(True) for x in (o, d, th)]
            params = {f: t.detach().requires_grad_(True)
                      for f, t in tables.items()}
            with torch.enable_grad():
                out = bounce_step(dataclasses.replace(flat, **params),
                                  state[0], state[1], t_, state[2], live, u,
                                  u_med, background, sky_gradient)[:4]
            lam_b = lam[idx]
            got = torch.autograd.grad(
                out, state + list(params.values()),
                (g[idx], lam_b[:, 0:3], lam_b[:, 3:6], lam_b[:, 6:9]),
                allow_unused=True)
            lam[idx] = torch.cat(got[:3], dim=1)
            for f, gr in zip(params, got[3:]):
                if gr is not None:
                    grads[f] += gr
    return wc._image_from_lanes(rad.T, width, height), grads


render_pass_adjoint_reference.calls = 0


# ------------------------------------------------------------- the kernel
def render_pass_adjoint_kernel(flat: FlatScene, cam: CameraState, seed,
                               sample_start, *, width: int, height: int,
                               n_strata: int, max_depth: int, n_samples: int,
                               cotangent, sky_gradient: bool = False,
                               prepared: wc.KernelInputs | None = None,
                               iters=None):
    """The adjoint kernel's (K9) wrapper: render_pass_adjoint_reference's
    signature and results, on a CUDA device. `prepared` is
    prepare_kernel(flat, cam, chunk_scan=True), packed here when not given.
    Launches on the current stream; raises if the scene is outside
    adjoint_gate_reason, the inputs are malformed, or the launch fails.
    Each launch adds one to render_pass_adjoint_kernel.launches."""
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
    n_pix = width * height
    n_lanes = wc.lane_count(n_pix)
    wc._check_iters(iters, n_lanes, device)
    if n_strata * n_strata + int(sample_start) >= 1 << 24:
        raise ValueError("sample indices must stay below 2^24")
    if max_depth < 1 or n_samples < 1:
        raise ValueError("max_depth and n_samples must be positive")
    cot = wc.cotangent_lanes(cotangent, width=width, height=height).to(
        device=device, dtype=torch.float32).contiguous()
    NT, S, NM = adjoint_layout(flat)
    p = wc._Params(
        n_lanes=n_lanes, n_pix=n_pix, width=width, n_strata=n_strata,
        max_depth=max_depth, n_samples=n_samples,
        sample_start=int(sample_start), seed_mix=rng.mix_seed(seed),
        sky_gradient=int(bool(sky_gradient)), cap=0, K=0, want_tex=0,
        suffix=0, inv_strata=float(np.float32(1.0 / n_strata)),
        **prepared.fields)
    rad = torch.empty(3, n_lanes, dtype=torch.float32, device=device)
    acc = torch.zeros(3 * NT + 4 * S + 2 * NM, dtype=torch.float64,
                      device=device)
    store = torch.empty(max_depth * ADJ_STORE * n_lanes, dtype=torch.float32,
                        device=device)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    lib = wc.load_library()
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device)
                                 .cuda_stream)
        err = lib.adjoint(ctypes.byref(p),
                          ctypes.byref(wc._VsParams(**prepared.vfields)),
                          ptr(prepared.tables), ptr(prepared.vtab), ptr(cot),
                          ptr(rad), ptr(acc), ptr(store), ptr(iters), NM,
                          stream)
    if err != 0:
        raise RuntimeError(f"adjoint kernel launch failed: CUDA error {err}")
    render_pass_adjoint_kernel.launches += 1
    return (wc._image_from_lanes(rad, width, height),
            grads_from_row(flat, acc.to(torch.float32)))


render_pass_adjoint_kernel.launches = 0


def adjoint_pass_function(flat: FlatScene, cam: CameraState,
                          prepared: wc.KernelInputs | None = None):
    """The adjoint pass for the scene's device: the kernel, with the scene
    packed once on the chunk scan's tables (or `prepared`), for a scene on a
    CUDA device; the plain version for a scene on the CPU."""
    if flat.device.type == "cuda":
        if prepared is None or prepared.mode != "vscan":
            prepared = wc.prepare_kernel(flat, cam, chunk_scan=True)
        return functools.partial(render_pass_adjoint_kernel,
                                 prepared=prepared)
    if flat.device.type == "cpu":
        return render_pass_adjoint_reference
    raise ValueError(f"no adjoint pass for device {flat.device}")
