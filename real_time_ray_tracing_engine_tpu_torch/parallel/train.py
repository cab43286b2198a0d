"""Differentiable rendering: optimize scene parameters against target images.

Port of the JAX package's parallel/train.py. The loss
forward renders with the forward kernel (K1, or the chunk scan's K6/K7 past
the unrolled bounds, or on a use_bvh scene that opts in the BVH walk's K11
or K12; K2 under the compacted schedule); its backward is the
forward-mode gradient kernel under the compacted grad driver (K5) over
every trainable family: tex_color (albedo, emission, medium tint) by exact
weight planes (K3; K3v on the chunk scan's selection, and on a BVH walk's)
for at most
MAX_GRAD_TEXS texture rows, past them by the suffix-radiance estimator
(K8, which replays each sample once more; a channel whose albedo is
exactly 0 gets no scatter gradient, announced once when a render is
built), and the hard families (metal fuzz, dielectric IOR, sphere centers
and radii) by one tangent bundle per scalar slot (K4; K4v), all dotted with
the image cotangent at every radiance event (ops/wavefront_cuda.py,
tex_form); or, from ADJOINT_MIN_SLOTS hard slots, by the adjoint backward
over every family at once (K9 or K10, ops/adjoint_cuda.py). Sampling
decisions use counter-based draws whose probabilities do not depend on the
parameters, so the gradient is that of the estimator with its samples held
fixed (reparameterized through intersection t for geometry), as in the JAX
package.

The tier policy is the JAX package's (train.py:160-216, `use_adjoint`): a
request with hard slots takes the adjoint (K9/K10) when it has
ADJOINT_MIN_SLOTS slots or more, or when the forward-mode kernels cannot
serve a scene inside their gate (grad_gate_reason on a scene
kernel_gate_reason admits); the port adds one rule of its own, measured
on the card: tex_color's weight planes of more than MAX_TEXS rows beside
ADJOINT_PLANES_SLOTS slots or more take the adjoint too. Every other
request takes the forward-mode
tiers as before, so a scene outside the kernels' gate, which only the
plain engine renders, keeps the plain tangent bundles under
ADJOINT_MIN_SLOTS. The adjoint returns every family's gradient, and each
requested tensor takes its own. Its sweep is `adjoint_seg`
(ops/adjoint_cuda.py::adjoint_sweep: None the port's default, 0 the
per-sample sweep K9, n > 0 the segmented-regeneration sweep K10 at SEG =
n; the JAX package's RTX_ADJOINT_SEG), the same gradients by either.
The JAX package's pure-JAX replay and mixed tiers are not carried over:
on the card they would be hidden plain engines.

Engines, as models/render.pick_engine resolves them: "cuda" runs the
kernels (the scene on a CUDA device, inside kernel_gate_reason, or it
raises); "torch" runs their plain torch versions (the same tiers and
sweep), the engine for the CPU and, asked for by name, on the card, where
it launches no kernel (the adjoint's plain versions included); "auto" is "cuda" on a
CUDA device and "torch" on the CPU. Both engines take the same tier for a
request. On "cuda" a request no kernel can serve (tex_color alone past a
block's shared memory) raises NotImplementedError naming what is missing
before any pass runs; there is no plain fallback.

Over a mesh (mesh=, parallel/mesh.py::RenderMesh; JAX train.py:124-143,
310-323, 326-392) each rank renders its shard: its tile's rows (the
passes' row0) and its range of the samples (their sample_start), the
compacted schedule from COMPACT_MIN_SAMPLES samples of the shard, and
its backward takes the shard's own rows of the cotangent. The shards of a
tile are merged by _SampleSum: its forward is a plain all_reduce (sum)
over "sample", its backward the identity. So each rank's backward is the
vector-Jacobian product of its own shard at its tile's cotangent, and
the gradient is the sum of those products over every rank: the explicit
all_reduce of all_reduce_grads, after the local backward, over the world.
Two designs this avoids: an autograd-aware all_reduce over "sample"
(whose backward sums the cotangent over the sample ranks, so the world's
sum would count each shard's product n_sample times), and a plain
all_reduce in place on the image (which cuts the graph).
tests/test_torch_mesh.py pins the factor. The loss of a rank is the sum
of its tile's squared errors over the whole image's entry count; summed
over "tile" it is the one-process loss (mesh_loss).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..scene.flat import FlatScene
from ..models.camera import CameraState
from ..models.render import pick_engine
from ..utils.profiling import span, spanned
from .mesh import RenderMesh, all_reduce_sum
from ..ops.adjoint_cuda import (adjoint_pass_function, adjoint_sweep,
                                plain_adjoint_pass)
from ..ops.wavefront_cuda import (HARD_FIELDS, MAX_GRAD_TEXS, MAX_TEXS,
                                  grad_gate_reason, grad_pass_function,
                                  hard_param_slots, kernel_gate_reason,
                                  pass_function,
                                  prepare_kernel, render_pass_compacted,
                                  render_pass_grad_compacted,
                                  render_pass_grad_reference,
                                  render_pass_reference, slot_index,
                                  tex_form)

# The JAX package's continuous, safely-differentiable scene parameters.
TRAINABLE_FIELDS = ("tex_color", "mat_fuzz", "mat_ior", "sph_center",
                    "sph_radius")
# from this many hard slots training takes the adjoint (K9/K10), below it the
# tangent bundles (JAX train.py:43)
ADJOINT_MIN_SLOTS = 33
# from this many hard slots beside the chunk scan's weight planes of more
# than MAX_TEXS rows (K3v with K4v's tangent bundles) training takes the
# adjoint as well: on chip_smoke.py's 31-row metals scene at 1200x675
# spp16 d50 K3v + K4v takes 16.92 ms with 16 fuzz slots and 29.26 with 24,
# K9 21.45 on the same request (an NVIDIA H100 80GB HBM3 at 700 W;
# scripts/port_profile.py k3vnew, PERF.md). The requests the adjoint took
# while those planes were in shared memory (30 slots beside 31 rows) stay
# on it.
ADJOINT_PLANES_SLOTS = 20
# a pass of at least this many samples takes the compacted schedule, as the
# JAX make_kernel_render does (train.py:136-146)
COMPACT_MIN_SAMPLES = 8


def get_params(flat: FlatScene, fields=TRAINABLE_FIELDS) -> dict:
    return {k: getattr(flat, k) for k in fields}


def set_params(flat: FlatScene, params: dict) -> FlatScene:
    return dataclasses.replace(flat, **params)


def check_fields(fields) -> None:
    """Raise unless `fields` is a non-empty set of trainable fields."""
    fields = set(fields)
    unknown = fields - set(TRAINABLE_FIELDS)
    if unknown:
        raise ValueError(f"unknown trainable fields {sorted(unknown)} "
                         f"(trainable: {TRAINABLE_FIELDS})")
    if not fields:
        raise ValueError("no trainable field given (trainable: "
                         f"{TRAINABLE_FIELDS})")


def grad_slots(flat: FlatScene, fields) -> tuple:
    """The hard slots a request for `fields` differentiates: those of the
    requested hard families only (JAX train.py:174-175)."""
    hard = set(fields) & set(HARD_FIELDS)
    return hard_param_slots(flat, hard) if hard else ()


def use_adjoint(flat: FlatScene, slots: tuple, want_tex: bool) -> bool:
    """Whether a request takes the adjoint backward (JAX train.py:196-199):
    it has hard slots, and either ADJOINT_MIN_SLOTS of them,
    ADJOINT_PLANES_SLOTS of them beside tex_color's weight planes of more
    than MAX_TEXS rows on a scene inside the kernels' gate (the port's
    rule: K9 measured faster there), or a pass the
    forward-mode kernels cannot serve on a scene inside their gate
    (grad_gate_reason; in the BVH modes, K11 and K12, any hard slot, since
    their walks carry no tangent bundles, as in the JAX package: tex_color
    alone keeps their grad instances, weight planes or the suffix tier). A
    scene outside the forward kernel's gate
    (kernel_gate_reason, which is the adjoint kernel's too) is no reason:
    only the plain engine renders it, and its tangent bundles serve it."""
    inside = kernel_gate_reason(flat) is None
    return bool(slots) and (
        len(slots) >= ADJOINT_MIN_SLOTS
        or (inside and len(slots) >= ADJOINT_PLANES_SLOTS
            and tex_form(flat, want_tex) == "planes"
            and flat.tex_type.shape[0] > MAX_TEXS)
        or (inside
            and grad_gate_reason(flat, len(slots), want_tex) is not None))


@dataclass(frozen=True)
class _Plan:
    """What a kernel render fixes at build time."""
    baked: FlatScene
    engine: str          # "cuda" | "torch"
    common: dict         # width, height (the shard's rows), n_strata,
                         # max_depth, n_samples (the shard's), sky_gradient,
                         # row0 (the shard's first row)
    compacted: bool
    adjoint_seg: int = 0  # an adjoint request's sweep (adjoint_sweep)
    sample0: int = 0      # the shard's first sample


@dataclass(frozen=True)
class _Request:
    """What one call differentiates: the param names in TRAINABLE_FIELDS
    order, the hard slots of their families and whether the adjoint
    backward serves it."""
    names: tuple
    slots: tuple
    adjoint: bool = False

    @property
    def want_tex(self) -> bool:
        return "tex_color" in self.names


def _pass_functions(plan: _Plan, flat: FlatScene, cam: CameraState,
                    req: _Request):
    """(forward pass, backward pass) for the plan's engine: the grad pass,
    or the adjoint pass for an adjoint request. The kernels share one
    packing of the scene and the slot table (once per step); the adjoint
    runs on the chunk scan's tables, packed once more for a scene the
    forward runs unrolled. The adjoint takes the plan's sweep."""
    if plan.engine == "cuda":
        if req.adjoint:
            prep = prepare_kernel(flat, cam)
            return (pass_function(flat, cam, prep),
                    adjoint_pass_function(flat, cam, prep,
                                          seg=plan.adjoint_seg))
        prep = prepare_kernel(flat, cam, req.slots)
        return (pass_function(flat, cam, prep),
                grad_pass_function(flat, cam, prep))
    if req.adjoint:
        return render_pass_reference, plain_adjoint_pass(plan.adjoint_seg)
    return render_pass_reference, render_pass_grad_reference


@spanned("rt.train.scatter")
def _scatter_grads(req: _Request, params, dg_tex, dg_hard) -> tuple:
    """Per requested tensor, its gradient: dG_tex for tex_color, dG_hard's
    slots added at their entries of the hard families (JAX
    train.py:245-252), zeros where a family has no slot."""
    grads = {n: torch.zeros_like(p) for n, p in zip(req.names, params)}
    if req.want_tex:
        grads["tex_color"] = dg_tex
    for field in set(req.names) & set(HARD_FIELDS):
        ks, flat_idx = [], []
        for k, slot in enumerate(req.slots):
            f, idx = slot_index(slot)
            if f == field:
                ks.append(k)
                flat_idx.append(idx if isinstance(idx, int)
                                else idx[0] * 3 + idx[1])
        if ks:
            dev = grads[field].device
            grads[field].view(-1).index_add_(
                0, torch.tensor(flat_idx, device=dev),
                dg_hard[torch.tensor(ks, device=dev)])
    return tuple(grads[n] for n in req.names)


class _KernelRender(torch.autograd.Function):
    """The requested params -> the (height, width, 3) radiance-sum image;
    its backward is the grad pass with the image cotangent, giving each
    param tensor its gradient."""

    @staticmethod
    def forward(ctx, plan: _Plan, cam: CameraState, seed, req: _Request,
                *params):
        flat = set_params(plan.baked, dict(zip(req.names, params)))
        fwd, grad = _pass_functions(plan, flat, cam, req)
        ctx.state = (plan, flat, cam, seed, req, grad)
        if plan.compacted:
            return render_pass_compacted(flat, cam, seed, plan.sample0,
                                         pass_fn=fwd, **plan.common)
        return fwd(flat, cam, seed, plan.sample0, **plan.common)

    @staticmethod
    def backward(ctx, g):
        plan, flat, cam, seed, req, grad = ctx.state
        params = tuple(getattr(flat, n) for n in req.names)
        if req.adjoint:
            # every family at once; each requested tensor takes its own
            # (JAX train.py:207-216)
            _, grads = grad(flat, cam, seed, plan.sample0,
                            cotangent=g.to(torch.float32).contiguous(),
                            **plan.common)
            return (None, None, None, None) + tuple(grads[n]
                                                    for n in req.names)
        if not req.want_tex and not req.slots:
            # nothing requested exists in this scene (fuzz without a
            # metal): the gradient is identically zero (train.py:203-206)
            dg_tex = dg_hard = None
        else:
            g = g.to(torch.float32).contiguous()
            kw = dict(cotangent=g, hard_slots=req.slots,
                      want_tex=req.want_tex, **plan.common)
            if plan.compacted:
                _, dg_tex, dg_hard = render_pass_grad_compacted(
                    flat, cam, seed, plan.sample0, pass_fn=grad, **kw)
            else:
                _, dg_tex, dg_hard = grad(flat, cam, seed, plan.sample0,
                                          **kw)
        return (None, None, None, None) + _scatter_grads(req, params, dg_tex,
                                                         dg_hard)


class _SampleSum(torch.autograd.Function):
    """The shards of a tile summed over the mesh's "sample" axis: a plain
    all_reduce forward, the identity backward (this module's docstring
    says why: each rank differentiates its own shard, and
    all_reduce_grads sums the ranks' gradients once)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_grads(params, mesh: RenderMesh | None) -> None:
    """Sum each tensor's .grad over every rank of `mesh`, in place: the
    explicit gradient all_reduce of a mesh training step, run after the
    local backward (nothing to do on a mesh without a process group: one
    process, or a local shard)."""
    group = mesh.world_group() if mesh is not None else None
    if group is None:
        return
    for p in params:
        if p.grad is not None:
            p.grad.copy_(all_reduce_sum(p.grad, group))


def mesh_loss(img: torch.Tensor, target: torch.Tensor,
              mesh: RenderMesh | None) -> torch.Tensor:
    """The L2 loss of this rank's rows of the image against the whole
    (height, width, 3) target: torch.mean((img - target) ** 2) on a
    one-rank mesh; over a mesh, the tile's sum of squared errors over the
    image's entry count, whose sum over "tile" (reduce_loss) is the
    one-process loss."""
    if mesh is None or mesh.size == 1:
        return torch.mean((img - target) ** 2)
    h = img.shape[0]
    rows = target[mesh.tile * h:(mesh.tile + 1) * h]
    if rows.shape != img.shape or target.shape[0] != h * mesh.n_tile:
        raise ValueError(f"target {tuple(target.shape)} is not the image "
                         f"of {mesh.n_tile} tiles of {tuple(img.shape)}")
    return torch.sum((img - rows) ** 2) / target.numel()


def reduce_loss(loss: torch.Tensor, mesh: RenderMesh | None) -> torch.Tensor:
    """The whole image's loss from a rank's mesh_loss: its sum over the
    "tile" axis (detached)."""
    loss = loss.detach()
    return loss if mesh is None else all_reduce_sum(loss, mesh.group("tile"))


def _step_mesh(mesh: RenderMesh | None) -> RenderMesh | None:
    """mesh, refused where a step over it would be neither the shard's
    nor the image's: a layout of more than one rank without a process
    group (local_shard) has no group to merge its samples, its loss or
    its gradients over. A local shard is rendered through
    make_kernel_render."""
    if mesh is not None and mesh.size > 1 and mesh.device_mesh is None:
        raise ValueError(f"a {mesh.n_tile} x {mesh.n_sample} mesh without a "
                         "process group (a local shard) cannot take a "
                         "training step: use make_kernel_render(mesh=)")
    return mesh


def make_kernel_render(baked: FlatScene, *, width: int, height: int,
                       n_strata: int, max_depth: int,
                       sky_gradient: bool = False, engine: str = "auto",
                       adjoint_seg: int | None = None,
                       mesh: RenderMesh | None = None):
    """Differentiable render at kernel speed: (params, cam, seed) -> the
    (height, width, 3) image, the radiance sum over n_strata^2 samples
    divided by their count (JAX train.py:54-323). Over a mesh (a
    RenderMesh; None is one process) the image is this rank's rows of it,
    (height / n_tile, width, 3): its shard's sum merged over "sample"
    (_SampleSum) and divided by the image's count. height must be a
    multiple of n_tile and n_strata^2 of n_sample.

    params maps trainable field names (TRAINABLE_FIELDS) to tensors shaped
    as `baked`'s; the other scene tables are `baked`'s. The forward is the
    compacted schedule at >= 8 samples, else one pass; the backward, with
    the image cotangent, is the grad pass under the same rule over the
    requested families' slots (grad_slots), or for a request use_adjoint
    picks the adjoint pass (one uncapped pass of the sweep
    adjoint_sweep(adjoint_seg) gives: K9, or K10 at SEG > 0; a negative
    adjoint_seg raises here). cam and seed get no gradient. On the kernels
    a request none of them can serve raises NotImplementedError at its
    first call, before any pass. Over a mesh every pass is the shard's
    (its rows and samples; the schedule's rule and the caps take its
    sample count), and the gradients a backward leaves are this rank's
    part, which all_reduce_grads sums over the world."""
    eng = pick_engine(baked, engine)
    if tex_form(baked) == "suffix":
        # the JAX package's build-time notice (train.py:112-123)
        print(f"[INFO] tex_color backward: {baked.tex_color.shape[0]} "
              f"texture rows > MAX_GRAD_TEXS={MAX_GRAD_TEXS} selects the "
              "suffix-radiance estimator — exact, except channels with "
              "albedo exactly 0 report a 0 scatter-gradient (one-sided "
              "boundary); nudge dark initializations by epsilon if "
              "training from black", flush=True)
    total = n_strata * n_strata
    mesh = mesh or RenderMesh()
    row0, h_local, sample0, spp_local = mesh.shard(height, total)
    sample_group = mesh.group("sample")
    plan = _Plan(baked=baked, engine=eng,
                 common=dict(width=width, height=h_local, n_strata=n_strata,
                             max_depth=max_depth, n_samples=spp_local,
                             sky_gradient=sky_gradient, row0=row0),
                 compacted=spp_local >= COMPACT_MIN_SAMPLES,
                 adjoint_seg=adjoint_sweep(adjoint_seg), sample0=sample0)
    requests = {}       # the slots of each requested set of fields, once

    def render_image(params: dict, cam: CameraState, seed) -> torch.Tensor:
        check_fields(params)
        names = tuple(f for f in TRAINABLE_FIELDS if f in params)
        if names not in requests:
            slots = grad_slots(baked, names)
            want_tex = "tex_color" in names
            req = _Request(names, slots, use_adjoint(baked, slots, want_tex))
            # the adjoint's gate is the forward's, which pick_engine held
            reason = (grad_gate_reason(baked, len(slots), want_tex)
                      if eng == "cuda" and not req.adjoint else None)
            if reason is not None:
                raise NotImplementedError(
                    f"training {list(names)} on the kernels: {reason}; "
                    "engine='torch' runs the plain versions")
            requests[names] = req
        for n in names:
            want = getattr(baked, n)
            p = params[n]
            if p.shape != want.shape or p.device != baked.device:
                raise ValueError(f"{n} must be {tuple(want.shape)} on "
                                 f"{baked.device}, got {tuple(p.shape)} on "
                                 f"{p.device}")
        img = _KernelRender.apply(plan, cam, seed, requests[names],
                                  *(params[n] for n in names))
        if sample_group is not None:
            img = _SampleSum.apply(img, sample_group)
        return img / total

    return render_image


def make_train_step(optimizer: torch.optim.Optimizer, *, flat: FlatScene,
                    width: int, height: int, n_strata: int, max_depth: int,
                    sky_gradient: bool = False, engine: str = "auto",
                    adjoint_seg: int | None = None,
                    mesh: RenderMesh | None = None):
    """One optimizer step: params -> rendered image -> L2 loss -> update
    (JAX train.py:326-377, with a torch.optim optimizer in place of optax).

    `optimizer` holds the tensors of `params`; `flat` gives every other
    table; adjoint_seg the adjoint's sweep and mesh the rank's shard
    (make_kernel_render). Returns step(params, cam, seed, target) -> loss
    (a detached scalar, the loss before the update; target the whole
    image); the step updates params in place. Over a mesh the rank's
    gradients are summed over the world (all_reduce_grads) before the
    update, so every rank that starts from the same params takes the same
    step, and the loss is the whole image's on every rank. A mesh without
    a process group raises (_step_mesh)."""
    mesh = _step_mesh(mesh)
    render_image = make_kernel_render(
        flat, width=width, height=height, n_strata=n_strata,
        max_depth=max_depth, sky_gradient=sky_gradient, engine=engine,
        adjoint_seg=adjoint_seg, mesh=mesh)

    @spanned("rt.train.step")
    def step(params: dict, cam: CameraState, seed, target) -> torch.Tensor:
        with span("rt.train.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        with span("rt.train.forward"):
            img = render_image(params, cam, seed)
            loss = mesh_loss(img, target, mesh)
        with span("rt.train.backward"):
            loss.backward()
        all_reduce_grads(params.values(), mesh)
        with span("rt.train.optimizer"):
            optimizer.step()
        return reduce_loss(loss, mesh)

    return step


def render_loss_grad(flat: FlatScene, cam: CameraState, seed, target, *,
                     width: int, height: int, n_strata: int, max_depth: int,
                     sky_gradient: bool = False,
                     fields: tuple = ("tex_color",), engine: str = "auto",
                     adjoint_seg: int | None = None,
                     mesh: RenderMesh | None = None):
    """One-shot L2 loss and parameter gradients (no optimizer state):
    (loss, {field: gradient}); adjoint_seg and mesh as make_kernel_render's
    (target the whole image). Over a mesh the loss and gradients are the
    whole image's, summed over the ranks, on every rank; a mesh without a
    process group raises (_step_mesh)."""
    check_fields(fields)
    mesh = _step_mesh(mesh)
    params = {f: getattr(flat, f).detach().clone().requires_grad_(True)
              for f in fields}
    render_image = make_kernel_render(
        flat, width=width, height=height, n_strata=n_strata,
        max_depth=max_depth, sky_gradient=sky_gradient, engine=engine,
        adjoint_seg=adjoint_seg, mesh=mesh)
    loss = mesh_loss(render_image(params, cam, seed), target, mesh)
    loss.backward()
    all_reduce_grads(params.values(), mesh)
    return (reduce_loss(loss, mesh),
            {f: p.grad for f, p in params.items()})
