"""Differentiable rendering: optimize scene parameters against target images.

Port of the JAX package's parallel/train.py (one shard, no mesh). The loss
forward renders with the forward kernel (K1, and K2 under the compacted
schedule); its backward is the forward-mode gradient kernel under the
compacted grad driver (K5) over every trainable family: tex_color
(albedo, emission, medium tint) by exact weight planes (K3), and the hard
families (metal fuzz, dielectric IOR, sphere centers and radii) by one
tangent bundle per scalar slot (K4), both dotted with the image cotangent
at every radiance event (ops/wavefront_cuda.py). Sampling decisions use
counter-based draws whose probabilities do not depend on the parameters,
so the gradient is that of the estimator with its samples held fixed
(reparameterized through intersection t for geometry), as in the JAX
package.

The tier policy is the JAX package's (train.py:161-306): fewer than
ADJOINT_MIN_SLOTS hard slots run the tangent bundles; from that many the
JAX package runs the adjoint kernels (K9/K10), which are not ported, so
such a request raises NotImplementedError. The JAX package's pure-JAX
replay and mixed tiers are not carried over: on the card they would be
hidden plain engines.

Engines, as models/render.pick_engine resolves them: "cuda" runs the
kernels (the scene on a CUDA device, inside kernel_gate_reason, or it
raises); "torch" runs their plain torch versions, the engine for the CPU
and, asked for by name, on the card; "auto" is "cuda" on a CUDA device and
"torch" on the CPU. The grad kernels take the unrolled (Cornell-class)
scenes only: on "cuda" a scene past those bounds, which the forward renders
through the chunk scan (K6/K7), raises NotImplementedError naming the grad
kernel it needs (grad_gate_reason: K3/K4 on the vscan selection, K8 or
K9/K10, not ported) before any pass runs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..scene.flat import FlatScene
from ..models.camera import CameraState
from ..models.render import pick_engine
from ..ops.wavefront_cuda import (HARD_FIELDS, grad_gate_reason,
                                  grad_pass_function, hard_param_slots,
                                  kernel_mode, pass_function,
                                  prepare_kernel, render_pass_compacted,
                                  render_pass_grad_compacted,
                                  render_pass_grad_reference,
                                  render_pass_reference, slot_index)

# The JAX package's continuous, safely-differentiable scene parameters.
TRAINABLE_FIELDS = ("tex_color", "mat_fuzz", "mat_ior", "sph_center",
                    "sph_radius")
# from this many hard slots the JAX package trains with the adjoint kernels
# (K9/K10, not ported), below it with the tangent bundles (train.py:43)
ADJOINT_MIN_SLOTS = 33
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
    requested hard families only (JAX train.py:174-175). Raises
    NotImplementedError from ADJOINT_MIN_SLOTS slots, the adjoint tier's
    share, whose kernels (K9/K10) are not ported."""
    hard = set(fields) & set(HARD_FIELDS)
    slots = hard_param_slots(flat, hard) if hard else ()
    if len(slots) >= ADJOINT_MIN_SLOTS:
        raise NotImplementedError(
            f"{len(slots)} hard slots of {sorted(hard)}: from "
            f"{ADJOINT_MIN_SLOTS} slots the JAX package trains with the "
            "adjoint kernels (K9/K10), which are not ported to this package "
            "yet; request fewer hard families or train tex_color alone")
    return slots


@dataclass(frozen=True)
class _Plan:
    """What a kernel render fixes at build time."""
    baked: FlatScene
    engine: str          # "cuda" | "torch"
    common: dict         # width, height, n_strata, max_depth, n_samples,
                         # sky_gradient
    compacted: bool


@dataclass(frozen=True)
class _Request:
    """What one call differentiates: the param names in TRAINABLE_FIELDS
    order and the hard slots of their families."""
    names: tuple
    slots: tuple

    @property
    def want_tex(self) -> bool:
        return "tex_color" in self.names


def _pass_functions(plan: _Plan, flat: FlatScene, cam: CameraState,
                    slots: tuple):
    """(forward pass, grad pass) for the plan's engine; the kernels share
    one packing of the scene and the slot table (once per step)."""
    if plan.engine == "cuda":
        prep = prepare_kernel(flat, cam, slots)
        return (pass_function(flat, cam, prep),
                grad_pass_function(flat, cam, prep))
    return render_pass_reference, render_pass_grad_reference


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
        fwd, grad = _pass_functions(plan, flat, cam, req.slots)
        ctx.state = (plan, flat, cam, seed, req, grad)
        if plan.compacted:
            return render_pass_compacted(flat, cam, seed, 0, pass_fn=fwd,
                                         **plan.common)
        return fwd(flat, cam, seed, 0, **plan.common)

    @staticmethod
    def backward(ctx, g):
        plan, flat, cam, seed, req, grad = ctx.state
        params = tuple(getattr(flat, n) for n in req.names)
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
                    flat, cam, seed, 0, pass_fn=grad, **kw)
            else:
                _, dg_tex, dg_hard = grad(flat, cam, seed, 0, **kw)
        return (None, None, None, None) + _scatter_grads(req, params, dg_tex,
                                                         dg_hard)


def make_kernel_render(baked: FlatScene, *, width: int, height: int,
                       n_strata: int, max_depth: int,
                       sky_gradient: bool = False, engine: str = "auto"):
    """Differentiable render at kernel speed: (params, cam, seed) -> the
    (height, width, 3) image, the radiance sum over n_strata^2 samples
    divided by their count (JAX train.py:54-323, one shard).

    params maps trainable field names (TRAINABLE_FIELDS) to tensors shaped
    as `baked`'s; the other scene tables are `baked`'s. The forward is the
    compacted schedule at >= 8 samples, else one pass; the backward is the
    grad pass under the same rule, with the image cotangent, over the
    requested families' slots (grad_slots, which raises from
    ADJOINT_MIN_SLOTS). cam and seed get no gradient. On the kernels a
    scene outside grad_gate_reason raises NotImplementedError here."""
    eng = pick_engine(baked, engine)
    if eng == "cuda" and kernel_mode(baked)[0] != "unrolled":
        raise NotImplementedError(
            f"training on the kernels: {grad_gate_reason(baked)}; "
            "engine='torch' runs the plain versions")
    total = n_strata * n_strata
    plan = _Plan(baked=baked, engine=eng,
                 common=dict(width=width, height=height, n_strata=n_strata,
                             max_depth=max_depth, n_samples=total,
                             sky_gradient=sky_gradient),
                 compacted=total >= COMPACT_MIN_SAMPLES)
    requests = {}       # the slots of each requested set of fields, once

    def render_image(params: dict, cam: CameraState, seed) -> torch.Tensor:
        check_fields(params)
        names = tuple(f for f in TRAINABLE_FIELDS if f in params)
        if names not in requests:
            requests[names] = _Request(names, grad_slots(baked, names))
        for n in names:
            want = getattr(baked, n)
            p = params[n]
            if p.shape != want.shape or p.device != baked.device:
                raise ValueError(f"{n} must be {tuple(want.shape)} on "
                                 f"{baked.device}, got {tuple(p.shape)} on "
                                 f"{p.device}")
        return _KernelRender.apply(plan, cam, seed, requests[names],
                                   *(params[n] for n in names)) / total

    return render_image


def make_train_step(optimizer: torch.optim.Optimizer, *, flat: FlatScene,
                    width: int, height: int, n_strata: int, max_depth: int,
                    sky_gradient: bool = False, engine: str = "auto"):
    """One optimizer step: params -> rendered image -> L2 loss -> update
    (JAX train.py:326-377, with a torch.optim optimizer in place of optax).

    `optimizer` holds the tensors of `params`; `flat` gives every other
    table. Returns step(params, cam, seed, target) -> loss (a detached
    scalar, the loss before the update); the step updates params in
    place."""
    render_image = make_kernel_render(
        flat, width=width, height=height, n_strata=n_strata,
        max_depth=max_depth, sky_gradient=sky_gradient, engine=engine)

    def step(params: dict, cam: CameraState, seed, target) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        img = render_image(params, cam, seed)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def render_loss_grad(flat: FlatScene, cam: CameraState, seed, target, *,
                     width: int, height: int, n_strata: int, max_depth: int,
                     sky_gradient: bool = False,
                     fields: tuple = ("tex_color",), engine: str = "auto"):
    """One-shot L2 loss and parameter gradients (no optimizer state):
    (loss, {field: gradient})."""
    check_fields(fields)
    params = {f: getattr(flat, f).detach().clone().requires_grad_(True)
              for f in fields}
    render_image = make_kernel_render(
        flat, width=width, height=height, n_strata=n_strata,
        max_depth=max_depth, sky_gradient=sky_gradient, engine=engine)
    loss = torch.mean((render_image(params, cam, seed) - target) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))
