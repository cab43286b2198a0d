"""Differentiable rendering: optimize scene parameters against target images.

Port of the JAX package's parallel/train.py, tex_color slice. The loss
forward renders with the forward kernel (K1, and K2 under the compacted
schedule); its backward is the forward-mode tex_color gradient kernel (K3)
under the compacted grad driver (K5): exact weight planes, dotted with the
image cotangent at every radiance event (ops/wavefront_cuda.py). Sampling
decisions use counter-based draws whose probabilities do not depend on
tex_color, so the gradient is that of the estimator with its samples held
fixed, as in the JAX package.

Only tex_color (albedo, emission, medium tint) trains in this package so
far. The other trainable families of the JAX package (metal fuzz,
dielectric IOR, sphere centers and radii) need the tangent-bundle kernel
(K4) or the adjoint kernels (K9/K10), which are not ported; asking for them
raises NotImplementedError on every engine. The JAX package's pure-JAX
replay and mixed tiers are not carried over: on the card they would be
hidden plain engines.

Engines, as models/render.pick_engine resolves them: "cuda" runs the
kernels (the scene on a CUDA device, inside kernel_gate_reason, or it
raises); "torch" runs their plain torch versions, the engine for the CPU
and, asked for by name, on the card; "auto" is "cuda" on a CUDA device and
"torch" on the CPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..scene.flat import FlatScene
from ..models.camera import CameraState
from ..models.render import pick_engine
from ..ops.wavefront_cuda import (grad_pass_function, pass_function,
                                  prepare_kernel, render_pass_compacted,
                                  render_pass_grad_compacted,
                                  render_pass_grad_reference,
                                  render_pass_reference)

# The JAX package's continuous, safely-differentiable scene parameters.
TRAINABLE_FIELDS = ("tex_color", "mat_fuzz", "mat_ior", "sph_center",
                    "sph_radius")
# the families whose backward kernels are not ported yet
HARD_FIELDS = ("mat_fuzz", "mat_ior", "sph_center", "sph_radius")
# a pass of at least this many samples takes the compacted schedule, as the
# JAX make_kernel_render does (train.py:136-146)
COMPACT_MIN_SAMPLES = 8


def get_params(flat: FlatScene, fields=TRAINABLE_FIELDS) -> dict:
    return {k: getattr(flat, k) for k in fields}


def set_params(flat: FlatScene, params: dict) -> FlatScene:
    return dataclasses.replace(flat, **params)


def check_fields(fields) -> None:
    """Raise unless `fields` is a set of trainable fields this package can
    differentiate: tex_color only, so far."""
    fields = set(fields)
    unknown = fields - set(TRAINABLE_FIELDS)
    if unknown:
        raise ValueError(f"unknown trainable fields {sorted(unknown)} "
                         f"(trainable: {TRAINABLE_FIELDS})")
    hard = fields & set(HARD_FIELDS)
    if hard:
        raise NotImplementedError(
            f"gradients of {sorted(hard)} need the tangent-bundle kernel "
            "(K4) or the adjoint kernels (K9/K10), which are not ported to "
            "this package yet; only tex_color trains so far")
    if "tex_color" not in fields:
        raise ValueError("no trainable field given: pass {'tex_color': ...}")


@dataclass(frozen=True)
class _Plan:
    """What a kernel render fixes at build time."""
    baked: FlatScene
    engine: str          # "cuda" | "torch"
    common: dict         # width, height, n_strata, max_depth, n_samples,
                         # sky_gradient
    compacted: bool


def _pass_functions(plan: _Plan, flat: FlatScene, cam: CameraState):
    """(forward pass, grad pass) for the plan's engine; the kernels share
    one packing of the scene (once per step)."""
    if plan.engine == "cuda":
        prep = prepare_kernel(flat, cam)
        return (pass_function(flat, cam, prep),
                grad_pass_function(flat, cam, prep))
    return render_pass_reference, render_pass_grad_reference


class _KernelRender(torch.autograd.Function):
    """tex_color -> the (height, width, 3) radiance-sum image; its backward
    is the grad pass with the image cotangent."""

    @staticmethod
    def forward(ctx, tex_color, plan: _Plan, cam: CameraState, seed):
        flat = set_params(plan.baked, {"tex_color": tex_color})
        fwd, grad = _pass_functions(plan, flat, cam)
        ctx.state = (plan, flat, cam, seed, grad)
        if plan.compacted:
            return render_pass_compacted(flat, cam, seed, 0, pass_fn=fwd,
                                         **plan.common)
        return fwd(flat, cam, seed, 0, **plan.common)

    @staticmethod
    def backward(ctx, g):
        plan, flat, cam, seed, grad = ctx.state
        g = g.to(torch.float32).contiguous()
        if plan.compacted:
            _, dg = render_pass_grad_compacted(flat, cam, seed, 0,
                                               cotangent=g, pass_fn=grad,
                                               **plan.common)
        else:
            _, dg = grad(flat, cam, seed, 0, cotangent=g, **plan.common)
        return dg, None, None, None


def make_kernel_render(baked: FlatScene, *, width: int, height: int,
                       n_strata: int, max_depth: int,
                       sky_gradient: bool = False, engine: str = "auto"):
    """Differentiable render at kernel speed: (params, cam, seed) -> the
    (height, width, 3) image, the radiance sum over n_strata^2 samples
    divided by their count (JAX train.py:54-323, one shard).

    params is {"tex_color": (NT, 3) tensor}; the other scene tables are
    `baked`'s. The forward is the compacted schedule at >= 8 samples, else
    one pass; the backward is the grad pass under the same rule, with the
    image cotangent. cam and seed get no gradient."""
    eng = pick_engine(baked, engine)
    total = n_strata * n_strata
    plan = _Plan(baked=baked, engine=eng,
                 common=dict(width=width, height=height, n_strata=n_strata,
                             max_depth=max_depth, n_samples=total,
                             sky_gradient=sky_gradient),
                 compacted=total >= COMPACT_MIN_SAMPLES)

    def render_image(params: dict, cam: CameraState, seed) -> torch.Tensor:
        check_fields(params)
        tex = params["tex_color"]
        if tex.shape != baked.tex_color.shape or tex.device != baked.device:
            raise ValueError(f"tex_color must be {tuple(baked.tex_color.shape)}"
                             f" on {baked.device}, got {tuple(tex.shape)} on "
                             f"{tex.device}")
        return _KernelRender.apply(tex, plan, cam, seed) / total

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
