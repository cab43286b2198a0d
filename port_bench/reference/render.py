"""What the benchmark asks of its reference: radiance sums of chosen pixels,
path lengths, and the training step's loss, gradients and Adam update,
each worked out from the scene file and the benchmark's own inputs.

Rays run in blocks of whole pixels (every sample of a pixel in one block)
of at most BLOCK_RAYS rays, which bounds a gradient block's autograd
graph; the intersection table is bounded inside the integrator.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import camera as cam_mod
from . import rng
from .integrator import trace

BLOCK_RAYS = 1 << 20


def _block_pixels(n_samples: int) -> int:
    return max(1, BLOCK_RAYS // max(1, n_samples))


def _rays(cam, width, pix, samples, seed, n_strata):
    """The rays of pixels `pix` (P,) at every sample of `samples` (a list),
    pixel-major."""
    s = torch.tensor(samples, device=pix.device, dtype=torch.int64)
    p = pix.repeat_interleave(len(samples))
    s = s.repeat(pix.shape[0])
    keys = rng.ray_keys(seed, p, s)
    org, dr, tm = cam_mod.generate_rays(cam, width, p, s, n_strata, keys)
    return org, dr, tm, keys


def pixel_sums(flat, cam, *, width: int, pix, samples, seed: int,
               n_strata: int, max_depth: int, sky_gradient: bool,
               lengths: bool = False):
    """(P, 3) float32 radiance of pixels `pix` summed over `samples`; with
    lengths=True instead the (P,) bounce iterations summed over them."""
    out = torch.zeros(pix.shape[0], 3, device=pix.device)
    out_len = torch.zeros(pix.shape[0], device=pix.device)
    step = _block_pixels(len(samples))
    with torch.no_grad():
        for a in range(0, pix.shape[0], step):
            px = pix[a:a + step]
            org, dr, tm, keys = _rays(cam, width, px, samples, seed,
                                      n_strata)
            rad, ln = trace(flat, org, dr, tm, keys, cam.background,
                            max_depth=max_depth, sky_gradient=sky_gradient,
                            return_lengths=True)
            out[a:a + step] = rad.view(px.shape[0], len(samples), 3).sum(
                1).float()
            out_len[a:a + step] = ln.view(px.shape[0], len(samples)).sum(1)
    return out_len if lengths else out


def mean_path_length(flat, cam, *, width: int, pix, samples, seed: int,
                     n_strata: int, max_depth: int, sky_gradient: bool
                     ) -> float:
    """Bounce iterations a path, over pixels `pix` at `samples`."""
    ln = pixel_sums(flat, cam, width=width, pix=pix, samples=samples,
                    seed=seed, n_strata=n_strata, max_depth=max_depth,
                    sky_gradient=sky_gradient, lengths=True)
    return float(ln.sum()) / (pix.shape[0] * len(samples))


def image(flat, cam, *, width: int, height: int, seed: int, n_strata: int,
          max_depth: int, sky_gradient: bool):
    """The (height, width, 3) float32 image: every pixel's mean over the
    n_strata^2 samples."""
    total = n_strata * n_strata
    pix = torch.arange(width * height, device=flat.device)
    s = pixel_sums(flat, cam, width=width, pix=pix, samples=range(total),
                   seed=seed, n_strata=n_strata, max_depth=max_depth,
                   sky_gradient=sky_gradient)
    return (s / total).view(height, width, 3)


def loss_grad(flat, params: dict, cam, target, *, width: int, height: int,
              seed: int, n_strata: int, max_depth: int, sky_gradient: bool,
              rows=None, scale: float = 1.0):
    """(loss, {field: gradient}) of mean((image - target)^2) with `params`
    in place of the scene's fields. Pixels run in blocks, each with all of
    its samples; a block's squared errors over the image's entry count are
    its share of the loss, so its backward is its share of the gradient.
    Two faults for the checks' own tests: rows=(r0, r1) takes the loss
    over those image rows only, as a mean over them (part of the batch
    dropped); scale multiplies the image (an answer altered)."""
    total = n_strata * n_strata
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    scene = dataclasses.replace(flat, **leaves)
    r0, r1 = rows if rows is not None else (0, height)
    pix_all = torch.arange(r0 * width, r1 * width, device=flat.device)
    numel = pix_all.shape[0] * 3
    tgt = target.reshape(-1, 3)
    loss = torch.zeros((), dtype=torch.float64, device=flat.device)
    step = _block_pixels(total)
    for a in range(0, pix_all.shape[0], step):
        px = pix_all[a:a + step]
        org, dr, tm, keys = _rays(cam, width, px, range(total), seed,
                                  n_strata)
        with torch.enable_grad():
            rad = trace(scene, org, dr, tm, keys, cam.background,
                        max_depth=max_depth, sky_gradient=sky_gradient)
            img = rad.view(px.shape[0], total, 3).sum(1) / total * scale
            part = ((img.float() - tgt[px]) ** 2).sum() / numel
            part.backward()
        loss += part.detach().double()
    return float(loss), {k: v.grad.detach() for k, v in leaves.items()}


class Adam:
    """torch.optim.Adam's update, written out: per parameter group a
    learning rate; betas (0.9, 0.999), eps 1e-8, no weight decay."""

    def __init__(self, lrs: dict, betas=(0.9, 0.999), eps=1e-8):
        self.lrs, self.betas, self.eps = dict(lrs), betas, eps
        self.m, self.v, self.t = {}, {}, 0

    def step(self, params: dict, grads: dict) -> dict:
        b1, b2 = self.betas
        self.t += 1
        bc1 = 1 - b1 ** self.t
        bc2_sqrt = math.sqrt(1 - b2 ** self.t)
        out = {}
        for k, p in params.items():
            g = grads[k]
            m = self.m.get(k, torch.zeros_like(p))
            v = self.v.get(k, torch.zeros_like(p))
            self.m[k] = m = b1 * m + (1 - b1) * g
            self.v[k] = v = b2 * v + (1 - b2) * g * g
            denom = torch.sqrt(v) / bc2_sqrt + self.eps
            out[k] = p - (self.lrs[k] / bc1) * m / denom
        return out
