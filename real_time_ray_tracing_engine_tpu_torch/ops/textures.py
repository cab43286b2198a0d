"""Texture evaluation over the flattened texture table.

Port of the JAX package's ops/textures.py (reference Texture.cuh:89-113,
CheckerTexture.cpp:14-55, NoiseTexture.cpp:8-33): gather each ray's texture
row, descend nested checker chains (bounded by the static
scene.checker_depth) to a solid or noise leaf, evaluate the leaf.
"""
from __future__ import annotations

import torch

from ..scene.flat import FlatScene, TEX_CHECKER, TEX_NOISE
from ..utils import perlin


def _noise_value(scene: FlatScene, scale, p):
    """Marble: 0.5*(1 + sin(scale*z + 10*turb(p, 7)))."""
    turb = perlin.turbulence(p, scene.perlin_seed, depth=7)
    g = 0.5 * (1.0 + torch.sin(scale * p[..., 2] + 10.0 * turb))
    return g[..., None].expand(*g.shape, 3)


def _base_value(scene: FlatScene, tidx, p):
    """Solid-or-noise leaf evaluation."""
    solid = scene.tex_color[tidx]
    if not scene.has_noise:
        return solid
    ttype = scene.tex_type[tidx]
    noise = _noise_value(scene, scene.tex_scale[tidx], p)
    return torch.where((ttype == TEX_NOISE)[..., None], noise, solid)


def resolve_checker(scene: FlatScene, tidx, p):
    """Descend checker chains until every lane's index is a leaf row:
    parity of floor(p / scale) picks the even or odd child."""
    for _ in range(scene.checker_depth):
        ttype = scene.tex_type[tidx]
        scale = scene.tex_scale[tidx]
        inv = 1.0 / torch.clamp(scale, min=1e-12)
        fl = torch.floor(inv[..., None] * p).to(torch.int32)
        even = (fl[..., 0] + fl[..., 1] + fl[..., 2]) % 2 == 0
        child = torch.where(even, scene.tex_child_even[tidx],
                            scene.tex_child_odd[tidx])
        tidx = torch.where(ttype == TEX_CHECKER, child.to(tidx.dtype), tidx)
    return tidx


def texture_value(scene: FlatScene, tidx, u, v, p):
    """Color of texture rows `tidx` (N,) at surface points p (N, 3)."""
    leaf = resolve_checker(scene, tidx.to(torch.int64), p)
    return _base_value(scene, leaf, p)


def effective_row(scene: FlatScene, tidx, p):
    """The tex_color row that a lookup of rows `tidx` at points p reads:
    the checker leaf, or -1 where the leaf is noise (a marble has no
    tex_color dependence). The JAX kernel's eff_tex (texture_color)."""
    leaf = resolve_checker(scene, tidx.to(torch.int64), p)
    if not scene.has_noise:
        return leaf
    return torch.where(scene.tex_type[leaf] == TEX_NOISE, -1, leaf)
