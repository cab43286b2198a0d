"""Hash-based Perlin gradient noise, bit-exact with the JAX package's
utils/perlin.py.

Each lattice corner's gradient is PCG4D(corner, seed) mapped to a
normalized vector in [-1, 1]^3 (the distribution of the reference's
256-entry tables, PerlinNoise.hpp:19-26), with Hermite-faded trilinear
interpolation (PerlinNoise.hpp:140-205) and 7-octave |noise| turbulence
(:67-79). The same arithmetic runs in the CUDA kernel (csrc/wavefront.cu),
so noise scenes compare per pixel.

All functions take component tensors (px, py, pz) of any common shape and a
u32 seed (python int or integer tensor).
"""
from __future__ import annotations

import torch

from .rng import _pcg4d, _to_unit, u32, MASK32

TURB_DEPTH = 7          # reference PerlinNoise.hpp:67-79


def _corner_gradient(ix, iy, iz, seed):
    """Gradient at integer lattice corner (ix, iy, iz) (int64 lattice
    coordinates, taken as their int32 bit patterns)."""
    a, b, c, _ = _pcg4d(ix & MASK32, iy & MASK32, iz & MASK32,
                        torch.broadcast_to(seed, ix.shape))
    gx = 2.0 * _to_unit(a) - 1.0
    gy = 2.0 * _to_unit(b) - 1.0
    gz = 2.0 * _to_unit(c) - 1.0
    inv = torch.rsqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-12))
    return gx * inv, gy * inv, gz * inv


def noise3(px, py, pz, seed):
    """Gradient noise in [-1, 1]."""
    seed = u32(seed, px.device)
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    # int32 lattice coordinates, as the JAX package's astype(int32)
    ix = fx.to(torch.int32).to(torch.int64)
    iy = fy.to(torch.int32).to(torch.int64)
    iz = fz.to(torch.int32).to(torch.int64)
    u, v, w = px - fx, py - fy, pz - fz
    su = u * u * (3.0 - 2.0 * u)
    sv = v * v * (3.0 - 2.0 * v)
    sw = w * w * (3.0 - 2.0 * w)

    acc = torch.zeros_like(u)
    for di in (0, 1):
        wu = su if di else 1.0 - su
        for dj in (0, 1):
            wv = sv if dj else 1.0 - sv
            for dk in (0, 1):
                ww = sw if dk else 1.0 - sw
                gx, gy, gz = _corner_gradient(ix + di, iy + dj, iz + dk,
                                              seed)
                d = (gx * (u - di) + gy * (v - dj) + gz * (w - dk))
                acc = acc + (wu * wv * ww) * d
    return acc


def turbulence3(px, py, pz, seed, depth: int = TURB_DEPTH):
    """Sum of |noise| octaves; octave o hashes with seed + o * golden."""
    seed = u32(seed, px.device)
    acc = torch.zeros_like(px)
    weight = 1.0
    qx, qy, qz = px, py, pz
    for o in range(depth):
        s_o = (seed + ((o * 0x9E3779B9) & MASK32)) & MASK32
        acc = acc + weight * torch.abs(noise3(qx, qy, qz, s_o))
        weight = weight * 0.5
        qx, qy, qz = qx * 2.0, qy * 2.0, qz * 2.0
    return acc


def turbulence(p, seed=0, depth: int = TURB_DEPTH):
    """turbulence3 of (..., 3) points."""
    return turbulence3(p[..., 0], p[..., 1], p[..., 2], seed, depth)
