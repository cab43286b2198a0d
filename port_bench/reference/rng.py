"""Counter-based RNG: PCG4D over (pixel, sample, mixed seed, tag counter).

Frozen copy of the port's utils/rng.py. The u32 streams live in int64
tensors holding values in [0, 2^32); every operation masks back to 32 bits,
and `_mul32` splits the multiplier into 16-bit halves so that no partial
product leaves int64. Uniforms come out in float32 (the top 24 bits, exact)
and are cast to the caller's dtype.
"""
from __future__ import annotations

import math

import torch

from .vecmath import sqrt

N_DRAWS = 9
(D_PICK, D_LIGHT_SEL, D_LIGHT_U, D_LIGHT_V, D_MAT_U, D_MAT_V,
 D_FUZZ_U, D_FUZZ_V, D_REFL) = range(N_DRAWS)

_GOLDEN = 0x9E3779B9
MASK32 = 0xFFFFFFFF
_PCG_MUL = 1664525
_PCG_ADD = 1013904223


def _mul32(a, b):
    """(a * b) mod 2^32 for u32 values held in int64 (either may be a
    python int)."""
    if isinstance(b, int):
        a, b = b, a
    if isinstance(a, int) and isinstance(b, int):
        return (a * b) & MASK32
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def u32(x, device=None) -> torch.Tensor:
    """Any integer tensor/int -> int64 tensor of its u32 bit pattern."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def pcg4d(a, b, c, d):
    """PCG4D mixing of four u32 streams -> four decorrelated u32 outputs."""
    a = (_mul32(a, _PCG_MUL) + _PCG_ADD) & MASK32
    b = (_mul32(b, _PCG_MUL) + _PCG_ADD) & MASK32
    c = (_mul32(c, _PCG_MUL) + _PCG_ADD) & MASK32
    d = (_mul32(d, _PCG_MUL) + _PCG_ADD) & MASK32
    a = (a + _mul32(b, d)) & MASK32
    b = (b + _mul32(c, a)) & MASK32
    c = (c + _mul32(a, b)) & MASK32
    d = (d + _mul32(b, c)) & MASK32
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + _mul32(b, d)) & MASK32
    b = (b + _mul32(c, a)) & MASK32
    c = (c + _mul32(a, b)) & MASK32
    d = (d + _mul32(b, c)) & MASK32
    return a, b, c, d


def to_unit(u):
    """u32 -> float32 in [0, 1) from the top 24 bits (exact in f32)."""
    return (u >> 8).to(torch.float32) * (1.0 / 16777216.0)


def mix_seed(seed) -> int:
    """The per-render key word: seed * golden + 0x85EBCA6B (mod 2^32)."""
    return (int(seed) * _GOLDEN + 0x85EBCA6B) & MASK32


def ray_keys(seed, pixel_ids, sample_ids):
    """Per-ray counter state (N, 3) int64 u32 words: [pixel, sample, mixed
    seed]. sample_ids may be a tensor or an int."""
    pixel_ids = u32(pixel_ids)
    sample_ids = torch.broadcast_to(u32(sample_ids, pixel_ids.device),
                                    pixel_ids.shape)
    k2 = torch.full_like(pixel_ids, mix_seed(seed))
    return torch.stack([pixel_ids, sample_ids, k2], dim=-1)


def uniforms(keys, tag, shape_suffix=(), dtype=torch.float32):
    """(N, *suffix) U[0,1) draws for an integer tag (an int, or a tensor
    broadcasting against keys[..., 0])."""
    (n,) = shape_suffix if shape_suffix else (1,)
    tag = u32(tag, keys.device)
    outs = []
    for blk in range(-(-n // 4)):
        ctr = (_mul32(tag, 0x193) + blk) & MASK32
        ctr = torch.broadcast_to(ctr, keys[..., 0].shape)
        a, b, c, d = pcg4d(keys[..., 0], keys[..., 1], keys[..., 2], ctr)
        outs += [to_unit(a), to_unit(b), to_unit(c), to_unit(d)]
    out = torch.stack(outs[:n], dim=-1).to(dtype)
    if not shape_suffix:
        return out[..., 0]
    return out


def bounce_uniforms(keys, bounce, n=N_DRAWS, dtype=torch.float32):
    """One (N, n) block of U[0,1) draws for a bounce."""
    return uniforms(keys, 0x4000000 + u32(bounce, keys.device), (n,), dtype)


def unit_vector_from_uv(u1, u2):
    """Uniform point on the unit sphere from two uniforms."""
    z = 1.0 - 2.0 * u1
    r = sqrt(torch.clamp(1.0 - z * z, min=1e-12))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def cosine_direction_from_uv(u1, u2):
    """Cosine-weighted hemisphere direction, local z-up frame."""
    phi = 2.0 * math.pi * u1
    sq2 = sqrt(torch.clamp(u2, min=1e-12))
    z = sqrt(torch.clamp(1.0 - u2, min=1e-12))
    return torch.stack([torch.cos(phi) * sq2, torch.sin(phi) * sq2, z],
                       dim=-1)


def in_unit_disk_from_uv(u1, u2):
    """Uniform point in the unit disk (defocus sampling)."""
    r = sqrt(u1)
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
