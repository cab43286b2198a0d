"""Vector math on stacked (..., 3) float32 tensors.

Port of the JAX package's utils/vecmath.py (the reference's Vec3 / ONB
helpers, src/utils/math/Vec3Utility.hpp, ONB.hpp). Every contraction is an
elementwise product summed over the last axis — never a matmul, which on a
GPU may run in TF32 and lose the ~1-unit accuracy that plane-equation tests
on Cornell-sized coordinates need (the JAX package's `edot` pins
Precision.HIGHEST for the same reason on the TPU).
"""
from __future__ import annotations

import torch

EPS = 1e-8
# Shadow-ray epsilon; the reference uses 0.001 (src/core/camera/Camera.cpp:242).
T_MIN = 1e-3
BIG = 1e30


def dot(a, b):
    """x, y, z products summed in that order — the order the CUDA kernel
    uses, so both round alike (a reduction kernel may sum in another)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def sqrt(x):
    """Correctly rounded sqrt. torch's float32 sqrt on the CPU is not (about
    0.7% of inputs land one ulp off, and an element's rounding can depend
    on the thread split); the float64 sqrt of a float32, rounded to
    float32, is correctly rounded for every float32 input, as the JAX
    package's sqrt on XLA:CPU and numpy's are. On CUDA torch.sqrt already
    is. Autograd runs through either."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def safe_sqrt(x, eps=1e-12):
    """sqrt(max(x, eps))."""
    return sqrt(torch.clamp(x, min=eps))


def length_squared(a):
    return dot(a, a)


def length(a):
    return sqrt(length_squared(a))


def normalize(a):
    return a / torch.clamp(length(a), min=EPS)[..., None]


def reflect(v, n):
    """Mirror reflection (reference: Vec3Utility.hpp reflect)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of unit vector uv about unit normal n."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = (
        -safe_sqrt(torch.abs(1.0 - length_squared(r_out_perp)))[..., None]
        * n)
    return r_out_perp + r_out_parallel


def onb_from_w(w):
    """Orthonormal basis (u, v, w) from vector w (reference ONB.hpp:19-65)."""
    w = normalize(w)
    big = (torch.abs(w[..., 0:1]) > 0.9)
    e_y = w.new_tensor([0.0, 1.0, 0.0])
    e_x = w.new_tensor([1.0, 0.0, 0.0])
    a = torch.where(big, e_y, e_x)
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_local(u, v, w, a):
    """Transform local-space vector a into the (u, v, w) world basis."""
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w


def where3(mask, a, b):
    """Select (..., 3) vectors by a (...,) mask."""
    return torch.where(mask[..., None], a, b)
