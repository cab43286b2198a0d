"""Vector math on stacked (..., 3) tensors (frozen copy of the port's
utils/vecmath.py). Every contraction is an elementwise product summed over
the last axis in x, y, z order, never a matmul (TF32 on a GPU)."""
from __future__ import annotations

import torch

EPS = 1e-8
T_MIN = 1e-3
BIG = 1e30


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def sqrt(x):
    """Correctly rounded sqrt: torch's float32 sqrt on the CPU is not, so
    there it goes through float64; on CUDA torch.sqrt already is."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def safe_sqrt(x, eps=1e-12):
    return sqrt(torch.clamp(x, min=eps))


def length(a):
    return sqrt(dot(a, a))


def normalize(a):
    return a / torch.clamp(length(a), min=EPS)[..., None]


def reflect(v, n):
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of unit vector uv about unit normal n."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = (
        -safe_sqrt(torch.abs(1.0 - dot(r_out_perp, r_out_perp)))[..., None]
        * n)
    return r_out_perp + r_out_parallel


def onb_from_w(w):
    """Orthonormal basis (u, v, w) from vector w."""
    w = normalize(w)
    big = (torch.abs(w[..., 0:1]) > 0.9)
    e_y = w.new_tensor([0.0, 1.0, 0.0])
    e_x = w.new_tensor([1.0, 0.0, 0.0])
    a = torch.where(big, e_y, e_x)
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_local(u, v, w, a):
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w


def where3(mask, a, b):
    return torch.where(mask[..., None], a, b)
