"""MIS light sampling over the scene's light list.

Port of the JAX package's ops/lights.py (reference HittablePDF, PDF.hpp:
86-124, Sphere.cpp:145-188 cone sampling and solid-angle pdf, Plane.cpp:
115-133 area sampling). Light rows reference unified prim ids; the world
`active` mask is ignored, since lights are sampling targets, not occluders.
"""
from __future__ import annotations

import math

import torch

from ..utils.vecmath import dot, normalize, onb_from_w, onb_local, \
    safe_sqrt, T_MIN, BIG
from ..scene.flat import FlatScene
from .intersect import sphere_ts, quad_ts


def _gather_light(scene: FlatScene, l):
    """Split light prim ids into sphere / quad gather indices."""
    S = scene.sph_center.shape[0]
    prim = scene.light_prim[l].to(torch.int64)
    is_sph = prim < S
    si = torch.clamp(prim, 0, S - 1)
    qi = torch.clamp(prim - S, 0, scene.quad_corner.shape[0] - 1)
    return prim, is_sph, si, qi


def light_pdf_values(scene: FlatScene, org, dr, tm):
    """Solid-angle pdf of direction dr (unit) from org toward each light;
    (N, L)."""
    L = scene.light_prim.shape[0]
    _, is_sph, si, qi = _gather_light(
        scene, torch.arange(L, device=org.device))
    ones = torch.ones_like(is_sph)

    # sphere lights: hit test, then 1/solid-angle (Sphere.cpp:145-158)
    ts = sphere_ts(scene.sph_center[si], scene.sph_cdelta[si],
                   scene.sph_radius[si], ones, org, dr, tm, T_MIN, BIG)
    cen, cd = scene.sph_center[si], scene.sph_cdelta[si]
    tmn = tm[:, None]
    ocx = cen[None, :, 0] + tmn * cd[None, :, 0] - org[:, 0:1]
    ocy = cen[None, :, 1] + tmn * cd[None, :, 1] - org[:, 1:2]
    ocz = cen[None, :, 2] + tmn * cd[None, :, 2] - org[:, 2:3]
    dist2 = ocx * ocx + ocy * ocy + ocz * ocz               # (N, L)
    r = scene.sph_radius[si][None, :]
    ratio = torch.clamp(1.0 - r * r / torch.clamp(dist2, min=1e-12),
                        0.0, 1.0)
    cos_max = safe_sqrt(ratio)
    solid = 2.0 * math.pi * (1.0 - cos_max)
    hit_s = ts < BIG * 0.5
    solid_safe = torch.where(hit_s, torch.clamp(solid, min=1e-12), 1.0)
    pdf_s = torch.where(hit_s, 1.0 / solid_safe, 0.0)

    # quad lights: hit test, then dist^2 / (cos * area) (Plane.cpp:115-126)
    tq = quad_ts(scene.quad_corner[qi], scene.quad_u[qi], scene.quad_v[qi],
                 scene.quad_normal[qi], scene.quad_d[qi], scene.quad_w[qi],
                 ones, org, dr, T_MIN, BIG)                 # (N, L)
    qn = scene.quad_normal[qi]
    cosine = torch.abs(dr[:, 0:1] * qn[None, :, 0]
                       + dr[:, 1:2] * qn[None, :, 1]
                       + dr[:, 2:3] * qn[None, :, 2])
    hit_q = tq < BIG * 0.5
    tq_safe = torch.where(hit_q, tq, 1.0)
    pdf_q = torch.where(
        hit_q,
        tq_safe * tq_safe
        / torch.clamp(cosine * scene.quad_area[qi][None, :], min=1e-12),
        0.0)

    pdf = torch.where(is_sph[None, :], pdf_s, pdf_q)
    return torch.where(scene.light_active[None, :], pdf, 0.0)


def light_pdf_value(scene: FlatScene, org, dr, tm):
    """Uniform average over lights (HittableList.cpp:44-56); (N,)."""
    pdfs = light_pdf_values(scene, org, dr, tm)
    n = max(scene.n_lights, 1)
    # summed light by light, in the CUDA kernel's order
    total = pdfs[:, 0]
    for l in range(1, pdfs.shape[1]):
        total = total + pdfs[:, l]
    return total / n


def light_sample(scene: FlatScene, org, tm, u_sel, u1, u2):
    """Unit direction toward a uniformly chosen light
    (HittableList.cpp:58-64); (N, 3)."""
    n = max(scene.n_lights, 1)
    l = torch.clamp((u_sel * n).to(torch.int32), 0, n - 1).to(torch.int64)
    _, is_sph, si, qi = _gather_light(scene, l)

    # sphere: cone sampling in an ONB toward the center (Sphere.cpp:160-188)
    c_t = scene.sph_center[si] + tm[:, None] * scene.sph_cdelta[si]
    to_c = c_t - org
    dist2 = torch.clamp(dot(to_c, to_c), min=1e-12)
    r = scene.sph_radius[si]
    ratio = torch.clamp(1.0 - r * r / dist2, 0.0, 1.0)
    z = 1.0 + u2 * (safe_sqrt(ratio) - 1.0)
    phi = 2.0 * math.pi * u1
    s = safe_sqrt(1.0 - z * z)
    local = torch.stack([torch.cos(phi) * s, torch.sin(phi) * s, z], dim=-1)
    bu, bv, bw = onb_from_w(to_c)
    dir_s = onb_local(bu, bv, bw, local)

    # quad: uniform area point (Plane.cpp:128-133)
    pt = (scene.quad_corner[qi] + u1[:, None] * scene.quad_u[qi]
          + u2[:, None] * scene.quad_v[qi])
    dir_q = pt - org

    d = torch.where(is_sph[:, None], dir_s, dir_q)
    return normalize(d)
