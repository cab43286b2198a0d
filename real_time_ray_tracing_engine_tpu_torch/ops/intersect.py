"""Vectorized ray-primitive intersection (brute force).

Port of the JAX package's ops/intersect.py (reference Sphere.cpp:32-143,
Plane.cpp:25-113, HittableList.cpp:26-42, ConstantMedium.cpp:25-96): every
ray tests every primitive row with masked arithmetic, one argmin picks the
closest hit (ties to the lowest prim id, spheres before quads), and the hit
record is rebuilt for the winning primitive only.

Shapes: rays are (N, 3) batches; per-primitive results are (N, P) planes
built from (N, 1) x (1, P) broadcasts in component form.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..utils.vecmath import dot, cross, safe_sqrt, sqrt, T_MIN, BIG
from ..scene.flat import FlatScene


@dataclass
class HitRecord:
    """Vectorized hit record (reference HitRecord, Hittable.hpp)."""
    hit: torch.Tensor          # (N,) bool
    t: torch.Tensor            # (N,)
    point: torch.Tensor        # (N, 3)
    normal: torch.Tensor       # (N, 3) faces against the ray
    front_face: torch.Tensor   # (N,) bool
    mat: torch.Tensor          # (N,) int64
    u: torch.Tensor            # (N,)
    v: torch.Tensor            # (N,)


# --------------------------------------------------------------- spheres
def _sphere_quadratic(center, cdelta, radius, org, dr, tm):
    """h, c, a for the sphere quadratic, elementwise over sphere terms
    (center, cdelta (..., 3), radius) and ray terms (org, dr (..., 3), tm)
    that broadcast together."""
    cx = center[..., 0] + tm * cdelta[..., 0]
    cy = center[..., 1] + tm * cdelta[..., 1]
    cz = center[..., 2] + tm * cdelta[..., 2]
    ocx = cx - org[..., 0]
    ocy = cy - org[..., 1]
    ocz = cz - org[..., 2]
    a = dot(dr, dr)
    h = dr[..., 0] * ocx + dr[..., 1] * ocy + dr[..., 2] * ocz
    c = (ocx * ocx + ocy * ocy + ocz * ocz
         - radius * radius)
    return h, c, a


def sphere_roots(center, cdelta, radius, active, org, dr, tm, t_min=T_MIN,
                 t_max=BIG):
    """The nearest valid quadratic root (BIG = miss), elementwise over
    sphere and ray terms that broadcast together: sphere_ts's (N, S) table,
    or one sphere a ray (the BVH walks' plain selections)."""
    h, c, a = _sphere_quadratic(center, cdelta, radius, org, dr, tm)
    disc = h * h - a * c
    ok = (disc > 0.0) & active & (radius > 0.0)
    sq = safe_sqrt(disc)
    r0 = (h - sq) / a
    r1 = (h + sq) / a
    in0 = (r0 > t_min) & (r0 < t_max)
    in1 = (r1 > t_min) & (r1 < t_max)
    t = torch.where(in0, r0, torch.where(in1, r1, BIG))
    return torch.where(ok & (in0 | in1), t, BIG)


def sphere_ts(center, cdelta, radius, active, org, dr, tm, t_min=T_MIN,
              t_max=BIG):
    """Nearest valid quadratic root per (ray, sphere); (N, S), BIG = miss."""
    return sphere_roots(center[None], cdelta[None], radius[None],
                        active[None], org[:, None], dr[:, None], tm[:, None],
                        t_min, t_max)


def sphere_both_ts(center, radius, org, dr, tm, cdelta=None):
    """Both roots over (-inf, inf) for medium boundary crossings
    (ConstantMedium.cpp:36-43). Returns (t0, t1), each (N, S)."""
    if cdelta is None:
        cdelta = torch.zeros_like(center)
    h, c, a = _sphere_quadratic(center[None], cdelta[None], radius[None],
                                org[:, None], dr[:, None], tm[:, None])
    disc = h * h - a * c
    ok = (disc > 0.0) & (radius > 0.0)[None, :]
    sq = safe_sqrt(disc)
    return (torch.where(ok, (h - sq) / a, BIG),
            torch.where(ok, (h + sq) / a, BIG))


def sphere_shade(center, cdelta, radius, org, dr, tm, t):
    """Geometry at parameter t for gathered sphere params (all (N, ...))."""
    p = org + t[:, None] * dr
    c_t = center + tm[:, None] * cdelta
    # a row of radius <= 0 (padding, or the clamped index of a lane that no
    # sphere won) is never a winner; it divides by 1 so that the discarded
    # branch stays finite under reverse mode (ops/adjoint_cuda.py)
    safe_r = torch.where(radius > 0.0, radius, 1.0)
    outward = (p - c_t) / torch.clamp(safe_r, min=1e-12)[:, None]
    front = dot(dr, outward) < 0.0
    n = torch.where(front[:, None], outward, -outward)
    # u, v take no derivative: no texture of this package reads them, and
    # arccos and atan2 have infinite slopes at the poles, where the adjoint
    # (ops/adjoint_cuda.py) would multiply its zero cotangent by them
    w = outward.detach()
    theta = torch.arccos(torch.clamp(-w[:, 1], -1.0, 1.0))
    phi = torch.atan2(-w[:, 2], w[:, 0]) + math.pi
    return p, n, front, phi / (2.0 * math.pi), theta / math.pi


# ----------------------------------------------------------------- quads
def quad_hits(corner, u, v, normal, d, w, active, org, dr, t_min=T_MIN,
              t_max=BIG, eps=1e-8):
    """Plane-equation hit + parallelogram inside test (BIG = miss),
    elementwise over quad terms (corner, u, v, normal, w (..., 3), d,
    active) and ray terms (org, dr (..., 3)) that broadcast together:
    quad_ts's (N, Q) table, or one quad a ray."""
    nxq, nyq, nzq = normal[..., 0], normal[..., 1], normal[..., 2]
    denom = dr[..., 0] * nxq + dr[..., 1] * nyq + dr[..., 2] * nzq
    parallel = torch.abs(denom) < eps
    o_dot_n = org[..., 0] * nxq + org[..., 1] * nyq + org[..., 2] * nzq
    t = (d - o_dot_n) / torch.where(parallel, 1.0, denom)
    plx = org[..., 0] + t * dr[..., 0] - corner[..., 0]
    ply = org[..., 1] + t * dr[..., 1] - corner[..., 1]
    plz = org[..., 2] + t * dr[..., 2] - corner[..., 2]
    vxq, vyq, vzq = v[..., 0], v[..., 1], v[..., 2]
    uxq, uyq, uzq = u[..., 0], u[..., 1], u[..., 2]
    wxq, wyq, wzq = w[..., 0], w[..., 1], w[..., 2]
    # alpha = w . (planar x v); beta = w . (u x planar)
    alpha = (wxq * (ply * vzq - plz * vyq)
             + wyq * (plz * vxq - plx * vzq)
             + wzq * (plx * vyq - ply * vxq))
    beta = (wxq * (uyq * plz - uzq * ply)
            + wyq * (uzq * plx - uxq * plz)
            + wzq * (uxq * ply - uyq * plx))
    inside = ((alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0)
              & (beta <= 1.0))
    ok = (~parallel) & inside & (t > t_min) & (t < t_max) & active
    return torch.where(ok, t, BIG)


def quad_ts(corner, u, v, normal, d, w, active, org, dr, t_min=T_MIN,
            t_max=BIG, eps=1e-8):
    """Plane-equation hit + parallelogram inside test; (N, Q), BIG = miss."""
    return quad_hits(corner[None], u[None], v[None], normal[None], d[None],
                     w[None], active[None], org[:, None], dr[:, None], t_min,
                     t_max, eps)


def quad_shade(corner, u, v, normal, w, org, dr, t):
    """Geometry at t for gathered quad params (all (N, ...))."""
    p = org + t[:, None] * dr
    planar = p - corner
    alpha = dot(w, cross(planar, v))
    beta = dot(w, cross(u, planar))
    front = dot(dr, normal) < 0.0
    n = torch.where(front[:, None], normal, -normal)
    return p, n, front, alpha, beta


# ----------------------------------------------------- closest hit (world)
def all_prim_ts(scene: FlatScene, org, dr, tm, t_min=T_MIN, t_max=BIG):
    """(N, S+Q) t table over the unified primitive space."""
    ts_s = sphere_ts(scene.sph_center, scene.sph_cdelta, scene.sph_radius,
                     scene.sph_active, org, dr, tm, t_min, t_max)
    ts_q = quad_ts(scene.quad_corner, scene.quad_u, scene.quad_v,
                   scene.quad_normal, scene.quad_d, scene.quad_w,
                   scene.quad_active, org, dr, t_min, t_max)
    return torch.cat([ts_s, ts_q], dim=1)


def shade_prim(scene: FlatScene, prim, org, dr, tm, t):
    """Rebuild the hit record for winning unified prim ids (N,)."""
    S = scene.sph_center.shape[0]
    is_sph = prim < S
    si = torch.clamp(prim, 0, S - 1)
    qi = torch.clamp(prim - S, 0, scene.quad_corner.shape[0] - 1)

    sp, sn, sf, su, sv = sphere_shade(
        scene.sph_center[si], scene.sph_cdelta[si], scene.sph_radius[si],
        org, dr, tm, t)
    qp, qn, qf, qu, qv = quad_shade(
        scene.quad_corner[qi], scene.quad_u[qi], scene.quad_v[qi],
        scene.quad_normal[qi], scene.quad_w[qi], org, dr, t)

    m = is_sph[:, None]
    point = torch.where(m, sp, qp)
    normal = torch.where(m, sn, qn)
    front = torch.where(is_sph, sf, qf)
    uu = torch.where(is_sph, su, qu)
    vv = torch.where(is_sph, sv, qv)
    mat = torch.where(is_sph, scene.sph_mat[si], scene.quad_mat[qi])
    return point, normal, front, uu, vv, mat.to(torch.int64)


def closest_hit(scene: FlatScene, org, dr, tm, t_min=T_MIN,
                t_max=BIG) -> HitRecord:
    """Brute-force closest hit over all active primitives."""
    ts = all_prim_ts(scene, org, dr, tm, t_min, t_max)
    # torch.min returns the first index of the minimum, as jnp.argmin does
    t, prim = torch.min(ts, dim=1)
    hit = t < BIG * 0.5
    ts_safe = torch.where(hit, t, 1.0)
    point, normal, front, uu, vv, mat = shade_prim(scene, prim, org, dr, tm,
                                                   ts_safe)
    return HitRecord(hit=hit, t=torch.where(hit, t, BIG), point=point,
                     normal=normal, front_face=front, mat=mat, u=uu, v=vv)


# ------------------------------------------------------- constant mediums
def medium_scatter(scene: FlatScene, org, dr, tm, t_surf, u_med,
                   t_min=T_MIN):
    """Exponential free-flight scattering inside medium boundaries
    (ConstantMedium.cpp:25-96: entry/exit crossings over the whole line,
    clamped to [t_min, t_surf], hit_distance = neg_inv_density * log(U)).

    u_med: (N, M) uniforms, one per medium per bounce.
    Returns (t_med (N,), mat (N,), valid (N,))."""
    M = scene.med_neg_inv_density.shape[0]
    raylen = sqrt(dot(dr, dr))                        # (N,)
    n = org.shape[0]
    s0, s1 = sphere_both_ts(scene.med_sph_center.reshape(-1, 3),
                            scene.med_sph_radius.reshape(-1),
                            org, dr, tm)                   # (N, M*MS) each
    ts_s = torch.stack([s0, s1], dim=2).reshape(n, M, -1)
    ts_q = quad_ts(scene.med_quad_corner.reshape(-1, 3),
                   scene.med_quad_u.reshape(-1, 3),
                   scene.med_quad_v.reshape(-1, 3),
                   scene.med_quad_normal.reshape(-1, 3),
                   scene.med_quad_d.reshape(-1),
                   scene.med_quad_w.reshape(-1, 3),
                   scene.med_quad_active.reshape(-1),
                   org, dr, t_min=-BIG, t_max=BIG).reshape(n, M, -1)
    ts = torch.cat([ts_s, ts_q], dim=2)              # (N, M, 2*MS+MQ)

    entry = ts.min(dim=2).values
    after = torch.where(ts > entry[..., None] + 1e-4, ts, BIG)
    exit_ = after.min(dim=2).values
    crossed = (entry < BIG * 0.5) & (exit_ < BIG * 0.5)

    t1 = torch.clamp(entry, min=t_min)
    t2 = torch.minimum(exit_, t_surf[:, None])
    span_ok = crossed & (t1 < t2) & scene.med_active[None, :]

    t2_safe = torch.where(span_ok, t2, t1 + 1.0)
    dist_inside = (t2_safe - t1) * raylen[:, None]
    hit_dist = scene.med_neg_inv_density[None, :] * torch.log(
        torch.clamp(u_med, min=1e-12))
    scatters = span_ok & (hit_dist < dist_inside)
    t_med = torch.where(scatters, t1 + hit_dist / raylen[:, None], BIG)

    t_best, best = torch.min(t_med, dim=1)
    valid = t_best < BIG * 0.5
    mat = scene.med_mat[best].to(torch.int64)
    return t_best, mat, valid
