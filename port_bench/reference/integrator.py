"""The plain path-tracing integrator: frozen copies of the port's
ops/intersect.py, ops/materials.py, ops/lights.py, ops/textures.py,
utils/perlin.py and ops/integrator.py, in the dtype of the scene tables.

One bounce (the reference engine's Camera.cpp:232-309): a miss takes the
background; front-face emitters add their emission; metal and dielectric
scatter specularly (skip_pdf); Lambertian and isotropic hits sample the
MIS mixture of the light list and the material pdf, guarded by pdf > 1e-8.
Constant mediums compete with the closest surface. The closest hit picks
its winner from a table computed without autograd and recomputes only the
winner's t with autograd (package docstring).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .vecmath import (dot, cross, normalize, reflect, refract, onb_from_w,
                      onb_local, safe_sqrt, sqrt, where3, T_MIN, BIG)
from . import rng
from .scene import (FlatScene, MAT_METAL, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT,
                    MAT_ISOTROPIC, TEX_CHECKER, TEX_NOISE)

INV_4PI = 1.0 / (4.0 * math.pi)
TURB_DEPTH = 7
TABLE_BUDGET = 1 << 27      # rays x primitives of one block's t table


# ----------------------------------------------------------- Perlin noise
def _corner_gradient(ix, iy, iz, seed, dtype):
    a, b, c, _ = rng.pcg4d(ix & rng.MASK32, iy & rng.MASK32, iz & rng.MASK32,
                           torch.broadcast_to(seed, ix.shape))
    gx = (2.0 * rng.to_unit(a) - 1.0).to(dtype)
    gy = (2.0 * rng.to_unit(b) - 1.0).to(dtype)
    gz = (2.0 * rng.to_unit(c) - 1.0).to(dtype)
    inv = torch.rsqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-12))
    return gx * inv, gy * inv, gz * inv


def _noise3(px, py, pz, seed):
    seed = rng.u32(seed, px.device)
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
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
                                              seed, px.dtype)
                d = (gx * (u - di) + gy * (v - dj) + gz * (w - dk))
                acc = acc + (wu * wv * ww) * d
    return acc


def _turbulence(p, seed, depth: int = TURB_DEPTH):
    seed = rng.u32(seed, p.device)
    qx, qy, qz = p[..., 0], p[..., 1], p[..., 2]
    acc = torch.zeros_like(qx)
    weight = 1.0
    for o in range(depth):
        s_o = (seed + ((o * 0x9E3779B9) & rng.MASK32)) & rng.MASK32
        acc = acc + weight * torch.abs(_noise3(qx, qy, qz, s_o))
        weight = weight * 0.5
        qx, qy, qz = qx * 2.0, qy * 2.0, qz * 2.0
    return acc


# --------------------------------------------------------------- textures
def _resolve_checker(scene: FlatScene, tidx, p):
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


def texture_value(scene: FlatScene, tidx, p):
    leaf = _resolve_checker(scene, tidx.to(torch.int64), p)
    solid = scene.tex_color[leaf]
    if not scene.has_noise:
        return solid
    turb = _turbulence(p, scene.perlin_seed)
    g = 0.5 * (1.0 + torch.sin(scene.tex_scale[leaf] * p[..., 2]
                               + 10.0 * turb))
    noise = g[..., None].expand(*g.shape, 3)
    return torch.where((scene.tex_type[leaf] == TEX_NOISE)[..., None],
                       noise, solid)


# ----------------------------------------------------------- intersection
@dataclass
class HitRecord:
    hit: torch.Tensor
    t: torch.Tensor
    point: torch.Tensor
    normal: torch.Tensor
    front_face: torch.Tensor
    mat: torch.Tensor


def _sphere_quadratic(center, cdelta, radius, org, dr, tm):
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
    sphere and ray terms that broadcast together."""
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
    return sphere_roots(center[None], cdelta[None], radius[None],
                        active[None], org[:, None], dr[:, None], tm[:, None],
                        t_min, t_max)


def _sphere_both_ts(center, radius, org, dr, tm):
    cdelta = torch.zeros_like(center)
    h, c, a = _sphere_quadratic(center[None], cdelta[None], radius[None],
                                org[:, None], dr[:, None], tm[:, None])
    disc = h * h - a * c
    ok = (disc > 0.0) & (radius > 0.0)[None, :]
    sq = safe_sqrt(disc)
    return (torch.where(ok, (h - sq) / a, BIG),
            torch.where(ok, (h + sq) / a, BIG))


def quad_hits(corner, u, v, normal, d, w, active, org, dr, t_min=T_MIN,
              t_max=BIG, eps=1e-8):
    """Plane-equation hit + parallelogram inside test (BIG = miss),
    elementwise over quad and ray terms that broadcast together."""
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
    return quad_hits(corner[None], u[None], v[None], normal[None], d[None],
                     w[None], active[None], org[:, None], dr[:, None], t_min,
                     t_max, eps)


def _sphere_shade(center, cdelta, radius, org, dr, tm, t):
    p = org + t[:, None] * dr
    c_t = center + tm[:, None] * cdelta
    safe_r = torch.where(radius > 0.0, radius, 1.0)
    outward = (p - c_t) / torch.clamp(safe_r, min=1e-12)[:, None]
    front = dot(dr, outward) < 0.0
    n = torch.where(front[:, None], outward, -outward)
    return p, n, front


def _quad_shade(normal, org, dr, t):
    p = org + t[:, None] * dr
    front = dot(dr, normal) < 0.0
    n = torch.where(front[:, None], normal, -normal)
    return p, n, front


def _winners(scene: FlatScene, org, dr, tm):
    """(t, prim) of the closest active primitive (the first index of the
    minimum, spheres before quads), without autograd, in blocks of rays
    whose t table holds at most TABLE_BUDGET entries."""
    step = max(1, TABLE_BUDGET // max(1, scene.n_prims))
    ts, ps = [], []
    with torch.no_grad():
        for a in range(0, org.shape[0], step):
            o, d, t = org[a:a + step], dr[a:a + step], tm[a:a + step]
            tab = torch.cat([
                sphere_ts(scene.sph_center, scene.sph_cdelta,
                          scene.sph_radius, scene.sph_active, o, d, t),
                quad_ts(scene.quad_corner, scene.quad_u, scene.quad_v,
                        scene.quad_normal, scene.quad_d, scene.quad_w,
                        scene.quad_active, o, d)], dim=1)
            t_min, prim = torch.min(tab, dim=1)
            ts.append(t_min)
            ps.append(prim)
    return torch.cat(ts), torch.cat(ps)


def closest_hit(scene: FlatScene, org, dr, tm) -> HitRecord:
    """Closest hit over every active primitive: the winner from a table
    without autograd (_winners), its t recomputed with autograd."""
    S = scene.sph_center.shape[0]
    t_tab, prim = _winners(scene, org, dr, tm)
    hit = t_tab < BIG * 0.5
    is_sph = prim < S
    si = torch.clamp(prim, 0, S - 1)
    qi = torch.clamp(prim - S, 0, scene.quad_corner.shape[0] - 1)
    if torch.is_grad_enabled():
        t_s = sphere_roots(scene.sph_center[si], scene.sph_cdelta[si],
                           scene.sph_radius[si], scene.sph_active[si],
                           org, dr, tm)
        t_q = quad_hits(scene.quad_corner[qi], scene.quad_u[qi],
                        scene.quad_v[qi], scene.quad_normal[qi],
                        scene.quad_d[qi], scene.quad_w[qi],
                        scene.quad_active[qi], org, dr)
        t = torch.where(is_sph, t_s, t_q)
    else:
        t = t_tab
    ts_safe = torch.where(hit, t, 1.0)
    sp, sn, sf = _sphere_shade(scene.sph_center[si], scene.sph_cdelta[si],
                               scene.sph_radius[si], org, dr, tm, ts_safe)
    qp, qn, qf = _quad_shade(scene.quad_normal[qi], org, dr, ts_safe)
    m = is_sph[:, None]
    mat = torch.where(is_sph, scene.sph_mat[si], scene.quad_mat[qi])
    return HitRecord(hit=hit, t=torch.where(hit, t, BIG),
                     point=torch.where(m, sp, qp),
                     normal=torch.where(m, sn, qn),
                     front_face=torch.where(is_sph, sf, qf),
                     mat=mat.to(torch.int64))


def medium_scatter(scene: FlatScene, org, dr, tm, t_surf, u_med,
                   t_min=T_MIN):
    """Exponential free-flight scattering inside medium boundaries
    (ConstantMedium.cpp:25-96). Returns (t_med, mat, valid)."""
    M = scene.med_neg_inv_density.shape[0]
    raylen = sqrt(dot(dr, dr))
    n = org.shape[0]
    s0, s1 = _sphere_both_ts(scene.med_sph_center.reshape(-1, 3),
                             scene.med_sph_radius.reshape(-1), org, dr, tm)
    ts_s = torch.stack([s0, s1], dim=2).reshape(n, M, -1)
    ts_q = quad_ts(scene.med_quad_corner.reshape(-1, 3),
                   scene.med_quad_u.reshape(-1, 3),
                   scene.med_quad_v.reshape(-1, 3),
                   scene.med_quad_normal.reshape(-1, 3),
                   scene.med_quad_d.reshape(-1),
                   scene.med_quad_w.reshape(-1, 3),
                   scene.med_quad_active.reshape(-1),
                   org, dr, t_min=-BIG, t_max=BIG).reshape(n, M, -1)
    ts = torch.cat([ts_s, ts_q], dim=2)
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
    return t_best, scene.med_mat[best].to(torch.int64), valid


def resolve_hit(scene: FlatScene, org, dr, tm, u_med) -> HitRecord:
    rec = closest_hit(scene, org, dr, tm)
    if scene.n_mediums == 0:
        return rec
    t_surf = torch.where(rec.hit, rec.t, BIG)
    t_med, med_mat, med_valid = medium_scatter(scene, org, dr, tm, t_surf,
                                               u_med)
    t_med_safe = torch.where(med_valid, t_med, 1.0)
    point_m = org + t_med_safe[:, None] * dr
    arb_n = dr.new_tensor([1.0, 0.0, 0.0]).expand_as(dr)
    return HitRecord(
        hit=rec.hit | med_valid, t=torch.where(med_valid, t_med, rec.t),
        point=where3(med_valid, point_m, rec.point),
        normal=where3(med_valid, arb_n, rec.normal),
        front_face=rec.front_face | med_valid,
        mat=torch.where(med_valid, med_mat, rec.mat))


# -------------------------------------------------------------- materials
def _schlick(cosine, ri):
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def _scatter(scene: FlatScene, rec: HitRecord, in_dir, u):
    """(attenuation, scatters, skip_pdf, skip_dir, is_isotropic)."""
    mat, normal, front_face = rec.mat, rec.normal, rec.front_face
    mtype = scene.mat_type[mat]
    tex = texture_value(scene, scene.mat_tex[mat], rec.point)
    is_metal = mtype == MAT_METAL
    is_diel = mtype == MAT_DIELECTRIC
    is_light = mtype == MAT_DIFFUSE_LIGHT

    fuzz = scene.mat_fuzz[mat]
    refl = normalize(reflect(in_dir, normal))
    jitter = rng.unit_vector_from_uv(u[:, rng.D_FUZZ_U], u[:, rng.D_FUZZ_V])
    metal_dir = normalize(refl + fuzz[:, None] * jitter)
    metal_ok = dot(metal_dir, normal) > 0.0

    ior = scene.mat_ior[mat]
    ri = torch.where(front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp(dot(-in_dir, normal), max=1.0)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot = ri * sin_theta > 1.0
    do_reflect = cannot | (_schlick(cos_theta, ri) > u[:, rng.D_REFL])
    diel_dir = where3(do_reflect, normalize(reflect(in_dir, normal)),
                      normalize(refract(in_dir, normal, ri)))

    attenuation = torch.where(is_diel[:, None], 1.0, tex)
    scatters = ~is_light & ~(is_metal & ~metal_ok)
    skip_pdf = is_metal | is_diel
    skip_dir = where3(is_metal, metal_dir, diel_dir)
    return attenuation, scatters, skip_pdf, skip_dir, mtype == MAT_ISOTROPIC


def _material_pdf_sample(normal, is_iso, u1, u2):
    bu, bv, bw = onb_from_w(normal)
    cos_dir = onb_local(bu, bv, bw, rng.cosine_direction_from_uv(u1, u2))
    sph_dir = rng.unit_vector_from_uv(u1, u2)
    return where3(is_iso, sph_dir, normalize(cos_dir))


def _material_pdf_value(normal, is_iso, out_dir):
    """The material sampler's pdf, which is also the BSDF's density
    (Lambertian cos/pi, isotropic 1/4pi)."""
    cosv = torch.clamp(dot(out_dir, normal), min=0.0) / math.pi
    return torch.where(is_iso, INV_4PI, cosv)


# ----------------------------------------------------------------- lights
def _gather_light(scene: FlatScene, l):
    S = scene.sph_center.shape[0]
    prim = scene.light_prim[l].to(torch.int64)
    is_sph = prim < S
    si = torch.clamp(prim, 0, S - 1)
    qi = torch.clamp(prim - S, 0, scene.quad_corner.shape[0] - 1)
    return is_sph, si, qi


def _light_pdf_value(scene: FlatScene, org, dr, tm):
    """Uniform average over lights of each light's solid-angle pdf."""
    L = scene.light_prim.shape[0]
    is_sph, si, qi = _gather_light(scene, torch.arange(L, device=org.device))
    ones = torch.ones_like(is_sph)
    ts = sphere_ts(scene.sph_center[si], scene.sph_cdelta[si],
                   scene.sph_radius[si], ones, org, dr, tm, T_MIN, BIG)
    cen, cd = scene.sph_center[si], scene.sph_cdelta[si]
    tmn = tm[:, None]
    ocx = cen[None, :, 0] + tmn * cd[None, :, 0] - org[:, 0:1]
    ocy = cen[None, :, 1] + tmn * cd[None, :, 1] - org[:, 1:2]
    ocz = cen[None, :, 2] + tmn * cd[None, :, 2] - org[:, 2:3]
    dist2 = ocx * ocx + ocy * ocy + ocz * ocz
    r = scene.sph_radius[si][None, :]
    ratio = torch.clamp(1.0 - r * r / torch.clamp(dist2, min=1e-12),
                        0.0, 1.0)
    solid = 2.0 * math.pi * (1.0 - safe_sqrt(ratio))
    hit_s = ts < BIG * 0.5
    solid_safe = torch.where(hit_s, torch.clamp(solid, min=1e-12), 1.0)
    pdf_s = torch.where(hit_s, 1.0 / solid_safe, 0.0)

    tq = quad_ts(scene.quad_corner[qi], scene.quad_u[qi], scene.quad_v[qi],
                 scene.quad_normal[qi], scene.quad_d[qi], scene.quad_w[qi],
                 ones, org, dr, T_MIN, BIG)
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
    pdfs = torch.where(scene.light_active[None, :],
                       torch.where(is_sph[None, :], pdf_s, pdf_q), 0.0)
    total = pdfs[:, 0]
    for l in range(1, pdfs.shape[1]):
        total = total + pdfs[:, l]
    return total / max(scene.n_lights, 1)


def _light_sample(scene: FlatScene, org, tm, u_sel, u1, u2):
    n = max(scene.n_lights, 1)
    l = torch.clamp((u_sel * n).to(torch.int32), 0, n - 1).to(torch.int64)
    is_sph, si, qi = _gather_light(scene, l)
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
    pt = (scene.quad_corner[qi] + u1[:, None] * scene.quad_u[qi]
          + u2[:, None] * scene.quad_v[qi])
    d = torch.where(is_sph[:, None], dir_s, pt - org)
    return normalize(d)


# ------------------------------------------------------------- integrator
def sky_color(dr):
    a = 0.5 * (dr[..., 1] + 1.0)
    blue = dr.new_tensor([0.5, 0.7, 1.0])
    return (1.0 - a)[..., None] + a[..., None] * blue


def bounce_step(scene: FlatScene, org, dr, tm, throughput, alive, u, u_med,
                background, sky_gradient: bool):
    """One estimator bounce: (radiance increment, org, dr, throughput,
    alive); paths that end keep their last state."""
    rec = resolve_hit(scene, org, dr, tm, u_med)
    bg = sky_color(dr) if sky_gradient else background.expand_as(dr)
    miss = alive & ~rec.hit
    drad = torch.where(miss[:, None], throughput * bg, 0.0)

    mtype = scene.mat_type[rec.mat]
    on = (mtype == MAT_DIFFUSE_LIGHT) & rec.front_face
    emit = torch.where(on[:, None], texture_value(
        scene, scene.mat_tex[rec.mat], rec.point), 0.0)
    live_hit = alive & rec.hit
    drad = drad + torch.where(live_hit[:, None], throughput * emit, 0.0)

    att, scatters, skip_pdf, skip_dir, is_iso = _scatter(scene, rec, dr, u)
    mat_dir = _material_pdf_sample(rec.normal, is_iso, u[:, rng.D_MAT_U],
                                   u[:, rng.D_MAT_V])
    if scene.n_lights > 0:
        l_dir = _light_sample(scene, rec.point, tm, u[:, rng.D_LIGHT_SEL],
                              u[:, rng.D_LIGHT_U], u[:, rng.D_LIGHT_V])
        mis_dir = where3(u[:, rng.D_PICK] < 0.5, l_dir, mat_dir)
        pdf_val = 0.5 * _light_pdf_value(scene, rec.point, mis_dir, tm) \
            + 0.5 * _material_pdf_value(rec.normal, is_iso, mis_dir)
    else:
        mis_dir = mat_dir
        pdf_val = _material_pdf_value(rec.normal, is_iso, mis_dir)

    spdf = _material_pdf_value(rec.normal, is_iso, mis_dir)
    pdf_ok = pdf_val > 1e-8
    factor = torch.where(skip_pdf, 1.0,
                         spdf / torch.where(pdf_ok, pdf_val, 1.0))
    new_dir = where3(skip_pdf, skip_dir, mis_dir)
    alive = live_hit & scatters & (skip_pdf | pdf_ok)
    throughput = torch.where(alive[:, None],
                             throughput * att * factor[:, None], throughput)
    return (drad, where3(alive, rec.point, org), where3(alive, new_dir, dr),
            throughput, alive)


def trace(scene: FlatScene, org, dr, tm, keys, background, *,
          max_depth: int = 50, sky_gradient: bool = False,
          return_lengths: bool = False):
    """Radiance (N, 3) of N camera rays; with return_lengths also the (N,)
    count of bounce iterations each path was alive for (the bounces a
    kernel lane traces for it). Each bounce runs on the paths still alive
    only (gathered by index): every path sees the same arithmetic as in
    the port's loop over all of them, whose ended paths add exactly 0."""
    dr = normalize(dr)
    n = org.shape[0]
    radiance = torch.zeros_like(org)
    length = torch.zeros(n, device=org.device)
    idx = torch.arange(n, device=org.device)
    throughput = torch.ones_like(org)
    m_pad = scene.med_neg_inv_density.shape[0]
    for bounce in range(max_depth):
        if idx.numel() == 0:
            break
        length = length.index_add(0, idx, torch.ones_like(length[idx]))
        k = keys.index_select(0, idx)
        u = rng.bounce_uniforms(k, bounce, dtype=org.dtype)
        u_med = (rng.uniforms(k, 1_000_000 + bounce, (m_pad,), org.dtype)
                 if scene.n_mediums else None)
        live = torch.ones(idx.shape[0], dtype=torch.bool, device=org.device)
        drad, org, dr, throughput, alive = bounce_step(
            scene, org, dr, tm, throughput, live, u, u_med, background,
            sky_gradient)
        radiance = radiance.index_add(0, idx, drad)
        keep = alive.nonzero().squeeze(1)
        idx = idx.index_select(0, keep)
        org, dr = org.index_select(0, keep), dr.index_select(0, keep)
        tm = tm.index_select(0, keep)
        throughput = throughput.index_select(0, keep)
    if return_lengths:
        return radiance, length
    return radiance
