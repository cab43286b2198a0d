"""Path-tracing integrator in plain torch.

Port of the JAX package's ops/integrator.py (reference Camera.cpp:232-309,
ray_color_cuda CameraKernels.cu:106-202). `bounce_step` is one bounce of the
estimator for a batch of rays:

  1. miss -> background color                          (Camera.cpp:242-243)
  2. radiance += throughput * emitted (front-face emitters)       (:246-254)
  3. no scatter -> path terminates                                (:253-254)
  4. specular (skip_pdf): throughput *= attenuation               (:260-262)
  5. else MIS: dir ~ 0.5*HittablePDF(lights) + 0.5*material PDF,
     throughput *= attenuation * scattering_pdf(dir) / mixture_pdf(dir),
     with the CUDA guard pdf > 1e-8             (:269-304, CameraKernels:192)

Constant mediums compete with the closest surface hit each bounce. `trace`
loops it over max_depth bounces for rays that share a bounce index; the
lane wavefront (ops/wavefront_cuda.py) calls it with a per-lane bounce
index and regenerates finished lanes.
"""
from __future__ import annotations

import torch

from ..utils.vecmath import normalize, where3, BIG
from ..utils import rng
from ..scene.flat import FlatScene, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT
from . import materials as mat_ops
from .bvh import closest_hit_bvh
from .intersect import HitRecord, closest_hit, medium_scatter
from .lights import light_pdf_value, light_sample
from .textures import effective_row


def sky_color(dr):
    """RTiOW gradient sky: lerp white -> light blue on unit dir y."""
    a = 0.5 * (dr[..., 1] + 1.0)
    blue = dr.new_tensor([0.5, 0.7, 1.0])
    return (1.0 - a)[..., None] + a[..., None] * blue


def resolve_hit(scene: FlatScene, org, dr, tm, u_med) -> HitRecord:
    """Closest surface hit (through the BVH on a use_bvh scene, as the JAX
    package's _resolve_hit), then let mediums preempt it."""
    if scene.use_bvh:
        rec = closest_hit_bvh(scene, org, dr, tm)
    else:
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
        hit=rec.hit | med_valid,
        t=torch.where(med_valid, t_med, rec.t),
        point=where3(med_valid, point_m, rec.point),
        normal=where3(med_valid, arb_n, rec.normal),
        front_face=rec.front_face | med_valid,
        mat=torch.where(med_valid, med_mat, rec.mat),
        u=torch.where(med_valid, 0.0, rec.u),
        v=torch.where(med_valid, 0.0, rec.v))


def medium_uniforms(scene: FlatScene, keys, bounce):
    """One free-flight draw per medium row (tag 1_000_000 + bounce), or
    None for a medium-free scene."""
    if not scene.n_mediums:
        return None
    m_pad = scene.med_neg_inv_density.shape[0]
    return rng.uniforms(keys, 1_000_000 + rng.u32(bounce, keys.device),
                        (m_pad,))


def bounce_step(scene: FlatScene, org, dr, tm, throughput, alive, u, u_med,
                background, sky_gradient: bool, record: bool = False):
    """One estimator bounce for N rays (dr unit; u (N, N_DRAWS)).

    Returns (radiance increment (N, 3), org, dr, throughput, alive): rays
    whose path ends here keep their origin, direction and throughput. With
    record=True a sixth item, the per-bounce record the tex_color gradient
    needs, under the JAX kernel's names (wavefront_pallas.py:2565-2603):
    miss, sb (background), emit_on, tcol (emitted color), at
    (attenuation), eff_tex (the tex_color row the hit reads, -1 for noise),
    is_diel, factor (MIS weight, 1 for specular), live_hit. The returned
    alive is the guard of the throughput update."""
    rec = resolve_hit(scene, org, dr, tm, u_med)

    # 1. miss -> background
    bg = sky_color(dr) if sky_gradient else background.expand_as(dr)
    miss = alive & ~rec.hit
    drad = torch.where(miss[:, None], throughput * bg, 0.0)

    # 2. emitted
    emit = mat_ops.emitted(scene, rec.mat, rec.u, rec.v, rec.point,
                           rec.front_face)
    live_hit = alive & rec.hit
    drad = drad + torch.where(live_hit[:, None], throughput * emit, 0.0)

    # 3-5. scatter
    sc = mat_ops.scatter(scene, rec.mat, dr, rec.normal, rec.front_face,
                         rec.u, rec.v, rec.point, u[:, rng.D_FUZZ_U],
                         u[:, rng.D_FUZZ_V], u[:, rng.D_REFL])
    mat_dir = mat_ops.material_pdf_sample(rec.normal, sc.is_isotropic,
                                          u[:, rng.D_MAT_U],
                                          u[:, rng.D_MAT_V])
    if scene.n_lights > 0:
        l_dir = light_sample(scene, rec.point, tm, u[:, rng.D_LIGHT_SEL],
                             u[:, rng.D_LIGHT_U], u[:, rng.D_LIGHT_V])
        pick_light = u[:, rng.D_PICK] < 0.5
        mis_dir = where3(pick_light, l_dir, mat_dir)
        pdf_val = 0.5 * light_pdf_value(scene, rec.point, mis_dir, tm) \
            + 0.5 * mat_ops.material_pdf_value(rec.normal, sc.is_isotropic,
                                               mis_dir)
    else:
        mis_dir = mat_dir
        pdf_val = mat_ops.material_pdf_value(rec.normal, sc.is_isotropic,
                                             mis_dir)

    spdf = mat_ops.scattering_pdf(rec.normal, sc.is_isotropic, mis_dir)
    pdf_ok = pdf_val > 1e-8
    mis_factor = spdf / torch.where(pdf_ok, pdf_val, 1.0)
    factor = torch.where(sc.skip_pdf, 1.0, mis_factor)
    new_dir = where3(sc.skip_pdf, sc.skip_dir, mis_dir)
    alive = live_hit & sc.scatters & (sc.skip_pdf | pdf_ok)
    # a path that ends keeps its last state, as the CUDA kernel's carry does
    throughput = torch.where(alive[:, None],
                             throughput * sc.attenuation * factor[:, None],
                             throughput)
    new_org = where3(alive, rec.point, org)
    new_dr = where3(alive, new_dir, dr)
    if not record:
        return drad, new_org, new_dr, throughput, alive
    mtype = scene.mat_type[rec.mat]
    event = dict(
        miss=miss, sb=bg, live_hit=live_hit,
        emit_on=live_hit & (mtype == MAT_DIFFUSE_LIGHT) & rec.front_face,
        tcol=emit, at=sc.attenuation,
        eff_tex=effective_row(scene, scene.mat_tex[rec.mat], rec.point),
        is_diel=mtype == MAT_DIELECTRIC, factor=factor)
    return drad, new_org, new_dr, throughput, alive, event


def trace(scene: FlatScene, org, dr, tm, keys, background, *,
          max_depth: int = 50, sky_gradient: bool = False,
          return_lengths: bool = False):
    """Radiance (N, 3) of N camera rays (dr need not be unit); keys (N, 3)
    from rng.ray_keys. Paths alive after max_depth bounces contribute
    nothing further (Camera.cpp:236-237). With return_lengths also the (N,)
    float32 count of bounce iterations each path was alive for (its
    wavefront work, the bounces a kernel lane traces for it): what
    utils/profiling.py::path_lengths and the plain engine's bounce total
    (models/render.py::_render_pass) read. The loop stops once every path
    has ended; the bounces left would add nothing to the radiance or the
    counts."""
    dr = normalize(dr)
    throughput = torch.ones_like(org)
    radiance = torch.zeros_like(org)
    alive = torch.ones(org.shape[0], dtype=torch.bool, device=org.device)
    length = torch.zeros_like(radiance[:, 0]) if return_lengths else None
    for bounce in range(max_depth):
        if not bool(alive.any()):
            break
        if return_lengths:
            length = length + alive.to(length.dtype)
        u = rng.bounce_uniforms(keys, bounce)
        u_med = medium_uniforms(scene, keys, bounce)
        drad, org, dr, throughput, alive = bounce_step(
            scene, org, dr, tm, throughput, alive, u, u_med, background,
            sky_gradient)
        radiance = radiance + drad
    if return_lengths:
        return radiance, length
    return radiance
