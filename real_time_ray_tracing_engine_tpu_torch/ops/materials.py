"""Material shading over the flattened material table.

Port of the JAX package's ops/materials.py (reference Material.cuh:204-266):
all five material families are evaluated with masked arithmetic and
selected by type code, following the reference ScatterRecord contract —
emission only from DiffuseLight front faces (DiffuseLightMaterial.cpp:12-23),
deterministic specular directions for metal and dielectric (skip_pdf,
MetalMaterial.cpp:10-62, DielectricMaterial.cpp:11-86), and sample / value /
scattering pdf for lambertian and isotropic (the MIS mixture's material
half).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..utils.vecmath import (dot, normalize, reflect, refract, onb_from_w,
                             onb_local, safe_sqrt, where3)
from ..utils.rng import unit_vector_from_uv, cosine_direction_from_uv
from ..scene.flat import (FlatScene, MAT_METAL, MAT_DIELECTRIC,
                          MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC)
from .textures import texture_value

INV_4PI = 1.0 / (4.0 * math.pi)


@dataclass
class ScatterInfo:
    attenuation: torch.Tensor   # (N, 3)
    scatters: torch.Tensor      # (N,) bool — False = absorbed/emitter
    skip_pdf: torch.Tensor      # (N,) bool — specular, bypass MIS
    skip_dir: torch.Tensor      # (N, 3) unit specular direction
    is_isotropic: torch.Tensor  # (N,) bool — material-pdf family selector


def emitted(scene: FlatScene, mat, u, v, p, front_face):
    """Emission term (Camera.cpp:246-254)."""
    is_light = scene.mat_type[mat] == MAT_DIFFUSE_LIGHT
    color = texture_value(scene, scene.mat_tex[mat], u, v, p)
    on = is_light & front_face
    return torch.where(on[:, None], color, 0.0)


def _schlick(cosine, ri):
    """Schlick reflectance (DielectricMaterial.cpp:75-81)."""
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(scene: FlatScene, mat, in_dir, normal, front_face, u, v, p,
            u_fuzz1, u_fuzz2, u_refl) -> ScatterInfo:
    """Scatter behaviour for every ray; in_dir unit."""
    mtype = scene.mat_type[mat]
    tex = texture_value(scene, scene.mat_tex[mat], u, v, p)

    is_metal = mtype == MAT_METAL
    is_diel = mtype == MAT_DIELECTRIC
    is_iso = mtype == MAT_ISOTROPIC
    is_light = mtype == MAT_DIFFUSE_LIGHT

    # metal: mirror + fuzz jitter; absorbed if scattered below the surface
    fuzz = scene.mat_fuzz[mat]
    refl = normalize(reflect(in_dir, normal))
    jitter = unit_vector_from_uv(u_fuzz1, u_fuzz2)
    metal_dir = normalize(refl + fuzz[:, None] * jitter)
    metal_ok = dot(metal_dir, normal) > 0.0

    # dielectric: refract unless total internal reflection or Schlick
    ior = scene.mat_ior[mat]
    ri = torch.where(front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp(dot(-in_dir, normal), max=1.0)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot = ri * sin_theta > 1.0
    do_reflect = cannot | (_schlick(cos_theta, ri) > u_refl)
    diel_dir = where3(do_reflect, normalize(reflect(in_dir, normal)),
                      normalize(refract(in_dir, normal, ri)))

    attenuation = torch.where(is_diel[:, None], 1.0, tex)
    scatters = ~is_light & ~(is_metal & ~metal_ok)
    skip_pdf = is_metal | is_diel
    skip_dir = where3(is_metal, metal_dir, diel_dir)
    return ScatterInfo(attenuation=attenuation, scatters=scatters,
                       skip_pdf=skip_pdf, skip_dir=skip_dir,
                       is_isotropic=is_iso)


def material_pdf_sample(normal, is_isotropic, u1, u2):
    """Sample the material's own pdf: cosine hemisphere for lambertian
    (CosinePDF, PDF.hpp:53-82), uniform sphere for isotropic."""
    bu, bv, bw = onb_from_w(normal)
    cos_dir = onb_local(bu, bv, bw, cosine_direction_from_uv(u1, u2))
    sph_dir = unit_vector_from_uv(u1, u2)
    return where3(is_isotropic, sph_dir, normalize(cos_dir))


def material_pdf_value(normal, is_isotropic, out_dir):
    """Pdf of the material's own sampler in direction out_dir (unit)."""
    cosv = torch.clamp(dot(out_dir, normal), min=0.0) / math.pi
    return torch.where(is_isotropic, INV_4PI, cosv)


def scattering_pdf(normal, is_isotropic, out_dir):
    """BSDF directional density (lambertian cos/pi, isotropic 1/4pi)."""
    cosv = torch.clamp(dot(out_dir, normal), min=0.0) / math.pi
    return torch.where(is_isotropic, INV_4PI, cosv)
