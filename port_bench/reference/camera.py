"""Camera: viewport derivation and stratified ray generation (frozen copy
of the port's models/camera.py; the reference engine's Camera.cpp:31-73,
152-216, 226-230)."""
from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace

import torch

from .vecmath import normalize, cross
from . import rng

CAMERA_DRAW_TAG = 0x0CA4


@dataclass
class CameraState:
    center: torch.Tensor
    pixel00: torch.Tensor
    pixel_du: torch.Tensor
    pixel_dv: torch.Tensor
    defocus_u: torch.Tensor
    defocus_v: torch.Tensor
    defocus_on: torch.Tensor
    background: torch.Tensor

    def to(self, device=None, dtype=None) -> "CameraState":
        return replace(self, **{f.name: getattr(self, f.name).to(
            device=device, dtype=dtype) for f in fields(self)})


def image_size(cfg) -> tuple[int, int]:
    h = max(1, int(cfg.image_width / cfg.aspect_ratio))
    return cfg.image_width, h


def sqrt_spp(cfg) -> int:
    return max(1, int(math.sqrt(cfg.samples_per_pixel)))


def derive(cfg, device="cpu") -> CameraState:
    w_px, h_px = image_size(cfg)

    def vec(x):
        return torch.tensor(x, dtype=torch.float32)

    lookfrom, lookat, vup = vec(cfg.lookfrom), vec(cfg.lookat), vec(cfg.vup)
    theta = math.radians(cfg.vfov)
    h = math.tan(theta / 2.0)
    viewport_h = 2.0 * h * cfg.focus_dist
    viewport_w = viewport_h * (w_px / h_px)

    w = normalize(lookfrom - lookat)
    u = normalize(cross(vup, w))
    v = cross(w, u)

    viewport_u = viewport_w * u
    viewport_v = viewport_h * (-v)
    pixel_du = viewport_u / w_px
    pixel_dv = viewport_v / h_px
    upper_left = (lookfrom - cfg.focus_dist * w - viewport_u / 2
                  - viewport_v / 2)
    pixel00 = upper_left + 0.5 * (pixel_du + pixel_dv)

    defocus_radius = cfg.focus_dist * math.tan(
        math.radians(cfg.defocus_angle / 2.0))
    return CameraState(
        center=lookfrom, pixel00=pixel00, pixel_du=pixel_du,
        pixel_dv=pixel_dv, defocus_u=u * defocus_radius,
        defocus_v=v * defocus_radius,
        defocus_on=torch.tensor(1.0 if cfg.defocus_angle > 0 else 0.0),
        background=vec(cfg.background)).to(device)


def generate_rays(cam: CameraState, width: int, pixel_ids, sample_id,
                  n_strata: int, keys):
    """Rays for pixel_ids (N,) at stratified sample index sample_id (int or
    (N,) tensor): stratum (s % n, s // n). Returns (org, dir not
    normalized, time), in the camera's dtype."""
    dtype = cam.center.dtype
    u = rng.uniforms(keys, CAMERA_DRAW_TAG, (5,), dtype)
    i = (pixel_ids % width).to(dtype)
    j = (pixel_ids // width).to(dtype)
    s = torch.as_tensor(sample_id, device=pixel_ids.device)
    s_i = (s % n_strata).to(dtype)
    s_j = (s // n_strata).to(dtype)

    inv = 1.0 / n_strata
    off_x = (s_i + u[:, 0]) * inv - 0.5
    off_y = (s_j + u[:, 1]) * inv - 0.5
    pixel_sample = (cam.pixel00[None, :]
                    + (i + off_x)[:, None] * cam.pixel_du[None, :]
                    + (j + off_y)[:, None] * cam.pixel_dv[None, :])

    disk = rng.in_unit_disk_from_uv(u[:, 2], u[:, 3])
    offset = (disk[:, 0:1] * cam.defocus_u[None, :]
              + disk[:, 1:2] * cam.defocus_v[None, :]) * cam.defocus_on
    org = cam.center[None, :] + offset
    dr = pixel_sample - org
    tm = u[:, 4]
    return org, dr, tm
