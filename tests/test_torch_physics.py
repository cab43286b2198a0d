"""The physics cells of tests/test_integrator.py and the pixel-gradient
validation of tests/test_grad.py, on the port's plain integrator: the same
scenes, ray counts, seeds and thresholds, no JAX oracle (each is a property
of the estimator, not a comparison with the JAX package).
"""
import dataclasses

import numpy as np
import pytest
import torch

from real_time_ray_tracing_engine_tpu_torch import (
    Box, CameraConfig, ConstantMedium, Dielectric, DiffuseLight, Lambertian,
    Metal, Quad, Scene, SolidColor, Sphere, compile_scene)
from real_time_ray_tracing_engine_tpu_torch.models import camera as pcam
from real_time_ray_tracing_engine_tpu_torch.models.render import _render_pass
from real_time_ray_tracing_engine_tpu_torch.ops.integrator import trace
from real_time_ray_tracing_engine_tpu_torch.scene.flat import (
    MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_LAMBERTIAN, MAT_METAL)
from real_time_ray_tracing_engine_tpu_torch.utils import rng

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _trace_n(flat, org, dr, n, seed=0, depth=16, bg=(0, 0, 0), sky=False):
    """tests/test_integrator.py::_trace_n: n copies of one ray, the draws
    keyed by ray index at sample 0."""
    org = torch.tensor(org, dtype=torch.float32).expand(n, 3)
    dr = torch.tensor(dr, dtype=torch.float32).expand(n, 3)
    keys = rng.ray_keys(seed, torch.arange(n), 0)
    return trace(flat, org, dr, torch.zeros(n), keys,
                 torch.tensor(bg, dtype=torch.float32), max_depth=depth,
                 sky_gradient=sky).numpy()


def test_furnace_energy_conservation():
    """A white Lambertian sphere in a uniform white environment is
    indistinguishable from the environment (albedo 1 furnace)."""
    flat = compile_scene(Scene(objects=[
        Sphere((0, 0, -3), 1.0, Lambertian(SolidColor((1.0, 1.0, 1.0))))]))
    rad = _trace_n(flat, (0, 0, 0), (0, 0, -1), 4096, depth=50,
                   bg=(1.0, 1.0, 1.0))
    np.testing.assert_allclose(rad.mean(axis=0), 1.0, rtol=0.02)


def test_furnace_albedo_half():
    """Gray furnace: radiance = sum_k P(escape after k bounces) a^k < 1,
    between a and 1 for a convex body."""
    flat = compile_scene(Scene(objects=[
        Sphere((0, 0, -3), 1.0, Lambertian(SolidColor((0.5, 0.5, 0.5))))]))
    rad = _trace_n(flat, (0, 0, 0), (0, 0, -1), 4096, depth=50,
                   bg=(1.0, 1.0, 1.0))
    assert 0.3 < float(rad.mean()) < 0.75


def test_mis_unbiased_vs_bsdf_sampling():
    """The MIS estimator (lights list present) and the pure-BSDF estimator
    (no lights) agree in expectation (Camera.cpp:269-273)."""
    light = DiffuseLight(SolidColor((10, 10, 10)))
    floor = Lambertian(SolidColor((0.7, 0.7, 0.7)))
    objs = [Quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), floor),
            Quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), light)]
    s_mis = Scene(objects=objs,
                  lights=[Quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), floor)])
    s_bsdf = Scene(objects=objs, lights=[])
    n = 16384
    r_mis = _trace_n(compile_scene(s_mis), (0, 2, 6), (0, -0.25, -1), n,
                     depth=8).mean()
    r_bsdf = _trace_n(compile_scene(s_bsdf), (0, 2, 6), (0, -0.25, -1), n,
                      depth=8, seed=1).mean()
    assert abs(r_mis - r_bsdf) / max(r_bsdf, 1e-6) < 0.08, (r_mis, r_bsdf)


def test_mis_variance_reduction():
    """With a small bright light, MIS has much lower variance than
    BSDF-only sampling at equal sample count."""
    light = DiffuseLight(SolidColor((100, 100, 100)))
    floor = Lambertian(SolidColor((0.7, 0.7, 0.7)))
    objs = [Quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), floor),
            Quad((-0.3, 4, -0.3), (0.6, 0, 0), (0, 0, 0.6), light)]
    s_mis = Scene(objects=objs, lights=[Quad((-0.3, 4, -0.3), (0.6, 0, 0),
                                             (0, 0, 0.6), floor)])
    s_bsdf = Scene(objects=objs)
    n = 8192
    r_mis = _trace_n(compile_scene(s_mis), (0, 2, 6), (0, -0.25, -1), n,
                     depth=4)
    r_bsdf = _trace_n(compile_scene(s_bsdf), (0, 2, 6), (0, -0.25, -1), n,
                      depth=4)
    assert r_mis.std() < r_bsdf.std() * 0.7


def test_constant_medium_attenuates_background():
    """Black fog in front of a bright background dims rays by exponential
    transmission: 2 units of density 1, exp(-2)."""
    fog = ConstantMedium(Box((-2, -2, -4), (2, 2, -2), Lambertian(
        SolidColor((1, 1, 1)))), 1.0, SolidColor((0.0, 0.0, 0.0)))
    flat = compile_scene(Scene(objects=[fog]))
    assert flat.n_mediums == 1
    rad = _trace_n(flat, (0, 0, 0), (0, 0, -1), 8192, depth=8,
                   bg=(1.0, 1.0, 1.0))
    np.testing.assert_allclose(rad.mean(), np.exp(-2.0), rtol=0.1)


def test_constant_medium_white_fog_scatters_not_absorbs():
    """White isotropic fog in a white furnace conserves energy."""
    fog = ConstantMedium(Box((-2, -2, -4), (2, 2, -2), Lambertian(
        SolidColor((1, 1, 1)))), 2.0, SolidColor((1.0, 1.0, 1.0)))
    flat = compile_scene(Scene(objects=[fog]))
    rad = _trace_n(flat, (0, 0, 0), (0, 0, -1), 8192, depth=64,
                   bg=(1.0, 1.0, 1.0))
    np.testing.assert_allclose(rad.mean(), 1.0, rtol=0.03)


def test_depth_zero_semantics():
    """A path of no bounces gathers nothing."""
    flat = compile_scene(Scene(objects=[
        Sphere((0, 0, -3), 1.0, Lambertian(SolidColor((1, 1, 1))))]))
    rad = _trace_n(flat, (0, 0, 0), (0, 0, -1), 4, depth=0, bg=(1, 1, 1))
    np.testing.assert_allclose(rad, 0.0)


def _pixel_grad_scene():
    """tests/test_grad.py::_pixel_grad_scene: every material family in a
    24x24 camera view, rendered by the plain pass (seed 3, 2x2 strata,
    depth 4; the radiance sum of the 4 samples)."""
    cam = CameraConfig(aspect_ratio=1.0, image_width=24, samples_per_pixel=4,
                       max_depth=4, vfov=40, lookfrom=(0, 2, 9),
                       lookat=(0, 1, 0))
    scene = Scene(objects=[
        Quad((-6, 0, -6), (12, 0, 0), (0, 0, 12),
             Lambertian(SolidColor((0.6, 0.5, 0.4)))),
        Quad((-1.5, 5, -1.5), (3, 0, 0), (0, 0, 3),
             DiffuseLight(SolidColor((6, 6, 6)))),
        Sphere((-1.6, 1, 0), 1.0, Lambertian(SolidColor((0.8, 0.2, 0.2)))),
        Sphere((1.6, 1, 0), 1.0, Metal((0.9, 0.9, 0.9), 0.3)),
        Sphere((0, 1, 1.8), 0.8, Dielectric(1.5)),
    ], lights=[Quad((-1.5, 5, -1.5), (3, 0, 0), (0, 0, 3),
                    Lambertian(SolidColor((1, 1, 1))))], camera=cam)
    flat = compile_scene(scene)
    camd = pcam.derive(cam)
    w, h = pcam.image_size(cam)

    def img_of(f2):
        return _render_pass(f2, camd, 3, 0, width=w, height=h, tile_rows=h,
                            n_strata=2, max_depth=4, sky_gradient=False,
                            n_samples=4)

    return flat, img_of


@pytest.fixture(scope="module")
def pixel_grad():
    return _pixel_grad_scene()


@pytest.mark.parametrize("family,min_rate", [
    ("albedo", 0.99), ("emission", 0.99), ("fuzz", 0.99), ("ior", 0.99),
    ("radius", 0.97), ("center", 0.97)])
def test_pixel_gradient_allclose_rates(pixel_grad, family, min_rate):
    """tests/test_grad.py::test_pixel_gradient_allclose_rates on the port:
    per-pixel forward-mode derivatives of the plain pass (torch.func.jvp)
    against common-random-numbers central differences, for every trainable
    family; the share of pixels within 1e-3 + 5% of the difference at
    least 0.99 on the material parameters and 0.97 on the sphere's radius
    and center (visibility edges are discontinuous)."""
    flat, img_of = pixel_grad
    mt = flat.mat_type.numpy()
    metal = int(np.nonzero(mt == MAT_METAL)[0][0])
    diel = int(np.nonzero(mt == MAT_DIELECTRIC)[0][0])
    light = int(np.nonzero(mt == MAT_DIFFUSE_LIGHT)[0][0])
    lam2 = int(np.nonzero(mt == MAT_LAMBERTIAN)[0][1])
    field, index = {
        "albedo": ("tex_color", (int(flat.mat_tex[lam2]), 0)),
        "emission": ("tex_color", (int(flat.mat_tex[light]), 1)),
        "fuzz": ("mat_fuzz", (metal,)),
        "ior": ("mat_ior", (diel,)),
        "radius": ("sph_radius", (0,)),
        "center": ("sph_center", (0, 1))}[family]
    step, atol, rtol = 1e-3, 1e-3, 0.05
    arr = getattr(flat, field)

    def fn(v):
        a = arr.clone()
        a[index] = v
        return img_of(dataclasses.replace(flat, **{field: a}))

    v0 = arr[index].clone()
    _, gad = torch.func.jvp(fn, (v0,), (torch.ones_like(v0),))
    fd = (fn(v0 + step) - fn(v0 - step)) / (2 * step)
    gad, fd = gad.numpy(), fd.numpy()
    assert np.abs(fd).max() > 0.1, (field, index, "no signal")
    close = np.abs(gad - fd) <= atol + rtol * np.abs(fd)
    assert close.mean() >= min_rate, (family, close.mean())
