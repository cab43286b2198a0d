"""The port's plain torch integrator against the JAX package's.

Both packages draw the same PCG4D streams per (pixel, sample, bounce) and
run the same float32 arithmetic, so images compare per pixel under the rule
the JAX kernel meets against its own oracle (tests/test_pallas.py::
_assert_close): under 1% of pixels differ by more than 1e-3 (discrete branch
flips on last-bit differences), and the means differ by under 2e-3. Scene
tables and camera are carried across from the JAX package as numpy
(scene/convert.py), so only the integrators differ.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import real_time_ray_tracing_engine_tpu as rt
from real_time_ray_tracing_engine_tpu.models import camera as jcam
from real_time_ray_tracing_engine_tpu.models.render import \
    _render_pass as jax_render_pass
from real_time_ray_tracing_engine_tpu.ops import intersect as jint
from real_time_ray_tracing_engine_tpu.ops import lights as jlights
from real_time_ray_tracing_engine_tpu.ops import materials as jmat
from real_time_ray_tracing_engine_tpu_torch.models.render import \
    _render_pass as torch_render_pass
from real_time_ray_tracing_engine_tpu_torch.ops import intersect as pint
from real_time_ray_tracing_engine_tpu_torch.ops import lights as plights
from real_time_ray_tracing_engine_tpu_torch.ops import materials as pmat
from real_time_ray_tracing_engine_tpu_torch.scene.convert import (
    camera_from_numpy, camera_to_numpy, flat_from_numpy, flat_to_numpy)

from test_pallas import _assert_close as assert_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# per-record tolerance: 1e-5 plus one float32 ulp of the value; hit
# distances and points also get one ulp of the scene's coordinate scale,
# since the sphere quadratic cancels its terms (h - sqrt(disc), h ~ |center|)
# and a last-bit difference there is an ulp of the scene's largest
# coordinate: 6e-5 at the Cornell box's 555, 2.4e-4 at the 1000-radius floor
ATOL, ULP = 1e-5, 2.0 ** -23


def _builtin(name, width):
    scene = rt.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = width
    return scene


def materials_scene():
    """tests/test_pallas.py::test_materials_scene_matches_oracle."""
    cam = rt.CameraConfig(aspect_ratio=16 / 9, image_width=64,
                          samples_per_pixel=4, max_depth=4, vfov=20,
                          lookfrom=(13, 2, 3), lookat=(0, 0, 0),
                          defocus_angle=0.6, focus_dist=10.0,
                          background=(0.7, 0.8, 1.0))
    checker = rt.Checker(2.0, rt.SolidColor((0.2, 0.3, 0.1)),
                         rt.SolidColor((0.9, 0.9, 0.9)))
    light = rt.Sphere((0, 6, 0), 2.0,
                      rt.DiffuseLight(rt.SolidColor((4, 4, 4))))
    return rt.Scene(objects=[
        rt.Sphere((0, -1000, 0), 1000.0, rt.Lambertian(checker)),
        rt.Sphere((0, 1, 0), 1.0, rt.Dielectric(1.5)),
        rt.Sphere((-4, 1, 0), 1.0,
                  rt.Lambertian(rt.SolidColor((0.4, 0.2, 0.1))),
                  center2=(-4, 1.3, 0)),
        rt.Sphere((4, 1, 0), 1.0, rt.Metal((0.7, 0.6, 0.5), fuzz=0.1)),
        light], lights=[light], camera=cam)


def nested_checker_scene():
    """tests/test_pallas.py::test_nested_checker_matches_oracle."""
    inner = rt.Checker(0.31, rt.SolidColor((0.9, 0.1, 0.1)),
                       rt.SolidColor((0.1, 0.1, 0.9)))
    tex = rt.Checker(1.1, inner, rt.Noise(3.0))
    cam = rt.CameraConfig(aspect_ratio=1.0, image_width=32,
                          samples_per_pixel=4, max_depth=4,
                          lookfrom=(0, 2, 6), lookat=(0, 1, 0),
                          sky_gradient=True)
    return rt.Scene(objects=[
        rt.Quad((-8, 0.513, -8), (16, 0, 0), (0, 0, 16), rt.Lambertian(tex)),
        rt.Sphere((0, 1.5, 0), 1.0, rt.Lambertian(tex))], camera=cam)


SCENES = {
    "cornell_box": lambda: _builtin("cornell_box", 48),
    "cornell_smoke": lambda: _builtin("cornell_smoke", 48),
    "materials": materials_scene,
    "nested_checker": nested_checker_scene,
}


def carried(scene):
    """(JAX flat, JAX camera, port flat, port camera) of one JAX scene."""
    jf = rt.compile_scene(scene)
    jc = jcam.derive(scene.camera)
    pf = flat_from_numpy(*flat_to_numpy(jf), device="cpu")
    pc = camera_from_numpy(camera_to_numpy(jc), device="cpu")
    return jf, jc, pf, pc


@pytest.mark.parametrize("name", list(SCENES))
def test_render_pass_matches_jax(name):
    scene = SCENES[name]()
    jf, jc, pf, pc = carried(scene)
    w, h = jcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=2, max_depth=4, n_samples=2,
              sky_gradient=scene.camera.sky_gradient, tile_rows=min(h, 32))
    img_j = np.asarray(jax_render_pass(jf, jc, jnp.uint32(5), jnp.int32(0),
                                       **kw))
    img_p = torch_render_pass(pf, pc, 5, 0, **kw).numpy()
    assert img_p.shape == img_j.shape == (h, w, 3)
    assert img_j.mean() > 0.01          # the scene is lit
    assert_close(img_p, img_j)


def _rays(name, n=3000):
    r = np.random.default_rng(len(name))
    lo, hi = (1.0, 554.0) if name.startswith("cornell") else (-6.0, 6.0)
    org = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = r.uniform(0, 1, n).astype(np.float32)
    u = r.uniform(0, 1, (n, 6)).astype(np.float32)
    return org, d, tm, u


def _scale(jf):
    """The largest coordinate magnitude of the scene's primitives."""
    sph = np.abs(np.asarray(jf.sph_center)).max(axis=1, initial=0.0) \
        + np.asarray(jf.sph_radius)
    quad = (np.abs(np.asarray(jf.quad_corner)) + np.abs(np.asarray(jf.quad_u))
            + np.abs(np.asarray(jf.quad_v))).max(axis=1, initial=0.0)
    return float(max(sph.max(initial=0.0), quad.max(initial=0.0)))


def _close(a, b, what, scale=0.0):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(b, a, err_msg=what)
    else:
        np.testing.assert_allclose(b, a, atol=ATOL + ULP * scale, rtol=ULP,
                                   err_msg=what)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke",
                                  "materials"])
def test_records_match_jax(name):
    """closest_hit, medium_scatter, scatter, light_pdf_value and
    light_sample, one module at a time on the same random rays."""
    jf, _, pf, _ = carried(SCENES[name]())
    scale = _scale(jf)
    org, d, tm, u = _rays(name)
    J = jnp.asarray

    def T(x):
        return torch.from_numpy(np.array(x))

    jr = jint.closest_hit(jf, J(org), J(d), J(tm))
    pr = pint.closest_hit(pf, T(org), T(d), T(tm))
    hit = np.asarray(jr.hit)
    assert 0.5 < hit.mean()
    _close(jr.hit, pr.hit, "hit")
    for f in ("t", "point", "normal", "front_face", "mat", "u", "v"):
        _close(np.asarray(getattr(jr, f))[hit], getattr(pr, f)[T(hit)], f,
               scale if f in ("t", "point") else 0.0)

    if jf.n_mediums:
        t_surf = np.where(hit, np.asarray(jr.t), np.float32(1e30))
        jm = jint.medium_scatter(jf, J(org), J(d), J(tm), J(t_surf),
                                 J(u[:, :jf.med_mat.shape[0]]))
        pm = pint.medium_scatter(pf, T(org), T(d), T(tm), T(t_surf),
                                 T(u[:, :jf.med_mat.shape[0]]))
        valid = np.asarray(jm[2])
        assert valid.any()
        _close(jm[2], pm[2], "medium valid")
        _close(np.asarray(jm[0])[valid], pm[0][T(valid)], "medium t",
               scale)
        _close(np.asarray(jm[1])[valid], pm[1][T(valid)], "medium mat")

    # scatter at the JAX hit records, so only the materials differ
    rec = {f: np.asarray(getattr(jr, f)) for f in
           ("mat", "normal", "front_face", "u", "v", "point")}
    js = jmat.scatter(jf, J(rec["mat"]), J(d), J(rec["normal"]),
                      J(rec["front_face"]), J(rec["u"]), J(rec["v"]),
                      J(rec["point"]), J(u[:, 0]), J(u[:, 1]), J(u[:, 2]))
    ps = pmat.scatter(pf, T(rec["mat"].astype(np.int64)), T(d),
                      T(rec["normal"]), T(rec["front_face"]), T(rec["u"]),
                      T(rec["v"]), T(rec["point"]), T(u[:, 0]),
                      T(u[:, 1]), T(u[:, 2]))
    for f in ("attenuation", "scatters", "skip_pdf", "skip_dir",
              "is_isotropic"):
        _close(np.asarray(getattr(js, f))[hit], getattr(ps, f)[T(hit)], f)

    jp = jlights.light_pdf_value(jf, J(org), J(d), J(tm))
    pp = plights.light_pdf_value(pf, T(org), T(d), T(tm))
    assert np.asarray(jp).max() > 0       # some rays see a light
    _close(jp, pp, "light_pdf_value")
    jl = jlights.light_sample(jf, J(org), J(tm), J(u[:, 3]), J(u[:, 4]),
                              J(u[:, 5]))
    pl = plights.light_sample(pf, T(org), T(tm), T(u[:, 3]),
                              T(u[:, 4]), T(u[:, 5]))
    _close(jl, pl, "light_sample")
