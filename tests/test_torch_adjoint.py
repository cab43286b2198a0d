"""The adjoint backward (the CUDA kernel K9's semantics) on the CPU: its plain
version against the JAX package's adjoint, against the port's own
forward-mode tiers, and the training policy that picks it.

render_pass_adjoint_reference is held against the JAX package's
render_pass_pallas(adjoint=True, interpret=True), as tests/test_grad.py runs
it, on that file's five adjoint scenes at their own sizes: the 78-sphere
scene with a sphere light (804), the Cornell-class scene with quads, a
metal, a glass and a sphere light (891), cornell_smoke (958), the checker
and noise routing scene (996) and the vquad city (1119). Each family agrees
at rtol 1e-3, atol 1e-4 x its largest entry. XLA's CPU contracts
multiply-adds under jit and torch rounds twice
(tests/test_torch_wavefront.py), so the two float32 images drift apart by
a few ulps a bounce on bright pixels (up to 1.9e-4, 1.3e-4 relative, at
radiances near 2 on the 78-sphere scene: 18 of its 144 pixels differ by
more than 1e-5): the image agrees within 1e-5 absolute and 3e-4 relative.
Where the images part by
more than 1e-3 the two sides trace different paths, so the cotangent is
zeroed on those pixels, on both sides, as tests/test_torch_large_grad.py
does: at most 2% of the pixels (1 of 144 on the 78-sphere scene, none on
the others). On the 78-sphere scene ten geometry and fuzz entries
(PARTED78) part by more than that (sphere 32's radius 3.29 against 4.06 of
a largest entry of 44.8): the packages' forward-mode tangent bundles part
on those very entries alike, since a grazing path's derivative magnifies
the last bits, so those ten entries are held at rtol 2e-2, atol 2e-2 x
their family's largest entry, every other entry of that scene at the
tolerance above, and test_slots78_gap_is_the_forward_mode_gap shows entry
by entry that the two adjoints part exactly as the two forward-mode passes
do. Each scene's JAX
adjoint runs once per module (5-27 s each here, its interpret-mode compile
included).

Without JAX: the plain adjoint equals the plain forward-mode tiers (weight
planes and tangent bundles on Cornell, the suffix tier on a 41-row scene),
make_kernel_render takes it from ADJOINT_MIN_SLOTS slots and gives a direct
call's gradients divided by the samples, and a plain full-family step on
bouncing_spheres lowers the loss. The kernel itself runs only on a GPU
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import real_time_ray_tracing_engine_tpu as rt
from real_time_ray_tracing_engine_tpu.models import camera as jcam
from real_time_ray_tracing_engine_tpu.ops import wavefront_pallas as wp
import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu_torch.models import camera as pcam
from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.parallel import train
from real_time_ray_tracing_engine_tpu_torch.scene.convert import (
    camera_from_numpy, camera_to_numpy, flat_from_numpy, flat_to_numpy)
from real_time_ray_tracing_engine_tpu_torch.scene.flat import (
    MAT_DIELECTRIC, MAT_METAL)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)
from torch_threads import one_torch_thread  # noqa: E402,F401

IMAGE_ATOL, IMAGE_RTOL = 1e-5, 3e-4
PARTED = 1e-3
RTOL, ATOL_SCALE = 1e-3, 1e-4
MAX_PARTED = 0.02
# the 78-sphere scene's entries where both packages' forward-mode passes
# part as their adjoints do, and their tolerance (see the top of this file)
PARTED78 = (("sphc", 0, 1), ("sphc", 32, 0), ("sphc", 32, 1),
            ("sphc", 32, 2), ("sphc", 63, 1), ("sphc", 69, 2), ("sphr", 0),
            ("sphr", 32), ("fuzz", 0), ("fuzz", 54))
GAP_RTOL, GAP_ATOL_SCALE = 2e-2, 2e-2
# the reverse bounce's oracle (_bounce_vjp) against float64 central
# differences of bounce_step: relative to each lane's largest entry (the
# differences' own error at h = 1e-6 is about 1e-9; a marble's turbulence
# hashes its lattice in float32, 5e-6 here)
PROBE_FD_RTOL = 1e-4
PROBE_FD_LANES = 3


def _slots_scene(m):
    """tests/test_grad.py:804's scene at its 12 px."""
    return cs.sized(cs.vscan_slots_scene(m), 12, 4, 4)


def _fused_scene(m):
    """tests/test_grad.py:891's Cornell-class scene: quads, a quad light
    and a sphere light that copies the glass sphere, a metal, 20 px."""
    glass_sphere = m.Sphere((0, 1, 1.8), 0.8, m.Dielectric(1.5))
    return m.Scene(objects=[
        m.Quad((-6, 0, -6), (12, 0, 0), (0, 0, 12),
               m.Lambertian(m.SolidColor((0.6, 0.5, 0.4)))),
        m.Quad((-1.5, 5, -1.5), (3, 0, 0), (0, 0, 3),
               m.DiffuseLight(m.SolidColor((6, 6, 6)))),
        m.Sphere((-1.6, 1, 0), 1.0,
                 m.Lambertian(m.SolidColor((0.8, 0.2, 0.2)))),
        m.Sphere((1.6, 1, 0), 1.0, m.Metal((0.9, 0.9, 0.9), 0.3)),
        glass_sphere,
    ], lights=[m.Quad((-1.5, 5, -1.5), (3, 0, 0), (0, 0, 3),
                      m.Lambertian(m.SolidColor((1, 1, 1)))),
               glass_sphere],
        camera=m.CameraConfig(aspect_ratio=1.0, image_width=20,
                              samples_per_pixel=4, max_depth=4, vfov=40,
                              lookfrom=(0, 2, 9), lookat=(0, 1, 0)))


def _smoke_scene(m):
    scene = m.builders.cornell_smoke()
    scene.camera.image_width = 16
    scene.camera.max_depth = 4
    return scene


def _routing_scene(m):
    """tests/test_grad.py:996's checker (parity-routed child rows) and
    marble (no tex_color dependence) spheres, 12 px, depth 3."""
    checker = m.Checker(0.6, m.SolidColor((0.1, 0.8, 0.2)),
                        m.SolidColor((0.9, 0.1, 0.6)))
    return m.Scene(objects=[
        m.Sphere((0, -100.5, 0), 100.0, m.Lambertian(checker)),
        m.Sphere((-1.1, 0.5, 0), 0.5, m.Lambertian(m.Noise(2.5))),
        m.Sphere((1.1, 0.5, 0), 0.5,
                 m.Lambertian(m.SolidColor((0.8, 0.6, 0.2))))],
        camera=m.CameraConfig(image_width=12, aspect_ratio=1.0,
                              samples_per_pixel=4, max_depth=3, vfov=50,
                              lookfrom=(0, 1.2, 4), lookat=(0, 0.4, 0),
                              background=(0.7, 0.8, 1.0)))


def _city_scene(m):
    """tests/test_grad.py:1119's 12 boxes, a ground quad, a metal and a
    lambertian sphere: 74 quads, the quad chunks (vquad), 16 px."""
    rng = np.random.default_rng(3)
    objs = []
    for _ in range(12):
        x, z = rng.uniform(-10, 10, 2)
        hgt = float(rng.uniform(1, 4))
        albedo = tuple(map(float, rng.uniform(0.3, 0.9, 3)))
        objs.append(m.Box((x, 0, z), (x + 1.5, hgt, z + 1.5),
                          m.Lambertian(m.SolidColor(albedo))))
    objs.append(m.Quad((-20, 0, -20), (40, 0, 0), (0, 0, 40),
                       m.Lambertian(m.SolidColor((0.5, 0.5, 0.5)))))
    objs.append(m.Sphere((0, 2, 3), 1.2, m.Metal((0.9, 0.8, 0.7), 0.2)))
    objs.append(m.Sphere((-3, 1.2, 1), 1.0,
                         m.Lambertian(m.SolidColor((0.8, 0.3, 0.2)))))
    return m.Scene(objects=objs, camera=m.CameraConfig(
        image_width=16, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        vfov=40, lookfrom=(14, 7, 14), lookat=(0, 1, 0), sky_gradient=True))


# name -> (scene builder over a schema module, seed, the cotangent's numpy
# seed): tests/test_grad.py's
SCENES = {"slots78": (_slots_scene, 0, 5), "fused": (_fused_scene, 7, 2),
          "smoke": (_smoke_scene, 3, 4), "routing": (_routing_scene, 0, 9),
          "city": (_city_scene, 0, 8)}


@functools.cache
def _case(name):
    """Both packages' state for one scene: the JAX flat and camera, the
    port's carried across as numpy, the pass keywords, the seed and the
    cotangent."""
    build, seed, g_seed = SCENES[name]
    scene = build(rt)
    jf, jc = rt.compile_scene(scene), jcam.derive(scene.camera)
    pf = flat_from_numpy(*flat_to_numpy(jf), device="cpu")
    pc = camera_from_numpy(camera_to_numpy(jc), device="cpu")
    w, h = jcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=2,
              max_depth=scene.camera.max_depth, n_samples=4,
              sky_gradient=scene.camera.sky_gradient)
    g = np.random.default_rng(g_seed).normal(size=(h, w, 3)).astype(
        np.float32)
    return jf, jc, pf, pc, kw, seed, g


def _jax_call(name, g):
    jf, jc, _, _, kw, seed, _ = _case(name)
    img, grads = wp.render_pass_pallas(
        jf, jc, jnp.asarray(seed, jnp.uint32), 0, cotangent=jnp.asarray(g),
        adjoint=True, light_src=wp.light_sphere_sources(jf), interpret=True,
        **kw)
    return np.asarray(img), {f: np.asarray(v) for f, v in grads.items()}


@functools.cache
def _jax_adjoint(name):
    """The JAX adjoint's (image, grads) at the case's cotangent zeroed where
    the two packages' float32 images part, that cotangent, and the parted
    pixels; once per module (a second call, with the zeroed cotangent,
    reuses the first one's compile)."""
    _, _, pf, pc, kw, seed, g = _case(name)
    img, grads = _jax_call(name, g)
    ours = wc.render_pass_reference(pf, pc, seed, 0, **kw).numpy()
    parted = np.abs(img - ours).max(-1) > PARTED
    if parted.any():
        g = g * ~parted[..., None]
        img, grads = _jax_call(name, g)
    return img, grads, g, parted


@pytest.mark.parametrize("name", SCENES)
def test_plain_adjoint_matches_jax_adjoint(name):
    """The plain adjoint against the JAX adjoint (see the top of this file)
    on the pixels whose paths both packages trace alike: the image within
    IMAGE_ATOL + IMAGE_RTOL x its value, every family at rtol RTOL, atol
    ATOL_SCALE x its largest entry (at least 1, as tests/test_grad.py:880;
    GAP_* on the 78-sphere scene's PARTED78 entries), and real signal in
    tex_color and, where the scene has them, in the hard families."""
    img_j, grads_j, g, parted = _jax_adjoint(name)
    _, _, pf, pc, kw, seed, _ = _case(name)
    img, grads = ac.render_pass_adjoint_reference(
        pf, pc, seed, 0, cotangent=torch.from_numpy(g), **kw)
    assert parted.mean() <= MAX_PARTED, (name, int(parted.sum()))
    np.testing.assert_allclose(img.numpy()[~parted], img_j[~parted],
                               rtol=IMAGE_RTOL, atol=IMAGE_ATOL)
    assert set(grads) == set(ac.ADJOINT_FIELDS) == set(grads_j)
    gap = {f: np.zeros(grads_j[f].shape, bool) for f in grads_j}
    for slot in PARTED78 if name == "slots78" else ():
        f, idx = wc.slot_index(slot)
        gap[f][idx] = True
    for f in ac.ADJOINT_FIELDS:
        got, want = grads[f].numpy(), grads_j[f]
        assert got.shape == want.shape, f
        assert np.isfinite(got).all(), f
        big = max(np.abs(want).max(), 1.0)
        for sel, rtol, scale in ((~gap[f], RTOL, ATOL_SCALE),
                                 (gap[f], GAP_RTOL, GAP_ATOL_SCALE)):
            np.testing.assert_allclose(got[sel], want[sel], rtol=rtol,
                                       atol=scale * big,
                                       err_msg=f"{name} {f}")
    assert np.abs(grads_j["tex_color"]).max() > 1e-2
    if name in ("slots78", "fused", "routing"):
        assert np.abs(grads_j["sph_center"]).max() > 1e-3


def test_slots78_gap_is_the_forward_mode_gap():
    """On the 78-sphere scene, tests/test_grad.py:804's five slots (a
    metal's fuzz, the glass's IOR, sphere 7's center y and radius, the light
    sphere's center x) and the PARTED78 entries: each package's adjoint
    equals its own tangent bundles, and the port's adjoint parts from the
    JAX adjoint by what the port's tangent bundles part from the JAX
    package's, at RTOL and ATOL_SCALE x the largest slot."""
    _, grads_j, g, _ = _jax_adjoint("slots78")
    jf, jc, pf, pc, kw, seed, _ = _case("slots78")
    mt = np.asarray(jf.mat_type)
    slots = (("fuzz", int(np.where(mt == MAT_METAL)[0][0])),
             ("ior", int(np.where(mt == MAT_DIELECTRIC)[0][0])),
             ("sphc", 7, 1), ("sphr", 7),
             ("sphc", int(np.asarray(jf.light_prim)[0]), 0))
    slots += tuple(s for s in PARTED78 if s not in slots)
    assert len(slots) == 14
    _, _, tan_j = wp.render_pass_pallas(
        jf, jc, jnp.asarray(seed, jnp.uint32), 0, cotangent=jnp.asarray(g),
        hard_slots=slots, light_src=wp.light_sphere_sources(jf),
        want_tex=False, interpret=True, **kw)
    tan_j = np.asarray(tan_j)
    _, _, tan_p = wc.render_pass_grad_reference(
        pf, pc, seed, 0, cotangent=torch.from_numpy(g), hard_slots=slots,
        want_tex=False, **kw)
    tan_p = tan_p.numpy()
    _, grads = ac.render_pass_adjoint_reference(
        pf, pc, seed, 0, cotangent=torch.from_numpy(g), **kw)
    adj_p, adj_j = [], []
    for slot in slots:
        f, idx = wc.slot_index(slot)
        adj_p.append(float(grads[f][idx]))
        adj_j.append(float(grads_j[f][idx]))
    atol = ATOL_SCALE * max(np.abs(tan_j).max(), 1.0)
    np.testing.assert_allclose(adj_p, tan_p, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(adj_j, tan_j, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(np.subtract(adj_p, adj_j), tan_p - tan_j,
                               rtol=RTOL, atol=atol)
    assert abs(adj_p[4]) > 1e-3          # the light sphere's signal


def _forward_mode_case(name):
    """(flat, cam, kw, seed, g, slots): Cornell (every slot; NT 6, the
    weight planes) or the 41-row scene (the suffix tier beside a few
    slots: two metals' fuzz, two spheres' geometry and the light's)."""
    if name == "cornell":
        scene = pt.builders.cornell_box()
        scene.camera.image_width = 12
    else:
        scene = cs.sized(cs.suffix_scene(pt), 12, 4, 4)
    flat, cam = pt.compile_scene(scene), pcam.derive(scene.camera)
    w, h = pcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=2, max_depth=4, n_samples=4)
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(h, w, 3)).astype(np.float32))
    if name == "cornell":
        slots = wc.hard_param_slots(flat)
    else:
        light = int(flat.light_prim[0])
        slots = (wc.hard_param_slots(flat, {"mat_fuzz"})[:2]
                 + (("sphc", 3, 0), ("sphr", 3), ("sphc", 10, 1),
                    ("sphc", light, 1), ("sphr", light)))
    return flat, cam, kw, 3, g, slots


@pytest.mark.parametrize("name", ["cornell", "suffix41"])
def test_plain_adjoint_matches_forward_mode(name):
    """Two differentiation mechanisms over one estimator
    (tests/test_grad.py:804's check): the plain adjoint against the plain
    forward-mode tiers, the weight planes or the suffix tier for tex_color
    and one tangent bundle a slot; the same image."""
    flat, cam, kw, seed, g, slots = _forward_mode_case(name)
    assert wc.tex_form(flat) == ("planes" if name == "cornell"
                                 else "suffix")
    img, grads = ac.render_pass_adjoint_reference(flat, cam, seed, 0,
                                                  cotangent=g, **kw)
    img_f, dg_tex, dg_hard = wc.render_pass_grad_reference(
        flat, cam, seed, 0, cotangent=g, hard_slots=slots, **kw)
    assert torch.equal(img, img_f)
    tex = grads["tex_color"].numpy()
    np.testing.assert_allclose(tex, dg_tex.numpy(), rtol=RTOL,
                               atol=ATOL_SCALE * np.abs(tex).max())
    got = []
    for slot in slots:
        f, idx = wc.slot_index(slot)
        got.append(float(grads[f][idx]))
    want = dg_hard.numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_SCALE * np.abs(want).max())
    assert np.abs(want).max() > 1e-3


def _lambertian_field():
    """tests/test_grad.py:1233's scene: 78 lambertian spheres and a sphere
    light, 12 px, depth 3."""
    rng = np.random.default_rng(33)
    objs = [pt.Sphere(tuple(map(float, rng.uniform(-4, 4, 3))), 0.5,
                      pt.Lambertian(pt.SolidColor(tuple(map(
                          float, rng.uniform(0.25, 0.9, 3))))))
            for _ in range(78)]
    light = pt.Sphere((0, 8, 0), 2.0,
                      pt.DiffuseLight(pt.SolidColor((6., 6., 6.))))
    objs.append(light)
    return pt.Scene(objects=objs, lights=[light], camera=pt.CameraConfig(
        image_width=12, aspect_ratio=1.0, samples_per_pixel=4, max_depth=3,
        vfov=45, lookfrom=(0, 2, 11), lookat=(0, 0, 0),
        background=(0.3, 0.4, 0.6)))


def test_train_takes_the_adjoint_from_33_slots():
    """make_kernel_render routes a request of ADJOINT_MIN_SLOTS or more hard
    slots through the adjoint (one adjoint pass, no grad pass) and gives
    exactly a direct adjoint call's gradients, divided by the samples
    (tests/test_grad.py:1233)."""
    scene = _lambertian_field()
    flat, cam = pt.compile_scene(scene), pcam.derive(scene.camera)
    w, h = pcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=2, max_depth=3)
    fields = ("tex_color", "sph_center", "sph_radius")
    slots = train.grad_slots(flat, fields)
    assert len(slots) >= train.ADJOINT_MIN_SLOTS
    assert train.use_adjoint(flat, slots, True)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(h, w, 3)).astype(np.float32))
    params = {f: getattr(flat, f).clone().requires_grad_(True)
              for f in fields}
    render = train.make_kernel_render(flat, **kw)
    adj, grad = (ac.render_pass_adjoint_reference.calls,
                 wc.render_pass_grad_reference.calls)
    img = render(params, cam, 5)
    got = torch.autograd.grad((img * g).sum(), list(params.values()))
    assert ac.render_pass_adjoint_reference.calls == adj + 1
    assert wc.render_pass_grad_reference.calls == grad
    img_d, want = ac.render_pass_adjoint_reference(
        flat, cam, 5, 0, cotangent=g, n_samples=4, **kw)
    torch.testing.assert_close(img.detach(), img_d / 4)
    for f, gr in zip(fields, got):
        torch.testing.assert_close(gr, want[f] / 4, rtol=1e-6, atol=1e-7)
        assert float(gr.abs().max()) > 0.0, f


def test_tier_policy(monkeypatch):
    """use_adjoint is the JAX package's rule: hard slots, and either
    ADJOINT_MIN_SLOTS of them or a pass the forward-mode tiers cannot
    serve (any hard slot under a BVH walk, which carries no tangent
    bundles); tex_color alone never takes it. The port's own rule:
    ADJOINT_PLANES_SLOTS slots beside tex_color's weight planes of more
    than MAX_TEXS rows take it too (30 tangent bundles beside 31 rows'
    planes, which the kernels serve since the planes left a block's shared
    memory), fewer slots or fewer rows do not. On the (faked) card an
    adjoint request builds its render without a gate error."""
    spheres = pt.compile_scene(pt.Scene(objects=[
        pt.Sphere((3.0 * i, 0, 0), 1.0,
                  pt.Metal((0.5, 0.4 + 0.01 * i, 0.5), 0.3) if i < 30
                  else pt.Lambertian(pt.SolidColor((1, 1, 1))))
        for i in range(80)]))
    assert not train.use_adjoint(spheres, (), True)
    fuzz = train.grad_slots(spheres, ("mat_fuzz",))
    assert len(fuzz) == 30
    assert not train.use_adjoint(spheres, fuzz, False)
    assert wc.grad_gate_reason(spheres, 30, True) is None
    assert spheres.tex_type.shape[0] > wc.MAX_TEXS
    assert train.use_adjoint(spheres, fuzz, True)
    n = train.ADJOINT_PLANES_SLOTS
    assert train.use_adjoint(spheres, fuzz[:n], True)
    assert not train.use_adjoint(spheres, fuzz[:n - 1], True)
    few = pt.compile_scene(pt.Scene(objects=[
        pt.Sphere((3.0 * i, 0, 0), 1.0,
                  pt.Metal((0.5, 0.5, 0.5), 0.1 + 0.01 * i) if i < 30
                  else pt.Lambertian(pt.SolidColor((1, 1, 1))))
        for i in range(80)]))
    assert few.tex_type.shape[0] <= wc.MAX_TEXS
    assert wc.kernel_mode(few)[0] == "vscan"
    few_fuzz = train.grad_slots(few, ("mat_fuzz",))
    assert len(few_fuzz) == 30
    assert not train.use_adjoint(few, few_fuzz, True)
    radii = train.grad_slots(spheres, ("sph_radius",))
    assert train.use_adjoint(spheres, radii[:33], False)
    assert not train.use_adjoint(spheres, radii[:32], False)
    assert ac.adjoint_gate_reason(spheres) is None
    walked = pt.compile_scene(pt.Scene(objects=[
        pt.Sphere((3.0 * i, 0, 0), 1.0, pt.Metal((0.5, 0.5, 0.5), 0.3))
        for i in range(80)]), use_bvh=True)
    monkeypatch.setenv("RTX_BVH_STACK", "1")
    assert wc.kernel_mode(walked)[0] == "stack"
    assert wc.grad_gate_reason(walked, 1) is not None
    assert train.use_adjoint(walked, train.grad_slots(walked,
                                                      ("mat_fuzz",)), True)
    assert not train.use_adjoint(walked, (), True)


def test_plain_full_family_step_on_bouncing_lowers_the_loss():
    """engine="torch" trains all five families of bouncing_spheres (2,013
    hard slots: the adjoint) at a few pixels under the sky gradient, from
    the glass at IOR 1.4 and the ground's checker leaves at 0.7: Adam at
    0.02 for tex_color, IOR and fuzz and chip_smoke.ADJ_GEOM_LR for the
    sphere geometry (see there); the loss falls at every step."""
    scene = pt.builders.bouncing_spheres(image_width=12)
    flat, cam = pt.compile_scene(scene), pcam.derive(scene.camera)
    w, h = pcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=2, max_depth=3, sky_gradient=True)
    assert len(wc.hard_param_slots(flat)) == 2013
    target = train.make_kernel_render(flat, **kw)(
        {"tex_color": flat.tex_color}, cam, 0).detach()
    p = {k: v.detach().clone() for k, v in train.get_params(flat).items()}
    ground = int(flat.mat_tex[flat.sph_mat[0]])
    p["tex_color"][[int(flat.tex_child_even[ground]),
                    int(flat.tex_child_odd[ground])]] *= 0.7
    p["mat_ior"][[s[1] for s in wc.hard_param_slots(flat, {"mat_ior"})]] \
        = 1.4
    for v in p.values():
        v.requires_grad_(True)
    step = train.make_train_step(torch.optim.Adam([
        {"params": [p["tex_color"], p["mat_ior"], p["mat_fuzz"]],
         "lr": 0.02},
        {"params": [p["sph_center"], p["sph_radius"]],
         "lr": cs.ADJ_GEOM_LR}]), flat=flat, engine="torch", **kw)
    calls = ac.render_pass_adjoint_reference.calls
    losses = [float(step(p, cam, 0, target)) for _ in range(3)]
    assert ac.render_pass_adjoint_reference.calls == calls + 3
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    for f, v in p.items():
        assert bool(torch.isfinite(v.grad).all()), f
    assert float(p["mat_ior"].grad.abs().max()) > 0.0


def _float64(flat):
    return dataclasses.replace(flat, **{
        f.name: getattr(flat, f.name).double()
        for f in dataclasses.fields(flat)
        if torch.is_tensor(getattr(flat, f.name))
        and getattr(flat, f.name).is_floating_point()})


@pytest.mark.parametrize("case", cs.PROBE_CASES,
                         ids=[c[0] for c in cs.PROBE_CASES])
def test_probe_oracle_matches_central_differences(case):
    """The plain VJP that chip_smoke.py's adjoint_bounce_probe holds the
    kernel's reverse bounce against (adjoint_bounce_probe_reference, one
    _bounce_vjp a lane) equals float64 central differences of bounce_step's
    <g, radiance increment> + <lam, (o', d', th')> in the state and in
    every table entry the adjoint accumulates (tex_color, sphere centers
    and radii, fuzz, IOR), on a few lanes of each of the probe's branches,
    within PROBE_FD_RTOL of the lane's largest entry."""
    from real_time_ray_tracing_engine_tpu_torch.ops.integrator import (
        bounce_step, medium_uniforms)
    from real_time_ray_tracing_engine_tpu_torch.utils import rng
    scene = cs.probe_scene(pt, case[1])
    flat = pt.compile_scene(scene)
    cam = pcam.derive(scene.camera)
    sky = case[2]
    o, d, th, tm, pix, sample, bounce = cs.probe_rays(torch, case,
                                                      torch.device("cpu"))
    labels = cs.probe_labels(torch, flat, o, d, th, tm, pix, sample,
                             bounce, 7, sky, cam.background)
    idx = torch.tensor([i for i, lab in enumerate(labels)
                        if lab == cs.probe_wanted(case)][:PROBE_FD_LANES])
    assert idx.numel() == PROBE_FD_LANES, (case[0], labels)
    f64 = wc.all_primitive(_float64(flat))
    gen = np.random.default_rng(0)
    g = torch.tensor(gen.standard_normal((idx.numel(), 3)))
    lam = torch.tensor(gen.standard_normal((idx.numel(), 9)))
    x = torch.cat([o[idx], d[idx], th[idx]], 1).double()
    lam_in, rows = ac.adjoint_bounce_probe_reference(
        f64, cam, x[:, 0:3], x[:, 3:6], x[:, 6:9], tm[idx], pix[idx],
        sample[idx], bounce[idx], g, lam, seed=7, sky_gradient=sky)
    keys = rng.ray_keys(7, pix[idx], sample[idx])
    u = rng.bounce_uniforms(keys, bounce[idx])
    u_med = medium_uniforms(f64, keys, bounce[idx])
    live = torch.ones(idx.numel(), dtype=torch.bool)

    def value(scene64, x):
        drad, o2, d2, th2, _ = bounce_step(
            scene64, x[:, 0:3], x[:, 3:6], tm[idx], x[:, 6:9], live, u,
            u_med, cam.background.double(), sky)
        return (g * drad).sum(1) + (lam * torch.cat([o2, d2, th2], 1)).sum(1)

    def central(shift):
        return (shift(1.0) - shift(-1.0)) / 2.0
    want_state = torch.zeros_like(lam_in)
    for j in range(9):
        h = 1e-6 * torch.clamp(x[:, j].abs(), min=1.0)
        want_state[:, j] = central(
            lambda sg: value(f64, x + sg * h[:, None]
                             * torch.eye(9, dtype=x.dtype)[j])) / h
    NT, S, NM = ac.adjoint_layout(flat)
    want_rows = torch.zeros_like(rows)
    entries = ([("tex_color", (t, c), 3 * t + c)
                for t in range(NT) for c in range(3)]
               + [("sph_center", (r, c), 3 * NT + 4 * r + c)
                  for r in range(S) for c in range(3)]
               + [("sph_radius", (r,), 3 * NT + 4 * r + 3) for r in range(S)]
               + [(f, (m,), 3 * NT + 4 * S + 2 * m + k)
                  for m in range(NM)
                  for k, f in enumerate(("mat_fuzz", "mat_ior"))])
    for field, at, col in entries:
        base = getattr(f64, field)
        h = 1e-6 * max(1.0, abs(float(base[at])))

        def shifted(sg):
            t = base.clone()
            t[at] += sg * h
            return value(dataclasses.replace(f64, **{field: t}), x)
        want_rows[:, col] = central(shifted) / h
    got = torch.cat([lam_in, rows], 1)
    want = torch.cat([want_state, want_rows], 1)
    scale = want.abs().max(1).values[:, None]
    assert bool((scale > 0).all())
    err = (got - want).abs() / scale
    assert float(err.max()) <= PROBE_FD_RTOL, (case[0], float(err.max()))
