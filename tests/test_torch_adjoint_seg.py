"""The adjoint's segmented-regeneration sweep (the CUDA kernel K10's
semantics) on the CPU: its plain version against the JAX package's
segmented adjoint and against the port's own per-sample sweep, the sweep
rule, and the training path that takes it.

render_pass_adjoint_seg_reference is held against the JAX package's
render_pass_pallas(adjoint=True, adjoint_seg=6, interpret=True) on
tests/test_grad.py::test_adjoint_segmented_matches_per_sample's own scene
(78 spheres of every material family and a sphere light, 10 px, spp4, d4),
at the tolerances of tests/test_torch_adjoint.py's comparison with the JAX
adjoint (see there why: XLA's CPU FMAs against torch's two roundings). As
there, a few entries part further: on this scene spheres 7 and 63 (a
metal) and the metal's fuzz, by 1.8% (sphere 63's center x -207.53 against
-211.21), all of them carried by one path, pixel 17's, the pixel whose
image parts most (2.7e-4 of a radiance near 2); GAP78 holds them at
tests/test_torch_adjoint.py's GAP_* tolerances,
test_seg78_gap_is_one_lane shows that pixel carries them whole, and
test_seg78_gap_is_the_forward_mode_gap shows that the port's sweep equals
its own tangent bundles on them and parts from the JAX adjoint as the two
packages' tangent bundles part. The JAX segmented adjoint runs once per
module, its interpret-mode compile included.

Without JAX: the plain segmented sweep equals the plain per-sample sweep
under the JAX test's own rule (image atol 1e-6; each family rtol 1e-5,
atol 1e-5 x its largest entry) at SEG 1, 6 and n_samples x max_depth, on
that scene and on cornell_smoke (quads, a medium); adjoint_sweep picks the
sweep; make_kernel_render with adjoint_seg takes the segmented plain
version; and a plain full-family step on bouncing_spheres through it lowers
the loss. The kernel itself runs only on a GPU (tests/test_torch_cuda.py,
chip_smoke.py).
"""
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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)
from torch_threads import one_torch_thread  # noqa: E402,F401

# tests/test_torch_adjoint.py's tolerances against the JAX adjoint
IMAGE_ATOL, IMAGE_RTOL = 1e-5, 3e-4
PARTED = 1e-3
RTOL, ATOL_SCALE = 1e-3, 1e-4
# the 78-sphere scene's entries carried by pixel 17's path alone, and their
# tolerance (tests/test_torch_adjoint.py's GAP_*; see the top of this file)
GAP78 = (("sphc", 7, 0), ("sphc", 7, 1), ("sphc", 7, 2), ("sphc", 63, 0),
         ("sphc", 63, 1), ("sphc", 63, 2), ("sphr", 7), ("sphr", 63),
         ("fuzz", 63))
GAP_PIXEL = 17
# the GAP78 entry that parts most (sphere 63's center x)
GAP_WITNESS = (("sphc", 63, 0),)
GAP_RTOL, GAP_ATOL_SCALE = 2e-2, 2e-2
# tests/test_grad.py:1181's rule between the two sweeps
SWEEP_IMAGE_ATOL, SWEEP_RTOL, SWEEP_ATOL_SCALE = 1e-6, 1e-5, 1e-5


def _smoke_scene(m):
    """cornell_smoke at 16 px, depth 4 (tests/test_torch_adjoint.py's)."""
    scene = m.builders.cornell_smoke()
    scene.camera.image_width = 16
    scene.camera.max_depth = 4
    return scene


# name -> (scene builder over a schema module, seed, the cotangent's numpy
# seed)
# (chip_smoke.adjoint_seg_scene is tests/test_grad.py:1181's scene)
SCENES = {"seg78": (cs.adjoint_seg_scene, 0, 5),
          "smoke": (_smoke_scene, 3, 4)}


@functools.cache
def _case(name):
    """The port's flat, camera, pass keywords, seed and cotangent of one
    scene (with the JAX flat and camera for the 78-sphere scene)."""
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


@functools.cache
def _jax_seg_adjoint():
    """The JAX segmented adjoint (SEG 6, tests/test_grad.py:1181's call) on
    the 78-sphere scene: (image, grads), once per module."""
    jf, jc, _, _, kw, seed, g = _case("seg78")
    img, grads = wp.render_pass_pallas(
        jf, jc, jnp.asarray(seed, jnp.uint32), 0, cotangent=jnp.asarray(g),
        adjoint=True, adjoint_seg=6, light_src=wp.light_sphere_sources(jf),
        interpret=True, **kw)
    return np.asarray(img), {f: np.asarray(v) for f, v in grads.items()}


@functools.cache
def _plain_seg6():
    """The plain segmented sweep's (image, grads) at SEG 6 on the
    78-sphere scene, the JAX call's inputs."""
    _, _, pf, pc, kw, seed, g = _case("seg78")
    return ac.render_pass_adjoint_seg_reference(
        pf, pc, seed, 0, cotangent=torch.from_numpy(g), seg=6, **kw)


@functools.cache
def _per_sample(name):
    """The plain per-sample sweep's (image, grads, bounces) of a scene."""
    _, _, pf, pc, kw, seed, g = _case(name)
    it = torch.zeros(wc.lane_count(kw["width"] * kw["height"]),
                     dtype=torch.int32)
    img, grads = ac.render_pass_adjoint_reference(
        pf, pc, seed, 0, cotangent=torch.from_numpy(g), iters=it, **kw)
    return img, grads, int(it.sum())


def test_plain_seg_adjoint_matches_jax_seg_adjoint():
    """The plain segmented sweep against the JAX segmented adjoint at SEG
    6: the image within IMAGE_ATOL + IMAGE_RTOL x its value (no pixel parts
    by more than PARTED on this scene), every family at rtol RTOL, atol
    ATOL_SCALE x its largest entry (at least 1; GAP_* on the GAP78
    entries), and real signal in tex_color and the geometry."""
    img_j, grads_j = _jax_seg_adjoint()
    img, grads = _plain_seg6()
    img = img.numpy()
    assert not (np.abs(img - img_j).max(-1) > PARTED).any()
    np.testing.assert_allclose(img, img_j, rtol=IMAGE_RTOL, atol=IMAGE_ATOL)
    assert set(grads) == set(ac.ADJOINT_FIELDS) == set(grads_j)
    gap = {f: np.zeros(grads_j[f].shape, bool) for f in grads_j}
    for slot in GAP78:
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
                                       atol=scale * big, err_msg=f)
    assert np.abs(grads_j["tex_color"]).max() > 1e-2
    assert np.abs(grads_j["sph_center"]).max() > 1e-3


def test_seg78_gap_is_one_lane():
    """The GAP78 entries are one path's: pixel GAP_PIXEL is where the two
    packages' images part most, and the port's gradients with the
    cotangent on that pixel alone give every GAP78 entry to 1e-5 of its
    whole value (the other 99 pixels add nothing to them)."""
    img_j, _ = _jax_seg_adjoint()
    _, _, pf, pc, kw, seed, g = _case("seg78")
    img = wc.render_pass_reference(pf, pc, seed, 0, **kw).numpy()
    assert int(np.argmax(np.abs(img - img_j).max(-1))) == GAP_PIXEL
    one = np.zeros_like(g)
    y, x = divmod(GAP_PIXEL, kw["width"])
    one[y, x] = g[y, x]
    _, part = ac.render_pass_adjoint_reference(
        pf, pc, seed, 0, cotangent=torch.from_numpy(one), **kw)
    _, whole, _ = _per_sample("seg78")
    for slot in GAP78:
        f, idx = wc.slot_index(slot)
        w = float(whole[f][idx])
        assert abs(w) > 1.0, slot
        assert abs(float(part[f][idx]) - w) <= 1e-5 * abs(w), slot


def test_seg78_gap_is_the_forward_mode_gap():
    """The GAP78 entries part as the two packages' forward-mode passes do:
    on every one the port's segmented sweep equals the port's tangent
    bundles (an independent differentiation route, so a fault in the
    sweep's VJP on pixel 17's lane would show), and on GAP_WITNESS the JAX
    segmented adjoint equals the JAX tangent bundles and the two adjoints
    part by what the two packages' tangent bundles part, at
    tests/test_torch_adjoint.py's RTOL, ATOL_SCALE x the largest entry
    (one JAX slot, not nine: each slot adds seconds to the JAX kernel's
    interpret-mode compile, and the file has a minute cold)."""
    _, grads_j = _jax_seg_adjoint()
    jf, jc, pf, pc, kw, seed, g = _case("seg78")
    _, grads = _plain_seg6()
    _, _, tan_p = wc.render_pass_grad_reference(
        pf, pc, seed, 0, cotangent=torch.from_numpy(g), hard_slots=GAP78,
        want_tex=False, **kw)
    tan_p = tan_p.numpy()
    adj_p = np.array([float(grads[f][i]) for f, i in
                      map(wc.slot_index, GAP78)])
    atol = ATOL_SCALE * max(np.abs(tan_p).max(), 1.0)
    np.testing.assert_allclose(adj_p, tan_p, rtol=RTOL, atol=atol)
    _, _, tan_j = wp.render_pass_pallas(
        jf, jc, jnp.asarray(seed, jnp.uint32), 0, cotangent=jnp.asarray(g),
        hard_slots=GAP_WITNESS, light_src=wp.light_sphere_sources(jf),
        want_tex=False, interpret=True, **kw)
    tan_j = np.asarray(tan_j)
    adj_j = np.array([float(grads_j[f][i]) for f, i in
                      map(wc.slot_index, GAP_WITNESS)])
    k = [GAP78.index(s) for s in GAP_WITNESS]
    np.testing.assert_allclose(adj_j, tan_j, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(adj_p[k] - adj_j, tan_p[k] - tan_j,
                               rtol=RTOL, atol=atol)


@pytest.mark.parametrize("seg", [1, 6, 16])
@pytest.mark.parametrize("name", list(SCENES))
def test_plain_seg_sweep_matches_per_sample(name, seg):
    """The plain segmented sweep against the plain per-sample sweep, port
    only, under tests/test_grad.py:1181's rule: the same bounces, the image
    within 1e-6, every family within rtol 1e-5, atol 1e-5 x its largest
    entry (at least 1). SEG 6 divides no path length or sample count, 16
    is n_samples x max_depth (one segment)."""
    _, _, pf, pc, kw, seed, g = _case(name)
    img_p, grads_p, bounces = _per_sample(name)
    it = torch.zeros(wc.lane_count(kw["width"] * kw["height"]),
                     dtype=torch.int32)
    calls = ac.render_pass_adjoint_seg_reference.calls
    img, grads = ac.render_pass_adjoint_seg_reference(
        pf, pc, seed, 0, cotangent=torch.from_numpy(g), seg=seg, iters=it,
        **kw)
    assert ac.render_pass_adjoint_seg_reference.calls == calls + 1
    assert int(it.sum()) == bounces
    torch.testing.assert_close(img, img_p, rtol=0.0, atol=SWEEP_IMAGE_ATOL)
    for f in ac.ADJOINT_FIELDS:
        a, b = grads_p[f].numpy(), grads[f].numpy()
        np.testing.assert_allclose(
            a, b, rtol=SWEEP_RTOL,
            atol=SWEEP_ATOL_SCALE * max(np.abs(a).max(), 1.0), err_msg=f)
    assert float(grads_p["tex_color"].abs().max()) > 1e-2


@pytest.mark.parametrize("adjoint_seg, want", [(None, 0), (0, 0), (6, 6)])
def test_adjoint_sweep(adjoint_seg, want):
    """adjoint_sweep: the default is the per-sample sweep (K9) at every
    depth (K10 is slower on the H100, PERF.md); an explicit 0 or SEG is
    taken as given."""
    assert ac.adjoint_sweep(adjoint_seg) == want


def test_adjoint_sweep_rejects_a_negative_seg():
    with pytest.raises(ValueError, match="adjoint_seg"):
        ac.adjoint_sweep(-1)
    with pytest.raises(ValueError, match="adjoint_seg"):
        train.make_kernel_render(_case("seg78")[2], width=10, height=10,
                                 n_strata=2, max_depth=4, adjoint_seg=-8)


def test_make_kernel_render_takes_the_seg_sweep():
    """make_kernel_render(adjoint_seg=2) on the CPU: an adjoint request
    (237 center slots) runs the plain segmented sweep, once, and no
    per-sample sweep, with a direct call's gradients divided by the
    samples."""
    _, _, pf, pc, kw, seed, g = _case("seg78")
    kw = {k: v for k, v in kw.items() if k != "n_samples"}
    slots = train.grad_slots(pf, ("sph_center",))
    assert train.use_adjoint(pf, slots, False)
    params = {"sph_center": pf.sph_center.clone().requires_grad_(True)}
    render = train.make_kernel_render(pf, adjoint_seg=2, **kw)
    seg_calls = ac.render_pass_adjoint_seg_reference.calls
    calls = ac.render_pass_adjoint_reference.calls
    img = render(params, pc, seed)
    gt = torch.from_numpy(g)
    (got,) = torch.autograd.grad((img * gt).sum(), [params["sph_center"]])
    assert ac.render_pass_adjoint_seg_reference.calls == seg_calls + 1
    assert ac.render_pass_adjoint_reference.calls == calls
    _, want = ac.render_pass_adjoint_seg_reference(
        pf, pc, seed, 0, cotangent=gt, seg=2, n_samples=4, **kw)
    torch.testing.assert_close(got, want["sph_center"] / 4, rtol=1e-6,
                               atol=1e-7)
    assert float(got.abs().max()) > 0.0


def test_plain_seg_full_family_step_on_bouncing_lowers_the_loss():
    """engine="torch" trains all five families of bouncing_spheres (2,013
    hard slots: the adjoint) at 12x7 px, depth 3, through the segmented
    sweep (adjoint_seg=2) under the sky gradient, from the glass at IOR 1.4
    and the ground's checker leaves at 0.7 (tests/test_torch_adjoint.py's
    start and rates): the loss falls at every step, and no per-sample sweep
    runs."""
    scene = pt.builders.bouncing_spheres(image_width=12)
    flat, cam = pt.compile_scene(scene), pcam.derive(scene.camera)
    w, h = pcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=2, max_depth=3, sky_gradient=True)
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
         "lr": cs.ADJ_GEOM_LR}]), flat=flat, engine="torch", adjoint_seg=2,
        **kw)
    seg_calls = ac.render_pass_adjoint_seg_reference.calls
    calls = ac.render_pass_adjoint_reference.calls
    losses = [float(step(p, cam, 0, target)) for _ in range(3)]
    assert ac.render_pass_adjoint_seg_reference.calls == seg_calls + 3
    assert ac.render_pass_adjoint_reference.calls == calls
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    for f, v in p.items():
        assert bool(torch.isfinite(v.grad).all()), f
    assert float(p["mat_ior"].grad.abs().max()) > 0.0
