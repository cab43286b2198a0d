"""The hard-parameter gradient tier (the CUDA kernel K4's semantics) on the
CPU: the plain version's tangent bundles, their slot metadata, their
compacted driver (K5) and one training step over all five families.

render_pass_grad_reference's dG_hard (fuzz, IOR, sphere centers and radii)
is held against jax.vjp of the JAX package's pure-JAX replay
(parallel/mesh.py::_tile_sample_render) with tests/test_grad.py's
tolerance for the fused hard slots (rtol 5e-2, atol 5e-3 per slot, at least
6 slots with real signal), and against central differences of the port's
own forward pass (rtol 1e-2) on a seed whose +-eps passes trace the same
bounces. One make_train_step Adam step over every family is held against
jax.value_and_grad of the replay and optax.adam. Never a Pallas call in
interpret mode. Width <= 20, 4 samples and depth <= 4, for the reason
tests/test_torch_wavefront.py gives (XLA's CPU FMAs against torch's two
roundings). The kernel itself runs only on a GPU (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import real_time_ray_tracing_engine_tpu as rt
from real_time_ray_tracing_engine_tpu.models import camera as jcam
from real_time_ray_tracing_engine_tpu.ops import wavefront_pallas as wp
from real_time_ray_tracing_engine_tpu.ops.integrator import trace
from real_time_ray_tracing_engine_tpu.parallel import train as jtrain
from real_time_ray_tracing_engine_tpu.parallel.mesh import \
    _tile_sample_render
from real_time_ray_tracing_engine_tpu.utils import rng
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.parallel import train
from real_time_ray_tracing_engine_tpu_torch.scene.convert import (
    camera_from_numpy, camera_to_numpy, flat_from_numpy, flat_to_numpy,
    params_from_numpy)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR = 0.02
WALLS = [0, 1, 2]        # Cornell's green, red and white texture rows
GLASS_MAT = 4            # Cornell's dielectric material row
GLASS_ROWS = [0, 1]      # the glass sphere and its light-list copy


def _fused_scene(m, width=20):
    """tests/test_grad.py::test_fused_full_grad_matches_replay's scene, from
    either package's schema module `m`: metal fuzz, glass IOR, three
    spheres' centers and radii, and a sphere light that copies the glass
    sphere (light-row aliasing)."""
    cam = m.CameraConfig(aspect_ratio=1.0, image_width=width,
                         samples_per_pixel=4, max_depth=4, vfov=40,
                         lookfrom=(0, 2, 9), lookat=(0, 1, 0))
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
               glass_sphere], camera=cam, name="fused")


def _jax_scene(name, width):
    if name == "fused":
        return _fused_scene(rt, width)
    scene = rt.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = width
    return scene


def _args(name, width, spp=4, depth=4):
    """The JAX flat and camera, the port's carried across, the pass
    keywords."""
    scene = _jax_scene(name, width)
    jf, jc = rt.compile_scene(scene), jcam.derive(scene.camera)
    pf = flat_from_numpy(*flat_to_numpy(jf), device="cpu")
    pc = camera_from_numpy(camera_to_numpy(jc), device="cpu")
    w, h = jcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=int(np.sqrt(spp)),
              max_depth=depth, n_samples=spp,
              sky_gradient=scene.camera.sky_gradient)
    return jf, jc, pf, pc, kw


def _cotangent(kw, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(kw["height"], kw["width"], 3)).astype(np.float32))


def test_slot_metadata_matches_jax():
    """hard_param_slots, light_sphere_sources and the slot restriction by
    field are the JAX package's; the slot table names each slot's table
    cell; the gate names the adjoint kernels past MAX_HARD_SLOTS."""
    for name in ("cornell_box", "three_spheres", "fused", "cornell_smoke"):
        jf, _, pf, _, _ = _args(name, 8)
        assert wc.hard_param_slots(pf) == wp.hard_param_slots(jf), name
        assert wc.light_sphere_sources(pf) == wp.light_sphere_sources(jf)
        for fields in ({"mat_ior"}, {"sph_radius", "mat_fuzz"}):
            assert (wc.hard_param_slots(pf, fields)
                    == wp.hard_param_slots(jf, fields))
    _, _, pf, _, _ = _args("cornell_box", 8)
    slots = wc.hard_param_slots(pf)
    assert slots == (("ior", 4), ("sphc", 0, 0), ("sphc", 0, 1),
                     ("sphc", 0, 2), ("sphr", 0), ("sphc", 1, 0),
                     ("sphc", 1, 1), ("sphc", 1, 2), ("sphr", 1))
    assert wc.light_sphere_sources(pf) == (1, -1)
    assert wc._slot_table(slots)[[0, 2, 4]].tolist() == [
        [2.0, 4.0, 1.0], [1.0, 0.0, 1.0], [1.0, 0.0, 6.0]]
    assert wc.slot_index(("sphc", 1, 2)) == ("sph_center", (1, 2))
    assert wc.hard_slots_gate_reason(pf, len(slots)) is None
    assert "K9/K10" in wc.hard_slots_gate_reason(pf, wc.MAX_HARD_SLOTS + 1)


@pytest.mark.parametrize("name,width", [("fused", 20), ("cornell_box", 16)])
def test_hard_grad_matches_jax_replay(name, width):
    """dG_hard against the replay's vjp, slot by slot: the fused scene
    (every hard family, a sphere light aliasing a trainable sphere) and
    Cornell (the glass IOR, the glass sphere and its light-list copy)."""
    jf, jc, pf, pc, kw = _args(name, width)
    g = _cotangent(kw, 2)
    seed = 7
    # every family, as the full-family step below differentiates them: one
    # compiled replay serves both
    params = jtrain.get_params(jf)

    def replay(p):
        return _tile_sample_render(
            jtrain.set_params(jf, p), jc, jnp.uint32(seed),
            width=kw["width"], height_local=kw["height"],
            row0=jnp.asarray(0, jnp.int32), n_strata=kw["n_strata"],
            spp_local=kw["n_samples"], sample0=jnp.asarray(0, jnp.int32),
            max_depth=kw["max_depth"], sky_gradient=kw["sky_gradient"])

    _, vjp = jax.vjp(replay, params)
    (dp,) = vjp(jnp.asarray(g.numpy()))
    slots = wc.hard_param_slots(pf)
    img, dg_tex, dg_hard = wc.render_pass_grad_reference(
        pf, pc, seed, 0, cotangent=g, hard_slots=slots, want_tex=False, **kw)
    assert dg_tex is None and dg_hard.shape == (len(slots),)
    want = np.array([float(np.asarray(dp[f])[i])
                     for f, i in map(wc.slot_index, slots)])
    got = dg_hard.numpy()
    for k, slot in enumerate(slots):
        np.testing.assert_allclose(got[k], want[k], rtol=5e-2, atol=5e-3,
                                   err_msg=f"{slot}")
    assert (np.abs(want) > 1e-3).sum() >= 6      # real signal
    # as a whole, far tighter than the per-slot rule
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


def _float64(state):
    """A copy of a port FlatScene or CameraState with float64 tables."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).double()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)
        and getattr(state, f.name).dtype == torch.float32})


def test_fused_16px_replay_gap_is_float32_rounding():
    """Why the fused scene is compared at 20 px: at 16 px one path parts
    the port from the replay (sphere 0's center x slot 19% off), and
    float64 sides with the replay. Pixel (7, 2), sample 3, leaves the red
    sphere at a grazing angle (cosine 4.5e-4): the port's float32 |oc|^2 -
    r^2 rounds to -8.3e-6 (float64: +1.2e-8), so it finds a far root at t =
    2.5e-3, past T_MIN, where float64 finds none and the path escapes. The
    witness does not rest on the port: the JAX integrator in float64 agrees
    with the port's plain forward in float64 on every pixel, and the port's
    float32 image parts from both at that pixel alone."""
    jf, jc, pf, pc, kw = _args("fused", 16)
    seed = 7
    f32 = wc.render_pass_reference(pf, pc, seed, 0, **kw).numpy()
    f64 = wc.render_pass_reference(_float64(pf), _float64(pc), seed, 0,
                                   **kw).numpy()
    with jax.enable_x64(True):
        wide = (lambda x: jnp.asarray(x, jnp.float64)
                if getattr(x, "dtype", None) == jnp.float32 else x)
        jf64, jc64 = jax.tree_util.tree_map(wide, (jf, jc))
        pix = jnp.arange(kw["width"] * kw["height"], dtype=jnp.int32)
        ref = 0.0
        for s in range(kw["n_samples"]):
            sid = jnp.full(pix.shape, s, jnp.int32)
            keys = rng.ray_keys(jnp.uint32(seed), pix, sid)
            org, dr, tm = jcam.generate_rays(jc64, kw["width"], pix, sid,
                                             kw["n_strata"], keys)
            ref = ref + trace(jf64, org, dr, tm, keys, jc64.background,
                              max_depth=kw["max_depth"], sky_gradient=False)
        ref = np.asarray(ref).reshape(f32.shape)
    assert ref.dtype == np.float64
    np.testing.assert_allclose(f64, ref, rtol=0, atol=1e-6)
    parted = np.argwhere(np.abs(f32 - ref).max(-1) > 1e-4).tolist()
    assert parted == [[7, 2]]
    assert f32[7, 2].max() == 0.0 and ref[7, 2, 0] > 7e-4


def test_full_family_train_step_matches_optax_adam():
    """One Adam step over all five families, from the walls dimmed and the
    glass sphere at IOR 1.4 and radius 85 (chip_smoke.py's training
    start): the loss, every family's gradient (the glass IOR, the glass
    sphere and its light-list copy through the tangent bundles) and the
    update match the JAX replay's with optax.adam."""
    jf, jc, pf, pc, kw = _args("cornell_box", 16)
    kw.pop("n_samples")
    kw.pop("sky_gradient")
    seed = 4
    spp = kw["n_strata"] ** 2
    target = train.make_kernel_render(pf, **kw)(
        {"tex_color": pf.tex_color}, pc, seed).detach()
    start = {k: np.array(v, copy=True)
             for k, v in jtrain.get_params(jf).items()}
    start["tex_color"][WALLS] *= 0.7
    start["mat_ior"][GLASS_MAT] = 1.4
    start["sph_radius"][GLASS_ROWS] = 85.0
    jparams = {k: jnp.asarray(v) for k, v in start.items()}

    def loss_fn(p):
        img = _tile_sample_render(
            jtrain.set_params(jf, p), jc, jnp.uint32(seed),
            width=kw["width"], height_local=kw["height"],
            row0=jnp.asarray(0, jnp.int32), n_strata=kw["n_strata"],
            spp_local=spp, sample0=jnp.asarray(0, jnp.int32),
            max_depth=kw["max_depth"], sky_gradient=False) / spp
        return jnp.mean((img - jnp.asarray(target.numpy())) ** 2)

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    opt = optax.adam(LR)
    updates, _ = opt.update(jgrads, opt.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)

    params = params_from_numpy(start, device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    step = train.make_train_step(torch.optim.Adam(params.values(), lr=LR),
                                 flat=pf, engine="torch", **kw)
    calls = wc.render_pass_grad_reference.calls
    loss = step(params, pc, seed, target)
    assert wc.render_pass_grad_reference.calls == calls + 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    for f in train.TRAINABLE_FIELDS:
        jg, g = np.asarray(jgrads[f]), params[f].grad.numpy()
        rtol, atol = (2e-2, 2e-3) if f == "tex_color" else (5e-2, 5e-3)
        scale = float(np.abs(jg).max())
        # Cornell has no metal: no fuzz slot, a zero gradient
        assert (scale == 0.0) == (f == "mat_fuzz"), f
        np.testing.assert_allclose(g, jg, rtol=rtol, atol=atol * scale,
                                   err_msg=f)
        # Adam's first step moves each entry by lr * g / (|g| + eps): the
        # same step wherever the gradient is well clear of zero
        clear = np.abs(jg) > atol * scale
        new = params[f].detach().numpy()
        np.testing.assert_allclose(new[clear], np.asarray(jnew[f])[clear],
                                   rtol=1e-6, atol=1e-6, err_msg=f)
        assert np.abs(new - start[f]).max() <= LR * 1.001 + 1e-4, f
    assert np.abs(np.asarray(jgrads["mat_ior"])[GLASS_MAT]) > 0.0
    assert (np.abs(np.asarray(jgrads["sph_radius"])[GLASS_ROWS]) > 0.0).all()


def test_hard_grad_matches_central_differences():
    """One fuzz, one IOR and one radius slot against central differences of
    the port's own forward pass. The seed and eps keep every +-eps pass on
    the same bounces (equal iteration counts), so the common random numbers
    take the same discrete decisions and the difference quotient is the
    derivative."""
    _, _, pf, pc, kw = _args("fused", 12)
    g = _cotangent(kw, 1)
    seed, eps = 5, 3e-4
    slots = (("fuzz", 3), ("ior", 4), ("sphr", 2))
    _, _, dg = wc.render_pass_grad_reference(pf, pc, seed, 0, cotangent=g,
                                             hard_slots=slots,
                                             want_tex=False, **kw)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    for k, slot in enumerate(slots):
        field, idx = wc.slot_index(slot)
        imgs, bounces = [], []
        for sign in (1.0, -1.0):
            table = getattr(pf, field).clone()
            table[idx] += sign * eps
            iters = torch.zeros(n_lanes, dtype=torch.int32)
            imgs.append(wc.render_pass_reference(
                dataclasses.replace(pf, **{field: table}), pc, seed, 0,
                iters=iters, **kw))
            bounces.append(iters)
        assert torch.equal(bounces[0], bounces[1]), slot
        fd = float(((imgs[0] - imgs[1]) * g).sum()) / (2 * eps)
        assert abs(fd) > 0.1, slot                  # real signal
        np.testing.assert_allclose(float(dg[k]), fd, rtol=1e-2,
                                   err_msg=f"{slot}")


def test_hard_grad_image_is_the_forward_image():
    """With every tier on (weight planes and 18 tangent bundles) the grad
    pass traces the forward's paths: the same image, bit for bit."""
    _, _, pf, pc, kw = _args("fused", 8, spp=1)
    g = _cotangent(kw, 3)
    img, dg_tex, dg_hard = wc.render_pass_grad_reference(
        pf, pc, 1, 2, cotangent=g, hard_slots=wc.hard_param_slots(pf), **kw)
    np.testing.assert_array_equal(
        img.numpy(), wc.render_pass_reference(pf, pc, 1, 2, **kw).numpy())
    assert dg_tex.shape == pf.tex_color.shape
    assert float(dg_hard.abs().max()) > 0.0
    assert bool(torch.isfinite(dg_hard).all())


def test_hard_grad_without_tex_tier():
    """want_tex=False runs the tangent bundles alone: the same dG_hard, no
    dG_tex, no weight-plane carry rows; with neither tier there is nothing
    to differentiate."""
    _, _, pf, pc, kw = _args("fused", 8, spp=1)
    g = _cotangent(kw, 4)
    slots = wc.hard_param_slots(pf)
    _, dg_tex, dg_hard = wc.render_pass_grad_reference(
        pf, pc, 1, 0, cotangent=g, hard_slots=slots, **kw)
    rad, none_tex, dg_hard2, st = wc.render_pass_grad_reference(
        pf, pc, 1, 0, cotangent=g, hard_slots=slots, want_tex=False,
        cap=1000, **kw)
    assert none_tex is None and dg_tex is not None
    np.testing.assert_array_equal(dg_hard2.numpy(), dg_hard.numpy())
    assert float(dg_hard.abs().max()) > 0.0
    assert st.shape == (wc.CARRY_ROWS + 9 * len(slots), rad.shape[1])
    with pytest.raises(ValueError, match="want_tex or hard_slots"):
        wc.render_pass_grad_reference(pf, pc, 1, 0, cotangent=g,
                                      want_tex=False, **kw)


def test_hard_grad_compacted_matches_single():
    """K5 with tangent bundles on the plain version, caps (12, 6): Cornell's
    12 x 12 pixels fill 144 of 256 lanes, so pad lanes are permuted with
    the rest. The tangent planes ride the carry: the same image, dG_tex and
    dG_hard up to the order of the sums."""
    _, _, pf, pc, kw = _args("cornell_box", 12)
    assert kw["width"] * kw["height"] % wc.LANE_BLOCK != 0
    g = _cotangent(kw, 5)
    slots = wc.hard_param_slots(pf)
    n_wp = 3 * pf.tex_type.shape[0]
    carried = []

    def spy(*args, **kwargs):
        out = wc.render_pass_grad_reference(*args, **kwargs)
        if kwargs.get("cap"):
            carried.append(out[3][wc.CARRY_ROWS + n_wp:])
        return out

    img, dg_tex, dg_hard = wc.render_pass_grad_reference(
        pf, pc, 7, 3, cotangent=g, hard_slots=slots, **kw)
    img2, dg_tex2, dg_hard2 = wc.render_pass_grad_compacted(
        pf, pc, 7, 3, cotangent=g, hard_slots=slots, caps=(12, 6),
        pass_fn=spy, **kw)
    np.testing.assert_allclose(img2.numpy(), img.numpy(), atol=1e-5)
    for a, b in ((dg_tex2, dg_tex), (dg_hard2, dg_hard)):
        scale = float(b.abs().max())
        assert scale > 0.05
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale)
    # both capped phases carried mid-path tangent planes
    assert len(carried) == 2
    assert all(c.shape[0] == 9 * len(slots) and bool((c != 0).any())
               for c in carried)
