"""The training step of the port (parallel/train.py), on the CPU.

One make_train_step Adam step over tex_color is held against the JAX
package's: the loss and gradient of the pure-JAX replay
(parallel/mesh.py::_tile_sample_render, jax.value_and_grad) and an
optax.adam update, from the same carried-over parameters
(scene/convert.py::params_from_numpy). Sizes and tolerances as
tests/test_torch_grad.py. The step over all five families is in
tests/test_torch_hard_grad.py, beside the replay comparison it shares a
compiled replay with. Here also: the tier policy (a request of 33 or more
hard slots takes the adjoint, K9) and a request with no slot. The kernels
run only on a GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import real_time_ray_tracing_engine_tpu as rt
from real_time_ray_tracing_engine_tpu.models import camera as jcam
from real_time_ray_tracing_engine_tpu.parallel import train as jtrain
from real_time_ray_tracing_engine_tpu.parallel.mesh import \
    _tile_sample_render
import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu_torch.models import camera as pcam
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.parallel import train
from real_time_ray_tracing_engine_tpu_torch.scene.convert import (
    camera_from_numpy, camera_to_numpy, flat_from_numpy, flat_to_numpy,
    params_from_numpy)
from real_time_ray_tracing_engine_tpu_torch.scene.flat import FlatScene
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR = 0.02
WALLS = [0, 1, 2]        # Cornell's green, red and white texture rows


def _cornell(width=16, spp=4, depth=4):
    scene = rt.builders.cornell_box()
    scene.camera.image_width = width
    jf, jc = rt.compile_scene(scene), jcam.derive(scene.camera)
    pf = flat_from_numpy(*flat_to_numpy(jf), device="cpu")
    pc = camera_from_numpy(camera_to_numpy(jc), device="cpu")
    w, h = jcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=int(np.sqrt(spp)),
              max_depth=depth)
    return jf, jc, pf, pc, kw


def _dimmed(tex_color):
    """The training start: the three wall rows at 0.7 of their color."""
    tc = np.array(tex_color, dtype=np.float32, copy=True)
    tc[WALLS] *= 0.7
    return tc


def test_train_step_matches_optax_adam():
    jf, jc, pf, pc, kw = _cornell()
    seed = 4
    spp = kw["n_strata"] ** 2
    target = train.make_kernel_render(pf, **kw)(
        {"tex_color": pf.tex_color}, pc, seed).detach()
    jparams = {"tex_color": jnp.asarray(
        _dimmed(jtrain.get_params(jf)["tex_color"]))}

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
    jnew = np.asarray(optax.apply_updates(jparams, updates)["tex_color"])
    jgrad = np.asarray(jgrads["tex_color"])

    params = params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    params["tex_color"].requires_grad_(True)
    opt_t = torch.optim.Adam(params.values(), lr=LR)
    step = train.make_train_step(opt_t, flat=pf, engine="torch", **kw)
    calls = wc.render_pass_grad_reference.calls
    loss = step(params, pc, seed, target)
    assert wc.render_pass_grad_reference.calls == calls + 1
    grad = params["tex_color"].grad.numpy()
    new = params["tex_color"].detach().numpy()

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    # the loss gradient is small (2 (image - target) / n_pixels per pixel):
    # atol is test_grad.py's 2e-3 of its largest entry
    scale = float(np.abs(jgrad).max())
    assert scale > 0.0
    np.testing.assert_allclose(grad, jgrad, rtol=2e-2, atol=2e-3 * scale)
    # Adam's first step moves each entry by lr * g / (|g| + eps): the same
    # step wherever the gradient is well clear of zero, at most lr elsewhere
    clear = np.abs(jgrad) > 2e-3 * scale
    assert clear[WALLS].any()
    np.testing.assert_allclose(new[clear], jnew[clear], atol=1e-6)
    assert np.abs(new - np.asarray(jparams["tex_color"])).max() <= LR * 1.001


@pytest.mark.parametrize("compacted", [False, True])
def test_training_lowers_the_loss(compacted, monkeypatch):
    """Three Adam steps from the dimmed walls toward the true image lower
    the loss; with the compacted schedules (forward and grad driver, K2 and
    K5) as with single passes."""
    if compacted:
        monkeypatch.setattr(train, "COMPACT_MIN_SAMPLES", 4)
    _, _, pf, pc, kw = _cornell(width=8)
    target = train.make_kernel_render(pf, **kw)(
        {"tex_color": pf.tex_color}, pc, 1).detach()
    params = {"tex_color": torch.from_numpy(
        _dimmed(pf.tex_color.numpy())).requires_grad_(True)}
    opt = torch.optim.Adam(params.values(), lr=LR)
    step = train.make_train_step(opt, flat=pf, **kw)
    losses = [float(step(params, pc, 1, target)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert torch.isfinite(params["tex_color"].grad).all()


def test_render_loss_grad_and_params():
    _, _, pf, pc, kw = _cornell(width=8)
    target = torch.zeros(kw["height"], kw["width"], 3)
    loss, grads = train.render_loss_grad(pf, pc, 0, target, **kw)
    assert set(grads) == {"tex_color"} and float(loss) > 0.0
    assert grads["tex_color"].shape == pf.tex_color.shape
    # the light row only raises the image above a black target
    assert float(grads["tex_color"][3].min()) > 0.0
    p = train.get_params(pf)
    assert tuple(p) == train.TRAINABLE_FIELDS
    moved = train.set_params(pf, {"tex_color": p["tex_color"] * 0.5})
    np.testing.assert_array_equal(moved.tex_color.numpy(),
                                  pf.tex_color.numpy() * 0.5)
    np.testing.assert_array_equal(moved.mat_fuzz.numpy(),
                                  pf.mat_fuzz.numpy())


def test_hard_request_without_slots_gives_zeros():
    """Fuzz on Cornell, which has no metal: the request has no slot, so its
    gradient is zero and no grad pass runs (JAX train.py:203-206)."""
    _, _, pf, pc, kw = _cornell(width=8, spp=1, depth=2)
    assert train.grad_slots(pf, ("mat_fuzz",)) == ()
    target = torch.zeros(kw["height"], kw["width"], 3)
    calls = wc.render_pass_grad_reference.calls
    loss, grads = train.render_loss_grad(pf, pc, 0, target,
                                         fields=("mat_fuzz",), **kw)
    assert wc.render_pass_grad_reference.calls == calls
    assert float(loss) > 0.0 and set(grads) == {"mat_fuzz"}
    assert grads["mat_fuzz"].shape == pf.mat_fuzz.shape
    assert float(grads["mat_fuzz"].abs().max()) == 0.0


def _many_slots(field):
    """Spheres in a row with ADJOINT_MIN_SLOTS slots of `field`'s family:
    33 metals (fuzz), 33 glasses (IOR), 11 spheres (3 center slots each)
    or 33 spheres (radii)."""
    mats = {"mat_fuzz": lambda i: pt.Metal((0.5, 0.5, 0.5), 0.01 * (i + 1)),
            "mat_ior": lambda i: pt.Dielectric(1.3 + 0.01 * i)}
    mat = mats.get(field, lambda i: pt.Lambertian(pt.SolidColor(
        (0.5, 0.5, 0.5))))
    n = 11 if field == "sph_center" else train.ADJOINT_MIN_SLOTS
    return pt.compile_scene(pt.Scene(objects=[
        pt.Sphere((3.0 * i, 0, 0), 1.0, mat(i)) for i in range(n)]))


@pytest.mark.parametrize("field", train.HARD_FIELDS)
def test_hard_families_raise(field, monkeypatch):
    """From ADJOINT_MIN_SLOTS hard slots a request takes the adjoint
    backward (K9), as the JAX package's does, on either engine: the plain
    engine trains it through the plain adjoint (one adjoint pass, no grad
    pass, a finite gradient of the family's shape), and on the (faked) card
    it reaches the kernels' render marked for the adjoint, without the
    NotImplementedError the port raised before K9. Below that bound every
    family takes the tangent bundles (tests/test_torch_hard_grad.py)."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    flat = _many_slots(field)
    slots = wc.hard_param_slots(flat, {field})
    assert len(slots) == train.ADJOINT_MIN_SLOTS
    assert train.use_adjoint(flat, slots, False)
    assert not train.use_adjoint(flat, slots[:-1], False)
    cam = pcam.derive(pt.CameraConfig(aspect_ratio=1.0, image_width=8))
    kw = dict(width=8, height=8, n_strata=1, max_depth=2)
    target = torch.zeros(8, 8, 3)
    grad_calls = wc.render_pass_grad_reference.calls
    adj_calls = ac.render_pass_adjoint_reference.calls
    loss, grads = train.render_loss_grad(flat, cam, 0, target,
                                         fields=(field,), **kw)
    assert ac.render_pass_adjoint_reference.calls == adj_calls + 1
    assert wc.render_pass_grad_reference.calls == grad_calls
    assert bool(torch.isfinite(loss))
    assert grads[field].shape == getattr(flat, field).shape
    assert bool(torch.isfinite(grads[field]).all())
    gated = _many_slots("sph_center")
    applied = []
    with monkeypatch.context() as m:
        m.setattr(FlatScene, "device",
                  property(lambda self: torch.device("cuda", 0)))
        render_image = train.make_kernel_render(gated, engine="cuda", **kw)
    monkeypatch.setattr(train._KernelRender, "apply",
                        lambda *a: applied.append(a[3])
                        or torch.zeros(8, 8, 3))
    calls = (wc.render_pass_reference.calls
             + wc.render_pass_grad_reference.calls
             + ac.render_pass_adjoint_reference.calls)
    render_image({field: getattr(gated, field),
                  "sph_center": gated.sph_center}, cam, 0)
    assert [r.adjoint for r in applied] == [True]
    assert len(applied[0].slots) >= train.ADJOINT_MIN_SLOTS
    assert (wc.render_pass_reference.calls
            + wc.render_pass_grad_reference.calls
            + ac.render_pass_adjoint_reference.calls) == calls


def test_engines_follow_the_gate(monkeypatch):
    """engine="cuda" on the CPU raises; on a (faked) card a scene outside
    the forward kernel's gate raises under auto, as render does; a scene
    the forward renders through the chunk scan (past the unrolled bounds)
    builds, and a request its grad kernels cannot serve (tex_color with 30
    fuzz slots and 80 radii: 110 hard slots) takes the adjoint (K9) at its
    first call, before any pass, where it raised NotImplementedError before
    K9, as does tex_color with 30 fuzz slots beside weight planes of more
    than MAX_TEXS rows (ADJOINT_PLANES_SLOTS), which the grad kernels
    serve (K3v with K4v) and the adjoint serves faster."""
    _, _, pf, pc, kw = _cornell(width=8, spp=1, depth=2)
    with pytest.raises(ValueError, match="CUDA"):
        train.make_kernel_render(pf, engine="cuda", **kw)
    mediums = pt.compile_scene(pt.Scene(objects=[pt.ConstantMedium(
        pt.Box((i, 0, 0), (i + 1, 1, 1),
               pt.Lambertian(pt.SolidColor((1, 1, 1)))),
        0.1, pt.SolidColor((1, 1, 1))) for i in range(5)]))
    spheres = pt.compile_scene(pt.Scene(objects=[
        pt.Sphere((3.0 * i, 0, 0), 1.0,
                  pt.Metal((0.5, 0.4 + 0.01 * i, 0.5), 0.3) if i < 30
                  else pt.Lambertian(pt.SolidColor((1, 1, 1))))
        for i in range(80)]))
    with monkeypatch.context() as m:
        m.setattr(FlatScene, "device",
                  property(lambda self: torch.device("cuda", 0)))
        with pytest.raises(ValueError, match="gate"):
            train.make_kernel_render(mediums, **kw)
        render = train.make_kernel_render(spheres, **kw)
    assert wc.grad_gate_reason(spheres, 30, True) is None
    applied = []
    monkeypatch.setattr(train._KernelRender, "apply",
                        lambda *a: applied.append(a[3])
                        or torch.zeros(8, 8, 3))
    render({"tex_color": spheres.tex_color,
            "mat_fuzz": spheres.mat_fuzz, "sph_radius": spheres.sph_radius},
           pc, 0)
    render({"tex_color": spheres.tex_color,
            "mat_fuzz": spheres.mat_fuzz}, pc, 0)
    assert [(len(r.slots), r.adjoint) for r in applied] == [(110, True),
                                                            (30, True)]


def test_plain_engine_on_the_card_stays_plain(monkeypatch):
    """engine="torch" on a (faked) card launches no kernel: a scene outside
    the kernels' gate (5 mediums) with a few hard slots keeps the plain
    tangent bundles (the refused forward gate is no reason for the
    adjoint, whose gate it is too), and an adjoint request of that plain
    engine gets the adjoint's plain version, not the kernel; on the CPU
    the same request trains through the plain tangent bundles."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    flat = pt.compile_scene(pt.Scene(objects=[pt.ConstantMedium(
        pt.Box((i, 0, 0), (i + 1, 1, 1),
               pt.Lambertian(pt.SolidColor((1, 1, 1)))),
        0.1, pt.SolidColor((1, 1, 1))) for i in range(5)] + [
        pt.Sphere((2.5, 0.5, -2), 0.5, pt.Dielectric(1.5)),
        pt.Sphere((0.5, 0.5, -2), 0.5, pt.Metal((0.8, 0.8, 0.8), 0.2))]))
    assert wc.kernel_gate_reason(flat) is not None
    fields = ("tex_color", "mat_ior", "mat_fuzz", "sph_radius")
    slots = train.grad_slots(flat, fields)
    assert 0 < len(slots) < train.ADJOINT_MIN_SLOTS
    assert not train.use_adjoint(flat, slots, True)
    cam = pcam.derive(pt.CameraConfig(aspect_ratio=1.0, image_width=8,
                                      lookfrom=(1.5, 1.5, 1),
                                      lookat=(1.5, 0.5, -2), vfov=60))
    kw = dict(width=8, height=8, n_strata=1, max_depth=3, sky_gradient=True)
    applied = []
    with monkeypatch.context() as m:
        m.setattr(FlatScene, "device",
                  property(lambda self: torch.device("cuda", 0)))
        render = train.make_kernel_render(flat, engine="torch", **kw)
    with monkeypatch.context() as m:
        m.setattr(train._KernelRender, "apply",
                  lambda *a: applied.append(a[:4]) or torch.zeros(8, 8, 3))
        render({f: getattr(flat, f) for f in fields}, cam, 0)
    (plan, _, _, req), = applied
    assert plan.engine == "torch" and not req.adjoint
    with monkeypatch.context() as m:
        m.setattr(FlatScene, "device",
                  property(lambda self: torch.device("cuda", 0)))
        for r, back in ((req, wc.render_pass_grad_reference),
                        (train._Request(req.names, req.slots, True),
                         ac.render_pass_adjoint_reference)):
            assert train._pass_functions(plan, flat, cam, r) == (
                wc.render_pass_reference, back)
    params = {f: getattr(flat, f).clone().requires_grad_(True)
              for f in fields}
    step = train.make_train_step(torch.optim.Adam(params.values(), lr=LR),
                                 flat=flat, engine="torch", **kw)
    calls = (wc.render_pass_grad_reference.calls,
             ac.render_pass_adjoint_reference.calls)
    loss = step(params, cam, 0, torch.zeros(8, 8, 3))
    assert (wc.render_pass_grad_reference.calls,
            ac.render_pass_adjoint_reference.calls) == (calls[0] + 1,
                                                        calls[1])
    assert bool(torch.isfinite(loss))
    for f, v in params.items():
        assert bool(torch.isfinite(v.grad).all()), f
    assert float(params["mat_ior"].grad.abs().max()) > 0.0
