"""Large-scene training's gradient tiers on the CPU: the plain versions of
the chunk scan's grad kernels (K3v weight planes, K4v tangent bundles) and
of the suffix-radiance kernel (K8), their compacted driver (K5) and the
training policy that picks them.

The plain grad pass tests every primitive in every mode, so on a chunk-scan
scene it is the semantics K3v and K4v claim; past MAX_GRAD_TEXS texture
rows it takes the suffix form, which is held against its own forced
weight-plane form with tests/test_grad.py::
test_suffix_tex_grad_matches_weight_planes's tolerance (image atol 1e-6, dG
rtol 1e-4, atol 1e-5), and every tier against the derivative of the JAX
package's pure-JAX replay (parallel/mesh.py::_tile_sample_render; jax.vjp
for tex_color, jax.jvp along each hard slot) with tests/test_grad.py's
tolerance for the fused tiers (rtol 2e-2, atol 2e-3); never a Pallas call
in interpret mode. Width <= 24, 4 samples, depth <= 4,
for the reason tests/test_torch_wavefront.py gives (XLA's CPU FMAs against
torch's two roundings). On bouncing_spheres, whose ground is a sphere of
radius 1000, that rounding parts a few paths even at depth 3 (the two
float32 images part at 5 of 312 pixels; in float64 the port's plain pass
and the JAX integrator agree there): against the replay the cotangent is
zeroed where the two images part by more than 1e-3, at most 2% of the
pixels, so that the gradients of the same paths are compared. Each scene's
JAX replay gradient is computed once per module. The kernels themselves run
only on a GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
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
    camera_from_numpy, camera_to_numpy, flat_from_numpy, flat_to_numpy)
from real_time_ray_tracing_engine_tpu_torch.scene.flat import (
    FlatScene, MAT_DIELECTRIC, MAT_METAL)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)
from torch_threads import one_torch_thread  # noqa: E402,F401

REPLAY_TOL = dict(rtol=2e-2, atol=2e-3)


def _bouncing(m):
    """bouncing_spheres under the sky gradient, as
    tests/test_grad.py::test_bouncing_spheres_suffix_grad_matches_kernel_fd
    renders it."""
    scene = m.builders.bouncing_spheres(image_width=24)
    scene.camera.sky_gradient = True
    return scene


# name -> (scene builder over a schema module, width, depth, seed, the
# cotangent's numpy seed)
SCENES = {
    "suffix41": (cs.suffix_scene, 24, 4, 0, 5),
    "bouncing": (_bouncing, 24, 3, 3, 9),
    "scan_tex": (cs.scan_tex_scene, 16, 3, 5, 2),
    "rows28": (cs.rows_scene, 24, 4, 0, 31),
    "vscan_slots": (cs.vscan_slots_scene, 24, 4, 0, 21),
}


@functools.cache
def _case(name):
    """Both packages' state for one scene (the JAX flat and camera, the
    port's carried across as numpy), the pass keywords, the seed and the
    cotangent."""
    build, width, depth, seed, g_seed = SCENES[name]
    scene = build(rt)
    scene.camera.image_width = width
    jf, jc = rt.compile_scene(scene), jcam.derive(scene.camera)
    pf = flat_from_numpy(*flat_to_numpy(jf), device="cpu")
    pc = camera_from_numpy(camera_to_numpy(jc), device="cpu")
    w, h = jcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=2, max_depth=depth, n_samples=4,
              sky_gradient=scene.camera.sky_gradient)
    g = np.random.default_rng(g_seed).normal(size=(h, w, 3)).astype(
        np.float32)
    return jf, jc, pf, pc, kw, seed, g


def _replay(name):
    """The case's JAX replay as a function of a dict of its tables."""
    jf, jc, _, _, kw, seed, _ = _case(name)

    def replay(p):
        return _tile_sample_render(
            jtrain.set_params(jf, p), jc, jnp.uint32(seed),
            width=kw["width"], height_local=kw["height"],
            row0=jnp.asarray(0, jnp.int32), n_strata=kw["n_strata"],
            spp_local=kw["n_samples"], sample0=jnp.asarray(0, jnp.int32),
            max_depth=kw["max_depth"], sky_gradient=kw["sky_gradient"])
    return replay


def _shared_paths(name, img):
    """The case's cotangent zeroed where the replay's image `img` and the
    port's plain image part by more than 1e-3 (see the top of this
    file)."""
    _, _, pf, pc, kw, seed, g = _case(name)
    ours = wc.render_pass_reference(pf, pc, seed, 0, **kw).numpy()
    same = np.abs(np.asarray(img) - ours).max(-1) <= 1e-3
    assert same.mean() >= 0.98, same.mean()
    return g * same[..., None]


@functools.cache
def _replay_tex_grad(name):
    """(jax.vjp of the JAX replay wrt tex_color at _shared_paths' cotangent,
    that cotangent), once per module."""
    jf = _case(name)[0]
    img, vjp = jax.vjp(_replay(name), {"tex_color": jf.tex_color})
    g = _shared_paths(name, img)
    (dp,) = vjp(jnp.asarray(g))
    return np.asarray(dp["tex_color"]), g


def _grad(name, g=None, **kw2):
    """The plain grad pass of a case, at its cotangent or `g`."""
    _, _, pf, pc, kw, seed, g0 = _case(name)
    return wc.render_pass_grad_reference(
        pf, pc, seed, 0, cotangent=torch.from_numpy(g0 if g is None else g),
        **kw, **kw2)


def test_suffix_matches_weight_planes():
    """The suffix form (41 rows, past MAX_GRAD_TEXS) against the exact
    weight planes forced at the same row count, the JAX package's own
    oracle for it: the same image, dG_tex to rounding; each sample traced
    twice."""
    _, _, pf, pc, kw, seed, g = _case("suffix41")
    assert wc.kernel_mode(pf)[0] == "vscan"
    assert pf.tex_type.shape[0] > wc.MAX_GRAD_TEXS
    assert wc.tex_form(pf) == "suffix"
    assert wc.tex_form(pf, force_planes=True) == "planes"
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    it_s = torch.zeros(n_lanes, dtype=torch.int32)
    it_f = torch.zeros_like(it_s)
    img_s, dg_s, dgh = _grad("suffix41", iters=it_s)
    img_w, dg_w, _ = _grad("suffix41", force_planes=True)
    fwd = wc.render_pass_reference(pf, pc, seed, 0, iters=it_f, **kw)
    assert dgh.shape == (0,)
    np.testing.assert_allclose(img_s.numpy(), img_w.numpy(), atol=1e-6)
    np.testing.assert_array_equal(img_s.numpy(), fwd.numpy())
    assert np.abs(dg_w.numpy()).max() > 0.05           # real signal
    np.testing.assert_allclose(dg_s.numpy(), dg_w.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert int(it_s.sum()) == 2 * int(it_f.sum())


@pytest.mark.parametrize("name", ["bouncing"])
def test_suffix_tex_grad_matches_jax_replay(name):
    """The suffix form's dG_tex against the JAX replay's vjp on bouncing
    spheres (460 rows: movers, the checker ground, metal and glass, no MIS
    light, a sky gradient; tests/test_grad.py::
    test_bouncing_spheres_suffix_grad_matches_kernel_fd's scene and
    depth)."""
    _, _, pf, _, _, _, _ = _case(name)
    assert wc.tex_form(pf) == "suffix"
    want, g = _replay_tex_grad(name)
    _, dg, _ = _grad(name, g)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(dg.numpy(), want, **REPLAY_TOL)


def test_vscan_weight_planes_match_jax_replay():
    """Weight planes on a chunk-scan scene (K3v's semantics: 80 spheres and
    a quad light, 7 rows, a checker among them) against the replay."""
    _, _, pf, _, _, _, _ = _case("scan_tex")
    assert wc.kernel_mode(pf)[0] == "vscan"
    assert wc.tex_form(pf) == "planes"
    assert pf.tex_type.shape[0] <= wc.MAX_TEXS
    assert wc.grad_gate_reason(pf) is None
    want, g = _replay_tex_grad("scan_tex")
    _, dg, _ = _grad("scan_tex", g)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(dg.numpy(), want, **REPLAY_TOL)


def test_vscan_weight_planes_28_rows_match_jax_replay():
    """Weight planes on a chunk-scan scene of 28 texture rows, between
    MAX_TEXS and MAX_GRAD_TEXS (K3v's semantics where the kernel's Gp sums
    reduce in lane order: 79 spheres over 24 lambertian albedos, 2 metals
    and a glass, and a sphere light), against the replay."""
    _, _, pf, _, _, _, _ = _case("rows28")
    assert wc.kernel_mode(pf)[0] == "vscan"
    assert wc.tex_form(pf) == "planes"
    assert wc.MAX_TEXS < pf.tex_type.shape[0] == 28 <= wc.MAX_GRAD_TEXS
    assert wc.grad_gate_reason(pf) is None
    want, g = _replay_tex_grad("rows28")
    _, dg, _ = _grad("rows28", g)
    assert np.abs(want).max() > 0.05
    assert (np.abs(want).max(axis=1) > 0).sum() >= 20   # most rows seen
    np.testing.assert_allclose(dg.numpy(), want, **REPLAY_TOL)


def test_vscan_hard_slots_match_jax_replay():
    """One tangent bundle per hard family on a chunk-scan scene (K4v's
    semantics; tests/test_grad.py::test_vscan_hard_slots_match_kernel_fd's
    scene and slots: a metal's fuzz, the glass's IOR, sphere 7's center y
    and radius) against <g, the replay's jax.jvp along each slot's unit
    tangent> (the four batched with jax.vmap: the vjp's derivative at a
    fraction of its cost on this CPU)."""
    jf, _, pf, _, _, _, _ = _case("vscan_slots")
    slots = cs.vscan_slots(pf.mat_type, MAT_METAL, MAT_DIELECTRIC)
    assert wc.grad_gate_reason(pf, len(slots)) is None
    p0 = {f: getattr(jf, f) for f in wc.HARD_FIELDS}
    tangents = []
    for slot in slots:
        f, idx = wc.slot_index(slot)
        t = {k: jnp.zeros_like(v) for k, v in p0.items()}
        t[f] = t[f].at[idx].set(1.0)
        tangents.append(t)
    img, tans = jax.vmap(lambda t: jax.jvp(_replay("vscan_slots"), (p0,),
                                           (t,)))(
        jax.tree_util.tree_map(lambda *a: jnp.stack(a), *tangents))
    g = _shared_paths("vscan_slots", img[0])
    want = (np.asarray(tans) * g).sum(axis=(1, 2, 3))
    _, dgt, dgh = _grad("vscan_slots", g, hard_slots=slots, want_tex=False)
    assert dgt is None
    assert (np.abs(want) > 1e-2).all()                  # real signal
    for k, slot in enumerate(slots):
        np.testing.assert_allclose(dgh.numpy()[k], want[k],
                                   err_msg=f"{slot}", **REPLAY_TOL)


def test_suffix_zero_albedo_channel_gets_no_scatter_gradient():
    """The suffix form's known limit, which the port keeps from the JAX
    package: a channel whose albedo is exactly 0 gets a 0 scatter gradient
    (its (T - P) / at term is dropped where |at| <= 1e-8), where the weight
    planes give the true one-sided derivative."""
    _, _, pf, pc, kw, seed, g = _case("suffix41")
    _, dg_w, _ = _grad("suffix41", force_planes=True)
    row = int(np.argmax(np.abs(dg_w.numpy()[:, 0])))
    tc = pf.tex_color.clone()
    tc[row, 0] = 0.0
    dark = train.set_params(pf, {"tex_color": tc})
    common = dict(cotangent=torch.from_numpy(g), **kw)
    _, dz_s, _ = wc.render_pass_grad_reference(dark, pc, seed, 0, **common)
    _, dz_w, _ = wc.render_pass_grad_reference(dark, pc, seed, 0,
                                               force_planes=True, **common)
    assert abs(float(dz_w[row, 0])) > 1e-3
    assert float(dz_s[row, 0]) == 0.0
    # the other channels of the row and the other rows keep their values
    keep = torch.ones_like(dz_s, dtype=torch.bool)
    keep[row, 0] = False
    np.testing.assert_allclose(dz_s[keep].numpy(), dz_w[keep].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_suffix_compacted_matches_single():
    """The compacted schedule (K5) carries the suffix state (phase, T, P)
    across its phases: the image and dG_tex equal the single pass's to
    rounding; a capped pass's carry has the suffix rows. (With hard slots
    riding the suffix tier it is checked on the card, chip_smoke.py.)"""
    _, _, pf, pc, kw, seed, g = _case("suffix41")
    slots = ()
    cot = torch.from_numpy(g)
    img1, dg1, dh1 = _grad("suffix41", hard_slots=slots)
    img2, dg2, dh2 = wc.render_pass_grad_compacted(
        pf, pc, seed, 0, cotangent=cot, hard_slots=slots, caps=(3, 2), **kw)
    np.testing.assert_allclose(img2.numpy(), img1.numpy(), atol=1e-5)
    np.testing.assert_allclose(dg2.numpy(), dg1.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert dh1.shape == dh2.shape == (0,)
    out = wc.render_pass_grad_reference(pf, pc, seed, 0, cotangent=cot,
                                        cap=2, **kw)
    assert out[3].shape == (wc.CARRY_ROWS + wc.SUFFIX_ROWS,
                            wc.lane_count(kw["width"] * kw["height"]))


def test_suffix_total_after_each_bounce_is_the_replay_prefix():
    """The premise of the suffix tier's single pass (csrc/wavefront.cu,
    K8): at every bounce, phase A's running path total equals phase B's
    prefix at the same bounce of the same sample, bit for bit (both start
    at 0 and add the same increments in the same order), so the prefix a
    route needs is the total the one trace already holds. Stepped one
    iteration at a time through the plain version's carry (its phase, T
    and P rows) on bouncing_spheres; fails if the two sums ever part."""
    _, _, pf, pc, kw, seed, g = _case("bouncing")
    cot = torch.from_numpy(g)
    sb = wc.CARRY_ROWS
    totals, prefixes = {}, {}
    carry, steps = None, 0
    while carry is None or bool((carry[0] > 0.5).any()):
        # the lanes that trace a bounce in this iteration
        lanes = (torch.nonzero(carry[0] > 0.5).squeeze(1)
                 if carry is not None else None)
        carry = wc.render_pass_grad_reference(
            pf, pc, seed, 0, cotangent=cot, cap=1, carry=carry, **kw)[3]
        steps += 1
        assert steps < 200
        if lanes is None:
            lanes = torch.arange(carry.shape[1])
        phb = carry[sb] > 0.5
        for lane in lanes.tolist():
            key = (lane, int(carry[3, lane]), int(carry[2, lane]))
            if bool(phb[lane]):
                prefixes[key] = carry[sb + 4:sb + 7, lane].clone()
            else:
                totals[key] = carry[sb + 1:sb + 4, lane].clone()
    assert len(prefixes) > 1000
    assert set(prefixes) <= set(totals)
    nonzero = 0
    for key, p in prefixes.items():
        t = totals[key]
        assert torch.equal(t.view(torch.int32), p.view(torch.int32)), \
            (key, t.tolist(), p.tolist())
        nonzero += bool((p != 0).any())
    assert nonzero > 100


def _metals_scene(n_metals=30):
    """A chunk-scan scene of n_metals metals of their own albedos and 50
    lambertians of one: n_metals + 1 texture rows and n_metals fuzz
    slots."""
    lam = pt.Lambertian(pt.SolidColor((0.5, 0.5, 0.5)))
    return pt.compile_scene(pt.Scene(objects=[
        pt.Sphere((3.0 * i, 0, 0), 1.0,
                  pt.Metal((0.5, 0.4 + 0.01 * i, 0.5), 0.3)
                  if i < n_metals else lam) for i in range(80)]))


def test_large_grad_gates(capsys):
    """The grad gates admit the JAX fused tiers on the chunk scan (tex_color
    at any row count, up to MAX_HARD_SLOTS slots) and name what they cannot
    serve: K9/K10 past MAX_HARD_SLOTS slots. A launch's shared memory
    counts the chunk boxes and the tangent planes only (the weight planes
    of up to 32 rows and their sums are rows of global memory, as the
    suffix tier's are), so 30 slots beside the metals' planes fit a
    block. Building a render over a suffix scene prints the JAX
    package's zero-albedo notice."""
    bouncing = pt.compile_scene(pt.builders.bouncing_spheres())
    assert wc.tex_form(bouncing) == "suffix"
    assert wc.grad_gate_reason(bouncing) is None
    ior = wc.hard_param_slots(bouncing, {"mat_ior"})
    assert len(ior) == 1 and wc.grad_gate_reason(bouncing, 1) is None
    fuzz = wc.hard_param_slots(bouncing, {"mat_fuzz"})
    assert len(fuzz) == 72
    assert "K9/K10" in wc.grad_gate_reason(bouncing, len(fuzz))
    assert wc.grad_smem_bytes(bouncing, 1) == 4 * (32 + 10 * 128)
    metals = _metals_scene()
    NT = metals.tex_type.shape[0]
    assert wc.MAX_TEXS < NT <= wc.MAX_GRAD_TEXS
    assert wc.tex_form(metals) == "planes"
    assert wc.grad_gate_reason(metals) is None
    assert wc.grad_smem_bytes(metals, 30) == 4 * (32 + 10 * 30 * 128)
    assert wc.grad_smem_bytes(metals, 32) <= wc.MAX_SHARED_BYTES
    assert wc.grad_gate_reason(metals, 30) is None
    assert wc.grad_gate_reason(metals, 30, want_tex=False) is None
    assert "K9/K10" in wc.grad_gate_reason(metals, 33)
    cornell = pt.compile_scene(pt.builders.cornell_box())
    assert wc.tex_form(cornell) == "planes"
    assert wc.grad_gate_reason(cornell, 9) is None
    capsys.readouterr()
    train.make_kernel_render(bouncing, width=8, height=5, n_strata=1,
                             max_depth=2)
    assert "suffix-radiance estimator" in capsys.readouterr().out
    train.make_kernel_render(cornell, width=8, height=8, n_strata=1,
                             max_depth=2)
    assert capsys.readouterr().out == ""


def test_requests_the_kernels_cannot_serve_raise(monkeypatch):
    """On the (faked) card, a request the forward-mode kernels cannot
    serve (33 or more hard slots: tex_color, 30 fuzz slots and 80 radii),
    which raised NotImplementedError before the adjoint was ported, takes
    the adjoint (K9) at its first call, before any pass, and so does
    tex_color with the 30 fuzz slots (weight planes of more than MAX_TEXS
    rows beside ADJOINT_PLANES_SLOTS slots or more: K9 measured faster
    than K3v with K4v, which the kernels now serve); tex_color alone and
    the fuzz slots alone keep the forward-mode tiers."""
    flat = _metals_scene()
    cam = pcam.derive(pt.CameraConfig(image_width=8))
    applied = []
    with monkeypatch.context() as m:
        m.setattr(FlatScene, "device",
                  property(lambda self: torch.device("cuda", 0)))
        render = train.make_kernel_render(flat, width=8, height=5,
                                          n_strata=1, max_depth=2)
    monkeypatch.setattr(train._KernelRender, "apply",
                        lambda *a: applied.append(a[3])
                        or torch.zeros(5, 8, 3))
    assert wc.grad_gate_reason(flat, 30) is None
    render({"tex_color": flat.tex_color, "mat_fuzz": flat.mat_fuzz},
           cam, 0)
    render({"tex_color": flat.tex_color, "mat_fuzz": flat.mat_fuzz,
            "sph_radius": flat.sph_radius}, cam, 0)
    render({"tex_color": flat.tex_color}, cam, 0)
    render({"mat_fuzz": flat.mat_fuzz}, cam, 0)
    assert [(r.names, len(r.slots), r.adjoint) for r in applied] == [
        (("tex_color", "mat_fuzz"), 30, True),
        (("tex_color", "mat_fuzz", "sph_radius"), 110, True),
        (("tex_color",), 0, False), (("mat_fuzz",), 30, False)]
