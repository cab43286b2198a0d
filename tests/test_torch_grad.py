"""The tex_color gradient pass's plain torch version (the CUDA kernel K3's
semantics) and its compacted driver (K5), on the CPU.

render_pass_grad_reference's dG_tex is held against jax.vjp of the JAX
package's pure-JAX replay (parallel/mesh.py::_tile_sample_render), the
semantics the JAX grad kernel claims, with tests/test_grad.py's tolerance
(rtol 2e-2, atol 2e-3); never a Pallas call in interpret mode. Depth stays
at 4 for the reason tests/test_torch_wavefront.py gives: XLA's CPU backend
contracts FMAs under jit, torch does not, and deep grazing paths part ways.
Against central differences of the port's own forward pass the tolerance
is tests/test_grad.py's rtol 5e-3: tex_color changes no sampling decision,
so common-random-numbers differences are near exact. The kernel itself runs
only on a GPU (tests/test_torch_cuda.py).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import real_time_ray_tracing_engine_tpu as rt
from real_time_ray_tracing_engine_tpu.models import camera as jcam
from real_time_ray_tracing_engine_tpu.parallel.mesh import \
    _tile_sample_render
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.scene.convert import (
    camera_from_numpy, camera_to_numpy, flat_from_numpy, flat_to_numpy)
from real_time_ray_tracing_engine_tpu_torch.scene.flat import (
    TEX_CHECKER, TEX_NOISE)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _nested_checker(m):
    """A depth-2 checker DAG over solid and marble leaves under a sky
    gradient (tests/test_pallas.py::test_nested_checker_matches_oracle),
    built from either package's schema module `m`."""
    inner = m.Checker(0.31, m.SolidColor((0.9, 0.1, 0.1)),
                      m.SolidColor((0.1, 0.1, 0.9)))
    tex = m.Checker(1.1, inner, m.Noise(3.0))
    cam = m.CameraConfig(aspect_ratio=1.0, image_width=16,
                         samples_per_pixel=4, max_depth=4,
                         lookfrom=(0, 2, 6), lookat=(0, 1, 0),
                         sky_gradient=True)
    return m.Scene(objects=[
        m.Quad((-8, 0.513, -8), (16, 0, 0), (0, 0, 16), m.Lambertian(tex)),
        m.Sphere((0, 1.5, 0), 1.0, m.Lambertian(tex))], camera=cam,
        name="nested_checker")


def _jax_scene(name):
    if name == "nested_checker":
        return _nested_checker(rt)
    scene = rt.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = 16
    return scene


def _port_args(name, width=16, spp=4, depth=4):
    """Both packages' state for one scene: the JAX flat and camera, and the
    port's carried across as numpy, plus the pass keywords."""
    scene = _jax_scene(name)
    scene.camera.image_width = width
    jf, jc = rt.compile_scene(scene), jcam.derive(scene.camera)
    pf = flat_from_numpy(*flat_to_numpy(jf), device="cpu")
    pc = camera_from_numpy(camera_to_numpy(jc), device="cpu")
    w, h = jcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=int(np.sqrt(spp)),
              max_depth=depth, n_samples=spp,
              sky_gradient=scene.camera.sky_gradient)
    return jf, jc, pf, pc, kw


def _cotangent(h, w, seed):
    return np.random.default_rng(seed).normal(size=(h, w, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke",
                                  "nested_checker"])
def test_grad_matches_jax_replay(name):
    """dG_tex = d<g, radiance sum>/d tex_color against the replay's vjp:
    Cornell (albedo and emission rows), Cornell smoke (the medium tint rows
    through the isotropic scatter), the nested checker (leaf routing; the
    checker and marble rows get no gradient)."""
    jf, jc, pf, pc, kw = _port_args(name)
    w, h = kw["width"], kw["height"]
    g = _cotangent(h, w, 4)
    seed = 3

    def replay(tc):
        return _tile_sample_render(
            jf.replace(tex_color=tc), jc, jnp.uint32(seed), width=w,
            height_local=h, row0=jnp.asarray(0, jnp.int32),
            n_strata=kw["n_strata"], spp_local=kw["n_samples"],
            sample0=jnp.asarray(0, jnp.int32), max_depth=kw["max_depth"],
            sky_gradient=kw["sky_gradient"])

    _, vjp = jax.vjp(replay, jf.tex_color)
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    img, dg, _ = wc.render_pass_grad_reference(pf, pc, seed, 0,
                                               cotangent=torch.from_numpy(g),
                                               **kw)
    got = dg.numpy()
    assert img.shape == (h, w, 3) and got.shape == want.shape
    assert np.abs(want).max() > 0.05          # real signal
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)
    if name == "nested_checker":
        ttype = pf.tex_type.numpy()
        routed = (ttype == TEX_CHECKER) | (ttype == TEX_NOISE)
        assert routed.any() and (ttype == TEX_NOISE).any()
        np.testing.assert_array_equal(got[routed], 0.0)
        assert np.abs(got[~routed]).min() > 0.0
    if name == "cornell_smoke":
        tints = pf.mat_tex.numpy()[pf.med_mat.numpy()]
        assert np.abs(got[tints]).max() > 0.05


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke",
                                  "nested_checker"])
def test_grad_image_is_the_forward_image(name):
    """The grad pass traces the forward pass's paths: the same image, bit
    for bit (tests/test_grad.py:226-228 holds the JAX kernel to 1e-6)."""
    _, _, pf, pc, kw = _port_args(name, width=8, depth=6)
    g = torch.from_numpy(_cotangent(kw["height"], kw["width"], 1))
    img, _, _ = wc.render_pass_grad_reference(pf, pc, 9, 2, cotangent=g,
                                              **kw)
    img0 = wc.render_pass_reference(pf, pc, 9, 2, **kw)
    np.testing.assert_array_equal(img.numpy(), img0.numpy())


def test_grad_matches_central_differences():
    """tests/test_grad.py::test_fused_tex_grad_matches_kernel_fd on the
    plain version: 12 x 12 pixels fill 144 of 256 lanes, so the pad lanes
    (which repeat the last pixel) must get a zero cotangent."""
    _, _, pf, pc, kw = _port_args("cornell_box", width=12, depth=3)
    assert wc.lane_count(kw["width"] * kw["height"]) > \
        kw["width"] * kw["height"]
    g = torch.from_numpy(_cotangent(kw["height"], kw["width"], 1))
    _, dg, _ = wc.render_pass_grad_reference(pf, pc, 5, 0, cotangent=g,
                                             **kw)
    tc = pf.tex_color
    eps = 1e-3
    checked = 0
    for t in range(tc.shape[0]):
        if abs(float(dg[t, 0])) < 1e-4:
            continue
        p, m = tc.clone(), tc.clone()
        p[t, 0] += eps
        m[t, 0] -= eps
        d = (wc.render_pass_reference(dataclasses.replace(pf, tex_color=p),
                                      pc, 5, 0, **kw)
             - wc.render_pass_reference(dataclasses.replace(pf, tex_color=m),
                                        pc, 5, 0, **kw))
        fd = float((d * g).sum() / (2 * eps))
        np.testing.assert_allclose(float(dg[t, 0]), fd, rtol=5e-3,
                                   err_msg=f"tex {t}")
        checked += 1
    assert checked >= 3


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_grad_compacted_matches_single(name):
    """K5 on the plain version, caps (12, 6): 20 x 20 pixels fill 400 of
    512 lanes, so pad lanes are permuted with the rest. The weight planes
    ride the carry, the cotangent is permuted with the lanes, and dG_tex
    (a sum over lanes) is summed across phases: the same image and
    gradient up to the order of the sums."""
    _, _, pf, pc, kw = _port_args(name, width=20, depth=8)
    n_pix = kw["width"] * kw["height"]
    assert n_pix % wc.LANE_BLOCK != 0
    g = torch.from_numpy(_cotangent(kw["height"], kw["width"], 2))
    img, dg, _ = wc.render_pass_grad_reference(pf, pc, 7, 3, cotangent=g,
                                               **kw)
    img2, dg2, _ = wc.render_pass_grad_compacted(pf, pc, 7, 3, cotangent=g,
                                                 caps=(12, 6), **kw)
    np.testing.assert_allclose(img2.numpy(), img.numpy(), atol=1e-5)
    scale = float(dg.abs().max())
    assert scale > 0.05
    np.testing.assert_allclose(dg2.numpy(), dg.numpy(), rtol=1e-4,
                               atol=1e-4 * scale)
    # the capped pass really carried mid-path weight planes
    rad, dg1, _, st = wc.render_pass_grad_reference(pf, pc, 7, 3,
                                                    cotangent=g, cap=12,
                                                    **kw)
    nt = pf.tex_type.shape[0]
    assert st.shape == (wc.CARRY_ROWS + 3 * nt, rad.shape[1])
    assert bool((st[wc.CARRY_ROWS:] != 0).any())
    # caps == () is one uncapped grad pass
    img3, dg3, _ = wc.render_pass_grad_compacted(pf, pc, 7, 3, cotangent=g,
                                                 caps=(), **kw)
    np.testing.assert_array_equal(dg3.numpy(), dg.numpy())


def test_grad_pass_dispatch_and_counts():
    """On the CPU the grad pass is the plain version and nothing else; the
    kernel's wrapper refuses CPU tensors and malformed cotangents."""
    _, _, pf, pc, kw = _port_args("cornell_box", width=8, spp=1, depth=2)
    assert wc.grad_pass_function(pf, pc) is wc.render_pass_grad_reference
    g = torch.zeros(kw["height"], kw["width"], 3)
    with pytest.raises(ValueError, match="CUDA"):
        wc.render_pass_grad_kernel(pf, pc, 0, 0, cotangent=g, **kw)
    with pytest.raises(ValueError, match="cotangent"):
        wc.render_pass_grad_reference(pf, pc, 0, 0, cotangent=g[1:], **kw)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    calls = wc.render_pass_grad_reference.calls
    iters = torch.zeros(n_lanes, dtype=torch.int32)
    wc.render_pass_grad_reference(pf, pc, 0, 0, cotangent=g, iters=iters,
                                  **kw)
    assert wc.render_pass_grad_reference.calls == calls + 1
    # one sample of at most 2 bounces per lane
    assert 1 <= int(iters.min()) and int(iters.max()) <= 2
    lanes = wc.cotangent_lanes(torch.ones_like(g), width=kw["width"],
                               height=kw["height"])
    assert lanes.shape == (3, n_lanes)
    assert float(lanes[:, :kw["width"] * kw["height"]].min()) == 1.0
    assert float(lanes[:, kw["width"] * kw["height"]:].abs().max()) == 0.0
