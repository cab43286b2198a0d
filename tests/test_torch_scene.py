"""The port's scene pipeline against the JAX package's: schema JSON, compiled
tables, state carried across as numpy, camera, kernel tables and the kernel
gate."""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import real_time_ray_tracing_engine_tpu as rt
import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu.models import camera as jcam
from real_time_ray_tracing_engine_tpu.ops import wavefront_pallas as wp
from real_time_ray_tracing_engine_tpu.utils import rng as jrng
from real_time_ray_tracing_engine_tpu_torch.models import camera as pcam
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.scene.convert import (
    camera_from_numpy, flat_from_numpy, flat_to_numpy)
from real_time_ray_tracing_engine_tpu_torch.scene.flat import STATIC_FIELDS
from real_time_ray_tracing_engine_tpu_torch.utils import rng as prng
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCENES = ["cornell_box", "cornell_smoke", "simple_sphere", "three_spheres",
          "bouncing_spheres"]


def jax_flat_numpy(flat):
    arrays = {n: np.asarray(getattr(flat, n))
              for n in flat.__dataclass_fields__
              if n not in STATIC_FIELDS and getattr(flat, n) is not None}
    meta = {n: getattr(flat, n) for n in STATIC_FIELDS}
    return arrays, meta


@pytest.mark.parametrize("name", SCENES)
def test_compile_scene_tables_match(name):
    jf = rt.compile_scene(rt.builders.BUILTIN_SCENES[name]())
    pf = pt.compile_scene(pt.builders.BUILTIN_SCENES[name]())
    arrays, meta = jax_flat_numpy(jf)
    for n, a in arrays.items():
        b = getattr(pf, n).numpy()
        assert b.dtype == a.dtype, (n, b.dtype, a.dtype)
        np.testing.assert_array_equal(b, a, err_msg=n)
    for n in STATIC_FIELDS:
        assert getattr(pf, n) == meta[n], n
    assert pt.golden_json(pf) == rt.compile_scene.__globals__[
        "golden_json"](jf)


def test_scene_json_round_trip():
    for name in pt.builders.BUILTIN_SCENES:
        if name in ("bouncing_spheres", "textured_spheres"):
            continue        # large; same code path as the rest
        s = pt.builders.BUILTIN_SCENES[name]()
        text = pt.scene_to_json(s)
        # the JSON is the contract: both packages write the same text
        assert text == rt.scene_to_json(rt.builders.BUILTIN_SCENES[name]())
        s2 = pt.scene_from_json(text)
        assert pt.golden_json(pt.compile_scene(s2)) == \
            pt.golden_json(pt.compile_scene(s))
        # and read each other's
        j2 = rt.scene_from_json(text)
        assert rt.scene_to_json(j2) == text


def test_flat_from_numpy_round_trip():
    jf = rt.compile_scene(rt.builders.cornell_smoke())
    arrays, meta = jax_flat_numpy(jf)
    pf = flat_from_numpy(arrays, meta, device="cpu")
    assert pt.golden_json(pf) == pt.golden_json(
        pt.compile_scene(pt.builders.cornell_smoke()))
    arrays2, meta2 = flat_to_numpy(pf)
    assert set(arrays2) == set(arrays)
    for n in arrays:
        np.testing.assert_array_equal(arrays2[n], arrays[n], err_msg=n)
        assert arrays2[n].dtype == arrays[n].dtype, n
    assert meta2 == meta
    with pytest.raises(KeyError):
        flat_from_numpy({k: v for k, v in arrays.items()
                         if k != "quad_u"}, meta, device="cpu")


@pytest.mark.parametrize("name", ["cornell_box", "three_spheres"])
def test_camera_derive_and_rays(name):
    cfg_j = rt.builders.BUILTIN_SCENES[name]().camera
    cfg_j.image_width = 40
    cfg_p = pt.builders.BUILTIN_SCENES[name]().camera
    cfg_p.image_width = 40
    cj = jcam.derive(cfg_j)
    cp = pcam.derive(cfg_p)
    for f in ("center", "pixel00", "pixel_du", "pixel_dv", "defocus_u",
              "defocus_v", "defocus_on", "background"):
        np.testing.assert_allclose(getattr(cp, f).numpy(),
                                   np.asarray(getattr(cj, f)), atol=1e-6,
                                   rtol=1e-6, err_msg=f)
    carried = camera_from_numpy({f: np.asarray(getattr(cj, f)) for f in
                                 ("center", "pixel00", "pixel_du",
                                  "pixel_dv", "defocus_u", "defocus_v",
                                  "defocus_on", "background")}, "cpu")
    w, h = pcam.image_size(cfg_p)
    assert (w, h) == jcam.image_size(cfg_j)
    n_strata = pcam.sqrt_spp(cfg_p)
    pix = np.arange(w * h)
    for s in (0, n_strata * n_strata - 1):
        jk = jrng.ray_keys(jnp.uint32(3), jnp.asarray(pix, jnp.uint32),
                           jnp.uint32(s))
        pk = prng.ray_keys(3, torch.from_numpy(pix), s)
        jo, jd, jt = jcam.generate_rays(cj, w, jnp.asarray(pix),
                                        jnp.int32(s), n_strata, jk)
        po, pd, ptm = pcam.generate_rays(carried, w, torch.from_numpy(pix),
                                         s, n_strata, pk)
        scale = np.abs(np.asarray(jo)).max() + np.abs(np.asarray(jd)).max()
        np.testing.assert_allclose(po.numpy(), np.asarray(jo),
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd),
                                   atol=1e-6 * scale)
        np.testing.assert_array_equal(ptm.numpy(), np.asarray(jt))


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_pack_tables_match(name):
    jf = rt.compile_scene(rt.builders.BUILTIN_SCENES[name]())
    pf = pt.compile_scene(pt.builders.BUILTIN_SCENES[name]())
    names = ("sphf", "quadf", "prim_mat", "lightf", "mati", "matf", "texf",
             "primmatf", "medf")
    jax_tables = dict(zip(names, wp._pack_tables(jf)))
    # the resolved per-prim rows are a TPU gather workaround: the port's
    # chunk scan indexes the scene tables by the winner's original id
    del jax_tables["primmatf"]
    port_tables = wc._pack_tables(pf)
    assert len(port_tables) == len(jax_tables)
    for (n, a), b in zip(jax_tables.items(), port_tables):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=n)


def _dedup_scene(mod):
    """Rows that == would merge and JSON keeps apart (1, 1.0 and True;
    0.0 and -0.0) and NaN rows that JSON merges, in either package's
    schema."""
    nan = float("nan")
    colors = [(1, 1, 1), (1.0, 1.0, 1.0), (True, 1, 1), (0.0, 0.5, 0.5),
              (-0.0, 0.5, 0.5), (nan, 0.5, 0.5), (nan, 0.5, 0.5),
              (np.float64(0.25), 0.5, 0.5), (0.25, 0.5, 0.5)]
    objs = [mod.Sphere((i * 3.0, 0, 0), 1.0,
                       mod.Lambertian(mod.SolidColor(c)))
            for i, c in enumerate(colors)]
    objs += [mod.Sphere((0, 3.0, i), 1.0, m) for i, m in enumerate([
        mod.Metal((0.5, 0.5, 0.5), 0.0), mod.Metal((0.5, 0.5, 0.5), -0.0),
        mod.Dielectric(1.5), mod.Dielectric(1.5),
        mod.Lambertian(mod.Noise(0.0)), mod.Lambertian(mod.Noise(-0.0))])]
    return mod.Scene(objects=objs)


def test_compile_dedup_follows_json():
    """The port interns rows by a key of their values, the JAX package by
    their json.dumps text: the same rows in the same order."""
    jf = rt.compile_scene(_dedup_scene(rt))
    pf = pt.compile_scene(_dedup_scene(pt))
    arrays, _ = jax_flat_numpy(jf)
    for n in ("mat_type", "mat_tex", "mat_fuzz", "mat_ior", "tex_type",
              "tex_color", "tex_scale", "sph_mat"):
        np.testing.assert_array_equal(getattr(pf, n).numpy(), arrays[n],
                                      err_msg=n)
    assert pf.tex_type.shape[0] == 10 and pf.mat_type.shape[0] == 12


def test_prepare_kernel_packs_a_host_scene_on_the_host(monkeypatch):
    """A scene on the host is packed there and sent to the card by _send
    (here handing the host buffers back): the buffers are the host packers'
    own, the camera's floats and the Perlin seed the host values, and the
    packing counts in host_packs. A scene on the host with no CUDA device
    to send it to raises, as before."""
    sent = []
    monkeypatch.setattr(wc, "_send",
                        lambda parts, device: sent.append(device) or parts)
    scene = pt.builders.bouncing_spheres(image_width=24)
    flat, cam = pt.compile_scene(scene), pcam.derive(scene.camera)
    counts = (wc.prepare_kernel.host_packs, wc.prepare_kernel.device_packs)
    prep = wc.prepare_kernel(flat, cam, device="cuda")
    assert (wc.prepare_kernel.host_packs,
            wc.prepare_kernel.device_packs) == (counts[0] + 1, counts[1])
    assert sent == [torch.device("cuda")]
    tables, off, _ = wc._kernel_tables(flat)
    vtab, vfields = wc._vscan_buffer(wc.pack_vscan_tables(flat))
    assert prep.mode == "vscan" and prep.vfields == vfields
    assert torch.equal(prep.tables, tables) and torch.equal(prep.vtab, vtab)
    assert prep.fields["off_tex"] == off["tex"]
    assert bytes(prep.fields["cam"]) == cam.scalars().numpy().tobytes()
    assert prep.fields["perlin_seed"] == int(flat.perlin_seed) & 0xFFFFFFFF
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        wc.prepare_kernel(flat, cam)


def _gate_scenes(mod):
    """The scenes of tests/test_pallas.py::test_supports_gate, built with
    either package's schema."""
    boxes = [mod.ConstantMedium(
        mod.Box((i, 0, 0), (i + 1, 1, 1),
                mod.Lambertian(mod.SolidColor((1, 1, 1)))),
        0.1, mod.SolidColor((1, 1, 1))) for i in range(5)]
    marble = mod.Scene(objects=[
        mod.Sphere((0, 0, 0), 1.0, mod.Lambertian(mod.Noise(4.0)))])
    nested = mod.Scene(objects=[mod.Sphere(
        (0, 0, 0), 1.0, mod.Lambertian(mod.Checker(
            1.0, mod.Noise(4.0), mod.SolidColor((1, 1, 1)))))])
    big_nested = mod.Scene(objects=[mod.Sphere(
        (i * 3.0, 0, 0), 1.0, mod.Lambertian(mod.Checker(
            1.0, mod.Noise(4.0), mod.SolidColor((1, 1, 1)))))
        for i in range(80)])
    return [mod.builders.cornell_box(), mod.builders.cornell_smoke(),
            mod.Scene(objects=boxes), marble, nested, big_nested]


def test_kernel_gate_reason():
    expect_ok = [True, True, False, True, True, True]
    expect_grad_ok = [True, True, False, True, True, True]
    for js, ps, ok, grad_ok in zip(_gate_scenes(rt), _gate_scenes(pt),
                                   expect_ok, expect_grad_ok):
        jf, pf = rt.compile_scene(js), pt.compile_scene(ps)
        # the port's forward takes the JAX kernel's gate (the chunk scan
        # past the unrolled bounds); its tex_color grad kernels take the
        # JAX gate of the full grad kernel on unrolled scenes and of its
        # scan-mode tex_color backward past them
        reason = wc.kernel_gate_reason(pf)
        assert (reason is None) == (wp.pallas_gate_reason(jf) is None) \
            == ok, reason
        reason = wc.grad_gate_reason(pf)
        jax_reason = (wp.pallas_grad_gate_reason(jf)
                      if wc.kernel_mode(pf)[0] == "unrolled"
                      else wp.pallas_scan_grad_gate_reason(jf))
        assert (reason is None) == (jax_reason is None) == grad_ok, reason


def test_compile_scene_bvh_not_ported():
    """use_bvh=True, which raised before the BVH build was ported, now
    builds the tree (tests/test_torch_bvh.py holds it against the JAX
    package's) and changes no other table."""
    flat = pt.compile_scene(pt.builders.cornell_box())
    bvh = pt.compile_scene(pt.builders.cornell_box(), use_bvh=True)
    assert bvh.use_bvh and not flat.use_bvh
    assert bvh.bvh_left.shape[0] > 1
    for name in flat.tensor_fields():
        if not name.startswith("bvh_"):
            assert torch.equal(getattr(flat, name), getattr(bvh, name)), name
