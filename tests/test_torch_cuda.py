"""The CUDA wavefront kernel on the card, against its plain torch version.

These need an NVIDIA GPU and nvcc: each test skips where
torch.cuda.is_available() is False. This file imports neither JAX nor
tests/conftest.py's JAX setup, so it runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The kernel and the plain version draw the same PCG4D streams and round
alike (the kernel is built with --fmad=false), so the per-pixel rule of
tests/test_pallas.py::_assert_close holds with room to spare.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu_torch.models import camera as pcam
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.parallel import train

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)


def _pass_args(name, device, width=64, spp=4, depth=8):
    scene = pt.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = width
    flat = pt.compile_scene(scene, device=device)
    cam = pcam.derive(scene.camera, device=device)
    w, h = pcam.image_size(scene.camera)
    n_strata = int(np.sqrt(spp))
    kw = dict(width=w, height=h, n_strata=n_strata, max_depth=depth,
              n_samples=spp, sky_gradient=scene.camera.sky_gradient)
    return flat, cam, kw


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke",
                                  "simple_sphere"])
def test_kernel_matches_plain(name, cuda_device):
    flat, cam, kw = _pass_args(name, cuda_device)
    before = wc.render_pass_kernel.launches
    kern = wc.render_pass_kernel(flat, cam, 7, 0, **kw)
    torch.cuda.synchronize()
    assert wc.render_pass_kernel.launches == before + 1
    plain = wc.render_pass_reference(flat, cam, 7, 0, **kw)
    k, p = kern.cpu().numpy(), plain.cpu().numpy()
    assert np.isfinite(k).all()
    diff = np.abs(k - p)
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert abs(k.mean() - p.mean()) < 2e-3


def test_kernel_carry_matches_plain(cuda_device):
    """cap / carry / pix_lanes: the kernel's 14-row carry after a capped
    pass is the plain version's, and a resumed pass under a permutation
    gives the same radiance."""
    flat, cam, kw = _pass_args("cornell_box", cuda_device)
    rk, sk = wc.render_pass_kernel(flat, cam, 7, 3, cap=5, **kw)
    rp, sp = wc.render_pass_reference(flat, cam, 7, 3, cap=5, **kw)
    np.testing.assert_allclose(sk.cpu().numpy(), sp.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    perm = torch.randperm(rk.shape[1], device=cuda_device,
                          generator=torch.Generator(device=cuda_device)
                          .manual_seed(0))
    pix = torch.clamp(torch.arange(rk.shape[1], device=cuda_device),
                      max=kw["width"] * kw["height"] - 1)[perm]
    r2k = wc.render_pass_kernel(flat, cam, 7, 3, carry=sk[:, perm],
                                pix_lanes=pix, **kw)
    r2p = wc.render_pass_reference(flat, cam, 7, 3, carry=sp[:, perm],
                                   pix_lanes=pix, **kw)
    np.testing.assert_allclose(r2k.cpu().numpy(), r2p.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_kernel_compacted_matches_single(name, cuda_device):
    flat, cam, kw = _pass_args(name, cuda_device, width=40)
    one = wc.render_pass(flat, cam, 7, 3, **kw).cpu().numpy()
    for sched in ({"cap": 6}, {"cap": 6, "phases": 3}, {"caps": (4, 4)}):
        two = wc.render_pass_compacted(flat, cam, 7, 3, **sched, **kw)
        assert np.allclose(one, two.cpu().numpy(), atol=1e-5), sched


def test_kernel_rejects_bad_inputs(cuda_device):
    flat, cam, kw = _pass_args("cornell_box", cuda_device, width=16)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    with pytest.raises(ValueError, match="carry"):
        wc.render_pass_kernel(flat, cam, 0, 0, carry=torch.zeros(
            wc.CARRY_ROWS, n_lanes + 1, device=cuda_device), **kw)
    many = pt.Scene(objects=[pt.ConstantMedium(
        pt.Box((i, 0, 0), (i + 1, 1, 1),
               pt.Lambertian(pt.SolidColor((1, 1, 1)))),
        0.1, pt.SolidColor((1, 1, 1))) for i in range(5)])
    gated = pt.compile_scene(many, device=cuda_device)
    with pytest.raises(ValueError, match="gate"):
        wc.render_pass_kernel(gated, cam, 0, 0, **kw)


def test_prepared_inputs_give_the_same_pass(cuda_device):
    """Packing the scene once per render changes no pixel."""
    flat, cam, kw = _pass_args("cornell_smoke", cuda_device, width=32)
    prep = wc.prepare_kernel(flat, cam)
    once = wc.render_pass_kernel(flat, cam, 2, 0, **kw)
    reused = wc.render_pass_kernel(flat, cam, 2, 0, prepared=prep, **kw)
    np.testing.assert_array_equal(reused.cpu().numpy(), once.cpu().numpy())


def test_render_auto_outside_the_gate_raises(cuda_device):
    """No silent plain engine on the card: a scene the kernel cannot take
    (past MAX_PRIMS_SCAN primitives) raises under auto, naming the BVH
    kernels, and renders only with engine="torch"."""
    scene = pt.Scene(objects=[
        pt.Sphere((3.0 * (i % 128), 3.0 * (i // 128), 0), 1.0,
                  pt.Lambertian(pt.SolidColor((1, 1, 1))))
        for i in range(wc.MAX_PRIMS_SCAN + 1)])
    scene.camera.image_width = 8
    scene.camera.samples_per_pixel = 1
    scene.camera.max_depth = 2
    with pytest.raises(ValueError, match="K11/K12"):
        pt.render(scene, device=cuda_device)
    img = pt.render(scene, device=cuda_device, engine="torch")
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())


def test_render_auto_runs_the_kernel(cuda_device):
    scene = pt.builders.cornell_box()
    scene.camera.image_width = 32
    scene.camera.samples_per_pixel = 16
    before = wc.render_pass_kernel.launches
    calls = wc.render_pass_reference.calls
    img = pt.render(scene, device=cuda_device)
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert wc.render_pass_kernel.launches > before
    assert wc.render_pass_reference.calls == calls


def _cotangent(kw, device, seed=0):
    g = np.random.default_rng(seed).normal(
        size=(kw["height"], kw["width"], 3)).astype(np.float32)
    return torch.from_numpy(g).to(device)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_grad_kernel_matches_plain(name, cuda_device):
    """K3 against its plain version at 64 px, depth 8: the image per pixel,
    dG_tex to 1e-4 of its largest entry (the two sum the lanes in another
    order), the carry with its weight planes, and the bounce counts."""
    flat, cam, kw = _pass_args(name, cuda_device)
    g = _cotangent(kw, cuda_device)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    it_k = torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
    it_p = torch.zeros_like(it_k)
    before = wc.render_pass_grad_kernel.launches
    img_k, dg_k, _ = wc.render_pass_grad_kernel(flat, cam, 7, 0,
                                                cotangent=g, iters=it_k,
                                                **kw)
    torch.cuda.synchronize()
    assert wc.render_pass_grad_kernel.launches == before + 1
    img_p, dg_p, _ = wc.render_pass_grad_reference(flat, cam, 7, 0,
                                                   cotangent=g, iters=it_p,
                                                   **kw)
    fwd = wc.render_pass_kernel(flat, cam, 7, 0, **kw)
    np.testing.assert_array_equal(img_k.cpu().numpy(), fwd.cpu().numpy())
    k, p = img_k.cpu().numpy(), img_p.cpu().numpy()
    assert (np.abs(k - p) > 1e-3).mean() < 0.01
    scale = float(dg_p.abs().max())
    assert scale > 0.05
    np.testing.assert_allclose(dg_k.cpu().numpy(), dg_p.cpu().numpy(),
                               rtol=1e-4, atol=1e-4 * scale)
    assert int(it_k.sum()) == int(it_p.sum())
    rk, _, _, sk = wc.render_pass_grad_kernel(flat, cam, 7, 0, cotangent=g,
                                              cap=5, **kw)
    rp, _, _, sp = wc.render_pass_grad_reference(flat, cam, 7, 0,
                                                 cotangent=g, cap=5, **kw)
    assert sk.shape == (wc.CARRY_ROWS + 3 * flat.tex_type.shape[0],
                        n_lanes)
    np.testing.assert_allclose(sk.cpu().numpy(), sp.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_grad_kernel_compacted_matches_single(name, cuda_device):
    """K5 on the kernel: caps (12, 6) against one grad pass, at 40 px (pad
    lanes in the permutation)."""
    flat, cam, kw = _pass_args(name, cuda_device, width=40)
    g = _cotangent(kw, cuda_device, 1)
    one, dg1, _ = wc.render_pass_grad_kernel(flat, cam, 7, 3, cotangent=g,
                                             **kw)
    two, dg2, _ = wc.render_pass_grad_compacted(flat, cam, 7, 3,
                                                cotangent=g, caps=(12, 6),
                                                **kw)
    assert np.allclose(one.cpu().numpy(), two.cpu().numpy(), atol=1e-5)
    scale = float(dg1.abs().max())
    np.testing.assert_allclose(dg2.cpu().numpy(), dg1.cpu().numpy(),
                               rtol=1e-4, atol=1e-4 * scale)


def test_train_step_runs_the_kernels(cuda_device):
    """make_train_step on the card: the forward and grad kernels run, no
    plain pass, and the loss falls over three Adam steps."""
    from real_time_ray_tracing_engine_tpu_torch.parallel import train
    flat, cam, kw = _pass_args("cornell_box", cuda_device, width=32, spp=16,
                               depth=8)
    kw = {k: v for k, v in kw.items() if k != "n_samples"}
    target = train.make_kernel_render(flat, **kw)(
        {"tex_color": flat.tex_color}, cam, 0).detach()
    tc = flat.tex_color.clone()
    tc[:3] *= 0.7
    params = {"tex_color": tc.requires_grad_(True)}
    step = train.make_train_step(torch.optim.Adam(params.values(), lr=0.02),
                                 flat=flat, **kw)
    grads = wc.render_pass_grad_kernel.launches
    plain = (wc.render_pass_reference.calls
             + wc.render_pass_grad_reference.calls)
    losses = [float(step(params, cam, 0, target)) for _ in range(3)]
    assert losses[-1] < losses[0], losses
    assert wc.render_pass_grad_kernel.launches >= grads + 3
    assert (wc.render_pass_reference.calls
            + wc.render_pass_grad_reference.calls) == plain


def _family_errors(slots, got, want):
    """Per hard family: (largest |got - want|, largest |want|)."""
    out = {}
    for fam in ("fuzz", "ior", "sphc", "sphr"):
        idx = [k for k, s in enumerate(slots) if s[0] == fam]
        if idx:
            out[fam] = (float((got[idx] - want[idx]).abs().max()),
                        float(want[idx].abs().max()))
    return out


def test_hard_grad_kernel_matches_plain(cuda_device):
    """K4 against its plain version on Cornell at 32 px, depth 8 (9 slots:
    the glass IOR, the glass sphere and its light-list copy): the image is
    the forward kernel's, the bounce counts are equal, dG_hard is within
    1e-4 of its largest entry per family and dG_tex of its own (the sums
    run in another order, and dual arithmetic rounds apart from torch's
    forward AD), and the capped carry holds the same tangent planes."""
    flat, cam, kw = _pass_args("cornell_box", cuda_device, width=32)
    slots = wc.hard_param_slots(flat)
    assert len(slots) == 9
    g = _cotangent(kw, cuda_device, 2)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    it_k = torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
    it_p = torch.zeros_like(it_k)
    img_k, dgt_k, dgh_k = wc.render_pass_grad_kernel(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, iters=it_k, **kw)
    torch.cuda.synchronize()
    img_p, dgt_p, dgh_p = wc.render_pass_grad_reference(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, iters=it_p, **kw)
    fwd = wc.render_pass_kernel(flat, cam, 7, 0, **kw)
    np.testing.assert_array_equal(img_k.cpu().numpy(), fwd.cpu().numpy())
    assert int(it_k.sum()) == int(it_p.sum())
    for fam, (err, scale) in _family_errors(slots, dgh_k, dgh_p).items():
        assert scale > 0.0 and err <= 1e-4 * scale, (fam, err, scale)
    scale = float(dgt_p.abs().max())
    assert float((dgt_k - dgt_p).abs().max()) <= 1e-4 * scale
    _, _, _, sk = wc.render_pass_grad_kernel(flat, cam, 7, 0, cotangent=g,
                                             hard_slots=slots, cap=5, **kw)
    _, _, _, sp = wc.render_pass_grad_reference(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, cap=5, **kw)
    n_wp = 3 * flat.tex_type.shape[0]
    assert sk.shape == (wc.CARRY_ROWS + n_wp + 9 * len(slots), n_lanes)
    np.testing.assert_allclose(sk[:wc.CARRY_ROWS].cpu().numpy(),
                               sp[:wc.CARRY_ROWS].cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    dk, dp = sk[wc.CARRY_ROWS:], sp[wc.CARRY_ROWS:]
    assert float((dk - dp).abs().max()) <= 1e-4 * float(dp.abs().max())


def test_hard_grad_kernel_compacted_matches_single(cuda_device):
    """Full-family K5 on the kernel: caps (12, 6) against one grad pass at
    40 px (pad lanes in the permutation), the tangent planes riding the
    carry."""
    flat, cam, kw = _pass_args("cornell_box", cuda_device, width=40)
    slots = wc.hard_param_slots(flat)
    g = _cotangent(kw, cuda_device, 3)
    one, t1, h1 = wc.render_pass_grad_kernel(flat, cam, 7, 3, cotangent=g,
                                             hard_slots=slots, **kw)
    two, t2, h2 = wc.render_pass_grad_compacted(
        flat, cam, 7, 3, cotangent=g, hard_slots=slots, caps=(12, 6), **kw)
    assert np.allclose(one.cpu().numpy(), two.cpu().numpy(), atol=1e-5)
    for a, b in ((t2, t1), (h2, h1)):
        scale = float(b.abs().max())
        assert scale > 0.0
        assert float((a - b).abs().max()) <= 1e-4 * scale


def test_full_family_train_step_runs_the_kernels(cuda_device):
    """make_train_step over all five families on the card: only the
    kernels run, every gradient is finite, the glass IOR and sphere get a
    gradient, and the loss falls over three Adam steps."""
    from real_time_ray_tracing_engine_tpu_torch.parallel import train
    flat, cam, kw = _pass_args("cornell_box", cuda_device, width=32, spp=16,
                               depth=8)
    kw = {k: v for k, v in kw.items() if k != "n_samples"}
    target = train.make_kernel_render(flat, **kw)(
        {"tex_color": flat.tex_color}, cam, 0).detach()
    params = {k: v.clone() for k, v in train.get_params(flat).items()}
    params["tex_color"][:3] *= 0.7
    params["mat_ior"][4] = 1.4
    params["sph_radius"][:2] = 85.0
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam([
        {"params": [params["tex_color"], params["mat_ior"],
                    params["mat_fuzz"]], "lr": 0.02},
        {"params": [params["sph_center"], params["sph_radius"]],
         "lr": 1.0}])
    step = train.make_train_step(opt, flat=flat, **kw)
    grads = wc.render_pass_grad_kernel.launches
    plain = (wc.render_pass_reference.calls
             + wc.render_pass_grad_reference.calls)
    losses = []
    for _ in range(3):
        losses.append(float(step(params, cam, 0, target)))
        assert all(bool(torch.isfinite(p.grad).all())
                   for p in params.values())
    assert losses[-1] < losses[0], losses
    assert float(params["mat_ior"].grad[4].abs()) > 0.0
    assert float(params["sph_radius"].grad[:2].abs().min()) > 0.0
    assert wc.render_pass_grad_kernel.launches >= grads + 3
    assert (wc.render_pass_reference.calls
            + wc.render_pass_grad_reference.calls) == plain


@pytest.mark.parametrize("name", ["multichunk", "vquad"])
def test_vscan_kernel_matches_plain(name, cuda_device):
    """The chunk-scan instance (K6; K7 on the 90-quad scene's quad chunks)
    against the plain pass, which tests every primitive: the same pixels
    and the same bounces, its launches counted apart."""
    scene = (cs.multichunk_scene(pt) if name == "multichunk"
             else cs.vquad_scene(pt))
    flat, cam, kw = cs.pass_args(pt, cs.sized(scene, 48, 4, 8), cuda_device)
    assert wc.kernel_mode(flat) == ("vscan", name == "vquad")
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    it_k = torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
    it_p = torch.zeros_like(it_k)
    vscan = wc.render_pass_kernel.launches_vscan
    vquad = wc.render_pass_kernel.launches_vquad
    kern = wc.render_pass_kernel(flat, cam, 7, 0, iters=it_k, **kw)
    torch.cuda.synchronize()
    assert wc.render_pass_kernel.launches_vscan == vscan + 1
    assert wc.render_pass_kernel.launches_vquad == vquad + (name == "vquad")
    plain = wc.render_pass_reference(flat, cam, 7, 0, iters=it_p, **kw)
    k, p = kern.cpu().numpy(), plain.cpu().numpy()
    assert np.isfinite(k).all() and k.mean() > 0.01
    diff = np.abs(k - p)
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert abs(k.mean() - p.mean()) < 2e-3
    assert int(it_k.sum()) == int(it_p.sum())
    # the compacted schedule, and a grad pass on the chunk scan's instance
    two = wc.render_pass_compacted(flat, cam, 7, 0, **kw)
    assert np.allclose(k, two.cpu().numpy(), atol=1e-5)
    before = wc.render_pass_grad_kernel.launches
    img, _, _ = wc.render_pass_grad_kernel(
        flat, cam, 7, 0, cotangent=torch.zeros_like(kern), **kw)
    assert wc.render_pass_grad_kernel.launches == before + 1
    np.testing.assert_array_equal(img.cpu().numpy(), k)


def _large_grad_case(name, device):
    """(flat, cam, kw, slots, want_tex) of the chunk scan's grad cases:
    weight planes (K3v), in shared memory for 28 rows (K3v, NT 17-32) and
    with the metals' fuzz and the glass's IOR, one slot per hard family
    alone (K4v), the suffix tier (K8), and K4v riding K8."""
    from real_time_ray_tracing_engine_tpu_torch.scene.flat import (
        MAT_DIELECTRIC, MAT_METAL)
    build = {"planes": cs.scan_tex_scene, "planes28": cs.rows_scene,
             "planes28_hard": cs.rows_scene, "hard": cs.vscan_slots_scene,
             "suffix": cs.suffix_scene,
             "suffix_hard": cs.vscan_slots_scene}[name]
    flat, cam, kw = cs.pass_args(pt, cs.sized(build(pt), 48, 4, 8), device)
    slots = (cs.vscan_slots(flat.mat_type.cpu(), MAT_METAL, MAT_DIELECTRIC)
             if name in ("hard", "suffix_hard") else ())
    if name == "planes28_hard":
        slots = wc.hard_param_slots(flat, {"mat_fuzz", "mat_ior"})
    return flat, cam, kw, slots, name != "hard"


@pytest.mark.parametrize("name", ["planes", "planes28", "planes28_hard",
                                  "hard", "suffix", "suffix_hard"])
def test_large_grad_kernels_match_plain(name, cuda_device):
    """The chunk scan's grad instances (K3v, K4v, K8) against the plain
    grad pass: the forward kernel's image, the bounces (the suffix tier
    traces each sample twice), dG_tex and dG_hard within 1e-4 of their
    largest entries (the suffix tier adds with float atomics), and the
    compacted schedule (K5) against the single pass."""
    flat, cam, kw, slots, want_tex = _large_grad_case(name, cuda_device)
    assert wc.kernel_mode(flat)[0] == "vscan"
    form = wc.tex_form(flat, want_tex)
    assert form == ("planes" if name.startswith("planes") else
                    None if name == "hard" else "suffix")
    g = cs.cotangent(torch, kw, cuda_device, 5)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    it_k = torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
    it_f = torch.zeros_like(it_k)
    it_p = torch.zeros_like(it_k)
    suffix = wc.render_pass_grad_kernel.suffix_launches
    img, dgt, dgh = wc.render_pass_grad_kernel(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, want_tex=want_tex,
        iters=it_k, **kw)
    fwd = wc.render_pass_kernel(flat, cam, 7, 0, iters=it_f, **kw)
    torch.cuda.synchronize()
    assert wc.render_pass_grad_kernel.suffix_launches == suffix + (
        form == "suffix")
    _, dgt_p, dgh_p = wc.render_pass_grad_reference(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, want_tex=want_tex,
        iters=it_p, **kw)
    np.testing.assert_array_equal(img.cpu().numpy(), fwd.cpu().numpy())
    assert int(it_k.sum()) == int(it_p.sum()) == (
        2 if form == "suffix" else 1) * int(it_f.sum())
    if want_tex:
        scale = float(dgt_p.abs().max())
        assert scale > 0.0
        assert float((dgt - dgt_p).abs().max()) <= 1e-4 * scale
    else:
        assert dgt is None
    if slots:
        fams = cs.family_errors(slots, dgh, dgh_p)
        for fam, e in fams.items():
            assert e["scale"] > 0.0, fam
            assert e["max_abs_err"] <= 1e-4 * e["scale"], (fam, e)
    img2, dgt2, dgh2 = wc.render_pass_grad_compacted(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, want_tex=want_tex,
        **kw)
    assert np.allclose(img2.cpu().numpy(), img.cpu().numpy(), atol=1e-5)
    if want_tex:
        assert float((dgt2 - dgt).abs().max()) <= 1e-4 * scale
    if slots:
        assert float((dgh2 - dgh).abs().max()) <= 1e-4 * float(
            dgh.abs().max())


def test_large_scene_train_step_runs_the_kernels(cuda_device):
    """make_train_step on bouncing_spheres (460 texture rows) on the card:
    tex_color alone (K8 under K5) and with its IOR slot (K4v riding K8),
    under the sky gradient so that the IOR has a gradient; the loss falls
    and no plain pass runs."""
    scene = cs.builtin(pt, "bouncing_spheres", 64, 16, 8)
    flat, cam, kw = cs.pass_args(pt, scene, cuda_device)
    kw.pop("n_samples")
    kw["sky_gradient"] = True
    target = train.make_kernel_render(flat, **kw)(
        {"tex_color": flat.tex_color}, cam, 0).detach()
    plain = (wc.render_pass_reference.calls
             + wc.render_pass_grad_reference.calls)
    for fields in (("tex_color",), ("tex_color", "mat_ior")):
        params = {f: getattr(flat, f).detach().clone() for f in fields}
        params["tex_color"][:4] *= 0.7
        if "mat_ior" in params:
            (slot,) = wc.hard_param_slots(flat, {"mat_ior"})
            params["mat_ior"][slot[1]] = 1.4
        for v in params.values():
            v.requires_grad_(True)
        step = train.make_train_step(torch.optim.Adam(params.values(),
                                                      lr=0.02),
                                     flat=flat, **kw)
        suffix = wc.render_pass_grad_kernel.suffix_launches
        losses = [float(step(params, cam, 0, target)) for _ in range(3)]
        assert losses[2] < losses[1] < losses[0], (fields, losses)
        assert wc.render_pass_grad_kernel.suffix_launches > suffix
        for v in params.values():
            assert bool(torch.isfinite(v.grad).all())
    assert (wc.render_pass_reference.calls
            + wc.render_pass_grad_reference.calls) == plain
