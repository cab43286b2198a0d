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


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("name, width", [("cornell_box", 64),
                                         ("cornell_box", 100),
                                         ("cornell_smoke", 16)])
def test_refilled_forward_matches_one_lane_a_thread(name, width,
                                                    cuda_device):
    """The forward's persistent threads (K1) against the one-lane-a-thread
    body on the same scene (the chunk scan's instance, K6, whose winner
    and t are the all-primitive selection's): the image and bounces of a
    single pass, the radiance, carry and bounces of a capped pass and of
    a capped pass resumed from its carry under a lane permutation, bit for
    bit; at 64 x 64, at 100 x 100 (10,000 pixels, not a multiple of 128)
    and at 16 x 16 (two blocks' worth of slots, fewer than the card keeps
    resident)."""
    flat, cam, kw = _pass_args(name, cuda_device, width=width, depth=16)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    k1 = wc.prepare_kernel(flat, cam)
    k6 = wc.prepare_kernel(flat, cam, chunk_scan=True)
    assert (k1.mode, k6.mode) == ("unrolled", "vscan")
    perm = torch.randperm(n_lanes, device=cuda_device,
                          generator=torch.Generator(device=cuda_device)
                          .manual_seed(1))
    pix = wc._identity_pixels(n_lanes, kw["width"] * kw["height"],
                              cuda_device)[perm]
    outs = []
    for prep in (k1, k6):
        its = [torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
               for _ in range(3)]
        img = wc.render_pass_kernel(flat, cam, 7, 3, iters=its[0],
                                    prepared=prep, **kw)
        rad, carry = wc.render_pass_kernel(flat, cam, 7, 3, cap=5,
                                           iters=its[1], prepared=prep, **kw)
        rad2, carry2 = wc.render_pass_kernel(
            flat, cam, 7, 3, cap=5, carry=carry[:, perm], pix_lanes=pix,
            iters=its[2], prepared=prep, **kw)
        outs.append([img, rad, carry, rad2, carry2] + its)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(_bits(a), _bits(b))
    assert int(outs[0][5].sum()) > n_lanes and float(outs[0][0].mean()) > 0


def test_refilled_forward_twice_in_a_row(cuda_device):
    """Two launches of the forward in a row on one stream, unsynchronised:
    each takes its lane slots from a counter zeroed for it, so both give
    the same radiance, carry and bounces bit for bit."""
    flat, cam, kw = _pass_args("cornell_box", cuda_device, width=96,
                               depth=16)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    prep = wc.prepare_kernel(flat, cam)
    runs = []
    for _ in range(2):
        it = torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
        rad, carry = wc.render_pass_kernel(flat, cam, 7, 0, cap=7, iters=it,
                                           prepared=prep, **kw)
        runs.append((rad, carry, it))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(_bits(a), _bits(b))
    assert int(runs[0][2].sum()) > 0


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


@pytest.mark.parametrize("name", ["multichunk", "vquad", "bouncing"])
def test_vscan_kernel_matches_plain(name, cuda_device):
    """The chunk-scan instance (K6; K7 on the 90-quad scene's quad chunks;
    on bouncing_spheres, whose first chunk mixes static and moving spheres,
    through their group boxes) against the plain pass, which tests every
    primitive: the same pixels and the same bounces, its launches counted
    apart."""
    scene = (pt.builders.bouncing_spheres() if name == "bouncing" else
             {"multichunk": cs.multichunk_scene,
              "vquad": cs.vquad_scene}[name](pt))
    flat, cam, kw = cs.pass_args(pt, cs.sized(scene, 48, 4, 8), cuda_device)
    assert wc.kernel_mode(flat) == ("vscan", name == "vquad")
    if name == "bouncing":
        vt = wc.pack_vscan_tables(flat)
        moving = (vt.rows[:wc.VCHUNK, 3:6] != 0).any(1) \
            & (vt.rows[:wc.VCHUNK, 7] >= 0)
        assert bool(moving.any()) and not bool(moving.all())
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
    weight planes (K3v) for 7 rows, for 28 rows alone and with the metals'
    fuzz and the glass's IOR, for 31 rows with 30 fuzz slots (the metals
    scene, under the sky gradient), and for 29 rows in a closed room at
    depth 50 (paths whose planes hold many rows), one slot per hard family
    alone (K4v), the suffix tier (K8), and K4v riding K8."""
    from real_time_ray_tracing_engine_tpu_torch.scene.flat import (
        MAT_DIELECTRIC, MAT_METAL)
    build = {"planes": cs.scan_tex_scene, "planes28": cs.rows_scene,
             "planes28_hard": cs.rows_scene, "planes_room": cs.room_scene,
             "planes31_fuzz30": cs.metals_scene,
             "hard": cs.vscan_slots_scene, "suffix": cs.suffix_scene,
             "suffix_hard": cs.vscan_slots_scene}[name]
    depth = 50 if name == "planes_room" else 8
    flat, cam, kw = cs.pass_args(pt, cs.sized(build(pt), 48, 4, depth),
                                 device)
    slots = (cs.vscan_slots(flat.mat_type.cpu(), MAT_METAL, MAT_DIELECTRIC)
             if name in ("hard", "suffix_hard") else ())
    if name == "planes28_hard":
        slots = wc.hard_param_slots(flat, {"mat_fuzz", "mat_ior"})
    if name == "planes31_fuzz30":
        slots = wc.hard_param_slots(flat, {"mat_fuzz"})
        assert len(slots) == 30 and flat.tex_type.shape[0] == 31
    return flat, cam, kw, slots, name != "hard"


@pytest.mark.parametrize("name", ["planes", "planes28", "planes28_hard",
                                  "planes31_fuzz30", "planes_room", "hard",
                                  "suffix", "suffix_hard"])
def test_large_grad_kernels_match_plain(name, cuda_device):
    """The chunk scan's grad instances (K3v, K4v, K8) against the plain
    grad pass: the forward kernel's image and bounces (the plain suffix
    tier traces each sample twice, the kernel once), dG_tex and dG_hard
    within 1e-4 of their largest entries (the lanes are summed in another
    order), and the compacted schedule (K5) against the single pass. In
    the closed room some paths' weight planes hold two rows or more
    (counted by the kernel)."""
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
    multi = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    img, dgt, dgh = wc.render_pass_grad_kernel(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, want_tex=want_tex,
        iters=it_k, multi_rows=multi, **kw)
    if name == "planes_room":
        assert int(multi) > 0
    fwd = wc.render_pass_kernel(flat, cam, 7, 0, iters=it_f, **kw)
    torch.cuda.synchronize()
    assert wc.render_pass_grad_kernel.suffix_launches == suffix + (
        form == "suffix")
    _, dgt_p, dgh_p = wc.render_pass_grad_reference(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, want_tex=want_tex,
        iters=it_p, **kw)
    np.testing.assert_array_equal(img.cpu().numpy(), fwd.cpu().numpy())
    assert int(it_k.sum()) == int(it_f.sum())
    assert int(it_p.sum()) == (2 if form == "suffix" else 1) * int(
        it_f.sum())
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


def _suffix_runs(flat, cam, kw, g, slots=(), caps=None):
    """Two runs of the suffix tier's kernel (single pass, or the compacted
    schedule at `caps`): their (image, dG_tex, dG_hard)."""
    def run():
        if caps is None:
            return wc.render_pass_grad_kernel(flat, cam, 7, 0, cotangent=g,
                                              hard_slots=slots, **kw)
        return wc.render_pass_grad_compacted(flat, cam, 7, 0, cotangent=g,
                                             hard_slots=slots, caps=caps,
                                             **kw)
    return run(), run()


def _bits(t):
    return t.contiguous().view(torch.int32).cpu()


@pytest.mark.parametrize("name", ["suffix", "bouncing_ior", "stack",
                                  "lane"])
def test_suffix_kernel_is_the_same_on_every_run(name, cuda_device,
                                                monkeypatch):
    """The suffix tier (K8; with the IOR slot, K4v riding it; and on the
    BVH walks' selections, K11 and K12) gives the same image, dG_tex and
    dG_hard bit for bit on two runs, single pass and compacted (a path's
    records ride the carry across the passes): its routes are summed in an
    order the data fixes. On the walks dG_tex is the chunk scan's bit for
    bit too (the same lanes route the same values in the same rounds)."""
    scene = (cs.suffix_scene(pt) if name == "suffix"
             else pt.builders.bouncing_spheres())
    flat, cam, kw = cs.pass_args(pt, cs.wide(scene, 96, 4, 12), cuda_device,
                                 use_bvh=name in ("stack", "lane"))
    slots = ()
    if name == "bouncing_ior":
        kw["sky_gradient"] = True
        slots = wc.hard_param_slots(flat, {"mat_ior"})
        assert len(slots) == 1
    g = cs.cotangent(torch, kw, cuda_device, 5)
    vscan = None
    if name in ("stack", "lane"):
        vscan = wc.render_pass_grad_kernel(flat, cam, 7, 0, cotangent=g,
                                           **kw)
        _bvh_env(monkeypatch, name)
        assert wc.kernel_mode(flat)[0] == name
    assert wc.tex_form(flat) == "suffix"
    for caps in (None, (5, 3)):
        a, b = _suffix_runs(flat, cam, kw, g, slots, caps)
        for x, y in zip(a, b):
            assert torch.equal(_bits(x), _bits(y))
        assert float(a[1].abs().max()) > 0.0
        if slots:
            assert float(a[2].abs().max()) > 0.0
        if vscan is not None and caps is None:
            assert torch.equal(_bits(a[0]), _bits(vscan[0]))
            assert torch.equal(_bits(a[1]), _bits(vscan[1]))


def test_suffix_kernel_with_ior_slot_matches_plain(cuda_device):
    """K8 with bouncing_spheres' IOR slot (K4v riding K8) under the sky
    gradient: the forward's image and bounces, dG_tex within 1e-4 of the
    plain grad pass's largest entry, dG_hard that of the tangent bundles
    alone (K4v without tex_color) bit for bit (the same tangent passes on
    the same paths, reduced in the same order: the suffix tier leaves them
    as they are; at this size the IOR entry parts from the plain
    version's by about 5e-4 of its size, the tangents' float32 rounding on
    a few grazing lanes, so chip_smoke.py holds dG_hard against the plain
    version at 1200x675), and a capped pass's carry in the kernel's
    layout (its records after T and the record count) beside the plain
    version's two-phase one."""
    flat, cam, kw = cs.pass_args(
        pt, cs.wide(pt.builders.bouncing_spheres(), 64, 4, 8), cuda_device)
    kw["sky_gradient"] = True
    slots = wc.hard_param_slots(flat, {"mat_ior"})
    g = cs.cotangent(torch, kw, cuda_device, 5)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    it_k = torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
    it_f = torch.zeros_like(it_k)
    it_p = torch.zeros_like(it_k)
    img, dgt, dgh = wc.render_pass_grad_kernel(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, iters=it_k, **kw)
    fwd = wc.render_pass_kernel(flat, cam, 7, 0, iters=it_f, **kw)
    _, dgt_p, dgh_p = wc.render_pass_grad_reference(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, iters=it_p, **kw)
    np.testing.assert_array_equal(img.cpu().numpy(), fwd.cpu().numpy())
    assert int(it_k.sum()) == int(it_f.sum()) == int(it_p.sum()) // 2
    scale = float(dgt_p.abs().max())
    assert scale > 0.0
    assert float((dgt - dgt_p).abs().max()) <= 1e-4 * scale
    assert float(dgh_p.abs().max()) > 0.0
    _, none, dgh_v = wc.render_pass_grad_kernel(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, want_tex=False, **kw)
    assert none is None
    assert torch.equal(_bits(dgh), _bits(dgh_v))
    out = wc.render_pass_grad_kernel(flat, cam, 7, 0, cotangent=g,
                                     hard_slots=slots, cap=3, **kw)
    assert out[3].shape == (wc.CARRY_ROWS + 9 + wc.SFX_STATE
                            + wc.SFX_REC * kw["max_depth"], n_lanes)
    pout = wc.render_pass_grad_reference(flat, cam, 7, 0, cotangent=g,
                                         hard_slots=slots, cap=3, **kw)
    assert pout[3].shape == (wc.CARRY_ROWS + 9 + wc.SUFFIX_ROWS, n_lanes)


def test_grad_kernel_nt16_matches_plain(cuda_device):
    """K3's NTMAX 16 instance (16 texture rows) against its plain version,
    as test_grad_kernel_matches_plain holds the NTMAX 8 one (Cornell's NT
    6): the forward's image, dG_tex to 1e-4 of its largest entry, the
    bounces, and the compacted schedule."""
    flat, cam, kw = cs.pass_args(pt, cs.sized(cs.nt16_scene(pt), 64, 4, 8),
                                 cuda_device)
    assert wc.kernel_mode(flat)[0] == "unrolled"
    assert flat.tex_type.shape[0] == 16
    g = _cotangent(kw, cuda_device)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    it_k = torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
    it_p = torch.zeros_like(it_k)
    img_k, dg_k, _ = wc.render_pass_grad_kernel(flat, cam, 7, 0,
                                                cotangent=g, iters=it_k,
                                                **kw)
    img_p, dg_p, _ = wc.render_pass_grad_reference(flat, cam, 7, 0,
                                                   cotangent=g, iters=it_p,
                                                   **kw)
    fwd = wc.render_pass_kernel(flat, cam, 7, 0, **kw)
    np.testing.assert_array_equal(img_k.cpu().numpy(), fwd.cpu().numpy())
    k, p = img_k.cpu().numpy(), img_p.cpu().numpy()
    assert (np.abs(k - p) > 1e-3).mean() < 0.01
    scale = float(dg_p.abs().max())
    assert scale > 0.0
    np.testing.assert_allclose(dg_k.cpu().numpy(), dg_p.cpu().numpy(),
                               rtol=1e-4, atol=1e-4 * scale)
    assert int(it_k.sum()) == int(it_p.sum())
    two, dg2, _ = wc.render_pass_grad_compacted(flat, cam, 7, 0,
                                                cotangent=g, caps=(12, 6),
                                                **kw)
    assert np.allclose(two.cpu().numpy(), k, atol=1e-5)
    np.testing.assert_allclose(dg2.cpu().numpy(), dg_k.cpu().numpy(),
                               rtol=1e-4, atol=1e-4 * scale)


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


def _adjoint_case(name, device):
    """(flat, cam, kw) of the adjoint's cases: Cornell (quads and a sphere
    light, which the forward runs unrolled and the adjoint on the chunk
    scan), the 79-sphere scene (metals, a glass, a sphere light),
    cornell_smoke (mediums), the city (quad chunks) and bouncing_spheres
    under the sky gradient. bouncing is at 128 px: at 64 px its one IOR
    entry (2.0) is a sum of terms a hundred times larger that cancel, and
    K9, its plain version, K4v and K4v's plain version spread over 6e-4
    of it; at 128 px it is 142."""
    scene = {"cornell": lambda: cs.builtin(pt, "cornell_box", 48, 4, 8),
             "slots": lambda: cs.sized(cs.vscan_slots_scene(pt), 48, 4, 8),
             "smoke": lambda: cs.builtin(pt, "cornell_smoke", 48, 4, 8),
             "city": lambda: cs.sized(cs.city_scene(pt), 64, 4, 6),
             "bouncing": lambda: cs.builtin(pt, "bouncing_spheres", 128,
                                            4, 16)}[name]()
    flat, cam, kw = cs.pass_args(pt, scene, device)
    kw["sky_gradient"] = kw["sky_gradient"] or name == "bouncing"
    return flat, cam, kw


@pytest.mark.parametrize("name", ["cornell", "slots", "smoke", "city",
                                  "bouncing"])
def test_adjoint_kernel_matches_plain(name, cuda_device):
    """The adjoint kernel (K9) against its plain version: the image is the
    forward kernel's bit for bit, the bounces are equal, and each family
    is within 1e-4 of its largest entry (the two sum in other orders)."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    flat, cam, kw = _adjoint_case(name, cuda_device)
    g = cs.cotangent(torch, kw, cuda_device, 5)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    it_k = torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
    it_f = torch.zeros_like(it_k)
    it_p = torch.zeros_like(it_k)
    before = ac.render_pass_adjoint_kernel.launches
    img, grads = ac.render_pass_adjoint_kernel(flat, cam, 7, 0, cotangent=g,
                                               iters=it_k, **kw)
    fwd = wc.render_pass_kernel(flat, cam, 7, 0, iters=it_f, **kw)
    torch.cuda.synchronize()
    assert ac.render_pass_adjoint_kernel.launches == before + 1
    _, grads_p = ac.render_pass_adjoint_reference(flat, cam, 7, 0,
                                                  cotangent=g, iters=it_p,
                                                  **kw)
    np.testing.assert_array_equal(img.cpu().numpy(), fwd.cpu().numpy())
    assert int(it_k.sum()) == int(it_p.sum()) == int(it_f.sum())
    for f in ac.ADJOINT_FIELDS:
        scale = float(grads_p[f].abs().max())
        assert bool(torch.isfinite(grads[f]).all()), f
        assert float((grads[f] - grads_p[f]).abs().max()) <= 1e-4 * scale, f
    assert float(grads_p["tex_color"].abs().max()) > 0.0


@pytest.mark.parametrize("case", cs.PROBE_CASES,
                         ids=[c[0] for c in cs.PROBE_CASES])
def test_adjoint_probe_matches_plain_vjp(case, cuda_device):
    """The adjoint kernels' reverse bounce alone (adj_reverse_bounce through
    adjoint_bounce_probe) against torch autograd of the bounce
    (adjoint_bounce_probe_reference), per lane, on each branch of
    chip_smoke.py's probe: the state's cotangent and every accumulator
    entry within PROBE_RTOL of the branch's largest entry."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    before = ac.adjoint_bounce_probe.launches
    idx, lam_k, rows_k = cs.probe_run(torch, pt, ac, case, cuda_device,
                                      ac.adjoint_bounce_probe)
    assert ac.adjoint_bounce_probe.launches == before + 1
    _, lam_p, rows_p = cs.probe_run(torch, pt, ac, case, cuda_device,
                                    ac.adjoint_bounce_probe_reference)
    assert idx.numel() >= 8, case[0]
    got = torch.cat([lam_k.double(), rows_k], 1)
    want = torch.cat([lam_p.double(), rows_p], 1)
    scale = float(want.abs().max())
    assert scale > 0.0 and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= cs.PROBE_RTOL * scale, case[0]


def _wide_slots_scene():
    """materials_scene with two more spheres: 34 hard slots (a fuzz, an
    IOR, eight sphere rows), 8 primitives (the unrolled kernel)."""
    scene = cs.materials_scene(pt)
    for x in (-2.0, 2.0):
        scene.objects.append(pt.Sphere(
            (x, 0.4, 2.0), 0.4, pt.Lambertian(pt.SolidColor((0.3, 0.6,
                                                             0.4)))))
    scene.camera.image_width = 32
    scene.camera.samples_per_pixel = 4
    scene.camera.max_depth = 6
    return scene


@pytest.mark.parametrize("n_slots", [1, 5, 9, 32])
def test_hard_grad_kernel_slot_groups_match_plain(n_slots, cuda_device):
    """K4's slot groups (HARD_W slots a dual pass, the warp-wide skip) at K
    = 1, 5 and 9 slots on Cornell (the glass IOR, the glass sphere, its
    light-list copy: groups of 1 and 4) and the first 32 of 34 on a wider
    scene (the gate's edge; the last sphere row's group cut at 2) against
    the plain version's tangent bundles: dG_hard within 1e-4 of its largest
    entry per family, the image the forward kernel's."""
    if n_slots < 32:
        flat, cam, kw = _pass_args("cornell_box", cuda_device, width=32)
    else:
        flat, cam, kw = cs.pass_args(pt, _wide_slots_scene(), cuda_device)
    slots = wc.hard_param_slots(flat)[:n_slots]
    assert len(slots) == n_slots
    g = _cotangent(kw, cuda_device, 4)
    img_k, _, dgh_k = wc.render_pass_grad_kernel(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, **kw)
    torch.cuda.synchronize()
    _, _, dgh_p = wc.render_pass_grad_reference(
        flat, cam, 7, 0, cotangent=g, hard_slots=slots, **kw)
    fwd = wc.render_pass_kernel(flat, cam, 7, 0, **kw)
    np.testing.assert_array_equal(img_k.cpu().numpy(), fwd.cpu().numpy())
    assert dgh_k.shape == (n_slots,)
    for fam, (err, scale) in _family_errors(slots, dgh_k, dgh_p).items():
        assert scale > 0.0 and err <= 1e-4 * scale, (fam, err, scale)


def test_adjoint_kernel_on_a_medium_and_a_marble(cuda_device):
    """K9 against its plain version on the MIS + medium scene with a marble
    (noise) ground: a medium's free flight and a marble's position
    gradient in the reverse bounce, both light kinds. The image is the
    forward kernel's, each family within 1e-4 of its largest entry."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    scene = cs.mis_medium_scene(pt)
    scene.objects[0] = pt.Sphere((0, -1000, 0), 1000.0,
                                 pt.Lambertian(pt.Noise(3.0)))
    scene = cs.sized(scene, 48, 4, 6)
    flat, cam, kw = cs.pass_args(pt, scene, cuda_device)
    assert flat.has_noise and flat.n_mediums == 1
    g = cs.cotangent(torch, kw, cuda_device, 9)
    img, grads = ac.render_pass_adjoint_kernel(flat, cam, 7, 0, cotangent=g,
                                               **kw)
    fwd = wc.render_pass_kernel(flat, cam, 7, 0, **kw)
    _, grads_p = ac.render_pass_adjoint_reference(flat, cam, 7, 0,
                                                  cotangent=g, **kw)
    np.testing.assert_array_equal(img.cpu().numpy(), fwd.cpu().numpy())
    for f in ac.ADJOINT_FIELDS:
        scale = float(grads_p[f].abs().max())
        assert bool(torch.isfinite(grads[f]).all()), f
        assert float((grads[f] - grads_p[f]).abs().max()) <= 1e-4 * scale, f
    assert float(grads_p["sph_center"].abs().max()) > 0.0


@pytest.mark.parametrize("name, seg", [("cornell", 3), ("slots", 6),
                                       ("smoke", 1)])
def test_seg_adjoint_kernel_matches_plain(name, seg, cuda_device):
    """The segmented adjoint kernel (K10) against its plain version: the
    image is the forward kernel's bit for bit, the bounces (sweep 1's) are
    equal, and each family is within 1e-4 of its largest entry."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    flat, cam, kw = _adjoint_case(name, cuda_device)
    g = cs.cotangent(torch, kw, cuda_device, 5)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    it_k = torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
    it_f = torch.zeros_like(it_k)
    it_p = torch.zeros_like(it_k)
    before = (ac.render_pass_adjoint_kernel.launches,
              ac.render_pass_adjoint_kernel.seg_launches)
    img, grads = ac.render_pass_adjoint_kernel(flat, cam, 7, 0, cotangent=g,
                                               iters=it_k, seg=seg, **kw)
    fwd = wc.render_pass_kernel(flat, cam, 7, 0, iters=it_f, **kw)
    torch.cuda.synchronize()
    assert (ac.render_pass_adjoint_kernel.launches,
            ac.render_pass_adjoint_kernel.seg_launches) == (before[0],
                                                            before[1] + 1)
    _, grads_p = ac.render_pass_adjoint_seg_reference(
        flat, cam, 7, 0, cotangent=g, iters=it_p, seg=seg, **kw)
    np.testing.assert_array_equal(img.cpu().numpy(), fwd.cpu().numpy())
    assert int(it_k.sum()) == int(it_p.sum()) == int(it_f.sum())
    for f in ac.ADJOINT_FIELDS:
        scale = float(grads_p[f].abs().max())
        assert bool(torch.isfinite(grads[f]).all()), f
        assert float((grads[f] - grads_p[f]).abs().max()) <= 1e-4 * scale, f
    assert float(grads_p["tex_color"].abs().max()) > 0.0


@pytest.mark.parametrize("seg", [1, 8])
def test_seg_adjoint_kernel_equals_per_sample_kernel(seg, cuda_device):
    """K10 against K9 on bouncing_spheres under the sky gradient: each lane
    runs K9's arithmetic in K9's order, so the images are equal bit for bit,
    the bounces are equal, and each family agrees within 1e-6 of its
    largest entry (the double accumulators sum in another order)."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    flat, cam, kw = _adjoint_case("bouncing", cuda_device)
    g = cs.cotangent(torch, kw, cuda_device, 5)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    it9 = torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
    it10 = torch.zeros_like(it9)
    img9, gr9 = ac.render_pass_adjoint_kernel(flat, cam, 7, 0, cotangent=g,
                                              iters=it9, **kw)
    img10, gr10 = ac.render_pass_adjoint_kernel(flat, cam, 7, 0,
                                                cotangent=g, iters=it10,
                                                seg=seg, **kw)
    assert torch.equal(img9, img10)
    assert torch.equal(it9, it10)
    for f in ac.ADJOINT_FIELDS:
        scale = float(gr9[f].abs().max())
        assert float((gr10[f] - gr9[f]).abs().max()) <= 1e-6 * scale, f
    assert float(gr9["sph_center"].abs().max()) > 0.0


def test_adjoint_kernel_matches_forward_mode_kernels(cuda_device):
    """Two differentiation mechanisms on the card (tests/test_grad.py:804):
    K9's entries for the 79-sphere scene's 4 slots against K4v's dG_hard,
    its tex_color against K8's (the scene has more than 32 rows), at rtol
    1e-3, atol 1e-4 x the largest entry."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    from real_time_ray_tracing_engine_tpu_torch.scene.flat import (
        MAT_DIELECTRIC, MAT_METAL)
    flat, cam, kw = _adjoint_case("slots", cuda_device)
    slots = cs.vscan_slots(flat.mat_type.cpu(), MAT_METAL, MAT_DIELECTRIC)
    assert wc.tex_form(flat) == "suffix"
    g = cs.cotangent(torch, kw, cuda_device, 6)
    _, grads = ac.render_pass_adjoint_kernel(flat, cam, 7, 0, cotangent=g,
                                             **kw)
    _, dgt, dgh = wc.render_pass_grad_kernel(flat, cam, 7, 0, cotangent=g,
                                             hard_slots=slots, **kw)
    got = torch.stack([grads[wc.slot_index(s)[0]][wc.slot_index(s)[1]]
                       for s in slots])
    torch.testing.assert_close(got, dgh, rtol=1e-3,
                               atol=1e-4 * float(dgh.abs().max()))
    torch.testing.assert_close(grads["tex_color"], dgt, rtol=1e-3,
                               atol=1e-4 * float(dgt.abs().max()))
    assert float(dgh.abs().min()) > 0.0


def test_full_family_bouncing_step_runs_the_adjoint(cuda_device):
    """make_train_step over all five families of bouncing_spheres (2,013
    hard slots) on the card: the forward kernel (K6) and the adjoint (K9),
    no plain pass; the loss falls (Adam at 0.02, the geometry at
    chip_smoke.ADJ_GEOM_LR) and every gradient is finite."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    flat, cam, kw = cs.pass_args(
        pt, cs.builtin(pt, "bouncing_spheres", 96, 4, 16), cuda_device)
    kw.pop("n_samples")
    kw["sky_gradient"] = True
    target = train.make_kernel_render(flat, **kw)(
        {"tex_color": flat.tex_color}, cam, 0).detach()
    params = {k: v.detach().clone()
              for k, v in train.get_params(flat).items()}
    params["tex_color"][:4] *= 0.7
    (slot,) = wc.hard_param_slots(flat, {"mat_ior"})
    params["mat_ior"][slot[1]] = 1.4
    for v in params.values():
        v.requires_grad_(True)
    step = train.make_train_step(torch.optim.Adam([
        {"params": [params["tex_color"], params["mat_ior"],
                    params["mat_fuzz"]], "lr": 0.02},
        {"params": [params["sph_center"], params["sph_radius"]],
         "lr": cs.ADJ_GEOM_LR}]), flat=flat, **kw)
    plain = (wc.render_pass_reference.calls
             + wc.render_pass_grad_reference.calls
             + ac.render_pass_adjoint_reference.calls)
    launches = ac.render_pass_adjoint_kernel.launches
    losses = [float(step(params, cam, 0, target)) for _ in range(3)]
    assert losses[2] < losses[1] < losses[0], losses
    assert ac.render_pass_adjoint_kernel.launches == launches + 3
    for f, v in params.items():
        assert bool(torch.isfinite(v.grad).all()), f
    assert (wc.render_pass_reference.calls
            + wc.render_pass_grad_reference.calls
            + ac.render_pass_adjoint_reference.calls) == plain


def test_plain_engine_on_the_card_launches_no_kernel(cuda_device):
    """engine="torch" on the card: a full-family bouncing step (the adjoint
    tier) runs the adjoint's plain version, and a 5-medium scene outside
    the kernels' gate with a few hard slots the plain tangent bundles; no
    kernel launches."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    mediums = pt.compile_scene(pt.Scene(objects=[pt.ConstantMedium(
        pt.Box((i, 0, 0), (i + 1, 1, 1),
               pt.Lambertian(pt.SolidColor((1, 1, 1)))),
        0.1, pt.SolidColor((1, 1, 1))) for i in range(5)] + [
        pt.Sphere((2.5, 0.5, -2), 0.5, pt.Dielectric(1.5)),
        pt.Sphere((0.5, 0.5, -2), 0.5, pt.Metal((0.8, 0.8, 0.8), 0.2))]),
        device=cuda_device)
    mcam = pcam.derive(pt.CameraConfig(aspect_ratio=1.0, image_width=8,
                                       lookfrom=(1.5, 1.5, 1),
                                       lookat=(1.5, 0.5, -2), vfov=60),
                       device=cuda_device)
    bflat, bcam, bkw = cs.pass_args(
        pt, cs.builtin(pt, "bouncing_spheres", 32, 4, 8), cuda_device)
    bkw.pop("n_samples")
    bkw["sky_gradient"] = True
    launches = (wc.render_pass_kernel.launches
                + wc.render_pass_grad_kernel.launches
                + ac.render_pass_adjoint_kernel.launches)
    for flat, cam, kw, plain in (
            (mediums, mcam, dict(width=8, height=8, n_strata=1, max_depth=3,
                                 sky_gradient=True),
             wc.render_pass_grad_reference),
            (bflat, bcam, bkw, ac.render_pass_adjoint_reference)):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in train.get_params(flat).items()}
        step = train.make_train_step(torch.optim.Adam(params.values(),
                                                      lr=0.02),
                                     flat=flat, engine="torch", **kw)
        calls = plain.calls
        target = torch.zeros(kw["height"], kw["width"], 3,
                             device=cuda_device)
        assert bool(torch.isfinite(step(params, cam, 0, target)))
        assert plain.calls == calls + 1
    assert (wc.render_pass_kernel.launches
            + wc.render_pass_grad_kernel.launches
            + ac.render_pass_adjoint_kernel.launches) == launches


def _bvh_env(monkeypatch, mode):
    monkeypatch.setenv("RTX_BVH_STACK", "1" if mode == "stack" else "0")
    monkeypatch.setenv("RTX_LANE_BVH", "1" if mode == "lane" else "0")


@pytest.mark.parametrize("mode, name", [("stack", "mixed"),
                                        ("lane", "spheres"),
                                        ("stack", "rows"),
                                        ("stack", "chain"),
                                        ("lane", "chain")])
def test_bvh_kernels_match_plain(mode, name, cuda_device, monkeypatch):
    """The BVH walks (K11 on mixed sphere / quad leaves, K12 on spheres
    with movers; both on a chain of spheres whose stack goes more than 8
    entries deep) against the plain pass, which tests every
    primitive: the same pixels and bounces as the chunk scan (K6) and the
    plain pass (and K12's as K11's), the compacted schedule, and the
    tex_color grad instance (the row planes, on each scene, the 28-row
    one among them) against the plain grad pass, with the
    forward's image; launches counted per mode."""
    scene = {"mixed": cs.bvh_mixed_scene, "spheres": cs.bvh_sphere_scene,
             "rows": cs.rows_scene, "chain": cs.bvh_chain_scene}[name](pt)
    flat, cam, kw = cs.pass_args(pt, cs.sized(scene, 48, 4, 8), cuda_device,
                                 use_bvh=True)
    _bvh_env(monkeypatch, mode)
    assert wc.kernel_mode(flat)[0] == mode
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    it_k = torch.zeros(n_lanes, dtype=torch.int32, device=cuda_device)
    it_p = torch.zeros_like(it_k)
    counter = f"launches_{mode}"
    before = getattr(wc.render_pass_kernel, counter)
    kern = wc.render_pass_kernel(flat, cam, 7, 0, iters=it_k, **kw)
    torch.cuda.synchronize()
    assert getattr(wc.render_pass_kernel, counter) == before + 1
    plain = wc.render_pass_reference(flat, cam, 7, 0, iters=it_p, **kw)
    k, p = kern.cpu().numpy(), plain.cpu().numpy()
    assert np.isfinite(k).all() and k.mean() > 0.01
    diff = np.abs(k - p)
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert abs(k.mean() - p.mean()) < 2e-3
    assert int(it_k.sum()) == int(it_p.sum())
    monkeypatch.setenv("RTX_BVH_STACK", "0")
    monkeypatch.setenv("RTX_LANE_BVH", "0")
    k6 = wc.render_pass_kernel(flat, cam, 7, 0, **kw)
    np.testing.assert_array_equal(k6.cpu().numpy(), k)
    if mode == "lane":
        _bvh_env(monkeypatch, "stack")
        it_s = torch.zeros_like(it_k)
        k11 = wc.render_pass_kernel(flat, cam, 7, 0, iters=it_s, **kw)
        np.testing.assert_array_equal(k11.cpu().numpy(), k)
        assert torch.equal(it_s, it_k)
    _bvh_env(monkeypatch, mode)
    two = wc.render_pass_compacted(flat, cam, 7, 0, **kw)
    assert np.allclose(k, two.cpu().numpy(), atol=1e-5)
    g = cs.cotangent(torch, kw, cuda_device, 5)
    grads = getattr(wc.render_pass_grad_kernel, f"{mode}_launches")
    img, dg_k, _ = wc.render_pass_grad_kernel(flat, cam, 7, 0, cotangent=g,
                                              **kw)
    assert getattr(wc.render_pass_grad_kernel, f"{mode}_launches") == \
        grads + 1
    np.testing.assert_array_equal(img.cpu().numpy(), k)
    _, dg_p, _ = wc.render_pass_grad_reference(flat, cam, 7, 0, cotangent=g,
                                               **kw)
    scale = float(dg_p.abs().max())
    assert scale > 0.0
    assert float((dg_k - dg_p).abs().max()) <= cs.DG_RTOL * scale


def _axis_rays(flat, device):
    """Rays along the six axis directions from seeded points around the
    scene, their zero components +0.0 or -0.0 in every combination, and
    rays at the scene's spheres from seeded points (the last third)."""
    g = np.random.default_rng(12)
    lo = np.maximum(flat.bvh_bbox_min[0].cpu().numpy() - 1.0, -30.0)
    hi = np.minimum(flat.bvh_bbox_max[0].cpu().numpy() + 1.0, 30.0)
    o, d = [], []
    for p in g.uniform(lo, hi, (48, 3)).astype(np.float32):
        for axis in range(3):
            for sign in (1.0, -1.0):
                for zeros in range(4):
                    u = np.zeros(3, np.float32)
                    u[axis] = sign
                    others = [k for k in range(3) if k != axis]
                    for j, k in enumerate(others):
                        u[k] = -0.0 if (zeros >> j) & 1 else 0.0
                    o.append(p)
                    d.append(u)
    c = flat.sph_center.cpu().numpy()
    for p in g.uniform(lo, hi, (len(o) // 2, 3)).astype(np.float32):
        t = c[g.integers(c.shape[0])] - p
        o.append(p)
        d.append((t / np.linalg.norm(t)).astype(np.float32))
    o = torch.from_numpy(np.stack(o)).to(device)
    d = torch.from_numpy(np.stack(d)).to(device)
    return o, d, torch.zeros(o.shape[0], device=device)


@pytest.mark.parametrize("name", ["spheres", "chain", "bouncing"])
def test_bvh_walks_select_alike(name, cuda_device, monkeypatch):
    """The walks' selections alone on the card (bvh_select_kernel): K12 on
    its octant links, K11 and the plain lane walk give the same winner and
    t bit for bit, on axis-aligned rays whose zero components are +0.0 or
    -0.0 (so the same ray takes different octants' links) and on rays at
    the spheres; the plain walk's winners are the all-primitive ones (the
    CPU tests)."""
    scene = {"spheres": cs.bvh_sphere_scene, "chain": cs.bvh_chain_scene,
             "bouncing": lambda api: api.builders.bouncing_spheres()}[name](
                 pt)
    flat = pt.compile_scene(scene, device=cuda_device, use_bvh=True)
    cam = pcam.derive(scene.camera, device=cuda_device)
    o, d, tm = _axis_rays(flat, cuda_device)
    got = {}
    for mode in ("lane", "stack"):
        _bvh_env(monkeypatch, mode)
        before = wc.bvh_select_kernel.launches
        got[mode] = wc.bvh_select_kernel(wc.prepare_kernel(flat, cam), o, d,
                                         tm)
        assert wc.bvh_select_kernel.launches == before + 1
    plain = wc.bvh_lane_select_reference(wc.pack_bvh_tables(flat, "lane"),
                                         o, d, tm)
    for mode in ("lane", "stack"):
        assert torch.equal(got[mode][0], plain[0]), mode
        assert torch.equal(_bits(got[mode][1]), _bits(plain[1])), mode
    assert bool((plain[0] >= 0).any()) and bool((plain[0] < 0).any())


def test_bvh_mode_is_fixed_when_packed(cuda_device, monkeypatch):
    """A packing made under one mode is not launched under another: the
    wrapper raises when the knobs changed since prepare_kernel."""
    flat, cam, kw = cs.pass_args(pt, cs.sized(cs.bvh_sphere_scene(pt), 16,
                                              1, 2), cuda_device,
                                 use_bvh=True)
    _bvh_env(monkeypatch, "lane")
    prep = wc.prepare_kernel(flat, cam)
    assert prep.mode == "lane"
    monkeypatch.setenv("RTX_LANE_BVH", "0")
    with pytest.raises(ValueError, match="pack again"):
        wc.render_pass_kernel(flat, cam, 0, 0, prepared=prep, **kw)
    wc.render_pass_kernel(flat, cam, 0, 0, **kw)   # a new packing: vscan


def test_bvh_train_step_runs_the_kernels(cuda_device, monkeypatch):
    """Training on a lane-mode scene: tex_color takes K12's grad instance
    and the loss falls; a hard family takes the adjoint (K9) on the chunk
    scan's tables, not a BVH grad instance; no plain pass runs."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    flat, cam, kw = cs.pass_args(pt, cs.sized(cs.bvh_sphere_scene(pt), 32,
                                              4, 6), cuda_device,
                                 use_bvh=True)
    _bvh_env(monkeypatch, "lane")
    kw.pop("n_samples")
    target = train.make_kernel_render(flat, **kw)(
        {"tex_color": flat.tex_color}, cam, 0).detach()
    tc = flat.tex_color.clone()
    tc[:4] *= 0.7
    params = {"tex_color": tc.requires_grad_(True)}
    step = train.make_train_step(torch.optim.Adam(params.values(), lr=0.02),
                                 flat=flat, **kw)
    lane = wc.render_pass_grad_kernel.lane_launches
    plain = (wc.render_pass_reference.calls
             + wc.render_pass_grad_reference.calls)
    losses = [float(step(params, cam, 0, target)) for _ in range(3)]
    assert losses[2] < losses[0], losses
    assert wc.render_pass_grad_kernel.lane_launches == lane + 3
    adj = ac.render_pass_adjoint_kernel.launches
    lane = wc.render_pass_grad_kernel.lane_launches
    radius = {"sph_radius": flat.sph_radius.clone().requires_grad_(True)}
    step = train.make_train_step(torch.optim.Adam(radius.values(), lr=1e-3),
                                 flat=flat, **kw)
    assert bool(torch.isfinite(step(radius, cam, 0, target)))
    assert ac.render_pass_adjoint_kernel.launches == adj + 1
    assert wc.render_pass_grad_kernel.lane_launches == lane
    assert (wc.render_pass_reference.calls
            + wc.render_pass_grad_reference.calls) == plain


@pytest.mark.parametrize("name, width", [("cornell_box", 64),
                                         ("bouncing_spheres", 96)])
def test_camera_repack_matches_a_fresh_packing(name, width, cuda_device):
    """ProgressiveRenderer.move_camera swaps only the camera's fields into
    its packing (wavefront_cuda.with_camera): the image after the move is
    a fresh prepare_kernel's at the moved camera, bit for bit, on the
    unrolled kernel and on the chunk scan."""
    from real_time_ray_tracing_engine_tpu_torch.models.render import \
        ProgressiveRenderer
    scene = pt.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = width
    scene.camera.samples_per_pixel = 16
    scene.camera.max_depth = 8
    prog = ProgressiveRenderer(scene, device=cuda_device, seed=5)
    prog.step(2)
    tables = prog._prepared.tables
    prog.move_camera((0.5, -0.25, 1.0))
    assert prog._prepared.tables is tables
    prog.step(4)
    fresh = wc.prepare_kernel(prog.flat, prog.cam)
    assert list(prog._prepared.fields["cam"]) == list(fresh.fields["cam"])
    w, h = pcam.image_size(prog.cfg)
    want = wc.render_pass_kernel(
        prog.flat, prog.cam, 5, 0, width=w, height=h, n_strata=4,
        max_depth=8, n_samples=4, sky_gradient=scene.camera.sky_gradient,
        prepared=fresh)
    torch.cuda.synchronize()
    assert torch.equal(prog.acc, want)


@pytest.mark.parametrize("k", [1, 8])
def test_progressive_equals_render_in_the_same_batches(k, cuda_device):
    """Steps of k samples sum the passes render() runs in batches of k, in
    the same order: the images are equal bit for bit (k = 8 on the
    compacted schedule)."""
    from real_time_ray_tracing_engine_tpu_torch.models.render import \
        ProgressiveRenderer
    scene = pt.builders.cornell_box()
    scene.camera.image_width = 48
    scene.camera.samples_per_pixel = 16
    scene.camera.max_depth = 8
    prog = ProgressiveRenderer(scene, device=cuda_device, seed=2)
    before = wc.render_pass_kernel.launches
    while prog.step(k):
        pass
    assert wc.render_pass_kernel.launches > before
    img = pt.render(scene, device=cuda_device, seed=2, samples_per_batch=k,
                    progress=lambda s, t: None)
    assert torch.equal(prog.image(), img)


# ------------------------------------------------ packing on the host
# (name, scene, use_bvh, RTX_BVH_STACK, RTX_LANE_BVH, prepare_kernel's
# keywords): the unrolled mode with quads and mediums, the chunk scan with
# and without quad chunks (with quads, two light kinds and a medium), both
# BVH walks, the adjoint's chunk-scan packing and a slot table
HOST_PACK_CASES = {
    "cornell_box": (lambda: pt.builders.cornell_box(), False, "0", "0", {}),
    "cornell_smoke": (lambda: pt.builders.cornell_smoke(), False, "0", "0",
                      {}),
    "bouncing_spheres": (lambda: pt.builders.bouncing_spheres(), False, "0",
                         "0", {}),
    "mis_medium": (lambda: cs.mis_medium_scene(pt), False, "0", "0", {}),
    "vquad": (lambda: cs.vquad_scene(pt), False, "0", "0", {}),
    "bvh_stack": (lambda: cs.bvh_mixed_scene(pt), True, "1", "0", {}),
    "bvh_lane": (lambda: cs.bvh_sphere_scene(pt), True, "0", "1", {}),
    "cornell_chunk_scan": (lambda: pt.builders.cornell_box(), False, "0",
                           "0", {"chunk_scan": True}),
    "cornell_slots": (lambda: pt.builders.cornell_box(), False, "0", "0",
                      {"hard_slots": "all"}),
}


@pytest.mark.parametrize("case", list(HOST_PACK_CASES))
def test_host_packing_equals_device_packing(case, cuda_device, monkeypatch):
    """A scene compiled on the host, packed there and sent in one copy is
    the packing made on the card of the scene compiled there, bit for bit:
    the tables, the chunk scan's or the walk's buffer (each view 16-byte
    aligned for the kernels' float4 rows), and every field, the camera's
    22 floats and the Perlin seed among them."""
    make, use_bvh, stack, lane, kw = HOST_PACK_CASES[case]
    monkeypatch.setenv("RTX_BVH_STACK", stack)
    monkeypatch.setenv("RTX_LANE_BVH", lane)
    scene = make()
    host_flat = pt.compile_scene(scene, use_bvh=use_bvh)
    dev_flat = pt.compile_scene(scene, use_bvh=use_bvh, device=cuda_device)
    if kw.get("hard_slots") == "all":
        kw = {"hard_slots": wc.hard_param_slots(host_flat)}
    counts = (wc.prepare_kernel.host_packs, wc.prepare_kernel.device_packs)
    host = wc.prepare_kernel(host_flat, pcam.derive(scene.camera),
                             device=cuda_device, **kw)
    dev = wc.prepare_kernel(dev_flat,
                            pcam.derive(scene.camera, device=cuda_device),
                            **kw)
    assert (wc.prepare_kernel.host_packs,
            wc.prepare_kernel.device_packs) == (counts[0] + 1, counts[1] + 1)
    assert (host.mode, host.env, host.hard_slots, host.vfields,
            host.bfields) == (dev.mode, dev.env, dev.hard_slots, dev.vfields,
                              dev.bfields)
    assert host.mode == {"bvh_stack": "stack", "bvh_lane": "lane"}.get(
        case, "unrolled" if case in ("cornell_box", "cornell_smoke",
                                     "cornell_slots") else "vscan")
    for name in ("tables", "vtab", "btab"):
        a, b = getattr(host, name), getattr(dev, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.device == b.device and a.dtype == b.dtype, name
            assert a.data_ptr() % 16 == 0, name
            assert torch.equal(a, b), name
    assert bytes(host.fields["cam"]) == bytes(dev.fields["cam"])
    assert ({k: v for k, v in host.fields.items() if k != "cam"}
            == {k: v for k, v in dev.fields.items() if k != "cam"})


@pytest.mark.parametrize("name", ["cornell_box", "bouncing_spheres"])
def test_render_packs_a_scene_on_the_host(name, cuda_device):
    """render(scene) compiles and packs on the host, once an image (one
    host packing, none on the card), and its image is, bit for bit, that of
    the same scene compiled onto the card and packed there, under the
    compacted schedule and in single passes."""
    scene = pt.builders.BUILTIN_SCENES[name]()
    cs.sized(scene, 48, 16, 8)
    for schedule in ("auto", "single"):
        counts = (wc.prepare_kernel.host_packs,
                  wc.prepare_kernel.device_packs)
        img = pt.render(scene, device=cuda_device, seed=5, schedule=schedule)
        assert (wc.prepare_kernel.host_packs,
                wc.prepare_kernel.device_packs) == (counts[0] + 1, counts[1])
        ref = pt.render(pt.compile_scene(scene, device=cuda_device),
                        scene.camera, device=cuda_device, seed=5,
                        schedule=schedule)
        assert (wc.prepare_kernel.host_packs,
                wc.prepare_kernel.device_packs) == (counts[0] + 1,
                                                    counts[1] + 1)
        torch.cuda.synchronize()
        assert torch.equal(img, ref), schedule


def test_render_sends_one_copy_and_reads_nothing_back(cuda_device):
    """Under torch.profiler, a Cornell render copies to the card at most
    twice, and reads nothing back, before its first kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    scene = cs.sized(pt.builders.cornell_box(), 48, 16, 8)
    pt.render(scene, device=cuda_device)       # the library, the pools
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pt.render(scene, device=cuda_device)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    first = next(i for i, n in enumerate(names) if "wavefront" in n)
    before = names[:first]
    to_card = [n for n in before if "HtoD" in n]
    assert 1 <= len(to_card) <= 2, before
    assert not [n for n in before if "DtoH" in n], before


def test_training_and_progressive_pack_on_the_card(cuda_device):
    """A scene already on the card is packed there, as before: a
    ProgressiveRenderer once (a camera move swaps the camera's fields
    only), and a training step at each step; neither packs on the host."""
    from real_time_ray_tracing_engine_tpu_torch.models.render import \
        ProgressiveRenderer
    scene = cs.sized(pt.builders.cornell_box(), 16, 4, 4)
    host0, dev0 = (wc.prepare_kernel.host_packs,
                   wc.prepare_kernel.device_packs)
    prog = ProgressiveRenderer(scene, device=cuda_device)
    prog.step()
    prog.move_camera((0.5, 0.0, 0.0))
    prog.step()
    assert (wc.prepare_kernel.host_packs,
            wc.prepare_kernel.device_packs) == (host0, dev0 + 1)
    flat, cam, kw = _pass_args("cornell_box", cuda_device, width=16, spp=4,
                               depth=4)
    kw = {k: v for k, v in kw.items() if k != "n_samples"}
    target = train.make_kernel_render(flat, **kw)(
        {"tex_color": flat.tex_color}, cam, 0).detach()
    params = {"tex_color": (flat.tex_color * 0.7).requires_grad_(True)}
    step = train.make_train_step(torch.optim.Adam(params.values(), lr=0.02),
                                 flat=flat, **kw)
    for _ in range(2):
        dev1 = wc.prepare_kernel.device_packs
        step(params, cam, 0, target)
        assert wc.prepare_kernel.device_packs > dev1
    assert wc.prepare_kernel.host_packs == host0
