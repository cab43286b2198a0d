"""The chunk scan (K6 vscan, K7 vquad) of the port against the JAX package.

The port's packing of the Morton chunk tables is the JAX packers'
(_pack_vscan_tables, _pack_vquad_tables) row for row; the plain version of
the kernel's selection (vscan_select_reference: chunk walk, per-ray box
cull, big block, quad chunks) picks the all-primitive closest_hit's winner
and t bit for bit; the port's plain pass renders large scenes as the JAX
oracle does; and the gates say which kernel takes a scene and, for the grad
passes, which one is missing. The CUDA instance itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Exactness and torch's CPU sqrt: torch's float32 sqrt in CPU builds with
AVX-512 and MKL (2.13.0+cpu) is not correctly rounded (about 0.6% of
random inputs land one ulp off) and rounds an element differently
depending on where the thread split puts it, so two calls on different
subsets of rays can differ in the last bit. The CUDA kernel and torch on the card round sqrt exactly.
The exact-selection tests therefore run the primitive tests with an exactly
rounded float32 sqrt (through float64), on both sides alike; what they
check is the walk, the cull and the tie rule.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_ray_tracing_engine_tpu as rt
import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu.models import camera as jcam
from real_time_ray_tracing_engine_tpu.models.render import \
    _render_pass as jax_render_pass
from real_time_ray_tracing_engine_tpu.ops import wavefront_pallas as wp
from real_time_ray_tracing_engine_tpu_torch.models import camera as pcam
from real_time_ray_tracing_engine_tpu_torch.ops import intersect as pint
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.parallel import train
from real_time_ray_tracing_engine_tpu_torch.scene.convert import (
    camera_from_numpy, camera_to_numpy, flat_from_numpy, flat_to_numpy)
from real_time_ray_tracing_engine_tpu_torch.scene.flat import FlatScene

from test_pallas import _assert_close as assert_close

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)

SCENES = {"bouncing_spheres": rt.builders.bouncing_spheres,
          "multichunk": lambda: cs.multichunk_scene(rt),
          "vquad": lambda: cs.vquad_scene(rt)}


def _carried(scene):
    """(JAX flat, port flat) of one JAX scene, the tables carried across."""
    jf = rt.compile_scene(scene)
    return jf, flat_from_numpy(*flat_to_numpy(jf), device="cpu")


@pytest.fixture
def exact_sqrt(monkeypatch):
    """Exactly rounded float32 sqrt in the primitive tests (see the module
    docstring)."""
    monkeypatch.setattr(pint, "safe_sqrt", lambda x, eps=1e-12: torch.sqrt(
        torch.clamp(x, min=eps).double()).float())


def _winners(flat, o, d, tm):
    """closest_hit's selection: the first of the smallest roots over all
    primitives (-1 and BIG on a miss)."""
    t, prim = pint.all_prim_ts(flat, o, d, tm).min(1)
    hit = t < wc.BIG * 0.5
    return torch.where(hit, prim, -1), torch.where(hit, t, wc.BIG)


def _assert_same_winners(vt, flat, o, d, tm):
    prim, t = wc.vscan_select_reference(vt, o, d, tm)
    want_prim, want_t = _winners(flat, o, d, tm)
    np.testing.assert_array_equal(prim.numpy(), want_prim.numpy())
    np.testing.assert_array_equal(t.numpy(), want_t.numpy())
    return prim


@pytest.mark.parametrize("name", list(SCENES))
def test_packing_matches_jax(name):
    """Rows, permutation, chunk counts and boxes against the JAX packers,
    exactly: the Morton quantisation is the same float32 operations on both
    sides, and no XLA rewrite moved a code on these scenes."""
    jf, pf = _carried(SCENES[name]())
    vt = wc.pack_vscan_tables(pf)
    S, Q = jf.sph_center.shape[0], jf.quad_corner.shape[0]
    # the resolved material rows only feed the JAX gather tables, which
    # the port does not carry: zeros of their shape (wavefront_pallas.py
    # PMCOLS); jit compiles each packer once (op by op, eager JAX spends
    # seconds compiling); neither moves a float op of the packing
    primmat = jnp.zeros((S + Q, wp.PMCOLS), jnp.float32)
    rows, ptab, _, vbox, C, C_g, C_stat, n_big = (
        np.asarray(x) for x in jax.jit(wp._pack_vscan_tables)(
            jf, primmat[:S]))
    C, C_g = int(C), int(C_g)
    assert (vt.C, vt.C_stat, vt.n_big) == (C, int(C_stat), int(n_big))
    if name == "bouncing_spheres":
        assert (C, C_stat, n_big) == (5, 0, 8)
    ids = ptab.reshape(C_g, 16, 128)[:, 8].reshape(-1)
    np.testing.assert_array_equal(vt.perm.numpy(), ids[ids >= 0])
    np.testing.assert_array_equal(vt.rows[:, :6].numpy(), rows[:, :6])
    real = vt.rows[:, 7].numpy() >= 0
    np.testing.assert_array_equal(vt.rows[real, 6].numpy(), rows[real, 7])
    np.testing.assert_array_equal(vt.box[:C].numpy(), vbox)
    assert wc.kernel_mode(pf) == ("vscan", Q > wc.MAX_QUADS_VSCAN)
    if Q > wc.MAX_QUADS_VSCAN:
        qrows, _, _, qbox, Cq, _ = (
            np.asarray(x) for x in jax.jit(wp._pack_vquad_tables)(
                jf, primmat[S:]))
        assert vt.Cq == int(Cq)
        # the JAX quad rows carry no id: match their corners to the scene's
        corners = np.asarray(jf.quad_corner)
        jq = [int(np.flatnonzero((corners == c).all(1))[0])
              for c in qrows[:Q, 4:7]]
        np.testing.assert_array_equal(vt.qperm.numpy(), jq)
        np.testing.assert_array_equal(vt.qrows[:, :12].numpy(),
                                      qrows[:, [4, 5, 6, 7, 8, 9, 10, 11, 12,
                                                0, 1, 2]])
        np.testing.assert_array_equal(vt.box[C:].numpy(), qbox)


def test_kernel_buffer_layout():
    """The vscan buffer holds the rows, the quad rows (16-byte aligned, the
    kernel reads float4s) and the boxes widened by the pad."""
    pf = pt.compile_scene(cs.vquad_scene(pt))
    vt = wc.pack_vscan_tables(pf)
    buf, f = wc._vscan_buffer(vt)
    assert f["off_qrows"] % 4 == 0 and f["off_box"] % 4 == 0
    assert (f["C_small"], f["n_big"], f["Cq"]) == (vt.C_small, vt.n_big,
                                                    vt.Cq)
    np.testing.assert_array_equal(
        buf[f["off_rows"]:f["off_qrows"]].numpy(), vt.rows.reshape(-1))
    np.testing.assert_array_equal(
        buf[f["off_qrows"]:f["off_box"]].numpy(), vt.qrows.reshape(-1))
    box = buf[f["off_box"]:].reshape(-1, 6)
    assert f["n_box"] == box.numel() == 6 * (vt.C + vt.Cq)
    full = vt.box[:, 0] <= vt.box[:, 3]
    np.testing.assert_array_equal(box[full, :3].numpy(),
                                  (vt.box[full, :3] - vt.pad).numpy())
    np.testing.assert_array_equal(box[full, 3:].numpy(),
                                  (vt.box[full, 3:] + vt.pad).numpy())
    assert vt.pad > 0.0


def _rays(flat, n, seed):
    """Seeded rays from inside and around the scene, a quarter from the
    camera's side; a few along axes and with a component under the 1/d
    guard."""
    g = np.random.default_rng(seed)
    lo = flat.sph_center.min(0).values.numpy() - 2.0
    hi = flat.sph_center.max(0).values.numpy() + 2.0
    if flat.quad_corner.shape[0]:
        lo = np.minimum(lo, flat.quad_corner.min(0).values.numpy() - 2.0)
        hi = np.maximum(hi, flat.quad_corner.max(0).values.numpy() + 2.0)
    lo, hi = np.maximum(lo, -30.0), np.minimum(hi, 30.0)
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[: n // 4] = g.uniform(hi, hi + 10.0, (n // 4, 3))
    d = g.normal(size=(n, 3)).astype(np.float32)
    d[: n // 4] = (g.uniform(lo, hi, (n // 4, 3)) - o[: n // 4])
    d[n // 4: n // 4 + 50, 1] = 0.0
    d[n // 4 + 50: n // 4 + 100, 0] = 1e-13
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = g.uniform(0, 1, n).astype(np.float32)
    return (torch.from_numpy(o), torch.from_numpy(d.astype(np.float32)),
            torch.from_numpy(tm))


@pytest.mark.parametrize("name", list(SCENES) + ["grid9"])
def test_select_reference_matches_closest_hit(name, exact_sqrt):
    scene = (cs.grid_scene(rt, 9) if name == "grid9" else SCENES[name]())
    _, pf = _carried(scene)
    vt = wc.pack_vscan_tables(pf)
    o, d, tm = _rays(pf, 3000, len(name))
    prim = _assert_same_winners(vt, pf, o, d, tm)
    assert (prim >= 0).float().mean() > 0.1
    if vt.Cq:
        assert (prim >= vt.S).any()         # quad winners from the chunks


def test_select_ties_go_to_the_lowest_id(exact_sqrt):
    """Two spheres equal at time 0, one static and one moving, land in
    different chunks (statics first, movers after); a ray at time 0 hits
    both at the same t, and the lower original id wins whichever chunk the
    walk reaches first."""
    g = np.random.default_rng(5)
    lam = rt.Lambertian(rt.SolidColor((0.5, 0.5, 0.5)))
    objs = [rt.Sphere(tuple(map(float, g.uniform(-6, 6, 3))), 0.3, lam)
            for _ in range(270)]
    objs += [rt.Sphere((20.0 + 3 * i, 0, 0), 1.0, lam) for i in range(8)]
    # pair 1: the mover has the lower id; pair 2: the static one has
    objs[3] = rt.Sphere((-6.5, -6.5, -6.5), 0.3, lam,
                        center2=(-6.5, -6.0, -6.5))
    objs[150] = rt.Sphere((-6.5, -6.5, -6.5), 0.3, lam)
    objs[5] = rt.Sphere((-6.5, 6.5, -6.5), 0.3, lam)
    objs[200] = rt.Sphere((-6.5, 6.5, -6.5), 0.3, lam,
                          center2=(-6.5, 7.0, -6.5))
    _, pf = _carried(rt.Scene(objects=objs))
    vt = wc.pack_vscan_tables(pf)
    chunk = {int(i): p // wc.VCHUNK for p, i in enumerate(vt.perm)}
    assert chunk[3] != chunk[150] and chunk[5] != chunk[200]
    n = 400
    o = torch.from_numpy(np.random.default_rng(6).uniform(
        -4, 4, (n, 3)).astype(np.float32))
    target = torch.tensor([[-6.5, -6.5, -6.5]] * (n // 2)
                          + [[-6.5, 6.5, -6.5]] * (n // 2))
    d = target - o
    d = d / d.norm(dim=1, keepdim=True)
    tm = torch.zeros(n)
    prim, t = wc.vscan_select_reference(vt, o, d, tm)
    _assert_same_winners(vt, pf, o, d, tm)
    tied = ((prim == 3) | (prim == 5)).float().mean()
    assert tied > 0.5, tied
    assert not ((prim == 150) | (prim == 200)).any()


def test_select_grazing_chunk_box_faces(exact_sqrt):
    """Rays along the faces of the chunk boxes, tangent to the sphere that
    spans each face, just inside and just outside: the widened boxes keep
    every grazing winner the all-primitive test finds."""
    _, pf = _carried(cs.multichunk_scene(rt))
    vt = wc.pack_vscan_tables(pf)
    o, d = [], []
    for c in range(vt.C_small):
        rows = vt.rows[c * wc.VCHUNK:(c + 1) * wc.VCHUNK]
        rows = rows[(rows[:, 7] >= 0) & (rows[:, 3:6] == 0).all(1)]
        for axis in range(3):
            for side, pick in ((-1.0, rows[:, axis].argmin()),
                               (1.0, rows[:, axis].argmax())):
                r = rows[pick]
                tip = r[:3].clone()
                tip[axis] += side * r[6]
                for k in range(8):
                    u = torch.zeros(3)
                    ang = k * np.pi / 4
                    u[(axis + 1) % 3], u[(axis + 2) % 3] = (np.cos(ang),
                                                            np.sin(ang))
                    for off in (-1e-4, -1e-6, 0.0, 1e-6, 1e-4):
                        p = tip.clone()
                        p[axis] += side * off
                        o.append(p - 3.0 * u)
                        d.append(u)
    o, d = torch.stack(o), torch.stack(d)
    tm = torch.zeros(o.shape[0])
    prim = _assert_same_winners(vt, pf, o, d, tm)
    assert (prim >= 0).any() and (prim < 0).any()


def _render_args(scene, spp):
    jf = rt.compile_scene(scene)
    jc = jcam.derive(scene.camera)
    pf = flat_from_numpy(*flat_to_numpy(jf), device="cpu")
    pc = camera_from_numpy(camera_to_numpy(jc), device="cpu")
    w, h = jcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=int(np.sqrt(spp)), max_depth=4,
              n_samples=spp, sky_gradient=scene.camera.sky_gradient)
    return jf, jc, pf, pc, kw


@pytest.mark.parametrize("name", ["bouncing_spheres", "nested_checker"])
def test_plain_pass_matches_jax(name):
    """The port's plain pass (the kernel's parity reference on the card)
    on vscan scenes against the JAX oracle, under test_pallas.py's rule at
    depth 4 (deeper, XLA's CPU FMAs part grazing paths from torch's two
    roundings: ROADMAP queue 3)."""
    if name == "bouncing_spheres":
        scene = rt.builders.bouncing_spheres()
        scene.camera.image_width = 32
        spp = 2
    else:
        scene, spp = cs.vscan_nested_checker_scene(rt), 4
    jf, jc, pf, pc, kw = _render_args(scene, spp)
    assert wc.kernel_mode(pf)[0] == "vscan" and wp._kernel_modes(jf)[3]
    img_j = np.asarray(jax_render_pass(jf, jc, jnp.uint32(3), jnp.int32(0),
                                       tile_rows=kw["height"], **kw))
    img_p = wc.render_pass_reference(pf, pc, 3, 0, **kw).numpy()
    assert img_p.shape == img_j.shape and img_j.mean() > 0.01
    assert_close(img_p, img_j)


def test_gates():
    """The forward gate admits every scene up to MAX_PRIMS_SCAN and names
    the BVH (-b, K11/K12) past it; the grad gates admit the chunk scan's
    tiers (K3v, K4v, K8) and name the adjoint kernels (K9/K10) past
    MAX_HARD_SLOTS slots."""
    admitted = [pt.builders.bouncing_spheres(), pt.builders.textured_spheres(),
                cs.grid_scene(pt), cs.city_scene(pt)]
    for scene in admitted:
        flat = pt.compile_scene(scene)
        assert wc.kernel_gate_reason(flat) is None, scene.name
        assert wc.kernel_mode(flat) == (
            "vscan", scene.name == "city"), scene.name
    assert wc.kernel_mode(pt.compile_scene(pt.builders.cornell_box())) == (
        "unrolled", False)
    lam = pt.Lambertian(pt.SolidColor((0.5, 0.5, 0.5)))
    past = pt.compile_scene(pt.Scene(objects=[
        pt.Sphere((3.0 * (i % 128), 3.0 * (i // 128), 0), 1.0, lam)
        for i in range(wc.MAX_PRIMS_SCAN + 1)]))
    reason = wc.kernel_gate_reason(past)
    assert "MAX_PRIMS_SCAN" in reason and "-b" in reason \
        and "K11/K12" in reason
    bouncing = pt.compile_scene(pt.builders.bouncing_spheres())
    assert wc.grad_gate_reason(bouncing) is None
    assert wc.tex_form(bouncing) == "suffix"
    slots = wc.hard_param_slots(bouncing)
    assert len(slots) > wc.MAX_HARD_SLOTS
    assert "K9/K10" in wc.hard_slots_gate_reason(bouncing, len(slots))
    small = pt.compile_scene(pt.Scene(objects=[
        pt.Sphere((3.0 * i, 0, 0), 1.0, lam) for i in range(80)]))
    assert wc.grad_gate_reason(small) is None
    assert wc.tex_form(small) == "planes"
    assert wc.hard_slots_gate_reason(small, 4) is None
    cornell = pt.compile_scene(pt.builders.cornell_box())
    assert wc.grad_gate_reason(cornell) is None
    assert wc.default_caps(bouncing, 16, 50) == (32, 32)


def test_vscan_training_on_the_kernels_raises(monkeypatch):
    """Training bouncing_spheres on the (faked) card: tex_color (the suffix
    tier, K8) and tex_color with its one IOR slot (K4v riding K8) pass the
    request's gate and reach the kernels' render, while mat_fuzz (72
    slots) raises NotImplementedError naming the adjoint kernels K9/K10
    before any pass; the plain engine still trains it."""
    scene = pt.builders.bouncing_spheres()
    flat = pt.compile_scene(scene)
    kw = dict(width=8, height=5, n_strata=1, max_depth=2)
    calls = (wc.render_pass_reference.calls
             + wc.render_pass_grad_reference.calls)
    cam = pcam.derive(scene.camera)
    applied = []
    with monkeypatch.context() as m:
        m.setattr(FlatScene, "device",
                  property(lambda self: torch.device("cuda", 0)))
        render = train.make_kernel_render(flat, **kw)
    with monkeypatch.context() as m:
        m.setattr(train._KernelRender, "apply",
                  lambda *a: applied.append(a[3]) or torch.zeros(5, 8, 3))
        render({"tex_color": flat.tex_color}, cam, 0)
        render({"tex_color": flat.tex_color, "mat_ior": flat.mat_ior},
               cam, 0)
        with pytest.raises(NotImplementedError, match="K9/K10"):
            render({"mat_fuzz": flat.mat_fuzz}, cam, 0)
    assert [(r.names, len(r.slots)) for r in applied] == [
        (("tex_color",), 0), (("tex_color", "mat_ior"), 1)]
    assert (wc.render_pass_reference.calls
            + wc.render_pass_grad_reference.calls) == calls
    p = {"tex_color": flat.tex_color.clone().requires_grad_(True)}
    step = train.make_train_step(torch.optim.Adam(p.values(), lr=0.01),
                                 flat=flat, engine="torch", **kw)
    loss = step(p, cam, 0, torch.zeros(5, 8, 3))
    assert bool(torch.isfinite(loss)) and p["tex_color"].grad is not None
