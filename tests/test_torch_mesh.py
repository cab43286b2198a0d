"""The sharded layer of the port on the CPU: the row offset of every plain
pass, parallel/mesh.py (render_shard, render_sharded, render_on_mesh) and
training over a (tile, sample) mesh (parallel/train.py, mesh=).

The mesh runs on gloo ranks spawned once for the module (8 ranks, the
conftest's 8 CPU devices; tests/torch_ranks.py::mesh_rank): the port's
render_on_mesh at (4, 2) and (1, 8) against the JAX package's on its
8-device CPU mesh under test_pallas.py::_assert_close's rule and against
the port's one-process render. (4, 2) at depth 4 and 4 samples (the FMA
note in ROADMAP.md); (1, 8) at 16 samples, the fewest a sample axis of 8
divides, and depth 1: at 16 samples the two plain integrators part on
2.3% of the pixels at depth 2 and 2.9% at depth 4 (32 px; XLA's FMA
contraction on grazing paths), past the rule's 1%, and on none at depth
1. Then render_loss_grad over every
family at (4, 2) against the JAX render_loss_grad on make_render_mesh(4, 2)
at 32 px, n_strata 2, depth 3 (n_strata 1, one sample, cannot be split
over a sample axis of 2: the JAX render_sharded asserts it), at
test_torch_train.py's tolerances. The mesh gradient is pinned against the
one-process gradient: no factor of n_sample (parallel/train.py's
docstring). In one process: shards of a row0 > 0 against the whole
image's pass, forward, grad and adjoint, and render_shard's shard sums
against one pass. The kernels' row offset runs on the card
(chip_smoke.py's row_offset and mesh_shards phases).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import real_time_ray_tracing_engine_tpu as rt
from real_time_ray_tracing_engine_tpu.models import camera as jcam
from real_time_ray_tracing_engine_tpu.parallel import mesh as jmesh
from real_time_ray_tracing_engine_tpu.parallel import train as jtrain
from real_time_ray_tracing_engine_tpu_torch.models import camera as pcam
from real_time_ray_tracing_engine_tpu_torch.models import render as rd
from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.parallel import distributed
from real_time_ray_tracing_engine_tpu_torch.parallel import mesh
from real_time_ray_tracing_engine_tpu_torch.parallel import train
from real_time_ray_tracing_engine_tpu_torch.scene.compile import \
    compile_scene
from test_pallas import _assert_close
from torch_ranks import cornell, mesh_rank
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RENDERS = {(4, 2): dict(width=32, spp=4, depth=4),
           (1, 8): dict(width=32, spp=16, depth=1)}
LAYOUTS = tuple(RENDERS)
GRAD = dict(width=32, n_strata=2, max_depth=3)
GRAD_LAYOUT = (4, 2)
SPAWN_S = 240


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(every rank's results of tests/torch_ranks.py::mesh_rank, 8 gloo
    ranks spawned once; the JAX oracle, _jax_mesh), the ranks running
    while the oracle compiles."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            distributed.spawn_ranks, mesh_rank, 8, RENDERS, GRAD_LAYOUT,
            GRAD, timeout_s=SPAWN_S, threads=1,
            work_dir=tmp_path_factory.mktemp("mesh_ranks"))
        oracle = _jax_mesh()
        return ranks.result(), oracle


@pytest.fixture(scope="module")
def ranks(mesh_runs):
    return mesh_runs[0]


@pytest.fixture(scope="module")
def jax_mesh(mesh_runs):
    return mesh_runs[1]


def _jax_mesh():
    """The JAX package's render_on_mesh at LAYOUTS and render_loss_grad at
    GRAD_LAYOUT."""
    images = {}
    for layout, kw in RENDERS.items():
        scene = rt.builders.cornell_box()
        scene.camera.image_width = kw["width"]
        scene.camera.samples_per_pixel = kw["spp"]
        scene.camera.max_depth = kw["depth"]
        images[layout] = np.asarray(jmesh.render_on_mesh(
            scene, mesh=jmesh.make_render_mesh(*layout)))
    gscene = rt.builders.cornell_box()
    gscene.camera.image_width = GRAD["width"]
    w, h = jcam.image_size(gscene.camera)
    loss, grads = jtrain.render_loss_grad(
        rt.compile_scene(gscene), jcam.derive(gscene.camera), 0,
        jnp.zeros((h, w, 3)), mesh=jmesh.make_render_mesh(*GRAD_LAYOUT),
        width=w, height=h, **{k: v for k, v in GRAD.items()
                              if k != "width"})
    return images, float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def one_process_grad():
    """The port's render_loss_grad of GRAD in this process (no mesh)."""
    scene = cornell(GRAD["width"], 1, 1)
    w, h = pcam.image_size(scene.camera)
    return train.render_loss_grad(
        compile_scene(scene, device="cpu"), pcam.derive(scene.camera), 0,
        torch.zeros(h, w, 3), width=w, height=h,
        fields=train.TRAINABLE_FIELDS,
        **{k: v for k, v in GRAD.items() if k != "width"})


@pytest.mark.parametrize("layout", LAYOUTS)
def test_render_on_mesh_matches_jax(ranks, jax_mesh, layout):
    _assert_close(ranks[0]["images"][layout].numpy(), jax_mesh[0][layout])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_render_on_mesh_matches_one_process(ranks, layout):
    """The mesh's image is the one-process render of the same samples,
    summed in another order (one pass a shard against render's batches):
    within 1e-5 of its largest entry."""
    one = rd.render(cornell(**RENDERS[layout]), device="cpu")
    img = ranks[0]["images"][layout]
    assert float((img - one).abs().max()) <= 1e-5 * float(one.abs().max())


def test_every_rank_holds_the_image(ranks):
    for layout in LAYOUTS:
        for r in ranks[1:]:
            assert torch.equal(r["images"][layout],
                               ranks[0]["images"][layout]), layout
    assert sorted(r["shard"] for r in ranks) == [
        (t, s) for t in range(GRAD_LAYOUT[0]) for s in range(GRAD_LAYOUT[1])]


def test_render_loss_grad_on_mesh_matches_jax(ranks, jax_mesh):
    _, jloss, jgrads = jax_mesh
    np.testing.assert_allclose(ranks[0]["loss"], jloss, rtol=1e-3)
    for field in train.TRAINABLE_FIELDS:
        grad = ranks[0]["grads"][field].numpy()
        scale = float(np.abs(jgrads[field]).max())
        np.testing.assert_allclose(grad, jgrads[field], rtol=2e-2,
                                   atol=2e-3 * scale, err_msg=field)


def test_mesh_gradient_has_no_n_sample_factor(ranks, one_process_grad):
    """The mesh's loss and gradients on every rank equal the one-process
    ones, not n_sample (2) times them, as an autograd all_reduce over
    "sample" would give."""
    loss, grads = one_process_grad
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        for field, g in grads.items():
            got = r["grads"][field]
            scale = float(g.abs().max())
            if scale == 0.0:
                assert float(got.abs().max()) == 0.0, field
                continue
            ratio = float((got * g).sum() / (g * g).sum())
            assert abs(ratio - 1.0) < 1e-4, (field, ratio)
            assert float((got - g).abs().max()) <= 1e-4 * scale, field
        assert all(torch.equal(r["grads"][f], ranks[0]["grads"][f])
                   for f in grads)


def test_local_shard_gradients_sum_to_one_process():
    """The mesh render of each local shard (no collective), differentiated
    at the whole image's cotangent rows, sums to the one-process
    gradient: each shard gives its own vector-Jacobian product once
    (tex_color; every family on the ranks above)."""
    scene = cornell(16, 1, 1)
    w, h = pcam.image_size(scene.camera)
    flat = compile_scene(scene, device="cpu")
    cam = pcam.derive(scene.camera)
    kw = dict(width=w, height=h, n_strata=2, max_depth=4)
    fields = ("tex_color",)
    whole = train.make_kernel_render(flat, **kw)
    params = {f: getattr(flat, f).clone().requires_grad_(True)
              for f in fields}
    img = whole(params, cam, 0)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=img.shape).astype(np.float32))
    want = torch.autograd.grad((img * g).sum(), list(params.values()))
    got = [torch.zeros_like(p) for p in params.values()]
    parts = torch.zeros_like(img)
    for t in range(2):
        for s in range(2):
            shard = mesh.local_shard(2, 2, t, s)
            part = train.make_kernel_render(flat, mesh=shard, **kw)(
                params, cam, 0)
            rows = slice(t * h // 2, (t + 1) * h // 2)
            parts[rows] += part.detach()
            for i, d in enumerate(torch.autograd.grad(
                    (part * g[rows]).sum(), list(params.values()))):
                got[i] += d
    img = img.detach()
    assert float((parts - img).abs().max()) <= 1e-5 * float(img.abs().max())
    for f, a, b in zip(fields, got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), f


def test_a_step_over_a_local_shard_is_refused():
    """A training step over a layout without a process group would use a
    loss and gradient that are neither the shard's nor the image's: both
    entry points refuse it, and a 1 x 1 mesh still steps."""
    scene = cornell(8, 1, 1)
    flat = compile_scene(scene, device="cpu")
    cam = pcam.derive(scene.camera)
    kw = dict(width=8, height=8, n_strata=2, max_depth=2, engine="torch")
    target = torch.zeros(8, 8, 3)
    params = {"tex_color": flat.tex_color.clone().requires_grad_(True)}
    for shard in (mesh.local_shard(2, 1, 0, 0), mesh.local_shard(1, 2, 0, 1)):
        with pytest.raises(ValueError, match="local shard"):
            train.render_loss_grad(flat, cam, 0, target, mesh=shard, **kw)
        with pytest.raises(ValueError, match="local shard"):
            train.make_train_step(torch.optim.Adam(params.values()),
                                  flat=flat, mesh=shard, **kw)
    loss, _ = train.render_loss_grad(flat, cam, 0, target,
                                     mesh=mesh.local_shard(1, 1, 0, 0), **kw)
    assert np.isfinite(float(loss))


def _plain():
    scene = cornell(8, 4, 4)
    flat = compile_scene(scene, device="cpu")
    return flat, pcam.derive(scene.camera), dict(
        width=8, n_strata=2, max_depth=4, n_samples=4, sky_gradient=False)


def test_row_offset_of_the_plain_passes():
    """A shard at row0 > 0 renders the whole image's rows [row0, row0 +
    height): the forward (single and compacted) and the plain engine bit
    for bit, and the grad (tex_color) and adjoint (every family, both
    sweeps) passes' images; their gradients of the two halves sum to the
    whole image's."""
    flat, cam, kw = _plain()
    whole = wc.render_pass_reference(flat, cam, 3, 0, height=8, **kw)
    rows = slice(4, 7)
    assert torch.equal(wc.render_pass_reference(
        flat, cam, 3, 0, height=3, row0=4, **kw), whole[rows])
    assert torch.equal(wc.render_pass_compacted(
        flat, cam, 3, 0, height=3, row0=4, caps=(3,),
        pass_fn=wc.render_pass_reference, **kw), whole[rows])
    assert torch.equal(rd._render_pass(flat, cam, 3, 0, height=3, row0=4,
                                       tile_rows=2, **kw), whole[rows])
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 8, 3)).astype(np.float32))
    full = wc.render_pass_grad_reference(flat, cam, 3, 0, height=8,
                                         cotangent=g, **kw)
    halves = [wc.render_pass_grad_reference(
        flat, cam, 3, 0, height=4, row0=r, cotangent=g[r:r + 4], **kw)
        for r in (0, 4)]
    assert torch.equal(torch.cat([halves[0][0], halves[1][0]]), full[0])
    got = halves[0][1] + halves[1][1]
    assert float((got - full[1]).abs().max()) <= 1e-5 * float(
        full[1].abs().max())
    for adjoint in (ac.render_pass_adjoint_reference,
                    ac.plain_adjoint_pass(3)):
        img, grads = adjoint(flat, cam, 3, 0, height=8, cotangent=g, **kw)
        parts = [adjoint(flat, cam, 3, 0, height=4, row0=r,
                         cotangent=g[r:r + 4], **kw) for r in (0, 4)]
        assert torch.equal(torch.cat([parts[0][0], parts[1][0]]), img)
        for f, want in grads.items():
            got = parts[0][1][f] + parts[1][1][f]
            assert float((got - want).abs().max()) <= 1e-5 * max(
                float(want.abs().max()), 1e-30), f


@pytest.mark.parametrize("layout", [(2, 1), (4, 1), (1, 2), (2, 2)])
def test_render_shard_sums_match_one_pass(layout):
    """render_shard over every shard of a layout, the sample shards of a
    tile summed: a tile-only layout gives the one-process pass bit for
    bit, a sample split the same within 1e-5 of its largest entry."""
    scene = cornell(16, 4, 4)
    flat = compile_scene(scene, device="cpu")
    cam = pcam.derive(scene.camera)
    common = dict(width=16, n_strata=2, max_depth=4, sky_gradient=False,
                  engine="torch")
    one = mesh.render_shard(flat, cam, 5, h_local=16, row0=0, spp_local=4,
                            sample0=0, **common)
    n_tile, n_sample = layout
    h, spp = 16 // n_tile, 4 // n_sample
    img = torch.cat([sum(mesh.render_shard(
        flat, cam, 5, h_local=h, row0=t * h, spp_local=spp,
        sample0=s * spp, **common) for s in range(n_sample))
        for t in range(n_tile)])
    if n_sample == 1:
        assert torch.equal(img, one)
    else:
        assert float((img - one).abs().max()) <= 1e-5 * float(
            one.abs().max())


def test_mesh_rules():
    """One process without a group is the 1 x 1 mesh; layouts must cover
    the world; a shard needs the axes to divide the height and samples;
    render_on_mesh raises n_strata until the sample axis divides it."""
    m = mesh.make_render_mesh()
    assert (m.shape, m.device_mesh, m.group("sample")) == (
        {"tile": 1, "sample": 1}, None, None)
    with pytest.raises(ValueError):
        mesh.make_render_mesh(2, 1)
    assert mesh._layout(8, None, None) == (4, 2)
    assert mesh._layout(6, 3, None) == (3, 2)
    assert mesh._layout(3, None, None) == (3, 1)
    with pytest.raises(ValueError):
        mesh._layout(8, 3, None)
    assert mesh.local_shard(4, 2, 3, 1).shard(32, 16) == (24, 8, 8, 8)
    with pytest.raises(ValueError):
        mesh.local_shard(3, 1, 0, 0).shard(32, 4)
    with pytest.raises(ValueError):
        mesh.local_shard(1, 2, 0, 0).shard(32, 9)
    with pytest.raises(ValueError):
        mesh.local_shard(2, 2, 2, 0)
    assert mesh.mesh_strata(3, 2) == 4 and mesh.mesh_strata(10, 2) == 10
    with pytest.raises(ValueError):
        wc.render_pass_reference(*_plain()[:2], 0, 0, height=4, row0=-1,
                                 **_plain()[2])
