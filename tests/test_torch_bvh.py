"""The SAH BVH (ops/bvh.py, -b) and the BVH modes (K11, K12) of the port
against the JAX package.

compile_scene(use_bvh=True) gives the JAX package's tree exactly (its C++
builder, compiled with the JAX package's flags, or its numpy builder);
closest_hit_bvh and the plain engine's -b render are the JAX oracle's; the
plain versions of the kernels' selections (the stack walk and the lane
walk over pack_bvh_tables' widened boxes) pick the all-primitive winner
and t bit for bit; kernel_mode and the gates agree with the JAX package's
under each setting of RTX_BVH_STACK / RTX_LANE_BVH; training takes the
JAX tier on a BVH-mode scene; the CLI's -b renders on the CPU. The CUDA
instances run only on the card (tests/test_torch_cuda.py, chip_smoke.py).
The exact-selection tests rely on the port's correctly rounded sqrt
(utils/vecmath.sqrt; see test_torch_vscan.py's docstring)."""
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_ray_tracing_engine_tpu as rt
import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu.models import camera as jcam
from real_time_ray_tracing_engine_tpu.models.render import \
    _render_pass as jax_render_pass
from real_time_ray_tracing_engine_tpu.ops import bvh as jbvh
from real_time_ray_tracing_engine_tpu.ops.intersect import \
    closest_hit as jclosest_hit
from real_time_ray_tracing_engine_tpu.ops import wavefront_pallas as wp
from real_time_ray_tracing_engine_tpu_torch.models import camera as pcam
from real_time_ray_tracing_engine_tpu_torch.models import render as prender
from real_time_ray_tracing_engine_tpu_torch.ops import bvh as pbvh
from real_time_ray_tracing_engine_tpu_torch.ops import intersect as pint
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.parallel import train
from real_time_ray_tracing_engine_tpu_torch.scene.convert import (
    camera_from_numpy, camera_to_numpy, flat_from_numpy, flat_to_numpy)
from real_time_ray_tracing_engine_tpu_torch.scene.flat import FlatScene
from real_time_ray_tracing_engine_tpu_torch.utils import cli

from test_pallas import _assert_close as assert_close

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)
from torch_threads import one_torch_thread  # noqa: E402,F401

BVH_FIELDS = ("bvh_bbox_min", "bvh_bbox_max", "bvh_left", "bvh_right",
              "bvh_axis", "bvh_leaf", "bvh_prims", "bvh_leaf_sph",
              "bvh_hit", "bvh_miss")
ENVS = {"default": {}, "stack": {"RTX_BVH_STACK": "1"},
        "lane": {"RTX_LANE_BVH": "1"},
        "both": {"RTX_BVH_STACK": "1", "RTX_LANE_BVH": "1"}}


def random_scene(api, n=150, seed=0):
    """tests/test_bvh.py's random scene: 150 spheres and 20 quads."""
    g = np.random.default_rng(seed)
    mat = api.Lambertian(api.SolidColor((0.5, 0.5, 0.5)))
    objs = [api.Sphere(tuple(g.uniform(-10, 10, 3)), g.uniform(0.2, 1.0),
                       mat) for _ in range(n)]
    objs += [api.Quad(tuple(g.uniform(-10, 10, 3)), tuple(g.uniform(-2, 2, 3)),
                      tuple(g.uniform(-2, 2, 3)), mat) for _ in range(20)]
    return api.Scene(objects=objs)


SCENES = {"random": random_scene, "bouncing_spheres":
          lambda api: api.builders.bouncing_spheres()}


@pytest.fixture(scope="module")
def compiled():
    """(JAX flat, port flat) of each scene compiled with use_bvh, once."""
    return {name: (rt.compile_scene(make(rt), use_bvh=True),
                   pt.compile_scene(make(pt), use_bvh=True))
            for name, make in SCENES.items()}


def _assert_trees_equal(jf, pf):
    for f in BVH_FIELDS:
        want = np.asarray(getattr(jf, f))
        got = getattr(pf, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert pf.use_bvh and jf.use_bvh


@pytest.mark.parametrize("name", list(SCENES))
def test_tree_matches_jax(name, compiled):
    """Every bvh_* table of the port's compile_scene(use_bvh=True) is the
    JAX package's, exactly (the C++ builder, here and there compiled with
    the same flags); flat_from_numpy carries a JAX use_bvh flat across."""
    jf, pf = compiled[name]
    _assert_trees_equal(jf, pf)
    carried = flat_from_numpy(*flat_to_numpy(jf), device="cpu")
    _assert_trees_equal(jf, carried)
    if name == "bouncing_spheres":
        assert pf.bvh_left.shape[0] == 331


def test_numpy_builder_matches_jax(monkeypatch):
    """Without the C++ builder both packages take their numpy builders,
    which agree exactly (and differ from the C++ tree, as in the JAX
    package)."""
    monkeypatch.setattr(jbvh, "_build_native", lambda *a: None)
    monkeypatch.setattr(pbvh, "_native_library", lambda: None)
    jf = rt.compile_scene(random_scene(rt), use_bvh=True)
    pf = pt.compile_scene(random_scene(pt), use_bvh=True)
    _assert_trees_equal(jf, pf)


def test_tree_structure(compiled, monkeypatch):
    """tests/test_bvh.py's invariants (leaves of at most 4, every active
    prim once), leaves segregated spheres first with their sphere counts,
    skip links that visit every node once in depth-first order, and the
    depth check: a tree deeper than STACK_DEPTH allows raises."""
    _, pf = compiled["random"]
    leaf = pf.bvh_leaf.numpy()
    left, right = pf.bvh_left.numpy(), pf.bvh_right.numpy()
    prims, leaf_sph = pf.bvh_prims.numpy(), pf.bvh_leaf_sph.numpy()
    S = pf.sph_center.shape[0]
    assert right[leaf].max() <= pbvh.MAX_LEAF
    active = np.concatenate([pf.sph_active.numpy(), pf.quad_active.numpy()])
    assert sorted(prims.tolist()) == np.nonzero(active)[0].tolist()
    for i in np.nonzero(leaf)[0]:
        run = prims[left[i]:left[i] + right[i]]
        k = leaf_sph[i]
        assert (run[:k] < S).all() and (run[k:] >= S).all()
    assert (leaf_sph[~leaf] == 0).all()
    B = left.shape[0]
    hit, miss = pf.bvh_hit.numpy(), pf.bvh_miss.numpy()
    seen, node = [], 0
    while node < B:                  # every box met: the hit links only
        seen.append(node)
        node = hit[node]
    assert sorted(seen) == list(range(B))
    order, stack = [], [0]           # the depth-first order, left first
    while stack:
        i = stack.pop()
        order.append(i)
        if not leaf[i]:
            stack += [right[i], left[i]]
    assert seen == order
    assert miss[0] == B and hit[0] == left[0]
    depth = pbvh.tree_depth(left, right, leaf)
    assert 0 < depth < pbvh.STACK_DEPTH
    monkeypatch.setattr(pbvh, "STACK_DEPTH", depth)
    with pytest.raises(ValueError, match="STACK_DEPTH"):
        pt.compile_scene(random_scene(pt), use_bvh=True)


def test_closest_hit_bvh_matches_jax(compiled):
    """The traversal oracle against the JAX package's on test_bvh.py's 256
    random rays: hit and material equal, t equal to the JAX all-primitive
    closest_hit's bit for bit (the port's oracle tests a leaf's primitives
    with the all-primitive test's own sphere_roots / quad_hits), and to the
    JAX BVH oracle's within 1e-5 relative. The JAX BVH oracle itself parts
    from the JAX all-primitive t by up to 7.2e-6 relative on these rays
    (XLA:CPU contracts multiply-adds in its while loop's compiled body;
    torch and the eager all-primitive path round each operation), so 1e-6
    holds against the all-primitive t, not against it. Then test_bvh.py:71's
    moving sphere."""
    jf, pf = compiled["random"]
    g = np.random.default_rng(1)
    o = g.uniform(-15, 15, (256, 3)).astype(np.float32)
    d = g.normal(size=(256, 3)).astype(np.float32)
    a = jbvh.closest_hit_bvh(jf, jnp.asarray(o), jnp.asarray(d),
                             jnp.zeros(256))
    b = pbvh.closest_hit_bvh(pf, torch.from_numpy(o), torch.from_numpy(d),
                             torch.zeros(256))
    brute = jclosest_hit(jf, jnp.asarray(o), jnp.asarray(d), jnp.zeros(256))
    hit = np.asarray(a.hit)
    np.testing.assert_array_equal(b.hit.numpy(), hit)
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_array_equal(b.t.numpy()[hit], np.asarray(brute.t)[hit])
    np.testing.assert_allclose(b.t.numpy()[hit], np.asarray(a.t)[hit],
                               rtol=1e-5)
    np.testing.assert_array_equal(b.mat.numpy()[hit],
                                  np.asarray(a.mat)[hit])

    def moving(api):
        mat = api.Lambertian(api.SolidColor((0.5, 0.5, 0.5)))
        return api.Scene(objects=[api.Sphere((0, 0, -5), 1.0, mat,
                                             center2=(0, 5, -5))]
                         + [api.Sphere((8, 0, -5), 1.0, mat)
                            for _ in range(6)])
    mf = pt.compile_scene(moving(pt), use_bvh=True)
    rec = pbvh.closest_hit_bvh(mf, torch.tensor([[0.0, 4.9, 0.0]]),
                               torch.tensor([[0.0, 0.0, -1.0]]),
                               torch.ones(1))
    assert bool(rec.hit[0]) and int(rec.mat[0]) == int(mf.sph_mat[0])
    jrec = jbvh.closest_hit_bvh(rt.compile_scene(moving(rt), use_bvh=True),
                                jnp.asarray([[0.0, 4.9, 0.0]]),
                                jnp.asarray([[0.0, 0.0, -1.0]]), jnp.ones(1))
    np.testing.assert_allclose(rec.t.numpy(), np.asarray(jrec.t), rtol=1e-6)


def _winners(flat, o, d, tm):
    t, prim = pint.all_prim_ts(flat, o, d, tm).min(1)
    hit = t < wc.BIG * 0.5
    return torch.where(hit, prim, -1), torch.where(hit, t, wc.BIG)


def _assert_same_winners(flat, mode, o, d, tm):
    bt = wc.pack_bvh_tables(flat, mode)
    fn = (wc.bvh_stack_select_reference if mode == "stack"
          else wc.bvh_lane_select_reference)
    prim, t = fn(bt, o, d, tm)
    want_prim, want_t = _winners(flat, o, d, tm)
    np.testing.assert_array_equal(prim.numpy(), want_prim.numpy())
    np.testing.assert_array_equal(t.numpy(), want_t.numpy())
    return prim


def _scene_rays(flat, n, seed):
    """Seeded rays from inside and around the scene (a quarter aimed at
    it from outside), some along axes and some under the 1/d guard, at
    times in [0, 1)."""
    lo = flat.bvh_bbox_min[0].numpy() - 2.0
    hi = flat.bvh_bbox_max[0].numpy() + 2.0
    lo, hi = np.maximum(lo, -30.0), np.minimum(hi, 30.0)
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[: n // 4] = g.uniform(hi, hi + 10.0, (n // 4, 3))
    d = g.normal(size=(n, 3)).astype(np.float32)
    d[: n // 4] = g.uniform(lo, hi, (n // 4, 3)) - o[: n // 4]
    d[n // 4: n // 4 + 50, 1] = 0.0
    d[n // 4 + 50: n // 4 + 100, 0] = 1e-13
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = g.uniform(0, 1, n).astype(np.float32)
    return (torch.from_numpy(o), torch.from_numpy(d.astype(np.float32)),
            torch.from_numpy(tm))


@pytest.mark.parametrize("mode, name", [("stack", "random"),
                                        ("stack", "mixed"),
                                        ("lane", "spheres"),
                                        ("lane", "chain"),
                                        ("lane", "ground")])
def test_select_references_match_closest_hit(mode, name):
    """Both plain selections pick the all-primitive winner and t bit for
    bit on seeded rays: the stack walk over mixed sphere / quad leaves, the
    lane walk (its octant links) on the all-sphere scene with movers, on a
    chain deeper than a short stack and over a ground sphere of radius
    1e6."""
    scene = {"random": random_scene, "mixed": cs.bvh_mixed_scene,
             "spheres": cs.bvh_sphere_scene, "chain": cs.bvh_chain_scene,
             "ground": ground_scene}[name](pt)
    flat = pt.compile_scene(scene, use_bvh=True)
    rays = _chain_rays() if name == "chain" else _scene_rays(flat, 2000, 3)
    prim = _assert_same_winners(flat, mode, *rays)
    assert (prim >= 0).float().mean() > (0.05 if name == "chain" else 0.1)
    if mode == "stack":
        assert (prim >= flat.sph_center.shape[0]).any()


@pytest.mark.parametrize("name", ["random", "chain", "spheres"])
def test_stack_rows_match_the_tree(name):
    """The stack walk's rows against the tree: each inner row holds its
    children's boxes widened each by its own pad (the boxes the lane walk
    and the tree's nodes carry, bit for bit) and their links (a leaf's
    -(id + 1)); each leaf row its runs; the entry row the root."""
    scene = {"random": random_scene, "chain": cs.bvh_chain_scene,
             "spheres": cs.bvh_sphere_scene}[name](pt)
    flat = pt.compile_scene(scene, use_bvh=True)
    bt = wc.pack_bvh_tables(flat, "stack")
    rows = wc._bvh_stack_rows(bt)
    B = flat.bvh_left.shape[0]
    assert rows.shape == (B + 1, wc.BVH_STACK_COLS)
    box = torch.cat([flat.bvh_bbox_min, flat.bvh_bbox_max], 1)
    wide = torch.cat([box[:, :3] - bt.pad[:, None],
                      box[:, 3:] + bt.pad[:, None]], 1)
    np.testing.assert_array_equal(wide.numpy(), wc._bvh_nodes(bt)[:, :6])
    leaf = flat.bvh_leaf
    inner = torch.nonzero(~leaf).squeeze(1)
    kids = torch.stack([flat.bvh_left[inner], flat.bvh_right[inner]],
                       1).long()
    np.testing.assert_array_equal(rows[inner, :6].numpy(),
                                  wide[kids[:, 0]].numpy())
    np.testing.assert_array_equal(rows[inner, 6:12].numpy(),
                                  wide[kids[:, 1]].numpy())
    links = torch.where(leaf[kids], -(kids + 1), kids)
    np.testing.assert_array_equal(rows[inner, 12:14].long().numpy(),
                                  links.numpy())
    assert not rows[inner, 14:].any()
    lf = torch.nonzero(leaf).squeeze(1)
    np.testing.assert_array_equal(rows[lf, :4].numpy(),
                                  bt.link[lf, 2:6].numpy())
    assert int(rows[lf, 1].sum() + rows[lf, 3].sum()) == int(
        flat.bvh_right[lf].sum())
    np.testing.assert_array_equal(rows[B, :6].numpy(), wide[0].numpy())
    assert int(rows[B, 12]) == (-1 if bool(leaf[0]) else 0)


def _near_first_preorder(flat, octant):
    """The tree's preorder in which each inner node's child nearer along
    its split axis for octant's sign there comes first (the lower box
    centre for a positive sign, the higher for a negative one, the left
    child on a tie), written out node by node; and each node's subtree
    size."""
    left, right = flat.bvh_left.numpy(), flat.bvh_right.numpy()
    leaf, axis = flat.bvh_leaf.numpy(), flat.bvh_axis.numpy()
    mid = (flat.bvh_bbox_min.numpy().astype(np.float64)
           + flat.bvh_bbox_max.numpy().astype(np.float64))
    order, stack = [], [0]
    while stack:
        i = int(stack.pop())
        order.append(i)
        if not leaf[i]:
            a = int(axis[i])
            cl, cr = mid[left[i], a], mid[right[i], a]
            near_left = cl >= cr if (octant >> a) & 1 else cl <= cr
            first, second = ((left[i], right[i]) if near_left
                             else (right[i], left[i]))
            stack += [second, first]
    size = np.ones(left.shape[0], np.int64)
    for i in reversed(order):
        if not leaf[i]:
            size[i] += size[left[i]] + size[right[i]]
    return order, size


OCTANT_SCENES = {"random": random_scene, "chain": cs.bvh_chain_scene,
                 "spheres": cs.bvh_sphere_scene,
                 "bouncing": lambda api: api.builders.bouncing_spheres()}


@pytest.mark.parametrize("name", list(OCTANT_SCENES))
def test_octant_links_visit_the_near_child_first(name):
    """In each of the 8 ray octants the lane walk's links visit every node
    once, in the preorder that enters each inner node's nearer child (along
    its split axis, for the octant's sign there) first: the hit links
    alone walk that preorder, a miss link is the node after the subtree in
    it (B after the last), a leaf's hit link is its miss link, and the
    root's miss link is B. The octants do not all walk one order."""
    flat = pt.compile_scene(OCTANT_SCENES[name](pt), use_bvh=True)
    links = wc.octant_links(flat).numpy()
    B = flat.bvh_left.shape[0]
    assert links.shape == (wc.N_OCTANTS, B, 2) and links.dtype == np.int32
    leaf = flat.bvh_leaf.numpy()
    for octant in range(wc.N_OCTANTS):
        hit, miss = links[octant, :, 0], links[octant, :, 1]
        order, size = _near_first_preorder(flat, octant)
        seen, node = [], 0
        while node < B:
            seen.append(int(node))
            node = hit[node]
        assert seen == order and sorted(seen) == list(range(B))
        at = np.empty(B, np.int64)
        at[order] = np.arange(B)
        nxt = at + size
        want = np.where(nxt < B, np.asarray(order + [B])[np.minimum(nxt, B)],
                        B)
        np.testing.assert_array_equal(miss, want)
        np.testing.assert_array_equal(hit[leaf], miss[leaf])
        assert miss[0] == B
    assert len({links[o].tobytes() for o in range(wc.N_OCTANTS)}) > 1


def test_octant_links_agree_with_skip_links(compiled):
    """ordered_skip_links with the left child first at every node gives
    _skip_links (the JAX package's bvh_hit / bvh_miss) on both scenes'
    trees; and on a three-node tree whose left child lies high along the
    root's split axis, the octant with a positive sign there enters the
    right child first and the one with a negative sign the left."""
    for jf, pf in compiled.values():
        left, right = pf.bvh_left.numpy(), pf.bvh_right.numpy()
        leaf = pf.bvh_leaf.numpy()
        hit, miss = pbvh.ordered_skip_links(
            left, right, leaf, np.ones((1, left.shape[0]), bool))
        h0, m0 = pbvh._skip_links(left, right, leaf)
        np.testing.assert_array_equal(hit[0], h0)
        np.testing.assert_array_equal(miss[0], m0)
        np.testing.assert_array_equal(hit[0], np.asarray(jf.bvh_hit))
        np.testing.assert_array_equal(miss[0], np.asarray(jf.bvh_miss))
    i32 = torch.int32
    tree = pt.compile_scene(cs.bvh_sphere_scene(pt), use_bvh=True)
    tree = dataclasses.replace(
        tree, bvh_left=torch.tensor([1, 0, 1], dtype=i32),
        bvh_right=torch.tensor([2, 1, 1], dtype=i32),
        bvh_leaf=torch.tensor([False, True, True]),
        bvh_axis=torch.tensor([0, 0, 0], dtype=i32),
        bvh_bbox_min=torch.tensor([[0.0, 0, 0], [5, 0, 0], [0, 0, 0]]),
        bvh_bbox_max=torch.tensor([[6.0, 1, 1], [6, 1, 1], [1, 1, 1]]))
    links = wc.octant_links(tree).tolist()
    for octant in range(wc.N_OCTANTS):
        if octant & 1:      # x negative: the left child (high x) first
            assert links[octant] == [[1, 3], [2, 2], [3, 3]]
        else:
            assert links[octant] == [[2, 3], [3, 3], [1, 1]]


def test_lane_select_signed_zero_directions():
    """Axis-aligned rays whose zero components are +0.0 or -0.0 in every
    combination: the sign bit picks the octant (-0.0 negative, as the
    kernel's signbit does), so the same ray walks different links, and the
    winner and t stay the all-primitive closest_hit's and closest_hit_bvh's
    bit for bit."""
    flat = pt.compile_scene(cs.bvh_sphere_scene(pt), use_bvh=True)
    g = np.random.default_rng(8)
    base = g.uniform(-5.0, 5.0, (40, 3)).astype(np.float32)
    o, d = [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            for zeros in range(4):
                u = np.zeros(3, np.float32)
                u[axis] = sign
                others = [k for k in range(3) if k != axis]
                for j, k in enumerate(others):
                    u[k] = -0.0 if (zeros >> j) & 1 else 0.0
                for p in base:
                    q = p.copy()
                    q[axis] = -8.0 * sign
                    o.append(q)
                    d.append(u)
    o = torch.from_numpy(np.stack(o))
    d = torch.from_numpy(np.stack(d))
    tm = torch.zeros(o.shape[0])
    assert sorted(set(wc.ray_octants(d).tolist())) == list(range(8))
    assert bool(torch.signbit(d).any()) and bool((d == 0).any())
    prim = _assert_same_winners(flat, "lane", o, d, tm)
    assert (prim >= 0).float().mean() > 0.2 and bool((prim < 0).any())
    rec = pbvh.closest_hit_bvh(flat, o, d, tm)
    hit = (prim >= 0).numpy()
    np.testing.assert_array_equal(rec.hit.numpy(), hit)
    _, t = wc.bvh_lane_select_reference(wc.pack_bvh_tables(flat, "lane"), o,
                                        d, tm)
    np.testing.assert_array_equal(rec.t.numpy()[hit], t.numpy()[hit])


@pytest.mark.parametrize("name", ["random", "mixed"])
def test_stack_select_reference_matches_closest_hit_bvh(name):
    """The stack walk's plain selection over its rows against the port's
    traversal oracle closest_hit_bvh (which walks the tree's own node
    arrays): the same hits at the same t bit for bit, and the same
    materials, on seeded rays."""
    scene = {"random": random_scene, "mixed": cs.bvh_mixed_scene}[name](pt)
    flat = pt.compile_scene(scene, use_bvh=True)
    o, d, tm = _scene_rays(flat, 1500, 9)
    prim, t = wc.bvh_stack_select_reference(
        wc.pack_bvh_tables(flat, "stack"), o, d, tm)
    rec = pbvh.closest_hit_bvh(flat, o, d, tm)
    hit = prim >= 0
    np.testing.assert_array_equal(rec.hit.numpy(), hit.numpy())
    assert 0.1 < float(hit.float().mean()) < 0.95
    np.testing.assert_array_equal(rec.t.numpy()[hit.numpy()],
                                  t.numpy()[hit.numpy()])
    S = flat.sph_center.shape[0]
    mat = torch.where(prim < S, flat.sph_mat[prim.clamp(0, S - 1)],
                      flat.quad_mat[(prim - S).clamp(
                          0, max(flat.quad_mat.shape[0] - 1, 0))]
                      if flat.quad_mat.shape[0] else 0)
    np.testing.assert_array_equal(rec.mat.numpy()[hit.numpy()],
                                  mat.numpy()[hit.numpy()])


def _chain_rays(n=600, seed=4):
    """Rays from the chain scene's camera, spread about its axis."""
    g = np.random.default_rng(seed)
    o = torch.tensor([[-6.0, 0.5, 0.5]] * n)
    d = torch.from_numpy((g.normal(size=(n, 3)) * [0.2, 0.3, 0.3]
                          + [1.0, 0.0, 0.0]).astype(np.float32))
    return o, d / d.norm(dim=1, keepdim=True), torch.zeros(n)


def test_stack_walk_deeper_than_the_short_stack():
    """A chain of spheres at doubling distances, seen along its axis: the
    tree is deeper than a short stack of 8 entries (what a lane could keep
    in shared memory or registers; the kernel keeps STACK_DEPTH entries in
    local memory), every far child is met and pushed on the way down, and
    the winners and ts stay the all-primitive selection's bit for bit."""
    flat = pt.compile_scene(cs.bvh_chain_scene(pt), use_bvh=True)
    depth = pbvh.tree_depth(flat.bvh_left.numpy(), flat.bvh_right.numpy(),
                            flat.bvh_leaf.numpy())
    assert 8 < depth < pbvh.STACK_DEPTH
    o, d, tm = _chain_rays()
    bt = wc.pack_bvh_tables(flat, "stack")
    prim, t = wc.bvh_stack_select_reference(bt, o, d, tm)
    want_prim, want_t = _winners(flat, o, d, tm)
    np.testing.assert_array_equal(prim.numpy(), want_prim.numpy())
    np.testing.assert_array_equal(t.numpy(), want_t.numpy())
    assert bool((prim >= 0).any()) and bool((prim < 0).any())


def test_select_ties_go_to_the_lowest_id():
    """Six equal spheres at each of two spots, at time 0: a mover of the
    lowest id and five static ones at A, a static one of the lowest id and
    five movers at B. The build splits each group over leaves (the mover's
    swept box moves its centroid), so a ray at time 0 meets equal roots in
    different leaves, and the lower original id wins whichever leaf the
    walk reaches first, in both walks."""
    g = np.random.default_rng(5)
    lam = pt.Lambertian(pt.SolidColor((0.5, 0.5, 0.5)))
    objs = [pt.Sphere(tuple(map(float, g.uniform(-6, 6, 3))), 0.3, lam)
            for _ in range(120)]
    a, b = (-6.5, -6.5, -6.5), (-6.5, 6.5, -6.5)
    objs[3] = pt.Sphere(a, 0.3, lam, center2=(-6.5, -6.0, -6.5))
    objs[5] = pt.Sphere(b, 0.3, lam)
    for k in range(5):
        objs[100 + k] = pt.Sphere(a, 0.3, lam)
        objs[90 + k] = pt.Sphere(b, 0.3, lam, center2=(-6.5, 7.0, -6.5))
    flat = pt.compile_scene(pt.Scene(objects=objs), use_bvh=True)
    leaf_of = {}
    for i in torch.nonzero(flat.bvh_leaf).squeeze(1).tolist():
        off, cnt = int(flat.bvh_left[i]), int(flat.bvh_right[i])
        leaf_of.update({int(p): i for p in flat.bvh_prims[off:off + cnt]})
    assert leaf_of[3] != leaf_of[100]
    n = 400
    o = torch.from_numpy(np.random.default_rng(6).uniform(
        -4, 4, (n, 3)).astype(np.float32))
    target = torch.tensor([list(a)] * (n // 2) + [list(b)] * (n // 2))
    d = target - o
    d = d / d.norm(dim=1, keepdim=True)
    tm = torch.zeros(n)
    for mode in ("stack", "lane"):
        prim = _assert_same_winners(flat, mode, o, d, tm)
        assert (prim[:n // 2] == 3).float().mean() > 0.5
        assert (prim[n // 2:] == 5).float().mean() > 0.5


def ground_scene(api):
    """150 small spheres (past VCHUNK, so the chunk scan keeps its
    VSCAN_BIG largest uncullable) over a ground sphere of radius 1e6, which
    the BVH culls by its nodes' boxes like any other."""
    g = np.random.default_rng(9)
    lam = api.Lambertian(api.SolidColor((0.5, 0.5, 0.5)))
    objs = [api.Sphere(tuple(map(float, g.uniform(-6, 6, 3))), 0.3, lam)
            for _ in range(150)]
    objs.append(api.Sphere((0.0, -1e6 - 7.0, 0.0), 1e6, lam))
    return api.Scene(objects=objs)


# scene, which leaves, the offsets off each face: those of the ground
# sphere's leaf span its roots' float32 error there (about 3 * 2^-24 *
# |oc|^2 / (2 r) = 0.09, past the small spheres' scale of widening)
GRAZING = {
    "spheres": (cs.bvh_sphere_scene, lambda flat, leaves: leaves[::3],
                (-1e-4, -1e-6, 0.0, 1e-6, 1e-4)),
    "ground": (ground_scene, lambda flat, leaves: [
        i for i in leaves if bool((flat.bvh_prims[
            int(flat.bvh_left[i]):int(flat.bvh_left[i])
            + int(flat.bvh_right[i])] == 150).any())],
        (-0.2, -0.1, -0.05, -0.02, 0.0, 0.02, 0.05, 0.1, 0.2))}


@pytest.mark.parametrize("name", GRAZING)
def test_select_grazing_node_box_faces(name):
    """Rays along the faces of the leaves' boxes, tangent to the sphere
    that spans each face, just inside and just outside: the widened boxes
    keep every grazing winner the all-primitive test finds, in both
    walks; also on a ground sphere of radius 1e6, whose grazing roots
    stray farther than the small spheres' widening."""
    make, pick, offsets = GRAZING[name]
    flat = pt.compile_scene(make(pt), use_bvh=True)
    prims = flat.bvh_prims
    o, d = [], []
    for i in pick(flat, torch.nonzero(flat.bvh_leaf).squeeze(1).tolist()):
        off, cnt = int(flat.bvh_left[i]), int(flat.bvh_right[i])
        run = prims[off:off + cnt].long()
        run = run[(flat.sph_cdelta[run] == 0).all(1)]
        if not run.numel():
            continue
        c, r = flat.sph_center[run], flat.sph_radius[run]
        for axis in range(3):
            for side, pick_ in ((-1.0, (c[:, axis] - r).argmin()),
                                (1.0, (c[:, axis] + r).argmax())):
                tip = c[pick_].clone()
                tip[axis] += side * r[pick_]
                for k in range(4):
                    u = torch.zeros(3)
                    ang = k * np.pi / 4
                    u[(axis + 1) % 3], u[(axis + 2) % 3] = (np.cos(ang),
                                                            np.sin(ang))
                    for off_ in offsets:
                        p = tip.clone()
                        p[axis] += side * off_
                        o.append(p - 3.0 * u)
                        d.append(u)
    o, d = torch.stack(o), torch.stack(d)
    tm = torch.zeros(o.shape[0])
    for mode in ("stack", "lane"):
        prim = _assert_same_winners(flat, mode, o, d, tm)
        assert (prim >= 0).any() and (prim < 0).any()


def test_bvh_tables_layout():
    """The walks' buffers: the stack walk's rows (an inner node's two
    children's widened boxes and links, a leaf's runs, the entry row last)
    and the lane walk's node rows (the widened box, the sphere run and
    the 8 octants' [hit, miss] int32 pairs: six float4s), sphere and quad
    rows in leaf order (16-byte aligned), each leaf's runs where its links
    say."""
    flat = pt.compile_scene(cs.bvh_mixed_scene(pt), use_bvh=True)
    bt = wc.pack_bvh_tables(flat, "stack")
    buf, f = wc._bvh_buffer(bt)
    assert f["off_srows"] % 4 == 0 and f["off_qrows"] % 4 == 0
    B = flat.bvh_left.shape[0]
    assert f["n_nodes"] == B + 1
    rows = buf[:f["off_srows"]].reshape(B + 1, wc.BVH_STACK_COLS)
    box = torch.cat([flat.bvh_bbox_min, flat.bvh_bbox_max], 1)
    wide = torch.cat([box[:, :3] - bt.pad[:, None],
                      box[:, 3:] + bt.pad[:, None]], 1)
    assert bt.pad.shape == (B,) and bool((bt.pad > 0.0).all())
    S = flat.sph_center.shape[0]
    srows = buf[f["off_srows"]:f["off_qrows"]].reshape(-1, wc.VROW_COLS)
    qrows = buf[f["off_qrows"]:].reshape(-1, wc.QROW_COLS)

    def link(c):
        return -(c + 1) if flat.bvh_leaf[c] else c

    for i in range(B):
        lk = bt.link[i].long().tolist()
        row = rows[i]
        if not flat.bvh_leaf[i]:
            left, right = int(flat.bvh_left[i]), int(flat.bvh_right[i])
            assert lk[0] == 0 and lk[2:4] == [left, right]
            np.testing.assert_array_equal(row[:6].numpy(), wide[left])
            np.testing.assert_array_equal(row[6:12].numpy(), wide[right])
            assert row[12:].tolist() == [link(left), link(right), 0, 0]
            continue
        off, cnt = int(flat.bvh_left[i]), int(flat.bvh_right[i])
        run = flat.bvh_prims[off:off + cnt].tolist()
        assert row[:4].long().tolist() == lk[2:6]
        assert not row[4:].any()
        got = (srows[lk[2]:lk[2] + lk[3], 7].long().tolist()
               + qrows[lk[4]:lk[4] + lk[5], 16].long().tolist())
        assert lk[0] == 1 and got == run and lk[3] + lk[5] == cnt
        assert all(p < S for p in run[:lk[3]])
    # the entry row: the root's box and link, an empty right child
    np.testing.assert_array_equal(rows[B, :6].numpy(), wide[0])
    np.testing.assert_array_equal(
        rows[B, 6:12].numpy(),
        np.float32([wc.BIG] * 3 + [-wc.BIG] * 3))
    assert rows[B, 12] == link(0)
    sph = pt.compile_scene(cs.bvh_sphere_scene(pt), use_bvh=True)
    lane = wc.pack_bvh_tables(sph, "lane")
    assert lane.qrows.shape[0] == 0
    lbuf, lf = wc._bvh_buffer(lane)
    LB = sph.bvh_left.shape[0]
    assert lf["n_nodes"] == LB and bt.octant is None
    assert lf["off_srows"] == LB * wc.BVH_LANE_COLS
    assert lf["off_srows"] % 4 == 0 and wc.BVH_LANE_COLS % 4 == 0
    nodes = lbuf[:lf["off_srows"]].reshape(LB, wc.BVH_LANE_COLS)
    lbox = torch.cat([sph.bvh_bbox_min, sph.bvh_bbox_max], 1)
    np.testing.assert_array_equal(nodes[:, :3].numpy(),
                                  (lbox[:, :3] - lane.pad[:, None]).numpy())
    np.testing.assert_array_equal(nodes[:, 3:6].numpy(),
                                  (lbox[:, 3:] + lane.pad[:, None]).numpy())
    np.testing.assert_array_equal(lane.link.numpy(),
                                  wc.pack_bvh_tables(sph, "stack").link)
    runs = torch.where(sph.bvh_leaf[:, None], lane.link[:, 2:4], 0.0)
    np.testing.assert_array_equal(nodes[:, 6:8].numpy(), runs.numpy())
    links = nodes[:, 8:].contiguous().view(torch.int32)
    np.testing.assert_array_equal(
        links.reshape(LB, wc.N_OCTANTS, 2).permute(1, 0, 2).numpy(),
        lane.octant.numpy())
    np.testing.assert_array_equal(
        lbuf[lf["off_srows"]:].reshape(-1, wc.VROW_COLS).numpy(),
        lane.srows.numpy())
    with pytest.raises(ValueError, match="spheres only"):
        wc.pack_bvh_tables(flat, "lane")
    with pytest.raises(ValueError, match="use_bvh"):
        wc.pack_bvh_tables(pt.compile_scene(cs.bvh_mixed_scene(pt)), "stack")


@pytest.fixture(scope="module")
def mixed_render():
    """The mixed scene at depth 4 (test_pallas.py:132): the JAX oracle's
    -b render (its _render_pass through closest_hit_bvh), and the port's
    (JAX flat, port flat, port camera, pass arguments)."""
    scene = cs.bvh_mixed_scene(rt)
    jf = rt.compile_scene(scene, use_bvh=True)
    jc = jcam.derive(scene.camera)
    w, h = jcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=2, max_depth=4, n_samples=4,
              sky_gradient=False)
    img_j = np.asarray(jax_render_pass(jf, jc, jnp.uint32(3), jnp.int32(0),
                                       tile_rows=h, **kw))
    pf = pt.compile_scene(cs.bvh_mixed_scene(pt), use_bvh=True)
    pc = camera_from_numpy(camera_to_numpy(jc), device="cpu")
    return img_j, pf, pc, kw


def test_plain_bvh_render_matches_jax(mixed_render):
    """The port's plain -b render (through closest_hit_bvh) against the
    JAX oracle's under test_pallas.py's rule, and against its own render
    without the BVH under the same rule."""
    img_j, pf, pc, kw = mixed_render
    h = kw["height"]
    img_b = prender._render_pass(pf, pc, 3, 0, tile_rows=h, **kw).numpy()
    assert img_b.shape == img_j.shape and img_j.mean() > 0.01
    assert_close(img_b, img_j)
    img_a = prender._render_pass(wc.all_primitive(pf), pc, 3, 0,
                                 tile_rows=h, **kw).numpy()
    assert_close(img_b, img_a)


@pytest.fixture(scope="module")
def gate_scenes():
    """(name, JAX flat, port flat) of the gate cases, compiled with -b."""
    out = []
    for name, make in (("cornell", lambda api: api.builders.cornell_box()),
                       ("bouncing", lambda api:
                        api.builders.bouncing_spheres()),
                       ("mixed", cs.bvh_mixed_scene),
                       ("grid15625", lambda api: cs.grid_scene(api, 25))):
        out.append((name, rt.compile_scene(make(rt), use_bvh=True),
                    pt.compile_scene(make(pt), use_bvh=True)))
    return out


@pytest.mark.parametrize("env", list(ENVS))
def test_modes_and_gates_match_jax(env, gate_scenes, monkeypatch):
    """kernel_mode, kernel_gate_reason and hard_slots_gate_reason against
    the JAX package's _kernel_modes, pallas_gate_reason and
    pallas_hard_slots_gate_reason under each setting of the knobs. Reasons
    about the TPU's scalar memory are left out: the port has no such
    budget, so it admits those scenes."""
    monkeypatch.delenv("RTX_BVH_STACK", raising=False)
    monkeypatch.delenv("RTX_LANE_BVH", raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    names = ("unrolled", "lane", "stack", "vscan")
    for name, jf, pf in gate_scenes:
        want = names[wp._kernel_modes(jf).index(True)]
        assert wc.kernel_mode(pf)[0] == want, (name, env)
        for got, jax_reason, hard in (
                (wc.kernel_gate_reason(pf), wp.pallas_gate_reason(jf),
                 False),
                (wc.hard_slots_gate_reason(pf, 4),
                 wp.pallas_hard_slots_gate_reason(jf, 4), True)):
            if jax_reason is not None and "scalar memory" in jax_reason:
                # the port takes the scene; its hard slots get the reason
                # the JAX gate gives past its scalar-memory check
                jax_reason = (wc._BVH_SLOTS_REASON
                              if hard and want in wc.BVH_MODES else None)
            assert (got is None) == (jax_reason is None), (
                name, env, got, jax_reason)
            if got is not None and want in wc.BVH_MODES:
                assert got == jax_reason
    if env == "lane":
        # the grid past MAX_PRIMS_SCAN takes the lane walk; the mixed
        # scene (quads) stays on the chunk scan
        modes = {name: wc.kernel_mode(pf)[0] for name, _, pf in gate_scenes}
        assert modes == {"cornell": "unrolled", "bouncing": "lane",
                         "mixed": "vscan", "grid15625": "lane"}


def test_past_the_scan_bound_needs_use_bvh():
    """A scene past MAX_PRIMS_SCAN: without use_bvh the gate refuses it,
    naming -b, as JAX's does; with it the gate admits it, as JAX's does
    (the chunk scan by default)."""
    def spheres(api):
        lam = api.Lambertian(api.SolidColor((0.5, 0.5, 0.5)))
        return api.Scene(objects=[
            api.Sphere((3.0 * (i % 128), 3.0 * (i // 128), 0), 1.0, lam)
            for i in range(wc.MAX_PRIMS_SCAN + 1)])
    pf = pt.compile_scene(spheres(pt), use_bvh=True)
    jf = rt.compile_scene(spheres(rt), use_bvh=True)
    assert wc.kernel_gate_reason(pf) is None
    assert wp.pallas_gate_reason(jf) is None
    assert wc.kernel_mode(pf) == ("vscan", False)
    reason = wc.kernel_gate_reason(wc.all_primitive(pf))
    assert "MAX_PRIMS_SCAN" in reason and "-b" in reason
    assert wp.pallas_gate_reason(jf.replace(use_bvh=False)) is not None


def test_training_tier_in_a_bvh_mode(monkeypatch):
    """On a stack-mode scene (the faked card: the choice only, no pass
    runs), tex_color takes the grad kernels (K11's instance) and the hard
    families take the adjoint, as the JAX package's tier rule does."""
    monkeypatch.setenv("RTX_BVH_STACK", "1")
    scene = cs.bvh_mixed_scene(pt)
    flat = pt.compile_scene(scene, use_bvh=True)
    assert wc.kernel_mode(flat)[0] == "stack"
    assert wc.grad_gate_reason(flat, 0, want_tex=True) is None
    assert "not linearizable" in wc.grad_gate_reason(flat, 1)
    assert train.use_adjoint(flat, wc.hard_param_slots(flat, {"mat_fuzz"}),
                             False)
    kw = dict(width=8, height=8, n_strata=1, max_depth=2)
    cam = pcam.derive(scene.camera)
    applied = []
    with monkeypatch.context() as m:
        m.setattr(FlatScene, "device",
                  property(lambda self: torch.device("cuda", 0)))
        render = train.make_kernel_render(flat, **kw)
    with monkeypatch.context() as m:
        m.setattr(train._KernelRender, "apply",
                  lambda *a: applied.append(a[3]) or torch.zeros(8, 8, 3))
        render({"tex_color": flat.tex_color}, cam, 0)
        render({"tex_color": flat.tex_color, "mat_fuzz": flat.mat_fuzz},
               cam, 0)
        render({"sph_radius": flat.sph_radius}, cam, 0)
    assert [(r.names, r.adjoint) for r in applied] == [
        (("tex_color",), False), (("tex_color", "mat_fuzz"), True),
        (("sph_radius",), True)]


def test_cli_bvh_on_the_cpu(tmp_path, monkeypatch):
    """`-b --device cpu` renders through the BVH and writes the PPM of
    render(use_bvh=True, device="cpu")."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--scene", "bouncing_spheres", "--width", "16",
                     "--samples", "1", "--depth", "3", "-b", "--device",
                     "cpu", "--output", "b"]) == 0
    scene = pt.builders.bouncing_spheres()
    scene.camera.image_width = 16
    scene.camera.samples_per_pixel = 1
    scene.camera.max_depth = 3
    img = pt.render(scene, device="cpu", use_bvh=True)
    pt.write_ppm(str(tmp_path / "want.ppm"), img)
    assert (tmp_path / "output" / "b.ppm").read_bytes() == \
        (tmp_path / "want.ppm").read_bytes()
    assert float(img.mean()) > 0.05
