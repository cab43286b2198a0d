"""Flat BVH: the host-side SAH build and the plain traversal oracle.

Port of the JAX package's ops/bvh.py. The reference builds a pointer BVH
with SAH (16 sampled splits an axis, leaves of at most 4, traverse and
intersect costs 1.0 / 2.0, BVHNode.cpp:215-254, BVHNode.hpp:167-170) and
flattens it into a depth-first node array traversed iteratively with a
64-entry stack, near child first by the ray's sign (BVHNode.cpp:385-446).
That flat form is the model here:

  - `build_bvh`: the SAH build over the active primitives at scene-compile
    time, by the C++ builder (csrc/bvh_builder.cpp, compiled with g++ at
    first use into build/bvh/, bound with ctypes) where a C++ compiler
    exists, else by the numpy builder below (the same constants and rule;
    the two give different trees, as the JAX package's two builders do).
    Which one ran is printed once a process. Leaves are segregated spheres
    first (`_segregate_leaves`), and the stackless skip links
    (`_skip_links`) ride beside the tree for the lane BVH (K12). The tree's
    depth is checked against STACK_DEPTH: a deeper tree raises.
  - `closest_hit_bvh`: the JAX package's traversal oracle, a per-ray stack
    walk vectorized over the ray batch on torch tensors of any device; the
    plain engine (models/render.py::_render_pass) takes it on a use_bvh
    scene, as the JAX package's does. The kernels' plain versions (the lane
    wavefront of ops/wavefront_cuda.py) stay the all-primitive selection.
"""
from __future__ import annotations

import ctypes
import dataclasses
import sys

import numpy as np
import torch

from ..utils.native import BUILD, CSRC, shared_library
from ..utils.vecmath import T_MIN, BIG
from ..scene.flat import FlatScene
from .intersect import HitRecord, quad_hits, shade_prim, sphere_roots

MAX_LEAF = 4          # reference BVHNode.hpp:167
SAH_SAMPLES = 16      # reference BVHNode.hpp:168
COST_TRAVERSE = 1.0   # reference BVHNode.hpp:169
COST_INTERSECT = 2.0  # reference BVHNode.hpp:170
STACK_DEPTH = 64      # reference BVHNode.cpp:398
BBOX_PAD = 1e-4       # reference AABB.cpp:167-176 pad_to_minimums

_SOURCE = CSRC / "bvh_builder.cpp"
BUILD_DIR = BUILD / "bvh"

_announced = set()


def _announce(builder: str) -> None:
    """Print, once a process, which builder built the BVH."""
    if builder not in _announced:
        _announced.add(builder)
        print(f"[INFO] BVH build: {builder}", file=sys.stderr, flush=True)


def _prim_bboxes(scene: FlatScene):
    """World-space AABBs of the unified prims (float64, host) and their
    active mask; thin boxes (an axis-aligned quad's) padded by BBOX_PAD."""
    sc = scene.sph_center.detach().cpu().numpy().astype(np.float64)
    sd = scene.sph_cdelta.detach().cpu().numpy().astype(np.float64)
    sr = scene.sph_radius.detach().cpu().numpy().astype(np.float64)[:, None]
    s_min = np.minimum(sc - sr, sc + sd - sr)
    s_max = np.maximum(sc + sr, sc + sd + sr)

    qc = scene.quad_corner.detach().cpu().numpy().astype(np.float64)
    qu = scene.quad_u.detach().cpu().numpy().astype(np.float64)
    qv = scene.quad_v.detach().cpu().numpy().astype(np.float64)
    corners = np.stack([qc, qc + qu, qc + qv, qc + qu + qv], axis=1)
    q_min = corners.min(axis=1)
    q_max = corners.max(axis=1)

    bb_min = np.concatenate([s_min, q_min], axis=0)
    bb_max = np.concatenate([s_max, q_max], axis=0)
    thin = (bb_max - bb_min) < BBOX_PAD
    bb_min = np.where(thin, bb_min - BBOX_PAD / 2, bb_min)
    bb_max = np.where(thin, bb_max + BBOX_PAD / 2, bb_max)

    active = np.concatenate([scene.sph_active.cpu().numpy(),
                             scene.quad_active.cpu().numpy()])
    return bb_min, bb_max, active


def _sah_split(ids, bb_min, bb_max, centroids):
    """Best (axis, threshold) by sampled SAH, or None (BVHNode.cpp:168-254)."""
    c = centroids[ids]
    c_lo, c_hi = c.min(axis=0), c.max(axis=0)
    span = bb_max[ids].max(axis=0) - bb_min[ids].min(axis=0)
    area = 2.0 * (span[0] * span[1] + span[1] * span[2] + span[2] * span[0])
    if area <= 0.0:
        return None
    best = (None, np.inf)
    n = len(ids)

    def _area(sel):
        lo = bb_min[sel].min(axis=0)
        hi = bb_max[sel].max(axis=0)
        e = hi - lo
        return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    for axis in range(3):
        if c_hi[axis] - c_lo[axis] < 1e-12:
            continue
        for k in range(1, SAH_SAMPLES + 1):
            thr = (c_lo[axis]
                   + (c_hi[axis] - c_lo[axis]) * k / (SAH_SAMPLES + 1))
            left = c[:, axis] < thr
            nl = int(left.sum())
            if nl == 0 or nl == n:
                continue
            cost = (COST_TRAVERSE
                    + _area(ids[left]) / area * nl * COST_INTERSECT
                    + _area(ids[~left]) / area * (n - nl) * COST_INTERSECT)
            if cost < best[1]:
                best = ((axis, thr), cost)
    if best[0] is not None and best[1] < n * COST_INTERSECT:
        return best[0]
    return None


def _build_numpy(bb_min, bb_max, active):
    """The numpy SAH builder: (node min, node max, left, right, axis, leaf,
    prims) with the C++ builder's semantics (the JAX package's fallback)."""
    centroids = 0.5 * (bb_min + bb_max)
    nodes = []   # (bmin, bmax, left | offset, right | count, axis, leaf)
    order = []

    def rec(ids) -> int:
        node_id = len(nodes)
        nodes.append(None)
        lo = bb_min[ids].min(axis=0) if len(ids) else np.zeros(3)
        hi = bb_max[ids].max(axis=0) if len(ids) else np.zeros(3)
        if len(ids) <= MAX_LEAF:
            nodes[node_id] = (lo, hi, len(order), len(ids), 0, True)
            order.extend(ids.tolist())
            return node_id
        split = _sah_split(ids, bb_min, bb_max, centroids)
        if split is None:
            # spatial-median fallback on the longest axis (BVHNode.cpp:60-77)
            axis = int(np.argmax(hi - lo))
            srt = ids[np.argsort(centroids[ids, axis], kind="stable")]
            l_ids, r_ids = srt[: len(srt) // 2], srt[len(srt) // 2:]
        else:
            axis, thr = split
            left = centroids[ids, axis] < thr
            l_ids, r_ids = ids[left], ids[~left]
        li = rec(l_ids)
        ri = rec(r_ids)
        nodes[node_id] = (lo, hi, li, ri, axis, False)
        return node_id

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(np.nonzero(active)[0].astype(np.int64))
    finally:
        sys.setrecursionlimit(old)
    return (np.stack([x[0] for x in nodes]).astype(np.float32),
            np.stack([x[1] for x in nodes]).astype(np.float32),
            np.array([x[2] for x in nodes], np.int32),
            np.array([x[3] for x in nodes], np.int32),
            np.array([x[4] for x in nodes], np.int32),
            np.array([x[5] for x in nodes], bool),
            np.array(order if order else [0], np.int32))


def _native_library():
    """The C++ builder's ctypes handle, compiled at first use into
    BUILD_DIR (utils/native.py); None where no C++ compiler exists or the
    build fails."""
    path = shared_library(_SOURCE, BUILD_DIR, "libbvh.so")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.rtx_build_bvh.restype = ctypes.c_int32
    lib.rtx_build_bvh.argtypes = [
        f32, f32, u8, ctypes.c_int32,              # bb_min, bb_max, active, n
        f32, f32, i32, i32, i32, u8,               # node arrays
        i32, ctypes.POINTER(ctypes.c_int32),       # prims, n_prims_out
        ctypes.c_int32]                            # max_nodes
    return lib, path


def _build_native(bb_min, bb_max, active):
    """The SAH build by the C++ builder (csrc/bvh_builder.cpp); None where
    it is not available."""
    found = _native_library()
    if found is None:
        return None
    lib, path = found
    n = bb_min.shape[0]
    max_nodes = max(2 * n + 1, 8)
    node_min = np.zeros((max_nodes, 3), np.float32)
    node_max = np.zeros((max_nodes, 3), np.float32)
    left = np.zeros(max_nodes, np.int32)
    right = np.zeros(max_nodes, np.int32)
    axis = np.zeros(max_nodes, np.int32)
    leaf = np.zeros(max_nodes, np.uint8)
    prims = np.zeros(max(n, 1), np.int32)
    n_prims_out = ctypes.c_int32(0)
    n_nodes = lib.rtx_build_bvh(
        np.ascontiguousarray(bb_min, np.float32),
        np.ascontiguousarray(bb_max, np.float32),
        np.ascontiguousarray(active, np.uint8), n,
        node_min, node_max, left, right, axis, leaf, prims,
        ctypes.byref(n_prims_out), max_nodes)
    if n_nodes < 0:
        raise RuntimeError(f"the C++ BVH builder ({path}) ran out of nodes")
    k = int(n_nodes)
    order = prims[:max(int(n_prims_out.value), 1)]
    _announce(f"C++ SAH builder ({path})")
    return (node_min[:k], node_max[:k], left[:k], right[:k], axis[:k],
            leaf[:k].astype(bool), np.ascontiguousarray(order))


def _skip_links(left, right, leaf):
    """Stackless depth-first skip links (the classic GPU escape pointers):
    hit = the left child for an inner node, the continuation for a leaf;
    miss = the next subtree of the continuation chain; n = done."""
    n = left.shape[0]
    hit = np.zeros(n, np.int32)
    miss = np.zeros(n, np.int32)
    stack = [(0, n)]
    while stack:
        i, cont = stack.pop()
        miss[i] = cont
        if leaf[i]:
            hit[i] = cont
        else:
            hit[i] = left[i]
            stack.append((left[i], right[i]))   # left's continuation = right
            stack.append((right[i], cont))
    return hit, miss


def ordered_skip_links(left, right, leaf, left_first):
    """_skip_links with each inner node's children in an order of its own,
    for n orders at once: left_first (n, B) bool says, per order, whether
    node i's left child comes first. Returns (hit, miss), each (n, B)
    int32: an inner node's hit link is its first child, a leaf's its miss
    link; a first child's miss link is its sibling, a second child's its
    parent's; the root's is B (done). Built level by level from the root,
    vectorised over the nodes of a level and the orders (at most the
    tree's depth + 1 levels, which check_depth bounds)."""
    left, right, leaf = (np.asarray(x) for x in (left, right, leaf))
    left_first = np.asarray(left_first, bool)
    n, B = left_first.shape
    first = np.where(left_first, left[None], right[None]).astype(np.int64)
    second = np.where(left_first, right[None], left[None]).astype(np.int64)
    hit = np.zeros((n, B), np.int64)
    miss = np.zeros((n, B), np.int64)
    miss[:, 0] = B
    rows = np.arange(n)[:, None]
    level = np.zeros(1, np.int64)
    while level.size:
        inner = level[~leaf[level]]
        if inner.size == 0:
            break
        f, s = first[:, inner], second[:, inner]
        hit[:, inner] = f
        miss[rows, f] = s
        miss[rows, s] = miss[:, inner]
        level = np.concatenate([left[inner], right[inner]])
    hit[:, leaf] = miss[:, leaf]
    return hit.astype(np.int32), miss.astype(np.int32)


def _segregate_leaves(n_sph, left, right, leaf, prims):
    """Reorder each leaf's prim run spheres first (in place) and return the
    per-node sphere count."""
    leaf_sph = np.zeros(left.shape[0], np.int32)
    for i in np.nonzero(leaf)[0]:
        off, cnt = int(left[i]), int(right[i])
        run = prims[off:off + cnt]
        sph = run[run < n_sph]
        prims[off:off + cnt] = np.concatenate([sph, run[run >= n_sph]])
        leaf_sph[i] = len(sph)
    return leaf_sph


def tree_depth(left, right, leaf) -> int:
    """Edges on the longest root-to-leaf path of a flat tree."""
    left, right, leaf = (np.asarray(x) for x in (left, right, leaf))
    depth, level = 0, np.zeros(1, np.int64)
    while True:
        inner = level[~leaf[level]]
        if inner.size == 0:
            return depth
        level = np.concatenate([left[inner], right[inner]])
        depth += 1


def check_depth(left, right, leaf) -> int:
    """The tree's depth; raises if the traversal stack (the stack BVH's,
    K11's, and closest_hit_bvh's) could overflow: a walk that pops a node
    and pushes its two children holds at most depth + 1 entries."""
    depth = tree_depth(left, right, leaf)
    if depth + 1 > STACK_DEPTH:
        raise ValueError(f"the BVH is {depth} levels deep: its traversal "
                         f"needs a {depth + 1}-entry stack, over "
                         f"STACK_DEPTH={STACK_DEPTH}")
    return depth


def build_bvh(scene: FlatScene) -> FlatScene:
    """Build the flat BVH over the active prims; returns the scene with its
    bvh_* tables (on the scene's device) and use_bvh=True. The C++ builder
    where a C++ compiler exists, else the numpy builder."""
    bb_min, bb_max, active = _prim_bboxes(scene)
    n_sph = scene.sph_center.shape[0]
    built = _build_native(bb_min.astype(np.float32),
                          bb_max.astype(np.float32), active)
    if built is None:
        _announce("numpy SAH builder (no C++ compiler: the tree differs "
                  "from the C++ builder's)")
        built = _build_numpy(bb_min, bb_max, active)
    n_min, n_max, left, right, axis, leaf, prims = built
    check_depth(left, right, leaf)
    prims = np.ascontiguousarray(prims)
    leaf_sph = _segregate_leaves(n_sph, left, right, leaf, prims)
    hit, miss = _skip_links(left, right, leaf)
    dev = scene.device

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return dataclasses.replace(
        scene, bvh_bbox_min=t(n_min), bvh_bbox_max=t(n_max),
        bvh_left=t(left), bvh_right=t(right), bvh_axis=t(axis),
        bvh_leaf=t(leaf), bvh_prims=t(prims), bvh_leaf_sph=t(leaf_sph),
        bvh_hit=t(hit), bvh_miss=t(miss), use_bvh=True)


# ------------------------------------------------------------- traversal
def closest_hit_bvh(scene: FlatScene, org, dr, tm, t_min=T_MIN,
                    t_max=BIG) -> HitRecord:
    """Iterative stack traversal vectorized over the ray batch (the JAX
    package's oracle; model: hit_flattened BVHNode.cpp:385-446): each ray
    pops a node, tests its box against [t_min, best t], tests a leaf's
    prims (a strictly closer root wins) or pushes an inner node's children,
    the near one (by the ray's sign on the split axis) on top. The stack
    holds STACK_DEPTH entries, which build_bvh's depth check guarantees;
    an overflow would raise an index error here, not clamp."""
    n = org.shape[0]
    dev = org.device
    rows = torch.arange(n, device=dev)
    eps = 1e-12
    inv_dr = 1.0 / torch.where(torch.abs(dr) < eps,
                               torch.where(dr < 0, -eps, eps), dr)
    left_t = scene.bvh_left.to(torch.int64)
    right_t = scene.bvh_right.to(torch.int64)
    axis_t = scene.bvh_axis.to(torch.int64)
    prims = scene.bvh_prims.to(torch.int64)
    n_p = prims.shape[0]
    n_s, n_q = scene.sph_center.shape[0], scene.quad_corner.shape[0]
    slots = torch.arange(MAX_LEAF, device=dev)

    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)    # the root pushed
    best_t = torch.full((n,), t_max, dtype=org.dtype, device=dev)
    best_p = torch.zeros(n, dtype=torch.int64, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    while bool((sp > 0).any()):
        live = sp > 0
        sp_pop = torch.clamp(sp - 1, min=0)
        node = stack[rows, sp_pop]

        # slab test against the node's box (AABB.cpp:62-165)
        t0 = (scene.bvh_bbox_min[node] - org) * inv_dr
        t1 = (scene.bvh_bbox_max[node] - org) * inv_dr
        t_near = torch.clamp(torch.minimum(t0, t1).max(-1).values, min=t_min)
        t_far = torch.minimum(torch.maximum(t0, t1).min(-1).values, best_t)
        box_hit = live & (t_near <= t_far)

        leaf = scene.bvh_leaf[node]
        off, cnt = left_t[node], right_t[node]
        # the leaf's slots in one evaluation against the best t so far, by
        # the all-primitive test's own sphere_roots / quad_hits, then taken
        # in slot order: a root at or past the running best t is never taken
        # either way, so this is the JAX oracle's slot-by-slot result
        pk = prims[torch.clamp(off[:, None] + slots, 0, n_p - 1)]
        si = torch.clamp(pk, 0, n_s - 1)
        qi = torch.clamp(pk - n_s, 0, n_q - 1)
        o1, d1, bt1 = org[:, None], dr[:, None], best_t[:, None]
        ts = torch.where(
            pk < n_s,
            sphere_roots(scene.sph_center[si], scene.sph_cdelta[si],
                         scene.sph_radius[si], scene.sph_active[si], o1, d1,
                         tm[:, None], t_min, bt1),
            quad_hits(scene.quad_corner[qi], scene.quad_u[qi],
                      scene.quad_v[qi], scene.quad_normal[qi],
                      scene.quad_d[qi], scene.quad_w[qi],
                      scene.quad_active[qi], o1, d1, t_min, bt1))
        for k in range(MAX_LEAF):
            take = box_hit & leaf & (k < cnt) & (ts[:, k] < best_t)
            best_t = torch.where(take, ts[:, k], best_t)
            best_p = torch.where(take, pk[:, k], best_p)
            found = found | take

        go_left = dr.gather(1, axis_t[node][:, None])[:, 0] >= 0.0
        near = torch.where(go_left, left_t[node], right_t[node])
        far = torch.where(go_left, right_t[node], left_t[node])
        push = box_hit & ~leaf
        # far first, so that near is popped first
        stack[rows, sp_pop] = torch.where(push, far, stack[rows, sp_pop])
        sp1 = torch.where(push, sp_pop + 1, sp_pop)
        stack[rows, sp1] = torch.where(push, near, stack[rows, sp1])
        sp = torch.where(live, torch.where(push, sp1 + 1, sp1), sp)

    ts_safe = torch.where(found, best_t, 1.0)
    point, normal, front, uu, vv, mat = shade_prim(scene, best_p, org, dr, tm,
                                                   ts_safe)
    return HitRecord(hit=found, t=torch.where(found, best_t, BIG),
                     point=point, normal=normal, front_face=front, mat=mat,
                     u=uu, v=vv)
