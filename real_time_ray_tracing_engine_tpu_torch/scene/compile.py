"""Scene compiler: schema graph -> FlatScene SoA tables (torch tensors).

The same compiler as the JAX package's scene/compile.py, emitting the same
tables (checked table by table and through golden_json by the tests). It is
the analogue of the reference's host->device scene conversion
(HittableConverter.cuh:37-240, MaterialConverter.cuh:21-123,
TextureConverter.cuh:19-89 + CudaSceneContext tables): walks the object graph,
dedups materials/textures into index tables, and — unlike the reference, which
keeps Translate/RotateY as runtime wrapper nodes (Translate.cpp:17-31,
RotateY.cpp:41-76) — *bakes* affine instance transforms directly into
primitive parameters at compile time. Spheres and parallelograms are closed
under rotation+translation, so the traced hit kernels never see an instance
node at all.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

from ..utils.profiling import spanned
from . import schema as S
from .flat import (FlatScene, MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC,
                   MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC, TEX_SOLID, TEX_CHECKER,
                   TEX_NOISE)

MIN_MED_QUADS = 6   # table floor (a box boundary); grows to the scene max


class _Tables:
    """Dedup is by *content* (row value), not Python object identity as in
    the reference's pointer-keyed converter maps (MaterialConverter.cuh:26):
    JSON scenes cannot express object sharing, and content dedup makes
    in-memory and round-tripped scenes compile to identical tables."""

    def __init__(self):
        self.tex_rows = []      # dicts
        self.mat_rows = []
        # NOTE: no id()-keyed fast path — temporaries (e.g. the SolidColor
        # wrapped around a Metal albedo) die between add_* calls and CPython
        # reuses their addresses, which silently merges distinct materials.
        self.tex_keys = {}      # content key -> index
        self.mat_keys = {}
        self.spheres = []       # dicts
        self.quads = []
        self.mediums = []

    def _intern(self, row, rows, keys) -> int:
        key = json.dumps(row, sort_keys=True)
        if key in keys:
            return keys[key]
        rows.append(row)
        keys[key] = len(rows) - 1
        return keys[key]

    # -------------------------------------------------------- textures
    def add_texture(self, t) -> int:
        if isinstance(t, S.SolidColor):
            row = dict(type=TEX_SOLID, color=tuple(t.albedo), scale=1.0,
                       even=0, odd=0)
        elif isinstance(t, S.Noise):
            row = dict(type=TEX_NOISE, color=(0, 0, 0), scale=float(t.scale),
                       even=0, odd=0)
        elif isinstance(t, S.Checker):
            even = self.add_texture(t.even)
            odd = self.add_texture(t.odd)
            row = dict(type=TEX_CHECKER, color=(0, 0, 0), scale=float(t.scale),
                       even=even, odd=odd)
        else:
            raise TypeError(f"unknown texture {t!r}")
        return self._intern(row, self.tex_rows, self.tex_keys)

    # -------------------------------------------------------- materials
    def add_material(self, m) -> int:
        if isinstance(m, S.Lambertian):
            row = dict(type=MAT_LAMBERTIAN, tex=self.add_texture(m.texture),
                       fuzz=0.0, ior=1.0)
        elif isinstance(m, S.Metal):
            tex = self.add_texture(S.SolidColor(tuple(m.albedo)))
            row = dict(type=MAT_METAL, tex=tex, fuzz=float(m.fuzz), ior=1.0)
        elif isinstance(m, S.Dielectric):
            tex = self.add_texture(S.SolidColor((1.0, 1.0, 1.0)))
            row = dict(type=MAT_DIELECTRIC, tex=tex, fuzz=0.0,
                       ior=float(m.refraction_index))
        elif isinstance(m, S.DiffuseLight):
            row = dict(type=MAT_DIFFUSE_LIGHT, tex=self.add_texture(m.texture),
                       fuzz=0.0, ior=1.0)
        elif isinstance(m, S.Isotropic):
            row = dict(type=MAT_ISOTROPIC, tex=self.add_texture(m.texture),
                       fuzz=0.0, ior=1.0)
        else:
            raise TypeError(f"unknown material {m!r}")
        return self._intern(row, self.mat_rows, self.mat_keys)


def _rot_y(deg: float) -> np.ndarray:
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def _quad_row(corner, u, v, mat):
    corner = np.asarray(corner, np.float64)
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    n = np.cross(u, v)
    nlen = np.linalg.norm(n)
    normal = n / max(nlen, 1e-12)
    return dict(corner=corner, u=u, v=v, normal=normal,
                d=float(np.dot(normal, corner)), w=n / max(np.dot(n, n), 1e-12),
                area=float(nlen), mat=mat)


def _box_quads(a, b):
    """6 parallelogram faces of the AABB [min(a,b), max(a,b)]
    (reference: PlaneUtility.hpp:11-39)."""
    lo = np.minimum(np.asarray(a, np.float64), np.asarray(b, np.float64))
    hi = np.maximum(np.asarray(a, np.float64), np.asarray(b, np.float64))
    dx = np.array([hi[0] - lo[0], 0, 0])
    dy = np.array([0, hi[1] - lo[1], 0])
    dz = np.array([0, 0, hi[2] - lo[2]])
    return [
        (np.array([lo[0], lo[1], hi[2]]), dx, dy),   # front
        (np.array([hi[0], lo[1], hi[2]]), -dz, dy),  # right
        (np.array([hi[0], lo[1], lo[2]]), -dx, dy),  # back
        (np.array([lo[0], lo[1], lo[2]]), dz, dy),   # left
        (np.array([lo[0], hi[1], hi[2]]), dx, -dz),  # top
        (np.array([lo[0], lo[1], lo[2]]), dx, dz),   # bottom
    ]


def _walk(obj, R, t, tab: _Tables, out_spheres, out_quads):
    """Collect transformed primitives from an object subtree.

    R (3,3), t (3,): accumulated world = R @ p + t."""
    if isinstance(obj, S.Sphere):
        c0 = R @ np.asarray(obj.center, np.float64) + t
        c2 = obj.center2
        delta = (R @ (np.asarray(c2, np.float64) - np.asarray(obj.center))
                 if c2 is not None else np.zeros(3))
        out_spheres.append(dict(center=c0, cdelta=delta,
                                radius=float(obj.radius),
                                mat=tab.add_material(obj.material)))
    elif isinstance(obj, S.Quad):
        m = tab.add_material(obj.material)
        out_quads.append(_quad_row(R @ np.asarray(obj.corner, np.float64) + t,
                                   R @ np.asarray(obj.u, np.float64),
                                   R @ np.asarray(obj.v, np.float64), m))
    elif isinstance(obj, S.Box):
        m = tab.add_material(obj.material)
        for corner, u, v in _box_quads(obj.a, obj.b):
            out_quads.append(_quad_row(R @ corner + t, R @ u, R @ v, m))
    elif isinstance(obj, S.Group):
        for child in obj.children:
            _walk(child, R, t, tab, out_spheres, out_quads)
    elif isinstance(obj, S.Translate):
        off = np.asarray(obj.offset, np.float64)
        _walk(obj.child, R, t + R @ off, tab, out_spheres, out_quads)
    elif isinstance(obj, S.RotateY):
        _walk(obj.child, R @ _rot_y(obj.angle_degrees), t, tab,
              out_spheres, out_quads)
    elif isinstance(obj, S.ConstantMedium):
        b_spheres, b_quads = [], []
        _walk(obj.boundary, R, t, tab, b_spheres, b_quads)
        # arbitrary boundaries: N spheres + N quads per medium (both tables
        # grow to the scene's max). The span is the FIRST TWO crossings of
        # the whole boundary, exactly the reference's double-hit semantics
        # (ConstantMedium.cpp:25-96: hit over UNIVERSE, then hit over
        # (t1+eps, inf)) — which is also how the reference treats composite
        # boundaries, since HittableList::hit returns the closest crossing.
        iso = tab.add_material(S.Isotropic(obj.texture))
        tab.mediums.append(dict(neg_inv_density=-1.0 / float(obj.density),
                                mat=iso, spheres=b_spheres, quads=b_quads))
    else:
        raise TypeError(f"unknown scene object {obj!r}")


def _checker_depth(tex_rows) -> int:
    """Longest checker chain in the texture DAG (depth 0 = no checkers).
    Children always precede parents in the interned table (add_texture
    interns children first), so one forward pass suffices."""
    depth = [0] * len(tex_rows)
    for i, t in enumerate(tex_rows):
        if t["type"] == TEX_CHECKER:
            depth[i] = 1 + max(depth[t["even"]], depth[t["odd"]])
    return max(depth, default=0)


def _f32(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _i32(x):
    return torch.from_numpy(np.asarray(x, np.int32))


def _bool(x):
    return torch.from_numpy(np.asarray(x, bool))


@spanned("rt.compile")
def compile_scene(scene: S.Scene, use_bvh: bool = False,
                  device="cpu") -> FlatScene:
    """Compile `scene` into FlatScene tables on `device`; use_bvh=True also
    builds the SAH BVH over the active primitives (ops/bvh.py::build_bvh),
    as the JAX package's compile_scene does."""
    tab = _Tables()
    I, z = np.eye(3), np.zeros(3)

    for obj in scene.objects:
        _walk(obj, I, z, tab, tab.spheres, tab.quads)

    n_world_sph, n_world_quad = len(tab.spheres), len(tab.quads)

    # Lights compile into extra *inactive* prim rows: they are sampled by the
    # MIS light PDF (pdf_value/random) but excluded from world intersection —
    # the world copy of the same geometry is a separate active row, mirroring
    # the reference's separate `lights` HittableList (src/main.cpp:58-66).
    light_sph, light_quad = [], []
    for obj in scene.lights:
        _walk(obj, I, z, tab, light_sph, light_quad)
    spheres = tab.spheres + light_sph
    quads = tab.quads + light_quad
    n_sph, n_quad = len(spheres), len(quads)
    light_prims = ([n_world_sph + i for i in range(len(light_sph))]
                   + [n_sph + n_world_quad + i for i in range(len(light_quad))])

    sph_pad = max(n_sph, 1)
    quad_pad = max(n_quad, 1)
    l_pad = max(len(light_prims), 1)
    m_pad = max(len(tab.mediums), 1)
    if not tab.mat_rows:
        tab.mat_rows.append(dict(type=MAT_LAMBERTIAN, tex=0, fuzz=0.0, ior=1.0))
    if not tab.tex_rows:
        tab.tex_rows.append(dict(type=TEX_SOLID, color=(0.5, 0.5, 0.5),
                                 scale=1.0, even=0, odd=0))

    def pad_rows(rows, n, template):
        return rows + [template] * (n - len(rows))

    zero_sph = dict(center=z, cdelta=z, radius=0.0, mat=0)
    spheres_p = pad_rows(spheres, sph_pad, zero_sph)
    zero_quad = _quad_row(z, np.array([1e-6, 0, 0]), np.array([0, 1e-6, 0]), 0)
    quads_p = pad_rows(quads, quad_pad, zero_quad)

    # medium boundary tables (ragged: N spheres + N quads per medium, padded
    # to the scene-wide max)
    med = tab.mediums
    ms_pad = max([1] + [len(m["spheres"]) for m in med])
    med_sph_center = np.zeros((m_pad, ms_pad, 3))
    med_sph_radius = np.zeros((m_pad, ms_pad))
    mq_pad = max([MIN_MED_QUADS] + [len(m["quads"]) for m in med])
    med_qc = np.zeros((m_pad, mq_pad, 3))
    med_qu = np.zeros((m_pad, mq_pad, 3))
    med_qv = np.zeros((m_pad, mq_pad, 3))
    med_qn = np.tile(np.array([0.0, 0.0, 1.0]), (m_pad, mq_pad, 1))
    med_qd = np.zeros((m_pad, mq_pad))
    med_qw = np.zeros((m_pad, mq_pad, 3))
    med_qact = np.zeros((m_pad, mq_pad), bool)
    med_nid = np.full(m_pad, -1e9)
    med_mat = np.zeros(m_pad, np.int64)
    for i, m in enumerate(med):
        med_nid[i] = m["neg_inv_density"]
        med_mat[i] = m["mat"]
        for j, sp in enumerate(m["spheres"]):
            med_sph_center[i, j] = sp["center"]
            med_sph_radius[i, j] = sp["radius"]
        for j, q in enumerate(m["quads"]):
            med_qc[i, j] = q["corner"]
            med_qu[i, j] = q["u"]
            med_qv[i, j] = q["v"]
            med_qn[i, j] = q["normal"]
            med_qd[i, j] = q["d"]
            med_qw[i, j] = q["w"]
            med_qact[i, j] = True

    flat = FlatScene(
        sph_center=_f32([s["center"] for s in spheres_p]),
        sph_cdelta=_f32([s["cdelta"] for s in spheres_p]),
        sph_radius=_f32([s["radius"] for s in spheres_p]),
        sph_mat=_i32([s["mat"] for s in spheres_p]),
        sph_active=_bool(
            [i < n_world_sph for i in range(sph_pad)]),
        quad_corner=_f32([q["corner"] for q in quads_p]),
        quad_u=_f32([q["u"] for q in quads_p]),
        quad_v=_f32([q["v"] for q in quads_p]),
        quad_normal=_f32([q["normal"] for q in quads_p]),
        quad_d=_f32([q["d"] for q in quads_p]),
        quad_w=_f32([q["w"] for q in quads_p]),
        quad_area=_f32([q["area"] for q in quads_p]),
        quad_mat=_i32([q["mat"] for q in quads_p]),
        quad_active=_bool(
            [i < n_world_quad for i in range(quad_pad)]),
        light_prim=_i32(light_prims + [0] * (l_pad - len(light_prims))),
        light_active=_bool(
            [i < len(light_prims) for i in range(l_pad)]),
        med_neg_inv_density=_f32(med_nid),
        med_mat=_i32(med_mat),
        med_sph_center=_f32(med_sph_center),
        med_sph_radius=_f32(med_sph_radius),
        med_quad_corner=_f32(med_qc),
        med_quad_u=_f32(med_qu),
        med_quad_v=_f32(med_qv),
        med_quad_normal=_f32(med_qn),
        med_quad_d=_f32(med_qd),
        med_quad_w=_f32(med_qw),
        med_quad_active=_bool(med_qact),
        med_active=_bool([i < len(med) for i in range(m_pad)]),
        mat_type=_i32([m["type"] for m in tab.mat_rows]),
        mat_tex=_i32([m["tex"] for m in tab.mat_rows]),
        mat_fuzz=_f32([m["fuzz"] for m in tab.mat_rows]),
        mat_ior=_f32([m["ior"] for m in tab.mat_rows]),
        tex_type=_i32([t["type"] for t in tab.tex_rows]),
        tex_color=_f32([t["color"] for t in tab.tex_rows]),
        tex_scale=_f32([t["scale"] for t in tab.tex_rows]),
        tex_child_even=_i32([t["even"] for t in tab.tex_rows]),
        tex_child_odd=_i32([t["odd"] for t in tab.tex_rows]),
        perlin_seed=torch.tensor(scene.perlin_seed & 0xFFFFFFFF,
                                 dtype=torch.uint32),
        bvh_bbox_min=_f32(np.zeros((1, 3))),
        bvh_bbox_max=_f32(np.zeros((1, 3))),
        bvh_left=_i32([0]),
        bvh_right=_i32([0]),
        bvh_axis=_i32([0]),
        bvh_leaf=_bool([True]),
        bvh_prims=_i32([0]),
        bvh_leaf_sph=_i32([0]),
        bvh_hit=_i32([1]),
        bvh_miss=_i32([1]),
        n_spheres=n_sph,
        n_quads=n_quad,
        n_lights=len(light_prims),
        n_mediums=len(med),
        use_bvh=False,
        has_noise=any(t["type"] == TEX_NOISE for t in tab.tex_rows),
        has_motion=any(np.any(np.asarray(s["cdelta"], np.float32) != 0)
                       for s in spheres_p),
        n_sph_active_static=sum(
            1 for i, s in enumerate(spheres_p)
            if i < n_world_sph and s["radius"] > 0
            and not np.any(np.asarray(s["cdelta"], np.float32) != 0)),
        checker_depth=_checker_depth(tab.tex_rows),
        tex_struct=tuple((int(t["type"]), int(t["even"]), int(t["odd"]))
                         for t in tab.tex_rows),
    )
    if use_bvh:
        from ..ops.bvh import build_bvh
        flat = build_bvh(flat)
    return flat.to(device)


def golden_json(flat: FlatScene) -> str:
    """Serialize the flattened scene for golden-file validation — the
    analogue of the reference's debug JSON dumps (Camera.cpp:75-149,
    logs/cuda_*_debug.json). Byte-identical to the JAX package's
    golden_json for the same scene."""
    d = {}
    for name in flat.__dataclass_fields__:
        v = getattr(flat, name)
        if isinstance(v, (int, bool)):
            d[name] = v
        else:
            arr = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v))
            d[name] = dict(shape=list(arr.shape), dtype=str(arr.dtype),
                           data=np.round(arr.astype(np.float64), 6).tolist()
                           if arr.dtype.kind == "f" else arr.tolist())
    return json.dumps(d, indent=1, sort_keys=True)
