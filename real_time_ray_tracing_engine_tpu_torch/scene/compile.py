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


def _json_key(v):
    """The dedup key of a row value, which two values share exactly when
    json.dumps writes them alike: a float as it is, or by its JSON text
    where == would merge what JSON keeps apart (0.0 and -0.0) or keep apart
    what JSON merges (NaNs); an int or a bool tagged with its kind, so that
    1, 1.0 and True stay three values; a tuple or list by its items;
    anything else by its JSON text (raising where json.dumps does)."""
    if isinstance(v, float):
        return v if v == v and v != 0.0 else float.__repr__(v)
    if isinstance(v, (tuple, list)):
        return tuple(map(_json_key, v))
    if isinstance(v, bool):
        return (bool, v)
    if isinstance(v, int):
        return (int, int(v))
    return json.dumps(v)


class _Tables:
    """Dedup is by *content* (row value), not Python object identity as in
    the reference's pointer-keyed converter maps (MaterialConverter.cuh:26):
    JSON scenes cannot express object sharing, and content dedup makes
    in-memory and round-tripped scenes compile to identical tables. Two
    rows are one where json.dumps writes them alike; each row's key holds
    what varies within its kind (_json_key)."""

    def __init__(self):
        self.tex_rows = []      # (type, color, scale, even, odd)
        self.mat_rows = []      # (type, tex, fuzz, ior)
        # NOTE: no id()-keyed fast path — temporaries (e.g. the SolidColor
        # wrapped around a Metal albedo) die between add_* calls and CPython
        # reuses their addresses, which silently merges distinct materials.
        self.tex_keys = {}      # content key -> index
        self.mat_keys = {}
        self.spheres = []       # (sphere, R, t, radius, material), _walk
        self.quads = []
        self.mediums = []

    @staticmethod
    def _intern(row, rows, keys, key) -> int:
        """The index of `row` in `rows`, appended the first time its
        content `key` is met."""
        i = keys.get(key)
        if i is None:
            i = keys[key] = len(rows)
            rows.append(row)
        return i

    # -------------------------------------------------------- textures
    def _solid(self, color: tuple) -> int:
        return self._intern((TEX_SOLID, color, 1.0, 0, 0), self.tex_rows,
                            self.tex_keys, (TEX_SOLID, _json_key(color)))

    def add_texture(self, t) -> int:
        if isinstance(t, S.SolidColor):
            return self._solid(tuple(t.albedo))
        if isinstance(t, S.Noise):
            row = (TEX_NOISE, (0, 0, 0), float(t.scale), 0, 0)
        elif isinstance(t, S.Checker):
            even = self.add_texture(t.even)
            odd = self.add_texture(t.odd)
            row = (TEX_CHECKER, (0, 0, 0), float(t.scale), even, odd)
        else:
            raise TypeError(f"unknown texture {t!r}")
        kind, _, scale, even, odd = row
        return self._intern(row, self.tex_rows, self.tex_keys,
                            (kind, _json_key(scale), even, odd))

    # -------------------------------------------------------- materials
    def _material(self, kind: int, tex: int, fuzz: float = 0.0,
                  ior: float = 1.0) -> int:
        return self._intern((kind, tex, fuzz, ior), self.mat_rows,
                            self.mat_keys,
                            (kind, tex, _json_key(fuzz), _json_key(ior)))

    def add_material(self, m) -> int:
        if isinstance(m, S.Lambertian):
            return self._material(MAT_LAMBERTIAN, self.add_texture(m.texture))
        if isinstance(m, S.Metal):
            return self._material(MAT_METAL, self._solid(tuple(m.albedo)),
                                  fuzz=float(m.fuzz))
        if isinstance(m, S.Dielectric):
            return self._material(MAT_DIELECTRIC,
                                  self._solid((1.0, 1.0, 1.0)),
                                  ior=float(m.refraction_index))
        if isinstance(m, S.DiffuseLight):
            return self._material(MAT_DIFFUSE_LIGHT,
                                  self.add_texture(m.texture))
        if isinstance(m, S.Isotropic):
            return self._material(MAT_ISOTROPIC, self.add_texture(m.texture))
        raise TypeError(f"unknown material {m!r}")


def _rot_y(deg: float) -> np.ndarray:
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def _cross(u, v) -> np.ndarray:
    """np.cross of two float64 3-vectors: its products and differences,
    rounded one by one as its ufuncs round them, without its per-call
    overhead."""
    (a0, a1, a2), (b0, b1, b2) = u.tolist(), v.tolist()
    return np.array([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                     a0 * b1 - a1 * b0])


def _quad_row(corner, u, v, mat):
    corner = np.asarray(corner, np.float64)
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    n = _cross(u, v)
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


_EYE = np.eye(3)   # the walk's starting rotation (read only)


def _walk(obj, R, t, tab: _Tables, out_spheres, out_quads):
    """Collect transformed primitives from an object subtree.

    R (3,3), t (3,): accumulated world = R @ p + t. A sphere is collected
    as (sphere, R, t, radius, material row), transformed by _sphere_rows."""
    if isinstance(obj, S.Sphere):
        out_spheres.append((obj, R, t, float(obj.radius),
                            tab.add_material(obj.material)))
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


def _sphere_rows(spheres, n_pad: int = 0):
    """(center (n, 3), cdelta (n, 3), radius (n,)) float64 of spheres
    collected by _walk, n the larger of their count and n_pad (the rows past
    them zero): center R @ c + t, cdelta R @ (center2 - c), zero for a
    static sphere. The spheres under no rotation (R is _EYE) are
    transformed in one matrix product: the identity's products and sums are
    exact, so each row is the bits its own R @ c gives."""
    n = max(len(spheres), n_pad)
    center, cdelta, radius = np.zeros((n, 3)), np.zeros((n, 3)), np.zeros(n)
    radius[:len(spheres)] = [r for _, _, _, r, _ in spheres]
    eye = [k for k, (_, R, _, _, _) in enumerate(spheres) if R is _EYE]
    if eye:
        c = np.array([spheres[k][0].center for k in eye], np.float64)
        ts = [spheres[k][2] for k in eye]
        t = ts[0] if all(x is ts[0] for x in ts) else np.array(ts)
        center[eye] = c @ _EYE + t
        moving = [k for k in eye if spheres[k][0].center2 is not None]
        if moving:
            c2 = np.array([spheres[k][0].center2 for k in moving], np.float64)
            c1 = np.array([spheres[k][0].center for k in moving], np.float64)
            cdelta[moving] = (c2 - c1) @ _EYE
    for k, (obj, R, t, _, _) in enumerate(spheres):
        if R is not _EYE:
            center[k] = R @ np.asarray(obj.center, np.float64) + t
            if obj.center2 is not None:
                cdelta[k] = R @ (np.asarray(obj.center2, np.float64)
                                 - np.asarray(obj.center))
    return center, cdelta, radius


def _checker_depth(tex_rows) -> int:
    """Longest checker chain in the texture DAG (depth 0 = no checkers).
    Children always precede parents in the interned table (add_texture
    interns children first), so one forward pass suffices."""
    depth = [0] * len(tex_rows)
    for i, (kind, _, _, even, odd) in enumerate(tex_rows):
        if kind == TEX_CHECKER:
            depth[i] = 1 + max(depth[even], depth[odd])
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
    I, z = _EYE, np.zeros(3)

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
        tab.mat_rows.append((MAT_LAMBERTIAN, 0, 0.0, 1.0))
    if not tab.tex_rows:
        tab.tex_rows.append((TEX_SOLID, (0.5, 0.5, 0.5), 1.0, 0, 0))
    mat_type, mat_tex, mat_fuzz, mat_ior = zip(*tab.mat_rows)
    tex_type, tex_color, tex_scale, tex_even, tex_odd = zip(*tab.tex_rows)

    def pad_rows(rows, n, template):
        return rows + [template] * (n - len(rows))

    # spheres padded with zero rows (radius 0, material 0) to sph_pad
    center, cdelta, radius = _sphere_rows(spheres, sph_pad)
    sph_mat = [m for _, _, _, _, m in spheres] + [0] * (sph_pad - n_sph)
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
        if m["spheres"]:
            b_center, _, b_radius = _sphere_rows(m["spheres"])
            med_sph_center[i, :len(b_radius)] = b_center
            med_sph_radius[i, :len(b_radius)] = b_radius
        for j, q in enumerate(m["quads"]):
            med_qc[i, j] = q["corner"]
            med_qu[i, j] = q["u"]
            med_qv[i, j] = q["v"]
            med_qn[i, j] = q["normal"]
            med_qd[i, j] = q["d"]
            med_qw[i, j] = q["w"]
            med_qact[i, j] = True

    cdelta = cdelta.astype(np.float32)
    moving = (cdelta != 0).any(1)
    flat = FlatScene(
        sph_center=_f32(center),
        sph_cdelta=torch.from_numpy(cdelta),
        sph_radius=_f32(radius),
        sph_mat=_i32(sph_mat),
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
        mat_type=_i32(mat_type),
        mat_tex=_i32(mat_tex),
        mat_fuzz=_f32(mat_fuzz),
        mat_ior=_f32(mat_ior),
        tex_type=_i32(tex_type),
        tex_color=_f32(tex_color),
        tex_scale=_f32(tex_scale),
        tex_child_even=_i32(tex_even),
        tex_child_odd=_i32(tex_odd),
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
        has_noise=TEX_NOISE in tex_type,
        has_motion=bool(moving.any()),
        n_sph_active_static=int(
            ((radius[:n_world_sph] > 0) & ~moving[:n_world_sph]).sum()),
        checker_depth=_checker_depth(tab.tex_rows),
        tex_struct=tuple(zip(tex_type, tex_even, tex_odd)),
    )
    if use_bvh:
        from ..ops.bvh import build_bvh
        flat = build_bvh(flat)
    return flat if torch.device(device).type == "cpu" else flat.to(device)


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
