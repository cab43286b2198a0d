"""Scene JSON -> flat SoA tables: frozen copies of the port's
scene/schema.py (the dataclasses and the JSON reader), scene/flat.py (the
table layout) and scene/compile.py (the compiler: content-deduplicated
material and texture tables, instance transforms baked into primitive
parameters, light rows as inactive primitive copies, padded medium
boundaries). The BVH tables are left out: the reference selects over every
primitive."""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

Vec = tuple[float, float, float]


# ---------------------------------------------------------------- textures
@dataclass
class SolidColor:
    """Constant color (reference: SolidColorTexture.cpp:8-10)."""
    albedo: Vec
    kind: str = "solid"


@dataclass
class Checker:
    """3D checker on floor(p/scale) parity (reference: CheckerTexture.cpp:14-55).

    Children may be any texture; the compiled evaluator supports one level of
    nesting (solid/noise children), which covers every reference scene.
    """
    scale: float
    even: "Texture"
    odd: "Texture"
    kind: str = "checker"


@dataclass
class Noise:
    """Marble texture 0.5*(1+sin(scale*z + 10*turb(p))) (NoiseTexture.cpp:8-33)."""
    scale: float
    kind: str = "noise"


Texture = SolidColor | Checker | Noise


# ---------------------------------------------------------------- materials
@dataclass
class Lambertian:
    """Cosine-weighted diffuse (reference: LambertianMaterial.cpp)."""
    texture: Texture
    kind: str = "lambertian"


@dataclass
class Metal:
    """Mirror + fuzz, skip_pdf (reference: MetalMaterial.cpp)."""
    albedo: Vec
    fuzz: float = 0.0
    kind: str = "metal"


@dataclass
class Dielectric:
    """Snell + Schlick glass, skip_pdf (reference: DielectricMaterial.cpp)."""
    refraction_index: float
    kind: str = "dielectric"


@dataclass
class DiffuseLight:
    """Front-face-only emitter, never scatters (DiffuseLightMaterial.cpp:12-23)."""
    texture: Texture
    kind: str = "diffuse_light"


@dataclass
class Isotropic:
    """Uniform-sphere phase function (IsotropicMaterial.cpp:12-31)."""
    texture: Texture
    kind: str = "isotropic"


Material = Lambertian | Metal | Dielectric | DiffuseLight | Isotropic


# ---------------------------------------------------------------- objects
@dataclass
class Sphere:
    """Static or moving sphere; center2 enables motion blur over t in [0,1)
    (reference: Sphere.cpp:15-23 stores center as a Ray)."""
    center: Vec
    radius: float
    material: Material
    center2: Optional[Vec] = None
    kind: str = "sphere"


@dataclass
class Quad:
    """Parallelogram corner + a*u + b*v, a,b in [0,1] (reference: Plane.cpp)."""
    corner: Vec
    u: Vec
    v: Vec
    material: Material
    kind: str = "quad"


@dataclass
class Box:
    """Axis-aligned box -> 6 quads (reference: PlaneUtility.hpp:11-39 make_box)."""
    a: Vec
    b: Vec
    material: Material
    kind: str = "box"


@dataclass
class Translate:
    """Instance translation, baked into primitive params at compile time
    (reference: Translate.cpp offsets the ray at trace time instead)."""
    child: "SceneObject"
    offset: Vec
    kind: str = "translate"


@dataclass
class RotateY:
    """Y-axis rotation instance, baked at compile time (reference: RotateY.cpp)."""
    child: "SceneObject"
    angle_degrees: float
    kind: str = "rotate_y"


@dataclass
class Group:
    """A list of child objects treated as one (the reference's HittableList
    used compositionally, HittableList.cpp:26-42) — e.g. a multi-part
    constant-medium boundary."""
    children: list = field(default_factory=list)
    kind: str = "group"


@dataclass
class ConstantMedium:
    """Constant-density participating medium inside a convex boundary
    (reference: ConstantMedium.cpp:25-96). The boundary does not itself render;
    it only bounds exponential free-flight sampling."""
    boundary: "SceneObject"
    density: float
    texture: Texture
    kind: str = "constant_medium"


SceneObject = Sphere | Quad | Box | Translate | RotateY | Group \
    | ConstantMedium


# ---------------------------------------------------------------- camera
@dataclass
class CameraConfig:
    """Union of the reference's CLIOptions + CameraConfig
    (src/input/CLI.hpp:8-51, src/core/camera/CameraConfig.hpp:9-63)."""
    aspect_ratio: float = 1.0
    image_width: int = 600
    samples_per_pixel: int = 100
    max_depth: int = 50
    vfov: float = 40.0
    lookfrom: Vec = (0.0, 0.0, 0.0)
    lookat: Vec = (0.0, 0.0, -1.0)
    vup: Vec = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_dist: float = 10.0
    background: Vec = (0.0, 0.0, 0.0)
    # Sky-gradient background (RTiOW-style lerp white->blue) instead of the
    # constant background color. Off for all reference-parity scenes.
    sky_gradient: bool = False


@dataclass
class Scene:
    objects: list = field(default_factory=list)
    lights: list = field(default_factory=list)  # subset of objects, MIS targets
    camera: CameraConfig = field(default_factory=CameraConfig)
    name: str = "scene"
    perlin_seed: int = 0


# ---------------------------------------------------------------- JSON I/O
_TEXTURES = {"solid": SolidColor, "checker": Checker, "noise": Noise}
_MATERIALS = {"lambertian": Lambertian, "metal": Metal, "dielectric": Dielectric,
              "diffuse_light": DiffuseLight, "isotropic": Isotropic}
_OBJECTS = {"sphere": Sphere, "quad": Quad, "box": Box, "translate": Translate,
            "rotate_y": RotateY, "group": Group,
            "constant_medium": ConstantMedium}


def _from_dict(d, registry):
    cls = registry[d["kind"]]
    kwargs = dict(d)
    kwargs.pop("kind")
    for k, v in kwargs.items():
        if isinstance(v, dict) and "kind" in v:
            if v["kind"] in _TEXTURES:
                kwargs[k] = _from_dict(v, _TEXTURES)
            elif v["kind"] in _MATERIALS:
                kwargs[k] = _from_dict(v, _MATERIALS)
            else:
                kwargs[k] = _from_dict(v, _OBJECTS)
        elif isinstance(v, list) and v and isinstance(v[0], dict) \
                and "kind" in v[0]:
            kwargs[k] = [_from_dict(c, _OBJECTS) for c in v]
    return cls(**kwargs)


def scene_from_json(text: str) -> Scene:
    d = json.loads(text)
    cam = CameraConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d["camera"].items()})
    objs = [_from_dict(o, _OBJECTS) for o in d["objects"]]
    # Lights duplicate object descriptions; identity with world objects is not
    # required (the reference also re-lists lights: src/main.cpp:58-66).
    lights = [_from_dict(o, _OBJECTS) for o in d.get("lights", [])]
    return Scene(objects=objs, lights=lights, camera=cam,
                 name=d.get("name", "scene"), perlin_seed=d.get("perlin_seed", 0))


# material type codes
MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC = range(5)
# texture type codes
TEX_SOLID, TEX_CHECKER, TEX_NOISE = range(3)

# the static (non-tensor) fields, in declaration order
STATIC_FIELDS = ("n_spheres", "n_quads", "n_lights", "n_mediums",
                 "has_noise", "has_motion", "n_sph_active_static",
                 "checker_depth", "tex_struct")


@dataclass
class FlatScene:
    # --- spheres (S rows; padded rows have radius 0 and active False)
    sph_center: torch.Tensor      # (S, 3) center at t=0
    sph_cdelta: torch.Tensor      # (S, 3) center(t) = center + t * cdelta
    sph_radius: torch.Tensor      # (S,)
    sph_mat: torch.Tensor         # (S,) int32
    sph_active: torch.Tensor      # (S,) bool

    # --- quads (Q rows), derived fields precomputed (reference Plane.cpp:6-26)
    quad_corner: torch.Tensor     # (Q, 3)
    quad_u: torch.Tensor          # (Q, 3)
    quad_v: torch.Tensor          # (Q, 3)
    quad_normal: torch.Tensor     # (Q, 3) unit
    quad_d: torch.Tensor          # (Q,)  plane offset: dot(normal, corner)
    quad_w: torch.Tensor          # (Q, 3) n/(n.n) for inside test
    quad_area: torch.Tensor       # (Q,)
    quad_mat: torch.Tensor        # (Q,) int32
    quad_active: torch.Tensor     # (Q,) bool

    # --- lights (L rows of unified prim ids; MIS targets)
    light_prim: torch.Tensor      # (L,) int32
    light_active: torch.Tensor    # (L,) bool

    # --- constant mediums (M rows; ragged boundaries of MS spheres + MQ
    # quads, padded to the scene max; ConstantMedium.cpp:25-96)
    med_neg_inv_density: torch.Tensor  # (M,)
    med_mat: torch.Tensor              # (M,) int32 (isotropic material)
    med_sph_center: torch.Tensor       # (M, MS, 3)
    med_sph_radius: torch.Tensor       # (M, MS)  0 => inactive slot
    med_quad_corner: torch.Tensor      # (M, MQ, 3)
    med_quad_u: torch.Tensor           # (M, MQ, 3)
    med_quad_v: torch.Tensor           # (M, MQ, 3)
    med_quad_normal: torch.Tensor      # (M, MQ, 3)
    med_quad_d: torch.Tensor           # (M, MQ)
    med_quad_w: torch.Tensor           # (M, MQ, 3)
    med_quad_active: torch.Tensor      # (M, MQ) bool
    med_active: torch.Tensor           # (M,) bool

    # --- materials
    mat_type: torch.Tensor        # (NM,) int32
    mat_tex: torch.Tensor         # (NM,) int32 texture index
    mat_fuzz: torch.Tensor        # (NM,)
    mat_ior: torch.Tensor         # (NM,)

    # --- textures
    tex_type: torch.Tensor        # (NT,) int32
    tex_color: torch.Tensor       # (NT, 3)
    tex_scale: torch.Tensor       # (NT,) checker or noise scale
    tex_child_even: torch.Tensor  # (NT,) int32
    tex_child_odd: torch.Tensor   # (NT,) int32

    # --- hash-noise seed (utils/perlin.py derives lattice gradients from it)
    perlin_seed: torch.Tensor     # () uint32

    # --- static metadata
    n_spheres: int = field(default=0)
    n_quads: int = field(default=0)
    n_lights: int = field(default=0)
    n_mediums: int = field(default=0)
    has_noise: bool = field(default=True)
    has_motion: bool = field(default=True)
    n_sph_active_static: int = field(default=0)
    checker_depth: int = field(default=1)
    # one (type, even_child, odd_child) int triple per texture row
    tex_struct: tuple = field(default=())

    @property
    def n_prims(self) -> int:
        return self.n_spheres + self.n_quads

    @property
    def device(self) -> torch.device:
        return self.sph_center.device

    def tensor_fields(self) -> list[str]:
        return [f.name for f in dataclasses.fields(self)
                if f.name not in STATIC_FIELDS]

    def to(self, device=None, dtype=None) -> "FlatScene":
        """A copy with every table on `device`, its float tables in `dtype`
        (the control's bfloat16)."""
        moved = {}
        for name in self.tensor_fields():
            v = getattr(self, name)
            if dtype is not None and v.is_floating_point():
                v = v.to(dtype)
            moved[name] = v.to(device) if device is not None else v
        return dataclasses.replace(self, **moved)


def load_scene(path: str) -> Scene:
    with open(path) as f:
        return scene_from_json(f.read())


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
        if isinstance(t, SolidColor):
            row = dict(type=TEX_SOLID, color=tuple(t.albedo), scale=1.0,
                       even=0, odd=0)
        elif isinstance(t, Noise):
            row = dict(type=TEX_NOISE, color=(0, 0, 0), scale=float(t.scale),
                       even=0, odd=0)
        elif isinstance(t, Checker):
            even = self.add_texture(t.even)
            odd = self.add_texture(t.odd)
            row = dict(type=TEX_CHECKER, color=(0, 0, 0), scale=float(t.scale),
                       even=even, odd=odd)
        else:
            raise TypeError(f"unknown texture {t!r}")
        return self._intern(row, self.tex_rows, self.tex_keys)

    # -------------------------------------------------------- materials
    def add_material(self, m) -> int:
        if isinstance(m, Lambertian):
            row = dict(type=MAT_LAMBERTIAN, tex=self.add_texture(m.texture),
                       fuzz=0.0, ior=1.0)
        elif isinstance(m, Metal):
            tex = self.add_texture(SolidColor(tuple(m.albedo)))
            row = dict(type=MAT_METAL, tex=tex, fuzz=float(m.fuzz), ior=1.0)
        elif isinstance(m, Dielectric):
            tex = self.add_texture(SolidColor((1.0, 1.0, 1.0)))
            row = dict(type=MAT_DIELECTRIC, tex=tex, fuzz=0.0,
                       ior=float(m.refraction_index))
        elif isinstance(m, DiffuseLight):
            row = dict(type=MAT_DIFFUSE_LIGHT, tex=self.add_texture(m.texture),
                       fuzz=0.0, ior=1.0)
        elif isinstance(m, Isotropic):
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
    if isinstance(obj, Sphere):
        c0 = R @ np.asarray(obj.center, np.float64) + t
        c2 = obj.center2
        delta = (R @ (np.asarray(c2, np.float64) - np.asarray(obj.center))
                 if c2 is not None else np.zeros(3))
        out_spheres.append(dict(center=c0, cdelta=delta,
                                radius=float(obj.radius),
                                mat=tab.add_material(obj.material)))
    elif isinstance(obj, Quad):
        m = tab.add_material(obj.material)
        out_quads.append(_quad_row(R @ np.asarray(obj.corner, np.float64) + t,
                                   R @ np.asarray(obj.u, np.float64),
                                   R @ np.asarray(obj.v, np.float64), m))
    elif isinstance(obj, Box):
        m = tab.add_material(obj.material)
        for corner, u, v in _box_quads(obj.a, obj.b):
            out_quads.append(_quad_row(R @ corner + t, R @ u, R @ v, m))
    elif isinstance(obj, Group):
        for child in obj.children:
            _walk(child, R, t, tab, out_spheres, out_quads)
    elif isinstance(obj, Translate):
        off = np.asarray(obj.offset, np.float64)
        _walk(obj.child, R, t + R @ off, tab, out_spheres, out_quads)
    elif isinstance(obj, RotateY):
        _walk(obj.child, R @ _rot_y(obj.angle_degrees), t, tab,
              out_spheres, out_quads)
    elif isinstance(obj, ConstantMedium):
        b_spheres, b_quads = [], []
        _walk(obj.boundary, R, t, tab, b_spheres, b_quads)
        # arbitrary boundaries: N spheres + N quads per medium (both tables
        # grow to the scene's max). The span is the FIRST TWO crossings of
        # the whole boundary, exactly the reference's double-hit semantics
        # (ConstantMedium.cpp:25-96: hit over UNIVERSE, then hit over
        # (t1+eps, inf)) — which is also how the reference treats composite
        # boundaries, since HittableList::hit returns the closest crossing.
        iso = tab.add_material(Isotropic(obj.texture))
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


def compile_scene(scene: Scene, device="cpu") -> FlatScene:
    """Compile `scene` into FlatScene tables on `device`."""
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
        n_spheres=n_sph,
        n_quads=n_quad,
        n_lights=len(light_prims),
        n_mediums=len(med),
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
    return flat.to(device)


