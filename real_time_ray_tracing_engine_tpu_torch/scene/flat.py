"""FlatScene: the device-resident SoA scene representation, as torch tensors.

Same tables as the JAX package's scene/flat.py (the reference's CUDA
tagged-union scene, CudaHittable Hittable.cuh:37-49, flattened into
fixed-shape float32/int32 rows): identical field names, shapes and dtypes,
so a scene compiled by either package can be fed to the other
(scene/convert.py) and checked table by table. The dataclass holds tensors
on one device; `.to(device)` moves every table at once.

Unified primitive ids: prim p in [0, n_spheres) is sphere p; p in
[n_spheres, n_spheres + n_quads) is quad p - n_spheres. Lights reference
prims by unified id.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

# material type codes
MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC = range(5)
# texture type codes
TEX_SOLID, TEX_CHECKER, TEX_NOISE = range(3)

# the static (non-tensor) fields, in declaration order
STATIC_FIELDS = ("n_spheres", "n_quads", "n_lights", "n_mediums", "use_bvh",
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

    # --- flat BVH over unified prims (ops/bvh.py::build_bvh; a one-node
    # dummy unless compiled with use_bvh)
    bvh_bbox_min: torch.Tensor    # (B, 3)
    bvh_bbox_max: torch.Tensor    # (B, 3)
    bvh_left: torch.Tensor        # (B,) int32
    bvh_right: torch.Tensor       # (B,) int32
    bvh_axis: torch.Tensor        # (B,) int32
    bvh_leaf: torch.Tensor        # (B,) bool
    bvh_prims: torch.Tensor       # (P,) int32
    bvh_leaf_sph: torch.Tensor = None   # (B,) int32
    bvh_hit: torch.Tensor = None        # (B,) int32
    bvh_miss: torch.Tensor = None       # (B,) int32

    # --- static metadata (see the JAX package's scene/flat.py for each)
    n_spheres: int = field(default=0)
    n_quads: int = field(default=0)
    n_lights: int = field(default=0)
    n_mediums: int = field(default=0)
    use_bvh: bool = field(default=False)
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

    def to(self, device) -> "FlatScene":
        """A copy with every table on `device`."""
        moved = {name: getattr(self, name).to(device)
                 for name in self.tensor_fields()
                 if getattr(self, name) is not None}
        return dataclasses.replace(self, **moved)
