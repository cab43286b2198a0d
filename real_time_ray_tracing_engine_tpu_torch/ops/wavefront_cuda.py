"""Path-tracing megakernel (CUDA) and its plain torch version.

Port of the JAX package's ops/wavefront_pallas.py Pallas kernel in its
variants: the unrolled forward (K1), its capped/resume variant under the
compacted driver (K2), the forward-mode gradient pass with tex_color
weight planes (K3) and hard-parameter tangent bundles (K4) under the
compacted grad driver (K5), and, for scenes past the unrolled bounds (up to
MAX_PRIMS_SCAN primitives), the forward over the Morton chunk scan's
selection (K6 vscan; K7 vquad, quads in chunks too) and the grad pass over
it (K3v weight planes, K4v tangent bundles, and past MAX_GRAD_TEXS texture
rows the suffix-radiance tier K8); and, on a scene compiled with use_bvh
that opts in (RTX_BVH_STACK=1, RTX_LANE_BVH=1), the forward and the
tex_color grad tiers over a BVH walk (K11 the stack BVH, K12 the lane BVH,
spheres only), scenes past MAX_PRIMS_SCAN included. Here they are one
hand-written CUDA kernel body, csrc/wavefront.cu, built with nvcc for
sm_90a at first use (its parts in parallel) and bound with ctypes. Beside
it:

  - `render_pass_reference` / `render_pass_grad_reference`: the same lane
    wavefront in plain torch, built from the integrator's per-bounce step
    (ops/integrator.py): persistent lane regeneration, `cap`, `carry` and
    `pix_lanes`, the same carry layout (14 rows; the grad pass appends its
    3*NT weight planes, 9 tangent planes per hard slot and the suffix
    tier's rows: the plain version's two-phase state, SUFFIX_ROWS, the
    kernel's single pass its path total, record count and records,
    _kernel_carry_rows). The hard slots' tangents are torch.func.jvp of the
    bounce step, batched over the slots with torch.func.vmap. The CPU tests
    run them; on the card only the parity checks do.
  - `pass_function` / `grad_pass_function` / `render_pass`: the
    dispatchers. A scene on a CUDA device launches the kernel (or raises),
    its tables packed once by `prepare_kernel`; a scene on the CPU runs the
    plain version.
  - `render_pass_compacted` / `render_pass_grad_compacted`: the capped +
    lane-compacted schedules, torch code shared by both versions and both
    passes (stable argsort by remaining samples, index_add_).
  - `hard_param_slots` / `light_sphere_sources` / `hard_slots_gate_reason`:
    the hard slots' metadata (wavefront_pallas.py:313-425), the slot table
    the kernel reads (`_slot_table`).
  - `kernel_mode` / `kernel_gate_reason` / `grad_gate_reason` /
    `tex_form`: which instance a scene takes, what the forward and the grad
    kernels accept, and which tex_color tier a grad pass runs.
  - `pack_vscan_tables` / `vscan_select_reference`: the chunk scan's tables
    (wavefront_pallas.py:495-675) and the plain version of its selection;
    `pack_bvh_tables` / `bvh_stack_select_reference` /
    `bvh_lane_select_reference`: the BVH modes' tables (the stack walk's
    tables at 3392-3400, the lane walk's _pack_lane_tables 703-750) and the
    plain versions of their selections. The plain pass
    (`render_pass_reference`) stays the all-primitive integrator in every
    mode (`all_primitive`).

The adjoint backward (K9, K10) has a module of its own, ops/adjoint_cuda.py;
its sweeps are parts 4 (K9) and 5 (K10) of csrc/wavefront.cu and their
ctypes bindings KernelLibrary.adjoint and KernelLibrary.adjoint_seg.

Lane layout: one lane per pixel, padded to a multiple of LANE_BLOCK; pad
lanes repeat the last pixel and are cropped (their cotangent is zero), and
the compaction permutes them like any other lane.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..scene.flat import (FlatScene, MAT_DIELECTRIC, MAT_METAL, TEX_CHECKER,
                          TEX_NOISE)
from ..models.camera import CameraState, generate_rays
from ..utils import rng
from ..utils.profiling import recording, span, spanned
from ..utils.vecmath import normalize
from . import intersect
from .bvh import MAX_LEAF, STACK_DEPTH, check_depth, ordered_skip_links
from .integrator import bounce_step, medium_uniforms

# gate bounds, as the JAX package's wavefront_pallas.py (MAX_* constants and
# _use_unrolled); SMEM_BUDGET there models the TPU's 1 MiB scalar memory and
# has no counterpart here
MAX_PRIMS_UNROLL = 64
MAX_PRIMS_SCAN = 16384  # the chunk scan's bound (wavefront_pallas.py:101)
MAX_MATS = 16
MAX_TEXS = 16
MAX_LIGHTS = 32
MAX_MEDIUMS = 4
# the exact weight-plane tier's texture bound (wavefront_pallas.py:345); past
# it the JAX package takes the suffix-radiance tier (K8)
MAX_GRAD_TEXS = 32
# what one block may hold in shared memory on Hopper (227 KB)
MAX_SHARED_BYTES = 232_448

# the chunk scan (K6 vscan, K7 vquad; wavefront_pallas.py:431-451)
VCHUNK = 128          # primitives per Morton chunk
VSCAN_BIG = 8         # the largest static spheres, in a final uncullable block
MAX_QUADS_VSCAN = 64  # past this many quads they move to chunks too (vquad)
BIG = 1e30
# Chunk boxes are widened by BOX_PAD x (1 + the largest coordinate of the
# culled primitives' boxes) on every side before the cull. A sphere root
# that float32 accepts on a grazing ray lies off the sphere by about
# 3 * 2^-24 * |oc|^2 / (2 r) (the discriminant cancels to that), and the slab
# test rounds by an ulp of t: for ray origins within the scene (|oc| up to
# twice its largest coordinate L) the pad covers both where spheres' radii
# exceed 4e-4 L, so the cull drops no winner the all-primitive test finds.
BOX_PAD = 1e-3
VROW_COLS = 8         # sphere chunk rows: c0 xyz, cdelta xyz, radius, id
QROW_COLS = 20        # quad chunk rows: corner, u, v, normal, d, w, id, pad
# The chunk scan's second level (csrc/wavefront.cu VGROUP, QGROUP): each
# sphere chunk is VCHUNK / VGROUP groups of VGROUP consecutive rows, each
# quad chunk VCHUNK / QGROUP groups of QGROUP (a quad test costs more than
# a sphere test), each group with its own box (motion-swept, widened by the
# chunk boxes' pad), GBOX_COLS floats a row in the buffer: lo xyz, 0, hi
# xyz, 0 (two float4s)
VGROUP = 8
QGROUP = 4
GBOX_COLS = 8

# the BVH modes (K11 stack, K12 lane; wavefront_pallas.py:464-492). The lane
# walk's node and primitive bound (LANE_BVH_MAX, 685): ids ride as exact
# float32 integers
BVH_MODES = ("stack", "lane")
LANE_BVH_MAX = 1 << 22
# The lane walk's (K12) node rows (_bvh_lane_rows; csrc/wavefront.cu
# LANE_ROW float4s): the widened box lo xyz, hi xyz, the node's sphere run
# (first row, count; 0 at an inner node), then the node's [hit, miss] links
# for each of the 8 ray octants (their int32 bits)
N_OCTANTS = 8
BVH_LANE_COLS = 8 + 2 * N_OCTANTS
# The stack walk's (K11) rows: an inner node's two children's widened boxes
# and their links, a leaf's runs (_bvh_stack_rows; csrc/wavefront.cu
# BVH_STACK_COLS)
BVH_STACK_COLS = 16

LANE_BLOCK = 128  # = WF_THREADS, the kernel's block size
CARRY_ROWS = 14   # work, alive, bounce, sample, time, o xyz, d xyz, th xyz
# (the grad pass appends 3*NT weight-plane rows, then 9 tangent-plane rows
# per hard slot, then the suffix tier's rows: in the plain version, which
# traces each sample twice as the JAX kernel does, SUFFIX_ROWS: phase, T
# xyz, P xyz (wavefront_pallas.py:3240-3249); in the kernel, which traces it
# once, SFX_STATE: T xyz and the path's record count, then SFX_REC rows a
# record, max_depth records: eff row, at xyz, P xyz; csrc/wavefront.cu)
SUFFIX_ROWS = 7
SFX_STATE = 4
SFX_REC = 7

# the hard trainable families and their slot kinds
# (wavefront_pallas.py:382-383)
HARD_SLOT_FIELDS = {"fuzz": "mat_fuzz", "ior": "mat_ior",
                    "sphc": "sph_center", "sphr": "sph_radius"}
HARD_FIELDS = ("mat_fuzz", "mat_ior", "sph_center", "sph_radius")
# hard slots one grad launch takes (csrc/wavefront.cu MAX_SLOTS): their
# tangent planes and sums live in shared memory, 10 floats a slot a lane.
# From 33 slots the training policy takes the adjoint (K9,
# ADJOINT_MIN_SLOTS, parallel/train.py), so 32 covers the tangent tier.
MAX_HARD_SLOTS = 32
# the slot table's table codes (csrc/wavefront.cu SEED_*)
_SEED_SPH, _SEED_MATF = 1, 2

_PKG_DIR = Path(__file__).resolve().parents[1]
_CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
# --fmad=false: no a*b+c contraction, so the kernel rounds as the plain
# torch version does op by op (with contraction, 3.4% of Cornell 128^2
# spp16 d50 pixels flipped a branch, over the 1% parity rule)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# csrc/wavefront.cu is compiled once per part (-DWF_PART=p), the parts in
# parallel, and the objects linked into one library (the file's comment
# above its kernels says which instances each part holds; 4 and 5 are the
# adjoint's sweeps, K9 and K10, ops/adjoint_cuda.py; 6 and 7 the BVH walks,
# K11 and K12)
WF_PARTS = (0, 1, 2, 3, 4, 5, 6, 7)


# ------------------------------------------------------------------- gate
def _use_unrolled(flat: FlatScene) -> bool:
    """The JAX package's unrolled-kernel bounds (_use_unrolled)."""
    S, Q = flat.sph_center.shape[0], flat.quad_corner.shape[0]
    return (S + Q <= MAX_PRIMS_UNROLL and flat.mat_type.shape[0] <= MAX_MATS
            and flat.tex_type.shape[0] <= MAX_TEXS)


def kernel_env() -> tuple:
    """The kernel-mode knobs (RTX_LANE_BVH, RTX_BVH_STACK), read from the
    environment when a scene is packed (prepare_kernel), not at launch: the
    JAX package's _kernel_env (wavefront_pallas.py:454-461), which threads
    them through as a static argument so that a changed setting cannot
    silently reuse a kernel built under the old one. Its RTX_LANE_GATHER
    and RTX_VSCAN_CULL pick among TPU code shapes (a gather by take or by
    a one-hot product; a chunk cull by branch or by mask) that have no
    counterpart here and are not read."""
    return (os.environ.get("RTX_LANE_BVH", "0"),
            os.environ.get("RTX_BVH_STACK", "0"))


def kernel_mode(flat: FlatScene, env: tuple | None = None) -> tuple:
    """(mode, vquad): the JAX package's _kernel_modes
    (wavefront_pallas.py:464-492) under env (kernel_env() when None).
    "unrolled" for a scene inside the unrolled bounds (tables in shared
    memory, every primitive tested); on a scene compiled with use_bvh,
    "lane" (K12) under RTX_LANE_BVH=1 when it has no quads and at most
    LANE_BVH_MAX nodes and primitives, else "stack" (K11) under
    RTX_BVH_STACK=1; else "vscan", the Morton chunk scan, with vquad True
    when its quads (more than MAX_QUADS_VSCAN) move to chunks too. The BVH
    modes are opt-in, as in the JAX package: the chunk scan is the default
    on every other scene, use_bvh or not."""
    lane_bvh, bvh_stack = kernel_env() if env is None else env
    if _use_unrolled(flat):
        return "unrolled", False
    if (lane_bvh == "1" and flat.use_bvh and flat.n_quads == 0
            and flat.bvh_bbox_min.shape[0] <= LANE_BVH_MAX
            and flat.bvh_prims.shape[0] <= LANE_BVH_MAX):
        return "lane", False
    if bvh_stack == "1" and flat.use_bvh:
        return "stack", False
    return "vscan", flat.quad_corner.shape[0] > MAX_QUADS_VSCAN


def kernel_gate_reason(flat: FlatScene) -> str | None:
    """Why this scene cannot run on the forward kernel (None = it can): the
    JAX package's pallas_gate_reason, and for the unrolled mode the
    shared-memory bound of its tables (the other modes read their tables
    from global memory). A scene compiled with use_bvh passes
    MAX_PRIMS_SCAN, as in the JAX gate. The JAX gate also refuses a scene
    whose tables overflow the TPU's scalar memory (SMEM_BUDGET), the stack
    BVH's node tables among them; no such budget exists here, so the stack
    mode (K11) also runs where the TPU refused it."""
    if flat.n_mediums > MAX_MEDIUMS:
        return (f"{flat.n_mediums} constant mediums exceeds the kernel bound "
                f"MAX_MEDIUMS={MAX_MEDIUMS}")
    if flat.n_prims == 0:
        return "empty scene (no primitives)"
    if not flat.use_bvh and flat.n_prims > MAX_PRIMS_SCAN:
        return (f"{flat.n_prims} primitives exceeds the chunk scan's bound "
                f"MAX_PRIMS_SCAN={MAX_PRIMS_SCAN}; compile with use_bvh "
                "(-b/--bvh), which lifts it (the chunk scan by default, the "
                "BVH kernels K11/K12 on opt-in)")
    if flat.n_lights > MAX_LIGHTS:
        return (f"{flat.n_lights} MIS lights exceeds the kernel bound "
                f"MAX_LIGHTS={MAX_LIGHTS}")
    if kernel_mode(flat)[0] == "unrolled":
        n_bytes = 4 * _table_floats(flat)
        if n_bytes > MAX_SHARED_BYTES:
            return (f"scene tables need {n_bytes} B of shared memory, over "
                    f"the {MAX_SHARED_BYTES} B a Hopper block can hold")
    return None


def tex_form(flat: FlatScene, want_tex: bool = True,
             force_planes: bool = False) -> str | None:
    """The tex_color gradient's tier, the JAX package's rule
    (wavefront_pallas.py:914-931): exact weight planes ("planes") for at
    most MAX_GRAD_TEXS texture rows, else the suffix-radiance estimator
    ("suffix", K8), whose cost does not grow with the rows; None without
    want_tex. force_planes takes the weight planes at any row count (the
    plain version's oracle for the suffix form)."""
    if not want_tex:
        return None
    if flat.tex_type.shape[0] > MAX_GRAD_TEXS and not force_planes:
        return "suffix"
    return "planes"


def grad_gate_reason(flat: FlatScene, n_slots: int = 0,
                     want_tex: bool = True) -> str | None:
    """Why a grad pass (tex_color if want_tex, and n_slots tangent bundles)
    cannot run on the grad kernels (None = it can): the forward's gate; at
    most MAX_HARD_SLOTS slots (past them training takes the adjoint, K9,
    as the JAX package takes its adjoint kernels K9/K10); and the launch's
    shared memory (grad_smem_bytes: the unrolled mode's tables beside the
    tangent planes; past the unrolled mode the weight planes and the
    suffix tier are in global memory, so up to MAX_HARD_SLOTS slots always
    fit). want_tex does not change the answer (past the unrolled mode the
    weight planes take no shared memory); it stays in the JAX rule's
    signature. The BVH modes take no hard slot
    (hard_slots_gate_reason)."""
    reason = kernel_gate_reason(flat)
    if reason is not None:
        return reason
    if n_slots and kernel_mode(flat)[0] in BVH_MODES:
        return _BVH_SLOTS_REASON
    NT = flat.tex_type.shape[0]
    if n_slots > MAX_HARD_SLOTS:
        return (f"{n_slots} hard slots exceed the tangent-bundle kernel's "
                f"MAX_HARD_SLOTS={MAX_HARD_SLOTS}; from 33 slots training "
                "takes the adjoint backward (K9/K10; ops/adjoint_cuda.py)")
    n_bytes = grad_smem_bytes(flat, n_slots)
    if n_bytes > MAX_SHARED_BYTES:
        return (f"a grad pass with {n_slots} hard slots and {NT} texture "
                f"rows needs {n_bytes} B of shared memory, over the "
                f"{MAX_SHARED_BYTES} B a Hopper block can hold")
    return None


# ------------------------------------------------------------- hard slots
def hard_param_slots(flat: FlatScene, fields=None) -> tuple:
    """The scalar "hard" trainable parameters, which enter through scatter
    directions and intersection t rather than the throughput: metal fuzz,
    dielectric IOR, the centers and radii of active spheres and of the
    (inactive) sphere rows the light list copies
    (wavefront_pallas.py:386-416, the same slots in the same order).

    Each is ("fuzz", m) | ("ior", m) | ("sphc", p, axis) | ("sphr", p).
    `fields` restricts them to those FlatScene field names. Reads the
    tables back to the host."""
    mt = flat.mat_type.cpu().numpy()
    act = flat.sph_active.cpu().numpy().copy()
    S = act.shape[0]
    for p in flat.light_prim.cpu().numpy()[:flat.n_lights]:
        if p < S:
            act[p] = True
    slots = []
    for m in range(mt.shape[0]):
        if mt[m] == MAT_METAL and (fields is None or "mat_fuzz" in fields):
            slots.append(("fuzz", m))
        if mt[m] == MAT_DIELECTRIC and (fields is None
                                        or "mat_ior" in fields):
            slots.append(("ior", m))
    for p in range(S):
        if act[p]:
            if fields is None or "sph_center" in fields:
                slots += [("sphc", p, 0), ("sphc", p, 1), ("sphc", p, 2)]
            if fields is None or "sph_radius" in fields:
                slots.append(("sphr", p))
    return tuple(slots)


def light_sphere_sources(flat: FlatScene) -> tuple:
    """Per light row of the kernel's table: the sphere row it copies, or -1
    for a quad light (wavefront_pallas.py:419-425). A slot of that sphere
    also perturbs the light row's center and radius columns."""
    S = flat.sph_center.shape[0]
    lp = flat.light_prim.cpu().numpy()[:max(flat.n_lights, 1)]
    return tuple(int(p) if p < S else -1 for p in lp)


def slot_index(slot) -> tuple:
    """(FlatScene field, index into it) of one hard slot."""
    f = HARD_SLOT_FIELDS[slot[0]]
    return f, (slot[1] if slot[0] != "sphc" else (slot[1], slot[2]))


def _slot_table(hard_slots) -> torch.Tensor:
    """(K, 3) rows of the kernel's slot table: the table (sphere or
    material floats), row and column each slot perturbs (the JAX kernel's
    theta_map, wavefront_pallas.py:955-978; light rows alias through
    light_sphere_sources)."""
    rows = []
    for s in hard_slots:
        if s[0] == "fuzz":
            rows.append((_SEED_MATF, s[1], 0))
        elif s[0] == "ior":
            rows.append((_SEED_MATF, s[1], 1))
        elif s[0] == "sphc":
            rows.append((_SEED_SPH, s[1], s[2]))
        elif s[0] == "sphr":
            rows.append((_SEED_SPH, s[1], 6))
        else:
            raise ValueError(f"unknown hard slot {s!r}")
    return torch.tensor(rows, dtype=torch.float32).reshape(-1, 3)


def _vscan_box_floats(flat: FlatScene) -> int:
    """Floats of the chunk boxes a chunk-scan launch copies into shared
    memory: pack_vscan_tables' box rows, 6 floats each."""
    S, Q = flat.sph_center.shape[0], flat.quad_corner.shape[0]
    n_big = VSCAN_BIG if S > VCHUNK else 0
    C_small = max(-(-(S - n_big) // VCHUNK), 1)
    Cq = -(-Q // VCHUNK) if Q > MAX_QUADS_VSCAN else 0
    return 6 * (C_small + (1 if n_big else 0) + Cq)


def grad_smem_bytes(flat: FlatScene, n_slots: int) -> int:
    """Shared memory of a grad launch (csrc/wavefront.cu, wavefront_body):
    the tables (the unrolled mode, with the slot table), the chunk boxes
    (the chunk scan, whose tables and group boxes stay in global memory)
    or nothing (the BVH modes), padded as table_pad does; 10 floats a hard
    slot a lane. The unrolled mode's weight planes are registers; past it
    the weight planes of the rows a path holds and their cotangent sums are
    rows of global memory (_tex_scratch_floats), as the suffix tier's route
    sums and records are."""
    mode = kernel_mode(flat)[0]
    n = {"unrolled": _table_floats(flat) + 3 * n_slots,
         "vscan": _vscan_box_floats(flat)}.get(mode, 0)
    return 4 * (-(-n // 32) * 32 + 10 * n_slots * LANE_BLOCK)


def _tex_scratch_floats(form: str | None, mode: str, nt: int, n_lanes: int,
                        cap: int, max_depth: int) -> int:
    """Floats of global scratch a tex_color grad launch needs
    (csrc/wavefront.cu, wavefront_body's scr): past the unrolled mode the
    weight planes' Gp rows and plane rows, 4 * NT floats a lane each;
    the suffix tier's route sums, 3 * NT a warp, and (uncapped; a capped
    pass keeps them in its carry) its records, SFX_REC floats each,
    max_depth a lane; else none."""
    if form == "planes" and mode != "unrolled":
        return 8 * nt * n_lanes
    if form == "suffix":
        return (n_lanes // 32) * 3 * nt + (0 if cap else
                                           SFX_REC * max_depth * n_lanes)
    return 0


# the JAX package's reason (pallas_hard_slots_gate_reason,
# wavefront_pallas.py:313-342): its stack and lane walks are
# lax.while_loops, which jax.linearize cannot take; the BVH instances here
# carry no tangent bundles either, and a request with hard slots on such a
# scene takes the adjoint (parallel/train.py), which runs on the chunk scan
_BVH_SLOTS_REASON = ("hard-parameter slots need the unrolled or vscan kernel "
                     "(stack/lane traversal loops are not linearizable)")


def hard_slots_gate_reason(flat: FlatScene, n_slots: int) -> str | None:
    """Why n_slots hard slots cannot run in the grad kernel (None = they
    can): grad_gate_reason without tex_color; in the BVH modes none can,
    as in the JAX package."""
    return grad_gate_reason(flat, n_slots, want_tex=False)


# ----------------------------------------------------------------- tables
def _pack_tables(flat: FlatScene):
    """The JAX package's _pack_tables: the scene gathered into kernel rows.

    Returns (sphf (S, 8), quadf (Q, 18), prim_mat (S+Q,), lightf (L, 25),
    mati (NM, 2), matf (NM, 2), texf (NT, 14), medf (M, 3+4*MS+17*MQ)) with
    the same columns. The JAX package's scan-mode resolved row table
    (primmatf) waits for the large-scene kernel that reads it. A flag or
    an index column becomes float32 in its torch.cat (type promotion: the
    exact float of each)."""
    sphf = torch.cat([flat.sph_center, flat.sph_cdelta,
                      flat.sph_radius[:, None], flat.sph_active[:, None]],
                     dim=1)
    quadf = torch.cat([flat.quad_corner, flat.quad_u, flat.quad_v,
                       flat.quad_normal, flat.quad_d[:, None], flat.quad_w,
                       flat.quad_area[:, None], flat.quad_active[:, None]],
                      dim=1)
    prim_mat = torch.cat([flat.sph_mat, flat.quad_mat])

    # a light row: is_sph, its sphere's c0, cdelta, radius (sphf's first
    # 7 columns), its quad's corner ... area (quadf's first 17)
    S = flat.sph_center.shape[0]
    li = flat.light_prim
    si = torch.clamp(li, 0, S - 1)
    qi = torch.clamp(li - S, 0, flat.quad_corner.shape[0] - 1)
    lightf = torch.cat([(li < S)[:, None], sphf[si, :7], quadf[qi, :17]],
                       dim=1)

    mati = torch.stack([flat.mat_type, flat.mat_tex], dim=1)
    matf = torch.stack([flat.mat_fuzz, flat.mat_ior], dim=1)

    even, odd = flat.tex_child_even, flat.tex_child_odd
    texf = torch.cat([
        flat.tex_color, flat.tex_scale[:, None],
        (flat.tex_type == TEX_CHECKER)[:, None], flat.tex_color[even],
        flat.tex_color[odd], even[:, None], odd[:, None],
        (flat.tex_type == TEX_NOISE)[:, None]], dim=1)

    n_med = flat.med_mat.shape[0]
    quad_cols = torch.cat([
        flat.med_quad_corner, flat.med_quad_u, flat.med_quad_v,
        flat.med_quad_normal, flat.med_quad_d[..., None], flat.med_quad_w,
        flat.med_quad_active[..., None]], dim=2).reshape(n_med, -1)
    sph_cols = torch.cat([flat.med_sph_center,
                          flat.med_sph_radius[..., None]],
                         dim=2).reshape(n_med, -1)
    medf = torch.cat([flat.med_neg_inv_density[:, None],
                      flat.med_active[:, None], sph_cols, quad_cols,
                      flat.med_mat[:, None]], dim=1)
    return (sphf, quadf, prim_mat, lightf, mati, matf, texf, medf)


def _table_floats(flat: FlatScene) -> int:
    """Floats in the kernel's shared-memory table without the slot table
    (see _kernel_tables)."""
    S, Q = flat.sph_center.shape[0], flat.quad_corner.shape[0]
    NM, NT = flat.mat_type.shape[0], flat.tex_type.shape[0]
    MS, MQ = flat.med_sph_center.shape[1], flat.med_quad_corner.shape[1]
    return (8 * S + 18 * Q + (S + Q) + 26 * max(flat.n_lights, 1)
            + 4 * NM + 14 * NT
            + flat.n_mediums * (3 + 4 * MS + 17 * MQ))


def _kernel_tables(flat: FlatScene, hard_slots=()):
    """One contiguous float32 buffer of the tables the kernel reads, and
    the offset of each (integer columns stored as exact floats, by the
    torch.cat's type promotion): the scene, the light rows' source spheres
    and the hard slots' table."""
    sphf, quadf, prim_mat, lightf, mati, matf, texf, medf = \
        _pack_tables(flat)
    parts = {"sph": sphf, "quad": quadf, "pmat": prim_mat,
             "light": lightf[:max(flat.n_lights, 1)], "mati": mati,
             "matf": matf, "tex": texf, "med": medf[:flat.n_mediums],
             "lsrc": torch.tensor(light_sphere_sources(flat),
                                  dtype=torch.float32),
             "slot": _slot_table(hard_slots)}
    offsets, off, flat_parts = {}, 0, []
    for name, t in parts.items():
        offsets[name] = off
        if t.device != flat.device:
            t = t.to(flat.device)
        t = t.reshape(-1)
        off += t.numel()
        flat_parts.append(t)
    buf = torch.cat(flat_parts).contiguous()
    return buf, offsets, int(medf.shape[1])


# ------------------------------------------------------ chunk-scan tables
def _morton_codes(mid, act):
    """30-bit Morton codes (wavefront_pallas.py:176) of box midpoints (n,
    3) quantized to 10 bits over the active ones' span, as the JAX packers
    do: each axis's bits spread to every third bit, x highest. In int64:
    torch's CPU builds have no uint32 shift or add, and no step here leaves
    32 bits."""
    act = act[:, None]
    wmin = torch.where(act, mid, BIG).amin(0)
    wmax = torch.where(act, mid, -BIG).amax(0)
    scale = 1023.0 / torch.clamp(wmax - wmin, min=1e-6)
    v = torch.clamp((mid - wmin) * scale, 0.0, 1023.0).to(torch.int64)
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return (v[:, 0] << 2) | (v[:, 1] << 1) | v[:, 2]


def _chunk_boxes(lo, hi, n_chunks: int, runs=(VCHUNK, VGROUP)) -> list:
    """For each run length r of `runs`, the (n_chunks * VCHUNK / r, 6)
    boxes [lo xyz, hi xyz] of consecutive r-row runs of n_chunks
    VCHUNK-row chunks (the chunks' own boxes at VCHUNK, their groups' at
    VGROUP or QGROUP); rows past lo's end count as empty (BIG / -BIG)."""
    pad = n_chunks * VCHUNK - lo.shape[0]
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=BIG)
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-BIG)
    return [torch.cat([lo.reshape(-1, r, 3).amin(1),
                       hi.reshape(-1, r, 3).amax(1)], dim=1)
            for r in runs]


def _chunk_rows(rows, n_chunks: int, id_col: int):
    """rows padded with zero rows of id -1 (column id_col) to n_chunks *
    VCHUNK."""
    pad = n_chunks * VCHUNK - rows.shape[0]
    out = torch.nn.functional.pad(rows, (0, 0, 0, pad))
    out[rows.shape[0]:, id_col] = -1.0
    return out


@dataclass(frozen=True)
class VscanTables:
    """A scene's tables for the chunk scan (K6 vscan, K7 vquad), in the
    JAX packers' order (_pack_vscan_tables, wavefront_pallas.py:495-620;
    _pack_vquad_tables, 626-675). The JAX packers' resolved material rows
    (primmatf) and chunk-major gather tables exist because a TPU lane
    cannot gather by index; a CUDA thread can, so the winner's original
    unified id (riding every row) indexes the scene's own tables.

      rows (C * VCHUNK, 8): sphere rows [c0 xyz, cdelta xyz, radius, id],
        Morton-ordered: static, then moving, then inactive (id -1), padded
        (id -1) to C_small chunks; then the n_big largest static spheres in
        one final block that no box culls (bouncing_spheres' r = 1000
        ground would otherwise widen its chunk's box over the scene).
      perm (S,): the original sphere id at each sorted position (the JAX
        packer's permutation).
      box (C + Cq, 6): the sphere chunks' boxes, swept over the motion
        interval (the big block's is empty), then the quad chunks'; empty
        boxes are [BIG, -BIG]. The cull widens them by `pad`.
      gbox (C * VCHUNK / VGROUP + Cq * VCHUNK / QGROUP, 6): the second
        level, the boxes of each sphere chunk's groups of VGROUP
        consecutive rows, then of each quad chunk's groups of QGROUP, in
        the chunks' order, built as `box` is (the big block's are empty,
        as are groups of id -1 rows only); `box` is their union chunk by
        chunk. The cull widens them by `pad` too.
      qrows (Cq * VCHUNK, 20): with vquad (Q > MAX_QUADS_VSCAN), quad rows
        [corner, u, v, normal, d, w, id, 0 0 0] in Morton order, inactive
        and pad rows id -1; qperm the original quad ids. Cq = 0 tests the
        quads one by one from `quads` (Q, 17): corner, u, v, normal, d, w,
        active, in the scene's order.
    Ids are unified primitive ids: spheres 0..S-1, quads S + q."""
    rows: torch.Tensor
    perm: torch.Tensor
    box: torch.Tensor
    gbox: torch.Tensor
    pad: float
    S: int
    C_small: int
    C_stat: int
    n_big: int
    qrows: torch.Tensor
    qperm: torch.Tensor
    Cq: int
    quads: torch.Tensor

    @property
    def C(self) -> int:
        return self.C_small + (1 if self.n_big else 0)


def _sphere_boxes(flat: FlatScene):
    """The spheres as the chunk scan sees them: (active (a radius > 0),
    motion-swept boxes lo and hi, moving, is_big: the VSCAN_BIG spheres of
    the largest extent, static ones where the scene has enough, which the
    chunk scan never culls (none at VCHUNK spheres or fewer))."""
    c0, cd, rad = flat.sph_center, flat.sph_cdelta, flat.sph_radius
    S = c0.shape[0]
    active = flat.sph_active & (rad > 0.0)
    c1, r = c0 + cd, rad[:, None]
    lo = torch.minimum(c0, c1) - r
    hi = torch.maximum(c0, c1) + r
    moving = (cd != 0.0).any(1)
    n_big = VSCAN_BIG if S > VCHUNK else 0
    is_big = torch.zeros(S, dtype=torch.bool, device=flat.device)
    if n_big:
        static_bigs = int(flat.n_sph_active_static) >= n_big
        pool = (active & ~moving) if static_bigs else active
        extent = (hi - lo).amax(1)
        order = torch.argsort(-torch.where(pool, extent, -1.0), stable=True)
        is_big[order[:n_big]] = True
    return active, lo, hi, moving, is_big


def pack_vscan_tables(flat: FlatScene) -> VscanTables:
    """The chunk-scan tables of a vscan scene (see VscanTables)."""
    f32 = torch.float32
    dev = flat.device
    c0, cd, rad = flat.sph_center, flat.sph_cdelta, flat.sph_radius
    S = c0.shape[0]
    active, lo, hi, moving, is_big = _sphere_boxes(flat)
    n_big = VSCAN_BIG if S > VCHUNK else 0
    nas = int(flat.n_sph_active_static)
    pick_static_bigs = nas >= n_big
    code = _morton_codes(0.5 * (lo + hi), active)
    # static smalls, moving smalls, inactive rows, the bigs last
    code = torch.where(active & moving, code | (1 << 30), code)
    code = torch.where(active, code, 0xFFFFFFFE)
    code = torch.where(is_big, 0xFFFFFFFF, code)
    perm = torch.argsort(code, stable=True)
    n_small = S - n_big
    C_small = max(-(-n_small // VCHUNK), 1)
    n_small_static = max(nas - n_big, 0) if pick_static_bigs else 0
    C_stat = min(n_small_static // VCHUNK, C_small)
    ids = torch.where(active, torch.arange(S, device=dev), -1)
    rows = torch.cat([c0, cd, rad[:, None], ids[:, None]], 1)[perm]
    rows = torch.cat([_chunk_rows(rows[:n_small], C_small, 7)]
                     + [_chunk_rows(rows[n_small:], 1, 7)] * (n_big > 0))
    culled = (active & ~is_big)[:, None]
    lo_c = torch.where(culled, lo, BIG)[perm][:n_small]
    hi_c = torch.where(culled, hi, -BIG)[perm][:n_small]
    box, gbox = _chunk_boxes(lo_c, hi_c, C_small + (1 if n_big else 0))
    scale = torch.where(culled, torch.maximum(lo.abs(), hi.abs()),
                        0.0).max() if S else torch.zeros((), device=dev)

    Q = flat.quad_corner.shape[0]
    qact = flat.quad_active
    quads = torch.cat([flat.quad_corner, flat.quad_u, flat.quad_v,
                       flat.quad_normal, flat.quad_d[:, None], flat.quad_w,
                       qact[:, None]], 1)
    Cq = 0
    qrows = torch.zeros(0, QROW_COLS, dtype=f32, device=dev)
    qperm = torch.zeros(0, dtype=torch.int64, device=dev)
    if Q > MAX_QUADS_VSCAN:
        corner, u, v = flat.quad_corner, flat.quad_u, flat.quad_v
        c1, c2, c3 = corner + u, corner + v, corner + u + v
        qlo = torch.minimum(torch.minimum(corner, c1), torch.minimum(c2, c3))
        qhi = torch.maximum(torch.maximum(corner, c1), torch.maximum(c2, c3))
        qcode = torch.where(qact, _morton_codes(0.5 * (qlo + qhi), qact),
                            0xFFFFFFFF)
        qperm = torch.argsort(qcode, stable=True)
        Cq = -(-Q // VCHUNK)
        qids = torch.where(qact, S + torch.arange(Q, device=dev), -1)
        qrows = _chunk_rows(torch.cat([
            quads[:, :16], qids[:, None],
            torch.zeros(Q, 3, dtype=f32, device=dev)], 1)[qperm], Cq, 16)
        qlo_c = torch.where(qact[:, None], qlo, BIG)[qperm]
        qhi_c = torch.where(qact[:, None], qhi, -BIG)[qperm]
        qbox, qgbox = _chunk_boxes(qlo_c, qhi_c, Cq, (VCHUNK, QGROUP))
        box = torch.cat([box, qbox])
        gbox = torch.cat([gbox, qgbox])
        scale = torch.maximum(scale, torch.where(
            qact[:, None], torch.maximum(qlo.abs(), qhi.abs()), 0.0).max())
    pad = float(np.float32(BOX_PAD * (1.0 + float(scale))))
    return VscanTables(rows=rows.contiguous(), perm=perm, box=box,
                       gbox=gbox, pad=pad,
                       S=S, C_small=C_small, C_stat=C_stat, n_big=n_big,
                       qrows=qrows.contiguous(), qperm=qperm, Cq=Cq,
                       quads=quads)


def _padded_boxes(vt: VscanTables, box=None) -> torch.Tensor:
    """The boxes the cull tests: each non-empty box of `box` (the chunk
    boxes vt.box by default, or the group boxes vt.gbox) widened by
    vt.pad."""
    box = vt.box if box is None else box
    lo, hi = box[:, :3], box[:, 3:]
    empty = (lo > hi).any(1, keepdim=True)
    return torch.cat([torch.where(empty, lo, lo - vt.pad),
                      torch.where(empty, hi, hi + vt.pad)], 1)


def _vscan_buffer(vt: VscanTables):
    """One float32 buffer of what the vscan kernel reads beside the scene
    tables: the widened group boxes (GBOX_COLS floats each, two float4s),
    the sphere rows, the quad rows (each 16-byte aligned, for float4
    loads) and the widened chunk boxes; and the kernel's VsParams
    fields."""
    g = torch.nn.functional.pad(_padded_boxes(vt, vt.gbox).reshape(-1, 2, 3),
                                (0, 1))
    parts = [g.reshape(-1), vt.rows.reshape(-1), vt.qrows.reshape(-1),
             _padded_boxes(vt).reshape(-1)]
    n0, n1, n2 = (x.numel() for x in parts[:3])
    fields = dict(C_small=vt.C_small, n_big=vt.n_big, Cq=vt.Cq,
                  off_rows=n0, off_qrows=n0 + n1, off_box=n0 + n1 + n2,
                  n_box=parts[3].numel(), off_gbox=0,
                  n_gbox=vt.gbox.shape[0])
    return torch.cat(parts).contiguous(), fields


def _inverse_dir(d):
    """1/d with |d| < 1e-12 taken as +-1e-12 (wavefront_pallas.py:
    1411-1416): the slab test of a ray along a box face stays finite."""
    eps = 1e-12
    return 1.0 / torch.where(d.abs() < eps,
                             torch.where(d < 0, -eps, eps), d)


def _box_entry(box, o, inv_d, t_far):
    """The kernel's per-ray box cull (box_entry): does the ray meet the
    (widened) box between T_MIN and t_far (never, an empty box), and its
    entry t into the box, tn = max(the slabs' near ts, T_MIN): (met, tn).
    The box is met before a later t_far' <= t_far exactly where it was met
    before t_far and tn <= t_far'. box (6,) or one a ray (n, 6), rays
    (n, 3)."""
    t0 = (box[..., :3] - o) * inv_d
    t1 = (box[..., 3:] - o) * inv_d
    tn = torch.maximum(torch.maximum(torch.minimum(t0[:, 0], t1[:, 0]),
                                     torch.minimum(t0[:, 1], t1[:, 1])),
                       torch.clamp(torch.minimum(t0[:, 2], t1[:, 2]),
                                   min=1e-3))
    tf = torch.minimum(torch.minimum(torch.maximum(t0[:, 0], t1[:, 0]),
                                     torch.maximum(t0[:, 1], t1[:, 1])),
                       torch.minimum(torch.maximum(t0[:, 2], t1[:, 2]),
                                     t_far))
    return (box[..., 0] <= box[..., 3]) & (tn <= tf), tn


def _box_reaches(box, o, inv_d, t_far):
    """_box_entry's cull alone (the kernel's box_reaches)."""
    return _box_entry(box, o, inv_d, t_far)[0]


def vscan_select_reference(vt: VscanTables, o, d, tm):
    """The plain version of the kernel's chunk-scan selection: the same
    walk (the big block, then each sphere chunk, then the quad chunks or
    the quads one by one; in a chunk whose box a ray meets, each group
    whose box it meets) and per-ray box culls against the running best t,
    for rays o, d (n, 3) at times tm (n,). Returns (the winner's
    original unified id, -1 on a miss; its t, BIG on a miss). The winner is
    the exact closest root, ties to the lowest unified id (spheres before
    quads), the all-primitive ops/intersect.py::closest_hit's bit for bit:
    each primitive is tested with the same float32 operations."""
    from .intersect import quad_ts, sphere_ts
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    inv_d = _inverse_dir(d)
    boxes = _padded_boxes(vt)
    gboxes = _padded_boxes(vt, vt.gbox)
    no_id = torch.iinfo(torch.int64).max

    def merge(idx, ts, ids):
        """Take, per ray idx, the lowest id among its closest roots ts
        (len(idx), k) where that beats the running (t, id)."""
        t = ts.min(1).values
        i = torch.where(ts == t[:, None], ids[None, :], no_id).min(1).values
        bt, bi = best_t[idx], best[idx]
        take = (t < BIG * 0.5) & ((t < bt) | ((t == bt) & (i < bi)))
        best_t[idx] = torch.where(take, t, bt)
        best[idx] = torch.where(take, i, bi)

    def spheres(idx, rows):
        rows = rows[rows[:, 7] >= 0]
        if idx.numel() and rows.shape[0]:
            ones = torch.ones(rows.shape[0], dtype=torch.bool, device=dev)
            merge(idx, sphere_ts(rows[:, 0:3], rows[:, 3:6], rows[:, 6],
                                 ones, o[idx], d[idx], tm[idx]),
                  rows[:, 7].to(torch.int64))

    def quads(idx, rows, ids):
        if idx.numel() and rows.shape[0]:
            merge(idx, quad_ts(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9],
                               rows[:, 9:12], rows[:, 12], rows[:, 13:16],
                               rows[:, 16] > 0.5, o[idx], d[idx]), ids)

    def culled(box, idx):
        """The rays of idx whose ray meets the (widened) box before their
        best t."""
        if bool(box[0] > box[3]) or not idx.numel():
            return idx[:0]
        return idx[_box_reaches(box, o[idx], inv_d[idx], best_t[idx])]

    def groups(g0, size, idx):
        """(rays, first row in the chunk) of each group, of `size` rows, of
        the chunk whose group boxes start at g0 that the rays of idx meet,
        group by group (the best t falls between groups)."""
        for g in range(VCHUNK // size):
            yield culled(gboxes[g0 + g], idx), g * size

    every = torch.arange(n, device=dev)
    if vt.n_big:
        base = vt.C_small * VCHUNK
        spheres(every, vt.rows[base:base + vt.n_big])
    for c in range(vt.C_small):
        for idx, r0 in groups(c * VCHUNK // VGROUP, VGROUP,
                              culled(boxes[c], every)):
            r0 += c * VCHUNK
            spheres(idx, vt.rows[r0:r0 + VGROUP])
    if vt.Cq:
        for k in range(vt.Cq):
            g0 = (vt.C * VCHUNK // VGROUP) + k * VCHUNK // QGROUP
            for idx, r0 in groups(g0, QGROUP,
                                  culled(boxes[vt.C + k], every)):
                r0 += k * VCHUNK
                rows = vt.qrows[r0:r0 + QGROUP]
                rows = rows[rows[:, 16] >= 0]
                q = torch.cat([rows[:, :16], torch.ones_like(rows[:, :1])],
                              1)
                quads(idx, q, rows[:, 16].to(torch.int64))
    else:
        quads(torch.arange(n, device=dev), vt.quads,
              vt.S + torch.arange(vt.quads.shape[0], device=dev))
    return best, best_t


# ------------------------------------------------------------- BVH tables
@dataclass(frozen=True)
class BvhTables:
    """A use_bvh scene's tables for a BVH walk (K11 stack, K12 lane), from
    its flat.bvh_* fields (ops/bvh.py). The JAX kernels' scalar-memory node
    tables (wavefront_pallas.py:3392-3400) and 128-lane chunk-major gather
    tables (_pack_lane_tables, 703-750) are TPU layouts; here a thread
    reads its own rows from global memory.

      box (B, 6): the node boxes [lo xyz, hi xyz] (flat.bvh_bbox_*); the
        walk tests each widened by its `pad` (B,) on every side
        (bvh_box_pad), so that no grazing root the all-primitive test
        accepts falls outside its leaf's ancestors. The stack walk reads a
        node's widened box in its parent's row (_bvh_stack_rows).
      link (B, 6): per node: [leaf (1 or 0), split axis, left child |
        first sphere row, right child | sphere count, 0 | first quad row,
        0 | quad count].
      octant (8, B, 2) int32, the lane walk's only (None for the stack
        walk): per ray octant o (bit k set where the ray's direction has
        its sign bit set along axis k, -0.0 included) the skip links
        [hit, miss] of the preorder that enters each inner node's child
        nearer along its split axis for o's sign there first (octant_links).
      srows (NS, 8): the leaves' sphere rows in leaf order [c0 xyz, cdelta
        xyz, radius, original id]; id -1 for a radius <= 0 (never a
        winner, as in the all-primitive test).
      qrows (NQ, 20): the stack walk's leaf quads in leaf order [corner, u,
        v, normal, d, w, original unified id, 0 0 0] (none in the lane
        walk, which takes spheres only).
    A leaf's spheres come first in flat.bvh_prims (_segregate_leaves), so
    each leaf is one run of sphere rows and one run of quad rows."""
    mode: str
    box: torch.Tensor
    link: torch.Tensor
    pad: torch.Tensor
    srows: torch.Tensor
    qrows: torch.Tensor
    octant: torch.Tensor | None = None


def bvh_box_pad(flat: FlatScene) -> torch.Tensor:
    """The BVH walks' box widening, (B,) per node: BOX_PAD x (1 + the
    larger of the chunk scan's scale and the node's own largest |coordinate|).
    The chunk scan's scale is the largest |coordinate| of the boxes it culls
    (every active sphere but its VSCAN_BIG big ones), here with every active
    quad, since the BVH culls every quad. The BVH culls the big spheres too:
    a node's own coordinate bounds that of every primitive under it, so each
    primitive's ancestors are widened at least by the BOX_PAD bound at its
    own scale (a ground sphere of radius 1e6 widens the few nodes above it
    by 2e3), and by no less than the chunk scan widens its boxes."""
    active, lo, hi, _, is_big = _sphere_boxes(flat)
    culled = (active & ~is_big)[:, None]
    scale = torch.where(culled, torch.maximum(lo.abs(), hi.abs()),
                        0.0).amax() if lo.shape[0] else 0.0
    qact = flat.quad_active
    if bool(qact.any()):
        corner, u, v = flat.quad_corner, flat.quad_u, flat.quad_v
        pts = torch.stack([corner, corner + u, corner + v, corner + u + v])
        scale = max(scale, pts.abs().amax(dim=(0, 2))[qact].max())
    n_lo, n_hi = flat.bvh_bbox_min, flat.bvh_bbox_max
    # an empty node (the tree of a scene without primitives) keeps its box
    node = torch.where((n_lo <= n_hi).all(1),
                       torch.maximum(n_lo.abs(), n_hi.abs()).amax(1), 0.0)
    node = torch.clamp(node.double(), min=float(scale))
    return (BOX_PAD * (1.0 + node)).to(torch.float32)


def octant_links(flat: FlatScene) -> torch.Tensor:
    """(8, B, 2) int32: the skip links [hit, miss] of each ray octant o
    (bit k of o: the direction's sign bit along axis k) over flat's tree.
    In octant o an inner node's first child is the one nearer along the
    node's split axis (flat.bvh_axis) for o's sign on it: the child whose
    box centre is lower there for a positive sign, higher for a negative
    one, the left child on a tie (the builder does not keep the left child
    low); ordered_skip_links gives the rest (a leaf's hit link is its miss
    link, B ends the walk)."""
    left = flat.bvh_left.cpu().numpy().astype(np.int64)
    right = flat.bvh_right.cpu().numpy().astype(np.int64)
    leaf = flat.bvh_leaf.cpu().numpy()
    axis = np.clip(flat.bvh_axis.cpu().numpy().astype(np.int64), 0, 2)
    # twice the box centres, in float64: the sum of float32 bounds is exact
    mid = (flat.bvh_bbox_min.cpu().numpy().astype(np.float64)
           + flat.bvh_bbox_max.cpu().numpy().astype(np.float64))
    rows = np.arange(left.shape[0])
    cl = mid[np.where(leaf, rows, left), axis]
    cr = mid[np.where(leaf, rows, right), axis]
    neg = (np.arange(N_OCTANTS)[:, None] >> axis[None]) & 1
    left_first = np.where(neg == 1, cl[None] >= cr[None],
                          cl[None] <= cr[None])
    hit, miss = ordered_skip_links(left, right, leaf, left_first)
    return torch.from_numpy(np.stack([hit, miss], 2)).to(flat.device)


def pack_bvh_tables(flat: FlatScene, mode: str) -> BvhTables:
    """The tables of a BVH walk, mode "stack" (K11) or "lane" (K12; a
    scene without quads), of a scene compiled with use_bvh (see
    BvhTables). Raises for another mode or scene, and for a tree deeper
    than the stack walk's STACK_DEPTH allows (ops/bvh.py::check_depth)."""
    if mode not in BVH_MODES:
        raise ValueError(f"unknown BVH mode {mode!r} ({BVH_MODES})")
    if not flat.use_bvh:
        raise ValueError("the BVH walks need a scene compiled with use_bvh")
    f32 = torch.float32
    dev = flat.device
    S = flat.sph_center.shape[0]
    left = flat.bvh_left.to(torch.int64)
    right = flat.bvh_right.to(torch.int64)
    leaf = flat.bvh_leaf
    check_depth(left.cpu().numpy(), right.cpu().numpy(), leaf.cpu().numpy())
    prims = flat.bvh_prims.to(torch.int64)
    B = left.shape[0]
    if B >= 1 << 24 or prims.shape[0] >= 1 << 24:
        raise ValueError(f"{B} nodes / {prims.shape[0]} primitives: the "
                         "node rows hold ids as exact float32 integers")
    # the leaves' runs cover the prim list, but for the one-entry list of
    # a tree without prims
    real = torch.full(prims.shape, bool(torch.where(leaf, right, 0).sum()),
                      device=dev)
    is_sph = real & (prims < S)
    is_quad = real & (prims >= S)
    # a leaf at offset o: its spheres start at the spheres before o
    sph_before = torch.cumsum(is_sph.to(torch.int64), 0) - is_sph.to(
        torch.int64)
    quad_before = torch.cumsum(is_quad.to(torch.int64), 0) - is_quad.to(
        torch.int64)
    leaf_off = torch.clamp(torch.where(leaf, left, 0), max=prims.shape[0] - 1)
    nsph = torch.where(leaf, flat.bvh_leaf_sph.to(torch.int64), 0)
    s_off = torch.where(leaf, sph_before[leaf_off], 0)
    q_off = torch.where(leaf, quad_before[leaf_off], 0)
    nq = torch.where(leaf, right - nsph, 0)
    if mode == "lane" and bool(is_quad.any()):
        raise ValueError("the lane BVH (K12) takes spheres only")
    link = torch.stack([leaf.to(torch.int64), flat.bvh_axis.to(torch.int64),
                        torch.where(leaf, s_off, left),
                        torch.where(leaf, nsph, right), q_off, nq], 1)
    sid = prims[is_sph]
    rad = flat.sph_radius[sid]
    srows = torch.cat([flat.sph_center[sid], flat.sph_cdelta[sid],
                       rad[:, None],
                       torch.where(rad > 0.0, sid, -1).to(f32)[:, None]], 1)
    qid = prims[is_quad] - S
    qrows = torch.cat([flat.quad_corner[qid], flat.quad_u[qid],
                       flat.quad_v[qid], flat.quad_normal[qid],
                       flat.quad_d[qid][:, None], flat.quad_w[qid],
                       (qid + S).to(f32)[:, None],
                       torch.zeros(qid.shape[0], 3, dtype=f32, device=dev)],
                      1)
    box = torch.cat([flat.bvh_bbox_min, flat.bvh_bbox_max], 1).to(f32)
    return BvhTables(mode=mode, box=box, link=link.to(f32),
                     pad=bvh_box_pad(flat), srows=srows.contiguous(),
                     qrows=qrows.contiguous(),
                     octant=octant_links(flat) if mode == "lane" else None)


def _bvh_nodes(bt: BvhTables) -> torch.Tensor:
    """(B, 6) the nodes' widened boxes [lo xyz, hi xyz]."""
    pad = bt.pad[:, None]
    return torch.cat([bt.box[:, :3] - pad, bt.box[:, 3:] + pad], 1)


def _bvh_lane_rows(bt: BvhTables) -> torch.Tensor:
    """(B, BVH_LANE_COLS) float32 the lane walk's node rows: the widened
    box, the node's sphere run [first sphere row, sphere count], then the
    int32 bits of its octant links, [hit, miss] for octant 0, 1, ..., 7."""
    B = bt.box.shape[0]
    runs = torch.where(bt.link[:, :1] == 1, bt.link[:, 2:4], 0.0)
    links = bt.octant.to(torch.int32).permute(1, 0, 2).reshape(
        B, 2 * N_OCTANTS).contiguous().view(torch.float32)
    return torch.cat([_bvh_nodes(bt), runs, links], 1)


def _lane_row_links(rows: torch.Tensor) -> torch.Tensor:
    """(B, 8, 2) int64 the octant links in lane rows (_bvh_lane_rows)."""
    return rows[:, 8:].contiguous().view(torch.int32).reshape(
        -1, N_OCTANTS, 2).to(torch.int64)


def _bvh_stack_rows(bt: BvhTables) -> torch.Tensor:
    """(B + 1, BVH_STACK_COLS) rows of the stack walk (K11), the usual GPU
    BVH2 layout (Aila and Laine, HPG 2009): row i < B is tree node i's, an
    inner node's [its left child's widened box (lo xyz, hi xyz), its right
    child's, the left link, the right link, 0, 0], a leaf's [first sphere
    row, sphere count, first quad row, quad count, 0...]; a link is the
    child's node id, or -(id + 1) for a leaf. Row B enters the tree: an
    inner row whose left child is the root (its widened box, tested once)
    and whose right child is empty ([BIG, -BIG], never met). The boxes are
    _bvh_nodes' (each node's own box widened by its own pad)."""
    nodes = _bvh_nodes(bt)
    B = nodes.shape[0]
    link = bt.link.to(torch.int64)
    leaf = link[:, 0] == 1
    empty = torch.tensor([BIG] * 3 + [-BIG] * 3, dtype=torch.float32,
                         device=nodes.device)

    def child_link(c):
        return torch.where(leaf[c], -(c + 1), c).to(torch.float32)

    left = torch.where(leaf, 0, link[:, 2])
    right = torch.where(leaf, 0, link[:, 3])
    zero = torch.zeros(B, 2, dtype=torch.float32, device=nodes.device)
    inner = torch.cat([nodes[left, :6], nodes[right, :6],
                       child_link(left)[:, None], child_link(right)[:, None],
                       zero], 1)
    runs = torch.cat([bt.link[:, 2:6], torch.zeros(
        B, BVH_STACK_COLS - 4, dtype=torch.float32, device=nodes.device)], 1)
    root = torch.zeros(1, dtype=torch.int64, device=nodes.device)
    entry = torch.cat([nodes[0, :6], empty, child_link(root),
                       child_link(root), zero[0]])
    return torch.cat([torch.where(leaf[:, None], runs, inner),
                      entry[None]])


def _bvh_buffer(bt: BvhTables):
    """One float32 buffer of what a BVH walk reads beside the scene tables:
    the node rows (the stack walk's _bvh_stack_rows, the lane walk's
    _bvh_lane_rows), the sphere rows and the quad rows (each 16-byte
    aligned, for float4 loads); and the kernel's BvParams fields (n_nodes
    counts the rows: B + 1 for the stack walk, whose entry row is the
    last)."""
    nodes = (_bvh_stack_rows(bt) if bt.mode == "stack"
             else _bvh_lane_rows(bt))
    parts = [nodes.reshape(-1), bt.srows.reshape(-1), bt.qrows.reshape(-1)]
    fields = dict(n_nodes=nodes.shape[0], n_srows=bt.srows.shape[0],
                  n_qrows=bt.qrows.shape[0], off_nodes=0,
                  off_srows=parts[0].numel(),
                  off_qrows=parts[0].numel() + parts[1].numel())
    return torch.cat(parts).contiguous(), fields


def _take_closer(t, ids, sel, best_t, best):
    """take_closer per ray where sel: the closer of (t, id) and the running
    winner, ties to the lower id."""
    take = sel & (t < BIG * 0.5) & ((t < best_t)
                                     | ((t == best_t) & (ids < best)))
    return torch.where(take, t, best_t), torch.where(take, ids, best)


def _leaf_tests(bt, idx, s_off, n_s, q_off, n_q, o, d, tm, best_t, best):
    """The rays idx test their leaves' sphere rows [s_off, s_off + n_s) and
    quad rows [q_off, q_off + n_q) (at most MAX_LEAF of each), as the
    kernel's scan_spheres / scan_quads do, with ops/intersect.py's float32
    operations in its order (the all-primitive test's), one row a ray."""
    bt_, bi = best_t[idx], best[idx]
    oi, di, ti = o[idx], d[idx], tm[idx]
    for k in range(MAX_LEAF):
        sel = k < n_s
        if bool(sel.any()) and bt.srows.shape[0]:
            r = bt.srows[torch.clamp(s_off + k, max=bt.srows.shape[0] - 1)]
            real = r[:, 7] >= 0
            t = intersect.sphere_roots(r[:, 0:3], r[:, 3:6], r[:, 6], real,
                                       oi, di, ti)
            bt_, bi = _take_closer(t, r[:, 7].to(torch.int64), sel & real,
                                   bt_, bi)
        sel = k < n_q
        if bool(sel.any()) and bt.qrows.shape[0]:
            r = bt.qrows[torch.clamp(q_off + k, max=bt.qrows.shape[0] - 1)]
            t = intersect.quad_hits(r[:, 0:3], r[:, 3:6], r[:, 6:9],
                                    r[:, 9:12], r[:, 12], r[:, 13:16], sel,
                                    oi, di)
            bt_, bi = _take_closer(t, r[:, 16].to(torch.int64), sel, bt_, bi)
    best_t[idx], best[idx] = bt_, bi


def bvh_stack_select_reference(bt: BvhTables, o, d, tm):
    """The plain version of the stack BVH's selection (K11), over the same
    rows (_bvh_stack_rows): from the entry row, each ray at an inner row
    tests both children's widened boxes against [T_MIN, its best t], goes
    on into the met one with the nearer entry t (the left on a tie) and
    pushes the other, if met, with its entry t; at a leaf it tests the
    leaf's spheres then quads; then it pops entries until one's entry t is
    at most its best t (that box is met still) or the stack is empty. For
    rays o, d (n, 3) at times tm (n,). Returns (the winner's original
    unified id, -1 on a miss; its t, BIG on a miss): the all-primitive
    closest_hit's, bit for bit (vscan_select_reference's rule)."""
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    inv_d = _inverse_dir(d)
    rows = _bvh_stack_rows(bt)
    pop = -(1 << 40)   # a ray's node when it pops next
    node = torch.full((n,), rows.shape[0] - 1, dtype=torch.int64,
                      device=dev)
    stack_id = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((n, STACK_DEPTH), dtype=torch.float32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    while bool(live.any()):
        r = torch.nonzero(live & (node >= 0)).squeeze(1)
        if r.numel():
            row = rows[node[r]]
            hl, tl = _box_entry(row[:, 0:6], o[r], inv_d[r], best_t[r])
            hr, tr = _box_entry(row[:, 6:12], o[r], inv_d[r], best_t[r])
            cl, cr = row[:, 12].to(torch.int64), row[:, 13].to(torch.int64)
            lfirst = tl <= tr
            both = hl & hr
            j = r[both]
            stack_id[j, sp[j]] = torch.where(lfirst, cr, cl)[both]
            stack_t[j, sp[j]] = torch.where(lfirst, tr, tl)[both]
            sp[j] += 1
            near = torch.where(both, torch.where(lfirst, cl, cr),
                               torch.where(hl, cl, cr))
            node[r] = torch.where(hl | hr, near, pop)
        r = torch.nonzero(live & (node < 0) & (node != pop)).squeeze(1)
        if r.numel():
            run = rows[-node[r] - 1, 0:4].to(torch.int64)
            _leaf_tests(bt, r, run[:, 0], run[:, 1], run[:, 2], run[:, 3],
                        o, d, tm, best_t, best)
            node[r] = pop
        r = torch.nonzero(live & (node == pop)).squeeze(1)
        if r.numel():
            done = sp[r] == 0
            live[r[done]] = False
            r = r[~done]
            sp[r] -= 1
            met = stack_t[r, sp[r]] <= best_t[r]
            node[r[met]] = stack_id[r, sp[r]][met]
    return best, best_t


def ray_octants(d) -> torch.Tensor:
    """(n,) int64 octant of each direction (n, 3): bit k set where d's
    sign bit is set along axis k (-0.0 counts as negative), as the lane
    walk's kernel takes it."""
    bits = torch.signbit(d).to(torch.int64)
    return bits[:, 0] | (bits[:, 1] << 1) | (bits[:, 2] << 2)


def bvh_lane_select_reference(bt: BvhTables, o, d, tm):
    """The plain version of the lane BVH's selection (K12), over the same
    rows (_bvh_lane_rows): each ray walks its octant's skip links (near
    child first) from the root, taking the hit link where the node's
    widened box meets [T_MIN, the ray's best t] (testing a leaf's spheres
    there) and the miss link elsewhere, until the links end; the results
    as bvh_stack_select_reference's."""
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    inv_d = _inverse_dir(d)
    rows = _bvh_lane_rows(bt)
    links = _lane_row_links(rows)
    oct_ = ray_octants(d)
    B = rows.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    while bool((node < B).any()):
        live = torch.nonzero(node < B).squeeze(1)
        nd = node[live]
        row = rows[nd]
        go = _box_reaches(row[:, :6], o[live], inv_d[live], best_t[live])
        lk = links[nd, oct_[live]]
        run = row[:, 6:8].to(torch.int64)
        leafy = go & (run[:, 1] > 0)
        if bool(leafy.any()):
            j = leafy.nonzero().squeeze(1)
            zero = torch.zeros_like(j)
            _leaf_tests(bt, live[j], run[j, 0], run[j, 1], zero, zero, o, d,
                        tm, best_t, best)
        node[live] = torch.where(go, lk[:, 0], lk[:, 1])
    return best, best_t


def bvh_select_kernel(prepared: "KernelInputs", o, d, tm):
    """The BVH walk of `prepared` (a BVH mode's packing) alone on the
    card, one ray a thread: for rays o, d (n, 3) at times tm (n,) on the
    packing's device, (the winner's original unified id, -1 on a miss; its
    t, BIG on a miss), as bvh_stack_select_reference /
    bvh_lane_select_reference give them. For the checks on the card; each
    launch adds one to bvh_select_kernel.launches."""
    if prepared.mode not in BVH_MODES:
        raise ValueError(f"packed for {prepared.mode!r}, not a BVH walk")
    dev = prepared.btab.device
    rays = torch.cat([o, d, tm[:, None]], 1).to(
        device=dev, dtype=torch.float32).contiguous()
    n = rays.shape[0]
    best = torch.empty(n, dtype=torch.int32, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bvh_select[prepared.mode](
            ctypes.byref(_BvParams(**prepared.bfields)),
            ctypes.c_void_p(prepared.btab.data_ptr()),
            ctypes.c_void_p(rays.data_ptr()), n,
            ctypes.c_void_p(best.data_ptr()), ctypes.c_void_p(t.data_ptr()),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"BVH selection launch failed: CUDA error {err}")
    bvh_select_kernel.launches += 1
    return best.to(torch.int64), t


bvh_select_kernel.launches = 0


# ------------------------------------------------------------ lane layout
def lane_count(n_pix: int) -> int:
    return -(-n_pix // LANE_BLOCK) * LANE_BLOCK


def _identity_pixels(n_lanes: int, n_pix: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(n_lanes, device=device), max=n_pix - 1)


def _image_from_lanes(rad, width: int, height: int) -> torch.Tensor:
    """(3, n_lanes) lane radiance -> (height, width, 3) image."""
    return rad[:, :width * height].T.reshape(height, width, 3)


def _check_carry(carry, pix_lanes, n_lanes: int, rows: int = CARRY_ROWS):
    if carry is not None and tuple(carry.shape) != (rows, n_lanes):
        raise ValueError(f"carry has shape {tuple(carry.shape)}, expected "
                         f"({rows}, {n_lanes})")
    if pix_lanes is not None and tuple(pix_lanes.shape) != (n_lanes,):
        raise ValueError(f"pix_lanes has shape {tuple(pix_lanes.shape)}, "
                         f"expected ({n_lanes},)")


def _check_row0(row0) -> int:
    """row0 as an int: the first image row of a shard, 0 or more."""
    if int(row0) != row0 or row0 < 0:
        raise ValueError(f"row0 must be a row index >= 0, got {row0!r}")
    return int(row0)


def _check_iters(iters, n_lanes: int, device):
    if iters is not None and (tuple(iters.shape) != (n_lanes,)
                              or iters.dtype != torch.int32
                              or iters.device != device):
        raise ValueError(f"iters must be an int32 ({n_lanes},) tensor on "
                         f"{device}")


def cotangent_lanes(cotangent, *, width: int, height: int, pix_lanes=None):
    """The cotangent as (3, n_lanes) float32 lane planes. Under pix_lanes it
    comes in that layout already (the compacted driver permutes it with the
    lanes); otherwise it is the (height, width, 3) image cotangent, and the
    pad lanes get zero: they repeat the last pixel, which must not count
    twice (wavefront_pallas.py:3538-3542)."""
    n_pix = width * height
    n_lanes = lane_count(n_pix)
    if pix_lanes is not None:
        if tuple(cotangent.shape) != (3, n_lanes):
            raise ValueError(f"cotangent under pix_lanes has shape "
                             f"{tuple(cotangent.shape)}, expected "
                             f"(3, {n_lanes})")
        return cotangent.to(torch.float32)
    if tuple(cotangent.shape) != (height, width, 3):
        raise ValueError(f"cotangent has shape {tuple(cotangent.shape)}, "
                         f"expected ({height}, {width}, 3)")
    g = torch.zeros(3, n_lanes, dtype=torch.float32,
                    device=cotangent.device)
    g[:, :n_pix] = cotangent.reshape(n_pix, 3).T
    return g


def _pass_result(rad, st, *, cap, pix_lanes, width, height):
    """The JAX driver's return convention: (radiance, carry) when capped,
    raw radiance planes under an explicit lane permutation, else the
    image."""
    if cap:
        return rad, st
    if pix_lanes is not None:
        return rad
    return _image_from_lanes(rad, width, height)


def _grad_result(rad, dg_tex, dg_hard, st, *, cap, pix_lanes, width,
                 height):
    """The grad pass's: (radiance, dG_tex, dG_hard, carry) when capped,
    (radiance planes, dG_tex, dG_hard) under pix_lanes, else (image,
    dG_tex, dG_hard)."""
    if cap:
        return rad, dg_tex, dg_hard, st
    if pix_lanes is not None:
        return rad, dg_tex, dg_hard
    return _image_from_lanes(rad, width, height), dg_tex, dg_hard


def _grad_layout(flat: FlatScene, cot, hard_slots, want_tex,
                 force_planes: bool = False) -> tuple:
    """(weight-plane rows 3*NT or 0, hard slots K, suffix tier) of a pass:
    0, 0, False for the forward (cot None). Its carry has CARRY_ROWS +
    3*NT (weight planes) + 9*K rows, then the suffix tier's
    (_carry_rows, _kernel_carry_rows). Raises for a grad pass with nothing
    to differentiate."""
    if cot is None:
        return 0, 0, False
    if not want_tex and not hard_slots:
        raise ValueError("a grad pass needs want_tex or hard_slots")
    form = tex_form(flat, want_tex, force_planes)
    n_wp = 3 * flat.tex_type.shape[0] if form == "planes" else 0
    return n_wp, len(hard_slots), form == "suffix"


def _carry_rows(n_wp: int, K: int, suffix: bool) -> int:
    return CARRY_ROWS + n_wp + 9 * K + (SUFFIX_ROWS if suffix else 0)


def _kernel_carry_rows(n_wp: int, K: int, suffix: bool,
                       max_depth: int) -> int:
    """The grad kernel's carry rows: _carry_rows' with the single-pass
    suffix tier's state and records in place of the two-phase state."""
    return (CARRY_ROWS + n_wp + 9 * K
            + (SFX_STATE + SFX_REC * max_depth if suffix else 0))


@spanned("rt.memcheck")
def check_free(device, need: int, what: str):
    """Raise if `need` bytes do not fit what the device has free and what
    torch's allocator holds unused."""
    free = (torch.cuda.mem_get_info(device)[0]
            + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    if need > free:
        raise RuntimeError(f"{what} ({need / 2**30:.2f} GiB) exceeds the "
                           f"device's {free / 2**30:.2f} GiB free")


def _slot_tangents(flat: FlatScene, hard_slots) -> tuple:
    """The hard slots' unit tangents of HARD_FIELDS' tables, batched over
    the slots: slot k is 1 at its own entry and 0 elsewhere."""
    tans = {f: torch.zeros((len(hard_slots),) + tuple(getattr(flat, f).shape),
                           dtype=torch.float32, device=flat.device)
            for f in HARD_FIELDS}
    for k, slot in enumerate(hard_slots):
        f, idx = slot_index(slot)
        tans[f][(k,) + (idx if isinstance(idx, tuple) else (idx,))] = 1.0
    return tuple(tans[f] for f in HARD_FIELDS)


def _hard_tangents(flat: FlatScene, org, dr, tm, th, alive, u, u_med,
                   background, sky_gradient, slot_tans, dst):
    """The JAX kernel's tangent-bundle step (wavefront_pallas.py:2411-2542):
    torch.func.jvp of one bounce (ops/integrator.py::bounce_step) as a
    function of the hard parameter tables and the ray state (o, d, th),
    batched over the K slots with torch.func.vmap. Slot k's tangent is its
    unit table entry (slot_tans) and its tangent planes dst[:, k] (n, K,
    9). The draws, alive mask and ray time are closed over, so they carry
    no tangent: the estimator's detached-sampling derivative. Light rows
    read the sphere tables, so a sphere's slots reach the light sample and
    pdf too. Returns the (K, n, 3) tangents of the radiance increment and
    of the next o, d and th."""
    prim = tuple(getattr(flat, f).detach() for f in HARD_FIELDS) + (
        org, dr, th)

    def physics(fuzz, ior, center, radius, o, d, t):
        sc = dataclasses.replace(flat, mat_fuzz=fuzz, mat_ior=ior,
                                 sph_center=center, sph_radius=radius)
        return bounce_step(sc, o, d, tm, t, alive, u, u_med, background,
                           sky_gradient)[:4]

    def push(*tangents):
        return torch.func.jvp(physics, prim, tangents)[1]

    planes = dst.permute(1, 0, 2)                       # (K, n, 9)
    return torch.func.vmap(push)(*slot_tans, planes[..., 0:3],
                                 planes[..., 3:6], planes[..., 6:9])


# ---------------------------------------------------- plain torch version
def all_primitive(flat: FlatScene) -> FlatScene:
    """The scene as the kernels' plain versions see it: every bounce
    selects over all primitives (ops/intersect.py::closest_hit), whatever
    the kernel mode. On a use_bvh scene the plain engine
    (models/render.py::_render_pass) takes the BVH oracle instead
    (ops/integrator.py::resolve_hit), as the JAX package's does; every
    kernel's selection is the all-primitive one bit for bit, so that is
    what they are held against."""
    return dataclasses.replace(flat, use_bvh=False) if flat.use_bvh else flat


def _wavefront_reference(flat: FlatScene, cam: CameraState, seed,
                         sample_start, *, width, height, n_strata, max_depth,
                         n_samples, sky_gradient, cap, carry, pix_lanes,
                         iters, cot, hard_slots=(), want_tex=True,
                         force_planes=False, row0=0):
    """The persistent lane wavefront in plain torch; with `cot` ((3,
    n_lanes) cotangent lanes) also the JAX grad kernel's tiers: with
    want_tex the tex_color weight planes (wavefront_pallas.py:865-873,
    2565-2603),

        Wp[t, c] = d th_c / d tex_color[t, c], reset to 0 on regeneration,
        Gp[t, c] += g_c * (Wp[t, c] * L_c + [eff == t] * th_c * emitted_c)
            at each radiance event (background L on a miss, emission),
        Wp[t, c] <- (Wp[t, c] * at_c + [eff == t and not dielectric]
                     * th_c) * factor   under the throughput's guard,

    or, past MAX_GRAD_TEXS rows (tex_form), the suffix-radiance tier
    (914-931, 2361-2375, 2545-2559, 2604-2637): each sample runs twice from
    the same draws, phase A tracing it (the image, its path total T) and
    phase B replaying it (its prefix P after each bounce), and at each
    phase-B hit on row t = eff_tex

        dG_tex[t, c] += g_c * ([emits] * th_c
                               + [not dielectric] * (T_c - P_c) / at_c),

    the scatter term 0 where |at_c| <= 1e-8 (so a channel of albedo exactly
    0 gets no scatter gradient: the estimator's known limit); and for the
    hard slots the tangent bundles (875-896, 2395, 2411-2542), in phase A
    only under the suffix tier:

        Dst[k] = d(o, d, th) / d theta_k, reset to 0 on regeneration,
        dG[k] += <g, d radiance increment / d theta_k> every bounce,
        Dst[k] <- the bounce's JVP along (theta_k, Dst[k]) under the
            throughput's guard (_hard_tangents).

    A lane's pixel is row0 * width plus its pixel in the shard (the
    identity layout or pix_lanes, both of the shard's height rows): that
    absolute id keys its draws and places its camera rays.

    Returns (radiance (3, n_lanes), carry or None, dG_tex (NT, 3) or None,
    dG_hard (K,) or None). iters ((n_lanes,) int32), when given, gets one
    added per lane per bounce it traces."""
    flat = all_primitive(flat)
    device = flat.device
    n_pix = width * height
    n_lanes = lane_count(n_pix)
    nt = flat.tex_type.shape[0]
    n_wp, K, suffix = _grad_layout(flat, cot, hard_slots, want_tex,
                                   force_planes)
    _check_carry(carry, pix_lanes, n_lanes, _carry_rows(n_wp, K, suffix))
    _check_iters(iters, n_lanes, device)
    pix = (_identity_pixels(n_lanes, n_pix, device) if pix_lanes is None
           else pix_lanes.to(device=device, dtype=torch.int64)) \
        + _check_row0(row0) * width
    sample_start = int(sample_start)
    background = cam.background

    def camera(p, s):
        keys = rng.ray_keys(seed, p, sample_start + s)
        org, dr, tm = generate_rays(cam, width, p, sample_start + s,
                                    n_strata, keys)
        return org, normalize(dr), tm

    if carry is None:
        sample = torch.zeros(n_lanes, dtype=torch.int64, device=device)
        org, dr, tm = camera(pix, sample)
        th = torch.ones_like(org)
        alive = torch.ones(n_lanes, dtype=torch.bool, device=device)
        work = alive.clone()
        bounce = torch.zeros_like(sample)
        wp = torch.zeros(n_lanes, n_wp, dtype=torch.float32, device=device)
        dst = torch.zeros(n_lanes, K, 9, dtype=torch.float32, device=device)
        phb = torch.zeros(n_lanes, dtype=torch.bool, device=device)
        tot = torch.zeros(n_lanes, 3, dtype=torch.float32, device=device)
        pre = torch.zeros_like(tot)
    else:
        carry = carry.to(device=device, dtype=torch.float32)
        work, alive = carry[0] > 0.5, carry[1] > 0.5
        bounce, sample = carry[2].to(torch.int64), carry[3].to(torch.int64)
        tm = carry[4].clone()
        org, dr, th = carry[5:8].T.clone(), carry[8:11].T.clone(), \
            carry[11:14].T.clone()
        wp = carry[CARRY_ROWS:CARRY_ROWS + n_wp].T.clone()
        sb = CARRY_ROWS + n_wp + 9 * K
        dst = carry[CARRY_ROWS + n_wp:sb].T.reshape(n_lanes, K, 9).clone()
        phb = carry[sb] > 0.5 if suffix else torch.zeros_like(work)
        tot = carry[sb + 1:sb + 4].T.clone() if suffix else None
        pre = carry[sb + 4:sb + 7].T.clone() if suffix else None
    rad = torch.zeros(n_lanes, 3, dtype=torch.float32, device=device)
    gp = torch.zeros(n_lanes, n_wp, dtype=torch.float32, device=device)
    dgh = torch.zeros(n_lanes, K, dtype=torch.float32, device=device)
    acc = torch.zeros(nt, 3, dtype=torch.float32, device=device)
    rows = torch.arange(nt, device=device)
    slot_tans = _slot_tangents(flat, hard_slots) if K else None

    it = 0
    while cap == 0 or it < cap:
        idx = torch.nonzero(work).squeeze(1)
        if idx.numel() == 0:
            break
        p, s, b, a = pix[idx], sample[idx], bounce[idx], alive[idx]
        o, d, t_, h = org[idx], dr[idx], tm[idx], th[idx]
        # a finished path restarts on the pixel's next stratified sample;
        # under the suffix tier a finished phase A first replays its sample
        # as phase B, and a finished phase B moves on to the next sample
        regen = ~a
        if suffix:
            ph = phb[idx]
            to_a = regen & ph
            s = torch.where(to_a, s + 1, s)
            ph = torch.where(regen, ~ph, ph)
            t_tot = torch.where(to_a[:, None], 0.0, tot[idx])
            t_pre = torch.where(regen[:, None], 0.0, pre[idx])
        else:
            s = torch.where(regen, s + 1, s)
        go, gd, gt = camera(p, s)
        o = torch.where(regen[:, None], go, o)
        d = torch.where(regen[:, None], gd, d)
        t_ = torch.where(regen, gt, t_)
        h = torch.where(regen[:, None], 1.0, h)
        b = torch.where(regen, 0, b)
        a = a | regen

        keys = rng.ray_keys(seed, p, sample_start + s)
        u = rng.bounce_uniforms(keys, b)
        u_med = medium_uniforms(flat, keys, b)
        out = bounce_step(flat, o, d, t_, h, a, u, u_med, background,
                          sky_gradient, record=n_wp > 0 or suffix)
        drad, o_new, d_new, h_new, a_new = out[:5]
        if n_wp or K or suffix:
            g = cot[:, idx].T                             # (n, 3)
        if suffix:
            # phase A owns the image and the path total T, phase B the
            # prefix P after this bounce; B routes its hit's events
            in_a = ~ph
            t_tot = t_tot + torch.where(in_a[:, None], drad, 0.0)
            t_pre = t_pre + torch.where(in_a[:, None], 0.0, drad)
            drad = torch.where(in_a[:, None], drad, 0.0)
            ev = out[5]
            emit_b = ev["emit_on"] & ph
            scat_b = ev["live_hit"] & ~ev["is_diel"] & ph
            at = ev["at"]
            ok = at.abs() > 1e-8
            div = torch.where(ok, (t_tot - t_pre) / torch.where(ok, at, 1.0),
                              0.0)
            val = g * (torch.where(emit_b[:, None], h, 0.0)
                       + torch.where(scat_b[:, None], div, 0.0))
            sel = (emit_b | scat_b) & (ev["eff_tex"] >= 0)
            acc.index_add_(0, ev["eff_tex"][sel], val[sel])
            tot[idx], pre[idx], phb[idx] = t_tot, t_pre, ph
        if n_wp:
            ev = out[5]
            gt3 = g[:, None, :]                           # (n, 1, 3)
            th_c = h[:, None, :]                          # pre-scatter th
            # a fresh path starts with throughput 1: no tex dependence
            w = torch.where(regen[:, None], 0.0, wp[idx]).view(-1, nt, 3)
            ind = (ev["eff_tex"][:, None] == rows)[:, :, None]
            gp[idx] += (
                torch.where(ev["miss"][:, None, None],
                            gt3 * w * ev["sb"][:, None, :], 0.0)
                + torch.where(ev["emit_on"][:, None, None],
                              gt3 * (w * ev["tcol"][:, None, :]
                                     + torch.where(ind, th_c, 0.0)), 0.0)
            ).reshape(-1, n_wp)
            w_new = (w * ev["at"][:, None, :]
                     + torch.where(ind & ~ev["is_diel"][:, None, None],
                                   th_c, 0.0)) * ev["factor"][:, None, None]
            wp[idx] = torch.where(a_new[:, None, None], w_new,
                                  w).reshape(-1, n_wp)
        if K:
            # a fresh path starts at the camera: no parameter dependence
            ds = torch.where(regen[:, None, None], 0.0, dst[idx])
            # under the suffix tier phase B repeats phase A's events: the
            # tangents run in phase A only (B's planes stay 0)
            j = torch.nonzero(~ph).squeeze(1) if suffix else slice(None)
            if not suffix or j.numel():
                t_rad, t_o, t_d, t_th = _hard_tangents(
                    flat, o[j], d[j], t_[j], h[j], a[j], u[j],
                    None if u_med is None else u_med[j], background,
                    sky_gradient, slot_tans, ds[j])
                dgh[idx[j]] += (t_rad * g[j][None]).sum(-1).T
                new = torch.cat([t_o, t_d, t_th], dim=-1).permute(1, 0, 2)
                ds[j] = torch.where(a_new[j][:, None, None], new, ds[j])
            dst[idx] = ds
        rad[idx] += drad
        b = b + 1
        a = a_new & (b < max_depth)
        org[idx], dr[idx], tm[idx], th[idx] = o_new, d_new, t_, h_new
        sample[idx], bounce[idx], alive[idx] = s, b, a
        work[idx] = a | (s + 1 < n_samples)
        if suffix:
            # a finished phase-A path still owes its replay
            work[idx] |= ~ph
        if iters is not None:
            iters[idx] += 1
        it += 1

    st = None
    if cap:
        f32 = torch.float32
        st = torch.cat([work.to(f32)[None], alive.to(f32)[None],
                        bounce.to(f32)[None], sample.to(f32)[None], tm[None],
                        org.T, dr.T, th.T, wp.T,
                        dst.reshape(n_lanes, 9 * K).T]
                       + ([phb.to(f32)[None], tot.T, pre.T] if suffix
                          else []))
    dg_tex = acc if suffix else (gp.sum(0).reshape(nt, 3) if n_wp else None)
    dg_hard = dgh.sum(0) if cot is not None else None
    return rad.T.contiguous(), st, dg_tex, dg_hard


def render_pass_reference(flat: FlatScene, cam: CameraState, seed,
                          sample_start, *, width: int, height: int,
                          n_strata: int, max_depth: int, n_samples: int,
                          sky_gradient: bool = False, cap: int = 0,
                          carry=None, pix_lanes=None, iters=None,
                          row0: int = 0):
    """Sum of n_samples stratified samples per pixel by a persistent lane
    wavefront in plain torch — the kernel's semantics, lane for lane. With
    row0 > 0 the pass renders the image rows [row0, row0 + height) of an
    image `width` wide (a tile shard, parallel/mesh.py): the same rays and
    draws as those rows of the whole image's pass.

    Each loop iteration advances every lane that still has work by one
    bounce; a lane whose path ended restarts on its pixel's next sample. A
    lane with no work left is frozen. cap > 0 stops after `cap` iterations
    and returns (radiance (3, n_lanes), carry (14, n_lanes)); carry resumes
    from such a state (same sample_start); pix_lanes ((n_lanes,) pixel ids)
    replaces the identity lane layout and returns raw radiance planes.
    iters, when given, counts each lane's bounces. Each call adds one to
    render_pass_reference.calls."""
    render_pass_reference.calls += 1
    rad, st, _, _ = _wavefront_reference(
        flat, cam, seed, sample_start, width=width, height=height,
        n_strata=n_strata, max_depth=max_depth, n_samples=n_samples,
        sky_gradient=sky_gradient, cap=cap, carry=carry, pix_lanes=pix_lanes,
        iters=iters, cot=None, row0=row0)
    return _pass_result(rad, st, cap=cap, pix_lanes=pix_lanes, width=width,
                        height=height)


render_pass_reference.calls = 0


def render_pass_grad_reference(flat: FlatScene, cam: CameraState, seed,
                               sample_start, *, width: int, height: int,
                               n_strata: int, max_depth: int,
                               n_samples: int, cotangent,
                               hard_slots: tuple = (), want_tex: bool = True,
                               sky_gradient: bool = False, cap: int = 0,
                               carry=None, pix_lanes=None, iters=None,
                               force_planes: bool = False, row0: int = 0):
    """The plain version of the grad kernel (K3, K4, K8 and their
    chunk-scan instances: the plain pass tests every primitive in every
    mode): render_pass_reference's pass plus, for g the cotangent, dG_tex =
    d<g, radiance sum>/d tex_color (NT, 3) by forward-mode weight planes or,
    past MAX_GRAD_TEXS rows, the suffix-radiance tier (tex_form;
    force_planes takes the weight planes at any count) (want_tex; None
    without) and dG_hard = d<g, radiance sum>/d theta_k (K,) for the hard
    slots (hard_param_slots) by tangent bundles, the JVP of each bounce.
    The image is the forward pass's, path for path (the suffix tier traces
    each sample twice: iters counts both phases). The carry has 14 + 3*NT +
    9*K (+ SUFFIX_ROWS) rows (the weight and tangent planes and the suffix
    state ride it); the cotangent is
    (height, width, 3), or (3, n_lanes) lane planes under pix_lanes
    (cotangent_lanes). Returns (image, dG_tex, dG_hard), (radiance planes,
    dG_tex, dG_hard) under pix_lanes, (radiance, dG_tex, dG_hard, carry)
    when capped. row0 as render_pass_reference's (the cotangent is the
    shard's). Each call adds one to render_pass_grad_reference.calls."""
    render_pass_grad_reference.calls += 1
    cot = cotangent_lanes(cotangent, width=width, height=height,
                          pix_lanes=pix_lanes).to(flat.device)
    rad, st, dg_tex, dg_hard = _wavefront_reference(
        flat, cam, seed, sample_start, width=width, height=height,
        n_strata=n_strata, max_depth=max_depth, n_samples=n_samples,
        sky_gradient=sky_gradient, cap=cap, carry=carry, pix_lanes=pix_lanes,
        iters=iters, cot=cot, hard_slots=tuple(hard_slots),
        want_tex=want_tex, force_planes=force_planes, row0=row0)
    return _grad_result(rad, dg_tex, dg_hard, st, cap=cap,
                        pix_lanes=pix_lanes, width=width, height=height)


render_pass_grad_reference.calls = 0


# ------------------------------------------------------------- the kernel
class _Params(ctypes.Structure):
    """Mirror of csrc/wavefront.cu::WfParams."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "n_lanes", "n_pix", "width", "n_strata", "max_depth", "n_samples",
        "sample_start", "row0")]
        + [("seed_mix", ctypes.c_uint), ("perlin_seed", ctypes.c_uint)]
        + [(n, ctypes.c_int) for n in (
            "sky_gradient", "has_noise", "checker_depth", "cap",
            "S", "Q", "L", "M", "MS", "MQ", "NT", "K", "want_tex", "suffix",
            "off_sph", "off_quad", "off_pmat", "off_light", "off_mati",
            "off_matf", "off_tex", "off_med", "off_lsrc", "off_slot",
            "med_cols", "n_table")]
        + [("inv_strata", ctypes.c_float), ("cam", ctypes.c_float * 22)])


class _VsParams(ctypes.Structure):
    """Mirror of csrc/wavefront.cu::VsParams."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "C_small", "n_big", "Cq", "off_rows", "off_qrows", "off_box",
        "n_box", "off_gbox", "n_gbox")]


class _BvParams(ctypes.Structure):
    """Mirror of csrc/wavefront.cu::BvParams."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_nodes", "n_srows", "n_qrows", "off_nodes", "off_srows",
        "off_qrows")]


class KernelLibrary:
    """The built kernel library: nvcc output of csrc/*.cu, cached in
    BUILD_DIR under a hash of the sources and flags, bound with ctypes."""

    def __init__(self, path: Path, build_log: str, build_seconds: float):
        self.path = path
        self.build_log = build_log
        self.build_seconds = build_seconds
        self.lib = ctypes.CDLL(str(path))
        ptr = ctypes.c_void_p
        self.forward = self.lib.rt_wavefront_forward
        self.forward.restype = ctypes.c_int
        # params, tables, pix_lanes, carry_in, rad_out, carry_out, iters,
        # the slot counter, stream
        self.forward.argtypes = [ctypes.POINTER(_Params)] + [ptr] * 8
        self.forward_vscan = self.lib.rt_wavefront_forward_vscan
        self.forward_vscan.restype = ctypes.c_int
        # params, vparams, tables, vtab, pix_lanes, carry_in, rad_out,
        # carry_out, iters, stream
        self.forward_vscan.argtypes = [ctypes.POINTER(_Params),
                                       ctypes.POINTER(_VsParams)] + [ptr] * 8
        self.grad = self.lib.rt_wavefront_grad
        self.grad.restype = ctypes.c_int
        # params, tables, pix_lanes, carry_in, cotangent, rad_out,
        # carry_out, dg_out, iters, stream
        self.grad.argtypes = [ctypes.POINTER(_Params)] + [ptr] * 9
        self.grad_vscan = self.lib.rt_wavefront_grad_vscan
        self.grad_vscan.restype = ctypes.c_int
        # params, vparams, tables, vtab, pix_lanes, carry_in, cotangent,
        # rad_out, carry_out, dg_out, iters, the tex_color tier's scratch,
        # the multi-row path counter, stream
        self.grad_vscan.argtypes = [ctypes.POINTER(_Params),
                                    ctypes.POINTER(_VsParams)] + [ptr] * 12
        self.adjoint = self.lib.rt_wavefront_adjoint
        self.adjoint.restype = ctypes.c_int
        # params, vparams, tables, vtab, cotangent, rad_out, acc_out, store,
        # iters, NM, stream
        self.adjoint.argtypes = ([ctypes.POINTER(_Params),
                                  ctypes.POINTER(_VsParams)] + [ptr] * 7
                                 + [ctypes.c_int, ptr])
        self.adjoint_seg = self.lib.rt_wavefront_adjoint_seg
        self.adjoint_seg.restype = ctypes.c_int
        # params, vparams, tables, vtab, cotangent, rad_out, acc_out,
        # records, snapshots, iters, NM, seg, nseg_max, stream
        self.adjoint_seg.argtypes = ([ctypes.POINTER(_Params),
                                      ctypes.POINTER(_VsParams)] + [ptr] * 8
                                     + [ctypes.c_int] * 3 + [ptr])
        self.adjoint_probe = self.lib.rt_adjoint_bounce_probe
        self.adjoint_probe.restype = ctypes.c_int
        # params, vparams, tables, vtab, state, keys, cotangent, lam_io,
        # rad_out, acc_out, store, NM, stream
        self.adjoint_probe.argtypes = ([ctypes.POINTER(_Params),
                                        ctypes.POINTER(_VsParams)]
                                       + [ptr] * 9 + [ctypes.c_int, ptr])
        # the BVH walks, forward (cot null) and tex_color grad: params,
        # bparams, tables, btab, pix_lanes, carry_in, cot, rad_out,
        # carry_out, dg_out, iters, the tex_color tier's scratch, the
        # multi-row path counter, stream
        self.bvh = {"stack": self.lib.rt_wavefront_bvh_stack,
                    "lane": self.lib.rt_wavefront_bvh_lane}
        for fn in self.bvh.values():
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(_Params),
                           ctypes.POINTER(_BvParams)] + [ptr] * 12
        # blocks an SM of the chunk scan's weight-plane instances (K3v;
        # True: with tangent bundles, K4v) at a dynamic shared memory in
        # bytes: smem, out
        self.vgrad_planes_blocks = {
            False: self.lib.rt_vgrad_planes_blocks,
            True: self.lib.rt_vgrad_planes_hard_blocks}
        for fn in self.vgrad_planes_blocks.values():
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int, ptr]
        # the walks' selections alone (bvh_select_kernel): bparams, btab,
        # rays, n, winners, ts, stream
        self.bvh_select = {"stack": self.lib.rt_bvh_select_stack,
                           "lane": self.lib.rt_bvh_select_lane}
        for fn in self.bvh_select.values():
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.POINTER(_BvParams)] + [ptr] * 2
                           + [ctypes.c_int] + [ptr] * 3)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


def build_library(build_dir: Path = BUILD_DIR) -> KernelLibrary:
    """Build (or reuse) the kernel library: each part of csrc/wavefront.cu
    compiled by its own nvcc, all started together, then linked. Raises on
    any build failure."""
    source = _CSRC / "wavefront.cu"
    h = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + [str(p) for p in WF_PARTS]).encode())
    out = build_dir / h.hexdigest()[:16] / "librt_wavefront.so"
    if out.exists():
        return KernelLibrary(out, "(cached)", 0.0)
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # build into a temporary directory and rename: concurrent builders race
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, f"wavefront_{p}.o") for p in WF_PARTS]
        procs = [subprocess.Popen(
            [nvcc] + NVCC_FLAGS + [f"-DWF_PART={p}", "-c", "-o", obj,
                                   str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p, obj in zip(WF_PARTS, objs)]
        try:
            logs = [proc.communicate(timeout=600)[0] for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        log = "\n".join(logs)
        if any(proc.returncode for proc in procs):
            raise RuntimeError(f"nvcc failed ({[q.returncode for q in procs]})"
                               f":\n{log}")
        lib = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", lib] + objs, capture_output=True, text=True, timeout=600)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(lib, out)
    return KernelLibrary(out, log, time.perf_counter() - t0)


@functools.cache
def load_library() -> KernelLibrary:
    """The process's one loaded kernel library, built at first use."""
    return build_library()


@dataclass(frozen=True)
class KernelInputs:
    """A scene and camera packed for the kernel: its tables in one device
    buffer (with the slot table of `hard_slots`), and the scene's and
    camera's fields of WfParams; for a vscan scene (`mode`) also the chunk
    scan's buffer `vtab` and its VsParams fields `vfields` (Cq > 0: vquad);
    for a BVH mode ("stack", "lane") the walk's buffer `btab` and its
    BvParams fields `bfields`. `env` is the kernel_env() the mode was
    chosen under. A render (or a training step) packs once and hands the
    result to every launch."""
    tables: torch.Tensor
    fields: dict
    hard_slots: tuple = ()
    mode: str = "unrolled"
    vtab: torch.Tensor | None = None
    vfields: dict | None = None
    btab: torch.Tensor | None = None
    bfields: dict | None = None
    env: tuple = ("0", "0")


@spanned("rt.pack")
def prepare_kernel(flat: FlatScene, cam: CameraState,
                   hard_slots: tuple = (), chunk_scan: bool = False,
                   device=None) -> KernelInputs:
    """Pack `flat` and `cam` (and the slot table of `hard_slots`, for the
    grad kernel) for the kernel wrappers, where the tables live. A scene on
    the card (training's parameters, the progressive renderer's scene) is
    packed there, and its camera and Perlin seed are read back to the host.
    A scene on the host (what render compiles) is packed on the host, its
    camera's floats and Perlin seed taken from the host (`cam` on the host
    reads nothing back), and the buffers go to the CUDA `device` in one
    copy (_send): nothing reads the card. The packing counts in
    prepare_kernel.device_packs or .host_packs. Raises for a scene on the
    host with no CUDA `device`, for one outside the forward kernel's gate,
    and for slots outside hard_slots_gate_reason. A grad launch on a scene
    outside grad_gate_reason raises in _launch. The mode is kernel_mode's
    under the environment now (kernel_env), fixed in the packing;
    chunk_scan packs the chunk scan's tables whatever the scene's mode (the
    adjoint, K9/K10, always runs on them)."""
    on_host = flat.device.type == "cpu"
    target = torch.device(device) if on_host and device is not None \
        else flat.device
    if target.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{target}")
    hard_slots = tuple(hard_slots)
    reason = (hard_slots_gate_reason(flat, len(hard_slots)) if hard_slots
              else kernel_gate_reason(flat))
    if reason is not None:
        raise ValueError(f"scene outside the CUDA kernel's gate: {reason}")
    tables, off, med_cols = _kernel_tables(flat, hard_slots)
    fields = dict(
        perlin_seed=int(flat.perlin_seed.cpu()) & rng.MASK32,
        has_noise=int(bool(flat.has_noise)),
        checker_depth=int(flat.checker_depth),
        S=flat.sph_center.shape[0], Q=flat.quad_corner.shape[0],
        L=flat.n_lights, M=flat.n_mediums,
        MS=flat.med_sph_center.shape[1], MQ=flat.med_quad_corner.shape[1],
        NT=flat.tex_type.shape[0],
        off_sph=off["sph"], off_quad=off["quad"], off_pmat=off["pmat"],
        off_light=off["light"], off_mati=off["mati"], off_matf=off["matf"],
        off_tex=off["tex"], off_med=off["med"], off_lsrc=off["lsrc"],
        off_slot=off["slot"], med_cols=med_cols, n_table=tables.numel(),
        cam=_camera_field(cam))
    env = kernel_env()
    mode = "vscan" if chunk_scan else kernel_mode(flat, env)[0]
    bufs, meta = {"tables": tables}, {}
    if mode in BVH_MODES:
        bufs["btab"], meta["bfields"] = _bvh_buffer(
            pack_bvh_tables(flat, mode))
    elif mode == "vscan":
        bufs["vtab"], meta["vfields"] = _vscan_buffer(
            pack_vscan_tables(flat))
    if on_host:
        bufs = dict(zip(bufs, _send(list(bufs.values()), target)))
        prepare_kernel.host_packs += 1
    else:
        prepare_kernel.device_packs += 1
    return KernelInputs(fields=fields, hard_slots=hard_slots, mode=mode,
                        env=env, **bufs, **meta)


prepare_kernel.host_packs = 0
prepare_kernel.device_packs = 0

# a buffer's start in _send's copy, in floats: 256 bytes, cudaMalloc's
# alignment, so each view's float4 rows load as from a buffer of its own
SEND_ALIGN = 64


def _send(parts, device) -> list:
    """The float32 host buffers `parts` on `device` after one copy: packed
    into one pinned host buffer, each at a SEND_ALIGN boundary, copied
    without waiting on the host, and split into views on the card (the
    caching host allocator keeps the pinned buffer until the copy is
    done)."""
    starts, n = [], 0
    for p in parts:
        starts.append(n)
        n += -(-p.numel() // SEND_ALIGN) * SEND_ALIGN
    buf = torch.empty(n, dtype=torch.float32, pin_memory=True)
    for p, a in zip(parts, starts):
        buf[a:a + p.numel()] = p.reshape(-1)
    dev = buf.to(device, non_blocking=True)
    return [dev[a:a + p.numel()] for p, a in zip(parts, starts)]


def _camera_field(cam: CameraState):
    """WfParams' camera: the 22 floats of cam.scalars(), read back to the
    host from a camera on the card."""
    return (ctypes.c_float * 22)(*cam.scalars().to("cpu").tolist())


def with_camera(prepared: KernelInputs, cam: CameraState) -> KernelInputs:
    """`prepared` with its camera fields taken from `cam`: the tables
    (`tables`, `vtab`, `btab`), their fields and the mode are the input's,
    not packed again. A moved camera reads its 22 floats back to the host
    here, once; the passes after it read none."""
    return dataclasses.replace(
        prepared, fields={**prepared.fields, "cam": _camera_field(cam)})


@spanned("rt.launch")
def _launch(flat: FlatScene, cam: CameraState, seed, sample_start, *,
            width, height, n_strata, max_depth, n_samples, sky_gradient, cap,
            carry, pix_lanes, prepared, iters, cot, hard_slots=(),
            want_tex=True, multi_rows=None, row0=0):
    """Check the inputs, launch the forward (cot None) or the grad kernel on
    the current stream, and raise if the launch fails. Returns (radiance
    (3, n_lanes), carry or None, dG_tex (NT, 3) or None, dG_hard (K,) or
    None)."""
    hard_slots = tuple(hard_slots) if cot is not None else ()
    if prepared is None:
        prepared = prepare_kernel(flat, cam, hard_slots)
    elif cot is not None and tuple(prepared.hard_slots) != hard_slots:
        raise ValueError(f"prepared for hard slots {prepared.hard_slots}, "
                         f"launched with {hard_slots}")
    # the card the tables were packed for (a scene packed on the host
    # stays there: the launch reads only its static fields)
    device = prepared.tables.device
    if kernel_mode(flat)[0] != kernel_mode(flat, prepared.env)[0]:
        # the JAX package's round-3 lesson behind _kernel_env: a packing
        # made under one mode is never launched where another is asked for
        raise ValueError(
            f"packed under RTX_LANE_BVH, RTX_BVH_STACK = {prepared.env} "
            f"({prepared.mode}), launched under {kernel_env()} "
            f"({kernel_mode(flat)[0]}): pack again (prepare_kernel)")
    if cot is not None:
        reason = grad_gate_reason(flat, len(hard_slots), want_tex)
        if reason is not None:
            raise ValueError(f"scene outside the CUDA grad kernel's gate: "
                             f"{reason}")
    n_pix = width * height
    n_lanes = lane_count(n_pix)
    nt = prepared.fields["NT"]
    n_wp, K, suffix = _grad_layout(flat, cot, hard_slots, want_tex)
    n_rows = _kernel_carry_rows(n_wp, K, suffix, max_depth)
    _check_carry(carry, pix_lanes, n_lanes, n_rows)
    _check_iters(iters, n_lanes, device)
    if multi_rows is not None and (multi_rows.device != device
                                   or multi_rows.dtype != torch.int32
                                   or multi_rows.shape != (1,)):
        raise ValueError("multi_rows must be a (1,) int32 tensor on the "
                         "scene's device")
    if n_strata * n_strata + int(sample_start) >= 1 << 24:
        raise ValueError("sample indices must stay below 2^24")

    p = _Params(
        n_lanes=n_lanes, n_pix=n_pix, width=width, n_strata=n_strata,
        max_depth=max_depth, n_samples=n_samples,
        sample_start=int(sample_start), row0=_check_row0(row0),
        seed_mix=rng.mix_seed(seed),
        sky_gradient=int(bool(sky_gradient)), cap=int(cap), K=K,
        want_tex=int(bool(want_tex) and cot is not None),
        suffix=int(suffix),
        inv_strata=float(np.float32(1.0 / n_strata)), **prepared.fields)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    if pix_lanes is not None:
        pix_lanes = pix_lanes.to(device=device, dtype=torch.int32) \
            .contiguous()
    if carry is not None:
        carry = carry.to(device=device, dtype=torch.float32).contiguous()
    scratch = None
    n_scr = _tex_scratch_floats(
        tex_form(flat, want_tex) if cot is not None else None,
        prepared.mode, nt, n_lanes, cap, max_depth)
    if n_scr:
        # the tex_color tier's scratch (_tex_scratch_floats), not zeroed:
        # the kernel writes each cell before it reads it. The suffix tier's
        # records grow with max_depth and are checked against the free
        # memory first; the weight planes' rows are bounded (8 * NT <= 256
        # floats a lane, about a capped pass's carry) and skip the check,
        # 0.4-0.8 ms of host time a launch (scripts/port_profile.py k3vnew)
        if suffix:
            check_free(device,
                       4 * (n_scr + (n_rows * n_lanes if cap else 0)),
                       f"the suffix tier's scratch and carry ({n_lanes} "
                       f"lanes, depth {max_depth})")
        scratch = torch.empty(n_scr, dtype=torch.float32, device=device)
    rad = torch.empty(3, n_lanes, dtype=torch.float32, device=device)
    st = (torch.empty(n_rows, n_lanes, dtype=torch.float32, device=device)
          if cap else None)
    lib = load_library()
    partial = None
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device)
                                 .cuda_stream)
        if prepared.mode in BVH_MODES:
            if cot is not None:
                cot = cot.to(device=device, dtype=torch.float32).contiguous()
                n_tex = 3 * nt
                partial = torch.empty(n_lanes // LANE_BLOCK, n_tex,
                                      dtype=torch.float32, device=device)
            err = lib.bvh[prepared.mode](
                ctypes.byref(p), ctypes.byref(_BvParams(**prepared.bfields)),
                ptr(prepared.tables), ptr(prepared.btab), ptr(pix_lanes),
                ptr(carry), ptr(cot), ptr(rad), ptr(st), ptr(partial),
                ptr(iters), ptr(scratch), ptr(multi_rows), stream)
        elif cot is None and prepared.mode == "vscan":
            err = lib.forward_vscan(
                ctypes.byref(p), ctypes.byref(_VsParams(**prepared.vfields)),
                ptr(prepared.tables), ptr(prepared.vtab), ptr(pix_lanes),
                ptr(carry), ptr(rad), ptr(st), ptr(iters), stream)
        elif cot is None:
            # the persistent threads' slot counter, 0 at the launch's start
            # (zeroed on its stream)
            slots = torch.zeros(1, dtype=torch.int32, device=device)
            err = lib.forward(ctypes.byref(p), ptr(prepared.tables),
                              ptr(pix_lanes), ptr(carry), ptr(rad), ptr(st),
                              ptr(iters), ptr(slots), stream)
        else:
            cot = cot.to(device=device, dtype=torch.float32).contiguous()
            # one row of per-block partial sums (3NT tex entries, then K
            # hard ones), summed over the blocks below in a fixed order
            n_tex = 3 * nt if p.want_tex else 0
            partial = torch.empty(n_lanes // LANE_BLOCK, n_tex + K,
                                  dtype=torch.float32, device=device)
            if prepared.mode == "vscan":
                err = lib.grad_vscan(
                    ctypes.byref(p),
                    ctypes.byref(_VsParams(**prepared.vfields)),
                    ptr(prepared.tables), ptr(prepared.vtab),
                    ptr(pix_lanes), ptr(carry), ptr(cot), ptr(rad),
                    ptr(st), ptr(partial), ptr(iters), ptr(scratch),
                    ptr(multi_rows), stream)
            else:
                err = lib.grad(ctypes.byref(p), ptr(prepared.tables),
                               ptr(pix_lanes), ptr(carry), ptr(cot),
                               ptr(rad), ptr(st), ptr(partial), ptr(iters),
                               stream)
    if err != 0:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error "
                           f"{err}")
    if partial is None:
        return rad, st, None, None
    sums = partial.sum(0)
    dg_tex = sums[:n_tex].reshape(nt, 3) if n_tex else None
    return rad, st, dg_tex, sums[n_tex:]


def render_pass_kernel(flat: FlatScene, cam: CameraState, seed,
                       sample_start, *, width: int, height: int,
                       n_strata: int, max_depth: int, n_samples: int,
                       sky_gradient: bool = False, cap: int = 0, carry=None,
                       pix_lanes=None, prepared: KernelInputs | None = None,
                       iters=None, row0: int = 0):
    """The forward kernel's wrapper: render_pass_reference's signature and
    results, on a CUDA device. `prepared` is prepare_kernel(flat, cam),
    packed here when not given; its mode picks the instance: the unrolled
    forward (K1), for a vscan scene the chunk scan's (K6, with quad chunks
    K7), for a BVH mode the stack walk's (K11) or the lane walk's (K12).
    Launches on the current stream; raises if the scene is outside the
    gate, the inputs are malformed, the packing's mode is not the one
    kernel_mode gives now, or the launch fails. Each launch adds one to
    render_pass_kernel.launches, one of the chunk scan's to
    render_pass_kernel.launches_vscan, one of those with quad chunks to
    render_pass_kernel.launches_vquad, one of the stack walk's to
    .launches_stack and one of the lane walk's to .launches_lane. While a
    profiler records (utils/profiling.py::recording) and iters is None, a
    zeroed bounce buffer goes to the launch and its sum is added to
    render_pass_kernel.bounces, a device-side total (no host sync): every
    bounce the launch traced, the lanes past the image's pixels included
    (they repeat its last pixel). With no profiler no buffer is made."""
    if prepared is None:
        prepared = prepare_kernel(flat, cam)
    count = iters is None and recording()
    if count:
        iters = torch.zeros(lane_count(width * height), dtype=torch.int32,
                            device=prepared.tables.device)
    rad, st, _, _ = _launch(
        flat, cam, seed, sample_start, width=width, height=height,
        n_strata=n_strata, max_depth=max_depth, n_samples=n_samples,
        sky_gradient=sky_gradient, cap=cap, carry=carry, pix_lanes=pix_lanes,
        prepared=prepared, iters=iters, cot=None, row0=row0)
    if count:
        render_pass_kernel.bounces = render_pass_kernel.bounces + iters.sum()
    render_pass_kernel.launches += 1
    if prepared.mode == "vscan":
        render_pass_kernel.launches_vscan += 1
        render_pass_kernel.launches_vquad += prepared.vfields["Cq"] > 0
    render_pass_kernel.launches_stack += prepared.mode == "stack"
    render_pass_kernel.launches_lane += prepared.mode == "lane"
    return _pass_result(rad, st, cap=cap, pix_lanes=pix_lanes, width=width,
                        height=height)


render_pass_kernel.launches = 0
render_pass_kernel.launches_vscan = 0
render_pass_kernel.launches_vquad = 0
render_pass_kernel.launches_stack = 0
render_pass_kernel.launches_lane = 0
render_pass_kernel.bounces = 0


def render_pass_grad_kernel(flat: FlatScene, cam: CameraState, seed,
                            sample_start, *, width: int, height: int,
                            n_strata: int, max_depth: int, n_samples: int,
                            cotangent, hard_slots: tuple = (),
                            want_tex: bool = True,
                            sky_gradient: bool = False, cap: int = 0,
                            carry=None, pix_lanes=None,
                            prepared: KernelInputs | None = None,
                            iters=None, multi_rows=None, row0: int = 0):
    """The grad kernel's (K3, K4, K8) wrapper: render_pass_grad_reference's
    signature and results (the tier by tex_form), on a CUDA device.
    `prepared` is prepare_kernel(flat, cam, hard_slots), packed here when
    not given (its slots must be `hard_slots`); its mode picks the unrolled
    instances, the chunk scan's (K3v, K4v, K8) or a BVH walk's (K11, K12:
    tex_color only, weight planes or the suffix tier). The kernel writes
    one row of dG_tex and dG_hard partial sums per block; they are summed
    here. The image, dG_hard and the bounces are the plain version's
    semantics; the suffix tier traces each sample once (csrc/wavefront.cu,
    K8), so its bounces are the forward's, and its capped carry holds the
    path total, the path's record count and its records
    (_kernel_carry_rows) in place of the plain version's phase and prefix.
    The tex_color tier's scratch in global memory (_tex_scratch_floats:
    the chunk scan's and the walks' weight-plane rows, or the suffix
    tier's route sums and records; the latter checked against the
    device's free memory). `multi_rows`, a (1,) int32 tensor, gets one
    for each path whose weight planes came to hold a second row on those
    instances. Raises as render_pass_kernel
    does, for a malformed cotangent, for a pass outside grad_gate_reason
    and for scratch past the free memory. Each launch adds one to
    render_pass_grad_kernel.launches; one with hard slots (the K4
    instances) to .hard_launches; one on the chunk scan's selection with
    weight planes (K3v) to .vscan_tex_launches and one with hard slots
    (K4v) to .vscan_hard_launches; one of the suffix tier (K8, on any
    selection) to .suffix_launches; one on the stack walk to
    .stack_launches and one on the lane walk to .lane_launches."""
    cot = cotangent_lanes(cotangent, width=width, height=height,
                          pix_lanes=pix_lanes)
    if prepared is None:
        prepared = prepare_kernel(flat, cam, hard_slots)
    rad, st, dg_tex, dg_hard = _launch(
        flat, cam, seed, sample_start, width=width, height=height,
        n_strata=n_strata, max_depth=max_depth, n_samples=n_samples,
        sky_gradient=sky_gradient, cap=cap, carry=carry, pix_lanes=pix_lanes,
        prepared=prepared, iters=iters, cot=cot, hard_slots=hard_slots,
        want_tex=want_tex, multi_rows=multi_rows, row0=row0)
    render_pass_grad_kernel.launches += 1
    form = tex_form(flat, want_tex)
    if hard_slots:
        render_pass_grad_kernel.hard_launches += 1
    if prepared.mode == "vscan":
        render_pass_grad_kernel.vscan_tex_launches += form == "planes"
        render_pass_grad_kernel.vscan_hard_launches += bool(hard_slots)
    render_pass_grad_kernel.suffix_launches += form == "suffix"
    render_pass_grad_kernel.stack_launches += prepared.mode == "stack"
    render_pass_grad_kernel.lane_launches += prepared.mode == "lane"
    return _grad_result(rad, dg_tex, dg_hard, st, cap=cap,
                        pix_lanes=pix_lanes, width=width, height=height)


render_pass_grad_kernel.launches = 0
render_pass_grad_kernel.hard_launches = 0
render_pass_grad_kernel.vscan_tex_launches = 0
render_pass_grad_kernel.vscan_hard_launches = 0
render_pass_grad_kernel.suffix_launches = 0
render_pass_grad_kernel.stack_launches = 0
render_pass_grad_kernel.lane_launches = 0


def pass_function(flat: FlatScene, cam: CameraState,
                  prepared: KernelInputs | None = None):
    """The pass function for the scene's device: the CUDA kernel, with the
    scene and camera packed once (or `prepared`, also a scene on the host
    packed for the card), for a scene on a CUDA device; the plain torch
    version for a scene on the CPU."""
    if prepared is not None or flat.device.type == "cuda":
        return functools.partial(
            render_pass_kernel,
            prepared=prepared or prepare_kernel(flat, cam))
    if flat.device.type == "cpu":
        return render_pass_reference
    raise ValueError(f"no wavefront pass for device {flat.device}")


def grad_pass_function(flat: FlatScene, cam: CameraState,
                       prepared: KernelInputs | None = None,
                       hard_slots: tuple = ()):
    """pass_function's counterpart for the grad pass: the grad kernel on a
    CUDA device, with the scene, camera and the slot table of `hard_slots`
    packed once (or `prepared`), its plain version on the CPU, nothing
    else. The caller passes the same hard_slots to each pass."""
    if flat.device.type == "cuda":
        return functools.partial(
            render_pass_grad_kernel,
            prepared=prepared or prepare_kernel(flat, cam, hard_slots))
    if flat.device.type == "cpu":
        return render_pass_grad_reference
    raise ValueError(f"no wavefront grad pass for device {flat.device}")


def render_pass(flat: FlatScene, cam: CameraState, seed, sample_start,
                **kw):
    """One pass through pass_function(flat, cam)."""
    return pass_function(flat, cam)(flat, cam, seed, sample_start, **kw)


# ------------------------------------------------------- compacted drivers
def default_caps(flat: FlatScene, n_samples: int, max_depth: int,
                 cap: int = 0, phases: int = 2) -> tuple:
    """The JAX package's cap schedule (wavefront_pallas.py:3726-3749),
    carried over verbatim. It was tuned on a TPU and waits for H100
    measurement (ROADMAP)."""
    if cap == 0:
        if kernel_mode(flat)[0] != "unrolled":
            return (max(2 * n_samples, 2),) * 2
        cap = max(int(6.5 * n_samples), max_depth)
    if phases <= 2:
        return (cap,)
    return (cap,) + tuple(max(int(cap * 0.4 ** i), max_depth // 2)
                          for i in range(1, phases - 1))


def default_grad_caps(flat: FlatScene, width: int, height: int,
                      n_samples: int, max_depth: int) -> tuple:
    """The JAX package's grad cap schedule (wavefront_pallas.py:3833-3845),
    carried over verbatim: three short phases from a million pixels up,
    else one 6.5 x spp cap. Tuned on a TPU; waits for H100 measurement
    (ROADMAP)."""
    if kernel_mode(flat)[0] != "unrolled":
        return (max(2 * n_samples, 2),) * 2
    if width * height >= 1_000_000:
        return (max(2 * n_samples, max_depth),) * 3
    return (max(int(6.5 * n_samples), max_depth),)


def _check_caps(caps) -> tuple:
    caps = tuple(int(c) for c in caps)
    if any(c <= 0 for c in caps):
        raise ValueError(f"caps must be positive iteration counts: {caps}")
    return caps


def _compacted_schedule(run_phase, caps: tuple, n_samples: int,
                        n_pix: int) -> torch.Tensor:
    """The compaction loop both drivers share. run_phase(cap, pix_lanes,
    carry, perm) runs one phase and returns (radiance (3, n_lanes), carry
    or None); the first phase gets pix_lanes, carry and perm None, the last
    cap 0. Between phases the lanes are sorted by remaining samples
    (unfinished lanes first, finished lanes last, stable), and perm maps
    the sorted lanes to identity lanes. Returns the radiance summed into
    identity lane order."""
    rad, st = run_phase(caps[0], None, None, None)
    n_lanes = rad.shape[1]
    pix_abs = _identity_pixels(n_lanes, n_pix, rad.device)
    perm = torch.arange(n_lanes, device=rad.device)
    for cap_i in caps[1:] + (0,):
        with span("rt.compact"):
            key = torch.where(st[0] > 0.5, n_samples - st[3],
                              torch.full_like(st[3], -1.0))
            order = torch.argsort(-key, stable=True)
            perm = perm[order]
            lanes, carry = pix_abs[perm], st[:, order]
        r, st = run_phase(cap_i, lanes, carry, perm)
        rad.index_add_(1, perm, r)
    return rad


def render_pass_compacted(flat: FlatScene, cam: CameraState, seed,
                          sample_start, *, width: int, height: int,
                          n_strata: int, max_depth: int, n_samples: int,
                          sky_gradient: bool = False, cap: int = 0,
                          phases: int = 2, caps: tuple | None = None,
                          pass_fn=None, row0: int = 0):
    """Capped + lane-compacted schedule: run the wavefront for caps[0]
    iterations, sort lanes by remaining samples, resume the carried states
    under that lane -> pixel permutation, and so on; an uncapped pass
    finishes. RNG keys are pixel ids, so the permutation changes no sample
    stream. caps == () is one uncapped pass. pass_fn runs each phase
    (default pass_function(flat, cam); the plain version may be given
    explicitly for a scene on the card). row0 (a tile shard's first row)
    goes to every phase; the lanes and their permutation stay the shard's.
    Returns the (height, width, 3) radiance-sum image."""
    if caps is None:
        caps = default_caps(flat, n_samples, max_depth, cap, phases)
    caps = _check_caps(caps)
    if pass_fn is None:
        pass_fn = pass_function(flat, cam)
    common = dict(width=width, height=height, n_strata=n_strata,
                  max_depth=max_depth, n_samples=n_samples,
                  sky_gradient=sky_gradient, row0=row0)
    if caps == ():
        return pass_fn(flat, cam, seed, sample_start, **common)

    def phase(cap_i, pix_lanes, carry, perm):
        out = pass_fn(flat, cam, seed, sample_start, cap=cap_i,
                      pix_lanes=pix_lanes, carry=carry, **common)
        return out if cap_i else (out, None)

    rad = _compacted_schedule(phase, caps, n_samples, width * height)
    return _image_from_lanes(rad, width, height)


def render_pass_grad_compacted(flat: FlatScene, cam: CameraState, seed,
                               sample_start, *, width: int, height: int,
                               n_strata: int, max_depth: int,
                               n_samples: int, cotangent,
                               hard_slots: tuple = (), want_tex: bool = True,
                               sky_gradient: bool = False,
                               caps: tuple | None = None, pass_fn=None,
                               row0: int = 0):
    """The capped + lane-compacted schedule of the grad pass (K5,
    wavefront_pallas.py:3807-3888): render_pass_compacted's phases, with
    the weight and tangent planes riding the carry, the cotangent lanes
    permuted with the lanes, and dG_tex and dG_hard (sums over lanes, which
    no permutation changes) summed across phases. caps default to
    default_grad_caps; () is one uncapped grad pass. pass_fn runs each
    phase (default grad_pass_function(flat, cam, hard_slots=hard_slots));
    row0 as render_pass_compacted's. Returns (image, dG_tex, dG_hard) as
    the single grad pass does."""
    if caps is None:
        caps = default_grad_caps(flat, width, height, n_samples, max_depth)
    caps = _check_caps(caps)
    if pass_fn is None:
        pass_fn = grad_pass_function(flat, cam, hard_slots=hard_slots)
    common = dict(width=width, height=height, n_strata=n_strata,
                  max_depth=max_depth, n_samples=n_samples,
                  sky_gradient=sky_gradient, hard_slots=hard_slots,
                  want_tex=want_tex, row0=row0)
    if caps == ():
        return pass_fn(flat, cam, seed, sample_start, cotangent=cotangent,
                       **common)
    g0 = cotangent_lanes(cotangent, width=width, height=height)
    dg_tex, dg_hard = [], []

    def phase(cap_i, pix_lanes, carry, perm):
        out = pass_fn(flat, cam, seed, sample_start, cap=cap_i,
                      pix_lanes=pix_lanes, carry=carry,
                      cotangent=cotangent if perm is None else g0[:, perm],
                      **common)
        dg_tex.append(out[1])
        dg_hard.append(out[2])
        return out[0], (out[3] if cap_i else None)

    rad = _compacted_schedule(phase, caps, n_samples, width * height)
    return (_image_from_lanes(rad, width, height),
            torch.stack(dg_tex).sum(0) if want_tex else None,
            torch.stack(dg_hard).sum(0))
