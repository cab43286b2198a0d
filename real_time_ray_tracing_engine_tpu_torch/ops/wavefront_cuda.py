"""Path-tracing megakernel (CUDA) and its plain torch version.

Port of the JAX package's ops/wavefront_pallas.py Pallas kernel in its
variants: the unrolled forward (K1), its capped/resume variant under the
compacted driver (K2), the forward-mode gradient pass with tex_color
weight planes (K3) and hard-parameter tangent bundles (K4) under the
compacted grad driver (K5), and, for scenes past the unrolled bounds (up to
MAX_PRIMS_SCAN primitives), the forward over the Morton chunk scan's
selection (K6 vscan; K7 vquad, quads in chunks too) and the grad pass over
it (K3v weight planes, K4v tangent bundles, and past MAX_GRAD_TEXS texture
rows the suffix-radiance tier K8). Here they are one hand-written CUDA
kernel body, csrc/wavefront.cu, built with nvcc for sm_90a at first use
(its parts in parallel) and bound with ctypes. Beside it:

  - `render_pass_reference` / `render_pass_grad_reference`: the same lane
    wavefront in plain torch, built from the integrator's per-bounce step
    (ops/integrator.py): persistent lane regeneration, `cap`, `carry` and
    `pix_lanes`, the same carry layout (14 rows; the grad pass appends its
    3*NT weight planes, 9 tangent planes per hard slot and the suffix
    tier's 7 rows). The hard slots' tangents are torch.func.jvp of the
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
    the plain pass (`render_pass_reference`) stays the all-primitive
    integrator in every mode.

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
from ..utils.vecmath import normalize
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

LANE_BLOCK = 128  # = WF_THREADS, the kernel's block size
CARRY_ROWS = 14   # work, alive, bounce, sample, time, o xyz, d xyz, th xyz
# (the grad pass appends 3*NT weight-plane rows, then 9 tangent-plane rows
# per hard slot, then the suffix tier's SUFFIX_ROWS: phase, T xyz, P xyz;
# wavefront_pallas.py:3240-3249)
SUFFIX_ROWS = 7

# the hard trainable families and their slot kinds
# (wavefront_pallas.py:382-383)
HARD_SLOT_FIELDS = {"fuzz": "mat_fuzz", "ior": "mat_ior",
                    "sphc": "sph_center", "sphr": "sph_radius"}
HARD_FIELDS = ("mat_fuzz", "mat_ior", "sph_center", "sph_radius")
# hard slots one grad launch takes (csrc/wavefront.cu MAX_SLOTS): their
# tangent planes and sums live in shared memory, 10 floats a slot a lane.
# From 33 slots the training policy takes the adjoint kernels
# (ADJOINT_MIN_SLOTS, parallel/train.py), so 32 covers the tangent tier.
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
# above its kernels says which instances each part holds)
WF_PARTS = (0, 1, 2, 3)


# ------------------------------------------------------------------- gate
def _use_unrolled(flat: FlatScene) -> bool:
    """The JAX package's unrolled-kernel bounds (_use_unrolled)."""
    S, Q = flat.sph_center.shape[0], flat.quad_corner.shape[0]
    return (S + Q <= MAX_PRIMS_UNROLL and flat.mat_type.shape[0] <= MAX_MATS
            and flat.tex_type.shape[0] <= MAX_TEXS)


def kernel_mode(flat: FlatScene) -> tuple:
    """(mode, vquad): the JAX package's _kernel_modes
    (wavefront_pallas.py:464-492) without its opt-in BVH modes (K11/K12,
    not ported). "unrolled" for a scene inside the unrolled bounds (tables
    in shared memory, every primitive tested); else "vscan", the Morton
    chunk scan, with vquad True when its quads (more than MAX_QUADS_VSCAN)
    move to chunks too."""
    if _use_unrolled(flat):
        return "unrolled", False
    return "vscan", flat.quad_corner.shape[0] > MAX_QUADS_VSCAN


def kernel_gate_reason(flat: FlatScene) -> str | None:
    """Why this scene cannot run on the forward kernel (None = it can): the
    JAX package's pallas_gate_reason, and for the unrolled mode the
    shared-memory bound of its tables (the chunk scan reads its tables from
    global memory)."""
    if flat.n_mediums > MAX_MEDIUMS:
        return (f"{flat.n_mediums} constant mediums exceeds the kernel bound "
                f"MAX_MEDIUMS={MAX_MEDIUMS}")
    if flat.n_prims == 0:
        return "empty scene (no primitives)"
    if flat.n_prims > MAX_PRIMS_SCAN:
        return (f"{flat.n_prims} primitives exceeds the chunk scan's bound "
                f"MAX_PRIMS_SCAN={MAX_PRIMS_SCAN}; larger scenes need the "
                "BVH (-b/--bvh, the kernels K11/K12), which is not ported "
                "yet")
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
    most MAX_HARD_SLOTS slots (past them the JAX package trains with the
    adjoint kernels K9/K10, not ported); and the launch's shared memory
    (grad_smem_bytes), which the chunk scan's weight planes for 17 to
    MAX_GRAD_TEXS rows share with the tangent planes."""
    reason = kernel_gate_reason(flat)
    if reason is not None:
        return reason
    NT = flat.tex_type.shape[0]
    if n_slots > MAX_HARD_SLOTS:
        return (f"{n_slots} hard slots exceed the tangent-bundle kernel's "
                f"MAX_HARD_SLOTS={MAX_HARD_SLOTS}; from 33 slots the JAX "
                "package trains with the adjoint kernels (K9/K10), which "
                "are not ported")
    n_bytes = grad_smem_bytes(flat, n_slots, want_tex)
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


def grad_smem_bytes(flat: FlatScene, n_slots: int,
                    want_tex: bool = True) -> int:
    """Shared memory of a grad launch (csrc/wavefront.cu, wavefront_body):
    the tables (the unrolled mode, with the slot table) or the chunk boxes
    (the chunk scan, whose tables stay in global memory), padded as
    table_pad does; 10 floats a hard slot a lane; the suffix tier's 3 * NT
    accumulators; on the chunk scan, weight planes for more than MAX_TEXS
    rows, 6 floats a row a lane (Wp and its cotangent sums Gp)."""
    NT = flat.tex_type.shape[0]
    vscan = kernel_mode(flat)[0] == "vscan"
    n = _vscan_box_floats(flat) if vscan else (_table_floats(flat)
                                               + 3 * n_slots)
    n = -(-n // 32) * 32 + 10 * n_slots * LANE_BLOCK
    form = tex_form(flat, want_tex)
    if form == "suffix":
        n += 3 * NT
    elif form == "planes" and vscan and NT > MAX_TEXS:
        n += 6 * NT * LANE_BLOCK
    return 4 * n


def hard_slots_gate_reason(flat: FlatScene, n_slots: int) -> str | None:
    """Why n_slots hard slots cannot run in the grad kernel (None = they
    can): grad_gate_reason without tex_color (the suffix tier's
    accumulators are counted where want_tex is known, at the launch)."""
    return grad_gate_reason(flat, n_slots, want_tex=False)


# ----------------------------------------------------------------- tables
def _pack_tables(flat: FlatScene):
    """The JAX package's _pack_tables: the scene gathered into kernel rows.

    Returns (sphf (S, 8), quadf (Q, 18), prim_mat (S+Q,), lightf (L, 25),
    mati (NM, 2), matf (NM, 2), texf (NT, 14), medf (M, 3+4*MS+17*MQ)) with
    the same columns. The JAX package's scan-mode resolved row table
    (primmatf) waits for the large-scene kernel that reads it."""
    f32 = torch.float32
    sphf = torch.cat([flat.sph_center, flat.sph_cdelta,
                      flat.sph_radius[:, None],
                      flat.sph_active.to(f32)[:, None]], dim=1)
    quadf = torch.cat([flat.quad_corner, flat.quad_u, flat.quad_v,
                       flat.quad_normal, flat.quad_d[:, None], flat.quad_w,
                       flat.quad_area[:, None],
                       flat.quad_active.to(f32)[:, None]], dim=1)
    prim_mat = torch.cat([flat.sph_mat, flat.quad_mat])

    S = flat.sph_center.shape[0]
    li = flat.light_prim.to(torch.int64)
    is_sph = (li < S).to(f32)
    si = torch.clamp(li, 0, S - 1)
    qi = torch.clamp(li - S, 0, flat.quad_corner.shape[0] - 1)
    lightf = torch.cat([
        is_sph[:, None], flat.sph_center[si], flat.sph_cdelta[si],
        flat.sph_radius[si][:, None],
        flat.quad_corner[qi], flat.quad_u[qi], flat.quad_v[qi],
        flat.quad_normal[qi], flat.quad_d[qi][:, None], flat.quad_w[qi],
        flat.quad_area[qi][:, None]], dim=1)

    mati = torch.stack([flat.mat_type, flat.mat_tex], dim=1)
    matf = torch.stack([flat.mat_fuzz, flat.mat_ior], dim=1)

    even_i = flat.tex_child_even.to(torch.int64)
    odd_i = flat.tex_child_odd.to(torch.int64)
    even_c = flat.tex_color[even_i]
    odd_c = flat.tex_color[odd_i]
    is_chk = (flat.tex_type == TEX_CHECKER).to(f32)
    is_noi = (flat.tex_type == TEX_NOISE).to(f32)
    texf = torch.cat([
        flat.tex_color, flat.tex_scale[:, None], is_chk[:, None],
        even_c, odd_c, flat.tex_child_even.to(f32)[:, None],
        flat.tex_child_odd.to(f32)[:, None], is_noi[:, None]], dim=1)

    n_med = flat.med_mat.shape[0]
    quad_cols = torch.cat([
        flat.med_quad_corner, flat.med_quad_u, flat.med_quad_v,
        flat.med_quad_normal, flat.med_quad_d[..., None], flat.med_quad_w,
        flat.med_quad_active.to(f32)[..., None]], dim=2).reshape(n_med, -1)
    sph_cols = torch.cat([flat.med_sph_center,
                          flat.med_sph_radius[..., None]],
                         dim=2).reshape(n_med, -1)
    medf = torch.cat([flat.med_neg_inv_density[:, None],
                      flat.med_active.to(f32)[:, None], sph_cols, quad_cols,
                      flat.med_mat.to(f32)[:, None]], dim=1)
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
    the offset of each (integer columns stored as exact floats): the scene,
    the light rows' source spheres and the hard slots' table."""
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
        t = t.to(device=flat.device, dtype=torch.float32).reshape(-1)
        off += t.numel()
        flat_parts.append(t)
    buf = torch.cat(flat_parts).contiguous()
    return buf, offsets, int(medf.shape[1])


# ------------------------------------------------------ chunk-scan tables
def _morton3(x, y, z):
    """30-bit Morton codes of 10-bit coordinates (wavefront_pallas.py:176),
    in int64: torch's CPU builds have no uint32 shift or add, and no step
    here leaves 32 bits."""
    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249
    return (spread(x) << 2) | (spread(y) << 1) | spread(z)


def _morton_codes(mid, act):
    """Morton codes of box midpoints (n, 3) quantized over the active ones'
    span, as the JAX packers do."""
    wmin = torch.where(act[:, None], mid, BIG).min(0).values
    wmax = torch.where(act[:, None], mid, -BIG).max(0).values
    scale = 1023.0 / torch.clamp(wmax - wmin, min=1e-6)
    q = torch.clamp((mid - wmin) * scale, 0.0, 1023.0).to(torch.int64)
    return _morton3(q[:, 0], q[:, 1], q[:, 2])


def _chunk_boxes(lo, hi, n_chunks: int):
    """(n_chunks, 6) boxes [lo xyz, hi xyz] of consecutive VCHUNK-row
    chunks; rows past lo's end count as empty (BIG / -BIG)."""
    pad = n_chunks * VCHUNK - lo.shape[0]
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=BIG)
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-BIG)
    return torch.cat([lo.reshape(n_chunks, VCHUNK, 3).min(1).values,
                      hi.reshape(n_chunks, VCHUNK, 3).max(1).values], dim=1)


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
      qrows (Cq * VCHUNK, 20): with vquad (Q > MAX_QUADS_VSCAN), quad rows
        [corner, u, v, normal, d, w, id, 0 0 0] in Morton order, inactive
        and pad rows id -1; qperm the original quad ids. Cq = 0 tests the
        quads one by one from `quads` (Q, 17): corner, u, v, normal, d, w,
        active, in the scene's order.
    Ids are unified primitive ids: spheres 0..S-1, quads S + q."""
    rows: torch.Tensor
    perm: torch.Tensor
    box: torch.Tensor
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


def pack_vscan_tables(flat: FlatScene) -> VscanTables:
    """The chunk-scan tables of a vscan scene (see VscanTables)."""
    f32 = torch.float32
    dev = flat.device
    c0, cd, rad = flat.sph_center, flat.sph_cdelta, flat.sph_radius
    S = c0.shape[0]
    active = flat.sph_active & (rad > 0.0)
    # motion-swept sphere boxes
    lo = torch.minimum(c0, c0 + cd) - rad[:, None]
    hi = torch.maximum(c0, c0 + cd) + rad[:, None]
    moving = (cd != 0.0).any(1)
    n_big = VSCAN_BIG if S > VCHUNK else 0
    nas = int(flat.n_sph_active_static)
    pick_static_bigs = nas >= n_big
    is_big = torch.zeros(S, dtype=torch.bool, device=dev)
    if n_big:
        pool = (active & ~moving) if pick_static_bigs else active
        extent = (hi - lo).max(1).values
        order = torch.argsort(-torch.where(pool, extent, -1.0), stable=True)
        is_big[order[:n_big]] = True
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
    rows = torch.cat([c0, cd, rad[:, None], ids.to(f32)[:, None]], 1)[perm]
    rows = torch.cat([_chunk_rows(rows[:n_small], C_small, 7)]
                     + [_chunk_rows(rows[n_small:], 1, 7)] * (n_big > 0))
    culled = (active & ~is_big)[:, None]
    lo_c = torch.where(culled, lo, BIG)[perm][:n_small]
    hi_c = torch.where(culled, hi, -BIG)[perm][:n_small]
    box = _chunk_boxes(lo_c, hi_c, C_small + (1 if n_big else 0))
    scale = torch.where(culled, torch.maximum(lo.abs(), hi.abs()),
                        0.0).max() if S else torch.zeros((), device=dev)

    Q = flat.quad_corner.shape[0]
    qact = flat.quad_active
    quads = torch.cat([flat.quad_corner, flat.quad_u, flat.quad_v,
                       flat.quad_normal, flat.quad_d[:, None], flat.quad_w,
                       qact.to(f32)[:, None]], 1)
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
            quads[:, :16], qids.to(f32)[:, None],
            torch.zeros(Q, 3, dtype=f32, device=dev)], 1)[qperm], Cq, 16)
        box = torch.cat([box, _chunk_boxes(
            torch.where(qact[:, None], qlo, BIG)[qperm],
            torch.where(qact[:, None], qhi, -BIG)[qperm], Cq)])
        scale = torch.maximum(scale, torch.where(
            qact[:, None], torch.maximum(qlo.abs(), qhi.abs()), 0.0).max())
    pad = float(np.float32(BOX_PAD * (1.0 + float(scale))))
    return VscanTables(rows=rows.contiguous(), perm=perm, box=box, pad=pad,
                       S=S, C_small=C_small, C_stat=C_stat, n_big=n_big,
                       qrows=qrows.contiguous(), qperm=qperm, Cq=Cq,
                       quads=quads)


def _padded_boxes(vt: VscanTables) -> torch.Tensor:
    """The boxes the cull tests: each non-empty box widened by vt.pad."""
    lo, hi = vt.box[:, :3], vt.box[:, 3:]
    empty = (lo > hi).any(1, keepdim=True)
    return torch.cat([torch.where(empty, lo, lo - vt.pad),
                      torch.where(empty, hi, hi + vt.pad)], 1)


def _vscan_buffer(vt: VscanTables):
    """One float32 buffer of what the vscan kernel reads beside the scene
    tables: the sphere rows, the quad rows (16-byte aligned, for float4
    loads) and the widened boxes; and the kernel's VsParams fields."""
    parts = [vt.rows.reshape(-1), vt.qrows.reshape(-1),
             _padded_boxes(vt).reshape(-1)]
    fields = dict(C_small=vt.C_small, n_big=vt.n_big, Cq=vt.Cq,
                  off_rows=0, off_qrows=parts[0].numel(),
                  off_box=parts[0].numel() + parts[1].numel(),
                  n_box=parts[2].numel())
    return torch.cat(parts).contiguous(), fields


def _inverse_dir(d):
    """1/d with |d| < 1e-12 taken as +-1e-12 (wavefront_pallas.py:
    1411-1416): the slab test of a ray along a box face stays finite."""
    eps = 1e-12
    return 1.0 / torch.where(d.abs() < eps,
                             torch.where(d < 0, -eps, eps), d)


def _box_reaches(box, o, inv_d, t_far):
    """The kernel's per-ray chunk cull: does the ray meet the (widened,
    non-empty) box between T_MIN and t_far? box (6,), rays (n, 3)."""
    t0 = (box[:3] - o) * inv_d
    t1 = (box[3:] - o) * inv_d
    tn = torch.maximum(torch.maximum(torch.minimum(t0[:, 0], t1[:, 0]),
                                     torch.minimum(t0[:, 1], t1[:, 1])),
                       torch.clamp(torch.minimum(t0[:, 2], t1[:, 2]),
                                   min=1e-3))
    tf = torch.minimum(torch.minimum(torch.maximum(t0[:, 0], t1[:, 0]),
                                     torch.maximum(t0[:, 1], t1[:, 1])),
                       torch.minimum(torch.maximum(t0[:, 2], t1[:, 2]),
                                     t_far))
    return tn <= tf


def vscan_select_reference(vt: VscanTables, o, d, tm):
    """The plain version of the kernel's chunk-scan selection: the same
    walk (the big block, then each sphere chunk, then the quad chunks or
    the quads one by one) and per-ray box cull against the running best t,
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

    def culled(k):
        box = boxes[k]
        if bool(box[0] > box[3]):
            return torch.zeros(0, dtype=torch.int64, device=dev)
        return torch.nonzero(_box_reaches(box, o, inv_d, best_t)).squeeze(1)

    if vt.n_big:
        base = vt.C_small * VCHUNK
        spheres(torch.arange(n, device=dev),
                vt.rows[base:base + vt.n_big])
    for c in range(vt.C_small):
        spheres(culled(c), vt.rows[c * VCHUNK:(c + 1) * VCHUNK])
    if vt.Cq:
        for k in range(vt.Cq):
            rows = vt.qrows[k * VCHUNK:(k + 1) * VCHUNK]
            rows = rows[rows[:, 16] >= 0]
            q = torch.cat([rows[:, :16], torch.ones_like(rows[:, :1])], 1)
            quads(culled(vt.C + k), q, rows[:, 16].to(torch.int64))
    else:
        quads(torch.arange(n, device=dev), vt.quads,
              vt.S + torch.arange(vt.quads.shape[0], device=dev))
    return best, best_t


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
    3*NT (weight planes) + 9*K + SUFFIX_ROWS (suffix tier) rows. Raises for
    a grad pass with nothing to differentiate."""
    if cot is None:
        return 0, 0, False
    if not want_tex and not hard_slots:
        raise ValueError("a grad pass needs want_tex or hard_slots")
    form = tex_form(flat, want_tex, force_planes)
    n_wp = 3 * flat.tex_type.shape[0] if form == "planes" else 0
    return n_wp, len(hard_slots), form == "suffix"


def _carry_rows(n_wp: int, K: int, suffix: bool) -> int:
    return CARRY_ROWS + n_wp + 9 * K + (SUFFIX_ROWS if suffix else 0)


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
def _wavefront_reference(flat: FlatScene, cam: CameraState, seed,
                         sample_start, *, width, height, n_strata, max_depth,
                         n_samples, sky_gradient, cap, carry, pix_lanes,
                         iters, cot, hard_slots=(), want_tex=True,
                         force_planes=False):
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

    Returns (radiance (3, n_lanes), carry or None, dG_tex (NT, 3) or None,
    dG_hard (K,) or None). iters ((n_lanes,) int32), when given, gets one
    added per lane per bounce it traces."""
    device = flat.device
    n_pix = width * height
    n_lanes = lane_count(n_pix)
    nt = flat.tex_type.shape[0]
    n_wp, K, suffix = _grad_layout(flat, cot, hard_slots, want_tex,
                                   force_planes)
    _check_carry(carry, pix_lanes, n_lanes, _carry_rows(n_wp, K, suffix))
    _check_iters(iters, n_lanes, device)
    pix = (_identity_pixels(n_lanes, n_pix, device) if pix_lanes is None
           else pix_lanes.to(device=device, dtype=torch.int64))
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
                          carry=None, pix_lanes=None, iters=None):
    """Sum of n_samples stratified samples per pixel by a persistent lane
    wavefront in plain torch — the kernel's semantics, lane for lane.

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
        iters=iters, cot=None)
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
                               force_planes: bool = False):
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
    when capped. Each call adds one to render_pass_grad_reference.calls."""
    render_pass_grad_reference.calls += 1
    cot = cotangent_lanes(cotangent, width=width, height=height,
                          pix_lanes=pix_lanes).to(flat.device)
    rad, st, dg_tex, dg_hard = _wavefront_reference(
        flat, cam, seed, sample_start, width=width, height=height,
        n_strata=n_strata, max_depth=max_depth, n_samples=n_samples,
        sky_gradient=sky_gradient, cap=cap, carry=carry, pix_lanes=pix_lanes,
        iters=iters, cot=cot, hard_slots=tuple(hard_slots),
        want_tex=want_tex, force_planes=force_planes)
    return _grad_result(rad, dg_tex, dg_hard, st, cap=cap,
                        pix_lanes=pix_lanes, width=width, height=height)


render_pass_grad_reference.calls = 0


# ------------------------------------------------------------- the kernel
class _Params(ctypes.Structure):
    """Mirror of csrc/wavefront.cu::WfParams."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "n_lanes", "n_pix", "width", "n_strata", "max_depth", "n_samples",
        "sample_start")]
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
        "n_box")]


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
        # stream
        self.forward.argtypes = [ctypes.POINTER(_Params)] + [ptr] * 7
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
        # rad_out, carry_out, dg_out, iters, stream
        self.grad_vscan.argtypes = [ctypes.POINTER(_Params),
                                    ctypes.POINTER(_VsParams)] + [ptr] * 10


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
    scan's buffer `vtab` and its VsParams fields `vfields` (Cq > 0: vquad).
    Packing gathers on the device and reads the camera and the Perlin seed
    back to the host, so a render (or a training step) packs once and hands
    the result to every launch."""
    tables: torch.Tensor
    fields: dict
    hard_slots: tuple = ()
    mode: str = "unrolled"
    vtab: torch.Tensor | None = None
    vfields: dict | None = None


def prepare_kernel(flat: FlatScene, cam: CameraState,
                   hard_slots: tuple = ()) -> KernelInputs:
    """Pack `flat` and `cam` (and the slot table of `hard_slots`, for the
    grad kernel) for the kernel wrappers; raises for a scene that is not on
    a CUDA device or is outside the forward kernel's gate, and for slots
    outside hard_slots_gate_reason. A grad launch on a scene outside
    grad_gate_reason raises in _launch."""
    if flat.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{flat.device}")
    hard_slots = tuple(hard_slots)
    reason = (hard_slots_gate_reason(flat, len(hard_slots)) if hard_slots
              else kernel_gate_reason(flat))
    if reason is not None:
        raise ValueError(f"scene outside the CUDA kernel's gate: {reason}")
    tables, off, med_cols = _kernel_tables(flat, hard_slots)
    cam_s = cam.scalars().to("cpu").tolist()
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
        cam=(ctypes.c_float * 22)(*cam_s))
    mode = kernel_mode(flat)[0]
    if mode == "unrolled":
        return KernelInputs(tables, fields, hard_slots)
    vtab, vfields = _vscan_buffer(pack_vscan_tables(flat))
    return KernelInputs(tables, fields, hard_slots, mode, vtab, vfields)


def _launch(flat: FlatScene, cam: CameraState, seed, sample_start, *,
            width, height, n_strata, max_depth, n_samples, sky_gradient, cap,
            carry, pix_lanes, prepared, iters, cot, hard_slots=(),
            want_tex=True):
    """Check the inputs, launch the forward (cot None) or the grad kernel on
    the current stream, and raise if the launch fails. Returns (radiance
    (3, n_lanes), carry or None, dG_tex (NT, 3) or None, dG_hard (K,) or
    None)."""
    device = flat.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{device}")
    hard_slots = tuple(hard_slots) if cot is not None else ()
    if prepared is None:
        prepared = prepare_kernel(flat, cam, hard_slots)
    elif cot is not None and tuple(prepared.hard_slots) != hard_slots:
        raise ValueError(f"prepared for hard slots {prepared.hard_slots}, "
                         f"launched with {hard_slots}")
    if cot is not None:
        reason = grad_gate_reason(flat, len(hard_slots), want_tex)
        if reason is not None:
            raise ValueError(f"scene outside the CUDA grad kernel's gate: "
                             f"{reason}")
    n_pix = width * height
    n_lanes = lane_count(n_pix)
    nt = prepared.fields["NT"]
    n_wp, K, suffix = _grad_layout(flat, cot, hard_slots, want_tex)
    n_rows = _carry_rows(n_wp, K, suffix)
    _check_carry(carry, pix_lanes, n_lanes, n_rows)
    _check_iters(iters, n_lanes, device)
    if n_strata * n_strata + int(sample_start) >= 1 << 24:
        raise ValueError("sample indices must stay below 2^24")

    p = _Params(
        n_lanes=n_lanes, n_pix=n_pix, width=width, n_strata=n_strata,
        max_depth=max_depth, n_samples=n_samples,
        sample_start=int(sample_start), seed_mix=rng.mix_seed(seed),
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
    rad = torch.empty(3, n_lanes, dtype=torch.float32, device=device)
    st = (torch.empty(n_rows, n_lanes, dtype=torch.float32, device=device)
          if cap else None)
    lib = load_library()
    partial = None
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device)
                                 .cuda_stream)
        if cot is None and prepared.mode == "vscan":
            err = lib.forward_vscan(
                ctypes.byref(p), ctypes.byref(_VsParams(**prepared.vfields)),
                ptr(prepared.tables), ptr(prepared.vtab), ptr(pix_lanes),
                ptr(carry), ptr(rad), ptr(st), ptr(iters), stream)
        elif cot is None:
            err = lib.forward(ctypes.byref(p), ptr(prepared.tables),
                              ptr(pix_lanes), ptr(carry), ptr(rad), ptr(st),
                              ptr(iters), stream)
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
                    ptr(st), ptr(partial), ptr(iters), stream)
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
                       iters=None):
    """The forward kernel's wrapper: render_pass_reference's signature and
    results, on a CUDA device. `prepared` is prepare_kernel(flat, cam),
    packed here when not given; its mode picks the instance: the unrolled
    forward (K1) or, for a vscan scene, the chunk scan's (K6, with quad
    chunks K7). Launches on the current stream; raises if the scene is
    outside the gate, the inputs are malformed, or the launch fails. Each
    launch adds one to render_pass_kernel.launches, one of the chunk scan's
    to render_pass_kernel.launches_vscan, and one of those with quad chunks
    to render_pass_kernel.launches_vquad."""
    if prepared is None:
        prepared = prepare_kernel(flat, cam)
    rad, st, _, _ = _launch(
        flat, cam, seed, sample_start, width=width, height=height,
        n_strata=n_strata, max_depth=max_depth, n_samples=n_samples,
        sky_gradient=sky_gradient, cap=cap, carry=carry, pix_lanes=pix_lanes,
        prepared=prepared, iters=iters, cot=None)
    render_pass_kernel.launches += 1
    if prepared.mode == "vscan":
        render_pass_kernel.launches_vscan += 1
        render_pass_kernel.launches_vquad += prepared.vfields["Cq"] > 0
    return _pass_result(rad, st, cap=cap, pix_lanes=pix_lanes, width=width,
                        height=height)


render_pass_kernel.launches = 0
render_pass_kernel.launches_vscan = 0
render_pass_kernel.launches_vquad = 0


def render_pass_grad_kernel(flat: FlatScene, cam: CameraState, seed,
                            sample_start, *, width: int, height: int,
                            n_strata: int, max_depth: int, n_samples: int,
                            cotangent, hard_slots: tuple = (),
                            want_tex: bool = True,
                            sky_gradient: bool = False, cap: int = 0,
                            carry=None, pix_lanes=None,
                            prepared: KernelInputs | None = None,
                            iters=None):
    """The grad kernel's (K3, K4, K8) wrapper: render_pass_grad_reference's
    signature and results (the tier by tex_form), on a CUDA device.
    `prepared` is prepare_kernel(flat, cam, hard_slots), packed here when
    not given (its slots must be `hard_slots`); its mode picks the unrolled
    instances or the chunk scan's (K3v, K4v, K8). The kernel writes one row
    of dG_tex and dG_hard partial sums per block; they are summed here.
    Raises as render_pass_kernel does, for a malformed cotangent, and for a
    pass outside grad_gate_reason. Each launch adds one to
    render_pass_grad_kernel.launches; one with hard slots (the K4
    instances) to .hard_launches; one on the chunk scan's selection with
    weight planes (K3v) to .vscan_tex_launches and one with hard slots
    (K4v) to .vscan_hard_launches; one of the suffix tier (K8) to
    .suffix_launches."""
    cot = cotangent_lanes(cotangent, width=width, height=height,
                          pix_lanes=pix_lanes)
    rad, st, dg_tex, dg_hard = _launch(
        flat, cam, seed, sample_start, width=width, height=height,
        n_strata=n_strata, max_depth=max_depth, n_samples=n_samples,
        sky_gradient=sky_gradient, cap=cap, carry=carry, pix_lanes=pix_lanes,
        prepared=prepared, iters=iters, cot=cot, hard_slots=hard_slots,
        want_tex=want_tex)
    render_pass_grad_kernel.launches += 1
    form = tex_form(flat, want_tex)
    if hard_slots:
        render_pass_grad_kernel.hard_launches += 1
    if kernel_mode(flat)[0] == "vscan":
        render_pass_grad_kernel.vscan_tex_launches += form == "planes"
        render_pass_grad_kernel.vscan_hard_launches += bool(hard_slots)
    render_pass_grad_kernel.suffix_launches += form == "suffix"
    return _grad_result(rad, dg_tex, dg_hard, st, cap=cap,
                        pix_lanes=pix_lanes, width=width, height=height)


render_pass_grad_kernel.launches = 0
render_pass_grad_kernel.hard_launches = 0
render_pass_grad_kernel.vscan_tex_launches = 0
render_pass_grad_kernel.vscan_hard_launches = 0
render_pass_grad_kernel.suffix_launches = 0


def pass_function(flat: FlatScene, cam: CameraState,
                  prepared: KernelInputs | None = None):
    """The pass function for the scene's device: the CUDA kernel, with the
    scene and camera packed once (or `prepared`), for a scene on a CUDA
    device; the plain torch version for a scene on the CPU."""
    if flat.device.type == "cuda":
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
        key = torch.where(st[0] > 0.5, n_samples - st[3],
                          torch.full_like(st[3], -1.0))
        order = torch.argsort(-key, stable=True)
        perm = perm[order]
        r, st = run_phase(cap_i, pix_abs[perm], st[:, order], perm)
        rad.index_add_(1, perm, r)
    return rad


def render_pass_compacted(flat: FlatScene, cam: CameraState, seed,
                          sample_start, *, width: int, height: int,
                          n_strata: int, max_depth: int, n_samples: int,
                          sky_gradient: bool = False, cap: int = 0,
                          phases: int = 2, caps: tuple | None = None,
                          pass_fn=None):
    """Capped + lane-compacted schedule: run the wavefront for caps[0]
    iterations, sort lanes by remaining samples, resume the carried states
    under that lane -> pixel permutation, and so on; an uncapped pass
    finishes. RNG keys are pixel ids, so the permutation changes no sample
    stream. caps == () is one uncapped pass. pass_fn runs each phase
    (default pass_function(flat, cam); the plain version may be given
    explicitly for a scene on the card).
    Returns the (height, width, 3) radiance-sum image."""
    if caps is None:
        caps = default_caps(flat, n_samples, max_depth, cap, phases)
    caps = _check_caps(caps)
    if pass_fn is None:
        pass_fn = pass_function(flat, cam)
    common = dict(width=width, height=height, n_strata=n_strata,
                  max_depth=max_depth, n_samples=n_samples,
                  sky_gradient=sky_gradient)
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
                               caps: tuple | None = None, pass_fn=None):
    """The capped + lane-compacted schedule of the grad pass (K5,
    wavefront_pallas.py:3807-3888): render_pass_compacted's phases, with
    the weight and tangent planes riding the carry, the cotangent lanes
    permuted with the lanes, and dG_tex and dG_hard (sums over lanes, which
    no permutation changes) summed across phases. caps default to
    default_grad_caps; () is one uncapped grad pass. pass_fn runs each
    phase (default grad_pass_function(flat, cam, hard_slots=hard_slots)).
    Returns (image, dG_tex, dG_hard) as the single grad pass does."""
    if caps is None:
        caps = default_grad_caps(flat, width, height, n_samples, max_depth)
    caps = _check_caps(caps)
    if pass_fn is None:
        pass_fn = grad_pass_function(flat, cam, hard_slots=hard_slots)
    common = dict(width=width, height=height, n_strata=n_strata,
                  max_depth=max_depth, n_samples=n_samples,
                  sky_gradient=sky_gradient, hard_slots=hard_slots,
                  want_tex=want_tex)
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
