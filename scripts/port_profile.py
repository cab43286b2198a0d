#!/usr/bin/env python3
"""Where a kernel of the PyTorch + CUDA port spends its time, on one GPU.

    python3 scripts/port_profile.py ROOT SET

ROOT holds the real_time_ray_tracing_engine_tpu_torch package to profile.
The script builds its csrc/wavefront.cu as the package does (the parts
compiled in parallel, then linked) into ROOT/build/profile/, then builds
variants: a copy of the source with a few lines replaced, of which only the
part holding the kernel under study is compiled again and linked with the
base build's other parts. Each variant library is timed with chip_smoke.py's
scenes and timer (CUDA events, best of 3 after one warm-up, the scene
packed once). A variant whose replacement text is missing from the source
fails: the sets name the source they apply to. SET is one of:

  parent  (the source before the slot groups and the hand-written
          reverse, commit c0d1d3c; a checkout of it unpacked under a
          git-ignored directory): K4, wavefront_grad_kernel<8,
          true>, at Cornell 1920x1080 spp64 d50 with its 9 hard slots,
          whole; with the dual passes' tangent writes (planes and dG) left
          out, their values kept alive (the value half); with no dual pass
          (the float pass and its selection); with the planes' shared
          memory reads and writes left out, the tangents kept alive (their
          shared-memory traffic); and the share of (warp, slot, bounce)
          dual passes after which no lane of the warp holds a nonzero plane
          or reads a cell of the slot (what an exact-zero skip removes).
          K9, wavefront_adjoint_kernel, at bouncing_spheres 1200x675 spp16
          d50 under the sky gradient, whole; phase F alone (no reverse
          bounce); and with the double atomics left out (the values kept
          alive).
  new     (this source): K4 at the same shape with the slot-group width
          HARD_W at 1 (the source's), 2 and 4, the group pass out of line
          (the source's) or inlined into each instance, the ptxas figures
          of each beside its time; the share of (warp, group, bounce) passes the warp-wide
          skip removed; K9 at the same shape whole, phase F alone, without
          the double atomics (the values kept alive), and with its
          accumulators in the global row in place of the block's shared
          memory.
  k3      (the source before K3's redesign, commit c7f8bd9): K3,
          wavefront_grad_kernel<8, false>, at Cornell 1920x1080 spp64 d50
          (tex_color, NT 6), whole; with the weight planes' updates left
          out (miss, emission and scatter; the planes then stay 0 and the
          compiler drops them); with the block reduction's shuffle trees
          left out (Gp kept alive); with an instance sized to NT 6 in
          place of 8 (no padded planes); and the forward kernel
          (wavefront_forward_kernel) at the same shape; each with the
          blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor
          at the launch's shared memory) beside its ptxas figures.
  k3new   (this source): K3, now wavefront_tex_grad_kernel<8> (its
          register planes held to four blocks an SM), at the same shape,
          whole; with __launch_bounds__ asking for no block count (the
          parent's three blocks an SM) and for five; with an instance
          sized to NT 6; and the forward kernel; blocks an SM and ptxas
          figures beside each. And K8, the suffix tier, at
          bouncing_spheres 1200x675 spp16 d50, whole.
  k6, k11 (the source before the chunk scan's group boxes and the stack
          walk's two-box rows, commit 13b9e41): the selections of K6/K7
          (closest_select_vscan in wavefront_forward_vscan_kernel) at
          bouncing_spheres 1200x675 spp16 d50, the 4,913-sphere grid
          400x225 spp9 d8, the 301-quad city 400x225 spp9 d6 and K4v's
          79-sphere scene 1200x675 spp16 d50, and of K11
          (closest_select_stack) at bouncing_spheres -b 1200x675 spp16 d50
          and the 4,913- and 32,768-sphere grids -b 400x225 spp9 d8: the
          whole kernel; its counts a bounce (a counter that exists only in
          the patched copy: box and sphere or quad tests; node fetches,
          pushes and leaf-primitive tests); with a second selection (its
          winner kept alive, never taken: the difference is the
          selection's time); with a second walk whose primitive tests are
          short-circuited, culled at the first's final t; each with its
          ptxas figures and blocks an SM.
  k6new, k11new (this source): the same splits (K6 also counts its group
          boxes; K11 its inner and leaf rows, pushes, leaf primitives and
          pops), and K6 with sphere groups of 4, 16 and 32 rows, quad
          groups of 8, the group boxes in shared memory, the chunks walked
          from the last where the ray's x is negative; K11 with one step a
          loop iteration, and holding the first leaf it meets while it
          walks on (speculative).

  k1, k12 (the source before the forward's persistent threads and the
          lane walk's octant links, commit f55c712): the forward (K1,
          wavefront_forward_kernel) at Cornell 600x600 spp16 and spp100 d50
          and 1920x1080 spp64 d50, single pass and compacted schedule: the
          whole kernel; the share of a warp's lanes each iteration of the
          bounce loop keeps busy (active); each block's start, end and SM
          (%globaltimer, %smid), giving the share of the launch with fewer
          SMs busy than the card has and with fewer blocks than it keeps
          resident (timeline); a second selection and a second bounce
          (their winner and radiance kept alive, never taken); blocks an
          SM, ptxas figures and the SASS count beside the float bounce of
          commit 55b6ee0 (its source at FLOAT_BOUNCE_SOURCE). And the
          lane walk (K12, closest_select_lane) at K11's shapes (k11's):
          the whole kernel; node rows, boxes met and sphere tests a
          selection, whether the first leaf it enters holds the final t
          and whether it holds no hit; a second walk, and one without its
          tests.
  k1new, k12new (this source): the same splits; K1 with no block count
          asked of __launch_bounds__, with 6, and in 64-thread blocks; K12
          with its octant links in a table of their own, the top of the
          tree in shared memory (breadth-first ids), breadth-first ids
          alone, and persistent threads (K1's); the layouts and block
          counts in two turns each.

  k3v     (the source before K3v's redesign, commit 9c24ad0; a checkout
          of it as ROOT): K3v, wavefront_grad_vscan_kernel<8, false,
          false> on the 80-sphere scene (7 rows) and <0, false, false,
          true> (its planes in shared memory) on the 28-row scene, at
          1200x675 spp16 d50, single pass and compacted: whole; with the
          planes' updates left out; the histograms of the distinct eff
          rows a path scatters on (its Wp rows) and of the rows a lane's
          Gp touches over its samples, with the rows a scatter's and a
          radiance event's planes hold; beside them the chunk-scan forward
          (K6) on both scenes and the suffix tier (K8) forced onto the
          28-row scene; ptxas figures and blocks an SM of each.
  k3vnew  (this source): K3v's row planes (wavefront_planes_vscan_kernel)
          on both scenes, with K4v's slots, and the walks'
          (wavefront_planes_bvh_kernel) on the 28-row scene -b: the
          source's 7 blocks an SM (5 with the slots); 4, 5, 6 and 8 blocks
          (2, 3 and 4 with the slots; the walks 5, 6 and no block count);
          the planes' updates left out, at the scatter only or at the
          radiance events only; the source again, measured last; K6
          beside them; the host's free-memory check and scratch
          allocation, which a pass's CUDA-event time also counts; and
          tex_color with 8, 16, 24 and 30 fuzz slots on chip_smoke.py's
          metals scene (31 rows) at 1200x675 spp16 d50 under the sky
          gradient, K3v with K4v's slots, beside the adjoint (K9) on the
          same request.

Prints one JSON line per measurement and each build's ptxas figures of the
kernels under study (registers, stack, spills).
"""
from __future__ import annotations

import ctypes
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)

K4 = "_Z21wavefront_grad_kernelILi8ELb1EEv8WfParamsPKfPKiS2_S2_PfS5_S5_Pi"
K9 = "wavefront_adjoint_kernel"

# ---- the parent's variants (wavefront.cu at commit c0d1d3c)
_P_TANGENT_WRITES = (
    """                dgs[k * WF_THREADS] = dgs[k * WF_THREADS]
                    + (gc[0] * rd.x.t + gc[1] * rd.y.t + gc[2] * rd.z.t);
                if (alive_new) {""",
    """                dgs[k * WF_THREADS] = dgs[k * WF_THREADS] + 0.0f * (
                    rd.x.v + rd.y.v + rd.z.v + od.x.v + od.y.v + od.z.v
                    + dd.x.v + dd.y.v + dd.z.v + td.x.v + td.y.v + td.z.v);
                if (false) {""")
_P_NO_DUAL = ("const int n_dual = (SUFFIX && phB) ? 0 : P.K;",
              "const int n_dual = 0;")
_P_NO_SMEM = [(f"{a}.{c} = dual({s}.{c}, ds[{i} * WF_THREADS]);",
               f"{a}.{c} = dual({s}.{c}, 0.0f);")
              for i, (a, s, c) in enumerate(
                  [(a, s, c) for a, s in (("od", "o0"), ("dd", "d0"),
                                          ("td", "th0"))
                   for c in "xyz"])] + [_P_TANGENT_WRITES[:1] + (
    """                dgs[0] = dgs[0] + 0.0f * (
                    gc[0] * rd.x.t + gc[1] * rd.y.t + gc[2] * rd.z.t
                    + od.x.t + od.y.t + od.z.t + dd.x.t + dd.y.t + dd.z.t
                    + td.x.t + td.y.t + td.z.t);
                if (false) {""",)]
# count, per (warp, slot, bounce) dual pass, whether any lane of the warp
# holds a nonzero plane of the slot or reads one of its cells (the winner's
# sphere row, the hit material's fuzz or IOR, a light row's source sphere at
# an MIS bounce); read back by rt_prof_counts
_COUNTERS = """
__device__ unsigned long long prof_counts[2];
extern "C" int rt_prof_counts(unsigned long long* out, int reset) {
    cudaError_t e = cudaMemcpyFromSymbol(out, prof_counts,
                                         2 * sizeof(unsigned long long));
    if (reset) {
        const unsigned long long z[2] = {0, 0};
        cudaMemcpyToSymbol(prof_counts, z, sizeof(z));
    }
    return (int)e;
}
"""
_P_SKIP_COUNT = [
    ("#define SEL_LANE 3      // the lane BVH (K12)",
     "#define SEL_LANE 3      // the lane BVH (K12)\n" + _COUNTERS),
    ("u_med, Seed{0, 0, 0}, Wp, Gp, gc, SUFFIX ? &ev : nullptr,",
     "u_med, Seed{0, 0, 0}, Wp, Gp, gc, &ev,"),
    ("                float* ds = dst + 9 * k * WF_THREADS;\n"
     "                const float* sl = sc.slot + SLOT_COLS * k;\n"
     "                const Seed sd = {(int)sl[0], (int)sl[1], (int)sl[2]};\n",
     """                float* ds = dst + 9 * k * WF_THREADS;
                const float* sl = sc.slot + SLOT_COLS * k;
                const Seed sd = {(int)sl[0], (int)sl[1], (int)sl[2]};
                {
                    bool need = false;
                    for (int c = 0; c < 9; ++c)
                        need = need || ds[c * WF_THREADS] != 0.0f;
                    const int mt = ev.hit ? (int)sc.mati[ev.mat * 2] : 0;
                    if (sd.tab == SEED_SPH && best >= 0 && best < sc.S
                        && sd.row == best)
                        need = true;
                    if (sd.tab == SEED_MATF && ev.hit && sd.row == ev.mat
                        && ((mt == MAT_METAL && sd.col == 0)
                            || (mt == MAT_DIELECTRIC && sd.col == 1)))
                        need = true;
                    if (sd.tab == SEED_SPH && ev.hit && sc.L > 0
                        && mt != MAT_METAL && mt != MAT_DIELECTRIC
                        && mt != MAT_DIFFUSE_LIGHT) {
                        for (int l = 0; l < sc.L; ++l)
                            need = need || (int)sc.lsrc[l] == sd.row;
                    }
                    const unsigned act = __activemask();
                    const unsigned any = __ballot_sync(act, need);
                    if ((threadIdx.x & 31) == __ffs(act) - 1) {
                        atomicAdd(&prof_counts[0], 1ull);
                        if (!any) atomicAdd(&prof_counts[1], 1ull);
                    }
                }
""")]
_P_K9_NO_R = ("""        for (int b = n_used - 1; b >= 0; --b)
            adj_reverse_bounce(""", """        for (int b = n_used - 1; b >= 0 && false; --b)
            adj_reverse_bounce(""")
_P_K9_NO_ATOMICS = [
    ("if (v != 0.0f) atomicAdd(acc + 3 * eff + c, (double)v);",
     "if (v != 0.0f) lam[0] = lam[0] + 0.0f * v;"),
    ("else if (v != 0.0f) atomicAdd(acc + target, (double)v);",
     "else if (v != 0.0f) nl[0] = nl[0] + 0.0f * v;")]

# ---- this source's variants
_N_K9_NO_R = _P_K9_NO_R
_N_K9_NO_ATOMICS = [("if (v != 0.0f) atomicAdd(acc + i, (double)v);",
                     "if (v == 1.2345e30f) acc[i] = (double)v;")]
_N_SKIP_COUNT = [
    ("#define SEL_LANE 3      // the lane BVH (K12)",
     "#define SEL_LANE 3      // the lane BVH (K12)\n" + _COUNTERS),
    ("""                    const bool run = __ballot_sync(
                        __activemask(), (need & gm) != 0u) != 0u;""",
     """                    const unsigned act = __activemask();
                    const bool run = __ballot_sync(
                        act, (need & gm) != 0u) != 0u;
                    if ((threadIdx.x & 31) == __ffs(act) - 1) {
                        atomicAdd(&prof_counts[0], 1ull);
                        if (!run) atomicAdd(&prof_counts[1], 1ull);
                    }""")]


# ---- K3's variants (wavefront.cu at commit c7f8bd9)
K3 = "_Z21wavefront_grad_kernelILi8ELb0EEv8WfParamsPKfPKiS2_S2_PfS5_S5_Pi"
K3_NT6 = "_Z21wavefront_grad_kernelILi6ELb0EEv8WfParamsPKfPKiS2_S2_PfS5_S5_Pi"
K1 = "wavefront_forward_kernel"
# the blocks an SM holds of K3 (<8, false> and, where the variant has it,
# <6, false>) and of the forward kernel, at n_table floats of dynamic shared
# memory; read back by rt_prof_occupancy
def _occupancy(nt6: bool = False) -> list:
    return [("#endif  // WF_IN_PART(0)", """
template <int NTMAX>
static int prof_blocks(int* out, size_t smem) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, wavefront_grad_kernel<NTMAX, false>, WF_THREADS, smem);
}
extern "C" int rt_prof_occupancy(int n_table, int* out) {
    const size_t smem = (size_t)n_table * sizeof(float);
    int e = prof_blocks<8>(out, smem);
    if (e == 0)
        e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            out + 1, wavefront_forward_kernel, WF_THREADS, smem);
""" + ("    if (e == 0) e = prof_blocks<6>(out + 2, smem);\n" if nt6 else "")
        + """    return e;
}
#endif  // WF_IN_PART(0)""")]
# ---- K3's variants on this source: its own kernel,
# wavefront_tex_grad_kernel<8>, its register planes held to four blocks an
# SM
K3_NEW = "_Z25wavefront_tex_grad_kernelILi8EE"
K8 = ("_Z27wavefront_grad_vscan_kernelILi0ELb0ELb1ELb0EEv8WfParams"
      "8VsParams8GradArgs")
_OCCUPANCY_NEW = [("#endif  // WF_IN_PART(0)", """
extern "C" int rt_prof_occupancy(int smem_k3, int smem_fwd, int* out) {
    int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, wavefront_tex_grad_kernel<8>, WF_THREADS, (size_t)smem_k3);
    if (e == 0)
        e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            out + 1, wavefront_forward_kernel, WF_THREADS, (size_t)smem_fwd);
    return e;
}
#endif  // WF_IN_PART(0)""")]
_K3_NT6_NEW = [(
    """        return P.NT <= 8 ? launch_tex_grad<8>(WF_GRAD_ARGS)""",
            """        return P.NT <= 6 ? launch_tex_grad<6>(WF_GRAD_ARGS)
            : P.NT <= 8 ? launch_tex_grad<8>(WF_GRAD_ARGS)""")]


def _k3_blocks(n: int) -> list:
    """K3's __launch_bounds__ asking for n blocks an SM (0: none)."""
    return [("__global__ void __launch_bounds__(WF_THREADS, 4)\n"
             "wavefront_tex_grad_kernel(",
             "__global__ void __launch_bounds__(WF_THREADS"
             + (f", {n}" if n else "") + ")\nwavefront_tex_grad_kernel(")]


def _ptxas_prefix(log: str, prefix: str):
    return next((v for k, v in cs.ptxas_table(log).items()
                 if k.startswith(prefix)), None)


_K3_NO_UPDATES = [
    ("""            for (int k = 0; k < 3 * NTMAX; ++k)
                Gp[k] = Gp[k] + gc[k % 3] * Wp[k] * sk[k % 3];""",
     """            for (int k = 0; k < 0; ++k)
                Gp[k] = Gp[k] + gc[k % 3] * Wp[k] * sk[k % 3];"""),
    ("""            for (int k = 0; k < 3 * NTMAX; ++k)
                Gp[k] = Gp[k] + gc[k % 3] * (""",
     """            for (int k = 0; k < 0; ++k)
                Gp[k] = Gp[k] + gc[k % 3] * ("""),
    ("""            for (int k = 0; k < 3 * NTMAX; ++k)
                Wp[k] = (Wp[k] * av[k % 3]""",
     """            for (int k = 0; k < 0; ++k)
                Wp[k] = (Wp[k] * av[k % 3]""")]
_K3_NO_REDUCTION = [("""                float v = Gp[k];
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    v += __shfl_down_sync(0xffffffffu, v, off);
                if (wl == 0) red[warp * 3 * NTMAX + k] = v;""",
                     """                float v = Gp[k];
                if (v == 1.2345e30f) red[warp * 3 * NTMAX + k] = v;""")]
_K3_NT6 = [("""        return P.NT <= 8 ? launch_grad<8, false>(WF_GRAD_ARGS)
                         : launch_grad<16, false>(WF_GRAD_ARGS);""",
            """        return P.NT <= 6 ? launch_grad<6, false>(WF_GRAD_ARGS)
            : P.NT <= 8 ? launch_grad<8, false>(WF_GRAD_ARGS)
                         : launch_grad<16, false>(WF_GRAD_ARGS);""")]


# hard_group inlined into each grad instance (the source keeps it out of
# line)
_INLINE = [("__device__ __noinline__ void hard_group(",
            "__device__ __forceinline__ void hard_group(")]
# the adjoint's accumulators in the global row (RED.F64 in the L2) in place
# of the block's shared copy (compare-and-swap loops)
_GLOBAL_ACC = [("""    shared_acc = boxes * sizeof(float) + n_acc * sizeof(double)
        <= (size_t)(226 * 1024);""", """    shared_acc = false;""")]


def _hard_w(w):
    return [("#define HARD_W 1 ", f"#define HARD_W {w} ")]


SETS = {
    "parent": [
        ("k4", "whole", 0, []),
        ("k4", "values_only", 0, [_P_TANGENT_WRITES]),
        ("k4", "float_pass_only", 0, [_P_NO_DUAL]),
        ("k4", "no_plane_smem", 0, _P_NO_SMEM),
        ("k4", "skip_count", 0, _P_SKIP_COUNT),
        ("k9", "whole", 4, []),
        ("k9", "phase_f_only", 4, [_P_K9_NO_R]),
        ("k9", "no_atomics", 4, _P_K9_NO_ATOMICS),
    ],
    "new": [
        ("k4", "whole", 0, []),
        ("k4", "hard_w1_inline", 0, _INLINE),
        ("k4", "hard_w2", 0, _hard_w(2)),
        ("k4", "hard_w2_inline", 0, _hard_w(2) + _INLINE),
        ("k4", "hard_w4", 0, _hard_w(4)),
        ("k4", "hard_w4_inline", 0, _hard_w(4) + _INLINE),
        ("k4", "skip_count", 0, _N_SKIP_COUNT),
        ("k9", "whole", 4, []),
        ("k9", "phase_f_only", 4, [_N_K9_NO_R]),
        ("k9", "no_atomics", 4, _N_K9_NO_ATOMICS),
        ("k9", "global_acc", 4, _GLOBAL_ACC),
    ],
    "k3": [
        ("k3", "whole", 0, _occupancy()),
        ("k3", "no_plane_updates", 0, _K3_NO_UPDATES + _occupancy()),
        ("k3", "no_reduction", 0, _K3_NO_REDUCTION + _occupancy()),
        ("k3", "nt6_instance", 0, _K3_NT6 + _occupancy(True)),
        ("k1", "forward", 0, _occupancy()),
    ],
    "k3new": [
        ("k3", "4_blocks", 0, _OCCUPANCY_NEW),
        ("k3", "3_blocks", 0, _k3_blocks(0) + _OCCUPANCY_NEW),
        ("k3", "5_blocks", 0, _k3_blocks(5) + _OCCUPANCY_NEW),
        ("k3", "nt6_instance_4_blocks", 0, _K3_NT6_NEW + _OCCUPANCY_NEW),
        ("k1", "forward", 0, _OCCUPANCY_NEW),
        ("k8", "whole", 2, []),
    ],
}


# ---- the selections' splits (K6 and K7, the chunk scan's
# closest_select_vscan in wavefront_forward_vscan_kernel, part 0; K11, the
# stack walk's closest_select_stack in wavefront_forward_bvh_kernel<SEL_STACK>,
# part 6). Six counters (rt_prof_counts): selections, then per kernel what
# it tests (_COUNT_NAMES): on the parent's source (13b9e41), K6 box tests,
# sphere tests, quad tests; K11 node fetches, pushes, leaf-primitive tests;
# on this source K6 adds the group-box tests, K11 counts inner-row and leaf
# fetches, pushes, leaf-primitive tests and pops apart. Each selection adds
# its own counts once, a warp at a time.
K6 = "wavefront_forward_vscan_kernel"
K11 = "_Z28wavefront_forward_bvh_kernelILi2EEv8WfParams8BvParams8GradArgs"
_SEL_COUNTERS = """
__device__ unsigned long long prof_counts[6];
extern "C" int rt_prof_counts(unsigned long long* out, int reset) {
    cudaError_t e = cudaMemcpyFromSymbol(out, prof_counts,
                                         6 * sizeof(unsigned long long));
    if (reset) {
        const unsigned long long z[6] = {0, 0, 0, 0, 0, 0};
        cudaMemcpyToSymbol(prof_counts, z, sizeof(z));
    }
    return (int)e;
}
__device__ __forceinline__ void prof_add(int i, unsigned v) {
    const unsigned m = __activemask();
    const unsigned s = __reduce_add_sync(m, v);
    if ((threadIdx.x & 31) == __ffs(m) - 1)
        atomicAdd(&prof_counts[i], (unsigned long long)s);
}
"""
_SEL_HEAD = ("#define SEL_LANE 3      // the lane BVH (K12)",
             "#define SEL_LANE 3      // the lane BVH (K12)\n" + _SEL_COUNTERS)
# the blocks an SM holds of the kernel under study at `smem` bytes of
# dynamic shared memory (rt_prof_occupancy)
_OCC_K6 = ("#endif  // WF_IN_PART(0)", """
extern "C" int rt_prof_occupancy(int smem, int* out) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, wavefront_forward_vscan_kernel, WF_THREADS, (size_t)smem);
}
#endif  // WF_IN_PART(0)""")
_OCC_K11 = ("WF_BVH_ENTRY(rt_wavefront_bvh_stack, SEL_STACK)", """WF_BVH_ENTRY(rt_wavefront_bvh_stack, SEL_STACK)
extern "C" int rt_prof_occupancy(int smem, int* out) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, wavefront_forward_bvh_kernel<SEL_STACK>, WF_THREADS,
        (size_t)smem);
}""")


def _function(text: str, head: str) -> str:
    """The definition that starts at `head` in `text`, to its closing brace
    at the start of a line."""
    i = text.index(head)
    return text[i:text.index("\n}\n", i) + 3]


def _walk_copy(text: str, head: str, name: str) -> str:
    """A copy of the selection at `head`, renamed `name`, whose primitive
    tests are short-circuited (the rows are still fetched; a test that
    cannot pass takes the place of sphere_root and quad_hit) and whose
    running best t starts at *t_best: given the real selection's t, it
    fetches the boxes, nodes and rows the real walk fetches once its
    winner is known, and tests none of them."""
    fn = _function(text, head)
    old_name = head.split("(")[0].split()[-1]
    fn = fn.replace(old_name + "(", name + "(", 1)
    fn = fn.replace("float best_t = BIGF;", "float best_t = *t_best;")
    fn = fn.replace("scan_spheres(", "scan_spheres_walk(")
    fn = fn.replace("scan_quads(", "scan_quads_walk(")
    sph = _function(text, "__device__ __forceinline__ void scan_spheres(")
    sph = sph.replace("scan_spheres(", "scan_spheres_walk(", 1).replace(
        "if (sphere_root(c, B.z, o, d, a, &t))",
        "t = c.x;\n        if (B.z == 1.2345e30f)")
    quad = _function(text, "__device__ __forceinline__ void scan_quads(")
    quad = quad.replace("scan_quads(", "scan_quads_walk(", 1).replace(
        "if (quad_hit(q, o, d, T_MINF, &t))",
        "t = q[0];\n        if (q4.y == 1.2345e30f)")
    return sph + "\n" + quad + "\n" + fn


def _second_select(call: str, head: str, walk: bool) -> list:
    """A second selection after the real one (`call`, its text in
    wavefront_body): the same function (walk False; the difference to the
    whole kernel is the selection's time) or its walk copy (walk True; the
    boxes, nodes and rows without the tests). Its winner is kept alive
    and never taken."""
    fname = head.split("(")[0].split()[-1]
    args = call[call.index("(") + 1:call.rindex("&best_t")]
    if walk:
        second = (f"float t2_ = best_t;\n                if ("
                  f"{fname}_walk({args}&t2_) == -7) best = -1;")
    else:
        second = (f"float t2_;\n                if ({fname}({args}&t2_)"
                  f" == -7) best = -1;")
    call_line = call.strip()
    repl = [(call, call.replace(call_line, "{ " + call_line + "\n"
                                "                " + second + " }"))]
    if walk:
        repl.append(functools.partial(_walk_insert, head=head))
    return repl


def _walk_insert(text: str, head: str) -> str:
    """text with the walk copy of `head` inserted after its definition."""
    fn = _function(text, head)
    fname = head.split("(")[0].split()[-1]
    return text.replace(fn, fn + "\n" + _walk_copy(text, head,
                                                    fname + "_walk"), 1)


_VS_HEAD = "static __device__ int closest_select_vscan("
_ST_HEAD = "static __device__ int closest_select_stack("
_VS_CALL_P = """                best = closest_select_vscan(sc, V, vtab, smem, o, d, tm,
                                            &best_t);"""
_ST_CALL_P = """                best = closest_select_stack(B, vtab, o, d, tm, &best_t);"""
# the parent's selections, counted (wavefront.cu at commit 13b9e41)
_K6_COUNT_P = [_SEL_HEAD, (
    """        if (box_reaches(box + 6 * c, o, inv, best_t))
            scan_spheres(rows + (size_t)c * VCHUNK * VROW_COLS, VCHUNK, true,
                         o, d, a, tm, best_t, best);""",
    """        ++n_box;
        if (box_reaches(box + 6 * c, o, inv, best_t)) {
            const float* rr = rows + (size_t)c * VCHUNK * VROW_COLS;
            for (int r = 0; r < VCHUNK; ++r) {
                if (rr[r * VROW_COLS + 7] < 0.0f) break;
                ++n_sph;
            }
            scan_spheres(rr, VCHUNK, true, o, d, a, tm, best_t, best);
        }"""), (
    """    if (V.n_big > 0)
        scan_spheres(rows + (size_t)V.C_small * VCHUNK * VROW_COLS, V.n_big,
                     false, o, d, a, tm, best_t, best);""",
    """    unsigned n_box = 0, n_sph = V.n_big, n_quad = 0;
    if (V.n_big > 0)
        scan_spheres(rows + (size_t)V.C_small * VCHUNK * VROW_COLS, V.n_big,
                     false, o, d, a, tm, best_t, best);"""), (
    """            if (box_reaches(qbox + 6 * k, o, inv, best_t))
                scan_quads(qrows + (size_t)k * VCHUNK * QROW_COLS, VCHUNK, o,
                           d, best_t, best);""",
    """            ++n_box;
            if (box_reaches(qbox + 6 * k, o, inv, best_t)) {
                const float* qq = qrows + (size_t)k * VCHUNK * QROW_COLS;
                for (int r = 0; r < VCHUNK; ++r) {
                    if (qq[r * QROW_COLS + 16] < 0.0f) break;
                    ++n_quad;
                }
                scan_quads(qq, VCHUNK, o, d, best_t, best);
            }"""), (
    """                take_closer(t, sc.S + q, best_t, best);
        }
    }
    *t_best = best_t;""",
    """                take_closer(t, sc.S + q, best_t, best);
        }
        n_quad += sc.Q;
    }
    prof_add(0, 1u); prof_add(1, n_box); prof_add(2, n_sph);
    prof_add(3, n_quad);
    *t_best = best_t;""")]
_K11_COUNT_P = [_SEL_HEAD, (
    """        const int node = stack[--sp];
        float b[6];""",
    """        const int node = stack[--sp];
        ++n_fetch;
        float b[6];"""), (
    """    int stack[STACK_DEPTH];
    int sp = 0;
    stack[sp++] = 0;""",
    """    unsigned n_fetch = 0, n_push = 0, n_prim = 0;
    int stack[STACK_DEPTH];
    int sp = 0;
    stack[sp++] = 0;"""), (
    """        if (n1.z > 0.5f) {
            scan_spheres(""",
    """        if (n1.z > 0.5f) {
            n_prim += (unsigned)n2.y + (unsigned)n2.w;
            scan_spheres("""), (
    """            stack[sp++] = da >= 0.0f ? left : right;
        }
    }
    *t_best = best_t;""",
    """            stack[sp++] = da >= 0.0f ? left : right;
            n_push += 2;
        }
    }
    prof_add(0, 1u); prof_add(1, n_fetch); prof_add(2, n_push);
    prof_add(3, n_prim);
    *t_best = best_t;""")]


def _split_set(kern: str, part: int, call: str, head: str, count: list,
               occ: tuple) -> list:
    """A selection's splits: whole, counted, selected twice, and walked a
    second time without its tests (each with rt_prof_occupancy)."""
    return [(kern, "whole", part, [occ]),
            (kern, "counts", part, count + [occ]),
            (kern, "select_twice", part,
             _second_select(call, head, False) + [occ]),
            (kern, "walk_twice", part,
             _second_select(call, head, True) + [occ])]


SETS["k6"] = _split_set("k6", 0, _VS_CALL_P, _VS_HEAD, _K6_COUNT_P, _OCC_K6)
SETS["k11"] = _split_set("k11", 6, _ST_CALL_P, _ST_HEAD, _K11_COUNT_P,
                         _OCC_K11)

# ---- this source's selections: K6's group boxes, K11's two-box rows
_K6_COUNT = [_SEL_HEAD, (
    """    if (V.n_big > 0)
        scan_spheres(rows + (size_t)V.C_small * VCHUNK * VROW_COLS, V.n_big,
                     false, o, d, a, tm, best_t, best);
    for (int c = 0; c < V.C_small; ++c) {
        if (!box_reaches(box + 6 * c, o, inv, best_t)) continue;
        for (int g = 0; g < VGROUPS; ++g) {
            if (group_reaches(gbox, c * VGROUPS + g, o, inv, best_t))
                scan_spheres(""",
    """    unsigned n_box = 0, n_gbox = 0, n_sph = V.n_big, n_quad = 0;
    if (V.n_big > 0)
        scan_spheres(rows + (size_t)V.C_small * VCHUNK * VROW_COLS, V.n_big,
                     false, o, d, a, tm, best_t, best);
    for (int c = 0; c < V.C_small; ++c) {
        ++n_box;
        if (!box_reaches(box + 6 * c, o, inv, best_t)) continue;
        for (int g = 0; g < VGROUPS; ++g) {
            ++n_gbox;
            if (group_reaches(gbox, c * VGROUPS + g, o, inv, best_t))
                for (int r = 0; r < VGROUP; ++r) {
                    if (rows[(size_t)(c * VCHUNK + g * VGROUP + r)
                             * VROW_COLS + 7] < 0.0f) break;
                    ++n_sph;
                }
            if (group_reaches(gbox, c * VGROUPS + g, o, inv, best_t))
                scan_spheres("""), (
    """            if (!box_reaches(box + 6 * (j0 + k), o, inv, best_t)) continue;
            for (int g = 0; g < QGROUPS; ++g) {
                if (group_reaches(gbox, j0 * VGROUPS + k * QGROUPS + g, o,
                                  inv, best_t))
                    scan_quads(""",
    """            ++n_box;
            if (!box_reaches(box + 6 * (j0 + k), o, inv, best_t)) continue;
            for (int g = 0; g < QGROUPS; ++g) {
                ++n_gbox;
                if (group_reaches(gbox, j0 * VGROUPS + k * QGROUPS + g, o,
                                  inv, best_t))
                    for (int r = 0; r < QGROUP; ++r) {
                        if (qrows[(size_t)(k * VCHUNK + g * QGROUP + r)
                                  * QROW_COLS + 16] < 0.0f) break;
                        ++n_quad;
                    }
                if (group_reaches(gbox, j0 * VGROUPS + k * QGROUPS + g, o,
                                  inv, best_t))
                    scan_quads("""), (
    """                take_closer(t, sc.S + q, best_t, best);
        }
    }
    *t_best = best_t;""",
    """                take_closer(t, sc.S + q, best_t, best);
        }
        n_quad += sc.Q;
    }
    prof_add(0, 1u); prof_add(1, n_box); prof_add(2, n_gbox);
    prof_add(3, n_sph); prof_add(4, n_quad);
    *t_best = best_t;""")]
_K11_COUNT = [_SEL_HEAD, (
    """    auto pop = [&]() {
        while (sp > 0) {
            --sp;""",
    """    unsigned n_inner = 0, n_leaf = 0, n_push = 0, n_prim = 0, n_pop = 0;
    auto pop = [&]() {
        while (sp > 0) {
            --sp;
            ++n_pop;"""), (
    """        while (node >= 0) {
            const float4 r0 = __ldg(rows + 4 * node),""",
    """        while (node >= 0) {
            ++n_inner;
            const float4 r0 = __ldg(rows + 4 * node),"""), (
    """                ++sp;
                node = lf ? cl : cr;""",
    """                ++sp;
                ++n_push;
                node = lf ? cl : cr;"""), (
    """        const float4 run = __ldg(rows + 4 * (-node - 1));""",
    """        const float4 run = __ldg(rows + 4 * (-node - 1));
        ++n_leaf;
        n_prim += (unsigned)run.y + (unsigned)run.w;"""), (
    """        node = pop();
    }
    *t_best = best_t;""",
    """        node = pop();
    }
    prof_add(0, 1u); prof_add(1, n_inner); prof_add(2, n_leaf);
    prof_add(3, n_push); prof_add(4, n_prim); prof_add(5, n_pop);
    *t_best = best_t;""")]
# K11 with one step a loop iteration, an inner row or a leaf (the leaf's
# tests run in a warp wherever one lane holds a leaf), in place of this
# source's inner rows down to a leaf, then the leaves
_K11_IFIF = [("""        while (node >= 0) {
            const float4 r0 = __ldg(rows + 4 * node),""",
              """        if (node >= 0) {
            const float4 r0 = __ldg(rows + 4 * node),"""), (
    """            } else {
                node = pop();
            }
        }
        if (node == WALK_DONE) break;""",
    """            } else {
                node = pop();
            }
            continue;
        }
        if (node == WALK_DONE) break;""")]
# K6's group widths VGROUP (spheres) and QGROUP (quads; the packer's too:
# the profile sets wavefront_cuda.VGROUP / QGROUP to the same while it
# packs)
def _vgroup(g):
    return [("#define VGROUP 8 ", f"#define VGROUP {g} ")]


def _qgroup(g):
    return [("#define QGROUP 4 ", f"#define QGROUP {g} ")]
# the group boxes in shared memory beside the chunk boxes, in place of the
# read-only path from the L2 (the forward only)
_GBOX_SHARED = [(
    """        for (int i = threadIdx.x; i < V.n_box; i += blockDim.x)
            smem[i] = vtab[V.off_box + i];""",
    """        for (int i = threadIdx.x; i < V.n_box; i += blockDim.x)
            smem[i] = vtab[V.off_box + i];
        for (int i = threadIdx.x; i < GBOX_COLS * V.n_gbox; i += blockDim.x)
            smem[table_pad(V.n_box) + i] = vtab[V.off_gbox + i];"""), (
    """    const float4* gbox = reinterpret_cast<const float4*>(vtab + V.off_gbox);""",
    """    const float4* gbox = reinterpret_cast<const float4*>(
        box + ((V.n_box + 31) & ~31));"""), (
    """    const float4 lo = __ldg(gbox + 2 * k), hi = __ldg(gbox + 2 * k + 1);""",
    """    const float* f = reinterpret_cast<const float*>(gbox) + GBOX_COLS * k;
    const float4 lo = make_float4(f[0], f[1], f[2], 0.0f),
                 hi = make_float4(f[4], f[5], f[6], 0.0f);"""), (
    """    const size_t smem = (size_t)V.n_box * sizeof(float);
    cudaError_t e = set_smem((const void*)wavefront_forward_vscan_kernel,""",
    """    const size_t smem = (size_t)(table_pad(V.n_box) + GBOX_COLS * V.n_gbox)
        * sizeof(float);
    cudaError_t e = set_smem((const void*)wavefront_forward_vscan_kernel,""")]
# the sphere chunks walked from the last when the ray's x is negative (the
# Morton order's leading axis), near first more often
_NEAR_FIRST = [(
    """    for (int c = 0; c < V.C_small; ++c) {
        if (!box_reaches(box + 6 * c, o, inv, best_t)) continue;""",
    """    for (int cc = 0; cc < V.C_small; ++cc) {
        const int c = d.x < 0.0f ? V.C_small - 1 - cc : cc;
        if (!box_reaches(box + 6 * c, o, inv, best_t)) continue;""")]


# K11 holding the first leaf it meets and walking on to the next before
# testing it (Aila and Laine's speculative traversal, without the warp vote)
_K11_SPECULATIVE = [("""    int node = B.n_nodes - 1;
    for (;;) {
        while (node >= 0) {""", """    int node = B.n_nodes - 1;
    for (;;) {
        int held = WALK_DONE;
        for (;;) {
            if (node < 0) {
                if (node == WALK_DONE || held != WALK_DONE) break;
                held = node;
                node = pop();
                continue;
            }"""), ("""            } else {
                node = pop();
            }
        }
        if (node == WALK_DONE) break;
        const float4 run = __ldg(rows + 4 * (-node - 1));""", """            } else {
                node = pop();
            }
        }
        if (held == WALK_DONE) break;
        const float4 run = __ldg(rows + 4 * (-held - 1));"""), ("""        scan_quads(qrows + (size_t)(int)run.z * QROW_COLS, (int)run.w, o, d,
                   best_t, best);
        node = pop();
    }""", """        scan_quads(qrows + (size_t)(int)run.z * QROW_COLS, (int)run.w, o, d,
                   best_t, best);
    }""")]

SETS["k6new"] = _split_set("k6", 0, _VS_CALL_P, _VS_HEAD, _K6_COUNT,
                           _OCC_K6) + [
    ("k6", "vgroup4", 0, _vgroup(4) + [_OCC_K6], {"VGROUP": 4}),
    ("k6", "qgroup8", 0, _qgroup(8) + [_OCC_K6], {"QGROUP": 8}),
    ("k6", "vgroup16", 0, _vgroup(16) + [_OCC_K6], {"VGROUP": 16}),
    ("k6", "vgroup32", 0, _vgroup(32) + [_OCC_K6], {"VGROUP": 32}),
    ("k6", "gbox_shared", 0, _GBOX_SHARED + [_OCC_K6], {"gbox_shared": 1}),
    ("k6", "near_first", 0, _NEAR_FIRST + [_OCC_K6])]
SETS["k11new"] = _split_set("k11", 6, _ST_CALL_P, _ST_HEAD, _K11_COUNT,
                            _OCC_K11) + [
    ("k11", "if_if", 6, _K11_IFIF + [_OCC_K11]),
    ("k11", "speculative", 6, _K11_SPECULATIVE + [_OCC_K11])]


# ---- the lane walk (K12): the parent's (commit f55c712: the skip links of
# flat.bvh_hit / bvh_miss, left child first, 12-float rows) and this
# source's (octant links, near child first, 8-float rows and an int2 pair
# a step). Counts a selection: node rows fetched, boxes met, sphere tests,
# whether the first leaf the walk enters already holds the final t, and
# whether it holds no hit at all.
K12 = "_Z28wavefront_forward_bvh_kernelILi3EEv8WfParams8BvParams8GradArgs"
_LA_HEAD = "static __device__ int closest_select_lane("
_LA_CALL = """                best = closest_select_lane(B, vtab, o, d, tm, &best_t);"""
_OCC_K12 = ("WF_BVH_ENTRY(rt_wavefront_bvh_lane, SEL_LANE)", """WF_BVH_ENTRY(rt_wavefront_bvh_lane, SEL_LANE)
extern "C" int rt_prof_occupancy(int smem, int* out) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, wavefront_forward_bvh_kernel<SEL_LANE>, WF_THREADS,
        (size_t)smem);
}""")
_LANE_COUNT_DECL = """    unsigned n_fetch = 0, n_met = 0, n_sph = 0;
    bool seen_leaf = false;
    float t_first = BIGF;
    int node = 0;
    while (node < B.n_nodes) {
        ++n_fetch;"""
_LANE_COUNT_END = """
    prof_add(0, 1u); prof_add(1, n_fetch); prof_add(2, n_met);
    prof_add(3, n_sph);
    prof_add(4, (seen_leaf && t_first == best_t) ? 1u : 0u);
    prof_add(5, (seen_leaf && t_first >= BIGF * 0.5f) ? 1u : 0u);
    *t_best = best_t;"""
_K12_COUNT_P = [_SEL_HEAD, ("""    int node = 0;
    while (node < B.n_nodes) {
        float b[6];""", _LANE_COUNT_DECL + """
        float b[6];"""), ("""            scan_spheres(srows + (size_t)(int)n2.x * VROW_COLS, (int)n2.y,
                         false, o, d, a, tm, best_t, best);""",
    """            ++n_met;
            n_sph += (unsigned)(int)n2.y;
            scan_spheres(srows + (size_t)(int)n2.x * VROW_COLS, (int)n2.y,
                         false, o, d, a, tm, best_t, best);
            if ((int)n2.y > 0 && !seen_leaf) {
                seen_leaf = true;
                t_first = best_t;
            }"""), ("""            node = (int)n1.w;
        }
    }
    *t_best = best_t;""", """            node = (int)n1.w;
        }
    }""" + _LANE_COUNT_END)]
_K12_COUNT = [_SEL_HEAD, ("""    int node = 0;
    while (node < B.n_nodes) {
        const float4* row = nodes + LANE_ROW * node;""", _LANE_COUNT_DECL + """
        const float4* row = nodes + LANE_ROW * node;"""), (
    """            scan_spheres(srows + (size_t)(int)n1.z * VROW_COLS, (int)n1.w,
                         false, o, d, a, tm, best_t, best);""",
    """            ++n_met;
            n_sph += (unsigned)(int)n1.w;
            scan_spheres(srows + (size_t)(int)n1.z * VROW_COLS, (int)n1.w,
                         false, o, d, a, tm, best_t, best);
            if ((int)n1.w > 0 && !seen_leaf) {
                seen_leaf = true;
                t_first = best_t;
            }"""), ("""            node = lk.y;
        }
    }
    *t_best = best_t;""", """            node = lk.y;
        }
    }""" + _LANE_COUNT_END)]
# this source's walk with the octant links in a table of their own, [octant]
# [node] int2 pairs after 8-float node rows (the box and the sphere run),
# in place of the links in each node's row; packed by _lane_buffer_table
_K12_LINKS_TABLE = [("""        const float4* row = nodes + LANE_ROW * node;
        const float4 n0 = __ldg(row), n1 = __ldg(row + 1);
        const int2 lk = __ldg(reinterpret_cast<const int2*>(row + 2) + oct);""",
    """        const float4 n0 = __ldg(nodes + 2 * node),
                     n1 = __ldg(nodes + 2 * node + 1);
        const int2 lk = __ldg(ltab_ + node);"""), (
    """    const int oct = ray_octant(d);
    const float* srows = btab + B.off_srows;""",
    """    const int oct = ray_octant(d);
    const int2* ltab_ = reinterpret_cast<const int2*>(
        btab + B.off_nodes + 8 * (size_t)B.n_nodes) + (size_t)oct * B.n_nodes;
    const float* srows = btab + B.off_srows;""")]


def _lane_buffer_table(wc):
    """The packer of _K12_LINKS_TABLE: node rows of the box and the sphere
    run, the octant links' int32 bits [octant][node][hit, miss], then the
    sphere rows."""
    import torch

    def buffer(bt):
        if bt.mode != "lane":
            return _SAVED_BUFFER[0](bt)
        B = bt.box.shape[0]
        rows = wc._bvh_lane_rows(bt)[:, :8]
        links = bt.octant.to(torch.int32).contiguous().view(torch.float32)
        parts = [rows.reshape(-1), links.reshape(-1), bt.srows.reshape(-1)]
        n = parts[0].numel() + parts[1].numel()
        return torch.cat(parts).contiguous(), dict(
            n_nodes=B, n_srows=bt.srows.shape[0], n_qrows=0, off_nodes=0,
            off_srows=n, off_qrows=n + parts[2].numel())
    return buffer


_SAVED_BUFFER = []
# this source's lane walk's forward with persistent threads over lane
# slots (forward_refill<SEL_LANE>, K1's design), its slot counter a
# device symbol zeroed on the launch's stream (the package passes K1's
# its own)
_K12_REFILL = [("""template <int SEL>
__global__ void __launch_bounds__(WF_THREADS)
wavefront_forward_bvh_kernel(WfParams P, BvParams B, GradArgs A) {
    __shared__ float cam[22];
    wavefront_body<0, false, SEL>(P, A.tables, A.pix_lanes, A.carry_in,
                                  nullptr, A.rad_out, A.carry_out, nullptr,
                                  A.iters_out, wf_tables, cam, nullptr,
                                  VsParams(), A.vtab, B);
}""", """__device__ int prof_next;
template <int SEL>
__global__ void __launch_bounds__(WF_THREADS)
wavefront_forward_bvh_kernel(WfParams P, BvParams B, GradArgs A) {
    __shared__ float cam[22];
    if constexpr (SEL == SEL_LANE) {
        forward_refill<SEL_LANE>(P, A.tables, A.pix_lanes, A.carry_in,
                                 A.rad_out, A.carry_out, A.iters_out,
                                 &prof_next, wf_tables, cam, A.vtab, B);
    } else {
        wavefront_body<0, false, SEL>(P, A.tables, A.pix_lanes, A.carry_in,
                                      nullptr, A.rad_out, A.carry_out,
                                      nullptr, A.iters_out, wf_tables, cam,
                                      nullptr, VsParams(), A.vtab, B);
    }
}"""), ("""    if (!A.cot) {
        wavefront_forward_bvh_kernel<SEL>
            <<<P.n_lanes / WF_THREADS, WF_THREADS, 0, stream>>>(P, B, A);
        return (int)cudaGetLastError();
    }""", """    if (!A.cot) {
        int blocks = P.n_lanes / WF_THREADS;
        if (SEL == SEL_LANE) {
            void* nx = nullptr;
            cudaGetSymbolAddress(&nx, prof_next);
            cudaMemsetAsync(nx, 0, sizeof(int), stream);
            blocks = resident_blocks(
                (const void*)wavefront_forward_bvh_kernel<SEL>, 0,
                P.n_lanes);
        }
        wavefront_forward_bvh_kernel<SEL>
            <<<blocks, WF_THREADS, 0, stream>>>(P, B, A);
        return (int)cudaGetLastError();
    }""")]

# this source's walk with the top of the tree in shared memory: the lane
# tables renumbered breadth first (_lane_buffer_bfs), and each block of the
# lane walk's kernels copies the first LANE_SMEM node rows and their 8
# octants' links into shared memory; a step reads a node below LANE_SMEM
# there, the rest through the read-only path
_K12_SMEM_DECL = """
#define LANE_SMEM 384
__shared__ float4 lane_rows_s[LANE_ROW * LANE_SMEM];
__shared__ int lane_ns;
__device__ __forceinline__ void lane_smem_fill(const BvParams& B,
                                               const float* btab) {
    const int ns = B.n_nodes < LANE_SMEM ? B.n_nodes : LANE_SMEM;
    const float4* rows = reinterpret_cast<const float4*>(btab + B.off_nodes);
    for (int i = threadIdx.x; i < LANE_ROW * ns; i += blockDim.x)
        lane_rows_s[i] = rows[i];
    if (threadIdx.x == 0) lane_ns = ns;
}
"""
_K12_SMEM = [(
    "static __device__ int closest_select_lane(",
    _K12_SMEM_DECL + "static __device__ int closest_select_lane("), (
    """    int node = 0;
    while (node < B.n_nodes) {
        const float4* row = nodes + LANE_ROW * node;
        const float4 n0 = __ldg(row), n1 = __ldg(row + 1);
        const int2 lk = __ldg(reinterpret_cast<const int2*>(row + 2) + oct);""",
    """    const int ns = lane_ns;
    int node = 0;
    while (node < B.n_nodes) {
        float4 n0, n1;
        int2 lk;
        if (node < ns) {
            const float4* row = lane_rows_s + LANE_ROW * node;
            n0 = row[0];
            n1 = row[1];
            lk = reinterpret_cast<const int2*>(row + 2)[oct];
        } else {
            const float4* row = nodes + LANE_ROW * node;
            n0 = __ldg(row);
            n1 = __ldg(row + 1);
            lk = __ldg(reinterpret_cast<const int2*>(row + 2) + oct);
        }"""), ("""wavefront_forward_bvh_kernel(WfParams P, BvParams B, GradArgs A) {
    __shared__ float cam[22];""", """wavefront_forward_bvh_kernel(WfParams P, BvParams B, GradArgs A) {
    __shared__ float cam[22];
    if constexpr (SEL == SEL_LANE) lane_smem_fill(B, A.vtab);"""), (
    """    __shared__ float red[(WF_THREADS / 32) * 3 * (NTMAX > 0 ? NTMAX : 1)];
    wavefront_body<NTMAX, false, SEL, SUFFIX, SPLANES>(
        P, A.tables, A.pix_lanes, A.carry_in, A.cot, A.rad_out, A.carry_out,""",
    """    __shared__ float red[(WF_THREADS / 32) * 3 * (NTMAX > 0 ? NTMAX : 1)];
    if constexpr (SEL == SEL_LANE) lane_smem_fill(B, A.vtab);
    wavefront_body<NTMAX, false, SEL, SUFFIX, SPLANES>(
        P, A.tables, A.pix_lanes, A.carry_in, A.cot, A.rad_out, A.carry_out,""")]


def _lane_buffer_bfs(wc):
    """The packer of _K12_SMEM: the lane walk's node rows renumbered
    breadth first (the root 0, then each level in order), so that the
    first LANE_SMEM ids are the top of the tree, their links renumbered
    with them (the children from the tables' links)."""
    import numpy as np
    import torch

    def buffer(bt):
        if bt.mode != "lane":
            return _SAVED_BUFFER[0](bt)
        link = bt.link.to(torch.int64).cpu().numpy()
        B = link.shape[0]
        inner = link[:, 0] == 0
        order, level = [], np.zeros(1, np.int64)
        while level.size:
            order.append(level)
            level = link[level[inner[level]], 2:4].reshape(-1)
        order = np.concatenate(order)
        new = np.empty(B + 1, np.int64)
        new[order] = np.arange(B)
        new[B] = B
        rows = wc._bvh_lane_rows(bt).cpu()[torch.from_numpy(order)]
        links = rows[:, 8:].contiguous().view(torch.int32).numpy()
        rows[:, 8:] = torch.from_numpy(new[links].astype(np.int32)).view(
            torch.float32)
        parts = [rows.to(bt.box.device).reshape(-1), bt.srows.reshape(-1)]
        return torch.cat(parts).contiguous(), dict(
            n_nodes=B, n_srows=bt.srows.shape[0], n_qrows=0, off_nodes=0,
            off_srows=parts[0].numel(),
            off_qrows=parts[0].numel() + parts[1].numel())
    return buffer


SETS["k12"] = _split_set("k12", 7, _LA_CALL, _LA_HEAD, _K12_COUNT_P,
                         _OCC_K12)
SETS["k12new"] = _split_set("k12", 7, _LA_CALL, _LA_HEAD, _K12_COUNT,
                            _OCC_K12) + [
    (kern, name + suffix, part, repl, *py)
    for suffix in ("", "_again")
    for kern, name, part, repl, *py in (
        (("k12", "whole", 7, [_OCC_K12]),) if suffix else ()) + (
        ("k12", "links_table", 7, _K12_LINKS_TABLE + [_OCC_K12],
         {"_bvh_buffer": _lane_buffer_table}),
        ("k12", "smem_top", 7, _K12_SMEM + [_OCC_K12],
         {"_bvh_buffer": _lane_buffer_bfs}),
        ("k12", "bfs_order", 7, [_OCC_K12],
         {"_bvh_buffer": _lane_buffer_bfs}),
        ("k12", "refill", 7, _K12_REFILL + [_OCC_K12]))]

# ---- the unrolled forward (K1, K2): the parent's (commit f55c712: one
# lane a thread, n_lanes / 128 blocks) and this source's (persistent
# threads over lane slots). Counters: the warp iterations of the bounce
# loop and their active lanes (the share of lanes a warp iteration keeps
# busy); per block its start and end (%globaltimer) and its SM (%smid).
_K1_COUNTERS = _SEL_COUNTERS + """
__device__ __forceinline__ void prof_active() {
    const unsigned m = __activemask();
    if ((threadIdx.x & 31) == __ffs(m) - 1) {
        atomicAdd(&prof_counts[0], 1ull);
        atomicAdd(&prof_counts[1], (unsigned long long)__popc(m));
    }
}
#define PROF_BLOCKS 65536
__device__ unsigned long long prof_timeline[3 * PROF_BLOCKS];
extern "C" int rt_prof_timeline(unsigned long long* out, int n) {
    cudaError_t e = n < 1 ? cudaSuccess : cudaMemcpyFromSymbol(
        out, prof_timeline, 3 * (size_t)n * sizeof(unsigned long long));
    void* p = nullptr;
    if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, prof_timeline);
    if (e == cudaSuccess)
        e = cudaMemset(p, 0, sizeof(unsigned long long) * 3 * PROF_BLOCKS);
    return (int)e;
}
__device__ __forceinline__ unsigned long long prof_clock() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
__device__ __forceinline__ void prof_block(unsigned long long t0) {
    __syncthreads();
    if (threadIdx.x == 0 && blockIdx.x < PROF_BLOCKS) {
        unsigned sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        prof_timeline[3 * blockIdx.x] = t0;
        prof_timeline[3 * blockIdx.x + 1] = prof_clock();
        prof_timeline[3 * blockIdx.x + 2] = sm;
    }
}
"""
_K1_HEAD = ("#define SEL_LANE 3      // the lane BVH (K12)",
            "#define SEL_LANE 3      // the lane BVH (K12)\n" + _K1_COUNTERS)
_OCC_K1 = ("#endif  // WF_IN_PART(0)", """
extern "C" int rt_prof_occupancy(int smem, int threads, int* out) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, wavefront_forward_kernel, threads, (size_t)smem);
}
#endif  // WF_IN_PART(0)""")
_K1_BODY_P = """    wavefront_body<0, false>(P, tables, pix_lanes, carry_in, nullptr,
                             rad_out, carry_out, nullptr, iters_out,
                             wf_tables, cam, nullptr);
}"""
_K1_BODY = """    forward_refill<SEL_UNROLLED>(P, tables, pix_lanes, carry_in, rad_out,
                                 carry_out, iters_out, next, wf_tables, cam);
}"""


def _k1_timeline(body: str) -> list:
    return [_K1_HEAD, (body, "    const unsigned long long t0_ = "
                       "prof_clock();\n" + body[:-2]
                       + "\n    prof_block(t0_);\n}")]


_K1_ACTIVE_P = [_K1_HEAD, ("""        } else if (!act) {
            break;
        }
""", """        } else if (!act) {
            break;
        }
        if constexpr (!GRAD && SEL == SEL_UNROLLED) prof_active();
""")]
_K1_ACTIVE = [_K1_HEAD, ("""            continue;
        }
        // a finished path restarts on the pixel's next stratified sample
""", """            continue;
        }
        prof_active();
        // a finished path restarts on the pixel's next stratified sample
""")]
_K1_SELECT2_P = [("""            else
                best = closest_select(sc, o, d, tm, &best_t);""",
                  """            else {
                best = closest_select(sc, o, d, tm, &best_t);
                float t2_;
                if (closest_select(sc, o, d, tm, &t2_) == -7) best = -1;
            }""")]
_K1_SELECT2 = [("""        else
            best = closest_select(sc, o, d, tm, &best_t);
        const bool alive_new = physics<float, 0>(""",
                """        else {
            best = closest_select(sc, o, d, tm, &best_t);
            float t2_;
            if (closest_select(sc, o, d, tm, &t2_) == -7) best = -1;
        }
        const bool alive_new = physics<float, 0>(""")]
_PHYSICS2 = """{
                V3 o2_ = o, d2_ = d, th2_ = th, r2_ = rad;
                float w2_[1], g2_[1];
                const float c2_[3] = {0.0f, 0.0f, 0.0f};
                if (physics<float, 0>(sc, P, cam, best, best_t, o2_, d2_,
                                      th2_, r2_, tm, u, u_med, Seeds<0>{},
                                      w2_, g2_, c2_)
                    && r2_.x == -1.2345e30f)
                    best_t = -best_t;
            }
"""
_K1_PHYSICS2_P = [("""            const bool alive_new = physics<float, NTMAX>(""",
                   "            if constexpr (!GRAD && SEL == SEL_UNROLLED) "
                   + _PHYSICS2
                   + """            const bool alive_new = physics<float, NTMAX>(""")]
_K1_PHYSICS2 = [("""        const bool alive_new = physics<float, 0>(""",
                 "        " + _PHYSICS2
                 + """        const bool alive_new = physics<float, 0>(""")]


def _k1_bounds(n: int) -> list:
    """The refilled forward's __launch_bounds__ asking for n blocks an SM
    (0: none; the source asks for 7)."""
    return [("__global__ void __launch_bounds__(WF_THREADS, 7)\n"
             "wavefront_forward_kernel(",
             "__global__ void __launch_bounds__(WF_THREADS"
             + (f", {n}" if n else "") + ")\nwavefront_forward_kernel(")]


# the refilled forward in blocks of 64 threads (its slots do not depend on
# the block size)
_K1_THREADS64 = [("__global__ void __launch_bounds__(WF_THREADS, 7)\n"
                  "wavefront_forward_kernel(",
                  "__global__ void __launch_bounds__(64)\n"
                  "wavefront_forward_kernel("), (
    """    const int blocks = resident_blocks((const void*)wavefront_forward_kernel,
                                       smem, P.n_lanes);
    if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
    wavefront_forward_kernel<<<blocks, WF_THREADS, smem,""",
    """    int dev_ = 0, sms_ = 0, per_ = 0;
    cudaGetDevice(&dev_);
    cudaDeviceGetAttribute(&sms_, cudaDevAttrMultiProcessorCount, dev_);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_, wavefront_forward_kernel, 64, smem);
    int blocks = per_ * sms_;
    if (blocks > (P.n_lanes + 63) / 64) blocks = (P.n_lanes + 63) / 64;
    if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
    wavefront_forward_kernel<<<blocks, 64, smem,""")]

SETS["k1"] = [
    ("k1", "whole", 0, [_OCC_K1]),
    ("k1", "active", 0, _K1_ACTIVE_P + [_OCC_K1]),
    ("k1", "timeline", 0, _k1_timeline(_K1_BODY_P) + [_OCC_K1]),
    ("k1", "select_twice", 0, _K1_SELECT2_P + [_OCC_K1]),
    ("k1", "physics_twice", 0, _K1_PHYSICS2_P + [_OCC_K1])]
SETS["k1new"] = [
    ("k1", "active", 0, _K1_ACTIVE + [_OCC_K1]),
    ("k1", "timeline", 0, _k1_timeline(_K1_BODY) + [_OCC_K1]),
    ("k1", "select_twice", 0, _K1_SELECT2 + [_OCC_K1]),
    ("k1", "physics_twice", 0, _K1_PHYSICS2 + [_OCC_K1])] + [
    ("k1", name + suffix, 0, repl + [_OCC_K1], *py)
    for suffix in ("", "_again")
    for name, repl, *py in (("whole", []), ("bounds_none", _k1_bounds(0)),
                            ("bounds6", _k1_bounds(6)),
                            ("threads64", _K1_THREADS64, {"threads": 64}))]
# the forward's shapes: (name, scene maker)
_K1_SHAPES = (
    ("cornell_600_spp16_d50",
     lambda pt: cs.builtin(pt, "cornell_box", 600, 16, 50)),
    ("cornell_600_spp100_d50",
     lambda pt: cs.builtin(pt, "cornell_box", 600, 100, 50)),
    ("cornell_1920x1080_spp64_d50",
     lambda pt: cs.cornell_1080p(pt, cs.TRAIN_SPP, cs.TRAIN_DEPTH)))


def _timeline_shares(rows, n_sm: int, capacity: int) -> dict:
    """From per-block (start, end, SM) of one launch: its span, and the
    shares of the span during which fewer SMs hold a block than the card
    has, and fewer blocks run than the card keeps resident (capacity, or
    the launch's block count if smaller)."""
    ev = []
    for t0, t1, sm in rows:
        ev.append((t0, 1, sm))
        ev.append((t1, -1, sm))
    ev.sort(key=lambda e: (e[0], e[1]))
    cap = min(capacity, len(rows))
    per_sm = [0] * max(n_sm, 1 + max(int(r[2]) for r in rows))
    busy = running = 0
    idle_sm = under = 0
    last = ev[0][0]
    for t, kind, sm in ev:
        dt = t - last
        if busy < n_sm:
            idle_sm += dt
        if running < cap:
            under += dt
        last = t
        running += kind
        sm = int(sm)
        if kind > 0:
            busy += per_sm[sm] == 0
            per_sm[sm] += 1
        else:
            per_sm[sm] -= 1
            busy -= per_sm[sm] == 0
    span = ev[-1][0] - ev[0][0]
    return {"span_ms": span / 1e6, "blocks": len(rows),
            "share_fewer_sms_busy": idle_sm / max(span, 1),
            "share_under_resident": under / max(span, 1),
            "last_start_ms": (max(r[0] for r in rows) - ev[0][0]) / 1e6}


def _sass_count(lib: str, kernel: str) -> dict:
    """Instructions of `kernel` in a library or cubin (cuobjdump -sass),
    with a histogram of their opcodes."""
    import port_kernel_times as pk
    ins = pk._sass(lib).get(kernel, [])
    ops = {}
    for i in ins:
        op = i.split()[0] if not i.startswith("@") else i.split()[1]
        op = op.split(".")[0]
        ops[op] = ops.get(op, 0) + 1
    return {"instructions": len(ins),
            "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


# the source of commit 55b6ee0 (its float bounce before the dual-number
# body), unpacked beforehand under the git-ignored build/ for a run on a
# copy without git history: git show 55b6ee0:real_time_ray_tracing_engine_
# tpu_torch/csrc/wavefront.cu > build/ab/float_bounce/wavefront.cu
FLOAT_BOUNCE_SOURCE = (Path("build") / "ab" / "float_bounce"
                       / "wavefront.cu")


def _float_bounce_sass(wc, out_dir: Path, source: Path) -> dict:
    """The forward kernel's SASS count in another source (the float bounce
    of commit 55b6ee0, its whole file in one unit), compiled with the
    package's flags."""
    cubin = out_dir / "float_bounce_forward.cubin"
    r = subprocess.run([wc._nvcc()] + [f for f in wc.NVCC_FLAGS
                                      if f not in ("-shared",)]
                       + ["-cubin", "-o", str(cubin), str(source)],
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        return {"error": r.stdout[-2000:] + r.stderr[-2000:]}
    return _sass_count(str(cubin), K1)


def forward_splits(torch, pt, wc, dev, libs, variants, float_src: Path):
    """Each variant of the forward's set at each shape, single pass and
    compacted schedule: its time; or its share of active lanes per warp
    iteration (active) or its launch's block timeline (timeline, single
    pass); with the ptxas figures, blocks an SM and SASS count."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    scenes = {}
    for name, make in _K1_SHAPES:
        flat, cam, kw = cs.pass_args(pt, make(pt), dev)
        scenes[name] = (flat, cam, kw, wc.prepare_kernel(flat, cam))
    base = libs[("k1", "whole")][0]
    rec = {"kernel": "k1", "sass": _sass_count(str(base.path), K1)}
    if float_src.exists():
        rec["sass_float_bounce"] = _float_bounce_sass(wc, base.path.parent,
                                                      float_src)
    print(json.dumps(rec), flush=True)
    for kern, vname, _, _, *py in variants:
        py = py[0] if py else {}
        lib, log = libs[(kern, vname)]
        wc.load_library = lambda lib=lib: lib
        threads = py.get("threads", 128)
        for name, (flat, cam, kw, prep) in scenes.items():
            rec = {"kernel": kern, "variant": vname, "shape": name,
                   "ptxas": cs.ptxas_table(log).get(K1)}
            occ = (ctypes.c_int * 1)()
            ofn = lib.lib.rt_prof_occupancy
            ofn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            cs.check(ofn(4 * prep.fields["n_table"], threads, occ) == 0,
                     "rt_prof_occupancy failed")
            rec["blocks_per_sm"] = occ[0]
            one = functools.partial(wc.render_pass_kernel, flat, cam, 0, 0,
                                    prepared=prep, **kw)
            comp = functools.partial(
                wc.render_pass_compacted, flat, cam, 0, 0,
                pass_fn=functools.partial(wc.render_pass_kernel,
                                          prepared=prep), **kw)
            if vname == "active":
                cfn = lib.lib.rt_prof_counts
                cfn.argtypes = [ctypes.c_void_p, ctypes.c_int]
                for sched, fn in (("single", one), ("compacted", comp)):
                    counts = (ctypes.c_ulonglong * 6)()
                    cs.check(cfn(counts, 1) == 0, "rt_prof_counts failed")
                    fn()
                    torch.cuda.synchronize()
                    cs.check(cfn(counts, 0) == 0, "rt_prof_counts failed")
                    rec[sched] = {
                        "warp_iterations": int(counts[0]),
                        "active_share": counts[1] / max(32 * counts[0], 1)}
            elif vname == "timeline":
                tfn = lib.lib.rt_prof_timeline
                tfn.argtypes = [ctypes.c_void_p, ctypes.c_int]
                cs.check(tfn(None, 0) == 0, "rt_prof_timeline failed")
                one()
                torch.cuda.synchronize()
                n_lanes = wc.lane_count(kw["width"] * kw["height"])
                n_blocks = min(-(-n_lanes // threads), 65536)
                buf = (ctypes.c_ulonglong * (3 * n_blocks))()
                cs.check(tfn(buf, n_blocks) == 0, "rt_prof_timeline failed")
                rows = [(buf[3 * i], buf[3 * i + 1], buf[3 * i + 2])
                        for i in range(n_blocks) if buf[3 * i + 1] > 0]
                rec.update(_timeline_shares(rows, n_sm, occ[0] * n_sm))
            else:
                rec["single_ms"] = cs.cuda_ms(torch, one)
                rec["compacted_ms"] = cs.cuda_ms(torch, comp)
            print(json.dumps(rec), flush=True)


def _callee_ptxas(log: str) -> dict:
    """Stack and spills of the out-of-line slot-group passes (ptxas prints
    no register count for a device function)."""
    lines = log.splitlines()
    out = {}
    for i, ln in enumerate(lines[:-1]):
        if "Function properties for " in ln and "hard_group" in ln:
            name = ln.split("Function properties for ")[-1].strip()
            out[name.split("hard_group")[1][:8]] = lines[i + 1].strip()
    return out


def _compile(wc, source: Path, part: int, obj: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [wc._nvcc()] + wc.NVCC_FLAGS + [f"-DWF_PART={part}", "-c", "-o",
                                        str(obj), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(procs) -> str:
    logs = [p.communicate(timeout=900)[0] for p in procs]
    log = "\n".join(logs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    return log


def _link(wc, objs, out: Path):
    r = subprocess.run([wc._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-shared", "-o", str(out)] + [str(o) for o in objs],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"link failed:\n{r.stdout}\n{r.stderr}")


def build_variants(wc, src: Path, out_dir: Path, variants) -> dict:
    """{(kernel, name): (library, ptxas log of its part)}: the base build
    (every part) and each variant's part, all compiled in parallel."""
    out_dir.mkdir(parents=True, exist_ok=True)
    base = src.read_text()
    jobs, procs, texts = [], [], []
    for p in wc.WF_PARTS:
        obj = out_dir / f"base_{p}.o"
        procs.append(_compile(wc, src, p, obj))
        jobs.append(("base", p, obj))
    for kern, name, part, repl, *_ in variants:
        if not repl:
            continue
        text = base
        for r in repl:
            if callable(r):
                text = r(text)
                continue
            old, new = r
            if old not in text:
                raise RuntimeError(f"{kern}/{name}: the source has no "
                                   f"{old[:70]!r}")
            text = text.replace(old, new)
        same = [j for j, t in enumerate(texts) if t == (text, part)]
        texts.append((text, part))
        if same:
            procs.append(procs[len(wc.WF_PARTS) + same[0]])
            jobs.append(((kern, name), part, jobs[len(wc.WF_PARTS)
                                                  + same[0]][2]))
            continue
        vsrc = out_dir / f"{kern}_{name}.cu"
        vsrc.write_text(text)
        obj = out_dir / f"{kern}_{name}_{part}.o"
        procs.append(_compile(wc, vsrc, part, obj))
        jobs.append(((kern, name), part, obj))
    t0 = time.perf_counter()
    finished = {}
    for p in procs:
        if id(p) not in finished:
            finished[id(p)] = _finish([p])
    logs = [finished[id(p)] for p in procs]
    build_s = time.perf_counter() - t0
    base_objs = {p: obj for (tag, p, obj) in jobs if tag == "base"}
    base_log = "\n".join(lg for (tag, _, _), lg in zip(jobs, logs)
                         if tag == "base")
    libs = {}
    base_lib = out_dir / "librt_base.so"
    _link(wc, list(base_objs.values()), base_lib)
    for (tag, part, obj), log in zip(jobs, logs):
        if tag == "base":
            continue
        objs = [obj if p == part else base_objs[p] for p in wc.WF_PARTS]
        lib = out_dir / f"librt_{tag[0]}_{tag[1]}.so"
        _link(wc, objs, lib)
        libs[tag] = (wc.KernelLibrary(lib, log, 0.0), log)
    for kern, name, part, repl, *_ in variants:
        if not repl:
            libs[(kern, name)] = (wc.KernelLibrary(base_lib, base_log, 0.0),
                                  base_log)
    print(json.dumps({"build_s": build_s, "variants": len(libs)}), flush=True)
    return libs


# the shapes of the selections' sets: (name, scene maker, BVH mode)
_K6_SHAPES = (
    ("bouncing_1200x675_spp16_d50",
     lambda pt: cs.builtin(pt, "bouncing_spheres", 1200, 16, 50), "vscan"),
    ("grid4913_400x225_spp9_d8",
     lambda pt: cs.sized(cs.grid_scene(pt), 400, 9, 8), "vscan"),
    ("city301_400x225_spp9_d6",
     lambda pt: cs.sized(cs.city_scene(pt), 400, 9, 6), "vscan"),
    ("vscan_slots_1200x675_spp16_d50",
     lambda pt: cs.wide(cs.vscan_slots_scene(pt), 1200, 16, 50), "vscan"))
_K11_SHAPES = (
    ("bouncing_b_1200x675_spp16_d50",
     lambda pt: cs.builtin(pt, "bouncing_spheres", 1200, 16, 50), "stack"),
    ("grid4913_b_400x225_spp9_d8",
     lambda pt: cs.sized(cs.grid_scene(pt), 400, 9, 8), "stack"),
    ("grid32768_b_400x225_spp9_d8",
     lambda pt: cs.sized(cs.grid_scene(pt, 32), 400, 9, 8), "stack"))
_K12_SHAPES = tuple((name.replace("_b_", "_lane_"), make, "lane")
                    for name, make, _ in _K11_SHAPES)
SELECTION_SHAPES = {"k6": _K6_SHAPES, "k11": _K11_SHAPES,
                    "k6new": _K6_SHAPES, "k11new": _K11_SHAPES,
                    "k12": _K12_SHAPES, "k12new": _K12_SHAPES}
_COUNT_NAMES = {"k6": ("box_tests", "sphere_tests", "quad_tests"),
                "k11": ("node_fetches", "pushes", "leaf_prim_tests"),
                "k6new": ("box_tests", "group_box_tests", "sphere_tests",
                          "quad_tests"),
                "k11new": ("inner_row_fetches", "leaf_fetches", "pushes",
                           "leaf_prim_tests", "pops"),
                "k12": ("node_rows", "boxes_met", "sphere_tests",
                        "first_leaf_final_t", "first_leaf_no_hit"),
                "k12new": ("node_rows", "boxes_met", "sphere_tests",
                           "first_leaf_final_t", "first_leaf_no_hit")}


def _launch_smem(wc, prep, py: dict) -> int:
    """The dynamic shared memory of the forward launch of `prep`, as the
    entry points size it: the chunk boxes (K6; and its group boxes in the
    gbox_shared variant) or none (K11)."""
    if prep.mode == "vscan":
        n = prep.vfields["n_box"]
        if py.get("gbox_shared"):
            n = -(-n // 32) * 32 + wc.GBOX_COLS * prep.vfields["n_gbox"]
        return 4 * n
    return 0


def selection_splits(torch, pt, wc, dev, libs, variants, shapes, which):
    """Each variant of a selection's set at each shape: its time (or, for
    "counts", its counts per selection, a selection being one bounce), the
    kernel's ptxas figures and its blocks an SM."""
    scenes = {}
    for name, make, mode in shapes:
        with cs.kernel_mode_env(mode):
            flat, cam, kw = cs.pass_args(pt, make(pt), dev,
                                         use_bvh=mode != "vscan")
            scenes[name] = (flat, cam, kw, mode)
    for kern, vname, _, _, *py in variants:
        py = py[0] if py else {}
        lib, log = libs[(kern, vname)]
        wc.load_library = lambda lib=lib: lib
        sym = {"k6": K6, "k11": K11, "k12": K12}[kern]
        for name, (flat, cam, kw, mode) in scenes.items():
            with cs.kernel_mode_env(mode):
                widths = {k: getattr(wc, k) for k in py if hasattr(wc, k)}
                for k in widths:
                    if k == "_bvh_buffer":
                        _SAVED_BUFFER[:] = [widths[k]]
                        setattr(wc, k, py[k](wc))
                    else:
                        setattr(wc, k, py[k])
                try:
                    prep = wc.prepare_kernel(flat, cam)
                finally:
                    for k, v in widths.items():
                        setattr(wc, k, v)
                fn = functools.partial(wc.render_pass_kernel, flat, cam, 0,
                                       0, prepared=prep, **kw)
                rec = {"kernel": kern, "variant": vname, "shape": name,
                       "ptxas": cs.ptxas_table(log).get(sym)}
                occ = (ctypes.c_int * 1)()
                ofn = lib.lib.rt_prof_occupancy
                ofn.argtypes = [ctypes.c_int, ctypes.c_void_p]
                cs.check(ofn(_launch_smem(wc, prep, py), occ) == 0,
                         "rt_prof_occupancy failed")
                rec["blocks_per_sm"] = occ[0]
                if vname == "counts":
                    counts = (ctypes.c_ulonglong * 6)()
                    cfn = lib.lib.rt_prof_counts
                    cfn.argtypes = [ctypes.c_void_p, ctypes.c_int]
                    cs.check(cfn(counts, 1) == 0, "rt_prof_counts failed")
                    fn()
                    torch.cuda.synchronize()
                    cs.check(cfn(counts, 0) == 0, "rt_prof_counts failed")
                    n_sel = max(int(counts[0]), 1)
                    rec["selections"] = int(counts[0])
                    rec.update({k: counts[i + 1] / n_sel for i, k in
                                enumerate(_COUNT_NAMES[which])})
                else:
                    rec["ms"] = cs.cuda_ms(torch, fn)
                print(json.dumps(rec), flush=True)


# ---- the chunk scan's weight planes (K3v): wavefront_grad_vscan_kernel
# <8, false, false> (NT <= 16, part 1) on the 80-sphere scene and <0, false,
# false, true> (NT 17-32, planes in shared memory, part 3) on the 28-row
# scene, at 1200x675 spp16 d50; beside them the chunk-scan forward (K6,
# part 0) on both scenes and the suffix tier (K8, part 2) forced onto the
# 28-row scene (tex_form "suffix") as yardsticks. Each variant adds
# rt_prof_occupancy(smem, out) for its instance in its part.
K3V_SHAPES = (
    ("scan_tex80_1200x675_spp16_d50",
     lambda pt: cs.wide(cs.scan_tex_scene(pt), 1200, 16, 50), "vscan"),
    ("rows28_1200x675_spp16_d50",
     lambda pt: cs.wide(cs.rows_scene(pt), 1200, 16, 50), "vscan"),
    ("rows28_b_stack_1200x675_spp16_d50",
     lambda pt: cs.wide(cs.rows_scene(pt), 1200, 16, 50), "stack"),
    ("rows28_b_lane_1200x675_spp16_d50",
     lambda pt: cs.wide(cs.rows_scene(pt), 1200, 16, 50), "lane"))
_K3V_PART_HEAD = {
    1: "#if WF_IN_PART(1)\n",
    2: "#if WF_IN_PART(2)\n",
    3: "#if WF_IN_PART(3)\n"}


def _occ_vgrad(part: int, inst: str) -> tuple:
    """rt_prof_occupancy for wavefront_grad_vscan_kernel<inst> in `part`."""
    head = _K3V_PART_HEAD[part]
    return (head, head + f"""extern "C" int rt_prof_occupancy(int smem, int* out) {{
    const cudaError_t e = set_smem(
        (const void*)wavefront_grad_vscan_kernel<{inst}>, (size_t)smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, wavefront_grad_vscan_kernel<{inst}>, WF_THREADS, (size_t)smem);
}}
""")


# the shared-memory planes' updates left out (miss, emission, scatter)
_K3V_NO_SW = [("for (int k = 0; k < n_sw; ++k)",
               "for (int k = 0; k < 0; ++k)")]
# per path, the distinct eff rows its scatters write into Wp (a histogram
# of their count at the path's end, prof_hist[0..32]); per lane, the rows
# its radiance events read or add into Gp over all its samples
# (prof_hist[33..65]); the radiance events and the Wp rows each one reads
# (66, 67); the scatters and the Wp rows after each (68, 69)
_K3V_HIST = [
    ("#define SEL_LANE 3      // the lane BVH (K12)",
     """#define SEL_LANE 3      // the lane BVH (K12)
__device__ unsigned long long prof_hist[70];
extern "C" int rt_prof_hist(unsigned long long* out, int reset) {
    cudaError_t e = cudaMemcpyFromSymbol(out, prof_hist,
                                         70 * sizeof(unsigned long long));
    if (reset) {
        unsigned long long z[70] = {0};
        cudaMemcpyToSymbol(prof_hist, z, sizeof(z));
    }
    return (int)e;
}"""),
    ("    int it = 0;\n    for (;;) {\n",
     "    uint32_t prof_pm = 0u, prof_lm = 0u;\n"
     "    int it = 0;\n    for (;;) {\n"),
    ("u_med, Seeds<0>{}, Wp, Gp, gc, (SUFFIX || HARD) ? &ev : nullptr,",
     "u_med, Seeds<0>{}, Wp, Gp, gc, &ev,"),
    ("            alive = alive_new && bounce < P.max_depth;\n",
     """            if constexpr (NTMAX > 0 || SPLANES) {
                if (!ev.hit || ev.emit) {
                    atomicAdd(&prof_hist[66], 1ull);
                    atomicAdd(&prof_hist[67],
                              (unsigned long long)__popc(prof_pm));
                    prof_lm |= prof_pm;
                    if (ev.emit && ev.eff >= 0) prof_lm |= 1u << ev.eff;
                }
                if (alive_new && ev.hit && ev.eff >= 0 && !ev.diel) {
                    prof_pm |= 1u << ev.eff;
                    atomicAdd(&prof_hist[68], 1ull);
                    atomicAdd(&prof_hist[69],
                              (unsigned long long)__popc(prof_pm));
                }
            }
            alive = alive_new && bounce < P.max_depth;
            if constexpr (NTMAX > 0 || SPLANES) {
                if (!alive) {
                    atomicAdd(&prof_hist[__popc(prof_pm)], 1ull);
                    prof_pm = 0u;
                }
            }
"""),
    ("\n    rad_out[0 * N + lane] = rad.x;",
     """
    if constexpr (NTMAX > 0 || SPLANES)
        atomicAdd(&prof_hist[33 + __popc(prof_lm)], 1ull);
    rad_out[0 * N + lane] = rad.x;""")]
_OCC_K3V16 = _occ_vgrad(1, "8, false, false")
_OCC_K3V28 = _occ_vgrad(3, "0, false, false, true")
K3V_SETS = ("k3v", "k3vnew")
SETS["k3v"] = [
    ("k3v16", "whole", 1, [_OCC_K3V16]),
    ("k3v16", "no_plane_updates", 1, _K3_NO_UPDATES + [_OCC_K3V16]),
    ("k3v16", "hist", 1, _K3V_HIST + [_OCC_K3V16]),
    ("k3v28", "whole", 3, [_OCC_K3V28]),
    ("k3v28", "no_plane_updates", 3, _K3V_NO_SW + [_OCC_K3V28]),
    ("k3v28", "hist", 3, _K3V_HIST + [_OCC_K3V28]),
    ("k6", "forward", 0, [_OCC_K6]),
    ("k8", "forced_rows28", 2, [_occ_vgrad(2, "0, false, true")]),
]


# ---- this source's K3v: the row planes, a path's rows in global scratch
# and a bit a row in a register (wavefront_planes_vscan_kernel<false>, part
# 1, held to WP_BLOCKS blocks an SM; its blocks an SM from
# rt_vgrad_planes_blocks) on both scenes, with K4v's slots (<true>, part 3,
# WP_HARD_BLOCKS), and the walks' row planes (wavefront_planes_bvh_kernel,
# parts 6 and 7) on the 28-row scene -b: the source's (7 blocks; 5 with the
# slots); 4, 5, 6 and 8 blocks an SM (2, 3, 4 with the slots; the walks 5,
# 6 and no block count); the planes' updates left out (miss, emission and
# scatter), at the scatter only or at the radiance events only (the path
# then holds no row); the source's build again, measured last; and (its
# build) K3v with 8 to 30 of K4v's slots on the metals scene beside K9
def _wp_blocks(n: int) -> tuple:
    return ("#define WP_BLOCKS 7 ", f"#define WP_BLOCKS {n} ")


def _bvh_unbounded() -> tuple:
    return ("__launch_bounds__(WF_THREADS, WP_BLOCKS)\n"
            "wavefront_planes_bvh_kernel(",
            "__launch_bounds__(WF_THREADS)\nwavefront_planes_bvh_kernel(")


_K3VL_NO_UPDATES = [("            if (wpl) {", "            if (wpl && false) {")]
_K3VL_NO_RADIANCE = [
    ("                wp_miss(*wpl, wcol, gc, sk);", "                (void)sk;"),
    ("                wp_emit(*wpl, wcol, gc, tv, tt, eff);",
     "                (void)tv;")]
_K3VL_NO_SCATTER = [
    ("                wp_scatter(*wpl, wcol, is_diel ? -1 : eff, av, tt, factor);",
     "                (void)av;")]


def _wp_hard_blocks(n: int) -> tuple:
    return ("#define WP_HARD_BLOCKS 5 ", f"#define WP_HARD_BLOCKS {n} ")


SETS["k3vnew"] = [
    ("k3vl", "7_blocks", 1, []),
    ("k3vl", "6_blocks", 1, [_wp_blocks(6)]),
    ("k3vl", "4_blocks", 1, [_wp_blocks(4)]),
    ("k3vl", "5_blocks", 1, [_wp_blocks(5)]),
    ("k3vl", "8_blocks", 1, [_wp_blocks(8)]),
    ("k3vl", "7_blocks_no_plane_updates", 1, _K3VL_NO_UPDATES),
    ("k3vl", "7_blocks_radiance_only", 1, _K3VL_NO_SCATTER),
    ("k3vl", "7_blocks_scatter_only", 1, _K3VL_NO_RADIANCE),
    ("k3vl", "7_blocks_again", 1, [("#define WP_TREE_ROWS 16 ",
                                    "#define WP_TREE_ROWS (16) ")]),
    ("k3vlh", "hard_5_blocks", 3, []),
    ("k3vlh", "hard_3_blocks", 3, [_wp_hard_blocks(3)]),
    ("k3vlh", "hard_4_blocks", 3, [_wp_hard_blocks(4)]),
    ("k3vlh", "hard_2_blocks", 3, [_wp_hard_blocks(2)]),
    ("k11p", "7_blocks", 6, []),
    ("k11p", "6_blocks", 6, [_wp_blocks(6)]),
    ("k11p", "5_blocks", 6, [_wp_blocks(5)]),
    ("k11p", "no_block_count", 6, [_bvh_unbounded()]),
    ("k12p", "7_blocks", 7, []),
    ("k12p", "6_blocks", 7, [_wp_blocks(6)]),
    ("k12p", "5_blocks", 7, [_wp_blocks(5)]),
    ("k12p", "no_block_count", 7, [_bvh_unbounded()]),
    ("k6", "forward", 0, [_OCC_K6]),
]
# the kernels' symbols (patterns) and the shapes each runs at
_K3V_SYMBOLS = {"k3v16": r"_Z27wavefront_grad_vscan_kernelILi8ELb0ELb0E",
                "k3v28": r"_Z27wavefront_grad_vscan_kernelILi0ELb0ELb0ELb1E",
                "k3vl": r"_Z29wavefront_planes_vscan_kernelILb0E",
                "k3vlh": r"_Z29wavefront_planes_vscan_kernelILb1E",
                "k11p": r"_Z27wavefront_planes_bvh_kernelILi2E",
                "k12p": r"_Z27wavefront_planes_bvh_kernelILi3E",
                "k6": r"wavefront_forward_vscan_kernel$",
                "k8": r"_Z27wavefront_grad_vscan_kernelILi0ELb0ELb1E"}
_K3V_RUNS = {"k3v16": (K3V_SHAPES[0][0],), "k3v28": (K3V_SHAPES[1][0],),
             "k3vl": (K3V_SHAPES[0][0], K3V_SHAPES[1][0]),
             "k6": (K3V_SHAPES[0][0], K3V_SHAPES[1][0]),
             "k8": (K3V_SHAPES[1][0],), "k11p": (K3V_SHAPES[2][0],),
             "k12p": (K3V_SHAPES[3][0],),
             "k3vlh": (K3V_SHAPES[0][0], K3V_SHAPES[1][0])}
# K3v with K4v's slots: the metals' fuzz under the sky gradient on the
# 80-sphere scene, fuzz and IOR on the 28-row scene
_K3VLH_SLOTS = {K3V_SHAPES[0][0]: ({"mat_fuzz"}, True),
                K3V_SHAPES[1][0]: ({"mat_fuzz", "mat_ior"}, False)}


def k3v_splits(torch, pt, wc, dev, libs, variants):
    """Each variant of the k3v set at its shapes: single pass and compacted
    schedule times (or, for "hist", the histograms), the kernel's ptxas
    figures and its blocks an SM at the launch's shared memory."""
    scenes, modes = {}, {}
    for name, make, mode in K3V_SHAPES:
        with cs.kernel_mode_env(mode):
            flat, cam, kw = cs.pass_args(pt, make(pt), dev,
                                         use_bvh=mode != "vscan")
            scenes[name] = (flat, cam, kw, wc.prepare_kernel(flat, cam),
                            cs.cotangent(torch, kw, dev, 6))
        modes[name] = mode
    tex_form = wc.tex_form
    # warm the card up (its clocks) before the first measurement
    wc.load_library = lambda lib=libs[variants[0][:2]][0]: lib
    flat, cam, kw, prep, _ = scenes[K3V_SHAPES[1][0]]
    for _ in range(30):
        wc.render_pass_kernel(flat, cam, 0, 0, prepared=prep, **kw)
    torch.cuda.synchronize()
    for kern, vname, _, _, *py in variants:
        lib, log = libs[(kern, vname)]
        wc.load_library = lambda lib=lib: lib
        for name in _K3V_RUNS[kern]:
            flat, cam, kw, prep, g = scenes[name]
            rec = {"kernel": kern, "variant": vname, "shape": name,
                   "textures": flat.tex_type.shape[0],
                   "ptxas": list(cs.ptxas_prefix(
                       log, _K3V_SYMBOLS[kern]).values())}
            if kern == "k8":
                wc.tex_form = lambda *a, **k: "suffix"
            env = cs.kernel_mode_env(modes[name])
            env.__enter__()
            slots = ()
            if kern == "k3vlh":
                fields, sky = _K3VLH_SLOTS[name]
                slots = wc.hard_param_slots(flat, fields)
                kw = dict(kw, sky_gradient=kw["sky_gradient"] or sky)
                prep = wc.prepare_kernel(flat, cam, slots)
                rec["slots"] = len(slots)
            try:
                if kern == "k6":
                    smem = 4 * prep.vfields["n_box"]
                    one = functools.partial(wc.render_pass_kernel, flat, cam,
                                            0, 0, prepared=prep, **kw)
                    comp = functools.partial(
                        wc.render_pass_compacted, flat, cam, 0, 0,
                        pass_fn=functools.partial(wc.render_pass_kernel,
                                                  prepared=prep), **kw)
                else:
                    smem = wc.grad_smem_bytes(flat, len(slots))
                    gpass = functools.partial(wc.render_pass_grad_kernel,
                                              prepared=prep)
                    one = functools.partial(gpass, flat, cam, 0, 0,
                                            cotangent=g, hard_slots=slots,
                                            **kw)
                    comp = functools.partial(
                        wc.render_pass_grad_compacted, flat, cam, 0, 0,
                        pass_fn=gpass, cotangent=g, hard_slots=slots, **kw)
                occ = (ctypes.c_int * 1)()
                if kern in ("k3vl", "k3vlh"):
                    ofn = lib.vgrad_planes_blocks[kern == "k3vlh"]
                elif kern in ("k11p", "k12p"):
                    ofn = None
                else:
                    ofn = lib.lib.rt_prof_occupancy
                    ofn.argtypes = [ctypes.c_int, ctypes.c_void_p]
                if ofn is not None:
                    cs.check(ofn(smem, occ) == 0,
                             "rt_prof_occupancy failed")
                    rec["blocks_per_sm"] = occ[0]
                rec["smem_bytes"] = smem
                if vname == "hist":
                    h = (ctypes.c_ulonglong * 70)()
                    hfn = lib.lib.rt_prof_hist
                    hfn.argtypes = [ctypes.c_void_p, ctypes.c_int]
                    cs.check(hfn(h, 1) == 0, "rt_prof_hist failed")
                    one()
                    torch.cuda.synchronize()
                    cs.check(hfn(h, 0) == 0, "rt_prof_hist failed")
                    rec["path_rows_hist"] = [int(x) for x in h[0:33]]
                    rec["lane_rows_hist"] = [int(x) for x in h[33:66]]
                    rec["radiance_events"] = int(h[66])
                    rec["rows_per_radiance_event"] = h[67] / max(h[66], 1)
                    rec["scatters"] = int(h[68])
                    rec["rows_per_scatter"] = h[69] / max(h[68], 1)
                else:
                    rec["single_ms"] = cs.cuda_ms(torch, one)
                    rec["compacted_ms"] = cs.cuda_ms(torch, comp)
            finally:
                wc.tex_form = tex_form
                env.__exit__(None, None, None)
            print(json.dumps(rec), flush=True)
    # the host's part of a grad launch that a kernel's time also counts:
    # the free-memory check and the scratch's allocation (28 rows)
    flat, cam, kw, prep, g = scenes[K3V_SHAPES[1][0]]
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    n_scr = 8 * flat.tex_type.shape[0] * n_lanes
    print(json.dumps({
        "kernel": "host", "check_free_ms": cs.cuda_ms(
            torch, lambda: wc.check_free(dev, 4 * n_scr, "scratch")),
        "scratch_alloc_ms": cs.cuda_ms(
            torch, lambda: torch.empty(n_scr, device=dev))}), flush=True)
    if ("k3vl", "7_blocks") in libs:
        wc.load_library = lambda lib=libs[("k3vl", "7_blocks")][0]: lib
        metals_slots(torch, pt, wc, dev)


def metals_slots(torch, pt, wc, dev):
    """tex_color with the first 8, 16, 24 and 30 fuzz slots of
    chip_smoke.py's metals scene (31 rows) at 1200x675 spp16 d50 under the
    sky gradient: K3v with K4v's slots (wavefront_planes_vscan_kernel<true>)
    single pass and compacted, beside the adjoint (K9), which serves any
    request on the scene in one sweep."""
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    flat, cam, kw = cs.pass_args(pt, cs.wide(cs.metals_scene(pt), 1200, 16,
                                             50), dev)
    g = cs.cotangent(torch, kw, dev, 6)
    fuzz = wc.hard_param_slots(flat, {"mat_fuzz"})
    shape = "metals31_1200x675_spp16_d50_sky"
    for n in (8, 16, 24, len(fuzz)):
        slots = fuzz[:n]
        prep = wc.prepare_kernel(flat, cam, slots)
        gpass = functools.partial(wc.render_pass_grad_kernel, prepared=prep)
        rec = {"kernel": "k3vlh", "variant": "7_blocks", "shape": shape,
               "textures": flat.tex_type.shape[0], "slots": n,
               "single_ms": cs.cuda_ms(torch, lambda: gpass(
                   flat, cam, 0, 0, cotangent=g, hard_slots=slots, **kw)),
               "compacted_ms": cs.cuda_ms(
                   torch, lambda: wc.render_pass_grad_compacted(
                       flat, cam, 0, 0, pass_fn=gpass, cotangent=g,
                       hard_slots=slots, **kw))}
        print(json.dumps(rec), flush=True)
    aprep = wc.prepare_kernel(flat, cam, chunk_scan=True)
    print(json.dumps({
        "kernel": "k9", "variant": "source", "shape": shape,
        "ms": cs.cuda_ms(torch, lambda: ac.render_pass_adjoint_kernel(
            flat, cam, 0, 0, cotangent=g, prepared=aprep, **kw))}),
        flush=True)


def main(root: str, which: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import real_time_ray_tracing_engine_tpu_torch as pt
    from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    cs.check(torch.cuda.is_available(), "this profile needs a CUDA device")
    cs.check(wc.__file__.startswith(root + os.sep),
             f"profiling {wc.__file__}, not the package under {root}")
    print(cs.gpu_line(), flush=True)
    dev = torch.device("cuda", 0)
    variants = SETS[which]
    libs = build_variants(wc, Path(root) / cs.KERNEL_SOURCE,
                          Path(root) / "build" / "profile" / which, variants)
    if which in SELECTION_SHAPES:
        selection_splits(torch, pt, wc, dev, libs, variants,
                         SELECTION_SHAPES[which], which)
        print(cs.gpu_line(), flush=True)
        return 0
    if which in K3V_SETS:
        k3v_splits(torch, pt, wc, dev, libs, variants)
        print(cs.gpu_line(), flush=True)
        return 0
    if which in ("k1", "k1new"):
        forward_splits(torch, pt, wc, dev, libs, variants,
                       Path(__file__).resolve().parents[1]
                       / FLOAT_BOUNCE_SOURCE)
        print(cs.gpu_line(), flush=True)
        return 0

    flat, cam, kw = cs.pass_args(
        pt, cs.cornell_1080p(pt, cs.TRAIN_SPP, cs.TRAIN_DEPTH), dev)
    g = cs.cotangent(torch, kw, dev, 6)
    slots = wc.hard_param_slots(flat)
    prep = wc.prepare_kernel(flat, cam, slots)
    k4 = functools.partial(wc.render_pass_grad_kernel, flat, cam, 0, 0,
                           cotangent=g, hard_slots=slots, prepared=prep, **kw)
    bflat, bcam, bkw = cs.pass_args(
        pt, cs.builtin(pt, "bouncing_spheres", 1200, 16, 50), dev)
    bkw["sky_gradient"] = True
    bg = cs.cotangent(torch, bkw, dev, 6)
    bprep = wc.prepare_kernel(bflat, bcam, chunk_scan=True)
    k9 = functools.partial(ac.render_pass_adjoint_kernel, bflat, bcam, 0, 0,
                           cotangent=bg, prepared=bprep, **bkw)
    gk3 = cs.cotangent(torch, kw, dev, 6)
    prep3 = wc.prepare_kernel(flat, cam)
    k3 = functools.partial(wc.render_pass_grad_kernel, flat, cam, 0, 0,
                           cotangent=gk3, prepared=prep3, **kw)
    k1 = functools.partial(wc.render_pass_kernel, flat, cam, 0, 0,
                           prepared=prep3, **kw)
    sflat, scam, skw = cs.pass_args(
        pt, cs.builtin(pt, "bouncing_spheres", 1200, 16, 50), dev)
    sg = cs.cotangent(torch, skw, dev, 6)
    k8 = functools.partial(wc.render_pass_grad_kernel, sflat, scam, 0, 0,
                           cotangent=sg, prepared=wc.prepare_kernel(sflat,
                                                                    scam),
                           **skw)
    runs = {"k4": (k4, K4, f"cornell_box 1920x1080 spp64 d50, {len(slots)} "
                           f"hard slots"),
            "k8": (k8, K8, "bouncing_spheres 1200x675 spp16 d50"),
            "k3": (k3, K3, "cornell_box 1920x1080 spp64 d50, tex_color"),
            "k1": (k1, K1, "cornell_box 1920x1080 spp64 d50, forward"),
            "k9": (k9, K9, "bouncing_spheres 1200x675 spp16 d50, sky "
                           "gradient")}
    for kern, name, _, _ in variants:
        lib, log = libs[(kern, name)]
        fn, sym, shape = runs[kern]
        wc.load_library = lambda lib=lib: lib
        rec = {"kernel": kern, "variant": name, "shape": shape,
               "ptxas": cs.ptxas_table(log).get(sym),
               "ptxas_calls": _callee_ptxas(log)}
        if kern in ("k3", "k1") and which == "k3new":
            occ = (ctypes.c_int * 3)()
            ofn = lib.lib.rt_prof_occupancy
            ofn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            n_table = prep3.fields["n_table"]
            cs.check(ofn(4 * n_table, 4 * n_table, occ) == 0,
                     "rt_prof_occupancy failed")
            rec["blocks_per_sm"] = {"k3": occ[0], "forward": occ[1]}
            rec["ptxas"] = _ptxas_prefix(log, K3_NEW)
            if name.startswith("nt6"):
                rec["ptxas_nt6"] = _ptxas_prefix(
                    log, "_Z25wavefront_tex_grad_kernelILi6EE")
            rec["ptxas_forward"] = cs.ptxas_table(log).get(K1)
        elif kern in ("k3", "k1"):
            occ = (ctypes.c_int * 3)()
            ofn = lib.lib.rt_prof_occupancy
            ofn.argtypes = [ctypes.c_int, ctypes.c_void_p]
            nt6 = name == "nt6_instance"
            cs.check(ofn(prep3.fields["n_table"], occ) == 0,
                     "rt_prof_occupancy failed")
            rec["blocks_per_sm"] = {"k3": occ[0], "forward": occ[1]}
            if nt6:
                rec["blocks_per_sm"]["k3_nt6"] = occ[2]
                rec["ptxas_nt6"] = cs.ptxas_table(log).get(K3_NT6)
            rec["ptxas_forward"] = cs.ptxas_table(log).get(K1)
        if name == "skip_count":
            counts = (ctypes.c_ulonglong * 2)()
            cfn = lib.lib.rt_prof_counts
            cfn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            cs.check(cfn(counts, 1) == 0, "rt_prof_counts failed")
            fn()
            torch.cuda.synchronize()
            cs.check(cfn(counts, 0) == 0, "rt_prof_counts failed")
            rec.update(passes=int(counts[0]), skippable=int(counts[1]),
                       share=counts[1] / max(counts[0], 1))
        else:
            rec["ms"] = cs.cuda_ms(torch, fn)
        print(json.dumps(rec), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
