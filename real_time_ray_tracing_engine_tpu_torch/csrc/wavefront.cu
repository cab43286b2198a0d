// Persistent-lane path-tracing megakernel for Hopper (sm_90a): the forward
// pass and the forward-mode gradient passes, one bounce body.
//
// Replaces: real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py
//   _make_kernel, reached through the one pl.pallas_call at line 3604 of
//   _render_pass_pallas, in four variants: the unrolled-prim forward (K1),
//   its capped/resume variant (K2), grad_tex=True with want_tex and
//   NT <= 32, the weight-plane tier (K3: 865-873, 2347-2349, 2565-2603,
//   3192-3204, 3249-3263), and the tangent-bundle tier for the hard
//   parameters (K4: hard_slots, 875-896, 955-978, 1104-1126, 2395,
//   2411-2542, 3197-3201, 3240-3244, 3260-3263), which the compacted grad
//   driver runs capped and resumed (K5, 3807-3888; driver in
//   ops/wavefront_cuda.py); and, for scenes past the unrolled bounds, the
//   chunk-scan selection of the forward (K6 vscan: _pack_vscan_tables
//   495-620, vscan_select 1378-1533, vscan_record 1614-1752, gather_fields
//   1046, tex_eval_dag 1903-1939; K7 vquad: _pack_vquad_tables 626-675,
//   qtest_rows..qchunk_body 1535-1612, the merge 1714-1733), in its own
//   instance (see "Chunk scan" below); and the grad tiers over the chunk
//   scan's selection (K3v weight planes, MAX_GRAD_TEXS 348; K4v tangent
//   bundles, vscan_record's post-gather theta aliasing 1614-1752, gate
//   313-342; K8 the suffix-radiance tier, grad_suffix 914-931, 2350-2375,
//   2545-2559, 2604-2637, 3205-3262); and the adjoint backward over every
//   trainable family (K9, grad_adjoint's per-sample sweep, 2664-2957,
//   3094-3217; K10, its segmented-regeneration sweep, 2958-3092; see
//   "adjoint (K9, K10)" below); and the opt-in BVH walks of a use_bvh scene
//   (K11, the stack BVH: closest_hit_scan's bvh_mode branch, 1200,
//   1272-1360, tables 3392-3400; K12, the lane BVH: _pack_lane_tables
//   703-750, closest_hit_lane 1755-1873; see "BVH walks" below).
//
// Shape: one lane (pixel) a thread at a time, the reference engine's own
//   static_render_kernel shape (CameraKernels.cu:240-278). A thread loops
//   over its pixel's samples and bounces in registers, regenerating a
//   finished path onto the next stratified sample exactly as the Pallas
//   kernel's unrolled `bounce` does (_make_kernel, wavefront_pallas.py:2336,
//   2360-2391), and sums the pixel's radiance in sample order. The
//   unrolled forward (K1, K2: wavefront_forward_kernel, forward_refill)
//   runs persistent threads: a launch holds only the blocks the card keeps
//   resident, and a thread whose lane is done takes the next lane slot
//   from the launch's counter; every other instance runs one lane a
//   thread for the launch (the grad tiers reduce per block). Scene tables
//   (a few KB inside the unrolled gate) are copied into shared memory once
//   a block (the chunk scan's and the walks' instances read them from
//   global memory); the radiance sum is written once a lane.
//
// Capped / resume (K2): with cap > 0 a thread stops after `cap` loop
//   iterations and spills a 14-row carry [work, alive, bounce, sample,
//   time, o xyz, d xyz, th xyz]; with carry_in it resumes from one, and
//   pix_lanes gives the lane -> pixel permutation of the compacted driver
//   (ops/wavefront_cuda.py). A lane advances one bounce per iteration and
//   freezes once its work is done, so its carry after `cap` iterations is
//   the Pallas per-tile loop's, lane for lane.
//
// One bounce is closest_select (which primitive wins, on values) and then
//   physics<T, NTMAX>, the continuous rest of the bounce (hit record,
//   medium preemption, texture, emission, scatter, light sample and pdf,
//   MIS weight, throughput update), templated on its scalar type T and
//   updating the lane's radiance and ray state in place.
//
// Gradient, weight planes (K3): wavefront_body<NTMAX, HARD> with NTMAX > 0
//   carries Wp (3*NTMAX floats a thread, d throughput / d tex_color, reset
//   on regeneration, carry rows 14..14+3NT) and their cotangent sums Gp,
//   both indexed by constants after unrolling, so they stay in registers;
//   physics<float, NTMAX> updates them inside the branches of the radiance
//   events and the scatter (kept there: gathering the events into a record
//   and updating after the bounce made this kernel 12% slower on the
//   H100). NTMAX is 8 (Cornell: NT = 6) or 16 (the gate's MAX_TEXS). For
//   tex_color alone K3 is its own kernel, wavefront_tex_grad_kernel, held
//   to four blocks an SM (see there).
//
// Gradient, tangent bundles (K4): with HARD, each of the K hard slots
//   (metal fuzz, dielectric IOR, sphere center and radius scalars) has a
//   9-plane tangent Dst[k] = d(o, d, th)/d theta_k. The JAX kernel
//   jax.linearize's `physics` once per bounce and pushes every bundle
//   through the linear map; CUDA has no linearize, so here the JVP is
//   forward-mode dual numbers: physics<DualN<W>> evaluates the same code
//   with a value and W tangents per scalar, written once as operator rules
//   (+ - * /, sqrt, pow, sin, abs, min/max with torch's tie rules). Per
//   bounce the float pass runs once (image, discrete decisions, K3), then
//   one dual pass per slot group: up to HARD_W consecutive slots of one
//   sphere row, or of the material table, from (o, d, th) with tangent i
//   the group's slot i's Dst and
//   theta's tangent 1 injected at the table reads its slot names: the
//   sphere row's center or radius column, the material's fuzz or IOR
//   column, and the columns 1-3 / 7 of every light row that copies that
//   sphere (light_src, the JAX kernel's theta_map aliasing). The value is
//   computed once a group and every branch (winning primitive, Schlick
//   reflect or refract, light pick, medium preemption, the pdf > 1e-8
//   guard) decided on it; the values are the float pass's operation for
//   operation, so the image is the forward's bit for bit and the slots see
//   the same paths, and each tangent is computed by the operations the
//   one-slot pass used (--fmad=false), so dG and the planes are that
//   design's bit for bit. dG[k] += <g, d radiance / d theta_k> at each
//   radiance event; Dst[k] takes the pass's new tangents where the path
//   goes on and is reset to 0 on regeneration (a camera ray has no theta
//   dependence). A slot whose planes are zero on a lane and whose cells
//   the bounce does not read gets exactly zero tangents there, so a group
//   runs in a warp only where a lane holds a nonzero plane of one of its
//   slots (a bitmask a lane, set where a pass writes a nonzero tangent) or
//   its bounce reads one of their cells (__ballot_sync); elsewhere its
//   planes and sums stay as they are. Dst and dG live in shared memory laid
//   out [plane][thread] (10*K floats a thread, 46 KB a block at Cornell's
//   K = 9, 160 KB at the bound K = 32): every access is thread-consecutive
//   (no bank conflicts), the size follows K at launch; a group's 9*W planes
//   are read into registers at the start of its pass and written back at
//   its end. The slot table's cells sit in shared memory as keys
//   (slot_key, K ints). The slots' planes ride the carry after the weight
//   planes (rows 14 + 3NT + 9k + c).
//
// Chunk scan (K6, K7): wavefront_forward_vscan_kernel is the forward with
//   closest_select_vscan in place of closest_select, for scenes of up to
//   MAX_PRIMS_SCAN = 16,384 primitives. It replaces the JAX kernel's
//   vscan_select (wavefront_pallas.py:1378) and its quad half, qtest_rows
//   .. qchunk_body (1535-1612). Spheres come in Morton-ordered chunks of
//   VCHUNK = 128 rows [c0, cdelta, radius, original id] (static, then
//   moving, then inactive), each chunk in groups of VGROUP = 8 consecutive
//   rows; a chunk and each of its groups have a box, swept over the
//   motion interval and widened (ops/wavefront_cuda.py BOX_PAD) so that
//   float32 rounding of a grazing root never puts the winner outside it;
//   the 8 largest static spheres sit in a final block that is always
//   tested (a ground sphere's box would cover the scene). Each thread
//   culls each chunk, then each group of a chunk it meets, against its own
//   ray (a slab test between T_MIN and its running best t; 1/d guarded at
//   |d| < 1e-12 as the JAX kernel does), and tests the rows of the groups
//   it meets; a warp runs a group when any of its lanes needs it. Quads
//   past MAX_QUADS_VSCAN = 64 take the same walk over quad chunks and
//   their groups of QGROUP = 4 rows (K7; a quad test costs more than a
//   sphere test); fewer are tested one by one. The winner is the
//   exact float t, ties to the lower original unified id (spheres before
//   quads): the all-primitive closest_select's and the plain torch
//   version's winner, bit for bit, where the JAX kernel packs t and a
//   7-bit Morton-local id into one int32 key (~2^-17 relative fuzz,
//   1456-1461). The winner's original id then indexes the scene's own
//   tables, so physics<T> runs unchanged and texture_value walks nested
//   checkers per thread (tex_eval_dag's gathers and the resolved per-prim
//   rows are TPU workarounds). What bounds it on this card: operations
//   and the latency of the row fetches, nearly all in the selection (95%
//   of K6's time on bouncing_spheres, 98% on the 4,913-sphere grid): with
//   one box a chunk, a chunk whose box spans the scene (bouncing_spheres'
//   first, static and moving spheres over the whole field) cost its 128
//   sphere tests, 293 a bounce for about one winner. The group boxes cut
//   that to 50 sphere tests and 38 group-box tests a bounce; the tables
//   (51 KB for bouncing_spheres, 530 KB for a 4,913-sphere grid, the
//   group boxes 32 B a group) are read through the read-only path from
//   the L2 (__ldg float4), only the chunk boxes (at most 257 x 6 floats)
//   sit in shared memory (the group boxes there measured 3% faster on
//   bouncing_spheres and 7% slower on the grid; sphere groups of 4, 16
//   and 32 rows slower than 8; quad groups of 4 faster than 8). On an
//   NVIDIA H100 80GB HBM3 at 700 W K6 takes 22.2 ms at bouncing_spheres
//   1200x675 spp16 d50 (47.3 with one box a chunk), 12.5 ms on the grid
//   at 400x225 spp9 d8 (28.0), K7 1.6 ms on the 301-quad city at 400x225
//   spp9 d6 (4.0) (PERF.md).
//
// BVH walks (K11, K12): the forward and the tex_color grad tiers with a BVH
//   walk in place of the selection, for a scene compiled with use_bvh
//   (ops/bvh.py, the reference's SAH tree) that opts in (RTX_BVH_STACK=1,
//   RTX_LANE_BVH=1; ops/wavefront_cuda.py::kernel_mode), of any size. They
//   replace the bvh_mode of closest_hit_scan (wavefront_pallas.py:1200,
//   1272-1360; tables 3392-3400) and closest_hit_lane (1755-1873). The TPU
//   kernels shared one stack per 128-lane tile and descended into a node when
//   any lane's ray met its box (K11), or walked per lane through 128-lane
//   gathers that cost O(table / 128) a fetch (K12), because a TPU lane cannot
//   gather on its own. A CUDA thread can: here one thread walks its own ray,
//   the reference engine's shape (BVHNode.cu:9-31, BVHNode.cpp:385-446). K11
//   (closest_select_stack) reads an inner node as one 64-byte row holding both
//   children's widened boxes and links (the usual GPU BVH2 layout, Aila and
//   Laine, HPG 2009), tests both boxes at once, goes on into the nearer met
//   child by entry t and pushes the farther met one with its entry t, dropped
//   at its pop when that t is past the best t; it goes down inner rows until
//   every lane of the warp holds a leaf or is done, then the leaves test their
//   spheres and then their quads (the leaves are segregated spheres first).
//   Its stack (STACK_DEPTH node ids and entry ts, local memory; ops/bvh.py
//   checks the tree's depth against it when it builds and packs) holds at most
//   the tree's depth. K12 (closest_select_lane) walks skip links without a
//   stack (48 B of stack against K11's 560): where the ray meets a node's box
//   it tests the node's spheres (a leaf's; an inner node has none) and takes
//   the hit link, elsewhere the miss link; spheres only. The TPU kernel's
//   links (and this walk's first port) entered the left child first whatever
//   the ray's direction, so a ray often walked the far subtree first, its best
//   t stayed at 1e30 longer and boxes a near hit would have culled were
//   entered: 24.3, 43.7 and 73.5 node rows a bounce on bouncing_spheres and
//   the 4,913- and 32,768-sphere grids. Here each node carries the links of 8
//   preorders, one a ray octant (the sign bits of d), each entering an inner
//   node's child nearer along its split axis for that sign first
//   (ops/wavefront_cuda.py::octant_links): 21.8, 29.9 and 38.1 rows a bounce.
//   A node row is 24 floats, 6 float4s: the box (widened as the chunk boxes
//   are), the sphere run, then the 8 octants' [hit, miss]; a step issues the
//   box's two loads and its octant's int2 together (the links in a table of
//   their own measured up to 2% slower, the top 384 nodes in shared memory and
//   persistent threads slower still). The rows and the leaves' sphere and quad
//   rows, in leaf order, are read from global memory through the read-only
//   path, as K6 reads its rows. Each primitive is tested with closest_select's
//   float operations (sphere_root, quad_hit), the culls are conservative, and
//   take_closer gives ties to the lower original id: the winner and its t are
//   the all-primitive selection's bit for bit, so physics<T> runs unchanged on
//   the winner's original id and the images and bounces equal K6's. What
//   bounds K11 on this card: the walk itself, the selection being 87% of its
//   time; the node walk (fetches and box tests) two thirds of that. Popping
//   and fetching every child before its box was tested cost 21.8 fetches and
//   20.8 pushes a bounce on bouncing_spheres; the two-box rows take 11.4 inner
//   rows, 2.4 leaf rows and 2.3 pushes. A short stack in shared memory (4, 8
//   or 16 entries a lane) measured slower than the local one; with one step a
//   loop iteration the leaf branch ran in a warp wherever one lane held a
//   leaf, and the inner-rows-then-leaves loop took 8% (bouncing) to 24% (the
//   grids) off that (holding the first leaf met and walking on to the next
//   measured slower). On an NVIDIA H100 80GB HBM3 at 700 W K11 takes 12.2 ms
//   at bouncing_spheres -b 1200x675 spp16 d50 (14.3 before), 2.0 and 4.0 ms on
//   the 4,913- and 32,768-sphere grids at 400x225 spp9 d8 (3.1, 6.6)
//   (PERF.md). What bounds K12: its walk's dependent fetches, one row a step
//   (the selection is 82-88% of its time, the walk without its tests 70-80% of
//   that); on an NVIDIA H100 80GB HBM3 at 700.00 W it takes 12.8 ms at
//   bouncing_spheres -b 1200x675 spp16 d50 (13.6 with the fixed order), 2.9
//   and 5.7 ms on the grids (4.3, 13.2) (PERF.md). No ray packets, treelets or
//   node compression: the walk is per thread. The grad instances take
//   tex_color only (the chunk scan's row planes up to 32 rows, the suffix tier
//   past them); hard slots on such a scene take the adjoint, as in the JAX
//   package.
//
// Chunk-scan grad (K3v, K4v): wavefront_planes_vscan_kernel (the weight
//   planes, with and without K4v's slots) and wavefront_grad_vscan_kernel
//   (K4v alone, K8) are the grad kernel's tiers over closest_select_vscan.
//   The winner's original id indexes the scene tables, so physics<T> and
//   the slot table's aliasing (rd_sph by original row, light rows through
//   light_src) are the unrolled kernel's: the JAX kernel's post-gather
//   theta aliasing needs nothing more here. The tables stay in global
//   memory, as K6 reads them; shared memory holds the chunk boxes and the
//   tangent planes. The weight planes (WROWS, one instance for NT <= 32)
//   are kept for the rows the path has scattered on only, a float4 row
//   each in global scratch beside the lane's Gp rows, and a bit a row in
//   a register (WpRows). What bounds K3v on this card is K6's selection, as
//   for the forward; the dense planes it replaces (in registers up to 16
//   rows, in shared memory for 17 to 32: 86 KB a block at 28 rows, two
//   blocks an SM) updated all 3 * NT planes at every event where a path
//   holds a row or two (64% of the 28-row scene's paths none, 24.5% one;
//   PERF.md). Gp reduces per block in the dense tiers' orders, so dG_tex
//   is theirs bit for bit. On an NVIDIA H100 80GB HBM3 at 700.00 W it takes
//   3.55 ms at the 80-sphere scene 1200x675 spp16 d50 (4.84 dense) and
//   14.52 ms at the 28-row scene (36.02), 1.14x the forward on the same
//   scenes (PERF.md).
//
// Suffix-radiance tier (K8), for more than MAX_GRAD_TEXS texture rows,
//   where weight planes (6 floats a row a lane) do not fit: the gradient of
//   a path's radiance T along a hit's attenuation at is (T - P) / at, P the
//   prefix of T up to and including that hit's bounce (what the path
//   radiates after a hit is proportional to at), plus th at an emission.
//   The JAX kernel traces each sample twice from the same counter-RNG
//   draws, phase A for T and phase B for each P. Here each sample is traced
//   once: P after a bounce is the path total Tt so far, bit for bit (both
//   sums start at 0 and add the same increments in the same order), so each
//   scattering hit with an eff row stores a record (its eff row, at, and Tt
//   after the bounce: SFX_REC floats in global memory, [record][field][lane]
//   in the lane's column) and, when the path ends (a miss, a light, an
//   absorption or max_depth) and T is known, each record routes g * (T - P)
//   / at (0 where |at| <= 1e-8: a channel of albedo exactly 0 gets no
//   scatter gradient, the JAX estimator's known limit) and the last hit g *
//   [th at an emission + (T - T) / at], to the eff rows: every route value
//   is the two-phase design's bit for bit. A capped pass leaves a path's
//   pending records in the carry (after T and the record count: 4 +
//   SFX_REC * max_depth rows), so a path spans the compacted driver's
//   passes. The routes are summed in an order the data fixes: the lane loop
//   runs warp-synchronously (a lane with no work left takes empty
//   iterations), and after each iteration the warp routes its lanes'
//   records in rounds: lanes routing to the same row combine by a shuffle
//   sum in lane order (__match_any_sync), the lowest lane adding it to the
//   warp's own 3 * NT row in global memory (the suffix scratch); at the end
//   the block adds its four warp rows in warp order. dG_tex is then the
//   same on every run (the JAX kernel reduces 128-wide one-hot rows in a
//   fixed order), and takes no shared memory whatever NT is.
//
// Reductions: Gp (K3) per block by a shuffle tree in each warp and then the
//   4 warps in order (K3v's row planes the same up to 16 rows, past them
//   each plane's 128 lanes in lane order, as the shared planes did); dG (K4) per block by one thread per slot summing the
//   block's 128 lanes in order; the suffix tier's warp rows as above. One
//   partial row per block (3NT tex entries, then K hard ones); the wrapper
//   sums the rows. There are no float atomics, so every gradient is the
//   same on every run.
//
// RNG: the PCG4D counter hash keyed per (pixel, absolute sample, mixed
//   seed) with the tags camera 0x0CA4, bounce 0x4000000 + b and medium
//   1000000 + b, bit-identical to utils/rng.py, so the kernel and its plain
//   torch version draw the same numbers and compare per pixel.
//
// What bounds it on the card: operations, and the lanes a warp leaves
//   idle. Intersection, shading, the light
//   sample and the RNG are fp32 and integer ALU work on data in registers
//   and shared memory, with branch divergence (lanes of a warp take
//   different material branches and finish their paths at different
//   times); device-memory traffic is negligible: 12 floats read and 3 (or
//   17) written per lane, plus 3 cotangent floats and (3*NT + 9*K) carry
//   floats each way in the grad pass; K8's records, 7 floats a scattering
//   hit, are written and read once. The grad pass adds 3*NTMAX
//   multiply-adds per radiance event and per scatter for K3, and for K4 the
//   dual passes: the tangent work is about a seventh of a dual bounce
//   (chip_smoke.py counts it alone for the bound), the values the rest.
//   One lane a thread for the launch, the forward (K1) kept 62% of a
//   warp's lanes busy a loop iteration at Cornell 600x600 spp16 d50 and
//   78% at 1920x1080 spp64 (lanes whose pixels are done sit out their
//   warp's longest path), the last 12-15% of a 600x600 launch ran on fewer
//   SMs than the card has, and 113 registers held it to 4 blocks an SM.
// What the design does about it: K1 takes its lanes from a counter, so a
//   warp's lanes refill as their pixels finish and every SM stays full until
//   the slots run out (75% of a warp's lanes busy at 600x600 spp16, 95% at
//   1920x1080), in a loop that takes 72 registers and asks for 7 blocks an SM;
//   on an NVIDIA H100 80GB HBM3 at 700.00 W it takes 8.5 ms at Cornell 600x600
//   spp16 d50 (12.7 one lane a thread), 46.7 at spp100 and 89.8 at 1920x1080
//   spp64 (62.9, 126.8) (PERF.md); K3 keeps the forward's four blocks an SM
//   (its registers held to 128, a few spilled); K8 traces each sample once
//   (the JAX kernel's replay only learned prefixes the trace already holds);
//   K4 skips a slot group in a warp where its tangents are exactly zero, and
//   can compute the values once a group (HARD_W; the values were 56% of the
//   one-slot passes on Cornell's 9 slots at 1920x1080 on an NVIDIA H100 80GB
//   HBM3 at 700 W, but wider passes measured slower, PERF.md); K9 and K10 take
//   the bounce's Jacobian by a hand-written reverse (physics_vjp) in place of
//   one dual pass per column.
//
// Arithmetic follows the plain torch integrator (ops/intersect.py,
//   materials.py, lights.py, textures.py) operation for operation, in the
//   same order. Built with --fmad=false and without --use_fast_math: FMA
//   contraction changed last bits against torch's eager ops, and over a
//   depth-50 path those flipped branches (Schlick, quad edges) in 3.4% of
//   Cornell pixels.

#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#define WF_THREADS 128
#define MAX_SLOTS 32    // hard slots a grad launch takes (ops/wavefront_cuda.py)
#define MAX_LIGHTS 32   // light rows a scene may have (ops/wavefront_cuda.py)
#define BIGF 1e30f
#define T_MINF 1e-3f
#define PI_F 3.14159265358979323846f
#define TWO_PI_F 6.28318530717958647692f
#define INV_4PI_F 0.0795774715459476678844f

#define MAT_METAL 1
#define MAT_DIELECTRIC 2
#define MAT_DIFFUSE_LIGHT 3
#define MAT_ISOTROPIC 4

// draw slots within a bounce block (utils/rng.py)
#define D_PICK 0
#define D_LIGHT_SEL 1
#define D_LIGHT_U 2
#define D_LIGHT_V 3
#define D_MAT_U 4
#define D_MAT_V 5
#define D_FUZZ_U 6
#define D_FUZZ_V 7
#define D_REFL 8

// table column layouts (ops/wavefront_cuda.py::_pack_tables)
#define SPH_COLS 8      // center xyz, cdelta xyz, radius, active
#define QUAD_COLS 18    // corner, u, v, normal, d, w, area, active
#define LIGHT_COLS 25   // is_sphere, center, cdelta, radius | quad fields
#define TEX_COLS 14     // color, scale, is_checker, even rgb, odd rgb,
                        // even row, odd row, is_noise
#define SLOT_COLS 3     // table (SEED_*), row, column
#define VCHUNK 128      // rows per chunk of the chunk scan
#define VGROUP 8        // rows per group of a sphere chunk, the chunk
#define VGROUPS (VCHUNK / VGROUP)  // scan's second level
#define QGROUP 4        // rows per group of a quad chunk
#define QGROUPS (VCHUNK / QGROUP)
#define GBOX_COLS 8     // a group box: lo xyz, 0, hi xyz, 0 (two float4s)
#define VROW_COLS 8     // sphere chunk row: c0 xyz, cdelta xyz, radius, id
#define QROW_COLS 20    // quad chunk row: corner, u, v, normal, d, w, id, 0 0 0
#define SEED_SPH 1
#define SEED_MATF 2
#define SFX_REC 7       // a suffix-tier record: eff row, at xyz, P xyz
#define SFX_STATE 4     // the suffix tier's carry rows before its records:
                        // T xyz, the record count

// Mirrored field by field by ops/wavefront_cuda.py::_Params (ctypes).
// row0 is the first image row of a shard (parallel/mesh.py): a lane's pixel
// id is row0 * width + its pixel in the shard, and that absolute id keys
// the pixel's random streams and places its camera rays, so a shard draws
// the image's own samples for its rows. n_pix, the lanes and pix_lanes
// stay the shard's.
struct WfParams {
    int n_lanes, n_pix, width, n_strata, max_depth, n_samples, sample_start,
        row0;
    unsigned int seed_mix, perlin_seed;
    int sky_gradient, has_noise, checker_depth, cap;
    int S, Q, L, M, MS, MQ, NT, K, want_tex, suffix;
    int off_sph, off_quad, off_pmat, off_light, off_mati, off_matf, off_tex,
        off_med, off_lsrc, off_slot, med_cols, n_table;
    float inv_strata;
    float cam[22];  // center, pixel00, pixel_du, pixel_dv, defocus_u,
                    // defocus_v, defocus_on, background
};

// The chunk scan's tables in the vscan buffer (ops/wavefront_cuda.py::
// _vscan_buffer), mirrored field by field by _VsParams (ctypes): sphere
// chunks (C_small, then a block of n_big rows), Cq quad chunks (0: quads
// tested one by one from the scene table), n_box floats of chunk boxes,
// and n_gbox group boxes (VGROUPS a sphere chunk, then QGROUPS a quad
// chunk, GBOX_COLS floats each).
struct VsParams {
    int C_small, n_big, Cq, off_rows, off_qrows, off_box, n_box, off_gbox,
        n_gbox;
};

// the chunk and group boxes a chunk-scan launch reads: one box a chunk,
// VGROUPS group boxes a sphere chunk and QGROUPS a quad chunk, 16-byte
// aligned (ops/wavefront_cuda.py packs them with the same VGROUP, QGROUP)
static inline bool vscan_groups_ok(const VsParams& V) {
    const int C = V.C_small + (V.n_big > 0);
    return V.n_box == 6 * (C + V.Cq)
        && V.n_gbox == C * VGROUPS + V.Cq * QGROUPS && V.off_gbox % 4 == 0
        && V.off_rows % 4 == 0;
}

// A BVH walk's tables in the bvh buffer (ops/wavefront_cuda.py::
// _bvh_buffer), mirrored field by field by _BvParams (ctypes): n_nodes node
// rows, then the leaves' sphere rows (VROW_COLS) and quad rows (QROW_COLS)
// in leaf order. The stack walk's rows (_bvh_stack_rows) are BVH_STACK_COLS
// floats, four float4s: an inner node's [left child's widened box lo xyz,
// hi xyz, right child's, left link, right link, 0, 0] (a link: the child's
// row, or -(row + 1) for a leaf), a leaf's [first sphere row, sphere count,
// first quad row, quad count, 0...]; the last row (n_nodes - 1) enters the
// tree: its left child is the root, its right child empty. The lane walk's
// are 12 floats, three float4s [box lo xyz, hi xyz (widened), hit link,
// miss link, first sphere row, sphere count].
struct BvParams {
    int n_nodes, n_srows, n_qrows, off_nodes, off_srows, off_qrows;
};
#define STACK_DEPTH 64  // ops/bvh.py STACK_DEPTH (the reference's, BVHNode.cpp:398)
#define BVH_STACK_COLS 16

// the selection a bounce takes (ops/wavefront_cuda.py::kernel_mode)
#define SEL_UNROLLED 0  // every primitive, tables in shared memory (K1-K5)
#define SEL_VSCAN 1     // the chunk scan (K6, K7 and their grad tiers)
#define SEL_STACK 2     // the stack BVH (K11)
#define SEL_LANE 3      // the lane BVH (K12)

// ------------------------------------------------------------ dual numbers
// A value and W tangents: K4's slot groups push W hard slots' tangents
// through one value pass. Each tangent follows torch's forward-mode formula
// (derivatives.yaml) on its own, the rule of the one-tangent dual,
// so the kernel and the plain version's torch.func.jvp differentiate alike
// up to rounding; with --fmad=false every tangent is computed by the same
// operations in the same order whatever W is, so a group of W slots gives
// the W one-slot passes' tangents bit for bit.
template <int W> struct DualN { float v; float t[W]; };

// the tangent count of a scalar type (0: float)
template <typename T> struct NTan { static constexpr int W = 0; };
template <int N> struct NTan<DualN<N>> { static constexpr int W = N; };

__device__ __forceinline__ float val(float x) { return x; }
template <int W>
__device__ __forceinline__ float val(const DualN<W>& x) { return x.v; }

template <typename T> struct Lift {
    static __device__ __forceinline__ T f(float v) { return v; }
};
template <int W> struct Lift<DualN<W>> {
    static __device__ __forceinline__ DualN<W> f(float v) {
        DualN<W> r;
        r.v = v;
#pragma unroll
        for (int i = 0; i < W; ++i) r.t[i] = 0.0f;
        return r;
    }
};
template <typename T>
__device__ __forceinline__ T lift(float v) { return Lift<T>::f(v); }

// the value expr_v and tangent i's expr_t of an operation's result
#define DN_OP(expr_v, expr_t)                          \
    DualN<W> res_;                                     \
    res_.v = (expr_v);                                 \
    _Pragma("unroll")                                  \
    for (int i = 0; i < W; ++i) res_.t[i] = (expr_t); \
    return res_;

template <int W>
__device__ __forceinline__ DualN<W> operator-(const DualN<W>& a) {
    DN_OP(-a.v, -a.t[i])
}
template <int W>
__device__ __forceinline__ DualN<W> operator+(const DualN<W>& a,
                                              const DualN<W>& b) {
    DN_OP(a.v + b.v, a.t[i] + b.t[i])
}
template <int W>
__device__ __forceinline__ DualN<W> operator+(const DualN<W>& a, float b) {
    DN_OP(a.v + b, a.t[i])
}
template <int W>
__device__ __forceinline__ DualN<W> operator+(float a, const DualN<W>& b) {
    DN_OP(a + b.v, b.t[i])
}
template <int W>
__device__ __forceinline__ DualN<W> operator-(const DualN<W>& a,
                                              const DualN<W>& b) {
    DN_OP(a.v - b.v, a.t[i] - b.t[i])
}
template <int W>
__device__ __forceinline__ DualN<W> operator-(const DualN<W>& a, float b) {
    DN_OP(a.v - b, a.t[i])
}
template <int W>
__device__ __forceinline__ DualN<W> operator-(float a, const DualN<W>& b) {
    DN_OP(a - b.v, -b.t[i])
}
template <int W>
__device__ __forceinline__ DualN<W> operator*(const DualN<W>& a,
                                              const DualN<W>& b) {
    DN_OP(a.v * b.v, a.t[i] * b.v + a.v * b.t[i])
}
template <int W>
__device__ __forceinline__ DualN<W> operator*(const DualN<W>& a, float b) {
    DN_OP(a.v * b, a.t[i] * b)
}
template <int W>
__device__ __forceinline__ DualN<W> operator*(float a, const DualN<W>& b) {
    DN_OP(a * b.v, a * b.t[i])
}
// d(a/b) = (da - db * q) / b
template <int W>
__device__ __forceinline__ DualN<W> operator/(const DualN<W>& a,
                                              const DualN<W>& b) {
    const float q = a.v / b.v;
    DN_OP(q, (a.t[i] - b.t[i] * q) / b.v)
}
template <int W>
__device__ __forceinline__ DualN<W> operator/(const DualN<W>& a, float b) {
    DN_OP(a.v / b, a.t[i] / b)
}
template <int W>
__device__ __forceinline__ DualN<W> operator/(float a, const DualN<W>& b) {
    const float q = a / b.v;
    DN_OP(q, (-b.t[i] * q) / b.v)
}

__device__ __forceinline__ float ssqrt(float x) { return sqrtf(x); }
template <int W>
__device__ __forceinline__ DualN<W> ssqrt(const DualN<W>& a) {
    const float r = sqrtf(a.v);
    DN_OP(r, a.t[i] / (2.0f * r))
}
// max / min against a constant: the tangent passes where the argument is
// kept, ties included (torch.clamp)
__device__ __forceinline__ float smax(float a, float c) { return fmaxf(a, c); }
template <int W>
__device__ __forceinline__ DualN<W> smax(const DualN<W>& a, float c) {
    const bool keep = a.v >= c;
    DN_OP(fmaxf(a.v, c), keep ? a.t[i] : 0.0f)
}
__device__ __forceinline__ float smin(float a, float c) { return fminf(a, c); }
template <int W>
__device__ __forceinline__ DualN<W> smin(const DualN<W>& a, float c) {
    const bool keep = a.v <= c;
    DN_OP(fminf(a.v, c), keep ? a.t[i] : 0.0f)
}
// min of two: half of each tangent on a tie (torch.minimum)
template <int W>
__device__ __forceinline__ DualN<W> smin(const DualN<W>& a,
                                         const DualN<W>& b) {
    const bool tie = a.v == b.v, lt = a.v < b.v;
    DN_OP(fminf(a.v, b.v),
          tie ? 0.5f * (a.t[i] + b.t[i]) : (lt ? a.t[i] : b.t[i]))
}
// the earlier of two on a tie (a running torch.min over a dimension)
template <typename T>
__device__ __forceinline__ T first_min(T a, T b) {
    return val(b) < val(a) ? b : a;
}
__device__ __forceinline__ float sabs(float x) { return fabsf(x); }
template <int W>
__device__ __forceinline__ DualN<W> sabs(const DualN<W>& a) {
    const bool pos = a.v > 0.0f, neg_ = a.v < 0.0f;
    DN_OP(fabsf(a.v), pos ? a.t[i] : (neg_ ? -a.t[i] : 0.0f))
}
__device__ __forceinline__ float ssin(float x) { return sinf(x); }
template <int W>
__device__ __forceinline__ DualN<W> ssin(const DualN<W>& a) {
    const float c = cosf(a.v);
    DN_OP(sinf(a.v), c * a.t[i])
}
__device__ __forceinline__ float spow5(float x) { return powf(x, 5.0f); }
template <int W>
__device__ __forceinline__ DualN<W> spow5(const DualN<W>& a) {
    const float p4 = powf(a.v, 4.0f);
    DN_OP(powf(a.v, 5.0f), a.t[i] * 5.0f * p4)
}
#undef DN_OP

// ----------------------------------------------------------------- vectors
template <typename T> struct V3T { T x, y, z; };
typedef V3T<float> V3;
// the scalar type of an operation on an A and a B
template <typename A, typename B> struct Pr;
template <> struct Pr<float, float> { typedef float T; };
template <int W> struct Pr<DualN<W>, float> { typedef DualN<W> T; };
template <int W> struct Pr<float, DualN<W>> { typedef DualN<W> T; };
template <int W> struct Pr<DualN<W>, DualN<W>> { typedef DualN<W> T; };

__device__ __forceinline__ V3 v3(float x, float y, float z) {
    V3 r; r.x = x; r.y = y; r.z = z; return r;
}
template <typename T>
__device__ __forceinline__ V3T<T> lift3(V3 a) {
    V3T<T> r; r.x = lift<T>(a.x); r.y = lift<T>(a.y); r.z = lift<T>(a.z);
    return r;
}
template <typename A, typename B>
__device__ __forceinline__ V3T<typename Pr<A, B>::T> add(V3T<A> a, V3T<B> b) {
    V3T<typename Pr<A, B>::T> r;
    r.x = a.x + b.x; r.y = a.y + b.y; r.z = a.z + b.z;
    return r;
}
template <typename A, typename B>
__device__ __forceinline__ V3T<typename Pr<A, B>::T> sub(V3T<A> a, V3T<B> b) {
    V3T<typename Pr<A, B>::T> r;
    r.x = a.x - b.x; r.y = a.y - b.y; r.z = a.z - b.z;
    return r;
}
template <typename A, typename B>
__device__ __forceinline__ V3T<typename Pr<A, B>::T> mul(V3T<A> a, B s) {
    V3T<typename Pr<A, B>::T> r;
    r.x = a.x * s; r.y = a.y * s; r.z = a.z * s;
    return r;
}
template <typename T>
__device__ __forceinline__ V3T<T> neg(V3T<T> a) {
    V3T<T> r; r.x = -a.x; r.y = -a.y; r.z = -a.z; return r;
}
template <typename A, typename B>
__device__ __forceinline__ typename Pr<A, B>::T dot(V3T<A> a, V3T<B> b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <typename A, typename B>
__device__ __forceinline__ V3T<typename Pr<A, B>::T> cross(V3T<A> a,
                                                           V3T<B> b) {
    V3T<typename Pr<A, B>::T> r;
    r.x = a.y * b.z - a.z * b.y;
    r.y = a.z * b.x - a.x * b.z;
    r.z = a.x * b.y - a.y * b.x;
    return r;
}
// a / max(|a|, 1e-8), as utils/vecmath.normalize
template <typename T>
__device__ __forceinline__ V3T<T> normalize(V3T<T> a) {
    T l = smax(ssqrt(dot(a, a)), 1e-8f);
    V3T<T> r; r.x = a.x / l; r.y = a.y / l; r.z = a.z / l;
    return r;
}
__device__ __forceinline__ V3 ld3(const float* t) {
    return v3(t[0], t[1], t[2]);
}
template <typename T>
__device__ __forceinline__ T safe_sqrt(T x) {
    return ssqrt(smax(x, 1e-12f));
}

// ----------------------------------------------------------------- RNG
__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c,
                                      uint32_t& d) {
    a = a * 1664525u + 1013904223u;
    b = b * 1664525u + 1013904223u;
    c = c * 1664525u + 1013904223u;
    d = d * 1664525u + 1013904223u;
    a += b * d; b += c * a; c += a * b; d += b * c;
    a ^= a >> 16; b ^= b >> 16; c ^= c >> 16; d ^= d >> 16;
    a += b * d; b += c * a; c += a * b; d += b * c;
}

__device__ __forceinline__ float to_unit(uint32_t u) {
    return (float)(u >> 8) * (1.0f / 16777216.0f);
}

// n U[0,1) draws for `tag` (rng.uniforms): block blk hashes counter
// tag * 0x193 + blk against the key words (pixel, sample, mixed seed)
__device__ __forceinline__ void draws(uint32_t k0, uint32_t k1, uint32_t k2,
                                      uint32_t tag, float* out, int n) {
    for (int blk = 0; blk * 4 < n; ++blk) {
        uint32_t a = k0, b = k1, c = k2, d = tag * 0x193u + (uint32_t)blk;
        pcg4d(a, b, c, d);
        float r[4] = {to_unit(a), to_unit(b), to_unit(c), to_unit(d)};
        for (int i = 0; i < 4 && blk * 4 + i < n; ++i) out[blk * 4 + i] = r[i];
    }
}

// ------------------------------------------------------ hash Perlin noise
// the lattice (floor) and the corner gradients take no tangent; the
// fractional position does
template <typename T>
__device__ T noise3(T px, T py, T pz, uint32_t seed) {
    float fx = floorf(val(px)), fy = floorf(val(py)), fz = floorf(val(pz));
    int ix = (int)fx, iy = (int)fy, iz = (int)fz;
    T u = px - fx, v = py - fy, w = pz - fz;
    T su = u * u * (3.0f - 2.0f * u);
    T sv = v * v * (3.0f - 2.0f * v);
    T sw = w * w * (3.0f - 2.0f * w);
    T acc = lift<T>(0.0f);
    for (int di = 0; di < 2; ++di) {
        T wu = di ? su : 1.0f - su;
        for (int dj = 0; dj < 2; ++dj) {
            T wv = dj ? sv : 1.0f - sv;
            for (int dk = 0; dk < 2; ++dk) {
                T ww = dk ? sw : 1.0f - sw;
                uint32_t a = (uint32_t)(ix + di), b = (uint32_t)(iy + dj),
                         c = (uint32_t)(iz + dk), d = seed;
                pcg4d(a, b, c, d);
                float gx = 2.0f * to_unit(a) - 1.0f;
                float gy = 2.0f * to_unit(b) - 1.0f;
                float gz = 2.0f * to_unit(c) - 1.0f;
                float inv = rsqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-12f));
                gx *= inv; gy *= inv; gz *= inv;
                T dd = gx * (u - (float)di) + gy * (v - (float)dj)
                    + gz * (w - (float)dk);
                acc = acc + (wu * wv * ww) * dd;
            }
        }
    }
    return acc;
}

template <typename T>
__device__ T turbulence3(T px, T py, T pz, uint32_t seed) {
    T acc = lift<T>(0.0f);
    float weight = 1.0f;
    for (int o = 0; o < 7; ++o) {
        acc = acc + weight * sabs(
            noise3(px, py, pz, seed + (uint32_t)o * 0x9E3779B9u));
        weight *= 0.5f;
        px = px * 2.0f; py = py * 2.0f; pz = pz * 2.0f;
    }
    return acc;
}

// ---------------------------------------------------------------- scene
struct Scene {
    const float* sph;
    const float* quad;
    const float* pmat;
    const float* light;
    const float* mati;
    const float* matf;
    const float* tex;
    const float* med;
    const float* lsrc;   // per light row: its source sphere row, or -1
    const float* slot;   // per hard slot: SEED_* table, row, column
    int S, Q, L, M, MS, MQ, med_cols, checker_depth, has_noise;
    uint32_t perlin_seed;
};

// A table cell a hard slot names, as one int: its table (SEED_*), row and
// column (the slot table's row, ops/wavefront_cuda.py::_slot_table)
__host__ __device__ __forceinline__ int slot_key(int tab, int row, int col) {
    return (row << 5) | (col << 2) | tab;
}
__device__ __forceinline__ int slot_tab(int key) { return key & 3; }
__device__ __forceinline__ int slot_row(int key) { return key >> 5; }

// The hard slots a dual pass differentiates by, one a tangent: tangent i
// is 1 at the table cell key[i] (slot_key; -1: none) and 0 elsewhere. The
// float pass has none.
template <int W> struct Seeds { int key[W > 0 ? W : 1]; };
template <typename T> using SeedsOf = Seeds<NTan<T>::W>;

template <typename T> struct Seeded {
    static __device__ __forceinline__ T f(float v, const Seeds<0>&, int) {
        return v;
    }
};
template <int W> struct Seeded<DualN<W>> {
    static __device__ __forceinline__ DualN<W> f(float v, const Seeds<W>& s,
                                                 int key) {
        DualN<W> r;
        r.v = v;
#pragma unroll
        for (int i = 0; i < W; ++i) r.t[i] = s.key[i] == key ? 1.0f : 0.0f;
        return r;
    }
};
// sphere row `row`, column `col` (center 0-2, radius 6)
template <typename T>
__device__ __forceinline__ T rd_sph(const Scene& sc, int row, int col,
                                    const SeedsOf<T>& s) {
    return Seeded<T>::f(sc.sph[row * SPH_COLS + col], s,
                        slot_key(SEED_SPH, row, col));
}
// material m's fuzz (col 0) or IOR (col 1)
template <typename T>
__device__ __forceinline__ T rd_matf(const Scene& sc, int m, int col,
                                     const SeedsOf<T>& s) {
    return Seeded<T>::f(sc.matf[m * 2 + col], s,
                        slot_key(SEED_MATF, m, col));
}
// light row l's copy of its source sphere's center (cols 1-3, sphere
// columns 0-2) or radius (col 7, sphere column 6)
template <typename T>
__device__ __forceinline__ T rd_light(const Scene& sc, int l, int col,
                                      const SeedsOf<T>& s) {
    const int src = (int)sc.lsrc[l];
    const int scol = col == 7 ? 6 : col - 1;
    return Seeded<T>::f(sc.light[l * LIGHT_COLS + col], s,
                        slot_key(SEED_SPH, src, scol));
}

// (ops/textures.py) descend nested checkers to a solid or noise leaf; *eff
// gets the leaf's row, the tex_color row the color depends on, or -1 for a
// noise leaf (textures.effective_row). Only a marble leaf depends on p.
template <typename T>
__device__ V3T<T> texture_value(const Scene& sc, int row, V3T<T> p,
                                int* eff) {
    for (int lvl = 0; lvl < sc.checker_depth; ++lvl) {
        const float* t = sc.tex + row * TEX_COLS;
        if (t[4] > 0.5f) {
            float inv = 1.0f / fmaxf(t[3], 1e-12f);
            int fx = (int)floorf(inv * val(p.x));
            int fy = (int)floorf(inv * val(p.y));
            int fz = (int)floorf(inv * val(p.z));
            bool even = ((fx + fy + fz) & 1) == 0;
            row = (int)(even ? t[11] : t[12]);
        }
    }
    const float* t = sc.tex + row * TEX_COLS;
    if (sc.has_noise && t[13] > 0.5f) {
        T turb = turbulence3(p.x, p.y, p.z, sc.perlin_seed);
        T g = 0.5f * (1.0f + ssin(t[3] * p.z + 10.0f * turb));
        *eff = -1;
        V3T<T> r; r.x = g; r.y = g; r.z = g;
        return r;
    }
    *eff = row;
    return lift3<T>(ld3(t));
}

// (ops/intersect.py::sphere_ts) the nearest root in (T_MIN, BIG); false
// when there is none. a = dot(d, d).
template <typename T>
__device__ __forceinline__ bool sphere_root(V3T<T> c, T rad, V3T<T> o,
                                            V3T<T> d, T a, T* t) {
    V3T<T> oc = sub(c, o);
    T h = dot(d, oc);
    T cc = dot(oc, oc) - rad * rad;
    T disc = h * h - a * cc;
    if (!(val(disc) > 0.0f)) return false;
    T sq = safe_sqrt(disc);
    T r0 = (h - sq) / a, r1 = (h + sq) / a;
    bool in0 = (val(r0) > T_MINF) && (val(r0) < BIGF);
    bool in1 = (val(r1) > T_MINF) && (val(r1) < BIGF);
    if (!(in0 || in1)) return false;
    *t = in0 ? r0 : r1;
    return true;
}

// (ops/intersect.py::quad_ts) plane hit + inside test; *t is the plane's
// t, valid where this returns true. q points at corner, u, v, normal, d, w
// (16 floats).
template <typename T>
__device__ __forceinline__ bool quad_hit(const float* q, V3T<T> o, V3T<T> d,
                                         float t_min, T* t_out) {
    T denom = d.x * q[9] + d.y * q[10] + d.z * q[11];
    bool par = fabsf(val(denom)) < 1e-8f;
    T odn = o.x * q[9] + o.y * q[10] + o.z * q[11];
    T t = (q[12] - odn) / (par ? lift<T>(1.0f) : denom);
    T plx = o.x + t * d.x - q[0];
    T ply = o.y + t * d.y - q[1];
    T plz = o.z + t * d.z - q[2];
    T alpha = q[13] * (ply * q[8] - plz * q[7])
        + q[14] * (plz * q[6] - plx * q[8])
        + q[15] * (plx * q[7] - ply * q[6]);
    T beta = q[13] * (q[4] * plz - q[5] * ply)
        + q[14] * (q[5] * plx - q[3] * plz)
        + q[15] * (q[3] * ply - q[4] * plx);
    *t_out = t;
    return !par && val(alpha) >= 0.0f && val(alpha) <= 1.0f
        && val(beta) >= 0.0f && val(beta) <= 1.0f && val(t) > t_min
        && val(t) < BIGF;
}

// (ops/intersect.py::closest_hit, the selection) spheres then quads; a
// later prim wins only when strictly closer, so ties go to the lowest
// unified prim id. Returns the winner (-1: miss) and its t in *t_best.
// Selection has no tangent: the dual passes reuse it.
static __device__ int closest_select(const Scene& sc, V3 o, V3 d,
                                     float tm, float* t_best) {
    float best_t = BIGF;
    int best = -1;
    float a = dot(d, d);
    for (int s = 0; s < sc.S; ++s) {
        const float* r = sc.sph + s * SPH_COLS;
        float rad = r[6];
        if (!(r[7] > 0.5f) || !(rad > 0.0f)) continue;
        V3 c = v3(r[0] + tm * r[3], r[1] + tm * r[4], r[2] + tm * r[5]);
        float t;
        if (!sphere_root(c, rad, o, d, a, &t)) continue;
        if (t < best_t) { best_t = t; best = s; }
    }
    for (int q = 0; q < sc.Q; ++q) {
        const float* r = sc.quad + q * QUAD_COLS;
        if (!(r[17] > 0.5f)) continue;
        float t;
        bool ok = quad_hit(r, o, d, T_MINF, &t);
        if (ok && t < best_t) { best_t = t; best = sc.S + q; }
    }
    *t_best = best_t;
    return best_t < BIGF * 0.5f ? best : -1;
}

// 1/d with |d| < 1e-12 taken as +-1e-12 (the JAX kernels' slab-test guard)
__device__ __forceinline__ V3 inverse_dir(V3 d) {
    const float eps = 1e-12f;
    return v3(1.0f / (fabsf(d.x) < eps ? (d.x < 0.0f ? -eps : eps) : d.x),
              1.0f / (fabsf(d.y) < eps ? (d.y < 0.0f ? -eps : eps) : d.y),
              1.0f / (fabsf(d.z) < eps ? (d.z < 0.0f ? -eps : eps) : d.z));
}

// Does the ray meet the box (lx, ly, lz)-(hx, hy, hz) between T_MIN and
// t_far? (the JAX kernel's box_any slab test, per ray; an empty box is
// [BIG, -BIG]) *tn gets the ray's entry t into it (the slabs' near ts and
// T_MIN): the box is met before a later t_far' <= t_far exactly where it
// is met now and *tn <= t_far'
__device__ __forceinline__ bool box_entry(float lx, float ly, float lz,
                                          float hx, float hy, float hz,
                                          V3 o, V3 inv, float t_far,
                                          float* tn) {
    if (lx > hx) return false;
    const float t0x = (lx - o.x) * inv.x, t1x = (hx - o.x) * inv.x;
    const float t0y = (ly - o.y) * inv.y, t1y = (hy - o.y) * inv.y;
    const float t0z = (lz - o.z) * inv.z, t1z = (hz - o.z) * inv.z;
    *tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                fmaxf(fminf(t0z, t1z), T_MINF));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fminf(fmaxf(t0z, t1z), t_far));
    return *tn <= tf;
}

// box_entry for the box b (lo xyz, hi xyz), its entry t unused
__device__ __forceinline__ bool box_reaches(const float* b, V3 o, V3 inv,
                                            float t_far) {
    float tn;
    return box_entry(b[0], b[1], b[2], b[3], b[4], b[5], o, inv, t_far, &tn);
}

// the closer of (t, id) and the running winner, ties to the lower id
__device__ __forceinline__ void take_closer(float t, int id, float& best_t,
                                            int& best) {
    if (t < best_t || (t == best_t && id < best)) {
        best_t = t;
        best = id;
    }
}

// n sphere rows from `rows`; a row of id -1 is inactive or padding, and in
// a Morton chunk every row after it is too (sorted last)
__device__ __forceinline__ void scan_spheres(const float* __restrict__ rows,
                                             int n, bool sorted, V3 o, V3 d,
                                             float a, float tm, float& best_t,
                                             int& best) {
    for (int r = 0; r < n; ++r) {
        const float4* row = reinterpret_cast<const float4*>(
            rows + (size_t)r * VROW_COLS);
        const float4 A = __ldg(row), B = __ldg(row + 1);
        if (B.w < 0.0f) {
            if (sorted) break;
            continue;
        }
        const V3 c = v3(A.x + tm * A.w, A.y + tm * B.x, A.z + tm * B.y);
        float t;
        if (sphere_root(c, B.z, o, d, a, &t))
            take_closer(t, (int)B.w, best_t, best);
    }
}

// n quad rows: a quad chunk's (K7; sorted, a row of id -1 ends it) or a
// BVH leaf's (K11)
__device__ __forceinline__ void scan_quads(const float* __restrict__ rows,
                                           int n, V3 o, V3 d, float& best_t,
                                           int& best) {
    for (int r = 0; r < n; ++r) {
        const float4* row = reinterpret_cast<const float4*>(
            rows + (size_t)r * QROW_COLS);
        const float4 q0 = __ldg(row), q1 = __ldg(row + 1),
                     q2 = __ldg(row + 2), q3 = __ldg(row + 3),
                     q4 = __ldg(row + 4);
        if (q4.x < 0.0f) break;
        const float q[16] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                             q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w};
        float t;
        if (quad_hit(q, o, d, T_MINF, &t))
            take_closer(t, (int)q4.x, best_t, best);
    }
}

// Does the ray meet group box k (two float4s at gbox, read through the
// read-only path) before t_far?
__device__ __forceinline__ bool group_reaches(const float4* __restrict__ gbox,
                                              int k, V3 o, V3 inv,
                                              float t_far) {
    const float4 lo = __ldg(gbox + 2 * k), hi = __ldg(gbox + 2 * k + 1);
    float tn;
    return box_entry(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, o, inv, t_far, &tn);
}

// closest_select over the chunk scan's tables (K6, K7): the big block
// first (it often holds the ground, which tightens every later cull), then
// each sphere chunk whose box the ray meets before its best t and, in it,
// each group of VGROUP rows whose box the ray meets before its best t,
// then the quads (their chunks and groups of QGROUP rows alike, or one by
// one). The winner and its t are closest_select's over all primitives:
// every test is the same float32 arithmetic, the culls are conservative,
// and ties go to the lower unified id whatever the walk's order. The
// sphere rows (C * VCHUNK, VROW_COLS), quad rows (Cq * VCHUNK, QROW_COLS)
// and group boxes (C * VGROUPS + Cq * QGROUPS, GBOX_COLS; sphere chunk j's
// at j * VGROUPS, quad chunk k's at C * VGROUPS + k * QGROUPS) are read
// from global memory at V.off_rows / V.off_qrows / V.off_gbox of vtab, the
// (widened) chunk boxes (C + Cq, 6: lo xyz, hi xyz) from `box` in shared
// memory.
static __device__ int closest_select_vscan(const Scene& sc,
                                           const VsParams& V,
                                           const float* __restrict__ vtab,
                                           const float* box, V3 o, V3 d,
                                           float tm, float* t_best) {
    float best_t = BIGF;
    int best = -1;
    const float a = dot(d, d);
    const V3 inv = inverse_dir(d);
    const float* rows = vtab + V.off_rows;
    const float4* gbox = reinterpret_cast<const float4*>(vtab + V.off_gbox);
    if (V.n_big > 0)
        scan_spheres(rows + (size_t)V.C_small * VCHUNK * VROW_COLS, V.n_big,
                     false, o, d, a, tm, best_t, best);
    for (int c = 0; c < V.C_small; ++c) {
        if (!box_reaches(box + 6 * c, o, inv, best_t)) continue;
        for (int g = 0; g < VGROUPS; ++g) {
            if (group_reaches(gbox, c * VGROUPS + g, o, inv, best_t))
                scan_spheres(rows + (size_t)(c * VCHUNK + g * VGROUP)
                                 * VROW_COLS,
                             VGROUP, true, o, d, a, tm, best_t, best);
        }
    }
    if (V.Cq > 0) {
        const float* qrows = vtab + V.off_qrows;
        const int j0 = V.C_small + (V.n_big > 0);
        for (int k = 0; k < V.Cq; ++k) {
            if (!box_reaches(box + 6 * (j0 + k), o, inv, best_t)) continue;
            for (int g = 0; g < QGROUPS; ++g) {
                if (group_reaches(gbox, j0 * VGROUPS + k * QGROUPS + g, o,
                                  inv, best_t))
                    scan_quads(qrows + (size_t)(k * VCHUNK + g * QGROUP)
                                   * QROW_COLS,
                               QGROUP, o, d, best_t, best);
            }
        }
    } else {
        for (int q = 0; q < sc.Q; ++q) {
            const float* r = sc.quad + q * QUAD_COLS;
            if (!(r[17] > 0.5f)) continue;
            float t;
            if (quad_hit(r, o, d, T_MINF, &t))
                take_closer(t, sc.S + q, best_t, best);
        }
    }
    *t_best = best_t;
    return best_t < BIGF * 0.5f ? best : -1;
}

// closest_select over the stack BVH (K11): one thread walks its ray's
// tree from the entry row. At an inner row it tests both children's
// widened boxes against its ray and its best t at once, goes on into the
// met one with the nearer entry t (the left on a tie) and pushes the
// other, if met, with its entry t; where neither is met it pops entries
// until one's entry t is at most its best t (box_entry: that box is met
// still). It goes down inner rows until it holds a leaf or its stack is
// empty (the warp goes on while any lane does), then tests the leaf's
// spheres, then its quads, and pops. The stack holds at most the tree's
// depth in entries (one a level on the way down), which ops/bvh.py keeps
// under STACK_DEPTH. The winner and its t are closest_select's over all
// primitives (the same tests, conservative culls, ties to the lower
// original id).
#define WALK_DONE (-0x7fffffff - 1)
static __device__ int closest_select_stack(const BvParams& B,
                                           const float* __restrict__ btab,
                                           V3 o, V3 d, float tm,
                                           float* t_best) {
    float best_t = BIGF;
    int best = -1;
    const float a = dot(d, d);
    const V3 inv = inverse_dir(d);
    const float4* rows = reinterpret_cast<const float4*>(btab + B.off_nodes);
    const float* srows = btab + B.off_srows;
    const float* qrows = btab + B.off_qrows;
    int sid[STACK_DEPTH];
    float st[STACK_DEPTH];
    int sp = 0;
    // the next entry whose box the ray meets before its best t, or
    // WALK_DONE
    auto pop = [&]() {
        while (sp > 0) {
            --sp;
            if (st[sp] <= best_t) return sid[sp];
        }
        return WALK_DONE;
    };
    int node = B.n_nodes - 1;
    for (;;) {
        while (node >= 0) {
            const float4 r0 = __ldg(rows + 4 * node),
                         r1 = __ldg(rows + 4 * node + 1),
                         r2 = __ldg(rows + 4 * node + 2),
                         r3 = __ldg(rows + 4 * node + 3);
            float tl, tr;
            const bool hl = box_entry(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, o,
                                      inv, best_t, &tl);
            const bool hr = box_entry(r1.z, r1.w, r2.x, r2.y, r2.z, r2.w, o,
                                      inv, best_t, &tr);
            const int cl = (int)r3.x, cr = (int)r3.y;
            if (hl && hr) {
                const bool lf = tl <= tr;
                sid[sp] = lf ? cr : cl;
                st[sp] = lf ? tr : tl;
                ++sp;
                node = lf ? cl : cr;
            } else if (hl || hr) {
                node = hl ? cl : cr;
            } else {
                node = pop();
            }
        }
        if (node == WALK_DONE) break;
        const float4 run = __ldg(rows + 4 * (-node - 1));
        scan_spheres(srows + (size_t)(int)run.x * VROW_COLS, (int)run.y,
                     false, o, d, a, tm, best_t, best);
        scan_quads(qrows + (size_t)(int)run.z * QROW_COLS, (int)run.w, o, d,
                   best_t, best);
        node = pop();
    }
    *t_best = best_t;
    return best_t < BIGF * 0.5f ? best : -1;
}

// the ray's octant: bit k set where d's sign bit is set along axis k (-0.0
// counts as negative; ops/wavefront_cuda.py::ray_octants)
__device__ __forceinline__ int ray_octant(V3 d) {
    return (int)(__float_as_uint(d.x) >> 31)
        | (int)(__float_as_uint(d.y) >> 31) << 1
        | (int)(__float_as_uint(d.z) >> 31) << 2;
}

// closest_select over the lane BVH (K12, spheres only): one thread follows
// its ray along its octant's skip links (ops/wavefront_cuda.py::
// octant_links: each inner node's child nearer along its split axis for
// the octant's sign there first), the hit link where the ray meets the
// node's widened box before its best t (after the node's spheres: a
// leaf's; an inner node has none), the miss link elsewhere, until the
// links end. A step reads one node row of LANE_ROW float4s: the widened
// box and the sphere run (two float4s), then the 8 octants' [hit, miss]
// pairs (int2s), of which the ray's octant's is read with the box, the
// three loads issued together.
#define LANE_ROW 6
static __device__ int closest_select_lane(const BvParams& B,
                                          const float* __restrict__ btab,
                                          V3 o, V3 d, float tm,
                                          float* t_best) {
    float best_t = BIGF;
    int best = -1;
    const float a = dot(d, d);
    const V3 inv = inverse_dir(d);
    const float4* nodes = reinterpret_cast<const float4*>(btab + B.off_nodes);
    const int oct = ray_octant(d);
    const float* srows = btab + B.off_srows;
    int node = 0;
    while (node < B.n_nodes) {
        const float4* row = nodes + LANE_ROW * node;
        const float4 n0 = __ldg(row), n1 = __ldg(row + 1);
        const int2 lk = __ldg(reinterpret_cast<const int2*>(row + 2) + oct);
        float tn;
        if (box_entry(n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, o, inv, best_t,
                      &tn)) {
            scan_spheres(srows + (size_t)(int)n1.z * VROW_COLS, (int)n1.w,
                         false, o, d, a, tm, best_t, best);
            node = lk.x;
        } else {
            node = lk.y;
        }
    }
    *t_best = best_t;
    return best_t < BIGF * 0.5f ? best : -1;
}

template <typename T>
struct HitT {
    bool hit, front;
    T t;
    V3T<T> p, n;
    int mat;
};

// (ops/intersect.py::shade_prim) the winner's hit record; a dual pass
// recomputes the winner's t from its (seeded) geometry, with the float
// pass's operations
template <typename T>
__device__ HitT<T> hit_record(const Scene& sc, int best, float best_t,
                              V3T<T> o, V3T<T> d, float tm,
                              const SeedsOf<T>& sd) {
    HitT<T> h;
    h.hit = best >= 0;
    h.t = lift<T>(BIGF);
    h.mat = 0;
    h.front = false;
    h.p = lift3<T>(v3(0.0f, 0.0f, 0.0f));
    h.n = lift3<T>(v3(1.0f, 0.0f, 0.0f));
    if (!h.hit) return h;
    h.mat = (int)sc.pmat[best];
    T t = lift<T>(best_t);
    if (best < sc.S) {
        const float* r = sc.sph + best * SPH_COLS;
        V3T<T> c;
        c.x = rd_sph<T>(sc, best, 0, sd) + tm * r[3];
        c.y = rd_sph<T>(sc, best, 1, sd) + tm * r[4];
        c.z = rd_sph<T>(sc, best, 2, sd) + tm * r[5];
        T rad = rd_sph<T>(sc, best, 6, sd);
        if constexpr (!std::is_same<T, float>::value)
            sphere_root(c, rad, o, d, dot(d, d), &t);
        h.p = add(o, mul(d, t));
        T rr = smax(rad, 1e-12f);
        V3T<T> out = sub(h.p, c);
        out.x = out.x / rr; out.y = out.y / rr; out.z = out.z / rr;
        h.front = val(dot(d, out)) < 0.0f;
        h.n = h.front ? out : neg(out);
    } else {
        const float* r = sc.quad + (best - sc.S) * QUAD_COLS;
        if constexpr (!std::is_same<T, float>::value)
            quad_hit(r, o, d, T_MINF, &t);
        h.p = add(o, mul(d, t));
        V3 nn = v3(r[9], r[10], r[11]);
        h.front = val(dot(d, nn)) < 0.0f;
        h.n = lift3<T>(h.front ? nn : neg(nn));
    }
    h.t = t;
    return h;
}

// (ops/intersect.py::medium_scatter) exponential free flight inside each
// medium's boundary; returns the nearest scattering t (BIG if none) and the
// medium row in *row (lowest row on ties)
template <typename T>
__device__ T medium_free_flight(const Scene& sc, V3T<T> o, V3T<T> d,
                                T t_surf, const float* u_med, int* row) {
    T a = dot(d, d);
    T raylen = ssqrt(a);
    T t_best = lift<T>(BIGF);
    *row = 0;
    for (int m = 0; m < sc.M; ++m) {
        const float* r = sc.med + m * sc.med_cols;
        // pass 1: entry = nearest crossing of the boundary union
        T entry = lift<T>(BIGF);
        for (int pass = 0; pass < 2; ++pass) {
            T exit_ = lift<T>(BIGF);
            for (int js = 0; js < sc.MS; ++js) {
                const float* s = r + 2 + 4 * js;
                float rad = s[3];
                V3T<T> oc = sub(ld3(s), o);
                T h = dot(d, oc);
                T cc = dot(oc, oc) - rad * rad;
                T disc = h * h - a * cc;
                bool ok = val(disc) > 0.0f && rad > 0.0f;
                T sq = safe_sqrt(disc);
                T t0 = ok ? (h - sq) / a : lift<T>(BIGF);
                T t1 = ok ? (h + sq) / a : lift<T>(BIGF);
                if (pass == 0) {
                    entry = first_min(entry, first_min(t0, t1));
                } else {
                    if (val(t0) > val(entry) + 1e-4f)
                        exit_ = first_min(exit_, t0);
                    if (val(t1) > val(entry) + 1e-4f)
                        exit_ = first_min(exit_, t1);
                }
            }
            for (int jq = 0; jq < sc.MQ; ++jq) {
                const float* q = r + 2 + 4 * sc.MS + 17 * jq;
                T t = lift<T>(BIGF);
                if (q[16] > 0.5f) {
                    T tq;
                    if (quad_hit(q, o, d, -BIGF, &tq)) t = tq;
                }
                if (pass == 0) entry = first_min(entry, t);
                else if (val(t) > val(entry) + 1e-4f)
                    exit_ = first_min(exit_, t);
            }
            if (pass == 1) {
                bool crossed = val(entry) < BIGF * 0.5f
                    && val(exit_) < BIGF * 0.5f;
                T t1 = smax(entry, T_MINF);
                T t2 = smin(exit_, t_surf);
                bool span_ok = crossed && (val(t1) < val(t2)) && r[1] > 0.5f;
                if (!span_ok) break;
                T dist_inside = (t2 - t1) * raylen;
                float hit_dist = r[0] * logf(fmaxf(u_med[m], 1e-12f));
                if (hit_dist < val(dist_inside)) {
                    T t_med = t1 + hit_dist / raylen;
                    if (val(t_med) < val(t_best)) { t_best = t_med; *row = m; }
                }
            }
        }
    }
    return t_best;
}

// orthonormal basis around w (utils/vecmath.onb_from_w): returns u, v and
// the normalized w
template <typename T>
__device__ __forceinline__ void onb_from_w(V3T<T> w_in, V3T<T>& u, V3T<T>& v,
                                           V3T<T>& w) {
    w = normalize(w_in);
    V3 aa = fabsf(val(w.x)) > 0.9f ? v3(0.0f, 1.0f, 0.0f)
                                   : v3(1.0f, 0.0f, 0.0f);
    v = normalize(cross(w, aa));
    u = cross(w, v);
}

template <typename A, typename B>
__device__ __forceinline__ V3T<typename Pr<A, B>::T> onb_local(
        V3T<A> u, V3T<A> v, V3T<A> w, V3T<B> a) {
    V3T<typename Pr<A, B>::T> r;
    r.x = a.x * u.x + a.y * v.x + a.z * w.x;
    r.y = a.x * u.y + a.y * v.y + a.z * w.y;
    r.z = a.x * u.z + a.y * v.z + a.z * w.z;
    return r;
}

__device__ __forceinline__ V3 unit_vector_from_uv(float u1, float u2) {
    float z = 1.0f - 2.0f * u1;
    float r = sqrtf(fmaxf(1.0f - z * z, 1e-12f));
    float phi = TWO_PI_F * u2;
    return v3(r * cosf(phi), r * sinf(phi), z);
}

// (ops/lights.py::light_sample) unit direction toward a uniformly chosen
// light
template <typename T>
__device__ V3T<T> light_sample(const Scene& sc, V3T<T> o, float tm,
                               float u_sel, float u1, float u2,
                               const SeedsOf<T>& sd) {
    int n = sc.L > 1 ? sc.L : 1;
    int l = (int)(u_sel * (float)n);
    l = l < 0 ? 0 : (l > n - 1 ? n - 1 : l);
    const float* r = sc.light + l * LIGHT_COLS;
    V3T<T> dir;
    if (r[0] > 0.5f) {
        V3T<T> c;
        c.x = rd_light<T>(sc, l, 1, sd) + tm * r[4];
        c.y = rd_light<T>(sc, l, 2, sd) + tm * r[5];
        c.z = rd_light<T>(sc, l, 3, sd) + tm * r[6];
        V3T<T> to_c = sub(c, o);
        T dist2 = smax(dot(to_c, to_c), 1e-12f);
        T rad = rd_light<T>(sc, l, 7, sd);
        T ratio = smin(smax(1.0f - rad * rad / dist2, 0.0f), 1.0f);
        T z = 1.0f + u2 * (safe_sqrt(ratio) - 1.0f);
        float phi = TWO_PI_F * u1;
        T s = safe_sqrt(1.0f - z * z);
        V3T<T> bu, bv, bw;
        onb_from_w(to_c, bu, bv, bw);
        V3T<T> loc;
        loc.x = cosf(phi) * s; loc.y = sinf(phi) * s; loc.z = z;
        dir = onb_local(bu, bv, bw, loc);
    } else {
        V3 pt = v3(r[8] + u1 * r[11] + u2 * r[14],
                   r[9] + u1 * r[12] + u2 * r[15],
                   r[10] + u1 * r[13] + u2 * r[16]);
        dir = sub(pt, o);
    }
    return normalize(dir);
}

// (ops/lights.py::light_pdf_value) uniform-average solid-angle pdf
template <typename T>
__device__ T light_pdf(const Scene& sc, V3T<T> o, V3T<T> d, float tm,
                       const SeedsOf<T>& sd) {
    T total = lift<T>(0.0f);
    for (int l = 0; l < sc.L; ++l) {
        const float* r = sc.light + l * LIGHT_COLS;
        T pdf = lift<T>(0.0f);
        if (r[0] > 0.5f) {
            T rad = rd_light<T>(sc, l, 7, sd);
            V3T<T> c;
            c.x = rd_light<T>(sc, l, 1, sd) + tm * r[4];
            c.y = rd_light<T>(sc, l, 2, sd) + tm * r[5];
            c.z = rd_light<T>(sc, l, 3, sd) + tm * r[6];
            V3T<T> oc = sub(c, o);
            T a = dot(d, d);
            T h = dot(d, oc);
            T dist2 = dot(oc, oc);
            T disc = h * h - a * (dist2 - rad * rad);
            T sq = safe_sqrt(disc);
            T r0 = (h - sq) / a, r1 = (h + sq) / a;
            bool hit = val(disc) > 0.0f && val(rad) > 0.0f
                && ((val(r0) > T_MINF && val(r0) < BIGF)
                    || (val(r1) > T_MINF && val(r1) < BIGF));
            if (hit) {
                T ratio = smin(smax(
                    1.0f - rad * rad / smax(dist2, 1e-12f), 0.0f), 1.0f);
                T solid = TWO_PI_F * (1.0f - safe_sqrt(ratio));
                pdf = 1.0f / smax(solid, 1e-12f);
            }
        } else {
            T t;
            if (quad_hit(r + 8, o, d, T_MINF, &t) && val(t) < BIGF * 0.5f) {
                T cosine = sabs(d.x * r[17] + d.y * r[18] + d.z * r[19]);
                pdf = t * t / smax(cosine * r[24], 1e-12f);
            }
        }
        total = total + pdf;
    }
    return total / (float)(sc.L > 1 ? sc.L : 1);
}

// (models/camera.py::generate_rays) camera ray for absolute sample s_abs;
// returns the normalized direction
static __device__ void gen_ray(const WfParams& P, const float* cam,
                               uint32_t k0, uint32_t k2, float fi, float fj,
                               int s_abs, V3& o, V3& d, float& tm) {
    float u[5];
    draws(k0, (uint32_t)s_abs, k2, 0x0CA4u, u, 5);
    float s_i = (float)(s_abs % P.n_strata);
    float s_j = (float)(s_abs / P.n_strata);
    float off_x = (s_i + u[0]) * P.inv_strata - 0.5f;
    float off_y = (s_j + u[1]) * P.inv_strata - 0.5f;
    float ax = fi + off_x, ay = fj + off_y;
    V3 ps = v3(cam[3] + ax * cam[6] + ay * cam[9],
               cam[4] + ax * cam[7] + ay * cam[10],
               cam[5] + ax * cam[8] + ay * cam[11]);
    float rr = sqrtf(u[2]);
    float phi = TWO_PI_F * u[3];
    float da = rr * cosf(phi), db = rr * sinf(phi);
    float on = cam[18];
    o = v3(cam[0] + (da * cam[12] + db * cam[15]) * on,
           cam[1] + (da * cam[13] + db * cam[16]) * on,
           cam[2] + (da * cam[14] + db * cam[17]) * on);
    d = normalize(sub(ps, o));
    tm = u[4];
}

// A surface or medium hit's event for the suffix-radiance tier (K8,
// wavefront_pallas.py:2604-2637): the tex_color row the hit reads (eff, -1
// for a marble leaf), whether it emits (a light's front face), whether it
// is a dielectric (attenuation 1, no tex dependence) and its attenuation.
struct SfxEv {
    bool hit, emit, diel;
    int eff;
    float at[3];
    // the adjoint (K9) reads these too: the hit's material row (after a
    // medium's override) and the scatter's MIS weight (1 for specular)
    int mat;
    float factor;
};

// The chunk scan's and the BVH walks' tex_color weight planes (K3v; K4v
// rides them), for NT <= MAX_GRAD_TEXS = 32 rows: Wp[3t+c] = d th_c /
// d tex_color[t][c] is nonzero only for the rows the path has scattered on
// (a scatter maps a zero plane to zero, a fresh sample resets them all),
// so the path keeps the planes of those rows only, each a float4 row of
// the lane's plane rows in global scratch, and a bit a row it holds
// (rows). Every value is computed by the dense planes' float operations in
// the same order, so each nonzero plane is the dense one's bit for bit,
// and a row not held is the dense plane's 0. Gp, the lane's cotangent sums
// over the pass, are rows of global scratch too; gm marks the rows this
// lane has written, so they need no zeroing and the block reduction takes
// a lane that never touched a row as the dense sum's exact 0. A form that
// also kept one to four of a path's rows in registers measured 2% to 29%
// slower (PERF.md): a path holds one row or none at most events, and the
// register rows cost the bounce registers.
#define WP_TREE_ROWS 16 // rows up to which Gp reduces as the register
                        // planes' did (wavefront_body; MAX_TEXS)
#define WP_BLOCKS 7     // blocks an SM the row planes' instances ask for
#define WP_HARD_BLOCKS 5 // and the chunk scan's with tangent bundles
struct WpRows {
    uint32_t rows;          // rows the path holds planes of
    uint32_t gm;            // Gp rows this lane has written
};
// The lane's rows in global scratch, NT float4s each, one 16-byte access
// a row: Gp's row t at gs[4t .. 4t + 2], the planes' at ws[4t .. 4t + 2];
// multi (nullable) counts the paths whose planes came to hold a second
// row.
struct WpCols {
    float* gs;
    float* ws;
    int* multi;
};

__device__ __forceinline__ void wp_load(const WpCols& C, int t,
                                        float (&w)[3]) {
    const float4 q = *reinterpret_cast<const float4*>(C.ws + 4 * t);
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
}
__device__ __forceinline__ void wp_store(const WpCols& C, int t,
                                         const float (&w)[3]) {
    *reinterpret_cast<float4*>(C.ws + 4 * t) =
        make_float4(w[0], w[1], w[2], 0.0f);
}

// Gp[3t+c] += x[c]
__device__ __forceinline__ void wp_gadd(WpRows& L, const WpCols& C, int t,
                                        const float (&x)[3]) {
    const float4 prev = ((L.gm >> t) & 1u)
        ? *reinterpret_cast<const float4*>(C.gs + 4 * t)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(C.gs + 4 * t) = make_float4(
        prev.x + x[0], prev.y + x[1], prev.z + x[2], 0.0f);
    L.gm |= 1u << t;
}

// a miss: Gp += g * Wp * sky over the path's rows
__device__ __forceinline__ void wp_miss(WpRows& L, const WpCols& C,
                                        const float (&gc)[3],
                                        const float (&sk)[3]) {
    for (uint32_t m = L.rows; m; m &= m - 1u) {
        const int t = __ffs(m) - 1;
        float w[3], x[3];
        wp_load(C, t, w);
#pragma unroll
        for (int c = 0; c < 3; ++c) x[c] = gc[c] * w[c] * sk[c];
        wp_gadd(L, C, t, x);
    }
}

// an emission: Gp += g * (Wp * emitted + [row == eff] * th) over the
// path's rows and the emitter's own row
__device__ __forceinline__ void wp_emit(WpRows& L, const WpCols& C,
                                        const float (&gc)[3],
                                        const float (&tv)[3],
                                        const float (&tt)[3], int eff) {
    for (uint32_t m = L.rows; m; m &= m - 1u) {
        const int t = __ffs(m) - 1;
        const bool me = t == eff;
        float w[3], x[3];
        wp_load(C, t, w);
#pragma unroll
        for (int c = 0; c < 3; ++c)
            x[c] = gc[c] * (w[c] * tv[c] + (me ? tt[c] : 0.0f));
        wp_gadd(L, C, t, x);
    }
    // the emitter's own row, where the path holds no plane of it
    if (eff >= 0 && !((L.rows >> eff) & 1u)) {
        float x[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) x[c] = gc[c] * (0.0f * tv[c] + tt[c]);
        wp_gadd(L, C, eff, x);
    }
}

// a scatter, th <- th * at * f: Wp <- (Wp * at + [row == t] * th) * f over
// the path's rows, and the hit's eff row taken on if it is new (row -1, a
// dielectric's: at = 1, no row)
__device__ __forceinline__ void wp_scatter(WpRows& L, const WpCols& C,
                                           int row, const float (&av)[3],
                                           const float (&tt)[3], float f) {
    for (uint32_t m = L.rows; m; m &= m - 1u) {
        const int t = __ffs(m) - 1;
        const bool me = t == row;
        float w[3];
        wp_load(C, t, w);
#pragma unroll
        for (int c = 0; c < 3; ++c)
            w[c] = (w[c] * av[c] + (me ? tt[c] : 0.0f)) * f;
        wp_store(C, t, w);
    }
    if (row >= 0 && !((L.rows >> row) & 1u)) {
        float x[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) x[c] = (0.0f * av[c] + tt[c]) * f;
        wp_store(C, row, x);
        if (L.rows != 0u && (L.rows & (L.rows - 1u)) == 0u && C.multi)
            atomicAdd(C.multi, 1);
        L.rows |= 1u << row;
    }
}

// (ops/integrator.py::bounce_step) the bounce after selection, for the
// winner `best` (-1: no surface) at t best_t, in place: rad gets the
// radiance increment, and o, d, th the next ray state where the path goes
// on (a path that ends keeps its last state in the carry). Returns whether
// it goes on. T = float is the forward bounce; T = DualN<W> its
// derivatives along (o, d, th)'s W tangents and the seeded table cells'
// (sd: one a tangent). NTMAX > 0 (float
// only) also updates the tex_color weight planes at the radiance events
// and the scatter (wavefront_pallas.py:2565-2603): Wp[3t+c] = d th_c /
// d tex_color[t][c], Gp its cotangent sums, gc the lane's cotangent. ev
// (float only; nullptr elsewhere) gets a hit's suffix-tier event. wpl
// (float only; nullptr elsewhere) holds the same planes as the rows the
// path has scattered on (WpRows, the chunk scan's and the BVH walks'
// instances), updated at the same events with the register planes'
// operations; wcol are the lane's rows in global scratch (WpCols).
template <typename T, int NTMAX>
__device__ __forceinline__ bool physics(
        const Scene& sc, const WfParams& P, const float* cam, int best,
        float best_t, V3T<T>& o, V3T<T>& d, V3T<T>& th, V3T<T>& rad,
        float tm, const float* u, const float* u_med, const SeedsOf<T>& sd,
        float (&Wp)[NTMAX > 0 ? 3 * NTMAX : 1],
        float (&Gp)[NTMAX > 0 ? 3 * NTMAX : 1], const float (&gc)[3],
        SfxEv* ev = nullptr, WpRows* wpl = nullptr,
        WpCols wcol = WpCols()) {
    constexpr bool FLOAT = std::is_same<T, float>::value;
    HitT<T> h = hit_record(sc, best, best_t, o, d, tm, sd);
    if (sc.M > 0) {
        int mrow;
        T t_med = medium_free_flight(sc, o, d, h.hit ? h.t : lift<T>(BIGF),
                                     u_med, &mrow);
        if (val(t_med) < BIGF * 0.5f) {
            h.hit = true;
            h.t = t_med;
            h.p = add(o, mul(d, t_med));
            h.n = lift3<T>(v3(1.0f, 0.0f, 0.0f));
            h.front = true;
            h.mat = (int)sc.med[mrow * sc.med_cols + sc.med_cols - 1];
        }
    }
    // the pre-scatter throughput, for the weight planes
    const float tt[3] = {val(th.x), val(th.y), val(th.z)};
    bool alive_new = false;
    if (!h.hit) {
        V3T<T> sky = lift3<T>(v3(cam[19], cam[20], cam[21]));
        if (P.sky_gradient) {
            T as = 0.5f * (d.y + 1.0f);
            sky.x = (1.0f - as) + as * 0.5f;
            sky.y = (1.0f - as) + as * 0.7f;
            sky.z = (1.0f - as) + as * 1.0f;
        }
        rad.x = rad.x + th.x * sky.x;
        rad.y = rad.y + th.y * sky.y;
        rad.z = rad.z + th.z * sky.z;
        if constexpr (NTMAX > 0) {
            // miss: the background is tex-independent, so only the
            // throughput's planes carry it
            const float sk[3] = {val(sky.x), val(sky.y), val(sky.z)};
#pragma unroll
            for (int k = 0; k < 3 * NTMAX; ++k)
                Gp[k] = Gp[k] + gc[k % 3] * Wp[k] * sk[k % 3];
        }
        if constexpr (FLOAT) {
            if (wpl) {
                const float sk[3] = {sky.x, sky.y, sky.z};
                wp_miss(*wpl, wcol, gc, sk);
            }
        }
        return false;
    }
    const int mtype = (int)sc.mati[h.mat * 2 + 0];
    const int mtex = (int)sc.mati[h.mat * 2 + 1];
    int eff;
    const V3T<T> tc = texture_value(sc, mtex, h.p, &eff);
    const bool is_light = mtype == MAT_DIFFUSE_LIGHT;
    const bool is_metal = mtype == MAT_METAL;
    const bool is_diel = mtype == MAT_DIELECTRIC;
    const bool is_iso = mtype == MAT_ISOTROPIC;
    if constexpr (std::is_same<T, float>::value) {
        if (ev) {
            ev->hit = true;
            ev->mat = h.mat;
            ev->factor = 1.0f;
            ev->emit = is_light && h.front;
            ev->diel = is_diel;
            ev->eff = eff;
            ev->at[0] = is_diel ? 1.0f : tc.x;
            ev->at[1] = is_diel ? 1.0f : tc.y;
            ev->at[2] = is_diel ? 1.0f : tc.z;
        }
    }
    if (is_light && h.front) {
        rad.x = rad.x + th.x * tc.x;
        rad.y = rad.y + th.y * tc.y;
        rad.z = rad.z + th.z * tc.z;
        if constexpr (NTMAX > 0) {
            // emission: through the throughput's planes, and directly
            // through the emitter's own row
            const float tv[3] = {val(tc.x), val(tc.y), val(tc.z)};
#pragma unroll
            for (int k = 0; k < 3 * NTMAX; ++k)
                Gp[k] = Gp[k] + gc[k % 3] * (
                    Wp[k] * tv[k % 3] + (eff == k / 3 ? tt[k % 3] : 0.0f));
        }
        if constexpr (FLOAT) {
            if (wpl) {
                const float tv[3] = {tc.x, tc.y, tc.z};
                wp_emit(*wpl, wcol, gc, tv, tt, eff);
            }
        }
    }
    if (is_light) return false;

    const V3T<T> n = h.n;
    bool scatters = true;
    const bool skip_pdf = is_metal || is_diel;
    V3T<T> new_dir;
    T factor = lift<T>(1.0f);
    bool pdf_ok = true;
    if (is_metal) {
        T fuzz = rd_matf<T>(sc, h.mat, 0, sd);
        V3T<T> refl = normalize(sub(d, mul(n, 2.0f * dot(d, n))));
        V3 jit = unit_vector_from_uv(u[D_FUZZ_U], u[D_FUZZ_V]);
        new_dir = normalize(add(refl, mul(jit, fuzz)));
        scatters = val(dot(new_dir, n)) > 0.0f;
    } else if (is_diel) {
        T ior = rd_matf<T>(sc, h.mat, 1, sd);
        T ri = h.front ? 1.0f / ior : ior;
        T cos_t = smin(dot(neg(d), n), 1.0f);
        T sin_t = safe_sqrt(1.0f - cos_t * cos_t);
        bool cannot = val(ri * sin_t) > 1.0f;
        T r0 = (1.0f - ri) / (1.0f + ri);
        r0 = r0 * r0;
        T schlick = r0 + (1.0f - r0) * spow5(1.0f - cos_t);
        if (cannot || val(schlick) > u[D_REFL]) {
            new_dir = normalize(sub(d, mul(n, 2.0f * dot(d, n))));
        } else {
            V3T<T> perp = mul(add(d, mul(n, cos_t)), ri);
            T par = -safe_sqrt(sabs(1.0f - dot(perp, perp)));
            new_dir = normalize(add(perp, mul(n, par)));
        }
    } else {
        // MIS: 0.5 * light pdf + 0.5 * material pdf
        V3T<T> mdir;
        if (is_iso) {
            mdir = lift3<T>(unit_vector_from_uv(u[D_MAT_U], u[D_MAT_V]));
        } else {
            V3T<T> bu, bv, bw;
            onb_from_w(n, bu, bv, bw);
            float phm = TWO_PI_F * u[D_MAT_U];
            float sq2 = sqrtf(fmaxf(u[D_MAT_V], 1e-12f));
            float zc = sqrtf(fmaxf(1.0f - u[D_MAT_V], 1e-12f));
            mdir = normalize(onb_local(
                bu, bv, bw, v3(cosf(phm) * sq2, sinf(phm) * sq2, zc)));
        }
        T pdf_val;
        V3T<T> gdir = mdir;
        T cosv = smax(dot(gdir, n), 0.0f) / PI_F;
        if (sc.L > 0) {
            if (u[D_PICK] < 0.5f)
                gdir = light_sample(sc, h.p, tm, u[D_LIGHT_SEL],
                                    u[D_LIGHT_U], u[D_LIGHT_V], sd);
            cosv = smax(dot(gdir, n), 0.0f) / PI_F;
            T mpdf = is_iso ? lift<T>(INV_4PI_F) : cosv;
            pdf_val = 0.5f * light_pdf(sc, h.p, gdir, tm, sd) + 0.5f * mpdf;
        } else {
            pdf_val = is_iso ? lift<T>(INV_4PI_F) : cosv;
        }
        T spdf = is_iso ? lift<T>(INV_4PI_F) : cosv;
        pdf_ok = val(pdf_val) > 1e-8f;
        factor = spdf / (pdf_ok ? pdf_val : lift<T>(1.0f));
        new_dir = gdir;
    }
    alive_new = scatters && (skip_pdf || pdf_ok);
    if (alive_new) {
        V3T<T> at = is_diel ? lift3<T>(v3(1.0f, 1.0f, 1.0f)) : tc;
        if constexpr (NTMAX > 0) {
            // product rule through th <- th * at * factor: at is the eff
            // row's color except for a dielectric (at = 1), and factor
            // never depends on tex_color
            const float av[3] = {val(at.x), val(at.y), val(at.z)};
            const float f = val(factor);
            const int row = is_diel ? -1 : eff;
#pragma unroll
            for (int k = 0; k < 3 * NTMAX; ++k)
                Wp[k] = (Wp[k] * av[k % 3]
                         + (row == k / 3 ? tt[k % 3] : 0.0f)) * f;
        }
        if constexpr (FLOAT) {
            if (wpl) {
                const float av[3] = {at.x, at.y, at.z};
                wp_scatter(*wpl, wcol, is_diel ? -1 : eff, av, tt, factor);
            }
        }
        if constexpr (FLOAT) {
            if (ev) ev->factor = factor;
        }
        th.x = th.x * at.x * factor;
        th.y = th.y * at.y * factor;
        th.z = th.z * at.z * factor;
        o = h.p;
        d = new_dir;
    }
    return alive_new;
}

// the scene tables, copied in at block start, then (HARD) the tangent
// bundles and their cotangent sums (dynamic shared memory)
extern __shared__ float wf_tables[];

// floats of the tables, padded so the tangent planes start 128-B aligned
__host__ __device__ __forceinline__ int table_pad(int n_table) {
    return (n_table + 31) & ~31;
}

// K4's slot groups: HARD_W hard slots a dual pass (DualN<HARD_W>). A group
// is a run of consecutive slots of one sphere row (center xyz, radius) or
// of the material table (fuzz and IOR slots), at most HARD_W long;
// ops/wavefront_cuda.py lists a sphere's 4 slots together and the material
// slots together. The width is measured (scripts/port_profile.py; the
// times in PERF.md, an NVIDIA H100 80GB HBM3 at 700 W): on Cornell's 9
// slots at 1920x1080 spp64 d50 widths 2 and 4 are slower than 1, with or
// without spills (the wider pass's registers cost more than the shared
// values save), so one slot a pass; the groups and the skip stay.
#define HARD_W 1 

// One dual pass over the n <= W slots k0.. of a group: the bounce from (o0,
// d0, th0) with the float pass's selection and draws, so the float pass's
// branches, its tangents the slots' planes (dst, [plane][thread]) and
// theta's unit tangent seeded at each slot's cell. Adds each slot's <g, d
// radiance> to its sum (dgs) and, where the path goes on, writes its new
// planes and sets its bit of nzm where one of them is nonzero (clears it
// where all are). Not inlined: the pass gets the register file to itself
// (the caller's live state, the weight planes among it, is saved around
// the call), so a grad instance fits in 168 registers, three blocks an SM;
// inlined, Cornell's K4 takes 207, two blocks an SM, and measured slower
// (scripts/port_profile.py, PERF.md).
template <int W>
__device__ __noinline__ void hard_group(
        const Scene& sc, const WfParams& P, const float* cam, int best,
        float best_t, V3 o0, V3 d0, V3 th0, float tm, const float* u,
        const float* u_med, const float (&gc)[3], bool alive_new,
        float* dst, float* dgs, const int* skey, int k0, int n,
        uint32_t& nzm) {
    Seeds<W> sd;
    V3T<DualN<W>> od = lift3<DualN<W>>(o0), dd = lift3<DualN<W>>(d0),
                  td = lift3<DualN<W>>(th0),
                  rd = lift3<DualN<W>>(v3(0.0f, 0.0f, 0.0f));
#pragma unroll
    for (int i = 0; i < W; ++i) {
        sd.key[i] = -1;
        if (i < n) {
            const float* ds = dst + 9 * (k0 + i) * WF_THREADS;
            sd.key[i] = skey[k0 + i];
            od.x.t[i] = ds[0 * WF_THREADS];
            od.y.t[i] = ds[1 * WF_THREADS];
            od.z.t[i] = ds[2 * WF_THREADS];
            dd.x.t[i] = ds[3 * WF_THREADS];
            dd.y.t[i] = ds[4 * WF_THREADS];
            dd.z.t[i] = ds[5 * WF_THREADS];
            td.x.t[i] = ds[6 * WF_THREADS];
            td.y.t[i] = ds[7 * WF_THREADS];
            td.z.t[i] = ds[8 * WF_THREADS];
        }
    }
    float nw[1], ng[1];
    physics<DualN<W>, 0>(sc, P, cam, best, best_t, od, dd, td, rd, tm, u,
                         u_med, sd, nw, ng, gc);
#pragma unroll
    for (int i = 0; i < W; ++i) {
        if (i < n) {
            const int k = k0 + i;
            dgs[k * WF_THREADS] = dgs[k * WF_THREADS]
                + (gc[0] * rd.x.t[i] + gc[1] * rd.y.t[i] + gc[2] * rd.z.t[i]);
            if (alive_new) {
                float* ds = dst + 9 * k * WF_THREADS;
                const float pl[9] = {od.x.t[i], od.y.t[i], od.z.t[i],
                                     dd.x.t[i], dd.y.t[i], dd.z.t[i],
                                     td.x.t[i], td.y.t[i], td.z.t[i]};
                bool nz = false;
#pragma unroll
                for (int c = 0; c < 9; ++c) {
                    ds[c * WF_THREADS] = pl[c];
                    nz = nz || pl[c] != 0.0f;
                }
                nzm = nz ? (nzm | (1u << k)) : (nzm & ~(1u << k));
            }
        }
    }
}

// The suffix tier's routes after one iteration of the lane loop, called by
// every lane of the warp (the loop is warp-synchronous there): a lane owes
// n_fl routes, the first fl_mem its path's records (rec, SFX_REC floats
// each: eff row, at, the prefix P), then the path's last hit (ev, th0 its
// pre-bounce throughput, P = T), each g * (e + (T - P) / at) per channel
// to its eff row: the two-phase design's phase-B value, operation for
// operation (e: th at an emission; the scatter term 0 for a dielectric or
// where |at| <= 1e-8). Round j routes each lane's j-th; the lanes of a
// round that route to one row combine by a shuffle sum in lane order and
// the lowest adds it to the warp's row wrow: the order of every sum is the
// data's, the same on every run.
static __device__ __forceinline__ void suffix_routes(
        float* __restrict__ wrow, const float* __restrict__ rec, int N,
        const float (&gc)[3], V3 Tt, int n_fl, int fl_mem, const SfxEv& ev,
        V3 th0) {
    const unsigned full = 0xffffffffu;
    const int wl = threadIdx.x & 31;
    const float tt[3] = {Tt.x, Tt.y, Tt.z};
    for (int j = 0;; ++j) {
        const bool has = j < n_fl;
        const unsigned hm = __ballot_sync(full, has);
        if (hm == 0u) break;
        int key = -1;
        float v[3] = {0.0f, 0.0f, 0.0f};
        if (has) {
            int eff;
            bool diel = false;
            float at[3], pp[3], e[3] = {0.0f, 0.0f, 0.0f};
            if (j < fl_mem) {
                const float* r = rec + (size_t)SFX_REC * j * N;
                eff = (int)r[0];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    at[c] = r[(size_t)(1 + c) * N];
                    pp[c] = r[(size_t)(4 + c) * N];
                }
            } else {
                eff = ev.eff;
                diel = ev.diel;
                const float tv[3] = {th0.x, th0.y, th0.z};
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    at[c] = ev.at[c];
                    pp[c] = tt[c];
                    e[c] = ev.emit ? tv[c] : 0.0f;
                }
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float sf = tt[c] - pp[c];
                float sc_ = 0.0f;
                if (!diel && fabsf(at[c]) > 1e-8f) sc_ = sf / at[c];
                v[c] = gc[c] * (e[c] + sc_);
            }
            key = eff;
        }
        const unsigned grp = __match_any_sync(full, key);
        float s[3] = {0.0f, 0.0f, 0.0f};
        for (unsigned rem = hm; rem != 0u; rem &= rem - 1u) {
            const int src = __ffs(rem) - 1;
            const bool mine = (grp >> src) & 1u;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float x = __shfl_sync(full, v[c], src);
                if (mine) s[c] = s[c] + x;
            }
        }
        if (has && wl == __ffs(grp) - 1) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                if (s[c] != 0.0f) wrow[3 * key + c] = wrow[3 * key + c] + s[c];
        }
        __syncwarp();
    }
}

// One thread's lane: its samples and bounces. NTMAX > 0 adds the tex_color
// weight planes of the JAX kernel's grad_tex variant
// (wavefront_pallas.py:2347-2349, 2392-2395, 2565-2603): Wp[3t+c] =
// d th_c / d tex_color[t][c] rides the lane's path state (and the carry,
// rows 14..14+3NT), and Gp[3t+c] accumulates g_c * d(radiance_c)/d tex at
// each radiance event, g the lane's cotangent. NTMAX is the compile-time
// bound of NT, so every plane index is a constant after unrolling. HARD
// adds the K tangent bundles (see the top of this file). SEL is the
// selection (SEL_*: every primitive, the chunk scan, a BVH walk). SUFFIX is
// the suffix-radiance tier of tex_color (K8, see the top of this file).
// WROWS carries the weight planes as the path's rows (WpRows) in place of
// NTMAX's register planes: the chunk scan's and the BVH walks' instances,
// NT <= 32.
// scr is the grad tier's scratch in global memory: the suffix tier's, each
// warp's 3 * NT row (gridDim.x * WF_THREADS / 32 rows), then, for an
// uncapped pass, the lanes' records (SFX_REC * max_depth floats a lane,
// [record][field][lane]; a capped pass keeps them in its carry); WROWS's,
// every lane's Gp rows and then every lane's plane rows, NT float4s a lane
// each (WpCols). `red` is the block's shared scratch of the end-of-pass
// reduction: (WF_THREADS / 32, 3 * NTMAX) floats (NTMAX > 0), or for WROWS
// (WF_THREADS / 32, 3 * WP_TREE_ROWS), which also holds the lanes' gm
// masks. multi (WROWS, nullable) counts the paths whose planes came to
// hold a second row. V and vtab are the chunk scan's tables, B and vtab a
// BVH walk's.
//
// Shared memory (smem): the tables (the chunk scan: its boxes; a BVH walk:
// nothing), padded to plane_base; then (HARD) the tangent planes and their
// sums, 10 * K * WF_THREADS floats.
template <int NTMAX, bool HARD, int SEL = SEL_UNROLLED, bool SUFFIX = false,
          bool WROWS = false>
__device__ __forceinline__ void wavefront_body(
        const WfParams& P, const float* __restrict__ tables,
        const int* __restrict__ pix_lanes,
        const float* __restrict__ carry_in, const float* __restrict__ cot,
        float* __restrict__ rad_out, float* __restrict__ carry_out,
        float* __restrict__ dg_out, int* __restrict__ iters_out,
        float* smem, float* cam, float* red, VsParams V = VsParams(),
        const float* __restrict__ vtab = nullptr, BvParams B = BvParams(),
        int* skey = nullptr, float* __restrict__ scr = nullptr,
        int* multi = nullptr) {
    constexpr bool GRAD = NTMAX > 0 || HARD || SUFFIX || WROWS;
    static_assert(!SUFFIX || NTMAX == 0, "the suffix tier has no planes");
    static_assert(!WROWS || (NTMAX == 0 && !SUFFIX && SEL != SEL_UNROLLED),
                  "the row planes replace the register planes past the "
                  "unrolled selection");
    static_assert(!HARD || SEL == SEL_UNROLLED || SEL == SEL_VSCAN,
                  "the BVH walks carry no tangent bundles");
    const int plane_base = SEL == SEL_VSCAN ? table_pad(V.n_box)
        : (SEL == SEL_UNROLLED ? table_pad(P.n_table) : 0);
    if constexpr (SEL == SEL_VSCAN) {
        // the chunk scan reads the scene tables from global memory and
        // keeps only the chunk boxes in shared memory
        for (int i = threadIdx.x; i < V.n_box; i += blockDim.x)
            smem[i] = vtab[V.off_box + i];
    } else if constexpr (SEL == SEL_UNROLLED) {
        for (int i = threadIdx.x; i < P.n_table; i += blockDim.x)
            smem[i] = tables[i];
    }
    if (threadIdx.x < 22) cam[threadIdx.x] = P.cam[threadIdx.x];
    if constexpr (HARD) {
        // the slot table's cells as keys (slot_key), K ints in shared memory
        for (int k = threadIdx.x; k < P.K; k += blockDim.x) {
            const float* sl = tables + P.off_slot + SLOT_COLS * k;
            skey[k] = slot_key((int)sl[0], (int)sl[1], (int)sl[2]);
        }
    }
    __syncthreads();

    // the entry points launch whole blocks of lanes only (the grad pass
    // reduces across the block, so no thread may leave early)
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const int N = P.n_lanes;

    Scene sc;
    const float* tab = SEL == SEL_UNROLLED ? smem : tables;
    sc.sph = tab + P.off_sph;
    sc.quad = tab + P.off_quad;
    sc.pmat = tab + P.off_pmat;
    sc.light = tab + P.off_light;
    sc.mati = tab + P.off_mati;
    sc.matf = tab + P.off_matf;
    sc.tex = tab + P.off_tex;
    sc.med = tab + P.off_med;
    sc.lsrc = tab + P.off_lsrc;
    sc.slot = tab + P.off_slot;
    sc.S = P.S; sc.Q = P.Q; sc.L = P.L; sc.M = P.M; sc.MS = P.MS;
    sc.MQ = P.MQ; sc.med_cols = P.med_cols;
    sc.checker_depth = P.checker_depth; sc.has_noise = P.has_noise;
    sc.perlin_seed = P.perlin_seed;

    // pad lanes of the identity layout repeat the last pixel (cropped later)
    const int pix = P.row0 * P.width
        + (pix_lanes ? pix_lanes[lane]
                     : (lane < P.n_pix ? lane : P.n_pix - 1));
    const uint32_t k0 = (uint32_t)pix;
    const uint32_t k2 = P.seed_mix;
    const float fi = (float)(pix % P.width);
    const float fj = (float)(pix / P.width);

    V3 o, d, th;
    float tm;
    int bounce, sample;
    bool alive, work;
    if (carry_in) {
        work = carry_in[0 * N + lane] > 0.5f;
        alive = carry_in[1 * N + lane] > 0.5f;
        bounce = (int)carry_in[2 * N + lane];
        sample = (int)carry_in[3 * N + lane];
        tm = carry_in[4 * N + lane];
        o = v3(carry_in[5 * N + lane], carry_in[6 * N + lane],
               carry_in[7 * N + lane]);
        d = v3(carry_in[8 * N + lane], carry_in[9 * N + lane],
               carry_in[10 * N + lane]);
        th = v3(carry_in[11 * N + lane], carry_in[12 * N + lane],
                carry_in[13 * N + lane]);
    } else {
        gen_ray(P, cam, k0, k2, fi, fj, P.sample_start, o, d, tm);
        th = v3(1.0f, 1.0f, 1.0f);
        alive = true;
        work = true;
        bounce = 0;
        sample = 0;
    }
    V3 rad = v3(0.0f, 0.0f, 0.0f);
    const int n_wp = (NTMAX > 0 || WROWS) ? 3 * P.NT : 0;
    // the row planes: no row held, no Gp row written; a resumed path
    // holds its nonzero rows (not counted again in multi)
    WpRows wpl;
    const WpCols wcol = {scr + (size_t)4 * P.NT * lane,
                         scr + (size_t)4 * P.NT * (N + lane), multi};
    if constexpr (WROWS) {
        wpl.rows = 0u;
        wpl.gm = 0u;
        if (carry_in) {
            for (int t = 0; t < P.NT; ++t) {
                float x[3];
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    x[c] = carry_in[(size_t)(14 + 3 * t + c) * N + lane];
                if (x[0] != 0.0f || x[1] != 0.0f || x[2] != 0.0f) {
                    wp_store(wcol, t, x);
                    wpl.rows |= 1u << t;
                }
            }
        }
    }
    // the suffix tier's lane state: the path total T so far and the
    // path's pending records (carry rows 14 + 9K .. 14 + 9K + 3, then the
    // records); wrow is this warp's row of route sums, rec this lane's
    // column of records (the capped pass's carry, else the scratch)
    V3 Tt = v3(0.0f, 0.0f, 0.0f);
    int n_rec = 0;
    float* wrow = nullptr;
    float* rec = nullptr;
    if constexpr (SUFFIX) {
        const int n3 = 3 * P.NT;
        wrow = scr + ((size_t)blockIdx.x * (WF_THREADS / 32)
                      + (threadIdx.x >> 5)) * n3;
        for (int i = threadIdx.x & 31; i < n3; i += 32) wrow[i] = 0.0f;
        __syncwarp();
        const size_t cs = (size_t)(14 + 9 * P.K) * N;
        rec = (carry_out ? carry_out + cs + (size_t)SFX_STATE * N
               : scr + (size_t)gridDim.x * (WF_THREADS / 32) * n3) + lane;
        if (carry_in) {
            const float* ci = carry_in + cs + lane;
            Tt = v3(ci[0], ci[N], ci[2 * (size_t)N]);
            n_rec = (int)ci[3 * (size_t)N];
            for (int j = 0; j < SFX_REC * n_rec; ++j)
                rec[(size_t)j * N] = ci[(size_t)(SFX_STATE + j) * N];
        }
    }

    // weight planes (path state) and their cotangent sums (per pass);
    // planes t >= NT stay 0: no hit reads their row
    float Wp[NTMAX > 0 ? 3 * NTMAX : 1];
    float Gp[NTMAX > 0 ? 3 * NTMAX : 1];
    float gc[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (NTMAX > 0) {
#pragma unroll
        for (int k = 0; k < 3 * NTMAX; ++k) {
            Wp[k] = (carry_in && k < n_wp) ? carry_in[(14 + k) * N + lane]
                                           : 0.0f;
            Gp[k] = 0.0f;
        }
    }
    if constexpr (GRAD) {
        gc[0] = cot[0 * N + lane];
        gc[1] = cot[1 * N + lane];
        gc[2] = cot[2 * N + lane];
    }
    // tangent bundles: plane c of slot k at dst[(9k + c) * WF_THREADS], its
    // cotangent sum at dgs[k * WF_THREADS] (this thread's column)
    float* dst = smem + plane_base + threadIdx.x;
    float* dgs = dst + 9 * P.K * WF_THREADS;
    // the slot groups (a bit where a group starts), the slots whose sphere
    // a light row copies (read at every MIS bounce), and the slots whose
    // planes hold a nonzero value on this lane (a slot with zero planes
    // that a bounce does not read gets exactly zero tangents there: the
    // warp-wide skip)
    uint32_t gstart = 0u, lsm = 0u, nzm = 0u;
    if constexpr (HARD) {
        for (int j = 0; j < 9 * P.K; ++j)
            dst[j * WF_THREADS] = carry_in
                ? carry_in[(14 + n_wp + j) * N + lane] : 0.0f;
        for (int k = 0; k < P.K; ++k) dgs[k * WF_THREADS] = 0.0f;
        int prev = -2, run = 0;
        for (int k = 0; k < P.K; ++k) {
            const int key = skey[k];
            const int grp = slot_tab(key) == SEED_SPH ? slot_row(key) : -1;
            if (grp != prev || run == HARD_W) {
                gstart |= 1u << k;
                run = 0;
            }
            ++run;
            prev = grp;
            if (slot_tab(key) == SEED_SPH) {
                for (int l = 0; l < sc.L; ++l)
                    if ((int)sc.lsrc[l] == slot_row(key)) lsm |= 1u << k;
            }
            bool nz = false;
            for (int c = 0; c < 9; ++c)
                nz = nz || dst[(9 * k + c) * WF_THREADS] != 0.0f;
            if (nz) nzm |= 1u << k;
        }
    }

    int it = 0;
    for (;;) {
        const bool act = work && (P.cap == 0 || it < P.cap);
        if constexpr (SUFFIX) {
            // the suffix tier's warp runs its lanes' iterations together
            // (a lane with no work left takes empty ones), so its routes
            // are summed at a point every lane reaches, in a fixed order
            if (!__any_sync(0xffffffffu, act)) break;
        } else if (!act) {
            break;
        }
        // the suffix tier's routes this lane owes after the iteration:
        // n_fl in all, its first fl_mem the path's records, then the last
        // hit's (last, with its pre-bounce throughput last_th)
        int n_fl = 0, fl_mem = 0;
        SfxEv last;
        V3 last_th;
        if (act) {
            // a finished path restarts on the pixel's next stratified sample
            if (!alive) {
                sample += 1;
                if constexpr (SUFFIX) Tt = v3(0.0f, 0.0f, 0.0f);
                gen_ray(P, cam, k0, k2, fi, fj, P.sample_start + sample, o, d,
                        tm);
                th = v3(1.0f, 1.0f, 1.0f);
                bounce = 0;
                alive = true;
                // a fresh path starts with throughput 1: no parameter
                // dependence
                if constexpr (NTMAX > 0) {
#pragma unroll
                    for (int k = 0; k < 3 * NTMAX; ++k) Wp[k] = 0.0f;
                }
                if constexpr (WROWS) wpl.rows = 0u;
                if constexpr (HARD) {
                    for (int j = 0; j < 9 * P.K; ++j)
                        dst[j * WF_THREADS] = 0.0f;
                    nzm = 0u;
                }
            }
            const uint32_t k1 = (uint32_t)(P.sample_start + sample);
            float u[9];
            draws(k0, k1, k2, 0x4000000u + (uint32_t)bounce, u, 9);
            float u_med[4];
            if (sc.M > 0)
                draws(k0, k1, k2, 1000000u + (uint32_t)bounce, u_med, sc.M);

            float best_t;
            int best;
            if constexpr (SEL == SEL_VSCAN)
                best = closest_select_vscan(sc, V, vtab, smem, o, d, tm,
                                            &best_t);
            else if constexpr (SEL == SEL_STACK)
                best = closest_select_stack(B, vtab, o, d, tm, &best_t);
            else if constexpr (SEL == SEL_LANE)
                best = closest_select_lane(B, vtab, o, d, tm, &best_t);
            else
                best = closest_select(sc, o, d, tm, &best_t);
            const V3 o0 = o, d0 = d, th0 = th;
            // the suffix tier takes the bounce's radiance increment apart
            V3 drad = v3(0.0f, 0.0f, 0.0f);
            SfxEv ev;
            ev.hit = false;
            const bool alive_new = physics<float, NTMAX>(
                sc, P, cam, best, best_t, o, d, th, SUFFIX ? drad : rad, tm, u,
                u_med, Seeds<0>{}, Wp, Gp, gc, (SUFFIX || HARD) ? &ev : nullptr,
                WROWS ? &wpl : nullptr, wcol);
            if constexpr (SUFFIX) {
                // the image, and the path total T so far: the prefix P of the
                // hit's routes, bit for bit
                rad = add(rad, drad);
                Tt = add(Tt, drad);
            }
            if constexpr (HARD) {
                // the slot groups' dual passes, from the same ray and
                // selection along the slots' tangents, so the same outcome.
                // A group runs in a warp where a lane holds a nonzero plane
                // of one of its slots or its bounce reads one of their cells
                // (physics' seeded reads: the winner's sphere row in
                // hit_record, the hit material's fuzz or IOR, and at an MIS
                // bounce every light row's source sphere); elsewhere its
                // tangents are exactly zero, its planes and sums stay as
                // they are.
                uint32_t need = nzm;
                if (ev.hit) {
                    const int mt = (int)sc.mati[ev.mat * 2];
                    if (mt != MAT_METAL && mt != MAT_DIELECTRIC
                        && mt != MAT_DIFFUSE_LIGHT && sc.L > 0)
                        need |= lsm;
                    const int mkey = mt == MAT_METAL
                        ? slot_key(SEED_MATF, ev.mat, 0)
                        : (mt == MAT_DIELECTRIC
                           ? slot_key(SEED_MATF, ev.mat, 1) : -1);
                    for (int k = 0; k < P.K; ++k)
                        if (skey[k] == mkey) need |= 1u << k;
                }
                if (best >= 0 && best < sc.S) {
                    for (int k = 0; k < P.K; ++k)
                        if (slot_tab(skey[k]) == SEED_SPH
                            && slot_row(skey[k]) == best)
                            need |= 1u << k;
                }
#pragma unroll 1
                for (int k = 0; k < P.K;) {
                    int e = k + 1;
                    while (e < P.K && !((gstart >> e) & 1u)) ++e;
                    const uint32_t gm = ((1u << (e - k)) - 1u) << k;
                    const bool run = __ballot_sync(
                        __activemask(), (need & gm) != 0u) != 0u;
                    if (run)
                        hard_group<HARD_W>(sc, P, cam, best, best_t, o0, d0,
                                           th0, tm, u, u_med, gc, alive_new,
                                           dst, dgs, skey, k, e - k, nzm);
                    k = e;
                }
            }
            bounce += 1;
            alive = alive_new && bounce < P.max_depth;
            work = alive || (sample + 1 < P.n_samples);
            if constexpr (SUFFIX) {
                // a hit with an eff row: a record while the path goes on (a
                // dielectric's at is 1, its route 0), and when the path ends
                // the last hit (its emission, and T - T = 0 of scatter) and
                // every record are routed below, T now known
                const bool ev_row = ev.hit && ev.eff >= 0;
                if (alive) {
                    if (ev_row && !ev.diel) {
                        float* r = rec + (size_t)SFX_REC * n_rec * N;
                        r[0] = (float)ev.eff;
                        r[1 * (size_t)N] = ev.at[0];
                        r[2 * (size_t)N] = ev.at[1];
                        r[3 * (size_t)N] = ev.at[2];
                        r[4 * (size_t)N] = Tt.x;
                        r[5 * (size_t)N] = Tt.y;
                        r[6 * (size_t)N] = Tt.z;
                        ++n_rec;
                    }
                } else {
                    fl_mem = n_rec;
                    n_fl = n_rec + (ev_row ? 1 : 0);
                    n_rec = 0;
                    last = ev;
                    last_th = th0;
                }
            }
            ++it;
        }
        if constexpr (SUFFIX)
            suffix_routes(wrow, rec, N, gc, Tt, n_fl, fl_mem, last, last_th);
    }

    rad_out[0 * N + lane] = rad.x;
    rad_out[1 * N + lane] = rad.y;
    rad_out[2 * N + lane] = rad.z;
    if (iters_out) iters_out[lane] += it;
    if (carry_out) {
        carry_out[0 * N + lane] = work ? 1.0f : 0.0f;
        carry_out[1 * N + lane] = alive ? 1.0f : 0.0f;
        carry_out[2 * N + lane] = (float)bounce;
        carry_out[3 * N + lane] = (float)sample;
        carry_out[4 * N + lane] = tm;
        carry_out[5 * N + lane] = o.x;
        carry_out[6 * N + lane] = o.y;
        carry_out[7 * N + lane] = o.z;
        carry_out[8 * N + lane] = d.x;
        carry_out[9 * N + lane] = d.y;
        carry_out[10 * N + lane] = d.z;
        carry_out[11 * N + lane] = th.x;
        carry_out[12 * N + lane] = th.y;
        carry_out[13 * N + lane] = th.z;
        if constexpr (NTMAX > 0) {
#pragma unroll
            for (int k = 0; k < 3 * NTMAX; ++k)
                if (k < n_wp) carry_out[(14 + k) * N + lane] = Wp[k];
        }
        if constexpr (WROWS) {
            // the dense planes: 0 but for the rows the path holds
            for (int t = 0; t < P.NT; ++t) {
                float x[3] = {0.0f, 0.0f, 0.0f};
                if ((wpl.rows >> t) & 1u) wp_load(wcol, t, x);
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    carry_out[(size_t)(14 + 3 * t + c) * N + lane] = x[c];
            }
        }
        if constexpr (HARD) {
            for (int j = 0; j < 9 * P.K; ++j)
                carry_out[(14 + n_wp + j) * N + lane] = dst[j * WF_THREADS];
        }
        if constexpr (SUFFIX) {
            // T and the record count; the records are in place (rec)
            float* cs = carry_out + (size_t)(14 + 9 * P.K) * N + lane;
            cs[0] = Tt.x;
            cs[N] = Tt.y;
            cs[2 * (size_t)N] = Tt.z;
            cs[3 * (size_t)N] = (float)n_rec;
        }
    }
    if constexpr (GRAD) {
        // one partial row per block: 3NT tex entries, then K hard ones,
        // each summed in a fixed order
        const int n_tex = SUFFIX ? 3 * P.NT : n_wp;
        const int n_row = n_tex + (HARD ? P.K : 0);
        if constexpr (NTMAX > 0) {
            // Gp: a shuffle tree in each warp, then the warps in order
            const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
            for (int k = 0; k < 3 * NTMAX; ++k) {
                float v = Gp[k];
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    v += __shfl_down_sync(0xffffffffu, v, off);
                if (wl == 0) red[warp * 3 * NTMAX + k] = v;
            }
        }
        if constexpr (WROWS) {
            // Gp in the order the dense tiers summed it: up to
            // WP_TREE_ROWS rows the register planes' (a shuffle tree in
            // each warp, then the warps in order), past them the shared
            // planes' (each plane's 128 lanes in lane order); a lane that
            // never wrote a row adds its exact 0 nowhere
            if (P.NT <= WP_TREE_ROWS) {
                const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
                for (int k = 0; k < n_wp; ++k) {
                    const bool had = (wpl.gm >> (k / 3)) & 1u;
                    float v = had ? wcol.gs[4 * (k / 3) + k % 3] : 0.0f;
#pragma unroll
                    for (int off = 16; off > 0; off >>= 1)
                        v += __shfl_down_sync(0xffffffffu, v, off);
                    if (ln == 0) red[warp * 3 * WP_TREE_ROWS + k] = v;
                }
            } else {
                reinterpret_cast<uint32_t*>(red)[threadIdx.x] = wpl.gm;
            }
        }
        __syncthreads();
        if constexpr (NTMAX > 0) {
            if (threadIdx.x < n_wp) {
                float s = 0.0f;
                for (int w = 0; w < WF_THREADS / 32; ++w)
                    s += red[w * 3 * NTMAX + threadIdx.x];
                dg_out[blockIdx.x * n_row + threadIdx.x] = s;
            }
        }
        if constexpr (WROWS) {
            if (threadIdx.x < n_wp) {
                const int k = threadIdx.x, t = k / 3;
                float s = 0.0f;
                if (P.NT <= WP_TREE_ROWS) {
                    for (int w = 0; w < WF_THREADS / 32; ++w)
                        s += red[w * 3 * WP_TREE_ROWS + k];
                } else {
                    // (a lane that never wrote the row adds its exact 0: s
                    // starts at +0 and is never -0, so s + 0 is s)
                    const uint32_t* gms = reinterpret_cast<const uint32_t*>(
                        red);
                    // lane i's sum at col[i * stride]
                    const size_t lane0 = (size_t)blockIdx.x * WF_THREADS;
                    const float* col = scr + lane0 * 4 * P.NT + 4 * t
                        + k % 3;
                    const size_t stride = 4 * P.NT;
                    for (int i0 = 0; i0 < WF_THREADS; i0 += 8) {
                        float x[8];
#pragma unroll
                        for (int i = 0; i < 8; ++i)
                            x[i] = ((gms[i0 + i] >> t) & 1u)
                                ? col[(i0 + i) * stride] : 0.0f;
#pragma unroll
                        for (int i = 0; i < 8; ++i) s += x[i];
                    }
                }
                dg_out[blockIdx.x * n_row + k] = s;
            }
        }
        if constexpr (SUFFIX) {
            // the block's warp rows, added in warp order
            const float* w0 = scr + (size_t)blockIdx.x * (WF_THREADS / 32)
                * n_tex;
            for (int i = threadIdx.x; i < n_tex; i += blockDim.x) {
                float s = w0[i];
                for (int w = 1; w < WF_THREADS / 32; ++w)
                    s += w0[(size_t)w * n_tex + i];
                dg_out[blockIdx.x * n_row + i] = s;
            }
        }
        if constexpr (HARD) {
            // dG: slot k's 128 lanes in lane order
            if (threadIdx.x < P.K) {
                const float* col = smem + plane_base
                    + (9 * P.K + threadIdx.x) * WF_THREADS;
                float s = 0.0f;
                for (int i = 0; i < WF_THREADS; ++i) s += col[i];
                dg_out[blockIdx.x * n_row + n_tex + threadIdx.x] = s;
            }
        }
    }
}

// The next lane slot for this thread: one atomicAdd on the launch's slot
// counter for the active lanes of the warp (warp-aggregated), each lane
// taking the slot of its rank among them.
__device__ __forceinline__ int next_slot(int* counter) {
    const unsigned m = __activemask();
    const int wl = threadIdx.x & 31;
    const int leader = __ffs(m) - 1;
    int base = 0;
    if (wl == leader) base = atomicAdd(counter, __popc(m));
    base = __shfl_sync(m, base, leader);
    return base + __popc(m & ((1u << wl) - 1u));
}

// The forward pass with persistent threads (K1, K2; Aila and Laine, HPG
// 2009): a launch holds only as many blocks as the card keeps resident,
// and each thread takes lane slots from the launch's counter (`next`, an
// int the wrapper zeroes on the launch's stream) until none is left. A
// slot is wavefront_body's lane of the same index: its pixel (pix_lanes
// or the identity), its carry in and out, its radiance and its iteration
// count, each computed by the same operations in the same order, so every
// output equals the one-lane-a-thread launch's bit for bit whichever
// thread ran the slot. A thread whose slot has no work left (its samples
// done, or `cap` iterations run) writes the slot's outputs and takes the
// next one at the top of the loop, so its warp's other lanes go on with
// their bounces and the warp stays full until the slots run out.
template <int SEL>
__device__ __forceinline__ void forward_refill(
        const WfParams& P, const float* __restrict__ tables,
        const int* __restrict__ pix_lanes,
        const float* __restrict__ carry_in, float* __restrict__ rad_out,
        float* __restrict__ carry_out, int* __restrict__ iters_out,
        int* __restrict__ next, float* smem, float* cam,
        const float* __restrict__ vtab = nullptr, BvParams B = BvParams()) {
    static_assert(SEL == SEL_UNROLLED || SEL == SEL_LANE,
                  "the refilled forward takes the unrolled or the lane "
                  "selection");
    if constexpr (SEL == SEL_UNROLLED) {
        for (int i = threadIdx.x; i < P.n_table; i += blockDim.x)
            smem[i] = tables[i];
    }
    if (threadIdx.x < 22) cam[threadIdx.x] = P.cam[threadIdx.x];
    __syncthreads();
    const int N = P.n_lanes;
    Scene sc;
    const float* tab = SEL == SEL_UNROLLED ? smem : tables;
    sc.sph = tab + P.off_sph;
    sc.quad = tab + P.off_quad;
    sc.pmat = tab + P.off_pmat;
    sc.light = tab + P.off_light;
    sc.mati = tab + P.off_mati;
    sc.matf = tab + P.off_matf;
    sc.tex = tab + P.off_tex;
    sc.med = tab + P.off_med;
    sc.lsrc = tab + P.off_lsrc;
    sc.slot = tab + P.off_slot;
    sc.S = P.S; sc.Q = P.Q; sc.L = P.L; sc.M = P.M; sc.MS = P.MS;
    sc.MQ = P.MQ; sc.med_cols = P.med_cols;
    sc.checker_depth = P.checker_depth; sc.has_noise = P.has_noise;
    sc.perlin_seed = P.perlin_seed;
    const uint32_t k2 = P.seed_mix;
    float Wp[1], Gp[1];
    const float gc[3] = {0.0f, 0.0f, 0.0f};

    int lane = -1;
    uint32_t k0 = 0u;
    float fi = 0.0f, fj = 0.0f, tm = 0.0f;
    V3 o = v3(0.0f, 0.0f, 0.0f), d = o, th = o, rad = o;
    int bounce = 0, sample = 0, it = 0;
    bool alive = false, work = false;
    for (;;) {
        if (!(work && (P.cap == 0 || it < P.cap))) {
            if (lane >= 0) {
                rad_out[0 * N + lane] = rad.x;
                rad_out[1 * N + lane] = rad.y;
                rad_out[2 * N + lane] = rad.z;
                if (iters_out) iters_out[lane] += it;
                if (carry_out) {
                    carry_out[0 * N + lane] = work ? 1.0f : 0.0f;
                    carry_out[1 * N + lane] = alive ? 1.0f : 0.0f;
                    carry_out[2 * N + lane] = (float)bounce;
                    carry_out[3 * N + lane] = (float)sample;
                    carry_out[4 * N + lane] = tm;
                    carry_out[5 * N + lane] = o.x;
                    carry_out[6 * N + lane] = o.y;
                    carry_out[7 * N + lane] = o.z;
                    carry_out[8 * N + lane] = d.x;
                    carry_out[9 * N + lane] = d.y;
                    carry_out[10 * N + lane] = d.z;
                    carry_out[11 * N + lane] = th.x;
                    carry_out[12 * N + lane] = th.y;
                    carry_out[13 * N + lane] = th.z;
                }
            }
            lane = next_slot(next);
            if (lane >= N) break;
            // pad lanes of the identity layout repeat the last pixel
            const int pix = P.row0 * P.width
                + (pix_lanes ? pix_lanes[lane]
                             : (lane < P.n_pix ? lane : P.n_pix - 1));
            k0 = (uint32_t)pix;
            fi = (float)(pix % P.width);
            fj = (float)(pix / P.width);
            if (carry_in) {
                work = carry_in[0 * N + lane] > 0.5f;
                alive = carry_in[1 * N + lane] > 0.5f;
                bounce = (int)carry_in[2 * N + lane];
                sample = (int)carry_in[3 * N + lane];
                tm = carry_in[4 * N + lane];
                o = v3(carry_in[5 * N + lane], carry_in[6 * N + lane],
                       carry_in[7 * N + lane]);
                d = v3(carry_in[8 * N + lane], carry_in[9 * N + lane],
                       carry_in[10 * N + lane]);
                th = v3(carry_in[11 * N + lane], carry_in[12 * N + lane],
                        carry_in[13 * N + lane]);
            } else {
                gen_ray(P, cam, k0, k2, fi, fj, P.sample_start, o, d, tm);
                th = v3(1.0f, 1.0f, 1.0f);
                alive = true;
                work = true;
                bounce = 0;
                sample = 0;
            }
            rad = v3(0.0f, 0.0f, 0.0f);
            it = 0;
            continue;
        }
        // a finished path restarts on the pixel's next stratified sample
        if (!alive) {
            sample += 1;
            gen_ray(P, cam, k0, k2, fi, fj, P.sample_start + sample, o, d,
                    tm);
            th = v3(1.0f, 1.0f, 1.0f);
            bounce = 0;
            alive = true;
        }
        const uint32_t k1 = (uint32_t)(P.sample_start + sample);
        float u[9];
        draws(k0, k1, k2, 0x4000000u + (uint32_t)bounce, u, 9);
        float u_med[4];
        if (sc.M > 0)
            draws(k0, k1, k2, 1000000u + (uint32_t)bounce, u_med, sc.M);
        float best_t;
        int best;
        if constexpr (SEL == SEL_LANE)
            best = closest_select_lane(B, vtab, o, d, tm, &best_t);
        else
            best = closest_select(sc, o, d, tm, &best_t);
        const bool alive_new = physics<float, 0>(
            sc, P, cam, best, best_t, o, d, th, rad, tm, u, u_med,
            Seeds<0>{}, Wp, Gp, gc, nullptr, nullptr);
        bounce += 1;
        alive = alive_new && bounce < P.max_depth;
        work = alive || (sample + 1 < P.n_samples);
        ++it;
    }
}

// the grid of a refilled forward launch: the blocks the card keeps
// resident (at `smem` bytes of dynamic shared memory), no more than the
// slots need; 0 where the query fails
static int resident_blocks(const void* kernel, size_t smem, int n_lanes) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, WF_THREADS, smem) != cudaSuccess)
        return 0;
    const int need = (n_lanes + WF_THREADS - 1) / WF_THREADS;
    return per_sm * sms < need ? per_sm * sms : need;
}

// The library is built from this file in parts, each part a translation
// unit of its own, compiled in parallel and linked into one shared library
// (ops/wavefront_cuda.py::build_library): WF_PART 0 holds the forward
// instances, the unrolled grad instances and the other C entry points; 1 the
// chunk scan's weight-plane grad instance (K3v); 2 its hard-slot-only and
// suffix instances (K4v, K8); 3 its weight planes with tangent bundles (K3v
// with K4v); 4 the
// adjoint's per-sample sweep (K9) and its C entry point; 5 its
// segmented-regeneration sweep (K10) and its C entry point; 6 the stack BVH's
// forward and tex_color grad instances (K11) and their C entry point; 7 the
// lane BVH's (K12). Without WF_PART the file holds all of them.
#ifndef WF_PART
#define WF_PART -1
#endif
#define WF_IN_PART(p) (WF_PART < 0 || WF_PART == (p))

// dynamic shared memory, raised past the default 48 KB where a launch
// needs it
static cudaError_t set_smem(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The pointers of one grad launch (or one BVH walk's, forward or grad).
struct GradArgs {
    const float* tables;
    const float* vtab;
    const int* pix_lanes;
    const float* carry_in;
    const float* cot;
    float* rad_out;
    float* carry_out;
    float* dg_out;
    int* iters_out;
    float* scr;     // the grad tier's scratch (wavefront_body)
    int* multi;     // paths whose row planes held two rows (nullable)
};

// the chunk scan's grad launchers (parts 1, 2 and 3)
int launch_vgrad_planes(const WfParams& P, const VsParams& V,
                        const GradArgs& A, cudaStream_t stream);
int launch_vgrad_other(const WfParams& P, const VsParams& V,
                       const GradArgs& A, cudaStream_t stream);
int launch_vgrad_planes_hard(const WfParams& P, const VsParams& V,
                             const GradArgs& A, cudaStream_t stream);

// The chunk scan's grad passes (K3v weight planes, K4v tangent bundles,
// K8 the suffix-radiance tier, each with the carry of K5): the unrolled
// grad kernel's tiers over closest_select_vscan. The winner's original id
// indexes the scene tables (global memory), so physics<T> and the slot
// table's aliasing are the unrolled kernel's; shared memory holds the
// chunk boxes and the tangent planes; the row planes' rows and the suffix
// tier's rows and records are in global memory (A.scr). This template
// holds K4v alone and K8 (with and without K4v); the weight planes' are
// wavefront_planes_vscan_kernel below.
template <int NTMAX, bool HARD, bool SUFFIX>
__global__ void __launch_bounds__(WF_THREADS)
wavefront_grad_vscan_kernel(WfParams P, VsParams V, GradArgs A) {
    __shared__ float cam[22];
    __shared__ float red[(WF_THREADS / 32) * 3 * (NTMAX > 0 ? NTMAX : 1)];
    if constexpr (HARD) {
        __shared__ int skey[MAX_SLOTS];
        wavefront_body<NTMAX, HARD, SEL_VSCAN, SUFFIX>(
            P, A.tables, A.pix_lanes, A.carry_in, A.cot, A.rad_out,
            A.carry_out, A.dg_out, A.iters_out, wf_tables, cam, red, V,
            A.vtab, BvParams(), skey, A.scr);
    } else {
        wavefront_body<NTMAX, HARD, SEL_VSCAN, SUFFIX>(
            P, A.tables, A.pix_lanes, A.carry_in, A.cot, A.rad_out,
            A.carry_out, A.dg_out, A.iters_out, wf_tables, cam, red, V,
            A.vtab, BvParams(), nullptr, A.scr);
    }
}

// the dynamic shared memory of a chunk-scan grad launch: the chunk boxes,
// then (HARD) the tangent planes and their sums
static size_t vgrad_smem(const WfParams& P, const VsParams& V, bool hard) {
    return sizeof(float) * ((size_t)table_pad(V.n_box)
                            + (hard ? (size_t)10 * P.K * WF_THREADS : 0));
}

template <int NTMAX, bool HARD, bool SUFFIX>
static int launch_grad_vscan(const WfParams& P, const VsParams& V,
                             const GradArgs& A, cudaStream_t stream) {
    const size_t smem = vgrad_smem(P, V, HARD);
    cudaError_t e = set_smem(
        (const void*)wavefront_grad_vscan_kernel<NTMAX, HARD, SUFFIX>, smem);
    if (e != cudaSuccess) return (int)e;
    wavefront_grad_vscan_kernel<NTMAX, HARD, SUFFIX>
        <<<P.n_lanes / WF_THREADS, WF_THREADS, smem, stream>>>(P, V, A);
    return (int)cudaGetLastError();
}

// The weight planes (K3v), NT <= 32, alone (part 1) and with tangent
// bundles (K4v riding them, HARD; part 3): the chunk scan's grad body with
// the row planes. Alone it asks for WP_BLOCKS = 7 blocks an SM, its
// registers held to 72 with 146 B of spill stores: at 5 blocks (96
// registers, no spills) it is 12% slower at the 28-row shape (PERF.md);
// with the tangent bundles WP_HARD_BLOCKS = 5 (96 registers, 616 B of
// spills; 153 registers and three blocks, 4% slower).
template <bool HARD>
__global__ void __launch_bounds__(WF_THREADS,
                                  HARD ? WP_HARD_BLOCKS : WP_BLOCKS)
wavefront_planes_vscan_kernel(WfParams P, VsParams V, GradArgs A) {
    __shared__ float cam[22];
    __shared__ float red[(WF_THREADS / 32) * 3 * WP_TREE_ROWS];
    __shared__ int skey[HARD ? MAX_SLOTS : 1];
    wavefront_body<0, HARD, SEL_VSCAN, false, true>(
        P, A.tables, A.pix_lanes, A.carry_in, A.cot, A.rad_out, A.carry_out,
        A.dg_out, A.iters_out, wf_tables, cam, red, V, A.vtab, BvParams(),
        HARD ? skey : nullptr, A.scr, A.multi);
}

template <bool HARD>
static int launch_planes_vscan(const WfParams& P, const VsParams& V,
                               const GradArgs& A, cudaStream_t stream) {
    const size_t smem = vgrad_smem(P, V, HARD);
    cudaError_t e = set_smem(
        (const void*)wavefront_planes_vscan_kernel<HARD>, smem);
    if (e != cudaSuccess) return (int)e;
    wavefront_planes_vscan_kernel<HARD>
        <<<P.n_lanes / WF_THREADS, WF_THREADS, smem, stream>>>(P, V, A);
    return (int)cudaGetLastError();
}

// blocks an SM the card keeps resident of that instance at smem bytes of
// dynamic shared memory (for the checks on the card: chip_smoke.py)
template <bool HARD>
static int planes_vscan_blocks(int smem, int* out) {
    const void* k = (const void*)wavefront_planes_vscan_kernel<HARD>;
    const cudaError_t e = set_smem(k, (size_t)smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, k, WF_THREADS, (size_t)smem);
}

#if WF_IN_PART(1)
int launch_vgrad_planes(const WfParams& P, const VsParams& V,
                        const GradArgs& A, cudaStream_t stream) {
    return launch_planes_vscan<false>(P, V, A, stream);
}

extern "C" int rt_vgrad_planes_blocks(int smem, int* out) {
    return planes_vscan_blocks<false>(smem, out);
}
#endif

#if WF_IN_PART(2)
// tangent bundles alone, or the suffix tier with or without them
int launch_vgrad_other(const WfParams& P, const VsParams& V,
                       const GradArgs& A, cudaStream_t stream) {
    if (!P.suffix) return launch_grad_vscan<0, true, false>(P, V, A, stream);
    return P.K == 0 ? launch_grad_vscan<0, false, true>(P, V, A, stream)
                    : launch_grad_vscan<0, true, true>(P, V, A, stream);
}
#endif

#if WF_IN_PART(3)
int launch_vgrad_planes_hard(const WfParams& P, const VsParams& V,
                             const GradArgs& A, cudaStream_t stream) {
    return launch_planes_vscan<true>(P, V, A, stream);
}

extern "C" int rt_vgrad_planes_hard_blocks(int smem, int* out) {
    return planes_vscan_blocks<true>(smem, out);
}
#endif

#if WF_IN_PART(6) || WF_IN_PART(7)
// ------------------------------------------------------ BVH walks (K11, K12)
// The forward (K2's carry included) and the tex_color grad tiers with the
// selection a BVH walk (SEL_STACK, K11; SEL_LANE, K12): the row planes
// (WpRows) for up to 32 rows, the suffix tier past them; no tangent bundles (hard slots on such a scene take the
// adjoint, on the chunk scan). A.vtab is the walk's buffer (BvParams).
template <int SEL>
__global__ void __launch_bounds__(WF_THREADS)
wavefront_forward_bvh_kernel(WfParams P, BvParams B, GradArgs A) {
    __shared__ float cam[22];
    wavefront_body<0, false, SEL>(P, A.tables, A.pix_lanes, A.carry_in,
                                  nullptr, A.rad_out, A.carry_out, nullptr,
                                  A.iters_out, wf_tables, cam, nullptr,
                                  VsParams(), A.vtab, B);
}

// the suffix tier (K8's) on a walk
template <int SEL>
__global__ void __launch_bounds__(WF_THREADS)
wavefront_grad_bvh_kernel(WfParams P, BvParams B, GradArgs A) {
    __shared__ float cam[22];
    wavefront_body<0, false, SEL, true>(
        P, A.tables, A.pix_lanes, A.carry_in, A.cot, A.rad_out, A.carry_out,
        A.dg_out, A.iters_out, wf_tables, cam, nullptr, VsParams(), A.vtab,
        B, nullptr, A.scr);
}

// the row planes (K3v's) on a walk, held to WP_BLOCKS blocks an SM as the
// chunk scan's instance is
template <int SEL>
__global__ void __launch_bounds__(WF_THREADS, WP_BLOCKS)
wavefront_planes_bvh_kernel(WfParams P, BvParams B, GradArgs A) {
    __shared__ float cam[22];
    __shared__ float red[(WF_THREADS / 32) * 3 * WP_TREE_ROWS];
    wavefront_body<0, false, SEL, false, true>(
        P, A.tables, A.pix_lanes, A.carry_in, A.cot, A.rad_out, A.carry_out,
        A.dg_out, A.iters_out, wf_tables, cam, red, VsParams(), A.vtab, B,
        nullptr, A.scr, A.multi);
}

// A.cot null: the forward; else the tex_color grad tier of P (dg_out as
// rt_wavefront_grad's, 3 * NT entries a block)
template <int SEL>
static int launch_bvh(const WfParams& P, const BvParams& B,
                      const GradArgs& A, cudaStream_t stream) {
    if (P.n_lanes % WF_THREADS != 0 || B.n_nodes < 1 || B.n_srows < 0
        || B.n_qrows < 0 || (SEL == SEL_LANE && B.n_qrows != 0) || P.K != 0
        || (A.cot && (!P.want_tex || P.NT < 1 || !A.scr
                      || (!P.suffix && P.NT > 32))))
        return (int)cudaErrorInvalidValue;
    if (!A.cot) {
        wavefront_forward_bvh_kernel<SEL>
            <<<P.n_lanes / WF_THREADS, WF_THREADS, 0, stream>>>(P, B, A);
        return (int)cudaGetLastError();
    }
    if (P.suffix)
        wavefront_grad_bvh_kernel<SEL>
            <<<P.n_lanes / WF_THREADS, WF_THREADS, 0, stream>>>(P, B, A);
    else
        wavefront_planes_bvh_kernel<SEL>
            <<<P.n_lanes / WF_THREADS, WF_THREADS, 0, stream>>>(P, B, A);
    return (int)cudaGetLastError();
}

// The walk's selection alone, one ray a thread, for the checks on the card
// (tests/test_torch_cuda.py): rays (n, 7) [o xyz, d xyz, time] in, the
// winner's original id (-1: miss) and its t (BIGF on a miss) out.
template <int SEL>
__global__ void __launch_bounds__(WF_THREADS)
bvh_select_probe_kernel(BvParams B, const float* __restrict__ btab,
                        const float* __restrict__ rays, int n,
                        int* __restrict__ best_out,
                        float* __restrict__ t_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float* r = rays + 7 * (size_t)i;
    const V3 o = v3(r[0], r[1], r[2]), d = v3(r[3], r[4], r[5]);
    float t;
    const int best = SEL == SEL_STACK
        ? closest_select_stack(B, btab, o, d, r[6], &t)
        : closest_select_lane(B, btab, o, d, r[6], &t);
    best_out[i] = best;
    t_out[i] = t;
}

#define WF_BVH_PROBE(name, SEL)                                              \
    extern "C" int name(const BvParams* bparams, const float* btab,         \
                        const float* rays, int n, int* best_out,            \
                        float* t_out, void* stream) {                       \
        if (n < 1) return (int)cudaErrorInvalidValue;                       \
        bvh_select_probe_kernel<SEL>                                        \
            <<<(n + WF_THREADS - 1) / WF_THREADS, WF_THREADS, 0,            \
               (cudaStream_t)stream>>>(*bparams, btab, rays, n, best_out,   \
                                       t_out);                              \
        return (int)cudaGetLastError();                                     \
    }

#define WF_BVH_ENTRY(name, SEL)                                              \
    extern "C" int name(const WfParams* params, const BvParams* bparams,    \
                        const float* tables, const float* btab,             \
                        const int* pix_lanes, const float* carry_in,        \
                        const float* cot, float* rad_out, float* carry_out, \
                        float* dg_out, int* iters_out, float* scr,          \
                        int* multi, void* stream) {                         \
        const GradArgs A = {tables, btab, pix_lanes, carry_in, cot,         \
                            rad_out, carry_out, dg_out, iters_out, scr,     \
                            multi};                                         \
        return launch_bvh<SEL>(*params, *bparams, A, (cudaStream_t)stream); \
    }
#endif  // WF_IN_PART(6) || WF_IN_PART(7)

#if WF_IN_PART(6)
WF_BVH_ENTRY(rt_wavefront_bvh_stack, SEL_STACK)
WF_BVH_PROBE(rt_bvh_select_stack, SEL_STACK)
#endif
#if WF_IN_PART(7)
WF_BVH_ENTRY(rt_wavefront_bvh_lane, SEL_LANE)
WF_BVH_PROBE(rt_bvh_select_lane, SEL_LANE)
#endif

#if WF_IN_PART(4) || WF_IN_PART(5)
// ------------------------------------------------------- adjoint (K9, K10)
// The adjoint (reverse-mode) backward, the JAX kernel's grad_adjoint
// (wavefront_pallas.py: adj_ctx 2693-2755, adj_record 2757-2840, adj_step
// 2842-2892, scatter_rows and apply_vjp 2894-2956; wrapper 3350-3357,
// 3532-3547, 3594-3626): the image and d<g, radiance sum>/d theta for every
// trainable family at once (tex_color, sphere centers and radii, metal
// fuzz, dielectric IOR), at a cost that does not grow with the number of
// parameters. It always runs on the chunk scan's selection
// (closest_select_vscan), Cornell-class scenes included, in one uncapped
// pass. Two sweeps, one bounce forward (adj_forward_bounce) and one bounce
// backward (adj_reverse_bounce) shared between them:
//   K9, the per-sample sweep (sample_body 3094-3209), part 4: per sample,
//   phase F traces the path and stores each bounce's record, phase R walks
//   the records backward;
//   K10, the segmented-regeneration sweep (adj_seg, 2958-3092), part 5:
//   the regenerating wavefront with a snapshot every SEG iterations, then
//   the segments last to first, each re-run from its snapshot storing its
//   records and reversed (see wavefront_adjoint_seg_kernel).
//
// Shape: one thread per lane, as every other instance. The forward bounce
//   is the forward kernel's arithmetic (so the image is the forward
//   kernel's, bounce for bounce) and stores, for each bounce, the ray state
//   it started from (o, d, th), the selection (winner, t) and the bounce's
//   discrete context (material row, eff row, flags, MIS weight): ADJ_STORE
//   floats a bounce in global scratch, [bounce][field][lane]. The reverse
//   walks the stored bounces backward with the state cotangent lam =
//   d<g, L>/d(o, d, th) of what follows (0 after a path's last bounce).
// Per bounce, (g, lam) . J, J the bounce's Jacobian (radiance increment,
//   o', d', th' over its inputs), by a hand-written reverse of the bounce
//   (physics_vjp): it re-runs the float bounce from the stored record with
//   physics<float>'s operations, so it takes the forward's branches, and
//   walks the bounce's stages backward from the cotangents (g, lam): the
//   throughput update, the scatter (metal fuzz; the dielectric's
//   reflection or refraction; the MIS weight, the light pdf over every
//   light and the light's cone or area sample, the ONB), the emission or
//   the sky, a marble texture's position gradient, the hit point and
//   normal, a medium's free flight, and the winner's root. The winner's t
//   gathers every use before it passes back through the root (autograd's
//   order, which the column design imitated with an extra pass along t: a
//   near-tangent root makes dt/dx huge, and taken whole in a column its
//   size runs through the rest of the bounce before cancelling). Each
//   stage's reverse follows the forward-mode rules' tie conventions,
//   torch's backward's, and reverses only the branch the forward took, so
//   no 0 * inf arises (the JAX adjoint's _sqrt0 trap, 190-197). Its table
//   cotangents go to the winner sphere's center and radius, the hit
//   material's fuzz (metal) or IOR (dielectric) and, at an MIS bounce, the
//   center and radius of each sphere a light row copies (rd_light aliases
//   the light's columns to that sphere's, as the JAX kernel's
//   adj_light_slots route them). tex_color enters a bounce as a factor
//   (emission th * c, attenuation th * c * factor), so its two products
//   are written out: g * th at an emission and lam_th * (th * factor) at a
//   non-dielectric scatter, to the hit's eff row (a marble leaf, eff -1,
//   takes none). The kernel first took (g, lam) . J by columns, one
//   physics<Dual> pass each (1 + 9 + 4 (+ 1) (+ 4 a light sphere) a
//   bounce), to keep no second copy of the physics; the reverse costs
//   about three float bounces, and chip_smoke.py's adjoint_bounce_probe
//   holds it against torch autograd of the bounce on every branch.
// Accumulators: 3 * NT tex_color, then 4 * S sphere (center xyz, radius),
//   then 2 * NM material (fuzz, IOR) doubles in the block's shared memory,
//   added to by double atomicAdd and flushed by atomicAdd into one global
//   double row at the block's end (or, past a block's shared memory, added
//   straight into it). A row sums every path's float contributions (13 M
//   paths at bouncing_spheres' 1200x675 spp16) into a few entries, where
//   float running sums would round off about 1e-4 of the largest; in double
//   only the order of the sums differs between runs, below float's last
//   bit.
// What bounds it: operations, as the other instances: the chunk scan once
//   per bounce (K10: twice, the re-run), one float bounce (K10: two) and
//   the reverse (a float bounce again and its reverse); and the shared
//   accumulators' double atomics, a compare-and-swap loop each (more than
//   half of K9's time at bouncing 1200x675 spp16 d50 on an NVIDIA H100
//   80GB HBM3 at 700 W, PERF.md; in the global row they take as long). The
//   scratch traffic (2 x 60 B a bounce; K10 adds 16 B of record and
//   52 B of snapshot a SEG bounces) is small beside them.
#define ADJ_STORE 15   // o xyz, d xyz, th xyz, winner, t, material, eff,
                       // flags, MIS weight
#define ADJ_HIT 1
#define ADJ_EMIT 2
#define ADJ_DIEL 4
#define ADJ_METAL 8
#define ADJ_MIS 16
#define ADJ_SCAT 32    // the bounce updated the throughput (alive_new)

// The pointers and sizes of one adjoint launch.
struct AdjArgs {
    const float* tables;
    const float* vtab;
    const float* cot;
    float* rad_out;
    double* acc_out;   // 3NT + 4S + 2NM doubles, zeroed by the caller
    float* store;      // K9: max_depth * ADJ_STORE * n_lanes floats; K10:
                       // seg * ADJ_REC * n_lanes
    int* iters_out;
    int NM;
    int shared_acc;    // the accumulators fit the block's shared memory
};

// ------------------------------------------ the bounce's reverse (K9, K10)
// Cotangent helpers. Each takes a forward operation's inputs, recomputes
// what it needs with physics<float>'s operations, and adds its inputs'
// cotangents from its output's. Each reverses only the branch the forward
// took, with the forward-mode rules' tie conventions, torch's backward's
// (smax / smin pass the cotangent where the argument is kept, ties
// included; sabs gives 0 at 0; the clamp in safe_sqrt passes where x >=
// 1e-12): a branch not taken contributes nothing, so no 0 * inf arises
// (the JAX adjoint's _sqrt0 trap, wavefront_pallas.py:190-197).

// v into the double accumulator entry i (exact zeros add nothing)
__device__ __forceinline__ void adj_add(double* acc, int i, float v) {
    if (v != 0.0f) atomicAdd(acc + i, (double)v);
}

__device__ __forceinline__ V3 axpy(V3 y, V3 x, float a) {
    return add(y, mul(x, a));
}

// r = a / smax(|a|, 1e-8) (normalize): a's cotangent from r's
__device__ __forceinline__ V3 normalize_vjp(V3 a, V3 rb) {
    const float l0 = sqrtf(dot(a, a));
    const float l = fmaxf(l0, 1e-8f);
    V3 ab = v3(rb.x / l, rb.y / l, rb.z / l);
    const float lb = -(rb.x * (a.x / l) + rb.y * (a.y / l)
                       + rb.z * (a.z / l)) / l;
    if (l0 >= 1e-8f) ab = axpy(ab, a, 2.0f * (lb / (2.0f * l0)));
    return ab;
}

// onb_from_w(w_in) -> (u, v, w): w_in's cotangent from u's, v's and w's
__device__ __forceinline__ V3 onb_from_w_vjp(V3 w_in, V3 ub, V3 vb,
                                             V3 wb) {
    const V3 w = normalize(w_in);
    const V3 aa = fabsf(w.x) > 0.9f ? v3(0.0f, 1.0f, 0.0f)
                                    : v3(1.0f, 0.0f, 0.0f);
    const V3 c0 = cross(w, aa);
    const V3 v = normalize(c0);
    // u = w x v
    wb = add(wb, cross(v, ub));
    vb = add(vb, cross(ub, w));
    // v = normalize(c0), c0 = w x aa
    wb = add(wb, cross(aa, normalize_vjp(c0, vb)));
    return normalize_vjp(w_in, wb);
}

// onb_local(u, v, w, a) = a.x u + a.y v + a.z w, a constant: the basis'
// cotangents
__device__ __forceinline__ void onb_local_vjp(V3 a, V3 rb, V3& ub, V3& vb,
                                              V3& wb) {
    ub = mul(rb, a.x);
    vb = mul(rb, a.y);
    wb = mul(rb, a.z);
}

// The root t = (h - sq) / a (r1 false) or (h + sq) / a (r1) of the sphere
// (c, rad) along (o, d): h = d . (c - o), a = d . d, sq = safe_sqrt(h h -
// a (|c - o|^2 - rad^2)). Adds tb's share to the cotangents of c, rad, o,
// d. The reverse runs in double on the forward's float values: its terms
// nearly cancel where the root does (h and sq agree to 1e-4 on the
// radius-1000 ground; on a grazing root, far from a small sphere, the
// origin's and the direction's terms), and float rounding of each term
// would come out magnified by that agreement (the float32 references part
// from each other by such rounding alone: chip_smoke.py, ADJ_MAIN_RTOL).
__device__ __forceinline__ void root_vjp(V3 c, float rad, V3 o, V3 d,
                                         bool r1, float tb, V3& cb,
                                         float& radb, V3& ob, V3& db) {
    const V3 oc = sub(c, o);
    const float a = dot(d, d), h = dot(d, oc);
    const float cc = dot(oc, oc) - rad * rad;
    const float disc = h * h - a * cc;
    const float sq = sqrtf(fmaxf(disc, 1e-12f));
    const float num = r1 ? h + sq : h - sq;
    const double A = a, H = h, CC = cc, TB = tb;
    const double nb = TB / A;
    double ab = -TB * ((double)num / A) / A;
    double hb = nb;
    const double discb = disc >= 1e-12f
        ? (r1 ? nb : -nb) / (2.0 * (double)sq) : 0.0;
    hb += 2.0 * H * discb;
    ab -= CC * discb;
    const double ccb = -A * discb;
    const double ocx = oc.x, ocy = oc.y, ocz = oc.z;
    const double dx = d.x, dy = d.y, dz = d.z;
    const double gx = 2.0 * ocx * ccb + dx * hb;
    const double gy = 2.0 * ocy * ccb + dy * hb;
    const double gz = 2.0 * ocz * ccb + dz * hb;
    radb += (float)(-2.0 * (double)rad * ccb);
    db = add(db, v3((float)(ocx * hb + 2.0 * dx * ab),
                    (float)(ocy * hb + 2.0 * dy * ab),
                    (float)(ocz * hb + 2.0 * dz * ab)));
    cb = add(cb, v3((float)gx, (float)gy, (float)gz));
    ob = sub(ob, v3((float)gx, (float)gy, (float)gz));
}

// a quad's plane t = (q[12] - o . N) / (d . N) (q: corner, u, v, normal,
// d, w): tb back to o and d
__device__ __forceinline__ void quad_t_vjp(const float* q, V3 o, V3 d,
                                           float tb, V3& ob, V3& db) {
    const V3 nn = v3(q[9], q[10], q[11]);
    const float denom = dot(d, nn);
    const float t = (q[12] - dot(o, nn)) / denom;
    ob = axpy(ob, nn, -(tb / denom));
    db = axpy(db, nn, -(tb * t) / denom);
}

// noise3's value, and its gradient in p (the fractional position's; the
// lattice takes none) in *g
static __device__ float noise3_grad(float px, float py, float pz, uint32_t seed,
                             V3* g) {
    const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
    const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
    const float u = px - fx, v = py - fy, w = pz - fz;
    const float su = u * u * (3.0f - 2.0f * u);
    const float sv = v * v * (3.0f - 2.0f * v);
    const float sw = w * w * (3.0f - 2.0f * w);
    // d su / du = 2u (3 - 2u) - 2 u^2
    const float du = 2.0f * u * (3.0f - 2.0f * u) - 2.0f * (u * u);
    const float dv = 2.0f * v * (3.0f - 2.0f * v) - 2.0f * (v * v);
    const float dw = 2.0f * w * (3.0f - 2.0f * w) - 2.0f * (w * w);
    float acc = 0.0f, gx_ = 0.0f, gy_ = 0.0f, gz_ = 0.0f;
    for (int di = 0; di < 2; ++di) {
        const float wu = di ? su : 1.0f - su, wu1 = di ? du : -du;
        for (int dj = 0; dj < 2; ++dj) {
            const float wv = dj ? sv : 1.0f - sv, wv1 = dj ? dv : -dv;
            for (int dk = 0; dk < 2; ++dk) {
                const float ww = dk ? sw : 1.0f - sw, ww1 = dk ? dw : -dw;
                uint32_t a = (uint32_t)(ix + di), b = (uint32_t)(iy + dj),
                         c = (uint32_t)(iz + dk), d = seed;
                pcg4d(a, b, c, d);
                float gx = 2.0f * to_unit(a) - 1.0f;
                float gy = 2.0f * to_unit(b) - 1.0f;
                float gz = 2.0f * to_unit(c) - 1.0f;
                const float inv = rsqrtf(fmaxf(gx * gx + gy * gy + gz * gz,
                                               1e-12f));
                gx *= inv; gy *= inv; gz *= inv;
                const float dd = gx * (u - (float)di) + gy * (v - (float)dj)
                    + gz * (w - (float)dk);
                const float wt = wu * wv * ww;
                acc = acc + wt * dd;
                gx_ += wu1 * wv * ww * dd + wt * gx;
                gy_ += wu * wv1 * ww * dd + wt * gy;
                gz_ += wu * wv * ww1 * dd + wt * gz;
            }
        }
    }
    *g = v3(gx_, gy_, gz_);
    return acc;
}

// texture_value's position cotangent at a marble leaf (the checkers above
// it are piecewise constant): 0.5 (1 + sin(scale p.z + 10 turbulence(p)))
// in every channel, tcb the color's cotangent
static __device__ V3 texture_vjp(const Scene& sc, int row, V3 p, V3 tcb) {
    for (int lvl = 0; lvl < sc.checker_depth; ++lvl) {
        const float* t = sc.tex + row * TEX_COLS;
        if (t[4] > 0.5f) {
            float inv = 1.0f / fmaxf(t[3], 1e-12f);
            int fx = (int)floorf(inv * p.x);
            int fy = (int)floorf(inv * p.y);
            int fz = (int)floorf(inv * p.z);
            bool even = ((fx + fy + fz) & 1) == 0;
            row = (int)(even ? t[11] : t[12]);
        }
    }
    const float scale = sc.tex[row * TEX_COLS + 3];
    const float turb = turbulence3(p.x, p.y, p.z, sc.perlin_seed);
    const float argb = 0.5f * cosf(scale * p.z + 10.0f * turb)
        * (tcb.x + tcb.y + tcb.z);
    V3 pb = v3(0.0f, 0.0f, scale * argb);
    // turbulence: sum_o 0.5^o |noise3(2^o p)|
    const float turbb = 10.0f * argb;
    float px = p.x, py = p.y, pz = p.z, weight = 1.0f, s = 1.0f;
    for (int o = 0; o < 7; ++o) {
        V3 g;
        const float n = noise3_grad(px, py, pz,
                                    sc.perlin_seed + (uint32_t)o * 0x9E3779B9u,
                                    &g);
        const float nb = weight * (n > 0.0f ? turbb
                                            : (n < 0.0f ? -turbb : 0.0f));
        pb = axpy(pb, g, nb * s);
        weight *= 0.5f;
        s *= 2.0f;
        px = px * 2.0f; py = py * 2.0f; pz = pz * 2.0f;
    }
    return pb;
}

// medium_free_flight<float>'s scattering t back to o and d (tb its
// cotangent): t = smax(entry, T_MIN) + hit_dist / |d| of the medium that
// won, entry the first of its boundary crossings (a sphere's root or a
// quad's plane t, first_min's order); the span's end t_surf only decides
// whether it scatters
static __device__ void medium_vjp(const Scene& sc, V3 o, V3 d, float t_surf,
                           const float* u_med, float tb, V3& ob, V3& db) {
    const float a = dot(d, d);
    const float raylen = sqrtf(a);
    float t_best = BIGF, b_entry = 0.0f, b_hd = 0.0f;
    int b_m = -1, b_id = -1;
    for (int m = 0; m < sc.M; ++m) {
        const float* r = sc.med + m * sc.med_cols;
        // pass 1: entry = nearest crossing of the boundary union; id: 2js
        // (+1 the far root) of a sphere, 2MS + jq of a quad
        float entry = BIGF, exit_ = BIGF;
        int id = -1;
        for (int pass = 0; pass < 2; ++pass) {
            for (int js = 0; js < sc.MS; ++js) {
                const float* s = r + 2 + 4 * js;
                float rad = s[3];
                V3 oc = sub(ld3(s), o);
                float h = dot(d, oc);
                float cc = dot(oc, oc) - rad * rad;
                float disc = h * h - a * cc;
                bool ok = disc > 0.0f && rad > 0.0f;
                float sq = safe_sqrt(disc);
                float t0 = ok ? (h - sq) / a : BIGF;
                float t1 = ok ? (h + sq) / a : BIGF;
                if (pass == 0) {
                    const bool far = t1 < t0;
                    const float tn = far ? t1 : t0;
                    if (tn < entry) {
                        entry = tn;
                        id = 2 * js + (far ? 1 : 0);
                    }
                } else {
                    if (t0 > entry + 1e-4f) exit_ = first_min(exit_, t0);
                    if (t1 > entry + 1e-4f) exit_ = first_min(exit_, t1);
                }
            }
            for (int jq = 0; jq < sc.MQ; ++jq) {
                const float* q = r + 2 + 4 * sc.MS + 17 * jq;
                float t = BIGF;
                if (q[16] > 0.5f) {
                    float tq;
                    if (quad_hit(q, o, d, -BIGF, &tq)) t = tq;
                }
                if (pass == 0) {
                    if (t < entry) {
                        entry = t;
                        id = 2 * sc.MS + jq;
                    }
                } else if (t > entry + 1e-4f) {
                    exit_ = first_min(exit_, t);
                }
            }
            if (pass == 1) {
                bool crossed = entry < BIGF * 0.5f && exit_ < BIGF * 0.5f;
                float t1 = fmaxf(entry, T_MINF);
                float t2 = fminf(exit_, t_surf);
                bool span_ok = crossed && (t1 < t2) && r[1] > 0.5f;
                if (!span_ok) break;
                float dist_inside = (t2 - t1) * raylen;
                float hit_dist = r[0] * logf(fmaxf(u_med[m], 1e-12f));
                if (hit_dist < dist_inside) {
                    float t_med = t1 + hit_dist / raylen;
                    if (t_med < t_best) {
                        t_best = t_med;
                        b_m = m;
                        b_entry = entry;
                        b_id = id;
                        b_hd = hit_dist;
                    }
                }
            }
        }
    }
    if (b_m < 0) return;
    // t = t1 + hit_dist / raylen, t1 = smax(entry, T_MIN), raylen = |d|
    const float rlb = -(tb * (b_hd / raylen)) / raylen;
    db = axpy(db, d, 2.0f * (rlb / (2.0f * raylen)));
    const float eb = b_entry >= T_MINF ? tb : 0.0f;
    const float* r = sc.med + b_m * sc.med_cols;
    if (b_id < 2 * sc.MS) {
        const float* s = r + 2 + 4 * (b_id >> 1);
        V3 cb = v3(0.0f, 0.0f, 0.0f);
        float radb = 0.0f;
        root_vjp(ld3(s), s[3], o, d, (b_id & 1) != 0, eb, cb, radb, ob, db);
    } else {
        quad_t_vjp(r + 2 + 4 * sc.MS + 17 * (b_id - 2 * sc.MS), o, d, eb,
                   ob, db);
    }
}

// light_pdf<float>(o, d)'s cotangent totb back to o and d, and each sphere
// light's center and radius cotangents into its source sphere's rows (the
// light rows copy that sphere, rd_light)
static __device__ void light_pdf_vjp(const Scene& sc, V3 o, V3 d, float tm,
                              float totb, V3& ob, V3& db, double* acc,
                              int t_base) {
    const float pb = totb / (float)(sc.L > 1 ? sc.L : 1);
    for (int l = 0; l < sc.L; ++l) {
        const float* r = sc.light + l * LIGHT_COLS;
        if (r[0] > 0.5f) {
            const float rad = r[7];
            const V3 c = v3(r[1] + tm * r[4], r[2] + tm * r[5],
                            r[3] + tm * r[6]);
            const V3 oc = sub(c, o);
            const float a = dot(d, d), h = dot(d, oc), dist2 = dot(oc, oc);
            const float disc = h * h - a * (dist2 - rad * rad);
            const float sq = safe_sqrt(disc);
            const float r0 = (h - sq) / a, r1 = (h + sq) / a;
            const bool hit = disc > 0.0f && rad > 0.0f
                && ((r0 > T_MINF && r0 < BIGF) || (r1 > T_MINF && r1 < BIGF));
            if (!hit) continue;
            // pdf = 1 / smax(2 pi (1 - safe_sqrt(ratio)), 1e-12), ratio =
            // smin(smax(1 - rad^2 / smax(dist2, 1e-12), 0), 1)
            const float dm = fmaxf(dist2, 1e-12f);
            const float w = 1.0f - rad * rad / dm;
            const float ratio = fminf(fmaxf(w, 0.0f), 1.0f);
            const float sr = sqrtf(fmaxf(ratio, 1e-12f));
            const float solid = TWO_PI_F * (1.0f - sr);
            const float sm = fmaxf(solid, 1e-12f);
            const float pdf = 1.0f / sm;
            const float solidb = solid >= 1e-12f ? -(pb * pdf) / sm : 0.0f;
            const float srb = -TWO_PI_F * solidb;
            const float ratiob = ratio >= 1e-12f ? srb / (2.0f * sr) : 0.0f;
            const float wb = (w >= 0.0f && fmaxf(w, 0.0f) <= 1.0f)
                ? ratiob : 0.0f;
            const float rrb = -wb / dm;
            const float dmb = wb * (rad * rad / dm) / dm;
            const float d2b = dist2 >= 1e-12f ? dmb : 0.0f;
            const V3 ocb = mul(oc, 2.0f * d2b);
            ob = sub(ob, ocb);
            const int src = (int)sc.lsrc[l];
            if (src >= 0) {
                adj_add(acc, t_base + 4 * src + 0, ocb.x);
                adj_add(acc, t_base + 4 * src + 1, ocb.y);
                adj_add(acc, t_base + 4 * src + 2, ocb.z);
                adj_add(acc, t_base + 4 * src + 3, 2.0f * rad * rrb);
            }
        } else {
            float t;
            if (quad_hit(r + 8, o, d, T_MINF, &t) && t < BIGF * 0.5f) {
                // pdf = t^2 / smax(|d . N| area, 1e-12)
                const V3 nn = v3(r[17], r[18], r[19]);
                const float craw = dot(d, nn);
                const float cosine = fabsf(craw);
                const float den = fmaxf(cosine * r[24], 1e-12f);
                const float pdf = t * t / den;
                const float numb = pb / den;
                const float denb = -(pb * pdf) / den;
                const float cb = cosine * r[24] >= 1e-12f ? denb * r[24]
                                                          : 0.0f;
                const float crb = craw > 0.0f ? cb
                                              : (craw < 0.0f ? -cb : 0.0f);
                db = axpy(db, nn, crb);
                quad_t_vjp(r + 8, o, d, 2.0f * t * numb, ob, db);
            }
        }
    }
}

// light_sample<float>(o)'s direction cotangent outb back to o, and the
// picked sphere light's center and radius cotangents into its source
// sphere's rows
static __device__ void light_sample_vjp(const Scene& sc, V3 o, float tm,
                                 float u_sel, float u1, float u2, V3 outb,
                                 V3& ob, double* acc, int t_base) {
    int n = sc.L > 1 ? sc.L : 1;
    int l = (int)(u_sel * (float)n);
    l = l < 0 ? 0 : (l > n - 1 ? n - 1 : l);
    const float* r = sc.light + l * LIGHT_COLS;
    if (r[0] > 0.5f) {
        const V3 c = v3(r[1] + tm * r[4], r[2] + tm * r[5], r[3] + tm * r[6]);
        const V3 to_c = sub(c, o);
        const float dd2 = dot(to_c, to_c);
        const float dist2 = fmaxf(dd2, 1e-12f);
        const float rad = r[7];
        const float w = 1.0f - rad * rad / dist2;
        const float ratio = fminf(fmaxf(w, 0.0f), 1.0f);
        const float sr = sqrtf(fmaxf(ratio, 1e-12f));
        const float z = 1.0f + u2 * (sr - 1.0f);
        const float phi = TWO_PI_F * u1;
        const float y = 1.0f - z * z;
        const float s = sqrtf(fmaxf(y, 1e-12f));
        V3 bu, bv, bw;
        onb_from_w(to_c, bu, bv, bw);
        const V3 loc = v3(cosf(phi) * s, sinf(phi) * s, z);
        const V3 dirb = normalize_vjp(onb_local(bu, bv, bw, loc), outb);
        V3 ub, vb, wb;
        onb_local_vjp(loc, dirb, ub, vb, wb);
        const float sb = cosf(phi) * dot(dirb, bu) + sinf(phi) * dot(dirb, bv);
        float zb = dot(dirb, bw);
        const float yb = y >= 1e-12f ? sb / (2.0f * s) : 0.0f;
        zb -= 2.0f * z * yb;
        const float srb = u2 * zb;
        const float ratiob = ratio >= 1e-12f ? srb / (2.0f * sr) : 0.0f;
        const float wb2 = (w >= 0.0f && fmaxf(w, 0.0f) <= 1.0f) ? ratiob
                                                                 : 0.0f;
        const float rrb = -wb2 / dist2;
        const float d2b = wb2 * (rad * rad / dist2) / dist2;
        const float dd2b = dd2 >= 1e-12f ? d2b : 0.0f;
        const V3 tcb = add(mul(to_c, 2.0f * dd2b),
                           onb_from_w_vjp(to_c, ub, vb, wb));
        ob = sub(ob, tcb);
        const int src = (int)sc.lsrc[l];
        if (src >= 0) {
            adj_add(acc, t_base + 4 * src + 0, tcb.x);
            adj_add(acc, t_base + 4 * src + 1, tcb.y);
            adj_add(acc, t_base + 4 * src + 2, tcb.z);
            adj_add(acc, t_base + 4 * src + 3, 2.0f * rad * rrb);
        }
    } else {
        const V3 pt = v3(r[8] + u1 * r[11] + u2 * r[14],
                         r[9] + u1 * r[12] + u2 * r[15],
                         r[10] + u1 * r[13] + u2 * r[16]);
        ob = sub(ob, normalize_vjp(sub(pt, o), outb));
    }
}

// v - n (2 v . n), the mirror direction before normalize: v's and n's
// cotangents from its own
__device__ __forceinline__ void reflect_vjp(V3 v, V3 n, V3 rb, V3& vb,
                                            V3& nb) {
    const float s2 = 2.0f * dot(v, n);
    vb = add(vb, rb);
    nb = axpy(nb, rb, -s2);
    const float db2 = 2.0f * -dot(rb, n);
    vb = axpy(vb, n, db2);
    nb = axpy(nb, v, db2);
}

// The hand-written reverse of physics<float, 0> (K9, K10): the bounce from
// (o, d, th) with the stored selection (winner best at best_t), the draws
// u and u_med, whether it went on (scat) and its throughput factor. It
// re-runs the float bounce's operations, so it takes the forward's
// branches, and walks the bounce backward from the cotangents (gc of the
// radiance increment; lam of o', d', th'): the throughput update, the
// scatter (metal fuzz, the dielectric's reflection or refraction, the MIS
// direction with its light sample, light pdf and weight), the emission or
// the sky, a marble texture's position gradient, the hit point and normal,
// a medium's free flight, and the winner's root. The winner's t gathers
// every use before it passes back through the root (autograd's order). The
// table cotangents go into acc: the winner sphere's and every read light's
// source sphere's center and radius at t_base + 4 row, the hit material's
// fuzz or IOR at m_base + 2 row (tex_color is the caller's). lam becomes
// the cotangent of (o, d, th).
static __device__ void physics_vjp(
        const Scene& sc, const WfParams& P, const float* cam, int best,
        float best_t, V3 o, V3 d, V3 th, float tm, const float* u,
        const float* u_med, const float (&gc)[3], bool scat, float factor,
        float (&lam)[9], double* acc, int t_base, int m_base) {
    const V3 zero = v3(0.0f, 0.0f, 0.0f);
    const V3 lo = v3(lam[0], lam[1], lam[2]);
    const V3 ld = v3(lam[3], lam[4], lam[5]);
    const V3 lt = v3(lam[6], lam[7], lam[8]);
    // a path that ends here keeps its state: it passes through
    V3 ob = scat ? zero : lo, db = scat ? zero : ld, thb = scat ? zero : lt;
    // ---- forward: the hit record, and a medium's preemption
    HitT<float> h = hit_record(sc, best, best_t, o, d, tm, Seeds<0>{});
    const float t_surf = h.hit ? h.t : BIGF;
    bool med = false;
    if (sc.M > 0) {
        int mrow;
        const float t_med = medium_free_flight(sc, o, d, t_surf, u_med,
                                               &mrow);
        if (t_med < BIGF * 0.5f) {
            med = true;
            h.hit = true;
            h.t = t_med;
            h.p = add(o, mul(d, t_med));
            h.n = v3(1.0f, 0.0f, 0.0f);
            h.front = true;
            h.mat = (int)sc.med[mrow * sc.med_cols + sc.med_cols - 1];
        }
    }
    const float gv[3] = {gc[0], gc[1], gc[2]};
    if (!h.hit) {
        // rad += th * sky
        float sky[3] = {cam[19], cam[20], cam[21]};
        const float k[3] = {0.5f, 0.7f, 1.0f};
        float asb = 0.0f;
        const float as = 0.5f * (d.y + 1.0f);
        const float tv[3] = {th.x, th.y, th.z};
        for (int c = 0; c < 3; ++c) {
            if (P.sky_gradient) {
                sky[c] = (1.0f - as) + as * k[c];
                asb += gv[c] * tv[c] * (k[c] - 1.0f);
            }
        }
        thb = add(thb, v3(gv[0] * sky[0], gv[1] * sky[1], gv[2] * sky[2]));
        if (P.sky_gradient) db.y += 0.5f * asb;
        lam[0] = ob.x; lam[1] = ob.y; lam[2] = ob.z;
        lam[3] = db.x; lam[4] = db.y; lam[5] = db.z;
        lam[6] = thb.x; lam[7] = thb.y; lam[8] = thb.z;
        return;
    }
    const int mtype = (int)sc.mati[h.mat * 2 + 0];
    const int mtex = (int)sc.mati[h.mat * 2 + 1];
    int eff;
    const V3 tc = texture_value(sc, mtex, h.p, &eff);
    const bool is_light = mtype == MAT_DIFFUSE_LIGHT;
    const bool is_metal = mtype == MAT_METAL;
    const bool is_diel = mtype == MAT_DIELECTRIC;
    const bool is_iso = mtype == MAT_ISOTROPIC;
    const V3 n = h.n, p = h.p;
    V3 tcb = zero, pb = zero, nb = zero;
    if (is_light && h.front) {
        // rad += th * tc
        thb = add(thb, v3(gv[0] * tc.x, gv[1] * tc.y, gv[2] * tc.z));
        tcb = v3(gv[0] * th.x, gv[1] * th.y, gv[2] * th.z);
    }
    if (!is_light && scat) {
        // th' = (th * at) * factor, o' = p, d' = the new direction
        const V3 at = is_diel ? v3(1.0f, 1.0f, 1.0f) : tc;
        const V3 tab = mul(lt, factor);
        thb = add(thb, v3(tab.x * at.x, tab.y * at.y, tab.z * at.z));
        if (!is_diel)
            tcb = add(tcb, v3(tab.x * th.x, tab.y * th.y, tab.z * th.z));
        const float factorb = lt.x * (th.x * at.x) + lt.y * (th.y * at.y)
            + lt.z * (th.z * at.z);
        pb = add(pb, lo);
        const V3 ndb = ld;
        if (is_metal) {
            // normalize(normalize(reflect) + jit fuzz)
            const float fuzz = sc.matf[h.mat * 2 + 0];
            const float s2 = 2.0f * dot(d, n);
            const V3 r0v = sub(d, mul(n, s2));
            const V3 jit = unit_vector_from_uv(u[D_FUZZ_U], u[D_FUZZ_V]);
            const V3 m0 = add(normalize(r0v), mul(jit, fuzz));
            const V3 m0b = normalize_vjp(m0, ndb);
            adj_add(acc, m_base + 2 * h.mat + 0, dot(jit, m0b));
            reflect_vjp(d, n, normalize_vjp(r0v, m0b), db, nb);
        } else if (is_diel) {
            const float ior = sc.matf[h.mat * 2 + 1];
            const float ri = h.front ? 1.0f / ior : ior;
            const float x = dot(neg(d), n);
            const float cos_t = fminf(x, 1.0f);
            const float sin_t = safe_sqrt(1.0f - cos_t * cos_t);
            const bool cannot = ri * sin_t > 1.0f;
            float r0 = (1.0f - ri) / (1.0f + ri);
            r0 = r0 * r0;
            const float schlick = r0 + (1.0f - r0) * spow5(1.0f - cos_t);
            if (cannot || schlick > u[D_REFL]) {
                const V3 r0v = sub(d, mul(n, 2.0f * dot(d, n)));
                reflect_vjp(d, n, normalize_vjp(r0v, ndb), db, nb);
            } else {
                // perp = (d + n cos_t) ri; par = -safe_sqrt(|1 - perp .
                // perp|); normalize(perp + n par)
                const V3 e = add(d, mul(n, cos_t));
                const V3 perp = mul(e, ri);
                const float z = 1.0f - dot(perp, perp);
                const float y = fabsf(z);
                const float ss = sqrtf(fmaxf(y, 1e-12f));
                const float par = -ss;
                const V3 mb = normalize_vjp(add(perp, mul(n, par)), ndb);
                nb = axpy(nb, mb, par);
                const float yb = y >= 1e-12f ? -dot(mb, n) / (2.0f * ss)
                                             : 0.0f;
                const float zb = z > 0.0f ? yb : (z < 0.0f ? -yb : 0.0f);
                const V3 perpb = axpy(mb, perp, -2.0f * zb);
                const V3 eb = mul(perpb, ri);
                const float rib = dot(perpb, e);
                db = add(db, eb);
                nb = axpy(nb, eb, cos_t);
                const float xb = x <= 1.0f ? dot(eb, n) : 0.0f;
                db = axpy(db, n, -xb);
                nb = axpy(nb, neg(d), xb);
                adj_add(acc, m_base + 2 * h.mat + 1,
                        h.front ? -(rib * (1.0f / ior)) / ior : rib);
            }
        } else {
            // MIS: the material's direction (or a light's, half the time),
            // factor = spdf / (0.5 light pdf + 0.5 material pdf)
            V3 bu, bv, bw, mloc = zero, mdir;
            if (is_iso) {
                mdir = unit_vector_from_uv(u[D_MAT_U], u[D_MAT_V]);
            } else {
                onb_from_w(n, bu, bv, bw);
                float phm = TWO_PI_F * u[D_MAT_U];
                float sq2 = sqrtf(fmaxf(u[D_MAT_V], 1e-12f));
                float zc = sqrtf(fmaxf(1.0f - u[D_MAT_V], 1e-12f));
                mloc = v3(cosf(phm) * sq2, sinf(phm) * sq2, zc);
                mdir = normalize(onb_local(bu, bv, bw, mloc));
            }
            const bool picked = sc.L > 0 && u[D_PICK] < 0.5f;
            const V3 gdir = picked
                ? light_sample(sc, p, tm, u[D_LIGHT_SEL], u[D_LIGHT_U],
                               u[D_LIGHT_V], Seeds<0>{})
                : mdir;
            const float cr = dot(gdir, n);
            const float cosv = fmaxf(cr, 0.0f) / PI_F;
            float pdf_val;
            if (sc.L > 0) {
                const float mpdf = is_iso ? INV_4PI_F : cosv;
                pdf_val = 0.5f * light_pdf(sc, p, gdir, tm, Seeds<0>{})
                    + 0.5f * mpdf;
            } else {
                pdf_val = is_iso ? INV_4PI_F : cosv;
            }
            const float spdf = is_iso ? INV_4PI_F : cosv;
            const float fq = spdf / pdf_val;
            const float spdfb = factorb / pdf_val;
            const float pdfb = -(factorb * fq) / pdf_val;
            float cosvb = is_iso ? 0.0f : spdfb, lpb = 0.0f;
            if (sc.L > 0) {
                lpb = 0.5f * pdfb;
                if (!is_iso) cosvb += 0.5f * pdfb;
            } else if (!is_iso) {
                cosvb += pdfb;
            }
            V3 gdb = ndb;
            const float crb = cr >= 0.0f ? cosvb / PI_F : 0.0f;
            gdb = axpy(gdb, n, crb);
            nb = axpy(nb, gdir, crb);
            if (sc.L > 0)
                light_pdf_vjp(sc, p, gdir, tm, lpb, pb, gdb, acc, t_base);
            if (picked) {
                light_sample_vjp(sc, p, tm, u[D_LIGHT_SEL], u[D_LIGHT_U],
                                 u[D_LIGHT_V], gdb, pb, acc, t_base);
            } else if (!is_iso) {
                const V3 dirb = normalize_vjp(onb_local(bu, bv, bw, mloc),
                                              gdb);
                V3 ub, vb, wb;
                onb_local_vjp(mloc, dirb, ub, vb, wb);
                nb = add(nb, onb_from_w_vjp(n, ub, vb, wb));
            }
        }
    }
    // ---- a marble leaf's position gradient (checkers are piecewise
    // constant, a solid color has none)
    if (eff < 0 && (tcb.x != 0.0f || tcb.y != 0.0f || tcb.z != 0.0f))
        pb = add(pb, texture_vjp(sc, mtex, p, tcb));
    // ---- the hit point and normal back to o, d, the winner's t and its
    // geometry
    if (med) {
        // p = o + d t_med; the normal is constant
        ob = add(ob, pb);
        db = axpy(db, pb, h.t);
        medium_vjp(sc, o, d, t_surf, u_med, dot(pb, d), ob, db);
    } else if (best < sc.S) {
        // p = o + d t; n = +-(p - c) / smax(rad, 1e-12)
        const float* r = sc.sph + best * SPH_COLS;
        const V3 c = v3(r[0] + tm * r[3], r[1] + tm * r[4], r[2] + tm * r[5]);
        const float rad = r[6];
        const float rr = fmaxf(rad, 1e-12f);
        const V3 out = v3((p.x - c.x) / rr, (p.y - c.y) / rr,
                          (p.z - c.z) / rr);
        const V3 outb = h.front ? nb : neg(nb);
        pb = axpy(pb, outb, 1.0f / rr);
        V3 cb = mul(outb, -1.0f / rr);
        const float rrb = -(outb.x * out.x / rr + outb.y * out.y / rr
                            + outb.z * out.z / rr);
        float radb = rad >= 1e-12f ? rrb : 0.0f;
        ob = add(ob, pb);
        db = axpy(db, pb, best_t);
        // the root sphere_root took: the near one where it lies in range
        const V3 oc = sub(c, o);
        const float a = dot(d, d), hh = dot(d, oc);
        const float disc = hh * hh - a * (dot(oc, oc) - rad * rad);
        const float r0 = (hh - safe_sqrt(disc)) / a;
        const bool far = !(r0 > T_MINF && r0 < BIGF);
        root_vjp(c, rad, o, d, far, dot(pb, d), cb, radb, ob, db);
        adj_add(acc, t_base + 4 * best + 0, cb.x);
        adj_add(acc, t_base + 4 * best + 1, cb.y);
        adj_add(acc, t_base + 4 * best + 2, cb.z);
        adj_add(acc, t_base + 4 * best + 3, radb);
    } else {
        // p = o + d t, t the quad's plane t; the normal is constant
        ob = add(ob, pb);
        db = axpy(db, pb, best_t);
        quad_t_vjp(sc.quad + (best - sc.S) * QUAD_COLS, o, d, dot(pb, d),
                   ob, db);
    }
    lam[0] = ob.x; lam[1] = ob.y; lam[2] = ob.z;
    lam[3] = db.x; lam[4] = db.y; lam[5] = db.z;
    lam[6] = thb.x; lam[7] = thb.y; lam[8] = thb.z;
}

// A block's start: the chunk scan's boxes into shared memory, the shared
// accumulators zeroed, the camera row; returns the accumulator row the
// block adds into (shared, or the global row past a block's shared memory)
static __device__ __forceinline__ double* adj_block_start(
        const VsParams& V, const AdjArgs& A, int n_acc, const WfParams& P,
        float* cam) {
    double* acc_s = reinterpret_cast<double*>(wf_tables
                                              + table_pad(V.n_box));
    for (int i = threadIdx.x; i < V.n_box; i += blockDim.x)
        wf_tables[i] = A.vtab[V.off_box + i];
    if (A.shared_acc) {
        for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc_s[i] = 0.0;
    }
    if (threadIdx.x < 22) cam[threadIdx.x] = P.cam[threadIdx.x];
    __syncthreads();
    return A.shared_acc ? acc_s : A.acc_out;
}

// A block's end: the shared accumulators added into the global row
static __device__ __forceinline__ void adj_block_flush(const AdjArgs& A,
                                                       const double* acc,
                                                       int n_acc) {
    if (A.shared_acc) {
        __syncthreads();
        for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
            const double v = acc[i];
            if (v != 0.0) atomicAdd(A.acc_out + i, v);
        }
    }
}

static __device__ __forceinline__ Scene adj_scene(const WfParams& P,
                                                  const float* tab) {
    Scene sc;
    sc.sph = tab + P.off_sph;
    sc.quad = tab + P.off_quad;
    sc.pmat = tab + P.off_pmat;
    sc.light = tab + P.off_light;
    sc.mati = tab + P.off_mati;
    sc.matf = tab + P.off_matf;
    sc.tex = tab + P.off_tex;
    sc.med = tab + P.off_med;
    sc.lsrc = tab + P.off_lsrc;
    sc.slot = tab + P.off_slot;
    sc.S = P.S; sc.Q = P.Q; sc.L = P.L; sc.M = P.M; sc.MS = P.MS;
    sc.MQ = P.MQ; sc.med_cols = P.med_cols;
    sc.checker_depth = P.checker_depth; sc.has_noise = P.has_noise;
    sc.perlin_seed = P.perlin_seed;
    return sc;
}

// One bounce forward (K9's phase F, K10's sweeps): bounce b of sample k1's
// path from (o, d, th) at ray time tm, the draws, the chunk scan's
// selection and the float bounce (physics<float>: rad gets the radiance
// increment, o, d, th the next ray state); with STORE its record, the
// first ADJ_STORE fields at st (stride N). Returns whether the path goes on
// (the bounce updated the throughput).
template <bool STORE>
static __device__ __forceinline__ bool adj_forward_bounce(
        const Scene& sc, const WfParams& P, const VsParams& V,
        const float* vtab, const float* cam, uint32_t k0, uint32_t k1,
        uint32_t k2, int b, V3& o, V3& d, V3& th, V3& rad, float tm,
        const float (&gc)[3], float* st, int N) {
    float u[9], u_med[4];
    draws(k0, k1, k2, 0x4000000u + (uint32_t)b, u, 9);
    if (sc.M > 0) draws(k0, k1, k2, 1000000u + (uint32_t)b, u_med, sc.M);
    float best_t;
    const int best = closest_select_vscan(sc, V, vtab, wf_tables, o, d, tm,
                                          &best_t);
    if (STORE) {
        st[0 * N] = o.x; st[1 * N] = o.y; st[2 * N] = o.z;
        st[3 * N] = d.x; st[4 * N] = d.y; st[5 * N] = d.z;
        st[6 * N] = th.x; st[7 * N] = th.y; st[8 * N] = th.z;
    }
    SfxEv ev;
    ev.hit = false;
    float nw[1], ng[1];
    const bool alive_new = physics<float, 0>(
        sc, P, cam, best, best_t, o, d, th, rad, tm, u, u_med, Seeds<0>{},
        nw, ng, gc, &ev);
    if (STORE) {
        int flags = 0, mat = 0, eff = -1;
        if (ev.hit) {
            mat = ev.mat;
            eff = ev.eff;
            const int mtype = (int)sc.mati[mat * 2];
            flags = ADJ_HIT | (ev.emit ? ADJ_EMIT : 0)
                | (ev.diel ? ADJ_DIEL : 0)
                | (mtype == MAT_METAL ? ADJ_METAL : 0)
                | (mtype != MAT_METAL && mtype != MAT_DIELECTRIC
                   && mtype != MAT_DIFFUSE_LIGHT ? ADJ_MIS : 0);
        }
        if (alive_new) flags |= ADJ_SCAT;
        st[9 * N] = (float)best;
        st[10 * N] = best_t;
        st[11 * N] = (float)mat;
        st[12 * N] = (float)eff;
        st[13 * N] = (float)flags;
        st[14 * N] = ev.hit ? ev.factor : 1.0f;
    }
    return alive_new;
}

// One bounce backward (K9's phase R, K10's sweep 2): the bounce whose
// record is at st (stride N), bounce b of sample k1 at ray time tm. Adds
// (g, lam) . d(radiance increment, o', d', th')/d theta into the
// accumulators, lam the cotangent of the state the bounce left, and
// replaces lam by (g, lam) . d(...)/d(o, d, th), the cotangent of the
// state it started from.
static __device__ __forceinline__ void adj_reverse_bounce(
        const Scene& sc, const WfParams& P, const float* cam, uint32_t k0,
        uint32_t k1, uint32_t k2, int b, float tm, const float (&gc)[3],
        const float* st, int N, float (&lam)[9], double* acc) {
    const int t_base = 3 * P.NT, m_base = 3 * P.NT + 4 * P.S;
    const V3 o0 = v3(st[0 * N], st[1 * N], st[2 * N]);
    const V3 d0 = v3(st[3 * N], st[4 * N], st[5 * N]);
    const V3 th0 = v3(st[6 * N], st[7 * N], st[8 * N]);
    const int best = (int)st[9 * N];
    const float best_t = st[10 * N];
    const int mat = (int)st[11 * N];
    const int eff = (int)st[12 * N];
    const int flags = (int)st[13 * N];
    const float factor = st[14 * N];
    float u[9], u_med[4];
    draws(k0, k1, k2, 0x4000000u + (uint32_t)b, u, 9);
    if (sc.M > 0) draws(k0, k1, k2, 1000000u + (uint32_t)b, u_med, sc.M);
    // tex_color: the emission's and the attenuation's products
    if ((flags & ADJ_HIT) && eff >= 0) {
        const float tv[3] = {th0.x, th0.y, th0.z};
        for (int c = 0; c < 3; ++c) {
            float v = 0.0f;
            if (flags & ADJ_EMIT) v = gc[c] * tv[c];
            if ((flags & ADJ_SCAT) && !(flags & ADJ_DIEL))
                v = v + lam[6 + c] * (tv[c] * factor);
            adj_add(acc, 3 * eff + c, v);
        }
    }
    physics_vjp(sc, P, cam, best, best_t, o0, d0, th0, tm, u, u_med, gc,
                (flags & ADJ_SCAT) != 0, factor, lam, acc, t_base, m_base);
}

// The dynamic shared memory of an adjoint launch: the chunk scan's boxes,
// and the accumulators where they fit beside them (the static cam row and
// a margin aside; shared_acc says whether they do). 0 for inputs the
// kernels do not take.
static size_t adj_smem(const WfParams& P, const VsParams& V, int NM,
                       bool& shared_acc) {
    shared_acc = false;
    if (P.n_lanes % WF_THREADS != 0 || V.C_small < 1 || V.n_big < 0
        || V.n_big > VCHUNK || V.Cq < 0 || V.n_box < 6 * V.C_small
        || !vscan_groups_ok(V)
        || NM < 1 || P.NT < 1 || P.L > MAX_LIGHTS || P.max_depth < 1)
        return 0;
    const size_t n_acc = (size_t)3 * P.NT + (size_t)4 * P.S + (size_t)2 * NM;
    const size_t boxes = (size_t)table_pad(V.n_box);
    shared_acc = boxes * sizeof(float) + n_acc * sizeof(double)
        <= (size_t)(226 * 1024);
    return boxes * sizeof(float) + (shared_acc ? n_acc * sizeof(double) : 0);
}
#endif  // WF_IN_PART(4) || WF_IN_PART(5)

#if WF_IN_PART(4)
// K9, the per-sample sweep: per sample, phase F runs the path forward
// storing each bounce's record (store: [bounce][field][lane]), phase R
// reverses them with lam chained from 0.
extern "C" __global__ void __launch_bounds__(WF_THREADS)
wavefront_adjoint_kernel(WfParams P, VsParams V, AdjArgs A) {
    __shared__ float cam[22];
    const int n_acc = 3 * P.NT + 4 * P.S + 2 * A.NM;
    double* acc = adj_block_start(V, A, n_acc, P, cam);

    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const int N = P.n_lanes;
    const Scene sc = adj_scene(P, A.tables);

    // pad lanes repeat the last pixel (their cotangent is 0)
    const int pix = P.row0 * P.width + (lane < P.n_pix ? lane : P.n_pix - 1);
    const uint32_t k0 = (uint32_t)pix;
    const uint32_t k2 = P.seed_mix;
    const float fi = (float)(pix % P.width);
    const float fj = (float)(pix / P.width);
    const float gc[3] = {A.cot[0 * N + lane], A.cot[1 * N + lane],
                         A.cot[2 * N + lane]};
    float* store = A.store + lane;
    const size_t sb = (size_t)ADJ_STORE * N;   // one bounce's floats

    V3 rad = v3(0.0f, 0.0f, 0.0f);
    int it = 0;
    for (int s = 0; s < P.n_samples; ++s) {
        const uint32_t k1 = (uint32_t)(P.sample_start + s);
        V3 o, d, th;
        float tm;
        gen_ray(P, cam, k0, k2, fi, fj, P.sample_start + s, o, d, tm);
        th = v3(1.0f, 1.0f, 1.0f);
        // ---- phase F: the forward path, each bounce's record stored
        int n_used = 0;
        for (int b = 0; b < P.max_depth; ++b) {
            const bool alive_new = adj_forward_bounce<true>(
                sc, P, V, A.vtab, cam, k0, k1, k2, b, o, d, th, rad, tm, gc,
                store + (size_t)b * sb, N);
            ++it;
            n_used = b + 1;
            if (!alive_new) break;
        }
        // ---- phase R: the bounces backward, lam chained from 0
        float lam[9];
        for (int c = 0; c < 9; ++c) lam[c] = 0.0f;
        for (int b = n_used - 1; b >= 0; --b)
            adj_reverse_bounce(sc, P, cam, k0, k1, k2, b, tm, gc,
                               store + (size_t)b * sb, N, lam, acc);
    }
    A.rad_out[0 * N + lane] = rad.x;
    A.rad_out[1 * N + lane] = rad.y;
    A.rad_out[2 * N + lane] = rad.z;
    if (A.iters_out) A.iters_out[lane] += it;
    adj_block_flush(A, acc, n_acc);
}

// rad_out (3, n_lanes); acc_out (3NT + 4S + 2NM doubles) zeroed; store
// (max_depth * ADJ_STORE * n_lanes) scratch; NM material rows
extern "C" int rt_wavefront_adjoint(const WfParams* params,
                                    const VsParams* vparams,
                                    const float* tables, const float* vtab,
                                    const float* cot, float* rad_out,
                                    double* acc_out, float* store,
                                    int* iters_out, int NM, void* stream) {
    const WfParams P = *params;
    const VsParams V = *vparams;
    bool shared_acc;
    const size_t smem = adj_smem(P, V, NM, shared_acc);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = set_smem((const void*)wavefront_adjoint_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const AdjArgs A = {tables, vtab, cot, rad_out, acc_out, store, iters_out,
                       NM, shared_acc ? 1 : 0};
    wavefront_adjoint_kernel<<<P.n_lanes / WF_THREADS, WF_THREADS, smem,
                               (cudaStream_t)stream>>>(P, V, A);
    return (int)cudaGetLastError();
}

// The reverse bounce alone (chip_smoke.py's adjoint_bounce_probe, the GPU
// tests): per lane, one bounce from a given state (o, d, th, ray time:
// state rows 0-9) as bounce b of sample k1 of pixel k0 (keys rows 0-2),
// through adj_forward_bounce (the chunk scan's selection and the float
// bounce, its record stored), then adj_reverse_bounce at the cotangents g
// (A.cot) and lam (lam_io rows 0-8, replaced by the cotangent of the
// state); each lane's table cotangents go to its own accumulator row
// (A.acc_out + lane * n_acc, zeroed by the caller).
extern "C" __global__ void __launch_bounds__(WF_THREADS)
adjoint_probe_kernel(WfParams P, VsParams V, AdjArgs A,
                     const float* __restrict__ state,
                     const int* __restrict__ keys, float* lam_io) {
    __shared__ float cam[22];
    const int n_acc = 3 * P.NT + 4 * P.S + 2 * A.NM;
    adj_block_start(V, A, n_acc, P, cam);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const int N = P.n_lanes;
    const Scene sc = adj_scene(P, A.tables);
    const float gc[3] = {A.cot[0 * N + lane], A.cot[1 * N + lane],
                         A.cot[2 * N + lane]};
    V3 o = v3(state[0 * N + lane], state[1 * N + lane], state[2 * N + lane]);
    V3 d = v3(state[3 * N + lane], state[4 * N + lane], state[5 * N + lane]);
    V3 th = v3(state[6 * N + lane], state[7 * N + lane],
               state[8 * N + lane]);
    const float tm = state[9 * N + lane];
    const uint32_t k0 = (uint32_t)keys[0 * N + lane];
    const uint32_t k1 = (uint32_t)keys[1 * N + lane];
    const int b = keys[2 * N + lane];
    V3 rad = v3(0.0f, 0.0f, 0.0f);
    adj_forward_bounce<true>(sc, P, V, A.vtab, cam, k0, k1, P.seed_mix, b, o,
                             d, th, rad, tm, gc, A.store + lane, N);
    float lam[9];
    for (int c = 0; c < 9; ++c) lam[c] = lam_io[c * N + lane];
    adj_reverse_bounce(sc, P, cam, k0, k1, P.seed_mix, b, tm, gc,
                       A.store + lane, N, lam,
                       A.acc_out + (size_t)lane * n_acc);
    for (int c = 0; c < 9; ++c) lam_io[c * N + lane] = lam[c];
    A.rad_out[0 * N + lane] = rad.x;
    A.rad_out[1 * N + lane] = rad.y;
    A.rad_out[2 * N + lane] = rad.z;
}

// state (10, n_lanes), keys (3, n_lanes) int, cot (3, n_lanes), lam_io (9,
// n_lanes), rad_out (3, n_lanes), acc_out (n_lanes, 3NT + 4S + 2NM
// doubles) zeroed, store (ADJ_STORE * n_lanes): the records
extern "C" int rt_adjoint_bounce_probe(const WfParams* params,
                                       const VsParams* vparams,
                                       const float* tables, const float* vtab,
                                       const float* state, const int* keys,
                                       const float* cot, float* lam_io,
                                       float* rad_out, double* acc_out,
                                       float* store, int NM, void* stream) {
    const WfParams P = *params;
    const VsParams V = *vparams;
    bool shared_acc;
    if (adj_smem(P, V, NM, shared_acc) == 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)table_pad(V.n_box) * sizeof(float);
    cudaError_t e = set_smem((const void*)adjoint_probe_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const AdjArgs A = {tables, vtab, cot, rad_out, acc_out, store, nullptr,
                       NM, 0};
    adjoint_probe_kernel<<<P.n_lanes / WF_THREADS, WF_THREADS, smem,
                           (cudaStream_t)stream>>>(P, V, A, state, keys,
                                                   lam_io);
    return (int)cudaGetLastError();
}
#endif  // WF_IN_PART(4)

#if WF_IN_PART(5)
// K10, the segmented-regeneration sweep (wavefront_pallas.py: adj_seg,
// awf_advance 2973-3019, sweep 1 s1_cond/s1_body 3021-3048, sweep 2
// rev_one/s2_body 3050-3092; scratch 3594-3599). The JAX kernel's reason
// for it is the TPU's lock-step tile: the per-sample sweep pays, per
// sample, the tile's longest path forward and again backward. On this card
// the counterpart of the tile is the warp: under K9 a warp's 32 lanes are
// in different phases (one still tracing its sample, another reversing
// it) and the warp pays the longest phase F of its lanes and then the
// longest phase R, sample by sample. K10 keeps a warp in one phase at a
// time:
//   Sweep 1 runs the regenerating wavefront to the end (adj_advance: a lane
//   whose path ended takes its pixel's next sample's camera ray, then every
//   live lane runs one bounce), accumulating the image, and every SEG
//   iterations stores a snapshot of the lane state (ADJ_SNAP floats: o, d,
//   th, alive, bounce, sample, time; [segment][field][lane]). It loops
//   while any lane of the warp has work left (__any_sync), so a warp's
//   segment count is uniform; a lane whose samples are done takes masked
//   no-op iterations, as the JAX tile's finished lanes do.
//   Sweep 2 takes the warp's segments last to first: it restores the
//   segment's snapshot, re-runs its SEG iterations storing each bounce's
//   record (ADJ_REC floats: K9's ADJ_STORE, then whether the lane
//   regenerated, the bounce, -1 for a no-op, the absolute sample and the
//   ray time; [iteration][field][lane]), and reverses them with K9's
//   backward bounce, lam carried across segment boundaries and set to 0
//   after an iteration whose lane regenerated (the cotangent of a fresh
//   camera ray's state with respect to the last path's is 0).
// Each lane runs K9's arithmetic in K9's order: the image and the bounces
//   (iters: sweep 1's) are K9's bit for bit, and each bounce adds K9's float
//   contributions to the double accumulators, in another order. The price
//   is one more forward bounce a bounce (the re-run) and the snapshots.
#define ADJ_REC (ADJ_STORE + 4)   // + regen, bounce, sample, time
#define ADJ_SNAP 13               // o xyz, d xyz, th xyz, alive, bounce,
                                  // sample (local), time

struct AdjSegArgs {
    AdjArgs a;         // store: seg * ADJ_REC * n_lanes floats
    float* snap;       // nseg_max * ADJ_SNAP * n_lanes floats
    int seg, nseg_max;
};

// A lane of the regenerating sweep: its ray, whether its path is alive,
// the path's bounce and the lane's local sample.
struct AdjLane {
    V3 o, d, th;
    float tm;
    int b, s;
    bool alive;
};

// One iteration of the regenerating sweep (awf_advance): a lane whose path
// ended and that has samples left takes the next sample's camera ray; a
// live lane then runs one bounce (adj_forward_bounce), rad getting its
// radiance. With REC its record goes to rec (stride N). Returns whether it
// ran a bounce.
template <bool REC>
static __device__ __forceinline__ bool adj_advance(
        const Scene& sc, const WfParams& P, const VsParams& V,
        const float* vtab, const float* cam, uint32_t k0, uint32_t k2,
        float fi, float fj, const float (&gc)[3], AdjLane& L, V3& rad,
        float* rec, int N) {
    const bool regen = !L.alive && L.s + 1 < P.n_samples;
    if (regen) {
        ++L.s;
        gen_ray(P, cam, k0, k2, fi, fj, P.sample_start + L.s, L.o, L.d,
                L.tm);
        L.th = v3(1.0f, 1.0f, 1.0f);
        L.b = 0;
        L.alive = true;
    }
    if (!L.alive) {
        if (REC) rec[(ADJ_STORE + 1) * N] = -1.0f;
        return false;
    }
    const int s_abs = P.sample_start + L.s;
    if (REC) {
        rec[(ADJ_STORE + 0) * N] = regen ? 1.0f : 0.0f;
        rec[(ADJ_STORE + 1) * N] = (float)L.b;
        rec[(ADJ_STORE + 2) * N] = (float)s_abs;
        rec[(ADJ_STORE + 3) * N] = L.tm;
    }
    const bool alive_new = adj_forward_bounce<REC>(
        sc, P, V, vtab, cam, k0, (uint32_t)s_abs, k2, L.b, L.o, L.d, L.th,
        rad, L.tm, gc, rec, N);
    L.alive = alive_new && L.b + 1 < P.max_depth;
    ++L.b;
    return true;
}

extern "C" __global__ void __launch_bounds__(WF_THREADS)
wavefront_adjoint_seg_kernel(WfParams P, VsParams V, AdjSegArgs G) {
    const AdjArgs& A = G.a;
    __shared__ float cam[22];
    const int n_acc = 3 * P.NT + 4 * P.S + 2 * A.NM;
    double* acc = adj_block_start(V, A, n_acc, P, cam);

    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const int N = P.n_lanes;
    const Scene sc = adj_scene(P, A.tables);

    // pad lanes repeat the last pixel (their cotangent is 0)
    const int pix = P.row0 * P.width + (lane < P.n_pix ? lane : P.n_pix - 1);
    const uint32_t k0 = (uint32_t)pix;
    const uint32_t k2 = P.seed_mix;
    const float fi = (float)(pix % P.width);
    const float fj = (float)(pix / P.width);
    const float gc[3] = {A.cot[0 * N + lane], A.cot[1 * N + lane],
                         A.cot[2 * N + lane]};
    float* snap = G.snap + lane;
    float* recs = A.store + lane;
    const size_t ss = (size_t)ADJ_SNAP * N;    // one snapshot's floats
    const size_t rs = (size_t)ADJ_REC * N;     // one record's floats

    AdjLane L;
    gen_ray(P, cam, k0, k2, fi, fj, P.sample_start, L.o, L.d, L.tm);
    L.th = v3(1.0f, 1.0f, 1.0f);
    L.b = 0;
    L.s = 0;
    L.alive = true;

    // ---- sweep 1: the regenerating forward, a snapshot every SEG
    // iterations, while a lane of the warp has work left
    V3 rad = v3(0.0f, 0.0f, 0.0f);
    int it = 0, nseg = 0;
    while (nseg < G.nseg_max
           && __any_sync(0xffffffffu, L.alive || L.s + 1 < P.n_samples)) {
        float* sn = snap + (size_t)nseg * ss;
        sn[0 * N] = L.o.x; sn[1 * N] = L.o.y; sn[2 * N] = L.o.z;
        sn[3 * N] = L.d.x; sn[4 * N] = L.d.y; sn[5 * N] = L.d.z;
        sn[6 * N] = L.th.x; sn[7 * N] = L.th.y; sn[8 * N] = L.th.z;
        sn[9 * N] = L.alive ? 1.0f : 0.0f;
        sn[10 * N] = (float)L.b;
        sn[11 * N] = (float)L.s;
        sn[12 * N] = L.tm;
        for (int i = 0; i < G.seg; ++i)
            if (adj_advance<false>(sc, P, V, A.vtab, cam, k0, k2, fi, fj, gc,
                                   L, rad, nullptr, N))
                ++it;
        ++nseg;
    }
    A.rad_out[0 * N + lane] = rad.x;
    A.rad_out[1 * N + lane] = rad.y;
    A.rad_out[2 * N + lane] = rad.z;
    if (A.iters_out) A.iters_out[lane] += it;

    // ---- sweep 2: the warp's segments last to first, each re-run from its
    // snapshot storing its records, then reversed; lam carries across
    // segments and is cut where a lane regenerated
    float lam[9];
    for (int c = 0; c < 9; ++c) lam[c] = 0.0f;
    for (int k = nseg - 1; k >= 0; --k) {
        const float* sn = snap + (size_t)k * ss;
        L.o = v3(sn[0 * N], sn[1 * N], sn[2 * N]);
        L.d = v3(sn[3 * N], sn[4 * N], sn[5 * N]);
        L.th = v3(sn[6 * N], sn[7 * N], sn[8 * N]);
        L.alive = sn[9 * N] != 0.0f;
        L.b = (int)sn[10 * N];
        L.s = (int)sn[11 * N];
        L.tm = sn[12 * N];
        V3 rerun = v3(0.0f, 0.0f, 0.0f);
        for (int i = 0; i < G.seg; ++i)
            adj_advance<true>(sc, P, V, A.vtab, cam, k0, k2, fi, fj, gc, L,
                              rerun, recs + (size_t)i * rs, N);
        for (int i = G.seg - 1; i >= 0; --i) {
            const float* r = recs + (size_t)i * rs;
            const int b = (int)r[(ADJ_STORE + 1) * N];
            if (b < 0) continue;
            adj_reverse_bounce(sc, P, cam, k0, (uint32_t)r[(ADJ_STORE + 2) * N],
                               k2, b, r[(ADJ_STORE + 3) * N], gc, r, N, lam,
                               acc);
            if (r[ADJ_STORE * N] != 0.0f) {
                for (int c = 0; c < 9; ++c) lam[c] = 0.0f;
            }
        }
    }
    adj_block_flush(A, acc, n_acc);
}

// rt_wavefront_adjoint's arguments, with store (seg * ADJ_REC * n_lanes)
// and snap (nseg_max * ADJ_SNAP * n_lanes) scratch and the sweep's SEG and
// snapshot bound (nseg_max >= ceil(n_samples * max_depth / seg))
extern "C" int rt_wavefront_adjoint_seg(const WfParams* params,
                                        const VsParams* vparams,
                                        const float* tables,
                                        const float* vtab, const float* cot,
                                        float* rad_out, double* acc_out,
                                        float* store, float* snap,
                                        int* iters_out, int NM, int seg,
                                        int nseg_max, void* stream) {
    const WfParams P = *params;
    const VsParams V = *vparams;
    bool shared_acc;
    const size_t smem = adj_smem(P, V, NM, shared_acc);
    if (smem == 0 || seg < 1
        || (long long)nseg_max * seg < (long long)P.n_samples * P.max_depth)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = set_smem((const void*)wavefront_adjoint_seg_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const AdjSegArgs G = {{tables, vtab, cot, rad_out, acc_out, store,
                           iters_out, NM, shared_acc ? 1 : 0},
                          snap, seg, nseg_max};
    wavefront_adjoint_seg_kernel<<<P.n_lanes / WF_THREADS, WF_THREADS, smem,
                                   (cudaStream_t)stream>>>(P, V, G);
    return (int)cudaGetLastError();
}
#endif  // WF_IN_PART(5)

#if WF_IN_PART(0)
// The forward pass (K1, K2), its threads persistent over lane slots
// (forward_refill), asking for seven blocks an SM: 72 registers and 44 B
// of spill stores, where left to itself ptxas takes 80 registers and six
// blocks, and the compacted schedule (the CLI's and training's) runs 2-6%
// slower (scripts/port_profile.py, PERF.md).
extern "C" __global__ void __launch_bounds__(WF_THREADS, 7)
wavefront_forward_kernel(WfParams P, const float* __restrict__ tables,
                         const int* __restrict__ pix_lanes,
                         const float* __restrict__ carry_in,
                         float* __restrict__ rad_out,
                         float* __restrict__ carry_out,
                         int* __restrict__ iters_out,
                         int* __restrict__ next) {
    __shared__ float cam[22];
    forward_refill<SEL_UNROLLED>(P, tables, pix_lanes, carry_in, rad_out,
                                 carry_out, iters_out, next, wf_tables, cam);
}

// The forward pass over the chunk scan's selection (K6 vscan; K7 vquad where
// V.Cq > 0), under the same capped/resume carry (K2).
extern "C" __global__ void __launch_bounds__(WF_THREADS)
wavefront_forward_vscan_kernel(WfParams P, VsParams V,
                               const float* __restrict__ tables,
                               const float* __restrict__ vtab,
                               const int* __restrict__ pix_lanes,
                               const float* __restrict__ carry_in,
                               float* __restrict__ rad_out,
                               float* __restrict__ carry_out,
                               int* __restrict__ iters_out) {
    __shared__ float cam[22];
    wavefront_body<0, false, SEL_VSCAN>(P, tables, pix_lanes, carry_in,
                                        nullptr, rad_out, carry_out, nullptr,
                                        iters_out, wf_tables, cam, nullptr, V,
                                        vtab);
}

// The forward pass plus the gradient tiers: the tex_color weight planes
// for NT <= NTMAX texture rows (K3; NTMAX 0: none) and, with HARD, the
// tangent bundles of the hard slots (K4); K5 under the compacted driver.
template <int NTMAX, bool HARD>
__global__ void __launch_bounds__(WF_THREADS)
wavefront_grad_kernel(WfParams P, const float* __restrict__ tables,
                      const int* __restrict__ pix_lanes,
                      const float* __restrict__ carry_in,
                      const float* __restrict__ cot,
                      float* __restrict__ rad_out,
                      float* __restrict__ carry_out,
                      float* __restrict__ dg_out,
                      int* __restrict__ iters_out) {
    __shared__ float cam[22];
    __shared__ float red[(WF_THREADS / 32) * 3 * (NTMAX > 0 ? NTMAX : 1)];
    if constexpr (HARD) {
        __shared__ int skey[MAX_SLOTS];
        wavefront_body<NTMAX, HARD>(P, tables, pix_lanes, carry_in, cot,
                                    rad_out, carry_out, dg_out, iters_out,
                                    wf_tables, cam, red, VsParams(), nullptr,
                                    BvParams(), skey);
    } else {
        wavefront_body<NTMAX, HARD>(P, tables, pix_lanes, carry_in, cot,
                                    rad_out, carry_out, dg_out, iters_out,
                                    wf_tables, cam, red);
    }
}

// K3, the tex_color weight planes alone (NT <= NTMAX, 8 or 16): the grad
// kernel's body, asking for four blocks an SM. With its 2 * 3 * NTMAX
// register planes (48 floats at NTMAX 8) beside the bounce, left to
// itself ptxas took 165 registers, three blocks an SM, where the forward
// takes 113 and four, and K3 took 152 ms at Cornell 1920x1080 spp64 d50
// against the forward's 127 ms; held to 128 registers it spills 88 B a
// thread and takes 138 ms (an NVIDIA H100 80GB HBM3 at 700 W,
// scripts/port_profile.py, PERF.md): the spills cost less than the fourth
// block gains. The planes' arithmetic and the reduction are the grad
// kernel's, so the image and dG_tex are its bit for bit. (The planes in
// shared memory, all of them or Gp alone, measured slower.)
template <int NTMAX>
__global__ void __launch_bounds__(WF_THREADS, 4)
wavefront_tex_grad_kernel(WfParams P, const float* __restrict__ tables,
                          const int* __restrict__ pix_lanes,
                          const float* __restrict__ carry_in,
                          const float* __restrict__ cot,
                          float* __restrict__ rad_out,
                          float* __restrict__ carry_out,
                          float* __restrict__ dg_out,
                          int* __restrict__ iters_out) {
    __shared__ float cam[22];
    __shared__ float red[(WF_THREADS / 32) * 3 * NTMAX];
    wavefront_body<NTMAX, false>(P, tables, pix_lanes, carry_in, cot,
                                 rad_out, carry_out, dg_out, iters_out,
                                 wf_tables, cam, red);
}

// Plain C entry points (bound with ctypes). Each launches on `stream` and
// returns cudaGetLastError(): a launch that is refused never runs, and only
// this reports it.
//
// next: the launch's slot counter, one int that is 0 when the launch
// starts (the wrapper zeroes it on the same stream)
extern "C" int rt_wavefront_forward(const WfParams* params,
                                    const float* tables, const int* pix_lanes,
                                    const float* carry_in, float* rad_out,
                                    float* carry_out, int* iters_out,
                                    int* next, void* stream) {
    const WfParams P = *params;
    if (P.n_lanes % WF_THREADS != 0 || !next)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)P.n_table * sizeof(float);
    cudaError_t e = set_smem((const void*)wavefront_forward_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = resident_blocks((const void*)wavefront_forward_kernel,
                                       smem, P.n_lanes);
    if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
    wavefront_forward_kernel<<<blocks, WF_THREADS, smem,
                               (cudaStream_t)stream>>>(
        P, tables, pix_lanes, carry_in, rad_out, carry_out, iters_out, next);
    return (int)cudaGetLastError();
}

// vtab: the chunk scan's buffer (rows, quad rows, boxes) beside the scene
// tables, which this instance reads from global memory
extern "C" int rt_wavefront_forward_vscan(const WfParams* params,
                                          const VsParams* vparams,
                                          const float* tables,
                                          const float* vtab,
                                          const int* pix_lanes,
                                          const float* carry_in,
                                          float* rad_out, float* carry_out,
                                          int* iters_out, void* stream) {
    const WfParams P = *params;
    const VsParams V = *vparams;
    if (P.n_lanes % WF_THREADS != 0 || V.C_small < 1 || V.n_big < 0
        || V.n_big > VCHUNK || V.Cq < 0 || V.n_box < 6 * V.C_small
        || !vscan_groups_ok(V))
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)V.n_box * sizeof(float);
    cudaError_t e = set_smem((const void*)wavefront_forward_vscan_kernel,
                             smem);
    if (e != cudaSuccess) return (int)e;
    wavefront_forward_vscan_kernel<<<P.n_lanes / WF_THREADS, WF_THREADS,
                                     smem, (cudaStream_t)stream>>>(
        P, V, tables, vtab, pix_lanes, carry_in, rad_out, carry_out,
        iters_out);
    return (int)cudaGetLastError();
}

template <int NTMAX, bool HARD>
static int launch_grad(const WfParams& P, const float* tables,
                       const int* pix_lanes, const float* carry_in,
                       const float* cot, float* rad_out, float* carry_out,
                       float* dg_out, int* iters_out, cudaStream_t stream) {
    size_t floats = HARD ? (size_t)table_pad(P.n_table)
                               + (size_t)10 * P.K * WF_THREADS
                         : (size_t)P.n_table;
    const size_t smem = floats * sizeof(float);
    cudaError_t e = set_smem(
        (const void*)wavefront_grad_kernel<NTMAX, HARD>, smem);
    if (e != cudaSuccess) return (int)e;
    wavefront_grad_kernel<NTMAX, HARD>
        <<<P.n_lanes / WF_THREADS, WF_THREADS, smem, stream>>>(
            P, tables, pix_lanes, carry_in, cot, rad_out, carry_out, dg_out,
            iters_out);
    return (int)cudaGetLastError();
}

template <int NTMAX>
static int launch_tex_grad(const WfParams& P, const float* tables,
                           const int* pix_lanes, const float* carry_in,
                           const float* cot, float* rad_out, float* carry_out,
                           float* dg_out, int* iters_out,
                           cudaStream_t stream) {
    const size_t smem = (size_t)P.n_table * sizeof(float);
    cudaError_t e = set_smem(
        (const void*)wavefront_tex_grad_kernel<NTMAX>, smem);
    if (e != cudaSuccess) return (int)e;
    wavefront_tex_grad_kernel<NTMAX>
        <<<P.n_lanes / WF_THREADS, WF_THREADS, smem, stream>>>(
            P, tables, pix_lanes, carry_in, cot, rad_out, carry_out, dg_out,
            iters_out);
    return (int)cudaGetLastError();
}

// dg_out: (n_lanes / WF_THREADS, 3 * NT * want_tex + K) per-block partial
// sums
extern "C" int rt_wavefront_grad(const WfParams* params,
                                 const float* tables, const int* pix_lanes,
                                 const float* carry_in, const float* cot,
                                 float* rad_out, float* carry_out,
                                 float* dg_out, int* iters_out,
                                 void* stream) {
    const WfParams P = *params;
    if (P.n_lanes % WF_THREADS != 0 || P.K < 0 || P.K > MAX_SLOTS
        || (P.want_tex && (P.NT < 1 || P.NT > 16))
        || (!P.want_tex && P.K == 0))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define WF_GRAD_ARGS P, tables, pix_lanes, carry_in, cot, rad_out, \
                     carry_out, dg_out, iters_out, s
    if (P.K == 0)
        return P.NT <= 8 ? launch_tex_grad<8>(WF_GRAD_ARGS)
                         : launch_tex_grad<16>(WF_GRAD_ARGS);
    if (!P.want_tex) return launch_grad<0, true>(WF_GRAD_ARGS);
    return P.NT <= 8 ? launch_grad<8, true>(WF_GRAD_ARGS)
                     : launch_grad<16, true>(WF_GRAD_ARGS);
#undef WF_GRAD_ARGS
}

// The chunk scan's grad passes: dg_out as rt_wavefront_grad's; P.suffix
// selects the suffix tier (3 * NT route sums in place of the weight
// planes' 3 * NT, its carry rows after the tangent planes: SFX_STATE, then
// SFX_REC * max_depth of records). scr is the tex_color tier's scratch
// (wavefront_body): the suffix tier's, or the weight planes' two columns;
// multi (nullable) gets one for each path whose weight planes came to hold
// a second row.
extern "C" int rt_wavefront_grad_vscan(const WfParams* params,
                                       const VsParams* vparams,
                                       const float* tables,
                                       const float* vtab,
                                       const int* pix_lanes,
                                       const float* carry_in,
                                       const float* cot, float* rad_out,
                                       float* carry_out, float* dg_out,
                                       int* iters_out, float* scr,
                                       int* multi, void* stream) {
    const WfParams P = *params;
    const VsParams V = *vparams;
    if (P.n_lanes % WF_THREADS != 0 || V.C_small < 1 || V.n_big < 0
        || V.n_big > VCHUNK || V.Cq < 0 || V.n_box < 6 * V.C_small
        || !vscan_groups_ok(V)
        || P.K < 0 || P.K > MAX_SLOTS
        || (P.want_tex && (P.NT < 1 || !scr))
        || (!P.suffix && P.want_tex && P.NT > 32)
        || (P.suffix && !P.want_tex)
        || (!P.want_tex && P.K == 0))
        return (int)cudaErrorInvalidValue;
    const GradArgs A = {tables, vtab, pix_lanes, carry_in, cot, rad_out,
                        carry_out, dg_out, iters_out, scr, multi};
    cudaStream_t s = (cudaStream_t)stream;
    if (P.want_tex && !P.suffix)
        return P.K == 0 ? launch_vgrad_planes(P, V, A, s)
                        : launch_vgrad_planes_hard(P, V, A, s);
    return launch_vgrad_other(P, V, A, s);
}
#endif  // WF_IN_PART(0)
