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
//   2545-2559, 2604-2637, 3205-3262).
//
// Shape: one thread per lane (pixel), the reference engine's own
//   static_render_kernel shape (CameraKernels.cu:240-278). Each thread loops
//   over its pixel's samples and bounces in registers, regenerating a
//   finished path onto the next stratified sample exactly as the Pallas
//   kernel's `bounce` does (wavefront_pallas.py:2360-2391). Scene tables
//   (a few KB inside the unrolled gate) are copied into shared memory at
//   block start (the chunk scan's instance reads them from global memory);
//   the radiance sum is written once per lane.
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
//   H100). NTMAX is 8 (Cornell: NT = 6) or 16 (the gate's MAX_TEXS).
//
// Gradient, tangent bundles (K4): with HARD, each of the K hard slots
//   (metal fuzz, dielectric IOR, sphere center and radius scalars) has a
//   9-plane tangent Dst[k] = d(o, d, th)/d theta_k. The JAX kernel
//   jax.linearize's `physics` once per bounce and pushes every bundle
//   through the linear map; CUDA has no linearize, so here the JVP is
//   forward-mode dual numbers: physics<Dual> evaluates the same code with
//   a value and one tangent per scalar, written once as operator rules
//   (+ - * /, sqrt, pow, sin, abs, min/max with torch's tie rules). Per
//   bounce the float pass runs once (image, discrete decisions, K3) and the
//   dual pass once per slot k, from (o, d, th) with tangent Dst[k] and
//   theta_k's tangent 1 injected at the table reads the slot table names:
//   the sphere row's center or radius column, the material's fuzz or IOR
//   column, and the columns 1-3 / 7 of every light row that copies that
//   sphere (light_src, the JAX kernel's theta_map aliasing). Every branch
//   (winning primitive, Schlick reflect or refract, light pick, medium
//   preemption, the pdf > 1e-8 guard) is decided on the value parts, which
//   are the float pass's operation for operation, so the image is the
//   forward's bit for bit and the slots see the same paths. dG[k] +=
//   <g, d radiance / d theta_k> at each radiance event; Dst[k] takes the
//   dual pass's new tangents where the path goes on and is reset to 0 on
//   regeneration (a camera ray has no theta dependence). Dst and dG live in
//   shared memory laid out [plane][thread] (10*K floats a thread, 46 KB a
//   block at Cornell's K = 9, 160 KB at the bound K = 32): every access is
//   thread-consecutive (no bank conflicts), the size follows K at launch,
//   and there is nothing to spill, where 10*K more registers a thread would
//   not fit beside the bounce's own. The slots' planes ride the carry
//   after the weight planes (rows 14 + 3NT + 9k + c).
//
// Chunk scan (K6, K7): wavefront_forward_vscan_kernel is the forward with
//   closest_select_vscan in place of closest_select, for scenes of up to
//   MAX_PRIMS_SCAN = 16,384 primitives. Spheres come in Morton-ordered
//   chunks of 128 rows [c0, cdelta, radius, original id] with one box per
//   chunk, swept over the motion interval and widened (ops/wavefront_cuda.py
//   BOX_PAD) so that float32 rounding of a grazing root never puts the
//   winner outside it; the 8 largest static spheres sit in a final block
//   that is always tested (a ground sphere's box would cover the scene).
//   Each thread culls each chunk against its own ray (a slab test between
//   T_MIN and its running best t; 1/d guarded at |d| < 1e-12 as the JAX
//   kernel does); a warp runs a chunk when any of its lanes needs it. Quads
//   past MAX_QUADS_VSCAN = 64 take the same walk over quad chunks (K7);
//   fewer are tested one by one. The winner is the exact float t, ties to
//   the lower original unified id (spheres before quads): the all-primitive
//   closest_select's and the plain torch version's winner, bit for bit,
//   where the JAX kernel packs t and a 7-bit Morton-local id into one int32
//   key (~2^-17 relative fuzz, 1456-1461). The winner's original id then
//   indexes the scene's own tables, so physics<T> runs unchanged and
//   texture_value walks nested checkers per thread (tex_eval_dag's gathers
//   and the resolved per-prim rows are TPU workarounds). Bounded by
//   operations, as the unrolled forward, plus memory latency: the tables
//   (51 KB for bouncing_spheres, 530 KB for a 4,913-sphere grid) do not fit
//   a block's shared memory, so rows, materials and textures are read from
//   global memory (rows through the read-only path, __ldg float4; H100's
//   50 MB L2 holds them all) and only the chunk boxes (at most 257 x 6
//   floats) are copied into shared memory. The chunk cull bounds the
//   sphere tests per bounce; a per-thread BVH (K12's shape) would bound them
//   at O(log N) and is the open alternative (PERF.md).
//
// Chunk-scan grad (K3v, K4v): wavefront_grad_vscan_kernel is the grad
//   kernel's tiers over closest_select_vscan. The winner's original id
//   indexes the scene tables, so physics<T> and the slot table's aliasing
//   (rd_sph by original row, light rows through light_src) are the unrolled
//   kernel's: the JAX kernel's post-gather theta aliasing needs nothing
//   more here. The tables stay in global memory, as K6 reads them; shared
//   memory holds the chunk boxes and the tangent planes. The weight planes
//   stay in registers for up to 16 rows (NTMAX 8 or 16); for 17 to 32 rows
//   (96 + 96 floats a thread, which registers cannot hold beside the
//   bounce) they live in shared memory, [plane][thread] as the tangent
//   planes do (SPLANES: 48 KB a block at 16 rows, 96 KB at 32), where the
//   chunk scan has room since its tables stay in global memory; their Gp
//   sums reduce per block as dG does.
//
// Suffix-radiance tier (K8), for more than MAX_GRAD_TEXS texture rows,
//   where weight planes (6 floats a row a lane) do not fit: each lane runs
//   each sample twice from the same counter-RNG draws. Phase A traces it,
//   owns the image and the hard slots' tangents, and sums the path's
//   radiance T; phase B replays it bounce for bounce, sums the prefix P
//   after each bounce, and routes g * [th at an emission + (T - P) / at at
//   a non-dielectric hit] to the hit's eff row: what a path radiates after
//   a hit is proportional to that hit's attenuation at, so one division
//   gives d radiance / d at (0 where |at| <= 1e-8: a channel of albedo
//   exactly 0 gets no scatter gradient, the JAX estimator's known limit).
//   The routes add into a per-block 3 * NT accumulator in shared memory
//   (5.5 KB at bouncing_spheres' 460 rows) with float atomicAdd, where the
//   JAX kernel reduces 128-wide one-hot rows; the carry gains the phase, T
//   and P (7 rows). The cost is about two forward passes, whatever NT is.
//
// Reductions: Gp (K3) per block by a shuffle tree in each warp and then the
//   4 warps in order; dG (K4) per block by one thread per slot summing the
//   block's 128 lanes in order. One partial row per block (3NT tex entries,
//   then K hard ones); the wrapper sums the rows. Outside the suffix tier
//   there are no float atomics, so those gradients are the same on every
//   run; the suffix tier's per-block sums take its atomics' order, so its
//   dG_tex may differ in the last bits from run to run.
//
// RNG: the PCG4D counter hash keyed per (pixel, absolute sample, mixed
//   seed) with the tags camera 0x0CA4, bounce 0x4000000 + b and medium
//   1000000 + b, bit-identical to utils/rng.py, so the kernel and its plain
//   torch version draw the same numbers and compare per pixel.
//
// What bounds it on the card: operations. Intersection, shading, the light
//   sample and the RNG are fp32 and integer ALU work on data in registers
//   and shared memory, with branch divergence (lanes of a warp take
//   different material branches and finish their paths at different
//   times); device-memory traffic is negligible: 12 floats read and 3 (or
//   17) written per lane, plus 3 cotangent floats and (3*NT + 9*K) carry
//   floats each way in the grad pass. The grad pass adds 3*NTMAX
//   multiply-adds per radiance event and per scatter for K3, and for K4 one
//   dual evaluation of the bounce's continuous physics per slot: each slot
//   costs about two to three times a float bounce's shading arithmetic
//   (the selection loop over primitives runs once, in the float pass).
//   The JVP itself needs about a seventh of that: each dual pass redoes
//   the values and pushes tangents through table constants (chip_smoke.py
//   counts the tangent work alone for the bound).
// What this first design does about it: nothing yet. It is the simple,
//   correct version; speed is later work (values once per bounce; a slot
//   whose tangent is provably zero this bounce could skip its dual pass).
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
#define VROW_COLS 8     // sphere chunk row: c0 xyz, cdelta xyz, radius, id
#define QROW_COLS 20    // quad chunk row: corner, u, v, normal, d, w, id, 0 0 0
#define SEED_SPH 1
#define SEED_MATF 2

// Mirrored field by field by ops/wavefront_cuda.py::_Params (ctypes).
struct WfParams {
    int n_lanes, n_pix, width, n_strata, max_depth, n_samples, sample_start;
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
// tested one by one from the scene table), and n_box floats of boxes.
struct VsParams {
    int C_small, n_big, Cq, off_rows, off_qrows, off_box, n_box;
};

// ------------------------------------------------------------ dual numbers
// A value and one tangent. The tangent rules are torch's forward-mode
// formulas (derivatives.yaml), so the kernel and the plain version's
// torch.func.jvp differentiate alike, up to rounding.
struct Dual { float v, t; };

__device__ __forceinline__ Dual dual(float v, float t) {
    Dual r; r.v = v; r.t = t; return r;
}
__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }
template <typename T> __device__ __forceinline__ T lift(float v);
template <> __device__ __forceinline__ float lift<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ Dual lift<Dual>(float v) {
    return dual(v, 0.0f);
}

__device__ __forceinline__ Dual operator-(Dual a) { return dual(-a.v, -a.t); }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
    return dual(a.v + b.v, a.t + b.t);
}
__device__ __forceinline__ Dual operator+(Dual a, float b) {
    return dual(a.v + b, a.t);
}
__device__ __forceinline__ Dual operator+(float a, Dual b) {
    return dual(a + b.v, b.t);
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
    return dual(a.v - b.v, a.t - b.t);
}
__device__ __forceinline__ Dual operator-(Dual a, float b) {
    return dual(a.v - b, a.t);
}
__device__ __forceinline__ Dual operator-(float a, Dual b) {
    return dual(a - b.v, -b.t);
}
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
    return dual(a.v * b.v, a.t * b.v + a.v * b.t);
}
__device__ __forceinline__ Dual operator*(Dual a, float b) {
    return dual(a.v * b, a.t * b);
}
__device__ __forceinline__ Dual operator*(float a, Dual b) {
    return dual(a * b.v, a * b.t);
}
// d(a/b) = (da - db * q) / b
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
    float q = a.v / b.v;
    return dual(q, (a.t - b.t * q) / b.v);
}
__device__ __forceinline__ Dual operator/(Dual a, float b) {
    return dual(a.v / b, a.t / b);
}
__device__ __forceinline__ Dual operator/(float a, Dual b) {
    float q = a / b.v;
    return dual(q, (-b.t * q) / b.v);
}

__device__ __forceinline__ float ssqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual ssqrt(Dual a) {
    float r = sqrtf(a.v);
    return dual(r, a.t / (2.0f * r));
}
// max / min against a constant: the tangent passes where the argument is
// kept, ties included (torch.clamp)
__device__ __forceinline__ float smax(float a, float c) { return fmaxf(a, c); }
__device__ __forceinline__ Dual smax(Dual a, float c) {
    return dual(fmaxf(a.v, c), a.v >= c ? a.t : 0.0f);
}
__device__ __forceinline__ float smin(float a, float c) { return fminf(a, c); }
__device__ __forceinline__ Dual smin(Dual a, float c) {
    return dual(fminf(a.v, c), a.v <= c ? a.t : 0.0f);
}
// min of two: half of each tangent on a tie (torch.minimum)
__device__ __forceinline__ Dual smin(Dual a, Dual b) {
    float t = a.v == b.v ? 0.5f * (a.t + b.t) : (a.v < b.v ? a.t : b.t);
    return dual(fminf(a.v, b.v), t);
}
// the earlier of two on a tie (a running torch.min over a dimension)
template <typename T>
__device__ __forceinline__ T first_min(T a, T b) {
    return val(b) < val(a) ? b : a;
}
__device__ __forceinline__ float sabs(float x) { return fabsf(x); }
__device__ __forceinline__ Dual sabs(Dual a) {
    return dual(fabsf(a.v), a.v > 0.0f ? a.t : (a.v < 0.0f ? -a.t : 0.0f));
}
__device__ __forceinline__ float ssin(float x) { return sinf(x); }
__device__ __forceinline__ Dual ssin(Dual a) {
    return dual(sinf(a.v), cosf(a.v) * a.t);
}
__device__ __forceinline__ float spow5(float x) { return powf(x, 5.0f); }
__device__ __forceinline__ Dual spow5(Dual a) {
    return dual(powf(a.v, 5.0f), a.t * 5.0f * powf(a.v, 4.0f));
}

// ----------------------------------------------------------------- vectors
template <typename T> struct V3T { T x, y, z; };
typedef V3T<float> V3;
template <typename A, typename B> struct Pr { typedef Dual T; };
template <> struct Pr<float, float> { typedef float T; };

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

// The one hard-parameter scalar a dual pass differentiates by: the table
// cell it perturbs (tab 0 in the float pass: no tangent anywhere).
struct Seed { int tab, row, col; };

template <typename T>
__device__ __forceinline__ T seeded(float v, bool on);
template <>
__device__ __forceinline__ float seeded<float>(float v, bool) { return v; }
template <>
__device__ __forceinline__ Dual seeded<Dual>(float v, bool on) {
    return dual(v, on ? 1.0f : 0.0f);
}
// sphere row `row`, column `col` (center 0-2, radius 6)
template <typename T>
__device__ __forceinline__ T rd_sph(const Scene& sc, int row, int col,
                                    Seed s) {
    return seeded<T>(sc.sph[row * SPH_COLS + col],
                     s.tab == SEED_SPH && s.row == row && s.col == col);
}
// material m's fuzz (col 0) or IOR (col 1)
template <typename T>
__device__ __forceinline__ T rd_matf(const Scene& sc, int m, int col,
                                     Seed s) {
    return seeded<T>(sc.matf[m * 2 + col],
                     s.tab == SEED_MATF && s.row == m && s.col == col);
}
// light row l's copy of its source sphere's center (cols 1-3, sphere
// columns 0-2) or radius (col 7, sphere column 6)
template <typename T>
__device__ __forceinline__ T rd_light(const Scene& sc, int l, int col,
                                      Seed s) {
    const int src = (int)sc.lsrc[l];
    const int scol = col == 7 ? 6 : col - 1;
    return seeded<T>(sc.light[l * LIGHT_COLS + col],
                     s.tab == SEED_SPH && s.row == src && s.col == scol);
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

// Does the ray meet box b between T_MIN and t_far? (the JAX kernel's
// box_any slab test, per ray; an empty chunk's box is [BIG, -BIG])
__device__ __forceinline__ bool box_reaches(const float* b, V3 o, V3 inv,
                                            float t_far) {
    if (b[0] > b[3]) return false;
    const float t0x = (b[0] - o.x) * inv.x, t1x = (b[3] - o.x) * inv.x;
    const float t0y = (b[1] - o.y) * inv.y, t1y = (b[4] - o.y) * inv.y;
    const float t0z = (b[2] - o.z) * inv.z, t1z = (b[5] - o.z) * inv.z;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), T_MINF));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fminf(fmaxf(t0z, t1z), t_far));
    return tn <= tf;
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

// one quad chunk's rows (K7)
__device__ __forceinline__ void scan_quads(const float* __restrict__ rows,
                                           V3 o, V3 d, float& best_t,
                                           int& best) {
    for (int r = 0; r < VCHUNK; ++r) {
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

// closest_select over the chunk scan's tables (K6, K7): the big block
// first (it often holds the ground, which tightens every later cull), then
// each sphere chunk whose box the ray meets before its best t, then the
// quads. The winner and its t are closest_select's over all primitives:
// every test is the same float32 arithmetic, the culls are conservative,
// and ties go to the lower unified id whatever the walk's order.
// The sphere rows (C * VCHUNK, VROW_COLS) and quad rows (Cq * VCHUNK,
// QROW_COLS) are read from global memory at V.off_rows / V.off_qrows of
// vtab, the (widened) chunk boxes (C + Cq, 6: lo xyz, hi xyz) from `box` in
// shared memory.
static __device__ int closest_select_vscan(const Scene& sc,
                                           const VsParams& V,
                                           const float* __restrict__ vtab,
                                           const float* box, V3 o, V3 d,
                                           float tm, float* t_best) {
    float best_t = BIGF;
    int best = -1;
    const float a = dot(d, d);
    const float eps = 1e-12f;
    const V3 inv = v3(
        1.0f / (fabsf(d.x) < eps ? (d.x < 0.0f ? -eps : eps) : d.x),
        1.0f / (fabsf(d.y) < eps ? (d.y < 0.0f ? -eps : eps) : d.y),
        1.0f / (fabsf(d.z) < eps ? (d.z < 0.0f ? -eps : eps) : d.z));
    const float* rows = vtab + V.off_rows;
    if (V.n_big > 0)
        scan_spheres(rows + (size_t)V.C_small * VCHUNK * VROW_COLS, V.n_big,
                     false, o, d, a, tm, best_t, best);
    for (int c = 0; c < V.C_small; ++c) {
        if (box_reaches(box + 6 * c, o, inv, best_t))
            scan_spheres(rows + (size_t)c * VCHUNK * VROW_COLS, VCHUNK, true,
                         o, d, a, tm, best_t, best);
    }
    if (V.Cq > 0) {
        const float* qrows = vtab + V.off_qrows;
        const float* qbox = box + 6 * (V.C_small + (V.n_big > 0));
        for (int k = 0; k < V.Cq; ++k) {
            if (box_reaches(qbox + 6 * k, o, inv, best_t))
                scan_quads(qrows + (size_t)k * VCHUNK * QROW_COLS, o, d,
                           best_t, best);
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
                              V3T<T> o, V3T<T> d, float tm, Seed sd) {
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
                               float u_sel, float u1, float u2, Seed sd) {
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
                       Seed sd) {
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
};

// (ops/integrator.py::bounce_step) the bounce after selection, for the
// winner `best` (-1: no surface) at t best_t, in place: rad gets the
// radiance increment, and o, d, th the next ray state where the path goes
// on (a path that ends keeps its last state in the carry). Returns whether
// it goes on. T = float is the forward bounce; T = Dual its derivative
// along (o, d, th)'s tangent and the seeded table cell's. NTMAX > 0 (float
// only) also updates the tex_color weight planes at the radiance events
// and the scatter (wavefront_pallas.py:2565-2603): Wp[3t+c] = d th_c /
// d tex_color[t][c], Gp its cotangent sums, gc the lane's cotangent. ev
// (float only; nullptr elsewhere) gets a hit's suffix-tier event. sw (float
// only; nullptr elsewhere) holds the same planes in shared memory instead,
// for 17 to 32 rows (K3v): plane k of Wp at sw[k * WF_THREADS], of Gp at
// sw[(n_sw + k) * WF_THREADS], this thread's column, n_sw = 3 * NT; the
// updates are the register planes', operation for operation.
template <typename T, int NTMAX>
__device__ __forceinline__ bool physics(
        const Scene& sc, const WfParams& P, const float* cam, int best,
        float best_t, V3T<T>& o, V3T<T>& d, V3T<T>& th, V3T<T>& rad,
        float tm, const float* u, const float* u_med, Seed sd,
        float (&Wp)[NTMAX > 0 ? 3 * NTMAX : 1],
        float (&Gp)[NTMAX > 0 ? 3 * NTMAX : 1], const float (&gc)[3],
        SfxEv* ev = nullptr, float* sw = nullptr, int n_sw = 0) {
    constexpr bool FLOAT = std::is_same<T, float>::value;
    float* sg = sw + n_sw * WF_THREADS;
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
            if (sw) {
                const float sk[3] = {sky.x, sky.y, sky.z};
                for (int k = 0; k < n_sw; ++k)
                    sg[k * WF_THREADS] = sg[k * WF_THREADS]
                        + gc[k % 3] * sw[k * WF_THREADS] * sk[k % 3];
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
            if (sw) {
                const float tv[3] = {tc.x, tc.y, tc.z};
                for (int k = 0; k < n_sw; ++k)
                    sg[k * WF_THREADS] = sg[k * WF_THREADS] + gc[k % 3] * (
                        sw[k * WF_THREADS] * tv[k % 3]
                        + (eff == k / 3 ? tt[k % 3] : 0.0f));
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
            if (sw) {
                const float av[3] = {at.x, at.y, at.z};
                const int row = is_diel ? -1 : eff;
                for (int k = 0; k < n_sw; ++k)
                    sw[k * WF_THREADS] = (sw[k * WF_THREADS] * av[k % 3]
                        + (row == k / 3 ? tt[k % 3] : 0.0f)) * factor;
            }
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

// One thread's lane: its samples and bounces. NTMAX > 0 adds the tex_color
// weight planes of the JAX kernel's grad_tex variant
// (wavefront_pallas.py:2347-2349, 2392-2395, 2565-2603): Wp[3t+c] =
// d th_c / d tex_color[t][c] rides the lane's path state (and the carry,
// rows 14..14+3NT), and Gp[3t+c] accumulates g_c * d(radiance_c)/d tex at
// each radiance event, g the lane's cotangent. NTMAX is the compile-time
// bound of NT, so every plane index is a constant after unrolling. HARD
// adds the K tangent bundles (see the top of this file). SUFFIX is the
// suffix-radiance tier of tex_color (K8, see the top of this file). `red` is
// the block's (WF_THREADS / 32, 3 * NTMAX) shared scratch of the end-of-pass
// reduction (NTMAX > 0 only).
//
// Shared memory (smem): the tables (the chunk scan: its boxes), padded to
// plane_base; then (HARD) the tangent planes and their sums, 10 * K *
// WF_THREADS floats; then (SUFFIX) the block's 3 * NT tex_color
// accumulators, or (SPLANES) the weight planes Wp and Gp, 2 * 3 * NT *
// WF_THREADS floats, for 17 to 32 rows that do not fit in registers.
template <int NTMAX, bool HARD, bool VSCAN = false, bool SUFFIX = false,
          bool SPLANES = false>
__device__ __forceinline__ void wavefront_body(
        const WfParams& P, const float* __restrict__ tables,
        const int* __restrict__ pix_lanes,
        const float* __restrict__ carry_in, const float* __restrict__ cot,
        float* __restrict__ rad_out, float* __restrict__ carry_out,
        float* __restrict__ dg_out, int* __restrict__ iters_out,
        float* smem, float* cam, float* red, VsParams V = VsParams(),
        const float* __restrict__ vtab = nullptr) {
    constexpr bool GRAD = NTMAX > 0 || HARD || SUFFIX || SPLANES;
    static_assert(!SUFFIX || NTMAX == 0, "the suffix tier has no planes");
    static_assert(!SPLANES || (NTMAX == 0 && !SUFFIX),
                  "shared-memory planes replace the register planes");
    const int plane_base = VSCAN ? table_pad(V.n_box) : table_pad(P.n_table);
    float* acc = smem + plane_base + (HARD ? 10 * P.K * WF_THREADS : 0);
    if constexpr (SUFFIX) {
        for (int i = threadIdx.x; i < 3 * P.NT; i += blockDim.x) acc[i] = 0.0f;
    }
    if constexpr (VSCAN) {
        // the chunk scan reads the scene tables from global memory and
        // keeps only the chunk boxes in shared memory
        for (int i = threadIdx.x; i < V.n_box; i += blockDim.x)
            smem[i] = vtab[V.off_box + i];
    } else {
        for (int i = threadIdx.x; i < P.n_table; i += blockDim.x)
            smem[i] = tables[i];
    }
    if (threadIdx.x < 22) cam[threadIdx.x] = P.cam[threadIdx.x];
    __syncthreads();

    // the entry points launch whole blocks of lanes only (the grad pass
    // reduces across the block, so no thread may leave early)
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const int N = P.n_lanes;

    Scene sc;
    const float* tab = VSCAN ? tables : smem;
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
    const int pix = pix_lanes ? pix_lanes[lane]
                              : (lane < P.n_pix ? lane : P.n_pix - 1);
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
    const int n_wp = (NTMAX > 0 || SPLANES) ? 3 * P.NT : 0;
    // the shared-memory planes: Wp then Gp, [plane][thread] after the
    // tangent planes (acc's place), this thread's column
    float* sw = acc + threadIdx.x;
    if constexpr (SPLANES) {
        for (int k = 0; k < n_wp; ++k) {
            sw[k * WF_THREADS] = carry_in ? carry_in[(14 + k) * N + lane]
                                          : 0.0f;
            sw[(n_wp + k) * WF_THREADS] = 0.0f;
        }
    }
    // the suffix tier's lane state: the phase (false: A traces the sample,
    // true: B replays it), A's path total T and B's prefix P (carry rows
    // 14 + 9K .. 14 + 9K + 6)
    bool phB = false;
    V3 Tt = v3(0.0f, 0.0f, 0.0f), Pp = v3(0.0f, 0.0f, 0.0f);
    if constexpr (SUFFIX) {
        if (carry_in) {
            const float* cs = carry_in + (size_t)(14 + 9 * P.K) * N + lane;
            phB = cs[0] > 0.5f;
            Tt = v3(cs[1 * N], cs[2 * N], cs[3 * N]);
            Pp = v3(cs[4 * N], cs[5 * N], cs[6 * N]);
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
    if constexpr (HARD) {
        for (int j = 0; j < 9 * P.K; ++j)
            dst[j * WF_THREADS] = carry_in
                ? carry_in[(14 + n_wp + j) * N + lane] : 0.0f;
        for (int k = 0; k < P.K; ++k) dgs[k * WF_THREADS] = 0.0f;
    }

    int it = 0;
    for (; work && (P.cap == 0 || it < P.cap); ++it) {
        // a finished path restarts on the pixel's next stratified sample;
        // in the suffix tier a finished phase-A path first replays the same
        // sample as phase B (the counter RNG draws the same numbers), and a
        // finished phase B moves to the next sample's phase A
        if (!alive) {
            if constexpr (SUFFIX) {
                if (phB) {
                    sample += 1;
                    Tt = v3(0.0f, 0.0f, 0.0f);
                }
                phB = !phB;
                Pp = v3(0.0f, 0.0f, 0.0f);
            } else {
                sample += 1;
            }
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
            if constexpr (SPLANES) {
                for (int k = 0; k < n_wp; ++k) sw[k * WF_THREADS] = 0.0f;
            }
            if constexpr (HARD) {
                for (int j = 0; j < 9 * P.K; ++j) dst[j * WF_THREADS] = 0.0f;
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
        if constexpr (VSCAN)
            best = closest_select_vscan(sc, V, vtab, smem, o, d, tm,
                                        &best_t);
        else
            best = closest_select(sc, o, d, tm, &best_t);
        const V3 o0 = o, d0 = d, th0 = th;
        // the suffix tier takes the bounce's radiance increment apart
        V3 drad = v3(0.0f, 0.0f, 0.0f);
        SfxEv ev;
        ev.hit = false;
        const bool alive_new = physics<float, NTMAX>(
            sc, P, cam, best, best_t, o, d, th, SUFFIX ? drad : rad, tm, u,
            u_med, Seed{0, 0, 0}, Wp, Gp, gc, SUFFIX ? &ev : nullptr,
            SPLANES ? sw : nullptr, SPLANES ? n_wp : 0);
        if constexpr (SUFFIX) {
            if (!phB) {
                // phase A owns the image and the path total
                rad = add(rad, drad);
                Tt = add(Tt, drad);
            } else {
                // phase B: the prefix after this bounce's events, and the
                // hit's events routed to its eff row: g * th at an
                // emission, g * (T - P) / at at a non-dielectric hit (what
                // the path radiates after it is proportional to its
                // attenuation; 0 where |at| <= 1e-8)
                Pp = add(Pp, drad);
                if (ev.hit && ev.eff >= 0) {
                    const float tv[3] = {th0.x, th0.y, th0.z};
                    const float sf[3] = {Tt.x - Pp.x, Tt.y - Pp.y,
                                         Tt.z - Pp.z};
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const float e = ev.emit ? tv[c] : 0.0f;
                        float sc_ = 0.0f;
                        if (!ev.diel && fabsf(ev.at[c]) > 1e-8f)
                            sc_ = sf[c] / ev.at[c];
                        const float v = gc[c] * (e + sc_);
                        if (v != 0.0f) atomicAdd(acc + 3 * ev.eff + c, v);
                    }
                }
            }
        }
        if constexpr (HARD) {
            // one dual pass per slot: the same bounce from the same ray and
            // selection, along slot k's tangent, so the same outcome. Phase
            // B's events repeat phase A's: the tangents count in A only
            // (the planes stay 0 from B's regeneration on)
            const int n_dual = (SUFFIX && phB) ? 0 : P.K;
            float nw[1], ng[1];
#pragma unroll 1
            for (int k = 0; k < n_dual; ++k) {
                float* ds = dst + 9 * k * WF_THREADS;
                const float* sl = sc.slot + SLOT_COLS * k;
                const Seed sd = {(int)sl[0], (int)sl[1], (int)sl[2]};
                V3T<Dual> od, dd, td, rd;
                od.x = dual(o0.x, ds[0 * WF_THREADS]);
                od.y = dual(o0.y, ds[1 * WF_THREADS]);
                od.z = dual(o0.z, ds[2 * WF_THREADS]);
                dd.x = dual(d0.x, ds[3 * WF_THREADS]);
                dd.y = dual(d0.y, ds[4 * WF_THREADS]);
                dd.z = dual(d0.z, ds[5 * WF_THREADS]);
                td.x = dual(th0.x, ds[6 * WF_THREADS]);
                td.y = dual(th0.y, ds[7 * WF_THREADS]);
                td.z = dual(th0.z, ds[8 * WF_THREADS]);
                rd = lift3<Dual>(v3(0.0f, 0.0f, 0.0f));
                physics<Dual, 0>(sc, P, cam, best, best_t, od, dd, td, rd,
                                 tm, u, u_med, sd, nw, ng, gc);
                dgs[k * WF_THREADS] = dgs[k * WF_THREADS]
                    + (gc[0] * rd.x.t + gc[1] * rd.y.t + gc[2] * rd.z.t);
                if (alive_new) {
                    ds[0 * WF_THREADS] = od.x.t;
                    ds[1 * WF_THREADS] = od.y.t;
                    ds[2 * WF_THREADS] = od.z.t;
                    ds[3 * WF_THREADS] = dd.x.t;
                    ds[4 * WF_THREADS] = dd.y.t;
                    ds[5 * WF_THREADS] = dd.z.t;
                    ds[6 * WF_THREADS] = td.x.t;
                    ds[7 * WF_THREADS] = td.y.t;
                    ds[8 * WF_THREADS] = td.z.t;
                }
            }
        }
        bounce += 1;
        alive = alive_new && bounce < P.max_depth;
        work = alive || (sample + 1 < P.n_samples);
        // a finished phase-A path still owes its replay
        if constexpr (SUFFIX) work = work || !phB;
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
        if constexpr (SPLANES) {
            for (int k = 0; k < n_wp; ++k)
                carry_out[(14 + k) * N + lane] = sw[k * WF_THREADS];
        }
        if constexpr (HARD) {
            for (int j = 0; j < 9 * P.K; ++j)
                carry_out[(14 + n_wp + j) * N + lane] = dst[j * WF_THREADS];
        }
        if constexpr (SUFFIX) {
            float* cs = carry_out + (size_t)(14 + 9 * P.K) * N + lane;
            cs[0] = phB ? 1.0f : 0.0f;
            cs[1 * N] = Tt.x; cs[2 * N] = Tt.y; cs[3 * N] = Tt.z;
            cs[4 * N] = Pp.x; cs[5 * N] = Pp.y; cs[6 * N] = Pp.z;
        }
    }
    if constexpr (GRAD) {
        // one partial row per block: 3NT tex entries, then K hard ones,
        // each summed in a fixed order (the suffix tier's tex entries are
        // its shared accumulators, added to by float atomics)
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
        __syncthreads();
        if constexpr (NTMAX > 0) {
            if (threadIdx.x < n_wp) {
                float s = 0.0f;
                for (int w = 0; w < WF_THREADS / 32; ++w)
                    s += red[w * 3 * NTMAX + threadIdx.x];
                dg_out[blockIdx.x * n_row + threadIdx.x] = s;
            }
        }
        if constexpr (SUFFIX) {
            for (int i = threadIdx.x; i < n_tex; i += blockDim.x)
                dg_out[blockIdx.x * n_row + i] = acc[i];
        }
        if constexpr (SPLANES) {
            // Gp: plane k's 128 lanes in lane order
            if (threadIdx.x < n_wp) {
                const float* col = acc + (n_wp + threadIdx.x) * WF_THREADS;
                float s = 0.0f;
                for (int i = 0; i < WF_THREADS; ++i) s += col[i];
                dg_out[blockIdx.x * n_row + threadIdx.x] = s;
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

// The library is built from this file in parts, each part a translation
// unit of its own, compiled in parallel and linked into one shared library
// (ops/wavefront_cuda.py::build_library): WF_PART 0 holds the forward
// instances, the unrolled grad instances and every C entry point; 1 the
// chunk scan's weight-plane grad instances for at most 16 rows (K3v, with
// K4v); 2 its hard-slot-only and suffix instances (K4v, K8); 3 its
// shared-memory weight planes for 17 to 32 rows (K3v, with K4v). Without
// WF_PART the file holds all of them.
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

// The pointers of one grad launch.
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
};

// the chunk scan's grad launchers (parts 1 and 2)
int launch_vgrad_planes(const WfParams& P, const VsParams& V,
                        const GradArgs& A, cudaStream_t stream);
int launch_vgrad_other(const WfParams& P, const VsParams& V,
                       const GradArgs& A, cudaStream_t stream);
int launch_vgrad_splanes(const WfParams& P, const VsParams& V,
                         const GradArgs& A, cudaStream_t stream);

// The chunk scan's grad passes (K3v weight planes, K4v tangent bundles,
// K8 the suffix-radiance tier, each with the carry of K5): the unrolled
// grad kernel's tiers over closest_select_vscan. The winner's original id
// indexes the scene tables (global memory), so physics<T> and the slot
// table's aliasing are the unrolled kernel's; shared memory holds the
// chunk boxes, the tangent planes and the suffix accumulators or (SPLANES,
// 17 to 32 rows) the weight planes.
template <int NTMAX, bool HARD, bool SUFFIX, bool SPLANES = false>
__global__ void __launch_bounds__(WF_THREADS)
wavefront_grad_vscan_kernel(WfParams P, VsParams V, GradArgs A) {
    __shared__ float cam[22];
    __shared__ float red[(WF_THREADS / 32) * 3 * (NTMAX > 0 ? NTMAX : 1)];
    wavefront_body<NTMAX, HARD, true, SUFFIX, SPLANES>(
        P, A.tables, A.pix_lanes, A.carry_in, A.cot, A.rad_out, A.carry_out,
        A.dg_out, A.iters_out, wf_tables, cam, red, V, A.vtab);
}

template <int NTMAX, bool HARD, bool SUFFIX, bool SPLANES = false>
static int launch_grad_vscan(const WfParams& P, const VsParams& V,
                             const GradArgs& A, cudaStream_t stream) {
    const size_t floats = (size_t)table_pad(V.n_box)
        + (HARD ? (size_t)10 * P.K * WF_THREADS : 0)
        + (SUFFIX ? (size_t)3 * P.NT : 0)
        + (SPLANES ? (size_t)6 * P.NT * WF_THREADS : 0);
    const size_t smem = floats * sizeof(float);
    cudaError_t e = set_smem(
        (const void*)
            wavefront_grad_vscan_kernel<NTMAX, HARD, SUFFIX, SPLANES>,
        smem);
    if (e != cudaSuccess) return (int)e;
    wavefront_grad_vscan_kernel<NTMAX, HARD, SUFFIX, SPLANES>
        <<<P.n_lanes / WF_THREADS, WF_THREADS, smem, stream>>>(P, V, A);
    return (int)cudaGetLastError();
}

#if WF_IN_PART(1)
// weight planes for NT <= 16, with or without tangent bundles
int launch_vgrad_planes(const WfParams& P, const VsParams& V,
                        const GradArgs& A, cudaStream_t stream) {
    if (P.K == 0)
        return P.NT <= 8 ? launch_grad_vscan<8, false, false>(P, V, A, stream)
                         : launch_grad_vscan<16, false, false>(P, V, A,
                                                               stream);
    return P.NT <= 8 ? launch_grad_vscan<8, true, false>(P, V, A, stream)
                     : launch_grad_vscan<16, true, false>(P, V, A, stream);
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
// weight planes for 17 to 32 rows, in shared memory, with or without
// tangent bundles
int launch_vgrad_splanes(const WfParams& P, const VsParams& V,
                         const GradArgs& A, cudaStream_t stream) {
    return P.K == 0 ? launch_grad_vscan<0, false, false, true>(P, V, A,
                                                               stream)
                    : launch_grad_vscan<0, true, false, true>(P, V, A,
                                                              stream);
}
#endif

#if WF_IN_PART(0)
// The forward pass (K1, K2).
extern "C" __global__ void __launch_bounds__(WF_THREADS)
wavefront_forward_kernel(WfParams P, const float* __restrict__ tables,
                         const int* __restrict__ pix_lanes,
                         const float* __restrict__ carry_in,
                         float* __restrict__ rad_out,
                         float* __restrict__ carry_out,
                         int* __restrict__ iters_out) {
    __shared__ float cam[22];
    wavefront_body<0, false>(P, tables, pix_lanes, carry_in, nullptr,
                             rad_out, carry_out, nullptr, iters_out,
                             wf_tables, cam, nullptr);
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
    wavefront_body<0, false, true>(P, tables, pix_lanes, carry_in, nullptr,
                                   rad_out, carry_out, nullptr, iters_out,
                                   wf_tables, cam, nullptr, V, vtab);
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
    wavefront_body<NTMAX, HARD>(P, tables, pix_lanes, carry_in, cot,
                                rad_out, carry_out, dg_out, iters_out,
                                wf_tables, cam, red);
}

// Plain C entry points (bound with ctypes). Each launches on `stream` and
// returns cudaGetLastError(): a launch that is refused never runs, and only
// this reports it.
extern "C" int rt_wavefront_forward(const WfParams* params,
                                    const float* tables, const int* pix_lanes,
                                    const float* carry_in, float* rad_out,
                                    float* carry_out, int* iters_out,
                                    void* stream) {
    const WfParams P = *params;
    if (P.n_lanes % WF_THREADS != 0) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)P.n_table * sizeof(float);
    cudaError_t e = set_smem((const void*)wavefront_forward_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    wavefront_forward_kernel<<<P.n_lanes / WF_THREADS, WF_THREADS, smem,
                               (cudaStream_t)stream>>>(
        P, tables, pix_lanes, carry_in, rad_out, carry_out, iters_out);
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
        || V.n_big > VCHUNK || V.Cq < 0 || V.n_box < 6 * V.C_small)
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
        return P.NT <= 8 ? launch_grad<8, false>(WF_GRAD_ARGS)
                         : launch_grad<16, false>(WF_GRAD_ARGS);
    if (!P.want_tex) return launch_grad<0, true>(WF_GRAD_ARGS);
    return P.NT <= 8 ? launch_grad<8, true>(WF_GRAD_ARGS)
                     : launch_grad<16, true>(WF_GRAD_ARGS);
#undef WF_GRAD_ARGS
}

// The chunk scan's grad passes: dg_out as rt_wavefront_grad's; P.suffix
// selects the suffix tier (3 * NT accumulator entries in place of the
// weight planes' 3 * NT, and its 7 carry rows after the tangent planes).
extern "C" int rt_wavefront_grad_vscan(const WfParams* params,
                                       const VsParams* vparams,
                                       const float* tables,
                                       const float* vtab,
                                       const int* pix_lanes,
                                       const float* carry_in,
                                       const float* cot, float* rad_out,
                                       float* carry_out, float* dg_out,
                                       int* iters_out, void* stream) {
    const WfParams P = *params;
    const VsParams V = *vparams;
    if (P.n_lanes % WF_THREADS != 0 || V.C_small < 1 || V.n_big < 0
        || V.n_big > VCHUNK || V.Cq < 0 || V.n_box < 6 * V.C_small
        || P.K < 0 || P.K > MAX_SLOTS
        || (P.suffix && (!P.want_tex || P.NT < 1))
        || (!P.suffix && P.want_tex && (P.NT < 1 || P.NT > 32))
        || (!P.want_tex && P.K == 0))
        return (int)cudaErrorInvalidValue;
    const GradArgs A = {tables, vtab, pix_lanes, carry_in, cot, rad_out,
                        carry_out, dg_out, iters_out};
    cudaStream_t s = (cudaStream_t)stream;
    if (P.want_tex && !P.suffix)
        return P.NT <= 16 ? launch_vgrad_planes(P, V, A, s)
                          : launch_vgrad_splanes(P, V, A, s);
    return launch_vgrad_other(P, V, A, s);
}
#endif  // WF_IN_PART(0)
