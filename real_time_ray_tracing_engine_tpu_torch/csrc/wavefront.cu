// Persistent-lane path-tracing megakernel for Hopper (sm_90a): the forward
// pass and the forward-mode tex_color gradient pass, one bounce body.
//
// Replaces: real_time_ray_tracing_engine_tpu/ops/wavefront_pallas.py
//   _make_kernel, reached through the one pl.pallas_call at line 3604 of
//   _render_pass_pallas, in three variants: the unrolled-prim forward (K1),
//   its capped/resume variant (K2), and grad_tex=True with want_tex and
//   NT <= 32, the weight-plane tier (K3: 865-873, 2347-2349, 2565-2603,
//   3192-3204, 3249-3263), which the compacted grad driver runs capped and
//   resumed (K5, 3807-3888; driver in ops/wavefront_cuda.py).
//
// Shape: one thread per lane (pixel), the reference engine's own
//   static_render_kernel shape (CameraKernels.cu:240-278). Each thread loops
//   over its pixel's samples and bounces in registers, regenerating a
//   finished path onto the next stratified sample exactly as the Pallas
//   kernel's `bounce` does (wavefront_pallas.py:2360-2391). Scene tables
//   (a few KB inside the kernel gate) are copied into shared memory at block
//   start; the radiance sum is written once per lane.
//
// Capped / resume (K2): with cap > 0 a thread stops after `cap` loop
//   iterations and spills a 14-row carry [work, alive, bounce, sample,
//   time, o xyz, d xyz, th xyz]; with carry_in it resumes from one, and
//   pix_lanes gives the lane -> pixel permutation of the compacted driver
//   (ops/wavefront_cuda.py). A lane advances one bounce per iteration and
//   freezes once its work is done, so its carry after `cap` iterations is
//   the Pallas per-tile loop's, lane for lane.
//
// Gradient (K3): wavefront_body<true, NTMAX> is the same bounce with the
//   weight planes Wp (3*NTMAX floats a thread, d throughput / d tex_color,
//   reset on regeneration, appended to the carry as rows 14..14+3NT) and
//   their cotangent sums Gp (3*NTMAX floats), both indexed by constants
//   after unrolling. The image is the forward's, bit for bit: the same
//   code traces the same paths. At the end Gp is reduced over the block
//   (warp shuffles, then the 4 warps in order) into one partial row per
//   block; the wrapper sums the rows. No float atomics, so dG_tex is the
//   same on every run. NTMAX is 8 (Cornell: NT = 6) or 16 (the gate's
//   MAX_TEXS).
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
//   17) written per lane, plus 3 cotangent floats and 3*NT carry floats
//   each way in the grad pass. The grad pass adds 3*NTMAX multiply-adds
//   per radiance event and per scatter, and Wp may spill to local memory
//   (ptxas reports it at build).
// What this first design does about it: nothing yet. It is the simple,
//   correct version; speed is later work.
//
// Arithmetic follows the plain torch integrator (ops/intersect.py,
//   materials.py, lights.py, textures.py) operation for operation, in the
//   same order. Built with --fmad=false and without --use_fast_math: FMA
//   contraction changed last bits against torch's eager ops, and over a
//   depth-50 path those flipped branches (Schlick, quad edges) in 3.4% of
//   Cornell pixels.

#include <cuda_runtime.h>
#include <stdint.h>

#define WF_THREADS 128
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

// Mirrored field by field by ops/wavefront_cuda.py::_Params (ctypes).
struct WfParams {
    int n_lanes, n_pix, width, n_strata, max_depth, n_samples, sample_start;
    unsigned int seed_mix, perlin_seed;
    int sky_gradient, has_noise, checker_depth, cap;
    int S, Q, L, M, MS, MQ, NT;
    int off_sph, off_quad, off_pmat, off_light, off_mati, off_matf, off_tex,
        off_med, med_cols, n_table;
    float inv_strata;
    float cam[22];  // center, pixel00, pixel_du, pixel_dv, defocus_u,
                    // defocus_v, defocus_on, background
};

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 v3(float x, float y, float z) {
    V3 r; r.x = x; r.y = y; r.z = z; return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
    return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
    return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 mul(V3 a, float s) {
    return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x);
}
// a / max(|a|, 1e-8), as utils/vecmath.normalize
__device__ __forceinline__ V3 normalize(V3 a) {
    float l = fmaxf(sqrtf(dot(a, a)), 1e-8f);
    return v3(a.x / l, a.y / l, a.z / l);
}
__device__ __forceinline__ V3 ld3(const float* t) {
    return v3(t[0], t[1], t[2]);
}
__device__ __forceinline__ float safe_sqrt(float x) {
    return sqrtf(fmaxf(x, 1e-12f));
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
__device__ float noise3(float px, float py, float pz, uint32_t seed) {
    float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
    int ix = (int)fx, iy = (int)fy, iz = (int)fz;
    float u = px - fx, v = py - fy, w = pz - fz;
    float su = u * u * (3.0f - 2.0f * u);
    float sv = v * v * (3.0f - 2.0f * v);
    float sw = w * w * (3.0f - 2.0f * w);
    float acc = 0.0f;
    for (int di = 0; di < 2; ++di) {
        float wu = di ? su : 1.0f - su;
        for (int dj = 0; dj < 2; ++dj) {
            float wv = dj ? sv : 1.0f - sv;
            for (int dk = 0; dk < 2; ++dk) {
                float ww = dk ? sw : 1.0f - sw;
                uint32_t a = (uint32_t)(ix + di), b = (uint32_t)(iy + dj),
                         c = (uint32_t)(iz + dk), d = seed;
                pcg4d(a, b, c, d);
                float gx = 2.0f * to_unit(a) - 1.0f;
                float gy = 2.0f * to_unit(b) - 1.0f;
                float gz = 2.0f * to_unit(c) - 1.0f;
                float inv = rsqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-12f));
                gx *= inv; gy *= inv; gz *= inv;
                float dd = gx * (u - (float)di) + gy * (v - (float)dj)
                    + gz * (w - (float)dk);
                acc = acc + (wu * wv * ww) * dd;
            }
        }
    }
    return acc;
}

__device__ float turbulence3(float px, float py, float pz, uint32_t seed) {
    float acc = 0.0f, weight = 1.0f;
    for (int o = 0; o < 7; ++o) {
        acc = acc + weight * fabsf(
            noise3(px, py, pz, seed + (uint32_t)o * 0x9E3779B9u));
        weight *= 0.5f;
        px *= 2.0f; py *= 2.0f; pz *= 2.0f;
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
    int S, Q, L, M, MS, MQ, med_cols, checker_depth, has_noise;
    uint32_t perlin_seed;
};

// (ops/textures.py) descend nested checkers to a solid or noise leaf; *eff
// gets the leaf's row, the tex_color row the color depends on, or -1 for a
// noise leaf (textures.effective_row)
__device__ V3 texture_value(const Scene& sc, int row, V3 p, int* eff) {
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
    const float* t = sc.tex + row * TEX_COLS;
    if (sc.has_noise && t[13] > 0.5f) {
        float turb = turbulence3(p.x, p.y, p.z, sc.perlin_seed);
        float g = 0.5f * (1.0f + sinf(t[3] * p.z + 10.0f * turb));
        *eff = -1;
        return v3(g, g, g);
    }
    *eff = row;
    return ld3(t);
}

struct Hit {
    bool hit, front;
    float t;
    V3 p, n;
    int mat;
};

// (ops/intersect.py::closest_hit) spheres then quads; a later prim wins only
// when strictly closer, so ties go to the lowest unified prim id
__device__ Hit closest_hit(const Scene& sc, V3 o, V3 d, float tm) {
    float best_t = BIGF;
    int best = -1;
    float a = dot(d, d);
    for (int s = 0; s < sc.S; ++s) {
        const float* r = sc.sph + s * SPH_COLS;
        float rad = r[6];
        if (!(r[7] > 0.5f) || !(rad > 0.0f)) continue;
        V3 c = v3(r[0] + tm * r[3], r[1] + tm * r[4], r[2] + tm * r[5]);
        V3 oc = sub(c, o);
        float h = dot(d, oc);
        float cc = dot(oc, oc) - rad * rad;
        float disc = h * h - a * cc;
        if (!(disc > 0.0f)) continue;
        float sq = safe_sqrt(disc);
        float r0 = (h - sq) / a, r1 = (h + sq) / a;
        bool in0 = (r0 > T_MINF) && (r0 < BIGF);
        bool in1 = (r1 > T_MINF) && (r1 < BIGF);
        if (!(in0 || in1)) continue;
        float t = in0 ? r0 : r1;
        if (t < best_t) { best_t = t; best = s; }
    }
    for (int q = 0; q < sc.Q; ++q) {
        const float* r = sc.quad + q * QUAD_COLS;
        if (!(r[17] > 0.5f)) continue;
        float denom = d.x * r[9] + d.y * r[10] + d.z * r[11];
        bool par = fabsf(denom) < 1e-8f;
        float odn = o.x * r[9] + o.y * r[10] + o.z * r[11];
        float t = (r[12] - odn) / (par ? 1.0f : denom);
        float plx = o.x + t * d.x - r[0];
        float ply = o.y + t * d.y - r[1];
        float plz = o.z + t * d.z - r[2];
        float alpha = r[13] * (ply * r[8] - plz * r[7])
            + r[14] * (plz * r[6] - plx * r[8])
            + r[15] * (plx * r[7] - ply * r[6]);
        float beta = r[13] * (r[4] * plz - r[5] * ply)
            + r[14] * (r[5] * plx - r[3] * plz)
            + r[15] * (r[3] * ply - r[4] * plx);
        bool ok = !par && alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f
            && beta <= 1.0f && t > T_MINF && t < BIGF;
        if (ok && t < best_t) { best_t = t; best = sc.S + q; }
    }
    Hit h;
    h.hit = best_t < BIGF * 0.5f;
    h.t = best_t;
    h.mat = 0;
    h.front = false;
    h.p = v3(0.0f, 0.0f, 0.0f);
    h.n = v3(1.0f, 0.0f, 0.0f);
    if (!h.hit) return h;
    h.mat = (int)sc.pmat[best];
    h.p = add(o, mul(d, best_t));
    if (best < sc.S) {
        const float* r = sc.sph + best * SPH_COLS;
        V3 c = v3(r[0] + tm * r[3], r[1] + tm * r[4], r[2] + tm * r[5]);
        float rr = fmaxf(r[6], 1e-12f);
        V3 out = sub(h.p, c);
        out = v3(out.x / rr, out.y / rr, out.z / rr);
        h.front = dot(d, out) < 0.0f;
        h.n = h.front ? out : neg(out);
    } else {
        const float* r = sc.quad + (best - sc.S) * QUAD_COLS;
        V3 nn = v3(r[9], r[10], r[11]);
        h.front = dot(d, nn) < 0.0f;
        h.n = h.front ? nn : neg(nn);
    }
    return h;
}

// (ops/intersect.py::quad_ts) plane hit + inside test over the whole line;
// BIG when missed. q points at corner, u, v, normal, d, w (16 floats).
__device__ __forceinline__ float quad_t_any(const float* q, V3 o, V3 d,
                                            float t_min) {
    float denom = d.x * q[9] + d.y * q[10] + d.z * q[11];
    bool par = fabsf(denom) < 1e-8f;
    float odn = o.x * q[9] + o.y * q[10] + o.z * q[11];
    float t = (q[12] - odn) / (par ? 1.0f : denom);
    float plx = o.x + t * d.x - q[0];
    float ply = o.y + t * d.y - q[1];
    float plz = o.z + t * d.z - q[2];
    float alpha = q[13] * (ply * q[8] - plz * q[7])
        + q[14] * (plz * q[6] - plx * q[8])
        + q[15] * (plx * q[7] - ply * q[6]);
    float beta = q[13] * (q[4] * plz - q[5] * ply)
        + q[14] * (q[5] * plx - q[3] * plz)
        + q[15] * (q[3] * ply - q[4] * plx);
    bool ok = !par && alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f
        && beta <= 1.0f && t > t_min && t < BIGF;
    return ok ? t : BIGF;
}

// (ops/intersect.py::medium_scatter) exponential free flight inside each
// medium's boundary; returns the nearest scattering t (BIG if none) and the
// medium row in *row (lowest row on ties)
__device__ float medium_free_flight(const Scene& sc, V3 o, V3 d, float t_surf,
                                    const float* u_med, int* row) {
    float a = dot(d, d);
    float raylen = sqrtf(a);
    float t_best = BIGF;
    *row = 0;
    for (int m = 0; m < sc.M; ++m) {
        const float* r = sc.med + m * sc.med_cols;
        // pass 1: entry = nearest crossing of the boundary union
        float entry = BIGF;
        for (int pass = 0; pass < 2; ++pass) {
            float exit_ = BIGF;
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
                    entry = fminf(entry, fminf(t0, t1));
                } else {
                    if (t0 > entry + 1e-4f) exit_ = fminf(exit_, t0);
                    if (t1 > entry + 1e-4f) exit_ = fminf(exit_, t1);
                }
            }
            for (int jq = 0; jq < sc.MQ; ++jq) {
                const float* q = r + 2 + 4 * sc.MS + 17 * jq;
                float t = q[16] > 0.5f ? quad_t_any(q, o, d, -BIGF) : BIGF;
                if (pass == 0) entry = fminf(entry, t);
                else if (t > entry + 1e-4f) exit_ = fminf(exit_, t);
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
                    if (t_med < t_best) { t_best = t_med; *row = m; }
                }
            }
        }
    }
    return t_best;
}

// orthonormal basis around w (utils/vecmath.onb_from_w): returns u, v and
// the normalized w
__device__ __forceinline__ void onb_from_w(V3 w_in, V3& u, V3& v, V3& w) {
    w = normalize(w_in);
    V3 aa = fabsf(w.x) > 0.9f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
    v = normalize(cross(w, aa));
    u = cross(w, v);
}

__device__ __forceinline__ V3 onb_local(V3 u, V3 v, V3 w, V3 a) {
    return v3(a.x * u.x + a.y * v.x + a.z * w.x,
              a.x * u.y + a.y * v.y + a.z * w.y,
              a.x * u.z + a.y * v.z + a.z * w.z);
}

__device__ __forceinline__ V3 unit_vector_from_uv(float u1, float u2) {
    float z = 1.0f - 2.0f * u1;
    float r = sqrtf(fmaxf(1.0f - z * z, 1e-12f));
    float phi = TWO_PI_F * u2;
    return v3(r * cosf(phi), r * sinf(phi), z);
}

// (ops/lights.py::light_sample) unit direction toward a uniformly chosen
// light
__device__ V3 light_sample(const Scene& sc, V3 o, float tm, float u_sel,
                           float u1, float u2) {
    int n = sc.L > 1 ? sc.L : 1;
    int l = (int)(u_sel * (float)n);
    l = l < 0 ? 0 : (l > n - 1 ? n - 1 : l);
    const float* r = sc.light + l * LIGHT_COLS;
    V3 dir;
    if (r[0] > 0.5f) {
        V3 c = v3(r[1] + tm * r[4], r[2] + tm * r[5], r[3] + tm * r[6]);
        V3 to_c = sub(c, o);
        float dist2 = fmaxf(dot(to_c, to_c), 1e-12f);
        float rad = r[7];
        float ratio = fminf(fmaxf(1.0f - rad * rad / dist2, 0.0f), 1.0f);
        float z = 1.0f + u2 * (safe_sqrt(ratio) - 1.0f);
        float phi = TWO_PI_F * u1;
        float s = safe_sqrt(1.0f - z * z);
        V3 bu, bv, bw;
        onb_from_w(to_c, bu, bv, bw);
        dir = onb_local(bu, bv, bw, v3(cosf(phi) * s, sinf(phi) * s, z));
    } else {
        V3 pt = v3(r[8] + u1 * r[11] + u2 * r[14],
                   r[9] + u1 * r[12] + u2 * r[15],
                   r[10] + u1 * r[13] + u2 * r[16]);
        dir = sub(pt, o);
    }
    return normalize(dir);
}

// (ops/lights.py::light_pdf_value) uniform-average solid-angle pdf
__device__ float light_pdf(const Scene& sc, V3 o, V3 d, float tm) {
    float total = 0.0f;
    for (int l = 0; l < sc.L; ++l) {
        const float* r = sc.light + l * LIGHT_COLS;
        float pdf = 0.0f;
        if (r[0] > 0.5f) {
            float rad = r[7];
            V3 c = v3(r[1] + tm * r[4], r[2] + tm * r[5], r[3] + tm * r[6]);
            V3 oc = sub(c, o);
            float a = dot(d, d);
            float h = dot(d, oc);
            float dist2 = dot(oc, oc);
            float disc = h * h - a * (dist2 - rad * rad);
            float sq = safe_sqrt(disc);
            float r0 = (h - sq) / a, r1 = (h + sq) / a;
            bool hit = disc > 0.0f && rad > 0.0f
                && ((r0 > T_MINF && r0 < BIGF) || (r1 > T_MINF && r1 < BIGF));
            if (hit) {
                float ratio = fminf(fmaxf(
                    1.0f - rad * rad / fmaxf(dist2, 1e-12f), 0.0f), 1.0f);
                float solid = TWO_PI_F * (1.0f - safe_sqrt(ratio));
                pdf = 1.0f / fmaxf(solid, 1e-12f);
            }
        } else {
            float t = quad_t_any(r + 8, o, d, T_MINF);
            if (t < BIGF * 0.5f) {
                float cosine = fabsf(d.x * r[17] + d.y * r[18] + d.z * r[19]);
                pdf = t * t / fmaxf(cosine * r[24], 1e-12f);
            }
        }
        total += pdf;
    }
    return total / (float)(sc.L > 1 ? sc.L : 1);
}

// (models/camera.py::generate_rays) camera ray for absolute sample s_abs;
// returns the normalized direction
__device__ void gen_ray(const WfParams& P, const float* cam, uint32_t k0,
                        uint32_t k2, float fi, float fj, int s_abs, V3& o,
                        V3& d, float& tm) {
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

// the scene tables, copied in at block start (dynamic shared memory)
extern __shared__ float wf_tables[];

// One thread's lane: its samples and bounces, in registers. GRAD adds the
// tex_color weight planes of the JAX kernel's grad_tex variant
// (wavefront_pallas.py:2347-2349, 2392-2395, 2565-2603): Wp[3t+c] =
// d th_c / d tex_color[t][c] rides the lane's path state (and the carry,
// rows 14..14+3NT), and Gp[3t+c] accumulates g_c * d(radiance_c)/d tex at
// each radiance event, g the lane's cotangent. NTMAX is the compile-time
// bound of NT, so every plane index is a constant after unrolling.
// `red` is the block's (WF_THREADS / 32, 3 * NTMAX) shared scratch of the
// end-of-pass reduction (GRAD only).
template <bool GRAD, int NTMAX>
__device__ __forceinline__ void wavefront_body(
        const WfParams& P, const float* __restrict__ tables,
        const int* __restrict__ pix_lanes,
        const float* __restrict__ carry_in, const float* __restrict__ cot,
        float* __restrict__ rad_out, float* __restrict__ carry_out,
        float* __restrict__ dg_out, int* __restrict__ iters_out,
        float* smem, float* cam, float* red) {
    for (int i = threadIdx.x; i < P.n_table; i += blockDim.x)
        smem[i] = tables[i];
    if (threadIdx.x < 22) cam[threadIdx.x] = P.cam[threadIdx.x];
    __syncthreads();

    // the entry points launch whole blocks of lanes only (the grad pass
    // reduces across the block, so no thread may leave early)
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const int N = P.n_lanes;

    Scene sc;
    sc.sph = smem + P.off_sph;
    sc.quad = smem + P.off_quad;
    sc.pmat = smem + P.off_pmat;
    sc.light = smem + P.off_light;
    sc.mati = smem + P.off_mati;
    sc.matf = smem + P.off_matf;
    sc.tex = smem + P.off_tex;
    sc.med = smem + P.off_med;
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
    const V3 bg = v3(cam[19], cam[20], cam[21]);

    // weight planes (path state) and their cotangent sums (per pass);
    // planes t >= NT stay 0: no hit reads their row
    float Wp[GRAD ? 3 * NTMAX : 1];
    float Gp[GRAD ? 3 * NTMAX : 1];
    float gc[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (GRAD) {
        const int n_wp = 3 * P.NT;
#pragma unroll
        for (int k = 0; k < 3 * NTMAX; ++k) {
            Wp[k] = (carry_in && k < n_wp) ? carry_in[(14 + k) * N + lane]
                                           : 0.0f;
            Gp[k] = 0.0f;
        }
        gc[0] = cot[0 * N + lane];
        gc[1] = cot[1 * N + lane];
        gc[2] = cot[2 * N + lane];
    }

    int it = 0;
    for (; work && (P.cap == 0 || it < P.cap); ++it) {
        // a finished path restarts on the pixel's next stratified sample
        if (!alive) {
            sample += 1;
            gen_ray(P, cam, k0, k2, fi, fj, P.sample_start + sample, o, d,
                    tm);
            th = v3(1.0f, 1.0f, 1.0f);
            bounce = 0;
            alive = true;
            if constexpr (GRAD) {
                // a fresh path starts with throughput 1: no tex dependence
#pragma unroll
                for (int k = 0; k < 3 * NTMAX; ++k) Wp[k] = 0.0f;
            }
        }
        const uint32_t k1 = (uint32_t)(P.sample_start + sample);
        float u[9];
        draws(k0, k1, k2, 0x4000000u + (uint32_t)bounce, u, 9);

        Hit h = closest_hit(sc, o, d, tm);
        if (sc.M > 0) {
            float u_med[4];
            draws(k0, k1, k2, 1000000u + (uint32_t)bounce, u_med, sc.M);
            int mrow;
            float t_med = medium_free_flight(sc, o, d, h.hit ? h.t : BIGF,
                                             u_med, &mrow);
            if (t_med < BIGF * 0.5f) {
                h.hit = true;
                h.t = t_med;
                h.p = add(o, mul(d, t_med));
                h.n = v3(1.0f, 0.0f, 0.0f);
                h.front = true;
                h.mat = (int)sc.med[mrow * sc.med_cols + sc.med_cols - 1];
            }
        }

        bool alive_new = false;
        if (!h.hit) {
            V3 sky = bg;
            if (P.sky_gradient) {
                float as = 0.5f * (d.y + 1.0f);
                sky = v3((1.0f - as) + as * 0.5f, (1.0f - as) + as * 0.7f,
                         (1.0f - as) + as * 1.0f);
            }
            rad = v3(rad.x + th.x * sky.x, rad.y + th.y * sky.y,
                     rad.z + th.z * sky.z);
            if constexpr (GRAD) {
                // miss: the background is tex-independent, so only the
                // throughput's planes carry it
                const float sk[3] = {sky.x, sky.y, sky.z};
#pragma unroll
                for (int k = 0; k < 3 * NTMAX; ++k)
                    Gp[k] = Gp[k] + gc[k % 3] * Wp[k] * sk[k % 3];
            }
        } else {
            const int mtype = (int)sc.mati[h.mat * 2 + 0];
            const int mtex = (int)sc.mati[h.mat * 2 + 1];
            int eff;
            const V3 tc = texture_value(sc, mtex, h.p, &eff);
            const bool is_light = mtype == MAT_DIFFUSE_LIGHT;
            const bool is_metal = mtype == MAT_METAL;
            const bool is_diel = mtype == MAT_DIELECTRIC;
            const bool is_iso = mtype == MAT_ISOTROPIC;
            if (is_light && h.front) {
                rad = v3(rad.x + th.x * tc.x, rad.y + th.y * tc.y,
                         rad.z + th.z * tc.z);
                if constexpr (GRAD) {
                    // emission: through the throughput's planes, and
                    // directly through the emitter's own row
                    const float tv[3] = {tc.x, tc.y, tc.z};
                    const float tt[3] = {th.x, th.y, th.z};
#pragma unroll
                    for (int k = 0; k < 3 * NTMAX; ++k)
                        Gp[k] = Gp[k] + gc[k % 3] * (
                            Wp[k] * tv[k % 3]
                            + (eff == k / 3 ? tt[k % 3] : 0.0f));
                }
            }
            if (!is_light) {
                const V3 n = h.n;
                bool scatters = true;
                bool skip_pdf = is_metal || is_diel;
                V3 new_dir;
                float factor = 1.0f;
                bool pdf_ok = true;
                if (is_metal) {
                    float fuzz = sc.matf[h.mat * 2 + 0];
                    V3 refl = normalize(sub(d, mul(n, 2.0f * dot(d, n))));
                    V3 jit = unit_vector_from_uv(u[D_FUZZ_U], u[D_FUZZ_V]);
                    new_dir = normalize(add(refl, mul(jit, fuzz)));
                    scatters = dot(new_dir, n) > 0.0f;
                } else if (is_diel) {
                    float ior = sc.matf[h.mat * 2 + 1];
                    float ri = h.front ? 1.0f / ior : ior;
                    float cos_t = fminf(dot(neg(d), n), 1.0f);
                    float sin_t = safe_sqrt(1.0f - cos_t * cos_t);
                    bool cannot = ri * sin_t > 1.0f;
                    float r0 = (1.0f - ri) / (1.0f + ri);
                    r0 = r0 * r0;
                    float schlick = r0 + (1.0f - r0) * powf(1.0f - cos_t, 5.0f);
                    if (cannot || schlick > u[D_REFL]) {
                        new_dir = normalize(sub(d, mul(n, 2.0f * dot(d, n))));
                    } else {
                        V3 perp = mul(add(d, mul(n, cos_t)), ri);
                        float par = -safe_sqrt(fabsf(1.0f - dot(perp, perp)));
                        new_dir = normalize(add(perp, mul(n, par)));
                    }
                } else {
                    // MIS: 0.5 * light pdf + 0.5 * material pdf
                    V3 mdir;
                    if (is_iso) {
                        mdir = unit_vector_from_uv(u[D_MAT_U], u[D_MAT_V]);
                    } else {
                        V3 bu, bv, bw;
                        onb_from_w(n, bu, bv, bw);
                        float phm = TWO_PI_F * u[D_MAT_U];
                        float sq2 = sqrtf(fmaxf(u[D_MAT_V], 1e-12f));
                        float zc = sqrtf(fmaxf(1.0f - u[D_MAT_V], 1e-12f));
                        mdir = normalize(onb_local(
                            bu, bv, bw, v3(cosf(phm) * sq2, sinf(phm) * sq2,
                                           zc)));
                    }
                    float pdf_val;
                    V3 gdir = mdir;
                    float cosv = fmaxf(dot(gdir, n), 0.0f) / PI_F;
                    if (sc.L > 0) {
                        if (u[D_PICK] < 0.5f)
                            gdir = light_sample(sc, h.p, tm, u[D_LIGHT_SEL],
                                                u[D_LIGHT_U], u[D_LIGHT_V]);
                        cosv = fmaxf(dot(gdir, n), 0.0f) / PI_F;
                        float mpdf = is_iso ? INV_4PI_F : cosv;
                        pdf_val = 0.5f * light_pdf(sc, h.p, gdir, tm)
                            + 0.5f * mpdf;
                    } else {
                        pdf_val = is_iso ? INV_4PI_F : cosv;
                    }
                    float spdf = is_iso ? INV_4PI_F : cosv;
                    pdf_ok = pdf_val > 1e-8f;
                    factor = spdf / (pdf_ok ? pdf_val : 1.0f);
                    new_dir = gdir;
                }
                alive_new = scatters && (skip_pdf || pdf_ok);
                // a path that ends keeps its last state in the carry
                if (alive_new) {
                    V3 at = is_diel ? v3(1.0f, 1.0f, 1.0f) : tc;
                    if constexpr (GRAD) {
                        // product rule through th <- th * at * factor: at
                        // is the eff row's color except for a dielectric
                        // (at = 1), and factor never depends on tex_color
                        const float av[3] = {at.x, at.y, at.z};
                        const float tt[3] = {th.x, th.y, th.z};
                        const int row = is_diel ? -1 : eff;
#pragma unroll
                        for (int k = 0; k < 3 * NTMAX; ++k)
                            Wp[k] = (Wp[k] * av[k % 3]
                                     + (row == k / 3 ? tt[k % 3] : 0.0f))
                                * factor;
                    }
                    th = v3(th.x * at.x * factor, th.y * at.y * factor,
                            th.z * at.z * factor);
                    o = h.p;
                    d = new_dir;
                }
            }
        }
        bounce += 1;
        alive = alive_new && bounce < P.max_depth;
        work = alive || (sample + 1 < P.n_samples);
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
        if constexpr (GRAD) {
            const int n_wp = 3 * P.NT;
#pragma unroll
            for (int k = 0; k < 3 * NTMAX; ++k)
                if (k < n_wp) carry_out[(14 + k) * N + lane] = Wp[k];
        }
    }
    if constexpr (GRAD) {
        // Gp summed over the block in a fixed order: a shuffle tree in each
        // warp, then the warps in order; one partial row per block, summed
        // over blocks by the wrapper (no float atomics)
        const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
        for (int k = 0; k < 3 * NTMAX; ++k) {
            float v = Gp[k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v += __shfl_down_sync(0xffffffffu, v, off);
            if (wl == 0) red[warp * 3 * NTMAX + k] = v;
        }
        __syncthreads();
        const int n_wp = 3 * P.NT;
        if (threadIdx.x < n_wp) {
            float s = 0.0f;
            for (int w = 0; w < WF_THREADS / 32; ++w)
                s += red[w * 3 * NTMAX + threadIdx.x];
            dg_out[blockIdx.x * n_wp + threadIdx.x] = s;
        }
    }
}

// The forward pass (K1, K2).
extern "C" __global__ void __launch_bounds__(WF_THREADS)
wavefront_forward_kernel(WfParams P, const float* __restrict__ tables,
                         const int* __restrict__ pix_lanes,
                         const float* __restrict__ carry_in,
                         float* __restrict__ rad_out,
                         float* __restrict__ carry_out,
                         int* __restrict__ iters_out) {
    __shared__ float cam[22];
    wavefront_body<false, 1>(P, tables, pix_lanes, carry_in, nullptr,
                             rad_out, carry_out, nullptr, iters_out,
                             wf_tables, cam, nullptr);
}

// The forward pass plus the tex_color weight planes (K3; K5 under the
// compacted driver), for NT <= NTMAX texture rows.
template <int NTMAX>
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
    __shared__ float red[(WF_THREADS / 32) * 3 * NTMAX];
    wavefront_body<true, NTMAX>(P, tables, pix_lanes, carry_in, cot,
                                rad_out, carry_out, dg_out, iters_out,
                                wf_tables, cam, red);
}

// dynamic shared memory for the scene tables, raised past the default 48 KB
// where a scene needs it
static cudaError_t table_smem(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
    cudaError_t e = table_smem((const void*)wavefront_forward_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    wavefront_forward_kernel<<<P.n_lanes / WF_THREADS, WF_THREADS, smem,
                               (cudaStream_t)stream>>>(
        P, tables, pix_lanes, carry_in, rad_out, carry_out, iters_out);
    return (int)cudaGetLastError();
}

template <int NTMAX>
static int launch_grad(const WfParams& P, const float* tables,
                       const int* pix_lanes, const float* carry_in,
                       const float* cot, float* rad_out, float* carry_out,
                       float* dg_out, int* iters_out, cudaStream_t stream) {
    const size_t smem = (size_t)P.n_table * sizeof(float);
    cudaError_t e = table_smem((const void*)wavefront_grad_kernel<NTMAX>,
                               smem);
    if (e != cudaSuccess) return (int)e;
    wavefront_grad_kernel<NTMAX><<<P.n_lanes / WF_THREADS, WF_THREADS, smem,
                                   stream>>>(
        P, tables, pix_lanes, carry_in, cot, rad_out, carry_out, dg_out,
        iters_out);
    return (int)cudaGetLastError();
}

// dg_out: (n_lanes / WF_THREADS, 3 * NT) per-block partial sums
extern "C" int rt_wavefront_grad(const WfParams* params,
                                 const float* tables, const int* pix_lanes,
                                 const float* carry_in, const float* cot,
                                 float* rad_out, float* carry_out,
                                 float* dg_out, int* iters_out,
                                 void* stream) {
    const WfParams P = *params;
    if (P.n_lanes % WF_THREADS != 0 || P.NT < 1 || P.NT > 16)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (P.NT <= 8)
        return launch_grad<8>(P, tables, pix_lanes, carry_in, cot, rad_out,
                              carry_out, dg_out, iters_out, s);
    return launch_grad<16>(P, tables, pix_lanes, carry_in, cot, rad_out,
                           carry_out, dg_out, iters_out, s);
}
