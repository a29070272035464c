// K6: affine-consistency Gauss-Newton against the first-frame template, for
// a feature batch (modes 0 translation, 1 similarity, 2 full affine).
//
// Replaces pyfeaturetrack_tpu/ops/pallas_affine_vec.py (K6: _vec_affine_raw,
// _affine_vec_kernel; public vec_affine_track_batch and
// vec_affine_with_fallback) and pyfeaturetrack_tpu/ops/pallas_affine_fused.py
// (K7: fused_affine_track_batch, _affine_kernel), the serial kernel that
// recomputes the vec kernel's "stale" lanes.
// Both exist on the TPU because a Pallas block holds only a fixed corridor
// of the image around each feature; a lane whose warped footprint leaves it
// needs another kernel. This kernel reads every bilinear tap from global
// memory, so any footprint is in reach and one kernel covers both.
//
// The arithmetic is that of ops/affine._affine_track_batch (affine.py:100-177
// of the JAX package), lane for lane:
//   * warped samples x + A00 i + A01 j, y + A10 i + A11 j; any sample outside
//     [0, W - 1.001] x [0, H - 1.001] makes the lane OOB (a warp vote);
//   * bilinear taps of img2, gx2, gy2 with the top-left tap clamped to
//     [0, W-2] x [0, H-2], blended (1-a)(1-b) p00 + a(1-b) p01 + (1-a) b p10
//     + a b p11 in that order (interp.py:14-35);
//   * the P(P+1)/2 entries of J J^T and the P entries of J (tmpl - I2w), each
//     a per-lane ascending sum then an xor butterfly (16, 8, 4, 2, 1), the
//     order ops/cuda_lk.tree_sum reproduces in the plain version: window
//     sample p belongs to lane p mod 32 at row k = p div 32;
//   * unpivoted Gauss-Jordan with det (ops/linalg.gauss_solve_det order:
//     |pivot| < 1e-30 divides by 1, every row eliminated, then row k
//     replaced), SMALL_DET on |det| < min_determinant, the update of x, y, A
//     by mode and the convergence test on affine_min_displacement;
//   * after the loop: warp OOB, then LARGE_RESIDUE (mean |tmpl - I2w|), then
//     drift beyond affine_max_displacement_differ (OOB), each only for a lane
//     still TRACKED. Unchecked lanes pass through with status TRACKED.
//
// The level-0 images are float32 or bfloat16 (cfg.image_dtype): the storage
// type is a template parameter, each tap is upcast to float32 where it is
// read, and templates, warps and sums stay float32.
//
// Two entries share that loop (affine_gn): pft_affine_track, the batch of
// ops/cuda_affine.affine_track_batch, and pft_affine_stage, the whole
// affine-consistency stage of ops/affine.affine_consistency_check (lost
// lanes, template capture, the check, the selects on the feature list and
// the AffineState) in one launch, where the eager stage took some 170.
//
// What bounds it on this card: neither bytes nor FLOPs (1000 features x a
// few iterations x 225 samples x 3 images is about a microsecond of either)
// but the serial path of the features that iterate longest: each
// Gauss-Newton iteration is a round of dependent bilinear taps, 27 sums and
// a 6x7 solve whose pivots follow one another, and a feature that never
// meets affine_min_displacement runs all affine_max_iterations of them; a
// launch ends with its slowest feature, later still when that feature's
// block waits for a slot behind earlier ones. On one warp a feature's
// iteration took about 3.3 us; spread as below, about 1.4 us.
// Design: that path is spread over a feature's threads. A feature gets WPF
// warps (ops/cuda_affine.launch_shape: one a row of 32 samples, at most 8;
// a window of more rows walks them WPF at a time) and each thread takes the
// window sample of its lane at the rows of its warp: its offsets and
// template value once, each iteration its taps, blends and products, which
// go to shared memory as float4 by row, lane and group of four sums. Warp w
// then adds up groups w, w + WPF, ... lane by lane over the rows in
// ascending order and runs one butterfly for a group's four sums, pairing
// them in the first two levels; every add takes the one-warp butterfly's
// operands, so every sum is the one-warp sum bit for bit. Every warp then
// solves the system with a column of [J J^T | J diff] a lane and updates
// x, y and the warp itself: the warps compute the same bits, so no
// broadcast and no barrier follows the solve. Each pivot step broadcasts
// the pivot column by shuffle, divides once a lane and eliminates with a
// multiply and a subtract an element, each element with its own sequence of
// operations. A zero dividend (the eliminated entries) is answered by its
// signed zero, as the division would: the division sends zeros to its slow
// path, some hundreds of cycles a step. All of a feature's branches are
// uniform, its barriers are named (one a feature, so features that share a
// block never wait for one another), and the bounds vote is one bar.red.or
// over the feature's threads, taken with the products. A feature leaves
// the loop as soon as it converges or fails, which equals the plain
// version's masked fixed-trip loop because an inactive lane changes
// nothing. The stage reads the lane's state and its thread's first
// template samples in one round trip, before the check. Blocks are capped
// at MIN_BLOCKS an SM's worth of registers, so that three features of 8
// warps share an SM; at four, 64 registers a thread, the spills cost what
// the fourth feature gains.
// Thread 0 of a feature writes its result and its Gauss-Newton update count.
// In the stage, it also adds to the device counters (common.cuh): the lane
// checked, its updates, and the lane when the check rejects it; at most
// three atomics a feature, on the slot of its feature.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;        // a block: at most 8 warps
constexpr int MIN_BLOCKS = 3;           // such blocks an SM holds: 85 registers a thread
constexpr int KLT_TRACKED = 0;
constexpr int KLT_SMALL_DET = -2;
constexpr int KLT_OOB = -4;
constexpr int KLT_LARGE_RESIDUE = -5;
constexpr float ONE_PLUS_EPS = 1.001f;  // ops/affine._ONE_PLUS_EPS
constexpr int CAPTURE_NIT = 5;          // ops/affine._CAPTURE_NIT
constexpr unsigned FULL = 0xffffffffu;

struct AffParams {
    int H, W, n, hw, hh, max_iterations;
    float min_displacement, min_determinant, max_residue, max_drift;
};

// The system's size by mode: NP parameters, the J J^T upper triangle (NTRI
// entries, row by row) then J diff, NS sums in all, in NG groups of four
// (the last padded with zeros); a lane's groups lie NGP float4 apart, NGP
// odd so that a quarter warp's 16-byte accesses meet no bank twice.
template <int MODE>
struct System {
    static constexpr int NP = MODE == 0 ? 2 : (MODE == 1 ? 4 : 6);
    static constexpr int NTRI = NP * (NP + 1) / 2;
    static constexpr int NS = NTRI + NP;
    static constexpr int NG = (NS + 3) / 4;
    static constexpr int NGP = NG | 1;
};

// A feature's shared memory: the products of a chunk of WPF window rows, the
// residues of one, the system, and what only the stage's outputs need.
template <int WPF, int MODE>
struct FeatureShared {
    float4 prod[WPF][32][System<MODE>::NGP];   // row of the chunk, lane, group
    float res[WPF][32];
    float sums[4 * System<MODE>::NG];
    float out[2];              // the stage's new anchor and nit, for the outputs
    int nit_out;
};
constexpr int CONTINUE = 0, CONVERGED = 1, SINGULAR = 2;

// This thread's place: feature f, warp w of its WPF warps, lane, and the
// feature's named barrier (1 + its index in the block; 0 is __syncthreads').
struct Feat {
    int f, w, lane, bar;
    __device__ bool first() const { return w == 0 && lane == 0; }
};

template <int WPF>
__device__ __forceinline__ void feat_sync(const Feat& F)
{
    asm volatile("bar.sync %0, %1;" ::"r"(F.bar), "n"(32 * WPF) : "memory");
}

// The feature's barrier, returning whether any of its threads holds p.
template <int WPF>
__device__ __forceinline__ bool feat_any(const Feat& F, bool p)
{
    int r;
    asm volatile(
        "{\n\t.reg .pred p, q;\n\tsetp.ne.s32 q, %1, 0;\n\t"
        "bar.red.or.pred p, %2, %3, q;\n\tselp.s32 %0, 1, 0, p;\n\t}"
        : "=r"(r)
        : "r"((int)p), "r"(F.bar), "n"(32 * WPF)
        : "memory");
    return r != 0;
}

__device__ __forceinline__ float warp_sum(float acc)
{
    for (int off = 16; off >= 1; off >>= 1)
        acc = acc + __shfl_xor_sync(FULL, acc, off);
    return acc;
}

// a / b, IEEE. A zero dividend (every entry of a column already
// eliminated) is divided as 1 and answered by its signed zero: the division
// sends a zero to its slow path, some hundreds of cycles.
__device__ __forceinline__ float divide(float a, float b)
{
    const float q = (a == 0.0f ? 1.0f : a) / b;
    return a == 0.0f && !isnan(b) ? __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                                                   0x80000000)
                                  : q;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b)
{
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// warp_sum of each of the four per-lane sums (x, y, z, w) in one butterfly:
// the first two levels pair them up, so every add takes the operands
// warp_sum's takes (in either order) and every result is warp_sum's bit for
// bit. The sums land on lanes 0 (x), 16 (y), 8 (z) and 24 (w).
__device__ __forceinline__ float warp_sum4(float4 a, int lane)
{
    const bool h16 = lane & 16, h8 = lane & 8;
    const float p = (h16 ? a.y : a.x) + __shfl_xor_sync(FULL, h16 ? a.x : a.y, 16);
    const float q = (h16 ? a.w : a.z) + __shfl_xor_sync(FULL, h16 ? a.z : a.w, 16);
    float r = (h8 ? q : p) + __shfl_xor_sync(FULL, h8 ? p : q, 8);
    for (int off = 4; off >= 1; off >>= 1) r = r + __shfl_xor_sync(FULL, r, off);
    return r;
}

__device__ __forceinline__ bool sample_out(float xs, float ys, const AffParams& P)
{
    return (xs < 0.0f) || ((float)P.W - xs < ONE_PLUS_EPS) ||
           (ys < 0.0f) || ((float)P.H - ys < ONE_PLUS_EPS);
}

// Top-left tap index and fractions of a bilinear sample (ops/interp.bilinear).
// The bound on the int conversion keeps runaway lanes defined; their taps
// are clamped into the image like every other lane's.
__device__ __forceinline__ int tap(float xs, float ys, const AffParams& P,
                                   float& ax, float& ay)
{
    const int xt = (int)fminf(fmaxf(floorf(xs), -1.0e8f), 1.0e8f);
    const int yt = (int)fminf(fmaxf(floorf(ys), -1.0e8f), 1.0e8f);
    ax = xs - (float)xt;
    ay = ys - (float)yt;
    const int x0 = min(max(xt, 0), P.W - 2);
    const int y0 = min(max(yt, 0), P.H - 2);
    return y0 * P.W + x0;
}

// Through the read-only data cache: the level images do not change in a launch.
template <typename TS>
__device__ __forceinline__ float blend(const TS* __restrict__ im, int i00, int W, float ax,
                                       float ay)
{
    const float p00 = pft_ldg(im + i00), p01 = pft_ldg(im + i00 + 1);
    const float p10 = pft_ldg(im + i00 + W), p11 = pft_ldg(im + i00 + W + 1);
    return (1.0f - ax) * (1.0f - ay) * p00 + ax * (1.0f - ay) * p01 +
           (1.0f - ax) * ay * p10 + ax * ay * p11;
}

// Column and row offsets (i - hw, j - hh) of window sample p.
__device__ __forceinline__ void offsets(int p, const AffParams& P, float& i, float& j)
{
    const int ww = 2 * P.hw + 1, r = p / ww;
    i = (float)(p - r * ww - P.hw);
    j = (float)(r - P.hh);
}

// A thread's window sample p: whether it lies in the window, its offsets
// and its template value.
struct Sample {
    bool in;
    float i, j, t;
};

__device__ __forceinline__ Sample sample_at(const float* __restrict__ tmf, const AffParams& P,
                                            int p, int npix)
{
    Sample s{p < npix, 0.0f, 0.0f, 0.0f};
    if (s.in) {
        offsets(p, P, s.i, s.j);
        s.t = tmf[p];
    }
    return s;
}

// Jacobian rows of one sample (ops/affine._jacobian).
template <int MODE>
__device__ __forceinline__ void jacobian(float gx, float gy, float i, float j,
                                         float (&J)[System<MODE>::NP])
{
    if (MODE == 0) {
        J[0] = gx;
        J[1] = gy;
    } else if (MODE == 1) {
        J[0] = gx * i + gy * j;
        J[1] = -gx * j + gy * i;
        J[2] = gx;
        J[3] = gy;
    } else {
        J[0] = gx * i;
        J[1] = gy * i;
        J[2] = gx * j;
        J[3] = gy * j;
        J[4] = gx;
        J[5] = gy;
    }
}

// The products of this thread's sample (zero past the window) into row w of
// the chunk; returns whether the warped sample is out of bounds.
template <int WPF, int MODE, typename TS>
__device__ __forceinline__ bool sample_products(const Sample& q, const TS* __restrict__ img2,
                                                const TS* __restrict__ gx2,
                                                const TS* __restrict__ gy2,
                                                const AffParams& P, const Feat& F, float x,
                                                float y, float a00, float a01, float a10,
                                                float a11, FeatureShared<WPF, MODE>& S)
{
    constexpr int NP = System<MODE>::NP, NG = System<MODE>::NG;
    float v[4 * NG] = {};
    bool out = false;
    if (q.in) {
        const float xs = x + a00 * q.i + a01 * q.j;
        const float ys = y + a10 * q.i + a11 * q.j;
        out = sample_out(xs, ys, P);
        float ax, ay;
        const int i00 = tap(xs, ys, P, ax, ay);
        const float diff = q.t - blend(img2, i00, P.W, ax, ay);
        float J[NP];
        jacobian<MODE>(blend(gx2, i00, P.W, ax, ay), blend(gy2, i00, P.W, ax, ay), q.i, q.j,
                       J);
        int s = 0;
#pragma unroll
        for (int a = 0; a < NP; ++a)
#pragma unroll
            for (int b = a; b < NP; ++b) v[s++] = J[a] * J[b];
#pragma unroll
        for (int a = 0; a < NP; ++a) v[s++] = J[a] * diff;
    }
#pragma unroll
    for (int g = 0; g < NG; ++g)
        S.prod[F.w][F.lane][g] =
            make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
    return out;
}

// Gauss-Jordan on each warp of the feature and the update of x, y and the
// warp: every warp computes the same bits, so the feature's warps need no
// broadcast. Element (r, c) of the augmented system [J J^T | J diff] lies
// on lane c + (NP + 1) h, h = r mod H, in slot r div H of that lane's
// RPL (the lanes past the H-th block of NP + 1 repeat its lanes). Each pivot step k broadcasts
// the pivot, the pivot row's element of each column and the pivot column's
// element of each row by shuffle, divides once a lane and eliminates with a
// multiply and a subtract an element, each element with its own sequence
// of operations. Returns CONTINUE, CONVERGED or SINGULAR (nothing updated).
template <int WPF, int MODE>
__device__ __forceinline__ int solve(const AffParams& P, const Feat& F, float& x, float& y,
                                     float& a00, float& a01, float& a10, float& a11,
                                     const FeatureShared<WPF, MODE>& S)
{
    constexpr int NP = System<MODE>::NP, NTRI = System<MODE>::NTRI, NC = NP + 1;
    constexpr int H = NP < 32 / NC ? NP : 32 / NC, RPL = (NP + H - 1) / H;
    const int c = F.lane % NC, h = min(F.lane / NC, H - 1);
    float el[RPL];
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
        const int r = h + H * j, a = min(r, c), b = max(r, c);   // the symmetric fill
        el[j] = r >= NP ? 0.0f
                        : S.sums[c == NP ? NTRI + r : a * NP - a * (a - 1) / 2 + (b - a)];
    }
    float det = 1.0f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
        const float piv = __shfl_sync(FULL, el[k / H], k + NC * (k % H));
        const float own = __shfl_sync(FULL, el[k / H], c + NC * (k % H));   // (k, c)
        float ck[RPL];                                                      // (r, k)
#pragma unroll
        for (int j = 0; j < RPL; ++j) ck[j] = __shfl_sync(FULL, el[j], k + NC * h);
        det = det * piv;
        const float safe = fabsf(piv) < 1e-30f ? 1.0f : piv;
        const float row = divide(own, safe);
#pragma unroll
        for (int j = 0; j < RPL; ++j) {
            const int r = h + H * j;
            el[j] = r == k ? row : el[j] - ck[j] * row;
        }
    }
    if (fabsf(det) < P.min_determinant) return SINGULAR;
    float d[NP];
#pragma unroll
    for (int r = 0; r < NP; ++r) d[r] = __shfl_sync(FULL, el[r / H], NP + NC * (r % H));
    float dx, dy;
    if (MODE == 0) {
        dx = d[0];
        dy = d[1];
    } else if (MODE == 1) {
        a00 = a00 + d[0];
        a01 = a01 + -d[1];
        a10 = a10 + d[1];
        a11 = a11 + d[0];
        dx = d[2];
        dy = d[3];
    } else {
        a00 = a00 + d[0];
        a10 = a10 + d[1];
        a01 = a01 + d[2];
        a11 = a11 + d[3];
        dx = d[4];
        dy = d[5];
    }
    x = x + dx;
    y = y + dy;
    return fabsf(dx) < P.min_displacement && fabsf(dy) < P.min_displacement ? CONVERGED
                                                                            : CONTINUE;
}

// The Gauss-Newton loop and the post-loop tests for the feature of F, run by
// all of its threads (ops/affine._affine_track_batch, one checked lane):
// template `tmf` ([wh * ww] samples), start (x, y) = (x0, y0) and warp a..,
// which come back updated (in every warp), with the status and the number
// of updates `it` (in warp 0). Shared by pft_affine_track and the stage.
template <int WPF, int MODE, typename TS>
__device__ void affine_gn(const float* __restrict__ tmf, const TS* __restrict__ img2,
                          const TS* __restrict__ gx2, const TS* __restrict__ gy2,
                          const AffParams& P, const Feat& F, FeatureShared<WPF, MODE>& S,
                          float x0, float y0, float& x, float& y, float& a00, float& a01,
                          float& a10, float& a11, int& status, int& it)
{
    constexpr int NS = System<MODE>::NS, NG = System<MODE>::NG;
    constexpr int GPW = (NG + WPF - 1) / WPF;    // groups of four sums a warp adds up
    const int npix = (2 * P.hw + 1) * (2 * P.hh + 1);
    const int rows = pft_ceil_div(npix, 32);
    const Sample first = sample_at(tmf, P, F.lane + 32 * F.w, npix);
    PFT_PHASE_START(clk);
    status = KLT_TRACKED;
    it = 0;
    for (int step = 0; step < P.max_iterations; ++step) {
        // the samples, WPF rows a chunk; the vote over all of them
        bool out = false, oob = false;
        float4 acc[GPW] = {};
        for (int k0 = 0; k0 < rows; k0 += WPF) {
            const int kc = min(WPF, rows - k0);
            const Sample q =
                k0 == 0 ? first : sample_at(tmf, P, F.lane + 32 * (k0 + F.w), npix);
            out = sample_products<WPF, MODE, TS>(q, img2, gx2, gy2, P, F, x, y, a00, a01, a10,
                                                 a11, S) ||
                  out;
            const bool any = feat_any<WPF>(F, out);
            const bool last = k0 + WPF >= rows;
            if (last && any) {
                oob = true;
                break;
            }
#pragma unroll
            for (int u = 0; u < GPW; ++u) {
                const int g = F.w + WPF * u;
                if (g >= NG) continue;
                float4 a = k0 == 0 ? S.prod[0][F.lane][g] : add4(acc[u], S.prod[0][F.lane][g]);
#pragma unroll
                for (int kk = 1; kk < WPF; ++kk) {
                    const float4 v = S.prod[kk][F.lane][g];   // rows past kc unused
                    if (kk < kc) a = add4(a, v);
                }
                acc[u] = a;
            }
            if (!last) feat_sync<WPF>(F);       // the next chunk reuses prod
        }
        PFT_PHASE_UNIT(clk, 1, F.first(), F.f);  // samples, vote, per-lane sums
        if (oob) {
            status = KLT_OOB;
            break;
        }
#pragma unroll
        for (int u = 0; u < GPW; ++u) {
            const int g = F.w + WPF * u;
            if (g >= NG) continue;
            const float r = warp_sum4(acc[u], F.lane);
            const int s = 4 * g + (F.lane >> 4) + ((F.lane >> 2) & 2);
            if ((F.lane & 7) == 0) S.sums[s] = r;
        }
        feat_sync<WPF>(F);
        PFT_PHASE_UNIT(clk, 2, F.first(), F.f);  // butterflies, the feature's wait
        const int ctl = solve<WPF, MODE>(P, F, x, y, a00, a01, a10, a11, S);
        if (ctl == SINGULAR) {
            status = KLT_SMALL_DET;
            break;
        }
        ++it;
        PFT_PHASE_UNIT(clk, 3, F.first(), F.f);  // solve and update
        if (ctl == CONVERGED) break;
    }

    // after the loop: the bounds vote and the residue in one pass
    if (status == KLT_TRACKED) {
        bool out = false;
        float acc = 0.0f;
        for (int k0 = 0; k0 < rows; k0 += WPF) {
            const int kc = min(WPF, rows - k0);
            const Sample q =
                k0 == 0 ? first : sample_at(tmf, P, F.lane + 32 * (k0 + F.w), npix);
            float v = 0.0f;
            if (q.in) {
                const float xs = x + a00 * q.i + a01 * q.j;
                const float ys = y + a10 * q.i + a11 * q.j;
                out = out || sample_out(xs, ys, P);
                float ax, ay;
                const int i00 = tap(xs, ys, P, ax, ay);
                v = fabsf(q.t - blend(img2, i00, P.W, ax, ay));
            }
            S.res[F.w][F.lane] = v;
            const bool any = feat_any<WPF>(F, out);
            const bool last = k0 + WPF >= rows;
            if (last && any) {
                status = KLT_OOB;
                break;
            }
            if (F.w == 0) {
#pragma unroll
                for (int kk = 0; kk < WPF; ++kk) {
                    const float v = S.res[kk][F.lane];       // rows past kc unused
                    if (kk < kc) acc = k0 + kk == 0 ? v : acc + v;
                }
            }
            if (!last) feat_sync<WPF>(F);
        }
        if (status == KLT_TRACKED && F.w == 0) {
            const float residue = warp_sum(acc) / (float)npix;
            if (residue > P.max_residue) status = KLT_LARGE_RESIDUE;
        }
    }
    if (status == KLT_TRACKED && F.w == 0) {
        // torch.maximum semantics: a NaN distance never passes the test
        const float ddx = fabsf(x - x0), ddy = fabsf(y - y0);
        if (!isnan(ddx) && !isnan(ddy) && fmaxf(ddx, ddy) > P.max_drift)
            status = KLT_OOB;
    }
    PFT_PHASE_UNIT(clk, 4, F.first(), F.f);           // after the loop: bounds, residue, drift
}

// This thread's feature, given WPF warps a feature, and its shared memory.
template <int WPF, int MODE>
__device__ __forceinline__ Feat feature_of(FeatureShared<WPF, MODE>*& S)
{
    extern __shared__ float4 pft_affine_smem[];
    const int warp = threadIdx.x >> 5, fib = warp / WPF;
    S = reinterpret_cast<FeatureShared<WPF, MODE>*>(pft_affine_smem) + fib;
    return Feat{(int)blockIdx.x * (int)(blockDim.x / (32 * WPF)) + fib, warp - fib * WPF,
                (int)(threadIdx.x & 31), 1 + fib};
}

template <int WPF, int MODE, typename TS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
affine_kernel(const float* __restrict__ tmpl, const TS* __restrict__ img2,
              const TS* __restrict__ gx2, const TS* __restrict__ gy2,
              const float* __restrict__ x_in, const float* __restrict__ y_in,
              const float* __restrict__ A_in, const bool* __restrict__ check,
              AffParams P, float* __restrict__ x_out, float* __restrict__ y_out,
              float* __restrict__ A_out, int* __restrict__ status_out,
              int* __restrict__ nit_out)
{
    FeatureShared<WPF, MODE>* S;
    const Feat F = feature_of<WPF, MODE>(S);
    const int f = F.f;
    if (f >= P.n) return;                        // the whole feature

    const float x0 = x_in[f], y0 = y_in[f];
    float x = x0, y = y0;
    float a00 = A_in[4 * f], a01 = A_in[4 * f + 1];
    float a10 = A_in[4 * f + 2], a11 = A_in[4 * f + 3];
    int status = KLT_TRACKED, it = 0;
    if (check[f]) {
        const size_t npix = (size_t)(2 * P.hw + 1) * (2 * P.hh + 1);
        affine_gn<WPF, MODE, TS>(tmpl + f * npix, img2, gx2, gy2, P, F, *S, x0, y0, x, y,
                                 a00, a01, a10, a11, status, it);
    }
    if (F.w == 0 && F.lane == 0) {
        x_out[f] = x;
        y_out[f] = y;
        A_out[4 * f] = a00;
        A_out[4 * f + 1] = a01;
        A_out[4 * f + 2] = a10;
        A_out[4 * f + 3] = a11;
        status_out[f] = status;
        nit_out[f] = it;
    }
}

// The affine stage's inputs and outputs (ops/affine.affine_consistency_check):
// level 0 of both pyramids, the feature lists before and after translational
// tracking, and the AffineState's eight fields, in and out; the level
// images in the storage type TS.
template <typename TS>
struct StageIn {
    const TS *img1, *gx1, *gy1, *img2, *gx2, *gy2;
    const float *xb, *yb;
    const int* vb;
    const float *xa, *ya;
    const int* va;
    const float *t_img, *t_gx, *t_gy, *t_x, *t_y, *t_A;
    const bool* t_valid;
    const int* t_nit;
};

struct StageOut {
    float *x, *y;
    int* val;
    float *t_img, *t_gx, *t_gy, *t_x, *t_y, *t_A;
    bool* t_valid;
    int* t_nit;
};

// The three template windows of the new AffineState, each thread its own
// samples (those it samples in affine_gn): captured (the bilinear windows of
// pyr1 level 0 at (xb, yb)) or copied from the old state, whose values at
// the thread's first sample, `first`, were read with the lane's state.
template <int WPF, typename TS>
__device__ __forceinline__ void template_out(const StageIn<TS>& I, const StageOut& O,
                                             const AffParams& P, const Feat& F, size_t tb,
                                             bool capture, float xb, float yb,
                                             const float (&first)[3])
{
    const int npix = (2 * P.hw + 1) * (2 * P.hh + 1);
    for (int p = F.lane + 32 * F.w; p < npix; p += 32 * WPF) {
        float t0 = first[0], t1 = first[1], t2 = first[2];
        if (capture) {
            float i, j, ax, ay;
            offsets(p, P, i, j);
            const int i00 = tap(xb + i, yb + j, P, ax, ay);
            t0 = blend(I.img1, i00, P.W, ax, ay);
            t1 = blend(I.gx1, i00, P.W, ax, ay);
            t2 = blend(I.gy1, i00, P.W, ax, ay);
        } else if (p >= 32 * WPF) {
            t0 = I.t_img[tb + p];
            t1 = I.t_gx[tb + p];
            t2 = I.t_gy[tb + p];
        }
        O.t_img[tb + p] = t0;
        O.t_gx[tb + p] = t1;
        O.t_gy[tb + p] = t2;
    }
}

// The whole affine stage for the feature of this thread: a lane lost by
// translational tracking drops its template and gets the identity warp; a
// first successful track captures the template (three bilinear windows of
// pyr1 level 0 at the pre-track position, interp.bilinear's clamp and blend
// order), its anchor, the identity warp, valid and nit = CAPTURE_NIT; a
// lane tracked with a template is checked by affine_gn; then the selects on
// x, y, val, A and valid. Every other template is copied through. The
// thread's first template samples are read with the lane's state, so that
// the copy waits for no second round trip; what only the outputs need waits
// in shared memory.
template <int WPF, int MODE, typename TS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
stage_kernel(StageIn<TS> I, StageOut O, AffParams P, unsigned long long* __restrict__ counters)
{
    FeatureShared<WPF, MODE>* S;
    const Feat F = feature_of<WPF, MODE>(S);
    const int f = F.f;
    if (f >= P.n) return;                        // the whole feature
    PFT_PHASE_STAMP(14, F.first(), f);
    PFT_PHASE_START(clk);

    const int npix = (2 * P.hw + 1) * (2 * P.hh + 1), p0 = F.lane + 32 * F.w;
    const size_t tb = (size_t)f * npix;
    float first[3] = {};
    if (p0 < npix) {
        first[0] = I.t_img[tb + p0];
        first[1] = I.t_gx[tb + p0];
        first[2] = I.t_gy[tb + p0];
    }
    const int va = I.va[f], vb = I.vb[f];
    const bool tracked = va == KLT_TRACKED;
    const bool lost = vb >= 0 && !tracked;
    const bool valid1 = I.t_valid[f] && !lost;
    const bool capture = tracked && !valid1;
    const bool check = tracked && valid1;
    const bool ident = lost || capture;
    const float xb = I.xb[f], yb = I.yb[f], x0 = I.xa[f], y0 = I.ya[f];
    if (F.first()) {
        S->out[0] = capture ? xb : I.t_x[f];
        S->out[1] = capture ? yb : I.t_y[f];
        S->nit_out = capture ? CAPTURE_NIT : I.t_nit[f];
    }
    const float b00 = ident ? 1.0f : I.t_A[4 * f], b01 = ident ? 0.0f : I.t_A[4 * f + 1];
    const float b10 = ident ? 0.0f : I.t_A[4 * f + 2], b11 = ident ? 1.0f : I.t_A[4 * f + 3];
    template_out<WPF>(I, O, P, F, tb, capture, xb, yb, first);
    float x = x0, y = y0, a00 = b00, a01 = b01, a10 = b10, a11 = b11;
    int status = KLT_TRACKED, it = 0;
    PFT_PHASE_UNIT(clk, 0, F.first(), f);        // lane state, capture or copy
    if (check)
        affine_gn<WPF, MODE, TS>(I.t_img + tb, I.img2, I.gx2, I.gy2, P, F, *S, x0, y0, x, y,
                                 a00, a01, a10, a11, status, it);
    if (!F.first()) return;
    PFT_PHASE_START(clk_out);
    const bool failed = check && status != KLT_TRACKED;
    const bool keep = check && !failed;
    O.x[f] = check ? (failed ? -1.0f : x) : x0;
    O.y[f] = check ? (failed ? -1.0f : y) : y0;
    O.val[f] = failed ? status : va;
    O.t_x[f] = S->out[0];
    O.t_y[f] = S->out[1];
    O.t_A[4 * f] = keep ? a00 : b00;
    O.t_A[4 * f + 1] = keep ? a01 : b01;
    O.t_A[4 * f + 2] = keep ? a10 : b10;
    O.t_A[4 * f + 3] = keep ? a11 : b11;
    O.t_valid[f] = (valid1 || capture) && !failed;
    O.t_nit[f] = S->nit_out;
    if (check) {
        pft_count(counters, PFT_K6_CHECKED, f, 1ull);
        pft_count(counters, PFT_K6_GN_STEPS, f, (unsigned long long)it);
        pft_count(counters, PFT_K6_REJECTIONS, f, failed ? 1ull : 0ull);
    }
    PFT_PHASE_UNIT(clk_out, 5, true, f);         // the outputs
    PFT_PHASE_STAMP(15, true, f);
}

// The launch of WPF warps a feature and fpb features a block, with each
// feature's shared memory.
template <int WPF, int MODE, typename K, typename... A>
int launch_features(K kernel, int n, int fpb, cudaStream_t stream, A... args)
{
    const size_t smem = (size_t)fpb * sizeof(FeatureShared<WPF, MODE>);
    pft_allow_smem(kernel, smem);
    kernel<<<pft_ceil_div(n, fpb), 32 * WPF * fpb, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

// The two launches for storage type TS, as dispatch takes them.
template <typename TS>
struct TrackLaunch {
    template <int WPF, int MODE>
    struct Run {
        static int run(int fpb, cudaStream_t s, const float* tmpl, const void* img2,
                       const void* gx2, const void* gy2, const float* x0, const float* y0,
                       const float* A0, const bool* check, const AffParams& P, float* xo,
                       float* yo, float* Ao, int* st, int* nit)
        {
            return launch_features<WPF, MODE>(affine_kernel<WPF, MODE, TS>, P.n, fpb, s,
                                              tmpl, (const TS*)img2, (const TS*)gx2,
                                              (const TS*)gy2, x0, y0, A0, check, P, xo, yo,
                                              Ao, st, nit);
        }
    };
};

template <typename TS>
struct StageLaunch {
    template <int WPF, int MODE>
    struct Run {
        static int run(int fpb, cudaStream_t s, const StageIn<TS>& I, const StageOut& O,
                       const AffParams& P, unsigned long long* counters)
        {
            return launch_features<WPF, MODE>(stage_kernel<WPF, MODE, TS>, P.n, fpb, s, I, O,
                                              P, counters);
        }
    };
};

// The instantiation for warps a feature (1-8) and mode.
template <template <int, int> class Launch, typename... Args>
int dispatch(int wpf, int mode, Args&&... args)
{
#define PFT_AFFINE_MODES(K)                                                             \
    case K:                                                                             \
        switch (mode) {                                                                 \
            case 0: return Launch<K, 0>::run(args...);                                  \
            case 1: return Launch<K, 1>::run(args...);                                  \
            case 2: return Launch<K, 2>::run(args...);                                  \
            default: return PFT_INVALID_ARGUMENT;                                       \
        }
    switch (wpf) {
        PFT_AFFINE_MODES(1)
        PFT_AFFINE_MODES(2)
        PFT_AFFINE_MODES(3)
        PFT_AFFINE_MODES(4)
        PFT_AFFINE_MODES(5)
        PFT_AFFINE_MODES(6)
        PFT_AFFINE_MODES(7)
        PFT_AFFINE_MODES(8)
        default:
            return PFT_INVALID_ARGUMENT;
    }
#undef PFT_AFFINE_MODES
}

// The stage's inputs with the level images as storage type TS.
template <typename TS>
StageIn<TS> stage_in(const void* const* pyr, const float* const* feats,
                     const int* const* vals, const float* const* state, const bool* valid,
                     const int* nit)
{
    return StageIn<TS>{(const TS*)pyr[0], (const TS*)pyr[1], (const TS*)pyr[2],
                       (const TS*)pyr[3], (const TS*)pyr[4], (const TS*)pyr[5],
                       feats[0], feats[1], vals[0], feats[2], feats[3], vals[1],
                       state[0], state[1], state[2], state[3], state[4], state[5],
                       valid, nit};
}

// The arguments both entries check: odd windows, images of at least 2x2,
// a launch shape of at most MAX_THREADS threads a block.
bool refuse(int H, int W, int window_width, int window_height, int wpf, int fpb)
{
    return H < 2 || W < 2 || window_width % 2 != 1 || window_height % 2 != 1 || wpf < 1 ||
           fpb < 1 || 32 * wpf * fpb > MAX_THREADS;
}

}  // namespace

// Any odd window. A0 is [n, 2, 2] row-major; outputs likewise. The three
// images float32 (bf16 0) or bfloat16 (bf16 1). warps_per_feature (1-8) and
// features_per_block (ops/cuda_affine.launch_shape) shape the launch.
extern "C" int pft_affine_track(const float* tmpl, const void* img2, const void* gx2,
                                const void* gy2, const float* x0, const float* y0,
                                const float* A0, const bool* check, int bf16, int H, int W,
                                int n, int window_width, int window_height, int mode,
                                int warps_per_feature, int features_per_block,
                                int max_iterations, float min_displacement,
                                float min_determinant, float max_residue,
                                float max_displacement_differ, float* x_out,
                                float* y_out, float* A_out, int* status, int* nit,
                                void* stream)
{
    if (n <= 0) return 0;
    if (refuse(H, W, window_width, window_height, warps_per_feature, features_per_block))
        return PFT_INVALID_ARGUMENT;
    const AffParams P{H, W, n, window_width / 2, window_height / 2, max_iterations,
                      min_displacement, min_determinant, max_residue,
                      max_displacement_differ};
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return dispatch<TrackLaunch<__nv_bfloat16>::Run>(
            warps_per_feature, mode, features_per_block, s, tmpl, img2, gx2, gy2, x0, y0, A0,
            check, P, x_out, y_out, A_out, status, nit);
    return dispatch<TrackLaunch<float>::Run>(warps_per_feature, mode, features_per_block, s,
                                             tmpl, img2, gx2, gy2, x0, y0, A0, check, P,
                                             x_out, y_out, A_out, status, nit);
}

// The affine stage in one launch. pyr: level 0 of both pyramids, six [H, W]
// images (img1, gx1, gy1, img2, gx2, gy2), float32 (bf16 0) or bfloat16
// (bf16 1); feats: fl_before's and fl_after's
// (x, y) [n] float32 and val [n] int32 as (xb, yb, xa, ya); vals: (vb, va);
// state: the AffineState in (img, gradx, grady [n, wh, ww], x, y [n], A
// [n, 2, 2]), valid [n] bool, nit [n] int32; out: x, y [n], then the new
// AffineState's float fields in the same order; val_out, valid_out, nit_out.
// counters: the device counters (common.cuh), or nullptr. The launch shape
// as pft_affine_track's.
extern "C" int pft_affine_stage(const void* const* pyr, const float* const* feats,
                                const int* const* vals, const float* const* state,
                                const bool* valid, const int* nit, int bf16, int H, int W,
                                int n, int window_width, int window_height, int mode,
                                int warps_per_feature, int features_per_block,
                                int max_iterations, float min_displacement,
                                float min_determinant, float max_residue,
                                float max_displacement_differ, float* const* out,
                                int* val_out, bool* valid_out, int* nit_out,
                                unsigned long long* counters, void* stream)
{
    if (n <= 0) return 0;
    if (refuse(H, W, window_width, window_height, warps_per_feature, features_per_block))
        return PFT_INVALID_ARGUMENT;
    const AffParams P{H, W, n, window_width / 2, window_height / 2, max_iterations,
                      min_displacement, min_determinant, max_residue,
                      max_displacement_differ};
    const StageOut O{out[0], out[1], val_out, out[2], out[3], out[4],
                     out[5], out[6], out[7],  valid_out, nit_out};
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return dispatch<StageLaunch<__nv_bfloat16>::Run>(
            warps_per_feature, mode, features_per_block, s,
            stage_in<__nv_bfloat16>(pyr, feats, vals, state, valid, nit), O, P, counters);
    return dispatch<StageLaunch<float>::Run>(
        warps_per_feature, mode, features_per_block, s,
        stage_in<float>(pyr, feats, vals, state, valid, nit), O, P, counters);
}

PFT_PHASE_READER(pft_affine_phase_clocks)
PFT_PHASE_UNIT_READER(pft_affine_phase_units)
