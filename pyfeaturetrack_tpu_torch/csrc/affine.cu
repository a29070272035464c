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
//     order ops/cuda_lk.tree_sum reproduces in the plain version;
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
// What bounds it on this card: latency of dependent gathers and the serial
// per-feature solve, not bytes or FLOPs (1000 features x a few iterations x
// 225 samples x 3 images), and, around the batch kernel, the host's launches
// of the eager stage. Design: one warp per feature, window sample s on
// lane s mod 32 (8 passes for 15x15); the template stays in registers for
// the whole loop (windows above 8 samples per lane re-read it, Window<0>);
// every lane ends a butterfly with the same sums, so every
// lane runs the (tiny) Gauss-Jordan itself and all branches are
// warp-uniform; each warp leaves the loop as soon as its feature converges
// or fails, which equals the plain version's masked fixed-trip loop because
// an inactive lane changes nothing. Lane 0 writes the feature's result and
// its Gauss-Newton update count. In the stage, lane 0 of a checked lane also
// adds to the device counters (common.cuh): the lane checked, its updates,
// and the lane when the check rejects it; at most three atomics a warp, on
// the slot of its feature.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 128;                 // 4 features per block
constexpr int KLT_TRACKED = 0;
constexpr int KLT_SMALL_DET = -2;
constexpr int KLT_OOB = -4;
constexpr int KLT_LARGE_RESIDUE = -5;
constexpr float ONE_PLUS_EPS = 1.001f;  // ops/affine._ONE_PLUS_EPS
constexpr int CAPTURE_NIT = 5;          // ops/affine._CAPTURE_NIT

struct AffParams {
    int H, W, n, hw, hh, max_iterations;
    float min_displacement, min_determinant, max_residue, max_drift;
};

__device__ __forceinline__ float warp_sum(float acc)
{
    for (int off = 16; off >= 1; off >>= 1)
        acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
    return acc;
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

template <typename TS>
__device__ __forceinline__ float blend(const TS* __restrict__ im, int i00, int W, float ax,
                                       float ay)
{
    const float p00 = pft_tap(im + i00), p01 = pft_tap(im + i00 + 1);
    const float p10 = pft_tap(im + i00 + W), p11 = pft_tap(im + i00 + W + 1);
    return (1.0f - ax) * (1.0f - ay) * p00 + ax * (1.0f - ay) * p01 +
           (1.0f - ax) * ay * p10 + ax * ay * p11;
}

// The window samples of one lane: sample p = lane + 32 k, its column and
// row offsets (i - hw, j - hh) and its template value. NPL > 0: up to NPL
// samples per lane, held in registers for the whole loop; NPL 0: windows
// above 8 samples per lane (over 256 samples, e.g. 17x17), whose offsets
// are recomputed and whose template is re-read (L1/L2) where a sample is
// needed. Both walk the samples in the same order, so the sums agree.
template <int NPL>
struct Window {
    static constexpr int CAP = NPL > 0 ? NPL : 1;
    float tm[CAP];      // template samples of this lane
    float oi[CAP];      // column offset i - hw
    float oj[CAP];      // row offset j - hh
    bool in[CAP];       // sample exists (not padding beyond ww * wh)
    const float* tmf;   // the feature's template (NPL 0)
    int lane, ww, npix, hw, hh;

    __device__ __forceinline__ void load(const float* __restrict__ t, int lane_,
                                         const AffParams& P)
    {
        tmf = t;
        lane = lane_;
        hw = P.hw;
        hh = P.hh;
        ww = 2 * P.hw + 1;
        npix = ww * (2 * P.hh + 1);
        if constexpr (NPL > 0) {
#pragma unroll
            for (int k = 0; k < NPL; ++k) {
                const int p = lane + 32 * k;
                in[k] = p < npix;
                const int r = in[k] ? p / ww : 0, c = in[k] ? p - r * ww : 0;
                oi[k] = (float)(c - hw);
                oj[k] = (float)(r - hh);
                tm[k] = in[k] ? t[p] : 0.0f;
            }
        }
    }
    __device__ __forceinline__ int count() const
    {
        return NPL > 0 ? NPL : pft_ceil_div(npix, 32);
    }
    // sample k: false for padding; else its offsets and template value
    __device__ __forceinline__ bool at(int k, float& i, float& j, float& t) const
    {
        if constexpr (NPL > 0) {
            i = oi[k];
            j = oj[k];
            t = tm[k];
            return in[k];
        } else {
            const int p = lane + 32 * k;
            if (p >= npix) return false;
            const int r = p / ww, c = p - r * ww;
            i = (float)(c - hw);
            j = (float)(r - hh);
            t = tmf[p];
            return true;
        }
    }
};

template <int NPL>
__device__ __forceinline__ bool warp_oob(const Window<NPL>& w, float x, float y,
                                         float a00, float a01, float a10, float a11,
                                         const AffParams& P)
{
    bool bad = false;
#pragma unroll
    for (int k = 0; k < (NPL > 0 ? NPL : w.count()); ++k) {
        float i, j, t;
        if (!w.at(k, i, j, t)) continue;
        const float xs = x + a00 * i + a01 * j;
        const float ys = y + a10 * i + a11 * j;
        bad = bad || sample_out(xs, ys, P);
    }
    return __any_sync(0xffffffffu, bad) != 0;
}

// Jacobian rows of one sample (ops/affine._jacobian).
template <int MODE>
__device__ __forceinline__ void jacobian(float gx, float gy, float i, float j,
                                         float (&J)[MODE == 0 ? 2 : (MODE == 1 ? 4 : 6)])
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

// The Gauss-Newton loop and the post-loop tests for the feature of this
// warp (ops/affine._affine_track_batch, one checked lane): template `tmf`
// ([wh * ww] samples), start (x, y) = (x0, y0) and warp a.., which come
// back updated, with the status and the number of updates `it`. Shared by
// pft_affine_track and the affine stage.
template <int NPL, int MODE, typename TS>
__device__ void affine_gn(const float* __restrict__ tmf, const TS* __restrict__ img2,
                          const TS* __restrict__ gx2, const TS* __restrict__ gy2,
                          const AffParams& P, int lane, float x0, float y0, float& x,
                          float& y, float& a00, float& a01, float& a10, float& a11,
                          int& status, int& it)
{
    constexpr int NP = MODE == 0 ? 2 : (MODE == 1 ? 4 : 6);
    constexpr int NS = NP * (NP + 1) / 2 + NP;   // J J^T upper triangle, then J diff
    PFT_PHASE_START(clk);
    Window<NPL> w;
    w.load(tmf, lane, P);
    PFT_PHASE(clk, 1, lane == 0);                // template into registers
    status = KLT_TRACKED;
    it = 0;
    for (int step = 0; step < P.max_iterations; ++step) {
        const bool oob = warp_oob<NPL>(w, x, y, a00, a01, a10, a11, P);
        PFT_PHASE(clk, 2, lane == 0);            // the warp's bounds vote
        if (oob) {
            status = KLT_OOB;
            break;
        }
        float acc[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) acc[s] = 0.0f;
#pragma unroll
        for (int k = 0; k < (NPL > 0 ? NPL : w.count()); ++k) {
            float v[NS];
            float i, j, t;
            if (w.at(k, i, j, t)) {
                const float xs = x + a00 * i + a01 * j;
                const float ys = y + a10 * i + a11 * j;
                float ax, ay;
                const int i00 = tap(xs, ys, P, ax, ay);
                const float diff = t - blend(img2, i00, P.W, ax, ay);
                float J[NP];
                jacobian<MODE>(blend(gx2, i00, P.W, ax, ay),
                               blend(gy2, i00, P.W, ax, ay), i, j, J);
                int s = 0;
#pragma unroll
                for (int a = 0; a < NP; ++a)
#pragma unroll
                    for (int b = a; b < NP; ++b) v[s++] = J[a] * J[b];
#pragma unroll
                for (int a = 0; a < NP; ++a) v[s++] = J[a] * diff;
            } else {
#pragma unroll
                for (int s = 0; s < NS; ++s) v[s] = 0.0f;
            }
#pragma unroll
            for (int s = 0; s < NS; ++s) acc[s] = k == 0 ? v[s] : acc[s] + v[s];
        }
        PFT_PHASE(clk, 3, lane == 0);            // samples: taps, blends, products
#pragma unroll
        for (int s = 0; s < NS; ++s) acc[s] = warp_sum(acc[s]);
        PFT_PHASE(clk, 4, lane == 0);            // the butterflies

        // augmented normal system [J J^T | J diff], symmetric fill
        float aug[NP][NP + 1];
        int s = 0;
#pragma unroll
        for (int a = 0; a < NP; ++a)
#pragma unroll
            for (int b = a; b < NP; ++b) {
                aug[a][b] = acc[s];
                aug[b][a] = acc[s];
                ++s;
            }
#pragma unroll
        for (int a = 0; a < NP; ++a) aug[a][NP] = acc[s++];

        float det = 1.0f;
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const float piv = aug[k][k];
            det = det * piv;
            const float safe = fabsf(piv) < 1e-30f ? 1.0f : piv;
            float row[NP + 1];
#pragma unroll
            for (int c = 0; c <= NP; ++c) row[c] = aug[k][c] / safe;
#pragma unroll
            for (int r = 0; r < NP; ++r) {
                if (r == k) continue;
                const float fct = aug[r][k];
#pragma unroll
                for (int c = 0; c <= NP; ++c) aug[r][c] = aug[r][c] - fct * row[c];
            }
#pragma unroll
            for (int c = 0; c <= NP; ++c) aug[k][c] = row[c];
        }
        if (fabsf(det) < P.min_determinant) {
            status = KLT_SMALL_DET;
            break;
        }
        float dx, dy;
        if (MODE == 0) {
            dx = aug[0][NP];
            dy = aug[1][NP];
        } else if (MODE == 1) {
            const float d0 = aug[0][NP], d1 = aug[1][NP];
            a00 = a00 + d0;
            a01 = a01 + -d1;
            a10 = a10 + d1;
            a11 = a11 + d0;
            dx = aug[2][NP];
            dy = aug[3][NP];
        } else {
            a00 = a00 + aug[0][NP];
            a10 = a10 + aug[1][NP];
            a01 = a01 + aug[2][NP];
            a11 = a11 + aug[3][NP];
            dx = aug[4][NP];
            dy = aug[5][NP];
        }
        x = x + dx;
        y = y + dy;
        ++it;
        PFT_PHASE(clk, 5, lane == 0);            // the solve and the update
        if (fabsf(dx) < P.min_displacement && fabsf(dy) < P.min_displacement)
            break;
    }

    if (status == KLT_TRACKED && warp_oob<NPL>(w, x, y, a00, a01, a10, a11, P))
        status = KLT_OOB;
    if (status == KLT_TRACKED) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < (NPL > 0 ? NPL : w.count()); ++k) {
            float v = 0.0f;
            float i, j, t;
            if (w.at(k, i, j, t)) {
                const float xs = x + a00 * i + a01 * j;
                const float ys = y + a10 * i + a11 * j;
                float ax, ay;
                const int i00 = tap(xs, ys, P, ax, ay);
                v = fabsf(t - blend(img2, i00, P.W, ax, ay));
            }
            acc = k == 0 ? v : acc + v;
        }
        const float residue = warp_sum(acc) / (float)w.npix;
        if (residue > P.max_residue) status = KLT_LARGE_RESIDUE;
    }
    if (status == KLT_TRACKED) {
        // torch.maximum semantics: a NaN distance never passes the test
        const float ddx = fabsf(x - x0), ddy = fabsf(y - y0);
        if (!isnan(ddx) && !isnan(ddy) && fmaxf(ddx, ddy) > P.max_drift)
            status = KLT_OOB;
    }
    PFT_PHASE(clk, 6, lane == 0);                // after the loop: bounds, residue, drift
}

template <int NPL, int MODE, typename TS>
__global__ void __launch_bounds__(NT)
affine_kernel(const float* __restrict__ tmpl, const TS* __restrict__ img2,
              const TS* __restrict__ gx2, const TS* __restrict__ gy2,
              const float* __restrict__ x_in, const float* __restrict__ y_in,
              const float* __restrict__ A_in, const bool* __restrict__ check,
              AffParams P, float* __restrict__ x_out, float* __restrict__ y_out,
              float* __restrict__ A_out, int* __restrict__ status_out,
              int* __restrict__ nit_out)
{
    const int f = (blockIdx.x * NT + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= P.n) return;                        // whole warp

    const float x0 = x_in[f], y0 = y_in[f];
    float x = x0, y = y0;
    float a00 = A_in[4 * f], a01 = A_in[4 * f + 1];
    float a10 = A_in[4 * f + 2], a11 = A_in[4 * f + 3];
    int status = KLT_TRACKED, it = 0;
    if (check[f]) {
        const size_t npix = (size_t)(2 * P.hw + 1) * (2 * P.hh + 1);
        affine_gn<NPL, MODE, TS>(tmpl + f * npix, img2, gx2, gy2, P, lane, x0, y0, x, y,
                                 a00, a01, a10, a11, status, it);
    }
    if (lane == 0) {
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

// The lane's three template windows of the new AffineState: captured (the
// bilinear windows of pyr1 level 0 at (xb, yb)) or copied from the old
// state. TEMPLATE_ROUND samples per lane at a time, every load of a round
// issued before its first store, so a window waits for about one memory
// round trip per round rather than one per sample.
constexpr int TEMPLATE_ROUND = 8;

template <typename TS>
__device__ __forceinline__ void template_out(const StageIn<TS>& I, const StageOut& O,
                                             const AffParams& P, size_t tb, int lane,
                                             bool capture, float xb, float yb)
{
    const int ww = 2 * P.hw + 1, npix = ww * (2 * P.hh + 1);
    for (int k0 = 0; 32 * k0 < npix; k0 += TEMPLATE_ROUND) {
        float t[3][TEMPLATE_ROUND];
#pragma unroll
        for (int u = 0; u < TEMPLATE_ROUND; ++u) {
            const int p = lane + 32 * (k0 + u);
            t[0][u] = t[1][u] = t[2][u] = 0.0f;
            if (p >= npix) continue;
            if (capture) {
                const int r = p / ww, c = p - r * ww;
                float ax, ay;
                const int i00 = tap(xb + (float)(c - P.hw), yb + (float)(r - P.hh), P, ax,
                                    ay);
                t[0][u] = blend(I.img1, i00, P.W, ax, ay);
                t[1][u] = blend(I.gx1, i00, P.W, ax, ay);
                t[2][u] = blend(I.gy1, i00, P.W, ax, ay);
            } else {
                t[0][u] = I.t_img[tb + p];
                t[1][u] = I.t_gx[tb + p];
                t[2][u] = I.t_gy[tb + p];
            }
        }
#pragma unroll
        for (int u = 0; u < TEMPLATE_ROUND; ++u) {
            const int p = lane + 32 * (k0 + u);
            if (p >= npix) continue;
            O.t_img[tb + p] = t[0][u];
            O.t_gx[tb + p] = t[1][u];
            O.t_gy[tb + p] = t[2][u];
        }
    }
}

// The whole affine stage for the feature of this warp: a lane lost by
// translational tracking drops its template and gets the identity warp; a
// first successful track captures the template (three bilinear windows of
// pyr1 level 0 at the pre-track position, interp.bilinear's clamp and blend
// order), its anchor, the identity warp, valid and nit = CAPTURE_NIT; a
// lane tracked with a template is checked by affine_gn; then the selects on
// x, y, val, A and valid. Every other template is copied through.
template <int NPL, int MODE, typename TS>
__global__ void __launch_bounds__(NT)
stage_kernel(StageIn<TS> I, StageOut O, AffParams P, unsigned long long* __restrict__ counters)
{
    const int f = (blockIdx.x * NT + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= P.n) return;                        // whole warp
    PFT_PHASE_START(clk);

    const int va = I.va[f], vb = I.vb[f];
    const bool tracked = va == KLT_TRACKED;
    const bool lost = vb >= 0 && !tracked;
    const bool valid1 = I.t_valid[f] && !lost;
    const bool capture = tracked && !valid1;
    const bool check = tracked && valid1;
    const bool ident = lost || capture;
    const float b00 = ident ? 1.0f : I.t_A[4 * f], b01 = ident ? 0.0f : I.t_A[4 * f + 1];
    const float b10 = ident ? 0.0f : I.t_A[4 * f + 2], b11 = ident ? 1.0f : I.t_A[4 * f + 3];

    const size_t tb = (size_t)f * (2 * P.hw + 1) * (2 * P.hh + 1);
    template_out(I, O, P, tb, lane, capture, I.xb[f], I.yb[f]);

    const float x0 = I.xa[f], y0 = I.ya[f];
    float x = x0, y = y0, a00 = b00, a01 = b01, a10 = b10, a11 = b11;
    int status = KLT_TRACKED, it = 0;
    PFT_PHASE(clk, 0, lane == 0);                // lane state, capture or copy
    if (check)
        affine_gn<NPL, MODE, TS>(I.t_img + tb, I.img2, I.gx2, I.gy2, P, lane, x0, y0, x, y,
                                 a00, a01, a10, a11, status, it);
    PFT_PHASE_START(clk_out);
    const bool failed = check && status != KLT_TRACKED;
    const bool keep = check && !failed;
    if (lane == 0) {
        O.x[f] = check ? (failed ? -1.0f : x) : x0;
        O.y[f] = check ? (failed ? -1.0f : y) : y0;
        O.val[f] = failed ? status : va;
        O.t_x[f] = capture ? I.xb[f] : I.t_x[f];
        O.t_y[f] = capture ? I.yb[f] : I.t_y[f];
        O.t_A[4 * f] = keep ? a00 : b00;
        O.t_A[4 * f + 1] = keep ? a01 : b01;
        O.t_A[4 * f + 2] = keep ? a10 : b10;
        O.t_A[4 * f + 3] = keep ? a11 : b11;
        O.t_valid[f] = (valid1 || capture) && !failed;
        O.t_nit[f] = capture ? CAPTURE_NIT : I.t_nit[f];
        if (check) {
            pft_count(counters, PFT_K6_CHECKED, f, 1ull);
            pft_count(counters, PFT_K6_GN_STEPS, f, (unsigned long long)it);
            pft_count(counters, PFT_K6_REJECTIONS, f, failed ? 1ull : 0ull);
        }
    }
    PFT_PHASE(clk_out, 7, lane == 0);            // the outputs
}

// pft_affine_track: one warp per feature, NT / 32 features per block.
template <int NPL, int MODE, typename TS>
int launch(const float* tmpl, const void* img2, const void* gx2, const void* gy2,
           const float* x0, const float* y0, const float* A0, const bool* check,
           const AffParams& P, float* xo, float* yo, float* Ao, int* st, int* nit,
           cudaStream_t stream)
{
    const int blocks = pft_ceil_div(P.n, NT / 32);
    affine_kernel<NPL, MODE, TS><<<blocks, NT, 0, stream>>>(
        tmpl, (const TS*)img2, (const TS*)gx2, (const TS*)gy2, x0, y0, A0, check, P, xo, yo,
        Ao, st, nit);
    return (int)cudaGetLastError();
}

template <int NPL, int MODE, typename TS>
int launch_stage(const StageIn<TS>& I, const StageOut& O, const AffParams& P,
                 unsigned long long* counters, cudaStream_t stream)
{
    stage_kernel<NPL, MODE, TS><<<pft_ceil_div(P.n, NT / 32), NT, 0, stream>>>(I, O, P,
                                                                               counters);
    return (int)cudaGetLastError();
}

// The instantiation for a window (samples per lane: 1-8 in registers, 0
// above) and mode.
template <template <int, int> class Launch, typename... Args>
int dispatch(int window_width, int window_height, int mode, Args&&... args)
{
    const int npl = pft_ceil_div(window_width * window_height, 32);
#define PFT_AFFINE_MODES(K)                                                             \
    case K:                                                                             \
        switch (mode) {                                                                 \
            case 0: return Launch<K, 0>::run(args...);                                  \
            case 1: return Launch<K, 1>::run(args...);                                  \
            case 2: return Launch<K, 2>::run(args...);                                  \
            default: return PFT_INVALID_ARGUMENT;                                       \
        }
    switch (npl <= 8 ? npl : 0) {
        PFT_AFFINE_MODES(0)
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

// The two launches for storage type TS, as dispatch takes them.
template <typename TS>
struct TrackLaunch {
    template <int NPL, int MODE>
    struct Run {
        template <typename... A>
        static int run(A&&... a) { return launch<NPL, MODE, TS>(a...); }
    };
};

template <typename TS>
struct StageLaunch {
    template <int NPL, int MODE>
    struct Run {
        template <typename... A>
        static int run(A&&... a) { return launch_stage<NPL, MODE, TS>(a...); }
    };
};

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

}  // namespace

// Any odd window. A0 is [n, 2, 2] row-major; outputs likewise. The three
// images float32 (bf16 0) or bfloat16 (bf16 1).
extern "C" int pft_affine_track(const float* tmpl, const void* img2, const void* gx2,
                                const void* gy2, const float* x0, const float* y0,
                                const float* A0, const bool* check, int bf16, int H, int W,
                                int n,
                                int window_width, int window_height, int mode,
                                int max_iterations, float min_displacement,
                                float min_determinant, float max_residue,
                                float max_displacement_differ, float* x_out,
                                float* y_out, float* A_out, int* status, int* nit,
                                void* stream)
{
    if (n <= 0) return 0;
    if (H < 2 || W < 2 || window_width % 2 != 1 || window_height % 2 != 1)
        return PFT_INVALID_ARGUMENT;
    const AffParams P{H, W, n, window_width / 2, window_height / 2, max_iterations,
                      min_displacement, min_determinant, max_residue,
                      max_displacement_differ};
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return dispatch<TrackLaunch<__nv_bfloat16>::Run>(window_width, window_height, mode,
                                                         tmpl, img2, gx2, gy2, x0, y0, A0,
                                                         check, P, x_out, y_out, A_out,
                                                         status, nit, s);
    return dispatch<TrackLaunch<float>::Run>(window_width, window_height, mode, tmpl, img2,
                                             gx2, gy2, x0, y0, A0, check, P, x_out, y_out,
                                             A_out, status, nit, s);
}

// The affine stage in one launch. pyr: level 0 of both pyramids, six [H, W]
// images (img1, gx1, gy1, img2, gx2, gy2), float32 (bf16 0) or bfloat16
// (bf16 1); feats: fl_before's and fl_after's
// (x, y) [n] float32 and val [n] int32 as (xb, yb, xa, ya); vals: (vb, va);
// state: the AffineState in (img, gradx, grady [n, wh, ww], x, y [n], A
// [n, 2, 2]), valid [n] bool, nit [n] int32; out: x, y [n], then the new
// AffineState's float fields in the same order; val_out, valid_out, nit_out.
// counters: the device counters (common.cuh), or nullptr.
extern "C" int pft_affine_stage(const void* const* pyr, const float* const* feats,
                                const int* const* vals, const float* const* state,
                                const bool* valid, const int* nit, int bf16, int H, int W,
                                int n,
                                int window_width, int window_height, int mode,
                                int max_iterations, float min_displacement,
                                float min_determinant, float max_residue,
                                float max_displacement_differ, float* const* out,
                                int* val_out, bool* valid_out, int* nit_out,
                                unsigned long long* counters, void* stream)
{
    if (n <= 0) return 0;
    if (H < 2 || W < 2 || window_width % 2 != 1 || window_height % 2 != 1)
        return PFT_INVALID_ARGUMENT;
    const AffParams P{H, W, n, window_width / 2, window_height / 2, max_iterations,
                      min_displacement, min_determinant, max_residue,
                      max_displacement_differ};
    const StageOut O{out[0], out[1], val_out, out[2], out[3], out[4],
                     out[5], out[6], out[7],  valid_out, nit_out};
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return dispatch<StageLaunch<__nv_bfloat16>::Run>(
            window_width, window_height, mode,
            stage_in<__nv_bfloat16>(pyr, feats, vals, state, valid, nit), O, P, counters, s);
    return dispatch<StageLaunch<float>::Run>(
        window_width, window_height, mode,
        stage_in<float>(pyr, feats, vals, state, valid, nit), O, P, counters, s);
}

PFT_PHASE_READER(pft_affine_phase_clocks)
