// Lucas-Kanade pieces shared by K2 (lk.cu), K8 (lk_dense.cu) and K9
// (window_terms.cu): the status codes, the window-fits test, the bilinear
// patch of ops/track._gather3, the warp reduction of ops/cuda_lk.tree_sum,
// and K2's per-level solve (lk_level_body), which both of K2's entries
// run. Every function rounds each product and sum on its own (the library
// is built with -fmad=false), in the order of the plain PyTorch versions.
// The level images are float or __nv_bfloat16 (TS, cfg.image_dtype): each
// tap is upcast to float32 where it is read (common.cuh pft_ldg).
#pragma once

#include "common.cuh"

namespace {

constexpr int KLT_TRACKED = 0;
constexpr int KLT_SMALL_DET = -2;
constexpr int KLT_MAX_ITERATIONS = -3;
constexpr int KLT_OOB = -4;
constexpr int KLT_LARGE_RESIDUE = -5;
constexpr float ONE_PLUS_EPS = 1.001f;  // ops/track._ONE_PLUS_EPS

struct LKParams {
    int H, W, n, hw, hh, max_iterations;
    float min_displacement, min_determinant, max_residue, step_factor;
};

__device__ __forceinline__ float warp_sum(float acc)
{
    for (int off = 16; off >= 1; off >>= 1)
        acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
    return acc;
}

// Sum of a window spread over a warp (pixel p = lane + 32 k): each lane adds
// its pixels in ascending k, then the xor butterfly 16, 8, 4, 2, 1.
template <int NPL>
__device__ __forceinline__ float window_sum(const float (&v)[NPL])
{
    float acc = v[0];
    for (int k = 1; k < NPL; ++k) acc = acc + v[k];
    return warp_sum(acc);
}

__device__ __forceinline__ bool bounds_ok(float x, float y, const LKParams& P)
{
    return (x - (float)P.hw >= 0.0f) &&
           ((float)P.W - (x + (float)P.hw) >= ONE_PLUS_EPS) &&
           (y - (float)P.hh >= 0.0f) &&
           ((float)P.H - (y + (float)P.hh) >= ONE_PLUS_EPS);
}

// The (wh+1) x (ww+1) integer patch of a window centred at (x, y): its
// top-left clamp(floor(x) - hw, 0, W - 2 - 2 hw) (interp.py:73-74) and the
// four bilinear weights every tap of the window shares.
struct Patch {
    int x0, y0;
    float w00, w01, w10, w11;
};

__device__ __forceinline__ Patch patch_at(float x, float y, const LKParams& P)
{
    // the clamp only keeps the int conversion defined for runaway lanes,
    // which are OOB and never read these windows
    const int xt = (int)fminf(fmaxf(floorf(x), -1.0e8f), 1.0e8f);
    const int yt = (int)fminf(fmaxf(floorf(y), -1.0e8f), 1.0e8f);
    const float a = x - (float)xt, b = y - (float)yt;
    int x0 = xt - P.hw, y0 = yt - P.hh;
    const int xmax = P.W - 2 - 2 * P.hw, ymax = P.H - 2 - 2 * P.hh;
    x0 = x0 < 0 ? 0 : (x0 > xmax ? xmax : x0);
    y0 = y0 < 0 ? 0 : (y0 > ymax ? ymax : y0);
    // Images smaller than the patch: keep every read inside the image (such
    // levels put every lane OOB, so these values are never used).
    Patch q;
    q.x0 = x0 < 0 ? 0 : x0;
    q.y0 = y0 < 0 ? 0 : y0;
    q.w00 = (1.0f - a) * (1.0f - b);
    q.w01 = a * (1.0f - b);
    q.w10 = (1.0f - a) * b;
    q.w11 = a * b;
    return q;
}

// Window tap (row j, column i) of ``im``: (1-a)(1-b) p00 + a(1-b) p01 +
// (1-a) b p10 + a b p11 in that order, reads clamped into the image.
template <typename TS>
__device__ __forceinline__ float blend_tap(const TS* __restrict__ im, const Patch& q,
                                           int j, int i, const LKParams& P)
{
    int r0 = q.y0 + j, c0 = q.x0 + i;
    int r1 = r0 + 1, c1 = c0 + 1;
    r0 = r0 < P.H ? r0 : P.H - 1;
    r1 = r1 < P.H ? r1 : P.H - 1;
    c0 = c0 < P.W ? c0 : P.W - 1;
    c1 = c1 < P.W ? c1 : P.W - 1;
    const float p00 = pft_ldg(im + r0 * P.W + c0), p01 = pft_ldg(im + r0 * P.W + c1);
    const float p10 = pft_ldg(im + r1 * P.W + c0), p11 = pft_ldg(im + r1 * P.W + c1);
    return q.w00 * p00 + q.w01 * p01 + q.w10 * p10 + q.w11 * p11;
}

// Per-lane window pixels of the warp layout: (row, col) offsets inside the
// window; rows < 0 mark the padding beyond ww*wh.
template <int NPL>
struct LanePixels {
    int j[NPL], i[NPL];
};

template <int NPL>
__device__ __forceinline__ LanePixels<NPL> lane_pixels(int lane, const LKParams& P)
{
    const int ww = 2 * P.hw + 1, npix = ww * (2 * P.hh + 1);
    LanePixels<NPL> px;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
        const int p = lane + 32 * k;
        px.j[k] = p < npix ? p / ww : -1;
        px.i[k] = p < npix ? p % ww : 0;
    }
    return px;
}

// Bilinear windows of up to three images at (x, y) in the warp layout,
// sharing one patch and one blend (ops/track._gather3); padding pixels 0.
template <int NPL, int NIMG, typename TS>
__device__ __forceinline__ void gather(const TS* const (&imgs)[NIMG],
                                       float x, float y, const LanePixels<NPL>& px,
                                       const LKParams& P, float (&out)[NIMG][NPL])
{
    const Patch q = patch_at(x, y, P);
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
#pragma unroll
        for (int m = 0; m < NIMG; ++m)
            out[m][k] = px.j[k] < 0 ? 0.0f : blend_tap(imgs[m], q, px.j[k], px.i[k], P);
    }
}

// Residual window: w1 - w2, or with lighting compensation w1 - alpha w2 -
// beta (track.py:120-128). Returns the gain alpha (1 without it).
template <int NPL, bool LIGHTING>
__device__ __forceinline__ float residual(const float (&w1)[NPL], const float (&w2)[NPL],
                                          float s11, float m1, float n,
                                          float (&dif)[NPL])
{
    if (!LIGHTING) {
#pragma unroll
        for (int k = 0; k < NPL; ++k) dif[k] = w1[k] - w2[k];
        return 1.0f;
    }
    float t[NPL];
#pragma unroll
    for (int k = 0; k < NPL; ++k) t[k] = w2[k] * w2[k];
    const float s22 = window_sum<NPL>(t);
    const float alpha = sqrtf((s11 / n) / (s22 / n));
    const float beta = m1 - alpha * (window_sum<NPL>(w2) / n);
#pragma unroll
    for (int k = 0; k < NPL; ++k) dif[k] = w1[k] - w2[k] * alpha - beta;
    return alpha;
}

// Window pixel p = lane + 32 k of a window of any size: its (row, col), row
// -1 beyond the window (padding, which every sum counts as 0).
__device__ __forceinline__ void window_pixel(int p, const LKParams& P, int& j, int& i)
{
    const int ww = 2 * P.hw + 1, npix = ww * (2 * P.hh + 1);
    j = p < npix ? p / ww : -1;
    i = p < npix ? p - (p / ww) * ww : 0;
}

// Per-lane running sum in ascending k (the first term taken as it is, as
// window_sum does), for windows walked pixel by pixel.
__device__ __forceinline__ float lane_add(float acc, float v, int k)
{
    return k == 0 ? v : acc + v;
}

// lk_level_body for windows of more than 8 pixels per lane (above 256
// pixels, e.g. 17x17 and up): the same arithmetic and sum order, but the
// window is walked pixel by pixel (k = 0, 1, ...) with per-lane running
// sums, and every window tap is re-read (L1/L2) where it is needed instead
// of being held in registers, so any window size runs. With lighting
// compensation the frame-2 window is walked twice per iteration: once for
// its gain sums, once for the normal equations.
template <bool LIGHTING, typename TS>
__device__ int lk_level_body_any(const TS* const (&f1)[3], const TS* const (&f2)[3],
                                 float xa, float ya, float& x, float& y, int& it, int lane,
                                 const LKParams& P)
{
    const int npix = (2 * P.hw + 1) * (2 * P.hh + 1), npl = pft_ceil_div(npix, 32);
    const float n = (float)npix;
    const Patch q1 = patch_at(xa, ya, P);
    float s11 = 0.0f, m1 = 0.0f;
    if (LIGHTING) {
        float a = 0.0f, b = 0.0f;
        for (int k = 0; k < npl; ++k) {
            int j, i;
            window_pixel(lane + 32 * k, P, j, i);
            const float w = j < 0 ? 0.0f : blend_tap(f1[0], q1, j, i, P);
            a = lane_add(a, w * w, k);
            b = lane_add(b, w, k);
        }
        s11 = warp_sum(a);
        m1 = warp_sum(b) / n;
    }
    // gain and bias of the frame-2 window at patch q (residual's order)
    auto gain = [&](const Patch& q, float& alpha, float& beta) {
        float a = 0.0f, b = 0.0f;
        for (int k = 0; k < npl; ++k) {
            int j, i;
            window_pixel(lane + 32 * k, P, j, i);
            const float w = j < 0 ? 0.0f : blend_tap(f2[0], q, j, i, P);
            a = lane_add(a, w * w, k);
            b = lane_add(b, w, k);
        }
        const float s22 = warp_sum(a);
        alpha = sqrtf((s11 / n) / (s22 / n));
        beta = m1 - alpha * (warp_sum(b) / n);
    };

    const bool ok1 = bounds_ok(xa, ya, P);
    int status = KLT_TRACKED;
    it = 0;
    for (int step = 0; step < P.max_iterations; ++step) {
        if (!(ok1 && bounds_ok(x, y, P))) {
            status = KLT_OOB;
            break;
        }
        const Patch q2 = patch_at(x, y, P);
        float alpha = 1.0f, beta = 0.0f;
        if (LIGHTING) gain(q2, alpha, beta);
        float sxx = 0.0f, sxy = 0.0f, syy = 0.0f, sex = 0.0f, sey = 0.0f;
        for (int k = 0; k < npl; ++k) {
            int j, i;
            window_pixel(lane + 32 * k, P, j, i);
            float txx = 0.0f, txy = 0.0f, tyy = 0.0f, tex = 0.0f, tey = 0.0f;
            if (j >= 0) {
                const float w1 = blend_tap(f1[0], q1, j, i, P);
                const float g1x = blend_tap(f1[1], q1, j, i, P);
                const float g1y = blend_tap(f1[2], q1, j, i, P);
                const float w2 = blend_tap(f2[0], q2, j, i, P);
                const float g2x = blend_tap(f2[1], q2, j, i, P);
                const float g2y = blend_tap(f2[2], q2, j, i, P);
                const float dif = LIGHTING ? w1 - w2 * alpha - beta : w1 - w2;
                const float gx = LIGHTING ? g1x + alpha * g2x : g1x + g2x;
                const float gy = LIGHTING ? g1y + alpha * g2y : g1y + g2y;
                txx = gx * gx;
                txy = gx * gy;
                tyy = gy * gy;
                tex = dif * gx;
                tey = dif * gy;
            }
            sxx = lane_add(sxx, txx, k);
            sxy = lane_add(sxy, txy, k);
            syy = lane_add(syy, tyy, k);
            sex = lane_add(sex, tex, k);
            sey = lane_add(sey, tey, k);
        }
        const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
        const float ex = P.step_factor * warp_sum(sex);
        const float ey = P.step_factor * warp_sum(sey);

        const float det = gxx * gyy - gxy * gxy;
        if (det < P.min_determinant) {
            status = KLT_SMALL_DET;
            break;
        }
        const float dx = (gyy * ex - gxy * ey) / det;
        const float dy = (gxx * ey - gxy * ex) / det;
        x = x + dx;
        y = y + dy;
        ++it;
        if (!(fabsf(dx) >= P.min_displacement || fabsf(dy) >= P.min_displacement))
            break;
    }

    if (!bounds_ok(x, y, P)) status = KLT_OOB;
    if (status == KLT_TRACKED) {
        const Patch q2 = patch_at(x, y, P);
        float alpha = 1.0f, beta = 0.0f;
        if (LIGHTING) gain(q2, alpha, beta);
        float acc = 0.0f;
        for (int k = 0; k < npl; ++k) {
            int j, i;
            window_pixel(lane + 32 * k, P, j, i);
            float v = 0.0f;
            if (j >= 0) {
                const float w1 = blend_tap(f1[0], q1, j, i, P);
                const float w2 = blend_tap(f2[0], q2, j, i, P);
                v = fabsf(LIGHTING ? w1 - w2 * alpha - beta : w1 - w2);
            }
            acc = lane_add(acc, v, k);
        }
        const float residue = warp_sum(acc) / n;
        if (residue > P.max_residue) status = KLT_LARGE_RESIDUE;
        else if (it >= P.max_iterations) status = KLT_MAX_ITERATIONS;
    }
    return status;
}

// One pyramid level of translational LK for the feature of this warp: the
// arithmetic of ops/track.track_feature_level (track.py:155-234), which
// ops/cuda_lk.lk_level_reference repeats. The frame-1 windows of img, gx, gy
// at (xa, ya) are read once and stay in registers; (x, y) is the frame-2
// start and comes back updated, `it` the number of updates. Per iteration:
// bounds check of both positions (OOB, position frozen), 2x2 normal
// equations, SMALL_DET, the step, convergence on min_displacement. After
// the loop: bounds check (OOB overrides any status), then LARGE_RESIDUE,
// then MAX_ITERATIONS (a lane converging on its last update still reports
// MAX_ITERATIONS, track.py:231-233). Every lane ends with the same sums, so
// all branches are warp-uniform. Returns the level status. NPL 0: windows
// above 8 pixels per lane, lk_level_body_any.
template <int NPL, bool LIGHTING, typename TS>
__device__ __forceinline__ int lk_level_body(const TS* const (&f1)[3],
                                             const TS* const (&f2)[3],
                                             float xa, float ya, float& x, float& y,
                                             int& it, int lane, const LKParams& P)
{
    if constexpr (NPL == 0) {
        return lk_level_body_any<LIGHTING, TS>(f1, f2, xa, ya, x, y, it, lane, P);
    } else {
    const float n = (float)((2 * P.hw + 1) * (2 * P.hh + 1));
    const LanePixels<NPL> px = lane_pixels<NPL>(lane, P);
    const TS* const f2img[1] = {f2[0]};
    float w1[3][NPL];
    gather<NPL, 3>(f1, xa, ya, px, P, w1);

    float s11 = 0.0f, m1 = 0.0f;
    if (LIGHTING) {
        float t[NPL];
#pragma unroll
        for (int k = 0; k < NPL; ++k) t[k] = w1[0][k] * w1[0][k];
        s11 = window_sum<NPL>(t);
        m1 = window_sum<NPL>(w1[0]) / n;
    }

    const bool ok1 = bounds_ok(xa, ya, P);
    int status = KLT_TRACKED;
    it = 0;
    for (int step = 0; step < P.max_iterations; ++step) {
        if (!(ok1 && bounds_ok(x, y, P))) {
            status = KLT_OOB;
            break;
        }
        float w2[3][NPL];
        gather<NPL, 3>(f2, x, y, px, P, w2);
        float dif[NPL], gxs[NPL], gys[NPL];
        const float alpha = residual<NPL, LIGHTING>(w1[0], w2[0], s11, m1, n, dif);
#pragma unroll
        for (int k = 0; k < NPL; ++k) {
            gxs[k] = LIGHTING ? w1[1][k] + alpha * w2[1][k] : w1[1][k] + w2[1][k];
            gys[k] = LIGHTING ? w1[2][k] + alpha * w2[2][k] : w1[2][k] + w2[2][k];
        }
        float t[NPL];
#pragma unroll
        for (int k = 0; k < NPL; ++k) t[k] = px.j[k] < 0 ? 0.0f : gxs[k] * gxs[k];
        const float gxx = window_sum<NPL>(t);
#pragma unroll
        for (int k = 0; k < NPL; ++k) t[k] = px.j[k] < 0 ? 0.0f : gxs[k] * gys[k];
        const float gxy = window_sum<NPL>(t);
#pragma unroll
        for (int k = 0; k < NPL; ++k) t[k] = px.j[k] < 0 ? 0.0f : gys[k] * gys[k];
        const float gyy = window_sum<NPL>(t);
#pragma unroll
        for (int k = 0; k < NPL; ++k) t[k] = px.j[k] < 0 ? 0.0f : dif[k] * gxs[k];
        const float ex = P.step_factor * window_sum<NPL>(t);
#pragma unroll
        for (int k = 0; k < NPL; ++k) t[k] = px.j[k] < 0 ? 0.0f : dif[k] * gys[k];
        const float ey = P.step_factor * window_sum<NPL>(t);

        const float det = gxx * gyy - gxy * gxy;
        if (det < P.min_determinant) {
            status = KLT_SMALL_DET;
            break;
        }
        const float dx = (gyy * ex - gxy * ey) / det;
        const float dy = (gxx * ey - gxy * ex) / det;
        x = x + dx;
        y = y + dy;
        ++it;
        if (!(fabsf(dx) >= P.min_displacement || fabsf(dy) >= P.min_displacement))
            break;
    }

    if (!bounds_ok(x, y, P)) status = KLT_OOB;
    if (status == KLT_TRACKED) {
        float w2[1][NPL];
        gather<NPL, 1>(f2img, x, y, px, P, w2);
        float dif[NPL];
        residual<NPL, LIGHTING>(w1[0], w2[0], s11, m1, n, dif);
#pragma unroll
        for (int k = 0; k < NPL; ++k) dif[k] = px.j[k] < 0 ? 0.0f : fabsf(dif[k]);
        const float residue = window_sum<NPL>(dif) / n;
        if (residue > P.max_residue) status = KLT_LARGE_RESIDUE;
        else if (it >= P.max_iterations) status = KLT_MAX_ITERATIONS;
    }
    return status;
    }
}

}  // namespace
