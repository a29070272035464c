// Lucas-Kanade pieces shared by K2 (lk.cu), K8 (lk_dense.cu) and K9
// (window_terms.cu): the status codes, the window-fits test, the bilinear
// patch of ops/track._gather3 and the warp reduction of
// ops/cuda_lk.tree_sum. Every function rounds each product and sum on its
// own (the library is built with -fmad=false), in the order of the plain
// PyTorch versions.
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
__device__ __forceinline__ float blend_tap(const float* __restrict__ im, const Patch& q,
                                           int j, int i, const LKParams& P)
{
    int r0 = q.y0 + j, c0 = q.x0 + i;
    int r1 = r0 + 1, c1 = c0 + 1;
    r0 = r0 < P.H ? r0 : P.H - 1;
    r1 = r1 < P.H ? r1 : P.H - 1;
    c0 = c0 < P.W ? c0 : P.W - 1;
    c1 = c1 < P.W ? c1 : P.W - 1;
    const float p00 = __ldg(im + r0 * P.W + c0), p01 = __ldg(im + r0 * P.W + c1);
    const float p10 = __ldg(im + r1 * P.W + c0), p11 = __ldg(im + r1 * P.W + c1);
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
template <int NPL, int NIMG>
__device__ __forceinline__ void gather(const float* const (&imgs)[NIMG],
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

}  // namespace
