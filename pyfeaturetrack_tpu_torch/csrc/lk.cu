// K2: one pyramid level of translational Lucas-Kanade for a feature batch.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_lk_vec.py: vec_track_level
// (_vec_level_kernel) and its stale-lane fallback
// vec_track_level_with_fallback. The arithmetic is that of
// ops/track.track_feature_level (track.py:155-234), lane for lane:
//   * bilinear windows from the (wh+1) x (ww+1) integer patch whose top-left
//     is clamp(floor(x) - hw, 0, W - 2 - 2 hw) (interp.py:73-74), blended as
//     (1-a)(1-b) p00 + a(1-b) p01 + (1-a) b p10 + a b p11 in that order;
//   * per iteration: bounds check of both positions (OOB, position frozen),
//     2x2 normal equations, SMALL_DET, the step, convergence on
//     min_displacement, at most max_iterations updates;
//   * after the loop: bounds check (OOB overrides any status), then
//     LARGE_RESIDUE, then MAX_ITERATIONS (a lane converging on its last
//     update still reports MAX_ITERATIONS, track.py:231-233);
//   * the lighting-insensitive variant (gain alpha, bias beta) as a
//     compile-time switch.
//
// What bounds it on this card: latency of dependent gathers, not bytes or
// FLOPs (1000 features x <= 10 iterations x 49 pixels x 3 images). Design:
// one warp per feature, the ww*wh window pixels spread over the 32 lanes
// (pixel p = lane + 32 k). The frame-1 windows of img, gx, gy are read once
// per level and stay in registers; each warp leaves the iteration loop on
// its own as soon as its feature converges or fails. The five window sums
// are warp reductions in one fixed order (per-lane ascending k, then an
// xor butterfly 16, 8, 4, 2, 1), which the plain version reproduces, so
// both give the same bits; every lane ends with the same sums, so all
// branches are warp-uniform. Lane 0 writes the feature's result.

#include "lk_common.cuh"

namespace {

constexpr int NT = 128;                 // 4 features per block

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

template <int NPL, bool LIGHTING>
__global__ void __launch_bounds__(NT)
lk_level_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
                const float* __restrict__ x2_in, const float* __restrict__ y2_in,
                const bool* __restrict__ active,
                const float* __restrict__ img1, const float* __restrict__ gx1,
                const float* __restrict__ gy1, const float* __restrict__ img2,
                const float* __restrict__ gx2, const float* __restrict__ gy2,
                LKParams P, float* __restrict__ x2_out, float* __restrict__ y2_out,
                int* __restrict__ status_out, int* __restrict__ iter_out)
{
    const int f = (blockIdx.x * NT + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= P.n) return;                       // whole warp
    float x = x2_in[f], y = y2_in[f];
    if (!active[f]) {                           // pass-through lane
        if (lane == 0) {
            x2_out[f] = x;
            y2_out[f] = y;
            status_out[f] = KLT_TRACKED;
            iter_out[f] = 0;
        }
        return;
    }
    const float xa = x1[f], ya = y1[f];
    const float n = (float)((2 * P.hw + 1) * (2 * P.hh + 1));
    const LanePixels<NPL> px = lane_pixels<NPL>(lane, P);

    const float* const f1[3] = {img1, gx1, gy1};
    const float* const f2[3] = {img2, gx2, gy2};
    const float* const f2img[1] = {img2};
    float w1[3][NPL];                            // frame-1 windows, kept per level
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
    int status = KLT_TRACKED, it = 0;
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
    if (lane == 0) {
        x2_out[f] = x;
        y2_out[f] = y;
        status_out[f] = status;
        iter_out[f] = it;
    }
}

template <int NPL, bool LIGHTING>
int launch(const float* x1, const float* y1, const float* x2, const float* y2,
           const bool* active, const float* img1, const float* gx1, const float* gy1,
           const float* img2, const float* gx2, const float* gy2, const LKParams& P,
           float* x2o, float* y2o, int* st, int* iters, cudaStream_t stream)
{
    const int blocks = pft_ceil_div(P.n, NT / 32);
    lk_level_kernel<NPL, LIGHTING><<<blocks, NT, 0, stream>>>(
        x1, y1, x2, y2, active, img1, gx1, gy1, img2, gx2, gy2, P, x2o, y2o, st, iters);
    return (int)cudaGetLastError();
}

}  // namespace

// Window sizes up to 8 pixels per lane (ww * wh <= 256, e.g. 15 x 15).
extern "C" int pft_lk_level(const float* x1, const float* y1, const float* x2,
                            const float* y2, const bool* active,
                            const float* img1, const float* gx1, const float* gy1,
                            const float* img2, const float* gx2, const float* gy2,
                            int H, int W, int n, int window_width, int window_height,
                            int max_iterations, float min_displacement,
                            float min_determinant, float max_residue,
                            float step_factor, int lighting_insensitive,
                            float* x2_out, float* y2_out, int* status, int* iteration,
                            void* stream)
{
    if (n <= 0) return 0;
    if (H <= 0 || W <= 0 || window_width % 2 != 1 || window_height % 2 != 1)
        return PFT_INVALID_ARGUMENT;
    const int npl = pft_ceil_div(window_width * window_height, 32);
    LKParams P{H, W, n, window_width / 2, window_height / 2, max_iterations,
               min_displacement, min_determinant, max_residue, step_factor};
    cudaStream_t s = (cudaStream_t)stream;
#define PFT_LK_CASE(K)                                                                  \
    case K:                                                                             \
        return lighting_insensitive                                                     \
            ? launch<K, true>(x1, y1, x2, y2, active, img1, gx1, gy1, img2, gx2, gy2,   \
                              P, x2_out, y2_out, status, iteration, s)                  \
            : launch<K, false>(x1, y1, x2, y2, active, img1, gx1, gy1, img2, gx2, gy2,  \
                               P, x2_out, y2_out, status, iteration, s);
    switch (npl) {
        PFT_LK_CASE(1)
        PFT_LK_CASE(2)
        PFT_LK_CASE(3)
        PFT_LK_CASE(4)
        PFT_LK_CASE(5)
        PFT_LK_CASE(6)
        PFT_LK_CASE(7)
        PFT_LK_CASE(8)
        default:
            return PFT_INVALID_ARGUMENT;
    }
#undef PFT_LK_CASE
}
