// K9: one LK iteration's window terms (gxx, gxy, gyy, ex, ey) for a
// feature batch.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_lk.py: binned_window_terms
// (_window_terms_kernel). Per feature: the position clamped to
// [hw, W - hw - 1.001] x [hh, H - hh - 1.001] (pallas_lk.py:166-167), the
// bilinear frame-2 windows of img2, gx2 and gy2 there, diff = w1 - w2,
// gx = g1x + g2x, gy = g1y + g2y, and the five sums, ex and ey scaled by
// step_factor. The TPU kernel sorts the features into row slabs held in
// VMEM, fetches aligned blocks and shifts them with one-hot matmuls, and
// needs a width >= 256 and a multiple of 128; all of that is Mosaic's and
// is dropped here: every tap is a gather from global memory.
//
// What bounds it on this card: bytes (1000 features read three 7x7
// frame-1 windows and three 8x8 patches each and write five sums, about
// 1.4 MB; about 0.3 M operations). Design: K2's warp layout (csrc/lk.cu):
// one warp per feature, window pixel p on lane p mod 32, the shared
// gather of lk_common.cuh, and the five sums as warp reductions in the
// fixed order ops/cuda_lk.tree_sum reproduces, so kernel and plain version
// give the same bits. Lane 0 writes the feature's row. Windows above 8
// pixels per lane (NPL 0) walk the window pixel by pixel with per-lane
// running sums in the same order.

#include "lk_common.cuh"

namespace {

constexpr int NT = 128;                 // 4 features per block

// The five sums of one window pixel (zero for padding pixels).
struct Terms {
    float xx = 0.0f, xy = 0.0f, yy = 0.0f, ex = 0.0f, ey = 0.0f;
};

__device__ __forceinline__ Terms pixel_terms(float w1, float g1x, float g1y, float w2,
                                             float g2x, float g2y)
{
    const float dif = w1 - w2, gx = g1x + g2x, gy = g1y + g2y;
    return Terms{gx * gx, gx * gy, gy * gy, dif * gx, dif * gy};
}

template <int NPL>
__global__ void __launch_bounds__(NT)
window_terms_kernel(const float* __restrict__ img2, const float* __restrict__ gx2,
                    const float* __restrict__ gy2, const float* __restrict__ w1,
                    const float* __restrict__ g1x, const float* __restrict__ g1y,
                    const float* __restrict__ x2, const float* __restrict__ y2,
                    LKParams P, float x_hi, float y_hi, float* __restrict__ out)
{
    const int f = (blockIdx.x * NT + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= P.n) return;                       // whole warp
    const float x = fminf(fmaxf(x2[f], (float)P.hw), x_hi);
    const float y = fminf(fmaxf(y2[f], (float)P.hh), y_hi);
    const int npix = (2 * P.hw + 1) * (2 * P.hh + 1);
    const long base = (long)f * npix + lane;
    Terms acc;
    if constexpr (NPL == 0) {
        const Patch q = patch_at(x, y, P);
        for (int k = 0; k < pft_ceil_div(npix, 32); ++k) {
            int j, i;
            window_pixel(lane + 32 * k, P, j, i);
            Terms t;
            if (j >= 0) {
                const long qi = base + 32 * k;
                t = pixel_terms(w1[qi], g1x[qi], g1y[qi], blend_tap(img2, q, j, i, P),
                                blend_tap(gx2, q, j, i, P), blend_tap(gy2, q, j, i, P));
            }
            acc = Terms{lane_add(acc.xx, t.xx, k), lane_add(acc.xy, t.xy, k),
                        lane_add(acc.yy, t.yy, k), lane_add(acc.ex, t.ex, k),
                        lane_add(acc.ey, t.ey, k)};
        }
    } else {
        const LanePixels<NPL> px = lane_pixels<NPL>(lane, P);
        const float* const f2[3] = {img2, gx2, gy2};
        float w2[3][NPL];
        gather<NPL, 3>(f2, x, y, px, P, w2);
#pragma unroll
        for (int k = 0; k < NPL; ++k) {
            Terms t;
            if (px.j[k] >= 0) {
                const long qi = base + 32 * k;
                t = pixel_terms(w1[qi], g1x[qi], g1y[qi], w2[0][k], w2[1][k], w2[2][k]);
            }
            acc = Terms{lane_add(acc.xx, t.xx, k), lane_add(acc.xy, t.xy, k),
                        lane_add(acc.yy, t.yy, k), lane_add(acc.ex, t.ex, k),
                        lane_add(acc.ey, t.ey, k)};
        }
    }
    const float gxx = warp_sum(acc.xx), gxy = warp_sum(acc.xy), gyy = warp_sum(acc.yy);
    const float ex = P.step_factor * warp_sum(acc.ex);
    const float ey = P.step_factor * warp_sum(acc.ey);
    if (lane == 0) {
        float* o = out + 5L * f;
        o[0] = gxx;
        o[1] = gxy;
        o[2] = gyy;
        o[3] = ex;
        o[4] = ey;
    }
}

template <int NPL>
int launch(const float* img2, const float* gx2, const float* gy2, const float* w1,
           const float* g1x, const float* g1y, const float* x2, const float* y2,
           const LKParams& P, float x_hi, float y_hi, float* out, cudaStream_t stream)
{
    window_terms_kernel<NPL><<<pft_ceil_div(P.n, NT / 32), NT, 0, stream>>>(
        img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, out);
    return (int)cudaGetLastError();
}

}  // namespace

// Any odd window size. ``x_hi`` / ``y_hi``: the float32 clamp bounds W - hw - 1.001, H - hh - 1.001.
extern "C" int pft_window_terms(const float* img2, const float* gx2, const float* gy2,
                                const float* w1, const float* g1x, const float* g1y,
                                const float* x2, const float* y2, int H, int W, int n,
                                int window_width, int window_height, float step_factor,
                                float x_hi, float y_hi, float* out, void* stream)
{
    if (n <= 0) return 0;
    if (H <= 0 || W <= 0 || window_width % 2 != 1 || window_height % 2 != 1)
        return PFT_INVALID_ARGUMENT;
    LKParams P{H, W, n, window_width / 2, window_height / 2, 0, 0.0f, 0.0f, 0.0f,
               step_factor};
    cudaStream_t s = (cudaStream_t)stream;
    const int npl = pft_ceil_div(window_width * window_height, 32);
    switch (npl <= 8 ? npl : 0) {
        case 0: return launch<0>(img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, out, s);
        case 1: return launch<1>(img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, out, s);
        case 2: return launch<2>(img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, out, s);
        case 3: return launch<3>(img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, out, s);
        case 4: return launch<4>(img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, out, s);
        case 5: return launch<5>(img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, out, s);
        case 6: return launch<6>(img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, out, s);
        case 7: return launch<7>(img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, out, s);
        case 8: return launch<8>(img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, out, s);
        default: return PFT_INVALID_ARGUMENT;
    }
}
