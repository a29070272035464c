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
// give the same bits. Lane 0 writes the feature's row.

#include "lk_common.cuh"

namespace {

constexpr int NT = 128;                 // 4 features per block

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
    const LanePixels<NPL> px = lane_pixels<NPL>(lane, P);
    const float* const f2[3] = {img2, gx2, gy2};
    float w2[3][NPL];
    gather<NPL, 3>(f2, x, y, px, P, w2);

    float txx[NPL], txy[NPL], tyy[NPL], tex[NPL], tey[NPL];
    const long base = (long)f * npix;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
        if (px.j[k] < 0) {
            txx[k] = txy[k] = tyy[k] = tex[k] = tey[k] = 0.0f;
            continue;
        }
        const long q = base + lane + 32 * k;
        const float dif = w1[q] - w2[0][k];
        const float gx = g1x[q] + w2[1][k];
        const float gy = g1y[q] + w2[2][k];
        txx[k] = gx * gx;
        txy[k] = gx * gy;
        tyy[k] = gy * gy;
        tex[k] = dif * gx;
        tey[k] = dif * gy;
    }
    const float gxx = window_sum<NPL>(txx);
    const float gxy = window_sum<NPL>(txy);
    const float gyy = window_sum<NPL>(tyy);
    const float ex = P.step_factor * window_sum<NPL>(tex);
    const float ey = P.step_factor * window_sum<NPL>(tey);
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

// Window sizes up to 8 pixels per lane (ww * wh <= 256, e.g. 15 x 15).
// ``x_hi`` / ``y_hi``: the float32 clamp bounds W - hw - 1.001, H - hh - 1.001.
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
    switch (pft_ceil_div(window_width * window_height, 32)) {
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
