// K3: quantized min-eigenvalue map.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_eig.py: min_eig_map_pallas
// (_eig_kernel), which is ops/select.quantized_min_eig_map in one pass.
//
// What it computes: the gradient products gxx, gxy, gyy; their window sums,
// vertical first, then horizontal, each in ascending tap order
// (pallas_eig.py:71-79); the min eigenvalue ((gxx+gyy) - sqrt((gxx-gyy)^2 +
// 4 gxy^2)) / 2; zero outside [hh, H-hh) x [hw, W-hw); a clamp at
// 2147483520 (the largest float below 2^31, select.py:44); truncation
// toward zero to int32. A +-1 change here reorders selection candidates, so
// the order of every sum is fixed, and the library is built with
// -fmad=false so each product and sum rounds as the plain version's do.
//
// What bounds it on this card: bytes (two float reads and one int write per
// pixel; ~50 FLOPs per pixel). Each block loads a 2-D output tile of gx and
// gy plus a (hh, hw) halo into shared memory once, forms the three products
// there, keeps the vertical sums in shared memory and writes only the final
// int32 map.

#include "common.cuh"

namespace {

constexpr int TH = 16;    // output rows per tile
constexpr int TW = 64;    // output cols per tile
constexpr int NT = 256;
constexpr float EIG_LIMIT = 2147483520.0f;

__global__ void __launch_bounds__(NT)
eig_kernel(const float* __restrict__ gxm, const float* __restrict__ gym,
           int* __restrict__ out, int H, int W, int ww, int wh)
{
    extern __shared__ float sm[];
    const int hw = ww / 2, hh = wh / 2;
    const int R0 = blockIdx.y * TH, C0 = blockIdx.x * TW;
    const int in_rows = TH + wh - 1, in_cols = TW + ww - 1;
    const int n_in = in_rows * in_cols, n_v = TH * in_cols;
    float* pxx = sm;
    float* pxy = pxx + n_in;
    float* pyy = pxy + n_in;
    float* vxx = pyy + n_in;
    float* vxy = vxx + n_v;
    float* vyy = vxy + n_v;

    for (int i = threadIdx.x; i < n_in; i += NT) {
        const int gr = R0 - hh + i / in_cols, gc = C0 - hw + i % in_cols;
        float a = 0.0f, b = 0.0f;
        if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
            a = gxm[gr * W + gc];
            b = gym[gr * W + gc];
        }
        pxx[i] = a * a;
        pxy[i] = a * b;
        pyy[i] = b * b;
    }
    __syncthreads();
    // vertical window sums: output row R0 + lr reads local rows lr .. lr + wh - 1
    for (int i = threadIdx.x; i < n_v; i += NT) {
        const int lr = i / in_cols, lc = i % in_cols;
        const int o = lr * in_cols + lc;
        float sxx = pxx[o], sxy = pxy[o], syy = pyy[o];
        for (int k = 1; k < wh; ++k) {
            sxx = sxx + pxx[o + k * in_cols];
            sxy = sxy + pxy[o + k * in_cols];
            syy = syy + pyy[o + k * in_cols];
        }
        vxx[i] = sxx;
        vxy[i] = sxy;
        vyy[i] = syy;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TH * TW; i += NT) {
        const int lr = i / TW, lc = i % TW, gr = R0 + lr, gc = C0 + lc;
        if (gr >= H || gc >= W) continue;
        int q = 0;
        if (gr >= hh && gr < H - hh && gc >= hw && gc < W - hw) {
            const int o = lr * in_cols + lc;      // column gc - hw
            float sxx = vxx[o], sxy = vxy[o], syy = vyy[o];
            for (int k = 1; k < ww; ++k) {
                sxx = sxx + vxx[o + k];
                sxy = sxy + vxy[o + k];
                syy = syy + vyy[o + k];
            }
            const float dd = sxx - syy;
            const float disc = sqrtf(dd * dd + 4.0f * sxy * sxy);
            float eig = ((sxx + syy) - disc) * 0.5f;
            if (eig > EIG_LIMIT) eig = EIG_LIMIT;
            q = __float2int_rz(eig);
        }
        out[gr * W + gc] = q;
    }
}

}  // namespace

extern "C" int pft_min_eig_map(const float* gx, const float* gy, int* out,
                               int H, int W, int window_width, int window_height,
                               void* stream)
{
    if (H <= 0 || W <= 0 || window_width < 1 || window_height < 1)
        return PFT_INVALID_ARGUMENT;
    const int in_rows = TH + window_height - 1, in_cols = TW + window_width - 1;
    const size_t smem = sizeof(float) * (3 * in_rows * in_cols + 3 * TH * in_cols);
    if (smem > 227 * 1024) return PFT_INVALID_ARGUMENT;
    pft_allow_smem(eig_kernel, smem);
    dim3 grid(pft_ceil_div(W, TW), pft_ceil_div(H, TH));
    eig_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(gx, gy, out, H, W, window_width,
                                                          window_height);
    return (int)cudaGetLastError();
}
