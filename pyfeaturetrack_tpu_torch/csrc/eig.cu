// K3: quantized min-eigenvalue map, the standalone entry.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_eig.py: min_eig_map_pallas
// (_eig_kernel), which is ops/select.quantized_min_eig_map in one pass.
//
// What it computes: eig_common.cuh, whose arithmetic K1's level-0 tile
// (pyramid.cu) runs as well: the main paths take the map from that launch,
// beside the gradients it stores, and no longer launch this kernel. It
// stays as the counterpart of min_eig_map_pallas(gradx, grady), for
// gradients that are already in device memory.
//
// What bounds it on this card: bytes (two float reads and one int write per
// pixel; ~50 FLOPs per pixel). Each block loads a 2-D output tile of gx and
// gy plus a (hh, hw) halo into shared memory once, keeps the vertical sums
// in shared memory and writes only the final int32 map.

#include "common.cuh"
#include "eig_common.cuh"

namespace {

constexpr int TH = 16;    // output rows per tile
constexpr int TW = 64;    // output cols per tile
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
eig_kernel(const float* __restrict__ gxm, const float* __restrict__ gym,
           int* __restrict__ out, int H, int W, int ww, int wh)
{
    extern __shared__ float sm[];
    const int hw = ww / 2, hh = wh / 2;
    const int R0 = blockIdx.y * TH, C0 = blockIdx.x * TW;
    const int in_rows = TH + wh - 1, in_cols = TW + ww - 1;
    const int n_in = in_rows * in_cols, n_v = TH * in_cols;
    float* sgx = sm;
    float* sgy = sgx + n_in;
    float* vxx = sgy + n_in;
    float* vxy = vxx + n_v;
    float* vyy = vxy + n_v;

    for (int i = threadIdx.x; i < n_in; i += NT) {
        const int gr = R0 - hh + i / in_cols, gc = C0 - hw + i % in_cols;
        float a = 0.0f, b = 0.0f;
        if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
            a = gxm[gr * W + gc];
            b = gym[gr * W + gc];
        }
        sgx[i] = a;
        sgy[i] = b;
    }
    __syncthreads();
    // vertical window sums: output row R0 + lr reads local rows lr .. lr + wh - 1
    for (int i = threadIdx.x; i < n_v; i += NT)
        eig_column_sums(sgx + i, sgy + i, in_cols, wh, vxx[i], vxy[i], vyy[i]);
    __syncthreads();
    for (int i = threadIdx.x; i < TH * TW; i += NT) {
        const int lr = i / TW, lc = i % TW, gr = R0 + lr, gc = C0 + lc;
        if (gr >= H || gc >= W) continue;
        const int o = lr * in_cols + lc;          // column gc - hw
        out[gr * W + gc] = (gr >= hh && gr < H - hh && gc >= hw && gc < W - hw)
                               ? eig_quantized(vxx + o, vxy + o, vyy + o, ww)
                               : 0;
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
    const size_t smem = sizeof(float) * (2 * in_rows * in_cols + 3 * TH * in_cols);
    if (smem > 227 * 1024) return PFT_INVALID_ARGUMENT;
    pft_allow_smem(eig_kernel, smem);
    dim3 grid(pft_ceil_div(W, TW), pft_ceil_div(H, TH));
    eig_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(gx, gy, out, H, W, window_width,
                                                          window_height);
    return (int)cudaGetLastError();
}
