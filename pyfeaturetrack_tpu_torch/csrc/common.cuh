// Shared helpers for the pyfeaturetrack_tpu_torch kernels.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success) so the ctypes wrapper can
// raise on a refused launch. The library is built with -fmad=false: each
// product and sum rounds separately, exactly as the plain PyTorch
// versions do, which is what lets K1 and K3 agree with them bit for bit.
#pragma once

#include <cuda_runtime.h>

#define PFT_MAX_TAPS 71   // ops/kernels.MAX_KERNEL_WIDTH
#define PFT_INVALID_ARGUMENT 9999

// Flipped 1-D taps (krev = k[::-1]) and their radius, passed by value.
struct PftTaps {
    float k[PFT_MAX_TAPS];
    int r;
};

static inline int pft_load_taps(PftTaps* t, const float* krev, int n) {
    if (n < 1 || n > PFT_MAX_TAPS || (n & 1) == 0) return 0;
    for (int i = 0; i < n; ++i) t->k[i] = krev[i];
    for (int i = n; i < PFT_MAX_TAPS; ++i) t->k[i] = 0.0f;
    t->r = n / 2;
    return 1;
}

// Raise the dynamic shared-memory cap when a launch needs more than the
// default 48 KB (H100: up to 227 KB per block).
template <typename K>
static inline void pft_allow_smem(K kernel, size_t bytes) {
    if (bytes > 48 * 1024)
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
}

__host__ __device__ static inline int pft_ceil_div(int a, int b)
{
    return (a + b - 1) / b;
}
