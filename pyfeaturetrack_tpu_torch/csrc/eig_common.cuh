// The arithmetic of K3's quantized min-eigenvalue map, shared by its two
// launches: the standalone eig_kernel (eig.cu) and the eig stage of K1's
// level-0 tile (pyramid.cu). One implementation decides every selection.
//
// Per pixel: the gradient products gxx, gxy, gyy; their window sums,
// vertical first (eig_column_sums), then horizontal (eig_quantized), each
// in ascending tap order (pallas_eig.py:71-79); the min eigenvalue
// ((gxx+gyy) - sqrt((gxx-gyy)^2 + 4 gxy^2)) / 2; a clamp at 2147483520 (the
// largest float below 2^31, select.py:44); truncation toward zero to int32.
// The caller zeroes the map outside [hh, H-hh) x [hw, W-hw). A +-1 change
// reorders selection candidates, so the order of every sum is fixed and the
// library is built with -fmad=false: each product and sum rounds as the
// plain version's (ops/cuda_eig.min_eig_reference) do.
//
// The sums wait on shared-memory loads (a thread's taps feed a chain of
// dependent adds): the tap loops are unrolled by 4 so that a thread's loads
// issue together. Summing several neighbouring outputs per thread from one
// read of each tap was timed as well and was no faster on the H100.
#pragma once

namespace {

constexpr float EIG_LIMIT = 2147483520.0f;

// The vertical window sums of one column: gx, gy at `pitch` apart over wh
// rows, their products summed in ascending row order.
__device__ __forceinline__ void eig_column_sums(const float* gx, const float* gy, int pitch,
                                                int wh, float& sxx, float& sxy, float& syy)
{
    float a = gx[0], b = gy[0];
    float xx = a * a, xy = a * b, yy = b * b;
#pragma unroll 4
    for (int k = 1; k < wh; ++k) {
        a = gx[k * pitch];
        b = gy[k * pitch];
        xx = xx + a * a;
        xy = xy + a * b;
        yy = yy + b * b;
    }
    sxx = xx;
    sxy = xy;
    syy = yy;
}

// One interior pixel of the map from the vertical sums of its ww columns
// (consecutive): the horizontal sums, the eigenvalue, the clamp and the
// truncation.
__device__ __forceinline__ int eig_quantized(const float* vxx, const float* vxy,
                                             const float* vyy, int ww)
{
    float sxx = vxx[0], sxy = vxy[0], syy = vyy[0];
#pragma unroll 4
    for (int k = 1; k < ww; ++k) {
        sxx = sxx + vxx[k];
        sxy = sxy + vxy[k];
        syy = syy + vyy[k];
    }
    const float dd = sxx - syy;
    const float disc = sqrtf(dd * dd + 4.0f * sxy * sxy);
    float eig = ((sxx + syy) - disc) * 0.5f;
    if (eig > EIG_LIMIT) eig = EIG_LIMIT;
    return __float2int_rz(eig);
}

}  // namespace
