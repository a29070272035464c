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
// What bounds it on this card: latency of dependent gathers and the serial
// per-feature solve, not bytes or FLOPs (1000 features x a few iterations x
// 225 samples x 3 images). Design: one warp per feature, window sample s on
// lane s mod 32 (8 passes for 15x15); the template stays in registers for
// the whole loop; every lane ends a butterfly with the same sums, so every
// lane runs the (tiny) Gauss-Jordan itself and all branches are
// warp-uniform; each warp leaves the loop as soon as its feature converges
// or fails, which equals the plain version's masked fixed-trip loop because
// an inactive lane changes nothing. Lane 0 writes the feature's result and
// its Gauss-Newton update count.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 128;                 // 4 features per block
constexpr int KLT_TRACKED = 0;
constexpr int KLT_SMALL_DET = -2;
constexpr int KLT_OOB = -4;
constexpr int KLT_LARGE_RESIDUE = -5;
constexpr float ONE_PLUS_EPS = 1.001f;  // ops/affine._ONE_PLUS_EPS

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

__device__ __forceinline__ float blend(const float* __restrict__ im, int i00, int W,
                                       float ax, float ay)
{
    const float p00 = im[i00], p01 = im[i00 + 1];
    const float p10 = im[i00 + W], p11 = im[i00 + W + 1];
    return (1.0f - ax) * (1.0f - ay) * p00 + ax * (1.0f - ay) * p01 +
           (1.0f - ax) * ay * p10 + ax * ay * p11;
}

template <int NPL>
struct Window {
    float tm[NPL];      // template samples of this lane
    float oi[NPL];      // column offset i - hw
    float oj[NPL];      // row offset j - hh
    bool in[NPL];       // sample exists (not padding beyond ww * wh)
};

template <int NPL>
__device__ __forceinline__ bool warp_oob(const Window<NPL>& w, float x, float y,
                                         float a00, float a01, float a10, float a11,
                                         const AffParams& P)
{
    bool bad = false;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
        if (!w.in[k]) continue;
        const float xs = x + a00 * w.oi[k] + a01 * w.oj[k];
        const float ys = y + a10 * w.oi[k] + a11 * w.oj[k];
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

template <int NPL, int MODE>
__global__ void __launch_bounds__(NT)
affine_kernel(const float* __restrict__ tmpl, const float* __restrict__ img2,
              const float* __restrict__ gx2, const float* __restrict__ gy2,
              const float* __restrict__ x_in, const float* __restrict__ y_in,
              const float* __restrict__ A_in, const bool* __restrict__ check,
              AffParams P, float* __restrict__ x_out, float* __restrict__ y_out,
              float* __restrict__ A_out, int* __restrict__ status_out,
              int* __restrict__ nit_out)
{
    constexpr int NP = MODE == 0 ? 2 : (MODE == 1 ? 4 : 6);
    constexpr int NS = NP * (NP + 1) / 2 + NP;   // J J^T upper triangle, then J diff
    const int f = (blockIdx.x * NT + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= P.n) return;                        // whole warp

    const float x0 = x_in[f], y0 = y_in[f];
    float x = x0, y = y0;
    float a00 = A_in[4 * f], a01 = A_in[4 * f + 1];
    float a10 = A_in[4 * f + 2], a11 = A_in[4 * f + 3];
    int status = KLT_TRACKED, it = 0;

    if (check[f]) {
        const int ww = 2 * P.hw + 1, npix = ww * (2 * P.hh + 1);
        Window<NPL> w;
#pragma unroll
        for (int k = 0; k < NPL; ++k) {
            const int p = lane + 32 * k;
            w.in[k] = p < npix;
            const int r = w.in[k] ? p / ww : 0, c = w.in[k] ? p - r * ww : 0;
            w.oi[k] = (float)(c - P.hw);
            w.oj[k] = (float)(r - P.hh);
            w.tm[k] = w.in[k] ? tmpl[(size_t)f * npix + p] : 0.0f;
        }

        for (int step = 0; step < P.max_iterations; ++step) {
            if (warp_oob<NPL>(w, x, y, a00, a01, a10, a11, P)) {
                status = KLT_OOB;
                break;
            }
            float acc[NS];
#pragma unroll
            for (int k = 0; k < NPL; ++k) {
                float v[NS];
                if (w.in[k]) {
                    const float xs = x + a00 * w.oi[k] + a01 * w.oj[k];
                    const float ys = y + a10 * w.oi[k] + a11 * w.oj[k];
                    float ax, ay;
                    const int i00 = tap(xs, ys, P, ax, ay);
                    const float diff = w.tm[k] - blend(img2, i00, P.W, ax, ay);
                    float J[NP];
                    jacobian<MODE>(blend(gx2, i00, P.W, ax, ay),
                                   blend(gy2, i00, P.W, ax, ay), w.oi[k], w.oj[k], J);
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
#pragma unroll
            for (int s = 0; s < NS; ++s) acc[s] = warp_sum(acc[s]);

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
            if (fabsf(dx) < P.min_displacement && fabsf(dy) < P.min_displacement)
                break;
        }

        if (status == KLT_TRACKED && warp_oob<NPL>(w, x, y, a00, a01, a10, a11, P))
            status = KLT_OOB;
        if (status == KLT_TRACKED) {
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < NPL; ++k) {
                float v = 0.0f;
                if (w.in[k]) {
                    const float xs = x + a00 * w.oi[k] + a01 * w.oj[k];
                    const float ys = y + a10 * w.oi[k] + a11 * w.oj[k];
                    float ax, ay;
                    const int i00 = tap(xs, ys, P, ax, ay);
                    v = fabsf(w.tm[k] - blend(img2, i00, P.W, ax, ay));
                }
                acc = k == 0 ? v : acc + v;
            }
            const float residue = warp_sum(acc) / (float)npix;
            if (residue > P.max_residue) status = KLT_LARGE_RESIDUE;
        }
        if (status == KLT_TRACKED) {
            // torch.maximum semantics: a NaN distance never passes the test
            const float ddx = fabsf(x - x0), ddy = fabsf(y - y0);
            if (!isnan(ddx) && !isnan(ddy) && fmaxf(ddx, ddy) > P.max_drift)
                status = KLT_OOB;
        }
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

template <int NPL, int MODE>
int launch(const float* tmpl, const float* img2, const float* gx2, const float* gy2,
           const float* x0, const float* y0, const float* A0, const bool* check,
           const AffParams& P, float* xo, float* yo, float* Ao, int* st, int* nit,
           cudaStream_t stream)
{
    const int blocks = pft_ceil_div(P.n, NT / 32);
    affine_kernel<NPL, MODE><<<blocks, NT, 0, stream>>>(
        tmpl, img2, gx2, gy2, x0, y0, A0, check, P, xo, yo, Ao, st, nit);
    return (int)cudaGetLastError();
}

template <int NPL>
int launch_mode(int mode, const float* tmpl, const float* img2, const float* gx2,
                const float* gy2, const float* x0, const float* y0, const float* A0,
                const bool* check, const AffParams& P, float* xo, float* yo, float* Ao,
                int* st, int* nit, cudaStream_t s)
{
    switch (mode) {
        case 0:
            return launch<NPL, 0>(tmpl, img2, gx2, gy2, x0, y0, A0, check, P, xo, yo, Ao,
                                  st, nit, s);
        case 1:
            return launch<NPL, 1>(tmpl, img2, gx2, gy2, x0, y0, A0, check, P, xo, yo, Ao,
                                  st, nit, s);
        case 2:
            return launch<NPL, 2>(tmpl, img2, gx2, gy2, x0, y0, A0, check, P, xo, yo, Ao,
                                  st, nit, s);
        default:
            return PFT_INVALID_ARGUMENT;
    }
}

}  // namespace

// Odd windows of up to 8 samples per lane (window_width * window_height <=
// 256, e.g. 15 x 15). A0 is [n, 2, 2] row-major; outputs likewise.
extern "C" int pft_affine_track(const float* tmpl, const float* img2, const float* gx2,
                                const float* gy2, const float* x0, const float* y0,
                                const float* A0, const bool* check, int H, int W, int n,
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
    const int npl = pft_ceil_div(window_width * window_height, 32);
    AffParams P{H, W, n, window_width / 2, window_height / 2, max_iterations,
                min_displacement, min_determinant, max_residue, max_displacement_differ};
    cudaStream_t s = (cudaStream_t)stream;
#define PFT_AFFINE_CASE(K)                                                               \
    case K:                                                                              \
        return launch_mode<K>(mode, tmpl, img2, gx2, gy2, x0, y0, A0, check, P, x_out,  \
                              y_out, A_out, status, nit, s);
    switch (npl) {
        PFT_AFFINE_CASE(1)
        PFT_AFFINE_CASE(2)
        PFT_AFFINE_CASE(3)
        PFT_AFFINE_CASE(4)
        PFT_AFFINE_CASE(5)
        PFT_AFFINE_CASE(6)
        PFT_AFFINE_CASE(7)
        PFT_AFFINE_CASE(8)
        default:
            return PFT_INVALID_ARGUMENT;
    }
#undef PFT_AFFINE_CASE
}
