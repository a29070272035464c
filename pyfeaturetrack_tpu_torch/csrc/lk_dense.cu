// K8: one pyramid level of dense Lucas-Kanade, the LK level solve at every
// pixel of a level: 2-D flow, or (ONE_D) disparity along the row.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_lk_fused.py: fused_track_level
// (_fused_level_kernel), which ops/flow.flow_level and, in its one_d mode,
// ops/disparity.disparity_level run over every pixel of a level. The
// arithmetic is that of ops/track.track_feature_level (track.py:155-234) on
// the pixel grid, x1 = column, y1 = row, as K2 computes it per feature
// (csrc/lk.cu), with these differences:
//   * the frame-1 positions are implicit: the kernel reads the (u, v) maps,
//     starts at (x1 + u, y1 + v) and writes u = x2 - x1, v = y2 - y1, the
//     status and the iteration count per pixel (flow.py:119-121);
//   * ONE_D (disparity.py:134-178): it reads the disparity map d, starts at
//     x2 = x1 - d on row y1 and writes d = x1 - x2. The step is
//     du = step_factor * sum(diff gx) / gxx with gx = g1x + g2x, SMALL_DET
//     when gxx < min_determinant, convergence on |du| alone, bounds checked
//     at (x2, y1); gy is never read, and there is no lighting variant (the
//     JAX XLA route ignores the flag there, disparity.py:144, :168);
//   * LIGHTING (2-D only): gain and bias as in K2;
//   * no window-size cap: each thread loops over its window.
// Status priorities are K2's: OOB before SMALL_DET inside the loop; after
// it, OOB overrides any status, then LARGE_RESIDUE, then MAX_ITERATIONS.
//
// What bounds it on this card: operations, not bytes. At 480x640 a level-0
// call moves about 15 MB (six level images, the maps in and out), while
// 307,200 pixels x 1.7 iterations x 49 taps x (three frame-2 bilinear
// blends, the residual, two gradient sums, five products and sums), plus
// one blend and a sum per tap for the final residue, are about 1.0 G
// float32 operations on the drift pair of chip_smoke.py; the frame-1
// windows sit on integer coordinates and need no blend. Design, the
// simple one: one thread per pixel, 128 threads per block. Neighbouring
// threads track neighbouring pixels, whose windows overlap, so a warp's
// taps share cache lines; every tap is a read through the read-only path.
// The frame-1 taps are read again at every iteration rather than held in
// registers (three 49-tap windows would spill). Each thread sums its window
// in row-major tap order with one accumulator per sum, starting from 0, the
// order of the plain version's sequential sum, so with -fmad=false both
// give the same bits. The frame-1 window lies on integer coordinates; its
// bilinear blend is kept (weights 1, 0, 0, 0 return p00 exactly).

#include "lk_common.cuh"

namespace {

constexpr int NT = 128;

// Lighting compensation of the frame-2 window at q2 (track.py:120-128):
// gain alpha = sqrt((s11 / n) / (s22 / n)), bias beta = m1 - alpha mean(w2),
// the window sums taken in row-major order from 0.
__device__ __forceinline__ void gain_bias(const float* __restrict__ img2, const Patch& q2,
                                          const LKParams& P, float s11, float m1, float n,
                                          float& alpha, float& beta)
{
    float s22 = 0.0f, sw2 = 0.0f;
    for (int j = 0; j < 2 * P.hh + 1; ++j)
        for (int i = 0; i < 2 * P.hw + 1; ++i) {
            const float w2 = blend_tap(img2, q2, j, i, P);
            s22 = s22 + w2 * w2;
            sw2 = sw2 + w2;
        }
    alpha = sqrtf((s11 / n) / (s22 / n));
    beta = m1 - alpha * (sw2 / n);
}

template <bool ONE_D, bool LIGHTING>
__global__ void __launch_bounds__(NT)
lk_dense_kernel(const float* __restrict__ img1, const float* __restrict__ gx1,
                const float* __restrict__ gy1, const float* __restrict__ img2,
                const float* __restrict__ gx2, const float* __restrict__ gy2,
                const float* __restrict__ u_in, const float* __restrict__ v_in,
                LKParams P, float* __restrict__ u_out, float* __restrict__ v_out,
                int* __restrict__ status_out, int* __restrict__ iter_out)
{
    const int p = blockIdx.x * NT + threadIdx.x;
    if (p >= P.n) return;
    const int row = p / P.W, col = p - row * P.W;
    const float x1 = (float)col, y1 = (float)row;
    float x = ONE_D ? x1 - u_in[p] : x1 + u_in[p];
    float y = ONE_D ? y1 : y1 + v_in[p];
    const int ww = 2 * P.hw + 1, wh = 2 * P.hh + 1;
    const float n = (float)(ww * wh);
    const Patch q1 = patch_at(x1, y1, P);

    float s11 = 0.0f, m1 = 0.0f;
    if (LIGHTING) {
        float sw1 = 0.0f;
        for (int j = 0; j < wh; ++j)
            for (int i = 0; i < ww; ++i) {
                const float w1 = blend_tap(img1, q1, j, i, P);
                s11 = s11 + w1 * w1;
                sw1 = sw1 + w1;
            }
        m1 = sw1 / n;
    }

    const bool ok1 = bounds_ok(x1, y1, P);
    int status = KLT_TRACKED, it = 0;
    for (int step = 0; step < P.max_iterations; ++step) {
        if (!(ok1 && bounds_ok(x, y, P))) {
            status = KLT_OOB;
            break;
        }
        const Patch q2 = patch_at(x, y, P);
        float alpha = 1.0f, beta = 0.0f;
        if (LIGHTING) gain_bias(img2, q2, P, s11, m1, n, alpha, beta);
        float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f, ex = 0.0f, ey = 0.0f;
        for (int j = 0; j < wh; ++j)
            for (int i = 0; i < ww; ++i) {
                const float w1 = blend_tap(img1, q1, j, i, P);
                const float w2 = blend_tap(img2, q2, j, i, P);
                const float g1x = blend_tap(gx1, q1, j, i, P);
                const float g2x = blend_tap(gx2, q2, j, i, P);
                if (ONE_D) {
                    const float gx = g1x + g2x;
                    gxx = gxx + gx * gx;
                    ex = ex + (w1 - w2) * gx;
                } else {
                    const float g1y = blend_tap(gy1, q1, j, i, P);
                    const float g2y = blend_tap(gy2, q2, j, i, P);
                    const float dif = LIGHTING ? w1 - w2 * alpha - beta : w1 - w2;
                    const float gx = LIGHTING ? g1x + alpha * g2x : g1x + g2x;
                    const float gy = LIGHTING ? g1y + alpha * g2y : g1y + g2y;
                    gxx = gxx + gx * gx;
                    gxy = gxy + gx * gy;
                    gyy = gyy + gy * gy;
                    ex = ex + dif * gx;
                    ey = ey + dif * gy;
                }
            }
        ex = P.step_factor * ex;
        if (ONE_D) {
            if (gxx < P.min_determinant) {
                status = KLT_SMALL_DET;
                break;
            }
            const float du = ex / gxx;
            x = x + du;
            ++it;
            if (!(fabsf(du) >= P.min_displacement)) break;
        } else {
            ey = P.step_factor * ey;
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
    }

    if (!bounds_ok(x, y, P)) status = KLT_OOB;
    if (status == KLT_TRACKED) {
        const Patch q2 = patch_at(x, y, P);
        float alpha = 1.0f, beta = 0.0f;
        if (LIGHTING) gain_bias(img2, q2, P, s11, m1, n, alpha, beta);
        float r = 0.0f;
        for (int j = 0; j < wh; ++j)
            for (int i = 0; i < ww; ++i) {
                const float w1 = blend_tap(img1, q1, j, i, P);
                const float w2 = blend_tap(img2, q2, j, i, P);
                r = r + fabsf(LIGHTING ? w1 - w2 * alpha - beta : w1 - w2);
            }
        const float residue = r / n;
        if (residue > P.max_residue) status = KLT_LARGE_RESIDUE;
        else if (it >= P.max_iterations) status = KLT_MAX_ITERATIONS;
    }
    if (ONE_D) {
        u_out[p] = x1 - x;
    } else {
        u_out[p] = x - x1;
        v_out[p] = y - y1;
    }
    status_out[p] = status;
    iter_out[p] = it;
}

template <bool ONE_D, bool LIGHTING>
int launch(const float* img1, const float* gx1, const float* gy1, const float* img2,
           const float* gx2, const float* gy2, const float* u, const float* v,
           const LKParams& P, float* uo, float* vo, int* st, int* iters,
           cudaStream_t stream)
{
    lk_dense_kernel<ONE_D, LIGHTING><<<pft_ceil_div(P.n, NT), NT, 0, stream>>>(
        img1, gx1, gy1, img2, gx2, gy2, u, v, P, uo, vo, st, iters);
    return (int)cudaGetLastError();
}

}  // namespace

// One dense level over the H x W pixel grid. 2-D: u, v in and out. One-d:
// ``u`` is the disparity map d in and out, ``v`` pointers are unused.
extern "C" int pft_lk_dense_level(const float* img1, const float* gx1, const float* gy1,
                                  const float* img2, const float* gx2, const float* gy2,
                                  const float* u, const float* v, int H, int W,
                                  int window_width, int window_height, int max_iterations,
                                  float min_displacement, float min_determinant,
                                  float max_residue, float step_factor,
                                  int lighting_insensitive, int one_d, float* u_out,
                                  float* v_out, int* status, int* iteration, void* stream)
{
    if (H <= 0 || W <= 0 || window_width % 2 != 1 || window_height % 2 != 1)
        return PFT_INVALID_ARGUMENT;
    LKParams P{H, W, H * W, window_width / 2, window_height / 2, max_iterations,
               min_displacement, min_determinant, max_residue, step_factor};
    cudaStream_t s = (cudaStream_t)stream;
    if (one_d)
        return launch<true, false>(img1, gx1, gy1, img2, gx2, gy2, u, v, P, u_out, v_out,
                                   status, iteration, s);
    return lighting_insensitive
        ? launch<false, true>(img1, gx1, gy1, img2, gx2, gy2, u, v, P, u_out, v_out,
                              status, iteration, s)
        : launch<false, false>(img1, gx1, gy1, img2, gx2, gy2, u, v, P, u_out, v_out,
                               status, iteration, s);
}
