// K2: pyramidal translational Lucas-Kanade for a feature batch.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_lk_vec.py: vec_track_level
// (_vec_level_kernel) and its stale-lane fallback
// vec_track_level_with_fallback, together with the coarse-to-fine level
// loop that the JAX package runs around them in XLA
// (pyfeaturetrack_tpu/ops/track.py:337-402), because a Mosaic kernel runs
// one level per call. The per-level arithmetic is lk_level_body
// (lk_common.cuh), that of ops/track.track_feature_level lane for lane:
//   * bilinear windows from the (wh+1) x (ww+1) integer patch whose top-left
//     is clamp(floor(x) - hw, 0, W - 2 - 2 hw) (interp.py:73-74), blended as
//     (1-a)(1-b) p00 + a(1-b) p01 + (1-a) b p10 + a b p11 in that order;
//   * the fixed-trip iteration, SMALL_DET, OOB, LARGE_RESIDUE and
//     MAX_ITERATIONS in the reference's order;
//   * the lighting-insensitive variant (gain alpha, bias beta) as a
//     compile-time switch;
//   * levels stored as float32 or bfloat16 (cfg.image_dtype): the storage
//     type is a template parameter of the same kernel, each tap upcast to
//     float32 where it is read, the window sums float32.
//
// Two entries:
//   * pft_lk_pyramid, the tracker's: one launch per track call. A warp
//     walks its feature's levels coarse to fine as ops/track.py:97-139 of
//     the plain version does: x / s^L as an IEEE division by the float32
//     s^L, * s per level, the level status carried, the walk stopped at the
//     first SMALL_DET or OOB (the reference's "broken" lanes keep that
//     level's position), then the final classification (out-of-view test
//     against borderx / bordery, OOB first, lost lanes to (-1, -1), lanes
//     with val < 0 passed through unchanged). Level pointers and shapes pass
//     by value up to PFT_LK_MAX_LEVELS levels (no frame of int32 size has
//     more non-empty levels at subsampling 2 or more); a deeper pyramid
//     (subsampling 1) passes them as a table in device memory. Guided starts
//     (ops/track.py:305-309): with x_init / y_init given, the coarsest
//     level's frame-2 start is x_init / s^L (the same IEEE division) while
//     the frame-1 anchor stays x / s^L; nullptr starts at x / s^L.
//   * pft_lk_level: one level for given positions (ops/cuda_lk.lk_level).
//
// What bounds it on this card: latency of dependent gathers, not bytes or
// FLOPs (1000 features x <= 10 iterations x 49 pixels x 3 images per
// level), and, around a one-level kernel, the host: the level loop's
// scaling, freezing and selects were some 55 eager PyTorch ops per call.
// Design: one warp per feature, the ww*wh window pixels spread over the 32
// lanes (pixel p = lane + 32 k); the frame-1 windows of img, gx, gy are
// read once per level and stay in registers (windows of up to 8 pixels per
// lane, 15x15; larger windows walk the window pixel by pixel and re-read
// their taps: lk_level_body_any); each warp leaves a level's
// iteration loop, and the level walk, on its own. The window sums are warp
// reductions in one fixed order (per-lane ascending k, then an xor
// butterfly 16, 8, 4, 2, 1), which the plain version reproduces, so both
// give the same bits. Lane 0 writes the feature's result and, into the
// device counters (common.cuh), the Gauss-Newton steps its levels ran and
// the levels it entered: two atomics a warp, on the slot of its feature.

#include "lk_common.cuh"

#define PFT_LK_MAX_LEVELS 32

namespace {

constexpr int NT = 128;                 // 4 features per block

// The pyramid pair, level r at index r: six [H, W] images each, in the
// launch's storage type.
struct LKLevels {
    const void* im[PFT_LK_MAX_LEVELS][6];    // img1, gx1, gy1, img2, gx2, gy2
    int H[PFT_LK_MAX_LEVELS], W[PFT_LK_MAX_LEVELS];
};

template <int NPL, bool LIGHTING, typename TS>
__global__ void __launch_bounds__(NT)
lk_level_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
                const float* __restrict__ x2_in, const float* __restrict__ y2_in,
                const bool* __restrict__ active,
                const TS* __restrict__ img1, const TS* __restrict__ gx1,
                const TS* __restrict__ gy1, const TS* __restrict__ img2,
                const TS* __restrict__ gx2, const TS* __restrict__ gy2,
                LKParams P, float* __restrict__ x2_out, float* __restrict__ y2_out,
                int* __restrict__ status_out, int* __restrict__ iter_out)
{
    const int f = (blockIdx.x * NT + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= P.n) return;                       // whole warp
    float x = x2_in[f], y = y2_in[f];
    int status = KLT_TRACKED, it = 0;
    if (active[f]) {
        const TS* const f1[3] = {img1, gx1, gy1};
        const TS* const f2[3] = {img2, gx2, gy2};
        status = lk_level_body<NPL, LIGHTING, TS>(f1, f2, x1[f], y1[f], x, y, it, lane, P);
    }
    if (lane == 0) {
        x2_out[f] = x;
        y2_out[f] = y;
        status_out[f] = status;
        iter_out[f] = it;
    }
}

template <int NPL, bool LIGHTING, typename TS>
__global__ void __launch_bounds__(NT)
lk_pyramid_kernel(const float* __restrict__ x_in, const float* __restrict__ y_in,
                  const int* __restrict__ val_in, LKLevels L,
                  const void* const* __restrict__ dev_im, const int* __restrict__ dev_hw,
                  int n_levels, LKParams P, float scale, float s, int borderx, int bordery,
                  const float* __restrict__ x_init, const float* __restrict__ y_init,
                  float* __restrict__ x_out, float* __restrict__ y_out,
                  int* __restrict__ val_out, unsigned long long* __restrict__ counters)
{
    const int f = (blockIdx.x * NT + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= P.n) return;                       // whole warp
    const float x0 = x_in[f], y0 = y_in[f];
    const int v0 = val_in[f];
    if (v0 < 0) {                               // dead lane: passed through
        if (lane == 0) {
            x_out[f] = x0;
            y_out[f] = y0;
            val_out[f] = v0;
        }
        return;
    }
    float xloc = x0 / scale, yloc = y0 / scale;
    float xout = xloc, yout = yloc;
    if (x_init != nullptr) {                    // guided start
        xout = x_init[f] / scale;
        yout = y_init[f] / scale;
    }
    int status = KLT_TRACKED;
    int steps = 0, levels = 0;
    for (int r = n_levels - 1; r >= 0; --r) {
        xloc = xloc * s;
        yloc = yloc * s;
        xout = xout * s;
        yout = yout * s;
        LKParams Q = P;
        const TS* im[6];
        if (dev_im == nullptr) {
            Q.H = L.H[r];
            Q.W = L.W[r];
            for (int m = 0; m < 6; ++m) im[m] = static_cast<const TS*>(L.im[r][m]);
        } else {
            Q.H = dev_hw[2 * r];
            Q.W = dev_hw[2 * r + 1];
            for (int m = 0; m < 6; ++m) im[m] = static_cast<const TS*>(dev_im[6 * r + m]);
        }
        const TS* const f1[3] = {im[0], im[1], im[2]};
        const TS* const f2[3] = {im[3], im[4], im[5]};
        int it;
        status = lk_level_body<NPL, LIGHTING, TS>(f1, f2, xloc, yloc, xout, yout, it, lane, Q);
        steps += it;
        ++levels;
        // broken: the reference leaves its level loop on these two codes
        if (status == KLT_SMALL_DET || status == KLT_OOB) break;
    }
    // final classification (KLTTrackFeatures post-loop), in level-0 pixels
    const bool out_of_view = xout < (float)borderx ||
                             xout > (float)(P.W - 1 - borderx) ||
                             yout < (float)bordery ||
                             yout > (float)(P.H - 1 - bordery);
    const bool lost = status != KLT_TRACKED || out_of_view;
    if (lane == 0) {
        x_out[f] = lost ? -1.0f : xout;
        y_out[f] = lost ? -1.0f : yout;
        val_out[f] = (status == KLT_OOB || out_of_view) ? KLT_OOB : status;
        pft_count(counters, PFT_K2_GN_STEPS, f, (unsigned long long)steps);
        pft_count(counters, PFT_K2_LANE_LEVELS, f, (unsigned long long)levels);
    }
}

}  // namespace

// NPL 0: windows above 8 pixels per lane (lk_level_body_any).
#define PFT_LK_SWITCH(npl, LAUNCH)   \
    switch (npl <= 8 ? npl : 0) {    \
        LAUNCH(0)                    \
        LAUNCH(1)                    \
        LAUNCH(2)                    \
        LAUNCH(3)                    \
        LAUNCH(4)                    \
        LAUNCH(5)                    \
        LAUNCH(6)                    \
        LAUNCH(7)                    \
        LAUNCH(8)                    \
        default:                     \
            return PFT_INVALID_ARGUMENT; \
    }

// Any odd window size; the six images float32 (bf16 0) or bfloat16 (1).
extern "C" int pft_lk_level(const float* x1, const float* y1, const float* x2,
                            const float* y2, const bool* active,
                            const void* img1, const void* gx1, const void* gy1,
                            const void* img2, const void* gx2, const void* gy2, int bf16,
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
    const LKParams P{H, W, n, window_width / 2, window_height / 2, max_iterations,
                     min_displacement, min_determinant, max_residue, step_factor};
    const int blocks = pft_ceil_div(n, NT / 32);
    cudaStream_t s = (cudaStream_t)stream;
#define PFT_LK_LEVEL_TS(K, LI, TS)                                                       \
    lk_level_kernel<K, LI, TS><<<blocks, NT, 0, s>>>(                                    \
        x1, y1, x2, y2, active, (const TS*)img1, (const TS*)gx1, (const TS*)gy1,         \
        (const TS*)img2, (const TS*)gx2, (const TS*)gy2, P, x2_out, y2_out, status,      \
        iteration)
#define PFT_LK_LEVEL(K)                                                                  \
    case K:                                                                              \
        if (lighting_insensitive) {                                                      \
            if (bf16) PFT_LK_LEVEL_TS(K, true, __nv_bfloat16);                           \
            else PFT_LK_LEVEL_TS(K, true, float);                                        \
        } else {                                                                         \
            if (bf16) PFT_LK_LEVEL_TS(K, false, __nv_bfloat16);                          \
            else PFT_LK_LEVEL_TS(K, false, float);                                       \
        }                                                                                \
        return (int)cudaGetLastError();
    PFT_LK_SWITCH(npl, PFT_LK_LEVEL)
#undef PFT_LK_LEVEL
#undef PFT_LK_LEVEL_TS
}

// levels: n_levels * 6 device pointers (level r: img1, gx1, gy1, img2, gx2,
// gy2; every image float32 for bf16 0, bfloat16 for bf16 1), shapes:
// n_levels * 2 ints (H, W), both host arrays read here; above
// PFT_LK_MAX_LEVELS levels the same two tables in device memory (dev_levels,
// dev_shapes), which the kernel reads instead.
// scale: float32 subsampling^n_levels; x, y, val in, x, y, val out [n];
// x_init, y_init: the guided frame-2 starts [n], both or neither (nullptr).
// counters: the device counters (common.cuh), or nullptr.
extern "C" int pft_lk_pyramid(const float* x, const float* y, const int* val, int n,
                              const void* const* levels, const int* shapes,
                              int n_levels, int bf16, int window_width, int window_height,
                              int max_iterations, float min_displacement,
                              float min_determinant, float max_residue,
                              float step_factor, int lighting_insensitive,
                              float scale, float subsampling, int borderx, int bordery,
                              const void* const* dev_levels, const int* dev_shapes,
                              const float* x_init, const float* y_init,
                              float* x_out, float* y_out, int* val_out,
                              unsigned long long* counters, void* stream)
{
    if (n <= 0) return 0;
    const bool by_value = n_levels <= PFT_LK_MAX_LEVELS;
    if (n_levels < 1 || window_width % 2 != 1 || window_height % 2 != 1 ||
        (!by_value && (dev_levels == nullptr || dev_shapes == nullptr)) ||
        ((x_init == nullptr) != (y_init == nullptr)))
        return PFT_INVALID_ARGUMENT;
    LKLevels L{};
    for (int r = 0; r < n_levels; ++r) {
        if (shapes[2 * r] <= 0 || shapes[2 * r + 1] <= 0) return PFT_INVALID_ARGUMENT;
        if (!by_value) continue;
        for (int m = 0; m < 6; ++m) L.im[r][m] = levels[6 * r + m];
        L.H[r] = shapes[2 * r];
        L.W[r] = shapes[2 * r + 1];
    }
    if (by_value) {
        dev_levels = nullptr;
        dev_shapes = nullptr;
    }
    const int npl = pft_ceil_div(window_width * window_height, 32);
    const LKParams P{shapes[0], shapes[1], n, window_width / 2, window_height / 2,
                     max_iterations, min_displacement, min_determinant, max_residue,
                     step_factor};
    const int blocks = pft_ceil_div(n, NT / 32);
    cudaStream_t s = (cudaStream_t)stream;
#define PFT_LK_PYRAMID_TS(K, LI, TS)                                                     \
    lk_pyramid_kernel<K, LI, TS><<<blocks, NT, 0, s>>>(                                  \
        x, y, val, L, dev_levels, dev_shapes, n_levels, P, scale, subsampling, borderx,  \
        bordery, x_init, y_init, x_out, y_out, val_out, counters)
#define PFT_LK_PYRAMID(K)                                                                \
    case K:                                                                              \
        if (lighting_insensitive) {                                                      \
            if (bf16) PFT_LK_PYRAMID_TS(K, true, __nv_bfloat16);                         \
            else PFT_LK_PYRAMID_TS(K, true, float);                                      \
        } else {                                                                         \
            if (bf16) PFT_LK_PYRAMID_TS(K, false, __nv_bfloat16);                        \
            else PFT_LK_PYRAMID_TS(K, false, float);                                     \
        }                                                                                \
        return (int)cudaGetLastError();
    PFT_LK_SWITCH(npl, PFT_LK_PYRAMID)
#undef PFT_LK_PYRAMID
#undef PFT_LK_PYRAMID_TS
}
