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
// is dropped here.
//
// What bounds it on this card: at the main paths' 1000 features, latency
// (about 1.4 MB, fewer than two blocks per SM); at large batches, bytes
// (three frame-1 windows and three (ww+1)(wh+1) frame-2 patches read once
// per feature, five sums written). Design, for latency:
//   * One round of independent loads at entry: the feature's position and
//     its frame-1 window values (contiguous, npix floats per image), each
//     lane its own pixels. The frame-2 reads then wait for one round trip.
//   * The frame-2 patch of each image, (wh+1) x (ww+1) integer pixels with
//     blend_tap's clamp into the image, is staged once in shared memory by
//     the feature's own lanes with batched, row-contiguous loads (for a 7x7
//     window 3 x 64 loads against 3 x 49 x 4 gathered reads), and every tap
//     is blended from there in blend_tap's order.
//   * The sums keep ops/cuda_lk.tree_sum's order: window pixel p on virtual
//     lane p mod 32, each virtual lane adding its pixels in ascending k
//     (padding pixels count 0), then the xor butterfly 16, 8, 4, 2, 1. A
//     feature takes half a warp: each thread holds virtual lanes l and
//     l + 16, whose sum is the butterfly's first step, so kernel and plain
//     version give the same bits.
//   * Windows above 8 pixels per virtual lane (NPL 0) walk the window in
//     strips of patch rows that fit a 48 KB block, with per-lane running
//     sums in the same order and the frame-1 values read in the walk.
// Half a warp per feature and four features a block were chosen by timing
// every layout (a warp or half a warp per feature, 1-16 features a block)
// at 1000 and 65,536 features; PERF.md keeps the sweep.

#include "lk_common.cuh"

namespace {

constexpr int LPF = 16;                  // lanes per feature
constexpr int V = 32 / LPF;              // virtual lanes per thread
constexpr int FPB = 4;                   // features per block
constexpr int STRIP_BYTES = 48 * 1024;   // a block's patches when a window is walked

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

__device__ __forceinline__ Terms add_terms(const Terms& a, const Terms& t, int k)
{
    return Terms{lane_add(a.xx, t.xx, k), lane_add(a.xy, t.xy, k), lane_add(a.yy, t.yy, k),
                 lane_add(a.ex, t.ex, k), lane_add(a.ey, t.ey, k)};
}

// The bilinear tap at patch cell (j, i) of a staged [rows][pw] patch, in
// blend_tap's order.
__device__ __forceinline__ float blend_staged(const float* s, int pw, int j, int i,
                                              const Patch& q)
{
    const float* c = s + j * pw + i;
    return q.w00 * c[0] + q.w01 * c[1] + q.w10 * c[pw] + q.w11 * c[pw + 1];
}

// Patch rows [j0, j0 + rows) of img2, gx2 and gy2 at q into s (three
// [rows][pw] planes, pw = ww + 1), rows and columns clamped into the image
// as blend_tap clamps them; lane `l` of the feature's LPF, four cells per batch of
// loads.
__device__ __forceinline__ void stage_patch(float* s, const float* __restrict__ img2,
                                            const float* __restrict__ gx2,
                                            const float* __restrict__ gy2, const Patch& q,
                                            int j0, int rows, int pw, int l, const LKParams& P)
{
    constexpr int U = 4;
    const int cells = rows * pw, plane = rows * pw;
    for (int i0 = l; i0 < cells; i0 += LPF * U) {
        float v[3][U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * LPF;
            const int r = i / pw, c = i - r * pw;
            int gr = q.y0 + j0 + r, gc = q.x0 + c;
            gr = gr < P.H ? gr : P.H - 1;
            gc = gc < P.W ? gc : P.W - 1;
            const int o = gr * P.W + gc;
            const bool in = i < cells;
            v[0][u] = in ? __ldg(img2 + o) : 0.0f;
            v[1][u] = in ? __ldg(gx2 + o) : 0.0f;
            v[2][u] = in ? __ldg(gy2 + o) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * LPF;
            if (i < cells) {
                s[i] = v[0][u];
                s[plane + i] = v[1][u];
                s[2 * plane + i] = v[2][u];
            }
        }
    }
}

// The butterfly of tree_sum over a feature's virtual lanes: the thread's
// two lanes first (l + (l + 16): the offset-16 step), then 8 .. 1 inside
// the half warp.
__device__ __forceinline__ float feature_sum(const float (&acc)[V])
{
    float s = acc[0] + acc[1];
    for (int off = 8; off >= 1; off >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, off);
    return s;
}

// NPL: pixels per virtual lane (1-8, the frame-1 values held in
// registers), 0 for any window (walked in strips of rows_cap - 1 window
// rows).
template <int NPL>
__global__ void __launch_bounds__(LPF * FPB)
window_terms_kernel(const float* __restrict__ img2, const float* __restrict__ gx2,
                    const float* __restrict__ gy2, const float* __restrict__ w1,
                    const float* __restrict__ g1x, const float* __restrict__ g1y,
                    const float* __restrict__ x2, const float* __restrict__ y2,
                    LKParams P, float x_hi, float y_hi, int rows_cap,
                    float* __restrict__ out)
{
    extern __shared__ float sm[];
    const int slot = threadIdx.x / LPF, l = threadIdx.x - slot * LPF;
    const int f = blockIdx.x * FPB + slot;
    const bool live = f < P.n;                  // dead slots still join the shuffles
    const int ww = 2 * P.hw + 1, wh = 2 * P.hh + 1, npix = ww * wh, pw = ww + 1;
    const long base = (long)(live ? f : 0) * npix;
    // phase clocks, lane 0 of each live feature: 0 position and frame-1
    // loads (waited for at first use), 1 the frame-2 patch staged, 2 the
    // blends and per-lane sums, 3 the butterflies and the store
    const bool clock0 = live && l == 0;
    PFT_PHASE_START(clk);

    // round 1: the position and the frame-1 values, all independent
    const float xr = live ? __ldg(x2 + f) : (float)P.hw;
    const float yr = live ? __ldg(y2 + f) : (float)P.hh;
    float a1[3][V][NPL > 0 ? NPL : 1];
    if constexpr (NPL > 0) {
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
            for (int k = 0; k < NPL; ++k) {
                const int p = l + LPF * v + 32 * k;
                const bool in = live && p < npix;
                a1[0][v][k] = in ? __ldg(w1 + base + p) : 0.0f;
                a1[1][v][k] = in ? __ldg(g1x + base + p) : 0.0f;
                a1[2][v][k] = in ? __ldg(g1y + base + p) : 0.0f;
            }
    }
    const float x = fminf(fmaxf(xr, (float)P.hw), x_hi);
    const float y = fminf(fmaxf(yr, (float)P.hh), y_hi);
    const Patch q = patch_at(x, y, P);
    PFT_PHASE(clk, 0, clock0);

    float* s = sm + (size_t)slot * 3 * rows_cap * pw;
    Terms acc[V];
    if constexpr (NPL > 0) {
        // round 2: the whole patch
        if (live) stage_patch(s, img2, gx2, gy2, q, 0, wh + 1, pw, l, P);
        __syncwarp();
        PFT_PHASE(clk, 1, clock0);
        const int plane = (wh + 1) * pw;
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
            for (int k = 0; k < NPL; ++k) {
                const int p = l + LPF * v + 32 * k;
                Terms t;
                if (p < npix) {
                    const int j = p / ww, i = p - j * ww;
                    t = pixel_terms(a1[0][v][k], a1[1][v][k], a1[2][v][k],
                                    blend_staged(s, pw, j, i, q),
                                    blend_staged(s + plane, pw, j, i, q),
                                    blend_staged(s + 2 * plane, pw, j, i, q));
                }
                acc[v] = add_terms(acc[v], t, k);
            }
    } else {
        // strips of window rows whose patch rows fit rows_cap
        const int strip = rows_cap - 1, kmax = pft_ceil_div(npix, 32);
        int k_next[V];
#pragma unroll
        for (int v = 0; v < V; ++v) k_next[v] = 0;
        for (int j0 = 0; j0 < wh; j0 += strip) {
            const int nr = min(strip, wh - j0), plane = (nr + 1) * pw;
            if (live) stage_patch(s, img2, gx2, gy2, q, j0, nr + 1, pw, l, P);
            __syncwarp();
            PFT_PHASE(clk, 1, clock0);
            const int p_hi = (j0 + nr) * ww;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                int k = k_next[v];
                for (int p = l + LPF * v + 32 * k; p < p_hi; p += 32, ++k) {
                    const int j = p / ww, i = p - j * ww;
                    const float b1 = live ? __ldg(w1 + base + p) : 0.0f;
                    const float b2 = live ? __ldg(g1x + base + p) : 0.0f;
                    const float b3 = live ? __ldg(g1y + base + p) : 0.0f;
                    const Terms t = pixel_terms(b1, b2, b3,
                                                blend_staged(s, pw, j - j0, i, q),
                                                blend_staged(s + plane, pw, j - j0, i, q),
                                                blend_staged(s + 2 * plane, pw, j - j0, i, q));
                    acc[v] = add_terms(acc[v], t, k);
                }
                k_next[v] = k;
            }
            __syncwarp();                       // the next strip overwrites the patch
            PFT_PHASE(clk, 2, clock0);
        }
        // padding pixels past the window count 0, as tree_sum's padding does
#pragma unroll
        for (int v = 0; v < V; ++v)
            if (k_next[v] < kmax) acc[v] = add_terms(acc[v], Terms{}, k_next[v]);
    }

    if constexpr (NPL > 0) PFT_PHASE(clk, 2, clock0);
    float xx[V], xy[V], yy[V], ex[V], ey[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
        xx[v] = acc[v].xx;
        xy[v] = acc[v].xy;
        yy[v] = acc[v].yy;
        ex[v] = acc[v].ex;
        ey[v] = acc[v].ey;
    }
    const float gxx = feature_sum(xx), gxy = feature_sum(xy);
    const float gyy = feature_sum(yy);
    const float sex = P.step_factor * feature_sum(ex);
    const float sey = P.step_factor * feature_sum(ey);
    if (live && l == 0) {
        float* o = out + 5L * f;
        o[0] = gxx;
        o[1] = gxy;
        o[2] = gyy;
        o[3] = sex;
        o[4] = sey;
    }
    PFT_PHASE(clk, 3, clock0);
}

template <int NPL>
int launch(const float* img2, const float* gx2, const float* gy2, const float* w1,
           const float* g1x, const float* g1y, const float* x2, const float* y2,
           const LKParams& P, float x_hi, float y_hi, float* out, cudaStream_t stream)
{
    const int pw = 2 * P.hw + 2, wh = 2 * P.hh + 1;
    int rows_cap = wh + 1;
    if (NPL == 0) {
        const int fit = STRIP_BYTES / (int)(FPB * 3 * pw * sizeof(float));
        if (fit < 2) return PFT_INVALID_ARGUMENT;
        rows_cap = fit < rows_cap ? fit : rows_cap;
    }
    const size_t smem = sizeof(float) * FPB * 3 * rows_cap * pw;
    auto kernel = window_terms_kernel<NPL>;
    pft_allow_smem(kernel, smem);
    kernel<<<pft_ceil_div(P.n, FPB), LPF * FPB, smem, stream>>>(
        img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, rows_cap, out);
    return (int)cudaGetLastError();
}

}  // namespace

// Any odd window size. ``x_hi`` / ``y_hi``: the float32 clamp bounds
// W - hw - 1.001, H - hh - 1.001.
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
#define PFT_K9(N) \
    case N: return launch<N>(img2, gx2, gy2, w1, g1x, g1y, x2, y2, P, x_hi, y_hi, out, s)
    switch (pft_ceil_div(window_width * window_height, 32)) {
        PFT_K9(1);
        PFT_K9(2);
        PFT_K9(3);
        PFT_K9(4);
        PFT_K9(5);
        PFT_K9(6);
        PFT_K9(7);
        PFT_K9(8);
        default: PFT_K9(0);
    }
#undef PFT_K9
}

PFT_PHASE_READER(pft_window_terms_phase_clocks)
