// K1: fused pyramid-level build.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_pyramid.py: fused_level_build
// (_fused_kernel) and fused_level_build_tiled (_tiled_kernel), as driven by
// build_track_pyramids_pallas.
//
// What it computes, per level (ops/convolve.py semantics): every 1-D pass
// is a true convolution (taps arrive flipped, krev = k[::-1]) accumulated in
// ascending tap order, and zeroes its own kernel_width//2 border measured
// from the IMAGE edges (so a pass over an extent <= 2r is all zero).
//   level 0:  base  = gauss_s *v (gauss_s *h img)               [pft_pyramid_smooth]
//   any:      gradx = gauss_g *v (deriv_g *h base)              [pft_pyramid_level]
//             grady = deriv_g *v (gauss_g *h base)
//   not last: next  = (gauss_p *v (gauss_p *h base))[subhalf::sub, subhalf::sub][:h2, :w2]
// Level 0 takes two launches (smooth, then gradients + decimation), every
// later level one. Only the decimated samples of the pyramid-smoothed image
// are computed or written: the full-resolution smoothed image is never
// needed.
//
// What bounds it on this card: bytes. Per level it reads the image once and
// writes two gradient images (plus base at level 0 and a 1/sub^2 decimated
// image); the arithmetic is a few tens of FLOPs per pixel. The design keeps
// every intermediate pass in shared memory: each block loads one output tile
// plus a halo of the widest radius, runs the horizontal passes over
// tile-plus-halo rows, then the vertical passes, and writes only final
// outputs. Tile edges inside the image read their real neighbours from the
// halo; borders are decided from global coordinates, never tile ones.

#include "common.cuh"

namespace {

constexpr int TH = 16;    // output rows per tile
constexpr int TW = 64;    // output cols per tile
constexpr int NT = 256;   // threads per block

// out = V(H(in)) with one kernel for both passes (the level-0 pre-smooth).
__global__ void __launch_bounds__(NT)
smooth_kernel(const float* __restrict__ in, float* __restrict__ out,
              int H, int W, PftTaps t)
{
    extern __shared__ float sm[];
    const int r = t.r;
    const int R0 = blockIdx.y * TH, C0 = blockIdx.x * TW;
    const int in_rows = TH + 2 * r, in_cols = TW + 2 * r;
    float* s_in = sm;                          // [in_rows][in_cols]
    float* s_h = sm + in_rows * in_cols;       // [in_rows][TW]

    for (int i = threadIdx.x; i < in_rows * in_cols; i += NT) {
        const int gr = R0 - r + i / in_cols, gc = C0 - r + i % in_cols;
        s_in[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W) ? in[gr * W + gc] : 0.0f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < in_rows * TW; i += NT) {
        const int lr = i / TW, lc = i % TW, gc = C0 + lc;
        float acc = 0.0f;
        if (gc >= r && gc < W - r) {
            const float* p = s_in + lr * in_cols + lc;     // column gc - r
            acc = t.k[0] * p[0];
            for (int j = 1; j <= 2 * r; ++j) acc = acc + t.k[j] * p[j];
        }
        s_h[i] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TH * TW; i += NT) {
        const int lr = i / TW, lc = i % TW, gr = R0 + lr, gc = C0 + lc;
        if (gr >= H || gc >= W) continue;
        float acc = 0.0f;
        if (gr >= r && gr < H - r) {
            const float* p = s_h + lr * TW + lc;           // row gr - r
            acc = t.k[0] * p[0];
            for (int j = 1; j <= 2 * r; ++j) acc = acc + t.k[j] * p[j * TW];
        }
        out[gr * W + gc] = acc;
    }
}

// Horizontal pass of radius t.r over the haloed tile: rows [0, in_rows) of
// s_in, output columns C0 + lc for lc in cols (a list of n_cols local
// columns), written to dst[lr][slot].
__device__ __forceinline__ void hpass(const float* s_in, int in_rows, int in_cols,
                                      int R, int C0, int W, const PftTaps& t,
                                      const int* cols, int n_cols, int dst_stride,
                                      float* dst)
{
    const int r = t.r;
    for (int i = threadIdx.x; i < in_rows * n_cols; i += NT) {
        const int lr = i / n_cols, slot = i % n_cols;
        const int lc = cols ? cols[slot] : slot;
        const int gc = C0 + lc;
        float acc = 0.0f;
        if (gc >= r && gc < W - r) {
            const float* p = s_in + lr * in_cols + lc + (R - r);   // column gc - r
            acc = t.k[0] * p[0];
            for (int j = 1; j <= 2 * r; ++j) acc = acc + t.k[j] * p[j];
        }
        dst[lr * dst_stride + slot] = acc;
    }
}

// Vertical pass of radius t.r at global row gr, reading column `slot` of a
// horizontal-pass buffer whose local row 0 is global row R0 - R.
__device__ __forceinline__ float vpass(const float* src, int stride, int slot,
                                       int gr, int R0, int R, int H,
                                       const PftTaps& t)
{
    const int r = t.r;
    if (gr < r || gr >= H - r) return 0.0f;
    const float* p = src + (gr - r - (R0 - R)) * stride + slot;   // row gr - r
    float acc = t.k[0] * p[0];
    for (int j = 1; j <= 2 * r; ++j) acc = acc + t.k[j] * p[j * stride];
    return acc;
}

// gradx / grady of `in`, plus (with_pyr) the decimated pyramid-smoothed
// samples that fall inside this tile.
__global__ void __launch_bounds__(NT)
level_kernel(const float* __restrict__ in, float* __restrict__ gx,
             float* __restrict__ gy, float* __restrict__ dec,
             int H, int W, PftTaps g, PftTaps d, PftTaps p, int with_pyr,
             int sub, int h2, int w2)
{
    extern __shared__ float sm[];
    int R = g.r > d.r ? g.r : d.r;
    if (with_pyr && p.r > R) R = p.r;
    const int R0 = blockIdx.y * TH, C0 = blockIdx.x * TW;
    const int in_rows = TH + 2 * R, in_cols = TW + 2 * R;
    float* s_in = sm;                              // [in_rows][in_cols]
    float* s_hd = s_in + in_rows * in_cols;        // deriv_g *h  [in_rows][TW]
    float* s_hg = s_hd + in_rows * TW;             // gauss_g *h  [in_rows][TW]
    float* s_hp = s_hg + in_rows * TW;             // gauss_p *h at decimated cols
    __shared__ int dcols[TW];                      // local decimated columns

    // decimated samples of this tile: rows/cols subhalf + k*sub
    const int subhalf = sub / 2;
    int q_lo = 0, n_q = 0, j_lo = 0, n_j = 0;
    if (with_pyr) {
        q_lo = C0 > subhalf ? pft_ceil_div(C0 - subhalf, sub) : 0;
        int q_hi = pft_ceil_div(C0 + TW - subhalf, sub);
        if (q_hi > w2) q_hi = w2;
        n_q = q_hi > q_lo ? q_hi - q_lo : 0;
        j_lo = R0 > subhalf ? pft_ceil_div(R0 - subhalf, sub) : 0;
        int j_hi = pft_ceil_div(R0 + TH - subhalf, sub);
        if (j_hi > h2) j_hi = h2;
        n_j = j_hi > j_lo ? j_hi - j_lo : 0;
        for (int i = threadIdx.x; i < n_q; i += NT)
            dcols[i] = subhalf + (q_lo + i) * sub - C0;
    }

    for (int i = threadIdx.x; i < in_rows * in_cols; i += NT) {
        const int gr = R0 - R + i / in_cols, gc = C0 - R + i % in_cols;
        s_in[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W) ? in[gr * W + gc] : 0.0f;
    }
    __syncthreads();
    hpass(s_in, in_rows, in_cols, R, C0, W, d, nullptr, TW, TW, s_hd);
    hpass(s_in, in_rows, in_cols, R, C0, W, g, nullptr, TW, TW, s_hg);
    if (n_q > 0)
        hpass(s_in, in_rows, in_cols, R, C0, W, p, dcols, n_q, TW, s_hp);
    __syncthreads();
    for (int i = threadIdx.x; i < TH * TW; i += NT) {
        const int lr = i / TW, lc = i % TW, gr = R0 + lr, gc = C0 + lc;
        if (gr >= H || gc >= W) continue;
        gx[gr * W + gc] = vpass(s_hd, TW, lc, gr, R0, R, H, g);
        gy[gr * W + gc] = vpass(s_hg, TW, lc, gr, R0, R, H, d);
    }
    for (int i = threadIdx.x; i < n_j * n_q; i += NT) {
        const int j = j_lo + i / n_q, slot = i % n_q;
        const int gr = subhalf + j * sub;
        dec[j * w2 + q_lo + slot] = vpass(s_hp, TW, slot, gr, R0, R, H, p);
    }
}

}  // namespace

extern "C" int pft_pyramid_smooth(const float* in, float* out, int H, int W,
                                  const float* krev, int ntaps, void* stream)
{
    PftTaps t;
    if (H <= 0 || W <= 0 || !pft_load_taps(&t, krev, ntaps)) return PFT_INVALID_ARGUMENT;
    const size_t smem = sizeof(float) * ((TH + 2 * t.r) * (TW + 2 * t.r) + (TH + 2 * t.r) * TW);
    pft_allow_smem(smooth_kernel, smem);
    dim3 grid(pft_ceil_div(W, TW), pft_ceil_div(H, TH));
    smooth_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(in, out, H, W, t);
    return (int)cudaGetLastError();
}

// p_ntaps == 0: last level, gradients only (dec is not touched).
extern "C" int pft_pyramid_level(const float* in, float* gx, float* gy, float* dec,
                                 int H, int W,
                                 const float* g_rev, int g_ntaps,
                                 const float* d_rev, int d_ntaps,
                                 const float* p_rev, int p_ntaps,
                                 int sub, int h2, int w2, void* stream)
{
    PftTaps g, d, p;
    if (H <= 0 || W <= 0 || !pft_load_taps(&g, g_rev, g_ntaps) ||
        !pft_load_taps(&d, d_rev, d_ntaps))
        return PFT_INVALID_ARGUMENT;
    const int with_pyr = p_ntaps > 0;
    if (with_pyr) {
        if (!pft_load_taps(&p, p_rev, p_ntaps) || sub < 1 || h2 != H / sub || w2 != W / sub)
            return PFT_INVALID_ARGUMENT;
    } else {
        p.r = 0;
        for (int i = 0; i < PFT_MAX_TAPS; ++i) p.k[i] = 0.0f;
        sub = 1;
    }
    int R = g.r > d.r ? g.r : d.r;
    if (with_pyr && p.r > R) R = p.r;
    const int in_rows = TH + 2 * R, in_cols = TW + 2 * R;
    const size_t smem = sizeof(float) * (in_rows * in_cols + 3 * in_rows * TW);
    pft_allow_smem(level_kernel, smem);
    dim3 grid(pft_ceil_div(W, TW), pft_ceil_div(H, TH));
    level_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        in, gx, gy, dec, H, W, g, d, p, with_pyr, sub, h2, w2);
    return (int)cudaGetLastError();
}
