// K1: the pyramid build, in at most two launches.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_pyramid.py: fused_level_build
// (_fused_kernel) and fused_level_build_tiled (_tiled_kernel), as driven by
// build_track_pyramids_pallas.
//
// What it computes, per level (ops/convolve.py semantics): every 1-D pass
// is a true convolution (taps arrive flipped, krev = k[::-1]) accumulated in
// ascending tap order, acc = k[0] p[0], then acc + k[j] p[j] (the library is
// built with -fmad=false, so no product is fused into a sum), and zeroes
// its own kernel_width//2 border measured from the IMAGE edges (so a pass
// over an extent <= 2r is all zero).
//   level 0:  base  = gauss_s *v (gauss_s *h img)    (the pre-smooth)
//   any:      gradx = gauss_g *v (deriv_g *h base)
//             grady = deriv_g *v (gauss_g *h base)
//   not last: next  = (gauss_p *v (gauss_p *h base))[subhalf::sub, subhalf::sub][:h2, :w2]
// Only the decimated samples of the pyramid-smoothed image are computed:
// the full-resolution smoothed image is never needed.
//
// Two entries:
//   * pft_pyramid_build, the tracker's: a whole pyramid in two launches
//     whatever the level count. Launch 1 (level0_kernel) builds level 0: each
//     block loads its output tile (64 columns, level0_rows rows) with a halo
//     of R + r_smooth
//     (R = the widest of the gradient and pyramid radii), smooths it in
//     shared memory, writes `base` once, then runs the gradient pair over the
//     tile's rows plus the gradient radius only and the pyramid pass at the
//     decimated columns and rows the tile owns: gx, gy and level 1's base
//     leave the SM, no intermediate does. Launch 2 (coarse_kernel) builds
//     every coarser level: a cooperative grid whose blocks walk each level's
//     tiles and meet at a grid-wide barrier between levels (level l + 1
//     reads level l's decimated image, written by other blocks). Every level
//     lives in one buffer the wrapper allocates ([img, gx, gy] per level, in
//     order), so the kernels find each level from (H, W, sub) alone and the
//     level count is not capped.
//   * pft_pyramid_level: one level (ops/cuda_pyramid.pyramid_level) in one
//     launch of level0_kernel, with or without the pre-smooth.
//
// What bounds it on this card: bytes (the frame read once; base, the
// gradient pair and the decimated image written once; a few tens of
// operations per pixel) and, at these frame sizes, launch latency: the
// earlier design took nPyramidLevels + 1 launches and wrote base to device
// memory and read it back. Radii are template parameters for the configs'
// radii (smooth 2 or 3, gradient 3, pyramid 5 or 10; tap loops unrolled), a
// generic instantiation takes any odd width up to PFT_MAX_TAPS. Each pass
// spreads its cells evenly over the block's threads (grid_for), so a level
// whose tiles are few still keeps every warp busy. Borders are decided from
// global coordinates, never tile ones.

#include "common.cuh"

namespace {

// Output rows (at most; see level0_rows) and columns per tile and threads per
// block. Level 0 takes the larger tile, the coarser levels (fewer tiles a
// level, a barrier between levels) the smaller: chosen by timing tile shapes
// from 8 x 64 to 64 x 128 on the card (PERF.md, section 6).
template <int TH_, int TW_, int NT_>
struct Tile {
    static constexpr int TH = TH_, TW = TW_, NT = NT_;
};
using Level0Tile = Tile<64, 64, 1024>;
using CoarseTile = Tile<16, 64, 512>;
// The generic radii (up to PFT_MAX_TAPS): a tile whose halos of 35 + 35
// still fit a block's shared memory.
using AnyTile = Tile<16, 32, 256>;

struct K1Taps {
    PftTaps s, g, d, p;   // pre-smooth, gradient gauss, gradient deriv, pyramid
};

// The radius of a pass: RC when fixed at compile time (RC >= 0), else the
// taps' own.
template <int RC>
__device__ __forceinline__ int radius(const PftTaps& t)
{
    return RC >= 0 ? RC : t.r;
}

// One output sample of a 1-D pass: p[0 .. 2r * stride] against the flipped
// taps, in ascending tap order.
template <int RC>
__device__ __forceinline__ float conv(const float* p, int stride, const PftTaps& t)
{
    float acc = t.k[0] * p[0];
    if constexpr (RC >= 0) {
#pragma unroll
        for (int j = 1; j <= 2 * RC; ++j) acc = acc + t.k[j] * p[j * stride];
    } else {
        for (int j = 1; j <= 2 * t.r; ++j) acc = acc + t.k[j] * p[j * stride];
    }
    return acc;
}

// rows x cols values of `src` ([H, W]) from (r0, c0) into dst, zero outside
// the image. Each thread issues LOADS_IN_FLIGHT loads before it stores any,
// so a tile waits for about one memory round trip, not one per load. CG: the
// source was written earlier in this launch, so the loads go to L2.
constexpr int LOADS_IN_FLIGHT = 8;

template <int NT, bool CG>
__device__ __forceinline__ void load_region(float* dst, const float* src, int r0, int c0,
                                            int rows, int cols, int H, int W)
{
    const int n = rows * cols;
    for (int i0 = threadIdx.x; i0 < n; i0 += NT * LOADS_IN_FLIGHT) {
        float v[LOADS_IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < LOADS_IN_FLIGHT; ++u) {
            const int i = i0 + u * NT;
            const int r = i / cols, gr = r0 + r, gc = c0 + i - r * cols;
            v[u] = 0.0f;
            if (i < n && gr >= 0 && gr < H && gc >= 0 && gc < W) {
                const float* q = src + (size_t)gr * W + gc;
                v[u] = CG ? __ldcg(q) : __ldg(q);
            }
        }
#pragma unroll
        for (int u = 0; u < LOADS_IN_FLIGHT; ++u)
            if (i0 + u * NT < n) dst[i0 + u * NT] = v[u];
    }
}

// f(r, c) for every cell of a rows x cols grid, the cells spread evenly over
// the block's threads, consecutive threads on consecutive columns (a
// compile-time `cols` divides by a shift).
template <int NT, typename F>
__device__ __forceinline__ void grid_for(int rows, int cols, F&& f)
{
    const int n = rows * cols;
    for (int i = threadIdx.x; i < n; i += NT) {
        const int r = i / cols;
        f(r, i - r * cols);
    }
}

// One TH x TL::TW output tile of one level at (R0, C0): gx, gy and, with_pyr,
// the decimated samples of the next level that fall inside the tile.
// SMOOTH: `src` is the raw frame and the tile first builds its base (written
// to base_out); else `src` is the level's base. `sm`: the block's dynamic
// shared memory (tile_smem floats). Inlined, so that the taps stay kernel
// parameters (constant-bank operands) instead of a local-memory copy.
template <class TL, int RS, int RG, int RP, bool SMOOTH, bool CG>
__device__ __forceinline__ void build_tile(const float* src, float* base_out, float* gx,
                                           float* gy, float* dec, int H, int W,
                                           bool with_pyr, int sub, int TH, int R0,
                                           int C0, const K1Taps& T, float* sm)
{
    constexpr int TW = TL::TW, NT = TL::NT;
    const int rs = SMOOTH ? radius<RS>(T.s) : 0;
    const int rgx = radius<RG>(T.g), rdx = radius<RG>(T.d);
    const int rv = rgx > rdx ? rgx : rdx;
    const int rp = with_pyr ? radius<RP>(T.p) : 0;
    const int R = rv > rp ? rv : rp;
    const int brows = TH + 2 * R, bcols = TW + 2 * R;
    float* base = sm;                           // [brows][bcols] from (R0 - R, C0 - R)
    float* work = base + brows * bcols;
    // phase clocks: 0-4 level 0 (launch 1), 8-12 the coarser levels
    const int ph = CG ? 8 : 0;
    const bool clock0 = threadIdx.x == 0;
    PFT_PHASE_START(clk);

    if constexpr (SMOOTH) {
        const int irows = brows + 2 * rs, icols = bcols + 2 * rs;
        float* in = work;                       // [irows][icols] from (R0 - R - rs, ..)
        float* hs = in + irows * icols;         // [irows][bcols]
        load_region<NT, CG>(in, src, R0 - R - rs, C0 - R - rs, irows, icols, H, W);
        __syncthreads();
        PFT_PHASE(clk, ph + 0, clock0);         // the frame tile and its halo
        grid_for<NT>(irows, bcols, [&](int r, int c) {
            const int gc = C0 - R + c;
            hs[r * bcols + c] = (gc >= rs && gc < W - rs)
                                    ? conv<RS>(in + r * icols + c, 1, T.s) : 0.0f;
        });
        __syncthreads();
        PFT_PHASE(clk, ph + 1, clock0);         // the pre-smooth, horizontal
        grid_for<NT>(brows, bcols, [&](int r, int c) {
            const int gr = R0 - R + r, gc = C0 - R + c;
            float v = 0.0f;
            if (gr >= rs && gr < H - rs && gc >= 0 && gc < W)
                v = conv<RS>(hs + r * bcols + c, bcols, T.s);
            base[r * bcols + c] = v;
            if (r >= R && r < R + TH && gr < H && c >= R && c < R + TW && gc < W)
                base_out[(size_t)gr * W + gc] = v;
        });
    } else {
        load_region<NT, CG>(base, src, R0 - R, C0 - R, brows, bcols, H, W);
    }
    __syncthreads();
    PFT_PHASE(clk, ph + 2, clock0);             // base: smoothed, or loaded

    // horizontal passes: the gradient pair over the tile's rows +- rv, the
    // pyramid smoothing at the decimated columns over its rows +- rp
    const int hrows = TH + 2 * rv;
    float* hd = work;                           // deriv_g *h  [hrows][TW]
    float* hg = hd + hrows * TW;                // gauss_g *h  [hrows][TW]
    float* hp = hg + hrows * TW;                // gauss_p *h  [TH + 2 rp][TW]
    grid_for<NT>(hrows, TW, [&](int r, int c) {
        const float* b = base + (r + R - rv) * bcols + R + c;   // column C0 + c
        const int gc = C0 + c;
        hd[r * TW + c] = (gc >= rdx && gc < W - rdx) ? conv<RG>(b - rdx, 1, T.d) : 0.0f;
        hg[r * TW + c] = (gc >= rgx && gc < W - rgx) ? conv<RG>(b - rgx, 1, T.g) : 0.0f;
    });
    const int subhalf = sub / 2, h2 = H / sub, w2 = W / sub;
    int q_lo = 0, n_q = 0, j_lo = 0, n_j = 0;
    if (with_pyr) {
        q_lo = C0 > subhalf ? pft_ceil_div(C0 - subhalf, sub) : 0;
        const int q_hi = min(pft_ceil_div(C0 + TW - subhalf, sub), w2);
        n_q = q_hi > q_lo ? q_hi - q_lo : 0;
        j_lo = R0 > subhalf ? pft_ceil_div(R0 - subhalf, sub) : 0;
        const int j_hi = min(pft_ceil_div(R0 + TH - subhalf, sub), h2);
        n_j = j_hi > j_lo ? j_hi - j_lo : 0;
        grid_for<NT>(TH + 2 * rp, n_q, [&](int r, int q) {
            const int gc = subhalf + (q_lo + q) * sub;
            hp[r * TW + q] = (gc >= rp && gc < W - rp)
                                 ? conv<RP>(base + (r + R - rp) * bcols + gc - C0 + R - rp, 1,
                                            T.p)
                                 : 0.0f;
        });
    }
    __syncthreads();
    PFT_PHASE(clk, ph + 3, clock0);             // the horizontal passes

    // vertical passes
    grid_for<NT>(TH, TW, [&](int r, int c) {
        const int gr = R0 + r, gc = C0 + c;
        if (gr >= H || gc >= W) return;
        const size_t o = (size_t)gr * W + gc;
        gx[o] = (gr >= rgx && gr < H - rgx) ? conv<RG>(hd + (r + rv - rgx) * TW + c, TW, T.g)
                                            : 0.0f;
        gy[o] = (gr >= rdx && gr < H - rdx) ? conv<RG>(hg + (r + rv - rdx) * TW + c, TW, T.d)
                                            : 0.0f;
    });
    grid_for<NT>(n_j, n_q, [&](int j, int q) {
        const int gr = subhalf + (j_lo + j) * sub;
        dec[(size_t)(j_lo + j) * w2 + q_lo + q] =
            (gr >= rp && gr < H - rp) ? conv<RP>(hp + (gr - R0) * TW + q, TW, T.p) : 0.0f;
    });
    PFT_PHASE(clk, ph + 4, clock0);             // the vertical passes and stores
}

// Shared memory of one tile (floats), as build_tile lays it out.
template <class TL>
inline int tile_smem(int TH, int rs, int rg, int rd, int rp, bool smooth)
{
    constexpr int TW = TL::TW;
    const int rv = rg > rd ? rg : rd;
    const int R = rv > rp ? rv : rp;
    const int base = (TH + 2 * R) * (TW + 2 * R);
    const int passes = (2 * (TH + 2 * rv) + TH + 2 * rp) * TW;
    if (!smooth) return base + passes;
    const int irows = TH + 2 * R + 2 * rs;
    const int smoothing = irows * (TW + 2 * R + 2 * rs) + irows * (TW + 2 * R);
    return base + (smoothing > passes ? smoothing : passes);
}

template <class TL, int RS, int RG, int RP, bool SMOOTH>
__global__ void __launch_bounds__(TL::NT)
level0_kernel(const float* __restrict__ img, float* __restrict__ base, float* __restrict__ gx,
              float* __restrict__ gy, float* __restrict__ dec, int H, int W, int with_pyr,
              int sub, int th, K1Taps T)
{
    extern __shared__ float sm[];
    build_tile<TL, RS, RG, RP, SMOOTH, false>(img, base, gx, gy, dec, H, W, with_pyr != 0,
                                              sub, th, blockIdx.y * th, blockIdx.x * TL::TW,
                                              T, sm);
}

// Grid-wide barrier of a cooperative launch. bar[0] counts arrivals and is
// back at 0 after every barrier; bar[1] is the generation the blocks wait to
// see advance. The data written before it is read after it through L2.
__device__ void grid_barrier(unsigned* bar)
{
    __syncthreads();
    if (threadIdx.x == 0) {
        volatile unsigned* gen = bar + 1;
        const unsigned g = *gen;
        __threadfence();
        if (atomicAdd(bar, 1u) == gridDim.x - 1) {
            atomicExch(bar, 0u);
            __threadfence();
            atomicAdd(bar + 1, 1u);
        } else {
            while (*gen == g) __nanosleep(64);
        }
        __threadfence();
    }
    __syncthreads();
}

// Levels 1 .. n_levels - 1 of the pyramid in `buf` (level l at its offset:
// [img, gx, gy], each H_l x W_l, H_l = H_{l-1} / sub): each block walks the
// level's tiles, then the grid meets at a barrier before the next level.
template <class TL, int RG, int RP>
__global__ void __launch_bounds__(TL::NT)
coarse_kernel(float* buf, int H0, int W0, int n_levels, int sub, K1Taps T, unsigned* bar)
{
    extern __shared__ float sm[];
    size_t off = 3 * (size_t)H0 * W0;
    int H = H0 / sub, W = W0 / sub;
    for (int l = 1; l < n_levels; ++l) {
        const size_t n = (size_t)H * W;
        float* img = buf + off;
        const bool with_pyr = l < n_levels - 1;
        constexpr int TH = TL::TH, TW = TL::TW;
        const int tx = pft_ceil_div(W, TW), nt = tx * pft_ceil_div(H, TH);
        for (int t = blockIdx.x; t < nt; t += gridDim.x) {
            const int ty = t / tx;
            build_tile<TL, 0, RG, RP, false, true>(img, nullptr, img + n, img + 2 * n,
                                               img + 3 * n, H, W, with_pyr, sub, TH, ty * TH,
                                               (t - ty * tx) * TW, T, sm);
            __syncthreads();
        }
        PFT_PHASE_START(clk);
        if (with_pyr) grid_barrier(bar);
        PFT_PHASE(clk, 16, threadIdx.x == 0);   // the grid barrier
        off += 3 * n;
        H /= sub;
        W /= sub;
    }
}

// The compile-time radii for a set of taps: (smooth, gradient, pyramid) of
// the configs, else -1 (generic). `rs` / `rp` < 0: not used by the launch.
enum class Radii { S2G3P10, S2G3P5, S3G3P5, ANY };

Radii pick(int rs, int rg, int rd, int rp)
{
    auto fits = [&](int s, int g, int p) {
        return (rs < 0 || rs == s) && rg == g && rd == g && (rp < 0 || rp == p);
    };
    if (fits(2, 3, 10)) return Radii::S2G3P10;
    if (fits(2, 3, 5)) return Radii::S2G3P5;
    if (fits(3, 3, 5)) return Radii::S3G3P5;
    return Radii::ANY;
}

// Rows per level-0 tile: TL::TH, or fewer where the frame's tiles would
// leave SMs idle (Level0Tile runs one block per SM): the fewest rows, a
// multiple of 8, whose tiles still fit one per SM. The halo stays a fixed
// number of rows, so a shorter tile is cheaper; 480x640 takes 40 rows (120
// tiles) on 132 SMs, where 64 rows gave 80 tiles.
template <class TL>
int level0_rows(int H, int W)
{
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int per_column = sms / pft_ceil_div(W, TL::TW);
    if (per_column < 1) return TL::TH;
    const int th = 8 * pft_ceil_div(pft_ceil_div(H, per_column), 8);
    return th > TL::TH ? TL::TH : th;
}

template <class TL, int RS, int RG, int RP, bool SMOOTH>
int launch_level0(const float* img, float* base, float* gx, float* gy, float* dec, int H,
                  int W, int with_pyr, int sub, const K1Taps& T, cudaStream_t s)
{
    const int th = level0_rows<TL>(H, W);
    const size_t smem = sizeof(float) * tile_smem<TL>(th, SMOOTH ? T.s.r : 0, T.g.r, T.d.r,
                                                      with_pyr ? T.p.r : 0, SMOOTH);
    auto kernel = level0_kernel<TL, RS, RG, RP, SMOOTH>;
    pft_allow_smem(kernel, smem);
    const dim3 grid(pft_ceil_div(W, TL::TW), pft_ceil_div(H, th));
    kernel<<<grid, TL::NT, smem, s>>>(img, base, gx, gy, dec, H, W, with_pyr, sub, th, T);
    return (int)cudaGetLastError();
}

template <bool SMOOTH>
int level0(Radii k, const float* img, float* base, float* gx, float* gy, float* dec, int H,
           int W, int with_pyr, int sub, const K1Taps& T, cudaStream_t s)
{
    switch (k) {
        case Radii::S2G3P10:
            return launch_level0<Level0Tile, 2, 3, 10, SMOOTH>(
                img, base, gx, gy, dec, H, W, with_pyr, sub, T, s);
        case Radii::S2G3P5:
            return launch_level0<Level0Tile, 2, 3, 5, SMOOTH>(
                img, base, gx, gy, dec, H, W, with_pyr, sub, T, s);
        case Radii::S3G3P5:
            return launch_level0<Level0Tile, 3, 3, 5, SMOOTH>(
                img, base, gx, gy, dec, H, W, with_pyr, sub, T, s);
        default:
            return launch_level0<AnyTile, -1, -1, -1, SMOOTH>(
                img, base, gx, gy, dec, H, W, with_pyr, sub, T, s);
    }
}

template <class TL, int RG, int RP>
int launch_coarse(float* buf, int H, int W, int n_levels, int sub, const K1Taps& T,
                  unsigned* bar, cudaStream_t s)
{
    const size_t smem = sizeof(float) * tile_smem<TL>(TL::TH, 0, T.g.r, T.d.r, T.p.r, false);
    auto kernel = coarse_kernel<TL, RG, RP>;
    pft_allow_smem(kernel, smem);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TL::NT, smem);
    int tiles = 0;
    for (int l = 1, h = H / sub, w = W / sub; l < n_levels; ++l, h /= sub, w /= sub) {
        const int t = pft_ceil_div(w, TL::TW) * pft_ceil_div(h, TL::TH);
        tiles = t > tiles ? t : tiles;
    }
    int blocks = per_sm * sms;
    if (tiles < blocks) blocks = tiles;
    if (blocks < 1) blocks = 1;
    void* args[] = {&buf, &H, &W, &n_levels, &sub, const_cast<K1Taps*>(&T), &bar};
    cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(TL::NT), args, smem,
                                s);
    return (int)cudaGetLastError();
}

int load_all(K1Taps* T, const float* s_rev, int s_n, const float* g_rev, int g_n,
             const float* d_rev, int d_n, const float* p_rev, int p_n)
{
    if (!pft_load_taps(&T->g, g_rev, g_n) || !pft_load_taps(&T->d, d_rev, d_n)) return 0;
    if (s_n > 0 ? !pft_load_taps(&T->s, s_rev, s_n) : !pft_load_taps(&T->s, g_rev, 1))
        return 0;
    if (p_n > 0 ? !pft_load_taps(&T->p, p_rev, p_n) : !pft_load_taps(&T->p, g_rev, 1))
        return 0;
    return 1;
}

}  // namespace

// One level in one launch. smooth: base = the pre-smoothed `in`, written to
// `base` (else base is `in` and `base` is not touched); p_ntaps == 0: no
// next level (dec is not touched), else dec is [H / sub, W / sub].
extern "C" int pft_pyramid_level(const float* in, float* base, float* gx, float* gy,
                                 float* dec, int H, int W, int smooth,
                                 const float* s_rev, int s_ntaps,
                                 const float* g_rev, int g_ntaps,
                                 const float* d_rev, int d_ntaps,
                                 const float* p_rev, int p_ntaps, int sub, void* stream)
{
    K1Taps T;
    if (H <= 0 || W <= 0 || sub < 1 || (smooth && s_ntaps <= 0) ||
        !load_all(&T, s_rev, smooth ? s_ntaps : 0, g_rev, g_ntaps, d_rev, d_ntaps, p_rev,
                  p_ntaps))
        return PFT_INVALID_ARGUMENT;
    const int with_pyr = p_ntaps > 0;
    const Radii k = pick(smooth ? T.s.r : -1, T.g.r, T.d.r, with_pyr ? T.p.r : -1);
    cudaStream_t s = (cudaStream_t)stream;
    return smooth ? level0<true>(k, in, base, gx, gy, dec, H, W, with_pyr, sub, T, s)
                  : level0<false>(k, in, base, gx, gy, dec, H, W, with_pyr, sub, T, s);
}

// A whole pyramid of n_levels levels of the [H, W] frame `img` into `buf`:
// level l at offset sum_{k<l} 3 H_k W_k floats as [img, gx, gy] (level 0's
// img is the pre-smoothed frame), H_l = H_{l-1} / sub. Two launches (one
// for a single level). bar: two uint32 of device memory, zero before the
// first build on this stream, left that way by every build.
extern "C" int pft_pyramid_build(const float* img, float* buf, int H, int W, int n_levels,
                                 int sub, const float* s_rev, int s_ntaps,
                                 const float* g_rev, int g_ntaps,
                                 const float* d_rev, int d_ntaps,
                                 const float* p_rev, int p_ntaps, unsigned* bar,
                                 void* stream)
{
    K1Taps T;
    if (H <= 0 || W <= 0 || n_levels < 1 || sub < 1 || bar == nullptr ||
        !load_all(&T, s_rev, s_ntaps, g_rev, g_ntaps, d_rev, d_ntaps, p_rev, p_ntaps))
        return PFT_INVALID_ARGUMENT;
    cudaStream_t s = (cudaStream_t)stream;
    const size_t n0 = (size_t)H * W;
    const int with_pyr = n_levels > 1;
    const Radii k = pick(T.s.r, T.g.r, T.d.r, T.p.r);
    int rc = level0<true>(k, img, buf, buf + n0, buf + 2 * n0, buf + 3 * n0, H, W, with_pyr,
                          sub, T, s);
    if (rc != 0 || !with_pyr) return rc;
    switch (k) {
        case Radii::S2G3P10:
            return launch_coarse<CoarseTile, 3, 10>(buf, H, W, n_levels, sub, T, bar, s);
        case Radii::S2G3P5:
        case Radii::S3G3P5:
            return launch_coarse<CoarseTile, 3, 5>(buf, H, W, n_levels, sub, T, bar, s);
        default:
            return launch_coarse<AnyTile, -1, -1>(buf, H, W, n_levels, sub, T, bar, s);
    }
}

PFT_PHASE_READER(pft_pyramid_phase_clocks)
