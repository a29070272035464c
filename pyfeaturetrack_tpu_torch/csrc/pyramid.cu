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
//     Given an int32 map, launch 1 also computes K3's quantized min-eig map
//     (eig_common.cuh) of the window beside level 0 (build_tile_eig): the
//     tile's halo grows by the window's half-size, the gradient pair is
//     computed over the tile plus that margin into shared memory (only the
//     tile's own part is stored: a neighbouring tile recomputes the margin,
//     at the same global positions, so with the same bits), and the window
//     sums and the eigenvalue run from shared memory. The gradients are
//     never read back from device memory. A window whose margin does not
//     fit the full tile takes a smaller one (eig_tile_shape: fewer rows or
//     columns, so the base and the pre-smooth's region shrink with it).
//   * pft_pyramid_level: one level (ops/cuda_pyramid.pyramid_level) in one
//     launch of level0_kernel, with or without the pre-smooth.
//   * pft_pyramid_eig: the same tile in eig-only mode, with or without the
//     pre-smooth (ops/cuda_pyramid.level0_eig, the host API's selection):
//     it writes the int32 map and nothing else.
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
// global coordinates, never tile ones. The eig stage is a compile-time mode
// (EigMode), so the builds without it compile to the code they had before.

#include "common.cuh"
#include "eig_common.cuh"

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

// The tile's base (TH + 2R) x (TW + 2R) from (R0 - R, C0 - R) into `base`:
// SMOOTH, the pre-smoothed frame `src` (`work` holds the frame tile and the
// horizontal pass; STORE: the tile's own part written to base_out); else
// `src` loaded as it is. Ends on a barrier.
template <class TL, int RS, bool SMOOTH, bool CG, bool STORE, typename TS>
__device__ __forceinline__ void tile_base(const float* src, TS* base_out, int H, int W,
                                          int TH, int TW, int R0, int C0, int R,
                                          const K1Taps& T, float* base, float* work, int ph)
{
    constexpr int NT = TL::NT;
    const int brows = TH + 2 * R, bcols = TW + 2 * R;
    const bool clock0 = threadIdx.x == 0;
    PFT_PHASE_START(clk);
    if constexpr (SMOOTH) {
        const int rs = radius<RS>(T.s);
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
            if (STORE && r >= R && r < R + TH && gr < H && c >= R && c < R + TW && gc < W)
                pft_store(base_out + (size_t)gr * W + gc, v);
        });
    } else {
        load_region<NT, CG>(base, src, R0 - R, C0 - R, brows, bcols, H, W);
    }
    __syncthreads();
    PFT_PHASE(clk, ph + 2, clock0);             // base: smoothed, or loaded
}

// The decimated columns [q_lo, q_lo + n_q) and rows [j_lo, j_lo + n_j) of
// the next level that fall inside the TH x TW tile at (R0, C0).
struct DecimatedSpan {
    int q_lo = 0, n_q = 0, j_lo = 0, n_j = 0;
};

__device__ __forceinline__ DecimatedSpan decimated_span(int H, int W, int sub, int TH, int TW,
                                                        int R0, int C0)
{
    const int subhalf = sub / 2, h2 = H / sub, w2 = W / sub;
    DecimatedSpan d;
    d.q_lo = C0 > subhalf ? pft_ceil_div(C0 - subhalf, sub) : 0;
    const int q_hi = min(pft_ceil_div(C0 + TW - subhalf, sub), w2);
    d.n_q = q_hi > d.q_lo ? q_hi - d.q_lo : 0;
    d.j_lo = R0 > subhalf ? pft_ceil_div(R0 - subhalf, sub) : 0;
    const int j_hi = min(pft_ceil_div(R0 + TH - subhalf, sub), h2);
    d.n_j = j_hi > d.j_lo ? j_hi - d.j_lo : 0;
    return d;
}

// The pyramid smoothing's horizontal pass at the decimated columns over the
// tile's rows +- rp (hp: [TH + 2 rp][TW]), read from a base with halo R.
template <class TL, int RP>
__device__ __forceinline__ void pyramid_rows(float* hp, const float* base, const DecimatedSpan& d,
                                             int W, int sub, int TH, int TW, int C0, int R,
                                             int rp, const K1Taps& T)
{
    const int bcols = TW + 2 * R, subhalf = sub / 2;
    grid_for<TL::NT>(TH + 2 * rp, d.n_q, [&](int r, int q) {
        const int gc = subhalf + (d.q_lo + q) * sub;
        hp[r * TW + q] = (gc >= rp && gc < W - rp)
                             ? conv<RP>(base + (r + R - rp) * bcols + gc - C0 + R - rp, 1, T.p)
                             : 0.0f;
    });
}

// Its vertical pass at the decimated rows: the next level's samples, in
// float32 to `dec` (the source of the next level's build) and, with
// bfloat16 storage, rounded to `dec16` (the stored next level).
template <class TL, int RP, typename TS>
__device__ __forceinline__ void pyramid_cols(float* dec, TS* dec16, const float* hp,
                                             const DecimatedSpan& d, int H, int W, int sub,
                                             int TW, int R0, int rp, const K1Taps& T)
{
    const int subhalf = sub / 2, w2 = W / sub;
    grid_for<TL::NT>(d.n_j, d.n_q, [&](int j, int q) {
        const int gr = subhalf + (d.j_lo + j) * sub;
        const size_t o = (size_t)(d.j_lo + j) * w2 + d.q_lo + q;
        const float v =
            (gr >= rp && gr < H - rp) ? conv<RP>(hp + (gr - R0) * TW + q, TW, T.p) : 0.0f;
        dec[o] = v;
        if constexpr (pft_is_bf16<TS>) pft_store(dec16 + o, v);
    });
}

// One TH x TL::TW output tile of one level at (R0, C0): gx, gy and, with_pyr,
// the decimated samples of the next level that fall inside the tile (dec,
// and dec16 with bfloat16 storage: pyramid_cols).
// SMOOTH: `src` is the raw frame and the tile first builds its base (written
// to base_out); else `src` is the level's float32 base. Stores go out in
// the storage type TS; everything in shared memory is float32. `sm`: the
// block's dynamic shared memory (tile_smem floats). Inlined, so that the
// taps stay kernel parameters (constant-bank operands) instead of a
// local-memory copy.
template <class TL, int RS, int RG, int RP, bool SMOOTH, bool CG, typename TS>
__device__ __forceinline__ void build_tile(const float* src, TS* base_out, TS* gx, TS* gy,
                                           float* dec, TS* dec16, int H, int W,
                                           bool with_pyr, int sub, int TH, int R0,
                                           int C0, const K1Taps& T, float* sm)
{
    constexpr int TW = TL::TW, NT = TL::NT;
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
    tile_base<TL, RS, SMOOTH, CG, true>(src, base_out, H, W, TH, TW, R0, C0, R, T, base, work,
                                        ph);
    PFT_PHASE_START(clk);

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
    DecimatedSpan d;
    if (with_pyr) {
        d = decimated_span(H, W, sub, TH, TW, R0, C0);
        pyramid_rows<TL, RP>(hp, base, d, W, sub, TH, TW, C0, R, rp, T);
    }
    __syncthreads();
    PFT_PHASE(clk, ph + 3, clock0);             // the horizontal passes

    // vertical passes
    grid_for<NT>(TH, TW, [&](int r, int c) {
        const int gr = R0 + r, gc = C0 + c;
        if (gr >= H || gc >= W) return;
        const size_t o = (size_t)gr * W + gc;
        pft_store(gx + o, (gr >= rgx && gr < H - rgx)
                              ? conv<RG>(hd + (r + rv - rgx) * TW + c, TW, T.g)
                              : 0.0f);
        pft_store(gy + o, (gr >= rdx && gr < H - rdx)
                              ? conv<RG>(hg + (r + rv - rdx) * TW + c, TW, T.d)
                              : 0.0f);
    });
    pyramid_cols<TL, RP>(dec, dec16, hp, d, H, W, sub, TW, R0, rp, T);
    PFT_PHASE(clk, ph + 4, clock0);             // the vertical passes and stores
}

// The eig stage's window (half-sizes) and the tile's output columns.
struct EigWin {
    int hw, hh, tw;
};

// Shared memory (floats) of a TH x TW eig-carrying level-0 tile, as
// build_tile_eig lays it out: base [TH + 2R][TW + 2R] (R = max(rv + max(hh,
// hw), rp)), then one region that holds in turn the pre-smooth's frame tile
// and horizontal pass; the extended gradient pair [ER][EC] x 2 (ER = TH +
// 2hh, EC = TW + 2hw) with, after it, the horizontal passes [HR][EC] x 2 (HR
// = ER + 2rv) and the pyramid's [TH + 2rp][TW]; the pair with the vertical
// window sums [TH][EC] x 3 after it.
struct EigTile {
    int R, ER, EC, HR, base, pair, passes, sums, smoothing;

    __host__ __device__ EigTile(int TH, int TW, bool smooth, int rs, int rv, int rp, int hw,
                                int hh)
    {
        const int m = hh > hw ? hh : hw;
        R = rv + m > rp ? rv + m : rp;
        ER = TH + 2 * hh;
        EC = TW + 2 * hw;
        HR = ER + 2 * rv;
        const int brows = TH + 2 * R, bcols = TW + 2 * R;
        base = brows * bcols;
        pair = 2 * ER * EC;
        passes = 2 * HR * EC + (rp > 0 ? (TH + 2 * rp) * TW : 0);
        sums = 3 * TH * EC;
        const int irows = brows + 2 * rs;
        smoothing = smooth ? irows * (bcols + 2 * rs) + irows * bcols : 0;
    }
    __host__ __device__ int total() const
    {
        const int later = pair + (passes > sums ? passes : sums);
        return base + (smoothing > later ? smoothing : later);
    }
};

// build_tile with K3's map of the (2hw+1) x (2hh+1) window beside it
// (eig_common.cuh), written to `eig`, for a TH x E.tw tile (E.tw <= TL::TW:
// narrower where the window's margin does not fit the full tile). STORE:
// also base_out (SMOOTH), the tile's gx, gy and, with_pyr, the next level,
// as build_tile writes them; else the map alone. The gradient pair over the
// tile's columns +- hw and rows +- hh from the base (the horizontal passes,
// then the vertical ones), the vertical window sums of the three products,
// then the horizontal sums and the eigenvalue. Every gradient is the same
// conv at the same global position as build_tile's, with borders decided
// from global coordinates, so the stored pair and the map's pair have the
// same bits. With bfloat16 storage each gradient is rounded to it before
// it is stored and before the window sums: the map is that of the stored
// gradients, upcast (the JAX package computes the refill map from them).
template <class TL, int RS, int RG, int RP, bool SMOOTH, bool STORE, typename TS>
__device__ __forceinline__ void build_tile_eig(const float* src, TS* base_out, TS* gx, TS* gy,
                                               float* dec, TS* dec16, int* eig, int H, int W,
                                               bool with_pyr, int sub, int TH, int R0, int C0,
                                               const K1Taps& T, const EigWin& E, float* sm)
{
    constexpr int NT = TL::NT;
    const int rgx = radius<RG>(T.g), rdx = radius<RG>(T.d);
    const int rv = rgx > rdx ? rgx : rdx;
    const int rp = with_pyr ? radius<RP>(T.p) : 0;
    const int hw = E.hw, hh = E.hh, TW = E.tw;
    const EigTile L(TH, TW, SMOOTH, SMOOTH ? radius<RS>(T.s) : 0, rv, rp, hw, hh);
    const int R = L.R, bcols = TW + 2 * R, EC = L.EC;
    float* base = sm;
    float* gxe = sm + L.base;                   // [ER][EC] from (R0 - hh, C0 - hw)
    float* gye = gxe + L.ER * EC;
    float* hd = gye + L.ER * EC;                // deriv_g *h  [HR][EC] from row R0 - hh - rv
    float* hg = hd + L.HR * EC;                 // gauss_g *h  [HR][EC]
    float* hp = hg + L.HR * EC;                 // gauss_p *h  [TH + 2 rp][TW]
    float* vxx = hd;                            // [TH][EC], once hd and hg are read
    float* vxy = vxx + TH * EC;
    float* vyy = vxy + TH * EC;
    const bool clock0 = threadIdx.x == 0;
    tile_base<TL, RS, SMOOTH, false, STORE>(src, base_out, H, W, TH, TW, R0, C0, R, T, base,
                                            gxe, 0);
    PFT_PHASE_START(clk);
    DecimatedSpan d;
    const int gc0 = C0 - hw;                    // global column of extended column 0
    grid_for<NT>(L.HR, EC, [&](int r, int c) {
        const float* b = base + (r + R - hh - rv) * bcols + R - hw + c;
        const int gc = gc0 + c;
        hd[r * EC + c] = (gc >= rdx && gc < W - rdx) ? conv<RG>(b - rdx, 1, T.d) : 0.0f;
        hg[r * EC + c] = (gc >= rgx && gc < W - rgx) ? conv<RG>(b - rgx, 1, T.g) : 0.0f;
    });
    if (with_pyr) {
        d = decimated_span(H, W, sub, TH, TW, R0, C0);
        pyramid_rows<TL, RP>(hp, base, d, W, sub, TH, TW, C0, R, rp, T);
    }
    __syncthreads();
    PFT_PHASE(clk, 3, clock0);                  // the horizontal passes

    grid_for<NT>(L.ER, EC, [&](int r, int c) {
        const int gr = R0 - hh + r, gc = gc0 + c;
        float vx = 0.0f, vy = 0.0f;
        if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
            if (gr >= rgx && gr < H - rgx)
                vx = conv<RG>(hd + (r + rv - rgx) * EC + c, EC, T.g);
            if (gr >= rdx && gr < H - rdx)
                vy = conv<RG>(hg + (r + rv - rdx) * EC + c, EC, T.d);
            vx = pft_stored<TS>(vx);
            vy = pft_stored<TS>(vy);
            if (STORE && r >= hh && r < hh + TH && c >= hw && c < hw + TW) {
                const size_t o = (size_t)gr * W + gc;
                pft_store(gx + o, vx);
                pft_store(gy + o, vy);
            }
        }
        gxe[r * EC + c] = vx;
        gye[r * EC + c] = vy;
    });
    if (with_pyr) pyramid_cols<TL, RP>(dec, dec16, hp, d, H, W, sub, TW, R0, rp, T);
    __syncthreads();
    PFT_PHASE(clk, 4, clock0);                  // the vertical passes and stores

    // the vertical window sums (rows past the frame's last are skipped)
    grid_for<NT>(TH, EC, [&](int r, int c) {
        if (R0 + r >= H) return;
        const int o = r * EC + c;
        eig_column_sums(gxe + o, gye + o, EC, 2 * hh + 1, vxx[o], vxy[o], vyy[o]);
    });
    __syncthreads();
    PFT_PHASE(clk, 5, clock0);                  // the eig stage: vertical window sums

    grid_for<NT>(TH, TW, [&](int r, int c) {
        const int gr = R0 + r, gc = C0 + c;
        if (gr >= H || gc >= W) return;
        const int o = r * EC + c;               // extended column c: global column gc - hw
        eig[(size_t)gr * W + gc] = (gr >= hh && gr < H - hh && gc >= hw && gc < W - hw)
                                       ? eig_quantized(vxx + o, vxy + o, vyy + o, 2 * hw + 1)
                                       : 0;
    });
    PFT_PHASE(clk, 6, clock0);                  // horizontal sums, eigenvalue, store
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

// What a level-0 launch writes: the level (NONE), the level and K3's map
// (WITH), or the map alone (ONLY).
enum class EigMode { NONE, WITH, ONLY };

template <class TL, int RS, int RG, int RP, bool SMOOTH, EigMode M, typename TS>
__global__ void __launch_bounds__(TL::NT)
level0_kernel(const float* __restrict__ img, TS* __restrict__ base, TS* __restrict__ gx,
              TS* __restrict__ gy, float* __restrict__ dec, TS* __restrict__ dec16,
              int* __restrict__ eig, int H, int W, int with_pyr, int sub, int th, K1Taps T,
              EigWin E)
{
    extern __shared__ float sm[];
    if constexpr (M == EigMode::NONE)
        build_tile<TL, RS, RG, RP, SMOOTH, false>(img, base, gx, gy, dec, dec16, H, W,
                                                  with_pyr != 0, sub, th, blockIdx.y * th,
                                                  blockIdx.x * TL::TW, T, sm);
    else
        build_tile_eig<TL, RS, RG, RP, SMOOTH, M == EigMode::WITH>(
            img, base, gx, gy, dec, dec16, eig, H, W, with_pyr != 0, sub, th, blockIdx.y * th,
            blockIdx.x * E.tw, T, E, sm);
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
// [img, gx, gy], each H_l x W_l, H_l = H_{l-1} / sub, in the storage type):
// each block walks the level's tiles, then the grid meets at a barrier
// before the next level. Each level is built from its float32 image: the
// level's own in `buf` (float storage), else its copy in `scratch` (levels
// 1 .. n_levels - 1 in order, H_l x W_l floats each), where the level above
// wrote it beside the rounded one it stores.
template <class TL, int RG, int RP, typename TS>
__global__ void __launch_bounds__(TL::NT)
coarse_kernel(TS* buf, float* scratch, int H0, int W0, int n_levels, int sub, K1Taps T,
              unsigned* bar)
{
    extern __shared__ float sm[];
    size_t off = 3 * (size_t)H0 * W0, soff = 0;
    int H = H0 / sub, W = W0 / sub;
    for (int l = 1; l < n_levels; ++l) {
        const size_t n = (size_t)H * W;
        TS* lv = buf + off;
        const float* src;
        float* dec;
        TS* dec16 = nullptr;
        if constexpr (pft_is_bf16<TS>) {
            src = scratch + soff;
            dec = scratch + soff + n;
            dec16 = lv + 3 * n;
        } else {
            src = lv;
            dec = lv + 3 * n;
        }
        const bool with_pyr = l < n_levels - 1;
        constexpr int TH = TL::TH, TW = TL::TW;
        const int tx = pft_ceil_div(W, TW), nt = tx * pft_ceil_div(H, TH);
        for (int t = blockIdx.x; t < nt; t += gridDim.x) {
            const int ty = t / tx;
            build_tile<TL, 0, RG, RP, false, true>(src, (TS*)nullptr, lv + n, lv + 2 * n, dec,
                                                   dec16, H, W, with_pyr, sub, TH, ty * TH,
                                                   (t - ty * tx) * TW, T, sm);
            __syncthreads();
        }
        PFT_PHASE_START(clk);
        if (with_pyr) grid_barrier(bar);
        PFT_PHASE(clk, 16, threadIdx.x == 0);   // the grid barrier
        off += 3 * n;
        soff += n;
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

constexpr int SMEM_FLOATS = 227 * 1024 / (int)sizeof(float);   // a block's most

// The eig-carrying tile's rows and columns: level0_rows' rows and TL::TW
// columns where they fit a block's shared memory; else, of the shapes with
// at most that many rows and columns that fit, the one with the most output
// pixels (the base and the pre-smooth's region shrink with the tile). With
// the configs' gradient taps every window whose pre-smooth the taps allow
// (at most 97 x 97) fits; false when not even one pixel fits.
template <class TL>
bool eig_tile_shape(int H, int W, bool smooth, int rs, int rv, int rp, int hw, int hh, int& th,
                    int& tw)
{
    int best = 0;
    for (int r = level0_rows<TL>(H, W); r >= 1 && r * TL::TW > best; --r)
        for (int c = TL::TW; c >= 1 && r * c > best; --c)
            if (EigTile(r, c, smooth, rs, rv, rp, hw, hh).total() <= SMEM_FLOATS) {
                best = r * c;
                th = r;
                tw = c;
            }
    return best > 0;
}

template <class TL, int RS, int RG, int RP, bool SMOOTH, EigMode M, typename TS>
int launch_level0(const float* img, TS* base, TS* gx, TS* gy, float* dec, TS* dec16, int* eig,
                  int H, int W, int with_pyr, int sub, const K1Taps& T, int ww, int wh,
                  cudaStream_t s)
{
    const int rs = SMOOTH ? T.s.r : 0, rp = with_pyr ? T.p.r : 0;
    int th = 0;
    size_t smem = 0;
    EigWin E{ww / 2, wh / 2, TL::TW};
    if (M == EigMode::NONE) {
        th = level0_rows<TL>(H, W);
        smem = sizeof(float) * tile_smem<TL>(th, rs, T.g.r, T.d.r, rp, SMOOTH);
    } else {
        const int rv = T.g.r > T.d.r ? T.g.r : T.d.r;
        if (!eig_tile_shape<TL>(H, W, SMOOTH, rs, rv, rp, E.hw, E.hh, th, E.tw))
            return PFT_INVALID_ARGUMENT;
        smem = sizeof(float) * EigTile(th, E.tw, SMOOTH, rs, rv, rp, E.hw, E.hh).total();
    }
    auto kernel = level0_kernel<TL, RS, RG, RP, SMOOTH, M, TS>;
    pft_allow_smem(kernel, smem);
    const dim3 grid(pft_ceil_div(W, E.tw), pft_ceil_div(H, th));
    kernel<<<grid, TL::NT, smem, s>>>(img, base, gx, gy, dec, dec16, eig, H, W, with_pyr, sub,
                                      th, T, E);
    return (int)cudaGetLastError();
}

template <bool SMOOTH, EigMode M, typename TS>
int level0(Radii k, const float* img, TS* base, TS* gx, TS* gy, float* dec, TS* dec16,
           int* eig, int H, int W, int with_pyr, int sub, const K1Taps& T, int ww, int wh,
           cudaStream_t s)
{
    switch (k) {
        case Radii::S2G3P10:
            return launch_level0<Level0Tile, 2, 3, 10, SMOOTH, M>(
                img, base, gx, gy, dec, dec16, eig, H, W, with_pyr, sub, T, ww, wh, s);
        case Radii::S2G3P5:
            return launch_level0<Level0Tile, 2, 3, 5, SMOOTH, M>(
                img, base, gx, gy, dec, dec16, eig, H, W, with_pyr, sub, T, ww, wh, s);
        case Radii::S3G3P5:
            return launch_level0<Level0Tile, 3, 3, 5, SMOOTH, M>(
                img, base, gx, gy, dec, dec16, eig, H, W, with_pyr, sub, T, ww, wh, s);
        default:
            return launch_level0<AnyTile, -1, -1, -1, SMOOTH, M>(
                img, base, gx, gy, dec, dec16, eig, H, W, with_pyr, sub, T, ww, wh, s);
    }
}

template <class TL, int RG, int RP, typename TS>
int launch_coarse(TS* buf, float* scratch, int H, int W, int n_levels, int sub,
                  const K1Taps& T, unsigned* bar, cudaStream_t s)
{
    const size_t smem = sizeof(float) * tile_smem<TL>(TL::TH, 0, T.g.r, T.d.r, T.p.r, false);
    auto kernel = coarse_kernel<TL, RG, RP, TS>;
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
    void* args[] = {&buf, &scratch, &H, &W, &n_levels, &sub, const_cast<K1Taps*>(&T), &bar};
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
    return smooth ? level0<true, EigMode::NONE>(k, in, base, gx, gy, dec, (float*)nullptr,
                                                nullptr, H, W, with_pyr, sub, T, 0, 0, s)
                  : level0<false, EigMode::NONE>(k, in, base, gx, gy, dec, (float*)nullptr,
                                                 nullptr, H, W, with_pyr, sub, T, 0, 0, s);
}

// K3's int32 map [H, W] of the window_width x window_height window (odd)
// from one level-0 launch that writes nothing else: smooth, the gradients of
// the pre-smoothed `in`; else of `in` itself.
extern "C" int pft_pyramid_eig(const float* in, int* eig, int H, int W, int smooth,
                               const float* s_rev, int s_ntaps,
                               const float* g_rev, int g_ntaps,
                               const float* d_rev, int d_ntaps,
                               int window_width, int window_height, void* stream)
{
    K1Taps T;
    if (H <= 0 || W <= 0 || eig == nullptr || (smooth && s_ntaps <= 0) ||
        window_width < 1 || window_height < 1 || window_width % 2 == 0 ||
        window_height % 2 == 0 ||
        !load_all(&T, s_rev, smooth ? s_ntaps : 0, g_rev, g_ntaps, d_rev, d_ntaps, nullptr, 0))
        return PFT_INVALID_ARGUMENT;
    const Radii k = pick(smooth ? T.s.r : -1, T.g.r, T.d.r, -1);
    cudaStream_t s = (cudaStream_t)stream;
    float* none = nullptr;
    return smooth ? level0<true, EigMode::ONLY>(k, in, none, none, none, none, none, eig, H, W,
                                                0, 1, T, window_width, window_height, s)
                  : level0<false, EigMode::ONLY>(k, in, none, none, none, none, none, eig, H,
                                                 W, 0, 1, T, window_width, window_height, s);
}

namespace {

// pft_pyramid_build in storage type TS (see there).
template <typename TS>
int build(const float* img, TS* buf, float* scratch, int H, int W, int n_levels, int sub,
          const K1Taps& T, int* eig, int window_width, int window_height, unsigned* bar,
          cudaStream_t s)
{
    const size_t n0 = (size_t)H * W;
    const int with_pyr = n_levels > 1;
    // level 1's image: float32 to buf (float storage) or to scratch, where
    // bfloat16 storage keeps the float32 source of every coarser level
    float* dec;
    TS* dec16 = nullptr;
    if constexpr (pft_is_bf16<TS>) {
        dec = scratch;
        dec16 = buf + 3 * n0;
    } else {
        dec = buf + 3 * n0;
    }
    const Radii k = pick(T.s.r, T.g.r, T.d.r, T.p.r);
    int rc = eig != nullptr
                 ? level0<true, EigMode::WITH>(k, img, buf, buf + n0, buf + 2 * n0, dec, dec16,
                                               eig, H, W, with_pyr, sub, T, window_width,
                                               window_height, s)
                 : level0<true, EigMode::NONE>(k, img, buf, buf + n0, buf + 2 * n0, dec, dec16,
                                               nullptr, H, W, with_pyr, sub, T, 0, 0, s);
    if (rc != 0 || !with_pyr) return rc;
    switch (k) {
        case Radii::S2G3P10:
            return launch_coarse<CoarseTile, 3, 10>(buf, scratch, H, W, n_levels, sub, T, bar,
                                                    s);
        case Radii::S2G3P5:
        case Radii::S3G3P5:
            return launch_coarse<CoarseTile, 3, 5>(buf, scratch, H, W, n_levels, sub, T, bar,
                                                   s);
        default:
            return launch_coarse<AnyTile, -1, -1>(buf, scratch, H, W, n_levels, sub, T, bar,
                                                  s);
    }
}

}  // namespace

// A whole pyramid of n_levels levels of the [H, W] frame `img` into `buf`:
// level l at offset sum_{k<l} 3 H_k W_k elements as [img, gx, gy] (level
// 0's img is the pre-smoothed frame), H_l = H_{l-1} / sub, float32 (bf16 0)
// or bfloat16 (bf16 1: each value built in float32 and rounded to nearest
// even where it is stored; scratch then holds sum_{l>=1} H_l W_l floats,
// the float32 images of levels 1 .. n_levels - 1 that the coarser levels
// are built from, and may be null for one level). Two launches (one for a
// single level). eig: null, or an int32 [H, W] map that launch 1 fills
// with K3's map of the window_width x window_height window (odd) over level
// 0's stored gradients. bar: two uint32 of device memory, zero before the
// first build on this stream, left that way by every build.
extern "C" int pft_pyramid_build(const float* img, void* buf, float* scratch, int bf16, int H,
                                 int W, int n_levels, int sub, const float* s_rev, int s_ntaps,
                                 const float* g_rev, int g_ntaps,
                                 const float* d_rev, int d_ntaps,
                                 const float* p_rev, int p_ntaps, int* eig,
                                 int window_width, int window_height, unsigned* bar,
                                 void* stream)
{
    K1Taps T;
    if (H <= 0 || W <= 0 || n_levels < 1 || sub < 1 || bar == nullptr ||
        (bf16 && n_levels > 1 && scratch == nullptr) ||
        (eig != nullptr && (window_width < 1 || window_height < 1 ||
                            window_width % 2 == 0 || window_height % 2 == 0)) ||
        !load_all(&T, s_rev, s_ntaps, g_rev, g_ntaps, d_rev, d_ntaps, p_rev, p_ntaps))
        return PFT_INVALID_ARGUMENT;
    cudaStream_t s = (cudaStream_t)stream;
    return bf16 ? build(img, (__nv_bfloat16*)buf, scratch, H, W, n_levels, sub, T, eig,
                        window_width, window_height, bar, s)
                : build(img, (float*)buf, scratch, H, W, n_levels, sub, T, eig, window_width,
                        window_height, bar, s);
}

PFT_PHASE_READER(pft_pyramid_phase_clocks)
