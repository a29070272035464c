// K8: one pyramid level of dense Lucas-Kanade, the LK level solve at every
// pixel of a level: 2-D flow, or (ONE_D) disparity along the row, started
// from level-sized maps, from zero, or from the coarser level's maps
// upsampled in the kernel.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_lk_fused.py: fused_track_level
// (_fused_level_kernel), which ops/flow.flow_level and, in its one_d mode,
// ops/disparity.disparity_level run over every pixel of a level. The
// arithmetic is that of ops/track.track_feature_level (track.py:155-234) on
// the pixel grid, x1 = column, y1 = row, as K2 computes it per feature
// (csrc/lk.cu), with these differences:
//   * the frame-1 positions are implicit; the kernel writes u = x2 - x1,
//     v = y2 - y1, the status and the iteration count per pixel
//     (flow.py:119-121);
//   * the start (START): MAP reads level-sized maps and starts at
//     (x1 + u, y1 + v); ZERO starts at (x1, y1) and reads no map; UP reads
//     the coarser level's maps and computes the start as
//     ops/interp.upsample_flow does on the card: the source coordinate
//     (dst + 0.5) * float32(h_in / h_out) - 0.5 clamped to [0, h_in - 1],
//     interp.bilinear's floor, its top-left clamp to [0, w_in - 2] (a flat
//     index below 0 wraps, as PyTorch's indexing does on a map one row or
//     one column high) and its blend order, then times the scale;
//   * ONE_D (disparity.py:134-178): it reads the disparity map d, starts at
//     x2 = x1 - d on row y1 and writes d = x1 - x2. The step is
//     du = step_factor * sum(diff gx) / gxx with gx = g1x + g2x, SMALL_DET
//     when gxx < min_determinant, convergence on |du| alone, bounds checked
//     at (x2, y1); gy is never read, and there is no lighting variant (the
//     JAX XLA route ignores the flag there, disparity.py:144, :168);
//   * LIGHTING (2-D only): gain and bias as in K2;
//   * no window-size cap;
//   * a row band (row0, rows): the launch solves and writes only rows
//     [row0, row0 + rows) of the level, into band-sized outputs, and
//     reads its start from the WHOLE map (MAP: the level's, UP: the
//     coarser level's) and its taps from the whole images, so a band's
//     pixels get the bits of the same pixels in a whole-level launch
//     (the sharded dense paths of parallel/sharding.py cut a level into
//     bands, one per rank).
// Status priorities are K2's: OOB before SMALL_DET inside the loop; after
// it, OOB overrides any status, then LARGE_RESIDUE, then MAX_ITERATIONS.
//
// What bounds it on this card: operations, not bytes. At 480x640 a level-0
// call moves about 15 MB (six level images, the maps in and out), while
// 307,200 pixels x 1.7 iterations x 49 taps x (three frame-2 bilinear
// blends, the residual, two gradient sums, five products and sums) are
// about 1.0 G float32 operations on the drift pair of chip_smoke.py.
// Design: a block covers a TH x TW tile of pixels (16 x 16: the fastest of
// six shapes from 8 x 32 to 32 x 32, phase_clocks.py), one thread per pixel,
// each warp a 4 x 8 block of them (a warp runs as many iterations as its
// slowest pixel, and a compact block of neighbours differs less than a run
// of 32 along a row). The block stages in shared memory, once:
//   * frame 1: the tile plus the window halo of img, gx, gy (img, gx in
//     1-D). A pixel reads taps only when its frame-1 window lies in the
//     image (the loop's first bounds test; the lighting sums are taken only
//     then), so its taps sit on integer coordinates inside the staged tile
//     and are read without a blend (the plain version's weights 1, 0, 0, 0
//     give the same sums: a sum from +0 absorbs the sign of a zero);
//   * frame 2: the bounding box of the tile's start patches, plus MARGIN
//     pixels on every side, clipped to the image and to the buffer (tile +
//     window + 1 + 2 MARGIN + SLACK per axis, the box anchored at its top
//     left). In each iteration a pixel whose (wh+1) x (ww+1) patch lies in
//     the staged box reads it there, else from device memory: the same
//     values through the same code (a pointer and a stride), not a
//     fallback. Along a window row the taps share their fractional
//     weights, so the column read as p01/p11 of tap i is carried in
//     registers as p00/p10 of tap i+1: two reads per tap and image, blended
//     w00 p00 + w01 p01 + w10 p10 + w11 p11 as interp.bilinear does.
// A window too large for the buffers reads device memory (frame 2 first,
// then frame 1). Sums run in row-major tap order with one accumulator
// each, starting from 0, the plain version's sequential order, so with
// -fmad=false both give the same bits. Where the cycles go at 480x640
// (phase_clocks.py, threads' own counts): the start and the staging about
// half (loads and the block's barriers), the taps a third, the final
// residue a sixth; the 4 x 8 warps run 2.24 iterations each against 2.73
// for 32 pixels in a row, at 1.68 per pixel.

#include <climits>

#include "lk_common.cuh"

namespace {

constexpr int NT_MAX = 1024;
constexpr int MARGIN = 2;       // frame-2 staging beyond the start patches
constexpr int SLACK = 8;        // buffer room for the starts' spread
constexpr size_t SMEM_MAX = 232448 - 1024;   // beside the static buffers

enum StartMode { START_MAP = 0, START_ZERO = 1, START_UP = 2 };

// Phase clocks (-DPFT_PHASE_CLOCKS builds only): each thread sums its own
// cycles per phase; the block adds them up in shared memory and its first
// threads add the block's sums to the file's counters. Slot 6 counts the
// patches that left the staged frame-2 box.
#ifdef PFT_PHASE_CLOCKS
constexpr int K8_SLOTS = 7;
#define K8_CLOCKS_START long long k8c_[K8_SLOTS] = {}, k8n_[K8_SLOTS] = {}; \
    long long k8t_ = clock64()
#define K8_MARK(k)                                                                  \
    do {                                                                            \
        const long long now_ = clock64();                                           \
        k8c_[k] += now_ - k8t_;                                                     \
        k8n_[k] += 1;                                                               \
        k8t_ = now_;                                                                \
    } while (0)
#define K8_COUNT(k) (k8n_[k] += 1)
#define K8_CLOCKS_FLUSH                                                             \
    do {                                                                            \
        __shared__ unsigned long long k8s_[2 * K8_SLOTS];                           \
        if (threadIdx.x < 2 * K8_SLOTS) k8s_[threadIdx.x] = 0ull;                   \
        __syncthreads();                                                            \
        if (active)                                                                 \
            for (int k = 0; k < K8_SLOTS; ++k) {                                    \
                atomicAdd(&k8s_[k], (unsigned long long)k8c_[k]);                   \
                atomicAdd(&k8s_[K8_SLOTS + k], (unsigned long long)k8n_[k]);        \
            }                                                                       \
        __syncthreads();                                                            \
        if (threadIdx.x < K8_SLOTS) {                                               \
            atomicAdd(&pft_phase_cycles[threadIdx.x], k8s_[threadIdx.x]);           \
            atomicAdd(&pft_phase_counts[threadIdx.x], k8s_[K8_SLOTS + threadIdx.x]); \
        }                                                                           \
    } while (0)
#else
#define K8_CLOCKS_START
#define K8_MARK(k)
#define K8_COUNT(k)
#define K8_CLOCKS_FLUSH
#endif

// The images one frame contributes: img, gx, gy (gy unused in 1-D).
struct Frame {
    const float* img;
    const float* gx;
    const float* gy;
};

// Where the start comes from: maps (MAP: level-sized; UP: the coarser
// level's, hc x wc, with the float32 zoom ratios and the scale).
struct Start {
    const float* u;
    const float* v;
    int hc, wc;
    float ry, rx, scale;
};

// Shared-memory layout of a tile: frame-1 planes (r1 rows of stride s1,
// staged when stage1) then frame-2 planes (r2 rows of stride s2, staged
// when stage2). Strides are 8 mod 32, so a warp's 4 x 8 pixels hit 32
// banks.
struct Tile {
    int th, tw, s1, r1, s2, r2, stage1, stage2;
};

// The rows a launch solves: [row0, row0 + rows) of the level, written to
// band-sized outputs (rows x W).
struct Band {
    int row0, rows;
};

// A window in one frame: the planes' pointers at its top-left and the row
// stride (shared or device memory, read as generic addresses).
struct Win {
    const float* a;
    const float* b;
    const float* c;
    int stride;
};

// PyTorch's wrap of a negative flat index (interp.bilinear on a map one row
// or one column high).
__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : i; }

// interp.bilinear of map m (hc x wc) at (xs, ys): floor, top-left clamp to
// [0, wc - 2] x [0, hc - 2], then the blend in its order.
__device__ __forceinline__ float sample_map(const float* __restrict__ m, int hc, int wc,
                                            float xs, float ys)
{
    const int xt = (int)fminf(fmaxf(floorf(xs), -1.0e8f), 1.0e8f);
    const int yt = (int)fminf(fmaxf(floorf(ys), -1.0e8f), 1.0e8f);
    const float ax = xs - (float)xt, ay = ys - (float)yt;
    const int x0 = min(max(xt, 0), wc - 2), y0 = min(max(yt, 0), hc - 2);
    const int n = hc * wc, i00 = y0 * wc + x0;
    const float p00 = __ldg(m + wrap(i00, n)), p01 = __ldg(m + wrap(i00 + 1, n));
    const float p10 = __ldg(m + wrap(i00 + wc, n));
    const float p11 = __ldg(m + wrap(i00 + wc + 1, n));
    return (1.0f - ax) * (1.0f - ay) * p00 + ax * (1.0f - ay) * p01 +
           (1.0f - ax) * ay * p10 + ax * ay * p11;
}

// Blended tap i of one plane's window row (top row r0, next row r1), with
// the previous column carried: p00 = c0, p10 = c1 on entry; the new column
// becomes the carry.
__device__ __forceinline__ float blend_carry(const float* r0, const float* r1, int i,
                                             const Patch& q, float& c0, float& c1)
{
    const float p01 = r0[i + 1], p11 = r1[i + 1];
    const float v = q.w00 * c0 + q.w01 * p01 + q.w10 * c1 + q.w11 * p11;
    c0 = p01;
    c1 = p11;
    return v;
}

// Lighting compensation of the frame-2 window (track.py:120-128): gain
// alpha = sqrt((s11 / n) / (s22 / n)), bias beta = m1 - alpha mean(w2), the
// window sums taken in row-major order from 0.
__device__ __forceinline__ void gain_bias(const Win& f2, const Patch& q, int ww, int wh,
                                          float s11, float m1, float n, float& alpha,
                                          float& beta)
{
    float s22 = 0.0f, sw2 = 0.0f;
    for (int j = 0; j < wh; ++j) {
        const float* r0 = f2.a + j * f2.stride;
        const float* r1 = r0 + f2.stride;
        float c0 = r0[0], c1 = r1[0];
        for (int i = 0; i < ww; ++i) {
            const float w2 = blend_carry(r0, r1, i, q, c0, c1);
            s22 = s22 + w2 * w2;
            sw2 = sw2 + w2;
        }
    }
    alpha = sqrtf((s11 / n) / (s22 / n));
    beta = m1 - alpha * (sw2 / n);
}

// Stage rows [oy, oy + ey) x cols [ox, ox + ex) of a frame's first nimg
// planes into a buffer of stride s and plane size `plane`. Each thread
// issues STAGE_BATCH loads before it stores them, so their latency is paid
// once per batch, not once per sample.
constexpr int STAGE_BATCH = 4;

__device__ __forceinline__ void stage(float* dst, int s, int plane, const Frame& f, int nimg,
                                      int W, int oy, int ox, int ey, int ex)
{
    const int per = ey * ex, total = nimg * per;
    for (int base = threadIdx.x; base < total; base += STAGE_BATCH * blockDim.x) {
        float v[STAGE_BATCH];
#pragma unroll
        for (int pass = 0; pass < 2; ++pass)
#pragma unroll
            for (int b = 0; b < STAGE_BATCH; ++b) {
                const int i = base + b * blockDim.x;
                if (i >= total) continue;
                const int k = i / per, rc = i - k * per, r = rc / ex, c = rc - r * ex;
                if (pass == 0) {
                    const float* src = k == 0 ? f.img : (k == 1 ? f.gx : f.gy);
                    v[b] = __ldg(src + (size_t)(oy + r) * W + ox + c);
                } else {
                    dst[k * plane + r * s + c] = v[b];
                }
            }
    }
}

// The bounding box of (x0, y0) over the block's threads with `in` set
// (lo > hi when none): one pass of warp reductions and one barrier.
__device__ __forceinline__ void block_bbox(int x0, int y0, bool in, int* scratch, int& lo_x,
                                           int& lo_y, int& hi_x, int& hi_y)
{
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const int a = __reduce_min_sync(0xffffffffu, in ? x0 : INT_MAX);
    const int b = __reduce_min_sync(0xffffffffu, in ? y0 : INT_MAX);
    const int c = __reduce_max_sync(0xffffffffu, in ? x0 : INT_MIN);
    const int e = __reduce_max_sync(0xffffffffu, in ? y0 : INT_MIN);
    if (lane < 4) scratch[4 * warp + lane] = lane == 0 ? a : (lane == 1 ? b : (lane == 2 ? c : e));
    __syncthreads();
    lo_x = lo_y = INT_MAX;
    hi_x = hi_y = INT_MIN;
    for (int k = 0; k < nwarps; ++k) {
        lo_x = min(lo_x, scratch[4 * k]);
        lo_y = min(lo_y, scratch[4 * k + 1]);
        hi_x = max(hi_x, scratch[4 * k + 2]);
        hi_y = max(hi_y, scratch[4 * k + 3]);
    }
}

template <bool ONE_D, bool LIGHTING, int START>
__global__ void __launch_bounds__(NT_MAX)
lk_tile_kernel(Frame f1, Frame f2, Start S, LKParams P, Tile T, Band B,
               float* __restrict__ u_out,
               float* __restrict__ v_out, int* __restrict__ status_out,
               int* __restrict__ iter_out)
{
    extern __shared__ float smem[];
    __shared__ int bbox[4 * (NT_MAX / 32)];
    K8_CLOCKS_START;
    const int nimg = ONE_D ? 2 : 3;
    const int ww = 2 * P.hw + 1, wh = 2 * P.hh + 1;
    const float n = (float)(ww * wh);

    // this thread's pixel: the warps tile the block's TH x TW pixels 4 x 8
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wpr = T.tw >> 3;
    const int tr0 = B.row0 + blockIdx.y * T.th, tc0 = blockIdx.x * T.tw;
    const int row = tr0 + (warp / wpr) * 4 + (lane >> 3);
    const int col = tc0 + (warp % wpr) * 8 + (lane & 7);
    const bool active = row < B.row0 + B.rows && col < P.W;
    const int p = active ? row * P.W + col : 0;               // in the level
    const int po = active ? (row - B.row0) * P.W + col : 0;   // in the band
    const float x1 = (float)col, y1 = (float)row;

    // the start
    float x = x1, y = y1;
    if (active) {
        if (START == START_MAP) {
            x = ONE_D ? x1 - __ldg(S.u + p) : x1 + __ldg(S.u + p);
            if (!ONE_D) y = y1 + __ldg(S.v + p);
        } else if (START == START_UP) {
            float ys = ((float)row + 0.5f) * S.ry - 0.5f;
            float xs = ((float)col + 0.5f) * S.rx - 0.5f;
            ys = fminf(fmaxf(ys, 0.0f), (float)(S.hc - 1));
            xs = fminf(fmaxf(xs, 0.0f), (float)(S.wc - 1));
            const float su = sample_map(S.u, S.hc, S.wc, xs, ys) * S.scale;
            x = ONE_D ? x1 - su : x1 + su;
            if (!ONE_D) y = y1 + sample_map(S.v, S.hc, S.wc, xs, ys) * S.scale;
        }
    }
    const bool ok1 = active && bounds_ok(x1, y1, P);

    // frame 1: the tile and its halo
    float* sm1 = smem;
    const int plane1 = T.s1 * T.r1;
    const int oy1 = max(tr0 - P.hh, 0), ox1 = max(tc0 - P.hw, 0);
    if (T.stage1)
        stage(sm1, T.s1, plane1, f1, nimg, P.W, oy1, ox1,
              min(tr0 + T.th - 1 + P.hh, P.H - 1) - oy1 + 1,
              min(tc0 + T.tw - 1 + P.hw, P.W - 1) - ox1 + 1);

    // frame 2: the bounding box of the start patches, with the margin
    float* sm2 = smem + (T.stage1 ? nimg * plane1 : 0);
    const int plane2 = T.s2 * T.r2;
    int oy2 = 0, ox2 = 0, ey2 = 0, ex2 = 0;
    if (T.stage2) {
        const bool in0 = ok1 && bounds_ok(x, y, P);
        int lo_x, lo_y, hi_x, hi_y;
        block_bbox(in0 ? (int)floorf(x) - P.hw : 0, in0 ? (int)floorf(y) - P.hh : 0, in0,
                   bbox, lo_x, lo_y, hi_x, hi_y);
        if (lo_x <= hi_x) {
            ox2 = max(lo_x - MARGIN, 0);
            oy2 = max(lo_y - MARGIN, 0);
            ex2 = min(min(hi_x + ww + MARGIN, P.W - 1) - ox2 + 1, T.s2);
            ey2 = min(min(hi_y + wh + MARGIN, P.H - 1) - oy2 + 1, T.r2);
            stage(sm2, T.s2, plane2, f2, nimg, P.W, oy2, ox2, ey2, ex2);
        }
    }
    __syncthreads();
    K8_MARK(0);                                 // the start and the staging

    // this pixel's frame-1 window (read only when ok1)
    Win w1;
    if (T.stage1) {
        const int off = (row - P.hh - oy1) * T.s1 + (col - P.hw - ox1);
        w1 = Win{sm1 + off, sm1 + plane1 + off, sm1 + 2 * plane1 + off, T.s1};
    } else {
        const int off = (row - P.hh) * P.W + (col - P.hw);
        w1 = Win{f1.img + off, f1.gx + off, f1.gy + off, P.W};
    }

    float s11 = 0.0f, m1 = 0.0f;
    if (LIGHTING && ok1) {
        float sw1 = 0.0f;
        for (int j = 0; j < wh; ++j)
            for (int i = 0; i < ww; ++i) {
                const float v1 = w1.a[j * w1.stride + i];
                s11 = s11 + v1 * v1;
                sw1 = sw1 + v1;
            }
        m1 = sw1 / n;
    }
    K8_MARK(1);                                 // frame-1 lighting sums

    // the frame-2 window at patch q: the staged box when it holds the patch
    auto frame2 = [&](const Patch& q) {
        if (q.x0 >= ox2 && q.x0 + ww < ox2 + ex2 && q.y0 >= oy2 && q.y0 + wh < oy2 + ey2) {
            const int off = (q.y0 - oy2) * T.s2 + (q.x0 - ox2);
            return Win{sm2 + off, sm2 + plane2 + off, sm2 + 2 * plane2 + off, T.s2};
        }
        K8_COUNT(6);
        const int off = q.y0 * P.W + q.x0;
        return Win{f2.img + off, f2.gx + off, f2.gy + off, P.W};
    };

    int status = KLT_TRACKED, it = 0;
    for (int step = 0; step < P.max_iterations; ++step) {
        if (!(ok1 && bounds_ok(x, y, P))) {
            status = KLT_OOB;
            break;
        }
        const Patch q = patch_at(x, y, P);
        const Win w2 = frame2(q);
        float alpha = 1.0f, beta = 0.0f;
        if (LIGHTING) gain_bias(w2, q, ww, wh, s11, m1, n, alpha, beta);
        float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f, ex = 0.0f, ey = 0.0f;
        for (int j = 0; j < wh; ++j) {
            const float* i1 = w1.a + j * w1.stride;
            const float* x1r = w1.b + j * w1.stride;
            const float* i20 = w2.a + j * w2.stride;
            const float* i21 = i20 + w2.stride;
            const float* x20 = w2.b + j * w2.stride;
            const float* x21 = x20 + w2.stride;
            float ci0 = i20[0], ci1 = i21[0], cx0 = x20[0], cx1 = x21[0];
            if (ONE_D) {
                for (int i = 0; i < ww; ++i) {
                    const float v1 = i1[i], g1x = x1r[i];
                    const float v2 = blend_carry(i20, i21, i, q, ci0, ci1);
                    const float g2x = blend_carry(x20, x21, i, q, cx0, cx1);
                    const float gx = g1x + g2x;
                    gxx = gxx + gx * gx;
                    ex = ex + (v1 - v2) * gx;
                }
            } else {
                const float* y1r = w1.c + j * w1.stride;
                const float* y20 = w2.c + j * w2.stride;
                const float* y21 = y20 + w2.stride;
                float cy0 = y20[0], cy1 = y21[0];
                for (int i = 0; i < ww; ++i) {
                    const float v1 = i1[i], g1x = x1r[i], g1y = y1r[i];
                    const float v2 = blend_carry(i20, i21, i, q, ci0, ci1);
                    const float g2x = blend_carry(x20, x21, i, q, cx0, cx1);
                    const float g2y = blend_carry(y20, y21, i, q, cy0, cy1);
                    const float dif = LIGHTING ? v1 - v2 * alpha - beta : v1 - v2;
                    const float gx = LIGHTING ? g1x + alpha * g2x : g1x + g2x;
                    const float gy = LIGHTING ? g1y + alpha * g2y : g1y + g2y;
                    gxx = gxx + gx * gx;
                    gxy = gxy + gx * gy;
                    gyy = gyy + gy * gy;
                    ex = ex + dif * gx;
                    ey = ey + dif * gy;
                }
            }
        }
        K8_MARK(2);                             // the taps of one iteration
        ex = P.step_factor * ex;
        bool done;
        if (ONE_D) {
            if (gxx < P.min_determinant) {
                status = KLT_SMALL_DET;
                K8_MARK(3);
                break;
            }
            const float du = ex / gxx;
            x = x + du;
            ++it;
            done = !(fabsf(du) >= P.min_displacement);
        } else {
            ey = P.step_factor * ey;
            const float det = gxx * gyy - gxy * gxy;
            if (det < P.min_determinant) {
                status = KLT_SMALL_DET;
                K8_MARK(3);
                break;
            }
            const float dx = (gyy * ex - gxy * ey) / det;
            const float dy = (gxx * ey - gxy * ex) / det;
            x = x + dx;
            y = y + dy;
            ++it;
            done = !(fabsf(dx) >= P.min_displacement || fabsf(dy) >= P.min_displacement);
        }
        K8_MARK(3);                             // the solve and the update
        if (done) break;
    }

    if (!bounds_ok(x, y, P)) status = KLT_OOB;
    if (status == KLT_TRACKED) {
        const Patch q = patch_at(x, y, P);
        const Win w2 = frame2(q);
        float alpha = 1.0f, beta = 0.0f;
        if (LIGHTING) gain_bias(w2, q, ww, wh, s11, m1, n, alpha, beta);
        float r = 0.0f;
        for (int j = 0; j < wh; ++j) {
            const float* i1 = w1.a + j * w1.stride;
            const float* i20 = w2.a + j * w2.stride;
            const float* i21 = i20 + w2.stride;
            float c0 = i20[0], c1 = i21[0];
            for (int i = 0; i < ww; ++i) {
                const float v2 = blend_carry(i20, i21, i, q, c0, c1);
                r = r + fabsf(LIGHTING ? i1[i] - v2 * alpha - beta : i1[i] - v2);
            }
        }
        const float residue = r / n;
        if (residue > P.max_residue) status = KLT_LARGE_RESIDUE;
        else if (it >= P.max_iterations) status = KLT_MAX_ITERATIONS;
    }
    K8_MARK(4);                                 // the final bounds and residue
    if (active) {
        if (ONE_D) {
            u_out[po] = x1 - x;
        } else {
            u_out[po] = x - x1;
            v_out[po] = y - y1;
        }
        status_out[po] = status;
        iter_out[po] = it;
    }
    K8_MARK(5);                                 // the outputs
    K8_CLOCKS_FLUSH;
}

// The smallest stride >= n that is 8 mod 32.
int bank_stride(int n) { return n + ((8 - n) % 32 + 32) % 32; }

// With ``blocks_per_sm``, nothing is launched: the CUDA occupancy
// calculator's count of this launch's blocks that one SM holds at once is
// written there instead.
template <bool ONE_D, bool LIGHTING, int START>
int launch(const Frame& f1, const Frame& f2, const Start& S, const LKParams& P, Tile T,
           const Band& B, float* uo, float* vo, int* st, int* iters, cudaStream_t stream,
           int* blocks_per_sm)
{
    const int nimg = ONE_D ? 2 : 3;
    const size_t b1 = sizeof(float) * nimg * (size_t)T.s1 * T.r1;
    const size_t b2 = sizeof(float) * nimg * (size_t)T.s2 * T.r2;
    T.stage1 = b1 <= SMEM_MAX;
    T.stage2 = (T.stage1 ? b1 : 0) + b2 <= SMEM_MAX;
    const size_t smem = (T.stage1 ? b1 : 0) + (T.stage2 ? b2 : 0);
    pft_allow_smem(lk_tile_kernel<ONE_D, LIGHTING, START>, smem);
    if (blocks_per_sm)
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, lk_tile_kernel<ONE_D, LIGHTING, START>, T.th * T.tw, smem);
    const dim3 grid(pft_ceil_div(P.W, T.tw), pft_ceil_div(B.rows, T.th));
    lk_tile_kernel<ONE_D, LIGHTING, START><<<grid, T.th * T.tw, smem, stream>>>(
        f1, f2, S, P, T, B, uo, vo, st, iters);
    return (int)cudaGetLastError();
}

template <bool ONE_D, bool LIGHTING>
int launch_start(int start, const Frame& f1, const Frame& f2, const Start& S,
                 const LKParams& P, const Tile& T, const Band& B, float* uo, float* vo,
                 int* st, int* iters, cudaStream_t s, int* bps)
{
    switch (start) {
    case START_MAP:
        return launch<ONE_D, LIGHTING, START_MAP>(f1, f2, S, P, T, B, uo, vo, st, iters, s,
                                                  bps);
    case START_ZERO:
        return launch<ONE_D, LIGHTING, START_ZERO>(f1, f2, S, P, T, B, uo, vo, st, iters, s,
                                                   bps);
    default:
        return launch<ONE_D, LIGHTING, START_UP>(f1, f2, S, P, T, B, uo, vo, st, iters, s,
                                                 bps);
    }
}

// The launch of one level (see pft_lk_dense_level), or with ``bps`` its
// blocks per SM.
int dispatch(const Frame& f1, const Frame& f2, const Start& S, const LKParams& P,
             int start, int lighting_insensitive, int one_d, int tile_h, int tile_w,
             const Band& B, float* uo, float* vo, int* st, int* iters, cudaStream_t s,
             int* bps)
{
    const int ww = 2 * P.hw + 1, wh = 2 * P.hh + 1;
    const Tile T{tile_h, tile_w, bank_stride(tile_w + ww - 1), tile_h + wh - 1,
                 bank_stride(tile_w + ww + 1 + 2 * MARGIN + SLACK),
                 tile_h + wh + 1 + 2 * MARGIN + SLACK, 0, 0};
    if (one_d)
        return launch_start<true, false>(start, f1, f2, S, P, T, B, uo, vo, st, iters, s, bps);
    return lighting_insensitive
        ? launch_start<false, true>(start, f1, f2, S, P, T, B, uo, vo, st, iters, s, bps)
        : launch_start<false, false>(start, f1, f2, S, P, T, B, uo, vo, st, iters, s, bps);
}

}  // namespace

// One dense level over the H x W pixel grid. 2-D: u, v in (start 0: maps of
// H x W; 1: none read; 2: the coarser level's hc x wc maps, with the
// float32 ratios ry = hc / H, rx = wc / W and the scale), u, v out. One-d:
// ``u`` is the disparity map d in (start 0 or 2) and out, the ``v``
// pointers are unused, start 1 is refused. tile_h x tile_w pixels per
// block: a multiple of 4 by a multiple of 8, at most 1024 threads. Rows
// [row0, row0 + nrows_out) are solved and written to nrows_out x W outputs
// (the whole level: row0 0, nrows_out H).
extern "C" int pft_lk_dense_level(const float* img1, const float* gx1, const float* gy1,
                                  const float* img2, const float* gx2, const float* gy2,
                                  const float* u, const float* v, int start, int hc,
                                  int wc, float ry, float rx, float scale, int H, int W,
                                  int window_width, int window_height, int max_iterations,
                                  float min_displacement, float min_determinant,
                                  float max_residue, float step_factor,
                                  int lighting_insensitive, int one_d, int tile_h,
                                  int tile_w, int row0, int nrows_out, float* u_out,
                                  float* v_out, int* status, int* iteration, void* stream)
{
    if (H <= 0 || W <= 0 || window_width % 2 != 1 || window_height % 2 != 1 ||
        row0 < 0 || nrows_out <= 0 || row0 > H - nrows_out ||
        start < START_MAP || start > START_UP || (one_d && start == START_ZERO) ||
        (start == START_UP && (hc <= 0 || wc <= 0 || hc * wc < 2)) || tile_h <= 0 ||
        tile_w <= 0 || tile_h % 4 != 0 || tile_w % 8 != 0 || tile_h * tile_w > NT_MAX)
        return PFT_INVALID_ARGUMENT;
    const LKParams P{H, W, H * W, window_width / 2, window_height / 2, max_iterations,
                     min_displacement, min_determinant, max_residue, step_factor};
    const Frame f1{img1, gx1, gy1}, f2{img2, gx2, gy2};
    const Band B{row0, nrows_out};
    const Start S{u, v, start == START_UP ? hc : H, start == START_UP ? wc : W, ry, rx,
                  scale};
    return dispatch(f1, f2, S, P, start, lighting_insensitive, one_d, tile_h, tile_w, B,
                    u_out, v_out, status, iteration, (cudaStream_t)stream, nullptr);
}

// Blocks of a pft_lk_dense_level launch with these arguments that one SM
// holds at once (the CUDA occupancy calculator: the kernel instance's
// registers, its threads and its shared memory), written to *blocks.
extern "C" int pft_lk_dense_blocks_per_sm(int start, int window_width, int window_height,
                                          int lighting_insensitive, int one_d, int tile_h,
                                          int tile_w, int* blocks)
{
    if (window_width % 2 != 1 || window_height % 2 != 1 || start < START_MAP ||
        start > START_UP || (one_d && start == START_ZERO) || tile_h <= 0 || tile_w <= 0 ||
        tile_h % 4 != 0 || tile_w % 8 != 0 || tile_h * tile_w > NT_MAX)
        return PFT_INVALID_ARGUMENT;
    LKParams P{};
    P.hw = window_width / 2;
    P.hh = window_height / 2;
    return dispatch(Frame{}, Frame{}, Start{}, P, start, lighting_insensitive, one_d, tile_h,
                    tile_w, Band{}, nullptr, nullptr, nullptr, nullptr, nullptr, blocks);
}

PFT_PHASE_READER(pft_lk_dense_phase_clocks)
