// K5: greedy min-distance suppression over priority-ordered candidates.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_select.py: greedy_suppress_pallas
// (_suppress_kernel), the host greedy of ops/select.py
// (_enforce_minimum_distance, native/min_distance.cpp) as one kernel. Lane
// by lane in priority order, while fewer than `budget` were accepted: a
// candidate that is valid, lies in the image and whose pixel is not yet
// covered is accepted and covers the (2 d + 1)^2 box around it (d =
// mindist - 1, clipped to the image; nothing when d < 0). Outputs: the
// acceptance flag of every lane, the accepted lanes' indices in acceptance
// order (the first n_acc entries of `order`, the rest 0) and n_acc.
//
// What bounds it on this card: latency. Each candidate's test depends on
// every earlier acceptance, so the work is a dependent chain of coverage
// reads and box stamps; the bytes (the candidate list read once) are far
// below it. Design: one block; all its threads zero the outputs and the
// coverage grid, then warp 0 scans. The grid holds one bit per pixel and
// lives in dynamic shared memory when it fits the block's 227 KB (480x640:
// 38.4 KB), else in a global scratch the wrapper allocates (1080x1920:
// 259 KB), read past L1. The warp takes 32 consecutive candidates at a
// time: each lane reads its pixel's bit, one ballot gives the lanes that
// may be accepted, and the warp walks that ballot in lane order, accepting
// a lane only if it lies farther than d (Chebyshev) from every lane
// already accepted in this batch (shuffles and ballots, no memory). That
// is exact, because the only coverage a batch's lanes cannot see in the
// grid is the batch's own. Then the lanes stamp the accepted boxes, one
// 32-bit word of a box row each, and the warp syncs. An all-invalid batch
// costs one ballot, so a dry pool scans to the end cheaply; each lane
// keeps the next 8 batches' candidates in flight in registers.

#include "common.cuh"

namespace {

constexpr int NT = 512;          // threads that zero the outputs and grid
constexpr int CHUNK = 8;         // batches of 32 candidates held per load
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_GRID_MAX = 232448;   // dynamic shared memory a block can use

template <bool SHARED>
__device__ __forceinline__ unsigned load_word(const unsigned* grid, size_t i)
{
    if (SHARED) return grid[i];
    return __ldcg(grid + i);     // L2: the stamps are atomics there
}

template <bool SHARED>
__global__ void __launch_bounds__(NT)
suppress_kernel(const int* __restrict__ xs, const int* __restrict__ ys,
                const unsigned char* __restrict__ valid, int k,
                const int* __restrict__ budget_ptr, int h, int w, int d,
                int max_out, unsigned* gmem_grid,
                unsigned char* __restrict__ accepted, int* __restrict__ order,
                int* __restrict__ n_acc)
{
    extern __shared__ unsigned smem_grid[];
    unsigned* grid = SHARED ? smem_grid : gmem_grid;
    const int words = (w + 31) >> 5;            // 32-bit words per image row
    const size_t grid_words = (size_t)h * words;
    const int tid = threadIdx.x;
    for (size_t i = tid; i < grid_words; i += NT) grid[i] = 0u;
    for (int i = tid; i < k; i += NT) accepted[i] = 0;
    for (int i = tid; i < max_out; i += NT) order[i] = 0;
    __syncthreads();
    if (tid >= 32) return;

    const int lane = tid;
    int limit = *budget_ptr;
    if (limit > max_out) limit = max_out;
    int n = 0;                                  // acceptances so far (warp-uniform)

    int nx_[CHUNK], ny_[CHUNK], nv_[CHUNK];     // next chunk, in flight
    auto load_chunk = [&](int base) {
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
            const int j = base + c * 32 + lane;
            const bool in = j < k;
            nx_[c] = in ? xs[j] : 0;
            ny_[c] = in ? ys[j] : 0;
            nv_[c] = in ? valid[j] : 0;
        }
    };
    load_chunk(0);
    for (int base = 0; base < k && n < limit; base += 32 * CHUNK) {
        int cx[CHUNK], cy[CHUNK], cv[CHUNK];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
            cx[c] = nx_[c];
            cy[c] = ny_[c];
            cv[c] = nv_[c];
        }
        if (base + 32 * CHUNK < k) load_chunk(base + 32 * CHUNK);
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
            if (n >= limit) break;
            const int j = base + c * 32 + lane;
            const int x = cx[c], y = cy[c];
            bool ok = cv[c] != 0 && x >= 0 && x < w && y >= 0 && y < h;
            if (ok) {
                const unsigned word = load_word<SHARED>(
                    grid, (size_t)y * words + (x >> 5));
                ok = ((word >> (x & 31)) & 1u) == 0u;
            }
            unsigned cand = __ballot_sync(FULL, ok);
            if (cand == 0u) continue;

            // serial walk of the batch in lane order
            unsigned acc = 0u;
            int room = limit - n;
            while (cand != 0u && room > 0) {
                const int i = __ffs(cand) - 1;
                acc |= 1u << i;
                --room;
                const int xi = __shfl_sync(FULL, x, i);
                const int yi = __shfl_sync(FULL, y, i);
                const bool near = ((cand >> lane) & 1u) && d >= 0
                                  && abs(x - xi) <= d && abs(y - yi) <= d;
                cand &= ~(__ballot_sync(FULL, near) | (1u << i));
            }
            if ((acc >> lane) & 1u) {
                accepted[j] = 1;
                order[n + __popc(acc & ((1u << lane) - 1u))] = j;
            }
            n += __popc(acc);

            if (d >= 0) {
                unsigned todo = acc;
                while (todo != 0u) {
                    const int i = __ffs(todo) - 1;
                    todo &= todo - 1u;
                    const int xi = __shfl_sync(FULL, x, i);
                    const int yi = __shfl_sync(FULL, y, i);
                    const int r0 = max(yi - d, 0), r1 = min(yi + d, h - 1);
                    const int c0 = max(xi - d, 0), c1 = min(xi + d, w - 1);
                    const int w0 = c0 >> 5, nw = (c1 >> 5) - w0 + 1;
                    const int items = (r1 - r0 + 1) * nw;
                    for (int t = lane; t < items; t += 32) {
                        const int r = r0 + t / nw, wi = w0 + t % nw;
                        const int lo = max(c0 - (wi << 5), 0);
                        const int hi = min(c1 - (wi << 5), 31);
                        const unsigned mask = hi - lo == 31
                            ? FULL : ((1u << (hi - lo + 1)) - 1u) << lo;
                        atomicOr(grid + (size_t)r * words + wi, mask);
                    }
                }
            }
            __syncwarp();
        }
    }
    if (lane == 0) *n_acc = n;
}

// Bytes of the coverage grid for an h x w image (one bit per pixel).
size_t grid_bytes(int h, int w)
{
    return sizeof(unsigned) * (size_t)h * ((w + 31) / 32);
}

}  // namespace

// xs, ys: [k] int32 candidate pixels in priority order; valid: [k] bytes
// (0/1). budget, n_acc: one int32 each in device memory. d: box radius
// (mindist - 1; < 0 stamps nothing). grid: null for the shared-memory grid,
// else a global scratch of grid_bytes(h, w) bytes (its contents are
// overwritten). accepted: [k] bytes; order: [max_out] int32.
// At most min(budget, max_out) candidates are accepted.
extern "C" int pft_greedy_suppress(const int* xs, const int* ys,
                                   const unsigned char* valid, int k,
                                   const int* budget, int h, int w, int d,
                                   int max_out, unsigned* grid,
                                   unsigned char* accepted, int* order,
                                   int* n_acc, void* stream)
{
    if (k < 0 || h <= 0 || w <= 0 || max_out < 0) return PFT_INVALID_ARGUMENT;
    cudaStream_t s = (cudaStream_t)stream;
    if (grid == nullptr) {
        const size_t smem = grid_bytes(h, w);
        if (smem > SMEM_GRID_MAX) return PFT_INVALID_ARGUMENT;
        pft_allow_smem(suppress_kernel<true>, smem);
        suppress_kernel<true><<<1, NT, smem, s>>>(
            xs, ys, valid, k, budget, h, w, d, max_out, nullptr, accepted,
            order, n_acc);
    } else {
        suppress_kernel<false><<<1, NT, 0, s>>>(
            xs, ys, valid, k, budget, h, w, d, max_out, grid, accepted, order,
            n_acc);
    }
    return (int)cudaGetLastError();
}
