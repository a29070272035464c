// K5: greedy min-distance suppression over priority-ordered candidates.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_select.py: greedy_suppress_pallas
// (_suppress_kernel), the host greedy of ops/select.py
// (_enforce_minimum_distance, native/min_distance.cpp) as one kernel. Lane
// by lane in priority order, while fewer than the budget were accepted: a
// candidate that is valid, lies in the image and whose pixel is not yet
// covered is accepted and covers the (2 d + 1)^2 box around it (d =
// mindist - 1, clipped to the image; nothing when d < 0). Two entries run
// the same scan:
//   * pft_greedy_suppress: candidate pixels and flags in, the acceptance
//     flag of every lane, the accepted lanes in acceptance order (the rest
//     0) and their count out, under a budget read from device memory
//     (greedy_suppress_pallas' contract);
//   * pft_suppress_fill: the host API's selection after its sort
//     (ops/select.py). It takes the sort's outputs as they are (the
//     negated lattice values and the int64 order), decodes each
//     candidate's pixel (border + (order mod nx) step, border + (order div
//     nx) step) and validity (value >= min_eig), counts the free slots for
//     the budget, scans, and writes the r-th acceptance (x, y, value) into
//     the r-th free slot, the other free slots (-1, -1, -1), the kept ones
//     unchanged (cuda_select.fill_slots' rule).
//
// What bounds it on this card: latency. Each candidate's test depends on
// every earlier acceptance, so the work is a dependent chain of coverage
// reads and box stamps; the bytes (the candidates scanned, read once) are
// far below it. Design: one block of 512 threads. The grid holds one bit
// per pixel and lives in dynamic shared memory when it fits (480x640:
// 38.4 KB), else in a global scratch the wrapper allocates (1080x1920:
// 259 KB), read past L1; the block zeroes it, and any output it returns
// whole, with 16-byte stores. Coverage only grows, so a candidate covered
// at any moment is rejected for good: the block takes the candidates in
// windows of 512, every thread tests one (valid, in the image, not
// covered) and the survivors are compacted into shared memory in priority
// order (ballots and warp offsets). Warp 0 then walks only the survivors,
// 32 at a time, with the exact batch walk: each lane re-reads its pixel's
// bit (the grid grew since the window's test), one ballot gives the lanes
// that may be accepted, and the warp walks it in lane order, accepting a
// lane only if it lies farther than d (Chebyshev) from every lane already
// accepted in this batch (shuffles and ballots). That is the serial scan's
// answer, because the only coverage a batch's lanes cannot see in the grid
// is the batch's own. Each accepted box is stamped one row per lane (its
// one or two words' masks are the same on every row). While warp 0 walks,
// every thread's next candidate is already loading. The scan stops when
// the budget is met. At 480x640 the initial selection's 1000 acceptances
// come from 46,336 scanned candidates in 91 windows with 1,731 survivors,
// 116 walked batches; the earlier design walked 1,448 batches of 32
// candidates, and its stamps, one lane per box word with a division each,
// took 46 % of its cycles (phase_clocks.py). What is left is the chain
// itself: per acceptance about 220 cycles of walk and 300 of stamps. A walk
// by rounds of ballots over each lane's earlier near lanes, and stamps of
// one box per lane, were measured at the same cost and not kept.

#include "common.cuh"

namespace {

constexpr int NT = 512;          // threads; candidates per window
constexpr int NW = NT / 32;
constexpr int KLT_NOT_FOUND = -1;
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory left for the grid beside the static buffers
constexpr size_t SMEM_GRID_MAX = 232448 - 8192;

// Phase clocks (-DPFT_PHASE_CLOCKS builds only), marked by thread 0.
#define K5_MARK(t, k) PFT_PHASE(t, k, threadIdx.x == 0)

template <bool SHARED>
__device__ __forceinline__ unsigned load_word(const unsigned* grid, size_t i)
{
    if (SHARED) return grid[i];
    return __ldcg(grid + i);     // L2: the stamps are atomics there
}

// Zero nbytes at p, all threads, with 16-byte stores where aligned.
__device__ void zero_bytes(void* p, size_t nbytes)
{
    unsigned char* b = (unsigned char*)p;
    const size_t mis = (16 - ((size_t)b & 15)) & 15;
    const size_t head = mis < nbytes ? mis : nbytes;
    const size_t body = (nbytes - head) / 16;
    uint4* q = (uint4*)(b + head);
    for (size_t i = threadIdx.x; i < head; i += NT) b[i] = 0;
    for (size_t i = threadIdx.x; i < body; i += NT) q[i] = make_uint4(0, 0, 0, 0);
    for (size_t i = head + 16 * body + threadIdx.x; i < nbytes; i += NT) b[i] = 0;
}

// Candidates as pixel lists and 0/1 flags (pft_greedy_suppress).
struct ListCands {
    const int* xs;
    const int* ys;
    const unsigned char* valid;
    __device__ void get(int j, int& x, int& y, bool& v) const
    {
        x = xs[j];
        y = ys[j];
        v = valid[j] != 0;
    }
};

// Candidates as the sort's outputs over the lattice (pft_suppress_fill).
struct SortedCands {
    const int* neg;
    const long long* order;
    int borderx, bordery, step, nx, min_eig;
    __device__ void get(int j, int& x, int& y, bool& v) const
    {
        const int o = (int)order[j];
        x = borderx + (o % nx) * step;
        y = bordery + (o / nx) * step;
        v = -neg[j] >= min_eig;
    }
};

// Acceptance r is candidate j: flags and index list (greedy_suppress).
struct FlagSink {
    unsigned char* accepted;
    int* order;
    __device__ void put(int r, int j) const
    {
        accepted[j] = 1;
        order[r] = j;
    }
};

// Acceptance r is candidate j: the list the slot fill reads.
struct ListSink {
    int* acc;
    __device__ void put(int r, int j) const { acc[r] = j; }
};

// The block's shared scratch: a window's survivors in priority order, the
// warps' counts, the acceptances so far.
struct Scratch {
    int x[NT], y[NT], j[NT];
    int warp_count[NW];
    int n;
};

// Mask of bits lo..hi (0 <= lo <= hi <= 31) of a grid word.
__device__ __forceinline__ unsigned bits(int lo, int hi)
{
    return hi - lo == 31 ? FULL : ((1u << (hi - lo + 1)) - 1u) << lo;
}

// The greedy scan of candidates [0, k) under `limit` acceptances, by all
// threads on a zeroed grid. Returns the number of acceptances.
template <bool SHARED, class Cands, class Sink>
__device__ int scan(const Cands& cands, int k, int limit, unsigned* grid, int h, int w,
                    int d, const Sink& sink, Scratch& S)
{
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int words = (w + 31) >> 5;           // 32-bit words per image row
    PFT_PHASE_START(clk);
    int n = 0;                                 // acceptances so far (block-uniform)
    int cx = 0, cy = 0;
    bool cv = false;
    if (tid < k) cands.get(tid, cx, cy, cv);
    for (int base = 0; base < k && n < limit; base += NT) {
        // every thread tests one candidate against the grid
        const int x = cx, y = cy;
        bool ok = base + tid < k && cv && x >= 0 && x < w && y >= 0 && y < h;
        if (ok)
            ok = ((load_word<SHARED>(grid, (size_t)y * words + (x >> 5)) >> (x & 31)) & 1u)
                 == 0u;
        // the next window's candidate loads while this one is walked
        if (base + NT + tid < k) cands.get(base + NT + tid, cx, cy, cv);
        const unsigned wb = __ballot_sync(FULL, ok);
        if (lane == 0) S.warp_count[warp] = __popc(wb);
        __syncthreads();
        int pos = __popc(wb & ((1u << lane) - 1u)), total = 0;
        for (int k2 = 0; k2 < NW; ++k2) {
            const int c = S.warp_count[k2];
            pos += k2 < warp ? c : 0;
            total += c;
        }
        if (ok) {
            S.x[pos] = x;
            S.y[pos] = y;
            S.j[pos] = base + tid;
        }
        __syncthreads();
        K5_MARK(clk, 1);                       // window tested and compacted

        if (warp == 0) {
            for (int b = 0; b < total && n < limit; b += 32) {
                const int i = b + lane;
                const bool in = i < total;
                const int sx = in ? S.x[i] : 0, sy = in ? S.y[i] : 0;
                bool open = in;
                if (in)
                    open = ((load_word<SHARED>(grid, (size_t)sy * words + (sx >> 5))
                             >> (sx & 31)) & 1u) == 0u;
                unsigned cand = __ballot_sync(FULL, open);
                // serial walk of the batch in lane order
                unsigned acc = 0u;
                int room = limit - n;
                while (cand != 0u && room > 0) {
                    const int l = __ffs(cand) - 1;
                    acc |= 1u << l;
                    --room;
                    const int xl = __shfl_sync(FULL, sx, l);
                    const int yl = __shfl_sync(FULL, sy, l);
                    const bool near = ((cand >> lane) & 1u) && d >= 0
                                      && abs(sx - xl) <= d && abs(sy - yl) <= d;
                    cand &= ~(__ballot_sync(FULL, near) | (1u << l));
                }
                if ((acc >> lane) & 1u)
                    sink.put(n + __popc(acc & ((1u << lane) - 1u)), S.j[i]);
                n += __popc(acc);
                K5_MARK(clk, 2);               // serial walk of a batch

                // stamps: one box row per lane, the same word masks per row
                unsigned todo = d >= 0 ? acc : 0u;
                while (todo != 0u) {
                    const int l = __ffs(todo) - 1;
                    todo &= todo - 1u;
                    const int xl = __shfl_sync(FULL, sx, l);
                    const int yl = __shfl_sync(FULL, sy, l);
                    const int r0 = max(yl - d, 0), r1 = min(yl + d, h - 1);
                    const int c0 = max(xl - d, 0), c1 = min(xl + d, w - 1);
                    const int w0 = c0 >> 5, w1 = c1 >> 5;
                    const unsigned m0 = bits(c0 & 31, w0 == w1 ? (c1 & 31) : 31);
                    const unsigned m1 = bits(0, c1 & 31);
                    for (int r = r0 + lane; r <= r1; r += 32) {
                        unsigned* row = grid + (size_t)r * words;
                        atomicOr(row + w0, m0);
                        for (int wi = w0 + 1; wi < w1; ++wi) atomicOr(row + wi, FULL);
                        if (w1 > w0) atomicOr(row + w1, m1);
                    }
                }
                __syncwarp();
                K5_MARK(clk, 3);               // box stamps
            }
            if (lane == 0) S.n = n;
        }
        __syncthreads();
        n = S.n;
    }
    return n;
}

// Sum of v over the block.
__device__ int block_sum(int v, Scratch& S)
{
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    v = __reduce_add_sync(FULL, v);
    if (lane == 0) S.warp_count[warp] = v;
    __syncthreads();
    int t = 0;
    for (int k = 0; k < NW; ++k) t += S.warp_count[k];
    __syncthreads();
    return t;
}

template <bool SHARED>
__global__ void __launch_bounds__(NT)
suppress_kernel(ListCands cands, int k, const int* __restrict__ budget_ptr, int h, int w,
                int d, int max_out, unsigned* gmem_grid, unsigned char* __restrict__ accepted,
                int* __restrict__ order, int* __restrict__ n_acc)
{
    extern __shared__ uint4 smem_grid4[];
    __shared__ Scratch S;
    unsigned* grid = SHARED ? (unsigned*)smem_grid4 : gmem_grid;
    PFT_PHASE_START(clk);
    zero_bytes(grid, sizeof(unsigned) * (size_t)h * ((w + 31) >> 5));
    zero_bytes(accepted, (size_t)k);
    zero_bytes(order, sizeof(int) * (size_t)max_out);
    __syncthreads();
    K5_MARK(clk, 0);                           // outputs and grid zeroed
    const int limit = min(*budget_ptr, max_out);
    const int n = scan<SHARED>(cands, k, limit, grid, h, w, d, FlagSink{accepted, order}, S);
    if (threadIdx.x == 0) *n_acc = n;
}

template <bool SHARED>
__global__ void __launch_bounds__(NT)
fill_kernel(SortedCands cands, int k, int h, int w, int d, const float* __restrict__ x,
            const float* __restrict__ y, const int* __restrict__ val, int n_slots,
            int replacing, unsigned* gmem_grid, int* __restrict__ acc,
            float* __restrict__ x_out, float* __restrict__ y_out, int* __restrict__ val_out)
{
    extern __shared__ uint4 smem_grid4[];
    __shared__ Scratch S;
    unsigned* grid = SHARED ? (unsigned*)smem_grid4 : gmem_grid;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    PFT_PHASE_START(clk);
    zero_bytes(grid, sizeof(unsigned) * (size_t)h * ((w + 31) >> 5));
    // the budget: the free slots (block_sum's barriers also order the zeroing)
    int nfree = 0;
    for (int i = tid; i < n_slots; i += NT) nfree += !replacing || val[i] < 0;
    const int limit = block_sum(nfree, S);
    K5_MARK(clk, 0);                           // grid zeroed, budget counted
    const int n = scan<SHARED>(cands, k, limit, grid, h, w, d, ListSink{acc}, S);

    // the r-th acceptance into the r-th free slot
    PFT_PHASE_START(clk_fill);
    int carry = 0;
    for (int base = 0; base < n_slots; base += NT) {
        const int i = base + tid;
        const bool in = i < n_slots;
        const bool free = in && (!replacing || val[i] < 0);
        const unsigned fb = __ballot_sync(FULL, free);
        if (lane == 0) S.warp_count[warp] = __popc(fb);
        __syncthreads();
        int rank = carry + __popc(fb & ((1u << lane) - 1u));
        for (int k2 = 0; k2 < NW; ++k2) {
            const int c = S.warp_count[k2];
            rank += k2 < warp ? c : 0;
            carry += c;
        }
        __syncthreads();
        if (!in) continue;
        if (!free) {
            x_out[i] = x[i];
            y_out[i] = y[i];
            val_out[i] = val[i];
        } else if (rank < n) {
            const int j = __ldcg(acc + rank);
            int cx, cy;
            bool cv;
            cands.get(j, cx, cy, cv);
            x_out[i] = (float)cx;
            y_out[i] = (float)cy;
            val_out[i] = -cands.neg[j];
        } else {
            x_out[i] = -1.0f;
            y_out[i] = -1.0f;
            val_out[i] = KLT_NOT_FOUND;
        }
    }
    K5_MARK(clk_fill, 4);                      // the slot fill
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
    const ListCands c{xs, ys, valid};
    if (grid == nullptr) {
        const size_t smem = grid_bytes(h, w);
        if (smem > SMEM_GRID_MAX) return PFT_INVALID_ARGUMENT;
        pft_allow_smem(suppress_kernel<true>, smem);
        suppress_kernel<true><<<1, NT, smem, s>>>(c, k, budget, h, w, d, max_out, nullptr,
                                                 accepted, order, n_acc);
    } else {
        suppress_kernel<false><<<1, NT, 0, s>>>(c, k, budget, h, w, d, max_out, grid,
                                                accepted, order, n_acc);
    }
    return (int)cudaGetLastError();
}

// The host API's selection after its sort: neg [k] int32 and order [k]
// int64 are torch.sort(-lattice, stable=True)'s outputs over the candidate
// lattice of nx columns at (borderx + c step, bordery + r step); min_eig:
// the validity bar; d: box radius (mindist - 1); x, y (float32), val
// (int32): the n_slots feature slots (free: val < 0 when replacing, else
// all). acc: an int32 [n_slots] scratch. grid: as pft_greedy_suppress's.
// Writes the new slots to x_out, y_out, val_out.
extern "C" int pft_suppress_fill(const int* neg, const long long* order, int k, int borderx,
                                 int bordery, int step, int nx, int min_eig, int h, int w,
                                 int d, const float* x, const float* y, const int* val,
                                 int n_slots, int replacing, unsigned* grid, int* acc,
                                 float* x_out, float* y_out, int* val_out, void* stream)
{
    if (k < 0 || h <= 0 || w <= 0 || nx <= 0 || step <= 0 || n_slots < 0)
        return PFT_INVALID_ARGUMENT;
    cudaStream_t s = (cudaStream_t)stream;
    const SortedCands c{neg, order, borderx, bordery, step, nx, min_eig};
    if (grid == nullptr) {
        const size_t smem = grid_bytes(h, w);
        if (smem > SMEM_GRID_MAX) return PFT_INVALID_ARGUMENT;
        pft_allow_smem(fill_kernel<true>, smem);
        fill_kernel<true><<<1, NT, smem, s>>>(c, k, h, w, d, x, y, val, n_slots, replacing,
                                             nullptr, acc, x_out, y_out, val_out);
    } else {
        fill_kernel<false><<<1, NT, 0, s>>>(c, k, h, w, d, x, y, val, n_slots, replacing,
                                            grid, acc, x_out, y_out, val_out);
    }
    return (int)cudaGetLastError();
}

PFT_PHASE_READER(pft_suppress_phase_clocks)
