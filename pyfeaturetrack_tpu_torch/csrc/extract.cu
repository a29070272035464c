// K4: greedy min-distance extraction straight from the candidate eig map.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_select.py: greedy_extract_pallas
// (_extract_kernel). Repeats, until the map's maximum drops below min_eig
// or `budget` candidates were accepted: take the global argmax (first
// occurrence in row-major order, the host sort's stable tie-break), record
// (row, col, value), zero the (2 dg + 1)^2 box around it. The result is the
// host greedy's acceptance sequence over the full candidate pool.
//
// What bounds it on this card: the serial chain of acceptances (each
// depends on the previous box), so latency of block-wide reductions, not
// bytes. Design: one persistent CTA works in place on a scratch copy of the
// candidate map (the wrapper makes the copy). Shared memory caches each
// row's maximum and the first column where it occurs. An acceptance is
// then a block argmax over the row maxima (lowest row on ties, which with
// the cached first column gives the row-major first occurrence), one
// record, the box zeroing, and a rescan of only the 2 dg + 1 rows the box
// touched: O(ny + (2 dg + 1) nx) per acceptance instead of a full-map scan,
// in the same acceptance order. `budget` is read from device memory and
// the count of acceptances is written to device memory, so a refill needs
// no host round trip.

#include <climits>

#include "common.cuh"

namespace {

constexpr int NT = 1024;

// better = larger value, then smaller index
__device__ __forceinline__ void take_better(int& v, int& idx, int ov, int oidx)
{
    if (ov > v || (ov == v && oidx < idx)) {
        v = ov;
        idx = oidx;
    }
}

__device__ __forceinline__ void warp_argmax(int& v, int& idx)
{
    for (int off = 16; off >= 1; off >>= 1) {
        const int ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        take_better(v, idx, ov, oi);
    }
}

// One warp: maximum of a row and the first column holding it.
__device__ __forceinline__ void scan_row(const int* row, int nx, int lane,
                                         int* rmax, int* rarg)
{
    int v = INT_MIN, c = INT_MAX;
    for (int j = lane; j < nx; j += 32) take_better(v, c, row[j], j);
    warp_argmax(v, c);
    if (lane == 0) {
        *rmax = v;
        *rarg = c;
    }
}

__global__ void __launch_bounds__(NT)
extract_kernel(int* __restrict__ cand, int ny, int nx,
               const int* __restrict__ budget_ptr, int min_eig, int dg,
               int max_out, int* __restrict__ out_r, int* __restrict__ out_c,
               int* __restrict__ out_v, int* __restrict__ n_acc)
{
    extern __shared__ int sm[];
    int* rmax = sm;          // [ny]
    int* rarg = sm + ny;     // [ny]
    __shared__ int red_v[NT / 32], red_r[NT / 32];
    __shared__ int best_v, best_r;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = NT / 32;

    for (int i = tid; i < max_out; i += NT) {
        out_r[i] = 0;
        out_c[i] = 0;
        out_v[i] = 0;
    }
    for (int r = warp; r < ny; r += nwarps)
        scan_row(cand + (size_t)r * nx, nx, lane, rmax + r, rarg + r);
    __syncthreads();

    int budget = *budget_ptr;
    if (budget > max_out) budget = max_out;
    int n = 0;
    while (n < budget) {
        int v = INT_MIN, r = INT_MAX;
        for (int i = tid; i < ny; i += NT) take_better(v, r, rmax[i], i);
        warp_argmax(v, r);
        if (lane == 0) {
            red_v[warp] = v;
            red_r[warp] = r;
        }
        __syncthreads();
        if (warp == 0) {
            v = red_v[lane];
            r = red_r[lane];
            warp_argmax(v, r);
            if (lane == 0) {
                best_v = v;
                best_r = r;
            }
        }
        __syncthreads();
        v = best_v;
        r = best_r;
        if (v < min_eig) break;                 // pool dry (block-uniform)
        const int c = rarg[r];
        if (tid == 0) {
            out_r[n] = r;
            out_c[n] = c;
            out_v[n] = v;
        }
        const int r0 = r - dg > 0 ? r - dg : 0, r1 = r + dg < ny - 1 ? r + dg : ny - 1;
        const int c0 = c - dg > 0 ? c - dg : 0, c1 = c + dg < nx - 1 ? c + dg : nx - 1;
        const int bw = c1 - c0 + 1, bh = r1 - r0 + 1;
        for (int i = tid; i < bw * bh; i += NT)
            cand[(size_t)(r0 + i / bw) * nx + c0 + i % bw] = 0;
        __syncthreads();
        for (int rr = r0 + warp; rr <= r1; rr += nwarps)
            scan_row(cand + (size_t)rr * nx, nx, lane, rmax + rr, rarg + rr);
        __syncthreads();
        ++n;
    }
    if (tid == 0) *n_acc = n;
}

}  // namespace

// cand: [ny, nx] int32 scratch copy, overwritten. budget, n_acc: one int32
// each in device memory. out_*: [max_out] int32 (lanes >= n_acc are zero).
extern "C" int pft_greedy_extract(int* cand, int ny, int nx, const int* budget,
                                  int min_eig, int dg, int max_out,
                                  int* out_r, int* out_c, int* out_v, int* n_acc,
                                  void* stream)
{
    if (ny <= 0 || nx <= 0 || dg < 0 || max_out < 0) return PFT_INVALID_ARGUMENT;
    const size_t smem = sizeof(int) * 2 * (size_t)ny;
    if (smem > 200 * 1024) return PFT_INVALID_ARGUMENT;
    pft_allow_smem(extract_kernel, smem);
    extract_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
        cand, ny, nx, budget, min_eig, dg, max_out, out_r, out_c, out_v, n_acc);
    return (int)cudaGetLastError();
}
