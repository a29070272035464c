// K4: the device route's (re)selection from the int32 min-eig map, in two
// launches.
//
// Replaces pyfeaturetrack_tpu/ops/pallas_select.py: greedy_extract_pallas
// (_extract_kernel), with the candidate pre-mask before it and the slot
// fill after it (pyfeaturetrack_tpu/ops/select_device.py:188-249). The
// greedy repeats, until the lattice's maximum drops below min_eig or
// `budget` candidates were accepted: take the global argmax (first
// occurrence in row-major order, the host sort's stable tie-break), record
// (row, col, value), zero the (2 dg + 1)^2 box around it. The result is the
// host greedy's acceptance sequence over the full candidate pool.
//
// Stage A (lattice_kernel), across the card: one warp per lattice row, 4
// rows per CTA. It reads the strided lattice straight from the eig map
// (borders, then step = nSkippedPixels + 1), zeroes cells below min_eig
// and, when refilling with mindist >= 1, every cell whose pixel lies within
// Chebyshev distance `radius` = mindist - 1 of a kept feature's (int32(x),
// int32(y)) clamped into the frame: the CTA stages the kept features near
// its rows in shared memory and stamps their boxes into a shared mask, which
// sampled at lattice points equals the stamped-then-dilated occupancy map
// of the JAX package. One lane scans a segment of `seg` columns. It writes
// the lattice (rows padded to a multiple of seg with zeros) and its maxima
// with their first column: per segment and per row.
//
// Stage B (chain_kernel), one CTA of 32 warps: the budget is counted from
// val (free slots; all n on an initial selection), the segment and row
// maxima come into shared memory, and the chain runs in the host greedy's
// order. Its argmax (warp 0) is a search over groups of 32 rows whose
// maxima sit in shared memory, reduced with __reduce_max_sync and
// __reduce_min_sync (largest value, then the smallest row-major index: the
// first occurrence). The segment maxima sit in shared memory beside the
// row maxima: the wrapper picks the smallest segment width (a power of
// two of at least 32 columns) whose maxima fit (32 at 480x640, 128 at
// 1080x1920, 512 at 2160x3840); a row of one segment keeps only its row
// maximum. The lattice itself stays as stage A wrote it: an accepted box
// is set in a bitmap of the lattice, one bit per cell, in shared memory
// where it fits (480x640: 32 KB) and otherwise in the device-memory
// scratch the wrapper always passes (1080x1920 and up); pft_greedy_chain
// alone decides which. After an acceptance one warp per row of the box
// sets the row's box bits, rescans a touched segment only when its
// maximum lay inside the box (lanes over the segment's cells, cells whose
// bit is set counting as zero, one warp reduction), and recomputes the
// row's maximum from its segment maxima only when that lay inside the box;
// then one warp per touched group recomputes the group's maximum if it lay
// inside the box. Three block barriers per acceptance. Acceptances collect
// in shared memory, 256 at a time. After the chain the CTA writes the r-th
// acceptance into the r-th free slot (x, y, val, filled), as fill_slots
// does, and -1, -1, KLT_NOT_FOUND into free slots left empty. On a refill,
// thread 0 then adds the chain's acceptances and its segment rescans to the
// device counters (common.cuh): two atomics a launch.
//
// What bounds it on this card: the chain is serial (each acceptance
// depends on the previous box), so the latency of one acceptance: the
// argmax's warp reductions, three block barriers, one L2 round trip for
// the rescans, the row and group reductions (chip_smoke.py times it; the
// per-acceptance cost is in PERF.md). The bytes (the
// eig lattice read once, the kept features, the slots written) are a few
// microseconds of the card's bandwidth, spread over stage A's CTAs.

#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KLT_NOT_FOUND = -1;
constexpr int A_WARPS = 4;              // lattice rows per stage-A CTA
constexpr int A_NT = 32 * A_WARPS;
constexpr int A_CHUNK = 1024;           // kept features staged per round
constexpr int B_NT = 1024;
constexpr int ACC_CHUNK = 256;          // acceptances buffered in shared memory

struct Lattice {
    int ny, nx;
    int stride;                         // padded row length, a multiple of seg
    int seg;                            // segment width (columns)
    int nseg;                           // segments per row
};

__device__ __forceinline__ int floor_div(int a, int b)   // b > 0
{
    const int q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Largest v across the warp, then the smallest idx holding it.
__device__ __forceinline__ void warp_argmax(int& v, int& idx)
{
    const int vmax = __reduce_max_sync(FULL, v);
    idx = __reduce_min_sync(FULL, v == vmax ? idx : INT_MAX);
    v = vmax;
}

// MSMEM: the CTA's pre-mask rows in shared memory, else in `gmask` (device
// memory, A_WARPS rows of `stride` bytes per CTA) for lattices too wide.
template <bool MSMEM>
__global__ void __launch_bounds__(A_NT)
lattice_kernel(const int* __restrict__ eig, int nrows, int ncols,
               const float* __restrict__ fx, const float* __restrict__ fy,
               const int* __restrict__ fval, int n, int radius, int borderx,
               int bordery, int step, int min_eig, int seg, Lattice G,
               unsigned char* gmask, int* __restrict__ lat, int* __restrict__ seg_v,
               int* __restrict__ seg_c, int* __restrict__ row_v, int* __restrict__ row_c)
{
    extern __shared__ unsigned char smask[];       // [A_WARPS][stride]
    unsigned char* blocked =
        MSMEM ? smask : gmask + (size_t)blockIdx.x * A_WARPS * G.stride;
    __shared__ int2 list[A_CHUNK];
    __shared__ int n_list;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r0 = blockIdx.x * A_WARPS;
    const int rows = min(A_WARPS, G.ny - r0);

    if (radius >= 0) {
        for (int i = tid; i < A_WARPS * G.stride; i += A_NT) blocked[i] = 0;
        if constexpr (!MSMEM) __threadfence_block();
        const int py_lo = bordery + r0 * step;
        const int py_hi = bordery + (r0 + rows - 1) * step;
        for (int base = 0; base < n; base += A_CHUNK) {
            if (tid == 0) n_list = 0;
            __syncthreads();
            const int end = min(n, base + A_CHUNK);
#pragma unroll 4
            for (int i = base + tid; i < end; i += A_NT) {
                const int v = fval[i];
                const float xf = fx[i], yf = fy[i];     // loads in flight together
                if (v < 0) continue;
                // truncation toward zero, then the clamp (select_device.py:129)
                const int xi = min(max((int)xf, 0), ncols - 1);
                const int yi = min(max((int)yf, 0), nrows - 1);
                if (yi + radius < py_lo || yi - radius > py_hi) continue;
                list[atomicAdd(&n_list, 1)] = make_int2(xi, yi);
            }
            __syncthreads();
            for (int k = warp; k < n_list; k += A_WARPS) {
                const int2 p = list[k];
                // lattice rows / columns whose pixel lies within radius of p
                // (no division on the usual step of 1)
                const int rl = max(step == 1 ? p.y - radius - bordery
                                             : -floor_div(bordery + radius - p.y, step), r0);
                const int rh = min(step == 1 ? p.y + radius - bordery
                                             : floor_div(p.y + radius - bordery, step),
                                   r0 + rows - 1);
                const int cl = max(step == 1 ? p.x - radius - borderx
                                             : -floor_div(borderx + radius - p.x, step), 0);
                const int ch = min(step == 1 ? p.x + radius - borderx
                                             : floor_div(p.x + radius - borderx, step),
                                   G.nx - 1);
                for (int row = rl; row <= rh; ++row)
                    for (int col = cl + lane; col <= ch; col += 32)
                        blocked[(row - r0) * G.stride + col] = 1;
            }
            if constexpr (!MSMEM) __threadfence_block();
            __syncthreads();
        }
    }
    if (warp >= rows) return;

    // one lane per segment: its cells' loads are independent and in flight
    // together, and the warp reduces once per row
    const int r = r0 + warp;
    const int* erow = eig + (size_t)(bordery + r * step) * ncols + borderx;
    const unsigned char* brow = blocked + warp * G.stride;
    int* lrow = lat + (size_t)r * G.stride;
    int rv = INT_MIN, rc = INT_MAX;
    for (int s = lane; s < G.nseg; s += 32) {
        int sv = INT_MIN, sc = INT_MAX;
#pragma unroll 8
        for (int c0 = s * seg; c0 < (s + 1) * seg; c0 += 4) {
            int v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = c0 + j;
                v[j] = 0;
                if (c < G.nx) {
                    v[j] = erow[(size_t)c * step];
                    if (v[j] < min_eig || (radius >= 0 && brow[c])) v[j] = 0;
                }
                if (v[j] > sv) {                // ascending c: first occurrence
                    sv = v[j];
                    sc = c;
                }
            }
            *reinterpret_cast<int4*>(lrow + c0) = make_int4(v[0], v[1], v[2], v[3]);
        }
        seg_v[r * G.nseg + s] = sv;
        seg_c[r * G.nseg + s] = sc;
        if (sv > rv) {                          // ascending s: first occurrence
            rv = sv;
            rc = sc;
        }
    }
    warp_argmax(rv, rc);
    if (lane == 0) {
        row_v[r] = rv;
        row_c[r] = rc;
    }
}

// Bits [lo, hi] of the 32-column bitmap word w (lo, hi absolute columns
// inside the word).
__device__ __forceinline__ unsigned span_bits(int lo, int hi, int w)
{
    const int n = hi - lo + 1;
    return (n == 32 ? 0xffffffffu : ((1u << n) - 1u)) << (lo - 32 * w);
}

// Stage B (see the top of the file). SEG: the segment width, 0 to read it
// from G (widths above 1024, and lattices with rows in device memory).
// BSMEM: the box bitmap in shared memory, else `gbits` in device memory.
// RSMEM: the row maxima in shared memory, else after the bitmap in `gbits`
// (one segment per row, more rows than shared memory holds: 27,803).
template <int SEG, bool BSMEM, bool RSMEM = true>
__global__ void __launch_bounds__(B_NT)
chain_kernel(const int* __restrict__ lat, Lattice G, const int* __restrict__ seg_v_in,
             const int* __restrict__ seg_c_in, const int* __restrict__ row_v_in,
             const int* __restrict__ row_c_in, unsigned* __restrict__ gbits,
             const int* __restrict__ budget_ptr, int min_eig, int dg, int max_out,
             int* __restrict__ out_r, int* __restrict__ out_c, int* __restrict__ out_v,
             int* __restrict__ n_acc_out, const float* __restrict__ x,
             const float* __restrict__ y, const int* __restrict__ val, int n,
             int replacing, int borderx, int bordery, int step,
             float* __restrict__ x_out, float* __restrict__ y_out,
             int* __restrict__ val_out, bool* __restrict__ filled,
             unsigned long long* __restrict__ counters)
{
    extern __shared__ int smem[];
    const int seg = SEG > 0 ? SEG : G.seg;
    const bool split = G.nseg > 1;      // else a row's segment is the row
    const int nsegs = split ? G.ny * G.nseg : 0, ngroups = pft_ceil_div(G.ny, 32);
    const int words = G.stride / 32;            // bitmap words per row
    int* rv = RSMEM ? smem : reinterpret_cast<int*>(gbits) + G.ny * words;   // row maxima [ny]
    int* rc = rv + G.ny;                // and their first columns
    int* gv = RSMEM ? rc + G.ny : smem; // group maxima [ngroups]
    int* gi = gv + ngroups;             // and their flat cell index
    int* acc = gi + ngroups;            // acceptances [3][ACC_CHUNK]
    int* sv = split ? acc + 3 * ACC_CHUNK : rv;   // segment maxima [ny * nseg]
    int* sc = split ? sv + nsegs : rc;
    unsigned* bits = BSMEM ? reinterpret_cast<unsigned*>(acc + 3 * ACC_CHUNK + 2 * nsegs)
                           : gbits;
    __shared__ int s_budget, s_r, s_c, s_v, s_wcount[32], s_wpre[32], s_total, s_rescans;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool fill = x != nullptr;

    // the budget: given (the chain alone), else the free slots of val
    if (tid == 0) {
        s_budget = budget_ptr != nullptr ? *budget_ptr : (replacing ? 0 : n);
        s_rescans = 0;
    }
    __syncthreads();
    if (budget_ptr == nullptr && replacing) {
        int cnt = 0;
        for (int base = 0; base < n; base += B_NT) {
            const int i = base + tid;
            cnt += __popc(__ballot_sync(FULL, i < n && val[i] < 0));
        }
        if (lane == 0) atomicAdd(&s_budget, cnt);
        __syncthreads();
    }
    const int budget = min(s_budget, max_out);

    if (budget > 0) {
#pragma unroll 8
        for (int i = tid; i < nsegs; i += B_NT) {
            sv[i] = seg_v_in[i];
            sc[i] = seg_c_in[i];
        }
        for (int i = tid; i < G.ny; i += B_NT) {
            rv[i] = row_v_in[i];
            rc[i] = row_c_in[i];
        }
        for (int i = tid; i < G.ny * words; i += B_NT) bits[i] = 0u;
        if constexpr (!RSMEM) __threadfence_block();
        __syncthreads();
        for (int g = warp; g < ngroups; g += B_NT / 32) {
            const int row = 32 * g + lane;
            int v = INT_MIN, idx = INT_MAX;
            if (row < G.ny) {
                v = rv[row];
                idx = row * G.nx + rc[row];
            }
            warp_argmax(v, idx);
            if (lane == 0) {
                gv[g] = v;
                gi[g] = idx;
            }
        }
        if constexpr (!BSMEM) __threadfence_block();
        __syncthreads();
    }

    // The chain. Per acceptance: warp 0 finds the argmax (B1); one warp per
    // row of the box sets the row's box bits, rescans each touched segment
    // whose maximum lay in the box and, if the row's maximum lay there,
    // recomputes it from the segment maxima (B2); one warp per touched
    // group of 32 rows recomputes the group's maximum if it lay in the box
    // (B3).
    int nacc = 0, rescans = 0;        // rescans: this warp's
    while (nacc < budget) {
        if (warp == 0) {
            int v = INT_MIN, idx = INT_MAX;
            for (int g = lane; g < ngroups; g += 32) {
                if (gv[g] > v || (gv[g] == v && gi[g] < idx)) {
                    v = gv[g];
                    idx = gi[g];
                }
            }
            warp_argmax(v, idx);
            if (lane == 0) {
                const int r = idx / G.nx, c = idx - r * G.nx;
                s_r = r;
                s_c = c;
                s_v = v;
                if (v >= min_eig) {
                    const int k = nacc % ACC_CHUNK;
                    acc[k] = r;
                    acc[ACC_CHUNK + k] = c;
                    acc[2 * ACC_CHUNK + k] = v;
                }
            }
        }
        __syncthreads();                                                // B1
        const int r = s_r, c = s_c;
        if (s_v < min_eig) break;               // pool dry (block-uniform)
        ++nacc;
        const int ra = max(r - dg, 0), rb = min(r + dg, G.ny - 1);
        const int ca = max(c - dg, 0), cb = min(c + dg, G.nx - 1);
        for (int rr = ra + warp; rr <= rb; rr += B_NT / 32) {
            unsigned* brow = bits + rr * words;
            for (int w = ca / 32 + lane; w <= cb / 32; w += 32) {
                const unsigned m = span_bits(max(ca, 32 * w), min(cb, 32 * w + 31), w);
                if constexpr (BSMEM) brow[w] |= m;
                else atomicOr(brow + w, m);
            }
            if constexpr (!BSMEM) __threadfence_block();
            __syncwarp();
            const int* lrow = lat + (size_t)rr * G.stride;
            for (int s = ca / seg; s <= cb / seg; ++s) {
                const int e = rr * G.nseg + s;
                if (sv[e] > 0 && sc[e] >= ca && sc[e] <= cb) {
                    ++rescans;
                    int bv = INT_MIN, bc = INT_MAX;
                    // 32 columns a step, lane = column % 32. The segment's
                    // bitmap words, up to 32 a round, come one per lane and
                    // go round by shuffle; every load of a round (words and
                    // cells) is issued before any is used, so a rescan
                    // waits for one round trip, not one per step.
                    const int w_end = (s + 1) * (seg / 32);
                    for (int w0 = s * (seg / 32); w0 < w_end; w0 += 32) {
                        unsigned mine = 0u;
                        if (w0 + lane < w_end) {
                            if constexpr (BSMEM) mine = brow[w0 + lane];
                            else mine = __ldcg(brow + w0 + lane);
                        }
                        const int kn = SEG > 0 && SEG < 1024 ? SEG / 32 : min(32, w_end - w0);
#pragma unroll
                        for (int k = 0; k < kn; ++k) {
                            const int cc = 32 * (w0 + k) + lane;
                            const int v = __ldg(lrow + cc);
                            const unsigned word = __shfl_sync(FULL, mine, k);
                            const int cell = (word >> lane) & 1u ? 0 : v;
                            if (cell > bv) {        // ascending cc: first occurrence
                                bv = cell;
                                bc = cc;
                            }
                        }
                    }
                    warp_argmax(bv, bc);
                    if (lane == 0) {
                        sv[e] = bv;
                        sc[e] = bc;
                    }
                    __syncwarp();
                }
            }
            if (rv[rr] > 0 && rc[rr] >= ca && rc[rr] <= cb) {
                int bv = INT_MIN, bc = INT_MAX;
                for (int s = lane; s < G.nseg; s += 32) {
                    const int e = rr * G.nseg + s;
                    if (sv[e] > bv) {               // ascending s: first occurrence
                        bv = sv[e];
                        bc = sc[e];
                    }
                }
                warp_argmax(bv, bc);
                if (lane == 0) {
                    rv[rr] = bv;
                    rc[rr] = bc;
                }
            }
        }
        if constexpr (!RSMEM) __threadfence_block();
        __syncthreads();                                                // B2
        for (int g = ra / 32 + warp; g <= rb / 32; g += B_NT / 32) {
            const int gr = gi[g] / G.nx, gc = gi[g] - gr * G.nx;
            if (gv[g] > 0 && gr >= ra && gr <= rb && gc >= ca && gc <= cb) {
                const int row = 32 * g + lane;
                int bv = INT_MIN, bi = INT_MAX;
                if (row < G.ny) {
                    bv = rv[row];
                    bi = row * G.nx + rc[row];
                }
                warp_argmax(bv, bi);
                if (lane == 0) {
                    gv[g] = bv;
                    gi[g] = bi;
                }
            }
        }
        __syncthreads();                                                // B3
        if (warp == 0 && nacc % ACC_CHUNK == 0) {   // a full chunk: write it out
            const int base = nacc - ACC_CHUNK;
            for (int j = lane; j < ACC_CHUNK; j += 32) {
                out_r[base + j] = acc[j];
                out_c[base + j] = acc[ACC_CHUNK + j];
                out_v[base + j] = acc[2 * ACC_CHUNK + j];
            }
        }
    }
    if (warp == 0) {
        const int base = nacc - nacc % ACC_CHUNK;
        for (int j = lane; j < nacc % ACC_CHUNK; j += 32) {
            out_r[base + j] = acc[j];
            out_c[base + j] = acc[ACC_CHUNK + j];
            out_v[base + j] = acc[2 * ACC_CHUNK + j];
        }
    }
    if (counters != nullptr && replacing && lane == 0 && rescans > 0)
        atomicAdd(&s_rescans, rescans);
    __syncthreads();

    for (int i = nacc + tid; i < max_out; i += B_NT) {
        out_r[i] = 0;
        out_c[i] = 0;
        out_v[i] = 0;
    }
    if (tid == 0) {
        *n_acc_out = nacc;
        if (replacing) {
            pft_count(counters, PFT_K4_ACCEPTS, 0, (unsigned long long)nacc);
            pft_count(counters, PFT_K4_RESCANS, 0, (unsigned long long)s_rescans);
        }
    }
    if (!fill) return;

    // slot fill: block-wide exclusive scan of the free mask, chunk by chunk
    int carry = 0;
    for (int base = 0; base < n; base += B_NT) {
        const int i = base + tid;
        const bool in = i < n;
        const int v = in ? val[i] : 0;
        const bool fr = in && (!replacing || v < 0);
        const unsigned b = __ballot_sync(FULL, fr);
        if (lane == 0) s_wcount[warp] = __popc(b);
        __syncthreads();
        if (warp == 0) {
            const int own = s_wcount[lane];
            int t = own;
            for (int off = 1; off < 32; off <<= 1) {
                const int u = __shfl_up_sync(FULL, t, off);
                if (lane >= off) t += u;
            }
            s_wpre[lane] = t - own;
            if (lane == 31) s_total = t;
        }
        __syncthreads();
        const int rank = carry + s_wpre[warp] + __popc(b & ((1u << lane) - 1u));
        if (in) {
            if (fr) {
                const bool f = rank < nacc;
                x_out[i] = f ? (float)(borderx + out_c[rank] * step) : -1.0f;
                y_out[i] = f ? (float)(bordery + out_r[rank] * step) : -1.0f;
                val_out[i] = f ? out_v[rank] : KLT_NOT_FOUND;
                filled[i] = f;
            } else {
                x_out[i] = x[i];
                y_out[i] = y[i];
                val_out[i] = v;
                filled[i] = false;
            }
        }
        carry += s_total;
        __syncthreads();
    }
}

}  // namespace

// Stage A. eig: [nrows, ncols] int32; fx, fy, fval: the feature slots [n]
// (read only when radius >= 0: kept slots are val >= 0). lat: [ny, stride]
// int32 with stride a multiple of seg; seg_v, seg_c: [ny, stride / seg];
// row_v, row_c: [ny]. mask: null, or ceil(ny / A_WARPS) * A_WARPS * stride
// bytes of device memory for the pre-mask where A_WARPS * stride bytes
// exceed PFT_LATTICE_SMEM (ops/cuda_select.LATTICE_SMEM_BYTES; lattices
// wider than 40,960 columns).
#define PFT_LATTICE_SMEM (160 * 1024)
extern "C" int pft_candidate_lattice(const int* eig, int nrows, int ncols,
                                     const float* fx, const float* fy, const int* fval,
                                     int n, int radius, int borderx, int bordery,
                                     int step, int ny, int nx, int min_eig, int seg,
                                     int stride, unsigned char* mask, int* lat, int* seg_v,
                                     int* seg_c, int* row_v, int* row_c, void* stream)
{
    if (ny <= 0 || nx <= 0 || step <= 0 || seg <= 0 || seg % 32 != 0 ||
        stride % seg != 0 || stride < nx || n < 0 || borderx < 0 || bordery < 0 ||
        borderx + (nx - 1) * step >= ncols || bordery + (ny - 1) * step >= nrows)
        return PFT_INVALID_ARGUMENT;
    const Lattice G{ny, nx, stride, seg, stride / seg};
    const dim3 grid(pft_ceil_div(ny, A_WARPS));
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = (size_t)A_WARPS * stride;
    if (smem <= PFT_LATTICE_SMEM) {
        pft_allow_smem(lattice_kernel<true>, smem);
        lattice_kernel<true><<<grid, A_NT, smem, s>>>(
            eig, nrows, ncols, fx, fy, fval, n, radius, borderx, bordery, step, min_eig,
            seg, G, nullptr, lat, seg_v, seg_c, row_v, row_c);
    } else {
        if (mask == nullptr) return PFT_INVALID_ARGUMENT;
        lattice_kernel<false><<<grid, A_NT, 0, s>>>(
            eig, nrows, ncols, fx, fy, fval, n, radius, borderx, bordery, step, min_eig,
            seg, G, mask, lat, seg_v, seg_c, row_v, row_c);
    }
    return (int)cudaGetLastError();
}

// Shared memory stage B needs for a lattice (bytes) without the box bitmap:
// row and group maxima, the acceptance buffer and, with more than one
// segment per row, the segment maxima. ops/cuda_select.segment_width lays
// the lattice out with the same count; a lattice that does not fit is
// refused here.
static long long chain_smem(int ny, int nseg)
{
    return 4LL * ((nseg > 1 ? 2LL * ny * nseg : 0LL) + 2LL * ny +
                  2LL * pft_ceil_div(ny, 32) + 3LL * ACC_CHUNK);
}

static long long bitmap_bytes(int ny, int stride) { return 4LL * ny * (stride / 32); }

// Stage B. lat and the maxima from stage A; bits: a [ny, stride / 32 + 2]
// uint32 scratch in device memory, always given: the bitmap where it does
// not fit in shared memory, and after it the row maxima where those do not
// fit either. budget: one int32 in device
// memory, or null to count the free slots of val. out_r, out_c, out_v:
// [max_out] acceptances in order (lanes >= n_acc zero), n_acc: one int32.
// x, y, val [n]: the slots to fill (null: the chain alone), x_out, y_out,
// val_out, filled [n]. counters: the device counters (common.cuh), or null.
extern "C" int pft_greedy_chain(const int* lat, int ny, int nx, int seg, int stride,
                                const int* seg_v, const int* seg_c, const int* row_v,
                                const int* row_c, unsigned* bits, const int* budget,
                                int min_eig, int dg, int max_out, int* out_r, int* out_c,
                                int* out_v, int* n_acc, const float* x, const float* y,
                                const int* val, int n, int replacing, int borderx,
                                int bordery, int step, float* x_out, float* y_out,
                                int* val_out, bool* filled, unsigned long long* counters,
                                void* stream)
{
    if (ny <= 0 || nx <= 0 || dg < 0 || max_out < 0 || n < 0 || seg < 32 ||
        (seg & (seg - 1)) != 0 || stride % seg != 0 || stride < nx || bits == nullptr ||
        (budget == nullptr && x == nullptr))
        return PFT_INVALID_ARGUMENT;
    const Lattice G{ny, nx, stride, seg, stride / seg};
    const long long limit = 227 * 1024;
    long long smem = chain_smem(ny, G.nseg);
    cudaStream_t s = (cudaStream_t)stream;
    if (smem > limit) {
        // one segment per row and more rows than fit: the rows (and the
        // bitmap) in device memory, only the groups and the acceptance
        // buffer in shared memory
        if (G.nseg > 1) return PFT_INVALID_ARGUMENT;
        smem = 4LL * (2LL * pft_ceil_div(ny, 32) + 3LL * ACC_CHUNK);
        pft_allow_smem(chain_kernel<0, false, false>, (size_t)smem);
        chain_kernel<0, false, false><<<1, B_NT, (size_t)smem, s>>>(
            lat, G, seg_v, seg_c, row_v, row_c, bits, budget, min_eig, dg, max_out, out_r,
            out_c, out_v, n_acc, x, y, val, n, replacing, borderx, bordery, step, x_out,
            y_out, val_out, filled, counters);
        return (int)cudaGetLastError();
    }
    const bool bsmem = smem + bitmap_bytes(ny, stride) <= limit;
    if (bsmem) smem += bitmap_bytes(ny, stride);
#define PFT_CHAIN_LAUNCH(SEG, BS)                                                        \
    pft_allow_smem(chain_kernel<SEG, BS>, (size_t)smem);                                 \
    chain_kernel<SEG, BS><<<1, B_NT, (size_t)smem, s>>>(                                 \
        lat, G, seg_v, seg_c, row_v, row_c, bits, budget, min_eig, dg, max_out, out_r,   \
        out_c, out_v, n_acc, x, y, val, n, replacing, borderx, bordery, step, x_out,     \
        y_out, val_out, filled, counters);                                               \
    return (int)cudaGetLastError();
#define PFT_CHAIN(SEG)                                                                   \
    case SEG:                                                                            \
        if (bsmem) {                                                                     \
            PFT_CHAIN_LAUNCH(SEG, true)                                                  \
        } else {                                                                         \
            PFT_CHAIN_LAUNCH(SEG, false)                                                 \
        }
    switch (seg) {
        PFT_CHAIN(32)
        PFT_CHAIN(64)
        PFT_CHAIN(128)
        PFT_CHAIN(256)
        PFT_CHAIN(512)
        PFT_CHAIN(1024)
        default:                        // wider: the width read at run time
            if (bsmem) {
                PFT_CHAIN_LAUNCH(0, true)
            } else {
                PFT_CHAIN_LAUNCH(0, false)
            }
    }
#undef PFT_CHAIN
#undef PFT_CHAIN_LAUNCH
}
