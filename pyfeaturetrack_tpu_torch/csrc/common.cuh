// Shared helpers for the pyfeaturetrack_tpu_torch kernels.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success) so the ctypes wrapper can
// raise on a refused launch. The library is built with -fmad=false: each
// product and sum rounds separately, exactly as the plain PyTorch
// versions do, which is what lets K1 and K3 agree with them bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#define PFT_MAX_TAPS 71   // ops/kernels.MAX_KERNEL_WIDTH
#define PFT_INVALID_ARGUMENT 9999

// Flipped 1-D taps (krev = k[::-1]) and their radius, passed by value.
struct PftTaps {
    float k[PFT_MAX_TAPS];
    int r;
};

static inline int pft_load_taps(PftTaps* t, const float* krev, int n) {
    if (n < 1 || n > PFT_MAX_TAPS || (n & 1) == 0) return 0;
    for (int i = 0; i < n; ++i) t->k[i] = krev[i];
    for (int i = n; i < PFT_MAX_TAPS; ++i) t->k[i] = 0.0f;
    t->r = n / 2;
    return 1;
}

// Raise the dynamic shared-memory cap when a launch needs more than the
// default 48 KB (H100: up to 227 KB per block).
template <typename K>
static inline void pft_allow_smem(K kernel, size_t bytes) {
    if (bytes > 48 * 1024)
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
}

// Device counters (utils/profiling.DEVICE_COUNTERS): one int64 buffer per
// device, [PFT_N_COUNTERS][PFT_COUNTER_SLOTS]; the host sums each row's
// slots. A kernel spreads its adds over the slots (a warp adds to the slot of
// its index), so no one address takes a launch's every atomic. A null buffer
// counts nothing; the counts never feed back into a result.
#define PFT_COUNTER_SLOTS 64
enum PftCounter { PFT_K2_GN_STEPS, PFT_K2_LANE_LEVELS, PFT_K4_ACCEPTS, PFT_K4_RESCANS,
                  PFT_K6_CHECKED, PFT_K6_GN_STEPS, PFT_K6_REJECTIONS, PFT_N_COUNTERS };

static __device__ __forceinline__ void pft_count(unsigned long long* c, PftCounter k,
                                                 int slot, unsigned long long n)
{
    if (c != nullptr && n != 0ull)
        atomicAdd(c + k * PFT_COUNTER_SLOTS + (slot & (PFT_COUNTER_SLOTS - 1)), n);
}

__host__ __device__ static inline int pft_ceil_div(int a, int b)
{
    return (a + b - 1) / b;
}

// Level storage (cfg.image_dtype): float or __nv_bfloat16. A stored value is
// the float32 one rounded to nearest even (__float2bfloat16_rn: XLA's
// convert, torch's .to(torch.bfloat16)); a tap reads it back as float32
// exactly (the bits shifted into the high half), and every sum is float32.
template <typename TS>
inline constexpr bool pft_is_bf16 = std::is_same<TS, __nv_bfloat16>::value;

static __device__ __forceinline__ float pft_tap(const float* p) { return *p; }
static __device__ __forceinline__ float pft_tap(const __nv_bfloat16* p)
{
    return __uint_as_float((unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
}
// The same through the read-only data cache.
static __device__ __forceinline__ float pft_ldg(const float* p) { return __ldg(p); }
static __device__ __forceinline__ float pft_ldg(const __nv_bfloat16* p)
{
    return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
static __device__ __forceinline__ void pft_store(float* p, float v) { *p = v; }
static __device__ __forceinline__ void pft_store(__nv_bfloat16* p, float v)
{
    *p = __float2bfloat16_rn(v);
}
// v as the storage type holds it, as float32.
template <typename TS>
static __device__ __forceinline__ float pft_stored(float v)
{
    if constexpr (pft_is_bf16<TS>)
        return __bfloat162float(__float2bfloat16_rn(v));
    else
        return v;
}

// Phase clocks, for measurement builds only (-DPFT_PHASE_CLOCKS, made by
// phase_clocks.py; the library the package loads compiles them out). A
// kernel marks the end of phase k with PFT_PHASE(t, k, on): the cycles
// since the previous mark (clock64) and a count go to per-file sums, which
// PFT_PHASE_READER's entry copies to the host and clears.
// PFT_PHASE_UNIT(t, k, on, u) also adds them to unit u's own record (a
// kernel's unit of work, e.g. K6's feature; units below PFT_PHASE_UNITS),
// which PFT_PHASE_UNIT_READER's entry copies out ([unit][cycles, marks]
// [phase], 32-bit) and clears. PFT_PHASE_STAMP(k, on, u) writes into unit
// u's slot k (14 or 15, above the phases) the low 32 bits of the global
// nanosecond timer and the SM's id: the last launch's start or end.
#ifdef PFT_PHASE_CLOCKS
#define PFT_PHASE_UNITS 4096
namespace {
__device__ unsigned long long pft_phase_cycles[32];
__device__ unsigned long long pft_phase_counts[32];
__device__ unsigned int pft_phase_unit[PFT_PHASE_UNITS][2][16];
}  // namespace
#define PFT_PHASE_START(t) long long t = clock64()
#define PFT_PHASE_UNIT(t, k, on, u)                                                 \
    do {                                                                            \
        if (on) {                                                                   \
            const long long pft_now_ = clock64();                                   \
            atomicAdd(&pft_phase_cycles[k], (unsigned long long)(pft_now_ - (t)));  \
            atomicAdd(&pft_phase_counts[k], 1ull);                                  \
            if ((u) >= 0 && (u) < PFT_PHASE_UNITS) {                                \
                atomicAdd(&pft_phase_unit[u][0][k], (unsigned int)(pft_now_ - (t)));  \
                atomicAdd(&pft_phase_unit[u][1][k], 1u);                            \
            }                                                                       \
            (t) = pft_now_;                                                         \
        }                                                                           \
    } while (0)
#define PFT_PHASE(t, k, on) PFT_PHASE_UNIT(t, k, on, -1)
#define PFT_PHASE_STAMP(k, on, u)                                                   \
    do {                                                                            \
        if ((on) && (u) >= 0 && (u) < PFT_PHASE_UNITS) {                            \
            unsigned long long pft_ns_;                                             \
            unsigned int pft_sm_;                                                   \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(pft_ns_));             \
            asm volatile("mov.u32 %0, %%smid;" : "=r"(pft_sm_));                    \
            pft_phase_unit[u][0][k] = (unsigned int)pft_ns_;                        \
            pft_phase_unit[u][1][k] = pft_sm_;                                      \
        }                                                                           \
    } while (0)
#define PFT_PHASE_READER(name)                                                      \
    extern "C" int name(unsigned long long* cycles, unsigned long long* counts)     \
    {                                                                               \
        static const unsigned long long zero[32] = {};                              \
        cudaDeviceSynchronize();                                                    \
        cudaMemcpyFromSymbol(cycles, pft_phase_cycles, sizeof(zero));               \
        cudaMemcpyFromSymbol(counts, pft_phase_counts, sizeof(zero));               \
        cudaMemcpyToSymbol(pft_phase_cycles, zero, sizeof(zero));                   \
        cudaMemcpyToSymbol(pft_phase_counts, zero, sizeof(zero));                   \
        return (int)cudaGetLastError();                                             \
    }
#define PFT_PHASE_UNIT_READER(name)                                                 \
    extern "C" int name(unsigned int* units)                                        \
    {                                                                               \
        cudaDeviceSynchronize();                                                    \
        cudaMemcpyFromSymbol(units, pft_phase_unit, sizeof(pft_phase_unit));        \
        void* pft_dev_ = nullptr;                                                   \
        cudaGetSymbolAddress(&pft_dev_, pft_phase_unit);                            \
        cudaMemset(pft_dev_, 0, sizeof(pft_phase_unit));                            \
        return (int)cudaGetLastError();                                             \
    }
#else
#define PFT_PHASE_START(t)
#define PFT_PHASE(t, k, on)
#define PFT_PHASE_UNIT(t, k, on, u)
#define PFT_PHASE_STAMP(k, on, u)
#define PFT_PHASE_READER(name)
#define PFT_PHASE_UNIT_READER(name)
#endif
