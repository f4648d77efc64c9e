// Shared helpers for the ring-step kernels.
//
// Packed entries are u32 `hb * N + id + 1` (0 = empty).  The PyTorch
// side stores them in int32 tensors; the kernels read the same bytes as
// unsigned, so order and `%` follow u32 arithmetic exactly as in the JAX
// package (including `0 - 1` wrapping to 2^32 - 1 before the modulo).
#pragma once

#include <cuda_runtime.h>

#define DM_FULL_MASK 0xffffffffu

// i32 subtraction with two's-complement wrap (the JAX `t - view_ts`).
__device__ __forceinline__ int dm_sub_wrap(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

namespace {

// x mod n without a division: the remainder by direct computation
// (Lemire, Kaser and Kurz, 2019), exact for every 32-bit x, with M =
// 2^64 / n rounded up (0 for n = 1): ((M * x mod 2^64) * n) >> 64, in
// 32-bit halves (one wide multiply).
struct Magic {
    unsigned lo, hi, n;              // M's halves, n
    __device__ __forceinline__ unsigned mod(unsigned x) const {
        const unsigned f_lo = lo * x;                      // M * x mod 2^64
        const unsigned f_hi = __umulhi(lo, x) + hi * x;
        return static_cast<unsigned>(
            (static_cast<unsigned long long>(f_hi) * n
             + __umulhi(f_lo, n)) >> 32);
    }
};

inline Magic magic_of(unsigned n) {
    const unsigned long long m = ~0ULL / n + 1;
    return Magic{static_cast<unsigned>(m), static_cast<unsigned>(m >> 32), n};
}

}  // namespace

// Launch status for the ctypes wrappers: 0 when the launch was accepted.
static inline int dm_launch_status() {
    return static_cast<int>(cudaGetLastError());
}

// The grid of a persistent kernel: as many blocks of `threads` threads
// with `smem` bytes of dynamic shared memory as the card holds at once,
// and at most `blocks` (> 0).  Returns 0, or the cudaError_t of a failed
// query.
template <typename K>
static inline int dm_persistent_grid(K kernel, int threads, int smem,
                                     long long blocks, unsigned* grid) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, threads, smem);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return static_cast<int>(err);
    }
    const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1)
                          * sms;
    *grid = static_cast<unsigned>(blocks < fit ? blocks : fit);
    return 0;
}
