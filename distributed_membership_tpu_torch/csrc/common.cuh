// Shared helpers for the ring-step kernels.
//
// Packed entries are u32 `hb * N + id + 1` (0 = empty).  The PyTorch
// side stores them in int32 tensors; the kernels read the same bytes as
// unsigned, so order and `%` follow u32 arithmetic exactly as in the JAX
// package (including `0 - 1` wrapping to 2^32 - 1 before the modulo).
#pragma once

#include <cuda_runtime.h>

#define DM_FULL_MASK 0xffffffffu

// (packed - 1) mod n in u32 arithmetic.
__device__ __forceinline__ unsigned dm_member(unsigned packed, unsigned n) {
    return (packed - 1u) % n;
}

// i32 subtraction with two's-complement wrap (the JAX `t - view_ts`).
__device__ __forceinline__ int dm_sub_wrap(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int dm_warp_sum(int x) {
    return __reduce_add_sync(DM_FULL_MASK, x);
}

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
