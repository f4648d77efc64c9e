// Philox4x32-10 draws: the bits of jax's rbg and unsafe_rbg keys.
//
// Replaces no Pallas kernel.  Under PRNG_IMPL rbg or unsafe_rbg the JAX
// package draws its random bits through XLA's rng_bit_generator
// (algorithm DEFAULT; its root key is made at
// distributed_membership_tpu/runtime/failures.py:114), which XLA's CPU
// backend compiles to Philox4x32-10.  This kernel computes that stream:
// for a key of four u32 words w, block j hashes the 128-bit counter
// (w1:w0:w3:w2) + j under the Philox key (w0, w1), and its four output
// words are elements 4j .. 4j+3 of the flat draw (ops/rbg.py states the
// layout and holds the plain version).  It is no cuRAND call:
// torch.rand is Philox4x32-10 too, but with cuRAND's subsequence and
// offset layout, so it gives other bits.
//
// Three forms, one thread per Philox block (the indexed form: per
// element):
//   0  float32 uniforms on [0, 1) of `numel` flat elements from block
//      `block0` on, written as 16-byte stores (the drop, thinning and
//      control-plane coins of the ring steps);
//   1  the same elements as raw u32 bits, each zero-extended into an
//      int64 (the plain version's layout, so randint's int64 arithmetic
//      takes them as they are), staged in shared memory so that each
//      store instruction of a warp writes 512 contiguous bytes;
//   2  float32 uniforms at `numel` int64 element indices `idx`.
//
// Bound: bytes.  The function writes 4 bytes an element (8 in form 1;
// the indexed form also reads an 8-byte index) and reads nothing else;
// each block
// costs 10 rounds of two 32-bit wide multiplies (__umulhi for the high
// words) and four XORs, expected to hide under the writes.  The design
// keeps the whole round loop in registers and gives each thread one
// block, so a warp writes 512 contiguous bytes.

#include <cstdint>

#include "common.cuh"

namespace {

struct PhiloxKey {
    unsigned w0, w1, w2, w3;
};

__device__ __forceinline__ uint4 philox_block(const PhiloxKey k,
                                              unsigned long long blk) {
    const unsigned long long base =
        (static_cast<unsigned long long>(k.w3) << 32) | k.w2;
    const unsigned long long lo = base + blk;
    const unsigned long long hi =
        ((static_cast<unsigned long long>(k.w1) << 32) | k.w0)
        + (lo < base ? 1ULL : 0ULL);                  // the low half's carry
    unsigned c0 = static_cast<unsigned>(lo);
    unsigned c1 = static_cast<unsigned>(lo >> 32);
    unsigned c2 = static_cast<unsigned>(hi);
    unsigned c3 = static_cast<unsigned>(hi >> 32);
    unsigned k0 = k.w0, k1 = k.w1;
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const unsigned hi0 = __umulhi(0xD2511F53u, c0);
        const unsigned lo0 = 0xD2511F53u * c0;
        const unsigned hi1 = __umulhi(0xCD9E8D57u, c2);
        const unsigned lo1 = 0xCD9E8D57u * c2;
        c0 = hi1 ^ c1 ^ k0;
        c1 = lo1;
        c2 = hi0 ^ c3 ^ k1;
        c3 = lo0;
        k0 += 0x9E3779B9u;
        k1 += 0xBB67AE85u;
    }
    return make_uint4(c0, c1, c2, c3);
}

// jax.random.uniform's float: the top 23 bits as the mantissa of a float
// in [1, 2), minus 1 (exact).
__device__ __forceinline__ float unit(unsigned b) {
    return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ unsigned word(const uint4 w, unsigned j) {
    return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
philox_uniform(const PhiloxKey k, unsigned long long block0, long long numel,
               float* __restrict__ out) {
    const long long b = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    const long long e = 4 * b;
    if (e >= numel) return;
    const uint4 w = philox_block(k, block0 + static_cast<unsigned long long>(b));
    if (e + 4 <= numel) {
        reinterpret_cast<float4*>(out)[b] =
            make_float4(unit(w.x), unit(w.y), unit(w.z), unit(w.w));
        return;
    }
    for (long long j = 0; e + j < numel; ++j)     // the ragged last block
        out[e + j] = unit(word(w, static_cast<unsigned>(j)));
}

// A thread's four int64 words are 32 bytes, twice the widest store; the
// block stages its 8 KB in shared memory and writes them back in order.
__global__ void __launch_bounds__(kThreads)
philox_bits(const PhiloxKey k, unsigned long long block0, long long numel,
            unsigned long long* __restrict__ out) {
    __shared__ ulonglong2 stage[2 * kThreads];
    const long long first = 4LL * kThreads * blockIdx.x;   // block's elements
    const long long b = first / 4 + threadIdx.x;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (4 * b < numel)
        w = philox_block(k, block0 + static_cast<unsigned long long>(b));
    stage[2 * threadIdx.x] = make_ulonglong2(w.x, w.y);
    stage[2 * threadIdx.x + 1] = make_ulonglong2(w.z, w.w);
    __syncthreads();
    const long long left = numel - first;
    if (left >= 4 * kThreads) {
        ulonglong2* o = reinterpret_cast<ulonglong2*>(out + first);
        for (int q = threadIdx.x; q < 2 * kThreads; q += kThreads)
            o[q] = stage[q];
        return;
    }
    const unsigned long long* words =
        reinterpret_cast<const unsigned long long*>(stage);
    for (long long q = threadIdx.x; q < left; q += kThreads)  // ragged end
        out[first + q] = words[q];
}

__global__ void __launch_bounds__(kThreads)
philox_at(const PhiloxKey k, const long long* __restrict__ idx,
          long long numel, float* __restrict__ out) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (i >= numel) return;
    const unsigned long long e = static_cast<unsigned long long>(idx[i]);
    out[i] = unit(word(philox_block(k, e >> 2), static_cast<unsigned>(e & 3)));
}

}  // namespace

// form 0: float32 out[numel], form 1: int64 out[numel] holding u32
// (elements 4 * block0 on), form 2: float32 out[numel] at the int64
// element indices idx (each >= 0).  out is 16-byte aligned for forms 0
// and 1.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int dm_philox(int form, unsigned w0, unsigned w1, unsigned w2,
                         unsigned w3, unsigned long long block0,
                         long long numel, const long long* idx, void* out,
                         void* stream) {
    if (form < 0 || form > 2 || numel < 0
        || (numel > 0 && (out == nullptr || (form == 2 && idx == nullptr)))
        || (form != 2
            && reinterpret_cast<std::uintptr_t>(out) % 16 != 0))
        return static_cast<int>(cudaErrorInvalidValue);
    if (numel == 0) return dm_launch_status();
    const long long items = form == 2 ? numel : (numel + 3) / 4;
    const long long grid = (items + kThreads - 1) / kThreads;
    if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const PhiloxKey k{w0, w1, w2, w3};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 blocks(static_cast<unsigned>(grid));
    if (form == 0)
        philox_uniform<<<blocks, kThreads, 0, st>>>(
            k, block0, numel, static_cast<float*>(out));
    else if (form == 1)
        philox_bits<<<blocks, kThreads, 0, st>>>(
            k, block0, numel, static_cast<unsigned long long*>(out));
    else
        philox_at<<<blocks, kThreads, 0, st>>>(k, idx, numel,
                                               static_cast<float*>(out));
    return dm_launch_status();
}
