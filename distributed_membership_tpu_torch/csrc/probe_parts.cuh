// Pieces shared by the probe-window kernels K3 (probe.cu, the [N, S]
// layout) and K7 (probe_folded.cu, the folded layout): the failed-id
// argument, the probe id of a window slot, and the staleness /
// suspicion histogram counters.
#pragma once

#include <cstdint>

#include "common.cuh"

// Up to eight failed ids, passed by value.  Declared outside the
// anonymous namespace: a type with internal linkage in its signature would
// give the exported entry point internal linkage too.
struct FailIds {
    int ids[8];
};

namespace {

constexpr int kMaxFail = 8;
constexpr int kBuckets = 8;        // h_staleness / h_suspicion buckets
constexpr int kBucketShift = 3;    // bucket width 8 ticks

__device__ __forceinline__ int bucket_of(int v) {
    int b = v >> kBucketShift;     // arithmetic shift: floor division
    b = b > kBuckets - 1 ? kBuckets - 1 : b;
    return b < 0 ? 0 : b;
}

// Eight per-row bucket counts in four registers, two 16-bit fields per
// word (word q holds buckets 2q and 2q + 1).  A row holds fewer than 2^16
// entries (the wrappers check), so a field never carries into the next,
// and one warp reduction sums two buckets.
struct Buckets {
    unsigned w0 = 0u, w1 = 0u, w2 = 0u, w3 = 0u;

    __device__ __forceinline__ void add(int b) {
        const unsigned inc = 1u << ((b & 1) << 4);
        const int q = b >> 1;
        w0 += q == 0 ? inc : 0u;
        w1 += q == 1 ? inc : 0u;
        w2 += q == 2 ? inc : 0u;
        w3 += q == 3 ? inc : 0u;
    }

    // Adds eight counts below 16 packed as nibbles (bucket b in bits
    // 4b..4b+3): the even buckets' nibbles become bytes 0-3 of `lo`, the
    // odd ones' of `hi`, and two byte permutes spread them to the fields.
    __device__ __forceinline__ void add_nibbles(unsigned x) {
        const unsigned lo = x & 0x0f0f0f0fu, hi = (x >> 4) & 0x0f0f0f0fu;
        const unsigned e01 = __byte_perm(lo, hi, 0x5410);   // b0 b2 b1 b3
        const unsigned e23 = __byte_perm(lo, hi, 0x7632);   // b4 b6 b5 b7
        w0 += e01 & 0x00ff00ffu;
        w1 += (e01 >> 8) & 0x00ff00ffu;
        w2 += e23 & 0x00ff00ffu;
        w3 += (e23 >> 8) & 0x00ff00ffu;
    }

    // Warp-sums the fields; lane 0 writes the row's eight counts.
    __device__ __forceinline__ void store(int lane, int* __restrict__ out) {
        const unsigned s0 = __reduce_add_sync(DM_FULL_MASK, w0);
        const unsigned s1 = __reduce_add_sync(DM_FULL_MASK, w1);
        const unsigned s2 = __reduce_add_sync(DM_FULL_MASK, w2);
        const unsigned s3 = __reduce_add_sync(DM_FULL_MASK, w3);
        if (lane == 0) {
            const unsigned sums[4] = {s0, s1, s2, s3};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                out[2 * q] = static_cast<int>(sums[q] & 0xffffu);
                out[2 * q + 1] = static_cast<int>(sums[q] >> 16);
            }
        }
    }
};

inline bool aligned16(const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// A window slot's probe id + 1: occupied, not the node itself, and the
// node active; 0 otherwise.  The member id by the Magic remainder.
__device__ __forceinline__ int probe_id(unsigned w, const Magic& n,
                                        unsigned node, bool on) {
    const unsigned id = n.mod(w - 1u);
    return w > 0u && id != node && on ? static_cast<int>(id + 1u) : 0;
}

// The staleness and suspicion buckets of W entries (view words w, stamps
// ts) as nibble counts, bucket b in bits 4b..4b+3 (W < 16).
template <int W>
__device__ __forceinline__ void hist_nibbles(const unsigned (&w)[W],
                                             const int (&ts)[W], int t,
                                             int tfail, unsigned& ns,
                                             unsigned& nu) {
    ns = nu = 0u;
#pragma unroll
    for (int e = 0; e < W; ++e) {
        if (w[e] == 0u) continue;
        const int d = dm_sub_wrap(t, ts[e]);
        ns += 1u << (bucket_of(d) << 2);
        if (d >= tfail) nu += 1u << (bucket_of(dm_sub_wrap(d, tfail)) << 2);
    }
}

}  // namespace
