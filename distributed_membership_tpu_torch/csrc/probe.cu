// K3: the probe-window read plus the per-row aggregate partials.
//
// Replaces the Pallas kernel `probe_window_fused` of the JAX package's
// ops/fused_probe.py: the P-slot window of each row at `ptr` (cyclic),
// validated (occupied, not the node itself, observer active) into probe
// ids; optionally the per-row staleness and suspicion bucket counts
// (8 buckets of 8 ticks, observability/timeline.py) and the FastAgg
// partials over the removal plane (removal count and per-fail-id
// detection counts).
//
// Bound: bytes.  The TPU kernel rolled the whole view row in VMEM and
// wrote a 128-lane id block; this kernel reads only the P window
// columns of the view (plus the view and view_ts rows when the
// histogram is wanted, and the rm_ids row for the aggregates) and
// writes exactly P ids per row.  One warp owns one row: window lanes
// read one contiguous run of slots, full-row passes are coalesced
// strided loops, and the counts are warp reductions (the eight histogram
// buckets packed two to a register).  Counts are integers, so any
// reduction order gives the same result.

#include "common.cuh"

// Up to eight failed ids, passed by value.  Declared outside the
// anonymous namespace: a type with internal linkage in its signature would
// give the exported entry point internal linkage too.
struct FailIds {
    int ids[8];
};

namespace {

constexpr int kRowsPerBlock = 8;
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
// entries (the wrapper checks), so a field never carries into the next,
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

__global__ void probe_kernel(int t, int ptr, unsigned n, int s, int p_cnt,
                             int tfail, long long row0, int rows,
                             const unsigned* __restrict__ view,
                             const int* __restrict__ view_ts,
                             const unsigned char* __restrict__ act,
                             const int* __restrict__ rm_ids,
                             int n_fail, FailIds fail,
                             int* __restrict__ ids,
                             int* __restrict__ stale_rows,
                             int* __restrict__ susp_rows,
                             int* __restrict__ rm_cnt,
                             int* __restrict__ det) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
    if (row >= rows) return;   // whole warp leaves together
    const long long base = static_cast<long long>(row) * s;
    const unsigned node = static_cast<unsigned>(row0 + row);
    const bool a = act[row] != 0;

    for (int k = lane; k < p_cnt; k += 32) {
        const unsigned w = view[base + (ptr + k) % s];
        const unsigned id = dm_member(w, n);
        const bool valid = w > 0u && id != node && a;
        ids[static_cast<long long>(row) * p_cnt + k] =
            valid ? static_cast<int>(id + 1u) : 0;
    }

    if (view_ts != nullptr) {
        Buckets stale, susp;
        for (int c = lane; c < s; c += 32) {
            if (view[base + c] == 0u) continue;
            const int d = dm_sub_wrap(t, view_ts[base + c]);
            stale.add(bucket_of(d));
            if (d >= tfail) susp.add(bucket_of(dm_sub_wrap(d, tfail)));
        }
        stale.store(lane, stale_rows + static_cast<long long>(row) * kBuckets);
        susp.store(lane, susp_rows + static_cast<long long>(row) * kBuckets);
    }

    if (rm_ids != nullptr) {
        int cnt = 0;
        int hits[kMaxFail] = {0};
        for (int c = lane; c < s; c += 32) {
            const int r = rm_ids[base + c];
            cnt += r >= 0;
#pragma unroll
            for (int f = 0; f < kMaxFail; ++f)
                hits[f] += f < n_fail && r == fail.ids[f];
        }
        cnt = dm_warp_sum(cnt);
        if (lane == 0) rm_cnt[row] = cnt;
#pragma unroll
        for (int f = 0; f < kMaxFail; ++f) {
            if (f < n_fail) {
                const int h = dm_warp_sum(hits[f]);
                if (lane == 0) det[static_cast<long long>(f) * rows + row] = h;
            }
        }
    }
}

}  // namespace

// view_ts, stale_rows and susp_rows are all null or all set (histogram);
// rm_ids, rm_cnt and det likewise (aggregates, det is [n_fail, rows]).
// ids is [rows, p_cnt] int32.  Returns cudaGetLastError().
extern "C" int dm_probe(int t, int ptr, unsigned n, int s, int p_cnt,
                        int tfail, long long row0, int rows,
                        const unsigned* view, const int* view_ts,
                        const unsigned char* act, const int* rm_ids,
                        int n_fail, FailIds fail, int* ids, int* stale_rows,
                        int* susp_rows, int* rm_cnt, int* det,
                        void* stream) {
    if (n_fail < 0 || n_fail > kMaxFail)
        return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 0) {
        probe_kernel<<<blocks, kRowsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
            t, ptr, n, s, p_cnt, tfail, row0, rows, view, view_ts, act,
            rm_ids, n_fail, fail, ids, stale_rows, susp_rows, rm_cnt, det);
    }
    return dm_launch_status();
}
