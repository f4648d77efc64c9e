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

#include "probe_parts.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

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
