// K7: the probe-window read plus the per-row aggregate partials, on the
// folded layout.
//
// Replaces the Pallas kernel `probe_folded_window_fused` of the JAX
// package's ops/fused_probe.py.  A [rows, 128] plane row holds F = 128/S
// nodes of S slots each.  Entry l of a row is rolled segment-wise so that
// position p of node segment g reads slot (p + ptr) mod S of that
// segment, and yields the probe id + 1 when that entry is occupied, not
// the node itself, and the node is active; the caller keeps the first P
// positions of each segment.  Optionally, per plane row: the staleness
// and suspicion bucket counts of view_ts (8 buckets of 8 ticks), and the
// removal count and per-failed-id detection counts of the rm_ids plane,
// plus a per-entry byte marking removals of any failed id.
//
// Bound: bytes.  It reads view (and view_ts, rm_ids when those partials
// are wanted) and the per-node act byte once, and writes the id plane,
// the det_any bytes and a few counts per row.  One warp owns one plane
// row: each lane loads four consecutive entries with one 16-byte load,
// the row is staged in shared memory so that the segment roll is an
// indexed read, and the counts are warp reductions of integers, so their
// order cannot change them.

#include "probe_parts.cuh"

namespace {

constexpr int kRowsPerBlock = 8;   // one warp per plane row

__global__ void probe_folded_kernel(int t, int ptr, unsigned n, int s_shift,
                                    int tfail, long long row0, int rows,
                                    const unsigned* __restrict__ view,
                                    const int* __restrict__ view_ts,
                                    const unsigned char* __restrict__ act,
                                    const int* __restrict__ rm_ids,
                                    int n_fail, FailIds fail,
                                    unsigned* __restrict__ ids,
                                    int* __restrict__ stale_rows,
                                    int* __restrict__ susp_rows,
                                    int* __restrict__ rm_cnt,
                                    int* __restrict__ det,
                                    unsigned char* __restrict__ det_any) {
    __shared__ unsigned sh_row[kRowsPerBlock][128];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int row = blockIdx.x * kRowsPerBlock + warp;
    if (row >= rows) return;   // whole warp leaves together
    const long long off = static_cast<long long>(row) * 128 + lane * 4;
    const int smask = (1 << s_shift) - 1;

    const uint4 v4 = *reinterpret_cast<const uint4*>(view + off);
    const unsigned vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) sh_row[warp][lane * 4 + k] = vv[k];
    __syncwarp();

    unsigned out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int l = lane * 4 + k;
        const int seg = l >> s_shift;
        const unsigned w = sh_row[warp][(seg << s_shift)
                                        | ((l + ptr) & smask)];
        const long long local = (static_cast<long long>(row)
                                 << (7 - s_shift)) + seg;
        const unsigned node = static_cast<unsigned>(row0 + local);
        const unsigned id = dm_member(w, n);
        const bool valid = w > 0u && id != node && act[local] != 0;
        out[k] = valid ? id + 1u : 0u;
    }
    *reinterpret_cast<uint4*>(ids + off) = make_uint4(out[0], out[1], out[2],
                                                      out[3]);

    if (view_ts != nullptr) {
        const int4 t4 = *reinterpret_cast<const int4*>(view_ts + off);
        const int tt[4] = {t4.x, t4.y, t4.z, t4.w};
        Buckets stale, susp;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (vv[k] == 0u) continue;
            const int d = dm_sub_wrap(t, tt[k]);
            stale.add(bucket_of(d));
            if (d >= tfail) susp.add(bucket_of(dm_sub_wrap(d, tfail)));
        }
        stale.store(lane, stale_rows + static_cast<long long>(row) * kBuckets);
        susp.store(lane, susp_rows + static_cast<long long>(row) * kBuckets);
    }

    if (rm_ids != nullptr) {
        const int4 r4 = *reinterpret_cast<const int4*>(rm_ids + off);
        const int rr[4] = {r4.x, r4.y, r4.z, r4.w};
        int cnt = 0;
        int hits[kMaxFail] = {0};
        unsigned char any[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            cnt += rr[k] >= 0;
            bool a = false;
#pragma unroll
            for (int f = 0; f < kMaxFail; ++f) {
                const bool hit = f < n_fail && rr[k] == fail.ids[f];
                hits[f] += hit;
                a = a || hit;
            }
            any[k] = a;
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
        if (det_any != nullptr)
            *reinterpret_cast<uchar4*>(det_any + off) =
                make_uchar4(any[0], any[1], any[2], any[3]);
    }
}

}  // namespace

// view, view_ts, rm_ids, ids and det_any are contiguous, 16-byte aligned
// [rows, 128]; act is [rows * 128 / S] bytes; S divides 128 and
// 0 <= ptr < S.  view_ts, stale_rows and susp_rows ([rows, 8]) are all
// null or all set; rm_ids, rm_cnt ([rows]) and det ([n_fail, rows])
// likewise, with det_any set iff n_fail > 0.  Returns cudaGetLastError().
extern "C" int dm_probe_folded(int t, int ptr, unsigned n, int s, int tfail,
                               long long row0, int rows,
                               const unsigned* view, const int* view_ts,
                               const unsigned char* act, const int* rm_ids,
                               int n_fail, FailIds fail, unsigned* ids,
                               int* stale_rows, int* susp_rows, int* rm_cnt,
                               int* det, unsigned char* det_any,
                               void* stream) {
    if (n_fail < 0 || n_fail > kMaxFail || s <= 0 || 128 % s != 0 ||
        ptr < 0 || ptr >= s)
        return static_cast<int>(cudaErrorInvalidValue);
    const int s_shift = __builtin_ctz(static_cast<unsigned>(s));
    const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 0) {
        probe_folded_kernel<<<blocks, kRowsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
            t, ptr, n, s_shift, tfail, row0, rows, view, view_ts, act,
            rm_ids, n_fail, fail, ids, stale_rows, susp_rows, rm_cnt, det,
            det_any);
    }
    return dm_launch_status();
}
