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
// writes exactly P ids per row.  What it does to reach the memory rate:
// - A persistent grid (as many blocks as the card holds) whose warps
//   walk groups of 8 rows, so each warp has a group's loads in flight
//   before it reduces any: 8 rows of rm_ids are 4 KiB per warp at S=128.
// - 16-byte loads and stores where S % 4 == 0 and the planes are 16-byte
//   aligned (a 128-slot row is one int4 per lane); the window too, where
//   also P % 4 == 0, ptr % 4 == 0 and it does not wrap (the ring step's
//   ptr = (t * P) mod S never wraps at P | S).  Otherwise one word at a
//   time: wrapping windows, any S below 2^16.
// - The fail-id compares run only when some lane of the warp holds an
//   entry at or above the smallest fail id (on a tick, nearly every
//   rm_ids entry is -1), over a compile-time count of fail ids.
// - Counts are kept two 16-bit fields to a word (a row holds fewer than
//   2^16 entries), so one warp reduction sums two counts; the histogram
//   counts a 4-entry chunk in nibbles and spreads them by byte permutes.
// Counts are integers, so any reduction order gives the same result.

#include <climits>
#include <utility>

#include "probe_parts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupRows = 8;     // rows a warp takes at once
constexpr int kHistRows = 4;      // of those, rows the histogram pass holds

struct Args {
    int t, ptr, s, p_cnt, tfail, rows;
    Magic n;                          // member ids, (packed - 1) mod n
    long long row0;
    const unsigned* view;
    const int* view_ts;               // null unless the histogram is wanted
    const unsigned char* act;
    const int* rm_ids;                // null unless the aggregates are
    FailIds fail;
    int fail_lo;                      // the smallest fail id
    bool win_vec;                     // the window as 16-byte runs
    int* ids;
    int* stale_rows;
    int* susp_rows;
    int* rm_cnt;
    int* det;
};

// W consecutive entries of a row: one 16-byte load (W = 4) or one word,
// streamed (each is read once).
template <int W, typename T>
__device__ __forceinline__ void load(T (&v)[W], const T* p) {
    if constexpr (W == 4) {
        const int4 x = __ldcs(reinterpret_cast<const int4*>(p));
        v[0] = static_cast<T>(x.x);
        v[1] = static_cast<T>(x.y);
        v[2] = static_cast<T>(x.z);
        v[3] = static_cast<T>(x.w);
    } else {
        v[0] = __ldcs(p);
    }
}

// The P ids of rows r0 .. r0 + 7: item k of the group is row k / q, piece
// k mod q (q = P / 4 runs of 4, or P single slots).
__device__ __forceinline__ void window(const Args& a, int r0, int lane) {
    const int q = a.win_vec ? a.p_cnt >> 2 : a.p_cnt;
    for (int k = lane; k < kGroupRows * q; k += 32) {
        const int u = k / q, row = r0 + u;
        if (row >= a.rows) break;
        const int i = k - u * q;
        const long long base = static_cast<long long>(row) * a.s;
        const long long out = static_cast<long long>(row) * a.p_cnt;
        const unsigned node = static_cast<unsigned>(a.row0 + row);
        const bool on = a.act[row] != 0;
        if (a.win_vec) {
            const uint4 w = *reinterpret_cast<const uint4*>(
                a.view + base + a.ptr + 4 * i);
            *reinterpret_cast<int4*>(a.ids + out + 4 * i) = make_int4(
                probe_id(w.x, a.n, node, on), probe_id(w.y, a.n, node, on),
                probe_id(w.z, a.n, node, on), probe_id(w.w, a.n, node, on));
        } else {
            int col = a.ptr + i;
            if (col >= a.s) col -= a.s;
            a.ids[out + i] = probe_id(a.view[base + col], a.n, node, on);
        }
    }
}

// Staleness and suspicion bucket counts of the group's rows, kHistRows
// rows at a time.
template <int W>
__device__ __forceinline__ void hist(const Args& a, int r0, int lane) {
    const int chunks = a.s / W;
#pragma unroll
    for (int h = 0; h < kGroupRows; h += kHistRows) {
        Buckets stale[kHistRows], susp[kHistRows];
        for (int c0 = 0; c0 < chunks; c0 += 32) {
            const int c = c0 + lane;
            unsigned w[kHistRows][W];
            int ts[kHistRows][W];
#pragma unroll
            for (int u = 0; u < kHistRows; ++u) {
                const int row = r0 + h + u;
                if (c < chunks && row < a.rows) {
                    const long long at = static_cast<long long>(row) * a.s
                                         + c * W;
                    load<W>(w[u], a.view + at);
                    load<W>(ts[u], a.view_ts + at);
                } else {
#pragma unroll
                    for (int e = 0; e < W; ++e) {
                        w[u][e] = 0u;            // empty: counts nothing
                        ts[u][e] = 0;
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < kHistRows; ++u) {
                unsigned ns, nu;                 // this chunk, in nibbles
                hist_nibbles<W>(w[u], ts[u], a.t, a.tfail, ns, nu);
                stale[u].add_nibbles(ns);
                susp[u].add_nibbles(nu);
            }
        }
#pragma unroll
        for (int u = 0; u < kHistRows; ++u) {
            const long long row = r0 + h + u;
            if (row < a.rows) {
                stale[u].store(lane, a.stale_rows + row * kBuckets);
                susp[u].store(lane, a.susp_rows + row * kBuckets);
            }
        }
    }
}

// Removal count and the NF fail ids' hit counts of the group's rows:
// field 0 of word 0 counts removals, field f + 1 the hits of fail id f.
template <int W, int NF>
__device__ __forceinline__ void agg(const Args& a, int r0, int lane) {
    constexpr int kWords = NF / 2 + 1;
    unsigned acc[kGroupRows][kWords] = {};
    const int chunks = a.s / W;
    for (int c0 = 0; c0 < chunks; c0 += 32) {
        const int c = c0 + lane;
        int v[kGroupRows][W];
        bool in[kGroupRows];
#pragma unroll
        for (int u = 0; u < kGroupRows; ++u) {
            const int row = r0 + u;
            in[u] = c < chunks && row < a.rows;
            if (in[u])
                load<W>(v[u], a.rm_ids + static_cast<long long>(row) * a.s
                              + c * W);
        }
        bool any = false;              // an entry that may hit a fail id
#pragma unroll
        for (int u = 0; u < kGroupRows; ++u) {
            if (!in[u]) continue;
#pragma unroll
            for (int e = 0; e < W; ++e) {
                acc[u][0] += v[u][e] >= 0 ? 1u : 0u;
                any |= v[u][e] >= a.fail_lo;
            }
        }
        if (NF > 0 && __any_sync(DM_FULL_MASK, any)) {
#pragma unroll
            for (int u = 0; u < kGroupRows; ++u) {
                if (!in[u]) continue;
#pragma unroll
                for (int e = 0; e < W; ++e) {
#pragma unroll
                    for (int f = 0; f < NF; ++f)
                        acc[u][(f + 1) >> 1] += v[u][e] == a.fail.ids[f]
                            ? 1u << (((f + 1) & 1) << 4) : 0u;
                }
            }
        }
    }
    // Lane u takes row u's sums and writes its counts.
    unsigned mine[kWords] = {};
#pragma unroll
    for (int u = 0; u < kGroupRows; ++u) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
            const unsigned sum = __reduce_add_sync(DM_FULL_MASK, acc[u][w]);
            if (lane == u) mine[w] = sum;
        }
    }
    const int row = r0 + lane;
    if (lane < kGroupRows && row < a.rows) {
        a.rm_cnt[row] = static_cast<int>(mine[0] & 0xffffu);
#pragma unroll
        for (int f = 0; f < NF; ++f)
            a.det[static_cast<long long>(f) * a.rows + row] =
                static_cast<int>((mine[(f + 1) >> 1]
                                  >> (((f + 1) & 1) << 4)) & 0xffffu);
    }
}

template <int W, int NF>
__global__ void __launch_bounds__(kThreads, 2) probe_kernel(const Args a) {
    const int lane = threadIdx.x & 31;
    const int n_groups = (a.rows + kGroupRows - 1) / kGroupRows;
    const int stride = static_cast<int>(gridDim.x) * kWarps;
    for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < n_groups;
         g += stride) {
        const int r0 = g * kGroupRows;
        window(a, r0, lane);
        if (a.view_ts != nullptr) hist<W>(a, r0, lane);
        if (a.rm_ids != nullptr) agg<W, NF>(a, r0, lane);
    }
}

template <int W, int NF>
int launch(const Args& a, void* stream) {
    const auto kernel = &probe_kernel<W, NF>;
    const long long groups = (a.rows + kGroupRows - 1) / kGroupRows;
    unsigned grid = 0;
    const int err = dm_persistent_grid(kernel, kThreads, 0,
                                       (groups + kWarps - 1) / kWarps, &grid);
    if (err != 0) return err;
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return dm_launch_status();
}

// launch<W, n_fail> for the n_fail of the call, one of F...
template <int W, int... F>
int launch_nf(const Args& a, int n_fail, void* stream,
              std::integer_sequence<int, F...>) {
    int rc = static_cast<int>(cudaErrorInvalidValue);
    ((n_fail == F ? (rc = launch<W, F>(a, stream)) : 0), ...);
    return rc;
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
    if (rows <= 0) return dm_launch_status();
    Args a{t, ptr, s, p_cnt, tfail, rows, magic_of(n), row0, view, view_ts,
           act, rm_ids, fail, INT_MAX, false, ids, stale_rows, susp_rows,
           rm_cnt, det};
    for (int f = 0; f < n_fail; ++f)
        a.fail_lo = fail.ids[f] < a.fail_lo ? fail.ids[f] : a.fail_lo;
    const bool vec = s % 4 == 0 && aligned16(view)
                     && (view_ts == nullptr || aligned16(view_ts))
                     && (rm_ids == nullptr || aligned16(rm_ids));
    a.win_vec = vec && p_cnt % 4 == 0 && ptr % 4 == 0 && ptr + p_cnt <= s
                && aligned16(ids);
    const auto nfs = std::make_integer_sequence<int, kMaxFail + 1>{};
    return vec ? launch_nf<4>(a, n_fail, stream, nfs)
               : launch_nf<1>(a, n_fail, stream, nfs);
}
