// K7: the probe-window read plus the per-row aggregate partials, on the
// folded layout.
//
// Replaces the Pallas kernel `probe_folded_window_fused` of the JAX
// package's ops/fused_probe.py.  A [rows, 128] plane row holds F = 128/S
// nodes of S slots each, node-major.  Position p of node i's window is
// slot (ptr + p) mod S of the node; it yields the probe id + 1 when that
// slot is occupied, not the node itself, and the node is active (else 0).
// Optionally, per plane row: the staleness and suspicion bucket counts
// of view_ts (8 buckets of 8 ticks), and the removal count and
// per-failed-id detection counts of the rm_ids plane; and per node
// whether it removed any failed id (det_any).
//
// Bound: bytes.  The TPU kernel rolled every plane row whole, wrote a
// [rows, 128] id plane and one det_any entry per slot, and the step kept
// P of each node's S ids and one flag per node.  This kernel computes
// just that: it reads only the window's sectors of view at S >= 8 (at
// S <= 4 a node's slots lie in one 16-byte load, so rows are read whole,
// as the histogram form reads them), and writes [nodes, P] ids and one
// det_any byte per node.  What it does to reach the memory rate:
// - A persistent grid of 32 warps an SM (64 registers a thread), whose
//   warps walk groups of 4 plane rows (2 in the histogram form, which
//   holds three planes' rows); a group's rm_ids rows (16-byte streamed
//   loads) are loaded before its window is read, so both are in flight
//   at once.
// - The window one node a lane, as 16-byte runs where P % 4 == 0, ptr % 4
//   == 0 and it does not wrap (the ring step's ptr = (t * P) mod S never
//   wraps at P | S), 8-byte runs where both are even, else one word a
//   slot.  Where the rows are read whole, each id is shuffled from the
//   lane that holds its slot, so the ids of a row are stored by
//   consecutive lanes.  Member ids by the Magic remainder (common.cuh),
//   not a division.
// - The fail-id compares run only when some lane of the warp holds an
//   entry at or above the smallest fail id (nearly every rm_ids entry of
//   a tick is -1), over a compile-time count of fail ids.  A node's
//   det_any is an OR over its segment: a ballot over the S/4 lanes that
//   hold it (S >= 4), or within a lane's four entries (S = 2).
// - Counts are two 16-bit fields to a word (a plane row holds 128
//   entries), summed by integer warp reductions row by row, so their
//   order cannot change them.

#include <climits>
#include <utility>

#include "probe_parts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Plane rows a warp takes at once: 4, or 2 in the histogram form, which
// holds three planes' rows (the faster of 2, 4 and 8 rows on the card).
__host__ __device__ constexpr int group_rows(bool hist) {
    return hist ? 2 : 4;
}
constexpr int kLanes = 128;       // entries of a plane row

struct Args {
    int t, ptr, s_shift, p_cnt, tfail, rows;
    Magic n;                          // member ids, (packed - 1) mod n
    long long row0;                   // the plane's first global node id
    const unsigned* view;
    const int* view_ts;               // null unless the histogram is wanted
    const unsigned char* act;         // per node
    const int* rm_ids;                // null unless the aggregates are
    FailIds fail;
    int fail_lo;                      // the smallest fail id
    int win_w;                        // window words a load: 4, 2 or 1
    int* ids;                         // [nodes, p_cnt]
    int* stale_rows;
    int* susp_rows;
    int* rm_cnt;
    int* det;                         // [n_fail, rows]
    unsigned char* det_any;           // [nodes]; null without fail ids
};

__device__ __forceinline__ unsigned pick(const uint4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// This lane's four entries of the group's rows of a [rows, 128] plane
// (`fill` past the last row), streamed.
template <int G, typename T4, typename T>
__device__ __forceinline__ void load_rows(const Args& a, const T* plane,
                                          int r0, int lane, T4 fill,
                                          T4 (&out)[G]) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
        out[u] = r0 + u < a.rows
            ? __ldcs(reinterpret_cast<const T4*>(
                  plane + static_cast<long long>(r0 + u) * kLanes
                  + 4 * lane))
            : fill;
    }
}

// S >= 8 without the histogram: the window slots of the group's nodes,
// read from view, one node a lane: runs of win_w words (16- or 8-byte
// loads where the window does not wrap and ptr and P are multiples of
// win_w), stored as the node's P consecutive ids.
template <int G>
__device__ __forceinline__ void window_slots(const Args& a, int r0,
                                             int lane) {
    const int f_shift = 7 - a.s_shift;
    const int s = 1 << a.s_shift;
    const int nodes_here = min(G, a.rows - r0) << f_shift;
    const long long node0 = static_cast<long long>(r0) << f_shift;
    for (int j = lane; j < nodes_here; j += 32) {
        const long long node = node0 + j;
        const unsigned* __restrict__ row = a.view + (node << a.s_shift);
        int* __restrict__ out = a.ids + node * a.p_cnt;
        const unsigned id = static_cast<unsigned>(a.row0 + node);
        const bool on = a.act[node] != 0;
        if (a.win_w == 4) {
            for (int i = 0; i < a.p_cnt; i += 4) {
                const uint4 w = __ldg(reinterpret_cast<const uint4*>(
                    row + a.ptr + i));
                *reinterpret_cast<int4*>(out + i) = make_int4(
                    probe_id(w.x, a.n, id, on), probe_id(w.y, a.n, id, on),
                    probe_id(w.z, a.n, id, on), probe_id(w.w, a.n, id, on));
            }
        } else if (a.win_w == 2) {
            for (int i = 0; i < a.p_cnt; i += 2) {
                const uint2 w = __ldg(reinterpret_cast<const uint2*>(
                    row + a.ptr + i));
                *reinterpret_cast<int2*>(out + i) = make_int2(
                    probe_id(w.x, a.n, id, on), probe_id(w.y, a.n, id, on));
            }
        } else {
            int col = a.ptr;
            for (int i = 0; i < a.p_cnt; ++i) {
                out[i] = probe_id(__ldg(row + col), a.n, id, on);
                col = col + 1 == s ? 0 : col + 1;
            }
        }
    }
}

// The window from the group's rows already in registers (S <= 4, where a
// node's slots lie in one 16-byte load, and the histogram form, which
// reads rows whole): row u's ids are item k = j * P + p (node j, position
// p) at ids[(row * F) * P + k], each gathered from the lane that holds
// entry j * S + (ptr + p) mod S by shuffles.
template <int G>
__device__ __forceinline__ void window_rows(const Args& a, int r0, int lane,
                                            const uint4 (&v)[G]) {
    const int f_shift = 7 - a.s_shift;
    const int smask = (1 << a.s_shift) - 1;
    const int per_row = a.p_cnt << f_shift;
#pragma unroll
    for (int u = 0; u < G; ++u) {
        if (r0 + u >= a.rows) break;
        const long long node0 = static_cast<long long>(r0 + u) << f_shift;
        for (int k0 = 0; k0 < per_row; k0 += 32) {
            const int k = k0 + lane;
            const int j = k / a.p_cnt, p = k - j * a.p_cnt;
            const int c = ((j << a.s_shift) + ((a.ptr + p) & smask)) & 127;
            const int src = c >> 2;
            const uint4 x = make_uint4(__shfl_sync(DM_FULL_MASK, v[u].x, src),
                                       __shfl_sync(DM_FULL_MASK, v[u].y, src),
                                       __shfl_sync(DM_FULL_MASK, v[u].z, src),
                                       __shfl_sync(DM_FULL_MASK, v[u].w, src));
            if (k < per_row) {
                const long long node = node0 + j;
                a.ids[node0 * a.p_cnt + k] = probe_id(
                    pick(x, c & 3), a.n, static_cast<unsigned>(a.row0 + node),
                    a.act[node] != 0);
            }
        }
    }
}

// Staleness and suspicion bucket counts of the group's rows, from their
// view and view_ts entries in registers.
template <int G>
__device__ __forceinline__ void hist(const Args& a, int r0, int lane,
                                     const uint4 (&v)[G],
                                     const int4 (&ts)[G]) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
        if (r0 + u >= a.rows) break;
        const unsigned w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        const int tt[4] = {ts[u].x, ts[u].y, ts[u].z, ts[u].w};
        unsigned ns, nu;
        hist_nibbles<4>(w, tt, a.t, a.tfail, ns, nu);
        Buckets stale, susp;
        stale.add_nibbles(ns);
        susp.add_nibbles(nu);
        const long long row = r0 + u;
        stale.store(lane, a.stale_rows + row * kBuckets);
        susp.store(lane, a.susp_rows + row * kBuckets);
    }
}

// Removal count and the NF fail ids' hit counts of the group's rows
// (field 0 of word 0 counts removals, field f + 1 the hits of fail id
// f), and det_any of the group's nodes, one row at a time.
template <int NF, int G>
__device__ __forceinline__ void agg(const Args& a, int r0, int lane,
                                    const int4 (&rm)[G]) {
    constexpr int kWords = NF / 2 + 1;
    bool any = false;                 // an entry that may hit a fail id
#pragma unroll
    for (int u = 0; u < G; ++u) {
        any |= rm[u].x >= a.fail_lo || rm[u].y >= a.fail_lo ||
               rm[u].z >= a.fail_lo || rm[u].w >= a.fail_lo;
    }
    const bool cand = NF > 0 && __any_sync(DM_FULL_MASK, any);
    const int f_shift = 7 - a.s_shift;            // log2 nodes a row
    const int seg_shift = a.s_shift - 2;          // log2 lanes a node
    unsigned mine[kWords] = {};
#pragma unroll
    for (int u = 0; u < G; ++u) {
        const int v[4] = {rm[u].x, rm[u].y, rm[u].z, rm[u].w};
        unsigned acc[kWords] = {};
        unsigned hit = 0u;            // bit e: entry e removed a fail id
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0] += v[e] >= 0 ? 1u : 0u;
        if (cand) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
#pragma unroll
                for (int f = 0; f < NF; ++f) {
                    const bool h = v[e] == a.fail.ids[f];
                    acc[(f + 1) >> 1] += h ? 1u << (((f + 1) & 1) << 4) : 0u;
                    hit |= h ? 1u << e : 0u;
                }
            }
        }
        // Lane u takes row u's sums.
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
            const unsigned sum = __reduce_add_sync(DM_FULL_MASK, acc[w]);
            if (lane == u) mine[w] = sum;
        }
        if (NF == 0 || r0 + u >= a.rows) continue;
        // det_any of row u's nodes: node j is lanes j * S/4 .. (j + 1) *
        // S/4 - 1 (S >= 4), or entries 2j, 2j + 1 of lane j / 2 (S = 2).
        unsigned char* out = a.det_any
            + (static_cast<long long>(r0 + u) << f_shift);
        if (a.s_shift == 1) {
            *reinterpret_cast<uchar2*>(out + 2 * lane) = make_uchar2(
                (hit & 3u) != 0u, (hit & 12u) != 0u);
        } else {
            const unsigned bal = cand ? __ballot_sync(DM_FULL_MASK, hit != 0u)
                                      : 0u;
            if (lane < (1 << f_shift))
                out[lane] = ((bal >> (lane << seg_shift))
                             & ((1u << (1 << seg_shift)) - 1u)) != 0u;
        }
    }
    const int row = r0 + lane;
    if (lane < G && row < a.rows) {
        a.rm_cnt[row] = static_cast<int>(mine[0] & 0xffffu);
#pragma unroll
        for (int f = 0; f < NF; ++f)
            a.det[static_cast<long long>(f) * a.rows + row] =
                static_cast<int>((mine[(f + 1) >> 1]
                                  >> (((f + 1) & 1) << 4)) & 0xffffu);
    }
}

// HIST: the histogram form, which reads view and view_ts rows whole and
// takes the window from them.
template <int NF, bool HIST>
__global__ void __launch_bounds__(kThreads, 4)
probe_folded_kernel(const Args a) {
    constexpr int G = group_rows(HIST);
    const int lane = threadIdx.x & 31;
    const int n_groups = (a.rows + G - 1) / G;
    const int stride = static_cast<int>(gridDim.x) * kWarps;
    const bool with_agg = a.rm_ids != nullptr;
    const bool whole = HIST || a.s_shift < 3;
    for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < n_groups;
         g += stride) {
        const int r0 = g * G;
        int4 rm[G];
        uint4 v[G];
        int4 ts[G];
        if (with_agg)
            load_rows(a, a.rm_ids, r0, lane, make_int4(-1, -1, -1, -1), rm);
        if (whole) {
            load_rows(a, a.view, r0, lane, make_uint4(0u, 0u, 0u, 0u), v);
            if constexpr (HIST)
                load_rows(a, a.view_ts, r0, lane, make_int4(0, 0, 0, 0), ts);
            window_rows(a, r0, lane, v);
        } else {
            window_slots<G>(a, r0, lane);
        }
        if constexpr (HIST) hist(a, r0, lane, v, ts);
        if (with_agg) agg<NF, G>(a, r0, lane, rm);
    }
}

template <int NF, bool HIST>
int launch(const Args& a, void* stream) {
    const auto kernel = &probe_folded_kernel<NF, HIST>;
    const long long groups = (a.rows + group_rows(HIST) - 1)
                             / group_rows(HIST);
    unsigned grid = 0;
    const int err = dm_persistent_grid(kernel, kThreads, 0,
                                       (groups + kWarps - 1) / kWarps, &grid);
    if (err != 0) return err;
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return dm_launch_status();
}

// launch<n_fail, HIST> for the n_fail of the call, one of F...
template <bool HIST, int... F>
int launch_nf(const Args& a, int n_fail, void* stream,
              std::integer_sequence<int, F...>) {
    int rc = static_cast<int>(cudaErrorInvalidValue);
    ((n_fail == F ? (rc = launch<F, HIST>(a, stream)) : 0), ...);
    return rc;
}

}  // namespace

// view, view_ts and rm_ids are contiguous, 16-byte aligned [rows, 128]
// planes; act is [nodes] bytes (nodes = rows * 128 / S), S divides 128,
// 0 < p_cnt < S and 0 <= ptr < S.  ids is [nodes, p_cnt] int32.
// view_ts, stale_rows and susp_rows ([rows, 8]) are all null or all set;
// rm_ids, rm_cnt ([rows]) and det ([n_fail, rows]) likewise, with det_any
// ([nodes] bytes) set iff n_fail > 0.  Returns cudaGetLastError().
extern "C" int dm_probe_folded(int t, int ptr, unsigned n, int s, int p_cnt,
                               int tfail, long long row0, int rows,
                               const unsigned* view, const int* view_ts,
                               const unsigned char* act, const int* rm_ids,
                               int n_fail, FailIds fail, int* ids,
                               int* stale_rows, int* susp_rows, int* rm_cnt,
                               int* det, unsigned char* det_any,
                               void* stream) {
    if (n_fail < 0 || n_fail > kMaxFail || s < 2 || s >= kLanes ||
        kLanes % s != 0 || p_cnt <= 0 || p_cnt >= s || ptr < 0 ||
        ptr >= s || !aligned16(view) ||
        (view_ts != nullptr && !aligned16(view_ts)) ||
        (rm_ids != nullptr && !aligned16(rm_ids)) ||
        (rm_ids != nullptr && (n_fail > 0) != (det_any != nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows <= 0) return dm_launch_status();
    Args a{t, ptr, __builtin_ctz(static_cast<unsigned>(s)), p_cnt, tfail,
           rows, magic_of(n), row0, view, view_ts, act, rm_ids, fail, INT_MAX,
           1, ids, stale_rows, susp_rows, rm_cnt, det, det_any};
    for (int f = 0; f < n_fail; ++f)
        a.fail_lo = fail.ids[f] < a.fail_lo ? fail.ids[f] : a.fail_lo;
    if (ptr + p_cnt <= s && aligned16(ids))
        a.win_w = p_cnt % 4 == 0 && ptr % 4 == 0   ? 4
                  : p_cnt % 2 == 0 && ptr % 2 == 0 ? 2 : 1;
    const int nf = rm_ids != nullptr ? n_fail : 0;
    const auto nfs = std::make_integer_sequence<int, kMaxFail + 1>{};
    return view_ts != nullptr ? launch_nf<true>(a, nf, stream, nfs)
                              : launch_nf<false>(a, nf, stream, nfs);
}
