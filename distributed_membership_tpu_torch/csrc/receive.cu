// K1: the ring step's receive pass in one traversal of the [rows, S] state.
//
// Replaces the Pallas kernel `receive_fused` of the JAX package's
// ops/fused_receive.py (semantics single-sourced there in
// `_receive_body`): sticky admission of mail, the occupant-matched
// strict-increase ack refresh from the candidate plane, the self-slot
// double-heartbeat refresh, and the TFAIL/TREMOVE sweep, with per-row
// stale and occupied counts.
//
// Bound: bytes.  Per element it reads view, view_ts, mail, cand (16 B)
// and writes view, view_ts, mail, rm_ids (16 B) plus the join byte, a
// handful of integer operations in between, far below the card's
// operations per byte.  The design therefore moves each byte exactly
// once: view, view_ts and mail are updated in place, one warp owns one
// row (S = 128 -> four u32 per lane, one 16-byte load per plane), and
// the row counts are warp reductions, so nothing but the outputs
// reaches device memory.
//
// The optional admit plane (int32 [rows, S], JAX `receive_fused`'s
// `admit_mask` operand) is a second instantiation of the same kernel:
// one more 16-byte load per lane and step, where a 0 entry suppresses
// that slot's delivered mail.  A null plane launches the form without
// it, the same code as before the operand existed.

#include "receive_one.cuh"

namespace {

constexpr int kRowsPerBlock = 8;   // one warp per row

template <bool kAdmit>
__global__ void receive_kernel(int t, unsigned n, int s, int tfail,
                               int tremove, int stride_mod,
                               long long row0, int rows,
                               unsigned* __restrict__ view,
                               int* __restrict__ view_ts,
                               unsigned* __restrict__ mail,
                               const unsigned* __restrict__ cand,
                               const unsigned char* __restrict__ recv,
                               const unsigned char* __restrict__ act,
                               const unsigned char* __restrict__ self_on,
                               const unsigned* __restrict__ self_pack,
                               const int* __restrict__ admit,
                               unsigned char* __restrict__ join,
                               int* __restrict__ rm_ids,
                               int* __restrict__ numfailed,
                               int* __restrict__ size) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
    if (row >= rows) return;   // whole warp leaves together

    RowCtx r;
    r.t = t;
    r.tfail = tfail;
    r.tremove = tremove;
    r.n = n;
    const long long node = row0 + row;
    r.node = static_cast<unsigned>(node);
    r.self_slot = static_cast<int>(((node % s) * stride_mod) % s);
    r.recv = recv[row] != 0;
    r.act = act[row] != 0;
    r.son = self_on[row] != 0;
    r.spack = self_pack[row];

    int stale_cnt = 0, size_cnt = 0;
    const long long base = static_cast<long long>(row) * s;
    for (int c0 = lane * 4; c0 < s; c0 += 128) {
        const long long off = base + c0;
        uint4 v = *reinterpret_cast<const uint4*>(view + off);
        int4 ts = *reinterpret_cast<const int4*>(view_ts + off);
        uint4 m = *reinterpret_cast<const uint4*>(mail + off);
        const uint4 cd = *reinterpret_cast<const uint4*>(cand + off);
        int4 ad = make_int4(1, 1, 1, 1);
        if (kAdmit) ad = *reinterpret_cast<const int4*>(admit + off);
        uchar4 jn;
        int4 rm;
        receive_one(r, c0 + 0, v.x, ts.x, m.x, cd.x, jn.x, rm.x, stale_cnt, size_cnt, ad.x != 0);
        receive_one(r, c0 + 1, v.y, ts.y, m.y, cd.y, jn.y, rm.y, stale_cnt, size_cnt, ad.y != 0);
        receive_one(r, c0 + 2, v.z, ts.z, m.z, cd.z, jn.z, rm.z, stale_cnt, size_cnt, ad.z != 0);
        receive_one(r, c0 + 3, v.w, ts.w, m.w, cd.w, jn.w, rm.w, stale_cnt, size_cnt, ad.w != 0);
        *reinterpret_cast<uint4*>(view + off) = v;
        *reinterpret_cast<int4*>(view_ts + off) = ts;
        *reinterpret_cast<uint4*>(mail + off) = m;
        *reinterpret_cast<uchar4*>(join + off) = jn;
        *reinterpret_cast<int4*>(rm_ids + off) = rm;
    }
    stale_cnt = dm_warp_sum(stale_cnt);
    size_cnt = dm_warp_sum(size_cnt);
    if (lane == 0) {
        numfailed[row] = stale_cnt;
        size[row] = size_cnt;
    }
}

}  // namespace

// S must be a multiple of 128 and every plane contiguous and 16-byte
// aligned (the Python wrapper checks both); `admit` may be null.
// Returns cudaGetLastError().
extern "C" int dm_receive(int t, unsigned n, int s, int tfail, int tremove,
                          int stride, long long row0, int rows,
                          unsigned* view, int* view_ts, unsigned* mail,
                          const unsigned* cand, const unsigned char* recv,
                          const unsigned char* act,
                          const unsigned char* self_on,
                          const unsigned* self_pack, unsigned char* join,
                          int* rm_ids, int* numfailed, int* size,
                          const int* admit, void* stream) {
    const int stride_mod = static_cast<int>((1LL + stride) % s);
    const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 0) {
        auto kernel = admit != nullptr ? receive_kernel<true>
                                       : receive_kernel<false>;
        kernel<<<blocks, kRowsPerBlock * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
            t, n, s, tfail, tremove, stride_mod, row0, rows, view, view_ts,
            mail, cand, recv, act, self_on, self_pack, admit, join, rm_ids,
            numfailed, size);
    }
    return dm_launch_status();
}
