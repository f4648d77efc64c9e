// K5: the receive pass on the folded layout, in one traversal.
//
// Replaces the Pallas kernel `receive_folded_fused` of the JAX package's
// ops/fused_folded.py (semantics there in `_folded_receive_body`).  For
// S < 128 the ring state is stored folded: F = 128 / S nodes share a
// plane row of 128 entries, so entry e of the [rows, 128] plane belongs
// to node row0 + e / S at slot e % S (the bytes of the natural [N, S]
// plane).  Per entry it is K1's pass (receive_one.cuh); instead of K1's
// per-row counts it writes the pre-remove stale mask, which the caller
// reduces per node.
//
// Bound: bytes.  It reads view, view_ts, mail, cand (16 B per entry) and
// the per-node recv, act and self entry (6 B per node), and writes view,
// view_ts, mail, rm_ids (16 B) plus the join and stale bytes; a few
// integer operations per entry.  One thread owns four consecutive
// entries (one 16-byte load or store per plane), so a plane row is one
// warp, as in K1 at S = 128.  The TPU kernel took recv, act and the self
// entry pre-broadcast as three more [rows, 128] planes; this one reads
// the per-node vectors, 3 x 4 B per entry less traffic.

#include "receive_one.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void receive_folded_kernel(int t, Magic n, int s_shift,
                                      int tfail, int tremove,
                                      int stride_mod, long long row0,
                                      long long quads,
                                      unsigned* __restrict__ view,
                                      int* __restrict__ view_ts,
                                      unsigned* __restrict__ mail,
                                      const unsigned* __restrict__ cand,
                                      const unsigned char* __restrict__ recv,
                                      const unsigned char* __restrict__ act,
                                      const unsigned* __restrict__ self_val,
                                      unsigned char* __restrict__ join,
                                      int* __restrict__ rm_ids,
                                      unsigned char* __restrict__ stale) {
    const long long q = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
    if (q >= quads) return;
    const long long off = q * 4;
    const int smask = (1 << s_shift) - 1;
    uint4 v = *reinterpret_cast<const uint4*>(view + off);
    int4 ts = *reinterpret_cast<const int4*>(view_ts + off);
    uint4 m = *reinterpret_cast<const uint4*>(mail + off);
    const uint4 cd = *reinterpret_cast<const uint4*>(cand + off);
    unsigned vv[4] = {v.x, v.y, v.z, v.w};
    int tt[4] = {ts.x, ts.y, ts.z, ts.w};
    unsigned mm[4] = {m.x, m.y, m.z, m.w};
    const unsigned cc[4] = {cd.x, cd.y, cd.z, cd.w};
    unsigned char jn[4], st[4];
    int rm[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const long long e = off + k;
        const long long local = e >> s_shift;     // node within the plane
        const long long node = row0 + local;
        RowCtx r;
        r.t = t;
        r.tfail = tfail;
        r.tremove = tremove;
        r.n = n;
        r.node = static_cast<unsigned>(node);
        // S divides 128, so it is a power of two: node % S is a mask.
        r.self_slot = static_cast<int>(((node & smask) * stride_mod) & smask);
        r.recv = recv[local] != 0;
        r.act = act[local] != 0;
        r.son = r.act;
        r.spack = self_val[local];
        int stale_cnt = 0, size_cnt = 0;
        receive_one(r, static_cast<int>(e & smask), vv[k], tt[k], mm[k],
                    cc[k], jn[k], rm[k], stale_cnt, size_cnt);
        st[k] = static_cast<unsigned char>(stale_cnt);
    }
    *reinterpret_cast<uint4*>(view + off) = make_uint4(vv[0], vv[1], vv[2],
                                                       vv[3]);
    *reinterpret_cast<int4*>(view_ts + off) = make_int4(tt[0], tt[1], tt[2],
                                                        tt[3]);
    *reinterpret_cast<uint4*>(mail + off) = make_uint4(mm[0], mm[1], mm[2],
                                                       mm[3]);
    *reinterpret_cast<uchar4*>(join + off) = make_uchar4(jn[0], jn[1], jn[2],
                                                         jn[3]);
    *reinterpret_cast<int4*>(rm_ids + off) = make_int4(rm[0], rm[1], rm[2],
                                                       rm[3]);
    *reinterpret_cast<uchar4*>(stale + off) = make_uchar4(st[0], st[1],
                                                          st[2], st[3]);
}

}  // namespace

// S divides 128 and every plane is a contiguous, 16-byte aligned
// [rows, 128] (the Python wrapper checks).  view, view_ts and mail are
// updated in place.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an S that does not divide 128 or N == 0.
extern "C" int dm_receive_folded(int t, unsigned n, int s, int tfail,
                                 int tremove, int stride, long long row0,
                                 int rows, unsigned* view, int* view_ts,
                                 unsigned* mail, const unsigned* cand,
                                 const unsigned char* recv,
                                 const unsigned char* act,
                                 const unsigned* self_val,
                                 unsigned char* join, int* rm_ids,
                                 unsigned char* stale, void* stream) {
    if (s <= 0 || 128 % s != 0 || n == 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int s_shift = __builtin_ctz(static_cast<unsigned>(s));
    const int stride_mod = static_cast<int>((1LL + stride) % s);
    const long long quads = static_cast<long long>(rows) * 32;
    const long long blocks = (quads + kThreads - 1) / kThreads;
    if (blocks > 0) {
        receive_folded_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
            t, magic_of(n), s_shift, tfail, tremove, stride_mod, row0,
            quads, view, view_ts, mail, cand, recv, act, self_val, join,
            rm_ids, stale);
    }
    return dm_launch_status();
}
