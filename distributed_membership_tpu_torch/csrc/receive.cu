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
// once: view, view_ts and mail are updated in place, and the row counts
// are reductions in registers and shared memory, so nothing but the
// outputs reaches device memory.  The TPU kernel's 128-lane tiling took
// S % 128 == 0 only; here any S runs the same way: a block owns
// max(1, 4096 / S) whole rows (at most kMaxBlockRows), read as one span
// of the planes, 16-byte vectors where S % 4 == 0 and 4-byte words
// otherwise, so neighbouring lanes always read neighbouring words and a
// warp covers 32 / S rows at S < 32.  Each row's node context (self
// slot, flags, self entry) is staged in shared memory once; a lane's
// counts are summed over the lanes of its row by a segmented shuffle
// reduction, and the first lane of each row's run adds them to the row's
// shared-memory counters.
//
// The optional admit plane (int32 [rows, S], JAX `receive_fused`'s
// `admit_mask` operand) is a second instantiation: one more load per
// item, where a 0 entry suppresses that slot's delivered mail.  A null
// plane launches the form without it.

#include "receive_one.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kBlockWords = 4096;   // entries a block takes (whole rows)
constexpr int kMaxBlockRows = 1024;

// Block b owns rows [b * block_rows, ...), its entries walked as items of
// kVec words (4 where S % 4 == 0, else 1), item i by lane i % 32 of warp
// (i / 32) % 8 in rounds of kRowThreads items.
template <bool kAdmit, int kVec>
__global__ void __launch_bounds__(kRowThreads)
receive_rows_kernel(int t, unsigned n, int s, int tfail, int tremove,
                    int stride_mod, long long row0, int rows,
                    int block_rows, unsigned* __restrict__ view,
                    int* __restrict__ view_ts, unsigned* __restrict__ mail,
                    const unsigned* __restrict__ cand,
                    const unsigned char* __restrict__ recv,
                    const unsigned char* __restrict__ act,
                    const unsigned char* __restrict__ self_on,
                    const unsigned* __restrict__ self_pack,
                    const int* __restrict__ admit,
                    unsigned char* __restrict__ join,
                    int* __restrict__ rm_ids, int* __restrict__ numfailed,
                    int* __restrict__ size) {
    __shared__ int sh_slot[kMaxBlockRows];
    __shared__ unsigned sh_pack[kMaxBlockRows];
    __shared__ unsigned char sh_flags[kMaxBlockRows];
    __shared__ int sh_stale[kMaxBlockRows];
    __shared__ int sh_size[kMaxBlockRows];
    const int tid = threadIdx.x, lane = tid & 31;
    const long long r0 = static_cast<long long>(blockIdx.x) * block_rows;
    const int nrows = static_cast<int>(
        min(static_cast<long long>(block_rows), rows - r0));
    for (int i = tid; i < nrows; i += kRowThreads) {
        const long long row = r0 + i;
        const long long node = row0 + row;
        sh_slot[i] = static_cast<int>(((node % s) * stride_mod) % s);
        sh_pack[i] = self_pack[row];
        sh_flags[i] = static_cast<unsigned char>(
            (recv[row] != 0) | ((act[row] != 0) << 1)
            | ((self_on[row] != 0) << 2));
        sh_stale[i] = 0;
        sh_size[i] = 0;
    }
    __syncthreads();

    // nrows * s <= max(kBlockWords, s) entries: 32-bit inside the block.
    const int items = nrows * s / kVec;
    const long long base = r0 * s;
    RowCtx r;
    r.t = t;
    r.tfail = tfail;
    r.tremove = tremove;
    r.n = n;
    for (int i0 = 0; i0 < items; i0 += kRowThreads) {
        const int it = i0 + tid;
        int row = -1, stale_cnt = 0, size_cnt = 0;
        if (it < items) {
            const int e = it * kVec;
            row = e / s;
            const int col = e - row * s;
            const unsigned char f = sh_flags[row];
            r.node = static_cast<unsigned>(row0 + r0 + row);
            r.self_slot = sh_slot[row];
            r.recv = f & 1;
            r.act = (f >> 1) & 1;
            r.son = (f >> 2) & 1;
            r.spack = sh_pack[row];
            const long long off = base + e;
            if constexpr (kVec == 4) {
                uint4 v = *reinterpret_cast<const uint4*>(view + off);
                int4 ts = *reinterpret_cast<const int4*>(view_ts + off);
                uint4 m = *reinterpret_cast<const uint4*>(mail + off);
                const uint4 cd = *reinterpret_cast<const uint4*>(cand + off);
                int4 ad = make_int4(1, 1, 1, 1);
                if (kAdmit) ad = *reinterpret_cast<const int4*>(admit + off);
                uchar4 jn;
                int4 rm;
                receive_one(r, col + 0, v.x, ts.x, m.x, cd.x, jn.x, rm.x, stale_cnt, size_cnt, ad.x != 0);
                receive_one(r, col + 1, v.y, ts.y, m.y, cd.y, jn.y, rm.y, stale_cnt, size_cnt, ad.y != 0);
                receive_one(r, col + 2, v.z, ts.z, m.z, cd.z, jn.z, rm.z, stale_cnt, size_cnt, ad.z != 0);
                receive_one(r, col + 3, v.w, ts.w, m.w, cd.w, jn.w, rm.w, stale_cnt, size_cnt, ad.w != 0);
                *reinterpret_cast<uint4*>(view + off) = v;
                *reinterpret_cast<int4*>(view_ts + off) = ts;
                *reinterpret_cast<uint4*>(mail + off) = m;
                *reinterpret_cast<uchar4*>(join + off) = jn;
                *reinterpret_cast<int4*>(rm_ids + off) = rm;
            } else {
                unsigned v = view[off], m = mail[off];
                int ts = view_ts[off], rm;
                unsigned char jn;
                receive_one(r, col, v, ts, m, cand[off], jn, rm, stale_cnt,
                            size_cnt, !kAdmit || admit[off] != 0);
                view[off] = v;
                view_ts[off] = ts;
                mail[off] = m;
                join[off] = jn;
                rm_ids[off] = rm;
            }
        }
        // Rows are contiguous runs of lanes: lane i sums lanes i.. of its
        // row, and the first lane of each run holds the run's total.
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int rr = __shfl_down_sync(DM_FULL_MASK, row, o);
            const int a = __shfl_down_sync(DM_FULL_MASK, stale_cnt, o);
            const int b = __shfl_down_sync(DM_FULL_MASK, size_cnt, o);
            if (lane + o < 32 && rr == row) {
                stale_cnt += a;
                size_cnt += b;
            }
        }
        const int prev = __shfl_up_sync(DM_FULL_MASK, row, 1);
        if (row >= 0 && (lane == 0 || prev != row)) {
            if (stale_cnt) atomicAdd(sh_stale + row, stale_cnt);
            if (size_cnt) atomicAdd(sh_size + row, size_cnt);
        }
    }
    __syncthreads();
    for (int i = tid; i < nrows; i += kRowThreads) {
        numfailed[r0 + i] = sh_stale[i];
        size[r0 + i] = sh_size[i];
    }
}

template <bool kAdmit>
void launch_rows(int s, unsigned blocks, int block_rows, cudaStream_t st,
                 int t, unsigned n, int tfail, int tremove, int stride_mod,
                 long long row0, int rows, unsigned* view, int* view_ts,
                 unsigned* mail, const unsigned* cand,
                 const unsigned char* recv, const unsigned char* act,
                 const unsigned char* self_on, const unsigned* self_pack,
                 const int* admit, unsigned char* join, int* rm_ids,
                 int* numfailed, int* size) {
    auto kernel = s % 4 == 0 ? receive_rows_kernel<kAdmit, 4>
                             : receive_rows_kernel<kAdmit, 1>;
    kernel<<<blocks, kRowThreads, 0, st>>>(
        t, n, s, tfail, tremove, stride_mod, row0, rows, block_rows, view,
        view_ts, mail, cand, recv, act, self_on, self_pack, admit, join,
        rm_ids, numfailed, size);
}

}  // namespace

// Any S > 0; every plane contiguous, and 16-byte aligned where S % 4 == 0
// (the Python wrapper checks both); `admit` may be null.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for S <= 0.
extern "C" int dm_receive(int t, unsigned n, int s, int tfail, int tremove,
                          int stride, long long row0, int rows,
                          unsigned* view, int* view_ts, unsigned* mail,
                          const unsigned* cand, const unsigned char* recv,
                          const unsigned char* act,
                          const unsigned char* self_on,
                          const unsigned* self_pack, unsigned char* join,
                          int* rm_ids, int* numfailed, int* size,
                          const int* admit, void* stream) {
    if (s <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int stride_mod = static_cast<int>((1LL + stride) % s);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (rows <= 0) return dm_launch_status();
    const int fit = s >= kBlockWords ? 1 : kBlockWords / s;
    const int block_rows = fit < kMaxBlockRows ? fit : kMaxBlockRows;
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<long long>(rows) + block_rows - 1) / block_rows);
    if (admit != nullptr)
        launch_rows<true>(s, blocks, block_rows, st, t, n, tfail, tremove,
                          stride_mod, row0, rows, view, view_ts, mail, cand,
                          recv, act, self_on, self_pack, admit, join, rm_ids,
                          numfailed, size);
    else
        launch_rows<false>(s, blocks, block_rows, st, t, n, tfail, tremove,
                           stride_mod, row0, rows, view, view_ts, mail, cand,
                           recv, act, self_on, self_pack, admit, join,
                           rm_ids, numfailed, size);
    return dm_launch_status();
}
