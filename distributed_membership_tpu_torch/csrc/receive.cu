// K1: the ring step's receive pass, one walk over tiles of the flattened
// [rows * S] planes for every S.
//
// Replaces the Pallas kernel `receive_fused` of the JAX package's
// ops/fused_receive.py (semantics single-sourced there in
// `_receive_body`, here in receive_one.cuh, which K5 shares): sticky
// admission of mail, the occupant-matched strict-increase ack refresh
// from the candidate plane, the self-slot double-heartbeat refresh, and
// the TFAIL/TREMOVE sweep, with per-row stale and occupied counts.
//
// Bound: bytes.  Per entry it reads view, view_ts, mail, cand (16 B) and
// writes view, view_ts, mail, rm_ids (16 B) plus the join byte, per row
// 7 bytes of row vectors in and two counts out, with a few dozen integer
// operations per entry in between.  So every byte moves once (view,
// view_ts and mail in place, the counts reduced on chip), and what the
// design has to get right is the memory traffic: 16-byte requests
// whatever S is (the TPU kernel's 128-lane tiling took S % 128 == 0
// only; a block of whole rows reads 4-byte words wherever S % 4 != 0),
// and enough of them in flight.
//
// Tiles.  A block takes kTile consecutive entries of the flattened planes
// (the last tile ragged), whatever S is: a row may be cut by a tile end,
// and a row wider than a tile spans several.  Its thread block loads the
// tile's span of view, view_ts, mail, cand (and admit) into shared
// memory by 16-byte loads, each span widened to 16-byte bounds with its
// lead counted from its own plane's base (planes that are slices may
// differ mod 16), so S % 4 != 0 moves its bytes as S % 4 == 0 does; the
// row context (self slot, self entry, flags) of the rows the tile
// touches is staged while the loads are in flight.  Small tiles and
// blocks (four blocks, 32 warps an SM) keep as many 16-byte loads in
// flight as the card needs: on the card this beat a persistent grid fed
// by 1-D bulk copies through a ring of shared-memory stages, which
// stayed near 84% of the bound (PERF.md) whatever its stages, compute
// groups, stores or L2 cache hints.
//
// Compute.  Thread t takes the tile's entries t, t + 256, ...
// (conflict-free shared-memory words, its row and column stepped along,
// no division) and stores its outputs straight to device memory: each
// store of a warp is 32 consecutive entries, so the writes are whole
// lines at any plane's offset, and no entry of a neighbouring tile is
// touched.  Member ids ((packed - 1) mod N, up to five an entry) and the
// self slots take the remainder by direct computation (receive_one.cuh's
// Magic) instead of an integer division.  Then the counts, one warp step
// (32 consecutive entries) at a time: two warp reductions from S = 32 on
// (two rows at most), a prefix sum over the lanes below.  A row wholly
// inside the tile stores its counts once; a row cut by a tile end adds
// the tile's partial sums by integer atomics into counts the launch
// zeroes first on the same stream (integer sums: the order does not
// matter), which it does only where a tile end can cut a row (kTile %
// S != 0).  Offsets inside a tile are 32-bit, tile bases 64-bit.
//
// The optional admit plane (int32 [rows, S], JAX `receive_fused`'s
// `admit_mask` operand) is a second instantiation: one more span per
// tile, where a 0 entry suppresses that slot's delivered mail.  A null
// plane launches the form without it.

#include <cstdint>

#include "receive_one.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;                  // entries a block
constexpr int kPerThread = kTile / kThreads;
constexpr int kMinBlocks = 4;                // blocks an SM, 64 registers
static_assert(kTile % 16 == 0 && kTile % kThreads == 0, "tile shape");
// A plane's span: kTile 4-byte entries widened to 16-byte bounds.
constexpr int kPlaneWords = kTile + 8;
constexpr int kChunks = (kPlaneWords / 4 + kThreads - 1) / kThreads;

__host__ __device__ constexpr int planes(bool admit) {
    return admit ? 5 : 4;
}
// The planes' spans, then per row of the tile (at most kTile): the self
// slot, the self entry and the packed counts (ints) and the flags (byte).
__host__ __device__ constexpr int smem_bytes(bool admit) {
    return planes(admit) * kPlaneWords * 4 + kTile * (4 + 4 + 4 + 1);
}

struct Args {
    unsigned* view;
    int* view_ts;
    unsigned* mail;
    const unsigned* cand;
    const int* admit;                // or null
    const unsigned char* recv;
    const unsigned char* act;
    const unsigned char* self_on;
    const unsigned* self_pack;
    unsigned char* join;
    int* rm_ids;
    int* numfailed;                  // zeroed first where rows are cut
    int* size;                       // zeroed first where rows are cut
    long long total;                 // rows * S
    long long row0;
    Magic n_magic, s_magic;          // remainders by n and by s
    int t, tfail, tremove, s, stride_mod;
};

// Entries between entry `e` of the int32 plane at `p` and the 16-byte
// bound below it.
__device__ __forceinline__ int lead_at(const void* p, long long e) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(p) / 4
                             + static_cast<unsigned long long>(e)) & 3);
}

// slot_of(node, node) = ((node % S) * ((1 + STRIDE) % S)) % S; `ms` is a
// Magic for S.
__device__ __forceinline__ int self_slot(long long node, int s,
                                         int stride_mod, const Magic& ms) {
    if (node < (1LL << 32) && s <= 0xffff)   // the product fits 32 bits
        return static_cast<int>(ms.mod(
            ms.mod(static_cast<unsigned>(node))
            * static_cast<unsigned>(stride_mod)));
    return static_cast<int>(node % s * stride_mod % s);
}

// A tile's input spans in shared memory, each at its tile entry 0.
struct Stage {
    const unsigned* view;
    const int* ts;
    const unsigned* mail;
    const unsigned* cand;
    const int* admit;
};

// A tile's outputs in device memory, each at its tile entry 0.
struct Out {
    unsigned* view;
    int* ts;
    unsigned* mail;
    int* rm;
    unsigned char* join;
};

// A tile's row context: self slot, flags (recv | act << 1 | son << 2),
// self entry; rows local to the tile.
struct Rows {
    const int* slot;
    const unsigned char* flag;
    const unsigned* pack;
    long long node0;                 // the tile's first row's node
    int rows;
};

__device__ __forceinline__ void set_row(RowCtx& r, const Rows& rw, int row) {
    const unsigned f = rw.flag[row];
    r.node = static_cast<unsigned>(rw.node0 + row);
    r.self_slot = rw.slot[row];
    r.spack = rw.pack[row];
    r.recv = f & 1;
    r.act = (f >> 1) & 1;
    r.son = (f >> 2) & 1;
}

// Adds the lanes' counts to cnt[row] where rows are shorter than a warp
// step (S < 32): an inclusive prefix sum over the lanes, of which the
// last lane of each row's run (column S - 1, or lane 31) adds the run's
// part, its prefix less the one before the run's first lane.
__device__ __forceinline__ void add_runs(int* cnt, int rows, unsigned row,
                                         unsigned col, unsigned s, int c,
                                         int lane) {
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(DM_FULL_MASK, x, o);
        if (lane >= o) x += y;
    }
    const int first = col < static_cast<unsigned>(lane)
                      ? lane - static_cast<int>(col) : 0;
    const int before = __shfl_sync(DM_FULL_MASK, x, first > 0 ? first - 1
                                                              : 0);
    const int sum = first > 0 ? x - before : x;
    if ((lane == 31 || col == s - 1) && sum
        && row < static_cast<unsigned>(rows))
        atomicAdd(cnt + row, sum);
}

// Adds the lanes' counts of row qa (lo) and row qa + 1 (hi): two warp
// reductions.
__device__ __forceinline__ void add_two(int* cnt, int qa, int lo, int hi,
                                        int lane) {
    lo = __reduce_add_sync(DM_FULL_MASK, lo);
    hi = __reduce_add_sync(DM_FULL_MASK, hi);
    if (lane == 0) {
        if (lo) atomicAdd(cnt + qa, lo);
        if (hi) atomicAdd(cnt + qa + 1, hi);
    }
}

// The receive pass over a tile: thread gt takes entries gt, gt +
// kThreads, ... and stores its outputs; then the counts, a warp step
// (32 consecutive entries) at a time, summed per row.
template <bool kAdmit>
__device__ __forceinline__ void compute(const Stage& sp, const Out& out,
                                        const Rows& rw, RowCtx r, int* cnt,
                                        int s, unsigned c0, int words,
                                        int gt) {
    const int lane = gt & 31;
    const unsigned us = static_cast<unsigned>(s);
    const unsigned drow = kThreads / us, dcol = kThreads % us;
    const unsigned x = c0 + gt;
    const unsigned row_first = x / us, col_first = x - row_first * us;
    unsigned row = row_first, col = col_first;
    // Entries past a ragged last tile are computed too, on the widened
    // spans' words or shared memory no load wrote (inside the spans: e <
    // kTile), but neither stored nor counted.
    int pk[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
        const int e = gt + i * kThreads;
        unsigned v = sp.view[e], m = sp.mail[e];
        int ts = sp.ts[e], rm;
        unsigned char jn;
        const bool admit = !kAdmit || sp.admit[e] != 0;
        set_row(r, rw, static_cast<int>(row));
        int stale = 0, occ = 0;
        receive_one(r, static_cast<int>(col), v, ts, m, sp.cand[e], jn, rm,
                    stale, occ, admit);
        if (e < words) {
            out.view[e] = v;
            out.ts[e] = ts;
            out.mail[e] = m;
            out.rm[e] = rm;
            out.join[e] = jn;
        }
        pk[i] = e < words ? stale | occ << 16 : 0;  // each <= kTile a tile
        col += dcol;
        row += drow;
        if (col >= us) {
            col -= us;
            ++row;
        }
    }
    row = row_first;
    col = col_first;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
        if (s >= 32) {               // a step's 32 entries: two rows at most
            const unsigned qa = __shfl_sync(DM_FULL_MASK, row, 0);
            add_two(cnt, static_cast<int>(qa), row == qa ? pk[i] : 0,
                    row == qa ? 0 : pk[i], lane);
        } else {
            add_runs(cnt, rw.rows, row, col, us, pk[i], lane);
        }
        col += dcol;
        row += drow;
        if (col >= us) {
            col -= us;
            ++row;
        }
    }
}

template <bool kAdmit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
receive_tiles(const Args a) {
    constexpr int kP = planes(kAdmit);
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned* span = reinterpret_cast<unsigned*>(smem);
    int* slots = reinterpret_cast<int*>(span + kP * kPlaneWords);
    unsigned* packs = reinterpret_cast<unsigned*>(slots + kTile);
    int* cnt = slots + 2 * kTile;
    unsigned char* flags = reinterpret_cast<unsigned char*>(cnt + kTile);
    const int tid = threadIdx.x;
    const int s = a.s;
    const long long e0 = static_cast<long long>(blockIdx.x) * kTile;
    const long long r0 = e0 / s;
    const unsigned c0 = static_cast<unsigned>(e0 - r0 * s);
    const long long left = a.total - e0;
    const int words = static_cast<int>(left < kTile ? left : kTile);
    const int nrows = static_cast<int>(
        (c0 + words - 1) / static_cast<unsigned>(s) + 1);

    // The planes' spans: 16-byte loads into registers, the row context
    // staged meanwhile, then into shared memory.
    const unsigned* src[5] = {a.view,
                              reinterpret_cast<const unsigned*>(a.view_ts),
                              a.mail, a.cand,
                              reinterpret_cast<const unsigned*>(a.admit)};
    int lead[kP], chunks[kP];
    uint4 buf[kP][kChunks];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
        lead[p] = lead_at(src[p], e0);
        chunks[p] = (lead[p] + words + 3) / 4;
        const uint4* from = reinterpret_cast<const uint4*>(
            src[p] + e0 - lead[p]);
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
            const int c = tid + j * kThreads;
            if (c < chunks[p]) buf[p][j] = from[c];
        }
    }
    for (int i = tid; i < nrows; i += kThreads) {
        const long long row = r0 + i;
        slots[i] = self_slot(a.row0 + row, s, a.stride_mod, a.s_magic);
        packs[i] = a.self_pack[row];
        flags[i] = static_cast<unsigned char>(
            (a.recv[row] != 0) | ((a.act[row] != 0) << 1)
            | ((a.self_on[row] != 0) << 2));
        cnt[i] = 0;
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) {
        uint4* to = reinterpret_cast<uint4*>(span + p * kPlaneWords);
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
            const int c = tid + j * kThreads;
            if (c < chunks[p]) to[c] = buf[p][j];
        }
    }
    __syncthreads();

    const Stage sp{span + lead[0],
                   reinterpret_cast<const int*>(span + kPlaneWords) + lead[1],
                   span + 2 * kPlaneWords + lead[2],
                   span + 3 * kPlaneWords + lead[3],
                   kAdmit ? reinterpret_cast<const int*>(
                                span + 4 * kPlaneWords) + lead[kP - 1]
                          : nullptr};
    const Out out{a.view + e0, a.view_ts + e0, a.mail + e0, a.rm_ids + e0,
                  a.join + e0};
    const Rows rw{slots, flags, packs, a.row0 + r0, nrows};
    RowCtx r;
    r.t = a.t;
    r.tfail = a.tfail;
    r.tremove = a.tremove;
    r.n = a.n_magic;
    compute<kAdmit>(sp, out, rw, r, cnt, s, c0, words, tid);
    __syncthreads();                 // the counts are in

    // A row wholly inside the tile stores its counts, a row cut by a tile
    // end adds its part.
    for (int i = tid; i < nrows; i += kThreads) {
        const int c = cnt[i];
        const long long at = r0 + i;
        const long long lo = static_cast<long long>(i) * s - c0;
        if (lo >= 0 && lo + s <= words) {
            a.numfailed[at] = c & 0xffff;
            a.size[at] = c >> 16;
        } else {
            if (c & 0xffff) atomicAdd(a.numfailed + at, c & 0xffff);
            if (c >> 16) atomicAdd(a.size + at, c >> 16);
        }
    }
}

template <bool kAdmit>
int launch(const Args& a, long long tiles, cudaStream_t st) {
    auto kernel = receive_tiles<kAdmit>;
    const int smem = smem_bytes(kAdmit);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return static_cast<int>(err);
    }
    kernel<<<static_cast<unsigned>(tiles), kThreads, smem, st>>>(a);
    return dm_launch_status();
}

}  // namespace

// Any S > 0; every plane contiguous and 4-byte aligned (the Python wrapper
// checks both); `admit` may be null.  Where a tile end can cut a row,
// zeroes numfailed and size on `stream` first; then launches.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for S <= 0, N == 0 or more
// tiles than a grid holds.
extern "C" int dm_receive(int t, unsigned n, int s, int tfail, int tremove,
                          int stride, long long row0, int rows,
                          unsigned* view, int* view_ts, unsigned* mail,
                          const unsigned* cand, const unsigned char* recv,
                          const unsigned char* act,
                          const unsigned char* self_on,
                          const unsigned* self_pack, unsigned char* join,
                          int* rm_ids, int* numfailed, int* size,
                          const int* admit, void* stream) {
    if (s <= 0 || n == 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (rows <= 0) return dm_launch_status();
    const long long total = static_cast<long long>(rows) * s;
    const long long tiles = (total + kTile - 1) / kTile;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    if (kTile % s != 0 && tiles > 1) {   // a tile end cuts rows
        const size_t bytes = static_cast<size_t>(rows) * sizeof(int);
        cudaError_t err = cudaMemsetAsync(numfailed, 0, bytes, st);
        if (err == cudaSuccess) err = cudaMemsetAsync(size, 0, bytes, st);
        if (err != cudaSuccess) {
            cudaGetLastError();
            return static_cast<int>(err);
        }
    }
    Args a;
    a.view = view;
    a.view_ts = view_ts;
    a.mail = mail;
    a.cand = cand;
    a.admit = admit;
    a.recv = recv;
    a.act = act;
    a.self_on = self_on;
    a.self_pack = self_pack;
    a.join = join;
    a.rm_ids = rm_ids;
    a.numfailed = numfailed;
    a.size = size;
    a.total = total;
    a.row0 = row0;
    a.n_magic = magic_of(n);
    a.s_magic = magic_of(static_cast<unsigned>(s));
    a.t = t;
    a.tfail = tfail;
    a.tremove = tremove;
    a.s = s;
    a.stride_mod = static_cast<int>((1LL + stride) % s);
    return admit != nullptr ? launch<true>(a, tiles, st)
                            : launch<false>(a, tiles, st);
}
