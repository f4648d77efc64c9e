// The tiled body of the three circulant gossip kernels: K2 (gossip.cu),
// K4 (gossip_stacked.cu) and K6 (gossip_folded.cu).
//
// All compute, for every shard d of L rows and every shift j < k_max,
//   mail[d][l] = max(mail[d][l],
//                    rotate(gate_j(payload_j)[d][(l - c_j) mod L], s_j(l)))
// where rotate moves a row s columns to the right, s_j(l) is s1[d][j] for
// the rows l >= c_j (or always, with single_col) and s2[d][j] for the
// wrapped rows l < c_j, and the max is unsigned.  K2 is the case D = 1,
// L = N.  K6 runs on the natural [N, S] view of the folded
// [N * S / 128, 128] planes (S | 128), D shards of whole plane rows: c_j
// is the node shift thr_j and s1/s2 the slot shifts c1/c2.  The gate is none (pre-masked
// payloads), `j < k_eff[sender row]` or `masks[j][sender entry] != 0`; the
// payload is one plane shared by all shifts or one plane per shift.
//
// Tile walk.  A block owns R = kTileWords / S consecutive receiver rows of
// one shard (the last tile of a shard is ragged, so no tile straddles two
// shards) and walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...: the
// grid is as many blocks as the card holds at once.  For shift j the
// tile's senders are the R rows from (l0 - c_j) mod L on, at most two
// contiguous runs split where the shard wraps; that split is also where
// the column shift changes from s2 to s1, because receiver row c_j reads
// sender row 0.  Each run is one span of device memory.  A bulk copy
// takes 16-byte aligned addresses and sizes, which a run of S < 4 words
// (payload) or S < 16 bytes (masks) per row need not have: each run is
// widened to 16-byte bounds (its start rounded down, its end up) and the
// stage read `lead` entries in.  A wrapped run ends at its shard's end,
// which is aligned (L * S % 16 == 0), so the second run lands aligned
// right behind it; the widened runs never leave the plane.  At S % 128 ==
// 0 nothing is widened.
//
// Stages.  A tile is a sequence of 1 + k_max items: its own mail rows,
// then one item per shift (the sender runs of the payload and, in the
// masks form, of the masks).  Items land in a ring of kStages
// shared-memory stages by 1-D bulk copies (`cp.async.bulk`, the TMA's
// tensor-map-free form), each completing on its stage's mbarrier; the
// k_eff gate of a shift's R sender rows rides the same barrier as 4-byte
// `cp.async` copies.  Warp 0 refills a stage with item k + kStages as soon
// as every thread is done with item k, so kStages - 1 items (up to 60 KiB
// per block) are in flight while one is merged, across tile boundaries.
// One stage holds one shift, so shared memory does not grow with k_max.
//
// Merge.  Thread t takes the tile's words t, t + 256, ...: a warp takes 32
// consecutive words (one row's columns, or 32 / S whole rows) and keeps
// their max in registers.  Lane column c reads sender column (c - s) mod
// S of the staged row, a cyclic rotation within each row, so a warp's 32
// reads are 32 consecutive staged words: 32 distinct banks.
// The mail tile is read once (the first item) and written once, from a
// shared-memory buffer by one bulk store.  Index arithmetic inside a tile
// is 32-bit; only the tile's base offsets are 64-bit.
//
// Wide rows.  A tile holds at least one row, so the tiled body takes S <=
// kTileWords.  Wider rows (S % 128 == 0 and S > 4096: the full membership
// list past 4096 nodes) take `run_wide`, a simple body with the same
// arithmetic and no staging: each thread owns mail words e, e + the grid's
// threads, ..., and per shift reads its sender word straight from device
// memory (row (l - c_j) mod L of its shard, column (c - s_j(l)) mod S), so
// a warp's 32 reads are 32 consecutive words of one sender row, split at
// most once where the column rotation wraps.  It moves what the tiled body
// moves, (2 + k_max) planes plus the gates, through L2 instead of shared
// memory.  All its indices are 64-bit.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace dm_tile {

constexpr int kThreads = 256;
constexpr int kTileWords = 4096;                 // R * S <= 4096: 16 KiB
constexpr int kPerThread = kTileWords / kThreads;
constexpr int kMaxRows = kTileWords / 128;       // R of the k_eff gate
constexpr int kMaxShifts = 64;
constexpr int kMaxS = kTileWords;                // R >= 1
constexpr int kStages = 4;
constexpr int kBarBytes = 128;                   // the stages' mbarriers
// A stage holds a tile's words plus the widening of its runs (up to 3
// words or 15 mask bytes before, and as many after each of two runs).
constexpr int kStageWords = kTileWords + 32;
constexpr int kStageMaskBytes = kTileWords + 128;

enum class Gate { kNone, kKeff, kMask };

// Per-shift scalars, in static shared memory: c_j as given, c_j mod L,
// and the column shifts s1/s2 (mod S) of the current tile's shard.
struct Shifts {
    int c[kMaxShifts];
    int cl[kMaxShifts];
    int s1[kMaxShifts];
    int s2[kMaxShifts];
};

struct TileArgs {
    unsigned* mail;                  // [D * L, S]
    const unsigned* payload;         // plane 0 of [1 or k_max, D * L, S]
    const unsigned char* masks;      // [k_max, D * L, S] or null
    const int* k_eff;                // [D * L] or null
    const int* s1;                   // [D, k_max], or null when Shifts
    const int* s2;                   //   already holds the column shifts
    long long plane;                 // D * L * S
    int s, n_local, k_max, tile_rows, tiles_per_shard, n_tiles;
    bool single_col;
};

// Dynamic shared memory of one block: barriers, the stages' payload rows,
// the output buffer, then the stages' mask rows or k_eff values.
constexpr int kOutOffset = kBarBytes + kStages * kStageWords * 4;
constexpr int kTailOffset = kOutOffset + kTileWords * 4;
constexpr int smem_bytes(Gate g) {
    return kTailOffset + (g == Gate::kMask ? kStages * kStageMaskBytes : 0)
           + (g == Gate::kKeff ? kStages * kMaxRows * 4 : 0);
}

__device__ __forceinline__ int mod(int v, int m) {
    const int r = v % m;
    return r < 0 ? r + m : r;
}

// Offset of entry `e` of a plane from the 16-byte bound below it, for
// entries of `bytes` bytes (mod 2^32 is enough: only the low bits count).
__device__ __forceinline__ int lead_of(long long e, int bytes) {
    return static_cast<int>(static_cast<unsigned>(e) & (16 / bytes - 1));
}

// ---- PTX wrappers: mbarrier, bulk copies, cp.async ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces `bytes` of bulk copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of `parity` to complete.  A phase that never
// completes is a fault: the kernel traps (a launch error) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    for (unsigned spins = 0;; ++spins) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (done) return;
        if (spins == (1u << 26)) __trap();
    }
}

// Device memory to shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// Shared memory to device memory, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// This thread's bulk stores have read their shared memory (may reuse it).
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Orders this thread's shared-memory writes before a later bulk copy
// reads them.
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies land
// (counted in the barrier's init count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];"
                 :: "r"(smem_u32(bar)) : "memory");
}

// ---- the tile loop ----

struct Tile {
    int d, l0, rows;
    long long base;                  // the shard's first row
};

__device__ __forceinline__ Tile tile_of(const TileArgs& a, int tile) {
    Tile t;
    t.d = tile / a.tiles_per_shard;
    t.l0 = (tile - t.d * a.tiles_per_shard) * a.tile_rows;
    t.rows = min(a.tile_rows, a.n_local - t.l0);
    t.base = static_cast<long long>(t.d) * a.n_local;
    return t;
}

// Warp 0: start item k (tile k / (1 + k_max), part p = k mod (1 + k_max):
// the mail rows for p = 0, shift p - 1 otherwise) into stage k % kStages.
template <Gate G, bool kShared>
__device__ __forceinline__ void stage_item(const TileArgs& a,
                                           const Shifts& sh,
                                           unsigned char* smem, int k,
                                           int lane) {
    const int per_tile = 1 + a.k_max;
    const int t = k / per_tile;
    const int p = k - t * per_tile;
    const Tile tl = tile_of(a, blockIdx.x + t * gridDim.x);
    const int st = k % kStages;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + st;
    unsigned* pay = reinterpret_cast<unsigned*>(smem + kBarBytes)
                    + st * kStageWords;
    const int s = a.s;
    const unsigned words = static_cast<unsigned>(tl.rows * s);
    if (p == 0) {
        if (G == Gate::kKeff) cp_async_arrive(bar);
        if (lane == 0) {
            mbar_expect_tx(bar, words * 4);
            bulk_load(pay, a.mail + (tl.base + tl.l0) * s, words * 4, bar);
        }
        return;
    }
    const int j = p - 1;
    int src0 = tl.l0 - sh.cl[j];
    if (src0 < 0) src0 += a.n_local;
    const int first = min(tl.rows, a.n_local - src0);   // rows before the wrap
    unsigned char* tail = smem + kTailOffset;
    if (G == Gate::kKeff) {
        if (lane < tl.rows) {
            int r = src0 + lane;
            if (r >= a.n_local) r -= a.n_local;
            cp_async4(reinterpret_cast<int*>(tail) + st * kMaxRows + lane,
                      a.k_eff + tl.base + r);
        }
        cp_async_arrive(bar);
    }
    if (lane != 0) return;
    // The runs in entries of the plane: [e0, e0 + a_words) and, past the
    // wrap, [eb, eb + b_words), each widened to 16-byte bounds.
    const long long e0 = (tl.base + src0) * s, eb = tl.base * s;
    const unsigned a_words = static_cast<unsigned>(first * s);
    const unsigned b_words = words - a_words;
    const unsigned* plane = a.payload + (kShared ? 0 : j * a.plane);
    const int lw = lead_of(e0, 4), lm = lead_of(e0, 1);
    const unsigned aw = (lw + a_words + 3) & ~3u, bw = (b_words + 3) & ~3u;
    const unsigned am = (lm + a_words + 15) & ~15u, bm = (b_words + 15) & ~15u;
    mbar_expect_tx(bar, (aw + bw) * 4 + (G == Gate::kMask ? am + bm : 0));
    bulk_load(pay, plane + e0 - lw, aw * 4, bar);
    if (b_words) bulk_load(pay + aw, plane + eb, bw * 4, bar);
    if (G == Gate::kMask) {
        const unsigned char* mp = a.masks + j * a.plane;
        unsigned char* md = tail + st * kStageMaskBytes;
        bulk_load(md, mp + e0 - lm, am, bar);
        if (b_words) bulk_load(md + am, mp + eb, bm, bar);
    }
}

// The whole kernel after its prologue has filled `sh` (c and cl always;
// s1/s2 too when a.s1 is null).  Launch with kThreads threads and
// smem_bytes(G) bytes of dynamic shared memory.
template <Gate G, bool kShared>
__device__ __forceinline__ void run(const TileArgs& a, Shifts& sh) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    const unsigned* pay = reinterpret_cast<const unsigned*>(smem + kBarBytes);
    unsigned* out = reinterpret_cast<unsigned*>(smem + kOutOffset);
    const unsigned char* tail = smem + kTailOffset;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int s = a.s;

    if (tid == 0) {
        for (int st = 0; st < kStages; ++st)
            mbar_init(full + st, G == Gate::kKeff ? 33 : 1);
        mbar_init_fence();
    }
    __syncthreads();                 // barriers and the prologue's `sh`

    const int bid = static_cast<int>(blockIdx.x);
    const int my_tiles = a.n_tiles > bid
        ? (a.n_tiles - 1 - bid) / static_cast<int>(gridDim.x) + 1 : 0;
    const int n_items = my_tiles * (1 + a.k_max);
    if (warp == 0)
        for (int k = 0; k < kStages && k < n_items; ++k)
            stage_item<G, kShared>(a, sh, smem, k, lane);

    // This thread's words tid + kThreads * m: row and column of m = 0,
    // and the step from one m to the next (drow rows and dcol columns).
    const int row0 = tid / s, col0 = tid - (tid / s) * s;
    const int drow = kThreads / s, dcol = kThreads - drow * s;
    unsigned acc[kPerThread];
    int k = 0;
    for (int t = 0; t < my_tiles; ++t) {
        const Tile tl = tile_of(a, bid + t * static_cast<int>(gridDim.x));
        const int words = tl.rows * s;

        // Item 1 of the tile: its mail rows.
        mbar_wait(full + k % kStages, (k / kStages) & 1);
        {
            const unsigned* m = pay + (k % kStages) * kStageWords;
#pragma unroll
            for (int i = 0; i < kPerThread; ++i) {
                const int e = tid + i * kThreads;
                acc[i] = e < words ? m[e] : 0u;
            }
        }
        if (a.s1 != nullptr && tid < a.k_max) {
            const int at = tl.d * a.k_max + tid;
            sh.s1[tid] = mod(a.s1[at], s);
            sh.s2[tid] = mod(a.s2[at], s);
        }
        __syncthreads();
        if (warp == 0 && k + kStages < n_items)
            stage_item<G, kShared>(a, sh, smem, k + kStages, lane);
        ++k;

        // One item per shift: merge the staged sender rows.
        for (int j = 0; j < a.k_max; ++j) {
            const int st = k % kStages;
            // Tile rows below `wrap` are the wrapped receivers l < c_j.
            const long long w = static_cast<long long>(sh.c[j]) - tl.l0;
            const int wrap = a.single_col ? 0
                : static_cast<int>(w < 0 ? 0 : (w > tl.rows ? tl.rows : w));
            const int sh1 = sh.s1[j], sh2 = sh.s2[j];
            // Where the stage's widened runs put the tile's first sender.
            int src0 = tl.l0 - sh.cl[j];
            if (src0 < 0) src0 += a.n_local;
            const long long e0 = (tl.base + src0) * s;
            mbar_wait(full + st, (k / kStages) & 1);
            const unsigned* src = pay + st * kStageWords + lead_of(e0, 4);
            const unsigned char* msk = tail + st * kStageMaskBytes
                                       + lead_of(e0, 1);
            const int* keff = reinterpret_cast<const int*>(tail)
                              + st * kMaxRows;
            int row = row0, col = col0;
#pragma unroll
            for (int i = 0; i < kPerThread; ++i) {
                if (tid + i * kThreads < words) {
                    int sc = col - (row < wrap ? sh2 : sh1);
                    if (sc < 0) sc += s;
                    const int at = row * s + sc;
                    bool keep = true;
                    if (G == Gate::kMask) keep = msk[at] != 0;
                    if (G == Gate::kKeff) keep = j < keff[row];
                    const unsigned v = keep ? src[at] : 0u;
                    acc[i] = v > acc[i] ? v : acc[i];
                }
                col += dcol;
                row += drow;
                if (col >= s) {
                    col -= s;
                    ++row;
                }
            }
            // The last shift's sync also frees `out` for this tile: the
            // previous tile's store has read it.
            if (j == a.k_max - 1 && tid == 0) bulk_wait_read();
            __syncthreads();
            if (warp == 0 && k + kStages < n_items)
                stage_item<G, kShared>(a, sh, smem, k + kStages, lane);
            ++k;
        }

        // Write the tile back: registers -> `out` -> one bulk store.
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
            const int e = tid + i * kThreads;
            if (e < words) out[e] = acc[i];
        }
        fence_async_shared();
        __syncthreads();
        if (tid == 0)
            bulk_store(a.mail + (tl.base + tl.l0) * s, out,
                       static_cast<unsigned>(words) * 4);
    }
    if (tid == 0) bulk_wait();
}

// The wide-row body (see the header): every mail word of the D shards of
// a.n_local rows, a.plane words in all.  `sh` holds c and cl, and s1/s2
// unless a.s1 is given ([D, k_max], read per word and shift).
template <Gate G, bool kShared>
__device__ __forceinline__ void run_wide(const TileArgs& a,
                                         const Shifts& sh) {
    const long long s = a.s, n_local = a.n_local;
    const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         e < a.plane; e += step) {
        const long long row = e / s;
        const int col = static_cast<int>(e - row * s);
        const int d = static_cast<int>(row / n_local);
        const long long base = d * n_local;
        const int l = static_cast<int>(row - base);
        unsigned acc = a.mail[e];
        for (int j = 0; j < a.k_max; ++j) {
            int src = l - sh.cl[j];
            if (src < 0) src += a.n_local;
            const bool unwrapped = a.single_col || l >= sh.c[j];
            int shift;
            if (a.s1 != nullptr) {
                const int at = d * a.k_max + j;
                shift = mod(unwrapped ? a.s1[at] : a.s2[at], a.s);
            } else {
                shift = unwrapped ? sh.s1[j] : sh.s2[j];
            }
            int sc = col - shift;
            if (sc < 0) sc += a.s;
            const long long at = (base + src) * s + sc;
            bool keep = true;
            if (G == Gate::kMask) keep = a.masks[j * a.plane + at] != 0;
            if (G == Gate::kKeff) keep = j < a.k_eff[base + src];
            if (keep) {
                const unsigned v = a.payload[(kShared ? 0 : j * a.plane)
                                             + at];
                acc = v > acc ? v : acc;
            }
        }
        a.mail[e] = acc;
    }
}

// Host side: launch a wide-row `kernel` (no dynamic shared memory) on as
// many blocks as the card holds at once, at most one per kThreads words.
template <typename... P, typename... A>
int launch_wide(void (*kernel)(P...), long long words, void* stream,
                A... args) {
    unsigned grid = 0;
    const int rc = dm_persistent_grid(kernel, kThreads, 0,
                                      (words + kThreads - 1) / kThreads,
                                      &grid);
    if (rc != 0) return rc;
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        args...);
    return dm_launch_status();
}

// Host side: launch `kernel` on a grid of as many blocks as the card holds
// at once (at most one per tile), with smem_bytes(G) of shared memory.
template <Gate G, typename... P, typename... A>
int launch(void (*kernel)(P...), int n_tiles, void* stream, A... args) {
    const int smem = smem_bytes(G);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return static_cast<int>(err);
    }
    unsigned grid = 0;
    const int rc = dm_persistent_grid(kernel, kThreads, smem, n_tiles, &grid);
    if (rc != 0) return rc;
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        args...);
    return dm_launch_status();
}

// Host side: the tile geometry of `a` for `shards` shards of a.n_local
// rows (a.s and a.n_local set).
inline void set_tiles(TileArgs& a, int shards) {
    a.tile_rows = kTileWords / a.s;
    a.tiles_per_shard = (a.n_local + a.tile_rows - 1) / a.tile_rows;
    a.n_tiles = shards * a.tiles_per_shard;
}

// K4 and K6: the row shifts c[j] come from device memory, the column
// shifts from a.s1/a.s2 ([D, k_max], read once per tile).
template <Gate G, bool kShared>
__global__ void __launch_bounds__(kThreads)
stacked_kernel(TileArgs a, const int* __restrict__ c) {
    __shared__ Shifts sh;
    for (int j = threadIdx.x; j < a.k_max; j += kThreads) {
        sh.c[j] = c[j];
        sh.cl[j] = mod(c[j], a.n_local);
    }
    run<G, kShared>(a, sh);
}

// K4 on rows wider than one tile: run_wide with the column shifts read
// from a.s1/a.s2.
template <Gate G, bool kShared>
__global__ void __launch_bounds__(kThreads)
stacked_wide_kernel(TileArgs a, const int* __restrict__ c) {
    __shared__ Shifts sh;
    for (int j = threadIdx.x; j < a.k_max; j += kThreads) {
        sh.c[j] = c[j];
        sh.cl[j] = mod(c[j], a.n_local);
    }
    __syncthreads();
    run_wide<G, kShared>(a, sh);
}

// Host side: stacked_kernel (stacked_wide_kernel when a row is wider than
// a tile) for one payload plane shared by every shift or one plane per
// shift.
template <Gate G>
int launch_stacked(const TileArgs& a, const int* c, bool shared,
                   void* stream) {
    if (a.s > kMaxS)
        return shared
            ? launch_wide(&stacked_wide_kernel<G, true>, a.plane, stream,
                          a, c)
            : launch_wide(&stacked_wide_kernel<G, false>, a.plane, stream,
                          a, c);
    return shared
        ? launch<G>(&stacked_kernel<G, true>, a.n_tiles, stream, a, c)
        : launch<G>(&stacked_kernel<G, false>, a.n_tiles, stream, a, c);
}

}  // namespace dm_tile
