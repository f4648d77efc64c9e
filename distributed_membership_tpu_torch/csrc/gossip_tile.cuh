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
// is the node shift thr_j and s1/s2 the slot shifts c1/c2.  The gate is
// none (pre-masked payloads), `j < k_eff[sender row]` or
// `masks[j][sender entry] != 0`; the payload is one plane shared by all
// shifts or one plane per shift.
//
// Tile walk.  A block owns R = kTileWords / S consecutive receiver rows of
// one shard (at most kKeffRows in the k_eff form; the last tile of a
// shard is ragged, so no tile straddles two shards) and walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...: the grid is as many blocks as
// the card holds at once.  For shift j the tile's senders are the R rows
// from (l0 - c_j) mod L on, at most two contiguous runs split where the
// shard wraps; that split is also where the column shift changes from s2
// to s1, because receiver row c_j reads sender row 0.  Each run is one
// span of device memory.  A bulk copy takes 16-byte aligned addresses and
// sizes, which a run need not have at any S % 4 != 0 (payload words) or S
// % 16 != 0 (mask bytes), nor where a shard's rows end off a bound (L * S
// % 4 != 0): each run, and the tile's own mail span, is widened to 16-byte
// bounds (its start rounded down, its end up) and read `lead` entries in.
// The second run lands at the next bound behind the first, with a lead of
// its own, so the merge adds that gap to the rows past the wrap (0 where
// the first run ends on a bound, as at S % 128 == 0).  A widened span
// reads at most 15 bytes past a run's ends, inside the 16-byte block of
// the run's first or last byte: inside the allocation, whatever the
// shapes; the entries read there are never used.
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
// The mail tile is read once (the first item) and written once: its
// 16-byte aligned interior from a shared-memory buffer by one bulk store,
// the up to 3 words before the interior's first bound and after its last
// by plain stores (a bulk store of the widened span would write the
// neighbouring tiles' words).  Index arithmetic inside a tile is 32-bit;
// only the tile's base offsets are 64-bit.
//
// Wide rows.  A row wider than one tile (S > 4096: the full membership
// list past 4096 nodes) is cut into chunks of kTileWords columns, the
// last one ragged, and a wide tile is one chunk [col0, col0 + C) of one
// receiver row l: the same walk, stage ring and merge over the
// D * L * ceil(S / C) tiles.  Its sender for shift j is row (l - c_j) mod
// L, columns (col0 - s_j(l)) mod S on: at most two runs, split at the
// sender row's end, each widened to 16-byte bounds as above, the second
// at the bound behind the first.  The stage holds the sender entries in
// receiver column order, and the merge is acc[i] = max(acc[i],
// stage[lead + i (+ the gap past the first run)]): no rotation, no bank
// conflict.
// s_j(l) and the gate `j < k_eff[sender row]` are one value per item.
// Warp 0 loads them (K4's column shifts from a.s1/a.s2, the gate from
// k_eff) into registers when it stages the tile's mail item and reads
// them an item or more later, when it stages the shift's; a closed gate
// issues no copy and only arrives on the stage's barrier (no bytes), and
// the stage's `meta` word tells the merge what the item holds.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace dm_tile {

constexpr int kThreads = 256;
constexpr int kTileWords = 4096;                 // R * S <= 4096: 16 KiB
constexpr int kPerThread = kTileWords / kThreads;
constexpr int kKeffRows = 512;                   // most R of the k_eff gate
constexpr int kMaxShifts = 64;
constexpr int kMaxS = kTileWords;                // R >= 1
constexpr int kStages = 4;
constexpr int kBarBytes = 128;                   // the stages' mbarriers
// Behind the barriers, in the same 128 bytes: a wide tile's per-stage
// meta word (the sender's first column, or -1 for an item with no copy).
constexpr int kMetaOffset = kStages * 8;
static_assert(kMetaOffset + kStages * 4 <= kBarBytes, "meta words");
// A stage holds a tile's words plus the widening of its runs (up to 3
// words or 15 mask bytes before, and as many after each of two runs).
constexpr int kStageWords = kTileWords + 32;
constexpr int kStageMaskBytes = kTileWords + 128;
// The output buffer: a tile's words behind the lead of its mail span.
constexpr int kOutWords = kTileWords + 4;

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
    int chunks;                      // tiles per row: ceil(S / C) or 1
    bool single_col;
};

// Dynamic shared memory of one block: barriers, the stages' payload rows,
// the output buffer, then the stages' mask rows or k_eff values.
constexpr int kOutOffset = kBarBytes + kStages * kStageWords * 4;
constexpr int kTailOffset = kOutOffset + kOutWords * 4;
static_assert(kOutOffset % 16 == 0 && kTailOffset % 16 == 0,
              "bulk copies need 16-byte aligned shared memory");
constexpr int smem_bytes(Gate g) {
    return kTailOffset + (g == Gate::kMask ? kStages * kStageMaskBytes : 0)
           + (g == Gate::kKeff ? kStages * kKeffRows * 4 : 0);
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

// Entries a span of `count` entries `lead` entries past a 16-byte bound
// occupies once widened to bounds on both sides.
__device__ __forceinline__ unsigned widened(int lead, unsigned count,
                                            int bytes) {
    const unsigned q = 16 / bytes - 1;
    return (lead + count + q) & ~q;
}

// Where the second of two staged runs puts its entries, against the
// first run's entries continued: the second run starts at the bound
// behind the widened first one, `lead_of(eb)` entries in, while a row
// past the wrap would read `lead_of(e0) + a_count` entries in.  0 when
// the first run ends on a bound.
__device__ __forceinline__ int run_gap(long long e0, unsigned a_count,
                                       long long eb, int bytes) {
    const int la = lead_of(e0, bytes);
    return static_cast<int>(widened(la, a_count, bytes)) + lead_of(eb, bytes)
           - la - static_cast<int>(a_count);
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
    int col0, words;                 // first column and entries (wide: C)
    long long base;                  // the shard's first row
};

template <bool kWide>
__device__ __forceinline__ Tile tile_of(const TileArgs& a, int tile) {
    Tile t;
    t.d = tile / a.tiles_per_shard;
    const int r = tile - t.d * a.tiles_per_shard;
    if (kWide) {
        t.l0 = r / a.chunks;
        t.col0 = (r - t.l0 * a.chunks) * kTileWords;
        t.rows = 1;
        t.words = min(kTileWords, a.s - t.col0);
    } else {
        t.l0 = r * a.tile_rows;
        t.col0 = 0;
        t.rows = min(a.tile_rows, a.n_local - t.l0);
        t.words = t.rows * a.s;
    }
    t.base = static_cast<long long>(t.d) * a.n_local;
    return t;
}

// Lane 0 of warp 0: shift j's sender entries [e0, e0 + a_words) and, past
// a wrap, [eb, eb + b_words), each widened to 16-byte bounds, into stage
// st by bulk copies completing on its barrier, the second run at the
// bound behind the first; the masks form copies the same entries of
// masks[j].
template <Gate G, bool kShared>
__device__ __forceinline__ void load_runs(const TileArgs& a,
                                          unsigned char* smem, int st, int j,
                                          long long e0, unsigned a_words,
                                          long long eb, unsigned b_words) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + st;
    unsigned* pay = reinterpret_cast<unsigned*>(smem + kBarBytes)
                    + st * kStageWords;
    // Leads count from the buffers' bases: plane j starts j * a.plane
    // entries in, off a bound where a.plane is not a multiple of 16.
    const long long po = kShared ? 0 : j * a.plane, mo = j * a.plane;
    const unsigned* plane = a.payload + po;
    const int lw = lead_of(po + e0, 4), lm = lead_of(mo + e0, 1);
    const int lbw = lead_of(po + eb, 4), lbm = lead_of(mo + eb, 1);
    const unsigned aw = widened(lw, a_words, 4);
    const unsigned am = widened(lm, a_words, 1);
    const unsigned bw = b_words ? widened(lbw, b_words, 4) : 0u;
    const unsigned bm = b_words ? widened(lbm, b_words, 1) : 0u;
    mbar_expect_tx(bar, (aw + bw) * 4 + (G == Gate::kMask ? am + bm : 0));
    bulk_load(pay, plane + e0 - lw, aw * 4, bar);
    if (b_words) bulk_load(pay + aw, plane + eb - lbw, bw * 4, bar);
    if (G == Gate::kMask) {
        const unsigned char* mp = a.masks + mo;
        unsigned char* md = smem + kTailOffset + st * kStageMaskBytes;
        bulk_load(md, mp + e0 - lm, am, bar);
        if (b_words) bulk_load(md + am, mp + eb - lbm, bm, bar);
    }
}

// Lane 0 of warp 0: the tile's own mail span [e, e + words), widened to
// 16-byte bounds, into stage st.
__device__ __forceinline__ void load_mail(const TileArgs& a,
                                          unsigned char* smem, int st,
                                          long long e, unsigned words) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + st;
    unsigned* pay = reinterpret_cast<unsigned*>(smem + kBarBytes)
                    + st * kStageWords;
    const int lw = lead_of(e, 4);
    const unsigned w = widened(lw, words, 4);
    mbar_expect_tx(bar, w * 4);
    bulk_load(pay, a.mail + e - lw, w * 4, bar);
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
    const Tile tl = tile_of<false>(a, blockIdx.x + t * gridDim.x);
    const int st = k % kStages;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + st;
    const int s = a.s;
    const unsigned words = static_cast<unsigned>(tl.words);
    if (p == 0) {
        if (G == Gate::kKeff) cp_async_arrive(bar);
        if (lane == 0) load_mail(a, smem, st, (tl.base + tl.l0) * s, words);
        return;
    }
    const int j = p - 1;
    int src0 = tl.l0 - sh.cl[j];
    if (src0 < 0) src0 += a.n_local;
    const int first = min(tl.rows, a.n_local - src0);   // rows before the wrap
    if (G == Gate::kKeff) {
        int* keff = reinterpret_cast<int*>(smem + kTailOffset)
                    + st * kKeffRows;
        for (int i = lane; i < tl.rows; i += 32) {
            int r = src0 + i;
            if (r >= a.n_local) r -= a.n_local;
            cp_async4(keff + i, a.k_eff + tl.base + r);
        }
        cp_async_arrive(bar);
    }
    if (lane != 0) return;
    // The runs in entries of the plane: the rows from src0 up to the
    // shard's end, then from its first row.
    const unsigned a_words = static_cast<unsigned>(first * s);
    load_runs<G, kShared>(a, smem, st, j, (tl.base + src0) * s, a_words,
                          tl.base * s, words - a_words);
}

// Warp 0's per-shift values of the wide tile whose mail item it staged
// last: lane i holds those of shifts i and i + 32 (the k_eff gate of the
// sender row, and K4's column shifts as given).
struct Ahead {
    int keff[2], s1[2], s2[2];
};

// Warp 0: start item k of the wide walk into stage k % kStages (the
// mail chunk for p = 0, shift p - 1 otherwise), and write the stage's
// meta word for a shift.
template <Gate G, bool kShared>
__device__ __forceinline__ void stage_wide(const TileArgs& a,
                                           const Shifts& sh,
                                           unsigned char* smem, int k,
                                           int lane, Ahead& ah) {
    const int per_tile = 1 + a.k_max;
    const int t = k / per_tile;
    const int p = k - t * per_tile;
    const Tile tl = tile_of<true>(a, blockIdx.x + t * gridDim.x);
    const int st = k % kStages;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + st;
    const int s = a.s;
    if (p == 0) {
        // Loads whose values are first read when the shifts are staged.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int j = lane + 32 * h;
            if (j < a.k_max) {
                if (G == Gate::kKeff) {
                    int src = tl.l0 - sh.cl[j];
                    if (src < 0) src += a.n_local;
                    ah.keff[h] = a.k_eff[tl.base + src];
                }
                if (a.s1 != nullptr) {
                    ah.s1[h] = a.s1[tl.d * a.k_max + j];
                    ah.s2[h] = a.s2[tl.d * a.k_max + j];
                }
            }
        }
        if (lane == 0)
            load_mail(a, smem, st, (tl.base + tl.l0) * s + tl.col0,
                      static_cast<unsigned>(tl.words));
        return;
    }
    const int j = p - 1;
    // Shift j's value of a per-lane pair, from the lane that loaded it.
    auto shift_value = [&](const int (&v)[2]) {
        return __shfl_sync(DM_FULL_MASK, j >= 32 ? v[1] : v[0], j & 31);
    };
    int keff = 0, sh1, sh2;
    if (G == Gate::kKeff) keff = shift_value(ah.keff);
    if (a.s1 != nullptr) {
        sh1 = mod(shift_value(ah.s1), s);
        sh2 = mod(shift_value(ah.s2), s);
    } else {
        sh1 = sh.s1[j];
        sh2 = sh.s2[j];
    }
    if (lane != 0) return;
    int c0 = tl.col0 - (a.single_col || tl.l0 >= sh.c[j] ? sh1 : sh2);
    if (c0 < 0) c0 += s;
    const bool keep = G != Gate::kKeff || j < keff;
    reinterpret_cast<int*>(smem + kMetaOffset)[st] = keep ? c0 : -1;
    if (!keep) {
        mbar_expect_tx(bar, 0);      // completes the phase, no bytes
        return;
    }
    int src = tl.l0 - sh.cl[j];
    if (src < 0) src += a.n_local;
    const long long row = (tl.base + src) * s;
    const unsigned a_words = static_cast<unsigned>(min(tl.words, s - c0));
    load_runs<G, kShared>(a, smem, st, j, row + c0, a_words, row,
                          static_cast<unsigned>(tl.words) - a_words);
}

// The whole kernel after its prologue has filled `sh` (c and cl always;
// s1/s2 too when a.s1 is null).  Launch with kThreads threads and
// smem_bytes(G) bytes of dynamic shared memory; kWide for S > kMaxS.
template <Gate G, bool kShared, bool kWide>
__device__ __forceinline__ void run(const TileArgs& a, Shifts& sh) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    const int* meta = reinterpret_cast<const int*>(smem + kMetaOffset);
    const unsigned* pay = reinterpret_cast<const unsigned*>(smem + kBarBytes);
    unsigned* out = reinterpret_cast<unsigned*>(smem + kOutOffset);
    const unsigned char* tail = smem + kTailOffset;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int s = a.s;

    if (tid == 0) {
        for (int st = 0; st < kStages; ++st)
            mbar_init(full + st, G == Gate::kKeff && !kWide ? 33 : 1);
        mbar_init_fence();
    }
    __syncthreads();                 // barriers and the prologue's `sh`

    Ahead ah;
    auto stage = [&](int item) {
        if constexpr (kWide)
            stage_wide<G, kShared>(a, sh, smem, item, lane, ah);
        else
            stage_item<G, kShared>(a, sh, smem, item, lane);
    };
    const int bid = static_cast<int>(blockIdx.x);
    const int my_tiles = a.n_tiles > bid
        ? (a.n_tiles - 1 - bid) / static_cast<int>(gridDim.x) + 1 : 0;
    const int n_items = my_tiles * (1 + a.k_max);
    if (warp == 0)
        for (int k = 0; k < kStages && k < n_items; ++k) stage(k);

    // This thread's words tid + kThreads * m: row and column of m = 0,
    // and the step from one m to the next (drow rows and dcol columns).
    const int row0 = tid / s, col0 = tid - (tid / s) * s;
    const int drow = kThreads / s, dcol = kThreads - drow * s;
    unsigned acc[kPerThread];
    int k = 0;
    for (int t = 0; t < my_tiles; ++t) {
        const Tile tl =
            tile_of<kWide>(a, bid + t * static_cast<int>(gridDim.x));
        const int words = tl.words;
        const long long mb = (tl.base + tl.l0) * s + tl.col0;
        const int ml = lead_of(mb, 4);

        // Item 1 of the tile: its mail rows.
        mbar_wait(full + k % kStages, (k / kStages) & 1);
        {
            const unsigned* m = pay + (k % kStages) * kStageWords + ml;
#pragma unroll
            for (int i = 0; i < kPerThread; ++i) {
                const int e = tid + i * kThreads;
                acc[i] = e < words ? m[e] : 0u;
            }
        }
        if (!kWide && a.s1 != nullptr && tid < a.k_max) {
            const int at = tl.d * a.k_max + tid;
            sh.s1[tid] = mod(a.s1[at], s);
            sh.s2[tid] = mod(a.s2[at], s);
        }
        __syncthreads();
        if (warp == 0 && k + kStages < n_items) stage(k + kStages);
        ++k;

        // One item per shift: merge the staged sender rows.
        for (int j = 0; j < a.k_max; ++j) {
            const int st = k % kStages;
            if constexpr (kWide) {
                // The stage holds the chunk's senders in column order,
                // `lead` entries in; no meta word means no copy.
                mbar_wait(full + st, (k / kStages) & 1);
                const int c0 = meta[st];
                if (c0 >= 0) {
                    // The sender row's entries from column c0, then from
                    // column 0 past the row's end (load_runs' two runs).
                    int src_row = tl.l0 - sh.cl[j];
                    if (src_row < 0) src_row += a.n_local;
                    const long long rb = (tl.base + src_row) * s;
                    const long long prb = rb + (kShared ? 0 : j * a.plane);
                    const long long mrb = rb + j * a.plane;
                    const int a_words = min(words, s - c0);
                    const int gw = run_gap(prb + c0, a_words, prb, 4);
                    const int gm = run_gap(mrb + c0, a_words, mrb, 1);
                    const unsigned* src = pay + st * kStageWords
                                          + lead_of(prb + c0, 4);
                    const unsigned char* msk = tail + st * kStageMaskBytes
                                               + lead_of(mrb + c0, 1);
#pragma unroll
                    for (int i = 0; i < kPerThread; ++i) {
                        const int e = tid + i * kThreads;
                        if (e < words) {
                            const bool past = e >= a_words;
                            const unsigned v =
                                G != Gate::kMask || msk[e + (past ? gm : 0)]
                                ? src[e + (past ? gw : 0)] : 0u;
                            acc[i] = v > acc[i] ? v : acc[i];
                        }
                    }
                }
            } else {
                // Tile rows below `wrap` are the wrapped receivers l < c_j.
                const long long w = static_cast<long long>(sh.c[j]) - tl.l0;
                const int wrap = a.single_col ? 0
                    : static_cast<int>(w < 0 ? 0
                                       : (w > tl.rows ? tl.rows : w));
                const int sh1 = sh.s1[j], sh2 = sh.s2[j];
                // Where the stage's widened runs put the tile's first
                // sender, and the gap before the rows past the wrap.
                int src0 = tl.l0 - sh.cl[j];
                if (src0 < 0) src0 += a.n_local;
                // Entries counted from the payload's and the masks' bases.
                const long long po = kShared ? 0 : j * a.plane;
                const long long mo = j * a.plane;
                const long long e0 = (tl.base + src0) * s;
                const int first = min(tl.rows, a.n_local - src0);
                const unsigned a_words = static_cast<unsigned>(first * s);
                const long long eb = tl.base * s;
                const int gw = run_gap(po + e0, a_words, po + eb, 4);
                const int gm = run_gap(mo + e0, a_words, mo + eb, 1);
                mbar_wait(full + st, (k / kStages) & 1);
                const unsigned* src = pay + st * kStageWords
                                      + lead_of(po + e0, 4);
                const unsigned char* msk = tail + st * kStageMaskBytes
                                           + lead_of(mo + e0, 1);
                const int* keff = reinterpret_cast<const int*>(tail)
                                  + st * kKeffRows;
                int row = row0, col = col0;
#pragma unroll
                for (int i = 0; i < kPerThread; ++i) {
                    if (tid + i * kThreads < words) {
                        int sc = col - (row < wrap ? sh2 : sh1);
                        if (sc < 0) sc += s;
                        const int at = row * s + sc;
                        const bool past = row >= first;
                        bool keep = true;
                        if (G == Gate::kMask) keep = msk[at + (past ? gm : 0)] != 0;
                        if (G == Gate::kKeff) keep = j < keff[row];
                        const unsigned v = keep ? src[at + (past ? gw : 0)] : 0u;
                        acc[i] = v > acc[i] ? v : acc[i];
                    }
                    col += dcol;
                    row += drow;
                    if (col >= s) {
                        col -= s;
                        ++row;
                    }
                }
            }
            // The last shift's sync also frees `out` for this tile: the
            // previous tile's store has read it.
            if (j == a.k_max - 1 && tid == 0) bulk_wait_read();
            __syncthreads();
            if (warp == 0 && k + kStages < n_items) stage(k + kStages);
            ++k;
        }

        // Write the tile back: the aligned interior [head, head + body)
        // registers -> `out` (ml words in) -> one bulk store; the words
        // before and after it by plain stores.
        const int head = min(words, (4 - ml) & 3);
        const int body = (words - head) & ~3;
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
            const int e = tid + i * kThreads;
            if (e < words) {
                if (e >= head && e < head + body)
                    out[ml + e] = acc[i];
                else
                    a.mail[mb + e] = acc[i];
            }
        }
        fence_async_shared();
        __syncthreads();
        if (tid == 0 && body > 0)
            bulk_store(a.mail + mb + head, out + ml + head,
                       static_cast<unsigned>(body) * 4);
    }
    if (tid == 0) bulk_wait();
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
// rows (a.s and a.n_local set): R = kTileWords / S whole rows a tile (at
// most `max_rows`: kKeffRows for the k_eff gate), or for S > kMaxS one
// chunk of a row.  False when the tiles outnumber int.
inline bool set_tiles(TileArgs& a, int shards, int max_rows = kTileWords) {
    const bool wide = a.s > kMaxS;
    const int fit = wide ? 1 : kTileWords / a.s;
    a.tile_rows = fit < max_rows ? fit : max_rows;
    a.chunks = wide ? (a.s + kTileWords - 1) / kTileWords : 1;
    const long long per_shard = wide
        ? static_cast<long long>(a.n_local) * a.chunks
        : (a.n_local + a.tile_rows - 1) / a.tile_rows;
    if (per_shard * shards > 0x7fffffffLL) return false;
    a.tiles_per_shard = static_cast<int>(per_shard);
    a.n_tiles = static_cast<int>(per_shard * shards);
    return true;
}

// K4 and K6: the row shifts c[j] come from device memory, the column
// shifts from a.s1/a.s2 ([D, k_max], read once per tile).
template <Gate G, bool kShared, bool kWide>
__global__ void __launch_bounds__(kThreads)
stacked_kernel(TileArgs a, const int* __restrict__ c) {
    __shared__ Shifts sh;
    for (int j = threadIdx.x; j < a.k_max; j += kThreads) {
        sh.c[j] = c[j];
        sh.cl[j] = mod(c[j], a.n_local);
    }
    run<G, kShared, kWide>(a, sh);
}

// Host side: stacked_kernel for one payload plane shared by every shift
// or one plane per shift; kWide (K4's rows wider than a tile) on row
// chunks.
template <Gate G, bool kWide>
int launch_stacked(const TileArgs& a, const int* c, bool shared,
                   void* stream) {
    return shared
        ? launch<G>(&stacked_kernel<G, true, kWide>, a.n_tiles, stream, a, c)
        : launch<G>(&stacked_kernel<G, false, kWide>, a.n_tiles, stream, a,
                    c);
}

}  // namespace dm_tile
