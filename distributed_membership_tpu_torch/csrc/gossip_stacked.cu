// K4: the sharded ring step's gossip delivery, all shifts of every shard
// in one pass over the mailbox.
//
// Replaces the Pallas kernel `gossip_fused_stacked` of the JAX package's
// ops/fused_gossip.py.  The mailbox holds D shards of L rows each (shard d
// owns rows [d*L, (d+1)*L)).  Per shift j the JAX step has already routed
// the payload across shards (the block hop); what is left per shard is
//   mail = max(mail, align(roll_rows(payload_j, c_j), s1[d][j] / s2[d][j]))
// where roll_rows is a roll of the shard's own rows by c_j and align a
// column roll by s1[d][j] for the shard's rows l >= c_j (or always, when
// single_col) and by s2[d][j] for the wrapped rows l < c_j.  Two operand
// forms: K pre-masked payloads [K, N, S] (the path), or one shared payload
// [1, N, S] with K sender-indexed keep masks [K, N, S] (bytes).
//
// Bound: bytes.  The function must read mail and the K payloads (or the
// shared payload and the masks) once and write mail once; a few integer
// operations per entry and shift.  The pre-masked form moves exactly that,
// (2 + K) planes; the shared form reads its one payload plane once per
// shift, as a receiver tile's senders for different shifts are different
// rows, so it moves (2 + K) planes plus the masks where the bound counts 3
// plus the masks.  The kernel is the tiled body of gossip_tile.cuh: a
// block owns R receiver rows of one shard (tiles never straddle a shard),
// stages each shift's R sender rows -- two contiguous runs, split where
// the shard wraps -- in shared memory by 1-D bulk copies on an mbarrier
// ring of four stages, so several items are in flight per block while one
// is merged, and merges them with a rotated, conflict-free read of the
// staged rows.  The tile's shard shifts s1[d][j], s2[d][j] are read once
// per tile.  A row wider than a tile (S > 4096) is staged in chunks of
// 4096 columns, each shift's sender chunk already in receiver column
// order (gossip_tile.cuh, "Wide rows").

#include "gossip_tile.cuh"

// mail is [rows, s] holding rows / n_local shards; payloads is [K, rows, s],
// or [1, rows, s] with shared_payload; masks is [K, rows, s] bytes or null;
// c is a device [K] int32 array of row shifts (the step passes [0, n_local);
// any int32 gives the plain version's result), s1 and s2 device [D, K]
// int32 arrays of per-shard column shifts.  Any s > 0 and shard size
// (rows wider than 4096 are tiled by row chunks, and spans off a 16-byte
// bound widened, gossip_tile.cuh); mail, payloads and masks 16-byte
// aligned.  mail is updated in place.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int dm_gossip_stacked(long long rows, int s, int n_local, int k_max,
                                 int single_col, int shared_payload,
                                 unsigned* mail, const unsigned* payloads,
                                 const unsigned char* masks, const int* c,
                                 const int* s1, const int* s2, void* stream) {
    using dm_tile::Gate;
    if (k_max > dm_tile::kMaxShifts || s <= 0 || n_local <= 0 || rows < 0
        || rows % n_local != 0 || rows > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0 || k_max <= 0) return dm_launch_status();
    dm_tile::TileArgs a{};
    a.mail = mail;
    a.payload = payloads;
    a.masks = masks;
    a.s1 = s1;
    a.s2 = s2;
    a.plane = rows * s;
    a.s = s;
    a.n_local = n_local;
    a.k_max = k_max;
    a.single_col = single_col != 0;
    if (!dm_tile::set_tiles(a, static_cast<int>(rows / n_local)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (s > dm_tile::kMaxS)
        return masks != nullptr
            ? dm_tile::launch_stacked<Gate::kMask, true>(a, c, shared_payload,
                                                         stream)
            : dm_tile::launch_stacked<Gate::kNone, true>(a, c, shared_payload,
                                                         stream);
    return masks != nullptr
        ? dm_tile::launch_stacked<Gate::kMask, false>(a, c, shared_payload,
                                                      stream)
        : dm_tile::launch_stacked<Gate::kNone, false>(a, c, shared_payload,
                                                      stream);
}
