// K6: folded circulant gossip delivery, all shifts in one pass over the
// mailbox.
//
// Replaces the Pallas kernel `gossip_folded_stacked` of the JAX package's
// ops/fused_folded.py.  Per shift j the JAX step delivers
//   roll_slots(roll_nodes(payload_j, thr_j), c_j)
// maxed into mail, where roll_nodes is the fold of a node-axis roll by
// thr_j and roll_slots the fold of a slot-axis roll by c_j; c_j is c1_j
// for receiver nodes i >= thr_j (or always, when single_col) and c2_j for
// the wrapped receivers i < thr_j.  Two operand forms: K pre-masked
// payloads [K, rows, 128], or one shared payload [1, rows, 128] with K
// sender-indexed keep masks [K, rows, 128] (bytes).
//
// Bound: bytes.  The function must read mail and the payloads (or the
// shared payload and the masks) once and write mail once; a few integer
// operations per entry and shift.  The folded [rows, 128] planes are the
// bytes of the natural [N, S] planes (S | 128), so K6 is K4's function
// on the natural view: D shards of n_local nodes (one shard of N on the
// single-chip step), node shift thr_j within a shard, slot shifts
// c1[d][j] / c2[d][j] per shard; the JAX sharded folded step calls its
// kernel once per shard, this kernel takes every shard in one launch.
// The kernel is the tiled body of gossip_tile.cuh (see there): a block owns
// 4096 / S receiver nodes, stages each shift's sender nodes -- two
// contiguous runs, split at the ring's wrap, widened to 16-byte bounds
// where S < 4 -- in shared memory by 1-D bulk copies on an mbarrier ring
// of four stages, and merges them with a rotated, conflict-free read.
// The pre-masked form moves exactly its bound; the shared form reads its
// one payload plane once per shift.

#include "gossip_tile.cuh"

// mail is [rows, 128] holding the nodes of D = rows * 128 / (s * n_local)
// shards of n_local nodes, each whole plane rows (n_local * s % 128 == 0);
// payloads is [K, rows, 128], or [1, rows, 128] with shared_payload; masks
// is [K, rows, 128] bytes or null; thr is a device [K] int32 array of node
// shifts within a shard, c1 and c2 device [D, K] int32 arrays of per-shard
// slot shifts (any int32 gives the plain version's result).  S divides
// 128 and rows * 128 / S < 2^31; mail, payloads and masks 16-byte
// aligned.  mail is updated in place.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int dm_gossip_folded(int rows, int s, int n_local, int k_max,
                                int single_col, int shared_payload,
                                unsigned* mail, const unsigned* payloads,
                                const unsigned char* masks, const int* thr,
                                const int* c1, const int* c2, void* stream) {
    using dm_tile::Gate;
    const long long plane = static_cast<long long>(rows) * 128;
    if (k_max > dm_tile::kMaxShifts || s <= 0 || 128 % s != 0 || rows < 0
        || plane / s > 0x7fffffffLL || n_local <= 0
        || (plane / s) % n_local != 0
        || (static_cast<long long>(n_local) * s) % 128 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0 || k_max <= 0) return dm_launch_status();
    dm_tile::TileArgs a{};
    a.mail = mail;
    a.payload = payloads;
    a.masks = masks;
    a.s1 = c1;
    a.s2 = c2;
    a.plane = plane;
    a.s = s;
    a.n_local = n_local;
    a.k_max = k_max;
    a.single_col = single_col != 0;
    // Tiles never straddle a shard, and every shard ends on a plane row,
    // so a wrapped run's second half lands 16-byte aligned.
    if (!dm_tile::set_tiles(a, static_cast<int>(plane / s / n_local)))
        return static_cast<int>(cudaErrorInvalidValue);
    // S divides 128, so a row never outgrows a tile.
    return masks != nullptr
        ? dm_tile::launch_stacked<Gate::kMask, false>(a, thr, shared_payload,
                                                      stream)
        : dm_tile::launch_stacked<Gate::kNone, false>(a, thr, shared_payload,
                                                      stream);
}
