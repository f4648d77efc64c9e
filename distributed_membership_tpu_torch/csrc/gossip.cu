// K2: circulant gossip delivery, all shifts in one pass over the mailbox.
//
// Replaces the Pallas kernel `gossip_fused` of the JAX package's
// ops/fused_gossip.py:
//   mail = max(mail, max_j roll_cols(roll_rows(gate_j(payload), r_j), s_j))
// with the gate `j < k_eff[sender]` (lossless form) or
// `masks[j, sender, sender_col] != 0` (masks form, used under drops).
//
// Bound: bytes.  The function must read mail and payload once (plus the
// masks or k_eff) and write mail once; the work per element is a few
// integer operations per shift.  This design cannot reach that count: a
// receiver tile gathers its senders, and the k_max receiver rows of one
// sender row lie far apart on the ring (further than L2 holds at N =
// 2^20), so it reads the payload once per shift and moves (2 + k_max)
// planes, plus k_max k_eff vectors or the k_max mask planes, where the
// bound counts 3.  The kernel is the tiled body of gossip_tile.cuh with
// D = 1 and L = N: a block stages the R sender rows of each shift (two
// contiguous runs, split at the ring's wrap) in shared memory by 1-D bulk
// copies on an mbarrier ring of four stages, so several items are in
// flight per block while one is merged, then merges them with a rotated,
// conflict-free read of the staged rows.  Receiver rows below r_j use the
// wrapped-row column alignment when (N * STRIDE) % S != 0, a case the TPU
// kernel could not take.  A row wider than a tile (S > 4096) is staged in
// chunks of 4096 columns, each shift's sender chunk already in receiver
// column order; a sender row whose k_eff gate is closed for the shift is
// not copied at all, so the chunks move (2 + the open gates) planes.
// Rows of any width run: the TPU kernel's 128-lane tiling asked S % 128
// == 0, the bulk copies here only 16-byte bounds, to which every span is
// widened (gossip_tile.cuh).

#include "gossip_tile.cuh"

namespace {

using dm_tile::Gate;

// The per-shift row and column shifts of the ring's shifts r_j.
__device__ __forceinline__ void ring_shifts(const dm_tile::TileArgs& a,
                                            const int* __restrict__ shifts,
                                            int cstride, dm_tile::Shifts& sh) {
    const long long n = a.n_local, s = a.s;
    for (int j = threadIdx.x; j < a.k_max; j += dm_tile::kThreads) {
        const long long r = shifts[j];
        sh.c[j] = static_cast<int>(r);
        sh.cl[j] = static_cast<int>(((r % n) + n) % n);
        sh.s1[j] = static_cast<int>((((r % s) + s) % s * cstride) % s);
        sh.s2[j] = static_cast<int>(((((r - n) % s) + s) % s * cstride) % s);
    }
}

template <Gate G, bool kWide>
__global__ void __launch_bounds__(dm_tile::kThreads)
gossip_kernel(dm_tile::TileArgs a, const int* __restrict__ shifts,
              int cstride) {
    __shared__ dm_tile::Shifts sh;
    ring_shifts(a, shifts, cstride, sh);
    dm_tile::run<G, true, kWide>(a, sh);
}

template <Gate G>
int launch_gossip(const dm_tile::TileArgs& a, const int* shifts, int cstride,
                  void* stream) {
    return a.s > dm_tile::kMaxS
        ? dm_tile::launch<G>(&gossip_kernel<G, true>, a.n_tiles, stream, a,
                             shifts, cstride)
        : dm_tile::launch<G>(&gossip_kernel<G, false>, a.n_tiles, stream, a,
                             shifts, cstride);
}

}  // namespace

// Exactly one of k_eff ([n] int32) and masks ([k_max, n, s] bytes) is
// non-null; shifts is a device [k_max] int32 array (the ring draws values
// in [1, n); any int32 shift gives the plain version's result: the sender
// row is taken mod n, and each receiver row i picks s1 or s2 by i >= r as
// drawn, as the plain version does).  Any s > 0 (whole rows per tile for
// s <= 4096, at most 512 rows in the k_eff form; one row chunk per tile
// past 4096); mail, payload and masks 16-byte aligned.  mail is updated
// in place.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernel does
// not take.
extern "C" int dm_gossip(unsigned n, int s, int k_max, int cstride,
                         int single_col, unsigned* mail,
                         const unsigned* payload, const int* k_eff,
                         const unsigned char* masks, const int* shifts,
                         void* stream) {
    if (k_max > dm_tile::kMaxShifts || s <= 0 || n > 0x7fffffffu)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0 || k_max <= 0) return dm_launch_status();
    dm_tile::TileArgs a{};
    a.mail = mail;
    a.payload = payload;
    a.masks = masks;
    a.k_eff = k_eff;
    a.plane = static_cast<long long>(n) * s;
    a.s = s;
    a.n_local = static_cast<int>(n);
    a.k_max = k_max;
    a.single_col = single_col != 0;
    if (!dm_tile::set_tiles(a, 1, masks != nullptr ? dm_tile::kTileWords
                                                   : dm_tile::kKeffRows))
        return static_cast<int>(cudaErrorInvalidValue);
    return masks != nullptr
        ? launch_gossip<Gate::kMask>(a, shifts, cstride, stream)
        : launch_gossip<Gate::kKeff>(a, shifts, cstride, stream);
}
