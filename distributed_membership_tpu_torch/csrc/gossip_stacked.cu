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
// operations per entry and shift.  The TPU kernel fetched two sender row
// blocks per output block by scalar prefetch and rebuilt the rolls with
// sublane and lane rotates; here the kernel is output-stationary per
// entry instead: a block owns 4 receiver rows, each thread one column of a
// row, and for every shift it computes its sender directly -- row d*L +
// (l - c_j) mod L, column (col - shift) mod S -- gathers it, and keeps the
// unsigned max in a register; each mail entry is read and written once.
// The senders of one warp are one rotated run of one payload row, so the
// gathers stay coalesced.  c_j mod L and the rows' column shifts (reduced
// mod S) are staged once per block in shared memory.

#include "common.cuh"

namespace {

constexpr int kCols = 128;         // threads along the slot axis
constexpr int kRowsPerBlock = 4;   // receiver rows per block
constexpr int kMaxShifts = 64;

__global__ void gossip_stacked_kernel(long long rows, int s, int n_local,
                                      int k_max, bool single_col,
                                      bool shared_payload,
                                      unsigned* __restrict__ mail,
                                      const unsigned* __restrict__ payloads,
                                      const unsigned char* __restrict__ masks,
                                      const int* __restrict__ c,
                                      const int* __restrict__ s1,
                                      const int* __restrict__ s2) {
    __shared__ int sh_c[kMaxShifts];                    // c_j as given
    __shared__ int sh_cl[kMaxShifts];                   // c_j mod L
    __shared__ int sh_shift[kRowsPerBlock][kMaxShifts];  // per row, mod S
    const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
    const int tid = threadIdx.y * kCols + threadIdx.x;
    for (int j = tid; j < k_max; j += kCols * kRowsPerBlock) {
        sh_c[j] = c[j];
        sh_cl[j] = ((c[j] % n_local) + n_local) % n_local;
    }
    __syncthreads();
    for (int e = tid; e < kRowsPerBlock * k_max; e += kCols * kRowsPerBlock) {
        const int r = e / k_max;
        const int j = e - r * k_max;
        const long long i = row0 + r;
        if (i >= rows) continue;
        const long long d = i / n_local;
        const int l = static_cast<int>(i - d * n_local);
        const int v = (single_col || l >= sh_c[j]) ? s1[d * k_max + j]
                                                   : s2[d * k_max + j];
        sh_shift[r][j] = ((v % s) + s) % s;
    }
    __syncthreads();

    const long long i = row0 + threadIdx.y;
    if (i >= rows) return;
    const long long d = i / n_local;
    const int l = static_cast<int>(i - d * n_local);
    const long long shard0 = d * n_local;
    const long long plane = rows * s;
    for (int col = threadIdx.x; col < s; col += kCols) {
        const long long dst = i * s + col;
        unsigned acc = mail[dst];
        for (int j = 0; j < k_max; ++j) {
            int src_l = l - sh_cl[j];
            if (src_l < 0) src_l += n_local;
            int src_col = col - sh_shift[threadIdx.y][j];
            if (src_col < 0) src_col += s;
            const long long src = (shard0 + src_l) * s + src_col;
            const long long at = static_cast<long long>(j) * plane + src;
            if (masks != nullptr && masks[at] == 0) continue;
            const unsigned val = payloads[shared_payload ? src : at];
            acc = val > acc ? val : acc;
        }
        mail[dst] = acc;
    }
}

}  // namespace

// mail is [rows, s] holding rows / n_local shards; payloads is [K, rows, s],
// or [1, rows, s] with shared_payload; masks is [K, rows, s] bytes or null;
// c is a device [K] int32 array of row shifts, s1 and s2 device [D, K] int32
// arrays of per-shard column shifts.  mail is updated in place.  Returns
// cudaGetLastError().
extern "C" int dm_gossip_stacked(long long rows, int s, int n_local, int k_max,
                                 int single_col, int shared_payload,
                                 unsigned* mail, const unsigned* payloads,
                                 const unsigned char* masks, const int* c,
                                 const int* s1, const int* s2, void* stream) {
    if (k_max > kMaxShifts || s <= 0 || n_local <= 0 || rows % n_local != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 0 && k_max > 0) {
        gossip_stacked_kernel<<<static_cast<unsigned>(blocks),
                                dim3(kCols, kRowsPerBlock), 0,
                                static_cast<cudaStream_t>(stream)>>>(
            rows, s, n_local, k_max, single_col != 0, shared_payload != 0,
            mail, payloads, masks, c, s1, s2);
    }
    return dm_launch_status();
}
