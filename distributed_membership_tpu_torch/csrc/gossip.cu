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
// integer operations per shift.  The TPU kernel assembled sender blocks
// from two adjacent VMEM blocks and rotated lanes; here the kernel is
// output-stationary per element instead: each receiver element (i, c)
// computes its k_max sender coordinates directly -- row (i - r_j) mod N,
// column (c - s_j) mod S -- gathers and gates them, and writes the max
// back in place.  Sender elements of one warp are one contiguous
// (rotated) run of a row, so the gathers stay coalesced.  The payload is
// read once per shift (the k_max receivers of a sender row lie far
// apart, beyond what L2 holds), so the kernel moves (2 + k_max) planes
// where the bound counts 3.  Receiver
// rows below r_j use the wrapped-row column alignment when
// (N * STRIDE) % S != 0, a case the TPU kernel could not take.

#include "common.cuh"

namespace {

constexpr int kCols = 128;         // threads along the slot axis
constexpr int kRowsPerBlock = 4;   // rows per block
constexpr int kMaxShifts = 64;

__global__ void gossip_kernel(unsigned n, int s, int k_max, int cstride,
                              bool single_col,
                              unsigned* __restrict__ mail,
                              const unsigned* __restrict__ payload,
                              const int* __restrict__ k_eff,
                              const unsigned char* __restrict__ masks,
                              const int* __restrict__ shifts) {
    __shared__ int sh_r[kMaxShifts];    // the shift as drawn
    __shared__ int sh_rn[kMaxShifts];   // the shift mod n
    __shared__ int sh_s1[kMaxShifts];   // column shift, unwrapped rows
    __shared__ int sh_s2[kMaxShifts];   // column shift, wrapped rows
    const int tid = threadIdx.y * kCols + threadIdx.x;
    for (int j = tid; j < k_max; j += kCols * kRowsPerBlock) {
        const long long r = shifts[j];
        const long long nn = n;
        sh_r[j] = static_cast<int>(r);
        sh_rn[j] = static_cast<int>(((r % nn) + nn) % nn);
        sh_s1[j] = static_cast<int>((((r % s) + s) % s * cstride) % s);
        sh_s2[j] = static_cast<int>(((((r - nn) % s) + s) % s * cstride) % s);
    }
    __syncthreads();

    const long long i = static_cast<long long>(blockIdx.x) * kRowsPerBlock
                        + threadIdx.y;
    if (i >= n) return;
    for (int c = threadIdx.x; c < s; c += kCols) {
        const long long dst = i * s + c;
        unsigned acc = mail[dst];
        for (int j = 0; j < k_max; ++j) {
            // (i - r) mod n without a 64-bit division: i and r mod n both
            // lie in [0, n).
            long long src_row = i - sh_rn[j];
            if (src_row < 0) src_row += n;
            const int shift = (single_col || i >= sh_r[j]) ? sh_s1[j]
                                                           : sh_s2[j];
            int src_col = c - shift;
            if (src_col < 0) src_col += s;
            const long long src = src_row * s + src_col;
            const bool keep = masks != nullptr
                ? masks[static_cast<long long>(j) * n * s + src] != 0
                : j < k_eff[src_row];
            if (keep) {
                const unsigned val = payload[src];
                acc = val > acc ? val : acc;
            }
        }
        mail[dst] = acc;
    }
}

}  // namespace

// Exactly one of k_eff ([n] int32) and masks ([k_max, n, s] bytes) is
// non-null; shifts is a device [k_max] int32 array (the ring draws values
// in [1, n); any non-negative shift gives the plain version's result).
// mail is updated in place.  Returns cudaGetLastError().
extern "C" int dm_gossip(unsigned n, int s, int k_max, int cstride,
                         int single_col, unsigned* mail,
                         const unsigned* payload, const int* k_eff,
                         const unsigned char* masks, const int* shifts,
                         void* stream) {
    if (k_max > kMaxShifts) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 0 && k_max > 0) {
        gossip_kernel<<<blocks, dim3(kCols, kRowsPerBlock), 0,
                        static_cast<cudaStream_t>(stream)>>>(
            n, s, k_max, cstride, single_col != 0, mail, payload, k_eff,
            masks, shifts);
    }
    return dm_launch_status();
}
