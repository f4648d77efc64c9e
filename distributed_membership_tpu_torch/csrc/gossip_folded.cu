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
// operations per entry and shift.  The TPU kernel fetched two sender row
// blocks per output block and rebuilt the rolls with lane rotates; here
// the kernel is output-stationary per entry instead: entry (i, c) of the
// folded mailbox computes each sender directly -- node (i - thr_j) mod N,
// slot (c - c_j) mod S -- gathers it, and writes the unsigned max back in
// place.  The sender entries of one warp form one rotated run of the
// payload, so the gathers stay within a few cache lines.  thr_j mod N
// and the slot shifts are reduced once per block into shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShifts = 64;

__global__ void gossip_folded_kernel(long long n, int s_shift, int k_max,
                                     bool single_col, bool shared_payload,
                                     unsigned* __restrict__ mail,
                                     const unsigned* __restrict__ payloads,
                                     const unsigned char* __restrict__ masks,
                                     const int* __restrict__ thr,
                                     const int* __restrict__ c1,
                                     const int* __restrict__ c2) {
    __shared__ long long sh_thr[kMaxShifts];   // the shift as given
    __shared__ long long sh_rn[kMaxShifts];    // the shift mod n
    __shared__ int sh_c1[kMaxShifts];          // slot shift, i >= thr
    __shared__ int sh_c2[kMaxShifts];          // slot shift, i < thr
    const int s = 1 << s_shift;
    for (int j = threadIdx.x; j < k_max; j += kThreads) {
        const long long r = thr[j];
        sh_thr[j] = r;
        sh_rn[j] = ((r % n) + n) % n;
        sh_c1[j] = ((c1[j] % s) + s) % s;
        sh_c2[j] = ((c2[j] % s) + s) % s;
    }
    __syncthreads();

    const long long total = n << s_shift;
    const long long e = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
    if (e >= total) return;
    const long long i = e >> s_shift;          // receiver node
    const int c = static_cast<int>(e & (s - 1));
    unsigned acc = mail[e];
    for (int j = 0; j < k_max; ++j) {
        long long src_node = i - sh_rn[j];
        if (src_node < 0) src_node += n;
        const int shift = (single_col || i >= sh_thr[j]) ? sh_c1[j]
                                                         : sh_c2[j];
        const long long src = (src_node << s_shift) | ((c - shift) & (s - 1));
        const long long plane = static_cast<long long>(j) * total;
        if (masks != nullptr && masks[plane + src] == 0) continue;
        const unsigned val = payloads[(shared_payload ? 0 : plane) + src];
        acc = val > acc ? val : acc;
    }
    mail[e] = acc;
}

}  // namespace

// mail is [rows, 128]; payloads is [K, rows, 128], or [1, rows, 128] with
// shared_payload; masks is [K, rows, 128] bytes or null; thr,
// c1 and c2 are device [K] int32 arrays.  S divides 128.  mail is updated
// in place.  Returns cudaGetLastError().
extern "C" int dm_gossip_folded(int rows, int s, int k_max, int single_col,
                                int shared_payload, unsigned* mail,
                                const unsigned* payloads,
                                const unsigned char* masks, const int* thr,
                                const int* c1, const int* c2, void* stream) {
    if (k_max > kMaxShifts || s <= 0 || 128 % s != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int s_shift = __builtin_ctz(static_cast<unsigned>(s));
    const long long n = static_cast<long long>(rows) * (128 / s);
    const long long blocks = (static_cast<long long>(rows) * 128 + kThreads
                              - 1) / kThreads;
    if (blocks > 0 && k_max > 0) {
        gossip_folded_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
            n, s_shift, k_max, single_col != 0, shared_payload != 0, mail,
            payloads, masks, thr, c1, c2);
    }
    return dm_launch_status();
}
