// The receive pass of one packed entry, shared by K1 (receive.cu, the
// [N, S] layout) and K5 (receive_folded.cu, the folded layout): sticky
// admission of mail, the occupant-matched strict-increase ack refresh,
// the self-slot refresh and the TFAIL/TREMOVE sweep, with the entry's
// stale and occupied counts added to the caller's.
#pragma once

#include "common.cuh"

namespace {

struct RowCtx {
    int t, tfail, tremove;
    Magic n;            // for member ids, (packed - 1) mod N
    unsigned node;      // global node id the entry belongs to
    int self_slot;      // slot_of(node, node)
    bool recv, act, son;
    unsigned spack;     // packed self entry
};

// ``admit`` false suppresses this entry's delivered mail, as if it had not
// arrived: it neither admits nor refreshes (the mailbox still clears).
__device__ __forceinline__ void receive_one(const RowCtx& r, int col,
                                            unsigned& v, int& ts,
                                            unsigned& m, unsigned cand,
                                            unsigned char& join, int& rm,
                                            int& stale_cnt, int& size_cnt,
                                            bool admit = true) {
    const bool self_mask = col == r.self_slot;
    const unsigned v0 = v;
    const bool prev_present = v0 > 0u;
    const unsigned m_in = admit ? m : 0u;
    // Sticky admission: the self slot admits only the node's own id; an
    // occupied slot only its occupant's id; an empty slot anything.
    const unsigned in_id = r.n.mod(m_in - 1u);
    const bool ok = self_mask ? (in_id == r.node)
                              : (!prev_present || in_id == r.n.mod(v0 - 1u));
    unsigned nv = v0;
    if (r.recv && m_in > 0u && ok && m_in > v0) nv = m_in;
    int nts = ts;
    const bool changed = nv > v0;
    if (changed) nts = r.t;
    join = changed && !prev_present;
    if (r.recv) m = 0u;
    // Ack refresh: occupant must match, strictly newer heartbeat.
    if (r.recv && cand > 0u && nv > 0u && cand > nv &&
        r.n.mod(cand - 1u) == r.n.mod(nv - 1u)) {
        nv = cand;
        nts = r.t;
    }
    if (self_mask && r.son) {
        nv = r.spack;
        nts = r.t;
    }
    // TFAIL / TREMOVE sweep.
    const int difft = dm_sub_wrap(r.t, nts);
    const bool stale = nv > 0u && difft >= r.tfail && r.act;
    const bool removes = stale && difft >= r.tremove;
    rm = removes ? static_cast<int>(r.n.mod(nv - 1u)) : -1;
    if (removes) nv = 0u;
    stale_cnt += stale;
    size_cnt += nv > 0u;
    v = nv;
    ts = nts;
}

}  // namespace
