"""The batched fanout exchange, ``EXCHANGE_MODE: batched`` (counterpart of
the JAX package's ``ops/exchange.py``).

The legacy ring exchange of the sharded steps hops every gossip shift's
payload to its destination shard on its own (``LocalMesh.block_send``),
then K4 or K6 rolls and aligns all shifts into the mailbox.  The batched
exchange moves that alignment to the sender: for shift ``u = b*L + c``
each source shard ``d`` aligns its payload for its destination ``r = (d +
b) mod D`` (the legacy receiver's row roll by ``c`` and column rolls,
with ``me := r``), maxes it into its bucket for ``r``, and after the last
shift one ``all_to_all`` ships every bucket.  The result is consumed at
the next tick's head, where the legacy merge first becomes observable, so
the deferral is bit-exact; the sharded steps carry it as ``(state,
xbuf)`` inside a segment (backends/tpu_hash_sharded.py).

On a :class:`~distributed_membership_tpu_torch.parallel.mesh.LocalMesh`
the buckets are kept where the ``all_to_all`` would put them and already
combined over their sources: payloads ``[D_dst, rows, lanes]`` (each
shard's ``[L, S]`` plane, or the folded ``[L*S/128, 128]``) and counts
``[D_dst, L]``, the size of the mailbox.  A shift's source shard ``d``
reaches one destination ``(d + b) mod D``, a permutation of the shards,
so ``add_shift`` aligns each source's plane for its destination and
maxes it into that destination's bucket (identity 0; the counts add).
Max and sum are associative and commutative, so this equals the JAX
buckets ``[D_src, D_dst, ...]`` shipped by the tiled ``all_to_all`` and
reduced over the source axis by the receiver, bit for bit; the JAX wire
(the counts as extra rows of the payload plane) has nothing to carry
here.  The alignment works on each shard's natural ``[L, S]`` view,
whose bytes the folded plane is, so one code serves both layouts.
Payloads are int32 tensors holding u32 bits (``view_merge.umax``).

On a :class:`~distributed_membership_tpu_torch.parallel.mesh.ProcessMesh`
the shards span processes, and the exchange ships as the JAX one does:
each process folds its ``D_local`` source shards into buckets for every
destination, ``[D_dst, rows, lanes]`` (the JAX per-source buckets
``[D_src_local, D_dst, ...]`` already maxed and summed over this
process's sources: max and sum are associative), puts the counts
beside the payload as extra words of each bucket (the JAX wire), and
one ``all_to_all`` per tick (:meth:`BatchedExchange.ship`) hands each
process its destinations' buckets from every process, which it maxes
and sums over the sources.
"""

from __future__ import annotations

import torch

from distributed_membership_tpu_torch.ops.view_merge import umax

I32 = torch.int32
I64 = torch.int64


class BatchedExchange:
    """The batched gossip exchange of one sharded step on ``mesh``: ``D``
    shards of ``n_local`` nodes with ``s`` slots; ``folded`` planes are
    ``[n_local * s / lanes, lanes]`` per shard."""

    def __init__(self, *, mesh, n_local: int, s: int, cstride: int,
                 single_col_roll: bool, folded: bool = False,
                 lanes: int = 128):
        self.mesh = mesh
        self.d = mesh.size
        self.n_local = n_local
        self.s = s
        self.cstride = cstride
        self.single_col_roll = single_col_roll
        rows, width = ((n_local * s // lanes, lanes) if folded
                       else (n_local, s))
        self.pay_shape = (self.d, rows, width)
        self.cnt_shape = (self.d, n_local)
        self.dl = mesh.local_size

    # ---- carry lane -------------------------------------------------
    def zero(self, device):
        """The empty carried xbuf: this process's destinations."""
        return (torch.zeros((self.dl,) + self.pay_shape[1:], dtype=I32,
                            device=device),
                torch.zeros((self.dl,) + self.cnt_shape[1:], dtype=I32,
                            device=device))

    def buckets(self, device):
        """Empty send buckets, one per destination shard (on a LocalMesh
        the carried xbuf's shape)."""
        return (torch.zeros(self.pay_shape, dtype=I32, device=device),
                torch.zeros(self.cnt_shape, dtype=I32, device=device))

    def ship(self, pay, cnt):
        """The tick's buckets to their destinations' processes: one
        ``all_to_all`` of the payload words with the counts beside them,
        maxed and summed over the source processes.  On a LocalMesh they
        already sit there."""
        mesh = self.mesh
        if mesh.procs == 1:
            return pay, cnt
        k, dl = mesh.procs, self.dl
        words = pay[0].numel()
        wire = torch.cat([pay.reshape(self.d, -1),
                          cnt.reshape(self.d, -1)], dim=1)
        got = mesh._all_to_all(wire, [dl] * k, [dl] * k).view(k, dl, -1)
        out_pay = got[0, :, :words]
        for q in range(1, k):
            out_pay = umax(out_pay, got[q, :, :words])
        out_cnt = got[:, :, words:].sum(0, dtype=I32)
        return (out_pay.reshape((dl,) + self.pay_shape[1:]).contiguous(),
                out_cnt.contiguous())

    # ---- sender side ------------------------------------------------
    def _rep(self, v: torch.Tensor) -> torch.Tensor:
        """``[D, L]`` per-node values over each node's slots, in the
        payload planes' shape."""
        return v[..., None].expand(v.shape + (self.s,)).reshape(
            v.shape[:-1] + self.pay_shape[1:])

    def _align(self, payload: torch.Tensor, b, c, r: torch.Tensor):
        """The legacy receive alignment of ``payload`` (``[K, rows,
        lanes]``, one plane per source shard) for its destinations ``r``
        (``[K]``), done on the sender: the rows rolled by ``c`` within the
        shard, slot ``q`` of a node taking the sender's slot ``q - s1``
        (``q - s2`` on the rows ``l < c`` that wrapped, unless the two
        coincide).  ``b`` and ``c`` are int64 device scalars."""
        dd, ll, s = payload.shape[0], self.n_local, self.s
        dev = payload.device
        bp = torch.where(r < b, b - dd, b)
        s1 = (bp * ll + c) % s * self.cstride % s
        s2 = (bp * ll + c - ll) % s * self.cstride % s
        nat = payload.reshape(dd, ll, s)
        l_idx = torch.arange(ll, dtype=I64, device=dev)
        p = nat.index_select(1, (l_idx - c) % ll)
        q = torch.arange(s, dtype=I64, device=dev)

        def cols(shift):
            idx = ((q[None, :] - shift[:, None]) % s)[:, None, :]
            return p.gather(2, idx.expand(dd, ll, s))
        out = cols(s1)
        if not self.single_col_roll:
            out = torch.where((l_idx >= c)[None, :, None], out, cols(s2))
        return out.reshape(payload.shape)

    def add_shift(self, pay, cnt, payload, cnt_j, b, c):
        """Fold one gossip shift ``u = b*L + c`` into the buckets, in
        place: ``payload`` is ``[D_local, rows, lanes]`` and ``cnt_j``
        ``[D_local, L]``, this process's source shards in order; ``b``/``c``
        int64 device scalars.  Source ``d`` goes to destination ``(d + b)
        mod D``, aligned for it.  Returns ``(pay, cnt)``."""
        dev = payload.device
        dst = (torch.arange(self.dl, dtype=I64, device=dev)
               + self.mesh.shard_lo + b) % self.d
        aligned = self._align(payload, b, c, dst)
        ll = self.n_local
        l_src = (torch.arange(ll, dtype=I64, device=dev) - c) % ll
        pay[dst] = umax(pay[dst], aligned)
        cnt[dst] += cnt_j.index_select(1, l_src)
        return pay, cnt

    # ---- receiver side (next tick's head, or the segment's end) -----
    def merge_mail(self, mail, pay):
        """``mail`` (the flat ``[N, ...]`` mailbox) maxed with the
        buckets."""
        return umax(mail, pay.reshape(mail.shape))

    def merge_pending(self, cnt):
        """``[N]`` receive counts."""
        return cnt.reshape(-1)

    def flush(self, state, xbuf):
        """``state`` with an exchanged xbuf merged into its mailbox and
        pending receives (the JAX ``_flush_xbuf``, and the sharded
        steps' head merge)."""
        pay, cnt = xbuf
        return state._replace(
            mail=self.merge_mail(state.mail, pay),
            pending_recv=state.pending_recv + self.merge_pending(cnt))

    def wipe(self, pay, cnt, up_now):
        """Zero a restarting node's undelivered rows in a fresh exchange:
        the legacy step merges gossip before the restart wipe, and
        ``where(mask, 0, .)`` distributes over the max and the sum."""
        up = up_now.view(self.dl, self.n_local)
        return (torch.where(self._rep(up), 0, pay),
                torch.where(up, 0, cnt))
