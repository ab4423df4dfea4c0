"""Paxos action kernels: the Next-relation over batch-last torch tensors.

The reference package's ``spec/paxos/kernels.py`` maps a single state
to ``(ok, state')`` and is vmapped; here, as for raft (``ops/
kernels.py``), every kernel takes compacted rows with the batch axis
LAST (``mb``/``vb``/``vv`` [I, N, R], ``msgs`` [MW, R], ``ctr`` [NCTR,
R]) and one int32 [R] tensor per lane parameter, and returns the
successor rows only: the enabling guards are ``guard_features`` plus
each family's declared guard algebra (``ir.py``), and the engine runs
a kernel on enabled rows only.

``msgs`` is a bitmask over the finite message universe (``layout.py``)
carried as int32 bit patterns: a bit test is ``(w >> s) & 1``, which is
exact at bit 31 too (the arithmetic shift's sign copies are masked
off), and a send ORs ``1 << s``, which is INT_MIN at s = 31 — the same
bits as the reference's u32.  The one non-trivial guard, Phase2a's
∃-quorum value rule, runs once per state in ``derived`` as a static
loop over ``cfg.quorums``, the oracle's union-over-quorums form.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...ops.kernels import addc, put, take
from .. import C_GLOBLEN
from .layout import PaxosLayout

State = Dict[str, torch.Tensor]
I32 = torch.int32


class PaxosKernels:
    """Kernel family bound to one (PaxosLayout, PaxosConfig)."""

    def __init__(self, lay: PaxosLayout):
        self.lay = lay
        self.cfg = lay.cfg
        self.N, self.B, self.V, self.I = lay.N, lay.B, lay.V, lay.I
        j = np.arange(lay.n_msg_bits)
        self._word_np = (j >> 5).astype(np.int64)
        self._shift_np = (j & 31).astype(np.int32)
        self._dev = {}

    def _consts(self, device):
        c = self._dev.get(device)
        if c is None:
            c = self._dev[device] = dict(
                word=torch.from_numpy(self._word_np).to(device),
                shift=torch.from_numpy(self._shift_np).to(device)[:, None],
                bal=torch.arange(self.B, dtype=I32, device=device),
                P=torch.arange((self.B + 1) * (self.V + 1), dtype=I32,
                               device=device),
                # the quorums' acceptor lists, on the device: a captured
                # step may not copy an index list from the host
                quorums=[torch.tensor(Q, dtype=torch.int64, device=device)
                         for Q in self.cfg.quorums])
        return c

    # ------------------------------------------------------------------
    # bitmask helpers
    # ------------------------------------------------------------------

    def unpack_bits(self, words: torch.Tensor) -> torch.Tensor:
        """msgs [MW, R] -> int32 [n_msg_bits, R] 0/1."""
        c = self._consts(words.device)
        return (words[c["word"]] >> c["shift"]) & 1

    def _send(self, sv: State, idx: torch.Tensor) -> State:
        """Monotone set add of bit ``idx`` [R]: OR it into its word."""
        words = sv["msgs"]
        mask = torch.ones_like(idx) << (idx & 31)
        hit = torch.arange(words.shape[0], dtype=I32,
                           device=words.device)[:, None] == (idx >> 5)[None]
        return dict(sv, msgs=words | torch.where(hit, mask[None], 0))

    def _glob(self, sv: State) -> State:
        return dict(sv, ctr=addc(sv["ctr"], C_GLOBLEN, 1))

    def _cell(self, x: torch.Tensor, i, a) -> torch.Tensor:
        """x [I, N, R] at (i[r], a[r]) per row -> [R]."""
        return take(x.reshape(self.I * self.N, -1), i * self.N + a)

    def _set_cell(self, x: torch.Tensor, i, a, v) -> torch.Tensor:
        """x [I, N, R] with (i[r], a[r]) set to v[r] per row."""
        return put(x.reshape(self.I * self.N, -1), i * self.N + a,
                   v).reshape(x.shape)

    # ------------------------------------------------------------------
    # Derived per-state quantities (recomputed once per expansion)
    # ------------------------------------------------------------------

    def derived(self, sv: State) -> State:
        lay = self.lay
        I, N, B, V = self.I, self.N, self.B, self.V
        bits = self.unpack_bits(sv["msgs"])                 # [n_bits, R]
        R = bits.shape[-1]
        c = self._consts(bits.device)
        bal = c["bal"]
        b1a = bits[lay.off_1a:lay.off_1b].reshape(I, B, R)
        b1b = bits[lay.off_1b:lay.off_2a].reshape(I, N, B, B + 1, V + 1, R)
        b2a = bits[lay.off_2a:lay.off_2b].reshape(I, B, V, R)
        b2b = bits[lay.off_2b:].reshape(I, N, B, V, R)
        no2a = b2a.sum(2, dtype=I32) == 0                   # [I, B, R]
        # chosen(i, v): ∃b with a 2b majority (quorums are the
        # majorities, so existence is a counting test)
        cnt = b2b.sum(1, dtype=I32)                         # [I, B, V, R]
        chosen = (2 * cnt > N).any(1)                       # [I, V, R]
        # the Phase2a value rule per (i, b, v): the union over the
        # static quorum list of the spec's ∃Q conjunct
        p2a = torch.zeros((I, B, V, R), dtype=torch.bool,
                          device=bits.device)
        balm = bal[None, None, :, None]
        for q in c["quorums"]:
            qb = b1b.index_select(1, q)      # [I, |Q|, B, B+1, V+1, R]
            have = (qb.sum((3, 4), dtype=I32) > 0).all(1)   # [I, B, R]
            pres = qb.sum(1, dtype=I32)      # [I, B, B+1, V+1, R]
            voted = pres[:, :, 1:]           # mbal >= 0 [I, B, Bm, V+1, R]
            any_voted = voted.sum((2, 3), dtype=I32) > 0    # [I, B, R]
            mb_any = voted.sum(3, dtype=I32) > 0            # [I, B, Bm, R]
            mx = torch.where(mb_any, balm, -1).amax(2)      # [I, B, R]
            vmatch = voted[:, :, :, 1:] > 0  # real mvals [I, B, Bm, V, R]
            at_max = vmatch & (balm[..., None] == mx[:, :, None, None])
            has_v = at_max.any(2)                           # [I, B, V, R]
            okq = have[:, :, None] & (has_v | ~any_voted[:, :, None])
            p2a = p2a | okq
        return {"bits": bits, "b1a": b1a, "b2a": b2a, "b1b": b1b,
                "b2b": b2b, "no2a": no2a, "p2a": p2a, "chosen": chosen}

    # ------------------------------------------------------------------
    # Guard features (the guard product's surface; offsets below)
    # ------------------------------------------------------------------

    def guard_features(self, sv: State, der: State) -> torch.Tensor:
        """φ(s) int32 [F, R]: each family's guard is exactly one of
        these 0/1 features."""
        R = sv["mb"].shape[-1]
        bal = self._consts(sv["mb"].device)["bal"]
        mb = sv["mb"].to(I32)
        f1a = 1 - der["b1a"]                                 # [I, B, R]
        f1b = (der["b1a"][:, None] > 0) & \
            (bal[None, None, :, None] > mb[:, :, None])      # [I, N, B, R]
        f2a = der["no2a"][:, :, None] & der["p2a"]           # [I, B, V, R]
        f2b = (der["b2a"][:, None] > 0) & \
            (bal[None, None, :, None, None] >=
             mb[:, :, None, None])                           # [I, N, B, V, R]
        return torch.cat([f1a.reshape(-1, R), f1b.reshape(-1, R).to(I32),
                          f2a.reshape(-1, R).to(I32),
                          f2b.reshape(-1, R).to(I32)])

    def guard_feature_offsets(self) -> Dict[str, int]:
        I, N, B, V = self.I, self.N, self.B, self.V
        off = dict(p1a=0, p1b=I * B, p2a=I * B + I * N * B)
        off["p2b"] = off["p2a"] + I * B * V
        off["total"] = off["p2b"] + I * N * B * V
        return off

    # ------------------------------------------------------------------
    # Delta features (the delta group's sources; ir.py's declarations).
    # ``notbit`` (1 - bit over the whole universe) makes each bit-send's
    # int32 add exactly the set-OR, and ``sel1b`` is the one-hot over the
    # (mbal, mval) report positions the acceptor's (vb, vv) select:
    # Phase1b's message bit is the one data-dependent slot of the spec.
    # ------------------------------------------------------------------

    def delta_features(self, sv: State, der: State) -> torch.Tensor:
        R = sv["vb"].shape[-1]
        V = self.V
        notbit = 1 - der["bits"]                             # [n_bits, R]
        p = (sv["vb"].to(I32) + 1) * (V + 1) + (sv["vv"].to(I32) + 1)
        P = self._consts(p.device)["P"]
        sel1b = (p[:, :, None] == P[None, None, :, None]).to(I32)
        return torch.cat([notbit, sel1b.reshape(-1, R)])

    def delta_feature_offsets(self) -> Dict[str, int]:
        P = (self.B + 1) * (self.V + 1)
        off = dict(notbit=0, sel1b=self.lay.n_msg_bits)
        off["total"] = self.lay.n_msg_bits + self.I * self.N * P
        return off

    # ------------------------------------------------------------------
    # Action kernels (oracle twins in model.py)
    # ------------------------------------------------------------------

    def phase1a(self, sv: State, der: State, i, b) -> State:
        """model.phase1a: start (or preempt with) ballot b."""
        return self._glob(self._send(sv, self.lay.off_1a + i * self.B + b))

    def phase1b(self, sv: State, der: State, i, a, b) -> State:
        """model.phase1b: promise b, reporting the accepted pair."""
        B, V, N = self.B, self.V, self.N
        mbal = self._cell(sv["vb"], i, a).to(I32)
        mval = self._cell(sv["vv"], i, a).to(I32)
        idx = self.lay.off_1b + \
            (((i * N + a) * B + b) * (B + 1) + (mbal + 1)) * (V + 1) \
            + (mval + 1)
        sv2 = dict(sv, mb=self._set_cell(sv["mb"], i, a, b))
        return self._glob(self._send(sv2, idx))

    def phase2a(self, sv: State, der: State, i, b, v) -> State:
        """model.phase2a: propose v at b (the ∃-quorum rule is in
        ``derived``)."""
        return self._glob(self._send(
            sv, self.lay.off_2a + (i * self.B + b) * self.V + v))

    def phase2b(self, sv: State, der: State, i, a, b, v) -> State:
        """model.phase2b: accept (b, v)."""
        B, V, N = self.B, self.V, self.N
        sv2 = dict(sv,
                   mb=self._set_cell(sv["mb"], i, a, b),
                   vb=self._set_cell(sv["vb"], i, a, b),
                   vv=self._set_cell(sv["vv"], i, a, v))
        idx = self.lay.off_2b + ((i * N + a) * B + b) * V + v
        return self._glob(self._send(sv2, idx))
