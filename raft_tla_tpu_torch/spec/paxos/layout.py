"""Paxos packed-state layout + host codec.

The reference package's ``spec/paxos/layout.py``, with the torch forms
of ``narrow``/``widen`` the port's engines store rows with.  Device
representation: the same SoA-dict contract the engines already speak
(ops/codec.py docstring), with one structural simplification the
Paxos semantics buys us — **messages are a monotone SET over a finite
universe**, so the whole bag machinery (slots, counts, commutative
hashing, split-slot identity) collapses to a fixed-width **bitmask**:

    mb, vb, vv : i32[I, N]    per-(instance, acceptor) scalars (-1 = Nil)
    msgs       : u32[MW]      one bit per possible message (set = sent);
                              int32 bit patterns in tensors, uint32 in
                              numpy (``SpecIR.u32_keys``)
    ctr        : i32[NCTR]    the shared ctr contract (spec package):
                              C_GLOBLEN = actions taken, C_OVERFLOW = 0
                              (everything is statically bounded)

Bit universe, block-major with arithmetic indexing (the kernels compute
bit ids from lane params with closed-form products, no tables needed on
device):

    1a(b, i)                idx =                i*B + b
    1b(a, b, mbal, mval, i) idx = off1b + (((i*N + a)*B + b)*(B+1)
                                  + (mbal+1))*(V+1) + (mval+1)
    2a(b, v, i)             idx = off2a + (i*B + b)*V + v
    2b(a, b, v, i)          idx = off2b + ((i*N + a)*B + b)*V + v

Set-ness also makes every guard a bit test — ideal grist for the
guard-feature matmul — and makes the fingerprint purely positional:
acceptor relabeling permutes bit POSITIONS (never values), so the
salt-permutation trick of engine/fingerprint covers the entire state
with zero per-sigma value rewriting (fingerprint.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, Tuple

import numpy as np
import torch

from .. import C_GLOBLEN, NCTR
from .model import PaxosHist, PaxosState

VIEW_KEYS = ("mb", "vb", "vv", "msgs")
NONVIEW_KEYS = ("ctr",)
ALL_KEYS = VIEW_KEYS + NONVIEW_KEYS


@dataclass(frozen=True)
class PaxosLayout:
    cfg: object

    @cached_property
    def N(self):
        return self.cfg.n_servers

    @cached_property
    def B(self):
        return self.cfg.n_ballots

    @cached_property
    def V(self):
        return self.cfg.n_values

    @cached_property
    def I(self):
        return self.cfg.n_instances

    # ---- bit-block offsets ---------------------------------------------
    @cached_property
    def off_1a(self):
        return 0

    @cached_property
    def off_1b(self):
        return self.I * self.B

    @cached_property
    def off_2a(self):
        return self.off_1b + self.I * self.N * self.B * \
            (self.B + 1) * (self.V + 1)

    @cached_property
    def off_2b(self):
        return self.off_2a + self.I * self.B * self.V

    @cached_property
    def n_msg_bits(self):
        return self.off_2b + self.I * self.N * self.B * self.V

    @cached_property
    def msg_words(self):
        return (self.n_msg_bits + 31) // 32

    # ---- host-side bit index <-> oracle message ------------------------

    def idx_1a(self, b, i):
        return self.off_1a + i * self.B + b

    def idx_1b(self, a, b, mbal, mval, i):
        return self.off_1b + \
            (((i * self.N + a) * self.B + b) * (self.B + 1) +
             (mbal + 1)) * (self.V + 1) + (mval + 1)

    def idx_2a(self, b, v, i):
        return self.off_2a + (i * self.B + b) * self.V + v

    def idx_2b(self, a, b, v, i):
        return self.off_2b + \
            ((i * self.N + a) * self.B + b) * self.V + v

    def msg_index(self, m) -> int:
        t = m[0]
        if t == "1a":
            return self.idx_1a(m[1], m[2])
        if t == "1b":
            return self.idx_1b(m[1], m[2], m[3], m[4], m[5])
        if t == "2a":
            return self.idx_2a(m[1], m[2], m[3])
        if t == "2b":
            return self.idx_2b(m[1], m[2], m[3], m[4])
        raise ValueError(f"bad paxos message {m!r}")

    @cached_property
    def universe(self) -> Tuple[tuple, ...]:
        """Every representable message, indexed by bit id (decode side
        and the fingerprint permutation maps read this)."""
        out = [None] * self.n_msg_bits
        I, N, B, V = self.I, self.N, self.B, self.V
        for i in range(I):
            for b in range(B):
                out[self.idx_1a(b, i)] = ("1a", b, i)
        for i in range(I):
            for a in range(N):
                for b in range(B):
                    for mbal in range(-1, B):
                        for mval in range(-1, V):
                            out[self.idx_1b(a, b, mbal, mval, i)] = \
                                ("1b", a, b, mbal, mval, i)
        for i in range(I):
            for b in range(B):
                for v in range(V):
                    out[self.idx_2a(b, v, i)] = ("2a", b, v, i)
        for i in range(I):
            for a in range(N):
                for b in range(B):
                    for v in range(V):
                        out[self.idx_2b(a, b, v, i)] = ("2b", a, b, v, i)
        assert all(m is not None for m in out)
        return tuple(out)

    def perm_bit_map(self, sigma) -> np.ndarray:
        """bit id -> bit id of the acceptor-relabeled message (1b/2b
        carry an acceptor; 1a/2a map to themselves).  Drives the
        fingerprinter's statically permuted salt tables."""
        from .model import _perm_msg
        out = np.empty((self.n_msg_bits,), np.int64)
        for k, m in enumerate(self.universe):
            out[k] = self.msg_index(_perm_msg(m, sigma))
        return out

    def describe(self) -> str:
        return (f"PaxosLayout(N={self.N}, B={self.B}, V={self.V}, "
                f"I={self.I}, msg_bits={self.n_msg_bits}, "
                f"msg_words={self.msg_words})")


# ---------------------------------------------------------------------------
# Codec: oracle (PaxosState, PaxosHist) <-> SoA arrays
# ---------------------------------------------------------------------------

def encode(lay: PaxosLayout, sv: PaxosState, h: PaxosHist
           ) -> Dict[str, np.ndarray]:
    out = {
        "mb": np.array(sv.mb, np.int32).reshape(lay.I, lay.N),
        "vb": np.array(sv.vb, np.int32).reshape(lay.I, lay.N),
        "vv": np.array(sv.vv, np.int32).reshape(lay.I, lay.N),
    }
    words = np.zeros((lay.msg_words,), np.uint32)
    for m in sv.msgs:
        k = lay.msg_index(m)
        words[k >> 5] |= np.uint32(1) << np.uint32(k & 31)
    out["msgs"] = words
    ctr = np.zeros((NCTR,), np.int32)
    ctr[C_GLOBLEN] = len(h.glob)
    out["ctr"] = ctr
    return out


def decode(lay: PaxosLayout, arrs) -> Tuple[PaxosState, PaxosHist]:
    """SoA arrays -> (PaxosState, PaxosHist).  Like the raft decode,
    the history *sequence* is host-side only: the returned hist carries
    an empty glob (its length lives in ctr[C_GLOBLEN])."""
    a = {k: np.asarray(v) for k, v in arrs.items()}
    msgs = []
    words = a["msgs"].astype(np.uint32)
    for k, m in enumerate(lay.universe):
        if (int(words[k >> 5]) >> (k & 31)) & 1:
            msgs.append(m)
    sv = PaxosState(
        mb=tuple(tuple(int(x) for x in row) for row in a["mb"]),
        vb=tuple(tuple(int(x) for x in row) for row in a["vb"]),
        vv=tuple(tuple(int(x) for x in row) for row in a["vv"]),
        msgs=tuple(sorted(msgs)))
    return sv, PaxosHist(glob=())


def narrow(lay: PaxosLayout, arrs):
    """int32 SoA rows -> storage dtypes (ballot/value scalars fit int8
    under the <=32 config bounds; the bit words stay u32)."""
    dts = {"mb": np.int8, "vb": np.int8, "vv": np.int8,
           "msgs": np.uint32, "ctr": np.int32}
    return {k: v.astype(dts[k]) for k, v in arrs.items()}


def widen(arrs):
    """Storage rows -> the kernels' int32/uint32 contract."""
    return {k: v.astype(np.uint32) if k == "msgs"
            else v.astype(np.int32) for k, v in arrs.items()}


_STORAGE_T = {"mb": torch.int8, "vb": torch.int8, "vv": torch.int8,
              "msgs": torch.int32, "ctr": torch.int32}


def narrow_t(lay: PaxosLayout, arrs):
    """Torch form of narrow: int32 tensors -> storage dtypes (``msgs``
    stays int32, the u32 words' bit patterns)."""
    return {k: v.to(_STORAGE_T[k]) for k, v in arrs.items()}


def widen_t(arrs):
    """Torch form of widen: storage tensors -> the kernels' int32."""
    return {k: v.to(torch.int32) for k, v in arrs.items()}
