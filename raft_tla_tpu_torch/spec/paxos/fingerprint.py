"""Symmetry-canonical Paxos fingerprints (acceptor-permutation VIEW).

The reference package's ``spec/paxos/fingerprint.py``, bit for bit:
fp(s) = the canonical value over the acceptor permutations of a salted
positional hash of the VIEW (mb / vb / vv / the message bits; ctr
excluded).  Acceptor ids appear only as positions (the [I, N] columns
and the acceptor-indexed 1b/2b message bits), never inside stored
values, so relabeling a state under σ is hashing it in place against
statically permuted salt tables: per-acceptor columns permute by σ(a),
message-bit salts by the layout's ``perm_bit_map``.

Canonicalizers, as for raft (``engine/fingerprint.py``):

- "minperm": the lexicographic minimum over every permutation;
- "sort" (orbit-sort): a permutation-equivariant per-acceptor signature
  (``paxos_acceptor_signature``), stable-argsorted in unsigned order,
  gives a per-lane σ under which the state hashes once; a tie between
  adjacent sorted acceptors is certified by hashing under their
  transposition, and a lane with an uncertified tie (a "hard" lane)
  takes the minperm value.  The reference computes that fallback for
  the whole batch behind a ``lax.cond`` and keeps it on the hard lanes;
  here it runs on the first ``hcap`` live hard lanes only, gathered
  without a host read, and the engine replays a chunk whose hard lanes
  outran ``hcap``.  Each lane's value depends on that lane alone, so
  the values are the reference's.

Streams: two independent 32-bit streams (a 64-bit key), four with
fp128.  u32 values ride as int32 bit patterns (``utils``); every sum
passes ``dtype=torch.int32`` so that it wraps as the reference's u32
sums do.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...engine.fingerprint import (_FALLBACK_PERMS_PER_STEP, _SIGN,
                                   RaftFingerprinter, _as_i32, _first_lanes,
                                   _salts, lex_min_perms)
from ...utils import fmix32, fmix32_np, i32
from .kernels import PaxosKernels
from .layout import PaxosLayout
from .model import symmetry_perms

I32 = torch.int32


def paxos_acceptor_signature(fpr, svT: Dict, bits) -> torch.Tensor:
    """The permutation-equivariant per-acceptor signature [N, R]:
    acceptor a's column of mb/vb/vv folds over instances with
    per-instance salts, and every message bit the acceptor owns (the
    1b/2b blocks) adds its role weight — the bit's index with the owner
    relabeled to 0, hashed — so two acceptors tie exactly when their
    columns match and they own the same messages up to their own
    label."""
    c = fpr._consts(bits.device)
    isalt = c["inst_salts"][:, None, None]                # [I, 1, 1]
    sig = None
    for key, s in (("mb", 0x6B79D8A5), ("vb", 0x27D4EB2F),
                   ("vv", 0x165667B1)):
        M = svT[key].to(I32)                              # [I, N, R]
        fold = fmix32(M ^ isalt ^ i32(s)).sum(0, dtype=I32)
        sig = fold if sig is None else fmix32(sig + fold)
    # Σ_j role_w[a, j] · bit_j over the bits acceptor a owns (role_w is
    # zero elsewhere, so the sum is the reference's over every bit)
    owned = torch.stack([
        (c["role_w"][a][:, None] * bits[c["own_idx"][a]]).sum(0, dtype=I32)
        for a in range(fpr.lay.N)])
    return fmix32(sig + owned)


class PaxosFingerprinter:
    def __init__(self, cfg, sym_canon: str = "minperm"):
        if sym_canon not in ("sort", "minperm"):
            raise ValueError(f"sym_canon must be 'sort' or 'minperm' (a "
                             f"resolved mode), got {sym_canon!r}")
        self.sym_canon = sym_canon
        self.cfg = cfg
        self.lay = PaxosLayout(cfg)
        self.kern = PaxosKernels(self.lay)
        lay = self.lay
        self.n_streams = 4 if cfg.fp128 else 2
        # positions: mb | vb | vv (I*N each) | message bits
        self.n_scalar = 3 * lay.I * lay.N
        self.n_pos = self.n_scalar + lay.n_msg_bits
        self.pos_salts = [_salts(self.n_pos, 32 + t)
                          for t in range(self.n_streams)]
        perms = (symmetry_perms(cfg) if cfg.symmetry
                 else [tuple(range(lay.N))])
        self.sigmas = np.array(perms, dtype=np.int32)
        # statically permuted salt tables: psalts[p, t, i] is the salt
        # position i's content hashes against under σ_p
        idx = np.empty((len(perms), self.n_pos), dtype=np.int64)
        ar = np.arange(lay.N)
        for p, sig in enumerate(self.sigmas):
            off = 0
            for _blk in range(3):                      # mb vb vv
                for i in range(lay.I):
                    base = off + i * lay.N
                    idx[p, base:base + lay.N] = base + sig[ar]
                off += lay.I * lay.N
            idx[p, off:] = off + lay.perm_bit_map(tuple(int(x)
                                                        for x in sig))
        self.psalts = np.stack(
            [np.stack([self.pos_salts[t][idx[p]]
                       for t in range(self.n_streams)])
             for p in range(len(perms))])       # [P, n_streams, n_pos]
        if sym_canon == "sort":
            self._init_sort(lay)
        self._dev_cache = {}

    def _init_sort(self, lay):
        """Orbit-sort precompute.  Every owned message bit's layout
        index is affine in its owning acceptor (idx_1b/idx_2b are linear
        in ``a``), so bit j's salt under σ sits at j + (σ(owner_j) −
        owner_j)·stride_j (identity for the unowned 1a/2a blocks);
        owner/stride come from the closed forms and are checked against
        ``perm_bit_map`` here."""
        N, B, V = lay.N, lay.B, lay.V
        owner = np.zeros(lay.n_msg_bits, np.int32)
        stride = np.zeros(lay.n_msg_bits, np.int32)
        s1b = B * (B + 1) * (V + 1)
        j1b = np.arange(lay.off_2a - lay.off_1b)
        owner[lay.off_1b:lay.off_2a] = (j1b // s1b) % N
        stride[lay.off_1b:lay.off_2a] = s1b
        s2b = B * V
        j2b = np.arange(lay.n_msg_bits - lay.off_2b)
        owner[lay.off_2b:] = (j2b // s2b) % N
        stride[lay.off_2b:] = s2b
        jar = np.arange(lay.n_msg_bits)
        for sig in (np.roll(np.arange(N), 1), np.arange(N)[::-1]):
            ref = lay.perm_bit_map(tuple(int(x) for x in sig))
            chk = jar + (sig[owner] - owner) * stride
            assert np.array_equal(np.asarray(ref), chk), \
                "paxos owner/stride bit map diverged from perm_bit_map"
        self._bit_owner, self._bit_stride = owner, stride
        # role id: the bit's index with its owner relabeled to 0 —
        # equal for bits that are the same message up to the acceptor
        # label.  role_w[a, j] weights bit j into acceptor a's
        # signature (0 for bits a does not own).
        role = (jar - owner.astype(np.int64) * stride).astype(np.uint32)
        with np.errstate(over="ignore"):
            rw = fmix32_np(role * np.uint32(0x9E3779B1)
                           + np.uint32(0x85EBCA6B))
        owned = stride > 0
        self._role_w = np.where(
            owned[None, :] & (owner[None, :] == np.arange(N)[:, None]),
            rw[None, :], np.uint32(0))           # [N, n_msg_bits]
        self._inst_salts = _salts(lay.I, 44)
        self._sort_salt = _salts(self.n_streams, 49)
        from .. import spec_of
        self._sig_fn = spec_of(self.cfg).server_signature

    def _consts(self, device):
        """Per-device tensors of the static tables (built once)."""
        c = self._dev_cache.get(device)
        if c is None:
            def t(a):
                return torch.from_numpy(_as_i32(a).copy()).to(device)
            c = dict(psalts=t(self.psalts),
                     pos_salts=t(np.stack(self.pos_salts)))
            if self.sym_canon == "sort":
                own = [np.nonzero(self._role_w[a])[0]
                       for a in range(self.lay.N)]
                c.update(
                    owner=torch.from_numpy(
                        self._bit_owner.astype(np.int64)).to(device),
                    stride=torch.from_numpy(
                        self._bit_stride.astype(np.int64)).to(device),
                    own_idx=[torch.from_numpy(o).to(device) for o in own],
                    role_w=[t(self._role_w[a][o])
                            for a, o in enumerate(own)],
                    inst_salts=t(self._inst_salts),
                    sort_salt=t(self._sort_salt))
            self._dev_cache[device] = c
        return c

    def supports_incremental(self) -> bool:
        """No incremental-delta path, as the reference's: the direct
        positional sum is cheap at paxos sizes."""
        return False

    # ------------------------------------------------------------------

    def _flat(self, svT: Dict):
        """(bits int32 [n_bits, R], flat int32 [n_pos, R]): the hashed
        positions in order mb | vb | vv | message bits."""
        bits = self.kern.unpack_bits(svT["msgs"])
        R = bits.shape[-1]
        flat = torch.cat([svT[k].to(I32).reshape(-1, R)
                          for k in ("mb", "vb", "vv")] + [bits])
        return bits, flat

    def _hash_under(self, flat, psalt) -> torch.Tensor:
        """One salted positional hash -> [T, R]; psalt is a static
        [T, n_pos] table or a per-lane gathered [T, n_pos, R] one."""
        out = []
        for t in range(self.n_streams):
            p_t = psalt[t]
            if p_t.dim() == 1:
                p_t = p_t[:, None]
            out.append(fmix32(flat ^ p_t).sum(0, dtype=I32))
        return torch.stack(out)

    # the raft fingerprinter's lexicographic min and sealer: both read
    # only ``n_streams``
    _lex_min = RaftFingerprinter._lex_min
    _seal = RaftFingerprinter._seal

    def _min_over_perms(self, flat) -> torch.Tensor:
        c = self._consts(flat.device)
        best = self._hash_under(flat, c["psalts"][0])
        for p in range(1, len(self.sigmas)):
            best = self._lex_min(best, self._hash_under(flat,
                                                        c["psalts"][p]))
        return best

    def _min_over_perms_lanes(self, flat, idx) -> torch.Tensor:
        """The minperm value [T, H] of lanes ``idx`` [H]: per step a
        block of permutations hashed as one batch over the gathered
        lanes, with a running lexicographic min across steps."""
        c = self._consts(flat.device)
        sub = flat[:, idx]                             # [n_pos, H]
        H, P, T = idx.shape[0], len(self.sigmas), self.n_streams
        best = None
        for lo in range(0, P, _FALLBACK_PERMS_PER_STEP):
            hi = min(P, lo + _FALLBACK_PERMS_PER_STEP)
            ps = c["psalts"][lo:hi]                    # [Pb, T, n_pos]
            h = torch.stack([
                fmix32(sub[None] ^ ps[:, t, :, None]).sum(1, dtype=I32)
                for t in range(T)], 1)                 # [Pb, T, H]
            m = lex_min_perms(h)
            best = m if best is None else self._lex_min(best, m)
        return best

    # ---- orbit-sort -----------------------------------------------------

    def _sort_perm(self, sig):
        """sig [N, R] -> (π int32 [N, R] old id -> canonical slot, the
        adjacent-pair tie certificates).  The group is the full S_N:
        one block; argsort in unsigned order, as the reference's u32."""
        N = self.lay.N
        order = torch.argsort(sig ^ _SIGN, dim=0, stable=True)
        pi = torch.empty_like(sig)
        pi.scatter_(0, order, torch.arange(N, dtype=I32, device=sig.device)
                    [:, None].expand_as(order).contiguous())
        ss = sig.gather(0, order)
        return pi, [(r, r + 1, ss[r] == ss[r + 1]) for r in range(N - 1)]

    def _dyn_psalts(self, pi) -> torch.Tensor:
        """pos_salts gathered under a per-lane permutation pi [N, R]:
        the tensor form of __init__'s static index construction, with
        the message bits' affine owner/stride map.  -> [T, n_pos, R]."""
        lay = self.lay
        I, N = lay.I, lay.N
        c = self._consts(pi.device)
        pil = pi.long()
        parts, off = [], 0
        iar = torch.arange(I, device=pi.device)[:, None, None]
        for _blk in range(3):                          # mb vb vv
            parts.append((off + iar * N + pil[None]).reshape(I * N, -1))
            off += I * N
        own, stride = c["owner"], c["stride"]
        jar = torch.arange(lay.n_msg_bits, device=pi.device)[:, None]
        parts.append(off + jar + (pil[own] - own[:, None]) * stride[:, None])
        return c["pos_salts"][:, torch.cat(parts)]

    def _sort_hashes(self, svT: Dict, bits, flat):
        sig = self._sig_fn(self, svT, bits)               # [N, R]
        pi, ties = self._sort_perm(sig)
        h0 = self._hash_under(flat, self._dyn_psalts(pi))
        hard = torch.zeros(h0.shape[1:], dtype=torch.bool, device=h0.device)
        tie = torch.zeros_like(hard)
        for a, b, eq in ties:
            tie = tie | eq
            pit = torch.where(pi == a, b, torch.where(pi == b, a, pi))
            ht = self._hash_under(flat, self._dyn_psalts(pit))
            hard = hard | (eq & ~(ht == h0).all(0))
        return h0, hard, tie

    def _core_sort(self, svT, bits, flat, hcap: Optional[int],
                   live: Optional[torch.Tensor]):
        """Sort-mode fingerprints [T, R] and the hard-lane count (0-d).
        hcap None: every hard lane takes the fallback (found with a host
        read); else the first hcap live hard lanes do, with no read, and
        the caller holds the count to hcap.  A lane outside ``live`` is
        never hard (nothing may read its value)."""
        h0, hard, _tie = self._sort_hashes(svT, bits, flat)
        if live is not None:
            hard = hard & live
        R = h0.shape[1]
        n_hard = hard.sum()
        idx = hard.nonzero().squeeze(1) if hcap is None \
            else _first_lanes(hard, hcap)
        fp = h0
        if idx.numel() and R:
            fb = self._min_over_perms_lanes(flat, idx.clamp(max=R - 1))
            # column R takes the padding lanes of a fixed-width gather
            fp = torch.cat([h0, h0[:, :1]], 1)
            fp[:, idx] = fb
            fp = fp[:, :R]
        c = self._consts(h0.device)
        return self._seal(fmix32(fp ^ c["sort_salt"][:, None])), n_hard

    def _core(self, svT: Dict, hcap: Optional[int] = None,
              live: Optional[torch.Tensor] = None):
        bits, flat = self._flat(svT)
        if self.sym_canon == "sort" and len(self.sigmas) > 1:
            return self._core_sort(svT, bits, flat, hcap, live)
        return self._seal(self._min_over_perms(flat)), None

    # ---- the engine's entry points (RaftFingerprinter's interface) ------

    def fingerprint_batch_T(self, svT: Dict) -> torch.Tensor:
        """Batch-last [..., R] rows -> int32-carried u32 [T, R]."""
        return self._core(svT)[0]

    def fingerprint_chunk_T(self, svT: Dict, hcap: int,
                            live: Optional[torch.Tensor] = None):
        """The engine's form of ``fingerprint_batch_T``: no host read.
        Returns (fp [T, R], n_hard): in sort mode n_hard counts the hard
        lanes among ``live`` [R] (all when None) as a 0-d device tensor,
        and fp is exact on the live lanes when n_hard <= hcap; in
        minperm mode n_hard is None."""
        return self._core(svT, hcap, live)

    def fingerprint_batch(self, svb: Dict) -> torch.Tensor:
        """Batch-first [R, ...] rows -> [R, T]."""
        return self.fingerprint_batch_T(
            {k: v.movedim(0, -1) for k, v in svb.items()}).T

    def fingerprint(self, sv: Dict) -> torch.Tensor:
        """One state's arrays -> [T]."""
        return self.fingerprint_batch_T(
            {k: v[..., None] for k, v in sv.items()})[:, 0]

    def sort_debug(self, svb: Dict) -> Dict[str, np.ndarray]:
        """Per-state (hard, tie) masks of batch-first [R, ...] rows under
        the sort canonicalizer (tests)."""
        assert self.sym_canon == "sort"
        svT = {k: v.movedim(0, -1) for k, v in svb.items()}
        bits, flat = self._flat(svT)
        _h0, hard, tie = self._sort_hashes(svT, bits, flat)
        return dict(hard=hard.cpu().numpy(), tie=tie.cpu().numpy())
