"""Symmetry-canonical state fingerprints and the visited-table dedup.

Fingerprints follow the reference's ``engine/fingerprint.py`` bit for
bit: the hash covers the 10 VIEW variables (raft.cfg:30), positional
fields hash with per-position salts and the message bag commutatively
(Σ over slots of count · mix(slot)), and relabeling a state under a
server permutation σ is done by permuting the salts (``psalts``), so
only the label-carrying values (votedFor, vote masks, ConfigEntry
payloads, message src/dst/mserver) are rewritten per σ.  Salts come
from the same ``numpy.random.RandomState`` seeds as the reference, so
the values match it exactly.  The canonicalizers are the reference's:

- "minperm": the lexicographic minimum over the symmetry group G
  (permutations fixing InitServer setwise) of the relabeled hash,

    fp(s) = min_{σ ∈ G} H(relabel(s, σ));

- incremental (a minperm variant for the engine): each successor's
  per-σ hash is its parent's plus the term deltas at the positions its
  action family touches (``parent_tables``, ``family_delta``,
  ``finish_min``) — every stream is a wrapping u32 sum, so the values
  equal the direct ones bit for bit;
- "sort" (orbit-sort): a permutation-equivariant per-server signature
  (``raft_server_signature``, 1-WL color refinement), argsorted within
  each symmetry block, gives a per-lane σ under which the state hashes
  once; a tie between adjacent sorted servers is certified by hashing
  under their transposition, and a lane with an uncertified tie (a
  "hard" lane) takes the minperm value instead.  A per-stream fmix
  keeps sort-mode values apart from minperm ones.  The partition of
  states is the minperm one.

The second half of the module is the claim-insert dedup into the
open-addressing visited table: ``probe_claim_insert`` launches the
CUDA kernel (``csrc/probe_claim.cu``) on a CUDA table and runs its
plain twin, ``probe_claim_insert_plain``, on a CPU table.
``probe_claim_insert_rounds`` models the kernel's parallel claim rounds
in plain torch, for the tests.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import CONFIG_ENTRY, MT_COC, NIL, ModelConfig
from ..ops.kernels import I32, RaftKernels
from ..ops.layout import Layout, get_field_t, put_field_t
from ..utils import HOME_SALT, fmix32, fmix32_int, home_slots, i32, ult


def _salts(n: int, stream: int) -> np.ndarray:
    rng = np.random.RandomState(0xC0FFEE + 7919 * stream)
    return rng.randint(0, 1 << 32, size=n, dtype=np.uint32)


def _as_i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


SYM_CANON_MODES = ("auto", "sort", "minperm")
# auto -> orbit-sort once the group outgrows the trivial-cost regime
_AUTO_SORT_MIN_PERMS = 6
# incremental tables cost O(P · n_pos) per parent: past this many
# permutations the direct path is used (the reference's gate)
_INCREMENTAL_MAX_PERMS = 24
# the hard-lane fallback hashes this many permutations per step, as one
# per-lane-σ batch, keeping a running lexicographic min across steps
_FALLBACK_PERMS_PER_STEP = 24
_SIGN = i32(0x80000000)
_I64_MAX = (1 << 63) - 1


def resolve_sym_canon(cfg, sym_canon: str = "auto") -> str:
    """Engine mode -> the concrete canonicalizer ("sort" or "minperm"),
    as the reference resolves it.  Symmetry off always resolves to
    minperm; "auto" picks sort past 6 permutations."""
    if sym_canon not in SYM_CANON_MODES:
        raise ValueError(
            f"sym_canon must be one of {SYM_CANON_MODES}, "
            f"got {sym_canon!r}")
    if not cfg.symmetry:
        return "minperm"
    if sym_canon == "auto":
        from ..spec import spec_of
        n_perms = len(spec_of(cfg).symmetry_perms(cfg))
        return "sort" if n_perms > _AUTO_SORT_MIN_PERMS else "minperm"
    return sym_canon


def _lex_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two int32-carried u32 words -> int64 whose signed order is the
    lexicographic unsigned order of (hi, lo)."""
    return ((hi ^ _SIGN).to(torch.int64) << 32) | \
        (lo.to(torch.int64) & 0xFFFFFFFF)


def lex_min_perms(h: torch.Tensor) -> torch.Tensor:
    """[P, T, N] per-permutation hashes -> [T, N]: the lexicographic
    unsigned minimum over P (streams in order), in a few reductions
    over stream pairs packed into int64."""
    T, N = h.shape[1], h.shape[2]
    keep = None
    for w in range(0, T, 2):
        key = _lex_key(h[:, w], h[:, w + 1])                  # [P, N]
        if keep is not None:
            key = torch.where(keep, key, _I64_MAX)
        hit = key == key.min(0).values[None]
        keep = hit if keep is None else keep & hit
    first = keep.to(I32).argmax(0)                # a p attaining the min
    return h.gather(0, first.view(1, 1, N).expand(1, T, N)).squeeze(0)


def _first_lanes(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the first ``cap`` set lanes of ``mask`` [N], padded
    with N, without a host sync: int64 [cap]."""
    N = mask.shape[0]
    rank = torch.cumsum(mask.to(I32), 0) - 1
    tgt = torch.where(mask & (rank < cap), rank, cap).long()
    idx = torch.full((cap + 1,), N, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, tgt, torch.arange(N, device=mask.device))
    return idx[:cap]


def _map_lanes(prep: Dict, fn) -> Dict:
    """fn applied to every tensor of a _prep dict (its lane axis is
    last); const_flat's empty slots stay None."""
    return {k: [None if x is None else fn(x) for x in v]
            if isinstance(v, list) else fn(v) for k, v in prep.items()}


class RaftFingerprinter:
    def __init__(self, cfg: ModelConfig, sym_canon: str = "minperm"):
        if sym_canon not in ("sort", "minperm"):
            raise ValueError(f"sym_canon must be 'sort' or 'minperm' (a "
                             f"resolved mode), got {sym_canon!r}")
        self.sym_canon = sym_canon
        self.cfg = cfg
        self.lay = Layout(cfg)
        self.kern = RaftKernels(self.lay)
        S, Lcap = self.lay.S, self.lay.Lcap
        self.n_streams = 4 if cfg.fp128 else 2
        # positional salt layout: ct,st,vf,ci,llen | log | vr,vg | ni,mi
        self.n_pos = 5 * S + S * Lcap + 2 * S + 2 * S * S
        self.pos_salts = [_salts(self.n_pos, t)
                          for t in range(self.n_streams)]
        self.bag_salts = [_salts(self.lay.msg_words + 1, 16 + t)
                          for t in range(self.n_streams)]
        if cfg.symmetry:
            from ..spec import spec_of
            perms = spec_of(cfg).symmetry_perms(cfg)
        else:
            perms = [tuple(range(S))]
        self.sigmas = np.array(perms, dtype=np.int32)           # [P, S]
        # statically permuted salt tables: psalts[p, t, i] is the salt a
        # value at original flat position i hashes against under σ_p
        idx = np.empty((len(perms), self.n_pos), dtype=np.int64)
        ar = np.arange(S)
        for p, sig in enumerate(self.sigmas):
            off = 0
            for _blk in range(5):                        # ct st vf ci llen
                idx[p, off:off + S] = off + sig[ar]
                off += S
            blk = (sig[ar][:, None] * Lcap +
                   np.arange(Lcap)[None, :]).reshape(-1)  # log
            idx[p, off:off + S * Lcap] = off + blk
            off += S * Lcap
            for _blk in range(2):                        # vr vg
                idx[p, off:off + S] = off + sig[ar]
                off += S
            blk2 = (sig[ar][:, None] * S + sig[ar][None, :]).reshape(-1)
            for _blk in range(2):                        # ni mi
                idx[p, off:off + S * S] = off + blk2
                off += S * S
            assert off == self.n_pos
        self.psalts = np.stack(
            [np.stack([self.pos_salts[t][idx[p]]
                       for t in range(self.n_streams)])
             for p in range(len(perms))])          # [P, n_streams, n_pos]
        if sym_canon == "sort":
            # orbit-sort state: the symmetry blocks (every σ in the group
            # fixes InitServer setwise, so the sort never moves a server
            # across the inside/outside boundary), a per-block salt in
            # the signature so servers of different blocks never tie,
            # per-log-slot signature salts, and the per-stream salt of
            # the final bijection that separates sort-mode values from
            # minperm ones
            inside = [i for i in range(S) if cfg.init_mask >> i & 1]
            outside = [i for i in range(S)
                       if not (cfg.init_mask >> i & 1)]
            self._blocks = [np.array(b, np.int32)
                            for b in (inside, outside) if b]
            bsalt = _salts(len(self._blocks), 41)
            blk = np.zeros(S, np.uint32)
            for bi, b in enumerate(self._blocks):
                blk[b] = bsalt[bi]
            self._blk_salt = blk
            self._log_sig_salts = _salts(Lcap, 42)
            self._sort_salt = _salts(self.n_streams, 49)
            from ..spec import spec_of
            self._sig_fn = spec_of(cfg).server_signature
        self._dev_cache = {}

    def _consts(self, device):
        """Per-device tensors of the static tables (built once)."""
        c = self._dev_cache.get(device)
        if c is None:
            def t(a):
                return torch.from_numpy(_as_i32(a).copy()).to(device)
            c = dict(psalts=t(self.psalts),
                     pos_salts=t(np.stack(self.pos_salts)),
                     bag_salts=[t(b) for b in self.bag_salts],
                     sigmas=torch.from_numpy(self.sigmas.copy()).to(device))
            if self.sym_canon == "sort":
                c.update(blocks=[torch.from_numpy(b.astype(np.int64))
                                 .to(device) for b in self._blocks],
                         blk_salt=t(self._blk_salt),
                         log_sig_salts=t(self._log_sig_salts),
                         sort_salt=t(self._sort_salt))
            self._dev_cache[device] = c
        return c

    # ------------------------------------------------------------------
    # the hashing core: a state relabeled under σ, where σ is one static
    # permutation [S] or a per-lane permutation [S, N]
    # ------------------------------------------------------------------

    def _perm_mask(self, m, sigma):
        """Relabel a server bitmask under σ ([S] or per-lane [S, N])."""
        out = torch.zeros_like(m)
        for i in range(self.lay.S):
            out = out | (((m >> i) & 1) << sigma[i])
        return out

    def _prep(self, svT: Dict) -> Dict:
        """Perm-independent hashing precompute: bag header fields
        unpacked once, log/entry ConfigEntry payloads split once."""
        lay, kern = self.lay, self.kern
        hs = lay.header_shifts
        bag = svT["bag"]                                  # [K, MW, N]
        w0 = bag[:, 0]
        mtype = get_field_t(w0, hs["mtype"])
        clear = i32(0xFFFFFFFF ^ (
            ((1 << hs["msrc"][1]) - 1) << hs["msrc"][0] |
            ((1 << hs["mdst"][1]) - 1) << hs["mdst"][0] |
            ((1 << hs["b"][1]) - 1) << hs["b"][0]))
        ebits, epw = lay.entry_bits, lay.entries_per_word
        emask = (1 << ebits) - 1
        ent = torch.stack([
            get_field_t(bag[:, 1 + k // epw], (ebits * (k % epw), ebits))
            & emask for k in range(lay.Lmax)], dim=1)      # [K, Lmax, N]
        vmask = (1 << lay.value_bits) - 1

        def split_cfg(e):
            """entry -> (is_cfg, payload-cleared base, payload)."""
            is_cfg = (kern.entry_type(e) == CONFIG_ENTRY) & (e != 0)
            return is_cfg, e & ~vmask, e & vmask

        ent_cfg, ent_base, ent_pay = split_cfg(ent)
        log = svT["log"]                                  # [S, Lcap, N]
        log_cfg, log_base, log_pay = split_cfg(log)
        const_flat = [svT["ct"], svT["st"], None, svT["ci"], svT["llen"],
                      None, None, None, svT["ni"], svT["mi"]]
        return dict(bag=bag, w0=w0, src=get_field_t(w0, hs["msrc"]),
                    dst=get_field_t(w0, hs["mdst"]),
                    braw=get_field_t(w0, hs["b"]),      # stored +1
                    w0_base=w0 & clear, empty=mtype == 0,
                    is_coc=mtype == MT_COC, ent=ent, ent_cfg=ent_cfg,
                    ent_base=ent_base, ent_pay=ent_pay, log=log,
                    log_cfg=log_cfg, log_base=log_base, log_pay=log_pay,
                    vf=svT["vf"], vr=svT["vr"], vg=svT["vg"],
                    cnt=svT["cnt"], const_flat=const_flat)

    def _relabel(self, prep: Dict, sigma: torch.Tensor):
        """The hashed content under σ: (flat [n_pos, N], the bag's
        message words, MW tensors [K, N])."""
        lay = self.lay
        S = lay.S
        hs = lay.header_shifts
        N = prep["w0"].shape[-1]
        if sigma.dim() == 1:
            def sub(idx):
                return sigma[idx.clamp(0, S - 1).long()]
        else:
            def sub(idx):
                return sigma.gather(0, idx.clamp(0, S - 1).long())

        # ---- label-carrying content, relabeled under σ ----
        vf = prep["vf"]
        vfp = torch.where(vf >= 0, sub(vf), NIL)
        vrp = self._perm_mask(prep["vr"], sigma)
        vgp = self._perm_mask(prep["vg"], sigma)
        logp = torch.where(prep["log_cfg"],
                           prep["log_base"] |
                           self._perm_mask(prep["log_pay"], sigma),
                           prep["log"])
        pieces = list(prep["const_flat"])
        pieces[2], pieces[5], pieces[6], pieces[7] = vfp, logp, vrp, vgp
        flat = torch.cat([x.reshape(-1, N) for x in pieces])  # [n_pos, N]

        # ---- bag header/entry repack (only label fields change) --
        srcp = sub(prep["src"])
        dstp = sub(prep["dst"])
        bp = torch.where(prep["is_coc"], sub(prep["braw"] - 1) + 1,
                         prep["braw"])
        w0p = (prep["w0_base"] | put_field_t(srcp, hs["msrc"]) |
               put_field_t(dstp, hs["mdst"]) | put_field_t(bp, hs["b"]))
        w0p = torch.where(prep["empty"], prep["w0"], w0p)
        entp = torch.where(prep["ent_cfg"],
                           prep["ent_base"] |
                           self._perm_mask(prep["ent_pay"], sigma),
                           prep["ent"])
        ebits, epw = lay.entry_bits, lay.entries_per_word
        words = [w0p]
        for w in range(1, lay.msg_words):
            acc = torch.zeros_like(prep["w0"])
            for k in range((w - 1) * epw, min(w * epw, lay.Lmax)):
                acc = acc | (entp[:, k] << (ebits * (k % epw)))
            words.append(torch.where(prep["empty"], prep["bag"][:, w], acc))
        return flat, words

    def _terms(self, prep: Dict, flat, words, t: int, psalt_t):
        """Stream t's per-position terms [n_pos, N] and per-slot bag
        terms [K, N]; psalt_t is [n_pos] or per-lane [n_pos, N]."""
        if psalt_t.dim() == 1:
            psalt_t = psalt_t[:, None]
        bs = self._consts(flat.device)["bag_salts"][t]
        slot = torch.zeros_like(prep["w0"])
        for w in range(self.lay.msg_words):
            slot = slot + fmix32(words[w] ^ bs[w])
        return fmix32(flat ^ psalt_t), prep["cnt"] * fmix32(slot ^ bs[-1])

    def _hash_under(self, prep: Dict, sigma: torch.Tensor,
                    psalt: torch.Tensor) -> torch.Tensor:
        """One salted hash of the states under σ -> int32 [T, N].  σ is
        a static permutation [S] with its salts psalt [T, n_pos], or a
        per-lane permutation [S, N] with per-lane salts [T, n_pos, N];
        the two forms agree bit for bit whenever the permutations do."""
        flat, words = self._relabel(prep, sigma)
        out = []
        for t in range(self.n_streams):
            pt, bt = self._terms(prep, flat, words, t, psalt[t])
            out.append(pt.sum(0, dtype=I32) + bt.sum(0, dtype=I32))
        return torch.stack(out)                           # [T, N]

    def _lex_min(self, best, cand):
        """Lexicographic unsigned min of two [T, N] hash stacks."""
        less = torch.zeros_like(best[0], dtype=torch.bool)
        eq = torch.ones_like(less)
        for t in range(self.n_streams):
            less = less | (eq & ult(cand[t], best[t]))
            eq = eq & (cand[t] == best[t])
        return torch.where(less, cand, best)

    def _seal(self, best):
        """The visited table's empty-slot sentinel is the all-ones key;
        remap an all-ones fingerprint to a fixed alternate so real keys
        never alias it."""
        allones = (best == -1).all(0)
        last = self.n_streams - 1
        best = best.clone()
        best[last] = torch.where(allones, i32(0xFFFFFFFE), best[last])
        return best

    def _min_over_perms(self, prep: Dict) -> torch.Tensor:
        """The minperm value [T, N]: every static σ in turn, with a
        running lexicographic min."""
        c = self._consts(prep["w0"].device)
        best = self._hash_under(prep, c["sigmas"][0], c["psalts"][0])
        for p in range(1, len(self.sigmas)):
            best = self._lex_min(best, self._hash_under(
                prep, c["sigmas"][p], c["psalts"][p]))
        return best

    def _min_over_perms_lanes(self, prep: Dict,
                              idx: torch.Tensor) -> torch.Tensor:
        """The minperm value [T, H] of lanes ``idx`` [H]: per step a
        block of permutations hashed as one per-lane-σ batch over the
        gathered lanes, with a running lexicographic min across
        steps."""
        c = self._consts(idx.device)
        sub = _map_lanes(prep, lambda x: x[..., idx])
        H, P, T = idx.shape[0], len(self.sigmas), self.n_streams
        best = None
        for lo in range(0, P, _FALLBACK_PERMS_PER_STEP):
            hi = min(P, lo + _FALLBACK_PERMS_PER_STEP)
            sig = c["sigmas"][lo:hi].T.repeat_interleave(H, dim=1)
            psalt = c["psalts"][lo:hi].permute(1, 2, 0) \
                .repeat_interleave(H, dim=2)         # [T, n_pos, Pb*H]
            # lane p*H + j is lane j under permutation lo + p
            tiled = _map_lanes(sub, lambda x: x.repeat(
                (1,) * (x.dim() - 1) + (hi - lo,)))
            h = self._hash_under(tiled, sig, psalt)
            m = lex_min_perms(h.view(T, hi - lo, H).transpose(0, 1))
            best = m if best is None else self._lex_min(best, m)
        return best

    # ------------------------------------------------------------------
    # Orbit-sort canonicalization (the reference's round 15).  Instead
    # of hashing under every σ (×P work per candidate, P = 120 on config
    # #5), compute a permutation-equivariant per-server signature,
    # stable-argsort it within each symmetry block and hash once under
    # the sorting permutation π.  If the sorted signatures are strictly
    # increasing in every block, π is unique up to the state's
    # stabilizer and the hash is an orbit invariant.  A tie leaves the
    # residual subgroup generated by the adjacent transpositions of the
    # tie runs: if each tied transposition leaves the hash fixed, the
    # whole residual subgroup stabilizes the representative (the lane is
    # "soft"); otherwise the lane is "hard" and takes the exact minperm
    # value.  Hard/soft is itself orbit-invariant, so the partition is
    # the minperm one.  The reference gates the P-fold pass on any hard
    # lane in the chunk (lax.cond); here it runs on the hard lanes
    # alone, gathered into a fixed-width buffer without a host sync
    # when the caller gives a capacity.
    # ------------------------------------------------------------------

    def _sort_perm(self, sig):
        """Per-lane canonicalizing permutation π (old id -> canonical
        slot) from the signature [S, N]: a stable argsort in unsigned
        order within each symmetry block.  Returns (π int32 [S, N],
        ties): ties is the static list of (slot_a, slot_b, eq [N])
        adjacent-pair certificates; block boundaries make no entry."""
        S, N = self.lay.S, sig.shape[1]
        c = self._consts(sig.device)
        pi = torch.zeros((S, N), dtype=I32, device=sig.device)
        ties = []
        for blk, bj in zip(self._blocks, c["blocks"]):
            sigb = sig[bj]                                # [m, N]
            # torch sorts int32 as signed: flipping the sign bit gives
            # the reference's unsigned order
            order = torch.argsort(sigb ^ _SIGN, dim=0, stable=True)
            src = bj[order]               # old ids in canonical order
            pi.scatter_(0, src, bj[:, None].to(I32).expand_as(src))
            ss = sigb.gather(0, order)
            for r in range(len(blk) - 1):
                ties.append((int(blk[r]), int(blk[r + 1]),
                             ss[r] == ss[r + 1]))
        return pi, ties

    def _dyn_psalts(self, pi):
        """pos_salts gathered under a per-lane permutation — the tensor
        form of __init__'s static psalts index construction.
        pi [S, N] -> [T, n_pos, N]."""
        S, Lcap = self.lay.S, self.lay.Lcap
        parts, off = [], 0
        for _blk in range(5):                        # ct st vf ci llen
            parts.append(off + pi)
            off += S
        lg = off + pi[:, None] * Lcap + torch.arange(
            Lcap, dtype=I32, device=pi.device)[None, :, None]
        parts.append(lg.reshape(S * Lcap, -1))       # log
        off += S * Lcap
        for _blk in range(2):                        # vr vg
            parts.append(off + pi)
            off += S
        for _blk in range(2):                        # ni mi
            sq = off + pi[:, None] * S + pi[None, :]
            parts.append(sq.reshape(S * S, -1))
            off += S * S
        idx = torch.cat(parts).long()                # [n_pos, N]
        return self._consts(pi.device)["pos_salts"][:, idx]

    def _sort_hashes(self, prep: Dict, svT: Dict):
        """Shared sort-path body: (h0 [T, N], hard [N], tie [N])."""
        sig = self._sig_fn(self, svT, prep)               # [S, N]
        pi, ties = self._sort_perm(sig)
        h0 = self._hash_under(prep, pi, self._dyn_psalts(pi))
        hard = torch.zeros(h0.shape[1:], dtype=torch.bool,
                           device=h0.device)
        tie = torch.zeros_like(hard)
        for a, b, eq in ties:
            tie = tie | eq
            pit = torch.where(pi == a, b, torch.where(pi == b, a, pi))
            ht = self._hash_under(prep, pit, self._dyn_psalts(pit))
            hard = hard | (eq & ~(ht == h0).all(0))
        return h0, hard, tie

    def _core_sort(self, prep: Dict, svT: Dict, hcap: Optional[int],
                   live: Optional[torch.Tensor] = None):
        """Sort-mode fingerprints [T, N] and the hard-lane count (a 0-d
        device tensor).  hcap None: every hard lane takes the fallback
        (found with a host sync); else the first hcap hard lanes do,
        with no sync, and the caller must hold the count to hcap.  A
        lane outside ``live`` [N] is never hard (its value is not
        canonical then, and nothing may read it)."""
        h0, hard, _tie = self._sort_hashes(prep, svT)
        if live is not None:
            hard = hard & live
        N = h0.shape[1]
        n_hard = hard.sum()
        idx = hard.nonzero().squeeze(1) if hcap is None \
            else _first_lanes(hard, hcap)
        fp = h0
        if idx.numel() and N:
            fb = self._min_over_perms_lanes(prep, idx.clamp(max=N - 1))
            # column N takes the padding lanes of a fixed-width gather
            fp = torch.cat([h0, h0[:, :1]], 1)
            fp[:, idx] = fb
            fp = fp[:, :N]
        c = self._consts(h0.device)
        return self._seal(fmix32(fp ^ c["sort_salt"][:, None])), n_hard

    def _core(self, svT: Dict, hcap: Optional[int] = None,
              live: Optional[torch.Tensor] = None):
        prep = self._prep(svT)
        if self.sym_canon == "sort" and len(self.sigmas) > 1:
            return self._core_sort(prep, svT, hcap, live)
        return self._seal(self._min_over_perms(prep)), None

    def fingerprint_batch_T(self, svT: Dict) -> torch.Tensor:
        """Batch-last [..., N] rows -> int32-carried u32 [T, N]."""
        return self._core(svT)[0]

    def fingerprint_chunk_T(self, svT: Dict, hcap: int,
                            live: Optional[torch.Tensor] = None):
        """The engine's form of ``fingerprint_batch_T``: no host sync.
        Returns (fp [T, N], n_hard): in sort mode n_hard is the count of
        the hard lanes among ``live`` [N] (all lanes when None) as a 0-d
        device tensor, and fp is exact on the live lanes only when
        n_hard <= hcap; in minperm mode n_hard is None."""
        return self._core(svT, hcap, live)

    def fingerprint_batch(self, svb: Dict) -> torch.Tensor:
        """Batch-first [N, ...] rows -> [N, T]."""
        return self.fingerprint_batch_T(
            {k: v.movedim(0, -1) for k, v in svb.items()}).T

    def fingerprint(self, sv: Dict) -> torch.Tensor:
        """One state's arrays -> [T]."""
        return self.fingerprint_batch_T(
            {k: v[..., None] for k, v in sv.items()})[:, 0]

    def sort_debug(self, svb: Dict) -> Dict[str, np.ndarray]:
        """Per-state (hard, tie) masks of batch-first [N, ...] rows under
        the sort canonicalizer (tests)."""
        assert self.sym_canon == "sort"
        svT = {k: v.movedim(0, -1) for k, v in svb.items()}
        _h0, hard, tie = self._sort_hashes(self._prep(svT), svT)
        return dict(hard=hard.cpu().numpy(), tie=tie.cpu().numpy())

    # ==================================================================
    # Incremental per-action fingerprints.  Every stream is a wrapping
    # u32 sum of per-position and per-bag-slot terms, so a successor's
    # per-permutation hash is exactly
    #
    #   h_p(s') = h_p(s) + Σ_{touched pos i} [term_p(new_i) − term_p(old_i)]
    #           + Σ_{changed slot k} [bagterm_p(new_k) − bagterm_p(old_k)]
    #
    # The engine computes, once per frontier chunk, every parent's
    # per-term table (``parent_tables``), and each candidate evaluates
    # terms only at its action family's touched-position superset
    # (``family_delta``; unchanged positions cancel, so supersets are
    # sound), then takes the min over σ (``finish_min``).  The touch
    # supersets follow ops/kernels.py's masked writes; the bag side is a
    # generic diff of at most two changed slots (an action sends and/or
    # consumes at most one message).
    # ==================================================================

    # families whose kernels touch the message bag (ops/kernels.py)
    _BAG_FAMILIES = frozenset((
        "RequestVote", "AppendEntries", "CocDiscard", "Receive",
        "Duplicate", "Drop", "AddNewServer", "DeleteServer"))

    def supports_incremental(self) -> bool:
        """Sort mode has no per-σ delta algebra (π depends on the
        state), and past 24 permutations the parent tables outweigh the
        win: both take the direct path."""
        if self.sym_canon == "sort":
            return False
        return len(self.sigmas) <= _INCREMENTAL_MAX_PERMS

    def _offsets(self):
        S, Lcap = self.lay.S, self.lay.Lcap
        return dict(ct=0, st=S, vf=2 * S, ci=3 * S, llen=4 * S,
                    log=5 * S, vr=5 * S + S * Lcap,
                    vg=6 * S + S * Lcap, ni=7 * S + S * Lcap,
                    mi=7 * S + S * Lcap + S * S)

    def _perm_mask_P(self, m, sig):
        """m [cap] -> [P, cap]: perm_mask under every σ at once."""
        out = torch.zeros((sig.shape[0],) + m.shape, dtype=I32,
                          device=m.device)
        for i in range(self.lay.S):
            out = out | (((m >> i) & 1)[None] << sig[:, i][:, None])
        return out

    def parent_tables(self, svT: Dict) -> Dict:
        """Batch-last parent rows [..., B] -> per-term tables: posterm
        [P, T, n_pos, B], bagterm [P, T, K, B], h [P, T, B] — the direct
        hash's arithmetic with the per-term sums kept."""
        prep = self._prep(svT)
        c = self._consts(prep["w0"].device)
        post, bagt, hsum = [], [], []
        for p in range(len(self.sigmas)):
            flat, words = self._relabel(prep, c["sigmas"][p])
            pts, bts = [], []
            for t in range(self.n_streams):
                pt, bt = self._terms(prep, flat, words, t, c["psalts"][p, t])
                pts.append(pt)
                bts.append(bt)
            post.append(torch.stack(pts))
            bagt.append(torch.stack(bts))
            hsum.append(torch.stack([pt.sum(0, dtype=I32) +
                                     bt.sum(0, dtype=I32)
                                     for pt, bt in zip(pts, bts)]))
        return dict(posterm=torch.stack(post), bagterm=torch.stack(bagt),
                    h=torch.stack(hsum))

    def _slot_terms(self, words, cnt, sig):
        """One bag slot per candidate (words [MW, cap], cnt [cap]) -> its
        per-(perm, stream) bag term [P, T, cap]: the single-slot twin of
        parent_tables' bag reduction."""
        lay = self.lay
        hs = lay.header_shifts
        S = lay.S
        c = self._consts(words.device)
        w0 = words[0]
        mtype = get_field_t(w0, hs["mtype"])
        src = get_field_t(w0, hs["msrc"])
        dst = get_field_t(w0, hs["mdst"])
        braw = get_field_t(w0, hs["b"])
        clear = i32(0xFFFFFFFF ^ (
            ((1 << hs["msrc"][1]) - 1) << hs["msrc"][0] |
            ((1 << hs["mdst"][1]) - 1) << hs["mdst"][0] |
            ((1 << hs["b"][1]) - 1) << hs["b"][0]))
        w0_base = w0 & clear
        empty = mtype == 0
        is_coc = mtype == MT_COC
        ebits, epw = lay.entry_bits, lay.entries_per_word
        emask = (1 << ebits) - 1
        vmask = (1 << lay.value_bits) - 1
        srcp = sig[:, src.clamp(0, S - 1).long()]           # [P, cap]
        dstp = sig[:, dst.clamp(0, S - 1).long()]
        bp = torch.where(is_coc[None],
                         sig[:, (braw - 1).clamp(0, S - 1).long()] + 1,
                         braw[None])
        w0p = (w0_base[None] | put_field_t(srcp, hs["msrc"]) |
               put_field_t(dstp, hs["mdst"]) | put_field_t(bp, hs["b"]))
        w0p = torch.where(empty[None], w0[None], w0p)       # [P, cap]
        wordsp = [w0p]
        if lay.msg_words > 1:
            ent = [get_field_t(words[1 + k // epw],
                               (ebits * (k % epw), ebits)) & emask
                   for k in range(lay.Lmax)]
            for w in range(1, lay.msg_words):
                acc = torch.zeros_like(w0p)
                for k in range((w - 1) * epw, min(w * epw, lay.Lmax)):
                    e = ent[k]
                    is_cfg = (self.kern.entry_type(e) == CONFIG_ENTRY) \
                        & (e != 0)
                    ep = torch.where(is_cfg[None],
                                     (e & ~vmask)[None] |
                                     self._perm_mask_P(e & vmask, sig),
                                     e[None])
                    acc = acc | (ep << (ebits * (k % epw)))
                wordsp.append(torch.where(empty[None], words[w][None],
                                          acc))
        out = []
        for t in range(self.n_streams):
            bs = c["bag_salts"][t]
            slot = torch.zeros_like(w0p)
            for w in range(lay.msg_words):
                slot = slot + fmix32(wordsp[w] ^ bs[w])
            out.append(cnt[None] * fmix32(slot ^ bs[-1]))
        return torch.stack(out, dim=1)                      # [P, T, cap]

    def family_delta(self, name: str, tables: Dict, b_idx: torch.Tensor,
                     parT: Dict, candT: Dict, params) -> torch.Tensor:
        """Per-candidate per-permutation hashes [P, T, cap] for one
        action family's rows: parent hash + touched-term deltas.  parT
        and candT are batch-last [..., cap]; b_idx maps rows to the
        chunk's parent index (the tables' B axis)."""
        lay = self.lay
        S, Lcap, K = lay.S, lay.Lcap, lay.K
        hs = lay.header_shifts
        OFF = self._offsets()
        cap = b_idx.shape[0]
        dev = b_idx.device
        r = torch.arange(cap, device=dev)
        c = self._consts(dev)
        sig, psal = c["sigmas"], c["psalts"]      # [P, S], [P, T, n_pos]
        P = sig.shape[0]
        b_idx = b_idx.long()

        if name in ("UpdateTerm", "CocDiscard", "Receive",
                    "Duplicate", "Drop"):
            w0 = parT["bag"][params[0].long(), 0, r]
            i = get_field_t(w0, hs["mdst"]).clamp(0, S - 1).long()
            j = get_field_t(w0, hs["msrc"]).clamp(0, S - 1).long()
        else:
            i = params[0].long()
            j = params[1].long() if len(params) > 1 else None

        touches = []                   # (kind, pos [cap], newval [cap])

        def t_plain(key, a, pos):
            touches.append(("plain", pos, candT[key][a, r]))

        def t_mask(key, a, pos):
            touches.append(("mask", pos, candT[key][a, r]))

        def t_rows(a):                                  # ni/mi row a
            for jj in range(S):
                touches.append(("plain", OFF["ni"] + a * S + jj,
                                candT["ni"][a, jj, r]))
                touches.append(("plain", OFF["mi"] + a * S + jj,
                                candT["mi"][a, jj, r]))

        if name == "Restart":
            t_plain("st", i, OFF["st"] + i)
            t_mask("vr", i, OFF["vr"] + i)
            t_mask("vg", i, OFF["vg"] + i)
            t_plain("ci", i, OFF["ci"] + i)
            t_rows(i)
        elif name == "Timeout":
            t_plain("ct", i, OFF["ct"] + i)
            t_plain("st", i, OFF["st"] + i)
            touches.append(("vf", OFF["vf"] + i, candT["vf"][i, r]))
            t_mask("vr", i, OFF["vr"] + i)
            t_mask("vg", i, OFF["vg"] + i)
        elif name == "BecomeLeader":
            t_plain("st", i, OFF["st"] + i)
            t_rows(i)
        elif name == "ClientRequest":
            t_plain("llen", i, OFF["llen"] + i)
            lpos = parT["llen"][i, r].clamp(0, Lcap - 1).long()
            touches.append(("logent", OFF["log"] + i * Lcap + lpos,
                            candT["log"][i, lpos, r]))
        elif name == "AdvanceCommitIndex":
            t_plain("ci", i, OFF["ci"] + i)
        elif name == "AddNewServer":
            t_plain("ct", j, OFF["ct"] + j)
            touches.append(("vf", OFF["vf"] + j, candT["vf"][j, r]))
        elif name == "UpdateTerm":
            t_plain("ct", i, OFF["ct"] + i)
            t_plain("st", i, OFF["st"] + i)
            touches.append(("vf", OFF["vf"] + i, candT["vf"][i, r]))
        elif name == "Receive":
            t_plain("ct", i, OFF["ct"] + i)
            t_plain("st", i, OFF["st"] + i)
            touches.append(("vf", OFF["vf"] + i, candT["vf"][i, r]))
            t_plain("ci", i, OFF["ci"] + i)
            t_plain("llen", i, OFF["llen"] + i)
            t_mask("vr", i, OFF["vr"] + i)
            t_mask("vg", i, OFF["vg"] + i)
            touches.append(("plain", OFF["ni"] + i * S + j,
                            candT["ni"][i, j, r]))
            touches.append(("plain", OFF["mi"] + i * S + j,
                            candT["mi"][i, j, r]))
            for ll in range(Lcap):
                touches.append(("logent", OFF["log"] + i * Lcap + ll,
                                candT["log"][i, ll, r]))
        # RequestVote / AppendEntries / DeleteServer / CocDiscard /
        # Duplicate / Drop: bag-only

        vmask = (1 << lay.value_bits) - 1
        delta = torch.zeros((P, self.n_streams, cap), dtype=I32,
                            device=dev)
        for kind, pos, val in touches:
            old = tables["posterm"][:, :, pos, b_idx]     # [P, T, cap]
            saltv = psal[:, :, pos]                       # [P, T, cap]
            if kind == "plain":
                newv = val[None].expand(P, cap)
            elif kind == "vf":
                newv = torch.where(val[None] >= 0,
                                   sig[:, val.clamp(0, S - 1).long()], NIL)
            elif kind == "mask":
                newv = self._perm_mask_P(val, sig)
            else:                                         # logent
                is_cfg = (self.kern.entry_type(val) == CONFIG_ENTRY) \
                    & (val != 0)
                newv = torch.where(is_cfg[None],
                                   (val & ~vmask)[None] |
                                   self._perm_mask_P(val & vmask, sig),
                                   val[None])
            delta = delta + (fmix32(newv[:, None] ^ saltv) - old)

        if name in self._BAG_FAMILIES:
            bagp, bagc = parT["bag"], candT["bag"]        # [K, MW, cap]
            diff = (bagp != bagc).any(1) | \
                (parT["cnt"] != candT["cnt"])             # [K, cap]
            # argmax = the first changed slot (slot 0 when none changed)
            k0 = diff.to(I32).argmax(0)
            d0 = diff[k0, r]
            diff2 = diff & (torch.arange(K, device=dev)[:, None] != k0[None])
            k1 = diff2.to(I32).argmax(0)
            d1 = diff2[k1, r]
            bag_t = bagc.movedim(1, 0)                    # [MW, K, cap]
            for km, dm in ((k0, d0), (k1, d1)):
                old = tables["bagterm"][:, :, km, b_idx]
                new = self._slot_terms(bag_t[:, km, r],
                                       candT["cnt"][km, r], sig)
                delta = delta + torch.where(dm[None, None], new - old, 0)

        return tables["h"][:, :, b_idx] + delta

    def finish_min(self, h_all: torch.Tensor) -> torch.Tensor:
        """[P, T, N] per-permutation hashes -> the sealed canonical
        fingerprint [T, N] (the direct path's lexicographic min and
        sentinel remap)."""
        return self._seal(lex_min_perms(h_all))


# ---------------------------------------------------------------------------
# The raft server signature (SpecIR ``server_signature`` hook): sig
# [S, N], permutation-equivariant — sig(relabel(s, σ))[σ(i)] == sig(s)[i]
# for every σ in the symmetry group — so sorting by signature commutes
# with relabeling.  Every component is a per-server invariant: own
# scalar row state, the self/NIL classes of votedFor, popcount and own
# bit of the vote masks and ConfigEntry payloads, row/column value
# multisets of nextIndex/matchIndex, and the multiset of label-blanked
# message contents that reference the server as src / dst / CoC
# subject.  Two rounds of 1-WL color refinement then fold neighbor
# colors over the label relations.  The signature's strength only
# decides how many lanes are hard; the partition never depends on it.
# u32 arithmetic on int32 carriers: sums take dtype=int32 and wrap.
# ---------------------------------------------------------------------------


def _popc(m, nbits: int):
    """Population count over the low ``nbits`` bits (static loop)."""
    pc = torch.zeros_like(m)
    for i in range(nbits):
        pc = pc + ((m >> i) & 1)
    return pc


def _u(x: torch.Tensor) -> torch.Tensor:
    return x.to(I32)


def _refine_colors(fpr, svT: Dict, c, rnd: int):
    """One 1-WL round: fold each server's neighbors' colors over the
    label-carrying relations, keyed by relation and direction."""
    S = fpr.lay.S
    ar0 = torch.arange(S, dtype=I32, device=c.device)
    agg = fmix32(c * i32(0x9E3779B1) + i32(0x7FEB352D + 0x45D9F3B * rnd))
    vf = svT["vf"]
    tgt = c.gather(0, vf.clamp(0, S - 1).long())
    agg = agg + torch.where(vf >= 0, fmix32(tgt ^ i32(0x2C1B3C6D)),
                            i32(0x297A2D39))
    inm = vf[None, :, :] == ar0[:, None, None]          # [S_i, S_j, N]
    agg = agg + (_u(inm) * fmix32(c ^ i32(0xD35A2D97))[None]).sum(
        1, dtype=I32)
    for key, so, si in (("vr", 0x9F3B5389, 0x6F68F2CD),
                        ("vg", 0xB92E5B2B, 0x186A3C6B)):
        bits = (svT[key][:, None, :] >> ar0[None, :, None]) & 1  # bit j of m[i]
        agg = agg + (bits * fmix32(c ^ i32(so))[None]).sum(1, dtype=I32)
        agg = agg + (bits.transpose(0, 1) *
                     fmix32(c ^ i32(si))[None]).sum(1, dtype=I32)
    for key, s1, s2 in (("ni", 0x8DA6B343, 0xD8163841),
                        ("mi", 0xCB1AB31F, 0x41C64E6D)):
        M = svT[key]                                    # [S, S, N]
        agg = agg + fmix32(c[None] ^ fmix32(M ^ i32(s1))).sum(
            1, dtype=I32)
        agg = agg + fmix32(c[None] ^ fmix32(M.transpose(0, 1) ^ i32(s2))
                           ).sum(1, dtype=I32)
    return fmix32(agg)


def raft_server_signature(fpr, svT: Dict, prep: Dict) -> torch.Tensor:
    """The raft ``server_signature`` hook: batch-last views and the
    fingerprinter's _prep dict -> int32-carried u32 sig [S, N]."""
    lay = fpr.lay
    S = lay.S
    dev = svT["ct"].device
    consts = fpr._consts(dev)
    ar1 = torch.arange(S, dtype=I32, device=dev)[:, None]   # [S, 1]
    c = fmix32(svT["ct"] ^ i32(0x6B79D8A5))
    c = fmix32(c + svT["st"] * i32(0x9E3779B1))
    c = fmix32(c + svT["ci"] * i32(0x85EBCA77))
    c = fmix32(c + svT["llen"] * i32(0xC2B2AE3D))
    vf = svT["vf"]
    c = fmix32(c + _u(vf == ar1) * i32(0x27D4EB2F)
               + _u(vf < 0) * i32(0x165667B1))
    for key, k1, k2 in (("vr", 0x94D049BB, 0xBF58476D),
                        ("vg", 0x2545F491, 0xD6E8FEB8)):
        m = svT[key]
        c = fmix32(c + _popc(m, S) * i32(k1) + ((m >> ar1) & 1) * i32(k2))
    # log: order-preserving entry fold; ConfigEntry payloads (server-
    # set bitmasks) reduce to their invariants (popcount + own bit)
    ar2 = ar1[:, None]                                   # [S, 1, 1]
    entc = torch.where(
        prep["log_cfg"],
        prep["log_base"] + _popc(prep["log_pay"], S) * i32(0xFF51AFD7)
        + ((prep["log_pay"] >> ar2) & 1) * i32(0xC4CEB9FE),
        prep["log"])
    lsalt = consts["log_sig_salts"][None, :, None]
    c = fmix32(c + fmix32(entc ^ lsalt).sum(1, dtype=I32))
    # ni/mi: row/column value multisets + the diagonal
    ar0 = torch.arange(S, device=dev)
    for key, s1, s2, s3 in (("ni", 0x0AF63B71, 0x9C06FAF1, 0x4B7F1897),
                            ("mi", 0x71D67FFF, 0xFD7046C5, 0xABA98398)):
        M = svT[key]                                     # [S, S, N]
        c = fmix32(c + fmix32(M ^ i32(s1)).sum(1, dtype=I32))
        c = fmix32(c + fmix32(M ^ i32(s2)).sum(0, dtype=I32))
        c = fmix32(c ^ fmix32(M[ar0, ar0] * i32(s3)))
    # message bag: each live slot's label-blanked content hash, counted
    # into the multisets of the servers it references (src / dst / CoC
    # subject); entry-payload membership is not folded, so states that
    # differ only there tie and take the fallback
    slot = fmix32(prep["w0_base"] ^ i32(0xE6546B64))
    for k in range(lay.Lmax):
        ek = torch.where(
            prep["ent_cfg"][:, k],
            prep["ent_base"][:, k]
            + _popc(prep["ent_pay"][:, k], S) * i32(0x5BD1E995),
            prep["ent"][:, k])
        slot = fmix32(slot + ek * i32(0x38B34AE5 + 2 * k))
    term = prep["cnt"] * _u(~prep["empty"])               # [K, N]
    ark = torch.arange(S, dtype=I32, device=dev)[:, None, None]
    for fld, ks in ((prep["src"], 0x632BE5AB),
                    (prep["dst"], 0x85157AF5)):
        w = term * fmix32(slot ^ i32(ks))
        msk = fld[None] == ark                           # [S, K, N]
        c = fmix32(c + (_u(msk) * w[None]).sum(1, dtype=I32))
    wb = term * _u(prep["is_coc"]) * fmix32(slot ^ i32(0x3C6EF372))
    mskb = (prep["braw"] - 1)[None] == ark
    c = fmix32(c + (_u(mskb) * wb[None]).sum(1, dtype=I32))
    # per-block salt: σ fixes the InitServer blocks, so equal-looking
    # servers in different blocks must never tie
    c = c ^ consts["blk_salt"][:, None]
    for rnd in range(2):
        c = _refine_colors(fpr, svT, c, rnd)
    return c


# ---------------------------------------------------------------------------
# The random-walk engine's novelty Bloom filter (sim/walker.py): k bit
# positions per state taken from the canonical fingerprint's independent
# u32 streams (remixed with a round salt when k exceeds the stream
# count), so the walkers and the exhaustive engines agree on state
# identity.
# ---------------------------------------------------------------------------

def bloom_positions(fp: torch.Tensor, m_bits: int,
                    k: int = 2) -> torch.Tensor:
    """Canonical fingerprints int32-carried u32 [n_streams, B] -> [k, B]
    int64 bit positions into a 2^m_bits Bloom array."""
    T = fp.shape[0]
    out = []
    for j in range(k):
        h = fp[j % T]
        if j >= T:
            h = fmix32(h ^ i32(0x9E3779B9 * (j // T)))
        out.append(h.long() & ((1 << m_bits) - 1))
    return torch.stack(out)


def bloom_estimate(bits_set: int, m_bits: int, k: int = 2) -> float:
    """The Bloom cardinality estimate n = -(m/k)·ln(1 - X/m), in float64
    on the host; a saturated filter (X == m) clamps to X = m - 1, which
    is a ceiling and not an estimate (the result's saturation flag says
    so)."""
    m = float(1 << m_bits)
    x = float(min(bits_set, (1 << m_bits) - 1))
    return -(m / k) * float(np.log1p(-x / m))


# ---------------------------------------------------------------------------
# Claim-insert dedup into the open-addressing visited table.
#
# The table is int32 [W, VCAP] (u32 words as int32 bits; the all-ones
# key marks an empty slot), VCAP a power of two.  Lanes resolve in
# ascending index order, one after another: a live lane walks the
# quadratic probe sequence pos_k = home + k(k+1)/2 (mod VCAP) from its
# home slot until the slot holds its key (a duplicate) or is empty (it
# writes its key there: fresh), for at most max_rounds probe steps; a
# live lane still unresolved then reports hovf and keeps the position
# after its last step.  A dead lane keeps pos = home and fresh = 0.
# These are the semantics of the reference's Pallas kernel
# (raft_tla_tpu/engine/fingerprint.py:probe_claim_insert_pallas).
# ---------------------------------------------------------------------------

MAX_PROBE_ROUNDS = 4096


class LaunchCounter:
    """Counts the kernel launches a wrapper makes (never the plain
    twin's calls): ``chip_smoke.py`` zeroes it before a run and reads
    it after, to show the run went through the kernel.  A launch made
    while a CUDA graph is being captured runs nothing: it adds to
    ``captured`` instead, and ``graph.GraphRunner`` adds each graph's
    share to ``count`` at every replay.  With ``timing`` on, each
    launch outside a capture is bracketed by CUDA events and its
    device scalars (claim rounds, error word) are kept, with no
    synchronisation; ``total_ms`` and ``rounds`` read them afterwards."""

    def __init__(self):
        self.captured = 0
        self.reset()

    def reset(self, timing: bool = False):
        self.count = 0
        self.timing = timing
        self.events = []
        self.stats = []

    def total_ms(self) -> float:
        if self.events:
            torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)

    def rounds(self):
        """[(rounds, error)] of each timed launch, in launch order."""
        return [(int(r), int(e)) for r, e in self.stats]


PROBE_CLAIM_LAUNCHES = LaunchCounter()


def probe_claim_insert_plain(table: torch.Tensor, keys: torch.Tensor,
                             live: torch.Tensor,
                             max_rounds: int = MAX_PROBE_ROUNDS):
    """Plain sequential twin of the kernel: a Python loop over lanes.
    ``table`` int32 [W, VCAP] is updated in place; keys int32 [W, M],
    live bool [M].  Returns (fresh bool [M], pos int32 [M], hovf bool
    0-d), on the table's device."""
    W, vcap = table.shape
    M = keys.shape[1]
    tab = table.detach().cpu()
    tnp = tab.numpy()
    ks = keys.detach().cpu().numpy().view(np.uint32).astype(np.int64)
    lv = live.detach().cpu().numpy().astype(bool)
    fresh = np.zeros(M, bool)
    pos = np.zeros(M, np.int32)
    hovf = False
    mask = vcap - 1
    for m in range(M):
        key = [int(ks[w, m]) for w in range(W)]
        h = HOME_SALT
        for w in range(W):
            h = fmix32_int(h ^ key[w])
        p = h & mask
        if not lv[m]:
            pos[m] = p
            continue
        kb = [i32(k) for k in key]
        t = 0
        for _ in range(max_rounds):
            cur = [int(tnp[w, p]) for w in range(W)]
            if cur == kb:
                break
            if all(c == -1 for c in cur):
                for w in range(W):
                    tnp[w, p] = kb[w]
                fresh[m] = True
                break
            t += 1
            p = (p + t) & mask
        else:
            hovf = True
        pos[m] = p
    if tab.data_ptr() != table.data_ptr():
        table.copy_(tab)
    dev = table.device
    return (torch.from_numpy(fresh).to(dev), torch.from_numpy(pos).to(dev),
            torch.tensor(hovf, device=dev))


DUP, CLAIM, UNRESOLVED = 0, 1, 2     # a lane's result kind in one round


def _claim_walk(table, keys, lanes, home, allones, k, owner,
                max_rounds):
    """One claim round's probe walk of ``lanes`` from probe step ``k``
    (per lane) against the committed ``table`` and the previous round's
    claim owners (``owner`` [VCAP], M where no lane claimed; None in
    round 1).  Returns per lane the result kind, its slot, the step it
    stopped at and whether that slot is empty in the committed table."""
    vcap, M = table.shape[1], keys.shape[1]
    n = lanes.numel()
    tri = max_rounds * (max_rounds + 1) // 2
    kind = torch.full((n,), UNRESOLVED, dtype=torch.int8,
                      device=table.device)
    slot = (home[lanes] + tri) & (vcap - 1)
    step = k.clone()
    at_empty = torch.zeros(n, dtype=torch.bool, device=table.device)
    act = torch.arange(n, device=table.device)
    kk = k.clone()
    while True:
        act = act[kk[act] < max_rounds]
        if act.numel() == 0:
            break
        ln, ka = lanes[act], kk[act]
        p = (home[ln] + ka * (ka + 1) // 2) & (vcap - 1)
        cur, key = table[:, p], keys[:, ln]
        empty = (cur == -1).all(0)
        if owner is None:
            owned = torch.zeros_like(empty)
            same = owned
        else:
            o = owner[p]
            # the order matters for the all-ones key, which equals an
            # empty slot: a lower lane's claim is checked first
            owned = empty & (o < ln)
            same = owned & (keys[:, o.clamp(max=M - 1)] == key).all(0)
        free = empty & ~owned
        dup = same | (free & allones[ln]) | (~empty & (cur == key).all(0))
        claim = free & ~allones[ln]
        stop = dup | claim
        s = act[stop]
        kind[s] = torch.where(claim[stop], CLAIM, DUP).to(torch.int8)
        slot[s] = p[stop]
        step[s] = ka[stop]
        at_empty[s] = empty[stop]
        act = act[~stop]
        kk[act] += 1
    return kind, slot, step, at_empty


def probe_claim_insert_rounds(table: torch.Tensor, keys: torch.Tensor,
                              live: torch.Tensor,
                              max_rounds: int = MAX_PROBE_ROUNDS):
    """Model of the kernel's claim rounds (csrc/probe_claim.cu) in plain
    torch, vectorised over lanes.  Per round every live lane that is not
    final walks its probe path against the committed table (unchanged
    during the rounds) and the previous round's owners — the lowest
    lane that targeted each slot as a claim:

      committed slot empty, owned by a lower lane j: a duplicate there
        if key_j = key_i, else blocked (go on);
      committed slot empty, no lower owner: a claim target (the
        all-ones key, which equals EMPTY, is a duplicate there);
      committed slot holds key_i: a duplicate;
      otherwise go on; after ``max_rounds`` steps the lane is
        unresolved.

    A lane whose round-1 walk met no empty slot is final; the others
    restart each round at their first empty slot.  Lane i is right from
    round i+1 on, so the rounds stop within M+1, at the first round in
    which no lane's result changed; that is the sequential outcome.
    Then each claiming lane writes its key.  Returns the twin's
    (fresh, pos, hovf) plus ``rounds``, the rounds run.  Only the tests
    call it."""
    vcap, M = table.shape[1], keys.shape[1]
    dev = table.device
    home = home_slots(keys, vcap).long()
    allones = (keys == -1).all(0)
    kind = torch.full((M,), DUP, dtype=torch.int8, device=dev)
    slot = home.clone()
    k0 = torch.zeros(M, dtype=torch.long, device=dev)
    pend = live.clone()
    owner = None
    for rounds in range(1, M + 2):
        idx = pend.nonzero().squeeze(1)
        nk, ns, nstep, at_empty = _claim_walk(table, keys, idx, home,
                                              allones, k0[idx], owner,
                                              max_rounds)
        changed = idx.numel() > 0 if rounds == 1 else bool(
            ((nk != kind[idx]) | (ns != slot[idx])).any())
        kind[idx], slot[idx] = nk, ns
        if rounds == 1:
            k0[idx] = nstep
            pend[idx] = at_empty
        claim = idx[nk == CLAIM]
        owner = torch.full((vcap,), M, dtype=torch.long, device=dev)
        owner.scatter_reduce_(0, slot[claim], claim, "amin")
        if not changed:
            break
    else:
        raise RuntimeError(f"claim rounds: no fixpoint after {M + 1}")
    fresh = live & (kind == CLAIM)
    table[:, slot[fresh]] = keys[:, fresh]
    return (fresh, slot.to(torch.int32), (live & (kind == UNRESOLVED)).any(),
            rounds)


def probe_claim_insert(table: torch.Tensor, keys: torch.Tensor,
                       live: torch.Tensor,
                       max_rounds: int = MAX_PROBE_ROUNDS):
    """Claim-insert ``keys`` into ``table`` (in place).  On a CUDA
    table this launches the hand-written kernel (csrc/probe_claim.cu)
    and counts the launch (inside a graph capture: tallies it for the
    replays); on a CPU table it runs the plain twin.
    Returns (fresh bool [M], pos int32 [M], hovf bool 0-d)."""
    if table.device.type == "cpu":
        return probe_claim_insert_plain(table, keys, live, max_rounds)
    from .cuda_ext import probe_claim_launch
    ctr = PROBE_CLAIM_LAUNCHES
    if torch.cuda.is_current_stream_capturing():
        out = probe_claim_launch(table, keys, live, max_rounds)
        ctr.captured += 1
        return out[:3]
    if ctr.timing:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    fresh, pos, hovf, rounds, err = probe_claim_launch(table, keys, live,
                                                       max_rounds)
    if ctr.timing:
        ev[1].record()
        ctr.events.append(ev)
        ctr.stats.append((rounds, err))
    ctr.count += 1
    return fresh, pos, hovf
