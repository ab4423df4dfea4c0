"""Symmetry-canonical state fingerprints and the visited-table dedup.

Fingerprints follow the reference's ``engine/fingerprint.py`` bit for
bit: the hash covers the 10 VIEW variables (raft.cfg:30), positional
fields hash with per-position salts and the message bag commutatively
(Σ over slots of count · mix(slot)), and the canonical value is the
lexicographic minimum over the symmetry group G (permutations fixing
InitServer setwise) of the relabeled hash:

  fp(s) = min_{σ ∈ G} H(relabel(s, σ))

Relabeling the state is done by permuting the salts (``psalts``), so
only the label-carrying values (votedFor, vote masks, ConfigEntry
payloads, message src/dst/mserver) are rewritten per σ.  Salts come
from the same ``numpy.random.RandomState`` seeds as the reference, so
the values match it exactly.  This slice ports the direct min-over-
perms mode; the reference's incremental and orbit-sort modes (equal
by its own tests) come later.

The second half of the module is the claim-insert dedup into the
open-addressing visited table: ``probe_claim_insert`` launches the
CUDA kernel (``csrc/probe_claim.cu``) on a CUDA table and runs its
plain twin, ``probe_claim_insert_plain``, on a CPU table.
``probe_claim_insert_rounds`` models the kernel's parallel claim rounds
in plain torch, for the tests.
"""

from __future__ import annotations

from typing import Dict

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


class RaftFingerprinter:
    def __init__(self, cfg: ModelConfig, sym_canon: str = "minperm"):
        if sym_canon != "minperm":
            raise NotImplementedError(
                f"sym_canon {sym_canon!r}: only the min-over-perms "
                "canonicalizer is ported (at most 6 symmetry "
                "permutations, i.e. up to 3 interchangeable servers)")
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
        self._dev_cache = {}

    def _consts(self, device):
        """Per-device tensors of the static tables (built once)."""
        c = self._dev_cache.get(device)
        if c is None:
            c = dict(
                psalts=torch.from_numpy(_as_i32(self.psalts)).to(device),
                bag_salts=[torch.from_numpy(_as_i32(b)).to(device)
                           for b in self.bag_salts],
                sigmas=[torch.from_numpy(s.copy()).to(device)
                        for s in self.sigmas])
            self._dev_cache[device] = c
        return c

    # ------------------------------------------------------------------

    def _perm_mask(self, m, sigma):
        """Relabel a server bitmask under the static permutation σ."""
        out = torch.zeros_like(m)
        for i in range(self.lay.S):
            out = out | (((m >> i) & 1) << int(sigma[i]))
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
                    vf=svT["vf"], cnt=svT["cnt"], const_flat=const_flat)

    def _hash_under(self, prep: Dict, svT: Dict, p: int) -> torch.Tensor:
        """One salted hash of the states under σ_p -> int32 [T, N]."""
        lay = self.lay
        S = lay.S
        hs = lay.header_shifts
        N = prep["w0"].shape[-1]
        c = self._consts(prep["w0"].device)
        sigma = self.sigmas[p]
        sig_t = c["sigmas"][p]

        def sub(idx):
            return sig_t[idx.clamp(0, S - 1).long()]

        # ---- label-carrying content, relabeled under σ ----
        vf = prep["vf"]
        vfp = torch.where(vf >= 0, sub(vf), NIL)
        vrp = self._perm_mask(svT["vr"], sigma)
        vgp = self._perm_mask(svT["vg"], sigma)
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

        # ---- per-stream reduction ----
        out = []
        for t in range(self.n_streams):
            h = fmix32(flat ^ c["psalts"][p, t][:, None]).sum(0, dtype=I32)
            bs = c["bag_salts"][t]
            slot = torch.zeros_like(prep["w0"])
            for w in range(lay.msg_words):
                slot = slot + fmix32(words[w] ^ bs[w])
            h = h + (prep["cnt"] * fmix32(slot ^ bs[-1])).sum(0, dtype=I32)
            out.append(h)
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

    def fingerprint_batch_T(self, svT: Dict) -> torch.Tensor:
        """Batch-last [..., N] rows -> int32-carried u32 [T, N]."""
        prep = self._prep(svT)
        best = self._hash_under(prep, svT, 0)
        for p in range(1, len(self.sigmas)):
            best = self._lex_min(best, self._hash_under(prep, svT, p))
        return self._seal(best)


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
    it after, to show the run went through the kernel.  With
    ``timing`` on, each launch is bracketed by CUDA events and its
    device scalars (claim rounds, error word) are kept, with no
    synchronisation; ``total_ms`` and ``rounds`` read them afterwards."""

    def __init__(self):
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
    and counts the launch; on a CPU table it runs the plain twin.
    Returns (fresh bool [M], pos int32 [M], hovf bool 0-d)."""
    if table.device.type == "cpu":
        return probe_claim_insert_plain(table, keys, live, max_rounds)
    from .cuda_ext import probe_claim_launch
    ctr = PROBE_CLAIM_LAUNCHES
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
