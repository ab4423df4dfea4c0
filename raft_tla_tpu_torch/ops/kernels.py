"""Action kernels: the Next-relation over batch-last torch tensors.

The reference package writes each kernel for a single state and vmaps
it; here every kernel takes a batch of compacted rows with the batch
axis LAST (``ct`` [S, N], ``log`` [S, Lcap, N], ``bag`` [K, MW, N], …)
and one int32 [N] tensor per action parameter, so the parameters vary
per row.  Data-dependent indexing goes through three helpers:

- ``take(x, i)``: x[i[..., n], ..., n] along the leading axis, for an
  index of any leading shape ([N] per row, [K, N] per bag slot);
- ``at(x, p)``: x[..., p[..., n], n] along the position axis (-2);
- ``put(x, i, v)``: x with x[i[n], ..., n] = v[..., n].

Indices clamp into range as JAX's gathers do; the kernels clip every
index whose row is enabled, so the clamp only touches rows the engine
discards.  u32 message words ride as int32 bit patterns (utils).

Semantics contract: the reference's ``ops/kernels.py`` (and through it
models/raft.py, which cites raft.tla line by line).  The enabling
guards live in ``guard_features`` plus each family's declared guard
algebra (spec/raft_ir); the successor kernels below compute the
successor only, and the engine runs them on enabled rows only.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import (CANDIDATE, CONFIG_ENTRY, FOLLOWER, LEADER, MT_AEREQ,
                      MT_AERESP, MT_CATREQ, MT_CATRESP, MT_COC, MT_RVREQ,
                      MT_RVRESP, NIL, VALUE_ENTRY)
from .codec import (C_GLOBLEN, C_NLEADERS, C_NMC, C_NREQ, C_NTRIED,
                    C_OVERFLOW, F_ADD_COMMITS, F_ADDED_SET, F_BL2_SEEN,
                    F_COMMIT_SEEN, F_CWCL_POS, F_LAST_RESTART_POS, F_LCDCC,
                    F_MC_COMMITS, F_MIN_RESTART_GAP, F_NJBL, F_OPEN_ADD,
                    NO_GAP)
from .layout import Layout, get_field_t, put_field_t

State = Dict[str, torch.Tensor]
I32 = torch.int32


def ar(n: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=ref.device)


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x [n, *rest, N], i [*lead, N] -> [*lead, *rest, N]."""
    n = x.shape[0]
    xt = x.movedim(-1, 0)                              # [N, n, *rest]
    i = i.clamp(0, n - 1).long()
    cols = torch.arange(x.shape[-1], device=x.device).expand_as(i)
    return xt[cols, i].movedim(i.dim() - 1, -1)


def at(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x [*lead, L, N], p [*lead, N] -> [*lead, N]."""
    p = p.clamp(0, x.shape[-2] - 1).long()
    return x.gather(-2, p.unsqueeze(-2)).squeeze(-2)


def put(x: torch.Tensor, i: torch.Tensor, v) -> torch.Tensor:
    """x [n, *rest, N] with row i[n] of column n set to v[..., n]."""
    n = x.shape[0]
    m = (ar(n, x)[:, None] == i[None, :]).view(
        (n,) + (1,) * (x.dim() - 2) + (-1,))
    if isinstance(v, torch.Tensor):
        v = v.unsqueeze(0)
    return torch.where(m, v, x)


def setc(x: torch.Tensor, c: int, v) -> torch.Tensor:
    """x with static row c replaced by v."""
    x = x.clone()
    x[c] = v
    return x


def addc(x: torch.Tensor, c: int, v) -> torch.Tensor:
    """x with static row c incremented by v."""
    return setc(x, c, x[c] + v)


def popcount(x, nbits: int):
    """Popcount over the low ``nbits`` of small server bitmasks."""
    total = torch.zeros_like(x)
    for k in range(nbits):
        total = total + ((x >> k) & 1)
    return total


def all_(x: torch.Tensor) -> torch.Tensor:
    """Reduce every axis but the batch axis (last) with AND."""
    return x.reshape(-1, x.shape[-1]).all(0)


def any_(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).any(0)


def select_enabled(ok: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The ``u``-th enabled lane (0-based) of each walker's guard mask,
    or -1 when no lane is enabled: ok bool [W, A], u int32 [W] ->
    int32 [W].  The random-walk engine's sampling step (sim/walker.py):
    with u uniform in [0, sum(ok)) it is the uniform choice over the
    enabled lanes.  The reference's argmax of ``cumsum > u`` takes the
    first such index, which is the count of running sums <= u (they
    never decrease), and 0 when there is none."""
    csum = torch.cumsum(ok.to(I32), 1)
    idx = (csum <= u[:, None]).sum(1, dtype=I32)
    idx = torch.where(idx == ok.shape[1], 0, idx)
    return torch.where(csum[:, -1] > 0, idx, -1)


class RaftKernels:
    """Kernel family bound to one (Layout, ModelConfig)."""

    def __init__(self, lay: Layout):
        self.lay = lay
        self.cfg = lay.cfg
        self.S = lay.S
        self.Lmax = lay.Lmax
        self.Lcap = lay.Lcap
        self.K = lay.K

    @property
    def term_cap(self) -> int:
        """The term representability clamp: the packing holds
        max_terms + 1 (the one unconstrained step past BoundedTerms)."""
        return self.cfg.bounds.max_terms + 1

    # ------------------------------------------------------------------
    # Derived per-state quantities
    # ------------------------------------------------------------------

    def derived(self, sv: State) -> State:
        lay = self.lay
        log = sv["log"]                                   # [S, Lcap, N]
        etype = (log >> lay.value_bits) & 1
        is_cfg = (etype == CONFIG_ENTRY) & (log != 0)
        pos = (ar(self.Lcap, log) + 1)[None, :, None]
        # GetMaxConfigIndex (raft.tla:346-351), 1-based, 0 if none
        maxcfg = torch.where(is_cfg, pos, 0).amax(1)      # [S, N]
        payload = log & ((1 << lay.value_bits) - 1)
        cfg_payload = at(payload, maxcfg - 1)
        # GetConfig (raft.tla:354-360): latest ConfigEntry else InitServer
        config = torch.where(maxcfg > 0, cfg_payload, self.cfg.init_mask)
        lastterm = torch.where(sv["llen"] > 0,
                               self.entry_term(at(log, sv["llen"] - 1)), 0)
        bits = (1 << ar(self.S, log))[:, None]
        leaders = torch.where(sv["st"] == LEADER, bits, 0).sum(
            0, dtype=I32)
        return {"config": config, "maxcfg": maxcfg, "lastterm": lastterm,
                "leaders": leaders}

    def guard_feature_offsets(self) -> Dict[str, int]:
        return guard_feature_offsets(self.lay)

    # ------------------------------------------------------------------
    # Entry / message packing helpers
    # ------------------------------------------------------------------

    def entry_term(self, e):
        return e >> (1 + self.lay.value_bits)

    def entry_type(self, e):
        return (e >> self.lay.value_bits) & 1

    def entry_payload(self, e):
        return e & ((1 << self.lay.value_bits) - 1)

    def pack_entry(self, term, etype, payload):
        vb = self.lay.value_bits
        return (term << (1 + vb)) | (etype << vb) | payload

    def pack_msg(self, ref, mtype, mterm, msrc, mdst, a=-1, b=-1, c=-1,
                 ent=None, entlen=0):
        """-> int32 [msg_words, N].  ``ref`` is any [N] int32 tensor
        (the batch shape); a/b/c use the +1 absent-field offset
        (codec.pack_msg is the host twin); ent is [Lmax, N]."""
        lay = self.lay
        hs = lay.header_shifts

        def t(v):
            return v if isinstance(v, torch.Tensor) else \
                torch.full_like(ref, v)

        w0 = (put_field_t(t(mtype), hs["mtype"]) |
              put_field_t(t(mterm), hs["mterm"]) |
              put_field_t(t(msrc), hs["msrc"]) |
              put_field_t(t(mdst), hs["mdst"]) |
              put_field_t(t(a) + 1, hs["a"]) |
              put_field_t(t(b) + 1, hs["b"]) |
              put_field_t(t(c) + 1, hs["c"]) |
              put_field_t(t(entlen), hs["entlen"]))
        words = [w0]
        epw = lay.entries_per_word
        entlen = t(entlen)
        for w in range(1, lay.msg_words):
            acc = torch.zeros_like(ref)
            for k in range((w - 1) * epw, min(w * epw, self.Lmax)):
                if ent is None:
                    continue
                live = (k < entlen).to(I32)
                acc = acc | ((live * ent[k]) << (lay.entry_bits * (k % epw)))
            words.append(acc)
        return torch.stack(words)

    def msg_fields(self, words):
        """int32 [msg_words, *lead, N] -> dict of [*lead, N] header
        fields + ent [Lmax, *lead, N]."""
        lay = self.lay
        hs = lay.header_shifts
        w0 = words[0]
        f = {name: get_field_t(w0, hs[name])
             for name in ("mtype", "mterm", "msrc", "mdst", "entlen")}
        for name in ("a", "b", "c"):
            f[name] = get_field_t(w0, hs[name]) - 1
        epw = lay.entries_per_word
        mask = (1 << lay.entry_bits) - 1
        f["ent"] = torch.stack(
            [get_field_t(words[1 + k // epw],
                         (lay.entry_bits * (k % epw), lay.entry_bits))
             & mask for k in range(self.Lmax)])
        return f

    # ------------------------------------------------------------------
    # Bag ops (TypedBags (+)/(-), raft.tla:226-231)
    # ------------------------------------------------------------------

    def bag_put(self, sv: State, words) -> State:
        """WithMessage: +1 count, merging into an existing slot for the
        same message, else the first empty slot; overflow faults."""
        bag, cnt = sv["bag"], sv["cnt"]                   # [K, MW, N]
        same = (bag == words[None]).all(1) & (cnt > 0)    # [K, N]
        exists = same.any(0)
        empty = cnt == 0
        first_empty = empty.to(I32).argmax(0)
        target = torch.where(exists, same.to(I32).argmax(0), first_empty)
        overflow = ~exists & ~empty.any(0)
        sv2 = dict(sv)
        sv2["bag"] = torch.where(overflow, bag, put(bag, target, words))
        sv2["cnt"] = torch.where(overflow, cnt,
                                 put(cnt, target, take(cnt, target) + 1))
        sv2["ctr"] = addc(sv["ctr"], C_OVERFLOW, overflow.to(I32))
        return sv2

    def bag_del_slot(self, sv: State, slot) -> State:
        """WithoutMessage on a known slot: -1 count, zero the slot at 0
        (TypedBags (-) removes zero-count elements)."""
        cnt2 = put(sv["cnt"], slot, take(sv["cnt"], slot) - 1)
        gone = take(cnt2, slot) == 0
        sv2 = dict(sv)
        sv2["cnt"] = cnt2
        sv2["bag"] = torch.where(gone, put(sv["bag"], slot, 0), sv["bag"])
        return sv2

    def _glob(self, sv: State, n) -> State:
        sv2 = dict(sv)
        sv2["ctr"] = addc(sv["ctr"], C_GLOBLEN, n)
        return sv2

    # ------------------------------------------------------------------
    # Top-level actions (oracle: models/raft.py of the reference)
    # ------------------------------------------------------------------

    def restart(self, sv: State, der, i) -> State:
        """Oracle restart(); raft.tla:401-411."""
        sv2 = dict(sv)
        sv2["st"] = put(sv["st"], i, FOLLOWER)
        sv2["vr"] = put(sv["vr"], i, 0)
        sv2["vg"] = put(sv["vg"], i, 0)
        sv2["ni"] = put(sv["ni"], i, 1)
        sv2["mi"] = put(sv["mi"], i, 0)
        sv2["ci"] = put(sv["ci"], i, 0)
        sv2["restarted"] = put(sv["restarted"], i,
                               take(sv["restarted"], i) + 1)
        # Restart record position feeds MajorityOfClusterRestarts
        pos = sv["ctr"][C_GLOBLEN] + 1
        last = sv["feat"][F_LAST_RESTART_POS]
        gap = torch.where(last > 0, pos - last, NO_GAP)
        feat = setc(sv["feat"], F_LAST_RESTART_POS, pos)
        feat[F_MIN_RESTART_GAP] = torch.minimum(feat[F_MIN_RESTART_GAP],
                                                gap)
        sv2["feat"] = feat
        return self._glob(sv2, 1)

    def timeout(self, sv: State, der, i) -> State:
        """Oracle timeout(); raft.tla:415-427."""
        sv2 = dict(sv)
        sv2["st"] = put(sv["st"], i, CANDIDATE)
        # term-width capacity guard: fault AND clamp (reachable only
        # with BoundedTerms disabled and too small a max_terms)
        cap = self.term_cap
        ct_i = take(sv["ct"], i)
        overflow = ct_i + 1 > cap
        sv2["ct"] = put(sv["ct"], i, torch.clamp(ct_i + 1, max=cap))
        sv2["vf"] = put(sv["vf"], i, NIL)
        sv2["vr"] = put(sv["vr"], i, 0)
        sv2["vg"] = put(sv["vg"], i, 0)
        sv2["timeout"] = put(sv["timeout"], i, take(sv["timeout"], i) + 1)
        sv2["ctr"] = addc(sv["ctr"], C_OVERFLOW, overflow.to(I32))
        return self._glob(sv2, 1)

    def request_vote(self, sv: State, der, i, j) -> State:
        """Oracle request_vote(); raft.tla:431-440 (includes j = i)."""
        words = self.pack_msg(i, MT_RVREQ, take(sv["ct"], i), i, j,
                              a=take(der["lastterm"], i),
                              b=take(sv["llen"], i))
        return self._glob(self.bag_put(sv, words), 1)

    def append_entries(self, sv: State, der, i, j) -> State:
        """Oracle append_entries(); raft.tla:446-468 (≤1 entry)."""
        log_i = take(sv["log"], i)                        # [Lcap, N]
        llen_i = take(sv["llen"], i)
        nij = at(take(sv["ni"], i), j)
        prev_idx = nij - 1
        in_range = (prev_idx > 0) & (prev_idx <= llen_i)
        prev_term = torch.where(
            in_range, self.entry_term(at(log_i, prev_idx - 1)), 0)
        last_entry = torch.minimum(llen_i, nij)
        has_entry = nij <= last_entry
        ent = torch.zeros((self.Lmax,) + i.shape, dtype=I32,
                          device=i.device)
        ent[0] = at(log_i, nij - 1)
        words = self.pack_msg(
            i, MT_AEREQ, take(sv["ct"], i), i, j, a=prev_idx, b=prev_term,
            c=torch.minimum(take(sv["ci"], i), last_entry),
            ent=ent, entlen=has_entry.to(I32))
        return self._glob(self.bag_put(sv, words), 1)

    def in_quorum(self, votes, config):
        """set ∈ Quorum(config) (raft.tla:217) as the counting test:
        subset + strict majority."""
        subset = (votes & ~config) == 0
        return subset & (2 * popcount(votes, self.S) >
                         popcount(config, self.S))

    def become_leader(self, sv: State, der, i) -> State:
        """Oracle become_leader(); raft.tla:472-484."""
        sv2 = dict(sv)
        sv2["st"] = put(sv["st"], i, LEADER)
        sv2["ni"] = put(sv["ni"], i, 1 + take(sv["llen"], i))
        sv2["mi"] = put(sv["mi"], i, 0)
        sv2["ctr"] = addc(sv["ctr"], C_NLEADERS, 1)
        # BecomeLeader record features (raft.tla:480-483)
        leaders2 = der["leaders"] | (1 << i)
        feat = sv["feat"].clone()
        bl2 = popcount(leaders2, self.S) >= 2
        feat[F_BL2_SEEN] = torch.maximum(feat[F_BL2_SEEN], bl2.to(I32))
        njbl = ((feat[F_ADDED_SET] >> i) & 1) == 1
        feat[F_NJBL] = torch.maximum(feat[F_NJBL], njbl.to(I32))
        feat[F_LCDCC] = torch.maximum(feat[F_LCDCC], feat[F_OPEN_ADD])
        sv2["feat"] = feat
        return self._glob(sv2, 1)

    def client_request(self, sv: State, der, i, v) -> State:
        """Oracle client_request(); raft.tla:488-497.  No global record."""
        llen_i = take(sv["llen"], i)
        log_i = take(sv["log"], i)
        entry = self.pack_entry(take(sv["ct"], i), VALUE_ENTRY, v)
        overflow = llen_i >= self.Lcap
        sv2 = dict(sv)
        sv2["log"] = put(sv["log"], i, put(
            log_i, llen_i.clamp(0, self.Lcap - 1),
            torch.where(overflow, log_i[self.Lcap - 1], entry)))
        sv2["llen"] = put(sv["llen"], i,
                          llen_i + torch.where(overflow, 0, 1))
        ctr = addc(sv["ctr"], C_NREQ, 1)
        ctr[C_OVERFLOW] += overflow.to(I32)
        sv2["ctr"] = ctr
        return sv2

    def advance_commit_index(self, sv: State, der, i) -> State:
        """Oracle advance_commit_index(); raft.tla:504-539."""
        S, Lcap = self.S, self.Lcap
        config = take(der["config"], i)                   # [N]
        log_i = take(sv["log"], i)                        # [Lcap, N]
        llen_i = take(sv["llen"], i)
        ci_i = take(sv["ci"], i)
        ct_i = take(sv["ct"], i)
        # Agree(index) = {i} ∪ {k ∈ config : matchIndex[i][k] ≥ index}
        idxs = (ar(Lcap, i) + 1)[:, None]                 # [Lcap, 1]
        kk = ar(S, i)[:, None]                            # [S, 1]
        match_ge = take(sv["mi"], i)[None] >= idxs[:, None]   # [Lcap,S,N]
        incfg = ((config[None] >> kk) & 1) == 1           # [S, N]
        agree = (1 << i) | torch.where(
            match_ge & incfg[None], (1 << kk)[None], 0).sum(1, dtype=I32)
        in_q = self.in_quorum(agree, config[None]) & (idxs <= llen_i[None])
        max_agree = torch.where(in_q, idxs, 0).amax(0)    # [N]
        term_ok = self.entry_term(at(log_i, max_agree - 1)) == ct_i
        new_ci = torch.where((max_agree > 0) & term_ok, max_agree, ci_i)
        did_commit = new_ci > ci_i
        sv2 = dict(sv)
        sv2["ci"] = put(sv["ci"], i, new_ci)
        # CommitEntry vs CommitMembershipChange (raft.tla:522-538)
        entry = at(log_i, new_ci - 1)
        is_cfg_entry = self.entry_type(entry) == CONFIG_ENTRY
        pos = idxs
        prefix_cfg_pos = torch.where(
            (self.entry_type(log_i) == CONFIG_ENTRY) & (log_i != 0) &
            (pos < new_ci[None]), pos, 0).amax(0)
        prefix_cfg = torch.where(
            prefix_cfg_pos > 0,
            self.entry_payload(at(log_i, prefix_cfg_pos - 1)),
            self.cfg.init_mask)
        is_mc = did_commit & is_cfg_entry & \
            (self.entry_payload(entry) != prefix_cfg)
        is_ce = did_commit & ~is_mc
        feat = sv["feat"].clone()
        pos_rec = sv["ctr"][C_GLOBLEN] + 1
        feat[F_COMMIT_SEEN] = torch.maximum(feat[F_COMMIT_SEEN],
                                            is_ce.to(I32))
        cwcl_hit = is_ce & (feat[F_BL2_SEEN] == 1) & (feat[F_CWCL_POS] == 0)
        feat[F_CWCL_POS] = torch.where(cwcl_hit, pos_rec, feat[F_CWCL_POS])
        add_hit = is_mc & ((self.entry_payload(entry) &
                            feat[F_ADDED_SET]) != 0)
        feat[F_ADD_COMMITS] = torch.maximum(feat[F_ADD_COMMITS],
                                            add_hit.to(I32))
        feat[F_OPEN_ADD] = torch.where(is_mc, 0, feat[F_OPEN_ADD])
        feat[F_MC_COMMITS] = feat[F_MC_COMMITS] + is_mc.to(I32)
        sv2["feat"] = feat
        return self._glob(sv2, did_commit.to(I32))

    def add_new_server(self, sv: State, der, i, j) -> State:
        """Oracle add_new_server(); raft.tla:542-555 — the leader resets
        j's term/votedFor (modeling shortcut) and sends CatchupRequest."""
        sv2 = dict(sv)
        sv2["ct"] = put(sv["ct"], j, 1)
        sv2["vf"] = put(sv["vf"], j, NIL)
        # mentries = SubSeq(log, nextIndex[i][j], commitIndex[i]) :550
        nij = at(take(sv["ni"], i), j)
        ci_i = take(sv["ci"], i)
        nent_raw = torch.clamp(ci_i - nij + 1, min=0)
        nent = torch.clamp(nent_raw, max=self.Lmax)
        gidx = (nij[None] - 1 + ar(self.Lmax, i)[:, None]).clamp(
            0, self.Lcap - 1)
        ent = take(sv["log"], i).gather(0, gidx.long())   # [Lmax, N]
        words = self.pack_msg(i, MT_CATREQ, take(sv["ct"], i), i, j,
                              a=at(take(sv["mi"], i), j), b=ci_i,
                              c=self.cfg.num_rounds, ent=ent, entlen=nent)
        sv2 = self.bag_put(sv2, words)
        ctr = addc(sv2["ctr"], C_OVERFLOW, (nent_raw > self.Lmax).to(I32))
        ctr[C_NTRIED] += 1                # TryAddServer (raft.tla:249)
        sv2["ctr"] = ctr
        return self._glob(sv2, 2)

    def delete_server(self, sv: State, der, i, j) -> State:
        """Oracle delete_server(); raft.tla:558-569 (self-addressed
        CheckOldConfig; j != i is static)."""
        words = self.pack_msg(i, MT_COC, take(sv["ct"], i), i, i, a=0, b=j)
        sv2 = self.bag_put(sv, words)
        sv2["ctr"] = addc(sv2["ctr"], C_NTRIED, 1)   # TryRemoveServer
        return self._glob(sv2, 2)

    def duplicate_message(self, sv: State, der, k) -> State:
        """Oracle duplicate_message(); raft.tla:892-896.  No history."""
        sv2 = dict(sv)
        sv2["cnt"] = put(sv["cnt"], k, take(sv["cnt"], k) + 1)
        return sv2

    def drop_message(self, sv: State, der, k) -> State:
        """Oracle drop_message(); raft.tla:900-904."""
        sv2 = dict(sv)
        sv2["cnt"] = put(sv["cnt"], k, 0)
        sv2["bag"] = put(sv["bag"], k, 0)
        return sv2

    # ------------------------------------------------------------------
    # Receive lanes (oracle receive(); raft.tla:842-863): UpdateTerm
    # (non-consuming), the main per-type handler, and the
    # CheckOldConfig discard branch.
    # ------------------------------------------------------------------

    def update_term(self, sv: State, der, k) -> State:
        """Oracle update_term(); raft.tla:826-832 — msg NOT consumed."""
        f = self.msg_fields(take(sv["bag"], k))
        i = f["mdst"]
        sv2 = dict(sv)
        sv2["ct"] = put(sv["ct"], i, f["mterm"])
        sv2["st"] = put(sv["st"], i, FOLLOWER)
        sv2["vf"] = put(sv["vf"], i, NIL)
        return sv2

    def coc_discard(self, sv: State, der, k) -> State:
        """HandleCheckOldConfig discard branch (raft.tla:796)."""
        return self._glob(self.bag_del_slot(sv, k), 1)

    def _ae_branches(self, f, ct_i, st_i, llen_i, log_i):
        """The AppendEntriesRequest branch family (raft.tla:617-700),
        shared by the guard and the successor: (reject, rtf, already,
        conflict, noconf)."""
        mterm = f["mterm"]
        prev_idx = f["a"]
        ae_in_range = (prev_idx > 0) & (prev_idx <= llen_i)
        ae_logok = (prev_idx == 0) | (
            ae_in_range &
            (f["b"] == self.entry_term(at(log_i, prev_idx - 1))))
        eq = mterm == ct_i
        reject = (mterm < ct_i) | (eq & (st_i == FOLLOWER) & ~ae_logok)
        rtf = eq & (st_i == CANDIDATE)
        accept = eq & (st_i == FOLLOWER) & ae_logok
        index = prev_idx + 1
        have_at = llen_i >= index
        term_match = self.entry_term(at(log_i, index - 1)) == \
            self.entry_term(f["ent"][0])
        already = accept & ((f["entlen"] == 0) | (have_at & term_match))
        conflict = accept & (f["entlen"] > 0) & have_at & ~term_match
        noconf = accept & (f["entlen"] > 0) & (llen_i == prev_idx)
        return reject, rtf, already, conflict, noconf

    def receive_main(self, sv: State, der, k) -> State:
        """Main handler lane: per-type dispatch via selects.  Oracle twins:
        handle_rv_req / handle_rv_resp / handle_ae_req / handle_ae_resp /
        handle_cat_req / handle_cat_resp / handle_coc (process branch)."""
        Lcap, Lmax = self.Lcap, self.Lmax
        f = self.msg_fields(take(sv["bag"], k))
        i, j, mterm, mtype = f["mdst"], f["msrc"], f["mterm"], f["mtype"]
        ct_i = take(sv["ct"], i)
        st_i = take(sv["st"], i)
        llen_i = take(sv["llen"], i)
        log_i = take(sv["log"], i)                        # [Lcap, N]
        ci_i = take(sv["ci"], i)
        vf_i = take(sv["vf"], i)
        ni_i = take(sv["ni"], i)                          # [S, N]
        mi_i = take(sv["mi"], i)
        cfg_i = take(der["config"], i)

        is_rvreq = mtype == MT_RVREQ
        is_rvresp = mtype == MT_RVRESP
        is_aereq = mtype == MT_AEREQ
        is_aeresp = mtype == MT_AERESP
        is_catreq = mtype == MT_CATREQ
        is_catresp = mtype == MT_CATRESP
        is_coc = mtype == MT_COC

        # RVREQ (raft.tla:578-597)
        lt = take(der["lastterm"], i)
        rv_logok = (f["a"] > lt) | ((f["a"] == lt) & (f["b"] >= llen_i))
        rv_grant = (mterm == ct_i) & rv_logok & ((vf_i == NIL) | (vf_i == j))
        rvreq_ok = is_rvreq & (mterm <= ct_i)
        # mlog carries the full log; llen > Lmax faults rather than
        # silently truncating
        rv_of = is_rvreq & (llen_i > Lmax)
        rv_resp = self.pack_msg(
            i, MT_RVRESP, ct_i, i, j, a=rv_grant.to(I32),
            ent=log_i[:Lmax], entlen=torch.clamp(llen_i, max=Lmax))

        # RVRESP (raft.tla:836-839, 602-614)
        rvresp_stale = mterm < ct_i
        rvresp_ok = is_rvresp & (mterm <= ct_i)
        rv_vr = take(sv["vr"], i) | (1 << j)
        rv_vg = take(sv["vg"], i) | torch.where(f["a"] == 1, 1 << j, 0)

        # AEREQ branch family (raft.tla:617-700)
        prev_idx = f["a"]
        ae_reject, ae_rtf, ae_already, ae_conflict, ae_noconf = \
            self._ae_branches(f, ct_i, st_i, llen_i, log_i)
        e0 = f["ent"][0]
        ae_resp_reject = self.pack_msg(i, MT_AERESP, ct_i, i, j, a=0, b=0)
        ae_resp_done = self.pack_msg(i, MT_AERESP, ct_i, i, j, a=1,
                                     b=prev_idx + f["entlen"])

        # AERESP (raft.tla:705-715)
        aeresp_stale = mterm < ct_i
        aeresp_ok = is_aeresp & (mterm <= ct_i)
        ae_succ = f["a"] == 1

        # CATREQ (raft.tla:718-745): splice prefix(min(mlogLen, Len))
        # ++ mentries (raft.tla:734-736)
        cat_stale = mterm < ct_i
        prefix_len = torch.minimum(f["a"], llen_i)
        new_len = prefix_len + f["entlen"]
        cat_overflow = new_len > Lcap
        pos0 = ar(Lcap, i)[:, None]                       # 0-based
        ent_idx = (pos0 - prefix_len[None]).clamp(0, Lmax - 1)
        spliced = torch.where(
            pos0 < prefix_len[None], log_i,
            torch.where(pos0 < new_len[None],
                        f["ent"].gather(0, ent_idx.long()), 0))
        cat_resp_stale = self.pack_msg(i, MT_CATRESP, ct_i, i, j, a=0, b=0,
                                       c=0)
        # success reply: mterm adopted, mmatchIndex = PRE-splice length,
        # roundsLeft = mrounds - 1 (raft.tla:738-744)
        cat_resp_ok = self.pack_msg(i, MT_CATRESP, mterm, i, j, a=1,
                                    b=llen_i, c=f["c"] - 1)

        # CATRESP (raft.tla:748-792); accept == NOT reject exactly
        mi_ij = at(mi_i, j)
        progress = ((f["b"] != ci_i) & (f["b"] != mi_ij)) | (f["b"] == ci_i)
        cat_accept = (f["a"] == 1) & progress & (st_i == LEADER) & \
            (mterm == ct_i) & (((cfg_i >> j) & 1) == 0)
        old_nij = at(ni_i, j)
        more = f["c"] != 0
        # follow-up CatchupRequest (raft.tla:762-771): unprimed
        # nextIndex, NO mcommitIndex field (b=-1 = absent)
        nent2_raw = torch.clamp(ci_i - old_nij + 1, min=0)
        nent2 = torch.clamp(nent2_raw, max=Lmax)
        cat_more_of = is_catresp & cat_accept & more & (nent2_raw > Lmax)
        gather2 = (old_nij[None] - 1 + ar(Lmax, i)[:, None]).clamp(
            0, Lcap - 1)
        cat_req_more = self.pack_msg(i, MT_CATREQ, ct_i, i, j,
                                     a=old_nij - 1, b=-1, c=f["c"],
                                     ent=log_i.gather(0, gather2.long()),
                                     entlen=nent2)
        coc_req_done = self.pack_msg(i, MT_COC, ct_i, i, i, a=1, b=j)

        # COC process branch (raft.tla:795-822)
        coc_ok = is_coc & (st_i == LEADER) & (mterm == ct_i)
        gate = take(der["maxcfg"], i) <= ci_i
        madd = f["a"] == 1
        coc_new = torch.where(madd, cfg_i | (1 << f["b"]),
                              cfg_i & ~(1 << f["b"]))
        coc_changed = coc_new != cfg_i
        coc_entry = self.pack_entry(ct_i, CONFIG_ENTRY, coc_new)
        coc_resend = self.pack_msg(i, MT_COC, ct_i, i, i, a=f["a"],
                                   b=f["b"])

        # ---- the successor, by masked writes ----
        sv2 = dict(sv)
        sv2["vf"] = put(sv["vf"], i, torch.where(
            is_rvreq & rvreq_ok & rv_grant, j, vf_i))
        rvresp_live = is_rvresp & rvresp_ok & ~rvresp_stale
        sv2["vr"] = put(sv["vr"], i, torch.where(
            rvresp_live, rv_vr, take(sv["vr"], i)))
        sv2["vg"] = put(sv["vg"], i, torch.where(
            rvresp_live, rv_vg, take(sv["vg"], i)))
        # role change (AEREQ ReturnToFollowerState)
        sv2["st"] = put(sv["st"], i, torch.where(
            is_aereq & ae_rtf, FOLLOWER, st_i))
        # commitIndex (AEREQ AlreadyDone: can DECREASE, raft.tla:644)
        sv2["ci"] = put(sv["ci"], i, torch.where(
            is_aereq & ae_already, f["c"], ci_i))
        # log edits
        new_log_i, new_llen_i = log_i, llen_i
        # AEREQ Conflict: truncate exactly one tail entry (:658-665)
        trunc = is_aereq & ae_conflict
        new_log_i = torch.where(
            trunc, put(log_i, (llen_i - 1).clamp(0, Lcap - 1), 0),
            new_log_i)
        new_llen_i = torch.where(trunc, llen_i - 1, new_llen_i)
        # AEREQ NoConflict: append one entry (raft.tla:668-672)
        app = is_aereq & ae_noconf
        new_log_i = torch.where(
            app,
            put(log_i, llen_i.clamp(0, Lcap - 1),
                torch.where(llen_i >= Lcap, log_i[Lcap - 1], e0)),
            new_log_i)
        new_llen_i = torch.where(app & (llen_i < Lcap), llen_i + 1,
                                 new_llen_i)
        # CATREQ splice
        cat_live = is_catreq & ~cat_stale
        new_log_i = torch.where(
            cat_live, torch.where(cat_overflow, log_i, spliced), new_log_i)
        new_llen_i = torch.where(cat_live & ~cat_overflow, new_len,
                                 new_llen_i)
        # COC append ConfigEntry
        coc_app = coc_ok & gate & coc_changed
        coc_of = llen_i >= Lcap
        new_log_i = torch.where(
            coc_app,
            put(log_i, llen_i.clamp(0, Lcap - 1),
                torch.where(coc_of, log_i[Lcap - 1], coc_entry)),
            new_log_i)
        new_llen_i = torch.where(coc_app & ~coc_of, llen_i + 1, new_llen_i)
        sv2["log"] = put(sv["log"], i, new_log_i)
        sv2["llen"] = put(sv["llen"], i, new_llen_i)
        # currentTerm adopt (CATREQ success branch, raft.tla:737)
        sv2["ct"] = put(sv["ct"], i, torch.where(
            cat_live, torch.maximum(mterm, ct_i), ct_i))
        # next/match updates (AERESP, CATRESP-accept)
        ae_live = is_aeresp & aeresp_ok & ~aeresp_stale
        ni_new = torch.where(
            ae_live,
            torch.where(ae_succ, f["b"] + 1,
                        torch.clamp(old_nij - 1, min=1)),
            torch.where(is_catresp & cat_accept, f["b"] + 1, old_nij))
        mi_new = torch.where(
            (ae_live & ae_succ) | (is_catresp & cat_accept), f["b"], mi_ij)
        sv2["ni"] = put(sv["ni"], i, put(ni_i, j, ni_new))
        sv2["mi"] = put(sv["mi"], i, put(mi_i, j, mi_new))
        # membership-change counter + features (COC apply)
        ctr = addc(sv["ctr"], C_NMC, coc_app.to(I32))
        feat = sv["feat"].clone()
        add_rec = coc_app & madd
        feat[F_ADDED_SET] = torch.where(
            add_rec, feat[F_ADDED_SET] | (1 << f["b"]), feat[F_ADDED_SET])
        feat[F_OPEN_ADD] = torch.maximum(feat[F_OPEN_ADD],
                                         add_rec.to(I32))
        sv2["feat"] = feat
        ctr[C_OVERFLOW] += ((cat_live & cat_overflow) | (coc_app & coc_of) |
                            rv_of | cat_more_of).to(I32)
        sv2["ctr"] = ctr

        # bag update: consume request? send reply?
        consume = (is_rvreq & rvreq_ok) | rvresp_live | \
            (is_rvresp & rvresp_ok & rvresp_stale) | \
            (is_aereq & (ae_reject | ae_already)) | \
            (is_aeresp & aeresp_ok) | is_catreq | is_catresp | coc_ok
        # (ReturnToFollower / Conflict / NoConflict do NOT consume)
        reply_words = torch.where(
            is_rvreq, rv_resp,
            torch.where(is_aereq & ae_reject, ae_resp_reject,
            torch.where(is_aereq & ae_already, ae_resp_done,
            torch.where(is_catreq & cat_stale, cat_resp_stale,
            torch.where(is_catreq, cat_resp_ok,
            torch.where(is_catresp & cat_accept & more, cat_req_more,
            torch.where(is_catresp & cat_accept, coc_req_done,
                        coc_resend)))))))
        has_reply = (is_rvreq & rvreq_ok) | \
            (is_aereq & (ae_reject | ae_already)) | is_catreq | \
            (is_catresp & cat_accept) | (coc_ok & ~gate)
        sv3 = self.bag_del_slot(sv2, k)
        for key in ("bag", "cnt"):
            sv3[key] = torch.where(consume, sv3[key], sv2[key])
        sv4 = self.bag_put(sv3, reply_words)
        for key in ("bag", "cnt", "ctr"):
            sv4[key] = torch.where(has_reply, sv4[key], sv3[key])
        # history record count: Reply=2, Discard=1, silent=0;
        # DiscardDirectWithMembershipChange appends 2 (raft.tla:285-290)
        n_rec = torch.where(has_reply | coc_app, 2,
                            torch.where(consume, 1, 0)).to(I32)
        return self._glob(sv4, n_rec)

    # ------------------------------------------------------------------
    # Guards: per-state features whose signed sums decide every lane
    # ------------------------------------------------------------------

    def _slot_view(self, sv: State):
        """Per bag slot: header fields [K, N] and the addressed server's
        scalars (dst = i)."""
        f = self.msg_fields(sv["bag"].movedim(1, 0))      # [MW, K, N]
        i = f["mdst"]
        return f, i, take(sv["ct"], i), take(sv["st"], i)

    def guard_features(self, sv: State, der: State) -> torch.Tensor:
        """Per-state guard-feature vector φ(s), int32 [F, N], in the
        ``guard_feature_offsets`` layout: every family's enabling guard
        is a signed-weight threshold over these features."""
        S = self.S
        st = sv["st"]
        leader = st == LEADER
        cand = st == CANDIDATE
        folc = (st == FOLLOWER) | cand
        blq = self.in_quorum(sv["vg"], der["config"])
        jj = ar(S, st)[None, :, None]
        cfgb = ((der["config"][:, None] >> jj) & 1) == 1             # [S,S,N]
        nv = (((der["config"] & ~sv["vr"])[:, None] >> jj) & 1) == 1
        f, i, ct_i, st_i = self._slot_view(sv)
        has = sv["cnt"] > 0
        mterm, mtype = f["mterm"], f["mtype"]
        # update_term (raft.tla:826-832)
        ut = has & (mterm > ct_i)
        # coc_discard (raft.tla:796)
        cocd = has & (mtype == MT_COC) & ((st_i != LEADER) | (mterm == ct_i))
        # receive_main's guard: any per-type branch enabled
        llen_i = take(sv["llen"], i)
        log_i = take(sv["log"], i)                        # [K, Lcap, N]
        aereq_ok = (mtype == MT_AEREQ) & torch.stack(
            self._ae_branches(f, ct_i, st_i, llen_i, log_i)).any(0)
        recv = has & (
            ((mtype == MT_RVREQ) & (mterm <= ct_i)) |
            ((mtype == MT_RVRESP) & (mterm <= ct_i)) | aereq_ok |
            ((mtype == MT_AERESP) & (mterm <= ct_i)) |
            (mtype == MT_CATREQ) | (mtype == MT_CATRESP) |
            ((mtype == MT_COC) & (st_i == LEADER) & (mterm == ct_i)))
        cnt1 = sv["cnt"] == 1
        N = st.shape[-1]
        return torch.cat([
            leader, cand, folc, blq, cfgb.reshape(-1, N),
            nv.reshape(-1, N), ut, cocd, recv, cnt1]).to(I32)

    # ------------------------------------------------------------------
    # Delta features: the data-dependent sources of the delta group
    # (engine/expand.py).  Every affine family's state delta is a
    # weighted sum of these per-state int32 values, the constant 1 and
    # the flat state view itself:
    #
    # - BecomeLeader's three feat max-updates, pre-differenced
    #   (max(old, x) - old), so an add lands the max exactly;
    # - Timeout's term-capacity clamp (ct < cap: the room is the
    #   increment);
    # - ClientRequest's append: the one-hot of the append position
    #   (llen), the same one-hot scaled by the term and by the old log
    #   word (so set == add with the old value cancelled), and the llen
    #   room;
    # - UpdateTerm's message-indexed sets: per bag slot, the dst one-hot
    #   scaled by (new - old) for each of the three per-server writes;
    # - Restart's min-gap update, pre-differenced (min(old, gap) - old).
    #
    # Layout is ``delta_feature_offsets``; the two move together.
    # ------------------------------------------------------------------

    def delta_features(self, sv: State, der: State) -> torch.Tensor:
        """Per-state delta-feature vector, int32 [n_delta_features, N],
        in the ``delta_feature_offsets`` layout."""
        S, Lcap = self.S, self.Lcap
        hs = self.lay.header_shifts
        feat = sv["feat"]                                 # [NF, N]
        N = feat.shape[-1]
        ii = ar(S, feat)[:, None]                         # [S, 1]
        # BecomeLeader feat deltas, per candidate server i
        leaders2 = der["leaders"][None] | (1 << ii)       # [S, N]
        bl2 = (popcount(leaders2, S) >= 2).to(I32)
        d_bl2 = torch.maximum(feat[F_BL2_SEEN], bl2) - feat[F_BL2_SEEN]
        njbl = (feat[F_ADDED_SET][None] >> ii) & 1
        d_njbl = torch.maximum(feat[F_NJBL], njbl) - feat[F_NJBL]
        d_lcdcc = (torch.maximum(feat[F_LCDCC], feat[F_OPEN_ADD]) -
                   feat[F_LCDCC])[None]
        # Timeout's clamped term bump: room == the exact increment
        ctroom = (sv["ct"] < self.term_cap).to(I32)
        # ClientRequest append: llen room + the append-position one-hot
        crroom = (sv["llen"] < Lcap).to(I32)
        croh = (sv["llen"][:, None] ==
                ar(Lcap, feat)[None, :, None]).to(I32)    # [S, Lcap, N]
        crohct = croh * sv["ct"][:, None]
        crohold = croh * sv["log"]
        # UpdateTerm's per-slot writes, dst-one-hot scaled and
        # pre-differenced (new - old)
        w0 = sv["bag"][:, 0]                              # [K, N]
        oh = (get_field_t(w0, hs["mdst"])[:, None] ==
              ii[None]).to(I32)                           # [K, S, N]
        utdct = oh * (get_field_t(w0, hs["mterm"])[:, None] - sv["ct"])
        utdst = oh * (FOLLOWER - sv["st"])
        utdvf = oh * (NIL - sv["vf"])
        # Restart's min-gap update, pre-differenced: the gap as
        # restart() computes it
        pos = sv["ctr"][C_GLOBLEN] + 1
        last = feat[F_LAST_RESTART_POS]
        gap = torch.where(last > 0, pos - last, NO_GAP)
        rgap = (torch.minimum(feat[F_MIN_RESTART_GAP], gap) -
                feat[F_MIN_RESTART_GAP])[None]
        return torch.cat([
            d_bl2, d_njbl, d_lcdcc, ctroom, crroom,
            croh.reshape(-1, N), crohct.reshape(-1, N),
            crohold.reshape(-1, N), utdct.reshape(-1, N),
            utdst.reshape(-1, N), utdvf.reshape(-1, N), rgap]).to(I32)

    def delta_feature_offsets(self) -> Dict[str, int]:
        return delta_feature_offsets(self.lay)


def guard_feature_offsets(lay: Layout) -> Dict[str, int]:
    """Flat layout of ``RaftKernels.guard_features``: per-server role
    blocks (leader / candidate / follower-or-candidate / become-leader
    quorum), the two [S, S] config-bit grids (cfg[i,j], needvote[i,j],
    row-major), then the four per-slot blocks (update_term /
    coc_discard / receive / count==1)."""
    S, K = lay.S, lay.K
    off = dict(leader=0, cand=S, folc=2 * S, blq=3 * S, cfg=4 * S,
               needvote=4 * S + S * S)
    base = 4 * S + 2 * S * S
    off.update(ut=base, cocd=base + K, recv=base + 2 * K,
               cnt1=base + 3 * K)
    off["total"] = base + 4 * K
    return off


def delta_feature_offsets(lay: Layout) -> Dict[str, int]:
    """Flat layout of ``RaftKernels.delta_features``: the BecomeLeader
    feat-delta blocks (bl2 / njbl per server, the scalar lcdcc), the
    Timeout term-room block, the ClientRequest append blocks (llen
    room, and the three [S, Lcap] one-hot grids: position, position ×
    term, position × old log word), the three UpdateTerm [K, S]
    dst-one-hot set-difference grids (ct / st / vf, row-major), and
    the scalar Restart min-gap difference."""
    S, Lcap, K = lay.S, lay.Lcap, lay.K
    off = dict(bl2=0, njbl=S, lcdcc=2 * S, ctroom=2 * S + 1,
               crroom=3 * S + 1, croh=4 * S + 1,
               crohct=4 * S + 1 + S * Lcap,
               crohold=4 * S + 1 + 2 * S * Lcap)
    base = 4 * S + 1 + 3 * S * Lcap
    off.update(utdct=base, utdst=base + K * S,
               utdvf=base + 2 * K * S, rgap=base + 3 * K * S)
    off["total"] = base + 3 * K * S + 1
    return off
