"""Host-side codec: oracle (State, Hist) ↔ device struct-of-arrays.

The device state is a dict of arrays (numpy on the host; torch tensors,
batch axis last, in the engine).  Fields:

  VIEW region (state identity, raft.cfg:30 ``VIEW vars``; SURVEY §2.2):
    ct, st, vf, ci, llen : i32[S]       per-server scalars
    log                  : i32[S, Lcap] packed entries (0 = empty slot)
    vr, vg               : i32[S]       vote-set bitmasks
    ni, mi               : i32[S, S]    nextIndex / matchIndex
    bag                  : u32[K, MW]   packed messages (all-zero = empty)
    cnt                  : i32[K]       bag copy counts (0 = empty slot)

  non-VIEW region (history counters + scenario features — inputs to
  constraints and scenario predicates, excluded from identity; SURVEY §2.2
  and §5 "Tracing"):
    restarted, timeout   : i32[S]
    ctr                  : i32[NCTR]    [nleaders, nreq, ntried, nmc,
                                         globlen, overflow, 0, 0]
    feat                 : i32[NFEAT]   derived scenario features (below)

`overflow` is the fault lane for un-representable growth (log beyond Lcap,
bag beyond K): the reference *constrains* those away, so with the stock
constraint set it stays 0; if a user disables the bounds we fault instead
of silently wrapping (SURVEY §7.4 hard part 3).

Scenario feature lanes (computed incrementally by kernels; recomputed from
the oracle history here for encoding mid-trace states):
    F_COMMIT_SEEN      any CommitEntry record            (raft.tla:1160-1163)
    F_BL2_SEEN         any BecomeLeader with ≥2 leaders  (raft.tla:1165-1176)
    F_CWCL_POS         1-based glob position of the first CommitEntry after
                       a BL2 record; 0 = none            (raft.tla:1165-1176)
    F_LAST_RESTART_POS 1-based position of last Restart  (raft.tla:1212-1226)
    F_MIN_RESTART_GAP  min gap between consecutive Restart records
    F_ADDED_SET        mask of servers in AddServer records (raft.tla:1248+)
    F_OPEN_ADD         AddServer seen, no CommitMembershipChange since
    F_NJBL             BecomeLeader by a previously-added server
    F_LCDCC            BecomeLeader while F_OPEN_ADD      (raft.tla:1268-1278)
    F_ADD_COMMITS      CommitMembershipChange ∩ addedSet  (raft.tla:1248-1256)
    F_PREFIX_MASK      RESERVED, always -1.  The punctuated-search prefix
                       pins (raft.tla:1198-1204) compile into BFS seed
                       states instead (cfg prefix_pins ->
                       models/golden.prefix_pin_seeds), so no per-state
                       prefix tracking is needed; the lane is kept so a
                       future in-flight IsPrefix mask has a home without
                       a layout change
    F_MC_COMMITS       count of CommitMembershipChange records — feeds
                       MembershipChangeCommits / MultipleMembership-
                       ChangesCommit (raft.tla:1239-1246)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import (MT_AEREQ, MT_AERESP, MT_CATREQ, MT_CATRESP, MT_COC,
                      MT_RVREQ, MT_RVRESP, popcount)
from ..models.raft import Hist, State
from .layout import (Layout, MSG_FIELDS, get_field, pack_entry,
                     put_field_checked, unpack_entry)

# the shared cross-spec ctr-lane contract now lives in the spec
# package (every SpecIR's encoded state carries the same ctr vector);
# aliased here for the historical import path
from ..spec import (C_GLOBLEN, C_NLEADERS, C_NMC, C_NREQ,   # noqa: F401
                    C_NTRIED, C_OVERFLOW, NCTR)

NFEAT = 12
(F_COMMIT_SEEN, F_BL2_SEEN, F_CWCL_POS, F_LAST_RESTART_POS,
 F_MIN_RESTART_GAP, F_ADDED_SET, F_OPEN_ADD, F_NJBL, F_LCDCC,
 F_ADD_COMMITS, F_PREFIX_MASK, F_MC_COMMITS) = range(NFEAT)

NO_GAP = 1 << 20  # "no restart pair yet" sentinel for F_MIN_RESTART_GAP

VIEW_KEYS = ("ct", "st", "vf", "ci", "llen", "log", "vr", "vg", "ni", "mi",
             "bag", "cnt")
NONVIEW_KEYS = ("restarted", "timeout", "ctr", "feat")
ALL_KEYS = VIEW_KEYS + NONVIEW_KEYS


# ---------------------------------------------------------------------------
# Storage dtypes.  Kernels/oracle/tests speak int32 SoA (encode's output);
# the ENGINES store frontier/level/archive buffers narrowed to the
# smallest dtype the configured bounds fit (VERDICT r2: the int32 rows
# cost ~620 B/state; terms <= 5, masks <= 2^S, indices <= Lcap all fit
# int8/int16, a 2-3x HBM capacity + bandwidth win), widening per chunk
# before the kernels run.  `bag` stays u32 (packed words); `ctr`/`feat`
# stay int32 (C_GLOBLEN grows with trace length; NO_GAP sentinel).
# ---------------------------------------------------------------------------

def _int_dtype_for(maxval: int) -> np.dtype:
    if maxval <= 127:
        return np.dtype(np.int8)
    if maxval <= 32767:
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def narrow_dtypes(lay: Layout) -> Dict[str, np.dtype]:
    b = lay.cfg.bounds
    i32 = np.dtype(np.int32)
    mx = {
        "ct": b.max_terms + 1, "st": 2, "vf": lay.S, "ci": lay.Lcap,
        "llen": lay.Lcap, "log": (1 << lay.entry_bits) - 1,
        "vr": (1 << lay.S) - 1, "vg": (1 << lay.S) - 1,
        "ni": lay.Lcap + 1, "mi": lay.Lcap,
        # counters can outrun their Bounded* budgets when a cfg disables
        # the constraint, so give them int16 headroom regardless
        "restarted": 32000, "timeout": 32000, "cnt": 32000,
    }
    out = {k: _int_dtype_for(v) for k, v in mx.items()}
    out["bag"] = np.dtype(np.uint32)
    out["ctr"] = i32
    out["feat"] = i32
    return out


def narrow(lay: Layout, arrs):
    """int32 SoA rows -> storage dtypes (numpy, shape-agnostic)."""
    dts = narrow_dtypes(lay)
    return {k: v.astype(dts[k]) for k, v in arrs.items()}


def widen(arrs):
    """Storage rows -> the kernels' int32/uint32 SoA contract (key-based
    so it also normalizes e.g. int64 arrays from JSON-loaded seeds)."""
    return {k: v.astype(np.uint32) if k == "bag" else v.astype(np.int32)
            for k, v in arrs.items()}


_TORCH_DTYPES = {np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32,
                 # u32 words ride as int32 bit patterns (utils docstring)
                 np.dtype(np.uint32): torch.int32}


def narrow_t(lay: Layout, arrs):
    """Torch form of narrow: int32 SoA tensors -> storage dtypes."""
    dts = narrow_dtypes(lay)
    return {k: v.to(_TORCH_DTYPES[dts[k]]) for k, v in arrs.items()}


def widen_t(arrs):
    """Torch form of widen: storage tensors -> the kernels' int32."""
    return {k: v.to(torch.int32) for k, v in arrs.items()}


# ---------------------------------------------------------------------------
# Message packing
# ---------------------------------------------------------------------------

def pack_msg(lay: Layout, m: tuple) -> np.ndarray:
    """Oracle message tuple -> u32[msg_words].  Generic fields a/b/c are
    stored +1 so an absent field (-1; the follow-up CatchupRequest's missing
    mcommitIndex, raft.tla:762-771) packs as 0 and field-set identity is
    preserved."""
    hs = lay.header_shifts
    f = MSG_FIELDS[m[0]]
    ent = m[f["ent"]] if f["ent"] is not None else ()

    def gf(key):
        idx = f[key]
        return (m[idx] if idx is not None else -1) + 1

    w0 = (put_field_checked(m[0], hs["mtype"], "mtype") |
          put_field_checked(m[1], hs["mterm"], "mterm") |
          put_field_checked(m[f["src"]], hs["msrc"], "msrc") |
          put_field_checked(m[f["dst"]], hs["mdst"], "mdst") |
          put_field_checked(gf("a"), hs["a"], "a") |
          put_field_checked(gf("b"), hs["b"], "b") |
          put_field_checked(gf("c"), hs["c"], "c") |
          put_field_checked(len(ent), hs["entlen"], "entlen"))
    words = np.zeros(lay.msg_words, dtype=np.uint32)
    words[0] = w0 & 0xFFFFFFFF
    epw = lay.entries_per_word
    for k, e in enumerate(ent):
        packed = pack_entry(lay, e[0], e[1], e[2])
        words[1 + k // epw] |= np.uint32(packed << (lay.entry_bits *
                                                    (k % epw)))
    return words


def unpack_msg(lay: Layout, words) -> tuple:
    """u32[msg_words] -> oracle message tuple (exact field order/set)."""
    hs = lay.header_shifts
    w0 = int(words[0])
    mtype = get_field(w0, hs["mtype"])
    term = get_field(w0, hs["mterm"])
    src = get_field(w0, hs["msrc"])
    dst = get_field(w0, hs["mdst"])
    a = get_field(w0, hs["a"]) - 1
    b = get_field(w0, hs["b"]) - 1
    c = get_field(w0, hs["c"]) - 1
    nent = get_field(w0, hs["entlen"])
    epw = lay.entries_per_word
    mask = (1 << lay.entry_bits) - 1
    ent = tuple(
        unpack_entry(lay, (int(words[1 + k // epw]) >>
                           (lay.entry_bits * (k % epw))) & mask)
        for k in range(nent))
    if mtype == MT_RVREQ:
        return (mtype, term, a, b, src, dst)
    if mtype == MT_RVRESP:
        return (mtype, term, a, ent, src, dst)
    if mtype == MT_AEREQ:
        return (mtype, term, a, b, ent, c, src, dst)
    if mtype == MT_AERESP:
        return (mtype, term, a, b, src, dst)
    if mtype == MT_CATREQ:
        return (mtype, term, a, ent, b, src, dst, c)
    if mtype == MT_CATRESP:
        return (mtype, term, a, b, src, dst, c)
    if mtype == MT_COC:
        return (mtype, term, a, b, src, dst)
    raise ValueError(f"bad message type {mtype}")


# ---------------------------------------------------------------------------
# Scenario features from an oracle history (mirrors what kernels maintain)
# ---------------------------------------------------------------------------

def features_from_hist(h: Hist) -> np.ndarray:
    feat = np.zeros(NFEAT, dtype=np.int32)
    feat[F_PREFIX_MASK] = -1
    bl2_seen = False
    open_add = False
    added = 0
    last_restart = 0
    min_gap = NO_GAP
    for k, r in enumerate(h.glob):
        pos = k + 1  # 1-based, matching the spec's Len-based indexing
        kind = r[0]
        if kind == "CommitEntry":
            feat[F_COMMIT_SEEN] = 1
            if bl2_seen and feat[F_CWCL_POS] == 0:
                feat[F_CWCL_POS] = pos
        elif kind == "BecomeLeader":
            if popcount(r[2]) >= 2:
                bl2_seen = True
            if (added >> r[1]) & 1:
                feat[F_NJBL] = 1
            if open_add:
                feat[F_LCDCC] = 1
        elif kind == "Restart":
            if last_restart:
                min_gap = min(min_gap, pos - last_restart)
            last_restart = pos
        elif kind == "AddServer":
            added |= 1 << r[2]
            open_add = True
        elif kind == "CommitMembershipChange":
            if r[2] & added:
                feat[F_ADD_COMMITS] = 1
            open_add = False
            feat[F_MC_COMMITS] += 1
    feat[F_BL2_SEEN] = int(bl2_seen)
    feat[F_LAST_RESTART_POS] = last_restart
    feat[F_MIN_RESTART_GAP] = min_gap
    feat[F_ADDED_SET] = added
    feat[F_OPEN_ADD] = int(open_add)
    return feat


# ---------------------------------------------------------------------------
# State encode / decode
# ---------------------------------------------------------------------------

def encode(lay: Layout, sv: State, h: Hist) -> Dict[str, np.ndarray]:
    S, Lcap, K, MW = lay.S, lay.Lcap, lay.K, lay.msg_words
    out = {
        "ct": np.array(sv.ct, dtype=np.int32),
        "st": np.array(sv.st, dtype=np.int32),
        "vf": np.array(sv.vf, dtype=np.int32),
        "ci": np.array(sv.ci, dtype=np.int32),
        "llen": np.array([len(l) for l in sv.log], dtype=np.int32),
        "vr": np.array(sv.vr, dtype=np.int32),
        "vg": np.array(sv.vg, dtype=np.int32),
        "ni": np.array(sv.ni, dtype=np.int32),
        "mi": np.array(sv.mi, dtype=np.int32),
    }
    log = np.zeros((S, Lcap), dtype=np.int32)
    for i, slog in enumerate(sv.log):
        assert len(slog) <= Lcap, "log overflow: un-representable state"
        for k, e in enumerate(slog):
            log[i, k] = pack_entry(lay, e[0], e[1], e[2])
    out["log"] = log
    bag = np.zeros((K, MW), dtype=np.uint32)
    cnt = np.zeros(K, dtype=np.int32)
    assert len(sv.msgs) <= K, "bag overflow: un-representable state"
    for slot, (m, c) in enumerate(sv.msgs):
        bag[slot] = pack_msg(lay, m)
        cnt[slot] = c
    out["bag"] = bag
    out["cnt"] = cnt
    out["restarted"] = np.array(h.restarted, dtype=np.int32)
    out["timeout"] = np.array(h.timeout, dtype=np.int32)
    ctr = np.zeros(NCTR, dtype=np.int32)
    ctr[C_NLEADERS], ctr[C_NREQ] = h.nleaders, h.nreq
    ctr[C_NTRIED], ctr[C_NMC] = h.ntried, h.nmc
    ctr[C_GLOBLEN] = len(h.glob)
    out["ctr"] = ctr
    out["feat"] = features_from_hist(h)
    return out


def decode(lay: Layout, arrs: Dict[str, np.ndarray]) -> Tuple[State, Hist]:
    """Device arrays -> (State, Hist).  The global history *sequence* is not
    reconstructible from counters (it lives host-side, SURVEY §5); the
    returned Hist carries the counters and an empty glob."""
    a = {k: np.asarray(v) for k, v in arrs.items()}
    S = lay.S
    log = []
    for i in range(S):
        n = int(a["llen"][i])
        log.append(tuple(unpack_entry(lay, int(a["log"][i, k]))
                         for k in range(n)))
    msgs = {}
    for slot in range(lay.K):
        c = int(a["cnt"][slot])
        if c > 0:
            m = unpack_msg(lay, a["bag"][slot])
            msgs[m] = msgs.get(m, 0) + c   # split slots merge here
    sv = State(
        ct=tuple(int(x) for x in a["ct"]),
        st=tuple(int(x) for x in a["st"]),
        vf=tuple(int(x) for x in a["vf"]),
        log=tuple(log),
        ci=tuple(int(x) for x in a["ci"]),
        vr=tuple(int(x) for x in a["vr"]),
        vg=tuple(int(x) for x in a["vg"]),
        ni=tuple(tuple(int(x) for x in row) for row in a["ni"]),
        mi=tuple(tuple(int(x) for x in row) for row in a["mi"]),
        msgs=tuple(sorted(msgs.items())),
    )
    ctr = a["ctr"]
    h = Hist(
        restarted=tuple(int(x) for x in a["restarted"]),
        timeout=tuple(int(x) for x in a["timeout"]),
        nleaders=int(ctr[C_NLEADERS]), nreq=int(ctr[C_NREQ]),
        ntried=int(ctr[C_NTRIED]), nmc=int(ctr[C_NMC]),
        glob=(),
    )
    return sv, h


def stack(states):
    """List of single-state dicts -> batched dict (leading axis)."""
    return {k: np.stack([s[k] for s in states]) for k in states[0]}


def unstack(batch, idx):
    return {k: np.asarray(v)[idx] for k, v in batch.items()}
