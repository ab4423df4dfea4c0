"""Plain-Python executable model of the Raft spec family (the oracle).

The port's own copy of the reference package's oracle
(``raft_tla_tpu/models/raft.py``), kept line for line: the state
types the codec decodes into, the message field table the packed
layout is built from, the JSON seed format, the 11 actions and the
Receive handlers, ``successors`` and the symmetry group.  The engine's
kernels (``ops/kernels.py``) and the oracle BFS (``models/explore.py``)
are held against it.

A dict/tuple-based, *painfully literal* transcription of the semantics of
the upstream spec `tlc_membership/raft.tla` (line references in each
function).  It exists so the vectorized kernels have a ground truth to be
differentially tested against: same successor sets, same distinct-state
counts, same invariant verdicts.

Deliberate literalism notes (all cited):
  * `HandleCheckOldConfig`'s first branch guard is
    `state[i] /= Leader \\/ m.mterm = currentTerm[i]` (raft.tla:796) — for a
    Leader at the message's term this makes the discard branch *and* the
    process branch both enabled (two successors), and a stale-term message at
    a Leader permanently unreceivable.  We reproduce this exactly.
  * `UpdateTerm` (raft.tla:826-832) overlaps `HandleCatchupRequest`'s
    `m.mterm >= currentTerm[i]` branch (raft.tla:729) and
    `HandleCheckOldConfig`'s discard branch: one message can yield several
    successors.
  * `HandleCatchupRequest` replies with `mmatchIndex |-> Len(log[i])` using
    the *unprimed* log (raft.tla:740) — i.e. the pre-splice length.
  * `HandleCatchupResponse`'s follow-up CatchupRequest (raft.tla:762-771)
    reads the *unprimed* nextIndex and omits the `mcommitIndex` field that
    `AddNewServer`'s CatchupRequest has (raft.tla:551); records with
    different field sets are distinct TLA+ values, so the omission is part
    of message identity.  We encode "absent" as mcommit = -1 (real
    mcommitIndex values are >= 0, and an int keeps messages orderable for
    the canonical sorted-bag representation).
  * `ConflictAppendEntriesRequest` / `NoConflictAppendEntriesRequest` /
    `ReturnToFollowerState` do **not** consume the message and do not touch
    history (raft.tla:632-636, 658-672).
  * `ClientRequest` bumps hadNumClientRequests but appends **no** global
    history record (raft.tla:488-497).

Servers are 0-based ints; Nil is -1; sets of servers are int bitmasks.
A log entry is a tuple ``(term, etype, payload)`` where payload is the client
value for VALUE_ENTRY and a server bitmask for CONFIG_ENTRY.
"""

from __future__ import annotations

import itertools
from collections import namedtuple
from typing import List, Tuple

from ..config import (
    CANDIDATE, CONFIG_ENTRY, FOLLOWER, LEADER, MT_AEREQ, MT_AERESP, MT_CATREQ,
    MT_CATRESP, MT_COC, MT_RVREQ, MT_RVRESP, NEXT_ASYNC, NEXT_ASYNC_CRASH,
    NEXT_DYNAMIC, NEXT_FULL, NIL, VALUE_ENTRY, ModelConfig, popcount,
    mask_iter,
)

# ---------------------------------------------------------------------------
# State representation
# ---------------------------------------------------------------------------

# The 10 semantic variables = the VIEW (raft.tla:193, raft.cfg:30).
State = namedtuple("State", [
    "ct",    # currentTerm : tuple[int]          (raft.tla:136-138)
    "st",    # state       : tuple[int]          (raft.tla:140-142)
    "vf",    # votedFor    : tuple[int], NIL=-1  (raft.tla:144-147)
    "log",   # log         : tuple[tuple[entry]] (raft.tla:153-155)
    "ci",    # commitIndex : tuple[int]          (raft.tla:157-159)
    "vr",    # votesResponded : tuple[int bitmask] (raft.tla:165-167)
    "vg",    # votesGranted   : tuple[int bitmask] (raft.tla:170-172)
    "ni",    # nextIndex   : tuple[tuple[int]]   (raft.tla:178-180)
    "mi",    # matchIndex  : tuple[tuple[int]]   (raft.tla:183-185)
    "msgs",  # messages bag: tuple[(msg, count)], sorted (raft.tla:114-123)
])

# The history variable (raft.tla:127-131, 379-386). Excluded from the VIEW.
Hist = namedtuple("Hist", [
    "restarted",  # tuple[int] per server
    "timeout",    # tuple[int] per server
    "nleaders",   # hadNumLeaders
    "nreq",       # hadNumClientRequests
    "ntried",     # hadNumTriedMembershipChanges
    "nmc",        # hadNumMembershipChanges
    "glob",       # tuple of action records (see below)
])

# Global-history action records, mirroring raft.tla's ACTION values:
#   ("Send", executedOn, msg)             SendDirect     raft.tla:248
#   ("Receive", executedOn, msg)          Discard/Reply  raft.tla:281,311
#   ("Restart", i)                                       raft.tla:410
#   ("Timeout", i)                                       raft.tla:426
#   ("BecomeLeader", i, leaders_mask)                    raft.tla:483
#   ("CommitEntry", i, entry)                            raft.tla:537
#   ("CommitMembershipChange", i, config_mask)           raft.tla:534
#   ("TryAddServer", i, added)                           raft.tla:251
#   ("TryRemoveServer", i, removed)                      raft.tla:253
#   ("AddServer", i, added)                              raft.tla:802
#   ("RemoveServer", i, removed)                         raft.tla:803

# Message tuples (type tag first; field order mirrors the packed codec):
#   (MT_RVREQ,   term, lastLogTerm, lastLogIndex, src, dst)     raft.tla:434-439
#   (MT_RVRESP,  term, granted, mlog, src, dst)                 raft.tla:588-596
#   (MT_AEREQ,   term, prevIdx, prevTerm, entries, mcommit, src, dst) :460-467
#   (MT_AERESP,  term, success, matchIdx, src, dst)             raft.tla:648-654
#   (MT_CATREQ,  term, logLen, entries, mcommit, src, dst, rounds)    :547-554
#                 (mcommit is -1 ["field absent"] for the follow-up requests of
#                  HandleCatchupResponse, raft.tla:762-771)
#   (MT_CATRESP, term, success, matchIdx, src, dst, roundsLeft) raft.tla:720-744
#   (MT_COC,     term, madd, mserver, src, dst)                 raft.tla:563-568

_SRC_DST = {
    MT_RVREQ: (4, 5), MT_RVRESP: (4, 5), MT_AEREQ: (6, 7), MT_AERESP: (4, 5),
    MT_CATREQ: (5, 6), MT_CATRESP: (4, 5), MT_COC: (4, 5),
}


def msg_src(m):
    return m[_SRC_DST[m[0]][0]]


def msg_dst(m):
    return m[_SRC_DST[m[0]][1]]


def msg_term(m):
    return m[1]


# ---------------------------------------------------------------------------
# JSON-able (de)serialization — the seed-trace file format for punctuated
# search (`check --seed-trace`, the equivalent of the spec's hard-coded
# prefix pins at raft.tla:1198-1234).
# ---------------------------------------------------------------------------

def _deep_tuple(x):
    if isinstance(x, list):
        return tuple(_deep_tuple(e) for e in x)
    return x


def _deep_list(x):
    if isinstance(x, tuple):
        return [_deep_list(e) for e in x]
    return x


def state_to_obj(sv: "State", h: "Hist") -> dict:
    return {"state": [_deep_list(f)
                      for f in (sv.ct, sv.st, sv.vf, sv.log, sv.ci, sv.vr,
                                sv.vg, sv.ni, sv.mi, sv.msgs)],
            "hist": [_deep_list(h.restarted), _deep_list(h.timeout),
                     h.nleaders, h.nreq, h.ntried, h.nmc,
                     _deep_list(h.glob)]}


def state_from_obj(obj: dict):
    f = [_deep_tuple(x) for x in obj["state"]]
    sv = State(ct=f[0], st=f[1], vf=f[2], log=f[3], ci=f[4], vr=f[5],
               vg=f[6], ni=f[7], mi=f[8], msgs=f[9])
    hh = obj["hist"]
    h = Hist(restarted=_deep_tuple(hh[0]), timeout=_deep_tuple(hh[1]),
             nleaders=hh[2], nreq=hh[3], ntried=hh[4], nmc=hh[5],
             glob=_deep_tuple(hh[6]))
    return sv, h


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def tup_set(t, i, v):
    return t[:i] + (v,) + t[i + 1:]


def row_set(mat, i, row):
    return mat[:i] + (row,) + mat[i + 1:]


def cell_set(mat, i, j, v):
    return row_set(mat, i, tup_set(mat[i], j, v))


def last_term(log):
    """LastTerm (raft.tla:221)."""
    return log[-1][0] if log else 0


def get_config_of_log(slog, cfg: ModelConfig) -> int:
    """GetHistoricalConfig on one log (raft.tla:346-360): the value of the
    latest ConfigEntry, committed or not; InitServer if none."""
    for k in range(len(slog) - 1, -1, -1):
        if slog[k][1] == CONFIG_ENTRY:
            return slog[k][2]
    return cfg.init_mask


def get_config(sv: State, i: int, cfg: ModelConfig) -> int:
    return get_config_of_log(sv.log[i], cfg)


def max_config_index(slog) -> int:
    """GetMaxConfigIndex (raft.tla:346-351), 1-based; 0 if none."""
    for k in range(len(slog) - 1, -1, -1):
        if slog[k][1] == CONFIG_ENTRY:
            return k + 1
    return 0


def in_quorum(set_mask: int, config_mask: int) -> bool:
    """set ∈ Quorum(config) (raft.tla:217): subset of config + majority."""
    if set_mask & ~config_mask:
        return False
    return 2 * popcount(set_mask) > popcount(config_mask)


def quorums(config_mask: int, n: int) -> List[int]:
    """Literal Quorum(config) enumeration — oracle-only (kernels use the
    popcount test; differential tests tie them together)."""
    members = list(mask_iter(config_mask, n))
    out = []
    for r in range(len(members) + 1):
        for sub in itertools.combinations(members, r):
            m = 0
            for s in sub:
                m |= 1 << s
            if 2 * len(sub) > len(members):
                out.append(m)
    return out


def is_prefix(a, b) -> bool:
    """IsPrefix(a, b) (SequencesExt.tla:134-140)."""
    return len(a) <= len(b) and tuple(b[:len(a)]) == tuple(a)


def committed(sv: State, i: int):
    """Committed(i) == SubSeq(log[i], 1, commitIndex[i]) (raft.tla:969).

    commitIndex can exceed Len(log[i]) after a catchup splice shortens the
    log (HandleCatchupRequest, raft.tla:734-736, leaves commitIndex
    UNCHANGED); TLC would raise an evaluation error there.  We clamp, which
    only matters on states TLC could not check at all."""
    return sv.log[i][:min(sv.ci[i], len(sv.log[i]))]


def bag_add(msgs, m):
    """WithMessage (raft.tla:226): bag count +1."""
    d = dict(msgs)
    d[m] = d.get(m, 0) + 1
    return tuple(sorted(d.items()))


def bag_remove(msgs, m):
    """WithoutMessage (raft.tla:231) via TypedBags (-) (TypedBags.tla:59-69):
    zero-count elements are removed from the domain."""
    d = dict(msgs)
    c = d.get(m, 0)
    if c <= 1:
        d.pop(m, None)
    else:
        d[m] = c - 1
    return tuple(sorted(d.items()))


# ---------------------------------------------------------------------------
# Send / Discard / Reply family (raft.tla:247-328, Direct variants)
# ---------------------------------------------------------------------------

def _send(sv: State, h: Hist, m) -> Tuple[State, Hist]:
    """SendDirect (raft.tla:247-263): Catchup/CheckOldConfig sends also log a
    TryAddServer/TryRemoveServer record and bump hadNumTriedMembershipChanges."""
    glob = h.glob
    ntried = h.ntried
    if m[0] == MT_CATREQ:
        glob = glob + (("TryAddServer", msg_src(m), msg_dst(m)),)
        ntried += 1
    elif m[0] == MT_COC:
        glob = glob + (("TryRemoveServer", msg_src(m), m[3]),)  # m.mserver
        ntried += 1
    glob = glob + (("Send", msg_src(m), m),)
    return sv._replace(msgs=bag_add(sv.msgs, m)), h._replace(glob=glob,
                                                             ntried=ntried)


def _discard(sv: State, h: Hist, m) -> Tuple[State, Hist]:
    """DiscardDirect (raft.tla:280-283)."""
    glob = h.glob + (("Receive", msg_dst(m), m),)
    return sv._replace(msgs=bag_remove(sv.msgs, m)), h._replace(glob=glob)


def _discard_with_mc(sv, h, m, extra) -> Tuple[State, Hist]:
    """DiscardDirectWithMembershipChange (raft.tla:285-290)."""
    glob = h.glob + (("Receive", msg_dst(m), m), extra)
    return (sv._replace(msgs=bag_remove(sv.msgs, m)),
            h._replace(glob=glob, nmc=h.nmc + 1))


def _reply(sv: State, h: Hist, resp, req) -> Tuple[State, Hist]:
    """ReplyDirect (raft.tla:308-314): add response, remove request, log
    Receive-then-Send."""
    msgs = bag_remove(bag_add(sv.msgs, resp), req)
    glob = h.glob + (("Receive", msg_dst(req), req),
                     ("Send", msg_src(resp), resp))
    return sv._replace(msgs=msgs), h._replace(glob=glob)


# ---------------------------------------------------------------------------
# Initial state (raft.tla:367-393)
# ---------------------------------------------------------------------------

def init_state(cfg: ModelConfig) -> Tuple[State, Hist]:
    n = cfg.n_servers
    sv = State(
        ct=(1,) * n,
        st=(FOLLOWER,) * n,
        vf=(NIL,) * n,
        log=((),) * n,
        ci=(0,) * n,
        vr=(0,) * n,
        vg=(0,) * n,
        ni=tuple((1,) * n for _ in range(n)),
        mi=tuple((0,) * n for _ in range(n)),
        msgs=(),
    )
    h = Hist(restarted=(0,) * n, timeout=(0,) * n, nleaders=0, nreq=0,
             ntried=0, nmc=0, glob=())
    return sv, h


# ---------------------------------------------------------------------------
# Top-level actions (SURVEY §2.4)
# ---------------------------------------------------------------------------

def restart(sv, h, i, cfg):
    """Restart(i) (raft.tla:401-411): keeps currentTerm, votedFor, log."""
    n = cfg.n_servers
    sv2 = sv._replace(
        st=tup_set(sv.st, i, FOLLOWER),
        vr=tup_set(sv.vr, i, 0),
        vg=tup_set(sv.vg, i, 0),
        ni=row_set(sv.ni, i, (1,) * n),
        mi=row_set(sv.mi, i, (0,) * n),
        ci=tup_set(sv.ci, i, 0),
    )
    h2 = h._replace(restarted=tup_set(h.restarted, i, h.restarted[i] + 1),
                    glob=h.glob + (("Restart", i),))
    return [(f"Restart({i})", sv2, h2)]


def timeout(sv, h, i, cfg):
    """Timeout(i) (raft.tla:415-427)."""
    if sv.st[i] not in (FOLLOWER, CANDIDATE):
        return []
    if not (get_config(sv, i, cfg) >> i & 1):
        return []
    sv2 = sv._replace(
        st=tup_set(sv.st, i, CANDIDATE),
        ct=tup_set(sv.ct, i, sv.ct[i] + 1),
        vf=tup_set(sv.vf, i, NIL),
        vr=tup_set(sv.vr, i, 0),
        vg=tup_set(sv.vg, i, 0),
    )
    h2 = h._replace(timeout=tup_set(h.timeout, i, h.timeout[i] + 1),
                    glob=h.glob + (("Timeout", i),))
    return [(f"Timeout({i})", sv2, h2)]


def request_vote(sv, h, i, j, cfg):
    """RequestVote(i, j) (raft.tla:431-440); includes the j = i self-send."""
    if sv.st[i] != CANDIDATE:
        return []
    if not ((get_config(sv, i, cfg) & ~sv.vr[i]) >> j & 1):
        return []
    m = (MT_RVREQ, sv.ct[i], last_term(sv.log[i]), len(sv.log[i]), i, j)
    sv2, h2 = _send(sv, h, m)
    return [(f"RequestVote({i},{j})", sv2, h2)]


def append_entries(sv, h, i, j, cfg):
    """AppendEntries(i, j) (raft.tla:446-468): up to one entry."""
    if i == j or sv.st[i] != LEADER:
        return []
    if not (get_config(sv, i, cfg) >> j & 1):
        return []
    nij = sv.ni[i][j]
    prev_idx = nij - 1
    prev_term = (sv.log[i][prev_idx - 1][0]
                 if 0 < prev_idx <= len(sv.log[i]) else 0)
    last_entry = min(len(sv.log[i]), nij)
    entries = sv.log[i][nij - 1:last_entry]          # SubSeq(log, nij, last)
    m = (MT_AEREQ, sv.ct[i], prev_idx, prev_term, entries,
         min(sv.ci[i], last_entry), i, j)
    sv2, h2 = _send(sv, h, m)
    return [(f"AppendEntries({i},{j})", sv2, h2)]


def become_leader(sv, h, i, cfg):
    """BecomeLeader(i) (raft.tla:472-484)."""
    if sv.st[i] != CANDIDATE:
        return []
    if not in_quorum(sv.vg[i], get_config(sv, i, cfg)):
        return []
    n = cfg.n_servers
    leaders = 1 << i
    for k in range(n):
        if sv.st[k] == LEADER:
            leaders |= 1 << k
    sv2 = sv._replace(
        st=tup_set(sv.st, i, LEADER),
        ni=row_set(sv.ni, i, (len(sv.log[i]) + 1,) * n),
        mi=row_set(sv.mi, i, (0,) * n),
    )
    h2 = h._replace(nleaders=h.nleaders + 1,
                    glob=h.glob + (("BecomeLeader", i, leaders),))
    return [(f"BecomeLeader({i})", sv2, h2)]


def client_request(sv, h, i, v, cfg):
    """ClientRequest(i, v) (raft.tla:488-497).  No global history record."""
    if sv.st[i] != LEADER:
        return []
    entry = (sv.ct[i], VALUE_ENTRY, v)
    sv2 = sv._replace(log=row_set(sv.log, i, sv.log[i] + (entry,)))
    h2 = h._replace(nreq=h.nreq + 1)
    return [(f"ClientRequest({i},{v})", sv2, h2)]


def advance_commit_index(sv, h, i, cfg):
    """AdvanceCommitIndex(i) (raft.tla:504-539)."""
    if sv.st[i] != LEADER:
        return []
    config = get_config(sv, i, cfg)
    agree_indexes = []
    for idx in range(1, len(sv.log[i]) + 1):
        agree = 1 << i
        for k in mask_iter(config, cfg.n_servers):
            if sv.mi[i][k] >= idx:
                agree |= 1 << k
        if in_quorum(agree, config):
            agree_indexes.append(idx)
    new_ci = sv.ci[i]
    if agree_indexes and sv.log[i][max(agree_indexes) - 1][0] == sv.ct[i]:
        new_ci = max(agree_indexes)
    did_commit = new_ci > sv.ci[i]
    sv2 = sv._replace(ci=tup_set(sv.ci, i, new_ci))
    h2 = h
    if did_commit:
        entry = sv.log[i][new_ci - 1]
        is_mc = (entry[1] == CONFIG_ENTRY and
                 entry[2] != get_config_of_log(sv.log[i][:new_ci - 1], cfg))
        if is_mc:
            h2 = h._replace(glob=h.glob +
                            (("CommitMembershipChange", i, entry[2]),))
        else:
            h2 = h._replace(glob=h.glob + (("CommitEntry", i, entry),))
    return [(f"AdvanceCommitIndex({i})", sv2, h2)]


def add_new_server(sv, h, i, j, cfg):
    """AddNewServer(i, j) (raft.tla:542-555): resets j's term/votedFor (a
    modeling shortcut — the leader writes another server's state) and sends
    the first CatchupRequest."""
    if sv.st[i] != LEADER:
        return []
    if get_config(sv, i, cfg) >> j & 1:
        return []
    sv1 = sv._replace(ct=tup_set(sv.ct, j, 1), vf=tup_set(sv.vf, j, NIL))
    m = (MT_CATREQ, sv.ct[i], sv.mi[i][j],
         sv.log[i][sv.ni[i][j] - 1:sv.ci[i]],   # SubSeq(log, ni, ci)
         sv.ci[i], i, j, cfg.num_rounds)
    sv2, h2 = _send(sv1, h, m)
    return [(f"AddNewServer({i},{j})", sv2, h2)]


def delete_server(sv, h, i, j, cfg):
    """DeleteServer(i, j) (raft.tla:558-569): self-addressed CheckOldConfig."""
    if sv.st[i] != LEADER or sv.st[j] not in (FOLLOWER, CANDIDATE):
        return []
    if not (get_config(sv, i, cfg) >> j & 1) or j == i:
        return []
    m = (MT_COC, sv.ct[i], 0, j, i, i)
    sv2, h2 = _send(sv, h, m)
    return [(f"DeleteServer({i},{j})", sv2, h2)]


def duplicate_message(sv, h, m, cfg):
    """DuplicateMessage(m) (raft.tla:892-896); count==1 guard lives in
    NextUnreliable (raft.tla:926-928).  No history record."""
    return [(f"Duplicate({m})", sv._replace(msgs=bag_add(sv.msgs, m)), h)]


def drop_message(sv, h, m, cfg):
    """DropMessage(m) (raft.tla:900-904); count==1 guard in NextUnreliable."""
    return [(f"Drop({m})", sv._replace(msgs=bag_remove(sv.msgs, m)), h)]


# ---------------------------------------------------------------------------
# Message handlers (SURVEY §2.5); each returns a list of successors — the
# disjunct structure of ReceiveDirect (raft.tla:842-863) is preserved, so
# overlapping guards yield multiple successors.
# ---------------------------------------------------------------------------

def update_term(sv, h, m, cfg):
    """UpdateTerm (raft.tla:826-832): message is NOT consumed."""
    i = msg_dst(m)
    if msg_term(m) <= sv.ct[i]:
        return []
    sv2 = sv._replace(ct=tup_set(sv.ct, i, msg_term(m)),
                      st=tup_set(sv.st, i, FOLLOWER),
                      vf=tup_set(sv.vf, i, NIL))
    return [(f"UpdateTerm({i})", sv2, h)]


def handle_rv_req(sv, h, m, cfg):
    """HandleRequestVoteRequest (raft.tla:578-597)."""
    i, j = msg_dst(m), msg_src(m)
    mterm, llt, lli = m[1], m[2], m[3]
    if mterm > sv.ct[i]:
        return []
    log_ok = (llt > last_term(sv.log[i]) or
              (llt == last_term(sv.log[i]) and lli >= len(sv.log[i])))
    grant = (mterm == sv.ct[i] and log_ok and sv.vf[i] in (NIL, j))
    sv1 = sv._replace(vf=tup_set(sv.vf, i, j)) if grant else sv
    resp = (MT_RVRESP, sv.ct[i], int(grant), sv.log[i], i, j)
    sv2, h2 = _reply(sv1, h, resp, m)
    return [(f"HandleRVReq({i}<-{j})", sv2, h2)]


def handle_rv_resp(sv, h, m, cfg):
    """DropStaleResponse / HandleRequestVoteResponse (raft.tla:836-839,
    602-614)."""
    i, j = msg_dst(m), msg_src(m)
    mterm, granted = m[1], m[2]
    if mterm < sv.ct[i]:
        sv2, h2 = _discard(sv, h, m)
        return [(f"DropStaleRVResp({i})", sv2, h2)]
    if mterm != sv.ct[i]:
        return []
    sv1 = sv._replace(vr=tup_set(sv.vr, i, sv.vr[i] | 1 << j))
    if granted:
        sv1 = sv1._replace(vg=tup_set(sv1.vg, i, sv1.vg[i] | 1 << j))
    sv2, h2 = _discard(sv1, h, m)
    return [(f"HandleRVResp({i}<-{j})", sv2, h2)]


def handle_ae_req(sv, h, m, cfg):
    """HandleAppendEntriesRequest (raft.tla:690-700) and its branch family
    (raft.tla:617-683).  The three accept sub-cases and the reject/return
    branches are mutually exclusive, but we evaluate each guard separately
    to mirror the disjunction."""
    i, j = msg_dst(m), msg_src(m)
    mterm, prev_idx, prev_term, entries, mcommit = m[1], m[2], m[3], m[4], m[5]
    if mterm > sv.ct[i]:
        return []
    log_ok = (prev_idx == 0 or
              (0 < prev_idx <= len(sv.log[i]) and
               prev_term == sv.log[i][prev_idx - 1][0]))
    out = []
    # RejectAppendEntriesRequest (raft.tla:617-629)
    if (mterm < sv.ct[i] or
            (mterm == sv.ct[i] and sv.st[i] == FOLLOWER and not log_ok)):
        resp = (MT_AERESP, sv.ct[i], 0, 0, i, j)
        sv2, h2 = _reply(sv, h, resp, m)
        out.append((f"RejectAEReq({i})", sv2, h2))
    # ReturnToFollowerState (raft.tla:632-636): message NOT consumed.
    if mterm == sv.ct[i] and sv.st[i] == CANDIDATE:
        sv2 = sv._replace(st=tup_set(sv.st, i, FOLLOWER))
        out.append((f"ReturnToFollower({i})", sv2, h))
    # AcceptAppendEntriesRequest (raft.tla:675-683)
    if mterm == sv.ct[i] and sv.st[i] == FOLLOWER and log_ok:
        index = prev_idx + 1
        # AppendEntriesAlreadyDone (raft.tla:639-655): commitIndex may
        # decrease (comment at raft.tla:644-646).
        if (entries == () or
                (len(sv.log[i]) >= index and
                 sv.log[i][index - 1][0] == entries[0][0])):
            sv1 = sv._replace(ci=tup_set(sv.ci, i, mcommit))
            resp = (MT_AERESP, sv.ct[i], 1, prev_idx + len(entries), i, j)
            sv2, h2 = _reply(sv1, h, resp, m)
            out.append((f"AEAlreadyDone({i})", sv2, h2))
        # ConflictAppendEntriesRequest (raft.tla:658-665): truncate exactly
        # one tail entry; message NOT consumed, no reply.
        if (entries != () and len(sv.log[i]) >= index and
                sv.log[i][index - 1][0] != entries[0][0]):
            sv2 = sv._replace(log=row_set(sv.log, i, sv.log[i][:-1]))
            out.append((f"AEConflict({i})", sv2, h))
        # NoConflictAppendEntriesRequest (raft.tla:668-672): append one
        # entry; message NOT consumed, no reply.
        if entries != () and len(sv.log[i]) == prev_idx:
            sv2 = sv._replace(log=row_set(sv.log, i, sv.log[i] + (entries[0],)))
            out.append((f"AENoConflict({i})", sv2, h))
    return out


def handle_ae_resp(sv, h, m, cfg):
    """DropStaleResponse / HandleAppendEntriesResponse (raft.tla:705-715)."""
    i, j = msg_dst(m), msg_src(m)
    mterm, success, midx = m[1], m[2], m[3]
    if mterm < sv.ct[i]:
        sv2, h2 = _discard(sv, h, m)
        return [(f"DropStaleAEResp({i})", sv2, h2)]
    if mterm != sv.ct[i]:
        return []
    if success:
        sv1 = sv._replace(ni=cell_set(sv.ni, i, j, midx + 1))
        sv1 = sv1._replace(mi=cell_set(sv1.mi, i, j, midx))
    else:
        sv1 = sv._replace(ni=cell_set(sv.ni, i, j, max(sv.ni[i][j] - 1, 1)))
    sv2, h2 = _discard(sv1, h, m)
    return [(f"HandleAEResp({i}<-{j})", sv2, h2)]


def handle_cat_req(sv, h, m, cfg):
    """HandleCatchupRequest (raft.tla:718-745).  NOTE: the success reply's
    mmatchIndex is Len of the *unprimed* (pre-splice) log (raft.tla:740),
    and its mterm is m.mterm (the adopted term)."""
    i, j = msg_dst(m), msg_src(m)
    mterm, mloglen, entries = m[1], m[2], m[3]
    rounds = m[7]
    out = []
    if mterm < sv.ct[i]:
        resp = (MT_CATRESP, sv.ct[i], 0, 0, i, j, 0)
        sv2, h2 = _reply(sv, h, resp, m)
        out.append((f"CatReqStale({i})", sv2, h2))
    if mterm >= sv.ct[i]:
        old_len = len(sv.log[i])
        if sv.log[i] == ():
            new_log = tuple(entries)
        else:
            new_log = sv.log[i][:min(mloglen, old_len)] + tuple(entries)
        sv1 = sv._replace(ct=tup_set(sv.ct, i, mterm),
                          log=row_set(sv.log, i, new_log))
        resp = (MT_CATRESP, mterm, 1, old_len, i, j, rounds - 1)
        sv2, h2 = _reply(sv1, h, resp, m)
        out.append((f"CatReqOk({i})", sv2, h2))
    return out


def handle_cat_resp(sv, h, m, cfg):
    """HandleCatchupResponse (raft.tla:748-792).  The follow-up
    CatchupRequest uses the *unprimed* nextIndex (raft.tla:764-767) and has
    no mcommitIndex field (encoded as -1)."""
    i, j = msg_dst(m), msg_src(m)
    mterm, success, midx, rounds_left = m[1], m[2], m[3], m[6]
    config = get_config(sv, i, cfg)
    out = []
    accept = (success and
              ((midx != sv.ci[i] and midx != sv.mi[i][j]) or
               midx == sv.ci[i]) and
              sv.st[i] == LEADER and mterm == sv.ct[i] and
              not (config >> j & 1))
    if accept:
        old_nij = sv.ni[i][j]
        sv1 = sv._replace(ni=cell_set(sv.ni, i, j, midx + 1))
        sv1 = sv1._replace(mi=cell_set(sv1.mi, i, j, midx))
        if rounds_left != 0:
            req = (MT_CATREQ, sv.ct[i], old_nij - 1,
                   sv.log[i][old_nij - 1:sv.ci[i]], -1, i, j, rounds_left)
            sv2, h2 = _reply(sv1, h, req, m)
            out.append((f"CatRespMore({i})", sv2, h2))
        else:
            req = (MT_COC, sv.ct[i], 1, j, i, i)
            sv2, h2 = _reply(sv1, h, req, m)
            out.append((f"CatRespDone({i})", sv2, h2))
    reject = (not success or
              ((midx == sv.ci[i] or midx == sv.mi[i][j]) and
               midx != sv.ci[i]) or
              sv.st[i] != LEADER or mterm != sv.ct[i] or
              bool(config >> j & 1))
    if reject:
        sv2, h2 = _discard(sv, h, m)
        out.append((f"CatRespReject({i})", sv2, h2))
    return out


def handle_coc(sv, h, m, cfg):
    """HandleCheckOldConfig (raft.tla:795-822).

    Faithful quirk: the discard branch's guard is
    `state[i] /= Leader \\/ m.mterm = currentTerm[i]` (raft.tla:796), so for
    a Leader at the message's term BOTH branches are enabled (discard or
    process), and a stale-term message at a Leader is stuck forever."""
    i = msg_dst(m)
    mterm, madd, mserver = m[1], m[2], m[3]
    out = []
    if sv.st[i] != LEADER or mterm == sv.ct[i]:
        sv2, h2 = _discard(sv, h, m)
        out.append((f"CocDiscard({i})", sv2, h2))
    if sv.st[i] == LEADER and mterm == sv.ct[i]:
        if max_config_index(sv.log[i]) <= sv.ci[i]:
            config = get_config(sv, i, cfg)
            new_config = (config | 1 << mserver) if madd else \
                (config & ~(1 << mserver))
            changed = new_config != config
            if changed:
                entry = (sv.ct[i], CONFIG_ENTRY, new_config)
                sv1 = sv._replace(log=row_set(sv.log, i, sv.log[i] + (entry,)))
                extra = (("AddServer", i, mserver) if madd
                         else ("RemoveServer", i, mserver))
                sv2, h2 = _discard_with_mc(sv1, h, m, extra)
            else:
                sv2, h2 = _discard(sv, h, m)
            out.append((f"CocApply({i})", sv2, h2))
        else:
            # One-at-a-time gate not yet satisfied: re-send to self (retry
            # loop, raft.tla:813-821).
            resend = (MT_COC, sv.ct[i], madd, mserver, i, i)
            sv2, h2 = _reply(sv, h, resend, m)
            out.append((f"CocRetry({i})", sv2, h2))
    return out


_HANDLERS = {
    MT_RVREQ: handle_rv_req,
    MT_RVRESP: handle_rv_resp,
    MT_AEREQ: handle_ae_req,
    MT_AERESP: handle_ae_resp,
    MT_CATREQ: handle_cat_req,
    MT_CATRESP: handle_cat_resp,
    MT_COC: handle_coc,
}


def receive(sv, h, m, cfg):
    """ReceiveDirect (raft.tla:842-863): UpdateTerm ∨ per-type handler."""
    return update_term(sv, h, m, cfg) + _HANDLERS[m[0]](sv, h, m, cfg)


# ---------------------------------------------------------------------------
# Next-relation families (raft.tla:909-943)
# ---------------------------------------------------------------------------

def successors(sv: State, h: Hist, cfg: ModelConfig):
    """All successors of (sv, h) under cfg.next_family, as
    (label, sv', h') triples.  Mirrors the ∃-expansion TLC performs
    (SURVEY §3.1)."""
    n = cfg.n_servers
    fam = cfg.next_family
    out = []
    # NextAsync (raft.tla:909-916)
    for i in range(n):
        for j in range(n):
            out += request_vote(sv, h, i, j, cfg)
    for i in range(n):
        out += become_leader(sv, h, i, cfg)
    for i in range(n):
        for v in cfg.values:
            out += client_request(sv, h, i, v, cfg)
    for i in range(n):
        out += advance_commit_index(sv, h, i, cfg)
    for i in range(n):
        for j in range(n):
            out += append_entries(sv, h, i, j, cfg)
    for m, _cnt in sv.msgs:
        out += receive(sv, h, m, cfg)
    for i in range(n):
        out += timeout(sv, h, i, cfg)
    # NextCrash (raft.tla:918)
    if fam in (NEXT_ASYNC_CRASH, NEXT_FULL, NEXT_DYNAMIC):
        for i in range(n):
            out += restart(sv, h, i, cfg)
    # NextUnreliable (raft.tla:924-932): only single-copy messages.
    if fam in (NEXT_FULL, NEXT_DYNAMIC):
        for m, cnt in sv.msgs:
            if cnt == 1:
                out += duplicate_message(sv, h, m, cfg)
        for m, cnt in sv.msgs:
            if cnt == 1:
                out += drop_message(sv, h, m, cfg)
    # Membership (raft.tla:940-943)
    if fam == NEXT_DYNAMIC:
        for i in range(n):
            for j in range(n):
                out += add_new_server(sv, h, i, j, cfg)
        for i in range(n):
            for j in range(n):
                out += delete_server(sv, h, i, j, cfg)
    return out


# ---------------------------------------------------------------------------
# Symmetry group (raft.tla:1281, raft.cfg:29)
# ---------------------------------------------------------------------------

def symmetry_perms(cfg: ModelConfig) -> List[Tuple[int, ...]]:
    """Permutations of 0..n-1 fixing InitServer setwise (sound subgroup of
    the reference's Permutations(Server); identical when Server=InitServer)."""
    n = cfg.n_servers
    inside = [i for i in range(n) if cfg.init_mask >> i & 1]
    outside = [i for i in range(n) if not (cfg.init_mask >> i & 1)]
    perms = []
    for pi in itertools.permutations(inside):
        for po in itertools.permutations(outside):
            sigma = [0] * n
            for a, b in zip(inside, pi):
                sigma[a] = b
            for a, b in zip(outside, po):
                sigma[a] = b
            perms.append(tuple(sigma))
    return perms
