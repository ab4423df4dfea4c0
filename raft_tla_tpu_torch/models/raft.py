"""The Raft model's state types and initial state, as the checker's
host side needs them.

A trimmed copy of the reference package's plain-Python oracle
(``raft_tla_tpu/models/raft.py``): the ``State``/``Hist`` tuples that
the codec decodes into, the message field table the packed layout is
built from, ``init_state`` (raft.tla:367-393) and the symmetry group.
The oracle's action functions stay in the reference package; the
port's tests compare against them there.

Servers are 0-based ints; Nil is -1; sets of servers are int bitmasks.
A log entry is a tuple ``(term, etype, payload)`` where payload is the
client value for VALUE_ENTRY and a server bitmask for CONFIG_ENTRY.
"""

from __future__ import annotations

import itertools
from collections import namedtuple
from typing import List, Tuple

from ..config import (FOLLOWER, MT_AEREQ, MT_AERESP, MT_CATREQ,
                      MT_CATRESP, MT_COC, MT_RVREQ, MT_RVRESP, NIL,
                      ModelConfig)

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
