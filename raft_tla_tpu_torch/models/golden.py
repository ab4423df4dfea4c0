"""The reference's embedded punctuated-search witness traces.

The port's own copy of the reference package's ``models/golden.py``.

`tlc_membership/raft.tla` pins deep scenario hunts to two hard-coded
history prefixes (SURVEY §2.9 "punctuated search"; Michaels et al,
Eurosys 2019):

  * a 20-record ConcurrentLeaders witness inside
    ``CommitWhenConcurrentLeaders_unique``       (raft.tla:1198-1204)
  * a 28-record CommitWhenConcurrentLeaders witness inside
    ``MajorityOfClusterRestarts_constraint``     (raft.tla:1228-1234)

Both constraints are ``∃ s1,s2,s3 distinct: IsPrefix(witness(s1,s2,s3),
history.global)`` — exploration is pinned to the witness for its length
and free afterwards.  Here the witnesses are expressed as oracle
successor-label sequences (the reference's s1,s2,s3 → ids 0,1,2); one
top-level step can emit 0, 1 or 2 history records (``UpdateTerm``
consumes nothing and logs nothing, raft.tla:826-832; a Reply logs
Receive + Send, raft.tla:308-314), so 18 labels produce the 20-record
trace and 9 more labels produce records 21-28.

``prefix_pin_seeds`` compiles a cfg's pins into BFS seed states: replay
the witness to its end state and seed the search there.  With SYMMETRY
on (the reference cfg always is) one assignment suffices — the pinned
reachable set is closed under relabeling, so the canonical exploration
from one assignment covers the ∃; without symmetry the seed set is the
witness end state under every injective (s1,s2,s3) assignment.
Divergence from TLC, documented: TLC also counts/checks the prefix
*interior* states (≤ the witness length); seeding at the end skips
those, but every extension state — the point of the technique — is
explored identically (tests/test_golden.py pins the witness hunts).
"""

from __future__ import annotations

import itertools
import re
from typing import List, Tuple

from ..config import ModelConfig
from .raft import init_state, successors

# --- records 1-20: two elections ending with concurrent leaders --------
# r2/r3: s1 sends RVReq to s2 first, then to itself (golden record order).
# r8/r9 and r18/r19: the remote vote response is received before the
# self-response.
CONCURRENT_LEADERS_LABELS = [
    "Timeout(0)",           # r1
    "RequestVote(0,1)",     # r2   Send RVReq 0->1
    "RequestVote(0,0)",     # r3   Send RVReq 0->0
    "HandleRVReq(0<-0)",    # r4,r5   Receive + Send RVResp (self grant)
    "UpdateTerm(1)",        # (no record; non-consuming, raft.tla:831)
    "HandleRVReq(1<-0)",    # r6,r7
    "HandleRVResp(0<-1)",   # r8
    "HandleRVResp(0<-0)",   # r9
    "BecomeLeader(0)",      # r10  leaders={0}
    "Timeout(1)",           # r11
    "RequestVote(1,1)",     # r12  Send RVReq 1->1 (self first, golden)
    "RequestVote(1,2)",     # r13
    "HandleRVReq(1<-1)",    # r14,r15
    "UpdateTerm(2)",        # (no record)
    "HandleRVReq(2<-1)",    # r16,r17
    "HandleRVResp(1<-2)",   # r18
    "HandleRVResp(1<-1)",   # r19
    "BecomeLeader(1)",      # r20  leaders={0,1}
]

# --- records 21-28: both leaders replicate; commit under 2 leaders -----
# ClientRequest bumps hadNumClientRequests but logs no record
# (raft.tla:488-497); AENoConflict appends without reply or record
# (raft.tla:668-672) — the success reply comes from the *second* receive
# of the same request (AlreadyDone, raft.tla:639-655).
CWCL_EXTENSION_LABELS = [
    "ClientRequest(0,1)",       # log[0] = [(2, Value, 1)]
    "AppendEntries(0,1)",       # r21  Send AEReq 0->1 (entry term 2)
    "ClientRequest(1,2)",       # log[1] = [(3, Value, 2)]
    "AppendEntries(1,2)",       # r22  Send AEReq 1->2 (entry term 3)
    "AENoConflict(2)",          # (no record) s2 appends the entry
    "AEAlreadyDone(2)",         # r23,r24  Receive + Send success reply
    "HandleAEResp(1<-2)",       # r25  matchIndex[1][2] := 1
    "AdvanceCommitIndex(1)",    # r26  CommitEntry (term 3, value 2)
    "RejectAEReq(1)",           # r27,r28  stale-term AEReq from s1
]

GOLDEN_20_KINDS = [
    "Timeout", "Send", "Send", "Receive", "Send", "Receive", "Send",
    "Receive", "Receive", "BecomeLeader",
    "Timeout", "Send", "Send", "Receive", "Send", "Receive", "Send",
    "Receive", "Receive", "BecomeLeader",
]

GOLDEN_28_KINDS = GOLDEN_20_KINDS + [
    "Send", "Send", "Receive", "Send", "Receive", "CommitEntry",
    "Receive", "Send",
]

# the two cfg-visible pin names (tlc_membership/raft.cfg:53-55)
PIN_LABELS = {
    "CommitWhenConcurrentLeaders_unique": CONCURRENT_LEADERS_LABELS,
    "MajorityOfClusterRestarts_constraint":
        CONCURRENT_LEADERS_LABELS + CWCL_EXTENSION_LABELS,
}

# which "(...)" argument positions of a golden label are server ids
# (ClientRequest's second argument is a client VALUE, raft.tla:488)
_SERVER_ARGS = {
    "Timeout": (0,), "RequestVote": (0, 1), "HandleRVReq": (0, 1),
    "UpdateTerm": (0,), "HandleRVResp": (0, 1), "BecomeLeader": (0,),
    "ClientRequest": (0,), "AppendEntries": (0, 1), "AENoConflict": (0,),
    "AEAlreadyDone": (0,), "HandleAEResp": (0, 1),
    "AdvanceCommitIndex": (0,), "RejectAEReq": (0,),
}

_LBL_RE = re.compile(r"^(\w+)\((.*)\)$")


def relabel_label(label: str, assign) -> str:
    """Map the server ids inside a golden label through ``assign``
    (0,1,2 -> the chosen s1,s2,s3)."""
    m = _LBL_RE.match(label)
    name, args = m.group(1), m.group(2)
    sep = "<-" if "<-" in args else ","
    parts = args.split(sep)
    roles = _SERVER_ARGS[name]
    parts = [str(assign[int(p)]) if k in roles else p
             for k, p in enumerate(parts)]
    return f"{name}({sep.join(parts)})"


def apply_label(sv, h, cfg: ModelConfig, label: str):
    matches = [(s2, h2) for lbl, s2, h2 in successors(sv, h, cfg)
               if lbl == label]
    if not matches:
        raise ValueError(f"no successor labelled {label!r}")
    if len(matches) > 1:
        raise ValueError(f"ambiguous label {label!r}")
    return matches[0]


def replay(labels: List[str], cfg: ModelConfig, start=None):
    """Replay a label sequence from Init (or ``start``); returns every
    intermediate (State, Hist) including the start."""
    sv, h = start if start is not None else init_state(cfg)
    states = [(sv, h)]
    for lbl in labels:
        sv, h = apply_label(sv, h, cfg, lbl)
        states.append((sv, h))
    return states


def prefix_pin_seeds(cfg: ModelConfig, with_interior: bool = False):
    """cfg.prefix_pins -> BFS seed states (oracle (State, Hist) pairs),
    or None when the cfg has no pins.  Multiple pins resolve to the
    longest witness (the 28-record trace extends the 20-record one, so
    the conjunction of both constraints IS the longer prefix).

    with_interior=True additionally returns the replayed prefix
    *interior* states (everything before each witness end, including
    Init) so callers can invariant-check them and report the
    distinct-state divergence from TLC — TLC counts and checks those
    states; seeding at the end skips them (module docstring)."""
    if not cfg.prefix_pins:
        return (None, None) if with_interior else None
    for nm in cfg.prefix_pins:
        if nm not in PIN_LABELS:
            raise KeyError(f"unknown prefix pin {nm!r}")
    labels = max((PIN_LABELS[nm] for nm in cfg.prefix_pins), key=len)
    if cfg.n_servers < 3:
        raise ValueError(
            "the punctuated-search witnesses quantify over 3 distinct "
            f"servers (raft.tla:1199); Server has {cfg.n_servers}")
    if cfg.symmetry:
        assigns = [(0, 1, 2)]
    else:
        assigns = list(itertools.permutations(range(cfg.n_servers), 3))
    seeds = []
    interiors = []
    for a in assigns:
        states = replay([relabel_label(l, a) for l in labels], cfg)
        seeds.append(states[-1])
        interiors.extend(states[:-1])
    return (seeds, interiors) if with_interior else seeds
