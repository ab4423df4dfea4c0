"""Plain-Python executable reference model of bounded Paxos (the oracle).

Deliberately literal transcription of the single-decree Paxos action
system (Lamport's ``Paxos.tla`` shape, bounded for model checking),
extended to ``n_instances`` fully independent consensus slots.  The
vectorized kernels in ``kernels.py`` are differentially tested against
THIS module: same successor sets, same distinct-state counts, same
invariant verdicts — the same oracle role ``models/raft.py`` plays for
the Raft frontend.

State:
  * ``mb[i][a]``  maxBal   — highest ballot acceptor ``a`` promised in
                  instance ``i`` (-1 = none)
  * ``vb[i][a]``  maxVBal  — highest ballot ``a`` accepted in (-1)
  * ``vv[i][a]``  maxVal   — the value accepted at ``vb`` (-1)
  * ``msgs``      a monotone SET of messages (sorted tuple — Paxos
                  messages are never consumed, so no bag counts exist)

Messages (tuples; acceptors/ballots/values are small ints):
  ("1a", b, i)                   Phase1a — a proposer starts ballot b
  ("1b", a, b, mbal, mval, i)    Phase1b — promise, reporting (vb, vv)
  ("2a", b, v, i)                Phase2a — proposal of v at ballot b
  ("2b", a, b, v, i)             Phase2b — acceptance

Actions (one vmapped family each, kernels.py):
  * Phase1a(i, b): send 1a(b, i).  Guarded by novelty (the message is
    not already in the set) — a re-send is the identity transition, so
    the reachable graph is unchanged and the trivial self-loop lanes
    are dropped.  A Phase1a at a ballot above every current promise IS
    leader preemption (arXiv:1905.10786's mapping of Raft's
    Timeout/term bump).
  * Phase1b(i, a, b): 1a(b, i) ∈ msgs ∧ b > mb[i][a] → promise: set
    mb, send 1b carrying the accepted pair.
  * Phase2a(i, b, v): no 2a at (b, i) yet ∧ ∃ quorum Q whose 1b(b)
    messages are all present and pick v (the value of a maximal-mbal
    report, free choice when all report -1).  Quantification is over
    MESSAGES, exactly as in the spec — the kernels implement the same
    union-over-Q form.
  * Phase2b(i, a, b, v): 2a(b, v, i) ∈ msgs ∧ b >= mb[i][a] → accept:
    set mb = vb = b, vv = v, send 2b.

History: ``glob`` records one label per action (drives the shared
``ctr[C_GLOBLEN]`` lane); nothing else — no Paxos predicate scans
history records, so engine-emitted seeds are always oracle-evaluable.
"""

from __future__ import annotations

from collections import namedtuple
from typing import List, Tuple

PaxosState = namedtuple("PaxosState", ["mb", "vb", "vv", "msgs"])
PaxosHist = namedtuple("PaxosHist", ["glob"])

NIL = -1


# ---------------------------------------------------------------------------
# Init / helpers
# ---------------------------------------------------------------------------

def init_state(cfg) -> Tuple[PaxosState, PaxosHist]:
    I, N = cfg.n_instances, cfg.n_servers
    row = ((NIL,) * N,) * I
    return PaxosState(mb=row, vb=row, vv=row, msgs=()), PaxosHist(glob=())


def _cell(mat, i, a, v):
    row = mat[i][:a] + (v,) + mat[i][a + 1:]
    return mat[:i] + (row,) + mat[i + 1:]


def _send(sv: PaxosState, m) -> PaxosState:
    """Monotone set add (sorted tuple keeps the representation
    canonical — message order is not part of state identity)."""
    if m in sv.msgs:
        return sv
    return sv._replace(msgs=tuple(sorted(sv.msgs + (m,))))


def _bump(h: PaxosHist, label: str) -> PaxosHist:
    return PaxosHist(glob=h.glob + (label,))


# ---------------------------------------------------------------------------
# Actions
# ---------------------------------------------------------------------------

def phase1a(sv, h, i, b, cfg):
    m = ("1a", b, i)
    if m in sv.msgs:
        return []
    lbl = f"Phase1a({i},{b})"
    return [(lbl, _send(sv, m), _bump(h, lbl))]


def phase1b(sv, h, i, a, b, cfg):
    if ("1a", b, i) not in sv.msgs or b <= sv.mb[i][a]:
        return []
    sv2 = sv._replace(mb=_cell(sv.mb, i, a, b))
    sv2 = _send(sv2, ("1b", a, b, sv.vb[i][a], sv.vv[i][a], i))
    lbl = f"Phase1b({i},{a},{b})"
    return [(lbl, sv2, _bump(h, lbl))]


def _p2a_value_ok(sv, i, b, v, cfg) -> bool:
    """The Phase2a value rule, quantified over messages exactly as the
    spec writes it: ∃Q ∈ Quorum such that every a ∈ Q has a 1b at
    (b, i) in msgs, and either no report in Q carries an accepted pair
    (free choice) or v is the value of a maximal-mbal report in Q."""
    onebs = {}
    for m in sv.msgs:
        if m[0] == "1b" and m[2] == b and m[5] == i:
            onebs.setdefault(m[1], []).append((m[3], m[4]))
    for Q in cfg.quorums:
        if not all(a in onebs for a in Q):
            continue
        reports = [r for a in Q for r in onebs[a]]
        voted = [r for r in reports if r[0] >= 0]
        if not voted:
            return True
        mx = max(r[0] for r in voted)
        if any(r == (mx, v) for r in voted):
            return True
    return False


def phase2a(sv, h, i, b, v, cfg):
    if any(m[0] == "2a" and m[1] == b and m[3] == i for m in sv.msgs):
        return []
    if not _p2a_value_ok(sv, i, b, v, cfg):
        return []
    lbl = f"Phase2a({i},{b},{v})"
    return [(lbl, _send(sv, ("2a", b, v, i)), _bump(h, lbl))]


def phase2b(sv, h, i, a, b, v, cfg):
    if ("2a", b, v, i) not in sv.msgs or b < sv.mb[i][a]:
        return []
    sv2 = sv._replace(mb=_cell(sv.mb, i, a, b))
    sv2 = sv2._replace(vb=_cell(sv2.vb, i, a, b),
                       vv=_cell(sv2.vv, i, a, v))
    sv2 = _send(sv2, ("2b", a, b, v, i))
    lbl = f"Phase2b({i},{a},{b},{v})"
    return [(lbl, sv2, _bump(h, lbl))]


def successors(sv: PaxosState, h: PaxosHist, cfg):
    """All successors in the kernels' lane-grid enumeration order
    (family-major; instance-major inside each family) so candidate
    streams are comparable, like models/raft.successors."""
    I, N, B, V = (cfg.n_instances, cfg.n_servers, cfg.n_ballots,
                  cfg.n_values)
    out = []
    for i in range(I):
        for b in range(B):
            out += phase1a(sv, h, i, b, cfg)
    for i in range(I):
        for a in range(N):
            for b in range(B):
                out += phase1b(sv, h, i, a, b, cfg)
    for i in range(I):
        for b in range(B):
            for v in range(V):
                out += phase2a(sv, h, i, b, v, cfg)
    for i in range(I):
        for a in range(N):
            for b in range(B):
                for v in range(V):
                    out += phase2b(sv, h, i, a, b, v, cfg)
    return out


# ---------------------------------------------------------------------------
# Symmetry: acceptors are interchangeable (ballots and values are not)
# ---------------------------------------------------------------------------

def symmetry_perms(cfg) -> List[Tuple[int, ...]]:
    import itertools
    return [tuple(p) for p in
            itertools.permutations(range(cfg.n_servers))]


def _perm_msg(m, sigma):
    if m[0] == "1b":
        return (m[0], sigma[m[1]]) + m[2:]
    if m[0] == "2b":
        return (m[0], sigma[m[1]]) + m[2:]
    return m


def relabel(sv: PaxosState, sigma, cfg) -> PaxosState:
    """Acceptor relabeling (old id -> new id) across the per-acceptor
    columns and the acc field of 1b/2b messages."""
    n = cfg.n_servers
    inv = [0] * n
    for i in range(n):
        inv[sigma[i]] = i

    def pr(mat):
        return tuple(tuple(row[inv[k]] for k in range(n)) for row in mat)

    return PaxosState(
        mb=pr(sv.mb), vb=pr(sv.vb), vv=pr(sv.vv),
        msgs=tuple(sorted(_perm_msg(m, sigma) for m in sv.msgs)))


def canonicalize(sv: PaxosState, perms, cfg) -> PaxosState:
    return min(relabel(sv, s, cfg) for s in perms)


def walk_key(sv: PaxosState):
    """State-identity key (msgs is kept sorted, so the tuple itself is
    canonical) — the paxos twin of models/explore._walk_key."""
    return sv


# ---------------------------------------------------------------------------
# Oracle predicates ((sv, h, cfg) -> holds, mirroring models/predicates)
# ---------------------------------------------------------------------------

def chosen_values(sv: PaxosState, i: int, cfg) -> set:
    """{v : ∃b ∃Q ∈ Quorum: ∀a ∈ Q: 2b(a, b, v, i) ∈ msgs}.  Quorums
    are exactly the majorities, so existence = a counting test."""
    n = cfg.n_servers
    out = set()
    for b in range(cfg.n_ballots):
        for v in range(cfg.n_values):
            cnt = sum(1 for a in range(n)
                      if ("2b", a, b, v, i) in sv.msgs)
            if 2 * cnt > n:
                out.add(v)
    return out


def agreement(sv, h, cfg) -> bool:
    """At most one value is ever chosen per instance — THE safety
    property of consensus."""
    return all(len(chosen_values(sv, i, cfg)) <= 1
               for i in range(cfg.n_instances))


def validity(sv, h, cfg) -> bool:
    """Acceptances trace to proposals: every 2b has its 2a, and every
    1b reporting an accepted pair (mbal >= 0) has the 2a it accepted.
    (Vacuous by construction — its violation would be a kernel bug,
    which is exactly why it runs in every differential.)"""
    for m in sv.msgs:
        if m[0] == "2b" and ("2a", m[2], m[3], m[4]) not in sv.msgs:
            return False
        if m[0] == "1b":
            mbal, mval = m[3], m[4]
            if (mbal >= 0) != (mval >= 0):
                return False
            if mbal >= 0 and ("2a", mbal, mval, m[5]) not in sv.msgs:
                return False
    return True


def one_value_per_ballot(sv, h, cfg) -> bool:
    """A ballot proposes at most one value per instance (the Phase2a
    novelty guard's invariant form)."""
    for i in range(cfg.n_instances):
        for b in range(cfg.n_ballots):
            vs = {m[2] for m in sv.msgs
                  if m[0] == "2a" and m[1] == b and m[3] == i}
            if len(vs) > 1:
                return False
    return True


# Scenario ("test case") properties — negated reachability, like the
# raft Test-cases block: a "violation" is a wanted witness.

def value_chosen(sv, h, cfg) -> bool:
    return all(not chosen_values(sv, i, cfg)
               for i in range(cfg.n_instances))


def two_ballots(sv, h, cfg) -> bool:
    """Holds until two distinct ballots have been started (a competing-
    proposers witness)."""
    bals = {m[1] for m in sv.msgs if m[0] == "1a"}
    return len(bals) < 2


def preempted(sv, h, cfg) -> bool:
    """Holds until some acceptor that accepted a value has promised a
    strictly higher ballot — the leader-preemption witness
    (arXiv:1905.10786: the Paxos analogue of a Raft term bump over a
    live leader)."""
    for i in range(cfg.n_instances):
        for a in range(cfg.n_servers):
            if sv.vb[i][a] >= 0 and sv.mb[i][a] > sv.vb[i][a]:
                return False
    return True


INVARIANTS = {
    "Agreement": agreement,
    "Validity": validity,
    "OneValuePerBallot": one_value_per_ballot,
    "ValueChosen": value_chosen,
    "TwoBallots": two_ballots,
    "Preempted": preempted,
}

CONSTRAINTS = {}            # the space is finite without any
ACTION_CONSTRAINTS = {}
GLOB_DEPENDENT = frozenset()    # no predicate scans history records

SCENARIO_PROPERTIES = ("ValueChosen", "TwoBallots", "Preempted")


# ---------------------------------------------------------------------------
# JSON-able (de)serialization — the seed-trace file format
# ---------------------------------------------------------------------------

def state_to_obj(sv: PaxosState, h: PaxosHist) -> dict:
    return {"paxos": True,
            "state": [[list(r) for r in sv.mb],
                      [list(r) for r in sv.vb],
                      [list(r) for r in sv.vv],
                      [list(m) for m in sv.msgs]],
            "hist": [list(h.glob)]}


def state_from_obj(obj: dict) -> Tuple[PaxosState, PaxosHist]:
    mb, vb, vv, msgs = obj["state"]
    sv = PaxosState(
        mb=tuple(tuple(r) for r in mb),
        vb=tuple(tuple(r) for r in vb),
        vv=tuple(tuple(r) for r in vv),
        msgs=tuple(sorted(tuple(m) for m in msgs)))
    return sv, PaxosHist(glob=tuple(obj["hist"][0]))
