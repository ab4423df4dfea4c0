"""Oracle-side explicit-state BFS: the executable semantics of TLC's worker
loop (SURVEY §3.1) in plain Python.

The port's own copy of the reference package's ``models/explore.py``,
behind ``--engine oracle``.  This is deliberately the *simple,
trustworthy* implementation: the engine in engine/ is differentially
tested against it (same distinct-state counts,
same invariant verdicts, same reachable sets on small configs).

TLC semantics replicated here:
  * Fingerprint identity = VIEW = the 10 semantic vars, NOT history
    (raft.cfg:30, SURVEY §2.2); first-seen state keeps its history.
  * SYMMETRY: canonicalization under server permutations (raft.cfg:29).
    When InitServer ⊊ Server we restrict to the subgroup that fixes
    InitServer setwise — Permutations(Server) as the reference declares
    would be unsound there (InitServer is a constant; see SURVEY §2.10).
  * CONSTRAINT: violating states are checked but not expanded.
  * ACTION_CONSTRAINT: violating transitions are not generated.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..config import CONFIG_ENTRY, NIL, ModelConfig
from . import predicates
from .raft import (Hist, State, init_state, successors, symmetry_perms,
                   _SRC_DST, MT_RVRESP, MT_AEREQ, MT_CATREQ, MT_COC)


# ---------------------------------------------------------------------------
# Symmetry canonicalization (raft.tla:1281, raft.cfg:29); the group is
# models/raft.symmetry_perms
# ---------------------------------------------------------------------------

def _perm_mask(mask: int, sigma, n: int) -> int:
    out = 0
    for i in range(n):
        if mask >> i & 1:
            out |= 1 << sigma[i]
    return out


def _perm_entry(e, sigma, n):
    term, etype, payload = e
    if etype == CONFIG_ENTRY:
        payload = _perm_mask(payload, sigma, n)
    return (term, etype, payload)


def _perm_entries(es, sigma, n):
    return tuple(_perm_entry(e, sigma, n) for e in es)


def _perm_msg(m, sigma, n):
    t = m[0]
    m = list(m)
    si, di = _SRC_DST[t]
    m[si] = sigma[m[si]]
    m[di] = sigma[m[di]]
    if t == MT_RVRESP:
        m[3] = _perm_entries(m[3], sigma, n)     # mlog
    elif t in (MT_AEREQ, MT_CATREQ):
        m[3 if t == MT_CATREQ else 4] = _perm_entries(
            m[3 if t == MT_CATREQ else 4], sigma, n)
    elif t == MT_COC:
        m[3] = sigma[m[3]]                        # mserver
    return tuple(m)


def relabel(sv: State, sigma, cfg: ModelConfig) -> State:
    """Apply server relabeling sigma (old id -> new id) to every lane of the
    state, including inside packed messages and set bitmasks (SURVEY §7.4
    hard part 1)."""
    n = cfg.n_servers
    inv = [0] * n
    for i in range(n):
        inv[sigma[i]] = i

    def pt(t):                   # permute a per-server tuple
        return tuple(t[inv[k]] for k in range(n))

    return State(
        ct=pt(sv.ct),
        st=pt(sv.st),
        vf=tuple(NIL if sv.vf[inv[k]] == NIL else sigma[sv.vf[inv[k]]]
                 for k in range(n)),
        log=tuple(_perm_entries(sv.log[inv[k]], sigma, n) for k in range(n)),
        ci=pt(sv.ci),
        vr=tuple(_perm_mask(sv.vr[inv[k]], sigma, n) for k in range(n)),
        vg=tuple(_perm_mask(sv.vg[inv[k]], sigma, n) for k in range(n)),
        ni=tuple(tuple(sv.ni[inv[k]][inv[l]] for l in range(n))
                 for k in range(n)),
        mi=tuple(tuple(sv.mi[inv[k]][inv[l]] for l in range(n))
                 for k in range(n)),
        msgs=tuple(sorted((_perm_msg(m, sigma, n), c) for m, c in sv.msgs)),
    )


def canonicalize(sv: State, perms, cfg: ModelConfig) -> State:
    """Min-over-permutations canonical representative.  States are plain
    nested tuples of ints (the absent-mcommitIndex field is the int -1), so
    the natural tuple order is total."""
    return min(relabel(sv, s, cfg) for s in perms)


# ---------------------------------------------------------------------------
# BFS driver
# ---------------------------------------------------------------------------

@dataclass
class Violation:
    invariant: str
    state: State
    hist: Hist
    trace: Optional[List[str]] = None


@dataclass
class ExploreResult:
    distinct_states: int
    generated_states: int
    depth: int
    violations: List[Violation] = field(default_factory=list)
    level_sizes: List[int] = field(default_factory=list)
    # key -> (State, Hist); only retained if keep_states=True
    states: Optional[Dict] = None
    # distinct pinned-prefix interior states invariant-checked but not
    # counted (TLC counts them; engine/bfs.CheckResult twin field)
    pin_interior_states: int = 0


def explore(cfg: ModelConfig, max_depth: int = 10 ** 9,
            max_states: int = 10 ** 9, keep_states: bool = False,
            stop_on_violation: bool = False,
            trace_violations: bool = False,
            seed_states=None) -> ExploreResult:
    """Level-synchronous BFS from Init (SURVEY §3.1), or from
    ``seed_states`` [(sv, h), ...] for punctuated search (the pinned-
    prefix technique of raft.tla:1198-1234 as replay-then-explore)."""
    perms = symmetry_perms(cfg) if cfg.symmetry else None
    inv_fns = [(nm, predicates.resolve_invariant(nm, cfg))
               for nm in cfg.invariants]
    con_fns = [predicates.CONSTRAINTS[nm] for nm in cfg.constraints]
    act_fns = [predicates.ACTION_CONSTRAINTS[nm]
               for nm in cfg.action_constraints]

    def key_of(sv: State):
        if perms:
            sv = canonicalize(sv, perms, cfg)
        return sv

    pin_interiors = None
    if seed_states is None and cfg.prefix_pins:
        # cfg-declared punctuated-search pins compile to seeds
        # (raft.tla:1198-1234; models/golden docstring)
        from .golden import prefix_pin_seeds
        seed_states, pin_interiors = prefix_pin_seeds(
            cfg, with_interior=True)
    roots = (seed_states if seed_states is not None
             else [init_state(cfg)])
    seen: Dict = {}
    parent: Dict = {}
    result = ExploreResult(distinct_states=0, generated_states=0, depth=0)
    if pin_interiors:
        # TLC counts + checks the prefix interior states; seeding at
        # the witness end skips them — invariant-check them here and
        # record the count divergence bound (models/golden docstring)
        int_seen = set()
        for sv, h in pin_interiors:
            k = key_of(sv)
            if k in int_seen:
                continue
            int_seen.add(k)
            result.pin_interior_states += 1
            for nm, fn in inv_fns:
                if not fn(sv, h, cfg):
                    result.violations.append(Violation(nm, sv, h))

    def check(sv, h, k):
        for nm, fn in inv_fns:
            if not fn(sv, h, cfg):
                v = Violation(nm, sv, h)
                if trace_violations:
                    v.trace = _trace_to(k, parent)
                result.violations.append(v)
                if stop_on_violation:
                    return False
        return True

    frontier = []
    for sv0, h0 in roots:
        k0 = key_of(sv0)
        if k0 in seen:
            continue
        seen[k0] = (sv0, h0)
        parent[k0] = (None, None)
        result.generated_states += 1
        if not check(sv0, h0, k0) and stop_on_violation:
            result.distinct_states = len(seen)
            result.states = seen if keep_states else None
            return result
        if all(f(sv0, h0, cfg) for f in con_fns):
            frontier.append((sv0, h0, k0))
    if stop_on_violation and result.violations:
        # a pinned-prefix interior state violated: stop after the root
        # level, exactly like the engines (engine/bfs.check)
        result.distinct_states = len(seen)
        result.states = seen if keep_states else None
        return result
    depth = 0
    while frontier and depth < max_depth and len(seen) < max_states:
        depth += 1
        nxt = []
        for sv, h, k in frontier:
            for label, sv2, h2 in successors(sv, h, cfg):
                if act_fns and not all(f(sv, h, sv2, h2, cfg)
                                       for f in act_fns):
                    continue
                result.generated_states += 1
                k2 = key_of(sv2)
                if k2 in seen:
                    continue
                seen[k2] = (sv2, h2)
                parent[k2] = (k, label)
                if not check(sv2, h2, k2) and stop_on_violation:
                    result.distinct_states = len(seen)
                    result.depth = depth
                    result.states = seen if keep_states else None
                    return result
                if all(f(sv2, h2, cfg) for f in con_fns):
                    nxt.append((sv2, h2, k2))
        result.level_sizes.append(len(nxt))
        frontier = nxt
    result.distinct_states = len(seen)
    result.depth = depth
    result.states = seen if keep_states else None
    return result


# ---------------------------------------------------------------------------
# Random-walk twin (TLC -simulate; oracle of sim/walker.SimEngine)
# ---------------------------------------------------------------------------

@dataclass
class WalkResult:
    steps: int                    # transitions actually taken
    restarts: int
    deadlocks: int
    sampled: int = 0              # successors drawn (incl. pruned
                                  # redraws — the engine's sampled_steps)
    hits: List[Violation] = field(default_factory=list)
    # labels of the walk that hit (root -> witness end), if any
    hit_trace: Optional[List[str]] = None
    hit_state: Optional[State] = None
    hit_hist: Optional[Hist] = None
    distinct_states: int = 0      # exact (set-based) distinct visited


def random_walk(cfg: ModelConfig, steps: int, max_depth: int = 64,
                seed: int = 0, stop_on_hit: bool = True,
                resample_pruned: bool = False) -> WalkResult:
    """Plain-Python uniform random walk — the executable oracle of the
    sim engine (the reference's sim/walker.py) and of TLC's
    ``-simulate`` mode:

      * uniform choice over the enabled successor transitions of the
        current state (the same surface the engine's enabled-lane
        sampling draws from — tests/test_sim.py pins the per-step
        enabled COUNTS against the engine's lane grid);
      * CONSTRAINT semantics prune-not-reject: a violating successor is
        invariant-checked but never extended — the walk restarts from
        the root (``resample_pruned=False``, TLC parity) or redraws
        uniformly among the remaining enabled successors
        (``resample_pruned=True``, the engine's 'punctuated' prune
        handling: rejection sampling = uniform over the extendable
        subset);
      * bounded-depth restart at ``max_depth``; deadlock restarts.

    The RNG streams are NOT shared with the engine (python Random vs
    the engine's streams) — differential tests replay the ENGINE's recorded
    choices through the oracle transition relation instead
    (oracle_validates_walk)."""
    import random as _random
    rng = _random.Random(seed)
    inv_fns = [(nm, predicates.resolve_invariant(nm, cfg))
               for nm in cfg.invariants]
    con_fns = [predicates.CONSTRAINTS[nm] for nm in cfg.constraints]
    root = init_state(cfg)
    sv, h = root
    depth = 0
    labels: List[str] = []
    res = WalkResult(steps=0, restarts=0, deadlocks=0)
    seen = {_walk_key(root[0])}
    # depth-0 check: the engine checks the root once up front too
    for nm, fn in inv_fns:
        if not fn(root[0], root[1], cfg):
            res.hits.append(Violation(nm, root[0], root[1]))
            if res.hit_trace is None:
                res.hit_trace = []
                res.hit_state, res.hit_hist = root
    if res.hits and stop_on_hit:
        return _walk_finish(res, seen)
    for _ in range(steps):
        succ = walk_enabled(sv, h, cfg)      # the ONE sampling surface
        if not succ:
            res.deadlocks += 1
            res.restarts += 1
            sv, h = root
            depth = 0
            labels = []
            continue
        remaining = list(succ)

        def check(sv2, h2):
            ok = True
            for nm, fn in inv_fns:
                if not fn(sv2, h2, cfg):
                    res.hits.append(Violation(nm, sv2, h2))
                    if res.hit_trace is None:
                        res.hit_trace = list(labels)
                        res.hit_state, res.hit_hist = sv2, h2
                    ok = False
            return ok

        pruned_out = False
        while True:
            k = rng.randrange(len(remaining))
            label, sv2, h2 = remaining.pop(k)
            res.sampled += 1
            seen.add(_walk_key(sv2))
            labels.append(label)
            hit = not check(sv2, h2)
            if hit and stop_on_hit:
                return _walk_finish(res, seen)
            if all(f(sv2, h2, cfg) for f in con_fns):
                res.steps += 1           # accepted transition
                break
            labels.pop()
            if not resample_pruned or not remaining:
                pruned_out = True
                break
        depth += 1
        if pruned_out or depth >= max_depth:
            res.restarts += 1
            sv, h = root
            depth = 0
            labels = []
        else:
            sv, h = sv2, h2
    return _walk_finish(res, seen)


def _walk_finish(res: "WalkResult", seen) -> "WalkResult":
    res.distinct_states = len(seen)
    return res


def _walk_key(sv: State):
    return sv._replace(msgs=tuple(sorted(sv.msgs)))


def walk_enabled(sv: State, h: Hist, cfg: ModelConfig):
    """The enabled successor transitions the walk samples from (action
    constraints applied — the sampling surface)."""
    succ = successors(sv, h, cfg)
    act_fns = [predicates.ACTION_CONSTRAINTS[nm]
               for nm in cfg.action_constraints]
    if act_fns:
        succ = [(lb, s2, h2) for (lb, s2, h2) in succ
                if all(f(sv, h, s2, h2, cfg) for f in act_fns)]
    return succ


def oracle_validates_walk(cfg: ModelConfig, states: List[State]
                          ) -> List[str]:
    """Replay an engine-decoded state chain through the oracle
    transition relation: every consecutive pair must be one oracle
    transition (state equality modulo message-bag order — slot order is
    not part of state identity, ops/layout.py).  Returns the oracle's
    labels for the walk; raises ValueError at the first step the oracle
    cannot take.  This is the 'oracle replays it as a valid behavior'
    check the sim witness traces are accepted under."""
    sv, h = init_state(cfg)
    if _walk_key(states[0]) != _walk_key(sv):
        raise ValueError("walk does not start at Init")
    out: List[str] = []
    for t, nxt in enumerate(states[1:]):
        want = _walk_key(nxt)
        matches = [(lb, s2, h2) for (lb, s2, h2) in successors(sv, h, cfg)
                   if _walk_key(s2) == want]
        if not matches:
            raise ValueError(
                f"step {t + 1}: engine state is not an oracle successor")
        lb, sv, h = matches[0]
        out.append(lb)
    return out


def _trace_to(k, parent) -> List[str]:
    out = []
    while True:
        pk, label = parent[k]
        if pk is None:
            break
        out.append(label)
        k = pk
    return list(reversed(out))
