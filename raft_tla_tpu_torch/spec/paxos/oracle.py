"""Oracle-side explicit-state BFS for Paxos — the differential anchor
(the reference package's ``spec/paxos/oracle.py``).

The same deliberately simple, trustworthy shape as models/explore.py
(TLC worker-loop semantics: VIEW identity, symmetry canonicalization,
CONSTRAINT = prune-not-expand), parameterized by the paxos model.  It
reuses models/explore's ``ExploreResult``/``Violation`` result types so
the CLI's oracle engine path is spec-blind.
"""

from __future__ import annotations

from typing import Dict, List

from ...models.explore import ExploreResult, Violation
from .model import (INVARIANTS, canonicalize, init_state, successors,
                    symmetry_perms, walk_key)


def explore(cfg, max_depth: int = 10 ** 9, max_states: int = 10 ** 9,
            keep_states: bool = False, stop_on_violation: bool = False,
            trace_violations: bool = False,
            seed_states=None) -> ExploreResult:
    """Level-synchronous BFS from Init (or ``seed_states``).  Paxos has
    no constraints / action constraints / prefix pins, so the loop is
    the models/explore core minus those arms; invariant names resolve
    from model.INVARIANTS (unknown names fail loudly, naming the
    spec)."""
    perms = symmetry_perms(cfg) if cfg.symmetry else None
    try:
        inv_fns = [(nm, INVARIANTS[nm]) for nm in cfg.invariants]
    except KeyError as e:
        raise KeyError(
            f"unknown invariant {e.args[0]!r} for spec 'paxos'; "
            f"known: {', '.join(sorted(INVARIANTS))}") from None
    if cfg.constraints or cfg.action_constraints:
        raise KeyError(
            "spec 'paxos' declares no constraints / action "
            "constraints; remove them from the config")

    def key_of(sv):
        return canonicalize(sv, perms, cfg) if perms else walk_key(sv)

    roots = (seed_states if seed_states is not None
             else [init_state(cfg)])
    seen: Dict = {}
    parent: Dict = {}
    result = ExploreResult(distinct_states=0, generated_states=0,
                           depth=0)

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
        frontier.append((sv0, h0, k0))
    depth = 0
    while frontier and depth < max_depth and len(seen) < max_states:
        depth += 1
        nxt = []
        for sv, h, k in frontier:
            for label, sv2, h2 in successors(sv, h, cfg):
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
                nxt.append((sv2, h2, k2))
        result.level_sizes.append(len(nxt))
        frontier = nxt
    result.distinct_states = len(seen)
    result.depth = depth
    result.states = seen if keep_states else None
    return result


def oracle_validates_walk(cfg, states: List) -> List[str]:
    """Replay an engine-decoded state chain through the oracle
    transition relation (the paxos twin of
    models/explore.oracle_validates_walk — sim witnesses are accepted
    under this check)."""
    sv, h = init_state(cfg)
    if walk_key(states[0]) != walk_key(sv):
        raise ValueError("walk does not start at Init")
    out: List[str] = []
    for t, nxt in enumerate(states[1:]):
        want = walk_key(nxt)
        matches = [(lb, s2, h2)
                   for (lb, s2, h2) in successors(sv, h, cfg)
                   if walk_key(s2) == want]
        if not matches:
            raise ValueError(
                f"step {t + 1}: engine state is not an oracle "
                f"successor")
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
