"""Paxos model configuration (the ``PaxosConfig`` the engines bind to).

Bounds model (cf. Lamport's ``Paxos.tla`` as run under TLC): ballots
range over ``0..n_ballots-1``, values over ``0..n_values-1`` (values
are opaque — indices keep the packed layout dense), instances are
``n_instances`` fully independent single-decree consensus slots (the
product-state multi-instance form; the reachable set is exactly the
product of the per-instance sets, which the tests exploit as a
closed-form count check).  Unlike Raft, the whole state space is
finite WITHOUT search constraints — ``msgs`` is a monotone SET over a
finite message universe and every per-acceptor variable is bounded —
so the constraint registry is legitimately empty.

The engines read the same generic surface they read off
``ModelConfig``: ``invariants`` / ``constraints`` /
``action_constraints`` / ``symmetry`` / ``fp128`` / ``prefix_pins``
plus the dispatch marker ``spec`` (a class attribute, so it never
enters ``repr``/checkpoint-compat comparisons).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

DEFAULT_INVARIANTS = ("Agreement", "Validity", "OneValuePerBallot")


@dataclass(frozen=True)
class PaxosConfig:
    """One checkable Paxos model: acceptor/ballot/value/instance bounds
    + the toggle surface the engines consume."""

    n_servers: int = 3            # |Acceptor| (engines' generic name)
    n_ballots: int = 2            # ballots 0..n_ballots-1
    n_values: int = 2             # values 0..n_values-1
    n_instances: int = 1          # independent consensus slots
    symmetry: bool = True         # acceptor-permutation canonicalization
    fp128: bool = False
    invariants: Tuple[str, ...] = DEFAULT_INVARIANTS
    constraints: Tuple[str, ...] = ()         # finite space: none needed
    action_constraints: Tuple[str, ...] = ()
    prefix_pins: Tuple[str, ...] = ()         # raft-only feature

    # SpecIR dispatch marker — class attribute, NOT a dataclass field:
    # repr(cfg) (the checkpoint-compat key) is unaffected
    spec = "paxos"

    def __post_init__(self):
        if not (1 <= self.n_servers <= 7):
            raise ValueError(
                f"n_servers must be in 1..7 (got {self.n_servers}) — "
                "quorum enumeration is exponential in acceptors")
        for nm in ("n_ballots", "n_values", "n_instances"):
            v = getattr(self, nm)
            if not (1 <= v <= 32):
                raise ValueError(f"{nm} must be in 1..32 (got {v})")

    @property
    def values(self) -> Tuple[int, ...]:
        return tuple(range(self.n_values))

    @property
    def quorums(self) -> Tuple[Tuple[int, ...], ...]:
        """All majorities of the acceptor set (every TLA Quorum model
        instantiates it so); shared by the oracle and the kernels."""
        import itertools
        n = self.n_servers
        out = []
        for r in range(n // 2 + 1, n + 1):
            out.extend(itertools.combinations(range(n), r))
        return tuple(out)

    def with_(self, **kw) -> "PaxosConfig":
        return dataclasses.replace(self, **kw)
