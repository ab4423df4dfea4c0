"""Paxos invariants and scenario properties over batch-last rows (the
device twins of model.py's oracle predicates, with the
``(sv, der) -> holds [R]`` contract of ``ops/vpredicates.Predicates``).

Quantifiers become reductions over the unpacked message-bit blocks that
``kernels.derived`` carries; Agreement's ∃-quorum "chosen" test is the
majority-count closed form computed there.  Paxos declares no
constraints and no action constraints (the bounded space is finite
without them), so those lookups fail loudly, naming the spec.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ...ops.kernels import all_, any_
from .kernels import PaxosKernels
from .layout import PaxosLayout


class PaxosPredicates:
    """Predicate family bound to one (PaxosLayout, PaxosConfig)."""

    def __init__(self, lay: PaxosLayout):
        self.lay = lay
        self.cfg = lay.cfg
        self.kern = PaxosKernels(lay)

    # ---- safety invariants (oracle twins in model.py) ------------------

    def agreement(self, sv, der):
        """model.agreement: at most one chosen value per instance."""
        return all_(der["chosen"].sum(1, dtype=torch.int32) <= 1)

    def validity(self, sv, der):
        """model.validity: every 2b traces to its 2a; every 1b report is
        consistent (mbal >= 0 iff mval >= 0) and traces to the 2a it
        accepted."""
        b1b, b2a, b2b = der["b1b"], der["b2a"], der["b2b"]
        ok_2b = all_(b2b <= b2a[:, None])
        incons = any_(b1b[:, :, :, 1:, 0] > 0) | \
            any_(b1b[:, :, :, 0, 1:] > 0)
        # real reports (mbal, mval >= 0) of any acceptor and promise
        rep = (b1b[:, :, :, 1:, 1:] > 0).any(1).any(1)     # [I, Bm, V, R]
        ok_1b = all_(~rep | (b2a > 0))
        return ok_2b & ~incons & ok_1b

    def one_value_per_ballot(self, sv, der):
        """model.one_value_per_ballot."""
        return all_(der["b2a"].sum(2, dtype=torch.int32) <= 1)

    # ---- scenario properties (negated reachability) --------------------

    def value_chosen(self, sv, der):
        return ~any_(der["chosen"])

    def two_ballots(self, sv, der):
        started = (der["b1a"] > 0).any(0)                  # [B, R]
        return started.sum(0, dtype=torch.int32) < 2

    def preempted(self, sv, der):
        vb, mb = sv["vb"].to(torch.int32), sv["mb"].to(torch.int32)
        return ~any_((vb >= 0) & (mb > vb))

    # ---- registries ----------------------------------------------------

    def invariant_fn(self, name: str) -> Callable:
        try:
            return INVARIANTS[name].__get__(self)
        except KeyError:
            raise KeyError(
                f"unknown invariant {name!r} for spec 'paxos'; known: "
                f"{', '.join(sorted(INVARIANTS))}") from None

    def constraint_fn(self, name: str) -> Callable:
        raise KeyError(
            f"unknown constraint {name!r} for spec 'paxos' — paxos "
            "declares no search constraints (the bounded space is "
            "finite without them)")

    def action_fn(self, name: str) -> Callable:
        raise KeyError(
            f"unknown action constraint {name!r} for spec 'paxos' — "
            "paxos declares none")

    def check_T(self, svT, inv_names, con_names, rtb=None):
        """The named invariants on batch-last rows [..., R], and the
        (empty) constraint conjunction: (inv bool [n_inv, R], con bool
        [R]).  ``rtb`` (runtime bounds) is accepted for the engines'
        uniform call and unused: paxos has no search bounds."""
        fns = [self.invariant_fn(nm) for nm in inv_names]
        for nm in con_names:
            self.constraint_fn(nm)
        R = svT["mb"].shape[-1]
        dev = svT["mb"].device
        con = torch.ones(R, dtype=torch.bool, device=dev)
        if not fns:
            return torch.ones((0, R), dtype=torch.bool, device=dev), con
        der = self.kern.derived(svT)
        return torch.stack([fn(svT, der) for fn in fns]), con


INVARIANTS: Dict[str, Callable] = {
    "Agreement": PaxosPredicates.agreement,
    "Validity": PaxosPredicates.validity,
    "OneValuePerBallot": PaxosPredicates.one_value_per_ballot,
    "ValueChosen": PaxosPredicates.value_chosen,
    "TwoBallots": PaxosPredicates.two_ballots,
    "Preempted": PaxosPredicates.preempted,
}

SCENARIO_PROPERTIES = ("ValueChosen", "TwoBallots", "Preempted")
