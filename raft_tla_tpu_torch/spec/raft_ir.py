"""The Raft spec as a ``SpecIR``: the action-family registry and the
per-family density table, assembled with the port's layout, codec,
kernels, predicates and fingerprinter.

Lane order, guard declarations and densities are those of the
reference package's ``spec/raft_ir.py`` — the candidate enumeration
order (and with it every global state id) depends on them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..config import NEXT_ASYNC_CRASH, NEXT_DYNAMIC, NEXT_FULL
from . import SpecIR


@dataclass
class Family:
    """One action family: its successor kernel over compacted rows,
    its static parameter grid, a label maker, and its guard algebra.

    ``fn(sv, der, *params)`` takes batch-last rows [..., N] and one
    int32 [N] tensor per parameter, and returns the successor rows.
    ``guard(offsets, lay, *lane_params) -> ([(feature, weight)],
    threshold)``: lane a is enabled exactly when the weighted sum of
    the kernels' guard features equals its threshold."""
    name: str
    fn: Callable
    params: Tuple[np.ndarray, ...]
    labeler: Callable
    guard: Optional[Callable] = None

    @property
    def n_lanes(self):
        return len(self.params[0]) if self.params else 1


def build_families(lay) -> List[Family]:
    from ..ops.kernels import RaftKernels
    cfg = lay.cfg
    kern = RaftKernels(lay)
    S, K = lay.S, lay.K
    fams: List[Family] = []

    def grid(*ranges):
        arrs = np.meshgrid(*[np.asarray(r, np.int32) for r in ranges],
                           indexing="ij")
        return tuple(a.ravel() for a in arrs)

    ij = grid(range(S), range(S))
    ij_ne = tuple(a[ij[0] != ij[1]] for a in ij)        # i != j lanes
    iv = grid(range(S), list(cfg.values))
    i_ = grid(range(S))
    k_ = grid(range(K))

    fams.append(Family(
        "RequestVote", kern.request_vote, ij,
        lambda i, j: f"RequestVote({i},{j})",
        guard=lambda off, lay, i, j: (
            [(off["cand"] + i, 1), (off["needvote"] + i * lay.S + j, 1)],
            2)))
    fams.append(Family(
        "BecomeLeader", kern.become_leader, i_,
        lambda i: f"BecomeLeader({i})",
        guard=lambda off, lay, i: (
            [(off["cand"] + i, 1), (off["blq"] + i, 1)], 2)))
    fams.append(Family(
        "ClientRequest", kern.client_request, iv,
        lambda i, v: f"ClientRequest({i},{v})",
        guard=lambda off, lay, i, v: ([(off["leader"] + i, 1)], 1)))
    fams.append(Family(
        "AdvanceCommitIndex", kern.advance_commit_index, i_,
        lambda i: f"AdvanceCommitIndex({i})",
        guard=lambda off, lay, i: ([(off["leader"] + i, 1)], 1)))
    fams.append(Family(
        "AppendEntries", kern.append_entries, ij_ne,
        lambda i, j: f"AppendEntries({i},{j})",
        guard=lambda off, lay, i, j: (
            [(off["leader"] + i, 1), (off["cfg"] + i * lay.S + j, 1)],
            2)))
    fams.append(Family(
        "UpdateTerm", kern.update_term, k_,
        lambda k: f"UpdateTerm[slot{k}]",
        guard=lambda off, lay, k: ([(off["ut"] + k, 1)], 1)))
    fams.append(Family(
        "CocDiscard", kern.coc_discard, k_,
        lambda k: f"CocDiscard[slot{k}]",
        guard=lambda off, lay, k: ([(off["cocd"] + k, 1)], 1)))
    fams.append(Family(
        "Receive", kern.receive_main, k_,
        lambda k: f"Receive[slot{k}]",
        guard=lambda off, lay, k: ([(off["recv"] + k, 1)], 1)))
    fams.append(Family(
        "Timeout", kern.timeout, i_,
        lambda i: f"Timeout({i})",
        guard=lambda off, lay, i: (
            [(off["folc"] + i, 1), (off["cfg"] + i * lay.S + i, 1)], 2)))
    if cfg.next_family in (NEXT_ASYNC_CRASH, NEXT_FULL, NEXT_DYNAMIC):
        fams.append(Family(
            "Restart", kern.restart, i_,
            lambda i: f"Restart({i})",
            guard=lambda off, lay, i: ([], 0)))    # unconditional
    if cfg.next_family in (NEXT_FULL, NEXT_DYNAMIC):
        fams.append(Family(
            "Duplicate", kern.duplicate_message,
            k_, lambda k: f"Duplicate[slot{k}]",
            guard=lambda off, lay, k: ([(off["cnt1"] + k, 1)], 1)))
        fams.append(Family(
            "Drop", kern.drop_message,
            k_, lambda k: f"Drop[slot{k}]",
            guard=lambda off, lay, k: ([(off["cnt1"] + k, 1)], 1)))
    if cfg.next_family == NEXT_DYNAMIC:
        fams.append(Family(
            "AddNewServer", kern.add_new_server, ij,
            lambda i, j: f"AddNewServer({i},{j})",
            # j ∉ config enters with weight -1 and no threshold share
            guard=lambda off, lay, i, j: (
                [(off["leader"] + i, 1),
                 (off["cfg"] + i * lay.S + j, -1)], 1)))
        fams.append(Family(
            "DeleteServer", kern.delete_server, ij_ne,
            lambda i, j: f"DeleteServer({i},{j})",
            guard=lambda off, lay, i, j: (
                [(off["leader"] + i, 1), (off["folc"] + j, 1),
                 (off["cfg"] + i * lay.S + j, 1)], 3)))
    return fams


# Expected enabled-lane density per parent state, by family (measured
# on the BASELINE configs by the reference package): the engine sizes
# the per-family materialization caps from these, cap_f = chunk *
# min(lanes, d).  Throughput tuning, not correctness bounds: overflow
# grows the cap and replays the level.
FAMILY_DENSITY = {
    "Restart": 1 << 30, "Timeout": 1 << 30,
    "RequestVote": 2, "BecomeLeader": 1, "ClientRequest": 2,
    "AdvanceCommitIndex": 2, "AppendEntries": 2,
    "UpdateTerm": 2, "CocDiscard": 1, "Receive": 4,
    "Duplicate": 4, "Drop": 4, "AddNewServer": 2, "DeleteServer": 2,
}


def build_ir() -> SpecIR:
    from ..models.raft import init_state, symmetry_perms
    from ..ops import codec
    from ..ops.kernels import RaftKernels
    from ..ops.layout import Layout
    from ..ops.vpredicates import Predicates

    def make_fingerprinter(cfg, sym_canon="minperm"):
        from ..engine.fingerprint import RaftFingerprinter
        return RaftFingerprinter(cfg, sym_canon=sym_canon)

    def server_signature(fpr, svT, prep):
        from ..engine.fingerprint import raft_server_signature
        return raft_server_signature(fpr, svT, prep)

    return SpecIR(
        name="raft",
        make_layout=Layout,
        init_state=init_state,
        encode=codec.encode,
        decode=codec.decode,
        narrow=codec.narrow_t,
        widen=codec.widen_t,
        view_keys=codec.VIEW_KEYS,
        nonview_keys=codec.NONVIEW_KEYS,
        make_kernels=RaftKernels,
        build_families=build_families,
        family_density=dict(FAMILY_DENSITY),
        make_predicates=Predicates,
        make_fingerprinter=make_fingerprinter,
        symmetry_perms=symmetry_perms,
        server_signature=server_signature,
    )
