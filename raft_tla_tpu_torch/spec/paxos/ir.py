"""The Paxos spec as a ``SpecIR``: the action-family registry and the
per-family density table, assembled with the port's paxos layout,
kernels, predicates and fingerprinter.

Families enumerate in the oracle's order (model.successors): Phase1a,
Phase1b, Phase2a, Phase2b, instance-major within each family — the
reference's ``spec/paxos/ir.py`` grids, on which every global state id
and generated count depends.  Each guard is exactly one feature of
``kernels.guard_features``, and every family declares its delta
algebra (set-monotone bit sends and per-cell scalar sets), so the whole
expansion runs as the delta group with no per-family kernel; the
kernels run under ``delta_matmul=False`` and in the walker's
``step_lanes`` without the group.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import U32_KEYS, Family, SpecIR

# Enabled-lane density per parent state (buffer sizing; overflow grows
# the cap and replays), the reference's table.
FAMILY_DENSITY = {
    "Phase1a": 4, "Phase1b": 8, "Phase2a": 4, "Phase2b": 8,
}


def _send_bit(off, idx, src=None):
    """Delta triples of the monotone bit-send ``msgs |= 1 << idx``: the
    bit's weight rides its own bit-clear feature (``src`` overrides the
    source — Phase1b routes through the (mbal, mval) one-hot), so the
    int32 add is the set-OR exactly.  The 1 << 31 weight wraps to
    INT_MIN when the expander builds its weights (engine/expand.py)."""
    if src is None:
        src = off["_src_f"] + off["_feat"]["notbit"] + idx
    return [(off["msgs"] + (idx >> 5), src, 1 << (idx & 31))]


def build_families(lay) -> List[Family]:
    from ...engine.expand import d_set
    from .. import C_GLOBLEN
    from .kernels import PaxosKernels
    kern = PaxosKernels(lay)
    I, N, B, V = lay.I, lay.N, lay.B, lay.V

    def grid(*ranges):
        arrs = np.meshgrid(*[np.asarray(r, np.int32) for r in ranges],
                           indexing="ij")
        return tuple(a.ravel() for a in arrs)

    def glob(off):
        return [(off["ctr"] + C_GLOBLEN, off["_const"], 1)]

    def d_1a(off, lay, i, b):
        return _send_bit(off, lay.off_1a + i * lay.B + b) + glob(off)

    def d_1b(off, lay, i, a, b):
        P = (lay.B + 1) * (lay.V + 1)
        base = lay.off_1b + ((i * lay.N + a) * lay.B + b) * P
        mb = off["mb"] + i * lay.N + a
        tr = [(mb, off["_const"], b), (mb, off["_src_x"] + mb, -1)]
        # the report bit's position depends on (vb, vv): spread the send
        # over the (mbal, mval) one-hot block — exactly one position
        # fires, and a monotone mb means that bit is clear
        fsel = off["_src_f"] + off["_feat"]["sel1b"] \
            + (i * lay.N + a) * P
        for p in range(P):
            tr += _send_bit(off, base + p, src=fsel + p)
        return tr + glob(off)

    def d_2a(off, lay, i, b, v):
        return _send_bit(
            off, lay.off_2a + (i * lay.B + b) * lay.V + v) + glob(off)

    def d_2b(off, lay, i, a, b, v):
        mb = off["mb"] + i * lay.N + a
        vb = off["vb"] + i * lay.N + a
        vv = off["vv"] + i * lay.N + a
        return (d_set(off, mb, b) + d_set(off, vb, b) +
                d_set(off, vv, v) +
                # a re-accept's bit is already set: notbit sourcing makes
                # the add a no-op there, exactly the set-OR
                _send_bit(off, lay.off_2b +
                          ((i * lay.N + a) * lay.B + b) * lay.V + v) +
                glob(off))

    return [
        Family("Phase1a", kern.phase1a, grid(range(I), range(B)),
               lambda i, b: f"Phase1a({i},{b})",
               guard=lambda off, lay, i, b: (
                   [(off["p1a"] + i * lay.B + b, 1)], 1),
               delta=d_1a),
        Family("Phase1b", kern.phase1b,
               grid(range(I), range(N), range(B)),
               lambda i, a, b: f"Phase1b({i},{a},{b})",
               guard=lambda off, lay, i, a, b: (
                   [(off["p1b"] + (i * lay.N + a) * lay.B + b, 1)], 1),
               delta=d_1b),
        Family("Phase2a", kern.phase2a,
               grid(range(I), range(B), range(V)),
               lambda i, b, v: f"Phase2a({i},{b},{v})",
               guard=lambda off, lay, i, b, v: (
                   [(off["p2a"] + (i * lay.B + b) * lay.V + v, 1)], 1),
               delta=d_2a),
        Family("Phase2b", kern.phase2b,
               grid(range(I), range(N), range(B), range(V)),
               lambda i, a, b, v: f"Phase2b({i},{a},{b},{v})",
               guard=lambda off, lay, i, a, b, v: (
                   [(off["p2b"] +
                     ((i * lay.N + a) * lay.B + b) * lay.V + v, 1)],
                   1),
               delta=d_2b),
    ]


def sim_progress(kern, lay):
    """The random walkers' punctuated-restart ladder: proposal seen <
    acceptance seen < value chosen.  (kernels, layout) -> (svT -> int32
    [W])."""
    import torch

    def score(svT):
        der = kern.derived(svT)
        W = der["bits"].shape[-1]
        any2a = (der["b2a"] > 0).reshape(-1, W).any(0)
        any2b = (der["b2b"] > 0).reshape(-1, W).any(0)
        chose = der["chosen"].reshape(-1, W).any(0)
        return (any2a.to(torch.int32) + 2 * any2b.to(torch.int32) +
                4 * chose.to(torch.int32))

    return score


def serve_bucket(cfg):
    """The bucket ceiling of a paxos job (the reference's
    ``spec/paxos/ir.serve_bucket``): ballots and values pad up the
    ``pad_rung`` ladder with floor 2, instances with floor 1, so sweeps
    over those constants share one bucket.  Each job's own bounds become
    its lane mask (``serve_runtime``): a padded ballot, value or
    instance lane never fires, so no out-of-bounds message is sent and
    padded instances stay at their init cells.  The acceptor count is
    structural and stays exact."""
    from .. import pad_rung
    ceiling = cfg.with_(n_ballots=pad_rung(cfg.n_ballots, floor=2),
                        n_values=pad_rung(cfg.n_values, floor=2),
                        n_instances=pad_rung(cfg.n_instances))
    return ceiling, dict(chunk=128, vcap=1 << 15, burst_levels=8)


def serve_runtime(expander, cfg):
    """A paxos job's runtime data under its ceiling's expander: the
    ceiling's thresholds, and the lane mask that holds the job's bounds
    (each lane's instance, ballot and value inside the job's; the
    acceptor parameter is never masked).  Paxos has no search bounds."""
    I, B, V = cfg.n_instances, cfg.n_ballots, cfg.n_values
    thr, mask = expander.runtime_thresholds()
    in_bounds = {
        "Phase1a": lambda i, b: i < I and b < B,
        "Phase1b": lambda i, a, b: i < I and b < B,
        "Phase2a": lambda i, b, v: i < I and b < B and v < V,
        "Phase2b": lambda i, a, b, v: i < I and b < B and v < V,
    }
    lane = 0
    for fam in expander.families:
        ok = in_bounds[fam.name]
        for vals in zip(*fam.params) if fam.params else [()]:
            mask[lane] = ok(*(int(v) for v in vals))
            lane += 1
    assert lane == expander.n_lanes
    return dict(thr=thr, mask=mask, bounds=np.zeros((0,), np.int32))


def build_ir() -> SpecIR:
    from . import layout as codec
    from .config import PaxosConfig
    from .kernels import PaxosKernels
    from .layout import PaxosLayout
    from .model import (GLOB_DEPENDENT, INVARIANTS, init_state,
                        state_from_obj, state_to_obj, successors,
                        symmetry_perms, walk_key)
    from .oracle import explore
    from .vpredicates import PaxosPredicates, SCENARIO_PROPERTIES

    def make_fingerprinter(cfg, sym_canon="minperm"):
        from .fingerprint import PaxosFingerprinter
        return PaxosFingerprinter(cfg, sym_canon=sym_canon)

    def server_signature(fpr, svT, prep):
        from .fingerprint import paxos_acceptor_signature
        return paxos_acceptor_signature(fpr, svT, prep)

    return SpecIR(
        name="paxos",
        version=1,
        make_layout=PaxosLayout,
        init_state=init_state,
        encode=codec.encode,
        decode=codec.decode,
        narrow=codec.narrow_t,
        widen=codec.widen_t,
        view_keys=codec.VIEW_KEYS,
        nonview_keys=codec.NONVIEW_KEYS,
        state_to_obj=state_to_obj,
        state_from_obj=state_from_obj,
        make_kernels=PaxosKernels,
        build_families=build_families,
        family_density=dict(FAMILY_DENSITY),
        make_predicates=PaxosPredicates,
        scenario_properties=SCENARIO_PROPERTIES,
        known_invariants=frozenset(INVARIANTS),
        known_constraints=frozenset(),
        known_action_constraints=frozenset(),
        glob_dependent=GLOB_DEPENDENT,
        make_fingerprinter=make_fingerprinter,
        symmetry_perms=symmetry_perms,
        server_signature=server_signature,
        oracle_explore=explore,
        oracle_successors=successors,
        oracle_walk_key=walk_key,
        prefix_pin_seeds=None,
        sim_progress=sim_progress,
        default_config=PaxosConfig,
        u32_keys=U32_KEYS["paxos"],
        serve_bucket=serve_bucket,
        serve_runtime=serve_runtime,
    )
