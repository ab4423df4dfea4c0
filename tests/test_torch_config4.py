"""BASELINE config #4, the apalache variant
(``configs/apalache_no_membership/raft.cfg``), on the port: the engine
against the JAX package's engine to a small depth, and the reference's
divergence hunts (``tests/test_divergence.py``) on the port's
``Engine(device="cpu")`` against the JAX package's oracle on the same
seed: ``VotesGrantedInv_false`` one step past the
CommitWhenConcurrentLeaders witness, and (slow, as the reference marks
its own) ``LeaderCompleteness_false`` from the ConcurrentLeaders
witness.  The port's witness is walked through the reference oracle's
successors from the seed, and its labels must be the oracle's."""

import os
import sys

import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from golden import (CONCURRENT_LEADERS_LABELS,  # noqa: E402
                    CWCL_EXTENSION_LABELS)

from raft_tla_tpu_torch.cfg.parser import load_model  # noqa: E402
from raft_tla_tpu_torch.config import Bounds  # noqa: E402
from raft_tla_tpu_torch.engine.bfs import Engine  # noqa: E402
from raft_tla_tpu_torch.models import predicates  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APA = os.path.join(REPO, "configs/apalache_no_membership/raft.cfg")
DEPTH = 7
# the LeaderCompleteness_false witness past the seed, as the oracle
# labels it (chip_smoke.py phase 19b holds the card's to the same)
LC_HUNT_TRACE = ["ClientRequest(1,1)", "AppendEntries(1,2)",
                 "AENoConflict(2)", "AEAlreadyDone(2)",
                 "HandleAEResp(1<-2)", "AdvanceCommitIndex(1)"]


def _hunt_cfgs(invariant):
    """(the port's cfg, the reference's) for the hunt."""
    from raft_tla_tpu.cfg.parser import load_model as r_load
    from raft_tla_tpu.config import Bounds as RBounds
    out = []
    for load, bounds in ((load_model, Bounds), (r_load, RBounds)):
        cfg = load(APA, bounds=bounds.make(
            max_log_length=2, max_timeouts=3, max_client_requests=2))
        # concurrent leaders need 3 servers (the shipped Server={1,2}
        # cannot reach the violations)
        out.append(cfg.with_(n_servers=3, init_servers=(0, 1, 2),
                             invariants=(invariant,)))
    assert repr(out[0]) == repr(out[1])
    return out


def _seed(cfg, labels, successors, init_state):
    sv, h = init_state(cfg)
    for lbl in labels:
        matches = [(s2, h2) for l2, s2, h2 in successors(sv, h, cfg)
                   if l2 == lbl]
        assert len(matches) == 1, lbl
        sv, h = matches[0]
    return sv, h


def _hunt(invariant, labels, max_states):
    """The hunt on the port's engine and on the reference's oracle, from
    the same seed.  Returns (the port's result, the oracle's, the port's
    witness labelled by the oracle: each step of its trace matched to
    the reference's successors by state)."""
    from raft_tla_tpu.models import raft as r_raft
    from raft_tla_tpu.models.explore import _walk_key, explore
    from raft_tla_tpu_torch.models import raft as p_raft
    cfg, rcfg = _hunt_cfgs(invariant)
    seed = _seed(cfg, labels, p_raft.successors, p_raft.init_state)
    rseed = _seed(rcfg, labels, r_raft.successors, r_raft.init_state)
    want = explore(rcfg, seed_states=[rseed], stop_on_violation=True,
                   trace_violations=True, max_states=max_states)
    eng = Engine(cfg, chunk=256, device="cpu")
    got = eng.check(seed_states=[seed], stop_on_violation=True,
                    max_states=max_states)
    chain = [s for _l, s in eng.trace(got.violations[0].state_id)]
    assert _walk_key(chain[0]) == _walk_key(rseed[0])
    sv, h = rseed
    walked = []
    for nxt in chain[1:]:
        step = [(lb, s2, h2) for lb, s2, h2 in
                r_raft.successors(sv, h, rcfg)
                if _walk_key(s2) == _walk_key(nxt)]
        assert step, f"step {len(walked) + 1} is no oracle successor"
        lb, sv, h = step[0]
        walked.append(lb)
    return got, want, walked, cfg, seed


def test_config4_equals_the_reference_engine_to_a_small_depth():
    from raft_tla_tpu.cfg.parser import load_model as r_load
    from raft_tla_tpu.engine.bfs import Engine as REngine
    cfg = load_model(APA)
    assert cfg.apalache_variant and cfg.n_servers == 2
    rcfg = r_load(APA)
    assert repr(rcfg) == repr(cfg)
    got = Engine(cfg, device="cpu").check(max_depth=DEPTH)
    want = REngine(rcfg).check(max_depth=DEPTH)
    assert (got.distinct_states, got.generated_states, got.depth) == \
        (want.distinct_states, want.generated_states, want.depth)
    assert got.level_sizes == want.level_sizes
    assert got.violations == [] and want.violations == []


def test_apalache_false_votes_granted_inv_found_on_the_port():
    """VotesGrantedInv_false fires at depth 1 past the 28-record
    CommitWhenConcurrentLeaders witness, on the port's engine and the
    reference's oracle alike, with the oracle's witness; the live
    apalache name resolves to the false form."""
    got, want, walked, cfg, seed = _hunt(
        "VotesGrantedInv", CONCURRENT_LEADERS_LABELS +
        CWCL_EXTENSION_LABELS, 50_000)
    assert predicates.resolve_invariant("VotesGrantedInv", cfg) is \
        predicates.INVARIANTS["VotesGrantedInv_false"]
    assert [v.invariant for v in want.violations[:1]] == \
        [v.invariant for v in got.violations[:1]] == ["VotesGrantedInv"]
    assert got.depth == want.depth == 1
    assert walked == want.violations[0].trace
    assert walked[-1].startswith("UpdateTerm")
    # the tlc variant's corrected form holds on the same search
    fixed = cfg.with_(apalache_variant=False)
    ok = Engine(fixed, chunk=256, device="cpu").check(
        seed_states=[seed], max_depth=2, max_states=50_000)
    assert ok.violations == []


@pytest.mark.slow
def test_apalache_false_leader_completeness_found_on_the_port():
    """LeaderCompleteness_false, seeded with the ConcurrentLeaders
    witness: the port's engine finds it at the reference oracle's
    depth, and its witness, walked through the oracle, is the oracle's
    six-step extension that ends in a commit."""
    got, want, walked, _cfg, _seed = _hunt(
        "LeaderCompleteness", CONCURRENT_LEADERS_LABELS, 200_000)
    assert [v.invariant for v in want.violations[:1]] == \
        [v.invariant for v in got.violations[:1]] == \
        ["LeaderCompleteness"]
    assert got.depth == want.depth == len(LC_HUNT_TRACE)
    assert walked == want.violations[0].trace == LC_HUNT_TRACE
