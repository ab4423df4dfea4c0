"""The port's Engine on the CPU, held exactly against the JAX package's
Engine(burst=False) and the Python oracle on micro configs: distinct
and generated counts, depth, level sizes, violations with their global
ids, and witness traces.  Also the CLI and the device rule of the
entry points.
"""

import json
from collections import Counter

import pytest
import torch

from raft_tla_tpu.config import (Bounds as JB, DEFAULT_INVARIANTS as JDI,
                                 ModelConfig as JC, NEXT_ASYNC as J_ASYNC)

from raft_tla_tpu_torch.config import (Bounds, DEFAULT_INVARIANTS,
                                       ModelConfig, NEXT_ASYNC)
from raft_tla_tpu_torch.engine.bfs import Engine

from conftest import cached_explore

torch.set_num_threads(1)

# the 2-server micro config (NextAsync, symmetry, MaxInFlight 2), with
# FirstCommit added so the run records violations to compare by id
_MICRO = dict(n_servers=2, init_servers=(0, 1), values=(1,),
              symmetry=True, max_inflight_override=2)
_MICRO_B = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
# tests/test_engine.py's MICRO (NextAsyncCrash, no symmetry), depth-cut
_CRASH = dict(n_servers=2, init_servers=(0, 1), values=(1,),
              symmetry=False, max_inflight_override=4)
CASES = {
    "micro": (dict(_MICRO, next_family="async"), 10 ** 9),
    "crash": (_CRASH, 16),
}


def _cfgs(case):
    kw, depth = CASES[case]
    kw = dict(kw)
    fam = kw.pop("next_family", None)
    jkw, tkw = dict(kw), dict(kw)
    if fam:
        jkw["next_family"], tkw["next_family"] = J_ASYNC, NEXT_ASYNC
    jc = JC(bounds=JB.make(**_MICRO_B), invariants=JDI + ("FirstCommit",),
            **jkw)
    tc = ModelConfig(bounds=Bounds.make(**_MICRO_B),
                     invariants=DEFAULT_INVARIANTS + ("FirstCommit",), **tkw)
    assert repr(jc) == repr(tc)
    return jc, tc, depth


def _summary(eng, res):
    return dict(
        distinct=res.distinct_states, generated=res.generated_states,
        depth=res.depth, level_sizes=list(res.level_sizes),
        faults=res.overflow_faults, viol_global=res.violations_global,
        violations=sorted((v.invariant, v.state_id)
                          for v in res.violations))


_RUNS = {}


def _runs(case):
    """(jax summary, port summary, jax engine, port engine), one JAX
    engine compile per case for the whole module."""
    if case not in _RUNS:
        from raft_tla_tpu.engine.bfs import Engine as JEngine
        jc, tc, depth = _cfgs(case)
        je = JEngine(jc, chunk=64, burst=False)
        jr = je.check(max_depth=depth)
        te = Engine(tc, chunk=64, device="cpu")
        tr = te.check(max_depth=depth)
        _RUNS[case] = (_summary(je, jr), _summary(te, tr), je, te)
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_levels_and_violation_ids_match_jax(case):
    want, got, _je, _te = _runs(case)
    assert got == want
    assert got["violations"], "the run must reach FirstCommit"


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_oracle(case):
    jc, _tc, depth = _cfgs(case)
    ref = cached_explore(jc, max_depth=depth)
    _want, got, _je, _te = _runs(case)
    assert got["distinct"] == ref.distinct_states
    assert got["depth"] == ref.depth
    assert got["level_sizes"] == list(ref.level_sizes)
    assert Counter(nm for nm, _ in got["violations"]) == \
        Counter(v.invariant for v in ref.violations)


@pytest.mark.parametrize("case", sorted(CASES))
def test_traces_and_states_match_jax(case):
    _w, got, je, te = _runs(case)
    gids = [g for _nm, g in got["violations"]][:5] + [got["distinct"] - 1]
    for g in gids:
        assert [lbl for lbl, _ in te.trace(g)] == \
            [lbl for lbl, _ in je.trace(g)]
        assert te.get_state(g) == je.get_state(g)


def test_first_commit_witness_is_the_15_step_chain():
    _jc, tc, _d = _cfgs("micro")
    eng = Engine(tc.with_(invariants=("FirstCommit",)), chunk=64,
                 device="cpu")
    res = eng.check(stop_on_violation=True)
    trace = [lbl for lbl, _ in eng.trace(res.violations[0].state_id)]
    _w, _g, je, _te = _runs("micro")
    first = min(g for nm, g in _runs("micro")[0]["violations"]
                if nm == "FirstCommit")
    assert res.violations[0].state_id == first
    assert trace == [lbl for lbl, _ in je.trace(first)]
    assert len(trace) - 1 == 15 and trace[-1] == "AdvanceCommitIndex(0)"


def test_replay_after_overflow_keeps_counts():
    """Tiny capacities force every overflow path (fam caps, FCAP, OCAP,
    LCAP, table growth): the replays must not change a count."""
    _jc, tc, depth = _cfgs("crash")
    want = _runs("crash")[1]
    eng = Engine(tc, chunk=16, lcap=64, vcap=64, ocap=16, fcap=32,
                 device="cpu")
    res = eng.check(max_depth=depth)
    assert _summary(eng, res) == want
    assert eng.VCAP > 64 and eng.LCAP > 64


@pytest.mark.parametrize("case", ["dynamic", "fp128"])
def test_more_configs_match_oracle(case):
    """Membership actions with InitServer ⊊ Server (a 2-permutation
    group), and 128-bit keys (W = 4 words in the visited table)."""
    from raft_tla_tpu.config import NEXT_DYNAMIC as J_DYN
    from raft_tla_tpu_torch.config import NEXT_DYNAMIC
    if case == "dynamic":
        kw = dict(n_servers=3, init_servers=(0, 1), values=(1,),
                  symmetry=True, max_inflight_override=6)
        b = dict(max_log_length=2, max_timeouts=1, max_client_requests=1,
                 max_membership_changes=1)
        jc = JC(next_family=J_DYN, bounds=JB.make(**b), **kw)
        tc = ModelConfig(next_family=NEXT_DYNAMIC, bounds=Bounds.make(**b),
                         **kw)
        depth = 14
    else:
        jc, tc, depth = _cfgs("crash")
        jc, tc = jc.with_(fp128=True), tc.with_(fp128=True)
    assert repr(jc) == repr(tc)
    ref = cached_explore(jc, max_depth=depth)
    res = Engine(tc, chunk=64, device="cpu").check(max_depth=depth)
    assert (res.distinct_states, res.depth, list(res.level_sizes)) == \
        (ref.distinct_states, ref.depth, list(ref.level_sizes))
    assert Counter(v.invariant for v in res.violations) == \
        Counter(v.invariant for v in ref.violations)


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    _jc, tc, _d = _cfgs("micro")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(tc)
    from raft_tla_tpu_torch.cli import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["check", "configs/tlc_membership/raft.cfg",
              "--max-depth", "1"])


MICRO_CFG = """CONSTANTS
    Server = {1, 2}
    InitServer = {1, 2}
    Value = {1}
NEXT NextAsync
SYMMETRY Symmetry
INVARIANTS
    LeaderVotesQuorum
    ElectionSafety
"""


def test_cli_check_and_trace(tmp_path, capsys):
    from raft_tla_tpu_torch.cli import main
    cfg = tmp_path / "micro.cfg"
    cfg.write_text(MICRO_CFG)
    stats = tmp_path / "stats.json"
    flags = ["--max-log-length", "1", "--max-timeouts", "1",
             "--max-client-requests", "1", "--chunk", "64",
             "--device", "cpu"]
    assert main(["check", str(cfg), "--max-depth", "8",
                 "--stats-json", str(stats)] + flags) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == json.loads(stats.read_text())
    jc = JC(n_servers=2, init_servers=(0, 1), values=(1,),
            next_family=J_ASYNC, symmetry=True,
            max_inflight_override=None,
            invariants=("LeaderVotesQuorum", "ElectionSafety"),
            bounds=JB.make(**_MICRO_B))
    ref = cached_explore(jc, max_depth=8)
    assert (out["distinct_states"], out["depth"], out["violations"]) == \
        (ref.distinct_states, ref.depth, 0)
    assert main(["trace", str(cfg), "--target", "FirstCommit"] +
                flags) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("witness for FirstCommit at depth 15 ")
    steps = [ln.split()[-1] for ln in out[1:]]
    assert steps[0] == "Init" and steps[-1] == "AdvanceCommitIndex(0)"
    assert len(steps) == 16
