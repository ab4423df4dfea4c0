"""The port's Engine with the orbit-sort canonicalizer and with
incremental fingerprints, held exactly against the JAX package's
Engine(burst=False) in sort mode on micro configs: distinct and
generated counts, depth, level sizes, violations with their global
ids, witness traces and states.  Global ids depend on the state
partition and the enumeration order only, so the port's minperm runs
(incremental and direct) must give the same ids as the reference's
sort run.  Also ``--sym-canon`` on the port's CLI.  The S=4
membership case and the hard-lane buffer's overflow replay are in
test_torch_engine_sort_dyn.py (one JAX engine compile per file).
"""

import json

import pytest
import torch

from raft_tla_tpu.config import (Bounds as JB, DEFAULT_INVARIANTS as JDI,
                                 ModelConfig as JC, NEXT_ASYNC as J_ASYNC,
                                 NEXT_DYNAMIC as J_DYN)

from raft_tla_tpu_torch.config import (Bounds, DEFAULT_INVARIANTS,
                                       ModelConfig, NEXT_ASYNC,
                                       NEXT_DYNAMIC)
from raft_tla_tpu_torch.engine.bfs import Engine

torch.set_num_threads(1)

CASES = {
    # 3 servers, all initial (P = 6): sort forced ("auto" is minperm)
    "s3": dict(n_servers=3, init_servers=(0, 1, 2), values=(1,),
               family="async", max_inflight_override=2,
               bounds=dict(max_log_length=1, max_timeouts=1,
                           max_client_requests=1), depth=16),
    # 4 servers, 3 initial, membership changes (P = 6, two blocks)
    "s4dyn": dict(n_servers=4, init_servers=(0, 1, 2), values=(1,),
                  family="dyn", max_inflight_override=3,
                  bounds=dict(max_log_length=1, max_timeouts=1,
                              max_client_requests=1,
                              max_membership_changes=1), depth=10),
}
# the port's modes held against the reference's sort run
MODES = {"sort": dict(sym_canon="sort"),
         "incremental": dict(sym_canon="minperm", incremental_fp=True),
         "direct": dict(sym_canon="minperm", incremental_fp=False)}


def _cfgs(case):
    c = dict(CASES[case])
    depth = c.pop("depth")
    fam = c.pop("family")
    b = c.pop("bounds")
    jc = JC(next_family={"async": J_ASYNC, "dyn": J_DYN}[fam],
            bounds=JB.make(**b), symmetry=True,
            invariants=JDI + ("FirstCommit",), **c)
    tc = ModelConfig(next_family={"async": NEXT_ASYNC,
                                  "dyn": NEXT_DYNAMIC}[fam],
                     bounds=Bounds.make(**b), symmetry=True,
                     invariants=DEFAULT_INVARIANTS + ("FirstCommit",), **c)
    assert repr(jc) == repr(tc)
    return jc, tc, depth


def _summary(res):
    return dict(
        distinct=res.distinct_states, generated=res.generated_states,
        depth=res.depth, level_sizes=list(res.level_sizes),
        faults=res.overflow_faults, viol_global=res.violations_global,
        violations=sorted((v.invariant, v.state_id)
                          for v in res.violations))


_JAX = {}


def _jax(case):
    """(summary, engine) of the reference's sort run, one JAX engine
    compile per case for the whole module."""
    if case not in _JAX:
        from raft_tla_tpu.engine.bfs import Engine as JEngine
        jc, _tc, depth = _cfgs(case)
        je = JEngine(jc, chunk=64, burst=False, sym_canon="sort")
        assert je.fpr.sym_canon == "sort"
        _JAX[case] = (_summary(je.check(max_depth=depth)), je)
    return _JAX[case]


def check_case(case, mode):
    """The port's engine in ``mode`` against the reference's sort run."""
    want, je = _jax(case)
    _jc, tc, depth = _cfgs(case)
    te = Engine(tc, chunk=64, device="cpu", hcap=8, **MODES[mode])
    assert te.fpr.sym_canon == MODES[mode]["sym_canon"]
    assert (te.incremental_fp and te.fpr.supports_incremental()) == \
        (mode == "incremental")
    res = te.check(max_depth=depth)
    got = _summary(res)
    assert got == want
    assert res.sym_canon == int(mode == "sort")
    gids = [g for _nm, g in got["violations"]][:3] + [got["distinct"] - 1]
    for g in gids:
        assert [lbl for lbl, _ in te.trace(g)] == \
            [lbl for lbl, _ in je.trace(g)]
        assert te.get_state(g) == je.get_state(g)
    if case == "s3":
        assert got["violations"], "the run must reach FirstCommit"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_jax_sort_engine(mode):
    check_case("s3", mode)


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


def test_cli_sym_canon(tmp_path, capsys):
    """--sym-canon: every choice gives the same counts; the stats name
    the resolved mode as the reference's do (1 = sort)."""
    from raft_tla_tpu_torch.cli import main
    from raft_tla_tpu_torch.engine.bfs import Engine
    levels, check = [], Engine.check

    def recorded(self, *a, **kw):
        res = check(self, *a, **kw)
        levels.append(list(res.level_sizes))
        return res
    cfg = tmp_path / "micro.cfg"
    cfg.write_text(MICRO_CFG)
    flags = ["--max-log-length", "1", "--max-timeouts", "1",
             "--max-client-requests", "1", "--chunk", "64",
             "--max-depth", "10", "--device", "cpu"]
    out = {}
    Engine.check = recorded
    try:
        for mode in ("auto", "sort", "minperm"):
            stats = tmp_path / f"{mode}.json"
            assert main(["check", str(cfg), "--sym-canon", mode,
                         "--stats-json", str(stats)] + flags) == 0
            line = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
            assert line == json.loads(stats.read_text())
            out[mode] = line
    finally:
        Engine.check = check
    assert [out[m]["sym_canon"] for m in ("auto", "sort", "minperm")] == \
        [0, 1, 0]
    for key in ("distinct_states", "generated_states", "depth",
                "violations"):
        assert out["sort"][key] == out["minperm"][key] == out["auto"][key]
    # the level sizes left the stats line (the reference's keys): the
    # engines' results hold them
    assert len(levels) == 3 and levels[0] == levels[1] == levels[2]
    with pytest.raises(SystemExit):
        main(["check", str(cfg), "--sym-canon", "fast"] + flags)
