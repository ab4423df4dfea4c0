"""The port's default Engine (guard product and delta group on) held
bit for bit against the JAX package's ``Engine(burst=False)`` with its
defaults on a micro config, and every other expansion setting of the
port against the same run: counts, level sizes, the global ids of the
violations, every state's parent and lane, the stored states and the
witness traces.  Covered: incremental (the default at 2 permutations),
direct and orbit-sort fingerprints; guard × delta on/off; the
chunk-skip form; and a tiny ``fam_density`` that forces per-family cap
overflows, whose replays must not change a count.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import (Bounds as JB, DEFAULT_INVARIANTS as JDI,
                                 ModelConfig as JC,
                                 NEXT_ASYNC_CRASH as J_CRASH)

from raft_tla_tpu_torch.config import (Bounds, DEFAULT_INVARIANTS,
                                       ModelConfig, NEXT_ASYNC_CRASH)
from raft_tla_tpu_torch.engine.bfs import Engine

torch.set_num_threads(1)

# 2 servers, NextAsyncCrash (Restart among the delta families),
# symmetric (2 permutations), FirstCommit for violations to compare
_KW = dict(n_servers=2, init_servers=(0, 1), values=(1,), symmetry=True,
           max_inflight_override=2)
_BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
DEPTH = 16
RUNS = {
    "default": dict(),
    "direct": dict(incremental_fp=False),
    "sort": dict(sym_canon="sort", hcap=4),
    "guard-off": dict(guard_matmul=False),
    "delta-off": dict(delta_matmul=False),
    "both-off": dict(guard_matmul=False, delta_matmul=False),
    "chunk-skip": dict(delta_chunk_skip=True),
    # every density 1: the caps of the wide families overflow
    "tiny-density": dict(fam_density={
        "Receive": 1, "UpdateTerm": 1, "RequestVote": 1,
        "AppendEntries": 1, "Timeout": 1, "Restart": 1,
        "ClientRequest": 1, "AdvanceCommitIndex": 1}),
}


def _cfgs():
    jc = JC(next_family=J_CRASH, bounds=JB.make(**_BOUNDS),
            invariants=JDI + ("FirstCommit",), **_KW)
    tc = ModelConfig(next_family=NEXT_ASYNC_CRASH,
                     bounds=Bounds.make(**_BOUNDS),
                     invariants=DEFAULT_INVARIANTS + ("FirstCommit",),
                     **_KW)
    assert repr(jc) == repr(tc)
    return jc, tc


def _record(eng, res):
    return dict(
        counts=(res.distinct_states, res.generated_states, res.depth,
                list(res.level_sizes), res.violations_global,
                res.overflow_faults),
        violations=sorted((v.invariant, v.state_id)
                          for v in res.violations),
        parents=np.concatenate(eng._parents),
        lanes=np.concatenate(eng._lanes))


_DONE = {}


def _jax():
    if "jax" not in _DONE:
        from raft_tla_tpu.engine.bfs import Engine as JEngine
        jc, _tc = _cfgs()
        je = JEngine(jc, chunk=32, burst=False)
        assert je.guard_matmul and je.delta_matmul
        _DONE["jax"] = (je, _record(je, je.check(max_depth=DEPTH)))
    return _DONE["jax"]


def _port(name):
    if name not in _DONE:
        _jc, tc = _cfgs()
        eng = Engine(tc, chunk=32, device="cpu", **RUNS[name])
        caps0 = eng.FAM_CAPS
        _DONE[name] = (eng, _record(eng, eng.check(max_depth=DEPTH)),
                       caps0)
    return _DONE[name]


def test_default_engine_runs_the_reference_default():
    eng, _rec, _caps = _port("default")
    assert eng.guard_matmul and eng.delta_matmul
    assert eng.expander.delta_active and not eng.expander.delta_chunk_skip
    assert set(eng.expander.delta_family_names) == {
        "BecomeLeader", "ClientRequest", "UpdateTerm", "Timeout",
        "Restart"}
    assert eng.incremental_fp and eng.fpr.supports_incremental()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_engine_matches_jax(name):
    je, want = _jax()
    eng, got, caps0 = _port(name)
    assert got["counts"] == want["counts"]
    assert got["violations"] == want["violations"]
    assert got["violations"], "the run must reach FirstCommit"
    np.testing.assert_array_equal(got["parents"], want["parents"])
    np.testing.assert_array_equal(got["lanes"], want["lanes"])
    gids = [g for _nm, g in got["violations"]][:3] + \
        [got["counts"][0] - 1]
    for g in gids:
        assert [lbl for lbl, _ in eng.trace(g)] == \
            [lbl for lbl, _ in je.trace(g)]
        assert eng.get_state(g) == je.get_state(g)
    if name == "sort":
        assert got["counts"] and eng.fpr.sym_canon == "sort"
    if name == "tiny-density":
        # the caps grew by replays, and nothing else changed
        assert any(c > c0 for c, c0 in zip(eng.FAM_CAPS, caps0))


def test_sort_mode_counts_only_live_hard_lanes():
    """The candidate buffer's columns past the enabled count must not
    count as hard lanes (they would fill the fallback's buffer and
    replay levels for nothing): with a live mask, only live hard lanes
    count, and the live lanes' fingerprints do not change.  States: 3
    servers whose votedFor forms a 3-cycle, which the signature cannot
    split (hard), among initial states (soft)."""
    from raft_tla_tpu_torch import convert as cvt
    from raft_tla_tpu_torch.engine.fingerprint import RaftFingerprinter
    from raft_tla_tpu_torch.models.raft import init_state
    from raft_tla_tpu_torch.ops import codec
    from raft_tla_tpu_torch.ops.layout import Layout
    _jc, tc = _cfgs()
    tc = tc.with_(n_servers=3, init_servers=(0, 1, 2))
    fpr = RaftFingerprinter(tc, sym_canon="sort")
    one = codec.encode(Layout(tc), *init_state(tc))
    rows = {k: np.stack([np.asarray(v)] * 8) for k, v in one.items()}
    rows["vf"][[1, 2, 5, 6]] = [(1, 2, 0), (2, 0, 1), (1, 2, 0), (2, 0, 1)]
    svT = cvt.rows_to_torch(rows)
    hard = torch.from_numpy(fpr.sort_debug(
        {k: v.movedim(-1, 0) for k, v in svT.items()})["hard"])
    assert hard.tolist() == [False, True, True, False] * 2
    live = torch.arange(8) < 4
    fp_all, h_all = fpr.fingerprint_chunk_T(svT, 8)
    fp_live, h_live = fpr.fingerprint_chunk_T(svT, 8, live=live)
    assert (int(h_all), int(h_live)) == (4, 2)
    assert torch.equal(fp_live[:, :4], fp_all[:, :4])
    assert torch.equal(fp_all, fpr.fingerprint_batch_T(svT))
