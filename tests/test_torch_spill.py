"""The port's host-spill engine (``engine/spill.py``) against the JAX
package's ``SpillEngine`` and the oracle, on the micro config of
``tests/test_spill.py`` with FirstBecomeLeader as its invariant (so
every level has violations to report), in tiny segments (seg 2^10,
sync_every 2): distinct and generated states, level sizes, depth, the
global ids (the parent and lane archives, the state rows), the
violations and the traces, with the burst on and off, and on runs that
trip every overflow — a level segment that fills (ovf, the segment cut
to 4·OCAP), family and candidate caps that grow (fovf), a probe budget
that runs out (hovf, the budget cut to 2 steps) — and a table that
grows mid-run.  Constraint pruning on the host holds against the oracle
and the classic engine.  One JAX compile for the module."""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC

from raft_tla_tpu_torch.config import (Bounds, ModelConfig, NEXT_ASYNC,
                                       NEXT_ASYNC_CRASH)
from raft_tla_tpu_torch.engine import spill as spill_mod
from raft_tla_tpu_torch.engine.spill import SpillEngine

torch.set_num_threads(1)

KW = dict(n_servers=2, init_servers=(0, 1), values=(1,),
          next_family=NEXT_ASYNC, max_inflight_override=4, symmetry=True,
          invariants=("FirstBecomeLeader",))
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
DEPTH = 18
TINY = dict(chunk=64, seg=1 << 10, vcap=1 << 12, sync_every=2,
            store_states=True)


def _cfgs():
    jc = JC(bounds=JB.make(**BOUNDS), **KW)
    tc = ModelConfig(bounds=Bounds.make(**BOUNDS), **KW)
    assert repr(jc) == repr(tc)
    return jc, tc


def _answer(eng, res):
    """Everything a run must reproduce: the counts, the violations (by
    invariant and global id), the archives (so every gid's parent,
    lane and state) and the traces of the first violation and of the
    last state."""
    gids = [res.violations[0].state_id, res.distinct_states - 1]
    return dict(
        counts=(res.distinct_states, res.generated_states, res.depth,
                list(res.level_sizes), res.overflow_faults,
                res.violations_global),
        violations=[(v.invariant, v.state_id) for v in res.violations],
        parents=np.concatenate(eng._parents).tolist(),
        lanes=np.concatenate(eng._lanes).tolist(),
        states={k: np.concatenate([s[k] for s in eng._states]).tolist()
                for k in eng._states[0]},
        traces=[eng.trace(g) for g in gids])


@pytest.fixture(scope="module")
def want():
    """The JAX SpillEngine's answer, on its segment driver alone (the
    burst's compile would double the module's time; the port's burst
    is held against the same answer)."""
    from raft_tla_tpu.engine.spill import SpillEngine as JSpill
    jc, _tc = _cfgs()
    je = JSpill(jc, burst=False, **TINY)
    return _answer(je, je.check(max_depth=DEPTH))


def _port(**kw):
    _jc, tc = _cfgs()
    eng = SpillEngine(tc, device="cpu", **dict(TINY, **kw))
    return eng, eng.check(max_depth=DEPTH)


@pytest.mark.parametrize("burst", [True, False], ids=["burst", "no-burst"])
def test_spill_equals_the_jax_spill_engine(want, burst):
    eng, res = _port(burst=burst)
    assert _answer(eng, res) == want
    assert (res.levels_fused > 0) == burst
    assert eng.segments_spilled > 0 and eng.summary_syncs > 0


def test_spill_matches_the_oracle(want):
    from conftest import cached_explore
    jc, _tc = _cfgs()
    ref = cached_explore(jc, max_depth=DEPTH)
    c = want["counts"]
    assert (c[0], c[1], c[2], c[3]) == (
        ref.distinct_states, ref.generated_states, ref.depth,
        list(ref.level_sizes))
    assert len(want["violations"]) == len(ref.violations)


def test_segment_overflow_trips_replay_exactly(want):
    """A level segment of 4·OCAP rows with OCAP 64: the spill floor
    lies below zero, so every window spills, and a window's fresh rows
    still overrun the segment (ovf) — each tripped chunk leaves no trace
    and replays after the spill."""
    _jc, tc = _cfgs()
    eng = SpillEngine(tc, device="cpu", burst=False, fcap=64, **TINY)
    eng.SEGL = 4 * eng.OCAP
    res = eng.check(max_depth=DEPTH)
    assert eng.trips["ovf"] > 0
    assert _answer(eng, res) == want


def test_cap_overflow_trips_grow_and_replay(want):
    """FCAP 64 and family caps of 16: fovf trips grow both mid-level."""
    _jc, tc = _cfgs()
    eng = SpillEngine(tc, device="cpu", burst=False, fcap=64, **TINY)
    eng.FAM_CAPS = tuple(min(c, 16) for c in eng.FAM_CAPS)
    res = eng.check(max_depth=DEPTH)
    assert eng.trips["fovf"] > 0 and eng.FCAP > 64
    assert _answer(eng, res) == want


def test_probe_budget_trips_grow_the_table(want, monkeypatch):
    """The step's probe budget cut to 2 steps and a 64-slot table: hovf
    trips rehash the table ×4 mid-level (the rehash keeps the full
    budget), and the proactive load check grows it too."""
    orig = spill_mod.probe_claim_insert

    def short(table, keys, live):
        return orig(table, keys, live, max_rounds=2)
    monkeypatch.setattr(spill_mod, "probe_claim_insert", short)
    eng, res = _port(burst=False, vcap=1 << 6)
    assert eng.trips["hovf"] > 0 and eng.VCAP > 1 << 12
    assert _answer(eng, res) == want


def test_constraint_pruning_parity():
    """Host-side prune-not-expand where the constraints bite (crash
    restarts, no symmetry): pruned rows are counted and checked but not
    expanded — the oracle's counts and the classic engine's, which keeps
    them under its fmask."""
    from conftest import cached_explore
    from raft_tla_tpu.config import NEXT_ASYNC_CRASH as J_CRASH
    from raft_tla_tpu_torch.engine.bfs import Engine
    kw = dict(n_servers=2, init_servers=(0, 1), values=(1,),
              symmetry=False, max_inflight_override=4)
    b = dict(max_log_length=1, max_timeouts=1, max_restarts=1,
             max_client_requests=1)
    jc = JC(next_family=J_CRASH, bounds=JB.make(**b), **kw)
    tc = ModelConfig(next_family=NEXT_ASYNC_CRASH, bounds=Bounds.make(**b),
                     **kw)
    ref = cached_explore(jc, max_depth=12)
    eng = SpillEngine(tc, device="cpu", chunk=64, seg=1 << 11,
                      vcap=1 << 13, sync_every=3, store_states=True)
    res = eng.check(max_depth=12)
    cls = Engine(tc, chunk=64, device="cpu").check(max_depth=12)
    got = (res.distinct_states, res.generated_states, res.depth,
           list(res.level_sizes))
    assert got == (ref.distinct_states, ref.generated_states, ref.depth,
                   list(ref.level_sizes))
    assert got == (cls.distinct_states, cls.generated_states, cls.depth,
                   list(cls.level_sizes))
    # constraints pruned rows: fewer expanded than admitted
    assert sum(res.level_sizes) < res.distinct_states
    assert eng.trace(res.distinct_states - 1)[0][0] == "Init"


def test_spill_engine_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    _jc, tc = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpillEngine(tc)


def test_micro_config_is_the_reference_spill_tests():
    """The config here is tests/test_spill.py's MICRO plus the
    invariant."""
    from test_spill import MICRO
    assert repr(MICRO.with_(invariants=KW["invariants"])) == \
        repr(_cfgs()[0])


def test_disk_archive_holds_the_in_ram_archive(want, tmp_path):
    """``archive_dir``: the spilled parts stream into the disk archive's
    memmaps (``DiskArchive.append_level_parts``) and the traces through
    it equal the in-RAM run's."""
    eng, res = _port(archive_dir=str(tmp_path / "arch"))
    assert eng._arch is not None and eng._arch.n_levels == DEPTH + 1
    got = [eng.trace(g) for g in (res.violations[0].state_id,
                                  res.distinct_states - 1)]
    assert got == want["traces"]


@pytest.mark.parametrize("mode", [dict(), dict(incremental_fp=False)],
                         ids=["incremental", "direct"])
def test_spill_step_and_burst_read_nothing_back(want, mode, monkeypatch):
    """Every spill step and spill-burst iteration runs under
    ``test_torch_chunk_step_ocap``'s guard (no host read, and no host
    data copied in past a graph key's first call), with FCAP 64 (fovf
    trips); the answer stays the JAX engine's.  (The hard-lane trip
    needs config #5's depth 17: ``tests/test_torch_cuda.py``.)"""
    from test_torch_chunk_step_ocap import NoHostRead, guard
    from raft_tla_tpu_torch.engine import bfs
    twin = spill_mod.probe_claim_insert

    def paused_twin(*a, **kw):
        NoHostRead.paused = True
        try:
            return twin(*a, **kw)
        finally:
            NoHostRead.paused = False
    monkeypatch.setattr(spill_mod, "probe_claim_insert", paused_twin)
    monkeypatch.setattr(bfs, "probe_claim_insert", paused_twin)
    _jc, tc = _cfgs()
    eng = SpillEngine(tc, device="cpu", fcap=64, **dict(TINY, **mode))
    steps = guard(eng, "_spill_step", "spill")
    bodies = guard(eng, "_burst_body", "burst")
    res = eng.check(max_depth=DEPTH)
    assert steps[0] > 0 and bodies[0] > 0
    assert eng.trips["fovf"] > 0
    assert _answer(eng, res) == want
