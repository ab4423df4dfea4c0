"""The port's fused small-level path (``Engine(burst=True)``, the
default) held exactly against the JAX package's Engine(burst=True) on
tests/test_burst.py's MICRO config: counts, level sizes, the burst
counters (levels fused, dispatches, bailouts), archives and where a
depth or state budget stops.  Burst on and off in the port give
identical archives, also past the level where the ring is outgrown and
the burst bails.  The forced bails and violations are in
test_torch_engine_burst_bail.py, the second compaction and the
no-host-read guard in test_torch_chunk_step_ocap.py.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC

from raft_tla_tpu_torch.config import Bounds, ModelConfig
from raft_tla_tpu_torch.engine.bfs import Engine

torch.set_num_threads(1)

# tests/test_burst.py's MICRO (NextAsyncCrash, symmetry, MaxInFlight 4)
MICRO = dict(n_servers=2, init_servers=(0, 1), values=(1,),
             max_inflight_override=4, symmetry=True)
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)


def cfgs(**kw):
    jc = JC(bounds=JB.make(**BOUNDS), **MICRO, **kw)
    tc = ModelConfig(bounds=Bounds.make(**BOUNDS), **MICRO, **kw)
    assert repr(jc) == repr(tc)
    return jc, tc


def summary(res):
    return dict(
        distinct=res.distinct_states, generated=res.generated_states,
        depth=res.depth, level_sizes=list(res.level_sizes),
        faults=res.overflow_faults, viol_global=res.violations_global,
        violations=sorted((v.invariant, v.state_id)
                          for v in res.violations),
        fused=res.levels_fused, dispatches=res.burst_dispatches,
        bailouts=res.burst_bailouts)


def archives_equal(a, b):
    """Archives identical level by level, row by row (same enumeration
    order, so the same global ids and traces)."""
    assert len(a._parents) == len(b._parents)
    for x, y in zip(a._parents, b._parents):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a._lanes, b._lanes):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a._states, b._states):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


_JAX = {}


def jax_engine():
    """The reference's burst engine on MICRO: one compile per module,
    reused by every run below."""
    if "e" not in _JAX:
        from raft_tla_tpu.engine.bfs import Engine as JEngine
        _JAX["e"] = JEngine(cfgs()[0], chunk=64, burst=True)
    return _JAX["e"]


def test_dispatch_floor_matches_jax():
    """The reference's acceptance shape: 12 levels fused in at most 2
    dispatches, the same counters and archives as the JAX engine."""
    je = jax_engine()
    want = summary(je.check(max_depth=12))
    eng = Engine(cfgs()[1], chunk=64, device="cpu")
    got = summary(eng.check(max_depth=12))
    assert got == want
    assert got["depth"] == 12 and got["fused"] == 12
    assert got["dispatches"] <= 2
    archives_equal(eng, je)


@pytest.mark.parametrize("limit", [dict(max_depth=1), dict(max_depth=3),
                                   dict(max_depth=7), dict(max_states=50)],
                         ids=["depth1", "depth3", "depth7", "states50"])
def test_budgets_stop_at_the_same_level(limit):
    want = summary(jax_engine().check(**limit))
    _jc, tc = cfgs()
    on = Engine(tc, chunk=64, store_states=False, device="cpu")
    off = Engine(tc, chunk=64, store_states=False, burst=False,
                 device="cpu")
    got_on, got_off = summary(on.check(**limit)), summary(off.check(**limit))
    assert got_on == want
    assert got_on["fused"] == got_on["depth"] > 0
    for k in ("fused", "dispatches", "bailouts"):
        assert got_off[k] == 0
        got_off[k] = got_on[k]
    assert got_off == got_on


def test_burst_on_and_off_give_identical_archives():
    """To depth 16: the ring (4 chunks of 64) is outgrown at depth 15,
    the burst bails and the per-level path takes over; the archives
    are those of the per-level driver throughout."""
    _jc, tc = cfgs()
    on = Engine(tc, chunk=64, device="cpu")
    off = Engine(tc, chunk=64, burst=False, device="cpu")
    r_on, r_off = on.check(max_depth=16), off.check(max_depth=16)
    assert r_on.burst_bailouts >= 1 and 0 < r_on.levels_fused < 16
    assert (r_on.distinct_states, r_on.generated_states, r_on.level_sizes) \
        == (r_off.distinct_states, r_off.generated_states, r_off.level_sizes)
    archives_equal(on, off)


@pytest.mark.parametrize("levels", [0, -3])
def test_burst_levels_must_be_positive(levels):
    with pytest.raises(ValueError, match="burst_levels must be positive"):
        Engine(cfgs()[1], chunk=64, burst_levels=levels, device="cpu")


def test_fewer_levels_per_dispatch_give_the_same_answer():
    """burst_levels=3 splits the same fused levels over more
    dispatches."""
    _jc, tc = cfgs()
    r3 = Engine(tc, chunk=64, burst_levels=3, device="cpu").check(
        max_depth=12)
    r16 = Engine(tc, chunk=64, device="cpu").check(max_depth=12)
    assert r3.levels_fused == r16.levels_fused == 12
    assert r3.burst_dispatches == 4 and r16.burst_dispatches == 1
    assert (r3.distinct_states, r3.level_sizes) == \
        (r16.distinct_states, r16.level_sizes)
