"""The spill engine with the host-partitioned visited table against the
JAX package's, on ``tests/test_host_table.py``'s SQUEEZE capacities
(a 64-key device cache, so it reseeds after nearly every level and
dedup against anything older than the frontier comes from the host
partitions alone): partitions 1, 4 and 8 give the same counts; the
host table holds every distinct key and its partitions grew; the keys
it holds equal the JAX engine's, partition by partition; traces and
violations equal the oracle's.  One JAX compile for the module."""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.host_table import U32
from raft_tla_tpu_torch.engine.spill import SpillEngine

torch.set_num_threads(1)

KW = dict(n_servers=2, init_servers=(0, 1), values=(1,),
          next_family=NEXT_ASYNC, symmetry=True, max_inflight_override=4)
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
SQUEEZE = dict(chunk=64, store_states=False, seg=1 << 10, vcap=1 << 12,
               sync_every=2, host_table=True, part_cap=1 << 6,
               dev_keys=64)
DEPTH = 18


def _cfgs(**extra):
    jc = JC(bounds=JB.make(**BOUNDS), **KW, **extra)
    tc = ModelConfig(bounds=Bounds.make(**BOUNDS), **KW, **extra)
    assert repr(jc) == repr(tc)
    return jc, tc


def _counts(r):
    return (r.distinct_states, r.generated_states, r.depth,
            list(r.level_sizes), len(r.violations))


def _key_sets(hpt):
    out = []
    for img in hpt.imgs:
        occ = ~(img == U32).all(axis=0)
        out.append({tuple(k) for k in img[:, occ].T.tolist()})
    return out


@pytest.fixture(scope="module")
def jax_run():
    from raft_tla_tpu.engine.spill import SpillEngine as JSpill
    jc, _tc = _cfgs()
    je = JSpill(jc, partitions=4, burst=False, **SQUEEZE)
    res = je.check(max_depth=DEPTH)
    return _counts(res), _key_sets(je.hpt)


@pytest.mark.parametrize("P", [1, 4, 8])
def test_partition_count_invariance(jax_run, P):
    want, want_keys = jax_run
    _jc, tc = _cfgs()
    eng = SpillEngine(tc, partitions=P, device="cpu", **SQUEEZE)
    res = eng.check(max_depth=DEPTH)
    assert _counts(res) == want
    assert eng.hpt.n_keys == res.distinct_states
    assert any(eng.hpt.cap(p) > 1 << 6 for p in range(P))
    assert eng.reseeds > 0
    if P == 4:
        # the same key set in each partition (the slots may differ: the
        # device cache's placement is the kernel's, not the lax walk's)
        assert _key_sets(eng.hpt) == want_keys
    assert set().union(*_key_sets(eng.hpt)) == set().union(*want_keys)


def test_host_table_matches_the_oracle(jax_run):
    from conftest import cached_explore
    jc, _tc = _cfgs()
    ref = cached_explore(jc, max_depth=DEPTH)
    assert jax_run[0] == (ref.distinct_states, ref.generated_states,
                          ref.depth, list(ref.level_sizes),
                          len(ref.violations))


def test_traces_and_violations_equal_the_oracle():
    """store_states with the host table: the first FirstBecomeLeader
    witness has the oracle's length and the oracle replays it."""
    from conftest import cached_explore
    from raft_tla_tpu_torch.models.explore import oracle_validates_walk
    jc, tc = _cfgs(invariants=("FirstBecomeLeader",))
    want = cached_explore(jc, stop_on_violation=True,
                          trace_violations=True)
    eng = SpillEngine(tc, partitions=4, device="cpu",
                      **dict(SQUEEZE, store_states=True))
    res = eng.check(stop_on_violation=True)
    assert res.violations and want.violations
    v = res.violations[0]
    assert v.invariant == want.violations[0].invariant
    assert res.depth == want.depth
    tr = eng.trace(v.state_id)
    assert len(tr) - 1 == len(want.violations[0].trace)
    labels = oracle_validates_walk(tc, [sv for _l, sv in tr])
    assert len(labels) == len(tr) - 1


def test_sweep_staging_is_counted_and_exact(jax_run):
    """With staging off every sweep uploads inline; the counts are the
    same either way, and staging serves some sweeps from its prestage."""
    _jc, tc = _cfgs()
    got = {}
    for stage in (True, False):
        eng = SpillEngine(tc, partitions=4, sweep_stage=stage,
                          device="cpu", **SQUEEZE)
        got[stage] = (_counts(eng.check(max_depth=DEPTH)),
                      eng.sweep_stage_hits, eng.sweep_stage_misses)
    assert got[True][0] == got[False][0] == jax_run[0]
    assert got[True][1] > 0
    assert got[False][1:] == (0, 0)
    assert np.sum(got[True][1:]) > 0
