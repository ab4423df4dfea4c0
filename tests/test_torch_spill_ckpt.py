"""Spill checkpoints across the two packages, with the host table off
and on: a file the JAX ``SpillEngine`` writes resumes in the port's,
and one the port writes resumes in the JAX engine, both landing on the
uninterrupted run's answer (counts, level sizes, violations, traces).
The two files have the same leaf set, dtypes and meta keys (the table's
slots may differ: the port places keys as its kernel does).  A classic
file handed to the spill engine, and a spill file handed to the classic
engine, are refused by name.  One JAX compile per table mode."""

import json

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.bfs import Engine
from raft_tla_tpu_torch.engine.ckpt import CheckpointError
from raft_tla_tpu_torch.engine.spill import SpillEngine

torch.set_num_threads(1)

KW = dict(n_servers=2, init_servers=(0, 1), values=(1,),
          next_family=NEXT_ASYNC, symmetry=True, max_inflight_override=4,
          invariants=("FirstBecomeLeader",))
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
DEPTH, AT = 16, 12
MODES = {"spill": dict(chunk=64, seg=1 << 10, vcap=1 << 12, sync_every=2,
                       store_states=True),
         "hpt": dict(chunk=64, seg=1 << 10, vcap=1 << 12, sync_every=2,
                     store_states=True, host_table=True, part_cap=1 << 6,
                     dev_keys=64, partitions=4)}


def _cfgs():
    jc = JC(bounds=JB.make(**BOUNDS), **KW)
    tc = ModelConfig(bounds=Bounds.make(**BOUNDS), **KW)
    assert repr(jc) == repr(tc)
    return jc, tc


def _answer(eng, res):
    return ((res.distinct_states, res.generated_states, res.depth,
             list(res.level_sizes), res.violations_global,
             [(v.invariant, v.state_id) for v in res.violations]),
            eng.trace(res.distinct_states - 1))


@pytest.fixture(scope="module", params=sorted(MODES))
def run(request, tmp_path_factory):
    """Per table mode: the JAX engine's uninterrupted answer and its
    checkpoint at AT, and the port's checkpoint at AT."""
    from raft_tla_tpu.engine.spill import SpillEngine as JSpill
    d = tmp_path_factory.mktemp(request.param)
    jc, tc = _cfgs()
    kw = MODES[request.param]
    je = JSpill(jc, burst=False, **kw)
    want = _answer(je, je.check(max_depth=DEPTH))
    out = dict(je=je, kw=kw, want=want, jax=str(d / "jax.ckpt"),
               port=str(d / "port.ckpt"))
    je.check(max_depth=AT, checkpoint_path=out["jax"], checkpoint_every=AT)
    SpillEngine(tc, device="cpu", **kw).check(
        max_depth=AT, checkpoint_path=out["port"], checkpoint_every=AT)
    return out


def test_jax_spill_file_resumes_in_the_port(run):
    _jc, tc = _cfgs()
    eng = SpillEngine(tc, device="cpu", **run["kw"])
    res = eng.check(max_depth=DEPTH, resume_from=run["jax"])
    assert _answer(eng, res) == run["want"]
    if eng.host_table:
        assert eng.hpt.n_keys == res.distinct_states


def test_port_spill_file_resumes_in_jax(run):
    je = run["je"]
    res = je.check(max_depth=DEPTH, resume_from=run["port"])
    assert _answer(je, res) == run["want"]


def test_port_spill_file_resumes_in_the_port(run):
    _jc, tc = _cfgs()
    eng = SpillEngine(tc, device="cpu", **dict(run["kw"], burst=True))
    res = eng.check(max_depth=DEPTH, resume_from=run["port"])
    assert _answer(eng, res)[0] == run["want"][0]


def test_the_files_have_the_same_leaves(run):
    zj, zp = np.load(run["jax"]), np.load(run["port"])
    assert sorted(zj.files) == sorted(zp.files)
    for k in set(zj.files) - {"meta"}:
        assert zj[k].dtype == zp[k].dtype, k
        if k.startswith(("carry|fblk", "carry|hpt", "carry|fkey",
                         "parents", "lanes", "states", "viol")):
            assert np.array_equal(zj[k], zp[k]), k
    mj, mp = (json.loads(str(z["meta"])) for z in (zj, zp))
    assert set(mj) <= set(mp)
    for k in ("spill", "depth", "n_states", "n_front", "n_fblk", "SEGF",
              "host_table", "partitions", "distinct", "level_sizes"):
        assert mj[k] == mp[k], k
    # the sparse table holds the same key set, in the kernel's slots
    kj, kp = (set(map(tuple, z["carry|vis_keys"].T.tolist()))
              for z in (zj, zp))
    assert kj == kp


def test_files_are_refused_by_the_other_engine_family(run, tmp_path):
    _jc, tc = _cfgs()
    classic = str(tmp_path / "classic.ckpt")
    Engine(tc, chunk=64, device="cpu").check(
        max_depth=4, checkpoint_path=classic, checkpoint_every=4)
    with pytest.raises(CheckpointError, match="not a SpillEngine "
                                              "checkpoint"):
        SpillEngine(tc, device="cpu", **run["kw"]).check(
            resume_from=classic)
    with pytest.raises(CheckpointError, match="host-spill checkpoint — "
                                              "resume it with SpillEngine"):
        Engine(tc, chunk=64, device="cpu").check(resume_from=run["port"])
    other = dict(run["kw"], host_table=not run["kw"].get("host_table"))
    with pytest.raises(CheckpointError, match="host_table="):
        SpillEngine(tc, device="cpu", **other).check(
            resume_from=run["port"])
