"""Units of the port's spill-composed mesh and of the step-atomic mode it
turns on in ``parallel/mesh.py``, on the CPU:

- a tripped step commits on no shard: every table shard, level shard
  and generated count is as it was before the step, each shard records
  the step's cursor in ``trip_base``, and after the host's spill every
  shard resumes there;
- the step-atomic split across device groups (one group per shard, the
  path several cards take: the insert and commit programs apart, the
  trips copied between them) equals the one-device step;
- classic mode is unchanged: ``ShardedEngine`` stays per-shard, and the
  step-atomic mode forced onto it gives the same answer;
- with no mid-level spill the spill mesh equals ``ShardedEngine``;
  paxos at D = 2 equals the oracle and the classic engine;
- the refusals: the host table (ROADMAP 9b-iii) and ``devices=None``
  without CUDA; the checkpoint keywords as the reference's engine takes
  them (a file written, its errors for a missing file and for an object
  that is not a portable image);
- (slow) the reference's engine at D = 4, with mid-level spills: the
  same answer as ``test_torch_spill_mesh.py`` holds at D = 2.
"""

import json

import jax
import numpy as np
import pytest
import torch

from raft_tla_tpu.parallel.spill_mesh import \
    SpilledShardedEngine as JSpilledShardedEngine

from raft_tla_tpu_torch.engine.ckpt import CheckpointError
from raft_tla_tpu_torch.parallel.mesh import ShardedEngine
from raft_tla_tpu_torch.parallel.spill_mesh import (Z_TRIP,
                                                    SpilledShardedEngine)

from test_torch_spill_mesh import DEPTH, ENGINE, answer, cfgs, count_trips

torch.set_num_threads(1)

CPU2 = ["cpu"] * 2


def split_groups(eng):
    """One device group per shard: the step takes the several-card path
    (trips copied between the groups' programs) on the CPU."""
    eng._groups = [(dev, [d]) for d, dev in enumerate(eng.devices)]


def snapshot(eng):
    return [dict(vis=sh.vis.clone(), n_lvl=int(sh.n_lvl),
                 n_gen=int(sh.n_gen), base=int(sh.base),
                 lvl={k: v[..., :int(sh.n_lvl)].clone()
                      for k, v in sh.lvl.items()})
            for sh in eng._shards]


def test_a_tripped_step_commits_on_no_shard():
    eng = SpilledShardedEngine(cfgs()[1], devices=CPU2,
                               **dict(ENGINE, store_states=False))
    kinds = []
    step, trip = eng._lockstep, eng._handle_mesh_trip

    def checked_step():
        before = snapshot(eng)
        flags = step()
        if any(bad for _more, bad in flags):
            for sh, b in zip(eng._shards, before):
                assert torch.equal(sh.vis, b["vis"])
                assert (int(sh.n_lvl), int(sh.n_gen)) == \
                    (b["n_lvl"], b["n_gen"])
                assert all(torch.equal(v[..., :b["n_lvl"]], b["lvl"][k])
                           for k, v in sh.lvl.items())
                assert int(sh.trip_base) == b["base"]
            kinds.append(tuple(any(bool(getattr(sh, f))
                                   for sh in eng._shards)
                               for f in ("ovf", "fovf", "sovf", "hovf")))
        return flags

    def checked_trip(s, *a, **kw):
        tb = max(r[Z_TRIP] for r in s)
        trip(s, *a, **kw)
        for sh in eng._shards:
            assert int(sh.base) == tb and int(sh.n_lvl) == 0
            assert not any(bool(f) for f in sh.flags)
            assert int(sh.trip_base) == -1

    eng._lockstep, eng._handle_mesh_trip = checked_step, checked_trip
    res = eng.check(max_depth=DEPTH)
    # a level-shard overflow (inserts made, then reverted on every
    # shard) and a family-cap overflow (nothing inserted)
    assert (True, False, False, False) in kinds
    assert any(k[1] for k in kinds)
    # (a burst's tripped step bails its level instead: no host trip)
    assert len(kinds) >= eng.trips >= 4 and eng.mid_level_spills >= 3
    assert res.depth == DEPTH


def test_the_split_step_across_device_groups_equals_one_device():
    runs = []
    for split in (False, True):
        eng = SpilledShardedEngine(cfgs()[1], devices=CPU2, burst=False,
                                   **dict(ENGINE, chunk=32, lcap=512,
                                          scap=32))
        if split:
            split_groups(eng)
        res = eng.check(max_depth=DEPTH)
        runs.append(answer(eng, res, eng.trips))
    assert runs[0] == runs[1]
    assert runs[0]["spills"][0] >= 3


CLASSIC = dict(chunk=32, lcap=256, scap=8)


@pytest.fixture(scope="module")
def classic():
    eng = ShardedEngine(cfgs()[1], devices=CPU2, **CLASSIC)
    return eng, eng.check(max_depth=10)


@pytest.mark.parametrize("mode", ["atomic", "atomic_split"])
def test_classic_mode_is_unchanged(mode, classic):
    """``ShardedEngine`` keeps per-shard trips and the whole-level
    replay; the step-atomic mode forced onto it changes no answer (a
    replayed level is rolled back through its journal either way)."""
    classic, want = classic
    assert not classic._step_atomic and not classic._burst_compact_frontier
    eng = ShardedEngine(cfgs()[1], devices=CPU2, **CLASSIC)
    eng._step_atomic = True
    if mode == "atomic_split":
        split_groups(eng)
    got = eng.check(max_depth=10)
    assert answer(eng, got, 0) == answer(classic, want, 0)
    assert eng.lockstep_steps == classic.lockstep_steps


def test_without_mid_level_spills_it_equals_the_sharded_engine():
    kw = dict(chunk=64, scap=128, vcap=1 << 15)
    sm = SpilledShardedEngine(cfgs()[1], devices=CPU2, lcap=1 << 14, **kw)
    got = sm.check(max_depth=DEPTH)
    mesh = ShardedEngine(cfgs()[1], devices=CPU2, **kw)
    want = mesh.check(max_depth=DEPTH)
    assert sm.mid_level_spills == 0
    assert (got.distinct_states, got.generated_states, got.depth,
            got.level_sizes, got.violations_global) == \
        (want.distinct_states, want.generated_states, want.depth,
         want.level_sizes, want.violations_global)


def test_paxos_at_two_shards_equals_the_oracle_and_the_engine():
    """The reference's tests/test_paxos.py spill-mesh case (chunk 64,
    lcap 2^12) to the full space."""
    from raft_tla_tpu_torch.engine.bfs import Engine
    from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig
    from raft_tla_tpu_torch.spec.paxos.oracle import explore as pexplore
    cfg = PaxosConfig()
    ro = pexplore(cfg)
    r = SpilledShardedEngine(cfg, devices=CPU2, chunk=64,
                             lcap=1 << 12).check()
    rc = Engine(cfg, chunk=64, store_states=False, device="cpu").check()
    got = (r.distinct_states, r.generated_states, r.depth)
    assert got == (ro.distinct_states, ro.generated_states, ro.depth)
    assert got + (r.level_sizes,) == (rc.distinct_states,
                                      rc.generated_states, rc.depth,
                                      rc.level_sizes)


@pytest.mark.parametrize("kw", [
    dict(host_table=True), dict(checkpoint_path="x.ckpt"),
    dict(resume_from="x.ckpt"), dict(resume_image=object())],
    ids=["host_table", "checkpoint_path", "resume_from", "resume_image"])
def test_the_later_items_refuse(kw, tmp_path):
    """The host table still refuses (ROADMAP 9b-iii).  The checkpoint
    keywords do what the reference's engine does on the same call: a
    file written, and the reference's own error for a missing file and
    for an object that is not a portable image."""
    if "host_table" in kw:
        with pytest.raises(NotImplementedError, match="9b-ii"):
            SpilledShardedEngine(cfgs()[1], devices=CPU2, **kw)
        return
    eng = SpilledShardedEngine(cfgs()[1], devices=CPU2, chunk=16)
    kw = {k: str(tmp_path / v) if isinstance(v, str) else v
          for k, v in kw.items()}
    if "checkpoint_path" in kw:
        res = eng.check(max_depth=2, **kw)
        meta = json.loads(str(np.load(kw["checkpoint_path"])["meta"]))
        assert (meta["D"], meta["spill"], meta["sharded"], meta["depth"],
                meta["distinct"]) == (2, True, True, 2, res.distinct_states)
        return
    ref = JSpilledShardedEngine(cfgs()[0], devices=jax.devices()[:2],
                                chunk=16)
    with pytest.raises(Exception) as want:
        ref.check(max_depth=2, **kw)
    with pytest.raises(CheckpointError) as got:
        eng.check(max_depth=2, **kw)
    assert type(want.value).__name__ == "CheckpointError"
    assert str(got.value) == str(want.value)


def test_no_devices_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpilledShardedEngine(cfgs()[1])


@pytest.mark.slow
def test_four_shards_equal_the_reference():
    """D = 4, chunk 32, scap 32 (256 level rows a shard, 128 usable):
    levels 12-14 spill mid-level.  Slow: the reference's engine at D = 4
    compiles for over a minute on a cold cache (chip_smoke.py phase 22b
    holds D = 4 against the reference's pinned config #1 answer)."""
    kw = dict(ENGINE, chunk=32, lcap=1024, scap=32, vcap=1 << 16)
    je = JSpilledShardedEngine(cfgs()[0], devices=jax.devices()[:4],
                               dedup_kernel="on", burst=False, **kw)
    jt = count_trips(je)
    want = answer(je, je.check(max_depth=DEPTH), jt[0])
    eng = SpilledShardedEngine(cfgs()[1], devices=["cpu"] * 4, burst=False,
                               **kw)
    got = answer(eng, eng.check(max_depth=DEPTH), eng.trips)
    assert got == want
    assert eng.mid_level_spills >= 3
    assert np.asarray(got["violations"]).size
