"""Checkpoints and resumes of the port's spill-composed mesh
(``raft_tla_tpu_torch/parallel/spill_mesh.py``) on ``["cpu"] * 2``,
against the reference's ``SpilledShardedEngine`` on 2 of its 8 virtual
CPU devices, at zero tolerance:

- MICRO as ``tests/test_resil.py`` runs it (chunk 16, lcap 2^10, two
  levels a burst): a file written at depth 4, after a fused burst,
  resumes to depth 6 on the answer of the uninterrupted run and of the
  reference's (counts, level sizes, parents, lanes, state rows,
  traces); each package resumes the other's file; the two files are
  equal array for array and meta key for meta key (the port adds its
  HCAP); the rebuilt table shards are the reference's images slot for
  slot; the burst's file is the per-level driver's; supervised chaos
  at ``dispatch:at=2`` recovers; the disk archive reattaches;
- ``test_torch_spill_mesh.py``'s squeezed shards, where levels 12-14
  spill mid-level: a file at depth 13 between two spilled levels;
- portable images both ways (the classic engine, ``ShardedEngine`` at
  D = 2 and the spill mesh at D = 4), the loader's three refusals and
  the reference's constructor keywords.

The reference runs its dedup kernel in interpret mode
(``dedup_kernel="on"``), whose slots the port's kernel keeps, so the
files' key arrays compare in order.
"""

import json

import jax
import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC
from raft_tla_tpu.config import NEXT_ASYNC as JNA
from raft_tla_tpu.parallel.spill_mesh import \
    SpilledShardedEngine as JSpilledShardedEngine

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.convert import words_to_numpy
from raft_tla_tpu_torch.engine.bfs import Engine
from raft_tla_tpu_torch.engine.ckpt import CheckpointError
from raft_tla_tpu_torch.engine.spill import SpillEngine
from raft_tla_tpu_torch.parallel.mesh import ShardedEngine
from raft_tla_tpu_torch.parallel.spill_mesh import SpilledShardedEngine
from raft_tla_tpu_torch.resil import chaos
from raft_tla_tpu_torch.resil.ckpt_chain import publish
from raft_tla_tpu_torch.resil.portable import load_portable_image
from raft_tla_tpu_torch.resil.supervisor import supervised_check

import test_torch_spill_mesh as squeezed

torch.set_num_threads(1)

KW = dict(n_servers=2, init_servers=(0, 1), values=(1,), symmetry=True,
          max_inflight_override=4)
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
MICRO_ENGINE = dict(chunk=16, store_states=True, lcap=1 << 10,
                    burst_levels=2)
D, AT, DEPTH = 2, 4, 6
CPU2 = ["cpu"] * D
# the squeezed shards: levels 12-14 spill mid-level
SQ_AT, SQ_DEPTH = 13, 14


def micro_cfgs():
    jc = JC(next_family=JNA, bounds=JB.make(**BOUNDS), **KW)
    tc = ModelConfig(next_family=NEXT_ASYNC, bounds=Bounds.make(**BOUNDS),
                     **KW)
    assert repr(jc) == repr(tc)
    return jc, tc


def summary(eng, res):
    """Everything a resume must keep: counts, level sizes, violations by
    (invariant, id), the archives and two witness traces."""
    n = res.distinct_states
    return dict(
        counts=(n, res.generated_states, res.depth, list(res.level_sizes),
                res.overflow_faults, res.violations_global),
        violations=[(v.invariant, v.state_id) for v in res.violations],
        parents=np.concatenate(eng._parents).tolist(),
        lanes=np.concatenate(eng._lanes).tolist(),
        rows={k: np.concatenate([s[k] for s in eng._states]).tolist()
              for k in eng._states[0]},
        traces=[[lbl for lbl, _sv in eng.trace(g)] for g in (n // 2, n - 1)])


def spills_of(eng, fn):
    """(fn's result, mid-level spills during it): the engines count
    across checks."""
    before = eng.mid_level_spills
    out = fn()
    return out, eng.mid_level_spills - before


def port_engine(cfg=None, devices=CPU2, **kw):
    return SpilledShardedEngine(cfg or micro_cfgs()[1], devices=devices,
                                **dict(MICRO_ENGINE, **kw))


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """The reference's uninterrupted answer at DEPTH, its file at AT, and
    the port's file at AT (both after a fused burst)."""
    tmp = tmp_path_factory.mktemp("smckpt")
    jc, _tc = micro_cfgs()
    je = JSpilledShardedEngine(jc, devices=jax.devices()[:D],
                               dedup_kernel="on", **MICRO_ENGINE)
    want = summary(je, je.check(max_depth=DEPTH))
    out = dict(je=je, want=want, jax=str(tmp / "jax.ckpt"),
               port=str(tmp / "port.ckpt"), tmp=tmp)
    je.check(max_depth=AT, checkpoint_path=out["jax"], checkpoint_every=1)
    port_engine().check(max_depth=AT, checkpoint_path=out["port"],
                        checkpoint_every=1)
    return out


def meta_of(path):
    return json.loads(str(np.load(path)["meta"]))


def test_a_resumed_run_equals_the_uninterrupted_one(micro):
    eng = port_engine()
    assert summary(eng, eng.check(max_depth=DEPTH)) == micro["want"]
    res = eng.check(max_depth=DEPTH, resume_from=micro["port"])
    assert summary(eng, res) == micro["want"]
    assert sum(len(p) for p in eng._parents) == res.distinct_states


@pytest.mark.parametrize("direction", ["reference_file_in_port",
                                       "port_file_in_reference"])
def test_each_package_resumes_the_others_file(micro, direction):
    if direction == "reference_file_in_port":
        eng = port_engine()
        res = eng.check(max_depth=DEPTH, resume_from=micro["jax"])
    else:
        eng = micro["je"]
        res = eng.check(max_depth=DEPTH, resume_from=micro["port"])
    assert summary(eng, res) == micro["want"]


def assert_same_files(jpath, ppath):
    zj, zp = np.load(jpath), np.load(ppath)
    assert sorted(zj.files) == sorted(zp.files)
    for k in zj.files:
        if k != "meta":
            assert zj[k].dtype == zp[k].dtype, k
            assert np.array_equal(zj[k], zp[k]), k
    mj, mp = meta_of(jpath), meta_of(ppath)
    assert set(mp) - set(mj) == {"HCAP"}
    assert {k: mp[k] for k in mj} == mj


def test_the_two_files_are_equal(micro):
    assert_same_files(micro["jax"], micro["port"])
    meta = meta_of(micro["port"])
    # written after a fused burst, on a mesh of D shards
    assert meta["levels_fused"] > 0 and meta["depth"] == AT
    assert (meta["D"], meta["sm_format"], meta["spill"],
            meta["sharded"]) == (D, 1, True, True)


def test_the_burst_file_equals_the_per_level_drivers(micro):
    """The compacting burst's post-burst frontier is the per-level
    driver's, so are the files (the burst counters aside)."""
    path = str(micro["tmp"] / "per_level.ckpt")
    port_engine(burst=False).check(max_depth=AT, checkpoint_path=path,
                                   checkpoint_every=AT)
    zb, zl = np.load(micro["port"]), np.load(path)
    assert sorted(zb.files) == sorted(zl.files)
    for k in zb.files:
        if k != "meta":
            assert np.array_equal(zb[k], zl[k]), k
    mb, ml = meta_of(micro["port"]), meta_of(path)
    assert ml["levels_fused"] == 0
    burst = ("levels_fused", "burst_dispatches", "burst_bailouts")
    assert {k: v for k, v in mb.items() if k not in burst} == \
        {k: v for k, v in ml.items() if k not in burst}


def test_rebuilt_table_shards_equal_the_reference_images(micro):
    """The slot layout is not in the file: both packages rebuild it with
    insert_np over the keys in the file's order."""
    for path in (micro["jax"], micro["port"]):
        carry = micro["je"]._load_spill_mesh_checkpoint(path)[0]
        eng = port_engine()
        _res, _front, _n, n_vis, _depth = \
            eng._load_spill_mesh_checkpoint(path)
        assert n_vis.tolist() == meta_of(path)["n_vis"]
        for d, sh in enumerate(eng._shards):
            got = words_to_numpy(sh.vis)
            for w in range(eng.W):
                assert np.array_equal(got[w], np.asarray(carry["vis"][w])[d])


def test_supervised_chaos_at_dispatch_recovers(micro):
    eng = port_engine()
    ck = str(micro["tmp"] / "chaos.ckpt")
    chaos.install("dispatch:at=2")
    try:
        res, eng2, attempts = supervised_check(
            lambda: eng, retries=1, backoff=0.01, checkpoint_path=ck,
            checkpoint_every=1, max_depth=DEPTH, sleep=lambda s: None,
            reinit=False)
    finally:
        chaos.uninstall()
    assert attempts == 2 and eng2 is eng
    assert summary(eng, res) == micro["want"]


def test_the_disk_archive_reattaches(micro):
    arch = str(micro["tmp"] / "arch")
    path = str(micro["tmp"] / "disk.ckpt")
    port_engine(archive_dir=arch).check(max_depth=AT, checkpoint_path=path,
                                        checkpoint_every=1)
    assert meta_of(path)["disk_archive"]
    eng = port_engine(archive_dir=arch)
    res = eng.check(max_depth=DEPTH, resume_from=path)
    a = eng._arch
    assert a is not None and a.total_rows == res.distinct_states
    assert np.concatenate([a.parents(i) for i in range(a.n_levels)]
                          ).tolist() == micro["want"]["parents"]
    n = res.distinct_states
    assert [[lbl for lbl, _ in eng.trace(g)] for g in (n // 2, n - 1)] == \
        micro["want"]["traces"]


@pytest.fixture(scope="module")
def spilled(tmp_path_factory):
    """The squeezed shards: the reference's file at SQ_AT (level 13
    spilled mid-level) and its resume to SQ_DEPTH (level 14 did too)."""
    tmp = tmp_path_factory.mktemp("smspill")
    jc, _tc = squeezed.cfgs()
    je = JSpilledShardedEngine(jc, devices=jax.devices()[:D],
                               dedup_kernel="on", burst=False,
                               **squeezed.ENGINE)
    path = str(tmp / "jax.ckpt")
    _r, before = spills_of(je, lambda: je.check(
        max_depth=SQ_AT, checkpoint_path=path, checkpoint_every=SQ_AT))
    res, after = spills_of(je, lambda: je.check(max_depth=SQ_DEPTH,
                                                resume_from=path))
    assert before > 0 and after > 0
    return dict(je=je, jax=path, port=str(tmp / "port.ckpt"),
                want=summary(je, res), spills=(before, after))


def test_mid_level_spills_on_both_sides_of_the_checkpoint(spilled):
    def engine():
        return SpilledShardedEngine(squeezed.cfgs()[1], devices=CPU2,
                                    burst=False, **squeezed.ENGINE)
    eng = engine()
    full = summary(eng, eng.check(max_depth=SQ_DEPTH))
    assert full == spilled["want"]
    _r, before = spills_of(eng, lambda: eng.check(
        max_depth=SQ_AT, checkpoint_path=spilled["port"],
        checkpoint_every=SQ_AT))
    assert_same_files(spilled["jax"], spilled["port"])
    for path in (spilled["port"], spilled["jax"]):
        eng = engine()
        res, after = spills_of(eng, lambda: eng.check(
            max_depth=SQ_DEPTH, resume_from=path))
        assert summary(eng, res) == full
        assert (before, after) == spilled["spills"]
    je = spilled["je"]
    assert summary(je, je.check(max_depth=SQ_DEPTH,
                                resume_from=spilled["port"])) == full


def counts(res):
    return (res.distinct_states, res.generated_states, res.depth,
            list(res.level_sizes), res.violations_global)


@pytest.mark.parametrize("source", ["classic", "sharded"])
def test_portable_images_onto_the_spill_mesh(micro, source):
    """A classic file and a D = 2 ShardedEngine file at depth 5 resume
    on the spill mesh to the uninterrupted classic run's answer (the
    reference's tests/test_resil.py case)."""
    _jc, tc = micro_cfgs()
    classic = Engine(tc, chunk=64, burst_levels=2, device="cpu")
    want = counts(classic.check(max_depth=8))
    path = str(micro["tmp"] / f"{source}5.ckpt")
    src = classic if source == "classic" else ShardedEngine(
        tc, devices=CPU2, chunk=16, store_states=True, burst_levels=2)
    src.check(max_depth=5, checkpoint_path=path)
    img = load_portable_image(path)
    assert img.source_format == ("engine" if source == "classic"
                                 else "sharded")
    eng = port_engine()
    res = eng.check(max_depth=8, resume_image=img)
    assert counts(res) == want
    assert sum(len(p) for p in eng._parents) == res.distinct_states


def test_the_spill_mesh_file_resumes_on_the_other_engines(micro):
    """Its image onto the spill engine, ShardedEngine, and the spill mesh
    at D = 4: the D = 2 answer.  The classic engine refuses a frontier
    whose pruned rows left gaps in the ids, as the reference's does, and
    takes a depth-1 file, which has none."""
    _jc, tc = micro_cfgs()
    want = micro["want"]["counts"][:4] + (0,)
    img = load_portable_image(micro["port"])
    assert img.source_format == "spill_mesh" and img.depth == AT
    for eng in (SpillEngine(tc, chunk=64, seg=1 << 12, store_states=True,
                            device="cpu"),
                ShardedEngine(tc, devices=CPU2, chunk=16, store_states=True),
                port_engine(devices=["cpu"] * 4)):
        res = eng.check(max_depth=DEPTH, resume_image=img)
        assert counts(res) == want, type(eng).__name__
    with pytest.raises(CheckpointError, match="gids are not contiguous"):
        Engine(tc, chunk=64, device="cpu").check(max_depth=DEPTH,
                                                 resume_image=img)
    path = str(micro["tmp"] / "depth1.ckpt")
    port_engine().check(max_depth=1, checkpoint_path=path)
    res = Engine(tc, chunk=64, device="cpu").check(
        max_depth=DEPTH, resume_image=load_portable_image(path))
    assert counts(res) == want


def rewrite_meta(src, dst, **changes):
    """A copy of a checkpoint with meta entries changed, published with
    its checksum."""
    z = np.load(src)
    data = {k: z[k] for k in z.files}
    meta = dict(json.loads(str(z["meta"])), **changes)
    data["meta"] = np.array(json.dumps(meta))
    tmp = dst + ".tmp.npz"
    np.savez(tmp, **data)
    publish(tmp, dst)
    return dst


def test_the_loaders_three_refusals(micro):
    with pytest.raises(CheckpointError, match="2-device mesh; this engine "
                                              "has 4 devices .* portable"):
        port_engine(devices=["cpu"] * 4).check(resume_from=micro["port"])
    ht = rewrite_meta(micro["port"], str(micro["tmp"] / "ht.ckpt"),
                      host_table=True, partitions=8)
    with pytest.raises(CheckpointError, match="host_table=True; resume "
                                              "with the same setting"):
        port_engine().check(resume_from=ht)
    # the host table's engine (ROADMAP 9b-iii) reaches the partitions
    # check, after the host_table one
    eng = port_engine()
    eng.host_table = True
    with pytest.raises(CheckpointError, match="8 host-table partitions; "
                                              "engine has 4"):
        eng.check(resume_from=ht)


def test_the_constructor_takes_the_references_keywords(micro):
    je = micro["je"]
    eng = port_engine(partitions=4, part_cap=4096, dev_keys=None)
    keep = ("host_table", "partitions", "part_cap", "VB0", "dev_keys")
    assert {k: getattr(eng, k) for k in keep} == \
        {k: getattr(je, k) for k in keep}
    assert summary(eng, eng.check(max_depth=DEPTH)) == micro["want"]
    eng = port_engine(partitions=8, part_cap=64, dev_keys=100)
    assert (eng.partitions, eng.part_cap, eng.dev_keys) == (8, 64, 100)
    with pytest.raises(NotImplementedError, match="9b-iii"):
        port_engine(host_table=True, partitions=4)


def test_both_resume_keywords_at_once_raise(micro):
    with pytest.raises(ValueError, match="mutually exclusive"):
        port_engine().check(resume_from=micro["port"],
                            resume_image=load_portable_image(micro["port"]))


@pytest.mark.slow
def test_four_shards_resume_the_image_as_the_reference(micro):
    """The reference's spill mesh at D = 4 (over a minute of compiling)
    against the port's, from the same D = 2 file's image."""
    jc, _tc = micro_cfgs()
    je4 = JSpilledShardedEngine(jc, devices=jax.devices()[:4],
                                dedup_kernel="on", **MICRO_ENGINE)
    from raft_tla_tpu.resil.portable import load_portable_image as jload
    want = summary(je4, je4.check(max_depth=DEPTH,
                                  resume_image=jload(micro["jax"])))
    eng = port_engine(devices=["cpu"] * 4)
    got = summary(eng, eng.check(max_depth=DEPTH,
                                 resume_image=load_portable_image(
                                     micro["jax"])))
    assert got == want
