"""One checkpoint file, two engines: a checkpoint the JAX package's
Engine writes resumes in the port, and one the port writes resumes in
the JAX Engine, both landing on the uninterrupted run's counts, level
sizes, violations and traces.  The port's file has the JAX file's leaf
set, shapes and dtypes at the same depth, and its visited table is
bit-equal to the one the JAX engine builds with its Pallas dedup
kernel (``dedup_kernel="on"``, interpret mode on the CPU: the lax form
the CPU otherwise runs may place contended keys elsewhere).  A disk
archive directory written by either engine is attached by the other.
One JAX engine compile for the module.
"""

import json

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC

from raft_tla_tpu_torch.config import Bounds, ModelConfig
from raft_tla_tpu_torch.engine.bfs import Engine

torch.set_num_threads(1)

KW = dict(n_servers=2, init_servers=(0, 1), values=(1,),
          max_inflight_override=4, symmetry=True,
          invariants=("FirstBecomeLeader",))
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
DEPTH, AT = 11, 6        # the run's depth, the checkpoint's


def _cfgs():
    jc = JC(bounds=JB.make(**BOUNDS), **KW)
    tc = ModelConfig(bounds=Bounds.make(**BOUNDS), **KW)
    assert repr(jc) == repr(tc)      # ckpt_read's config check
    return jc, tc


def _summary(res):
    """The answer (the burst counters count the run's own path: a resumed
    per-level run fuses fewer levels)."""
    return (res.distinct_states, res.generated_states, res.depth,
            list(res.level_sizes), res.overflow_faults,
            res.violations_global,
            [(v.invariant, v.state_id) for v in res.violations])


def _traces(eng, res):
    gids = [v.state_id for v in res.violations[:3]] + \
        [res.distinct_states - 1]
    return [eng.trace(g) for g in gids]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX engine, its uninterrupted run to DEPTH and its checkpoint
    at AT; the port's checkpoints at AT (burst and per-level)."""
    from raft_tla_tpu.engine.bfs import Engine as JEngine
    d = tmp_path_factory.mktemp("cross")
    jc, tc = _cfgs()
    je = JEngine(jc, chunk=64, dedup_kernel="on")
    full = je.check(max_depth=DEPTH)
    out = dict(je=je, dir=d, want=_summary(full),
               traces=_traces(je, full))
    assert len(full.violations) > 1
    je.ckpt_keep = 1
    out["jax"] = str(d / "jax.ckpt")
    je.check(max_depth=AT, checkpoint_path=out["jax"], checkpoint_every=AT)
    for name, burst in (("port", True), ("port_pl", False)):
        out[name] = str(d / f"{name}.ckpt")
        Engine(tc, chunk=64, burst=burst, device="cpu").check(
            max_depth=AT, checkpoint_path=out[name], checkpoint_every=AT)
    return out


def test_uninterrupted_runs_agree(run):
    eng = Engine(_cfgs()[1], chunk=64, device="cpu")
    res = eng.check(max_depth=DEPTH)
    assert _summary(res) == run["want"]
    assert _traces(eng, res) == run["traces"]


@pytest.mark.parametrize("burst", [True, False], ids=["burst", "perlevel"])
def test_jax_checkpoint_resumes_in_the_port(run, burst):
    eng = Engine(_cfgs()[1], chunk=64, burst=burst, device="cpu")
    res = eng.check(max_depth=DEPTH, resume_from=run["jax"])
    assert _summary(res) == run["want"]
    assert _traces(eng, res) == run["traces"]


@pytest.mark.parametrize("name", ["port", "port_pl"])
def test_port_checkpoint_resumes_in_jax(run, name):
    je = run["je"]
    res = je.check(max_depth=DEPTH, resume_from=run[name])
    assert _summary(res) == run["want"]
    assert _traces(je, res) == run["traces"]


def test_port_file_has_the_jax_leaf_set(run):
    zj, zp = np.load(run["jax"]), np.load(run["port"])
    leaves = {k: (zj[k].shape, zj[k].dtype) for k in zj.files
              if k != "meta"}
    assert {k: (zp[k].shape, zp[k].dtype) for k in zp.files
            if k != "meta"} == leaves
    assert sum(k.startswith("carry|") for k in leaves) == 55
    assert leaves["carry|vis|0"][1] == np.uint32
    assert leaves["carry|front|bag"][1] == np.uint32
    assert leaves["carry|n_front"] == ((), np.int32)
    mj, mp = (json.loads(str(z["meta"])) for z in (zj, zp))
    port_only = {"HCAP", "hard_lanes", "hard_chunks", "hard_chunk_max",
                 "hcovf"}
    assert set(mp) == set(mj) | port_only
    assert {k: mp[k] for k in mj} == mj
    # the in-RAM archives: the same rows in the same dtypes
    for k in zj.files:
        if k.split("|")[0] in ("parents", "lanes", "states"):
            np.testing.assert_array_equal(zp[k], zj[k])


@pytest.mark.parametrize("name", ["port", "port_pl"])
def test_table_is_bit_equal_to_the_kernel_placement(run, name):
    zj, zp = np.load(run["jax"]), np.load(run[name])
    for w in range(2):
        np.testing.assert_array_equal(zp[f"carry|vis|{w}"],
                                      zj[f"carry|vis|{w}"])
    n = int(zj["carry|n_front"])
    for k in ("n_front", "g_off", "pg_off"):
        assert int(zp[f"carry|{k}"]) == int(zj[f"carry|{k}"])
    np.testing.assert_array_equal(zp["carry|fmask"], zj["carry|fmask"])
    for k in zj.files:
        if k.startswith("carry|front|"):
            np.testing.assert_array_equal(zp[k][..., :n], zj[k][..., :n])


def test_disk_archives_cross_between_the_engines(run):
    """A checkpoint with its archive directory, written by either engine,
    resumes in the other through that directory."""
    je, d = run["je"], run["dir"]
    tc = _cfgs()[1]
    # JAX writes, the port attaches
    je.archive_dir = str(d / "arch_jax")
    try:
        je.check(max_depth=AT, checkpoint_path=str(d / "jd.ckpt"),
                 checkpoint_every=AT)
        eng = Engine(tc, chunk=64, archive_dir=je.archive_dir,
                     device="cpu")
        res = eng.check(max_depth=DEPTH, resume_from=str(d / "jd.ckpt"))
        assert eng._arch is not None and eng._parents == []
        assert _summary(res) == run["want"]
        assert _traces(eng, res) == run["traces"]
        # the port writes, JAX attaches
        arch = str(d / "arch_port")
        Engine(tc, chunk=64, archive_dir=arch, device="cpu").check(
            max_depth=AT, checkpoint_path=str(d / "pd.ckpt"),
            checkpoint_every=AT)
        je.archive_dir = arch
        res = je.check(max_depth=DEPTH, resume_from=str(d / "pd.ckpt"))
        assert je._arch is not None
        assert _summary(res) == run["want"]
        assert _traces(je, res) == run["traces"]
    finally:
        je.archive_dir = None


def test_ir_fingerprint_equals_the_reference():
    """Checkpoint meta and the stats line carry the spec's IR
    fingerprint: both packages hash the same description."""
    from raft_tla_tpu.spec import get_spec as ref_spec

    from raft_tla_tpu_torch.spec import get_spec
    assert get_spec("raft").fingerprint() == \
        ref_spec("raft").fingerprint() == "4837e08bf0b6"
