"""Shape-portable resume (``resil/portable.py``): ``load_portable_image``
in the port and in the JAX package read the same fields from files
written by the JAX classic ``Engine``, the JAX ``ShardedEngine`` on 2
forced CPU devices, the JAX ``SpillEngine`` and the port's own engines;
each image resumes on the port's ``SpillEngine`` (host table off and
on) with the uninterrupted run's counts and level sizes (and, from a
single-device source, its violations and last trace); images whose
frontier is the whole last level resume on the port's ``Engine`` too,
and a spill image, whose pruned rows are gone, is refused there with
the reference's words; so is a wrong config.  The micro config of
``tests/test_resil.py`` with FirstBecomeLeader; one JAX compile per
source engine."""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.bfs import Engine
from raft_tla_tpu_torch.engine.ckpt import CheckpointError
from raft_tla_tpu_torch.engine.spill import SpillEngine
from raft_tla_tpu_torch.resil.portable import (PortableImage,
                                               load_portable_image)

torch.set_num_threads(1)

KW = dict(n_servers=2, init_servers=(0, 1), values=(1,),
          next_family=NEXT_ASYNC, symmetry=True, max_inflight_override=4,
          invariants=("FirstBecomeLeader",))
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
DEPTH, AT = 14, 8
SPILL = dict(chunk=64, seg=1 << 10, vcap=1 << 12, sync_every=2,
             store_states=True)
HPT = dict(SPILL, host_table=True, part_cap=1 << 6, dev_keys=64)


def _cfgs():
    jc = JC(bounds=JB.make(**BOUNDS), **KW)
    tc = ModelConfig(bounds=Bounds.make(**BOUNDS), **KW)
    assert repr(jc) == repr(tc)
    return jc, tc


def _counts(res):
    return (res.distinct_states, res.generated_states, res.depth,
            list(res.level_sizes), res.violations_global)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Checkpoints at AT from every source engine, and the port's
    uninterrupted answer to DEPTH."""
    import jax
    from raft_tla_tpu.engine.bfs import Engine as JEngine
    from raft_tla_tpu.engine.spill import SpillEngine as JSpill
    from raft_tla_tpu.parallel.mesh import ShardedEngine
    d = tmp_path_factory.mktemp("portable")
    jc, tc = _cfgs()
    out = {k: str(d / f"{k}.ckpt") for k in
           ("jax_engine", "jax_sharded", "jax_spill", "port_engine",
            "port_spill")}
    for name, eng in (
            ("jax_engine", JEngine(jc, chunk=64, burst=False)),
            ("jax_sharded", ShardedEngine(jc, devices=jax.devices()[:2],
                                          chunk=16, burst=False)),
            ("jax_spill", JSpill(jc, burst=False, **SPILL)),
            ("port_engine", Engine(tc, chunk=64, device="cpu")),
            ("port_spill", SpillEngine(tc, device="cpu", **SPILL))):
        eng.check(max_depth=AT, checkpoint_path=out[name],
                  checkpoint_every=AT)
    full = Engine(tc, chunk=64, device="cpu")
    res = full.check(max_depth=DEPTH)
    return out, dict(counts=_counts(res),
                     viol=[(v.invariant, v.state_id)
                           for v in res.violations],
                     trace=full.trace(res.distinct_states - 1))


SOURCES = ("jax_engine", "jax_sharded", "jax_spill", "port_engine",
           "port_spill")


@pytest.mark.parametrize("src", SOURCES)
def test_images_equal_the_reference_loader(files, src):
    from raft_tla_tpu.resil.portable import load_portable_image as jload
    paths, _want = files
    got, want = load_portable_image(paths[src]), jload(paths[src])
    for k in ("spec", "cfg_repr", "depth", "n_states", "store_states",
              "disk_archive_levels", "source_format"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("keys", "gids", "con"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert sorted(got.rows) == sorted(want.rows)
    for k in got.rows:
        assert got.rows[k].dtype == want.rows[k].dtype
        assert np.array_equal(got.rows[k], want.rows[k]), k
    for a, b in ((got.parents, want.parents), (got.lanes, want.lanes)):
        assert len(a) == len(b) == AT + 1
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for x, y in zip(got.states, want.states):
        assert all(np.array_equal(x[k], y[k]) for k in y)
    g, w = got.res, want.res
    assert (g.distinct_states, g.generated_states, list(g.level_sizes),
            g.violations_global, [(v.invariant, v.state_id)
                                  for v in g.violations]) == \
        (w.distinct_states, w.generated_states, list(w.level_sizes),
         w.violations_global, [(v.invariant, v.state_id)
                               for v in w.violations])
    assert got.n_vis == got.res.distinct_states


@pytest.mark.parametrize("target", ["spill", "hpt", "engine"])
@pytest.mark.parametrize("src", SOURCES)
def test_images_resume_with_the_uninterrupted_answer(files, src, target):
    paths, want = files
    _jc, tc = _cfgs()
    img = load_portable_image(paths[src])
    if target == "engine":
        eng = Engine(tc, chunk=64, device="cpu")
        if src.endswith("spill"):
            # the spill engines drop constraint-pruned rows from the
            # frontier: the classic layout cannot hold it
            with pytest.raises(CheckpointError,
                               match="gids are not contiguous"):
                eng.check(max_depth=DEPTH, resume_image=img)
            return
    else:
        eng = SpillEngine(tc, device="cpu",
                          **(HPT if target == "hpt" else SPILL))
    res = eng.check(max_depth=DEPTH, resume_image=img)
    assert _counts(res) == want["counts"]
    if src != "jax_sharded":
        # gids follow the frontier's order, which a single device keeps
        assert [(v.invariant, v.state_id)
                for v in res.violations] == want["viol"]
        assert eng.trace(res.distinct_states - 1) == want["trace"]
    if target == "hpt":
        assert eng.hpt.n_keys == res.distinct_states


def test_wrong_images_are_refused_with_the_reference_words(files):
    from raft_tla_tpu.resil.portable import load_portable_image as jload
    from raft_tla_tpu.resil.portable import validate_image as jvalidate
    from raft_tla_tpu_torch.resil.portable import validate_image
    paths, _want = files
    jc, tc = _cfgs()
    img = load_portable_image(paths["port_engine"])
    jimg = jload(paths["port_engine"])
    img.cfg_repr = jimg.cfg_repr = "nope"
    msgs = []
    for fn, im, cfg in ((validate_image, img, tc), (jvalidate, jimg, jc)):
        with pytest.raises(Exception, match="different model config") as e:
            fn(im, "raft", repr(cfg), 2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for eng in (Engine(tc, chunk=64, device="cpu"),
                SpillEngine(tc, device="cpu", **SPILL)):
        with pytest.raises(CheckpointError, match="different model config"):
            eng.check(resume_image=img)
    with pytest.raises(CheckpointError, match="must be a resil.portable"):
        validate_image(object(), "raft", repr(tc), 2)
    good = load_portable_image(paths["port_engine"])
    with pytest.raises(CheckpointError, match="fp64 vs fp128"):
        validate_image(good, "raft", repr(tc), 4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Engine(tc, chunk=64, device="cpu").check(
            resume_from=paths["port_engine"], resume_image=good)
    assert isinstance(good, PortableImage)
