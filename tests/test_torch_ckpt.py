"""The port's checkpoints on the CPU: a run checkpointed at every level
(or after every burst) and resumed from each of those depths lands on
the uninterrupted run's counts, level sizes, violations, archives and
traces — with the burst on and off, the archives in RAM, on disk or
not kept, with 128-bit keys, and in sort mode at S=3.  The refusals
(another cfg, chunk, canonicalization mode, ``store_states``, archive
directory) carry the reference's messages: the reference's own
``ckpt_read`` gives the same text on the port's file.
"""

import os

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.bfs import CheckpointError, Engine

torch.set_num_threads(1)

BOUNDS = Bounds.make(max_log_length=1, max_timeouts=1,
                     max_client_requests=1)
# FirstBecomeLeader is first violated at depth 9 (1, 6 and 22
# violations to depths 9, 10 and 11): the later checkpoints carry some
MICRO = ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                    next_family=NEXT_ASYNC, symmetry=True,
                    max_inflight_override=4,
                    invariants=("FirstBecomeLeader",), bounds=BOUNDS)
S3 = ModelConfig(n_servers=3, init_servers=(0, 1, 2), values=(1,),
                 symmetry=True, max_inflight_override=4, bounds=BOUNDS)

CASES = {
    "burst-ram": (MICRO, dict(burst=True), "ram", 11),
    "burst-disk": (MICRO, dict(burst=True), "disk", 11),
    "burst-nostore": (MICRO, dict(burst=True), "none", 11),
    "perlevel-ram": (MICRO, dict(burst=False), "ram", 10),
    "perlevel-disk": (MICRO, dict(burst=False), "disk", 10),
    "perlevel-nostore": (MICRO, dict(burst=False), "none", 10),
    "fp128": (MICRO.with_(fp128=True), dict(burst=True), "ram", 10),
    "sort-s3": (S3, dict(sym_canon="sort", burst=False), "ram", 7),
}


def _engine(cfg, kw, store, arch_dir=None):
    return Engine(cfg, chunk=64, burst_levels=2, device="cpu",
                  store_states=store != "none",
                  archive_dir=arch_dir if store == "disk" else None, **kw)


def _summary(res):
    return (res.distinct_states, res.generated_states, res.depth,
            res.level_sizes, res.levels_fused, res.overflow_faults,
            res.violations_global, res.pin_interior_states,
            [(v.invariant, v.state_id) for v in res.violations])


def _archive(eng):
    """Every archived row, level by level, as one list of arrays."""
    if eng._arch is not None:
        a = eng._arch
        return [arr for i in range(a.n_levels) for arr in
                [a.parents(i), a.lanes(i)] +
                [a.states(i)[k] for k in sorted(a.keys)]]
    return [arr for p, lane, st in zip(eng._parents, eng._lanes,
                                       eng._states)
            for arr in [p, lane] + [st[k] for k in sorted(st)]]


@pytest.mark.parametrize("case", list(CASES))
def test_resume_from_every_depth_equals_the_uninterrupted_run(case,
                                                              tmp_path):
    cfg, kw, store, depth = CASES[case]
    arch = str(tmp_path / "arch")
    ck = str(tmp_path / "run.ckpt")
    eng = _engine(cfg, kw, store, arch)
    eng.ckpt_keep = depth + 1          # keep every checkpoint
    full = eng.check(max_depth=depth, checkpoint_path=ck,
                     checkpoint_every=1)
    want = _summary(full)
    if cfg.invariants == MICRO.invariants:
        assert len(full.violations) > 1
    rows = [a.copy() for a in _archive(eng)] if store != "none" else None
    last = eng.trace(full.distinct_states - 1) if rows else None
    if kw.get("sym_canon") == "sort":
        assert full.sym_canon == 1
    members = sorted(f for f in os.listdir(tmp_path)
                     if f.startswith("run.ckpt") and
                     not f.endswith(".sum"))
    # per level: a checkpoint at each depth 1..depth; after each burst
    # (of at most two levels) otherwise
    if kw.get("burst"):
        assert (depth + 1) // 2 <= len(members) < depth
    else:
        assert len(members) == depth
    for m in members:
        again = _engine(cfg, kw, store, arch)
        res = again.check(max_depth=depth,
                          resume_from=str(tmp_path / m))
        assert _summary(res) == want, m
        if rows is not None:
            got = _archive(again)
            assert len(got) == len(rows)
            for a, b in zip(got, rows):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
            assert again.trace(res.distinct_states - 1) == last
            for v in res.violations[:3]:
                assert again.trace(v.state_id) == eng.trace(v.state_id)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Checkpoints of MICRO at depth 5: in-RAM archives, no archives,
    and a disk archive (its directory beside it)."""
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for store in ("ram", "none", "disk"):
        path = str(d / f"{store}.ckpt")
        _engine(MICRO, {}, store, str(d / "arch")).check(
            max_depth=5, checkpoint_path=path, checkpoint_every=5)
        out[store] = path
    out["arch"] = str(d / "arch")
    return out


def _ref_message(path, **kw):
    """The reference's ckpt_read refusal for the same file and args."""
    from raft_tla_tpu.engine.bfs import CheckpointError as RefError
    from raft_tla_tpu.engine.bfs import ckpt_read
    args = dict(cfg_repr=repr(MICRO), chunk=64, extra_keys=(
        "LCAP", "VCAP", "FCAP", "OCAP", "fam_caps"), sharded=False,
        expected_format=("layout", 2, "this engine's batch-last/"
                         "narrow-dtype storage layout"),
        spec_name="raft", sym_canon="minperm")
    args.update(kw)
    with pytest.raises(RefError) as ei:
        ckpt_read(path, **args)
    return str(ei.value)


@pytest.mark.parametrize("what", ["cfg", "chunk", "sym_canon"])
def test_refusals_carry_the_reference_messages(written, what):
    path = written["ram"]
    if what == "cfg":
        other = MICRO.with_(symmetry=False)
        eng = Engine(other, chunk=64, device="cpu")
        want = _ref_message(path, cfg_repr=repr(other))
    elif what == "chunk":
        eng = Engine(MICRO, chunk=32, device="cpu")
        want = _ref_message(path, chunk=32)
    else:
        eng = Engine(MICRO, chunk=64, sym_canon="sort", device="cpu")
        want = _ref_message(path, sym_canon="sort")
    with pytest.raises(CheckpointError) as ei:
        eng.check(resume_from=path)
    assert str(ei.value) == want


def test_store_and_archive_refusals(written, tmp_path):
    """A file without archives refuses a storing engine; a disk-archive
    file wants its directory; an in-RAM file refuses one; an archive
    shorter than the checkpoint is named."""
    with pytest.raises(CheckpointError) as ei:
        Engine(MICRO, chunk=64, device="cpu").check(
            resume_from=written["none"])
    assert str(ei.value) == (
        "checkpoint was written with store_states=False; resume with "
        "store_states=False (CLI: --no-store) — trace archives cannot "
        "be reconstructed")
    path = written["disk"]
    with pytest.raises(CheckpointError) as ei:
        Engine(MICRO, chunk=64, device="cpu").check(resume_from=path)
    assert str(ei.value) == (
        f"{path}: checkpoint archives live in a disk archive directory "
        "— resume with the same archive_dir (CLI: --archive-dir)")
    path = written["ram"]
    with pytest.raises(CheckpointError) as ei:
        Engine(MICRO, chunk=64, device="cpu",
               archive_dir=str(tmp_path / "a")).check(resume_from=path)
    assert str(ei.value) == (
        f"{path}: checkpoint holds in-RAM archives; resume without "
        "archive_dir")
    short = str(tmp_path / "short")
    Engine(MICRO, chunk=64, device="cpu", archive_dir=short).check(
        max_depth=2)
    with pytest.raises(CheckpointError, match="wrong archive_dir"):
        Engine(MICRO, chunk=64, device="cpu", archive_dir=short).check(
            resume_from=written["disk"])
    # the storing-off engine takes any file: no archives to restore
    res = Engine(MICRO, chunk=64, device="cpu",
                 store_states=False).check(max_depth=7,
                                           resume_from=written["ram"])
    assert res.depth == 7


def test_port_meta_and_hard_lane_counters(tmp_path):
    """The port's extra meta keys (HCAP and the sort-mode hard-lane
    counters) come back on resume: the resuming engine takes the
    checkpoint's HCAP over its own default."""
    import json
    path = str(tmp_path / "s3.ckpt")
    eng = Engine(S3, chunk=64, sym_canon="sort", burst=False, hcap=16,
                 device="cpu")
    full = eng.check(max_depth=6)
    eng.check(max_depth=4, checkpoint_path=path, checkpoint_every=4)
    meta = json.loads(str(np.load(path)["meta"]))
    assert meta["HCAP"] == eng.HCAP and meta["layout"] == 2
    assert meta["sym_canon"] == "sort" and meta["spec"] == "raft"
    assert meta["ir_fingerprint"] == eng.ir.fingerprint()
    again = Engine(S3, chunk=64, sym_canon="sort", burst=False,
                   device="cpu")
    res = again.check(max_depth=6, resume_from=path)
    assert again.HCAP == eng.HCAP
    assert (res.hard_lanes, res.hard_chunks, res.hard_chunk_max) == \
        (full.hard_lanes, full.hard_chunks, full.hard_chunk_max)
    assert _summary(res) == _summary(full)


def test_resumed_pin_interior_violations_keep_their_states(tmp_path):
    """A checkpoint keeps a violation's invariant and state id; a
    violation inside the pinned prefix (state id -1, no archive row)
    gets its state back from the cfg's pins on resume, as an
    uninterrupted run reports it."""
    pinned = ModelConfig(
        n_servers=3, init_servers=(0, 1, 2), values=(1,), symmetry=True,
        max_inflight_override=2, next_family=NEXT_ASYNC,
        prefix_pins=("CommitWhenConcurrentLeaders_unique",),
        invariants=("FirstBecomeLeader",),
        bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                           max_client_requests=2, max_terms=4))
    path = str(tmp_path / "pinned.ckpt")
    full = Engine(pinned, chunk=64, device="cpu").check(max_depth=3)
    Engine(pinned, chunk=64, device="cpu").check(
        max_depth=2, checkpoint_path=path, checkpoint_every=2)
    res = Engine(pinned, chunk=64, device="cpu").check(
        max_depth=3, resume_from=path)
    assert _summary(res) == _summary(full)
    inner = [(v.state, v.hist) for v in full.violations if v.state_id < 0]
    assert inner and inner[0][0] is not None
    assert [(v.state, v.hist) for v in res.violations
            if v.state_id < 0] == inner
