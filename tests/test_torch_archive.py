"""The port's disk-backed trace archives (``engine/archive.py``),
mirroring tests/test_archive.py: the file format round-trips exactly,
batch-last parts stream in, attach + truncate serve a resume, the
engine's trace through the memmaps equals the in-RAM one row for row,
and a directory written by either package's ``DiskArchive`` is
byte-identical to the other's and attached by it.
"""

import json
import os

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.archive import ArchiveError, DiskArchive

torch.set_num_threads(1)

MICRO = ModelConfig(
    n_servers=2, init_servers=(0, 1), values=(1,),
    next_family=NEXT_ASYNC, symmetry=True, max_inflight_override=4,
    bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                       max_client_requests=1))


def _mk_level(rng, n, with_matrix=True):
    parents = rng.integers(-1, 50, size=n).astype(np.int32)
    lanes = rng.integers(-1, 8, size=n).astype(np.int32)
    states = {"ct": rng.integers(0, 5, size=n).astype(np.int8),
              "votes": rng.integers(0, 2, size=(n, 3)).astype(np.uint8),
              "bag": rng.integers(0, 2 ** 32, size=(n, 2, 2),
                                  dtype=np.uint32)}
    if not with_matrix:
        states.pop("votes")
    return parents, lanes, states


def test_disk_archive_roundtrip_batch_major(tmp_path):
    rng = np.random.default_rng(5)
    arch = DiskArchive(str(tmp_path / "run"))
    levels = [_mk_level(rng, n) for n in (3, 17, 1)]
    for par, lane, st in levels:
        arch.append_level(par, lane, st)
    assert arch.n_levels == 3 and arch.total_rows == 21
    for i, (par, lane, st) in enumerate(levels):
        np.testing.assert_array_equal(arch.parents(i), par)
        np.testing.assert_array_equal(arch.lanes(i), lane)
        got = arch.states(i)
        for k in st:
            np.testing.assert_array_equal(got[k], st[k])
            assert got[k].dtype == st[k].dtype
    # global-id addressing crosses level boundaries
    assert arch.locate(0) == (0, 0)
    assert arch.locate(3) == (1, 0)
    assert arch.locate(20) == (2, 0)
    with pytest.raises(IndexError):
        arch.locate(21)
    par, lane = arch.parent_lane(4)
    assert (par, lane) == (int(levels[1][0][1]), int(levels[1][1][1]))
    row = arch.state_row(5)
    np.testing.assert_array_equal(row["ct"], levels[1][2]["ct"][2])


def test_disk_archive_parts_stream_batch_last(tmp_path):
    """Parts may arrive batch-LAST and over-allocated past n; the
    archive transposes and trims per part."""
    rng = np.random.default_rng(9)
    arch = DiskArchive(str(tmp_path / "run"))
    par, lane, st = _mk_level(rng, 10)
    parts = []
    for lo, hi in ((0, 4), (4, 10)):
        pad = 3                      # over-allocated tail, must be cut
        rows = {k: np.moveaxis(
            np.concatenate([v[lo:hi], v[:pad]]), 0, -1)
            for k, v in st.items()}
        parts.append(dict(n=hi - lo, lpar=np.concatenate(
            [par[lo:hi], par[:pad]]),
            llane=np.concatenate([lane[lo:hi], lane[:pad]]),
            rows=rows))
    arch.append_level_parts(parts)
    np.testing.assert_array_equal(arch.parents(0), par)
    np.testing.assert_array_equal(arch.lanes(0), lane)
    for k, v in st.items():
        np.testing.assert_array_equal(arch.states(0)[k], v)


def test_disk_archive_attach_truncate_resume(tmp_path):
    """attach=True reopens a killed run's completed levels; truncate
    drops levels past a checkpoint and refuses an archive shorter than
    the checkpoint expects."""
    rng = np.random.default_rng(13)
    root = str(tmp_path / "run")
    arch = DiskArchive(root)
    levels = [_mk_level(rng, n) for n in (4, 6, 5)]
    for par, lane, st in levels:
        arch.append_level(par, lane, st)
    re = DiskArchive(root, attach=True)
    assert re.level_rows == [4, 6, 5]
    re.truncate(1)
    assert re.n_levels == 1 and not os.path.exists(
        os.path.join(root, "lvl0001.parents.npy"))
    np.testing.assert_array_equal(re.parents(0), levels[0][0])
    with pytest.raises(ArchiveError, match="wrong"):
        re.truncate(3)
    with pytest.raises(ArchiveError, match="not a readable"):
        DiskArchive(str(tmp_path / "nope"), attach=True)
    # meta is rewritten atomically: no .tmp survives a clean append
    assert not os.path.exists(os.path.join(root, "meta.json.tmp"))
    assert json.load(open(os.path.join(root, "meta.json")))[
        "level_rows"] == [4]


def test_archive_directories_are_byte_compatible(tmp_path):
    """The same levels through the port's and the reference's
    DiskArchive give byte-identical files, and each package attaches
    the other's directory (and appends after its levels)."""
    from raft_tla_tpu.engine.archive import DiskArchive as RefArchive
    rng = np.random.default_rng(21)
    levels = [_mk_level(rng, n) for n in (2, 9, 4)]
    roots = {name: str(tmp_path / name) for name in ("port", "ref")}
    for name, cls in (("port", DiskArchive), ("ref", RefArchive)):
        arch = cls(roots[name])
        for par, lane, st in levels[:2]:
            arch.append_level(par, lane, st)
    names = sorted(os.listdir(roots["port"]))
    assert names == sorted(os.listdir(roots["ref"]))
    for f in names:
        with open(os.path.join(roots["port"], f), "rb") as a, \
                open(os.path.join(roots["ref"], f), "rb") as b:
            assert a.read() == b.read(), f
    # each attaches the other's directory, appends a level, reads all
    for name, cls in (("port", RefArchive), ("ref", DiskArchive)):
        arch = cls(roots[name], attach=True)
        arch.append_level(*levels[2])
        assert arch.level_rows == [2, 9, 4]
        for i, (par, _lane, st) in enumerate(levels):
            np.testing.assert_array_equal(arch.parents(i), par)
            for k in st:
                np.testing.assert_array_equal(arch.states(i)[k], st[k])


def test_engine_trace_roundtrip_disk_vs_ram(tmp_path):
    """A violation trace through the memmap'd per-level files equals
    the in-RAM archive's: labels, states and every archived row, in the
    storage dtypes."""
    from raft_tla_tpu_torch.engine.bfs import Engine
    cfg = MICRO.with_(invariants=("FirstBecomeLeader",))
    e_ram = Engine(cfg, chunk=64, store_states=True, device="cpu")
    r_ram = e_ram.check(stop_on_violation=True)
    e_dsk = Engine(cfg, chunk=64, store_states=True, device="cpu",
                   archive_dir=str(tmp_path / "arch"))
    r_dsk = e_dsk.check(stop_on_violation=True)
    assert r_dsk.distinct_states == r_ram.distinct_states
    assert r_dsk.violations[0].state_id == r_ram.violations[0].state_id
    # the disk engine holds no in-RAM archive: rows live on disk only
    assert e_dsk._states == [] and e_dsk._parents == []
    assert e_dsk._arch.total_rows == r_dsk.distinct_states
    gid = r_dsk.violations[0].state_id
    tr_ram, tr_dsk = e_ram.trace(gid), e_dsk.trace(gid)
    assert [lbl for lbl, _s in tr_dsk] == [lbl for lbl, _s in tr_ram]
    assert [s for _l, s in tr_dsk] == [s for _l, s in tr_ram]
    for g in range(r_dsk.distinct_states):
        ram_row = e_ram.get_state_arrays(g)
        dsk_row = e_dsk.get_state_arrays(g)
        for k in ram_row:
            np.testing.assert_array_equal(ram_row[k], dsk_row[k])
            assert ram_row[k].dtype == dsk_row[k].dtype
    assert e_dsk._arch.states(0)["bag"].dtype == np.uint32
