"""The port's host-partitioned visited table (``engine/host_table.py``)
against the JAX package's on keys made from a numpy seed: the home
hash, membership, the claim-insert, partition ids, level sweeps with
growth, and the checkpoint images (``state_dict``/``from_state``), read
across the two packages both ways; the bails on a full image and on a
poisoned partition, and the chaos site of the host sweep."""

import numpy as np
import pytest
import torch

from raft_tla_tpu.engine import host_table as ref
from raft_tla_tpu_torch.engine import host_table as port

torch.set_num_threads(1)

U32MAX = np.uint32(0xFFFFFFFF)


def _keys(rng, n, W):
    return np.unique(rng.integers(0, 2 ** 32 - 2, size=(n, W),
                                  dtype=np.uint64).astype(np.uint32),
                     axis=0)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("cap", [64, 1024])
def test_home_insert_member_equal_the_reference(W, cap):
    rng = np.random.default_rng(cap + W)
    keys = _keys(rng, int(0.4 * cap), W)
    assert np.array_equal(port.home_np(keys, cap), ref.home_np(keys, cap))
    imgs = []
    for mod in (port, ref):
        img = np.full((W, cap), U32MAX, np.uint32)
        mod.insert_np(img, keys)
        imgs.append(img)
    assert np.array_equal(imgs[0], imgs[1])
    misses = keys.copy()
    misses[:, 1] ^= np.uint32(1)
    probe = np.concatenate([keys, misses])
    got = port.member_np(imgs[0], probe)
    assert np.array_equal(got, ref.member_np(imgs[1], probe))
    assert got[:len(keys)].all()


@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_partition_ids_equal_the_reference(P):
    keys = _keys(np.random.default_rng(3), 1000, 2)
    got = port.HostPartitionedTable(2, partitions=P).partition_ids(keys)
    want = ref.HostPartitionedTable(2, partitions=P).partition_ids(keys)
    assert np.array_equal(got, want)
    assert got.min() >= 0 and got.max() < P
    with pytest.raises(ValueError, match="power of two"):
        port.HostPartitionedTable(2, partitions=3)


def _levels(rng, W, n_levels=5):
    """Level key batches, unique within a level, each holding some keys
    of earlier levels (the sweep must drop them)."""
    seen = np.zeros((0, W), np.uint32)
    out = []
    for i in range(n_levels):
        new = _keys(rng, 150 * (i + 1), W)
        old = seen[rng.choice(len(seen), size=min(len(seen), 40),
                              replace=False)] if len(seen) else seen
        lvl = np.unique(np.concatenate([new, old]), axis=0)
        rng.shuffle(lvl)
        out.append(lvl)
        seen = np.unique(np.concatenate([seen, new]), axis=0)
    return out


def _same_tables(a, b):
    assert (a.P, a.W, a.counts) == (b.P, b.W, b.counts)
    for p in range(a.P):
        assert np.array_equal(a.imgs[p], b.imgs[p]), p


@pytest.mark.parametrize("P", [1, 4])
def test_sweeps_and_images_equal_the_reference(P):
    """Level sweeps from 64-slot partitions: the same verdicts, the
    same growth, the same images and versions; each package's
    ``state_dict`` rebuilds in the other's ``from_state`` to the same
    images."""
    rng = np.random.default_rng(P)
    t = port.HostPartitionedTable(2, partitions=P, part_cap=1 << 6)
    r = ref.HostPartitionedTable(2, partitions=P, part_cap=1 << 6)
    for lvl in _levels(rng, 2):
        assert np.array_equal(t.sweep(lvl), r.sweep(lvl))
    _same_tables(t, r)
    assert t.vers == r.vers and t.n_keys == r.n_keys
    assert all(t.cap(p) > 1 << 6 for p in range(P))
    sd_t, sd_r = t.state_dict(), r.state_dict()
    assert sorted(sd_t) == sorted(sd_r)
    for k in sd_t:
        assert sd_t[k].dtype == sd_r[k].dtype
        assert np.array_equal(sd_t[k], sd_r[k]), k
    _same_tables(port.HostPartitionedTable.from_state(sd_r.__getitem__),
                 r)
    _same_tables(ref.HostPartitionedTable.from_state(sd_t.__getitem__),
                 t)


def test_insert_np_bails_on_a_full_image():
    rng = np.random.default_rng(7)
    for mod in (port, ref):
        img = np.full((2, 64), U32MAX, np.uint32)
        mod.insert_np(img, _keys(rng, 64, 2)[:64])
        assert not (img == U32MAX).all(axis=0).any()
        with pytest.raises(RuntimeError, match="full"):
            mod.insert_np(img, _keys(rng, 8, 2))
        with pytest.raises(RuntimeError, match="full"):
            mod.member_np(img, _keys(np.random.default_rng(99), 4, 2))


def test_device_sweep_bails_on_a_poisoned_partition():
    """A partition image with no empty slot (forced behind reserve()'s
    back): the spill engine's sweep probe must raise, never answer."""
    from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    cfg = ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                      next_family=NEXT_ASYNC, symmetry=True,
                      max_inflight_override=4,
                      bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                                         max_client_requests=1))
    eng = SpillEngine(cfg, chunk=64, seg=1 << 10, host_table=True,
                      partitions=1, part_cap=1 << 6, device="cpu")
    eng.hpt = port.HostPartitionedTable(eng.W, partitions=1,
                                        part_cap=1 << 6)
    eng.hpt.imgs[0][:] = np.uint32(0)
    eng.hpt.counts[0] = 0                 # reserve() will not grow it
    keys = np.full((4, eng.W), np.uint32(123), np.uint32)
    keys[:, 0] = np.arange(1, 5, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="full"):
        eng._sweep_level_keys(keys)


def test_host_sweep_fires_its_chaos_site():
    from raft_tla_tpu_torch.resil.chaos import (InjectedFault, install,
                                                uninstall)
    t = port.HostPartitionedTable(2, partitions=2)
    install("host_table:at=2")
    try:
        t.sweep(_keys(np.random.default_rng(1), 10, 2))
        with pytest.raises(InjectedFault):
            t.sweep(_keys(np.random.default_rng(2), 10, 2))
    finally:
        uninstall()
