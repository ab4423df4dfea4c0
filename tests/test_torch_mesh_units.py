"""The sharded engine's pieces against the reference's on random data
made from a seed with numpy, at zero tolerance: the exchange against
``lax.all_to_all`` (tiled) and the device-major id prefix against
``lax.all_gather`` on the 8 virtual CPU devices; the chunk rounding and
its one warning; owner routing, send-window packing and ``sovf``
against the reference's sort by (owner, slot); stage 1 of the
canonical survivor against the reference's multi-key ``lax.sort`` on
windows with ties in key, content and provenance; stage 2's
replace-if-smaller comparison against the reference's u32 word loop.
The reference's formulas are restated from
``raft_tla_tpu/parallel/mesh.py`` (``_local_step``) in ``jnp``.
"""

import warnings
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from raft_tla_tpu.parallel import mesh as rmesh

from raft_tla_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)


def _shard_map(f, devs, in_specs, out_specs):
    return rmesh._shard_map(f, Mesh(np.array(devs), ("d",)), in_specs,
                            out_specs)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_exchange_equals_tiled_all_to_all(D):
    """Every field of the windows (u32 key words, int32 ids, narrow
    rows) lands where the reference's tiled all_to_all puts it, through
    one device group (the strided copy) and through D groups (the D^2
    copies between shards' devices)."""
    rng = np.random.RandomState(D)
    SC, W = 3, 2
    fields = {"a": ((2, 3), torch.int8), "b": ((), torch.int16)}
    eng = SimpleNamespace(W=W, _fields=fields)
    M = D * SC
    cpu = torch.device("cpu")
    one = tmesh._Windows(eng, [(cpu, list(range(D)))], M)
    many = tmesh._Windows(eng, [(cpu, [d]) for d in range(D)], M)
    sends = {}
    for f, v in one.send[0].items():
        info = np.iinfo(np.dtype(str(v.dtype).split(".")[-1]))
        a = rng.randint(info.min, info.max, size=tuple(v.shape),
                        dtype=np.int64).astype(str(v.dtype).split(".")[-1])
        sends[f] = a
        v.copy_(torch.from_numpy(a))
        for d in range(D):
            many.send_of[d][f].copy_(torch.from_numpy(a[d]))
    one.exchange(D)
    many.exchange(D)
    a2a = partial(lax.all_to_all, axis_name="d", split_axis=0,
                  concat_axis=0, tiled=True)
    devs = jax.devices()[:D]
    for f, a in sends.items():
        # the reference's windows are batch-major: [M, ...] per device
        bm = np.moveaxis(a, -1, 1)                     # [D, M, ...]
        got = _shard_map(lambda x: a2a(x[0])[None], devs, (P("d"),),
                         P("d"))(jnp.asarray(bm))
        want = np.moveaxis(np.asarray(got), 1, -1)
        assert np.array_equal(one.recv[0][f].numpy(), want), f
        for d in range(D):
            assert np.array_equal(many.recv_of[d][f].numpy(), want[d]), f


def test_device_major_prefix_equals_all_gather():
    """The finalize's host prefix of the shards' level counts (each
    shard's first global id past g_off) == the reference's all_gather
    exclusive cumsum."""
    rng = np.random.RandomState(3)
    nl = rng.randint(0, 50, size=8).astype(np.int32)
    devs = jax.devices()[:8]

    def f(n):
        v = lax.all_gather(n[0], "d")
        return (jnp.cumsum(v) - v)[lax.axis_index("d")][None]
    want = np.asarray(_shard_map(f, devs, (P("d"),), P("d"))(
        jnp.asarray(nl)))
    got = np.cumsum(nl) - nl
    assert np.array_equal(got, want)


def test_round_chunk_to_devices_and_its_one_warning():
    rmesh._warned_uneven_chunk = False
    tmesh._warned_uneven_chunk = False
    cases = [(512, 8), (100, 8), (17, 4), (30, 7), (64, 1), (5, 0)]
    for mod in (rmesh, tmesh):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = [mod._round_chunk_to_devices(c, d) for c, d in cases]
        msgs = [str(w.message) for w in rec]
        if mod is rmesh:
            want, want_msgs = got, msgs
        assert got == want == [512, 104, 20, 35, 64, 5]
        assert msgs == want_msgs and len(msgs) == 1
        assert "rounded up to 104 (13 frontier rows per device)" in msgs[0]


def _ref_route(owner, D, SC):
    """The reference's owner sort and window packing (_local_step)."""
    FC = owner.shape[0]
    M = D * SC
    owner = jnp.asarray(owner, jnp.int32)
    slot = jnp.arange(FC, dtype=jnp.int32)
    o_s, slot_s = lax.sort((owner, slot), num_keys=2)
    counts = jnp.sum(o_s[None, :] == jnp.arange(D)[:, None], axis=1)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(FC, dtype=jnp.int32) - \
        starts[jnp.clip(o_s, 0, D - 1)]
    live_s = o_s < D
    sovf = jnp.any(live_s & (rank >= SC))
    dest = jnp.where(live_s & (rank < SC),
                     o_s * SC + jnp.clip(rank, 0, SC - 1), M)
    sidx = jnp.full((M,), FC, jnp.int32).at[dest].set(slot_s, mode="drop")
    return np.asarray(sidx), bool(sovf)


@pytest.mark.parametrize("D,SC,FC,p_live", [
    (1, 64, 64, 0.7), (2, 8, 40, 0.5), (4, 4, 64, 0.3), (4, 2, 64, 0.6),
    (8, 3, 48, 0.9)])
def test_routing_and_send_windows_equal_the_reference(D, SC, FC, p_live):
    """Owner routing, each owner's block in buffer order, empty slots
    and the sovf trip (cases with more than SC candidates for one
    owner) == the reference's."""
    rng = np.random.RandomState(D * 100 + SC)
    for _ in range(5):
        owner = np.where(rng.rand(FC) < p_live,
                         rng.randint(0, D, FC), D).astype(np.int64)
        sidx, sovf = tmesh.route_to_owners(torch.from_numpy(owner), D, SC)
        want_sidx, want_sovf = _ref_route(owner, D, SC)
        assert np.array_equal(sidx.numpy(), want_sidx)
        assert bool(sovf) == want_sovf


def _ref_reps(keys_u32, cwords_i32, pwords_u32):
    """The reference's stage 1: lax.sort over (key words, content ^
    0x80000000, parent-fp words, lane, index), first of each key's
    run."""
    M = keys_u32.shape[1]
    W = keys_u32.shape[0]
    ops = [jnp.asarray(k) for k in keys_u32] + \
        [jnp.asarray(c).astype(jnp.uint32) ^ jnp.uint32(0x80000000)
         for c in cwords_i32] + [jnp.asarray(p) for p in pwords_u32] + \
        [jnp.arange(M, dtype=jnp.uint32)]
    srt = lax.sort(tuple(ops), num_keys=len(ops))
    s_idx = srt[-1].astype(jnp.int32)
    same_prev = jnp.ones((M - 1,), bool)
    for w in range(W):
        same_prev = same_prev & (srt[w][1:] == srt[w][:-1])
    first_run = jnp.concatenate([jnp.ones((1,), bool), ~same_prev])
    return np.asarray(jnp.zeros((M,), bool).at[s_idx].set(first_run))


def _window(rng, M, W, C, n_keys):
    """A receive window with heavy ties: few distinct keys, content,
    parent fingerprints and lanes drawn from small sets (u32 words
    across their whole range, signed content)."""
    pool = rng.randint(0, 2 ** 32, size=(n_keys, W), dtype=np.uint64)
    keys = pool[rng.randint(0, n_keys, M)].T.astype(np.uint32)
    keys[:, rng.rand(M) < 0.1] = 0xFFFFFFFF            # empty slots
    cvals = np.array([-128, -1, 0, 1, 7, 127, 2 ** 31 - 1, -2 ** 31])
    content = cvals[rng.randint(0, 4, size=(C, M))].astype(np.int32)
    ppool = rng.randint(0, 2 ** 32, size=(3, W), dtype=np.uint64)
    pfp = ppool[rng.randint(0, 3, M)].T.astype(np.uint32)
    lane = rng.choice([0, 3, 0xFFFFFFFF], size=M).astype(np.uint32)
    return keys, content, list(pfp) + [lane]


@pytest.mark.parametrize("seed", range(6))
def test_stage1_representative_equals_the_reference(seed):
    rng = np.random.RandomState(seed)
    M, W, C = 96, 2 + 2 * (seed % 2), 1 + seed
    keys, content, pw = _window(rng, M, W, C, n_keys=5 + seed)
    want = _ref_reps(keys, content, pw)
    kt = torch.from_numpy(keys.view(np.int32).copy())
    words = [torch.from_numpy(k.astype(np.int64)) for k in keys] + \
        [torch.from_numpy(c.astype(np.int64) + 2 ** 31) for c in content] + \
        [torch.from_numpy(p.astype(np.int64)) for p in pw]
    got = tmesh.canonical_reps(kt, words)
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == len({tuple(c) for c in keys.T})


@pytest.mark.parametrize("seed", range(4))
def test_stage2_replace_if_smaller_equals_the_reference(seed):
    """The candidate's (content, parent fp, lane) against the stored
    row's, word by word as the reference compares u32 words."""
    rng = np.random.RandomState(100 + seed)
    M, C = 200, 3 + seed
    _k, ca, pa = _window(rng, M, 2, C, 4)
    _k, cb, pb = _window(rng, M, 2, C, 4)
    cb[:, ::3] = ca[:, ::3]                     # equal prefixes
    ref_a = [jnp.asarray(c).astype(jnp.uint32) ^ jnp.uint32(0x80000000)
             for c in ca] + [jnp.asarray(p) for p in pa]
    ref_b = [jnp.asarray(c).astype(jnp.uint32) ^ jnp.uint32(0x80000000)
             for c in cb] + [jnp.asarray(p) for p in pb]
    less = jnp.zeros((M,), bool)
    eq = jnp.ones((M,), bool)
    for cw, sw in zip(ref_a, ref_b):
        less = less | (eq & (cw < sw))
        eq = eq & (cw == sw)

    def words(c, p):
        return [torch.from_numpy(x.astype(np.int64) + 2 ** 31)
                for x in c] + [torch.from_numpy(x.astype(np.int64))
                               for x in p]
    got = tmesh._lex_less(words(ca, pa), words(cb, pb))
    assert np.array_equal(got.numpy(), np.asarray(less))
    assert 0 < int(got.sum()) < M
