"""The model of the dedup kernel's claim rounds
(``probe_claim_insert_rounds``) held exactly against the plain
sequential twin and the reference's Pallas kernel in interpret mode
(``probe_claim_insert_pallas(..., interpret=True)``): table, fresh, pos
and hovf, on seeded and hypothesis fixtures — a same-home chain that
needs many rounds, in-batch and in-table duplicates with dead lanes, the
all-ones key (which equals an empty slot), a near-full table with an
8-step probe budget (hovf) and a rehash-shaped insert.  The CUDA kernel
runs the same rounds; ``tests/test_torch_cuda.py`` holds its ``rounds``
against this model's on the card.

The functions that make the fixtures import no JAX:
``tests/test_torch_cuda.py`` uses them on the GPU machine, which has
none.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from raft_tla_tpu_torch import convert as cvt
from raft_tla_tpu_torch.engine.fingerprint import (MAX_PROBE_ROUNDS,
                                                   probe_claim_insert_plain,
                                                   probe_claim_insert_rounds)
from raft_tla_tpu_torch.utils import fmix32_np, home_slots

torch.set_num_threads(1)

W = 2
ALL_ONES = 0xFFFFFFFF


def distinct_keys(rng, n):
    """n distinct u32 keys [W, n], never all-ones: word 1 is a bijective
    mix of a counter, so the keys differ whatever word 0 draws."""
    k = rng.randint(0, 1 << 32, size=(W, n), dtype=np.uint64)
    k = k.astype(np.uint32)
    k[1] = fmix32_np(np.arange(n, dtype=np.uint64) + rng.randint(1 << 30))
    return k


def homes(keys, vcap):
    return home_slots(cvt.words_to_torch(keys), vcap).numpy()


def same_home_keys(rng, n, vcap, home):
    """n distinct keys [W, n] whose home slot is ``home``."""
    out = np.empty((W, 0), np.uint32)
    while out.shape[1] < n:
        cand = distinct_keys(rng, 64 * vcap)
        out = np.concatenate([out, cand[:, homes(cand, vcap) == home]], 1)
    return out[:, :n]


def empty_table(vcap):
    return np.full((W, vcap), ALL_ONES, np.uint32)


def filled(table, keys):
    """``table`` with ``keys`` claim-inserted in order (the plain twin)."""
    t = cvt.words_to_torch(table)
    probe_claim_insert_plain(t, cvt.words_to_torch(keys),
                             torch.ones(keys.shape[1], dtype=torch.bool))
    return cvt.words_to_numpy(t)


def probe_path(home, n, vcap):
    k = np.arange(n)
    return (home + k * (k + 1) // 2) & (vcap - 1)


def build_case(name, seed=5):
    """(table u32 [W, VCAP], keys u32 [W, M], live bool [M], max_rounds)."""
    rng = np.random.RandomState(seed)
    if name == "chain":
        # 24 distinct keys share one home, two slots on their path are
        # taken, and the batch repeats chain keys at higher lanes: each
        # round settles one more link, so the rounds run past 24
        vcap, home = 256, 17
        chain = same_home_keys(rng, 24, vcap, home)
        table = empty_table(vcap)
        other = distinct_keys(rng, 2)
        table[:, probe_path(home, 6, vcap)[[2, 5]]] = other
        keys = np.concatenate([chain, chain[:, rng.randint(0, 24, 8)]], 1)
        return table, keys, np.ones(keys.shape[1], bool), MAX_PROBE_ROUNDS
    if name == "duplicates":
        # a 512-slot table at 30% load; the batch draws from its keys
        # (in-table duplicates) and repeats new keys (in-batch
        # duplicates); a fifth of the lanes are dead, with all-ones keys
        vcap, n_fill = 512, 154
        pool = distinct_keys(rng, n_fill + 60)
        table = filled(empty_table(vcap), pool[:, :n_fill])
        keys = pool[:, rng.randint(n_fill - 40, n_fill + 60, 160)]
        live = rng.rand(160) > 0.2
        keys[:, ~live] = ALL_ONES
        return table, keys, live, MAX_PROBE_ROUNDS
    if name == "all_ones":
        # lanes 0 and 1 take the first two slots on the all-ones key's
        # path; live all-ones lanes 2 and 6 must pass them (the slot is
        # taken by then) and stop, as duplicates, at the third; dead
        # lanes hold all-ones keys too
        vcap = 64
        h1 = int(homes(np.full((W, 1), ALL_ONES, np.uint32), vcap)[0])
        path = probe_path(h1, 3, vcap)
        ab = np.concatenate([same_home_keys(rng, 1, vcap, h1),
                             same_home_keys(rng, 1, vcap, path[1])], 1)
        rest = distinct_keys(rng, 6)
        keys = np.concatenate([ab, np.full((W, 1), ALL_ONES, np.uint32),
                               rest[:, :3], np.full((W, 3), ALL_ONES,
                                                    np.uint32),
                               rest[:, 3:]], 1)
        live = np.ones(keys.shape[1], bool)
        live[[5, 7]] = False
        table = filled(empty_table(vcap), distinct_keys(rng, 20))
        table[:, path] = ALL_ONES
        return table, keys, live, MAX_PROBE_ROUNDS
    if name == "hovf":
        # 60 of 64 slots taken and an 8-step budget: some lanes run out
        vcap = 64
        pool = distinct_keys(rng, 60 + 16)
        table = filled(empty_table(vcap), pool[:, :60])
        return table, pool[:, 60:], np.ones(16, bool), 8
    if name == "rehash":
        # a 1024-slot table at 0.40 load reinserted in slot order into an
        # empty 2048-slot table, as Engine._rehash_tables does
        old = filled(empty_table(1024), distinct_keys(rng, 410))
        keys = old[:, ~(old == ALL_ONES).all(0)]
        return (empty_table(2048), keys, np.ones(keys.shape[1], bool),
                MAX_PROBE_ROUNDS)
    raise KeyError(name)


def run_plain(table, keys, live, max_rounds):
    t = cvt.words_to_torch(table)
    f, p, h = probe_claim_insert_plain(t, cvt.words_to_torch(keys),
                                       torch.from_numpy(live), max_rounds)
    return cvt.words_to_numpy(t), f.numpy(), p.numpy(), bool(h)


def run_rounds(table, keys, live, max_rounds):
    t = cvt.words_to_torch(table)
    f, p, h, rounds = probe_claim_insert_rounds(
        t, cvt.words_to_torch(keys), torch.from_numpy(live), max_rounds)
    return (cvt.words_to_numpy(t), f.numpy(), p.numpy(), bool(h)), rounds


def run_pallas(table, keys, live, max_rounds):
    import jax.numpy as jnp
    from raft_tla_tpu.engine.fingerprint import probe_claim_insert_pallas
    t, f, p, h = probe_claim_insert_pallas(
        tuple(jnp.asarray(w) for w in table),
        tuple(jnp.asarray(w) for w in keys), jnp.asarray(live),
        max_rounds=max_rounds, interpret=True)
    return (np.stack([np.asarray(w) for w in t]), np.asarray(f),
            np.asarray(p), bool(h))


def assert_same(got, want):
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


def check_all(table, keys, live, max_rounds):
    """Model == twin == Pallas kernel; returns the model's outputs and
    its rounds."""
    got, rounds = run_rounds(table, keys, live, max_rounds)
    assert_same(got, run_plain(table, keys, live, max_rounds))
    assert_same(got, run_pallas(table, keys, live, max_rounds))
    assert 1 <= rounds <= keys.shape[1] + 1
    return got, rounds


@pytest.mark.parametrize("name", ["chain", "duplicates", "all_ones",
                                  "hovf", "rehash"])
def test_rounds_model_equals_twin_and_pallas(name):
    table, keys, live, max_rounds = build_case(name)
    (_t, fresh, pos, hovf), rounds = check_all(table, keys, live,
                                               max_rounds)
    M = keys.shape[1]
    if name == "chain":
        assert rounds > 24 and int(fresh.sum()) == 24
    if name == "duplicates":
        assert 0 < int(fresh.sum()) < int(live.sum())
        assert (pos[~live] == homes(keys, 512)[~live]).all()
    if name == "all_ones":
        vcap = table.shape[1]
        h1 = int(homes(keys[:, 2:3], vcap)[0])
        third = int(probe_path(h1, 3, vcap)[2])
        assert pos[2] == pos[6] == third and not fresh[[2, 6]].any()
        assert rounds >= 2
    if name == "hovf":
        assert hovf and 0 < int(fresh.sum()) < M
    if name == "rehash":
        assert fresh.all() and not hovf and rounds > 2


def test_rounds_model_dead_and_empty_batches():
    """No live lane: one round, nothing written; no lane at all: the
    same."""
    table = filled(empty_table(64), distinct_keys(np.random.RandomState(2),
                                                   10))
    keys = distinct_keys(np.random.RandomState(3), 6)
    for k, live in ((keys, np.zeros(6, bool)),
                    (keys[:, :0], np.zeros(0, bool))):
        (t, fresh, pos, hovf), rounds = run_rounds(table, k, live,
                                                   MAX_PROBE_ROUNDS)
        assert rounds == 1 and not fresh.any() and not hovf
        np.testing.assert_array_equal(t, table)
        np.testing.assert_array_equal(pos, homes(k, 64))


@st.composite
def fixtures(draw):
    """A 128-slot table at 0-60% load and 48 lanes drawn from a pool
    that overlaps it: in-table and in-batch duplicates, dead lanes,
    all-ones keys, and sometimes an 8-step budget."""
    seed = draw(st.integers(0, 2 ** 31 - 1))
    load = draw(st.floats(0.0, 0.6))
    p_dead = draw(st.floats(0.0, 0.5))
    n_ones = draw(st.integers(0, 3))
    max_rounds = draw(st.sampled_from([8, MAX_PROBE_ROUNDS]))
    rng = np.random.RandomState(seed)
    vcap, M = 128, 48
    n_fill = int(load * vcap)
    pool = distinct_keys(rng, n_fill + M)
    table = filled(empty_table(vcap), pool[:, :n_fill])
    keys = pool[:, rng.randint(max(0, n_fill - M), n_fill + M // 2, M)]
    keys[:, rng.randint(0, M, n_ones)] = ALL_ONES
    live = rng.rand(M) >= p_dead
    return table, keys, live, max_rounds


@settings(max_examples=12, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(fixtures())
def test_rounds_model_equals_twin_and_pallas_hypothesis(fx):
    check_all(*fx)
