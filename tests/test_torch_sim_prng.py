"""The port's threefry PRNG (``raft_tla_tpu_torch/utils/prng.py``)
against ``jax.random`` bit for bit: the threefry2x32 block, ``PRNGKey``,
``fold_in``, ``split``, 32 random bits and ``randint(key, (), 0, n)``
over many seeds and walker ids (ids near 2^31 among them) and every n
from 0 (span 1, as the walkers' ``maximum(n, 1)`` never passes 0) to
375, config #5's lane count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from raft_tla_tpu_torch.utils import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1, -1, -(2 ** 31)]
WIDS = np.array([0, 1, 2, 63, 64, 16383, 2 ** 20 + 3, 2 ** 31 - 2,
                 2 ** 31 - 1], np.int32)


def _t(a):
    """numpy u32 -> the port's int32-carried tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32).copy())


def _u(t):
    return t.numpy().view(np.uint32)


def _keys(n, seed=3):
    base = jax.random.PRNGKey(seed)
    ids = jnp.arange(n, dtype=jnp.int32)
    return np.asarray(jax.vmap(lambda w: jax.random.fold_in(base, w))(ids))


def test_threefry_block_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(4):
        key = rng.randint(0, 1 << 32, size=2, dtype=np.uint64) \
            .astype(np.uint32)
        cnt = rng.randint(0, 1 << 32, size=64, dtype=np.uint64) \
            .astype(np.uint32)
        want = np.asarray(jprng.threefry_2x32(jnp.asarray(key),
                                              jnp.asarray(cnt)))
        y1, y2 = prng.threefry2x32(_t(key[:1]), _t(key[1:]), _t(cnt[:32]),
                                   _t(cnt[32:]))
        np.testing.assert_array_equal(np.concatenate([_u(y1), _u(y2)]),
                                      want)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_match_jax(seed):
    base = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_u(prng.PRNGKey(seed)), np.asarray(base))
    want = np.asarray(jax.vmap(lambda w: jax.random.fold_in(base, w))(
        jnp.asarray(WIDS)))
    got = prng.fold_in(prng.PRNGKey(seed), torch.from_numpy(WIDS))
    np.testing.assert_array_equal(_u(got), want)


def test_prng_key_refuses_seeds_past_int32():
    for seed in (2 ** 31, -(2 ** 31) - 1):
        with pytest.raises(ValueError, match="int32"):
            prng.PRNGKey(seed)


def test_split_and_bits_match_jax():
    keys = _keys(200)
    want = np.asarray(jax.vmap(jax.random.split)(keys))     # [N, 2, 2]
    got = prng.split(_t(keys))
    assert got.shape == (200, 2, 2)
    np.testing.assert_array_equal(_u(got), want)
    bits = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (), jnp.uint32))(keys))
    np.testing.assert_array_equal(_u(prng.random_bits(_t(keys))), bits)


def test_randint_matches_jax_for_every_span():
    """n = 0..375 (a walker's enabled-lane counts on config #5), each
    against many keys, through the walker's own call: randint of
    ``maximum(n, 1)``; the port takes n as it is and maps n <= 0 to
    span 1."""
    ns = np.repeat(np.arange(0, 376, dtype=np.int32), 24)
    keys = _keys(ns.size, seed=11)
    want = np.asarray(jax.vmap(lambda k, n: jax.random.randint(
        k, (), 0, jnp.maximum(n, 1)))(keys, jnp.asarray(ns)))
    got = prng.randint(_t(keys), torch.from_numpy(ns))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() < np.maximum(ns, 1)).all()


def test_randint_large_spans_wrap_as_uint32():
    """Spans where (2^16 mod span)^2 and (hi mod span) * multiplier
    overflow 32 bits: the products wrap as uint32 arithmetic does."""
    ns = np.array([65537, 99991, 2 ** 20 + 7, 2 ** 30 + 3, 2 ** 31 - 1,
                   123456789] * 40, np.int32)
    keys = _keys(ns.size, seed=5)
    want = np.asarray(jax.vmap(lambda k, n: jax.random.randint(
        k, (), 0, n))(keys, jnp.asarray(ns)))
    got = prng.randint(_t(keys), torch.from_numpy(ns))
    np.testing.assert_array_equal(got.numpy(), want)


def test_walker_streams_match_the_reference_engine():
    """The walker's first rounds: fold_in by global id, then split and
    draw, as ``SimEngine.fresh_carry`` and its rejection rounds do."""
    seed, n_en = 9, np.arange(1, 65, dtype=np.int32)
    wids = np.arange(2 ** 31 - 64, 2 ** 31, dtype=np.int64).astype(np.int32)
    base = jax.random.PRNGKey(seed)
    jk = jax.vmap(lambda w: jax.random.fold_in(base, w))(jnp.asarray(wids))
    tk = prng.fold_in(prng.PRNGKey(seed), torch.from_numpy(wids))
    for _ in range(3):
        sj = jax.vmap(jax.random.split)(jk)
        uj = jax.vmap(lambda k, n: jax.random.randint(
            k, (), 0, jnp.maximum(n, 1)))(sj[:, 1], jnp.asarray(n_en))
        st = prng.split(tk)
        ut = prng.randint(st[:, 1], torch.from_numpy(n_en))
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
        jk, tk = sj[:, 0], st[:, 0]
        np.testing.assert_array_equal(_u(tk), np.asarray(jk))
