"""The port's u32 helpers, packed-field helpers, converters and the dedup
kernel's plain twin, held exactly against the JAX package.

The dedup twin is compared with the reference's Pallas kernel run in
interpret mode (``probe_claim_insert_pallas(..., interpret=True)``) on
three fixtures: forced collisions, a contended batch and a full table.
The contended fixture also shows that the kernel's sequential order
places keys differently from the reference's parallel lax claim loop
(``Engine._probe_insert_lax``), while the fresh set agrees.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch import convert as cvt
from raft_tla_tpu_torch.config import Bounds, ModelConfig
from raft_tla_tpu_torch.engine.fingerprint import (MAX_PROBE_ROUNDS,
                                                   probe_claim_insert,
                                                   probe_claim_insert_plain)
from raft_tla_tpu_torch.ops.layout import Layout, get_field_t, put_field_t
from raft_tla_tpu_torch.utils import fmix32, home_slots, lsr, ult

torch.set_num_threads(1)

RNG_SEED = 11


def _u32(n, seed=RNG_SEED):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]     # bit-31 edges
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _np(t):
    return t.numpy().view(np.uint32)


def test_fmix32_matches_jax():
    import jax.numpy as jnp
    from raft_tla_tpu.engine.fingerprint import fmix32 as jfmix
    from raft_tla_tpu.utils import fmix32_np
    x = _u32(4096)
    want = np.asarray(jfmix(jnp.asarray(x)))
    np.testing.assert_array_equal(_np(fmix32(_t(x))), want)
    np.testing.assert_array_equal(fmix32_np(x), want)


@pytest.mark.parametrize("s", [0, 1, 7, 16, 31])
def test_lsr_and_ult_are_unsigned(s):
    x, y = _u32(2048), _u32(2048, seed=3)
    np.testing.assert_array_equal(_np(lsr(_t(x), s)), x >> np.uint32(s))
    np.testing.assert_array_equal(ult(_t(x), _t(y)).numpy(), x < y)


def test_layout_fields_match_jax():
    """get_field/put_field over every header field of a wide layout,
    on words with bit 31 set."""
    from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC
    from raft_tla_tpu.ops.layout import (Layout as JL, get_field as jget,
                                         put_field as jput)
    import jax.numpy as jnp
    kw = dict(n_servers=5, init_servers=(0, 1, 2, 3, 4), values=(1, 2, 3))
    jl = JL(JC(bounds=JB.make(max_log_length=4, max_timeouts=3), **kw))
    tl = Layout(ModelConfig(bounds=Bounds.make(max_log_length=4,
                                               max_timeouts=3), **kw))
    assert jl.header_shifts == tl.header_shifts
    w = _u32(1024)
    for name, sw in tl.header_shifts.items():
        got = get_field_t(_t(w), sw)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jget(jnp.asarray(w), sw)), err_msg=name)
        np.testing.assert_array_equal(
            _np(put_field_t(_t(w), sw)),
            np.asarray(jput(jnp.asarray(w), sw)), err_msg=name)


def test_home_slots_match_reference():
    from raft_tla_tpu.utils import HOME_SALT, fmix32_np
    keys = np.stack([_u32(512), _u32(512, seed=4)])
    h = np.full(512, HOME_SALT, np.uint32)
    for w in range(2):
        h = fmix32_np(h ^ keys[w])
    np.testing.assert_array_equal(
        home_slots(_t(keys), 1 << 20).numpy(), h & ((1 << 20) - 1))


def test_convert_round_trips():
    from raft_tla_tpu.config import ModelConfig as JC
    from raft_tla_tpu.models.raft import init_state
    from raft_tla_tpu.ops import codec
    from raft_tla_tpu.ops.layout import Layout as JL
    cfg = JC()
    rows = codec.stack([codec.encode(JL(cfg), *init_state(cfg))] * 3)
    rows["bag"][0, 0, 0] = 0x80000001
    back = cvt.rows_to_numpy(cvt.rows_to_torch(rows))
    for k in rows:
        assert back[k].dtype == rows[k].dtype, k
        np.testing.assert_array_equal(back[k], rows[k])
    words = np.stack([_u32(64), _u32(64, seed=9)])
    np.testing.assert_array_equal(
        cvt.words_to_numpy(cvt.words_to_torch(words)), words)
    np.testing.assert_array_equal(
        cvt.words_to_numpy(cvt.words_to_torch(tuple(words))), words)


# ---------------------------------------------------------------------
# the dedup kernel's plain twin vs the reference Pallas kernel
# ---------------------------------------------------------------------

def _distinct(rng, n, W=2):
    from raft_tla_tpu.utils import fmix32_np
    k = rng.randint(0, 0xFFFFFFFF, size=(W, n), dtype=np.uint64)
    k = k.astype(np.uint32)
    k[1] = fmix32_np(np.arange(n, dtype=np.uint64) + rng.randint(1 << 20))
    return k


def _fixture(name):
    """(table u32 [W, VCAP], keys u32 [W, M], live bool [M])."""
    rng = np.random.RandomState(7)
    W = 2
    if name == "forced_collision":
        # VCAP 128, M 96 over 24 distinct keys, dead lanes and a
        # pre-populated cohort of 4 keys
        vcap = 128
        distinct = _distinct(rng, 24)
        keys = distinct[:, rng.randint(0, 24, size=96)]
        live = rng.rand(96) > 0.2
        keys[:, ~live] = 0xFFFFFFFF
        table = cvt.words_to_torch(np.full((W, vcap), 0xFFFFFFFF, np.uint32))
        probe_claim_insert_plain(table, cvt.words_to_torch(distinct[:, :4]),
                                 torch.ones(4, dtype=torch.bool))
        return cvt.words_to_numpy(table), keys, live
    if name == "contended":
        # VCAP 1024, M 400 distinct keys (39% load), empty table
        return (np.full((W, 1024), 0xFFFFFFFF, np.uint32),
                _distinct(rng, 400), np.ones(400, bool))
    if name == "full_table":
        # every slot taken: every live lane exhausts its budget
        keys = _distinct(rng, 64 + 8)
        live = np.ones(8, bool)
        live[3] = False
        return keys[:, :64].copy(), keys[:, 64:], live
    raise KeyError(name)


def _pallas(table, keys, live, max_rounds=MAX_PROBE_ROUNDS):
    import jax.numpy as jnp
    from raft_tla_tpu.engine.fingerprint import probe_claim_insert_pallas
    t, f, p, h = probe_claim_insert_pallas(
        tuple(jnp.asarray(w) for w in table),
        tuple(jnp.asarray(w) for w in keys), jnp.asarray(live),
        max_rounds=max_rounds, interpret=True)
    return (np.stack([np.asarray(w) for w in t]), np.asarray(f),
            np.asarray(p), bool(h))


@pytest.mark.parametrize("name", ["forced_collision", "contended",
                                  "full_table"])
def test_dedup_twin_matches_pallas_kernel(name):
    table, keys, live = _fixture(name)
    want_t, want_f, want_p, want_h = _pallas(table, keys, live)
    tab = cvt.words_to_torch(table)
    f, p, h = probe_claim_insert(tab, cvt.words_to_torch(keys),
                                 torch.from_numpy(live))
    np.testing.assert_array_equal(cvt.words_to_numpy(tab), want_t)
    np.testing.assert_array_equal(f.numpy(), want_f)
    np.testing.assert_array_equal(p.numpy(), want_p)
    assert bool(h) == want_h
    if name == "forced_collision":
        assert 0 < int(f.sum()) < int(live.sum()) and not want_h
    if name == "full_table":
        assert want_h and not want_f.any()


def test_dedup_twin_follows_kernel_not_lax_form():
    """On a contended batch the reference's parallel lax claim loop
    places keys in other slots than its sequential Pallas kernel does
    (the twin follows the kernel); membership — the fresh set — agrees."""
    import jax.numpy as jnp
    from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC
    from raft_tla_tpu.engine.bfs import Engine as JEngine
    table, keys, live = _fixture("contended")
    eng = JEngine(JC(n_servers=2, init_servers=(0, 1), values=(1,),
                     bounds=JB.make(max_log_length=1)),
                  chunk=64, store_states=False)
    M = keys.shape[1]
    tl, _c, fl, pl, hl = eng._probe_insert_lax(
        tuple(jnp.asarray(w) for w in table),
        jnp.full((table.shape[1],), 0xFFFFFFFF, jnp.uint32),
        tuple(jnp.asarray(w) for w in keys), jnp.asarray(live),
        jnp.arange(M, dtype=jnp.uint32))
    tab = cvt.words_to_torch(table)
    f, p, _h = probe_claim_insert(tab, cvt.words_to_torch(keys),
                                  torch.from_numpy(live))
    np.testing.assert_array_equal(f.numpy(), np.asarray(fl))
    assert not np.array_equal(p.numpy(), np.asarray(pl))
    assert not bool(hl)


def test_wrapper_uses_twin_only_for_cpu_tensors():
    """A CPU table takes the plain twin and counts no launch; the CUDA
    branch needs the card (tests/test_torch_cuda.py)."""
    from raft_tla_tpu_torch.engine.fingerprint import PROBE_CLAIM_LAUNCHES
    table, keys, live = _fixture("contended")
    PROBE_CLAIM_LAUNCHES.reset()
    probe_claim_insert(cvt.words_to_torch(table), cvt.words_to_torch(keys),
                       torch.from_numpy(live))
    assert PROBE_CLAIM_LAUNCHES.count == 0
