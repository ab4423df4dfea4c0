"""The paxos fingerprinter against the JAX package's, bit for bit, on
seeded samples of reachable states: minperm (6 permutations), fp128's
four streams, symmetry off at two instances, and orbit-sort at 4 and 5
acceptors (the signature, the fingerprints and the hard/tie masks).
The sort path's hard-lane fallback runs on the first ``hcap`` live hard
lanes only: with a signature that ties every acceptor (so most lanes
are hard), a batch with more hard lanes than ``hcap`` gives the
reference's values on those lanes and on every soft lane, and the
count that makes the engine replay; the engine, given that signature
and HCAP 2, replays until HCAP holds the hard lanes and lands on the
minperm run's answer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu.spec.paxos.config import PaxosConfig as JConfig
from raft_tla_tpu.spec.paxos.fingerprint import (
    PaxosFingerprinter as JFpr, paxos_acceptor_signature as jsig)

from raft_tla_tpu_torch.convert import rows_to_torch, words_to_numpy
from raft_tla_tpu_torch.engine.bfs import Engine
from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig
from raft_tla_tpu_torch.spec.paxos.fingerprint import (
    PaxosFingerprinter, paxos_acceptor_signature)
from test_torch_paxos_units import sample

torch.set_num_threads(1)

CASES = {
    "minperm": (dict(), "minperm"),
    "fp128": (dict(fp128=True), "minperm"),
    "2inst_nosym": (dict(n_instances=2, symmetry=False), "minperm"),
    "sort_n4": (dict(n_servers=4), "sort"),
    "sort_n5": (dict(n_servers=5), "sort"),
    "sort_n5_fp128": (dict(n_servers=5, fp128=True), "sort"),
}


def _pair(name, n=256):
    kw, mode = CASES[name]
    _cfg, _lay, arrs = sample(kw, n=n, seed=3)
    tf = PaxosFingerprinter(PaxosConfig(**kw), mode)
    jf = JFpr(JConfig(**kw), mode)
    svT = rows_to_torch(arrs, u32_keys=("msgs",))
    jT = {k: jnp.moveaxis(jnp.asarray(v), 0, -1) for k, v in arrs.items()}
    return tf, jf, svT, jT


@pytest.mark.parametrize("name", sorted(CASES))
def test_fingerprints_equal_the_reference(name):
    tf, jf, svT, jT = _pair(name)
    want = np.asarray(jf.fingerprint_batch_T(jT))
    got = words_to_numpy(tf.fingerprint_batch_T(svT))
    assert got.shape == want.shape == (tf.n_streams, svT["mb"].shape[-1])
    assert np.array_equal(got, want)
    fp, n_hard = tf.fingerprint_chunk_T(svT, 16)
    assert np.array_equal(words_to_numpy(fp), want)
    assert (n_hard is None) == (CASES[name][1] == "minperm")
    assert tf.supports_incremental() is False


@pytest.mark.parametrize("name", ["sort_n4", "sort_n5"])
def test_sort_signature_and_masks(name):
    tf, jf, svT, jT = _pair(name)
    bits = tf.kern.unpack_bits(svT["msgs"])
    jbits = (jT["msgs"][np.arange(tf.lay.n_msg_bits) >> 5] >>
             jnp.asarray((np.arange(tf.lay.n_msg_bits) & 31)
                         .astype(np.uint32))[:, None]) & jnp.uint32(1)
    got = words_to_numpy(paxos_acceptor_signature(tf, svT, bits))
    assert np.array_equal(got, np.asarray(jsig(jf, jT, jbits)))
    svb = {k: v.movedim(-1, 0) for k, v in svT.items()}
    jb = {k: jnp.moveaxis(v, -1, 0) for k, v in jT.items()}
    got, want = tf.sort_debug(svb), jf.sort_debug(jb)
    for k in ("hard", "tie"):
        assert np.array_equal(got[k], want[k]), k
    assert got["tie"].any()


def _tie_all_torch(f, svT, bits):
    return torch.zeros((f.lay.N, bits.shape[-1]), dtype=torch.int32,
                       device=bits.device)


def _tie_all_jax(f, svT, bits):
    return jnp.zeros((f.lay.N, bits.shape[-1]), jnp.uint32)


@pytest.mark.parametrize("name", ["sort_n4", "sort_n5"])
def test_hard_lanes_past_hcap(name):
    tf, jf, svT, jT = _pair(name)
    tf._sig_fn, jf._sig_fn = _tie_all_torch, _tie_all_jax
    want = np.asarray(jf.fingerprint_batch_T(jT))
    svb = {k: v.movedim(-1, 0) for k, v in svT.items()}
    hard = tf.sort_debug(svb)["hard"]
    assert np.array_equal(hard, np.asarray(
        jf.sort_debug({k: jnp.moveaxis(v, -1, 0)
                       for k, v in jT.items()})["hard"]))
    n = int(hard.sum())
    hcap = 8
    assert n > 4 * hcap
    fp, n_hard = tf.fingerprint_chunk_T(svT, hcap)
    fp = words_to_numpy(fp)
    assert int(n_hard) == n
    first = np.nonzero(hard)[0][:hcap]
    assert np.array_equal(fp[:, first], want[:, first])
    assert np.array_equal(fp[:, ~hard], want[:, ~hard])
    assert not np.array_equal(fp, want)
    # a lane outside ``live`` is never hard, and every lane is exact
    # when the buffer holds them all
    live = torch.from_numpy(~hard)
    assert int(tf.fingerprint_chunk_T(svT, hcap, live=live)[1]) == 0
    assert np.array_equal(words_to_numpy(tf.fingerprint_chunk_T(svT, n)[0]),
                          want)


def test_engine_replays_past_hcap():
    cfg = PaxosConfig(n_servers=4, n_values=1)
    base = Engine(cfg, chunk=256, sym_canon="minperm", device="cpu")
    want = base.check()
    eng = Engine(cfg, chunk=256, sym_canon="sort", hcap=2, device="cpu")
    eng.fpr._sig_fn = _tie_all_torch
    res = eng.check()
    assert res.sym_canon == 1 and want.sym_canon == 0
    assert res.hard_lanes > 0 and res.hard_chunk_max > 2 and eng.HCAP > 2
    assert (res.distinct_states, res.generated_states, res.level_sizes) == \
        (want.distinct_states, want.generated_states, want.level_sizes)
    for g in (1, res.distinct_states // 2, res.distinct_states - 1):
        assert eng.trace(g) == base.trace(g)
