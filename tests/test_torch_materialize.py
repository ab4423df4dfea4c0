"""The port's fixed-width ``materialize`` held bit for bit against the
JAX package's, on reachable frontier chunks of a ``NextDynamic`` micro
config (every delta family and every kernel family, 2 permutations):
the guard grid, the per-family counts, the whole FCAP-wide candidate
buffer and the incremental fingerprints (``delta_fp``), for the same
``okf``/``epos``/``fam_caps``.

The JAX side runs once per chunk shape (one jit, its default
expansion: guard matmul and delta group on); the port runs every
guard × delta setting and the chunk-skip form against it.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import (Bounds as JBounds, ModelConfig as JCfg,
                                 NEXT_DYNAMIC as J_DYN)
from raft_tla_tpu.ops import codec as jcodec
from raft_tla_tpu.ops.layout import Layout as JLayout

from raft_tla_tpu_torch import convert as cvt
from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_DYNAMIC
from raft_tla_tpu_torch.engine.expand import Expander, compact_positions
from raft_tla_tpu_torch.engine.fingerprint import RaftFingerprinter

from conftest import cached_explore

torch.set_num_threads(1)

CPU = torch.device("cpu")
_KW = dict(n_servers=3, init_servers=(0, 1), values=(1,), symmetry=True,
           max_inflight_override=4)
_B = dict(max_log_length=2, max_timeouts=1, max_client_requests=1)
B, FCAP = 64, 1024
# (guard_matmul, delta_matmul, delta_chunk_skip)
SETTINGS = {"on-on": (True, True, False), "on-off": (True, False, False),
            "off-on": (False, True, False),
            "off-off": (False, False, False),
            "chunk-skip": (True, True, True)}


def _cfgs():
    jc = JCfg(next_family=J_DYN, bounds=JBounds.make(**_B), **_KW)
    tc = ModelConfig(next_family=NEXT_DYNAMIC, bounds=Bounds.make(**_B),
                     **_KW)
    assert repr(jc) == repr(tc)
    return jc, tc


def _chunks():
    """Two B-row chunks (JAX codec rows) with their valid masks: a
    seeded sample of reachable states, its last rows masked out as in a
    frontier's last chunk; and the initial state repeated, where most
    families (several delta families among them) enable no lane."""
    jc, _tc = _cfgs()
    r = cached_explore(jc, max_depth=12, keep_states=True)
    pairs = list(r.states.values())
    rng = np.random.RandomState(7)
    pick = sorted(rng.choice(len(pairs), size=B, replace=False))
    lay = JLayout(jc)
    sample = jcodec.stack([jcodec.encode(lay, *pairs[i]) for i in pick])
    init = jcodec.stack([jcodec.encode(lay, *pairs[0])] * B)
    return {"reachable": (sample, np.arange(B) < B - 9),
            "init": (init, np.arange(B) < 16)}


_RUN = {}


def _run():
    """The JAX side on both chunks: (ok, cand, counts, fp)."""
    if _RUN:
        return _RUN
    import jax
    import jax.numpy as jnp
    from raft_tla_tpu.engine.expand import Expander as JExpander
    from raft_tla_tpu.engine.fingerprint import RaftFingerprinter as JF
    jc, tc = _cfgs()
    jx = JExpander(jc)
    jf = JF(jc, sym_canon="minperm")
    caps = Expander(tc, CPU).default_fam_caps(B)
    assert tuple(jx.default_fam_caps(B)) == caps

    def f(svT, valid):
        derT = jx.derived_batch_T(svT)
        ok = jx.guards_T(svT, derT) & valid[:, None]
        okf = ok.reshape(-1)
        epos = jnp.where(okf, jnp.cumsum(okf.astype(jnp.int32)) - 1, FCAP)
        cand, counts, fp = jx.materialize(
            svT, derT, okf, epos, FCAP, caps,
            delta_fp=(jf, jf.parent_tables(svT)))
        return ok, cand, counts, fp

    fj = jax.jit(f)
    for name, (arrs, valid) in _chunks().items():
        svTj = jcodec.widen({k: jnp.moveaxis(jnp.asarray(v), 0, -1)
                             for k, v in arrs.items()})
        ok, cand, counts, fp = fj(svTj, jnp.asarray(valid))
        _RUN[name] = dict(
            arrs=arrs, valid=valid, caps=caps, ok=np.asarray(ok),
            cand={k: np.asarray(v) for k, v in cand.items()},
            counts=np.asarray(counts), fp=np.asarray(fp))
    return _RUN


@pytest.mark.parametrize("chunk", ["reachable", "init"])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_materialize_matches_jax(setting, chunk):
    want = _run()[chunk]
    _jc, tc = _cfgs()
    gm, dm, skip = SETTINGS[setting]
    tx = Expander(tc, CPU, guard_matmul=gm, delta_matmul=dm,
                  delta_chunk_skip=skip)
    assert tx.delta_active == dm
    fpr = RaftFingerprinter(tc)
    assert fpr.supports_incremental() and len(fpr.sigmas) == 2
    svT = cvt.rows_to_torch(want["arrs"])
    der = tx.kern.derived(svT)
    ok = tx.guards_T(svT, der) & torch.from_numpy(want["valid"])[:, None]
    np.testing.assert_array_equal(ok.numpy(), want["ok"])
    okf = ok.reshape(-1)
    epos, n_e = compact_positions(okf, FCAP)
    n_e = int(n_e)
    cand, counts = tx.materialize(svT, der, okf, epos, FCAP, want["caps"])
    cand2, counts2, fp = tx.materialize(
        svT, der, okf, epos, FCAP, want["caps"],
        delta_fp=(fpr, fpr.parent_tables(svT)))
    np.testing.assert_array_equal(counts.numpy(), want["counts"])
    assert torch.equal(counts, counts2)
    assert 0 < n_e < FCAP and (counts <= torch.tensor(want["caps"])).all()
    # the chunk-skip form runs every block, so the columns of a family
    # with no enabled lane (zeros in the reference's skip branch) and
    # the buffer columns past n_e that read them are not the
    # reference's; every column before n_e is
    n = n_e if skip else FCAP
    got = cvt.rows_to_numpy(cand)
    for k in tx.keys:
        jk = np.moveaxis(want["cand"][k], -1, 0)
        if k == "bag":
            jk = jk.view(np.int32)
        np.testing.assert_array_equal(got[k][:n], jk[:n], err_msg=k)
        assert torch.equal(cand[k], cand2[k]), k
    np.testing.assert_array_equal(fp.numpy()[:, :n].view(np.uint32),
                                  want["fp"][:, :n])
    # the incremental values are the canonical fingerprints
    live = {k: v[..., :n_e] for k, v in cand.items()}
    assert torch.equal(fp[:, :n_e], fpr.fingerprint_batch_T(live))
    if chunk == "init":
        zero = {tx.families[fi].name for fi, c in enumerate(counts.tolist())
                if c == 0}
        assert {"BecomeLeader", "ClientRequest", "Duplicate"} <= zero
        assert counts.sum() > 0
