"""The random-walk engine's building blocks against the JAX package's,
bit for bit, on states the reference oracle reaches: the sampling step
``select_enabled``, the Bloom's ``bloom_positions`` and
``bloom_estimate``, the progress ladder ``sim_progress`` (and
``derived_batch_T``), ``Expander.step_lanes`` with the delta group and
the guard product on and off, and ``Expander.expand_one`` (the witness
decode's expansion); and the IR fingerprint, which hashes no hook.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu.config import (Bounds as JB, ModelConfig as JC,
                                 NEXT_DYNAMIC as J_DYN)
from raft_tla_tpu.ops import codec as jcodec
from raft_tla_tpu.ops.layout import Layout as JLayout

from raft_tla_tpu_torch import convert as cvt
from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_DYNAMIC
from raft_tla_tpu_torch.engine.expand import Expander
from raft_tla_tpu_torch.engine.fingerprint import (bloom_estimate,
                                                   bloom_positions)
from raft_tla_tpu_torch.ops.kernels import select_enabled

from conftest import cached_explore

torch.set_num_threads(1)
CPU = torch.device("cpu")

# tests/test_sim.py's MEMBER: NextDynamic, InitServer ⊊ Server
_MEMBER = dict(n_servers=3, init_servers=(0, 1), values=(1,),
               max_inflight_override=6, symmetry=False,
               invariants=("MembershipChange",))
_MEMBER_B = dict(max_log_length=2, max_timeouts=1, max_client_requests=1,
                 max_membership_changes=1)


def _cfgs():
    jc = JC(next_family=J_DYN, bounds=JB.make(**_MEMBER_B), **_MEMBER)
    tc = ModelConfig(next_family=NEXT_DYNAMIC, bounds=Bounds.make(
        **_MEMBER_B), **_MEMBER)
    assert repr(jc) == repr(tc)
    return jc, tc


_ST = {}


def _states(n=160):
    """Encoded oracle-reachable states (JAX codec rows, batch-major): a
    seeded sample to depth 14."""
    if "s" not in _ST:
        jc, _tc = _cfgs()
        r = cached_explore(jc, max_depth=14, keep_states=True)
        pairs = list(r.states.values())
        rng = np.random.RandomState(5)
        pick = sorted(rng.choice(len(pairs), size=n, replace=False))
        lay = JLayout(jc)
        _ST["s"] = jcodec.stack([jcodec.encode(lay, *pairs[i])
                                 for i in pick])
    return _ST["s"]


def _leader_cfg_states(tx):
    """The sample's states with a leader whose log holds a ConfigEntry,
    each also with matchIndex raised (no such state is reachable by
    depth 14), so the ladder's replication rung is exercised."""
    arrs = _states()
    der = tx.derived_batch_T(_tT(arrs))
    from raft_tla_tpu_torch.config import LEADER
    sel = ((torch.from_numpy(np.moveaxis(arrs["st"], 0, -1)) == LEADER) &
           (der["maxcfg"] > 0)).any(0).numpy()
    assert sel.sum() >= 4
    rows = {k: np.asarray(v)[sel] for k, v in arrs.items()}
    raised = dict(rows, mi=np.full_like(rows["mi"], 2))
    return {k: np.concatenate([np.asarray(arrs[k]), raised[k]])
            for k in arrs}


def _jT(arrs):
    """Batch-major codec rows -> the JAX engines' batch-last arrays."""
    return {k: jnp.asarray(np.moveaxis(np.asarray(v), 0, -1))
            for k, v in arrs.items()}


def _tT(arrs):
    return cvt.rows_to_torch(arrs)


def _np_rows(svT):
    """Batch-last tensors or arrays -> batch-major numpy, bag as u32."""
    out = {}
    for k, v in svT.items():
        a = np.moveaxis(v.numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v), -1, 0)
        out[k] = a.view(np.uint32) if k == "bag" else a
    return out


def test_select_enabled_matches_jax():
    from raft_tla_tpu.ops.kernels import select_enabled as jsel
    rng = np.random.RandomState(3)
    for A, p in ((5, 0.5), (96, 0.05), (375, 0.02), (375, 0.9)):
        ok = rng.rand(300, A) < p
        ok[:7] = False                      # walkers with no lane
        ok[7, :] = True
        n = ok.sum(1)
        u = (rng.rand(300) * np.maximum(n, 1)).astype(np.int32)
        u[8:12] = np.maximum(n[8:12] - 1, 0)          # the last lane
        want = np.asarray(jax.vmap(jsel)(jnp.asarray(ok), jnp.asarray(u)))
        got = select_enabled(torch.from_numpy(ok), torch.from_numpy(u))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy()[:7] == -1).all()
    # the reference's unit cases
    ok = torch.tensor([[False, True, False, True, True]] * 3 +
                      [[False] * 5])
    got = select_enabled(ok, torch.tensor([0, 1, 2, 0], dtype=torch.int32))
    assert got.tolist() == [1, 3, 4, -1]


@pytest.mark.parametrize("T", [2, 4])
def test_bloom_positions_and_estimate_match_jax(T):
    from raft_tla_tpu.engine.fingerprint import (
        bloom_estimate as jest, bloom_positions as jpos)
    rng = np.random.RandomState(T)
    fp = rng.randint(0, 1 << 32, size=(T, 257), dtype=np.uint64) \
        .astype(np.uint32)
    fp_t = torch.from_numpy(fp.view(np.int32).copy())
    for m in (10, 22, 24, 31):
        for k in (1, 2, 3, 5):
            want = np.asarray(jpos(jnp.asarray(fp), m, k))
            got = bloom_positions(fp_t, m, k)
            assert got.shape == (k, 257)
            np.testing.assert_array_equal(got.numpy(), want)
            assert (got >= 0).all() and (got < (1 << m)).all()
    for bits, m in ((0, 16), (100, 16), (1000, 16), (65535, 16),
                    (65536, 16), (5927, 24), (16777215, 24)):
        assert bloom_estimate(bits, m, 2) == jest(bits, m, 2)
        assert bloom_estimate(bits, m, 3) == jest(bits, m, 3)


def test_sim_progress_and_derived_match_jax():
    from raft_tla_tpu.engine.expand import Expander as JExpander
    from raft_tla_tpu.spec import get_spec as jget
    from raft_tla_tpu_torch.spec import get_spec
    jc, tc = _cfgs()
    jx, tx = JExpander(jc), Expander(tc, CPU)
    arrs = _leader_cfg_states(tx)
    jT, tT = _jT(arrs), _tT(arrs)
    der_j = jx.derived_batch_T(jT)
    der_t = tx.derived_batch_T(tT)
    assert sorted(der_j) == sorted(der_t)
    for k in der_j:
        np.testing.assert_array_equal(der_t[k].numpy(),
                                      np.asarray(der_j[k]), err_msg=k)
    want = np.asarray(jget("raft").sim_progress(jx.kern, jx.lay)(jT))
    got = get_spec("raft").sim_progress(tx.kern, tx.lay)(tT)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # every rung of the ladder occurs among the states
    assert (want >= 1 << 20).any() and ((want >> 10) & 1023).any() and \
        (want & 1023).any() and (want == 0).any()


@pytest.mark.parametrize("delta", [True, False], ids=["delta", "kernels"])
def test_step_lanes_matches_jax(delta):
    """Each state steps through one of its enabled lanes (some rows
    through lane -1, which must come back unchanged), with the JAX
    expander in the same delta setting; the port's guard setting does
    not reach step_lanes, and both are held."""
    from raft_tla_tpu.engine.expand import Expander as JExpander
    jc, tc = _cfgs()
    arrs = _states()
    jx = JExpander(jc, guard_matmul=True, delta_matmul=delta)
    jT, tT = _jT(arrs), _tT(arrs)
    derj = jx.derived_batch_T(jT)
    ok = np.asarray(jx.guards_T(jT, derj))                    # [B, A]
    rng = np.random.RandomState(1)
    lane = np.array([rng.choice(np.nonzero(r)[0]) if r.any() else -1
                     for r in ok], np.int32)
    lane[::9] = -1
    want = _np_rows(jax.jit(jx.step_lanes)(jT, derj, jnp.asarray(lane)))
    fams = set()
    for guard in (True, False):
        tx = Expander(tc, CPU, guard_matmul=guard, delta_matmul=delta)
        assert tx.delta_active == delta
        dert = tx.derived_batch_T(tT)
        np.testing.assert_array_equal(tx.guards_T(tT, dert).numpy(), ok)
        got = _np_rows(tx.step_lanes(tT, dert, torch.from_numpy(lane)))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        fams = {tx.families[int(f)].name for f in
                tx._fam_of[torch.from_numpy(lane[lane >= 0]).long()]}
    # rows with lane -1 are unchanged
    for k in want:
        np.testing.assert_array_equal(want[k][lane < 0],
                                      np.asarray(arrs[k])[lane < 0])
    # affine and kernel-only families both stepped
    assert {"Timeout", "Receive", "AddNewServer"} <= fams


def test_expand_one_matches_jax():
    from raft_tla_tpu.engine.expand import Expander as JExpander
    jc, tc = _cfgs()
    arrs = _states()
    jx, tx = JExpander(jc), Expander(tc, CPU)
    assert jx.lane_labels() == tx.lane_labels()
    n_succ = 0
    for i in range(0, 160, 20):
        one = {k: np.asarray(v)[i] for k, v in arrs.items()}
        want = jx.expand_one(one)
        got = tx.expand_one(one)
        assert [lbl for lbl, _ in got] == [lbl for lbl, _ in want]
        for (_l, g), (_m, w) in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == np.asarray(w[k]).dtype, k
                np.testing.assert_array_equal(g[k], np.asarray(w[k]),
                                              err_msg=k)
        n_succ += len(got)
    assert n_succ > 20


def test_ir_fingerprint_hashes_no_hook():
    """SpecIR.fingerprint() covers the IR's structure, not its hooks:
    with sim_progress added it stays the reference's value."""
    from raft_tla_tpu.spec import get_spec as jget
    from raft_tla_tpu_torch.spec import get_spec
    ir = get_spec("raft")
    assert ir.sim_progress is not None
    assert ir.fingerprint() == jget("raft").fingerprint() == "4837e08bf0b6"
