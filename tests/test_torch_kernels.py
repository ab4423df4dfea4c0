"""The port's RaftKernels, guard grid, Predicates and fingerprinter held
against the JAX package on oracle-reachable micro states, exactly
(every value is an integer: zero tolerance).

The same encoded states (the JAX codec's numpy rows) feed both sides:
the JAX functions per state (vmapped) and the port's batch-last torch
functions on the CPU.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import (Bounds as JBounds, ModelConfig as JCfg,
                                 NEXT_DYNAMIC as J_DYN, NEXT_FULL as J_FULL)
from raft_tla_tpu.ops import codec as jcodec
from raft_tla_tpu.ops.layout import Layout as JLayout

from raft_tla_tpu_torch import convert as cvt
from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_DYNAMIC, \
    NEXT_FULL
from raft_tla_tpu_torch.engine.expand import Expander, compact_positions
from raft_tla_tpu_torch.engine.fingerprint import RaftFingerprinter
from raft_tla_tpu_torch.ops.layout import Layout
from raft_tla_tpu_torch.ops.vpredicates import (CONSTRAINTS, INVARIANTS,
                                                Predicates, runtime_bounds)

from conftest import cached_explore

torch.set_num_threads(1)

CASES = {
    # membership: AddNewServer / DeleteServer / catch-up / CheckOldConfig
    "dynamic": dict(n_servers=3, init_servers=(0, 1), values=(1,),
                    next_family="dyn", max_inflight_override=6,
                    bounds=dict(max_log_length=2, max_timeouts=1,
                                max_client_requests=1,
                                max_membership_changes=1),
                    symmetry=True, depth=14),
    # unreliable network: Duplicate / Drop, two values
    "full": dict(n_servers=2, init_servers=(0, 1), values=(1, 2),
                 next_family="full", max_inflight_override=3,
                 bounds=dict(max_log_length=1, max_timeouts=1,
                             max_client_requests=2),
                 symmetry=True, depth=14),
}


def _cfgs(case):
    c = dict(CASES[case])
    depth = c.pop("depth")
    fam = c.pop("next_family")
    b = c.pop("bounds")
    jc = JCfg(next_family={"dyn": J_DYN, "full": J_FULL}[fam],
              bounds=JBounds.make(**b), **c)
    tc = ModelConfig(next_family={"dyn": NEXT_DYNAMIC,
                                  "full": NEXT_FULL}[fam],
                     bounds=Bounds.make(**b), **c)
    assert repr(jc) == repr(tc)
    return jc, tc, depth


_STATES = {}


def _states(case, n=160):
    """Encoded oracle-reachable states (JAX codec rows, batch-major)."""
    if case not in _STATES:
        jc, _tc, depth = _cfgs(case)
        r = cached_explore(jc, max_depth=depth, keep_states=True)
        pairs = list(r.states.values())
        rng = np.random.RandomState(5)
        pick = rng.choice(len(pairs), size=min(n, len(pairs)),
                          replace=False)
        lay = JLayout(jc)
        rows = [jcodec.encode(lay, *pairs[i]) for i in sorted(pick)]
        _STATES[case] = jcodec.stack(rows)
    return _STATES[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_guards_and_successors_match_jax(case):
    """Every lane's guard and every enabled lane's successor row."""
    import jax.numpy as jnp
    from raft_tla_tpu.engine.expand import Expander as JExpander
    jc, tc, _ = _cfgs(case)
    arrs = _states(case)
    jx = JExpander(jc, guard_matmul=False, delta_matmul=False)
    ok_j, cand_j = jx.expand({k: jnp.asarray(v) for k, v in arrs.items()})
    ok_j = np.asarray(ok_j)
    tx = Expander(tc, torch.device("cpu"))
    assert tx.lane_labels() == jx.lane_labels()
    svT = cvt.rows_to_torch(arrs)
    der = tx.kern.derived(svT)
    ok_t = tx.guards_T(svT, der).numpy()
    np.testing.assert_array_equal(ok_t, ok_j)
    # every enabled lane into a buffer of exactly n_e, no cap binding
    okf = torch.from_numpy(ok_t.reshape(-1))
    epos, n_e = compact_positions(okf, int(okf.sum()))
    caps = tuple(ok_t.shape[0] * f.n_lanes for f in tx.families)
    cand, counts = tx.materialize(svT, der, okf, epos, int(n_e), caps)
    cand_t = cvt.rows_to_numpy(cand)
    counts = counts.tolist()
    b, a = np.nonzero(ok_j)
    for k in cand_t:
        want = np.asarray(cand_j[k])[b, a]
        np.testing.assert_array_equal(cand_t[k], want, err_msg=k)
    # every family fired somewhere (CheckOldConfig messages, which
    # CocDiscard receives, exist only under NextDynamic)
    missing = {f.name for f, c in zip(tx.families, counts) if c == 0}
    assert missing == ({"CocDiscard"} if case == "full" else set())


@pytest.mark.parametrize("case", sorted(CASES))
def test_predicates_match_jax(case):
    import jax
    import jax.numpy as jnp
    from raft_tla_tpu.ops.kernels import RaftKernels as JK
    from raft_tla_tpu.ops.vpredicates import (CONSTRAINTS as JC_,
                                              Predicates as JP)
    from raft_tla_tpu.ops.vpredicates import \
        runtime_bounds as j_runtime_bounds
    jc, tc, _ = _cfgs(case)
    arrs = _states(case)
    svb = {k: jnp.asarray(v) for k, v in arrs.items()}
    jp, jk = JP(JLayout(jc)), JK(JLayout(jc))
    tp = Predicates(Layout(tc))
    svT = cvt.rows_to_torch(arrs)
    der = tp.kern.derived(svT)
    assert set(CONSTRAINTS) == set(JC_)
    rtb = runtime_bounds(tc)
    np.testing.assert_array_equal(rtb, j_runtime_bounds(jc))
    for nm in sorted(INVARIANTS) + sorted(CONSTRAINTS):
        fn_j = jp.invariant_fn(nm) if nm in INVARIANTS else \
            jp.constraint_fn(nm)
        fn_t = tp.invariant_fn(nm) if nm in INVARIANTS else \
            tp.constraint_fn(nm)
        want = np.asarray(jax.vmap(lambda sv: fn_j(sv, jk.derived(sv)))(
            svb))
        got = fn_t(svT, der).numpy()
        np.testing.assert_array_equal(got, want, err_msg=nm)
        if nm in CONSTRAINTS:
            # the runtime-bounds vector of the config reads the same
            np.testing.assert_array_equal(fn_t(svT, der, rtb).numpy(),
                                          want, err_msg=nm)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fingerprints_match_jax(case):
    import jax.numpy as jnp
    from raft_tla_tpu.engine.fingerprint import RaftFingerprinter as JF
    jc, tc, _ = _cfgs(case)
    arrs = _states(case)
    want = np.asarray(JF(jc, sym_canon="minperm").fingerprint_batch(
        {k: jnp.asarray(v) for k, v in arrs.items()}))       # [B, T]
    got = RaftFingerprinter(tc).fingerprint_batch_T(
        cvt.rows_to_torch(arrs))                            # [T, B]
    np.testing.assert_array_equal(cvt.words_to_numpy(got).T, want)


def test_fp128_fingerprints_match_jax():
    import jax.numpy as jnp
    from raft_tla_tpu.engine.fingerprint import RaftFingerprinter as JF
    jc, tc, _ = _cfgs("full")
    arrs = _states("full")
    want = np.asarray(JF(jc.with_(fp128=True), sym_canon="minperm")
                      .fingerprint_batch({k: jnp.asarray(v)
                                          for k, v in arrs.items()}))
    got = RaftFingerprinter(tc.with_(fp128=True)).fingerprint_batch_T(
        cvt.rows_to_torch(arrs))
    np.testing.assert_array_equal(cvt.words_to_numpy(got).T, want)
