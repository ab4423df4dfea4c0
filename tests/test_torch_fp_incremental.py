"""The port's incremental per-action fingerprints held exactly against
the direct hash and the JAX package (integer hashes: zero tolerance).

On sampled oracle-reachable parents of micro configs that fire every
action family (membership: AddNewServer / DeleteServer / CocDiscard
and ConfigEntry payloads; the unreliable network: Duplicate / Drop;
Restart), each family's ``family_delta`` rows [P, T, cap] must equal
(a) the direct per-permutation hash of the same successor rows and
(b) the JAX fingerprinter's ``family_delta`` on the same inputs; and
``materialize(..., delta_fp=...)`` must give the direct canonical
fingerprints.  The S=3 all-initial case has P=6, the others P=2.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import (Bounds as JB, ModelConfig as JC,
                                 NEXT_ASYNC as J_ASYNC,
                                 NEXT_DYNAMIC as J_DYN,
                                 NEXT_FULL as J_FULL)
from raft_tla_tpu.ops import codec as jcodec
from raft_tla_tpu.ops.layout import Layout as JLayout

from raft_tla_tpu_torch import convert as cvt
from raft_tla_tpu_torch.config import (Bounds, ModelConfig, NEXT_ASYNC,
                                       NEXT_DYNAMIC, NEXT_FULL)
from raft_tla_tpu_torch.engine.expand import Expander, compact_positions
from raft_tla_tpu_torch.engine.fingerprint import RaftFingerprinter

from conftest import cached_explore

torch.set_num_threads(1)

FAMS = {"async": (J_ASYNC, NEXT_ASYNC), "dyn": (J_DYN, NEXT_DYNAMIC),
        "full": (J_FULL, NEXT_FULL)}
CASES = {
    "dynamic": dict(n_servers=3, init_servers=(0, 1), values=(1,),
                    family="dyn", max_inflight_override=6,
                    bounds=dict(max_log_length=2, max_timeouts=1,
                                max_client_requests=1,
                                max_membership_changes=1), depth=14),
    "full_fp128": dict(n_servers=2, init_servers=(0, 1), values=(1, 2),
                       family="full", max_inflight_override=3,
                       bounds=dict(max_log_length=1, max_timeouts=1,
                                   max_client_requests=2),
                       fp128=True, depth=14),
    "s3": dict(n_servers=3, init_servers=(0, 1, 2), values=(1,),
               family="async", max_inflight_override=2,
               bounds=dict(max_log_length=1, max_timeouts=1,
                           max_client_requests=1), depth=12),
}
N_PARENTS = 96


def _cfgs(case):
    c = dict(CASES[case])
    c.pop("depth")
    jf, tf = FAMS[c.pop("family")]
    b = c.pop("bounds")
    jc = JC(next_family=jf, bounds=JB.make(**b), symmetry=True, **c)
    tc = ModelConfig(next_family=tf, bounds=Bounds.make(**b),
                     symmetry=True, **c)
    assert repr(jc) == repr(tc)
    return jc, tc


def _parents(case):
    """Encoded oracle-reachable states (JAX codec rows, batch-first)."""
    jc, _tc = _cfgs(case)
    r = cached_explore(jc, max_depth=CASES[case]["depth"], keep_states=True)
    pairs = list(r.states.values())
    rng = np.random.RandomState(9)
    pick = rng.choice(len(pairs), size=min(N_PARENTS, len(pairs)),
                      replace=False)
    lay = JLayout(jc)
    return jcodec.stack([jcodec.encode(lay, *pairs[i]) for i in sorted(pick)])


def _jt(rows_T):
    """Port batch-last tensors -> JAX batch-last arrays (bag as u32)."""
    import jax.numpy as jnp
    return {k: jnp.moveaxis(jnp.asarray(v), 0, -1)
            for k, v in cvt.rows_to_numpy(rows_T).items()}


_RUNS = {}


def _run(case):
    """Per fired family: (name, port family_delta rows [P, T, cap], the
    port's direct per-permutation hashes of the same rows, the JAX
    family_delta rows); plus the parent tables of both sides and the
    pieces for the expander-hook check.  The JAX side runs as one jitted
    function per case."""
    if case in _RUNS:
        return _RUNS[case]
    import jax
    import jax.numpy as jnp
    from raft_tla_tpu.engine.fingerprint import RaftFingerprinter as JF
    jc, tc = _cfgs(case)
    arrs = _parents(case)
    tx = Expander(tc, torch.device("cpu"))
    fpr = RaftFingerprinter(tc)
    assert fpr.supports_incremental()
    jfp = JF(jc, sym_canon="minperm")
    svT = cvt.rows_to_torch(arrs)
    der = tx.kern.derived(svT)
    lanes = tx.guards_T(svT, der).reshape(-1).nonzero().squeeze(1)
    tables = fpr.parent_tables(svT)
    c = fpr._consts(torch.device("cpu"))
    A = tx.n_lanes
    fams, jin = [], []
    for fi, fam in enumerate(tx.families):
        lf = lanes[tx._fam_of[lanes % A] == fi]
        if lf.numel() == 0:
            continue
        b = lf // A
        prm = [p[lf % A - int(tx.lane_off[fi])] for p in tx._params[fi]]
        par = {k: v[..., b] for k, v in svT.items()}
        cand = {k: v.to(torch.int32) for k, v in fam.fn(
            par, {k: v[..., b] for k, v in der.items()}, *prm).items()}
        got = fpr.family_delta(fam.name, tables, b, par, cand, prm)
        prep = fpr._prep(cand)
        direct = torch.stack([fpr._hash_under(prep, c["sigmas"][p],
                                              c["psalts"][p])
                              for p in range(len(fpr.sigmas))])
        fams.append((fam.name, got, direct))
        jin.append((jnp.asarray(b.numpy()), _jt(par), _jt(cand),
                    [jnp.asarray(p.numpy()) for p in prm]))

    def ref(svTj, jin):
        jtab = jfp.parent_tables(svTj)
        return jtab, [jfp.family_delta(name, jtab, *x)
                      for (name, _g, _d), x in zip(fams, jin)]

    svTj = {k: jnp.moveaxis(jnp.asarray(v), 0, -1) for k, v in arrs.items()}
    jtab, jout = jax.jit(ref)(svTj, jin)
    _RUNS[case] = dict(
        fams=[(n, g, d, np.asarray(w)) for (n, g, d), w in zip(fams, jout)],
        tables=tables, jtab={k: np.asarray(v) for k, v in jtab.items()},
        tx=tx, fpr=fpr, svT=svT, der=der, lanes=lanes)
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_parent_tables_match_jax(case):
    r = _run(case)
    for k in ("posterm", "bagterm", "h"):
        np.testing.assert_array_equal(
            r["tables"][k].numpy().view(np.uint32), r["jtab"][k], err_msg=k)
    fpr = r["fpr"]
    assert torch.equal(fpr.finish_min(r["tables"]["h"]),
                       fpr.fingerprint_batch_T(r["svT"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_delta_matches_direct_and_jax(case):
    r = _run(case)
    for name, got, direct, want in r["fams"]:
        np.testing.assert_array_equal(got.numpy(), direct.numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want,
                                      err_msg=name)
    # every family fired (CheckOldConfig messages, which CocDiscard
    # receives, exist only under NextDynamic)
    fired = {name for name, *_x in r["fams"]}
    want = {f.name for f in r["tx"].families}
    if case != "dynamic":
        want -= {"CocDiscard"}
    assert fired == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_materialize_hook_gives_the_direct_fingerprints(case):
    r = _run(case)
    tx, fpr = r["tx"], r["fpr"]
    B = r["svT"]["ct"].shape[-1]
    okf = torch.zeros(B * tx.n_lanes, dtype=torch.bool)
    okf[r["lanes"]] = True
    epos, n_e = compact_positions(okf, int(okf.sum()))
    args = (r["svT"], r["der"], okf, epos, int(n_e),
            tuple(B * f.n_lanes for f in tx.families))
    cand, _counts, fp = tx.materialize(*args, delta_fp=(fpr, r["tables"]))
    assert torch.equal(fp, fpr.fingerprint_batch_T(cand))
    want, _counts = tx.materialize(*args)
    for k in want:
        assert torch.equal(cand[k], want[k]), k


def test_incremental_support_gate():
    """As the reference: minperm with at most 24 permutations; never in
    sort mode; P=120 (S=5, all initial) falls back to the direct path."""
    _jc, tc = _cfgs("s3")
    assert RaftFingerprinter(tc, "minperm").supports_incremental()
    assert not RaftFingerprinter(tc, "sort").supports_incremental()
    s5 = tc.with_(n_servers=5, init_servers=(0, 1, 2, 3, 4))
    assert not RaftFingerprinter(s5, "minperm").supports_incremental()
