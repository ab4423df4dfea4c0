"""Runtime thresholds and bounds of the padded serving ceilings against
the JAX package, on reachable rows: ``Expander.guards_T(..., rt)`` with
one job's or J jobs' thresholds and lane masks (one product over all
the jobs' rows), ``Engine._phase2_T(..., rtb)`` with one job's or per-row
bounds, and the job-axis compaction (``materialize(jobs=J)``,
``Engine._expand_fp_chunk(jobs=J)``) against J one-job calls.  Rows are
each job's reachable states (the oracle) in its bucket ceiling's
layout, as the batched burst holds them."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from raft_tla_tpu.engine.bfs import Engine as REngine  # noqa: E402
from raft_tla_tpu.engine.expand import Expander as RExpander  # noqa: E402
from raft_tla_tpu.spec import spec_of as r_spec_of  # noqa: E402
from raft_tla_tpu.config import Bounds as RBounds  # noqa: E402
from raft_tla_tpu.config import ModelConfig as RModel  # noqa: E402
from raft_tla_tpu.spec.paxos.config import PaxosConfig as RPax  # noqa: E402

from raft_tla_tpu_torch.config import Bounds, ModelConfig  # noqa: E402
from raft_tla_tpu_torch.convert import rows_to_torch  # noqa: E402
from raft_tla_tpu_torch.engine.bfs import Engine  # noqa: E402
from raft_tla_tpu_torch.engine.expand import Expander  # noqa: E402
from raft_tla_tpu_torch.spec import spec_of  # noqa: E402
from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig  # noqa: E402

CPU = torch.device("cpu")


def _raft(M, B, mll, mt, mcr):
    return M(n_servers=2, init_servers=(0, 1), values=(1,),
             next_family="NextAsync", symmetry=True,
             max_inflight_override=4,
             bounds=B.make(max_log_length=mll, max_timeouts=mt,
                           max_client_requests=mcr))


# one bucket per spec: jobs of different bounds under one ceiling
BUCKETS = {
    "raft": (lambda M, B, P: [_raft(M, B, 1, 1, 1), _raft(M, B, 2, 1, 2),
                              _raft(M, B, 1, 2, 2)], 5),
    "paxos": (lambda M, B, P: [P(n_servers=2, n_ballots=2, n_values=1),
                               P(n_servers=2, n_ballots=1, n_values=2),
                               P(n_servers=2, n_ballots=2, n_values=2)],
              6),
}

_MEMO = {}


def _bucket(name):
    """(port jobs, reference jobs, port ceiling, reference ceiling, the
    jobs' reachable rows in the ceiling's layout [n, ...] per job)."""
    if name in _MEMO:
        return _MEMO[name]
    make, depth = BUCKETS[name]
    pjobs = make(ModelConfig, Bounds, PaxosConfig)
    rjobs = make(RModel, RBounds, RPax)
    ir = spec_of(pjobs[0])
    ceils = {repr(ir.serve_bucket(c)[0]) for c in pjobs}
    assert len(ceils) == 1, ceils          # one bucket
    ceil = ir.serve_bucket(pjobs[0])[0]
    rceil = r_spec_of(rjobs[0]).serve_bucket(rjobs[0])[0]
    lay = ir.make_layout(ceil)
    rows = []
    for c in pjobs:
        res = ir.oracle_explore(c, max_depth=depth, keep_states=True)
        enc = [ir.encode(lay, sv, h) for sv, h in res.states.values()]
        rows.append({k: np.stack([e[k] for e in enc]) for k in enc[0]})
    _MEMO[name] = (pjobs, rjobs, ceil, rceil, rows)
    return _MEMO[name]


def _ref_T(rows):
    return {k: jnp.asarray(np.moveaxis(v, 0, -1)) for k, v in rows.items()}


def _cat(rows):
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


@pytest.mark.parametrize("name", sorted(BUCKETS))
def test_guards_rt_equal_reference_per_job_and_stacked(name):
    """The guard product with runtime data equals the reference's, job
    by job and with the J jobs' rows in one product; the port's plain
    (terms) form equals its product form under the same data."""
    pjobs, rjobs, ceil, rceil, rows = _bucket(name)
    ir = spec_of(ceil)
    pex = Expander(ceil, CPU)
    pex_terms = Expander(ceil, CPU, guard_matmul=False)
    rex = RExpander(rceil)
    rts = [ir.serve_runtime(pex, c) for c in pjobs]
    n = min(64, min(len(next(iter(r.values()))) for r in rows))
    blocks = [{k: v[:n] for k, v in r.items()} for r in rows]
    want = []
    for rc, blk in zip(rjobs, blocks):
        rt = r_spec_of(rc).serve_runtime(rex, rc)
        svT = _ref_T(blk)
        want.append(np.asarray(rex.guards_T(
            svT, rex.derived_batch_T(svT),
            {k: jnp.asarray(v) for k, v in rt.items()})))
    for rt, blk, w in zip(rts, blocks, want):
        sv = rows_to_torch(blk, CPU, ir.u32_keys)
        got = pex.guards_T(sv, pex.derived_batch_T(sv),
                           {k: torch.from_numpy(v) for k, v in rt.items()})
        assert (got.numpy() == w).all()
    # the J jobs' rows in one call: one product, each job's thresholds
    sv = rows_to_torch(_cat(blocks), CPU, ir.u32_keys)
    rtJ = {k: torch.from_numpy(np.stack([rt[k] for rt in rts]))
           for k in ("thr", "mask")}
    got = pex.guards_T(sv, pex.derived_batch_T(sv), rtJ)
    assert (got.numpy() == np.concatenate(want)).all()
    terms = pex_terms.guards_T(sv, pex_terms.derived_batch_T(sv), rtJ)
    assert torch.equal(terms, got)
    if name == "paxos":
        # the lane masks differ between jobs: the padding really masks
        assert not (rts[0]["mask"] == rts[1]["mask"]).all()


@pytest.mark.parametrize("name", sorted(BUCKETS))
def test_phase2_rtb_equal_reference_and_per_row(name):
    pjobs, rjobs, ceil, rceil, rows = _bucket(name)
    ir = spec_of(ceil)
    peng = Engine(ceil, device="cpu")
    reng = REngine(rceil)
    bounds = [ir.serve_runtime(peng.expander, c)["bounds"] for c in pjobs]
    outs = []
    for rc, blk, b in zip(rjobs, rows, bounds):
        w_inv, w_con = reng._phase2_T(_ref_T(blk), jnp.asarray(b))
        sv = rows_to_torch(blk, CPU, ir.u32_keys)
        inv, con = peng._phase2_T(sv, b)
        assert (inv.numpy() == np.asarray(w_inv)).all()
        assert (con.numpy() == np.asarray(w_con)).all()
        outs.append((inv, con))
        # rtb=None: the ceiling's own bounds, as before
        n_inv, n_con = peng._phase2_T(sv)
        r_inv, r_con = reng._phase2_T(_ref_T(blk))
        assert (n_inv.numpy() == np.asarray(r_inv)).all()
        assert (n_con.numpy() == np.asarray(r_con)).all()
    # per-row bounds [NB, N] over all jobs' rows at once
    sv = rows_to_torch(_cat(rows), CPU, ir.u32_keys)
    per_row = torch.from_numpy(np.concatenate(
        [np.repeat(b[None], len(next(iter(r.values()))), 0)
         for b, r in zip(bounds, rows)]).T.copy())
    inv, con = peng._phase2_T(sv, per_row)
    assert torch.equal(inv, torch.cat([o[0] for o in outs], 1))
    assert torch.equal(con, torch.cat([o[1] for o in outs]))
    if name == "raft":
        # the bounds are read from the vector: MaxTimeouts 0 prunes the
        # rows with a timeout, which the jobs' own bounds keep
        from raft_tla_tpu_torch.ops.vpredicates import RB_TIMEOUTS
        tight = bounds[0].copy()
        tight[RB_TIMEOUTS] = 0
        assert int(peng._phase2_T(sv, tight)[1].sum()) < int(con.sum())


@pytest.mark.parametrize("name", sorted(BUCKETS))
@pytest.mark.parametrize("delta_matmul", [True, False])
def test_expand_fp_chunk_jobs_equals_one_job_calls(name, delta_matmul):
    """The job-axis front half (per-job compaction into side-by-side
    FCAP buffers, the (family, job) materialize plan, per-job counts)
    equals J one-job calls column for column."""
    pjobs, _rjobs, ceil, _rceil, rows = _bucket(name)
    ir = spec_of(ceil)
    eng = Engine(ceil, chunk=16, device="cpu", delta_matmul=delta_matmul)
    B, J, F = eng.chunk, len(pjobs), eng.FCAP
    rts = [ir.serve_runtime(eng.expander, c) for c in pjobs]
    svs, valids = [], []
    for r in rows:
        blk = {k: np.resize(v, (B,) + v.shape[1:]) for k, v in r.items()}
        svs.append(rows_to_torch(blk, CPU, ir.u32_keys))
        valids.append(torch.arange(B) < min(B, len(r["ctr"])) - 1)
    one = [eng._expand_fp_chunk(
        sv, va, F, rt={k: torch.from_numpy(v) for k, v in rt.items()})
        for sv, va, rt in zip(svs, valids, rts)]
    sv = {k: torch.cat([s[k] for s in svs], -1) for k in svs[0]}
    rtJ = {k: torch.from_numpy(np.stack([rt[k] for rt in rts]))
           for k in ("thr", "mask", "bounds")}
    cand, elive, keys, lanes, counts, n_e, n_gen, _nh = \
        eng._expand_fp_chunk(sv, torch.cat(valids), F, rt=rtJ, jobs=J,
                             hcap=J * F)
    for j, (c1, e1, k1, l1, cn1, ne1, ng1, _h) in enumerate(one):
        sl = slice(j * F, (j + 1) * F)
        live = e1.numpy()
        assert (elive[sl].numpy() == live).all()
        assert int(n_e[j]) == int(ne1) and int(n_gen[j]) == int(ng1)
        assert (counts[j].numpy() == cn1.numpy()).all()
        assert (keys[:, sl].numpy()[:, live] == k1.numpy()[:, live]).all()
        # flat lane ids: job j's rows sit j*B rows down
        assert (lanes[sl].numpy()[live] ==
                l1.numpy()[live] + j * B * eng.A).all()
        for k in c1:
            assert (cand[k][..., sl].numpy()[..., live] ==
                    c1[k].numpy()[..., live]).all(), k
