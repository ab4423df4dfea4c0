"""The membership hunt of tests/test_sim.py in both packages on the CPU:
the port's hit (walker, depth, lanes), its stats, its decode (labels,
states, the end state's arrays), validated by the port's oracle, and
its seed file equal the reference's.  And the gating that lets the
walker step run as one fixed program: sampling rounds after every
walker is done, and steps after the fleet's hit, change nothing; the
step reads nothing back.  One JAX compile.
"""

import json

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch.sim import SimEngine
from raft_tla_tpu_torch.sim.walker import ST_HIT, ST_ITERS
from test_torch_chunk_step_ocap import NoHostRead
from test_torch_sim import MEMBER_KW, _assert_same, _cfgs, _leaves

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def member():
    """The membership hunt in both packages: (JAX engine, its result,
    port engine, its result)."""
    from raft_tla_tpu.sim import SimEngine as JSim
    jc, tc = _cfgs("member")
    je = JSim(jc, **MEMBER_KW)
    te = SimEngine(tc, device="cpu", **MEMBER_KW)
    return je, je.run(steps=4000), te, te.run(steps=4000)


def _summary(r):
    return (r.walkers, r.steps_dispatched, r.walker_steps, r.sampled_steps,
            r.restarts, r.deadlocks, r.promotions, r.bloom_bits_set,
            r.bloom_m_bits, r.bloom_saturated, r.bloom_canonical,
            r.est_distinct_states,
            [(h.invariant, h.walker, h.depth, h.lanes) for h in r.hits])


def test_member_hunt_matches_jax(member):
    from raft_tla_tpu.cli import _seed_obj as jseed
    from raft_tla_tpu.spec import get_spec as jget
    from raft_tla_tpu_torch.cli import _seed_obj as tseed
    from raft_tla_tpu_torch.models.explore import oracle_validates_walk
    from raft_tla_tpu_torch.spec import get_spec
    je, jr, te, tr = member
    assert _summary(tr) == _summary(jr)
    assert tr.hits and tr.hits[0].depth > 10
    hj, ht = je.decode_hit(jr.hits[0]), te.decode_hit(tr.hits[0])
    assert [lbl for lbl, _ in ht.trace] == [lbl for lbl, _ in hj.trace]
    assert [repr(sv) for _, sv in ht.trace] == \
        [repr(sv) for _, sv in hj.trace]
    for k, v in hj.state_arrs.items():
        assert ht.state_arrs[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(ht.state_arrs[k], v, err_msg=k)
    walk = oracle_validates_walk(te.cfg, [sv for _, sv in ht.trace])
    assert len(walk) == ht.depth
    want = jseed(jget("raft"), hj.trace[-1][1], hj.hist, hj.state_arrs)
    got = tseed(get_spec("raft"), ht.trace[-1][1], ht.hist, ht.state_arrs)
    assert json.dumps(got) == json.dumps(want)


def test_a_step_after_the_hit_changes_nothing(member):
    """The dispatch's gate: once the fleet has hit, a step with
    stop_on_hit leaves every leaf as it was and does not count."""
    _je, _jr, te, _tr = member
    st = te.fresh_carry()
    te._dispatch(st, 100)
    assert bool(st["stats"][ST_HIT])
    before = _leaves(st, True)
    te._step_into(st, True)
    _assert_same(_leaves(st, True), before)
    te._step_into(st, False)          # ungated, the fleet moves on
    assert _leaves(st, True)["stats"][ST_ITERS] == \
        before["stats"][ST_ITERS] + 1


def test_rounds_after_every_walker_is_done_change_nothing(member):
    """The reference ends its rejection rounds once every walker is
    done; the port runs all 8.  Along the hunt's steps, every round after
    that point leaves the step's outputs as they were."""
    _je, _jr, te, _tr = member
    st = te.fresh_carry()
    needed = []
    for _ in range(12):
        svT = st["sv"]
        derT = te.expander.derived_batch_T(svT)
        ok0 = te.expander.guards_T(svT, derT)
        c = te._rounds_init(svT, ok0, st["hit"], st["key"])
        n = 0
        while not bool(c["done"].all()) and n < te._MAX_TRIES:
            c = te._round(svT, derT, c)
            n += 1
        needed.append(n)
        ref = {k: c[k] for k in ("key", "lane", "acc", "hitrow", "hinv",
                                 "sampled", "okm", "done")}
        for _ in range(n, te._MAX_TRIES):
            c = te._round(svT, derT, c)
        for k, v in ref.items():
            assert torch.equal(c[k], v), k
        te._step_into(st, True)
    assert max(needed) > 1 and min(needed) < te._MAX_TRIES


def test_the_step_reads_nothing_back():
    """Every walker step of a dispatch runs under a guard that refuses
    host reads and host data (after the first, the warm-up, which may
    build what it caches); the host reads the stats once per dispatch."""
    _jc, tc = _cfgs("member")
    eng = SimEngine(tc, device="cpu", **MEMBER_KW)
    calls = [0]
    step = eng.step

    def guarded(st, *a):
        with NoHostRead(warm_up=calls[0] == 0):
            out = step(st, *a)
        calls[0] += 1
        return out
    eng.step = guarded
    r = eng.run(steps=12, steps_per_dispatch=4, stop_on_hit=False)
    assert calls[0] == 12 and r.steps_dispatched == 12
