"""The port's fused small-level path in sort mode and with violations.

Sort mode on the S=4 membership micro config (test_torch_engine_sort.py's
"s4dyn", P = 6) with a one-lane hard-lane buffer: the micro config has
no hard lanes, so a stand-in fingerprinter reports every live lane as
hard (the keys stay exact); every chunk then overflows HCAP, which bails
the burst before its dedup launch, and the per-level path grows HCAP
and replays the level.  Burst on and off give identical archives and
the oracle's answer.  And a violation found inside a burst stops
``stop_on_violation`` at the JAX package's state (tests/test_burst.py's
FirstBecomeLeader case, against the reference's Engine(burst=True)).
"""

import torch

from raft_tla_tpu_torch.engine.bfs import Engine

from conftest import cached_explore
from test_torch_engine_burst import archives_equal, cfgs, summary
from test_torch_engine_sort import _cfgs as sort_cfgs

torch.set_num_threads(1)


def every_live_lane_hard(eng):
    """The fingerprinter reports each chunk's live lanes as hard lanes
    on top of the real ones; the fingerprints are unchanged."""
    fn = eng.fpr.fingerprint_chunk_T

    def wrapped(cand, hcap, live=None):
        keys, n_hard = fn(cand, hcap, live=live)
        return keys, n_hard + live.sum()
    eng.fpr.fingerprint_chunk_T = wrapped


def test_hard_lane_bails_in_sort_mode_keep_the_answer():
    jc, tc, _depth = sort_cfgs("s4dyn")
    depth = 9
    runs = {}
    for burst in (True, False):
        eng = Engine(tc, chunk=64, hcap=1, sym_canon="sort", burst=burst,
                     device="cpu")
        every_live_lane_hard(eng)
        runs[burst] = (eng, eng.check(max_depth=depth))
    (on, r_on), (off, r_off) = runs[True], runs[False]
    assert r_on.burst_bailouts >= 2 and r_on.levels_fused > 0
    assert on.HCAP > 1 and off.HCAP > 1
    s_on, s_off = summary(r_on), summary(r_off)
    for k in ("fused", "dispatches", "bailouts"):
        s_off[k] = s_on[k]
    assert s_on == s_off
    archives_equal(on, off)
    ref = cached_explore(jc, max_depth=depth)
    assert (r_on.distinct_states, r_on.depth, r_on.level_sizes) == \
        (ref.distinct_states, ref.depth, list(ref.level_sizes))


def test_stop_on_violation_inside_a_burst_matches_jax():
    from raft_tla_tpu.engine.bfs import Engine as JEngine
    jc, tc = cfgs()
    extra = ("FirstBecomeLeader",)
    je = JEngine(jc.with_(invariants=jc.invariants + extra), chunk=64,
                 burst=True, store_states=False)
    want = je.check(stop_on_violation=True)
    got = {}
    for burst in (True, False):
        eng = Engine(tc.with_(invariants=tc.invariants + extra), chunk=64,
                     burst=burst, store_states=False, device="cpu")
        got[burst] = eng.check(stop_on_violation=True)
    assert summary(got[True]) == summary(want)
    assert got[True].levels_fused > 0 and want.violations
    for res in got.values():
        v, w = res.violations[0], want.violations[0]
        assert (v.invariant, v.state_id) == (w.invariant, w.state_id)
        assert v.state == w.state and v.hist == w.hist
