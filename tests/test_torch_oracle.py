"""The port's copy of the oracle (``models/raft.py``,
``models/predicates.py``, ``models/explore.py``) against the reference
package's: ``successors`` label for label and state for state on every
state the reference ``explore`` reaches on micro configs (NextAsync,
NextAsyncCrash and NextDynamic, symmetry on and off); ``explore``'s
counts, level sizes, violations and traces; the JSON seed format; and
the random-walk twin.  Pure Python on both sides: no engine compiles.
"""

import json

import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC

from raft_tla_tpu_torch.config import (Bounds, ModelConfig, NEXT_ASYNC,
                                       NEXT_ASYNC_CRASH, NEXT_DYNAMIC)

torch.set_num_threads(1)

MICROS = {
    "async": (dict(n_servers=2, init_servers=(0, 1), values=(1,),
                   next_family=NEXT_ASYNC, max_inflight_override=2),
              dict(max_log_length=1, max_timeouts=1,
                   max_client_requests=1), 14),
    "crash": (dict(n_servers=2, init_servers=(0, 1), values=(1,),
                   next_family=NEXT_ASYNC_CRASH, max_inflight_override=3),
              dict(max_log_length=1, max_timeouts=1,
                   max_client_requests=1), 14),
    "dynamic": (dict(n_servers=3, init_servers=(0, 1), values=(1,),
                     next_family=NEXT_DYNAMIC, max_inflight_override=2),
                dict(max_log_length=1, max_timeouts=1,
                     max_client_requests=1, max_membership_changes=1), 14),
}


def cfgs(name, symmetry, **extra):
    shape, bounds, _depth = MICROS[name]
    jc = JC(bounds=JB.make(**bounds), symmetry=symmetry, **shape, **extra)
    tc = ModelConfig(bounds=Bounds.make(**bounds), symmetry=symmetry,
                     **shape, **extra)
    assert repr(jc) == repr(tc)
    return jc, tc


@pytest.mark.parametrize("symmetry", [True, False], ids=["sym", "nosym"])
@pytest.mark.parametrize("name", sorted(MICROS))
def test_successors_equal_the_reference(name, symmetry):
    from raft_tla_tpu.models.explore import explore as jexplore
    from raft_tla_tpu.models.raft import successors as jsucc
    from raft_tla_tpu_torch.spec import get_spec
    successors = get_spec("raft").oracle_successors
    jc, tc = cfgs(name, symmetry)
    ref = jexplore(jc, max_depth=MICROS[name][2], keep_states=True)
    n = 0
    for sv, h in ref.states.values():
        want = jsucc(sv, h, jc)
        got = successors(sv, h, tc)
        assert [lbl for lbl, _, _ in got] == [lbl for lbl, _, _ in want]
        assert [(s, hh) for _, s, hh in got] == \
            [(s, hh) for _, s, hh in want]
        n += len(got)
    assert len(ref.states) > 100 and n > len(ref.states)


@pytest.mark.parametrize("kw", [
    dict(stop_on_violation=True), dict(stop_on_violation=False)],
    ids=["stop", "keep-going"])
@pytest.mark.parametrize("name", sorted(MICROS))
def test_explore_equals_the_reference(name, kw):
    """Counts, level sizes and every violation with its trace and
    state, with a scenario invariant that the micro reaches."""
    from raft_tla_tpu.models.explore import explore as jexplore
    from raft_tla_tpu_torch.models.explore import explore
    inv = ("ElectionSafety", "FirstBecomeLeader", "FirstCommit")
    jc, tc = cfgs(name, True, invariants=inv)
    depth = MICROS[name][2]
    want = jexplore(jc, max_depth=depth, trace_violations=True, **kw)
    got = explore(tc, max_depth=depth, trace_violations=True, **kw)
    assert (got.distinct_states, got.generated_states, got.depth,
            got.level_sizes) == (want.distinct_states,
                                 want.generated_states, want.depth,
                                 want.level_sizes)
    assert got.violations and len(got.violations) == len(want.violations)
    for g, w in zip(got.violations, want.violations):
        assert (g.invariant, g.trace, g.state, g.hist) == \
            (w.invariant, w.trace, w.state, w.hist)


def test_seed_json_round_trips_as_the_reference():
    """state_to_obj writes the reference's JSON, and state_from_obj
    reads it back, on every state of a NextDynamic micro (membership
    entries, catch-up messages)."""
    from raft_tla_tpu.models.explore import explore as jexplore
    from raft_tla_tpu.models.raft import (state_from_obj as jfrom,
                                          state_to_obj as jto)
    from raft_tla_tpu_torch.models.raft import state_from_obj, state_to_obj
    jc, _tc = cfgs("dynamic", False)
    ref = jexplore(jc, max_depth=4, keep_states=True)
    for sv, h in ref.states.values():
        text = json.dumps(state_to_obj(sv, h))
        assert text == json.dumps(jto(sv, h))
        assert state_from_obj(json.loads(text)) == jfrom(json.loads(text))
        assert state_from_obj(json.loads(text)) == (sv, h)


def test_random_walk_and_replay_equal_the_reference():
    """The random-walk twin draws the same walk from the same seed, and
    oracle_validates_walk replays it with the same labels."""
    from raft_tla_tpu.models import explore as J
    from raft_tla_tpu_torch.models import explore as T
    jc, tc = cfgs("crash", True, invariants=("FirstCommit",))
    for seed in (0, 3):
        want = J.random_walk(jc, steps=300, max_depth=12, seed=seed,
                             stop_on_hit=False)
        got = T.random_walk(tc, steps=300, max_depth=12, seed=seed,
                            stop_on_hit=False)
        assert (got.steps, got.restarts, got.deadlocks, got.sampled,
                got.distinct_states, len(got.hits)) == \
            (want.steps, want.restarts, want.deadlocks, want.sampled,
             want.distinct_states, len(want.hits))
    from raft_tla_tpu_torch.models.golden import replay
    chain = replay(["Timeout(0)", "RequestVote(0,0)", "RequestVote(0,1)"],
                   tc)
    states = [sv for sv, _h in chain]
    assert T.oracle_validates_walk(tc, states) == \
        J.oracle_validates_walk(jc, states)
    from raft_tla_tpu_torch.spec import get_spec
    assert get_spec("raft").oracle_walk_key(states[-1]) == \
        J._walk_key(states[-1])
