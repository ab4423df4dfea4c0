"""The punctuated search in the port's engine on the CPU: a micro config
(3 servers, NextAsync, MaxInFlight 2, L=1, two client requests, terms
to 4) pinned by the cfg to the ConcurrentLeaders witness
(``CommitWhenConcurrentLeaders_unique``, raft.tla:1198-1204), pruned by
``CommitWhenConcurrentLeaders_action_constraint`` (raft.tla:1207-1210)
and checked for CommitWhenConcurrentLeaders to depth 8 past the seed,
without stopping at a violation.  The port's Engine, burst on and off
in every ``sym_canon``, must equal the JAX package's Engine (one
compile) in distinct states, generated states, level sizes, violations
with their gids, ``pin_interior_states`` and the first witness trace,
and the oracles; the same search from explicit seeds ((State, Hist)
pairs or raw SoA rows) must equal the pinned one; a violation inside
the pinned prefix carries state_id -1; and a step with the action
constraint's mask reads nothing back.
"""

import json

import numpy as np
import pytest
import torch

from conftest import cached_explore
from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC
from raft_tla_tpu.config import NEXT_ASYNC as J_ASYNC

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.bfs import Engine

from test_torch_chunk_step_ocap import NoHostRead, guard

torch.set_num_threads(1)

PIN = "CommitWhenConcurrentLeaders_unique"
ACT = "CommitWhenConcurrentLeaders_action_constraint"
SHAPE = dict(n_servers=3, init_servers=(0, 1, 2), values=(1,),
             symmetry=True, max_inflight_override=2, prefix_pins=(PIN,),
             action_constraints=(ACT,),
             invariants=("CommitWhenConcurrentLeaders",))
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=2,
              max_terms=4)
DEPTH = 8


def cfgs():
    jc = JC(next_family=J_ASYNC, bounds=JB.make(**BOUNDS), **SHAPE)
    tc = ModelConfig(next_family=NEXT_ASYNC, bounds=Bounds.make(**BOUNDS),
                     **SHAPE)
    assert repr(jc) == repr(tc)
    return jc, tc


def summary(res):
    return dict(
        distinct=res.distinct_states, generated=res.generated_states,
        depth=res.depth, level_sizes=list(res.level_sizes),
        viol_global=res.violations_global,
        pin_interior=res.pin_interior_states,
        violations=[(v.invariant, v.state_id) for v in res.violations])


_JAX = {}


def jax_run():
    """The JAX package's Engine on the pinned micro config: its
    summary and the trace of its first violation."""
    if "r" not in _JAX:
        from raft_tla_tpu.engine.bfs import Engine as JEngine
        je = JEngine(cfgs()[0], chunk=64, burst=False)
        res = je.check(max_depth=DEPTH)
        _JAX["r"] = (summary(res), je.trace(res.violations[0].state_id))
    return _JAX["r"]


@pytest.mark.parametrize("sym_canon", ["auto", "sort", "minperm"])
@pytest.mark.parametrize("burst", [False, True], ids=["levels", "burst"])
def test_pinned_search_matches_jax(burst, sym_canon):
    want, want_trace = jax_run()
    eng = Engine(cfgs()[1], chunk=64, burst=burst, sym_canon=sym_canon,
                 device="cpu")
    res = eng.check(max_depth=DEPTH)
    got = summary(res)
    assert got == want
    assert got["pin_interior"] == 18 and len(got["violations"]) > 1
    assert (res.levels_fused > 0) == burst
    trace = eng.trace(res.violations[0].state_id)
    assert [lbl for lbl, _ in trace] == [lbl for lbl, _ in want_trace]
    assert [sv for _, sv in trace] == [sv for _, sv in want_trace]


def test_pinned_search_matches_the_oracles():
    """Both oracles (the reference's and the port's copy) and the engine
    agree, and the action constraint prunes: without it the same
    search generates more."""
    from raft_tla_tpu_torch.models.explore import explore
    jc, tc = cfgs()
    ref = cached_explore(jc, max_depth=DEPTH)
    mine = explore(tc, max_depth=DEPTH)
    want = jax_run()[0]
    for r in (ref, mine):
        assert (r.distinct_states, r.generated_states, r.depth,
                list(r.level_sizes), r.pin_interior_states,
                len(r.violations)) == (
            want["distinct"], want["generated"], want["depth"],
            want["level_sizes"], want["pin_interior"],
            len(want["violations"]))
    pruned = explore(tc, max_depth=6)
    free = explore(tc.with_(action_constraints=()), max_depth=6)
    assert free.generated_states > pruned.generated_states


def test_seeds_equal_the_pins():
    """The same search from explicit seeds: the pins' witness end state
    as a (State, Hist) pair and as a raw SoA row (an engine-emitted
    seed keeps its non-VIEW lanes) gives the pinned run's answer, less
    the interior states that only the pins replay."""
    from raft_tla_tpu_torch.models.golden import prefix_pin_seeds
    _jc, tc = cfgs()
    pinned = summary(Engine(tc, chunk=64, device="cpu").check(
        max_depth=DEPTH))
    free = tc.with_(prefix_pins=())
    seeds = prefix_pin_seeds(tc)
    eng = Engine(free, chunk=64, device="cpu")
    raw = [eng.ir.encode(eng.lay, *s) for s in seeds]
    for seed_states in (seeds, raw + seeds):
        got = summary(Engine(free, chunk=64, device="cpu").check(
            max_depth=DEPTH, seed_states=seed_states))
        assert got == dict(pinned, pin_interior=0)


def test_pin_interior_violation_has_no_state_id():
    """FirstBecomeLeader holds at Init and fails inside the pinned
    prefix (BecomeLeader(0) is its ninth step): the interior state is
    reported with state_id -1, as the oracle reports it, and a stopping
    run ends after the root level."""
    from raft_tla_tpu_torch.models.explore import explore
    _jc, tc = cfgs()
    cfg = tc.with_(invariants=("FirstBecomeLeader",))
    oracle = explore(cfg, max_depth=2, stop_on_violation=True)
    res = Engine(cfg, chunk=64, device="cpu").check(
        max_depth=2, stop_on_violation=True)
    assert res.violations and res.violations[0].state_id == -1
    assert [v.invariant for v in res.violations] == \
        [v.invariant for v in oracle.violations]
    assert [v.state for v in res.violations] == \
        [v.state for v in oracle.violations]
    assert res.depth == oracle.depth == 0
    assert res.pin_interior_states == oracle.pin_interior_states == 18


def test_step_with_the_mask_reads_nothing_back(monkeypatch):
    """Every chunk step and burst iteration of the pinned search to
    depth 5, the action constraint's mask included, reads nothing back
    (tiny capacities, so replays run guarded too); the mask is part of
    the graph key."""
    _jc, tc = cfgs()
    tiny = dict(chunk=16, lcap=64, vcap=64, ocap=16, fcap=32,
                device="cpu")
    want = summary(Engine(tc, chunk=64, device="cpu").check(max_depth=5))
    eng = Engine(tc, **tiny)
    from raft_tla_tpu_torch.engine import bfs
    twin = bfs.probe_claim_insert

    def paused_twin(*a):
        NoHostRead.paused = True
        try:
            return twin(*a)
        finally:
            NoHostRead.paused = False
    monkeypatch.setattr(bfs, "probe_claim_insert", paused_twin)
    steps = guard(eng, "_chunk_step", "step")
    bodies = guard(eng, "_burst_body", "burst")
    assert summary(eng.check(max_depth=5)) == want
    assert steps[0] > 0 and bodies[0] > 0
    eng = Engine(tc, **tiny)
    plain = Engine(tc.with_(action_constraints=()), **tiny)
    st = bfs._Level(eng, eng.LCAP, eng._new_table(eng.VCAP))
    assert eng._graph_key("step", st)[:-1] == \
        plain._graph_key("step", st)[:-1]
    assert eng._graph_key("step", st) != plain._graph_key("step", st)


def test_device_action_constraint_equals_the_oracle():
    """``Predicates.action_fn`` on batch-last (parent, successor) rows
    equals the reference's oracle action constraint (and the port's
    copy of it) on every transition out of the pinned micro's states to
    depth 2, and an unknown name raises the reference's KeyError
    text."""
    from raft_tla_tpu.models import predicates as JOP
    from raft_tla_tpu.models.raft import state_from_obj as jfrom
    from raft_tla_tpu.ops.vpredicates import Predicates as JPredicates
    from raft_tla_tpu.ops.layout import Layout as JLayout
    from raft_tla_tpu_torch.convert import rows_to_torch
    from raft_tla_tpu_torch.models import predicates as OP
    from raft_tla_tpu_torch.models.explore import explore
    from raft_tla_tpu_torch.models.raft import state_to_obj, successors
    from raft_tla_tpu_torch.ops.codec import encode
    from raft_tla_tpu_torch.ops.layout import Layout
    from raft_tla_tpu_torch.ops.vpredicates import Predicates
    jc, tc = cfgs()
    lay = Layout(tc)
    res = explore(tc, max_depth=2, keep_states=True)
    # the transitions into rows the layout holds (the constraints prune
    # the others before they are ever encoded)
    pairs = [(encode(lay, s, h), encode(lay, s2, h2), (s, h, s2, h2))
             for s, h in res.states.values()
             for _lbl, s2, h2 in successors(s, h, tc)
             if all(len(lg) <= lay.Lcap for lg in s2.log)]

    def ref(s, h):
        return jfrom(json.loads(json.dumps(state_to_obj(s, h))))
    want = [JOP.ACTION_CONSTRAINTS[ACT](*ref(*p[2][:2]), *ref(*p[2][2:]),
                                        jc) for p in pairs]
    assert 0 < sum(want) < len(want)
    assert [OP.ACTION_CONSTRAINTS[ACT](*p[2], tc) for p in pairs] == want

    def rows(enc):
        return rows_to_torch({k: np.stack([e[k] for e in enc])
                              for k in enc[0]})
    par = rows([p[0] for p in pairs])
    cand = rows([p[1] for p in pairs])
    got = Predicates(lay).action_fn(ACT)(par, cand)
    assert got.tolist() == want
    msgs = []
    for preds in (Predicates(lay), JPredicates(JLayout(jc))):
        with pytest.raises(KeyError) as e:
            preds.action_fn("NoSuchAction")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_mask_gathers_only_the_fields_it_reads():
    """The mask's parent rows are gathered field by field on first
    read: on the transitions out of the pinned micro's states to depth
    2, the action constraint reads ``ctr`` alone, so no other parent
    field is gathered, and its answer equals that on every field
    gathered."""
    from raft_tla_tpu_torch.convert import rows_to_torch
    from raft_tla_tpu_torch.engine.bfs import _ParentRows
    from raft_tla_tpu_torch.models.explore import explore
    from raft_tla_tpu_torch.models.raft import successors
    from raft_tla_tpu_torch.ops.codec import encode
    from raft_tla_tpu_torch.ops.layout import Layout
    from raft_tla_tpu_torch.ops.vpredicates import Predicates
    tc = cfgs()[1]
    lay = Layout(tc)
    res = explore(tc, max_depth=2, keep_states=True)
    states = list(res.states.values())
    pairs = [(i, encode(lay, s2, h2))
             for i, (s, h) in enumerate(states)
             for _lbl, s2, h2 in successors(s, h, tc)
             if all(len(lg) <= lay.Lcap for lg in s2.log)]

    def rows(enc):
        return rows_to_torch({k: np.stack([e[k] for e in enc])
                              for k in enc[0]})
    sv = rows([encode(lay, s, h) for s, h in states])
    cand = rows([p[1] for p in pairs])
    prow = torch.tensor([p[0] for p in pairs])
    fn = Predicates(lay).action_fn(ACT)
    par = _ParentRows(sv, prow)
    got = fn(par, cand)
    assert set(par._rows) == {"ctr"}
    want = fn({k: v.index_select(-1, prow) for k, v in sv.items()}, cand)
    assert 0 < int(want.sum()) < want.numel()
    assert torch.equal(got, want)
