"""The walker fleet (``raft_tla_tpu_torch/parallel/sim_mesh.py``) on
``[cpu] * D`` against the reference's ``ShardedSimEngine`` (pmapped over
D of the 8 virtual CPU devices) and against one port ``SimEngine`` of
the same width and seed, at zero tolerance: the cohorts' trajectories
(tests/test_sim.py's sharding test), a whole hunt (stats, hits, decoded
witness), and ``simulate --mesh`` against the reference CLI's (the
reference's 8-cohort fleet) on a hunt with no witness.
"""

import json

import jax
import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC
from raft_tla_tpu.config import NEXT_DYNAMIC as JND
from raft_tla_tpu.parallel.sim_mesh import ShardedSimEngine as JFleet

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_DYNAMIC
from raft_tla_tpu_torch.parallel.sim_mesh import ShardedSimEngine
from raft_tla_tpu_torch.sim import SimEngine
from test_torch_cli import FLAGS, _run, cfgs  # noqa: F401

torch.set_num_threads(1)

MICRO = dict(n_servers=2, init_servers=(0, 1), values=(1,),
             max_inflight_override=4, symmetry=False)
MICRO_B = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
# tests/test_sim.py's MEMBER hunt
MEMBER = dict(n_servers=3, init_servers=(0, 1), values=(1,),
              max_inflight_override=6, symmetry=False,
              invariants=("MembershipChange",))
MEMBER_B = dict(max_log_length=2, max_timeouts=1, max_client_requests=1,
                max_membership_changes=1)


def free():
    """tests/test_sim.py's FREE (no target: no hit ends a walk)."""
    jc = JC(bounds=JB.make(**MICRO_B), invariants=(), **MICRO)
    tc = ModelConfig(bounds=Bounds.make(**MICRO_B), invariants=(), **MICRO)
    assert repr(jc) == repr(tc)
    return jc, tc


def member():
    jc = JC(next_family=JND, bounds=JB.make(**MEMBER_B), **MEMBER)
    tc = ModelConfig(next_family=NEXT_DYNAMIC,
                     bounds=Bounds.make(**MEMBER_B), **MEMBER)
    assert repr(jc) == repr(tc)
    return jc, tc


KW = dict(max_depth=12, seed=5, bloom_bits=12)


def test_cohorts_walk_the_reference_fleet_and_one_engine():
    """Two cohorts after 25 steps: each cohort's trajectories, depths,
    hit flags and stats == the reference fleet's device rows, and side
    by side == one SimEngine of the whole width."""
    jc, tc = free()
    jf = JFleet(jc, walkers=16, devices=jax.devices()[:2], **KW)
    want = jf._pdisp(jf.fresh_carry(), 25, True)
    fleet = ShardedSimEngine(tc, walkers=16, devices=["cpu"] * 2, **KW)
    sts = fleet.fresh_carry()
    for c, st in zip(fleet.cohorts, sts):
        c._dispatch(st, 25, True)
    R = fleet.sim.R
    for d, st in enumerate(sts):
        assert np.array_equal(st["traj"][:R].numpy(),
                              np.asarray(want["traj"])[d])
        for k in ("depth", "hit", "stats"):
            assert np.array_equal(st[k].numpy(), np.asarray(want[k])[d]), k
    solo = SimEngine(tc, walkers=16, device="cpu", **KW)
    st1 = solo._dispatch(solo.fresh_carry(), 25, True)
    assert np.array_equal(
        torch.cat([st["traj"][:R] for st in sts], 1).numpy(),
        st1["traj"][:R].numpy())
    assert np.array_equal(
        torch.cat([st["bloom"] for st in sts]).view(2, -1).any(0).numpy(),
        st1["bloom"].numpy())


def _result(r, eng):
    hits = [eng.decode_hit(h) for h in r.hits]
    return dict(
        stats=(r.walkers, r.steps_dispatched, r.walker_steps,
               r.sampled_steps, r.restarts, r.deadlocks, r.promotions,
               r.bloom_bits_set, r.est_distinct_states),
        hits=[(h.invariant, h.walker, h.depth, list(h.lanes),
               [lbl for lbl, _ in h.trace]) for h in hits])


def test_hunt_equals_the_reference_fleet_and_one_engine():
    """tests/test_sim.py's MEMBER hunt on a two-cohort fleet: the run's
    stats, hits and decoded witnesses == the reference fleet's.  One
    SimEngine of the same width stops every walker at its first hit,
    while a cohort without that hit finishes its dispatch (as the
    reference's pmapped fleet does): its hits are among the fleet's,
    each with the same walker, depth, lanes and decoded witness."""
    jc, tc = member()
    kw = dict(max_depth=30, seed=1, bloom_bits=14)
    jf = JFleet(jc, walkers=16, devices=jax.devices()[:2], **kw)
    want = _result(jf.run(steps=4000), jf)
    fleet = ShardedSimEngine(tc, walkers=16, devices=["cpu"] * 2, **kw)
    got = _result(fleet.run(steps=4000), fleet)
    assert got == want and got["hits"]
    solo = SimEngine(tc, walkers=16, device="cpu", **kw)
    one = _result(solo.run(steps=4000), solo)
    assert one["hits"] and all(h in got["hits"] for h in one["hits"])
    assert one["stats"][1] <= got["stats"][1]


def test_fleet_refuses_an_uneven_split_and_needs_a_device_list():
    _jc, tc = free()
    with pytest.raises(ValueError, match="must divide across 3 devices"):
        ShardedSimEngine(tc, walkers=16, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardedSimEngine(tc, walkers=16)


def test_simulate_mesh_prints_the_reference_cli_stats(cfgs, capsys):
    """``simulate --mesh`` with no witness within its steps: the port
    (one engine here, no second card) prints the reference's 8-cohort
    fleet's stats line and its message, exit 1."""
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    argv = ["simulate", cfgs[0], "--target", "FirstCommit", "--steps",
            "6", "--walkers", "16", "--max-depth", "16", "--seed", "3",
            "--bloom-bits", "12", "--steps-per-dispatch", "4",
            "--mesh"] + FLAGS
    got = _run(tmain, argv + ["--device", "cpu"], capsys)
    want = _run(jmain, argv, capsys)
    assert got[0] == want[0] == 1
    assert got[2] == want[2]
    gs, ws = (json.loads(x[1].partition("\n")[0]) for x in (got, want))
    timing = ("seconds", "walker_steps_per_sec", "platform")
    assert list(gs) == list(ws)
    assert {k: v for k, v in gs.items() if k not in timing} == \
        {k: v for k, v in ws.items() if k not in timing}
    assert gs["hits"] == 0 and gs["walker_steps"] > 0
