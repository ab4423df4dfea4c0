"""The port's engines on the paxos tenant against the JAX package's
``Engine`` and the paxos oracle: the stock model with symmetry (857
states) and without (3,921), distinct and generated states, depth, level
sizes, every global id's parent, lane and row, and traces, in every
expansion form (guard product and delta group on and off) with the burst
on and off; the scenario properties' violations and witnesses; the
multi-instance product law (two one-ballot instances: 73^2 = 5,329
states, level sizes the self-convolution of one instance's); the spill
engine in tiny segments and the host-partitioned table at stock size;
checkpoints written by either package resumed by the other, the port's
file with the JAX file's leaves (``msgs`` as uint32), and a checkpoint
of the other spec refused before its config is compared.  A raft
checkpoint of the port has the same leaves, byte for byte, as before
the u32 repair (pinned).  One JAX engine compile per config."""

import hashlib
import itertools
import json

import numpy as np
import pytest
import torch

from raft_tla_tpu.engine.bfs import Engine as JEngine
from raft_tla_tpu.spec.paxos.config import PaxosConfig as JConfig

from raft_tla_tpu_torch.engine.bfs import CheckpointError, Engine
from raft_tla_tpu_torch.engine.spill import SpillEngine
from raft_tla_tpu_torch.spec import get_spec
from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig

torch.set_num_threads(1)

SCEN = ("Agreement", "ValueChosen", "TwoBallots", "Preempted")
CASES = {"sym": dict(), "nosym": dict(symmetry=False),
         "scenarios": dict(invariants=SCEN)}
AT = 6          # the checkpoints' depth


def answer(eng, res):
    """What a run must reproduce: the counts, the violations, every
    global id's parent, lane and row, and the traces of the first
    violation (if any) and of the last state."""
    gids = [v.state_id for v in res.violations[:1]] + \
        [res.distinct_states - 1]
    return dict(
        counts=(res.distinct_states, res.generated_states, res.depth,
                list(res.level_sizes), res.overflow_faults,
                res.violations_global),
        violations=[(v.invariant, v.state_id) for v in res.violations],
        parents=np.concatenate(eng._parents).tolist(),
        lanes=np.concatenate(eng._lanes).tolist(),
        states={k: np.concatenate([s[k] for s in eng._states]).tolist()
                for k in eng._states[0]},
        traces=[eng.trace(g) for g in gids])


_REF = {}


def reference(name):
    """The JAX engine's run of CASES[name], once per module."""
    if name not in _REF:
        kw = CASES[name]
        je = JEngine(JConfig(**kw), chunk=64)
        res = je.check(stop_on_violation=False)
        _REF[name] = dict(kw=kw, je=je, want=answer(je, res), name=name)
    return _REF[name]


# the expansion forms, the spill engines and the checkpoints are held on
# the symmetric model and on the one with violations
HELD = ["sym", "scenarios"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_equals_the_reference_and_the_oracle(name):
    ref = reference(name)
    cfg = PaxosConfig(**ref["kw"])
    eng = Engine(cfg, chunk=64, device="cpu")
    res = eng.check(stop_on_violation=False)
    assert answer(eng, res) == ref["want"]
    o = get_spec("paxos").oracle_explore(cfg)
    assert (res.distinct_states, res.generated_states, res.depth,
            res.level_sizes) == (o.distinct_states, o.generated_states,
                                 o.depth, o.level_sizes)
    want = {"sym": 857, "nosym": 3921, "scenarios": 857}[ref["name"]]
    assert res.distinct_states == want
    assert bool(res.violations) == (ref["name"] == "scenarios")


@pytest.mark.parametrize("guard,delta,burst",
                         list(itertools.product((True, False), repeat=3)),
                         ids=lambda v: "on" if v else "off")
@pytest.mark.parametrize("name", HELD)
def test_every_expansion_form_and_driver(name, guard, delta, burst):
    ref = reference(name)
    eng = Engine(PaxosConfig(**ref["kw"]), chunk=64, burst=burst,
                 guard_matmul=guard, delta_matmul=delta, device="cpu")
    assert eng.expander.delta_active == delta
    res = eng.check(stop_on_violation=False)
    assert answer(eng, res) == ref["want"]
    assert (res.levels_fused > 0) == burst


def _levels_with_root(res):
    return [1] + res.level_sizes[:-1]


def test_multi_instance_product_law():
    one = Engine(PaxosConfig(n_ballots=1, symmetry=False), chunk=64,
                 device="cpu", store_states=False).check()
    two = Engine(PaxosConfig(n_ballots=1, n_instances=2, symmetry=False),
                 chunk=64, device="cpu", store_states=False).check()
    assert one.distinct_states == 73 and two.distinct_states == 73 ** 2
    conv = np.convolve(_levels_with_root(one),
                       _levels_with_root(one)).tolist()
    assert _levels_with_root(two) == conv and two.level_sizes[-1] == 0
    assert not two.violations


@pytest.mark.parametrize("host_table", [False, True],
                         ids=["spill", "host_table"])
@pytest.mark.parametrize("name", HELD)
def test_spill_and_host_table(name, host_table):
    ref = reference(name)
    eng = SpillEngine(PaxosConfig(**ref["kw"]), chunk=64, seg=1 << 8,
                      vcap=1 << 10, sync_every=2, store_states=True,
                      host_table=host_table, partitions=4, part_cap=64,
                      device="cpu")
    res = eng.check(stop_on_violation=False)
    got = answer(eng, res)
    assert got == ref["want"]
    if host_table:
        assert eng.hpt.n_keys == res.distinct_states


def _ckpt(tmp_path, name):
    return str(tmp_path / f"{name}.ckpt")


@pytest.mark.parametrize("name", HELD)
def test_checkpoints_cross_between_the_packages(name, tmp_path):
    """Either package's checkpoint at depth AT resumes in the other to
    the uninterrupted answer; the port's file has the JAX file's leaves
    (``msgs`` as uint32) and meta."""
    ref = reference(name)
    je, want = ref["je"], ref["want"]
    cfg = PaxosConfig(**ref["kw"])
    je.ckpt_keep = 1
    jpath, tpath = _ckpt(tmp_path, "jax"), _ckpt(tmp_path, "port")
    je.check(max_depth=AT, checkpoint_path=jpath, checkpoint_every=AT,
             stop_on_violation=False)
    eng = Engine(cfg, chunk=64, device="cpu")
    eng.ckpt_keep = 1
    eng.check(max_depth=AT, checkpoint_path=tpath, checkpoint_every=AT,
              stop_on_violation=False)
    eng = Engine(cfg, chunk=64, device="cpu")
    res = eng.check(resume_from=jpath, stop_on_violation=False)
    assert answer(eng, res) == want
    res = je.check(resume_from=tpath, stop_on_violation=False)
    assert answer(je, res) == want
    zj, zp = np.load(jpath), np.load(tpath)
    leaves = {k: (zj[k].shape, zj[k].dtype) for k in zj.files
              if k != "meta"}
    assert {k: (zp[k].shape, zp[k].dtype) for k in zp.files
            if k != "meta"} == leaves
    assert leaves["carry|front|msgs"][1] == np.uint32
    assert leaves["states|0|msgs"][1] == np.uint32
    for k in zj.files:
        if k.split("|")[0] in ("parents", "lanes", "states"):
            np.testing.assert_array_equal(zp[k], zj[k])
    mj, mp = (json.loads(str(z["meta"])) for z in (zj, zp))
    assert mp["spec"] == mj["spec"] == "paxos"
    assert mp["cfg"] == mj["cfg"] == repr(cfg)
    assert {k: mp[k] for k in mj} == mj


def test_checkpoint_of_the_other_spec_is_refused(tmp_path):
    """A paxos checkpoint handed to a raft engine, and a raft one to a
    paxos engine, are refused by spec before the config compare."""
    from raft_tla_tpu_torch.config import Bounds, ModelConfig
    raft = ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                       max_inflight_override=4,
                       bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                                          max_client_requests=1))
    ppath, rpath = _ckpt(tmp_path, "paxos"), _ckpt(tmp_path, "raft")
    for cfg, path in ((PaxosConfig(), ppath), (raft, rpath)):
        e = Engine(cfg, chunk=64, device="cpu")
        e.ckpt_keep = 1
        e.check(max_depth=2, checkpoint_path=path, checkpoint_every=2)
    with pytest.raises(CheckpointError, match="written for spec 'paxos'; "
                       "engine is running spec 'raft'"):
        Engine(raft, chunk=64, device="cpu").check(resume_from=ppath)
    with pytest.raises(CheckpointError, match="written for spec 'raft'; "
                       "engine is running spec 'paxos'"):
        Engine(PaxosConfig(), chunk=64, device="cpu").check(
            resume_from=rpath)


# sha256 over (name, dtype, shape, bytes) of every member of the micro
# raft checkpoint below, as the port wrote it before the u32 repair
# (the parent tree of that change, on the CPU)
RAFT_CKPT_LEAVES_SHA = \
    "73ca3d45aeb1076bb6f42b517e230d0a8ccfcbc90ecadd33bdccc2e296b354ba"


def _leaves_sha(path):
    z = np.load(path)
    h = hashlib.sha256()
    for k in sorted(z.files):
        a = np.ascontiguousarray(z[k])
        h.update(f"{k}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def test_raft_checkpoint_is_unchanged_by_the_u32_repair(tmp_path):
    from raft_tla_tpu_torch.config import Bounds, ModelConfig
    cfg = ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                      max_inflight_override=4, symmetry=True,
                      invariants=("FirstBecomeLeader",),
                      bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                                         max_client_requests=1))
    path = _ckpt(tmp_path, "raft")
    e = Engine(cfg, chunk=64, device="cpu")
    e.ckpt_keep = 1
    e.check(max_depth=AT, checkpoint_path=path, checkpoint_every=AT)
    assert np.load(path)["carry|front|bag"].dtype == np.uint32
    assert _leaves_sha(path) == RAFT_CKPT_LEAVES_SHA
