"""The port's random-walk engine (``raft_tla_tpu_torch/sim``) against
the JAX package's ``SimEngine`` on the CPU, bit for bit: the final carry
(states, depths, keys, trajectories, progress bases, hit flags, the
Bloom and the stats) under both restart policies and every expansion
setting, on a fleet of 8 walkers (below the guard product's 32-row
padding); walker streams that depend on the global walker id only
(width and ``wid_base``); a JAX carry continued by the port
(``convert.sim_carry_from_jax``); a root violation at depth 0; the
engine's device rule.  The membership hunt and the step's gating are in
``test_torch_sim_hunt.py``.  One JAX compile per policy.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import (Bounds as JB, ModelConfig as JC,
                                 NEXT_DYNAMIC as J_DYN)

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_DYNAMIC
from raft_tla_tpu_torch.convert import sim_carry_from_jax
from raft_tla_tpu_torch.sim import SimEngine
from raft_tla_tpu_torch.sim.walker import ST_ITERS

torch.set_num_threads(1)

# tests/test_sim.py's configs: MICRO's hit-free form and MEMBER
_FREE = dict(n_servers=2, init_servers=(0, 1), values=(1,),
             max_inflight_override=4, symmetry=False, invariants=())
_FREE_B = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
_MEMBER = dict(n_servers=3, init_servers=(0, 1), values=(1,),
               max_inflight_override=6, symmetry=False,
               invariants=("MembershipChange",))
_MEMBER_B = dict(max_log_length=2, max_timeouts=1, max_client_requests=1,
                 max_membership_changes=1)
FREE_KW = dict(walkers=8, max_depth=12, seed=7, bloom_bits=12)
MEMBER_KW = dict(walkers=16, max_depth=30, seed=1, bloom_bits=14)
STEPS = 15


def _cfgs(which):
    c, b = (_FREE, _FREE_B) if which == "free" else (_MEMBER, _MEMBER_B)
    extra = {} if which == "free" else dict(next_family=NEXT_DYNAMIC)
    jextra = {} if which == "free" else dict(next_family=J_DYN)
    jc = JC(bounds=JB.make(**b), **jextra, **c)
    tc = ModelConfig(bounds=Bounds.make(**b), **extra, **c)
    assert repr(jc) == repr(tc)
    return jc, tc


def _np(tree):
    """A JAX carry as numpy copies (the dispatch donates its buffers)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def _leaves(st, port):
    """Carry -> {name: numpy} in the JAX layout: the port's spare traj
    row and Bloom entry dropped, u32 words as uint32."""
    out = {}
    for k, v in st.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [("", v)]):
            a = vv.numpy().copy() if port else np.asarray(vv)
            if port and k == "traj":
                a = a[:-1]
            if port and k == "bloom":
                a = a[:-1]
            if a.dtype == np.int32 and (kk == "bag" or k == "key"):
                a = a.view(np.uint32)
            out[f"{k}.{kk}" if kk else k] = a
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_free():
    """The JAX engine on the hit-free micro config, per policy: its
    carries after STEPS and 2 * STEPS steps."""
    from raft_tla_tpu.sim import SimEngine as JSim
    jc, _tc = _cfgs("free")
    out = {}
    for policy in ("punctuated", "tlc"):
        eng = JSim(jc, policy=policy, **FREE_KW)
        st = eng._dispatch(eng.fresh_carry(), STEPS)
        one = _np(st)
        two = _np(eng._dispatch(st, STEPS))
        out[policy] = (one, two)
    return out


@pytest.mark.parametrize("policy,guard,delta", [
    ("punctuated", True, True), ("punctuated", False, True),
    ("punctuated", True, False), ("punctuated", False, False),
    ("tlc", True, True)])
def test_carry_matches_jax(jax_free, policy, guard, delta):
    _jc, tc = _cfgs("free")
    eng = SimEngine(tc, policy=policy, guard_matmul=guard,
                    delta_matmul=delta, device="cpu", **FREE_KW)
    st = eng._dispatch(eng.fresh_carry(), STEPS)
    _assert_same(_leaves(st, True), _leaves(jax_free[policy][0], False))
    eng._dispatch(st, STEPS)
    got, want = _leaves(st, True), _leaves(jax_free[policy][1], False)
    _assert_same(got, want)
    assert want["stats"][ST_ITERS] == 2 * STEPS
    assert want["bloom"].sum() > 20 and want["stats"][1] > 0  # restarts


def test_streams_depend_on_the_global_walker_id(jax_free):
    """A 16-walker fleet's first 8 walkers are the JAX 8-walker fleet's,
    and its last 8 are an 8-walker fleet's at wid_base 8."""
    _jc, tc = _cfgs("free")
    wide = SimEngine(tc, device="cpu", **dict(FREE_KW, walkers=16))
    half = SimEngine(tc, device="cpu", wid_base=8, **FREE_KW)
    a = wide._dispatch(wide.fresh_carry(), STEPS)
    b = half._dispatch(half.fresh_carry(), STEPS)
    want = _leaves(jax_free["punctuated"][0], False)
    for k, v in _leaves(a, True).items():
        if k in ("bloom", "stats"):
            continue
        lo = v[:8] if k == "key" else v[..., :8]
        hi = v[8:] if k == "key" else v[..., 8:]
        np.testing.assert_array_equal(lo, want[k], err_msg=k)
        np.testing.assert_array_equal(hi, _leaves(b, True)[k], err_msg=k)


def test_a_jax_carry_continues_in_the_port(jax_free):
    _jc, tc = _cfgs("free")
    eng = SimEngine(tc, device="cpu", **FREE_KW)
    st = sim_carry_from_jax(jax_free["punctuated"][0], "cpu")
    assert st["traj"].shape[0] == eng.R + 1
    assert st["bloom"].shape[0] == (1 << FREE_KW["bloom_bits"]) + 1
    eng._dispatch(st, STEPS)
    _assert_same(_leaves(st, True), _leaves(jax_free["punctuated"][1],
                                            False))


def test_root_violation_reported_at_depth_zero():
    _jc, tc = _cfgs("free")
    cfg = tc.with_(invariants=("BoundedTrace",),
                   bounds=Bounds.make(**dict(_FREE_B, max_trace=-1)))
    eng = SimEngine(cfg, walkers=4, max_depth=8, seed=0, bloom_bits=10,
                    device="cpu")
    r = eng.run(steps=50)
    assert r.hits and r.hits[0].depth == 0 and r.steps_dispatched == 0
    assert r.hits[0].invariant == "BoundedTrace" and r.hits[0].lanes == []
    h = eng.decode_hit(r.hits[0])
    assert [lbl for lbl, _sv in h.trace] == ["Init"]


def test_dispatch_counters_match_jax():
    from raft_tla_tpu.sim.walker import dispatch_counters as jdc
    from raft_tla_tpu_torch.sim.walker import ST_LEN, dispatch_counters
    stats = np.random.RandomState(2).randint(0, 1000, size=(3, ST_LEN)) \
        .astype(np.int32)
    assert dispatch_counters(stats, 96) == jdc(stats, 96)


def test_engine_defaults_to_the_card():
    _jc, tc = _cfgs("free")
    if torch.cuda.is_available():
        assert SimEngine(tc, **FREE_KW).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SimEngine(tc, **FREE_KW)
    with pytest.raises(ValueError, match="restart policy"):
        SimEngine(tc, policy="bfs", device="cpu", **FREE_KW)
