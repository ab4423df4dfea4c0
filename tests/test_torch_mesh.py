"""The port's sharded engine (``raft_tla_tpu_torch/parallel/mesh.py``) on
``[cpu] * D`` against the reference's ``ShardedEngine`` on D of the 8
virtual CPU devices, at zero tolerance: distinct and generated states,
depth, level sizes, the burst counters, violations (invariant and
device-major global id), the per-level archives (parents, lanes, state
rows), witness traces and, through a checkpoint at the last level, the
table shards bit for bit and every carry leaf a resume reads.  The
reference runs its dedup kernel in interpret mode (``dedup_kernel="on"``:
the lax claim walk may place contended keys in other slots).

Also: the burst off, the plain expansion and a growth replay against
the same reference answer; the trace identical across mesh sizes;
paxos against its oracle (and, slow, against the reference's mesh); and
config #1, where the reference's ShardedEngine equals its Engine
(which decides what the card's phase 21a asserts).
"""

import json

import jax
import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC
from raft_tla_tpu.config import NEXT_ASYNC as JNA
from raft_tla_tpu.parallel.mesh import ShardedEngine as JShardedEngine

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.parallel.mesh import ShardedEngine

torch.set_num_threads(1)

KW = dict(n_servers=2, init_servers=(0, 1), values=(1,), symmetry=True,
          max_inflight_override=4)
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
INV = ("FirstBecomeLeader",)
DEPTH = 9
CHUNK = 16


def cfgs():
    jc = JC(next_family=JNA, bounds=JB.make(**BOUNDS), invariants=INV, **KW)
    tc = ModelConfig(next_family=NEXT_ASYNC, bounds=Bounds.make(**BOUNDS),
                     invariants=INV, **KW)
    assert repr(jc) == repr(tc)
    return jc, tc


def answer(eng, res):
    gids = [v.state_id for v in res.violations[:1]] + \
        [res.distinct_states - 1]
    return dict(
        counts=(res.distinct_states, res.generated_states, res.depth,
                list(res.level_sizes), res.overflow_faults,
                res.violations_global),
        burst=(res.levels_fused, res.burst_dispatches, res.burst_bailouts),
        violations=[(v.invariant, v.state_id) for v in res.violations],
        states=[v.state for v in res.violations],
        parents=[p.tolist() for p in eng._parents],
        lanes=[p.tolist() for p in eng._lanes],
        rows=[{k: v.tolist() for k, v in s.items()} for s in eng._states],
        traces=[eng.trace(g) for g in gids])


_REF = {}


def reference(D, tmp_path_factory):
    """The reference mesh's run at D (once per module), with a
    checkpoint at its last level."""
    if D not in _REF:
        path = str(tmp_path_factory.mktemp(f"jmesh{D}") / "j.ckpt")
        je = JShardedEngine(cfgs()[0], devices=jax.devices()[:D],
                            chunk=CHUNK, dedup_kernel="on")
        res = je.check(max_depth=DEPTH, checkpoint_path=path,
                       checkpoint_every=DEPTH)
        _REF[D] = dict(want=answer(je, res), ckpt=path)
    return _REF[D]


def leaves(path):
    z = np.load(path, allow_pickle=False)
    return {k: z[k] for k in z.files if k.startswith("carry|")}, \
        json.loads(str(z["meta"]))


def same_carry(a_path, b_path):
    """Every leaf of two sharded checkpoints at a level boundary: the
    same names, dtypes and shapes; the table shards, counters, flags
    and the frontier's rows, mask and gids bit for bit (the level
    buffers past the committed rows hold what either engine last wrote
    there, which no resume reads)."""
    (a, ma), (b, mb) = leaves(a_path), leaves(b_path)
    assert sorted(a) == sorted(b)
    nf = a["carry|n_front"]
    stale = ("carry|lvl|", "carry|lpar", "carry|llane", "carry|lpfp",
             "carry|linv", "carry|lcon", "carry|jslot")
    for k in a:
        assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
        if k.startswith(stale):
            continue
        if k.startswith("carry|front|") or k in ("carry|fmask",
                                                 "carry|gids"):
            for d in range(len(nf)):
                assert np.array_equal(a[k][d, :nf[d]], b[k][d, :nf[d]]), k
        else:
            assert np.array_equal(a[k], b[k]), k
    drop = ("HCAP",)
    assert {k: v for k, v in ma.items() if k not in drop} == \
        {k: v for k, v in mb.items() if k not in drop}


@pytest.mark.parametrize("D", [1, 2, 4])
def test_mesh_equals_the_reference(D, tmp_path, tmp_path_factory):
    ref = reference(D, tmp_path_factory)
    eng = ShardedEngine(cfgs()[1], devices=["cpu"] * D, chunk=CHUNK)
    path = str(tmp_path / "p.ckpt")
    res = eng.check(max_depth=DEPTH, checkpoint_path=path,
                    checkpoint_every=DEPTH)
    got = answer(eng, res)
    assert got == ref["want"]
    assert res.violations and res.levels_fused > 0
    same_carry(path, ref["ckpt"])
    # the dedup kernel's twin ran once per shard per lock-step step
    assert eng.lockstep_steps > 0 and eng.flag_reads == eng.lockstep_steps


def test_burst_off_and_plain_expansion_equal_the_reference(
        tmp_path_factory):
    """The per-level driver, and the expansion without the guard
    product and the delta group: the reference's answer, but the burst
    counters (no level fused)."""
    ref = reference(2, tmp_path_factory)["want"]
    for kw in (dict(burst=False),
               dict(guard_matmul=False, delta_matmul=False)):
        eng = ShardedEngine(cfgs()[1], devices=["cpu"] * 2, chunk=CHUNK,
                            **kw)
        got = answer(eng, eng.check(max_depth=DEPTH))
        if kw.get("burst") is False:
            assert got.pop("burst") == (0, 0, 0)
            want = {k: v for k, v in ref.items() if k != "burst"}
        else:
            assert not eng.expander.delta_active and not eng.guard_matmul
            want = ref
        assert got == want, kw


def test_growth_replays_keep_the_reference_answer(tmp_path_factory):
    """Undersized send windows (scap 2) trip sovf, and the level buffer
    grown with them; the levels replay with the grown capacities and the
    answer stays the reference's."""
    ref = reference(2, tmp_path_factory)["want"]
    eng = ShardedEngine(cfgs()[1], devices=["cpu"] * 2, chunk=CHUNK,
                        lcap=64, scap=2, burst=False)
    lb0, sc0 = eng.LB, eng.SC
    got = answer(eng, eng.check(max_depth=DEPTH))
    got.pop("burst")
    assert got == {k: v for k, v in ref.items() if k != "burst"}
    assert eng.SC > sc0 and eng.LB > lb0


def test_witness_trace_is_the_same_for_every_mesh_size():
    """The content-canonical survivor's provenance is mesh-invariant:
    the first violation's trace at D = 2 and D = 4 is identical action
    by action and state by state (its global id differs)."""
    tc = cfgs()[1]
    out = {}
    for D in (2, 4):
        eng = ShardedEngine(tc, devices=["cpu"] * D, chunk=8 * D)
        res = eng.check(stop_on_violation=True)
        out[D] = eng.trace(res.violations[0].state_id)
    assert [(l, s) for l, s in out[2]] == [(l, s) for l, s in out[4]]
    assert len(out[2]) > 3


def test_paxos_on_the_mesh_equals_its_oracle():
    from raft_tla_tpu_torch.spec import get_spec
    from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig
    cfg = PaxosConfig()
    o = get_spec("paxos").oracle_explore(cfg)
    r = ShardedEngine(cfg, devices=["cpu"] * 2, chunk=64,
                      store_states=False).check()
    assert (r.distinct_states, r.generated_states, r.depth,
            r.level_sizes) == (o.distinct_states, o.generated_states,
                               o.depth, o.level_sizes) == \
        (857, o.generated_states, o.depth, o.level_sizes)


@pytest.mark.slow
def test_paxos_on_the_mesh_equals_the_reference_mesh():
    from raft_tla_tpu.spec.paxos.config import PaxosConfig as JPaxos
    from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig
    je = JShardedEngine(JPaxos(invariants=("ValueChosen",)),
                        devices=jax.devices()[:2], chunk=64,
                        dedup_kernel="on")
    want = answer(je, je.check())
    eng = ShardedEngine(PaxosConfig(invariants=("ValueChosen",)),
                        devices=["cpu"] * 2, chunk=64)
    assert answer(eng, eng.check()) == want


def _config1(pkg):
    if pkg == "jax":
        from raft_tla_tpu.cfg.parser import load_model
        from raft_tla_tpu.config import Bounds as B
    else:
        from raft_tla_tpu_torch.cfg.parser import load_model
        B = Bounds
    return load_model("configs/tlc_membership/raft.cfg",
                      bounds=B.make(max_log_length=2, max_timeouts=1,
                                    max_client_requests=3))


def _counts(r):
    return (r.distinct_states, r.generated_states, r.depth,
            list(r.level_sizes))


@pytest.mark.parametrize("depth", [
    12, pytest.param(16, marks=pytest.mark.slow)])
def test_config1_reference_mesh_equals_reference_engine(depth):
    """BASELINE config #1 (raft.cfg's counter-dependent constraints):
    the reference's content-canonical ShardedEngine equals its
    first-seen Engine to this depth (to 16: 105,915 distinct, 242,661
    generated), and the port's mesh equals both at 12."""
    from raft_tla_tpu.engine.bfs import Engine as JEngine
    jc = _config1("jax")
    kw = dict(store_states=False, lcap=1 << 16, vcap=1 << 18)
    jm = JShardedEngine(jc, devices=jax.devices()[:2], chunk=512,
                        **kw).check(max_depth=depth)
    je = JEngine(jc, chunk=512, **kw).check(max_depth=depth)
    assert _counts(jm) == _counts(je)
    if depth == 16:
        assert _counts(jm)[:2] == (105_915, 242_661)
    else:
        pm = ShardedEngine(_config1("port"), devices=["cpu"] * 2,
                           chunk=512, **kw).check(max_depth=depth)
        assert _counts(pm) == _counts(jm)


def test_sort_mode_equals_the_reference():
    """The orbit-sort canonicalizer on the mesh (``sym_canon="sort"``,
    the per-level driver): the reference's mesh hashes every hard lane,
    the port's step holds the fallback to ``HCAP`` hard lanes (here 1,
    the smallest buffer) and would replay a level past it; the answer,
    archives and table shards are the reference's."""
    import tempfile
    jc, tc = cfgs()
    with tempfile.TemporaryDirectory() as td:
        je = JShardedEngine(jc, devices=jax.devices()[:2], chunk=CHUNK,
                            dedup_kernel="on", sym_canon="sort",
                            burst=False)
        want = answer(je, je.check(max_depth=DEPTH,
                                   checkpoint_path=td + "/j.ckpt",
                                   checkpoint_every=DEPTH))
        eng = ShardedEngine(tc, devices=["cpu"] * 2, chunk=CHUNK,
                            sym_canon="sort", burst=False)
        eng.HCAP = 1
        got = answer(eng, eng.check(max_depth=DEPTH,
                                    checkpoint_path=td + "/p.ckpt",
                                    checkpoint_every=DEPTH))
        assert eng.fpr.sym_canon == "sort"
        assert got == want
        same_carry(td + "/p.ckpt", td + "/j.ckpt")


def test_chunk_rounds_up_to_the_mesh_with_one_warning():
    """tests/test_sym_canon.py's chunk rounding on the engine."""
    from raft_tla_tpu_torch.parallel import mesh
    mesh._warned_uneven_chunk = False
    with pytest.warns(UserWarning, match="rounded up"):
        eng = ShardedEngine(cfgs()[1], devices=["cpu"] * 8, chunk=63)
    assert (eng.chunk, eng.BL, eng.D) == (64, 8, 8)
    mesh._warned_uneven_chunk = False
