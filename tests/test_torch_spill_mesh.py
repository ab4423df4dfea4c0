"""The port's spill-composed mesh (``raft_tla_tpu_torch/parallel/
spill_mesh.py``) on ``[cpu] * 2`` against the reference's
``SpilledShardedEngine`` on 2 of the 8 virtual CPU devices, at zero
tolerance, on the reference's MICRO (``tests/test_spill_mesh.py``) with
FirstBecomeLeader added, so that violations and their ids are held too.
The shard capacities are squeezed (chunk 16, lcap 1024, scap 128: 256
usable level rows a shard) so that levels 12-14 spill mid-level: the
counts, level sizes, violations (invariant, global id, state), the
mid-level spills and trips, the archives (parents, lanes, state rows),
witness traces, and the observability spans and ledger rows.

The reference runs its dedup kernel in interpret mode
(``dedup_kernel="on"``) and the per-level driver (its burst takes a
minute to compile on the CPU; the slow test holds the burst against
it).  The
port's burst, its disk archive and its per-level driver are held
against the same answer.
"""

import json

import jax
import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC
from raft_tla_tpu.config import NEXT_ASYNC as JNA
from raft_tla_tpu.parallel.spill_mesh import \
    SpilledShardedEngine as JSpilledShardedEngine

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.parallel.spill_mesh import SpilledShardedEngine

torch.set_num_threads(1)

VIEW_CONSTRAINTS = ("BoundedInFlightMessages", "BoundedRequestVote",
                    "BoundedLogSize", "BoundedTerms")
KW = dict(n_servers=2, init_servers=(0, 1), values=(1,),
          max_inflight_override=2, symmetry=False,
          constraints=VIEW_CONSTRAINTS,
          invariants=("ElectionSafety", "LogMatching", "FirstBecomeLeader"))
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
ENGINE = dict(chunk=16, lcap=1024, scap=128, vcap=1 << 15,
              store_states=True)
D, DEPTH = 2, 14
SPANS = ("level_dispatch", "burst_dispatch", "harvest", "archive_io")


def cfgs():
    jc = JC(next_family=JNA, bounds=JB.make(**BOUNDS), **KW)
    tc = ModelConfig(next_family=NEXT_ASYNC, bounds=Bounds.make(**BOUNDS),
                     **KW)
    assert repr(jc) == repr(tc)
    return jc, tc


def count_trips(eng):
    """Count the engine's trip handler calls (the reference keeps no
    counter)."""
    box = [0]
    orig = eng._handle_mesh_trip

    def counted(*a, **kw):
        box[0] += 1
        return orig(*a, **kw)
    eng._handle_mesh_trip = counted
    return box


def answer(eng, res, trips):
    gids = [v.state_id for v in res.violations[:1]] + \
        [res.distinct_states - 1]
    return dict(
        counts=(res.distinct_states, res.generated_states, res.depth,
                list(res.level_sizes), res.overflow_faults,
                res.violations_global),
        burst=(res.levels_fused, res.burst_dispatches, res.burst_bailouts),
        spills=(getattr(eng, "mid_level_spills", 0), trips),
        violations=[(v.invariant, v.state_id) for v in res.violations],
        states=[v.state for v in res.violations],
        parents=np.concatenate(eng._parents).tolist(),
        lanes=np.concatenate(eng._lanes).tolist(),
        rows={k: np.concatenate([s[k] for s in eng._states]).tolist()
              for k in eng._states[0]},
        traces=[eng.trace(g) for g in gids])


def run_with_obs(pkg, eng, tmp, name, **check_kw):
    """``eng.check`` to DEPTH with a ledger and a span recorder:
    (result, dispatch rows, span counts)."""
    led = str(tmp / f"{name}.jsonl")
    spans = pkg.SpanRecorder()
    obs = pkg.Obs(ledger=pkg.RunLedger(led), spans=spans).start()
    res = eng.check(max_depth=DEPTH, obs=obs, **check_kw)
    obs.finish(depth=int(res.depth), states=int(res.distinct_states))
    rows = [json.loads(x) for x in open(led)]
    rows = [(r["kind"], r["depth"], r["frontier"]) for r in rows
            if r["kind"] in ("level", "burst")]
    return res, rows, {k: v["count"] for k, v in spans.totals().items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's run (once per module), with its obs bundle."""
    import raft_tla_tpu.obs as ref_obs
    je = JSpilledShardedEngine(cfgs()[0], devices=jax.devices()[:D],
                               dedup_kernel="on", burst=False, **ENGINE)
    trips = count_trips(je)
    res, rows, spans = run_with_obs(ref_obs, je,
                                    tmp_path_factory.mktemp("jsm"), "ref")
    return dict(want=answer(je, res, trips[0]), rows=rows, spans=spans)


def port(tmp_path, **kw):
    import raft_tla_tpu_torch.obs as port_obs
    eng = SpilledShardedEngine(cfgs()[1], devices=["cpu"] * D,
                               **dict(ENGINE, **kw))
    trips = count_trips(eng)
    res, rows, spans = run_with_obs(port_obs, eng, tmp_path, "port")
    assert trips[0] == eng.trips
    return eng, res, answer(eng, res, trips[0]), rows, spans


@pytest.fixture(scope="module")
def per_level(tmp_path_factory):
    """The port's per-level run (once per module)."""
    return port(tmp_path_factory.mktemp("tsm"), burst=False)


def test_spill_mesh_equals_the_reference(ref, per_level):
    eng, res, got, _rows, _spans = per_level
    assert got == ref["want"]
    # levels 12-14 did not fit the shards: several mid-level spills,
    # and violations in every one of them
    assert eng.mid_level_spills >= 3 and res.violations
    assert max(len(p) for p in eng._parents) > D * (eng.LB - D * eng.SC)
    # one flag read a lock-step step; one dedup launch a shard a step
    assert eng.lockstep_steps > 0 and eng.flag_reads == eng.lockstep_steps
    assert eng.bytes_down > 0 and eng.bytes_up > 0


def test_obs_spans_and_ledger_rows_equal_the_reference(ref, per_level):
    _eng, _res, _got, rows, spans = per_level
    assert rows == ref["rows"]
    assert {k: spans.get(k, 0) for k in SPANS} == \
        {k: ref["spans"].get(k, 0) for k in SPANS}
    # nothing is captured on the CPU
    assert "compile" not in spans


def test_burst_equals_the_per_level_driver(ref, tmp_path):
    """The compacting mesh burst (the default) fuses the narrow levels;
    everything but the burst counters equals the reference's per-level
    answer."""
    eng, res, got, _rows, spans = port(tmp_path)
    want = ref["want"]
    assert res.levels_fused > 0 and spans.get("burst_dispatch", 0) > 0
    assert got["burst"] != want["burst"]
    assert {k: v for k, v in got.items() if k != "burst"} == \
        {k: v for k, v in want.items() if k != "burst"}


def test_disk_archive_equals_the_in_ram_archive(ref, tmp_path):
    """``archive_dir``: the spilled blocks stream into per-level memmaps
    in global-id order; the rows and the traces walked from them equal
    the reference's in-RAM archive."""
    eng = SpilledShardedEngine(cfgs()[1], devices=["cpu"] * D,
                               archive_dir=str(tmp_path / "arch"),
                               **ENGINE)
    res = eng.check(max_depth=DEPTH)
    want = ref["want"]
    assert eng._arch is not None and not eng._parents
    arch = eng._arch
    par = np.concatenate([arch.parents(i) for i in range(arch.n_levels)])
    assert par.tolist() == want["parents"]
    assert arch.total_rows == res.distinct_states
    gids = [res.violations[0].state_id, res.distinct_states - 1]
    assert [eng.trace(g) for g in gids] == want["traces"]
    assert eng.mid_level_spills == want["spills"][0]


@pytest.mark.slow
def test_burst_equals_the_reference_burst(tmp_path):
    """The reference's burst against the port's, burst counters too."""
    je = JSpilledShardedEngine(cfgs()[0], devices=jax.devices()[:D],
                               dedup_kernel="on", **ENGINE)
    jt = count_trips(je)
    jr = je.check(max_depth=DEPTH)
    eng, res, got, _rows, _spans = port(tmp_path)
    assert got == answer(je, jr, jt[0])
