"""The port's classic engine with an observability bundle against the
reference's on the CPU (the reference's ``TINY`` config, chunk 64):
the same sequence of dispatch kinds and, row for row, the same depth,
frontier and counters; the final row's burst counters equal to
``check_stats`` and to the checkpoint's meta; the heartbeat's depth
and states equal to the run's; the spans at the reference's sites with
no ``compile`` span on the CPU (there is nothing to capture); and a
chaos dispatch fault under ``supervised_check`` writing a
``kind="retry"`` row and a ``backoff`` heartbeat before ``finished``.
"""

import json

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.bfs import Engine
from raft_tla_tpu_torch.obs import (BURST_COUNTER_KEYS, CHECK_COUNTER_KEYS,
                                    Heartbeat, Obs, RunLedger, SpanRecorder,
                                    check_stats)
from raft_tla_tpu_torch.obs.heartbeat import read_heartbeat
from raft_tla_tpu_torch.resil import chaos
from raft_tla_tpu_torch.resil.supervisor import supervised_check

torch.set_num_threads(1)

# the reference's TINY (tests/test_obs.py), as the port's config
TINY = ModelConfig(
    n_servers=2, init_servers=(0, 1), values=(1,),
    max_inflight_override=2, next_family=NEXT_ASYNC, symmetry=False,
    constraints=("BoundedInFlightMessages", "BoundedRequestVote",
                 "BoundedLogSize", "BoundedTerms"),
    invariants=("ElectionSafety", "LogMatching"),
    bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                       max_client_requests=1))
DEPTH = 20          # a burst that bails, then per-level dispatches
# what a run cannot repeat
_TIMES = ("ts", "t_mono", "seq", "seconds", "states_per_sec", "rss_bytes",
          "run_id", "dedup_hit_rate")


def _run(pkg, make_engine, tmp_path, name, spans=False):
    """One ``check(obs=)`` to DEPTH with a checkpoint every level, the
    bundle from ``pkg`` (the port's or the reference's obs package):
    (result, ledger rows, checkpoint meta, heartbeat, bundle)."""
    led = str(tmp_path / f"{name}.jsonl")
    hb = str(tmp_path / f"{name}.hb.json")
    ck = str(tmp_path / f"{name}.ckpt")
    obs = pkg.Obs(ledger=pkg.RunLedger(led), heartbeat=pkg.Heartbeat(hb),
                  spans=pkg.SpanRecorder() if spans else None).start()
    r = make_engine().check(obs=obs, max_depth=DEPTH, checkpoint_path=ck,
                            checkpoint_every=1)
    obs.finish(depth=int(r.depth), states=int(r.distinct_states))
    rows = [json.loads(x) for x in open(led)]
    z = np.load(ck, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    z.close()
    return r, rows, meta, read_heartbeat(hb), obs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_engine")
    import raft_tla_tpu.obs as ref_obs
    import raft_tla_tpu_torch.obs as port_obs
    from raft_tla_tpu.engine.bfs import Engine as RefEngine
    from test_obs import TINY as REF_TINY
    assert repr(REF_TINY) == repr(TINY)
    ref = _run(ref_obs, lambda: RefEngine(REF_TINY, chunk=64,
                                          store_states=False), tmp, "ref")
    port = _run(port_obs, lambda: Engine(TINY, chunk=64, store_states=False,
                                         device="cpu"),
                tmp, "port", spans=True)
    return port, ref


def _dispatch_rows(rows):
    return [r for r in rows if r["kind"] in ("level", "burst")]


def test_dispatch_rows_equal_the_reference_row_for_row(runs):
    (r, rows, _m, _hb, _o), (ref_r, ref_rows, _rm, _rhb, _ro) = runs
    assert (r.distinct_states, r.depth, r.level_sizes) == \
        (ref_r.distinct_states, ref_r.depth, ref_r.level_sizes)
    assert [x["kind"] for x in rows] == [x["kind"] for x in ref_rows]
    got, want = _dispatch_rows(rows), _dispatch_rows(ref_rows)
    kinds = [x["kind"] for x in got]
    # the path the rows record: a burst that bailed, then per-level
    # dispatches
    assert kinds[0] == "burst" and "level" in kinds
    assert r.burst_bailouts >= 1 and r.levels_fused > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert not set(CHECK_COUNTER_KEYS) - set(a)
        assert {k: v for k, v in a.items() if k not in _TIMES} == \
            {k: v for k, v in b.items() if k not in _TIMES}
    assert [x["dispatch"] for x in got] == list(range(1, len(got) + 1))


def test_final_row_stats_and_checkpoint_meta_agree(runs):
    r, rows, meta, _hb, _o = runs[0]
    stats = check_stats(r.metrics.as_dict(), r.seconds, len(r.violations),
                        fp_bits=64)
    last = rows[-1]
    assert last["kind"] in ("level", "burst")
    for k in BURST_COUNTER_KEYS:
        assert last[k] == stats[k] == meta[k], k
    assert meta["distinct"] == stats["distinct_states"] == \
        last["distinct_states"]
    assert tuple(r.metrics.keys()) == CHECK_COUNTER_KEYS
    assert r.phase_seconds["device_levels"] > 0


def test_heartbeat_matches_the_run(runs):
    r, _rows, _m, hb, obs = runs[0]
    assert hb["status"] == "finished"
    assert hb["depth"] == r.depth == DEPTH
    assert hb["states_enqueued"] == r.distinct_states
    assert hb["run_id"] == obs.run_id
    assert hb["beats"] == len(_dispatch_rows(runs[0][1])) + 1


def test_spans_at_the_reference_sites_and_no_compile_on_the_cpu(runs):
    r, rows, _m, _hb, obs = runs[0]
    tot = obs.spans.totals()
    assert "compile" not in tot
    n_burst = sum(x["kind"] == "burst" for x in rows)
    n_level = sum(x["kind"] == "level" for x in rows)
    assert tot["burst_dispatch"]["count"] == r.burst_dispatches
    assert tot["level_dispatch"]["count"] == n_level
    assert tot["harvest"]["count"] == n_burst + n_level
    assert tot["checkpoint"]["count"] >= 1
    # the meta rows' resource sample counts no compile either
    res = [x for x in rows if x["kind"] == "resource"]
    assert res and res[0]["compile_count"] == 0


def test_chaos_retry_writes_a_retry_row_and_a_backoff_heartbeat(tmp_path):
    led, hb = str(tmp_path / "l.jsonl"), str(tmp_path / "hb.json")
    obs = Obs(ledger=RunLedger(led), heartbeat=Heartbeat(hb),
              spans=SpanRecorder(), device="cpu").start()
    seen = []

    def sleep(_s):
        # the supervisor sleeps right after obs.retry: the heartbeat on
        # disk is the backoff beat
        seen.append(read_heartbeat(hb))
    chaos.install("dispatch:at=3")
    try:
        res, _eng, attempts = supervised_check(
            lambda: Engine(TINY, chunk=64, store_states=False,
                           burst_levels=2, device="cpu"),
            retries=2, backoff=0.01, obs=obs, sleep=sleep,
            checkpoint_path=str(tmp_path / "c.ckpt"), checkpoint_every=1,
            max_depth=8)
    finally:
        chaos.uninstall()
    obs.finish(depth=int(res.depth), states=int(res.distinct_states))
    assert attempts == 2
    rows = [json.loads(x) for x in open(led)]
    kinds = [x["kind"] for x in rows]
    assert kinds.count("retry") == 1
    retry = rows[kinds.index("retry")]
    assert (retry["attempt"], retry["max_attempts"]) == (1, 3)
    assert "InjectedFault" in retry["error"] or "chaos" in retry["error"]
    # dispatches before and after the retry
    assert "burst" in kinds[:kinds.index("retry")]
    assert kinds[-1] in ("level", "burst")
    assert len(seen) == 1 and seen[0]["status"] == "backoff"
    assert seen[0]["retry"]["attempt"] == 1
    final = read_heartbeat(hb)
    assert final["status"] == "finished" and final["depth"] == res.depth
    assert final["beats"] > seen[0]["beats"]
    assert res.depth == 8
