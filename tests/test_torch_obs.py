"""The port's observability modules (``raft_tla_tpu_torch/obs``) against
the reference's (``raft_tla_tpu/obs``) on the CPU: the five counter-key
tuples, the strict ``MetricsRegistry``, ``CheckResult``'s write-through
views and its repr, ``check_stats``/``sim_stats`` payloads equal to the
reference's, the span recorder (nesting, its streamed file, a killed
run's file, its ``record_function`` ranges in a ``torch.profiler``
trace), the same ``Obs`` calls through both bundles giving ledger rows,
heartbeats and registry records with the same keys and the same
non-time values, and ``device_memory_stats`` giving None on the CPU
without initialising CUDA.
"""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from raft_tla_tpu_torch.obs import (BURST_COUNTER_KEYS, CHECK_COUNTER_KEYS,
                                    MXU_COUNTER_KEYS, SIM_COUNTER_KEYS,
                                    SIM_DISPATCH_KEYS, Heartbeat,
                                    MetricsRegistry, Obs, RunLedger,
                                    RunRegistry, SpanRecorder,
                                    backend_fingerprint, check_stats,
                                    device_memory_stats, sim_stats)
from raft_tla_tpu_torch.obs.heartbeat import read_heartbeat

torch.set_num_threads(1)

# what a run cannot repeat: clocks, rates, memory, ids
_TIMES = {"ts", "t_mono", "seq", "seconds", "states_per_sec", "rss_bytes",
          "rss_peak_bytes", "run_id", "last_dispatch_ts", "started_ts",
          "finished_ts", "compile_seconds"}


def test_counter_key_tuples_equal_the_reference():
    from raft_tla_tpu.obs import metrics as ref
    assert CHECK_COUNTER_KEYS == ref.CHECK_COUNTER_KEYS
    assert MXU_COUNTER_KEYS == ref.MXU_COUNTER_KEYS
    assert BURST_COUNTER_KEYS == ref.BURST_COUNTER_KEYS
    assert SIM_COUNTER_KEYS == ref.SIM_COUNTER_KEYS
    assert SIM_DISPATCH_KEYS == ref.SIM_DISPATCH_KEYS


def test_metrics_registry_is_strict():
    m = MetricsRegistry()
    m.register("a", 1)
    m.inc("a", 2)
    assert m.get("a") == 3 and "a" in m and m.keys() == ("a",)
    with pytest.raises(ValueError):
        m.register("a")            # double registration
    with pytest.raises(KeyError):
        m.set("typo", 1)           # undeclared counter fails loudly
    assert m.as_dict() == {"a": 3}
    assert MetricsRegistry({"x": 1, "y": 2}).as_dict() == {"x": 1, "y": 2}


def test_check_result_counters_are_registry_views():
    from raft_tla_tpu.engine.bfs import CheckResult as RefResult
    from raft_tla_tpu_torch.engine.bfs import CheckResult
    r = CheckResult(distinct_states=7, generated_states=9)
    r.levels_fused += 2
    r.depth = 5
    r.burst_bailouts += True
    # the attribute is the registry entry: one store, no copies
    assert r.metrics.get("levels_fused") == 2
    assert r.metrics.get("depth") == 5
    assert r.metrics.get("burst_bailouts") == 1
    assert tuple(r.metrics.keys()) == CHECK_COUNTER_KEYS
    # the port's hard-lane counters stay outside the registry
    r.hard_lanes, r.hard_chunks, r.hard_chunk_max = 3, 2, 1
    assert "hard_lanes" not in r.metrics
    with pytest.raises(KeyError):
        r.metrics.set("hard_lanes", 1)
    assert r.phase_seconds == {} and r.level_sizes == [] and \
        r.violations == []
    # the reference's repr, the reference's derived rates
    ref = RefResult(distinct_states=7, generated_states=9, depth=5,
                    levels_fused=2, burst_bailouts=1, seconds=0.5)
    r.seconds = 0.5
    assert repr(r) == repr(ref)
    assert r.states_per_sec == ref.states_per_sec
    assert r.dedup_hit_rate == ref.dedup_hit_rate


@pytest.mark.parametrize("fp_bits, pins, spec", [
    (None, 0, None), (64, 0, None), (64, 4, "raft"), (128, 0, "paxos"),
    (None, 3, "raft")])
def test_check_stats_equal_the_reference(fp_bits, pins, spec):
    from raft_tla_tpu.engine.bfs import CheckResult as RefResult
    from raft_tla_tpu.obs import check_stats as ref_stats
    from raft_tla_tpu_torch.engine.bfs import CheckResult
    kw = dict(distinct_states=10, generated_states=20, depth=3,
              pin_interior_states=pins, levels_fused=2,
              burst_dispatches=3, burst_bailouts=1, guard_matmul=1,
              dedup_kernel=1, delta_matmul=0, sym_canon=1)
    ir_fp = "d6d7a456cec9" if spec else None
    got = check_stats(CheckResult(**kw).metrics.as_dict(), 1.5, 2,
                      fp_bits=fp_bits, spec=spec, ir_fp=ir_fp)
    want = ref_stats(RefResult(**kw).metrics.as_dict(), 1.5, 2,
                     fp_bits=fp_bits, spec=spec, ir_fp=ir_fp)
    assert json.dumps(got) == json.dumps(want)


def test_sim_stats_equal_the_reference():
    from raft_tla_tpu.obs import sim_stats as ref_sim_stats
    res = SimpleNamespace(
        walkers=8, steps_dispatched=24, walker_steps=190,
        sampled_steps=180, restarts=3, deadlocks=1, promotions=2,
        hits=[object()], est_distinct_states=123.456,
        bloom_saturated=False, bloom_canonical=True,
        walker_steps_per_sec=77.77, seconds=2.4444)
    args = dict(target="FirstCommit", policy="tlc", seed=7,
                platform="cpu")
    assert json.dumps(sim_stats(res, **args)) == \
        json.dumps(ref_sim_stats(res, **args))


def test_span_recorder_nesting_and_file(tmp_path):
    path = str(tmp_path / "tl.json")
    rec = SpanRecorder(path)
    with rec.span("outer"):
        with rec.span("inner"):
            pass
        with rec.span("inner"):
            pass
    rec.close()
    events = json.load(open(path))
    assert [e["name"] for e in events] == ["inner", "inner", "outer"]
    for e in events:
        assert e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0
        assert e["cat"] == "obs" and e["pid"] == os.getpid()
    outer = events[-1]
    for inner in events[:2]:
        assert inner["ts"] >= outer["ts"]
        assert inner["ts"] + inner["dur"] <= \
            outer["ts"] + outer["dur"] + 1.0
    tot = rec.totals()
    assert tot["inner"]["count"] == 2 and tot["outer"]["count"] == 1
    assert list(tot) == ["inner", "outer"]
    # in-memory mode keeps the events instead
    mem = SpanRecorder()
    with mem.span("a"):
        pass
    assert [e["name"] for e in mem.events] == ["a"]


def test_span_recorder_killed_run_file_parses(tmp_path):
    """A run killed mid-stream leaves a loadable timeline (only the
    closing ] is missing, which the trace-event spec makes optional)."""
    path = str(tmp_path / "tl.json")
    rec = SpanRecorder(path)
    with rec.span("a"):
        pass
    with rec.span("b"):
        pass
    text = open(path).read()
    assert not text.rstrip().endswith("]")
    events = json.loads(text.rstrip().rstrip(",") + "]")
    assert [e["name"] for e in events] == ["a", "b"]


def test_span_annotations_reach_the_profiler(tmp_path):
    """With ``annotate`` each span is a ``record_function`` range of the
    same name in a torch.profiler trace (CPU activity here)."""
    from torch.profiler import ProfilerActivity, profile
    rec = SpanRecorder(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("level_dispatch"):
            torch.ones(4).sum()
            with rec.span("harvest"):
                torch.zeros(2).add_(1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"level_dispatch", "harvest"} <= names
    assert rec.totals()["harvest"]["count"] == 1


def _bundle(pkg, d, spans):
    """An Obs of ``pkg`` (the port's or the reference's obs package) with
    every file sink under ``d``."""
    os.makedirs(d, exist_ok=True)
    return pkg.Obs(
        spans=pkg.SpanRecorder(os.path.join(d, "tl.json")) if spans
        else None,
        ledger=pkg.RunLedger(os.path.join(d, "l.jsonl")),
        heartbeat=pkg.Heartbeat(os.path.join(d, "hb.json")),
        registry=pkg.RunRegistry(os.path.join(d, "reg")),
        meta={"spec": "raft", "ir_fingerprint": "4837e08bf0b6"},
        run_info={"cmd": "check", "cfg": "ModelConfig(...)"})


def _drive(obs, retry_hb):
    """The same hook calls a supervised check makes."""
    m = dict.fromkeys(CHECK_COUNTER_KEYS, 0)
    obs.start()
    with obs.span("burst_dispatch"):
        with obs.span("archive_io"):
            pass
    obs.dispatch(kind="burst", depth=4, frontier=7,
                 metrics=dict(m, distinct_states=14, generated_states=20,
                              levels_fused=4, burst_dispatches=1))
    obs.retry(attempt=1, max_attempts=3, wait_s=0.25,
              error=RuntimeError("injected"))
    retry_hb.append(read_heartbeat(obs.heartbeat.path))
    with obs.span("level_dispatch"):
        pass
    obs.dispatch(kind="level", depth=5, frontier=9,
                 metrics=dict(m, distinct_states=23, generated_states=40,
                              levels_fused=4, burst_dispatches=1))
    obs.finish(depth=5, states=23,
               counters=dict(m, distinct_states=23, generated_states=40,
                             depth=5, levels_fused=4, burst_dispatches=1),
               level_sizes=[1, 2, 4, 7, 9])


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in _TIMES}
    return obj


@pytest.mark.parametrize("spans", [False, True])
def test_same_obs_calls_give_the_reference_records(tmp_path, spans):
    import raft_tla_tpu.obs as ref_pkg
    import raft_tla_tpu_torch.obs as port_pkg
    got_hb, want_hb = [], []
    port = _bundle(port_pkg, str(tmp_path / "port"), spans)
    ref = _bundle(ref_pkg, str(tmp_path / "ref"), spans)
    _drive(port, got_hb)
    _drive(ref, want_hb)
    rows = [[json.loads(x) for x in open(o.ledger.path)]
            for o in (port, ref)]
    assert [r["kind"] for r in rows[0]] == [r["kind"] for r in rows[1]] \
        == ["meta", "resource", "burst", "retry", "level"]
    for got, want in zip(*rows):
        assert got["run_id"] == port.run_id and want["run_id"] == ref.run_id
        if got["kind"] == "meta":
            # the backend names torch and CUDA where the reference names
            # jax; the rest of the row is the reference's
            assert set(got) == set(want)
            b, wb = got.pop("backend"), want.pop("backend")
            assert set(wb) - {"jax"} <= set(b)
            assert set(b) - set(wb) == {"torch", "cuda"}
            assert b["platform"] == wb["platform"] == "cpu"
        assert set(got) == set(want), got["kind"]
        assert _untimed(got) == _untimed(want), got["kind"]
    # the backoff heartbeat of the retry, then the terminal one
    assert _untimed(got_hb[0]) == _untimed(want_hb[0])
    assert got_hb[0]["status"] == "backoff"
    assert got_hb[0]["retry"]["attempt"] == 1
    hb = [read_heartbeat(o.heartbeat.path) for o in (port, ref)]
    assert set(hb[0]) == set(hb[1])
    assert _untimed(hb[0]) == _untimed(hb[1])
    assert hb[0]["status"] == "finished" and hb[0]["depth"] == 5
    recs = [o.registry.load(o.run_id) for o in (port, ref)]
    assert set(recs[0]) == set(recs[1])
    for k in ("status", "depth", "distinct_states", "counters",
              "level_sizes", "cmd", "cfg", "spec", "ir_fingerprint",
              "schema"):
        assert recs[0][k] == recs[1][k], k
    assert {k: v["count"] for k, v in recs[0]["spans"].items()} == \
        {k: v["count"] for k, v in recs[1]["spans"].items()}
    assert set(recs[0]["artifacts"]) == set(recs[1]["artifacts"])
    assert _untimed(recs[0]["resources"]) == _untimed(recs[1]["resources"])
    if spans:
        tl = [json.load(open(o.spans.path)) for o in (port, ref)]
        assert [e["name"] for e in tl[0]] == [e["name"] for e in tl[1]]


def test_registry_append_atomic_and_resolve(tmp_path):
    reg = RunRegistry(str(tmp_path / "reg"))
    with pytest.raises(ValueError):
        reg.append({"cmd": "check"})          # no run_id: loud
    ra, rb = "r20260806-000001-1-aaaaaa", "r20260806-000002-1-bbbbbb"
    reg.append({"run_id": ra, "cmd": "check", "status": "finished"})
    reg.append({"run_id": rb, "cmd": "check", "status": "failed"})
    assert reg.run_ids() == [ra, rb]
    assert not [n for n in os.listdir(reg.root) if n.endswith(".tmp")]
    assert reg.load(ra)["schema"] == 1
    assert reg.resolve("last") == rb and reg.resolve(ra) == ra
    assert reg.resolve("r20260806-000001") == ra
    assert reg.resolve("r2026") is None and reg.resolve("nope") is None
    with open(os.path.join(reg.root, "r20260806-000003-1-cccccc.json"),
              "w") as fh:
        fh.write("{torn")
    assert [rid for rid, _ in reg.records()] == [ra, rb]


def test_device_memory_stats_is_none_on_the_cpu(tmp_path):
    assert device_memory_stats() is None
    assert device_memory_stats("cpu") is None
    assert backend_fingerprint("cpu") == {
        "platform": "cpu", "device_kind": "cpu", "n_devices": "1",
        "torch": torch.__version__, "cuda": str(torch.version.cuda)}
    obs = Obs(ledger=RunLedger(str(tmp_path / "l.jsonl")), device="cpu")
    obs.start()
    obs.dispatch(kind="level", depth=1)
    obs.finish()
    rows = [json.loads(x) for x in open(tmp_path / "l.jsonl")]
    assert [r["kind"] for r in rows] == ["meta", "resource", "level"]
    assert not any("device_memory" in r for r in rows)
    # nothing here initialised CUDA
    assert not torch.cuda.is_initialized()


def test_heartbeat_and_ledger_files(tmp_path):
    hb_path = str(tmp_path / "hb.json")
    hb = Heartbeat(hb_path)
    hb.beat(depth=3, states=42)
    obj = read_heartbeat(hb_path)
    assert obj["depth"] == 3 and obj["states_enqueued"] == 42
    assert obj["pid"] == os.getpid() and obj["status"] == "running"
    hb.beat(depth=4, states=50, status="finished")
    assert read_heartbeat(hb_path)["status"] == "finished"
    assert not os.path.exists(hb_path + ".tmp")
    with pytest.raises(ValueError):
        (tmp_path / "x.json").write_text("{}")
        read_heartbeat(str(tmp_path / "x.json"))
    led_path = str(tmp_path / "run.jsonl")
    led = RunLedger(led_path)
    led.record({"kind": "level", "depth": 1})
    led.record({"kind": "burst", "depth": 4})
    # readable before close: the killed-run contract
    lines = [json.loads(x) for x in open(led_path)]
    assert [x["kind"] for x in lines] == ["level", "burst"]
    assert all("ts" in x and "t_mono" in x for x in lines)
    assert lines[1]["seq"] > lines[0]["seq"]
    led.close()
    # append, never truncate
    RunLedger(led_path).record({"kind": "level", "depth": 5})
    assert len(open(led_path).readlines()) == 3
