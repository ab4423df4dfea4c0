"""The observability bundle on the card (marker ``cuda``; skips
elsewhere): the CUDA allocator's gauges and the backend fingerprint,
one ``compile`` span per graph capture (plus one for a first-use build
of the kernel library) with device memory on every dispatch row, and a
``--profile-dir`` trace that holds the hand dedup kernel by name under
the span-named ``record_function`` ranges; the same ``compile`` count on
the spill engine (plain and with the host table) and on the walker,
whose ledger rows equal the CPU's.  On the card run

    python -m pytest tests/test_torch_obs_cuda.py -m cuda --noconftest
"""

import glob
import json
import os

import pytest
import torch

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.bfs import Engine
from raft_tla_tpu_torch.obs import (Obs, RunLedger, SpanRecorder,
                                    backend_fingerprint, device_memory_stats)

pytestmark = pytest.mark.cuda

MICRO = ModelConfig(
    n_servers=2, init_servers=(0, 1), values=(1,),
    next_family=NEXT_ASYNC, symmetry=True, max_inflight_override=4,
    bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                       max_client_requests=1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) — run on the GPU")
    return torch.device("cuda")


def test_device_memory_and_backend_on_the_card(cuda):
    x = torch.ones(1 << 20, device=cuda)
    dev = device_memory_stats("cuda")
    assert set(dev) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert dev["peak_bytes_in_use"] >= dev["bytes_in_use"] >= x.nbytes
    assert dev["bytes_limit"] == \
        torch.cuda.get_device_properties(cuda).total_memory
    assert device_memory_stats() == device_memory_stats("cuda")
    b = backend_fingerprint("cuda")
    assert (b["platform"], b["device_kind"], b["n_devices"]) == (
        "gpu", torch.cuda.get_device_name(0),
        str(torch.cuda.device_count()))
    assert b["cuda"] == str(torch.version.cuda)


def test_compile_spans_count_the_captures(cuda, tmp_path):
    from raft_tla_tpu_torch.engine import cuda_ext
    built = not cuda_ext.loaded()
    led = str(tmp_path / "l.jsonl")
    obs = Obs(spans=SpanRecorder(), ledger=RunLedger(led),
              device="cuda").start()
    eng = Engine(MICRO, chunk=64, burst_levels=4, device="cuda")
    r = eng.check(obs=obs, max_depth=10)
    obs.finish(depth=r.depth, states=r.distinct_states)
    want = Engine(MICRO, chunk=64, burst_levels=4,
                  device="cpu").check(max_depth=10)
    assert (r.distinct_states, r.level_sizes) == \
        (want.distinct_states, want.level_sizes)
    tot = obs.spans.totals()
    assert eng._graphs.captures > 0
    assert tot["compile"]["count"] == eng._graphs.captures + int(built)
    rows = [json.loads(x) for x in open(led)]
    drows = [x for x in rows if x["kind"] in ("level", "burst")]
    assert drows and all(x["device_memory"]["peak_bytes_in_use"] > 0
                         for x in drows)
    assert rows[0]["backend"]["platform"] == "gpu"
    assert tot["burst_dispatch"]["count"] == r.burst_dispatches


def test_profiler_trace_holds_the_dedup_kernel(cuda, tmp_path):
    prof = str(tmp_path / "prof")
    obs = Obs(spans=SpanRecorder(), profile_dir=prof, device="cuda")
    obs.start()
    r = Engine(MICRO, chunk=64, burst_levels=4,
               device="cuda").check(obs=obs, max_depth=10)
    obs.finish(depth=r.depth, states=r.distinct_states)
    (path,) = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    assert path == obs.profile_path
    events = json.load(open(path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and
               "probe_claim_rounds" in e.get("name", "")]
    assert kernels, "no dedup kernel in the profiler's trace"
    names = {e.get("name") for e in events
             if e.get("cat") in ("user_annotation", "gpu_user_annotation")}
    assert {"compile", "burst_dispatch", "harvest"} <= names


SPILL = dict(chunk=64, seg=1 << 10, vcap=1 << 12, sync_every=2)


# the spill engine's captured chunk step on every level: without the
# burst, and under the host table (which never bursts)
@pytest.mark.parametrize("mode", [dict(burst=False), dict(
    host_table=True, partitions=4, sweep_stage=True)])
def test_spill_compile_spans_count_the_captures(cuda, tmp_path, mode):
    from raft_tla_tpu_torch.engine import cuda_ext
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    built = not cuda_ext.loaded()
    rows = {}
    for dev in ("cuda", "cpu"):
        led = str(tmp_path / f"{dev}.jsonl")
        obs = Obs(spans=SpanRecorder(), ledger=RunLedger(led),
                  device=dev).start()
        eng = SpillEngine(MICRO, **SPILL, **mode, device=dev)
        r = eng.check(obs=obs, max_depth=12)
        obs.finish(depth=r.depth, states=r.distinct_states)
        rows[dev] = [{k: v for k, v in x.items() if k in (
            "kind", "depth", "frontier", "distinct_states",
            "generated_states", "levels_fused", "burst_dispatches")}
            for x in map(json.loads, open(led))
            if x["kind"] in ("level", "burst")]
        if dev == "cuda":
            tot = obs.spans.totals()
            assert eng._graphs.captures > 0
            assert tot["compile"]["count"] == \
                eng._graphs.captures + int(built)
            assert tot["level_dispatch"]["count"] == sum(
                x["kind"] == "level" for x in rows[dev])
    assert rows["cuda"] == rows["cpu"]


def test_walker_compile_spans_count_the_captures(cuda, tmp_path):
    from raft_tla_tpu_torch.sim import SimEngine
    cfg = MICRO.with_(invariants=("FirstCommit",))
    rows = {}
    for dev in ("cuda", "cpu"):
        led = str(tmp_path / f"{dev}.jsonl")
        obs = Obs(spans=SpanRecorder(), ledger=RunLedger(led),
                  device=dev).start()
        eng = SimEngine(cfg, walkers=8, max_depth=16, seed=1,
                        bloom_bits=12, device=dev)
        r = eng.run(steps=400, steps_per_dispatch=8, obs=obs)
        obs.finish(depth=r.steps_dispatched, states=r.walker_steps)
        rows[dev] = [{k: v for k, v in x.items() if k in (
            "kind", "depth", "frontier", "walker_steps", "hits",
            "steps_dispatched", "restarts", "sampled_steps")}
            for x in map(json.loads, open(led)) if x["kind"] == "sim"]
        tot = obs.spans.totals()
        assert tot["sim_dispatch"]["count"] == len(rows[dev])
        if dev == "cuda":
            assert eng._graphs.captures > 0
            assert tot["compile"]["count"] == eng._graphs.captures
        else:
            assert "compile" not in tot
    # the card replays the gated steps after the hit: the rows agree
    assert rows["cuda"] == rows["cpu"] and rows["cpu"][-1]["hits"] >= 1
