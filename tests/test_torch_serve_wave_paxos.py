"""A batched wave of paxos jobs over ballots and values in one padded
bucket, with violated invariants and witness traces, through ``batch
--device cpu`` in-process: the reports equal the JAX package's
``run_jobs`` (every key but the timing keys, traces included), each
job's counts, violation ids and witness traces equal the port's solo
``Engine`` and the paxos oracle, and the wave state a killed JAX batch
leaves behind resumes in the port."""

import json
import os

import pytest
import torch

torch.set_num_threads(1)

from conftest import cached_explore  # noqa: E402

from raft_tla_tpu.serve import load_jobs as r_load_jobs  # noqa: E402
from raft_tla_tpu.serve import run_jobs as r_run_jobs  # noqa: E402

from raft_tla_tpu_torch.cli import main as port_main  # noqa: E402
from raft_tla_tpu_torch.engine.bfs import Engine  # noqa: E402
from raft_tla_tpu_torch.serve import WaveScheduler, load_jobs  # noqa: E402

TIMING = ("seconds", "states_per_sec", "wait_s", "service_s")


def _pax(label, b, v, **kw):
    o = {"spec": "paxos", "label": label, "config": {
        "acceptors": 2, "ballots": b, "values": v,
        "invariants": ["Agreement", "ValueChosen"]}}
    o.update(kw)
    return o


JOBS = [_pax("p22", 2, 2),
        _pax("p21-all", 2, 1, keep_going=True, max_depth=9),
        _pax("p12", 1, 2, max_depth=5),
        _pax("p11", 1, 1, store=False)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wave_paxos")
    path = d / "jobs.jsonl"
    path.write_text("\n".join(json.dumps(j) for j in JOBS) + "\n")
    out = d / "stats.json"
    rc = port_main(["batch", "--jobs", str(path), "--device", "cpu",
                    "--stats-json", str(out)])
    port = json.loads(out.read_text())
    try:
        r_run_jobs(r_load_jobs(str(path))[:1], wave_mesh="off")
    except TypeError:
        pass          # the reference's first-call fault (see README)
    ref = r_run_jobs(r_load_jobs(str(path)), wave_mesh="off")
    return rc, port, ref, str(path)


def test_exit_one_on_violations_one_bucket(runs):
    rc, port, _ref, _path = runs
    assert rc == 1
    s = port["summary"]
    assert (s["buckets"], s["engines_compiled"], s["fallback_jobs"]) == \
        (1, 1, 0)
    assert s["violations"] == sum(r["violations"] for r in port["jobs"])
    assert s["violations"] > len(JOBS)


def test_reports_and_traces_equal_reference(runs):
    _rc, port, ref, _path = runs
    assert [list(r) for r in port["jobs"]] == \
        [list(o.report) for o in ref.outcomes]
    for got, o in zip(port["jobs"], ref.outcomes):
        want = {k: v for k, v in o.report.items() if k not in TIMING}
        assert {k: v for k, v in got.items() if k not in TIMING} == want
    traced = [d for r in port["jobs"] for d in r["violations_detail"]
              if "trace" in d]
    assert traced and all(t["trace"][0] == "Init" for t in traced)


def test_violations_and_traces_equal_solo_engine_and_oracle(runs):
    _rc, port, _ref, path = runs
    jobs = load_jobs(path)
    out = WaveScheduler(device="cpu").serve(jobs).outcomes
    for job, got, o in zip(jobs, port["jobs"], out):
        eng = Engine(job.cfg, device="cpu", store_states=job.store_states)
        solo = eng.check(max_depth=job.max_depth,
                         stop_on_violation=job.stop_on_violation)
        want = cached_explore(job.cfg, max_depth=job.max_depth,
                              stop_on_violation=job.stop_on_violation)
        assert got["distinct_states"] == solo.distinct_states
        assert got["level_sizes"] == solo.level_sizes
        assert [(v.invariant, v.state_id) for v in o.res.violations] == \
            [(v.invariant, v.state_id) for v in solo.violations]
        assert {v.invariant for v in want.violations} == \
            {v.invariant for v in solo.violations}
        if job.store_states:
            for v in solo.violations[:3]:
                assert [(lbl, repr(sv)) for lbl, sv in
                        o.trace(v.state_id)] == \
                    [(lbl, repr(sv)) for lbl, sv in eng.trace(v.state_id)]


def test_reference_wave_state_resumes_in_the_port(runs, tmp_path):
    """A ``wave_kill`` of the JAX package's batch leaves its .wave.npz
    files; the port resumes every job from them mid-BFS and answers as
    its own uninterrupted run."""
    from raft_tla_tpu.resil import chaos as rchaos
    _rc, port, _ref, path = runs
    d = str(tmp_path / "ws")
    rchaos.install("wave_kill:at=1")
    try:
        with pytest.raises(rchaos.InjectedFault):
            r_run_jobs(r_load_jobs(path), wave_state=d, wave_mesh="off")
    finally:
        rchaos.uninstall()
    saved = [f for f in os.listdir(d) if f.endswith(".wave.npz")]
    assert saved
    rep = WaveScheduler(device="cpu", wave_state=d).serve(load_jobs(path))
    assert rep.meta["resumed_jobs"] == len(saved)
    for o, want in zip(rep.outcomes, port["jobs"]):
        if o.report["cache_key"] + ".wave.npz" in saved:
            assert o.report["status_reason"] == "resumed from wave state"
        drop = TIMING + ("status_reason",)
        assert {k: v for k, v in o.report.items() if k not in drop} == \
            {k: v for k, v in want.items() if k not in drop}
