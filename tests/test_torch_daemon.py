"""The daemon (``serve/daemon.py``) on the CPU: its cycles over a spool
answer as the port's solo ``Engine`` and the oracle (counts, level
sizes, violations, witness traces) and as the port's ``batch`` rows;
duplicates are ``cache_hit`` rows; ``max_idle_polls`` drains with exit
0; a drain with parked work records ``draining`` and a later daemon on
the spool resumes the job bit-exact; the ``intake`` and ``daemon``
ledger rows carry the reference daemon's keys (the reference daemon
answers the same spool from the port's result cache, so no JAX engine is
built); and the reference's ``tools/watch.py`` renders the port daemon's
heartbeat."""

import contextlib
import importlib.util
import inspect
import io
import json
import os
import signal
import shutil

import pytest
import torch

torch.set_num_threads(1)

from conftest import cached_explore  # noqa: E402

from raft_tla_tpu_torch.cli import main as port_main  # noqa: E402
from raft_tla_tpu_torch.engine.bfs import Engine  # noqa: E402
from raft_tla_tpu_torch.obs import (Heartbeat, Obs, RunLedger,  # noqa: E402
                                    RunRegistry)
from raft_tla_tpu_torch.serve import (Daemon, ResultCache,  # noqa: E402
                                      job_from_dict)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = "configs/tlc_membership/raft.cfg"
MICRO = {"servers": 2, "values": [1], "max_inflight": 4,
         "next": "NextAsync",
         "bounds": {"max_log_length": 1, "max_timeouts": 1,
                    "max_client_requests": 1}}
TIMING = ("seconds", "states_per_sec", "wait_s", "service_s")


def _raft(label, **kw):
    o = {"spec": "raft", "config": CFG, "overrides": dict(MICRO),
         "label": label}
    o.update(kw)
    return o


PAX = {"spec": "paxos", "config": {"acceptors": 2, "ballots": 2,
                                   "values": 1},
       "max_depth": 3, "label": "pax"}
FBL = dict(_raft("fbl", max_depth=9),
           overrides=dict(MICRO, invariants=["FirstBecomeLeader"]))
# the first cycle's submissions, in claim (name) order
CYCLE1 = [("a-r6", _raft("r6", max_depth=6)), ("b-fbl", FBL),
          ("c-pax", PAX), ("d-pax-dup", PAX)]


def _untimed(rep, drop=()):
    return {k: v for k, v in rep.items() if k not in TIMING + drop}


def _result(spool, name):
    with open(os.path.join(spool, "results", name + ".json")) as fh:
        return json.load(fh)


def _rows(path):
    with open(path) as fh:
        return [json.loads(x) for x in fh]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("daemon")
    spool = str(d / "spool")
    led, hb, reg = str(d / "ledger.jsonl"), str(d / "hb.json"), \
        str(d / "reg")
    obs = Obs(ledger=RunLedger(led), heartbeat=Heartbeat(hb),
              registry=RunRegistry(reg), run_info={"cmd": "serve"},
              device="cpu")
    cache = str(d / "cache")
    dm = Daemon(spool, cache=ResultCache(cache),
                wave_state=str(d / "waves"), obs=obs, poll_s=0.0,
                max_idle_polls=2, grace_s=0.0, sleep=lambda s: None,
                device="cpu")
    assert dm.run_cycle() is None
    for name, job in CYCLE1:
        dm.intake.submit(job, name)
    with open(os.path.join(spool, "incoming", "e-bad.json"), "w") as fh:
        fh.write("{nope\n")
    with open(os.path.join(spool, "incoming", "f-torn.json"), "w") as fh:
        fh.write('{"spec": "paxos"')
    rep1 = dm.run_cycle()
    dm.intake.submit(PAX, "g-pax-again")
    rep2 = dm.run_cycle()
    rc = dm.run()
    return dict(dir=d, spool=spool, ledger=led, hb=hb, reg=reg,
                cache=cache, rep1=rep1, rep2=rep2, rc=rc, daemon=dm)


def test_results_equal_solo_engine_and_oracle(served):
    """Each computed job's result file against the port's solo Engine
    (counts, level sizes, violation ids and witness traces) and the
    oracle (counts, level sizes; the witness among its violations)."""
    for name, obj in CYCLE1[:3]:
        got = _result(served["spool"], name)
        job = job_from_dict(dict(obj))
        eng = Engine(job.cfg, store_states=True, device="cpu")
        solo = eng.check(max_depth=job.max_depth, stop_on_violation=True)
        assert got["status"] == "done"
        assert (got["distinct_states"], got["generated_states"],
                got["depth"], got["level_sizes"], got["violations"]) == \
            (solo.distinct_states, solo.generated_states, solo.depth,
             list(solo.level_sizes), len(solo.violations))
        assert [(v["invariant"], v["state_id"], v["trace"])
                for v in got["violations_detail"]] == \
            [(v.invariant, v.state_id,
              [lbl for lbl, _sv in eng.trace(v.state_id)])
             for v in solo.violations]
        want = cached_explore(job.cfg, max_depth=got["depth"],
                              trace_violations=True)
        assert got["distinct_states"] == want.distinct_states
        assert got["depth"] == want.depth
        assert got["level_sizes"] == list(want.level_sizes)
        # the oracle names actions its own way: the witnesses agree in
        # number, invariant and length (Init plus one step a level)
        assert [(v["invariant"], len(v["trace"]))
                for v in got["violations_detail"]] == \
            [(v.invariant, len(v.trace) + 1) for v in want.violations]
    assert _result(served["spool"], "b-fbl")["violations"] == 1


def test_results_equal_the_batch_rows(served, tmp_path):
    """The port's ``batch`` on the same four jobs prints, row for row, the
    daemon's result files but the timing keys."""
    jobs = tmp_path / "jobs.jsonl"
    jobs.write_text("\n".join(json.dumps(j) for _n, j in CYCLE1) + "\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main(["batch", "--jobs", str(jobs), "--device", "cpu"])
    assert rc == 1
    rows = [json.loads(x) for x in out.getvalue().splitlines()][1:]
    for (name, _j), row in zip(CYCLE1, rows):
        assert _untimed(_result(served["spool"], name)) == _untimed(row)


def test_duplicates_are_cache_hits_and_idle_drains(served):
    dup = _result(served["spool"], "d-pax-dup")
    again = _result(served["spool"], "g-pax-again")
    first = _result(served["spool"], "c-pax")
    assert dup["status"] == again["status"] == "cache_hit"
    assert dup["status_reason"].startswith("duplicate of job 'pax'")
    for r in (dup, again):
        assert _untimed(r, ("status", "status_reason", "label")) == \
            _untimed(first, ("status", "status_reason", "label"))
    assert served["rep1"].meta["deduped"] == 1
    assert (served["rep2"].meta["cache_hits"],
            served["rep2"].meta["batch_dispatches"]) == (1, 0)
    dm = served["daemon"]
    assert served["rc"] == 0 and dm._drain == "idle for 2 polls"
    assert dm.stats == {"cycles": 2, "jobs_claimed": 5, "jobs_done": 5,
                        "jobs_rejected": 2, "jobs_recovered": 0,
                        "cache_hits": 2, "violations": 1}
    spool = served["spool"]
    assert sorted(os.listdir(os.path.join(spool, "rejected"))) == [
        "e-bad.json", "e-bad.json.reason", "f-torn.json",
        "f-torn.json.reason"]
    assert os.listdir(os.path.join(spool, "claimed")) == []
    assert sorted(os.listdir(os.path.join(spool, "done"))) == sorted(
        [n + ".json" for n, _j in CYCLE1] + ["g-pax-again.json"])
    # each marker is written after its result file
    for fn in os.listdir(os.path.join(spool, "done")):
        assert os.path.getmtime(os.path.join(spool, "done", fn)) >= \
            os.path.getmtime(os.path.join(spool, "results", fn))
    hb = json.load(open(served["hb"]))
    assert hb["status"] == "done"
    assert hb["daemon"]["drain_reason"] == "idle for 2 polls"
    assert hb["daemon"]["tenants"]["paxos"]["jobs_done"] == 3
    recs = [rec for _rid, rec in RunRegistry(served["reg"]).records()]
    assert len(recs) == 1
    assert (recs[0]["cmd"], recs[0]["status"]) == ("serve", "done")
    assert recs[0]["counters"]["jobs_done"] == 5


def test_ledger_rows_carry_the_reference_keys(served, tmp_path):
    """The reference daemon serves the same submissions from the port's
    result cache (no engine): its intake and daemon rows have the port's
    keys, its rejection reasons the port's texts, and its result files
    the port's answers."""
    from raft_tla_tpu.obs import Obs as RObs
    from raft_tla_tpu.obs import RunLedger as RLedger
    from raft_tla_tpu.serve import Daemon as RDaemon
    from raft_tla_tpu.serve import ResultCache as RCache
    spool = str(tmp_path / "spool")
    led = str(tmp_path / "ledger.jsonl")
    cache = str(tmp_path / "cache")
    shutil.copytree(served["cache"], cache)
    rd = RDaemon(spool, cache=RCache(cache), obs=RObs(
        ledger=RLedger(led)), poll_s=0.0, max_idle_polls=1, grace_s=0.0,
        sleep=lambda s: None, wave_mesh="off")
    for name, job in CYCLE1:
        rd.intake.submit(job, name)
    with open(os.path.join(spool, "incoming", "e-bad.json"), "w") as fh:
        fh.write("{nope\n")
    with open(os.path.join(spool, "incoming", "f-torn.json"), "w") as fh:
        fh.write('{"spec": "paxos"')
    rep = rd.run_cycle()
    # the duplicate, too, is answered by the cache here
    assert rep.meta["cache_hits"] == 4 and rep.meta["deduped"] == 0
    assert rep.meta["batch_dispatches"] == 0
    assert rd.run() == 0

    def keyed(rows):
        out = {}
        for r in rows:
            if r.get("kind") in ("intake", "daemon"):
                k = (r["kind"], r.get("action"))
                out.setdefault(k, []).append(r)
        return out

    port, ref = keyed(_rows(served["ledger"])), keyed(_rows(led))
    assert set(ref) == {("intake", "claimed"), ("intake", "rejected"),
                        ("daemon", None)}
    assert set(ref) <= set(port)
    drop = {"run_id", "seq", "ts", "t_mono"}
    for k, rows in ref.items():
        for a in port[k]:
            assert set(a) - drop == set(rows[0]) - drop, k
    assert {(r["name"], r["reason"]) for r in ref[("intake", "rejected")]} \
        == {(r["name"], r["reason"])
            for r in port[("intake", "rejected")]}
    assert [(r["name"], r["cache_key"])
            for r in ref[("intake", "claimed")]] == \
        [(r["name"], r["cache_key"])
         for r in port[("intake", "claimed")][:4]]
    for name, _j in CYCLE1:
        with open(os.path.join(spool, "results", name + ".json")) as fh:
            got = json.load(fh)
        assert _untimed(got, ("status", "status_reason", "dedup_kernel")) \
            == _untimed(_result(served["spool"], name),
                        ("status", "status_reason", "dedup_kernel"))


def test_watch_renders_the_port_daemon_heartbeat(served):
    spec = importlib.util.spec_from_file_location(
        "watch", os.path.join(_REPO, "tools", "watch.py"))
    watch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(watch)
    line, code = watch.status_line(served["hb"], None, stale_s=300)
    assert code == 0 and "FINISHED" in line
    assert "daemon done  cycle 2" in line
    assert "served 5 jobs (2 cache hits, 1 violations)" in line
    assert "tenant paxos: 3 done, 2 cache hits" in line
    assert "draining: idle for 2 polls" in line


def test_drain_with_parked_work_records_draining_then_resumes(tmp_path):
    """A drain that fires once the job's first carry is on disk: exit 0,
    heartbeat done, registry "draining", the claimed file and the
    ``.wave.npz`` kept; a new daemon on the spool recovers the file,
    resumes the job mid-BFS and answers bit-exact."""
    spool = str(tmp_path / "spool")
    waves = str(tmp_path / "waves")
    job = _raft("deep", max_depth=8)

    def daemon(tag, **kw):
        obs = Obs(ledger=RunLedger(str(tmp_path / f"{tag}.jsonl")),
                  heartbeat=Heartbeat(str(tmp_path / f"{tag}.hb")),
                  registry=RunRegistry(str(tmp_path / "reg")),
                  run_info={"cmd": "serve"}, device="cpu")
        return Daemon(spool, cache=ResultCache(str(tmp_path / "cache")),
                      wave_state=waves, obs=obs, poll_s=0.0,
                      max_idle_polls=1, sleep=lambda s: None,
                      bucket_overrides={"burst_levels": 1},
                      device="cpu", **kw)

    def carried():
        return os.path.isdir(waves) and any(
            f.endswith(".wave.npz") for f in os.listdir(waves))

    d1 = daemon("d1")
    d1.intake.submit(job, "deep")
    own = d1.draining
    d1.draining = lambda: own() or carried()
    assert d1.run() == 0
    assert d1.stats["jobs_done"] == 0 and carried()
    assert os.listdir(os.path.join(spool, "claimed")) == ["deep.json"]
    assert json.load(open(tmp_path / "d1.hb"))["status"] == "done"
    (rec,) = [r for _i, r in RunRegistry(str(tmp_path / "reg")).records()]
    assert (rec["cmd"], rec["status"]) == ("serve", "draining")
    cyc = [r for r in _rows(tmp_path / "d1.jsonl")
           if r.get("kind") == "daemon"]
    assert [(r["claimed"], r["done"], r["deferred"], r["drained"])
            for r in cyc] == [(1, 0, 1, True)]

    d2 = daemon("d2")
    assert d2.run() == 0
    assert d2.stats["jobs_recovered"] == 1 and d2.stats["jobs_done"] == 1
    rows = _rows(tmp_path / "d2.jsonl")
    assert [r["action"] for r in rows if r.get("kind") == "intake"] == \
        ["recovered"]
    assert [r["label"] for r in rows if r.get("kind") == "wave_resume"] \
        == ["deep"]
    got = _result(spool, "deep")
    assert got["status_reason"] == "resumed from wave state"
    eng = Engine(job_from_dict(dict(job)).cfg, device="cpu")
    solo = eng.check(max_depth=8)
    assert (got["distinct_states"], got["generated_states"], got["depth"],
            got["level_sizes"]) == (solo.distinct_states,
                                    solo.generated_states, solo.depth,
                                    list(solo.level_sizes))
    assert not carried() and os.listdir(
        os.path.join(spool, "claimed")) == []


def test_signals_request_a_drain(tmp_path):
    d = Daemon(str(tmp_path / "spool"), device="cpu")
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                              signal.SIGINT)}
    try:
        d.install_signals()
        os.kill(os.getpid(), signal.SIGTERM)
        assert d.draining() and d._drain == "signal SIGTERM"
        d.request_drain("later")
        assert d._drain == "signal SIGTERM"
    finally:
        for s, h in saved.items():
            signal.signal(s, h)


def test_cycle_routes_through_the_scheduler():
    cyc = inspect.getsource(Daemon.run_cycle)
    assert "self.sched.serve(" in cyc
    assert "run_wave" not in cyc and "BucketEngine" not in cyc


def test_daemon_refuses_to_start_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Daemon(str(tmp_path / "spool"))
    # the scheduler raised before the intake made the spool
    assert not os.path.exists(tmp_path / "spool")
