"""The port's random-walk engine with an observability bundle against
the reference's on the CPU: ``SimEngine.run(obs=)`` on the config of
``tests/test_obs.py::test_telemetry_parity_sim_engine`` writes, row for
row, the reference's ``kind="sim"`` ledger rows (exactly the
``SIM_DISPATCH_KEYS`` counters, consistent with the SimResult), one
``sim_dispatch`` span per dispatch and the reference's heartbeat; and
both CLIs' ``simulate`` with the four file sinks give the same row
kinds, keys and counters and registry records with the same keys, with
``cmd`` ``simulate`` (and ``failed`` where the run raises).  One
reference engine compile for each of the two.
"""

import glob
import json
import os

import pytest
import torch

from raft_tla_tpu_torch.obs import SIM_DISPATCH_KEYS, sim_counters
from raft_tla_tpu_torch.obs.heartbeat import read_heartbeat
from raft_tla_tpu_torch.sim import SimEngine

from test_torch_cli import FLAGS, _run, cfgs  # noqa: F401
from test_torch_cli_sim import SIM
from test_torch_obs_cli import _TIMES, _flags, _sinks
from test_torch_obs_engine import TINY

torch.set_num_threads(1)

CFG = TINY.with_(invariants=("ElectionSafety",))
ENGINE = dict(walkers=8, max_depth=8, seed=0, bloom_bits=12)
RUN = dict(steps=24, steps_per_dispatch=8, stop_on_hit=False)


def _run_engine(pkg, eng, tmp_path, name):
    led = str(tmp_path / f"{name}.jsonl")
    hb = str(tmp_path / f"{name}.hb.json")
    spans = pkg.SpanRecorder()
    obs = pkg.Obs(ledger=pkg.RunLedger(led), heartbeat=pkg.Heartbeat(hb),
                  spans=spans).start()
    r = eng.run(obs=obs, **RUN)
    obs.finish(depth=int(r.steps_dispatched), states=int(r.walker_steps),
               counters=pkg.sim_counters(r))
    rows = [json.loads(x) for x in open(led)]
    return r, rows, read_heartbeat(hb), spans.totals()


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    import raft_tla_tpu.obs as ref_obs
    import raft_tla_tpu_torch.obs as port_obs
    from raft_tla_tpu.sim.walker import SimEngine as RefSim
    from test_obs import TINY as REF_TINY
    ref_cfg = REF_TINY.with_(invariants=("ElectionSafety",))
    assert repr(ref_cfg) == repr(CFG)
    tmp = tmp_path_factory.mktemp("obs_sim")
    ref = _run_engine(ref_obs, RefSim(ref_cfg, **ENGINE), tmp, "ref")
    port = _run_engine(port_obs, SimEngine(CFG, device="cpu", **ENGINE),
                       tmp, "port")
    return port, ref


def test_sim_rows_equal_the_reference_row_for_row(engines):
    (r, rows, _hb, _t), (ref_r, ref_rows, _rhb, _rt) = engines
    assert sim_counters(r) == sim_counters(ref_r)
    got = [x for x in rows if x["kind"] == "sim"]
    want = [x for x in ref_rows if x["kind"] == "sim"]
    assert [x["kind"] for x in rows if x["kind"] != "resource"] == \
        [x["kind"] for x in ref_rows if x["kind"] != "resource"]
    assert len(got) == len(want) == RUN["steps"] // RUN["steps_per_dispatch"]
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert set(SIM_DISPATCH_KEYS) <= set(a)
        assert {k: v for k, v in a.items() if k not in _TIMES} == \
            {k: v for k, v in b.items() if k not in _TIMES}
    last = got[-1]
    assert {k: last[k] for k in SIM_DISPATCH_KEYS} == \
        {k: sim_counters(r)[k] for k in SIM_DISPATCH_KEYS}
    assert [x["depth"] for x in got] == [8, 16, 24]


def test_sim_spans_and_heartbeat(engines):
    (r, rows, hb, tot), (_rr, _rrows, ref_hb, ref_tot) = engines
    n = sum(x["kind"] == "sim" for x in rows)
    assert tot == {"sim_dispatch": tot["sim_dispatch"]}
    assert tot["sim_dispatch"]["count"] == n == \
        ref_tot["sim_dispatch"]["count"]
    for k in ("status", "depth", "states_enqueued", "beats"):
        assert hb[k] == ref_hb[k], k
    assert hb["depth"] == r.steps_dispatched
    assert hb["states_enqueued"] == r.walker_steps


@pytest.fixture(scope="module")
def clis(cfgs, tmp_path_factory):  # noqa: F811
    """(port, reference): exit code, stdout, ledger rows, registry record
    of a FirstBecomeLeader hunt with the four file sinks."""
    import io
    from contextlib import redirect_stderr, redirect_stdout
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    d = tmp_path_factory.mktemp("obs_sim_cli")
    out = []
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        s = _sinks(str(d / name))
        buf = io.StringIO()
        with redirect_stdout(buf), redirect_stderr(io.StringIO()):
            rc = main(["simulate", cfgs[0], "--target",
                       "FirstBecomeLeader", "--steps", "400"] + SIM +
                      FLAGS + _flags(s) + extra)
        rows = [json.loads(x) for x in open(s["ledger"])]
        (rec,) = [json.load(open(p)) for p in
                  glob.glob(os.path.join(s["registry"], "*.json"))]
        out.append((rc, buf.getvalue(), s, rows, rec))
    return out


def test_simulate_sinks_give_the_reference_records(clis):
    (rc, text, s, rows, rec), (jrc, jtext, _js, jrows, jrec) = clis
    assert rc == jrc == 0
    stats = json.loads(text.partition("\n")[0])
    assert [x["kind"] for x in rows if x["kind"] != "resource"] == \
        [x["kind"] for x in jrows if x["kind"] != "resource"]
    assert rows[0]["kind"] == "meta" and rows[0]["cmd"] == "simulate"
    for got, want in zip(rows, jrows):
        if got["kind"] == "sim":
            assert set(got) == set(want)
            assert {k: v for k, v in got.items() if k not in _TIMES} == \
                {k: v for k, v in want.items() if k not in _TIMES}
    sim = [x for x in rows if x["kind"] == "sim"]
    assert sim and all(set(SIM_DISPATCH_KEYS) <= set(x) for x in sim)
    assert sim[-1]["steps_dispatched"] == stats["steps_dispatched"]
    assert set(rec) == set(jrec)
    for k in ("status", "cmd", "cfg", "spec", "ir_fingerprint", "depth",
              "distinct_states", "counters", "schema"):
        assert rec[k] == jrec[k], k
    assert rec["cmd"] == "simulate" and rec["status"] == "finished"
    assert rec["depth"] == stats["steps_dispatched"]
    assert rec["distinct_states"] == stats["walker_steps"]
    assert set(rec["spans"]) == set(jrec["spans"]) - {"compile"} == \
        {"sim_dispatch"}
    assert rec["spans"]["sim_dispatch"]["count"] == len(sim)
    hb = read_heartbeat(s["heartbeat"])
    assert hb["status"] == "finished" and hb["depth"] == rec["depth"]
    tl = json.load(open(rec["artifacts"]["timeline"]))
    assert {e["name"] for e in tl} == {"sim_dispatch"}


def test_simulate_that_raises_ends_failed(cfgs, tmp_path, capsys,
                                          monkeypatch):  # noqa: F811
    from raft_tla_tpu_torch.cli import main

    def broken(self, *a, **kw):
        raise RuntimeError("walker fault")
    monkeypatch.setattr(SimEngine, "run", broken)
    s = _sinks(str(tmp_path))
    with pytest.raises(RuntimeError, match="walker fault"):
        _run(main, ["simulate", cfgs[0], "--target", "FirstBecomeLeader",
                    "--device", "cpu"] + SIM + FLAGS + _flags(s), capsys)
    (rec,) = [json.load(open(p)) for p in
              glob.glob(s["registry"] + "/*.json")]
    assert (rec["status"], rec["cmd"]) == ("failed", "simulate")
    assert read_heartbeat(s["heartbeat"])["status"] == "failed"
    assert [json.loads(x)["kind"] for x in open(s["ledger"])] == ["meta"]
