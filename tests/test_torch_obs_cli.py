"""``check``'s observability flags on the port's CLI against the
reference CLI's, on a micro cfg on the CPU: with ``--ledger``,
``--heartbeat``, ``--trace-timeline`` and ``--registry`` both CLIs give
the same ledger kinds, keys and counters and registry records with the
same keys; the reference's own ``RunRegistry``, ``cli obs show/ls`` and
``tools/watch.py`` read the port's record, heartbeat and ledger;
``--profile-dir`` writes a ``torch.profiler`` trace that holds the span
names; a failed run ends ``failed``; ``check --spill`` and ``simulate``
write the sink each flag names; and ``--pjit`` is still refused by
name.
"""

import glob
import json
import os

import pytest
import torch

from test_torch_cli import FLAGS, _run, cfgs  # noqa: F401

torch.set_num_threads(1)

DEPTH = ["--max-depth", "8"]
_TIMES = ("ts", "t_mono", "seq", "seconds", "states_per_sec", "rss_bytes",
          "run_id", "pid", "dedup_hit_rate")


def _sinks(d):
    os.makedirs(d, exist_ok=True)
    return dict(ledger=os.path.join(d, "l.jsonl"),
                heartbeat=os.path.join(d, "hb.json"),
                timeline=os.path.join(d, "tl.json"),
                registry=os.path.join(d, "reg"))


def _flags(s):
    return ["--ledger", s["ledger"], "--heartbeat", s["heartbeat"],
            "--trace-timeline", s["timeline"], "--registry", s["registry"]]


@pytest.fixture(scope="module")
def both(cfgs, tmp_path_factory):  # noqa: F811
    """(port, reference): (exit code, stdout, sinks, ledger rows,
    registry record) of ``check`` with the four file sinks."""
    import io
    from contextlib import redirect_stderr, redirect_stdout
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    d = tmp_path_factory.mktemp("obs_cli")
    out = []
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        s = _sinks(str(d / name))
        buf = io.StringIO()
        with redirect_stdout(buf), redirect_stderr(io.StringIO()):
            rc = main(["check", cfgs[0]] + FLAGS + DEPTH + _flags(s) +
                      extra)
        rows = [json.loads(x) for x in open(s["ledger"])]
        (rec,) = [json.load(open(p)) for p in
                  glob.glob(os.path.join(s["registry"], "*.json"))]
        out.append((rc, buf.getvalue(), s, rows, rec))
    return out


def test_four_sinks_give_the_reference_records(both):
    (rc, text, _s, rows, rec), (jrc, jtext, _js, jrows, jrec) = both
    assert rc == jrc == 0
    stats, jstats = (json.loads(t.split("\n", 1)[0]) for t in (text, jtext))
    assert list(stats) == list(jstats)
    assert [r["kind"] for r in rows] == [r["kind"] for r in jrows]
    assert rows[0]["kind"] == "meta"
    for got, want in zip(rows, jrows):
        if got["kind"] == "meta":
            assert set(got["backend"]) - {"torch", "cuda"} == \
                set(want["backend"]) - {"jax"}
            got, want = dict(got), dict(want)
            got.pop("backend")
            want.pop("backend")
        assert set(got) == set(want), got["kind"]
        if got["kind"] in ("level", "burst", "meta"):
            assert {k: v for k, v in got.items() if k not in _TIMES} == \
                {k: v for k, v in want.items() if k not in _TIMES}
    last = rows[-1]
    for k in ("distinct_states", "generated_states", "levels_fused",
              "burst_dispatches", "burst_bailouts"):
        assert last[k] == stats[k]
    assert set(rec) == set(jrec)
    for k in ("status", "cmd", "cfg", "spec", "ir_fingerprint", "depth",
              "distinct_states", "counters", "level_sizes", "schema"):
        assert rec[k] == jrec[k], k
    assert rec["status"] == "finished"
    assert rec["counters"]["depth"] == stats["depth"] == 8
    # the port has nothing to compile on the CPU; every other span name
    # is the reference's
    assert set(rec["spans"]) == set(jrec["spans"]) - {"compile"}
    assert set(rec["artifacts"]) == set(jrec["artifacts"]) == \
        {"ledger", "heartbeat", "timeline"}
    assert rec["backend"]["platform"] == "cpu"
    tl = json.load(open(rec["artifacts"]["timeline"]))
    assert {e["name"] for e in tl} == set(rec["spans"])


def test_the_reference_reads_the_port_record(both, capsys):
    from raft_tla_tpu import cli as jcli
    from raft_tla_tpu.obs.registry import RunRegistry
    _rc, _text, s, rows, rec = both[0]
    (got,) = list(RunRegistry(s["registry"]).records())
    assert got == (rec["run_id"], rec)
    assert rows[0]["run_id"] == rec["run_id"]
    capsys.readouterr()
    assert jcli.main(["obs", "show", "--registry", s["registry"],
                      "last"]) == 0
    shown = json.loads(capsys.readouterr().out)
    assert shown["run_id"] == rec["run_id"]
    assert shown["counters"] == rec["counters"]
    assert jcli.main(["obs", "ls", "--registry", s["registry"]]) == 0
    assert rec["run_id"] in capsys.readouterr().out


def test_the_reference_watch_renders_the_port_heartbeat(both):
    import importlib.util
    _rc, _text, s, _rows, rec = both[0]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "watch", os.path.join(here, "tools", "watch.py"))
    watch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(watch)
    line, code = watch.status_line(s["heartbeat"], s["ledger"], 3600.0)
    assert code == 0, line
    assert "FINISHED" in line and "depth 8" in line
    assert f"{rec['distinct_states']:,} states" in line


def test_profile_dir_on_the_cpu_writes_a_trace_with_span_names(
        cfgs, tmp_path, capsys):  # noqa: F811
    from raft_tla_tpu_torch.cli import main
    prof, reg = str(tmp_path / "prof"), str(tmp_path / "reg")
    rc, _out, _err = _run(main, ["check", cfgs[0], "--device", "cpu",
                                 "--max-depth", "3", "--profile-dir", prof,
                                 "--registry", reg] + FLAGS, capsys)
    assert rc == 0
    (rec,) = [json.load(open(p)) for p in glob.glob(reg + "/*.json")]
    path = rec["artifacts"]["profile_trace"]
    assert path == os.path.join(prof, rec["run_id"] + ".pt.trace.json")
    assert os.listdir(prof) == [os.path.basename(path)]
    events = json.load(open(path))["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"burst_dispatch", "harvest", "archive_io"} <= names
    assert names <= set(rec["spans"])
    assert rec["artifacts"]["profile_dir"] == prof


def test_a_failed_run_ends_failed(cfgs, tmp_path, capsys):  # noqa: F811
    from raft_tla_tpu_torch.cli import main
    s = _sinks(str(tmp_path))
    rc, _out, err = _run(main, ["check", cfgs[0], "--device", "cpu",
                                "--resume", str(tmp_path / "none.ckpt")] +
                         FLAGS + _flags(s), capsys)
    assert rc == 2 and err.startswith("cannot resume from")
    (rec,) = [json.load(open(p)) for p in
              glob.glob(s["registry"] + "/*.json")]
    assert rec["status"] == "failed"
    assert json.load(open(s["heartbeat"]))["status"] == "failed"
    assert [json.loads(x)["kind"] for x in open(s["ledger"])] == ["meta"]


@pytest.mark.parametrize("argv, sinks", [
    (["check", "--spill", "--seg", "1024", "--ledger", "L"], "L"),
    (["check", "--spill", "--heartbeat", "H", "--registry", "R"], "HR"),
    (["check", "--spill", "--profile-dir", "P"], "P"),
    (["simulate", "--target", "FirstCommit", "--ledger", "L"], "L"),
    (["simulate", "--target", "FirstCommit", "--trace-timeline", "T"],
     "T")])
def test_spill_and_simulate_write_each_flag_sink(cfgs, tmp_path, capsys,
                                                 argv, sinks):  # noqa: F811
    """The spill engine and the random-walk engine serve every flag: each
    sink a flag names is written and parses, and the run exits 0."""
    from raft_tla_tpu_torch.cli import main
    path = {a: str(tmp_path / a) for a in ("L", "H", "R", "P", "T")}
    argv = [path.get(a, a) for a in argv]
    extra = ["--max-depth", "6"] if argv[0] == "check" else \
        ["--walkers", "8", "--max-depth", "16", "--seed", "1",
         "--bloom-bits", "12", "--steps-per-dispatch", "32",
         "--steps", "400"]
    rc, out, _err = _run(main, argv[:1] + [cfgs[0], "--device", "cpu"] +
                         argv[1:] + extra + FLAGS, capsys)
    assert rc == 0, out
    stats = json.loads(out.partition("\n")[0])
    depth = stats["depth" if argv[0] == "check" else "steps_dispatched"]
    kind = "sim" if argv[0] == "simulate" else "level"
    assert sorted(os.listdir(tmp_path)) == sorted(sinks)
    if "L" in sinks:
        rows = [json.loads(x) for x in open(path["L"])]
        assert rows[0]["kind"] == "meta" and rows[0]["cmd"] == argv[0]
        assert rows[-1]["kind"] in (kind, "burst")
        assert rows[-1]["depth"] == depth
    if "H" in sinks:
        hb = json.load(open(path["H"]))
        assert (hb["status"], hb["depth"]) == ("finished", depth)
    if "R" in sinks:
        (rec,) = [json.load(open(p)) for p in
                  glob.glob(path["R"] + "/*.json")]
        assert (rec["cmd"], rec["status"], rec["depth"]) == \
            (argv[0], "finished", depth)
        assert rec["counters"]["distinct_states"] == \
            stats["distinct_states"]
        assert {"burst_dispatch", "harvest"} <= set(rec["spans"])
    if "P" in sinks:
        (trace,) = os.listdir(path["P"])
        events = json.load(open(os.path.join(path["P"], trace)))[
            "traceEvents"]
        assert "burst_dispatch" in {e.get("name") for e in events
                                    if e.get("cat") == "user_annotation"}
    if "T" in sinks:
        tl = json.load(open(path["T"]))
        assert {e["name"] for e in tl} == {"sim_dispatch"}
        assert len(tl) == -(-depth // 32)


def test_pjit_with_an_obs_flag_is_still_refused_by_name(
        cfgs, tmp_path, capsys):  # noqa: F811
    from raft_tla_tpu_torch.cli import main
    rc, out, err = _run(main, ["check", cfgs[0], "--device", "cpu",
                               "--pjit", "--ledger",
                               str(tmp_path / "l.jsonl")] + FLAGS, capsys)
    assert rc == 2 and out == ""
    assert err.startswith("--pjit (the pod-scale pjit engine) is not "
                          "ported to this package")
    assert not os.listdir(tmp_path)      # no sink was opened


def test_oracle_ignores_the_flags_as_the_reference(cfgs, tmp_path,
                                                   capsys):  # noqa: F811
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    argv = ["check", cfgs[0], "--engine", "oracle", "--max-depth", "4",
            "--ledger", str(tmp_path / "l.jsonl")] + FLAGS
    got = _run(tmain, argv + ["--device", "cpu"], capsys)
    want = _run(jmain, argv, capsys)
    assert got[0] == want[0] == 0
    assert got[2] == want[2] and "ignored for --engine oracle" in got[2]
    assert not os.path.exists(tmp_path / "l.jsonl")
