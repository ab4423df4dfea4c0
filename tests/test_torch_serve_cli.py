"""``python -m raft_tla_tpu_torch batch`` against the reference CLI: the
summary's keys and order and the report lines (the port fills a result
cache that the reference CLI then answers from, key for key), the exit
codes 0, 1, 2 and 3, the refusals of the wave mesh (ROADMAP item 9d)
and of the executable cache (item 8b); and ``check --dedup-kernel``:
the flag set of both CLIs' ``check`` and ``batch`` parsers, ``off``
against ``auto``, and ``on`` refused without CUDA."""

import argparse
import contextlib
import io
import json

import pytest
import torch

torch.set_num_threads(1)

from raft_tla_tpu.cli import main as ref_main  # noqa: E402

from raft_tla_tpu_torch.cli import main as port_main  # noqa: E402

MICRO = {"servers": 2, "values": [1], "max_inflight": 4,
         "next": "NextAsync",
         "bounds": {"max_log_length": 1, "max_timeouts": 1,
                    "max_client_requests": 1}}
CFG = "configs/tlc_membership/raft.cfg"


def _raft(label, **kw):
    o = {"spec": "raft", "config": CFG, "overrides": dict(MICRO),
         "label": label}
    o.update(kw)
    return o


CLEAN = [_raft("r4", max_depth=4), _raft("r6", max_depth=6),
         {"spec": "paxos", "config": {"acceptors": 2, "ballots": 1,
                                      "values": 1}, "label": "p"}]
VIOLATING = [dict(_raft("fc", max_depth=9), overrides=dict(
    MICRO, invariants=["FirstBecomeLeader"]))]


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _jobs_file(tmp_path, jobs, name="jobs.jsonl"):
    p = tmp_path / name
    p.write_text("\n".join(json.dumps(j) for j in jobs) + "\n")
    return str(p)


def test_summary_and_reports_equal_the_reference_cli(tmp_path):
    """The port's batch fills a cache the reference CLI answers from:
    the summary lines have the same keys in the same order, and every
    report line the reference prints from the port's cache is the
    port's own, key for key."""
    jobs = _jobs_file(tmp_path, CLEAN)
    cache = str(tmp_path / "cache")
    rc, out, _ = _run(port_main, ["batch", "--jobs", jobs, "--device",
                                  "cpu", "--cache-dir", cache])
    assert rc == 0
    p_lines = [json.loads(x) for x in out.splitlines()]
    assert len(p_lines) == 1 + len(CLEAN)
    assert p_lines[0]["kind"] == "batch_summary"
    assert p_lines[0]["batch_dispatches"] > 0
    rc, out, _ = _run(ref_main, ["batch", "--jobs", jobs, "--cache-dir",
                                 cache])
    assert rc == 0
    r_lines = [json.loads(x) for x in out.splitlines()]
    assert list(r_lines[0]) == list(p_lines[0])
    assert r_lines[0]["cache_hits"] == len(CLEAN)
    assert r_lines[0]["batch_dispatches"] == 0
    for got, want in zip(r_lines[1:], p_lines[1:]):
        assert got["status"] == "cache_hit"
        assert {k: v for k, v in got.items() if k != "status"} == \
            {k: v for k, v in want.items() if k != "status"}
    # and the port's second run answers every job from the cache
    rc, out, _ = _run(port_main, ["batch", "--jobs", jobs, "--device",
                                  "cpu", "--cache-dir", cache])
    s = json.loads(out.splitlines()[0])
    assert (rc, s["cache_hits"], s["batch_dispatches"],
            s["engines_compiled"]) == (0, len(CLEAN), 0, 0)


def test_exit_one_on_a_violation_with_its_witness(tmp_path):
    jobs = _jobs_file(tmp_path, VIOLATING)
    rc, out, _ = _run(port_main, ["batch", "--jobs", jobs, "--device",
                                  "cpu"])
    assert rc == 1
    rep = json.loads(out.splitlines()[1])
    (det,) = rep["violations_detail"]
    assert det["invariant"] == "FirstBecomeLeader"
    assert det["trace"][0] == "Init"
    assert det["trace"][-1].startswith("BecomeLeader")


USAGE = [
    (["--wave-mesh", "2"], "9d"),
    (["--wave-mesh", "2x2"], "9d"),
    (["--executable-cache", "ec"], "8b"),
    (["--executable-cache-max-bytes", "5"], "add --executable-cache"),
    (["--cache-max-bytes", "10"], "add --cache-dir"),
    (["--max-wave", "0"], "--max-wave must be >= 1"),
    (["--wave-yield", "0"], "--wave-yield must be >= 1"),
    (["--chaos", "nowhere:at=1"], "nowhere"),
    (["--retries", "-1"], "--retries must be >= 0"),
]


@pytest.mark.parametrize("extra,needle", USAGE,
                         ids=[u[0][0] + "=" + u[0][1] for u in USAGE])
def test_usage_errors_exit_two(tmp_path, extra, needle):
    jobs = _jobs_file(tmp_path, CLEAN[:1])
    rc, out, err = _run(port_main, ["batch", "--jobs", jobs, "--device",
                                    "cpu"] + extra)
    assert rc == 2 and needle in err and out == ""


@pytest.mark.parametrize("job", [
    {"spec": "raft", "config": CFG, "colour": 1},
    {"spec": "raft", "config": "no/such.cfg"},
    {"spec": "paxos", "config": {"acceptors": 0}},
], ids=["unknown-key", "missing-cfg", "bad-paxos"])
def test_bad_jobs_exit_two_with_the_reference_message(tmp_path, job):
    text = json.dumps(job)
    rc_p, _o, err_p = _run(port_main, ["batch", "--job", text,
                                       "--device", "cpu"])
    rc_r, _o, err_r = _run(ref_main, ["batch", "--job", text])
    assert rc_p == rc_r == 2
    assert err_p == err_r


def test_no_jobs_and_spent_retries(tmp_path):
    assert _run(port_main, ["batch", "--device", "cpu"])[0] == 2
    jobs = _jobs_file(tmp_path, CLEAN[:1])
    rc, _out, err = _run(port_main, ["batch", "--jobs", jobs, "--device",
                                     "cpu", "--chaos", "dispatch:every=1",
                                     "--backoff", "0.01"])
    assert rc == 3 and "batch run failed" in err
    # the schedule does not outlive the run
    from raft_tla_tpu_torch.resil.chaos import get_schedule
    assert get_schedule() is None


def _flags(main, cmd):
    got = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, *a, **kw):
        got["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        _run(main, [cmd])
    finally:
        argparse.ArgumentParser.parse_args = orig
    sub = next(a for a in got["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return {s for a in sub.choices[cmd]._actions for s in a.option_strings}


@pytest.mark.parametrize("cmd", ["check", "batch"])
def test_port_parser_has_every_reference_flag(cmd):
    ref, port = _flags(ref_main, cmd), _flags(port_main, cmd)
    assert ref - port == set()
    # the port's own: the device, and check's capacity knobs
    assert port - ref <= {"--device", "--lcap", "--vcap", "--ocap"}


def _check_stats(extra):
    rc, out, err = _run(port_main, [
        "check", CFG, "--servers", "2", "--next", "NextAsync",
        "--max-log-length", "1", "--max-timeouts", "1",
        "--max-client-requests", "1", "--max-depth", "7", "--device",
        "cpu"] + extra)
    return rc, json.loads(out.splitlines()[0]) if rc == 0 else err


def test_check_dedup_kernel_off_auto_and_on():
    rc_a, auto = _check_stats([])
    rc_o, off = _check_stats(["--dedup-kernel", "off"])
    assert rc_a == rc_o == 0
    assert off["dedup_kernel"] == auto["dedup_kernel"] == 0
    drop = ("seconds", "states_per_sec")
    assert {k: v for k, v in off.items() if k not in drop} == \
        {k: v for k, v in auto.items() if k not in drop}
    rc, err = _check_stats(["--dedup-kernel", "on"])
    assert rc == 2 and "--dedup-kernel on needs a CUDA device" in err
    # 'off' on the card (the default device) would move the dedup to
    # the host: a usage error
    rc, _out, err = _run(port_main, [
        "check", CFG, "--servers", "2", "--max-depth", "3",
        "--dedup-kernel", "off"])
    assert rc == 2 and "--dedup-kernel off needs --device cpu" in err
