"""``obs/report.py`` and ``cli obs`` against the reference's, on the
CPU.  One registry holds a ``check`` record from each package (the
micro cfg of ``test_torch_cli.py``); on it and on records derived from
it (a clean pair, a depth mismatch, a mode flag drifted by name, span
times that trip ``--max-span-ratio`` only when asked, a ``--stats-json``
payload, a bench headline object and an A/B row) the port's
``extract``, ``diff_runs`` and ``regress`` return the reference's
values, and ``python -m raft_tla_tpu_torch obs ls/show/diff/regress``
prints the reference CLI's stdout byte for byte with its exit code,
usage errors included.  One reference engine compile for the module.
"""

import copy
import json
import os

import pytest
import torch

from raft_tla_tpu_torch.obs import report

from test_torch_cli import FLAGS, cfgs  # noqa: F401

torch.set_num_threads(1)


def _main(main, argv, capsys):
    """(exit code, stdout) of a CLI run in this process; a SystemExit's
    code stands for the exit code (argparse's 2, or a message)."""
    capsys.readouterr()
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def reg(cfgs, tmp_path_factory):  # noqa: F811
    """A registry holding the reference's record, then the port's, and
    the stats-json payload of each run."""
    import io
    from contextlib import redirect_stderr, redirect_stdout
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    d = tmp_path_factory.mktemp("obs_report")
    regd = str(d / "reg")
    stats = {}
    for name, main, extra in (("ref", jmain, []),
                              ("port", tmain, ["--device", "cpu"])):
        path = str(d / f"{name}.stats.json")
        with redirect_stdout(io.StringIO()), \
                redirect_stderr(io.StringIO()):
            rc = main(["check", cfgs[0], "--max-depth", "8", "--registry",
                       regd, "--stats-json", path] + FLAGS + extra)
        assert rc == 0
        stats[name] = path
    ids = sorted(f[:-5] for f in os.listdir(regd))
    recs = {}
    for rid in ids:
        rec = json.load(open(os.path.join(regd, rid + ".json")))
        recs["port" if rec["backend"].get("torch") else "ref"] = rec
    assert set(recs) == {"port", "ref"} and recs["port"]["run_id"] == ids[-1]
    return dict(dir=regd, d=str(d), recs=recs, stats=stats, ids=ids)


def _variants(reg):
    """Records derived from the two runs, each shape ``extract`` reads."""
    port, ref = reg["recs"]["port"], reg["recs"]["ref"]
    deeper = copy.deepcopy(port)
    deeper["depth"] += 1
    deeper["counters"]["depth"] += 1
    drift = copy.deepcopy(port)
    drift["counters"]["guard_matmul"] = 0
    drift["counters"]["sym_canon"] = 1
    slow = copy.deepcopy(port)
    slow["spans"] = {"harvest": {"count": 3, "seconds": 3.0},
                     "level_dispatch": {"count": 3, "seconds": 0.01}}
    fast = copy.deepcopy(port)
    fast["spans"] = {"harvest": {"count": 3, "seconds": 1.0},
                     "level_dispatch": {"count": 3, "seconds": 0.001}}
    flat = json.load(open(reg["stats"]["port"]))
    headline = {"detail": json.load(open(reg["stats"]["ref"])),
                "metric": "states_per_sec"}
    ab = {"distinct": port["distinct_states"], "depth": port["depth"],
          "phase_seconds": {"harvest": 0.5, "compile": 2.0},
          "phase_counts": {"harvest": 4}}
    return dict(port=port, ref=ref, deeper=deeper, drift=drift, slow=slow,
                fast=fast, flat=flat, headline=headline, ab=ab)


def test_extract_equals_the_reference(reg):
    from raft_tla_tpu.obs import report as ref_report
    for name, rec in _variants(reg).items():
        assert report.extract(rec) == ref_report.extract(rec), name
    assert report.PARITY_KEYS == ref_report.PARITY_KEYS
    tot = reg["recs"]["port"]["spans"]
    assert report.format_span_totals(tot) == \
        ref_report.format_span_totals(tot)


@pytest.mark.parametrize("a, b, verdict, drift", [
    ("ref", "port", "clean", []),
    ("port", "deeper", "mismatch", []),
    ("port", "drift", "mode_drift", ["guard_matmul", "sym_canon"]),
    ("flat", "port", "clean", []),
    ("headline", "port", "clean", []),
    # an A/B row carries no mode flags: every flag the run has drifts
    ("ab", "port", "mode_drift", ["guard_matmul", "dedup_kernel",
                                  "delta_matmul", "sym_canon"])])
def test_diff_runs_equals_the_reference(reg, a, b, verdict, drift):
    from raft_tla_tpu.obs import report as ref_report
    v = _variants(reg)
    got = report.diff_runs(v[a], v[b])
    assert got == ref_report.diff_runs(v[a], v[b])
    assert (got["verdict"], got["mode_drift"]) == (verdict, drift)


@pytest.mark.parametrize("run, base, kw, code", [
    ("port", "ref", {}, 0),
    ("deeper", "port", {}, 1),
    ("drift", "port", {}, 0),
    ("slow", "fast", {}, 0),
    ("slow", "fast", dict(max_span_ratio=2.0), 1),
    ("slow", "fast", dict(max_span_ratio=2.0, min_seconds=1.5), 0),
    ("port", "flat", {}, 0),
    ("port", "ab", dict(max_span_ratio=1.0), 0)])
def test_regress_equals_the_reference(reg, run, base, kw, code):
    from raft_tla_tpu.obs import report as ref_report
    v = _variants(reg)
    got = report.regress(v[run], v[base], **kw)
    assert got == ref_report.regress(v[run], v[base], **kw)
    assert got[1] == code
    if run == "slow" and code:
        # the opt-in span bound names the phase; the short one never
        # trips (under --min-seconds in the baseline)
        assert got[0]["failures"] == [
            "span 'harvest' regressed 3.00x (1.00s -> 3.00s > 2.00x "
            "bound)"]


def _argvs(reg):
    """``obs`` argument lists over the shared registry."""
    r, d = reg["dir"], reg["d"]
    port_id, ref_id = reg["ids"][-1], reg["ids"][0]
    rows = os.path.join(d, "ab_rows.json")
    with open(rows, "w") as fh:
        json.dump({"rows": {
            "classic": json.load(open(reg["stats"]["ref"])),
            "deeper": dict(json.load(open(reg["stats"]["port"])),
                           depth=99)}}, fh)
    return [
        ["ls"], ["ls", "--cmd", "check"], ["ls", "--cmd", "simulate"],
        ["ls", "--spec", "raft", "--status", "finished"],
        ["show", "last"], ["show", ref_id], ["show", ref_id[:-3]],
        ["show", "r"], ["show", "nosuchrun"],
        ["diff", ref_id, "last"], ["diff", "last", "nosuch"],
        ["regress", "last", "--against", ref_id],
        ["regress", "last", "--baseline", reg["stats"]["ref"]],
        ["regress", "last", "--baseline", rows, "--baseline-row",
         "classic"],
        ["regress", "last", "--baseline", rows, "--baseline-row",
         "deeper"],
        ["regress", "last", "--baseline", rows],
        ["regress", "last", "--baseline", rows, "--baseline-row",
         "missing"],
        ["regress", "last", "--baseline", reg["stats"]["ref"],
         "--baseline-row", "classic"],
        ["regress", "last", "--against", ref_id, "--max-span-ratio",
         "1e9", "--min-seconds", "0"],
        ["regress", "last"],
        ["regress", "last", "--against", ref_id, "--baseline",
         reg["stats"]["ref"]],
        ["regress", port_id[:-2] + "zz", "--against", ref_id]], r


def test_cli_obs_prints_the_reference_byte_for_byte(reg, capsys):
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    argvs, r = _argvs(reg)
    codes = []
    for argv in argvs:
        full = ["obs", argv[0], "--registry", r] + argv[1:]
        got = _main(tmain, full, capsys)
        want = _main(jmain, full, capsys)
        assert got == want, argv
        codes.append(got[0])
    assert codes[:7] == [0] * 7
    assert codes[7:9] == [2, 2]                # no unique match
    assert codes[9:11] == [0, 2]
    assert codes[11:14] == [0, 0, 0]
    assert codes[14] == 1                      # a depth mismatch
    assert all(isinstance(c, str) for c in codes[15:18])
    assert codes[18:] == [0, 2, 2, 2]
    out = _main(tmain, ["obs", "ls", "--registry", r], capsys)[1]
    assert all(rid in out for rid in reg["ids"])


@pytest.mark.parametrize("argv", [
    ["obs"], ["obs", "ls"], ["obs", "show", "--registry", "x"],
    ["obs", "diff", "--registry", "x", "last"],
    ["obs", "regress", "--registry", "x", "last", "--max-span-ratio",
     "fast"]])
def test_cli_obs_usage_errors_exit_2_as_the_reference(argv, capsys):
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    got, want = _main(tmain, argv, capsys), _main(jmain, argv, capsys)
    assert got == want == (2, "")
