"""``--spec paxos`` through both CLIs in this process: ``check`` prints
the reference's stats line (``_same_stats``: every key, the spec name
and its IR fingerprint included, equal apart from the timings) and its
violation text, at the stock size with symmetry on (with the scenario
properties as extra invariants and ``--keep-going``), with symmetry off
and ``fp128``, and at two one-ballot instances; ``trace --target
ValueChosen`` prints the reference's witness and ``--emit-seed`` writes
its seed file; ``simulate --target Preempted`` prints the reference's
stats and witness for the same seed and writes its trace file.  One
reference engine compile per command line."""

import json

import pytest
import torch

from test_torch_cli import _no_seconds, _run
from test_torch_cli_surface import _mains, _same_stats

torch.set_num_threads(1)

CHECKS = {
    "keep_going": ["--invariant", "ValueChosen", "--invariant",
                   "TwoBallots", "--keep-going", "--max-violations", "3"],
    "nosym_fp128": ["--no-symmetry", "--fp128"],
    "2inst": ["--instances", "2", "--ballots", "1"],
}


def _both(argv, capsys, tmp_path, stats=True):
    """(rc, stdout, stderr, stats file) of the port's and the
    reference's run of ``argv``."""
    tmain, jmain = _mains()
    out = []
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        path = tmp_path / f"{name}.json"
        more = ["--stats-json", str(path)] if stats else []
        rc, text, err = _run(main, argv + extra + more, capsys)
        out.append((rc, text, err, path.read_text() if stats else None))
    return out


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_check_prints_the_reference_stats_and_violations(name, capsys,
                                                         tmp_path):
    got, want = _both(["check", "--spec", "paxos", "--chunk", "64"] +
                      CHECKS[name], capsys, tmp_path)
    assert got[0] == want[0] == (1 if name == "keep_going" else 0)
    lines = [json.loads(t[1].split("\n", 1)[0]) for t in (got, want)]
    _same_stats(*lines)
    assert list(lines[0]) == list(lines[1])
    assert lines[0]["spec"] == "paxos" and \
        lines[0]["ir_fingerprint"] == "d6d7a456cec9"
    assert lines[0]["dedup_kernel"] == 0
    assert got[1].split("\n", 1)[1] == want[1].split("\n", 1)[1]
    _same_stats(json.loads(got[3]), json.loads(want[3]))
    if name == "keep_going":
        assert lines[0]["violations"] == 3
        assert "\nViolation 0: invariant TwoBallots\n" in got[1]
        assert "       PaxosState(mb=" in got[1]
    if name == "2inst":
        assert lines[0]["distinct_states"] == 1125


def test_trace_value_chosen_and_its_seed(capsys, tmp_path):
    seeds = [tmp_path / "port.seed", tmp_path / "ref.seed"]
    tmain, jmain = _mains()
    argv = ["trace", "--spec", "paxos", "--target", "ValueChosen",
            "--chunk", "64"]
    got = _run(tmain, argv + ["--device", "cpu", "--emit-seed",
                              str(seeds[0])], capsys)
    want = _run(jmain, argv + ["--emit-seed", str(seeds[1])], capsys)
    assert got[0] == want[0] == 0
    assert _no_seconds(got[1]) == _no_seconds(want[1])
    assert "Phase2b(0,1,0,0)" in got[1]
    assert json.loads(seeds[0].read_text()) == \
        json.loads(seeds[1].read_text())
    assert json.loads(seeds[0].read_text())["paxos"] is True


def test_simulate_preempted(capsys, tmp_path):
    files = [tmp_path / "port.json", tmp_path / "ref.json"]
    tmain, jmain = _mains()
    argv = ["simulate", "--spec", "paxos", "--target", "Preempted",
            "--walkers", "64", "--steps", "200", "--seed", "3"]
    got = _run(tmain, argv + ["--device", "cpu", "--trace-out",
                              str(files[0])], capsys)
    want = _run(jmain, argv + ["--trace-out", str(files[1])], capsys)
    assert got[0] == want[0] == 0
    head = [json.loads(t[1].split("\n", 1)[0]) for t in (got, want)]
    vol = ("seconds", "walker_steps_per_sec")
    assert {k: v for k, v in head[0].items() if k not in vol} == \
        {k: v for k, v in head[1].items() if k not in vol}
    assert list(head[0]) == list(head[1])
    assert head[0]["spec"] == "paxos" and head[0]["hits"] == 1
    assert _no_seconds(got[1].split("\n", 1)[1]) == \
        _no_seconds(want[1].split("\n", 1)[1])
    assert json.loads(files[0].read_text()) == \
        json.loads(files[1].read_text())
