"""The port's ``check`` prints the reference CLI's violation text: the
same numbered steps with their states, after the stats line, and the
same exit code (both CLIs in this process, on the micro cfg of
``test_torch_cli.py`` with FirstCommit among its invariants), here
with ``--no-burst`` on both, and the reference's stats line and
``--stats-json`` key for key (``_same_stats``: every key in the same
order, equal values apart from the timings; the file compact, as the
reference writes it); ``test_torch_cli_burst.py`` holds the same with
the burst on (one reference engine compile per file).  ``--burst-levels
0`` is refused with the reference's message and exit 2."""

import json

import torch

from test_torch_cli import FLAGS, _run, cfgs  # noqa: F401
from test_torch_cli_surface import _same_stats

torch.set_num_threads(1)


def _both_stats(argv, capsys, tmp_path):
    """(rc, stdout, stats) of the port's and the reference's check."""
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    out = []
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        path = tmp_path / f"{name}.json"
        rc, text, _err = _run(main, argv + extra +
                              ["--stats-json", str(path)], capsys)
        out.append((rc, text, path.read_text()))
    return out


def _same_report(got, want):
    assert got[0] == want[0] == 1
    line = [json.loads(t[1].split("\n", 1)[0]) for t in (got, want)]
    _same_stats(*line)
    assert list(line[0]) == list(line[1])
    assert got[1].split("\n", 1)[1] == want[1].split("\n", 1)[1]
    assert "\nViolation 0: invariant FirstCommit\n" in got[1]
    assert "       State(ct=" in got[1]
    assert "\n" not in got[2].strip()
    _same_stats(json.loads(got[2]), json.loads(want[2]))


def test_check_prints_the_reference_violation_text(cfgs, capsys,
                                                     tmp_path):
    got, want = _both_stats(["check", cfgs[1], "--no-burst"] + FLAGS,
                            capsys, tmp_path)
    _same_report(got, want)
    stats = json.loads(got[2])
    assert stats["levels_fused"] == stats["burst_dispatches"] == 0


def test_burst_levels_must_be_positive(cfgs, capsys):
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    argv = ["check", cfgs[1], "--burst-levels", "0"] + FLAGS
    got = _run(tmain, argv + ["--device", "cpu"], capsys)
    want = _run(jmain, argv, capsys)
    assert got[0] == want[0] == 2
    assert got[2] == want[2]
    assert got[2].startswith("--burst-levels must be positive (got 0)")
