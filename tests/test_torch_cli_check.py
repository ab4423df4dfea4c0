"""The port's ``check`` prints the reference CLI's violation text: the
same numbered steps with their states, after the stats line, and the
same exit code (both CLIs in this process, on the micro cfg of
``test_torch_cli.py`` with FirstCommit among its invariants)."""

import torch

from test_torch_cli import FLAGS, _both, cfgs  # noqa: F401

torch.set_num_threads(1)


def test_check_prints_the_reference_violation_text(cfgs, capsys):
    got, want = _both(["check", cfgs[1]] + FLAGS, capsys,
                      ref_extra=["--no-burst"])
    assert got[0] == want[0] == 1
    # the stats line differs in its keys; everything after it is equal
    assert got[1].split("\n", 1)[1] == want[1].split("\n", 1)[1]
    assert "\nViolation 0: invariant FirstCommit\n" in got[1]
    assert "       State(ct=" in got[1]
