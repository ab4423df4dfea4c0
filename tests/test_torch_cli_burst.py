"""The port's ``check`` with the burst on (both CLIs' default) against
the reference CLI's, on the micro cfg of ``test_torch_cli.py`` with
FirstCommit among its invariants: the same violation text after the
stats line, the same exit code, and the reference's stats line and
``--stats-json`` key for key (``test_torch_cli_check.py`` holds
``--no-burst``)."""

import json

import torch

from test_torch_cli import FLAGS, cfgs  # noqa: F401
from test_torch_cli_check import _both_stats, _same_report

torch.set_num_threads(1)


def test_check_with_the_burst_matches_the_reference(cfgs, capsys,
                                                      tmp_path):
    got, want = _both_stats(["check", cfgs[1]] + FLAGS, capsys, tmp_path)
    _same_report(got, want)
    assert json.loads(got[2])["levels_fused"] > 0
