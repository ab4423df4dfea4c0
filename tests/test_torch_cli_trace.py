"""The port's ``trace`` prints the reference CLI's witness text, apart
from its seconds, with the same exit code (both CLIs in this process,
on the micro cfg of ``test_torch_cli.py``)."""

import torch

from test_torch_cli import FLAGS, _both, _no_seconds, cfgs  # noqa: F401

torch.set_num_threads(1)


def test_trace_prints_the_reference_witness_text(cfgs, capsys):
    got, want = _both(["trace", cfgs[0], "--target", "FirstCommit"]
                      + FLAGS, capsys)
    assert got[0] == want[0] == 0
    assert _no_seconds(got[1]) == _no_seconds(want[1])
    lines = got[1].splitlines()
    assert lines[0].startswith("witness for FirstCommit at depth 15 (")
    assert lines[-1] == "   15  AdvanceCommitIndex(0)"
