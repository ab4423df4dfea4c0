"""The port's CLI against the reference's on a micro cfg: both CLIs run
in this process (the reference's ``main`` as its own entry point) and
must print the same text and return the same exit code for
``trace --target ElectionSafety`` (a safety invariant: no witness
within the depth, exit 1) and for an unknown target (exit 2, the same
message); the port's expansion flags are accepted and change no
answer.  The violation and witness texts are held in
``test_torch_cli_check.py`` and ``test_torch_cli_trace.py`` (one
reference engine compile each).
"""

import re

import pytest
import torch

torch.set_num_threads(1)

MICRO_CFG = """CONSTANTS
    Server = {1, 2}
    InitServer = {1, 2}
    Value = {1}
NEXT NextAsync
SYMMETRY Symmetry
INVARIANTS
    LeaderVotesQuorum
    ElectionSafety
"""
FLAGS = ["--max-log-length", "1", "--max-timeouts", "1",
         "--max-client-requests", "1", "--chunk", "64"]


@pytest.fixture(scope="module")
def cfgs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ok = d / "micro.cfg"
    ok.write_text(MICRO_CFG)
    viol = d / "viol.cfg"
    viol.write_text(MICRO_CFG + "    FirstCommit\n")
    return str(ok), str(viol)


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys, ref_extra=()):
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    want = _run(jmain, argv + list(ref_extra), capsys)
    got = _run(tmain, argv + ["--device", "cpu"], capsys)
    return got, want


def _no_seconds(text):
    return re.sub(r", [0-9.]+s\):", ", Ts):", text)


def test_trace_accepts_a_safety_invariant(cfgs, capsys):
    got, want = _both(["trace", cfgs[0], "--target", "ElectionSafety",
                       "--max-depth", "6"] + FLAGS, capsys)
    assert got[0] == want[0] == 1
    assert got[1] == want[1]
    assert got[1].startswith("no witness found for ElectionSafety "
                             "within bounds (")


def test_trace_refuses_an_unknown_target(cfgs, capsys):
    got, want = _both(["trace", cfgs[0], "--target", "NoSuchProperty"]
                      + FLAGS, capsys)
    assert got[0] == want[0] == 2
    assert got[2] == want[2] and "unknown scenario property" in got[2]


def test_expansion_flags_are_accepted(cfgs, capsys):
    from raft_tla_tpu_torch.cli import main
    base = ["check", cfgs[1], "--device", "cpu", "--max-depth", "10"] + \
        FLAGS
    outs = []
    for extra in ([], ["--no-guard-matmul", "--no-delta-matmul"],
                  ["--guard-matmul", "--delta-matmul",
                   "--fam-cap-density", "Receive=1,UpdateTerm=1"]):
        rc, out, _err = _run(main, base + extra, capsys)
        # the mode keys name the program that ran, which the flags pick
        modes = re.search(r'"guard_matmul": (\d), "dedup_kernel": (\d), '
                          r'"delta_matmul": (\d),', out).groups()
        outs.append((rc, re.sub(r'"guard_matmul": \d, "dedup_kernel": '
                                r'\d, "delta_matmul": \d,', "",
                                re.sub(r'"seconds": [^,]+, '
                                       r'"states_per_sec": [^,]+,', "",
                                       out)), modes))
    assert outs[0][:2] == outs[1][:2] == outs[2][:2]
    assert [o[2] for o in outs] == [("1", "0", "1"), ("0", "0", "0"),
                                    ("1", "0", "1")]
    rc, _out, err = _run(main, base + ["--fam-cap-density", "Receive=0"],
                         capsys)
    assert rc == 2 and err.startswith("--fam-cap-density: fam-cap-density "
                                      "Receive: k must be >= 1")
