"""The port's ``simulate`` against the reference CLI's, both run in this
process on the micro cfg of ``test_torch_cli.py``: a hunt for
FirstBecomeLeader prints the reference's stats keys in the reference's
order with equal values (apart from the run's seconds, its rate and
the platform), the reference's witness text, and writes the
reference's ``--trace-out``, ``--emit-seed`` and ``--stats-json``
files; the seed feeds the port's ``check --seed-trace``; a hunt that
finds nothing exits 1 with the reference's message; and the bounds and
target errors exit 2 with the reference's messages.  One reference
engine compile per hunt.
"""

import json
import re

import pytest
import torch

from test_torch_cli import FLAGS, _run, cfgs  # noqa: F401

torch.set_num_threads(1)

SIM = ["--walkers", "8", "--max-depth", "16", "--seed", "3",
       "--bloom-bits", "12", "--steps-per-dispatch", "32"]
TIMING = ("seconds", "walker_steps_per_sec", "platform")


def _both(argv, capsys, tmp_path, files=()):
    """(port, reference): exit code, stdout, stderr and each named
    file's text, the file paths given per side."""
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    out = {}
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        paths = {f: str(tmp_path / f"{name}.{f}.json") for f in files}
        flags = [x for f in files for x in (f"--{f}", paths[f])]
        rc, text, err = _run(main, argv + flags + extra, capsys)
        out[name] = (rc, text, err.replace(f"{name}.", ""),
                     {f: open(p).read() for f, p in paths.items()})
    return out["port"], out["ref"]


def _stats(text):
    return json.loads(text.partition("\n")[0])


def _no_time(text):
    return re.sub(r"walker-steps, [0-9.]+s\):", "walker-steps, Ts):",
                  text.partition("\n")[2])


def test_simulate_matches_the_reference(cfgs, capsys, tmp_path):
    argv = ["simulate", cfgs[0], "--target", "FirstBecomeLeader",
            "--steps", "400"] + SIM + FLAGS
    got, want = _both(argv, capsys, tmp_path,
                      ("trace-out", "emit-seed", "stats-json"))
    assert got[0] == want[0] == 0
    gs, ws = _stats(got[1]), _stats(want[1])
    assert list(gs) == list(ws)
    assert {k: v for k, v in gs.items() if k not in TIMING} == \
        {k: v for k, v in ws.items() if k not in TIMING}
    assert gs["platform"] == "cpu" and gs["hits"] == 1 and \
        gs["walker_steps"] > 0
    assert _no_time(got[1]) == _no_time(want[1])
    assert "witness for FirstBecomeLeader at depth " in got[1]
    assert got[2] == want[2]              # the files' stderr lines
    for f in ("trace-out", "emit-seed"):
        assert got[3][f] == want[3][f], f
    fs, fw = json.loads(got[3]["stats-json"]), \
        json.loads(want[3]["stats-json"])
    assert fs == gs and list(fw) == list(fs)
    # the seed continues in the port's punctuated search
    from raft_tla_tpu_torch.cli import main as tmain
    rc, text, _err = _run(tmain, [
        "check", cfgs[0], "--seed-trace", str(tmp_path / "port.emit-seed"
                                              ".json"),
        "--max-depth", "3", "--device", "cpu"] + FLAGS, capsys)
    assert rc == 0 and json.loads(text.partition("\n")[0])[
        "distinct_states"] > 1


def test_simulate_without_a_witness(cfgs, capsys, tmp_path):
    argv = ["simulate", cfgs[0], "--target", "FirstCommit", "--steps",
            "3", "--policy", "tlc"] + SIM + FLAGS
    got, want = _both(argv, capsys, tmp_path)
    assert got[0] == want[0] == 1
    assert got[2] == want[2] and got[2].startswith(
        "no witness found for FirstCommit within ")
    gs, ws = _stats(got[1]), _stats(want[1])
    assert {k: v for k, v in gs.items() if k not in TIMING} == \
        {k: v for k, v in ws.items() if k not in TIMING}
    assert gs["policy"] == "tlc" and gs["hits"] == 0


@pytest.mark.parametrize("flag", ["--walkers", "--steps",
                                  "--steps-per-dispatch"])
def test_simulate_refuses_non_positive_bounds(cfgs, capsys, tmp_path,
                                              flag):
    argv = ["simulate", cfgs[0], "--target", "FirstBecomeLeader"] + \
        FLAGS + [flag, "0"]
    got, want = _both(argv, capsys, tmp_path)
    assert got[0] == want[0] == 2
    assert got[1:3] == want[1:3] == ("", f"{flag} must be positive "
                                         f"(got 0)\n")


def test_simulate_refuses_an_unknown_target(cfgs, capsys, tmp_path):
    argv = ["simulate", cfgs[0], "--target", "NoSuchProperty"] + FLAGS
    got, want = _both(argv, capsys, tmp_path)
    assert got[0] == want[0] == 2
    assert got[2] == want[2] and "unknown scenario property" in got[2]


def test_simulate_help_names_the_mesh_rule(capsys):
    from raft_tla_tpu_torch.cli import main as tmain
    with pytest.raises(SystemExit):
        tmain(["simulate", "--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "--mesh" in text and "one device" in text


def test_simulate_defaults_to_the_card(cfgs):
    """Without --device the run is on the card; with no CUDA it raises
    (it never falls back to the CPU quietly)."""
    from raft_tla_tpu_torch.cli import main as tmain
    if torch.cuda.is_available():
        assert tmain(["simulate", cfgs[0], "--target", "FirstBecomeLeader",
                      "--steps", "40"] + SIM + FLAGS) == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmain(["simulate", cfgs[0], "--target", "FirstBecomeLeader"]
                  + SIM + FLAGS)
