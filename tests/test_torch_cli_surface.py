"""The port's ``check``/``trace`` flag surface against the reference CLI,
both run in this process on micro cfgs: ``--engine oracle`` (stats,
violation and witness text, ``--emit-seed``, ``--seed-trace`` and the
refusal of an engine-emitted seed for history-scanning predicates),
unknown ``--invariant``/``--constraint``/``--action-constraint`` names,
the model overrides (``--symmetry``, ``--next``, ``--max-terms``,
``--max-restarts``, ``--fp128``) with ``--no-store``, ``--keep-going``
and ``--max-violations`` on the engine (one reference compile), and the
cfg-pinned search with ``pin_interior_states`` in the stats.
"""

import json
import shutil

import pytest
import torch

from test_torch_cli import FLAGS, _run, cfgs  # noqa: F401

torch.set_num_threads(1)

VOLATILE = ("seconds", "states_per_sec")


def _mains():
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    return tmain, jmain


def _same_stats(got, want):
    """The port's stats line carries the reference's keys, its IR
    fingerprint included, with the same values."""
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in VOLATILE} == \
        {k: v for k, v in want.items() if k not in VOLATILE}


def _no_seconds(text):
    head, rest = text.split(" states explored, ", 1)
    return head + rest.split("s):", 1)[1]


@pytest.mark.parametrize("keep", [False, True], ids=["stop", "keep-going"])
def test_oracle_check_matches_the_reference(cfgs, capsys, keep):
    tmain, jmain = _mains()
    argv = ["check", cfgs[0], "--engine", "oracle", "--invariant",
            "FirstCommit", "--max-depth", "16"] + FLAGS + \
        (["--keep-going"] if keep else [])
    got = _run(tmain, argv, capsys)
    want = _run(jmain, argv, capsys)
    assert got[0] == want[0] == 1
    _same_stats(json.loads(got[1].split("\n", 1)[0]),
                json.loads(want[1].split("\n", 1)[0]))
    assert got[1].split("\n", 1)[1] == want[1].split("\n", 1)[1]
    assert got[1].count("\nViolation ") == (9 if keep else 1)
    assert "\nViolation 0: FirstCommit\n  Timeout(0) -> " in got[1]


def test_oracle_trace_and_seeds_match_the_reference(cfgs, capsys,
                                                   tmp_path):
    """``trace --engine oracle --emit-seed`` writes the reference's
    seed (no non-VIEW lanes: the oracle keeps the history records);
    ``check --engine oracle --seed-trace`` from it prints the
    reference's answer; an engine-emitted seed is refused when a
    history-scanning predicate is on, with the reference's message."""
    tmain, jmain = _mains()
    out = {}
    for name, main in (("port", tmain), ("ref", jmain)):
        seed = tmp_path / f"{name}.json"
        out[name] = _run(main, ["trace", cfgs[0], "--engine", "oracle",
                                "--target", "FirstBecomeLeader",
                                "--emit-seed", str(seed)] + FLAGS, capsys)
    got, want = out["port"], out["ref"]
    assert got[0] == want[0] == 0
    assert _no_seconds(got[1]) == _no_seconds(want[1])
    assert "\n    9  BecomeLeader(0)\n" in got[1]
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    argv = ["check", cfgs[0], "--engine", "oracle", "--seed-trace",
            str(tmp_path / "ref.json"), "--invariant", "FirstCommit",
            "--max-depth", "7", "--keep-going"] + FLAGS
    got, want = _run(tmain, argv, capsys), _run(jmain, argv, capsys)
    assert got[0] == want[0] == 1
    _same_stats(json.loads(got[1].split("\n", 1)[0]),
                json.loads(want[1].split("\n", 1)[0]))
    assert got[1].split("\n", 1)[1] == want[1].split("\n", 1)[1]
    # an engine-emitted seed, for a history-scanning invariant
    eng_seed = tmp_path / "engine.json"
    assert tmain(["trace", cfgs[0], "--target", "FirstBecomeLeader",
                  "--emit-seed", str(eng_seed), "--device", "cpu"]
                 + FLAGS) == 0
    argv = ["check", cfgs[0], "--engine", "oracle", "--seed-trace",
            str(eng_seed), "--invariant", "FirstBecomeLeader"] + FLAGS
    got, want = _run(tmain, argv, capsys), _run(jmain, argv, capsys)
    assert got[0] == want[0] == 2
    assert got[2] == want[2] and "re-emit the seed" in got[2]


@pytest.mark.parametrize("flag,name", [
    ("--invariant", "NoSuchInvariant"), ("--constraint", "NoSuchBound"),
    ("--action-constraint", "NoSuchAction")])
def test_unknown_names_are_refused(cfgs, flag, name):
    tmain, jmain = _mains()
    argv = ["check", cfgs[0], flag, name] + FLAGS
    msgs = []
    for main, extra in ((tmain, ["--device", "cpu"]), (jmain, [])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        msgs.append(e.value.code)
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith(f"unknown {flag[2:].replace('-', ' ')} "
                              f"{name!r}; known: ")


def test_overrides_no_store_and_fp128_match_the_reference(cfgs, capsys,
                                                          tmp_path):
    """The model overrides, 128-bit keys, no state store (violations
    show the violating state), --keep-going and --max-violations."""
    tmain, jmain = _mains()
    argv = ["check", cfgs[0], "--no-symmetry", "--next", "NextAsyncCrash",
            "--max-terms", "3", "--max-restarts", "0", "--fp128",
            "--no-store", "--keep-going", "--max-violations", "2",
            "--invariant", "FirstCommit", "--max-depth", "15"] + FLAGS
    out = {}
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        path = tmp_path / f"{name}.json"
        rc, text, _err = _run(main, argv + extra +
                              ["--stats-json", str(path)], capsys)
        out[name] = (rc, text, json.loads(path.read_text()))
    got, want = out["port"], out["ref"]
    assert got[0] == want[0] == 1
    assert got[1].split("\n", 1)[1] == want[1].split("\n", 1)[1]
    assert got[1].count("(violating state; run without --no-store") == 2
    keys = ("distinct_states", "generated_states", "depth", "violations",
            "fp_bits", "levels_fused", "burst_dispatches",
            "burst_bailouts")
    assert {k: got[2][k] for k in keys} == {k: want[2][k] for k in keys}
    assert got[2]["fp_bits"] == 128 and got[2]["violations"] == 2


def test_pinned_cfg_reports_its_interior_states(capsys, tmp_path):
    """The tlc cfg with the upstream pin lines enabled: both CLIs'
    oracles and the port's engine give the same answer, with the 18
    interior states of the pinned prefix in the stats."""
    tmain, jmain = _mains()
    text = open("configs/tlc_membership/raft.cfg").read()
    text = text.replace("\nCONSTRAINTS\n", "\nCONSTRAINTS\n"
                        "    CommitWhenConcurrentLeaders_unique\n")
    text = text.replace("\nINVARIANTS\n", "\nINVARIANTS\n"
                        "    CommitWhenConcurrentLeaders\n")
    text += ("\nACTION_CONSTRAINTS\n"
             "    CommitWhenConcurrentLeaders_action_constraint\n")
    (tmp_path / "raft.cfg").write_text(text)
    shutil.copy("configs/tlc_membership/raft.tla", tmp_path)
    argv = ["check", str(tmp_path / "raft.cfg"), "--max-log-length", "1",
            "--max-timeouts", "1", "--max-restarts", "0",
            "--max-client-requests", "2", "--max-terms", "4",
            "--max-depth", "3", "--keep-going"]
    got = _run(tmain, argv + ["--engine", "oracle"], capsys)
    want = _run(jmain, argv + ["--engine", "oracle"], capsys)
    assert got[0] == want[0] == 0
    stats = json.loads(got[1])
    _same_stats(stats, json.loads(want[1]))
    assert stats["pin_interior_states"] == 18
    rc, text, _err = _run(tmain, argv + ["--device", "cpu", "--chunk",
                                         "256", "--verbose"], capsys)
    assert rc == 0 and text.startswith("burst: 3 levels to depth 3")
    eng = json.loads(text.strip().splitlines()[-1])
    assert {k: eng[k] for k in ("distinct_states", "generated_states",
                                "depth", "violations",
                                "pin_interior_states")} == \
        {k: stats[k] for k in ("distinct_states", "generated_states",
                               "depth", "violations",
                               "pin_interior_states")}
