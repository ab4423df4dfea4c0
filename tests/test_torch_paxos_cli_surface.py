"""``--spec paxos``'s surface against the reference CLI and parser, with
no engine compiled: the TLC .cfg and JSON constant forms (the same
``PaxosConfig`` as the reference's, and its ``CfgError`` messages word
for word), the oracle engine through both CLIs, the refusals of the
raft-only flags, of constraints and action constraints, unknown
invariants and targets, a seed file of the other spec, a raft run with
no cfg, and ``--fam-cap-density`` against paxos's families."""

import json

import pytest
import torch

from test_torch_cli import _run, cfgs  # noqa: F401
from test_torch_cli_surface import _mains, _same_stats

torch.set_num_threads(1)

PAXOS_CFG = """\\* a paxos model
CONSTANTS
  a1 = 1
  a2 = 2
  a3 = 3
  Acceptor = {a1, a2, a3}
  Ballot = {0, 1}
  Value = {0, 1}
  Instances = 2
SYMMETRY perms
INIT Init
NEXT Next
INVARIANTS
  Agreement
  Validity
"""
BAD_CFGS = {
    "const": "  Frob = {a1}\n", "quorum": "  Quorum = {a1}\n",
    "dense": "  Ballot = {1, 3}\n", "inv": "INVARIANT NotAThing\n",
    "constraint": "CONSTRAINT Bounded\n", "next": "NEXT NextAsync\n"}
BAD_JSON = {"key": {"frob": 1}, "bool": {"symmetry": 1},
            "int": {"ballots": "2"}, "range": {"acceptors": 9},
            "inv": {"invariants": ["Nope"]}, "list": [1]}


def _parsers():
    from raft_tla_tpu.cfg import parser as jp
    from raft_tla_tpu_torch.cfg import parser as tp
    return tp, jp


def test_cfg_and_json_forms(tmp_path):
    tp, jp = _parsers()
    p = tmp_path / "paxos.cfg"
    p.write_text(PAXOS_CFG)
    got, want = tp.load_paxos_model(str(p)), jp.load_paxos_model(str(p))
    assert repr(got) == repr(want)
    assert (got.n_servers, got.n_ballots, got.n_values, got.n_instances,
            got.symmetry) == (3, 2, 2, 2, True)
    obj = {"acceptors": 3, "ballots": 2, "values": 2, "instances": 2,
           "symmetry": True, "invariants": ["Agreement", "Validity"]}
    assert got == tp.paxos_config_from_obj(obj, where="json")
    assert repr(tp.paxos_config_from_obj(obj)) == \
        repr(jp.paxos_config_from_obj(obj))


@pytest.mark.parametrize("bad", sorted(BAD_CFGS))
def test_cfg_errors_are_the_reference_s(bad, tmp_path):
    tp, jp = _parsers()
    p = tmp_path / "bad.cfg"
    p.write_text("CONSTANTS\n  a1 = 1\n  Acceptor = {a1}\n" + BAD_CFGS[bad])
    with pytest.raises(tp.CfgError) as got:
        tp.load_paxos_model(str(p))
    with pytest.raises(jp.CfgError) as want:
        jp.load_paxos_model(str(p))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", sorted(BAD_JSON))
def test_json_errors_are_the_reference_s(bad):
    tp, jp = _parsers()
    with pytest.raises(tp.CfgError) as got:
        tp.paxos_config_from_obj(BAD_JSON[bad], where="m.json")
    with pytest.raises(jp.CfgError) as want:
        jp.paxos_config_from_obj(BAD_JSON[bad], where="m.json")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("form", ["cfg", "json", "default"])
def test_oracle_check_through_both_clis(form, capsys, tmp_path):
    """The oracle engine on each model form prints the reference's stats
    line and violation text."""
    path = {"cfg": tmp_path / "m.cfg", "json": tmp_path / "m.json",
            "default": None}[form]
    if form == "cfg":
        path.write_text("CONSTANTS\n  a1 = 1\n  a2 = 2\n"
                        "  Acceptor = {a1, a2}\n  Ballot = {0, 1}\n"
                        "  Value = {0}\nINVARIANT ValueChosen\n")
    elif form == "json":
        path.write_text(json.dumps({"acceptors": 2, "ballots": 2,
                                    "values": 1, "symmetry": False,
                                    "invariants": ["ValueChosen"]}))
    argv = ["check", "--spec", "paxos", "--engine", "oracle",
            "--keep-going"] + ([str(path)] if path else
                               ["--invariant", "Preempted"])
    tmain, jmain = _mains()
    got = _run(tmain, argv + ["--device", "cpu"], capsys)
    want = _run(jmain, argv, capsys)
    assert got[0] == want[0] == 1
    lines = [json.loads(t[1].split("\n", 1)[0]) for t in (got, want)]
    _same_stats(*lines)
    assert list(lines[0]) == list(lines[1])
    assert got[1].split("\n", 1)[1] == want[1].split("\n", 1)[1]


REFUSED = {
    "raft_only": ["--max-terms", "3", "--init-servers", "2"],
    "next": ["--next", "NextAsync"],
    "constraint": ["--constraint", "BoundedTerms"],
    "action": ["--action-constraint", "X"],
    "invariant": ["--invariant", "Nope"],
    "range": ["--servers", "9"],
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_are_the_reference_s(name):
    tmain, jmain = _mains()
    argv = ["check", "--spec", "paxos"] + REFUSED[name]
    with pytest.raises(SystemExit) as got:
        tmain(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jmain(argv)
    assert isinstance(got.value.code, str)
    assert got.value.code == want.value.code


def test_raft_needs_a_cfg():
    tmain, jmain = _mains()
    for argv in (["check"], ["trace", "--target", "FirstCommit"]):
        with pytest.raises(SystemExit) as got:
            tmain(argv + ["--device", "cpu"])
        with pytest.raises(SystemExit) as want:
            jmain(argv)
        assert got.value.code == want.value.code
        assert "required for --spec raft" in got.value.code


@pytest.mark.parametrize("cmd", ["trace", "simulate"])
def test_unknown_target(cmd, capsys):
    tmain, jmain = _mains()
    argv = [cmd, "--spec", "paxos", "--target", "FirstCommit"]
    got = _run(tmain, argv + ["--device", "cpu"], capsys)
    want = _run(jmain, argv, capsys)
    assert got[0] == want[0] == 2
    assert got[2] == want[2]
    assert "known scenario properties: ValueChosen, TwoBallots, " \
        "Preempted" in got[2]


def test_seed_of_the_other_spec_is_refused(cfgs, capsys,  # noqa: F811
                                           tmp_path):
    """A paxos seed handed to a raft check and a raft seed to a paxos
    check are refused with the reference's message."""
    tmain, jmain = _mains()
    pseed, rseed = tmp_path / "paxos.seed", tmp_path / "raft.seed"
    assert _run(tmain, ["trace", "--spec", "paxos", "--target",
                        "ValueChosen", "--engine", "oracle",
                        "--emit-seed", str(pseed), "--device", "cpu"],
                capsys)[0] == 0
    assert _run(tmain, ["trace", cfgs[0], "--target", "FirstBecomeLeader",
                        "--engine", "oracle", "--max-timeouts", "1",
                        "--emit-seed", str(rseed), "--device", "cpu"],
                capsys)[0] == 0
    for argv in (["check", cfgs[0], "--seed-trace", str(pseed),
                  "--max-timeouts", "1"],
                 ["check", "--spec", "paxos", "--seed-trace", str(rseed)]):
        with pytest.raises(SystemExit) as got:
            tmain(argv + ["--device", "cpu"])
        with pytest.raises(SystemExit) as want:
            jmain(argv)
        assert got.value.code == want.value.code
        assert "re-emit the seed with the matching --spec" in got.value.code


def test_fam_cap_density_names_paxos_families(capsys):
    tmain, jmain = _mains()
    argv = ["check", "--spec", "paxos", "--fam-cap-density", "Receive=2"]
    got = _run(tmain, argv + ["--device", "cpu"], capsys)
    want = _run(jmain, argv, capsys)
    assert got[0] == want[0] == 2
    assert got[2] == want[2]
    assert "known families: Phase1a, Phase1b, Phase2a, Phase2b" in got[2]
    rc, text, _err = _run(tmain, ["check", "--spec", "paxos",
                                  "--fam-cap-density", "Phase1b=1",
                                  "--chunk", "64", "--device", "cpu"],
                          capsys)
    assert rc == 0 and json.loads(text.split("\n", 1)[0])[
        "distinct_states"] == 857
