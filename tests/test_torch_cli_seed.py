"""The two-command punctuated search through both CLIs in this process,
on the micro cfg of ``test_torch_cli.py``: ``trace --target
FirstBecomeLeader --emit-seed`` must print the reference's witness and
write the reference's seed file (key by key, the non-VIEW lanes
included); ``check --seed-trace`` from that file with ``--invariant
FirstCommit --action-constraint ... --keep-going --max-violations 2``
must give the reference's exit code, violation text and stats values.
One reference engine compile per command.
"""

import json

import torch

from test_torch_cli import FLAGS, _run, cfgs  # noqa: F401

torch.set_num_threads(1)

ACT = "CommitWhenConcurrentLeaders_action_constraint"
KEYS = ("distinct_states", "generated_states", "depth", "violations",
        "fp_bits", "levels_fused", "burst_dispatches", "burst_bailouts")


def _no_seconds(text):
    head, rest = text.split(" states explored, ", 1)
    return head + rest.split("s):", 1)[1]


def test_emit_seed_then_seed_trace_match_the_reference(cfgs, capsys,
                                                       tmp_path):
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    seeds = {}
    runs = {}
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        seed = tmp_path / f"{name}.seed.json"
        runs[name] = _run(main, ["trace", cfgs[0], "--target",
                                 "FirstBecomeLeader", "--emit-seed",
                                 str(seed)] + FLAGS + extra, capsys)
        seeds[name] = json.loads(seed.read_text())
    got, want = runs["port"], runs["ref"]
    assert got[0] == want[0] == 0
    assert _no_seconds(got[1]) == _no_seconds(want[1])
    assert got[2] == f"seed written to {tmp_path / 'port.seed.json'}\n"
    assert want[2] == f"seed written to {tmp_path / 'ref.seed.json'}\n"
    assert sorted(seeds["port"]) == sorted(seeds["ref"]) == \
        ["hist", "nonview", "state"]
    for k in seeds["ref"]:
        assert seeds["port"][k] == seeds["ref"][k], k
    assert sorted(seeds["port"]["nonview"]) == \
        ["ctr", "feat", "restarted", "timeout"]
    # the second command, from the reference's seed file on both sides
    argv = ["check", cfgs[0], "--seed-trace", str(tmp_path /
                                                  "ref.seed.json"),
            "--invariant", "FirstCommit", "--action-constraint", ACT,
            "--keep-going", "--max-violations", "2", "--max-depth", "8"]
    out = {}
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        path = tmp_path / f"{name}.stats.json"
        rc, text, _err = _run(main, argv + FLAGS + extra +
                              ["--stats-json", str(path)], capsys)
        out[name] = (rc, text, json.loads(path.read_text()))
    got, want = out["port"], out["ref"]
    assert got[0] == want[0] == 1
    assert got[1].split("\n", 1)[1] == want[1].split("\n", 1)[1]
    assert got[1].count("\nViolation ") == 2
    assert {k: got[2][k] for k in KEYS} == {k: want[2][k] for k in KEYS}
    assert got[2]["violations"] == 2 and "pin_interior_states" not in got[2]
