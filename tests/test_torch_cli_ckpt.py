"""The checkpoint, resume and supervision flags of the port's CLI
against the reference CLI, both run in this process on micro cfgs:
the flags' refusals (their text and exit code 2, a bad or missing file
included), ``RetryExhausted`` with exit 3, ``check --checkpoint F`` in
one CLI then ``--resume F`` in the other giving the uninterrupted
run's stats line and violation text, and a supervised run under
``--chaos`` with a torn head giving the unfaulted answer.
"""

import json
import warnings

import pytest
import torch

from test_torch_cli import FLAGS, _run, cfgs  # noqa: F401

torch.set_num_threads(1)

# the stats that must agree across the two CLIs (the rest are the
# run's seconds, its rate, the device, and mode flags only one has)
KEYS = ("distinct_states", "generated_states", "depth", "violations",
        "dedup_hit_rate", "spec", "ir_fingerprint", "fp_bits",
        "expected_fp_collisions")
VIOL = ["--invariant", "FirstBecomeLeader", "--keep-going",
        "--max-violations", "3"]


def _mains():
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    return tmain, jmain


@pytest.fixture(autouse=True)
def _chaos_clean():
    """The reference CLI leaves its --chaos schedule installed."""
    yield
    from raft_tla_tpu.resil import chaos as ref
    from raft_tla_tpu_torch.resil import chaos
    ref.uninstall()
    chaos.uninstall()


def _stats(text):
    head, _, rest = text.partition("\n")
    stats = json.loads(head)
    return {k: stats[k] for k in KEYS}, rest


@pytest.fixture(scope="module")
def files(cfgs, tmp_path_factory):  # noqa: F811
    """A garbage file, and a checkpoint of another config (no symmetry)
    written by the port's CLI."""
    from raft_tla_tpu_torch.cli import main
    d = tmp_path_factory.mktemp("cli_ckpt")
    (d / "garbage.ckpt").write_bytes(b"not a checkpoint")
    other = str(d / "other.ckpt")
    assert main(["check", cfgs[0], "--no-symmetry", "--max-depth", "3",
                 "--checkpoint", other, "--checkpoint-every", "3",
                 "--device", "cpu"] + FLAGS) == 0
    return dict(dir=str(d), other=other)


REFUSALS = {
    "retries": ["--retries", "-1"],
    "backoff": ["--backoff", "0"],
    "ckpt-keep": ["--ckpt-keep", "0"],
    "chaos": ["--chaos", "nope:at=1"],
    "chaos-rule": ["--chaos", "dispatch:often=2"],
    "oracle": ["--engine", "oracle", "--checkpoint", "{d}/x.ckpt"],
    "seed-trace": ["--resume", "{d}/x.ckpt", "--seed-trace", "{d}/s.json"],
    "missing": ["--resume", "{d}/missing.ckpt"],
    "garbage": ["--resume", "{d}/garbage.ckpt"],
    "other-cfg": ["--resume", "{other}"],
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_equal_the_reference(cfgs, files, capsys,  # noqa: F811
                                      case):
    tmain, jmain = _mains()
    argv = ["check", cfgs[0]] + FLAGS + [
        a.format(d=files["dir"], other=files["other"])
        for a in REFUSALS[case]]
    want = _run(jmain, argv, capsys)
    got = _run(tmain, argv + ["--device", "cpu"], capsys)
    assert got[0] == want[0] == 2
    assert got[2] == want[2] and got[1] == want[1] == ""
    if case in ("missing", "garbage", "other-cfg"):
        assert got[2].startswith("cannot resume from ")


def test_retries_exhausted_exit_3(cfgs, capsys):  # noqa: F811
    tmain, jmain = _mains()
    argv = ["check", cfgs[0], "--chaos", "dispatch:every=1", "--retries",
            "1", "--backoff", "0.001", "--max-depth", "4"] + FLAGS
    want = _run(jmain, argv, capsys)
    got = _run(tmain, argv + ["--device", "cpu"], capsys)
    assert got[0] == want[0] == 3
    assert got[2] == want[2] == (
        "supervised run failed after 2 attempt(s); last error: "
        "chaos-injected fault at site 'dispatch' (hit #2)\n")


def test_checkpoint_in_one_cli_resumes_in_the_other(
        cfgs, tmp_path, capsys):  # noqa: F811
    tmain, jmain = _mains()
    base = ["check", cfgs[0]] + FLAGS + VIOL
    port = base + ["--device", "cpu"]
    full = _run(tmain, port + ["--max-depth", "10"], capsys)
    assert full[0] == 1
    want, want_text = _stats(full[1])
    assert want["violations"] == 3
    # the reference writes, the port resumes
    ck = str(tmp_path / "ref.ckpt")
    assert _run(jmain, base + ["--max-depth", "6", "--checkpoint", ck,
                               "--checkpoint-every", "3"], capsys)[0] == 0
    got = _run(tmain, port + ["--max-depth", "10", "--resume", ck], capsys)
    assert got[0] == 1 and _stats(got[1]) == (want, want_text)
    # the port writes, the reference resumes
    ck = str(tmp_path / "port.ckpt")
    assert _run(tmain, port + ["--max-depth", "6", "--checkpoint", ck,
                               "--checkpoint-every", "3"], capsys)[0] == 0
    got = _run(jmain, base + ["--max-depth", "10", "--resume", ck], capsys)
    assert got[0] == 1 and _stats(got[1]) == (want, want_text)


def test_supervised_chaos_gives_the_unfaulted_answer(
        cfgs, tmp_path, capsys):  # noqa: F811
    """Dispatch faults at every other loop entry and a torn second
    checkpoint head: the run resumes from ``.1`` with a ChainWarning and
    prints the unfaulted stats and violations."""
    from raft_tla_tpu_torch.resil.ckpt_chain import ChainWarning
    tmain, _jmain = _mains()
    port = ["check", cfgs[0]] + FLAGS + VIOL + ["--device", "cpu",
                                                "--max-depth", "10",
                                                "--no-burst"]
    want = _stats(_run(tmain, port, capsys)[1])
    ck = str(tmp_path / "sup.ckpt")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _run(tmain, port + [
            "--chaos", "dispatch:every=3;ckpt_torn:at=2", "--retries", "20",
            "--backoff", "0.001", "--checkpoint", ck,
            "--checkpoint-every", "1"], capsys)
    assert got[0] == 1 and _stats(got[1]) == want
    assert any(issubclass(x.category, ChainWarning) and
               "sup.ckpt: checkpoint failed integrity validation (torn "
               "write" in str(x.message) for x in w)
