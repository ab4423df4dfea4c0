"""The port's ``check --spill`` surface against the reference CLI, both
in this process on the micro cfg of ``test_torch_cli.py``: the stats
line and ``--stats-json`` of a spill run held key for key
(``_same_stats``: every key, equal values apart from the timings), the
violation text after it, and the reference's refusals word for word
(``--resume-portable`` without ``--resume`` or without ``--spill``,
``--host-table`` without ``--spill``, ``--pjit`` with ``--spill``);
``--pjit`` is refused as not ported.  ``--resume-portable`` continues a
classic checkpoint on the spill engine (with the host table) to the
uninterrupted run's stats, and ``check --spill`` with no CUDA and no
``--device cpu`` raises.  Two reference spill compiles (burst on and
off)."""

import json

import pytest
import torch

from test_torch_cli import FLAGS, _run, cfgs  # noqa: F401
from test_torch_cli_surface import _same_stats

torch.set_num_threads(1)

SPILL = ["--spill", "--seg", "1024", "--max-depth", "16"]


def _mains():
    from raft_tla_tpu.cli import main as jmain
    from raft_tla_tpu_torch.cli import main as tmain
    return tmain, jmain


@pytest.mark.parametrize("burst", [[], ["--no-burst"]],
                         ids=["burst", "no-burst"])
def test_spill_stats_line_equals_the_reference(cfgs, capsys, tmp_path,
                                                burst):
    """With the burst on (the CLI's default) the burst counters
    ``levels_fused``, ``burst_dispatches`` and ``burst_bailouts`` are
    held against the reference's spill burst too."""
    tmain, jmain = _mains()
    argv = ["check", cfgs[1]] + SPILL + burst + FLAGS
    out = {}
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        path = tmp_path / f"{name}.json"
        rc, text, _err = _run(main, argv + extra +
                              ["--stats-json", str(path)], capsys)
        out[name] = (rc, text, path.read_text())
    got, want = out["port"], out["ref"]
    assert got[0] == want[0] == 1
    _same_stats(json.loads(got[1].split("\n", 1)[0]),
                json.loads(want[1].split("\n", 1)[0]))
    _same_stats(json.loads(got[2]), json.loads(want[2]))
    # compact, as the reference writes it
    assert "\n" not in got[2].strip() and ", " in got[2]
    assert list(json.loads(got[2])) == list(json.loads(want[2]))
    assert got[1].split("\n", 1)[1] == want[1].split("\n", 1)[1]
    assert "\nViolation 0: invariant FirstCommit\n" in got[1]
    stats = json.loads(got[2])
    assert (stats["levels_fused"] > 0) == (not burst), stats


@pytest.mark.parametrize("extra, msg", [
    (["--resume-portable"], "--resume-portable qualifies --resume: pass "
     "the checkpoint with --resume FILE"),
    (["--resume-portable", "--resume", "x.ckpt"],
     "--resume-portable re-partitions any engine family's checkpoint "
     "onto the spill or pjit engine: add --spill or --pjit"),
    (["--host-table"], "--host-table composes with the spill engine: add "
     "--spill"),
    (["--pjit", "--spill"], "--pjit and --spill are different engines; "
     "pick one"),
])
def test_refusals_equal_the_reference(cfgs, capsys, extra, msg):
    tmain, jmain = _mains()
    argv = ["check", cfgs[0]] + extra + FLAGS
    got = _run(tmain, argv + ["--device", "cpu"], capsys)
    want = _run(jmain, argv, capsys)
    assert got[0] == want[0] == 2
    assert got[2] == want[2] == msg + "\n"


def test_pjit_is_refused_as_not_ported(cfgs, capsys):
    tmain, _jmain = _mains()
    rc, _out, err = _run(tmain, ["check", cfgs[0], "--pjit", "--device",
                                 "cpu"] + FLAGS, capsys)
    assert rc == 2 and "not ported" in err


def test_resume_portable_continues_a_classic_checkpoint(cfgs, capsys,
                                                        tmp_path):
    """A classic checkpoint at depth 8, then ``--spill --host-table
    --resume-portable`` to depth 14 writing a spill checkpoint at 12,
    then a resume of that: the stats lines equal the uninterrupted
    classic run's (apart from the timings)."""
    tmain, _jmain = _mains()
    base = ["check", cfgs[0], "--device", "cpu", "--no-store",
            "--no-burst"] + FLAGS
    ck, ck2 = str(tmp_path / "c.ckpt"), str(tmp_path / "s.ckpt")
    rc, full, _e = _run(tmain, base + ["--max-depth", "14"], capsys)
    assert rc == 0
    assert _run(tmain, base + ["--max-depth", "8", "--checkpoint", ck,
                               "--checkpoint-every", "8"], capsys)[0] == 0
    spill = base + ["--spill", "--host-table", "--partitions", "2",
                    "--part-cap", "64", "--seg", "1024", "--max-depth", "14"]
    rc, text, err = _run(tmain, spill + [
        "--resume", ck, "--resume-portable", "--checkpoint", ck2,
        "--checkpoint-every", "12"], capsys)
    assert rc == 0, err
    rc2, text2, err2 = _run(tmain, spill + ["--resume", ck2], capsys)
    assert rc2 == 0, err2
    want = json.loads(full)
    for t in (text, text2):
        _same_stats(json.loads(t), want)
    bad = _run(tmain, spill + ["--resume", ck], capsys)
    assert bad[0] == 2 and bad[2].startswith(f"cannot resume from {ck}: ")


def test_check_spill_needs_cuda_unless_asked_for_the_cpu(cfgs):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    tmain, _jmain = _mains()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain(["check", cfgs[0], "--spill"] + FLAGS)
