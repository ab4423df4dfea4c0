"""The spool intake (``serve/intake.py``) against the reference's: the
port's and the JAX package's ``SpoolIntake`` and ``StreamTail`` (both
pure Python) run side by side over the same fixture spools and leave the
same directory trees, file for file and byte for byte: the claimed,
rejected and skipped sets, the ``.reason`` texts, the torn-write grace,
``recover``, the done markers, the stream offsets and partial lines,
and the ``intake`` chaos site leaving the file in incoming/."""

import json
import os
import time

import pytest
import torch

torch.set_num_threads(1)

from raft_tla_tpu.resil import chaos as r_chaos  # noqa: E402
from raft_tla_tpu.serve import intake as RI  # noqa: E402

from raft_tla_tpu_torch.resil import chaos as p_chaos  # noqa: E402
from raft_tla_tpu_torch.serve import intake as PI  # noqa: E402

PAX_JOB = {"spec": "paxos",
           "config": {"acceptors": 2, "ballots": 2, "values": 1},
           "max_depth": 3, "label": "pax"}
RAFT_JOB = {"spec": "raft", "config": "configs/tlc_membership/raft.cfg",
            "max_depth": 4, "label": "r",
            "overrides": {"servers": 2, "next": "NextAsync"}}
PKGS = (("port", PI), ("ref", RI))


def _tree(root):
    """Every file under root: relative path -> bytes."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _write_raw(intake, name, data):
    with open(os.path.join(intake.dirs["incoming"], name), "wb") as fh:
        fh.write(data)


def _subs(subs):
    return [(s.name, s.job.label, s.job.cache_key(),
             os.path.basename(s.path), s.recovered) for s in subs]


def _fill(intake):
    intake.submit(PAX_JOB, "good")
    intake.submit(RAFT_JOB, "raft")
    _write_raw(intake, "bare", (json.dumps(PAX_JOB) + "\n").encode())
    _write_raw(intake, "garbage.json", b"{not json\n")
    _write_raw(intake, "badkey.json",
               (json.dumps({"spec": "paxos", "bogus": 1}) + "\n").encode())
    _write_raw(intake, "nospec.json", b'{"config": "x"}\n')
    _write_raw(intake, "badpax.json",
               (json.dumps({"spec": "paxos", "config": {"acceptors": 0}})
                + "\n").encode())
    _write_raw(intake, "torn.json", b'{"spec": "paxos"')
    _write_raw(intake, "skip.json.tmp", b"x")
    _write_raw(intake, "skip.part", b"x")
    _write_raw(intake, ".hidden.json", b"x")


def test_poll_grace_and_done_equal_the_reference(tmp_path):
    intakes = {nm: mod.SpoolIntake(str(tmp_path / nm), grace_s=0.3)
               for nm, mod in PKGS}
    for it in intakes.values():
        _fill(it)
    got = {nm: it.poll() for nm, it in intakes.items()}
    (pc, pr), (rc, rr) = got["port"], got["ref"]
    assert _subs(pc) == _subs(rc)
    assert sorted(s.name for s in pc) == ["bare", "good", "raft"]
    assert pr == rr
    assert sorted(n for n, _ in pr) == ["badkey", "badpax", "garbage",
                                        "nospec"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    assert intakes["port"].counts() == intakes["ref"].counts() == {
        "incoming": 1, "claimed": 3, "rejected": 4, "results": 0,
        "done": 0}
    # the torn file rides its grace window, then quarantines by name
    time.sleep(0.35)
    got = {nm: it.poll() for nm, it in intakes.items()}
    assert got["port"] == got["ref"] == ([], [got["ref"][1][0]])
    name, reason = got["port"][1][0]
    assert name == "torn" and reason.startswith(
        "torn/incomplete job file (no trailing newline after 0.3s grace)")
    for it in intakes.values():
        it.write_result("good", {"status": "done", "label": "pax",
                                 "cache_key": "k", "violations": 0})
        it.mark_done("good", {"status": "done", "label": "pax",
                              "cache_key": "k"})
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    for nm, it in intakes.items():
        with pytest.raises(ValueError) as e:
            it.submit(PAX_JOB, ".dot")
        assert str(e.value) == "bad submission name '.dot'"


def test_recover_equals_the_reference(tmp_path):
    out = {}
    for nm, mod in PKGS:
        it = mod.SpoolIntake(str(tmp_path / nm), grace_s=0.0)
        it.submit(PAX_JOB, "inflight")
        it.submit(dict(PAX_JOB, label="fin"), "finished")
        it.submit(dict(PAX_JOB, label="old"), "retired")
        assert len(it.poll()[0]) == 3
        it.write_result("finished", {"status": "done", "label": "fin",
                                     "cache_key": "k2"})
        # a result with its marker whose claim survived a kill
        it.write_result("retired", {"status": "done", "label": "old",
                                    "cache_key": "k3"})
        with open(os.path.join(it.dirs["done"], "retired.json"),
                  "w") as fh:
            fh.write('{"name": "retired"}\n')
        with open(os.path.join(it.dirs["claimed"], "tampered.json"),
                  "w") as fh:
            fh.write("{broken\n")
        rec, rej = it.recover()
        rec2, _ = it.recover()
        out[nm] = (_subs(rec), rej, _subs(rec2))
    assert out["port"] == out["ref"]
    assert [s[0] for s in out["port"][0]] == ["inflight"]
    assert [n for n, _ in out["port"][1]] == ["tampered"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")


def test_stream_tail_equals_the_reference(tmp_path):
    stream = str(tmp_path / "jobs.jsonl")
    with open(stream, "w") as fh:
        fh.write(json.dumps(PAX_JOB) + "\n")
        fh.write("# a comment line\n\n")
        fh.write(json.dumps(dict(PAX_JOB, label="p2")) + "\n")
        fh.write('{"spec": "paxos"')
    tails = {nm: mod.StreamTail(stream, mod.SpoolIntake(
        str(tmp_path / nm))) for nm, mod in PKGS}
    assert [t.poll() for t in tails.values()] == [2, 2]
    assert [t.poll() for t in tails.values()] == [0, 0]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    with open(stream, "a") as fh:
        fh.write(', "label": "p3"}\n')
        fh.write(json.dumps(dict(PAX_JOB, label="p4")) + "\n")
        fh.write("{partial")
    assert [t.poll() for t in tails.values()] == [2, 2]
    assert tails["port"].offset == tails["ref"].offset
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    # a restarted tail resumes from the persisted offset
    again = {nm: mod.StreamTail(stream, tails[nm].intake)
             for nm, mod in PKGS}
    assert (again["port"].offset, again["port"].lineno) == \
        (again["ref"].offset, again["ref"].lineno) == \
        (tails["ref"].offset, 4)
    assert [t.poll() for t in again.values()] == [0, 0]
    claimed = {nm: t.intake.poll() for nm, t in again.items()}
    assert _subs(claimed["port"][0]) == _subs(claimed["ref"][0])
    assert [s.job.label for s in claimed["port"][0]] == \
        ["pax", "p2", "p3", "p4"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")


def test_intake_chaos_site_leaves_the_file_in_incoming(tmp_path):
    for nm, mod in PKGS:
        chaos = p_chaos if nm == "port" else r_chaos
        it = mod.SpoolIntake(str(tmp_path / nm))
        it.submit(PAX_JOB, "j1")
        chaos.install("intake:at=1")
        try:
            with pytest.raises(chaos.InjectedFault) as e:
                it.poll()
            assert e.value.site == "intake"
            assert os.listdir(it.dirs["claimed"]) == []
        finally:
            chaos.uninstall()
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    assert sorted(_tree(tmp_path / "port")) == ["incoming/j1.json"]
    got = {nm: mod.SpoolIntake(str(tmp_path / nm)).poll()
           for nm, mod in PKGS}
    assert _subs(got["port"][0]) == _subs(got["ref"][0])
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
