"""The port's fault-tolerance layer (``raft_tla_tpu_torch/resil``) on
the CPU, mirroring tests/test_resil.py: the chaos grammar and its
schedules (held equal to the reference's), the backoff bounds, the
checkpoint chain's rotation with a torn head falling back to ``.1``,
the clear error for a truncated file, and supervised runs with faults
at every level boundary (and at an archive write) that land on the
unfaulted answer, with the trace.
"""

import os
import warnings

import pytest
import torch

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.bfs import CheckpointError, Engine
from raft_tla_tpu_torch.resil import chaos
from raft_tla_tpu_torch.resil.chaos import (ChaosSchedule, ChaosSpecError,
                                            InjectedFault)
from raft_tla_tpu_torch.resil.ckpt_chain import (ChainWarning,
                                                 chain_candidates,
                                                 latest_valid, verify)
from raft_tla_tpu_torch.resil.supervisor import (RetryExhausted,
                                                 backoff_delay,
                                                 supervised_check)

torch.set_num_threads(1)

MICRO = ModelConfig(
    n_servers=2, init_servers=(0, 1), values=(1,),
    next_family=NEXT_ASYNC, symmetry=True, max_inflight_override=4,
    bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                       max_client_requests=1))


def _same(res, ref):
    assert (res.distinct_states, res.generated_states, res.depth) == \
        (ref.distinct_states, ref.generated_states, ref.depth)
    assert res.level_sizes == ref.level_sizes
    assert [(v.invariant, v.state_id) for v in res.violations] == \
        [(v.invariant, v.state_id) for v in ref.violations]


def _labels(trace):
    return [label for label, _sv in trace]


@pytest.fixture(autouse=True)
def _chaos_clean():
    """Every test leaves the process-global schedule uninstalled."""
    yield
    chaos.uninstall()


@pytest.fixture(scope="module")
def classic():
    # burst_levels=2 so checkpoint chains build up (one 16-level burst
    # would cover the whole micro prefix in one save)
    return Engine(MICRO, chunk=64, burst_levels=2, device="cpu")


@pytest.fixture(scope="module")
def classic_ref(classic):
    """One unfaulted depth-8 run (counts + the last state's trace)."""
    ref = classic.check(max_depth=8)
    return ref, _labels(classic.trace(ref.distinct_states - 1))


def test_chaos_spec_parse_and_determinism():
    s = ChaosSchedule("seed=3;dispatch:at=2,4;archive:every=3;"
                      "host_table:p=0.5")
    assert [s.fire("dispatch") for _ in range(5)] == \
        [False, True, False, True, False]
    assert [s.fire("archive") for _ in range(6)] == \
        [False, False, True, False, False, True]
    # p= clauses are a pure function of (seed, site, hit)
    s1 = ChaosSchedule("seed=7;host_table:p=0.5")
    s2 = ChaosSchedule("seed=7;host_table:p=0.5")
    assert [s1.fire("host_table") for _ in range(32)] == \
        [s2.fire("host_table") for _ in range(32)]
    # unknown sites/rules/values error by name
    for bad, msg in [("nope:at=1", "unknown site"),
                     ("dispatch:often=2", "unknown rule"),
                     ("dispatch:at=0", "bad at= value"),
                     ("dispatch", "not 'site:rule'"),
                     ("seed=x;dispatch:at=1", "bad seed"),
                     ("seed=4", "declares no sites"),
                     ("dispatch:at=1;dispatch:at=2", "declared twice")]:
        with pytest.raises(ChaosSpecError, match=msg):
            ChaosSchedule(bad)
    # point() raises InjectedFault with site + hit attribution
    s3 = ChaosSchedule("dispatch:at=2")
    s3.point("dispatch")
    with pytest.raises(InjectedFault) as ei:
        s3.point("dispatch")
    assert ei.value.site == "dispatch" and ei.value.hit == 2
    assert s3.fired == [("dispatch", 2)]
    # uninstalled global points are no-ops
    chaos.uninstall()
    chaos.chaos_point("dispatch")
    assert chaos.chaos_fire("ckpt_torn") is False


@pytest.mark.parametrize("spec", [
    "seed=7;host_table:p=0.5", "seed=11;dispatch:p=0.25;archive:every=4",
    "ckpt_torn:at=1,3;wave_kill:p=0.9;intake:every=2"])
def test_chaos_schedules_equal_the_reference(spec):
    """The same spec fires on the same hits in both packages, and the
    grammar knows the same seven sites."""
    from raft_tla_tpu.resil import chaos as ref
    assert chaos.KNOWN_SITES == ref.KNOWN_SITES
    got, want = ChaosSchedule(spec), ref.ChaosSchedule(spec)
    for _ in range(64):
        for site in chaos.KNOWN_SITES:
            assert got.fire(site) == want.fire(site)
    assert got.fired == want.fired


def test_backoff_delay_bounded_and_deterministic():
    from raft_tla_tpu.resil.supervisor import backoff_delay as ref
    d = [backoff_delay(k, 1.0, 8.0) for k in range(6)]
    assert d == [backoff_delay(k, 1.0, 8.0) for k in range(6)]
    assert d == [ref(k, 1.0, 8.0) for k in range(6)]
    base = [min(1.0 * 2.0 ** k, 8.0) for k in range(6)]
    for got, b in zip(d, base):
        assert b <= got <= b * 1.25


def test_ckpt_chain_rotation_and_torn_head_fallback(classic, classic_ref,
                                                    tmp_path):
    ref, _ref_trace = classic_ref
    ck = str(tmp_path / "run.ckpt")
    classic.ckpt_keep = 3
    classic.check(max_depth=6, checkpoint_path=ck, checkpoint_every=1)
    names = sorted(os.listdir(tmp_path))
    assert "run.ckpt" in names and "run.ckpt.1" in names
    assert "run.ckpt.sum" in names and "run.ckpt.1.sum" in names
    assert verify(ck) == (True, "ok")
    assert latest_valid(ck) == ck
    assert chain_candidates(ck)[0] == ck
    # tear the head: resume falls back to .1 with a named warning and
    # still lands bit-exact
    with open(ck, "r+b") as fh:
        fh.truncate(os.path.getsize(ck) // 2)
    assert verify(ck)[0] is False
    assert latest_valid(ck) == ck + ".1"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        resumed = classic.check(max_depth=8, resume_from=ck)
    assert any(issubclass(x.category, ChainWarning) and
               "integrity" in str(x.message) for x in w)
    _same(resumed, ref)
    assert sum(len(p) for p in classic._parents) == ref.distinct_states
    # corrupt bytes (same length) are caught by the sha256, not size
    with open(ck + ".1", "r+b") as fh:
        size = os.path.getsize(ck + ".1")
        fh.seek(size // 2)
        fh.write(b"\xff" * 32)
    assert verify(ck + ".1") == (False, "sha256 mismatch "
                                 "(corrupt bytes)")
    classic.ckpt_keep = 2


def test_ckpt_read_truncated_yields_clear_error(classic, tmp_path):
    """Integrity is checked before the cfg compare: a truncated file,
    with or without its sidecar, is a clear CheckpointError."""
    ck = str(tmp_path / "solo.ckpt")
    classic.ckpt_keep = 1            # no chain: nothing to fall back to
    classic.check(max_depth=4, checkpoint_path=ck)
    with open(ck, "r+b") as fh:
        fh.truncate(os.path.getsize(ck) // 3)
    with pytest.raises(CheckpointError, match="no valid checkpoint"):
        classic.check(resume_from=ck)
    # no sidecar: the structural load catches the torn zip container
    os.remove(ck + ".sum")
    with pytest.raises(CheckpointError, match="no valid checkpoint"):
        classic.check(resume_from=ck)
    with pytest.raises(CheckpointError, match="no such checkpoint"):
        classic.check(resume_from=str(tmp_path / "missing.ckpt"))
    classic.ckpt_keep = 2


def test_supervised_chaos_every_boundary(classic, classic_ref, tmp_path):
    """Dispatch faults at every level boundary (every 2nd loop hit: the
    other hits are the post-resume re-entries) plus one torn and one
    corrupt checkpoint head, all recovered by the supervised runner,
    bit-exact against the unfaulted run."""
    ck = str(tmp_path / "sup.ckpt")
    ref, ref_trace = classic_ref
    sched = chaos.install(
        "dispatch:every=2;ckpt_torn:at=2;ckpt_corrupt:at=3")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res, eng, attempts = supervised_check(
            lambda: classic, retries=50, backoff=0.01,
            checkpoint_path=ck, checkpoint_every=1, max_depth=8,
            sleep=lambda s: None, reinit=False)
    assert attempts > 1
    assert any(site == "dispatch" for site, _ in sched.fired)
    assert any(site == "ckpt_torn" for site, _ in sched.fired)
    # the retry after the torn head resumed from .1, and said so
    assert any(issubclass(x.category, ChainWarning) for x in w)
    _same(res, ref)
    assert _labels(eng.trace(res.distinct_states - 1)) == ref_trace
    chaos.uninstall()
    # exhaustion is a named error, not an infinite loop (no checkpoint:
    # every-dispatch faults allow no progress at all)
    chaos.install("dispatch:every=1")
    with pytest.raises(RetryExhausted, match="after 3 attempt"):
        supervised_check(lambda: classic, retries=2, backoff=0.01,
                         max_depth=8, sleep=lambda s: None, reinit=False)


def test_supervised_fresh_engines_with_a_disk_archive(classic_ref,
                                                      tmp_path):
    """A fresh engine per attempt with the release between attempts
    (``reinit``), the archives on disk: dispatch faults and an
    archive-write fault recover through resume (reattach + truncate),
    bit-exact, the trace read from the memmaps."""
    ref, ref_trace = classic_ref
    ck = str(tmp_path / "disk.ckpt")
    arch = str(tmp_path / "arch")
    engines = []

    def make_engine():
        engines.append(Engine(MICRO, chunk=64, burst_levels=2,
                              archive_dir=arch, device="cpu"))
        return engines[-1]
    sched = chaos.install("dispatch:at=3,7;archive:at=5")
    res, eng, attempts = supervised_check(
        make_engine, retries=5, backoff=0.01, checkpoint_path=ck,
        checkpoint_every=1, max_depth=8, sleep=lambda s: None)
    # one attempt per fault, plus the one that finished
    assert {site for site, _ in sched.fired} == {"dispatch", "archive"}
    assert attempts == len(engines) == len(sched.fired) + 1
    _same(res, ref)
    assert eng._arch is not None and eng._parents == []
    assert eng._arch.total_rows == ref.distinct_states
    assert _labels(eng.trace(res.distinct_states - 1)) == ref_trace


def test_misconfiguration_is_not_retried(classic, tmp_path):
    """A CheckpointError (a ValueError) propagates on the first attempt:
    it means misconfiguration, not weather."""
    ck = str(tmp_path / "other.ckpt")
    Engine(MICRO.with_(symmetry=False), chunk=64,
           device="cpu").check(max_depth=3, checkpoint_path=ck)
    calls = []

    def make_engine():
        calls.append(1)
        return classic
    with pytest.raises(CheckpointError, match="different model config"):
        supervised_check(make_engine, retries=3, resume_from=ck,
                         sleep=lambda s: None)
    assert len(calls) == 1
