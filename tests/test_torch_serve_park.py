"""The wave scheduler's rules on the port: ``wave_yield`` parking, a
``wave_kill`` chaos kill resumed from the wave state, solo fallbacks
(roots past the table, a level past the ring, seeded jobs) with the
reference's reason texts, the dedup of equal cache keys, priority order
and the result cache.  Every answer is held against an uninterrupted
run and the solo ``Engine`` (``test_torch_serve_wave_paxos.py`` resumes
wave state the JAX package wrote)."""

import os

import pytest
import torch

torch.set_num_threads(1)

from raft_tla_tpu_torch.config import Bounds, ModelConfig  # noqa: E402
from raft_tla_tpu_torch.engine.bfs import Engine  # noqa: E402
from raft_tla_tpu_torch.resil import chaos  # noqa: E402
from raft_tla_tpu_torch.serve import (Job, ResultCache,  # noqa: E402
                                      WaveScheduler, run_jobs)
from raft_tla_tpu_torch.serve import batch as sbatch  # noqa: E402
from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig  # noqa: E402

TIMING = ("seconds", "states_per_sec", "wait_s", "service_s")


def _micro(mt=1, mcr=1, M=ModelConfig, B=Bounds):
    return M(n_servers=2, init_servers=(0, 1), values=(1,),
             next_family="NextAsync", symmetry=True,
             max_inflight_override=4,
             bounds=B.make(max_log_length=1, max_timeouts=mt,
                           max_client_requests=mcr))


def _jobs():
    return [Job(_micro(), max_depth=10, label="m10"),
            Job(_micro(mcr=2), max_depth=12, label="c12"),
            Job(_micro(mt=2), max_depth=11, label="t11",
                store_states=False)]


def _untimed(o, drop=()):
    return {k: v for k, v in o.report.items()
            if k not in TIMING and k not in drop}


@pytest.fixture(scope="module")
def plain():
    return run_jobs(_jobs(), device="cpu")


def test_wave_yield_parks_and_answers_as_one_wave(plain):
    rep = run_jobs(_jobs(), device="cpu", max_wave=2, wave_yield=1)
    assert rep.meta["parked_waves"] > 0
    assert rep.meta["batch_dispatches"] > plain.meta["batch_dispatches"]
    assert [_untimed(o) for o in rep.outcomes] == \
        [_untimed(o) for o in plain.outcomes]


def test_wave_kill_resumes_mid_bfs_bit_exact(plain, tmp_path):
    d = str(tmp_path / "ws")
    chaos.install("wave_kill:at=1")
    try:
        with pytest.raises(chaos.InjectedFault):
            run_jobs(_jobs(), device="cpu", wave_state=d)
    finally:
        chaos.uninstall()
    assert len([f for f in os.listdir(d) if f.endswith(".wave.npz")]) == 3
    rep = run_jobs(_jobs(), device="cpu", wave_state=d)
    assert rep.meta["resumed_jobs"] == 3
    for o, p in zip(rep.outcomes, plain.outcomes):
        assert o.report["status_reason"] == "resumed from wave state"
        assert _untimed(o, ("status_reason",)) == _untimed(p)
    # answered jobs retire their carries
    assert not [f for f in os.listdir(d) if f.endswith(".wave.npz")]
    # the resumed job's archives still give its witness traces
    gid = plain.outcomes[0].res.distinct_states - 1
    assert [lbl for lbl, _ in rep.outcomes[0].trace(gid)] == \
        [lbl for lbl, _ in plain.outcomes[0].trace(gid)]


def test_fallbacks_keep_the_reference_reasons_and_are_exact():
    seed_of = Engine(_micro(), device="cpu")
    roots, _rk, _p = seed_of._dedup_roots()
    seed = {k: v[0] for k, v in roots.items()}
    jobs = [Job(_micro(mcr=2), max_depth=12, label="level"),
            Job(_micro(), max_depth=6, label="seeded",
                seed_states=[seed]),
            Job(_micro(), max_depth=3, label="fits")]
    rep = run_jobs(jobs, device="cpu",
                   bucket_overrides={"chunk": 16})
    got = {o.job.label: o for o in rep.outcomes}
    assert got["level"].status == "fallback"
    assert got["level"].report["status_reason"] == (
        "burst bailed (per-job ring or table overflow) — re-run "
        "sequentially")
    assert got["seeded"].report["status_reason"] == \
        "seeded/prefix-pinned jobs run sequentially"
    assert got["fits"].status == "done"
    assert rep.meta["fallback_jobs"] == 2
    for o in rep.outcomes:
        solo = Engine(o.job.cfg, device="cpu").check(
            max_depth=o.job.max_depth, seed_states=o.job.seed_states,
            stop_on_violation=True)
        assert (o.res.distinct_states, o.res.level_sizes) == \
            (solo.distinct_states, solo.level_sizes)
    # roots past the bucket's table: admission refuses them
    rep = run_jobs([Job(_micro(), max_depth=2, label="roots")],
                   device="cpu", bucket_overrides={"vcap": 2})
    assert rep.outcomes[0].report["status_reason"] == \
        "1 root states exceed the bucket ring/table"


def test_equal_keys_dedup_and_the_result_cache(plain, tmp_path):
    cache = ResultCache(str(tmp_path / "c"))
    jobs = _jobs() + [Job(_micro(), max_depth=10, label="again")]
    rep = run_jobs(jobs, device="cpu", cache=cache)
    assert rep.meta["deduped"] == 1
    dup = rep.outcomes[3]
    assert dup.status == "cache_hit"
    assert dup.report["status_reason"] == \
        "duplicate of job 'm10' in this batch"
    assert dup.report["distinct_states"] == \
        plain.outcomes[0].report["distinct_states"]
    again = run_jobs(_jobs(), device="cpu", cache=cache)
    assert again.meta["cache_hits"] == 3
    assert again.meta["batch_dispatches"] == 0
    assert again.meta["engines_compiled"] == 0
    for o, p in zip(again.outcomes, plain.outcomes):
        assert o.status == "cache_hit"
        assert _untimed(o, ("status", "cache_key")) == \
            _untimed(p, ("status", "cache_key"))


def test_priority_orders_the_waves(monkeypatch):
    seen = []
    orig = sbatch.BucketEngine.run_wave

    def recorded(self, runs, *a, **kw):
        seen.append([r.job.label for r in runs])
        return orig(self, runs, *a, **kw)

    monkeypatch.setattr(sbatch.BucketEngine, "run_wave", recorded)
    jobs = [Job(_micro(), max_depth=2, label="low"),
            Job(_micro(), max_depth=3, label="high", priority=5),
            Job(_micro(), max_depth=4, label="mid", priority=1)]
    sch = WaveScheduler(device="cpu", max_wave=1)
    rep = sch.serve(jobs)
    assert seen == [["high"], ["mid"], ["low"]]
    assert [o.job.label for o in rep.outcomes] == ["low", "high", "mid"]
    # the scheduler keeps its bucket engine: a second serve compiles none
    assert sch.serve([Job(_micro(), max_depth=5)]).meta[
        "engines_compiled"] == 0


def test_mixed_specs_bucket_apart():
    rep = run_jobs([Job(_micro(), max_depth=3, label="r"),
                    Job(PaxosConfig(n_servers=2, n_ballots=1,
                                    n_values=1), label="p")],
                   device="cpu")
    assert rep.meta["buckets"] == 2 and rep.meta["engines_compiled"] == 2
    assert [o.status for o in rep.outcomes] == ["done", "done"]


def test_batched_body_reads_nothing_back(plain, monkeypatch):
    """The job-axis body, as captured on the card, reads nothing back
    and (past its first call per wave width, the warm-up) copies no host
    data in: the per-job gates are written before the replays."""
    from test_torch_chunk_step_ocap import NoHostRead
    from raft_tla_tpu_torch.engine import bfs
    twin = bfs.probe_claim_insert

    def paused_twin(*a):
        NoHostRead.paused = True
        try:
            return twin(*a)
        finally:
            NoHostRead.paused = False

    monkeypatch.setattr(bfs, "probe_claim_insert", paused_twin)
    body, seen, calls = bfs.Engine._burst_body, set(), [0]

    def guarded(self, st, r):
        if st is not None:          # a solo fallback's ring
            return body(self, st, r)
        calls[0] += 1
        with NoHostRead(warm_up=r.J not in seen):
            body(self, st, r)
        seen.add(r.J)

    monkeypatch.setattr(bfs.Engine, "_burst_body", guarded)
    rep = run_jobs(_jobs(), device="cpu")
    assert calls[0] > len(seen) > 0
    assert [_untimed(o) for o in rep.outcomes] == \
        [_untimed(o) for o in plain.outcomes]
