"""A batched wave of raft jobs of different bounds in one bucket, through
``python -m raft_tla_tpu_torch batch --device cpu`` in-process, held
exactly against the JAX package's ``run_jobs`` (every report key but the
timing keys), the port's solo ``Engine`` and the oracle (counts, level
sizes, violation ids, witness traces), with each job's visited table
equal, as a key set, to the fingerprints of its reachable states."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from conftest import cached_explore  # noqa: E402

from raft_tla_tpu.serve import load_jobs as r_load_jobs  # noqa: E402
from raft_tla_tpu.serve import run_jobs as r_run_jobs  # noqa: E402

from raft_tla_tpu_torch.cli import main as port_main  # noqa: E402
from raft_tla_tpu_torch.convert import rows_to_torch, words_to_numpy  # noqa: E402,E501
from raft_tla_tpu_torch.engine.bfs import Engine  # noqa: E402
from raft_tla_tpu_torch.serve import WaveScheduler, load_jobs  # noqa: E402

TIMING = ("seconds", "states_per_sec", "wait_s", "service_s")
MICRO = {"servers": 2, "values": [1], "max_inflight": 4,
         "next": "NextAsync"}


def _job(label, mll, mt, mcr, **kw):
    o = {"spec": "raft", "config": "configs/tlc_membership/raft.cfg",
         "label": label, "overrides": dict(MICRO, bounds={
             "max_log_length": mll, "max_timeouts": mt,
             "max_client_requests": mcr})}
    o.update(kw)
    return o


JOBS = [_job("a", 1, 1, 1, max_depth=9),
        _job("b", 2, 1, 2, max_depth=8),
        _job("c", 1, 2, 2, max_depth=7, store=False)]


def _untimed(rep):
    return {k: v for k, v in rep.items() if k not in TIMING}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wave")
    path = d / "jobs.jsonl"
    path.write_text("\n".join(json.dumps(j) for j in JOBS) + "\n")
    out = d / "stats.json"
    rc = port_main(["batch", "--jobs", str(path), "--device", "cpu",
                    "--stats-json", str(out)])
    port = json.loads(out.read_text())
    # the reference's first run_jobs in a process raises (its barrier
    # batching rule, under jax 0.9.0); one caught call gets past it.
    # Its waves run on one device, as the port's (the test run's
    # eight CPU devices would make "auto" a mesh wave)
    try:
        r_run_jobs(r_load_jobs(str(path))[:1], wave_mesh="off")
    except TypeError:
        pass
    ref = r_run_jobs(r_load_jobs(str(path)), wave_mesh="off")
    return rc, port, ref, str(path)


def test_one_bucket_one_engine_no_fallback(runs):
    rc, port, _ref, _path = runs
    s = port["summary"]
    assert rc == 0
    assert (s["buckets"], s["engines_compiled"], s["fallback_jobs"],
            s["cache_hits"]) == (1, 1, 0, 0)
    assert [r["status"] for r in port["jobs"]] == ["done"] * len(JOBS)


def test_reports_equal_reference_run_jobs(runs):
    _rc, port, ref, _path = runs
    assert list(port["summary"]) == list(ref.summary)
    assert _untimed(port["summary"]) == _untimed(ref.summary)
    for got, o in zip(port["jobs"], ref.outcomes):
        want = o.report
        assert list(got) == list(want)
        assert _untimed(got) == _untimed(want), got["label"]


def test_counts_equal_solo_engine_and_oracle(runs):
    _rc, port, _ref, path = runs
    for job, got in zip(load_jobs(path), port["jobs"]):
        eng = Engine(job.cfg, device="cpu")
        solo = eng.check(max_depth=job.max_depth, stop_on_violation=True)
        want = cached_explore(job.cfg, max_depth=job.max_depth,
                              keep_states=True)
        assert got["distinct_states"] == solo.distinct_states == \
            want.distinct_states
        assert got["depth"] == solo.depth == want.depth
        assert got["level_sizes"] == solo.level_sizes
        assert got["generated_states"] == solo.generated_states
        assert got["violations"] == len(solo.violations) == 0


def test_tables_hold_the_reachable_key_sets(runs):
    """Each job's visited table after its wave, as a key set, is the set
    of its reachable states' fingerprints under the bucket's ceiling
    (slots may differ from a sequential insert; membership may not)."""
    _rc, _port, _ref, path = runs
    jobs = load_jobs(path)
    sch = WaveScheduler(device="cpu")
    rep = sch.serve(jobs)
    (be,) = sch._engines.values()
    ring = be._rings[4]
    eng = be.eng
    for k, (job, o) in enumerate(zip(jobs, rep.outcomes)):
        tab = words_to_numpy(ring.table(k))
        occ = ~(tab == 0xFFFFFFFF).all(0)
        got = {tuple(c) for c in tab[:, occ].T}
        want = cached_explore(job.cfg, max_depth=job.max_depth,
                              keep_states=True)
        enc = [eng.ir.encode(eng.lay, sv, h)
               for sv, h in want.states.values()]
        rows = {n: np.stack([e[n] for e in enc]) for n in enc[0]}
        fp = words_to_numpy(eng.fpr.fingerprint_batch_T(
            rows_to_torch(rows, "cpu", eng.ir.u32_keys)))
        assert got == {tuple(c) for c in fp.T}, job.label
        assert len(got) == o.res.distinct_states


def test_witness_trace_of_a_batched_job_equals_solo(runs):
    """The deepest state's trace replays identically from the batched
    job's archives and the solo engine's."""
    _rc, _port, _ref, path = runs
    job = load_jobs(path)[0]
    sch = WaveScheduler(device="cpu")
    o = sch.serve([job]).outcomes[0]
    eng = Engine(job.cfg, device="cpu")
    res = eng.check(max_depth=job.max_depth)
    gid = res.distinct_states - 1
    assert [(lbl, repr(sv)) for lbl, sv in o.trace(gid)] == \
        [(lbl, repr(sv)) for lbl, sv in eng.trace(gid)]
