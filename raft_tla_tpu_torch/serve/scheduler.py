"""The wave scheduler: the serving loop's one copy (the reference's
``serve/scheduler.py``).

``batch`` drains a job list through ``WaveScheduler.serve`` once: result
cache lookups, in-batch duplicate dedup, wave-state restore, shape
bucketing, priority order, ``wave_yield`` parking, solo fallbacks, SLO
tracking, per-tenant ledger rollups and the cache fill.  ``run_jobs`` is
a thin one-shot wrapper over it.

A ``WaveScheduler`` keeps its ``BucketEngine``s (and their captured
graphs) across ``serve()`` calls, so a bucket seen again reports
``engines_compiled`` 0.

Graceful drain: ``serve(jobs, stop=...)`` checks ``stop`` at every wave
boundary and between waves and buckets.  When it fires, live jobs park
(their carries are already persisted to ``wave_state`` at the boundary)
and every unanswered job is deferred: its outcome stays ``None``, its
wave state survives, and ``meta["deferred_jobs"]``/``meta["drained"]``
say so; a later ``serve()`` of the same jobs resumes them bit-exact.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..obs import NULL_OBS
from ..spec import spec_of
from .batch import (_MAX_WAVE, BatchReport, BucketEngine, JobOutcome,
                    _build_report, _default_serve_bucket, _job_row,
                    _JobRun, _run_solo, _SloTracker,
                    resolve_wave_mesh)

# what exec_cache may not ask for yet
_EXEC_CACHE_REFUSAL = (
    "the persistent executable cache (ROADMAP item 8b) is not ported: "
    "a CUDA graph cannot be written to disk, and each bucket captures "
    "its graphs at first use")
from .jobs import Job
from .wavestate import WaveStateStore

__all__ = ["WaveScheduler"]


class WaveScheduler:
    """The serving loop's long-lived half: the stores (result cache,
    wave state), the bucket parameters, the device and the
    ``BucketEngine`` map.  ``serve()`` drains one job list through it."""

    def __init__(self, cache=None, wave_state=None, exec_cache=None,
                 bucket_overrides=None,
                 wave_yield: Optional[int] = None,
                 max_wave: Optional[int] = None,
                 wave_mesh=None, device: Optional[str] = None):
        from ..utils import resolve_device
        if exec_cache is not None:
            raise ValueError(_EXEC_CACHE_REFUSAL)
        if isinstance(wave_state, str):
            wave_state = WaveStateStore(wave_state)
        if wave_yield is not None and int(wave_yield) < 1:
            raise ValueError(f"wave_yield must be >= 1 "
                             f"(got {wave_yield})")
        # one device: "auto"/"off"/0/1 resolve to (0, 1); a larger mesh
        # raises, naming ROADMAP item 9d
        resolve_wave_mesh(wave_mesh)
        wave_cap = int(max_wave) if max_wave is not None else _MAX_WAVE
        if wave_cap < 1:
            raise ValueError(f"max_wave must be >= 1 (got {max_wave})")
        # the device every bucket and solo engine runs on: cuda unless
        # the caller asks for the CPU (raises with no CUDA)
        self.device = str(resolve_device(device))
        self.cache = cache
        self.wave_state = wave_state
        self.bucket_overrides = dict(bucket_overrides or {})
        self.wave_yield = None if wave_yield is None else int(wave_yield)
        self.wave_cap = wave_cap
        # bucket key -> BucketEngine, kept across serve() calls
        self._engines: Dict[tuple, BucketEngine] = {}

    def _bucket_engine(self, bkey, ceiling, params, meta
                       ) -> BucketEngine:
        be = self._engines.get(bkey)
        if be is None:
            be = BucketEngine(ceiling, device=self.device, **params)
            self._engines[bkey] = be
            meta["engines_compiled"] += 1
        return be

    def serve(self, jobs: List[Job], obs=None,
              sequential: bool = False, verbose: bool = False,
              stop=None) -> BatchReport:
        """Drain one job list: cache lookups, dedup, wave-state
        restore, bucketed waves, solo fallbacks, cache fill.  Returns
        a BatchReport with outcomes in submission order — an outcome
        is ``None`` only when ``stop`` fired first (deferred; see the
        module docstring)."""
        obs = obs if obs is not None else NULL_OBS
        t0 = time.perf_counter()
        cache, wave_state = self.cache, self.wave_state
        meta = dict(jobs=len(jobs), cache_hits=0, buckets=0,
                    engines_compiled=0, batch_dispatches=0,
                    fallback_jobs=0, sequential=bool(sequential),
                    resumed_jobs=0, parked_waves=0,
                    # wave occupancy highwater marks:
                    # run_wave maxes these per wave; 0 = no batched
                    # wave ran (cache-only or sequential runs)
                    wave_devices=0, wave_lanes=0, wave_state_shards=0)
        slo = _SloTracker(len(jobs))
        stopped = False

        def _want_stop() -> bool:
            nonlocal stopped
            if not stopped and stop is not None and stop():
                stopped = True
            return stopped

        # labels key the heartbeat/watch job map and the report rows —
        # empty ones get positional names, duplicates get #N suffixes
        # so two same-labeled jobs never collapse into one watch line.
        # (The Job objects are relabeled in place: the outcome rows
        # must carry the same names the heartbeat used.)
        seen_labels: Dict[str, int] = {}
        for i, job in enumerate(jobs):
            if not job.label:
                job.label = f"job{i}"
            base = job.label
            if base in seen_labels:
                n = seen_labels[base]
                while f"{base}#{n + 1}" in seen_labels:
                    n += 1
                seen_labels[base] = n + 1
                job.label = f"{base}#{n + 1}"
            seen_labels.setdefault(job.label, 1)
        outcomes: List[Optional[JobOutcome]] = [None] * len(jobs)
        deferred: set = set()
        # the batch-global per-job status map every heartbeat carries
        jobs_ctx: Dict[str, Dict] = {}
        pending: List[int] = []
        key_first: Dict[str, int] = {}
        dup_of: Dict[int, int] = {}
        for i, job in enumerate(jobs):
            key = job.cache_key()
            hit = cache.get(key) if cache is not None else None
            if hit is not None:
                meta["cache_hits"] += 1
                outcomes[i] = JobOutcome._from_cache(job, hit)
                jobs_ctx[job.label] = {
                    "depth": int(hit.get("depth", 0)),
                    "distinct": int(hit.get("distinct_states", 0)),
                    "status": "cache_hit"}
                slo.job_done(0.0, 0.0)     # served instantly, honestly
                _job_row(obs, outcomes[i])
            elif key in key_first:
                # two equal cache keys in one list are guaranteed the
                # same result — compute once, answer the duplicate from
                # the first job's outcome
                dup_of[i] = key_first[key]
            else:
                key_first[key] = i
                pending.append(i)
        meta["deduped"] = len(dup_of)
        solo: List[Tuple[int, str, Optional[str]]] = []
        # wave-state resume: a pending job with a persisted carry
        # enters its wave mid-BFS instead of from the roots (a killed
        # run's stragglers; finished jobs were answered by the cache)
        restored: Dict[int, _JobRun] = {}
        if wave_state is not None and not sequential:
            for i in pending:
                hit = wave_state.load(jobs[i].cache_key())
                if hit is None:
                    continue
                arrays, book = hit
                restored[i] = _JobRun.from_wave_state(jobs[i], arrays,
                                                      book)
                meta["resumed_jobs"] += 1
                if obs.ledger is not None:
                    obs.ledger.record({
                        "kind": "wave_resume", "label": jobs[i].label,
                        "depth": int(book["depth"]),
                        "distinct": int(book["distinct"])})
        if sequential:
            solo = [(i, "done", None) for i in pending]
        else:
            buckets: Dict[tuple, list] = {}
            for i in pending:
                job = jobs[i]
                ir = spec_of(job.cfg)
                if job.seed_states is not None or \
                        getattr(job.cfg, "prefix_pins", ()):
                    solo.append((i, "fallback",
                                 "seeded/prefix-pinned jobs run "
                                 "sequentially"))
                    continue
                hook = ir.serve_bucket or _default_serve_bucket
                ceiling, params = hook(job.cfg)
                params = dict(params)
                params.update(self.bucket_overrides)
                bkey = (ir.name, ir.fingerprint(), repr(ceiling),
                        tuple(sorted(params.items())))
                buckets.setdefault(
                    bkey, [ceiling, params, []])[2].append(i)
            meta["buckets"] = len(buckets)
            for bkey, (ceiling, params, idxs) in buckets.items():
                if _want_stop():
                    deferred.update(idxs)
                    continue
                be = self._bucket_engine(bkey, ceiling, params, meta)
                # wave scheduling: priority first (stable on
                # submission order), parked jobs requeue at the back —
                # a long job yields its lane and continues in a later
                # wave
                queue = deque(sorted(
                    idxs, key=lambda i: (-jobs[i].priority, i)))
                parked_runs: Dict[int, _JobRun] = {}
                while queue:
                    if _want_stop():
                        # drain: everything still queued (incl. parked
                        # stragglers, whose carries are already on
                        # disk when wave_state is set) is deferred —
                        # a later serve() resumes them mid-BFS
                        deferred.update(queue)
                        break
                    wave = [queue.popleft()
                            for _ in range(min(self.wave_cap,
                                               len(queue)))]
                    runs = []
                    for i in wave:
                        run = parked_runs.pop(i, None)
                        if run is None:
                            # fresh AND wave-state-restored jobs stamp
                            # their wait here (a restored run's _t0 is
                            # its restore time in THIS process — its
                            # pre-kill runtime is not recoverable,
                            # which the row's "resumed from wave
                            # state" status_reason flags for SLO
                            # consumers); parked runs keep the wait
                            # stamped at their first entry
                            run = restored.pop(i, None) \
                                or _JobRun(jobs[i])
                            slo.job_entered(run)
                        run.parked = False
                        runs.append(run)
                    answered = sum(1 for o in outcomes
                                   if o is not None)
                    slo.set_queue_depth(
                        len(jobs) - answered - len(runs))
                    be.run_wave(
                        runs, obs, meta, jobs_ctx=jobs_ctx,
                        verbose=verbose,
                        max_steps=self.wave_yield if queue else None,
                        wave_state=wave_state, slo_ctx=slo.snapshot,
                        stop=stop)
                    if any(run.parked for run in runs):
                        # one increment per wave that yielded, however
                        # many jobs parked in it (the key counts WAVES)
                        meta["parked_waves"] += 1
                    for i, run in zip(wave, runs):
                        if run.parked:
                            parked_runs[i] = run
                            queue.append(i)
                            continue
                        if run.fallback:
                            solo.append((i, "fallback",
                                         run.fallback_reason))
                            continue
                        job = jobs[i]
                        archives = ((run.parents, run.lanes,
                                     run.states, be.eng.labels,
                                     be.eng.lay)
                                    if job.store_states else None)
                        tracer = None
                        outcome = JobOutcome(job, "done", res=run.res,
                                             report=None,
                                             archives=archives)
                        if job.store_states:
                            tracer = outcome.trace
                        reason = ("resumed from wave state"
                                  if run.resumed else None)
                        outcome.report = _build_report(job, run.res,
                                                       "done",
                                                       reason=reason,
                                                       tracer=tracer)
                        outcome.report["wait_s"] = round(run.wait_s, 3)
                        outcome.report["service_s"] = round(
                            run.res.seconds, 3)
                        slo.job_done(run.wait_s, run.res.seconds)
                        outcomes[i] = outcome
        meta["fallback_jobs"] = sum(1 for _i, st, _r in solo
                                    if st == "fallback")
        for i, status, reason in solo:
            if _want_stop():
                # drain: don't start new solo engines — the job's
                # claimed file / submission survives for a later round
                deferred.add(i)
                meta["fallback_jobs"] -= int(status == "fallback")
                continue
            wait_s = time.perf_counter() - slo.t_submit
            outcomes[i] = _run_solo(jobs[i], obs, meta, status, reason,
                                    sym_canon=self.bucket_overrides
                                    .get("sym_canon", "auto"),
                                    device=self.device)
            res = outcomes[i].res
            outcomes[i].report["wait_s"] = round(wait_s, 3)
            outcomes[i].report["service_s"] = round(res.seconds, 3)
            slo.job_done(wait_s, res.seconds)
            jobs_ctx[jobs[i].label] = {"depth": int(res.depth),
                                       "distinct":
                                       int(res.distinct_states),
                                       "status": status}
        for i, src in dup_of.items():
            if outcomes[src] is None:
                # the duplicate's source was deferred by the drain —
                # the duplicate defers with it (same fingerprint, same
                # later answer)
                deferred.add(i)
                continue
            payload = outcomes[src].cache_payload()
            outcomes[i] = JobOutcome._from_cache(jobs[i], payload)
            outcomes[i].report["status_reason"] = \
                f"duplicate of job {jobs[src].label!r} in this batch"
            jobs_ctx[jobs[i].label] = {
                "depth": int(payload.get("depth", 0)),
                "distinct": int(payload.get("distinct_states", 0)),
                "status": "cache_hit"}
            slo.job_done(0.0, 0.0)
            _job_row(obs, outcomes[i])
        for i in sorted(deferred):
            ctx = jobs_ctx.setdefault(jobs[i].label,
                                      {"depth": 0, "distinct": 0})
            ctx["status"] = "deferred"
        meta["deferred_jobs"] = len(deferred)
        meta["drained"] = stopped
        slo.set_queue_depth(len(deferred))
        if jobs_ctx:
            # the final heartbeat carries the whole batch's job map +
            # SLO snapshot, incl. cache hits and solo jobs that never
            # rode a batched dispatch
            obs.set_jobs(jobs_ctx, slo=slo.snapshot)
        if obs.ledger is not None:
            # per-tenant (spec) rollups: one kind="tenant" record per
            # spec in the batch — the multi-tenant SLO summary a
            # dashboard (tools/watch.py --ledger) reads without
            # parsing job rows
            tenants: Dict[str, Dict] = {}
            for o in outcomes:
                if o is None:
                    continue
                t = tenants.setdefault(o.job.ir.name, dict(
                    kind="tenant", spec=o.job.ir.name, jobs=0,
                    cache_hits=0, fallbacks=0, violations=0,
                    distinct_states=0, wait_s=0.0, service_s=0.0))
                t["jobs"] += 1
                t["cache_hits"] += int(o.status == "cache_hit")
                t["fallbacks"] += int(o.status == "fallback")
                t["violations"] += int(o.report.get("violations", 0))
                t["distinct_states"] += int(
                    o.report.get("distinct_states", 0))
                t["wait_s"] += float(o.report.get("wait_s", 0.0))
                t["service_s"] += float(o.report.get("service_s", 0.0))
            for t in tenants.values():
                t["wait_s"] = round(t["wait_s"], 3)
                t["service_s"] = round(t["service_s"], 3)
                obs.ledger.record(t)
        for outcome in outcomes:
            if outcome is None or outcome.status == "cache_hit":
                continue
            if cache is not None:
                cache.put(outcome.report["cache_key"],
                          outcome.cache_payload())
            if wave_state is not None:
                # the job is answered (and cached): retire its mid-BFS
                # carry so a future invocation never resumes stale
                # state (a DEFERRED job's carry deliberately survives)
                wave_state.drop(outcome.report["cache_key"])
            _job_row(obs, outcome)
        return BatchReport(outcomes, meta,
                           seconds=time.perf_counter() - t0)
