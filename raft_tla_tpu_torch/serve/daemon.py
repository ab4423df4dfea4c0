"""The persistent checking daemon — ``serve`` (the reference's
``serve/daemon.py``, over this package's wave scheduler).

A long-lived process over the shared wave scheduler (serve/scheduler):
poll the spool (serve/intake) — and optionally a JSONL stream tail —
claim complete submissions, drain each claimed batch through
``WaveScheduler.serve()``, and write one atomic result JSON and done/
marker per submission.  ``batch`` is this loop run for exactly one
cycle with the jobs handed in directly; the daemon adds only intake,
the poll cadence, signals and per-cycle telemetry — every scheduling
decision (priority, ``--wave-yield`` parking, dedup, cache, wave-state
restore) is the scheduler's.  Its waves run on ``device`` (cuda unless
the caller asks for the CPU; with no CUDA the scheduler raises).

Lifecycle and restart matrix:

- **SIGTERM/SIGINT** — graceful drain: the current wave parks at its
  next step boundary (carries already persisted to the wave state),
  unanswered jobs stay claimed, a ``kind="daemon"`` row and one
  registry record (cmd="serve", status "draining" when work is parked,
  else "done", with the drain reason) flush, the final heartbeat says
  ``status="done"``, and the process exits 0.
- **a kill mid-wave** — nothing graceful ran, and nothing is lost:
  claimed files survive, wave-state carries survive, finished jobs sit
  in the result cache.  The next start re-claims every leftover
  (``SpoolIntake.recover``) and the scheduler resumes stragglers
  mid-BFS bit-exact.
- **a restart with an executable cache** — every bucket recaptures its
  graphs: a CUDA graph cannot be written to disk, so the cache counts a
  named store failure per program and never hits (serve/exec_cache).
  Within one process the scheduler's bucket engines keep their graphs
  across cycles.
- **cycle failure** — transient errors (the resil RETRYABLE set, chaos
  faults included) retry the whole cycle with bounded backoff
  (``retries``/``backoff``); the retry is incremental through the
  result cache and the wave state.  Exhaustion exits 3 with a
  status="failed" registry record.

Heartbeat: between waves the daemon beats ``status idle|serving|
draining`` with a ``daemon`` block (cycle counter, queue depths,
cumulative done/rejected, per-tenant rollups) that also rides every
in-wave dispatch beat; the reference's ``tools/watch.py`` renders the
daemon view from it.
"""

from __future__ import annotations

import signal
import time
from typing import Dict, List, Optional

from ..obs import NULL_OBS
from ..resil.supervisor import RETRYABLE, backoff_delay
from .intake import SpoolIntake, StreamTail, Submission
from .scheduler import WaveScheduler

__all__ = ["Daemon"]


class Daemon:
    """The serve loop (module docstring).  Construction wires the
    intake, the optional stream tail and the scheduler; ``run()`` is
    the process main loop and owns ``obs.finish`` (the CLI only
    builds and starts the bundle)."""

    def __init__(self, spool: str, cache=None, wave_state=None,
                 exec_cache=None, obs=None, poll_s: float = 0.5,
                 wave_yield: Optional[int] = None,
                 max_wave: Optional[int] = None,
                 wave_mesh=None,
                 bucket_overrides=None, retries: int = 0,
                 backoff: float = 2.0,
                 max_idle_polls: Optional[int] = None,
                 stream: Optional[str] = None, grace_s: float = 5.0,
                 verbose: bool = False, sleep=time.sleep,
                 device: Optional[str] = None):
        # the scheduler first: with no CUDA and no device="cpu" it
        # raises before the spool is touched
        self.sched = WaveScheduler(cache=cache, wave_state=wave_state,
                                   exec_cache=exec_cache,
                                   bucket_overrides=bucket_overrides,
                                   wave_yield=wave_yield,
                                   max_wave=max_wave,
                                   wave_mesh=wave_mesh, device=device)
        self.intake = SpoolIntake(spool, grace_s=grace_s)
        self.stream = (StreamTail(stream, self.intake)
                       if stream else None)
        self.obs = obs if obs is not None else NULL_OBS
        self.poll_s = float(poll_s)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.max_idle_polls = max_idle_polls
        self.verbose = verbose
        self.sleep = sleep
        self.stats: Dict[str, int] = dict(
            cycles=0, jobs_claimed=0, jobs_done=0, jobs_rejected=0,
            jobs_recovered=0, cache_hits=0, violations=0)
        # per-tenant (spec) cumulative rollup for the daemon heartbeat
        self.tenants: Dict[str, Dict[str, int]] = {}
        self._pending: List[Submission] = []
        self._drain: Optional[str] = None

    # -- drain plumbing ------------------------------------------------

    def request_drain(self, reason: str):
        if self._drain is None:
            self._drain = reason

    def draining(self) -> bool:
        """The scheduler's ``stop`` callable: checked at every wave
        step boundary, after the wave-state persist."""
        return self._drain is not None

    def install_signals(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda signum, _frame:
                          self.request_drain(
                              f"signal {signal.Signals(signum).name}"))

    # -- telemetry -----------------------------------------------------

    def _daemon_block(self, status: str) -> Dict:
        d = dict(self.stats)
        d["status"] = status
        d.update(self.intake.counts())
        d["tenants"] = {k: dict(v) for k, v in self.tenants.items()}
        if self._drain is not None:
            d["drain_reason"] = self._drain
        return d

    def _beat(self, status: str):
        self.obs.daemon_beat(status=status,
                             stats=self._daemon_block(status))

    def _ledger(self, rec: Dict):
        if self.obs.ledger is not None:
            self.obs.ledger.record(rec)

    # -- the cycle -----------------------------------------------------

    def _poll_intake(self) -> List[Submission]:
        if self.stream is not None:
            self.stream.poll()
        claimed, rejected = self.intake.poll()
        for sub in claimed:
            self.stats["jobs_claimed"] += 1
            self._ledger({"kind": "intake", "action": "claimed",
                          "name": sub.name, "label": sub.job.label,
                          "spec": sub.job.ir.name,
                          "cache_key": sub.job.cache_key()})
        for name, reason in rejected:
            self.stats["jobs_rejected"] += 1
            self._ledger({"kind": "intake", "action": "rejected",
                          "name": name, "reason": reason[:300]})
        return claimed

    def _finalize(self, sub: Submission, outcome):
        self.intake.write_result(sub.name, outcome.report)
        self.intake.mark_done(sub.name, outcome.report)
        self.stats["jobs_done"] += 1
        self.stats["cache_hits"] += int(outcome.status == "cache_hit")
        self.stats["violations"] += int(
            outcome.report.get("violations", 0))
        t = self.tenants.setdefault(sub.job.ir.name, dict(
            jobs_done=0, cache_hits=0, violations=0))
        t["jobs_done"] += 1
        t["cache_hits"] += int(outcome.status == "cache_hit")
        t["violations"] += int(outcome.report.get("violations", 0))

    def run_cycle(self) -> Optional[object]:
        """One poll + serve round: None when intake was empty (idle),
        else the cycle's BatchReport.  Raises the last RETRYABLE error
        when per-cycle retries exhaust (run() turns that into exit
        3).  Exposed for in-process tests — run() is this in a loop
        plus signals and the drain epilogue."""
        new = self._pending + self._poll_intake()
        self._pending = []
        if not new:
            return None
        self.stats["cycles"] += 1
        self._beat("serving")
        jobs = [sub.job for sub in new]
        attempt = 0
        while True:
            try:
                rep = self.sched.serve(jobs, obs=self.obs,
                                       verbose=self.verbose,
                                       stop=self.draining)
                break
            except RETRYABLE as e:
                # the retry is incremental: answered jobs hit the
                # result cache, stragglers resume from wave state —
                # and the claimed files are untouched either way
                if attempt >= self.retries:
                    self._pending = new
                    raise
                wait = backoff_delay(attempt, self.backoff, 60.0)
                self.obs.retry(attempt=attempt + 1,
                               max_attempts=self.retries + 1,
                               wait_s=wait, error=e)
                self.sleep(wait)
                attempt += 1
        deferred = 0
        for sub, outcome in zip(new, rep.outcomes):
            if outcome is None:
                # deferred by a drain: the claimed file stays — this
                # process (or the next) picks it up again
                self._pending.append(sub)
                deferred += 1
                continue
            self._finalize(sub, outcome)
        self._ledger({"kind": "daemon", "cycle": self.stats["cycles"],
                      "claimed": len(new),
                      "done": len(new) - deferred,
                      "deferred": deferred,
                      **{k: rep.meta[k] for k in
                         ("cache_hits", "buckets", "engines_compiled",
                          "batch_dispatches", "resumed_jobs",
                          "parked_waves", "deferred_jobs", "drained")
                         if k in rep.meta}})
        return rep

    # -- the main loop -------------------------------------------------

    def run(self) -> int:
        recovered, rejected = self.intake.recover()
        for sub in recovered:
            self.stats["jobs_recovered"] += 1
            self._ledger({"kind": "intake", "action": "recovered",
                          "name": sub.name, "label": sub.job.label,
                          "spec": sub.job.ir.name,
                          "cache_key": sub.job.cache_key()})
        for name, reason in rejected:
            self.stats["jobs_rejected"] += 1
            self._ledger({"kind": "intake", "action": "rejected",
                          "name": name, "reason": reason[:300]})
        self._pending = recovered
        idle = 0
        status = "failed"              # any abnormal exit path
        try:
            while not self.draining():
                try:
                    rep = self.run_cycle()
                except RETRYABLE as e:
                    print(f"serve cycle failed: {e}", flush=True)
                    return 3
                if rep is None and not self._pending:
                    idle += 1
                    self._beat("idle")
                    if self.max_idle_polls is not None and \
                            idle >= self.max_idle_polls:
                        self.request_drain(
                            f"idle for {idle} polls")
                        break
                    self.sleep(self.poll_s)
                else:
                    idle = 0
            self._beat("draining")
            status = "done"
            return 0
        finally:
            # the drain epilogue runs on EVERY exit path (graceful
            # drain, retry exhaustion, unexpected error): final
            # heartbeat status "done"/"failed" with the drain reason,
            # plus the one registry record per drain cycle — both
            # cross-linked to the job/intake ledger rows by run id.
            # A graceful exit that still has work parked records
            # registry status "draining" (the heartbeat stays "done"):
            # `cli obs ls --status draining` lists exactly the drain
            # cycles a successor daemon must pick up.
            extra = {"daemon": self._daemon_block(status),
                     "drain_reason": self._drain or ""}
            if status == "done" and self._pending:
                extra["status"] = "draining"
            self.obs.finish(
                status=status,
                counters={k: int(v) for k, v in self.stats.items()},
                extra=extra)
