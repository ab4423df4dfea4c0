"""Observability bundle for the engines (the reference's
``raft_tla_tpu/obs/``; its query half, ``report.py``, serves ``cli
obs``).

One ``Obs`` bundle rides through a run and fans out to its sinks, each
optional:

- **spans** (`obs/spans.py`) — nested phase timers on
  ``time.perf_counter()``, emitted as Chrome-trace JSON
  (``--trace-timeline``, loads in Perfetto);
- **ledger** (`obs/ledger.py`) — one JSONL record per dispatch
  (``--ledger``): depth, frontier, the full metrics-registry snapshot,
  states/sec, dedup hit rate, RSS, device memory — flushed per record
  so a killed run keeps its telemetry;
- **heartbeat** (`obs/heartbeat.py`) — a small JSON atomically
  rewritten every dispatch (``--heartbeat``) so a watchdog can tell a
  slow level from a dead process;
- **profiler** — an opt-in ``torch.profiler`` trace (``--profile-dir``;
  CPU activity, and CUDA activity when the run uses the card) whose
  ``record_function`` ranges carry the span names, exported at
  ``finish`` as one Chrome trace file named by the run id;
- **registry** (`obs/registry.py`, ``--registry DIR``) — one atomic
  schema-versioned record per run at ``finish()``: counters, span
  rollups, resource peaks, backend fingerprint, exit status, artifact
  paths.

Every bundle with a file sink carries a **run id**, stamped into every
ledger row, the heartbeat and the registry record, and a **resource
sampler** (`obs/resources.py`) fed at every dispatch.

Engines take ``obs=None`` in ``check()`` (the walker in ``run()``) and
default to ``NULL_OBS`` (every hook a no-op); the CLI builds a real
bundle from the flags via ``from_flags`` and owns its lifecycle
(``start``/``finish``).  The
counters themselves live in ``obs/metrics.py``'s registry.  Nothing
here touches CUDA, starts a profiler or opens a file at import.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

from .heartbeat import Heartbeat
from .ledger import RunLedger, device_memory_stats, rss_bytes
from .metrics import (BURST_COUNTER_KEYS, CHECK_COUNTER_KEYS,
                      MXU_COUNTER_KEYS, SIM_COUNTER_KEYS,
                      SIM_DISPATCH_KEYS, MetricsRegistry, check_stats,
                      sim_counters, sim_stats)
from .registry import RunRegistry, new_run_id
from .resources import ResourceSampler, backend_fingerprint
from .spans import SpanRecorder

__all__ = [
    "Obs", "NULL_OBS", "from_flags", "SpanRecorder", "RunLedger",
    "Heartbeat", "MetricsRegistry", "RunRegistry", "ResourceSampler",
    "check_stats", "sim_stats", "sim_counters", "rss_bytes",
    "device_memory_stats", "backend_fingerprint", "new_run_id",
    "CHECK_COUNTER_KEYS", "BURST_COUNTER_KEYS", "MXU_COUNTER_KEYS",
    "SIM_COUNTER_KEYS", "SIM_DISPATCH_KEYS",
]

_NULL_CTX = contextlib.nullcontext()


class Obs:
    """Per-run observability bundle (see module docstring).  With no
    sinks configured every hook is a no-op — the engines call
    ``span``/``dispatch`` unconditionally.  ``device`` is the run's
    device (None: CUDA where it is available): it picks the profiler's
    activities, the device-memory gauges and the backend fingerprint."""

    def __init__(self, spans: Optional[SpanRecorder] = None,
                 ledger: Optional[RunLedger] = None,
                 heartbeat: Optional[Heartbeat] = None,
                 profile_dir: Optional[str] = None,
                 meta: Optional[Dict] = None,
                 registry: Optional[RunRegistry] = None,
                 run_info: Optional[Dict] = None,
                 device: Optional[str] = None):
        self.spans = spans
        self.ledger = ledger
        self.heartbeat = heartbeat
        self.profile_dir = profile_dir
        self.registry = registry
        self.device = device
        # run-constant stamp merged into every ledger record (the CLI
        # passes the active spec name + IR fingerprint here)
        self.meta = dict(meta or {})
        # run-level context for the meta row + registry record only
        # (cmd name, cfg repr — too bulky to ride every dispatch row)
        self.run_info = dict(run_info or {})
        self._profiler = None
        self.profile_path: Optional[str] = None
        self._t0 = time.perf_counter()
        self._started_ts = time.time()
        self._n_dispatch = 0
        self._last_jobs = None
        self._last_slo = None
        self._last_wave = None
        self._last_daemon = None
        self._last_metrics: Optional[Dict] = None
        # one id per run, stamped into every ledger row (RunLedger's
        # stamp), the heartbeat, and the registry record
        self.run_id = new_run_id() if (
            ledger is not None or heartbeat is not None
            or registry is not None) else None
        if self.run_id is not None:
            if ledger is not None:
                ledger.stamp["run_id"] = self.run_id
            if heartbeat is not None:
                heartbeat.run_id = self.run_id
        self._resources = ResourceSampler(spans=spans, device=device) if (
            ledger is not None or heartbeat is not None
            or registry is not None) else None
        if profile_dir and spans is not None:
            # the device trace lines up with the host timeline only if
            # the record_function names are the span names
            spans.annotate = True

    @property
    def enabled(self) -> bool:
        return (self.spans is not None or self.ledger is not None
                or self.heartbeat is not None
                or self.profile_dir is not None
                or self.registry is not None)

    # -- hooks the engines call ---------------------------------------

    def span(self, name: str):
        if self.spans is None:
            return _NULL_CTX
        return self.spans.span(name)

    def dispatch(self, *, kind: str, depth: int, frontier: int = 0,
                 metrics: Optional[Dict] = None,
                 states: Optional[int] = None,
                 jobs: Optional[Dict] = None,
                 slo: Optional[Dict] = None,
                 wave: Optional[Dict] = None):
        """One record per dispatch (a burst dispatch or a per-level round
        trip): ledger line + heartbeat rewrite.  ``jobs`` (a serving
        layer's per-job status map {label: {depth, distinct, status}}),
        ``slo`` (its queue snapshot) and ``wave`` (a batched wave's
        occupancy {devices, lanes, filled, pad, jobs_per_device}) ride
        the heartbeat, and the ledger record carries their counts, as
        in the reference; the engines of this package pass none."""
        self._n_dispatch += 1
        metrics = metrics or {}
        if metrics:
            self._last_metrics = dict(metrics)
        if states is None:
            states = int(metrics.get("distinct_states",
                                     metrics.get("walker_steps", 0)))
        res_snap = None
        if self._resources is not None:
            res_snap = self._resources.sample()
            if self.ledger is not None and self._resources.due():
                # the resource row precedes the dispatch row: the
                # ledger's final record stays the final dispatch record
                rrec = dict(self.meta)
                rrec["kind"] = "resource"
                rrec["depth"] = int(depth)
                rrec.update(res_snap)
                self.ledger.record(rrec)
        if self.ledger is not None:
            secs = time.perf_counter() - self._t0
            # counters first, header fields second: the registry's
            # `depth` counter is only finalized at run end, so the
            # dispatch-passed depth must win
            rec = dict(metrics)
            rec.update(self.meta)
            rec["kind"] = kind
            rec["depth"] = int(depth)
            rec["frontier"] = int(frontier)
            rec["dispatch"] = self._n_dispatch
            rec["seconds"] = round(secs, 3)
            rec["states_per_sec"] = round(states / max(secs, 1e-9), 1)
            gen = int(metrics.get("generated_states", 0) or 0)
            if gen:
                rec["dedup_hit_rate"] = round(
                    1.0 - int(metrics["distinct_states"]) / gen, 4)
            rec["rss_bytes"] = rss_bytes()
            dev = device_memory_stats(self.device)
            if dev:
                rec["device_memory"] = dev
            if jobs is not None:
                rec["jobs_total"] = len(jobs)
                rec["jobs_live"] = sum(
                    1 for j in jobs.values()
                    if j.get("status") == "running")
            if slo is not None and "queue_depth" in slo:
                rec["queue_depth"] = int(slo["queue_depth"])
            if wave is not None:
                rec["wave_devices"] = int(wave.get("devices", 1))
                rec["wave_lanes"] = int(wave.get("lanes", 0))
                rec["wave_pad"] = int(wave.get("pad", 0))
                rec["wave_state_shards"] = int(
                    wave.get("state_shards", 1))
            self.ledger.record(rec)
        if jobs is not None:
            self._last_jobs = jobs
        if slo is not None:
            self._last_slo = dict(slo)
        if wave is not None:
            self._last_wave = dict(wave)
        if self.heartbeat is not None:
            extra = {}
            if jobs is not None:
                extra["jobs"] = jobs
            if slo is not None:
                extra["slo"] = dict(slo)
            if wave is not None:
                extra["wave"] = dict(wave)
            if res_snap is not None:
                extra["resources"] = res_snap
            if self._last_daemon is not None:
                # a daemon's in-wave dispatch beats keep the daemon
                # block visible
                extra["daemon"] = self._last_daemon
            self.heartbeat.beat(depth=depth, states=states,
                                extra=extra or None)

    def set_jobs(self, jobs: Dict, slo: Optional[Dict] = None):
        """Update the per-job status map (and optionally the SLO
        snapshot) the final heartbeat carries (a serving layer records
        jobs that finish outside any batched dispatch here)."""
        self._last_jobs = dict(jobs)
        if slo is not None:
            self._last_slo = dict(slo)

    def daemon_beat(self, *, status: str, stats: Dict):
        """One daemon lifecycle beat: heartbeat status
        ``idle|serving|draining`` plus the ``daemon`` block (queue
        depths, cycle/done/rejected counters, per-tenant rollups)
        tools/watch.py renders as the daemon view.  The block is also
        remembered so every later dispatch beat carries it."""
        self._last_daemon = dict(stats)
        if self.heartbeat is None:
            return
        extra = {"daemon": self._last_daemon}
        if self._last_jobs is not None:
            extra["jobs"] = self._last_jobs
        if self._last_slo is not None:
            extra["slo"] = self._last_slo
        self.heartbeat.beat(depth=self.heartbeat.last_depth,
                            states=self.heartbeat.last_states,
                            status=status, extra=extra)

    def retry(self, *, attempt: int, max_attempts: int, wait_s: float,
              error):
        """One supervised-retry event (resil/supervisor): a
        ``kind="retry"`` ledger record plus a ``status="backoff"``
        heartbeat rewrite carrying the attempt counters, so a watchdog
        (tools/watch.py) shows a retrying run instead of a silent gap
        between dispatches."""
        retry_info = {"attempt": int(attempt),
                      "max_attempts": int(max_attempts),
                      "wait_s": round(float(wait_s), 3),
                      "error": str(error)[:300]}
        if self.ledger is not None:
            rec = dict(self.meta)
            rec["kind"] = "retry"
            rec.update(retry_info)
            self.ledger.record(rec)
        if self.heartbeat is not None:
            self.heartbeat.beat(depth=self.heartbeat.last_depth,
                                states=self.heartbeat.last_states,
                                status="backoff",
                                extra={"retry": retry_info})

    # -- lifecycle (the CLI owns it) ----------------------------------

    def start(self):
        self._t0 = time.perf_counter()
        self._started_ts = time.time()
        if self.ledger is not None:
            # one kind="meta" row at run start: run id (ledger stamp),
            # spec + IR fingerprint (meta), pid, cmd/cfg context and
            # the backend fingerprint
            rec = dict(self.meta)
            rec.update(self.run_info)
            rec["kind"] = "meta"
            rec["pid"] = os.getpid()
            rec["backend"] = backend_fingerprint(self.device)
            self.ledger.record(rec)
        if self.profile_dir:
            # started before the engine's first graph warm-up, so the
            # trace holds the captures the compile spans name; a
            # profiler that cannot start fails the run
            from torch.profiler import ProfilerActivity, profile
            from .resources import run_device
            acts = [ProfilerActivity.CPU]
            if run_device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self.profile_dir, exist_ok=True)
            prof = profile(activities=acts)
            prof.start()
            self._profiler = prof
        return self

    def _stop_profiler(self):
        """Stop the profiler and export its one Chrome trace file,
        ``<run id>.pt.trace.json``, into the profile directory."""
        prof, self._profiler = self._profiler, None
        prof.stop()
        path = os.path.join(self.profile_dir,
                            f"{self.run_id or new_run_id()}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.profile_path = path

    def finish(self, depth: Optional[int] = None,
               states: Optional[int] = None, status: str = "finished",
               counters: Optional[Dict] = None,
               level_sizes=None, extra: Optional[Dict] = None):
        """``extra``: merged into both the final heartbeat's extra
        payload and the registry record's top level.  A ``status`` key
        in it overrides the registry record's status only — the
        heartbeat keeps the ``status`` argument, so watch always sees
        the terminal done/failed."""
        if self._profiler is not None:
            self._stop_profiler()
        if self.heartbeat is not None:
            # a terminal status without fresh numbers (the CLI's
            # failure path passes depth=None) still stamps the file —
            # a watchdog must see "failed", not an eternal "running"
            self.heartbeat.beat(
                depth=depth if depth is not None
                else self.heartbeat.last_depth,
                states=int(states if states is not None
                           else self.heartbeat.last_states),
                status=status,
                extra=(({"jobs": self._last_jobs}
                        if self._last_jobs is not None else {}) |
                       ({"slo": self._last_slo}
                        if self._last_slo is not None else {}) |
                       ({"wave": self._last_wave}
                        if self._last_wave is not None else {}) |
                       ({"resources": self._resources.sample()}
                        if self._resources is not None else {}) |
                       ({"daemon": self._last_daemon}
                        if self._last_daemon is not None else {}) |
                       ({k: v for k, v in extra.items()
                         if k != "status"} if extra else {})) or
                None)
        if self.registry is not None:
            # one atomic schema-versioned record per run.  ``counters``
            # is the final metrics snapshot when the caller has it
            # (r.metrics.as_dict()); otherwise the last dispatched
            # snapshot stands in (its `depth` counter may lag — the
            # top-level depth field is authoritative)
            rec = dict(self.meta)
            rec.update(self.run_info)
            rec["run_id"] = self.run_id
            rec["status"] = status
            rec["started_ts"] = round(self._started_ts, 3)
            rec["finished_ts"] = round(time.time(), 3)
            rec["seconds"] = round(time.perf_counter() - self._t0, 3)
            if depth is not None:
                rec["depth"] = int(depth)
            if states is not None:
                rec["distinct_states"] = int(states)
            rec["counters"] = dict(counters if counters is not None
                                   else self._last_metrics or {})
            if level_sizes is not None:
                rec["level_sizes"] = [int(x) for x in level_sizes]
            rec["spans"] = (self.spans.totals()
                            if self.spans is not None else {})
            rec["resources"] = (self._resources.rollup()
                                if self._resources is not None else {})
            rec["backend"] = backend_fingerprint(self.device)
            rec["artifacts"] = {
                k: v for k, v in (
                    ("ledger", getattr(self.ledger, "path", None)),
                    ("heartbeat",
                     getattr(self.heartbeat, "path", None)),
                    ("timeline", getattr(self.spans, "path", None)),
                    ("profile_dir", self.profile_dir),
                    ("profile_trace", self.profile_path)) if v}
            if extra:
                rec.update(extra)
            self.registry.append(rec)
        if self.ledger is not None:
            self.ledger.close()
        if self.spans is not None:
            self.spans.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.finish()


NULL_OBS = Obs()


def from_flags(ledger: Optional[str] = None,
               heartbeat: Optional[str] = None,
               timeline: Optional[str] = None,
               profile_dir: Optional[str] = None,
               meta: Optional[Dict] = None,
               registry: Optional[str] = None,
               run_info: Optional[Dict] = None,
               device: Optional[str] = None) -> Obs:
    """Build the bundle the CLI flags describe (NULL_OBS when none are
    set, so callers can pass the result unconditionally).  A registry
    or a profile without a timeline still gets an in-memory
    SpanRecorder: the record's span rollups (and the sampler's compile
    seconds) exist whether or not a trace file was requested, and the
    profiler's ranges come from the spans."""
    if not (ledger or heartbeat or timeline or profile_dir
            or registry):
        return NULL_OBS
    return Obs(
        spans=SpanRecorder(timeline)
        if (timeline or profile_dir or registry) else None,
        ledger=RunLedger(ledger) if ledger else None,
        heartbeat=Heartbeat(heartbeat) if heartbeat else None,
        profile_dir=profile_dir, meta=meta,
        registry=RunRegistry(registry) if registry else None,
        run_info=run_info, device=device)
