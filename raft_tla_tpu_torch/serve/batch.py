"""Batched checking of many small jobs: one device program per bucket
(the reference's ``serve/batch.py``, on one device).

A solo ``check`` pays its own warm-up and its own dispatch chain, so N
small jobs pay N times.  This layer shares both across jobs:

- **Buckets.**  Jobs group by their spec's ``serve_bucket`` hook: (spec,
  ceiling config, bucket params).  One ``BucketEngine`` per bucket
  serves all of its jobs through one job-axis burst
  (``engine/bfs.Engine.burst_batched``), in waves of up to
  ``_MAX_WAVE`` jobs padded to a power of two (padded width JP), so a
  bucket captures few graphs: one per JP.
- **Job axis.**  Each job's frontier ring, visited table, global-id
  cursor, depth gate and invariant verdicts ride a leading [J] axis.
  The loop runs until every job's condition is false; a finished job
  freezes while the others step on.  Each job's trajectory is a solo
  burst's: counts, level sizes, violations and witness traces equal
  the solo ``Engine``'s.
- **Padded ceilings.**  A bucket's ceiling may sit above its jobs'
  configs (``serve_bucket``); each job's guard thresholds, lane mask
  and search bounds (``serve_runtime``) enter the burst as device data,
  so the int8 guard matrix stays one per ceiling.
- **The dedup kernel.**  The batched step launches
  ``csrc/probe_claim.cu`` once per job slot, on that job's table,
  inside the captured graph; the CPU runs its plain twin.  (The
  reference's bucket engine runs its lax dedup form, since a Pallas
  call has no batching rule.)  So a report's ``dedup_kernel`` is 1 on
  the card and 0 on the CPU: the one report key that may differ from
  the reference's there.
- **Fallback.**  A job the batched path cannot hold (roots or a
  frontier past the per-job ring, a table or buffer overflow, seeds or
  prefix pins) re-runs from scratch on its own ``Engine``; its batched
  progress is dropped, so its result is exact.  Fallbacks are counted
  and labelled in the report.
- **Result cache** (serve/cache): a repeat job is answered with zero
  device dispatches.
- **Observability.**  Spans ``bucket_compile`` (the graph warm-up and
  capture of a new (bucket, JP) key, on the card), ``bucket_exec_load``
  and ``bucket_exec_store`` (around it, with an executable cache),
  ``batched_dispatch``, ``job_harvest``, ``sequential_job``; the ledger
  gets one ``kind="batch"`` row per batched dispatch and one
  ``kind="job"`` row per finished job; the heartbeat carries the
  per-job status map.
- **Executable cache** (serve/exec_cache): each new (bucket, JP)
  program is looked up and stored, as the reference does; a captured
  graph cannot be written to disk, so every store fails by name and
  the cache never hits.

The wave mesh (``--wave-mesh N`` / ``JxS``, the reference's multi-device
waves) is not ported: ``resolve_wave_mesh`` refuses it by name.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import (rows_to_torch, storage_rows_to_numpy,
                       storage_to_numpy, words_to_numpy)
from ..engine.graph import GraphRunner
from ..obs.metrics import check_stats
from ..resil.chaos import chaos_point
from ..spec import C_OVERFLOW, spec_of
from ..utils import take_arrays as _take
from .jobs import Job
from .wavestate import WaveStateStore

U32MAX_NP = np.uint32(0xFFFFFFFF)

# jobs per batched wave; a bucket with more runs extra waves
_MAX_WAVE = 8

# the serve_bucket contract's fallback when a spec declares no hook
DEFAULT_BUCKET_PARAMS = dict(chunk=128, vcap=1 << 15, burst_levels=8)

# what --wave-mesh may not ask for yet
_WAVE_MESH_REFUSAL = (
    "the multi-device wave mesh (ROADMAP item 9d) is not ported: this "
    "package runs every wave on one device (--wave-mesh auto, off, 0 "
    "or 1)")


def _default_serve_bucket(cfg):
    return cfg, dict(DEFAULT_BUCKET_PARAMS)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def resolve_wave_mesh(value) -> Tuple[int, int]:
    """Normalize a ``--wave-mesh`` spec to a (J, S) mesh shape, the
    reference's contract on one device: ``"auto"``/None, ``"off"``, 0
    and 1 are ``(0, 1)``, the single-device wave.  A larger count or a
    ``JxS`` grid raises a ValueError naming ROADMAP item 9d (the wave
    mesh is not ported); a malformed value raises the reference's
    message."""
    if value is None or value in ("auto", "off"):
        return (0, 1)
    if isinstance(value, tuple):
        j, s = int(value[0]), int(value[1])
        if j < 0 or s < 1:
            raise ValueError(f"--wave-mesh shape must have J >= 0 and "
                             f"S >= 1, got {value!r}")
    elif isinstance(value, str) and "x" in value:
        try:
            j_txt, s_txt = value.split("x", 1)
            j, s = int(j_txt), int(s_txt)
        except ValueError:
            raise ValueError(
                f"--wave-mesh must be 'auto', 'off', a device count "
                f"or JxS (e.g. 4x2), got {value!r}")
        if j < 1 or s < 1:
            raise ValueError(
                f"--wave-mesh {value!r}: both the J (jobs) and S "
                f"(state) axes must be >= 1")
    else:
        try:
            n = int(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"--wave-mesh must be 'auto', 'off', a device count "
                f"or JxS (e.g. 4x2), got {value!r}")
        if n < 0:
            raise ValueError(f"--wave-mesh device count must be >= 0, "
                             f"got {n}")
        j, s = n, 1
    if j * s > 1:
        raise ValueError(f"--wave-mesh {value!r}: {_WAVE_MESH_REFUSAL}")
    return (0, 1)


# ---------------------------------------------------------------------------
# per-job bookkeeping
# ---------------------------------------------------------------------------

class _JobRun:
    """One job's in-flight state inside a batched wave: the CheckResult
    under construction, the BFS cursors the harvest advances, and the
    per-level trace archives (host lists, the engine's in-RAM archive
    format)."""

    def __init__(self, job: Job):
        from ..engine.bfs import CheckResult
        self.job = job
        self.res = CheckResult()
        # a job's clock starts when it enters its wave, so its seconds
        # never include other buckets' work (it shares its wave's)
        self._t0 = time.perf_counter()
        self.depth = 0
        self.n_states = 0
        self.n_front = 0
        self.parents: List[np.ndarray] = []
        self.lanes: List[np.ndarray] = []
        self.states: List[Dict[str, np.ndarray]] = []
        self.live = True
        self.fallback = False
        self.fallback_reason: Optional[str] = None
        # a carry slice to enter the next wave with instead of root
        # admission: set by a wave yield (parked) or a restore (resumed)
        self.preinit: Optional[Dict] = None
        self.parked = False
        self.resumed = False
        # submission -> wave-entry seconds (_SloTracker)
        self.wait_s = 0.0

    def finish(self):
        self.live = False
        self.res.depth = self.depth
        self.res.seconds = time.perf_counter() - self._t0

    def mark_fallback(self, reason: str):
        self.live = False
        self.fallback = True
        self.fallback_reason = reason

    @property
    def status(self) -> str:
        if self.live:
            return "parked" if self.parked else "running"
        return "fallback" if self.fallback else "done"

    # -- wave-state (de)hydration (serve/wavestate) --------------------

    def book(self) -> Dict:
        res = self.res
        return dict(
            cache_key=self.job.cache_key(), label=self.job.label,
            depth=int(self.depth), n_states=int(self.n_states),
            n_front=int(self.n_front),
            distinct=int(res.distinct_states),
            generated=int(res.generated_states),
            faults=int(res.overflow_faults),
            viol_global=int(res.violations_global),
            levels_fused=int(res.levels_fused),
            burst_dispatches=int(res.burst_dispatches),
            burst_bailouts=int(res.burst_bailouts),
            level_sizes=[int(x) for x in res.level_sizes],
            violations=[[v.invariant, int(v.state_id)]
                        for v in res.violations],
            n_arch=len(self.parents))

    def wave_arrays(self) -> Dict[str, np.ndarray]:
        out = {}
        for nm in ("fm", "gd", "vis"):
            out[nm] = self.preinit[nm]
        for k, v in self.preinit["fr"].items():
            out[f"fr|{k}"] = v
        out["cursors"] = np.array(
            [self.preinit["nf"], self.preinit["g"],
             self.preinit["pg"]], np.int64)
        for i, (p, ln) in enumerate(zip(self.parents, self.lanes)):
            out[f"par|{i}"] = p
            out[f"lane|{i}"] = ln
            for k, v in self.states[i].items():
                out[f"st|{i}|{k}"] = v
        return out

    @classmethod
    def from_wave_state(cls, job: Job, arrays: Dict, book: Dict
                        ) -> "_JobRun":
        from ..engine.bfs import Violation
        run = cls(job)
        run.resumed = True
        run.depth = int(book["depth"])
        run.n_states = int(book["n_states"])
        run.n_front = int(book["n_front"])
        res = run.res
        res.distinct_states = int(book["distinct"])
        res.generated_states = int(book["generated"])
        res.overflow_faults = int(book["faults"])
        res.violations_global = int(book["viol_global"])
        res.levels_fused = int(book["levels_fused"])
        res.burst_dispatches = int(book["burst_dispatches"])
        res.burst_bailouts = int(book["burst_bailouts"])
        res.level_sizes = [int(x) for x in book["level_sizes"]]
        for inv, sid in book["violations"]:
            res.violations.append(Violation(str(inv), int(sid)))
        fr = {nm.split("|", 1)[1]: arrays[nm] for nm in arrays
              if nm.startswith("fr|")}
        cur = arrays["cursors"]
        run.preinit = dict(fr=fr, fm=arrays["fm"], vis=arrays["vis"],
                           gd=arrays["gd"], nf=int(cur[0]),
                           g=int(cur[1]), pg=int(cur[2]))
        n_arch = int(book.get("n_arch", 0))
        st_keys = sorted({nm.split("|", 2)[2] for nm in arrays
                          if nm.startswith("st|0|")})
        for i in range(n_arch):
            run.parents.append(arrays[f"par|{i}"])
            run.lanes.append(arrays[f"lane|{i}"])
            run.states.append({k: arrays[f"st|{i}|{k}"]
                               for k in st_keys})
        return run


class JobOutcome:
    """One job's final answer: status, the CheckResult (None for cache
    hits), the JSON-able report row, and — when trace archives exist —
    ``trace(gid)``/``get_state(gid)`` in the Engine's form."""

    def __init__(self, job: Job, status: str, res=None, report=None,
                 archives=None, engine=None, reason=None):
        self.job = job
        self.status = status
        self.res = res
        self.report = report or {}
        self._archives = archives      # (parents, lanes, states, labels, lay)
        self._engine = engine          # solo engine (fallback path)
        self.reason = reason

    @property
    def cache_hit(self) -> bool:
        return self.status == "cache_hit"

    def get_state(self, gid: int):
        if self._engine is not None:
            return self._engine.get_state(gid)
        if self._archives is None:
            raise ValueError(f"job {self.job.label!r}: no trace "
                             "archives (store_states off or cache hit)")
        ir, lay = self.job.ir, self._archives[4]
        _parents, _lanes, states, _labels = self._archives[:4]
        off = 0
        for blk in states:
            n = next(iter(blk.values())).shape[0]
            if gid < off + n:
                return ir.decode(lay, _take(blk, gid - off))
            off += n
        raise IndexError(gid)

    def trace(self, gid: int) -> List[Tuple]:
        """Witness trace (label, state) chain — the Engine.trace
        contract, replayed from the per-job archives."""
        if self._engine is not None:
            return self._engine.trace(gid)
        if self._archives is None:
            raise ValueError(f"job {self.job.label!r}: no trace "
                             "archives (store_states off or cache hit)")
        parents_l, lanes_l, _states, labels, _lay = self._archives
        parents = np.concatenate(parents_l)
        lanes = np.concatenate(lanes_l)
        chain = []
        g = gid
        while g >= 0:
            lane = int(lanes[g])
            label = labels[lane] if lane >= 0 else "Init"
            chain.append((label, self.get_state(g)[0]))
            g = int(parents[g])
        return list(reversed(chain))

    def cache_payload(self) -> Dict:
        return dict(self.report)

    @classmethod
    def _from_cache(cls, job: Job, payload: Dict) -> "JobOutcome":
        report = dict(payload)
        report["status"] = "cache_hit"
        report["label"] = job.label
        return cls(job, "cache_hit", report=report)


class BatchReport:
    """run_jobs' return value: outcomes in submission order and the
    batch's meta counters (buckets, engines, dispatches, cache hits,
    fallbacks)."""

    def __init__(self, outcomes: List[JobOutcome], meta: Dict,
                 seconds: float):
        self.outcomes = outcomes
        self.meta = dict(meta)
        self.meta["seconds"] = round(seconds, 3)

    @property
    def summary(self) -> Dict:
        return {"kind": "batch_summary", **self.meta,
                "violations": sum(int(o.report.get("violations", 0))
                                  for o in self.outcomes
                                  if o is not None)}


# ---------------------------------------------------------------------------
# report assembly
# ---------------------------------------------------------------------------

def _build_report(job: Job, res, status: str, reason=None,
                  tracer=None) -> Dict:
    ir = spec_of(job.cfg)
    out = check_stats(res.metrics.as_dict(), res.seconds,
                      len(res.violations),
                      fp_bits=128 if getattr(job.cfg, "fp128", False)
                      else 64,
                      spec=ir.name, ir_fp=ir.fingerprint())
    out["label"] = job.label
    out["status"] = status
    if reason:
        out["status_reason"] = reason
    out["cfg_fingerprint"] = job.cfg_fingerprint()
    out["opts_fingerprint"] = job.opts_fingerprint()
    out["cache_key"] = job.cache_key()
    out["level_sizes"] = [int(x) for x in res.level_sizes]
    det = []
    for v in res.violations[:8]:
        d = {"invariant": v.invariant, "state_id": int(v.state_id)}
        if tracer is not None and v.state_id >= 0:
            d["trace"] = [lbl for lbl, _sv in tracer(v.state_id)]
        det.append(d)
    out["violations_detail"] = det
    return out


def _job_row(obs, outcome: JobOutcome):
    if obs.ledger is None:
        return
    rec = dict(outcome.report)
    rec["kind"] = "job"
    obs.ledger.record(rec)


def _jobs_map(runs: List[_JobRun]) -> Dict[str, Dict]:
    return {run.job.label: {"depth": int(run.depth),
                            "distinct": int(run.res.distinct_states),
                            "status": run.status}
            for run in runs}


# ---------------------------------------------------------------------------
# SLO accounting: per-job wait (submission -> first wave entry) and
# service (wave entry -> answer) seconds, folded into fixed-bucket
# histograms the heartbeat carries
# ---------------------------------------------------------------------------

_SLO_EDGES = (0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0)


def slo_histogram(seconds: List[float]) -> Dict[str, int]:
    """Fixed latency buckets: each key is a bucket's inclusive upper
    edge, 'inf' takes the tail."""
    hist = {f"le_{e:g}": 0 for e in _SLO_EDGES}
    hist["inf"] = 0
    for s in seconds:
        for e in _SLO_EDGES:
            if s <= e:
                hist[f"le_{e:g}"] += 1
                break
        else:
            hist["inf"] += 1
    return hist


class _SloTracker:
    """The batch's SLO state: submission time, finished jobs'
    wait/service samples, and the live snapshot dict (updated in place:
    every wave dispatch carries it into the heartbeat)."""

    def __init__(self, n_jobs: int):
        self.t_submit = time.perf_counter()
        self.waits: List[float] = []
        self.services: List[float] = []
        self.snapshot: Dict = {"queue_depth": n_jobs,
                               "jobs_done": 0,
                               "wait_hist": slo_histogram([]),
                               "service_hist": slo_histogram([])}

    def job_entered(self, run: "_JobRun"):
        run.wait_s = run._t0 - self.t_submit

    def job_done(self, wait_s: float, service_s: float):
        self.waits.append(max(0.0, float(wait_s)))
        self.services.append(max(0.0, float(service_s)))
        self.snapshot["jobs_done"] = len(self.services)
        self.snapshot["wait_hist"] = slo_histogram(self.waits)
        self.snapshot["service_hist"] = slo_histogram(self.services)

    def set_queue_depth(self, n: int):
        self.snapshot["queue_depth"] = max(0, int(n))


# ---------------------------------------------------------------------------
# the bucket engine
# ---------------------------------------------------------------------------

class BucketEngine:
    """One batched checker per (spec, ceiling cfg, params) bucket.
    Wraps an ordinary ``Engine`` for the ceiling config and drives its
    job-axis burst; never calls ``Engine.check``.

    Per padded wave width JP it keeps one ``engine/bfs._JobRing`` and
    one captured graph of the batched body (on the card: the first
    dispatch of a new JP warms the body up and captures it, inside the
    ``bucket_compile`` span).  A wave's jobs are loaded into the ring
    before its first dispatch, and their gates before each dispatch;
    nothing is copied from the host inside a replay."""

    def __init__(self, cfg, chunk: int = 128, vcap: int = 1 << 15,
                 burst_levels: int = 8, delta_matmul: bool = True,
                 sym_canon: str = "auto", exec_cache=None,
                 device: Optional[str] = None):
        from ..engine.bfs import Engine
        from .exec_cache import port_exec_cache
        # only the port's serializer (which revives nothing) may back a
        # bucket: ValueError for any other
        self.exec_cache = port_exec_cache(exec_cache)
        # store_states stays off on the engine: serve harvests its own
        # per-job archives from the burst's outputs
        self.eng = Engine(cfg, chunk=chunk, store_states=False,
                          vcap=vcap, burst_levels=burst_levels,
                          delta_matmul=delta_matmul,
                          sym_canon=sym_canon, device=device)
        self.KB = self.eng._burst_width()
        self.VCAP = self.eng.VCAP
        # padded ceilings: with a serve_runtime hook every job's guard
        # thresholds, lane mask and search bounds enter the burst as
        # device data; cfg here is the bucket's ceiling
        self.rt_mode = self.eng.ir.serve_runtime is not None
        self._rt_cache: Dict[str, Dict] = {}
        self._rings: Dict[int, object] = {}
        # the wave widths JP this engine has a program for: its first
        # dispatch of a new JP warms up and captures one (on the card)
        self._programs: set = set()
        # run_wave hands it the run's obs bundle
        self._graphs = GraphRunner(self.eng.device, True,
                                   span="bucket_compile")

    def _rt_of(self, cfg) -> Dict[str, np.ndarray]:
        """One job's runtime arrays under this bucket's ceiling
        expander, kept per config repr (a parked or restored job
        re-enters with the same arrays)."""
        key = repr(cfg)
        rt = self._rt_cache.get(key)
        if rt is None:
            rt = self._rt_cache[key] = \
                self.eng.ir.serve_runtime(self.eng.expander, cfg)
        return rt

    def _exec_key_parts(self, JP: int) -> Dict:
        """Every identity of the (bucket, JP) program — the reference's
        key parts over this engine's fields (serve/exec_cache).  The
        ceiling cfg repr covers the predicate lists, symmetry and fp128;
        the engine fields cover the program's static shapes and modes.
        The reference's ``donate`` part is absent: this package donates
        no buffers, so there is no donation mode to tell apart."""
        from ..obs.resources import backend_fingerprint
        from .exec_cache import code_fingerprint
        eng = self.eng
        return {
            "backend": backend_fingerprint(eng.device),
            "code": code_fingerprint(),
            "spec": eng.ir.name,
            "ir_fingerprint": eng.ir.fingerprint(),
            "ceiling_cfg": repr(eng.cfg),
            "JP": JP,
            "chunk": eng.chunk, "KB": self.KB, "VCAP": self.VCAP,
            "FCAP": eng.FCAP, "OCAP": eng.OCAP,
            "burst_levels": eng.burst_levels,
            "fam_caps": list(eng.FAM_CAPS),
            "W": eng.W,
            "guard_matmul": eng.guard_matmul,
            "delta_matmul": eng.expander.delta_active,
            # the resolved canonicalization mode: sort and minperm give
            # different programs and different table values
            "sym_canon": eng.fpr.sym_canon,
            "incremental_fp": bool(eng.incremental_fp and
                                   eng.fpr.supports_incremental()),
            "rt_mode": self.rt_mode,
            # one device: the reference's "off" wave mesh
            "wave_mesh": 0,
        }

    def _ring(self, JP: int):
        from ..engine.bfs import _JobRing
        r = self._rings.get(JP)
        if r is None:
            r = self._rings[JP] = _JobRing(self.eng, JP, self.VCAP,
                                           self.rt_mode)
        return r

    # -- root admission ------------------------------------------------

    def _admit(self, run: _JobRun):
        """Level-0 admission for one job, the host-side twin of the
        solo engine's fresh start (roots dedup, invariants and
        constraints, archive, table placement).  Returns the job's init
        dict (host arrays), or None when the roots cannot enter the
        batched path."""
        from ..engine.bfs import Violation
        eng = self.eng
        roots, rk, _pins = eng._dedup_roots(run.job.seed_states)
        n = len(rk)
        if n > min(self.KB, int(eng._LOAD_MAX * self.VCAP)):
            run.mark_fallback(
                f"{n} root states exceed the bucket ring/table")
            return None
        rows = rows_to_torch(roots, eng.device, eng.ir.u32_keys)
        narrow = eng.ir.narrow(eng.lay, rows)
        narrow_mj = storage_rows_to_numpy(narrow, eng.ir.u32_keys)
        # root constraints gate level-0 expansion: they read the job's
        # bounds, not the ceiling's
        rtb = self._rt_of(run.job.cfg)["bounds"] if self.rt_mode else None
        inv_r, con_r = eng._phase2_T(rows, rtb)
        inv_r, con_r = inv_r.cpu().numpy().T, con_r.cpu().numpy()
        res = run.res
        res.distinct_states = n
        res.generated_states = n
        res.overflow_faults = int(
            (np.asarray(roots["ctr"])[:, C_OVERFLOW] > 0).sum())
        res.violations_global = int((~inv_r).sum())
        eng._stamp_mode(res)
        if run.job.store_states:
            run.parents.append(np.full((n,), -1, np.int32))
            run.lanes.append(np.full((n,), -1, np.int32))
            run.states.append({k: v.copy()
                               for k, v in narrow_mj.items()})
        for jx, nm in enumerate(eng.inv_names):
            for s in np.nonzero(~inv_r[:, jx])[0]:
                vsv, vh = eng.ir.decode(eng.lay, _take(narrow_mj,
                                                       int(s)))
                res.violations.append(
                    Violation(nm, int(s), state=vsv, hist=vh))
        run.n_states = n
        run.n_front = n
        # the job is born finished when its gates already close
        if run.job.max_depth <= 0 or \
                res.distinct_states >= run.job.max_states or \
                (run.job.stop_on_violation and res.violations):
            run.finish()
        fr = {k: np.zeros(v.shape[1:] + (self.KB,), v.dtype)
              for k, v in narrow_mj.items()}
        for k in fr:
            fr[k][..., :n] = np.moveaxis(narrow_mj[k], 0, -1)
        fm = np.zeros((self.KB,), bool)
        fm[:n] = con_r
        vis = np.full((eng.W, self.VCAP), U32MAX_NP, np.uint32)
        slots = eng._host_probe_assign(rk, vcap=self.VCAP)
        for w in range(eng.W):
            vis[w][slots] = rk[:, w]
        return dict(fr=fr, fm=fm, vis=vis, nf=n, g=n)

    def _pad_init(self):
        """A frozen placeholder job (nf=0): pads a wave to its
        power-of-two width without contributing any work."""
        eng = self.eng
        one = storage_rows_to_numpy(eng.ir.narrow(eng.lay, rows_to_torch(
            {k: np.asarray(v)[None] for k, v in eng.ir.encode(
                eng.lay, *eng.ir.init_state(eng.cfg)).items()},
            "cpu", eng.ir.u32_keys)), eng.ir.u32_keys)
        fr = {k: np.zeros(v.shape[1:] + (self.KB,), v.dtype)
              for k, v in one.items()}
        fm = np.zeros((self.KB,), bool)
        vis = np.full((eng.W, self.VCAP), U32MAX_NP, np.uint32)
        out = dict(fr=fr, fm=fm, vis=vis, nf=0, g=0)
        if self.rt_mode:
            # the ceiling's own (all-enabled) data: the pad lane is
            # frozen (nf=0) whatever it holds
            out["rt"] = self._rt_of(eng.cfg)
        return out

    def _pad_jp(self, n: int) -> int:
        """Wave width for n admitted jobs: the next power of two."""
        return _next_pow2(n)

    def _stack(self, inits):
        """Load a wave's init dicts (host arrays) into the ring of its
        width, one copy per buffer; gd/pg default to the fresh-start
        values, a parked or restored init brings its own."""
        eng, dev = self.eng, self.eng.device
        JP = len(inits)
        r = self._ring(JP)
        gd0 = np.arange(self.KB, dtype=np.int64)

        def put(dst, arr):
            dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(dev))

        vis = np.stack([np.asarray(it["vis"], np.uint32)
                        for it in inits]).reshape(JP, -1)
        tab = np.full((JP, vis.shape[1] + 1), -1, np.int32)
        tab[:, :-1] = vis.view(np.int32)
        put(r.vis, tab)
        for k, v in r.fr.items():
            a = np.stack([np.asarray(it["fr"][k]) for it in inits])
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            put(v, a)
        put(r.fm, np.stack([np.asarray(it["fm"], bool) for it in inits]))
        put(r.gd, np.stack([np.asarray(it.get("gd", gd0), np.int64)
                            for it in inits]))
        put(r.nf, np.array([it["nf"] for it in inits], np.int64))
        put(r.g, np.array([it["g"] for it in inits], np.int64))
        put(r.pg, np.array([int(it.get("pg", 0)) for it in inits],
                           np.int64))
        if self.rt_mode:
            for nm in ("thr", "mask", "bounds"):
                put(r.rt[nm], np.stack([np.asarray(it["rt"][nm])
                                        for it in inits]))
        return r

    def _job_slice(self, r, k: int) -> Dict:
        """Job k's lane of the ring -> a host init dict (the _stack /
        _admit format plus gd/pg, in the reference's dtypes): the
        parkable and persistable per-job wave state."""
        u32 = self.eng.ir.u32_keys
        return dict(
            fr=storage_to_numpy({nm: v[k] for nm, v in r.fr.items()}, u32),
            fm=r.fm[k].cpu().numpy().copy(),
            vis=words_to_numpy(r.table(k)),
            gd=r.gd[k].cpu().numpy().astype(np.int32),
            nf=int(r.nf[k]), g=int(r.g[k]), pg=int(r.pg[k]))

    # -- the wave loop -------------------------------------------------

    def run_wave(self, runs: List[_JobRun], obs, meta: Dict,
                 jobs_ctx: Optional[Dict] = None,
                 verbose: bool = False,
                 max_steps: Optional[int] = None,
                 wave_state: Optional[WaveStateStore] = None,
                 slo_ctx: Optional[Dict] = None,
                 stop=None):
        """Run up to a wave of jobs through the batched burst.  Mutates
        the runs in place; jobs that bail are marked for the solo
        fallback.  ``jobs_ctx`` is the batch's per-job status map (the
        heartbeat payload) this wave merges its statuses into.

        ``max_steps`` — preemption: after that many batched dispatches
        the still-live jobs PARK (their carry slice moves to
        ``run.preinit``) and the wave returns, yielding its lanes to
        waiting jobs.  ``wave_state`` persists every live job's slice at
        each wave boundary, so a killed process resumes them mid-BFS.
        ``stop`` — a callable checked at every boundary after the
        persist; when true, live jobs park as for ``max_steps``."""
        eng = self.eng
        self._graphs.obs = obs
        with obs.span("job_admit"):
            admitted = []
            for run in runs:
                if run.preinit is not None:
                    # parked/restored job: enter with its carry slice,
                    # not root admission (counters already accrued)
                    init, run.preinit = run.preinit, None
                    eng._stamp_mode(run.res)
                else:
                    init = self._admit(run)
                if init is not None:
                    if self.rt_mode:
                        # rt is derived from the job's config, never
                        # persisted: parked/restored carries re-attach it
                        init["rt"] = self._rt_of(run.job.cfg)
                    admitted.append((run, init))
        if not any(run.live for run, _ in admitted):
            for run, _ in admitted:
                if not run.fallback:
                    run.finish()
            return
        JP = self._pad_jp(len(admitted))
        inits = [init for _run, init in admitted]
        inits += [self._pad_init()] * (JP - len(admitted))
        r = self._stack(inits)
        wave_occ = {"devices": 1, "lanes": JP,
                    "filled": len(admitted),
                    "pad": JP - len(admitted),
                    "jobs_per_device": JP,
                    "state_shards": 1}
        meta["wave_devices"] = max(meta.get("wave_devices", 0), 1)
        meta["wave_lanes"] = max(meta.get("wave_lanes", 0), JP)
        meta["wave_state_shards"] = max(
            meta.get("wave_state_shards", 0), 1)
        steps = 0
        while any(run.live for run, _ in admitted):
            # chaos site: a dispatch-time device error on the batched
            # program (the batch-level --retries re-runs the job list;
            # the cache and the wave state make the retry incremental)
            chaos_point("dispatch")
            lv = np.zeros((JP,), np.int32)
            cap = np.ones((JP,), np.int32)
            for k, (run, _) in enumerate(admitted):
                if run.live:
                    lv[k] = min(eng.burst_levels,
                                run.job.max_depth - run.depth)
                    cap[k] = max(1, min(
                        run.job.max_states - run.res.distinct_states,
                        2 ** 31 - 1))
            fresh = JP not in self._programs
            key = parts = None
            if fresh and self.exec_cache is not None:
                # the persistent program cache, in the reference's
                # order: load, capture, store.  The port's serializer
                # revives nothing, so the load is a named miss and the
                # capture below always runs
                from .exec_cache import exec_key
                parts = self._exec_key_parts(JP)
                key = exec_key(parts)
                with obs.span("bucket_exec_load"):
                    self.exec_cache.load(key, parts)
            with obs.span("batched_dispatch"):
                # a new JP's first replay is its warm-up and capture,
                # inside the bucket_compile span (engine/graph.py)
                stats = eng.burst_batched(r, self._graphs, lv, cap)
            if fresh:
                self._programs.add(JP)
                if self.exec_cache is not None:
                    # a counted, named failure: a CUDA graph cannot be
                    # written to disk (on the CPU nothing was captured)
                    with obs.span("bucket_exec_store"):
                        self.exec_cache.store(
                            key, self._graphs.program(("batched", JP)),
                            parts)
            meta["batch_dispatches"] += 1
            with obs.span("job_harvest"):
                for k, (run, _) in enumerate(admitted):
                    if not run.live:
                        continue
                    # archives come back per job, and only for jobs
                    # that keep traces or hit a violation
                    need = run.job.store_states or stats[k, -1, 3]
                    arch = (None, None, None, None)
                    if need:
                        arch = (r.opar[k].cpu().numpy(),
                                r.olane[k].cpu().numpy(),
                                r.oinv[k].cpu().numpy(),
                                storage_to_numpy(
                                    {nm: v[k] for nm, v in r.ost.items()},
                                    eng.ir.u32_keys))
                    self._harvest(run, stats[k], *arch)
            steps += 1
            if wave_state is not None:
                # wave boundary: persist every live job's carry slice
                # and book, so a kill before the next boundary resumes
                # mid-BFS (finished jobs are in the result cache)
                with obs.span("wave_persist"):
                    for k, (run, _) in enumerate(admitted):
                        if run.live:
                            run.preinit = self._job_slice(r, k)
                            wave_state.save(run.job.cache_key(),
                                            run.wave_arrays(),
                                            run.book())
                            run.preinit = None
            # chaos site: the stand-in for a kill, AFTER the persist
            chaos_point("wave_kill")
            if ((max_steps is not None and steps >= max_steps) or
                    (stop is not None and stop())) and \
                    any(run.live for run, _ in admitted):
                # preemption: park the live jobs' carry slices and yield
                # the lanes; the scheduler requeues them into a later wave
                for k, (run, _) in enumerate(admitted):
                    if run.live:
                        run.preinit = self._job_slice(r, k)
                        run.parked = True
            live_runs = [run for run, _ in admitted]
            jobs_map = dict(jobs_ctx or {})
            jobs_map.update(_jobs_map(live_runs))
            if jobs_ctx is not None:
                jobs_ctx.update(jobs_map)
            obs.dispatch(
                kind="batch",
                depth=max((r_.depth for r_ in live_runs), default=0),
                frontier=sum(r_.n_front for r_ in live_runs if r_.live),
                metrics={
                    "distinct_states": sum(
                        int(r_.res.distinct_states) for r_ in live_runs),
                    "generated_states": sum(
                        int(r_.res.generated_states)
                        for r_ in live_runs)},
                jobs=jobs_map, slo=slo_ctx, wave=wave_occ)
            if verbose:
                done = sum(1 for r_ in live_runs if not r_.live)
                print(f"batch wave: {done}/{len(live_runs)} jobs done, "
                      f"max depth "
                      f"{max((r_.depth for r_ in live_runs), default=0)}")
            if any(run.parked for run, _ in admitted):
                break

    def _harvest(self, run: _JobRun, sj, par_j, lane_j, inv_j, st_j):
        """One job's slice of a batched dispatch: the solo burst harvest
        (the shared ``engine/driver`` loop: depth gating, the pseudo-
        level skip, archive rows, violation decode)."""
        from ..engine import driver
        eng = self.eng
        res = run.res
        nlev = int(sj[-1, 0])
        bailed = bool(sj[-1, 1])
        res.burst_dispatches += 1
        res.burst_bailouts += int(bailed)
        if bailed:
            # the job outgrew its ring, table or family caps: drop the
            # batched progress and re-run it solo (the solo engine owns
            # every growth path).  Exact by construction.
            run.mark_fallback("burst bailed (per-job ring or table "
                              "overflow) — re-run sequentially")
            return

        def _arch(li, n_lvl):
            if not run.job.store_states:
                return
            # zero-row levels still take an archive slot, so gid
            # arithmetic matches the solo archives
            par, lane, states = driver.burst_archive_slice(
                par_j, lane_j, st_j, li, n_lvl)
            run.parents.append(par)
            run.lanes.append(lane)
            run.states.append(states)

        def _viol(li, n_lvl, gid_base):
            driver.burst_decode_violations(
                res, eng.ir, eng.lay, eng.inv_names, inv_j, st_j,
                li, n_lvl, gid_base)

        # per-job ids never approach 2^31: no id guard, as the reference
        run.depth, run.n_states = driver.harvest_fused_levels(
            res, nlev, lambda li: sj[li, :5], run.depth, run.n_states,
            archive=_arch, violations=_viol, id_guard=False)
        run.n_front = int(sj[-1, 2])
        if run.n_front == 0 or run.depth >= run.job.max_depth or \
                res.distinct_states >= run.job.max_states or \
                (run.job.stop_on_violation and res.violations):
            run.finish()
        elif nlev == 0:
            # a live job that neither committed a level nor bailed would
            # spin this loop forever: route it to the solo path
            run.mark_fallback("batched call made no progress")


# ---------------------------------------------------------------------------
# the solo path and the entry point
# ---------------------------------------------------------------------------

def _run_solo(job: Job, obs, meta: Dict, status: str,
              reason: Optional[str], sym_canon: str = "auto",
              device: Optional[str] = None) -> JobOutcome:
    """One job on its own Engine (the sequential path): ``--sequential``
    runs, batched-path fallbacks, and seeded/pinned jobs.  Its
    dispatches ride the same obs bundle; ``sym_canon`` follows any
    bucket override, so a fallback dedups as its bucket would have."""
    from ..engine.bfs import Engine
    with obs.span("sequential_job"):
        eng = Engine(job.cfg, store_states=job.store_states,
                     sym_canon=sym_canon, device=device)
        meta["engines_compiled"] += 1
        res = eng.check(max_depth=job.max_depth,
                        max_states=job.max_states,
                        stop_on_violation=job.stop_on_violation,
                        seed_states=job.seed_states, obs=obs)
    tracer = eng.trace if job.store_states else None
    report = _build_report(job, res, status, reason=reason,
                           tracer=tracer)
    return JobOutcome(job, status, res=res, report=report, engine=eng,
                      reason=reason)


def run_jobs(jobs: List[Job], cache=None, obs=None,
             sequential: bool = False, bucket_overrides=None,
             verbose: bool = False, wave_state=None,
             wave_yield: Optional[int] = None,
             max_wave: Optional[int] = None,
             exec_cache=None, wave_mesh=None,
             device: Optional[str] = None) -> BatchReport:
    """Serve a job list: cache lookups, shape buckets, batched waves,
    solo fallbacks, cache fill.  Returns a BatchReport with outcomes in
    submission order.

    sequential=True skips the batched path (one solo Engine per job).
    bucket_overrides overrides the per-spec bucket params (tests force
    tiny rings with it to exercise the fallback).  Jobs run by
    descending ``Job.priority`` (stable on submission order);
    ``wave_yield=N`` makes a wave yield its lanes after N batched
    dispatches while other jobs wait; ``wave_state`` (a WaveStateStore
    or a directory) persists live jobs' carries at wave boundaries and
    resumes them on the next call; ``max_wave`` caps the jobs per wave
    (default 8).  ``wave_mesh``: "auto"/"off"/0/1 (one device; a larger
    mesh is refused, ROADMAP item 9d).  ``exec_cache`` (an ``ExecCache``
    or a directory) counts each bucket program's load and store; on
    this backend every store fails by name (serve/exec_cache).
    ``device``: cuda by default.

    A thin wrapper over ``serve/scheduler.WaveScheduler``, which holds
    every scheduling rule."""
    from .scheduler import WaveScheduler
    return WaveScheduler(
        cache=cache, wave_state=wave_state, exec_cache=exec_cache,
        bucket_overrides=bucket_overrides, wave_yield=wave_yield,
        max_wave=max_wave, wave_mesh=wave_mesh, device=device).serve(
        jobs, obs=obs, sequential=sequential, verbose=verbose)
