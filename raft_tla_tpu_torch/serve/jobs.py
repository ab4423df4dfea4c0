"""Job objects for the batched serving layer (the reference's
``serve/jobs.py``).

A ``Job`` is one user request: a model config plus the engine options
that shape the *result* (depth/state gates, stop-on-violation, trace
retention).  Jobs carry three fingerprints:

- the active spec's IR structure fingerprint (``SpecIR.fingerprint``),
- the config fingerprint — sha256 of ``repr(cfg)``, the same canonical
  identity string checkpoint resume compares byte-for-byte,
- the engine-options fingerprint — sha256 of the canonical JSON of the
  result-affecting options above (and a digest of any seed states).

Their concatenation is the result-cache key (serve/cache): two jobs
with equal keys are guaranteed the same ``CheckResult``, so a repeat
job is answered without any device dispatch.  All three equal the
reference's for the same job, so a cache directory written by either
package answers jobs in the other.

``job_from_dict`` parses the JSONL job format the ``batch`` command
consumes (README "Batch / serving on the H100"); every unknown key
errors by name, with the reference's messages.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..spec import SpecIR, spec_of


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


@dataclass
class Job:
    """One check request.  ``cfg`` is a model config object (raft
    ``ModelConfig`` or ``PaxosConfig``); the rest are the engine
    options that affect the result.  Options that only shape the
    execution (chunk sizes, burst toggles) are bucket properties, not
    job ones — they cannot change the answer, so they stay out of the
    options fingerprint."""

    cfg: object
    max_depth: int = 10 ** 9
    max_states: int = 10 ** 9
    stop_on_violation: bool = True
    store_states: bool = True
    label: str = ""
    # engine seed SoA dicts (punctuated search) — batched waves route
    # seeded jobs to the sequential fallback; still cacheable (the
    # seed digest rides the options fingerprint)
    seed_states: Optional[List] = None
    # wave-scheduling priority (higher runs first): a
    # SCHEDULING property, not a result one — deliberately outside the
    # options fingerprint so priority changes never miss the cache
    priority: int = 0

    def __post_init__(self):
        if self.max_depth < 0:
            raise ValueError(f"max_depth must be >= 0 "
                             f"(got {self.max_depth})")
        if self.max_states < 0:
            raise ValueError(f"max_states must be >= 0 "
                             f"(got {self.max_states})")

    @property
    def ir(self) -> SpecIR:
        return spec_of(self.cfg)

    def cfg_fingerprint(self) -> str:
        return _sha(repr(self.cfg))

    def opts_fingerprint(self) -> str:
        opts = {"max_depth": int(self.max_depth),
                "max_states": int(self.max_states),
                "stop_on_violation": bool(self.stop_on_violation),
                "store_states": bool(self.store_states)}
        if self.seed_states is not None:
            import numpy as np
            h = hashlib.sha256()
            for seed in self.seed_states:
                for k in sorted(seed):
                    h.update(k.encode())
                    h.update(np.ascontiguousarray(
                        np.asarray(seed[k])).tobytes())
            opts["seeds"] = h.hexdigest()[:16]
        return _sha(json.dumps(opts, sort_keys=True))

    def cache_key(self) -> str:
        ir = self.ir
        return "-".join((ir.name, ir.fingerprint(),
                         self.cfg_fingerprint(),
                         self.opts_fingerprint()))


# ---------------------------------------------------------------------------
# JSONL job format (the `batch` command)
# ---------------------------------------------------------------------------

_TOP_KEYS = ("spec", "config", "overrides", "max_depth", "max_states",
             "keep_going", "store", "label", "priority")
_RAFT_OVERRIDES = ("servers", "values", "max_inflight", "next",
                   "symmetry", "invariants", "bounds")
_RAFT_BOUNDS = ("max_log_length", "max_restarts", "max_timeouts",
                "max_client_requests", "max_membership_changes",
                "max_terms", "max_trace")
_NEXT_NAMES = ("NextAsync", "NextAsyncCrash", "Next", "NextDynamic")


def _raft_cfg(config, overrides, where: str):
    from ..cfg.parser import load_model
    from ..config import Bounds
    from ..spec import get_spec
    if not isinstance(config, str):
        raise ValueError(
            f"{where}: raft jobs need 'config': a TLC .cfg path "
            f"(got {config!r})")
    cfg = load_model(config)
    ov = dict(overrides or {})
    unknown = sorted(set(ov) - set(_RAFT_OVERRIDES))
    if unknown:
        raise ValueError(
            f"{where}: unknown raft override(s) "
            f"{', '.join(map(repr, unknown))}; known: "
            f"{', '.join(_RAFT_OVERRIDES)}")
    kw = {}
    if "servers" in ov:
        n = int(ov["servers"])
        kw["n_servers"] = n
        kw["init_servers"] = tuple(range(n))
        # MaxInFlightMessages is a formula over |Server| in the spec;
        # recompute it exactly as the CLI --servers override does
        old_n, infl = cfg.n_servers, cfg.max_inflight_override
        if infl == 2 * old_n * old_n:
            kw["max_inflight_override"] = 2 * n * n
        elif infl == 4 * old_n * old_n:
            kw["max_inflight_override"] = 4 * n * n
    if "values" in ov:
        kw["values"] = tuple(int(v) for v in ov["values"])
    if "max_inflight" in ov:
        kw["max_inflight_override"] = int(ov["max_inflight"])
    if "next" in ov:
        if ov["next"] not in _NEXT_NAMES:
            raise ValueError(
                f"{where}: unknown NEXT family {ov['next']!r}; known: "
                f"{', '.join(_NEXT_NAMES)}")
        kw["next_family"] = ov["next"]
    if "symmetry" in ov:
        kw["symmetry"] = bool(ov["symmetry"])
    if "invariants" in ov:
        known = get_spec("raft").known_invariants
        bad = [nm for nm in ov["invariants"] if nm not in known]
        if bad:
            raise ValueError(
                f"{where}: unknown invariant(s) "
                f"{', '.join(map(repr, bad))} for spec 'raft'")
        kw["invariants"] = tuple(ov["invariants"])
    if "bounds" in ov:
        bd = dict(ov["bounds"])
        unknown = sorted(set(bd) - set(_RAFT_BOUNDS))
        if unknown:
            raise ValueError(
                f"{where}: unknown bounds key(s) "
                f"{', '.join(map(repr, unknown))}; known: "
                f"{', '.join(_RAFT_BOUNDS)}")
        b = cfg.bounds
        kw["bounds"] = Bounds.make(
            max_log_length=bd.get("max_log_length", b.max_log_length),
            max_restarts=bd.get("max_restarts", b.max_restarts),
            max_timeouts=bd.get("max_timeouts", b.max_timeouts),
            max_client_requests=bd.get("max_client_requests",
                                       b.max_client_requests),
            max_membership_changes=bd.get("max_membership_changes",
                                          b.max_membership_changes),
            # None derives MaxTerms = MaxTimeouts + 1, the spec formula
            max_terms=bd.get("max_terms"),
            max_trace=bd.get("max_trace", b.max_trace))
    return cfg.with_(**kw) if kw else cfg


def _paxos_cfg(config, where: str):
    from ..cfg.parser import load_paxos_model, paxos_config_from_obj
    from ..spec.paxos.config import PaxosConfig
    if config is None or config == "default":
        return PaxosConfig()
    if isinstance(config, dict):
        return paxos_config_from_obj(config, where=where)
    if isinstance(config, str):
        if config.endswith(".cfg"):
            return load_paxos_model(config)
        with open(config) as fh:
            return paxos_config_from_obj(json.load(fh), where=config)
    raise ValueError(
        f"{where}: paxos 'config' must be a constants object, a .cfg/"
        f"JSON path, or 'default' (got {config!r})")


def job_from_dict(obj: Dict, where: str = "job") -> Job:
    """One JSONL job record -> a Job.  Format:

      {"spec": "raft"|"paxos", "config": ..., "overrides": {...},
       "max_depth": N, "max_states": N, "keep_going": bool,
       "store": bool, "label": "name"}

    raft: config is a TLC .cfg path; overrides tweak the parsed model
    (servers/values/max_inflight/next/symmetry/invariants/bounds).
    paxos: config is an inline constants object, a .cfg or JSON path,
    or "default"; overrides are rejected (fold constants into config).
    Unknown keys error by name."""
    from ..spec import spec_names
    if not isinstance(obj, dict):
        raise ValueError(f"{where}: a job must be a JSON object "
                         f"(got {type(obj).__name__})")
    unknown = sorted(set(obj) - set(_TOP_KEYS))
    if unknown:
        raise ValueError(
            f"{where}: unknown job key(s) "
            f"{', '.join(map(repr, unknown))}; known: "
            f"{', '.join(_TOP_KEYS)}")
    spec = obj.get("spec", "raft")
    if spec not in spec_names():
        raise ValueError(f"{where}: unknown spec {spec!r}; known "
                         f"specs: {', '.join(spec_names())}")
    if spec == "paxos":
        if obj.get("overrides"):
            raise ValueError(
                f"{where}: 'overrides' is raft-only — fold paxos "
                "constants into 'config'")
        cfg = _paxos_cfg(obj.get("config"), where)
    else:
        cfg = _raft_cfg(obj.get("config"), obj.get("overrides"), where)
    for nm in ("max_depth", "max_states"):
        v = obj.get(nm)
        if v is not None and (isinstance(v, bool)
                              or not isinstance(v, int) or v < 0):
            raise ValueError(
                f"{where}: {nm} must be a non-negative integer "
                f"(got {v!r})")
    prio = obj.get("priority", 0)
    if isinstance(prio, bool) or not isinstance(prio, int):
        raise ValueError(
            f"{where}: priority must be an integer (higher runs "
            f"first; got {prio!r})")
    return Job(cfg,
               max_depth=obj.get("max_depth", 10 ** 9),
               max_states=obj.get("max_states", 10 ** 9),
               stop_on_violation=not obj.get("keep_going", False),
               store_states=bool(obj.get("store", True)),
               label=str(obj.get("label", "")),
               priority=prio)


def load_jobs(path: str) -> List[Job]:
    """Parse a JSONL job file (one job object per line; blank lines
    and #-comments skipped)."""
    jobs = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            where = f"{os.path.basename(path)}:{ln}"
            try:
                obj = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{where}: not a JSON object ({e})")
            jobs.append(job_from_dict(obj, where=where))
    return jobs
