"""Metrics registry: the one store for a run's scalar counters (the
reference's ``raft_tla_tpu/obs/metrics.py``).

- ``MetricsRegistry`` holds the counters; ``engine.bfs.CheckResult``
  exposes them as write-through attribute views, so a harvest loop
  mutating ``res.levels_fused`` is updating the registry — the ledger,
  ``--stats-json`` and checkpoint meta read one store;
- ``check_stats`` / ``sim_stats`` are the single assemblers of the
  ``check`` and ``simulate`` stats payloads (the stdout line and
  ``--stats-json``), with the reference CLI's keys in its order.

Keys are registered once (``register``) and unknown-key writes raise —
a typo'd counter fails loudly instead of forking a new silent copy.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

# the counter set every exhaustive-check engine accumulates (the
# classic and the spill engine share CheckResult)
CHECK_COUNTER_KEYS = (
    "distinct_states", "generated_states", "depth", "overflow_faults",
    "violations_global", "levels_fused", "burst_dispatches",
    "burst_bailouts", "pin_interior_states", "guard_matmul",
    "dedup_kernel", "delta_matmul", "sym_canon")

# the mode flags (0/1): which expansion and dedup program this run
# executed — the guard product, the hand dedup kernel (1 on the card,
# 0 for its plain twin on the CPU), the delta group, and 1 = orbit-sort
# canonical fingerprints, 0 = min-over-perms.  Stamped live by the
# engine's ``_stamp_mode`` (never from a checkpoint: a resumed run
# reports the resuming engine's modes)
MXU_COUNTER_KEYS = ("guard_matmul", "dedup_kernel", "delta_matmul",
                    "sym_canon")

# the burst telemetry triple that must agree between the ledger,
# --stats-json and checkpoint meta
BURST_COUNTER_KEYS = ("levels_fused", "burst_dispatches",
                      "burst_bailouts")

# the random-walk engine's counter set (SimResult fields surfaced by
# sim_stats and the simulate ledger's final record)
SIM_COUNTER_KEYS = (
    "walkers", "steps_dispatched", "walker_steps", "sampled_steps",
    "restarts", "deadlocks", "promotions", "hits",
    "est_distinct_states", "bloom_saturated", "bloom_canonical")

# the per-dispatch subset knowable without reading the Bloom back
SIM_DISPATCH_KEYS = (
    "walkers", "steps_dispatched", "walker_steps", "sampled_steps",
    "restarts", "deadlocks", "promotions", "hits")


class MetricsRegistry:
    """A named-counter store with explicit registration.

    ``register`` declares a counter once; ``set``/``inc`` update it and
    raise ``KeyError`` on undeclared names, so every counter any code
    path reports must appear in the declared set.
    """

    __slots__ = ("_vals",)

    def __init__(self, initial: Optional[Mapping] = None):
        self._vals: Dict[str, object] = {}
        if initial:
            for k, v in initial.items():
                self.register(k, v)

    def register(self, name: str, value=0):
        if name in self._vals:
            raise ValueError(f"metric {name!r} already registered")
        self._vals[name] = value

    def set(self, name: str, value):
        if name not in self._vals:
            raise KeyError(
                f"metric {name!r} not registered (known: "
                f"{', '.join(sorted(self._vals))})")
        self._vals[name] = value

    def inc(self, name: str, delta=1):
        self.set(name, self._vals[name] + delta)

    def get(self, name: str):
        return self._vals[name]

    def __contains__(self, name: str) -> bool:
        return name in self._vals

    def keys(self):
        return tuple(self._vals.keys())

    def as_dict(self) -> Dict[str, object]:
        """Snapshot in registration order."""
        return dict(self._vals)


def check_stats(counters: Mapping, seconds: float, n_violations: int,
                fp_bits: Optional[int] = None,
                spec: Optional[str] = None,
                ir_fp: Optional[str] = None) -> Dict[str, object]:
    """The ``check`` stats payload (stdout line and ``--stats-json``),
    assembled from a counter mapping (``CheckResult.metrics.as_dict()``
    for the engines; a hand-built dict for the oracle, which has no
    registry).

    The fingerprint, burst and mode keys appear only when ``fp_bits`` is
    given (the oracle has no notion of them), ``pin_interior_states``
    only when nonzero, the spec name and its IR fingerprint last.
    """
    distinct = int(counters["distinct_states"])
    gen = int(counters["generated_states"])
    out = {
        "distinct_states": distinct,
        "generated_states": gen,
        "depth": int(counters["depth"]),
        "seconds": round(float(seconds), 3),
        "states_per_sec": round(distinct / max(seconds, 1e-9), 1),
        "dedup_hit_rate": round(1.0 - distinct / max(gen, 1), 4),
        "violations": int(n_violations),
    }
    if int(counters.get("pin_interior_states", 0) or 0):
        out["pin_interior_states"] = int(counters["pin_interior_states"])
    if fp_bits is not None:
        # dedup is fingerprint-based (TLC semantics): the expected
        # collision bound the exhaustiveness claim rests on,
        # E[collisions] <= n^2 / 2^(b+1)
        out["fp_bits"] = int(fp_bits)
        out["expected_fp_collisions"] = float(
            distinct * distinct / 2.0 ** (fp_bits + 1))
        for k in BURST_COUNTER_KEYS:
            out[k] = int(counters[k])
        for k in MXU_COUNTER_KEYS:
            out[k] = int(counters.get(k, 0) or 0)
    if spec is not None:
        out["spec"] = spec
        if ir_fp is not None:
            out["ir_fingerprint"] = ir_fp
    return out


def sim_counters(res) -> Dict[str, object]:
    """A SimResult's counter snapshot (SIM_COUNTER_KEYS order)."""
    return {
        "walkers": int(res.walkers),
        "steps_dispatched": int(res.steps_dispatched),
        "walker_steps": int(res.walker_steps),
        "sampled_steps": int(res.sampled_steps),
        "restarts": int(res.restarts),
        "deadlocks": int(res.deadlocks),
        "promotions": int(res.promotions),
        "hits": len(res.hits),
        "est_distinct_states": round(float(res.est_distinct_states), 1),
        "bloom_saturated": bool(res.bloom_saturated),
        "bloom_canonical": bool(res.bloom_canonical),
    }


def sim_stats(res, target: str, policy: str, seed: int,
              platform: str) -> Dict[str, object]:
    """The ``simulate`` stats payload, with the reference CLI's keys in
    its order."""
    c = sim_counters(res)
    return {
        "target": target,
        "policy": policy,
        "walkers": c["walkers"],
        "steps_dispatched": c["steps_dispatched"],
        "walker_steps": c["walker_steps"],
        "sampled_steps": c["sampled_steps"],
        "walker_steps_per_sec": round(res.walker_steps_per_sec, 1),
        "restarts": c["restarts"],
        "deadlocks": c["deadlocks"],
        "promotions": c["promotions"],
        "seconds": round(float(res.seconds), 3),
        "est_distinct_states": c["est_distinct_states"],
        "bloom_saturated": c["bloom_saturated"],
        "bloom_canonical": c["bloom_canonical"],
        "hits": c["hits"],
        "platform": platform,
        "seed": seed,
    }
