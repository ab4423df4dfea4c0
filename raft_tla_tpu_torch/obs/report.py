"""Report engine: run records turned into verdicts (``cli obs``; the
reference's ``raft_tla_tpu/obs/report.py``).

The query half of the run registry: pure functions over run records,
with no engine, torch or CUDA import, so ``cli obs`` answers anywhere
in milliseconds.

- ``diff_runs(a, b)`` — a machine-readable comparison of two runs: a
  count and level-size **parity verdict** (``clean`` / ``mode_drift``
  / ``mismatch``), per-phase span deltas (seconds and ratio), the mode
  flags that differ, by name (``MXU_COUNTER_KEYS``: guard matmul,
  dedup kernel, delta matmul, sym canon), and resource-peak deltas.
  Equal counts under different flags is the A/B shape: that is
  ``mode_drift``, not ``mismatch``.
- ``regress(run, baseline, ...)`` — a run against a baseline: a
  committed bench row, a ``--stats-json`` payload or an earlier
  registry run; a regression on a count mismatch, and (opt-in, since
  wall-clock is noisy) on a per-phase span-time ratio.
- ``extract(rec)`` — the shape normaliser: registry records, flat
  stats dicts, bench headline objects (``detail``) and bench A/B rows
  (``phase_seconds``/``phase_counts``) all reduce to one
  ``{counters, level_sizes, spans, resources}`` view.
- ``format_span_totals`` — the one rendering of span rollups.

Their outputs equal the reference's on the same records.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .metrics import MXU_COUNTER_KEYS

__all__ = ["extract", "diff_runs", "regress", "format_span_totals",
           "PARITY_KEYS"]

# the count keys whose equality defines run parity (violations rides
# along when both sides carry it)
PARITY_KEYS = ("distinct_states", "generated_states", "depth")


def format_span_totals(totals: Dict[str, Dict]) -> str:
    """``compile=6.10s/1  harvest=0.52s/12`` — the shared rendering of
    ``SpanRecorder.totals()``-shaped rollups."""
    return "  ".join(f"{nm}={t['seconds']:.2f}s/{t['count']}"
                     for nm, t in sorted(totals.items()))


def extract(rec: Dict) -> Dict:
    """Normalize any supported record shape to
    ``{counters, level_sizes, spans, resources, info}``.

    Accepted shapes: a registry record (``counters`` dict), a flat
    stats payload (``--stats-json``: counts at top level), a bench
    headline object (descend into ``detail``), and a BENCH A/B row
    (``phase_seconds``/``phase_counts`` become span totals)."""
    if not isinstance(rec, dict):
        raise ValueError("run record is not a JSON object")
    if "detail" in rec and isinstance(rec["detail"], dict) \
            and "counters" not in rec \
            and "distinct_states" not in rec:
        rec = rec["detail"]
    if isinstance(rec.get("counters"), dict):
        counters = dict(rec["counters"])
    else:
        counters = {k: rec[k] for k in rec
                    if isinstance(rec[k], (int, float))
                    and not isinstance(rec[k], bool)}
    # registry records also carry depth/distinct at top level (from
    # finish()); let those fill counter gaps, never override
    for k in PARITY_KEYS + ("violations",):
        if k not in counters and isinstance(rec.get(k), (int, float)):
            counters[k] = rec[k]
    if "distinct" in rec and "distinct_states" not in counters:
        counters["distinct_states"] = rec["distinct"]   # deep_run rows
    spans = dict(rec.get("spans") or {})
    if not spans and isinstance(rec.get("phase_seconds"), dict):
        pc = rec.get("phase_counts") or {}
        spans = {nm: {"count": int(pc.get(nm, 0)),
                      "seconds": float(s)}
                 for nm, s in rec["phase_seconds"].items()}
    ls = rec.get("level_sizes")
    return {
        "counters": counters,
        "level_sizes": list(ls) if ls is not None else None,
        "spans": spans,
        "resources": dict(rec.get("resources") or {}),
        "info": {k: rec.get(k) for k in
                 ("run_id", "cmd", "spec", "status", "cfg")
                 if rec.get(k) is not None},
    }


def _count_parity(a: Dict, b: Dict) -> Tuple[Dict, bool]:
    counts = {}
    equal = True
    keys = [k for k in PARITY_KEYS + ("violations",)
            if k in a["counters"] or k in b["counters"]]
    for k in keys:
        va, vb = a["counters"].get(k), b["counters"].get(k)
        ok = va == vb and va is not None
        counts[k] = {"a": va, "b": vb, "equal": ok}
        # a key only one side carries (oracle vs engine payloads) is
        # reported but does not break parity
        if va is not None and vb is not None and not ok:
            equal = False
    ls_eq = None
    if a["level_sizes"] is not None and b["level_sizes"] is not None:
        ls_eq = list(a["level_sizes"]) == list(b["level_sizes"])
        if not ls_eq:
            equal = False
    return {"counts": counts, "level_sizes_equal": ls_eq}, equal


def _mode_drift(a: Dict, b: Dict) -> List[str]:
    """The program-shaping mode flags that differ, BY NAME."""
    return [k for k in MXU_COUNTER_KEYS
            if a["counters"].get(k) != b["counters"].get(k)
            and (k in a["counters"] or k in b["counters"])]


def _span_deltas(a: Dict, b: Dict) -> Dict:
    out = {}
    for nm in sorted(set(a["spans"]) | set(b["spans"])):
        sa = float(a["spans"].get(nm, {}).get("seconds", 0.0))
        sb = float(b["spans"].get(nm, {}).get("seconds", 0.0))
        out[nm] = {"a_seconds": round(sa, 6), "b_seconds": round(sb, 6),
                   "delta_seconds": round(sb - sa, 6),
                   "ratio": round(sb / sa, 3) if sa > 0 else None}
    return out


def _resource_deltas(a: Dict, b: Dict) -> Dict:
    out = {}
    for k in ("rss_peak_bytes", "device_peak_bytes_in_use",
              "compile_seconds"):
        va, vb = a["resources"].get(k), b["resources"].get(k)
        if va is not None or vb is not None:
            out[k] = {"a": va, "b": vb}
    return out


def diff_runs(a_rec: Dict, b_rec: Dict) -> Dict:
    """Machine-readable diff of two run records (any ``extract``-able
    shape).  ``verdict``: ``clean`` (counts + level sizes identical,
    same mode flags), ``mode_drift`` (counts identical under DIFFERENT
    named flags — the A/B shape), ``mismatch`` (counts differ)."""
    a, b = extract(a_rec), extract(b_rec)
    parity, equal = _count_parity(a, b)
    drift = _mode_drift(a, b)
    verdict = "mismatch" if not equal else \
        ("mode_drift" if drift else "clean")
    return {
        "verdict": verdict,
        "run_a": a["info"], "run_b": b["info"],
        "parity": parity,
        "mode_drift": drift,
        "spans": _span_deltas(a, b),
        "resources": _resource_deltas(a, b),
    }


def regress(run_rec: Dict, baseline_rec: Dict,
            max_span_ratio: Optional[float] = None,
            min_seconds: float = 0.05) -> Tuple[Dict, int]:
    """Regression verdict of ``run`` against ``baseline``; returns
    ``(report, exit_code)`` with code 0 ok / 1 regression.

    Count mismatch (PARITY_KEYS both sides carry, or level sizes) is
    always a regression.  Span-time ratios are opt-in
    (``max_span_ratio``): a shared phase whose baseline took at least
    ``min_seconds`` and whose run/baseline ratio exceeds the bound
    trips — short phases are excluded because their wall-clock is
    noise on shared CI hosts."""
    run, base = extract(run_rec), extract(baseline_rec)
    parity, equal = _count_parity(run, base)
    failures = []
    if not equal:
        bad = [k for k, v in parity["counts"].items()
               if v["a"] is not None and v["b"] is not None
               and not v["equal"]]
        if bad:
            failures.append("count mismatch vs baseline: "
                            + ", ".join(bad))
        if parity["level_sizes_equal"] is False:
            failures.append("level_sizes mismatch vs baseline")
    spans = _span_deltas(base, run)   # a=baseline, b=run
    if max_span_ratio is not None:
        for nm, d in spans.items():
            if d["a_seconds"] >= min_seconds and \
                    d["ratio"] is not None and \
                    d["ratio"] > max_span_ratio:
                failures.append(
                    f"span {nm!r} regressed {d['ratio']:.2f}x "
                    f"({d['a_seconds']:.2f}s -> "
                    f"{d['b_seconds']:.2f}s > "
                    f"{max_span_ratio:.2f}x bound)")
    report = {
        "verdict": "ok" if not failures else "regression",
        "run": run["info"], "baseline": base["info"],
        "parity": parity,
        "mode_drift": _mode_drift(base, run),
        "failures": failures,
        "spans": spans,
    }
    return report, (0 if not failures else 1)
