"""Command-line front end: ``python -m raft_tla_tpu_torch check|trace``.

  check <cfg>  exhaustive BFS of the model; prints one JSON stats line
               (and writes it to --stats-json), exits 1 on an
               invariant violation.
  trace <cfg> --target NAME
               BFS until the scenario property NAME is violated and
               prints the witness trace (exit 0 when found, 1 if not).

The bounds flags override the cfg's in-spec bounds as the reference
CLI's do; ``--device`` picks the device (default cuda; the run raises
when CUDA is absent unless ``--device cpu`` is given); ``--sym-canon``
picks the symmetry canonicalizer as the reference's does.  The stats
keys are the reference CLI's names for the fields this port fills.
"""

from __future__ import annotations

import argparse
import json
import sys

from .cfg.parser import load_model
from .config import Bounds


def _apply_overrides(cfg, args):
    kw = {}
    if args.servers is not None:
        kw["n_servers"] = args.servers
        init = args.init_servers if args.init_servers is not None \
            else args.servers
        kw["init_servers"] = tuple(range(init))
        # MaxInFlightMessages is a formula over Server in the spec
        # (raft.tla:30): a --servers override recomputes it
        old_n, new_n = cfg.n_servers, args.servers
        ov = cfg.max_inflight_override
        if ov == 2 * old_n * old_n:
            kw["max_inflight_override"] = 2 * new_n * new_n
        elif ov == 4 * old_n * old_n:
            kw["max_inflight_override"] = 4 * new_n * new_n
    elif args.init_servers is not None:
        kw["init_servers"] = tuple(range(args.init_servers))
    b = cfg.bounds
    bkw = {k: getattr(args, k) for k in
           ("max_log_length", "max_timeouts", "max_client_requests")
           if getattr(args, k) is not None}
    if bkw:
        kw["bounds"] = Bounds.make(
            max_log_length=bkw.get("max_log_length", b.max_log_length),
            max_restarts=b.max_restarts,
            max_timeouts=bkw.get("max_timeouts", b.max_timeouts),
            max_client_requests=bkw.get("max_client_requests",
                                        b.max_client_requests),
            max_membership_changes=b.max_membership_changes,
            max_trace=b.max_trace)
    return cfg.with_(**kw) if kw else cfg


def check_stats(res, fp_bits: int) -> dict:
    """The ``check`` stats payload, with the reference's key names."""
    distinct, gen, secs = res.distinct_states, res.generated_states, \
        res.seconds
    return {
        "distinct_states": distinct,
        "generated_states": gen,
        "depth": res.depth,
        "seconds": round(secs, 3),
        "states_per_sec": round(distinct / max(secs, 1e-9), 1),
        "dedup_hit_rate": round(1.0 - distinct / max(gen, 1), 4),
        "violations": len(res.violations),
        "fp_bits": fp_bits,
        "expected_fp_collisions": float(
            distinct * distinct / 2.0 ** (fp_bits + 1)),
        "level_sizes": list(res.level_sizes),
        # 1 = orbit-sort, 0 = min-over-perms: the resolved --sym-canon
        "sym_canon": res.sym_canon,
        "spec": "raft",
    }


def _engine(cfg, args, store_states):
    from .engine.bfs import Engine
    return Engine(cfg, chunk=args.chunk, lcap=args.lcap, vcap=args.vcap,
                  ocap=args.ocap, store_states=store_states,
                  sym_canon=args.sym_canon, device=args.device)


def _print_trace(eng, v):
    print(f"violation of {v.invariant} at state {v.state_id}:")
    for step, (label, sv) in enumerate(eng.trace(v.state_id)):
        print(f"  {step:3d} {label}")


def cmd_check(args) -> int:
    cfg = _apply_overrides(load_model(args.cfg), args)
    eng = _engine(cfg, args, store_states=True)
    res = eng.check(max_depth=args.max_depth, max_states=args.max_states,
                    stop_on_violation=True)
    stats = check_stats(res, 32 * eng.W)
    stats["device"] = str(eng.device)
    print(json.dumps(stats))
    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump(stats, fh, indent=1)
    for v in res.violations[:1]:
        _print_trace(eng, v)
    return 1 if res.violations else 0


def cmd_trace(args) -> int:
    from .ops.vpredicates import SCENARIO_PROPERTIES
    if args.target not in SCENARIO_PROPERTIES:
        print(f"unknown --target {args.target!r}; known: "
              f"{', '.join(SCENARIO_PROPERTIES)}", file=sys.stderr)
        return 2
    cfg = _apply_overrides(load_model(args.cfg), args)
    cfg = cfg.with_(invariants=(args.target,))
    eng = _engine(cfg, args, store_states=True)
    res = eng.check(max_depth=args.max_depth, max_states=args.max_states,
                    stop_on_violation=True)
    if not res.violations:
        print(f"no state violates {args.target} within the bounds "
              f"({res.distinct_states} states, depth {res.depth})")
        return 1
    trace = [label for label, _sv in eng.trace(res.violations[0].state_id)]
    print(json.dumps({"target": args.target, "length": len(trace) - 1,
                      "trace": trace}))
    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump(check_stats(res, 32 * eng.W), fh, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raft_tla_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("cfg", help="TLC model file (raft.cfg)")
        sp.add_argument("--servers", type=int, default=None)
        sp.add_argument("--init-servers", type=int, default=None)
        sp.add_argument("--max-log-length", type=int, default=None)
        sp.add_argument("--max-timeouts", type=int, default=None)
        sp.add_argument("--max-client-requests", type=int, default=None)
        sp.add_argument("--max-depth", type=int, default=10 ** 9)
        sp.add_argument("--max-states", type=int, default=10 ** 9)
        sp.add_argument("--chunk", type=int, default=512)
        sp.add_argument("--lcap", type=int, default=1 << 14)
        sp.add_argument("--vcap", type=int, default=1 << 17)
        sp.add_argument("--ocap", type=int, default=None)
        sp.add_argument("--stats-json", default=None, metavar="FILE")
        sp.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
        sp.add_argument("--sym-canon", choices=("auto", "sort", "minperm"),
                        default="auto",
                        help="symmetry canonicalization: 'sort' hashes "
                             "one orbit-sorted relabeling per state "
                             "(signature ties fall back to the min over "
                             "every permutation, so the state partition "
                             "is the same); 'minperm' takes the min over "
                             "every permutation; 'auto' (default) picks "
                             "sort past 6 permutations.  Fingerprint "
                             "values are mode-specific")

    pc = sub.add_parser("check", help="exhaustive model check")
    common(pc)
    pt = sub.add_parser("trace", help="witness trace for a scenario")
    common(pt)
    pt.add_argument("--target", required=True)
    args = ap.parse_args(argv)
    return {"check": cmd_check, "trace": cmd_trace}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
