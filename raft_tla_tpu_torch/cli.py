"""Command-line front end: ``python -m raft_tla_tpu_torch check|trace``.

  check <cfg>  exhaustive BFS of the model; prints one JSON stats line
               (and writes it to --stats-json), then each violation
               with its trace as the reference CLI prints it; exits 1
               on an invariant violation.
  trace <cfg> --target NAME
               BFS until the property NAME (a scenario property or a
               safety invariant) is violated and prints the witness
               trace (exit 0 when found, 1 if not, 2 for an unknown
               name).

The bounds flags override the cfg's in-spec bounds as the reference
CLI's do; ``--device`` picks the device (default cuda; the run raises
when CUDA is absent unless ``--device cpu`` is given); ``--sym-canon``,
``--guard-matmul``, ``--delta-matmul`` and ``--fam-cap-density`` pick
the engine's forms, and ``check --burst/--no-burst`` and
``--burst-levels`` its driver, as the reference's do.  The stats keys
are the reference CLI's names for the fields this port fills.
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
        "levels_fused": res.levels_fused,
        "burst_dispatches": res.burst_dispatches,
        "burst_bailouts": res.burst_bailouts,
        "level_sizes": list(res.level_sizes),
        # 1 = orbit-sort, 0 = min-over-perms: the resolved --sym-canon
        "sym_canon": res.sym_canon,
        "spec": "raft",
    }


# the reference CLI's default --max-violations (the port has no flag)
MAX_VIOLATIONS = 5


def _engine(cfg, args, store_states):
    from .engine.bfs import Engine
    return Engine(cfg, chunk=args.chunk, lcap=args.lcap, vcap=args.vcap,
                  ocap=args.ocap, store_states=store_states,
                  burst=args.burst, burst_levels=args.burst_levels,
                  sym_canon=args.sym_canon,
                  guard_matmul=args.guard_matmul,
                  delta_matmul=args.delta_matmul,
                  fam_density=args.fam_density, device=args.device)


def _fam_density(args):
    """Parse --fam-cap-density into args.fam_density; an error message
    (for exit 2) or None."""
    args.fam_density = None
    if args.fam_cap_density:
        from .engine.expand import parse_fam_density
        try:
            args.fam_density = parse_fam_density(args.fam_cap_density)
        except ValueError as e:
            return f"--fam-cap-density: {e}"
    return None


def _print_violation(idx, name, trace):
    print(f"\nViolation {idx}: invariant {name}")
    if trace:
        for step, (label, sv) in enumerate(trace):
            print(f"  {step:3d}  {label}")
            print(f"       {sv}")


def _check_target(name, ir) -> bool:
    """A --target names a scenario property or a safety invariant of
    the spec; else print what is known and refuse."""
    if name in ir.known_invariants:
        return True
    others = sorted(set(ir.known_invariants) -
                    set(ir.scenario_properties))
    print(f"unknown scenario property {name!r} for spec "
          f"{ir.name!r}; known scenario properties: "
          f"{', '.join(ir.scenario_properties)}\n"
          f"(safety invariants are accepted too: "
          f"{', '.join(others)})",
          file=sys.stderr)
    return False


def cmd_check(args) -> int:
    if args.burst_levels is not None and args.burst_levels <= 0:
        print(f"--burst-levels must be positive (got "
              f"{args.burst_levels}); use --no-burst to disable "
              "the fused-level path", file=sys.stderr)
        return 2
    err = _fam_density(args)
    if err:
        print(err, file=sys.stderr)
        return 2
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
    viol = res.violations[:MAX_VIOLATIONS]
    for k, v in enumerate(viol):
        _print_violation(k, v.invariant, eng.trace(v.state_id))
    return 1 if viol else 0


def cmd_trace(args) -> int:
    from .spec import get_spec
    if not _check_target(args.target, get_spec("raft")):
        return 2
    err = _fam_density(args)
    if err:
        print(err, file=sys.stderr)
        return 2
    cfg = _apply_overrides(load_model(args.cfg), args)
    cfg = cfg.with_(invariants=(args.target,))
    eng = _engine(cfg, args, store_states=True)
    res = eng.check(max_depth=args.max_depth, max_states=args.max_states,
                    stop_on_violation=True)
    if not res.violations:
        print(f"no witness found for {args.target} within bounds "
              f"({res.distinct_states} states, depth {res.depth})")
        return 1
    v = res.violations[0]
    print(f"witness for {args.target} at depth {res.depth} "
          f"({res.distinct_states} states explored, "
          f"{res.seconds:.1f}s):")
    for step, (label, _sv) in enumerate(eng.trace(v.state_id)):
        print(f"  {step:3d}  {label}")
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
        sp.add_argument("--guard-matmul",
                        action=argparse.BooleanOptionalAction,
                        default=True,
                        help="evaluate the guard grid as one int8 "
                             "product of the guard features with the "
                             "packed guard matrix (default); "
                             "--no-guard-matmul sums each lane's guard "
                             "terms instead.  Same answer either way")
        sp.add_argument("--delta-matmul",
                        action=argparse.BooleanOptionalAction,
                        default=True,
                        help="apply the families with declared delta "
                             "algebras as one scatter-add over the flat "
                             "state view (default); --no-delta-matmul "
                             "runs every family's kernel.  Same answer "
                             "either way")
        sp.add_argument("--fam-cap-density", default=None, metavar="SPEC",
                        help="override per-family enabled-lane density "
                             "caps as fam=k,fam2=k2 (e.g. "
                             "Receive=8,Timeout=2): cap_f = chunk * "
                             "min(lanes_f, k); unknown families and "
                             "non-positive k are refused")

    pc = sub.add_parser("check", help="exhaustive model check")
    common(pc)
    pc.add_argument("--burst", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fuse runs of small levels: while the frontier "
                         "fits the burst ring, whole levels run on the "
                         "device with one host read per ring level "
                         "(default); --no-burst keeps the per-level "
                         "driver.  Same answer either way")
    pc.add_argument("--burst-levels", type=int, default=None,
                    metavar="K",
                    help="max levels fused per burst dispatch "
                         "(default 16)")
    pt = sub.add_parser("trace", help="witness trace for a scenario")
    common(pt)
    pt.add_argument("--target", required=True)
    # trace runs the default driver, as the reference's does
    pt.set_defaults(burst=True, burst_levels=None)
    args = ap.parse_args(argv)
    return {"check": cmd_check, "trace": cmd_trace}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
