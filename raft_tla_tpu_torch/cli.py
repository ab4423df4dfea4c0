"""Command-line front end: ``python -m raft_tla_tpu_torch
check|trace|simulate|batch|serve|obs``.

  check <cfg>  exhaustive BFS of the model; prints one JSON stats line
               (and writes it to --stats-json), then each violation
               with its trace as the reference CLI prints it; exits 1
               on an invariant violation.
  simulate <cfg> --target NAME
               random walkers hunt the property NAME (sim/walker.py);
               prints the stats line, then the witness (exit 0), or
               exit 1 when none is found within --steps; ``--trace-out``
               and ``--emit-seed`` write the witness's labels and end
               state.
  trace <cfg> --target NAME
               BFS until the property NAME (a scenario property or a
               safety invariant) is violated and prints the witness
               trace (exit 0 when found, 1 if not, 2 for an unknown
               name); ``--emit-seed FILE`` writes the witness end state
               as a seed for ``check --seed-trace FILE``.
  batch --jobs F.jsonl [--job JSON]
               batched checking of many small jobs (serve/): one summary
               line, then one report line per job; exit 1 when a job
               found violations, 3 when --retries are spent.
  serve --spool DIR
               the persistent daemon (serve/daemon): claims job files
               from DIR/incoming, serves them through the same waves,
               writes DIR/results and DIR/done; exit 0 on a drain
               (SIGTERM, SIGINT, --max-idle-polls), 3 when a cycle's
               retries are spent.
  obs ls|show|diff|regress --registry DIR
               the run registry's query surface (``obs/report.py``):
               the run table, one run's record, the parity verdict of
               two runs (exit 1 on a count mismatch), and a run against
               an earlier run or a baseline file (exit 1 on a
               regression, 2 on a usage error), as the reference CLI's.

``--spec paxos`` checks the second tenant (``spec/paxos``) with the same
engines and flags: the cfg positional is then optional (none or
"default" is the stock model, else a TLC .cfg or a JSON file of Paxos
constants), ``--servers`` is the acceptor count, and ``--ballots``,
``--paxos-values`` and ``--instances`` bound the rest, as in the
reference CLI.  The punctuated search runs from the cfg alone (prefix
pins and ACTION_CONSTRAINTS) or from a seed file.  ``--engine oracle``
runs the plain-Python oracle (``models/explore.py``) instead of the
device engine ("tpu", the reference CLI's name for it).  The bounds and model
flags override the cfg's as the reference CLI's do, and ``check
--invariant/--constraint/--action-constraint`` add to the cfg's lists.
``--device`` picks the device (default cuda; the run raises when CUDA
is absent unless ``--device cpu`` is given); ``--sym-canon``,
``--guard-matmul``, ``--delta-matmul`` and ``--fam-cap-density`` pick
the engine's forms, and ``check --burst/--no-burst`` and
``--burst-levels`` its driver, as the reference's do.  ``check
--checkpoint F --checkpoint-every N --ckpt-keep K`` writes checkpoints
in the reference's format, ``--resume F`` continues one written by
either package, ``--archive-dir D`` keeps the trace archives on disk,
and ``--retries N --backoff S`` supervise the run (resume from the
newest valid checkpoint after a transient failure; ``--chaos SPEC``
injects faults to test exactly that).  ``check --spill`` runs the
host-spill engine (``--seg``; ``--host-table --partitions P --part-cap
N --sweep-stage`` for the host-partitioned visited table), and
``--resume F --resume-portable`` resumes any engine family's
checkpoint on it (``resil/portable.py``).  ``check --ledger F
--heartbeat F --trace-timeline F --profile-dir D --registry D`` write
the reference's run ledger, heartbeat, span timeline and registry
record, and a ``torch.profiler`` trace (``obs/``), on the classic and
the spill engine, and ``simulate`` takes the same flags.  The stats
line has the reference CLI's keys, in its order (``obs/metrics.py``
``check_stats``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .cfg.parser import load_model
from .config import Bounds
from .obs.metrics import check_stats, sim_counters, sim_stats


def _apply_overrides(cfg, args, ir):
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
    if args.symmetry is not None:
        kw["symmetry"] = args.symmetry
    if args.next_family:
        # the CLI analog of editing the cfg's NEXT line
        kw["next_family"] = args.next_family
    b = cfg.bounds
    bkw = {k: getattr(args, k) for k in
           ("max_terms", "max_log_length", "max_timeouts",
            "max_client_requests", "max_restarts")
           if getattr(args, k) is not None}
    if bkw:
        kw["bounds"] = Bounds.make(
            max_log_length=bkw.get("max_log_length", b.max_log_length),
            max_restarts=bkw.get("max_restarts", b.max_restarts),
            max_timeouts=bkw.get("max_timeouts", b.max_timeouts),
            max_client_requests=bkw.get("max_client_requests",
                                        b.max_client_requests),
            max_membership_changes=b.max_membership_changes,
            max_terms=bkw.get("max_terms"),
            max_trace=b.max_trace)
    if args.fp128:
        kw["fp128"] = True
    # cfg-surgery equivalents of TLC's comment-toggling (raft.cfg:51-76),
    # additive like TLC's repeated CONSTRAINTS/INVARIANTS blocks

    def _add(base, extra, known, what):
        for nm in extra:
            if nm not in known:
                raise SystemExit(
                    f"unknown {what} {nm!r}; known: "
                    f"{', '.join(sorted(known))}")
        return tuple(dict.fromkeys(base + tuple(extra)))
    if getattr(args, "invariants", None):
        kw["invariants"] = _add(cfg.invariants, args.invariants,
                                ir.known_invariants, "invariant")
    if getattr(args, "constraint_overrides", None):
        kw["constraints"] = _add(cfg.constraints, args.constraint_overrides,
                                 ir.known_constraints, "constraint")
    if getattr(args, "action_constraints", None):
        kw["action_constraints"] = _add(cfg.action_constraints,
                                        args.action_constraints,
                                        ir.known_action_constraints,
                                        "action constraint")
    return cfg.with_(**kw) if kw else cfg


def _load_paxos_model(args):
    """--spec paxos config assembly, the reference CLI's: the cfg
    positional is optional (None or "default" -> the stock model; a
    ``.cfg`` path -> the TLC CONSTANTS front-end; anything else -> a JSON
    file of constants), then the overrides apply (--servers = acceptors,
    --ballots/--paxos-values/--instances, --symmetry, --fp128,
    --invariant).  The raft-only flags, constraints and action
    constraints are refused."""
    from .cfg.parser import (CfgError, load_paxos_model,
                             paxos_config_from_obj)
    from .spec import get_spec
    ir = get_spec("paxos")
    raft_only = [flag for flag, attr in (
        ("--next", "next_family"), ("--max-terms", "max_terms"),
        ("--max-log-length", "max_log_length"),
        ("--max-timeouts", "max_timeouts"),
        ("--max-client-requests", "max_client_requests"),
        ("--max-restarts", "max_restarts"),
        ("--init-servers", "init_servers"))
        if getattr(args, attr, None) is not None]
    if raft_only:
        raise SystemExit(
            f"{', '.join(raft_only)} are raft-only bounds/toggles — "
            "spec 'paxos' is bounded by --ballots/--paxos-values/"
            "--instances/--servers instead")
    if args.cfg and args.cfg != "default":
        try:
            if args.cfg.endswith(".cfg"):
                cfg = load_paxos_model(args.cfg)
            else:
                with open(args.cfg) as fh:
                    raw = json.load(fh)
                cfg = paxos_config_from_obj(raw, where=args.cfg)
        except CfgError as e:
            raise SystemExit(str(e))
    else:
        cfg = ir.default_config()
    kw = {}
    if args.servers is not None:
        kw["n_servers"] = args.servers
    if getattr(args, "ballots", None) is not None:
        kw["n_ballots"] = args.ballots
    if getattr(args, "paxos_values", None) is not None:
        kw["n_values"] = args.paxos_values
    if getattr(args, "instances", None) is not None:
        kw["n_instances"] = args.instances
    if args.symmetry is not None:
        kw["symmetry"] = args.symmetry
    if args.fp128:
        kw["fp128"] = True
    try:
        if kw:
            cfg = cfg.with_(**kw)
    except ValueError as e:
        raise SystemExit(f"paxos config: {e}")
    if getattr(args, "invariants", None):
        for nm in args.invariants:
            if nm not in ir.known_invariants:
                raise SystemExit(
                    f"unknown invariant {nm!r} for spec 'paxos'; "
                    f"known: {', '.join(sorted(ir.known_invariants))}")
        cfg = cfg.with_(invariants=tuple(dict.fromkeys(
            cfg.invariants + tuple(args.invariants))))
    if getattr(args, "constraint_overrides", None) or \
            getattr(args, "action_constraints", None):
        raise SystemExit(
            "spec 'paxos' declares no constraints / action "
            "constraints (the bounded space is finite without them)")
    return cfg


def _load_cfg(args):
    """(SpecIR handle, model config) for the selected --spec."""
    from .spec import get_spec
    ir = get_spec(args.spec)
    if args.spec == "paxos":
        return ir, _load_paxos_model(args)
    if not args.cfg:
        raise SystemExit(
            "a TLC .cfg path is required for --spec raft "
            "(only --spec paxos has a built-in default model)")
    return ir, _apply_overrides(load_model(args.cfg, bounds=None), args, ir)


_OBS_ARGS = ("ledger", "heartbeat", "trace_timeline", "profile_dir",
             "registry")


def _obs_flags_set(args) -> bool:
    """Flag presence without constructing the bundle (building it
    opens the ledger and timeline files)."""
    return any(getattr(args, nm, None) for nm in _OBS_ARGS)


def _build_obs(args, ir=None, cfg=None, cmd=None):
    """The observability bundle the flags describe (NULL_OBS when none
    is set): ``ir`` stamps the spec name and IR fingerprint into every
    ledger record, the command (``check``, ``simulate``, ``batch``) and
    the cfg ride the meta row and the registry record (``batch`` has
    many specs and configs and passes neither), and the bundle
    describes the run's device (``--device``)."""
    from .obs import NULL_OBS, from_flags
    from .utils import resolve_device
    if not _obs_flags_set(args):
        return NULL_OBS
    meta = ({"spec": ir.name, "ir_fingerprint": ir.fingerprint()}
            if ir is not None else None)
    run_info = {}
    if cmd is not None:
        run_info["cmd"] = cmd
    if cfg is not None:
        run_info["cfg"] = repr(cfg)
    return from_flags(ledger=args.ledger, heartbeat=args.heartbeat,
                      timeline=args.trace_timeline,
                      profile_dir=args.profile_dir, registry=args.registry,
                      meta=meta, run_info=run_info or None,
                      device=str(resolve_device(args.device)))


def _add_obs_flags(sp):
    """--ledger/--heartbeat/--trace-timeline/--profile-dir/--registry,
    on check and simulate as in the reference CLI."""
    sp.add_argument("--ledger", default=None, metavar="FILE",
                    help="append one JSONL record per dispatch (depth, "
                         "frontier, registry counters, states/sec, "
                         "RSS, device memory) — flushed per record, so "
                         "a killed run keeps its telemetry; tail with "
                         "tools/watch.py")
    sp.add_argument("--heartbeat", default=None, metavar="FILE",
                    help="atomically rewrite a small JSON (pid, depth, "
                         "last-dispatch timestamp, states enqueued) "
                         "every dispatch so an external watchdog can "
                         "distinguish a slow level from a dead process")
    sp.add_argument("--trace-timeline", default=None, metavar="FILE",
                    help="write the host span timeline (compile / "
                         "burst_dispatch / level_dispatch / harvest / "
                         "archive_io / checkpoint) as Chrome-trace "
                         "JSON — load it in Perfetto "
                         "(https://ui.perfetto.dev)")
    sp.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace (CPU, and CUDA "
                         "kernels on the card) into DIR as one Chrome "
                         "trace file named by the run id; span names "
                         "ride along as record_function ranges so the "
                         "device trace lines up with --trace-timeline")
    sp.add_argument("--registry", default=None, metavar="DIR",
                    help="append one atomic schema-versioned run "
                         "record (counters, span rollups, resource "
                         "peaks, backend fingerprint, exit status, "
                         "artifact paths) under DIR at run end")


def _engine(cfg, args, store_states):
    kw = dict(chunk=args.chunk, vcap=args.vcap, ocap=args.ocap,
              store_states=store_states, burst=args.burst,
              burst_levels=args.burst_levels, sym_canon=args.sym_canon,
              guard_matmul=args.guard_matmul,
              delta_matmul=args.delta_matmul,
              fam_density=args.fam_density,
              archive_dir=getattr(args, "archive_dir", None),
              device=args.device,
              dedup_kernel=getattr(args, "dedup_kernel", "auto"))
    if getattr(args, "spill", False):
        # the host-spill engine: levels stream through host RAM
        # (engine/spill.py); --host-table moves the visited set to
        # prefix partitions in host RAM (engine/host_table.py)
        from .engine.spill import SpillEngine
        return SpillEngine(cfg, seg=args.seg, host_table=args.host_table,
                           partitions=args.partitions,
                           part_cap=args.part_cap,
                           sweep_stage=args.sweep_stage, **kw)
    from .engine.bfs import Engine
    return Engine(cfg, lcap=args.lcap, **kw)


def _install_chaos(args):
    """--chaos SPEC -> the process-global schedule (resil/chaos);
    returns an error string on a malformed spec."""
    if not args.chaos:
        return None
    from .resil.chaos import ChaosSpecError, install
    try:
        install(args.chaos)
    except ChaosSpecError as e:
        return str(e)
    return None


def _check_retry_flags(args):
    """The reference's refusals of --retries, --backoff, --ckpt-keep;
    an error string or None."""
    if args.retries < 0:
        return f"--retries must be >= 0 (got {args.retries})"
    if args.backoff <= 0:
        return f"--backoff must be positive (got {args.backoff})"
    if getattr(args, "ckpt_keep", 1) < 1:
        return f"--ckpt-keep must be >= 1 (got {args.ckpt_keep})"
    return None


def _fam_density(args, ir):
    """Parse --fam-cap-density against the spec's families into
    args.fam_density; an error message (for exit 2) or None."""
    args.fam_density = None
    if args.fam_cap_density:
        from .engine.expand import parse_fam_density
        try:
            args.fam_density = parse_fam_density(args.fam_cap_density, ir)
        except ValueError as e:
            return f"--fam-cap-density: {e}"
    return None


def _print_violation(idx, name, trace):
    print(f"\nViolation {idx}: invariant {name}")
    if trace:
        for step, (label, sv) in enumerate(trace):
            print(f"  {step:3d}  {label}")
            print(f"       {sv}")


def _load_seeds(path, ir):
    """Seed-trace file -> (oracle seeds [(sv, h)], engine seeds [(sv, h,
    nonview lanes or None)]) for the punctuated search."""
    with open(path) as fh:
        data = json.load(fh)
    if isinstance(data, dict):
        data = [data]
    oracle_seeds, engine_seeds = [], []
    for obj in data:
        # seed files are spec-tagged (a paxos seed carries a "paxos"
        # marker; untagged files are raft's)
        got_spec = "paxos" if obj.get("paxos") else "raft"
        if got_spec != ir.name:
            raise SystemExit(
                f"{path}: seed was emitted for spec {got_spec!r}; "
                f"this run is --spec {ir.name} — re-emit the seed "
                f"with the matching --spec")
        sv, h = ir.state_from_obj(obj)
        oracle_seeds.append((sv, h))
        engine_seeds.append((sv, h, obj.get("nonview")))
    return oracle_seeds, engine_seeds


def _engine_seed_arrays(cfg, ir, engine_seeds):
    """Engine seeds -> raw SoA dicts: an engine-emitted seed's non-VIEW
    lanes replace the ones the codec rebuilds from its history."""
    import numpy as np
    lay = ir.make_layout(cfg)
    out = []
    for sv, h, nonview in engine_seeds:
        arrs = ir.encode(lay, sv, h)
        if nonview:
            for k, v in nonview.items():
                arrs[k] = np.asarray(v, dtype=arrs[k].dtype)
        out.append(arrs)
    return out


def _write_seed(path, obj):
    with open(path, "w") as fh:
        json.dump(obj, fh)
    print(f"seed written to {path}", file=sys.stderr)


def _seed_obj(ir, sv, hist, arrs):
    """Witness end state -> the seed-file object ``check --seed-trace``
    accepts: the oracle view plus the raw non-VIEW lanes, so a seeded
    engine resumes with identical constraint and predicate inputs."""
    import numpy as np
    obj = ir.state_to_obj(sv, hist)
    obj["nonview"] = {k: np.asarray(arrs[k]).tolist()
                      for k in ir.nonview_keys}
    return obj


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
    ir, cfg = _load_cfg(args)
    if args.engine == "oracle" and (args.resume or args.checkpoint):
        print("--checkpoint/--resume are tpu-engine features",
              file=sys.stderr)
        return 2
    if args.resume and args.seed_trace:
        print("--resume and --seed-trace are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.resume_portable and not args.resume:
        print("--resume-portable qualifies --resume: pass the "
              "checkpoint with --resume FILE", file=sys.stderr)
        return 2
    if args.resume_portable and not (args.spill or args.pjit):
        print("--resume-portable re-partitions any engine family's "
              "checkpoint onto the spill or pjit engine: add --spill "
              "or --pjit", file=sys.stderr)
        return 2
    if args.pjit and args.spill:
        print("--pjit and --spill are different engines; pick one",
              file=sys.stderr)
        return 2
    if args.pjit:
        print("--pjit (the pod-scale pjit engine) is not ported to this "
              "package: run on one device, or use --spill",
              file=sys.stderr)
        return 2
    import torch
    if args.dedup_kernel == "on" and args.engine != "oracle" and (
            args.device == "cpu" or not torch.cuda.is_available()):
        print("--dedup-kernel on needs a CUDA device: the hand kernel "
              "(csrc/probe_claim.cu) runs on the card only; use 'auto' "
              "or 'off' on the CPU", file=sys.stderr)
        return 2
    if args.dedup_kernel == "off" and args.engine != "oracle" and \
            args.device != "cpu":
        print("--dedup-kernel off needs --device cpu: the plain twin reads "
              "the visited table back to the host, so on the card it "
              "would move the dedup off the device; use 'auto' or 'on' "
              "there", file=sys.stderr)
        return 2
    err = _check_retry_flags(args) or _install_chaos(args)
    if err:
        print(err, file=sys.stderr)
        return 2
    try:
        return _check(args, ir, cfg)
    finally:
        # the schedule is process-global: it lives as long as this run
        if args.chaos:
            from .resil.chaos import uninstall
            uninstall()


def _check(args, ir, cfg) -> int:
    oracle_seeds = engine_seeds = None
    if args.seed_trace:
        oracle_seeds, raw = _load_seeds(args.seed_trace, ir)
        if args.engine == "oracle":
            # engine-emitted seeds (non-VIEW lanes, no history records)
            # cannot feed the oracle's record-scanning predicates
            needs_glob = ir.glob_dependent & (
                set(cfg.invariants) | set(cfg.constraints) |
                set(cfg.action_constraints))
            for _sv, h, nonview in raw:
                if nonview and not h.glob and needs_glob:
                    print(f"seed was emitted by the tpu engine (nonview "
                          f"lanes, no history records); the oracle "
                          f"cannot evaluate {sorted(needs_glob)} on it — "
                          f"re-emit the seed with `trace --engine oracle "
                          f"--emit-seed`", file=sys.stderr)
                    return 2
        else:
            engine_seeds = _engine_seed_arrays(cfg, ir, raw)
    if args.engine == "oracle":
        if _obs_flags_set(args):
            # the oracle has no dispatches to ledger or heartbeat: say
            # so, and do not build the bundle (that would touch the files)
            print("--ledger/--heartbeat/--trace-timeline/--profile-dir"
                  "/--registry instrument the tpu engines; ignored "
                  "for --engine oracle", file=sys.stderr)
        t0 = time.perf_counter()
        r = ir.oracle_explore(cfg, max_depth=args.max_depth,
                              max_states=args.max_states,
                              stop_on_violation=not args.keep_going,
                              trace_violations=True,
                              seed_states=oracle_seeds)
        secs = time.perf_counter() - t0
        viol = [(v.invariant, v.trace) for v in r.violations]
        out = check_stats(dict(
            distinct_states=r.distinct_states,
            generated_states=r.generated_states, depth=r.depth,
            pin_interior_states=r.pin_interior_states), secs, len(viol),
            ir_fp=ir.fingerprint(), spec=ir.name)
    else:
        if args.host_table and not args.spill:
            print("--host-table composes with the spill engine: add "
                  "--spill", file=sys.stderr)
            return 2
        if args.burst_levels is not None and args.burst_levels <= 0:
            print(f"--burst-levels must be positive (got "
                  f"{args.burst_levels}); use --no-burst to disable "
                  "the fused-level path", file=sys.stderr)
            return 2
        err = _fam_density(args, ir)
        if err:
            print(err, file=sys.stderr)
            return 2
        from .engine.bfs import CheckpointError
        from .resil.supervisor import RetryExhausted, supervised_check

        def make_engine():
            # one fresh engine per supervised attempt
            eng = _engine(cfg, args, store_states=not args.no_store)
            eng.ckpt_keep = args.ckpt_keep
            return eng
        obs = _build_obs(args, ir, cfg, "check")
        obs.start()
        done = False
        try:
            resume_image = None
            if args.resume_portable:
                from .resil.portable import load_portable_image
                resume_image = load_portable_image(args.resume)
            r, eng, _attempts = supervised_check(
                make_engine, retries=args.retries, backoff=args.backoff,
                obs=obs, checkpoint_path=args.checkpoint,
                resume_from=(None if args.resume_portable
                             else args.resume),
                resume_image=resume_image, max_depth=args.max_depth,
                max_states=args.max_states,
                stop_on_violation=not args.keep_going,
                verbose=args.verbose, seed_states=engine_seeds,
                checkpoint_every=args.checkpoint_every)
            done = True
        except (CheckpointError, FileNotFoundError) as e:
            # only checkpoint load/format problems — a mid-run error
            # after a successful resume propagates with its real trace
            if not args.resume:
                raise
            print(f"cannot resume from {args.resume}: {e}",
                  file=sys.stderr)
            return 2
        except RetryExhausted as e:
            print(str(e), file=sys.stderr)
            return 3
        finally:
            # the final heartbeat carries the run's reported depth (a
            # watchdog sees "finished" with the stats line's depth)
            if done:
                obs.finish(depth=int(r.depth),
                           states=int(r.distinct_states),
                           counters=r.metrics.as_dict(),
                           level_sizes=list(r.level_sizes))
            else:
                obs.finish(status="failed")
        viol = []
        for v in r.violations[:args.max_violations]:
            if v.state_id < 0:
                # a pinned-prefix interior state: checked at seed time,
                # it never entered the BFS and has no parent chain
                trace = [("(pinned-prefix interior state — precedes "
                          "the seeded witness end)", v.state)]
            elif not args.no_store:
                trace = eng.trace(v.state_id)
            elif v.state is not None:
                # no parent archive, but the violating state was decoded
                # at detection time
                trace = [("(violating state; run without --no-store "
                          "for the full trace)", v.state)]
            else:
                trace = None
            viol.append((v.invariant, trace))
        if r.overflow_faults:
            print(f"FAULT: {r.overflow_faults} un-representable states "
                  f"(bounds too small for the disabled-constraint space)",
                  file=sys.stderr)
        out = check_stats(r.metrics.as_dict(), r.seconds, len(viol),
                          fp_bits=128 if args.fp128 else 64,
                          ir_fp=ir.fingerprint(), spec=ir.name)
    print(json.dumps(out))
    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump(out, fh)
    for k, (name, trace) in enumerate(viol):
        if args.engine == "oracle":
            print(f"\nViolation {k}: {name}")
            if trace:
                print("  " + " -> ".join(trace))
            elif trace is None:
                # a pinned-prefix interior state has no action trace (a
                # root violation has an empty one)
                print("  (pinned-prefix interior state — precedes the "
                      "seeded witness end)")
            else:
                print("  (violation at a root state — empty trace)")
        else:
            _print_violation(k, name, trace)
    return 1 if viol else 0


def cmd_trace(args) -> int:
    ir, cfg = _load_cfg(args)
    if not _check_target(args.target, ir):
        return 2
    cfg = cfg.with_(invariants=(args.target,))
    if args.engine == "oracle":
        t0 = time.perf_counter()
        r = ir.oracle_explore(cfg, max_depth=args.max_depth,
                              max_states=args.max_states,
                              stop_on_violation=True, trace_violations=True)
        if not r.violations:
            print(f"no witness found for {args.target} within bounds "
                  f"({r.distinct_states} states, depth {r.depth})")
            return 1
        print(f"witness for {args.target} at depth {r.depth} "
              f"({r.distinct_states} states explored, "
              f"{time.perf_counter() - t0:.1f}s):")
        for step, label in enumerate(r.violations[0].trace):
            print(f"  {step + 1:3d}  {label}")
        if args.emit_seed:
            v = r.violations[0]
            _write_seed(args.emit_seed, ir.state_to_obj(v.state, v.hist))
        return 0
    err = _fam_density(args, ir)
    if err:
        print(err, file=sys.stderr)
        return 2
    eng = _engine(cfg, args, store_states=True)
    r = eng.check(max_depth=args.max_depth, max_states=args.max_states,
                  stop_on_violation=True, verbose=args.verbose)
    if not r.violations:
        print(f"no witness found for {args.target} within bounds "
              f"({r.distinct_states} states, depth {r.depth})")
        return 1
    v = r.violations[0]
    print(f"witness for {args.target} at depth {r.depth} "
          f"({r.distinct_states} states explored, "
          f"{r.seconds:.1f}s):")
    for step, (label, sv) in enumerate(eng.trace(v.state_id)):
        print(f"  {step:3d}  {label}")
        if args.verbose:
            print(f"       {sv}")
    if args.emit_seed:
        arrs = eng.get_state_arrays(v.state_id)
        sv, h = ir.decode(eng.lay, arrs)
        _write_seed(args.emit_seed, _seed_obj(ir, sv, h, arrs))
    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump(check_stats(r.metrics.as_dict(), r.seconds,
                                  len(r.violations),
                                  fp_bits=128 if args.fp128 else 64,
                                  ir_fp=ir.fingerprint(), spec=ir.name),
                      fh)
    return 0


def cmd_simulate(args) -> int:
    """TLC ``-simulate``: W random walkers hunt a scenario property past
    the exhaustive engines' reach (sim/walker.py).  Exit 0 on a
    witness, 1 on none within the step budget."""
    # a clear bounds error beats a shape error from a non-positive width
    for nm, val in (("--steps-per-dispatch", args.steps_per_dispatch),
                    ("--walkers", args.walkers),
                    ("--steps", args.steps)):
        if val <= 0:
            print(f"{nm} must be positive (got {val})",
                  file=sys.stderr)
            return 2
    ir, cfg = _load_cfg(args)
    if not _check_target(args.target, ir):
        return 2
    cfg = cfg.with_(invariants=(args.target,))
    # --max-depth doubles as the walk restart bound; the check-style
    # "unbounded" default maps to a walk-sized one
    depth = args.max_depth if args.max_depth < 10 ** 6 else 64
    from .sim import SimEngine
    # --mesh: the fleet across devices is not ported; a walker's stream
    # depends on its global id only, so one device walks the same
    eng = SimEngine(cfg, walkers=args.walkers, max_depth=depth,
                    seed=args.seed, policy=args.policy,
                    bloom_bits=args.bloom_bits,
                    guard_matmul=args.guard_matmul,
                    delta_matmul=args.delta_matmul,
                    sym_canon=args.sym_canon, device=args.device)
    obs = _build_obs(args, ir, cfg, "simulate")
    obs.start()
    t0 = time.perf_counter()
    done = False
    try:
        r = eng.run(steps=args.steps,
                    steps_per_dispatch=args.steps_per_dispatch,
                    verbose=args.verbose, obs=obs)
        done = True
    finally:
        if done:
            obs.finish(depth=int(r.steps_dispatched),
                       states=int(r.walker_steps),
                       counters=sim_counters(r))
        else:
            obs.finish(status="failed")
    out = sim_stats(r, target=args.target, policy=args.policy,
                    seed=args.seed,
                    platform="gpu" if eng.device.type == "cuda" else "cpu")
    out["spec"] = ir.name
    out["ir_fingerprint"] = ir.fingerprint()
    print(json.dumps(out))
    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump(out, fh)
    if not r.hits:
        print(f"no witness found for {args.target} within "
              f"{r.walker_steps} walker-steps", file=sys.stderr)
        return 1
    h = eng.decode_hit(r.hits[0])
    print(f"witness for {args.target} at depth {h.depth} "
          f"(walker {h.walker}, {r.walker_steps} walker-steps, "
          f"{time.perf_counter() - t0:.1f}s):")
    for step, (label, sv) in enumerate(h.trace):
        print(f"  {step:3d}  {label}")
        if args.verbose:
            print(f"       {sv}")
    if args.trace_out:
        with open(args.trace_out, "w") as fh:
            json.dump({"target": args.target, "depth": h.depth,
                       "walker": h.walker, "seed": args.seed,
                       "labels": [label for label, _sv in h.trace]},
                      fh)
        print(f"witness trace written to {args.trace_out}",
              file=sys.stderr)
    if args.emit_seed:
        _write_seed(args.emit_seed,
                    _seed_obj(ir, h.trace[-1][1], h.hist, h.state_arrs))
    return 0


def cmd_batch(args):
    """Batched checking of many small jobs (serve/): a job list from a
    JSONL file and/or repeated --job flags, grouped into shape buckets
    and run as one job-axis program per bucket, with fingerprint-keyed
    result caching.  Prints one summary JSON line, then one report line
    per job (submission order).  Exit 0 = all clean, 1 = some job found
    violations, 2 = usage error, 3 = --retries spent."""
    from .cfg.parser import CfgError
    from .serve import job_from_dict, load_jobs
    jobs = []
    if args.jobs:
        try:
            jobs.extend(load_jobs(args.jobs))
        except (OSError, ValueError, CfgError) as e:
            print(str(e), file=sys.stderr)
            return 2
    for k, text in enumerate(args.job or []):
        where = f"--job #{k + 1}"
        try:
            jobs.append(job_from_dict(json.loads(text), where=where))
        except (OSError, ValueError) as e:
            # OSError too: a missing config path is a usage error
            # (exit 2), not a violation-style exit 1
            msg = str(e) if str(e).startswith(where) \
                else f"{where}: {e}"
            print(msg, file=sys.stderr)
            return 2
    if not jobs:
        print("no jobs: pass --jobs FILE.jsonl and/or --job JSON",
              file=sys.stderr)
        return 2
    err = (_cache_bound_error(args) or
           ("--cache-max-bytes bounds the on-disk result cache: add "
            "--cache-dir" if args.cache_max_bytes is not None and
            not args.cache_dir else None) or
           _wave_flags_error(args) or _exec_cache_flags_error(args) or
           _check_retry_flags(args) or _install_chaos(args))
    if err:
        print(err, file=sys.stderr)
        return 2
    try:
        return _batch(args, jobs)
    finally:
        # the schedule is process-global: it lives as long as this run
        if args.chaos:
            from .resil.chaos import uninstall
            uninstall()


def _cache_bound_error(args):
    """The reference's refusal of a non-positive --cache-max-bytes."""
    if args.cache_max_bytes is not None and args.cache_max_bytes <= 0:
        return (f"--cache-max-bytes must be positive (got "
                f"{args.cache_max_bytes}); omit it for an unbounded "
                "cache")
    return None


def _wave_flags_error(args):
    """The reference's refusals of --wave-yield, --max-wave and
    --wave-mesh (a mesh past one device names ROADMAP item 9d)."""
    from .serve.batch import resolve_wave_mesh
    if args.wave_yield is not None and args.wave_yield < 1:
        return f"--wave-yield must be >= 1 (got {args.wave_yield})"
    if args.max_wave is not None and args.max_wave < 1:
        return f"--max-wave must be >= 1 (got {args.max_wave})"
    try:
        resolve_wave_mesh(args.wave_mesh)
    except ValueError as e:
        return str(e)
    return None


def _exec_cache_flags_error(args):
    """The reference's refusals of --executable-cache-max-bytes."""
    n = args.executable_cache_max_bytes
    if n is not None and n <= 0:
        return (f"--executable-cache-max-bytes must be positive (got "
                f"{n}); omit it for an unbounded cache")
    if n is not None and not args.executable_cache:
        return ("--executable-cache-max-bytes bounds the on-disk "
                "executable cache: add --executable-cache")
    return None


def _exec_cache(args):
    """--executable-cache DIR [--executable-cache-max-bytes N] -> an
    ExecCache with the port's serializer, or None."""
    if not args.executable_cache:
        return None
    from .serve.exec_cache import ExecCache
    return ExecCache(args.executable_cache,
                     max_bytes=args.executable_cache_max_bytes)


def _batch(args, jobs) -> int:
    from .resil.supervisor import RETRYABLE, backoff_delay
    from .serve import ResultCache, run_jobs
    cache = ResultCache(args.cache_dir,
                        max_bytes=args.cache_max_bytes) \
        if args.cache_dir else None
    exec_cache = _exec_cache(args)
    obs = _build_obs(args, cmd="batch")
    obs.start()
    done = False
    rep = None
    attempt = 0
    try:
        while True:
            try:
                rep = run_jobs(jobs, cache=cache, obs=obs,
                               sequential=args.sequential,
                               verbose=args.verbose,
                               wave_state=args.wave_state,
                               wave_yield=args.wave_yield,
                               max_wave=args.max_wave,
                               wave_mesh=args.wave_mesh,
                               bucket_overrides=(
                                   {"sym_canon": args.sym_canon}
                                   if args.sym_canon != "auto"
                                   else None),
                               exec_cache=exec_cache,
                               device=args.device)
                done = True
                break
            except RETRYABLE as e:
                # a retried batch is incremental: finished jobs answer
                # from the result cache, stragglers resume mid-BFS
                # from --wave-state
                if attempt >= args.retries:
                    print(f"batch run failed: {e}", file=sys.stderr)
                    return 3
                wait = backoff_delay(attempt, args.backoff, 60.0)
                obs.retry(attempt=attempt + 1,
                          max_attempts=args.retries + 1,
                          wait_s=wait, error=e)
                time.sleep(wait)
                attempt += 1
    finally:
        if done:
            obs.finish(
                depth=max((int(o.report.get("depth", 0))
                           for o in rep.outcomes), default=0),
                states=sum(int(o.report.get("distinct_states", 0))
                           for o in rep.outcomes),
                # the batch summary's scalar counters (jobs, buckets,
                # cache hits, dispatches) are the run's registry record
                counters={k: v for k, v in rep.summary.items()
                          if isinstance(v, (int, float))
                          and not isinstance(v, bool)})
        else:
            obs.finish(status="failed")
    print(json.dumps(rep.summary))
    for o in rep.outcomes:
        print(json.dumps(o.report))
    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump({"summary": rep.summary,
                       "jobs": [o.report for o in rep.outcomes]}, fh)
    n_viol = sum(int(o.report.get("violations", 0))
                 for o in rep.outcomes)
    return 1 if n_viol else 0


def cmd_serve(args) -> int:
    """The persistent checking daemon (serve/daemon): watch a spool
    directory (and/or tail a JSONL stream) for job submissions, drain
    claimed jobs through the wave scheduler, and write one atomic result
    JSON and done/ marker per submission.  Runs until SIGTERM/SIGINT
    (graceful drain, exit 0) or --max-idle-polls.  Exit 0 = drained
    cleanly, 2 = usage error, 3 = a serve cycle exhausted its retries.
    Its waves run on cuda unless --device cpu; with no CUDA it raises."""
    from .serve import Daemon, ResultCache
    from .utils import resolve_device
    if args.poll <= 0:
        print(f"--poll must be positive (got {args.poll})",
              file=sys.stderr)
        return 2
    if args.grace < 0:
        print(f"--grace must be >= 0 (got {args.grace})",
              file=sys.stderr)
        return 2
    if args.max_idle_polls is not None and args.max_idle_polls < 1:
        print(f"--max-idle-polls must be >= 1 "
              f"(got {args.max_idle_polls})", file=sys.stderr)
        return 2
    err = (_wave_flags_error(args) or _cache_bound_error(args) or
           _exec_cache_flags_error(args) or _check_retry_flags(args) or
           _install_chaos(args))
    if err:
        print(err, file=sys.stderr)
        return 2
    try:
        # no CUDA and no --device cpu: raise before touching the spool
        resolve_device(args.device)
        # restart-proof by default: the result cache and the wave state
        # live under the spool unless pointed elsewhere
        cache_dir = args.cache_dir or os.path.join(args.spool, "cache")
        wave_dir = args.wave_state or os.path.join(args.spool, "waves")
        cache = ResultCache(cache_dir, max_bytes=args.cache_max_bytes)
        obs = _build_obs(args, cmd="serve")
        obs.start()
        daemon = Daemon(
            args.spool, cache=cache, wave_state=wave_dir,
            exec_cache=_exec_cache(args), obs=obs, poll_s=args.poll,
            wave_yield=args.wave_yield,
            max_wave=args.max_wave, wave_mesh=args.wave_mesh,
            bucket_overrides=({"sym_canon": args.sym_canon}
                              if args.sym_canon != "auto" else None),
            retries=args.retries, backoff=args.backoff,
            max_idle_polls=args.max_idle_polls, stream=args.stream,
            grace_s=args.grace, verbose=args.verbose,
            device=args.device)
        daemon.install_signals()
        # daemon.run owns obs.finish (the drain epilogue runs on every
        # exit path, with the daemon's own counters)
        return daemon.run()
    finally:
        # the schedule is process-global: it lives as long as this run
        if args.chaos:
            from .resil.chaos import uninstall
            uninstall()


def _load_baseline_file(path, row):
    """A baseline for ``obs regress``: a --stats-json payload, a bench
    headline object, a registry record, or a bench A/B file with a
    ``rows`` map (then --baseline-row picks one)."""
    with open(path) as fh:
        obj = json.load(fh)
    if isinstance(obj, dict) and isinstance(obj.get("rows"), dict):
        if not row:
            raise SystemExit(
                f"{path} holds multiple A/B rows; pick one with "
                f"--baseline-row (known: "
                f"{', '.join(sorted(obj['rows']))})")
        if row not in obj["rows"]:
            raise SystemExit(
                f"--baseline-row {row!r} not in {path} (known: "
                f"{', '.join(sorted(obj['rows']))})")
        return obj["rows"][row]
    if row:
        raise SystemExit(f"--baseline-row given but {path} has no "
                         "'rows' map")
    return obj


def cmd_obs(args) -> int:
    """``obs`` — the run registry's query surface (``obs/report.py``).

    ls      — the run table, filterable (newest last).
    show    — one run's whole record as indented JSON.
    diff    — the parity verdict and per-phase span deltas of two runs;
              exit 1 on a count mismatch.
    regress — a run against an earlier run (--against) or a baseline
              file (--baseline); exit 1 on a count mismatch or a
              tripped --max-span-ratio bound, 2 on a usage error.

    Run tokens: a full run id, a unique id prefix, or ``last``."""
    from .obs.registry import RunRegistry
    from .obs.report import diff_runs, regress
    reg = RunRegistry(args.registry)

    def resolve(token):
        rid = reg.resolve(token)
        if rid is None:
            ids = reg.run_ids()
            print(f"no unique run matches {token!r} in "
                  f"{args.registry} ({len(ids)} records"
                  + (f"; newest {ids[-1]}" if ids else "")
                  + ")", file=sys.stderr)
        return rid

    if args.obs_cmd == "ls":
        rows = []
        for _rid, rec in reg.records():
            if args.spec and rec.get("spec") != args.spec:
                continue
            if args.cmd_filter and rec.get("cmd") != args.cmd_filter:
                continue
            if args.status and rec.get("status") != args.status:
                continue
            rows.append(rec)
        print(f"{'run_id':34s} {'cmd':9s} {'spec':6s} {'status':9s} "
              f"{'depth':>6s} {'states':>10s} {'seconds':>8s}")
        for rec in rows:
            print(f"{str(rec.get('run_id', '?')):34s} "
                  f"{str(rec.get('cmd', '?')):9s} "
                  f"{str(rec.get('spec', '-')):6s} "
                  f"{str(rec.get('status', '?')):9s} "
                  f"{str(rec.get('depth', '-')):>6s} "
                  f"{str(rec.get('distinct_states', '-')):>10s} "
                  f"{str(rec.get('seconds', '-')):>8s}")
        return 0
    if args.obs_cmd == "show":
        rid = resolve(args.run)
        if rid is None:
            return 2
        print(json.dumps(reg.load(rid), indent=1))
        return 0
    if args.obs_cmd == "diff":
        ra, rb = resolve(args.run_a), resolve(args.run_b)
        if ra is None or rb is None:
            return 2
        rep = diff_runs(reg.load(ra), reg.load(rb))
        print(json.dumps(rep))
        return 1 if rep["verdict"] == "mismatch" else 0
    # regress
    if bool(args.against) == bool(args.baseline):
        print("obs regress needs exactly one of --against RUN / "
              "--baseline FILE", file=sys.stderr)
        return 2
    rid = resolve(args.run)
    if rid is None:
        return 2
    if args.against:
        bid = resolve(args.against)
        if bid is None:
            return 2
        baseline = reg.load(bid)
    else:
        baseline = _load_baseline_file(args.baseline, args.baseline_row)
    rep, code = regress(reg.load(rid), baseline,
                        max_span_ratio=args.max_span_ratio,
                        min_seconds=args.min_seconds)
    print(json.dumps(rep))
    return code


def _add_obs_parser(sub):
    """``obs ls/show/diff/regress``, with the reference CLI's flags."""
    po = sub.add_parser(
        "obs",
        help="query the run registry: ls (run table), show RUN, "
             "diff A B (parity verdict + span deltas), regress "
             "(verdict vs a prior run or a baseline file; exit "
             "nonzero on count mismatch / span-ratio regression)")
    osub = po.add_subparsers(dest="obs_cmd", required=True)

    def _reg_flag(sp):
        sp.add_argument("--registry", required=True, metavar="DIR",
                        help="the registry directory earlier runs "
                             "recorded into")

    ols = osub.add_parser("ls", help="list recorded runs (newest last)")
    _reg_flag(ols)
    ols.add_argument("--spec", default=None,
                     help="only runs of this spec frontend")
    ols.add_argument("--cmd", dest="cmd_filter", default=None,
                     help="only runs of this command (check/simulate)")
    ols.add_argument("--status", default=None,
                     help="only runs with this exit status "
                          "(finished/failed)")
    oshow = osub.add_parser(
        "show", help="one run's full record (counters, span rollups, "
                     "resource peaks, artifact paths) as JSON")
    _reg_flag(oshow)
    oshow.add_argument("run", help="run id, unique prefix, or 'last'")
    odiff = osub.add_parser(
        "diff", help="machine-readable diff of two runs: count/"
                     "level-size parity verdict, per-phase span "
                     "deltas, mode-flag drift by name; exit 1 on "
                     "count mismatch")
    _reg_flag(odiff)
    odiff.add_argument("run_a", help="run id, unique prefix, or 'last'")
    odiff.add_argument("run_b", help="run id, unique prefix, or 'last'")
    oreg = osub.add_parser(
        "regress", help="regression verdict of RUN against a prior "
                        "registry run or a baseline file; exit 1 on "
                        "regression, 2 on usage error")
    _reg_flag(oreg)
    oreg.add_argument("run", help="run id, unique prefix, or 'last'")
    oreg.add_argument("--against", default=None, metavar="RUN",
                      help="baseline = this prior registry run")
    oreg.add_argument("--baseline", default=None, metavar="FILE",
                      help="baseline = a JSON file: a --stats-json "
                           "payload, a bench headline object, or an A/B "
                           "file with a 'rows' map (then --baseline-row "
                           "picks the row)")
    oreg.add_argument("--baseline-row", default=None, metavar="KEY",
                      help="row key inside the file's 'rows' map")
    oreg.add_argument("--max-span-ratio", type=float, default=None,
                      metavar="R",
                      help="also fail when a shared phase's span time "
                           "exceeds R x the baseline's (phases under "
                           "--min-seconds in the baseline are exempt: "
                           "wall-clock noise)")
    oreg.add_argument("--min-seconds", type=float, default=0.05,
                      metavar="S",
                      help="span-ratio floor: baseline phases shorter "
                           "than S seconds never trip (default 0.05)")


def _add_serve_parser(sub):
    """``serve``: the reference's flags and defaults, plus --device."""
    pd = sub.add_parser(
        "serve",
        help="persistent checking daemon: watch a spool directory "
             "(and/or tail a JSONL stream) for job files, claim them "
             "atomically, drain them through the wave scheduler, and "
             "write one atomic result JSON + done/ marker per job; "
             "SIGTERM drains gracefully (README 'Batch / serving on "
             "the H100' documents the spool protocol)")
    pd.add_argument("--spool", required=True, metavar="DIR",
                    help="spool root: incoming/ claimed/ rejected/ "
                         "results/ done/ are created under it; "
                         "clients write-then-rename one JSON job "
                         "object per file (trailing newline) into "
                         "incoming/")
    pd.add_argument("--stream", default=None, metavar="FILE",
                    help="also tail this append-only JSONL job "
                         "stream: each complete appended line "
                         "materializes as a spool submission "
                         "(stream-<n>); the consumed offset persists "
                         "across restarts")
    pd.add_argument("--poll", type=float, default=0.5, metavar="SEC",
                    help="spool poll interval while idle "
                         "(default 0.5)")
    pd.add_argument("--grace", type=float, default=5.0, metavar="SEC",
                    help="seconds an incomplete submission (no "
                         "trailing newline — a writer mid-write) may "
                         "sit in incoming/ before it quarantines as "
                         "torn (default 5)")
    pd.add_argument("--max-idle-polls", type=int, default=None,
                    metavar="N",
                    help="drain and exit 0 after N consecutive empty "
                         "polls (default: run until SIGTERM)")
    pd.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="result cache directory (default: "
                         "SPOOL/cache) — duplicate submissions are "
                         "answered from it with zero device "
                         "dispatches")
    pd.add_argument("--cache-max-bytes", type=int, default=None,
                    metavar="N",
                    help="LRU-by-bytes result-cache bound (see "
                         "batch --cache-max-bytes)")
    pd.add_argument("--executable-cache", default=None, metavar="DIR",
                    help="the persistent executable cache (see batch "
                         "--executable-cache): on this backend every "
                         "store fails by name and a restart "
                         "recaptures its graphs")
    pd.add_argument("--executable-cache-max-bytes", type=int,
                    default=None, metavar="N",
                    help="LRU-by-bytes bound on the executable cache "
                         "(see batch --executable-cache-max-bytes)")
    pd.add_argument("--wave-state", default=None, metavar="DIR",
                    help="wave-state directory (default: SPOOL/waves) "
                         "— live jobs persist their carry at every "
                         "wave boundary, so a killed daemon resumes "
                         "stragglers mid-BFS bit-exact on restart")
    pd.add_argument("--wave-yield", type=int, default=None,
                    metavar="N",
                    help="fairness: a wave yields its lanes after N "
                         "batched device calls while other claimed "
                         "jobs wait (higher Job priority runs first)")
    pd.add_argument("--max-wave", type=int, default=None, metavar="N",
                    help="jobs-per-wave ceiling (default 8; see batch "
                         "--max-wave)")
    pd.add_argument("--wave-mesh", default="auto",
                    metavar="auto|N|JxS|off",
                    help="the wave's device mesh: 'auto' (default), "
                         "'off', 0 and 1 run every wave on one device; "
                         "a larger mesh is not ported (ROADMAP item "
                         "9d) and refused with exit 2")
    pd.add_argument("--retries", type=int, default=0, metavar="N",
                    help="re-run a failed serve cycle up to N times "
                         "with bounded exponential backoff "
                         "(incremental via the result cache + wave "
                         "state); exhaustion exits 3")
    pd.add_argument("--backoff", type=float, default=2.0, metavar="S",
                    help="base backoff seconds for --retries")
    pd.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault injection (resil/"
                         "chaos); 'intake' faults the spool scan, "
                         "'wave_kill:at=1' is the deterministic "
                         "stand-in for a kill at a wave boundary")
    pd.add_argument("--sym-canon",
                    choices=("auto", "sort", "minperm"),
                    default="auto",
                    help="symmetry canonicalization for every bucket "
                         "engine (see batch --sym-canon)")
    pd.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    pd.add_argument("--verbose", "-v", action="store_true")
    _add_obs_flags(pd)
    pd.set_defaults(fn=cmd_serve)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raft_tla_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("cfg", nargs="?", default=None,
                        help="model file: a TLC .cfg path (--spec raft; "
                             "required) or a TLC .cfg / JSON constants "
                             "file / 'default' (--spec paxos; optional)")
        sp.add_argument("--spec", choices=("raft", "paxos"),
                        default="raft",
                        help="which spec to check: the Raft "
                             "membership-change spec (default) or "
                             "bounded single-decree/multi-instance Paxos "
                             "— same engines, same flags")
        sp.add_argument("--engine", choices=("tpu", "oracle"),
                        default="tpu",
                        help="the device engine (default; named as the "
                             "reference CLI names it) or the "
                             "plain-Python oracle")
        sp.add_argument("--servers", type=int, default=None,
                        help="override |Server|")
        sp.add_argument("--init-servers", type=int, default=None,
                        help="override |InitServer| (first K servers)")
        sp.add_argument("--symmetry", action=argparse.BooleanOptionalAction,
                        default=None)
        sp.add_argument("--next", dest="next_family", default=None,
                        choices=("NextAsync", "NextAsyncCrash", "Next",
                                 "NextDynamic"),
                        help="override the cfg's NEXT family (e.g. "
                             "NextDynamic enables the membership "
                             "actions)")
        sp.add_argument("--max-terms", type=int, default=None)
        sp.add_argument("--max-log-length", type=int, default=None)
        sp.add_argument("--max-timeouts", type=int, default=None)
        sp.add_argument("--max-client-requests", type=int, default=None)
        sp.add_argument("--max-restarts", type=int, default=None)
        sp.add_argument("--fp128", action="store_true",
                        help="128-bit fingerprints (4-word dedup keys)")
        # --spec paxos constants (ignored for raft)
        sp.add_argument("--ballots", type=int, default=None,
                        help="paxos: ballots 0..N-1 (--spec paxos)")
        sp.add_argument("--paxos-values", type=int, default=None,
                        help="paxos: values 0..N-1 (--spec paxos)")
        sp.add_argument("--instances", type=int, default=None,
                        help="paxos: independent consensus instances "
                             "(--spec paxos)")
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
        sp.add_argument("--verbose", "-v", action="store_true")

    # --target help comes from each spec's scenario registry
    from .spec import get_spec
    target_help = ("scenario property of the active --spec (raft: " +
                   ", ".join(get_spec("raft").scenario_properties) +
                   "; paxos: " +
                   ", ".join(get_spec("paxos").scenario_properties) +
                   ")")

    pc = sub.add_parser("check", help="exhaustive model check")
    common(pc)
    pc.add_argument("--keep-going", action="store_true",
                    help="do not stop at the first violation")
    pc.add_argument("--spill", action="store_true",
                    help="host-spill engine: stream levels through "
                         "host RAM — for levels whose buffers outgrow "
                         "the device")
    pc.add_argument("--pjit", action="store_true",
                    help="the reference's pod-scale pjit engine: not "
                         "ported (refused)")
    pc.add_argument("--seg", type=int, default=1 << 21,
                    help="spill segment capacity in states (--spill)")
    pc.add_argument("--host-table", action="store_true",
                    help="host-partitioned visited table (needs "
                         "--spill): the authoritative fingerprint set "
                         "lives in host RAM as fingerprint-prefix "
                         "partitions swept through the device per "
                         "level; the device table becomes a bounded "
                         "cache")
    pc.add_argument("--sweep-stage",
                    action=argparse.BooleanOptionalAction,
                    default=True,
                    help="double-buffered sweep uploads (--host-table): "
                         "start the next sweep's partition-image "
                         "uploads at level start so they overlap the "
                         "level's steps (same counts either way)")
    pc.add_argument("--partitions", type=int, default=4, metavar="P",
                    help="host-table partition count, a power of two "
                         "(counts do not depend on it)")
    pc.add_argument("--part-cap", type=int, default=1 << 16,
                    metavar="N",
                    help="initial slots per host-table partition "
                         "(grows 4x on the 0.40 load bound)")
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
    pc.add_argument("--dedup-kernel", choices=("auto", "on", "off"),
                    default="auto",
                    help="the dedup kernel (csrc/probe_claim.cu): "
                         "'auto' (default) launches it on the card and "
                         "runs its plain twin on the CPU; 'on' requires "
                         "the card (a usage error without CUDA); 'off' "
                         "runs the twin and needs --device cpu (a usage "
                         "error on the card; the stats stamp "
                         "dedup_kernel 0).  Same answer in every mode")
    pc.add_argument("--no-store", action="store_true",
                    help="keep no state archive: violations show the "
                         "violating state, not its trace")
    pc.add_argument("--max-violations", type=int, default=5)
    pc.add_argument("--seed-trace", default=None, metavar="FILE",
                    help="punctuated search: explore only extensions of "
                         "the seed state(s) in FILE (emitted by `trace "
                         "--emit-seed`; the engine analog of the spec's "
                         "hard-coded prefix pins, raft.tla:1198-1234)")
    pc.add_argument("--archive-dir", default=None, metavar="DIR",
                    help="disk-backed trace archives: stream each "
                         "level's parent/lane/state rows to memmap'd "
                         "files under DIR instead of growing host "
                         "arrays (traces replay from the memmaps)")
    pc.add_argument("--checkpoint", default=None, metavar="FILE",
                    help="write a resumable checkpoint every "
                         "--checkpoint-every levels, in the JAX "
                         "package's format (TLC's states/ dir "
                         "counterpart)")
    pc.add_argument("--checkpoint-every", type=int, default=5,
                    metavar="N",
                    help="levels between checkpoints (each checkpoint "
                         "is a full snapshot incl. the visited set and "
                         "any in-RAM trace archives)")
    pc.add_argument("--resume", default=None, metavar="FILE",
                    help="resume a checkpointed run, written by this "
                         "package or the JAX package (final counts are "
                         "identical to an uninterrupted run).  A torn "
                         "or corrupt head falls back to the previous "
                         "valid checkpoint in the last-K chain with a "
                         "named warning")
    pc.add_argument("--resume-portable", action="store_true",
                    help="shape-portable resume (needs --spill): "
                         "re-partition any engine family's checkpoint "
                         "— classic, spill, or a JAX mesh of any device "
                         "count — onto this engine by re-inserting the "
                         "visited key set and re-homing the frontier "
                         "(resil/portable.py)")
    pc.add_argument("--ckpt-keep", type=int, default=2, metavar="K",
                    help="checkpoint-chain depth: keep the last K "
                         "checkpoints (FILE, FILE.1, ...), each with "
                         "a sha256 integrity sidecar (default 2; 1 = a "
                         "single file)")
    pc.add_argument("--retries", type=int, default=0, metavar="N",
                    help="supervised retry/backoff: on a transient "
                         "failure (a device error, an I/O error), "
                         "release the failed attempt and resume from "
                         "the newest valid checkpoint, up to N times "
                         "with bounded exponential backoff + jitter")
    pc.add_argument("--backoff", type=float, default=2.0, metavar="S",
                    help="base backoff seconds for --retries "
                         "(doubles per attempt, capped at 60s, "
                         "deterministic jitter)")
    pc.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault injection: e.g. "
                         "'dispatch:every=2;ckpt_torn:at=1' — a seeded "
                         "schedule firing at named engine sites "
                         "(dispatch, ckpt_torn, ckpt_corrupt, archive), "
                         "so every recovery path is testable on the "
                         "CPU")
    pc.add_argument("--invariant", dest="invariants",
                    action="append", default=None, metavar="NAME",
                    help="enable an extra invariant (repeatable)")
    pc.add_argument("--constraint", dest="constraint_overrides",
                    action="append", default=None, metavar="NAME",
                    help="enable an extra CONSTRAINT (repeatable)")
    pc.add_argument("--action-constraint", dest="action_constraints",
                    action="append", default=None, metavar="NAME",
                    help="enable an extra ACTION_CONSTRAINT (repeatable)")
    _add_obs_flags(pc)
    pt = sub.add_parser("trace", help="witness trace for a scenario")
    common(pt)
    pt.add_argument("--target", required=True, help=target_help)
    pt.add_argument("--emit-seed", default=None, metavar="FILE",
                    help="write the witness end state to FILE as a seed "
                         "for `check --seed-trace` (punctuated search)")
    # trace runs the default driver, as the reference's does
    pt.set_defaults(burst=True, burst_levels=None)
    ps = sub.add_parser(
        "simulate",
        help="random-walk scenario hunt (TLC -simulate analogue): W "
             "walkers sample enabled actions uniformly, for configs past "
             "the exhaustive engines' reach")
    common(ps)
    ps.add_argument("--target", required=True, help=target_help)
    ps.add_argument("--walkers", type=int, default=256,
                    help="fleet width W")
    ps.add_argument("--steps", type=int, default=10000,
                    help="synchronous fleet steps before giving up")
    ps.add_argument("--steps-per-dispatch", type=int, default=256,
                    help="walker steps per dispatch (the host reads the "
                         "stats once per dispatch)")
    ps.add_argument("--seed", type=int, default=0,
                    help="PRNG seed; a fixed seed replays the JAX "
                         "package's trajectories bit for bit, whatever "
                         "--walkers")
    ps.add_argument("--policy", choices=("punctuated", "tlc"),
                    default="punctuated",
                    help="restart policy: 'punctuated' (default) "
                         "resamples pruned successors and restarts "
                         "from per-walker scenario-ladder bases; "
                         "'tlc' is exact TLC -simulate shape (abandon "
                         "the walk on any pruned successor)")
    ps.add_argument("--bloom-bits", type=int, default=24,
                    help="log2 bits of the novelty Bloom filter behind "
                         "est_distinct_states")
    ps.add_argument("--mesh", action="store_true",
                    help="accepted for the reference CLI's surface: the "
                         "fleet runs on one device whatever the count "
                         "(a walker's stream depends on its global id "
                         "only, so the answer is the sharded fleet's)")
    ps.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the witness trace (labels) as JSON")
    ps.add_argument("--emit-seed", default=None, metavar="FILE",
                    help="write the witness end state as a seed for "
                         "`check --seed-trace` (simulation feeds "
                         "punctuated exhaustive search)")
    _add_obs_flags(ps)
    pb = sub.add_parser(
        "batch",
        help="batched checking: many (spec, config) jobs packed into "
             "one job-axis device program per shape bucket, with "
             "fingerprint-keyed result caching (README 'Batch / serving "
             "on the H100' documents the JSONL job format)")
    pb.add_argument("--jobs", default=None, metavar="FILE",
                    help="JSONL job file: one job object per line "
                         "(blank lines and #-comments skipped)")
    pb.add_argument("--job", action="append", default=None,
                    metavar="JSON",
                    help="inline job object (repeatable), same schema "
                         "as a --jobs line")
    pb.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="result cache: jobs whose (spec, config, "
                         "engine-options) fingerprints match a cached "
                         "result are answered with zero device "
                         "dispatches; results persist across "
                         "invocations")
    pb.add_argument("--cache-max-bytes", type=int, default=None,
                    metavar="N",
                    help="LRU-by-bytes cache bound: every completed "
                         "job's put trims the --cache-dir back under "
                         "N bytes, least-recently-used payloads "
                         "first (default: unbounded, the historical "
                         "behavior)")
    pb.add_argument("--executable-cache", default=None, metavar="DIR",
                    help="the reference's persistent executable cache "
                         "(serve/exec_cache): each new bucket program "
                         "is looked up and stored; a captured CUDA "
                         "graph cannot be written to disk, so every "
                         "store fails by name, the cache never hits, "
                         "and the summary and ledger count both")
    pb.add_argument("--executable-cache-max-bytes", type=int,
                    default=None, metavar="N",
                    help="LRU-by-bytes bound on the executable cache "
                         "directory (default: unbounded)")
    pb.add_argument("--sequential", action="store_true",
                    help="run each job on its own engine instead of "
                         "the batched path (the A/B reference: N jobs "
                         "pay N warm-ups)")
    pb.add_argument("--wave-state", default=None, metavar="DIR",
                    help="preemptible waves (serve/wavestate): "
                         "persist every live job's carry slice at "
                         "each wave boundary, so a killed run "
                         "resumes finished jobs from --cache-dir and "
                         "stragglers mid-BFS — bit-exact per job")
    pb.add_argument("--wave-yield", type=int, default=None,
                    metavar="N",
                    help="preemption: a wave yields its lanes after "
                         "N batched device calls while other jobs "
                         "wait (higher Job priority runs first); "
                         "parked jobs continue in a later wave")
    pb.add_argument("--max-wave", type=int, default=None, metavar="N",
                    help="jobs-per-wave ceiling (default 8); shrink "
                         "it to force parking or to bound wave memory")
    pb.add_argument("--wave-mesh", default="auto",
                    metavar="auto|N|JxS|off",
                    help="the wave's device mesh: 'auto' (default), "
                         "'off', 0 and 1 run every wave on one device; "
                         "a larger mesh is the multi-device wave mesh, "
                         "not ported (ROADMAP item 9d) and refused "
                         "with exit 2")
    pb.add_argument("--retries", type=int, default=0, metavar="N",
                    help="re-run the job list up to N times on a "
                         "transient failure, with bounded exponential "
                         "backoff — incremental via --cache-dir + "
                         "--wave-state")
    pb.add_argument("--backoff", type=float, default=2.0, metavar="S",
                    help="base backoff seconds for --retries")
    pb.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault injection (resil/"
                         "chaos); 'wave_kill:at=1' is the "
                         "deterministic stand-in for a kill at a wave "
                         "boundary")
    pb.add_argument("--sym-canon",
                    choices=("auto", "sort", "minperm"),
                    default="auto",
                    help="symmetry canonicalization for every bucket "
                         "engine and solo fallback (see check "
                         "--sym-canon)")
    pb.add_argument("--stats-json", default=None, metavar="FILE",
                    help="write the batch summary + per-job reports "
                         "as one JSON file")
    pb.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    pb.add_argument("--verbose", "-v", action="store_true")
    _add_obs_flags(pb)
    pb.set_defaults(fn=cmd_batch)
    _add_serve_parser(sub)

    _add_obs_parser(sub)
    args = ap.parse_args(argv)
    return {"check": cmd_check, "trace": cmd_trace,
            "simulate": cmd_simulate, "obs": cmd_obs,
            "batch": cmd_batch, "serve": cmd_serve}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
