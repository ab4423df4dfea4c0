"""Where the time goes in the PyTorch/CUDA port's check on one GPU.

    python tools/torch_profile.py [--config 1|5|pinned|paxos|sim|spill|mesh]
                                  [--max-depth 17] [--walkers 64]
                                  [--shards 4]
                                  [--steps 32] [--no-action-constraint]
                                  [--incremental-fp 0|1] [--hcap N]
                                  [--no-guard-matmul] [--no-delta-matmul]
                                  [--no-burst] [--eager] [--host-table]
                                  [--no-profile] [--out FILE]

Runs BASELINE config #1 or #5, or the cfg-pinned punctuated search
(the chip_smoke.py configurations and capacities; the pinned search
runs past its violations, and ``--no-action-constraint`` drops its
ACTION_CONSTRAINTS mask) through ``raft_tla_tpu_torch`` on the CUDA
device, in the
engine's defaults (the burst, each chunk step and burst iteration a
captured CUDA graph, the default fingerprint mode and expansion)
unless ``--incremental-fp 0`` turns the incremental path off,
``--no-guard-matmul`` / ``--no-delta-matmul`` the guard product / the
delta group, ``--no-burst`` the burst, and ``--eager`` the capture
(the engine's private ``_capture``): once plain, for the wall time
(its captures included), and once under ``torch.profiler`` (CPU +
CUDA activities), for the device time per kernel name
(``--no-profile`` skips this run: the profiler's summary takes
minutes past ~10^5 launches).  Prints one JSON object: the card, the
run's counts, the wall, the burst counters, the graphs captured and
replayed, the dedup kernel's launches (one per chunk step or burst
iteration) and, eager, their event time, the hard lanes of the
orbit-sort fallback, the device-busy total, the idle share of the
plain run's wall, the device kernels and the host's launch calls
(kernel launches and graph launches, by runtime call) per chunk step,
and the top kernels by device time.  A depth cut keeps the profiler's trace small; the runs
explore the same levels (a first, unmeasured run warms the allocator
and builds the kernels).  The pinned search also counts the device
kernels and time of one eager ``_expand_fp_chunk`` on a full chunk of
its seed rows, with the mask and without it (one engine each).

``--config paxos`` runs chip_smoke.py phase 15a's paxos model (two
instances, symmetry off, chunk 4096) to ``--max-depth`` (default 14),
and also counts the device kernels and time of one eager
``_expand_fp_chunk`` on a full chunk of the widest level's rows, and
of its ``derived`` alone (the Phase2a quorum loop's share).

``--config sim`` profiles the random-walk engine's step instead:
``--walkers`` walkers of chip_smoke.py's hit-free config #5 fleet
(phase 13c) take two steps (the warm-up and the capture), then
``--steps`` more are timed plain and once under the profiler: the wall
per step, the device-busy time per step and its share of the wall,
the device kernels per step and the top kernels.

``--config spill`` runs BASELINE config #2 (chip_smoke.py phase 14's)
on the host-spill engine to ``--max-depth`` (default 19; chunk 4096,
seg 2^21, no trace archive; ``--host-table`` adds the host-partitioned
table with 4 partitions), after a warm-up to depth 12, with a CUDA
event pair around every chunk step and burst iteration (a graph replay
or an eager call): their sum is the device-busy time of the steps, and
its complement in the wall the idle share.  The host's share is split
by what it does (the engine's ``host_seconds``: summary syncs, segment
copies down (d2h) and frontier and image uploads (h2d), the harvest,
the sweep and the reseed), beside the segments, bytes, summary reads,
captures and reseeds.  The profiler is not used: a run to depth 19
launches millions of kernels.

``--config mesh`` runs BASELINE config #1 on the sharded engine
(``parallel/mesh.py``, chip_smoke.py phase 21's capacities) with
``--shards`` D shards on the one card to ``--max-depth`` (default 16),
after a warm-up: the wall, the lock-step steps and flag reads, the
dedup launches; under the profiler the device-busy time, the idle
share of the plain run's wall and the device kernels per lock-step
step; the host's seconds blocked in the step's flag read against the
steps' host seconds (the read's share of a step); and, from an eager
run with CUDA events around each step and around its exchange, the
exchange's share of a step's device time.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("1", "5", "pinned", "paxos",
                                         "sim", "spill", "mesh"),
                    default="1")
    ap.add_argument("--shards", type=int, default=4,
                    help="shards on the card (--config mesh)")
    ap.add_argument("--max-depth", type=int, default=None,
                    help="default 17 (19 for --config spill, 14 for "
                         "--config paxos, 16 for --config mesh)")
    ap.add_argument("--host-table", action="store_true",
                    help="the host-partitioned table (--config spill)")
    ap.add_argument("--walkers", type=int, default=64,
                    help="the fleet's width (--config sim)")
    ap.add_argument("--steps", type=int, default=32,
                    help="fleet steps timed (--config sim)")
    ap.add_argument("--action-constraint",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="the pinned search's mask (--config pinned)")
    ap.add_argument("--incremental-fp", type=int, choices=(0, 1),
                    default=1)
    ap.add_argument("--hcap", type=int, default=None,
                    help="hard-lane buffer (default: the config's)")
    ap.add_argument("--guard-matmul", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--delta-matmul", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--burst", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--eager", action="store_true",
                    help="run the chunk step and the burst body "
                         "uncaptured")
    ap.add_argument("--profile", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.max_depth is None:
        args.max_depth = {"spill": 19, "paxos": 14,
                          "mesh": 16}.get(args.config, 17)
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from raft_tla_tpu_torch.cfg.parser import load_model
    from raft_tla_tpu_torch.config import Bounds
    from raft_tla_tpu_torch.engine import cuda_ext
    from raft_tla_tpu_torch.engine import fingerprint as fp
    from raft_tla_tpu_torch.engine.bfs import Engine

    card = cs.card_line()
    cuda_ext.library()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args.config == "sim":
        return _print(sim_profile(torch, profile, ProfilerActivity, cs,
                                  root, card, args), args)
    if args.config == "spill":
        return _print(spill_profile(torch, cs, root, card, args), args)
    if args.config == "mesh":
        return _print(mesh_profile(torch, profile, ProfilerActivity, cs,
                                   root, card, args), args)
    path = os.path.join(root, "configs/tlc_membership/raft.cfg")
    stop = True
    if args.config == "1":
        cfg = load_model(path, bounds=Bounds.make(**cs.CONFIG1_BOUNDS))
        engine_kw, budget = cs.CONFIG1_ENGINE, cs.CONFIG1_MAX_STATES
    elif args.config == "pinned":
        tmp = tempfile.mkdtemp()
        cfg = load_model(cs.pinned_cfg(root, tmp), bounds=None)
        shutil.rmtree(tmp)
        b = cfg.bounds
        cfg = cfg.with_(bounds=Bounds.make(
            max_membership_changes=b.max_membership_changes,
            max_trace=b.max_trace, **cs.PIN_BOUNDS))
        if not args.action_constraint:
            cfg = cfg.with_(action_constraints=())
        engine_kw, budget, stop = cs.CONFIG1_ENGINE, 10 ** 9, False
    elif args.config == "paxos":
        from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig
        cfg = PaxosConfig(n_instances=2, symmetry=False)
        engine_kw = dict(chunk=4096, lcap=1 << 21, vcap=1 << 26)
        budget = 10 ** 9
    else:
        cfg = load_model(path, bounds=Bounds.make(**cs.CONFIG5_BOUNDS))
        cfg = cfg.with_(**cs.CONFIG5_SHAPE)
        engine_kw, budget = cs.CONFIG5_ENGINE, cs.CONFIG5_MAX_STATES
    if args.hcap:
        engine_kw = dict(engine_kw, hcap=args.hcap)

    def run():
        eng = Engine(cfg, store_states=False, device="cuda",
                     incremental_fp=bool(args.incremental_fp),
                     guard_matmul=args.guard_matmul,
                     delta_matmul=args.delta_matmul, burst=args.burst,
                     **engine_kw)
        eng._capture = not args.eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.check(max_depth=args.max_depth, max_states=budget,
                        stop_on_violation=stop)
        return res, time.perf_counter() - t0, eng

    run()                                  # warm-up: allocator, kernels
    fp.PROBE_CLAIM_LAUNCHES.reset(timing=args.eager)
    res, wall, eng = run()
    launches = fp.PROBE_CLAIM_LAUNCHES.count
    dedup_ms = fp.PROBE_CLAIM_LAUNCHES.total_ms() if args.eager else None
    fp.PROBE_CLAIM_LAUNCHES.reset()
    out = {
        "card": card,
        "config": args.config,
        "action_constraints": list(cfg.action_constraints),
        "max_depth": args.max_depth,
        "burst": args.burst,
        "captured": not args.eager,
        "sym_canon": res.sym_canon,
        "incremental_fp": eng.incremental_fp and
        eng.fpr.supports_incremental(),
        "guard_matmul": eng.guard_matmul,
        "delta_matmul": eng.expander.delta_active,
        "distinct_states": res.distinct_states,
        "generated_states": res.generated_states,
        "depth": res.depth,
        "level_sizes": res.level_sizes,
        "violations": len(res.violations),
        "wall_s": wall,
        "states_per_s": res.distinct_states / wall,
        "levels_fused": res.levels_fused,
        "burst_dispatches": res.burst_dispatches,
        "burst_bailouts": res.burst_bailouts,
        "graph_captures": eng._graphs.captures,
        "graph_replays": eng._graphs.replays,
        "dedup_launches": launches,
        "dedup_event_ms": dedup_ms,
        "hcap_initial": engine_kw.get("hcap"),
        "hcap": eng.HCAP,
        "hard_lanes": res.hard_lanes,
        "hard_chunks": res.hard_chunks,
        "hard_chunk_max": res.hard_chunk_max,
    }
    if args.profile:
        fp.PROBE_CLAIM_LAUNCHES.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _res, wall_prof, _eng = run()
        steps = fp.PROBE_CLAIM_LAUNCHES.count
        rows, calls = _kernel_rows(torch, prof)
        busy_ms = sum(r[0] for r in rows) / 1e3
        n_launch = sum(r[2] for r in rows)
        out.update({
            "profiled_wall_s": wall_prof,
            "device_busy_ms": busy_ms,
            # against the unprofiled wall: the kernels are the same, the
            # profiler only slows the host
            "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
            "device_launches": n_launch,
            "chunk_steps": steps,
            "launches_per_chunk": n_launch / max(steps, 1),
            "host_launch_calls": calls,
            "host_launch_calls_per_chunk":
                sum(calls.values()) / max(steps, 1),
            "top_kernels": [{"name": k[:120], "device_ms": us / 1e3,
                             "calls": n} for us, k, n in rows[:args.top]],
        })
    if args.config == "pinned":
        out["front_half"] = front_half_cost(torch, profile,
                                            ProfilerActivity, Engine, cfg,
                                            engine_kw)
    if args.config == "paxos":
        out["front_half"] = paxos_front_half(torch, profile,
                                             ProfilerActivity, Engine, cfg,
                                             engine_kw, args.max_depth)
    return _print(out, args)


def _print(out, args):
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)
    return 0


def _kernel_rows(torch, prof):
    """(rows, calls): the device kernels as (device us, name, count),
    longest first, and the host's launch calls into the runtime by
    name.  Device-side events only: an operator's row repeats the
    device time of the kernels it launched."""
    rows, calls = [], {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if "Launch" in e.key and e.key.startswith("cu"):
                calls[e.key] = e.count
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    return rows, calls


def mesh_profile(torch, profile, ProfilerActivity, cs, root, card, args):
    """Config #1 on the sharded engine with ``--shards`` shards on the
    card: wall, steps and reads; the profiler's device time and kernels
    per lock-step step; the flag read's share of a step's host time;
    the exchange's share of an eager step's device time."""
    from raft_tla_tpu_torch.cfg.parser import load_model
    from raft_tla_tpu_torch.config import Bounds
    from raft_tla_tpu_torch.engine import fingerprint as fp
    from raft_tla_tpu_torch.parallel import mesh
    cfg = load_model(os.path.join(root, "configs/tlc_membership/raft.cfg"),
                     bounds=Bounds.make(**cs.CONFIG1_BOUNDS))
    D = args.shards

    def run(capture=True):
        eng = mesh.ShardedEngine(cfg, devices=["cuda:0"] * D,
                                 store_states=False, burst=args.burst,
                                 **cs.MESH_ENGINE)
        eng._capture = capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.check(max_depth=args.max_depth,
                        max_states=cs.CONFIG1_MAX_STATES)
        return res, time.perf_counter() - t0, eng

    run()                                  # warm-up: allocator, kernels
    fp.PROBE_CLAIM_LAUNCHES.reset()
    # the host's seconds in each lock-step step and in its flag read
    host = {"step": 0.0, "read": 0.0}
    step, read = mesh.ShardedEngine._lockstep, mesh.ShardedEngine._read_flags

    def timed(name, fn):
        def wrapped(self, *a):
            t = time.perf_counter()
            try:
                return fn(self, *a)
            finally:
                host[name] += time.perf_counter() - t
        return wrapped
    mesh.ShardedEngine._lockstep = timed("step", step)
    mesh.ShardedEngine._read_flags = timed("read", read)
    try:
        res, wall, eng = run()
    finally:
        mesh.ShardedEngine._lockstep, mesh.ShardedEngine._read_flags = \
            step, read
    out = {"card": card, "config": "mesh", "shards": D,
           "max_depth": args.max_depth, "burst": args.burst,
           "distinct_states": res.distinct_states,
           "generated_states": res.generated_states, "depth": res.depth,
           "level_sizes": res.level_sizes, "wall_s": wall,
           "states_per_s": res.distinct_states / wall,
           "lockstep_steps": eng.lockstep_steps,
           "flag_reads": eng.flag_reads,
           "dedup_launches": fp.PROBE_CLAIM_LAUNCHES.count,
           "graph_captures": eng.captures, "graph_replays": eng.replays,
           "steps_host_s": host["step"], "flag_read_host_s": host["read"],
           "flag_read_share_of_step": host["read"] / max(host["step"],
                                                         1e-9)}
    fp.PROBE_CLAIM_LAUNCHES.reset()
    if args.profile:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _res, wall_prof, eng_p = run()
        rows, calls = _kernel_rows(torch, prof)
        busy_ms = sum(r[0] for r in rows) / 1e3
        n_launch = sum(r[2] for r in rows)
        out.update({
            "profiled_wall_s": wall_prof,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
            "device_launches": n_launch,
            "kernels_per_lockstep_step": n_launch / max(
                eng_p.lockstep_steps, 1),
            "host_launch_calls": calls,
            "top_kernels": [{"name": k[:120], "device_ms": us / 1e3,
                             "calls": c} for us, k, c in rows[:args.top]]})
    # eager: CUDA events around each step and around its exchange
    ev = {"step": [], "exchange": []}
    exch = mesh._Windows.exchange

    def ev_wrap(name, fn):
        def wrapped(self, *a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            try:
                return fn(self, *a)
            finally:
                e1.record()
                ev[name].append((e0, e1))
        return wrapped
    mesh.ShardedEngine._lockstep = ev_wrap("step", step)
    mesh._Windows.exchange = ev_wrap("exchange", exch)
    try:
        _res, wall_e, _eng = run(capture=False)
    finally:
        mesh.ShardedEngine._lockstep = step
        mesh._Windows.exchange = exch
    torch.cuda.synchronize()
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in ev.items()}
    out.update({"eager_wall_s": wall_e, "eager_steps_ms": ms["step"],
                "eager_exchange_ms": ms["exchange"],
                "exchange_share_of_step": ms["exchange"] /
                max(ms["step"], 1e-9)})
    return out


def sim_profile(torch, profile, ProfilerActivity, cs, root, card, args):
    """The walker step of the hit-free config #5 fleet: wall and device
    time per step, kernels per step, the top kernels."""
    from raft_tla_tpu_torch.sim import SimEngine
    eng = SimEngine(cs._fleet_cfg(root), device="cuda",
                    **dict(cs.SIM_FLEET, walkers=args.walkers))
    eng._capture = not args.eager
    st = eng._dispatch(eng.fresh_carry(), 2, False)   # warm-up, capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._dispatch(st, args.steps, False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"card": card, "config": "sim", "walkers": args.walkers,
           "steps": args.steps, "captured": not args.eager,
           "wall_s": wall, "wall_ms_per_step": wall * 1e3 / args.steps,
           "graph_replays": eng._graphs.replays}
    if args.profile:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng._dispatch(st, args.steps, False)
            torch.cuda.synchronize()
        rows, calls = _kernel_rows(torch, prof)
        busy_ms = sum(r[0] for r in rows) / 1e3
        n = sum(r[2] for r in rows)
        out.update({
            "device_busy_ms_per_step": busy_ms / args.steps,
            "device_busy_share": busy_ms / (wall * 1e3),
            "device_kernels_per_step": n / args.steps,
            "mean_kernel_us": busy_ms * 1e3 / max(n, 1),
            "host_launch_calls": calls,
            "top_kernels": [{"name": k[:120], "device_ms": us / 1e3,
                             "calls": c} for us, k, c in rows[:args.top]],
        })
    return out


def spill_profile(torch, cs, root, card, args):
    """Config #2 on the spill engine: the steps' device-busy time by CUDA
    events, the wall, and the host's time by kind of work."""
    from raft_tla_tpu_torch.cfg.parser import load_model
    from raft_tla_tpu_torch.config import Bounds
    from raft_tla_tpu_torch.engine.graph import GraphRunner
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    tmp = tempfile.mkdtemp()
    cfg = load_model(cs._config2_cfg(root, tmp),
                     bounds=Bounds.make(**cs.CONFIG2_BOUNDS))
    shutil.rmtree(tmp)
    events = []
    run = GraphRunner.run

    def timed(self, key, fn):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        run(self, key, fn)
        b.record()
        events.append((a, b))

    def go(depth):
        eng = SpillEngine(cfg, chunk=4096, seg=1 << 21, store_states=False,
                          host_table=args.host_table, partitions=4,
                          burst=args.burst, device="cuda")
        eng._capture = not args.eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.check(max_depth=depth)
        return eng, res, time.perf_counter() - t0

    go(12)                                 # warm-up: allocator, kernels
    GraphRunner.run = timed
    try:
        eng, res, wall = go(args.max_depth)
    finally:
        GraphRunner.run = run
    torch.cuda.synchronize()
    busy_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    host = {k: round(v, 4) for k, v in sorted(eng.host_seconds.items())}
    return {
        "card": card, "config": "spill", "host_table": args.host_table,
        "max_depth": args.max_depth, "captured": not args.eager,
        "distinct_states": res.distinct_states, "depth": res.depth,
        "level_sizes": res.level_sizes, "wall_s": wall,
        "states_per_s": res.distinct_states / wall,
        "steps": len(events), "step_busy_s": busy_s,
        "device_busy_share": busy_s / wall,
        "device_idle_share": 1.0 - busy_s / wall,
        "host_s": host,
        "host_share": {k: v / wall for k, v in host.items()},
        "segments_spilled": eng.segments_spilled,
        "segments_by_level": eng.segments_by_level,
        "bytes_down": eng.bytes_down, "bytes_up": eng.bytes_up,
        "summary_syncs": eng.summary_syncs,
        "graph_captures": eng._graphs.captures,
        "reseeds": eng.reseeds,
        "sweep_stage_hits": eng.sweep_stage_hits,
        "sweep_stage_misses": eng.sweep_stage_misses,
        "levels_fused": res.levels_fused,
        "final_vcap": eng.VCAP,
    }


def front_half_cost(torch, profile, ProfilerActivity, Engine, cfg,
                    engine_kw):
    """Device kernels and device ms of one eager ``_expand_fp_chunk`` on
    a full chunk of the seed rows, with the cfg's action constraint and
    without it (the mask's own cost per chunk step)."""
    from raft_tla_tpu_torch.convert import rows_to_torch
    out = {}
    for name, c in (("with_mask", cfg.with_(action_constraints=(
            "CommitWhenConcurrentLeaders_action_constraint",))),
                    ("without_mask", cfg.with_(action_constraints=()))):
        eng = Engine(c, store_states=False, device="cuda", **engine_kw)
        roots, _keys, _interiors = eng._dedup_roots()
        sv = rows_to_torch(roots, "cuda")
        n = sv["ct"].shape[-1]
        idx = torch.arange(eng.chunk, device="cuda") % n
        sv = eng.ir.widen({k: v.index_select(-1, idx)
                           for k, v in sv.items()})
        valid = torch.ones(eng.chunk, dtype=torch.bool, device="cuda")
        out[name] = _device_cost(
            torch, profile, ProfilerActivity,
            lambda: eng._expand_fp_chunk(sv, valid, eng.FCAP))
    out["mask_kernels"] = (out["with_mask"]["device_kernels"] -
                           out["without_mask"]["device_kernels"])
    out["mask_device_ms"] = (out["with_mask"]["device_ms"] -
                             out["without_mask"]["device_ms"])
    return out


def _device_cost(torch, profile, ProfilerActivity, fn):
    """(device kernels, device ms) of one call of ``fn`` after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = dev_us = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            kernels += e.count
            dev_us += us
    return {"device_kernels": kernels, "device_ms": dev_us / 1e3}


def paxos_front_half(torch, profile, ProfilerActivity, Engine, cfg,
                     engine_kw, depth):
    """Device kernels and ms of one eager ``_expand_fp_chunk`` on a full
    chunk of the paxos run's widest level, and of ``derived`` alone."""
    from raft_tla_tpu_torch.convert import rows_to_torch
    eng = Engine(cfg, store_states=True, device="cuda", **engine_kw)
    eng.check(max_depth=depth)
    last = max(eng._states, key=lambda s: len(s["ctr"]))   # widest level
    n = len(last["ctr"])
    idx = np.arange(eng.chunk) % n
    sv = eng.ir.widen(rows_to_torch({k: v[idx] for k, v in last.items()},
                                    "cuda", eng.ir.u32_keys))
    valid = torch.ones(eng.chunk, dtype=torch.bool, device="cuda")
    return {
        "rows": eng.chunk, "quorums": len(cfg.quorums),
        "expand_fp_chunk": _device_cost(
            torch, profile, ProfilerActivity,
            lambda: eng._expand_fp_chunk(sv, valid, eng.FCAP)),
        "derived": _device_cost(torch, profile, ProfilerActivity,
                                lambda: eng.kern.derived(sv))}


if __name__ == "__main__":
    raise SystemExit(main())
