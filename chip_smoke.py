#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raft_tla_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from raft_tla_tpu_torch/csrc (nvcc);
  3. hold the dedup kernel against its plain twin on the card: a
     forced-collision fixture, a contended batch, a full table (hovf)
     and a BASELINE config #1-sized batch — table, fresh, pos and hovf
     must be equal;
  4. the main path: ``Engine(config #1).check(max_states=2_000_000)``
     on the card must give 2,540,315 distinct states, depth 19, no
     violation, and the reference's level sizes; the kernel's launches
     in this run are counted and timed;
  5. ``trace --target FirstCommit`` on a micro config must give the
     reference's 15-step witness, and the same micro check on the CPU
     (plain twin) must agree with the card.

Prints the kernel table as one JSON line, then the card line, then
``{"ok": true, "device": {...}}`` last.  Exits non-zero without a
result when CUDA is absent or the package is not beside this script.
"""

import json
import os
import subprocess
import sys
import time

# BASELINE config #1 (tools/measure_baseline.py: build_cfg(1), BUDGET,
# ENGINE_KW) and its answer (baseline_runs/config1.json).
CONFIG1_BOUNDS = dict(max_log_length=2, max_timeouts=1,
                      max_client_requests=3)
CONFIG1_ENGINE = dict(chunk=2048, lcap=1 << 21, vcap=1 << 24, ocap=1 << 14)
CONFIG1_MAX_STATES = 2_000_000
CONFIG1_DISTINCT, CONFIG1_DEPTH = 2_540_315, 19
# Post-constraint level sizes of config #1, levels 1..19, as the JAX
# package's Engine recorded them (baseline_runs/round4_deep.json,
# "config1_depth21_r4", the first 19 of 21 levels); a JAX CPU run of the
# reference (Engine(burst=False, chunk=256).check(max_depth=14)) gave
# the same first 14 sizes.
CONFIG1_LEVEL_SIZES = [1, 2, 4, 7, 12, 19, 28, 40, 57, 84, 154, 397, 1252,
                       4091, 12873, 38411, 108856, 294895, 768234]
# The reference's FirstCommit witness on the phase-5 micro config
# (2 servers, NextAsync, symmetry, MaxInFlight 2, bounds 1/1/1) from the
# JAX package's Engine(burst=False, chunk=64) with
# invariants=("FirstCommit",), stop_on_violation=True: state id 354.
MICRO_TRACE = ["Init", "Timeout(0)", "RequestVote(0,0)", "RequestVote(0,1)",
               "UpdateTerm[slot1]", "Receive[slot0]", "Receive[slot0]",
               "Receive[slot1]", "Receive[slot0]", "BecomeLeader(0)",
               "ClientRequest(0,1)", "AppendEntries(0,1)", "Receive[slot0]",
               "Receive[slot0]", "Receive[slot0]", "AdvanceCommitIndex(0)"]
MICRO_TRACE_GID = 354
# H100 SXM device-memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12


def log(msg):
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _keys(rng, n, W, salt=0):
    """n distinct u32 keys [W, n], never all-ones: word 1 is a bijective
    mix of a counter, so the keys differ whatever word 0 draws."""
    import numpy as np
    from raft_tla_tpu_torch.utils import fmix32_np
    k = rng.randint(0, 0xFFFFFFFF, size=(W, n), dtype=np.uint64)
    k = k.astype(np.uint32)
    k[1] = fmix32_np(np.arange(n, dtype=np.uint64) + salt)
    return k


def kernel_phase(torch, fp, cvt, home_slots, card):
    """Phase 3: kernel vs plain twin on four fixtures; returns the
    measurements of the config #1-sized case."""
    import numpy as np
    dev = torch.device("cuda")
    rng = np.random.RandomState(2024)
    W = 2
    errs = []

    def both(table_np, keys_np, live_np):
        """Run kernel (card) and twin (plain) from the same inputs."""
        t_k = cvt.words_to_torch(table_np, dev)
        t_p = t_k.clone()
        keys = cvt.words_to_torch(keys_np, dev)
        live = torch.from_numpy(live_np).to(dev)
        fk, pk, hk = fp.probe_claim_insert(t_k, keys, live)
        torch.cuda.synchronize()
        fpl, ppl, hpl = fp.probe_claim_insert_plain(t_p, keys, live)
        # largest absolute difference over every output (u32 words
        # compared as u32)
        errs.append(max(
            int((t_k.long() & 0xFFFFFFFF).sub(t_p.long() & 0xFFFFFFFF)
                .abs().max()),
            int((pk.long() - ppl.long()).abs().max()),
            int((fk.long() - fpl.long()).abs().max()),
            abs(int(bool(hk)) - int(bool(hpl)))))
        check(torch.equal(t_k, t_p), "table differs")
        check(torch.equal(fk, fpl), "fresh differs")
        check(torch.equal(pk, ppl), "pos differs")
        check(bool(hk) == bool(hpl), "hovf differs")
        return t_k, keys, live, fk, pk, bool(hk)

    def empty(vcap):
        return np.full((W, vcap), 0xFFFFFFFF, np.uint32)

    # (a) forced collisions: VCAP 128, M 96 over 24 distinct keys, dead
    # lanes, a pre-populated cohort
    distinct = _keys(rng, 24, W, salt=1)
    keys = distinct[:, rng.randint(0, 24, size=96)]
    live = rng.rand(96) > 0.2
    keys[:, ~live] = 0xFFFFFFFF
    t0, *_ = both(empty(128), distinct[:, :4], np.ones(4, bool))
    _t, _k, _l, f, _p, h = both(cvt.words_to_numpy(t0), keys, live)
    check(int(f.sum()) < int(live.sum()) and not h, "fixture (a) vacuous")
    log("phase 3a forced-collision fixture: kernel == twin")
    # (b) contended: VCAP 1024, M 400 distinct keys, all live
    both(empty(1024), _keys(rng, 400, W, salt=2), np.ones(400, bool))
    log("phase 3b contended fixture (VCAP 1024, M 400): kernel == twin")
    # (c) a full table: every live lane exhausts its probe budget
    full = _keys(rng, 64 + 8, W, salt=3)
    _t, _k, _l, f, _p, h = both(full[:, :64], full[:, 64:],
                                np.ones(8, bool))
    check(h and not bool(f.any()), "fixture (c) did not overflow")
    log("phase 3c full table (hovf): kernel == twin")
    # (d) config #1-sized: VCAP 2^24 filled to 35%, M 32768 with
    # duplicates (in-table and in-batch); the fill runs on the kernel
    vcap, M = 1 << 24, 32768
    pool = _keys(rng, int(0.35 * vcap) + M, W, salt=4)
    fill = cvt.words_to_torch(pool[:, :int(0.35 * vcap)], dev)
    table = torch.full((W, vcap), -1, dtype=torch.int32, device=dev)
    fp.probe_claim_insert(table, fill, torch.ones(fill.shape[1],
                                                  dtype=torch.bool,
                                                  device=dev))
    torch.cuda.synchronize()
    pick = np.concatenate([rng.randint(0, int(0.35 * vcap), M // 4),
                           int(0.35 * vcap) + rng.randint(0, M // 2,
                                                          M - M // 4)])
    keys = pool[:, pick]
    live = np.ones(M, bool)
    table_np = cvt.words_to_numpy(table)
    _t, keys_t, live_t, f, p, h = both(table_np, keys, live)
    check(not h, "fixture (d) overflowed")
    log(f"phase 3d config #1-sized fixture (VCAP 2^24 at 35%, M {M}): "
        f"kernel == twin, {int(f.sum())} fresh")
    # time the kernel (fresh table copy per launch) and the twin
    src = cvt.words_to_torch(table_np, dev)
    reps, ms = 5, []
    for _ in range(reps):
        tb = src.clone()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fp.probe_claim_insert(tb, keys_t, live_t)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    tb = src.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fp.probe_claim_insert_plain(tb, keys_t, live_t)
    plain_ms = (time.perf_counter() - t0) * 1e3
    # bytes the function must move: keys + live in, the table words its
    # probes read, the claimed words written, fresh + pos + hovf out
    home = home_slots(keys_t, vcap).long()
    tri = torch.arange(fp.MAX_PROBE_ROUNDS, device=dev, dtype=torch.int64)
    tri = tri * (tri + 1) // 2
    steps = ((home[:, None] + tri[None, :]) & (vcap - 1)) == \
        p.long()[:, None]
    probes = int((steps.int().argmax(1) + 1).sum())
    n_fresh = int(f.sum())
    nbytes = (4 * W * M + M + 4 * W * probes + 4 * W * n_fresh + M +
              4 * M + 4)
    kern_ms = sorted(ms)[len(ms) // 2]
    log(f"phase 3 timing [{card}]: kernel {kern_ms:.3f} ms (median of "
        f"{reps}), plain twin {plain_ms:.1f} ms, {probes} probes, "
        f"{nbytes} bytes")
    return dict(max_abs_err=max(errs), ms=kern_ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, probes=probes)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from raft_tla_tpu_torch.cfg.parser import load_model
        from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
        from raft_tla_tpu_torch.engine import cuda_ext
        from raft_tla_tpu_torch.engine import fingerprint as fp
        from raft_tla_tpu_torch.engine.bfs import Engine
        from raft_tla_tpu_torch import convert as cvt
        from raft_tla_tpu_torch.utils import home_slots
    except ImportError as e:
        print(f"chip_smoke: the raft_tla_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 3
    here = os.path.dirname(os.path.abspath(__file__))

    # phase 1
    card = card_line()
    log(card)
    # phase 2
    t0 = time.perf_counter()
    cuda_ext.build(verbose=True)            # prints ptxas's resource use
    cuda_ext.library()
    log(f"phase 2 build and load: {time.perf_counter() - t0:.1f} s")
    # phase 3
    meas = kernel_phase(torch, fp, cvt, home_slots, card)
    # phase 4: the main path
    cfg1 = load_model(os.path.join(here, "configs/tlc_membership/raft.cfg"),
                      bounds=Bounds.make(**CONFIG1_BOUNDS))
    eng = Engine(cfg1, store_states=False, device="cuda", **CONFIG1_ENGINE)
    torch.cuda.synchronize()
    fp.PROBE_CLAIM_LAUNCHES.reset(timing=True)
    t0 = time.perf_counter()
    res = eng.check(max_states=CONFIG1_MAX_STATES)
    wall = time.perf_counter() - t0
    launches = fp.PROBE_CLAIM_LAUNCHES.count
    kern_total = fp.PROBE_CLAIM_LAUNCHES.total_ms()
    fp.PROBE_CLAIM_LAUNCHES.reset()
    log(f"phase 4 config #1 [{card}]: distinct {res.distinct_states}, "
        f"depth {res.depth}, violations {len(res.violations)}, "
        f"generated {res.generated_states}")
    log(f"phase 4 config #1 [{card}]: wall {wall:.2f} s, "
        f"{res.distinct_states / wall:.0f} states/s")
    log(f"phase 4 config #1 [{card}]: probe_claim_insert launches "
        f"{launches}, kernel time {kern_total:.1f} ms (CUDA events)")
    check(res.distinct_states == CONFIG1_DISTINCT,
          f"distinct {res.distinct_states} != {CONFIG1_DISTINCT}")
    check(res.depth == CONFIG1_DEPTH, f"depth {res.depth}")
    check(not res.violations and res.violations_global == 0,
          "config #1 reported violations")
    check(res.level_sizes == CONFIG1_LEVEL_SIZES,
          f"level sizes {res.level_sizes}")
    check(res.overflow_faults == 0, "overflow faults")
    check(launches > 0, "the main path never launched the kernel")
    # phase 5: a witness trace on the micro config, card vs CPU
    micro = ModelConfig(
        n_servers=2, init_servers=(0, 1), values=(1,),
        next_family=NEXT_ASYNC, symmetry=True, max_inflight_override=2,
        invariants=("FirstCommit",),
        bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                           max_client_requests=1))
    runs = {}
    for dev in ("cuda", "cpu"):
        e = Engine(micro, chunk=64, device=dev)
        r = e.check(stop_on_violation=True)
        check(r.violations, f"{dev}: no FirstCommit witness")
        gid = r.violations[0].state_id
        runs[dev] = (r.distinct_states, r.level_sizes, gid,
                     [lbl for lbl, _ in e.trace(gid)])
    check(runs["cuda"] == runs["cpu"], f"card vs CPU: {runs}")
    check(runs["cuda"][2] == MICRO_TRACE_GID and
          runs["cuda"][3] == MICRO_TRACE,
          f"FirstCommit witness {runs['cuda'][2:]}")
    log(f"phase 5 FirstCommit witness: {len(MICRO_TRACE) - 1} steps, "
        "card == CPU == reference")
    check(not any(m.split(".")[0] in ("jax", "raft_tla_tpu")
                  for m in sys.modules), "JAX or its package was imported")

    print(json.dumps({"kernels": [{
        "name": "probe_claim_insert", "route": "cuda",
        "source": "raft_tla_tpu_torch/csrc/probe_claim.cu",
        "replaces": "raft_tla_tpu/engine/fingerprint.py:1025",
        "launches": launches, "max_abs_err": meas["max_abs_err"],
        "ms": meas["ms"], "plain_ms": meas["plain_ms"],
        "bound_ms": meas["bound_ms"], "bound_by": "bytes",
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
