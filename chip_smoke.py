#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raft_tla_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from raft_tla_tpu_torch/csrc (nvcc);
  3. hold the dedup kernel against its plain twin on the card: (a) a
     forced-collision fixture, (b) a contended batch, (c) a full table
     (hovf), (d) a BASELINE config #1-sized batch, (e) a same-home
     chain, (f) a rehash-shaped reinsert of a 2^20 table into 2^21,
     (g) the all-ones key among dead lanes and (h) the spill engine's
     shapes at config #2 depth 20 (VCAP 2^26, M 131,072) — table,
     fresh, pos and hovf must be equal, two launches must give the same
     outputs, and the kernel's claim rounds must equal the CPU model's
     (``probe_claim_insert_rounds``); (d), (f) and (h) are timed; then
     (b), (c), (d) and (g) again with ``fp128``'s 4-word keys, (d)
     timed;
  4. the main path: ``Engine(config #1).check(max_states=2_000_000)``
     on the card, in the engine's defaults (the burst for the small
     levels, each chunk step and burst iteration a captured CUDA graph,
     the int8 guard product and the delta group, incremental
     fingerprints at 6 permutations, the trace archives in host RAM),
     must give 2,540,315 distinct states, depth 19, no violation, the
     reference's level sizes and fused levels; the kernel's launches in
     this run are counted, one per launch a replayed graph holds, and
     the last state's trace is kept for phase 12; then the same check
     with direct
     fingerprints (``incremental_fp=False``), and once more with the
     plain expansion (``guard_matmul=False, delta_matmul=False``),
     which must give the same answer;
  5. BASELINE config #5 (5 servers, 120 permutations: "auto" resolves
     to the orbit-sort canonicalizer) with the reference's 600,000-state
     budget must give 937,554 distinct states, depth 20, no violation,
     the reference's level sizes and fused levels; its kernel launches
     are counted, and the chunks whose hard lanes took the
     min-over-perms fallback are counted;
  6. ``trace --target FirstCommit`` on a micro config must give the
     reference's 15-step witness, and the same micro check on the CPU
     (plain twin) must agree with the card;
  7. the expansion's two card-only paths, bit for bit, on the frontier
     chunks of config #1 to depth 16: the guard product through
     ``torch._int_mm`` against the term form, and the delta group's
     candidates, counts and incremental fingerprints against the
     per-family kernels on the card and against the CPU's for the same
     chunk; the guard product and ``materialize`` are timed per chunk;
  8. the captured chunk step against the eager one (the engine's
     private ``_capture = False``) on config #1 to depth 16 on the
     per-level path: archives (parents, lanes, states) and counts bit
     for bit, the walls timed in turns (eager, graph, graph, eager);
     the eager runs time each dedup launch with CUDA events (a capture
     holds no timing event), which gives the kernel's main-path time;
  9. config #1 as in phase 4 with ``fp128=True`` (4-word dedup keys):
     the same answer;
 10. the punctuated search, through the CLI in this process: (a) ``check
     --keep-going`` to depth 11 of the tlc cfg with its upstream pin
     lines enabled (prefix pin, action constraint, invariant) must give
     the reference's distinct states, level sizes, interior states,
     violations and first witness, and the CPU to depth 8 the card's
     first levels; (b) ``trace --emit-seed`` and ``check --seed-trace
     --action-constraint`` without pins give the same exit codes,
     witness, seed file and stats on the card and on the CPU;
 11. BASELINE config #3 (NextDynamic, Server=4 over InitServer=3, the
     membership invariant) with the reference's 1,500,000-state budget
     must give 2,875,461 distinct states, depth 17, no violation and the
     reference's level sizes, with no level replayed for LCAP;
 12. checkpoints: (a) config #1 as in phase 4 under ``supervised_check``
     (checkpoints every 5 levels in a chain of 2, the trace archives in
     a ``DiskArchive``, 2 retries) with a chaos schedule that tears the
     second checkpoint's head and raises at the dispatch of a later
     level: the retry resumes from ``.1`` with a ChainWarning and must
     give phase 4's answer in 2 attempts, its last state's trace
     through the disk archive equal to phase 4's in-RAM one; each
     checkpoint's bytes and write seconds, the resume's seconds, the
     captures after it and the temp directory's free space are
     printed (the phase fails if that space cannot hold the chain and
     the archive); (b) the pinned search of phase 10 through the CLI,
     checkpointed at depth 6 on the card and resumed on the CPU to
     depth 8, and the other way round: both equal phase 10a's
     uninterrupted CPU run;
 13. the random-walk simulator: (a) the README's BASELINE config #5
     hunt (64 walkers, MembershipChangeCommits) through ``simulate`` in
     this process must give the reference's witness (walker 7, depth
     120), stats, labels and trace file, and the oracle must replay the
     witness; (b) its seed file must be the reference's, and ``check
     --seed-trace`` of it must give the same answer on the card and on
     the CPU, launching the dedup kernel; (c) the hit-free config #5
     fleet at 16,384 walkers: its first 64 walkers must equal a
     64-walker fleet's, and that fleet the CPU's over its first 32
     steps (the whole carry); walker-steps/s, one captured step's
     device time and the peak device memory are printed; (d) the
     captured walker step against the eager one on a micro fleet, bit
     for bit;
 14. the host-spill engine: (a) ``SpillEngine`` on BASELINE config #2
     (chunk 4096, seg 2^22, the trace archives in host RAM) to depth
     20 must give the reference's recorded spill run
     (baseline_runs/round4_deep.json ``config2_depth20``): 22,475,807
     distinct states, its 20 level sizes, no violation and no overflow
     fault, more than one level segment spilled at level 20, levels
     fused by the burst, and the last state's trace replayed by the
     oracle step by step; wall, states/s, launches, segments and bytes
     each way, summary reads, graph captures and the peaks of device
     memory and host RSS are printed; (b) the classic engine
     checkpoints config #2 at depth 16, then ``check --spill
     --host-table --partitions 4 --resume-portable`` continues it
     through the CLI to depth 18 (2,443,370 states, with at least one
     reseed of the device cache) writing a spill checkpoint, and a
     resume of that checkpoint prints the same stats line; the largest
     reseed's frontier keys go through the kernel and the plain twin
     at its VCAP (equal tables, fresh and pos), and the engine's
     reseeded cache must be that table and hold every key;
 15. the paxos tenant, through the CLI in this process: (a) ``check
     --spec paxos --instances 2 --no-symmetry`` must give the full
     15,374,241-state space (3,921^2: the two instances are independent,
     so the level sizes are the self-convolution of the one-instance
     sizes, computed here from the port's paxos oracle) at depth 33 with
     no violation of Agreement, Validity or OneValuePerBallot; wall,
     states/s, graph captures, dedup launches and the peaks of device
     memory and host RSS are printed; (b) ``check --spec paxos --servers
     5 --chunk 4096`` (orbit-sort over 120 permutations) must print the
     reference's stats line (11,553 states, depth 25, ``sym_canon`` 1,
     its ``ir_fingerprint``; ``dedup_kernel`` 1 here) and its level
     sizes, with the hard lanes and HCAP replays printed; (c) ``trace
     --target ValueChosen`` and ``simulate --target Preempted`` give the
     same witness (and simulate the same stats) on the card and on the
     CPU, each replayed step by step by the paxos oracle; (d) the dedup
     kernel against its plain twin at 15a's shapes (its VCAP and fill,
     M = its FCAP), timed beside its bound;
 16. the observability bundle, through the CLI in this process: (a)
     config #1 as in phase 4 (``--no-store``) with ``--ledger``,
     ``--heartbeat``, ``--trace-timeline`` and ``--registry`` must give
     phase 4's answer, a meta row naming the H100, every dispatch row
     with every counter and the allocator's device memory, one row per
     burst and per-level dispatch whose last burst counters are the
     stats line's, a finished heartbeat, one finished registry record
     with the stats line's counters, phase 4's level sizes, the
     ``compile`` (one per graph capture), ``burst_dispatch``,
     ``level_dispatch`` and ``harvest`` spans, and a timeline that
     parses; the walls without and with the sinks are printed, timed in
     turns (none, sinks, sinks, none); (b) ``--profile-dir
     --trace-timeline`` on config #1 to depth 16: the ``torch.profiler``
     trace must hold the dedup kernel by name and the span-named
     ranges; the kernel's events are counted against its launches, and
     the median device time of those inside graph replays is printed
     beside fixture (d)'s eager time and bound.

 17. observability on the spill engine and the walker, and ``cli obs``,
     through the CLI in this process: (a) BASELINE config #2 on ``check
     --spill --host-table --partitions 4 --sweep-stage`` (2^18-row
     segments, a 2^20-slot device cache, ``--no-store``) to depth 18
     with ``--ledger``, ``--heartbeat``, ``--trace-timeline``,
     ``--registry`` and ``--stats-json`` must give the reference's
     first 18 level sizes (1,382,258 states past the constraints) with
     at least one reseed and levels 17 and 18 spilled in more than one
     segment, one row per
     dispatch with every counter (each level row's frontier its level's
     size; the last row's counters the stats line's), a finished
     heartbeat at depth 18, one finished registry record with ``cmd``
     ``check``, the ``level_dispatch``, ``harvest``, ``host_sweep``,
     ``h2d_stage`` (inside ``level_dispatch``) and ``sweep_overlap``
     spans, one ``compile`` span per graph capture, and a timeline that
     parses; (b) the classic engine on the same cfg to the same depth
     into the same registry, then ``obs ls --cmd check`` lists both,
     ``obs diff <classic> <spill>`` exits 0 with a verdict that is not
     ``mismatch``, ``obs regress <spill> --against <classic>`` and ``obs
     regress last --baseline <classic stats json>`` exit 0, and ``obs
     show last`` parses; (c) phase 13a's hunt through ``simulate`` with
     the four sinks: the reference's stats and witness, one ``sim`` row
     per dispatch with exactly the dispatch counters, as many
     ``sim_dispatch`` spans, a record with ``cmd`` ``simulate`` and one
     ``compile`` span per capture; (d) (a)'s command to depth 15 under
     ``--profile-dir``: the trace holds the dedup kernel's events, as
     many as its launches, and the ``level_dispatch`` ranges; the
     median in-graph kernel time is printed beside fixture (h)'s eager
     time and bound.  Its measures are one JSON line before the kernel
     line.
 18. batched serving, through ``batch`` in this process: (a) 33 jobs
     (``BATCH_JOBS``: raft at 3 servers under MaxTimeouts, MaxTerms and
     MaxClientRequests from 1 to 3, one padded bucket per invariant
     set; paxos at 3 acceptors over ballots and values) in at least 4
     waves of at most 8 must give every job's distinct and generated
     states, depth, level sizes, violations and witness labels as the
     reference's solo runs (``BATCH_PINS``), the two ``big-`` jobs as
     labelled solo fallbacks, the dedup kernel once per job slot in
     each captured job-axis step; ``--sequential`` on four of them the
     same reports but the timing keys; (b) the same file against the
     filled ``--cache-dir``: every job a cache hit, 0 batched
     dispatches; (c) ``--wave-yield 1 --wave-state D --chaos
     wave_kill:at=2`` exits 3, and the same command without the chaos
     resumes jobs from the wave state with 18a's reports; (d) fixture
     (i): the dedup kernel at the bucket's shapes (eight 2^15 tables at
     35%, M 8,192) against the twin, timed back to back beside its
     bound; and the device's idle share over 18a's first wave, re-run
     under ``torch.profiler``;
 19. BASELINE config #4 (the apalache variant) to depth 10 against
     baseline_runs/config4.json, and the ``LeaderCompleteness_false``
     hunt from the ConcurrentLeaders witness, its witness replayed by
     the oracle and equal to the oracle's own;
 20. the daemon (``serve``) on the card: (a) an in-process ``Daemon``
     over a spool of twelve of phase 18's jobs (raft and paxos, two
     witnesses, one solo fallback), a torn and a malformed file, then a
     duplicate in a second cycle, then the idle drain: every result ==
     ``BATCH_PINS``, the duplicate a cache hit with 0 dispatches, both
     bad files rejected with a reason, each done/ marker after its
     result, the dedup kernel's launches == one per job slot per
     batched step plus the fallback's own, one ledger ``intake`` row
     per claim or rejection and one ``daemon`` row per cycle; (b) the
     first cycle again in a fresh daemon with an executable cache:
     misses == store failures == graph captures, no store, no hit, no
     entry file, each reason "backend cannot serialize executables
     (..."; (c) ``python -m raft_tla_tpu_torch serve`` as a process
     with one deep raft job, SIGTERMed after its first batched
     dispatch (its second faults by ``--chaos dispatch:at=2`` and the
     cycle backs off, so the signal lands with work left): exit 0,
     heartbeat ``done``, registry ``cmd=serve`` status ``draining``,
     the claim and the ``.wave.npz`` kept; (d) ``serve --chaos
     wave_kill:at=1 --retries 0`` exits 3 with both kept; a new
     ``serve`` on each of (c)'s and (d)'s spools recovers the claim,
     resumes the job from its wave state (a ``wave_resume`` row) and
     answers as the pin.
 21. The sharded engine and the walker fleet (``parallel/``), D shards on
     the one card (devices ``["cuda:0"] * D``): (a) BASELINE config #1 at
     D = 1, 2 and 4 to the budget's depth: equal counts and level sizes
     across D, the reference mesh's first 16 levels, the classic engine's
     answer; launches = D per lock-step step + the rehashes'; (b) the
     FirstCommit witness at D = 2 and 4 (identical, replayed by the
     oracle) and paxos at D = 2 == the classic engine; (c) the kernel at
     the mesh's shapes (four table shards of 2^22, windows of 32,768
     keys, back to back, twice) == the twin, timed beside its bound; (d)
     a D = 2 checkpoint written mid-run, resumed on the card, on the CPU
     and, as a portable image, on 4 shards and the classic engine; (e)
     phase 13a's hunt on a two-cohort fleet (SimEngine's hit and trace
     among its hits), and a hit-free fleet's stats == SimEngine's.
 22. The spill-composed mesh (``parallel/spill_mesh.py``), D shards of
     the card whose levels stream through host RAM: (a) config #1 at
     D = 2 with lcap 2^21, levels spilled at their ends only: phase
     21a's answer; (b) lcap 2^17 at D = 2 and 4: the widest levels
     spill mid-level, the step-atomic trips replay, and the counts, the
     level sizes, the mid-level spills, the trips and the capacities at
     the end are the reference's engine's; (c) the FirstCommit witness
     on the reference's spill-mesh MICRO with levels spilled mid-level
     and the archive on disk: the reference's gids and trace at D = 2
     and 4, replayed by the oracle; (d) in every run the launches are
     D per lock-step step (tripped ones included) + the rehashes', and
     the kernel at 22b's 2-shard shapes (2^23 slots, windows of 65,536
     keys) == the twin, timed beside its bound.  Each run prints its
     wall, lock-step steps, trips, mid-level spills, spill events and
     host bytes each way; (e) 22b's D = 2 run checkpointed at every
     level to depth 12: the file's frontier, keys and capacities are
     the reference's file's; resumed on the card to the budget, 22b's
     answer; resumed on the CPU to depth 14, the card's; its portable
     image to depth 16 on 4 mesh shards and on the spill engine, the
     reference's engines' answers from its own file, and the classic
     engine's refusal; a supervised run with a dispatch fault, two
     attempts and 22b's answer.  It prints the file's bytes and write
     seconds and each resume's seconds.

Each log line starts with the seconds since the script began.
``python3 chip_smoke.py --phase 15`` (or 16, ..., 22) runs phases 1, 2
and that phase alone and prints no result line.

Prints the kernel table as one JSON line, then the card line, then
``{"ok": true, "device": {...}}`` last.  Exits non-zero without a
result when CUDA is absent or the package is not beside this script.
"""

import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# BASELINE config #5 (tools/measure_baseline.py: build_cfg(5), BUDGET[5])
# and its answer (baseline_runs/config5.json); nothing of it is cut.
CONFIG5_BOUNDS = dict(max_log_length=4, max_timeouts=3,
                      max_client_requests=3)
CONFIG5_SHAPE = dict(n_servers=5, init_servers=(0, 1, 2, 3, 4),
                     invariants=("ConcurrentLeaders",))
CONFIG5_MAX_STATES = 600_000
CONFIG5_DISTINCT, CONFIG5_DEPTH = 937_554, 20
# the port's capacities for config #5 (the counts do not depend on them):
# the largest level holds 413,567 rows after constraints, the table ends
# under 0.12 load at 2^23 slots, and hcap, the hard-lane buffer per
# chunk, holds the most hard lanes a chunk has (1,113), so no level
# replays for it
CONFIG5_ENGINE = dict(chunk=2048, lcap=1 << 20, vcap=1 << 23, ocap=1 << 14,
                      hcap=2048)
# Post-constraint level sizes of config #5, levels 1..20, from the JAX
# package's Engine on a CPU (JAX_PLATFORMS=cpu; "auto" resolved to sort):
# Engine(build_cfg(5) on configs/tlc_membership/raft.cfg, chunk=1024,
# burst=False, store_states=False).check(max_depth=20,
# max_states=600_000) -> 937,554 distinct, depth 20, 0 violations.
CONFIG5_LEVEL_SIZES = [1, 2, 4, 8, 15, 25, 41, 65, 100, 149, 218, 311, 438,
                       612, 900, 1668, 4877, 20276, 92622, 413567]
# The punctuated search of phase 10: configs/tlc_membership/raft.cfg with
# the upstream pin lines enabled (CommitWhenConcurrentLeaders_unique under
# CONSTRAINTS, CommitWhenConcurrentLeaders_action_constraint under
# ACTION_CONSTRAINTS, CommitWhenConcurrentLeaders first under INVARIANTS)
# at these bounds, with the capacities of phase 4.
PIN_BOUNDS = dict(max_log_length=1, max_timeouts=1, max_restarts=0,
                  max_client_requests=2, max_terms=4)
PIN_FLAGS = [a for k, v in PIN_BOUNDS.items()
             for a in ("--" + k.replace("_", "-"), str(v))]
CAP_FLAGS = ["--chunk", "2048", "--lcap", str(1 << 21), "--vcap",
             str(1 << 24), "--ocap", str(1 << 14)]
ACT = "CommitWhenConcurrentLeaders_action_constraint"
PINNED_DEPTH = 11
# Its answer to depth 11, from the JAX package's Engine on a CPU
# (JAX_PLATFORMS=cpu): Engine(that cfg, chunk=2048, burst=False,
# store_states=True, lcap=2^21, vcap=2^24, ocap=2^14).check(max_depth=11,
# stop_on_violation=False): distinct and generated states, post-constraint
# level sizes, the distinct interior states of the pinned prefix, the
# CommitWhenConcurrentLeaders violations (every one), the first one's
# state id and its trace from the seed.
PINNED_DISTINCT, PINNED_GENERATED = 2_228_245, 4_922_060
PINNED_LEVEL_SIZES = [8, 42, 175, 621, 1946, 5526, 14479, 35520, 82529,
                      183369, 392763]
PINNED_INTERIOR, PINNED_VIOLATIONS = 18, 4966
PINNED_FIRST_GID = 97120
# phase 12: the pinned search is checkpointed at this depth and resumed
# to PINNED_CPU_DEPTH, card to CPU and CPU to card, at capacities that
# hold depth 8 (160,822 states) with no replay
PINNED_CKPT_DEPTH = 6
PINNED_CKPT_CAPS = ["--lcap", str(1 << 18), "--vcap", str(1 << 20)]
PINNED_FIRST_TRACE = ["Init", "ClientRequest(1,1)", "AppendEntries(1,2)",
                      "Receive[slot0]", "Receive[slot0]", "Receive[slot0]",
                      "AdvanceCommitIndex(1)", "AppendEntries(1,0)",
                      "AppendEntries(1,0)"]
# the CPU holds the card's first levels of it to this depth
PINNED_CPU_DEPTH = 8
# the two-command form: ``trace --emit-seed`` for this target at the same
# bounds without pins, then ``check --seed-trace`` to this depth.
# ConcurrentLeaders is out of reach in seconds on the CPU at these
# bounds (a CPU trace ran past two minutes without a witness), and so is
# LeadershipChange; FirstCommit is the deepest scenario target the CPU
# reaches in seconds (depth 15, 41,656 states).
SEED_TARGET, SEED_CHECK_DEPTH = "FirstCommit", 12
# BASELINE config #3, the membership workload (tools/measure_baseline.py:
# build_cfg(3), BUDGET[3]) and its answer (baseline_runs/config3.json);
# nothing of it is cut.  Post-constraint level sizes of levels 1..17 from
# the JAX package's Engine on a CPU: Engine(build_cfg(3) on
# configs/tlc_membership/raft.cfg, chunk=2048, burst=False,
# store_states=False, lcap=2^22, vcap=2^24, ocap=2^14).check(
# max_states=1_500_000) -> 2,875,461 distinct, depth 17, 0 violations.
CONFIG3_BOUNDS = dict(max_log_length=2, max_timeouts=1,
                      max_client_requests=2, max_membership_changes=1)
CONFIG3_MAX_STATES = 1_500_000
CONFIG3_DISTINCT, CONFIG3_DEPTH = 2_875_461, 17
CONFIG3_LEVEL_SIZES = [1, 2, 4, 10, 20, 35, 56, 91, 141, 213, 382, 1117,
                       4566, 19757, 80652, 305683, 1083047]
# the port's capacities for config #3: the budget stops at level 17,
# whose fresh rows are at most 2,875,461 less the 412,730 rows of levels
# 1-16 that passed the constraints (2.46 M), under LCAP 2^22 less OCAP
# (4.18 M), so no level replays for LCAP; the table ends under 0.18 load
# at 2^24 slots; FCAP is the reference's for this config
# (tools/measure_baseline.py ENGINE_KW[3])
CONFIG3_ENGINE = dict(chunk=2048, lcap=1 << 22, vcap=1 << 24, ocap=1 << 14,
                      fcap=45056)
# Phase 13: the README's random-walk hunt on BASELINE config #5's
# scenario arm, and the reference's answer to it: the JAX package's CLI
# on a CPU at this tree, ``python -m raft_tla_tpu simulate`` with these
# arguments, found walker 7's witness at depth 120 with these stats; its
# --trace-out and --emit-seed files have these sha256 digests (the
# labels list, Init included, as json.dumps hashes to SIM_LABELS_SHA).
SIM_CMD = ["simulate", "configs/tlc_membership/raft.cfg", "--servers", "5",
           "--max-terms", "4", "--max-log-length", "4", "--next",
           "NextDynamic", "--target", "MembershipChangeCommits",
           "--walkers", "64", "--steps", "30000", "--max-depth", "40",
           "--seed", "0"]
SIM_MODEL_FLAGS = SIM_CMD[2:10]
SIM_WALKER, SIM_DEPTH = 7, 120
SIM_STATS = dict(steps_dispatched=175, walker_steps=11109,
                 sampled_steps=25640, restarts=243, deadlocks=0,
                 promotions=80, est_distinct_states=5927.1,
                 bloom_canonical=True, hits=1)
SIM_LABELS_SHA = \
    "a343b44d506655087c01584d7abe31fe9768bc1410e185e35406a021dcabeeb8"
SIM_LABELS_HEAD = ["Init", "Timeout(4)", "RequestVote(4,1)",
                   "RequestVote(4,2)", "RequestVote(4,4)"]
SIM_LABELS_TAIL = ["Receive[slot1]", "Receive[slot2]", "Receive[slot0]",
                   "Receive[slot2]", "AdvanceCommitIndex(4)"]
SIM_TRACE_SHA = \
    "63cd39d4a75ef17510d42f59376e2de5516c7282c5d319ecc87d526989eeaed4"
SIM_SEED_SHA = \
    "d91170c3f6be3013d06efb271c02af4c22f6d9346f203af3f9e90f567e4b72ce"
# the seeded check of the witness's end state (13b), as deep as the CPU
# takes in seconds
SIM_SEED_CHECK_DEPTH = 2
# 13c: tools/bench_sim.py's "cfg5" fleet (config #5's shape, no target,
# so no hit ends it) at H100 width; its first SIM_NARROW walkers are held
# against a fleet of that width, and that fleet against the CPU over the
# first SIM_CPU_STEPS steps
SIM_FLEET = dict(walkers=16384, max_depth=48, seed=0, bloom_bits=24)
SIM_FLEET_STEPS, SIM_FLEET_DISPATCH = 512, 256
SIM_NARROW, SIM_CPU_STEPS = 64, 32
# 13d: the membership micro fleet, captured against eager
SIM_MICRO_WALKERS, SIM_MICRO_STEPS = 256, 64

# Phase 14: BASELINE config #2 (tools/measure_baseline.py build_cfg(2):
# bounds 3/2/3, ElectionSafety alone) on the host-spill engine, and the
# reference's recorded spill run of it (baseline_runs/round4_deep.json,
# "config2_depth20": SpillEngine, chunk 4096, seg 2^22): distinct states
# and post-constraint level sizes to depth 20
CONFIG2_BOUNDS = dict(max_log_length=3, max_timeouts=2,
                      max_client_requests=3)
CONFIG2_FLAGS = ["--max-log-length", "3", "--max-timeouts", "2",
                 "--max-client-requests", "3"]
SPILL_DEPTH, SPILL_DISTINCT = 20, 22_475_807
SPILL_LEVEL_SIZES = [1, 2, 4, 7, 12, 19, 28, 40, 57, 85, 167, 507, 1942,
                     7579, 27966, 96189, 309574, 938079, 2694118, 7377828]
SPILL_ENGINE = dict(chunk=4096, seg=1 << 22, store_states=True)
# 14b: the classic checkpoint's depth (vcap 2^22, lcap 2^19 and no
# archives keep the file small), the host-table run's depth and its
# distinct count (baseline_runs/round3_deep.json, "config2_fp128_parity":
# config #2 to depth 18, where its 2.4 M budget stopped both key widths);
# the spill checkpoint is written at HT_SPILL_CKPT_DEPTH and resumed to
# HT_DEPTH
HT_CKPT_DEPTH, HT_DEPTH, HT_DISTINCT = 16, 18, 2_443_370
HT_SPILL_CKPT_DEPTH = 17
HT_CLASSIC = dict(chunk=4096, lcap=1 << 19, vcap=1 << 22,
                  store_states=False)
# a device cache of 2^20 slots (0.4 of them, 419,430 keys, before a
# reseed) against levels 17-19 of 0.3-2.7 M rows: it reseeds
HT_FLAGS = ["--spill", "--host-table", "--partitions", "4", "--chunk",
            "4096", "--seg", str(1 << 21), "--vcap", str(1 << 20),
            "--no-store", "--device", "cuda"]
# Phase 15: the paxos tenant.  (a) two independent instances with
# symmetry off: the reachable set is the product of the one-instance
# sets (3,921 states each), so its level sizes are the self-convolution
# of the one-instance sizes, which the phase computes from the port's
# paxos oracle; the run sizes its buffers for the 1.95 M-state peak
# level and a 2^26-slot table (load 0.23 at 15,374,241 keys)
PAXOS_FULL_ARGV = ["check", "--spec", "paxos", "--instances", "2",
                   "--no-symmetry", "--chunk", "4096", "--lcap",
                   str(1 << 21), "--vcap", str(1 << 26)]
PAXOS_FULL_DISTINCT, PAXOS_FULL_DEPTH = 15_374_241, 33
# (b) orbit-sort at 5 acceptors (120 permutations), and the reference's
# answer: ``JAX_PLATFORMS=cpu python -m raft_tla_tpu check --spec paxos
# --servers 5 --chunk 4096`` at this tree printed this stats line (less
# seconds and states_per_sec), and ``Engine(PaxosConfig(n_servers=5),
# chunk=4096).check()`` of the JAX package these level sizes
PAXOS_SORT_ARGV = ["check", "--spec", "paxos", "--servers", "5",
                   "--chunk", "4096"]
PAXOS_SORT_STATS = {
    "distinct_states": 11553, "generated_states": 75119, "depth": 25,
    "dedup_hit_rate": 0.8462, "violations": 0, "fp_bits": 64,
    "expected_fp_collisions": 3.6177606320842576e-12, "levels_fused": 25,
    "burst_dispatches": 2, "burst_bailouts": 0, "guard_matmul": 1,
    "delta_matmul": 1, "sym_canon": 1, "spec": "paxos",
    "ir_fingerprint": "d6d7a456cec9"}
PAXOS_SORT_LEVEL_SIZES = [2, 3, 4, 6, 12, 27, 56, 101, 166, 260, 388, 609,
                          982, 1476, 1880, 1944, 1612, 1066, 572, 250, 94,
                          32, 8, 2, 0]
# (c) a witness from trace and one from simulate, card against CPU
PAXOS_TRACE_ARGV = ["trace", "--spec", "paxos", "--target", "ValueChosen"]
PAXOS_SIM_ARGV = ["simulate", "--spec", "paxos", "--target", "Preempted",
                  "--walkers", "64", "--steps", "200", "--seed", "0"]
# H100 SXM device-memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
# about 1 ms of device sleep at the H100's 1.98 GHz boost clock
SLEEP_CYCLES = 2_000_000

# Phase 18: the batched serving sweep (``batch``).  Raft jobs on the tlc
# cfg at 3 servers under MaxTimeouts/MaxTerms/MaxClientRequests between
# 1 and 3 (one padded bucket per invariant set), paxos jobs over ballots
# and values at 3 acceptors, depth gates from the reference's level
# sizes so that every job but the two "big-" ones fits the bucket's ring
# (512 rows a level) and its 2^15-slot table.
BATCH_CFG = "configs/tlc_membership/raft.cfg"


def _batch_raft(label, mt, terms, mcr, depth=None, inv=None, store=True):
    o = {"spec": "raft", "config": BATCH_CFG, "label": label,
         "overrides": {"bounds": {"max_log_length": 2, "max_timeouts": mt,
                                  "max_terms": terms,
                                  "max_client_requests": mcr}}}
    if inv:
        o["overrides"]["invariants"] = inv
    if depth is not None:
        o["max_depth"] = depth
    if not store:
        o["store"] = False
    return o


def _batch_paxos(label, b, v, depth=None, inv=None):
    c = {"acceptors": 3, "ballots": b, "values": v}
    if inv:
        c["invariants"] = inv
    o = {"spec": "paxos", "config": c, "label": label}
    if depth is not None:
        o["max_depth"] = depth
    return o


BATCH_JOBS = [
    _batch_raft("r121d10", 1, 2, 1, 10), _batch_raft("r121d11", 1, 2, 1, 11),
    _batch_raft("r122d11", 1, 2, 2, 11), _batch_raft("r123d11", 1, 2, 3, 11),
    _batch_raft("r231d11", 2, 3, 1, 11), _batch_raft("r331d10", 3, 3, 1, 10),
    _batch_raft("r222d11", 2, 2, 2, 11), _batch_raft("r113d5", 1, 1, 3, 5),
    _batch_raft("r232d11", 2, 3, 2, 11, store=False),
    _batch_raft("r333d10", 3, 3, 3, 10), _batch_raft("r131d11", 1, 3, 1, 11),
    _batch_raft("r211d6", 2, 1, 1, 6), _batch_raft("r322d11", 3, 2, 2, 11),
    _batch_raft("r122d9", 1, 2, 2, 9, store=False),
    _batch_raft("r233d10", 2, 3, 3, 10), _batch_raft("r321d8", 3, 2, 1, 8),
    _batch_raft("r221d7", 2, 2, 1, 7), _batch_raft("r332d9", 3, 3, 2, 9),
    _batch_raft("big-r122d14", 1, 2, 2, 14),
    _batch_raft("big-r231d13", 2, 3, 1, 13),
    _batch_raft("fbl-r121", 1, 2, 1, None, ["FirstBecomeLeader"]),
    _batch_raft("fbl-r232", 2, 3, 2, None, ["FirstBecomeLeader"]),
    _batch_raft("fbl-r331", 3, 3, 1, None, ["FirstBecomeLeader"]),
    _batch_paxos("p11", 1, 1), _batch_paxos("p12", 1, 2),
    _batch_paxos("p21", 2, 1), _batch_paxos("p22d8", 2, 2, 8),
    _batch_paxos("p22", 2, 2), _batch_paxos("p21d5", 2, 1, 5),
    _batch_paxos("p12d3", 1, 2, 3), _batch_paxos("p22d12", 2, 2, 12),
    _batch_paxos("vc-p22", 2, 2, None, ["ValueChosen"]),
    _batch_paxos("vc-p12", 1, 2, None, ["ValueChosen"]),
]
BATCH_FALLBACK = ("big-r122d14", "big-r231d13")
# four jobs that also run through ``batch --sequential``: each runs 5
# to 8 levels, and its depth gate fits one burst dispatch of either
# engine (a bucket fuses 8 levels), so every report key but the timing
# keys is the same
BATCH_SEQUENTIAL = ("r321d8", "r221d7", "p22d8", "p21d5")
BATCH_TIMING = ("seconds", "states_per_sec", "wait_s", "service_s")
# Each phase-18 job's answer from the JAX package's solo Engine on the
# CPU (raft_tla_tpu.engine.bfs.Engine(job.cfg, store_states=...).check
# with the job's gates, the report built by its serve/batch
# _build_report): label -> (distinct, generated, depth, level sizes,
# violations, [(invariant, state id, witness labels or None)]).
BATCH_PINS = {
    "r121d10": (1008, 1854, 10, [1, 2, 4, 7, 12, 19, 28, 40, 57, 84], 0, []),
    "r121d11": (1492, 2788, 11, [1, 2, 4, 7, 12, 19, 28, 40, 57, 84, 150], 0,
        []),
    "r122d11": (1492, 2788, 11, [1, 2, 4, 7, 12, 19, 28, 40, 57, 84, 154], 0,
        []),
    "r123d11": (1492, 2788, 11, [1, 2, 4, 7, 12, 19, 28, 40, 57, 84, 154], 0,
        []),
    "r231d11": (1498, 2801, 11, [1, 2, 4, 7, 12, 19, 28, 40, 57, 85, 163], 0,
        []),
    "r331d10": (1008, 1854, 10, [1, 2, 4, 7, 12, 19, 28, 40, 57, 85], 0, []),
    "r222d11": (1492, 2788, 11, [1, 2, 4, 7, 12, 19, 28, 40, 57, 84, 154], 0,
        []),
    "r113d5": (2, 7, 1, [0], 0, []),
    "r232d11": (1498, 2801, 11, [1, 2, 4, 7, 12, 19, 28, 40, 57, 85, 167], 0,
        []),
    "r333d10": (1008, 1854, 10, [1, 2, 4, 7, 12, 19, 28, 40, 57, 85], 0, []),
    "r131d11": (1498, 2801, 11, [1, 2, 4, 7, 12, 19, 28, 40, 57, 85, 163], 0,
        []),
    "r211d6": (2, 7, 1, [0], 0, []),
    "r322d11": (1492, 2788, 11, [1, 2, 4, 7, 12, 19, 28, 40, 57, 84, 154], 0,
        []),
    "r122d9": (681, 1226, 9, [1, 2, 4, 7, 12, 19, 28, 40, 57], 0, []),
    "r233d10": (1008, 1854, 10, [1, 2, 4, 7, 12, 19, 28, 40, 57, 85], 0, []),
    "r321d8": (445, 787, 8, [1, 2, 4, 7, 12, 19, 28, 40], 0, []),
    "r221d7": (278, 483, 7, [1, 2, 4, 7, 12, 19, 28], 0, []),
    "r332d9": (681, 1226, 9, [1, 2, 4, 7, 12, 19, 28, 40, 57], 0, []),
    "big-r122d14": (11689, 24101, 14, [1, 2, 4, 7, 12, 19, 28, 40, 57, 84,
        154, 397, 1252, 4091], 0, []),
    "big-r231d13": (5127, 10096, 13, [1, 2, 4, 7, 12, 19, 28, 40, 57, 85, 163,
        455, 1566], 0, []),
    "fbl-r121": (681, 1226, 9, [1, 2, 4, 7, 12, 19, 28, 40, 57], 1,
        [('FirstBecomeLeader', 594, ['Init', 'Timeout(0)', 'RequestVote(0,0)',
        'RequestVote(0,1)', 'UpdateTerm[slot1]', 'Receive[slot0]',
        'Receive[slot0]', 'Receive[slot1]', 'Receive[slot0]',
        'BecomeLeader(0)'])]),
    "fbl-r232": (681, 1226, 9, [1, 2, 4, 7, 12, 19, 28, 40, 57], 1,
        [('FirstBecomeLeader', 594, ['Init', 'Timeout(0)', 'RequestVote(0,0)',
        'RequestVote(0,1)', 'UpdateTerm[slot1]', 'Receive[slot0]',
        'Receive[slot0]', 'Receive[slot1]', 'Receive[slot0]',
        'BecomeLeader(0)'])]),
    "fbl-r331": (681, 1226, 9, [1, 2, 4, 7, 12, 19, 28, 40, 57], 1,
        [('FirstBecomeLeader', 594, ['Init', 'Timeout(0)', 'RequestVote(0,0)',
        'RequestVote(0,1)', 'UpdateTerm[slot1]', 'Receive[slot0]',
        'Receive[slot0]', 'Receive[slot1]', 'Receive[slot0]',
        'BecomeLeader(0)'])]),
    "p11": (15, 43, 9, [1, 1, 1, 2, 3, 3, 2, 1, 0], 0, []),
    "p12": (25, 78, 9, [1, 1, 1, 3, 6, 6, 4, 2, 0], 0, []),
    "p21": (373, 1404, 17, [2, 3, 4, 8, 14, 20, 28, 37, 42, 49, 58, 54, 34,
        14, 4, 1, 0], 0, []),
    "p22d8": (209, 590, 8, [2, 3, 4, 10, 22, 36, 54, 77], 0, []),
    "p22": (857, 3328, 17, [2, 3, 4, 10, 22, 36, 54, 77, 102, 134, 156, 136,
        80, 30, 8, 2, 0], 0, []),
    "p21d5": (32, 67, 5, [2, 3, 4, 8, 14], 0, []),
    "p12d3": (4, 7, 3, [1, 1, 1], 0, []),
    "p22d12": (737, 2474, 12, [2, 3, 4, 10, 22, 36, 54, 77, 102, 134, 156,
        136], 0, []),
    "vc-p22": (78, 182, 6, [2, 3, 4, 10, 22, 36], 8, [('ValueChosen', 68,
        ['Init', 'Phase1a(0,0)', 'Phase1b(0,0,0)', 'Phase1b(0,1,0)',
        'Phase2a(0,0,0)', 'Phase2b(0,0,0,0)', 'Phase2b(0,1,0,0)']),
        ('ValueChosen', 69, ['Init', 'Phase1a(0,0)', 'Phase1b(0,0,0)',
        'Phase1b(0,1,0)', 'Phase2a(0,0,0)', 'Phase2b(0,0,0,0)',
        'Phase2b(0,2,0,0)']), ('ValueChosen', 70, ['Init', 'Phase1a(0,0)',
        'Phase1b(0,0,0)', 'Phase1b(0,1,0)', 'Phase2a(0,0,1)',
        'Phase2b(0,0,0,1)', 'Phase2b(0,1,0,1)']), ('ValueChosen', 71, ['Init',
        'Phase1a(0,0)', 'Phase1b(0,0,0)', 'Phase1b(0,1,0)', 'Phase2a(0,0,1)',
        'Phase2b(0,0,0,1)', 'Phase2b(0,2,0,1)']), ('ValueChosen', 74, ['Init',
        'Phase1a(0,1)', 'Phase1b(0,0,1)', 'Phase1b(0,1,1)', 'Phase2a(0,1,0)',
        'Phase2b(0,0,1,0)', 'Phase2b(0,1,1,0)']), ('ValueChosen', 75, ['Init',
        'Phase1a(0,1)', 'Phase1b(0,0,1)', 'Phase1b(0,1,1)', 'Phase2a(0,1,0)',
        'Phase2b(0,0,1,0)', 'Phase2b(0,2,1,0)']), ('ValueChosen', 76, ['Init',
        'Phase1a(0,1)', 'Phase1b(0,0,1)', 'Phase1b(0,1,1)', 'Phase2a(0,1,1)',
        'Phase2b(0,0,1,1)', 'Phase2b(0,1,1,1)']), ('ValueChosen', 77, ['Init',
        'Phase1a(0,1)', 'Phase1b(0,0,1)', 'Phase1b(0,1,1)', 'Phase2a(0,1,1)',
        'Phase2b(0,0,1,1)', 'Phase2b(0,2,1,1)'])]),
    "vc-p12": (19, 40, 6, [1, 1, 1, 3, 6, 6], 4, [('ValueChosen', 15, ['Init',
        'Phase1a(0,0)', 'Phase1b(0,0,0)', 'Phase1b(0,1,0)', 'Phase2a(0,0,0)',
        'Phase2b(0,0,0,0)', 'Phase2b(0,1,0,0)']), ('ValueChosen', 16, ['Init',
        'Phase1a(0,0)', 'Phase1b(0,0,0)', 'Phase1b(0,1,0)', 'Phase2a(0,0,0)',
        'Phase2b(0,0,0,0)', 'Phase2b(0,2,0,0)']), ('ValueChosen', 17, ['Init',
        'Phase1a(0,0)', 'Phase1b(0,0,0)', 'Phase1b(0,1,0)', 'Phase2a(0,0,1)',
        'Phase2b(0,0,0,1)', 'Phase2b(0,1,0,1)']), ('ValueChosen', 18, ['Init',
        'Phase1a(0,0)', 'Phase1b(0,0,0)', 'Phase1b(0,1,0)', 'Phase2a(0,0,1)',
        'Phase2b(0,0,0,1)', 'Phase2b(0,2,0,1)'])]),
}
# Phase 19b: the LeaderCompleteness_false hunt of the reference's
# tests/test_divergence.py (config #4's variant at 3 servers, bounds
# 2/3/2, seeded with the ConcurrentLeaders witness): the oracle
# (raft_tla_tpu/models/explore.py, trace_violations) finds it at depth 6
# with this witness past the seed.
LC_HUNT_DEPTH = 6
LC_HUNT_TRACE = ["ClientRequest(1,1)", "AppendEntries(1,2)",
                 "AENoConflict(2)", "AEAlreadyDone(2)",
                 "HandleAEResp(1<-2)", "AdvanceCommitIndex(1)"]


_T0 = time.perf_counter()


def log(msg):
    """A line of the run's log, with the seconds since the script began
    (where each phase's time goes)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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


def _same_home(rng, n, W, vcap, home, cvt, home_slots):
    """n distinct keys [W, n] whose home slot in a VCAP table is home."""
    import numpy as np
    out = np.empty((W, 0), np.uint32)
    while out.shape[1] < n:
        cand = _keys(rng, 64 * vcap, W, salt=rng.randint(1 << 30))
        hit = home_slots(cvt.words_to_torch(cand), vcap).numpy() == home
        out = np.concatenate([out, cand[:, hit]], 1)
    return out[:, :n]


def _probes(home, pos, vcap, max_rounds):
    """Probe steps the sequential walk takes: per lane, the first k with
    home + k(k+1)/2 = pos (mod VCAP), plus one."""
    import torch
    steps = torch.full_like(home, max_rounds)
    act = torch.arange(home.shape[0], device=home.device)
    for k in range(max_rounds):
        hit = ((home[act] + k * (k + 1) // 2) & (vcap - 1)) == pos[act]
        steps[act[hit]] = k + 1
        act = act[~hit]
        if act.numel() == 0:
            break
    return int(steps.sum())


def kernel_phase(torch, fp, cvt, home_slots, card, W=2,
                 fixtures="abcdefgh", shape=None):
    """Phase 3: kernel vs plain twin on eight fixtures with W-word keys
    (2: 64-bit fingerprints; 4: ``fp128``), or on the ``fixtures``
    named; two launches must agree, and the claim rounds must equal the
    CPU model's.  Returns the measurements of fixtures (d), (f) and
    (h).  Fixture "p" is a run's own shapes, ``shape`` = (name,
    log2(VCAP), keys in the table, M) (phase 15d)."""
    import numpy as np
    dev = torch.device("cuda")
    rng = np.random.RandomState(2024)
    tag = "" if W == 2 else f" at W={W}"
    errs = []
    out = {}
    ctr = fp.PROBE_CLAIM_LAUNCHES

    def both(table_np, keys_np, live_np, max_rounds=fp.MAX_PROBE_ROUNDS):
        """Run the kernel twice (card), the twin and the rounds model
        (CPU) from the same inputs; all must agree."""
        src = cvt.words_to_torch(table_np, dev)
        t_k, t_k2 = src.clone(), src.clone()
        keys = cvt.words_to_torch(keys_np, dev)
        live = torch.from_numpy(live_np).to(dev)
        ctr.reset(timing=True)
        fk, pk, hk = fp.probe_claim_insert(t_k, keys, live, max_rounds)
        fk2, pk2, hk2 = fp.probe_claim_insert(t_k2, keys, live, max_rounds)
        torch.cuda.synchronize()
        (r1, e1), (r2, e2) = ctr.rounds()
        ctr.reset()
        t_p = src.to("cpu", copy=True)
        t0 = time.perf_counter()
        fpl, ppl, hpl = fp.probe_claim_insert_plain(t_p, keys.cpu(),
                                                    live.cpu(), max_rounds)
        plain_ms = (time.perf_counter() - t0) * 1e3
        *_m, rounds = fp.probe_claim_insert_rounds(
            src.to("cpu", copy=True), keys.cpu(), live.cpu(), max_rounds)
        tk = t_k.cpu()
        # largest absolute difference over every output (u32 words
        # compared as u32)
        errs.append(max(
            int((tk.long() & 0xFFFFFFFF).sub(t_p.long() & 0xFFFFFFFF)
                .abs().max()),
            int((pk.cpu().long() - ppl.long()).abs().max()),
            int((fk.cpu().long() - fpl.long()).abs().max()),
            abs(int(bool(hk)) - int(bool(hpl)))))
        check(torch.equal(tk, t_p), "table differs")
        check(torch.equal(fk.cpu(), fpl), "fresh differs")
        check(torch.equal(pk.cpu(), ppl), "pos differs")
        check(bool(hk) == bool(hpl), "hovf differs")
        check(torch.equal(t_k, t_k2) and torch.equal(fk, fk2) and
              torch.equal(pk, pk2) and bool(hk) == bool(hk2),
              "two launches differ")
        check(e1 == e2 == 0, "claim rounds found no fixpoint")
        check(r1 == r2 == rounds,
              f"claim rounds {r1}, {r2} != the model's {rounds}")
        return dict(table=t_k, keys=keys, live=live, fresh=fk, pos=pk,
                    hovf=bool(hk), rounds=r1, plain_ms=plain_ms, src=src)

    def empty(vcap):
        return np.full((W, vcap), 0xFFFFFFFF, np.uint32)

    def timed(src, keys, live, reps=5):
        """Median kernel time (ms) over reps launches, each on a fresh
        copy of the table.  A device sleep ahead of each launch keeps
        the stream busy while the host enqueues it, so the events time
        the device alone and not the wrapper's host-side work."""
        ms = []
        for _ in range(reps):
            tb = src.clone()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            e0.record()
            fp.probe_claim_insert(tb, keys, live)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        return sorted(ms)[len(ms) // 2]

    def bound(r, vcap):
        """Bytes the function must move over the memory rate (ms): keys
        and live in, the table words the sequential probes read, the
        claimed words written, fresh + pos + hovf out."""
        M = r["keys"].shape[1]
        home = home_slots(r["keys"], vcap).long()
        probes = _probes(home[r["live"]], r["pos"].long()[r["live"]], vcap,
                         fp.MAX_PROBE_ROUNDS)
        n_fresh = int(r["fresh"].sum())
        nbytes = (4 * W * M + M + 4 * W * probes + 4 * W * n_fresh + M +
                  4 * M + 4)
        return nbytes / HBM_BYTES_PER_S * 1e3, probes, nbytes

    if "a" in fixtures:
        fixture_a(cvt, both, empty, rng, W, tag)
    # (b) contended: VCAP 1024, M 400 distinct keys, all live
    if "b" in fixtures:
        r = both(empty(1024), _keys(rng, 400, W, salt=2),
                 np.ones(400, bool))
        log(f"phase 3b{tag} contended fixture (VCAP 1024, M 400): kernel "
            f"== twin, {r['rounds']} rounds")
    # (c) a full table: every live lane exhausts its probe budget
    if "c" in fixtures:
        full = _keys(rng, 64 + 8, W, salt=3)
        r = both(full[:, :64], full[:, 64:], np.ones(8, bool))
        check(r["hovf"] and not bool(r["fresh"].any()),
              "fixture (c) did not overflow")
        log(f"phase 3c{tag} full table (hovf): kernel == twin, "
            f"{r['rounds']} rounds")
    if "d" in fixtures:
        out.update(fixture_d(torch, fp, cvt, both, timed, bound, rng, W,
                             tag, card))
    if "e" in fixtures:
        fixture_e(both, empty, rng, W, cvt, home_slots)
    if "f" in fixtures:
        out.update(fixture_f(cvt, both, empty, timed, bound, rng, W, card))
    if "g" in fixtures:
        fixture_g(torch, cvt, home_slots, both, empty, rng, W, tag)
    if "h" in fixtures:
        h = fixture_h(torch, fp, cvt, both, timed, bound, rng, W, card)
        out.update({f"spill_{k}": v for k, v in h.items()})
    if "p" in fixtures:
        name, log2_vcap, n_fill, M = shape
        out.update(_loaded_fixture(torch, fp, cvt, both, timed, bound, rng,
                                   W, card, name, log2_vcap, M, salt=15,
                                   n_fill=n_fill))
    out["max_abs_err"] = max(errs)
    return out


def fixture_a(cvt, both, empty, rng, W, tag):
    """(a) forced collisions: VCAP 128, M 96 over 24 distinct keys,
    dead lanes, a pre-populated cohort."""
    import numpy as np
    distinct = _keys(rng, 24, W, salt=1)
    keys = distinct[:, rng.randint(0, 24, size=96)]
    live = rng.rand(96) > 0.2
    keys[:, ~live] = 0xFFFFFFFF
    r = both(empty(128), distinct[:, :4], np.ones(4, bool))
    r = both(cvt.words_to_numpy(r["table"]), keys, live)
    check(int(r["fresh"].sum()) < int(live.sum()) and not r["hovf"],
          "fixture (a) vacuous")
    log(f"phase 3a{tag} forced-collision fixture: kernel == twin, "
        f"{r['rounds']} rounds")


def fixture_d(torch, fp, cvt, both, timed, bound, rng, W, tag, card):
    """(d) config #1-sized: VCAP 2^24 filled to 35%, M 32768 with
    duplicates (in-table and in-batch); the fill runs on the kernel."""
    return _loaded_fixture(torch, fp, cvt, both, timed, bound, rng, W,
                           card, f"3d{tag} config #1-sized", 24, 32768,
                           salt=4)


def fixture_h(torch, fp, cvt, both, timed, bound, rng, W, card):
    """(h) spill-sized: the spill engine's shapes at config #2 depth 20
    (phase 14a), VCAP 2^26 filled to 35%, M = FCAP 131,072 (chunk
    4096: FCAP starts at 65,536 and grows on the run's fovf trips)."""
    return _loaded_fixture(torch, fp, cvt, both, timed, bound, rng, W,
                           card, "3h spill-sized", 26, 131072, salt=9)


def _loaded_fixture(torch, fp, cvt, both, timed, bound, rng, W, card,
                    name, log2_vcap, M, salt, n_fill=None):
    """A 2^log2_vcap table filled to 35% (or with ``n_fill`` keys) by the
    kernel, then M keys with duplicates (a quarter in the table, the
    rest drawn twice on average from M/2 new keys): kernel == twin, and
    the kernel timed."""
    import numpy as np
    dev = torch.device("cuda")
    ctr = fp.PROBE_CLAIM_LAUNCHES
    vcap = 1 << log2_vcap
    n_fill = int(0.35 * vcap) if n_fill is None else int(n_fill)
    pool = _keys(rng, n_fill + M, W, salt=salt)
    fill = cvt.words_to_torch(pool[:, :n_fill], dev)
    table = torch.full((W, vcap), -1, dtype=torch.int32, device=dev)
    fill_ms = timed(table, fill, torch.ones(n_fill, dtype=torch.bool,
                                            device=dev), reps=1)
    ctr.reset(timing=True)
    fp.probe_claim_insert(table, fill, torch.ones(n_fill, dtype=torch.bool,
                                                  device=dev))
    (fill_rounds, fill_err), = ctr.rounds()
    ctr.reset()
    check(fill_err == 0, "fill found no fixpoint")
    log(f"phase {name} fill [{card}]: {n_fill} keys into an empty "
        f"2^{log2_vcap} table in {fill_ms:.3f} ms, {fill_rounds} rounds")
    pick = np.concatenate([rng.randint(0, n_fill, M // 4),
                           n_fill + rng.randint(0, M // 2, M - M // 4)])
    keys = pool[:, pick]
    live = np.ones(M, bool)
    d = both(cvt.words_to_numpy(table), keys, live)
    check(not d["hovf"], f"fixture {name} overflowed")
    d_ms = timed(d["src"], d["keys"], d["live"])
    d_bound, d_probes, d_bytes = bound(d, vcap)
    log(f"phase {name} fixture (VCAP 2^{log2_vcap}, {n_fill} keys in, M "
        f"{M}) "
        f"[{card}]: kernel == twin, {int(d['fresh'].sum())} fresh, "
        f"{d['rounds']} rounds; kernel {d_ms:.4f} ms (median of 5), plain "
        f"twin {d['plain_ms']:.1f} ms, {d_probes} probes, {d_bytes} bytes "
        f"(bound {d_bound:.6f} ms)")
    return dict(ms=d_ms, plain_ms=d["plain_ms"], bound_ms=d_bound,
                probes=d_probes, rounds=d["rounds"], fill_ms=fill_ms,
                fill_rounds=fill_rounds)


def fixture_e(both, empty, rng, W, cvt, home_slots):
    """(e) a same-home chain: 48 distinct keys share one home, so each
    round settles one more link of the chain."""
    import numpy as np
    vcap = 1024
    chain = _same_home(rng, 48, W, vcap, 321, cvt, home_slots)
    keys = np.concatenate([chain, chain[:, rng.randint(0, 48, 16)]], 1)
    r = both(empty(vcap), keys, np.ones(keys.shape[1], bool))
    check(r["rounds"] > 48 and int(r["fresh"].sum()) == 48,
          "fixture (e) is not a chain")
    log(f"phase 3e same-home chain (48 keys): kernel == twin, "
        f"{r['rounds']} rounds")


def fixture_f(cvt, both, empty, timed, bound, rng, W, card):
    """(f) rehash-shaped: a 2^20 table at 0.40 load (itself filled by
    the kernel and held against the twin) reinserted in slot order into
    an empty 2^21 table, as Engine._rehash_tables does."""
    import numpy as np
    n_old = int(0.40 * (1 << 20))
    old = both(empty(1 << 20), _keys(rng, n_old, W, salt=6),
               np.ones(n_old, bool))
    occ = ~(old["table"] == -1).all(0)
    keys = cvt.words_to_numpy(old["table"][:, occ].contiguous())
    f = both(empty(1 << 21), keys, np.ones(keys.shape[1], bool))
    check(bool(f["fresh"].all()) and not f["hovf"], "rehash lost keys")
    f_ms = timed(f["src"], f["keys"], f["live"])
    f_bound, f_probes, f_bytes = bound(f, 1 << 21)
    log(f"phase 3f rehash-shaped ({keys.shape[1]} keys, 2^20 at 0.40 -> "
        f"2^21) [{card}]: kernel == twin, {f['rounds']} rounds (fill "
        f"{old['rounds']}); kernel {f_ms:.4f} ms (median of 5), plain twin "
        f"{f['plain_ms']:.1f} ms, {f_probes} probes, {f_bytes} bytes")
    return dict(rehash_ms=f_ms, rehash_plain_ms=f["plain_ms"],
                rehash_bound_ms=f_bound, rehash_rounds=f["rounds"])


def fixture_g(torch, cvt, home_slots, both, empty, rng, W, tag):
    """(g) the all-ones key (it equals EMPTY) among dead lanes: lanes 0
    and 1 take the first two slots of its path, so live all-ones lanes
    pass them and stop, as duplicates, at the third."""
    import numpy as np
    vcap = 256
    h1 = int(home_slots(torch.full((W, 1), -1, dtype=torch.int32),
                        vcap)[0])
    path = [(h1 + k * (k + 1) // 2) & (vcap - 1) for k in range(3)]
    table = cvt.words_to_numpy(both(empty(vcap), _keys(rng, 80, W, salt=7),
                                    np.ones(80, bool))["table"])
    table[:, path] = 0xFFFFFFFF
    ones = np.full((W, 1), 0xFFFFFFFF, np.uint32)
    rest = _keys(rng, 40, W, salt=8)
    keys = np.concatenate(
        [_same_home(rng, 1, W, vcap, path[0], cvt, home_slots),
         _same_home(rng, 1, W, vcap, path[1], cvt, home_slots), ones,
         rest[:, :20], ones, ones, ones, rest[:, 20:], ones], 1)
    live = np.ones(keys.shape[1], bool)
    live[[23, 24, 25]] = False
    r = both(table, keys, live)
    pos = r["pos"].cpu().numpy()
    check(pos[2] == path[2] and not r["fresh"][[2, 46]].any(),
          "fixture (g): the all-ones lane did not pass the taken slots")
    log(f"phase 3g{tag} all-ones key among dead lanes: kernel == twin, "
        f"{r['rounds']} rounds")


def expansion_phase(torch, Engine, cfg, card):
    """Phase 7: the guard product (``torch._int_mm``) against the term
    form on every frontier chunk of config #1 to depth 16, and the delta
    group against the per-family kernels and the CPU on a full chunk.
    Returns the timings."""
    import numpy as np
    from raft_tla_tpu_torch import convert as cvt
    from raft_tla_tpu_torch.engine.expand import (Expander,
                                                  compact_positions)
    from raft_tla_tpu_torch.engine.fingerprint import RaftFingerprinter
    dev = torch.device("cuda")
    B = CONFIG1_ENGINE["chunk"]
    eng = Engine(cfg, device="cuda", **CONFIG1_ENGINE)
    eng.check(max_depth=16)
    rows = {k: np.concatenate([b[k] for b in eng._states])
            for k in eng._states[0]}
    svT = {k: v.to(torch.int32) for k, v in
           eng.ir.widen(cvt.rows_to_torch(rows, dev)).items()}
    n = svT["ct"].shape[-1]
    tx = Expander(cfg, dev)
    n_chunks = (n + B - 1) // B
    for c in range(n_chunks):
        idx = torch.arange(c * B, c * B + B, device=dev) % n
        sv = {k: v[..., idx] for k, v in svT.items()}
        der = tx.kern.derived(sv)
        got = tx.guards_T_matmul(sv, der)
        check(torch.equal(got, tx.guards_T_terms(sv, der)),
              f"guard product differs from the term form on chunk {c}")
    # the last full chunk: the widest level's rows
    sv = {k: v[..., n - B:] for k, v in svT.items()}
    der = tx.kern.derived(sv)
    F, A = tx._gW.shape
    timing = {}

    def events(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    Bp = (B + 31) // 32 * 32
    x8 = torch.zeros((Bp, tx._W8.shape[0]), dtype=torch.int8, device=dev)
    x8[:B, :F] = tx.kern.guard_features(sv, der).T
    timing["int_mm_ms"] = events(lambda: torch._int_mm(x8, tx._W8))
    timing["guard_product_ms"] = events(lambda: tx.guards_T_matmul(sv, der))
    timing["guard_terms_ms"] = events(lambda: tx.guards_T_terms(sv, der))
    timing["int_mm_shape"] = [Bp, int(tx._W8.shape[0]),
                              int(tx._W8.shape[1])]
    log(f"phase 7 guard product [{card}]: {n_chunks} chunks of config #1 "
        f"to depth 16 ({n} states), _int_mm == term form; per chunk "
        f"(B {B}, F {F}, A {A}; _int_mm [{Bp}x{tx._W8.shape[0]}] x "
        f"[{tx._W8.shape[0]}x{tx._W8.shape[1]}]): _int_mm "
        f"{timing['int_mm_ms']:.4f} ms, guards_T_matmul "
        f"{timing['guard_product_ms']:.4f} ms, term form "
        f"{timing['guard_terms_ms']:.4f} ms (CUDA events, mean of 20)")
    okf = tx.guards_T(sv, der).reshape(-1)
    FCAP = eng.FCAP
    epos, n_e = compact_positions(okf, FCAP)
    out = {}
    for name, d, delta in (("card", dev, True), ("card kernels", dev, False),
                           ("cpu", torch.device("cpu"), True)):
        ex = Expander(cfg, d, delta_matmul=delta)
        fpr = RaftFingerprinter(cfg)
        s_d = {k: v.to(d) for k, v in sv.items()}
        der_d = ex.kern.derived(s_d)
        args = (s_d, der_d, okf.to(d), epos.to(d), FCAP, eng.FAM_CAPS)
        tables = fpr.parent_tables(s_d)
        cand, counts, keys = ex.materialize(*args,
                                            delta_fp=(fpr, tables))
        m = int(n_e)
        out[name] = ({k: v[..., :m].cpu() for k, v in cand.items()},
                     counts.cpu(), keys[:, :m].cpu())
        if d.type == "cuda":
            timing[f"materialize_{name.replace(' ', '_')}_ms"] = events(
                lambda: ex.materialize(*args), reps=10)
    ref = out["cpu"]
    check(int(n_e) > B and int(ref[1].sum()) == int(n_e),
          "phase 7 chunk has too few enabled lanes")
    for name in ("card", "card kernels"):
        cand, counts, keys = out[name]
        check(torch.equal(counts, ref[1]), f"{name}: counts differ")
        check(torch.equal(keys, ref[2]), f"{name}: fingerprints differ")
        for k in cand:
            check(torch.equal(cand[k], ref[0][k]),
                  f"{name}: candidates differ in {k}")
    log(f"phase 7 delta group [{card}]: a chunk of {B} rows, "
        f"{int(n_e)} candidates (FCAP {FCAP}): the delta group on the "
        f"card == the per-family kernels on the card == the CPU "
        f"(candidates, counts, incremental fingerprints); materialize "
        f"{timing['materialize_card_ms']:.3f} ms with the delta group, "
        f"{timing['materialize_card_kernels_ms']:.3f} ms with the "
        f"kernels (CUDA events, mean of 10)")
    return timing


def run_path(torch, fp, Engine, cfg, engine_kw, max_states=10 ** 9,
             max_depth=10 ** 9, capture=True, store_states=False):
    """Drive ``Engine(cfg).check`` on the card with the kernel's launch
    counter zeroed just before and read just after.  ``capture`` False
    keeps the chunk step and the burst body eager (the engine's private
    switch); only then are the launches timed with CUDA events."""
    eng = Engine(cfg, store_states=store_states, device="cuda",
                 **engine_kw)
    eng._capture = capture
    torch.cuda.synchronize()
    ctr = fp.PROBE_CLAIM_LAUNCHES
    ctr.reset(timing=not capture)
    t0 = time.perf_counter()
    res = eng.check(max_states=max_states, max_depth=max_depth)
    wall = time.perf_counter() - t0
    launches = ctr.count
    kernel_ms = ctr.total_ms() if not capture else None
    rounds = ctr.rounds()
    ctr.reset()
    per_launch = [r for r, _e in rounds]
    check(launches > 0, "the main path never launched the kernel")
    check(not any(e for _r, e in rounds),
          "a main-path launch found no fixpoint")
    check(capture == (eng._graphs.replays > 0),
          f"graph replays {eng._graphs.replays} with capture={capture}")
    return dict(
        eng=eng, res=res, wall=wall, launches=launches,
        kernel_ms=kernel_ms, rounds_max=max(per_launch, default=0),
        rounds_mean=sum(per_launch) / max(len(per_launch), 1),
        replays=eng._graphs.replays, captures=eng._graphs.captures,
        sym_canon=res.sym_canon,
        incremental=eng.incremental_fp and eng.fpr.supports_incremental())


def report(name, r, card):
    res = r["res"]
    log(f"{name} [{card}]: distinct {res.distinct_states}, depth "
        f"{res.depth}, violations {len(res.violations)}, generated "
        f"{res.generated_states}")
    log(f"{name} [{card}]: wall {r['wall']:.2f} s, "
        f"{res.distinct_states / r['wall']:.0f} states/s; levels fused "
        f"{res.levels_fused} in {res.burst_dispatches} burst dispatches "
        f"({res.burst_bailouts} bailed); graphs captured {r['captures']}, "
        f"replayed {r['replays']}")
    timed = "" if r["kernel_ms"] is None else (
        f", kernel time {r['kernel_ms']:.1f} ms (CUDA events), claim "
        f"rounds per launch max {r['rounds_max']} mean "
        f"{r['rounds_mean']:.3f}")
    log(f"{name} [{card}]: probe_claim_insert launches "
        f"{r['launches']}{timed}")


def graph_phase(torch, fp, Engine, cfg, card):
    """Phase 8: the captured chunk step against the eager one on config
    #1 to depth 16 (per-level path), in turns eager, graph, graph,
    eager; the first two are held bit for bit."""
    import numpy as np
    kw = dict(CONFIG1_ENGINE, burst=False)
    runs = [run_path(torch, fp, Engine, cfg, kw, max_depth=16,
                     capture=cap, store_states=(i < 2))
            for i, cap in enumerate((False, True, True, False))]
    sizes = CONFIG1_LEVEL_SIZES[:16]
    for r in runs:
        check(r["res"].level_sizes == sizes and r["res"].depth == 16,
              f"phase 8 level sizes {r['res'].level_sizes}")
    e, g = runs[0], runs[1]
    check((g["res"].distinct_states, g["res"].generated_states,
           g["launches"]) == (e["res"].distinct_states,
                               e["res"].generated_states, e["launches"]),
          "phase 8: captured and eager counts differ")
    for a, b in zip((e["eng"]._parents, e["eng"]._lanes, e["eng"]._states),
                    (g["eng"]._parents, g["eng"]._lanes, g["eng"]._states)):
        check(len(a) == len(b), "phase 8: archive lengths differ")
        for u, v in zip(a, b):
            same = all(np.array_equal(u[k], v[k]) for k in u) \
                if isinstance(u, dict) else np.array_equal(u, v)
            check(same, "phase 8: the captured step's archives differ")
    steps = e["launches"]
    walls = [r["wall"] for r in runs]
    log(f"phase 8 captured vs eager chunk step [{card}]: config #1 to "
        f"depth 16 ({e['res'].distinct_states} states, {steps} chunk "
        f"steps), archives and counts bit for bit; wall in turns eager "
        f"{walls[0]:.3f} s, graph {walls[1]:.3f} s, graph {walls[2]:.3f} "
        f"s, eager {walls[3]:.3f} s; graphs captured {g['captures']}, "
        f"replayed {g['replays']}; dedup kernel {e['kernel_ms']:.2f} / "
        f"{runs[3]['kernel_ms']:.2f} ms over {steps} launches (CUDA "
        f"events, eager runs), rounds max {e['rounds_max']}")
    return dict(walls=walls, steps=steps, replays=g["replays"],
                captures=g["captures"], kernel_ms=e["kernel_ms"],
                kernel_ms_2=runs[3]["kernel_ms"],
                rounds_max=e["rounds_max"], rounds_mean=e["rounds_mean"])


def check_answer(name, r, distinct, depth, level_sizes):
    res = r["res"]
    check(res.distinct_states == distinct,
          f"{name}: distinct {res.distinct_states} != {distinct}")
    check(res.depth == depth, f"{name}: depth {res.depth} != {depth}")
    check(not res.violations and res.violations_global == 0,
          f"{name} reported violations")
    check(res.level_sizes == level_sizes,
          f"{name}: level sizes {res.level_sizes}")
    check(res.overflow_faults == 0, f"{name}: overflow faults")
    check(res.levels_fused > 0, f"{name}: no level ran on the burst")


def cli_run(argv, cls=None, method="check"):
    """The port's CLI in this process: (exit code, stdout, stderr, the
    (instance, result) of each call of ``cls.method`` it made; by
    default ``Engine.check``)."""
    from raft_tla_tpu_torch import cli
    if cls is None:
        from raft_tla_tpu_torch.engine.bfs import Engine as cls
    seen, orig = [], getattr(cls, method)

    def recorded(self, *a, **kw):
        res = orig(self, *a, **kw)
        seen.append((self, res))
        return res
    out, err = io.StringIO(), io.StringIO()
    setattr(cls, method, recorded)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        setattr(cls, method, orig)
    return rc, out.getvalue(), err.getvalue(), seen


def _stats_and_rest(text):
    """The check's stats line (less what a run cannot repeat: its
    seconds, its rate and its device: ``dedup_kernel`` is 1 where the
    hand kernel ran, on the card, and 0 on the CPU) and the text after
    it."""
    head, _, rest = text.partition("\n")
    stats = json.loads(head)
    for k in ("seconds", "states_per_sec", "dedup_kernel"):
        stats.pop(k)
    return stats, rest


def _no_seconds(text):
    head, _, rest = text.partition(" states explored, ")
    return head + rest.partition("s):")[2]


def pinned_cfg(here, tmp):
    """configs/tlc_membership/raft.cfg with the upstream pin lines
    enabled, beside its spec stub (the bounds the parser reads)."""
    text = open(os.path.join(here, "configs/tlc_membership/raft.cfg")).read()
    text = text.replace("\nCONSTRAINTS\n", "\nCONSTRAINTS\n"
                        "    CommitWhenConcurrentLeaders_unique\n")
    text = text.replace("\nINVARIANTS\n", "\nINVARIANTS\n"
                        "    CommitWhenConcurrentLeaders\n")
    text += f"\nACTION_CONSTRAINTS\n    {ACT}\n"
    path = os.path.join(tmp, "raft.cfg")
    with open(path, "w") as fh:
        fh.write(text)
    shutil.copy(os.path.join(here, "configs/tlc_membership/raft.tla"), tmp)
    return path


def pinned_phase(torch, fp, here, tmp, card):
    """Phase 10 (a): ``check`` of the cfg-pinned search to depth 11 on
    the card, from the cfg alone, against the reference's answer; the
    same check on the CPU to depth 8 against the card's first levels."""
    ctr = fp.PROBE_CLAIM_LAUNCHES
    argv = ["check", pinned_cfg(here, tmp), "--keep-going"] + PIN_FLAGS + \
        CAP_FLAGS
    torch.cuda.synchronize()
    ctr.reset()
    t0 = time.perf_counter()
    rc, out, _err, seen = cli_run(argv + ["--max-depth", str(PINNED_DEPTH),
                                          "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = ctr.count
    ctr.reset()
    (eng, res), = seen
    stats, text = _stats_and_rest(out)
    check(rc == 1, f"pinned check exit code {rc}")
    check(eng.act_names == [ACT] and eng.cfg.prefix_pins,
          "the pinned cfg lost its pins or its action constraint")
    got = (res.distinct_states, res.generated_states, res.depth,
           res.level_sizes, res.pin_interior_states, len(res.violations),
           res.violations_global)
    want = (PINNED_DISTINCT, PINNED_GENERATED, PINNED_DEPTH,
            PINNED_LEVEL_SIZES, PINNED_INTERIOR, PINNED_VIOLATIONS,
            PINNED_VIOLATIONS)
    check(got == want, f"pinned search {got} != the reference's {want}")
    first = res.violations[0]
    check(first.state_id == PINNED_FIRST_GID and
          [lbl for lbl, _ in eng.trace(first.state_id)] ==
          PINNED_FIRST_TRACE, f"first witness {first.state_id}")
    check(stats["pin_interior_states"] == PINNED_INTERIOR and
          stats["violations"] == 5 and
          res.level_sizes == PINNED_LEVEL_SIZES,
          f"pinned stats line {stats}")
    check(launches > 0 and eng._graphs.replays > 0,
          "the pinned search ran no captured step")
    log(f"phase 10a pinned search [{card}]: distinct {res.distinct_states}, "
        f"depth {res.depth}, {res.pin_interior_states} prefix interior "
        f"states, {len(res.violations)} CommitWhenConcurrentLeaders "
        f"violations (first: state {first.state_id}), == the reference; "
        f"wall {wall:.2f} s, {res.distinct_states / wall:.0f} states/s; "
        f"levels fused {res.levels_fused}; graphs captured "
        f"{eng._graphs.captures}, replayed {eng._graphs.replays}; "
        f"probe_claim_insert launches {launches}")
    t0 = time.perf_counter()
    rc_c, out_c, _e, seen_c = cli_run(
        argv + ["--max-depth", str(PINNED_CPU_DEPTH), "--device", "cpu"])
    cpu_wall = time.perf_counter() - t0
    (ceng, cres), = seen_c
    _cstats, ctext = _stats_and_rest(out_c)
    n = cres.distinct_states
    check(rc_c == rc and cres.level_sizes ==
          PINNED_LEVEL_SIZES[:PINNED_CPU_DEPTH] and
          cres.pin_interior_states == PINNED_INTERIOR,
          f"CPU pinned search {cres.level_sizes}")
    check([v.state_id for v in cres.violations] ==
          [v.state_id for v in res.violations if v.state_id < n],
          "CPU and card violations differ")
    check(ctext.partition("\nViolation 1:")[0] ==
          text.partition("\nViolation 1:")[0],
          "CPU and card print different first witnesses")
    log(f"phase 10a pinned search on the CPU to depth {PINNED_CPU_DEPTH}: "
        f"{n} states, {len(cres.violations)} violations, == the card's "
        f"first levels ({cpu_wall:.1f} s)")
    return dict(wall=wall, launches=launches, replays=eng._graphs.replays,
                captures=eng._graphs.captures, cpu_wall=cpu_wall,
                cpu_out=(rc_c, _cstats, ctext), argv=argv)


def seed_phase(torch, fp, here, tmp, card):
    """Phase 10 (b): ``trace --emit-seed`` and then ``check
    --seed-trace`` with the action constraint, on the card and on the
    CPU: exit codes, witness text, seed file and stats equal."""
    ctr = fp.PROBE_CLAIM_LAUNCHES
    cfg = os.path.join(here, "configs/tlc_membership/raft.cfg")
    runs = {}
    for dev in ("cuda", "cpu"):
        seed = os.path.join(tmp, f"seed_{dev}.json")
        ctr.reset()
        t0 = time.perf_counter()
        tr = cli_run(["trace", cfg, "--target", SEED_TARGET, "--emit-seed",
                      seed, "--device", dev] + PIN_FLAGS + CAP_FLAGS)
        t1 = time.perf_counter()
        trace_launches = ctr.count
        ctr.reset()
        ck = cli_run(["check", cfg, "--seed-trace", seed, "--invariant",
                      "CommitWhenConcurrentLeaders", "--action-constraint",
                      ACT, "--keep-going", "--max-depth",
                      str(SEED_CHECK_DEPTH), "--device", dev] + PIN_FLAGS +
                     CAP_FLAGS)
        t2 = time.perf_counter()
        with open(seed) as fh:
            runs[dev] = dict(
                trace=(tr[0], _no_seconds(tr[1])), seed=fh.read(),
                check=(ck[0],) + _stats_and_rest(ck[1]),
                walls=(t1 - t0, t2 - t1), trace_launches=trace_launches,
                check_launches=ctr.count, eng=ck[3][0][0])
        ctr.reset()
    g, c = runs["cuda"], runs["cpu"]
    check(g["trace"][0] == 0 and g["trace"] == c["trace"],
          "card and CPU witnesses differ")
    check(g["seed"] == c["seed"] and '"nonview"' in g["seed"],
          "card and CPU seed files differ")
    check(g["check"] == c["check"], "card and CPU seeded checks differ")
    check(g["eng"].act_names == [ACT] and g["eng"]._graphs.replays > 0 and
          g["trace_launches"] > 0 and g["check_launches"] > 0,
          "the seeded check ran no captured step with the mask")
    stats = g["check"][1]
    log(f"phase 10b trace --target {SEED_TARGET} --emit-seed, then check "
        f"--seed-trace --action-constraint to depth {SEED_CHECK_DEPTH} "
        f"[{card}]: card == CPU (exit codes {g['trace'][0]}, "
        f"{g['check'][0]}; witness, seed file, stats: "
        f"{stats['distinct_states']} states, {stats['violations']} "
        f"violations); card walls {g['walls'][0]:.2f} / "
        f"{g['walls'][1]:.2f} s, CPU {c['walls'][0]:.2f} / "
        f"{c['walls'][1]:.2f} s; probe_claim_insert launches: trace "
        f"{g['trace_launches']}, check {g['check_launches']}")
    return dict(walls=g["walls"], cpu_walls=c["walls"],
                trace_launches=g["trace_launches"],
                check_launches=g["check_launches"])


# a resumed run's burst dispatches and bailouts count its own path (a
# resume re-enters the burst), so they are not part of the answer
PATH_KEYS = ("burst_dispatches", "burst_bailouts")


def supervised_phase(torch, fp, Engine, cfg, card, want_trace):
    """Phase 12 (a): config #1 under ``supervised_check`` with the
    archives on disk, a torn checkpoint head and a dispatch fault after
    it; the retry resumes from ``.1``.  Returns the measurements."""
    import warnings
    from raft_tla_tpu_torch.resil import chaos, ckpt_chain
    from raft_tla_tpu_torch.resil.ckpt_chain import ChainWarning
    from raft_tla_tpu_torch.resil.supervisor import supervised_check
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"phase 12a temp directory {tmp}: {free} bytes free before "
            f"the first checkpoint")
        # two chain members, the temporary file of a publish and the
        # disk archive (~333 B per state row over 2.5 M states)
        need = 3 * 1.7e9 + 0.9e9
        check(free > need, f"phase 12a needs {need:.0f} bytes free in "
              f"{tmp}, has {free}")
        ck, arch = os.path.join(tmp, "c1.ckpt"), os.path.join(tmp, "arch")
        saves, loads, alloc = [], [], []
        # where a save's and a resume's seconds go: the device-to-host
        # copy, the sidecar's sha256 (a re-read), a member's digest
        # check, the host-to-device copy into a fresh level state
        parts = {"d2h": [], "sidecar": [], "verify": [], "h2d": []}

        def timed(name, fn, sync=False):
            def run(*a):
                t0 = time.perf_counter()
                out = fn(*a)
                if sync:
                    torch.cuda.synchronize()
                parts[name].append(time.perf_counter() - t0)
                return out
            return run
        patched = {"write_sidecar": ckpt_chain.write_sidecar,
                   "verify": ckpt_chain.verify}
        ckpt_chain.write_sidecar = timed("sidecar",
                                         patched["write_sidecar"])
        ckpt_chain.verify = timed("verify", patched["verify"])

        def make_engine():
            alloc.append(torch.cuda.memory_allocated())
            eng = Engine(cfg, store_states=True, archive_dir=arch,
                         device="cuda", **CONFIG1_ENGINE)
            eng.ckpt_keep = 2
            save, load = eng._save_checkpoint, eng._load_checkpoint

            def timed_save(path, st, res, depth, *rest):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                save(path, st, res, depth, *rest)
                with open(path + ".sum") as fh:
                    nbytes = json.load(fh)["bytes"]
                saves.append((depth, nbytes, time.perf_counter() - t0))

            def timed_load(path):
                t0 = time.perf_counter()
                out = load(path)
                torch.cuda.synchronize()
                loads.append((out[2]["depth"], time.perf_counter() - t0))
                return out
            eng._save_checkpoint, eng._load_checkpoint = \
                timed_save, timed_load
            eng._carry_numpy = timed("d2h", eng._carry_numpy)
            eng._level_from_carry = timed("h2d", eng._level_from_carry,
                                          sync=True)
            return eng
        # the first dispatches: the burst (levels 1-14) and then levels
        # 15 and 16 per level; checkpoints after the burst (depth 14)
        # and at depth 15, whose head is torn; level 17's dispatch fails
        sched = chaos.install("ckpt_torn:at=2;dispatch:at=4")
        ctr = fp.PROBE_CLAIM_LAUNCHES
        torch.cuda.synchronize()
        ctr.reset()
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                res, eng, attempts = supervised_check(
                    make_engine, retries=2, backoff=0.05,
                    checkpoint_path=ck, checkpoint_every=5,
                    max_states=CONFIG1_MAX_STATES)
        finally:
            chaos.uninstall()
            for k, v in patched.items():
                setattr(ckpt_chain, k, v)
        wall = time.perf_counter() - t0
        launches = ctr.count
        ctr.reset()
        check(attempts == 2, f"phase 12a took {attempts} attempts")
        check([site for site, _ in sched.fired] == ["ckpt_torn",
                                                    "dispatch"],
              f"phase 12a faults {sched.fired}")
        check(any(issubclass(x.category, ChainWarning) for x in w),
              "phase 12a: the torn head raised no ChainWarning")
        check([d for d, _ in loads] == [14] and
              [d for d, _n, _s in saves] == [14, 15, 15],
              f"phase 12a saved at {saves}, resumed from {loads}")
        r = dict(res=res)
        check_answer("phase 12a config #1 supervised", r, CONFIG1_DISTINCT,
                     CONFIG1_DEPTH, CONFIG1_LEVEL_SIZES)
        check(eng._arch is not None and eng._parents == [] and
              eng._arch.total_rows == CONFIG1_DISTINCT,
              "phase 12a: the archive is not on disk")
        got_trace = eng.trace(CONFIG1_DISTINCT - 1)
        check(got_trace == want_trace,
              "phase 12a: the disk archive's trace differs from phase 4's")
        captures = eng._graphs.captures
        check(captures > 0 and eng._graphs.replays > 0,
              "phase 12a: the resumed run captured no graph")
        for (depth, nbytes, secs), d2h, side in zip(saves, parts["d2h"],
                                                    parts["sidecar"]):
            log(f"phase 12a checkpoint at depth {depth} [{card}]: {nbytes} "
                f"bytes written in {secs:.3f} s (device-to-host copy "
                f"{d2h:.3f} s, sha256 sidecar {side:.3f} s, savez and "
                f"rotation {secs - d2h - side:.3f} s)")
        checks = [round(v, 3) for v in parts["verify"]]
        log(f"phase 12a resume [{card}]: digest checks {checks} s (the "
            f"supervisor's latest_valid, then the resume's own), "
            f"host-to-device into a fresh level state "
            f"{parts['h2d'][0]:.3f} s")
        log(f"phase 12a [{card}]: torn head at depth 15, fault at level "
            f"17's dispatch, resumed from depth {loads[0][0]} (.1) in "
            f"{loads[0][1]:.3f} s; device memory allocated at each "
            f"attempt's start {alloc} bytes; graphs captured after the "
            f"resume {captures}, replayed {eng._graphs.replays}; "
            f"{res.distinct_states} states, depth {res.depth}, level "
            f"sizes == phase 4's, last state's trace ({len(got_trace)} "
            f"steps) through the disk archive == phase 4's in-RAM one; "
            f"wall {wall:.2f} s in {attempts} attempts; probe_claim_insert "
            f"launches {launches}")
        return dict(free_bytes=free, saves=saves, resume_s=loads[0][1],
                    io_parts_s=parts,
                    resume_depth=loads[0][0], attempts=attempts,
                    captures_after_resume=captures, wall=wall,
                    launches=launches, alloc_at_attempt_start=alloc)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def pinned_resume_phase(torch, fp, t10, tmp, card):
    """Phase 12 (b): the pinned search checkpointed on the card and
    resumed on the CPU, and the other way round, each to phase 10a's
    CPU depth: both equal that uninterrupted CPU run."""
    rc_w, stats_w, text_w = t10["cpu_out"]
    want = (rc_w, {k: v for k, v in stats_w.items() if k not in PATH_KEYS},
            text_w)
    out = {}
    ctr = fp.PROBE_CLAIM_LAUNCHES
    for first, then in (("cuda", "cpu"), ("cpu", "cuda")):
        ck = os.path.join(tmp, f"pinned_{first}.ckpt")
        t0 = time.perf_counter()
        # capacities that hold depth 8 (the resume adopts them), so the
        # checkpoint is ~0.2 GB, not phase 4's ~1.6 GB; the counts do
        # not depend on them
        rc, _o, err, _seen = cli_run(t10["argv"] + PINNED_CKPT_CAPS + [
            "--max-depth", str(PINNED_CKPT_DEPTH), "--checkpoint", ck,
            "--checkpoint-every", str(PINNED_CKPT_DEPTH), "--device", first])
        t1 = time.perf_counter()
        check(rc in (0, 1) and os.path.exists(ck),
              f"phase 12b: {first} wrote no checkpoint ({rc}: {err})")
        ctr.reset()
        rc, text, err, seen = cli_run(t10["argv"] + [
            "--max-depth", str(PINNED_CPU_DEPTH), "--resume", ck,
            "--device", then])
        t2 = time.perf_counter()
        launches = ctr.count
        ctr.reset()
        stats, rest = _stats_and_rest(text)
        got = (rc, {k: v for k, v in stats.items() if k not in PATH_KEYS},
               rest)
        check(got == want, f"phase 12b: written on {first}, resumed on "
              f"{then}: {got[:2]} != the uninterrupted CPU run's "
              f"{want[:2]}")
        for f in (ck, ck + ".sum"):
            os.remove(f)
        (eng, _res), = seen
        if then == "cuda":
            check(launches > 0 and eng._graphs.captures > 0,
                  "phase 12b: the card's resume ran no captured step")
        out[f"{first}_to_{then}"] = dict(write_s=t1 - t0, resume_s=t2 - t1,
                                         launches=launches)
        log(f"phase 12b pinned search written on {first} at depth "
            f"{PINNED_CKPT_DEPTH} ({t1 - t0:.2f} s), resumed on {then} to "
            f"depth {PINNED_CPU_DEPTH} ({t2 - t1:.2f} s): exit code, stats "
            f"and violations == the uninterrupted CPU run "
            f"({stats['distinct_states']} states)")
    return out


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def sim_hunt_phase(torch, fp, here, tmp, card):
    """Phase 13 (a) and (b): the README's config #5 hunt through the CLI
    on the card, against the reference's pinned answer, its witness
    through the oracle; then ``check --seed-trace`` of its seed on the
    card and on the CPU, with the dedup kernel's launches counted."""
    from raft_tla_tpu_torch.config import NEXT_DYNAMIC
    from raft_tla_tpu_torch.models.explore import oracle_validates_walk
    from raft_tla_tpu_torch.sim import SimEngine
    seed, trace = os.path.join(tmp, "sim_seed.json"), \
        os.path.join(tmp, "sim_trace.json")
    argv = [os.path.join(here, a) if a.endswith(".cfg") else a
            for a in SIM_CMD]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, out, err, seen = cli_run(
        argv + ["--device", "cuda", "--emit-seed", seed, "--trace-out",
                trace], SimEngine, "run")
    wall = time.perf_counter() - t0
    (eng, res), = seen
    check(rc == 0, f"phase 13a simulate exit code {rc}: {err[-300:]}")
    stats = json.loads(out.partition("\n")[0])
    got = {k: stats[k] for k in SIM_STATS}
    check(got == SIM_STATS, f"phase 13a stats {got} != the reference's "
          f"{SIM_STATS}")
    check(stats["platform"] == "gpu" and eng.device.type == "cuda",
          "phase 13a did not run on the card")
    check(eng._graphs.replays > 0, "phase 13a replayed no captured step")
    h = res.hits[0]
    check((h.walker, h.depth) == (SIM_WALKER, SIM_DEPTH),
          f"phase 13a hit walker {h.walker} at depth {h.depth}")
    with open(trace) as fh:
        labels = json.load(fh)["labels"]
    check(hashlib.sha256(json.dumps(labels).encode()).hexdigest() ==
          SIM_LABELS_SHA and
          labels[:5] == SIM_LABELS_HEAD and labels[-5:] == SIM_LABELS_TAIL,
          f"phase 13a witness labels {labels[:5]} ... {labels[-5:]}")
    check(_sha(trace) == SIM_TRACE_SHA and _sha(seed) == SIM_SEED_SHA,
          "phase 13b: the trace or seed file differs from the reference's")
    t1 = time.perf_counter()
    walk = oracle_validates_walk(eng.cfg, [sv for _l, sv in h.trace])
    t_oracle = time.perf_counter() - t1
    check(len(walk) == SIM_DEPTH, "phase 13a: the oracle took fewer steps")
    log(f"phase 13a config #5 hunt [{card}]: witness for "
        f"MembershipChangeCommits at depth {h.depth} from walker "
        f"{h.walker}, stats == the reference's ({stats['walker_steps']} "
        f"walker-steps in {stats['steps_dispatched']} steps, "
        f"{stats['sampled_steps']} sampled, {stats['restarts']} restarts, "
        f"{stats['promotions']} promotions, est. "
        f"{stats['est_distinct_states']} distinct); wall {wall:.2f} s, "
        f"run {res.seconds:.2f} s, {stats['walker_steps_per_sec']} "
        f"walker-steps/s; graphs captured {eng._graphs.captures}, "
        f"replayed {eng._graphs.replays}; the oracle replays the witness "
        f"({t_oracle:.1f} s)")
    # (b) the seed through the punctuated search, card and CPU
    ctr = fp.PROBE_CLAIM_LAUNCHES
    runs = {}
    for dev in ("cuda", "cpu"):
        ctr.reset()
        t2 = time.perf_counter()
        rc_c, text, err_c, seen_c = cli_run(
            ["check", argv[1]] + SIM_MODEL_FLAGS +
            ["--seed-trace", seed, "--max-depth",
             str(SIM_SEED_CHECK_DEPTH), "--device", dev])
        runs[dev] = (rc_c,) + _stats_and_rest(text) + (
            ctr.count, time.perf_counter() - t2, seen_c[0][0],
            seen_c[0][1].level_sizes)
        ctr.reset()
    g, c = runs["cuda"], runs["cpu"]
    check(g[:3] == c[:3] and g[6] == c[6],
          f"phase 13b card {g[:2]} != CPU {c[:2]}")
    check(g[0] == 0 and g[1]["depth"] == SIM_SEED_CHECK_DEPTH and
          g[5].cfg.next_family == NEXT_DYNAMIC,
          f"phase 13b seeded check {g[:2]}")
    check(g[3] > 0 and g[5]._graphs.replays > 0,
          "phase 13b: the seeded check launched no dedup kernel")
    log(f"phase 13b --emit-seed [{card}]: seed and trace files == the "
        f"reference's (sha256); check --seed-trace to depth "
        f"{SIM_SEED_CHECK_DEPTH}: card == CPU ({g[1]['distinct_states']} "
        f"states, level sizes {g[6]}), card {g[4]:.2f} s, "
        f"CPU {c[4]:.2f} s; probe_claim_insert launches {g[3]}")
    return dict(wall=wall, run_s=res.seconds,
                walker_steps_per_sec=stats["walker_steps_per_sec"],
                replays=eng._graphs.replays, oracle_s=t_oracle,
                check_launches=g[3], check_walls=(g[4], c[4]))


def _fleet_cfg(here):
    """tools/bench_sim.py's "cfg5" workload, with the port's parser."""
    from raft_tla_tpu_torch.cfg.parser import load_model
    from raft_tla_tpu_torch.config import Bounds, NEXT_DYNAMIC
    return load_model(os.path.join(
        here, "configs/tlc_membership/raft.cfg")).with_(
        n_servers=5, init_servers=(0, 1, 2, 3, 4), next_family=NEXT_DYNAMIC,
        max_inflight_override=50, invariants=(),
        bounds=Bounds.make(max_log_length=4, max_timeouts=3,
                           max_client_requests=3, max_terms=4))


def _carry_host(st, W=None):
    """A carry's leaves on the host, walkers [:W] (all: None)."""
    out = {}
    for k, v in st.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"{k}.{kk}"] = vv[..., :W].cpu()
        elif k in ("stats", "bloom"):
            out[k] = v.cpu()
        elif k == "key":
            out[k] = v[:W].cpu()
        else:
            out[k] = v[..., :W].cpu()
    return out


def _same(a, b, keys=None):
    keys = keys or sorted(a)
    return [k for k in keys if not (a[k].shape == b[k].shape and
                                    bool((a[k] == b[k]).all()))]


def sim_fleet_phase(torch, here, card):
    """Phase 13 (c): the hit-free config #5 fleet at 16,384 walkers; its
    first walkers against a 64-walker fleet, that fleet against the CPU
    over its first steps; walker-steps/s, peak memory and one captured
    step's device time."""
    from raft_tla_tpu_torch.sim import SimEngine
    from raft_tla_tpu_torch.sim.walker import ST_ITERS, ST_STEPS
    cfg = _fleet_cfg(here)
    kw = dict(SIM_FLEET, walkers=SIM_NARROW)
    # the narrow fleet: the CPU to SIM_CPU_STEPS, the card to the end
    cpu = SimEngine(cfg, device="cpu", **kw)
    st_c = cpu._dispatch(cpu.fresh_carry(), SIM_CPU_STEPS, False)
    narrow = SimEngine(cfg, device="cuda", **kw)
    st_n = narrow._dispatch(narrow.fresh_carry(), SIM_CPU_STEPS, False)
    bad = _same(_carry_host(st_c), _carry_host(st_n))
    check(not bad, f"phase 13c: the {SIM_NARROW}-walker fleet on the card "
          f"differs from the CPU after {SIM_CPU_STEPS} steps in {bad}")
    narrow._dispatch(st_n, SIM_FLEET_STEPS - SIM_CPU_STEPS, False)
    # the wide fleet, timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wide = SimEngine(cfg, device="cuda", **SIM_FLEET)
    st = wide.fresh_carry()
    t0 = time.perf_counter()
    done = 0
    while done < SIM_FLEET_STEPS:
        wide._dispatch(st, SIM_FLEET_DISPATCH, False)
        done = int(st["stats"].cpu()[ST_ITERS])   # the dispatch's read
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = int(st["stats"].cpu()[ST_STEPS])
    keys = ["depth", "key", "traj"] + [f"sv.{k}" for k in st["sv"]]
    bad = _same(_carry_host(st, SIM_NARROW), _carry_host(st_n), keys)
    check(not bad, f"phase 13c: the first {SIM_NARROW} of "
          f"{SIM_FLEET['walkers']} walkers differ from a {SIM_NARROW}-"
          f"walker fleet in {bad}")
    check(wide._graphs.replays == SIM_FLEET_STEPS - 1,
          f"phase 13c replayed {wide._graphs.replays} steps")
    # one more step, one replay, timed by CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    wide._dispatch(st, 1, False)
    ev[1].record()
    torch.cuda.synchronize()
    step_ms = ev[0].elapsed_time(ev[1])
    rate = steps / wall
    log(f"phase 13c hit-free config #5 fleet [{card}]: "
        f"{SIM_FLEET['walkers']} walkers x {SIM_FLEET_STEPS} steps "
        f"({SIM_FLEET_DISPATCH} per dispatch): {steps} walker-steps in "
        f"{wall:.2f} s = {rate:.0f} walker-steps/s (first capture "
        f"included); one captured step {step_ms:.3f} ms (CUDA events); "
        f"peak device memory {peak / 2**30:.2f} GiB; the first "
        f"{SIM_NARROW} walkers == a {SIM_NARROW}-walker fleet (sv, depth, "
        f"traj, key), which == the CPU over {SIM_CPU_STEPS} steps (full "
        f"carry, Bloom included)")
    return dict(wall=wall, walker_steps=steps, walker_steps_per_sec=rate,
                step_ms=step_ms, peak_bytes=peak,
                replays=wide._graphs.replays)


def sim_graph_phase(torch, card):
    """Phase 13 (d): the membership micro fleet (tests/test_sim.py's
    MEMBER without a target) with the engine's capture switch off and
    on: the final carries bit for bit, the walls."""
    from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_DYNAMIC
    from raft_tla_tpu_torch.sim import SimEngine
    cfg = ModelConfig(
        n_servers=3, init_servers=(0, 1), values=(1,),
        next_family=NEXT_DYNAMIC, max_inflight_override=6,
        bounds=Bounds.make(max_log_length=2, max_timeouts=1,
                           max_client_requests=1, max_membership_changes=1),
        symmetry=False)
    out, walls = [], []
    for capture in (False, True):
        eng = SimEngine(cfg, walkers=SIM_MICRO_WALKERS, max_depth=30,
                        seed=1, bloom_bits=14, device="cuda")
        eng._capture = capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = eng._dispatch(eng.fresh_carry(), SIM_MICRO_STEPS, False)
        out.append(_carry_host(st))
        walls.append(time.perf_counter() - t0)
        check(capture == (eng._graphs.replays > 0),
              f"phase 13d replays {eng._graphs.replays}")
    bad = _same(out[0], out[1])
    check(not bad, f"phase 13d: captured and eager carries differ in {bad}")
    log(f"phase 13d captured vs eager walker step [{card}]: "
        f"{SIM_MICRO_WALKERS} walkers x {SIM_MICRO_STEPS} steps of the "
        f"membership micro config, final carries bit for bit; wall eager "
        f"{walls[0]:.3f} s, graph {walls[1]:.3f} s")
    return dict(walls=walls)


def _config2_cfg(here, tmp):
    """configs/tlc_membership/raft.cfg with ElectionSafety its only
    invariant (config #2's), beside its spec stub."""
    lines, out, skip = open(os.path.join(
        here, "configs/tlc_membership/raft.cfg")).read().split("\n"), [], False
    for ln in lines:
        if ln.strip() == "INVARIANTS":
            out += [ln, "    ElectionSafety"]
            skip = True
            continue
        if skip and ln.startswith("    "):
            continue
        skip = False
        out.append(ln)
    path = os.path.join(tmp, "raft.cfg")
    with open(path, "w") as fh:
        fh.write("\n".join(out))
    shutil.copy(os.path.join(here, "configs/tlc_membership/raft.tla"), tmp)
    return path


def _peak_rss_bytes():
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def spill_phase(torch, fp, here, tmp, card):
    """Phase 14 (a): config #2 to depth 20 on the host-spill engine
    against the reference's recorded spill run; the last state's trace
    through the spill archive, replayed by the oracle."""
    from raft_tla_tpu_torch.cfg.parser import load_model
    from raft_tla_tpu_torch.config import Bounds
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    from raft_tla_tpu_torch.models.explore import oracle_validates_walk
    cfg = load_model(_config2_cfg(here, tmp),
                     bounds=Bounds.make(**CONFIG2_BOUNDS))
    check(cfg.invariants == ("ElectionSafety",), f"config #2 {cfg}")
    eng = SpillEngine(cfg, device="cuda", **SPILL_ENGINE)
    ctr = fp.PROBE_CLAIM_LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctr.reset()
    t0 = time.perf_counter()
    res = eng.check(max_depth=SPILL_DEPTH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ctr.count
    ctr.reset()
    peak_dev = torch.cuda.max_memory_allocated()
    check(res.distinct_states == SPILL_DISTINCT and
          res.depth == SPILL_DEPTH and
          res.level_sizes == SPILL_LEVEL_SIZES,
          f"phase 14a: {res} level sizes {res.level_sizes}")
    check(not res.violations and res.violations_global == 0 and
          res.overflow_faults == 0, "phase 14a: violations or faults")
    segs20 = eng.segments_by_level.get(SPILL_DEPTH, 0)
    check(segs20 > 1, f"phase 14a: {segs20} segment(s) spilled at level 20")
    check(res.levels_fused > 0, "phase 14a: no level ran on the burst")
    check(launches > 0 and eng._graphs.captures > 0,
          "phase 14a: no captured spill step launched the kernel")
    # phase 3h held the kernel against its twin at these shapes
    check(eng.VCAP <= 1 << 26 and eng.FCAP <= 131072,
          f"phase 14a outgrew phase 3h's shapes: VCAP {eng.VCAP}, FCAP "
          f"{eng.FCAP}")
    t1 = time.perf_counter()
    trace = eng.trace(SPILL_DISTINCT - 1)
    # Init, then one state for each of the 20 levels below it
    check(len(trace) == SPILL_DEPTH + 1 and trace[0][0] == "Init",
          f"phase 14a: a trace of {len(trace)} states")
    walk = oracle_validates_walk(cfg, [sv for _l, sv in trace])
    check(len(walk) == SPILL_DEPTH, "phase 14a: the oracle stopped")
    t_trace = time.perf_counter() - t1
    rss = _peak_rss_bytes()
    log(f"phase 14a spill engine [{card}]: config #2 to depth "
        f"{res.depth}, {res.distinct_states} distinct, level sizes == the "
        f"reference's spill run, 0 violations, 0 faults; wall {wall:.2f} s "
        f"({res.seconds:.2f} s in check), "
        f"{res.distinct_states / wall:.0f} states/s; probe_claim_insert "
        f"launches {launches}; levels fused {res.levels_fused}; segments "
        f"spilled {eng.segments_spilled} ({segs20} at level 20), bytes "
        f"down {eng.bytes_down}, up {eng.bytes_up}; summary reads "
        f"{eng.summary_syncs}; graphs captured {eng._graphs.captures}; "
        f"peak device memory {peak_dev} B, peak host RSS {rss} B; final "
        f"VCAP {eng.VCAP}, FCAP {eng.FCAP}, trips {dict(eng.trips)}; "
        f"host seconds "
        f"{ {k: round(v, 3) for k, v in eng.host_seconds.items()} }; the "
        f"last state's trace ({len(trace)} states) replayed by the oracle "
        f"in {t_trace:.1f} s")
    return dict(wall=wall, run_s=res.seconds, launches=launches,
                segments=eng.segments_spilled, segments_level20=segs20,
                bytes_down=eng.bytes_down, bytes_up=eng.bytes_up,
                syncs=eng.summary_syncs, captures=eng._graphs.captures,
                peak_device_bytes=peak_dev, peak_rss_bytes=rss,
                host_s={k: round(v, 3) for k, v in eng.host_seconds.items()},
                levels_fused=res.levels_fused, trace_s=t_trace)


def host_table_phase(torch, fp, here, tmp, card):
    """Phase 14 (b): the classic engine's checkpoint of config #2 at
    depth 16, resumed through ``check --spill --host-table
    --resume-portable`` to depth 18 (a spill checkpoint written at depth
    17), then that checkpoint resumed to depth 18: the same stats."""
    from raft_tla_tpu_torch.cfg.parser import load_model
    from raft_tla_tpu_torch.config import Bounds
    from raft_tla_tpu_torch.engine.bfs import Engine
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    cfg_path = _config2_cfg(here, tmp)
    cfg = load_model(cfg_path, bounds=Bounds.make(**CONFIG2_BOUNDS))
    ck, ck2 = os.path.join(tmp, "classic.ckpt"), os.path.join(tmp,
                                                              "spill.ckpt")
    t0 = time.perf_counter()
    Engine(cfg, device="cuda", **HT_CLASSIC).check(
        max_depth=HT_CKPT_DEPTH, checkpoint_path=ck,
        checkpoint_every=HT_CKPT_DEPTH)
    classic_s = time.perf_counter() - t0
    ck_bytes = os.path.getsize(ck)
    ctr = fp.PROBE_CLAIM_LAUNCHES
    argv = ["check", cfg_path] + CONFIG2_FLAGS + HT_FLAGS + [
        "--max-depth", str(HT_DEPTH)]
    torch.cuda.synchronize()
    reseed, orig_reseed = {}, SpillEngine._reseed_dev_table

    def recorded_reseed(self, st, fkeys):
        """The largest reseed's frontier keys, VCAP and device cache."""
        n = orig_reseed(self, st, fkeys)
        if n >= reseed.get("n", -1):
            reseed.update(n=n, keys=fkeys.copy(), vcap=st.vcap,
                          table=st.vis.cpu())
        return n
    ctr.reset()
    t0 = time.perf_counter()
    SpillEngine._reseed_dev_table = recorded_reseed
    try:
        rc, out, err, seen = cli_run(argv + [
            "--resume", ck, "--resume-portable", "--checkpoint", ck2,
            "--checkpoint-every", str(HT_SPILL_CKPT_DEPTH)],
            cls=SpillEngine)
    finally:
        SpillEngine._reseed_dev_table = orig_reseed
    wall = time.perf_counter() - t0
    launches = ctr.count
    ctr.reset()
    check(rc == 0 and len(seen) == 1, f"phase 14b exit {rc}: {err[-2000:]}")
    (eng, res), = seen
    stats, _rest = _stats_and_rest(out)
    check(res.distinct_states == HT_DISTINCT and res.depth == HT_DEPTH and
          res.level_sizes == SPILL_LEVEL_SIZES[:HT_DEPTH] and
          stats["distinct_states"] == HT_DISTINCT,
          f"phase 14b: {res} level sizes {res.level_sizes}")
    check(eng.hpt.n_keys == HT_DISTINCT,
          f"phase 14b: the host table holds {eng.hpt.n_keys} keys")
    check(eng.reseeds > 0, "phase 14b: the device cache never reseeded")
    check(launches > 0, "phase 14b: no dedup launch")
    reseed_check = check_reseed(torch, fp, eng, reseed, card)
    t0 = time.perf_counter()
    rc2, out2, err2, seen2 = cli_run(argv + ["--resume", ck2],
                                     cls=SpillEngine)
    wall2 = time.perf_counter() - t0
    check(rc2 == 0, f"phase 14b spill resume exit {rc2}: {err2[-2000:]}")
    stats2, _rest2 = _stats_and_rest(out2)
    check(stats2 == stats, f"phase 14b: resumed stats {stats2} != {stats}")
    (eng2, res2), = seen2
    log(f"phase 14b host table [{card}]: classic checkpoint at depth "
        f"{HT_CKPT_DEPTH} ({ck_bytes} B, {classic_s:.2f} s), "
        f"--resume-portable with the host table (4 partitions) to depth "
        f"{res.depth}: {res.distinct_states} distinct == the reference, "
        f"host table {eng.hpt.n_keys} keys in {eng.hpt.nbytes} B, caps "
        f"{[eng.hpt.cap(p) for p in range(eng.hpt.P)]}; device-cache "
        f"reseeds {eng.reseeds}; staged sweep hits "
        f"{eng.sweep_stage_hits}, misses {eng.sweep_stage_misses}; wall "
        f"{wall:.2f} s; probe_claim_insert launches {launches}; host "
        f"seconds { {k: round(v, 3) for k, v in eng.host_seconds.items()} }"
        f"; the spill checkpoint at depth {HT_SPILL_CKPT_DEPTH} "
        f"({os.path.getsize(ck2)} B) "
        f"resumed to depth {res2.depth}: the same stats line, "
        f"{wall2:.2f} s")
    return dict(wall=wall, launches=launches, reseeds=eng.reseeds,
                reseed_check=reseed_check,
                hits=eng.sweep_stage_hits, misses=eng.sweep_stage_misses,
                host_keys=eng.hpt.n_keys, resume_wall=wall2,
                classic_s=classic_s, ckpt_bytes=ck_bytes,
                host_s={k: round(v, 3) for k, v in eng.host_seconds.items()})


def check_reseed(torch, fp, eng, reseed, card):
    """Phase 14b's largest cache reseed, held at its own shapes: its
    frontier keys claim-inserted into an empty table at its VCAP by the
    kernel on the card and by the plain twin give equal fresh, pos and
    tables, every key fresh; the engine's reseeded cache is that table,
    and holds every key (the engine's membership probe)."""
    import numpy as np
    dev = torch.device("cuda")
    n, vcap = reseed["n"], reseed["vcap"]
    check(n == len(reseed["keys"]) and n > 0, f"phase 14b reseed of {n}")
    keys = torch.from_numpy(
        np.ascontiguousarray(reseed["keys"].T).view(np.int32))
    live = torch.ones(n, dtype=torch.bool)
    t_k = torch.full((eng.W, vcap), -1, dtype=torch.int32, device=dev)
    fk, pk, hk = fp.probe_claim_insert(t_k, keys.to(dev), live.to(dev))
    t_p = torch.full((eng.W, vcap), -1, dtype=torch.int32)
    t0 = time.perf_counter()
    fpl, ppl, hpl = fp.probe_claim_insert_plain(t_p, keys, live)
    plain_s = time.perf_counter() - t0
    check(torch.equal(t_k.cpu(), t_p) and torch.equal(fk.cpu(), fpl) and
          torch.equal(pk.cpu(), ppl) and not bool(hk) and not bool(hpl),
          "phase 14b: the reseed's kernel insert differs from the twin")
    check(bool(fpl.all()), "phase 14b: a reseed key was not fresh")
    check(torch.equal(reseed["table"], t_p),
          "phase 14b: the reseeded cache is not the twin's table")
    member = eng._member_dev(reseed["table"].to(dev), keys.to(dev))
    check(bool(member.all()), "phase 14b: a frontier key is missing from "
          "the reseeded cache")
    log(f"phase 14b reseed [{card}]: the largest reseed's {n} frontier "
        f"keys at VCAP {vcap}: kernel == plain twin (table, fresh, pos; "
        f"twin {plain_s:.1f} s), == the engine's reseeded cache, every "
        f"key a member")
    return dict(keys=n, vcap=vcap, plain_s=plain_s)


def _paxos_expected_levels():
    """Phase 15a's level sizes in the engine's convention (levels 1..32
    and the empty level 33): the self-convolution of the one-instance
    sizes the port's paxos oracle gives (3,921 states, symmetry off)."""
    import numpy as np
    from raft_tla_tpu_torch.spec import get_spec
    from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig
    one = get_spec("paxos").oracle_explore(PaxosConfig(symmetry=False))
    check(one.distinct_states == 3921, f"one instance: {one.distinct_states}")
    l1 = [1] + one.level_sizes[:-1]
    conv = [int(x) for x in np.convolve(l1, l1)]
    check(sum(conv) == PAXOS_FULL_DISTINCT and
          len(conv) == PAXOS_FULL_DEPTH, f"closed form {sum(conv)}")
    return conv[1:] + [0]


def paxos_full_phase(torch, fp, card):
    """Phase 15a: the full two-instance paxos space through the CLI on the
    card: 15,374,241 states, the closed-form level sizes, no violation."""
    want_levels = _paxos_expected_levels()
    ctr = fp.PROBE_CLAIM_LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctr.reset()
    t0 = time.perf_counter()
    rc, out, err, seen = cli_run(PAXOS_FULL_ARGV + ["--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = ctr.count
    ctr.reset()
    peak_dev = torch.cuda.max_memory_allocated()
    rss = _peak_rss_bytes()
    (eng, res), = seen
    check(rc == 0, f"phase 15a exit code {rc}: {err[-300:]}")
    stats = json.loads(out.partition("\n")[0])
    check(res.distinct_states == PAXOS_FULL_DISTINCT and
          stats["distinct_states"] == PAXOS_FULL_DISTINCT,
          f"phase 15a distinct {res.distinct_states}")
    check(res.depth == PAXOS_FULL_DEPTH, f"phase 15a depth {res.depth}")
    check(res.level_sizes == want_levels,
          f"phase 15a level sizes {res.level_sizes}")
    check(stats["violations"] == 0 and not res.violations and
          res.violations_global == 0 and res.overflow_faults == 0,
          "phase 15a reported violations or faults")
    check(eng.cfg.invariants == ("Agreement", "Validity",
                                 "OneValuePerBallot"),
          f"phase 15a invariants {eng.cfg.invariants}")
    check(stats["spec"] == "paxos" and stats["dedup_kernel"] == 1 and
          stats["sym_canon"] == 0, f"phase 15a stats {stats}")
    check(launches > 0 and eng._graphs.replays > 0,
          "phase 15a: no dedup launch or no graph replay")
    log(f"phase 15a paxos, 2 instances, symmetry off [{card}]: "
        f"{res.distinct_states} states == 3,921^2, depth {res.depth}, the "
        f"closed-form level sizes (peak {max(want_levels)}), 0 violations "
        f"of Agreement, Validity, OneValuePerBallot; generated "
        f"{res.generated_states}")
    log(f"phase 15a [{card}]: wall {wall:.2f} s (engine {res.seconds:.2f} "
        f"s), {res.distinct_states / wall:.0f} states/s; levels fused "
        f"{res.levels_fused} in {res.burst_dispatches} burst dispatches; "
        f"graphs captured {eng._graphs.captures}, replayed "
        f"{eng._graphs.replays}; probe_claim_insert launches {launches}; "
        f"FCAP {eng.FCAP}, OCAP {eng.OCAP}, LCAP {eng.LCAP}, VCAP "
        f"{eng.VCAP}; peak device memory {peak_dev} B, the process's peak "
        f"host RSS so far {rss} B")
    return dict(wall=wall, engine_s=res.seconds,
                states_per_sec=res.distinct_states / wall,
                launches=launches, captures=eng._graphs.captures,
                replays=eng._graphs.replays, generated=res.generated_states,
                peak_device_bytes=peak_dev, peak_rss_bytes=rss,
                vcap=eng.VCAP, fcap=eng.FCAP,
                fill=res.distinct_states)


def paxos_sort_phase(torch, fp, card):
    """Phase 15b: orbit-sort at 5 acceptors through the CLI on the card
    against the reference's stats line and level sizes."""
    ctr = fp.PROBE_CLAIM_LAUNCHES
    torch.cuda.synchronize()
    ctr.reset()
    t0 = time.perf_counter()
    rc, out, err, seen = cli_run(PAXOS_SORT_ARGV + ["--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = ctr.count
    ctr.reset()
    (eng, res), = seen
    check(rc == 0, f"phase 15b exit code {rc}: {err[-300:]}")
    stats = json.loads(out.partition("\n")[0])
    got = {k: v for k, v in stats.items()
           if k not in ("seconds", "states_per_sec", "dedup_kernel")}
    check(got == PAXOS_SORT_STATS, f"phase 15b stats {got}")
    check(stats["dedup_kernel"] == 1 and launches > 0,
          "phase 15b did not launch the dedup kernel")
    check(res.level_sizes == PAXOS_SORT_LEVEL_SIZES,
          f"phase 15b level sizes {res.level_sizes}")
    doublings = (eng.HCAP // eng.chunk).bit_length() - 1
    log(f"phase 15b paxos orbit-sort, 5 acceptors [{card}]: stats == the "
        f"reference's ({res.distinct_states} states, depth {res.depth}, "
        f"sym_canon 1, ir_fingerprint {stats['ir_fingerprint']}), level "
        f"sizes == the reference's; hard lanes {res.hard_lanes} in "
        f"{res.hard_chunks} chunks (at most {res.hard_chunk_max}), HCAP "
        f"{eng.HCAP} after {doublings} doubling replays; wall {wall:.2f} "
        f"s; graphs captured {eng._graphs.captures}, replayed "
        f"{eng._graphs.replays}; probe_claim_insert launches {launches}")
    return dict(wall=wall, launches=launches, hard_lanes=res.hard_lanes,
                hcap=eng.HCAP, hcap_replays=doublings,
                captures=eng._graphs.captures)


def _witness_labels(text):
    """The step labels a witness printout lists, Init first."""
    body = text.partition("witness for ")[2].partition("\n")[2]
    return [ln.split(None, 1)[1] for ln in body.splitlines()
            if ln.strip() and ln.split(None, 1)[0].isdigit()]


def _paxos_replay(labels, target):
    """Replay a witness label by label through the port's paxos oracle:
    every step an oracle successor, the end state violating ``target``."""
    from raft_tla_tpu_torch.spec.paxos import model
    from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig
    cfg = PaxosConfig()
    check(labels[0] == "Init", f"witness starts at {labels[0]}")
    sv, h = model.init_state(cfg)
    for lb in labels[1:]:
        nxt = [(s2, h2) for lab, s2, h2 in model.successors(sv, h, cfg)
               if lab == lb]
        check(len(nxt) == 1, f"witness step {lb} is not an oracle "
              "successor")
        sv, h = nxt[0]
    check(not model.INVARIANTS[target](sv, h, cfg),
          f"the witness's end state does not violate {target}")
    return len(labels) - 1


def paxos_witness_phase(torch, fp, card):
    """Phase 15c: ``trace --target ValueChosen`` and ``simulate --target
    Preempted`` on the card and on the CPU: equal witnesses and stats,
    each replayed by the paxos oracle."""
    import re
    from raft_tla_tpu_torch.sim import SimEngine
    ctr = fp.PROBE_CLAIM_LAUNCHES
    out = {}
    for name, argv, cls, method in (
            ("trace", PAXOS_TRACE_ARGV, None, "check"),
            ("simulate", PAXOS_SIM_ARGV, SimEngine, "run")):
        runs = {}
        for dev in ("cuda", "cpu"):
            ctr.reset()
            t0 = time.perf_counter()
            rc, text, err, seen = cli_run(argv + ["--device", dev], cls,
                                          method)
            runs[dev] = (rc, text, ctr.count, time.perf_counter() - t0,
                         seen[0][0])
            ctr.reset()
        g, c = runs["cuda"], runs["cpu"]
        check(g[0] == c[0] == 0, f"phase 15c {name} exit codes "
              f"{g[0]}, {c[0]}")
        if name == "simulate":
            sg, sc = (json.loads(r[1].partition("\n")[0]) for r in (g, c))
            for st in (sg, sc):
                for k in ("seconds", "walker_steps_per_sec", "platform"):
                    st.pop(k)
            check(sg == sc, f"phase 15c simulate stats {sg} != {sc}")
            check(g[4]._graphs.replays > 0,
                  "phase 15c simulate replayed no captured step")
        else:
            check(g[2] > 0, "phase 15c trace launched no dedup kernel")

        def norm(t):
            return re.sub(r"[0-9.]+s\):", "Ts):",
                          t.partition("witness for ")[2])
        check(norm(g[1]) == norm(c[1]), f"phase 15c {name}: card witness "
              f"!= CPU witness")
        labels = _witness_labels(g[1])
        target = argv[argv.index("--target") + 1]
        steps = _paxos_replay(labels, target)
        log(f"phase 15c {name} --spec paxos --target {target} [{card}]: "
            f"{steps}-step witness, card == CPU, replayed by the paxos "
            f"oracle; card {g[3]:.2f} s, CPU {c[3]:.2f} s; dedup launches "
            f"{g[2]}")
        out[name] = dict(steps=steps, walls=(g[3], c[3]), launches=g[2])
    return out


def paxos_phase(torch, fp, cvt, home_slots, card):
    """Phase 15: the paxos tenant (a-d)."""
    t0 = time.perf_counter()
    a = paxos_full_phase(torch, fp, card)
    b = paxos_sort_phase(torch, fp, card)
    c = paxos_witness_phase(torch, fp, card)
    # (d) the dedup kernel at 15a's shapes: its final table size and
    # fill, and M = its FCAP
    log2_vcap = a["vcap"].bit_length() - 1
    d = kernel_phase(torch, fp, cvt, home_slots, card, fixtures="p",
                     shape=("15d paxos 15a-shaped", log2_vcap, a["fill"],
                            a["fcap"]))
    log(f"phase 15 [{card}]: {time.perf_counter() - t0:.1f} s")
    return dict(full=a, sort=b, witness=c, kernel=d,
                wall=time.perf_counter() - t0)


CONFIG1_ARGV = ["check", "configs/tlc_membership/raft.cfg",
                "--max-log-length", "2", "--max-timeouts", "1",
                "--max-client-requests", "3"] + CAP_FLAGS + \
    ["--device", "cuda", "--no-store"]
OBS_SPANS = ("compile", "burst_dispatch", "level_dispatch", "harvest")
DEDUP_SYMBOL = "probe_claim_rounds"      # csrc/probe_claim.cu's kernel


def _sink_argv(d):
    return ["--ledger", os.path.join(d, "l.jsonl"),
            "--heartbeat", os.path.join(d, "hb.json"),
            "--trace-timeline", os.path.join(d, "tl.json"),
            "--registry", os.path.join(d, "reg")]


def _obs_cli(fp, argv):
    """The port's ``check`` in this process with the dedup launches
    counted: (wall s, stats line, engine, result, launches)."""
    from raft_tla_tpu_torch.engine import cuda_ext
    built = not cuda_ext.loaded()
    ctr = fp.PROBE_CLAIM_LAUNCHES
    ctr.reset()
    t0 = time.perf_counter()
    rc, out, err, seen = cli_run(argv)
    wall = time.perf_counter() - t0
    launches = ctr.count
    ctr.reset()
    check(rc == 0, f"phase 16 {argv[-8:]}: exit code {rc}: {err[-400:]}")
    (eng, res), = seen
    return dict(wall=wall, stats=json.loads(out.partition("\n")[0]),
                eng=eng, res=res, launches=launches, built=built)


def obs_sinks_phase(torch, fp, tmp, card):
    """Phase 16a: config #1 through the CLI with the four file sinks and
    without them, in turns (none, sinks, sinks, none): the answer, then
    the ledger, heartbeat, registry record and timeline checked against
    the stats line and the engine."""
    from raft_tla_tpu_torch.obs import BURST_COUNTER_KEYS, CHECK_COUNTER_KEYS
    argv = CONFIG1_ARGV + ["--max-states", str(CONFIG1_MAX_STATES)]
    runs = []
    for i, sinks in enumerate((False, True, True, False)):
        d = os.path.join(tmp, f"16a_{i}")
        os.makedirs(d)
        torch.cuda.synchronize()
        r = _obs_cli(fp, argv + (_sink_argv(d) if sinks else []))
        check(r["res"].distinct_states == CONFIG1_DISTINCT and
              r["res"].depth == CONFIG1_DEPTH and
              r["res"].level_sizes == CONFIG1_LEVEL_SIZES,
              f"phase 16a run {i}: {r['res']}")
        r.update(dir=d, sinks=sinks)
        runs.append(r)
    r = runs[1]
    stats, eng, res, d = r["stats"], r["eng"], r["res"], r["dir"]
    rows = [json.loads(x) for x in open(os.path.join(d, "l.jsonl"))]
    check(rows[0]["kind"] == "meta" and
          "H100" in rows[0]["backend"]["device_kind"] and
          rows[0]["backend"]["platform"] == "gpu",
          f"phase 16a meta row {rows[0]}")
    drows = [x for x in rows if x["kind"] in ("burst", "level")]
    for x in drows:
        check(not set(CHECK_COUNTER_KEYS) - set(x),
              f"phase 16a row lacks {set(CHECK_COUNTER_KEYS) - set(x)}")
        check(x.get("device_memory", {}).get("peak_bytes_in_use", 0) > 0,
              f"phase 16a row without device memory: {x}")
    n_burst = sum(x["kind"] == "burst" for x in drows)
    n_level = len(drows) - n_burst
    per_level = res.depth - res.levels_fused
    check(len(drows) == res.burst_dispatches + per_level and
          n_level == per_level,
          f"phase 16a: {n_burst} burst and {n_level} level rows for "
          f"{res.burst_dispatches} bursts and {per_level} per-level "
          f"dispatches")
    for k in BURST_COUNTER_KEYS:
        check(drows[-1][k] == stats[k],
              f"phase 16a last row {k} {drows[-1][k]} != {stats[k]}")
    hb = json.load(open(os.path.join(d, "hb.json")))
    check(hb["status"] == "finished" and hb["depth"] == stats["depth"] and
          hb["states_enqueued"] == stats["distinct_states"],
          f"phase 16a heartbeat {hb}")
    regd = os.path.join(d, "reg")
    recs = os.listdir(regd)
    check(len(recs) == 1, f"phase 16a registry holds {recs}")
    rec = json.load(open(os.path.join(regd, recs[0])))
    check(rec["status"] == "finished", f"phase 16a status {rec['status']}")
    check(all(rec["counters"][k] == v for k, v in stats.items()
              if k in rec["counters"]),
          f"phase 16a counters {rec['counters']} vs {stats}")
    check(rec["level_sizes"] == CONFIG1_LEVEL_SIZES,
          f"phase 16a registry level sizes {rec['level_sizes']}")
    spans = rec["spans"]
    check(set(OBS_SPANS) <= set(spans), f"phase 16a spans {sorted(spans)}")
    want_compile = eng._graphs.captures + int(r["built"])
    n_compile = spans.get("compile", {}).get("count", 0)
    check(n_compile == want_compile,
          f"phase 16a compile spans {n_compile} != {want_compile} "
          f"(captures {eng._graphs.captures})")
    art = rec["artifacts"]
    check({k: art.get(k) for k in ("ledger", "heartbeat", "timeline")} ==
          {"ledger": os.path.join(d, "l.jsonl"),
           "heartbeat": os.path.join(d, "hb.json"),
           "timeline": os.path.join(d, "tl.json")},
          f"phase 16a artifacts {art}")
    tl = json.load(open(art["timeline"]))
    check({e["name"] for e in tl} == set(spans),
          "phase 16a timeline spans differ from the record's")
    walls = [x["wall"] for x in runs]
    engine_s = [x["res"].seconds for x in runs]
    log(f"phase 16a config #1 with --ledger/--heartbeat/--trace-timeline/"
        f"--registry [{card}]: {stats['distinct_states']} states, depth "
        f"{stats['depth']}, phase 4's level sizes; {len(rows)} ledger rows "
        f"({n_burst} burst, {n_level} level, the meta row and "
        f"{len(rows) - len(drows) - 1} resource rows); heartbeat finished; "
        f"one registry record, counters == the stats line; spans "
        + ", ".join(f"{k} {v['count']} / {v['seconds']:.3f} s"
                    for k, v in sorted(spans.items()))
        + f"; graphs captured {eng._graphs.captures}; device peak "
        f"{rec['resources'].get('device_peak_bytes_in_use')} B "
        f"(the allocator's)")
    log(f"phase 16a walls in turns [{card}]: none {walls[0]:.3f} s, sinks "
        f"{walls[1]:.3f} s, sinks {walls[2]:.3f} s, none {walls[3]:.3f} s "
        f"(engine seconds {', '.join(f'{x:.3f}' for x in engine_s)}); "
        f"dedup launches {r['launches']}")
    return dict(walls_none_sinks_sinks_none_s=walls,
                engine_s=engine_s, launches=r["launches"],
                rows=len(rows), burst_rows=n_burst, level_rows=n_level,
                captures=eng._graphs.captures,
                spans={k: v for k, v in sorted(spans.items())},
                device_peak_bytes=rec["resources"].get(
                    "device_peak_bytes_in_use"))


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def obs_profile_phase(torch, fp, tmp, card, eager_ms, bound_ms):
    """Phase 16b: ``check --profile-dir --trace-timeline`` on config #1
    to depth 16: the torch.profiler trace holds the dedup kernel by name
    and the span-named record_function ranges; the kernel's device time
    inside graph replays is read from it."""
    prof = os.path.join(tmp, "16b_prof")
    tl = os.path.join(tmp, "16b_tl.json")
    argv = CONFIG1_ARGV + ["--max-depth", "16", "--profile-dir", prof,
                           "--trace-timeline", tl]
    torch.cuda.synchronize()
    r = _obs_cli(fp, argv)
    res, eng = r["res"], r["eng"]
    check(res.level_sizes == CONFIG1_LEVEL_SIZES[:16] and res.depth == 16,
          f"phase 16b: {res}")
    files = os.listdir(prof)
    check(len(files) == 1 and files[0].endswith(".pt.trace.json"),
          f"phase 16b profile dir holds {files}")
    path = os.path.join(prof, files[0])
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    events = json.load(open(path))["traceEvents"]
    parse_s = time.perf_counter() - t0
    ranges = {e.get("name") for e in events
              if e.get("cat") == "user_annotation"}
    check({"level_dispatch", "harvest", "compile"} <= ranges,
          f"phase 16b record_function ranges {sorted(ranges)}")
    runtime = {e.get("args", {}).get("correlation"): e.get("name", "")
               for e in events if e.get("cat") == "cuda_runtime"}
    kern = [e for e in events if e.get("cat") == "kernel" and
            DEDUP_SYMBOL in e.get("name", "")]
    check(kern, f"phase 16b: no {DEDUP_SYMBOL} kernel in the trace")
    # a kernel of a graph replay correlates with the replay's
    # cudaGraphLaunch (CUPTI names the graph node too); an eager one
    # with its own launch call
    in_graph, eager = [], []
    for e in kern:
        args = e.get("args", {})
        launch = runtime.get(args.get("correlation"), "")
        (in_graph if launch.startswith("cudaGraphLaunch") or
         args.get("graph node id") else eager).append(e)
    launch_calls = sorted({runtime.get(e.get("args", {}).get(
        "correlation"), "?") for e in kern})
    graph_ms = _median([e["dur"] / 1e3 for e in in_graph])
    eager_trace_ms = _median([e["dur"] / 1e3 for e in eager])
    log(f"phase 16b config #1 to depth 16 with --profile-dir [{card}]: "
        f"{res.distinct_states} states, phase 4's first 16 level sizes; "
        f"wall {r['wall']:.2f} s (engine {res.seconds:.2f} s); trace "
        f"{nbytes} B, {len(events)} events, parsed in {parse_s:.2f} s; "
        f"ranges {sorted(ranges & set(OBS_SPANS + ('archive_io',)))}")
    log(f"phase 16b dedup kernel [{card}]: {len(kern)} "
        f"{DEDUP_SYMBOL} events in the trace against the engine's "
        f"{r['launches']} launches ({eng._graphs.replays} replays of "
        f"{eng._graphs.captures} graphs), launched by {launch_calls}; "
        f"{len(eager)} eager (the warm-ups), median {eager_trace_ms} ms; "
        f"{len(in_graph)} inside "
        f"graph replays"
        + (f", median {graph_ms:.4f} ms" if in_graph else
           ": the trace shows no kernel of a graph replay")
        + f"; fixture (d) eager {eager_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms")
    return dict(wall=r["wall"], engine_s=res.seconds, trace_bytes=nbytes,
                events=len(events), parse_s=parse_s,
                kernel_events=len(kern), launches=r["launches"],
                in_graph_events=len(in_graph), in_graph_ms=graph_ms,
                eager_events=len(eager), eager_trace_ms=eager_trace_ms,
                replays=eng._graphs.replays, captures=eng._graphs.captures)


def obs_phase(torch, fp, card, eager_ms, bound_ms):
    """Phase 16: the observability bundle on the classic engine."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        a = obs_sinks_phase(torch, fp, tmp, card)
        b = obs_profile_phase(torch, fp, tmp, card, eager_ms, bound_ms)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 16 [{card}]: {wall:.1f} s")
    return dict(sinks=a, profile=b, wall=wall)


# Phase 17: the observability bundle on the spill engine and the
# walker, and ``cli obs``.  (a) config #2 on the spill engine with the
# host table to depth 18 (SPILL_LEVEL_SIZES[:18]); a 2^20-slot device
# cache (0.4 of it, 419,430 keys, before a reseed) against level 18's
# 938,079 rows reseeds, and a 2^18-row segment spills levels 17 and 18
# in several blocks; (b) the classic engine on the same cfg, the same
# depth, into the same registry; (d) (a)'s command to depth 15 under
# torch.profiler.  1,382,258 is the sum of the first 18 level sizes (the
# states that pass the constraints); the distinct count also holds the
# pruned states, and (b)'s classic run must give the spill run's.  The
# distinct count at depth 15 is the port's classic engine's on the CPU
# (this cfg, chunk 4096), whose level sizes are the reference's.
SPILL_OBS_DEPTH, SPILL_OBS_LEVEL_SUM = 18, 1_382_258
SPILL_OBS_FLAGS = ["--spill", "--host-table", "--partitions", "4",
                   "--sweep-stage", "--chunk", "4096", "--seg",
                   str(1 << 18), "--vcap", str(1 << 20), "--no-store",
                   "--device", "cuda"]
CLASSIC2_FLAGS = ["--chunk", "4096", "--lcap", str(1 << 21), "--vcap",
                  str(1 << 22), "--no-store", "--device", "cuda"]
SPILL_PROFILE_DEPTH, SPILL_PROFILE_DISTINCT = 15, 57_438
SPILL_OBS_SPANS = ("level_dispatch", "harvest", "host_sweep", "h2d_stage",
                   "sweep_overlap")


def _ledger_rows(path):
    return [json.loads(x) for x in open(path)]


def _contained(events, inner, outer):
    """Every ``inner`` span of a Chrome trace lies inside an ``outer``."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e["name"] == outer]
    return all(any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                   for a, b in spans)
               for e in events if e["name"] == inner)


def spill_obs_phase(torch, fp, here, tmp, card):
    """Phase 17a: ``check --spill --host-table --sweep-stage`` on config
    #2 to depth 18 with the ledger, heartbeat, timeline, registry and
    stats-json sinks, each checked against the stats line and the
    engine."""
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    from raft_tla_tpu_torch.obs import CHECK_COUNTER_KEYS, BURST_COUNTER_KEYS
    cfg = _config2_cfg(here, tmp)
    d = os.path.join(tmp, "17a")
    os.makedirs(d)
    sj = os.path.join(d, "stats.json")
    argv = (["check", cfg] + CONFIG2_FLAGS + SPILL_OBS_FLAGS +
            ["--max-depth", str(SPILL_OBS_DEPTH), "--stats-json", sj] +
            _sink_argv(d))
    ctr = fp.PROBE_CLAIM_LAUNCHES
    torch.cuda.synchronize()
    ctr.reset()
    t0 = time.perf_counter()
    rc, out, err, seen = cli_run(argv, cls=SpillEngine)
    wall = time.perf_counter() - t0
    launches = ctr.count
    ctr.reset()
    check(rc == 0 and len(seen) == 1, f"phase 17a exit {rc}: {err[-2000:]}")
    (eng, res), = seen
    stats = json.loads(out.partition("\n")[0])
    check(sum(res.level_sizes) == SPILL_OBS_LEVEL_SUM and
          res.depth == SPILL_OBS_DEPTH and
          res.level_sizes == SPILL_LEVEL_SIZES[:SPILL_OBS_DEPTH] and
          stats["distinct_states"] == res.distinct_states and
          json.load(open(sj)) == stats,
          f"phase 17a: {res} level sizes {res.level_sizes}")
    segs = {lv: eng.segments_by_level.get(lv, 0)
            for lv in (SPILL_OBS_DEPTH - 1, SPILL_OBS_DEPTH)}
    check(eng.reseeds >= 1, "phase 17a: the device cache never reseeded")
    check(min(segs.values()) > 1,
          f"phase 17a: segments spilled at levels 17-18 {segs}")
    check(launches > 0, "phase 17a: no dedup launch")
    rows = _ledger_rows(os.path.join(d, "l.jsonl"))
    check(rows[0]["kind"] == "meta" and rows[0]["cmd"] == "check" and
          rows[0]["backend"]["platform"] == "gpu",
          f"phase 17a meta row {rows[0]}")
    drows = [x for x in rows if x["kind"] in ("burst", "level")]
    for x in drows:
        check(not set(CHECK_COUNTER_KEYS) - set(x),
              f"phase 17a row lacks {set(CHECK_COUNTER_KEYS) - set(x)}")
        check(x.get("device_memory", {}).get("peak_bytes_in_use", 0) > 0,
              f"phase 17a row without device memory: {x}")
    n_level = sum(x["kind"] == "level" for x in drows)
    check(n_level == res.depth - res.levels_fused and
          len(drows) - n_level <= res.burst_dispatches,
          f"phase 17a: {len(drows)} rows, {n_level} level rows for "
          f"{res.depth - res.levels_fused} per-level dispatches")
    lv_rows = [x for x in drows if x["kind"] == "level"]
    check([x["frontier"] for x in lv_rows] ==
          [res.level_sizes[x["depth"] - 1] for x in lv_rows],
          "phase 17a: a level row's frontier is not its level's size")
    for k in BURST_COUNTER_KEYS + ("distinct_states", "generated_states"):
        check(drows[-1][k] == stats[k],
              f"phase 17a last row {k} {drows[-1][k]} != {stats[k]}")
    hb = json.load(open(os.path.join(d, "hb.json")))
    check(hb["status"] == "finished" and hb["depth"] == SPILL_OBS_DEPTH and
          hb["states_enqueued"] == res.distinct_states,
          f"phase 17a heartbeat {hb}")
    regd = os.path.join(d, "reg")
    recs = os.listdir(regd)
    check(len(recs) == 1, f"phase 17a registry holds {recs}")
    rec = json.load(open(os.path.join(regd, recs[0])))
    check(rec["status"] == "finished" and rec["cmd"] == "check" and
          rec["level_sizes"] == SPILL_LEVEL_SIZES[:SPILL_OBS_DEPTH],
          f"phase 17a record {rec['status']} {rec['cmd']}")
    spans = rec["spans"]
    check(set(SPILL_OBS_SPANS) <= set(spans),
          f"phase 17a spans {sorted(spans)}")
    check(spans["sweep_overlap"]["count"] == eng.sweep_stage_hits and
          spans["host_sweep"]["count"] == SPILL_OBS_DEPTH + 1 and
          spans["level_dispatch"]["count"] == n_level,
          f"phase 17a span counts {spans} (staged hits "
          f"{eng.sweep_stage_hits})")
    n_compile = spans.get("compile", {}).get("count", 0)
    check(eng._graphs.captures > 0 and n_compile == eng._graphs.captures,
          f"phase 17a compile spans {n_compile} != captures "
          f"{eng._graphs.captures}")
    tl = json.load(open(rec["artifacts"]["timeline"]))
    check({e["name"] for e in tl} == set(spans),
          "phase 17a timeline spans differ from the record's")
    check(_contained(tl, "h2d_stage", "level_dispatch"),
          "phase 17a: an h2d_stage span lies outside level_dispatch")
    log(f"phase 17a spill engine with the sinks [{card}]: config #2 to "
        f"depth {res.depth}, {res.distinct_states} distinct, level sizes "
        f"== the reference's; wall {wall:.2f} s ({res.seconds:.2f} s in "
        f"check); {len(rows)} ledger rows ({n_level} level, "
        f"{len(drows) - n_level} burst, the meta row and "
        f"{len(rows) - len(drows) - 1} resource rows); reseeds "
        f"{eng.reseeds}; segments spilled at levels 17, 18: "
        f"{segs[SPILL_OBS_DEPTH - 1]}, {segs[SPILL_OBS_DEPTH]}; staged "
        f"sweep hits {eng.sweep_stage_hits}, misses "
        f"{eng.sweep_stage_misses}; heartbeat finished; spans "
        + ", ".join(f"{k} {v['count']} / {v['seconds']:.3f} s"
                    for k, v in sorted(spans.items()))
        + f"; graphs captured {eng._graphs.captures}; dedup launches "
        f"{launches}; host seconds "
        f"{ {k: round(v, 3) for k, v in eng.host_seconds.items()} }")
    return dict(wall=wall, run_s=res.seconds, launches=launches,
                distinct=res.distinct_states, generated=res.generated_states,
                rows=len(rows), level_rows=n_level, reseeds=eng.reseeds,
                segments_17_18=[segs[SPILL_OBS_DEPTH - 1],
                                segs[SPILL_OBS_DEPTH]],
                hits=eng.sweep_stage_hits, misses=eng.sweep_stage_misses,
                captures=eng._graphs.captures,
                spans={k: v for k, v in sorted(spans.items())},
                registry=regd, run_id=rec["run_id"], stats_json=sj,
                argv=argv)


def obs_query_phase(torch, fp, here, tmp, card, a):
    """Phase 17b: the classic engine on 17a's cfg and depth into 17a's
    registry, then ``obs ls/diff/regress/show`` over the two records."""
    regd = a["registry"]
    sj = os.path.join(tmp, "17b_stats.json")
    argv = (["check", _config2_cfg(here, tmp)] + CONFIG2_FLAGS +
            CLASSIC2_FLAGS + ["--max-depth", str(SPILL_OBS_DEPTH),
                              "--registry", regd, "--stats-json", sj])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, out, err, seen = cli_run(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"phase 17b classic exit {rc}: {err[-2000:]}")
    (_eng, res), = seen
    check(res.distinct_states == a["distinct"] and
          res.level_sizes == SPILL_LEVEL_SIZES[:SPILL_OBS_DEPTH],
          f"phase 17b classic: {res}, the spill run {a['distinct']}")
    ids = sorted(f[:-5] for f in os.listdir(regd))
    check(len(ids) == 2 and a["run_id"] in ids, f"phase 17b registry {ids}")
    classic = [i for i in ids if i != a["run_id"]][0]

    def obs(*args):
        rc, text, err, _seen = cli_run(["obs", args[0], "--registry",
                                        regd] + list(args[1:]))
        return rc, text, err
    t1 = time.perf_counter()
    rc_ls, ls, _e = obs("ls", "--cmd", "check")
    check(rc_ls == 0 and all(i in ls for i in ids),
          f"phase 17b obs ls: {rc_ls} {ls}")
    rc_d, dtext, derr = obs("diff", classic, a["run_id"])
    diff = json.loads(dtext) if rc_d in (0, 1) else {}
    check(rc_d == 0 and diff.get("verdict") != "mismatch",
          f"phase 17b obs diff: {rc_d} {dtext[:2000]} {derr[-500:]}")
    rc_r, rtext, rerr = obs("regress", a["run_id"], "--against", classic)
    check(rc_r == 0, f"phase 17b obs regress --against: {rc_r} "
          f"{rtext[:2000]} {rerr[-500:]}")
    rc_b, btext, berr = obs("regress", "last", "--baseline", sj)
    check(rc_b == 0, f"phase 17b obs regress --baseline: {rc_b} "
          f"{btext[:2000]} {berr[-500:]}")
    rc_s, stext, _e = obs("show", "last")
    shown = json.loads(stext)
    check(rc_s == 0 and shown["run_id"] == ids[-1],
          f"phase 17b obs show last: {rc_s}")
    query_s = time.perf_counter() - t1
    log(f"phase 17b cli obs [{card}]: the classic engine on config #2 to "
        f"depth {SPILL_OBS_DEPTH} ({res.distinct_states} states, "
        f"{wall:.2f} s) beside 17a's spill run in one registry; obs ls "
        f"--cmd check lists both; obs diff <classic> <spill>: verdict "
        f"{diff['verdict']}, mode_drift {diff['mode_drift']}, level sizes "
        f"equal {diff['parity']['level_sizes_equal']}; obs regress "
        f"--against and --baseline <classic stats json> exit 0; obs show "
        f"last parses; the five queries {query_s:.2f} s")
    return dict(classic_wall=wall, verdict=diff["verdict"],
                mode_drift=diff["mode_drift"], query_s=query_s)


def sim_obs_phase(torch, fp, here, tmp, card):
    """Phase 17c: phase 13a's hunt through ``simulate`` with the four
    file sinks."""
    from raft_tla_tpu_torch.obs import SIM_COUNTER_KEYS, SIM_DISPATCH_KEYS
    from raft_tla_tpu_torch.sim import SimEngine
    d = os.path.join(tmp, "17c")
    os.makedirs(d)
    argv = [os.path.join(here, x) if x.endswith(".cfg") else x
            for x in SIM_CMD] + ["--device", "cuda"] + _sink_argv(d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, out, err, seen = cli_run(argv, SimEngine, "run")
    wall = time.perf_counter() - t0
    check(rc == 0, f"phase 17c simulate exit code {rc}: {err[-300:]}")
    (eng, res), = seen
    stats = json.loads(out.partition("\n")[0])
    got = {k: stats[k] for k in SIM_STATS}
    check(got == SIM_STATS, f"phase 17c stats {got} != {SIM_STATS}")
    h = res.hits[0]
    check((h.walker, h.depth) == (SIM_WALKER, SIM_DEPTH),
          f"phase 17c hit walker {h.walker} at depth {h.depth}")
    rows = _ledger_rows(os.path.join(d, "l.jsonl"))
    check(rows[0]["kind"] == "meta" and rows[0]["cmd"] == "simulate",
          f"phase 17c meta row {rows[0]}")
    srows = [x for x in rows if x["kind"] == "sim"]
    n_disp = -(-stats["steps_dispatched"] // 256)
    check(len(srows) == n_disp, f"phase 17c: {len(srows)} sim rows for "
          f"{n_disp} dispatches")
    for x in srows:
        check(set(x) & set(SIM_COUNTER_KEYS) == set(SIM_DISPATCH_KEYS),
              f"phase 17c row keys {sorted(x)}")
    check({k: srows[-1][k] for k in SIM_DISPATCH_KEYS} ==
          {k: stats[k] for k in SIM_DISPATCH_KEYS},
          f"phase 17c last row {srows[-1]} vs {stats}")
    regd = os.path.join(d, "reg")
    (recf,) = os.listdir(regd)
    rec = json.load(open(os.path.join(regd, recf)))
    check(rec["cmd"] == "simulate" and rec["status"] == "finished" and
          rec["depth"] == stats["steps_dispatched"],
          f"phase 17c record {rec['cmd']} {rec['status']}")
    spans = rec["spans"]
    n_compile = spans.get("compile", {}).get("count", 0)
    check(spans["sim_dispatch"]["count"] == len(srows) and
          eng._graphs.captures > 0 and n_compile == eng._graphs.captures,
          f"phase 17c spans {spans}, captures {eng._graphs.captures}")
    hb = json.load(open(os.path.join(d, "hb.json")))
    check(hb["status"] == "finished" and
          hb["depth"] == stats["steps_dispatched"],
          f"phase 17c heartbeat {hb}")
    tl = json.load(open(rec["artifacts"]["timeline"]))
    check({e["name"] for e in tl} == set(spans),
          "phase 17c timeline spans differ from the record's")
    log(f"phase 17c simulate with the sinks [{card}]: stats == the "
        f"reference's, walker {h.walker}'s witness at depth {h.depth}; "
        f"{len(srows)} sim row(s) with exactly the dispatch counters; "
        f"record cmd simulate; spans "
        + ", ".join(f"{k} {v['count']} / {v['seconds']:.3f} s"
                    for k, v in sorted(spans.items()))
        + f" (captures {eng._graphs.captures}, replays "
        f"{eng._graphs.replays}); wall {wall:.2f} s")
    return dict(wall=wall, sim_rows=len(srows),
                captures=eng._graphs.captures, replays=eng._graphs.replays,
                spans={k: v for k, v in sorted(spans.items())})


def spill_profile_phase(torch, fp, here, tmp, card, a, eager_ms,
                        bound_ms):
    """Phase 17d: 17a's command to depth 15 with ``--profile-dir``: the
    trace names the dedup kernel, its kernel events equal the run's
    launches, and it holds the level_dispatch ranges."""
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    d = os.path.join(tmp, "17d")
    os.makedirs(d)
    prof = os.path.join(d, "prof")
    argv = [x for x in a["argv"]]
    argv[argv.index("--max-depth") + 1] = str(SPILL_PROFILE_DEPTH)
    argv = argv[:argv.index("--stats-json")] + _sink_argv(d) + [
        "--profile-dir", prof]
    ctr = fp.PROBE_CLAIM_LAUNCHES
    torch.cuda.synchronize()
    ctr.reset()
    t0 = time.perf_counter()
    rc, out, err, seen = cli_run(argv, cls=SpillEngine)
    wall = time.perf_counter() - t0
    launches = ctr.count
    ctr.reset()
    check(rc == 0, f"phase 17d exit {rc}: {err[-2000:]}")
    (eng, res), = seen
    check(res.distinct_states == SPILL_PROFILE_DISTINCT and
          res.level_sizes == SPILL_LEVEL_SIZES[:SPILL_PROFILE_DEPTH],
          f"phase 17d: {res}")
    (name,) = os.listdir(prof)
    path = os.path.join(prof, name)
    nbytes = os.path.getsize(path)
    t1 = time.perf_counter()
    events = json.load(open(path))["traceEvents"]
    parse_s = time.perf_counter() - t1
    ranges = {e.get("name") for e in events
              if e.get("cat") == "user_annotation"}
    check({"level_dispatch", "harvest", "host_sweep", "compile"} <= ranges,
          f"phase 17d record_function ranges {sorted(ranges)}")
    runtime = {e.get("args", {}).get("correlation"): e.get("name", "")
               for e in events if e.get("cat") == "cuda_runtime"}
    kern = [e for e in events if e.get("cat") == "kernel" and
            DEDUP_SYMBOL in e.get("name", "")]
    check(len(kern) == launches > 0,
          f"phase 17d: {len(kern)} {DEDUP_SYMBOL} events against "
          f"{launches} launches")
    in_graph, eager = [], []
    for e in kern:
        args = e.get("args", {})
        launch = runtime.get(args.get("correlation"), "")
        (in_graph if launch.startswith("cudaGraphLaunch") or
         args.get("graph node id") else eager).append(e)
    graph_ms = _median([e["dur"] / 1e3 for e in in_graph])
    eager_trace_ms = _median([e["dur"] / 1e3 for e in eager])
    log(f"phase 17d spill engine to depth {SPILL_PROFILE_DEPTH} with "
        f"--profile-dir [{card}]: {res.distinct_states} states; wall "
        f"{wall:.2f} s (engine {res.seconds:.2f} s); trace {nbytes} B, "
        f"{len(events)} events, parsed in {parse_s:.2f} s; ranges "
        f"{sorted(ranges & set(SPILL_OBS_SPANS + ('compile',)))}; "
        f"{len(kern)} {DEDUP_SYMBOL} events == {launches} launches "
        f"({eng._graphs.replays} replays of {eng._graphs.captures} "
        f"graphs, reseeds {eng.reseeds}); {len(eager)} eager, median "
        f"{eager_trace_ms} ms; {len(in_graph)} inside graph replays"
        + (f", median {graph_ms:.4f} ms" if in_graph else "")
        + f"; fixture (h) eager {eager_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms")
    return dict(wall=wall, engine_s=res.seconds, trace_bytes=nbytes,
                events=len(events), parse_s=parse_s,
                kernel_events=len(kern), launches=launches,
                in_graph_events=len(in_graph), in_graph_ms=graph_ms,
                eager_events=len(eager), eager_trace_ms=eager_trace_ms,
                replays=eng._graphs.replays, captures=eng._graphs.captures)


def spill_sim_obs_phase(torch, fp, here, card, eager_ms, bound_ms):
    """Phase 17: observability on the spill engine and the walker, and
    ``cli obs`` over the registry the runs wrote."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs17_")
    try:
        a = spill_obs_phase(torch, fp, here, tmp, card)
        b = obs_query_phase(torch, fp, here, tmp, card, a)
        c = sim_obs_phase(torch, fp, here, tmp, card)
        d = spill_profile_phase(torch, fp, here, tmp, card, a, eager_ms,
                                bound_ms)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in ("registry", "stats_json", "argv", "run_id"):
        a.pop(k)
    wall = time.perf_counter() - t0
    log(f"phase 17 [{card}]: {wall:.1f} s")
    return dict(spill_sinks=a, query=b, sim=c, profile=d, wall=wall)


def _batch_cli(argv):
    """``batch`` through the CLI in this process: (exit code, summary,
    report lines, stderr, the BucketEngines it built, the waves it
    ran)."""
    from raft_tla_tpu_torch.serve import batch as sb
    made, waves = [], []
    init, run_wave = sb.BucketEngine.__init__, sb.BucketEngine.run_wave

    def rec_init(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def rec_wave(self, runs, *a, **kw):
        waves.append([r.job.label for r in runs])
        return run_wave(self, runs, *a, **kw)

    sb.BucketEngine.__init__ = rec_init
    sb.BucketEngine.run_wave = rec_wave
    try:
        rc, out, err, _seen = cli_run(argv)
    finally:
        sb.BucketEngine.__init__ = init
        sb.BucketEngine.run_wave = run_wave
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    return (rc, lines[0] if lines else None, lines[1:], err, made, waves)


def _untimed(rep, drop=()):
    return {k: v for k, v in rep.items()
            if k not in BATCH_TIMING and k not in drop}


def _check_pins(reps, tag):
    """Each report against its job's pinned solo answer."""
    for r in reps:
        want = BATCH_PINS[r["label"]]
        got = (r["distinct_states"], r["generated_states"], r["depth"],
               r["level_sizes"], r["violations"],
               [(d["invariant"], d["state_id"], d.get("trace"))
                for d in r["violations_detail"]])
        check(got == want, f"{tag} {r['label']}: {got} != {want}")


def _check_batch_answers(reps, tag):
    """Every job's report against the reference's solo answer."""
    check([r["label"] for r in reps] == [j["label"] for j in BATCH_JOBS],
          f"{tag}: report order {[r['label'] for r in reps]}")
    _check_pins(reps, tag)


def _batch_idle_share(torch, jobs, wall_of):
    """The device's idle share over one wave re-run under torch.profiler:
    1 - (the device time of its kernels) / (the wave's unprofiled wall)."""
    from torch.profiler import ProfilerActivity, profile
    from raft_tla_tpu_torch.serve import WaveScheduler, job_from_dict
    torch.cuda.synchronize()
    sch = WaveScheduler()
    todo = [job_from_dict(dict(j)) for j in jobs]
    t0 = time.perf_counter()
    sch.serve(todo)               # warm: the graph is captured here
    torch.cuda.synchronize()
    wall_warm = time.perf_counter() - t0
    todo = [job_from_dict(dict(j)) for j in jobs]
    t0 = time.perf_counter()
    sch.serve(todo)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sch.serve([job_from_dict(dict(j)) for j in jobs])
        torch.cuda.synchronize()
    busy_us, kernels = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            busy_us += us
            kernels += e.count if us > 0 else 0
    return dict(wall_s=wall, first_wall_s=wall_warm,
                device_busy_ms=busy_us / 1e3, device_kernels=kernels,
                device_idle_share=1.0 - busy_us / 1e6 / wall)


def _batch_jobs(here):
    """BATCH_JOBS by label, their cfg paths rooted at the checkout."""
    jobs = {}
    for j in BATCH_JOBS:
        j = dict(j)
        if j["spec"] == "raft":
            j["config"] = os.path.join(here, j["config"])
        jobs[j["label"]] = j
    return jobs


def batch_phase(torch, fp, here, tmp, card):
    """Phase 18 (a-c): the serving sweep through ``batch``; its cache;
    a killed and resumed run."""
    ctr = fp.PROBE_CLAIM_LAUNCHES
    jobs = list(_batch_jobs(here).values())
    path = os.path.join(tmp, "jobs.jsonl")
    with open(path, "w") as fh:
        fh.write("\n".join(json.dumps(j) for j in jobs) + "\n")
    cache = os.path.join(tmp, "cache")
    # (a) the sweep, its launches counted from 0
    ctr.reset()
    t0 = time.perf_counter()
    rc, summ, reps, err, made, waves = _batch_cli(
        ["batch", "--jobs", path, "--cache-dir", cache])
    wall = time.perf_counter() - t0
    launches = ctr.count
    check(rc == 1, f"18a: exit {rc} (violations expected): {err[-400:]}")
    check(len(BATCH_JOBS) >= 32 and len(waves) >= 4,
          f"18a: {len(BATCH_JOBS)} jobs in {len(waves)} waves")
    check(all(len(w) <= 8 for w in waves), f"18a: waves {waves}")
    _check_batch_answers(reps, "18a")
    fell = sorted(r["label"] for r in reps if r["status"] == "fallback")
    check(fell == sorted(BATCH_FALLBACK), f"18a: fallbacks {fell}")
    check(all(r["status"] == "done" for r in reps
              if r["label"] not in BATCH_FALLBACK), "18a: statuses")
    check(all(r["dedup_kernel"] == 1 for r in reps),
          "18a: a report without the kernel")
    traced = [r["label"] for r in reps if any(
        "trace" in d for d in r["violations_detail"])]
    check(len(traced) >= 4, f"18a: witness traces for {traced}")
    captures = sum(be._graphs.captures for be in made)
    replays = sum(be._graphs.replays for be in made)
    per_step = sorted({held for be in made
                       for _g, held in be._graphs._graphs.values()})
    check(replays > 0 and per_step and all(
        held == key[1] for be in made
        for key, (_g, held) in be._graphs._graphs.items()),
        f"18a: kernel launches per captured step {per_step}")
    check(launches > 0, "18a: the dedup kernel never ran")
    log(f"phase 18a batch sweep [{card}]: {len(reps)} jobs, "
        f"{summ['buckets']} buckets, {len(waves)} waves, "
        f"{summ['batch_dispatches']} batched dispatches, "
        f"{summ['fallback_jobs']} fallbacks ({', '.join(fell)}), "
        f"{summ['violations']} violations with {len(traced)} witness "
        f"traces, every answer == the reference's solo runs; wall "
        f"{wall:.2f} s; {captures} graph captures, {replays} replays, "
        f"dedup launches {launches} ({per_step} per batched step, one "
        f"per job slot)")
    log("phase 18a per-job seconds [" + card + "]: " + ", ".join(
        f"{r['label']} {r['service_s']}" for r in reps))
    # the --sequential A/B on four jobs
    sub = os.path.join(tmp, "seq.jsonl")
    with open(sub, "w") as fh:
        fh.write("\n".join(json.dumps(j) for j in jobs
                           if j["label"] in BATCH_SEQUENTIAL) + "\n")
    t1 = time.perf_counter()
    rc_s, summ_s, reps_s, err_s, _m, _w = _batch_cli(
        ["batch", "--jobs", sub, "--sequential"])
    seq_wall = time.perf_counter() - t1
    check(rc_s == 0 and summ_s["sequential"] and
          summ_s["engines_compiled"] == len(BATCH_SEQUENTIAL),
          f"18a sequential: exit {rc_s} {summ_s} {err_s[-300:]}")
    by = {r["label"]: r for r in reps}
    for r in reps_s:
        check(_untimed(r) == _untimed(by[r["label"]]),
              f"18a sequential {r['label']}: {r} != {by[r['label']]}")
    # (b) the same job file against the filled cache
    t1 = time.perf_counter()
    rc_b, summ_b, reps_b, _e, _m, _w = _batch_cli(
        ["batch", "--jobs", path, "--cache-dir", cache])
    cache_wall = time.perf_counter() - t1
    check(rc_b == 1 and summ_b["cache_hits"] == len(BATCH_JOBS) and
          summ_b["batch_dispatches"] == 0 and
          summ_b["engines_compiled"] == 0, f"18b: {summ_b}")
    for r, a in zip(reps_b, reps):
        check(r["status"] == "cache_hit" and
              _untimed(r, ("status",)) == _untimed(a, ("status",)),
              f"18b {r['label']}")
    log(f"phase 18b cache [{card}]: every job answered from the cache "
        f"with 0 batched dispatches in {cache_wall:.2f} s")
    # (c) preemption and a kill, then the resume
    ws = os.path.join(tmp, "waves")
    argv = ["batch", "--jobs", path, "--wave-yield", "1", "--wave-state",
            ws]
    t1 = time.perf_counter()
    rc_k, _s, _r, err_k, _m, _w = _batch_cli(
        argv + ["--chaos", "wave_kill:at=2"])
    check(rc_k == 3 and "batch run failed" in err_k,
          f"18c kill: exit {rc_k} {err_k[-300:]}")
    saved = [f for f in os.listdir(ws) if f.endswith(".wave.npz")]
    rc_c, summ_c, reps_c, err_c, _m, waves_c = _batch_cli(argv)
    resume_wall = time.perf_counter() - t1
    check(rc_c == 1 and summ_c["resumed_jobs"] > 0,
          f"18c resume: {summ_c}")
    for r, a in zip(reps_c, reps):
        check(_untimed(r, ("status_reason",)) ==
              _untimed(a, ("status_reason",)), f"18c {r['label']}")
    check(not [f for f in os.listdir(ws) if f.endswith(".wave.npz")],
          "18c: wave state left behind")
    log(f"phase 18c kill and resume [{card}]: killed at the second wave "
        f"boundary with {len(saved)} jobs' wave state on disk; the resume "
        f"ran {len(waves_c)} waves ({summ_c['parked_waves']} parked), "
        f"resumed {summ_c['resumed_jobs']} jobs, every report == 18a's; "
        f"{resume_wall:.2f} s for both runs")
    return dict(jobs=len(reps), buckets=summ["buckets"], waves=len(waves),
                dispatches=summ["batch_dispatches"], wall=wall,
                seconds_per_job={r["label"]: r["service_s"] for r in reps},
                captures=captures, replays=replays, launches=launches,
                launches_per_step=per_step, sequential_wall=seq_wall,
                cache_wall=cache_wall, resume_wall=resume_wall,
                resumed_jobs=summ_c["resumed_jobs"],
                killed_with_saved=len(saved), jobs_file=jobs)


def fixture_i(torch, fp, cvt, home_slots, card):
    """18d: the dedup kernel at the serving bucket's shapes: eight 2^15
    tables filled to 35%, M = the bucket's FCAP (8,192), launched back to
    back as a batched step does; each held against the twin, the eight
    timed together by CUDA events, beside the bound."""
    import numpy as np
    dev = torch.device("cuda")
    rng = np.random.RandomState(18)
    vcap, M, J, W = 1 << 15, 8192, 8, 2
    tabs, keys_l, live_l, probes, nbytes, plain_ms = [], [], [], 0, 0, 0.0
    err = 0
    for j in range(J):
        n_fill = int(0.35 * vcap)
        pool = _keys(rng, n_fill + M, W, salt=100 + j)
        table = torch.full((W, vcap), -1, dtype=torch.int32, device=dev)
        fp.probe_claim_insert(table, cvt.words_to_torch(pool[:, :n_fill],
                                                        dev),
                              torch.ones(n_fill, dtype=torch.bool,
                                         device=dev))
        pick = np.concatenate([rng.randint(0, n_fill, M // 4),
                               n_fill + rng.randint(0, M // 2,
                                                    M - M // 4)])
        keys = cvt.words_to_torch(pool[:, pick], dev)
        live = torch.ones(M, dtype=torch.bool, device=dev)
        t_k = table.clone()
        fk, pk, hk = fp.probe_claim_insert(t_k, keys, live)
        t_p = table.cpu()
        t0 = time.perf_counter()
        fpl, ppl, hpl = fp.probe_claim_insert_plain(t_p, keys.cpu(),
                                                    live.cpu())
        plain_ms += (time.perf_counter() - t0) * 1e3
        err = max(err, int((t_k.cpu().long() - t_p.long()).abs().max()),
                  int((pk.cpu().long() - ppl.long()).abs().max()),
                  int((fk.cpu().long() - fpl.long()).abs().max()))
        check(torch.equal(t_k.cpu(), t_p) and torch.equal(fk.cpu(), fpl)
              and torch.equal(pk.cpu(), ppl) and bool(hk) == bool(hpl)
              and not bool(hk), f"18d: table {j}: kernel != twin")
        home = home_slots(keys, vcap).long()
        probes_j = _probes(home, pk.long(), vcap, fp.MAX_PROBE_ROUNDS)
        probes += probes_j
        nbytes += (4 * W * M + M + 4 * W * probes_j +
                   4 * W * int(fk.sum()) + M + 4 * M + 4)
        tabs.append(table)
        keys_l.append(keys)
        live_l.append(live)
    ms = []
    for _ in range(5):
        copies = [t.clone() for t in tabs]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        for t, k, lv in zip(copies, keys_l, live_l):
            fp.probe_claim_insert(t, k, lv)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    total = sorted(ms)[len(ms) // 2]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"phase 18d fixture (i) (8 tables of 2^15 at 35%, M {M} each, "
        f"launched back to back) [{card}]: kernel == twin on every "
        f"table; {total:.4f} ms for the eight (median of 5, "
        f"{total / J:.4f} ms a launch), plain twin {plain_ms:.1f} ms, "
        f"{probes} probes, {nbytes} bytes (bound {bound:.6f} ms)")
    return dict(ms=total, ms_per_launch=total / J, plain_ms=plain_ms,
                bound_ms=bound, probes=probes, bytes=nbytes,
                max_abs_err=err)


def serving_phase(torch, fp, cvt, home_slots, here, card):
    """Phase 18: batched serving on the card."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_batch_")
    try:
        a = batch_phase(torch, fp, here, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    jobs = a.pop("jobs_file")
    # the device's idle share over 18a's first raft wave, re-run
    idle = _batch_idle_share(torch, jobs[:8], a["wall"])
    log(f"phase 18 idle share [{card}]: 18a's first wave (8 raft jobs) "
        f"{idle['wall_s']:.3f} s warm ({idle['first_wall_s']:.3f} s with "
        f"its capture), device busy {idle['device_busy_ms']:.1f} ms in "
        f"{idle['device_kernels']} kernels: idle share "
        f"{idle['device_idle_share']:.3f}")
    d = fixture_i(torch, fp, cvt, home_slots, card)
    wall = time.perf_counter() - t0
    log(f"phase 18 [{card}]: {wall:.1f} s")
    return dict(sweep=a, idle=idle, kernel=d, wall=wall)


# Phase 20: the daemon (``serve``) over phase 18's job shapes: twelve of
# BATCH_JOBS (raft and paxos, two with violations and witnesses, one
# solo fallback), then a duplicate in a second cycle; the deep job of the
# drain and the kill.
SERVE_JOBS = ("r121d10", "r122d11", "r231d11", "r331d10", "r113d5",
              "r232d11", "fbl-r121", "big-r122d14", "p11", "p21", "p22d8",
              "vc-p22")
SERVE_DUP = "p21"
SERVE_DEEP = "r121d11"


@contextlib.contextmanager
def _serve_probe():
    """Record what the serving layer runs: each wave's labels, the width
    JP of each batched step (one dedup launch per job slot, eager
    warm-up or replay alike), each solo fallback's dedup launches, and
    the bucket engines built."""
    from raft_tla_tpu_torch.engine import graph as eg
    from raft_tla_tpu_torch.serve import batch as sb
    from raft_tla_tpu_torch.serve import scheduler as ss
    from raft_tla_tpu_torch.engine.fingerprint import PROBE_CLAIM_LAUNCHES
    rec = dict(waves=[], steps=[], solo=[], engines=[])
    run, wave, solo = (eg.GraphRunner.run, sb.BucketEngine.run_wave,
                       ss._run_solo)
    init = sb.BucketEngine.__init__

    def rec_run(self, key, fn):
        if isinstance(key, tuple) and key[0] == "batched":
            rec["steps"].append(key[1])
        return run(self, key, fn)

    def rec_wave(self, runs, *a, **kw):
        rec["waves"].append([r.job.label for r in runs])
        return wave(self, runs, *a, **kw)

    def rec_solo(job, *a, **kw):
        c0 = PROBE_CLAIM_LAUNCHES.count
        out = solo(job, *a, **kw)
        rec["solo"].append((job.label, PROBE_CLAIM_LAUNCHES.count - c0))
        return out

    def rec_init(self, *a, **kw):
        init(self, *a, **kw)
        rec["engines"].append(self)

    eg.GraphRunner.run, sb.BucketEngine.run_wave = rec_run, rec_wave
    ss._run_solo, sb.BucketEngine.__init__ = rec_solo, rec_init
    try:
        yield rec
    finally:
        eg.GraphRunner.run, sb.BucketEngine.run_wave = run, wave
        ss._run_solo, sb.BucketEngine.__init__ = solo, init


def _read_json(path):
    with open(path) as fh:
        return json.load(fh)


def _spool_results(spool):
    d = os.path.join(spool, "results")
    return {fn[:-5]: _read_json(os.path.join(d, fn))
            for fn in sorted(os.listdir(d))}


def _serve_cli(argv):
    """``serve`` through the CLI in this process; the daemon installs
    its SIGTERM/SIGINT handlers, which are put back after."""
    import signal
    saved = {sg: signal.getsignal(sg) for sg in (signal.SIGTERM,
                                                  signal.SIGINT)}
    try:
        rc, out, err, _seen = cli_run(argv)
    finally:
        for sg, h in saved.items():
            signal.signal(sg, h)
    return rc, out, err


def _daemon_service(torch, fp, jobs, tmp, card, exec_cache=False):
    """20a (20b with ``exec_cache``): an in-process daemon on the card
    over a spool of SERVE_JOBS, a torn and a malformed file, then (20a)
    a duplicate in a second cycle, then the idle drain."""
    from raft_tla_tpu_torch.obs import Heartbeat, Obs, RunLedger
    from raft_tla_tpu_torch.serve import Daemon, ExecCache, ResultCache
    tag = "20b" if exec_cache else "20a"
    spool = os.path.join(tmp, tag)
    led = os.path.join(tmp, tag + ".jsonl")
    ec = ExecCache(os.path.join(tmp, tag + "-exec")) if exec_cache \
        else None
    obs = Obs(ledger=RunLedger(led),
              heartbeat=Heartbeat(os.path.join(tmp, tag + ".hb")),
              run_info={"cmd": "serve"}, device="cuda")
    ctr = fp.PROBE_CLAIM_LAUNCHES
    t0 = time.perf_counter()
    with _serve_probe() as rec:
        d = Daemon(spool, cache=ResultCache(os.path.join(spool, "cache")),
                   wave_state=os.path.join(spool, "waves"),
                   exec_cache=ec, obs=obs, poll_s=0.0, max_idle_polls=2,
                   grace_s=0.0, sleep=lambda s: None, device="cuda")
        for k, label in enumerate(SERVE_JOBS):
            # the client protocol: write-then-rename, trailing newline
            d.intake.submit(jobs[label], f"{k:02d}-{label}")
        inc = d.intake.dirs["incoming"]
        with open(os.path.join(inc, "90-torn.json"), "w") as fh:
            fh.write(json.dumps(jobs["p11"]))
        with open(os.path.join(inc, "91-malformed.json"), "w") as fh:
            fh.write('{"spec": "paxos", "ballots": 2\n')
        ctr.reset()
        rep1 = d.run_cycle()
        launches = ctr.count
        rep2 = None
        if not exec_cache:
            d.intake.submit(jobs[SERVE_DUP], "99-dup")
            rep2 = d.run_cycle()
        rc = d.run()
    wall = time.perf_counter() - t0
    check(rc == 0 and d._drain == "idle for 2 polls",
          f"{tag}: daemon exit {rc}, drain {d._drain!r}")
    res = _spool_results(spool)
    names = [f"{k:02d}-{lbl}" for k, lbl in enumerate(SERVE_JOBS)]
    check(sorted(res) == sorted(names + ([] if exec_cache else
                                         ["99-dup"])),
          f"{tag}: results {sorted(res)}")
    _check_pins([res[n] for n in names], tag)
    check(all(res[n]["dedup_kernel"] == 1 for n in names),
          f"{tag}: a result without the kernel")
    fell = sorted(r["label"] for r in res.values()
                  if r["status"] == "fallback")
    check(fell == ["big-r122d14"], f"{tag}: fallbacks {fell}")
    traced = sorted(r["label"] for r in res.values() if any(
        "trace" in v for v in r["violations_detail"]))
    check(traced == ["fbl-r121", "vc-p22"], f"{tag}: witnesses {traced}")
    rej = sorted(os.listdir(os.path.join(spool, "rejected")))
    check(rej == ["90-torn.json", "90-torn.json.reason",
                  "91-malformed.json", "91-malformed.json.reason"],
          f"{tag}: rejected {rej}")
    torn = open(os.path.join(spool, "rejected",
                             "90-torn.json.reason")).read()
    check(torn.startswith("torn/incomplete job file (no trailing "
                          "newline"), f"{tag}: torn reason {torn!r}")
    done = os.path.join(spool, "done")
    check(sorted(os.listdir(done)) == sorted(n + ".json" for n in res),
          f"{tag}: done markers")
    for n in res:
        check(os.stat(os.path.join(done, n + ".json")).st_mtime_ns >=
              os.stat(os.path.join(spool, "results",
                                   n + ".json")).st_mtime_ns,
              f"{tag}: the marker of {n} is older than its result")
    check(os.listdir(os.path.join(spool, "claimed")) == [],
          f"{tag}: claims left")
    # the dedup kernel: one launch per job slot per batched step, plus
    # the solo fallbacks' own
    batched = sum(rec["steps"])
    solo = sum(n for _l, n in rec["solo"])
    check(launches == batched + solo and batched > 0 and
          [lbl for lbl, _n in rec["solo"]] == ["big-r122d14"] and
          solo > 0,
          f"{tag}: launches {launches} != {batched} batched + {solo} "
          f"solo ({rec['solo']})")
    captures = sum(be._graphs.captures for be in d.sched._engines.values())
    replays = sum(be._graphs.replays for be in d.sched._engines.values())
    check(captures > 0 and replays > 0,
          f"{tag}: {captures} captures, {replays} replays")
    rows = _ledger_rows(led)
    intake = [(r["action"], r["name"]) for r in rows
              if r.get("kind") == "intake"]
    cycles = [r for r in rows if r.get("kind") == "daemon"]
    want_claims = names + ([] if exec_cache else ["99-dup"])
    check(sorted(n for a, n in intake if a == "claimed") ==
          sorted(want_claims) and
          sorted(n for a, n in intake if a == "rejected") ==
          ["90-torn", "91-malformed"],
          f"{tag}: intake rows {intake}")
    check([r["cycle"] for r in cycles] ==
          ([1] if exec_cache else [1, 2]), f"{tag}: daemon rows {cycles}")
    out = dict(jobs=len(res), waves=len(rec["waves"]),
               wave_sizes=[len(w) for w in rec["waves"]],
               buckets=rep1.meta["buckets"],
               dispatches=rep1.meta["batch_dispatches"],
               batched_steps=len(rec["steps"]), launches=launches,
               launches_batched=batched, launches_solo=solo,
               captures=captures, replays=replays, wall_s=wall,
               cycle1_s=rep1.meta["seconds"])
    if exec_cache:
        st = ec.stats()
        check(st["exec_cache_misses"] == captures and
              st["exec_cache_stores"] == 0 and
              st["exec_cache_hits"] == 0 and
              st["exec_cache_store_failures"] == captures,
              f"20b: exec cache {st} against {captures} captures")
        check(all(r.startswith("backend cannot serialize executables (")
                  for r in st["exec_cache_store_fail_reasons"]),
              f"20b: reasons {st['exec_cache_store_fail_reasons']}")
        check(os.listdir(ec.path) == [], "20b: an entry was written")
        check(rep1.meta["exec_cache_store_failures"] == captures,
              f"20b: the cycle's meta {rep1.meta}")
        ecr = [r for r in rows if r.get("kind") == "exec_cache"]
        check(len(ecr) == 1 and ecr[0]["exec_cache_hits"] == 0,
              f"20b: exec_cache rows {ecr}")
        out["exec_cache"] = {k: v for k, v in st.items()
                             if not k.endswith("_reasons")}
        out["exec_cache_fail_reason"] = \
            st["exec_cache_store_fail_reasons"][-1]
    else:
        dup = res["99-dup"]
        check(dup["status"] == "cache_hit" and
              rep2.meta["batch_dispatches"] == 0 and
              rep2.meta["cache_hits"] == 1 and
              cycles[1]["batch_dispatches"] == 0,
              f"20a duplicate: {dup['status']} {rep2.meta}")
        _check_pins([dup], "20a duplicate")
        out["cache_hits"] = rep2.meta["cache_hits"]
        out["results"] = {r["label"]: (r["distinct_states"],
                                       r["violations"], r["status"])
                          for r in res.values()}
    return out


def _drain_subprocess(here, jobs, tmp, card):
    """20c: ``serve`` as a process with one deep raft job, SIGTERM once
    the ledger shows its first batched dispatch.  The second dispatch
    faults (``--chaos dispatch:at=2``) and the cycle backs off for
    ``--backoff 4`` seconds before its retry, so the signal lands
    while the job still has work: the retry parks it at once."""
    import signal
    spool = os.path.join(tmp, "20c")
    led, hb, reg = (os.path.join(tmp, "20c.jsonl"),
                    os.path.join(tmp, "20c.hb"),
                    os.path.join(tmp, "20c-reg"))
    from raft_tla_tpu_torch.serve import SpoolIntake
    SpoolIntake(spool).submit(jobs[SERVE_DEEP], "deep")
    cmd = [sys.executable, "-m", "raft_tla_tpu_torch", "serve", "--spool",
           spool, "--poll", "0.05", "--wave-yield", "1", "--chaos",
           "dispatch:at=2", "--retries", "1", "--backoff", "4",
           "--ledger", led, "--heartbeat", hb, "--registry", reg]
    logp = os.path.join(tmp, "20c.log")
    t0 = time.perf_counter()
    with open(logp, "w") as log:
        proc = subprocess.Popen(cmd, cwd=here, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            def first_dispatch():
                # the ledger is being written: match the text, since its
                # last line may be partial
                if not os.path.exists(led):
                    return False
                with open(led) as fh:
                    return '"kind": "batch"' in fh.read()
            deadline = time.time() + 180
            while not first_dispatch():
                check(proc.poll() is None and time.time() < deadline,
                      f"20c: no dispatch row (exit {proc.poll()}): "
                      f"{open(logp).read()[-600:]}")
                time.sleep(0.05)
            t_sig = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    check(rc == 0, f"20c: exit {rc}: {open(logp).read()[-600:]}")
    beat = _read_json(hb)
    check(beat["status"] == "done" and
          beat["daemon"]["drain_reason"] == "signal SIGTERM",
          f"20c: heartbeat {beat.get('status')} {beat.get('daemon')}")
    recs = [_read_json(os.path.join(reg, f)) for f in os.listdir(reg)
            if f.endswith(".json")]
    check(len(recs) == 1 and recs[0]["cmd"] == "serve" and
          recs[0]["status"] == "draining",
          f"20c: registry {[(r.get('cmd'), r.get('status')) for r in recs]}")
    check(os.listdir(os.path.join(spool, "claimed")) == ["deep.json"],
          "20c: the claimed file is gone")
    waves = [f for f in os.listdir(os.path.join(spool, "waves"))
             if f.endswith(".wave.npz")]
    check(len(waves) == 1, f"20c: wave state {waves}")
    rows = _ledger_rows(led)
    check([r["kind"] for r in rows if r.get("kind") in
           ("batch", "retry")] == ["batch", "retry"],
          "20c: expected one batched dispatch, then the retry")
    cyc = [r for r in rows if r.get("kind") == "daemon"]
    check(len(cyc) == 1 and cyc[0]["deferred"] == 1 and cyc[0]["drained"],
          f"20c: daemon rows {cyc}")
    return dict(spool=spool, wall_s=wall,
                signal_to_exit_s=time.perf_counter() - t_sig)


def _restart(spool, tmp, tag, label):
    """A new ``serve`` on a spool left by a drain or a kill: it recovers
    the claimed file, resumes the job from its wave state and answers
    as the pin."""
    led = os.path.join(tmp, tag + ".jsonl")
    t0 = time.perf_counter()
    rc, out, err = _serve_cli(["serve", "--spool", spool, "--poll", "0.01",
                               "--max-idle-polls", "1", "--ledger", led])
    wall = time.perf_counter() - t0
    check(rc == 0, f"{tag}: restart exit {rc}: {err[-400:]}")
    rows = _ledger_rows(led)
    check([r["action"] for r in rows if r.get("kind") == "intake"] ==
          ["recovered"] and
          [r["label"] for r in rows if r.get("kind") == "wave_resume"] ==
          [label], f"{tag}: restart rows "
          f"{[(r.get('kind'), r.get('action')) for r in rows]}")
    res = _spool_results(spool)
    check(list(res) == ["deep"] and
          res["deep"]["status_reason"] == "resumed from wave state",
          f"{tag}: restart results {res}")
    _check_pins([res["deep"]], tag)
    check(os.listdir(os.path.join(spool, "claimed")) == [] and
          not [f for f in os.listdir(os.path.join(spool, "waves"))
               if f.endswith(".wave.npz")], f"{tag}: leftovers")
    return wall


def _kill_and_restart(jobs, tmp, card):
    """20d: ``serve --chaos wave_kill:at=1 --retries 0`` exits 3 with the
    claimed file and the wave state on disk; a new ``serve`` resumes."""
    spool = os.path.join(tmp, "20d")
    from raft_tla_tpu_torch.serve import SpoolIntake
    SpoolIntake(spool).submit(jobs[SERVE_DEEP], "deep")
    reg = os.path.join(tmp, "20d-reg")
    t0 = time.perf_counter()
    rc, out, err = _serve_cli(["serve", "--spool", spool, "--poll", "0.01",
                               "--chaos", "wave_kill:at=1", "--retries",
                               "0", "--registry", reg])
    kill_wall = time.perf_counter() - t0
    check(rc == 3 and "serve cycle failed" in out,
          f"20d: kill exit {rc}: {out[-300:]} {err[-300:]}")
    check(os.listdir(os.path.join(spool, "claimed")) == ["deep.json"] and
          len([f for f in os.listdir(os.path.join(spool, "waves"))
               if f.endswith(".wave.npz")]) == 1 and
          os.listdir(os.path.join(spool, "done")) == [],
          "20d: the kill lost the claim or the wave state")
    recs = [_read_json(os.path.join(reg, f)) for f in os.listdir(reg)
            if f.endswith(".json")]
    check([r["status"] for r in recs] == ["failed"],
          f"20d: registry {[r.get('status') for r in recs]}")
    return dict(kill_wall_s=kill_wall,
                restart_wall_s=_restart(spool, tmp, "20d-restart",
                                        SERVE_DEEP))


def daemon_phase(torch, fp, here, card):
    """Phase 20: the daemon on the card."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    jobs = _batch_jobs(here)
    try:
        a = _daemon_service(torch, fp, jobs, tmp, card)
        log(f"phase 20a daemon [{card}]: {a['jobs']} results in "
            f"{a['waves']} waves {a['wave_sizes']} over {a['buckets']} "
            f"buckets, {a['dispatches']} batched dispatches, every answer "
            f"== the pinned solo runs (1 fallback, 2 witnesses), the "
            f"duplicate a cache hit with 0 dispatches, the torn and the "
            f"malformed file rejected with reasons; dedup launches "
            f"{a['launches']} = {a['launches_batched']} in "
            f"{a['batched_steps']} batched steps (one per job slot) + "
            f"{a['launches_solo']} in the fallback; {a['captures']} "
            f"captures, {a['replays']} replays; wall {a['wall_s']:.2f} s")
        b = _daemon_service(torch, fp, jobs, tmp, card, exec_cache=True)
        log(f"phase 20b --executable-cache [{card}]: {b['exec_cache']} "
            f"against {b['captures']} graph captures, no entry written, "
            f"answers unchanged; every store failed: "
            f"{b['exec_cache_fail_reason']!r}; wall {b['wall_s']:.2f} s")
        c = _drain_subprocess(here, jobs, tmp, card)
        c["restart_wall_s"] = _restart(c.pop("spool"), tmp, "20c-restart",
                                       SERVE_DEEP)
        log(f"phase 20c drain [{card}]: serve process SIGTERMed after its "
            f"first dispatch: exit 0 in {c['signal_to_exit_s']:.2f} s, "
            f"heartbeat done, registry cmd=serve status=draining, the "
            f"claim and the .wave.npz kept; a new serve resumed it == the "
            f"pin in {c['restart_wall_s']:.2f} s (process wall "
            f"{c['wall_s']:.2f} s)")
        d = _kill_and_restart(jobs, tmp, card)
        log(f"phase 20d kill [{card}]: wave_kill:at=1 exit 3 in "
            f"{d['kill_wall_s']:.2f} s, claim and wave state kept; the "
            f"restart resumed == the pin in {d['restart_wall_s']:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 20 [{card}]: {wall:.1f} s")
    return dict(service=a, exec_cache=b, drain=c, kill=d, wall_s=wall,
                card=card)


def config4_phase(torch, fp, here, card):
    """Phase 19: BASELINE config #4 (the apalache variant) to depth 10
    against baseline_runs/config4.json, and the LeaderCompleteness_false
    hunt against the oracle's witness."""
    from raft_tla_tpu_torch.cfg.parser import load_model
    from raft_tla_tpu_torch.config import Bounds
    from raft_tla_tpu_torch.engine.bfs import Engine
    from raft_tla_tpu_torch.models.explore import _walk_key
    from raft_tla_tpu_torch.models.golden import CONCURRENT_LEADERS_LABELS
    from raft_tla_tpu_torch.models.predicates import resolve_invariant
    from raft_tla_tpu_torch.models.raft import init_state, successors
    apa = os.path.join(here, "configs/apalache_no_membership/raft.cfg")
    with open(os.path.join(here, "baseline_runs/config4.json")) as fh:
        base = json.load(fh)["engine"]
    cfg = load_model(apa)
    check(cfg.apalache_variant, "config #4 is not the apalache variant")
    ctr = fp.PROBE_CLAIM_LAUNCHES
    ctr.reset()
    t0 = time.perf_counter()
    r = Engine(cfg).check(max_depth=10)
    wall = time.perf_counter() - t0
    check((r.distinct_states, r.depth, len(r.violations)) ==
          (base["distinct"], base["depth"], base["violations"]),
          f"config #4: {r.distinct_states}, depth {r.depth}, "
          f"{len(r.violations)} violations")
    launches = ctr.count
    log(f"phase 19a config #4 [{card}]: {r.distinct_states} states at "
        f"depth {r.depth}, 0 violations == baseline_runs/config4.json; "
        f"{wall:.2f} s, {launches} dedup launches")
    hunt = load_model(apa, bounds=Bounds.make(
        max_log_length=2, max_timeouts=3, max_client_requests=2)).with_(
            n_servers=3, init_servers=(0, 1, 2),
            invariants=("LeaderCompleteness",))
    sv, h = init_state(hunt)
    for lbl in CONCURRENT_LEADERS_LABELS:
        (sv, h), = [(s2, h2) for l2, s2, h2 in successors(sv, h, hunt)
                    if l2 == lbl]
    t0 = time.perf_counter()
    eng = Engine(hunt, chunk=256)
    got = eng.check(seed_states=[(sv, h)], stop_on_violation=True,
                    max_states=200_000)
    hunt_wall = time.perf_counter() - t0
    chain = [s_ for _l, s_ in eng.trace(got.violations[0].state_id)]
    check(got.violations[0].invariant == "LeaderCompleteness" and
          got.depth == LC_HUNT_DEPTH and len(chain) == LC_HUNT_DEPTH + 1,
          f"LeaderCompleteness hunt: depth {got.depth}, {len(chain)} "
          "states")
    # the engine's witness, step by step through the oracle from the
    # seed (its lane labels name bag slots, the oracle's the handlers)
    check(_walk_key(chain[0]) == _walk_key(sv), "hunt: not from the seed")
    labels = []
    for nxt in chain[1:]:
        step = [(lb, s2, h2) for lb, s2, h2 in successors(sv, h, hunt)
                if _walk_key(s2) == _walk_key(nxt)]
        check(len(step) >= 1, f"hunt: step {len(labels) + 1} is not an "
              "oracle successor")
        lb, sv, h = step[0]
        labels.append(lb)
    check(labels == LC_HUNT_TRACE, f"hunt: witness {labels}")
    check(not resolve_invariant("LeaderCompleteness", hunt)(sv, h, hunt),
          "hunt: the witness's end state holds LeaderCompleteness")
    log(f"phase 19b LeaderCompleteness_false hunt [{card}]: found at "
        f"depth {got.depth} from the ConcurrentLeaders witness; its "
        f"witness, replayed by the oracle, is the oracle's "
        f"({' -> '.join(LC_HUNT_TRACE)}); {hunt_wall:.2f} s")
    return dict(distinct=r.distinct_states, wall=wall, launches=launches,
                hunt_depth=got.depth, hunt_wall=hunt_wall,
                hunt_distinct=got.distinct_states)


# Phase 21: the sharded engine (parallel/mesh.py) and the walker fleet
# (parallel/sim_mesh.py), D shards on the one card (devices ["cuda:0"]*D).
# The reference's ShardedEngine on config #1 (2 of the 8 virtual CPU
# devices, chunk 2048, lcap 2^20, vcap 2^22, the 2,000,000 budget) ran
# to depth 19 in 577 s on the CPU: 2,540,315 distinct and 6,447,443
# generated states with these level sizes (those of the reference's
# Engine), and 105,915 / 242,661 at depth 16, where its Engine agrees
# (tests/test_torch_mesh.py).
CONFIG1_MESH_LEVEL_SIZES = [1, 2, 4, 7, 12, 19, 28, 40, 57, 84, 154, 397,
                            1252, 4091, 12873, 38411, 108856, 294895,
                            768234]
CONFIG1_MESH_GENERATED = 6_447_443
CONFIG1_DEPTH16_COUNTS = (105_915, 242_661)
# 21d: a 2-shard checkpoint of config #1 at depth 12 as a portable image,
# resumed to depth 16 by the reference's engines on the CPU: its
# ShardedEngine on 4 devices lands on CONFIG1_DEPTH16_COUNTS; its
# first-seen Engine, continuing from the mesh's content-canonical
# representatives, on these (counter-dependent constraints prune
# differently from other representatives)
MESH_IMAGE_CLASSIC = (105_902, 242_613, 16,
                      [1, 2, 4, 7, 12, 19, 28, 40, 57, 84, 154, 397,
                       1252, 4090, 12868, 38390])
# The reference's ShardedEngine on phase 6's micro config (FirstCommit,
# stop at the first violation; 8 virtual CPU devices, chunk 64): its
# content-canonical witness, the same at D = 2 and 4, at these
# device-major global ids (the classic engine's first-seen witness is
# MICRO_TRACE)
MESH_MICRO_TRACE = ["Init", "Timeout(1)", "RequestVote(1,0)",
                    "UpdateTerm[slot0]", "Receive[slot0]", "Receive[slot0]",
                    "RequestVote(1,1)", "Receive[slot0]", "Receive[slot0]",
                    "BecomeLeader(1)", "ClientRequest(1,1)",
                    "AppendEntries(1,0)", "Receive[slot0]",
                    "Receive[slot0]", "Receive[slot0]",
                    "AdvanceCommitIndex(1)"]
MESH_MICRO_GIDS = {2: 373, 4: 379}
MESH_SHARDS = (1, 2, 4)
MESH_ENGINE = dict(chunk=2048, lcap=1 << 21, vcap=1 << 24)
MESH_CKPT_DEPTH, MESH_CPU_DEPTH = 12, 14
# 21c: four table shards of config #1's D = 4 run (VB 2^22) at the load
# of its last level, receive windows of D * SC keys
MESH_FIXTURE = dict(shards=4, log2_vb=22, M=4 * 8192)
# 21e: phase 13a's hunt split into two cohorts, and a hit-free fleet
MESH_FLEET_COHORTS = 2
MESH_FREE_STEPS = 256


# Phase 22: the spill-composed mesh (parallel/spill_mesh.py), D shards of
# cuda:0.  Its answers are pinned from JAX CPU runs of the reference's
# SpilledShardedEngine on D of the 8 virtual CPU devices:
#   SpilledShardedEngine(build_cfg(1), devices=jax.devices()[:D],
#       chunk=2048, lcap=LCAP, vcap=1 << 24, store_states=False
#   ).check(max_states=2_000_000)
# with its trips counted by wrapping _handle_mesh_trip.  22a, lcap 2^21 at
# D = 2 (343.9 s on the CPU): 2,540,315 / 6,447,443 / depth 19 and the
# mesh's level sizes (phase 21a's answer), no mid-level spill, 2 trips.
# 22b, lcap 2^17 (the receive window's floor: 65,536 usable level rows a
# shard at D = 2, 32,768 at D = 4): the widest levels spill mid-level, and
# the per-epoch survivor lands on these answers (459.2 s / 323.6 s on the
# CPU); the capacities at the end (LB, FC, SC, VB) are the reference's.
SM_ENGINE = dict(chunk=2048, vcap=1 << 24, store_states=False)
SM_LEVEL_END_LCAP, SM_LEVEL_END_TRIPS = 1 << 21, 2
SM_SQUEEZED_LCAP = 1 << 17
SM_PINS = {
    2: dict(distinct=2_540_259, generated=6_447_168, mid=17, trips=19,
            caps=(131_072, 16_384, 32_768, 1 << 23),
            tail=[294_867, 767_997]),
    4: dict(distinct=2_540_279, generated=6_447_259, mid=17, trips=18,
            caps=(65_536, 8_192, 8_192, 1 << 22),
            tail=[294_877, 768_045])}
# 22c: the reference's spill-mesh MICRO (tests/test_spill_mesh.py: two
# servers, no symmetry, the VIEW-only constraints) with FirstCommit,
# squeezed to spill levels 12-15 mid-level, archive on disk, stopped at
# the first violation; the reference's gids, violations and witness
#   SpilledShardedEngine(micro, devices=jax.devices()[:D],
#       store_states=True, archive_dir=tmp, **SM_MICRO_ENGINE[D]
#   ).check(stop_on_violation=True)
SM_MICRO_ENGINE = {2: dict(chunk=16, lcap=1024, scap=128, vcap=1 << 15),
                   4: dict(chunk=32, lcap=1024, scap=32, vcap=1 << 16)}
SM_MICRO_PINS = {2: dict(gids=[4489, 4606], mid=4),
                 4: dict(gids=[4289, 4380], mid=4)}
SM_MICRO_DISTINCT = 4742
SM_MICRO_TRACE = ["Init", "Timeout(1)", "RequestVote(1,0)",
                  "UpdateTerm[slot0]", "Receive[slot0]", "RequestVote(1,1)",
                  "Receive[slot0]", "Receive[slot1]", "Receive[slot0]",
                  "BecomeLeader(1)", "ClientRequest(1,1)",
                  "AppendEntries(1,0)", "Receive[slot0]", "Receive[slot0]",
                  "Receive[slot0]", "AdvanceCommitIndex(1)"]
# 22d: the kernel at 22b's D = 2 table shards (VB 2^23) and windows (M =
# D x SC = 65,536); D = 4's (2^22, 32,768) are 21c's
SM_FIXTURE = dict(shards=2, log2_vb=23, M=2 * 32768)
# 22e: 22b's D = 2 run checkpointed at every level to depth 12 (the burst
# fuses levels 1-12, so one file, after the burst).  The reference's file
# from a JAX CPU run of its engine at the same settings,
#   SpilledShardedEngine(build_cfg(1), devices=jax.devices()[:2],
#       chunk=2048, lcap=1 << 17, vcap=1 << 24, store_states=False
#   ).check(max_depth=12, checkpoint_path=F, checkpoint_every=1)
# holds 397 frontier rows and 2,377 keys; the sha256 of its frontier arrays
# ("carry|pf|..." by name, then bytes) and of its keys in ascending order
# (its CPU dedup is the lax form, whose slots may differ from the kernel's).
# Its portable image to depth 16: the reference's ShardedEngine on 4
# devices (MESH_ENGINE) lands on CONFIG1_DEPTH16_COUNTS and the mesh's
# levels, its SpillEngine (SM_IMAGE_SPILL) on MESH_IMAGE_CLASSIC, and its
# classic Engine refuses the image: the rows pruned at level 12 left gaps in
# the frontier's ids.
SM_CKPT_DEPTH, SM_CKPT_CPU_DEPTH, SM_IMAGE_DEPTH = 12, 14, 16
SM_CKPT_FILE = dict(
    n_front=397, n_keys=2377, n_vis=[1198, 1179],
    caps=(131_072, 1 << 23, 16_384, 32_768),
    fam_caps=[2048, 1024, 2048, 2048, 2048, 2048, 1024, 4096, 3072, 3072],
    pf_sha256="374f800238b2cae6c71a11567b3f6730e897b28c638306b43e5396923bf07043",
    keys_sha256="2e7e5a6741c7aee460a0747226b339f6053c052e65e10112519b353256c61ec8")
SM_IMAGE_SPILL = dict(chunk=2048, seg=1 << 17, vcap=1 << 24,
                      store_states=False)
SM_IMAGE_REFUSAL = "gids are not contiguous"
# the 4th level-loop dispatch is level 17's (the burst takes 1-14, bailing
# at 15): the retry resumes from the depth-16 file
SM_CHAOS = "dispatch:at=4"


def mesh_run(torch, fp, cfg, D, kw, capture=True, **check_kw):
    """``ShardedEngine(cfg, devices=["cuda:0"] * D).check`` with the
    kernel's launch counter zeroed just before and read just after."""
    from raft_tla_tpu_torch.parallel.mesh import ShardedEngine
    eng = ShardedEngine(cfg, devices=["cuda:0"] * D, **kw)
    eng._capture = capture
    torch.cuda.synchronize()
    ctr = fp.PROBE_CLAIM_LAUNCHES
    ctr.reset()
    t0 = time.perf_counter()
    res = eng.check(**check_kw)
    wall = time.perf_counter() - t0
    launches = ctr.count
    ctr.reset()
    check(launches > 0, f"D={D}: the mesh never launched the kernel")
    check(launches == D * eng.lockstep_steps + eng.rehash_launches,
          f"D={D}: {launches} launches != {D} x {eng.lockstep_steps} "
          f"steps + {eng.rehash_launches} rehash launches")
    check(capture == (eng.replays > 0),
          f"D={D}: graph replays {eng.replays} with capture={capture}")
    return dict(eng=eng, res=res, wall=wall, launches=launches,
                steps=eng.lockstep_steps, flag_reads=eng.flag_reads,
                rehash_launches=eng.rehash_launches,
                captures=eng.captures, replays=eng.replays)


def mesh_config1_phase(torch, fp, cfg1, card):
    """21a: config #1 at D = 1, 2 and 4 shards on the card to the
    budget's depth: identical counts and level sizes across D, equal to
    the reference mesh's pinned answer (which is its Engine's too)."""
    runs = {}
    for D in MESH_SHARDS:
        r = mesh_run(torch, fp, cfg1, D,
                     dict(MESH_ENGINE, store_states=False),
                     max_states=CONFIG1_MAX_STATES)
        res = r["res"]
        runs[D] = r
        log(f"phase 21a config #1 on {D} shard(s) [{card}]: distinct "
            f"{res.distinct_states}, generated {res.generated_states}, "
            f"depth {res.depth} (classic engine: {CONFIG1_DISTINCT} / "
            f"depth {CONFIG1_DEPTH}); wall {r['wall']:.2f} s, "
            f"{res.distinct_states / r['wall']:.0f} states/s; "
            f"{r['steps']} lock-step steps, {r['flag_reads']} flag reads, "
            f"probe_claim_insert launches {r['launches']} = {D} x "
            f"{r['steps']} + {r['rehash_launches']} (rehash); levels "
            f"fused {res.levels_fused} in {res.burst_dispatches} bursts "
            f"({res.burst_bailouts} bailed); graphs captured "
            f"{r['captures']}, replayed {r['replays']}; LB "
            f"{r['eng'].LB}, VB {r['eng'].VB}, FC {r['eng'].FC}, SC "
            f"{r['eng'].SC}")
    base = runs[MESH_SHARDS[0]]["res"]
    for D, r in runs.items():
        res = r["res"]
        check((res.distinct_states, res.generated_states, res.depth,
               res.level_sizes) == (base.distinct_states,
                                    base.generated_states, base.depth,
                                    base.level_sizes),
              f"21a: D={D} differs from D={MESH_SHARDS[0]}")
    # the reference mesh's pinned answer, which is also its Engine's
    check_answer("21a config #1 on the mesh", dict(res=base),
                 CONFIG1_DISTINCT, CONFIG1_DEPTH, CONFIG1_MESH_LEVEL_SIZES)
    check(base.generated_states == CONFIG1_MESH_GENERATED,
          f"21a: generated {base.generated_states}")
    return {D: dict(wall=r["wall"], launches=r["launches"],
                    steps=r["steps"], flag_reads=r["flag_reads"],
                    rehash_launches=r["rehash_launches"],
                    captures=r["captures"], replays=r["replays"],
                    distinct=r["res"].distinct_states,
                    LB=r["eng"].LB, VB=r["eng"].VB, FC=r["eng"].FC,
                    SC=r["eng"].SC)
            for D, r in runs.items()}


def mesh_witness_phase(torch, fp, card):
    """21b: the FirstCommit witness at D = 2 and 4 (identical traces,
    replayed by the oracle); paxos at D = 2 == the classic engine."""
    from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
    from raft_tla_tpu_torch.engine.bfs import Engine
    from raft_tla_tpu_torch.models.explore import oracle_validates_walk
    from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig
    micro = ModelConfig(
        n_servers=2, init_servers=(0, 1), values=(1,),
        next_family=NEXT_ASYNC, symmetry=True, max_inflight_override=2,
        invariants=("FirstCommit",),
        bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                           max_client_requests=1))
    traces, gids = {}, {}
    for D in (2, 4):
        r = mesh_run(torch, fp, micro, D, dict(chunk=64),
                     stop_on_violation=True)
        check(r["res"].violations, f"21b: no FirstCommit witness at D={D}")
        gids[D] = r["res"].violations[0].state_id
        traces[D] = r["eng"].trace(gids[D])
    labels = {D: [lbl for lbl, _ in t] for D, t in traces.items()}
    check(labels[2] == labels[4] == MESH_MICRO_TRACE and
          gids == MESH_MICRO_GIDS, f"21b: witnesses {gids} {labels}")
    states = [sv for _l, sv in traces[2]]
    check(states == [sv for _l, sv in traces[4]],
          "21b: the witnesses' states differ")
    walk = oracle_validates_walk(micro, states)
    check(len(walk) == len(MESH_MICRO_TRACE) - 1,
          "21b: the oracle did not replay the witness")
    pax = PaxosConfig()
    pm = mesh_run(torch, fp, pax, 2, dict(chunk=64, store_states=False))
    pc = Engine(pax, chunk=64, store_states=False,
                device="cuda").check()
    got = (pm["res"].distinct_states, pm["res"].generated_states,
           pm["res"].depth, pm["res"].level_sizes)
    check(got == (pc.distinct_states, pc.generated_states, pc.depth,
                  pc.level_sizes), f"21b: paxos mesh {got[:3]} != "
          f"classic {(pc.distinct_states, pc.depth)}")
    log(f"phase 21b FirstCommit witness [{card}]: D=2 == D=4 action by "
        f"action ({len(MESH_MICRO_TRACE) - 1} steps, the reference mesh's "
        f"labels, gids {gids}), replayed by the oracle; paxos on 2 "
        f"shards == the classic "
        f"engine ({got[0]} states, depth {got[2]}, "
        f"{pm['launches']} launches)")
    return dict(paxos_distinct=got[0], paxos_launches=pm["launches"])


def mesh_kernel_phase(torch, fp, cvt, home_slots, card, fixture=None,
                      tag="21c"):
    """21c: the dedup kernel at the mesh's shapes: S table shards of one
    VB on the card at config #1's last-level load, receive windows of M
    keys (duplicates across the shards and within a window), launched
    back to back on one stream, twice; each output == the plain twin's,
    the two passes agree; the S timed together.  ``fixture`` (default
    MESH_FIXTURE) gives S, VB and M; 22d runs it at the spill mesh's."""
    import numpy as np
    fixture = fixture or MESH_FIXTURE
    dev = torch.device("cuda")
    rng = np.random.RandomState(21)
    S, vb, M, W = (fixture["shards"], 1 << fixture["log2_vb"],
                   fixture["M"], 2)
    n_fill = (CONFIG1_DISTINCT + S - 1) // S
    tabs = []
    shared = _keys(rng, M // 4, W, salt=2100)      # in every window
    wins, lives, pools = [], [], []
    for s in range(S):
        pool = _keys(rng, n_fill + M, W, salt=2200 + s)
        t = torch.full((W, vb), -1, dtype=torch.int32, device=dev)
        fp.probe_claim_insert(t, cvt.words_to_torch(pool[:, :n_fill], dev),
                              torch.ones(n_fill, dtype=torch.bool,
                                         device=dev))
        pick = np.concatenate([rng.randint(0, n_fill, M // 4),
                               n_fill + rng.randint(0, M // 4, M // 4)])
        win = np.concatenate([shared, pool[:, pick]], 1)
        win = win[:, :M] if win.shape[1] >= M else np.concatenate(
            [win, pool[:, n_fill + M // 4:n_fill + M // 4 +
                       (M - win.shape[1])]], 1)
        live = rng.rand(M) < 0.9
        tabs.append(t)
        wins.append(cvt.words_to_torch(win, dev))
        lives.append(torch.from_numpy(live).to(dev))
    torch.cuda.synchronize()
    outs = []
    for _pass in range(2):
        copies = [t.clone() for t in tabs]
        got = [fp.probe_claim_insert(c, k, lv)
               for c, k, lv in zip(copies, wins, lives)]
        torch.cuda.synchronize()
        outs.append((copies, got))
    err, plain_ms, probes, nbytes = 0, 0.0, 0, 0
    for s in range(S):
        t_p = tabs[s].cpu()
        t0 = time.perf_counter()
        fpl, ppl, hpl = fp.probe_claim_insert_plain(t_p, wins[s].cpu(),
                                                    lives[s].cpu())
        plain_ms += (time.perf_counter() - t0) * 1e3
        for copies, got in outs:
            fk, pk, hk = got[s]
            err = max(err, int((copies[s].cpu().long() -
                                t_p.long()).abs().max()),
                      int((pk.cpu().long() - ppl.long()).abs().max()),
                      int((fk.cpu().long() - fpl.long()).abs().max()))
            check(torch.equal(copies[s].cpu(), t_p) and
                  torch.equal(fk.cpu(), fpl) and
                  torch.equal(pk.cpu(), ppl) and bool(hk) == bool(hpl),
                  f"{tag}: shard {s}: kernel != twin")
        (c0, g0), (c1, g1) = outs
        check(torch.equal(c0[s], c1[s]) and all(
            torch.equal(a, b) for a, b in zip(g0[s], g1[s])),
            f"{tag}: shard {s}: the two passes differ")
        fk = g0[s][0]
        live = lives[s]
        home = home_slots(wins[s], vb).long()
        p = _probes(home[live], g0[s][1].long()[live], vb,
                    fp.MAX_PROBE_ROUNDS)
        probes += p
        nbytes += 4 * W * M + M + 4 * W * p + 4 * W * int(fk.sum()) + \
            M + 4 * M + 4
    ms = []
    for _ in range(5):
        copies = [t.clone() for t in tabs]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        for c, k, lv in zip(copies, wins, lives):
            fp.probe_claim_insert(c, k, lv)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    total = sorted(ms)[len(ms) // 2]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"phase {tag} the mesh's shapes ({S} table shards of 2^"
        f"{fixture['log2_vb']} at {n_fill} keys each, windows of M "
        f"{M}, launched back to back, twice) [{card}]: kernel == twin on "
        f"every shard, the passes agree; {total:.4f} ms for the {S} "
        f"(median of 5, {total / S:.4f} ms a launch), plain twin "
        f"{plain_ms:.1f} ms, {probes} probes, {nbytes} bytes (bound "
        f"{bound:.6f} ms)")
    return dict(ms=total, ms_per_launch=total / S, plain_ms=plain_ms,
                bound_ms=bound, probes=probes, bytes=nbytes,
                max_abs_err=err)


def mesh_ckpt_phase(torch, fp, cfg1, a, card):
    """21d: a sharded checkpoint of config #1 at D = 2, written on the
    card mid-run; resumed on the card (the uninterrupted stats), on the
    CPU by the port (== the card to a shallower depth), and its
    portable image onto D = 4 and the classic engine (the reference's
    engines' counts from the same image at depth 16)."""
    from raft_tla_tpu_torch.engine.bfs import Engine
    from raft_tla_tpu_torch.parallel.mesh import ShardedEngine
    from raft_tla_tpu_torch.resil.portable import load_portable_image
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    kw = dict(MESH_ENGINE, store_states=False)
    try:
        path = os.path.join(tmp, "mesh2.ckpt")
        t0 = time.perf_counter()
        w = mesh_run(torch, fp, cfg1, 2, kw, max_depth=MESH_CKPT_DEPTH,
                     checkpoint_path=path, checkpoint_every=MESH_CKPT_DEPTH)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(path)
        r = mesh_run(torch, fp, cfg1, 2, kw, resume_from=path,
                     max_states=CONFIG1_MAX_STATES)
        full = a[2]
        check((r["res"].distinct_states, r["res"].depth) ==
              (full["distinct"], CONFIG1_DEPTH) and
              r["res"].level_sizes == CONFIG1_LEVEL_SIZES,
              f"21d: the card's resume {r['res'].distinct_states}")

        def stats(res):
            return (res.distinct_states, res.generated_states, res.depth,
                    res.level_sizes, res.violations_global)
        card14 = mesh_run(torch, fp, cfg1, 2, kw,
                          max_depth=MESH_CPU_DEPTH)["res"]
        t1 = time.perf_counter()
        cpu = ShardedEngine(cfg1, devices=["cpu"] * 2, **kw).check(
            resume_from=path, max_depth=MESH_CPU_DEPTH)
        t_cpu = time.perf_counter() - t1
        check(stats(cpu) == stats(card14),
              f"21d: the CPU's resume {stats(cpu)[:3]} != the card's "
              f"{stats(card14)[:3]}")
        img = load_portable_image(path)
        r4 = mesh_run(torch, fp, cfg1, 4, kw, resume_image=img,
                      max_depth=16)
        rc = Engine(cfg1, device="cuda", store_states=False,
                    **dict(CONFIG1_ENGINE)).check(resume_image=img,
                                                  max_depth=16)
        mesh16 = CONFIG1_DEPTH16_COUNTS + (16,
                                           CONFIG1_MESH_LEVEL_SIZES[:16])
        for nm, res, want in (("D=4", r4["res"], mesh16),
                              ("classic", rc, MESH_IMAGE_CLASSIC)):
            check(stats(res)[:4] == tuple(want),
                  f"21d: portable onto {nm}: {stats(res)[:3]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 21d sharded checkpoint [{card}]: config #1 at D=2 "
        f"written at depth {MESH_CKPT_DEPTH} ({size} bytes, run + write "
        f"{t_write:.2f} s); resumed on the card to depth "
        f"{r['res'].depth} == the uninterrupted run "
        f"({r['res'].distinct_states}); resumed on the CPU to depth "
        f"{MESH_CPU_DEPTH} == the card ({cpu.distinct_states} states, "
        f"{t_cpu:.1f} s); its portable image to depth 16 == the "
        f"reference's engines': on 4 shards {CONFIG1_DEPTH16_COUNTS}, on "
        f"the classic engine {MESH_IMAGE_CLASSIC[:2]}")
    return dict(bytes=size, write_s=t_write, cpu_s=t_cpu,
                resume_launches=r["launches"])


def mesh_fleet_phase(torch, here, card):
    """21e: phase 13a's hunt (the CLI's solo run) against a two-cohort
    ShardedSimEngine of the same width and seed on the card: the solo
    hit and its decoded trace among the fleet's; a hit-free fleet's
    stats == SimEngine's."""
    from raft_tla_tpu_torch.parallel.sim_mesh import ShardedSimEngine
    from raft_tla_tpu_torch.sim import SimEngine
    argv = [os.path.join(here, a) if a.endswith(".cfg") else a
            for a in SIM_CMD]
    rc, out, err, seen = cli_run(argv + ["--device", "cuda"], SimEngine,
                                 "run")
    check(rc == 0, f"21e: simulate exit code {rc}: {err[-300:]}")
    (solo, rs), = seen
    t0 = time.perf_counter()
    fleet = ShardedSimEngine(
        solo.cfg, walkers=solo.W, devices=["cuda:0"] * MESH_FLEET_COHORTS,
        max_depth=solo.budget, seed=solo.seed, policy=solo.policy,
        bloom_bits=solo.bloom_bits)
    rf = fleet.run(steps=30000)
    t_fleet = time.perf_counter() - t0
    # a single engine stops every walker at the first hit; a cohort
    # without it finishes its dispatch (the reference fleet's rule), so
    # the solo run's hit is among the fleet's
    check(rf.hits and rs.hits, "21e: no MembershipChangeCommits hit")
    hs = solo.decode_hit(rs.hits[0])
    hf = [fleet.decode_hit(h) for h in rf.hits
          if (h.walker, h.depth) == (hs.walker, hs.depth)]
    check(len(hf) == 1 and hf[0].lanes == hs.lanes and
          (hs.walker, hs.depth) == (SIM_WALKER, SIM_DEPTH) and
          [l for l, _ in hf[0].trace] == [l for l, _ in hs.trace],
          f"21e: fleet hits {[(h.walker, h.depth) for h in rf.hits]}, "
          f"solo {(hs.walker, hs.depth)}")
    hf = hf[0]
    free = _fleet_cfg(here)
    fkw = dict(SIM_FLEET, walkers=SIM_NARROW)
    ff = ShardedSimEngine(free, devices=["cuda:0"] * MESH_FLEET_COHORTS,
                          **fkw).run(steps=MESH_FREE_STEPS)
    fs = SimEngine(free, device="cuda", **fkw).run(steps=MESH_FREE_STEPS)
    keys = ("steps_dispatched", "walker_steps", "sampled_steps",
            "restarts", "deadlocks", "promotions", "bloom_bits_set")
    check(all(getattr(ff, k) == getattr(fs, k) for k in keys),
          f"21e: hit-free fleet {[getattr(ff, k) for k in keys]} != "
          f"solo {[getattr(fs, k) for k in keys]}")
    log(f"phase 21e walker fleet [{card}]: {MESH_FLEET_COHORTS} cohorts "
        f"on the card, SimEngine at {solo.W} walkers: the hunt's hit "
        f"(walker {hf.walker}, depth {hf.depth}) and decoded trace "
        f"among the fleet's {len(rf.hits)} hit(s); steps fleet "
        f"{rf.steps_dispatched} / solo {rs.steps_dispatched}, "
        f"walker-steps {rf.walker_steps} / {rs.walker_steps} (a cohort "
        f"without the hit ends its dispatch); fleet {t_fleet:.2f} s; the "
        f"hit-free fleet's stats == SimEngine's over {MESH_FREE_STEPS} "
        f"steps")
    return dict(fleet_s=t_fleet, fleet_hits=len(rf.hits),
                fleet_steps=rf.steps_dispatched,
                solo_steps=rs.steps_dispatched,
                fleet_walker_steps=rf.walker_steps,
                solo_walker_steps=rs.walker_steps)


def mesh_phase(torch, fp, cvt, home_slots, here, card):
    """Phase 21: the sharded engine and the walker fleet on the card."""
    from raft_tla_tpu_torch.cfg.parser import load_model
    from raft_tla_tpu_torch.config import Bounds
    t0 = time.perf_counter()
    cfg1 = load_model(os.path.join(here, "configs/tlc_membership/raft.cfg"),
                      bounds=Bounds.make(**CONFIG1_BOUNDS))
    a = mesh_config1_phase(torch, fp, cfg1, card)
    b = mesh_witness_phase(torch, fp, card)
    c = mesh_kernel_phase(torch, fp, cvt, home_slots, card)
    d = mesh_ckpt_phase(torch, fp, cfg1, a, card)
    e = mesh_fleet_phase(torch, here, card)
    wall = time.perf_counter() - t0
    log(f"phase 21 [{card}]: {wall:.1f} s")
    return dict(config1=a, witness=b, kernel=c, ckpt=d, fleet=e, wall=wall)


def spill_mesh_run(torch, fp, cfg, D, kw, **check_kw):
    """``SpilledShardedEngine(cfg, devices=["cuda:0"] * D).check`` with
    the kernel's launch counter zeroed just before and read just after:
    one launch a shard a lock-step step (tripped steps included) plus
    the rehashes'."""
    from raft_tla_tpu_torch.parallel.spill_mesh import SpilledShardedEngine
    eng = SpilledShardedEngine(cfg, devices=["cuda:0"] * D, **kw)
    torch.cuda.synchronize()
    ctr = fp.PROBE_CLAIM_LAUNCHES
    ctr.reset()
    t0 = time.perf_counter()
    res = eng.check(**check_kw)
    wall = time.perf_counter() - t0
    launches = ctr.count
    ctr.reset()
    check(launches > 0, f"22 D={D}: the spill mesh never launched the kernel")
    check(launches == D * eng.lockstep_steps + eng.rehash_launches,
          f"22 D={D}: {launches} launches != {D} x {eng.lockstep_steps} "
          f"steps + {eng.rehash_launches} rehash launches")
    check(eng.replays > 0 and eng.flag_reads == eng.lockstep_steps,
          f"22 D={D}: replays {eng.replays}, flag reads {eng.flag_reads}")
    return dict(eng=eng, res=res, wall=wall, launches=launches,
                steps=eng.lockstep_steps, trips=eng.trips,
                mid=eng.mid_level_spills, spills=eng.spill_events,
                rehash_launches=eng.rehash_launches,
                bytes_down=eng.bytes_down, bytes_up=eng.bytes_up,
                captures=eng.captures, replays=eng.replays,
                caps=(eng.LB, eng.FC, eng.SC, eng.VB))


def _sm_summary(r):
    res = r["res"]
    return (f"{res.distinct_states} distinct, {res.generated_states} "
            f"generated, depth {res.depth}; wall {r['wall']:.2f} s; "
            f"{r['steps']} lock-step steps ({r['trips']} tripped and "
            f"replayed), {r['mid']} mid-level spills, {r['spills']} spill "
            f"events; probe_claim_insert launches {r['launches']} = "
            f"{r['eng'].D} x {r['steps']} + {r['rehash_launches']} "
            f"(rehash); host bytes down {r['bytes_down']}, up "
            f"{r['bytes_up']}; graphs captured {r['captures']}, replayed "
            f"{r['replays']}; LB {r['caps'][0]}, FC {r['caps'][1]}, SC "
            f"{r['caps'][2]}, VB {r['caps'][3]}")


def _sm_row(r):
    return {k: r[k] for k in ("wall", "launches", "steps", "trips", "mid",
                              "spills", "rehash_launches", "bytes_down",
                              "bytes_up", "captures", "replays")}


def spill_mesh_config1_phase(torch, fp, cfg1, card):
    """22a: config #1 at D = 2 with lcap 2^21: levels spill at their ends
    only, the answer is phase 21a's.  22b: lcap 2^17 at D = 2 and 4: the
    widest levels spill mid-level, the answers are the reference's."""
    out = {}
    r = spill_mesh_run(torch, fp, cfg1, 2,
                       dict(SM_ENGINE, lcap=SM_LEVEL_END_LCAP),
                       max_states=CONFIG1_MAX_STATES)
    res = r["res"]
    log(f"phase 22a config #1, level-end spills, 2 shards [{card}]: "
        + _sm_summary(r))
    check_answer("22a config #1 on the spill mesh", dict(res=res),
                 CONFIG1_DISTINCT, CONFIG1_DEPTH, CONFIG1_MESH_LEVEL_SIZES)
    check((res.generated_states, r["mid"], r["trips"]) ==
          (CONFIG1_MESH_GENERATED, 0, SM_LEVEL_END_TRIPS),
          f"22a: generated {res.generated_states}, mid-level spills "
          f"{r['mid']}, trips {r['trips']}")
    out["level_end_d2"] = _sm_row(r)
    for D, pin in SM_PINS.items():
        r = spill_mesh_run(torch, fp, cfg1, D,
                           dict(SM_ENGINE, lcap=SM_SQUEEZED_LCAP),
                           max_states=CONFIG1_MAX_STATES)
        res = r["res"]
        log(f"phase 22b config #1, mid-level spills, {D} shards [{card}]: "
            + _sm_summary(r))
        want = CONFIG1_MESH_LEVEL_SIZES[:-2] + pin["tail"]
        check(res.distinct_states == pin["distinct"] and
              res.generated_states == pin["generated"] and
              res.depth == CONFIG1_DEPTH and res.level_sizes == want,
              f"22b D={D}: {res.distinct_states} / {res.generated_states} "
              f"/ depth {res.depth}, level sizes {res.level_sizes}")
        check((r["mid"], r["trips"], r["caps"]) ==
              (pin["mid"], pin["trips"], pin["caps"]),
              f"22b D={D}: mid-level spills {r['mid']}, trips {r['trips']},"
              f" caps {r['caps']}")
        out[f"squeezed_d{D}"] = _sm_row(r)
    return out


def spill_mesh_witness_phase(torch, fp, card):
    """22c: the FirstCommit witness on the spill mesh at D = 2 and 4 with
    the archive on disk and levels spilled mid-level: the reference's
    gids and trace, walked from the memmaps and replayed by the
    oracle."""
    from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
    from raft_tla_tpu_torch.models.explore import oracle_validates_walk
    micro = ModelConfig(
        n_servers=2, init_servers=(0, 1), values=(1,),
        next_family=NEXT_ASYNC, symmetry=False, max_inflight_override=2,
        constraints=("BoundedInFlightMessages", "BoundedRequestVote",
                     "BoundedLogSize", "BoundedTerms"),
        invariants=("FirstCommit",),
        bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                           max_client_requests=1))
    out = {}
    for D, pin in SM_MICRO_PINS.items():
        tmp = tempfile.mkdtemp(prefix="chip_smoke_sm_")
        try:
            r = spill_mesh_run(torch, fp, micro, D,
                               dict(SM_MICRO_ENGINE[D], store_states=True,
                                    archive_dir=tmp),
                               stop_on_violation=True)
            res, eng = r["res"], r["eng"]
            gids = [v.state_id for v in res.violations]
            trace = eng.trace(gids[0])
            check(eng._arch is not None and eng._arch.n_levels == res.depth + 1,
                  f"22c D={D}: the archive is not on disk")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        labels = [lbl for lbl, _ in trace]
        check(gids == pin["gids"] and r["mid"] == pin["mid"] and
              res.distinct_states == SM_MICRO_DISTINCT and
              labels == SM_MICRO_TRACE,
              f"22c D={D}: gids {gids}, mid-level spills {r['mid']}, "
              f"{res.distinct_states} states, trace {labels}")
        walk = oracle_validates_walk(micro, [sv for _l, sv in trace])
        check(len(walk) == len(SM_MICRO_TRACE) - 1,
              f"22c D={D}: the oracle did not replay the witness")
        out[D] = dict(gids=gids, launches=r["launches"], wall=r["wall"],
                      mid=r["mid"], trips=r["trips"])
    log(f"phase 22c FirstCommit witness on the spill mesh [{card}]: the "
        f"reference's gids {({D: o['gids'] for D, o in out.items()})} and "
        f"{len(SM_MICRO_TRACE) - 1}-step trace at D = 2 and 4, walked from "
        f"the disk archive after {out[2]['mid']} / {out[4]['mid']} "
        f"mid-level spills, replayed by the oracle")
    return out


def _sm_file(path):
    """A spill-mesh checkpoint's pinned features (SM_CKPT_FILE's keys)."""
    import numpy as np
    z = np.load(path)
    meta = json.loads(str(z["meta"]))
    h = hashlib.sha256()
    for k in sorted(z.files):
        if k.startswith("carry|pf"):
            h.update(k.encode())
            h.update(np.ascontiguousarray(z[k]).tobytes())
    keys = z["carry|keys"]
    keys = keys[np.lexsort(keys.T[::-1])]
    out = dict(n_front=meta["n_front"], n_keys=int(keys.shape[0]),
               n_vis=meta["n_vis"],
               caps=(meta["LB"], meta["VB"], meta["FC"], meta["SC"]),
               fam_caps=meta["fam_caps"], pf_sha256=h.hexdigest(),
               keys_sha256=hashlib.sha256(
                   np.ascontiguousarray(keys).tobytes()).hexdigest())
    z.close()
    return out


def _counts(res):
    return (res.distinct_states, res.generated_states, res.depth,
            list(res.level_sizes))


def spill_mesh_ckpt_phase(torch, fp, cfg1, card):
    """22e: 22b's D = 2 run with a checkpoint at every level to depth 12;
    the file against the reference's; its resumes on the card, on the
    CPU and, as a portable image, on 4 mesh shards, the spill engine and
    the classic engine; a supervised run with a dispatch fault."""
    from raft_tla_tpu_torch.engine.bfs import Engine
    from raft_tla_tpu_torch.engine.ckpt import CheckpointError
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    from raft_tla_tpu_torch.parallel.spill_mesh import SpilledShardedEngine
    from raft_tla_tpu_torch.resil import chaos
    from raft_tla_tpu_torch.resil.portable import load_portable_image
    from raft_tla_tpu_torch.resil.supervisor import supervised_check
    kw = dict(SM_ENGINE, lcap=SM_SQUEEZED_LCAP)
    pin = SM_PINS[2]
    want = (pin["distinct"], pin["generated"], CONFIG1_DEPTH,
            CONFIG1_MESH_LEVEL_SIZES[:-2] + pin["tail"])
    saves = []
    save = SpilledShardedEngine._save_spill_mesh_checkpoint

    def timed_save(self, path, *rest):
        t = time.perf_counter()
        save(self, path, *rest)
        saves.append((rest[2], time.perf_counter() - t,
                      os.path.getsize(path)))
    SpilledShardedEngine._save_spill_mesh_checkpoint = timed_save
    tmp = tempfile.mkdtemp(prefix="chip_smoke_smckpt_")
    try:
        path = os.path.join(tmp, "sm2.ckpt")
        w = spill_mesh_run(torch, fp, cfg1, 2, kw, max_depth=SM_CKPT_DEPTH,
                           checkpoint_path=path, checkpoint_every=1)
        check(w["res"].depth == SM_CKPT_DEPTH and
              [d for d, _s, _b in saves] == [SM_CKPT_DEPTH],
              f"22e: saves at depths {[d for d, _s, _b in saves]}")
        got = _sm_file(path)
        check(got == SM_CKPT_FILE,
              f"22e: the file {got} is not the reference's "
              f"{SM_CKPT_FILE}")
        write = saves[-1]
        # (i) on the card to the budget
        r = spill_mesh_run(torch, fp, cfg1, 2, kw, resume_from=path,
                           max_states=CONFIG1_MAX_STATES)
        check(_counts(r["res"]) == want and r["mid"] == pin["mid"] and
              r["caps"] == pin["caps"],
              f"22e: the card's resume {_counts(r['res'])[:3]}, mid-level "
              f"spills {r['mid']}, caps {r['caps']}")
        # (ii) on the CPU to depth 14, against the card's
        card14 = spill_mesh_run(torch, fp, cfg1, 2, kw, resume_from=path,
                                max_depth=SM_CKPT_CPU_DEPTH)
        t1 = time.perf_counter()
        cpu = SpilledShardedEngine(cfg1, devices=["cpu"] * 2, **kw).check(
            resume_from=path, max_depth=SM_CKPT_CPU_DEPTH)
        t_cpu = time.perf_counter() - t1
        check(_counts(cpu) == _counts(card14["res"]) and
              cpu.level_sizes == want[3][:SM_CKPT_CPU_DEPTH],
              f"22e: the CPU's resume {_counts(cpu)[:3]} != the card's "
              f"{_counts(card14['res'])[:3]}")
        # (iii) the portable image
        img = load_portable_image(path)
        r4 = mesh_run(torch, fp, cfg1, 4, dict(MESH_ENGINE,
                                                store_states=False),
                      resume_image=img, max_depth=SM_IMAGE_DEPTH)
        ctr = fp.PROBE_CLAIM_LAUNCHES
        ctr.reset()
        t1 = time.perf_counter()
        sp = SpillEngine(cfg1, device="cuda", **SM_IMAGE_SPILL).check(
            resume_image=img, max_depth=SM_IMAGE_DEPTH)
        t_spill = time.perf_counter() - t1
        spill_launches = ctr.count
        ctr.reset()
        mesh16 = CONFIG1_DEPTH16_COUNTS + (
            SM_IMAGE_DEPTH, CONFIG1_MESH_LEVEL_SIZES[:SM_IMAGE_DEPTH])
        for nm, res, pinned in (("4 mesh shards", r4["res"], mesh16),
                                ("the spill engine", sp,
                                 MESH_IMAGE_CLASSIC)):
            check(tuple(_counts(res)) == tuple(pinned),
                  f"22e: the image on {nm}: {_counts(res)[:3]}")
        check(spill_launches > 0, "22e: the spill engine never launched "
                                  "the kernel")
        refused = ""
        try:
            Engine(cfg1, device="cuda", store_states=False,
                   **CONFIG1_ENGINE).check(resume_image=img,
                                           max_depth=SM_IMAGE_DEPTH)
        except CheckpointError as e:
            refused = str(e)
        check(SM_IMAGE_REFUSAL in refused,
              f"22e: the classic engine took the image ({refused!r})")
        # (iv) supervised, a fault at a level's dispatch, from the chain
        eng = SpilledShardedEngine(cfg1, devices=["cuda:0"] * 2, **kw)
        before = []

        def make_engine():
            # the failed attempt's steps, before check() resets them
            before.append((eng.lockstep_steps, eng.rehash_launches))
            return eng
        torch.cuda.synchronize()
        ctr.reset()
        chaos.install(SM_CHAOS)
        t1 = time.perf_counter()
        try:
            sres, _e, attempts = supervised_check(
                make_engine, retries=1, backoff=0.01,
                checkpoint_path=os.path.join(tmp, "chaos.ckpt"),
                checkpoint_every=1, max_states=CONFIG1_MAX_STATES,
                sleep=lambda s: None, reinit=False)
        finally:
            chaos.uninstall()
        t_sup = time.perf_counter() - t1
        sup_launches = ctr.count
        ctr.reset()
        steps = sum(b[0] for b in before) + eng.lockstep_steps
        rehash = sum(b[1] for b in before) + eng.rehash_launches
        check(attempts == 2 and _counts(sres) == want,
              f"22e: supervised {attempts} attempts, {_counts(sres)[:3]}")
        check(sup_launches == 2 * steps + rehash,
              f"22e: supervised launches {sup_launches} != 2 x {steps} "
              f"steps + {rehash}")
    finally:
        SpilledShardedEngine._save_spill_mesh_checkpoint = save
        shutil.rmtree(tmp, ignore_errors=True)
    sup_saves = saves[1:]
    log(f"phase 22e spill-mesh checkpoint [{card}]: config #1 at D=2, lcap "
        f"2^17, written at depth {SM_CKPT_DEPTH} after the burst: "
        f"{write[2]} bytes in {write[1]:.3f} s (run + write "
        f"{w['wall']:.2f} s); frontier, keys and capacities == the "
        f"reference's file")
    log(f"phase 22e resumes [{card}]: on the card to depth "
        f"{r['res'].depth} in {r['wall']:.2f} s == 22b "
        f"({r['res'].distinct_states} states, {r['mid']} mid-level spills, "
        f"{r['launches']} launches = 2 x {r['steps']} steps + "
        f"{r['rehash_launches']}); on the card to depth "
        f"{SM_CKPT_CPU_DEPTH} in {card14['wall']:.2f} s, on the CPU in "
        f"{t_cpu:.2f} s, equal ({cpu.distinct_states} states); the image "
        f"to depth {SM_IMAGE_DEPTH} on 4 mesh shards in {r4['wall']:.2f} s "
        f"({r4['launches']} launches) and on the spill engine in "
        f"{t_spill:.2f} s ({spill_launches} launches) == the reference's "
        f"engines'; the classic engine refuses it")
    log(f"phase 22e supervised [{card}]: {SM_CHAOS}, {attempts} attempts in "
        f"{t_sup:.2f} s == 22b; {len(sup_saves)} saves, the largest "
        f"{max(b for _d, _s, b in sup_saves)} bytes in "
        f"{max(s for _d, s, _b in sup_saves):.3f} s, "
        f"{sum(s for _d, s, _b in sup_saves):.2f} s in all; launches "
        f"{sup_launches} = 2 x {steps} steps + {rehash}")
    return dict(file_bytes=write[2], write_s=write[1], run_write_s=w["wall"],
                write_launches=w["launches"],
                resume=_sm_row(r), resume14_s=card14["wall"],
                resume14_launches=card14["launches"], cpu_resume14_s=t_cpu,
                image_mesh4_s=r4["wall"], image_mesh4_launches=r4["launches"],
                image_spill_s=t_spill, image_spill_launches=spill_launches,
                supervised_s=t_sup, supervised_launches=sup_launches,
                supervised_steps=steps, supervised_attempts=attempts,
                supervised_saves=[[d, s, b] for d, s, b in sup_saves])


def spill_mesh_phase(torch, fp, cvt, home_slots, here, card):
    """Phase 22: the spill-composed mesh on the card."""
    from raft_tla_tpu_torch.cfg.parser import load_model
    from raft_tla_tpu_torch.config import Bounds
    t0 = time.perf_counter()
    cfg1 = load_model(os.path.join(here, "configs/tlc_membership/raft.cfg"),
                      bounds=Bounds.make(**CONFIG1_BOUNDS))
    a = spill_mesh_config1_phase(torch, fp, cfg1, card)
    c = spill_mesh_witness_phase(torch, fp, card)
    # 22d: the launches were held in every run above; the kernel at the
    # 2-shard table shards' shapes (21c holds the 4-shard ones)
    d = mesh_kernel_phase(torch, fp, cvt, home_slots, card,
                          fixture=SM_FIXTURE, tag="22d")
    e = spill_mesh_ckpt_phase(torch, fp, cfg1, card)
    wall = time.perf_counter() - t0
    log(f"phase 22 [{card}]: {wall:.1f} s")
    return dict(config1=a, witness=c, kernel=d, ckpt=e, wall=wall)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--phase", "15"], ["--phase", "16"],
                    ["--phase", "17"], ["--phase", "18"],
                    ["--phase", "19"], ["--phase", "20"],
                    ["--phase", "21"], ["--phase", "22"]):
        print("usage: python3 chip_smoke.py "
              "[--phase 15|16|17|18|19|20|21|22]", file=sys.stderr)
        return 2
    only = argv[1] if argv else None
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from raft_tla_tpu_torch.cfg.parser import load_model
        from raft_tla_tpu_torch.config import (Bounds, ModelConfig,
                                               NEXT_ASYNC, NEXT_DYNAMIC)
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
    t_start = time.perf_counter()

    # phase 1
    card = card_line()
    log(card)
    # phase 2
    t0 = time.perf_counter()
    cuda_ext.build(verbose=True)            # prints ptxas's resource use
    cuda_ext.library()
    log(f"phase 2 build and load: {time.perf_counter() - t0:.1f} s")
    if only:
        # phases 1, 2 and one of 15-19 alone: no result line
        if only == "15":
            got = {"paxos": paxos_phase(torch, fp, cvt, home_slots, card)}
        elif only == "18":
            got = {"serving": serving_phase(torch, fp, cvt, home_slots,
                                            here, card)}
        elif only == "19":
            got = {"config4": config4_phase(torch, fp, here, card)}
        elif only == "20":
            got = {"serve": daemon_phase(torch, fp, here, card)}
        elif only == "21":
            got = {"mesh": mesh_phase(torch, fp, cvt, home_slots, here,
                                      card)}
        elif only == "22":
            got = {"spill_mesh": spill_mesh_phase(torch, fp, cvt,
                                                  home_slots, here, card)}
        elif only == "17":
            # fixture (h) gives the kernel's eager time and bound at the
            # spill engine's shapes
            h = kernel_phase(torch, fp, cvt, home_slots, card,
                             fixtures="h")
            got = {"obs17": spill_sim_obs_phase(
                torch, fp, here, card, h["spill_ms"],
                h["spill_bound_ms"])}
        else:
            # fixture (d) gives the kernel's eager time and bound
            d = kernel_phase(torch, fp, cvt, home_slots, card,
                             fixtures="d")
            got = {"obs": obs_phase(torch, fp, card, d["ms"],
                                    d["bound_ms"])}
        check(not any(m.split(".")[0] in ("jax", "raft_tla_tpu")
                      for m in sys.modules),
              "JAX or its package was imported")
        log(json.dumps(got))
        log(f"chip_smoke --phase {only}: passed in "
            f"{time.perf_counter() - t_start:.1f} s (no result line)")
        return 0
    # phase 3, with 64-bit keys and then with fp128's 4-word keys
    meas = kernel_phase(torch, fp, cvt, home_slots, card)
    meas4 = kernel_phase(torch, fp, cvt, home_slots, card, W=4,
                         fixtures="bcdg")
    # phase 4: the main path, config #1, incremental fingerprints
    cfg1 = load_model(os.path.join(here, "configs/tlc_membership/raft.cfg"),
                      bounds=Bounds.make(**CONFIG1_BOUNDS))
    c1 = run_path(torch, fp, Engine, cfg1, CONFIG1_ENGINE,
                  CONFIG1_MAX_STATES, store_states=True)
    check(c1["incremental"], "config #1 did not run incremental")
    check(c1["eng"].guard_matmul and c1["eng"].expander.delta_active,
          "config #1 did not run the default expansion")
    report("phase 4 config #1 (incremental fingerprints)", c1, card)
    check_answer("config #1", c1, CONFIG1_DISTINCT, CONFIG1_DEPTH,
                 CONFIG1_LEVEL_SIZES)
    # the last state's trace through the in-RAM archive, for phase 12
    c1_trace = c1.pop("eng").trace(CONFIG1_DISTINCT - 1)
    c1d = run_path(torch, fp, Engine, cfg1,
                   dict(CONFIG1_ENGINE, incremental_fp=False),
                   CONFIG1_MAX_STATES)
    check(not c1d["incremental"], "config #1 direct ran incremental")
    report("phase 4 config #1 (direct fingerprints)", c1d, card)
    check_answer("config #1 direct", c1d, CONFIG1_DISTINCT, CONFIG1_DEPTH,
                 CONFIG1_LEVEL_SIZES)
    c1p = run_path(torch, fp, Engine, cfg1,
                   dict(CONFIG1_ENGINE, guard_matmul=False,
                        delta_matmul=False), CONFIG1_MAX_STATES)
    check(not c1p["eng"].expander.delta_active,
          "config #1 plain expansion ran the delta group")
    report("phase 4 config #1 (plain expansion, incremental)", c1p, card)
    check_answer("config #1 plain expansion", c1p, CONFIG1_DISTINCT,
                 CONFIG1_DEPTH, CONFIG1_LEVEL_SIZES)
    log(f"phase 4 config #1 [{card}]: wall incremental {c1['wall']:.2f} s, "
        f"direct {c1d['wall']:.2f} s, plain expansion {c1p['wall']:.2f} s")
    # phase 5: config #5, the orbit-sort canonicalizer
    cfg5 = load_model(os.path.join(here, "configs/tlc_membership/raft.cfg"),
                      bounds=Bounds.make(**CONFIG5_BOUNDS))
    cfg5 = cfg5.with_(**CONFIG5_SHAPE)
    c5 = run_path(torch, fp, Engine, cfg5, CONFIG5_ENGINE,
                  CONFIG5_MAX_STATES)
    check(c5["sym_canon"] == 1, "config #5 did not resolve to sort")
    report("phase 5 config #5 (orbit-sort)", c5, card)
    res5 = c5["res"]
    log(f"phase 5 config #5 [{card}]: hard-lane fallback in "
        f"{res5.hard_chunks} chunks, {res5.hard_lanes} hard lanes, at most "
        f"{res5.hard_chunk_max} in a chunk (HCAP {c5['eng'].HCAP})")
    check_answer("config #5", c5, CONFIG5_DISTINCT, CONFIG5_DEPTH,
                 CONFIG5_LEVEL_SIZES)
    # phase 6: a witness trace on the micro config, card vs CPU
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
    log(f"phase 6 FirstCommit witness: {len(MICRO_TRACE) - 1} steps, "
        "card == CPU == reference")
    # phase 7: the expansion's card-only paths
    t7 = expansion_phase(torch, Engine, cfg1, card)
    # phase 8: the captured chunk step against the eager one
    t8 = graph_phase(torch, fp, Engine, cfg1, card)
    # phase 9: config #1 with 128-bit fingerprints (4-word dedup keys)
    c1w = run_path(torch, fp, Engine, cfg1.with_(fp128=True),
                   CONFIG1_ENGINE, CONFIG1_MAX_STATES)
    check(c1w["eng"].W == 4, f"fp128 ran {c1w['eng'].W}-word keys")
    report("phase 9 config #1 (fp128, 4-word keys)", c1w, card)
    check_answer("config #1 fp128", c1w, CONFIG1_DISTINCT, CONFIG1_DEPTH,
                 CONFIG1_LEVEL_SIZES)
    # phase 10: the punctuated search, from the cfg and from a seed file
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t10 = pinned_phase(torch, fp, here, tmp, card)
        t10b = seed_phase(torch, fp, here, tmp, card)
        # phase 12 (b) needs phase 10a's cfg and uninterrupted CPU run
        t12b = pinned_resume_phase(torch, fp, t10, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # phase 11: BASELINE config #3, the membership workload
    cfg3 = load_model(os.path.join(here, "configs/tlc_membership/raft.cfg"),
                      bounds=Bounds.make(**CONFIG3_BOUNDS))
    cfg3 = cfg3.with_(n_servers=4, init_servers=(0, 1, 2),
                      next_family=NEXT_DYNAMIC,
                      invariants=tuple(cfg3.invariants) +
                      ("OneAtATimeMembershipChangeOK",))
    c3 = run_path(torch, fp, Engine, cfg3, CONFIG3_ENGINE,
                  CONFIG3_MAX_STATES)
    report("phase 11 config #3 (NextDynamic, Server=4, InitServer=3)", c3,
           card)
    check_answer("config #3", c3, CONFIG3_DISTINCT, CONFIG3_DEPTH,
                 CONFIG3_LEVEL_SIZES)
    check(c3["eng"].LCAP == CONFIG3_ENGINE["lcap"],
          f"config #3 replayed a level for LCAP ({c3['eng'].LCAP})")
    log(f"phase 11 config #3 [{card}]: LCAP stayed 2^22; FCAP "
        f"{c3['eng'].FCAP}, OCAP {c3['eng'].OCAP}, VCAP {c3['eng'].VCAP}")
    # phase 12: checkpoints, resume, the disk archive and a supervised
    # retry on config #1 (b ran beside phase 10)
    t12 = supervised_phase(torch, fp, Engine, cfg1, card, c1_trace)
    # phase 13: the random-walk simulator
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t13 = sim_hunt_phase(torch, fp, here, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t13c = sim_fleet_phase(torch, here, card)
    t13d = sim_graph_phase(torch, card)
    # phase 14: the host-spill engine, the host table, portable resume
    tmp = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    try:
        t14 = spill_phase(torch, fp, here, tmp, card)
        t14b = host_table_phase(torch, fp, here, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # phase 15: the paxos tenant
    t15 = paxos_phase(torch, fp, cvt, home_slots, card)
    # phase 16: the observability bundle, the profiler's view
    t16 = obs_phase(torch, fp, card, meas["ms"], meas["bound_ms"])
    # phase 17: the bundle on the spill engine and the walker, cli obs
    t17 = spill_sim_obs_phase(torch, fp, here, card, meas["spill_ms"],
                              meas["spill_bound_ms"])
    # phase 18: batched serving, the dedup kernel once per job slot in
    # the captured job-axis step
    t18 = serving_phase(torch, fp, cvt, home_slots, here, card)
    # phase 19: BASELINE config #4 and the apalache divergence hunt
    t19 = config4_phase(torch, fp, here, card)
    # phase 20: the daemon over the wave scheduler, the executable cache,
    # a drain and a kill, each restarted
    t20 = daemon_phase(torch, fp, here, card)
    # phase 21: the sharded engine at D = 1, 2, 4 shards on the card and
    # the walker fleet
    t21 = mesh_phase(torch, fp, cvt, home_slots, here, card)
    # phase 22: the spill-composed mesh, levels through host RAM
    t22 = spill_mesh_phase(torch, fp, cvt, home_slots, here, card)
    check(not any(m.split(".")[0] in ("jax", "raft_tla_tpu")
                  for m in sys.modules), "JAX or its package was imported")
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"phase17": t17}))
    log(json.dumps({"phase18": t18, "phase19": t19}))
    log(json.dumps({"serve": t20}))
    log(json.dumps({"mesh": t21}))
    log(json.dumps({"spill_mesh": t22}))

    print(json.dumps({"kernels": [{
        "name": "probe_claim_insert", "route": "cuda",
        "source": "raft_tla_tpu_torch/csrc/probe_claim.cu",
        "replaces": "raft_tla_tpu/engine/fingerprint.py:1025",
        "launches": c5["launches"],
        "max_abs_err": max(meas["max_abs_err"],
                           t18["kernel"]["max_abs_err"],
                           t21["kernel"]["max_abs_err"],
                           t22["kernel"]["max_abs_err"]),
        "ms": meas["ms"], "plain_ms": meas["plain_ms"],
        "bound_ms": meas["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "rounds": meas["rounds"],
        "rehash_ms": meas["rehash_ms"],
        "rehash_plain_ms": meas["rehash_plain_ms"],
        "rehash_bound_ms": meas["rehash_bound_ms"],
        "rehash_rounds": meas["rehash_rounds"],
        "spill_shape_ms": meas["spill_ms"],
        "spill_shape_plain_ms": meas["spill_plain_ms"],
        "spill_shape_bound_ms": meas["spill_bound_ms"],
        "spill_shape_rounds": meas["spill_rounds"],
        "spill_shape_of": "phase 3h: VCAP 2^26 at 35%, M 131,072",
        "main_path_ms": t8["kernel_ms"],
        "main_path_ms_of": "config #1 to depth 16, eager chunk steps "
                          "(phase 8), CUDA events per launch",
        "main_path_launches": t8["steps"],
        "main_path_rounds_max": t8["rounds_max"],
        "main_path_rounds_mean": t8["rounds_mean"],
        "config1_launches": c1["launches"],
        "config1_direct_launches": c1d["launches"],
        "config1_plain_expansion_launches": c1p["launches"],
        "ms_w4": meas4["ms"], "plain_ms_w4": meas4["plain_ms"],
        "bound_ms_w4": meas4["bound_ms"], "rounds_w4": meas4["rounds"],
        "max_abs_err_w4": meas4["max_abs_err"],
        "config1_fp128_launches": c1w["launches"],
        "pinned_search_launches": t10["launches"],
        "seed_trace_launches": t10b["trace_launches"],
        "seeded_check_launches": t10b["check_launches"],
        "config3_launches": c3["launches"],
        "config1_supervised_launches": t12["launches"],
        "sim_seeded_check_launches": t13["check_launches"],
        "spill_launches": t14["launches"],
        "host_table_launches": t14b["launches"],
        "paxos_2inst_launches": t15["full"]["launches"],
        "paxos_sort5_launches": t15["sort"]["launches"],
        "paxos_trace_launches": t15["witness"]["trace"]["launches"],
        "paxos_shape_ms": t15["kernel"]["ms"],
        "paxos_shape_plain_ms": t15["kernel"]["plain_ms"],
        "paxos_shape_bound_ms": t15["kernel"]["bound_ms"],
        "paxos_shape_rounds": t15["kernel"]["rounds"],
        "paxos_shape_of": "phase 15d: 15a's VCAP and fill, M = its FCAP",
        "obs_sinks_launches": t16["sinks"]["launches"],
        "obs_profiled_launches": t16["profile"]["launches"],
        "obs_profiled_kernel_events": t16["profile"]["kernel_events"],
        "in_graph_launches": t16["profile"]["in_graph_events"],
        "in_graph_ms": t16["profile"]["in_graph_ms"],
        "in_graph_of": "phase 16b: config #1 to depth 16 under "
                       "torch.profiler, median device time of the kernel "
                       "events of graph replays",
        "spill_obs_launches": t17["spill_sinks"]["launches"],
        "sim_obs_captures": t17["sim"]["captures"],
        "spill_profiled_launches": t17["profile"]["launches"],
        "spill_profiled_kernel_events": t17["profile"]["kernel_events"],
        "spill_in_graph_launches": t17["profile"]["in_graph_events"],
        "spill_in_graph_ms": t17["profile"]["in_graph_ms"],
        "spill_in_graph_of": "phase 17d: config #2 on the spill engine "
                             "with the host table to depth 15 under "
                             "torch.profiler, median device time of the "
                             "kernel events of graph replays",
        "batch_launches": t18["sweep"]["launches"],
        "batch_launches_per_step": t18["sweep"]["launches_per_step"],
        "batch_shape_ms": t18["kernel"]["ms"],
        "batch_shape_ms_per_launch": t18["kernel"]["ms_per_launch"],
        "batch_shape_plain_ms": t18["kernel"]["plain_ms"],
        "batch_shape_bound_ms": t18["kernel"]["bound_ms"],
        "batch_shape_of": "phase 18d fixture (i): 8 tables of 2^15 at "
                          "35%, M 8,192 each, launched back to back",
        "config4_launches": t19["launches"],
        "serve_launches": t20["service"]["launches"],
        "serve_launches_batched": t20["service"]["launches_batched"],
        "serve_launches_solo": t20["service"]["launches_solo"],
        "serve_exec_cache_launches": t20["exec_cache"]["launches"],
        "mesh_config1_launches": {str(D): a["launches"]
                                  for D, a in t21["config1"].items()},
        "mesh_config1_lockstep_steps": {
            str(D): a["steps"] for D, a in t21["config1"].items()},
        "mesh_paxos_launches": t21["witness"]["paxos_launches"],
        "mesh_shape_ms": t21["kernel"]["ms"],
        "mesh_shape_ms_per_launch": t21["kernel"]["ms_per_launch"],
        "mesh_shape_plain_ms": t21["kernel"]["plain_ms"],
        "mesh_shape_bound_ms": t21["kernel"]["bound_ms"],
        "mesh_shape_max_abs_err": t21["kernel"]["max_abs_err"],
        "mesh_shape_of": "phase 21c: 4 table shards of 2^22 at config "
                         "#1's last-level load, windows of M 32,768, "
                         "launched back to back",
        "spill_mesh_config1_launches": {
            k: v["launches"] for k, v in t22["config1"].items()},
        "spill_mesh_config1_lockstep_steps": {
            k: v["steps"] for k, v in t22["config1"].items()},
        "spill_mesh_witness_launches": {
            str(D): w["launches"] for D, w in t22["witness"].items()},
        "spill_mesh_ckpt_launches": {
            k: t22["ckpt"][k] for k in (
                "write_launches", "resume14_launches",
                "image_mesh4_launches", "image_spill_launches",
                "supervised_launches")},
        "spill_mesh_ckpt_resume_launches": t22["ckpt"]["resume"][
            "launches"],
        "spill_mesh_shape_ms": t22["kernel"]["ms"],
        "spill_mesh_shape_ms_per_launch": t22["kernel"]["ms_per_launch"],
        "spill_mesh_shape_plain_ms": t22["kernel"]["plain_ms"],
        "spill_mesh_shape_bound_ms": t22["kernel"]["bound_ms"],
        "spill_mesh_shape_max_abs_err": t22["kernel"]["max_abs_err"],
        "spill_mesh_shape_of": "phase 22d: 2 table shards of 2^23 at "
                               "config #1's last-level load, windows of M "
                               "65,536, launched back to back"}],
        "mesh": t21,
        "spill_mesh": t22,
        "obs": t16,
        "paxos": t15,
        "spill": {"config2_depth20": t14, "host_table_depth19": t14b},
        "sim": {
            "hunt_wall_s": t13["wall"], "hunt_run_s": t13["run_s"],
            "hunt_walker_steps_per_sec": t13["walker_steps_per_sec"],
            "hunt_replays": t13["replays"],
            "oracle_replay_s": t13["oracle_s"],
            "seeded_check_walls_card_cpu_s": list(t13["check_walls"]),
            "fleet_walkers": SIM_FLEET["walkers"],
            "fleet_steps": SIM_FLEET_STEPS,
            "fleet_wall_s": t13c["wall"],
            "fleet_walker_steps": t13c["walker_steps"],
            "fleet_walker_steps_per_sec": t13c["walker_steps_per_sec"],
            "fleet_step_ms": t13c["step_ms"],
            "fleet_peak_bytes": t13c["peak_bytes"],
            "micro_wall_eager_graph_s": t13d["walls"]},
        "checkpoint": {
            "config1_saves_depth_bytes_s": t12["saves"],
            "config1_resume_s": t12["resume_s"],
            "config1_resume_depth": t12["resume_depth"],
            "config1_io_parts_s": t12["io_parts_s"],
            "config1_attempts": t12["attempts"],
            "config1_captures_after_resume": t12["captures_after_resume"],
            "config1_supervised_wall_s": t12["wall"],
            "config1_alloc_at_attempt_start": t12["alloc_at_attempt_start"],
            "tmp_free_bytes": t12["free_bytes"],
            "pinned": t12b},
        "graphs": {
            "config1_replays": c1["replays"],
            "config1_captures": c1["captures"],
            "config5_replays": c5["replays"],
            "config5_captures": c5["captures"],
            "config1_fp128_replays": c1w["replays"],
            "pinned_search_replays": t10["replays"],
            "config3_replays": c3["replays"],
            "depth16_steps": t8["steps"],
            "depth16_wall_eager_graph_graph_eager_s": t8["walls"]},
        "walls_s": {"config1": c1["wall"], "config1_direct": c1d["wall"],
                    "config1_plain_expansion": c1p["wall"],
                    "config5": c5["wall"], "config1_fp128": c1w["wall"],
                    "pinned_search_depth11": t10["wall"],
                    "pinned_search_cpu_depth8": t10["cpu_wall"],
                    "seed_trace_card": list(t10b["walls"]),
                    "seed_trace_cpu": list(t10b["cpu_walls"]),
                    "config3": c3["wall"],
                    "config1_supervised": t12["wall"]},
        "guard_product": {
            "call": "torch._int_mm", "shape": t7["int_mm_shape"],
            "int_mm_ms": t7["int_mm_ms"],
            "guards_T_matmul_ms": t7["guard_product_ms"],
            "guards_T_terms_ms": t7["guard_terms_ms"]},
        "materialize_ms": {
            "delta_group": t7["materialize_card_ms"],
            "kernels": t7["materialize_card_kernels_ms"]}}))
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
