"""Shared level-harvest/driver core (ROADMAP item 5).

The per-level host bookkeeping every engine driver runs — decode the
stats rows, accumulate counters into the ``CheckResult`` registry,
depth-gate all-pruned pseudo-levels, guard the int32 global-id space,
and decide checkpoint-crossing — lived in FIVE copies (the four
exhaustive engine drivers plus the batched-serve harvest).  One
telemetry drift (``levels_fused`` pseudo-level counting) needed three
review passes to fix everywhere; the MetricsRegistry killed the
counter-drift class but not the control-flow duplication.  This module
is the single copy: engines supply what genuinely differs per family —
how archive rows are stored, how violation rows decode out of their
array layout, and how per-device visited occupancy is tracked — as
callbacks, and everything else runs HERE.

The contract is bit-exactness: every existing engine differential
(counts, level sizes, gids, archives, traces, checkpoints) pins the
re-homed call sites against the oracle unchanged
(tests/test_driver.py adds the call-site routing reps).

Semantics notes, shared by every caller:

- **depth gate** — a level with ``n_lvl == 0`` AND ``n_gen == 0`` is
  an all-pruned pseudo-level: the frontier held only constraint-pruned
  rows, nothing was even generated, so the oracle (whose frontier
  excludes pruned rows) would not have run it — it advances no depth
  and appends no level size.  An all-duplicates level (``n_gen > 0``)
  DOES count.  ``levels_fused`` increments inside the same gate so
  ``levels_fused ≡ depth advanced`` in every engine and
  ``depth - levels_fused`` is exactly the per-level-driver level
  count.
- **id guard** — global state ids are device int32 (gids/lpar); fail
  loud rather than wrap when a run approaches 2^31 ids.
- **checkpoint crossing** — a fused burst jumps several levels per
  device call, so the burst checkpoint fires when ANY multiple of
  ``checkpoint_every`` was crossed by the jump (an exact-modulo test
  could step over every multiple); the per-level path keeps the plain
  modulo.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..utils import take_arrays as _take


def guard_id_space(n_states: int) -> None:
    """Fail loud before the int32 global-id space wraps."""
    if n_states >= 2 ** 31 - 1:
        raise RuntimeError(
            "state-id space exhausted (2^31 ids): run exceeds "
            "the engine's int32 global-id width")


def ckpt_due_after_burst(depth: int, depth_before: int,
                         checkpoint_every: int) -> bool:
    """True when the burst's multi-level depth jump crossed ANY
    multiple of ``checkpoint_every`` (the exact-modulo test could skip
    every checkpoint with checkpoint_every > 1)."""
    every = max(1, checkpoint_every)
    return depth // every > depth_before // every


def ckpt_due_at_level(depth: int, checkpoint_every: int) -> bool:
    """The per-level drivers' plain modulo test."""
    return depth % max(1, checkpoint_every) == 0


def gate_level_depth(res, depth: int, n_new: int, n_gen: int,
                     level_size: int) -> int:
    """Per-level depth gate (docstring above): returns the corrected
    depth, appending ``level_size`` to ``res.level_sizes`` only for a
    real level.  Callers pre-increment depth at level entry and assign
    the return value back."""
    if n_new == 0 and n_gen == 0:
        return depth - 1
    res.level_sizes.append(level_size)
    return depth


def harvest_fused_levels(
        res, nlev: int,
        stats_of: Callable[[int], Tuple[int, int, int, int, int]],
        depth: int, n_states: int, *,
        archive: Optional[Callable[[int, int], None]] = None,
        violations: Optional[Callable[[int, int, int], None]] = None,
        visited: Optional[Callable[[int, int], None]] = None,
        id_guard: bool = True) -> Tuple[int, int]:
    """THE fused-burst harvest loop (the five-copy dedup).

    ``stats_of(li)`` returns the level's
    ``(n_lvl, n_viol, faults, n_expand, n_gen)`` — mesh engines sum
    their per-device stats matrix inside it.  Per committed level the
    loop accumulates the result counters, calls ``archive(li, n_lvl)``
    (the callback owns its own store_states / empty-level policy),
    calls ``violations(li, n_lvl, gid_base)`` only when the level saw
    violations (``gid_base`` is the level's first global id — the
    PRE-increment n_states), applies the depth gate, advances
    ``n_states``, and finally calls ``visited(li, n_lvl)`` for
    per-engine occupancy/flush bookkeeping.  Returns the advanced
    ``(depth, n_states)``.

    ``id_guard=False`` preserves the batched-serve semantics exactly
    (per-job ids never approach 2^31; the solo engines guard after
    every harvest)."""
    for li in range(nlev):
        n_lvl, n_viol, faults, n_expand, n_gen = (
            int(x) for x in stats_of(li))
        res.distinct_states += n_lvl
        res.generated_states += n_gen
        res.overflow_faults += faults
        res.violations_global += n_viol
        if archive is not None:
            archive(li, n_lvl)
        if n_viol and violations is not None:
            # a None callback means "don't decode violation rows" —
            # violations_global above still counts them
            violations(li, n_lvl, n_states)
        if n_lvl == 0 and n_gen == 0:
            pass        # all-pruned pseudo-level: not a BFS level
        else:
            depth += 1
            res.levels_fused += 1
            res.level_sizes.append(n_expand)
        n_states += n_lvl
        if visited is not None:
            visited(li, n_lvl)
    if id_guard:
        guard_id_space(n_states)
    return depth, n_states


# ---------------------------------------------------------------------------
# shared row helpers for the single-chip burst layout ([..., L_MAX, KB]
# batch-last ring archives — engine/bfs._burst_core's out arrays).  The
# mesh engines keep their own per-device decodes in their callbacks;
# bfs, spill and the batched serve share these.
# ---------------------------------------------------------------------------

def burst_archive_slice(par_h, lane_h, st_h, li: int, n_lvl: int):
    """One burst level's (parents, lanes, states batch-major) archive
    rows, copied out of the ring stack (the stack buffer is reused by
    the next burst)."""
    return (par_h[li, :n_lvl].copy(), lane_h[li, :n_lvl].copy(),
            {k: np.moveaxis(v[..., li, :n_lvl], -1, 0).copy()
             for k, v in st_h.items()})


def burst_decode_violations(res, ir, lay, inv_names, inv_h, st_h,
                            li: int, n_lvl: int, gid_base: int) -> None:
    """Decode one burst level's violating rows out of the ring stack
    into ``res.violations`` (ids = gid_base + row)."""
    from .bfs import Violation
    rows = {k: np.moveaxis(v[..., li, :n_lvl], -1, 0)
            for k, v in st_h.items()}
    for j, nm in enumerate(inv_names):
        for s in np.nonzero(~inv_h[j, li, :n_lvl])[0]:
            vsv, vh = ir.decode(lay, _take(rows, int(s)))
            res.violations.append(
                Violation(nm, gid_base + int(s), state=vsv, hist=vh))
