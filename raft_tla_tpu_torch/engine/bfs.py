"""Level-synchronous BFS engine: TLC's worker loop on a CUDA device.

The frontier, the candidate expansion, the visited set (an
open-addressing hash table in device memory), the dedup, the invariant
and constraint evaluation and the level buffer all live on the device;
the host keeps the counters and reads back one packed row per level.

Per frontier chunk (``_chunk_step``): guard-first expansion over the
[B, A] lane grid (the int8 guard product by default), compaction of
the enabled lanes into the fixed-width FCAP candidate buffer with
successor materialization (the delta group for the affine families,
kernels for the rest), the ACTION_CONSTRAINTS mask on the (parent,
successor) pairs, the symmetry-canonical fingerprint (incremental
from per-parent term tables where the fingerprinter supports it, else
direct: minperm, or orbit-sort with the hard lanes' min over every
permutation), claim-insert dedup into the visited table
(``fingerprint.probe_claim_insert`` — the CUDA kernel) gated by the
level's overflow flags, then the second compaction of the fresh rows
(FCAP -> OCAP), invariants and constraints on them and their append
to the level buffer.  The step reads nothing back: its cursor, counts
and flags are device tensors updated in place, so on the card it runs
as a captured CUDA graph (``graph.GraphRunner``).  ``_finalize`` reads
the level's scalars once and commits the level (the level buffer
becomes the frontier) or, when a buffer overflowed, rolls the visited
table back through the level's insert journal and leaves the frontier
intact, so the host can grow the capacity and replay the level.

The roots are Init, the caller's seed states, or the cfg's prefix pins
compiled to seeds (the punctuated search, ``models/golden.py``), whose
replayed interior states are invariant-checked apart.

While the frontier fits a ring of ``_BURST_CHUNKS`` chunks, the burst
(``_burst_body``, the reference's ``_burst_core``) runs whole levels
one chunk per iteration with the same front half, committing a level
on the device whenever its chunks are done; the host reads the loop
state once per ring level, and any overflow bails the level back to
the per-level path.

At level boundaries the engine writes checkpoints in the reference's
file format (``engine/ckpt.py``): the carry's leaves under the
reference's names and dtypes, so a run started by either package
resumes in the other.  ``check(resume_from=)`` rebuilds the level state
at the checkpoint's capacities and starts a fresh graph runner (a graph
captured before holds the old buffers' addresses); trace archives live
in host RAM or, with ``archive_dir``, in a ``DiskArchive``.

This is the reference's driver (``raft_tla_tpu/engine/bfs.py``) with
the same capacity model: ``chunk`` frontier rows per step, LCAP level
rows (an OCAP append margin reserved), FCAP enabled candidates per
chunk, OCAP fresh rows per chunk, VCAP table slots (a power of two,
grown ×4 past load 0.40), per-family caps, and in sort mode HCAP hard
lanes per chunk (the fallback's fixed-width buffer, so finding them
needs no host sync); any overflow replays the level with the cap
grown.  State identity, first-seen order and global ids equal the
reference's: candidates are enumerated in ascending (row, lane) order
and the dedup resolves lanes in that order.
"""

from __future__ import annotations

import time
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..convert import (rows_to_torch, storage_rows_to_numpy,
                       storage_to_numpy, words_to_numpy, words_to_torch)
from ..obs import NULL_OBS
from ..obs.metrics import CHECK_COUNTER_KEYS, MetricsRegistry
from ..ops.codec import C_OVERFLOW
from ..resil.chaos import chaos_point
from ..spec import spec_of
from ..utils import (fmix32_int, fp_key, HOME_SALT, resolve_device,
                     take_arrays)
from . import driver
from .ckpt import (CheckpointError, _leaf_name, ckpt_archives, ckpt_carry,
                   ckpt_read, ckpt_result, ckpt_write)
from .expand import Expander, compact_positions
from .fingerprint import probe_claim_insert, resolve_sym_canon
from .graph import GraphRunner

EMPTY = -1          # the all-ones u32 key, as int32: an empty table slot

# the carry leaves of a checkpoint besides the table and the state
# buffers (the reference's ``_fresh_carry`` names): per-row arrays, 0-d
# int32 counters and 0-d bool flags
_CARRY_ROWS = ("jslot", "linv", "lcon", "lpar", "llane", "fmask", "famx")
_CARRY_COUNTERS = ("n_lvl", "n_gen", "ofx", "base", "g_off", "pg_off",
                   "n_front")
_CARRY_FLAGS = ("ovf", "fovf", "hovf", "oovf")


@dataclass
class Violation:
    invariant: str
    state_id: int
    state: Optional[object] = None
    hist: Optional[object] = None


class CheckResult:
    """A run's result, whose scalar counters live in one
    ``obs.metrics.MetricsRegistry`` (``self.metrics``, over exactly the
    reference's ``CHECK_COUNTER_KEYS``); the named attributes below are
    write-through views, so a harvest loop mutating ``res.levels_fused`` is
    updating the registry — the ledger, ``--stats-json`` and checkpoint
    meta all read the same store (the reference's form).

    - ``violations_global`` — total violations found;
    - ``levels_fused`` / ``burst_dispatches`` / ``burst_bailouts`` —
      levels committed inside bursts, burst dispatches, and dispatches
      that ended in a bail (a dispatch can both commit levels and bail);
    - ``guard_matmul`` / ``dedup_kernel`` / ``delta_matmul`` /
      ``sym_canon`` — the program this run executed
      (``Engine._stamp_mode``);
    - ``pin_interior_states`` — distinct pinned-prefix interior states
      invariant-checked but not counted (TLC counts them;
      models/golden docstring).

    The port's sort-mode counters ``hard_lanes``, ``hard_chunks`` and
    ``hard_chunk_max`` (hard lanes that took the min-over-perms
    fallback, the chunks that had any, the most in one chunk) are plain
    attributes outside the registry, so its key set is the reference's.
    """

    _COUNTERS = CHECK_COUNTER_KEYS

    def __init__(self, distinct_states: int = 0,
                 generated_states: int = 0, depth: int = 0,
                 violations: Optional[List[Violation]] = None,
                 level_sizes: Optional[List[int]] = None,
                 seconds: float = 0.0, overflow_faults: int = 0,
                 phase_seconds: Optional[Dict[str, float]] = None,
                 violations_global: int = 0, levels_fused: int = 0,
                 burst_dispatches: int = 0, burst_bailouts: int = 0,
                 pin_interior_states: int = 0, guard_matmul: int = 0,
                 dedup_kernel: int = 0, delta_matmul: int = 0,
                 sym_canon: int = 0):
        init = locals()
        self.metrics = MetricsRegistry()
        for nm in self._COUNTERS:
            self.metrics.register(nm, int(init[nm]))
        self.violations: List[Violation] = list(violations or [])
        self.level_sizes: List[int] = list(level_sizes or [])
        self.seconds = float(seconds)
        self.phase_seconds: Dict[str, float] = dict(phase_seconds or {})
        self.hard_lanes = self.hard_chunks = self.hard_chunk_max = 0

    def __repr__(self):
        body = ", ".join(f"{k}={v}"
                         for k, v in self.metrics.as_dict().items())
        return (f"CheckResult({body}, seconds={self.seconds:.3f}, "
                f"violations={len(self.violations)})")

    @property
    def states_per_sec(self):
        return self.distinct_states / max(self.seconds, 1e-9)

    @property
    def dedup_hit_rate(self):
        """Fraction of generated successors that were duplicates."""
        return 1.0 - self.distinct_states / max(self.generated_states, 1)


def _metric_view(nm: str) -> property:
    return property(lambda self: self.metrics.get(nm),
                    lambda self, v: self.metrics.set(nm, int(v)))


for _nm in CheckResult._COUNTERS:
    setattr(CheckResult, _nm, _metric_view(_nm))


def _ceil_log2(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def _scalar(device, dtype=torch.int64) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=device)


class _Level:
    """The per-level device buffers and counters (the reference's jit
    carry).  Every count and flag a chunk step touches is a device
    tensor updated in place, so the step is one fixed program over
    these buffers; a commit copies the level's rows into the frontier
    buffer rather than swapping the two, so one captured step serves
    every level.  The visited table is a view of a flat buffer with one
    spare slot at its end, where masked entries of a clearing scatter
    go."""

    def __init__(self, eng: "Engine", lcap: int, table: torch.Tensor):
        dev = eng.device
        one = eng.ir.narrow(eng.lay, rows_to_torch(
            {k: v[None] for k, v in eng.ir.encode(
                eng.lay, *eng.ir.init_state(eng.cfg)).items()}, dev,
            eng.ir.u32_keys))
        self.W = eng.W
        self.set_table(table)
        self.lvl = {k: torch.zeros(v.shape[:-1] + (lcap,), dtype=v.dtype,
                                   device=dev) for k, v in one.items()}
        self.front = {k: torch.zeros_like(v) for k, v in self.lvl.items()}
        self.fmask = torch.zeros(lcap, dtype=torch.bool, device=dev)
        self.jslot = torch.full((lcap,), -1, dtype=torch.int32, device=dev)
        self.linv = torch.ones((len(eng.inv_names), lcap),
                               dtype=torch.bool, device=dev)
        self.lcon = torch.ones(lcap, dtype=torch.bool, device=dev)
        self.lpar = torch.full((lcap,), -1, dtype=torch.int32, device=dev)
        self.llane = torch.full((lcap,), -1, dtype=torch.int32, device=dev)
        self.n_front = _scalar(dev)
        self.g_off = _scalar(dev)     # global state-id offset (this level)
        self.pg_off = _scalar(dev)    # global state-id offset (frontier)
        self.n_front_h = 0            # n_front as the last read gave it
        self.base = _scalar(dev)      # chunk cursor within the frontier
        self.n_lvl = _scalar(dev)
        self.n_gen = _scalar(dev)
        self.ofx = _scalar(dev)       # max fresh rows in any chunk
        self.ovf, self.fovf, self.hovf, self.oovf = (
            _scalar(dev, torch.bool) for _ in range(4))
        self.hcovf = _scalar(dev, torch.bool)   # hard lanes past HCAP
        # the most enabled lanes per family in any chunk
        self.famx = torch.zeros(len(eng.expander.families),
                                dtype=torch.int32, device=dev)
        # sort mode: hard lanes, chunks with any, the most in a chunk
        self.hard = torch.zeros(3, dtype=torch.int64, device=dev)

    def set_table(self, flat: torch.Tensor):
        self.vis_flat = flat
        self.vis = flat[:-1].view(self.W, -1)

    @property
    def lcap(self) -> int:
        return self.lpar.shape[0]

    @property
    def vcap(self) -> int:
        return self.vis.shape[1]

    @property
    def flags(self):
        return self.ovf, self.fovf, self.hovf, self.oovf, self.hcovf

    def reset(self):
        for t in (self.base, self.n_lvl, self.n_gen, self.ofx, self.famx,
                  self.hard, *self.flags):
            t.zero_()


class _Ring:
    """The burst's ring-width buffers, the reference's ``_burst_core``
    loop state: the frontier ring (KB = ``_BURST_CHUNKS`` chunks of
    rows, with each row's global id), the level ring with its insert
    journal, the per-level archives of up to ``burst_levels`` levels
    and the [levels + 1, 8] stats.  The level ring has a spare column
    and the archives and stats a spare row: a masked scatter writes
    there, and nothing reads it."""

    def __init__(self, eng: "Engine", st: _Level):
        dev, KB, L = eng.device, eng._burst_width(), eng.burst_levels
        n_inv = len(eng.inv_names)
        self.fr = {k: torch.zeros(v.shape[:-1] + (KB,), dtype=v.dtype,
                                  device=dev) for k, v in st.front.items()}
        self.lv = {k: torch.zeros(v.shape[:-1] + (KB + 1,), dtype=v.dtype,
                                  device=dev) for k, v in st.front.items()}
        self.fm = torch.zeros(KB, dtype=torch.bool, device=dev)
        self.gd = torch.zeros(KB, dtype=torch.int64, device=dev)
        self.lvp = torch.full((KB + 1,), -1, dtype=torch.int32, device=dev)
        self.lvlane = torch.full((KB + 1,), -1, dtype=torch.int32,
                                 device=dev)
        self.jsl = torch.zeros(KB + 1, dtype=torch.int32, device=dev)
        self.lin = torch.ones((n_inv, KB + 1), dtype=torch.bool, device=dev)
        self.lco = torch.ones(KB + 1, dtype=torch.bool, device=dev)
        self.stats = torch.zeros((L + 1, 8), dtype=torch.int64, device=dev)
        self.opar = torch.full((L + 1, KB), -1, dtype=torch.int32,
                               device=dev)
        self.olane = torch.full((L + 1, KB), -1, dtype=torch.int32,
                                device=dev)
        self.ost = {k: torch.zeros(v.shape[:-1] + (L + 1, KB), dtype=v.dtype,
                                   device=dev) for k, v in st.front.items()}
        self.oinv = torch.ones((n_inv, L + 1, KB), dtype=torch.bool,
                               device=dev)
        (self.nf, self.base, self.nl, self.gl, self.li, self.done, self.g,
         self.pg, self.lv_left, self.st_cap) = (_scalar(dev)
                                                for _ in range(10))
        self.bail = _scalar(dev, torch.bool)
        self.viol = _scalar(dev, torch.bool)
        # sort mode: hard-lane stats of the committed levels, and of
        # the level under way
        self.hard = torch.zeros(3, dtype=torch.int64, device=dev)
        self.hard_l = torch.zeros(3, dtype=torch.int64, device=dev)


def _hard_add(h: torch.Tensor, nh: torch.Tensor) -> torch.Tensor:
    """Hard-lane stats [sum, chunks with any, max] plus one chunk's."""
    return torch.stack([h[0] + nh, h[1] + (nh > 0), torch.maximum(h[2], nh)])


class _ParentRows(Mapping):
    """The parent's batch-last fields gathered per candidate column, each
    field on its first read: an action constraint pays only for the
    fields it reads (XLA drops the unread gathers of the reference's
    dict; eager PyTorch and a captured graph would run them all)."""

    def __init__(self, sv, prow: torch.Tensor):
        self._sv, self._prow, self._rows = sv, prow, {}

    def __getitem__(self, key):
        if key not in self._rows:
            self._rows[key] = self._sv[key].index_select(-1, self._prow)
        return self._rows[key]

    def __iter__(self):
        return iter(self._sv)

    def __len__(self):
        return len(self._sv)


class Engine:
    """One checker instance per (ModelConfig, chunk size, device).

    chunk    — frontier states expanded per chunk step.
    lcap     — initial level-buffer capacity (states); grows ×4 on
               overflow (the level is replayed from the intact frontier).
    vcap     — initial visited-table capacity (keys; a power of two).
    fcap     — enabled-candidate capacity per chunk (default as the
               reference: min(chunk·A, max(chunk·16, 8192))).
    ocap     — fresh-row capacity per chunk.
    incremental_fp — incremental per-action fingerprints where the
               fingerprinter supports them (minperm, at most 24
               permutations); bit-identical to the direct path.
    burst    — fuse small levels (the reference's default): while the
               frontier fits the ring of ``_BURST_CHUNKS`` chunks, run
               up to ``burst_levels`` (default 16) whole levels in one
               dispatch whose only reads are the host's checks between
               its iterations; False keeps the per-level driver.  The
               same answer either way.
    guard_matmul, delta_matmul, delta_chunk_skip — the expansion's
               forms (``expand.Expander``); every setting gives the
               same answer.
    fam_density — per-family density overrides for the initial
               per-family caps (``expand.validate_fam_density``).
    sym_canon — "auto" (sort past 6 permutations), "sort" or "minperm"
               (``fingerprint.resolve_sym_canon``).
    hcap     — sort mode: hard lanes per chunk that the fallback's
               fixed-width buffer holds (default: chunk); grows on
               overflow.
    archive_dir — with ``store_states``, stream each level's parents,
               lanes and state rows to memmap'd files under this
               directory (``archive.DiskArchive``) instead of host
               lists; None keeps the archives in host RAM.
    device   — "cuda" by default; "cpu" only when asked for.

    On the card the chunk step and the burst body run as captured CUDA
    graphs (``graph.GraphRunner``); ``_capture = False`` keeps them
    eager there, to hold a graph against the program it captured.
    """

    _LOAD_MAX = 0.40
    _BURST_LEVELS = 16
    _BURST_CHUNKS = 4           # the burst ring's width, in chunks
    # the observability bundle of the run under way (``check(obs=)``);
    # every hook of NULL_OBS is a no-op
    _obs = NULL_OBS

    def __init__(self, cfg: ModelConfig, chunk: int = 512,
                 store_states: bool = True,
                 lcap: int = 1 << 14, vcap: int = 1 << 17,
                 fcap: Optional[int] = None, ocap: Optional[int] = None,
                 incremental_fp: bool = True,
                 burst: bool = True, burst_levels: Optional[int] = None,
                 sym_canon: str = "auto",
                 hcap: Optional[int] = None,
                 guard_matmul: bool = True, delta_matmul: bool = True,
                 delta_chunk_skip: Optional[bool] = None,
                 fam_density: Optional[Dict[str, int]] = None,
                 archive_dir: Optional[str] = None,
                 device: Optional[str] = None):
        if burst_levels is not None and int(burst_levels) <= 0:
            raise ValueError(
                f"burst_levels must be positive, got {burst_levels} "
                "(use burst=False to disable the fused-level path)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ir = spec_of(cfg)
        self.chunk = max(16, int(chunk))
        self.store_states = store_states
        self.archive_dir = archive_dir
        self._arch = None
        self._states: List[Dict[str, np.ndarray]] = []
        self._parents: List[np.ndarray] = []
        self._lanes: List[np.ndarray] = []
        self.lay = self.ir.make_layout(cfg)
        self.kern = self.ir.make_kernels(self.lay)
        self.guard_matmul = bool(guard_matmul)
        self.delta_matmul = bool(delta_matmul)
        self.expander = Expander(cfg, self.device,
                                 guard_matmul=self.guard_matmul,
                                 delta_matmul=self.delta_matmul,
                                 delta_chunk_skip=delta_chunk_skip)
        self.fpr = self.ir.make_fingerprinter(
            cfg, sym_canon=resolve_sym_canon(cfg, sym_canon))
        self.incremental_fp = incremental_fp
        self.burst = bool(burst)
        self.burst_levels = (int(burst_levels) if burst_levels
                             else self._BURST_LEVELS)
        self.preds = self.ir.make_predicates(self.lay)
        self.inv_names = list(cfg.invariants)
        self.con_names = list(cfg.constraints)
        self.act_names = list(cfg.action_constraints)
        self._act_fns = [self.preds.action_fn(nm) for nm in self.act_names]
        self.labels = self.expander.lane_labels()
        self.A = self.expander.n_lanes
        self.W = self.fpr.n_streams           # u32 words per dedup key
        self.FCAP = int(fcap) if fcap else min(
            self.chunk * self.A, max(self.chunk * 16, 1 << 13))
        self.OCAP = self._round_cap(min(self.FCAP, int(ocap) if ocap
                                        else max(4 * self.chunk,
                                                 1 << 11)))
        self.LCAP = self._round_cap(
            max(lcap, 4 * self.chunk, 4 * self.FCAP))
        self.VCAP = 1 << _ceil_log2(int(vcap))
        self.fam_density = dict(fam_density or {})
        self.FAM_CAPS = self.expander.default_fam_caps(self.chunk,
                                                       self.fam_density)
        self._caps_dev = (None, None)
        self.HCAP = int(hcap) if hcap else self.chunk
        self._capture = True
        self._graphs = GraphRunner(self.device, False)
        # checkpoint-chain depth (resil/ckpt_chain): keep the last K
        # checkpoints (path, path.1, ...) so a torn head falls back to
        # its predecessor; the CLI sets it (--ckpt-keep)
        self.ckpt_keep = 2

    def _round_cap(self, n: int) -> int:
        c = self.chunk
        return ((int(n) + c - 1) // c) * c

    def _burst_width(self) -> int:
        """The ring's width (states): the largest frontier the fused
        path takes."""
        return self._BURST_CHUNKS * self.chunk

    # ------------------------------------------------------------------
    # invariants + constraints on batch-last rows
    # ------------------------------------------------------------------

    def _phase2_T(self, svT):
        """inv bool [n_inv, N], con bool [N]."""
        return self.preds.check_T(svT, self.inv_names, self.con_names)

    def _act_ok(self, parent, cand) -> torch.Tensor:
        """ACTION_CONSTRAINTS (TLC semantics) on batch-last (parent,
        successor) pairs: ok bool [N]; a violating transition is not
        taken."""
        ok = self._act_fns[0](parent, cand)
        for fn in self._act_fns[1:]:
            ok = ok & fn(parent, cand)
        return ok

    # ------------------------------------------------------------------
    # the visited table
    # ------------------------------------------------------------------

    def _new_table(self, vcap: int) -> torch.Tensor:
        """An empty table's flat buffer: W·VCAP slots and a spare one."""
        return torch.full((self.W * vcap + 1,), EMPTY, dtype=torch.int32,
                          device=self.device)

    def _clear_slots(self, st: _Level, slots: torch.Tensor,
                     mask: torch.Tensor):
        """EMPTY the table slots ``slots`` [n] where ``mask`` [n]: one
        scatter of a constant, masked entries sent to the spare slot,
        so repeated slots cannot race."""
        W, V = self.W, st.vcap
        words = torch.arange(W, device=self.device)[:, None] * V
        idx = torch.where(mask[None], slots.long()[None] + words, W * V)
        st.vis_flat.index_fill_(0, idx.reshape(-1), EMPTY)

    def _host_probe_assign(self, keys: np.ndarray,
                           vcap: Optional[int] = None) -> np.ndarray:
        """Sequential host placement of pre-deduped keys [N, W] u32 into
        an EMPTY table (the roots): same home hash and quadratic
        advance as the kernel, so the device continues it consistently."""
        vcap = vcap if vcap is not None else self.VCAP
        occupied = set()
        out = np.zeros(len(keys), np.int32)
        for i, kw in enumerate(keys):
            h = HOME_SALT
            for w in range(self.W):
                h = fmix32_int(h ^ int(kw[w]))
            pos, t = h & (vcap - 1), 0
            while pos in occupied:
                t += 1
                pos = (pos + t) & (vcap - 1)
            occupied.add(pos)
            out[i] = pos
        return out

    def _rehash_tables(self, vis: torch.Tensor, new_vcap: int):
        """Grow the visited table: claim-insert every occupied slot, in
        ascending slot order, into a fresh table of ``new_vcap``.
        Returns the new table's flat buffer."""
        keys = vis[:, ~(vis == EMPTY).all(0)].contiguous()
        flat = self._new_table(new_vcap)
        live = torch.ones(keys.shape[1], dtype=torch.bool,
                          device=self.device)
        _fresh, _pos, hv = probe_claim_insert(
            flat[:-1].view(self.W, new_vcap), keys, live)
        if bool(hv):
            raise RuntimeError("rehash did not converge — table "
                               "pathologically full; raise vcap")
        return flat

    # ------------------------------------------------------------------
    # the shared front half of a chunk step and a burst iteration
    # ------------------------------------------------------------------

    def _expand_fp_chunk(self, sv, valid: torch.Tensor, fcap: int):
        """Guard-first expansion over the [B, A] lane grid (rows outside
        ``valid`` [B] disabled), compaction of the enabled lanes into the
        fixed-width FCAP candidate buffer in ascending (row, lane) order,
        successor materialization, ACTION_CONSTRAINTS and the
        symmetry-canonical fingerprint (the reference's
        ``_expand_fp_chunk``).  Returns (cand [..., fcap], elive [fcap],
        keys [W, fcap], lanes [fcap] (buffer slot -> flat lane), counts
        [n_fams], n_e, n_gen, n_hard): the per-family and total enabled
        counts, the live candidates (the generated states) and, in sort
        mode, the live hard lanes, all device data (n_hard None
        otherwise).  Columns past n_e are garbage: they are not live."""
        derb = self.kern.derived(sv)
        okf = (self.expander.guards_T(sv, derb) &
               valid[:, None]).reshape(-1)
        epos, n_e = compact_positions(okf, fcap)
        elive = torch.arange(fcap, device=self.device) < n_e
        lanes = self._slot_lanes(epos, fcap)
        incr = self.incremental_fp and self.fpr.supports_incremental()
        if incr:
            tables = self.fpr.parent_tables(sv)
            cand, counts, keys = self.expander.materialize(
                sv, derb, okf, epos, fcap, self.FAM_CAPS,
                delta_fp=(self.fpr, tables))
        else:
            cand, counts = self.expander.materialize(
                sv, derb, okf, epos, fcap, self.FAM_CAPS)
        if self.act_names:
            # ACTION_CONSTRAINTS on the compacted (parent, successor)
            # pairs: a violating transition is cleared before dedup
            prow = (lanes // self.A).clamp(max=valid.shape[0] - 1)
            elive = elive & self._act_ok(_ParentRows(sv, prow), cand)
            n_gen = elive.sum()
        else:
            n_gen = n_e.clamp(max=fcap)
        n_hard = None
        if not incr:
            # columns that are not live (past n_e, or cut by an action
            # constraint) must not count as hard lanes, or they would
            # fill the fallback's buffer
            keys, n_hard = self.fpr.fingerprint_chunk_T(cand, self.HCAP,
                                                        live=elive)
        return cand, elive, keys, lanes, counts, n_e, n_gen, n_hard

    def _caps_t(self) -> torch.Tensor:
        """FAM_CAPS as a device tensor (copied once per value: the caps
        change only between levels, before any capture)."""
        if self._caps_dev[0] != self.FAM_CAPS:
            self._caps_dev = (self.FAM_CAPS, torch.tensor(
                self.FAM_CAPS, dtype=torch.int32, device=self.device))
        return self._caps_dev[1]

    @staticmethod
    def _slot_lanes(epos: torch.Tensor, fcap: int) -> torch.Tensor:
        """Buffer slot -> flat lane id [fcap] (slots past the enabled
        count hold the grid size; lanes past fcap, which only an
        overflowing chunk has, go to the spare slot)."""
        N = epos.shape[0]
        out = torch.full((fcap + 1,), N, dtype=torch.int64,
                         device=epos.device)
        return out.scatter_(0, epos.long().clamp(max=fcap), torch.arange(
            N, device=epos.device))[:fcap]

    @staticmethod
    def _compact(fresh: torch.Tensor, ocap: int) -> torch.Tensor:
        """The second compaction: out row -> buffer slot [ocap] of the
        fresh slots, in slot order (rows past the fresh count hold 0)."""
        n = fresh.shape[0]
        opos = torch.where(fresh, torch.cumsum(fresh, 0) - 1, ocap)
        out = torch.zeros(ocap + 1, dtype=torch.int64, device=fresh.device)
        return out.scatter_(0, opos, torch.arange(
            n, device=fresh.device))[:ocap]

    def _grow_caps(self, oovf: bool, fovf: bool, famx):
        """After an overflow: double OCAP toward FCAP (fresh rows
        outran the second compaction), and grow the family caps past
        their chunk maxima ``famx`` or, when no family cap overflowed,
        FCAP."""
        if oovf:
            self.OCAP = self._round_cap(min(self.FCAP, 2 * self.OCAP))
        if fovf:
            caps = list(self.FAM_CAPS)
            fam_over = False
            for fi, fam in enumerate(self.expander.families):
                hard = fam.n_lanes * self.chunk
                while caps[fi] < hard and famx[fi] > caps[fi]:
                    caps[fi] = min(2 * caps[fi], hard)
                    fam_over = True
            self.FAM_CAPS = tuple(caps)
            if not fam_over:
                self.FCAP = self._round_cap(min(
                    self.chunk * self.A,
                    max(2 * self.FCAP, (5 * int(sum(famx))) // 4)))

    def _graph_key(self, kind: str, st: _Level):
        """What a captured step or burst iteration is specialised to."""
        return (kind, self.chunk, self.FCAP, self.OCAP,
                tuple(self.FAM_CAPS), self.HCAP, st.lcap, st.vcap,
                self.incremental_fp and self.fpr.supports_incremental(),
                self.fpr.sym_canon, bool(self.act_names))

    # ------------------------------------------------------------------
    # the halves a chunk step shares with the spill engine's
    # ------------------------------------------------------------------

    def _gather_window(self, st, cap: int):
        """The chunk window: a gather of the frontier at base +
        arange(B), clamped into its ``cap`` rows (a multiple of the
        chunk).  Returns (rows, win, sv): the rows' indices, the clamped
        indices and the widened states; the caller masks rows past the
        frontier."""
        rows = st.base + torch.arange(self.chunk, device=self.device)
        win = rows.clamp(max=cap - 1)
        sv = self.ir.widen({k: v.index_select(-1, win)
                            for k, v in st.front.items()})
        return rows, win, sv

    def _append_fresh(self, st, fresh, n_fresh, cand, lanes, parent_of,
                      per_row=()):
        """The second compaction (FCAP -> OCAP), the invariants and
        constraints of the fresh rows, and their contiguous append at
        ``n_lvl`` (rows past n_fresh are garbage beyond the new n_lvl);
        then the cursor moves one chunk on.  ``parent_of`` maps the
        parents' frontier rows to their global ids; ``per_row`` holds
        (buffer, dim, source) triples, each source indexed along dim by
        buffer slot, appended beside the rows."""
        A, OCAP, LCAP = self.A, self.OCAP, st.lcap
        lidx = self._compact(fresh, OCAP)
        lane = lanes[lidx]
        rows_f = {k: v.index_select(-1, lidx) for k, v in cand.items()}
        inv, con = self._phase2_T(rows_f)
        rows_n = self.ir.narrow(self.lay, rows_f)
        dst = st.n_lvl.clamp(max=LCAP - OCAP) + torch.arange(
            OCAP, device=self.device)
        for k, v in st.lvl.items():
            v.index_copy_(v.dim() - 1, dst, rows_n[k])
        st.lpar.index_copy_(0, dst, parent_of(st.base + lane // A))
        st.llane.index_copy_(0, dst, (lane % A).to(torch.int32))
        st.linv.index_copy_(1, dst, inv)
        st.lcon.index_copy_(0, dst, con)
        for buf, dim, src in per_row:
            buf.index_copy_(dim, dst, src.index_select(dim, lidx))
        st.n_lvl.copy_((st.n_lvl + n_fresh).clamp(max=LCAP - OCAP))
        torch.maximum(st.ofx, n_fresh, out=st.ofx)
        st.base += self.chunk

    # ------------------------------------------------------------------
    # one frontier chunk (the reference's _chunk_step_impl)
    # ------------------------------------------------------------------

    def _chunk_step(self, st: _Level):
        """Expand the B frontier rows at the device cursor, fingerprint,
        dedup into the visited table, evaluate invariants/constraints on
        the fresh rows and append them to the level buffer.  Reads
        nothing back: the counts and flags stay on the device, the dedup
        gate is device data and the fresh rows take the second
        compaction (FCAP -> OCAP), so the step is one fixed program."""
        FCAP, OCAP, LCAP = self.FCAP, self.OCAP, st.lcap
        rows, win, sv = self._gather_window(st, LCAP)
        valid = st.fmask.index_select(0, win) & (rows < st.n_front)
        cand, elive, keys, lanes, counts, n_e, n_gen, n_hard = \
            self._expand_fp_chunk(sv, valid, FCAP)
        torch.maximum(st.famx, counts, out=st.famx)
        # a chunk whose enabled lanes overflow FCAP or a family cap, or
        # whose hard lanes overflow HCAP, has an incomplete or
        # non-canonical buffer: the level replays
        st.fovf |= (n_e > FCAP) | (counts > self._caps_t()).any()
        if n_hard is not None:
            st.hard.copy_(_hard_add(st.hard, n_hard.long()))
            st.hcovf |= n_hard > self.HCAP
        st.n_gen += n_gen
        # once the level replays, insert nothing, so the journal stays
        # the exact record of its table writes
        gate = ~(st.ovf | st.fovf | st.hovf | st.oovf | st.hcovf)
        fresh, pos, hv = probe_claim_insert(st.vis, keys, elive & gate)
        st.hovf |= hv
        n_fresh = fresh.sum()
        # the chunk-local overflows: level buffer full (the margin is
        # OCAP) and fresh rows past OCAP; revert this chunk's inserts
        # on the spot (earlier chunks' at finalize, via the journal)
        ovf_now = st.n_lvl + n_fresh > LCAP - OCAP
        oovf_now = n_fresh > OCAP
        bad_now = ovf_now | oovf_now
        self._clear_slots(st, pos, fresh & bad_now)
        st.ovf |= ovf_now
        st.oovf |= oovf_now
        fresh = fresh & ~bad_now
        n_fresh = torch.where(bad_now, 0, n_fresh)
        # parent ids: the frontier's first global id plus the row; the
        # insert journal records each row's table slot
        self._append_fresh(
            st, fresh, n_fresh, cand, lanes,
            lambda prow: (st.pg_off + prow).to(torch.int32),
            ((st.jslot, 0, pos),))

    # ------------------------------------------------------------------
    # per-level finalize: commit, or roll the table back via the journal
    # ------------------------------------------------------------------

    def _finalize(self, st: _Level) -> Tuple[List[int], torch.Tensor]:
        """The level's one read: every scalar packed into one tensor.
        Returns (scal, inv_ok): scal = [n_lvl, n_viol, faults, n_front,
        ovf, fovf, n_gen, n_expand, hovf, oovf, ofx] + famx, the
        reference's per-level scalar row, + [hcovf, the most hard lanes
        in one chunk].  A clean level is committed: its rows are copied
        into the frontier buffer and ``fmask`` is rewritten in place; an
        overflowed one rolls the table back through the level's insert
        journal and keeps the frontier."""
        validrow = torch.arange(st.lcap, device=self.device) < st.n_lvl
        n_viol = (~st.linv & validrow).sum()
        faults = ((st.lvl["ctr"][C_OVERFLOW] > 0) & validrow).sum()
        n_expand = (st.lcon & validrow).sum()
        got = torch.cat([
            torch.stack([st.n_lvl, n_viol, faults, st.n_gen, n_expand,
                         st.ofx] + [f.long() for f in st.flags]),
            st.famx.long(), st.hard]).tolist()
        n_lvl, n_viol, faults, n_gen, n_expand, ofx = got[:6]
        ovf, fovf, hovf, oovf, hcovf = got[6:11]
        nf = len(st.famx)
        famx, hard = got[11:11 + nf], got[11 + nf:]
        inv_ok = st.linv[:, :n_lvl]
        if ovf or fovf or hovf or oovf or hcovf:
            # clear exactly the journaled inserts; a cleared cohort
            # postdates every surviving key, so it cannot sit on a
            # surviving key's probe path
            st.vis[:, st.jslot[:n_lvl].long()] = EMPTY
        else:
            # the level becomes the frontier; constraint-pruned rows
            # stay in place, masked out of expansion by fmask
            for k, v in st.front.items():
                v[..., :n_lvl] = st.lvl[k][..., :n_lvl]
            st.fmask.copy_(st.lcon & validrow)
            st.n_front.copy_(st.n_lvl)
            st.n_front_h = n_lvl
            st.pg_off.copy_(st.g_off)
            st.g_off += st.n_lvl
            h = self.hard_stats
            self.hard_stats = [h[0] + hard[0], h[1] + hard[1],
                               max(h[2], hard[2])]
        scal = [n_lvl, n_viol, faults, st.n_front_h, ovf, fovf, n_gen,
                n_expand, hovf, oovf, ofx] + famx + [hcovf, hard[2]]
        st.reset()
        return scal, inv_ok

    def _grow(self, st: _Level, lcap: int) -> _Level:
        """Re-home the frontier and the table into a level state of
        ``lcap`` rows (the level buffer is reset; callers replay)."""
        new = _Level(self, lcap, st.vis_flat)
        n = st.lcap
        for k, v in st.front.items():
            new.front[k][..., :n] = v
        new.fmask[:n] = st.fmask
        for a, b in ((new.n_front, st.n_front), (new.g_off, st.g_off),
                     (new.pg_off, st.pg_off)):
            a.copy_(b)
        new.n_front_h = st.n_front_h
        return new

    # ------------------------------------------------------------------
    # the small-level burst (the reference's _burst_core / _burst_impl)
    # ------------------------------------------------------------------

    def _burst_body(self, st: _Level, r: _Ring):
        """One iteration of the burst loop, predicated on the loop's
        condition: one frontier chunk of the ring through the same
        front half as a chunk step, dedup, the second compaction, the
        append to the level ring and, when the chunk drains the
        frontier, the level's commit (stats, archives, the ring
        swap).  Any overflow bails: this chunk's inserts and the
        level's earlier ones (the ring journal) are cleared and the
        pre-level frontier is kept.  When the condition is false the
        iteration changes nothing, so the host may run it past the
        loop's end.  Reads nothing back."""
        B, A, FCAP, dev = self.chunk, self.A, self.FCAP, self.device
        KB, L = self._burst_width(), self.burst_levels
        OC = min(self.OCAP, KB)
        run = ~r.bail & ~r.viol & (r.li < r.lv_left) & (r.nf > 0) & \
            (r.done < r.st_cap)
        rows = r.base + torch.arange(B, device=dev)
        win = rows.clamp(max=KB - 1)
        sv = self.ir.widen({k: v.index_select(-1, win)
                            for k, v in r.fr.items()})
        valid = r.fm.index_select(0, win) & (rows < r.nf) & run
        cand, elive, keys, lanes, counts, n_e, n_gen, n_hard = \
            self._expand_fp_chunk(sv, valid, FCAP)
        # overflows known before the launch: nothing is inserted
        bail = (n_e > FCAP) | (counts > self._caps_t()).any()
        if n_hard is not None:
            nh = n_hard.long()
            bail = bail | (nh > self.HCAP)
        fresh, pos, hv = probe_claim_insert(st.vis, keys, elive & ~bail)
        n_fresh = fresh.sum()
        # the probe budget, the ring outgrown, fresh rows past OC
        bail = bail | hv | (r.nl + n_fresh > KB) | (n_fresh > OC)
        # bail: the level never happened
        self._clear_slots(
            st, torch.cat([pos, r.jsl[:KB]]),
            torch.cat([fresh, torch.arange(KB, device=dev) < r.nl]) & bail)
        fresh = fresh & ~bail
        n_fresh = torch.where(bail, 0, n_fresh)
        gl2 = r.gl + torch.where(bail, 0, n_gen)
        nl2 = r.nl + n_fresh
        # the second compaction, then the ring append at nl (rows past
        # n_fresh go to the spare column)
        oidx = self._compact(fresh, OC)
        rows_f = {k: v.index_select(-1, oidx) for k, v in cand.items()}
        inv, con = self._phase2_T(rows_f)
        rows_n = self.ir.narrow(self.lay, rows_f)
        oar = torch.arange(OC, device=dev)
        rpos = torch.where(oar < n_fresh, r.nl + oar, KB)
        for k, v in r.lv.items():
            v.index_copy_(v.dim() - 1, rpos, rows_n[k])
        take = lanes[oidx]
        par_row = (r.base + take // A).clamp(0, KB - 1)
        r.lvp.index_copy_(0, rpos, r.gd[par_row].to(torch.int32))
        r.lvlane.index_copy_(0, rpos, (take % A).to(torch.int32))
        r.jsl.index_copy_(0, rpos, pos.index_select(0, oidx))
        r.lin.index_copy_(1, rpos, inv)
        r.lco.index_copy_(0, rpos, con)
        # the level's commit, predicated (a mid-level chunk, a bail or a
        # finished loop leaves the frontier and the archives as they
        # are: their writes go to the spare row)
        new_base = r.base + B
        done = run & ~bail & (new_base >= r.nf)
        validrow = torch.arange(KB, device=dev) < nl2
        inv_ok = r.lin[:, :KB] | ~validrow
        n_viol = (~inv_ok).sum()
        faults = ((r.lv["ctr"][C_OVERFLOW, :KB] > 0) & validrow).sum()
        n_expand = (r.lco[:KB] & validrow).sum()
        at = torch.where(done, r.li, L).reshape(1)
        r.stats.index_copy_(0, at, torch.cat([
            torch.stack([nl2, n_viol, faults, n_expand, gl2]),
            nl2.new_zeros(3)])[None])
        r.opar.index_copy_(0, at, r.lvp[None, :KB])
        r.olane.index_copy_(0, at, r.lvlane[None, :KB])
        for k, v in r.ost.items():
            v.index_copy_(v.dim() - 2, at, r.lv[k][..., None, :KB])
        r.oinv.index_copy_(1, at, inv_ok[:, None])
        if n_hard is not None:
            hl = _hard_add(r.hard_l, torch.where(bail, 0, nh))
            hc = torch.stack([r.hard[0] + hl[0], r.hard[1] + hl[1],
                              torch.maximum(r.hard[2], hl[2])])
            r.hard.copy_(torch.where(done, hc, r.hard))
            r.hard_l.copy_(torch.where(done, 0, hl))
        # the ring swap at a level boundary; rows past nl2 are stale
        # but masked by nf and fm
        for k, v in r.fr.items():
            v.copy_(torch.where(done, r.lv[k][..., :KB], v))
        r.fm.copy_(torch.where(done, r.lco[:KB] & validrow, r.fm))
        r.nf.copy_(torch.where(done, nl2, r.nf))
        r.gd.copy_(torch.where(done, r.g + torch.arange(KB, device=dev),
                               r.gd))
        r.pg.copy_(torch.where(done, r.g, r.pg))
        r.g += torch.where(done, nl2, 0)
        r.done += torch.where(done, nl2, 0)
        r.li += done
        r.base.copy_(torch.where(run, torch.where(done, 0, new_base),
                                 r.base))
        r.nl.copy_(torch.where(done, 0, nl2))
        r.gl.copy_(torch.where(done, 0, gl2))
        r.bail |= bail
        r.viol |= done & (n_viol > 0)

    def _burst(self, st: _Level, r: _Ring, lv_left: int, st_cap: int):
        """One burst dispatch from the level state's frontier: up to
        ``lv_left`` levels (and to ``st_cap`` new states) while the
        frontier fits the ring.  Returns (the meta row [levels done,
        bail, n_front, viol_any, states done], the stats rows
        [levels, 8] as numpy)."""
        KB = self._burst_width()
        for k, v in st.front.items():
            r.fr[k].copy_(v[..., :KB])
        r.fm.copy_(st.fmask[:KB])
        torch.add(torch.arange(KB, device=self.device), st.pg_off,
                  out=r.gd)
        r.nf.copy_(st.n_front)
        r.g.copy_(st.g_off)
        r.pg.copy_(st.pg_off)
        got, stats = self._burst_loop(st, r, lv_left, st_cap,
                                      st.n_front_h)
        # paste the surviving frontier back
        st.fmask.zero_()
        st.fmask[:KB] = r.fm
        for k, v in st.front.items():
            v[..., :KB] = r.fr[k]
        st.n_front.copy_(r.nf)
        st.n_front_h = got[2]
        st.g_off.copy_(r.g)
        st.pg_off.copy_(r.pg)
        return got, stats

    def _burst_loop(self, st, r: _Ring, lv_left: int, st_cap: int,
                    nf: int):
        """The burst loop over a loaded ring (frontier rows, mask,
        gids, ``nf`` rows, the id offsets): the host runs the body k
        iterations at a time, k the chunks left in the ring's current
        level, and reads the loop state once per k.  Returns (the meta
        row, the stats rows [levels, 8] as numpy)."""
        B, L = self.chunk, self.burst_levels
        for t in (r.base, r.nl, r.gl, r.li, r.done, r.bail, r.viol, r.hard,
                  r.hard_l):
            t.zero_()
        r.lv_left.fill_(lv_left)
        r.st_cap.fill_(st_cap)
        key = self._graph_key("burst", st)
        base = 0
        while True:
            for _ in range(max(1, -(-(nf - base) // B))):
                self._graphs.run(key, lambda: self._burst_body(st, r))
            got = torch.cat([
                torch.stack([r.li, r.bail.long(), r.nf, r.viol.long(),
                             r.done, r.base]),
                r.hard, r.stats[:L].reshape(-1)]).tolist()
            li, bail, nf, viol, done, base = got[:6]
            if bail or viol or li >= lv_left or nf == 0 or done >= st_cap:
                break
        h, hb = self.hard_stats, got[6:9]
        self.hard_stats = [h[0] + hb[0], h[1] + hb[1], max(h[2], hb[2])]
        return got[:5], np.asarray(got[9:], np.int64).reshape(L, 8)

    # ------------------------------------------------------------------

    def _encode_rows(self, states) -> Dict[str, np.ndarray]:
        """(State, Hist) pairs or raw SoA dicts -> SoA rows [n, ...]."""
        arrs = [s if isinstance(s, dict) else
                self.ir.encode(self.lay, *s) for s in states]
        return {k: np.stack([np.asarray(a[k]) for a in arrs])
                for k in arrs[0]}

    def _first_seen(self, rows: Dict[str, np.ndarray]):
        """(keys u32 [n, W], the first-seen row of each distinct
        canonical fingerprint, ascending)."""
        fp = self.fpr.fingerprint_batch_T(
            rows_to_torch(rows, self.device, self.ir.u32_keys))
        rk = words_to_numpy(fp).T                              # [n, W]
        _u, first = np.unique(fp_key(rk), return_index=True)
        first.sort()
        return rk, first

    def _dedup_roots(self, seed_states=None):
        """The root set: the seeds, or the cfg's prefix pins compiled to
        seeds with their interiors (raft.tla:1198-1234; models/golden
        docstring), or Init.  Seeds are (State, Hist) pairs or raw SoA
        dicts (an engine-emitted seed keeps its non-VIEW lanes exactly).
        Returns (roots numpy SoA [n, ...], keys u32 [n, W],
        pin_interiors or None) after first-seen fingerprint dedup."""
        pin_interiors = None
        if seed_states is None and self.cfg.prefix_pins:
            seed_states, pin_interiors = self.ir.prefix_pin_seeds(
                self.cfg, with_interior=True)
        roots = self._encode_rows(
            seed_states if seed_states is not None
            else [self.ir.init_state(self.cfg)])
        rk, first = self._first_seen(roots)
        return take_arrays(roots, first), rk[first], pin_interiors

    def _check_pin_interiors(self, interiors, res: CheckResult):
        """Invariant-check the replayed pinned-prefix interior states.
        TLC counts and checks every prefix state; seeding at the witness
        end skips them, so their distinct count is recorded in
        ``pin_interior_states`` (the divergence bound) and a violation
        among them is reported with state_id -1 (it has no BFS id)."""
        if not interiors:
            return
        rows = self._encode_rows(interiors)
        _rk, first = self._first_seen(rows)
        res.pin_interior_states = len(first)
        if not self.inv_names:
            return
        inv, _con = self._phase2_T(
            rows_to_torch(rows, self.device, self.ir.u32_keys))
        bad = (~inv).cpu().numpy()[:, first]
        for j, nm in enumerate(self.inv_names):
            for s in np.nonzero(bad[j])[0]:
                sv, h = interiors[int(first[s])]
                res.violations.append(Violation(nm, -1, state=sv, hist=h))
                res.violations_global += 1

    # ------------------------------------------------------------------
    # trace archives: host lists, or a DiskArchive under archive_dir —
    # one dispatch point, so the check loop, checkpoints and trace
    # reconstruction do not depend on the backing
    # ------------------------------------------------------------------

    def _init_store(self):
        self._states, self._parents, self._lanes = [], [], []
        self._arch = None
        if self.store_states and self.archive_dir:
            from .archive import DiskArchive
            self._arch = DiskArchive(self.archive_dir)

    def _archive_level(self, parents: np.ndarray, lanes: np.ndarray,
                       states: Dict[str, np.ndarray]):
        """One level's batch-major rows, in the storage dtypes."""
        with self._obs.span("archive_io"):
            if self._arch is not None:
                self._arch.append_level(parents, lanes, states)
            else:
                self._parents.append(parents)
                self._lanes.append(lanes)
                self._states.append(states)

    def _ckpt_store_args(self):
        """(parents, lanes, states, extra-meta) for ckpt_write: a disk
        archive already persists itself level by level, so checkpoints
        record only its level count instead of re-embedding rows."""
        if self._arch is not None:
            return [], [], [], dict(disk_archive=True,
                                    arch_levels=self._arch.n_levels)
        return self._parents, self._lanes, self._states, {}

    def _load_archives(self, path, z, meta, template):
        """Resume-side twin of _ckpt_store_args: reattach the disk
        archive (truncating levels past the checkpoint, so a resumed
        run re-appends them bit-identically) or unpack the embedded
        in-RAM archives."""
        from .archive import ArchiveError, DiskArchive
        if meta.get("disk_archive"):
            if not (self.store_states and self.archive_dir):
                raise CheckpointError(
                    f"{path}: checkpoint archives live in a disk "
                    "archive directory — resume with the same "
                    "archive_dir (CLI: --archive-dir)")
            try:
                self._arch = DiskArchive(self.archive_dir, attach=True)
                self._arch.truncate(meta["arch_levels"])
            except ArchiveError as e:
                raise CheckpointError(str(e)) from e
            self._parents, self._lanes, self._states = [], [], []
            return
        if self.store_states and self.archive_dir:
            raise CheckpointError(
                f"{path}: checkpoint holds in-RAM archives; resume "
                "without archive_dir")
        self._arch = None
        self._parents, self._lanes, self._states = ckpt_archives(
            z, meta, template, self.store_states)

    def _admit_roots(self, seed_states) -> Tuple[_Level, CheckResult]:
        """A fresh level state holding the deduplicated roots in its
        level buffer and table, ready for the first finalize."""
        roots, rk, pin_interiors = self._dedup_roots(seed_states)
        n_roots = len(rk)
        res = CheckResult(generated_states=n_roots)
        self._check_pin_interiors(pin_interiors, res)
        while self.LCAP - self.OCAP < 2 * n_roots:
            self.LCAP *= 2
        while n_roots + self.LCAP - self.OCAP > \
                self._LOAD_MAX * self.VCAP:
            self.VCAP *= 4
        st = _Level(self, self.LCAP, self._new_table(self.VCAP))
        # roots enter through the same admit path as every level: host
        # placement into the empty table, then finalize
        rows = rows_to_torch(roots, self.device, self.ir.u32_keys)
        rows_n = self.ir.narrow(self.lay, rows)
        for k, v in st.lvl.items():
            v[..., :n_roots] = rows_n[k]
        slots = torch.from_numpy(self._host_probe_assign(rk)).to(
            self.device)
        st.vis[:, slots.long()] = words_to_torch(rk.T, self.device)
        st.jslot[:n_roots] = slots
        st.n_lvl.fill_(n_roots)
        inv_r, con_r = self._phase2_T(rows)
        st.linv[:, :n_roots] = inv_r
        st.lcon[:n_roots] = con_r
        return st, res

    # ------------------------------------------------------------------
    # checkpoint / resume (engine/ckpt.py: the reference's file format)
    # ------------------------------------------------------------------

    def _carry_numpy(self, st: _Level) -> dict:
        """The level state as the JAX engine's carry of numpy arrays:
        its leaf names, shapes and dtypes.  u32 words (the table, ``bag``)
        are viewed as uint32, the 64-bit counters narrowed to int32; the
        leaves the port does not carry get the JAX engine's fresh
        values (``claims`` all ones, ``cidx``/``oidx`` zeros).  Every
        array is a copy: ``.numpy()`` of a CPU tensor aliases it."""
        def host(t):
            return t.to("cpu", copy=True).numpy()
        carry = dict(
            vis=tuple(host(st.vis[w]).view(np.uint32)
                      for w in range(self.W)),
            claims=np.full(st.vcap, 0xFFFFFFFF, np.uint32),
            cidx=np.zeros(self.FCAP, np.int32),
            oidx=np.zeros(self.OCAP, np.int32),
            lvl=storage_to_numpy(st.lvl, self.ir.u32_keys),
            front=storage_to_numpy(st.front, self.ir.u32_keys))
        for k in _CARRY_ROWS + _CARRY_FLAGS:
            carry[k] = host(getattr(st, k))
        for k in _CARRY_COUNTERS:
            carry[k] = host(getattr(st, k).to(torch.int32))
        return carry

    def _carry_template(self) -> dict:
        """The carry's structure (leaves unread), for ``ckpt_carry``."""
        fields = {k: None for k in self.ir.encode(
            self.lay, *self.ir.init_state(self.cfg))}
        keys = ("claims", "cidx", "oidx") + _CARRY_ROWS + \
            _CARRY_COUNTERS + _CARRY_FLAGS
        return dict(dict.fromkeys(keys), vis=(None,) * self.W, lvl=fields,
                    front=dict(fields))

    def _level_from_carry(self, path, carry: dict, meta: dict) -> _Level:
        """A level state at the checkpoint's capacities holding the
        carry: the flat table with its spare slot, ``vis`` its
        [W, VCAP] view; u32 words and ``bag`` back to int32 bit
        patterns with no value conversion."""
        st = _Level(self, self.LCAP, self._new_table(self.VCAP))
        dev = self.device

        def load(dst: torch.Tensor, arr: np.ndarray, name: str):
            src = torch.from_numpy(np.asarray(arr, order="C"))
            if tuple(src.shape) != tuple(dst.shape) or \
                    src.dtype != dst.dtype:
                raise CheckpointError(
                    f"{path}: checkpoint leaf {name!r} is "
                    f"{arr.dtype}{list(arr.shape)}, the engine's "
                    f"{dst.dtype}{list(dst.shape)} — re-run without "
                    "--resume")
            dst.copy_(src.to(dev))

        for w in range(self.W):
            load(st.vis[w], carry["vis"][w].view(np.int32),
                 _leaf_name(("vis", w)))
        for part in ("lvl", "front"):
            for k, v in getattr(st, part).items():
                a = carry[part][k]
                load(v, a.view(np.int32) if k in self.ir.u32_keys else a,
                     _leaf_name((part, k)))
        for k in _CARRY_ROWS + _CARRY_FLAGS:
            load(getattr(st, k), carry[k], _leaf_name((k,)))
        for k in _CARRY_COUNTERS:
            getattr(st, k).fill_(int(carry[k]))
        st.hcovf.fill_(bool(meta.get("hcovf", False)))
        st.n_front_h = int(meta["n_front"])
        return st

    def _restore_pin_interiors(self, res: CheckResult):
        """A checkpoint keeps a violation's invariant and state id only;
        the pinned-prefix interior states (state id -1, no archive row)
        are replayed from the cfg so a resumed run prints them as an
        uninterrupted one does."""
        bad = [v for v in res.violations if v.state_id < 0]
        if not bad or not self.cfg.prefix_pins:
            return
        _seeds, interiors = self.ir.prefix_pin_seeds(self.cfg,
                                                     with_interior=True)
        again = CheckResult()
        self._check_pin_interiors(interiors, again)
        for v, w in zip(bad, again.violations):
            v.state, v.hist = w.state, w.hist

    def _save_checkpoint(self, path, st: _Level, res: CheckResult, depth,
                         n_states, n_vis, n_front):
        """Read the level state back (at the level boundary, after the
        level's one read) and write it with the reference's meta; the
        port's HCAP and hard-lane counters ride as extra keys."""
        with self._obs.span("checkpoint"):
            parents, lanes, states, arch_meta = self._ckpt_store_args()
            h = self.hard_stats
            ckpt_write(path, self._carry_numpy(st), self.store_states,
                       parents, lanes, states, res, dict(
                           depth=depth, n_states=n_states, n_vis=n_vis,
                           n_front=n_front, LCAP=self.LCAP,
                           VCAP=self.VCAP, FCAP=self.FCAP,
                           OCAP=self.OCAP,
                           fam_caps=list(self.FAM_CAPS), **arch_meta,
                           layout=2, chunk=self.chunk, spec=self.ir.name,
                           sym_canon=self.fpr.sym_canon,
                           ir_fingerprint=self.ir.fingerprint(),
                           cfg=repr(self.cfg), HCAP=self.HCAP,
                           hard_lanes=h[0], hard_chunks=h[1],
                           hard_chunk_max=h[2], hcovf=bool(st.hcovf)),
                       keep=self.ckpt_keep)

    def _load_checkpoint(self, path):
        """(level state, result so far, meta) from a checkpoint of this
        engine's config, chunk, spec and canonicalization mode; the
        capacities become the checkpoint's."""
        z, meta = ckpt_read(path, repr(self.cfg), self.chunk,
                            ("LCAP", "VCAP", "FCAP", "OCAP", "fam_caps"),
                            sharded=False, expected_format=(
                                "layout", 2, "this engine's batch-last/"
                                "narrow-dtype storage layout"),
                            spec_name=self.ir.name,
                            sym_canon=self.fpr.sym_canon)
        template = self._carry_template()
        carry = ckpt_carry(path, z, template, np.asarray)
        self.LCAP, self.VCAP, self.FCAP, self.OCAP = (
            meta["LCAP"], meta["VCAP"], meta["FCAP"], meta["OCAP"])
        self.FAM_CAPS = tuple(int(c) for c in meta["fam_caps"])
        self.HCAP = int(meta.get("HCAP", self.HCAP))
        self.hard_stats = [int(meta.get(k, 0)) for k in
                           ("hard_lanes", "hard_chunks", "hard_chunk_max")]
        st = self._level_from_carry(path, carry, meta)
        del carry
        self._load_archives(path, z, meta, template)
        res = ckpt_result(z, meta)
        z.close()             # all arrays extracted; don't leak the fd
        return st, res, meta

    # ------------------------------------------------------------------
    # shape-portable resume (resil/portable.py)
    # ------------------------------------------------------------------

    def _restore_portable_archives(self, img):
        """The portable twin of ``_load_archives``: attach the archives
        a ``PortableImage`` carries (the in-RAM per-level lists, or a
        disk archive reattached and truncated).  The archive format is
        engine-agnostic, so archives cross engine families unchanged."""
        from .archive import ArchiveError, DiskArchive
        self._arch = None
        self._parents, self._lanes, self._states = [], [], []
        if not self.store_states:
            return
        if not img.store_states:
            raise CheckpointError(
                "portable image was written with store_states=False; "
                "resume with store_states=False (CLI: --no-store) — "
                "trace archives cannot be reconstructed")
        if img.disk_archive_levels is not None:
            if not self.archive_dir:
                raise CheckpointError(
                    f"{img.source_path}: image archives live in a "
                    "disk archive directory — resume with the same "
                    "archive_dir (CLI: --archive-dir)")
            try:
                self._arch = DiskArchive(self.archive_dir, attach=True)
                self._arch.truncate(img.disk_archive_levels)
            except ArchiveError as e:
                raise CheckpointError(str(e)) from e
            return
        if self.archive_dir:
            raise CheckpointError(
                f"{img.source_path}: image holds in-RAM archives; "
                "resume without archive_dir")
        self._parents = list(img.parents)
        self._lanes = list(img.lanes)
        self._states = [dict(s) for s in img.states]

    def _seed_table_from_keys(self, keys_np: np.ndarray) -> torch.Tensor:
        """[N, W] u32 visited keys -> a fresh table's flat buffer at
        the current VCAP, claim-inserted by the dedup kernel (its plain
        twin on the CPU).  Dedup needs membership, not the source's
        slot layout; the reference's lax claim walk places contended
        keys elsewhere."""
        flat = self._new_table(self.VCAP)
        if len(keys_np):
            keys = words_to_torch(np.ascontiguousarray(keys_np.T),
                                  self.device)
            live = torch.ones(keys.shape[1], dtype=torch.bool,
                              device=self.device)
            _f, _p, hv = probe_claim_insert(
                flat[:-1].view(self.W, self.VCAP), keys, live)
            if bool(hv):
                raise RuntimeError(
                    "portable-resume table seed probe overflow — raise "
                    "vcap")
        return flat

    def _resume_portable(self, img):
        """PortableImage -> (level state, result, depth, n_states,
        n_vis, n_front).  Refuses an image whose frontier gids are not
        contiguous (a spill-family image drops constraint-pruned rows;
        this engine's frontier is the whole last level under fmask),
        naming the engine that can host it."""
        from ..resil.portable import validate_image
        validate_image(img, self.ir.name, repr(self.cfg), self.W)
        n_front = img.n_front
        if n_front:
            gids = np.asarray(img.gids, np.int64)
            pg_off = int(gids[0])
            if not np.array_equal(
                    gids, pg_off + np.arange(n_front, dtype=np.int64)):
                raise CheckpointError(
                    f"{img.source_path}: portable image's frontier "
                    "gids are not contiguous (a spill-family image "
                    "drops constraint-pruned rows); this engine's "
                    "frontier layout needs the full last level — "
                    "resume it with the spill engine "
                    "(check --spill --resume F --resume-portable)")
        else:
            pg_off = img.n_states
        # capacities follow the fresh start's sizing (they shape
        # overflow replays, never counts)
        while self.LCAP - self.OCAP < 2 * max(n_front, 1):
            self.LCAP *= 2
        while img.n_vis + self.LCAP - self.OCAP > \
                self._LOAD_MAX * self.VCAP:
            self.VCAP *= 4
        self._restore_portable_archives(img)
        st = _Level(self, self.LCAP, self._seed_table_from_keys(img.keys))
        if n_front:
            rows = rows_to_torch({k: np.asarray(v)
                                  for k, v in img.rows.items()},
                                 self.device, self.ir.u32_keys)
            rows_n = self.ir.narrow(self.lay, rows)
            for k, v in st.front.items():
                v[..., :n_front] = rows_n[k]
            st.fmask[:n_front] = torch.from_numpy(
                np.asarray(img.con, bool)).to(self.device)
        st.n_front.fill_(n_front)
        st.n_front_h = n_front
        st.pg_off.fill_(pg_off)
        st.g_off.fill_(img.n_states)
        self.hard_stats = [0, 0, 0]
        return (st, img.fresh_result(), img.depth, img.n_states,
                img.n_vis, n_front)

    def _stamp_mode(self, res: CheckResult) -> CheckResult:
        """Record which expansion and dedup program this run executed,
        from the live engine (never from a checkpoint, so a resumed run
        reports the resuming engine's modes).  ``dedup_kernel`` is 1
        when the hand kernel ran (a CUDA device) and 0 for its plain
        twin on the CPU: the reference's ``auto`` reading, which engages
        its kernel on the accelerator only."""
        res.guard_matmul = int(self.guard_matmul)
        res.dedup_kernel = int(self.device.type == "cuda")
        res.delta_matmul = int(self.expander.delta_active)
        res.sym_canon = int(self.fpr.sym_canon == "sort")
        return res

    def _load_kernels(self, obs):
        """On the card, build (or load) the kernel library before the
        run: its first use in a process is a compile, as the reference's
        warm-up is, and gets the run's ``compile`` span."""
        if self.device.type == "cuda":
            from . import cuda_ext
            if not cuda_ext.loaded():
                with obs.span("compile"):
                    cuda_ext.library()

    def check(self, max_depth: int = 10 ** 9, max_states: int = 10 ** 9,
              stop_on_violation: bool = False,
              seed_states: Optional[List] = None,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 1,
              resume_from: Optional[str] = None,
              resume_image=None,
              verbose: bool = False, obs=None) -> CheckResult:
        """BFS from Init, from the cfg's prefix pins, or from
        ``seed_states``: (State, Hist) pairs or raw SoA dicts (the
        latter keep their non-VIEW lanes exactly: engine-emitted seeds
        for the punctuated search).

        checkpoint_path — write a checkpoint there every
        ``checkpoint_every`` levels (a burst that crosses a multiple
        writes one after it); resume_from — continue a checkpointed
        run, written by this engine or by the JAX package's (the final
        counts are those of an uninterrupted run; levels are never
        half-resumed).  resume_image — a ``resil.portable.PortableImage``
        of any engine family's checkpoint: its key set seeds the table
        and its gid-ordered frontier becomes the level state's.

        obs — an ``obs.Obs`` bundle (spans, JSONL ledger, heartbeat,
        profiler); every dispatch writes one ledger record and one
        heartbeat rewrite, so a killed run keeps its telemetry.  The
        spans sit at the reference's sites, on the host, never inside a
        captured program: ``compile`` (each graph's warm-up and capture,
        and the kernels' first-use build), ``burst_dispatch``,
        ``level_dispatch``, ``harvest``, ``archive_io``,
        ``checkpoint``."""
        obs = self._obs = obs if obs is not None else NULL_OBS
        t0 = time.perf_counter()
        t_dev = 0.0
        if resume_from is not None and resume_image is not None:
            raise ValueError(
                "resume_from and resume_image are mutually exclusive")
        self._load_kernels(obs)
        self._graphs = GraphRunner(self.device, self._capture, obs=obs)
        ring = None
        resumed = resume_from is not None or resume_image is not None
        if resume_from is not None:
            st, res, cmeta = self._load_checkpoint(resume_from)
            n_states, n_vis = cmeta["n_states"], cmeta["n_vis"]
            depth, n_front = cmeta["depth"], cmeta["n_front"]
            self._restore_pin_interiors(res)
        elif resume_image is not None:
            (st, res, depth, n_states, n_vis,
             n_front) = self._resume_portable(resume_image)
            self._restore_pin_interiors(res)
        else:
            self._init_store()
            self.hard_stats = [0, 0, 0]
            st, res = self._admit_roots(seed_states)
            n_states = 0
            n_vis = 0
            depth = 0

        def grow_table_if_needed(st, min_add=0):
            # pessimistic load bound: a level adds at most LCAP - OCAP
            # keys (a burst up to min_add)
            need = n_vis + max(st.lcap - self.OCAP, min_add)
            if need > self._LOAD_MAX * self.VCAP:
                while need > self._LOAD_MAX * self.VCAP:
                    self.VCAP *= 4
                st.set_table(self._rehash_tables(st.vis, self.VCAP))
                self._graphs.clear()

        def harvest(st, scal, inv_ok):
            nonlocal n_states, n_vis
            n_lvl, n_viol, faults = scal[:3]
            res.distinct_states += n_lvl
            res.overflow_faults += faults
            res.generated_states += scal[6]
            res.violations_global += n_viol
            rows = None
            if self.store_states or n_viol:
                rows = storage_rows_to_numpy(
                    {k: v[..., :n_lvl] for k, v in st.front.items()},
                    self.ir.u32_keys)
            if self.store_states:
                self._archive_level(st.lpar[:n_lvl].cpu().numpy().copy(),
                                    st.llane[:n_lvl].cpu().numpy().copy(),
                                    rows)
            if n_viol:
                bad = (~inv_ok).cpu().numpy()
                for j, nm in enumerate(self.inv_names):
                    for s in np.nonzero(bad[j])[0]:
                        vsv, vh = self.ir.decode(self.lay,
                                                 take_arrays(rows, s))
                        res.violations.append(
                            Violation(nm, n_states + int(s),
                                      state=vsv, hist=vh))
            n_states += n_lvl
            n_vis += n_lvl
            driver.guard_id_space(n_states)
            return st.n_front_h

        def harvest_burst(meta, stats, r):
            nonlocal n_states, depth
            arch = None
            if self.store_states or meta[3]:
                arch = (r.opar.cpu().numpy(), r.olane.cpu().numpy(),
                        storage_to_numpy(r.ost, self.ir.u32_keys),
                        r.oinv.cpu().numpy())

            def archive(li, n_lvl):
                if self.store_states:
                    self._archive_level(*driver.burst_archive_slice(
                        arch[0], arch[1], arch[2], li, n_lvl))

            def violations(li, n_lvl, gid_base):
                driver.burst_decode_violations(
                    res, self.ir, self.lay, self.inv_names, arch[3],
                    arch[2], li, n_lvl, gid_base)

            def visited(li, n_lvl):
                nonlocal n_vis
                n_vis += n_lvl

            depth, n_states = driver.harvest_fused_levels(
                res, meta[0], lambda li: stats[li, :5], depth, n_states,
                archive=archive, violations=violations, visited=visited)

        if not resumed:
            scal, inv_ok = self._finalize(st)
            n_front = harvest(st, scal, inv_ok)
        self._stamp_mode(res)

        def save(st):
            self._save_checkpoint(checkpoint_path, st, res, depth,
                                  n_states, n_vis, n_front)

        # a burst that committed levels and then bailed keeps the
        # bailing level's frontier: re-entering would bail again, so
        # that level runs on the per-level path, which re-arms the burst
        burst_ok = True
        while n_front and depth < max_depth and \
                res.distinct_states < max_states and \
                not (stop_on_violation and res.violations):
            # chaos site: a dispatch-time device error at the level
            # boundary (resil/chaos), raised before any device work, so
            # the last checkpoint and archives stay consistent and the
            # supervised runner resumes bit-exact
            chaos_point("dispatch")
            if self.burst and burst_ok and \
                    n_front <= self._burst_width():
                t1 = time.perf_counter()
                with obs.span("burst_dispatch"):
                    grow_table_if_needed(
                        st, min_add=self.burst_levels * self._burst_width())
                    if ring is None:
                        ring = _Ring(self, st)
                    meta, stats = self._burst(
                        st, ring, min(self.burst_levels, max_depth - depth),
                        max(1, min(max_states - res.distinct_states,
                                   2 ** 31 - 1)))
                res.burst_dispatches += 1
                res.burst_bailouts += meta[1]
                if meta[0]:
                    burst_ok = not meta[1]
                    n_front = meta[2]
                    d0 = depth
                    with obs.span("harvest"):
                        harvest_burst(meta, stats, ring)
                    t_dev += time.perf_counter() - t1
                    if checkpoint_path is not None and \
                            driver.ckpt_due_after_burst(
                                depth, d0, checkpoint_every):
                        save(st)
                    obs.dispatch(kind="burst", depth=depth,
                                 frontier=n_front,
                                 metrics=res.metrics.as_dict())
                    if verbose:
                        print(f"burst: {meta[0]} levels to depth {depth} "
                              f"(total {res.distinct_states}), frontier "
                              f"{n_front}, "
                              f"{time.perf_counter() - t1:.2f}s")
                    continue
            burst_ok = True
            depth += 1
            t1 = time.perf_counter()
            with obs.span("level_dispatch"):
                grow_table_if_needed(st)
                while True:
                    n_chunks = (n_front + self.chunk - 1) // self.chunk
                    key = self._graph_key("step", st)
                    for _ in range(n_chunks):
                        self._graphs.run(key, lambda: self._chunk_step(st))
                    scal, inv_ok = self._finalize(st)
                    ovf, fovf, hovf, oovf = (bool(scal[4]), bool(scal[5]),
                                             bool(scal[8]), bool(scal[9]))
                    hcovf = bool(scal[-2])
                    if not (ovf or fovf or hovf or oovf or hcovf):
                        break
                    # overflow: the table was rolled back and the frontier
                    # kept, so grow and replay the level exactly
                    self._graphs.clear()
                    old_caps = (self.LCAP, self.FCAP, self.OCAP)
                    self._grow_caps(oovf, fovf,
                                    scal[11:11 + len(self.FAM_CAPS)])
                    if ovf or self.LCAP < 4 * self.OCAP:
                        self.LCAP = self._round_cap(
                            max((4 * self.LCAP) if ovf else self.LCAP,
                                4 * self.OCAP))
                    if hcovf:
                        # a chunk had more hard lanes than the buffer holds
                        while self.HCAP < 2 * scal[-1]:
                            self.HCAP *= 2
                    if hovf:
                        # probe walk blew its round budget: table too full
                        self.VCAP *= 4
                        st.set_table(self._rehash_tables(st.vis, self.VCAP))
                    if verbose:
                        print(f"level {depth}: buffer overflow (ovf={ovf} "
                              f"fovf={fovf} hovf={hovf} oovf={oovf} "
                              f"hcovf={hcovf}), LCAP={self.LCAP} "
                              f"FCAP={self.FCAP} OCAP={self.OCAP} "
                              f"VCAP={self.VCAP} HCAP={self.HCAP}")
                    if (self.LCAP, self.FCAP, self.OCAP) != old_caps:
                        if self.LCAP != st.lcap:
                            st = self._grow(st, self.LCAP)
                        grow_table_if_needed(st)
            with obs.span("harvest"):
                n_front = harvest(st, scal, inv_ok)
            depth = driver.gate_level_depth(res, depth, scal[0], scal[6],
                                            scal[7])
            t_dev += time.perf_counter() - t1
            if checkpoint_path is not None and \
                    driver.ckpt_due_at_level(depth, checkpoint_every):
                save(st)
            obs.dispatch(kind="level", depth=depth, frontier=n_front,
                         metrics=res.metrics.as_dict())
            if verbose:
                print(f"depth {depth}: +{scal[0]} states (total "
                      f"{res.distinct_states}), frontier {n_front}, "
                      f"{n_chunks} chunks in "
                      f"{time.perf_counter() - t1:.2f}s")
        res.depth = depth
        res.hard_lanes, res.hard_chunks, res.hard_chunk_max = \
            self.hard_stats
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # the graphs hold their buffers' memory: drop them with the run
        self._graphs.clear()
        res.seconds = time.perf_counter() - t0
        res.phase_seconds["device_levels"] = t_dev
        return res

    # ------------------------------------------------------------------

    def get_state(self, gid: int) -> Tuple:
        return self.ir.decode(self.lay, self.get_state_arrays(gid))

    def get_state_arrays(self, gid: int) -> Dict[str, np.ndarray]:
        assert self.store_states, "state store disabled"
        if self._arch is not None:
            return self._arch.state_row(gid)
        off = 0
        for blk in self._states:
            n = len(next(iter(blk.values())))
            if gid < off + n:
                return take_arrays(blk, gid - off)
            off += n
        raise IndexError(gid)

    def trace(self, gid: int) -> List[Tuple]:
        if self._arch is not None:
            # memmap'd walk: each hop reads one parent/lane pair and
            # one state row — no level is ever loaded whole
            chain = []
            g = gid
            while g >= 0:
                par, lane = self._arch.parent_lane(g)
                label = self.labels[lane] if lane >= 0 else "Init"
                chain.append((label, self.get_state(g)[0]))
                g = par
            return list(reversed(chain))
        parents = np.concatenate(self._parents)
        lanes = np.concatenate(self._lanes)
        chain = []
        g = gid
        while g >= 0:
            lane = lanes[g]
            label = self.labels[lane] if lane >= 0 else "Init"
            chain.append((label, self.get_state(g)[0]))
            g = parents[g]
        return list(reversed(chain))
