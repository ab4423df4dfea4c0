"""Level-synchronous BFS engine: TLC's worker loop on a CUDA device.

The frontier, the candidate expansion, the visited set (an
open-addressing hash table in device memory), the dedup, the invariant
and constraint evaluation and the level buffer all live on the device;
the host keeps the counters and reads back a few scalars per chunk.

Per frontier chunk (``_chunk_step``): guard-first expansion over the
[B, A] lane grid (the int8 guard product by default), compaction of
the enabled lanes into the fixed-width FCAP candidate buffer with
successor materialization (the delta group for the affine families,
kernels for the rest), the symmetry-canonical fingerprint (incremental
from per-parent term tables where the fingerprinter supports it, else
direct: minperm, or orbit-sort with the hard lanes' min over every
permutation), claim-insert dedup into the visited table
(``fingerprint.probe_claim_insert`` — the CUDA kernel) gated by the
chunk's own overflow flag, then invariants and constraints on the
fresh rows and their append to the level buffer.  Nothing is read back
before the dedup launch; one read after it brings the enabled count,
the overflow flags and the probe budget, and the fresh rows' indices
are the second.  ``_finalize`` commits the level (the level buffer
becomes the frontier) or, when a buffer overflowed, rolls the visited
table back through the level's insert journal and leaves the frontier
intact, so the host can grow the capacity and replay the level.

This is the reference's per-level driver (``raft_tla_tpu/engine/
bfs.py``, ``burst=False``) with the same capacity model: ``chunk``
frontier rows per step, LCAP level rows (an OCAP append margin
reserved), FCAP enabled candidates per chunk, OCAP fresh rows per
chunk, VCAP table slots (a power of two, grown ×4 past load 0.40),
per-family caps, and in sort mode HCAP hard lanes per chunk (the
fallback's fixed-width buffer, so finding them needs no host sync);
any overflow replays the level with the cap grown.
State identity, first-seen order and global ids equal the
reference's: candidates are enumerated in ascending (row, lane) order
and the dedup resolves lanes in that order.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..convert import (rows_to_numpy, rows_to_torch, words_to_numpy,
                       words_to_torch)
from ..ops.codec import C_OVERFLOW
from ..spec import spec_of
from ..utils import (fmix32_int, fp_key, HOME_SALT, resolve_device,
                     take_arrays)
from . import driver
from .expand import Expander, compact_positions
from .fingerprint import probe_claim_insert, resolve_sym_canon

EMPTY = -1          # the all-ones u32 key, as int32: an empty table slot


@dataclass
class Violation:
    invariant: str
    state_id: int
    state: Optional[object] = None
    hist: Optional[object] = None


class CheckResult:
    """A run's counters (the reference's ``CheckResult`` names)."""

    def __init__(self, distinct_states: int = 0, generated_states: int = 0,
                 depth: int = 0):
        self.distinct_states = distinct_states
        self.generated_states = generated_states
        self.depth = depth
        self.overflow_faults = 0
        self.violations_global = 0
        self.violations: List[Violation] = []
        self.level_sizes: List[int] = []
        self.seconds = 0.0
        # 1 = orbit-sort canonical fingerprints, 0 = min-over-perms (the
        # resolved mode, as the reference reports it)
        self.sym_canon = 0
        # sort mode: hard lanes that took the min-over-perms fallback,
        # the chunks that had any, and the most in one chunk
        self.hard_lanes = self.hard_chunks = self.hard_chunk_max = 0

    def __repr__(self):
        return (f"CheckResult(distinct_states={self.distinct_states}, "
                f"generated_states={self.generated_states}, "
                f"depth={self.depth}, seconds={self.seconds:.3f}, "
                f"violations={len(self.violations)})")


def _ceil_log2(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


class _Level:
    """The per-level device buffers and counters (the reference's
    jit carry, held here as tensors plus host ints)."""

    def __init__(self, eng: "Engine", lcap: int, vis: torch.Tensor):
        dev = eng.device
        one = eng.ir.narrow(eng.lay, rows_to_torch(
            {k: v[None] for k, v in eng.ir.encode(
                eng.lay, *eng.ir.init_state(eng.cfg)).items()}, dev))
        self.vis = vis
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
        self.n_front = 0
        self.g_off = 0          # global state-id offset (this level)
        self.pg_off = 0         # global state-id offset (frontier)
        self.reset(len(eng.expander.families))

    @property
    def lcap(self) -> int:
        return self.lpar.shape[0]

    def reset(self, n_fams: int):
        self.n_lvl = 0
        self.n_gen = 0
        self.ovf = self.fovf = self.hovf = self.oovf = False
        self.hcovf = False      # more hard lanes in a chunk than HCAP
        self.hard = [0, 0, 0]   # hard lanes, chunks with any, chunk max
        self.famx = [0] * n_fams
        # the most enabled lanes per family in any chunk, on the device
        self.famx_d = torch.zeros(n_fams, dtype=torch.int32,
                                  device=self.fmask.device)
        self.ofx = 0            # max fresh rows in any chunk
        self.base = 0           # chunk cursor within the frontier

    @property
    def bad(self) -> bool:
        return self.ovf or self.fovf or self.hovf or self.oovf or \
            self.hcovf


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
    device   — "cuda" by default; "cpu" only when asked for.
    """

    _LOAD_MAX = 0.40

    def __init__(self, cfg: ModelConfig, chunk: int = 512,
                 store_states: bool = True,
                 lcap: int = 1 << 14, vcap: int = 1 << 17,
                 fcap: Optional[int] = None, ocap: Optional[int] = None,
                 incremental_fp: bool = True, sym_canon: str = "auto",
                 hcap: Optional[int] = None,
                 guard_matmul: bool = True, delta_matmul: bool = True,
                 delta_chunk_skip: Optional[bool] = None,
                 fam_density: Optional[Dict[str, int]] = None,
                 device: Optional[str] = None):
        if cfg.prefix_pins or cfg.action_constraints:
            raise NotImplementedError(
                "cfg prefix pins and ACTION_CONSTRAINTS are not ported "
                "yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ir = spec_of(cfg)
        self.chunk = max(16, int(chunk))
        self.store_states = store_states
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
        self.preds = self.ir.make_predicates(self.lay)
        self.inv_names = list(cfg.invariants)
        self.con_names = list(cfg.constraints)
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

    def _round_cap(self, n: int) -> int:
        c = self.chunk
        return ((int(n) + c - 1) // c) * c

    # ------------------------------------------------------------------
    # invariants + constraints on batch-last rows
    # ------------------------------------------------------------------

    def _phase2_T(self, svT):
        """inv bool [n_inv, N], con bool [N]."""
        der = self.kern.derived(svT)
        N = svT["ct"].shape[-1]
        inv = torch.stack([self.preds.invariant_fn(nm)(svT, der)
                           for nm in self.inv_names]) \
            if self.inv_names else torch.ones((0, N), dtype=torch.bool,
                                              device=self.device)
        con = torch.ones(N, dtype=torch.bool, device=self.device)
        for nm in self.con_names:
            con = con & self.preds.constraint_fn(nm)(svT, der)
        return inv, con

    # ------------------------------------------------------------------
    # the visited table
    # ------------------------------------------------------------------

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
        ascending slot order, into a fresh table of ``new_vcap``."""
        keys = vis[:, ~(vis == EMPTY).all(0)].contiguous()
        new = torch.full((self.W, new_vcap), EMPTY, dtype=torch.int32,
                         device=self.device)
        live = torch.ones(keys.shape[1], dtype=torch.bool,
                          device=self.device)
        _fresh, _pos, hv = probe_claim_insert(new, keys, live)
        if bool(hv):
            raise RuntimeError("rehash did not converge — table "
                               "pathologically full; raise vcap")
        return new

    # ------------------------------------------------------------------
    # one frontier chunk
    # ------------------------------------------------------------------

    def _chunk_step(self, st: _Level):
        """Expand frontier[base:base+chunk], fingerprint, dedup into the
        visited table, evaluate invariants/constraints on the fresh
        rows and append them to the level buffer."""
        B, A = self.chunk, self.A
        FCAP = self.FCAP
        base = st.base
        st.base += B
        if base >= st.n_front:
            return
        # a fixed B-row window (LCAP is a multiple of the chunk); rows
        # past the frontier are masked out of the lane grid
        sv = self.ir.widen({k: v[..., base:base + B]
                            for k, v in st.front.items()})
        valid = st.fmask[base:base + B] & (
            torch.arange(B, device=self.device) < st.n_front - base)
        derb = self.kern.derived(sv)
        okf = (self.expander.guards_T(sv, derb) &
               valid[:, None]).reshape(-1)
        if st.bad:
            # the level replays: insert nothing, so the journal stays
            # the exact record of this level's table writes, but keep
            # the per-family maxima the replay sizes its caps from
            st.famx_d = torch.maximum(st.famx_d,
                                      self.expander.family_counts(okf))
            return
        # enabled lanes in ascending (row, lane) order = the oracle's
        # successor enumeration order, at fixed positions in FCAP
        epos, n_e = compact_positions(okf, FCAP)
        elive = torch.arange(FCAP, device=self.device) < n_e
        n_hard = None
        if self.incremental_fp and self.fpr.supports_incremental():
            tables = self.fpr.parent_tables(sv)
            cand, counts, keys = self.expander.materialize(
                sv, derb, okf, epos, FCAP, self.FAM_CAPS,
                delta_fp=(self.fpr, tables))
        else:
            cand, counts = self.expander.materialize(
                sv, derb, okf, epos, FCAP, self.FAM_CAPS)
            # columns past n_e are garbage: they must not count as hard
            # lanes, or they would fill the fallback's buffer
            keys, n_hard = self.fpr.fingerprint_chunk_T(cand, self.HCAP,
                                                        live=elive)
        st.famx_d = torch.maximum(st.famx_d, counts)
        # a chunk whose enabled lanes overflow FCAP or a family cap has
        # an incomplete buffer: it inserts nothing and the level replays
        fovf = (n_e > FCAP) | (counts > self._caps_t()).any()
        fresh, pos, hv = probe_claim_insert(st.vis, keys, elive & ~fovf)
        # the step's one read: probe budget, hard lanes, enabled count,
        # overflow flag and the per-family maxima
        none = torch.full((1,), -1, dtype=torch.int64, device=self.device)
        got = torch.cat([hv.reshape(1).to(torch.int64),
                         none if n_hard is None
                         else n_hard.reshape(1).to(torch.int64),
                         n_e.reshape(1).to(torch.int64),
                         fovf.reshape(1).to(torch.int64),
                         st.famx_d.to(torch.int64)]).tolist()
        hv, nh, n_e, fovf = got[:4]
        st.famx = got[4:]
        if fovf:
            st.fovf = True
            return
        st.n_gen += n_e
        st.hovf |= bool(hv)
        hcovf_now = False
        if nh >= 0:
            st.hard = [st.hard[0] + nh, st.hard[1] + (nh > 0),
                       max(st.hard[2], nh)]
            hcovf_now = nh > self.HCAP
        fidx = fresh.nonzero().squeeze(1)
        n_fresh = fidx.shape[0]
        # the chunk-local overflows share the revert path: level buffer
        # full (ovf; the margin is OCAP), fresh rows past OCAP, and hard
        # lanes past HCAP (some keys were not canonical)
        ovf_now = st.n_lvl + n_fresh > st.lcap - self.OCAP
        oovf_now = n_fresh > self.OCAP
        if ovf_now or oovf_now or hcovf_now:
            st.vis[:, pos[fidx].long()] = EMPTY
            st.ovf |= ovf_now
            st.oovf |= oovf_now
            st.hcovf |= hcovf_now
            return
        if n_fresh == 0:
            return
        rows = {k: v[..., fidx] for k, v in cand.items()}
        inv, con = self._phase2_T(rows)
        rows_n = self.ir.narrow(self.lay, rows)
        s, e = st.n_lvl, st.n_lvl + n_fresh
        for k, v in st.lvl.items():
            v[..., s:e] = rows_n[k]
        # buffer slot -> flat lane: the fresh slots' enabled lanes
        lane = self._slot_lanes(epos, FCAP)[fidx]
        st.lpar[s:e] = (st.pg_off + base + lane // A).to(torch.int32)
        st.llane[s:e] = (lane % A).to(torch.int32)
        st.jslot[s:e] = pos[fidx]
        st.linv[:, s:e] = inv
        st.lcon[s:e] = con
        st.n_lvl = e
        st.ofx = max(st.ofx, n_fresh)

    def _caps_t(self) -> torch.Tensor:
        """FAM_CAPS as a device tensor (copied once per value: the caps
        change only between levels)."""
        if self._caps_dev[0] != self.FAM_CAPS:
            self._caps_dev = (self.FAM_CAPS, torch.tensor(
                self.FAM_CAPS, dtype=torch.int32, device=self.device))
        return self._caps_dev[1]

    @staticmethod
    def _slot_lanes(epos: torch.Tensor, fcap: int) -> torch.Tensor:
        """Buffer slot -> flat lane id [fcap] (slots past the enabled
        count hold the grid size)."""
        N = epos.shape[0]
        out = torch.full((fcap + 1,), N, dtype=torch.int64,
                         device=epos.device)
        return out.scatter_(0, epos.long(), torch.arange(
            N, device=epos.device))[:fcap]

    # ------------------------------------------------------------------
    # per-level finalize: commit, or roll the table back via the journal
    # ------------------------------------------------------------------

    def _finalize(self, st: _Level) -> Tuple[List[int], torch.Tensor]:
        """Returns (scal, inv_ok): scal = [n_lvl, n_viol, faults,
        n_front, ovf, fovf, n_gen, n_expand, hovf, oovf, ofx] + famx,
        the reference's per-level scalar row, + [hcovf, the most hard
        lanes in one chunk]."""
        n_lvl = st.n_lvl
        inv_ok = st.linv[:, :n_lvl]
        con = st.lcon[:n_lvl]
        n_viol = int((~inv_ok).sum())
        faults = int((st.lvl["ctr"][C_OVERFLOW, :n_lvl] > 0).sum())
        n_expand = int(con.sum())
        if st.bad:
            # chunks after the overflow only updated the device maxima
            st.famx = st.famx_d.tolist()
            # clear exactly the journaled inserts; a cleared cohort
            # postdates every surviving key, so it cannot sit on a
            # surviving key's probe path
            st.vis[:, st.jslot[:n_lvl].long()] = EMPTY
        else:
            # the level buffer BECOMES the frontier; constraint-pruned
            # rows stay in place, masked out of expansion by fmask
            st.front, st.lvl = st.lvl, st.front
            st.fmask = torch.zeros_like(st.fmask)
            st.fmask[:n_lvl] = con
            st.n_front = n_lvl
            st.pg_off = st.g_off
            st.g_off += n_lvl
            h = self.hard_stats
            self.hard_stats = [h[0] + st.hard[0], h[1] + st.hard[1],
                               max(h[2], st.hard[2])]
        scal = [n_lvl, n_viol, faults, st.n_front, int(st.ovf),
                int(st.fovf), st.n_gen, n_expand, int(st.hovf),
                int(st.oovf), st.ofx] + list(st.famx) + \
            [int(st.hcovf), st.hard[2]]
        st.reset(len(self.expander.families))
        return scal, inv_ok

    def _grow(self, st: _Level, lcap: int) -> _Level:
        """Re-home the frontier and the table into a level state of
        ``lcap`` rows (the level buffer is reset; callers replay)."""
        new = _Level(self, lcap, st.vis)
        n = st.lcap
        for k, v in st.front.items():
            new.front[k][..., :n] = v
        new.fmask[:n] = st.fmask
        new.n_front, new.g_off, new.pg_off = st.n_front, st.g_off, st.pg_off
        return new

    # ------------------------------------------------------------------

    def _dedup_roots(self):
        """Init state -> (roots numpy SoA [n, ...], keys u32 [n, W]):
        first-seen fingerprint dedup of the seed set."""
        roots = self.ir.encode(self.lay, *self.ir.init_state(self.cfg))
        roots = {k: np.asarray(v)[None] for k, v in roots.items()}
        fp = self.fpr.fingerprint_batch_T(rows_to_torch(roots,
                                                        self.device))
        rk = words_to_numpy(fp).T                              # [n, W]
        _u, first = np.unique(fp_key(rk), return_index=True)
        first.sort()
        return take_arrays(roots, first), rk[first]

    def _archive_level(self, st: _Level, n_lvl: int):
        self._parents.append(st.lpar[:n_lvl].cpu().numpy().copy())
        self._lanes.append(st.llane[:n_lvl].cpu().numpy().copy())
        self._states.append(rows_to_numpy(
            {k: v[..., :n_lvl] for k, v in st.front.items()}))

    def check(self, max_depth: int = 10 ** 9, max_states: int = 10 ** 9,
              stop_on_violation: bool = False,
              verbose: bool = False) -> CheckResult:
        t0 = time.perf_counter()
        self._states, self._parents, self._lanes = [], [], []
        self.hard_stats = [0, 0, 0]
        roots, rk = self._dedup_roots()
        n_roots = len(rk)
        res = CheckResult(generated_states=n_roots)
        while self.LCAP - self.OCAP < 2 * n_roots:
            self.LCAP *= 2
        while n_roots + self.LCAP - self.OCAP > \
                self._LOAD_MAX * self.VCAP:
            self.VCAP *= 4
        vis = torch.full((self.W, self.VCAP), EMPTY, dtype=torch.int32,
                         device=self.device)
        st = _Level(self, self.LCAP, vis)
        # roots enter through the same admit path as every level: host
        # placement into the empty table, then finalize
        rows = rows_to_torch(roots, self.device)
        rows_n = self.ir.narrow(self.lay, rows)
        for k, v in st.lvl.items():
            v[..., :n_roots] = rows_n[k]
        slots = torch.from_numpy(self._host_probe_assign(rk)).to(
            self.device)
        st.vis[:, slots.long()] = words_to_torch(rk.T, self.device)
        st.jslot[:n_roots] = slots
        st.n_lvl = n_roots
        inv_r, con_r = self._phase2_T(rows)
        st.linv[:, :n_roots] = inv_r
        st.lcon[:n_roots] = con_r
        n_states = 0
        n_vis = 0
        depth = 0

        def grow_table_if_needed(st):
            # pessimistic load bound: a level adds at most LCAP - OCAP
            need = n_vis + st.lcap - self.OCAP
            if need > self._LOAD_MAX * self.VCAP:
                while need > self._LOAD_MAX * self.VCAP:
                    self.VCAP *= 4
                st.vis = self._rehash_tables(st.vis, self.VCAP)

        def harvest(st, scal, inv_ok):
            nonlocal n_states, n_vis
            n_lvl, n_viol, faults = scal[:3]
            res.distinct_states += n_lvl
            res.overflow_faults += faults
            res.generated_states += scal[6]
            res.violations_global += n_viol
            if self.store_states:
                self._archive_level(st, n_lvl)
            if n_viol:
                rows = rows_to_numpy({k: v[..., :n_lvl]
                                     for k, v in st.front.items()})
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
            return st.n_front

        scal, inv_ok = self._finalize(st)
        n_front = harvest(st, scal, inv_ok)
        while n_front and depth < max_depth and \
                res.distinct_states < max_states and \
                not (stop_on_violation and res.violations):
            depth += 1
            t1 = time.perf_counter()
            grow_table_if_needed(st)
            while True:
                n_chunks = (n_front + self.chunk - 1) // self.chunk
                for _ in range(n_chunks):
                    self._chunk_step(st)
                scal, inv_ok = self._finalize(st)
                ovf, fovf, hovf, oovf = (bool(scal[4]), bool(scal[5]),
                                         bool(scal[8]), bool(scal[9]))
                hcovf = bool(scal[-2])
                if not (ovf or fovf or hovf or oovf or hcovf):
                    break
                # overflow: the table was rolled back and the frontier
                # kept, so grow and replay the level exactly
                old_caps = (self.LCAP, self.FCAP, self.OCAP)
                if oovf:
                    self.OCAP = self._round_cap(
                        min(self.FCAP, 2 * self.OCAP))
                if fovf:
                    famx = scal[11:11 + len(self.FAM_CAPS)]
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
                    st.vis = self._rehash_tables(st.vis, self.VCAP)
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
            n_front = harvest(st, scal, inv_ok)
            depth = driver.gate_level_depth(res, depth, scal[0], scal[6],
                                            scal[7])
            if verbose:
                print(f"depth {depth}: +{scal[0]} states (total "
                      f"{res.distinct_states}), frontier {n_front}, "
                      f"{n_chunks} chunks in "
                      f"{time.perf_counter() - t1:.2f}s")
        res.depth = depth
        res.sym_canon = int(self.fpr.sym_canon == "sort")
        res.hard_lanes, res.hard_chunks, res.hard_chunk_max = \
            self.hard_stats
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        res.seconds = time.perf_counter() - t0
        return res

    # ------------------------------------------------------------------

    def get_state(self, gid: int) -> Tuple:
        return self.ir.decode(self.lay, self.get_state_arrays(gid))

    def get_state_arrays(self, gid: int) -> Dict[str, np.ndarray]:
        assert self.store_states, "state store disabled"
        off = 0
        for blk in self._states:
            n = len(next(iter(blk.values())))
            if gid < off + n:
                return take_arrays(blk, gid - off)
            off += n
        raise IndexError(gid)

    def trace(self, gid: int) -> List[Tuple]:
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
