"""Host-spill BFS engine: levels stream through host RAM, past the depth
at which a level's buffers fit the card (the reference's
``raft_tla_tpu/engine/spill.py``).

The classic ``Engine`` keeps the frontier and the level buffer on the
device.  This engine keeps there only the visited table and two
segment buffers — a frontier segment being expanded and a level
segment being filled:

- the frontier lives in host RAM as a list of narrow batch-last blocks
  (numpy, the reference's dtypes); a segment of up to SEGF rows is
  uploaded whole, one segment ahead of the one being expanded, on a
  copy stream from pinned host memory, and copied into the static
  frontier buffer once the compute stream has waited for it;
- fresh states append to the level segment on the device; when it
  fills, or the level ends, its rows are cloned on the compute stream
  and copied into pinned host buffers on the copy stream (the clone is
  ``record_stream``-ed, so the allocator keeps it until the copy
  ends); the host reads them only after the copy's event, and the
  block becomes the next frontier and the trace archive;
- the chunk step (``_spill_step``) reads nothing back and runs as a
  captured CUDA graph on the card; the host reads one small summary of
  the step's counters and flags every ``sync_every`` chunks, one
  window late, through a pinned buffer and an event.

Overflow recovery is chunk-local (earlier segments have left the
device, so the classic engine's whole-level replay is impossible): a
chunk that trips any overflow — the level segment full (ovf), the
family or candidate caps (fovf), the sort-mode hard lanes (hcovf), the
probe budget (hovf), the fresh-row buffer (oovf) — reverts its own
table inserts and leaves no trace, and every later chunk of the window
sees the sticky flag and does nothing.  The host fixes the cause
(spill the segment, grow the caps, grow and rehash the table), clears
the flags and resumes at the recorded chunk, so enumeration order, the
counts and the first-seen survivors equal the classic engine's and the
oracle's.

Constraint semantics stay prune-not-expand: pruned rows are counted,
invariant-checked and archived, then dropped on the host when the next
frontier is assembled.

With ``host_table`` the authoritative visited set lives in host RAM as
fingerprint-prefix partitions (``engine/host_table.py``), swept through
the device once per level: the device table becomes a cache, complete
over the running level and reseeded with the frontier's keys when it
outgrows ``dev_keys``, and the sweep drops rows an earlier level
already holds.  While the frontier fits the burst ring (and no sweep
is due), whole levels run fused on the device (``Engine._burst_loop``).

Checkpoints are the reference's spill files (``spill=True`` in the
meta, a sparse visited table, the frontier blocks, the host partitions'
sparse images), so a file either package writes resumes in the other;
``check(resume_image=)`` resumes any engine family's checkpoint through
``resil/portable.py``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..convert import rows_to_torch, storage_to_numpy, words_to_numpy
from ..obs import NULL_OBS
from ..ops.codec import C_OVERFLOW
from ..resil.chaos import chaos_point
from ..utils import home_slots
from . import driver
from .bfs import (EMPTY, CheckResult, Engine, Violation, _Ring, _hard_add,
                  _scalar)
from .ckpt import CheckpointError, ckpt_read, ckpt_result, ckpt_write
from .fingerprint import MAX_PROBE_ROUNDS, probe_claim_insert
from .graph import GraphRunner
from .host_table import HostPartitionedTable, insert_np

# the host's summary of the step's counters, read once per window:
# the reference's layout, then the family maxima, then the sort-mode
# hard-lane overflow and the most hard lanes in one chunk
(S_NLVL, S_NGEN, S_OVF, S_FOVF, S_HOVF, S_OOVF, S_TRIP, S_OFX,
 S_LEN) = range(9)

# the device probe's rounds between two reads of its active flag
_MEMBER_BLOCK = 8


def _np_to_t(a: np.ndarray) -> torch.Tensor:
    """A storage-dtype numpy array as a CPU tensor (u32 as int32 bits),
    aliasing it."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a)


def _t_to_np(t: torch.Tensor, u32: bool = False) -> np.ndarray:
    """A CPU tensor as an owned numpy array (int32 bits as uint32 when
    ``u32``): ``.numpy()`` aliases, and the source may be reused."""
    a = t.numpy().copy()
    return a.view(np.uint32) if u32 else a


class _SpillLevel:
    """The spill engine's device state (the reference's spill carry):
    the visited table (a flat buffer with a spare slot, as ``_Level``'s),
    the level segment with its parents, lanes, verdicts and (host-table
    mode) fingerprints, the frontier segment with its global ids, and
    every count and flag as a 0-d device tensor updated in place."""

    def __init__(self, eng: "SpillEngine", table: torch.Tensor):
        dev = eng.device
        self.W = eng.W
        self.one = eng.ir.narrow(eng.lay, rows_to_torch(
            {k: v[None] for k, v in eng.ir.encode(
                eng.lay, *eng.ir.init_state(eng.cfg)).items()}, dev,
            eng.ir.u32_keys))
        self.set_table(table)
        self.front = {k: torch.zeros(v.shape[:-1] + (eng.SEGF,),
                                     dtype=v.dtype, device=dev)
                      for k, v in self.one.items()}
        self.gids = torch.full((eng.SEGF,), -1, dtype=torch.int32,
                               device=dev)
        (self.n_front, self.base, self.n_lvl, self.n_gen, self.ofx,
         self.hmax) = (_scalar(dev) for _ in range(6))
        self.trip_base = torch.full((), -1, dtype=torch.int64, device=dev)
        self.ovf, self.fovf, self.hovf, self.oovf, self.hcovf = (
            _scalar(dev, torch.bool) for _ in range(5))
        self.famx = torch.zeros(len(eng.expander.families),
                                dtype=torch.int32, device=dev)
        self.hard = torch.zeros(3, dtype=torch.int64, device=dev)
        self.alloc_level(eng)

    def alloc_level(self, eng: "SpillEngine"):
        """Fresh level-segment buffers at the engine's current SEGL."""
        dev, segl = eng.device, eng.SEGL
        self.lvl = {k: torch.zeros(v.shape[:-1] + (segl,), dtype=v.dtype,
                                   device=dev) for k, v in self.one.items()}
        self.lpar = torch.full((segl,), -1, dtype=torch.int32, device=dev)
        self.llane = torch.full((segl,), -1, dtype=torch.int32, device=dev)
        self.linv = torch.ones((len(eng.inv_names), segl), dtype=torch.bool,
                               device=dev)
        self.lcon = torch.ones(segl, dtype=torch.bool, device=dev)
        self.lfp = (torch.full((eng.W, segl), EMPTY, dtype=torch.int32,
                               device=dev) if eng.host_table else None)
        self.n_lvl.zero_()

    def set_table(self, flat: torch.Tensor):
        self.vis_flat = flat
        self.vis = flat[:-1].view(self.W, -1)

    @property
    def lcap(self) -> int:
        return self.lpar.shape[0]

    @property
    def segf(self) -> int:
        return self.gids.shape[0]

    @property
    def vcap(self) -> int:
        return self.vis.shape[1]

    @property
    def flags(self):
        return self.ovf, self.fovf, self.hovf, self.oovf, self.hcovf

    def summary(self) -> torch.Tensor:
        """The host's view of the counters and flags, one int64 vector."""
        return torch.cat([
            torch.stack([self.n_lvl, self.n_gen, self.ovf.long(),
                         self.fovf.long(), self.hovf.long(),
                         self.oovf.long(), self.trip_base, self.ofx]),
            self.famx.long(), torch.stack([self.hcovf.long(), self.hmax])])


class SpillEngine(Engine):
    """Engine whose frontier and level buffers stream through host RAM.

    chunk      — frontier states expanded per chunk step.
    seg        — level and frontier segment capacity (states).
    vcap       — initial visited-table slots (grows by rehash).
    sync_every — chunks between summary reads (a trip replays at most
                 this many chunks).
    host_table — the host-partitioned visited table
                 (``engine/host_table.py``): ``partitions`` prefix
                 partitions of ``part_cap`` initial slots; the device
                 table becomes a cache reseeded past ``dev_keys`` keys
                 (default: its load bound); ``sweep_stage`` uploads the
                 next sweep's first images at level start.
    The remaining arguments are ``Engine``'s.  ``device`` is "cuda"
    unless the caller asks for "cpu".
    """

    _SWEEP_STAGE_DEPTH = 2
    _SPILL_EXTRA_KEYS = ("SEGL", "SEGF", "VCAP", "FCAP", "OCAP",
                         "fam_caps", "n_fblk")

    def __init__(self, cfg: ModelConfig, chunk: int = 2048,
                 store_states: bool = False, seg: int = 1 << 21,
                 vcap: int = 1 << 22, fcap: Optional[int] = None,
                 ocap: Optional[int] = None, sync_every: int = 8,
                 host_table: bool = False, partitions: int = 4,
                 part_cap: int = 1 << 12,
                 dev_keys: Optional[int] = None,
                 sweep_stage: bool = True,
                 burst: bool = True,
                 burst_levels: Optional[int] = None,
                 archive_dir: Optional[str] = None,
                 guard_matmul: bool = True,
                 delta_matmul: bool = True,
                 fam_density: Optional[Dict[str, int]] = None,
                 sym_canon: str = "auto",
                 incremental_fp: bool = True,
                 hcap: Optional[int] = None,
                 device: Optional[str] = None):
        super().__init__(cfg, chunk=chunk, store_states=store_states,
                         lcap=seg, vcap=vcap, fcap=fcap, ocap=ocap,
                         incremental_fp=incremental_fp, burst=burst,
                         burst_levels=burst_levels, sym_canon=sym_canon,
                         hcap=hcap, guard_matmul=guard_matmul,
                         delta_matmul=delta_matmul,
                         fam_density=fam_density,
                         archive_dir=archive_dir, device=device)
        self.SEGL = self.LCAP          # level segment rows (can grow)
        self.SEGF = self.LCAP          # frontier segment rows (fixed)
        self.sync_every = max(1, int(sync_every))
        self.host_table = bool(host_table)
        self.partitions = int(partitions)
        self.part_cap = int(part_cap)
        self.VCAP0 = self.VCAP         # a reseed resets the cache here
        self.dev_keys = (int(dev_keys) if dev_keys
                         else int(self._LOAD_MAX * self.VCAP))
        self.hpt = None                # built per check() or resume
        self.sweep_stage = bool(sweep_stage)
        self._sweep_staged = {}        # partition -> (image, version)
        self._staged_for = None
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._reset_counters()

    def _reset_counters(self):
        """The run's transfer and host-time counters (``chip_smoke.py``
        and ``tools/torch_profile.py`` read them)."""
        self.sweep_stage_hits = 0      # sweeps served from a prestage
        self.sweep_stage_misses = 0    # inline uploads
        self.segments_spilled = 0      # level-segment blocks sent down
        self.segments_by_level = {}    # depth -> blocks of that level
        self.trips = defaultdict(int)  # overflow kind -> chunk trips
        self.bytes_down = 0            # device -> host
        self.bytes_up = 0              # host -> device
        self.summary_syncs = 0         # summary reads
        self.reseeds = 0               # device-cache reseeds
        self.host_seconds = defaultdict(float)

    @contextmanager
    def _span(self, name: str):
        """Host time of one kind of work (sync, d2h, h2d, harvest,
        sweep, reseed, checkpoint), summed over the run; the sweep's
        device probe (sweep_probe) and its host claim-insert
        (sweep_commit) are also counted apart, inside sweep."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.host_seconds[name] += time.perf_counter() - t

    # ------------------------------------------------------------------
    # the chunk step (the reference's _spill_step_impl)
    # ------------------------------------------------------------------

    def _graph_key(self, kind: str, st):
        return super()._graph_key(kind, st) + (st.segf if kind == "spill"
                                               else 0, self.host_table)

    def _spill_step(self, st: _SpillLevel):
        """One frontier chunk of the segment at the device cursor: the
        shared front half, the dedup launch, the invariants and
        constraints on the fresh rows and their append to the level
        segment.  A chunk that trips an overflow reverts its own inserts
        and records its cursor in ``trip_base``.  Reads nothing back.
        Differs from ``Engine._chunk_step`` in: no fmask (pruned rows
        never enter the frontier), parent ids from the segment's
        ``gids``, the fingerprints appended in host-table mode, and the
        chunk-local trip."""
        FCAP, OCAP = self.FCAP, self.OCAP
        SEGL, SEGF, dev = st.lcap, st.segf, self.device
        rows, _win, sv = self._gather_window(st, SEGF)
        valid = rows < st.n_front
        cand, elive, keys, lanes, counts, n_e, n_gen, n_hard = \
            self._expand_fp_chunk(sv, valid, FCAP)
        torch.maximum(st.famx, counts, out=st.famx)
        fovf_now = (n_e > FCAP) | (counts > self._caps_t()).any()
        if n_hard is not None:
            nh = n_hard.long()
            torch.maximum(st.hmax, nh, out=st.hmax)
            hc_now = nh > self.HCAP
        else:
            hc_now = torch.zeros((), dtype=torch.bool, device=dev)
        gate = ~(st.ovf | st.fovf | st.hovf | st.oovf | st.hcovf)
        fresh, pos, hv = probe_claim_insert(
            st.vis, keys, elive & gate & ~fovf_now & ~hc_now)
        n_fresh = fresh.sum()
        ovf_now = gate & (st.n_lvl + n_fresh > SEGL - OCAP)
        oovf_now = gate & (n_fresh > OCAP)
        fovf_now = gate & fovf_now
        hc_now = gate & hc_now
        hovf_now = gate & hv
        bad_now = fovf_now | hc_now | hovf_now | ovf_now | oovf_now
        # the tripping chunk leaves no trace: the host replays it
        self._clear_slots(st, pos, fresh & bad_now)
        fresh = fresh & ~bad_now
        n_fresh = torch.where(bad_now, 0, n_fresh)
        commit = gate & ~bad_now
        st.n_gen += torch.where(commit, n_gen, 0)
        if n_hard is not None:
            st.hard.copy_(_hard_add(st.hard, torch.where(commit, nh, 0)))
        st.trip_base.copy_(torch.where(bad_now, st.base, st.trip_base))
        # parent ids: the uploaded per-row global ids (the host dropped
        # the pruned rows, so pg_off + row no longer holds); in
        # host-table mode the rows' fingerprints ride the spill, for the
        # level-end sweep and the cache reseed
        self._append_fresh(
            st, fresh, n_fresh, cand, lanes,
            lambda prow: st.gids.index_select(0, prow.clamp(max=SEGF - 1)),
            () if st.lfp is None else ((st.lfp, 1, keys),))
        st.ovf |= ovf_now
        st.fovf |= fovf_now
        st.hcovf |= hc_now
        st.hovf |= hovf_now
        st.oovf |= oovf_now

    def _run_step(self, st: _SpillLevel):
        self._graphs.run(self._graph_key("spill", st),
                         lambda: self._spill_step(st))

    def _read_summary(self, st: _SpillLevel):
        """Start the summary's copy to the host; returns a callable that
        waits for it and gives the numpy vector."""
        snap = st.summary()
        if self._copy is None:
            return lambda: snap.numpy().copy()
        host = torch.empty(snap.shape, dtype=snap.dtype, pin_memory=True)
        host.copy_(snap, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()

        def get():
            ev.synchronize()
            return host.numpy().copy()
        return get

    # ------------------------------------------------------------------
    # host-side level plumbing: segment transfers
    # ------------------------------------------------------------------

    def _spill_segment(self, st: _SpillLevel, n_lvl: int):
        """Start the copy of the level segment's first ``n_lvl`` rows to
        the host and reset the device cursor.  Returns a pending block
        (None when empty) that ``_materialize_blk`` resolves."""
        blk = None
        if n_lvl:
            with self._span("d2h"):
                dev = dict(rows={k: v[..., :n_lvl].clone()
                                 for k, v in st.lvl.items()},
                           lpar=st.lpar[:n_lvl].clone(),
                           llane=st.llane[:n_lvl].clone(),
                           linv=st.linv[:, :n_lvl].clone(),
                           lcon=st.lcon[:n_lvl].clone())
                if st.lfp is not None:
                    dev["lfp"] = st.lfp[:, :n_lvl].clone()
                blk = dict(n=n_lvl, _host=self._to_host(dev))
                self.segments_spilled += 1
        st.n_lvl.zero_()
        return blk

    def _to_host(self, dev):
        """Device tensors (a dict, with the rows one level down) ->
        (host tensors, event): on the card a non-blocking copy into
        pinned buffers on the copy stream, after the compute stream's
        work so far; the clones stay with the allocator until the copy
        ends."""
        leaves = [(dev["rows"], k) for k in dev["rows"]] + \
            [(dev, k) for k in dev if k != "rows"]
        self.bytes_down += sum(d[k].numel() * d[k].element_size()
                               for d, k in leaves)
        if self._copy is None:
            return dev, None
        self._copy.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._copy):
            for d, k in leaves:
                t = d[k]
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(self._copy)
                d[k] = h
            ev = torch.cuda.Event()
            ev.record(self._copy)
        return dev, ev

    def _materialize_blk(self, blk):
        """Resolve a pending block to host numpy in the reference's
        layout (rows batch-last in the storage dtypes, the u32 word keys
        as uint32; fingerprints uint32), as owned arrays; idempotent."""
        if blk is None or "_host" not in blk:
            return blk
        host, ev = blk.pop("_host")
        with self._span("d2h"):
            if ev is not None:
                ev.synchronize()
            blk["rows"] = {k: _t_to_np(v, k in self.ir.u32_keys)
                           for k, v in host["rows"].items()}
            for k in ("lpar", "llane", "linv", "lcon"):
                blk[k] = _t_to_np(host[k])
            if "lfp" in host:
                blk["lfp"] = _t_to_np(host["lfp"], True)
        return blk

    def _upload(self, arrs: Dict[str, np.ndarray]):
        """Numpy arrays -> (device tensors, event): on the card a
        non-blocking copy from pinned memory on the copy stream (the
        compute stream waits on the event before it reads them); on the
        CPU tensors that alias the arrays."""
        out = {k: _np_to_t(v) for k, v in arrs.items()}
        self.bytes_up += sum(v.numel() * v.element_size()
                             for v in out.values())
        if self._copy is None:
            return out, None
        dev = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
               for k, v in out.items()}
        self._copy.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._copy):
            for k, v in out.items():
                dev[k].copy_(v.pin_memory(), non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._copy)
        return dev, ev

    def _stage_segment(self, seg_rows: Dict[str, np.ndarray],
                       seg_gids: np.ndarray):
        """Start the upload of a frontier segment (exactly its rows)
        without touching the device state: called one segment ahead,
        so the copy overlaps the current segment's steps."""
        with self._span("h2d"):
            arrs = {"r|" + k: v for k, v in seg_rows.items()}
            arrs["gids"] = np.asarray(seg_gids, np.int32)
            dev, ev = self._upload(arrs)
        return dict(dev=dev, ev=ev, n=int(seg_gids.shape[0]))

    def _swap_in_segment(self, st: _SpillLevel, staged):
        """Copy the staged segment into the static frontier buffers
        (a captured step reads those addresses) and point the cursor at
        its first row.  Rows past ``n`` are stale; the step's ``valid``
        masks them."""
        n, dev = staged["n"], staged["dev"]
        if staged["ev"] is not None:
            torch.cuda.current_stream(self.device).wait_event(staged["ev"])
        for k, v in st.front.items():
            v[..., :n].copy_(dev["r|" + k])
        st.gids[:n].copy_(dev["gids"])
        st.n_front.fill_(n)
        st.base.zero_()
        return n

    @staticmethod
    def _resegment(blocks: List, seg: int):
        """Yield (rows, gids) segments of <= seg rows from frontier
        blocks [(rows dict batch-last, gids)], concatenating across
        block boundaries."""
        buf_rows, buf_gids, have = [], [], 0
        for rows, gids in blocks:
            n = int(gids.shape[0])
            off = 0
            while off < n:
                take_n = min(seg - have, n - off)
                buf_rows.append({k: v[..., off:off + take_n]
                                 for k, v in rows.items()})
                buf_gids.append(gids[off:off + take_n])
                have += take_n
                off += take_n
                if have == seg:
                    yield SpillEngine._cat_seg(buf_rows, buf_gids)
                    buf_rows, buf_gids, have = [], [], 0
        if have:
            yield SpillEngine._cat_seg(buf_rows, buf_gids)

    @staticmethod
    def _cat_seg(buf_rows, buf_gids):
        if len(buf_rows) == 1:
            return buf_rows[0], buf_gids[0]
        keys = buf_rows[0].keys()
        return ({k: np.concatenate([b[k] for b in buf_rows], axis=-1)
                 for k in keys}, np.concatenate(buf_gids))

    # ------------------------------------------------------------------
    # the host-partitioned table: the per-level sweep and the reseed
    # ------------------------------------------------------------------

    def _member_dev(self, img: torch.Tensor, keys: torch.Tensor
                    ) -> torch.Tensor:
        """Membership of int32 [W, n] keys in an int32 [W, C] partition
        image on the device: the table's home hash and quadratic walk,
        gathers only, every lane until its key or an empty slot.  Reads
        the active flag once per ``_MEMBER_BLOCK`` rounds and raises
        when a lane is still walking after the probe budget."""
        C, n = img.shape[1], keys.shape[1]
        pos = home_slots(keys, C).long()
        t = torch.zeros(n, dtype=torch.long, device=img.device)
        act = torch.ones(n, dtype=torch.bool, device=img.device)
        found = torch.zeros(n, dtype=torch.bool, device=img.device)
        rounds = 0
        while True:
            for _ in range(_MEMBER_BLOCK):
                cur = img[:, pos]
                iskey = (cur == keys).all(0)
                isempty = (cur == EMPTY).all(0)
                found |= act & iskey
                act &= ~(iskey | isempty)
                t += act
                pos = torch.where(act, (pos + t) & (C - 1), pos)
            rounds += _MEMBER_BLOCK
            if not bool(act.any()):
                return found
            if rounds >= MAX_PROBE_ROUNDS:
                raise RuntimeError(
                    "host-partition sweep probe walk did not converge "
                    "— partition image pathologically full")

    def _sweep_level_keys(self, keys: np.ndarray) -> np.ndarray:
        """One level's partition sweep: bucket the level's keys (u32
        [N, W], unique within the level, in enumeration order) by
        prefix, probe each bucket against its partition's image on the
        device (partition p+1's upload is started before p's probe),
        then commit the fresh keys into the host partitions.  Returns
        keep = not seen before [N]."""
        # chaos site: a lost host partition
        chaos_point("host_table")
        with self._obs.span("host_sweep"), self._span("sweep"):
            return self._sweep_level_keys_impl(keys)

    def _upload_image(self, p: int):
        dev, ev = self._upload({"img": self.hpt.imgs[p]})
        return dev["img"], ev

    def _stage_sweep_images(self):
        """Start the uploads of the next sweep's first partition images
        (ascending, the sweep's order) up to the double-buffer depth,
        at level start, so they overlap the level's steps.  A staged
        image serves the sweep only while its partition's version is
        current."""
        if not (self.sweep_stage and self.host_table
                and self.hpt is not None):
            return
        if self._staged_for is not self.hpt:
            # a fresh or resumed run rebuilt the partitions: images
            # staged for the old table (whose versions may alias) go
            self._sweep_staged = {}
            self._staged_for = self.hpt
        todo = [p for p in range(self.hpt.P)
                if p not in self._sweep_staged]
        room = self._SWEEP_STAGE_DEPTH - len(self._sweep_staged)
        if room <= 0 or not todo:
            return
        # inside the level's level_dispatch span: the timeline shows the
        # uploads overlapping the level's steps
        with self._obs.span("h2d_stage"), self._span("h2d"):
            for p in todo[:room]:
                self._sweep_staged[p] = (self._upload_image(p),
                                         self.hpt.vers[p])

    def _sweep_level_keys_impl(self, keys: np.ndarray) -> np.ndarray:
        n_all = keys.shape[0]
        keep = np.ones(n_all, bool)
        if n_all == 0:
            return keep
        hpt = self.hpt
        pids = hpt.partition_ids(keys)
        plan = []
        for p in range(hpt.P):
            idx = np.nonzero(pids == p)[0]
            if idx.size:
                plan.append((p, idx))
        staged = {}

        def stage(j):
            if j < len(plan):
                p, idx = plan[j]
                # grow before the upload: the device image keeps the
                # load bound even after this level commits
                grew = hpt.reserve(p, int(idx.size))
                pre = self._sweep_staged.pop(p, None)
                if pre is not None and not grew and pre[1] == hpt.vers[p]:
                    # the prestaged image is current: its upload already
                    # rode the link, and the span marks the one skipped
                    with self._obs.span("sweep_overlap"):
                        staged[j] = pre[0]
                    self.sweep_stage_hits += 1
                else:
                    staged[j] = self._upload_image(p)
                    if self.sweep_stage:
                        self.sweep_stage_misses += 1

        stage(0)
        for j, (p, idx) in enumerate(plan):
            img, ev = staged.pop(j)
            kq, kev = self._upload({"k": np.ascontiguousarray(keys[idx].T)})
            stage(j + 1)        # the next partition's upload rides now
            for e in (ev, kev):
                if e is not None:
                    torch.cuda.current_stream(self.device).wait_event(e)
            with self._span("sweep_probe"):
                keep[idx] = ~self._member_dev(img, kq["k"]).cpu().numpy()
        with self._span("sweep_commit"):
            hpt.commit(keys, keep)
        return keep

    def _reseed_dev_table(self, st: _SpillLevel, fkeys: np.ndarray) -> int:
        """Reset the device cache to the frontier's keys near the
        initial capacity (the next level re-generates them at a high
        rate; everything older answers from the sweep).  The keys go in
        through the dedup kernel (its twin on the CPU): their slots may
        differ from the reference's lax walk, their membership does
        not.  Only at a level boundary: the cache must stay complete
        over a running level."""
        n = int(fkeys.shape[0])
        self.VCAP = self.VCAP0
        while n + self.SEGL - self.OCAP > self._LOAD_MAX * self.VCAP:
            self.VCAP *= 4
        with self._span("reseed"):
            st.set_table(self._seed_table_from_keys(fkeys))
        self._graphs.clear()
        self.reseeds += 1
        return n

    # ------------------------------------------------------------------
    # the spill-aware burst: while the whole frontier fits the ring and
    # no sweep is due, whole levels run on the device; a bail leaves the
    # pre-level frontier to the segment driver
    # ------------------------------------------------------------------

    def _burst_spill_levels(self, st, ring, frontier_blocks, res, depth,
                            n_states, n_vis, max_depth, max_states,
                            verbose):
        """One fused multi-level burst on a frontier that fits the ring.
        Harvests every committed level and rebuilds the host frontier
        from the surviving ring.  Returns (frontier_blocks, depth,
        n_states, n_vis, fused, bailed): fused False means the first
        level bailed and the segment driver runs it; bailed True means
        the call ended in a bail."""
        t1 = time.perf_counter()
        with self._obs.span("burst_dispatch"):
            KB = self._burst_width()
            rows_cat, gids_cat = self._cat_seg(
                [r for r, _g in frontier_blocks],
                [g for _r, g in frontier_blocks])
            n_front = int(gids_cat.shape[0])
            with self._span("h2d"):
                dev, ev = self._upload({k: v for k, v in rows_cat.items()})
            if ev is not None:
                torch.cuda.current_stream(self.device).wait_event(ev)
            for k, v in ring.fr.items():
                v.zero_()
                v[..., :n_front] = dev[k]
            ring.fm.zero_()
            ring.fm[:n_front] = True
            ring.gd.fill_(-1)
            ring.gd[:n_front] = torch.from_numpy(
                gids_cat.astype(np.int64)).to(self.device)
            ring.nf.fill_(n_front)
            ring.g.fill_(n_states)
            ring.pg.zero_()
            self._grow_table_if_needed(st, n_vis,
                                       min_add=self.burst_levels * KB)
            lv_left = min(self.burst_levels, max_depth - depth)
            st_cap = max(1, min(max_states - res.distinct_states,
                                2 ** 31 - 1))
            meta, stats = self._burst_loop(st, ring, lv_left, st_cap,
                                           n_front)
        nlev, bailed = meta[0], bool(meta[1])
        res.burst_dispatches += 1
        res.burst_bailouts += int(bailed)
        if nlev == 0:
            return (frontier_blocks, depth, n_states, n_vis, False,
                    bailed)
        with self._obs.span("harvest"), self._span("harvest"):
            arch = None
            if self.store_states or meta[3]:
                arch = (ring.opar.cpu().numpy(), ring.olane.cpu().numpy(),
                        storage_to_numpy(ring.ost, self.ir.u32_keys),
                        ring.oinv.cpu().numpy())

            def archive(li, n_lvl):
                # an empty level appends nothing: the spill archive's
                # gid -> row map is cumulative
                if self.store_states and n_lvl:
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
                res, nlev, lambda li: stats[li, :5], depth, n_states,
                archive=archive, violations=violations, visited=visited)
            # the next frontier from the surviving ring: pruned rows
            # drop here, as if the level had spilled
            nf = meta[2]
            frontier_blocks = []
            if nf:
                keep = torch.nonzero(ring.fm[:nf]).squeeze(1)
                if keep.numel():
                    fr_h = storage_to_numpy(
                        {k: v.index_select(-1, keep)
                         for k, v in ring.fr.items()}, self.ir.u32_keys)
                    g = ring.gd.index_select(0, keep).to(torch.int32)
                    frontier_blocks = [(fr_h, g.cpu().numpy())]
        self._obs.dispatch(kind="burst", depth=depth, frontier=nf,
                           metrics=res.metrics.as_dict())
        if verbose:
            print(f"burst: {nlev} levels to depth {depth} "
                  f"(total {res.distinct_states}), frontier "
                  f"{sum(int(g.shape[0]) for _r, g in frontier_blocks)}, "
                  f"{time.perf_counter() - t1:.2f}s", flush=True)
        return (frontier_blocks, depth, n_states, n_vis, True, bailed)

    # ------------------------------------------------------------------

    def check(self, max_depth: int = 10 ** 9, max_states: int = 10 ** 9,
              stop_on_violation: bool = False,
              seed_states: Optional[List] = None,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 1,
              resume_from: Optional[str] = None,
              resume_image=None,
              verbose: bool = False, obs=None) -> CheckResult:
        """``resume_image`` — a ``resil.portable.PortableImage`` from any
        engine family's checkpoint: the visited key set rebuilds this
        engine's table (and host partitions) and the frontier rows
        become one spill block.

        obs — an ``obs.Obs`` bundle: one ledger record and heartbeat
        rewrite per burst and per level, written once the level's
        sweep, reseed and checkpoint are done, and the reference's
        spans on the host: ``compile`` (each graph's warm-up and
        capture, and the kernels' first-use build), ``burst_dispatch``,
        ``level_dispatch`` (with ``h2d_stage`` inside it),
        ``harvest``, ``host_sweep``, ``sweep_overlap``,
        ``archive_io``, ``checkpoint``.  They sit beside the engine's
        own ``host_seconds`` kinds, which keep their names."""
        obs = self._obs = obs if obs is not None else NULL_OBS
        t0 = time.perf_counter()
        lay = self.lay
        if resume_from is not None and resume_image is not None:
            raise ValueError(
                "resume_from and resume_image are mutually exclusive")
        self._reset_counters()
        self._load_kernels(obs)
        self._graphs = GraphRunner(self.device, self._capture, obs=obs)
        self.hard_stats = [0, 0, 0]
        frontier_keys: List[np.ndarray] = []   # host-table mode only
        root_blk = None
        if resume_from is not None:
            (st, res, frontier_blocks, frontier_keys, n_states, n_vis,
             depth) = self._load_spill_checkpoint(resume_from)
            self._restore_pin_interiors(res)
        elif resume_image is not None:
            (st, res, frontier_blocks, frontier_keys, n_states, n_vis,
             depth) = self._resume_portable(resume_image)
            self._restore_pin_interiors(res)
        else:
            self._init_store()
            if self.host_table:
                self.hpt = HostPartitionedTable(
                    self.W, partitions=self.partitions,
                    part_cap=self.part_cap)
                self._sweep_staged = {}
            roots, rk, pin_interiors = self._dedup_roots(seed_states)
            n_roots = len(rk)
            res = CheckResult(generated_states=n_roots)
            self._check_pin_interiors(pin_interiors, res)
            st = _SpillLevel(self, self._new_table(self.VCAP))
            slots = torch.from_numpy(self._host_probe_assign(rk)).to(
                self.device)
            st.vis[:, slots.long()] = torch.from_numpy(
                np.ascontiguousarray(rk.T).view(np.int32)).to(self.device)
            rows = rows_to_torch(roots, self.device, self.ir.u32_keys)
            inv_r, con_r = self._phase2_T(rows)
            root_blk = dict(
                rows=storage_to_numpy(self.ir.narrow(lay, rows),
                                      self.ir.u32_keys),
                lpar=np.full((n_roots,), -1, np.int32),
                llane=np.full((n_roots,), -1, np.int32),
                linv=inv_r.cpu().numpy(), lcon=con_r.cpu().numpy(),
                n=n_roots)
            if self.host_table:
                root_blk["lfp"] = np.ascontiguousarray(
                    rk.T.astype(np.uint32))
            n_states = 0       # running global id offset
            n_vis = n_roots
            depth = 0
            frontier_blocks = []
        self._stamp_mode(res)
        ring = None

        def harvest_block(blk, keep=None):
            """Counts, violations, archives and next-frontier rows of one
            spilled block; returns (rows, gids, fkeys) of the frontier
            (fkeys None outside host-table mode) or None.  ``keep`` is
            the sweep's verdict: False rows were seen at an earlier
            level and are dropped before anything counts them."""
            nonlocal n_states
            if keep is not None and not keep.all():
                kidx = np.nonzero(keep)[0]
                sub = dict(
                    rows={k: np.ascontiguousarray(v[..., kidx])
                          for k, v in blk["rows"].items()},
                    lpar=blk["lpar"][kidx], llane=blk["llane"][kidx],
                    linv=blk["linv"][:, kidx], lcon=blk["lcon"][kidx],
                    n=len(kidx))
                if "lfp" in blk:
                    sub["lfp"] = np.ascontiguousarray(blk["lfp"][:, kidx])
                blk = sub
            n = blk["n"]
            res.distinct_states += n
            res.overflow_faults += int(
                (blk["rows"]["ctr"][C_OVERFLOW] > 0).sum())
            gids = np.arange(n_states, n_states + n, dtype=np.int32)
            inv_ok = blk["linv"]
            if inv_ok.size and not inv_ok.all():
                bad = np.nonzero(~inv_ok)
                res.violations_global += len(bad[0])
                for j, s in zip(*bad):
                    vsv, vh = self.ir.decode(
                        lay, {k: v[..., s] for k, v in blk["rows"].items()})
                    res.violations.append(Violation(
                        self.inv_names[j], int(gids[s]), state=vsv,
                        hist=vh))
            if self.store_states:
                self._lvl_parts[-1].append(blk)
            n_states += n
            driver.guard_id_space(n_states)
            con = blk["lcon"].astype(bool)
            if con.all():
                fk = (np.ascontiguousarray(blk["lfp"].T)
                      if "lfp" in blk else None)
                return blk["rows"], gids, fk
            cidx = np.nonzero(con)[0]
            if not len(cidx):
                return None
            fk = (np.ascontiguousarray(blk["lfp"][:, cidx].T)
                  if "lfp" in blk else None)
            return ({k: v[..., cidx] for k, v in blk["rows"].items()},
                    gids[cidx], fk)

        def flush_archives():
            """Merge this level's spilled parts into the archive: the
            disk archive's memmaps, or the in-RAM batch-major arrays."""
            if not self.store_states:
                return
            parts = self._lvl_parts[-1]
            if not parts:
                return
            with obs.span("archive_io"), self._span("harvest"):
                if self._arch is not None:
                    self._arch.append_level_parts(parts)
                else:
                    self._parents.append(np.concatenate(
                        [p["lpar"] for p in parts]))
                    self._lanes.append(np.concatenate(
                        [p["llane"] for p in parts]))
                    # batch-major views of the batch-last concatenation,
                    # as the reference keeps them (a transposing copy of
                    # a deep level costs seconds)
                    keys = parts[0]["rows"].keys()
                    self._states.append(
                        {k: np.moveaxis(np.concatenate(
                            [p["rows"][k] for p in parts], axis=-1), -1, 0)
                         for k in keys})
            self._lvl_parts[-1] = []

        def save():
            self._save_spill_checkpoint(
                checkpoint_path, st, res, frontier_blocks, frontier_keys,
                depth, n_states, n_vis)

        self._lvl_parts: List[List] = [[]]
        if root_blk is not None:
            rkeep = None
            if self.host_table:
                # the roots enter the host partitions through the same
                # sweep as every level (all fresh)
                rkeep = self._sweep_level_keys(
                    np.ascontiguousarray(root_blk["lfp"].T))
            out = harvest_block(root_blk, rkeep)
            flush_archives()
            if out is not None:
                frontier_blocks.append(out[:2])
                if out[2] is not None:
                    frontier_keys.append(out[2])
            res.generated_states = n_roots

        # a burst that committed levels and then bailed keeps the bailing
        # level's frontier: re-entering would bail again, so that level
        # runs on the segment driver, which re-arms the burst
        burst_ok = True
        while frontier_blocks and depth < max_depth and \
                res.distinct_states < max_states and \
                not (stop_on_violation and res.violations):
            # chaos site: a dispatch-time device error at the level
            # boundary, before any device work
            chaos_point("dispatch")
            if (self.burst and burst_ok and not self.host_table and
                    sum(int(g.shape[0]) for _r, g in frontier_blocks)
                    <= self._burst_width()):
                d0 = depth
                if ring is None:
                    ring = _Ring(self, st)
                (frontier_blocks, depth, n_states, n_vis, fused,
                 bailed) = self._burst_spill_levels(
                    st, ring, frontier_blocks, res, depth, n_states,
                    n_vis, max_depth, max_states, verbose)
                if fused:
                    burst_ok = not bailed
                    if checkpoint_path is not None and \
                            driver.ckpt_due_after_burst(
                                depth, d0, checkpoint_every):
                        save()
                    continue
            burst_ok = True
            depth += 1
            t1 = time.perf_counter()
            seg0 = self.segments_spilled
            self._lvl_parts.append([])
            level_new = 0
            level_gen = 0
            next_blocks: List = []
            next_keys: List = []
            level_blks: List = []      # host table: swept at level end
            pending_blks: List = []

            def drain_gen():
                nonlocal level_gen
                g = int(st.n_gen)
                st.n_gen.zero_()
                res.generated_states += g
                level_gen += g

            def settle_blk(blk):
                """Bookkeeping of a fresh pending block; its host copy
                and harvest wait (FIFO) so the copy overlaps further
                steps.  n_vis tracks the device table's occupancy;
                under the host table level_new waits for the sweep."""
                nonlocal n_vis, level_new
                if blk is not None:
                    n_vis += blk["n"]
                    if not self.host_table:
                        level_new += blk["n"]
                    pending_blks.append(blk)

            def drain_blks():
                nonlocal pending_blks
                if not pending_blks:
                    return
                with obs.span("harvest"):
                    for blk in pending_blks:
                        blk = self._materialize_blk(blk)
                        if self.host_table:
                            # harvest waits for the level-end sweep
                            level_blks.append(blk)
                            continue
                        with self._span("harvest"):
                            out = harvest_block(blk)
                        if out is not None:
                            next_blocks.append(out[:2])
                pending_blks = []

            with obs.span("level_dispatch"):
                # the sweep's first images upload during the level: the
                # h2d_stage span nests inside this one
                if self.host_table:
                    self._stage_sweep_images()
                seg_iter = self._resegment(frontier_blocks, self.SEGF)
                staged = next(seg_iter, None)
                staged_dev = (self._stage_segment(*staged)
                              if staged is not None else None)
                while staged_dev is not None:
                    self._grow_table_if_needed(st, n_vis)
                    n_seg = self._swap_in_segment(st, staged_dev)
                    staged = next(seg_iter, None)
                    # the next segment's upload rides while this one runs
                    staged_dev = (self._stage_segment(*staged)
                                  if staged is not None else None)
                    n_chunks = (n_seg + self.chunk - 1) // self.chunk
                    k = 0
                    inflight = None
                    while k < n_chunks or inflight is not None:
                        cur = None
                        if k < n_chunks:
                            win_end = min(k + self.sync_every, n_chunks)
                            while k < win_end:
                                self._run_step(st)
                                k += 1
                            cur = self._read_summary(st)
                        if inflight is not None:
                            with self._span("sync"):
                                s = inflight()          # one window late
                            self.summary_syncs += 1
                            # the margin covers the window dispatched above
                            spill_floor = self.SEGL - self.OCAP * (
                                2 * self.sync_every + 3)
                            tripped = s[S_OVF] or s[S_FOVF] or s[S_HOVF] or \
                                s[S_OOVF] or s[-2]
                            if tripped or int(s[S_NLVL]) >= spill_floor:
                                if cur is not None:
                                    # the window in flight has the freshest
                                    # flags (its chunks after a trip are
                                    # no-ops)
                                    with self._span("sync"):
                                        s = cur()
                                    self.summary_syncs += 1
                                    cur = None
                                if s[S_OVF] or s[S_FOVF] or s[S_HOVF] or \
                                        s[S_OOVF] or s[-2]:
                                    drain_blks()
                                    blk, k = self._handle_trip(st, s, verbose)
                                    settle_blk(blk)
                                else:
                                    drain_blks()
                                    settle_blk(self._spill_segment(
                                        st, int(s[S_NLVL])))
                                # n_vis moved: a dense segment can spill
                                # several SEGL's worth of keys before the
                                # next segment boundary
                                self._grow_table_if_needed(st, n_vis)
                        inflight = cur
                    drain_gen()
                    # the rows stay on the device across frontier segments
                    # until the floor trips or the level ends

                # level end: spill the remainder
                settle_blk(self._spill_segment(st, int(st.n_lvl)))
                drain_gen()
            drain_blks()
            if self.host_table and level_blks:
                # the level's keys (unique, in enumeration order) meet
                # the host partitions: rows an earlier level archived
                # drop everywhere at once
                lkeys = np.concatenate(
                    [np.ascontiguousarray(b["lfp"].T) for b in level_blks])
                lkeep = self._sweep_level_keys(lkeys)
                with obs.span("harvest"), self._span("harvest"):
                    off = 0
                    for b in level_blks:
                        nb = b["n"]
                        kb = lkeep[off:off + nb]
                        off += nb
                        level_new += int(kb.sum())
                        out = harvest_block(b, kb)
                        if out is not None:
                            next_blocks.append(out[:2])
                            next_keys.append(out[2])
            flush_archives()
            self.segments_by_level[depth] = self.segments_spilled - seg0
            depth = driver.gate_level_depth(
                res, depth, level_new, level_gen,
                sum(int(g.shape[0]) for _r, g in next_blocks))
            frontier_blocks = next_blocks
            frontier_keys = next_keys
            if self.host_table and n_vis > self.dev_keys:
                # the cache outgrew its budget: reseed it with the
                # frontier's keys (the partitions hold everything else)
                fkeys = (np.concatenate(frontier_keys) if frontier_keys
                         else np.zeros((0, self.W), np.uint32))
                n_vis = self._reseed_dev_table(st, fkeys)
            if checkpoint_path is not None and \
                    driver.ckpt_due_at_level(depth, checkpoint_every):
                save()
            # the level's row carries its final counters: written after
            # its drain, sweep, reseed and checkpoint
            obs.dispatch(kind="level", depth=depth,
                         frontier=sum(int(g.shape[0])
                                      for _r, g in frontier_blocks),
                         metrics=res.metrics.as_dict())
            if verbose:
                print(f"depth {depth}: +{level_new} states "
                      f"(total {res.distinct_states}), frontier "
                      f"{sum(int(g.shape[0]) for _r, g in frontier_blocks)}"
                      f", {time.perf_counter() - t1:.2f}s", flush=True)
        res.depth = depth
        h, hs = self.hard_stats, st.hard.tolist()
        res.hard_lanes, res.hard_chunks, res.hard_chunk_max = (
            h[0] + hs[0], h[1] + hs[1], max(h[2], hs[2]))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._graphs.clear()
        res.seconds = time.perf_counter() - t0
        return res

    # ------------------------------------------------------------------
    # checkpoint / resume: at a level boundary the visited table is the
    # only device state that matters (the level segment is empty and the
    # frontier rebuilds from the host blocks); the files are the
    # reference's spill checkpoints
    # ------------------------------------------------------------------

    def _save_spill_checkpoint(self, path, st, res, frontier_blocks,
                               frontier_keys, depth, n_states, n_vis):
        with self._obs.span("checkpoint"), self._span("checkpoint"):
            self._save_spill_checkpoint_impl(
                path, st, res, frontier_blocks, frontier_keys, depth,
                n_states, n_vis)

    def _save_spill_checkpoint_impl(self, path, st, res, frontier_blocks,
                                    frontier_keys, depth, n_states, n_vis):
        # the table goes sparse, compacted on the device, so the copy is
        # O(occupied) (the reference pads it to a size quantum; only the
        # live slots are written either way).  An all-ones key reads as
        # empty: the probe walk's accepted-risk class
        occ = torch.nonzero(~(st.vis == EMPTY).all(0)).squeeze(1)
        ckpt = dict(
            # int32, as the JAX engine writes it (its int64 request is
            # truncated without x64)
            vis_idx=occ.to(torch.int32).cpu().numpy(),
            vis_keys=words_to_numpy(st.vis.index_select(1, occ)),
            fblk=[dict(g=np.asarray(g), r=dict(rows))
                  for rows, g in frontier_blocks])
        if self.host_table:
            # the authoritative visited set (exact images) and the
            # frontier keys the reseed needs
            ckpt.update(self.hpt.state_dict())
            ckpt["fkey"] = [np.asarray(fk) for fk in frontier_keys]
        n_front = sum(int(g.shape[0]) for _r, g in frontier_blocks)
        parents, lanes, states, arch_meta = self._ckpt_store_args()
        ckpt_write(path, ckpt, self.store_states, parents, lanes, states,
                   res, dict(
                       spill=True, depth=depth, n_states=n_states,
                       n_vis=n_vis, n_front=n_front,
                       n_fblk=len(frontier_blocks),
                       SEGL=self.SEGL, SEGF=self.SEGF, VCAP=self.VCAP,
                       FCAP=self.FCAP, OCAP=self.OCAP,
                       fam_caps=list(self.FAM_CAPS),
                       host_table=self.host_table,
                       partitions=self.partitions, **arch_meta,
                       layout=2, chunk=self.chunk, spec=self.ir.name,
                       sym_canon=self.fpr.sym_canon,
                       ir_fingerprint=self.ir.fingerprint(),
                       cfg=repr(self.cfg), HCAP=self.HCAP),
                   keep=self.ckpt_keep)

    def _frontier_keys_of(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        """Batch-major storage rows -> their u32 [n, W] keys."""
        n = len(next(iter(rows.values())))
        out = []
        for i in range(0, n, 1 << 16):
            b = rows_to_torch({k: v[i:i + (1 << 16)]
                               for k, v in rows.items()}, self.device,
                              self.ir.u32_keys)
            out.append(words_to_numpy(self.fpr.fingerprint_batch_T(b)).T)
        return (np.concatenate(out) if out
                else np.zeros((0, self.W), np.uint32))

    def _resume_portable(self, img):
        """This engine's level-boundary state from a PortableImage of any
        engine family: the key set goes into a fresh table through the
        host claim-insert (``insert_np``), the frontier rows become one
        spill block, and under ``host_table`` the partitions rebuild by
        sweeping the whole key set (so any ``partitions`` works) while
        the device table gets only the frontier's keys."""
        from ..resil.portable import validate_image
        validate_image(img, self.ir.name, repr(self.cfg), self.W)
        self._restore_portable_archives(img)
        keys = img.keys.astype(np.uint32)
        rows, gids = img.expandable()
        frontier_blocks = []
        if gids.shape[0]:
            frontier_blocks.append((
                {k: np.ascontiguousarray(np.moveaxis(v, 0, -1))
                 for k, v in rows.items()}, np.asarray(gids, np.int32)))
        frontier_keys: List[np.ndarray] = []
        if self.host_table:
            self.hpt = HostPartitionedTable(
                self.W, partitions=self.partitions,
                part_cap=self.part_cap)
            step = 1 << 16
            for i in range(0, keys.shape[0], step):
                self.hpt.sweep(np.ascontiguousarray(keys[i:i + step]))
            fkeys = (self._frontier_keys_of(rows) if gids.shape[0]
                     else np.zeros((0, self.W), np.uint32))
            if gids.shape[0]:
                frontier_keys.append(fkeys)
            self.VCAP = self.VCAP0
            while fkeys.shape[0] + self.SEGL > self._LOAD_MAX * self.VCAP:
                self.VCAP *= 4
            tkeys = fkeys
        else:
            while keys.shape[0] + self.SEGL > self._LOAD_MAX * self.VCAP:
                self.VCAP *= 4
            tkeys = keys
        tbl = np.full((self.W, self.VCAP), np.uint32(0xFFFFFFFF), np.uint32)
        insert_np(tbl, tkeys)
        st = _SpillLevel(self, self._new_table(self.VCAP))
        st.vis.copy_(torch.from_numpy(tbl.view(np.int32)).to(self.device))
        return (st, img.fresh_result(), frontier_blocks, frontier_keys,
                img.n_states, int(tkeys.shape[0]), img.depth)

    def _load_spill_checkpoint(self, path):
        z, meta = ckpt_read(path, repr(self.cfg), self.chunk,
                            self._SPILL_EXTRA_KEYS,
                            sharded=False, spill=True, expected_format=(
                                "layout", 2, "this engine's batch-last/"
                                "narrow-dtype storage layout"),
                            spec_name=self.ir.name,
                            sym_canon=self.fpr.sym_canon)
        if meta["SEGF"] != self.SEGF:
            # re-segmenting keeps the counts, but a resumed run holds
            # the segment shape so every block boundary stays the same
            raise CheckpointError(
                f"checkpoint was written with seg={meta['SEGF']}; "
                f"resume with the same seg (engine has {self.SEGF})")
        self.SEGL, self.VCAP, self.FCAP, self.OCAP = (
            meta["SEGL"], meta["VCAP"], meta["FCAP"], meta["OCAP"])
        self.FAM_CAPS = tuple(int(c) for c in meta["fam_caps"])
        self.HCAP = int(meta.get("HCAP", self.HCAP))
        if "carry|vis_idx" not in z or "carry|vis_keys" not in z:
            raise CheckpointError(
                f"{path}: checkpoint lacks the sparse visited-table "
                "records — written by an incompatible engine version; "
                "re-run without --resume")
        keys = z["carry|vis_keys"]
        if keys.shape[0] != self.W:
            raise CheckpointError(
                f"{path}: checkpoint has {keys.shape[0]} fingerprint "
                f"streams; engine expects {self.W} (fp64 vs fp128 "
                "mismatch)")
        st = _SpillLevel(self, self._new_table(self.VCAP))
        occ = torch.from_numpy(np.asarray(z["carry|vis_idx"])).to(
            self.device)
        st.vis[:, occ] = torch.from_numpy(
            np.ascontiguousarray(keys).view(np.int32)).to(self.device)
        row_keys = list(st.lvl.keys())
        frontier_blocks = []
        for i in range(meta["n_fblk"]):
            gids = z[f"carry|fblk|{i}|g"]
            rows = {k: z[f"carry|fblk|{i}|r|{k}"] for k in row_keys}
            frontier_blocks.append((rows, gids))
        if bool(meta.get("host_table")) != self.host_table:
            raise CheckpointError(
                f"{path}: checkpoint was written with host_table="
                f"{bool(meta.get('host_table'))}; resume with the "
                "same setting")
        frontier_keys = []
        if self.host_table:
            if meta.get("partitions") != self.partitions:
                raise CheckpointError(
                    f"{path}: checkpoint has {meta.get('partitions')} "
                    f"host-table partitions; engine has "
                    f"{self.partitions} — resume with the same "
                    "--partitions (counts are P-invariant, but the "
                    "serialized images are not)")
            self.hpt = HostPartitionedTable.from_state(
                lambda nm: z["carry|" + nm])
            frontier_keys = [np.asarray(z[f"carry|fkey|{i}"])
                             for i in range(meta["n_fblk"])]
        self._load_archives(path, z, meta, {"lvl": st.lvl})
        res = ckpt_result(z, meta)
        z.close()             # all arrays extracted; don't leak the fd
        return (st, res, frontier_blocks, frontier_keys,
                meta["n_states"], meta["n_vis"], meta["depth"])

    # ------------------------------------------------------------------

    def _grow_table_if_needed(self, st: _SpillLevel, n_vis: int,
                              min_add: int = 0):
        """The load check at segment boundaries and after every
        mid-segment spill or trip: the table takes at most SEGL - OCAP
        more keys before the next check (``min_add`` raises the bound
        for a burst).  Safe mid-segment: the cursor and the frontier
        segment stay as they are."""
        need = n_vis + max(self.SEGL - self.OCAP, min_add)
        if need > self._LOAD_MAX * self.VCAP:
            while need > self._LOAD_MAX * self.VCAP:
                self.VCAP *= 4
            st.set_table(self._rehash_tables(st.vis, self.VCAP))
            self._graphs.clear()

    def _handle_trip(self, st: _SpillLevel, s, verbose: bool):
        """Fix what tripped (the segment full, the caps, the hard-lane
        buffer, the table), clear the sticky flags and point the cursor
        back at the tripped chunk, which left no trace.  Returns (the
        spilled block or None, the chunk index to resume at)."""
        trip_base = int(s[S_TRIP])
        assert trip_base >= 0, "trip flags set but no trip_base"
        nf = len(self.FAM_CAPS)
        hcovf, hmax = int(s[S_LEN + nf]), int(s[S_LEN + nf + 1])
        for kind, at in (("ovf", S_OVF), ("fovf", S_FOVF),
                         ("hovf", S_HOVF), ("oovf", S_OOVF)):
            self.trips[kind] += int(s[at])
        self.trips["hcovf"] += hcovf
        blk = None
        old_shapes = (self.FCAP, self.OCAP, self.SEGL)
        if s[S_OVF]:
            blk = self._spill_segment(st, int(s[S_NLVL]))
        self._grow_caps(bool(s[S_OOVF]), bool(s[S_FOVF]),
                        [int(x) for x in s[S_LEN:S_LEN + nf]])
        if hcovf:
            while self.HCAP < 2 * hmax:
                self.HCAP *= 2
        if self.SEGL < 4 * self.OCAP:
            # the level segment keeps an OCAP-sized append margin
            self.SEGL = self._round_cap(4 * self.OCAP)
        if (self.FCAP, self.OCAP, self.SEGL) != old_shapes:
            # the buffers change shape: spill the committed rows first
            if blk is None:
                blk = self._spill_segment(st, int(s[S_NLVL]))
            st.alloc_level(self)
            self._graphs.clear()
        if s[S_HOVF]:
            self.VCAP *= 4
            st.set_table(self._rehash_tables(st.vis, self.VCAP))
            self._graphs.clear()
        if verbose:
            print(f"trip at base {trip_base}: ovf={int(s[S_OVF])} "
                  f"fovf={int(s[S_FOVF])} hovf={int(s[S_HOVF])} "
                  f"oovf={int(s[S_OOVF])} hcovf={hcovf} "
                  f"-> FCAP={self.FCAP} OCAP={self.OCAP} "
                  f"SEGL={self.SEGL} VCAP={self.VCAP} HCAP={self.HCAP} "
                  f"fam_caps={self.FAM_CAPS}", flush=True)
        for t in st.flags:
            t.zero_()
        st.trip_base.fill_(-1)
        st.famx.zero_()
        st.hmax.zero_()
        st.base.fill_(trip_base)
        return blk, trip_base // self.chunk
