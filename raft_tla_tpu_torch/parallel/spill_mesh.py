"""Spill-composed sharded BFS: the mesh's hash-owned table shards and
the spill engine's host-resident levels in one engine (the reference's
``raft_tla_tpu/parallel/spill_mesh.py``).

``ShardedEngine`` keeps every shard's frontier and level buffer on its
device, so a mesh meets the same level-buffer wall the single-device
``SpillEngine`` removed.  Here:

- each shard's table stays on its device, and candidates reach their
  owner shard (``key[W-1] mod D``) through the mesh's exchange, as in
  ``parallel/mesh.py``;
- each shard's frontier lives in host RAM as blocks and streams through
  its [LB] frontier buffer in segments, all shards in lock-step;
- each shard's level buffer goes to the host when any shard trips and
  at the level's end; the blocks become the next frontier (pruned rows
  counted, checked and dropped on the host, prune-not-expand) and, with
  ``store_states``, the trace archive (``engine/archive`` memmaps under
  ``archive_dir``, else host lists), in global-id order;
- trips are STEP-ATOMIC (``ShardedEngine._step_atomic``): a step that
  overflows anything on any shard commits on none, so the host spills,
  grows what tripped and resumes every shard at the tripped step's
  cursor (``trip_base``).  The classic engine's whole-level replay is
  impossible here: the level's earlier rows have left the device.

The reference runs a segment's lock-step steps in one device loop and
reads a summary back; the port drives the same loop from the host over
graph replays, one read of the [D, 2] flags a step, then one read of
the [D, Z_LEN + n_fams + 2] summary.

Survivors: stage 1 of the content-canonical reduction (per receive
window) is unchanged; stage 2's replace-if-smaller map (``lrow``)
reaches only rows still on the device, so it resets at every spill and
the canonical minimum is per spill epoch.  With no mid-level spill the
engine equals ``ShardedEngine``; with them it is deterministic for a
fixed (D, chunk, caps) and equals the reference's engine bit for bit.

Checkpoints: at a level's end the whole wavefront is on the host (the
frontier blocks) or one read away (the table shards).  The file holds
it pooled in global-id order, the portable form, with the shards' keys
in (shard, slot) order: the reference's file, written and read by
either package.  Ownership is a function of a key's content, so a
resume routes rows and keys back to their owners and rebuilds each
shard's table with the host claim-insert (``insert_np``); a
``resume_image`` of any engine family takes the same path.

The host-partitioned table (``host_table``) is ROADMAP item 9b-iii: it
raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..convert import (rows_to_torch, storage_to_numpy, words_to_numpy,
                       words_to_torch)
from ..engine import driver
from ..engine.bfs import CheckResult, Violation
from ..engine.ckpt import CheckpointError, ckpt_read, ckpt_result, ckpt_write
from ..engine.host_table import insert_np
from ..engine.spill import SpillEngine, _np_to_t, _t_to_np
from ..obs import NULL_OBS
from ..ops.codec import C_OVERFLOW
from ..resil.chaos import chaos_point
from ..resil.portable import dense_table_keys, validate_image
from ..utils import take_arrays
from .mesh import ShardedEngine

# a shard's summary row: the reference's layout, then the family maxima,
# then the sort-mode hard-lane overflow and the most hard lanes in a step
(Z_NLVL, Z_NGEN, Z_OVF, Z_FOVF, Z_SOVF, Z_HOVF, Z_TRIP,
 Z_LEN) = range(8)

_LATER = ("is ROADMAP item 9b-iii: not ported yet (the reference's "
          "SpilledShardedEngine has it)")


class SpilledShardedEngine(ShardedEngine):
    """ShardedEngine whose level and frontier shards stream through host
    RAM (module docstring).  ``lcap`` is the whole mesh's level rows,
    LB = lcap / D per shard, floored only by the receive window's bound
    (2·D·SC): the classic engine's 4·FCAP floor guards whole-level
    replays, and this engine replays single steps.  The rest as
    ``ShardedEngine``; ``store_states`` composes the trace archive from
    the spilled blocks (``archive_dir``: on disk).  ``partitions``,
    ``part_cap`` and ``dev_keys`` belong to the host table: they are
    kept, and ``partitions`` goes into every checkpoint, as the
    reference keeps them."""

    def __init__(self, cfg: ModelConfig, devices=None, chunk: int = 512,
                 store_states: bool = False, host_table: bool = False,
                 partitions: int = 4, part_cap: int = 1 << 12,
                 dev_keys: Optional[int] = None,
                 archive_dir: Optional[str] = None, **kw):
        if host_table:
            raise NotImplementedError(f"the spill mesh's host table {_LATER}")
        # the parent's archive is bypassed: check() composes its own from
        # the spilled blocks
        super().__init__(cfg, devices=devices, chunk=chunk,
                         store_states=False, **kw)
        self.store_states = bool(store_states)
        self.archive_dir = archive_dir
        self._cur_parts: List[dict] = []
        self.host_table = False
        self.partitions = int(partitions)
        self.part_cap = int(part_cap)
        self.VB0 = self.VB
        self.dev_keys = (int(dev_keys) if dev_keys
                         else int(self._LOAD_MAX * self.VB))
        self.LB = self._round_lb(max(kw.get("lcap", 1 << 14) // self.D,
                                     2 * self.D * self.SC))
        self._step_atomic = True
        self._burst_compact_frontier = True
        self.mid_level_spills = 0      # spills forced by a full level shard
        self._reset_spill_counters()

    def _reset_spill_counters(self):
        """The last check()'s trips, spill events and host bytes moved
        each way (``chip_smoke.py`` reads them)."""
        self.trips = 0
        self.spill_events = 0
        self.bytes_down = self.bytes_up = 0

    # ------------------------------------------------------------------
    # the segment's lock-step steps and their summary
    # ------------------------------------------------------------------

    def _summary(self) -> List[List[int]]:
        """Every shard's counters and flags after a segment's steps: one
        read per device group."""
        rows = []
        for sh in self._shards:
            rows.append(torch.cat([torch.stack([
                sh.n_lvl, sh.n_gen, sh.ovf.long(), sh.fovf.long(),
                sh.sovf.long(), sh.hovf.long(), sh.trip_base]),
                sh.famx.long(), torch.stack([sh.hcovf.long(), sh.hmax])]))
        return self._read_rows(rows)

    # ------------------------------------------------------------------
    # host-side shard plumbing
    # ------------------------------------------------------------------

    def _fetch_shards(self, nl: List[int]):
        """Every shard's first nl[d] level rows, parents, lanes and
        verdicts to host blocks (batch-last, the storage dtypes), then
        the level shards reset.  Resetting ``lrow`` closes the stage-2
        epoch: no replacement may target rows that left the device."""
        blks = [None] * self.D
        if max(nl) > 0:
            self.spill_events += 1
        for d, sh in enumerate(self._shards):
            n = int(nl[d])
            if n:
                blk = dict(rows=storage_to_numpy(
                               {k: v[..., :n] for k, v in sh.lvl.items()},
                               self.ir.u32_keys),
                           lpar=_t_to_np(sh.lpar[:n].cpu()),
                           llane=_t_to_np(sh.llane[:n].cpu()),
                           linv=_t_to_np(sh.linv[:, :n].cpu()),
                           lcon=_t_to_np(sh.lcon[:n].cpu()), n=n)
                self.bytes_down += sum(
                    a.nbytes for a in blk["rows"].values()) + sum(
                    blk[k].nbytes for k in ("lpar", "llane", "linv",
                                            "lcon"))
                blks[d] = blk
            sh.n_lvl.zero_()
            sh.lrow.fill_(-1)
        return blks

    def _upload_seg(self, seg) -> List[int]:
        """One frontier segment into the shards' frontier buffers: seg
        per shard (rows batch-last, gids) or None.  The host dropped the
        pruned rows, so every uploaded row is expandable (fmask all
        set).  Returns the rows per shard."""
        ns = []
        for sh, s in zip(self._shards, seg):
            n = 0 if s is None else int(s[1].shape[0])
            if n:
                rows, gids = s
                for k, v in sh.front.items():
                    src = _np_to_t(rows[k])
                    v[..., :n].copy_(src)
                    self.bytes_up += src.numel() * src.element_size()
                sh.gids[:n].copy_(torch.from_numpy(
                    np.ascontiguousarray(gids, np.int32)))
                self.bytes_up += 4 * n
            sh.n_front.fill_(n)
            sh.base.zero_()
            sh.fmask.fill_(True)
            ns.append(n)
        return ns

    @staticmethod
    def _resegment_dev(blocks_per_dev, seg: int):
        """Lock-step segments of <= seg rows per shard: each round, every
        shard's next segment of its own blocks (None once it has none),
        until every shard is drained."""
        its = [SpillEngine._resegment(b, seg) for b in blocks_per_dev]
        while True:
            out = [next(it, None) for it in its]
            if all(s is None for s in out):
                return
            yield out

    def _flush_level_parts(self):
        """One finished level's harvested parts, in global-id order, to
        the trace archive (the disk archive's memmaps, or the host
        lists); a level that archived nothing appends nothing."""
        if not self.store_states:
            return
        parts, self._cur_parts = self._cur_parts, []
        if not parts:
            return
        with self._obs.span("archive_io"):
            if self._arch is not None:
                self._arch.append_level_parts(parts)
                return
            self._parents.append(np.concatenate(
                [p["lpar"][:p["n"]] for p in parts]))
            self._lanes.append(np.concatenate(
                [p["llane"][:p["n"]] for p in parts]))
            keys = parts[0].get("rows_major") or parts[0]["rows"]
            self._states.append({k: np.concatenate(
                [p["rows_major"][k][:p["n"]] if "rows_major" in p else
                 np.moveaxis(p["rows"][k][..., :p["n"]], -1, 0)
                 for p in parts]) for k in keys})

    def _decode_rows(self, res, rows_of, inv_ok: np.ndarray, gid0: int):
        """Violations of one block, row-major (a row's invariants in
        order): inv_ok bool [n_inv, n], ``rows_of(s)`` row s's arrays."""
        bad = np.nonzero(~inv_ok.T)
        for s, j in zip(*bad):
            vsv, vh = self.ir.decode(self.lay, rows_of(int(s)))
            res.violations.append(Violation(
                self.inv_names[j], gid0 + int(s), state=vsv, hist=vh))
        return len(bad[0])

    # ------------------------------------------------------------------
    # trips and table growth
    # ------------------------------------------------------------------

    def _sgrow_table_if_needed(self, n_vis, min_add: int = 0):
        need = int(n_vis.max()) + max(self.LB, min_add)
        if need > self._LOAD_MAX * self.VB:
            while need > self._LOAD_MAX * self.VB:
                self.VB *= 4
            self._rehash_sharded()

    def _handle_mesh_trip(self, s, n_vis, settle, verbose: bool):
        """Spill every shard's committed rows (the tripped step itself
        committed nowhere), grow what tripped, and point every shard back
        at the tripped step."""
        self.trips += 1
        tb = max(r[Z_TRIP] for r in s)
        assert tb >= 0, "trip flags set but no trip_base"
        ovf = any(r[Z_OVF] for r in s)
        fovf = any(r[Z_FOVF] for r in s)
        sovf = any(r[Z_SOVF] for r in s)
        hovf = any(r[Z_HOVF] for r in s)
        hcovf = any(r[-2] for r in s)
        if ovf:
            self.mid_level_spills += 1
        settle(self._fetch_shards([r[Z_NLVL] for r in s]))
        old = (self.LB, self.FC, self.SC, self.FAM_CAPS, self.HCAP)
        if fovf:
            nf = len(self.FAM_CAPS)
            famx = np.asarray([r[Z_LEN:Z_LEN + nf] for r in s]).max(axis=0)
            caps = list(self.FAM_CAPS)
            fam_over = False
            for fi, fam in enumerate(self.expander.families):
                hard = fam.n_lanes * self.BL
                while caps[fi] < hard and famx[fi] > caps[fi]:
                    caps[fi] = min(2 * caps[fi], hard)
                    fam_over = True
            self.FAM_CAPS = tuple(caps)
            if not fam_over:
                self.FC *= 4
        if sovf:
            self.SC = 4 * self.SC
        # only the receive window's bound grows the shard: running it
        # near full is this engine's operating mode
        if self.LB < 2 * self.D * self.SC:
            self.LB = self._round_lb(2 * self.D * self.SC)
        if hcovf:
            hmax = max(r[-1] for r in s)
            while self.HCAP < 2 * hmax:
                self.HCAP *= 2
        if (self.LB, self.FC, self.SC) != old[:3]:
            self._grow_sharded()
        elif (self.FAM_CAPS, self.HCAP) != old[3:]:
            self._clear_graphs()
        if hovf:
            self.VB *= 4
            self._rehash_sharded()
        self._sgrow_table_if_needed(n_vis)
        if verbose:
            print(f"mesh trip at base {tb}: ovf={ovf} fovf={fovf} "
                  f"sovf={sovf} hovf={hovf} hcovf={hcovf} -> LB={self.LB} "
                  f"FC={self.FC} SC={self.SC} VB={self.VB}", flush=True)
        for sh in self._shards:
            for t in (sh.famx, sh.hmax, *sh.flags):
                t.zero_()
            sh.trip_base.fill_(-1)
            sh.base.fill_(tb)

    # ------------------------------------------------------------------
    # the run
    # ------------------------------------------------------------------

    def _root_blocks(self, seed_states):
        """The deduplicated roots as host blocks on their owners, their
        keys placed in the fresh table shards (the host twin of the
        probe).  Returns (result so far, blocks, keys per shard)."""
        D, W = self.D, self.W
        roots, rk, pin_interiors = self._dedup_roots(seed_states)
        res = CheckResult(distinct_states=0, generated_states=len(rk))
        self._check_pin_interiors(pin_interiors, res)
        per_dev: List[List[int]] = [[] for _ in range(D)]
        for r in range(len(rk)):
            per_dev[int(rk[r, W - 1]) % D].append(r)
        rows_t = rows_to_torch(roots, "cpu", self.ir.u32_keys)
        self._bind(self.devices[0])
        inv_r, con_r = (t.cpu().numpy() for t in self._phase2_T(rows_t))
        rows_n = storage_to_numpy(self.ir.narrow(self.lay, rows_t),
                                  self.ir.u32_keys)
        self._shards = self._new_shards()
        blks = [None] * D
        for d, sh in enumerate(self._shards):
            idx = per_dev[d]
            if not idx:
                continue
            rkd = rk[idx]
            slots = self._host_probe_assign(rkd, vcap=self.VB)
            sh.vis[:, torch.from_numpy(slots).long().to(sh.device)] = \
                torch.from_numpy(np.ascontiguousarray(rkd.T).view(
                    np.int32)).to(sh.device)
            blks[d] = dict(
                rows={k: np.ascontiguousarray(v[..., idx])
                      for k, v in rows_n.items()},
                lpar=np.full((len(idx),), -1, np.int32),
                llane=np.full((len(idx),), -1, np.int32),
                linv=inv_r[:, idx], lcon=con_r[idx], n=len(idx))
        return res, blks, np.array([len(p) for p in per_dev], np.int64)

    def check(self, max_depth: int = 10 ** 9, max_states: int = 10 ** 9,
              stop_on_violation: bool = False,
              seed_states: Optional[List] = None,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 1,
              resume_from: Optional[str] = None,
              resume_image=None,
              verbose: bool = False, obs=None) -> CheckResult:
        """As ``ShardedEngine.check``.  ``checkpoint_path`` writes the
        reference's pooled-wavefront file after a fused burst and at a
        level's end (every ``checkpoint_every`` levels); ``resume_from``
        resumes one written on a mesh of the same D, ``resume_image`` a
        ``resil.portable.PortableImage`` of any engine family (module
        docstring).  obs — the reference's spans: ``level_dispatch``,
        ``burst_dispatch``, ``harvest`` (one per spill event),
        ``archive_io``, ``checkpoint``; one ledger row per level and per
        burst."""
        if resume_from is not None and resume_image is not None:
            raise ValueError(
                "resume_from and resume_image are mutually exclusive")
        obs = self._obs = obs if obs is not None else NULL_OBS
        t0 = time.perf_counter()
        D = self.D
        self._bind(self.devices[0])
        self._load_kernels(obs)
        self.lockstep_steps = self.flag_reads = self.rehash_launches = 0
        self.captures = self.replays = 0
        self._reset_spill_counters()
        resumed = resume_from is not None or resume_image is not None
        if resume_from is not None:
            (res, frontier, n_states, n_vis,
             depth) = self._load_spill_mesh_checkpoint(resume_from)
        elif resume_image is not None:
            (res, frontier, n_states, n_vis,
             depth) = self._resume_portable(resume_image)
        else:
            self._init_store()
            self._cur_parts = []
            res, root_blks, n_vis = self._root_blocks(seed_states)
            n_states = depth = 0
        if resumed:
            self._restore_pin_interiors(res)
        self._stamp_mode(res)
        self._flag_buffers()
        # windows and graphs for the capacities this run starts from (a
        # resume restores the file's)
        self._fresh_buffers()

        def harvest_blocks(blks):
            """One spill event's blocks, shard-major: counts, violations,
            archive parts, and the next frontier's rows (pruned rows
            dropped).  Returns per shard (rows, gids) or None."""
            nonlocal n_states
            out = [None] * D
            with obs.span("harvest"):
                for d, blk in enumerate(blks):
                    if blk is None:
                        continue
                    n, rows = blk["n"], blk["rows"]
                    res.distinct_states += n
                    res.overflow_faults += int(
                        (rows["ctr"][C_OVERFLOW] > 0).sum())
                    gids = np.arange(n_states, n_states + n, dtype=np.int32)
                    if blk["linv"].size and not blk["linv"].all():
                        res.violations_global += self._decode_rows(
                            res, lambda s: {k: v[..., s]
                                            for k, v in rows.items()},
                            blk["linv"], n_states)
                    n_states += n
                    driver.guard_id_space(n_states)
                    if self.store_states:
                        self._cur_parts.append(dict(
                            n=n, lpar=blk["lpar"], llane=blk["llane"],
                            rows=rows))
                    con = blk["lcon"].astype(bool)
                    if con.all():
                        out[d] = (rows, gids)
                    elif con.any():
                        keep = np.nonzero(con)[0]
                        out[d] = ({k: v[..., keep] for k, v in rows.items()},
                                  gids[keep])
            return out

        if not resumed:
            frontier = [[] for _ in range(D)]
            for d, f in enumerate(harvest_blocks(root_blks)):
                if f is not None:
                    frontier[d].append(f)
            self._flush_level_parts()
        if stop_on_violation and res.violations:
            return self._done(res, depth, t0)

        # a burst that committed levels and then bailed keeps the bailing
        # level's frontier: re-entering would bail again, so that level
        # runs on the segment driver, which re-arms the burst
        burst_ok = True
        while any(frontier) and depth < max_depth and \
                res.distinct_states < max_states:
            # chaos site: a dispatch-time device error at the level
            # boundary, before any device work
            chaos_point("dispatch")
            if (self.burst and burst_ok and
                    max(sum(int(g.shape[0]) for _r, g in q)
                        for q in frontier) <= self._mesh_burst_width()):
                d0 = depth
                (frontier, depth, n_states, fused,
                 bailed) = self._burst_mesh_levels(
                    frontier, res, depth, n_states, n_vis, max_depth,
                    max_states, verbose)
                if fused:
                    burst_ok = not bailed
                    if checkpoint_path is not None and \
                            driver.ckpt_due_after_burst(
                                depth, d0, checkpoint_every):
                        self._save_spill_mesh_checkpoint(
                            checkpoint_path, res, frontier, depth,
                            n_states, n_vis)
                    if stop_on_violation and res.violations:
                        break
                    continue
            burst_ok = True
            depth += 1
            seg_rows = self.LB
            t1 = time.perf_counter()
            level_new = level_gen = 0
            next_frontier: List[List] = [[] for _ in range(D)]

            def settle(blks):
                nonlocal level_new
                for d, b in enumerate(blks):
                    if b is not None:
                        n_vis[d] += b["n"]
                        level_new += b["n"]
                for d, f in enumerate(harvest_blocks(blks)):
                    if f is not None:
                        next_frontier[d].append(f)

            with obs.span("level_dispatch"):
                s = None
                for seg in self._resegment_dev(frontier, seg_rows):
                    self._sgrow_table_if_needed(n_vis)
                    nf = self._upload_seg(seg)
                    while True:
                        self._run_level_steps(nf)
                        s = self._summary()
                        level_gen += sum(r[Z_NGEN] for r in s)
                        for sh in self._shards:
                            sh.n_gen.zero_()
                        if not any(r[Z_OVF] or r[Z_FOVF] or r[Z_SOVF] or
                                   r[Z_HOVF] or r[-2] for r in s):
                            break
                        self._handle_mesh_trip(s, n_vis, settle, verbose)
                # level end: spill the remainder everywhere
                blks = self._fetch_shards([r[Z_NLVL] for r in s])
            settle(blks)
            self._flush_level_parts()
            res.generated_states += level_gen
            depth = driver.gate_level_depth(
                res, depth, level_new, level_gen,
                sum(int(g.shape[0]) for q in next_frontier for _r, g in q))
            frontier = next_frontier
            # after the level's harvest and archive flush: the file holds
            # the post-prune frontier, the exact resume point
            if checkpoint_path is not None and \
                    driver.ckpt_due_at_level(depth, checkpoint_every):
                self._save_spill_mesh_checkpoint(
                    checkpoint_path, res, frontier, depth, n_states, n_vis)
            obs.dispatch(kind="level", depth=depth,
                         frontier=sum(int(g.shape[0])
                                      for q in frontier for _r, g in q),
                         metrics=res.metrics.as_dict())
            if stop_on_violation and res.violations:
                break
            if verbose:
                print(f"depth {depth}: +{level_new} states "
                      f"(total {res.distinct_states}), frontier "
                      f"{sum(int(g.shape[0]) for q in frontier for _r, g in q)}"
                      f", {time.perf_counter() - t1:.2f}s", flush=True)
        return self._done(res, depth, t0)

    # ------------------------------------------------------------------
    # checkpoints and resumes (the reference's pooled-wavefront file).
    # The slot layout is not in the file: membership is a set property,
    # and a resume rebuilds each shard's table with insert_np over the
    # file's keys in (shard, slot) order, the reference's images slot for
    # slot.  A file is written only at a level's end, where the stage-2
    # epoch has closed, so mid-level spills before or after it change
    # nothing.
    # ------------------------------------------------------------------

    _SM_EXTRA_KEYS = ("D", "LB", "VB", "FC", "SC", "fam_caps",
                      "host_table", "partitions")
    _SM_FMT = ("sm_format", 1, "the spill-mesh pooled-wavefront layout")

    def _empty_rows(self) -> Dict[str, np.ndarray]:
        """Zero batch-major rows in the storage dtypes."""
        return storage_to_numpy(
            {k: torch.zeros((0,) + s, dtype=dt)
             for k, (s, dt) in self._fields.items()}, self.ir.u32_keys)

    def _pool_frontier(self, frontier):
        """Every shard's frontier blocks (batch-last) -> (rows
        batch-major, gids) pooled in global-id order."""
        rows_l, gids_l = [], []
        for q in frontier:
            for rows, gids in q:
                rows_l.append(rows)
                gids_l.append(gids)
        if not gids_l:
            return self._empty_rows(), np.zeros((0,), np.int32)
        g = np.concatenate(gids_l)
        order = np.argsort(g, kind="stable")
        pf_rows = {k: np.ascontiguousarray(np.concatenate(
            [np.moveaxis(r[k], -1, 0) for r in rows_l])[order])
            for k in rows_l[0]}
        return pf_rows, g[order].astype(np.int32)

    def _save_spill_mesh_checkpoint(self, path, res, frontier, depth,
                                    n_states, n_vis):
        with self._obs.span("checkpoint"):
            pf_rows, pf_g = self._pool_frontier(frontier)
            # the shards as the reference's carry, W words of [D, VB]:
            # the keys come out in (shard, slot) order
            tabs = np.stack([words_to_numpy(sh.vis) for sh in self._shards])
            ckpt = {"pf|g": pf_g, "keys": dense_table_keys(
                [tabs[:, w] for w in range(self.W)])}
            for k, v in pf_rows.items():
                ckpt[f"pf|rows|{k}"] = v
            parents, lanes, states, arch_meta = self._ckpt_store_args()
            # the reference's meta, and the port's HCAP (the sort-mode
            # hard-lane bound: a resumed run trips where the interrupted
            # one did not without it)
            ckpt_write(path, ckpt, self.store_states, parents, lanes,
                       states, res, dict(
                           spill=True, sharded=True, sm_format=1,
                           D=self.D, W=self.W, host_table=self.host_table,
                           partitions=self.partitions,
                           depth=depth, n_states=n_states,
                           n_vis=[int(x) for x in n_vis],
                           n_front=int(pf_g.shape[0]),
                           LB=self.LB, VB=self.VB, FC=self.FC, SC=self.SC,
                           fam_caps=list(self.FAM_CAPS), **arch_meta,
                           layout=2, chunk=self.chunk, spec=self.ir.name,
                           sym_canon=self.fpr.sym_canon,
                           ir_fingerprint=self.ir.fingerprint(),
                           cfg=repr(self.cfg), HCAP=self.HCAP),
                       keep=self.ckpt_keep)

    def _load_spill_mesh_checkpoint(self, path):
        z, meta = ckpt_read(path, repr(self.cfg), self.chunk,
                            self._SM_EXTRA_KEYS, sharded=True, spill=True,
                            expected_format=self._SM_FMT,
                            spec_name=self.ir.name,
                            sym_canon=self.fpr.sym_canon)
        if meta["D"] != self.D:
            raise CheckpointError(
                f"checkpoint was written on a {meta['D']}-device "
                f"mesh; this engine has {self.D} devices — exact "
                "resume needs the same mesh, or re-partition with a "
                "portable resume (resume_image / --resume-portable)")
        if bool(meta.get("host_table")) != self.host_table:
            raise CheckpointError(
                f"{path}: checkpoint was written with host_table="
                f"{bool(meta.get('host_table'))}; resume with the "
                "same setting")
        if self.host_table and meta["partitions"] != self.partitions:
            raise CheckpointError(
                f"{path}: checkpoint has {meta['partitions']} "
                f"host-table partitions; engine has "
                f"{self.partitions} — resume with the same "
                "--partitions (counts are P-invariant, but the "
                "serialized images are not)")
        # the capacities decide the segments, so the spill events, row
        # order and global ids: the interrupted run's
        self.LB, self.VB, self.FC, self.SC = (
            int(meta["LB"]), int(meta["VB"]), int(meta["FC"]),
            int(meta["SC"]))
        self.FAM_CAPS = tuple(int(c) for c in meta["fam_caps"])
        self.HCAP = int(meta.get("HCAP", self.HCAP))
        rows = {nm.split("|", 3)[3]: np.asarray(z[nm]) for nm in z.files
                if nm.startswith("carry|pf|rows|")}
        gids = np.asarray(z["carry|pf|g"]).astype(np.int32)
        keys = np.asarray(z["carry|keys"]).astype(np.uint32)
        self._load_archives(path, z, meta, {"lvl": rows})
        self._cur_parts = []
        res = ckpt_result(z, meta)
        z.close()
        frontier, n_vis = self._restore_wavefront(keys, rows, gids,
                                                  exact_vb=True)
        return res, frontier, meta["n_states"], n_vis, meta["depth"]

    def _resume_portable(self, img):
        """A PortableImage of any engine family or mesh size onto this
        mesh: keys and frontier rows go to their owners."""
        validate_image(img, self.ir.name, repr(self.cfg), self.W)
        self._restore_portable_archives(img)
        self._cur_parts = []
        rows, gids = img.expandable()
        frontier, n_vis = self._restore_wavefront(
            img.keys.astype(np.uint32), rows, gids)
        return img.fresh_result(), frontier, img.n_states, n_vis, img.depth

    def _restore_wavefront(self, keys, rows, gids, exact_vb=False):
        """The pooled wavefront -> this mesh's shards: frontier rows and
        visited keys to their owners (``key[W-1] mod D``), each shard's
        table built on the host with ``insert_np`` and uploaded.  Outside
        an exact resume the table grows to the load bound first.
        Returns (frontier blocks per shard, n_vis)."""
        D, W = self.D, self.W
        self._bind(self.devices[0])
        frontier: List[List] = [[] for _ in range(D)]
        if gids.shape[0]:
            fkeys = SpillEngine._frontier_keys_of(self, rows)
            fowner = fkeys[:, W - 1].astype(np.int64) % D
            for d in range(D):
                idx = np.nonzero(fowner == d)[0]
                if len(idx):
                    frontier[d].append((
                        {k: np.ascontiguousarray(np.moveaxis(v[idx], 0, -1))
                         for k, v in rows.items()},
                        gids[idx].astype(np.int32)))
        owner = keys[:, W - 1].astype(np.int64) % D
        key_src = [np.ascontiguousarray(keys[owner == d]) for d in range(D)]
        n_vis = np.array([k.shape[0] for k in key_src], np.int64)
        if not exact_vb:
            while int(n_vis.max(initial=0)) + self.LB > \
                    self._LOAD_MAX * self.VB:
                self.VB *= 4
        self._shards = self._new_shards()
        for sh, kd in zip(self._shards, key_src):
            img = np.full((W, self.VB), np.uint32(0xFFFFFFFF), np.uint32)
            insert_np(img, kd)
            sh.vis.copy_(words_to_torch(img, sh.device))
        return frontier, n_vis

    # ------------------------------------------------------------------
    # the compacting mesh burst: while every shard's frontier fits the
    # ring, whole levels run in ShardedEngine._shard_burst, their pruned
    # rows leaving the next frontier on the device as the host path
    # drops them.  No mid-level spill happens inside a burst (a trip
    # bails the level), so the stage-2 epoch is the level and the burst's
    # device-major ids are the segment driver's (spill event, shard)
    # order: the same counts, archives and traces either way.
    # ------------------------------------------------------------------

    def _burst_mesh_levels(self, frontier, res, depth, n_states, n_vis,
                           max_depth, max_states, verbose):
        """One fused run of levels from the host frontier.  Returns
        (frontier, depth, n_states, fused, bailed): fused False means the
        first level bailed and the segment driver runs it (the host
        frontier untouched); bailed means the run ended in a bail."""
        t1 = time.perf_counter()
        D = self.D
        obs = self._obs
        with obs.span("burst_dispatch"):
            kbd = self._mesh_burst_width()
            seg = [SpillEngine._cat_seg([r for r, _g in q],
                                        [g for _r, g in q]) if q else None
                   for q in frontier]
            self._sgrow_table_if_needed(n_vis,
                                        min_add=self.burst_levels * kbd)
            nf = self._upload_seg(seg)
            # the burst's ids are device-major from g_off: the next id
            # this engine would assign
            for sh in self._shards:
                sh.g_off.fill_(n_states)
            nlev, bailed, nf_b, stats, arch = self._shard_burst(
                nf, min(self.burst_levels, max_depth - depth),
                max(1, min(max_states - res.distinct_states, 2 ** 31 - 1)))
        res.burst_dispatches += 1
        res.burst_bailouts += int(bailed)
        if nlev == 0:
            return frontier, depth, n_states, False, bailed

        def archive(li, _n):
            if not self.store_states:
                return
            a = arch[li][1]
            if len(a[0]):
                # shard-major: the segment driver's harvest order
                self._cur_parts.append(dict(n=len(a[0]), lpar=a[0],
                                            llane=a[1], rows_major=a[2]))

        def violations(li, _n, gid_base):
            nl, a = arch[li]
            off = gid_base
            for d, (rows, inv_ok) in enumerate(a[3]):
                self._decode_rows(res, lambda s: take_arrays(rows, s),
                                  inv_ok, off)
                off += nl[d]

        def visited(li, _n):
            self._flush_level_parts()
            n_vis[:] += arch[li][0]

        with obs.span("harvest"):
            depth, n_states = driver.harvest_fused_levels(
                res, nlev, lambda li: stats[li], depth, n_states,
                archive=archive, violations=violations, visited=visited)
        # the next frontier back to the host: the compacted rows
        frontier = [[] for _ in range(D)]
        for d, sh in enumerate(self._shards):
            n = nf_b[d]
            if n:
                rows = storage_to_numpy(
                    {k: v[..., :n] for k, v in sh.front.items()},
                    self.ir.u32_keys)
                frontier[d].append((rows, _t_to_np(sh.gids[:n].cpu())))
                self.bytes_down += sum(a.nbytes for a in rows.values()) + \
                    4 * n
        obs.dispatch(kind="burst", depth=depth,
                     frontier=sum(int(g.shape[0])
                                  for q in frontier for _r, g in q),
                     metrics=res.metrics.as_dict())
        if verbose:
            print(f"burst: {nlev} levels to depth {depth} "
                  f"(total {res.distinct_states}), frontier "
                  f"{sum(int(g.shape[0]) for q in frontier for _r, g in q)}"
                  f", {time.perf_counter() - t1:.2f}s", flush=True)
        return frontier, depth, n_states, True, bailed
