"""Sharded BFS: frontier data parallelism and hash-owned visited shards
(the reference's ``raft_tla_tpu/parallel/mesh.py``).

One controller drives D shards, each on a device of the list it is
given (a list may name one device several times: ``["cuda:0"] * 4``
runs four shards on one card, ``[torch.device("cpu")] * 4`` four on
the CPU):

- each shard holds its own frontier, level buffer, parent arrays and
  its shard of the visited table (``VB`` slots), all batch-last as the
  classic engine's;
- per lock-step step every shard expands its next ``BL = chunk / D``
  frontier rows and fingerprints the candidates, then routes each live
  candidate to its OWNER shard, ``key[W-1] mod D``, through fixed
  ``[D * SC]`` send windows (``SC`` slots per destination; a shard with
  more than ``SC`` candidates for one owner trips ``sovf``);
- the exchange hands shard e block e of every sender, in sender order
  (the reference's tiled ``all_to_all``).  With every shard on one
  device it is one strided copy per field; across devices, D^2 copies
  between the shards' devices (written for several cards, run only on
  one here);
- the owner claim-inserts the window into its table shard with the
  dedup kernel (``fingerprint.probe_claim_insert``: csrc/probe_claim.cu
  on the card, the plain twin on the CPU) and appends the fresh rows.

Global state ids are device-major per level: shard d's rows get
``g_off + prefix[d] + row``, prefix the exclusive sum of the shards'
level counts, so archives and traces concatenate the shards in order.

The survivor among equal-fingerprint candidates is CONTENT-CANONICAL,
as the reference's: the lexicographic minimum of (non-VIEW content,
parent fingerprint, lane) over the whole level's candidate multiset.
Stage 1 keeps, per receive window, the first candidate of each key in
a lexicographic sort over (key, content, parent fingerprint, lane,
index); PyTorch has no multi-key sort, so it is a chain of stable
int64 sorts from the last key to the first, two u32 words packed per
key (``canon_order``).  Stage 2 replaces a row that an earlier window
of the same level admitted when a smaller candidate of its key
arrives, through the ``lrow`` slot map.  The reachable set, counts and
witness traces are then the same for every shard count.

Host reads: one per lock-step step (the stacked [D, 2] (more, bad)
flags, the reference's while-loop condition), one per level (the
[D, K] scalar matrix of ``_finalize``), and the harvest's rows.  On the
card the step is captured as CUDA graphs (``engine/graph.GraphRunner``):
with every shard on one device, one graph holds every shard's front
half, the exchange and every back half; across devices, one graph per
device for the front halves and one for the back halves, the exchange
between them.  Each device's shards launch on one stream, in shard
order: shards of one device with the same ``VB`` share the dedup
kernel's claim scratch (``engine/cuda_ext._scratch``, keyed by device
and table size), which is safe only because their launches serialize.

The mesh burst (``_shard_burst``) fuses up to ``burst_levels`` levels
while every shard's frontier fits the ring width; a level that trips
any overflow or outgrows the ring is rolled back and bails to the
per-level path, as the reference's.  The port drives it from the host
with the same reads as the per-level path (the reference reads once a
burst), so it changes which levels fuse and the burst counters, not
the reads.

Checkpoints are the reference's sharded files (format 4, the carry's
leaves stacked with a leading D axis), so a file either package writes
resumes in the other at the same D; ``check(resume_image=)`` re-homes
any engine family's portable image onto this mesh by owner.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..convert import (rows_to_torch, sharded_carry_from_jax,
                       sharded_carry_to_jax, storage_rows_to_numpy,
                       words_to_torch)
from ..engine import driver
from ..engine.bfs import EMPTY, CheckResult, Engine, Violation
from ..engine.ckpt import (CheckpointError, ckpt_archives, ckpt_carry,
                           ckpt_read, ckpt_result, ckpt_write)
from ..engine.expand import Expander
from ..engine.fingerprint import probe_claim_insert
from ..engine.graph import GraphRunner
from ..engine.host_table import insert_np
from ..obs import NULL_OBS
from ..ops.codec import C_OVERFLOW
from ..resil.chaos import chaos_point
from ..utils import take_arrays

# sharded checkpoint format gate (the reference's): format 4 carries the
# gids table and trip_base
_SHARDED_CKPT_FORMAT = 4
_SHARDED_FMT = ("ckpt_format", _SHARDED_CKPT_FORMAT,
                "the carry replaced pg_off with the gids table and "
                "gained trip_base")

# a shard's 0-d counters and flags, under the reference's carry names
_SHARD_COUNTERS = ("n_lvl", "n_gen", "base", "g_off", "n_front",
                   "trip_base")
_SHARD_FLAGS = ("ovf", "fovf", "sovf", "hovf")

_U32 = 0xFFFFFFFF
_HALF = 1 << 31

# warn-once latch for uneven user chunk overrides (per process)
_warned_uneven_chunk = False


def _round_chunk_to_devices(chunk: int, n_devices: int) -> int:
    """Round ``chunk`` up to the next multiple of the mesh size: each
    shard expands chunk/D rows a step.  An override that does not divide
    is rounded up (never down: capacities are sized from the chunk),
    with one warning per process naming both numbers."""
    d = max(1, int(n_devices))
    rem = int(chunk) % d
    if rem == 0:
        return int(chunk)
    rounded = int(chunk) + (d - rem)
    global _warned_uneven_chunk
    if not _warned_uneven_chunk:
        _warned_uneven_chunk = True
        warnings.warn(
            f"chunk {chunk} is not a multiple of the {d}-device mesh; "
            f"rounded up to {rounded} ({rounded // d} frontier rows "
            "per device)", stacklevel=3)
    return rounded


def resolve_devices(devices) -> List[torch.device]:
    """The mesh's device list.  None: every visible CUDA device (raises
    without CUDA, as ``utils.resolve_device`` does); else each entry as
    a ``torch.device`` (a bare ``"cuda"`` is the current card), all of
    one type, repeats allowed."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=[torch.device("
                "'cpu')] * D to run the shards on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = torch.device(d)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available; pass devices=[torch.device("
                    "'cpu')] * D to run the shards on the CPU")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {d!r}")
        out.append(dev)
    if not out:
        raise ValueError("the mesh needs at least one device")
    if len({d.type for d in out}) > 1:
        raise ValueError("the mesh's devices must all be CUDA or all CPU")
    return out


def _u(x: torch.Tensor) -> torch.Tensor:
    """int32-carried u32 words -> int64 in [0, 2^32)."""
    return x.long() & _U32


def _pack(words: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sort words in [0, 2^32), most significant first -> int64 keys,
    two words each (the first word shifted into the signed high half),
    ordered as the word sequence is."""
    out = []
    for i in range(0, len(words), 2):
        if i + 1 < len(words):
            out.append((words[i] - _HALF) * (1 << 32) + words[i + 1])
        else:
            out.append(words[i])
    return out


def _lex_less(a: List[torch.Tensor], b: List[torch.Tensor]) -> torch.Tensor:
    """Lexicographic a < b over word lists of equal length (int64 [M]
    each, most significant first) -> bool [M]."""
    A, B = torch.stack(a), torch.stack(b)
    eq = (A == B).long()
    before = torch.cat([torch.ones_like(eq[:1]),
                        torch.cumprod(eq, 0)[:-1]])
    return ((A < B) & before.bool()).any(0)


def canon_order(words: List[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts M window rows lexicographically by
    ``words`` (int64 [M] each in [0, 2^32), most significant first) and
    then by index: stable sorts from the last packed key to the first
    (PyTorch has no multi-key sort)."""
    perm = torch.arange(words[0].shape[0], device=words[0].device)
    for k in reversed(_pack(words)):
        _s, i = torch.sort(k.index_select(0, perm), stable=True)
        perm = perm.index_select(0, i)
    return perm


def canonical_reps(keys: torch.Tensor,
                   words: List[torch.Tensor]) -> torch.Tensor:
    """Stage 1 of the canonical survivor: keys int32 [W, M] and the sort
    words (the W key words first, then content, parent fingerprint and
    lane) -> bool [M], each key's first row in that order."""
    order = canon_order(words)
    ks = keys.index_select(1, order)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device),
                       (ks[:, 1:] != ks[:, :-1]).any(0)])
    return torch.zeros(keys.shape[1], dtype=torch.bool,
                       device=keys.device).scatter_(0, order, first)


def route_to_owners(owner: torch.Tensor, D: int, SC: int):
    """Pack candidates into the send windows: owner int64 [FC] (D for a
    dead candidate) -> (sidx int64 [D * SC], each send slot's candidate
    slot, FC where empty; sovf bool 0-d, some owner got more than SC).
    Owner d's candidates fill block d in buffer order (the reference's
    sort by (owner, slot))."""
    FC, M, dev = owner.shape[0], D * SC, owner.device
    # owners on the outer axis: CUDA's scan along an inner axis is fast,
    # along the outer axis of [FC, D] it took over a millisecond a call
    hot = owner[None, :] == torch.arange(D, device=dev)[:, None]
    rank = (hot.long().cumsum(1) - 1).gather(
        0, owner.clamp(max=D - 1)[None, :])[0]
    live = owner < D
    sovf = (live & (rank >= SC)).any()
    dest = torch.where(live & (rank < SC), owner * SC + rank, M)
    sidx = torch.full((M + 1,), FC, dtype=torch.int64, device=dev).scatter_(
        0, dest, torch.arange(FC, device=dev))[:M]
    return sidx, sovf


class _Shard:
    """One shard's buffers (the reference's per-device carry leaves,
    batch-last).  The level-row buffers have a spare column at LB, and
    ``lrow`` a spare slot at VB, where stage 2's and stage 1's masked
    scatters go; the table is a flat buffer with a spare slot, its
    [W, VB] view the dedup kernel takes."""

    def __init__(self, eng: "ShardedEngine", dev: torch.device, lb: int,
                 vb: int, table: Optional[torch.Tensor] = None):
        W = eng.W
        self.device = dev
        self.set_table(table if table is not None else torch.full(
            (W * vb + 1,), EMPTY, dtype=torch.int32, device=dev), W)

        def full(shape, fill, dtype=torch.int32):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        self.lvl = {k: full(s + (lb + 1,), 0, dt)
                    for k, (s, dt) in eng._fields.items()}
        self.front = {k: full(s + (lb,), 0, dt)
                      for k, (s, dt) in eng._fields.items()}
        self.fmask = full((lb,), False, torch.bool)
        self.gids = full((lb,), -1)
        self.jslot = full((lb,), -1)
        self.linv = full((len(eng.inv_names), lb + 1), True, torch.bool)
        self.lcon = full((lb + 1,), True, torch.bool)
        self.lpar = full((lb + 1,), -1)
        self.llane = full((lb + 1,), -1)
        self.lpfp = full((W, lb + 1), -1)
        (self.n_lvl, self.n_gen, self.base, self.g_off, self.n_front,
         self.hmax) = (full((), 0, torch.int64) for _ in range(6))
        self.trip_base = full((), -1, torch.int64)
        self.ovf, self.fovf, self.sovf, self.hovf, self.hcovf = (
            full((), False, torch.bool) for _ in range(5))
        self.famx = full((len(eng.expander.families),), 0)
        if eng._step_atomic:
            # a step-atomic step's insert outcome, held from the insert
            # to the commit-or-revert (graphs apart across devices)
            M = eng.D * eng.SC
            self.s_fresh = full((M,), False, torch.bool)
            self.s_live = full((M,), False, torch.bool)
            self.s_pos = full((M,), 0)
            self.s_n_fresh, self.s_gen = (full((), 0, torch.int64)
                                         for _ in range(2))
            self.s_ovf, self.s_hv = (full((), False, torch.bool)
                                     for _ in range(2))

    def front_bad(self) -> torch.Tensor:
        """The trips a front half can raise (compaction, families, send
        window, sort-mode hard lanes)."""
        return self.fovf | self.sovf | self.hcovf

    def set_table(self, flat: torch.Tensor, W: int):
        self.vis_flat = flat
        self.vis = flat[:-1].view(W, -1)
        self.lrow = torch.full((self.vis.shape[1] + 1,), -1,
                               dtype=torch.int32, device=flat.device)

    @property
    def lb(self) -> int:
        return self.fmask.shape[0]

    @property
    def vb(self) -> int:
        return self.vis.shape[1]

    @property
    def flags(self):
        return self.ovf, self.fovf, self.sovf, self.hovf, self.hcovf

    def leaves(self) -> Dict:
        """The shard's carry leaves under the reference's names, in the
        port's layout (``convert.sharded_carry_to_jax``), spare columns
        cut, counters as int32."""
        lb = self.lb
        out = dict(vis=self.vis, lrow=self.lrow[:-1], jslot=self.jslot,
                   linv=self.linv[:, :lb], lcon=self.lcon[:lb],
                   lvl={k: v[..., :lb] for k, v in self.lvl.items()},
                   lpar=self.lpar[:lb], llane=self.llane[:lb],
                   lpfp=self.lpfp[:, :lb], gids=self.gids, famx=self.famx,
                   front=self.front, fmask=self.fmask)
        for k in _SHARD_COUNTERS:
            out[k] = getattr(self, k).to(torch.int32)
        for k in _SHARD_FLAGS:
            out[k] = getattr(self, k)
        return out

    def load(self, leaves: Dict, path: str):
        """Fill the shard from ``leaves`` (``leaves()``'s form), each
        checked against the buffer's shape and dtype."""
        def put(dst: torch.Tensor, src: torch.Tensor, name: str):
            if tuple(src.shape) != tuple(dst.shape) or \
                    src.dtype != dst.dtype:
                raise CheckpointError(
                    f"{path}: checkpoint leaf {name!r} is "
                    f"{src.dtype}{list(src.shape)}, the engine's "
                    f"{dst.dtype}{list(dst.shape)} — re-run without "
                    "--resume")
            dst.copy_(src)

        mine = self.leaves()
        for k, dst in mine.items():
            if k in _SHARD_COUNTERS:
                put(dst, leaves[k], k)
                getattr(self, k).copy_(leaves[k])
            elif isinstance(dst, dict):
                for f, v in dst.items():
                    put(v, leaves[k][f], f"{k}|{f}")
            else:
                put(dst, leaves[k], k)

    def reset(self):
        """The per-level state back to a level's start."""
        for t in (self.n_lvl, self.n_gen, self.base, self.famx, self.hmax,
                  *self.flags):
            t.zero_()
        self.trip_base.fill_(-1)
        self.lrow.fill_(-1)


class _Windows:
    """Every shard's send and receive windows: per field a [D, ..., M]
    buffer per device group, shard s's window its row.  The fields are
    the key words, the parent's global id, the lane, the parent's
    fingerprint and the candidate's narrow state fields."""

    def __init__(self, eng: "ShardedEngine", groups, M: int):
        W = eng.W
        fields = dict(key=((W,), torch.int32), pgid=((), torch.int32),
                      lane=((), torch.int32), pfp=((W,), torch.int32))
        fields.update({"row:" + k: v for k, v in eng._fields.items()})
        self.groups = groups
        self.M = M
        self.send, self.recv = [], []
        self.send_of: Dict[int, Dict] = {}
        self.recv_of: Dict[int, Dict] = {}
        for dev, shards in groups:
            n = len(shards)
            snd = {f: torch.zeros((n,) + s + (M,), dtype=dt, device=dev)
                   for f, (s, dt) in fields.items()}
            rcv = {f: torch.zeros_like(v) for f, v in snd.items()}
            self.send.append(snd)
            self.recv.append(rcv)
            for i, d in enumerate(shards):
                self.send_of[d] = {f: v[i] for f, v in snd.items()}
                self.recv_of[d] = {f: v[i] for f, v in rcv.items()}

    def exchange(self, D: int):
        """Shard e receives block e of every sender, in sender order."""
        SC = self.M // D
        if len(self.groups) == 1:
            for f, snd in self.send[0].items():
                s = snd.shape[1:-1]
                self.recv[0][f].view((D,) + s + (D, SC)).copy_(
                    snd.view((D,) + s + (D, SC)).transpose(0, -2))
            return
        for e in range(D):
            for d in range(D):
                for f, src in self.send_of[d].items():
                    self.recv_of[e][f][..., d * SC:(d + 1) * SC].copy_(
                        src[..., e * SC:(e + 1) * SC])


class ShardedEngine(Engine):
    """Engine whose BFS runs over D hash-owned shards (module docstring).

    devices — the shards' devices; None takes every visible CUDA device.
    chunk   — GLOBAL frontier rows per lock-step step (chunk/D per
              shard), rounded up to a multiple of D (one warning).
    lcap, vcap — the whole mesh's level rows and table slots (each shard
              holds lcap/D and vcap/D, VB a power of two), grown on
              overflow as the reference grows them; fcap as Engine's,
              FC = FCAP/D per shard; scap — send slots per (source,
              owner) pair (default 4·FC/D).

    The rest as ``Engine``.  ``_capture = False`` keeps the card
    eager."""

    def __init__(self, cfg: ModelConfig, devices=None, chunk: int = 512,
                 store_states: bool = True,
                 lcap: int = 1 << 14, vcap: int = 1 << 17,
                 fcap: Optional[int] = None, scap: Optional[int] = None,
                 burst: bool = True,
                 burst_levels: Optional[int] = None,
                 guard_matmul: bool = True,
                 dedup_kernel: str = "auto",
                 delta_matmul: bool = True,
                 fam_density=None,
                 sym_canon: str = "auto"):
        self.devices = resolve_devices(devices)
        self.D = len(self.devices)
        chunk = _round_chunk_to_devices(chunk, self.D)
        self.BL = chunk // self.D              # frontier rows per shard
        super().__init__(cfg, chunk=chunk, store_states=store_states,
                         lcap=lcap, vcap=vcap, fcap=fcap, burst=burst,
                         burst_levels=burst_levels,
                         guard_matmul=guard_matmul,
                         dedup_kernel=dedup_kernel,
                         delta_matmul=delta_matmul,
                         fam_density=fam_density, sym_canon=sym_canon,
                         device=str(self.devices[0]))
        # the sharded step hashes every candidate in full, as the
        # reference's (its fingerprints decide the table shards' bits)
        self.incremental_fp = False
        self.FC = max(256, (self.FCAP + self.D - 1) // self.D)
        self.VB = 1 << max(12, int(np.ceil(np.log2(
            max(vcap // self.D, 2)))))
        self.SC = int(scap) if scap else max(256, 4 * self.FC // self.D)
        self.LB = self._round_lb(max(lcap // self.D, 4 * self.FC,
                                     2 * self.D * self.SC))
        self.FAM_CAPS = tuple(self.expander.default_fam_caps(
            self.BL, self.fam_density))
        self.HCAP = self.BL
        # the spill-composed mesh's switches, off here as the reference's
        self._step_atomic = False
        self._burst_compact_frontier = False
        self._track_keys = False
        # device-bound members per device (the expander holds its
        # tables on one device; the rest take the device of their input)
        self._expanders = {self.devices[0]: self.expander}
        for dev in self.devices:
            if dev not in self._expanders:
                self._expanders[dev] = Expander(
                    cfg, dev, guard_matmul=self.guard_matmul,
                    delta_matmul=self.delta_matmul)
        self._caps_by_dev = {}
        groups: Dict[torch.device, List[int]] = {}
        for d, dev in enumerate(self.devices):
            groups.setdefault(dev, []).append(d)
        self._groups = list(groups.items())
        one = self.ir.narrow(self.lay, rows_to_torch(
            {k: v[None] for k, v in self.ir.encode(
                self.lay, *self.ir.init_state(self.cfg)).items()}, "cpu",
            self.ir.u32_keys))
        self._fields = {k: (tuple(v.shape[:-1]), v.dtype)
                        for k, v in one.items()}
        self._shards: List[_Shard] = []
        self._win: Optional[_Windows] = None
        self._runners: Dict[torch.device, GraphRunner] = {}
        # the last check()'s lock-step steps, host reads of their flags,
        # dedup launches of table rehashes, graph captures and replays
        self.lockstep_steps = self.flag_reads = self.rehash_launches = 0
        self.captures = self.replays = 0

    def _round_lb(self, n: int) -> int:
        b = self.BL
        return ((int(n) + b - 1) // b) * b

    def _mesh_burst_width(self) -> int:
        """Per-shard burst ring rows: the burst's entry gate compares
        the largest shard frontier with it."""
        return min(self._BURST_CHUNKS * self.BL, self.LB)

    def _bind(self, dev: torch.device):
        """Point the device-bound members at a shard's device."""
        self.device = dev
        self.expander = self._expanders[dev]

    def _caps_t(self) -> torch.Tensor:
        key = (self.device, self.FAM_CAPS)
        if key not in self._caps_by_dev:
            self._caps_by_dev[key] = torch.tensor(
                self.FAM_CAPS, dtype=torch.int32, device=self.device)
        return self._caps_by_dev[key]

    # ------------------------------------------------------------------
    # the buffers
    # ------------------------------------------------------------------

    def _new_shards(self, tables=None) -> List[_Shard]:
        return [_Shard(self, dev, self.LB, self.VB,
                       None if tables is None else tables[d])
                for d, dev in enumerate(self.devices)]

    def _flag_buffers(self):
        """Per device group: the step's [n, 2] flags the host reads and,
        step-atomic, the shards' trips and every shard's copy of them."""
        bools = [(dev, len(s)) for dev, s in self._groups]
        self._flags = [torch.zeros((n, 2), dtype=torch.bool, device=dev)
                       for dev, n in bools]
        self._trip_loc = [torch.zeros(n, dtype=torch.bool, device=dev)
                          for dev, n in bools]
        self._trip_all = [torch.zeros(self.D, dtype=torch.bool, device=dev)
                          for dev, _n in bools]

    def _fresh_buffers(self):
        """New windows and graph runners for the current capacities (a
        graph holds its buffers' addresses)."""
        self._win = _Windows(self, self._groups, self.D * self.SC)
        self._clear_graphs()

    def _clear_graphs(self):
        for r in self._runners.values():
            self.captures += r.captures
            self.replays += r.replays
            r.clear()
        self._runners = {dev: GraphRunner(dev, self._capture,
                                          obs=self._obs)
                         for dev, _ in self._groups}

    # ------------------------------------------------------------------
    # one lock-step step: every shard's front half, the exchange, every
    # shard's back half (the reference's _local_step around all_to_all)
    # ------------------------------------------------------------------

    def _front_half(self, d: int):
        """Expand and fingerprint shard d's next BL frontier rows and
        pack its live candidates into its send window by owner."""
        sh, snd = self._shards[d], self._win.send_of[d]
        B, A, W, D = self.BL, self.A, self.W, self.D
        FC, SC, LB = self.FC, self.SC, sh.lb
        self._bind(sh.device)
        rows = sh.base + torch.arange(B, device=sh.device)
        win = rows.clamp(max=LB - 1)
        sv = self.ir.widen({k: v.index_select(-1, win)
                            for k, v in sh.front.items()})
        valid = sh.fmask.index_select(0, win) & (rows < sh.n_front)
        cand, elive, keys, lanes, counts, n_e, n_gen, n_hard = \
            self._expand_fp_chunk(sv, valid, FC)
        torch.maximum(sh.famx, counts, out=sh.famx)
        sh.fovf |= (n_e > FC) | (sh.famx > self._caps_t()).any()
        # the parents' fingerprints: the mesh-invariant half of the
        # provenance key (gids are device-major, so mesh-dependent)
        pfp_par, nh_par = self.fpr.fingerprint_chunk_T(sv, self.HCAP,
                                                       live=valid)
        if n_hard is not None:
            nh = torch.maximum(n_hard, nh_par).long()
            sh.hcovf |= nh > self.HCAP
            torch.maximum(sh.hmax, nh, out=sh.hmax)
        if self._step_atomic:
            # counted at the commit, and only when the step commits
            sh.s_gen.copy_(n_gen)
        else:
            sh.n_gen += n_gen
        take = lanes.clamp(max=B * A - 1)
        prow = take // A
        pgid = sh.gids.index_select(0, (sh.base + prow).clamp(max=LB - 1))
        lane = (take % A).to(torch.int32)
        pfp = pfp_par.index_select(1, prow)                  # [W, FC]
        # route each live candidate to its owner's block
        sidx, sovf = route_to_owners(
            torch.where(elive, _u(keys[W - 1]) % D, D), D, SC)
        sh.sovf |= sovf
        sfill = sidx < FC
        stake = sidx.clamp(max=FC - 1)
        snd["key"].copy_(torch.where(sfill, keys.index_select(1, stake),
                                     EMPTY))
        rows_n = self.ir.narrow(self.lay, {k: v.index_select(-1, stake)
                                           for k, v in cand.items()})
        for k, v in rows_n.items():
            snd["row:" + k].copy_(v)
        snd["pgid"].copy_(torch.where(sfill, pgid.index_select(0, stake),
                                      -1))
        snd["lane"].copy_(torch.where(sfill, lane.index_select(0, stake),
                                      -1))
        snd["pfp"].copy_(torch.where(sfill, pfp.index_select(1, stake),
                                     EMPTY))

    def _content_words(self, rows: Dict[str, torch.Tensor], M: int):
        """The non-VIEW content of narrow rows [..., M] as sort words in
        [0, 2^32): each lane a signed value (the reference's int32 cast
        with its top bit flipped), in the reference's column order."""
        out = []
        for k in self.ir.nonview_keys:
            v = rows[k].long().reshape(-1, M) + _HALF
            out.extend(v.unbind(0))
        return out

    def _window_words(self, rcv, M: int):
        """A receive window's content and provenance sort words."""
        W = self.W
        rrow = {k: rcv["row:" + k] for k in self._fields}
        return (self._content_words(rrow, M),
                [_u(rcv["pfp"][w]) for w in range(W)] + [_u(rcv["lane"])])

    def _back_half(self, d: int):
        """Shard d's receive window: stage 1 of the canonical survivor,
        the dedup kernel on the table shard, the append, stage 2.  A
        step whose window would overflow the level shard reverts its own
        inserts (the level replays)."""
        t = self._back_insert(d)
        self._back_commit(d, t, t["ovf_now"])

    def _back_insert(self, d: int, pre: Optional[torch.Tensor] = None):
        """Stage 1 and the dedup launch on shard d's window; ``pre`` (a
        step-atomic step) is whether any shard's front half tripped,
        which gates every insert.  Returns the outcome: fresh, pos,
        live_rep, hv, n_fresh, ovf_now and the window's sort words."""
        sh, rcv = self._shards[d], self._win.recv_of[d]
        W, D, SC, LB = self.W, self.D, self.SC, sh.lb
        M = D * SC
        self._bind(sh.device)
        rk = rcv["key"]                                      # [W, M]
        recv_live = (rk != EMPTY).any(0)
        # a step that overflowed its compaction or send window replays:
        # nothing of it is inserted
        gate = ~(sh.ovf | sh.fovf | sh.sovf | sh.hovf | sh.hcovf)
        if pre is not None:
            gate = gate & ~pre
        cwords, pwords = self._window_words(rcv, M)
        kwords = [_u(rk[w]) for w in range(W)]
        rep = canonical_reps(rk, kwords + cwords + pwords)
        live_rep = recv_live & rep & gate
        fresh, pos, hv = probe_claim_insert(sh.vis, rk, live_rep)
        n_fresh = fresh.sum()
        return dict(fresh=fresh, pos=pos, live_rep=live_rep, hv=hv,
                    n_fresh=n_fresh, ovf_now=sh.n_lvl + n_fresh > LB - M,
                    cwords=cwords, pwords=pwords)

    def _back_insert_atomic(self, d: int, pre: torch.Tensor):
        """A step-atomic step's insert: its outcome is kept on the shard
        until every shard's trip is known."""
        sh = self._shards[d]
        t = self._back_insert(d, pre)
        for k in ("fresh", "pos", "hv", "n_fresh"):
            getattr(sh, "s_" + k).copy_(t[k])
        sh.s_live.copy_(t["live_rep"])
        sh.s_ovf.copy_(t["ovf_now"])

    def _back_commit_atomic(self, d: int, bad: torch.Tensor):
        """Commit shard d's kept insert, or revert it when any shard
        tripped (``bad``)."""
        sh = self._shards[d]
        cwords, pwords = self._window_words(self._win.recv_of[d],
                                            self.D * self.SC)
        self._back_commit(d, dict(
            fresh=sh.s_fresh, pos=sh.s_pos, live_rep=sh.s_live, hv=sh.s_hv,
            n_fresh=sh.s_n_fresh, ovf_now=sh.s_ovf, cwords=cwords,
            pwords=pwords), bad)

    def _back_commit(self, d: int, t: Dict, bad: torch.Tensor):
        """Revert the insert where ``bad`` (the shard's own level-shard
        overflow; in step-atomic mode, a trip on any shard), else append
        the fresh rows and run stage 2.  A step-atomic step records its
        cursor in ``trip_base`` when it trips and counts its generated
        states only when it commits."""
        sh, rcv = self._shards[d], self._win.recv_of[d]
        W, D, SC, LB, VB = self.W, self.D, self.SC, sh.lb, sh.vb
        M = D * SC
        self._bind(sh.device)
        dev = sh.device
        rrow = {k: rcv["row:" + k] for k in self._fields}
        rpgid, rlane, rpfp = rcv["pgid"], rcv["lane"], rcv["pfp"]
        fresh, pos, live_rep = t["fresh"], t["pos"], t["live_rep"]
        cwords, pwords = t["cwords"], t["pwords"]
        sh.hovf |= t["hv"]
        words = torch.arange(W, device=dev)[:, None] * VB
        idx = torch.where((fresh & bad)[None], pos.long()[None] + words,
                          W * VB)
        sh.vis_flat.index_fill_(0, idx.reshape(-1), EMPTY)
        fresh = fresh & ~bad
        n_fresh = torch.where(bad, 0, t["n_fresh"])
        sh.ovf |= t["ovf_now"]
        if self._step_atomic:
            sh.trip_base.copy_(torch.where(bad, sh.base, sh.trip_base))
            sh.n_gen += torch.where(bad, 0, sh.s_gen)
        cum = torch.cumsum(fresh, 0)
        lpos = torch.where(fresh, cum - 1, M)
        lidx = torch.zeros(M + 1, dtype=torch.int64, device=dev).scatter_(
            0, lpos, torch.arange(M, device=dev))[:M]
        start = sh.n_lvl.clamp(max=LB - M)
        dst = start + torch.arange(M, device=dev)
        # invariants/constraints of every window row: the append reads
        # them through lidx, stage 2's replacements their own lane
        inv_all, con_all = self._phase2_T(self.ir.widen(rrow))
        for k, v in sh.lvl.items():
            v.index_copy_(v.dim() - 1, dst, rrow[k].index_select(-1, lidx))
        sh.lpar.index_copy_(0, dst, rpgid.index_select(0, lidx))
        sh.llane.index_copy_(0, dst, rlane.index_select(0, lidx))
        sh.lpfp.index_copy_(1, dst, rpfp.index_select(1, lidx))
        sh.jslot.index_copy_(0, dst, pos.index_select(0, lidx))
        sh.linv.index_copy_(1, dst, inv_all.index_select(1, lidx))
        sh.lcon.index_copy_(0, dst, con_all.index_select(0, lidx))
        # stage 2: replace-if-smaller for duplicates of keys an EARLIER
        # window of this level admitted (one rep per key per window, so
        # the targets are distinct); a replaced row keeps its jslot
        sh.lrow.index_copy_(0, torch.where(fresh, pos.long(), VB),
                            (start + lpos).to(torch.int32))
        tgt = sh.lrow.index_select(0, pos.long().clamp(0, VB - 1))
        dup = live_rep & ~fresh & ~bad & (tgt >= 0)
        tgt_c = tgt.long().clamp(0, LB - 1)
        swords = self._content_words(
            {k: v.index_select(-1, tgt_c) for k, v in sh.lvl.items()}, M) + \
            [_u(sh.lpfp[w].index_select(0, tgt_c)) for w in range(W)] + \
            [_u(sh.llane.index_select(0, tgt_c))]
        repl = dup & _lex_less(cwords + pwords, swords)
        widx = torch.where(repl, tgt_c, LB)
        for k, v in sh.lvl.items():
            v.index_copy_(v.dim() - 1, widx, rrow[k])
        sh.lpar.index_copy_(0, widx, rpgid)
        sh.llane.index_copy_(0, widx, rlane)
        sh.lpfp.index_copy_(1, widx, rpfp)
        sh.linv.index_copy_(1, widx, inv_all)
        sh.lcon.index_copy_(0, widx, con_all)
        sh.n_lvl.copy_((sh.n_lvl + n_fresh).clamp(max=LB - M))
        sh.base += self.BL

    def _write_flags(self, g: int):
        """The group's [n, 2] (more, bad) flags, for the step's read."""
        for i, d in enumerate(self._groups[g][1]):
            sh = self._shards[d]
            self._flags[g][i, 0] = sh.base < sh.n_front
            self._flags[g][i, 1] = sh.ovf | sh.fovf | sh.sovf | sh.hovf | \
                sh.hcovf

    def _step_key(self, half: str):
        return (half, self.BL, self.FC, self.SC, self.LB, self.VB,
                tuple(self.FAM_CAPS), self.HCAP, self.fpr.sym_canon,
                bool(self.act_names))

    def _write_trips(self, g: int, post: bool):
        """The group's [n] step-atomic trips: the front halves' (before
        the inserts), then with each shard's level-shard overflow and
        probe budget (after them)."""
        for i, d in enumerate(self._groups[g][1]):
            sh = self._shards[d]
            bad = sh.front_bad()
            self._trip_loc[g][i] = (bad | sh.s_ovf | sh.s_hv) if post else bad

    def _share_trips(self):
        """Every group's trips to every device: the one copy between
        devices in the middle of a step-atomic step (written for several
        cards, run only on one here)."""
        off = 0
        for h in range(len(self._groups)):
            n = self._trip_loc[h].shape[0]
            for g in range(len(self._groups)):
                self._trip_all[g][off:off + n].copy_(self._trip_loc[h])
            off += n

    def _atomic_backs(self, shards: List[int], pre: torch.Tensor):
        """A step-atomic step's back halves on one device holding every
        shard: the inserts, the device-side decision whether any shard
        tripped, then every commit or revert."""
        for d in shards:
            self._back_insert_atomic(d, pre)
        bad = pre | torch.stack([self._shards[d].s_ovf | self._shards[d].s_hv
                                 for d in shards]).any()
        for d in shards:
            self._back_commit_atomic(d, bad)

    def _lockstep(self) -> List[List[bool]]:
        """One lock-step step of every shard; returns the [D, 2] flags
        (the step's one host read).  In step-atomic mode a trip on any
        shard reverts the step on every shard: with one device the
        decision is a reduction inside the step's graph; across devices
        the back halves split into an insert graph and a commit graph,
        with the shards' trips copied between devices before each."""
        atomic = self._step_atomic
        if len(self._groups) == 1:
            dev, shards = self._groups[0]

            def whole():
                for d in shards:
                    self._front_half(d)
                self._win.exchange(self.D)
                if atomic:
                    self._atomic_backs(shards, torch.stack(
                        [self._shards[d].front_bad() for d in shards]).any())
                else:
                    for d in shards:
                        self._back_half(d)
                self._write_flags(0)
            self._runners[dev].run(self._step_key("step"), whole)
        elif atomic:
            for g, (dev, shards) in enumerate(self._groups):
                self._runners[dev].run(
                    self._step_key("front"),
                    lambda g=g, s=shards: (
                        [self._front_half(d) for d in s],
                        self._write_trips(g, False)))
            self._win.exchange(self.D)
            self._share_trips()
            for g, (dev, shards) in enumerate(self._groups):
                self._runners[dev].run(
                    self._step_key("insert"),
                    lambda g=g, s=shards: (
                        [self._back_insert_atomic(d, self._trip_all[g].any())
                         for d in s], self._write_trips(g, True)))
            self._share_trips()
            for g, (dev, shards) in enumerate(self._groups):
                self._runners[dev].run(
                    self._step_key("commit"),
                    lambda g=g, s=shards: (
                        [self._back_commit_atomic(d, self._trip_all[g].any())
                         for d in s], self._write_flags(g)))
        else:
            for g, (dev, shards) in enumerate(self._groups):
                self._runners[dev].run(
                    self._step_key("front"),
                    lambda s=shards: [self._front_half(d) for d in s])
            self._win.exchange(self.D)
            for g, (dev, shards) in enumerate(self._groups):
                self._runners[dev].run(
                    self._step_key("back"),
                    lambda g=g, s=shards: (
                        [self._back_half(d) for d in s],
                        self._write_flags(g)))
        self.lockstep_steps += 1
        return self._read_flags()

    def _read_flags(self) -> List[List[bool]]:
        """The step's one host read: every shard's (more, bad)."""
        self.flag_reads += 1
        got = [None] * self.D
        for g, (_dev, shards) in enumerate(self._groups):
            for d, f in zip(shards, self._flags[g].tolist()):
                got[d] = f
        return got

    def _run_level_steps(self, n_front: List[int]):
        """Lock-step steps while any shard has frontier rows left and no
        shard has tripped a flag (the reference's level while-loop)."""
        if not any(n_front):
            return
        while True:
            f = self._lockstep()
            if not any(m for m, _b in f) or any(b for _m, b in f):
                return

    # ------------------------------------------------------------------
    # the level's finalize: one read, then commit or journal rollback
    # ------------------------------------------------------------------

    def _finalize(self, kbd: Optional[int] = None):
        """Read every shard's level scalars (one [D, K] matrix), then
        commit the level on every shard or, when any shard tripped (or,
        in a burst, outgrew ``kbd`` rows), roll every table shard back
        through its insert journal.  Returns (scal int [D, K]: n_lvl,
        n_viol, faults, n_front after the commit or rollback, ovf, fovf,
        n_gen, n_expand, sovf, hovf, famx..., hcovf, the most hard lanes
        in a step; bad)."""
        rows = []
        for sh in self._shards:
            valid = torch.arange(sh.lb, device=sh.device) < sh.n_lvl
            n_viol = (~sh.linv[:, :sh.lb] & valid).sum()
            faults = ((sh.lvl["ctr"][C_OVERFLOW, :sh.lb] > 0) & valid).sum()
            n_expand = (sh.lcon[:sh.lb] & valid).sum()
            rows.append(torch.cat([torch.stack([
                sh.n_lvl, n_viol, faults, sh.n_front, sh.ovf.long(),
                sh.fovf.long(), sh.n_gen, n_expand, sh.sovf.long(),
                sh.hovf.long()]), sh.famx.long(),
                torch.stack([sh.hcovf.long(), sh.hmax])]))
        scal = self._read_rows(rows)
        nl = [r[0] for r in scal]
        bad = any(r[4] or r[5] or r[8] or r[9] or r[-2] for r in scal)
        if kbd is not None:
            bad = bad or max(nl) > kbd
        prefix = np.cumsum(nl) - np.asarray(nl)
        total = int(sum(nl))
        for d, sh in enumerate(self._shards):
            n = nl[d]
            if bad:
                # clear exactly the journaled inserts (a cleared cohort
                # postdates every surviving key)
                sh.vis[:, sh.jslot[:n].long()] = EMPTY
            else:
                ar = torch.arange(sh.lb, device=sh.device)
                keep = sh.lcon[:sh.lb] & (ar < n)
                gids = (sh.g_off + int(prefix[d]) + ar).to(torch.int32)
                if self._burst_compact_frontier:
                    # the spill-composed mesh: the pruned rows leave the
                    # next frontier here, as its host path drops them, so
                    # the windows pack (and the gids fall) as there
                    n = scal[d][7]
                    kpos = torch.where(keep, torch.cumsum(keep, 0) - 1,
                                       sh.lb)
                    kidx = torch.zeros(sh.lb + 1, dtype=torch.int64,
                                       device=sh.device).scatter_(
                        0, kpos, ar)[:n]
                    sh.fmask.copy_(ar < n)
                    sh.gids[:n] = gids.index_select(0, kidx)
                    for k, v in sh.front.items():
                        v[..., :n] = sh.lvl[k].index_select(-1, kidx)
                else:
                    sh.fmask.copy_(keep)
                    sh.gids.copy_(gids)
                    for k, v in sh.front.items():
                        v[..., :n] = sh.lvl[k][..., :n]
                sh.n_front.fill_(n)
                sh.g_off += total
                scal[d][3] = n
            sh.reset()
        return scal, bad

    def _read_rows(self, rows: List[torch.Tensor]) -> List[List[int]]:
        """Per-shard int rows -> host lists: one read per device group."""
        out = [None] * self.D
        for _dev, shards in self._groups:
            got = torch.stack([rows[d] for d in shards]).tolist()
            for d, r in zip(shards, got):
                out[d] = r
        return out

    def _host_rows(self, d: int, n: int):
        """Shard d's committed level: its first n level rows, parents
        and lanes, on the host (read before the next level's first
        step)."""
        sh = self._shards[d]
        return (storage_rows_to_numpy({k: v[..., :n]
                                       for k, v in sh.lvl.items()},
                                      self.ir.u32_keys),
                sh.lpar[:n].cpu().numpy().copy(),
                sh.llane[:n].cpu().numpy().copy())

    def _level_archive(self, nl, viol: bool):
        """The committed level's device-major rows: (parents, lanes,
        states, per-shard (rows, inv_ok) for decoding violations), each
        None where not needed."""
        if not (self.store_states or viol):
            return None
        got = [self._host_rows(d, nl[d]) for d in range(self.D)]
        per = [(g[0], self._shards[d].linv[:, :nl[d]].cpu().numpy())
               for d, g in enumerate(got)] if viol else None
        if not self.store_states:
            return None, None, None, per
        return (np.concatenate([g[1] for g in got]),
                np.concatenate([g[2] for g in got]),
                {k: np.concatenate([g[0][k] for g in got])
                 for k in got[0][0]}, per)

    def _decode_violations(self, res, per, nl, gid_base: int):
        prefix = np.cumsum(nl) - np.asarray(nl)
        for d, (rows, inv_ok) in enumerate(per):
            for j, nm in enumerate(self.inv_names):
                for s in np.nonzero(~inv_ok[j])[0]:
                    vsv, vh = self.ir.decode(self.lay,
                                             take_arrays(rows, int(s)))
                    res.violations.append(Violation(
                        nm, gid_base + int(prefix[d]) + int(s),
                        state=vsv, hist=vh))

    # ------------------------------------------------------------------
    # the mesh burst (the reference's _shard_burst)
    # ------------------------------------------------------------------

    def _shard_burst(self, n_front: List[int], lv_left: int, st_cap: int):
        """Up to ``lv_left`` levels (and ``st_cap`` new states), each
        committed on every shard unless a shard trips or outgrows the
        ring width; stops after a level with violations.  Returns
        (levels, bail, n_front per shard, stats [levels, 5], archives
        per level)."""
        kbd = self._mesh_burst_width()
        li = done = 0
        bail = viol = False
        stats, arch = [], []
        while not bail and not viol and li < lv_left and any(n_front) \
                and done < st_cap:
            self._run_level_steps(n_front)
            scal, bad = self._finalize(kbd)
            if bad:
                bail = True
                break
            nl = [r[0] for r in scal]
            n_viol = sum(r[1] for r in scal)
            stats.append((sum(nl), n_viol, sum(r[2] for r in scal),
                          sum(r[7] for r in scal), sum(r[6] for r in scal)))
            arch.append((nl, self._level_archive(nl, n_viol > 0)))
            n_front = [r[3] for r in scal]
            li += 1
            viol = n_viol > 0
            done += sum(nl)
        return li, bail, n_front, stats, arch

    # ------------------------------------------------------------------
    # table growth
    # ------------------------------------------------------------------

    def _rehash_sharded(self):
        """Every table shard claim-inserted, in ascending slot order,
        into a fresh table of ``self.VB`` slots by the dedup kernel (its
        twin on the CPU).  The reference rehashes with its lax claim
        walk, which may place contended keys elsewhere: membership is
        the same, the slots may differ."""
        for sh in self._shards:
            keys = sh.vis[:, ~(sh.vis == EMPTY).all(0)].contiguous()
            flat = torch.full((self.W * self.VB + 1,), EMPTY,
                              dtype=torch.int32, device=sh.device)
            if keys.shape[1]:
                live = torch.ones(keys.shape[1], dtype=torch.bool,
                                  device=sh.device)
                _f, _p, hv = probe_claim_insert(
                    flat[:-1].view(self.W, self.VB), keys, live)
                self.rehash_launches += 1
                if bool(hv):
                    raise RuntimeError("sharded rehash did not converge "
                                       "— table pathologically full; "
                                       "raise vcap")
            sh.set_table(flat, self.W)
        self._clear_graphs()

    def _grow_sharded(self):
        """Re-home the shards in buffers of the current LB, FC and SC:
        the frontier, its gids and the table survive; the level buffer
        resets (the level replays).  Grow the table first."""
        old = self._shards
        self._shards = self._new_shards([sh.vis_flat for sh in old])
        for o, sh in zip(old, self._shards):
            n = o.lb
            for k, v in o.front.items():
                sh.front[k][..., :n] = v
            sh.fmask[:n] = o.fmask
            sh.gids[:n] = o.gids
            sh.n_front.copy_(o.n_front)
            sh.g_off.copy_(o.g_off)
        self._fresh_buffers()

    # ------------------------------------------------------------------
    # the run
    # ------------------------------------------------------------------

    def _admit_roots(self, seed_states):
        """Deduplicated roots routed to their owners' level buffers and
        placed in their table shards (the host twin of the probe), ready
        for the first finalize.  Returns the result so far."""
        D, W = self.D, self.W
        roots, rk, pin_interiors = self._dedup_roots(seed_states)
        per_dev: List[List[int]] = [[] for _ in range(D)]
        for r in range(len(rk)):
            per_dev[int(rk[r, W - 1]) % D].append(r)
        # the most-loaded shard's seeds fit beside the receive window
        max_seed = max(len(p) for p in per_dev)
        while self.LB - self.D * self.SC < 2 * max_seed:
            self.LB = self._round_lb(2 * self.LB)
        while max_seed + self.LB > self._LOAD_MAX * self.VB:
            self.VB *= 4
        res = CheckResult(distinct_states=0, generated_states=len(rk))
        self._check_pin_interiors(pin_interiors, res)
        self._states, self._parents, self._lanes = [], [], []
        self._arch = None
        rows_t = rows_to_torch(roots, "cpu", self.ir.u32_keys)
        self._bind(self.devices[0])
        inv_r, con_r = self._phase2_T(rows_t)
        rows_n = self.ir.narrow(self.lay, rows_t)
        self._shards = self._new_shards()
        nl = [len(p) for p in per_dev]
        pref = np.cumsum(nl) - np.asarray(nl)
        for d, sh in enumerate(self._shards):
            idx = torch.tensor(per_dev[d], dtype=torch.int64)
            n = len(per_dev[d])
            if not n:
                continue
            for k, v in sh.lvl.items():
                v[..., :n] = rows_n[k].index_select(-1, idx).to(sh.device)
            sh.linv[:, :n] = inv_r.index_select(1, idx).to(sh.device)
            sh.lcon[:n] = con_r.index_select(0, idx).to(sh.device)
            sh.gids[:n] = torch.arange(n, dtype=torch.int32) + int(pref[d])
            rkd = rk[per_dev[d]]
            slots = self._host_probe_assign(rkd, vcap=self.VB)
            sh.vis[:, torch.from_numpy(slots).long().to(sh.device)] = \
                words_to_torch(rkd.T, sh.device)
            sh.jslot[:n] = torch.from_numpy(slots).to(sh.device)
            sh.n_lvl.fill_(n)
        return res

    def check(self, max_depth: int = 10 ** 9, max_states: int = 10 ** 9,
              stop_on_violation: bool = False,
              seed_states: Optional[List] = None,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 1,
              resume_from: Optional[str] = None,
              resume_image=None,
              verbose: bool = False, obs=None) -> CheckResult:
        """As ``Engine.check``.  ``resume_image`` — a ``resil.portable.
        PortableImage`` of ANY engine family's checkpoint: its keys and
        frontier rows are re-homed onto this mesh by owner, so a file
        written on another shard count (or by the classic or spill
        engines) resumes here."""
        obs = self._obs = obs if obs is not None else NULL_OBS
        t0 = time.perf_counter()
        D = self.D
        if resume_from is not None and resume_image is not None:
            raise ValueError(
                "resume_from and resume_image are mutually exclusive")
        self._bind(self.devices[0])
        self._load_kernels(obs)
        self.lockstep_steps = self.flag_reads = self.rehash_launches = 0
        self.captures = self.replays = 0
        if resume_from is not None:
            res, meta = self._load_checkpoint(resume_from)
            n_states = meta["n_states"]
            n_vis = np.asarray(meta["n_vis"], dtype=np.int64)
            depth = meta["depth"]
            resumed = True
            self._restore_pin_interiors(res)
        elif resume_image is not None:
            res, n_states, n_vis, depth = self._resume_portable(
                resume_image)
            resumed = True
            self._restore_pin_interiors(res)
        else:
            res = self._admit_roots(seed_states)
            n_states = 0
            n_vis = np.zeros((D,), np.int64)
            depth = 0
            resumed = False
        self._stamp_mode(res)
        self._flag_buffers()
        self._fresh_buffers()

        def grow_table_if_needed(min_add=0):
            # pessimistic per-shard load bound, checked between levels
            need = int(n_vis.max()) + max(self.LB, min_add)
            if need > self._LOAD_MAX * self.VB:
                while need > self._LOAD_MAX * self.VB:
                    self.VB *= 4
                self._rehash_sharded()

        def harvest(scal):
            nonlocal n_states
            nl = [r[0] for r in scal]
            n_lvl = sum(nl)
            n_viol = sum(r[1] for r in scal)
            res.distinct_states += n_lvl
            res.overflow_faults += sum(r[2] for r in scal)
            res.generated_states += sum(r[6] for r in scal)
            res.violations_global += n_viol
            a = self._level_archive(nl, n_viol > 0)
            if self.store_states:
                self._parents.append(a[0])
                self._lanes.append(a[1])
                self._states.append(a[2])
            if n_viol:
                self._decode_violations(res, a[3], nl, n_states)
            n_states += n_lvl
            n_vis[:] += nl
            driver.guard_id_space(n_states)
            return [r[3] for r in scal]

        if resumed:
            nf = [int(sh.n_front) for sh in self._shards]
        else:
            scal, _bad = self._finalize()
            nf = harvest(scal)
        if stop_on_violation and res.violations_global:
            return self._done(res, depth, t0)
        burst_ok = True
        while max(nf) and depth < max_depth and \
                res.distinct_states < max_states:
            # chaos site: a dispatch-time device error at the level
            # boundary, before any device work
            chaos_point("dispatch")
            kbd = self._mesh_burst_width()
            if self.burst and burst_ok and max(nf) <= kbd:
                t1 = time.perf_counter()
                with obs.span("burst_dispatch"):
                    grow_table_if_needed(self.burst_levels * kbd)
                    nlev, bailed, nf_b, stats, arch = \
                        self._shard_burst(
                            nf, min(self.burst_levels, max_depth - depth),
                            max(1, min(max_states - res.distinct_states,
                                       2 ** 31 - 1)))
                res.burst_dispatches += 1
                res.burst_bailouts += int(bailed)
                if nlev:
                    burst_ok = not bailed
                    nf = nf_b
                    d0 = depth
                    with obs.span("harvest"):
                        depth, n_states = self._harvest_burst(
                            res, nlev, stats, arch, depth, n_states,
                            n_vis)
                    if checkpoint_path is not None and \
                            driver.ckpt_due_after_burst(
                                depth, d0, checkpoint_every):
                        self._save_checkpoint(checkpoint_path, res, depth,
                                              n_states, n_vis, max(nf))
                    obs.dispatch(kind="burst", depth=depth,
                                 frontier=max(nf),
                                 metrics=res.metrics.as_dict())
                    if stop_on_violation and res.violations_global:
                        break
                    if verbose:
                        print(f"burst: {nlev} levels to depth {depth} "
                              f"(total {res.distinct_states}), "
                              f"frontier(max/dev) {max(nf)}, "
                              f"{time.perf_counter() - t1:.2f}s")
                    continue
            burst_ok = True
            depth += 1
            with obs.span("level_dispatch"):
                grow_table_if_needed()
                while True:
                    self._run_level_steps(nf)
                    scal, bad = self._finalize()
                    if not bad:
                        break
                    self._grow_after(scal, verbose, depth)
                    grow_table_if_needed()
            with obs.span("harvest"):
                nf = harvest(scal)
            depth = driver.gate_level_depth(
                res, depth, sum(r[0] for r in scal),
                sum(r[6] for r in scal), sum(r[7] for r in scal))
            if checkpoint_path is not None and \
                    driver.ckpt_due_at_level(depth, checkpoint_every):
                self._save_checkpoint(checkpoint_path, res, depth,
                                      n_states, n_vis, max(nf))
            obs.dispatch(kind="level", depth=depth, frontier=max(nf),
                         metrics=res.metrics.as_dict())
            if stop_on_violation and res.violations_global:
                break
            if verbose:
                print(f"depth {depth}: +{sum(r[0] for r in scal)} states "
                      f"(total {res.distinct_states}), "
                      f"frontier(max/dev) {max(nf)}")
        return self._done(res, depth, t0)

    def _done(self, res, depth, t0):
        res.depth = depth
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)
        self._clear_graphs()
        res.seconds = time.perf_counter() - t0
        return res

    def _grow_after(self, scal, verbose, depth):
        """A level tripped: grow what overflowed (the reference's
        order) and re-home the shards; the level replays."""
        ovf = any(r[4] for r in scal)
        fovf = any(r[5] for r in scal)
        sovf = any(r[8] for r in scal)
        hovf = any(r[9] for r in scal)
        hcovf = any(r[-2] for r in scal)
        old = (self.LB, self.FC, self.SC, self.FAM_CAPS, self.HCAP)
        if fovf:
            nf = len(self.FAM_CAPS)
            famx = np.asarray([r[10:10 + nf] for r in scal]).max(axis=0)
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
        if sovf or (fovf and self.FC != old[1]):
            self.SC = max(4 * self.SC, 4 * self.FC // self.D)
        if ovf or self.LB < max(4 * self.FC, 2 * self.D * self.SC):
            self.LB = self._round_lb(
                max((4 * self.LB) if ovf else self.LB,
                    4 * self.FC, 2 * self.D * self.SC))
        if hcovf:
            hmax = max(r[-1] for r in scal)
            while self.HCAP < 2 * hmax:
                self.HCAP *= 2
        if hovf:
            self.VB *= 4
            self._rehash_sharded()
        if verbose:
            print(f"level {depth}: overflow (ovf={ovf} fovf={fovf} "
                  f"sovf={sovf} hovf={hovf} hcovf={hcovf}), LB={self.LB} "
                  f"FC={self.FC} SC={self.SC} VB={self.VB}")
        if (self.LB, self.FC, self.SC) != old[:3]:
            self._grow_sharded()
        elif (self.FAM_CAPS, self.HCAP) != old[3:]:
            self._clear_graphs()

    def _harvest_burst(self, res, nlev, stats, arch, depth, n_states,
                       n_vis):
        def archive(li, _n):
            if self.store_states:
                a = arch[li][1]
                self._parents.append(a[0])
                self._lanes.append(a[1])
                self._states.append(a[2])

        def violations(li, _n, gid_base):
            nl, a = arch[li]
            self._decode_violations(res, a[3], nl, gid_base)

        def visited(li, _n):
            n_vis[:] += arch[li][0]

        return driver.harvest_fused_levels(
            res, nlev, lambda li: stats[li], depth, n_states,
            archive=archive, violations=violations, visited=visited)

    # ------------------------------------------------------------------
    # checkpoints (the reference's sharded format 4) and resume
    # ------------------------------------------------------------------

    def _carry_numpy(self) -> dict:
        """The shards as the reference's sharded carry (``convert.
        sharded_carry_to_jax``)."""
        return sharded_carry_to_jax([sh.leaves() for sh in self._shards],
                                    self.FC, self.SC, self.ir.u32_keys)

    def _carry_template(self) -> dict:
        fields = dict.fromkeys(self._fields)
        keys = ("claims", "lrow", "jslot", "linv", "lcon", "lpar", "llane",
                "lpfp", "gids", "trip_base", "cidx", "sscr") + \
            _SHARD_COUNTERS + _SHARD_FLAGS + ("famx", "fmask")
        return dict(dict.fromkeys(keys), vis=(None,) * self.W,
                    lvl=fields, front=dict(fields))

    def _shards_from_carry(self, path, carry: dict):
        """Shards at the current capacities holding a reference carry
        (``convert.sharded_carry_from_jax``), every leaf checked against
        the engine's shape and dtype."""
        self._shards = self._new_shards()
        for sh, leaves in zip(self._shards, sharded_carry_from_jax(
                carry, self.devices)):
            sh.load(leaves, path)

    def _save_checkpoint(self, path, res, depth, n_states, n_vis, n_front):
        with self._obs.span("checkpoint"):
            ckpt_write(path, self._carry_numpy(), self.store_states,
                       self._parents, self._lanes, self._states, res, dict(
                           sharded=True,
                           ckpt_format=_SHARDED_CKPT_FORMAT, D=self.D,
                           chunk=self.chunk, LB=self.LB, VB=self.VB,
                           FC=self.FC, SC=self.SC,
                           fam_caps=list(self.FAM_CAPS),
                           depth=depth, n_states=n_states,
                           n_vis=[int(x) for x in n_vis],
                           n_front=int(n_front), spec=self.ir.name,
                           sym_canon=self.fpr.sym_canon,
                           ir_fingerprint=self.ir.fingerprint(),
                           cfg=repr(self.cfg), HCAP=self.HCAP),
                       keep=self.ckpt_keep)

    def _load_checkpoint(self, path):
        z, meta = ckpt_read(path, repr(self.cfg), self.chunk,
                            ("D", "LB", "VB", "FC", "SC", "fam_caps"),
                            sharded=True, expected_format=_SHARDED_FMT,
                            spec_name=self.ir.name,
                            sym_canon=self.fpr.sym_canon)
        if meta["D"] != self.D:
            raise CheckpointError(
                f"checkpoint was written on a {meta['D']}-device mesh; "
                f"this engine has {self.D} devices (shard ownership is "
                "mesh-size dependent)")
        self.LB, self.VB, self.FC, self.SC = (
            meta["LB"], meta["VB"], meta["FC"], meta["SC"])
        self.FAM_CAPS = tuple(int(c) for c in meta["fam_caps"])
        self.HCAP = int(meta.get("HCAP", self.HCAP))
        template = self._carry_template()
        carry = ckpt_carry(path, z, template, np.asarray)
        self._shards_from_carry(path, carry)
        del carry
        self._arch = None
        self._parents, self._lanes, self._states = ckpt_archives(
            z, meta, template, self.store_states)
        res = ckpt_result(z, meta)
        z.close()
        return res, meta

    def _resume_portable(self, img):
        """Rebuild a level-boundary mesh from a PortableImage: visited
        keys and frontier rows go to their owners (``key[W-1] mod D``,
        pure content, so any source shape re-partitions), each table
        shard is built with the reference's host insert, and the gids
        come from the image.  Constraint-pruned rows are dropped (never
        expanded; gids are explicit here)."""
        from ..resil.portable import validate_image
        D, W = self.D, self.W
        validate_image(img, self.ir.name, repr(self.cfg), W)
        self._restore_portable_archives(img)
        keys = img.keys
        owner = (keys[:, W - 1].astype(np.int64)) % D
        n_vis = np.bincount(owner, minlength=D).astype(np.int64)
        rows, gids = img.expandable()
        if gids.shape[0]:
            self._bind(self.devices[0])
            fk = self.fpr.fingerprint_batch_T(self.ir.widen(rows_to_torch(
                rows, self.device, self.ir.u32_keys)))
            fkeys = fk.cpu().numpy().view(np.uint32).T
            fowner = (fkeys[:, W - 1].astype(np.int64)) % D
        else:
            fowner = np.zeros((0,), np.int64)
        per_dev = [np.nonzero(fowner == d)[0] for d in range(D)]
        max_rows = max((len(p) for p in per_dev), default=0)
        # LB first, then the table against the final LB (the root
        # admission's order)
        while self.LB - self.D * self.SC < 2 * max(max_rows, 1):
            self.LB = self._round_lb(2 * self.LB)
        while int(n_vis.max()) + self.LB > self._LOAD_MAX * self.VB:
            self.VB *= 4
        self._shards = self._new_shards()
        for d, sh in enumerate(self._shards):
            kd = keys[owner == d]
            if kd.shape[0]:
                tbl = np.full((W, self.VB), np.uint32(0xFFFFFFFF),
                              np.uint32)
                insert_np(tbl, kd.astype(np.uint32))
                sh.vis.copy_(words_to_torch(tbl, sh.device))
            idx = per_dev[d]
            n = len(idx)
            if n:
                rt = rows_to_torch({k: v[idx] for k, v in rows.items()},
                                   "cpu", self.ir.u32_keys)
                for k, v in self.ir.narrow(self.lay, rt).items():
                    sh.front[k][..., :n] = v.to(sh.device)
                sh.gids[:n] = torch.from_numpy(
                    np.asarray(gids[idx], np.int32)).to(sh.device)
                sh.fmask[:n] = True
            sh.n_front.fill_(n)
            sh.g_off.fill_(int(img.n_states))
        return img.fresh_result(), img.n_states, n_vis, img.depth

    # ------------------------------------------------------------------
    # the collective demo the reference keeps for its multi-device dry
    # run (__graft_entry__.py)
    # ------------------------------------------------------------------

    def device_fingerprint_gather(self, svb: Dict[str, np.ndarray]):
        """Rows split across the shards (B/D each, B a multiple of D):
        each shard fingerprints every lane's successor of its rows, and
        the blocks are gathered in shard order -> uint32 [B, A, W]
        (disabled lanes' successors are the step's unchanged rows)."""
        B = len(next(iter(svb.values())))
        if B % self.D:
            raise ValueError(f"{B} rows do not split across {self.D} "
                             "shards")
        n = B // self.D
        out = []
        for d, dev in enumerate(self.devices):
            self._bind(dev)
            sv = rows_to_torch({k: np.asarray(v)[d * n:(d + 1) * n]
                                for k, v in svb.items()}, dev,
                               self.ir.u32_keys)
            der = self.kern.derived(sv)
            fps = []
            for a in range(self.A):
                lane = torch.full((n,), a, dtype=torch.int32, device=dev)
                cand = self.expander.step_lanes(sv, der, lane)
                fps.append(self.fpr.fingerprint_batch_T(cand).cpu())
            out.append(torch.stack(fps, 0).permute(2, 0, 1))
        self._bind(self.devices[0])
        return torch.cat(out).numpy().view(np.uint32)
