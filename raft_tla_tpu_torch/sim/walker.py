"""Random-walk simulation engine: TLC ``-simulate``, W walkers at once.

Configurations past the exhaustive engines' reach (BASELINE config #5's
scenario arm: Server=5, MaxTerm=4, MaxLogLen=4, NextDynamic) are hunted
by W independent random walkers that step together as one program:

- each walker draws from its own threefry stream, keyed by its GLOBAL
  id (``fold_in(PRNGKey(seed), w)``, ``utils/prng.py``), so a fixed
  seed replays the same trajectories whatever the fleet's width;
- a walker draws u uniformly in [0, n_enabled) and takes the u-th
  enabled lane of the guard grid (``Expander.guards_T`` and
  ``ops.kernels.select_enabled``): TLC ``-simulate``'s uniform choice
  of successor;
- the successor comes from ``Expander.step_lanes``: one kernel
  application per family per walker, not the [W, A] expansion;
- invariants and constraints are evaluated on every sampled successor;
  a pruned successor is checked, then discarded (TLC's CONSTRAINT);
- each walker's lane ids from the root live in a [traj_cap, W] buffer,
  so a hit decodes on the host into the witness ``trace`` prints and
  the seed ``check --seed-trace`` reads;
- a Bloom filter over the canonical fingerprints the exhaustive
  engines dedup on estimates the distinct states visited.

Restart policies: ``tlc`` draws once per step and abandons the walk
(back to the root) on a pruned successor, a deadlock or the depth
bound; ``punctuated`` (default) masks a pruned lane out and redraws
among the remaining enabled lanes, and restarts a walker from its own
best state on the spec's monotone scenario ladder (``sim_progress``).

This is the reference package's ``sim/walker.py``; with the same seed
its walks, statistics and witnesses are the reference's bit for bit.
Its step is one ``lax.while_loop`` program; here the step is a fixed
program with no host read that runs, on the card, as a captured CUDA
graph (``engine/graph.py``), and the host reads the stats vector once
per dispatch.  Two loops of the reference end on data, and both run
here to a fixed count with every update gated:

- the rejection-sampling rounds end when every walker is done; here all
  ``_MAX_TRIES`` rounds run (1 under ``tlc``) and a round updates only
  its active walkers.  A round with no active walker changes nothing
  the step keeps: a walker's key advances only on its own draws, its
  candidate, lane and flags only when it draws, and ``sampled`` adds
  the active count, 0;
- the dispatch loop ends at the first hit; here every step of a
  dispatch runs, and a step after the hit treats every walker as
  frozen (as the reference freezes a walker that hit), which leaves
  the carry as it was, and does not count itself.

Two scatters of the reference drop out-of-range rows; here they land
in a spare slot that nothing reads: the Bloom has 2^m + 1 entries
(rejected rows write entry 2^m) and the trajectory buffer traj_cap + 1
rows (a depth at traj_cap writes row traj_cap).
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..convert import rows_to_torch
from ..engine.expand import Expander
from ..engine.fingerprint import (bloom_estimate, bloom_positions,
                                  resolve_sym_canon)
from ..engine.graph import GraphRunner
from ..obs import NULL_OBS
from ..ops.kernels import select_enabled
from ..spec import spec_of
from ..utils import prng, resolve_device

I32 = torch.int32
BLOOM_K = 2
# under a forced min-over-perms canonicalizer (--sym-canon minperm) a
# symmetry group past this size costs more per step in P-fold hashing
# than the novelty estimate is worth: the Bloom then takes identity-
# permutation fingerprints and says so (bloom_canonical false).  The
# orbit-sort canonicalizer hashes one relabeling per state and keeps the
# Bloom canonical at any group size.
_BLOOM_CANONICAL_MAX_PERMS = 24


@dataclass
class WalkerHit:
    """One walker's scenario or invariant hit, decoded on the host."""
    invariant: str
    walker: int                  # global walker id
    depth: int                   # steps from the root (witness length)
    lanes: List[int]             # flat lane ids root -> hit state
    # (label, oracle state) chain
    trace: List[Tuple] = field(default_factory=list)
    state_arrs: Optional[Dict[str, np.ndarray]] = None
    hist: Optional[object] = None


@dataclass
class SimResult:
    walkers: int
    steps_dispatched: int        # fleet-synchronous steps
    walker_steps: int            # transitions taken (accepted steps)
    sampled_steps: int           # successors sampled (pruned included)
    restarts: int
    deadlocks: int
    promotions: int              # progress-base advances (punctuated)
    seconds: float = 0.0
    hits: List[WalkerHit] = field(default_factory=list)
    bloom_bits_set: int = 0
    bloom_m_bits: int = 0
    bloom_saturated: bool = False
    bloom_canonical: bool = True  # False: identity-perm fingerprints
    est_distinct_states: float = 0.0

    @property
    def walker_steps_per_sec(self) -> float:
        return self.walker_steps / max(self.seconds, 1e-9)


# the stats vector's layout (int32 on the device)
(ST_STEPS, ST_RESTARTS, ST_DEADLOCKS, ST_ITERS, ST_HIT, ST_SAMPLED,
 ST_PROMOS, ST_LEN) = range(8)


def dispatch_counters(stats2d: np.ndarray, walkers: int):
    """Per-dispatch counters off the raw [n_shards, ST_LEN] stats
    matrix: the SimResult counters known without a Bloom read."""
    return {
        "walkers": int(walkers),
        "steps_dispatched": int(stats2d[:, ST_ITERS].max()),
        "walker_steps": int(stats2d[:, ST_STEPS].sum()),
        "sampled_steps": int(stats2d[:, ST_SAMPLED].sum()),
        "restarts": int(stats2d[:, ST_RESTARTS].sum()),
        "deadlocks": int(stats2d[:, ST_DEADLOCKS].sum()),
        "promotions": int(stats2d[:, ST_PROMOS].sum()),
        "hits": int(stats2d[:, ST_HIT].sum()),
    }


class SimEngine:
    """W-walker random-walk explorer bound to one ModelConfig.

    walkers   — fleet width W.
    max_depth — per-segment step budget: a walk restarts (to the root,
                or to its progress base under ``punctuated``) after
                this many steps beyond its base.
    traj_cap  — trajectory buffer rows (lane ids from the ROOT); bounds
                the witness depth.
    seed      — base PRNG seed; walker w draws from fold_in(PRNGKey(
                seed), w) with w its GLOBAL id (see wid_base).
    policy    — 'punctuated' (default) or 'tlc' (module docstring).
    bloom_bits— log2 of the novelty Bloom filter's size in bits.
    wid_base  — global id of this engine's walker 0 (a shard of a fleet
                passes its offset, so streams do not depend on
                sharding).
    guard_matmul, delta_matmul, sym_canon — the expansion's and the
                fingerprint's forms; every setting walks the same.
    device    — "cuda" by default; "cpu" only when asked for.

    On the card each step runs as a captured CUDA graph; ``_capture =
    False`` keeps it eager there, to hold the graph against it.
    """

    _MAX_TRIES = 8               # prune-resampling rounds per step

    def __init__(self, cfg: ModelConfig, walkers: int = 256,
                 max_depth: int = 48, seed: int = 0,
                 policy: str = "punctuated",
                 traj_cap: Optional[int] = None,
                 bloom_bits: int = 22, wid_base: int = 0,
                 guard_matmul: bool = True,
                 delta_matmul: bool = True,
                 sym_canon: str = "auto",
                 device: Optional[str] = None):
        if policy not in ("punctuated", "tlc"):
            raise ValueError(f"unknown restart policy {policy!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.W = int(walkers)
        self.budget = max(2, int(max_depth))
        self.R = int(traj_cap) if traj_cap else max(4 * self.budget, 64)
        self.seed = int(seed)
        self.policy = policy
        self.bloom_bits = int(bloom_bits)
        self.wid_base = int(wid_base)
        self.ir = spec_of(cfg)
        self.lay = self.ir.make_layout(cfg)
        self.kern = self.ir.make_kernels(self.lay)
        self.guard_matmul = bool(guard_matmul)
        self.delta_matmul = bool(delta_matmul)
        self.expander = Expander(cfg, self.device,
                                 guard_matmul=self.guard_matmul,
                                 delta_matmul=self.delta_matmul)
        fp_cfg = cfg
        self.bloom_canonical = True
        mode = resolve_sym_canon(cfg, sym_canon)
        if cfg.symmetry and mode == "minperm":
            n_perms = len(self.ir.symmetry_perms(cfg))
            if n_perms > _BLOOM_CANONICAL_MAX_PERMS:
                warnings.warn(
                    f"--sym-canon minperm with {n_perms} perms: the "
                    "novelty Bloom falls back to identity-permutation "
                    "fingerprints (bloom_canonical=false) — use "
                    "--sym-canon sort (or auto) to keep it canonical",
                    stacklevel=2)
                fp_cfg = cfg.with_(symmetry=False)
                self.bloom_canonical = False
        self.fpr = self.ir.make_fingerprinter(fp_cfg, sym_canon=mode)
        self.preds = self.ir.make_predicates(self.lay)
        self._progress_fn = (self.ir.sim_progress(self.kern, self.lay)
                             if self.ir.sim_progress else None)
        self.inv_names = list(cfg.invariants)
        self.con_names = list(cfg.constraints)
        self.labels = self.expander.lane_labels()
        self.A = self.expander.n_lanes
        self._root = self.ir.encode(self.lay, *self.ir.init_state(cfg))
        # built once: the root as one batch-last row, and the walkers'
        # column indices
        self._rootT = rows_to_torch(
            {k: np.asarray(v)[None] for k, v in self._root.items()},
            self.device, self.ir.u32_keys)
        self._cols = torch.arange(self.W, device=self.device)
        self._capture = True
        self._obs = NULL_OBS           # the bundle of the run under way
        self._graphs = GraphRunner(self.device, False)
        self._bound = None

    # ------------------------------------------------------------------
    # carry construction
    # ------------------------------------------------------------------

    def fresh_carry(self) -> Dict:
        """The walkers at the root: every leaf a fresh device tensor."""
        W, dev = self.W, self.device
        rootT = {k: v.expand(v.shape[:-1] + (W,)).contiguous()
                 for k, v in self._rootT.items()}
        wids = torch.arange(self.wid_base, self.wid_base + W,
                            device=dev).to(I32)
        return dict(
            sv=rootT,                                    # [..., W] int32
            depth=torch.zeros(W, dtype=I32, device=dev),  # from the ROOT
            key=prng.fold_in(prng.PRNGKey(self.seed, dev), wids),
            traj=torch.full((self.R + 1, W), -1, dtype=I32, device=dev),
            base={k: v.clone() for k, v in rootT.items()},
            base_depth=torch.zeros(W, dtype=I32, device=dev),
            score=torch.zeros(W, dtype=I32, device=dev),
            hit=torch.zeros(W, dtype=torch.bool, device=dev),
            hit_inv=torch.full((W,), -1, dtype=I32, device=dev),
            hit_depth=torch.full((W,), -1, dtype=I32, device=dev),
            bloom=torch.zeros((1 << self.bloom_bits) + 1,
                              dtype=torch.bool, device=dev),
            stats=torch.zeros(ST_LEN, dtype=I32, device=dev),
        )

    # ------------------------------------------------------------------
    # predicates on batch-last rows
    # ------------------------------------------------------------------

    def _phase2_T(self, svT):
        """inv bool [n_inv, N], con bool [N]."""
        return self.preds.check_T(svT, self.inv_names, self.con_names)

    def _progress_T(self, svT) -> torch.Tensor:
        """The monotone scenario-ladder score int32 [W] (the SpecIR
        ``sim_progress`` hook); 0 for a spec without one, which makes
        ``punctuated`` restart by the budget alone."""
        if self._progress_fn is None:
            return torch.zeros(self.W, dtype=I32, device=self.device)
        return self._progress_fn(svT)

    # ------------------------------------------------------------------
    # one step of every walker
    # ------------------------------------------------------------------

    def _rounds_init(self, svT, ok0, frozen, key) -> Dict:
        """The rejection-sampling state before the first round."""
        W = self.W
        acc = torch.zeros(W, dtype=torch.bool, device=self.device)
        lane = torch.full((W,), -1, dtype=I32, device=self.device)
        return dict(okm=ok0 & ~frozen[:, None], key=key, cand=dict(svT),
                    lane=lane, acc=acc, hitrow=torch.zeros_like(acc),
                    hinv=torch.full_like(lane, -1),
                    sampled=torch.zeros((), dtype=I32, device=self.device),
                    done=frozen | (ok0.sum(1, dtype=I32) == 0))

    def _round(self, svT, derT, c: Dict) -> Dict:
        """One rejection-sampling round: each active walker (not done,
        an enabled lane left) draws a lane uniformly from its remaining
        enabled set; a pruned successor is checked, masked out and
        redrawn in the next round (punctuated) or ends the step (tlc).
        A walker that is not active changes nothing here."""
        A = self.A
        okm = c["okm"]
        n_en = okm.sum(1, dtype=I32)
        active = ~c["done"] & (n_en > 0)
        splits = prng.split(c["key"])                      # [W, 2, 2]
        # a walker's key advances only on its own draws: the fleet's
        # round count must not reach any walker's stream
        key = torch.where(active[:, None], splits[:, 0], c["key"])
        u = prng.randint(splits[:, 1], n_en)
        lane = torch.where(active, select_enabled(okm, u), -1)
        cand = self.expander.step_lanes(svT, derT, lane)
        inv, con = self._phase2_T(cand)
        if self.inv_names:
            inv = inv | ~active[None]
            hitrow = ~inv.all(0)
            hinv = (~inv).to(I32).argmax(0).to(I32)
        else:
            hitrow = torch.zeros_like(active)
            hinv = torch.full_like(lane, -1)
        accept = active & con & ~hitrow
        reject = active & ~con & ~hitrow
        li = lane.clamp(0, A - 1).long()[:, None]
        okm = okm.scatter(1, li, okm.gather(1, li) & ~reject[:, None])
        take = (accept | hitrow) & ~c["acc"]
        return dict(
            okm=okm, key=key,
            cand={k: torch.where(take, cand[k], c["cand"][k])
                  for k in cand},
            lane=torch.where(take, lane, c["lane"]),
            acc=c["acc"] | accept,
            hitrow=c["hitrow"] | hitrow,
            hinv=torch.where(hitrow & (c["hinv"] < 0), hinv, c["hinv"]),
            sampled=c["sampled"] + active.sum(dtype=I32),
            done=c["done"] | accept | hitrow | (n_en == 0))

    def step(self, st: Dict, stop_on_hit: bool = False) -> Dict:
        """One synchronous step of every walker; returns the new carry
        (fresh tensors; ``st`` is read, not written).  With
        ``stop_on_hit`` a step taken once the fleet has hit is a no-op
        that does not count itself (the dispatch's gate)."""
        W = self.W
        svT = st["sv"]
        frozen = st["hit"]
        go = None
        if stop_on_hit:
            go = st["stats"][ST_HIT] == 0
            frozen = frozen | ~go
        derT = self.expander.derived_batch_T(svT)
        ok0 = self.expander.guards_T(svT, derT)               # [W, A]
        # every round runs (the reference stops once every walker is
        # done, after which a round changes nothing: see _round)
        c = self._rounds_init(svT, ok0, frozen, st["key"])
        for _ in range(self._MAX_TRIES if self.policy == "punctuated"
                       else 1):
            c = self._round(svT, derT, c)
        cand, lane, accepted = c["cand"], c["lane"], c["acc"]
        hitrow, hinv, sampled, key = (c["hitrow"], c["hinv"],
                                      c["sampled"], c["key"])
        hit_now = hitrow & ~frozen
        took = accepted | hit_now                  # a lane was recorded
        deadlock = ~frozen & (ok0.sum(1, dtype=I32) == 0)
        # stuck: every enabled lane tried and pruned, or tries blown
        stuck = ~frozen & ~took & ~deadlock

        # the trajectory record at the pre-step depth
        traj = st["traj"].clone()
        d = st["depth"].clamp(max=self.R).long()
        traj[d, self._cols] = torch.where(took, lane, traj[d, self._cols])

        # the novelty Bloom over the accepted rows' fingerprints, exact
        # wherever it is read: every accepted row may be a hard lane of
        # the orbit-sort canonicalizer, so the fallback holds W lanes
        fp, _n_hard = self.fpr.fingerprint_chunk_T(cand, W, live=accepted)
        pos = bloom_positions(fp, self.bloom_bits, BLOOM_K)   # [k, W]
        upd = torch.where(accepted[None], pos, 1 << self.bloom_bits)
        bloom = st["bloom"].index_fill(0, upd.reshape(-1), True)

        depth2 = torch.where(took, st["depth"] + 1, st["depth"])
        hit_all = st["hit"] | hit_now

        # punctuated progress bases
        if self.policy == "punctuated":
            score2 = self._progress_T(cand)
            promote = accepted & (score2 > st["score"]) & \
                (depth2 <= self.R - self.budget)
            base = {k: torch.where(promote, cand[k], st["base"][k])
                    for k in cand}
            base_depth = torch.where(promote, depth2, st["base_depth"])
            score = torch.where(promote, score2, st["score"])
        else:
            promote = torch.zeros_like(accepted)
            base, base_depth, score = (st["base"], st["base_depth"],
                                       st["score"])

        # restart policy: segment budget blown, stuck, deadlock
        over = depth2 - base_depth >= self.budget
        restart = ~frozen & ~hit_now & \
            (deadlock | stuck | (accepted & over & ~promote))
        # stuck at the base: demote the base to the root, so the walker
        # cannot spin forever on an unextendable base
        demote = (stuck | deadlock) & (st["depth"] == base_depth)
        base = {k: torch.where(demote, self._rootT[k], base[k])
                for k in base}
        base_depth = torch.where(demote, 0, base_depth)
        score = torch.where(demote, 0, score)

        sv_next = {k: torch.where(restart, base[k],
                                  torch.where(accepted, cand[k], svT[k]))
                   for k in svT}
        depth3 = torch.where(restart, base_depth, depth2)

        iters = go.to(I32) if go is not None else \
            torch.ones((), dtype=I32, device=self.device)
        zero = torch.zeros((), dtype=I32, device=self.device)
        stats = st["stats"] + torch.stack([
            accepted.sum(dtype=I32), restart.sum(dtype=I32),
            deadlock.sum(dtype=I32), iters, zero, sampled,
            promote.sum(dtype=I32)])
        stats[ST_HIT] = hit_all.any().to(I32)
        return dict(st, sv=sv_next, depth=depth3, key=key, traj=traj,
                    base=base, base_depth=base_depth, score=score,
                    hit=hit_all,
                    hit_inv=torch.where(hit_now & (st["hit_inv"] < 0),
                                        hinv, st["hit_inv"]),
                    hit_depth=torch.where(
                        hit_now & (st["hit_depth"] < 0), depth2,
                        st["hit_depth"]),
                    bloom=bloom, stats=stats)

    def _step_into(self, st: Dict, stop_on_hit: bool):
        """One step written back into the carry's own buffers (the
        program a graph captures)."""
        new = self.step(st, stop_on_hit)
        for k, v in new.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    st[k][kk].copy_(vv)
            else:
                st[k].copy_(v)

    def _dispatch(self, st: Dict, steps: int,
                  stop_on_hit: bool = True) -> Dict:
        """``steps`` walker steps on the carry ``st``, in place: on the
        card each is one replay of the captured step, with no host read
        (a carry other than the one the graphs hold drops them).  With
        ``stop_on_hit`` the steps after the fleet's first hit change
        nothing.  Returns ``st``."""
        bound = [st[k].data_ptr() for k in sorted(st)
                 if not isinstance(st[k], dict)] + \
            [v.data_ptr() for k in ("sv", "base") for v in st[k].values()]
        if bound != self._bound:
            self._graphs = GraphRunner(self.device, self._capture,
                                       obs=self._obs)
            self._bound = bound
        for _ in range(int(steps)):
            self._graphs.run(("step", bool(stop_on_hit)),
                             lambda: self._step_into(st, stop_on_hit))
            # on the CPU nothing is captured and a read costs no sync:
            # stop at the hit, as the reference's loop does, instead of
            # running the gated steps that would change nothing
            if stop_on_hit and self.device.type == "cpu" and \
                    bool(st["stats"][ST_HIT]):
                break
        return st

    # ------------------------------------------------------------------
    # the run loop
    # ------------------------------------------------------------------

    def run(self, steps: int, steps_per_dispatch: int = 256,
            stop_on_hit: bool = True, verbose: bool = False,
            obs=None) -> SimResult:
        """Walk for up to ``steps`` synchronous fleet steps (ending at
        the first scenario or invariant hit when stop_on_hit); the host
        reads the stats vector once per dispatch.

        obs — an ``obs.Obs`` bundle: one ``sim_dispatch`` span (the
        dispatch and its stats read), one ledger record and one
        heartbeat rewrite per dispatch (the heartbeat's ``depth`` is the
        fleet's step count: a random walk has no BFS depth), and a
        ``compile`` span per graph capture on the card."""
        obs = self._obs = obs if obs is not None else NULL_OBS
        self._graphs.obs = obs
        t0 = time.perf_counter()
        # the steps check sampled successors; the root is checked once
        # here (a safety-invariant target can fail at depth 0)
        root_hit = self._check_root()
        if root_hit is not None and stop_on_hit:
            res = self._harvest(self.fresh_carry(),
                                time.perf_counter() - t0)
            res.hits.insert(0, root_hit)
            return res
        st = self.fresh_carry()
        done = 0
        while done < steps:
            k = min(steps_per_dispatch, steps - done)
            with obs.span("sim_dispatch"):
                self._dispatch(st, k, stop_on_hit)
                stats = st["stats"].cpu().numpy()   # the one read
            done = int(stats[ST_ITERS])
            if obs.enabled:
                # the counters known without a Bloom read (key set
                # obs.metrics.SIM_DISPATCH_KEYS)
                obs.dispatch(kind="sim", depth=done, frontier=self.W,
                             states=int(stats[ST_STEPS]),
                             metrics=dispatch_counters(stats[None],
                                                       self.W))
            if verbose:
                print(f"sim: {done} iters, {int(stats[ST_STEPS])} "
                      f"walker-steps, {int(stats[ST_RESTARTS])} "
                      f"restarts, {int(stats[ST_PROMOS])} promotions",
                      flush=True)
            if stop_on_hit and stats[ST_HIT]:
                break
        res = self._harvest(st, time.perf_counter() - t0)
        if root_hit is not None:
            res.hits.insert(0, root_hit)
        return res

    def _check_root(self) -> Optional[WalkerHit]:
        """The target invariants on the root; a depth-0 violation
        decodes like any other hit (empty lane list)."""
        if not self.inv_names:
            return None
        inv, _con = self._phase2_T(self._rootT)
        inv = inv[:, 0].cpu().numpy()
        if inv.all():
            return None
        return WalkerHit(
            invariant=self.inv_names[int(np.argmax(~inv))],
            walker=self.wid_base, depth=0, lanes=[])

    def build_result(self, stats2d: np.ndarray, union_bits: int,
                     walkers: int, seconds: float) -> SimResult:
        """stats [n_shards, ST_LEN] -> SimResult: the step count is the
        max across shards (a hit ends one shard early), the rest sum."""
        m = self.bloom_bits
        return SimResult(
            walkers=walkers,
            steps_dispatched=int(stats2d[:, ST_ITERS].max()),
            walker_steps=int(stats2d[:, ST_STEPS].sum()),
            sampled_steps=int(stats2d[:, ST_SAMPLED].sum()),
            restarts=int(stats2d[:, ST_RESTARTS].sum()),
            deadlocks=int(stats2d[:, ST_DEADLOCKS].sum()),
            promotions=int(stats2d[:, ST_PROMOS].sum()),
            seconds=seconds,
            bloom_bits_set=union_bits, bloom_m_bits=m,
            bloom_saturated=union_bits >= (1 << m) - 1,
            bloom_canonical=self.bloom_canonical,
            est_distinct_states=bloom_estimate(union_bits, m, BLOOM_K))

    def harvest_hits(self, res: SimResult, hit, traj, hdep, hinv,
                     wid_base: int):
        """One shard's hit flags -> WalkerHit entries (traj [R, W] of
        that shard; global ids offset by wid_base)."""
        for w in np.nonzero(hit)[0]:
            d = int(hdep[w])
            res.hits.append(WalkerHit(
                invariant=self.inv_names[int(hinv[w])]
                if 0 <= int(hinv[w]) < len(self.inv_names) else "?",
                walker=wid_base + int(w), depth=d,
                lanes=[int(x) for x in traj[:d, w]]))

    def _harvest(self, st: Dict, seconds: float) -> SimResult:
        stats = st["stats"].cpu().numpy()
        bits = int(st["bloom"][:1 << self.bloom_bits].sum())
        res = self.build_result(stats[None], bits, self.W, seconds)
        hit = st["hit"].cpu().numpy()
        if hit.any():
            self.harvest_hits(res, hit, st["traj"][:self.R].cpu().numpy(),
                              st["hit_depth"].cpu().numpy(),
                              st["hit_inv"].cpu().numpy(), self.wid_base)
        return res

    # ------------------------------------------------------------------
    # the witness decode: the recorded lanes replayed from the root
    # through the single-state expansion (the step's own kernels and
    # params), giving the (label, State) chain ``trace`` prints and the
    # exact arrays ``--emit-seed`` writes
    # ------------------------------------------------------------------

    def decode_hit(self, h: WalkerHit) -> WalkerHit:
        arrs = {k: np.asarray(v) for k, v in self._root.items()}
        chain: List[Tuple] = [
            ("Init", self.ir.decode(self.lay, arrs)[0])]
        for lane in h.lanes:
            enabled = self.expander.expand_one(arrs)
            match = [sv2 for (lbl, sv2) in enabled
                     if lbl == self.labels[lane]]
            if not match:
                raise RuntimeError(
                    f"sim replay divergence: lane {lane} "
                    f"({self.labels[lane]}) not enabled at depth "
                    f"{len(chain) - 1}")
            arrs = match[0]
            chain.append((self.labels[lane],
                          self.ir.decode(self.lay, arrs)[0]))
        h.trace = chain
        h.state_arrs = arrs
        h.hist = self.ir.decode(self.lay, arrs)[1]
        return h
