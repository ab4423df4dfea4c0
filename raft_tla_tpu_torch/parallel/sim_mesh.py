"""The walker fleet across devices (the reference's
``raft_tla_tpu/parallel/sim_mesh.py``).

Walkers exchange nothing, so the fleet is D ``sim.walker.SimEngine``
cohorts, one per listed device (a device may be listed more than once),
driven by one controller with no process group:

- the W walkers split evenly into D cohorts; cohort d's walker i has
  the GLOBAL id d·W/D + i (``wid_base``), which keys its PRNG stream,
  so a seed replays the same trajectories for any D, and a single
  engine of width W walks the same;
- per dispatch every cohort's ``_dispatch`` is launched (each replays
  its own captured step on the card), then the host reads the stacked
  [D, ST_LEN] stats; a cohort's hit stops that cohort's steps, the
  others finish the dispatch, and any hit ends the fleet;
- the harvest ORs the cohorts' Bloom filters (the union is exact for
  membership) and offsets each cohort's hits by its ``wid_base``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..obs import NULL_OBS
from ..sim.walker import (ST_HIT, ST_ITERS, ST_STEPS, SimEngine,
                          SimResult, WalkerHit, dispatch_counters)
from .mesh import resolve_devices


class ShardedSimEngine:
    """A D-cohort walker fleet.  ``walkers`` is the fleet's total width,
    split evenly across ``devices`` (None: every visible CUDA device);
    the rest of the keywords go to each cohort's ``SimEngine``."""

    def __init__(self, cfg: ModelConfig, walkers: int = 1024,
                 devices: Optional[List] = None, **kw):
        self.devices = resolve_devices(devices)
        self.D = len(self.devices)
        if walkers % self.D:
            raise ValueError(
                f"walkers={walkers} must divide across {self.D} devices")
        if "device" in kw or "wid_base" in kw:
            raise ValueError("the fleet sets each cohort's device and "
                             "wid_base")
        self.Wd = walkers // self.D
        self.W = walkers
        self.cohorts = [SimEngine(cfg, walkers=self.Wd,
                                  wid_base=d * self.Wd, device=str(dev),
                                  **kw)
                        for d, dev in enumerate(self.devices)]
        self.sim = self.cohorts[0]
        self.device = self.devices[0]

    def fresh_carry(self) -> List[Dict]:
        return [c.fresh_carry() for c in self.cohorts]

    def run(self, steps: int, steps_per_dispatch: int = 256,
            stop_on_hit: bool = True, verbose: bool = False,
            obs=None) -> SimResult:
        obs = obs if obs is not None else NULL_OBS
        for c in self.cohorts:
            c._obs = obs
            c._graphs.obs = obs
        t0 = time.perf_counter()
        root_hit = self.sim._check_root()
        if root_hit is not None and stop_on_hit:
            res = self._harvest(self.fresh_carry(),
                                time.perf_counter() - t0)
            res.hits.insert(0, root_hit)
            return res
        sts = self.fresh_carry()
        done = 0
        while done < steps:
            k = min(steps_per_dispatch, steps - done)
            with obs.span("sim_dispatch"):
                for c, st in zip(self.cohorts, sts):
                    c._dispatch(st, k, stop_on_hit)
                stats = self._stats(sts)                # [D, ST_LEN]
            done = int(stats[:, ST_ITERS].max())
            if obs.enabled:
                obs.dispatch(
                    kind="sim", depth=done, frontier=self.W,
                    states=int(stats[:, ST_STEPS].sum()),
                    metrics=dispatch_counters(stats, self.W))
            if verbose:
                print(f"fleet: {done} iters, "
                      f"{int(stats[:, ST_STEPS].sum())} walker-steps "
                      f"across {self.D} devices", flush=True)
            if stop_on_hit and stats[:, ST_HIT].any():
                break
        res = self._harvest(sts, time.perf_counter() - t0)
        if root_hit is not None:
            res.hits.insert(0, root_hit)
        return res

    def _stats(self, sts: List[Dict]) -> np.ndarray:
        """The cohorts' stats vectors, one read per device."""
        out = [None] * self.D
        for dev in dict.fromkeys(self.devices):
            ds = [d for d in range(self.D) if self.devices[d] == dev]
            got = torch.stack([sts[d]["stats"] for d in ds]).cpu().numpy()
            for d, row in zip(ds, got):
                out[d] = row
        return np.stack(out)

    def _harvest(self, sts: List[Dict], seconds: float) -> SimResult:
        """The shared result assembly over the cohorts: the step count
        is the most any cohort ran, the rest sum; the Bloom union
        estimates the fleet's coverage."""
        stats = self._stats(sts)
        m = 1 << self.sim.bloom_bits
        union = torch.zeros(m, dtype=torch.bool)
        for st in sts:
            union |= st["bloom"][:m].cpu()
        res = self.sim.build_result(stats, int(union.sum()), self.W,
                                    seconds)
        for d, (c, st) in enumerate(zip(self.cohorts, sts)):
            hit = st["hit"].cpu().numpy()
            if hit.any():
                c.harvest_hits(res, hit, st["traj"][:c.R].cpu().numpy(),
                               st["hit_depth"].cpu().numpy(),
                               st["hit_inv"].cpu().numpy(), d * self.Wd)
        return res

    def decode_hit(self, h: WalkerHit) -> WalkerHit:
        return self.sim.decode_hit(h)
