"""Frontier expansion: guard-first, over the [batch, lane] grid.

The lane grid mirrors the ∃-quantification TLC performs: each action
family is laid out over its parameter grid (server pairs, values, bag
slots), families concatenate into A lanes per state, and a state's
successors are enumerated in ascending lane order — the oracle's order,
on which every global state id depends.

Per frontier chunk the engine (1) evaluates every lane's enabling guard
from the kernels' per-state guard features and each family's declared
guard algebra (``guards_T``: up to three signed feature terms against a
threshold — the plain form of the reference's int8 guard matmul), then
(2) materializes successors for the enabled lanes only, each family's
kernel running on its compacted rows (``materialize``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..spec import spec_of


class Expander:
    """Guard-first expansion bound to one config and device."""

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.ir = spec_of(cfg)
        self.lay = self.ir.make_layout(cfg)
        self.kern = self.ir.make_kernels(self.lay)
        self.families = self.ir.build_families(self.lay)
        self.keys = self.ir.all_keys
        self.n_lanes = sum(f.n_lanes for f in self.families)
        gidx, gw, gT = self._build_guard_terms()
        self._gidx = torch.from_numpy(gidx).to(device)
        self._gw = torch.from_numpy(gw).to(device)
        self._gT = torch.from_numpy(gT).to(device)
        fam_of = np.concatenate([np.full(f.n_lanes, fi, np.int64)
                                 for fi, f in enumerate(self.families)])
        self.lane_off = np.concatenate(
            [[0], np.cumsum([f.n_lanes for f in self.families])[:-1]])
        self._fam_of = torch.from_numpy(fam_of).to(device)
        self._params = [[torch.from_numpy(np.asarray(p, np.int32)).to(device)
                         for p in f.params] for f in self.families]

    def _build_guard_terms(self):
        """Each lane's guard as (feature index, weight) terms padded to
        a fixed width G, plus its threshold: lane a is enabled exactly
        when Σ_g w[a, g] · φ[idx[a, g]] == T[a].  Integer arithmetic
        over 0/±1 weights, so the compare is exact."""
        OFF = self.kern.guard_feature_offsets()
        rows, T = [], []
        for fam in self.families:
            if fam.guard is None:
                raise KeyError(
                    f"no guard algebra declared for action family "
                    f"{fam.name!r} of spec {self.ir.name!r}")
            for vals in zip(*fam.params) if fam.params else [()]:
                pairs, thresh = fam.guard(OFF, self.lay,
                                          *(int(v) for v in vals))
                rows.append(pairs)
                T.append(thresh)
        G = max(1, max(len(r) for r in rows))
        gidx = np.zeros((self.n_lanes, G), np.int64)
        gw = np.zeros((self.n_lanes, G), np.int32)
        for a, pairs in enumerate(rows):
            for g, (idx, w) in enumerate(pairs):
                gidx[a, g], gw[a, g] = idx, w
        return gidx, gw, np.asarray(T, np.int32)

    def lane_labels(self) -> List[str]:
        out = []
        for f in self.families:
            for vals in zip(*f.params):
                out.append(f.labeler(*[int(v) for v in vals]))
        return out

    def default_fam_caps(self, chunk: int) -> Tuple[int, ...]:
        """Per-family materialization caps: chunk × min(lanes, density)
        over the spec's density table."""
        d = self.ir.family_density
        return tuple(chunk * min(f.n_lanes, d.get(f.name, 2))
                     for f in self.families)

    def guards_T(self, svT, derT) -> torch.Tensor:
        """Batch-last frontier [..., B] -> ok bool [B, A]."""
        phi = self.kern.guard_features(svT, derT)              # [F, B]
        acc = (phi[self._gidx] * self._gw[:, :, None]).sum(
            1, dtype=torch.int32)                               # [A, B]
        return (acc == self._gT[:, None]).T

    def family_counts(self, lanes: torch.Tensor) -> torch.Tensor:
        """Enabled lanes (flat b*A + a ids) -> int64 [n_fams] counts."""
        fam = self._fam_of[lanes % self.n_lanes]
        return torch.bincount(fam, minlength=len(self.families))

    def materialize(self, svT, derT, lanes: torch.Tensor,
                    counts: List[int], delta_fp=None):
        """Successor rows [..., n] for the enabled flat lanes ``lanes``
        (ascending = enumeration order) of the batch-last chunk svT;
        ``counts`` are the per-family lane counts (family_counts).
        Each family's kernel runs once, on its own rows.

        delta_fp — optional (fingerprinter, parent_tables) pair: each
        family also computes its candidates' per-permutation hashes
        incrementally from the parent tables (``family_delta``), and
        the result is (cand, fp) with the sealed canonical
        fingerprints fp [n_streams, n]."""
        A = self.n_lanes
        rows, lane = lanes // A, lanes % A
        fam = self._fam_of[lane]
        order = torch.argsort(fam, stable=True)       # family-major
        outs, fp_outs = [], []
        lo = 0
        for fi, (f, n) in enumerate(zip(self.families, counts)):
            if n == 0:
                continue
            sel = order[lo:lo + n]
            lo += n
            b = rows[sel]
            li = lane[sel] - int(self.lane_off[fi])
            sv_rows = {k: v[..., b] for k, v in svT.items()}
            der_rows = {k: v[..., b] for k, v in derT.items()}
            prm = [p[li] for p in self._params[fi]]
            # int32 rows whatever a kernel's arithmetic promoted to (the
            # incremental deltas wrap in int32, as the reference's do)
            outs.append({k: v.to(torch.int32) for k, v in
                         f.fn(sv_rows, der_rows, *prm).items()})
            if delta_fp is not None:
                fpr, tables = delta_fp
                fp_outs.append(fpr.family_delta(f.name, tables, b, sv_rows,
                                                outs[-1], prm))

        def unsort(parts):
            cat = torch.cat(parts, dim=-1)
            out = torch.empty_like(cat)
            out[..., order] = cat
            return out

        cand = {k: unsort([o[k] for o in outs]) for k in self.keys}
        if delta_fp is None:
            return cand
        return cand, delta_fp[0].finish_min(unsort(fp_outs))
