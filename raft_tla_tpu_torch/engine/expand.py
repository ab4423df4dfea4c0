"""Frontier expansion: guard-first, over the [batch, lane] grid.

The lane grid mirrors the ∃-quantification TLC performs: each action
family is laid out over its parameter grid (server pairs, values, bag
slots), families concatenate into A lanes per state, and a state's
successors are enumerated in ascending lane order — the oracle's order,
on which every global state id depends.

Per frontier chunk the engine (1) evaluates every lane's enabling guard
(``guards_T``): by default as one int8 product of the kernels' guard
features φ [B, F] with the packed weight matrix W [F, A] and an exact
compare with the per-lane thresholds T (``guards_T_matmul``), else by
summing each lane's declared guard terms (``guards_T_terms``, the plain
form; both are integer arithmetic over 0/±1 weights, so they are equal
by construction); then (2) materializes successors for the enabled
lanes into a fixed-width candidate buffer (``materialize``): one cumsum
compacts every family's enabled lanes into its cap-wide slice, the
affine families (those that declare a delta algebra) apply as one
scatter-add over the flat int32 state view (the delta group), and the
other families run their kernels on their slices.  The per-family
enabled counts come back as device data, so the host learns of a cap
overflow only at the step's one read after the dedup launch.

This is the reference package's ``engine/expand.py`` (``Expander``
with ``guard_matmul`` and ``delta_matmul``).  Its one-hot einsum
selections (``_sel_rows``/``_sel_params``) stay plain indexing here,
which they equal by construction.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..spec import get_spec, spec_of

I32 = torch.int32


def d_set(off, slot: int, value: int):
    """Delta-declaration helper: the two triples of ``x'[slot] = value``
    for a lane-constant value — the constant in, the old slot value
    out."""
    return [(slot, off["_const"], int(value)),
            (slot, off["_src_x"] + slot, -1)]


def validate_fam_density(density, ir=None) -> Dict[str, int]:
    """Bounds-validate a per-family density override mapping (the
    engine's ``fam_density`` / CLI ``--fam-cap-density``): a known
    family name of the spec, an integer k >= 1.  Raises ValueError with
    a message fit for the CLI.  ``ir`` defaults to the raft spec."""
    if ir is None:
        ir = get_spec("raft")
    known = dict(ir.family_density)
    out = {}
    for name, k in dict(density or {}).items():
        if name not in known:
            raise ValueError(
                f"unknown action family {name!r} in fam-cap-density "
                f"for spec {ir.name!r}; known families: "
                f"{', '.join(sorted(known))}")
        if isinstance(k, bool) or not isinstance(k, int):
            raise ValueError(
                f"fam-cap-density {name}: k must be an integer "
                f"(got {k!r})")
        if k < 1:
            raise ValueError(
                f"fam-cap-density {name}: k must be >= 1 (got {k}) — "
                "a zero cap would drop every enabled lane of the "
                "family")
        out[name] = k
    return out


def parse_fam_density(text: str, ir=None) -> Dict[str, int]:
    """Parse the CLI form ``fam=k,fam2=k2`` (``--fam-cap-density``)
    into a validated override dict."""
    out = {}
    for item in (text or "").split(","):
        item = item.strip()
        if not item:
            continue
        name, sep, val = item.partition("=")
        if not sep:
            raise ValueError(
                f"fam-cap-density entry {item!r} is not of the form "
                "fam=k (e.g. Receive=8,Timeout=2)")
        try:
            k = int(val.strip())
        except ValueError:
            raise ValueError(
                f"fam-cap-density {name.strip()}: k must be an "
                f"integer, got {val.strip()!r}") from None
        out[name.strip()] = k
    return validate_fam_density(out, ir)


def compact_positions(okf: torch.Tensor, fcap: int):
    """Flat enabled mask [B*A] (b-major) -> (epos [B*A], n_e): each
    enabled lane's position in the candidate buffer in enumeration
    order, fcap for a disabled lane, and the enabled count as a 0-d
    device tensor (no host read)."""
    cum = torch.cumsum(okf.to(I32), 0)
    return torch.where(okf, cum - 1, fcap), cum[-1]


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


class Expander:
    """Guard-first expansion bound to one config and device.

    guard_matmul — evaluate the guard grid as one int8 product of the
    guard features with the packed weight matrix (default); False sums
    each lane's declared guard terms instead.  Equal by construction.

    delta_matmul — apply every family that declares a delta algebra as
    one scatter-add over the flat int32 state view (the delta group,
    default); False runs every family's kernel.  Equal by construction.

    delta_chunk_skip — apply the delta group as one block per family
    instead of one block for the group.  The reference skips a block
    whose family the chunk does not enable (a ``lax.cond`` under its
    TPU lowering); here every block always runs, since a branch on the
    count would need a host read, and a family with no enabled lane
    yields only columns that nothing reads.  Default off, as the
    reference's default off the TPU."""

    def __init__(self, cfg, device: torch.device,
                 guard_matmul: bool = True, delta_matmul: bool = True,
                 delta_chunk_skip: Optional[bool] = None):
        self.cfg = cfg
        self.device = device
        self.ir = spec_of(cfg)
        self.lay = self.ir.make_layout(cfg)
        self.kern = self.ir.make_kernels(self.lay)
        self.families = self.ir.build_families(self.lay)
        self.keys = self.ir.all_keys
        self.n_lanes = sum(f.n_lanes for f in self.families)
        self.guard_matmul = bool(guard_matmul)
        self.delta_matmul = bool(delta_matmul)
        self.delta_chunk_skip = bool(delta_chunk_skip)
        self._gW, self._gT = self._build_guard_matrix()
        self._check_features_fit_int8()
        self._T = torch.from_numpy(self._gT).to(device)
        F, A = self._gW.shape
        W = np.zeros((_pad8(F), _pad8(A)), np.int8)
        W[:F, :A] = self._gW
        self._W8 = torch.from_numpy(W).to(device)
        self._W32 = torch.from_numpy(self._gW.astype(np.int32)).to(device)
        gidx, gw = self._guard_terms()
        self._gidx = torch.from_numpy(gidx).to(device)
        self._gw = torch.from_numpy(gw).to(device)
        self.lane_off = np.concatenate(
            [[0], np.cumsum([f.n_lanes for f in self.families])[:-1]])
        self._fam_of = torch.from_numpy(np.concatenate(
            [np.full(f.n_lanes, fi, np.int64)
             for fi, f in enumerate(self.families)])).to(device)
        self._params = [[torch.from_numpy(np.asarray(p, np.int32)).to(device)
                         for p in f.params] for f in self.families]
        self._dgroup = self._build_delta_group() if self.delta_matmul \
            else None
        if self._dgroup is not None:
            dg = self._dgroup
            used, D = dg["used"].astype(np.int64), dg["D"]
            self._dt = {k: torch.from_numpy(np.asarray(
                dg[k], np.int32 if k == "t_w" else np.int64)).to(device)
                for k in ("t_lane", "t_srcu", "t_slot", "t_w")}
            # psi's used rows by region: the constant, x, the features
            self._dt["u_one"] = bool((used < 1).any())
            self._dt["u_x"] = torch.from_numpy(
                used[(used >= 1) & (used < 1 + D)] - 1).to(device)
            self._dt["u_f"] = torch.from_numpy(
                used[used >= 1 + D] - (1 + D)).to(device)
            self._dt["lane_to_aff"] = torch.from_numpy(
                dg["lane_to_aff"].astype(np.int64)).to(device)
        self._plans = {}

    @property
    def delta_active(self) -> bool:
        """True when the delta group is built (the flag is on and at
        least one family declares its delta algebra)."""
        return self._dgroup is not None

    @property
    def delta_family_names(self):
        if self._dgroup is None:
            return ()
        return tuple(self.families[fi].name
                     for fi in self._dgroup["fam_idx"])

    # ---- the packed guard matrix -------------------------------------

    def _build_guard_matrix(self):
        """(W int8 [n_features, A], T int32 [A]): lane a's enabling
        guard is exactly ``φ(s) · W[:, a] == T[a]``.  A family without
        a guard declaration fails here, naming the spec."""
        OFF = self.kern.guard_feature_offsets()
        Wm = np.zeros((OFF["total"], self.n_lanes), np.int8)
        T = np.zeros((self.n_lanes,), np.int32)
        lane = 0
        for fam in self.families:
            if fam.guard is None:
                raise KeyError(
                    f"no guard algebra declared for action family "
                    f"{fam.name!r} of spec {self.ir.name!r} — set the "
                    f"Family.guard declaration in the spec's "
                    f"build_families (spec/{self.ir.name}*)")
            for vals in zip(*fam.params) if fam.params else [()]:
                vals = tuple(int(v) for v in vals)
                pairs, thresh = fam.guard(OFF, self.lay, *vals)
                for idx, w in pairs:
                    Wm[idx, lane] = w
                T[lane] = thresh
                lane += 1
        assert lane == self.n_lanes
        return Wm, T

    def _guard_terms(self):
        """W's nonzero rows per lane as (feature index, weight) terms
        padded to the widest lane's count: the plain form's gather."""
        Wm = self._gW
        G = max(1, int((Wm != 0).sum(0).max()))
        gidx = np.zeros((self.n_lanes, G), np.int64)
        gw = np.zeros((self.n_lanes, G), np.int32)
        for a in range(self.n_lanes):
            nz = np.nonzero(Wm[:, a])[0]
            gidx[a, :len(nz)] = nz
            gw[a, :len(nz)] = Wm[nz, a]
        return gidx, gw

    def _check_features_fit_int8(self):
        """The int8 product needs every guard feature in int8: the
        features are 0/1 flags by construction, checked here once on
        the initial state."""
        from ..convert import rows_to_torch
        one = rows_to_torch({k: np.asarray(v)[None] for k, v in
                             self.ir.encode(self.lay, *self.ir.init_state(
                                 self.cfg)).items()},
                            u32_keys=self.ir.u32_keys)
        phi = self.kern.guard_features(one, self.kern.derived(one))
        if phi.shape[0] != self._gW.shape[0] or \
                int(phi.min()) < 0 or int(phi.max()) > 1:
            raise ValueError(
                f"guard features of spec {self.ir.name!r} are not 0/1 "
                f"flags over {self._gW.shape[0]} rows: the int8 guard "
                "product would not be exact")

    # ---- the delta group ---------------------------------------------
    #
    # The affine families compile into one group over the flat int32
    # state view x (every state array in self.keys order, row-major)
    # and the source vector psi = [1; x; kernels.delta_features]:
    #
    #   Q [A_g, T] int8 — triple t belongs to group lane a (applied as
    #                     the gather t_lane);
    #   t_srcu, t_w [T] — each triple's source row (into the pruned
    #                     ``used`` rows of psi) and int32 weight;
    #   P [T, D] int8   — triple t writes slot t_slot[t] (applied as a
    #                     scatter-add over t_slot).
    #
    # A compacted (row, group lane) block then takes every lane's delta
    # at once: x'_rows = x_rows + P^T ((L Q) ⊙ (w · psi_rows[src])).

    def _build_delta_group(self):
        fams = [fi for fi, fam in enumerate(self.families)
                if fam.delta is not None]
        if not fams:
            return None
        # flat state-view layout from the encoded init state: shapes
        proto = self.ir.encode(self.lay, *self.ir.init_state(self.cfg))
        slots, shapes = {}, {}
        D = 0
        for k in self.keys:
            a = np.asarray(proto[k])
            slots[k], shapes[k] = D, a.shape
            D += int(a.size)
        foff = self.kern.delta_feature_offsets()
        nF = int(foff["total"])
        E = 1 + D + nF
        OFF = dict(slots)
        OFF["_const"] = 0            # source index of the literal 1
        OFF["_src_x"] = 1            # + flat slot -> old-value source
        OFF["_src_f"] = 1 + D        # + feature index -> feature source
        OFF["_feat"] = dict(foff)
        t_lane, t_slot, t_src, t_w = [], [], [], []
        fam_idx, lane_base, fam_trng = [], {}, {}
        lane_to_aff = np.full((self.n_lanes,), -1, np.int32)
        A_g = 0
        goff = 0
        for fi, fam in enumerate(self.families):
            nf = fam.n_lanes
            if fam.delta is not None:
                fam_idx.append(fi)
                lane_base[fi] = A_g
                t_lo = len(t_w)
                lane_to_aff[goff:goff + nf] = \
                    A_g + np.arange(nf, dtype=np.int32)
                for li, vals in enumerate(
                        zip(*fam.params) if fam.params else [()]):
                    vals = tuple(int(v) for v in vals)
                    for slot, src, w in fam.delta(OFF, self.lay, *vals):
                        if not 0 <= slot < D:
                            raise KeyError(
                                f"delta declaration of family "
                                f"{fam.name!r} (spec {self.ir.name!r}) "
                                f"writes slot {slot} outside the "
                                f"[0, {D}) state view")
                        if not 0 <= src < E:
                            raise KeyError(
                                f"delta declaration of family "
                                f"{fam.name!r} (spec {self.ir.name!r}) "
                                f"reads source {src} outside the "
                                f"[0, {E}) psi vector")
                        if not -(1 << 31) <= int(w) < (1 << 32):
                            raise KeyError(
                                f"delta declaration of family "
                                f"{fam.name!r} (spec {self.ir.name!r}) "
                                f"uses weight {w} outside the 32-bit "
                                f"range")
                        t_lane.append(A_g + li)
                        t_slot.append(slot)
                        t_src.append(src)
                        t_w.append(int(w))
                fam_trng[fi] = (t_lo, len(t_w))
                A_g += nf
            goff += nf
        T = len(t_w)
        Q = np.zeros((A_g, T), np.int8)
        Q[np.asarray(t_lane), np.arange(T)] = 1
        # only the psi rows some triple reads
        used = np.unique(np.asarray(t_src, np.int64))
        src_of = {int(s): u for u, s in enumerate(used)}
        # u32 bit weights (1 << 31) wrap to INT_MIN: the two's-complement
        # add still sets exactly that bit when the source proves it clear
        t_wi = (np.asarray(t_w, np.int64) &
                0xFFFFFFFF).astype(np.uint32).view(np.int32)
        P = np.zeros((T, D), np.int8)
        P[np.arange(T), np.asarray(t_slot)] = 1
        return dict(fam_idx=fam_idx, lane_base=lane_base, n_lanes=A_g,
                    n_triples=T, Q=Q, P=P, slots=slots, shapes=shapes,
                    D=D, used=used.astype(np.int32), n_feats=nF,
                    t_lane=np.asarray(t_lane, np.int32),
                    t_srcu=np.asarray([src_of[s] for s in t_src],
                                      np.int32),
                    t_slot=np.asarray(t_slot, np.int32),
                    t_w=t_wi, lane_to_aff=lane_to_aff, fam_trng=fam_trng)

    def _flatten_T(self, svT) -> torch.Tensor:
        """Batch-last int32 state dict [..., B] -> flat view [D, B]."""
        B = svT[self.keys[0]].shape[-1]
        return torch.cat([svT[k].reshape(-1, B) for k in self.keys])

    def _unflatten_T(self, flat) -> Dict[str, torch.Tensor]:
        """[D, B] flat view -> the state dict (views of ``flat``)."""
        dg = self._dgroup
        out = {}
        for k in self.keys:
            shape = dg["shapes"][k]
            n = int(np.prod(shape, dtype=np.int64))
            pos = dg["slots"][k]
            out[k] = flat[pos:pos + n].reshape(tuple(shape) +
                                               flat.shape[-1:])
        return out

    def _delta_of(self, psi_c, gl):
        """The group delta [D, cap] for per-row sources psi_c [U, cap]
        and group-lane ids gl [cap] (the one-hot L of the reference as
        its argmax): per-triple terms ``own ⊙ (w · psi[src])`` summed
        into their slots by a scatter-add — the reference's lowering
        off the TPU.  int32 adds wrap and commute, so the order of
        the adds (atomic on the card) cannot change the buffer."""
        t = self._dt
        return self._delta_terms(psi_c, gl, t["t_srcu"], t["t_w"],
                                 t["t_lane"], t["t_slot"])

    def _delta_of_fam(self, psi_c, gl_f, fi: int):
        """``_delta_of`` restricted to one family's triple range, for
        family-local lane ids gl_f (the chunk-skip form's block)."""
        dg, t = self._dgroup, self._dt
        lo, hi = dg["fam_trng"][fi]
        return self._delta_terms(psi_c, gl_f, t["t_srcu"][lo:hi],
                                 t["t_w"][lo:hi],
                                 t["t_lane"][lo:hi] - dg["lane_base"][fi],
                                 t["t_slot"][lo:hi])

    def _delta_terms(self, psi_c, gl, srcu, w, lane, slot):
        own = (lane[:, None] == gl[None, :]).to(I32)       # [T, cap]
        x = own * (psi_c[srcu] * w[:, None])
        return torch.zeros((self._dgroup["D"], x.shape[-1]), dtype=I32,
                           device=x.device).index_add_(0, slot, x)

    def _psi_T(self, svT, derT, xflat):
        """The used rows of psi = [1; x; features], in ``used``
        (ascending source) order — [U, B].  The feature pass is skipped
        when no declaration reads a feature."""
        t = self._dt
        parts = []
        if t["u_one"]:
            parts.append(torch.ones((1, xflat.shape[-1]), dtype=I32,
                                    device=xflat.device))
        if t["u_x"].numel():
            parts.append(xflat[t["u_x"]])
        if t["u_f"].numel():
            parts.append(self.kern.delta_features(svT, derT)[t["u_f"]])
        return torch.cat(parts)

    # ------------------------------------------------------------------

    def lane_labels(self) -> List[str]:
        out = []
        for f in self.families:
            for vals in zip(*f.params):
                out.append(f.labeler(*[int(v) for v in vals]))
        return out

    def default_fam_caps(self, chunk: int,
                         density=None) -> Tuple[int, ...]:
        """Per-family materialization caps: chunk × min(lanes, density)
        over the spec's density table, with ``density`` overriding it
        per family (validated)."""
        d = dict(self.ir.family_density)
        d.update(validate_fam_density(density, self.ir))
        return tuple(chunk * min(f.n_lanes, d.get(f.name, 2))
                     for f in self.families)

    # ---- runtime thresholds (the batched serving layer's padded
    # ceilings).  The int8 guard matrix is shared per ceiling; what a
    # job brings is device data: rt["thr"] int32 [A] (or [J, A]), the
    # thresholds the product is compared with (every job's equal the
    # ceiling's: they are conjunct counts), and rt["mask"] bool [A] (or
    # [J, A]), the job's lane mask, ANDed in after the compare, so a
    # masked lane never becomes a candidate.  With a [J, A] rt the
    # frontier's B rows are J jobs' blocks of B/J rows, job-major, and
    # the product stays one product over all of them.  rt=None is the
    # baked-constant form, unchanged.

    def runtime_thresholds(self):
        """The ceiling's (thresholds, all-enabled mask) as host arrays:
        the template a spec's ``serve_runtime`` starts from."""
        return (np.asarray(self._gT, np.int32).copy(),
                np.ones((self.n_lanes,), bool))

    def _compare(self, acc, rt) -> torch.Tensor:
        """acc int32 [B, A] -> ok bool [B, A] against the baked
        thresholds or a job's (or J jobs') runtime data."""
        if rt is None:
            return acc == self._T[None, :]
        thr, mask = rt["thr"], rt["mask"]
        if thr.dim() == 1:
            return (acc == thr[None, :]) & mask[None, :]
        J, A = thr.shape
        ok = (acc.view(J, -1, A) == thr[:, None, :]) & mask[:, None, :]
        return ok.view(-1, A)

    def guards_T(self, svT, derT, rt=None) -> torch.Tensor:
        """Batch-last frontier [..., B] -> ok bool [B, A]; ``rt`` the
        runtime thresholds above (None: the baked constants)."""
        if self.guard_matmul:
            return self.guards_T_matmul(svT, derT, rt)
        return self.guards_T_terms(svT, derT, rt)

    def guards_T_terms(self, svT, derT, rt=None) -> torch.Tensor:
        """The plain form: each lane's guard terms summed."""
        phi = self.kern.guard_features(svT, derT)              # [F, B]
        acc = (phi[self._gidx] * self._gw[:, :, None]).sum(
            1, dtype=I32)                                       # [A, B]
        return self._compare(acc.T, rt)

    def guards_T_matmul(self, svT, derT, rt=None) -> torch.Tensor:
        """The guard grid as one integer product φ [B, F] × W [F, A]
        with int32 accumulation, then the exact compare with T (or the
        runtime thresholds, and the lane mask).  On the
        card: ``torch._int_mm`` over int8, with F and A zero-padded to
        multiples of 8 (its shape rules) and B to a multiple of 32: on
        the H100, cuBLASLt refused B padded to 24 or 104 rows
        (CUBLAS_STATUS_NOT_SUPPORTED) and took 64, 1024 and 2048.  On
        the CPU: the same product in int32 (an int8 product would wrap
        in int8)."""
        phi = self.kern.guard_features(svT, derT)              # [F, B]
        F, B = phi.shape
        A = self.n_lanes
        if phi.is_cuda:
            Bp = (B + 31) // 32 * 32
            x = torch.zeros((Bp, self._W8.shape[0]), dtype=torch.int8,
                            device=phi.device)
            x[:B, :F] = phi.T
            acc = torch._int_mm(x, self._W8)[:B, :A]
        else:
            acc = phi.T @ self._W32
        return self._compare(acc, rt)

    # ---- fixed-width materialization ---------------------------------

    def _plan(self, B: int, fam_caps, jobs: int = 1):
        """The static compaction tables for ``jobs`` blocks of B rows
        each and the per-job caps: the permutation of the flat lane
        grid into (family, job) groups, family-major, each grouped
        lane's group, cap and slice offset, and the group ends.  A
        family's slices of every job sit side by side, so its kernel
        runs once over all of them."""
        key = (B, tuple(fam_caps), jobs)
        if key in self._plans:
            return self._plans[key]
        A, dev, J = self.n_lanes, self.device, jobs
        n_fams = len(self.families)
        perm = np.empty((J * B * A,), np.int64)      # grouped -> flat
        f_of = np.empty((J * B * A,), np.int64)      # grouped -> group
        grp_start = np.empty((n_fams * J,), np.int64)
        cap_g = np.empty((n_fams * J,), np.int64)
        coff_g = np.empty((n_fams * J,), np.int64)
        caps_np = np.asarray(fam_caps, np.int64)
        coff = np.concatenate([[0], np.cumsum(caps_np)[:-1]]) * J
        g = 0
        for fi, fam in enumerate(self.families):
            nf, off = fam.n_lanes, int(self.lane_off[fi])
            for j in range(J):
                gi = fi * J + j
                grp_start[gi] = g
                cap_g[gi] = caps_np[fi]
                coff_g[gi] = coff[fi] + j * caps_np[fi]
                perm[g:g + B * nf] = (
                    (j * B + np.arange(B))[:, None] * A + off +
                    np.arange(nf)[None, :]).reshape(-1)
                f_of[g:g + B * nf] = gi
                g += B * nf

        def t(a, dt=torch.int64):
            return torch.from_numpy(np.asarray(a)).to(dev, dt)

        plan = dict(
            perm=t(perm), f_of=t(f_of),
            ends=t(np.concatenate([grp_start[1:], [J * B * A]]) - 1),
            cap_p=t(cap_g[f_of]), coff_p=t(coff_g[f_of]),
            coff=[int(c) for c in coff], totc=int(caps_np.sum()) * J)
        self._plans[key] = plan
        return plan

    def materialize(self, svT, derT, okf, epos, fcap: int, fam_caps,
                    delta_fp=None, jobs: Optional[int] = None):
        """The candidate buffer [..., fcap] of the enabled lanes, in
        enumeration order.  svT/derT are batch-last [..., B]; okf is the
        flat [B*A] enabled mask (b-major), epos each flat lane's buffer
        position (fcap for a disabled lane, ``compact_positions``).
        Returns (cand, counts): counts int32 [n_fams] are the
        per-family enabled counts, as device data — a count above its
        cap, or more than fcap enabled lanes, means the buffer is
        incomplete and the caller replays with the caps grown.  Columns
        past the enabled count hold garbage that nothing may read.

        delta_fp — optional (fingerprinter, parent_tables) pair: each
        family also computes its candidates' per-permutation hashes
        incrementally from the parent tables (``family_delta``), and
        the result is (cand, counts, fp) with the sealed canonical
        fingerprints fp [n_streams, fcap].

        jobs — J jobs' chunks at once (the batched serving burst): the
        rows are J job-major blocks, ``fam_caps`` are each job's caps,
        ``fcap`` covers all J buffers and ``epos`` places each job's
        lanes in its own; counts come back int32 [J, n_fams]."""
        A = self.n_lanes
        J = 1 if jobs is None else int(jobs)
        B = okf.shape[0] // A // J
        pl = self._plan(B, fam_caps, J)
        totc, coff = pl["totc"], pl["coff"]
        fam_caps = [J * c for c in fam_caps]

        # ---- one compaction for every family: the lane grid family-
        # major, one cumsum, each family's slice position from it
        okg = okf[pl["perm"]]
        cum = torch.cumsum(okg.to(I32), 0)
        cum_end = cum[pl["ends"]]
        cum_start = torch.cat([cum_end.new_zeros(1), cum_end[:-1]])
        counts = cum_end - cum_start                 # [n_fams * J]
        wpos = cum - 1 - cum_start[pl["f_of"]]
        fits = okg & (wpos < pl["cap_p"])
        target = torch.where(fits, pl["coff_p"] + wpos, totc)
        # slice column -> flat lane (column totc takes the misfits)
        src = torch.full((totc + 1,), J * B * A, dtype=torch.int64,
                         device=okf.device)
        src.scatter_(0, target, pl["perm"])
        srcc = src[:totc].clamp(0, J * B * A - 1)
        b_all, l_all = srcc // A, srcc % A
        # buffer position -> slice column; only fitting lanes write
        epos_g = epos[pl["perm"]].long()
        mapidx = torch.full((fcap + 1,), totc, dtype=torch.int64,
                            device=okf.device)
        mapidx.scatter_(0, torch.where(fits & (epos_g < fcap), epos_g,
                                       fcap), target)
        take = mapidx[:fcap].clamp(0, totc - 1)

        # ---- the delta group: every affine family's slice at once
        dg = self._dgroup
        g_pos, g_all, g_par = {}, None, None
        if dg is not None:
            xflat = self._flatten_T(svT)
            psi = self._psi_T(svT, derT, xflat)
            gb_parts, gl_parts = [], []
            for fi in dg["fam_idx"]:
                nf = self.families[fi].n_lanes
                lo, cap = coff[fi], fam_caps[fi]
                gb_parts.append(b_all[lo:lo + cap])
                gl_parts.append((l_all[lo:lo + cap] -
                                 int(self.lane_off[fi])).clamp(0, nf - 1))
            if self.delta_chunk_skip:
                out_parts, par_parts = [], []
                for fi, gb_f, gl_f in zip(dg["fam_idx"], gb_parts,
                                          gl_parts):
                    rows = xflat[:, gb_f]
                    par_parts.append(rows)
                    out_parts.append(rows + self._delta_of_fam(
                        psi[:, gb_f], gl_f, fi))
                rows_flat = torch.cat(par_parts, -1)
                out_flat = torch.cat(out_parts, -1)
            else:
                gb = torch.cat(gb_parts)
                gl = torch.cat([g + dg["lane_base"][fi] for fi, g in
                                zip(dg["fam_idx"], gl_parts)])
                rows_flat = xflat[:, gb]
                out_flat = rows_flat + self._delta_of(psi[:, gb], gl)
            g_all = self._unflatten_T(out_flat)
            if delta_fp is not None:
                g_par = self._unflatten_T(rows_flat)
            pos = 0
            for fi in dg["fam_idx"]:
                g_pos[fi] = pos
                pos += fam_caps[fi]

        # ---- per-family kernels on their slices
        outs, fp_outs = [], []
        for fi, (fam, cap) in enumerate(zip(self.families, fam_caps)):
            nf, lo = fam.n_lanes, coff[fi]
            b_idx = b_all[lo:lo + cap]
            l_idx = (l_all[lo:lo + cap] -
                     int(self.lane_off[fi])).clamp(0, nf - 1)
            prm = [p[l_idx] for p in self._params[fi]]
            if fi in g_pos:
                gp = g_pos[fi]
                sv2 = {k: v[..., gp:gp + cap] for k, v in g_all.items()}
                outs.append(sv2)
                if delta_fp is not None:
                    fpr, tables = delta_fp
                    fp_outs.append(fpr.family_delta(
                        fam.name, tables, b_idx,
                        {k: v[..., gp:gp + cap] for k, v in g_par.items()},
                        sv2, prm))
                continue
            sv_rows = {k: v[..., b_idx] for k, v in svT.items()}
            der_rows = {k: v[..., b_idx] for k, v in derT.items()}
            # int32 rows whatever a kernel's arithmetic promoted to (the
            # incremental deltas wrap in int32, as the reference's do)
            sv2 = {k: v.to(I32) for k, v in
                   fam.fn(sv_rows, der_rows, *prm).items()}
            outs.append(sv2)
            if delta_fp is not None:
                fpr, tables = delta_fp
                fp_outs.append(fpr.family_delta(fam.name, tables, b_idx,
                                                sv_rows, sv2, prm))
        cand = {k: torch.cat([o[k] for o in outs], -1)[..., take]
                for k in self.keys}
        if jobs is not None:
            counts = counts.view(-1, J).T
        if delta_fp is None:
            return cand, counts
        h_all = torch.cat(fp_outs, -1)[..., take]
        return cand, counts, delta_fp[0].finish_min(h_all)

    # ---- one lane per row: the random walkers' step ------------------

    def derived_batch_T(self, svT) -> Dict[str, torch.Tensor]:
        """Batch-last derived quantities (the kernels are batch-last
        already)."""
        return self.kern.derived(svT)

    def step_lanes(self, svT, derT, lane) -> Dict[str, torch.Tensor]:
        """Batch-last states [..., B] and flat lane ids int32 [B] -> the
        successor rows [..., B]: each family's kernel runs once over
        every row with that row's params (clipped into the family's
        grid when the row chose another family; the lane-range select
        discards that result), and a row whose lane is out of range
        (-1: no enabled lane) comes back unchanged.  With the delta
        group, a row whose lane belongs to an affine family steps
        through the group's scatter-add; any other row's group lane is
        -1, which matches no triple, so its delta is exactly zero."""
        dg = self._dgroup
        if dg is not None:
            aff = self._dt["lane_to_aff"][
                lane.clamp(0, self.n_lanes - 1).long()]
            gl = torch.where(lane >= 0, aff, -1)
            xflat = self._flatten_T(svT)
            psi = self._psi_T(svT, derT, xflat)
            out = self._unflatten_T(xflat + self._delta_of(psi, gl))
        else:
            out = dict(svT)
        for fi, fam in enumerate(self.families):
            nf, off = fam.n_lanes, int(self.lane_off[fi])
            if dg is not None and fam.delta is not None:
                continue
            li = (lane - off).clamp(0, nf - 1).long()
            sv2 = fam.fn(svT, derT, *[p[li] for p in self._params[fi]])
            sel = (lane >= off) & (lane < off + nf)
            out = {k: torch.where(sel, sv2[k].to(I32), out[k])
                   for k in out}
        return out

    def expand_one(self, arrs: Dict[str, np.ndarray]):
        """One state's encoded arrays -> [(label, successor arrays)] of
        its enabled lanes in ascending lane order (the witness decode's
        and the tests' path)."""
        from ..convert import arrays_to_numpy, rows_to_torch
        sv = rows_to_torch({k: np.asarray(v)[None] for k, v in
                            arrs.items()}, self.device, self.ir.u32_keys)
        ok = self.guards_T(sv, self.derived_batch_T(sv))[0]
        lanes = ok.nonzero().squeeze(1).to(I32)
        n = lanes.numel()
        svn = {k: v.expand(v.shape[:-1] + (n,)).contiguous()
               for k, v in sv.items()}
        succ = arrays_to_numpy(self.step_lanes(
            svn, self.derived_batch_T(svn), lanes), self.ir.u32_keys)
        labels = self.lane_labels()
        return [(labels[a], {k: np.ascontiguousarray(v[..., j])
                             for k, v in succ.items()})
                for j, a in enumerate(lanes.tolist())]
