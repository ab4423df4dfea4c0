"""Shape-portable resume images (the reference's
``raft_tla_tpu/resil/portable.py``): any engine family's checkpoint
read into one engine-agnostic wavefront.

Every engine family's checkpoint — the classic ``Engine``, the
``SpillEngine``, ``ShardedEngine`` and ``SpilledShardedEngine``, from
either package — carries the same logical wavefront under different
layouts: the visited-fingerprint set, the frontier rows (the
last committed level) in gid order, the run counters and the trace
archives.  ``load_portable_image`` reads any of those files into one
``PortableImage``:

- ``keys`` — [N, W] u32 visited fingerprints (dense tables are
  sparsified, host partitions pooled, per-device shards concatenated:
  membership is a set property, so the slot layout never matters);
- ``rows``/``gids``/``con`` — frontier rows batch-major in the storage
  dtypes, their global ids and the constraint mask (``con=False`` rows
  are archived but never expanded);
- the counters (a ``CheckResult``), depth, ``n_states`` and the
  archives.

The sharded readers only parse files: a mesh's file reads without a
mesh.  A target engine rebuilds its table from the key set and re-homes
the frontier rows, so a resumed run lands on the counts and level sizes
of an uninterrupted one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .ckpt_chain import IntegrityError, open_validated

U32 = np.uint32(0xFFFFFFFF)


@dataclass
class PortableImage:
    spec: str
    cfg_repr: str
    depth: int
    n_states: int
    res: object                       # engine.bfs.CheckResult
    keys: np.ndarray                  # [N, W] u32 visited fingerprints
    rows: Dict[str, np.ndarray]       # frontier, batch-major storage
    gids: np.ndarray                  # [F] int32
    con: np.ndarray                   # [F] bool (expandable mask)
    store_states: bool
    # in-RAM trace archives (parents/lanes/state blocks per level), or
    # a disk archive's level count for the target to reattach
    parents: List[np.ndarray] = field(default_factory=list)
    lanes: List[np.ndarray] = field(default_factory=list)
    states: List[Dict[str, np.ndarray]] = field(default_factory=list)
    disk_archive_levels: Optional[int] = None
    source_format: str = "engine"
    source_path: str = ""

    @property
    def W(self) -> int:
        return int(self.keys.shape[1])

    @property
    def n_vis(self) -> int:
        return int(self.keys.shape[0])

    @property
    def n_front(self) -> int:
        return int(self.gids.shape[0])

    def fresh_result(self):
        """A fresh CheckResult copy of the image's counters: an image
        can seed several engines, and a run mutates its result."""
        from ..engine.bfs import CheckResult
        r = self.res
        out = CheckResult(distinct_states=r.distinct_states,
                          generated_states=r.generated_states,
                          depth=r.depth)
        out.level_sizes = list(r.level_sizes)
        for k in ("overflow_faults", "violations_global",
                  "pin_interior_states", "levels_fused",
                  "burst_dispatches", "burst_bailouts"):
            setattr(out, k, getattr(r, k))
        out.violations = list(r.violations)
        return out

    def expandable(self):
        """(rows, gids) with pruned rows dropped: the spill engines'
        frontier convention."""
        if self.con.all():
            return self.rows, self.gids
        keep = np.nonzero(self.con)[0]
        return ({k: np.ascontiguousarray(v[keep])
                 for k, v in self.rows.items()}, self.gids[keep])


def validate_image(img: "PortableImage", spec_name: str,
                   cfg_repr: str, W: int):
    """The gate every ``resume_image`` consumer runs: same spec, the
    same config repr, the same fingerprint width.  Raises
    ``CheckpointError`` with the reference's words."""
    from ..engine.ckpt import CheckpointError
    if not isinstance(img, PortableImage):
        raise CheckpointError(
            f"resume_image must be a resil.portable.PortableImage "
            f"(got {type(img).__name__}) — build one with "
            "load_portable_image(path)")
    if img.spec != spec_name:
        raise CheckpointError(
            f"portable image was written for spec {img.spec!r}; "
            f"engine is running spec {spec_name!r}")
    if img.cfg_repr != cfg_repr:
        raise CheckpointError(
            "portable image was written for a different model "
            f"config:\n  image:  {img.cfg_repr}\n"
            f"  engine: {cfg_repr}")
    if img.W != W:
        raise CheckpointError(
            f"portable image has {img.W} fingerprint streams; engine "
            f"expects {W} (fp64 vs fp128 mismatch)")


def dense_table_keys(words: List[np.ndarray]) -> np.ndarray:
    """[W] x u32[...C] dense open-addressing table -> [N, W] keys (the
    all-ones key reads as empty, the engines' accepted-risk class)."""
    occ = ~(words[0] == U32)
    for w in words[1:]:
        occ &= ~(w == U32)
    occ = occ if occ.ndim == 1 else occ.reshape(-1)
    flat = [w.reshape(-1) for w in words]
    idx = np.nonzero(occ)[0]
    return np.stack([w[idx] for w in flat], axis=1)


def _in_ram_archives(z, meta):
    n_levels = int(meta.get("n_levels", 0))
    if not (meta.get("store_states") and n_levels >= 0):
        return [], [], []
    st_keys = sorted({nm.split("|", 2)[2] for nm in z.files
                      if nm.startswith("states|0|")})
    parents = [np.asarray(z[f"parents|{i}"]) for i in range(n_levels)]
    lanes = [np.asarray(z[f"lanes|{i}"]) for i in range(n_levels)]
    states = [{k: np.asarray(z[f"states|{i}|{k}"]) for k in st_keys}
              for i in range(n_levels)]
    return parents, lanes, states


def load_portable_image(path: str) -> PortableImage:
    """Read any engine family's checkpoint into a PortableImage,
    integrity-checked with the chain's fallback (``ckpt_chain``) as
    every native resume is.  Raises ``CheckpointError`` on a file it
    cannot use."""
    import json

    from ..engine.ckpt import CheckpointError, ckpt_result
    from .ckpt_chain import load_engine_npz
    try:
        z, used = open_validated(path, load_engine_npz)
    except IntegrityError as e:
        raise CheckpointError(str(e)) from e
    meta = json.loads(str(z["meta"]))
    spill = bool(meta.get("spill"))
    sharded = bool(meta.get("sharded"))
    try:
        if spill and sharded:
            img = _extract_spill_mesh(z, meta)
        elif spill:
            img = _extract_spill(z, meta)
        elif sharded:
            img = _extract_sharded(z, meta)
        else:
            img = _extract_engine(z, meta)
    except KeyError as e:
        raise CheckpointError(
            f"{used}: checkpoint lacks record {e} — written by an "
            "incompatible engine version; portable resume needs a "
            "round-12+ checkpoint for this engine family") from e
    img.res = ckpt_result(z, meta)
    img.depth = int(meta["depth"])
    img.n_states = int(meta["n_states"])
    img.spec = meta.get("spec", "raft")
    img.cfg_repr = meta["cfg"]
    img.store_states = bool(meta.get("store_states"))
    img.source_path = used
    if meta.get("disk_archive"):
        img.disk_archive_levels = int(meta["arch_levels"])
    else:
        img.parents, img.lanes, img.states = _in_ram_archives(z, meta)
    z.close()
    return img


def _blank(fmt) -> PortableImage:
    return PortableImage(spec="", cfg_repr="", depth=0, n_states=0,
                         res=None, keys=np.zeros((0, 2), np.uint32),
                         rows={}, gids=np.zeros((0,), np.int32),
                         con=np.zeros((0,), bool), store_states=False,
                         source_format=fmt)


def _extract_engine(z, meta) -> PortableImage:
    img = _blank("engine")
    words = []
    w = 0
    while f"carry|vis|{w}" in z:
        words.append(np.asarray(z[f"carry|vis|{w}"]))
        w += 1
    if not words:
        raise KeyError("carry|vis|0")
    img.keys = dense_table_keys(words)
    n_front = int(meta["n_front"])
    pg_off = int(np.asarray(z["carry|pg_off"]))
    fmask = np.asarray(z["carry|fmask"])[:n_front]
    rows = {}
    for nm in z.files:
        if nm.startswith("carry|front|"):
            k = nm.split("|", 2)[2]
            v = np.asarray(z[nm])          # batch-last [..., LCAP]
            rows[k] = np.ascontiguousarray(
                np.moveaxis(v[..., :n_front], -1, 0))
    img.rows = rows
    img.gids = pg_off + np.arange(n_front, dtype=np.int32)
    img.con = fmask.astype(bool)
    return img


def _extract_sharded(z, meta) -> PortableImage:
    img = _blank("sharded")
    words = []
    w = 0
    while f"carry|vis|{w}" in z:
        words.append(np.asarray(z[f"carry|vis|{w}"]))   # [D, VB]
        w += 1
    if not words:
        raise KeyError("carry|vis|0")
    img.keys = dense_table_keys(words)
    nfd = np.asarray(z["carry|n_front"])               # [D]
    fmask = np.asarray(z["carry|fmask"])               # [D, LB]
    gids = np.asarray(z["carry|gids"])                 # [D, LB]
    D = nfd.shape[0]
    fronts = {}
    for nm in z.files:
        if nm.startswith("carry|front|"):
            fronts[nm.split("|", 2)[2]] = np.asarray(z[nm])
    rows_d, gids_d, con_d = [], [], []
    for d in range(D):
        n = int(nfd[d])
        if not n:
            continue
        rows_d.append({k: v[d, :n] for k, v in fronts.items()})
        gids_d.append(gids[d, :n].astype(np.int32))
        con_d.append(fmask[d, :n].astype(bool))
    if rows_d:
        keys0 = rows_d[0].keys()
        rows = {k: np.concatenate([r[k] for r in rows_d])
                for k in keys0}
        g = np.concatenate(gids_d)
        c = np.concatenate(con_d)
        order = np.argsort(g, kind="stable")   # global gid order
        img.rows = {k: np.ascontiguousarray(v[order])
                    for k, v in rows.items()}
        img.gids = g[order]
        img.con = c[order]
    else:
        img.rows = {k: v[:0, 0] for k, v in fronts.items()}
        img.gids = np.zeros((0,), np.int32)
        img.con = np.zeros((0,), bool)
    return img


def _extract_spill(z, meta) -> PortableImage:
    img = _blank("spill")
    if meta.get("host_table"):
        # the host partitions are the authoritative visited set (the
        # device table is a bounded cache of them)
        shape = np.asarray(z["carry|hpt|shape"])
        P = int(shape[0])
        parts = [np.asarray(z[f"carry|hpt|keys{p}"]).T
                 for p in range(P)]            # [n_p, W]
        img.keys = (np.concatenate(parts) if parts
                    else np.asarray(z["carry|vis_keys"]).T)
    else:
        img.keys = np.ascontiguousarray(
            np.asarray(z["carry|vis_keys"]).T)
    rows_b, gids_b = [], []
    for i in range(int(meta["n_fblk"])):
        g = np.asarray(z[f"carry|fblk|{i}|g"])
        blk = {}
        for nm in z.files:
            pre = f"carry|fblk|{i}|r|"
            if nm.startswith(pre):
                v = np.asarray(z[nm])          # batch-last [..., n]
                blk[nm[len(pre):]] = np.ascontiguousarray(
                    np.moveaxis(v, -1, 0))
        rows_b.append(blk)
        gids_b.append(g.astype(np.int32))
    if rows_b:
        keys0 = rows_b[0].keys()
        img.rows = {k: np.concatenate([r[k] for r in rows_b])
                    for k in keys0}
        img.gids = np.concatenate(gids_b)
    img.con = np.ones((img.gids.shape[0],), bool)
    return img


def _extract_spill_mesh(z, meta) -> PortableImage:
    """Either package's ``SpilledShardedEngine`` writes the wavefront
    pooled and in gid order already: its native form is the portable
    one."""
    img = _blank("spill_mesh")
    if meta.get("host_table"):
        D = int(meta["D"])
        parts = []
        for d in range(D):
            shape = np.asarray(z[f"carry|hpt{d}|shape"])
            for p in range(int(shape[0])):
                parts.append(np.asarray(z[f"carry|hpt{d}|keys{p}"]).T)
        img.keys = np.concatenate(parts) if parts else \
            np.zeros((0, int(meta.get("W", 2))), np.uint32)
    else:
        img.keys = np.ascontiguousarray(np.asarray(z["carry|keys"]))
    rows = {}
    for nm in z.files:
        if nm.startswith("carry|pf|rows|"):
            rows[nm.split("|", 3)[3]] = np.asarray(z[nm])  # batch-major
    img.rows = rows
    img.gids = np.asarray(z["carry|pf|g"]).astype(np.int32)
    img.con = np.ones((img.gids.shape[0],), bool)
    return img
