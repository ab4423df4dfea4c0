"""Per-level trace archives on disk: the parent/lane/state-row store
behind ``store_states`` with ``archive_dir=`` (the reference's
``raft_tla_tpu/engine/archive.py``; a directory written by either
package is attached by the other).

Without ``archive_dir`` the engine keeps each level's numpy arrays in
host lists; a run of tens of millions of states would hold tens of GB
of rows there.  With it, each level's arrays stream to memmap'd
``.npy`` files under a run directory and are read back through
``numpy`` memory maps, so trace reconstruction and ``store_states``
runs are bounded by the frontier working set, not the cumulative
archive.  TLC keeps its state queue and trace files on disk the same
way (its ``states/`` directory).

Layout under ``root``::

    meta.json                  {"level_rows": [...], "keys": [...]}
    lvl0000.parents.npy        int32 [n]  parent global ids
    lvl0000.lanes.npy          int32 [n]  action lane ids
    lvl0000.st.<key>.npy       storage-dtype [n, ...] state rows
    ...

Rows are batch-MAJOR on disk, in the storage dtypes (``bag`` uint32);
writers may supply batch-last parts and they are transposed per part,
so a level streams to disk without a whole-level concatenation
buffer.

``meta.json`` is rewritten atomically after every level append, so a
killed run leaves a readable archive of its completed levels; resume
truncates back to the checkpointed level count (`truncate`) to keep
resumed runs bit-identical to uninterrupted ones.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


class ArchiveError(ValueError):
    """Archive directory missing, malformed, or inconsistent with the
    run/checkpoint attaching to it."""


def _lvl(i: int) -> str:
    return f"lvl{i:04d}"


class DiskArchive:
    """Disk-backed per-level parent/lane/state archive (module
    docstring).  One instance per run directory; ``attach=True`` reopens
    an existing archive (checkpoint resume) instead of starting empty.
    """

    def __init__(self, root: str, attach: bool = False):
        self.root = root
        self._mmaps: Dict[str, np.ndarray] = {}   # read-cache per file
        if attach:
            try:
                with open(self._meta_path) as fh:
                    meta = json.load(fh)
            except (OSError, ValueError) as e:
                raise ArchiveError(
                    f"{root}: not a readable trace archive ({e})") from e
            self.level_rows: List[int] = [int(n) for n in
                                          meta["level_rows"]]
            self.keys: Optional[List[str]] = list(meta["keys"]) \
                if meta.get("keys") is not None else None
        else:
            os.makedirs(root, exist_ok=True)
            self.level_rows = []
            self.keys = None
            self._write_meta()

    # -- write path ----------------------------------------------------

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.root, "meta.json")

    def _write_meta(self):
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"level_rows": self.level_rows, "keys": self.keys},
                      fh)
        os.replace(tmp, self._meta_path)

    def _path(self, i: int, name: str) -> str:
        return os.path.join(self.root, f"{_lvl(i)}.{name}.npy")

    def append_level(self, parents: np.ndarray, lanes: np.ndarray,
                     states: Dict[str, np.ndarray]):
        """One finished level, batch-major arrays (the classic engines'
        harvest layout)."""
        self.append_level_parts([dict(
            lpar=parents, llane=lanes, rows_major=states,
            n=int(parents.shape[0]))])

    def append_level_parts(self, parts: List[dict]):
        """One finished level from spill parts, streamed part-by-part
        into the level's memmaps (no whole-level concat buffer).  Each
        part is ``dict(n=…, lpar=…, llane=…)`` plus either
        ``rows`` (batch-LAST state arrays, the spill block layout) or
        ``rows_major`` (batch-major)."""
        # chaos site: a disk I/O failure before this level's memmaps
        # are written.  meta.json still names only complete levels, so
        # a resume reattaches + truncates and re-appends bit-exact.
        from ..resil.chaos import chaos_point
        chaos_point("archive")
        i = len(self.level_rows)
        n = sum(int(p["n"]) for p in parts)
        first = parts[0]
        rows0 = first.get("rows_major") or first["rows"]
        if self.keys is None:
            self.keys = sorted(rows0.keys())
        mm_par = np.lib.format.open_memmap(
            self._path(i, "parents"), mode="w+", dtype=np.int32,
            shape=(n,))
        mm_lane = np.lib.format.open_memmap(
            self._path(i, "lanes"), mode="w+", dtype=np.int32,
            shape=(n,))
        mm_st = {}
        for k in self.keys:
            v = rows0[k]
            minor = v.shape[1:] if "rows_major" in first else v.shape[:-1]
            mm_st[k] = np.lib.format.open_memmap(
                self._path(i, f"st.{k}"), mode="w+", dtype=v.dtype,
                shape=(n,) + tuple(minor))
        off = 0
        for p in parts:
            m = int(p["n"])
            mm_par[off:off + m] = p["lpar"][:m]
            mm_lane[off:off + m] = p["llane"][:m]
            if "rows_major" in p:
                for k in self.keys:
                    mm_st[k][off:off + m] = p["rows_major"][k][:m]
            else:
                for k in self.keys:
                    mm_st[k][off:off + m] = np.moveaxis(
                        p["rows"][k][..., :m], -1, 0)
            off += m
        for mm in [mm_par, mm_lane, *mm_st.values()]:
            mm.flush()
        del mm_par, mm_lane, mm_st      # drop the write maps: RSS stays
        # bounded by the level being written, not the cumulative archive
        self.level_rows.append(n)
        self._write_meta()

    def truncate(self, n_levels: int):
        """Drop levels past ``n_levels`` (checkpoint resume: the run
        replays from the checkpointed level and re-appends them)."""
        if n_levels > len(self.level_rows):
            raise ArchiveError(
                f"{self.root}: archive has {len(self.level_rows)} "
                f"levels, checkpoint expects {n_levels} — wrong "
                "archive_dir for this checkpoint?")
        for i in range(n_levels, len(self.level_rows)):
            for name in ["parents", "lanes"] + \
                    [f"st.{k}" for k in (self.keys or [])]:
                try:
                    os.remove(self._path(i, name))
                except OSError:
                    pass
        self.level_rows = self.level_rows[:n_levels]
        self._mmaps.clear()
        self._write_meta()

    # -- read path (memmap'd; random access never loads a level) -------

    @property
    def n_levels(self) -> int:
        return len(self.level_rows)

    @property
    def total_rows(self) -> int:
        return sum(self.level_rows)

    def _map(self, i: int, name: str) -> np.ndarray:
        path = self._path(i, name)
        mm = self._mmaps.get(path)
        if mm is None:
            mm = self._mmaps[path] = np.load(path, mmap_mode="r")
        return mm

    def parents(self, i: int) -> np.ndarray:
        return self._map(i, "parents")

    def lanes(self, i: int) -> np.ndarray:
        return self._map(i, "lanes")

    def states(self, i: int) -> Dict[str, np.ndarray]:
        return {k: self._map(i, f"st.{k}") for k in self.keys or []}

    def locate(self, gid: int):
        """Global state id -> (level, row-within-level)."""
        off = 0
        for i, n in enumerate(self.level_rows):
            if gid < off + n:
                return i, gid - off
            off += n
        raise IndexError(gid)

    def state_row(self, gid: int) -> Dict[str, np.ndarray]:
        i, r = self.locate(gid)
        return {k: np.asarray(self._map(i, f"st.{k}")[r])
                for k in self.keys or []}

    def parent_lane(self, gid: int):
        i, r = self.locate(gid)
        return int(self._map(i, "parents")[r]), \
            int(self._map(i, "lanes")[r])
