"""Fingerprint-prefix-partitioned visited table in host RAM (the
reference's ``raft_tla_tpu/engine/host_table.py``, numpy as it is).

A device-resident visited table caps an exhaustive run at the keys the
card's memory holds next to the spill segments.  This is the host-RAM
counterpart:

- the fingerprint space splits by the top bits of stream 0 into ``P``
  power-of-two partitions; each partition is an open-addressing image
  with the device table's slot layout, home hash and quadratic walk,
  so a partition image can be shipped to the device and probed there
  with the same discipline;
- per BFS level the spill engine buckets the level's keys by prefix and
  sweeps partition by partition (``engine/spill.py``
  ``_sweep_level_keys``): the device probes the level's keys against
  partition ``p``'s uploaded image while ``p+1``'s upload is under way,
  and the host appends the keys no earlier level held into its
  authoritative image;
- the device table degrades to a bounded cache of recent levels' keys
  (it can only err fresh-ward, re-admitting an evicted key, never
  suppress a new state), so the ceiling moves from "every distinct key
  fits the card" to "one partition image and one level's keys fit it".

First-seen exactness: level keys arrive deduplicated within the level
(the device cache is complete over the running level) and in
enumeration order, so membership against the archive is the only
decision left; the kept set and every count equal the in-memory
engine's.  Images are uint32 [W, cap] with all-ones as the empty slot,
exactly the reference's, so a checkpoint's images read in either
package.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..utils import HOME_SALT, fmix32_np

U32 = np.uint32(0xFFFFFFFF)
_MAX_ROUNDS = 4096


def home_np(keys: np.ndarray, cap: int) -> np.ndarray:
    """Home slots for [N, W] u32 keys in a cap-slot (power-of-two)
    table: the device table's home hash (``utils.home_slots``)."""
    h = np.full(keys.shape[0], HOME_SALT, np.uint32)
    for w in range(keys.shape[1]):
        h = fmix32_np(h ^ keys[:, w])
    return (h & np.uint32(cap - 1)).astype(np.int64)


def member_np(img: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Membership of [N, W] keys in a [W, C] open-addressing image:
    quadratic walk until the key (found) or an empty slot (absent).
    Gathers only; the host twin of the device sweep probe."""
    N, W = keys.shape
    C = img.shape[1]
    found = np.zeros(N, bool)
    if N == 0:
        return found
    pos = home_np(keys, C)
    t = np.zeros(N, np.int64)
    active = np.ones(N, bool)
    keysT = keys.T
    for _ in range(_MAX_ROUNDS):
        if not active.any():
            break
        cur = img[:, pos]                       # [W, N]
        iskey = (cur == keysT).all(axis=0)
        isempty = (cur == U32).all(axis=0)
        found |= active & iskey
        active &= ~(iskey | isempty)
        t = np.where(active, t + 1, t)
        pos = np.where(active, (pos + t) & (C - 1), pos)
    else:
        if active.any():
            # a lane that met neither its key nor an empty slot would
            # read as absent, and a duplicate commit would inflate counts
            raise RuntimeError("host partition membership walk did "
                               "not converge — image pathologically "
                               "full")
    return found


def insert_np(img: np.ndarray, keys: np.ndarray,
              ranks: Optional[np.ndarray] = None) -> None:
    """Insert [N, W] keys (unique, not present) into the image in
    place: walk to an empty slot, claim by the least rank, winners
    write, losers walk on.  Deterministic for a fixed key order."""
    N = keys.shape[0]
    if N == 0:
        return
    C = img.shape[1]
    if ranks is None:
        ranks = np.arange(N, dtype=np.int64)
    else:
        ranks = ranks.astype(np.int64)
    pos = home_np(keys, C)
    t = np.zeros(N, np.int64)
    active = np.ones(N, bool)
    for _ in range(_MAX_ROUNDS):
        if not active.any():
            break
        # walk every active lane to its next empty slot
        for _w in range(_MAX_ROUNDS):
            isempty = (img[:, pos] == U32).all(axis=0)
            moving = active & ~isempty
            if not moving.any():
                break
            t = np.where(moving, t + 1, t)
            pos = np.where(moving, (pos + t) & (C - 1), pos)
        else:
            raise RuntimeError("host partition probe walk did not "
                               "converge — image pathologically full")
        # claim round: the least rank wins each contested empty slot
        claims = np.full(C, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(claims, pos[active], ranks[active])
        won = active & (claims[pos] == ranks)
        img[:, pos[won]] = keys[won].T
        active &= ~won
    else:
        raise RuntimeError("host partition claim rounds did not "
                           "converge — image pathologically full")


class HostPartitionedTable:
    """P prefix-partitioned open-addressing images in host RAM.

    n_streams  — u32 words per key (2 for fp64, 4 for fp128).
    partitions — P, a power of two; partition id = key stream 0's top
                 log2(P) bits, a pure function of the key, so counts do
                 not depend on P.
    part_cap   — initial slots per partition image (grows ×4 past the
                 0.40 load bound, rehashed on the host).
    """

    LOAD_MAX = 0.40

    def __init__(self, n_streams: int, partitions: int = 4,
                 part_cap: int = 1 << 12):
        if partitions & (partitions - 1):
            raise ValueError(f"partitions must be a power of two, "
                             f"got {partitions}")
        part_cap = max(int(part_cap), 1 << 6)
        if part_cap & (part_cap - 1):
            c = 1
            while c < part_cap:
                c *= 2
            part_cap = c
        self.W = int(n_streams)
        self.P = int(partitions)
        self.bits = self.P.bit_length() - 1
        self.imgs: List[np.ndarray] = [
            np.full((self.W, part_cap), U32, np.uint32)
            for _ in range(self.P)]
        self.counts: List[int] = [0] * self.P
        # per-partition version, bumped on every rehash and commit: a
        # device copy staged ahead of a sweep serves it only while its
        # version is still current
        self.vers: List[int] = [0] * self.P

    # -- key bucketing -------------------------------------------------

    def partition_ids(self, keys: np.ndarray) -> np.ndarray:
        """[N, W] u32 keys -> int64 partition ids (stream 0 top bits)."""
        if self.bits == 0:
            return np.zeros(keys.shape[0], np.int64)
        return (keys[:, 0] >> np.uint32(32 - self.bits)).astype(np.int64)

    @property
    def n_keys(self) -> int:
        return sum(self.counts)

    @property
    def nbytes(self) -> int:
        return sum(img.nbytes for img in self.imgs)

    def cap(self, p: int) -> int:
        return self.imgs[p].shape[1]

    # -- growth --------------------------------------------------------

    def reserve(self, p: int, add: int) -> bool:
        """Grow partition ``p`` so it takes ``add`` more keys under the
        load bound; True when it rehashed.  Called before a sweep
        uploads the image, so the device never probes an image past
        its probe budget."""
        cap = self.cap(p)
        need = self.counts[p] + int(add)
        if need <= self.LOAD_MAX * cap:
            return False
        while need > self.LOAD_MAX * cap:
            cap *= 4
        old = self.imgs[p]
        occ = ~(old == U32).all(axis=0)
        keys = old[:, occ].T.copy()              # slot order: stable
        self.imgs[p] = np.full((self.W, cap), U32, np.uint32)
        insert_np(self.imgs[p], keys)
        self.vers[p] += 1
        return True

    # -- host-side sweep -----------------------------------------------

    def member(self, keys: np.ndarray) -> np.ndarray:
        """[N, W] keys -> bool[N] already archived (any partition)."""
        out = np.zeros(keys.shape[0], bool)
        pids = self.partition_ids(keys)
        for p in np.unique(pids):
            sel = pids == p
            out[sel] = member_np(self.imgs[int(p)], keys[sel])
        return out

    def commit(self, keys: np.ndarray, fresh: np.ndarray) -> None:
        """Append ``keys[fresh]`` (unique, found absent by a member
        pass) into their partitions, growing under the load bound."""
        keys = keys[fresh]
        pids = self.partition_ids(keys)
        for p in np.unique(pids):
            sel = pids == p
            kp = keys[sel]
            self.reserve(int(p), kp.shape[0])
            insert_np(self.imgs[int(p)], kp)
            self.counts[int(p)] += int(kp.shape[0])
            self.vers[int(p)] += 1

    def sweep(self, keys: np.ndarray) -> np.ndarray:
        """Level sweep on the host: returns keep = ~member and commits
        the kept keys.  ``keys`` must be unique and in enumeration
        order."""
        # chaos site: a lost host partition (the partitions live with
        # the host process; recovery rebuilds them from a checkpoint)
        from ..resil.chaos import chaos_point
        chaos_point("host_table")
        seen = self.member(keys)
        self.commit(keys, ~seen)
        return ~seen

    # -- checkpoint serialization (sparse, exact-image restore) --------

    def state_dict(self, prefix: str = "hpt") -> Dict[str, np.ndarray]:
        """Occupied slots and keys per partition: a resume rebuilds the
        exact images (no rehash drift)."""
        out = {f"{prefix}|shape": np.array(
            [self.P, self.W] + [self.cap(p) for p in range(self.P)],
            np.int64)}
        for p in range(self.P):
            occ = ~(self.imgs[p] == U32).all(axis=0)
            idx = np.nonzero(occ)[0].astype(np.int64)
            out[f"{prefix}|idx{p}"] = idx
            out[f"{prefix}|keys{p}"] = np.ascontiguousarray(
                self.imgs[p][:, idx])
        return out

    @classmethod
    def from_state(cls, get, prefix: str = "hpt"
                   ) -> "HostPartitionedTable":
        """Rebuild from ``state_dict`` arrays; ``get(name)`` returns the
        stored array (an npz indexer)."""
        shape = np.asarray(get(f"{prefix}|shape"))
        P, W = int(shape[0]), int(shape[1])
        tbl = cls(W, partitions=P, part_cap=int(shape[2]))
        for p in range(P):
            cap = int(shape[2 + p])
            idx = np.asarray(get(f"{prefix}|idx{p}"))
            keys = np.asarray(get(f"{prefix}|keys{p}"))
            img = np.full((W, cap), U32, np.uint32)
            img[:, idx] = keys
            tbl.imgs[p] = img
            tbl.counts[p] = int(idx.shape[0])
        return tbl
