"""Carry state across between the JAX package's numpy artefacts and the
port's tensors.

The checker has no weights; what crosses between the two packages (and
between the engine's device buffers and its host archives) is data:
encoded state rows (a spec codec's ``encode`` dict, batch-major, bit
words as uint32), visited tables u32[W, VCAP] and key batches u32[W, M].
The port carries u32 as int32 bit patterns and state rows batch-last;
these functions convert both ways without changing a bit.  Which state
keys are u32 words is the spec's ``SpecIR.u32_keys`` (raft's ``bag``,
paxos's ``msgs``): a caller that knows its spec passes them, and the
default is every spec's.
"""

from __future__ import annotations

from typing import Collection, Dict, List, Sequence, Union

import numpy as np
import torch

from .spec import ALL_U32_KEYS

U32Words = Union[np.ndarray, Sequence[np.ndarray]]


def rows_to_torch(arrs: Dict[str, np.ndarray], device="cpu",
                  u32_keys: Collection[str] = ALL_U32_KEYS):
    """Encoded rows {key: [N, ...]} -> batch-last int32 tensors."""
    out = {}
    for k, v in arrs.items():
        a = np.moveaxis(np.asarray(v), 0, -1)
        a = a.astype(np.uint32).view(np.int32) if k in u32_keys \
            else a.astype(np.int32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def arrays_to_numpy(arrs: Dict[str, torch.Tensor],
                    u32_keys: Collection[str] = ALL_U32_KEYS
                    ) -> Dict[str, np.ndarray]:
    """State tensors in any layout -> numpy in the codec's dtypes (int32,
    the u32 word keys uint32).  Always a copy: on the CPU ``.numpy()``
    would alias the tensor's storage."""
    out = {}
    for k, v in arrs.items():
        a = v.to(torch.int32).cpu().numpy().copy()
        out[k] = a.view(np.uint32) if k in u32_keys else a
    return out


def rows_to_numpy(svT: Dict[str, torch.Tensor],
                  u32_keys: Collection[str] = ALL_U32_KEYS
                  ) -> Dict[str, np.ndarray]:
    """Batch-last tensors -> encoded rows {key: [N, ...]} in the codec's
    dtypes, a copy."""
    return arrays_to_numpy({k: v.movedim(-1, 0) for k, v in svT.items()},
                           u32_keys)


def storage_to_numpy(arrs: Dict[str, torch.Tensor],
                     u32_keys: Collection[str] = ALL_U32_KEYS
                     ) -> Dict[str, np.ndarray]:
    """State tensors in their storage dtypes -> numpy in the same dtypes
    (the u32 word keys as uint32: the JAX engine's archives and
    checkpoint leaves), C-contiguous and always a copy."""
    out = {}
    for k, v in arrs.items():
        a = v.to("cpu", copy=True,
                 memory_format=torch.contiguous_format).numpy()
        out[k] = a.view(np.uint32) if k in u32_keys else a
    return out


def storage_rows_to_numpy(svT: Dict[str, torch.Tensor],
                          u32_keys: Collection[str] = ALL_U32_KEYS
                          ) -> Dict[str, np.ndarray]:
    """Batch-last storage tensors -> batch-major rows in the storage
    dtypes (the archives' layout), a copy."""
    return storage_to_numpy({k: v.movedim(-1, 0) for k, v in svT.items()},
                            u32_keys)


def words_to_torch(words: U32Words, device="cpu") -> torch.Tensor:
    """A visited table or a key batch, u32 [W, n] (or a tuple of W
    u32 [n] arrays, the JAX engine's form) -> int32 [W, n] tensor."""
    a = words if isinstance(words, np.ndarray) else \
        np.stack([np.asarray(w) for w in words])
    a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 [W, n] tensor -> u32 [W, n] array (a copy)."""
    return t.cpu().numpy().view(np.uint32).copy()


def sim_carry_from_jax(carry: Dict, device="cpu") -> Dict:
    """A JAX ``SimEngine`` carry (leaves as numpy; keys u32 [W, 2]) ->
    the port's carry on ``device``: the same leaves as int32 tensors,
    the trajectory buffer with its spare row (-1) and the Bloom with its
    spare entry (False) appended."""
    def t(a, dtype=torch.int32):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a).copy()).to(
            device, dtype)

    traj = np.asarray(carry["traj"])
    out = {k: t(carry[k]) for k in ("depth", "key", "base_depth", "score",
                                    "hit_inv", "hit_depth", "stats")}
    out.update(
        sv={k: t(v) for k, v in carry["sv"].items()},
        base={k: t(v) for k, v in carry["base"].items()},
        traj=t(np.concatenate([traj, np.full((1,) + traj.shape[1:], -1,
                                             traj.dtype)])),
        hit=t(carry["hit"], torch.bool),
        bloom=t(np.append(np.asarray(carry["bloom"]), False), torch.bool))
    return out


# the sharded carry: the reference's ShardedEngine carry leaves, each
# with a leading [D] axis, against the port's one dict per shard
_SHARD_SCRATCH = ("claims", "cidx", "sscr")


def sharded_carry_from_jax(carry: Dict, devices) -> List[Dict]:
    """The reference's sharded carry (numpy leaves with a leading D
    axis, batch-major, u32 words as uint32: ``vis`` a tuple of W
    [D, VB], ``lpfp`` [D, LB, W], ``linv`` [D, LB, n_inv], ``lvl`` and
    ``front`` {key: [D, LB, ...]}) -> one dict per shard on its device
    in the port's layout: batch-last, u32 words as int32 bits, ``vis``
    [W, VB], ``lpfp`` [W, LB], ``linv`` [n_inv, LB].  The reference's
    scratch leaves (``claims``, ``cidx``, ``sscr``) are dropped."""
    def t(a, dev):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        # np.array, not ascontiguousarray, which makes a 0-d leaf 1-d
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    out = []
    for d, dev in enumerate(devices):
        sh = {}
        for k, v in carry.items():
            if k in _SHARD_SCRATCH:
                continue
            if k == "vis":
                sh[k] = t(np.stack([np.asarray(w)[d] for w in v]), dev)
            elif k in ("lvl", "front"):
                sh[k] = {f: t(np.moveaxis(np.asarray(a)[d], 0, -1), dev)
                         for f, a in v.items()}
            elif k in ("lpfp", "linv"):
                sh[k] = t(np.asarray(v)[d].T, dev)
            else:
                sh[k] = t(np.asarray(v)[d], dev)
        out.append(sh)
    return out


def sharded_carry_to_jax(shards: List[Dict], fc: int, sc: int,
                         u32_keys: Collection[str] = ALL_U32_KEYS) -> Dict:
    """The inverse of ``sharded_carry_from_jax``: per-shard dicts ->
    the reference's carry of numpy leaves (copies), the scratch leaves
    as the reference's fresh ones (``claims`` all ones [D, VB], ``cidx``
    [D, fc] and ``sscr`` [D, sc] zeros)."""
    def h(x, u32=False):
        a = x.to("cpu", copy=True).numpy()
        return a.view(np.uint32) if u32 else a

    D = len(shards)
    out = {}
    for k, v in shards[0].items():
        if k == "vis":
            out[k] = tuple(np.stack([h(s[k][w], True) for s in shards])
                           for w in range(v.shape[0]))
        elif k in ("lvl", "front"):
            out[k] = {f: np.stack([np.moveaxis(h(s[k][f], f in u32_keys),
                                               -1, 0) for s in shards])
                      for f in v}
        elif k in ("lpfp", "linv"):
            out[k] = np.stack([h(s[k], k == "lpfp").T for s in shards])
        else:
            out[k] = np.stack([h(s[k]) for s in shards])
    vb = shards[0]["vis"].shape[1]
    out["claims"] = np.full((D, vb), 0xFFFFFFFF, np.uint32)
    out["cidx"] = np.zeros((D, fc), np.int32)
    out["sscr"] = np.zeros((D, sc), np.int32)
    return out
