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

from typing import Collection, Dict, Sequence, Union

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
