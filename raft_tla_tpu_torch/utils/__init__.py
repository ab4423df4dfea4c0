"""Shared helpers: u32 arithmetic on int32-carried tensors, the probe
home hash, and the numpy/int twins the engine uses on the host.

Every u32 value of the checker (fingerprint streams, visited-table
words, packed message words) is carried in torch as the int32 value
with the same bit pattern: PyTorch's CPU build has no uint32 ``>>``,
``+``, ``<`` or ``scatter_reduce``.  Addition and multiplication wrap
alike in both types; the three operations that differ get helpers here:

- ``lsr``: logical right shift (int32 ``>>`` is arithmetic);
- ``ult``: unsigned less-than, by flipping the sign bit;
- ``i32``: a u32 Python constant as the int32 with its bit pattern.

Sums over int32 tensors must pass ``dtype=torch.int32``; torch widens
them to int64 otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# the probe-walk contract every visited-table image shares: home slot =
# fmix32-fold of the key words seeded with this salt
HOME_SALT = 0x9E3779B9


def i32(c: int) -> int:
    """A u32 constant as the Python int of the int32 with its bits."""
    c &= 0xFFFFFFFF
    return c - (1 << 32) if c >= (1 << 31) else c


_SIGN = i32(0x80000000)


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32-carried u32 values by static s."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b on int32-carried u32 values."""
    return (a ^ _SIGN) < (b ^ _SIGN)


_C1 = i32(0x85EBCA6B)
_C2 = i32(0xC2B2AE35)


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int32-carried u32 tensors (wrapping)."""
    x = x ^ lsr(x, 16)
    x = x * _C1
    x = x ^ lsr(x, 13)
    x = x * _C2
    x = x ^ lsr(x, 16)
    return x


def fmix32_int(x: int) -> int:
    """The same finalizer on a plain int (u32 in, u32 out)."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def fmix32_np(x: np.ndarray) -> np.ndarray:
    """The same finalizer over a numpy array (returns uint32)."""
    x = x.astype(np.uint32, copy=True)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def home_slots(keys: torch.Tensor, vcap: int) -> torch.Tensor:
    """Home slot of each key: keys int32 [W, M] -> int32 [M]."""
    h = torch.full(keys.shape[1:], i32(HOME_SALT), dtype=torch.int32,
                   device=keys.device)
    for w in range(keys.shape[0]):
        h = fmix32(h ^ keys[w])
    return h & (vcap - 1)


def take_arrays(arrs: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    """Row-select every array of an SoA dict."""
    return {k: v[idx] for k, v in arrs.items()}


def combine_u64(fp: np.ndarray) -> np.ndarray:
    """[N, n_streams] u32 -> [N, n_streams//2] u64 words: the canonical
    bit layout of the dedup key."""
    fp = np.asarray(fp, dtype=np.uint64)
    return (fp[:, 0::2] << np.uint64(32)) | fp[:, 1::2]


def fp_key(fp_u32: np.ndarray) -> np.ndarray:
    """[N, n_streams] u32 -> 1-D sortable dedup key over all streams."""
    u64 = combine_u64(fp_u32)
    if u64.shape[1] == 1:
        return u64[:, 0]
    dtype = np.dtype([(f"w{i}", "<u8") for i in range(u64.shape[1])])
    return np.ascontiguousarray(u64).view(dtype)[:, 0]


def resolve_device(device: Optional[str]) -> torch.device:
    """The entry points' device rule: CUDA unless the caller names the
    CPU.  With no CUDA and no explicit ``"cpu"`` this raises; it never
    falls back quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device "
            "cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
