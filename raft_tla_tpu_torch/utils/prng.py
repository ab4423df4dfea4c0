"""The walkers' random streams: ``jax.random``'s threefry2x32 PRNG, in
torch.

The random-walk engine (``sim/walker.py``) keys walker w by
``fold_in(PRNGKey(seed), w)`` and, per sampling round, splits its key
and draws ``randint(sub, (), 0, n)``.  The walks equal the reference's
only if these draws equal ``jax.random``'s bit for bit, so this module
is the port's own copy of the algorithms of JAX 0.9.0, which runs with
``jax_threefry_partitionable`` on:

- ``threefry2x32``: the Threefry-2x32 block cipher, 20 rounds;
- ``PRNGKey(seed)``: the key ``(0, seed)`` for an int32 seed;
- ``fold_in(key, d)``: threefry of the count vector ``(0, d)`` — an
  even-length vector hashes its first half against its second half;
- ``split(key)``: the fold-like split, key i = threefry(key, (0, i));
- ``random_bits(key)``: 32 bits as ``bits1 ^ bits2`` of threefry(key,
  (0, 0));
- ``randint(key, n)``: ``jax.random.randint(key, (), 0, n)`` — two
  halves of a split give the high and low words, reduced modulo the
  span with every product and sum wrapping at 32 bits, as uint32
  arithmetic does.

Keys are int32 tensors [..., 2] carrying u32 bit patterns (the port's
uint32 rule, ``utils``); every function is elementwise over the
leading axes, so a fleet of keys [W, 2] draws in one call.
"""

from __future__ import annotations

import torch

from . import i32, lsr

I32 = torch.int32
_PARITY = i32(0x1BD11BDA)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | lsr(x, 32 - r)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """Threefry-2x32 of the count pair (x1, x2) under the key (k1, k2);
    all int32-carried u32, broadcast together.  Returns (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = x1 + ks[0]
    x2 = x2 + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = x1 + x2
            x2 = _rotl(x2, r) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + (i + 1)
    return x1, x2


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: int32 [2].  The
    reference runs without x64, so the seed is an int32 and its high
    word (a logical shift by 32) is 0."""
    if not -(1 << 31) <= int(seed) < (1 << 31):
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, int(seed)], dtype=I32, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in(key, d)`` for int32 data [N] (key [2] or
    [N, 2]): threefry of the seed words (0, d).  Returns [N, 2]."""
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data.to(I32))
    return torch.stack([y1, y2], -1)


def split(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.split(key)`` per key: [..., 2] -> [..., 2, 2]."""
    cnt = torch.arange(2, dtype=I32, device=key.device)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, cnt)
    return torch.stack([y1, y2], -1)


def random_bits(key: torch.Tensor) -> torch.Tensor:
    """32 random bits per key, ``jax.random.bits(key, (), uint32)``:
    int32-carried [...]."""
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], 0, 0)
    return y1 ^ y2


def randint(key: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``jax.random.randint(key, (), 0, n)`` per key: keys [..., 2],
    int32 n [...] -> int32 [...] in [0, max(n, 1))."""
    k = split(key)
    bits = random_bits(k)                  # [..., 2]: higher, lower
    mask = 0xFFFFFFFF
    hi = bits[..., 0].long() & mask
    lo = bits[..., 1].long() & mask
    # maxval <= minval takes span 1, so minval is returned
    span = torch.where(n > 0, n.long(), 1)
    mult = (1 << 16) % span
    mult = ((mult * mult) & mask) % span
    off = (((hi % span) * mult) & mask) + lo % span
    return ((off & mask) % span).to(I32)
