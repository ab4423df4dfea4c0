"""Checksummed last-K checkpoint chains with atomic publish (the
reference's ``raft_tla_tpu/resil/ckpt_chain.py``; files and sidecars
are the same in both packages).

A checkpoint that dies with the process is worse than none, and a crash
DURING a checkpoint write can leave a torn head that would resume as an
unpickling traceback.  This module hardens the engine's serializer
(``engine/ckpt.py`` ``ckpt_write``/``ckpt_read``) with three
properties:

- **integrity**: every published checkpoint gets a sidecar
  ``<path>.sum`` recording its byte length and sha256; readers verify
  the digest BEFORE any array is touched, so truncation/corruption is
  a clear named condition, never a deep numpy/zipfile traceback;
- **last-K chain**: ``keep > 1`` rotates the previous head to
  ``<path>.1`` (and ``.1`` to ``.2``, ...) before publishing, so the
  most recent K checkpoints coexist;
- **fall back, don't crash**: a reader finding a torn/corrupt head
  emits a named ``ChainWarning`` and falls back to the newest valid
  predecessor in the chain — the run resumes a few levels earlier
  instead of dying.

Publish order is: rotate → ``os.replace(tmp, path)`` → write sidecar.
Every step is atomic, and a crash between any two of them leaves a
state the reader handles (an old-but-valid head, or a head whose
sidecar mismatch routes the resume to ``.1``).

This module deliberately knows nothing about the checkpoint payload —
the engines' serializer calls ``publish``; reads go through
``open_validated`` (used by ``ckpt_read`` and the portable-resume
loader).  ``IntegrityError`` is raised for an exhausted chain; callers
translate it to their own error type (``CheckpointError``).
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import List, Optional, Tuple

from .chaos import chaos_fire


class ChainWarning(UserWarning):
    """A checkpoint-chain member failed integrity and was skipped in
    favor of an older valid one."""


class IntegrityError(ValueError):
    """No member of the checkpoint chain passed integrity/readability
    validation."""


def _sidecar(path: str) -> str:
    return path + ".sum"


def chain_name(path: str, i: int) -> str:
    return path if i == 0 else f"{path}.{i}"


def chain_candidates(path: str) -> List[str]:
    """Existing chain members, newest first: path, path.1, path.2, ..."""
    out = []
    i = 0
    while True:
        cand = chain_name(path, i)
        if os.path.exists(cand):
            out.append(cand)
        elif i > 0:
            break
        i += 1
    return out


def _digest(path: str) -> Tuple[str, int]:
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as fh:
        while True:
            blk = fh.read(1 << 20)
            if not blk:
                break
            h.update(blk)
            n += len(blk)
    return h.hexdigest(), n


def write_sidecar(path: str):
    digest, n = _digest(path)
    tmp = _sidecar(path) + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"sha256": digest, "bytes": n}, fh)
    os.replace(tmp, _sidecar(path))


def verify(path: str) -> Tuple[Optional[bool], str]:
    """(verdict, why): True = digest matches; False = torn/corrupt
    (size or sha256 mismatch, or unreadable); None = no sidecar (a
    pre-round-12 checkpoint — caller falls back to structural
    validation)."""
    try:
        with open(_sidecar(path)) as fh:
            rec = json.load(fh)
        want_sha, want_n = rec["sha256"], int(rec["bytes"])
    except (OSError, ValueError, KeyError):
        return None, "no checksum sidecar (pre-round-12 checkpoint)"
    try:
        size = os.path.getsize(path)
    except OSError as e:
        return False, f"unreadable ({e})"
    if size != want_n:
        return False, (f"torn write: {size} bytes on disk, sidecar "
                       f"records {want_n}")
    got_sha, _ = _digest(path)
    if got_sha != want_sha:
        return False, "sha256 mismatch (corrupt bytes)"
    return True, "ok"


def _move(src: str, dst: str):
    try:
        os.replace(src, dst)
    except OSError:
        pass
    try:
        os.replace(_sidecar(src), _sidecar(dst))
    except OSError:
        # a member without its sidecar stays readable via the
        # structural path; never fail a publish over sidecar shuffling
        try:
            os.remove(_sidecar(dst))
        except OSError:
            pass


def publish(tmp: str, path: str, keep: int = 1):
    """Atomically publish ``tmp`` as the chain head, rotating the
    previous ``keep - 1`` heads down the chain first.  Applies the
    ``ckpt_torn``/``ckpt_corrupt`` chaos sites to the just-published
    head (never to the rotated predecessors — recovery must have
    something valid to fall back to)."""
    keep = max(1, int(keep))
    for i in range(keep - 2, -1, -1):
        src = chain_name(path, i)
        if os.path.exists(src):
            _move(src, chain_name(path, i + 1))
    os.replace(tmp, path)
    write_sidecar(path)
    if chaos_fire("ckpt_torn"):
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(max(1, size // 2))
    if chaos_fire("ckpt_corrupt"):
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.seek(size // 2)
            blk = fh.read(64)
            fh.seek(size // 2)
            fh.write(bytes(b ^ 0xFF for b in blk))


def load_engine_npz(path: str):
    """The shared structural loader for engine checkpoint files: np
    container readable, a ``meta`` record present and JSON-parseable.
    Raises on anything malformed — the shape ``open_validated``'s
    ``np_load`` hook expects.  ONE definition (ckpt_read and the
    portable-image loader both resume through it), so a future format
    tightening cannot skip one resume path."""
    import json

    import numpy as np
    z = np.load(path, allow_pickle=False)
    if "meta" not in z:
        raise ValueError("not an engine checkpoint (no meta record)")
    json.loads(str(z["meta"]))
    return z


def open_validated(path: str, np_load):
    """Walk the chain from ``path``, returning ``(z, used_path)`` for
    the newest member that passes integrity + structural load
    (``np_load`` is called with the candidate path and must raise on a
    malformed file).  Members that fail are skipped with a named
    ``ChainWarning``; an exhausted chain raises ``IntegrityError``
    naming the last failure."""
    cands = chain_candidates(path)
    if not cands:
        raise IntegrityError(f"{path}: no such checkpoint")
    last_why = "no candidates"
    for k, cand in enumerate(cands):
        ok, why = verify(cand)
        if ok is False:
            last_why = why
            warnings.warn(
                f"{cand}: checkpoint failed integrity validation "
                f"({why}) — falling back to the previous checkpoint "
                f"in the chain", ChainWarning, stacklevel=3)
            continue
        try:
            z = np_load(cand)
        except Exception as e:       # zipfile/OSError/ValueError zoo:
            # integrity said ok/unknown but the container is still
            # unreadable (legacy file without a sidecar) — same
            # fallback discipline
            last_why = f"unreadable checkpoint container ({e})"
            if k + 1 < len(cands):
                warnings.warn(
                    f"{cand}: {last_why} — falling back to the "
                    f"previous checkpoint in the chain", ChainWarning,
                    stacklevel=3)
                continue
            break
        return z, cand
    raise IntegrityError(
        f"{path}: no valid checkpoint in the chain ({last_why}) — "
        "re-run without --resume")


def latest_valid(path: str) -> Optional[str]:
    """The newest chain member passing integrity validation (sidecar
    digest, or mere existence for legacy members), or None.  Used by
    the supervised runner to decide whether a retry can resume."""
    for cand in chain_candidates(path):
        ok, _why = verify(cand)
        if ok is not False:
            return cand
    return None
