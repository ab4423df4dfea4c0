"""The persistent bucket-program cache (the reference's
``serve/exec_cache.py``), on a backend that cannot serialize.

The reference compiles one executable per (bucket, padded job count JP)
and serializes it to disk, so that a restarted service skips the
compile.  This module keeps its container, its keys and its accounting
unchanged, so an entry written by either package is read by the other
as a named miss, never as a hit:

- **key** — sha256 of the canonical JSON of every part that shapes the
  program: the backend, the package's code, the spec and its IR, the
  bucket's ceiling config and parameters, JP, the engine's modes and
  the wave-mesh shape (``BucketEngine._exec_key_parts``).  Any drift in
  any part is another key: a miss, never a wrong load.
- **entries** — one ``<key>.exec`` file per program: a pickled
  container holding the full key and its parts beside the serializer's
  blob, published by write and rename.  A corrupt or truncated file, a
  foreign (renamed) entry, an embedded key mismatch or another
  serializer's entry all read as named misses.
- **honesty** — the port's program for a (bucket, JP) is a captured CUDA
  graph (``engine/graph.py``), and a CUDA graph holds the addresses of
  one process's device buffers: there is nothing to write to disk.  So
  ``TorchGraphSerializer`` raises on both sides, every ``store`` is a
  counted "backend cannot serialize executables (...)" failure, no
  entry file is ever written, and every later ``load`` is "cold: no
  entry for this key".  A restart recaptures its graphs; the counters
  say so, and no hit is ever reported.  This is the reference's own
  documented behaviour on a backend that cannot serialize.

The serializer stays injectable (``serializer=``) so the tests pin the
keying, the round trip and the corrupt-entry paths with a fake one.
``BucketEngine`` itself takes only the port's serializer.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from typing import Dict, Optional, Tuple

# re-exported: the cache key's backend part is the obs layer's identity
from ..obs.resources import backend_fingerprint  # noqa: F401

__all__ = ["ExecCache", "TorchGraphSerializer", "backend_fingerprint",
           "code_fingerprint", "exec_key", "port_exec_cache"]

_FORMAT = 1

# what the program's source identity hashes: the Python modules and the
# hand kernel's CUDA sources (the build directory is an output)
_CODE_SUFFIXES = (".py", ".cu")
_CODE_SKIP_DIRS = ("__pycache__", "_build")

_CODE_FP: Optional[str] = None


def code_fingerprint(root: Optional[str] = None) -> str:
    """sha256 over every source file of the package (path-sorted): its
    ``*.py`` modules and its ``csrc/*.cu`` kernel sources, whose code is
    part of the captured program here.  Without it a warm cache could
    answer with an older checkout's program.  ``root`` hashes another
    copy of the package; the default, this package, is computed once
    per process."""
    global _CODE_FP
    if root is None and _CODE_FP is not None:
        return _CODE_FP
    top = root if root is not None else \
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(top)):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in _CODE_SKIP_DIRS)
        for nm in sorted(filenames):
            if not nm.endswith(_CODE_SUFFIXES):
                continue
            rel = os.path.relpath(os.path.join(dirpath, nm), top)
            h.update(rel.encode())
            with open(os.path.join(dirpath, nm), "rb") as fh:
                h.update(fh.read())
    digest = h.hexdigest()[:16]
    if root is None:
        _CODE_FP = digest
    return digest


def exec_key(parts: Dict) -> str:
    """Canonical-JSON sha256 of the key parts (order-independent)."""
    desc = json.dumps(parts, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(desc.encode()).hexdigest()[:32]


class TorchGraphSerializer:
    """The port's serializer.  A bucket's program is a captured CUDA
    graph (on the CPU: the eager body, with nothing captured), bound to
    the device buffers of the process that captured it; neither can be
    written to disk or revived in another process.  Both sides raise,
    naming why, and ``ExecCache`` turns that into a counted, named
    store failure or miss."""

    name = "torch.cuda.CUDAGraph"

    _WHY = ("a captured CUDA graph is bound to one process's device "
            "buffers and cannot be written to disk")

    def serialize(self, program) -> bytes:
        raise RuntimeError(self._WHY)

    def deserialize(self, blob: bytes):
        raise RuntimeError(self._WHY)


def port_exec_cache(exec_cache) -> Optional["ExecCache"]:
    """A bucket engine's executable cache: None, a directory (an
    ``ExecCache`` with the port's serializer) or an ``ExecCache`` whose
    serializer is the port's.  Any other serializer is refused
    (ValueError): a program it revived would be bound to another
    engine's buffers."""
    if exec_cache is None:
        return None
    if isinstance(exec_cache, str):
        return ExecCache(exec_cache)
    ser = getattr(exec_cache, "_ser", None)
    if type(ser) is not TorchGraphSerializer:
        raise ValueError(
            f"a bucket engine takes an ExecCache with the port's "
            f"serializer ({TorchGraphSerializer.name!r}) only, got "
            f"{getattr(ser, 'name', type(ser).__name__)!r}")
    return exec_cache


class ExecCache:
    """One directory of serialized bucket programs and honest hit/miss
    accounting.  ``load``/``store`` never raise on entry or backend
    problems: every failure is a counted, named miss."""

    def __init__(self, path: str, serializer=None,
                 max_bytes: Optional[int] = None):
        if max_bytes is not None and int(max_bytes) <= 0:
            raise ValueError(
                f"executable-cache max_bytes must be positive (got "
                f"{max_bytes}); omit it for an unbounded cache")
        self.path = path
        # LRU-by-bytes bound: recency is the file's mtime, refreshed on
        # a warm load; the entry just stored is never the victim.  None
        # is unbounded.
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        os.makedirs(path, exist_ok=True)
        self._ser = serializer if serializer is not None \
            else TorchGraphSerializer()
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.store_failures = 0
        self.evictions = 0
        # the most recent miss and store-failure reasons, newest last
        # (bounded: telemetry, not a log)
        self.miss_reasons = []
        self.store_fail_reasons = []

    # -- accounting ----------------------------------------------------

    def _miss(self, reason: str) -> Tuple[None, str]:
        self.misses += 1
        self.miss_reasons = (self.miss_reasons + [reason])[-8:]
        return None, reason

    def stats(self) -> Dict:
        return {
            "exec_cache_hits": self.hits,
            "exec_cache_misses": self.misses,
            "exec_cache_stores": self.stores,
            "exec_cache_store_failures": self.store_failures,
            "exec_cache_evictions": self.evictions,
            "exec_cache_miss_reasons": list(self.miss_reasons),
            "exec_cache_store_fail_reasons":
                list(self.store_fail_reasons),
        }

    def _touch(self, key: str):
        """LRU recency refresh on a warm load (bounded caches only:
        unbounded reads write nothing)."""
        if self.max_bytes is None:
            return
        try:
            os.utime(self._entry_path(key))
        except OSError:
            pass

    def _evict(self, keep: str):
        """Trim the directory back under max_bytes, oldest mtime first,
        never touching the just-written ``keep`` entry.  A racing
        deletion reads as already evicted."""
        if self.max_bytes is None:
            return
        entries = []
        total = 0
        for nm in os.listdir(self.path):
            if not nm.endswith(".exec"):
                continue
            fp = os.path.join(self.path, nm)
            try:
                st = os.stat(fp)
            except OSError:
                continue
            total += st.st_size
            entries.append((st.st_mtime, st.st_size, nm))
        if total <= self.max_bytes:
            return
        for _mtime, size, nm in sorted(entries):
            if nm == keep + ".exec":
                continue
            try:
                os.remove(os.path.join(self.path, nm))
            except OSError:
                continue
            self.evictions += 1
            total -= size
            if total <= self.max_bytes:
                break

    def _entry_path(self, key: str) -> str:
        return os.path.join(self.path, key + ".exec")

    # -- the two operations BucketEngine wraps around a capture --------

    def load(self, key: str, parts: Optional[Dict] = None):
        """(program | None, reason).  Every None is a named miss: no
        entry, a corrupt or truncated pickle, a foreign entry (embedded
        key or parts mismatch), another serializer's entry, or a backend
        that cannot deserialize."""
        fp = self._entry_path(key)
        if not os.path.exists(fp):
            return self._miss("cold: no entry for this key")
        try:
            with open(fp, "rb") as fh:
                obj = pickle.load(fh)
        except Exception as e:
            return self._miss(
                f"corrupt entry (unreadable: {type(e).__name__})")
        if not isinstance(obj, dict) or obj.get("format") != _FORMAT:
            return self._miss("corrupt entry (bad container format)")
        if obj.get("key") != key:
            return self._miss(
                "foreign entry (embedded key mismatch — file renamed "
                "or copied across caches)")
        if parts is not None and obj.get("parts") != dict(parts):
            # the full part set must match, not just its digest
            return self._miss(
                "foreign entry (embedded key parts mismatch)")
        ser_name = getattr(self._ser, "name", type(self._ser).__name__)
        if obj.get("serializer") != ser_name:
            return self._miss(
                f"serializer mismatch (entry: {obj.get('serializer')!r},"
                f" runtime: {ser_name!r})")
        try:
            ex = self._ser.deserialize(obj["blob"])
        except Exception as e:
            return self._miss(
                f"backend cannot deserialize executables "
                f"({type(e).__name__}: {str(e)[:120]})")
        self.hits += 1
        self._touch(key)
        return ex, "hit"

    def store(self, key: str, program, parts: Optional[Dict] = None
              ) -> bool:
        """Serialize and publish one program; False, with a recorded
        named reason, when the backend cannot serialize — the capture
        that just happened still serves the run, the cache stays
        cold."""
        try:
            blob = self._ser.serialize(program)
        except Exception as e:
            self.store_failures += 1
            self.store_fail_reasons = (self.store_fail_reasons + [
                f"backend cannot serialize executables "
                f"({type(e).__name__}: {str(e)[:120]})"])[-8:]
            return False
        obj = {"format": _FORMAT, "key": key,
               "parts": dict(parts or {}),
               "serializer": getattr(self._ser, "name",
                                     type(self._ser).__name__),
               "blob": blob}
        fp = self._entry_path(key)
        tmp = fp + ".tmp"
        try:
            with open(tmp, "wb") as fh:
                pickle.dump(obj, fh)
            os.replace(tmp, fp)
        except OSError as e:
            self.store_failures += 1
            self.store_fail_reasons = (self.store_fail_reasons + [
                f"cache dir unwritable ({e})"])[-8:]
            return False
        self.stores += 1
        self._evict(keep=key)
        return True
