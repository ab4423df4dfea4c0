"""Fingerprint-keyed result cache for the serving layer (the
reference's ``serve/cache.py``, whose file format it shares).

Keys are ``Job.cache_key()`` — (spec name, IR structure fingerprint,
config fingerprint, engine-options fingerprint) — so equal keys imply
an identical ``CheckResult``; a hit answers the job with zero device
dispatches.  Values are the per-job report payloads (serve/batch builds
them): JSON-able counters, level sizes and violation summaries with
their witness trace labels.

Storage is one JSON file per key under the cache directory, written
atomically (write-then-rename), plus a per-process dict so repeat jobs
inside one batch never touch the disk twice.  A corrupt or
foreign-keyed file reads as a miss, never an error: the cache is an
optimization, not a source of truth.

Eviction: optional LRU by bytes.  With ``max_bytes`` set, every ``put``
trims the directory back under the bound by deleting the
least-recently-used payload files first; recency is the file mtime,
which ``get`` refreshes on every hit, so a hot key outlives cold ones
whatever their insertion order.  The just-written payload is never
evicted (a single oversized payload may exceed the bound until the
next put retires it).  ``max_bytes=None`` (the default) never evicts.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


class ResultCache:
    def __init__(self, path: str, max_bytes: Optional[int] = None):
        if max_bytes is not None and int(max_bytes) <= 0:
            raise ValueError(
                f"cache max_bytes must be positive (got {max_bytes}); "
                "omit it for an unbounded cache")
        self.path = path
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        os.makedirs(path, exist_ok=True)
        self._mem: Dict[str, Dict] = {}

    def _file(self, key: str) -> str:
        return os.path.join(self.path, key + ".json")

    def _touch(self, key: str):
        """LRU recency refresh (file mtime) on a hit — including
        in-process dict hits, since the dict dies with the batch but
        the eviction order must not.  Unbounded caches skip it:
        reads stay write-free there."""
        if self.max_bytes is None:
            return
        try:
            os.utime(self._file(key))
        except OSError:
            pass

    def get(self, key: str) -> Optional[Dict]:
        hit = self._mem.get(key)
        if hit is not None:
            self._touch(key)
            return dict(hit)
        try:
            with open(self._file(key)) as fh:
                obj = json.load(fh)
        except (OSError, ValueError):
            return None
        if not isinstance(obj, dict) or obj.get("cache_key") != key:
            return None          # foreign/corrupt payload: a miss
        self._touch(key)
        self._mem[key] = obj
        return dict(obj)

    def put(self, key: str, payload: Dict):
        payload = dict(payload)
        payload["cache_key"] = key
        self._mem[key] = payload
        tmp = self._file(key) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, self._file(key))
        self._evict(keep=key)

    def _evict(self, keep: str):
        """Trim the directory back under max_bytes, least-recently-used
        first, never touching the just-written ``keep`` payload.  A
        racing deletion reads as already-evicted, never an error."""
        if self.max_bytes is None:
            return
        entries = []
        total = 0
        for nm in os.listdir(self.path):
            if not nm.endswith(".json"):
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
        for mtime, size, nm in sorted(entries):
            if nm == keep + ".json":
                continue
            try:
                os.remove(os.path.join(self.path, nm))
            except OSError:
                continue
            self._mem.pop(nm[:-len(".json")], None)
            total -= size
            if total <= self.max_bytes:
                break

    def __len__(self) -> int:
        return sum(1 for nm in os.listdir(self.path)
                   if nm.endswith(".json"))
