"""Persistent run registry: one atomic JSON record per invocation (the
reference's ``raft_tla_tpu/obs/registry.py``, same record format).

With ``--registry DIR``, every ``check`` invocation appends one
schema-versioned record under DIR:

- **naming** — ``<run_id>.json`` where ``run_id`` =
  ``r<YYYYmmdd-HHMMSS>-<pid>-<6 hex>`` (``new_run_id``): lexically about
  chronological, collision-free across interleaved processes, and the
  same id is stamped into every ledger row and heartbeat of the run;
  the record's ``artifacts`` paths cross-link them.
- **atomicity** — write-tmp-then-``os.replace``: a reader never sees a
  torn record, and a crash mid-write leaves no ``<run_id>.json`` at all
  (the ledger still has the run).
- **tolerance** — ``records()`` skips corrupt or foreign files with one
  stderr warning each instead of failing the whole listing.

The reference's ``obs/report.py`` and ``cli obs`` subcommands read
these records as they read their own.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["SCHEMA", "RunRegistry", "new_run_id"]

# bump on any backwards-incompatible record change; readers keep
# accepting older schemas (the fields they read are append-only)
SCHEMA = 1


def new_run_id() -> str:
    """``r20260806-141530-3406-a1b2c3``: sortable timestamp prefix +
    pid + random suffix (collision-free when two runs start the same
    second in the same process tree)."""
    return (f"r{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}-"
            f"{os.urandom(3).hex()}")


class RunRegistry:
    """Directory of one atomic ``<run_id>.json`` record per run."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path_for(self, run_id: str) -> str:
        return os.path.join(self.root, run_id + ".json")

    def append(self, rec: Dict) -> str:
        """Publish one run record atomically; returns its path.
        ``rec`` must carry ``run_id``; ``schema`` is stamped here."""
        rec = dict(rec)
        run_id = rec.get("run_id")
        if not run_id:
            raise ValueError("registry record lacks run_id")
        rec.setdefault("schema", SCHEMA)
        path = self.path_for(run_id)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(rec, fh, default=str)
        os.replace(tmp, path)
        return path

    def run_ids(self) -> List[str]:
        """All recorded run ids, sorted (≈ chronological)."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(nm[:-5] for nm in names
                      if nm.endswith(".json") and nm.startswith("r"))

    def load(self, run_id: str) -> Dict:
        with open(self.path_for(run_id)) as fh:
            return json.load(fh)

    def records(self) -> Iterator[Tuple[str, Dict]]:
        """Yield ``(run_id, record)`` for every parseable record;
        corrupt files are skipped with one named stderr warning each
        (never fail the whole listing over one bad writer)."""
        for run_id in self.run_ids():
            try:
                rec = self.load(run_id)
            except (OSError, ValueError) as e:
                print(f"registry: skipping corrupt record "
                      f"{self.path_for(run_id)}: {e}", file=sys.stderr)
                continue
            if not isinstance(rec, dict):
                print(f"registry: skipping corrupt record "
                      f"{self.path_for(run_id)}: not a JSON object",
                      file=sys.stderr)
                continue
            yield run_id, rec

    def resolve(self, token: str) -> Optional[str]:
        """Run token -> run id: ``last`` (newest record), an exact id,
        or a unique id prefix; None when nothing (or more than one
        thing) matches."""
        ids = self.run_ids()
        if not ids:
            return None
        if token == "last":
            return ids[-1]
        if token in ids:
            return token
        hits = [rid for rid in ids if rid.startswith(token)]
        return hits[0] if len(hits) == 1 else None
