"""Heartbeat file: atomically rewritten every dispatch (the reference's
``raft_tla_tpu/obs/heartbeat.py``, same file format).

A watchdog tailing a long run cannot otherwise tell "depth 20 is just a
big level" from "the process died an hour ago".  The engine rewrites a
small JSON (pid, depth, last-dispatch wall timestamp, states enqueued)
via write-then-rename on every dispatch, so an external process
(``tools/watch.py``, or any cron) can compare ``last_dispatch_ts``
against the clock and the pid against the process table without
touching the run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class Heartbeat:
    def __init__(self, path: str):
        self.path = path
        self._pid = os.getpid()
        self._started = time.time()
        self._beats = 0
        # the owning run's id (Obs sets it): cross-links the heartbeat
        # to the ledger rows and registry record of the same run
        self.run_id: Optional[str] = None
        # last-known progress, so a terminal "failed" beat (which has
        # no fresher numbers) can still stamp the file
        self.last_depth = 0
        self.last_states = 0

    def beat(self, depth: int, states: int, status: str = "running",
             extra: Optional[Dict] = None):
        self._beats += 1
        self.last_depth = int(depth)
        self.last_states = int(states)
        obj = {
            "pid": self._pid,
            "status": status,
            "depth": int(depth),
            "states_enqueued": int(states),
            "last_dispatch_ts": round(time.time(), 3),
            "started_ts": round(self._started, 3),
            "beats": self._beats,
        }
        if self.run_id is not None:
            obj["run_id"] = self.run_id
        if extra:
            obj.update(extra)
        # write-then-rename: a reader never sees a torn file, and a
        # run killed mid-beat leaves the previous complete heartbeat
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(obj, fh)
        os.replace(tmp, self.path)


def read_heartbeat(path: str) -> Dict:
    """Load and sanity-check a heartbeat file."""
    with open(path) as fh:
        obj = json.load(fh)
    for key in ("pid", "depth", "last_dispatch_ts", "states_enqueued"):
        if key not in obj:
            raise ValueError(f"{path}: not a heartbeat file "
                             f"(missing {key!r})")
    return obj
