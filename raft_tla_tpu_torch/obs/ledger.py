"""JSONL run ledger: one record per dispatch, written incrementally (the
reference's ``raft_tla_tpu/obs/ledger.py``, same record format).

The ledger appends one JSON line per dispatch (a burst dispatch or a
per-level round trip) and flushes it at once, so a killed run leaves a
complete record up to its last dispatch: depth, frontier size, the
cumulative registry counters, throughput, host RSS and device memory
(``device_memory_stats``: the CUDA caching allocator's counters, where
the run has initialised CUDA).  ``tools/watch.py`` tails it for live
progress.
"""

from __future__ import annotations

import itertools
import json
import time
from typing import Dict, Optional

# monotonic per-process record sequence, shared by every RunLedger in
# the process, so records of interleaved runs (or one run appending
# after a resume) order deterministically even when two ledgers target
# the same file; readers pair it with the per-run ``run_id`` stamp
_SEQ = itertools.count(1)


def rss_bytes() -> int:
    """Current process resident set size (bytes); 0 if unknowable."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource
        import sys
        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss units are platform-defined: bytes on macOS,
        # KiB everywhere else that matters here
        return int(ru) * (1 if sys.platform == "darwin" else 1024)
    except Exception:
        return 0


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The CUDA caching allocator's gauges for ``device`` (default: the
    current CUDA device) under the reference's names: ``bytes_in_use``
    (``allocated_bytes.all.current``, graph pools included),
    ``peak_bytes_in_use`` (``allocated_bytes.all.peak``) and
    ``bytes_limit`` (the card's total memory).  None for a CPU device
    or a process that has not initialised CUDA: this never initialises
    CUDA and never synchronises a stream.  The CUDA driver's view of the
    card (other processes, the context, cuBLAS workspaces outside the
    allocator) is not in these numbers."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_initialized():
        return None
    dev = torch.device(device) if device is not None else \
        torch.device("cuda", torch.cuda.current_device())
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                dev).total_memory)}


class RunLedger:
    """Append-only JSONL writer; every record carries a wall-clock
    timestamp (for correlating with external logs) and a monotonic
    one (for durations)."""

    def __init__(self, path: str):
        self.path = path
        # run-constant keys applied to every record via setdefault
        # (Obs installs {"run_id": ...} here)
        self.stamp: Dict = {}
        # append, never truncate: a resumed run must extend the earlier
        # telemetry, which is exactly the record the ledger exists to
        # preserve
        self._fh = open(path, "a")
        self._t0 = time.perf_counter()

    def record(self, rec: Dict):
        rec = dict(rec)
        for k, v in self.stamp.items():
            rec.setdefault(k, v)
        rec.setdefault("seq", next(_SEQ))
        rec.setdefault("ts", round(time.time(), 3))
        rec.setdefault("t_mono", round(time.perf_counter() - self._t0, 6))
        self._fh.write(json.dumps(rec) + "\n")
        # flush per record: the OS has the line even if the process is
        # killed mid-run (the whole point of the ledger)
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
