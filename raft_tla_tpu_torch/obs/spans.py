"""Span/timeline recorder: nested named phases on monotonic clocks (the
reference's ``raft_tla_tpu/obs/spans.py``, same file format).

The classic engine brackets its phases — ``compile`` (a graph's
warm-up and capture, a first-use ``nvcc`` build), ``burst_dispatch``,
``level_dispatch``, ``harvest``, ``archive_io``, ``checkpoint`` — with
``SpanRecorder.span(name)``.  Spans time the host: a dispatch span
covers the enqueue of the device work, and the device time lands in
the span whose read waits for it (the level's ``_finalize`` read inside
``level_dispatch``, the burst's loop reads inside ``burst_dispatch``),
as the reference's spans behave around JAX's asynchronous dispatch.
Clocks are ``time.perf_counter()``, and completed spans are emitted as
Chrome-trace "complete" events (``"ph": "X"`` with ``ts``/``dur`` in
microseconds), so a ``--trace-timeline`` file loads in Perfetto or
chrome://tracing.  With ``annotate`` every span is also a
``torch.profiler.record_function`` range of the same name, so a
``--profile-dir`` device trace lines up with the host timeline by name.

The on-disk format is the catapult JSON *array* form, streamed: the
file is valid the moment each span closes (the trailing ``]`` is
optional per the trace-event spec and appended on a clean close), so a
killed run still leaves a loadable timeline up to its last dispatch.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple


class SpanRecorder:
    """Nested span timer + Chrome-trace-event emitter.

    path     — optional trace file, streamed incrementally (see module
               docstring); ``close()`` finishes the JSON array.
    annotate — mirror every span as a ``torch.profiler.record_function``
               range so a ``torch.profiler`` trace (``--profile-dir``)
               lines up with the host timeline by name.  A profiler
               error propagates: it fails the run.
    """

    def __init__(self, path: Optional[str] = None,
                 annotate: bool = False):
        self.path = path
        self.annotate = annotate
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._stack: List[Tuple[str, float]] = []
        self._totals: Dict[str, List[float]] = {}   # name -> [n, secs]
        self.events: List[dict] = []
        self._fh = None
        self._n_written = 0
        if path:
            self._fh = open(path, "w")
            self._fh.write("[")
            self._fh.flush()

    # -- recording -----------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str):
        ann = None
        if self.annotate:
            from torch.profiler import record_function
            ann = record_function(name)
            ann.__enter__()
        t0 = time.perf_counter()
        self._stack.append((name, t0))
        try:
            yield self
        finally:
            t1 = time.perf_counter()
            self._stack.pop()
            if ann is not None:
                ann.__exit__(None, None, None)
            self._emit(name, t0, t1)

    def _emit(self, name: str, t0: float, t1: float):
        tot = self._totals.setdefault(name, [0, 0.0])
        tot[0] += 1
        tot[1] += t1 - t0
        ev = {
            "name": name, "cat": "obs", "ph": "X",
            "ts": round((t0 - self._t0) * 1e6, 3),
            "dur": round((t1 - t0) * 1e6, 3),
            "pid": self._pid, "tid": 0,
        }
        if self._fh is None:
            # in-memory mode only: when streaming, the file is the
            # record (totals() reads _totals), so RAM stays bounded on
            # long runs
            self.events.append(ev)
        else:
            # never a trailing comma: a killed run's file stays
            # parseable (only the closing ] is missing, which the
            # trace-event spec makes optional)
            prefix = "\n" if self._n_written == 0 else ",\n"
            self._fh.write(prefix + json.dumps(ev))
            self._fh.flush()
            self._n_written += 1

    # -- reading back --------------------------------------------------

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name inclusive totals: ``{name: {count, seconds}}``."""
        return {nm: {"count": n, "seconds": round(s, 6)}
                for nm, (n, s) in sorted(self._totals.items())}

    # -- lifecycle -----------------------------------------------------

    def close(self):
        if self._fh is not None:
            self._fh.write("\n]\n")
            self._fh.close()
            self._fh = None
