"""The engine's per-chunk programs as captured CUDA graphs.

The port's counterpart of the reference's compiled step
(``raft_tla_tpu/engine/bfs.py`` ``_step_jit`` and ``_burst_jit``).
The chunk step and the burst body are written as fixed programs over
buffers that live as long as the level does: they read nothing back
and update every count and flag in place on the device.  On the CPU
such a program runs eagerly; on the card the first call for a shape
key runs it eagerly on a side stream (the warm-up: a real step, whose
work counts, and which allocates every lazily built constant), then
captures it into a ``torch.cuda.CUDAGraph``, and every later call for
the key is one graph replay.  A capture that fails raises: nothing
falls back to the eager program on the card.

A graph holds the addresses of the buffers it was captured with, so
the engine drops its graphs whenever it replaces one (a grown level
buffer, a rehashed table) or changes a capacity; the shape key names
the rest.  All graphs of one runner share one memory pool: they are
replayed one at a time on one stream, and what they compute lands in
the persistent buffers, never in a graph's own outputs.

Each warm-up and capture runs inside the run's ``compile`` span (the
reference warms its executables under one such span), entered and left
on the host around the capture, so nothing of the observability layer
is inside a captured program.

Launch counts stay true device launches: a wrapper that launches a
hand kernel while a capture is under way tallies it as captured
(``LaunchCounter.captured``), the runner keeps the tally per graph, and
each replay adds it to the count.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import torch

from ..obs import NULL_OBS
from .fingerprint import PROBE_CLAIM_LAUNCHES


class GraphRunner:
    """Runs a program per shape key: eagerly on the CPU, or as a
    captured graph's replay on a CUDA device (``capture`` False keeps
    the card eager, for the tests and timings that hold the graph
    against the program it captured).  ``obs`` is the run's
    observability bundle, whose ``span`` (``compile``; the serving
    layer's ``bucket_compile``) times each warm-up and capture."""

    def __init__(self, device: torch.device, capture: bool = True,
                 obs=None, span: str = "compile"):
        self.device = device
        self.obs = obs if obs is not None else NULL_OBS
        self.span = span
        self.capture = capture and device.type == "cuda"
        self._graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, int]] = {}
        self._pool = None
        self.replays = 0
        self.captures = 0

    def clear(self):
        """Drop every graph (their buffers are about to be replaced) and
        their pool: a pool whose graphs are all gone is released, and
        the allocator refuses to capture into it again."""
        self._graphs.clear()
        self._pool = None

    def program(self, key: Hashable):
        """The graph captured for ``key``, or None (nothing captured:
        the CPU, an eager card, or a key not seen yet)."""
        got = self._graphs.get(key)
        return None if got is None else got[0]

    def run(self, key: Hashable, fn: Callable[[], None]):
        if not self.capture:
            fn()
            return
        got = self._graphs.get(key)
        if got is None:
            self._warm_and_capture(key, fn)
            return
        graph, held = got
        graph.replay()
        self.replays += 1
        PROBE_CLAIM_LAUNCHES.count += held

    def _warm_and_capture(self, key: Hashable, fn: Callable[[], None]):
        with self.obs.span(self.span):
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                fn()
            cur.wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            before = PROBE_CLAIM_LAUNCHES.captured
            with torch.cuda.graph(graph, pool=self._pool):
                fn()
            self._graphs[key] = (graph,
                                 PROBE_CLAIM_LAUNCHES.captured - before)
            self.captures += 1
