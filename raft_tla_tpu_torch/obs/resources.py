"""Resource telemetry: backend identity + a low-overhead sampler (the
reference's ``raft_tla_tpu/obs/resources.py``).

- ``backend_fingerprint(device)`` — the identity of the device a run
  uses: the reference's keys ``platform`` (``"gpu"`` or ``"cpu"``),
  ``device_kind`` (``torch.cuda.get_device_name``) and ``n_devices``,
  then ``torch`` (in place of the reference's ``jax``) and ``cuda``
  (``torch.version.cuda``).  The obs layer stamps it on every ledger
  meta row and registry record.

- ``ResourceSampler`` — sampled at every level and burst dispatch by
  ``Obs.dispatch``: host RSS (and its running peak), the CUDA
  allocator's device memory (``ledger.device_memory_stats``) and the
  compile wall-clock read from the span recorder's ``compile`` totals.
  Samples surface as the ``resources`` field of every heartbeat, as
  throttled ``kind="resource"`` ledger rows (the first dispatch at
  once, then at most one per ``interval_s``) and as the ``resources``
  rollup of the run's registry record.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from .ledger import device_memory_stats, rss_bytes

__all__ = ["backend_fingerprint", "ResourceSampler"]


def run_device(device) -> "torch.device":
    """The run's device; with none given, the process's default backend
    (CUDA where it is available), as the reference's default JAX
    backend is to a run that names none."""
    import torch
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def backend_fingerprint(device=None) -> Dict[str, str]:
    """The identity of the run's device: platform, device kind, device
    count, torch and CUDA versions."""
    import torch
    dev = run_device(device)
    if dev.type == "cuda":
        return {
            "platform": "gpu",
            "device_kind": str(torch.cuda.get_device_name(dev)),
            "n_devices": str(torch.cuda.device_count()),
            "torch": torch.__version__,
            "cuda": str(torch.version.cuda),
        }
    return {"platform": "cpu", "device_kind": "cpu", "n_devices": "1",
            "torch": torch.__version__, "cuda": str(torch.version.cuda)}


# span names whose totals count as compile wall-clock (the reference's
# serving layer adds "bucket_compile")
_COMPILE_SPANS = ("compile", "bucket_compile")


class ResourceSampler:
    """Peak-tracking sampler, driven by ``Obs.dispatch``.

    spans      — optional SpanRecorder; its compile-span totals become
                 the ``compile_seconds``/``compile_count`` fields.
    interval_s — minimum spacing of ``kind="resource"`` ledger rows
                 (``due()``); heartbeats carry every sample regardless.
    device     — the run's device, for ``device_memory_stats``.
    """

    def __init__(self, spans=None, interval_s: float = 30.0,
                 device=None):
        self.spans = spans
        self.interval_s = float(interval_s)
        self.device = device
        self._last_emit: Optional[float] = None
        self._n_samples = 0
        self._rss_peak = 0
        self._dev_peak_in_use = 0
        self._dev_peak = 0          # the allocator's peak_bytes_in_use

    def sample(self) -> Dict:
        """One sample: current RSS + running peak, device memory where
        the run uses CUDA, compile totals so far.  Cheap enough for
        every dispatch (one /proc read, one allocator-stats call)."""
        self._n_samples += 1
        rss = rss_bytes()
        self._rss_peak = max(self._rss_peak, rss)
        snap = {"rss_bytes": rss, "rss_peak_bytes": self._rss_peak}
        dev = device_memory_stats(self.device)
        if dev:
            self._dev_peak_in_use = max(self._dev_peak_in_use,
                                        int(dev.get("bytes_in_use", 0)))
            self._dev_peak = max(self._dev_peak,
                                 int(dev.get("peak_bytes_in_use", 0)))
            snap["device_memory"] = dev
        snap.update(self._compile_totals())
        return snap

    def _compile_totals(self) -> Dict:
        secs, count = 0.0, 0
        if self.spans is not None:
            tot = self.spans.totals()
            for nm in _COMPILE_SPANS:
                if nm in tot:
                    secs += float(tot[nm]["seconds"])
                    count += int(tot[nm]["count"])
        return {"compile_seconds": round(secs, 3),
                "compile_count": count}

    def due(self) -> bool:
        """Throttle for ledger rows: True on the first call and then
        at most once per ``interval_s``."""
        now = time.perf_counter()
        if self._last_emit is not None and \
                now - self._last_emit < self.interval_s:
            return False
        self._last_emit = now
        return True

    def rollup(self) -> Dict:
        """The registry record's resources summary: sample count,
        peaks, compile totals."""
        out = {"samples": self._n_samples,
               "rss_peak_bytes": self._rss_peak}
        out.update(self._compile_totals())
        if self._dev_peak_in_use or self._dev_peak:
            out["device_peak_bytes_in_use"] = max(
                self._dev_peak, self._dev_peak_in_use)
        return out
