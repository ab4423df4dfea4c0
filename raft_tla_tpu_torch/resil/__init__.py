"""Fault tolerance (the reference's ``raft_tla_tpu/resil``):
deterministic chaos injection, checksummed last-K checkpoint chains and
the supervised retry/backoff runner.

- ``chaos`` — a seeded, deterministic fault schedule (``--chaos``)
  that injects failures at named engine sites (dispatch, checkpoint
  publish, archive writes) so every recovery path is testable on the
  CPU.
- ``ckpt_chain`` — sha256-sidecar integrity for every checkpoint plus
  last-K rotation with atomic publish; a torn or corrupt head reads as
  "fall back to the previous valid checkpoint" with a named warning.
- ``supervisor`` — catch → release the failed attempt → resume from
  the latest valid checkpoint, with bounded exponential backoff and
  jitter.
- ``portable`` — shape-portable resume images: any engine family's
  checkpoint (classic, spill, the JAX package's mesh engines) read into
  one wavefront that the port's ``Engine`` and ``SpillEngine`` resume.
"""

from .chaos import (ChaosSchedule, ChaosSpecError, InjectedFault,
                    chaos_fire, chaos_point, get_schedule, install,
                    uninstall)
from .ckpt_chain import ChainWarning

__all__ = [
    "ChaosSchedule", "ChaosSpecError", "InjectedFault", "chaos_fire",
    "chaos_point", "get_schedule", "install", "uninstall",
    "ChainWarning",
]
