"""Supervised retry/backoff runner: catch → backend reinit → resume
from the latest valid checkpoint, with bounded exponential backoff
(the reference's ``raft_tla_tpu/resil/supervisor.py``).

A long run dies to transient causes (a device error, an out-of-memory
race, a host I/O blip) more often than to engine bugs.
``supervised_check`` wraps the engine's ``check()``:

- retryable failures (``InjectedFault``, ``RuntimeError`` — which
  covers CUDA errors and ``torch.cuda.OutOfMemoryError`` — and
  ``OSError``) trigger a bounded exponential backoff with deterministic
  jitter, a reinit that drops the failed engine's graphs, graph pool
  and carry, a fresh engine from ``make_engine()``, and a resume from
  the newest VALID member of the checkpoint chain
  (``resil.ckpt_chain``; a torn head is skipped with a ``ChainWarning``)
  — falling back to the original resume source, or a fresh start, when
  no checkpoint was written yet;
- non-retryable failures (``CheckpointError`` and other
  ``ValueError``s, assertion failures, ``NotImplementedError``)
  propagate at once — they mean misconfiguration, not weather.

A sticky CUDA error poisons the process's context: a retry in the same
process then fails again and the run ends in ``RetryExhausted`` with
that error.  Nothing here moves a run to another device.

Every retry is stamped into the run ledger (``kind="retry"``) and the
heartbeat (``status="backoff"``) through ``obs.retry``, so
``tools/watch.py`` shows a retrying run instead of a silent gap.

Because the engine resumes bit-exact from level-boundary checkpoints,
a supervised run's final counts are identical to an unfaulted run's.
"""

from __future__ import annotations

import gc
import time
import traceback
from typing import Callable, Optional

from .chaos import InjectedFault
from .ckpt_chain import latest_valid

#: failures the supervisor treats as transient weather
RETRYABLE = (InjectedFault, RuntimeError, OSError)


class RetryExhausted(RuntimeError):
    """The supervised run failed on its final permitted attempt."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(
            f"supervised run failed after {attempts} attempt(s); "
            f"last error: {last}")
        self.attempts = attempts
        self.last = last


def _jitter(attempt: int) -> float:
    """Deterministic jitter in [0, 1): decorrelates fleet retries
    without breaking replayability (no wall-clock entropy)."""
    return ((attempt + 1) * 2654435761 % (1 << 20)) / float(1 << 20)


def backoff_delay(attempt: int, backoff: float, backoff_max: float,
                  jitter_frac: float = 0.25) -> float:
    """Bounded exponential backoff + deterministic jitter for the
    k-th retry (0-based)."""
    base = min(backoff * (2.0 ** attempt), backoff_max)
    return base * (1.0 + jitter_frac * _jitter(attempt))


def _reinit_backend(eng, err: BaseException):
    """Release what the failed attempt holds on the device before the
    next engine allocates its own: the engine's captured graphs and
    their pool (they hold the old buffers' addresses and must never be
    replayed), the carry that the failed ``check`` frame still holds
    through the error's traceback, and the allocator's cached blocks
    (a config #1 carry is ~1.6 GB)."""
    graphs = getattr(eng, "_graphs", None)
    if graphs is not None:
        graphs.clear()
    traceback.clear_frames(err.__traceback__)
    gc.collect()
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def supervised_check(make_engine: Callable[[], object],
                     retries: int = 0,
                     backoff: float = 1.0,
                     backoff_max: float = 60.0,
                     obs=None,
                     checkpoint_path: Optional[str] = None,
                     resume_from: Optional[str] = None,
                     resume_image=None,
                     sleep: Callable[[float], None] = time.sleep,
                     reinit: bool = True,
                     **check_kw):
    """Run ``make_engine().check(...)`` under supervision.  Returns
    ``(res, engine, attempts_used)``; raises ``RetryExhausted`` when
    the last permitted attempt also fails (with ``retries`` 0 the
    error itself propagates).

    ``make_engine`` is called once per attempt.  ``checkpoint_path``
    doubles as the recovery source: each retry resumes from the newest
    valid chain member; without one, retries fall back to the original
    ``resume_from``/``resume_image`` (or a fresh start).  ``reinit=False`` skips the
    release between attempts (the chaos differentials retry dozens of
    times on one CPU engine).  Remaining kwargs pass through to
    ``check()``."""
    from ..obs import NULL_OBS
    obs = obs if obs is not None else NULL_OBS
    # the caller's resume source: retries fall back to it (or to a
    # fresh start) whenever the checkpoint chain has no valid member —
    # never to a stale chain path from an earlier attempt
    orig_from, orig_image = resume_from, resume_image
    attempt = 0
    while True:
        eng = None
        try:
            eng = make_engine()
            kw = dict(check_kw)
            if resume_image is not None:
                kw["resume_image"] = resume_image
            res = eng.check(checkpoint_path=checkpoint_path,
                            resume_from=resume_from, obs=obs, **kw)
            return res, eng, attempt + 1
        except NotImplementedError:
            # a RuntimeError subclass, but never weather: it names a
            # capability the engine lacks — retrying cannot help
            raise
        except RETRYABLE as e:
            if attempt >= retries:
                if retries:
                    raise RetryExhausted(attempt + 1, e) from e
                raise
            wait = backoff_delay(attempt, backoff, backoff_max)
            obs.retry(attempt=attempt + 1, max_attempts=retries + 1,
                      wait_s=wait, error=e)
            sleep(wait)
            if reinit:
                _reinit_backend(eng, e)
            # recovery source for the next attempt: newest valid
            # checkpoint > the original resume source > fresh start.
            # The resume reads through the chain's head, so a torn or
            # corrupt head is skipped with its named ChainWarning, as
            # on a --resume, and the newest valid member loads
            lv = (latest_valid(checkpoint_path)
                  if checkpoint_path else None)
            if lv is not None:
                resume_from, resume_image = checkpoint_path, None
            else:
                resume_from, resume_image = orig_from, orig_image
            attempt += 1
