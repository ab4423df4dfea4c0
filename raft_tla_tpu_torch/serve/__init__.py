"""Batched serving of many small checks (the reference's ``serve``
package, on one device).

Takes a list of (spec, config, engine-options) jobs, groups them into
shape buckets, runs each bucket as one job-axis program (serve/batch),
and answers repeat jobs from a fingerprint-keyed result cache
(serve/cache).  The scheduling loop is serve/scheduler's
``WaveScheduler``; ``batch`` drains a job list through it once.
serve/jobs defines the job objects and the JSONL format, and
serve/wavestate the per-job wave state that makes waves preemptible.

Not ported yet: the executable cache (``serve/exec_cache.py``) and the
daemon (``serve/intake.py``, ``serve/daemon.py``, the ``serve``
command).
"""

from .batch import BatchReport, BucketEngine, JobOutcome, run_jobs
from .cache import ResultCache
from .jobs import Job, job_from_dict, load_jobs
from .scheduler import WaveScheduler
from .wavestate import WaveStateStore

__all__ = [
    "BatchReport", "BucketEngine", "Job", "JobOutcome", "ResultCache",
    "WaveScheduler", "WaveStateStore", "job_from_dict", "load_jobs",
    "run_jobs",
]
