"""Batched serving of many small checks (the reference's ``serve``
package, on one device).

Takes a list of (spec, config, engine-options) jobs, groups them into
shape buckets, runs each bucket as one job-axis program (serve/batch),
and answers repeat jobs from a fingerprint-keyed result cache
(serve/cache).  The scheduling loop is serve/scheduler's
``WaveScheduler``: ``batch`` drains a job list through it once, and the
persistent daemon (serve/daemon and serve/intake, ``serve``) runs it
cycle after cycle over a spool directory.  serve/jobs defines the job
objects and the JSONL format, serve/wavestate the per-job wave state
that makes waves preemptible, and serve/exec_cache the reference's
persistent program cache, which on this backend counts a named store
failure for every captured graph and never hits.
"""

from .batch import BatchReport, BucketEngine, JobOutcome, run_jobs
from .cache import ResultCache
from .daemon import Daemon
from .exec_cache import ExecCache
from .intake import SpoolIntake, StreamTail, Submission
from .jobs import Job, job_from_dict, load_jobs
from .scheduler import WaveScheduler
from .wavestate import WaveStateStore

__all__ = [
    "BatchReport", "BucketEngine", "Daemon", "ExecCache", "Job",
    "JobOutcome", "ResultCache", "SpoolIntake", "StreamTail",
    "Submission", "WaveScheduler", "WaveStateStore", "job_from_dict",
    "load_jobs", "run_jobs",
]
