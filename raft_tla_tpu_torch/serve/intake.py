"""Spool-directory intake for the persistent checking daemon (the
reference's ``serve/intake.py``: the same layout, rules and texts).

The daemon's submission surface is a directory, because a directory
is the one queue every client already has: drop a file, get a result
file back.  Layout (all subdirectories are created on demand, all
writes throughout are write-then-rename atomic):

    <spool>/incoming/   clients drop ONE JSON job object per file —
                        the same record schema as a ``--jobs`` JSONL
                        line (serve/jobs.job_from_dict), ending with
                        a trailing newline.
    <spool>/claimed/    the daemon atomically renames a submission
                        here before serving it.  A claimed file IS
                        the restart contract: a daemon killed
                        mid-wave re-claims every leftover on the next
                        start and resumes it (mid-BFS via wave state,
                        or instantly via the result cache).
    <spool>/rejected/   malformed submissions, moved verbatim, plus a
                        ``NAME.reason`` file naming the parse error —
                        quarantine, never a daemon crash.
    <spool>/results/    one atomic result JSON per submission (the
                        same per-job report row ``cli batch`` prints).
    <spool>/done/       one small marker per finished submission
                        (name, status, cache key) — the client-visible
                        completion signal, written AFTER the result
                        file, so a marker always has its result.

Write-then-rename protocol (documented in README "Batch / serving on
the H100", enforced here, held against the reference's by
tests/test_torch_intake.py): clients MUST write
the job elsewhere (or to ``NAME.json.tmp`` in incoming/) and
``rename(2)`` it in — the rename is the commit point.  Two guards
keep a non-conforming or crashed writer from corrupting the queue:

- files named ``*.tmp`` / ``*.part`` and dotfiles are never claimed;
- a file NOT ending in a newline is treated as still-being-written
  and left untouched for ``grace_s`` seconds (measured from its
  mtime); past the grace it quarantines with a reason naming the torn
  write.  A complete submission therefore always ends with ``\\n`` —
  cheap for writers, and it makes "torn" detectable without fsync
  games.

Duplicates need no special casing here: two submissions of an
identical job claim independently and the scheduler answers the
second from the result cache / in-batch dedup (``cache_hit`` rows) —
the three-part job fingerprint is the dedup key, not the filename.

``chaos_point("intake")`` (resil/chaos) fires before each claim
rename: an injected intake fault leaves the submission in incoming/
for the next poll — claims are idempotent.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..resil.chaos import chaos_point
from .jobs import Job, job_from_dict

__all__ = ["SpoolIntake", "StreamTail", "Submission"]

_SKIP_SUFFIXES = (".tmp", ".part")


def _atomic_write(path: str, data: str):
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(data)
    os.replace(tmp, path)


@dataclass
class Submission:
    """One claimed job: the spool name that keys its result/done
    files, the parsed Job, and where its claimed file sits."""
    name: str
    job: Job
    path: str
    recovered: bool = False


class SpoolIntake:
    """The spool-directory protocol (module docstring): scan, claim,
    quarantine, recover, and write results/markers."""

    def __init__(self, root: str, grace_s: float = 5.0):
        self.root = root
        self.grace_s = float(grace_s)
        self.dirs = {nm: os.path.join(root, nm)
                     for nm in ("incoming", "claimed", "rejected",
                                "results", "done")}
        for d in self.dirs.values():
            os.makedirs(d, exist_ok=True)

    # -- client side ---------------------------------------------------

    def submit(self, obj: Dict, name: str) -> str:
        """Write-then-rename a job object into incoming/ (the protocol
        clients must follow; tools and tests submit through this)."""
        if os.sep in name or name.startswith("."):
            raise ValueError(f"bad submission name {name!r}")
        final = os.path.join(self.dirs["incoming"], name + ".json")
        _atomic_write(final, json.dumps(obj) + "\n")
        return final

    # -- daemon side ---------------------------------------------------

    def _quarantine(self, src: str, name: str, reason: str):
        dst = os.path.join(self.dirs["rejected"],
                           os.path.basename(src))
        os.replace(src, dst)
        _atomic_write(dst + ".reason", reason.rstrip("\n") + "\n")

    def poll(self) -> Tuple[List[Submission],
                            List[Tuple[str, str]]]:
        """One incoming/ scan: claim every complete submission, leave
        in-progress writes alone, quarantine the malformed.  Returns
        (claimed submissions, [(name, reason)] rejections)."""
        claimed: List[Submission] = []
        rejected: List[Tuple[str, str]] = []
        inc = self.dirs["incoming"]
        now = time.time()
        for fn in sorted(os.listdir(inc)):
            if fn.startswith(".") or fn.endswith(_SKIP_SUFFIXES):
                continue
            path = os.path.join(inc, fn)
            name = fn[:-5] if fn.endswith(".json") else fn
            try:
                with open(path, "rb") as fh:
                    raw = fh.read()
            except OSError:
                continue               # raced with a writer's rename
            if not raw.endswith(b"\n"):
                # no trailing newline = still being written (or a torn
                # writer): honor the grace window, then quarantine
                try:
                    age = now - os.path.getmtime(path)
                except OSError:
                    continue
                if age < self.grace_s:
                    continue
                reason = (f"torn/incomplete job file (no trailing "
                          f"newline after {self.grace_s:g}s grace) — "
                          f"write-then-rename a complete JSON object "
                          f"ending with a newline")
                self._quarantine(path, name, reason)
                rejected.append((name, reason))
                continue
            # an injected intake fault aborts the scan BEFORE the
            # claim: the submission stays in incoming/ for the next
            # poll (claims are idempotent)
            chaos_point("intake")
            try:
                job = job_from_dict(
                    json.loads(raw.decode("utf-8")), where=fn)
            except Exception as e:     # malformed = quarantined, never
                reason = str(e)        # a daemon crash
                self._quarantine(path, name, reason)
                rejected.append((name, reason))
                continue
            # claimed files are always NAME.json, whatever the client
            # called the submission — mark_done recomputes this path
            dst = os.path.join(self.dirs["claimed"], name + ".json")
            os.replace(path, dst)
            claimed.append(Submission(name=name, job=job, path=dst))
        return claimed, rejected

    def recover(self) -> Tuple[List[Submission],
                               List[Tuple[str, str]]]:
        """Startup re-claim: every leftover claimed/ file from a
        killed daemon re-enters the queue.  A leftover whose result
        already landed (killed between result write and marker) is
        finalized instead of recomputed."""
        out: List[Submission] = []
        rejected: List[Tuple[str, str]] = []
        cl = self.dirs["claimed"]
        for fn in sorted(os.listdir(cl)):
            path = os.path.join(cl, fn)
            name = fn[:-5] if fn.endswith(".json") else fn
            res_path = os.path.join(self.dirs["results"],
                                    name + ".json")
            if os.path.exists(res_path):
                if not os.path.exists(os.path.join(
                        self.dirs["done"], name + ".json")):
                    try:
                        with open(res_path) as fh:
                            report = json.load(fh)
                    except (OSError, ValueError):
                        report = {}
                    self.mark_done(name, report)
                else:
                    os.unlink(path)
                continue
            try:
                with open(path, "rb") as fh:
                    raw = fh.read()
                job = job_from_dict(
                    json.loads(raw.decode("utf-8")), where=fn)
            except Exception as e:
                # defensive: claims are validated before the rename,
                # so this means the spool was tampered with — same
                # quarantine, not a crash
                reason = str(e)
                self._quarantine(path, name, reason)
                rejected.append((name, reason))
                continue
            out.append(Submission(name=name, job=job, path=path,
                                  recovered=True))
        return out, rejected

    def write_result(self, name: str, report: Dict) -> str:
        path = os.path.join(self.dirs["results"], name + ".json")
        _atomic_write(path, json.dumps(report) + "\n")
        return path

    def mark_done(self, name: str, report: Dict):
        """Write the done/ marker (AFTER the result file) and retire
        the claimed file — the submission's terminal transition."""
        marker = {"name": name,
                  "status": report.get("status"),
                  "label": report.get("label"),
                  "cache_key": report.get("cache_key")}
        _atomic_write(os.path.join(self.dirs["done"], name + ".json"),
                      json.dumps(marker) + "\n")
        claimed = os.path.join(self.dirs["claimed"], name + ".json")
        if os.path.exists(claimed):
            os.unlink(claimed)

    def counts(self) -> Dict[str, int]:
        """Live queue-depth numbers for the daemon heartbeat (watch's
        daemon view): files currently in each lifecycle directory."""
        out = {}
        for nm, d in self.dirs.items():
            try:
                out[nm] = sum(
                    1 for fn in os.listdir(d)
                    if not fn.startswith(".")
                    and not fn.endswith(_SKIP_SUFFIXES)
                    and not fn.endswith(".reason"))
            except OSError:
                out[nm] = 0
        return out


class StreamTail:
    """Tail an append-only JSONL job stream into the spool.

    Each COMPLETE appended line (newline-terminated; blank lines and
    #-comments skipped, the ``--jobs`` file conventions) materializes
    as a spool submission named ``stream-<n>`` through the normal
    incoming/ protocol — so validation, quarantine, claiming and
    recovery are all the directory path's, with no second copy.  The
    consumed byte offset persists atomically next to the spool; a
    restarted daemon resumes the tail where it left off, so stream
    jobs are neither re-submitted nor dropped.  A partial final line
    (writer mid-append) stays unconsumed until its newline lands.
    Re-materializing an already-written submission after a crash
    between the file write and the offset persist is harmless: the
    name is deterministic, the content identical."""

    def __init__(self, path: str, intake: SpoolIntake):
        self.path = path
        self.intake = intake
        self.state_path = os.path.join(intake.root, "stream.offset")
        self.offset = 0
        self.lineno = 0
        try:
            with open(self.state_path) as fh:
                st = json.load(fh)
            self.offset = int(st.get("offset", 0))
            self.lineno = int(st.get("lineno", 0))
        except (OSError, ValueError):
            pass

    def poll(self) -> int:
        """Consume complete appended lines; returns the number of
        submissions materialized."""
        try:
            with open(self.path, "rb") as fh:
                fh.seek(self.offset)
                data = fh.read()
        except OSError:
            return 0
        n = 0
        consumed = 0
        while True:
            nl = data.find(b"\n", consumed)
            if nl < 0:
                break
            line = data[consumed:nl]
            consumed = nl + 1
            text = line.decode("utf-8", "replace").strip()
            if not text or text.startswith("#"):
                continue
            self.lineno += 1
            name = f"stream-{self.lineno:06d}"
            final = os.path.join(self.intake.dirs["incoming"],
                                 name + ".json")
            _atomic_write(final, text + "\n")
            n += 1
        if consumed:
            self.offset += consumed
            _atomic_write(self.state_path, json.dumps(
                {"offset": self.offset, "lineno": self.lineno}))
        return n
