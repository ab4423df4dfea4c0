"""Deterministic chaos injection: a seeded fault schedule fired at
named engine sites (``--chaos SPEC``), the reference's
``raft_tla_tpu/resil/chaos.py`` with the same grammar, sites and
schedule semantics.

Long deep runs lose the whole run to one lost process, and recovery
code that only runs when a process really dies is untested code.  This
module makes every failure reproducible on the CPU: a schedule is a
pure function of (spec string, per-site hit counter), so a faulted run
is exactly replayable and "faulted-then-recovered == unfaulted" is a
deterministic test, not a soak.

Spec grammar (';'-separated clauses)::

    seed=N                      PRNG seed for p= clauses (default 0)
    <site>:at=K[,K2,...]        fire on the K-th hit (1-based), once each
    <site>:every=N              fire on every N-th hit
    <site>:p=0.25               fire with probability p (seeded hash of
                                the hit counter — deterministic)

Sites (each names one injection point in the engines; this package
fires ``dispatch``, ``ckpt_torn``, ``ckpt_corrupt``, ``archive``,
``host_table`` (the spill engine's host table) and ``wave_kill`` (the
batched serving waves, ``serve/batch.py``) — ``intake`` belongs to the
daemon, not ported yet, and its name is kept so a spec is valid in
both packages)::

    dispatch    raised at the top of every engine level/burst loop
                iteration — a dispatch-time device error
    ckpt_torn   after a checkpoint publishes: truncate the head file
                (a torn write at crash time)
    ckpt_corrupt  after a checkpoint publishes: flip bytes mid-file
    archive     raised before a trace-archive level append (disk I/O
                error on the memmap files)
    host_table  raised before a host-partition sweep (partition image
                lost with the host process)
    wave_kill   raised at a serve wave boundary AFTER the per-job wave
                state persists — the deterministic stand-in for
                SIGKILLing a ``cli batch`` run mid-wave
    intake      raised in the daemon's spool scan (serve/intake)
                BEFORE a submission's claim rename — a disk/NFS error
                during intake; the submission stays in incoming/ and
                the next poll re-claims it

``dispatch``/``archive``/``host_table``/``wave_kill``/``intake`` RAISE
``InjectedFault`` (the supervised runner catches and recovers);
``ckpt_torn``/``ckpt_corrupt`` silently damage the just-published
checkpoint bytes so the NEXT resume exercises the chain fallback.

The schedule is process-global (``install``/``uninstall``) and its
counters deliberately survive recovery retries: an ``at=K`` clause
fires once ever, so a replayed level does not re-fault forever, while
``every=N`` keeps faulting on schedule — the supervised differential
uses exactly that to fault every level boundary.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

KNOWN_SITES = ("dispatch", "ckpt_torn", "ckpt_corrupt", "archive",
               "host_table", "wave_kill", "intake")


class ChaosSpecError(ValueError):
    """Malformed ``--chaos`` spec (unknown site/rule, bad value)."""


class InjectedFault(RuntimeError):
    """A chaos-injected failure.  Carries the site and hit index so
    ledgers and tests can attribute the fault."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"chaos-injected fault at site {site!r} "
                         f"(hit #{hit})")
        self.site = site
        self.hit = hit


def _mix(x: int) -> int:
    """32-bit finalizer (the fmix32 constants) in pure Python — the
    p= clauses must not depend on any array library."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x


class ChaosSchedule:
    """Parsed fault schedule; ``fire(site)`` advances the site's hit
    counter and reports whether this hit faults (deterministic)."""

    def __init__(self, spec: str):
        self.spec = spec
        self.seed = 0
        # site -> ("at", frozenset) | ("every", N) | ("p", threshold)
        self.rules: Dict[str, Tuple[str, object]] = {}
        self.hits: Dict[str, int] = {}
        self.fired: List[Tuple[str, int]] = []     # (site, hit) log
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                try:
                    self.seed = int(clause[5:])
                except ValueError:
                    raise ChaosSpecError(
                        f"chaos spec: bad seed in {clause!r}")
                continue
            if ":" not in clause:
                raise ChaosSpecError(
                    f"chaos spec: clause {clause!r} is not "
                    f"'site:rule' (known sites: "
                    f"{', '.join(KNOWN_SITES)})")
            site, rule = clause.split(":", 1)
            site = site.strip()
            if site not in KNOWN_SITES:
                raise ChaosSpecError(
                    f"chaos spec: unknown site {site!r}; known: "
                    f"{', '.join(KNOWN_SITES)}")
            if site in self.rules:
                raise ChaosSpecError(
                    f"chaos spec: site {site!r} declared twice")
            if "=" not in rule:
                raise ChaosSpecError(
                    f"chaos spec: rule {rule!r} is not at=/every=/p=")
            kind, val = rule.split("=", 1)
            kind = kind.strip()
            if kind not in ("at", "every", "p"):
                raise ChaosSpecError(
                    f"chaos spec: unknown rule {kind!r} for site "
                    f"{site!r} (use at=K[,..], every=N, or p=0.x)")
            try:
                if kind == "at":
                    hits = frozenset(int(v) for v in val.split(","))
                    if not hits or min(hits) < 1:
                        raise ValueError
                    self.rules[site] = ("at", hits)
                elif kind == "every":
                    n = int(val)
                    if n < 1:
                        raise ValueError
                    self.rules[site] = ("every", n)
                else:
                    p = float(val)
                    if not 0.0 <= p <= 1.0:
                        raise ValueError
                    self.rules[site] = ("p", int(p * 2.0 ** 32))
            except ChaosSpecError:
                raise
            except ValueError:
                raise ChaosSpecError(
                    f"chaos spec: bad {kind}= value {val!r} for site "
                    f"{site!r}")
        if not self.rules:
            raise ChaosSpecError(
                f"chaos spec {spec!r} declares no sites; clauses are "
                f"'site:rule' with sites {', '.join(KNOWN_SITES)}")

    def fire(self, site: str) -> bool:
        rule = self.rules.get(site)
        if rule is None:
            return False
        hit = self.hits.get(site, 0) + 1
        self.hits[site] = hit
        kind, val = rule
        if kind == "at":
            hot = hit in val
        elif kind == "every":
            hot = hit % val == 0
        else:
            site_h = _mix(sum(ord(c) for c in site) * 0x9E3779B1)
            hot = _mix(self.seed ^ site_h ^ hit) < val
        if hot:
            self.fired.append((site, hit))
        return hot

    def point(self, site: str):
        """Raise ``InjectedFault`` when this hit is scheduled to
        fault; otherwise a cheap counter bump."""
        if self.fire(site):
            raise InjectedFault(site, self.hits[site])


# ---------------------------------------------------------------------------
# process-global installation (the CLI/supervisor own the lifecycle;
# engines call chaos_point unconditionally — one global read when no
# schedule is installed)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[ChaosSchedule] = None


def install(spec_or_schedule) -> ChaosSchedule:
    global _ACTIVE
    sched = (spec_or_schedule
             if isinstance(spec_or_schedule, ChaosSchedule)
             else ChaosSchedule(str(spec_or_schedule)))
    _ACTIVE = sched
    return sched


def uninstall():
    global _ACTIVE
    _ACTIVE = None


def get_schedule() -> Optional[ChaosSchedule]:
    return _ACTIVE


def chaos_point(site: str):
    """Engine-side injection hook: no-op unless a schedule is
    installed AND this hit is scheduled — then raises InjectedFault."""
    if _ACTIVE is not None:
        _ACTIVE.point(site)


def chaos_fire(site: str) -> bool:
    """Non-raising twin for sites that corrupt rather than fail
    (checkpoint tear/corrupt)."""
    return _ACTIVE.fire(site) if _ACTIVE is not None else False
