"""Model configuration: the `raft.cfg` operator boundary, lifted.

This mirrors the two config tiers of the reference (SURVEY.md §5 "Config"):
  (a) `raft.cfg`-settable things: CONSTANTS (Server/InitServer/Value/NumRounds),
      INIT/NEXT selection, CONSTRAINTS / ACTION_CONSTRAINTS / INVARIANTS lists,
      SYMMETRY, VIEW            (reference: tlc_membership/raft.cfg:1-88)
  (b) in-spec search bounds (MaxLogLength etc., tlc_membership/raft.tla:22-30)
      which in the reference require editing the spec; here they are real
      config.  They determine static tensor shapes, so a distinct Bounds is a
      distinct JIT cache entry.

Server IDs are 0-based ints everywhere (the reference binds model values
s1..s5 = 1..5; our cfg front-end maps them down).  NIL is -1.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

NIL = -1

# Server roles (tlc_membership/raft.tla:38-44).
FOLLOWER = 0
CANDIDATE = 1
LEADER = 2

# Log entry types (tlc_membership/raft.tla:20).
VALUE_ENTRY = 0
CONFIG_ENTRY = 1

# Message types (tlc_membership/raft.tla:52-65).  0 is reserved for "empty
# bag slot" in the packed encoding, so wire types start at 1.
MT_RVREQ = 1
MT_RVRESP = 2
MT_AEREQ = 3
MT_AERESP = 4
MT_CATREQ = 5
MT_CATRESP = 6
MT_COC = 7

MSG_TYPE_NAMES = {
    MT_RVREQ: "RequestVoteRequest",
    MT_RVRESP: "RequestVoteResponse",
    MT_AEREQ: "AppendEntriesRequest",
    MT_AERESP: "AppendEntriesResponse",
    MT_CATREQ: "CatchupRequest",
    MT_CATRESP: "CatchupResponse",
    MT_COC: "CheckOldConfig",
}

# Next-relation families (tlc_membership/raft.tla:909-943).
NEXT_ASYNC = "NextAsync"
NEXT_ASYNC_CRASH = "NextAsyncCrash"
NEXT_FULL = "Next"
NEXT_DYNAMIC = "NextDynamic"

# The default-enabled constraint set (tlc_membership/raft.cfg:37-49).
DEFAULT_CONSTRAINTS = (
    "BoundedInFlightMessages",
    "BoundedRequestVote",
    "BoundedLogSize",
    "BoundedRestarts",
    "BoundedTimeouts",
    "BoundedTerms",
    "BoundedClientRequests",
    "BoundedTriedMembershipChanges",
    "BoundedMembershipChanges",
    "ElectionsUncontested",
    "CleanStartUntilFirstRequest",
    "CleanStartUntilTwoLeaders",
)

# The default-enabled safety invariants (tlc_membership/raft.cfg:79-87).
DEFAULT_INVARIANTS = (
    "LeaderVotesQuorum",
    "CandidateTermNotInLog",
    "ElectionSafety",
    "LogMatching",
    "VotesGrantedInv",
    "QuorumLogInv",
    "MoreUpToDateCorrect",
    "LeaderCompleteness",
)


@dataclass(frozen=True)
class Bounds:
    """In-spec search bounds (tlc_membership/raft.tla:22-30), lifted to config.

    Note: these bound *expansion* (TLC CONSTRAINT semantics, SURVEY.md §2.8):
    a state exceeding a bound is still generated and invariant-checked, it is
    just never expanded.  The packed representation must therefore hold one
    step beyond each bound (e.g. log length max_log_length+1 after an
    unconstrained append, and up to 2*max_log_length after a catchup splice;
    see ops/codec.py).
    """

    max_log_length: int = 5
    max_restarts: int = 2
    max_timeouts: int = 3
    max_client_requests: int = 3
    max_membership_changes: int = 3
    # Derived defaults mirror the reference (raft.tla:27,29): MaxTerms =
    # MaxTimeouts + 1, MaxTriedMembershipChanges = MaxMembershipChanges + 1.
    max_terms: int = 4
    max_tried_membership_changes: int = 4
    # BoundedTrace cap (raft.tla:1143: 24; apalache variant :776: 12)
    max_trace: int = 24

    @staticmethod
    def make(max_log_length=5, max_restarts=2, max_timeouts=3,
             max_client_requests=3, max_membership_changes=3,
             max_terms=None, max_tried_membership_changes=None,
             max_trace=24) -> "Bounds":
        return Bounds(
            max_log_length=max_log_length,
            max_restarts=max_restarts,
            max_timeouts=max_timeouts,
            max_client_requests=max_client_requests,
            max_membership_changes=max_membership_changes,
            max_terms=max_timeouts + 1 if max_terms is None else max_terms,
            max_tried_membership_changes=(
                max_membership_changes + 1
                if max_tried_membership_changes is None
                else max_tried_membership_changes),
            max_trace=max_trace,
        )


@dataclass(frozen=True)
class ModelConfig:
    """One checkable model: constants + NEXT + toggles (= one raft.cfg)."""

    # SpecIR dispatch marker (spec/ package) — class attribute, NOT a
    # dataclass field, so repr(cfg) (the checkpoint-compat key) is
    # byte-identical to every pre-IR checkpoint's
    spec = "raft"

    n_servers: int = 3                      # |Server|
    init_servers: Tuple[int, ...] = (0, 1, 2)   # InitServer ⊆ Server
    values: Tuple[int, ...] = (1, 2)        # Value
    num_rounds: int = 1                     # NumRounds (catch-up rounds)
    next_family: str = NEXT_ASYNC_CRASH     # raft.cfg:33 default
    constraints: Tuple[str, ...] = DEFAULT_CONSTRAINTS
    action_constraints: Tuple[str, ...] = ()
    invariants: Tuple[str, ...] = DEFAULT_INVARIANTS
    symmetry: bool = True                   # SYMMETRY perms (raft.cfg:29)
    bounds: Bounds = Bounds()
    # Variant switch: apalache_no_membership ships the two *_false invariant
    # forms as its live VotesGrantedInv / LeaderCompleteness (SURVEY.md §2.7
    # divergence note).  When True, those names resolve to the _false forms.
    apalache_variant: bool = False
    # Override for MaxInFlightMessages (raft.tla:30 derives 2*|Server|^2).
    # The reference requires editing the spec for this; we lift it.
    max_inflight_override: int = None
    # 128-bit fingerprints (two independent 64-bit streams).  TLC runs with
    # 64-bit fingerprints and ~1e-9 collision odds; exhaustive-parity runs
    # can opt into 128 (SURVEY §7.4 hard part 4).
    fp128: bool = False
    # Punctuated-search prefix pins from the cfg (raft.tla:1198-1234):
    # "CommitWhenConcurrentLeaders_unique" /
    # "MajorityOfClusterRestarts_constraint".  The reference evaluates
    # these as CONSTRAINTs against a hard-coded witness trace embedded in
    # the spec; the engines compile them into seed states — BFS starts at
    # the end of the pinned prefix (models/golden.prefix_pin_seeds), which
    # reproduces TLC's punctuated-search outcome (the witness extensions)
    # while skipping the prefix interior itself.
    prefix_pins: Tuple[str, ...] = ()

    @property
    def init_mask(self) -> int:
        m = 0
        for i in self.init_servers:
            m |= 1 << i
        return m

    @property
    def all_mask(self) -> int:
        return (1 << self.n_servers) - 1

    @property
    def max_inflight(self) -> int:
        # MaxInFlightMessages == 2 * |Server|^2 (raft.tla:30)
        if self.max_inflight_override is not None:
            return self.max_inflight_override
        return 2 * self.n_servers * self.n_servers

    @property
    def bag_capacity(self) -> int:
        # A state may exceed BoundedInFlightMessages by exactly one Send
        # before being pruned (constraints gate expansion, not generation).
        return self.max_inflight + 1

    @property
    def log_capacity(self) -> int:
        # Worst case representable log: catchup splice of a <=L prefix with
        # <=L caught-up entries (HandleCatchupRequest, raft.tla:734-736), or
        # an append onto a length-L log.  See Bounds docstring.
        return 2 * self.bounds.max_log_length

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def popcount(x: int) -> int:
    return bin(x & ((1 << 64) - 1)).count("1")


def mask_iter(mask: int, n: int):
    for i in range(n):
        if mask >> i & 1:
            yield i
