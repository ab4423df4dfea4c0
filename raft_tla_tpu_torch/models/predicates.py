"""Constraints, safety invariants, and scenario properties — oracle versions.

The port's own copy of the reference package's ``models/predicates.py``.

Literal transcriptions of tlc_membership/raft.tla:949-1278 over the Python
State/Hist representation.  The oracle versions may be slow (they enumerate
Quorum sets literally, walk the global history, etc.) — that is the point:
they are the semantics the vectorized predicates in ops/ are differentially
tested against.

TLC semantics reminders (SURVEY §2.8):
  * CONSTRAINT: a state violating it is still generated and invariant-checked
    but never *expanded*.
  * ACTION_CONSTRAINT: a transition violating it is not taken at all.
  * "Test case" INVARIANTS are negated reachability properties: a violation
    is the product (a witness trace).
"""

from __future__ import annotations

from typing import Callable, Dict

from ..config import (CANDIDATE, CONFIG_ENTRY, LEADER, NIL, ModelConfig,
                      popcount, mask_iter)
from .raft import (Hist, State, committed, get_config, is_prefix, last_term,
                   quorums)


# ---------------------------------------------------------------------------
# Constraints (raft.tla:1105-1137)
# ---------------------------------------------------------------------------

def bounded_in_flight_messages(sv, h, cfg):
    """BagCardinality(messages) <= MaxInFlightMessages (raft.tla:1105)."""
    return sum(c for _m, c in sv.msgs) <= cfg.max_inflight


def bounded_request_vote(sv, h, cfg):
    """<=1 copy of each RequestVoteRequest (raft.tla:1108-1110)."""
    from ..config import MT_RVREQ
    return all(c <= 1 for m, c in sv.msgs if m[0] == MT_RVREQ)


def bounded_log_size(sv, h, cfg):
    return all(len(l) <= cfg.bounds.max_log_length for l in sv.log)


def bounded_restarts(sv, h, cfg):
    return all(r <= cfg.bounds.max_restarts for r in h.restarted)


def bounded_timeouts(sv, h, cfg):
    return all(t <= cfg.bounds.max_timeouts for t in h.timeout)


def bounded_terms(sv, h, cfg):
    return all(t <= cfg.bounds.max_terms for t in sv.ct)


def bounded_client_requests(sv, h, cfg):
    return h.nreq <= cfg.bounds.max_client_requests


def bounded_tried_membership_changes(sv, h, cfg):
    return h.ntried <= cfg.bounds.max_tried_membership_changes


def bounded_membership_changes(sv, h, cfg):
    return h.nmc <= cfg.bounds.max_membership_changes


def elections_uncontested(sv, h, cfg):
    """<=1 concurrent Candidate (raft.tla:1126)."""
    return sum(1 for s in sv.st if s == CANDIDATE) <= 1


def clean_start_until_first_request(sv, h, cfg):
    """raft.tla:1128-1132."""
    if h.nleaders < 1 and h.nreq < 1:
        return (all(r == 0 for r in h.restarted) and
                sum(h.timeout) <= 1 and
                elections_uncontested(sv, h, cfg))
    return True


def clean_start_until_two_leaders(sv, h, cfg):
    """raft.tla:1134-1137."""
    if h.nleaders < 2:
        return sum(h.restarted) <= 1 and sum(h.timeout) <= 2
    return True


def clean_first_leader_election(sv, h, cfg):
    """CleanFirstLeaderElection (apalache_no_membership/raft.tla:766-770):
    until the first leader, no restarts and at most one candidate."""
    if h.nleaders < 1:
        return (all(r == 0 for r in h.restarted) and
                elections_uncontested(sv, h, cfg))
    return True


def commit_when_concurrent_leaders_constraint(sv, h, cfg):
    """CommitWhenConcurrentLeaders_constraint (raft.tla:1182-1186) — the
    WEAK punctuated-search pruning: by step >= 20 the history must
    contain a BecomeLeader with >= 2 simultaneous leaders (the comment at
    raft.tla:1188-1191 measures >1.2M length-20 traces still satisfy
    this; the strong prefix pin is our --seed-trace mode instead)."""
    if len(h.glob) < 20:
        return True
    return any(r[0] == "BecomeLeader" and popcount(r[2]) >= 2
               for r in h.glob)


CONSTRAINTS: Dict[str, Callable] = {
    "BoundedInFlightMessages": bounded_in_flight_messages,
    "BoundedRequestVote": bounded_request_vote,
    "BoundedLogSize": bounded_log_size,
    "BoundedRestarts": bounded_restarts,
    "BoundedTimeouts": bounded_timeouts,
    "BoundedTerms": bounded_terms,
    "BoundedClientRequests": bounded_client_requests,
    "BoundedTriedMembershipChanges": bounded_tried_membership_changes,
    "BoundedMembershipChanges": bounded_membership_changes,
    "ElectionsUncontested": elections_uncontested,
    "CleanStartUntilFirstRequest": clean_start_until_first_request,
    "CleanStartUntilTwoLeaders": clean_start_until_two_leaders,
    "CleanFirstLeaderElection": clean_first_leader_election,
    "CommitWhenConcurrentLeaders_constraint":
        commit_when_concurrent_leaders_constraint,
}


# ---------------------------------------------------------------------------
# Safety invariants (raft.tla:988-1099)
# ---------------------------------------------------------------------------

def leader_votes_quorum(sv, h, cfg):
    """LeaderVotesQuorum (raft.tla:988-993), guarded on no membership
    changes."""
    if h.nmc != 0:
        return True
    n = cfg.n_servers
    for i in range(n):
        if sv.st[i] != LEADER:
            continue
        voters = 0
        for j in range(n):
            if (sv.ct[j] > sv.ct[i] or
                    (sv.ct[j] == sv.ct[i] and sv.vf[j] == i)):
                voters |= 1 << j
        if voters not in quorums(get_config(sv, i, cfg), n):
            return False
    return True


def candidate_term_not_in_log(sv, h, cfg):
    """CandidateTermNotInLog (raft.tla:997-1004)."""
    if h.nmc != 0:
        return True
    n = cfg.n_servers
    for i in range(n):
        if sv.st[i] != CANDIDATE:
            continue
        voters = 0
        for j in range(n):
            if sv.ct[j] == sv.ct[i] and sv.vf[j] in (i, NIL):
                voters |= 1 << j
        if voters not in quorums(get_config(sv, i, cfg), n):
            continue
        for j in range(n):
            for e in sv.log[j]:
                if e[0] == sv.ct[i]:
                    return False
    return True


def election_safety(sv, h, cfg):
    """ElectionSafety (raft.tla:1009-1014)."""
    n = cfg.n_servers

    def max_or_zero(slog, term):
        idxs = [k + 1 for k, e in enumerate(slog) if e[0] == term]
        return max(idxs) if idxs else 0

    for i in range(n):
        if sv.st[i] != LEADER:
            continue
        mine = max_or_zero(sv.log[i], sv.ct[i])
        for j in range(n):
            if mine < max_or_zero(sv.log[j], sv.ct[i]):
                return False
    return True


def log_matching(sv, h, cfg):
    """LogMatching (raft.tla:1017-1021)."""
    n = cfg.n_servers
    for i in range(n):
        for j in range(n):
            upto = min(len(sv.log[i]), len(sv.log[j]))
            for k in range(upto):
                if (sv.log[i][k][0] == sv.log[j][k][0] and
                        sv.log[i][:k + 1] != sv.log[j][:k + 1]):
                    return False
    return True


def votes_granted_inv(sv, h, cfg):
    """VotesGrantedInv, corrected form (raft.tla:1048-1052)."""
    n = cfg.n_servers
    for i in range(n):
        j = sv.vf[i]
        if j != NIL and not is_prefix(committed(sv, i), sv.log[j]):
            return False
    return True


def votes_granted_inv_false(sv, h, cfg):
    """VotesGrantedInv_false — Ricketts' original, documented as violated
    (raft.tla:1038-1046); live in the apalache variant (SURVEY §2.7)."""
    n = cfg.n_servers
    for i in range(n):
        for j in mask_iter(sv.vg[i], n):
            if sv.ct[i] == sv.ct[j]:
                if not is_prefix(committed(sv, j), sv.log[i]):
                    return False
    return True


def quorum_log_inv(sv, h, cfg):
    """QuorumLogInv (raft.tla:1056-1060)."""
    n = cfg.n_servers
    for i in range(n):
        comm = committed(sv, i)
        for q in quorums(get_config(sv, i, cfg), n):
            if not any(is_prefix(comm, sv.log[j])
                       for j in mask_iter(q, n)):
                return False
    return True


def more_up_to_date_correct(sv, h, cfg):
    """MoreUpToDateCorrect (raft.tla:1066-1071)."""
    n = cfg.n_servers
    for i in range(n):
        for j in range(n):
            more = (last_term(sv.log[i]) > last_term(sv.log[j]) or
                    (last_term(sv.log[i]) == last_term(sv.log[j]) and
                     len(sv.log[i]) >= len(sv.log[j])))
            if more and not is_prefix(committed(sv, j), sv.log[i]):
                return False
    return True


def leader_completeness(sv, h, cfg):
    """LeaderCompleteness, corrected form (raft.tla:1089-1099).  An index
    beyond a leader's log length counts as a violation (TLC would raise an
    evaluation error on log[l][idx] there)."""
    n = cfg.n_servers
    leaders = [l for l in range(n) if sv.st[l] == LEADER]
    for i in range(n):
        comm = committed(sv, i)
        for idx in range(1, len(comm) + 1):
            entry = sv.log[i][idx - 1]
            for l in leaders:
                if sv.ct[l] > entry[0]:
                    if len(sv.log[l]) < idx or sv.log[l][idx - 1] != entry:
                        return False
    return True


def leader_completeness_false(sv, h, cfg):
    """LeaderCompleteness_false (raft.tla:1079-1083) — violated under
    concurrent leaders; live in the apalache variant."""
    n = cfg.n_servers
    for i in range(n):
        if sv.st[i] != LEADER:
            continue
        for j in range(n):
            if not is_prefix(committed(sv, j), sv.log[i]):
                return False
    return True


def one_at_a_time_membership_change_ok(sv, h, cfg):
    """OneAtATimeMembershipChangeOK — OURS, not the reference's.

    BASELINE.json names this invariant but no such operator exists in the
    reference (SURVEY.md preamble, phantom-name warning).  The one-at-a-time
    discipline is enforced operationally by HandleCheckOldConfig's gate
    `GetMaxConfigIndex(i) <= commitIndex[i]` (raft.tla:800).  We state the
    induced state property: every log suffix beyond a server's commitIndex
    contains at most one ConfigEntry."""
    n = cfg.n_servers
    for i in range(n):
        uncommitted_configs = sum(
            1 for e in sv.log[i][sv.ci[i]:] if e[1] == CONFIG_ENTRY)
        if uncommitted_configs > 1:
            return False
    return True


# ---------------------------------------------------------------------------
# Scenario ("test case") properties (raft.tla:1143-1278) — negated
# reachability; oracle versions read the full global history.
# ---------------------------------------------------------------------------

def _current_leaders(sv):
    m = 0
    for k, s in enumerate(sv.st):
        if s == LEADER:
            m |= 1 << k
    return m


def bounded_trace(sv, h, cfg):
    return len(h.glob) <= cfg.bounds.max_trace


def first_become_leader(sv, h, cfg):
    return not any(r[0] == "BecomeLeader" for r in h.glob)


def first_commit(sv, h, cfg):
    return not any(c > 0 for c in sv.ci)


def first_restart(sv, h, cfg):
    return not any(r >= 2 for r in h.restarted)


def leadership_change(sv, h, cfg):
    return h.nleaders < 2


def membership_change(sv, h, cfg):
    return h.nmc < 1


def multiple_membership_changes(sv, h, cfg):
    return h.nmc < 2


def concurrent_leaders(sv, h, cfg):
    return popcount(_current_leaders(sv)) < 2


def entry_committed(sv, h, cfg):
    return not any(r[0] == "CommitEntry" for r in h.glob)


def commit_when_concurrent_leaders(sv, h, cfg):
    """CommitWhenConcurrentLeaders (raft.tla:1165-1176)."""
    if popcount(_current_leaders(sv)) < 2:
        return True
    seen_bl2 = False
    for k, r in enumerate(h.glob):          # k is 0-based; spec is 1-based
        if r[0] == "BecomeLeader" and popcount(r[2]) >= 2:
            seen_bl2 = True
        elif r[0] == "CommitEntry" and seen_bl2:
            # need Len(glob) >= (k+1) + 2 in 1-based terms
            if len(h.glob) >= k + 3:
                return False
    return True


def majority_of_cluster_restarts(sv, h, cfg):
    """MajorityOfClusterRestarts (raft.tla:1212-1226)."""
    n = cfg.n_servers
    nontrivial = any(
        i != j and len(sv.log[i]) >= 2 and len(sv.log[j]) >= 1
        for i in range(n) for j in range(n))
    if not nontrivial:
        return True
    full = (1 << n) - 1
    maj_restarted = any(
        all(h.restarted[i] >= 1 for i in mask_iter(q, n))
        for q in quorums(full, n))
    if not maj_restarted:
        return True
    restart_positions = [k for k, r in enumerate(h.glob)
                         if r[0] == "Restart"]
    for a in range(len(restart_positions)):
        for b in range(a + 1, len(restart_positions)):
            if restart_positions[b] - restart_positions[a] < 6:
                return True     # activity-gap condition fails => no witness
    return False


def add_successful(sv, h, cfg):
    """AddSucessful [sic] (raft.tla:1236-1237)."""
    return not any(r[0] == "AddServer" for r in h.glob)


def membership_change_commits(sv, h, cfg):
    return not any(r[0] == "CommitMembershipChange" for r in h.glob)


def multiple_membership_changes_commit(sv, h, cfg):
    return sum(1 for r in h.glob
               if r[0] == "CommitMembershipChange") < 2


def add_commits(sv, h, cfg):
    """AddCommits (raft.tla:1248-1256)."""
    added_so_far = 0
    for r in h.glob:
        if r[0] == "AddServer":
            added_so_far |= 1 << r[2]
        elif r[0] == "CommitMembershipChange" and (r[2] & added_so_far):
            return False
    return True


def newly_joined_become_leader(sv, h, cfg):
    """NewlyJoinedBecomeLeader (raft.tla:1258-1266)."""
    added_so_far = 0
    for r in h.glob:
        if r[0] == "AddServer":
            added_so_far |= 1 << r[2]
        elif r[0] == "BecomeLeader" and (added_so_far >> r[1] & 1):
            return False
    return True


def leader_changes_during_conf_change(sv, h, cfg):
    """LeaderChangesDuringConfChange (raft.tla:1268-1278)."""
    open_add = False
    for r in h.glob:
        if r[0] == "AddServer":
            open_add = True
        elif r[0] == "CommitMembershipChange":
            open_add = False
        elif r[0] == "BecomeLeader" and open_add:
            return False
    return True


INVARIANTS: Dict[str, Callable] = {
    # Safety
    "LeaderVotesQuorum": leader_votes_quorum,
    "CandidateTermNotInLog": candidate_term_not_in_log,
    "ElectionSafety": election_safety,
    "LogMatching": log_matching,
    "VotesGrantedInv": votes_granted_inv,
    "VotesGrantedInv_false": votes_granted_inv_false,
    "QuorumLogInv": quorum_log_inv,
    "MoreUpToDateCorrect": more_up_to_date_correct,
    "LeaderCompleteness": leader_completeness,
    "LeaderCompleteness_false": leader_completeness_false,
    "OneAtATimeMembershipChangeOK": one_at_a_time_membership_change_ok,
    # Scenario / trace generation
    "BoundedTrace": bounded_trace,
    "FirstBecomeLeader": first_become_leader,
    "FirstCommit": first_commit,
    "FirstRestart": first_restart,
    "LeadershipChange": leadership_change,
    "MembershipChange": membership_change,
    "MultipleMembershipChanges": multiple_membership_changes,
    "ConcurrentLeaders": concurrent_leaders,
    "EntryCommitted": entry_committed,
    "CommitWhenConcurrentLeaders": commit_when_concurrent_leaders,
    "MajorityOfClusterRestarts": majority_of_cluster_restarts,
    "AddSucessful": add_successful,
    "MembershipChangeCommits": membership_change_commits,
    "MultipleMembershipChangesCommit": multiple_membership_changes_commit,
    "AddCommits": add_commits,
    "NewlyJoinedBecomeLeader": newly_joined_become_leader,
    "LeaderChangesDuringConfChange": leader_changes_during_conf_change,
}


def resolve_invariant(name: str, cfg: ModelConfig) -> Callable:
    """apalache_no_membership knowingly ships the *_false forms as its live
    VotesGrantedInv / LeaderCompleteness (SURVEY §2.7 divergence)."""
    if cfg.apalache_variant and name in ("VotesGrantedInv",
                                         "LeaderCompleteness"):
        return INVARIANTS[name + "_false"]
    return INVARIANTS[name]


# ---------------------------------------------------------------------------
# Action constraints (raft.tla:1207-1210)
# ---------------------------------------------------------------------------

def commit_when_concurrent_leaders_action_constraint(sv, h, sv2, h2, cfg):
    """After step 20, no transition may produce a Candidate
    (raft.tla:1207-1210).  `Len(history.global)` is evaluated on the
    unprimed state; state' on the primed one."""
    if len(h.glob) >= 20:
        return all(s != CANDIDATE for s in sv2.st)
    return True


ACTION_CONSTRAINTS: Dict[str, Callable] = {
    "CommitWhenConcurrentLeaders_action_constraint":
        commit_when_concurrent_leaders_action_constraint,
}


# Properties whose oracle evaluation scans the glob *record sequence*
# (not just the counters).  A seed emitted by the engine carries no
# records (decode reconstructs counters only, ops/codec.py), so the
# oracle cannot evaluate these faithfully on such a seed — the CLI
# refuses that combination (cli.py cmd_check).
GLOB_DEPENDENT = frozenset({
    "BoundedTrace", "FirstBecomeLeader", "EntryCommitted",
    "CommitWhenConcurrentLeaders", "MajorityOfClusterRestarts",
    "AddSucessful", "MembershipChangeCommits",
    "MultipleMembershipChangesCommit", "AddCommits",
    "NewlyJoinedBecomeLeader", "LeaderChangesDuringConfChange",
    "CommitWhenConcurrentLeaders_constraint",
    "CommitWhenConcurrentLeaders_action_constraint",
})
