"""Invariants, constraints and scenario properties over batch-last rows.

Torch form of the reference's ``ops/vpredicates.py``: each predicate
maps a batch of SoA states ([..., N]) to a bool [N] ("holds").
Quantifier structure becomes broadcasting over the leading axes with
the batch axis last:

  * ∀ server pairs / log positions  -> [S, S, Lcap, N] masks + all_
  * ∃ quorum ⊆ config with property P -> the counting closed form
    2·|config ∩ P| > |config|

TLC semantics: CONSTRAINT = don't-expand (not reject); the engine
applies it as the frontier mask.  ``rtb`` is the runtime-bounds vector
(``runtime_bounds``): when given, the Bounded* constraints read their
bound from it instead of the config.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..config import CANDIDATE, CONFIG_ENTRY, LEADER, MT_RVREQ, NIL
from .codec import (C_GLOBLEN, C_NLEADERS, C_NMC, C_NREQ, C_NTRIED,
                    F_ADD_COMMITS, F_ADDED_SET, F_BL2_SEEN, F_COMMIT_SEEN,
                    F_CWCL_POS, F_LCDCC, F_MC_COMMITS, F_MIN_RESTART_GAP,
                    F_NJBL)
from .kernels import I32, RaftKernels, all_, any_, ar, popcount
from .layout import Layout, get_field_t

RUNTIME_BOUND_KEYS = (
    "max_inflight", "max_log_length", "max_restarts", "max_timeouts",
    "max_terms", "max_client_requests", "max_tried_membership_changes",
    "max_membership_changes", "max_trace")
(RB_INFLIGHT, RB_LOGLEN, RB_RESTARTS, RB_TIMEOUTS, RB_TERMS, RB_NREQ,
 RB_TRIED, RB_NMC, RB_TRACE) = range(len(RUNTIME_BOUND_KEYS))


def runtime_bounds(cfg) -> np.ndarray:
    """A config's search bounds as the int32 vector the runtime-bounds
    predicates consume (RUNTIME_BOUND_KEYS order)."""
    b = cfg.bounds
    return np.array([
        cfg.max_inflight, b.max_log_length, b.max_restarts,
        b.max_timeouts, b.max_terms, b.max_client_requests,
        b.max_tried_membership_changes, b.max_membership_changes,
        b.max_trace], np.int32)


def _rb(rtb, idx: int, static):
    """One bound: the runtime vector's entry when present, else the
    config constant."""
    return static if rtb is None else int(rtb[idx])


class Predicates:
    """Predicate family bound to one (Layout, ModelConfig)."""

    def __init__(self, lay: Layout):
        self.lay = lay
        self.cfg = lay.cfg
        self.kern = RaftKernels(lay)
        self.S, self.Lcap = lay.S, lay.Lcap

    # ------------------------------------------------------------------
    # Shared derived quantities
    # ------------------------------------------------------------------

    def _prefix_ok(self, sv):
        """prefix_ok[i, j] == IsPrefix(Committed(i), log[j])
        (raft.tla:969).  commitIndex clamps to the log length."""
        comm_len = torch.minimum(sv["ci"], sv["llen"])        # [S, N]
        log = sv["log"]
        eq = log[:, None] == log[None, :]                     # [S,S,Lcap,N]
        pos = ar(self.Lcap, log)[None, None, :, None]
        within = pos < comm_len[:, None, None]
        all_eq = (eq | ~within).all(2)
        return all_eq & (comm_len[:, None] <= sv["llen"][None, :])

    def _in_quorum(self, votes, config):
        return self.kern.in_quorum(votes, config)

    def _bits(self, ref):
        return 1 << ar(self.S, ref)

    def _voters(self, support):
        """[i, j, N] support -> [i, N] bitmask of the j that support i."""
        bits = self._bits(support)[None, :, None]
        return torch.where(support, bits, 0).sum(1, dtype=I32)

    # ------------------------------------------------------------------
    # Safety invariants (raft.tla:988-1099)
    # ------------------------------------------------------------------

    def leader_votes_quorum(self, sv, der):
        guard = sv["ctr"][C_NMC] != 0
        ct, vf = sv["ct"], sv["vf"]
        me = ar(self.S, ct)[:, None, None]
        support = (ct[None, :] > ct[:, None]) | \
            ((ct[None, :] == ct[:, None]) & (vf[None, :] == me))   # [i,j,N]
        voters = self._voters(support)
        ok = ~(sv["st"] == LEADER) | self._in_quorum(voters, der["config"])
        return guard | all_(ok)

    def candidate_term_not_in_log(self, sv, der):
        guard = sv["ctr"][C_NMC] != 0
        ct, vf = sv["ct"], sv["vf"]
        me = ar(self.S, ct)[:, None, None]
        support = (ct[None, :] == ct[:, None]) & \
            ((vf[None, :] == me) | (vf[None, :] == NIL))
        voters = self._voters(support)
        electable = (sv["st"] == CANDIDATE) & \
            self._in_quorum(voters, der["config"])
        terms = self.kern.entry_term(sv["log"])               # [S, Lcap, N]
        occ = sv["log"] != 0
        term_in_log = (occ[None] & (terms[None] == ct[:, None, None])) \
            .flatten(1, 2).any(1)                             # [i, N]
        return guard | all_(~electable | ~term_in_log)

    def election_safety(self, sv, der):
        terms = self.kern.entry_term(sv["log"])
        occ = sv["log"] != 0
        pos = (ar(self.Lcap, terms) + 1)[None, None, :, None]
        # maxidx[i, j] = MaxOrZero index in log[j] with term currentTerm[i]
        hit = occ[None] & (terms[None] == sv["ct"][:, None, None])
        maxidx = torch.where(hit, pos, 0).amax(2)             # [i, j, N]
        mine = torch.diagonal(maxidx, 0, 0, 1).movedim(-1, 0)  # [i, N]
        ok = ~(sv["st"] == LEADER)[:, None] | (maxidx <= mine[:, None])
        return all_(ok)

    def log_matching(self, sv, der):
        log = sv["log"]
        terms = self.kern.entry_term(log)
        pos = ar(self.Lcap, log)[None, None, :, None]
        llen = sv["llen"]
        within = (pos < llen[:, None, None]) & (pos < llen[None, :, None])
        term_eq = (terms[:, None] == terms[None, :]) & within
        entry_eq = log[:, None] == log[None, :]
        prefix_eq = torch.cumprod((entry_eq | ~within).to(I32), dim=2) \
            .to(torch.bool)
        return ~any_(term_eq & ~prefix_eq)

    def votes_granted_inv(self, sv, der):
        """Corrected form (raft.tla:1048-1052)."""
        pref = self._prefix_ok(sv)                            # [i, j, N]
        vf = sv["vf"]
        my_pref = pref.gather(
            1, vf.clamp(0, self.S - 1).long()[:, None]).squeeze(1)
        return all_((vf == NIL) | my_pref)

    def votes_granted_inv_false(self, sv, der):
        """The original form, documented-violated (raft.tla:1038-1046);
        live in the apalache variant."""
        pref = self._prefix_ok(sv)                            # [j, i, N]
        jj = ar(self.S, pref)[None, :, None]
        granted = ((sv["vg"][:, None] >> jj) & 1) == 1        # [i, j, N]
        same_term = sv["ct"][:, None] == sv["ct"][None, :]
        need = granted & same_term
        return ~any_(need & ~pref.transpose(0, 1))

    def quorum_log_inv(self, sv, der):
        """Every quorum has a member with my committed prefix — dual: the
        bad set must not itself contain a quorum (raft.tla:1056-1060)."""
        good = self._voters(self._prefix_ok(sv))              # [i, N]
        bad = der["config"] & ~good
        cfg_n = popcount(der["config"], self.S)
        return all_(~(2 * popcount(bad, self.S) > cfg_n))

    def more_up_to_date_correct(self, sv, der):
        lt = der["lastterm"]
        llen = sv["llen"]
        more = (lt[:, None] > lt[None, :]) | \
            ((lt[:, None] == lt[None, :]) &
             (llen[:, None] >= llen[None, :]))                # [i, j, N]
        pref = self._prefix_ok(sv)                            # [j, i, N]
        return ~any_(more & ~pref.transpose(0, 1))

    def leader_completeness(self, sv, der):
        """Corrected form (raft.tla:1089-1099): a committed entry appears
        at the same position in every higher-term current leader's log."""
        log = sv["log"]
        terms = self.kern.entry_term(log)                     # [i, k, N]
        comm_len = torch.minimum(sv["ci"], sv["llen"])
        pos = ar(self.Lcap, log)[:, None]                     # [k, 1]
        committed = pos[None] < comm_len[:, None]             # [i, k, N]
        # [i, l, k, N]: leader l with ct[l] > entry term must hold it
        higher = sv["ct"][None, :, None] > terms[:, None]
        is_leader = (sv["st"] == LEADER)[None, :, None]
        same = log[None] == log[:, None]
        within_l = pos[None, None] < sv["llen"][None, :, None]
        ok = ~(committed[:, None] & is_leader & higher) | (within_l & same)
        return all_(ok)

    def leader_completeness_false(self, sv, der):
        """Original form, violated under concurrent leaders
        (raft.tla:1079-1083); live in the apalache variant."""
        pref = self._prefix_ok(sv)                            # [j, i, N]
        is_leader = (sv["st"] == LEADER)[None, :]
        return ~any_(is_leader & ~pref)

    def one_at_a_time_membership_change_ok(self, sv, der):
        """At most one uncommitted ConfigEntry per log suffix."""
        etypes = self.kern.entry_type(sv["log"])
        occ = sv["log"] != 0
        pos = ar(self.Lcap, occ)[None, :, None]
        beyond = pos >= sv["ci"][:, None]
        n_unc = (occ & (etypes == CONFIG_ENTRY) & beyond).sum(
            1, dtype=I32)
        return all_(n_unc <= 1)

    # ------------------------------------------------------------------
    # Scenario ("test case") properties (raft.tla:1143-1278) — negated
    # reachability, read from counter/feature lanes
    # ------------------------------------------------------------------

    def bounded_trace(self, sv, der, rtb=None):
        return sv["ctr"][C_GLOBLEN] <= \
            _rb(rtb, RB_TRACE, self.cfg.bounds.max_trace)

    def first_become_leader(self, sv, der):
        return sv["ctr"][C_NLEADERS] < 1

    def first_commit(self, sv, der):
        return all_(sv["ci"] == 0)

    def first_restart(self, sv, der):
        return all_(sv["restarted"] < 2)

    def leadership_change(self, sv, der):
        return sv["ctr"][C_NLEADERS] < 2

    def membership_change(self, sv, der):
        return sv["ctr"][C_NMC] < 1

    def multiple_membership_changes(self, sv, der):
        return sv["ctr"][C_NMC] < 2

    def concurrent_leaders(self, sv, der):
        return popcount(der["leaders"], self.S) < 2

    def entry_committed(self, sv, der):
        return sv["feat"][F_COMMIT_SEEN] == 0

    def commit_when_concurrent_leaders(self, sv, der):
        """raft.tla:1165-1176 via the F_CWCL_POS feature lane."""
        two_now = popcount(der["leaders"], self.S) >= 2
        p = sv["feat"][F_CWCL_POS]
        witness = (p > 0) & (sv["ctr"][C_GLOBLEN] >= p + 2)
        return ~(two_now & witness)

    def majority_of_cluster_restarts(self, sv, der):
        """raft.tla:1212-1226 via restart-position feature lanes."""
        llen = sv["llen"]
        off_diag = (ar(self.S, llen)[:, None] !=
                    ar(self.S, llen)[None, :])[..., None]
        nontrivial = any_((llen[:, None] >= 2) & (llen[None, :] >= 1) &
                          off_diag)
        restarted_set = torch.where(sv["restarted"] >= 1,
                                    self._bits(llen)[:, None], 0) \
            .sum(0, dtype=I32)
        maj = 2 * popcount(restarted_set, self.S) > self.S
        gaps_ok = sv["feat"][F_MIN_RESTART_GAP] >= 6
        return ~(nontrivial & maj & gaps_ok)

    def add_successful(self, sv, der):
        return sv["feat"][F_ADDED_SET] == 0

    def membership_change_commits(self, sv, der):
        return sv["feat"][F_MC_COMMITS] < 1

    def multiple_membership_changes_commit(self, sv, der):
        return sv["feat"][F_MC_COMMITS] < 2

    def add_commits(self, sv, der):
        return sv["feat"][F_ADD_COMMITS] == 0

    def newly_joined_become_leader(self, sv, der):
        return sv["feat"][F_NJBL] == 0

    def leader_changes_during_conf_change(self, sv, der):
        return sv["feat"][F_LCDCC] == 0

    # ------------------------------------------------------------------
    # Constraints (raft.tla:1105-1137) — expansion gates
    # ------------------------------------------------------------------

    def bounded_in_flight_messages(self, sv, der, rtb=None):
        return sv["cnt"].sum(0, dtype=I32) <= \
            _rb(rtb, RB_INFLIGHT, self.cfg.max_inflight)

    def bounded_request_vote(self, sv, der):
        mtype = get_field_t(sv["bag"][:, 0],
                            self.lay.header_shifts["mtype"])
        return all_(~((mtype == MT_RVREQ) & (sv["cnt"] > 1)))

    def bounded_log_size(self, sv, der, rtb=None):
        return all_(sv["llen"] <=
                    _rb(rtb, RB_LOGLEN, self.cfg.bounds.max_log_length))

    def bounded_restarts(self, sv, der, rtb=None):
        return all_(sv["restarted"] <=
                    _rb(rtb, RB_RESTARTS, self.cfg.bounds.max_restarts))

    def bounded_timeouts(self, sv, der, rtb=None):
        return all_(sv["timeout"] <=
                    _rb(rtb, RB_TIMEOUTS, self.cfg.bounds.max_timeouts))

    def bounded_terms(self, sv, der, rtb=None):
        return all_(sv["ct"] <=
                    _rb(rtb, RB_TERMS, self.cfg.bounds.max_terms))

    def bounded_client_requests(self, sv, der, rtb=None):
        return sv["ctr"][C_NREQ] <= \
            _rb(rtb, RB_NREQ, self.cfg.bounds.max_client_requests)

    def bounded_tried_membership_changes(self, sv, der, rtb=None):
        return sv["ctr"][C_NTRIED] <= \
            _rb(rtb, RB_TRIED, self.cfg.bounds.max_tried_membership_changes)

    def bounded_membership_changes(self, sv, der, rtb=None):
        return sv["ctr"][C_NMC] <= \
            _rb(rtb, RB_NMC, self.cfg.bounds.max_membership_changes)

    def elections_uncontested(self, sv, der):
        return (sv["st"] == CANDIDATE).sum(0, dtype=I32) <= 1

    def clean_start_until_first_request(self, sv, der):
        pre = (sv["ctr"][C_NLEADERS] < 1) & (sv["ctr"][C_NREQ] < 1)
        cond = all_(sv["restarted"] == 0) & \
            (sv["timeout"].sum(0, dtype=I32) <= 1) & \
            ((sv["st"] == CANDIDATE).sum(0, dtype=I32) <= 1)
        return ~pre | cond

    def clean_start_until_two_leaders(self, sv, der):
        pre = sv["ctr"][C_NLEADERS] < 2
        cond = (sv["restarted"].sum(0, dtype=I32) <= 1) & \
            (sv["timeout"].sum(0, dtype=I32) <= 2)
        return ~pre | cond

    def clean_first_leader_election(self, sv, der):
        """apalache_no_membership/raft.tla:766-770."""
        pre = sv["ctr"][C_NLEADERS] < 1
        cond = all_(sv["restarted"] == 0) & \
            ((sv["st"] == CANDIDATE).sum(0, dtype=I32) <= 1)
        return ~pre | cond

    def commit_when_concurrent_leaders_constraint(self, sv, der):
        """Weak punctuated-search pruning (raft.tla:1182-1186) via the
        F_BL2_SEEN feature lane."""
        return (sv["ctr"][C_GLOBLEN] < 20) | (sv["feat"][F_BL2_SEEN] == 1)

    # ------------------------------------------------------------------
    # Registries (cfg-name -> callable)
    # ------------------------------------------------------------------

    def invariant_fn(self, name: str) -> Callable:
        if self.cfg.apalache_variant and name in (
                "VotesGrantedInv", "LeaderCompleteness"):
            name = name + "_false"
        return INVARIANTS[name].__get__(self)

    def constraint_fn(self, name: str) -> Callable:
        """Every returned callable is uniformly ``(sv, der, rtb=None)``."""
        fn = CONSTRAINTS[name].__get__(self)
        if name in _RTB_CONSTRAINTS:
            return fn
        return lambda sv, der, rtb=None: fn(sv, der)

    def check_T(self, svT, inv_names, con_names):
        """The named invariants and the conjunction of the named
        constraints on batch-last rows [..., N]: (inv bool [n_inv, N],
        con bool [N])."""
        der = self.kern.derived(svT)
        N = svT["ct"].shape[-1]
        dev = svT["ct"].device
        inv = torch.stack([self.invariant_fn(nm)(svT, der)
                           for nm in inv_names]) \
            if inv_names else torch.ones((0, N), dtype=torch.bool,
                                         device=dev)
        con = torch.ones(N, dtype=torch.bool, device=dev)
        for nm in con_names:
            con = con & self.constraint_fn(nm)(svT, der)
        return inv, con

    def action_fn(self, name: str) -> Callable:
        """ACTION_CONSTRAINT device form: (parent_sv, cand_sv) -> ok [N]
        over batch-last rows, the parent gathered per candidate column
        (raft.tla:1207-1210 semantics: a violating transition is not
        generated)."""
        try:
            return ACTION_CONSTRAINTS_V[name].__get__(self)
        except KeyError:
            raise KeyError(
                f"unknown action constraint {name!r} for spec 'raft'; "
                f"known: {', '.join(sorted(ACTION_CONSTRAINTS_V))}"
            ) from None

    def commit_when_concurrent_leaders_action_constraint(
            self, parent_sv, cand_sv):
        """raft.tla:1207-1210: past trace length 20, kill transitions
        that leave any candidate alive (punctuated-search pruning)."""
        deep = parent_sv["ctr"][C_GLOBLEN] >= 20
        no_cand = all_(cand_sv["st"] != CANDIDATE)
        return ~deep | no_cand


INVARIANTS: Dict[str, Callable] = {
    "LeaderVotesQuorum": Predicates.leader_votes_quorum,
    "CandidateTermNotInLog": Predicates.candidate_term_not_in_log,
    "ElectionSafety": Predicates.election_safety,
    "LogMatching": Predicates.log_matching,
    "VotesGrantedInv": Predicates.votes_granted_inv,
    "VotesGrantedInv_false": Predicates.votes_granted_inv_false,
    "QuorumLogInv": Predicates.quorum_log_inv,
    "MoreUpToDateCorrect": Predicates.more_up_to_date_correct,
    "LeaderCompleteness": Predicates.leader_completeness,
    "LeaderCompleteness_false": Predicates.leader_completeness_false,
    "OneAtATimeMembershipChangeOK":
        Predicates.one_at_a_time_membership_change_ok,
    "BoundedTrace": Predicates.bounded_trace,
    "FirstBecomeLeader": Predicates.first_become_leader,
    "FirstCommit": Predicates.first_commit,
    "FirstRestart": Predicates.first_restart,
    "LeadershipChange": Predicates.leadership_change,
    "MembershipChange": Predicates.membership_change,
    "MultipleMembershipChanges": Predicates.multiple_membership_changes,
    "ConcurrentLeaders": Predicates.concurrent_leaders,
    "EntryCommitted": Predicates.entry_committed,
    "CommitWhenConcurrentLeaders":
        Predicates.commit_when_concurrent_leaders,
    "MajorityOfClusterRestarts": Predicates.majority_of_cluster_restarts,
    "AddSucessful": Predicates.add_successful,
    "MembershipChangeCommits": Predicates.membership_change_commits,
    "MultipleMembershipChangesCommit":
        Predicates.multiple_membership_changes_commit,
    "AddCommits": Predicates.add_commits,
    "NewlyJoinedBecomeLeader": Predicates.newly_joined_become_leader,
    "LeaderChangesDuringConfChange":
        Predicates.leader_changes_during_conf_change,
}

# The scenario ("Test cases") properties of raft.cfg:51-76 — negated
# reachability targets, the invariants whose "violation" is a wanted
# witness rather than a bug (the CLI's ``trace --target`` set).
SCENARIO_PROPERTIES = (
    "BoundedTrace",
    "FirstBecomeLeader",
    "FirstCommit",
    "FirstRestart",
    "LeadershipChange",
    "MembershipChange",
    "MultipleMembershipChanges",
    "ConcurrentLeaders",
    "EntryCommitted",
    "CommitWhenConcurrentLeaders",
    "MajorityOfClusterRestarts",
    "AddSucessful",
    "MembershipChangeCommits",
    "MultipleMembershipChangesCommit",
    "AddCommits",
    "NewlyJoinedBecomeLeader",
    "LeaderChangesDuringConfChange",
)

ACTION_CONSTRAINTS_V: Dict[str, Callable] = {
    "CommitWhenConcurrentLeaders_action_constraint":
        Predicates.commit_when_concurrent_leaders_action_constraint,
}

CONSTRAINTS: Dict[str, Callable] = {
    "BoundedInFlightMessages": Predicates.bounded_in_flight_messages,
    "BoundedRequestVote": Predicates.bounded_request_vote,
    "BoundedLogSize": Predicates.bounded_log_size,
    "BoundedRestarts": Predicates.bounded_restarts,
    "BoundedTimeouts": Predicates.bounded_timeouts,
    "BoundedTerms": Predicates.bounded_terms,
    "BoundedClientRequests": Predicates.bounded_client_requests,
    "BoundedTriedMembershipChanges":
        Predicates.bounded_tried_membership_changes,
    "BoundedMembershipChanges": Predicates.bounded_membership_changes,
    "ElectionsUncontested": Predicates.elections_uncontested,
    "CleanStartUntilFirstRequest":
        Predicates.clean_start_until_first_request,
    "CleanStartUntilTwoLeaders":
        Predicates.clean_start_until_two_leaders,
    "CleanFirstLeaderElection":
        Predicates.clean_first_leader_election,
    "CommitWhenConcurrentLeaders_constraint":
        Predicates.commit_when_concurrent_leaders_constraint,
}

# the Bounded* constraints that read the runtime-bounds vector
_RTB_CONSTRAINTS = frozenset((
    "BoundedInFlightMessages", "BoundedLogSize", "BoundedRestarts",
    "BoundedTimeouts", "BoundedTerms", "BoundedClientRequests",
    "BoundedTriedMembershipChanges", "BoundedMembershipChanges"))
