"""The Raft spec as a ``SpecIR``: the action-family registry and the
per-family density table, assembled with the port's layout, codec,
kernels, predicates and fingerprinter.

Lane order, guard and delta declarations and densities are those of
the reference package's ``spec/raft_ir.py`` — the candidate
enumeration order (and with it every global state id) depends on them.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..config import (ModelConfig, NEXT_ASYNC_CRASH, NEXT_DYNAMIC,
                      NEXT_FULL)
from . import U32_KEYS, Family, SpecIR


def build_families(lay) -> List[Family]:
    from ..config import CANDIDATE, FOLLOWER, LEADER, NIL, VALUE_ENTRY
    from ..engine.expand import d_set
    from ..ops.codec import (C_GLOBLEN, C_NLEADERS, C_NREQ, C_OVERFLOW,
                             F_BL2_SEEN, F_LAST_RESTART_POS, F_LCDCC,
                             F_MIN_RESTART_GAP, F_NJBL)
    from ..ops.kernels import RaftKernels
    cfg = lay.cfg
    kern = RaftKernels(lay)
    S, K = lay.S, lay.K
    fams: List[Family] = []

    def grid(*ranges):
        arrs = np.meshgrid(*[np.asarray(r, np.int32) for r in ranges],
                           indexing="ij")
        return tuple(a.ravel() for a in arrs)

    ij = grid(range(S), range(S))
    ij_ne = tuple(a[ij[0] != ij[1]] for a in ij)        # i != j lanes
    iv = grid(range(S), list(cfg.values))
    i_ = grid(range(S))
    k_ = grid(range(K))

    # ---- delta-algebra declarations (the delta group of
    # engine/expand.py): the affine families declare their writes as
    # (slot, source, weight) triples over the flat int32 state view;
    # the data-dependent pieces ride the kernels' delta_features
    # (ops/kernels.delta_feature_offsets).  Bag inserts, the Receive
    # branch family and AdvanceCommitIndex's quorum scan are not affine
    # and keep their kernels.

    def d_timeout(off, lay, i):
        F, FS = off["_feat"], off["_src_f"]
        X, C = off["_src_x"], off["_const"]
        return (
            d_set(off, off["st"] + i, CANDIDATE) +
            # ct' = min(ct+1, cap): the room feature IS the increment
            [(off["ct"] + i, FS + F["ctroom"] + i, 1)] +
            d_set(off, off["vf"] + i, NIL) +
            [(off["vr"] + i, X + off["vr"] + i, -1),
             (off["vg"] + i, X + off["vg"] + i, -1),
             (off["timeout"] + i, C, 1),
             # overflow = 1 - room
             (off["ctr"] + C_OVERFLOW, C, 1),
             (off["ctr"] + C_OVERFLOW, FS + F["ctroom"] + i, -1),
             (off["ctr"] + C_GLOBLEN, C, 1)])

    def d_become_leader(off, lay, i):
        F, FS = off["_feat"], off["_src_f"]
        X, C = off["_src_x"], off["_const"]
        tr = d_set(off, off["st"] + i, LEADER)
        for j in range(lay.S):
            nij = off["ni"] + i * lay.S + j
            mij = off["mi"] + i * lay.S + j
            # ni' = 1 + llen[i]; mi' = 0
            tr += [(nij, C, 1), (nij, X + off["llen"] + i, 1),
                   (nij, X + nij, -1), (mij, X + mij, -1)]
        tr += [(off["ctr"] + C_NLEADERS, C, 1),
               # the three feat maxes, pre-differenced in the features
               (off["feat"] + F_BL2_SEEN, FS + F["bl2"] + i, 1),
               (off["feat"] + F_NJBL, FS + F["njbl"] + i, 1),
               (off["feat"] + F_LCDCC, FS + F["lcdcc"], 1),
               (off["ctr"] + C_GLOBLEN, C, 1)]
        return tr

    def d_client_request(off, lay, i, v):
        F, FS, C = off["_feat"], off["_src_f"], off["_const"]
        vb = lay.value_bits
        cv = (VALUE_ENTRY << vb) | int(v)     # the term-free entry bits
        tshift = 1 << (1 + vb)                # term field scale
        tr = []
        for p in range(lay.Lcap):
            lp = off["log"] + i * lay.Lcap + p
            fp = i * lay.Lcap + p
            # log[i, llen] = pack_entry(ct, VALUE_ENTRY, v): the llen
            # one-hot places it, × ct scales the term field, × old log
            # word cancels the overwritten value — overflow zeroes all
            tr += [(lp, FS + F["croh"] + fp, cv),
                   (lp, FS + F["crohct"] + fp, tshift),
                   (lp, FS + F["crohold"] + fp, -1)]
        tr += [(off["llen"] + i, FS + F["crroom"] + i, 1),
               (off["ctr"] + C_NREQ, C, 1),
               (off["ctr"] + C_OVERFLOW, C, 1),
               (off["ctr"] + C_OVERFLOW, FS + F["crroom"] + i, -1)]
        return tr

    def d_update_term(off, lay, k):
        # ct[dst]=mterm, st[dst]=FOLLOWER, vf[dst]=NIL: the [K, S]
        # dst-one-hot features carry (new - old) per server, so each
        # write is one add per (slot, server); the message is not
        # consumed and glob does not advance (kernels.update_term)
        F, FS = off["_feat"], off["_src_f"]
        tr = []
        for j in range(lay.S):
            kj = k * lay.S + j
            tr += [(off["ct"] + j, FS + F["utdct"] + kj, 1),
                   (off["st"] + j, FS + F["utdst"] + kj, 1),
                   (off["vf"] + j, FS + F["utdvf"] + kj, 1)]
        return tr

    def d_restart(off, lay, i):
        F, FS = off["_feat"], off["_src_f"]
        X, C = off["_src_x"], off["_const"]
        tr = d_set(off, off["st"] + i, FOLLOWER) + [
            (off["vr"] + i, X + off["vr"] + i, -1),
            (off["vg"] + i, X + off["vg"] + i, -1),
            (off["ci"] + i, X + off["ci"] + i, -1)]
        for j in range(lay.S):
            nij = off["ni"] + i * lay.S + j
            mij = off["mi"] + i * lay.S + j
            # ni' = 1; mi' = 0 (nextIndex/matchIndex reset)
            tr += [(nij, C, 1), (nij, X + nij, -1),
                   (mij, X + mij, -1)]
        tr += [(off["restarted"] + i, C, 1),
               # last_restart_pos' = globlen + 1 (set via cancel-old)
               (off["feat"] + F_LAST_RESTART_POS, C, 1),
               (off["feat"] + F_LAST_RESTART_POS,
                X + off["ctr"] + C_GLOBLEN, 1),
               (off["feat"] + F_LAST_RESTART_POS,
                X + off["feat"] + F_LAST_RESTART_POS, -1),
               # min_restart_gap' = min(old, gap): pre-differenced
               (off["feat"] + F_MIN_RESTART_GAP, FS + F["rgap"], 1),
               (off["ctr"] + C_GLOBLEN, C, 1)]
        return tr

    def d_duplicate(off, lay, k):
        return [(off["cnt"] + k, off["_const"], 1)]

    def d_drop(off, lay, k):
        X = off["_src_x"]
        tr = [(off["cnt"] + k, X + off["cnt"] + k, -1)]
        for w in range(lay.msg_words):
            bw = off["bag"] + k * lay.msg_words + w
            tr.append((bw, X + bw, -1))
        return tr

    fams.append(Family(
        "RequestVote", kern.request_vote, ij,
        lambda i, j: f"RequestVote({i},{j})",
        guard=lambda off, lay, i, j: (
            [(off["cand"] + i, 1), (off["needvote"] + i * lay.S + j, 1)],
            2)))
    fams.append(Family(
        "BecomeLeader", kern.become_leader, i_,
        lambda i: f"BecomeLeader({i})",
        guard=lambda off, lay, i: (
            [(off["cand"] + i, 1), (off["blq"] + i, 1)], 2),
        delta=d_become_leader))
    fams.append(Family(
        "ClientRequest", kern.client_request, iv,
        lambda i, v: f"ClientRequest({i},{v})",
        guard=lambda off, lay, i, v: ([(off["leader"] + i, 1)], 1),
        delta=d_client_request))
    fams.append(Family(
        "AdvanceCommitIndex", kern.advance_commit_index, i_,
        lambda i: f"AdvanceCommitIndex({i})",
        guard=lambda off, lay, i: ([(off["leader"] + i, 1)], 1)))
    fams.append(Family(
        "AppendEntries", kern.append_entries, ij_ne,
        lambda i, j: f"AppendEntries({i},{j})",
        guard=lambda off, lay, i, j: (
            [(off["leader"] + i, 1), (off["cfg"] + i * lay.S + j, 1)],
            2)))
    fams.append(Family(
        "UpdateTerm", kern.update_term, k_,
        lambda k: f"UpdateTerm[slot{k}]",
        guard=lambda off, lay, k: ([(off["ut"] + k, 1)], 1),
        delta=d_update_term))
    fams.append(Family(
        "CocDiscard", kern.coc_discard, k_,
        lambda k: f"CocDiscard[slot{k}]",
        guard=lambda off, lay, k: ([(off["cocd"] + k, 1)], 1)))
    fams.append(Family(
        "Receive", kern.receive_main, k_,
        lambda k: f"Receive[slot{k}]",
        guard=lambda off, lay, k: ([(off["recv"] + k, 1)], 1)))
    fams.append(Family(
        "Timeout", kern.timeout, i_,
        lambda i: f"Timeout({i})",
        guard=lambda off, lay, i: (
            [(off["folc"] + i, 1), (off["cfg"] + i * lay.S + i, 1)], 2),
        delta=d_timeout))
    if cfg.next_family in (NEXT_ASYNC_CRASH, NEXT_FULL, NEXT_DYNAMIC):
        fams.append(Family(
            "Restart", kern.restart, i_,
            lambda i: f"Restart({i})",
            guard=lambda off, lay, i: ([], 0),    # unconditional
            delta=d_restart))
    if cfg.next_family in (NEXT_FULL, NEXT_DYNAMIC):
        fams.append(Family(
            "Duplicate", kern.duplicate_message,
            k_, lambda k: f"Duplicate[slot{k}]",
            guard=lambda off, lay, k: ([(off["cnt1"] + k, 1)], 1),
            delta=d_duplicate))
        fams.append(Family(
            "Drop", kern.drop_message,
            k_, lambda k: f"Drop[slot{k}]",
            guard=lambda off, lay, k: ([(off["cnt1"] + k, 1)], 1),
            delta=d_drop))
    if cfg.next_family == NEXT_DYNAMIC:
        fams.append(Family(
            "AddNewServer", kern.add_new_server, ij,
            lambda i, j: f"AddNewServer({i},{j})",
            # j ∉ config enters with weight -1 and no threshold share
            guard=lambda off, lay, i, j: (
                [(off["leader"] + i, 1),
                 (off["cfg"] + i * lay.S + j, -1)], 1)))
        fams.append(Family(
            "DeleteServer", kern.delete_server, ij_ne,
            lambda i, j: f"DeleteServer({i},{j})",
            guard=lambda off, lay, i, j: (
                [(off["leader"] + i, 1), (off["folc"] + j, 1),
                 (off["cfg"] + i * lay.S + j, 1)], 3)))
    return fams


# Expected enabled-lane density per parent state, by family (measured
# on the BASELINE configs by the reference package): the engine sizes
# the per-family materialization caps from these, cap_f = chunk *
# min(lanes, d).  Throughput tuning, not correctness bounds: overflow
# grows the cap and replays the level.
FAMILY_DENSITY = {
    "Restart": 1 << 30, "Timeout": 1 << 30,
    "RequestVote": 2, "BecomeLeader": 1, "ClientRequest": 2,
    "AdvanceCommitIndex": 2, "AppendEntries": 2,
    "UpdateTerm": 2, "CocDiscard": 1, "Receive": 4,
    "Duplicate": 4, "Drop": 4, "AddNewServer": 2, "DeleteServer": 2,
}


# ---------------------------------------------------------------------------
# The random-walk engine's punctuated-restart progress ladder
# (sim/walker.py): leader elected < membership changes appended <
# latest-ConfigEntry replication count at a current leader.
# ---------------------------------------------------------------------------

_SCORE_LEADER = 1 << 20
_SCORE_NMC = 1 << 10


def sim_progress(kern, lay):
    """(kernels, layout) -> the monotone scenario score of batch-last
    states: svT -> int32 [W]."""
    import torch

    from ..config import LEADER
    from ..ops.codec import C_NLEADERS, C_NMC

    def score(svT):
        derT = kern.derived(svT)
        leader_seen = (svT["ctr"][C_NLEADERS] > 0).to(torch.int32)
        nmc = svT["ctr"][C_NMC]
        maxcfg = derT["maxcfg"]                       # [S, W]
        repl = (svT["mi"] >= maxcfg[:, None, :]).sum(
            1, dtype=torch.int32)                     # [S, W]
        is_l = (svT["st"] == LEADER) & (maxcfg > 0)
        repl = torch.where(is_l, repl, 0).amax(0)
        return leader_seen * _SCORE_LEADER + \
            nmc.clamp(max=_SCORE_LEADER // _SCORE_NMC - 1) * \
            _SCORE_NMC + repl.clamp(max=_SCORE_NMC - 1)

    return score


def build_ir() -> SpecIR:
    from ..models import predicates as OP
    from ..models.explore import _walk_key, explore
    from ..models.golden import prefix_pin_seeds
    from ..models.raft import (init_state, state_from_obj, state_to_obj,
                               successors, symmetry_perms)
    from ..ops import codec
    from ..ops.kernels import RaftKernels
    from ..ops.layout import Layout
    from ..ops.vpredicates import (CONSTRAINTS as VC, INVARIANTS as VI,
                                   Predicates, SCENARIO_PROPERTIES)

    def make_fingerprinter(cfg, sym_canon="minperm"):
        from ..engine.fingerprint import RaftFingerprinter
        return RaftFingerprinter(cfg, sym_canon=sym_canon)

    def server_signature(fpr, svT, prep):
        from ..engine.fingerprint import raft_server_signature
        return raft_server_signature(fpr, svT, prep)

    return SpecIR(
        name="raft",
        make_layout=Layout,
        init_state=init_state,
        encode=codec.encode,
        decode=codec.decode,
        narrow=codec.narrow_t,
        widen=codec.widen_t,
        view_keys=codec.VIEW_KEYS,
        nonview_keys=codec.NONVIEW_KEYS,
        state_to_obj=state_to_obj,
        state_from_obj=state_from_obj,
        make_kernels=RaftKernels,
        build_families=build_families,
        family_density=dict(FAMILY_DENSITY),
        make_predicates=Predicates,
        make_fingerprinter=make_fingerprinter,
        symmetry_perms=symmetry_perms,
        server_signature=server_signature,
        scenario_properties=SCENARIO_PROPERTIES,
        known_invariants=frozenset(VI) | frozenset(OP.INVARIANTS),
        known_constraints=frozenset(VC) | frozenset(OP.CONSTRAINTS),
        known_action_constraints=frozenset(OP.ACTION_CONSTRAINTS),
        glob_dependent=frozenset(OP.GLOB_DEPENDENT),
        oracle_explore=explore,
        oracle_successors=successors,
        oracle_walk_key=_walk_key,
        prefix_pin_seeds=prefix_pin_seeds,
        sim_progress=sim_progress,
        default_config=ModelConfig,
        u32_keys=U32_KEYS["raft"],
        version=1,
    )
