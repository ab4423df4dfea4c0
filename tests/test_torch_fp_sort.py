"""The port's orbit-sort canonicalizer held exactly against the JAX
package's (integer hashes: zero tolerance): the raft server signature,
sort-mode fingerprints, the hard/tie masks of ``sort_debug`` (with
1-WL-hard states that take the min-over-perms fallback) and the mode
resolution, at S=3 (P=6, sort forced), S=4 with an inside/outside
block pair (P=6, sort forced) and the BASELINE config #5 shape (S=5,
P=120, "auto" resolves to sort) on sampled oracle-reachable states.

One jitted JAX function per config for the whole module gives the
reference's fingerprints, signatures and masks together.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import (Bounds as JB, ModelConfig as JC,
                                 NEXT_ASYNC as J_ASYNC,
                                 NEXT_DYNAMIC as J_DYN)
from raft_tla_tpu.ops import codec as jcodec
from raft_tla_tpu.ops.layout import Layout as JLayout

from raft_tla_tpu_torch import convert as cvt
from raft_tla_tpu_torch.config import (Bounds, ModelConfig, NEXT_ASYNC,
                                       NEXT_DYNAMIC)
from raft_tla_tpu_torch.engine.fingerprint import (
    RaftFingerprinter, lex_min_perms, raft_server_signature,
    resolve_sym_canon)

from conftest import cached_explore

torch.set_num_threads(1)

CASES = {
    # 3 servers, all initial: one symmetry block of 3 (P = 6)
    "s3": dict(n_servers=3, init_servers=(0, 1, 2), values=(1,),
               family="async", max_inflight_override=2,
               bounds=dict(max_log_length=1, max_timeouts=1,
                           max_client_requests=1), depth=9),
    # 4 servers, 3 initial: blocks {0,1,2} and {3} (P = 6), membership
    # changes put ConfigEntry payloads in logs and messages
    "s4": dict(n_servers=4, init_servers=(0, 1, 2), values=(1,),
               family="dyn", max_inflight_override=3,
               bounds=dict(max_log_length=1, max_timeouts=1,
                           max_client_requests=1,
                           max_membership_changes=1), depth=7),
    # BASELINE config #5's shape: 5 servers, all initial (P = 120)
    "s5": dict(n_servers=5, init_servers=(0, 1, 2, 3, 4), values=(1,),
               family="async", max_inflight_override=4,
               bounds=dict(max_log_length=4, max_timeouts=3,
                           max_client_requests=3), depth=3),
}
N_SAMPLE = 200
# S=5 states whose servers differ only in the votedFor functional graph
# (every server has in- and out-degree 1): 1-WL refinement cannot rank
# them, so each has an uncertified tie and takes the fallback; the
# first two are isomorphic 5-cycles, the others other cycle types
HARD_VF = [(1, 2, 3, 4, 0), (2, 3, 4, 0, 1), (1, 2, 0, 4, 3),
           (1, 0, 2, 4, 3)]


def _cfgs(case):
    c = dict(CASES[case])
    c.pop("depth")
    fam = c.pop("family")
    b = c.pop("bounds")
    jc = JC(next_family={"async": J_ASYNC, "dyn": J_DYN}[fam],
            bounds=JB.make(**b), symmetry=True, **c)
    tc = ModelConfig(next_family={"async": NEXT_ASYNC,
                                  "dyn": NEXT_DYNAMIC}[fam],
                     bounds=Bounds.make(**b), symmetry=True, **c)
    assert repr(jc) == repr(tc)
    return jc, tc


_DATA = {}


def _data(case):
    """(encoded rows [N, ...], the JAX sort fingerprinter's outputs:
    fingerprints [N, T], signatures [S, N], hard and tie masks [N];
    the state pairs): sampled reachable states of the config with
    symmetry off (so relabeled twins appear), and at S=5 the hard
    fixtures first."""
    if case not in _DATA:
        import jax
        import jax.numpy as jnp
        from raft_tla_tpu.engine.fingerprint import (
            RaftFingerprinter as JF, raft_server_signature as jsig)
        from raft_tla_tpu.models.raft import init_state
        jc, _tc = _cfgs(case)
        r = cached_explore(jc.with_(symmetry=False),
                           max_depth=CASES[case]["depth"], keep_states=True)
        pairs = list(r.states.values())
        rng = np.random.RandomState(7)
        pick = rng.choice(len(pairs), size=min(N_SAMPLE, len(pairs)),
                          replace=False)
        pairs = [pairs[i] for i in sorted(pick)]
        if case == "s5":
            sv, h = init_state(jc)
            pairs = [(sv._replace(vf=vf), h) for vf in HARD_VF] + pairs
        lay = JLayout(jc)
        arrs = jcodec.stack([jcodec.encode(lay, s, h) for s, h in pairs])
        jf = JF(jc, sym_canon="sort")

        def ref(svb):
            svT = {k: jnp.moveaxis(v, 0, -1) for k, v in svb.items()}
            prep = jf._prep(svT, 1)
            _h0, hard, tie = jf._sort_hashes(prep, svT)
            return (jf.fingerprint_batch(svb), jsig(jf, svT, prep), hard,
                    tie)

        out = jax.jit(ref)({k: jnp.asarray(v) for k, v in arrs.items()})
        want = dict(zip(("fp", "sig", "hard", "tie"),
                        (np.asarray(x) for x in out)))
        _DATA[case] = (arrs, want, pairs)
    return _DATA[case]


def _partition(keys):
    groups = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return sorted(tuple(v) for v in groups.values())


def test_resolve_sym_canon_matches_jax():
    from raft_tla_tpu.engine.fingerprint import resolve_sym_canon as jres
    for case in CASES:
        jc, tc = _cfgs(case)
        for sym in (True, False):
            for mode in ("auto", "sort", "minperm"):
                got = resolve_sym_canon(tc.with_(symmetry=sym), mode)
                assert got == jres(jc.with_(symmetry=sym), mode)
    assert resolve_sym_canon(_cfgs("s5")[1], "auto") == "sort"
    assert resolve_sym_canon(_cfgs("s3")[1], "auto") == "minperm"
    with pytest.raises(ValueError, match="sym_canon"):
        resolve_sym_canon(_cfgs("s3")[1], "fast")
    # the fingerprinter takes a resolved mode only
    with pytest.raises(ValueError, match="resolved"):
        RaftFingerprinter(_cfgs("s3")[1], "auto")


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_signature_matches_jax(case):
    arrs, want, _p = _data(case)
    tf = RaftFingerprinter(_cfgs(case)[1], sym_canon="sort")
    svT = cvt.rows_to_torch(arrs)
    got = raft_server_signature(tf, svT, tf._prep(svT))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want["sig"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_fingerprints_match_jax(case):
    """Sort-mode values equal the JAX package's bit for bit; the sort
    partition is the minperm one; the two modes' values differ."""
    arrs, ref, _p = _data(case)
    want = ref["fp"]
    tc = _cfgs(case)[1]
    svT = cvt.rows_to_torch(arrs)
    tf = RaftFingerprinter(tc, sym_canon="sort")
    got = cvt.words_to_numpy(tf.fingerprint_batch_T(svT)).T
    np.testing.assert_array_equal(got, want)
    mp = cvt.words_to_numpy(
        RaftFingerprinter(tc, sym_canon="minperm").fingerprint_batch_T(
            svT)).T
    assert _partition(map(tuple, got)) == _partition(map(tuple, mp))
    assert not np.array_equal(got, mp)
    # batch-first and single-state entry points give the same values
    svb = {k: v.movedim(-1, 0) for k, v in svT.items()}
    np.testing.assert_array_equal(
        cvt.words_to_numpy(tf.fingerprint_batch(svb).T).T, got)
    np.testing.assert_array_equal(
        tf.fingerprint({k: v[0] for k, v in svb.items()}).numpy()
        .view(np.uint32), got[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_debug_masks_match_jax(case):
    """hard/tie masks equal JAX's; at S=5 the 1-WL-hard fixtures are
    hard and their partition is the oracle's orbit partition."""
    from raft_tla_tpu.models.explore import canonicalize, symmetry_perms
    arrs, want, pairs = _data(case)
    tf = RaftFingerprinter(_cfgs(case)[1], sym_canon="sort")
    got = tf.sort_debug({k: v.movedim(-1, 0)
                         for k, v in cvt.rows_to_torch(arrs).items()})
    np.testing.assert_array_equal(got["hard"], want["hard"])
    np.testing.assert_array_equal(got["tie"], want["tie"])
    assert got["tie"].any()
    if case == "s5":
        n = len(HARD_VF)
        assert got["hard"][:n].all() and got["tie"][:n].all()
        jc = _cfgs(case)[0]
        perms = symmetry_perms(jc)
        orbit = _partition([canonicalize(s, perms, jc)
                            for s, _h in pairs[:n]])
        assert orbit == [(0, 1), (2,), (3,)]
        assert _partition(map(tuple, want["fp"][:n])) == orbit


def test_fixed_width_fallback_equals_exact():
    """The engine's sync-free form (hard lanes gathered into a buffer of
    hcap lanes) equals the exact form whenever the count fits, and
    reports the count when it does not."""
    arrs, ref, _p = _data("s5")
    want = ref["fp"]
    tf = RaftFingerprinter(_cfgs("s5")[1], sym_canon="sort")
    svT = cvt.rows_to_torch(arrs)
    n_hard = len(HARD_VF)
    for hcap in (n_hard, 3 * n_hard):
        fp, nh = tf.fingerprint_chunk_T(svT, hcap)
        assert int(nh) == n_hard
        np.testing.assert_array_equal(cvt.words_to_numpy(fp).T, want)
    fp, nh = tf.fingerprint_chunk_T(svT, n_hard - 1)
    assert int(nh) > n_hard - 1
    assert (cvt.words_to_numpy(fp).T != want).any(1).sum() == 1


@pytest.mark.parametrize("T", [2, 4])
def test_lex_min_perms_equals_running_lex_min(T):
    """The packed-int64 reduction picks the running lexicographic
    unsigned min, bit 31 and equal leading words included."""
    rng = np.random.RandomState(T)
    h = rng.randint(0, 1 << 32, size=(9, T, 300), dtype=np.uint64)
    h = h.astype(np.uint32)
    h[:, 0, :100] = h[0, 0, :100]                # ties on the first word
    h[3, :, 100:120] = 0xFFFFFFFF
    h[:, :, 120:130] = 0x80000000
    ht = torch.from_numpy(h.view(np.int32))
    tf = RaftFingerprinter(_cfgs("s3")[1].with_(fp128=T == 4))
    best = ht[0]
    for p in range(1, ht.shape[0]):
        best = tf._lex_min(best, ht[p])
    assert torch.equal(lex_min_perms(ht), best)
