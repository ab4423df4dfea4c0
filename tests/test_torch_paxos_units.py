"""The paxos tenant's pieces against the JAX package's, on a seeded
sample of reachable states: the codec round trip, the u32 words of
``msgs`` (bit 31 included) through the port's conversions, ``derived``,
the guard and delta features, the four action kernels on every lane
and the six predicates, bit for bit; the ``PaxosConfig`` repr (the
checkpoint-compat key) character for character.  The reference's
single-state functions run vmapped over the sample; no engine is
compiled here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu.spec.paxos import kernels as JK, layout as JL
from raft_tla_tpu.spec.paxos import vpredicates as JV
from raft_tla_tpu.spec.paxos.config import PaxosConfig as JConfig

from raft_tla_tpu_torch.convert import (arrays_to_numpy, rows_to_numpy,
                                        rows_to_torch, storage_to_numpy)
from raft_tla_tpu_torch.spec import get_spec
from raft_tla_tpu_torch.spec.paxos import layout as TL
from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig
from raft_tla_tpu_torch.spec.paxos.kernels import PaxosKernels
from raft_tla_tpu_torch.spec.paxos.vpredicates import PaxosPredicates

torch.set_num_threads(1)

CFGS = {"stock": dict(),
        "2inst": dict(n_instances=2, n_ballots=1, symmetry=False),
        "n4": dict(n_servers=4, n_values=1)}
N_SAMPLE = 96


def sample(kw, n=N_SAMPLE, seed=0):
    """(cfg, layout, batch-first numpy rows) of n reachable states drawn
    with a seeded numpy generator from the oracle's state set."""
    cfg = PaxosConfig(**kw)
    ir = get_spec("paxos")
    res = ir.oracle_explore(cfg.with_(symmetry=False), keep_states=True,
                            max_states=4000)
    pairs = list(res.states.values())
    pick = np.random.RandomState(seed).choice(len(pairs),
                                              min(n, len(pairs)), False)
    lay = ir.make_layout(cfg)
    rows = [ir.encode(lay, *pairs[i]) for i in sorted(pick)]
    return cfg, lay, {k: np.stack([r[k] for r in rows]) for k in rows[0]}


@pytest.fixture(scope="module", params=sorted(CFGS))
def case(request):
    kw = CFGS[request.param]
    cfg, lay, arrs = sample(kw)
    jlay = JL.PaxosLayout(JConfig(**kw))
    svb = {k: jnp.asarray(v) for k, v in arrs.items()}
    return dict(cfg=cfg, lay=lay, arrs=arrs, jlay=jlay, svb=svb,
                svT=rows_to_torch(arrs, u32_keys=("msgs",)),
                kern=PaxosKernels(lay), jkern=JK.PaxosKernels(jlay))


def _bl(x):
    """A batch-last torch tensor -> batch-first numpy (bools as bool)."""
    return x.movedim(-1, 0).cpu().numpy()


def test_config_repr_is_the_reference_s():
    for kw in [dict(), dict(n_servers=5, fp128=True),
               dict(n_instances=2, symmetry=False,
                    invariants=("Agreement", "ValueChosen"))]:
        assert repr(PaxosConfig(**kw)) == repr(JConfig(**kw))
        assert PaxosConfig(**kw).quorums == JConfig(**kw).quorums
    assert PaxosConfig.spec == "paxos" and "spec" not in repr(PaxosConfig())
    with pytest.raises(ValueError, match="n_servers must be in 1..7"):
        PaxosConfig(n_servers=8)


def test_codec_round_trip(case):
    """encode -> the port's tensors -> numpy -> decode gives the oracle
    state back, and the layout's bit universe is the reference's."""
    ir = get_spec("paxos")
    lay, arrs = case["lay"], case["arrs"]
    assert lay.universe == case["jlay"].universe
    back = rows_to_numpy(case["svT"], ir.u32_keys)
    assert back["msgs"].dtype == np.uint32
    for i in range(len(arrs["mb"])):
        one = {k: v[i] for k, v in back.items()}
        want = JL.decode(case["jlay"], {k: v[i] for k, v in arrs.items()})
        assert ir.decode(lay, one) == want
        again = ir.encode(lay, *ir.decode(lay, one))
        for k in ir.view_keys:
            assert np.array_equal(again[k], arrs[k][i]), k


def test_msgs_bit31_survives_as_uint32():
    """A paxos row with bit 31 of a ``msgs`` word set goes through
    rows_to_torch -> narrow -> storage_to_numpy and comes back as the
    np.uint32 the reference stores; a raft ``bag`` word keeps its
    uint32 form too."""
    cfg = PaxosConfig(n_instances=2)
    ir = get_spec("paxos")
    lay = ir.make_layout(cfg)
    assert lay.msg_words == 5 and lay.n_msg_bits == 144
    row = ir.encode(lay, *ir.init_state(cfg))
    row["msgs"] = np.array([0x80000001, 0xFFFFFFFF, 0x80000000, 0, 7],
                           np.uint32)
    arrs = {k: v[None] for k, v in row.items()}
    t = rows_to_torch(arrs, u32_keys=ir.u32_keys)
    assert t["msgs"].dtype == torch.int32 and int(t["msgs"][0, 0]) < 0
    got = storage_to_numpy({k: v.movedim(-1, 0) for k, v in
                            ir.narrow(lay, t).items()}, ir.u32_keys)
    want = JL.narrow(JL.PaxosLayout(JConfig(n_instances=2)), arrs)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    # the default (every spec's u32 keys) agrees, and ``decode`` reads
    # bit 31 back as the message it encodes
    dflt = arrays_to_numpy({k: v.movedim(-1, 0) for k, v in t.items()})
    assert dflt["msgs"].dtype == np.uint32 and \
        np.array_equal(dflt["msgs"], arrs["msgs"])
    sv, _h = ir.decode(lay, {k: v[0] for k, v in dflt.items()})
    assert lay.universe[31] in sv.msgs and lay.universe[64 + 31] in sv.msgs
    # a raft bag word: unchanged by the repair
    from raft_tla_tpu_torch.config import Bounds, ModelConfig
    rcfg = ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                       bounds=Bounds.make(max_log_length=1))
    rir = get_spec("raft")
    assert rir.u32_keys == ("bag",)
    rl = rir.make_layout(rcfg)
    rrow = {k: v[None] for k, v in
            rir.encode(rl, *rir.init_state(rcfg)).items()}
    rrow["bag"] = rrow["bag"] | np.uint32(0x80000000)
    rt = rows_to_torch(rrow, u32_keys=rir.u32_keys)
    rb = storage_to_numpy({k: v.movedim(-1, 0) for k, v in
                           rir.narrow(rl, rt).items()}, rir.u32_keys)
    assert rb["bag"].dtype == np.uint32 and \
        np.array_equal(rb["bag"], rrow["bag"])


def test_derived_and_features(case):
    kern, jkern, svb, svT = (case["kern"], case["jkern"], case["svb"],
                             case["svT"])
    jder = jax.vmap(jkern.derived)(svb)
    der = kern.derived(svT)
    for k in ("bits", "b1a", "b1b", "b2a", "b2b", "no2a", "p2a", "chosen"):
        got, want = _bl(der[k]), np.asarray(jder[k])
        assert np.array_equal(got.astype(want.dtype), want), k
    jg = jax.vmap(lambda s: jkern.guard_features(s, jkern.derived(s)))(svb)
    g = kern.guard_features(svT, der)
    assert g.shape[0] == kern.guard_feature_offsets()["total"]
    assert kern.guard_feature_offsets() == jkern.guard_feature_offsets()
    assert np.array_equal(_bl(g), np.asarray(jg).astype(np.int32))
    jd = jax.vmap(lambda s: jkern.delta_features(s, jkern.derived(s)))(svb)
    d = kern.delta_features(svT, der)
    assert kern.delta_feature_offsets() == jkern.delta_feature_offsets()
    assert np.array_equal(_bl(d), np.asarray(jd))


def test_action_kernels_on_every_lane(case):
    """Every family on every lane of every sampled state: where the
    reference's guard holds, the port's successor equals its state."""
    from raft_tla_tpu_torch.spec.paxos.ir import build_families
    kern, jkern, svb, svT = (case["kern"], case["jkern"], case["svb"],
                             case["svT"])
    der = kern.derived(svT)
    jder = jax.vmap(jkern.derived)(svb)
    R = svT["mb"].shape[-1]
    n_on = 0
    for fam in build_families(case["lay"]):
        jfn = getattr(jkern, fam.name.lower())
        for vals in zip(*fam.params):
            vals = [int(v) for v in vals]
            jv = [jnp.int32(v) for v in vals]
            ok, jsv = jax.vmap(lambda s, d: jfn(s, d, *jv))(svb, jder)
            ok = np.asarray(ok)
            prm = [torch.full((R,), v, dtype=torch.int32) for v in vals]
            got = arrays_to_numpy({k: v.movedim(-1, 0) for k, v in
                                   fam.fn(svT, der, *prm).items()})
            for k in got:
                want = np.asarray(jsv[k])
                assert np.array_equal(got[k][ok], want[ok]), (fam.name,
                                                              vals, k)
            n_on += int(ok.sum())
    assert n_on > R


def test_predicates(case):
    jp = JV.PaxosPredicates(case["jlay"])
    tp = PaxosPredicates(case["lay"])
    svb, svT = case["svb"], case["svT"]
    names = sorted(JV.INVARIANTS)
    inv, con = tp.check_T(svT, names, [])
    assert bool(con.all())
    for i, nm in enumerate(names):
        fn = jp.invariant_fn(nm)
        want = np.asarray(jax.vmap(lambda s: fn(s, jp.kern.derived(s)))(
            svb))
        assert np.array_equal(inv[i].numpy(), want), nm
    with pytest.raises(KeyError, match="unknown invariant 'Nope' for spec "
                                       "'paxos'"):
        tp.invariant_fn("Nope")
    with pytest.raises(KeyError, match="paxos declares no search"):
        tp.check_T(svT, [], ["BoundedTerms"])
    with pytest.raises(KeyError, match="paxos declares none"):
        tp.action_fn("X")


def test_narrow_widen_are_the_reference_s(case):
    lay, arrs = case["lay"], case["arrs"]
    st = storage_to_numpy({k: v.movedim(-1, 0) for k, v in
                           TL.narrow_t(lay, case["svT"]).items()},
                          ("msgs",))
    want = JL.narrow(case["jlay"], arrs)
    assert {k: (v.dtype, v.tolist()) for k, v in st.items()} == \
        {k: (v.dtype, v.tolist()) for k, v in want.items()}
    assert all(v.dtype == torch.int32 for v in
               TL.widen_t(TL.narrow_t(lay, case["svT"])).values())
