"""The port's packed guard matrix and delta group, held bit for bit
against the JAX package's Expander, with no JAX compile: the arrays are
built on the host on both sides.

Four shapes: BASELINE config #1's and config #5's (S = 5, no engine),
a ``Next`` micro config (Duplicate, Drop) and a ``NextDynamic`` micro
config.  Also the delta features of reachable states against the JAX
kernels', the delta group's three build-time checks, the
``--fam-cap-density`` parser's errors, and the two guard forms of the
port against each other.
"""

import os

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import (Bounds as JBounds, ModelConfig as JCfg,
                                 NEXT_DYNAMIC as J_DYN, NEXT_FULL as J_FULL)
from raft_tla_tpu.ops import codec as jcodec
from raft_tla_tpu.ops.layout import Layout as JLayout

from raft_tla_tpu_torch import convert as cvt
from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_DYNAMIC, \
    NEXT_FULL
from raft_tla_tpu_torch.engine.expand import (Expander, parse_fam_density,
                                              validate_fam_density)

from conftest import cached_explore

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# the BASELINE shapes as chip_smoke.py builds them
_C1_BOUNDS = dict(max_log_length=2, max_timeouts=1, max_client_requests=3)
_C5_BOUNDS = dict(max_log_length=4, max_timeouts=3, max_client_requests=3)
_C5_SHAPE = dict(n_servers=5, init_servers=(0, 1, 2, 3, 4),
                 invariants=("ConcurrentLeaders",))
MICRO = {
    # unreliable network: Duplicate / Drop
    "next": dict(n_servers=2, init_servers=(0, 1), values=(1, 2),
                 next_family="full", max_inflight_override=3,
                 bounds=dict(max_log_length=1, max_timeouts=1,
                             max_client_requests=2), symmetry=True),
    # membership changes, InitServer ⊊ Server
    "dynamic": dict(n_servers=3, init_servers=(0, 1), values=(1,),
                    next_family="dyn", max_inflight_override=4,
                    bounds=dict(max_log_length=2, max_timeouts=1,
                                max_client_requests=1), symmetry=True),
}
SHAPES = ("config1", "config5", "next", "dynamic")


def _cfgs(shape):
    if shape in ("config1", "config5"):
        from raft_tla_tpu.cfg.parser import load_model as jload
        from raft_tla_tpu_torch.cfg.parser import load_model as tload
        path = os.path.join(REPO, "configs/tlc_membership/raft.cfg")
        b = _C1_BOUNDS if shape == "config1" else _C5_BOUNDS
        jc = jload(path, bounds=JBounds.make(**b))
        tc = tload(path, bounds=Bounds.make(**b))
        if shape == "config5":
            jc, tc = jc.with_(**_C5_SHAPE), tc.with_(**_C5_SHAPE)
    else:
        c = dict(MICRO[shape])
        fam = c.pop("next_family")
        b = c.pop("bounds")
        jc = JCfg(next_family={"dyn": J_DYN, "full": J_FULL}[fam],
                  bounds=JBounds.make(**b), **c)
        tc = ModelConfig(next_family={"dyn": NEXT_DYNAMIC,
                                      "full": NEXT_FULL}[fam],
                         bounds=Bounds.make(**b), **c)
    assert repr(jc) == repr(tc)
    return jc, tc


_EXP = {}


def _expanders(shape):
    if shape not in _EXP:
        from raft_tla_tpu.engine.expand import Expander as JExpander
        jc, tc = _cfgs(shape)
        _EXP[shape] = (JExpander(jc), Expander(tc, CPU))
    return _EXP[shape]


# the group's arrays; fam_trng and lane_base are dicts by family index
_DG_ARRAYS = ("Q", "P", "t_lane", "t_srcu", "t_slot", "t_w", "used",
              "lane_to_aff")
_DG_SCALARS = ("fam_idx", "fam_trng", "lane_base", "n_lanes",
               "n_triples", "D", "n_feats", "slots")


@pytest.mark.parametrize("shape", SHAPES)
def test_guard_matrix_and_delta_group_match_jax(shape):
    jx, tx = _expanders(shape)
    assert tx.lane_labels() == jx.lane_labels()
    np.testing.assert_array_equal(tx._gW, np.asarray(jx._gW))
    assert tx._gW.dtype == np.int8
    np.testing.assert_array_equal(tx._gT, np.asarray(jx._gT))
    jd, td = jx._dgroup, tx._dgroup
    for k in _DG_ARRAYS:
        assert np.asarray(td[k]).dtype == np.asarray(jd[k]).dtype, k
        np.testing.assert_array_equal(td[k], np.asarray(jd[k]),
                                      err_msg=k)
    for k in _DG_SCALARS:
        assert td[k] == jd[k], k
    assert {k: tuple(v) for k, v in td["shapes"].items()} == \
        {k: tuple(v) for k, v in jd["shapes"].items()}
    assert tx.delta_family_names == jx.delta_family_names
    # every one of the seven declared families that the shape has
    seven = {"BecomeLeader", "ClientRequest", "UpdateTerm", "Timeout",
             "Restart", "Duplicate", "Drop"}
    names = {f.name for f in tx.families}
    assert set(tx.delta_family_names) == seven & names
    assert ({"Duplicate", "Drop"} <= names) == (shape != "config1" and
                                                shape != "config5")
    # the padded int8 matrix the card's product uses
    F, A = tx._gW.shape
    W8 = tx._W8.numpy()
    assert W8.shape[0] % 8 == 0 and W8.shape[1] % 8 == 0
    np.testing.assert_array_equal(W8[:F, :A], tx._gW)
    assert not W8[F:].any() and not W8[:, A:].any()


_STATES = {}


def _states(shape, n=150):
    """Encoded oracle-reachable states of a micro shape (JAX codec
    rows, batch-major), a seeded sample."""
    if shape not in _STATES:
        jc, _tc = _cfgs(shape)
        r = cached_explore(jc, max_depth=12, keep_states=True)
        pairs = list(r.states.values())
        rng = np.random.RandomState(11)
        pick = rng.choice(len(pairs), size=min(n, len(pairs)),
                          replace=False)
        lay = JLayout(jc)
        _STATES[shape] = jcodec.stack(
            [jcodec.encode(lay, *pairs[i]) for i in sorted(pick)])
    return _STATES[shape]


@pytest.mark.parametrize("shape", ["next", "dynamic"])
def test_delta_features_match_jax(shape):
    import jax
    import jax.numpy as jnp
    jx, tx = _expanders(shape)
    arrs = _states(shape)
    svb = jcodec.widen({k: jnp.asarray(v) for k, v in arrs.items()})
    feats_j = jax.jit(jax.vmap(
        lambda sv: jx.kern.delta_features(sv, jx.kern.derived(sv))))(svb)
    svT = cvt.rows_to_torch(arrs)
    feats_t = tx.kern.delta_features(svT, tx.kern.derived(svT))
    assert feats_t.dtype == torch.int32
    np.testing.assert_array_equal(feats_t.numpy().T, np.asarray(feats_j))
    assert tx.kern.delta_feature_offsets() == \
        jx.kern.delta_feature_offsets()
    # the states exercise the data-dependent features
    assert (feats_t != 0).any(1).sum() > feats_t.shape[0] // 3


@pytest.mark.parametrize("shape", ["next", "dynamic"])
def test_guard_product_equals_guard_terms(shape):
    """The CPU form of the guard product (int32) and the term form give
    the same grid on reachable states; the product's features are 0/1."""
    _jx, tx = _expanders(shape)
    svT = cvt.rows_to_torch(_states(shape))
    der = tx.kern.derived(svT)
    ok_m = tx.guards_T_matmul(svT, der)
    ok_t = tx.guards_T_terms(svT, der)
    assert torch.equal(ok_m, ok_t)
    assert ok_m.any() and not ok_m.all()
    phi = tx.kern.guard_features(svT, der)
    assert int(phi.min()) >= 0 and int(phi.max()) <= 1


def _bad_delta(ir, slot=None, src=None, w=1):
    """build_families with BecomeLeader's declaration replaced by one
    triple (slot, source, weight); a slot or source of None is valid."""
    orig = ir.build_families

    def bad(lay):
        fams = orig(lay)
        f = fams[1]
        assert f.name == "BecomeLeader"
        fams[1] = type(f)(
            f.name, f.fn, f.params, f.labeler, guard=f.guard,
            delta=lambda off, lay, i: [(0 if slot is None else slot,
                                        0 if src is None else src, w)])
        return fams
    return orig, bad


@pytest.mark.parametrize("which", ["slot", "source", "weight"])
def test_delta_group_checks_fire_as_the_reference(which):
    from raft_tla_tpu.engine.expand import Expander as JExpander
    from raft_tla_tpu.spec import get_spec as jget
    from raft_tla_tpu_torch.spec import get_spec as tget
    jc, tc = _cfgs("next")
    kw = dict(slot=dict(slot=10 ** 9), source=dict(src=10 ** 9),
              weight=dict(w=1 << 40))[which]
    msgs = []
    for ir, make in ((jget("raft"), lambda: JExpander(jc)),
                     (tget("raft"), lambda: Expander(tc, CPU))):
        orig, bad = _bad_delta(ir, **kw)
        object.__setattr__(ir, "build_families", bad)
        try:
            with pytest.raises(KeyError, match="BecomeLeader") as e:
                make()
            msgs.append(str(e.value))
        finally:
            object.__setattr__(ir, "build_families", orig)
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("text", [
    "Receive=8, Timeout=2", "NoSuchFamily=3", "Receive=0",
    "Receive=abc", "Receive", " , Drop=4,"])
def test_fam_density_parser_matches_the_reference(text):
    from raft_tla_tpu.engine.expand import parse_fam_density as jparse
    try:
        want = ("ok", jparse(text))
    except ValueError as e:
        want = ("error", str(e))
    try:
        got = ("ok", parse_fam_density(text))
    except ValueError as e:
        got = ("error", str(e))
    assert got == want
    with pytest.raises(ValueError, match="must be an integer"):
        validate_fam_density({"Receive": 2.5})


def test_fam_density_sets_the_caps():
    _jx, tx = _expanders("next")
    from raft_tla_tpu_torch.engine.bfs import Engine
    _jc, tc = _cfgs("next")
    dflt = Engine(tc, chunk=64, device="cpu")
    tight = Engine(tc, chunk=64, device="cpu",
                   fam_density={"Receive": 1, "Duplicate": 3})
    names = [f.name for f in tx.families]
    for nm, k in (("Receive", 1), ("Duplicate", 3)):
        fi = names.index(nm)
        assert tight.FAM_CAPS[fi] == 64 * min(tx.families[fi].n_lanes, k)
    assert tight.FAM_CAPS != dflt.FAM_CAPS
    with pytest.raises(ValueError, match="unknown action family"):
        Engine(tc, chunk=64, device="cpu", fam_density={"Nope": 2})
