"""The port's copy of ``models/golden.py`` against the reference's: the
punctuated-search pins of ``tlc_membership/raft.cfg`` compile to the
same seeds and interior states, for each pin and for both, with
symmetry (one seed) and without (one seed per injective assignment of
s1, s2, s3: 6 on three servers), and the port's codec encodes them to
the reference's rows; the label helpers agree.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC

from raft_tla_tpu_torch.config import Bounds, ModelConfig

torch.set_num_threads(1)

PINS = {
    "concurrent": ("CommitWhenConcurrentLeaders_unique",),
    "restarts": ("MajorityOfClusterRestarts_constraint",),
    "both": ("CommitWhenConcurrentLeaders_unique",
             "MajorityOfClusterRestarts_constraint"),
}
SHAPE = dict(n_servers=3, init_servers=(0, 1, 2), values=(1, 2),
             invariants=("CommitWhenConcurrentLeaders",))
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_restarts=0,
              max_client_requests=2, max_terms=4)


def cfgs(pins, symmetry):
    jc = JC(bounds=JB.make(**BOUNDS), symmetry=symmetry, prefix_pins=pins,
            **SHAPE)
    tc = ModelConfig(bounds=Bounds.make(**BOUNDS), symmetry=symmetry,
                     prefix_pins=pins, **SHAPE)
    assert repr(jc) == repr(tc)
    return jc, tc


@pytest.mark.parametrize("symmetry", [True, False], ids=["sym", "nosym"])
@pytest.mark.parametrize("pins", sorted(PINS))
def test_prefix_pin_seeds_equal_the_reference(pins, symmetry):
    from raft_tla_tpu.models.golden import prefix_pin_seeds as jpins
    from raft_tla_tpu.ops import codec as jcodec
    from raft_tla_tpu.ops.layout import Layout as JLayout
    from raft_tla_tpu_torch.models.golden import prefix_pin_seeds
    from raft_tla_tpu_torch.ops import codec
    from raft_tla_tpu_torch.ops.layout import Layout
    jc, tc = cfgs(PINS[pins], symmetry)
    want_seeds, want_int = jpins(jc, with_interior=True)
    seeds, interiors = prefix_pin_seeds(tc, with_interior=True)
    assert len(seeds) == (1 if symmetry else 6)
    n_labels = 27 if pins != "concurrent" else 18
    assert len(interiors) == n_labels * len(seeds)
    assert seeds == want_seeds and interiors == want_int
    assert prefix_pin_seeds(tc) == seeds
    jlay, lay = JLayout(jc), Layout(tc)
    for sv, h in seeds + interiors:
        want = jcodec.encode(jlay, sv, h)
        got = codec.encode(lay, sv, h)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_label_helpers_equal_the_reference():
    """relabel_label maps server arguments only (ClientRequest's second
    argument is a value); replay and apply_label step the same states;
    the witness tables are the reference's."""
    from raft_tla_tpu.models import golden as J
    from raft_tla_tpu_torch.models import golden as T
    assert T.PIN_LABELS == J.PIN_LABELS
    assert T.GOLDEN_28_KINDS == J.GOLDEN_28_KINDS
    for lbl in T.PIN_LABELS["MajorityOfClusterRestarts_constraint"]:
        for a in ((2, 0, 1), (1, 2, 0)):
            assert T.relabel_label(lbl, a) == J.relabel_label(lbl, a)
    assert T.relabel_label("ClientRequest(0,1)", (2, 0, 1)) == \
        "ClientRequest(2,1)"
    jc, tc = cfgs((), True)
    labels = T.PIN_LABELS["CommitWhenConcurrentLeaders_unique"][:9]
    assert T.replay(labels, tc) == J.replay(labels, jc)
    sv, h = T.replay(labels[:1], tc)[-1]
    assert T.apply_label(sv, h, tc, labels[1]) == \
        J.apply_label(sv, h, jc, labels[1])
    with pytest.raises(ValueError, match="no successor labelled"):
        T.apply_label(sv, h, tc, "BecomeLeader(2)")
    with pytest.raises(KeyError, match="unknown prefix pin"):
        T.prefix_pin_seeds(tc.with_(prefix_pins=("NoSuchPin",)))
