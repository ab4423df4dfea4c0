"""The port's Engine in sort, incremental and direct modes held exactly
against the JAX package's Engine(burst=False) in sort mode on the S=4
membership micro config (blocks {0,1,2} and {3}, P = 6; the checks of
test_torch_engine_sort.py), and the hard-lane buffer's overflow replay
at the BASELINE config #5 shape.
"""

import os

import pytest
import torch

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.engine.bfs import Engine

from test_torch_engine_sort import MODES, check_case

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_jax_sort_engine(mode):
    check_case("s4dyn", mode)


def test_hard_lane_overflow_replays_keep_counts():
    """Config #5's shape (5 servers, 120 permutations, "auto" = sort)
    to depth 17, where chunks first carry hard lanes: with a one-lane
    buffer every such chunk overflows and its level replays with HCAP
    grown, and the level sizes stay the reference's (chip_smoke.py's
    constants, from the JAX package's Engine)."""
    import chip_smoke as cs
    from raft_tla_tpu_torch.cfg.parser import load_model
    cfg = load_model(os.path.join(REPO, "configs/tlc_membership/raft.cfg"),
                     bounds=Bounds.make(**cs.CONFIG5_BOUNDS))
    cfg = cfg.with_(**cs.CONFIG5_SHAPE)
    eng = Engine(cfg, chunk=512, store_states=False, hcap=1, device="cpu")
    assert eng.fpr.sym_canon == "sort"
    assert not eng.fpr.supports_incremental()
    res = eng.check(max_depth=17)
    assert res.level_sizes == cs.CONFIG5_LEVEL_SIZES[:17]
    assert res.hard_lanes > 0 and res.hard_chunk_max > 1
    assert eng.HCAP >= res.hard_chunk_max
    assert res.sym_canon == 1 and not res.violations
