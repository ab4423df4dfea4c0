"""The CUDA dedup kernel against its plain twin, and the engine on the
card against the engine on the CPU.  These need an NVIDIA GPU with
nvcc (marker ``cuda``) and skip elsewhere; on the card run

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch import convert as cvt
from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.bfs import Engine
from raft_tla_tpu_torch.engine.fingerprint import (PROBE_CLAIM_LAUNCHES,
                                                   probe_claim_insert,
                                                   probe_claim_insert_plain)
from raft_tla_tpu_torch.utils import fmix32_np

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) — run on the GPU")
    return torch.device("cuda")


def _keys(rng, n, W=2):
    k = rng.randint(0, 0xFFFFFFFF, size=(W, n), dtype=np.uint64)
    k = k.astype(np.uint32)
    k[1] = fmix32_np(np.arange(n, dtype=np.uint64) + rng.randint(1 << 20))
    return k


@pytest.mark.parametrize("vcap,m,dup,load", [(128, 96, 24, 0.0),
                                             (1024, 400, 400, 0.0),
                                             (64, 8, 8, 1.0),
                                             (1 << 16, 8192, 4096, 0.3)])
def test_kernel_equals_twin(cuda, vcap, m, dup, load):
    rng = np.random.RandomState(vcap + m)
    W = 2
    pool = _keys(rng, int(load * vcap) + dup)
    table = torch.full((W, vcap), -1, dtype=torch.int32, device=cuda)
    n_fill = int(load * vcap)
    if n_fill:
        fill = cvt.words_to_torch(pool[:, :n_fill], cuda)
        probe_claim_insert_plain(table, fill,
                                 torch.ones(n_fill, dtype=torch.bool,
                                            device=cuda))
    keys = cvt.words_to_torch(pool[:, n_fill + rng.randint(0, dup, m)],
                              cuda)
    live = torch.from_numpy(rng.rand(m) > 0.2).to(cuda)
    t_k, t_p = table.clone(), table.clone()
    PROBE_CLAIM_LAUNCHES.reset()
    fk, pk, hk = probe_claim_insert(t_k, keys, live)
    torch.cuda.synchronize()
    assert PROBE_CLAIM_LAUNCHES.count == 1
    fp, pp, hp = probe_claim_insert_plain(t_p, keys, live)
    assert torch.equal(t_k, t_p)
    assert torch.equal(fk, fp) and torch.equal(pk, pp)
    assert bool(hk) == bool(hp) == (load == 1.0)


def test_engine_on_the_card_equals_the_cpu(cuda):
    cfg = ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                      next_family=NEXT_ASYNC, symmetry=True,
                      max_inflight_override=2,
                      invariants=("ElectionSafety", "FirstCommit"),
                      bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                                         max_client_requests=1))
    out = []
    for dev in ("cuda", "cpu"):
        eng = Engine(cfg, chunk=64, device=dev)
        res = eng.check()
        out.append((res.distinct_states, res.generated_states, res.depth,
                    res.level_sizes,
                    sorted((v.invariant, v.state_id)
                           for v in res.violations)))
    assert out[0] == out[1]
