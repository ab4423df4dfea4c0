"""The paxos tenant on the card (marker ``cuda``; they skip without a
GPU): the captured chunk step and burst against eager steps and against
the CPU, archives bit for bit; the dedup kernel against its plain twin
on a paxos run's own fingerprints; the orbit-sort fingerprints and their
hard-lane fallback at 5 acceptors on the card against the CPU; and the
random-walk hunt, captured, against the CPU.  On the card run

    python -m pytest tests/test_torch_paxos_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch.convert import rows_to_torch
from raft_tla_tpu_torch.engine.bfs import Engine
from raft_tla_tpu_torch.engine.fingerprint import (probe_claim_insert,
                                                   probe_claim_insert_plain)
from raft_tla_tpu_torch.spec import get_spec
from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig

pytestmark = pytest.mark.cuda

TWO = PaxosConfig(n_instances=2, n_ballots=1, symmetry=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) — run on the GPU")
    return torch.device("cuda")


def _archives(eng):
    return (eng._parents, eng._lanes, eng._states)


def _same_archives(a, b):
    for x, y in zip(_archives(a), _archives(b)):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if isinstance(u, dict):
                assert all(np.array_equal(u[k], v[k]) for k in u)
            else:
                assert np.array_equal(u, v)


@pytest.mark.parametrize("burst", [True, False], ids=["burst", "perlevel"])
def test_captured_steps_equal_eager_and_the_cpu(cuda, burst):
    runs = []
    for dev, capture in (("cuda", True), ("cuda", False), ("cpu", True)):
        eng = Engine(TWO, chunk=64, burst=burst, device=dev)
        eng._capture = capture
        res = eng.check()
        runs.append((eng, (res.distinct_states, res.generated_states,
                           res.level_sizes, res.levels_fused)))
    assert runs[0][1] == runs[1][1] == runs[2][1]
    assert runs[0][1][0] == 73 ** 2
    assert runs[0][0]._graphs.replays > 0
    assert runs[1][0]._graphs.replays == 0
    for other in runs[1:]:
        _same_archives(runs[0][0], other[0])


def test_kernel_equals_twin_on_paxos_keys(cuda):
    """Every state of the stock model's fingerprints, twice over with a
    two thirds of them live, through the kernel and the twin into a small
    table: equal tables, fresh, pos and hovf."""
    ir = get_spec("paxos")
    cfg = PaxosConfig()
    res = ir.oracle_explore(cfg.with_(symmetry=False), keep_states=True)
    lay = ir.make_layout(cfg)
    rows = [ir.encode(lay, *p) for p in res.states.values()]
    arrs = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    fpr = ir.make_fingerprinter(cfg, "minperm")
    keys = fpr.fingerprint_batch_T(rows_to_torch(arrs, u32_keys=("msgs",)))
    keys = torch.cat([keys, keys.flip(1)], 1)
    rng = np.random.RandomState(5)
    live = torch.from_numpy(rng.rand(keys.shape[1]) < 0.67)
    t_p = torch.full((2, 1 << 12), -1, dtype=torch.int32)
    fp_p, pos_p, h_p = probe_claim_insert_plain(t_p, keys, live)
    t_k = torch.full((2, 1 << 12), -1, dtype=torch.int32, device=cuda)
    fp_k, pos_k, h_k = probe_claim_insert(t_k, keys.to(cuda), live.to(cuda))
    assert torch.equal(t_k.cpu(), t_p)
    assert torch.equal(fp_k.cpu(), fp_p) and torch.equal(pos_k.cpu(), pos_p)
    assert bool(h_k) == bool(h_p) is False
    assert 0 < int(fp_p.sum()) <= 857


def _tie_all(f, svT, bits):
    return torch.zeros((f.lay.N, bits.shape[-1]), dtype=torch.int32,
                       device=bits.device)


@pytest.mark.parametrize("tie_all", [False, True], ids=["real", "tie_all"])
def test_sort_fingerprints_on_the_card_equal_the_cpu(cuda, tie_all):
    ir = get_spec("paxos")
    cfg = PaxosConfig(n_servers=5)
    res = ir.oracle_explore(cfg.with_(symmetry=False), keep_states=True,
                            max_states=3000)
    lay = ir.make_layout(cfg)
    rows = [ir.encode(lay, *p) for p in res.states.values()]
    arrs = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    out = []
    for dev in ("cuda", "cpu"):
        fpr = ir.make_fingerprinter(cfg, "sort")
        if tie_all:
            fpr._sig_fn = _tie_all
        svT = rows_to_torch(arrs, dev, ("msgs",))
        fp, n_hard = fpr.fingerprint_chunk_T(svT, 64)
        out.append((fp.cpu(), int(n_hard),
                    fpr.fingerprint_batch_T(svT).cpu()))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]
    assert torch.equal(out[0][2], out[1][2])
    assert (out[0][1] > 64) == tie_all


def test_sim_hunt_on_the_card_equals_the_cpu(cuda):
    from raft_tla_tpu_torch.sim import SimEngine
    cfg = PaxosConfig(invariants=("Preempted",))
    out = []
    for dev in ("cuda", "cpu"):
        eng = SimEngine(cfg, walkers=64, max_depth=64, seed=0,
                        bloom_bits=14, device=dev)
        r = eng.run(steps=400, steps_per_dispatch=64)
        h = eng.decode_hit(r.hits[0])
        out.append((r.steps_dispatched, r.walker_steps, r.sampled_steps,
                    r.restarts, r.promotions, r.est_distinct_states,
                    h.walker, h.depth, h.lanes,
                    [lbl for lbl, _sv in h.trace]))
        if dev == "cuda":
            assert eng._graphs.replays > 0
    assert out[0] == out[1]
