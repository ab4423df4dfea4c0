"""The sharded engine on the card: the dedup kernel at the mesh's
shapes (several table shards of one size on one device, launched back
to back on one stream, so they share the kernel's claim scratch)
against its plain twin; the lock-step step captured against the eager
one, its replays and eager steps under ``set_sync_debug_mode("error")``;
the card against the CPU.  These need an NVIDIA GPU with nvcc (marker
``cuda``) and skip elsewhere; on the card run

    python -m pytest tests/test_torch_mesh_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch import convert as cvt
from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.fingerprint import (probe_claim_insert,
                                                   probe_claim_insert_plain)
from raft_tla_tpu_torch.parallel.mesh import ShardedEngine
from raft_tla_tpu_torch.utils import fmix32_np

pytestmark = pytest.mark.cuda

MICRO = ModelConfig(
    n_servers=2, init_servers=(0, 1), values=(1,), next_family=NEXT_ASYNC,
    symmetry=True, max_inflight_override=4, invariants=("FirstCommit",),
    bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                       max_client_requests=1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) — run on the GPU")
    return torch.device("cuda")


def _keys(rng, n, salt, W=2):
    k = rng.randint(0, 0xFFFFFFFF, size=(W, n), dtype=np.uint64)
    k = k.astype(np.uint32)
    k[1] = fmix32_np(np.arange(n, dtype=np.uint64) + salt)
    return k


def test_kernel_on_table_shards_of_one_size_equals_the_twin(cuda):
    """Four 2^16-slot shards at 35% load, windows of 8,192 keys sharing
    a quarter of their keys across the shards and repeating others
    within a window, launched back to back twice: every output equals
    the twin's, and the passes agree (no claim state leaks between
    shards that share the scratch)."""
    rng = np.random.RandomState(7)
    S, vb, M = 4, 1 << 16, 8192
    n_fill = int(0.35 * vb)
    shared = _keys(rng, M // 4, 1 << 24)
    tabs, wins, lives = [], [], []
    for s in range(S):
        pool = _keys(rng, n_fill + M, (1 << 20) * (s + 1))
        t = torch.full((2, vb), -1, dtype=torch.int32, device=cuda)
        probe_claim_insert(t, cvt.words_to_torch(pool[:, :n_fill], cuda),
                           torch.ones(n_fill, dtype=torch.bool,
                                      device=cuda))
        pick = np.concatenate([rng.randint(0, n_fill, M // 4),
                               n_fill + rng.randint(0, M // 4, M // 2)])
        tabs.append(t)
        wins.append(cvt.words_to_torch(
            np.concatenate([shared, pool[:, pick]], 1), cuda))
        lives.append(torch.from_numpy(rng.rand(M) < 0.9).to(cuda))
    passes = []
    for _ in range(2):
        copies = [t.clone() for t in tabs]
        got = [probe_claim_insert(c, k, lv)
               for c, k, lv in zip(copies, wins, lives)]
        torch.cuda.synchronize()
        passes.append((copies, got))
    for s in range(S):
        t_p = tabs[s].cpu()
        fpl, ppl, hpl = probe_claim_insert_plain(t_p, wins[s].cpu(),
                                                 lives[s].cpu())
        for copies, got in passes:
            fk, pk, hk = got[s]
            assert torch.equal(copies[s].cpu(), t_p)
            assert torch.equal(fk.cpu(), fpl) and torch.equal(pk.cpu(), ppl)
            assert bool(hk) == bool(hpl) is False


def _answer(eng, res):
    return dict(
        counts=(res.distinct_states, res.generated_states, res.depth,
                list(res.level_sizes), res.violations_global,
                res.levels_fused, res.burst_dispatches),
        violations=[(v.invariant, v.state_id) for v in res.violations],
        parents=np.concatenate(eng._parents).tolist(),
        lanes=np.concatenate(eng._lanes).tolist(),
        states={k: np.concatenate([s[k] for s in eng._states]).tolist()
                for k in eng._states[0]})


def test_captured_step_equals_eager_without_a_sync(cuda, monkeypatch):
    """Four shards on the card: the captured lock-step step and the
    eager one give the same answer as the CPU; every replay, and every
    eager step after its key's first (the warm-up), runs under
    ``set_sync_debug_mode("error")`` (the flag read is outside)."""
    from raft_tla_tpu_torch.engine import graph

    def strict(fn, *a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    run = graph.GraphRunner.run

    def run_strict(self, key, fn):
        if self.capture and key in self._graphs:
            return strict(run, self, key, fn)
        if not self.capture and key in self._graphs:
            return strict(fn)
        self._graphs.setdefault(key, None)
        return run(self, key, fn)
    monkeypatch.setattr(graph.GraphRunner, "run", run_strict)
    out = {}
    for name, devs, capture in (("graph", ["cuda:0"] * 4, True),
                                ("eager", ["cuda:0"] * 4, False),
                                ("cpu", ["cpu"] * 4, False)):
        eng = ShardedEngine(MICRO, devices=devs, chunk=32)
        eng._capture = capture
        res = eng.check(max_depth=12)
        out[name] = _answer(eng, res)
        if name == "graph":
            assert eng.replays > 0 and eng.captures > 0
    assert out["graph"] == out["eager"] == out["cpu"]
