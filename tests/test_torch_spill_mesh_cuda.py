"""The spill-composed mesh on the card: two shards of one device with the
shard capacities squeezed so that levels spill mid-level; the captured
step-atomic lock-step step, the eager one and the CPU give the same
answer (counts, violations, archives, mid-level spills and trips), the
dedup kernel launched once a shard a lock-step step plus the rehashes,
and every replay runs under ``set_sync_debug_mode("error")`` (the flag
and summary reads are outside); a checkpoint written on the card, between
two levels that spill mid-level, resumes on the CPU as on the card.
These need an NVIDIA GPU with nvcc
(marker ``cuda``) and skip elsewhere; on the card run

    python -m pytest tests/test_torch_spill_mesh_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine import fingerprint as fp
from raft_tla_tpu_torch.parallel.spill_mesh import SpilledShardedEngine

pytestmark = pytest.mark.cuda

MICRO = ModelConfig(
    n_servers=2, init_servers=(0, 1), values=(1,), next_family=NEXT_ASYNC,
    symmetry=False, max_inflight_override=2,
    constraints=("BoundedInFlightMessages", "BoundedRequestVote",
                 "BoundedLogSize", "BoundedTerms"),
    invariants=("ElectionSafety", "LogMatching", "FirstBecomeLeader"),
    bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                       max_client_requests=1))
ENGINE = dict(chunk=16, lcap=1024, scap=128, vcap=1 << 15,
              store_states=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) — run on the GPU")
    return torch.device("cuda")


def _answer(eng, res):
    return dict(
        counts=(res.distinct_states, res.generated_states, res.depth,
                list(res.level_sizes), res.violations_global,
                res.levels_fused, res.burst_dispatches),
        spills=(eng.mid_level_spills, eng.trips),
        violations=[(v.invariant, v.state_id) for v in res.violations],
        parents=np.concatenate(eng._parents).tolist(),
        lanes=np.concatenate(eng._lanes).tolist(),
        states={k: np.concatenate([s[k] for s in eng._states]).tolist()
                for k in eng._states[0]})


def test_the_card_equals_the_cpu_without_a_sync_in_a_replay(cuda,
                                                            monkeypatch):
    from raft_tla_tpu_torch.engine import graph

    run = graph.GraphRunner.run

    def run_strict(self, key, fn):
        if self.capture and key in self._graphs:
            torch.cuda.set_sync_debug_mode("error")
            try:
                return run(self, key, fn)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run(self, key, fn)
    monkeypatch.setattr(graph.GraphRunner, "run", run_strict)
    out = {}
    for name, devs, capture in (("graph", ["cuda:0"] * 2, True),
                                ("eager", ["cuda:0"] * 2, False),
                                ("cpu", ["cpu"] * 2, False)):
        eng = SpilledShardedEngine(MICRO, devices=devs, **ENGINE)
        eng._capture = capture
        fp.PROBE_CLAIM_LAUNCHES.reset()
        res = eng.check(max_depth=14)
        launches = fp.PROBE_CLAIM_LAUNCHES.count
        out[name] = _answer(eng, res)
        if name != "cpu":
            assert launches == 2 * eng.lockstep_steps + eng.rehash_launches
        if name == "graph":
            assert eng.replays > 0 and eng.captures > 0
    assert out["graph"] == out["eager"] == out["cpu"]
    assert out["cpu"]["spills"][0] >= 3


def test_a_file_written_on_the_card_resumes_on_the_cpu(cuda, tmp_path):
    path = str(tmp_path / "card.ckpt")
    eng = SpilledShardedEngine(MICRO, devices=["cuda:0"] * 2, **ENGINE)
    eng.check(max_depth=13, checkpoint_path=path, checkpoint_every=13)
    assert eng.mid_level_spills > 0
    out = {}
    for name, devs in (("card", ["cuda:0"] * 2), ("cpu", ["cpu"] * 2)):
        eng = SpilledShardedEngine(MICRO, devices=devs, **ENGINE)
        out[name] = _answer(eng, eng.check(max_depth=14, resume_from=path))
    assert out["card"] == out["cpu"]
    assert out["cpu"]["spills"][0] > 0
    full = SpilledShardedEngine(MICRO, devices=["cpu"] * 2, **ENGINE)
    want = _answer(full, full.check(max_depth=14))
    assert {k: v for k, v in out["cpu"].items() if k != "spills"} == \
        {k: v for k, v in want.items() if k != "spills"}
