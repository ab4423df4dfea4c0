"""The batched serving step on the card (marker ``cuda``; they skip
without a GPU): a wave of raft and paxos jobs through the captured
job-axis burst against the same wave on the CPU (reports bit for bit
but the timing keys and the ``dedup_kernel`` stamp), the dedup kernel
launched once per job slot inside the graph, and the per-job tables as
key sets.  On the card run

    python -m pytest tests/test_torch_serve_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch.config import Bounds, ModelConfig
from raft_tla_tpu_torch.convert import words_to_numpy
from raft_tla_tpu_torch.engine.fingerprint import PROBE_CLAIM_LAUNCHES
from raft_tla_tpu_torch.serve import Job, WaveScheduler
from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig

pytestmark = pytest.mark.cuda

TIMING = ("seconds", "states_per_sec", "wait_s", "service_s",
          "dedup_kernel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) — run on the GPU")
    return torch.device("cuda")


def _micro(mt=1, mcr=1):
    return ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                       next_family="NextAsync", symmetry=True,
                       max_inflight_override=4,
                       bounds=Bounds.make(max_log_length=1,
                                          max_timeouts=mt,
                                          max_client_requests=mcr))


def _jobs():
    return [Job(_micro(), max_depth=10, label="a"),
            Job(_micro(mcr=2), max_depth=12, label="b"),
            Job(_micro(mt=2), max_depth=9, label="c", store_states=False),
            Job(PaxosConfig(n_servers=2, n_ballots=2, n_values=2,
                            invariants=("ValueChosen",)), label="p")]


def _tables(sch):
    out = {}
    for be in sch._engines.values():
        for jp, ring in be._rings.items():
            out[(be.eng.ir.name, jp)] = [
                {tuple(c) for c in t[:, ~(t == 0xFFFFFFFF).all(0)].T}
                for t in (words_to_numpy(ring.table(k))
                          for k in range(jp))]
    return out


def test_batched_step_on_the_card_equals_the_cpu(cuda):
    runs = {}
    for dev in ("cuda", "cpu"):
        sch = WaveScheduler(device=dev)
        c0 = PROBE_CLAIM_LAUNCHES.count
        rep = sch.serve(_jobs())
        runs[dev] = (sch, rep, PROBE_CLAIM_LAUNCHES.count - c0)
    (gs, gr, launches), (cs, cr, _) = runs["cuda"], runs["cpu"]
    for g, c in zip(gr.outcomes, cr.outcomes):
        assert g.report["dedup_kernel"] == 1 and \
            c.report["dedup_kernel"] == 0
        assert {k: v for k, v in g.report.items() if k not in TIMING} == \
            {k: v for k, v in c.report.items() if k not in TIMING}
    assert _tables(gs) == _tables(cs)
    # the kernel ran inside the captured graphs: one launch per job slot
    # per replay (the warm-up launches uncaptured)
    captures = sum(be._graphs.captures for be in gs._engines.values())
    replays = sum(be._graphs.replays for be in gs._engines.values())
    assert captures >= 1 and replays > 0
    assert launches >= replays
    for be in gs._engines.values():
        for jp in be._rings:
            assert be._graphs._graphs[("batched", jp)][1] == jp


def test_guard_product_over_all_jobs_rows_at_the_bucket_chunk(cuda):
    """J = 1 at the bucket's chunk of 128 rows: ``torch._int_mm`` takes
    the padded product, compared with one job's thresholds."""
    from raft_tla_tpu_torch.convert import rows_to_torch
    from raft_tla_tpu_torch.engine.expand import Expander
    from raft_tla_tpu_torch.spec import spec_of
    cfg = _micro(mcr=2)
    ir = spec_of(cfg)
    ceil, params = ir.serve_bucket(cfg)
    res = ir.oracle_explore(cfg, max_depth=8, keep_states=True)
    lay = ir.make_layout(ceil)
    enc = [ir.encode(lay, sv, h) for sv, h in res.states.values()]
    rows = {k: np.resize(np.stack([e[k] for e in enc]),
                         (params["chunk"],) + np.shape(enc[0][k]))
            for k in enc[0]}
    out = []
    for dev in ("cuda", "cpu"):
        ex = Expander(ceil, torch.device(dev))
        rt = {k: torch.from_numpy(v[None]).to(dev)
              for k, v in ir.serve_runtime(ex, cfg).items()
              if k in ("thr", "mask")}
        sv = rows_to_torch(rows, dev, ir.u32_keys)
        out.append(ex.guards_T(sv, ex.derived_batch_T(sv), rt).cpu())
    assert torch.equal(out[0], out[1])


def test_check_dedup_kernel_off_is_refused_on_the_card(cuda):
    """``Engine(dedup_kernel="off")`` on the card is refused (the plain
    twin would move the dedup to the host), and so is ``check
    --dedup-kernel off`` without ``--device cpu`` (exit 2); "auto" and
    "on" launch the kernel inside the graphs and answer alike."""
    import contextlib
    import io
    from raft_tla_tpu_torch.cli import main as port_main
    from raft_tla_tpu_torch.engine.bfs import Engine
    cfg = _micro(mcr=2)
    with pytest.raises(ValueError, match="dedup_kernel='off' is for the "
                       "CPU only"):
        Engine(cfg, chunk=64, dedup_kernel="off")
    got = {}
    for mode in ("auto", "on"):
        eng = Engine(cfg, chunk=64, dedup_kernel=mode)
        c0 = PROBE_CLAIM_LAUNCHES.count
        res = eng.check(max_depth=12)
        got[mode] = (res.distinct_states, res.level_sizes,
                     res.dedup_kernel, PROBE_CLAIM_LAUNCHES.count - c0 > 0,
                     eng._graphs.replays > 0)
    assert got["auto"] == got["on"]
    assert got["auto"][2:] == (1, True, True)
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = port_main(["check", "configs/tlc_membership/raft.cfg",
                        "--servers", "2", "--max-depth", "3",
                        "--dedup-kernel", "off"])
    assert rc == 2 and "--dedup-kernel off needs --device cpu" in \
        err.getvalue()