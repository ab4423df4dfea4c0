"""The CUDA dedup kernel against its plain twin and the CPU model of
its claim rounds, and the engine on the card against the engine on the
CPU.  These need an NVIDIA GPU with nvcc (marker ``cuda``) and skip
elsewhere; on the card run

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch import convert as cvt
from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.bfs import Engine
from raft_tla_tpu_torch.engine.fingerprint import (
    MAX_PROBE_ROUNDS, PROBE_CLAIM_LAUNCHES, probe_claim_insert,
    probe_claim_insert_plain, probe_claim_insert_rounds)
from raft_tla_tpu_torch.utils import fmix32_np
from test_torch_dedup_rounds import build_case

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


def _case(case, dev):
    """(table, keys, live, max_rounds, hovf expected or None) on ``dev``:
    a random fixture (vcap, m lanes over dup distinct keys, load) or a
    named fixture of tests/test_torch_dedup_rounds.py."""
    W = 2
    if isinstance(case, str):
        table, keys, live, max_rounds = build_case(case)
        return (cvt.words_to_torch(table, dev), cvt.words_to_torch(keys, dev),
                torch.from_numpy(live).to(dev), max_rounds, None)
    vcap, m, dup, load = case
    rng = np.random.RandomState(vcap + m)
    pool = _keys(rng, int(load * vcap) + dup)
    table = torch.full((W, vcap), -1, dtype=torch.int32, device=dev)
    n_fill = int(load * vcap)
    if n_fill:
        fill = cvt.words_to_torch(pool[:, :n_fill], dev)
        probe_claim_insert_plain(table, fill,
                                 torch.ones(n_fill, dtype=torch.bool,
                                            device=dev))
    keys = cvt.words_to_torch(pool[:, n_fill + rng.randint(0, dup, m)],
                              dev)
    live = torch.from_numpy(rng.rand(m) > 0.2).to(dev)
    return table, keys, live, MAX_PROBE_ROUNDS, load == 1.0


@pytest.mark.parametrize("case", [(128, 96, 24, 0.0), (1024, 400, 400, 0.0),
                                  (64, 8, 8, 1.0), (1 << 16, 8192, 4096, 0.3),
                                  "chain", "all_ones"])
def test_kernel_equals_twin(cuda, case):
    """Kernel == twin bit for bit; two launches give the same outputs
    and the same claim rounds as the CPU model of the rounds."""
    table, keys, live, max_rounds, want_hovf = _case(case, cuda)
    t_k, t_k2, t_p = table.clone(), table.clone(), table.clone()
    PROBE_CLAIM_LAUNCHES.reset(timing=True)
    fk, pk, hk = probe_claim_insert(t_k, keys, live, max_rounds)
    out2 = probe_claim_insert(t_k2, keys, live, max_rounds)
    torch.cuda.synchronize()
    assert PROBE_CLAIM_LAUNCHES.count == 2
    (r1, e1), (r2, e2) = PROBE_CLAIM_LAUNCHES.rounds()
    PROBE_CLAIM_LAUNCHES.reset()
    fp, pp, hp = probe_claim_insert_plain(t_p, keys, live, max_rounds)
    assert torch.equal(t_k, t_p)
    assert torch.equal(fk, fp) and torch.equal(pk, pp)
    assert bool(hk) == bool(hp)
    if want_hovf is not None:
        assert bool(hk) == want_hovf
    assert torch.equal(t_k2, t_k) and torch.equal(out2[0], fk) and \
        torch.equal(out2[1], pk) and bool(out2[2]) == bool(hk)
    t_m = table.cpu()
    *_o, rounds = probe_claim_insert_rounds(t_m, keys.cpu(), live.cpu(),
                                            max_rounds)
    assert r1 == r2 == rounds and e1 == e2 == 0


@pytest.mark.parametrize("case", [(128, 96, 24, 0.0), (1024, 400, 400, 0.0),
                                  (64, 8, 8, 1.0), (1 << 16, 8192, 4096, 0.3),
                                  "all_ones"])
def test_kernel_at_128_bit_keys_equals_twin(cuda, case):
    """``--fp128`` keys (W = 4 words): kernel == twin bit for bit, and
    the claim rounds equal the CPU model's; "all_ones" puts 4-word
    all-ones keys (equal to EMPTY) among live and dead lanes."""
    W = 4
    rng = np.random.RandomState(7)
    if case == "all_ones":
        vcap, m = 256, 64
        keys_np = _keys(rng, m, W)
        keys_np[:, [3, 17, 18, 40]] = 0xFFFFFFFF
        live_np = np.ones(m, bool)
        live_np[[17, 30]] = False
        table = torch.full((W, vcap), -1, dtype=torch.int32, device=cuda)
        probe_claim_insert_plain(
            table, cvt.words_to_torch(_keys(rng, 80, W), cuda),
            torch.ones(80, dtype=torch.bool, device=cuda))
        keys = cvt.words_to_torch(keys_np, cuda)
        live = torch.from_numpy(live_np).to(cuda)
        want_hovf = None
    else:
        vcap, m, dup, load = case
        pool = _keys(rng, int(load * vcap) + dup, W)
        table = torch.full((W, vcap), -1, dtype=torch.int32, device=cuda)
        n_fill = int(load * vcap)
        if n_fill:
            probe_claim_insert_plain(
                table, cvt.words_to_torch(pool[:, :n_fill], cuda),
                torch.ones(n_fill, dtype=torch.bool, device=cuda))
        keys = cvt.words_to_torch(
            pool[:, n_fill + rng.randint(0, dup, m)], cuda)
        live = torch.from_numpy(rng.rand(m) > 0.2).to(cuda)
        want_hovf = load == 1.0
    t_k, t_p = table.clone(), table.clone()
    PROBE_CLAIM_LAUNCHES.reset(timing=True)
    fk, pk, hk = probe_claim_insert(t_k, keys, live)
    torch.cuda.synchronize()
    (r1, e1), = PROBE_CLAIM_LAUNCHES.rounds()
    PROBE_CLAIM_LAUNCHES.reset()
    fp, pp, hp = probe_claim_insert_plain(t_p, keys, live)
    assert torch.equal(t_k, t_p)
    assert torch.equal(fk, fp) and torch.equal(pk, pp)
    assert bool(hk) == bool(hp)
    if want_hovf is not None:
        assert bool(hk) == want_hovf
    *_o, rounds = probe_claim_insert_rounds(table.cpu(), keys.cpu(),
                                            live.cpu(), MAX_PROBE_ROUNDS)
    assert r1 == rounds and e1 == 0


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


@pytest.mark.parametrize("mode", ["sort", "incremental"])
def test_fingerprint_modes_on_the_card_equal_the_cpu(cuda, mode):
    """The engine in sort mode (forced at 3 servers, P = 6) and with
    incremental fingerprints gives the CPU's answer on the card."""
    cfg = ModelConfig(n_servers=3, init_servers=(0, 1, 2), values=(1,),
                      next_family=NEXT_ASYNC, symmetry=True,
                      max_inflight_override=2,
                      invariants=("ElectionSafety", "FirstCommit"),
                      bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                                         max_client_requests=1))
    kw = dict(sym_canon="sort") if mode == "sort" else \
        dict(sym_canon="minperm", incremental_fp=True)
    out = []
    for dev in ("cuda", "cpu"):
        eng = Engine(cfg, chunk=64, hcap=8, device=dev, **kw)
        res = eng.check(max_depth=16)
        out.append((res.distinct_states, res.generated_states, res.depth,
                    res.level_sizes, res.sym_canon,
                    sorted((v.invariant, v.state_id)
                           for v in res.violations)))
    assert out[0] == out[1]


def test_sort_fingerprints_on_the_card_equal_the_cpu(cuda):
    """Config #5's shape (S=5, P=120): sort-mode values of reachable
    states and 1-WL-hard states (votedFor cycles) are the CPU's, in both
    the exact and the fixed-width hard-lane forms."""
    from raft_tla_tpu_torch.engine.fingerprint import RaftFingerprinter
    cfg = ModelConfig(n_servers=5, init_servers=(0, 1, 2, 3, 4),
                      values=(1,), next_family=NEXT_ASYNC, symmetry=True,
                      max_inflight_override=4,
                      bounds=Bounds.make(max_log_length=4, max_timeouts=3,
                                         max_client_requests=3))
    eng = Engine(cfg, chunk=256, device="cpu")
    eng.check(max_depth=5)
    rows = {k: np.concatenate([b[k] for b in eng._states])
            for k in eng._states[0]}
    for vf in ((1, 2, 3, 4, 0), (1, 2, 0, 4, 3)):
        one = {k: v[:1].copy() for k, v in rows.items()}
        one["vf"][0] = vf
        rows = {k: np.concatenate([one[k], v]) for k, v in rows.items()}
    fpr = RaftFingerprinter(cfg, sym_canon="sort")
    svT = {k: v.to(torch.int32) for k, v in
           eng.ir.widen(cvt.rows_to_torch(rows)).items()}
    want = fpr.fingerprint_batch_T(svT)
    got = fpr.fingerprint_batch_T({k: v.to(cuda) for k, v in svT.items()})
    assert torch.equal(got.cpu(), want)
    fixed, n_hard = fpr.fingerprint_chunk_T(
        {k: v.to(cuda) for k, v in svT.items()}, 16)
    assert int(n_hard) >= 2 and torch.equal(fixed.cpu(), want)


def _frontier_rows(cfg, depth, chunk=64):
    """Reachable states of ``cfg`` (the port's engine on the CPU, the
    states of the levels up to ``depth``) as batch-last int32 rows."""
    eng = Engine(cfg, chunk=chunk, device="cpu")
    eng.check(max_depth=depth)
    rows = {k: np.concatenate([b[k] for b in eng._states])
            for k in eng._states[0]}
    return eng, {k: v.to(torch.int32) for k, v in
                 eng.ir.widen(cvt.rows_to_torch(rows)).items()}


def _micro_dynamic():
    from raft_tla_tpu_torch.config import NEXT_DYNAMIC
    return ModelConfig(n_servers=3, init_servers=(0, 1), values=(1,),
                       next_family=NEXT_DYNAMIC, symmetry=True,
                       max_inflight_override=4,
                       bounds=Bounds.make(max_log_length=2, max_timeouts=1,
                                          max_client_requests=1))


@pytest.mark.parametrize("rows", [16, 17, 40, 100, 1024])
def test_guard_product_on_the_card_equals_the_term_form(cuda, rows):
    """``torch._int_mm`` (int8, F and A padded to multiples of 8, B
    padded past 16 rows) gives the term form's grid bit for bit, at
    chunk widths that need each padding."""
    from raft_tla_tpu_torch.engine.expand import Expander
    eng, svT = _frontier_rows(_micro_dynamic(), 9)
    n = svT["ct"].shape[-1]
    idx = torch.arange(rows) % n
    svT = {k: v[..., idx] for k, v in svT.items()}
    tx = Expander(eng.cfg, cuda)
    sv_c = {k: v.to(cuda) for k, v in svT.items()}
    der_c = tx.kern.derived(sv_c)
    got = tx.guards_T_matmul(sv_c, der_c)
    assert got.shape == (rows, tx.n_lanes)
    assert torch.equal(got, tx.guards_T_terms(sv_c, der_c))
    tcpu = Expander(eng.cfg, torch.device("cpu"))
    want = tcpu.guards_T_terms(svT, tcpu.kern.derived(svT))
    assert torch.equal(got.cpu(), want) and want.any()


@pytest.mark.parametrize("skip", [False, True])
def test_delta_group_on_the_card(cuda, skip):
    """The delta group's candidates on the card (``index_add_`` with
    atomic adds) equal the per-family kernels' on the card and the
    CPU's output for the same chunk; so do the incremental
    fingerprints."""
    from raft_tla_tpu_torch.engine.expand import (Expander,
                                                  compact_positions)
    from raft_tla_tpu_torch.engine.fingerprint import RaftFingerprinter
    eng, svT = _frontier_rows(_micro_dynamic(), 9)
    B = 256
    svT = {k: v[..., torch.arange(B) % v.shape[-1]] for k, v in svT.items()}
    out = {}
    for dev, delta in ((cuda, True), (cuda, False), (torch.device("cpu"),
                                                     True)):
        tx = Expander(eng.cfg, dev, delta_matmul=delta,
                      delta_chunk_skip=skip)
        fpr = RaftFingerprinter(eng.cfg)
        sv = {k: v.to(dev) for k, v in svT.items()}
        der = tx.kern.derived(sv)
        okf = tx.guards_T(sv, der).reshape(-1)
        fcap = B * 16
        epos, n_e = compact_positions(okf, fcap)
        caps = tx.default_fam_caps(B)
        cand, counts, fp = tx.materialize(
            sv, der, okf, epos, fcap, caps,
            delta_fp=(fpr, fpr.parent_tables(sv)))
        n = int(n_e)
        out[(dev.type, delta)] = (
            {k: v[..., :n].cpu() for k, v in cand.items()},
            counts.cpu(), fp[:, :n].cpu())
    ref = out[("cpu", True)]
    assert int(ref[1].sum()) > B
    for key in (("cuda", True), ("cuda", False)):
        cand, counts, fp = out[key]
        assert torch.equal(counts, ref[1]), key
        assert torch.equal(fp, ref[2]), key
        for k in cand:
            assert torch.equal(cand[k], ref[0][k]), (key, k)


def test_captured_probe_claim_replays_equal_eager_launches(cuda):
    """Stream capture takes the kernel's cooperative launch: one
    captured launch, replayed twice with new keys in its input buffer,
    gives the tables and outputs of two eager launches, and each
    replay counts as one launch."""
    from raft_tla_tpu_torch.engine.graph import GraphRunner
    rng = np.random.RandomState(7)
    W, vcap, M = 2, 1 << 12, 512
    batches = [cvt.words_to_torch(_keys(rng, M, W), cuda) for _ in range(3)]
    batches[2][:, :64] = batches[1][:, :64]       # duplicates across
    live = torch.from_numpy(rng.rand(M) > 0.1).to(cuda)
    table = torch.full((W, vcap), -1, dtype=torch.int32, device=cuda)
    eager = table.clone()
    keys = batches[0].clone()
    # the step's outputs land in persistent buffers, as the engine's do
    fresh = torch.zeros(M, dtype=torch.bool, device=cuda)
    pos = torch.zeros(M, dtype=torch.int32, device=cuda)
    hovf = torch.zeros((), dtype=torch.bool, device=cuda)

    def step():
        for buf, t in zip((fresh, pos, hovf),
                          probe_claim_insert(table, keys, live)):
            buf.copy_(t)

    runner = GraphRunner(cuda)
    PROBE_CLAIM_LAUNCHES.reset()
    for i, b in enumerate(batches):
        keys.copy_(b)
        runner.run("k", step)     # the first: warm-up, then the capture
        f, p, h = probe_claim_insert(eager, b, live)
        torch.cuda.synchronize()
        assert torch.equal(table, eager), i
        assert torch.equal(fresh, f) and torch.equal(pos, p), i
        assert bool(hovf) == bool(h)
    assert runner.captures == 1 and runner.replays == 2
    assert PROBE_CLAIM_LAUNCHES.count == 3 + 3    # eager 3, graph 1 + 2
    # dropped graphs (a cap grew): the next call warms up and captures
    # anew, into a new pool
    runner.clear()
    keys.copy_(batches[0])
    runner.run("k", step)
    f, p, h = probe_claim_insert(eager, batches[0], live)
    runner.run("k", step)
    f, p, h = probe_claim_insert(eager, batches[0], live)
    torch.cuda.synchronize()
    assert torch.equal(table, eager) and torch.equal(pos, p)
    assert runner.captures == 2 and runner.replays == 3


def _config1():
    import os
    import chip_smoke as cs
    from raft_tla_tpu_torch.cfg.parser import load_model
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return cs, load_model(os.path.join(
        here, "configs/tlc_membership/raft.cfg"),
        bounds=Bounds.make(**cs.CONFIG1_BOUNDS))


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


def test_captured_chunk_step_equals_the_eager_step(cuda):
    """Config #1 to depth 14 on the per-level path: every chunk step a
    graph replay against every chunk step eager, bit for bit."""
    cs, cfg = _config1()
    runs = {}
    for capture in (True, False):
        eng = Engine(cfg, burst=False, device="cuda", **cs.CONFIG1_ENGINE)
        eng._capture = capture
        res = eng.check(max_depth=14)
        runs[capture] = (eng, res)
    (g, rg), (e, re_) = runs[True], runs[False]
    assert rg.level_sizes == re_.level_sizes == cs.CONFIG1_LEVEL_SIZES[:14]
    assert (rg.distinct_states, rg.generated_states) == \
        (re_.distinct_states, re_.generated_states)
    assert g._graphs.replays > 0 and e._graphs.replays == 0
    _same_archives(g, e)


def test_replays_and_eager_steps_do_not_synchronize(cuda, monkeypatch):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` every graph
    replay, and every eager chunk step and burst iteration after the
    first for its graph key (the warm-up, which copies in the constants
    it caches), runs without a host synchronisation; the captures, the
    finalize's read and the burst's reads between iterations stay
    outside the mode."""
    from raft_tla_tpu_torch.engine import graph
    cs, cfg = _config1()

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
        self._graphs.setdefault(key, None)     # eager: the warm-up
        return run(self, key, fn)
    monkeypatch.setattr(graph.GraphRunner, "run", run_strict)
    out = []
    for capture in (False, True):
        eng = Engine(cfg, device="cuda", **cs.CONFIG1_ENGINE)
        eng._capture = capture
        res = eng.check(max_depth=16)
        assert res.levels_fused > 0
        out.append((res.distinct_states, res.level_sizes))
    assert out[0] == out[1]
    assert out[0][1] == cs.CONFIG1_LEVEL_SIZES[:16]


def test_burst_on_the_card_equals_the_cpu(cuda):
    """tests/test_burst.py's MICRO: the fused path (captured on the
    card) gives the CPU's counters and archives, a ring bail included."""
    cfg = ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                      max_inflight_override=4, symmetry=True,
                      bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                                         max_client_requests=1))
    runs = []
    for dev in ("cuda", "cpu"):
        eng = Engine(cfg, chunk=64, device=dev)
        res = eng.check(max_depth=16)
        runs.append((eng, (res.distinct_states, res.generated_states,
                           res.level_sizes, res.levels_fused,
                           res.burst_dispatches, res.burst_bailouts)))
    assert runs[0][1] == runs[1][1]
    assert runs[0][1][3] > 0 and runs[0][1][5] > 0
    assert runs[0][0]._graphs.replays > 0
    _same_archives(runs[0][0], runs[1][0])


def test_captured_step_with_the_act_mask_equals_the_eager_step(cuda):
    """The cfg-pinned search with the action constraint's mask
    (tests/test_torch_action_constraint.py's micro, to depth 8): every
    chunk step and burst iteration a graph replay against the same
    steps eager and against the CPU, bit for bit."""
    tc = ModelConfig(
        n_servers=3, init_servers=(0, 1, 2), values=(1,),
        next_family=NEXT_ASYNC, symmetry=True, max_inflight_override=2,
        prefix_pins=("CommitWhenConcurrentLeaders_unique",),
        action_constraints=(
            "CommitWhenConcurrentLeaders_action_constraint",),
        invariants=("CommitWhenConcurrentLeaders",),
        bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                           max_client_requests=2, max_terms=4))
    runs = {}
    for name, dev, capture in (("graph", "cuda", True),
                               ("eager", "cuda", False),
                               ("cpu", "cpu", True)):
        for burst in (False, True):
            eng = Engine(tc, chunk=64, burst=burst, device=dev)
            eng._capture = capture
            res = eng.check(max_depth=8)
            runs[name, burst] = (eng, (
                res.distinct_states, res.generated_states, res.level_sizes,
                res.pin_interior_states,
                [(v.invariant, v.state_id) for v in res.violations]))
    for burst in (False, True):
        g, e, c = (runs[n, burst] for n in ("graph", "eager", "cpu"))
        assert g[1] == e[1] == c[1]
        assert g[0]._graphs.replays > 0 and e[0]._graphs.replays == 0
        _same_archives(g[0], e[0])
        _same_archives(g[0], c[0])


@pytest.mark.parametrize("burst", [False, True], ids=["perlevel", "burst"])
def test_resume_on_the_card_recaptures_the_step(cuda, tmp_path, burst):
    """A checkpoint written on the card (whose steps ran as captured
    graphs) resumes in the same engine and in a fresh one: every resume
    starts a fresh graph runner whose first step captures again, and
    lands on the uninterrupted counts; a checkpoint written on the CPU
    resumes on the card too, and the card's on the CPU."""
    cfg = ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                      next_family=NEXT_ASYNC, symmetry=True,
                      max_inflight_override=2,
                      invariants=("FirstBecomeLeader",),
                      bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                                         max_client_requests=1))

    def summary(r):
        return (r.distinct_states, r.generated_states, r.depth,
                r.level_sizes, [(v.invariant, v.state_id)
                                for v in r.violations])
    kw = dict(chunk=64, burst=burst, burst_levels=2)
    eng = Engine(cfg, device="cuda", **kw)
    want = summary(eng.check(max_depth=14))
    assert eng._graphs.captures > 0 and eng._graphs.replays > 0
    ck_card, ck_cpu = str(tmp_path / "card.ckpt"), str(tmp_path / "cpu.ckpt")
    eng.check(max_depth=8, checkpoint_path=ck_card, checkpoint_every=8)
    Engine(cfg, device="cpu", **kw).check(
        max_depth=8, checkpoint_path=ck_cpu, checkpoint_every=8)
    for path, e in ((ck_card, eng), (ck_card, Engine(cfg, device="cuda",
                                                      **kw)),
                    (ck_cpu, Engine(cfg, device="cuda", **kw)),
                    (ck_card, Engine(cfg, device="cpu", **kw))):
        before = e._graphs
        res = e.check(max_depth=14, resume_from=path)
        assert summary(res) == want
        assert e._graphs is not before
        if e.device.type == "cuda":
            assert e._graphs.captures > 0 and e._graphs.replays > 0


def _sim_member(invariants=("MembershipChange",)):
    """tests/test_sim.py's MEMBER config (NextDynamic, 3 servers)."""
    from raft_tla_tpu_torch.config import NEXT_DYNAMIC
    return ModelConfig(n_servers=3, init_servers=(0, 1), values=(1,),
                       next_family=NEXT_DYNAMIC, max_inflight_override=6,
                       bounds=Bounds.make(max_log_length=2, max_timeouts=1,
                                          max_client_requests=1,
                                          max_membership_changes=1),
                       symmetry=False, invariants=invariants)


def _sim_leaves(st):
    out = {}
    for k, v in st.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [("", v)]):
            out[k + "." + kk] = vv.cpu()
    return out


def test_sim_hunt_on_the_card_equals_the_cpu(cuda):
    """The membership hunt (16 walkers, seed 1) finds the same witness
    on the card, through captured steps, as on the CPU: walker, depth,
    lanes, stats, Bloom estimate and the decoded trace."""
    from raft_tla_tpu_torch.sim import SimEngine
    out = []
    for dev in ("cuda", "cpu"):
        eng = SimEngine(_sim_member(), walkers=16, max_depth=30, seed=1,
                        bloom_bits=14, device=dev)
        r = eng.run(steps=4000, steps_per_dispatch=256)
        h = eng.decode_hit(r.hits[0])
        out.append((r.steps_dispatched, r.walker_steps, r.sampled_steps,
                    r.restarts, r.promotions, r.est_distinct_states,
                    h.walker, h.depth, h.lanes,
                    [lbl for lbl, _sv in h.trace]))
        if dev == "cuda":
            assert eng._graphs.replays > 0
    assert out[0] == out[1]


@pytest.mark.parametrize("stop_on_hit", [False, True])
def test_sim_captured_step_equals_the_eager_step(cuda, stop_on_hit):
    """The captured walker step against the eager one on the card and
    against the CPU: final carries bit for bit (with the target set, the
    steps after the fleet's first hit replay gated and change nothing),
    and the replays run without a host synchronisation."""
    from raft_tla_tpu_torch.sim import SimEngine
    from raft_tla_tpu_torch.sim.walker import ST_HIT
    cfg = _sim_member(("MembershipChange",) if stop_on_hit else ())
    out = []
    for dev, capture in (("cuda", True), ("cuda", False), ("cpu", True)):
        eng = SimEngine(cfg, walkers=24, max_depth=30, seed=1,
                        bloom_bits=14, device=dev)
        eng._capture = capture
        # the first step: on the card the warm-up, then the capture
        st = eng._dispatch(eng.fresh_carry(), 1, stop_on_hit)
        if capture and dev == "cuda":
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng._dispatch(st, 60, stop_on_hit)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert eng._graphs.replays == 60
        else:
            eng._dispatch(st, 60, stop_on_hit)
        out.append(_sim_leaves(st))
    assert bool(out[0]["stats."][ST_HIT]) == stop_on_hit
    for other in out[1:]:
        assert sorted(other) == sorted(out[0])
        for k in out[0]:
            assert torch.equal(out[0][k], other[k]), k


def _spill_micro():
    return ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                       next_family=NEXT_ASYNC, symmetry=True,
                       max_inflight_override=4,
                       invariants=("FirstBecomeLeader",),
                       bounds=Bounds.make(max_log_length=1, max_timeouts=1,
                                          max_client_requests=1))


def test_spill_captured_step_equals_the_eager_step(cuda):
    """Config #1 to depth 15 on the spill engine's segment driver with
    segments small enough to spill mid-level (chunk 256, FCAP 4096, so
    SEGL 2^14, and a summary read after every chunk: the spill floor is
    6,144 rows, and level 15's 12,873 rows go down in several
    segments): every spill step a graph replay against every step
    eager, bit for bit (counts, archives, segments by level), and both
    against the classic engine's level sizes."""
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    cs, cfg = _config1()
    runs = {}
    for capture in (True, False):
        eng = SpillEngine(cfg, chunk=256, fcap=4096, seg=1 << 12,
                          sync_every=1, burst=False, store_states=True,
                          device="cuda")
        eng._capture = capture
        res = eng.check(max_depth=15)
        runs[capture] = (eng, res)
    (g, rg), (e, re_) = runs[True], runs[False]
    assert rg.level_sizes == re_.level_sizes == cs.CONFIG1_LEVEL_SIZES[:15]
    assert (rg.distinct_states, rg.generated_states) == \
        (re_.distinct_states, re_.generated_states)
    assert g._graphs.replays > 0 and e._graphs.replays == 0
    assert g.segments_by_level == e.segments_by_level
    assert g.segments_by_level[15] > 1, g.segments_by_level
    _same_archives(g, e)


def test_spill_pinned_segment_round_trip(cuda):
    """A frontier segment up through the copy stream and a level segment
    down through pinned buffers: the bytes come back unchanged, the
    staged tensors land in the static buffers, and a block the host
    holds is its own memory (a later spill does not change it)."""
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    eng = SpillEngine(_spill_micro(), chunk=64, seg=1 << 10,
                      store_states=True, device="cuda")
    eng.check(max_depth=6)                 # builds the engine's state
    from raft_tla_tpu_torch.engine.spill import _SpillLevel
    st = _SpillLevel(eng, eng._new_table(eng.VCAP))
    rng = np.random.RandomState(5)
    n = 300
    rows = {k: rng.randint(-3, 100, size=v.shape[:-1] + (n,)).astype(
        cvt.storage_to_numpy({k: v[..., :1]})[k].dtype)
        for k, v in st.front.items()}
    gids = rng.randint(0, 1 << 30, size=n).astype(np.int32)
    staged = eng._stage_segment(rows, gids)
    assert eng._swap_in_segment(st, staged) == n
    back = cvt.storage_to_numpy({k: v[..., :n] for k, v in st.front.items()})
    for k in rows:
        assert np.array_equal(back[k], rows[k]), k
    assert np.array_equal(st.gids[:n].cpu().numpy(), gids)
    for k, v in st.lvl.items():
        v[..., :n].copy_(st.front[k][..., :n])
    st.lpar[:n] = st.gids[:n]
    blk = eng._spill_segment(st, n)
    assert int(st.n_lvl) == 0
    for v in st.lvl.values():              # the device buffer moves on
        v.zero_()
    st.lpar.zero_()
    blk = eng._materialize_blk(blk)
    for k in rows:
        assert np.array_equal(blk["rows"][k], rows[k]), k
    assert np.array_equal(blk["lpar"], gids)
    again = eng._spill_segment(st, n)
    eng._materialize_blk(again)
    assert np.array_equal(blk["lpar"], gids)
    assert eng.bytes_down > 0 and eng.bytes_up > 0


@pytest.mark.parametrize("host_table", [False, True], ids=["spill", "hpt"])
def test_spill_on_the_card_equals_the_cpu(cuda, host_table):
    """The micro config in tiny segments on the card (captured steps, the
    burst, the copy stream; with the host table the device sweep and the
    kernel's reseed) against the CPU: counts, level sizes, violation
    ids and the last state's trace."""
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    kw = dict(chunk=64, seg=1 << 10, vcap=1 << 12, sync_every=2,
              fcap=64, store_states=True)
    if host_table:
        kw.update(host_table=True, part_cap=1 << 6, dev_keys=64)
    out = []
    for dev in ("cuda", "cpu"):
        eng = SpillEngine(_spill_micro(), device=dev, **kw)
        res = eng.check(max_depth=18)
        out.append((res.distinct_states, res.generated_states,
                    res.level_sizes, [v.state_id for v in res.violations],
                    eng.trace(res.distinct_states - 1)))
        if host_table:
            assert eng.reseeds > 0 and eng.hpt.n_keys == res.distinct_states
    assert out[0] == out[1]


def test_spill_hard_lane_trips_keep_counts(cuda):
    """Config #5's shape to depth 17 on the spill engine with a one-lane
    hard-lane buffer: every chunk with more hard lanes trips (hcovf),
    grows HCAP and replays, and the level sizes stay the reference's."""
    import os
    import chip_smoke as cs
    from raft_tla_tpu_torch.cfg.parser import load_model
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_model(os.path.join(here, "configs/tlc_membership/raft.cfg"),
                     bounds=Bounds.make(**cs.CONFIG5_BOUNDS))
    cfg = cfg.with_(**cs.CONFIG5_SHAPE)
    eng = SpillEngine(cfg, chunk=512, hcap=1, device="cuda")
    res = eng.check(max_depth=17)
    assert res.level_sizes == cs.CONFIG5_LEVEL_SIZES[:17]
    assert eng.trips["hcovf"] > 0 and eng.HCAP > 1
    assert res.hard_lanes > 0
