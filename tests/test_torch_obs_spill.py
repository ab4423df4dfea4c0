"""The port's spill engine with an observability bundle against the
reference's on the CPU (``tests/test_obs.py``'s TINY shapes: chunk 64,
seg 2^10, vcap 2^12, sync_every 2, a checkpoint every level), once
plain and once with the host table (partitions 4, sweep_stage): the
same sequence of dispatch kinds and, row for row, the same depth,
frontier and counters, each row the level's final counters; the final
row's burst counters equal to ``check_stats`` and to the spill
checkpoint's meta; the heartbeat; the spans at the reference's sites in
the same numbers (``h2d_stage`` inside ``level_dispatch``), and no
``compile`` span on the CPU, where nothing is captured.  One JAX engine
compile for each of the two settings.
"""

import json

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch.engine.spill import SpillEngine
from raft_tla_tpu_torch.obs import (BURST_COUNTER_KEYS, CHECK_COUNTER_KEYS,
                                    check_stats)
from raft_tla_tpu_torch.obs.heartbeat import read_heartbeat

from test_torch_obs_engine import _TIMES, TINY

torch.set_num_threads(1)

KW = dict(chunk=64, store_states=False, seg=1 << 10, vcap=1 << 12,
          sync_every=2)
MODES = {"plain": {},
         "host_table": dict(host_table=True, partitions=4,
                            sweep_stage=True)}
# deep enough for bursts that bail, levels spilled in two segments, and
# device-cache reseeds under the host table
DEPTH = 20


def _run(pkg, eng, tmp_path, name):
    """``eng.check(obs=)`` to DEPTH with a spill checkpoint every level:
    (result, ledger rows, checkpoint meta, heartbeat, span recorder)."""
    led = str(tmp_path / f"{name}.jsonl")
    hb = str(tmp_path / f"{name}.hb.json")
    ck = str(tmp_path / f"{name}.ckpt")
    spans = pkg.SpanRecorder()
    obs = pkg.Obs(ledger=pkg.RunLedger(led), heartbeat=pkg.Heartbeat(hb),
                  spans=spans).start()
    r = eng.check(obs=obs, max_depth=DEPTH, checkpoint_path=ck,
                  checkpoint_every=1)
    obs.finish(depth=int(r.depth), states=int(r.distinct_states))
    rows = [json.loads(x) for x in open(led)]
    z = np.load(ck, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    z.close()
    return r, rows, meta, read_heartbeat(hb), spans


@pytest.fixture(scope="module", params=list(MODES))
def runs(request, tmp_path_factory):
    import raft_tla_tpu.obs as ref_obs
    import raft_tla_tpu_torch.obs as port_obs
    from raft_tla_tpu.engine.spill import SpillEngine as RefSpill
    from test_obs import TINY as REF_TINY
    assert repr(REF_TINY) == repr(TINY)
    mode = MODES[request.param]
    tmp = tmp_path_factory.mktemp("obs_spill")
    ref = _run(ref_obs, RefSpill(REF_TINY, **KW, **mode), tmp, "ref")
    eng = SpillEngine(TINY, **KW, **mode, device="cpu")
    port = _run(port_obs, eng, tmp, "port")
    return request.param, eng, port, ref


def _dispatch_rows(rows):
    return [r for r in rows if r["kind"] in ("level", "burst")]


def test_dispatch_rows_equal_the_reference_row_for_row(runs):
    mode, eng, (r, rows, _m, _hb, _s), (ref_r, ref_rows, *_rest) = runs
    assert (r.distinct_states, r.depth, r.level_sizes) == \
        (ref_r.distinct_states, ref_r.depth, ref_r.level_sizes)
    got, want = _dispatch_rows(rows), _dispatch_rows(ref_rows)
    assert [x["kind"] for x in got] == [x["kind"] for x in want]
    assert sum(x["kind"] == "level" for x in got) == \
        r.depth - r.levels_fused
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert not set(CHECK_COUNTER_KEYS) - set(a)
        assert {k: v for k, v in a.items() if k not in _TIMES} == \
            {k: v for k, v in b.items() if k not in _TIMES}
    assert [x["dispatch"] for x in got] == list(range(1, len(got) + 1))
    # each level row holds its level's final counters (after the drain,
    # the sweep and the reseed): its frontier is the level's size
    lv = [x for x in got if x["kind"] == "level"]
    assert [x["frontier"] for x in lv] == \
        [r.level_sizes[x["depth"] - 1] for x in lv]
    dist = [x["distinct_states"] for x in got]
    assert dist == sorted(set(dist)) and dist[-1] == r.distinct_states
    # the path the rows record
    kinds = {x["kind"] for x in got}
    if mode == "plain":
        assert kinds == {"burst", "level"} and r.burst_bailouts >= 1
    else:
        assert kinds == {"level"} and eng.reseeds >= 1
    assert max(eng.segments_by_level.values()) > 1


def test_final_row_stats_and_checkpoint_meta_agree(runs):
    _mode, _eng, (r, rows, meta, _hb, _s), _ref = runs
    stats = check_stats(r.metrics.as_dict(), r.seconds, len(r.violations),
                        fp_bits=64)
    last = rows[-1]
    assert last["kind"] in ("level", "burst")
    for k in BURST_COUNTER_KEYS:
        assert last[k] == stats[k] == meta[k], k
    assert meta["distinct"] == stats["distinct_states"] == \
        last["distinct_states"]
    assert meta["spill"] is True and meta["depth"] == r.depth == DEPTH
    assert tuple(r.metrics.keys()) == CHECK_COUNTER_KEYS


def test_heartbeat_matches_the_run_and_the_reference(runs):
    _mode, _eng, (r, rows, _m, hb, _s), (_rr, _rrows, _rm, ref_hb,
                                          _rs) = runs
    assert hb["status"] == ref_hb["status"] == "finished"
    assert hb["depth"] == ref_hb["depth"] == r.depth == DEPTH
    assert hb["states_enqueued"] == ref_hb["states_enqueued"] == \
        r.distinct_states
    assert hb["beats"] == ref_hb["beats"] == len(_dispatch_rows(rows)) + 1
    assert hb["run_id"] is None or hb["run_id"] == rows[0]["run_id"]


def test_spans_at_the_reference_sites_and_no_compile_on_the_cpu(runs):
    mode, eng, (r, rows, _m, _hb, spans), (*_r, ref_spans) = runs
    tot = {k: v["count"] for k, v in spans.totals().items()}
    want = {k: v["count"] for k, v in ref_spans.totals().items()}
    assert "compile" not in tot
    assert tot == {k: v for k, v in want.items() if k != "compile"}
    n_level = sum(x["kind"] == "level" for x in rows)
    assert tot["level_dispatch"] == n_level
    if mode == "plain":
        assert tot["burst_dispatch"] == r.burst_dispatches
        assert not {"host_sweep", "h2d_stage", "sweep_overlap"} & set(tot)
    else:
        # one sweep for the roots and one for each level; a staged
        # image that served a sweep is one sweep_overlap
        assert tot["host_sweep"] == r.depth + 1
        assert tot["checkpoint"] == r.depth
        assert tot["sweep_overlap"] == eng.sweep_stage_hits > 0
        assert eng.sweep_stage_misses > 0
        lv = [(e["ts"], e["ts"] + e["dur"]) for e in spans.events
              if e["name"] == "level_dispatch"]
        staged = [e for e in spans.events if e["name"] == "h2d_stage"]
        assert len(staged) == tot["h2d_stage"] > 0
        for e in staged:
            assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                       for a, b in lv)
