"""The batched serving slice's host-side units against the JAX package's:
job parsing and its error texts, the result-cache keys (equal across
the packages, so one cache directory answers both), the spec hooks
(``pad_rung``, ``serve_bucket`` ceilings, ``serve_runtime`` arrays),
the result cache's LRU, the wave-state files in both directions,
``resolve_wave_mesh`` and the SLO histogram.  No engine runs here."""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raft_tla_tpu.serve.batch as RB  # noqa: E402
import raft_tla_tpu.serve.cache as RC  # noqa: E402
import raft_tla_tpu.serve.jobs as RJ  # noqa: E402
import raft_tla_tpu.serve.wavestate as RW  # noqa: E402
import raft_tla_tpu.spec as RS  # noqa: E402
from raft_tla_tpu.config import Bounds as RBounds  # noqa: E402
from raft_tla_tpu.config import ModelConfig as RModel  # noqa: E402
from raft_tla_tpu.spec.paxos.config import PaxosConfig as RPax  # noqa: E402

import raft_tla_tpu_torch.serve.batch as PB  # noqa: E402
import raft_tla_tpu_torch.serve.cache as PC  # noqa: E402
import raft_tla_tpu_torch.serve.jobs as PJ  # noqa: E402
import raft_tla_tpu_torch.serve.wavestate as PW  # noqa: E402
import raft_tla_tpu_torch.spec as PS  # noqa: E402
from raft_tla_tpu_torch.config import Bounds as PBounds  # noqa: E402
from raft_tla_tpu_torch.config import ModelConfig as PModel  # noqa: E402
from raft_tla_tpu_torch.spec.paxos.config import \
    PaxosConfig as PPax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs/tlc_membership/raft.cfg")


def _micro(M, B, **bounds):
    kw = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
    kw.update(bounds)
    return M(n_servers=2, init_servers=(0, 1), values=(1,),
             next_family="NextAsync", symmetry=True,
             max_inflight_override=4, bounds=B.make(**kw))


# (label, factory of the job's config given the package's classes)
CONFIGS = [
    ("micro", lambda M, B, P: _micro(M, B)),
    ("micro-mt2", lambda M, B, P: _micro(M, B, max_timeouts=2,
                                         max_terms=3)),
    ("micro-fc", lambda M, B, P: _micro(M, B).with_(
        invariants=("FirstCommit",))),
    ("paxos", lambda M, B, P: P(n_servers=2, n_ballots=2, n_values=1)),
    ("paxos-stock", lambda M, B, P: P()),
    ("paxos-3i", lambda M, B, P: P(n_servers=3, n_ballots=3, n_values=1,
                                   n_instances=3)),
]


def _both(factory):
    return (factory(RModel, RBounds, RPax), factory(PModel, PBounds, PPax))


@pytest.mark.parametrize("name,factory", CONFIGS, ids=[c[0] for c in
                                                       CONFIGS])
def test_cache_key_repr_and_ir_fingerprint_equal_reference(name, factory):
    rc, pc = _both(factory)
    assert repr(pc) == repr(rc)
    assert PS.spec_of(pc).fingerprint() == RS.spec_of(rc).fingerprint()
    for kw in ({}, {"max_depth": 7, "store_states": False},
               {"stop_on_violation": False, "max_states": 99}):
        assert PJ.Job(pc, **kw).cache_key() == RJ.Job(rc, **kw).cache_key()
        assert PJ.Job(pc, **kw).opts_fingerprint() == \
            RJ.Job(rc, **kw).opts_fingerprint()
    # priority is a scheduling property, outside the key
    assert PJ.Job(pc, priority=5).cache_key() == PJ.Job(pc).cache_key()


def test_seeded_job_cache_key_equals_reference():
    rc, pc = _both(CONFIGS[0][1])
    seed = {"ct": np.arange(2, dtype=np.int32),
            "bag": np.array([1, 2, 3], np.uint32)}
    assert PJ.Job(pc, seed_states=[seed]).cache_key() == \
        RJ.Job(rc, seed_states=[seed]).cache_key()
    assert PJ.Job(pc, seed_states=[seed]).cache_key() != \
        PJ.Job(pc).cache_key()


GOOD = [
    {"spec": "raft", "config": CFG, "max_depth": 3, "label": "a"},
    {"spec": "raft", "config": CFG, "overrides": {
        "servers": 2, "values": [1], "max_inflight": 4,
        "next": "NextAsync", "symmetry": False,
        "invariants": ["FirstCommit"],
        "bounds": {"max_log_length": 1, "max_timeouts": 2,
                   "max_terms": 3}}, "keep_going": True, "store": False,
     "priority": 3},
    {"spec": "raft", "config": CFG, "overrides": {"servers": 4}},
    {"spec": "paxos", "config": {"acceptors": 2, "ballots": 3,
                                 "values": 1}},
    {"spec": "paxos", "config": "default", "max_states": 10},
    {"spec": "paxos"},
]


@pytest.mark.parametrize("obj", GOOD, ids=[f"job{i}" for i in
                                           range(len(GOOD))])
def test_job_from_dict_equals_reference(obj):
    rj = RJ.job_from_dict(dict(obj))
    pj = PJ.job_from_dict(dict(obj))
    assert repr(pj.cfg) == repr(rj.cfg)
    assert pj.cache_key() == rj.cache_key()
    assert (pj.max_depth, pj.max_states, pj.stop_on_violation,
            pj.store_states, pj.label, pj.priority) == \
        (rj.max_depth, rj.max_states, rj.stop_on_violation,
         rj.store_states, rj.label, rj.priority)


BAD = [
    ["not a dict"],
    {"spec": "raft", "config": CFG, "color": 1},
    {"spec": "tla"},
    {"spec": "raft", "config": 3},
    {"spec": "raft", "config": CFG, "overrides": {"sevrers": 2}},
    {"spec": "raft", "config": CFG, "overrides": {"next": "Nxt"}},
    {"spec": "raft", "config": CFG, "overrides": {"invariants": ["Nope"]}},
    {"spec": "raft", "config": CFG, "overrides": {"bounds": {"mll": 1}}},
    {"spec": "paxos", "overrides": {"servers": 2}},
    {"spec": "paxos", "config": 7},
    {"spec": "raft", "config": CFG, "max_depth": -1},
    {"spec": "raft", "config": CFG, "max_states": True},
    {"spec": "raft", "config": CFG, "priority": "high"},
]


@pytest.mark.parametrize("obj", BAD, ids=[f"bad{i}" for i in
                                          range(len(BAD))])
def test_job_from_dict_errors_equal_reference(obj):
    with pytest.raises(ValueError) as want:
        RJ.job_from_dict(obj, where="jobs.jsonl:4")
    with pytest.raises(ValueError) as got:
        PJ.job_from_dict(obj, where="jobs.jsonl:4")
    assert str(got.value) == str(want.value)


def test_load_jobs_equals_reference(tmp_path):
    p = tmp_path / "jobs.jsonl"
    p.write_text("# a comment\n\n" + "\n".join(json.dumps(o)
                                                for o in GOOD) + "\n")
    rj, pj = RJ.load_jobs(str(p)), PJ.load_jobs(str(p))
    assert [j.cache_key() for j in pj] == [j.cache_key() for j in rj]
    p.write_text(json.dumps(GOOD[0]) + "\n{not json\n")
    with pytest.raises(ValueError) as want:
        RJ.load_jobs(str(p))
    with pytest.raises(ValueError) as got:
        PJ.load_jobs(str(p))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("v,floor", [(0, 1), (1, 1), (2, 1), (3, 1),
                                     (5, 4), (1, 4), (9, 2), (16, 4)])
def test_pad_rung_equals_reference(v, floor):
    assert PS.pad_rung(v, floor) == RS.pad_rung(v, floor)


BUCKET_CONFIGS = CONFIGS + [
    ("cfg-3s", lambda M, B, P: M(bounds=B.make(
        max_log_length=2, max_timeouts=1, max_terms=2,
        max_client_requests=3))),
    ("cfg-no-constraints", lambda M, B, P: M(
        constraints=(), bounds=B.make(max_timeouts=2))),
    ("cfg-inflight", lambda M, B, P: _micro(M, B).with_(
        max_inflight_override=5)),
]


@pytest.mark.parametrize("name,factory", BUCKET_CONFIGS,
                         ids=[c[0] for c in BUCKET_CONFIGS])
def test_serve_bucket_and_runtime_equal_reference(name, factory):
    """The ceiling, the bucket params and the job's runtime arrays
    under the ceiling's expander equal the reference's."""
    from raft_tla_tpu.engine.expand import Expander as RExpander
    from raft_tla_tpu_torch.engine.expand import Expander as PExpander
    rc, pc = _both(factory)
    rir, pir = RS.spec_of(rc), PS.spec_of(pc)
    r_ceil, r_par = rir.serve_bucket(rc)
    p_ceil, p_par = pir.serve_bucket(pc)
    assert repr(p_ceil) == repr(r_ceil) and p_par == r_par
    rt_r = rir.serve_runtime(RExpander(r_ceil), rc)
    rt_p = pir.serve_runtime(PExpander(p_ceil, torch.device("cpu")), pc)
    assert sorted(rt_p) == sorted(rt_r) == ["bounds", "mask", "thr"]
    for k in rt_r:
        a, b = np.asarray(rt_r[k]), np.asarray(rt_p[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert (a == b).all(), k


def test_result_cache_lru_and_files_shared_with_reference(tmp_path):
    d = str(tmp_path / "c")
    pc = PC.ResultCache(d, max_bytes=400)
    pc.put("k1", {"x": "a" * 100})
    pc.put("k2", {"x": "b" * 100})
    os.utime(os.path.join(d, "k1.json"), (1, 1))
    os.utime(os.path.join(d, "k2.json"), (2, 2))
    assert pc.get("k1")["x"] == "a" * 100     # a get refreshes recency
    pc.put("k3", {"x": "c" * 150})
    assert sorted(os.listdir(d)) == ["k1.json", "k3.json"]
    rc = RC.ResultCache(d)
    assert rc.get("k3") == PC.ResultCache(d).get("k3")
    rc.put("k4", {"y": 1})
    assert PC.ResultCache(d).get("k4") == {"y": 1, "cache_key": "k4"}
    with open(os.path.join(d, "k5.json"), "w") as fh:
        json.dump({"cache_key": "other"}, fh)
    assert PC.ResultCache(d).get("k5") is None
    with pytest.raises(ValueError) as got:
        PC.ResultCache(d, max_bytes=0)
    with pytest.raises(ValueError) as want:
        RC.ResultCache(d, max_bytes=0)
    assert str(got.value) == str(want.value)


def _wave_arrays(rng):
    return {"fm": rng.random(512) < 0.5,
            "gd": np.arange(512, dtype=np.int32),
            "vis": rng.integers(0, 2 ** 32, (2, 1 << 10), dtype=np.uint32),
            "fr|ct": rng.integers(0, 4, (2, 512), dtype=np.int8),
            "fr|bag": rng.integers(0, 2 ** 32, (5, 512), dtype=np.uint32),
            "cursors": np.array([3, 9, 6], np.int64),
            "par|0": np.full(3, -1, np.int32)}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wave_state_files_load_in_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(7)
    arrays = _wave_arrays(rng)
    book = {"cache_key": "raft-k", "depth": 4, "n_arch": 1}
    stores = {"port": PW.WaveStateStore(str(tmp_path)),
              "reference": RW.WaveStateStore(str(tmp_path))}
    other = "reference" if writer == "port" else "port"
    stores[writer].save("raft-k", arrays, book)
    got = stores[other].load("raft-k")
    assert got is not None
    arr, bk = got
    assert bk == book and sorted(arr) == sorted(arrays)
    for k, v in arrays.items():
        assert arr[k].dtype == v.dtype and (arr[k] == v).all(), k
    assert stores[other].load("raft-other") is None
    stores[other].drop("raft-k")
    assert stores[writer].load("raft-k") is None


def test_torn_wave_state_is_a_miss(tmp_path):
    st = PW.WaveStateStore(str(tmp_path))
    st.save("k", {"cursors": np.zeros(3, np.int64)}, {"cache_key": "k"})
    path = os.path.join(str(tmp_path), "k.wave.npz")
    with open(path, "r+b") as fh:
        fh.truncate(10)
    with pytest.warns(UserWarning, match="integrity"):
        assert st.load("k") is None


@pytest.mark.parametrize("value", [None, "auto", "off", 0, 1, "1",
                                   "1x1", (0, 1), (1, 1)])
def test_wave_mesh_resolves_to_one_device(value):
    assert PB.resolve_wave_mesh(value) == (0, 1)


@pytest.mark.parametrize("value", [2, "4", "2x1", "1x2", (2, 2)])
def test_wave_mesh_larger_mesh_refused_naming_9d(value):
    with pytest.raises(ValueError, match="9d"):
        PB.resolve_wave_mesh(value)


@pytest.mark.parametrize("value", ["mesh", "axb", "0x2", -1])
def test_wave_mesh_malformed_message_equals_reference(value):
    with pytest.raises(ValueError) as want:
        RB.resolve_wave_mesh(value)
    with pytest.raises(ValueError) as got:
        PB.resolve_wave_mesh(value)
    assert str(got.value) == str(want.value)


def test_slo_histogram_equals_reference():
    xs = [0.0, 0.01, 0.02, 0.3, 2.0, 29.0, 31.0, 500.0]
    assert PB.slo_histogram(xs) == RB.slo_histogram(xs)
    assert PB._SLO_EDGES == RB._SLO_EDGES and PB._MAX_WAVE == 8


def test_scheduler_refuses_executable_cache_naming_8b():
    from raft_tla_tpu_torch.serve import WaveScheduler
    with pytest.raises(ValueError, match="8b"):
        WaveScheduler(exec_cache="some/dir", device="cpu")
    with pytest.raises(ValueError, match="max_wave"):
        WaveScheduler(max_wave=0, device="cpu")
    with pytest.raises(ValueError, match="wave_yield"):
        WaveScheduler(wave_yield=0, device="cpu")
