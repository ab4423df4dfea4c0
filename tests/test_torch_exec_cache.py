"""The executable cache (``serve/exec_cache.py``) against the reference's:
the reference's four exec-cache tests run on the port's ``ExecCache``
(key stability, the round trip through an injected serializer, the
corrupt, foreign and mismatch misses, LRU eviction, the ``batch`` exit-2
validations); equal key parts give equal keys in both packages, and an
entry written by either package reads in the other as a named miss;
``code_fingerprint`` covers the kernel's CUDA source; and at engine level
the port's ``run_jobs`` counts the same ``exec_cache_*`` counters and
exec spans as the reference's with a serializer that always raises,
with no ``.exec`` file written and no hit."""

import os
import pickle
import shutil
import time

import pytest
import torch

torch.set_num_threads(1)

from raft_tla_tpu.serve import exec_cache as REC  # noqa: E402

from raft_tla_tpu_torch.serve import exec_cache as PEC  # noqa: E402
from raft_tla_tpu_torch.serve import ExecCache  # noqa: E402

PAX_JOB = {"spec": "paxos",
           "config": {"acceptors": 2, "ballots": 2, "values": 1},
           "max_depth": 3, "label": "pax"}


class _FakeSerializer:
    """Round-trips in memory: the blob is an id into a registry."""
    name = "fake"
    _objs = {}

    def serialize(self, compiled):
        k = len(self._objs)
        self._objs[k] = compiled
        return pickle.dumps(k)

    def deserialize(self, blob):
        return self._objs[pickle.loads(blob)]


class _BrokenSerializer:
    name = "broken"

    def serialize(self, compiled):
        raise RuntimeError("this backend cannot serialize executables")

    def deserialize(self, blob):
        raise RuntimeError("this backend cannot serialize executables")


# -- the reference's four tests, on the port's ExecCache -------------------

def test_exec_cache_key_stability_and_parts():
    base = dict(backend=PEC.backend_fingerprint("cpu"), spec="raft",
                ceiling_cfg="cfgA", JP=2, chunk=128, guard_matmul=True)
    assert PEC.exec_key(base) == PEC.exec_key(dict(base))
    assert PEC.exec_key(base) == PEC.exec_key(
        dict(reversed(list(base.items()))))
    for change in (dict(JP=4), dict(ceiling_cfg="cfgB"),
                   dict(guard_matmul=False), dict(spec="paxos"),
                   dict(backend={"platform": "other"})):
        assert PEC.exec_key({**base, **change}) != PEC.exec_key(base)


def test_exec_cache_roundtrip_corrupt_and_foreign_miss(tmp_path):
    cache = ExecCache(str(tmp_path), serializer=_FakeSerializer())
    sentinel = object()
    assert cache.store("k1", sentinel)
    ex, why = cache.load("k1")
    assert ex is sentinel and why == "hit"
    ex, why = cache.load("k2")
    assert ex is None and why == "cold: no entry for this key"
    with open(tmp_path / "k3.exec", "wb") as fh:
        fh.write(b"\x80\x04 garbage")
    ex, why = cache.load("k3")
    assert ex is None and why.startswith("corrupt entry (unreadable: ")
    os.replace(tmp_path / "k1.exec", tmp_path / "k4.exec")
    ex, why = cache.load("k4")
    assert ex is None and why.startswith("foreign entry (")
    cache2 = ExecCache(str(tmp_path), serializer=_BrokenSerializer())
    assert not cache2.store("k5", sentinel)
    assert cache2.store_failures == 1
    assert cache2.store_fail_reasons[-1] == (
        "backend cannot serialize executables (RuntimeError: this "
        "backend cannot serialize executables)")
    with open(tmp_path / "k6.exec", "wb") as fh:
        pickle.dump({"format": 1, "key": "k6", "parts": {},
                     "serializer": "fake", "blob": b"x"}, fh)
    ex, why = cache2.load("k6")
    assert ex is None and why == ("serializer mismatch (entry: 'fake', "
                                  "runtime: 'broken')")
    stats = cache.stats()
    assert stats["exec_cache_hits"] == 1
    assert stats["exec_cache_misses"] >= 3


def test_exec_cache_lru_bytes_eviction(tmp_path):
    def entry_bytes(key):
        cache = ExecCache(str(tmp_path), serializer=_FakeSerializer())
        cache.store(key, object())
        return os.path.getsize(tmp_path / f"{key}.exec")

    one = entry_bytes("probe")
    os.remove(tmp_path / "probe.exec")
    with pytest.raises(ValueError, match="must be positive"):
        ExecCache(str(tmp_path), max_bytes=0)
    cache = ExecCache(str(tmp_path), serializer=_FakeSerializer(),
                      max_bytes=int(2.5 * one))
    assert cache.store("a", object())
    time.sleep(0.05)
    assert cache.store("b", object())
    time.sleep(0.05)
    assert cache.load("a")[1] == "hit"
    time.sleep(0.05)
    assert cache.store("c", object())
    assert cache.evictions == 1
    assert sorted(p.name for p in tmp_path.glob("*.exec")) == \
        ["a.exec", "c.exec"]
    tiny = ExecCache(str(tmp_path / "tiny"),
                     serializer=_FakeSerializer(), max_bytes=1)
    assert tiny.store("big", object())
    assert os.path.exists(tmp_path / "tiny" / "big.exec")
    assert tiny.evictions == 0
    assert tiny.store("big2", object())
    assert not os.path.exists(tmp_path / "tiny" / "big.exec")
    unb = ExecCache(str(tmp_path / "unb"), serializer=_FakeSerializer())
    for i in range(4):
        unb.store(f"k{i}", object())
    assert unb.evictions == 0
    assert len(list((tmp_path / "unb").glob("*.exec"))) == 4


@pytest.mark.parametrize("extra,needle", [
    (["--executable-cache-max-bytes", "100"], "add --executable-cache"),
    (["--executable-cache", "EC", "--executable-cache-max-bytes", "-5"],
     "--executable-cache-max-bytes must be positive (got -5)"),
], ids=["bound-without-cache", "negative-bound"])
def test_exec_cache_max_bytes_cli_validation(tmp_path, capsys, extra,
                                             needle):
    from raft_tla_tpu.cli import main as ref_main
    from raft_tla_tpu_torch.cli import main as port_main
    extra = [str(tmp_path / "ec") if x == "EC" else x for x in extra]
    argv = ["batch", "--job", '{"spec": "paxos"}'] + extra
    assert port_main(argv + ["--device", "cpu"]) == 2
    err_p = capsys.readouterr().err
    assert ref_main(argv) == 2
    err_r = capsys.readouterr().err
    assert err_p == err_r and needle in err_p


# -- across the packages ---------------------------------------------------

def test_port_serializer_fails_every_store_by_name(tmp_path):
    cache = ExecCache(str(tmp_path))
    assert type(cache._ser) is PEC.TorchGraphSerializer
    assert not cache.store("k", object(), {"JP": 1})
    (why,) = cache.store_fail_reasons
    assert why.startswith("backend cannot serialize executables "
                          "(RuntimeError: a captured CUDA graph")
    assert os.listdir(tmp_path) == []
    assert cache.load("k", {"JP": 1}) == (
        None, "cold: no entry for this key")
    assert cache.stats()["exec_cache_hits"] == 0


def test_exec_key_and_containers_across_the_packages(tmp_path):
    """Equal parts give equal keys; a container either package writes
    reads in the other as "serializer mismatch" (another serializer) or
    "foreign entry" (other parts), never as a hit."""
    parts = dict(backend={"platform": "cpu"}, spec="paxos", JP=2,
                 ceiling_cfg="PaxosConfig(...)", fam_caps=[8, 16],
                 guard_matmul=True, wave_mesh=0)
    key = PEC.exec_key(parts)
    assert key == REC.exec_key(parts)
    assert PEC._FORMAT == REC._FORMAT
    for writer_mod, reader_mod in ((PEC, REC), (REC, PEC)):
        d = tmp_path / writer_mod.__name__.split(".")[0]
        writer = writer_mod.ExecCache(str(d), serializer=_FakeSerializer())
        assert writer.store(key, object(), parts)
        with open(d / f"{key}.exec", "rb") as fh:
            obj = pickle.load(fh)
        assert sorted(obj) == ["blob", "format", "key", "parts",
                               "serializer"]
        # the reader's own serializer is another one
        reader = reader_mod.ExecCache(str(d),
                                      serializer=_BrokenSerializer())
        ex, why = reader.load(key, parts)
        assert ex is None and why == ("serializer mismatch (entry: "
                                      "'fake', runtime: 'broken')")
        ex, why = reader.load(key, dict(parts, JP=4))
        assert ex is None and why == ("foreign entry (embedded key "
                                      "parts mismatch)")
        assert reader.hits == 0 and reader.misses == 2
    # the port's default serializer never revives a reference entry
    port = ExecCache(str(tmp_path / "raft_tla_tpu"))
    ex, why = port.load(key, parts)
    assert ex is None and why.startswith("serializer mismatch (entry: "
                                         "'fake'")


def test_code_fingerprint_covers_the_cuda_source(tmp_path):
    import raft_tla_tpu_torch
    src = os.path.dirname(raft_tla_tpu_torch.__file__)
    dst = tmp_path / "pkg"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "_build"))
    base = PEC.code_fingerprint(str(dst))
    assert base == PEC.code_fingerprint(str(dst))
    assert base == PEC.code_fingerprint()
    cu = dst / "csrc" / "probe_claim.cu"
    data = bytearray(cu.read_bytes())
    data[len(data) // 2] ^= 1
    cu.write_bytes(bytes(data))
    assert PEC.code_fingerprint(str(dst)) != base
    # a build output changes nothing
    (dst / "_build").mkdir()
    (dst / "_build" / "x.py").write_text("# built\n")
    assert PEC.code_fingerprint(str(dst)) == \
        PEC.code_fingerprint(str(dst))


# -- at engine level -------------------------------------------------------

def test_engine_counters_and_spans_equal_the_reference(tmp_path):
    """One paxos job at depth 3 through each package's ``run_jobs`` with
    an executable cache: the same exec_cache_* counters, the same
    ``bucket_exec_load``/``bucket_exec_store`` span counts, the same
    reports but the timing keys, and no entry file."""
    from raft_tla_tpu.obs import Obs as RObs
    from raft_tla_tpu.obs import SpanRecorder as RSpans
    from raft_tla_tpu.serve import Job as RJob
    from raft_tla_tpu.serve import job_from_dict as r_job
    from raft_tla_tpu.serve import run_jobs as r_run_jobs
    from raft_tla_tpu_torch.obs import Obs, SpanRecorder
    from raft_tla_tpu_torch.serve import job_from_dict, run_jobs
    from raft_tla_tpu.spec.paxos.config import PaxosConfig as RPax
    # the reference's first run_jobs in a process raises (its barrier
    # batching rule under jax 0.9.0); one caught call gets past it
    try:
        r_run_jobs([RJob(RPax(n_servers=2, n_ballots=1, n_values=1),
                         max_depth=1)], wave_mesh="off")
    except TypeError:
        pass
    r_sp = RSpans()
    r_ec = REC.ExecCache(str(tmp_path / "ref"),
                         serializer=_BrokenSerializer())
    ref = r_run_jobs([r_job(dict(PAX_JOB))], wave_mesh="off",
                     exec_cache=r_ec, obs=RObs(spans=r_sp))
    p_sp = SpanRecorder()
    p_ec = ExecCache(str(tmp_path / "port"))
    port = run_jobs([job_from_dict(dict(PAX_JOB))], exec_cache=p_ec,
                    obs=Obs(spans=p_sp), device="cpu")
    counters = ("exec_cache_hits", "exec_cache_misses",
                "exec_cache_stores", "exec_cache_store_failures",
                "exec_cache_evictions")
    got = {k: port.meta[k] for k in counters}
    assert got == {k: ref.meta[k] for k in counters}
    assert got == {"exec_cache_hits": 0, "exec_cache_misses": 1,
                   "exec_cache_stores": 0, "exec_cache_store_failures": 1,
                   "exec_cache_evictions": 0}
    assert port.meta["exec_cache_miss_reasons"] == \
        ref.meta["exec_cache_miss_reasons"] == \
        ["cold: no entry for this key"]
    (why,) = port.meta["exec_cache_store_fail_reasons"]
    assert why.startswith("backend cannot serialize executables (")
    for span in ("bucket_exec_load", "bucket_exec_store"):
        assert p_sp.totals()[span]["count"] == \
            r_sp.totals()[span]["count"] == 1
    timing = ("seconds", "states_per_sec", "wait_s", "service_s")
    drop = timing + ("dedup_kernel",)
    (p_rep,), (r_rep,) = ([o.report for o in rep.outcomes]
                          for rep in (port, ref))
    assert {k: v for k, v in p_rep.items() if k not in drop} == \
        {k: v for k, v in r_rep.items() if k not in drop}
    assert os.listdir(tmp_path / "port") == []
    # a second run in a new scheduler (a restart) recaptures: the cache
    # is still cold, and it still never hits
    again = run_jobs([job_from_dict(dict(PAX_JOB))], exec_cache=p_ec,
                     device="cpu")
    assert (again.meta["exec_cache_hits"], again.meta["exec_cache_misses"],
            again.meta["exec_cache_store_failures"]) == (0, 2, 2)


def test_bucket_engine_refuses_another_serializer(tmp_path):
    from raft_tla_tpu_torch.serve import BucketEngine
    from raft_tla_tpu_torch.serve.batch import _default_serve_bucket
    from raft_tla_tpu_torch.spec.paxos.config import PaxosConfig
    ceiling, params = _default_serve_bucket(
        PaxosConfig(n_servers=2, n_ballots=1, n_values=1))
    for ser in (_FakeSerializer(), _BrokenSerializer()):
        with pytest.raises(ValueError, match="port's serializer"):
            BucketEngine(ceiling, device="cpu", exec_cache=ExecCache(
                str(tmp_path), serializer=ser), **params)
    be = BucketEngine(ceiling, device="cpu",
                      exec_cache=str(tmp_path / "ok"), **params)
    parts = be._exec_key_parts(2)
    assert "donate" not in parts and parts["JP"] == 2
    assert parts["code"] == PEC.code_fingerprint()
    assert parts["wave_mesh"] == 0
