"""Sharded checkpoints (format 4) between the packages, on the CPU at
zero tolerance: a file the reference's ``ShardedEngine`` wrote resumed
by the port's and the port's by the reference's, to the uninterrupted
answer, the two files' leaves equal (names, dtypes, shapes; the table
shards bit for bit); the mesh-size and engine-family refusals in the
reference's words; a portable image re-homed onto other mesh sizes and
onto the classic engine; a ``supervised_check`` retry after a chaos
dispatch fault (tests/test_resil.py's sharded case); and the
observability bundle's dispatch rows row for row against the
reference mesh's (tests/test_obs.py's mesh case).
"""

import json

import jax
import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JB, ModelConfig as JC
from raft_tla_tpu.config import NEXT_ASYNC as JNA
from raft_tla_tpu.parallel.mesh import ShardedEngine as JShardedEngine

from raft_tla_tpu_torch.config import Bounds, ModelConfig, NEXT_ASYNC
from raft_tla_tpu_torch.engine.bfs import CheckpointError, Engine
from raft_tla_tpu_torch.parallel.mesh import ShardedEngine
from raft_tla_tpu_torch.resil import chaos
from raft_tla_tpu_torch.resil.portable import load_portable_image
from raft_tla_tpu_torch.resil.supervisor import supervised_check
from test_torch_mesh import same_carry

torch.set_num_threads(1)

KW = dict(n_servers=2, init_servers=(0, 1), values=(1,), symmetry=True,
          max_inflight_override=4)
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
AT, DEPTH = 5, 10


def cfgs():
    jc = JC(next_family=JNA, bounds=JB.make(**BOUNDS), **KW)
    tc = ModelConfig(next_family=NEXT_ASYNC, bounds=Bounds.make(**BOUNDS),
                     **KW)
    assert repr(jc) == repr(tc)
    return jc, tc


def jax_mesh(D):
    return JShardedEngine(cfgs()[0], devices=jax.devices()[:D], chunk=16,
                          dedup_kernel="on")


def port_mesh(D, **kw):
    return ShardedEngine(cfgs()[1], devices=["cpu"] * D, chunk=16, **kw)


def summary(eng, res):
    return dict(
        counts=(res.distinct_states, res.generated_states, res.depth,
                list(res.level_sizes), res.violations_global),
        parents=np.concatenate(eng._parents).tolist(),
        lanes=np.concatenate(eng._lanes).tolist(),
        trace=[lbl for lbl, _ in eng.trace(res.distinct_states - 1)])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Checkpoints at depth AT: the reference mesh's and the port's at
    D = 2, the port classic engine's, the port spill engine's; and the
    port mesh's uninterrupted answer to DEPTH."""
    from raft_tla_tpu_torch.engine.spill import SpillEngine
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    out = {k: str(tmp / f"{k}.ckpt")
           for k in ("jax", "port", "classic", "spill")}
    jax_mesh(2).check(max_depth=AT, checkpoint_path=out["jax"],
                      checkpoint_every=AT)
    port_mesh(2).check(max_depth=AT, checkpoint_path=out["port"],
                       checkpoint_every=AT)
    Engine(cfgs()[1], chunk=16, device="cpu").check(
        max_depth=AT, checkpoint_path=out["classic"])
    SpillEngine(cfgs()[1], chunk=64, seg=1 << 10, device="cpu").check(
        max_depth=AT, checkpoint_path=out["spill"])
    eng = port_mesh(2)
    out["want"] = summary(eng, eng.check(max_depth=DEPTH))
    return out


def test_files_cross_between_the_packages(files):
    same_carry(files["port"], files["jax"])
    eng = port_mesh(2)
    assert summary(eng, eng.check(max_depth=DEPTH,
                                  resume_from=files["jax"])) == files["want"]
    je = jax_mesh(2)
    assert summary(je, je.check(max_depth=DEPTH,
                                resume_from=files["port"])) == files["want"]


def _refusal(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def test_refusals_name_the_mesh_size_and_the_engine_family(files):
    """A D = 2 file on a 4-shard mesh, a sharded file on the classic
    engine, a classic and a spill file on the mesh: each refused with
    the reference's message."""
    from raft_tla_tpu.engine.bfs import Engine as JEngine
    cases = [
        (lambda: port_mesh(4).check(resume_from=files["port"]),
         lambda: jax_mesh(4).check(resume_from=files["port"]),
         "4 devices (shard ownership"),
        (lambda: Engine(cfgs()[1], chunk=16, device="cpu").check(
            resume_from=files["port"]),
         lambda: JEngine(cfgs()[0], chunk=16).check(
             resume_from=files["port"]), "sharded-engine checkpoint"),
        (lambda: port_mesh(2).check(resume_from=files["classic"]),
         lambda: jax_mesh(2).check(resume_from=files["classic"]),
         "single-device checkpoint"),
        (lambda: port_mesh(2).check(resume_from=files["spill"]),
         lambda: jax_mesh(2).check(resume_from=files["spill"]),
         "resume it with SpillEngine"),
    ]
    for port, ref, words in cases:
        got, want = _refusal(port), _refusal(ref)
        assert got == want and got[0] == "CheckpointError", (got, want)
        assert words in got[1]


def test_portable_image_onto_other_meshes_and_the_classic_engine(files):
    """The D = 2 file as a portable image: re-homed by owner onto 1 and
    4 shards, and onto the classic engine, each lands on the
    uninterrupted counts and the image's archives; the global ids past
    the image follow the target's layout)."""
    img = load_portable_image(files["port"])
    n = sum(len(p) for p in img.parents)
    assert n
    for make in (lambda: port_mesh(4), lambda: port_mesh(1),
                 lambda: Engine(cfgs()[1], chunk=16, device="cpu")):
        eng = make()
        got = summary(eng, eng.check(max_depth=DEPTH, resume_image=img))
        assert got["counts"] == files["want"]["counts"]
        assert got["parents"][:n] == files["want"]["parents"][:n]


def test_supervised_chaos_retry_resumes_bit_exact(files, tmp_path):
    """A dispatch fault at the second level boundary: the supervisor
    resumes the mesh from its checkpoint and lands on the uninterrupted
    answer (tests/test_resil.py's sharded case)."""
    eng = port_mesh(2, burst_levels=2)
    chaos.install("dispatch:at=2")
    try:
        res, eng2, attempts = supervised_check(
            lambda: eng, retries=1, backoff=0.01,
            checkpoint_path=str(tmp_path / "mesh.ckpt"),
            checkpoint_every=1, max_depth=DEPTH, sleep=lambda s: None,
            reinit=False)
    finally:
        chaos.uninstall()
    assert attempts == 2
    assert summary(eng2, res) == files["want"]


def test_obs_dispatch_rows_equal_the_reference_mesh(tmp_path):
    """tests/test_obs.py's TINY on two shards with a ledger and a
    checkpoint every level: the same kinds of rows and, row for row,
    the same depth, frontier and counters as the reference mesh's; the
    final row's burst counters == the checkpoint's meta."""
    import raft_tla_tpu.obs as ref_obs
    import raft_tla_tpu_torch.obs as port_obs
    from test_obs import TINY as REF_TINY
    from test_torch_obs_engine import TINY, _TIMES, _dispatch_rows

    def run(pkg, make, name):
        led = str(tmp_path / f"{name}.jsonl")
        ck = str(tmp_path / f"{name}.ckpt")
        obs = pkg.Obs(ledger=pkg.RunLedger(led)).start()
        r = make().check(obs=obs, max_depth=20, checkpoint_path=ck,
                         checkpoint_every=1)
        obs.finish(depth=int(r.depth), states=int(r.distinct_states))
        z = np.load(ck, allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        z.close()
        return r, [json.loads(x) for x in open(led)], meta

    r, rows, meta = run(port_obs, lambda: ShardedEngine(
        TINY, devices=["cpu"] * 2, chunk=64, store_states=False), "port")
    rr, ref_rows, _m = run(ref_obs, lambda: JShardedEngine(
        REF_TINY, devices=jax.devices()[:2], chunk=64,
        store_states=False), "ref")
    assert [x["kind"] for x in rows] == [x["kind"] for x in ref_rows]
    got, want = _dispatch_rows(rows), _dispatch_rows(ref_rows)
    assert got and len(got) == len(want)
    for a, b in zip(got, want):
        assert {k: v for k, v in a.items() if k not in _TIMES} == \
            {k: v for k, v in b.items() if k not in _TIMES}
    for k in ("levels_fused", "burst_dispatches", "burst_bailouts",
              "distinct_states"):
        assert got[-1][k] == meta[{"distinct_states": "distinct"}.get(
            k, k)]
    assert (r.distinct_states, r.depth) == (rr.distinct_states, rr.depth)


def test_carry_converters_round_trip_a_reference_carry(files):
    """``convert.sharded_carry_from_jax`` turns the reference file's
    carry into one dict per shard in the port's layout (``vis`` [W, VB],
    batch-last rows, u32 as int32 bits), and ``sharded_carry_to_jax``
    gives back every leaf bit for bit."""
    from raft_tla_tpu_torch.convert import (sharded_carry_from_jax,
                                            sharded_carry_to_jax)
    from raft_tla_tpu_torch.engine.ckpt import ckpt_carry
    eng = port_mesh(2)
    z = np.load(files["jax"], allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    carry = ckpt_carry(files["jax"], z, eng._carry_template(), np.asarray)
    shards = sharded_carry_from_jax(carry, [torch.device("cpu")] * 2)
    assert len(shards) == 2 and "claims" not in shards[0]
    assert tuple(shards[1]["vis"].shape) == (eng.W, meta["VB"])
    assert shards[0]["vis"].dtype == torch.int32
    back = sharded_carry_to_jax(shards, meta["FC"], meta["SC"],
                                eng.ir.u32_keys)
    from raft_tla_tpu_torch.engine.ckpt import _tree_paths
    want = dict(_tree_paths(carry))
    got = dict(_tree_paths(back))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_fingerprint_gather_equals_the_reference():
    """The collective demo of the reference's dry run: every lane's
    successor fingerprint of rows split across the shards, gathered in
    shard order, equals the reference's ``shard_map`` + ``all_gather``
    on the enabled lanes."""
    import jax.numpy as jnp
    from raft_tla_tpu.engine.bfs import Engine as JEngine
    jc, tc = cfgs()
    pe = Engine(tc, chunk=16, device="cpu")
    pe.check(max_depth=4)
    rows = {k: np.concatenate([s[k] for s in pe._states])[:8]
            for k in pe._states[0]}
    got = port_mesh(2).device_fingerprint_gather(rows)
    svb = {k: jnp.asarray(v) for k, v in rows.items()}
    want = np.asarray(jax.jit(jax_mesh(2).device_fingerprint_gather)(svb))
    ok = np.asarray(JEngine(jc, chunk=16)._phase1(svb)[0])
    assert got.shape == want.shape == ok.shape + (want.shape[-1],)
    assert ok.any()
    assert np.array_equal(got[ok], want[ok])
