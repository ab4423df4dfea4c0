"""The chunk step with no host read: the second compaction (FCAP ->
OCAP fresh rows, then one contiguous append) under the tiny capacities
of test_torch_engine.py's replay test, where the fresh rows overflow
OCAP (oovf) and the level buffer overflows (ovf) and each overflowing
chunk reverts its own inserts on the spot, held against the JAX
package's Engine; and a guard that no chunk step and no burst
iteration reads anything back (no ``item``, no ``nonzero``, no boolean
indexing), while ``_finalize`` reads once per level.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from raft_tla_tpu.config import Bounds as JB, DEFAULT_INVARIANTS as JDI
from raft_tla_tpu.config import ModelConfig as JC

from raft_tla_tpu_torch.config import (Bounds, DEFAULT_INVARIANTS,
                                       ModelConfig)
from raft_tla_tpu_torch.engine.bfs import Engine

torch.set_num_threads(1)

# test_torch_engine.py's "crash" case (tests/test_engine.py's MICRO:
# NextAsyncCrash, no symmetry, MaxInFlight 4) with FirstCommit
CRASH = dict(n_servers=2, init_servers=(0, 1), values=(1,),
             symmetry=False, max_inflight_override=4)
BOUNDS = dict(max_log_length=1, max_timeouts=1, max_client_requests=1)
DEPTH = 10
TINY = dict(chunk=16, lcap=64, vcap=64, ocap=16, fcap=32)


def cfgs():
    jc = JC(bounds=JB.make(**BOUNDS), invariants=JDI + ("FirstCommit",),
            **CRASH)
    tc = ModelConfig(bounds=Bounds.make(**BOUNDS),
                     invariants=DEFAULT_INVARIANTS + ("FirstCommit",),
                     **CRASH)
    assert repr(jc) == repr(tc)
    return jc, tc


def summary(res):
    return dict(
        distinct=res.distinct_states, generated=res.generated_states,
        depth=res.depth, level_sizes=list(res.level_sizes),
        faults=res.overflow_faults, viol_global=res.violations_global,
        violations=sorted((v.invariant, v.state_id)
                          for v in res.violations))


_JAX = {}


def jax_summary():
    if "s" not in _JAX:
        from raft_tla_tpu.engine.bfs import Engine as JEngine
        je = JEngine(cfgs()[0], chunk=64, burst=False)
        _JAX["s"] = summary(je.check(max_depth=DEPTH))
    return _JAX["s"]


def finalize_flags(eng):
    """Wrap the engine's finalize; returns the list that collects each
    level's (ovf, oovf) flags."""
    seen = []
    fin = eng._finalize

    def wrapped(st):
        scal, inv_ok = fin(st)
        seen.append((scal[4], scal[9]))
        return scal, inv_ok
    eng._finalize = wrapped
    return seen


@pytest.mark.parametrize("burst", [False, True], ids=["levels", "burst"])
def test_ocap_and_level_overflow_replays_match_jax(burst):
    _jc, tc = cfgs()
    eng = Engine(tc, burst=burst, device="cpu", **TINY)
    seen = finalize_flags(eng)
    got = summary(eng.check(max_depth=DEPTH))
    assert got == jax_summary()
    assert any(o for o, _ in seen), "no level buffer overflow (ovf)"
    assert any(o for _, o in seen), "no fresh-row overflow (oovf)"
    assert eng.OCAP > 16 and eng.LCAP > 64


aten = torch.ops.aten
HOST_READS = {aten._local_scalar_dense.default, aten.item.default,
              aten.is_nonzero.default, aten.nonzero.default,
              aten.masked_select.default, aten._unique2.default,
              aten.unique_dim.default, aten.unique_consecutive.default,
              aten.repeat_interleave.Tensor}
INDEXING = {aten.index.Tensor, aten.index_put.default,
            aten.index_put_.default, aten._index_put_impl_.default}


class NoHostRead(TorchDispatchMode):
    """Raises on every op that needs a value on the host: a scalar
    read, a data-dependent output shape (nonzero, masked_select,
    unique, repeat_interleave) or indexing by a boolean mask; and on
    host data made into a tensor (``lift_fresh``: a list index,
    ``torch.tensor``, ``from_numpy``), which on the card is a copy that
    no captured graph may hold.  ``paused`` lets the dedup kernel's
    plain twin, its stand-in on the CPU, work on the host."""

    paused = False

    def __init__(self, warm_up: bool = False):
        super().__init__()
        self.warm_up = warm_up

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if NoHostRead.paused:
            return func(*args, **kwargs)
        if func in HOST_READS:
            raise AssertionError(f"host read: {func}")
        if func is aten.lift_fresh.default and not self.warm_up:
            raise AssertionError("host data copied in")
        if func in INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None):
            raise AssertionError(f"boolean-mask indexing: {func}")
        return func(*args, **kwargs)


def test_the_guard_catches_host_reads():
    x = torch.arange(4)
    for read in (lambda: x.sum().item(), lambda: x.nonzero(),
                 lambda: x[x > 1], lambda: bool(x.any()),
                 lambda: x[[1, 2]], lambda: torch.tensor([1, 2])):
        with pytest.raises(AssertionError), NoHostRead():
            read()


def guard(eng, name, kind):
    """Run every call of the engine's method ``name`` under the guard;
    the first call for a graph key is the warm-up, which may build the
    constants it caches (as the card's uncaptured first call does).
    Returns the call counter."""
    calls, seen = [0], set()
    fn = getattr(eng, name)

    def wrapped(st, *a):
        calls[0] += 1
        key = eng._graph_key(kind, st)
        with NoHostRead(warm_up=key not in seen):
            out = fn(st, *a)
        seen.add(key)
        return out
    setattr(eng, name, wrapped)
    return calls


@pytest.mark.parametrize("mode", [
    dict(), dict(incremental_fp=False), dict(sym_canon="sort", hcap=1)],
    ids=["incremental", "direct", "sort"])
def test_step_and_burst_body_read_nothing_back(mode, monkeypatch):
    """Every chunk step and every burst iteration of a check with tiny
    capacities (so overflowing chunks and bails run guarded too) reads
    nothing back, and past the first call for its graph key copies no
    host data in; each level's finalize reads once."""
    tc = cfgs()[1].with_(symmetry=True)
    if "sym" not in _JAX:
        _JAX["sym"] = summary(Engine(tc, chunk=64, burst=False,
                                     device="cpu").check(max_depth=DEPTH))
    eng = Engine(tc, device="cpu", **TINY, **mode)
    from raft_tla_tpu_torch.engine import bfs
    twin = bfs.probe_claim_insert

    def paused_twin(*a):
        NoHostRead.paused = True
        try:
            return twin(*a)
        finally:
            NoHostRead.paused = False
    monkeypatch.setattr(bfs, "probe_claim_insert", paused_twin)
    steps = guard(eng, "_chunk_step", "step")
    bodies = guard(eng, "_burst_body", "burst")
    fins = [0]
    fin = eng._finalize

    def counted(st):
        fins[0] += 1
        return fin(st)
    eng._finalize = counted
    reads = [0]
    tolist = torch.Tensor.tolist

    def counted_tolist(t):
        reads[0] += 1
        return tolist(t)
    monkeypatch.setattr(torch.Tensor, "tolist", counted_tolist)
    res = eng.check(max_depth=DEPTH)
    assert summary(res) == _JAX["sym"]
    assert steps[0] > 0 and bodies[0] > 0 and res.burst_dispatches > 0
    assert eng._graphs.replays == 0          # the CPU runs them eagerly
    # one read per finalize, and per dispatch one per group of burst
    # iterations (at most one per iteration)
    assert fins[0] + res.burst_dispatches <= reads[0] <= \
        fins[0] + bodies[0]
