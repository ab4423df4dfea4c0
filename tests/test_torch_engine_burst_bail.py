"""A forced bail of the port's fused small-level path against the JAX
package's Engine(burst=True) at the same capacities: fresh rows past a
small OCAP bail the burst, and the per-level path grows the cap and
replays the level, with the reference's answer, bailout count and
archives.  (One file for it: the reference compiles its per-level step
at both capacities.)
"""

import torch

from raft_tla_tpu_torch.engine.bfs import Engine

from test_torch_engine_burst import archives_equal, cfgs, summary

torch.set_num_threads(1)


def test_forced_bail_matches_jax():
    """OCAP 64 at chunk 64: the burst commits 8 levels and bails on the
    9th (oovf), which the per-level path replays with OCAP grown."""
    from raft_tla_tpu.engine.bfs import Engine as JEngine
    jc, tc = cfgs()
    je = JEngine(jc, chunk=64, ocap=64, burst=True)
    want = summary(je.check(max_depth=9))
    eng = Engine(tc, chunk=64, ocap=64, device="cpu")
    got = summary(eng.check(max_depth=9))
    assert got == want
    assert got["bailouts"] == 1 and got["fused"] == 8
    assert eng.OCAP == je.OCAP > 64
    archives_equal(eng, je)
