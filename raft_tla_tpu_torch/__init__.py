"""raft_tla_tpu_torch: the Raft explicit-state model checker on PyTorch
and CUDA (an NVIDIA H100), ported from the JAX package ``raft_tla_tpu``.

Entry points: ``engine.bfs.Engine``, ``serve.run_jobs`` and ``python -m
raft_tla_tpu_torch check|trace|simulate|obs|batch``.  They run on the
CUDA device unless the caller asks for the CPU (``device="cpu"`` /
``--device cpu``); with no CUDA and no such request they raise.  The
package imports torch and numpy only.
"""
