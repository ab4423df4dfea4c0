"""Paxos, the second ``SpecIR`` tenant (single-decree, with independent
multi-instance slots): the reference package's ``spec/paxos``, with its
oracle, codec and configuration kept as the port's own copies and its
kernels, predicates and fingerprints over batch-last torch tensors.
The engines run it unmodified, through ``get_spec("paxos")``.
"""

from .config import PaxosConfig  # noqa: F401
