"""The spec's operator surface (``SpecIR``), raft only.

The engine never executes TLA+; it consumes a compiled operator
surface: an Init state, a packed layout and its codec, a registry of
action families (each with its parameter grid, its successor kernel
and its guard algebra), per-family density caps, the device
predicates, and the symmetry-canonical fingerprinter.  ``SpecIR``
bundles exactly that, as the reference package's ``spec`` module does;
this port carries the raft frontend only.

The SoA *ctr* contract: every encoded state carries a ``ctr``
int32[NCTR] lane vector with ``C_GLOBLEN`` (history length) and
``C_OVERFLOW`` (un-representability fault) at the indices below — the
engine's harvest reads only these two.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Tuple

NCTR = 8
C_NLEADERS, C_NREQ, C_NTRIED, C_NMC, C_GLOBLEN, C_OVERFLOW = range(6)


@dataclass(frozen=True)
class SpecIR:
    """One spec's compiled operator surface (see module docstring)."""

    name: str
    make_layout: Callable             # cfg -> layout object
    init_state: Callable              # cfg -> (sv, hist) oracle pair
    encode: Callable                  # (lay, sv, hist) -> numpy SoA dict
    decode: Callable                  # (lay, numpy arrs) -> (sv, hist)
    narrow: Callable                  # (lay, tensors) -> storage dtypes
    widen: Callable                   # tensors -> kernel int32
    view_keys: Tuple[str, ...]        # state-identity arrays
    nonview_keys: Tuple[str, ...]     # history/feature arrays
    make_kernels: Callable            # lay -> kernels object
    build_families: Callable          # lay -> List[Family]
    family_density: Mapping[str, int]  # per-family enabled-lane density
    make_predicates: Callable         # lay -> device predicate object
    make_fingerprinter: Callable      # (cfg, sym_canon) -> fingerprinter
    symmetry_perms: Callable          # cfg -> [perm tuples]
    # (fpr, svT, prep) -> sig [S, N]: the permutation-equivariant
    # per-server signature the orbit-sort canonicalizer argsorts
    server_signature: Callable = None

    @property
    def all_keys(self) -> Tuple[str, ...]:
        return self.view_keys + self.nonview_keys


_RAFT = None


def spec_of(cfg) -> SpecIR:
    """The IR handle for a model config.  Only raft is ported."""
    global _RAFT
    name = getattr(cfg, "spec", "raft")
    if name != "raft":
        raise ValueError(
            f"spec {name!r} is not ported to raft_tla_tpu_torch yet; "
            "known specs: raft")
    if _RAFT is None:
        from .raft_ir import build_ir
        _RAFT = build_ir()
    return _RAFT
