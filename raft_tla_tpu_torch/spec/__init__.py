"""The spec's operator surface (``SpecIR``) and the spec registry.

The engine never executes TLA+; it consumes a compiled operator
surface: an Init state, a packed layout and its codec, a registry of
action families (each with its parameter grid, its successor kernel,
its guard algebra and, where the action is affine, its delta algebra),
per-family density caps, the device predicates with the names they
answer to, and the symmetry-canonical fingerprinter.  ``SpecIR``
bundles exactly that, as the reference package's ``spec`` module does,
for its two tenants: raft (``raft_ir.py``) and paxos (``paxos/``).

The SoA *ctr* contract: every encoded state carries a ``ctr``
int32[NCTR] lane vector with ``C_GLOBLEN`` (history length) and
``C_OVERFLOW`` (un-representability fault) at the indices below — the
engine's harvest reads only these two.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple

import numpy as np

NCTR = 8
C_NLEADERS, C_NREQ, C_NTRIED, C_NMC, C_GLOBLEN, C_OVERFLOW = range(6)


@dataclass
class Family:
    """One action family: its successor kernel over compacted rows,
    its static parameter grid, a label maker, its guard algebra and
    optionally its delta algebra.

    ``fn(sv, der, *params)`` takes batch-last rows [..., N] and one
    int32 [N] tensor per parameter, and returns the successor rows.

    ``guard(offsets, lay, *lane_params) -> ([(feature, weight)],
    threshold)``: lane a is enabled exactly when the weighted sum of
    the kernels' guard features equals its threshold.

    ``delta(offsets, lay, *lane_params) -> [(slot, source, weight)]``:
    the successor is ``x'[slot] = x[slot] + Σ weight · psi[source]``
    over the flat int32 state view x, with psi = [1; x; the kernels'
    delta features] (``engine/expand.py``, the delta group).  Only
    affine families declare one; the others keep their kernel."""
    name: str
    fn: Callable
    params: Tuple[np.ndarray, ...]
    labeler: Callable
    guard: Optional[Callable] = None
    delta: Optional[Callable] = None

    @property
    def n_lanes(self):
        return len(self.params[0]) if self.params else 1


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
    state_to_obj: Callable            # (sv, hist) -> JSON-able dict
    state_from_obj: Callable          # dict -> (sv, hist)
    make_kernels: Callable            # lay -> kernels object
    build_families: Callable          # lay -> List[Family]
    family_density: Mapping[str, int]  # per-family enabled-lane density
    make_predicates: Callable         # lay -> device predicate object
    make_fingerprinter: Callable      # (cfg, sym_canon) -> fingerprinter
    symmetry_perms: Callable          # cfg -> [perm tuples]
    # (fpr, svT, prep) -> sig [S, N]: the permutation-equivariant
    # per-server signature the orbit-sort canonicalizer argsorts
    server_signature: Callable = None
    # the negated reachability targets of the cfg's "Test cases" (the
    # CLI's trace targets), and every invariant name the predicates
    # answer to (safety invariants and scenario properties)
    scenario_properties: Tuple[str, ...] = ()
    known_invariants: frozenset = frozenset()
    known_constraints: frozenset = frozenset()
    known_action_constraints: frozenset = frozenset()
    # invariants/constraints whose oracle form scans history records an
    # engine-emitted seed cannot carry (the CLI's seed-trace guard)
    glob_dependent: frozenset = frozenset()
    # the oracle twins (the differential anchor, ``--engine oracle``)
    oracle_explore: Callable = None       # explore(cfg, **kw)
    oracle_successors: Callable = None    # (sv, h, cfg) -> [(lbl, sv, h)]
    oracle_walk_key: Callable = None      # sv -> hashable identity key
    # cfg -> (seeds, interiors): the cfg's punctuated-search prefix pins
    prefix_pin_seeds: Optional[Callable] = None
    # (kern, lay) -> (svT -> int32 [W]): the random walkers' monotone
    # scenario score, which places their punctuated restart bases
    sim_progress: Optional[Callable] = None
    # the model config's class, whose defaults are the stock model
    default_config: Optional[Callable] = None
    # the state keys that hold u32 bit words: carried as int32 bit
    # patterns in tensors, stored as uint32 wherever numpy leaves the
    # port (checkpoint leaves, archives, the JAX package's arrays)
    u32_keys: Tuple[str, ...] = ()
    # bumped on IR-structure changes (the reference's field)
    version: int = 1

    @property
    def all_keys(self) -> Tuple[str, ...]:
        return self.view_keys + self.nonview_keys

    def fingerprint(self) -> str:
        """Short stable hash of the IR *structure* (not of any run
        config), the reference's: stamped into ``--stats-json`` and
        checkpoint meta so a resumed or compared run records which
        frontend compiled it.  Equal to the reference's for the same
        spec, since both hash the same description."""
        desc = json.dumps([
            self.name, self.version,
            sorted((k, int(v)) for k, v in
                   dict(self.family_density).items()),
            list(self.scenario_properties),
            sorted(self.known_invariants),
            sorted(self.known_constraints),
            sorted(self.known_action_constraints),
            list(self.view_keys), list(self.nonview_keys),
        ], separators=(",", ":"))
        return hashlib.sha256(desc.encode()).hexdigest()[:12]


def _build_raft() -> SpecIR:
    from .raft_ir import build_ir
    return build_ir()


def _build_paxos() -> SpecIR:
    from .paxos.ir import build_ir
    return build_ir()


_BUILDERS = {"raft": _build_raft, "paxos": _build_paxos}
_CACHE = {}

# every spec's u32 word keys (each ``build_ir`` sets its
# ``SpecIR.u32_keys`` from here): the conversions that are given no
# spec (``convert.py``) take the union, since no key is u32 in one spec
# and int32 in another
U32_KEYS = {"raft": ("bag",), "paxos": ("msgs",)}
ALL_U32_KEYS = frozenset(k for ks in U32_KEYS.values() for k in ks)


def spec_names() -> Tuple[str, ...]:
    return tuple(sorted(_BUILDERS))


def spec_of(cfg) -> SpecIR:
    """The IR handle for a model config (its ``spec`` class attribute;
    a config without one is raft's)."""
    return get_spec(getattr(cfg, "spec", "raft"))


def get_spec(name: str) -> SpecIR:
    """The IR handle of a spec by name, built on first use; an unknown
    name fails with the known-spec list, the reference's message."""
    if name not in _BUILDERS:
        raise ValueError(
            f"unknown spec {name!r}; known specs: "
            f"{', '.join(spec_names())}")
    ir = _CACHE.get(name)
    if ir is None:
        ir = _CACHE[name] = _BUILDERS[name]()
        assert ir.name == name, (ir.name, name)
    return ir
