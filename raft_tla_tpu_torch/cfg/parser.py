"""TLC ``.cfg`` front-end: the operator boundary the framework preserves.

Parses the reference's model files unchanged (BASELINE.json north star:
"SPECIFICATION/INVARIANT/CONSTANTS are read unchanged") into a
ModelConfig:

  * CONSTANTS: model-value bindings (``s1 = 1``), sets (``Server =
    {s1, s2, s3}``), ints (``NumRounds = 1``); string-valued model
    constants (roles, message types, entry tags) are validated but carry
    no information for us — our codec fixes their encodings.
  * INIT / NEXT: Init must be ``Init``; NEXT selects the Next-relation
    family (raft.tla:909-943).
  * SYMMETRY perms / VIEW vars: symmetry reduction toggle; the VIEW is
    always ``vars`` semantics here (identity excludes history).  A cfg
    with no VIEW line (apalache_no_membership) would make TLC fingerprint
    the ever-growing history — divergence documented: we keep VIEW vars.
  * CONSTRAINT(S) / ACTION_CONSTRAINT(S) / INVARIANT(S): names resolved
    against the predicate registries (singular and plural forms, the
    plural introducing an indented name list, as in the reference cfgs).

``load_paxos_model`` and ``paxos_config_from_obj`` are the ``--spec
paxos`` front-ends: a TLC .cfg of Paxos constants, or a JSON object of
them, onto a ``PaxosConfig``.

In-spec search bounds (MaxLogLength etc., raft.tla:22-30) are NOT
cfg-settable in the reference — editing the spec is required — so
``read_bounds_from_spec`` lifts them by scanning the sibling ``raft.tla``
(SURVEY §5 "Config" tier b).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional

from ..config import (Bounds, DEFAULT_CONSTRAINTS, DEFAULT_INVARIANTS,
                      ModelConfig, NEXT_ASYNC, NEXT_ASYNC_CRASH,
                      NEXT_DYNAMIC, NEXT_FULL)
from ..models import predicates as OP

_KEYWORDS = {
    "CONSTANTS", "CONSTANT", "SYMMETRY", "VIEW", "INIT", "NEXT",
    "CONSTRAINTS", "CONSTRAINT", "ACTION_CONSTRAINTS", "ACTION_CONSTRAINT",
    "INVARIANTS", "INVARIANT", "SPECIFICATION", "PROPERTIES", "PROPERTY",
}

_NEXT_FAMILIES = {
    "NextAsync": NEXT_ASYNC,
    "NextAsyncCrash": NEXT_ASYNC_CRASH,
    "Next": NEXT_FULL,
    "NextDynamic": NEXT_DYNAMIC,
}


class CfgError(ValueError):
    pass


def _tokenize(text: str) -> List[str]:
    out = []
    for line in text.splitlines():
        line = line.split("\\*")[0]
        # split on whitespace but keep {...} sets together
        line = line.replace("{", " { ").replace("}", " } ") \
                   .replace("=", " = ").replace(",", " , ")
        out.extend(line.split())
    return out


def _parse_value(toks: List[str], pos: int):
    """Parse int | "string" | {elems} starting at pos; returns (value,
    new_pos).  Set elements are names or ints."""
    t = toks[pos]
    if t == "{":
        elems = []
        pos += 1
        while toks[pos] != "}":
            if toks[pos] != ",":
                elems.append(toks[pos])
            pos += 1
        return ("set", elems), pos + 1
    if t.startswith('"'):
        return ("str", t.strip('"')), pos + 1
    try:
        return ("int", int(t)), pos + 1
    except ValueError:
        return ("name", t), pos + 1


def parse_cfg_text(text: str) -> Dict:
    """Raw parse: returns constants, init, next, symmetry, view, and the
    constraint/action-constraint/invariant name lists."""
    toks = _tokenize(text)
    consts: Dict[str, object] = {}
    out = {"constants": consts, "init": None, "next": None,
           "symmetry": None, "view": None, "specification": None,
           "constraints": [], "action_constraints": [], "invariants": [],
           "properties": []}
    i = 0
    section = None
    while i < len(toks):
        t = toks[i]
        if t in _KEYWORDS:
            section = t
            i += 1
            if t in ("SYMMETRY", "VIEW", "INIT", "NEXT", "SPECIFICATION"):
                out[t.lower()] = toks[i]
                i += 1
                section = None
            continue
        if section in ("CONSTANTS", "CONSTANT"):
            name = t
            if i + 1 < len(toks) and toks[i + 1] == "=":
                val, i = _parse_value(toks, i + 2)
                consts[name] = val
            else:
                i += 1
            continue
        if section in ("CONSTRAINTS", "CONSTRAINT"):
            out["constraints"].append(t)
        elif section in ("ACTION_CONSTRAINTS", "ACTION_CONSTRAINT"):
            out["action_constraints"].append(t)
        elif section in ("INVARIANTS", "INVARIANT"):
            out["invariants"].append(t)
        elif section in ("PROPERTIES", "PROPERTY"):
            out["properties"].append(t)
        else:
            raise CfgError(f"unexpected token {t!r} outside any section")
        i += 1
    return out


def _resolve_set(consts: Dict, val) -> List[int]:
    kind, elems = val
    if kind != "set":
        raise CfgError(f"expected a set, got {val}")
    out = []
    for e in elems:
        try:
            out.append(int(e))
        except ValueError:
            bound = consts.get(e)
            if bound is None or bound[0] != "int":
                raise CfgError(f"model value {e!r} has no int binding")
            out.append(bound[1])
    return out


def read_bounds_from_spec(spec_path: Path,
                          default: Optional[Bounds] = None) -> Bounds:
    """Lift the in-spec bound constants (tlc raft.tla:22-30 / apalache
    raft.tla:19-22) by scanning the spec text.  Unrecognized bounds keep
    the Bounds.make defaults."""
    text = Path(spec_path).read_text()
    found = {}
    for name in ("MaxLogLength", "MaxRestarts", "MaxTimeouts",
                 "MaxClientRequests", "MaxMembershipChanges"):
        m = re.search(rf"^{name}\s*==\s*(\d+)\s*$", text, re.M)
        if m:
            found[name] = int(m.group(1))
    m = re.search(r"^BoundedTrace\s*==.*<=\s*(\d+)", text, re.M)
    base = default or Bounds()
    return Bounds.make(
        max_log_length=found.get("MaxLogLength", base.max_log_length),
        max_restarts=found.get("MaxRestarts", base.max_restarts),
        max_timeouts=found.get("MaxTimeouts", base.max_timeouts),
        max_client_requests=found.get("MaxClientRequests",
                                      base.max_client_requests),
        max_membership_changes=found.get("MaxMembershipChanges",
                                         base.max_membership_changes),
        max_trace=int(m.group(1)) if m else base.max_trace,
    )


def max_inflight_from_spec(spec_path: Path, n_servers: int) -> Optional[int]:
    """The two MaxInFlightMessages formulas in the reference family:
    tlc 2·S² (raft.tla:30) vs apalache (2S)² (raft.tla:22)."""
    text = Path(spec_path).read_text()
    if re.search(r"LET card == 2 \* Cardinality\(Server\) IN card \* card",
                 text):
        return 4 * n_servers * n_servers
    if re.search(r"LET card == Cardinality\(Server\) IN 2 \* card \* card",
                 text):
        return 2 * n_servers * n_servers
    return None


# ---------------------------------------------------------------------------
# Paxos front-ends (--spec paxos).  Two entry points share one
# validated construction path: ``paxos_config_from_obj`` (the JSON /
# inline-dict constants form the CLI and serve/jobs consume) and
# ``load_paxos_model`` (the TLC .cfg form), which
# round-trip onto identical PaxosConfig objects (the reference's
# ``cfg/parser.py``; tests/test_torch_paxos_cli.py holds both).
# ---------------------------------------------------------------------------

_PAXOS_ALIAS = {"acceptors": "n_servers", "servers": "n_servers",
                "ballots": "n_ballots", "values": "n_values",
                "instances": "n_instances"}
_PAXOS_INT_KEYS = ("n_servers", "n_ballots", "n_values", "n_instances")

# TLC .cfg CONSTANT names -> PaxosConfig bound (singular and plural
# forms, as the reference raft cfgs accept for their sections)
_PAXOS_CFG_CONSTS = {
    "Acceptor": "n_servers", "Acceptors": "n_servers",
    "Ballot": "n_ballots", "Ballots": "n_ballots",
    "Value": "n_values", "Values": "n_values",
    "Instance": "n_instances", "Instances": "n_instances",
    "NumInstances": "n_instances",
}


def paxos_config_from_obj(raw: Dict, where: str = "paxos config"):
    """Constants dict -> PaxosConfig, with clear errors naming the
    offending key.  Accepted keys: acceptors/servers, ballots, values,
    instances (ints), symmetry/fp128 (bools), invariants (names from
    the paxos registry)."""
    from ..spec import get_spec
    from ..spec.paxos.config import PaxosConfig
    if not isinstance(raw, dict):
        raise CfgError(
            f"{where}: paxos constants must be a JSON object "
            f"(got {type(raw).__name__})")
    kw = {}
    for k, v in raw.items():
        kk = _PAXOS_ALIAS.get(k, k)
        if kk not in _PAXOS_INT_KEYS + ("symmetry", "fp128",
                                        "invariants"):
            raise CfgError(f"{where}: unknown paxos config key {k!r}")
        if kk in ("symmetry", "fp128"):
            if not isinstance(v, bool):
                raise CfgError(
                    f"{where}: {k} must be a JSON bool (got {v!r})")
        elif kk == "invariants":
            known = get_spec("paxos").known_invariants
            bad = [nm for nm in v if nm not in known]
            if bad:
                raise CfgError(
                    f"{where}: unknown invariant(s) "
                    f"{', '.join(map(repr, bad))} for spec 'paxos'; "
                    f"known: {', '.join(sorted(known))}")
            v = tuple(v)
        elif isinstance(v, bool) or not isinstance(v, int):
            raise CfgError(
                f"{where}: {k} must be a JSON integer (got {v!r})")
        kw[kk] = v
    try:
        return PaxosConfig(**kw)
    except ValueError as e:
        raise CfgError(f"{where}: {e}") from e


def load_paxos_model(cfg_path) -> "object":
    """TLC ``.cfg`` front-end for ``--spec paxos``: CONSTANTS map onto
    PaxosConfig bounds — Acceptor/Value as model-value sets (their
    cardinality is the bound; values must be the dense 0..N-1 indices
    the packed layout uses), Ballot as a 0..N-1 set or an int count,
    Instance(s) as an int — SYMMETRY toggles acceptor canonicalization
    (a cfg with no SYMMETRY line runs symmetry-off, TLC semantics),
    and INVARIANT names resolve against the paxos registry.  Quorum
    must NOT be bound: the engine derives all majorities of Acceptor,
    the standard Paxos.tla instantiation.  Every other key errors by
    name.  Round-trips with the JSON constants path
    (``paxos_config_from_obj``)."""
    cfg_path = Path(cfg_path)
    raw = parse_cfg_text(cfg_path.read_text())
    consts = raw["constants"]
    # names referenced inside any set binding are model values (a1 = 1)
    refd = set()
    for val in consts.values():
        if val[0] == "set":
            refd.update(val[1])
    kw: Dict[str, object] = {}
    for name, val in consts.items():
        if name in _PAXOS_CFG_CONSTS:
            key = _PAXOS_CFG_CONSTS[name]
            if val[0] == "set":
                elems = _resolve_set(consts, val)
                if key in ("n_ballots", "n_values") and \
                        sorted(elems) != list(range(len(elems))):
                    raise CfgError(
                        f"{cfg_path}: {name} must be the contiguous "
                        f"set 0..N-1 (got {sorted(elems)}) — ballots "
                        "and values are dense indices in the packed "
                        "layout")
                kw[key] = len(elems)
            elif val[0] == "int":
                kw[key] = val[1]
            else:
                raise CfgError(
                    f"{cfg_path}: {name} must be a set or an int "
                    f"(got {val[1]!r})")
        elif name == "Quorum":
            raise CfgError(
                f"{cfg_path}: Quorum is not cfg-settable — the engine "
                "derives all majorities of Acceptor (the standard "
                "Paxos.tla instantiation); remove the Quorum binding")
        elif val[0] == "int" and name in refd:
            pass          # model-value binding, consumed by the sets
        else:
            raise CfgError(
                f"{cfg_path}: unsupported paxos CONSTANT {name!r} — "
                "supported: " +
                ", ".join(sorted(set(_PAXOS_CFG_CONSTS))))
    if raw["init"] not in (None, "Init"):
        raise CfgError(f"{cfg_path}: unsupported INIT {raw['init']!r}")
    if raw["view"] is not None:
        raise CfgError(
            f"{cfg_path}: VIEW is not supported for spec 'paxos' — "
            "state identity is the full packed state; remove the "
            "VIEW line")
    if raw["specification"] not in (None, "Spec"):
        raise CfgError(
            f"{cfg_path}: unsupported SPECIFICATION "
            f"{raw['specification']!r}")
    if raw["next"] not in (None, "Next"):
        raise CfgError(
            f"{cfg_path}: unsupported NEXT {raw['next']!r} for spec "
            "'paxos' (only the full Next relation exists)")
    if raw["properties"]:
        raise CfgError(
            f"{cfg_path}: temporal PROPERTIES are not supported: "
            f"{raw['properties']}")
    if raw["constraints"] or raw["action_constraints"]:
        raise CfgError(
            f"{cfg_path}: spec 'paxos' declares no constraints / "
            "action constraints (the bounded space is finite without "
            "them)")
    # delegate invariant validation + construction to the JSON path's
    # validator, so the two front-ends share one tail and cannot drift
    kw["symmetry"] = raw["symmetry"] is not None
    if raw["invariants"]:
        kw["invariants"] = list(raw["invariants"])
    return paxos_config_from_obj(kw, where=str(cfg_path))


def load_model(cfg_path, variant: Optional[str] = None,
               bounds: Optional[Bounds] = None) -> ModelConfig:
    """cfg file -> ModelConfig.  ``variant`` = 'apalache' switches the
    live VotesGrantedInv/LeaderCompleteness to the documented-false forms
    the apalache_no_membership spec ships (SURVEY §2.7); auto-detected
    from the path when None."""
    cfg_path = Path(cfg_path)
    raw = parse_cfg_text(cfg_path.read_text())
    consts = raw["constants"]
    if variant is None:
        variant = "apalache" if "apalache" in str(cfg_path) else "tlc"

    if "Server" not in consts:
        raise CfgError("cfg binds no Server set")
    server_ids = sorted(_resolve_set(consts, consts["Server"]))
    id_map = {sid: k for k, sid in enumerate(server_ids)}
    init_ids = (sorted(_resolve_set(consts, consts["InitServer"]))
                if "InitServer" in consts else server_ids)
    values = tuple(sorted(_resolve_set(consts, consts["Value"]))) \
        if "Value" in consts else (1,)
    num_rounds = consts.get("NumRounds", ("int", 1))[1]

    if raw["init"] not in (None, "Init"):
        raise CfgError(f"unsupported INIT {raw['init']!r}")
    if raw["properties"]:
        raise CfgError(
            f"temporal PROPERTIES are not supported: {raw['properties']}")
    next_name = raw["next"]
    if next_name is None and raw["specification"] is not None:
        # SPECIFICATION Spec == Init /\ [][Next]_vars (raft.tla:947)
        if raw["specification"] != "Spec":
            raise CfgError(
                f"unsupported SPECIFICATION {raw['specification']!r}")
        next_name = "Next"
    next_name = next_name or "NextAsyncCrash"
    if next_name not in _NEXT_FAMILIES:
        raise CfgError(f"unknown NEXT family {next_name!r}")

    for nm in raw["invariants"]:
        if nm not in OP.INVARIANTS:
            raise CfgError(f"unknown invariant {nm!r}")
    # the punctuated-search prefix pins (raft.tla:1198-1234) are cfg
    # CONSTRAINTS in the reference but compile to BFS seeds here
    # (models/golden.prefix_pin_seeds) — split them out
    prefix_pins = tuple(nm for nm in raw["constraints"]
                        if nm in ("CommitWhenConcurrentLeaders_unique",
                                  "MajorityOfClusterRestarts_constraint"))
    plain_constraints = tuple(nm for nm in raw["constraints"]
                              if nm not in prefix_pins)
    for nm in plain_constraints:
        if nm not in OP.CONSTRAINTS:
            raise CfgError(f"unknown constraint {nm!r}")
    for nm in raw["action_constraints"]:
        if nm not in OP.ACTION_CONSTRAINTS:
            raise CfgError(f"unknown action constraint {nm!r}")

    spec_path = cfg_path.with_suffix(".tla")
    n = len(server_ids)
    if bounds is None and spec_path.exists():
        bounds = read_bounds_from_spec(spec_path)
    bounds = bounds or Bounds()
    inflight = (max_inflight_from_spec(spec_path, n)
                if spec_path.exists() else None)

    return ModelConfig(
        n_servers=n,
        init_servers=tuple(id_map[s] for s in init_ids),
        values=values,
        num_rounds=num_rounds,
        next_family=_NEXT_FAMILIES[next_name],
        # defaults only when the cfg listed NO constraints at all — a
        # cfg listing only prefix pins gets exactly that (an author who
        # pinned the search did not ask for the bounded-constraint set)
        constraints=(plain_constraints if raw["constraints"]
                     else DEFAULT_CONSTRAINTS),
        prefix_pins=prefix_pins,
        action_constraints=tuple(raw["action_constraints"]),
        invariants=tuple(raw["invariants"]) or DEFAULT_INVARIANTS,
        symmetry=raw["symmetry"] is not None,
        bounds=bounds,
        apalache_variant=(variant == "apalache"),
        max_inflight_override=inflight,
    )
