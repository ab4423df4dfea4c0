"""Checkpoint files, in the reference's format (``raft_tla_tpu/engine/
bfs.py``'s serializer): a checkpoint written by either package resumes
in the other.

A checkpoint is the full BFS wavefront at a level boundary: the carry's
leaves under the reference's names (``_leaf_name``: ``carry|vis|0``,
``carry|front|bag``, ``carry|n_front``, ...), the level counters, the
result so far and, with ``store_states`` and no disk archive, the
per-level parent/lane/state archives for trace reconstruction.  A
resumed run replays nothing and lands on the counts of an uninterrupted
one.  Engine-specific capacity fields ride in the meta record the
caller supplies; a key the reader does not know is ignored, so the
port's own (``HCAP``, the hard-lane counters) pass through the JAX
engine untouched.

The carry is a nest of dicts (keys flattened in sorted order) and
tuples of numpy arrays, in the JAX engine's dtypes: u32 words as
uint32, 0-d counters as int32, flags as bool, state fields in their
storage dtypes (``ops/codec.py`` ``narrow_dtypes``).  Converting the
port's tensors to and from that form is the engine's business
(``bfs.Engine._carry_numpy`` / ``_level_from_carry``).

Integrity (``resil/ckpt_chain.py``): every file has a sha256 sidecar
verified before any array is read, and a torn or corrupt head falls
back, with a ``ChainWarning``, to the newest valid predecessor in the
last-K chain ``path, path.1, ...``.
"""

from __future__ import annotations

import json

import numpy as np

_CKPT_BASE_KEYS = ("cfg", "chunk", "store_states", "n_levels",
                   "distinct", "generated", "depth", "level_sizes",
                   "faults", "viol_global", "n_states", "n_vis",
                   "n_front")


class CheckpointError(ValueError):
    """Checkpoint missing, malformed, or written by an incompatible
    engine version/config.  The CLI catches exactly this for its
    'cannot resume' message; unrelated mid-run ValueErrors propagate."""


def _leaf_name(key_path) -> str:
    """Stable archive name for a carry leaf (shared by checkpoint save
    and load — must stay in lockstep with the reference's)."""
    return "carry|" + "|".join(
        str(getattr(p, "key", getattr(p, "idx", p))) for p in key_path)


def _tree_paths(tree, path=()):
    """(key path, leaf) of every leaf of a nest of dicts and tuples, in
    the order ``jax.tree_util`` flattens it (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_paths(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, path + (i,))
    else:
        yield path, tree


def _tree_map(fn, tree, path=()):
    """The nest with each leaf replaced by ``fn(key path)``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, v, path + (i,))
                     for i, v in enumerate(tree))
    return fn(path)


def ckpt_write(path, carry, store_states, parents, lanes, states, res,
               meta, keep: int = 1):
    """``keep`` > 1 keeps a last-K chain (path, path.1, ..) with the
    previous heads rotated down before the atomic publish; every
    member carries a sha256 sidecar (resil/ckpt_chain) so a torn or
    corrupt head is detected BEFORE any array is read and resume
    falls back to the newest valid predecessor."""
    data = {}
    for kp, leaf in _tree_paths(carry):
        data[_leaf_name(kp)] = np.asarray(leaf)
    if store_states:
        for i, arr in enumerate(parents):
            data[f"parents|{i}"] = arr
        for i, arr in enumerate(lanes):
            data[f"lanes|{i}"] = arr
        for i, blk in enumerate(states):
            for k, v in blk.items():
                data[f"states|{i}|{k}"] = v
    data["viol_names"] = np.array([v.invariant for v in res.violations])
    data["viol_ids"] = np.array([v.state_id for v in res.violations],
                                dtype=np.int64)
    base = dict(distinct=res.distinct_states,
                generated=res.generated_states,
                faults=res.overflow_faults,
                level_sizes=res.level_sizes,
                viol_global=res.violations_global,
                pin_interior=res.pin_interior_states,
                levels_fused=res.levels_fused,
                burst_dispatches=res.burst_dispatches,
                burst_bailouts=res.burst_bailouts,
                n_levels=len(parents), store_states=store_states)
    data["meta"] = np.array(json.dumps({**base, **meta}))
    tmp = path + ".tmp.npz"           # .npz suffix: savez won't append
    np.savez(tmp, **data)
    # rotate + publish + checksum sidecar (+ the ckpt_torn/ckpt_corrupt
    # chaos sites, applied to the fresh head only)
    from ..resil.ckpt_chain import publish
    publish(tmp, path, keep=keep)


def ckpt_read(path, cfg_repr, chunk, extra_keys, sharded, spill=False,
              expected_format=None, spec_name=None, sym_canon=None):
    """np.load + the meta validation every engine shares.  Returns
    (npz, meta) or raises CheckpointError with the reference's
    messages.

    expected_format — optional (meta_key, want_value, why) triple: the
    engine's checkpoint-format gate (meta lacking the key reads as
    format 1).

    spec_name — the resuming engine's SpecIR name: resume refuses on a
    spec mismatch (meta lacking the key reads as "raft").

    sym_canon — the resuming engine's RESOLVED canonicalization mode
    ("sort" | "minperm"): the visited table stores fingerprint VALUES,
    which are mode-specific, so resuming across modes would silently
    re-visit every known state.  Refused by name; meta lacking the key
    reads as "minperm".

    Integrity (resil/ckpt_chain): the file's sha256 sidecar is verified
    BEFORE any array is touched — a truncated or corrupt file is a
    clear named condition, never a numpy/zipfile traceback — and a bad
    head falls back (with a ChainWarning) to the newest valid
    predecessor in the last-K chain ``path, path.1, ...``."""
    from ..resil.ckpt_chain import (IntegrityError, load_engine_npz,
                                    open_validated)
    # payload-integrity validation before ANY meta compare: the digest
    # check runs first; the structural loader catches legacy
    # no-sidecar files whose zip container or meta record is torn
    try:
        z, path = open_validated(path, load_engine_npz)
    except IntegrityError as e:
        raise CheckpointError(str(e)) from e
    meta = json.loads(str(z["meta"]))
    if spec_name is not None:
        got_spec = meta.get("spec", "raft")
        if got_spec != spec_name:
            raise CheckpointError(
                f"{path}: checkpoint was written for spec "
                f"{got_spec!r}; engine is running spec {spec_name!r} "
                f"— resume with --spec {got_spec}")
    if sym_canon is not None:
        got_mode = meta.get("sym_canon", "minperm")
        if got_mode != sym_canon:
            raise CheckpointError(
                f"{path}: checkpoint fingerprints were canonicalized "
                f"with --sym-canon {got_mode}; engine resolved "
                f"{sym_canon} — fingerprint values are mode-specific "
                f"(the visited table would miss every known state) — "
                f"resume with --sym-canon {got_mode}")
    # spill before sharded: a spill checkpoint handed to a sharded
    # engine must name SpillEngine, not "the single-device Engine"
    if bool(meta.get("spill")) != spill:
        raise CheckpointError(
            f"{path}: host-spill checkpoint — resume it with "
            "SpillEngine" if meta.get("spill")
            else f"{path}: not a SpillEngine checkpoint — resume it "
            "with the engine that wrote it")
    if bool(meta.get("sharded")) != sharded:
        raise CheckpointError(
            f"{path}: sharded-engine checkpoint — resume it with "
            "ShardedEngine on the same mesh size" if meta.get("sharded")
            else f"{path}: single-device checkpoint — resume it with "
            "the single-device Engine")
    if expected_format is not None:
        fkey, want, why = expected_format
        got = meta.get(fkey, 1)
        if got != want:
            raise CheckpointError(
                f"{path}: checkpoint format {got!r} != {want} ({why}) "
                "— re-run without --resume")
    for key in _CKPT_BASE_KEYS + tuple(extra_keys):
        if key not in meta:
            raise CheckpointError(
                f"{path}: checkpoint written by an older engine "
                f"version (meta lacks {key!r}) — re-run without "
                "--resume")
    if meta["cfg"] != cfg_repr:
        raise CheckpointError(
            "checkpoint was written for a different model config:\n"
            f"  checkpoint: {meta['cfg']}\n"
            f"  engine:     {cfg_repr}")
    if meta["chunk"] != chunk:
        raise CheckpointError(
            f"checkpoint was written with chunk={meta['chunk']}; "
            f"resume with the same chunk (engine has {chunk} — "
            "capacities are rounded to the chunk size)")
    return z, meta


def ckpt_carry(path, z, template, to_device):
    """Rebuild the carry nest from archived leaves: ``template`` gives
    the structure (its leaves are never read), ``to_device`` takes each
    stored array."""
    names = [_leaf_name(kp) for kp, _ in _tree_paths(template)]
    missing = [nm for nm in names if nm not in z]
    if missing:
        raise CheckpointError(
            f"{path}: checkpoint carry layout is from an "
            f"incompatible engine version (missing {missing[:3]}"
            f"{'…' if len(missing) > 3 else ''}) — re-run without "
            "--resume")
    return _tree_map(lambda kp: to_device(z[_leaf_name(kp)]), template)


def ckpt_archives(z, meta, template, store_states):
    """(parents, lanes, states) trace archives; empty when the store is
    off."""
    if store_states and not meta["store_states"]:
        raise CheckpointError(
            "checkpoint was written with store_states=False; "
            "resume with store_states=False (CLI: --no-store) — "
            "trace archives cannot be reconstructed")
    if not (store_states and meta["store_states"]):
        return [], [], []
    parents = [z[f"parents|{i}"] for i in range(meta["n_levels"])]
    lanes = [z[f"lanes|{i}"] for i in range(meta["n_levels"])]
    keys = list(template["lvl"].keys())
    states = [{k: z[f"states|{i}|{k}"] for k in keys}
              for i in range(meta["n_levels"])]
    return parents, lanes, states


def ckpt_result(z, meta):
    """The result so far (a port ``CheckResult``); the port-only
    hard-lane counters default to 0 for a file the JAX engine wrote."""
    from .bfs import CheckResult, Violation
    res = CheckResult(distinct_states=meta["distinct"],
                      generated_states=meta["generated"],
                      depth=meta["depth"])
    res.level_sizes = list(meta["level_sizes"])
    res.overflow_faults = meta["faults"]
    res.violations_global = meta["viol_global"]
    res.pin_interior_states = meta.get("pin_interior", 0)
    res.levels_fused = meta.get("levels_fused", 0)
    res.burst_dispatches = meta.get("burst_dispatches", 0)
    res.burst_bailouts = meta.get("burst_bailouts", 0)
    for nm, sid in zip(z["viol_names"], z["viol_ids"]):
        res.violations.append(Violation(str(nm), int(sid)))
    return res
