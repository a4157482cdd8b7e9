"""Checkpointing (port of ``repro.checkpoint.io``): an npz payload and a
json meta, the reference's on-disk format.

Two layers, as in the reference:

* the generic tree save/load (``save_checkpoint`` / ``load_checkpoint``),
  positional, for params-only snapshots;
* the versioned full-state format (``save_state`` / ``load_state``, v2):
  when the saved tree is a NamedTuple (``MethodState``,
  ``DashaTrainState``, optimizer states nested inside), the meta records
  each field's leaf span, so a restore matches fields by name: retired
  fields (the seed-era ``prev_params``) are dropped, and a field missing
  from the file raises.

The payload is ``arrays.npz`` with one ``leaf_{i}`` entry a leaf; the meta
is ``meta.json`` with ``version``, ``treedef``, ``step``, ``fields``,
``extra``, ``num_leaves`` and ``dtypes``.  Leaves are ordered as
``jax.tree_util`` orders them: a dict by sorted key, a NamedTuple by its
fields, a tuple or list by position, ``None`` and ``()`` holding none.  So
a state written here has the reference's leaves and field spans, and a
reference file reads here.  ``treedef`` is this module's own description
of the structure; nothing reads it back.

Tensors leave the device one leaf at a time as the file is written, and
arrive on the device and in the dtype of the matching ``like`` leaf as it
is read.  bfloat16 is stored as float32 (a lossless widening) and cast
back, so every restore is bit-identical.  Host leaves (the round index,
Adam's count, the seed, ``bits_sent``) are stored as numpy arrays with a
fixed dtype (int32; int64 for a ``seed`` field; float32 as given) and come
back as the type of the ``like`` leaf (``int``, ``np.float32``, an array).

The reference's states hold a JAX ``key`` where the port's hold an integer
``seed``.  A v2 file whose fields name ``key`` and not ``seed`` is a
reference checkpoint: it restores into a state with a ``seed`` field only
when the caller passes ``seed=``, and its ``key`` span is dropped like a
retired field (the port cannot replay threefry streams, so the
continuation draws the port's own randomness from that seed).  A port
file carries its own seed and accepts no ``seed=``.

v1 checkpoints (no field spans) load positionally; a seed-era
``DashaTrainState`` whose retired ``prev_params`` slot held a full
params-shaped copy is detected by its leaf count and that span skipped.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

#: current on-disk format version (meta.json "version")
FORMAT_VERSION = 2

#: state fields that existed in older formats and are dropped on restore
RETIRED_FIELDS = ("prev_params",)

#: host integers stored as int64 (``derive_seed`` gives 63-bit seeds);
#: every other host integer (round index, Adam's count) as int32, the
#: reference's dtype for them
_INT64_FIELDS = ("seed",)


# ---------------------------------------------------------------------------
# trees: the reference's leaf order
# ---------------------------------------------------------------------------

def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaves(tree, field: str = "") -> List[Tuple[str, Any]]:
    """``(field, leaf)`` pairs in ``jax.tree_util``'s order; ``field`` is
    the name of the innermost NamedTuple field holding the leaf."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        return [p for f in tree._fields for p in _leaves(getattr(tree, f), f)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaves(tree[k], field)]
    if isinstance(tree, (tuple, list)):
        return [p for v in tree for p in _leaves(v, field)]
    return [(field, tree)]


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if _is_namedtuple(tree):
        inner = ", ".join(f"{f}={_structure(getattr(tree, f))}"
                          for f in tree._fields)
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _rebuild(like, values):
    """``like``'s structure holding the next leaves of the iterator
    ``values`` (dict keys keep ``like``'s own order)."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), values)
                            for f in like._fields))
    if isinstance(like, dict):
        got = {k: _rebuild(like[k], values) for k in sorted(like)}
        return {k: got[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, values) for v in like)
    return next(values)


# ---------------------------------------------------------------------------
# leaves to and from the file
# ---------------------------------------------------------------------------

def _host_array(leaf, field: str) -> Tuple[np.ndarray, str]:
    """(the array to store, the leaf's dtype name for the meta)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy(), name
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        dt = np.int64 if field in _INT64_FIELDS else np.int32
        info = np.iinfo(dt)
        if not info.min <= leaf <= info.max:
            raise ValueError(f"host integer {field or 'leaf'}={leaf} does "
                             f"not fit the {np.dtype(dt).name} it is "
                             "stored as")
        a = np.asarray(leaf, dt)
    else:
        a = np.asarray(leaf)
    name = a.dtype.name
    if name == "bfloat16":
        a = a.astype(np.float32)
    return a, name


def _write(path: str, leaves: List[Tuple[str, Any]], meta: dict) -> None:
    """``arrays.npz`` as ``np.savez`` lays it out, written a leaf at a
    time (the host holds one leaf, not the state), then ``meta.json``."""
    os.makedirs(path, exist_ok=True)
    dtypes = []
    with zipfile.ZipFile(os.path.join(path, "arrays.npz"), "w",
                         zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, (field, leaf) in enumerate(leaves):
            a, name = _host_array(leaf, field)
            dtypes.append(name)
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)
            del a
    meta = dict(meta, num_leaves=len(leaves), dtypes=dtypes)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def _restore(saved: np.ndarray, like):
    """One saved array as the type, dtype and device of ``like``."""
    if isinstance(like, torch.Tensor):
        if saved.shape != tuple(like.shape):
            raise ValueError(f"checkpoint shape mismatch: {saved.shape} vs "
                             f"{tuple(like.shape)}")
        return torch.from_numpy(saved).to(device=like.device,
                                          dtype=like.dtype)
    want = np.shape(like)
    if saved.shape != want:
        raise ValueError(f"checkpoint shape mismatch: {saved.shape} vs "
                         f"{want}")
    if isinstance(like, np.ndarray):
        return saved.astype(like.dtype)
    if isinstance(like, np.generic):
        return like.dtype.type(saved)
    return type(like)(saved.item())


def _load_leaves(path: str, sources, like_leaves) -> list:
    """Each ``like`` leaf restored from its source: an index into the
    file's leaves, or a host value taken as it is."""
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for src, (_, like) in zip(sources, like_leaves):
            out.append(_restore(data[f"leaf_{src}"], like)
                       if isinstance(src, int) else src.value)
    return out


class _Given:
    """A leaf value supplied by the caller, not read from the file."""

    def __init__(self, value):
        self.value = value


def _check_count(n_saved: int, like_leaves) -> None:
    if n_saved != len(like_leaves):
        raise ValueError(f"checkpoint leaf count mismatch: saved {n_saved} "
                         f"vs expected {len(like_leaves)}")


# ---------------------------------------------------------------------------
# seed API (generic tree; params-only snapshots)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    _write(path, _leaves(tree), {"version": FORMAT_VERSION,
                                 "treedef": _structure(tree), "step": step})


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shape/dtype/device
    template), leaf by leaf in order."""
    meta = checkpoint_meta(path)
    like_leaves = _leaves(like)
    _check_count(meta["num_leaves"], like_leaves)
    sources = list(range(meta["num_leaves"]))
    return _rebuild(like, iter(_load_leaves(path, sources, like_leaves)))


def checkpoint_step(path: str) -> int:
    return checkpoint_meta(path)["step"]


def checkpoint_meta(path: str) -> dict:
    """The full meta dict (version / step / fields / extra)."""
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# versioned full-state format (v2)
# ---------------------------------------------------------------------------

def _field_spans(tree) -> Optional[list]:
    """[{name, leaves}] per NamedTuple field, in field order."""
    if not _is_namedtuple(tree):
        return None
    return [{"name": f, "leaves": len(_leaves(getattr(tree, f)))}
            for f in tree._fields]


def save_state(path: str, state: Any, *, step: int = 0,
               extra: Optional[dict] = None) -> None:
    """Save a full state tree in the versioned (v2) format; a NamedTuple
    state gets per-field leaf spans in the meta."""
    _write(path, _leaves(state), {"version": FORMAT_VERSION,
                                  "treedef": _structure(state),
                                  "step": step,
                                  "fields": _field_spans(state),
                                  "extra": extra or {}})


def _by_field(path: str, fields: list, like, seed: Optional[int]) -> list:
    """The file's leaf index (or a given value) for each ``like`` leaf,
    matched by field name under the ``key`` -> ``seed`` rule."""
    spans, off = {}, 0
    for f in fields:
        spans[f["name"]] = list(range(off, off + f["leaves"]))
        off += f["leaves"]
    reference_key = "seed" in like._fields and "seed" not in spans \
        and "key" in spans
    if reference_key:
        if seed is None:
            raise ValueError(
                f"checkpoint at {path!r} holds the reference's JAX key, "
                "not a seed: the port cannot replay threefry streams, so "
                "pass seed= and the continuation draws the port's own "
                "randomness from it")
    elif seed is not None:
        raise ValueError(
            f"seed= restores a reference checkpoint (fields name 'key'); "
            f"{path!r} has no 'key' field to replace (a port checkpoint "
            "carries its own seed)")
    missing = [n for n in like._fields if n not in spans
               and not (reference_key and n == "seed")]
    if missing:
        raise ValueError(f"checkpoint at {path!r} lacks state fields "
                         f"{missing} (saved: {sorted(spans)})")
    sources = []
    for name in like._fields:
        want = len(_leaves(getattr(like, name)))
        if reference_key and name == "seed":
            if want != 1:
                raise ValueError(f"field 'seed' holds {want} leaves")
            sources.append(_Given(int(seed)))
            continue
        got = spans[name]
        if len(got) != want:
            raise ValueError(f"field {name!r}: saved {len(got)} leaves vs "
                             f"expected {want}")
        sources.extend(got)
    # saved fields absent from ``like`` (RETIRED_FIELDS, a reference
    # file's key) are skipped
    return sources


def load_state(path: str, like: Any, *, seed: Optional[int] = None) -> Any:
    """Restore a v2 (or v1) state checkpoint into the structure of
    ``like``, each tensor on the device and in the dtype of its ``like``
    leaf.

    v2 + NamedTuple: fields are matched by name; saved fields absent from
    ``like`` are dropped; fields of ``like`` absent from the file raise.
    ``seed`` restores a reference checkpoint (a ``key`` field, no
    ``seed``) into a state with a ``seed`` field, and is refused
    otherwise.  Without field spans: positional, with the v1
    ``prev_params`` leaf-count heuristic (a seed-era ``DashaTrainState``
    whose second slot duplicated ``params``)."""
    meta = checkpoint_meta(path)
    like_leaves = _leaves(like)
    fields = meta.get("fields")
    if fields and _is_namedtuple(like):
        sources = _by_field(path, fields, like, seed)
    else:
        if seed is not None:
            raise ValueError(f"seed= needs field spans (a v2 state "
                             f"checkpoint); {path!r} restores positionally")
        n_saved = meta["num_leaves"]
        idx = list(range(n_saved))
        if (n_saved != len(like_leaves) and _is_namedtuple(like)
                and like._fields and like._fields[0] == "params"):
            p = len(_leaves(like.params))
            if n_saved == len(like_leaves) + p:
                idx = idx[:p] + idx[2 * p:]
        _check_count(len(idx), like_leaves)
        sources = idx
    return _rebuild(like, iter(_load_leaves(path, sources, like_leaves)))


# ---------------------------------------------------------------------------
# MethodState convenience (the driver's checkpoint cadence)
# ---------------------------------------------------------------------------

def save_method_state(path: str, state: Any, *, step: Optional[int] = None,
                      extra: Optional[dict] = None) -> None:
    """Full-``MethodState`` checkpoint; ``step`` defaults to ``state.t``."""
    if step is None:
        step = int(np.asarray(getattr(state, "t", 0)))
    save_state(path, state, step=step, extra=extra)


def load_method_state(path: str, like: Any, *,
                      seed: Optional[int] = None) -> Any:
    """Restore a ``MethodState``: a bit-identical continuation under the
    driver (data seeded by the global round ``t``, the method's draws by
    the restored ``seed`` and ``t``).  ``seed`` is for a reference
    checkpoint only (see :func:`load_state`)."""
    return load_state(path, like, seed=seed)
