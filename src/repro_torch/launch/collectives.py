"""Collective bytes and live memory of one traced call (the counterpart of
``repro.launch.hlo_parse`` / ``roofline.collective_bytes``).

Torch makes no HLO, so nothing is parsed: :class:`CallTrace` is a
``CommDebugMode`` (a dispatch mode that lets DTensor desugar each op into
local ops and collectives before it sees them) that also records

* the bytes of every collective's output on this rank, under the
  reference's five kinds (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``), each with its
  ``_count`` — the reference's HLO shapes are per-device shapes too;
* the live local-storage bytes over the call: every storage an op's output
  brings in counts until it is freed, from the arguments'
  (:meth:`CallTrace.track_args`) up; :func:`repro_torch.launch.roofline.
  memory_per_device` reads the peak.  Not counted: the global-shape
  ``meta`` stand-ins DTensor's sharding propagation makes, and the outputs
  of the functional collectives' wait / wrap ops, which alias their input
  on a device: their input's storage stays counted while they live (on
  ``meta`` they get storage of their own, which would otherwise let the
  collective's result go uncounted while the model holds it).

The backward runs under the same mode (the autograd engine carries the
dispatch modes to its threads), so a traced train step counts its
backward's collectives and its live bytes: the tensors autograd saves,
and under ``torch.utils.checkpoint`` the layer inputs it keeps and the
recomputed activations.

Eager torch runs the model's layer loop as Python, unrolled, so every
layer's collectives are seen as they are issued: no trip-count walk over
loop bodies is needed (the reference's ``collective_bytes_loop_aware``
multiplies its while-loop bodies by their trip counts).  On a ``"fake"``
process group the collectives return at once and write nothing; their
shapes, and so the bytes counted, are those of the real program.
"""
from __future__ import annotations

import sys
import weakref
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_leaves

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
# (substring of the op name, kind), the first that matches
_PATTERNS = (("reduce_scatter", "reduce-scatter"),
             ("all_gather", "all-gather"), ("allgather", "all-gather"),
             ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
             ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
             ("permute", "collective-permute"), ("send", "collective-permute"),
             ("recv", "collective-permute"))


def collective_kind(func) -> Optional[str]:
    """The reference's kind of the op ``func``, or None for any other op
    (``wait_tensor`` included)."""
    name = getattr(func, "name", None)
    if name is None:
        return None
    ns, _, rest = func.name().partition("::")
    if ns not in _NAMESPACES:
        return None
    op = rest.split(".")[0]
    for pattern, kind in _PATTERNS:
        if pattern in op:
            return kind
    return None


#: ops whose output aliases their input on a device (their ``meta``
#: kernels return a new tensor)
_ALIASING = ("_c10d_functional::wait_tensor",
             "_c10d_functional::_wrap_tensor_autograd")
#: DTensor's sharding propagation runs ops on ``meta`` stand-ins of the
#: GLOBAL shapes (on any device); storages made under these files are its
#: bookkeeping, not the rank's memory
_PROPAGATION = ("_sharding_prop.py", "_op_schema.py")


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CallTrace(CommDebugMode):
    """``with CallTrace() as tr: out = fn(*args)``; then
    :meth:`collectives` and the memory fields (``arg_bytes``,
    ``peak_bytes``, :meth:`storage_bytes`)."""

    def __init__(self):
        super().__init__()
        self.coll_bytes: Dict[str, int] = {k: 0 for k in KINDS}
        self.coll_count: Dict[str, int] = {k: 0 for k in KINDS}
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.arg_bytes = 0
        self._arg_keys: set = set()
        # an aliasing op's output storage -> the storage it aliases, held
        # while the output lives
        self._held: Dict[int, Any] = {}
        #: every collective as (kind, process group name, output shape,
        #: dtype), in issue order
        self.calls: list = []

    # -- memory ------------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> Optional[int]:
        """Count ``t``'s storage if it is new; returns its key."""
        st = t.untyped_storage()
        key = id(st)
        if key not in self._live:
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)
        return key

    def _alias(self, out: torch.Tensor, src: torch.Tensor) -> None:
        """``out`` aliases ``src`` on a device (``meta`` gives it storage
        of its own): keep ``src``'s storage counted while ``out``'s
        lives, and count ``out``'s nothing."""
        st_out, st_in = out.untyped_storage(), src.untyped_storage()
        key = id(st_out)
        if key == id(st_in) or key in self._held:
            return
        self._held[key] = st_in
        weakref.finalize(st_out, self._held.pop, key, None)

    def _locals(self, tree: Any):
        from torch.distributed.tensor import DTensor
        for x in tree_leaves(tree):
            if isinstance(x, DTensor):
                yield x.to_local()
            elif isinstance(x, torch.Tensor):
                yield x

    def track_args(self, tree: Any) -> None:
        """Count the local storages of the call's arguments (a tree of
        DTensors or tensors) as live from the start."""
        for t in self._locals(tree):
            key = self._track(t)
            if key not in self._arg_keys:
                self._arg_keys.add(key)
                self.arg_bytes += self._live[key]

    def storage_bytes(self, tree: Any) -> Dict[str, int]:
        """Local storage bytes of ``tree`` (the call's outputs), split into
        those that are argument storages (``alias``) and new ones
        (``output``), each storage once."""
        seen, out = set(), {"output": 0, "alias": 0}
        for t in self._locals(tree):
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            out["alias" if id(st) in self._arg_keys else "output"] += \
                st.nbytes()
        return out

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        kind = collective_kind(func)
        aliasing = func.name().startswith(_ALIASING)
        track = not aliasing and not _in_propagation()
        src = next((a for a in tree_leaves(args)
                    if isinstance(a, torch.Tensor)), None) if aliasing \
            else None
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                if kind is not None:
                    self.coll_bytes[kind] += _nbytes(t)
                if track:
                    self._track(t)
                elif src is not None:
                    self._alias(t, src)
        if kind is not None:
            self.coll_count[kind] += 1
            # the functional collectives take the group's name last
            names = [a for a in tree_leaves((args, kwargs or {}))
                     if isinstance(a, str)]
            group = names[-1] if names else None
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.calls.append((kind, group, tuple(t.shape),
                                       t.dtype))
        return out

    def collectives(self) -> Dict[str, int]:
        """Bytes by kind and ``<kind>_count``, the reference's
        ``collective_bytes`` keys."""
        out: Dict[str, int] = dict(self.coll_bytes)
        out.update({k + "_count": v for k, v in self.coll_count.items()})
        return out
