"""Dispatch-level audits of one call — Layer 1 of ``repro_torch.analysis``
(the counterpart of ``repro.analysis.jaxpr_audit``).

The reference walks a traced jaxpr and XLA's compiled module; eager torch
has neither, so each audit here *runs* the callable on its arguments' own
device (the CPU in tests, the card in ``chip_smoke.py``, ``meta`` where
the callable allows it) under a ``TorchDispatchMode`` that sees every op:

===========================================  ===============================
reference (``jaxpr_audit``)                  port
===========================================  ===============================
``large_outputs`` / ``assert_large_outputs``  :func:`large_outputs` /
                                              :func:`assert_large_outputs`:
                                              every op output that
                                              materializes a new storage at
                                              or above a byte threshold
``compiled_temp_bytes``                      :func:`temp_bytes`: the live
                                              bytes' peak over the call of
                                              storages that are neither
                                              arguments nor outputs (XLA's
                                              temp allocation), on
                                              :class:`repro_torch.launch.
                                              collectives.CallTrace`'s
                                              storage tracking
``compiled_flops``                           :func:`flops`
                                              (``FlopCounterMode``)
``donation_report``                          :func:`inplace_report`: per
                                              state field, whether the call
                                              wrote its storage in place or
                                              made a new tensor of its size
                                              (eager torch has no donation)
``scan_carry_report``                        :func:`carry_report`: the bytes
                                              a chunk carries from round to
                                              round, by field (the async
                                              ring's included)
``hlo_collective_report``                    :func:`collective_report`
                                              (``CallTrace.collectives()``)
===========================================  ===============================

"Large" defaults to the largest input tensor, as the reference's
``_default_min_bytes`` does, so on the federated path it means O(n·d).
Only outputs with a storage of their own count: a view or an in-place
op's result aliases a storage that already exists.  A hand-written
kernel launched through ``ctypes`` is not dispatched: its outputs are
counted where its wrapper allocates them (``torch.empty_like``), and its
in-place writes (the slab writeback into the store) are invisible to
:func:`inplace_report`.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.launch.collectives import CallTrace, _in_propagation


def _walk(obj: Any, path: str, seen: Set[int]) -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) for every tensor and numpy leaf of ``obj``:
    tuples (named ones by field), lists, dicts, dataclasses and plain
    objects' attributes."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield path, obj
        return
    if obj is None or isinstance(obj, (str, bytes, int, float, bool)) or \
            id(obj) in seen or callable(obj):
        return
    seen.add(id(obj))
    join = (lambda k: f"{path}.{k}" if path else str(k))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = zip(obj._fields, obj)
    elif isinstance(obj, (tuple, list)):
        items = enumerate(obj)
    elif isinstance(obj, dict):
        items = obj.items()
    elif dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    elif hasattr(obj, "__dict__"):
        items = vars(obj).items()
    else:
        return
    for k, v in items:
        yield from _walk(v, join(k), seen)


def tensor_leaves(obj: Any) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor leaf of ``obj``."""
    return [(p, t) for p, t in _walk(obj, "", set())
            if isinstance(t, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _default_min_bytes(args: Any) -> int:
    """Largest input buffer: outputs at or above it are 'large'."""
    return max((nbytes(t) for _, t in tensor_leaves(args)), default=1) or 1


@dataclasses.dataclass(frozen=True)
class LargeOutput:
    op: str
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int

    def render(self) -> str:
        return (f"{self.op}: {self.dtype}{list(self.shape)} "
                f"({self.nbytes / 2**20:.2f} MiB)")


class _Audit(CallTrace):
    """:class:`CallTrace` (live storages, collectives) that also records
    the op outputs with a new storage at or above ``min_bytes``, the
    storages mutating ops wrote, and an allocation log for :meth:`temp`."""

    def __init__(self, min_bytes: int):
        super().__init__()
        self.min_bytes = int(min_bytes)
        self.large: List[LargeOutput] = []
        self.fresh_bytes = 0
        self.written: Set[int] = set()
        self.fresh_by_size: Dict[int, int] = {}
        #: (storage serial, +/- bytes) in allocation order; a serial, not
        #: the storage's id, which a later storage may reuse
        self.log: List[Tuple[int, int]] = []
        self.serial: Dict[int, int] = {}          # live storage id -> serial

    def _gone(self, key: int, serial: int, n: int) -> None:
        self.log.append((serial, -n))
        if self.serial.get(key) == serial:
            del self.serial[key]

    def _track(self, t: torch.Tensor) -> Optional[int]:
        st = t.untyped_storage()
        key = id(st)
        if key not in self._live:
            n, serial = st.nbytes(), len(self.log)
            self.serial[key] = serial
            self.log.append((serial, n))
            weakref.finalize(st, self._gone, key, serial, n)
        return super()._track(t)

    def serials(self, storages) -> Set[int]:
        return {self.serial[id(st)] for st in storages
                if id(st) in self.serial}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = {id(a.untyped_storage()) for a in tree_leaves((args, kwargs))
                  if isinstance(a, torch.Tensor)}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or _in_propagation():
            return out
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in tree_leaves(val):
                if isinstance(t, torch.Tensor):
                    self.written.add(id(t.untyped_storage()))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if id(st) in before:
                continue                 # a view or an in-place result
            n = st.nbytes()
            self.fresh_bytes += n
            self.fresh_by_size[n] = self.fresh_by_size.get(n, 0) + 1
            if n >= self.min_bytes:
                self.large.append(LargeOutput(
                    str(func.name()), tuple(t.shape),
                    str(t.dtype).removeprefix("torch."), n))
        return out

    def temp(self, exclude: Set[int]) -> int:
        """Peak live bytes of the storages whose serials are not in
        ``exclude`` (the arguments' and the outputs')."""
        live = peak = 0
        for key, delta in self.log:
            if key in exclude:
                continue
            live += delta
            peak = max(peak, live)
        return peak


@dataclasses.dataclass
class AuditReport:
    """One audited call: its large outputs, the live bytes' peak (the
    arguments' storages counted from the start), the arguments' bytes and
    the temporaries' peak (:func:`temp_bytes`), and every fresh output's
    bytes."""

    min_bytes: int
    large: List[LargeOutput]
    peak_bytes: int
    arg_bytes: int
    temp_bytes: int
    fresh_bytes: int
    collectives: Dict[str, int]

    @property
    def peak_over_args(self) -> int:
        """The live peak above the arguments: what the call adds to the
        device's allocation at its highest (temporaries and outputs)."""
        return self.peak_bytes - self.arg_bytes

    def render(self) -> str:
        return (f"{len(self.large)} outputs >= {self.min_bytes / 2**20:.2f} "
                f"MiB; live peak {self.peak_bytes / 2**20:.2f} MiB "
                f"({self.arg_bytes / 2**20:.2f} MiB of arguments), temps "
                f"{self.temp_bytes / 2**20:.2f} MiB")


def audit(fn: Callable, *args: Any, min_bytes: Optional[int] = None,
          **kwargs: Any) -> Tuple[Any, AuditReport]:
    """Run ``fn(*args, **kwargs)`` under the audit mode; returns (its
    result, the :class:`AuditReport`)."""
    floor = _default_min_bytes((args, kwargs)) if min_bytes is None \
        else int(min_bytes)
    mode = _Audit(floor)
    with mode:
        mode.track_args([t for _, t in tensor_leaves((args, kwargs))])
        out = fn(*args, **kwargs)
    keep = [t.untyped_storage() for _, t in tensor_leaves((args, kwargs))]
    keep += [t.untyped_storage() for _, t in tensor_leaves(out)]
    rep = AuditReport(
        min_bytes=floor, large=list(mode.large),
        peak_bytes=mode.peak_bytes, arg_bytes=mode.arg_bytes,
        temp_bytes=mode.temp(mode.serials(keep)),
        fresh_bytes=mode.fresh_bytes, collectives=mode.collectives())
    return out, rep


def large_outputs(fn: Callable, *args: Any, min_bytes: Optional[int] = None,
                  **kwargs: Any) -> List[LargeOutput]:
    """Op outputs of ``fn(*args)`` with a new storage of at least
    ``min_bytes`` (default: the largest input tensor, so on the sampled
    federated path "large" means O(n·d))."""
    return audit(fn, *args, min_bytes=min_bytes, **kwargs)[1].large


def assert_large_outputs(fn: Callable, *args: Any, max_big: int = 2,
                         min_bytes: Optional[int] = None,
                         **kwargs: Any) -> List[LargeOutput]:
    """Assert the call materializes at most ``max_big`` outputs at or
    above the threshold; returns them for reporting."""
    big = large_outputs(fn, *args, min_bytes=min_bytes, **kwargs)
    if len(big) > max_big:
        lines = "\n  ".join(o.render() for o in big)
        raise AssertionError(
            f"{len(big)} large op outputs (allowed {max_big}) — the call "
            f"materializes extra full-size buffers:\n  {lines}")
    return big


def temp_bytes(fn: Callable, *args: Any, **kwargs: Any) -> int:
    """The peak bytes of the call's temporaries: storages live at once
    over the call that are neither arguments nor outputs (what XLA's
    ``temp_size_in_bytes`` counts for a compiled call)."""
    return audit(fn, *args, **kwargs)[1].temp_bytes


def flops(fn: Callable, *args: Any, **kwargs: Any) -> int:
    """The call's flops as ``torch.utils.flop_counter`` counts them (matrix
    products, convolutions, attention; elementwise ops count nothing)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return int(fc.get_total_flops())


@dataclasses.dataclass(frozen=True)
class FieldWrite:
    nbytes: int
    in_place: bool       # the call wrote this field's storage
    new_of_size: int     # fresh outputs of exactly this field's bytes


@dataclasses.dataclass(frozen=True)
class InplaceReport:
    fields: Dict[str, FieldWrite]

    def render(self) -> str:
        return "; ".join(
            f"{k}: {'in place' if w.in_place else 'not written'}, "
            f"{w.new_of_size} new of its size" for k, w in
            self.fields.items())


def inplace_report(fn: Callable, state: Any, *args: Any,
                   **kwargs: Any) -> InplaceReport:
    """For each tensor field of ``state`` (``fn(state, *args)``'s first
    argument): its bytes, whether the call wrote its storage in place, and
    how many new tensors of exactly its size the call made.  Eager torch
    has no donation: a field updated out of place costs a new buffer of
    its size every call, which this counts instead."""
    fields = tensor_leaves(state)
    mode = _Audit(_default_min_bytes(state))
    with mode:
        fn(state, *args, **kwargs)
    return InplaceReport({
        path: FieldWrite(nbytes(t), id(t.untyped_storage()) in mode.written,
                         mode.fresh_by_size.get(
                             t.untyped_storage().nbytes(), 0))
        for path, t in fields})


@dataclasses.dataclass(frozen=True)
class CarryReport:
    fields: Dict[str, int]

    @property
    def carry_bytes(self) -> int:
        return sum(self.fields.values())

    def render(self) -> str:
        top = sorted(self.fields.items(), key=lambda kv: -kv[1])[:6]
        return (f"carry {len(self.fields)} buffers, "
                f"{self.carry_bytes / 2**20:.2f} MiB ["
                + ", ".join(f"{k} {v / 2**20:.2f}" for k, v in top) + "]")


def carry_report(*carries: Any) -> CarryReport:
    """The bytes a chunk carries from round to round, by field: the tensor
    and numpy leaves of ``carries`` (the round state a chunk threads, the
    slab store's slab state, ``VecFedSim``'s async ``_Pipeline`` ring),
    each storage once.  This is where the async ring's O(tau·C·d) message
    rows show up."""
    seen: Set[int] = set()
    out: Dict[str, int] = {}
    for i, c in enumerate(carries):
        for path, leaf in _walk(c, f"{i}" if len(carries) > 1 else "",
                                set()):
            if isinstance(leaf, torch.Tensor):
                key, n = id(leaf.untyped_storage()), \
                    leaf.untyped_storage().nbytes()
            else:
                key, n = id(leaf), int(leaf.nbytes)
            if key not in seen:
                seen.add(key)
                out[path] = n
    return CarryReport(out)


def collective_report(fn: Callable, *args: Any,
                      **kwargs: Any) -> Dict[str, int]:
    """Collective bytes by kind and ``<kind>_count`` of the call
    (``CallTrace.collectives()``, the reference's loop-aware HLO totals:
    eager torch issues every loop iteration's collectives)."""
    return audit(fn, *args, **kwargs)[1].collectives
