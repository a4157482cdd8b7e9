"""Per-lane hyperparameters of a sweep (:class:`repro_torch.methods.driver.
Sweeper`).

A sweep runs G copies of one method side by side, each with its own value
of a hyperparameter such as the stepsize.  The state of such a run has a
leading (G,) lane axis on every device field: the iterate is (G, d), the
per-node fields are (G, n, d).  A :class:`Lanes` holds the G values of one
scalar hyperparameter and stands where a method's arithmetic expects a
Python float:

* against a Python number it stays on the host, in float64, as a scalar
  expression does (``1.0 - b``); such results are memoised, so a rule that
  forms ``1.0 - b`` every round makes one :class:`Lanes`;
* against a tensor it becomes a tensor of the tensor's dtype and device,
  shaped (G, 1, ..., 1) to the tensor's rank, so lane j's value meets lane
  j's rows, whatever the rank of the tensor (a (G, d) iterate or (G, n, d)
  per-node rows).  Each (device, dtype, rank) is made once.

Below the methods layer nothing knows a :class:`Lanes`: a fused kernel
takes a sweep's ``a`` (and kernel 3 its ``1 - b``) as a (G,) fp32 tensor,
:func:`kernel_value`, and a coin its per-lane p as a (G,) array,
:func:`host_value`.

Lane j's arithmetic is then a sequential run's at ``values[j]``: the
float64 expression is rounded to the tensor's dtype once, where it meets
the tensor, as torch rounds a Python scalar.
"""
from __future__ import annotations

import operator
from typing import Callable, Dict, Tuple

import numpy as np
import torch


class Lanes:
    """G values of one scalar hyperparameter (see the module docstring)."""

    def __init__(self, values):
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        v = np.array(values, dtype=np.float64)
        if v.ndim != 1 or v.size == 0:
            raise ValueError(f"lane values must be a non-empty 1-D array, "
                             f"got shape {v.shape}")
        self.values = v
        self._tensors: Dict[Tuple, torch.Tensor] = {}
        self._derived: Dict[Tuple, "Lanes"] = {}

    def __len__(self) -> int:
        return int(self.values.size)

    def __repr__(self) -> str:
        return f"Lanes({self.values.tolist()})"

    def as_tensor(self, like: torch.Tensor) -> torch.Tensor:
        """The values in ``like``'s dtype and device, (G, 1, ..., 1) to
        ``like``'s rank."""
        key = (like.device, like.dtype, like.dim())
        t = self._tensors.get(key)
        if t is None:
            t = torch.as_tensor(self.values).to(like.dtype).reshape(
                (-1,) + (1,) * (like.dim() - 1)).to(like.device)
            self._tensors[key] = t
        return t

    def as_vector(self, device) -> torch.Tensor:
        """The values as a contiguous (G,) fp32 tensor on ``device``, each
        rounded once from float64 as a lane's scalar is where it meets an
        fp32 tensor; made once per device."""
        key = ("vector", torch.device(device))
        t = self._tensors.get(key)
        if t is None:
            t = self._tensors[key] = torch.as_tensor(self.values).to(
                torch.float32).to(device).contiguous()
        return t

    def _apply(self, other, fn: Callable, name: str, swap: bool):
        if isinstance(other, torch.Tensor):
            mine = self.as_tensor(other)
            return fn(other, mine) if swap else fn(mine, other)
        if isinstance(other, (int, float, np.floating, np.integer)):
            key = (name, swap, float(other))
            out = self._derived.get(key)
            if out is None:
                a, b = (float(other), self.values) if swap else \
                    (self.values, float(other))
                out = self._derived[key] = Lanes(fn(a, b))
            return out
        return NotImplemented

    def __neg__(self) -> "Lanes":
        return self._apply(-1.0, operator.mul, "mul", False)


def _binary(name: str, fn: Callable):
    def forward(self, other):
        return self._apply(other, fn, name, False)

    def reflected(self, other):
        return self._apply(other, fn, name, True)
    return forward, reflected


for _name, _fn in (("add", operator.add), ("sub", operator.sub),
                   ("mul", operator.mul), ("truediv", operator.truediv)):
    _fwd, _ref = _binary(_name, _fn)
    setattr(Lanes, f"__{_name}__", _fwd)
    setattr(Lanes, f"__r{_name}__", _ref)


def kernel_value(v, device):
    """A scalar hyperparameter as a fused kernel takes it: a number as it
    is, a :class:`Lanes` as its (G,) fp32 :meth:`Lanes.as_vector`."""
    return v.as_vector(device) if isinstance(v, Lanes) else v


def host_value(v):
    """A scalar hyperparameter as a host comparison takes it: a number as
    it is, a :class:`Lanes` as its (G,) float64 values."""
    return v.values if isinstance(v, Lanes) else v


def as_lanes(values):
    """``values`` (a 1-D array or tensor, or a dict of them) as
    :class:`Lanes` (a dict of them), and the lane count G.  Every axis must
    have the same G."""
    if isinstance(values, dict):
        if not values:
            raise ValueError("a sweep needs at least one value axis")
        out = {k: v if isinstance(v, Lanes) else Lanes(v)
               for k, v in values.items()}
        counts = {len(v) for v in out.values()}
        if len(counts) != 1:
            raise ValueError(f"value axes of different lengths: "
                             f"{ {k: len(v) for k, v in out.items()} }")
        return out, counts.pop()
    lanes = values if isinstance(values, Lanes) else Lanes(values)
    return lanes, len(lanes)


def lane_metric(fn: Callable, lanes: Callable) -> Callable:
    """``fn``, a metric of one lane's state, with its lane form attached:
    ``lanes`` takes the same arguments with a lane state and returns the G
    lanes' values, (G, ...).  A sweep evaluates a metric through its lane
    form where it has one (one pass for all lanes), else lane by lane."""
    fn.lanes = lanes
    return fn
