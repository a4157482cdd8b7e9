"""Carry state, parameters, decode caches, problems and plans across from
the reference package.

Everything arrives as numpy arrays (the reference's arrays through
``np.asarray``; bfloat16 arrays keep their ``ml_dtypes`` bfloat16 dtype),
so this module imports nothing of the reference.  The reference's JAX key
is not carried: the port seeds its own generators from an integer seed.
The parity tests start both packages from one state with these functions,
and replay the reference's plans through :func:`plan_from_numpy`.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.compress.plan import Plan
from repro_torch.core import tree
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.oracles import FiniteSumProblem
from repro_torch.methods.engine import MethodState
from repro_torch.optim.base import AdamState

_STATE_FIELDS = ("x", "g", "g_local", "h_local", "t", "bits_sent")


def _tensor(a, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def state_from_numpy(arrays: Mapping[str, np.ndarray], *, seed: int,
                     device=DEFAULT_DEVICE) -> MethodState:
    """The port's MethodState from a reference flat-path state given as a
    dict of numpy arrays (``x``, ``g``, ``g_local``, ``h_local``, ``t``,
    ``bits_sent``; ``opt_state`` is () on the flat path)."""
    missing = [k for k in _STATE_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"state is missing {missing}")
    if tuple(arrays.get("opt_state", ())) != ():
        raise ValueError("only the flat path's empty opt_state is carried")
    dev = resolve_device(device)
    return MethodState(x=_tensor(arrays["x"], dev),
                       g=_tensor(arrays["g"], dev),
                       g_local=_tensor(arrays["g_local"], dev),
                       h_local=_tensor(arrays["h_local"], dev),
                       opt_state=(), seed=int(seed),
                       t=int(np.asarray(arrays["t"])),
                       bits_sent=np.float32(np.asarray(arrays["bits_sent"])))


def problem_from_numpy(loss, features: np.ndarray, labels: np.ndarray, *,
                       device=DEFAULT_DEVICE) -> FiniteSumProblem:
    """A finite-sum problem over the given (n, m, ...) features and labels
    with a per-sample torch ``loss``."""
    dev = resolve_device(device)
    return FiniteSumProblem(loss=loss, features=_tensor(features, dev),
                            labels=_tensor(labels, dev))


def plan_from_numpy(kind: str, scale, *, indices: Optional[np.ndarray] = None,
                    mask: Optional[np.ndarray] = None,
                    dither_u: Optional[np.ndarray] = None, levels: int = 0,
                    payload_coords: float = 0.0, wire_coords: float = 0.0,
                    device=DEFAULT_DEVICE) -> Plan:
    """A port Plan holding the given arrays (a reference plan's fields
    through ``np.asarray``).  An array ``scale`` (participation coins)
    becomes an (n, 1) tensor."""
    dev = resolve_device(device)
    if np.ndim(scale) > 0:
        scale = _tensor(scale, dev)
    else:
        scale = float(scale)
    return Plan(kind=kind, scale=scale,
                indices=None if indices is None
                else _tensor(indices, dev, torch.int64),
                mask=None if mask is None else _tensor(mask, dev),
                dither_u=None if dither_u is None else _tensor(dither_u, dev),
                levels=int(levels), payload_coords=float(payload_coords),
                wire_coords=float(wire_coords))


def _exact(a, dev) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype (bfloat16 by its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.as_tensor(np.array(a), device=dev)


def params_from_numpy(params: Mapping[str, Any], *,
                      device=DEFAULT_DEVICE) -> dict:
    """The port's parameter tree from the reference's ``init_params``
    output as a nested dict of numpy arrays (bfloat16 or float32), dtype
    for dtype and bit for bit."""
    dev = resolve_device(device)
    return tree.map_leaves(lambda a: _exact(a, dev), dict(params))


def cache_from_numpy(cache: Mapping[str, Any], *,
                     device=DEFAULT_DEVICE) -> dict:
    """The port's decode cache from the reference's (``lm.init_cache`` or
    a ``decode_step`` output, as numpy arrays): Mamba2's conv window in its
    dtype (bfloat16 by its bits) and float32 SSM state, or the dense
    family's stacked K and V (ring buffers included), exactly."""
    dev = resolve_device(device)
    return tree.map_leaves(lambda a: _exact(a, dev), dict(cache))


def _opt_state_from_numpy(opt, dev):
    if opt is None or (isinstance(opt, tuple) and len(opt) == 0):
        return ()
    return AdamState(mu=params_from_numpy(opt["mu"], device=dev),
                     nu=params_from_numpy(opt["nu"], device=dev),
                     count=int(np.asarray(opt["count"])))


def tree_state_from_numpy(arrays: Mapping[str, Any], *, seed: int,
                          device=DEFAULT_DEVICE) -> MethodState:
    """The port's MethodState from a reference tree-path state (the
    trainer's ``MethodState``/``DashaTrainState`` fields as numpy trees):
    ``x`` (params), ``g``, ``g_local``, ``h_local``, ``t``, ``bits_sent``
    and ``opt_state`` as ``{"mu", "nu", "count"}`` (Adam) or ``()``
    (plain SGD, whose state carries nothing)."""
    missing = [k for k in _STATE_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"state is missing {missing}")
    dev = resolve_device(device)

    def trees(name):
        return params_from_numpy(arrays[name], device=dev)

    return MethodState(x=trees("x"), g=trees("g"),
                       g_local=trees("g_local"), h_local=trees("h_local"),
                       opt_state=_opt_state_from_numpy(
                           arrays.get("opt_state"), dev),
                       seed=int(seed), t=int(np.asarray(arrays["t"])),
                       bits_sent=np.float32(np.asarray(arrays["bits_sent"])))
