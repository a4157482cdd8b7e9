"""DASHA as a distributed training method (port of
``repro.optim.distributed``): the trainer's config, its Method, its static
payload fraction, and the seed-era train-step API (``DashaTrainState``,
``dasha_train_init``, ``make_train_step``, ``method_state``,
``train_state``).

The "nodes" are data-parallel groups; every method quantity (h_i, g_i,
messages) is a parameter-shaped tree with a leading node axis.  The
algorithm is the methods layer's: :meth:`repro_torch.methods.Method.build`
over a :class:`~repro_torch.methods.substrates.TreeSubstrate` whose
:class:`~repro_torch.methods.substrates.BatchLossOracle` derives per-node
gradients from the loss, compressing through
:class:`~repro_torch.methods.substrates.TreeCompression`.
``use_kernel=True`` routes every mode x variant through the fused CUDA
kernels, with the MVR/SARAH h-update recomputed inside the kernel pass.

The reference's mesh knobs (``seq_shard``: the residual stream's sequence
dim over "model" between blocks; ``fsdp``: params, g and the server
optimizer's moments ZeRO-3-sharded over the data axes; ``spmd_axes``: the
mesh axes the node axis lies on) shape the train specs of
:func:`repro_torch.launch.specs.train_spec`, and ``grad_specs`` (the
parameters' specs with no node axis) makes the step sharded: on DTensors
each rank computes only its own nodes' gradients (the oracle's
``spmd_axes`` / ``grad_specs``), draws only its shards' masks and runs the
estimator update on its local shards (the compression's
``P(spmd_axes, *grad_spec)`` specs), and the aggregate ``mean_i m_i`` is
the one float32 reduction over the data axes, beside FSDP's gather of the
parameters and the scalar metrics.  On one device they change nothing, as
the reference's do on its 1x1 host mesh: the step with them set is the
step without them, bit for bit, on plain tensors and on a 1x1 mesh's
DTensors alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.compress.spec import omega_bernoulli, omega_permk
from repro_torch.core import tree
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.rng import Draws
from repro_torch.methods.accounting import expected_payload_frac
from repro_torch.methods.engine import Hyper, Method, MethodState
from repro_torch.methods.rules import get_rule
from repro_torch.methods.substrates import (BatchLossOracle,
                                            TreeCompression, TreeSubstrate)
from repro_torch.optim.base import SGD, Adam

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DashaTrainConfig:
    gamma: float                      # server stepsize
    compression: float = 0.03125     # fraction of coords sent (1/32)
    mode: str = "independent"        # independent | shared_coords | permk
    variant: str = "dasha"           # dasha | mvr | page | sync_mvr
    b: float = 0.1                   # MVR momentum
    p: float = 0.25                  # PAGE / SYNC-MVR coin probability
    n_nodes: int = 1
    server_opt: str = "sgd"          # sgd | adam (adam = beyond-paper)
    use_kernel: bool = False         # fused CUDA path (all modes/variants)
    state_dtype: str = "float32"     # h_i/g_i storage: float32 | bfloat16
    # mesh knobs: read by launch.specs.train_spec; no-ops on one device
    seq_shard: bool = False          # Megatron-SP residual-stream sharding
    fsdp: bool = False               # ZeRO-3 params / g / optimizer moments
    spmd_axes: Optional[Tuple[str, ...]] = None   # the node axis's axes

    @property
    def omega(self) -> float:
        if self.mode == "permk":
            return omega_permk(self.n_nodes)
        # independent & shared_coords Bernoulli-RandP
        return omega_bernoulli(self.compression)

    @property
    def a(self) -> float:
        return 1.0 / (2.0 * self.omega + 1.0)

    @property
    def torch_state_dtype(self) -> torch.dtype:
        return _STATE_DTYPES[self.state_dtype]

    @property
    def hyper(self) -> Hyper:
        return Hyper(gamma=self.gamma, a=self.a, variant=self.variant,
                     b=self.b, p=self.p)


class DashaTrainState(NamedTuple):
    """Trainer-facing state (the reference's, with ``key`` an integer
    ``seed``).  ``prev_params`` is retired, as in the reference: v1
    checkpoints that still carry it restore through
    :func:`repro_torch.checkpoint.load_state`."""

    params: Any           # the iterate (a parameter tree)
    g: Any                # server estimator (like params, float32)
    h_local: Any          # per-node h_i: leading node axis
    g_local: Any          # per-node g_i
    opt_state: Any
    seed: int             # root of every round's generators
    step: int             # global round index


def _server_opt(cfg: DashaTrainConfig):
    if cfg.server_opt == "adam":
        return Adam(lr=cfg.gamma)
    return SGD(lr=cfg.gamma)


def dasha_train_init(params: Any, cfg: DashaTrainConfig, seed: int,
                     grads0: Optional[Any] = None, *,
                     device=DEFAULT_DEVICE, mesh=None,
                     specs: Optional[DashaTrainState] = None
                     ) -> DashaTrainState:
    """The initial trainer state on ``device`` (the card unless the caller
    asks for the CPU).  ``grads0``: optional (n, *shape) initial per-node
    gradients (the paper's h_i^0 = g_i^0 = grad f_i(x^0)); zeros
    otherwise.  ``g`` is the float32 mean of the per-node state.

    On a ``mesh``, with ``specs`` the state's spec tree (``train_spec``'s
    ``in_shardings[0]``), every field is a DTensor laid out by its spec on
    the mesh's device: the parameters as given (or cut to their shards),
    the zeros made at each shard's shape (``grads0`` is for one
    device)."""
    if mesh is not None:
        if grads0 is not None:
            raise ValueError("grads0 is for one device: on a mesh, lay a "
                             "full state out with distribute_tree")
        return _sharded_init(params, cfg, seed, mesh, specs)
    dev = resolve_device(device)
    n, sdt = cfg.n_nodes, cfg.torch_state_dtype
    params = tree.map_leaves(lambda p: p.to(dev), params)
    if grads0 is None:
        per_node = tree.map_leaves(
            lambda p: torch.zeros((n,) + tuple(p.shape), dtype=sdt,
                                  device=dev), params)
    else:
        per_node = tree.map_leaves(lambda h: h.to(device=dev, dtype=sdt),
                                   grads0)
    g = tree.map_leaves(lambda h: torch.mean(h.to(torch.float32), 0),
                        per_node)
    return DashaTrainState(params=params, g=g, h_local=per_node,
                           g_local=per_node,
                           opt_state=_server_opt(cfg).init(params),
                           seed=int(seed), step=0)


def _sharded_init(params, cfg: DashaTrainConfig, seed: int, mesh,
                  specs: Optional[DashaTrainState]) -> DashaTrainState:
    from repro_torch.models import sharding as sh
    if specs is None:
        raise ValueError("dasha_train_init on a mesh needs the state's "
                         "specs (train_spec's in_shardings[0])")
    dev = torch.device(mesh.device_type)
    meta = tree.map_leaves(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                                 device="meta"), params)
    skel = dasha_train_init(meta, cfg, seed, device="meta")

    def zeros(path, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state = sh.distribute_tree(skel, specs, mesh, make_local=zeros)
    if not any(sh.is_dtensor(p) for p in tree.leaves(params)):
        params = sh.distribute_tree(params, specs.params, mesh)
    return state._replace(params=params)


def make_method(cfg: DashaTrainConfig,
                loss_fn: Callable[[Any, Any], torch.Tensor],
                grad_specs: Optional[Any] = None) -> Method:
    """The trainer's Method (variant rule x TreeCompression x
    TreeSubstrate): ``method.init(params, seed, init_mode="zeros",
    device=...)`` then ``Driver(method, data_fn=...).run(...)``.

    ``loss_fn(params, node_batch) -> scalar``; steps take a batch tree with
    a leading node axis (n, ...).  ``grad_specs``: optional per-parameter
    specs (no node axis), read on DTensors: each node's gradient is laid
    out by them, and with ``cfg.spmd_axes`` the per-node state's masks by
    ``P(spmd_axes, *spec)`` (module docstring)."""
    from repro_torch.models.sharding import is_spec, map_with_path, node_spec
    sdt = cfg.torch_state_dtype
    node_full_specs = None
    if grad_specs is not None and cfg.spmd_axes:
        node_full_specs = map_with_path(
            lambda _, s: node_spec(cfg.spmd_axes, s), grad_specs,
            is_leaf=is_spec)
    oracle = BatchLossOracle(loss_fn=loss_fn, state_dtype=sdt,
                             spmd_axes=cfg.spmd_axes, grad_specs=grad_specs)
    substrate = TreeSubstrate(oracle=oracle, n=cfg.n_nodes,
                              server_opt=_server_opt(cfg), state_dtype=sdt)
    comp = TreeCompression(mode=cfg.mode, p=cfg.compression, n=cfg.n_nodes,
                           use_kernel=cfg.use_kernel, specs=node_full_specs)
    return Method.build(cfg.variant, comp, substrate, cfg.hyper)


def payload_frac(cfg: DashaTrainConfig) -> float:
    """Static E[coords sent]/d: the compressor's fraction plus the sync
    rounds' dense uploads (SYNC-MVR's prob-p megabatch)."""
    comp = TreeCompression(mode=cfg.mode, p=cfg.compression,
                           n=cfg.n_nodes)
    return expected_payload_frac(get_rule(cfg.variant), cfg.hyper,
                                 comp.static_frac)


def method_state(state: DashaTrainState,
                 bits_sent: Optional[Any] = None) -> MethodState:
    """View a trainer state as the engine's MethodState."""
    if bits_sent is None:
        bits_sent = np.float32(0)
    return MethodState(x=state.params, g=state.g, g_local=state.g_local,
                       h_local=state.h_local, opt_state=state.opt_state,
                       seed=state.seed, t=state.step, bits_sent=bits_sent)


def train_state(ms: MethodState) -> DashaTrainState:
    """Project a MethodState back onto the trainer state (drops the
    cumulative ``bits_sent``: the train step reports it as a metric)."""
    return DashaTrainState(params=ms.x, g=ms.g, h_local=ms.h_local,
                           g_local=ms.g_local, opt_state=ms.opt_state,
                           seed=ms.seed, step=ms.t)


def make_train_step(cfg: DashaTrainConfig,
                    loss_fn: Callable[[Any, Any], torch.Tensor],
                    grad_specs: Optional[Any] = None
                    ) -> Callable[..., Tuple[DashaTrainState, dict]]:
    """The train step for any registry variant (a thin wrapper over
    :func:`make_method`): ``step(state, batch, draws=None) -> (state,
    {"g_norm_sq", "payload_frac", "payload_coords"})``.  ``g_norm_sq`` is
    ``sum ||g||^2`` over ``state.g``'s leaves before the step, and
    ``payload_coords`` the round's coords sent per node.  ``draws``
    injects the round's randomness (:meth:`Method.step_full`).
    ``grad_specs``: as :func:`make_method`'s.  ``g_norm_sq`` stays a sum
    of per-leaf squares: no leaf is flattened, so a sharded ``g`` is never
    gathered for it (on DTensors it is a scalar DTensor)."""
    method = make_method(cfg, loss_fn, grad_specs)
    frac = np.float32(payload_frac(cfg))

    def step(state: DashaTrainState, batch, draws: Optional[Draws] = None
             ) -> Tuple[DashaTrainState, dict]:
        gn = sum(torch.sum(torch.square(x)) for x in tree.leaves(state.g))
        ms, _ = method.step_full(method_state(state), batch, draws=draws)
        return train_state(ms), {"g_norm_sq": gn, "payload_frac": frac,
                                 "payload_coords": ms.bits_sent}

    return step
