"""DASHA as a distributed training method (port of
``repro.optim.distributed``): the trainer's config, its Method and its
static payload fraction.

The "nodes" are data-parallel groups; every method quantity (h_i, g_i,
messages) is a parameter-shaped tree with a leading node axis.  The
algorithm is the methods layer's: :meth:`repro_torch.methods.Method.build`
over a :class:`~repro_torch.methods.substrates.TreeSubstrate` whose
:class:`~repro_torch.methods.substrates.BatchLossOracle` derives per-node
gradients from the loss, compressing through
:class:`~repro_torch.methods.substrates.TreeCompression`.
``use_kernel=True`` routes every mode x variant through the fused CUDA
kernels, with the MVR/SARAH h-update recomputed inside the kernel pass.

The reference's sharding knobs (``seq_shard``, ``fsdp``, ``spmd_axes``)
belong to its TPU mesh.  They are kept as fields so the config reads the
same, and must stay at their defaults: the port runs one device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.compress.spec import omega_bernoulli, omega_permk
from repro_torch.methods.accounting import expected_payload_frac
from repro_torch.methods.engine import Hyper, Method
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
    # the reference's TPU mesh knobs: must stay at their defaults here
    seq_shard: bool = False
    fsdp: bool = False
    spmd_axes: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.seq_shard or self.fsdp or self.spmd_axes:
            raise NotImplementedError(
                "seq_shard / fsdp / spmd_axes shard the reference's TPU "
                "mesh; repro_torch trains on one device")

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


def _server_opt(cfg: DashaTrainConfig):
    if cfg.server_opt == "adam":
        return Adam(lr=cfg.gamma)
    return SGD(lr=cfg.gamma)


def make_method(cfg: DashaTrainConfig,
                loss_fn: Callable[[Any, Any], torch.Tensor]) -> Method:
    """The trainer's Method (variant rule x TreeCompression x
    TreeSubstrate): ``method.init(params, seed, init_mode="zeros",
    device=...)`` then ``Driver(method, data_fn=...).run(...)``.

    ``loss_fn(params, node_batch) -> scalar``; steps take a batch tree with
    a leading node axis (n, ...)."""
    sdt = cfg.torch_state_dtype
    oracle = BatchLossOracle(loss_fn=loss_fn, state_dtype=sdt)
    substrate = TreeSubstrate(oracle=oracle, n=cfg.n_nodes,
                              server_opt=_server_opt(cfg), state_dtype=sdt)
    comp = TreeCompression(mode=cfg.mode, p=cfg.compression, n=cfg.n_nodes,
                           use_kernel=cfg.use_kernel)
    return Method.build(cfg.variant, comp, substrate, cfg.hyper)


def payload_frac(cfg: DashaTrainConfig) -> float:
    """Static E[coords sent]/d: the compressor's fraction plus the sync
    rounds' dense uploads (SYNC-MVR's prob-p megabatch)."""
    comp = TreeCompression(mode=cfg.mode, p=cfg.compression,
                           n=cfg.n_nodes)
    return expected_payload_frac(get_rule(cfg.variant), cfg.hyper,
                                 comp.static_frac)
