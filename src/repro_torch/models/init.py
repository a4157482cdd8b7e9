"""Parameter initialisation (port of ``repro.models.init``, the ``ssm``
family).

Layers are stacked along a leading L axis, as the reference's
``lax.scan`` expects, so ``params["layers"]`` has one leaf per weight kind
and the per-node optimizer state has the reference's leaves.  Every draw
comes from a ``torch.Generator`` on ``device`` seeded from ``(seed,
part)``; the numbers differ from the reference's threefry draws, so parity
tests carry the reference's parameters across (``convert.params_from_numpy``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.rng import generator
from repro_torch.models.common import ArchConfig


def _dense_init(gen: torch.Generator, shape, dtype, fan_in=None
                ) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan, 1))
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def _stack(n: int, fn: Callable[[int], Dict]) -> Dict:
    """``fn(i)`` for each of n layers, stacked leaf-wise on a leading axis."""
    per_layer = [fn(i) for i in range(n)]
    return {k: torch.stack([p[k] for p in per_layer])
            for k in per_layer[0]}


def _mamba_params(gen: torch.Generator, cfg: ArchConfig, dt) -> Dict:
    d = cfg.d_model
    H, P, N, W = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.conv_width
    cd = H * P + 2 * N
    dev = gen.device
    return {"ln": torch.zeros((d,), dtype=dt, device=dev),
            "w_z": _dense_init(gen, (d, H, P), dt, d),
            "w_xbc": _dense_init(gen, (d, cd), dt, d),
            "w_dt": _dense_init(gen, (d, H), dt, d),
            "dt_bias": torch.full((H,), math.log(math.e - 1), dtype=dt,
                                  device=dev),                 # softplus = 1
            "conv_w": _dense_init(gen, (W, cd), dt, W),
            "conv_b": torch.zeros((cd,), dtype=dt, device=dev),
            "A_log": torch.zeros((H,), dtype=torch.float32,
                                 device=dev),                  # A = -1
            "D": torch.ones((H,), dtype=torch.float32, device=dev),
            "norm": torch.zeros((H * P,), dtype=dt, device=dev),
            "w_out": _dense_init(gen, (H * P, d), dt, H * P)}


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device=DEFAULT_DEVICE) -> Dict:
    """Random parameters of ``cfg`` on ``device`` (the ``ssm`` family)."""
    if cfg.arch_type != "ssm":
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported to repro_torch yet")
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    params: Dict = {
        "embed": _dense_init(generator(dev, seed, "embed"),
                             (cfg.padded_vocab, cfg.d_model), dt,
                             cfg.d_model),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(generator(dev, seed, "lm_head"),
                                        (cfg.d_model, cfg.padded_vocab), dt)
    params["layers"] = _stack(cfg.num_layers, lambda i: _mamba_params(
        generator(dev, seed, "layer", i), cfg, dt))
    return params
