"""Parameter initialisation (port of ``repro.models.init``): the ``ssm``
family and the homogeneous dense transformer stack.

Layers are stacked along a leading L axis, as the reference's
``lax.scan`` expects, so ``params["layers"]`` has one leaf per weight kind
(nested ``attn`` / ``ffn`` dicts for a transformer block) and the per-node
optimizer state has the reference's leaves.  Every draw comes from a
``torch.Generator`` on ``device`` seeded from ``(seed, part, layer)``; the
numbers differ from the reference's threefry draws, so parity tests carry
the reference's parameters across (``convert.params_from_numpy``).  On the
``meta`` device nothing is drawn or allocated: the tree carries the shapes
and dtypes only (:meth:`ArchConfig.param_count`).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.rng import generator
from repro_torch.models.common import ArchConfig

#: the reference's families that wait for a later slice, and what each is
_NOT_PORTED = {"moe": "mixture-of-experts: phi3.5-moe, and deepseek-v2's "
                      "MLA with experts",
               "hybrid": "Mamba2 + shared attention (zamba2)",
               "vlm": "vision cross-attention (llama-3.2-vision)",
               "audio": "encoder-decoder (whisper)"}


def require_ported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError, naming the family, for an architecture
    the port does not run yet: every ``arch_type`` but ``ssm`` and the
    homogeneous ``dense`` stack (gemma3's grouped local/global stack
    included)."""
    at = cfg.arch_type
    if at == "dense" and cfg.global_every:
        family = "gemma3's grouped local/global attention"
    elif at in ("ssm", "dense"):
        return
    else:
        family = _NOT_PORTED.get(at, at)
    raise NotImplementedError(
        f"arch_type {at!r} ({family}) is not ported to repro_torch yet")


class _Draws:
    """One generator per ``(seed, part, ...)`` on ``dev`` (None on the
    ``meta`` device, which draws nothing)."""

    def __init__(self, dev: torch.device, seed: int):
        self.dev, self.seed = dev, seed

    def __call__(self, *parts) -> Optional[torch.Generator]:
        if self.dev.type == "meta":
            return None
        return generator(self.dev, self.seed, *parts)


def _dense_init(gen: Optional[torch.Generator], dev: torch.device, shape,
                dtype, fan_in=None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan, 1))
    w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    return (w * scale).to(dtype)


def _zeros(dev, shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=dev)


def _stack(n: int, fn: Callable[[int], Dict]) -> Dict:
    """``fn(i)`` for each of n layers, stacked leaf-wise on a leading axis
    (nested dicts stay nested)."""
    per_layer = [fn(i) for i in range(n)]

    def stack(parts):
        if isinstance(parts[0], dict):
            return {k: stack([p[k] for p in parts]) for k in parts[0]}
        return torch.stack(parts)

    return stack(per_layer)


def _mamba_params(gen, dev, cfg: ArchConfig, dt) -> Dict:
    d = cfg.d_model
    H, P, N, W = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.conv_width
    cd = H * P + 2 * N
    return {"ln": _zeros(dev, (d,), dt),
            "w_z": _dense_init(gen, dev, (d, H, P), dt, d),
            "w_xbc": _dense_init(gen, dev, (d, cd), dt, d),
            "w_dt": _dense_init(gen, dev, (d, H), dt, d),
            "dt_bias": torch.full((H,), math.log(math.e - 1), dtype=dt,
                                  device=dev),                 # softplus = 1
            "conv_w": _dense_init(gen, dev, (W, cd), dt, W),
            "conv_b": _zeros(dev, (cd,), dt),
            "A_log": _zeros(dev, (H,), torch.float32),         # A = -1
            "D": torch.ones((H,), dtype=torch.float32, device=dev),
            "norm": _zeros(dev, (H * P,), dt),
            "w_out": _dense_init(gen, dev, (H * P, d), dt, H * P)}


def _mlp_params(gen, dev, cfg: ArchConfig, d: int, ff: int, dt) -> Dict:
    if cfg.mlp_type == "gelu":
        return {"w_in": _dense_init(gen, dev, (d, ff), dt),
                "b_in": _zeros(dev, (ff,), dt),
                "w_out": _dense_init(gen, dev, (ff, d), dt, ff),
                "b_out": _zeros(dev, (d,), dt)}
    return {"w_gate": _dense_init(gen, dev, (d, ff), dt),
            "w_in": _dense_init(gen, dev, (d, ff), dt),
            "w_out": _dense_init(gen, dev, (ff, d), dt, ff)}


def _gqa_params(gen, dev, cfg: ArchConfig, dt) -> Dict:
    d, H, G, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": _dense_init(gen, dev, (d, H, hd), dt, d),
         "wk": _dense_init(gen, dev, (d, G, hd), dt, d),
         "wv": _dense_init(gen, dev, (d, G, hd), dt, d),
         "wo": _dense_init(gen, dev, (H, hd, d), dt, H * hd)}
    if cfg.qkv_bias:
        p.update(bq=_zeros(dev, (H, hd), dt), bk=_zeros(dev, (G, hd), dt),
                 bv=_zeros(dev, (G, hd), dt))
    return p


def _block_params(draws: _Draws, i: int, cfg: ArchConfig, dt) -> Dict:
    """Layer ``i`` of the dense transformer stack: its attention and its
    MLP each from their own generator."""
    dev = draws.dev
    return {"ln1": _zeros(dev, (cfg.d_model,), dt),
            "ln2": _zeros(dev, (cfg.d_model,), dt),
            "attn": _gqa_params(draws("layer", i, "attn"), dev, cfg, dt),
            "ffn": _mlp_params(draws("layer", i, "ffn"), dev, cfg,
                               cfg.d_model, cfg.d_ff, dt)}


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device=DEFAULT_DEVICE) -> Dict:
    """Random parameters of ``cfg`` on ``device`` (the ``ssm`` family and
    the homogeneous dense stack; every other family raises
    NotImplementedError)."""
    require_ported(cfg)
    dev = resolve_device(device)
    draws = _Draws(dev, seed)
    dt = cfg.torch_dtype
    params: Dict = {
        "embed": _dense_init(draws("embed"), dev,
                             (cfg.padded_vocab, cfg.d_model), dt,
                             cfg.d_model),
        "final_norm": _zeros(dev, (cfg.d_model,), dt),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(draws("lm_head"), dev,
                                        (cfg.d_model, cfg.padded_vocab), dt)
    if cfg.arch_type == "ssm":
        params["layers"] = _stack(cfg.num_layers, lambda i: _mamba_params(
            draws("layer", i), dev, cfg, dt))
    else:
        params["layers"] = _stack(cfg.num_layers, lambda i: _block_params(
            draws, i, cfg, dt))
    return params
