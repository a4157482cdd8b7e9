"""Parameter initialisation (port of ``repro.models.init``): the ``ssm``
family, the homogeneous transformer stack (dense GQA, or MLA and routed
experts for the ``moe`` family), gemma3's grouped local/global stack,
the ``hybrid`` family (zamba2: stacked Mamba2 layers and one shared
transformer block, ``shared_attn``), the ``vlm`` family (llama-3.2-vision:
the transformer stack and ``cross_layers``, one gated cross-attention
block per ``cross_attn_every`` layers) and the ``audio`` family (whisper:
an encoder stack ``enc_layers`` with its ``enc_norm``, and a decoder
stack with one cross block per layer).

Layers are stacked along a leading L axis, as the reference's
``lax.scan`` expects, so ``params["layers"]`` has one leaf per weight kind
(nested ``attn`` / ``ffn`` dicts for a transformer block) and the per-node
optimizer state has the reference's leaves.  gemma3's groups stack twice:
``local_layers`` (n_groups, n_local, ...) and ``global_layers``
(n_groups, ...).  Every draw comes from a ``torch.Generator`` on
``device`` seeded from ``(seed, part, group, layer)``; the numbers differ
from the reference's threefry draws, so parity tests carry the
reference's parameters across (``convert.params_from_numpy``).  On the
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

#: every ``arch_type`` of the reference, all ported
PORTED = ("ssm", "dense", "moe", "hybrid", "vlm", "audio")


def require_ported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError, naming the family, for an ``arch_type``
    that is none of the reference's (:data:`PORTED`)."""
    at = cfg.arch_type
    if at in PORTED:
        return
    raise NotImplementedError(
        f"arch_type {at!r} is no family of the reference, and not ported "
        f"to repro_torch (ported: {', '.join(PORTED)})")


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
    (nested dicts stay nested).  Each layer is copied into its slot as it
    is made, so the peak is the stack and one layer (a 42 GB stack of
    experts would not fit twice)."""
    def alloc(part):
        if isinstance(part, dict):
            return {k: alloc(v) for k, v in part.items()}
        return torch.empty((n,) + tuple(part.shape), dtype=part.dtype,
                           device=part.device)

    def put(out, part, i):
        if isinstance(part, dict):
            for k, v in part.items():
                put(out[k], v, i)
        else:
            out[i].copy_(part)

    first = fn(0)
    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, fn(i), i)
    return out


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


def _mla_params(gen, dev, cfg: ArchConfig, dt) -> Dict:
    d, H = cfg.d_model, cfg.num_heads
    dn, dr, dv, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim, cfg.kv_lora_rank)
    return {"wq": _dense_init(gen, dev, (d, H, dn + dr), dt, d),
            "w_dkv": _dense_init(gen, dev, (d, r), dt, d),
            "w_krope": _dense_init(gen, dev, (d, dr), dt, d),
            "w_uk": _dense_init(gen, dev, (r, H, dn), dt, r),
            "w_uv": _dense_init(gen, dev, (r, H, dv), dt, r),
            "wo": _dense_init(gen, dev, (H, dv, d), dt, H * dv)}


def _moe_params(gen, dev, cfg: ArchConfig, dt) -> Dict:
    """The router (float32 in any model dtype), the experts stacked
    (E, d, ff) / (E, ff, d), and the shared experts as one d x
    ff * num_shared SwiGLU."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff
    p = {"router": _dense_init(gen, dev, (d, E), torch.float32, d),
         "w_gate": _dense_init(gen, dev, (E, d, ff), dt, d),
         "w_in": _dense_init(gen, dev, (E, d, ff), dt, d),
         "w_out": _dense_init(gen, dev, (E, ff, d), dt, ff)}
    if cfg.num_shared_experts:
        sf = ff * cfg.num_shared_experts
        p.update(shared_w_gate=_dense_init(gen, dev, (d, sf), dt),
                 shared_w_in=_dense_init(gen, dev, (d, sf), dt),
                 shared_w_out=_dense_init(gen, dev, (sf, d), dt, sf))
    return p


def _block_params(draws: _Draws, tag: tuple, cfg: ArchConfig, dt) -> Dict:
    """One transformer block (``tag`` names it: ``("layer", i)``,
    ``("local", g, j)`` / ``("global", g)`` in gemma3's groups, or
    ``("shared_attn",)`` for the hybrid family's shared block): its
    attention (GQA or MLA) and its feed-forward (an MLP or the routed
    experts) each from their own generator."""
    dev = draws.dev
    attn, ffn = draws(*tag, "attn"), draws(*tag, "ffn")
    return {"ln1": _zeros(dev, (cfg.d_model,), dt),
            "ln2": _zeros(dev, (cfg.d_model,), dt),
            "attn": _mla_params(attn, dev, cfg, dt) if cfg.use_mla
            else _gqa_params(attn, dev, cfg, dt),
            "ffn": _moe_params(ffn, dev, cfg, dt) if cfg.num_experts
            else _mlp_params(ffn, dev, cfg, cfg.d_model, cfg.d_ff, dt)}


def _cross_block_params(draws: _Draws, tag: tuple, cfg: ArchConfig,
                        dt) -> Dict:
    """One gated cross-attention block: GQA projections and a dense MLP
    (never MLA or experts), with ``attn_gate`` and ``mlp_gate`` (1,) at
    zero, so that a fresh block adds nothing."""
    dev = draws.dev
    return {"ln1": _zeros(dev, (cfg.d_model,), dt),
            "ln2": _zeros(dev, (cfg.d_model,), dt),
            "attn": _gqa_params(draws(*tag, "attn"), dev, cfg, dt),
            "ffn": _mlp_params(draws(*tag, "ffn"), dev, cfg, cfg.d_model,
                               cfg.d_ff, dt),
            "attn_gate": _zeros(dev, (1,), dt),
            "mlp_gate": _zeros(dev, (1,), dt)}


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device=DEFAULT_DEVICE) -> Dict:
    """Random parameters of ``cfg`` on ``device`` (every family of the
    reference; any other ``arch_type`` raises NotImplementedError)."""
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
    if cfg.arch_type in ("ssm", "hybrid"):
        params["layers"] = _stack(cfg.num_layers, lambda i: _mamba_params(
            draws("layer", i), dev, cfg, dt))
        if cfg.arch_type == "hybrid":   # one block, shared by every use
            params["shared_attn"] = _block_params(draws, ("shared_attn",),
                                                  cfg, dt)
    elif cfg.arch_type == "vlm":    # cross blocks after every k-th layer
        params["layers"] = _stack(cfg.num_layers, lambda i: _block_params(
            draws, ("layer", i), cfg, dt))
        params["cross_layers"] = _stack(
            cfg.num_layers // cfg.cross_attn_every,
            lambda i: _cross_block_params(draws, ("cross", i), cfg, dt))
    elif cfg.arch_type == "audio":  # encoder; decoder with a cross block each
        params["enc_layers"] = _stack(
            cfg.num_encoder_layers, lambda i: _block_params(
                draws, ("enc", i), cfg, dt))
        params["enc_norm"] = _zeros(dev, (cfg.d_model,), dt)
        params["layers"] = _stack(cfg.num_layers, lambda i: _block_params(
            draws, ("layer", i), cfg, dt))
        params["cross_layers"] = _stack(
            cfg.num_layers, lambda i: _cross_block_params(
                draws, ("cross", i), cfg, dt))
    elif cfg.global_every:      # gemma3-style local/global groups
        n_groups = cfg.num_layers // cfg.global_every
        n_local = cfg.global_every - 1
        params["local_layers"] = _stack(n_groups, lambda g: _stack(
            n_local, lambda j: _block_params(draws, ("local", g, j), cfg,
                                             dt)))
        params["global_layers"] = _stack(n_groups, lambda g: _block_params(
            draws, ("global", g), cfg, dt))
    else:                       # homogeneous dense / moe stack
        params["layers"] = _stack(cfg.num_layers, lambda i: _block_params(
            draws, ("layer", i), cfg, dt))
    return params
