"""Language-model assembly (port of ``repro.models.lm``, the ``ssm``
family and the homogeneous dense GQA stack): the training / prefill
forward and loss, and the serving cache and decode step.

    forward(cfg, params, tokens, last_only=False) -> (logits, aux)
    loss_fn(cfg, params, batch) -> (scalar, metrics)
    init_cache(cfg, batch, seq, device=...) -> cache (decode)
    decode_step(cfg, params, cache, token, t) -> (logits (B,V), cache)

The reference scans the stacked layers under ``jax.checkpoint``; the port
loops over them and keeps every activation for the backward pass (no
rematerialisation, so no ``remat`` argument: it would change memory, not
the numbers).  Each stacked leaf is ``unbind``-ed once, so its gradient is
assembled by one stack rather than one full-size scatter per layer.  The
decode step updates the stacked cache in place, layer by layer: the SSM
family's conv window and state, or the dense family's KV cache (ring
buffers of the sliding window where the config has one).  Every other
family raises NotImplementedError, naming it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.blocks import (block_decode, block_prefill,
                                       mamba_block_decode,
                                       mamba_block_prefill)
from repro_torch.models.common import ArchConfig, rms_norm
from repro_torch.models.init import require_ported


def _embed(cfg: ArchConfig, params: Dict, tokens: torch.Tensor
           ) -> torch.Tensor:
    return params["embed"][tokens]


def _logits(cfg: ArchConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].t()
    return x @ params["lm_head"]


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None].expand(B, S)


def _per_layer(tree: Dict, n: int):
    """The stacked leaves of ``tree`` (nested dicts allowed) as one tree
    per layer (one ``unbind`` per leaf)."""
    per = {k: _per_layer(v, n) if isinstance(v, dict) else v.unbind(0)
           for k, v in tree.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def forward(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V_padded), aux_loss scalar).  ``last_only``
    slices the hidden states to the final position BEFORE the vocab
    projection (serving prefill: no (B,S,V) logits)."""
    require_ported(cfg)
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _per_layer(params["layers"], cfg.num_layers)
    if cfg.arch_type == "ssm":
        for lp in layers:
            x = mamba_block_prefill(lp, x, cfg)
    else:                       # the homogeneous dense stack (uniform window)
        pos = _positions(B, S, x.device)
        for lp in layers:
            x, a = block_prefill(lp, x, pos, cfg,
                                 window=cfg.sliding_window)
            aux = aux + a
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x), aux


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(cfg, params, batch["tokens"])
    labels = batch["labels"]
    logp = F.log_softmax(logits.to(torch.float32), -1)
    # out-of-range labels are masked below; clamp them for the gather as
    # the reference's take_along_axis does
    idx = labels.clamp(0, logp.shape[-1] - 1).to(torch.int64)
    nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
    mask = (labels >= 0) & (labels < cfg.vocab_size)
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux}


def _ssm_cache(cfg: ArchConfig, B: int, dev: torch.device) -> Dict:
    H, P, N, W = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.conv_width
    cd = H * P + 2 * N
    L = cfg.num_layers
    return {"conv": torch.zeros((L, B, W - 1, cd), dtype=cfg.torch_dtype,
                                device=dev),
            "ssm": torch.zeros((L, B, H, N, P), dtype=torch.float32,
                               device=dev)}


def init_cache(cfg: ArchConfig, batch: int, seq: int, *,
               device=DEFAULT_DEVICE) -> Dict:
    """The decode cache for ``seq`` total positions on ``device``: for the
    ``ssm`` family a conv window (L,B,W-1,Cd) in the model dtype and a
    float32 state (L,B,H,N,P), neither of which grows with ``seq``; for the
    dense family K and V of (L,B,T,G,hd) in the model dtype, T = ``seq``,
    or ring buffers of T = min(sliding_window, seq) slots."""
    require_ported(cfg)
    dev = resolve_device(device)
    if cfg.arch_type == "ssm":
        return _ssm_cache(cfg, batch, dev)
    T = min(cfg.sliding_window, seq) if cfg.sliding_window else seq
    shape = (cfg.num_layers, batch, T, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}


def decode_step(cfg: ArchConfig, params: Dict, cache: Dict,
                token: torch.Tensor, t) -> Tuple[torch.Tensor, Dict]:
    """token: (B,) int; t: the absolute position, a Python int (an SSM
    does not read it).  Returns (logits (B, V_padded), cache); the cache's
    tensors are updated in place and returned."""
    require_ported(cfg)
    x = _embed(cfg, params, token[:, None])
    caches = _per_layer(cache, cfg.num_layers)
    layers = _per_layer(params["layers"], cfg.num_layers)
    if cfg.arch_type == "ssm":
        for lp, lc in zip(layers, caches):
            x, _ = mamba_block_decode(lp, x, lc, cfg)
    else:
        ring = bool(cfg.sliding_window)
        for lp, lc in zip(layers, caches):
            x, _ = block_decode(lp, x, t, lc, cfg,
                                window=cfg.sliding_window, ring=ring)
    return _logits(cfg, params, x)[:, 0], cache
