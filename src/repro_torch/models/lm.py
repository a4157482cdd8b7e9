"""Language-model assembly (port of ``repro.models.lm``, the ``ssm``
family's training forward and loss).

    forward(cfg, params, tokens) -> (logits (B,S,V_padded), aux)
    loss_fn(cfg, params, batch) -> (scalar, metrics)

The reference scans the stacked layers under ``jax.checkpoint``; the port
loops over them and keeps every activation for the backward pass (no
rematerialisation, so no ``remat`` argument: it would change memory, not
the numbers).  Each stacked leaf is ``unbind``-ed once, so its gradient is
assembled by one stack rather than one full-size scatter per layer.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import mamba_block_prefill
from repro_torch.models.common import ArchConfig, rms_norm


def _embed(cfg: ArchConfig, params: Dict, tokens: torch.Tensor
           ) -> torch.Tensor:
    return params["embed"][tokens]


def _logits(cfg: ArchConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].t()
    return x @ params["lm_head"]


def forward(cfg: ArchConfig, params: Dict, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V_padded), aux_loss scalar)."""
    if cfg.arch_type != "ssm":
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported to repro_torch yet")
    x = _embed(cfg, params, tokens)
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    for i in range(cfg.num_layers):
        x = mamba_block_prefill({k: v[i] for k, v in per_layer.items()}, x,
                                cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
