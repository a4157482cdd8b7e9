"""Block application (port of ``repro.models.blocks``): the pre-norm
transformer block of the dense family and the pre-norm Mamba block, each
as a prefill and a decode step.  MoE, MLA and cross-attention blocks come
with the slices that port those families."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import ArchConfig, mlp_apply, rms_norm
from repro_torch.models.ssm import mamba_mixer_decode, mamba_mixer_prefill


def _ffn(p: Dict, x: torch.Tensor, cfg: ArchConfig
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's feed-forward and its auxiliary loss: the dense MLP,
    whose loss is zero (MoE's routed experts come with the moe family,
    which ``init_params`` and ``lm`` refuse)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return mlp_apply(p, x, cfg.mlp_type), aux


def block_prefill(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ArchConfig, window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.gqa_prefill(p["attn"], h, positions, cfg, window=window)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = _ffn(p["ffn"], h, cfg)
    return x + y, aux


def block_decode(p: Dict, x: torch.Tensor, t: int, cache: Dict,
                 cfg: ArchConfig, window: int = 0, ring: bool = False
                 ) -> Tuple[torch.Tensor, Dict]:
    """One token through the block; ``cache`` ({"k", "v"}: (B,T,G,hd)) is
    written in place and returned."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attn.gqa_decode(p["attn"], h, t, cache, cfg, window=window,
                               ring=ring)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, _ = _ffn(p["ffn"], h, cfg)
    return x + y, cache


def mamba_block_prefill(p: Dict, x: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + mamba_mixer_prefill(p, h, cfg)


def mamba_block_decode(p: Dict, x: torch.Tensor, cache: Dict,
                       cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y, cache = mamba_mixer_decode(p, h, cache, cfg)
    return x + y, cache
