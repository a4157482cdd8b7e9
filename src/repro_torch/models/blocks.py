"""Block application (port of ``repro.models.blocks``): the pre-norm
transformer block (GQA or MLA attention; a dense MLP or the routed
experts) and the pre-norm Mamba block, each as a prefill and a decode
step, and the gated cross-attention block of the VLM and the
encoder-decoder (fresh K/V in the forward, precomputed K/V in decode).
On DTensors each residual add is pinned to the stream's layout
(:func:`sharding.residual`)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import ArchConfig, mlp_apply, rms_norm
from repro_torch.models.moe import moe_ffn
from repro_torch.models.sharding import residual
from repro_torch.models.ssm import mamba_mixer_decode, mamba_mixer_prefill


def _ffn(p: Dict, x: torch.Tensor, cfg: ArchConfig,
         dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's feed-forward and its float32 auxiliary loss: the
    routed experts where the config has them (``dropless`` on the decode
    path), else the dense MLP, whose loss is zero."""
    if cfg.num_experts:
        return moe_ffn(p, x, cfg, dropless=dropless)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return mlp_apply(p, x, cfg.mlp_type), aux


def block_prefill(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ArchConfig, window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        x = x + attn.mla_prefill(p["attn"], h, positions, cfg)
    else:
        x = x + attn.gqa_prefill(p["attn"], h, positions, cfg,
                                 window=window)
    x = residual(x)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = _ffn(p["ffn"], h, cfg)
    return residual(x + y), aux


def block_decode(p: Dict, x: torch.Tensor, t: int, cache: Dict,
                 cfg: ArchConfig, window: int = 0, ring: bool = False
                 ) -> Tuple[torch.Tensor, Dict]:
    """One token through the block; ``cache`` ({"k", "v"}: (B,T,G,hd), or
    MLA's {"ckv", "krope"}) is written in place and returned.  The routed
    experts run dropless."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, cache = attn.mla_decode(p["attn"], h, t, cache, cfg)
    else:
        a, cache = attn.gqa_decode(p["attn"], h, t, cache, cfg,
                                   window=window, ring=ring)
    x = residual(x + a)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, _ = _ffn(p["ffn"], h, cfg, dropless=True)
    return residual(x + y), cache


def cross_block(p: Dict, x: torch.Tensor,
                image_states: Optional[torch.Tensor], cfg: ArchConfig,
                kv: Optional[Dict] = None) -> torch.Tensor:
    """Gated cross-attention block (llama-3.2-vision style): attention to
    ``image_states`` (B,T,d) (the forward: fresh K/V) or to ``kv`` (decode:
    K/V made once), then the MLP, each added through ``tanh`` of its gate
    (both gates start at zero, so a fresh block adds nothing)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kv is not None:
        a = attn.cross_attn_cached(p["attn"], h, kv, cfg)
    else:
        a = attn.cross_attn(p["attn"], h, image_states, cfg)
    x = residual(x + torch.tanh(p["attn_gate"]) * a)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y = mlp_apply(p["ffn"], h, cfg.mlp_type)
    return residual(x + torch.tanh(p["mlp_gate"]) * y)


def mamba_block_prefill(p: Dict, x: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return residual(x + mamba_mixer_prefill(p, h, cfg))


def mamba_block_decode(p: Dict, x: torch.Tensor, cache: Dict,
                       cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y, cache = mamba_mixer_decode(p, h, cache, cfg)
    return residual(x + y), cache
