"""Block application (port of ``repro.models.blocks``): the pre-norm Mamba
block's prefill and decode step.  Transformer and cross-attention blocks
come with the slices that port those families."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.common import ArchConfig, rms_norm
from repro_torch.models.ssm import mamba_mixer_decode, mamba_mixer_prefill


def mamba_block_prefill(p: Dict, x: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + mamba_mixer_prefill(p, h, cfg)


def mamba_block_decode(p: Dict, x: torch.Tensor, cache: Dict,
                       cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y, cache = mamba_mixer_decode(p, h, cache, cfg)
    return x + y, cache
