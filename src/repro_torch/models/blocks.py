"""Block application (port of ``repro.models.blocks``): the pre-norm Mamba
block's prefill.  Transformer, cross-attention and decode blocks come with
the slices that port those paths."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import ArchConfig, rms_norm
from repro_torch.models.ssm import mamba_mixer_prefill


def mamba_block_prefill(p: Dict, x: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + mamba_mixer_prefill(p, h, cfg)
