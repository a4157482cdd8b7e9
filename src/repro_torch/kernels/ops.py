"""Dispatch of the DASHA round's kernels (port of ``repro.kernels.ops``).

A CPU tensor takes the plain torch version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor launches the hand-written kernel
(:mod:`repro_torch.kernels.dasha_update`) or raises.  No lane padding: the
kernels walk the flat storage with a 1-D grid.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import dasha_update as cuda_kernels
from repro_torch.kernels import ref


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def dasha_update(grad: torch.Tensor, h: torch.Tensor, g_local: torch.Tensor,
                 mask: torch.Tensor, a: float, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused DASHA update; returns (m, h_new, g_local_new)."""
    if _on_cpu("dasha_update", grad):
        return ref.dasha_update_ref(grad, h, g_local, mask, a, scale)
    return cuda_kernels.dasha_update(grad, h, g_local, mask, a, scale)


def dasha_mvr_update(grad_new: torch.Tensor, grad_old: torch.Tensor,
                     h: torch.Tensor, g_local: torch.Tensor,
                     mask: torch.Tensor, a: float, b: float, scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused DASHA-MVR update; returns (m, h_new, g_local_new)."""
    if _on_cpu("dasha_mvr_update", grad_new):
        return ref.dasha_mvr_update_ref(grad_new, grad_old, h, g_local, mask,
                                        a, b, scale)
    return cuda_kernels.dasha_mvr_update(grad_new, grad_old, h, g_local,
                                         mask, a, b, scale)


def quantize_with_u(x: torch.Tensor, u: torch.Tensor,
                    levels: int = 15) -> torch.Tensor:
    """Row-wise quantization with external uniforms (the plan layer draws
    them once so the dense and fused backends dither identically)."""
    if _on_cpu("quantize_with_u", x):
        return ref.quantize_ref(x, u, levels)
    return cuda_kernels.quantize(x, u, levels)


def quantize(x: torch.Tensor, generator: torch.Generator,
             levels: int = 15) -> torch.Tensor:
    """Unbiased row-wise stochastic quantization of x: (R, C), drawing the
    uniforms from ``generator`` (on x's device)."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return quantize_with_u(x, u, levels)
