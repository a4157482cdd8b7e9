"""Plain torch versions of the port's kernels (ports of
``repro.kernels.ref``).

These are the semantics contracts: the CPU path runs them, and the card
tests hold each CUDA kernel against them.  The operation order is the
reference's, one rounding per torch op.
"""
from __future__ import annotations

from typing import Tuple

import torch


def dasha_update_ref(grad: torch.Tensor, h: torch.Tensor,
                     g_local: torch.Tensor, mask: torch.Tensor, a: float,
                     scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused DASHA node update (Alg. 1 lines 8-10, GD-like h), elementwise:

        h_new = grad
        delta = h_new - h - a * (g_local - h)
        m     = mask * delta * scale
        g_new = g_local + m

    Returns (m, h_new, g_new)."""
    h_new = grad
    delta = h_new - h - a * (g_local - h)
    m = mask * delta * scale
    return m, h_new, g_local + m


def dasha_mvr_update_ref(grad_new: torch.Tensor, grad_old: torch.Tensor,
                         h: torch.Tensor, g_local: torch.Tensor,
                         mask: torch.Tensor, a: float, b: float, scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused DASHA-MVR node update (Alg. 1 line 8 MVR + lines 9-10):

        h_new = grad_new + (1-b) * (h - grad_old)
        delta = h_new - h - a * (g_local - h)
        m     = mask * delta * scale
        g_new = g_local + m

    Returns (m, h_new, g_new)."""
    h_new = grad_new + (1.0 - b) * (h - grad_old)
    delta = h_new - h - a * (g_local - h)
    m = mask * delta * scale
    return m, h_new, g_local + m


def quantize_ref(x: torch.Tensor, u: torch.Tensor,
                 levels: int) -> torch.Tensor:
    """Per-row unbiased stochastic quantization (QSGD, s = levels):

        y = |x| / ||x||_2 * s;  q = floor(y) + [u < y - floor(y)]
        out = sign(x) * q * ||x||_2 / s

    ``x``, ``u``: (R, C); zero rows give zeros."""
    xf = x.to(torch.float32)
    norm = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    y = xf.abs() / safe * levels
    lo = torch.floor(y)
    q = lo + (u < (y - lo)).to(torch.float32)
    out = torch.sign(xf) * q * safe / levels
    return torch.where(norm > 0, out, torch.zeros_like(out)).to(x.dtype)
