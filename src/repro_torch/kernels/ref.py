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


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Mamba2 SSD intra-chunk block (the body of the reference's
    ``_ssd_chunk_kernel``), batched over (G, nc) = (batch * heads, chunks):

        acs    = cumsum(dt * A)                         inclusive
        L      = tril(exp(acs_q - acs_k))
        y_diag = (L * (c b^T)) (x * dt)
        state  = b^T (exp(acs_end - acs) * x * dt)
        decay  = exp(acs_end)

    ``x``: (G, nc, Q, P), ``dt``: (G, nc, Q), ``A``: (G,), ``b``/``c``:
    (G, nc, Q, N), any float type; each is read as float32 before any
    product, as the Pallas body does.  Returns float32 ``(y_diag (G,nc,Q,P),
    states (G,nc,N,P), decays (G,nc), acs (G,nc,Q))``."""
    f32 = torch.float32
    x, dt, b, c = (t.to(f32) for t in (x, dt, b, c))
    xdt = x * dt[..., None]
    acs = torch.cumsum(dt * A.to(f32)[:, None, None], -1)
    q = acs.shape[-1]
    above = torch.triu(torch.ones((q, q), dtype=torch.bool,
                                  device=x.device), 1)
    # mask before exp: above the diagonal acs_q - acs_k > 0 can overflow,
    # and inf * 0 is NaN; exp(-inf) is the 0 of the reference's select.
    # In place: at the serving shape each (G, nc, Q, Q) tensor is 6.4 GB.
    L = (acs[..., :, None] - acs[..., None, :]).masked_fill_(
        above, float("-inf")).exp_()
    y_diag = L.mul_(c @ b.transpose(-1, -2)) @ xdt
    del L
    decay_end = torch.exp(acs[..., -1:] - acs)
    states = b.transpose(-1, -2) @ (decay_end[..., None] * xdt)
    return y_diag, states, torch.exp(acs[..., -1]), acs


def slab_writeback_ref(full: torch.Tensor, idx: torch.Tensor,
                       rows: torch.Tensor, *,
                       accumulate: bool = False) -> torch.Tensor:
    """The federated slab store's per-chunk writeback (the reference's
    ``full.at[idx].set/add(rows, mode="drop")``), in place:

        full[idx[j]]  = rows[j]     (or += with ``accumulate``)

    for every j with ``idx[j]`` in [0, n); the pad sentinel ``n`` is
    dropped.  ``idx`` holds unique row ids, so each store row receives
    one copy, or one float32 add.  Returns ``full``."""
    n = full.shape[0]
    keep = (idx >= 0) & (idx < n)
    at = idx[keep].to(torch.int64)
    if accumulate:
        full[at] += rows[keep]
    else:
        full[at] = rows[keep]
    return full
