"""Dispatch of the port's kernels (port of ``repro.kernels.ops``).

A CPU tensor takes the plain torch version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor launches the hand-written kernel
(:mod:`repro_torch.kernels.dasha_update`, :mod:`repro_torch.kernels.
ssd_chunk`, :mod:`repro_torch.kernels.slab_writeback`) or raises.  No lane
padding: the DASHA kernels walk the flat storage with a 1-D grid.
:func:`ssd_chunk_scan` is the SSD forward that ``models.ssm`` calls with
``use_ssd_kernel``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import dasha_update as cuda_kernels
from repro_torch.kernels import ref
from repro_torch.kernels import slab_writeback as slab_kernel
from repro_torch.kernels import ssd_chunk as ssd_kernel


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


def slab_writeback(full: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                   *, accumulate: bool = False) -> torch.Tensor:
    """Write a chunk slab back into the persistent (n, d) store, in place,
    and return the store.  ``idx`` (U,) int32: sorted unique global row
    ids padded with the sentinel ``n`` (dropped); ``rows`` (U, d): the
    slab.  Unlike the reference's wrapper, which is jitted without
    donation and returns a new array, this writes into ``full``: callers
    pass a store they own."""
    if _on_cpu("slab_writeback", full):
        return ref.slab_writeback_ref(full, idx, rows, accumulate=accumulate)
    return slab_kernel.slab_writeback(full, idx, rows, accumulate=accumulate)


def chunk_layout(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int):
    """The model's (x (B,S,H,P), dt (B,S,H), A (H,), b/c (B,S,N)) in the
    reference kernel's layout: x (G,nc,Q,P), dt (G,nc,Q), A (G,), b/c
    (G,nc,Q,N) with G = B * H (b and c copied once per head, as the
    reference's wrapper broadcasts them)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    G, nc = B * H, S // chunk
    xg = x.permute(0, 2, 1, 3).reshape(G, nc, chunk, P)
    dtg = dt.permute(0, 2, 1).reshape(G, nc, chunk)
    Ag = A[None].expand(B, H).reshape(G)

    def per_head(m):
        return m[:, None].expand(B, H, S, N).reshape(G, nc, chunk, N)

    return xg, dtg, Ag, per_head(b), per_head(c)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """The SSD intra-chunk pass over the model's tensors (x (B,S,H,P), dt
    (B,S,H), A (H,), b/c (B,S,N)); returns float32 (y_diag (G,nc,Q,P),
    states (G,nc,N,P), decays (G,nc), acs (G,nc,Q)) in the reference
    kernel's layout."""
    if _on_cpu("ssd_chunk", x):
        return ref.ssd_chunk_ref(*chunk_layout(x, dt, A, b, c, chunk))
    return ssd_kernel.ssd_chunk(x, dt, A, b, c, chunk)


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, D: torch.Tensor,
                   chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel SSD forward (drop-in for ``models.ssm.ssd_chunked`` without
    an initial state; port of the reference's ``ops.ssd_chunk_scan``).

    x: (B,S,H,P), dt: (B,S,H), A: (H,), b/c: (B,S,N), D: (H,); S a
    multiple of ``chunk``.  The intra-chunk blocks run in :func:`ssd_chunk`;
    the inter-chunk recurrence is a loop over chunks; the off-diagonal
    ``exp(acs) * (c @ prev_state)`` is one batched matmul per (batch,
    chunk) with every head's state side by side, so c is never copied per
    head.  Returns (y (B,S,H,P) in x's dtype, final_state (B,H,N,P)
    float32)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    nc = S // chunk
    G = B * H
    y_diag, states, decays, acs = ssd_chunk(x, dt, A, b, c, chunk)

    # each intermediate is dropped as soon as it is used: at the serving
    # prefill shape y_diag is 1.6 GB and the states 0.8 GB a layer
    s = torch.zeros((G, N, P), dtype=torch.float32, device=x.device)
    prev = torch.empty_like(states)                      # (G,nc,N,P)
    for j in range(nc):
        prev[:, j] = s
        s = s * decays[:, j, None, None] + states[:, j]
    del states

    # y_off[b,j,q,h,p] = exp(acs[b,h,j,q]) * sum_n c[b,j,q,n] prev[b,h,j,n,p]
    prev = prev.view(B, H, nc, N, P).permute(0, 2, 3, 1, 4) \
        .reshape(B, nc, N, H * P)
    cc = c.to(torch.float32).reshape(B, nc, chunk, N)
    y = (cc @ prev).view(B, nc, chunk, H, P)
    del prev, cc
    y.mul_(torch.exp(acs).view(B, H, nc, chunk).permute(0, 2, 3, 1)[..., None])
    y.add_(y_diag.view(B, H, nc, chunk, P).permute(0, 2, 3, 1, 4))
    del y_diag
    y = y.view(B, S, H, P)
    y.add_(x.to(torch.float32) * D[None, None, :, None])
    return y.to(x.dtype), s.view(B, H, N, P)
