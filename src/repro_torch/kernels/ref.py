"""Plain torch versions of the port's kernels (ports of
``repro.kernels.ref``).

These are the semantics contracts: the CPU path runs them, and the card
tests hold each CUDA kernel against them.  The operation order is the
reference's, one rounding per torch op.

A sweep's G lanes may give ``a`` (and kernel 3's ``c = 1 - b``) one value
a lane: a (G,) fp32 tensor, G dividing the rows of the last axis, row r
taking lane ``r // (rows // G)``'s value (:func:`per_row`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def per_row(v, t: torch.Tensor):
    """A scalar argument against ``t``'s rows (its last axis the row): a
    number as it is, or (G,) lane values as a tensor of ``t``'s leading
    shape and a trailing 1, row r holding value ``r // (rows // G)``."""
    if not isinstance(v, torch.Tensor):
        return v
    cols = t.shape[-1]
    rows = t.numel() // cols if cols else 0
    g = v.numel()
    if v.dim() != 1 or g < 1 or rows % g:
        raise ValueError(f"{g} lane values do not divide {rows} rows")
    return v.repeat_interleave(rows // g).reshape(t.shape[:-1] + (1,))


def dasha_update_ref(grad: torch.Tensor, h: torch.Tensor,
                     g_local: torch.Tensor, mask: torch.Tensor, a: float,
                     scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused DASHA node update (Alg. 1 lines 8-10, GD-like h), elementwise:

        h_new = grad
        delta = h_new - h - a * (g_local - h)
        m     = mask * delta * scale
        g_new = g_local + m

    Returns (m, h_new, g_new).  A bool or uint8 mask is read as float32,
    as the dense path converts it.  ``a``: a float or (G,) lane values
    (:func:`per_row`)."""
    h_new = grad
    delta = h_new - h - per_row(a, grad) * (g_local - h)
    m = _as_float(mask) * delta * scale
    return m, h_new, g_local + m


def dasha_mvr_update_ref(grad_new: torch.Tensor, grad_old: torch.Tensor,
                         h: torch.Tensor, g_local: torch.Tensor,
                         mask: torch.Tensor, a: float, b: float, scale: float,
                         *, c=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused DASHA-MVR node update (Alg. 1 line 8 MVR + lines 9-10):

        h_new = grad_new + (1-b) * (h - grad_old)
        delta = h_new - h - a * (g_local - h)
        m     = mask * delta * scale
        g_new = g_local + m

    ``mask`` float32, bool or uint8 (read as float32), of the leaf's
    shape, or with k rows dividing its n, row r read at r % k as the
    kernel reads it ((1, ...) for every node, (n, ...) for G * n lane
    rows).  ``a``: a float or (G,) fp32 lane values of the leaf's leading
    rows (:func:`per_row`); ``c``: the lanes' (G,) fp32 ``1 - b``, which
    replaces ``b``.  Returns (m, h_new, g_new)."""
    c = 1.0 - b if c is None else c
    h_new = grad_new + _per_leading_row(c, grad_new) * (h - grad_old)
    delta = h_new - h - _per_leading_row(a, grad_new) * (g_local - h)
    mask = _as_float(mask)
    if mask.shape != delta.shape and mask.shape[0] != 1:
        mask = _rows_of(mask.reshape(mask.shape[0], -1),
                        delta.shape[0]).view(delta.shape)
    m = mask * delta * scale
    return m, h_new, g_local + m


def _per_leading_row(v, t: torch.Tensor):
    """:func:`per_row` over a leaf's leading axis (a leaf (n, ...) is n
    rows, a 1-D one a row), shaped to broadcast against the leaf."""
    rows = t.reshape(t.shape[0], -1) if t.dim() >= 2 else t
    r = per_row(v, rows)
    if isinstance(r, torch.Tensor):
        return r.reshape((-1,) + (1,) * (t.dim() - 1))
    return r


def _as_float(mask: torch.Tensor) -> torch.Tensor:
    return mask if mask.is_floating_point() else mask.to(torch.float32)


def _rows_of(t: torch.Tensor, rows: int) -> torch.Tensor:
    """(k, w) -> (rows, w): row r is t's row r % k."""
    k, w = t.shape
    return t.expand(rows // k, k, w).reshape(rows, w)


def dasha_sparsify_update_ref(grad: torch.Tensor, h: torch.Tensor,
                              g_local: torch.Tensor, a: float, scale, *,
                              indices: Optional[torch.Tensor] = None,
                              mask: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The fused backend's sparsifier estimator update as the chain the
    card's one launch replaces (the reference's ``fused_estimator_update``
    around ``dasha_update_pallas``), on rows of grad's last axis:

        support = indices -> 0/1 rows (PAD and indices >= cols dropped)
                  | mask as float32 | ones (passthrough);  row r is
                  support row r % s_rows
        mask    = support * scale row r % sc_rows, kernel scale 1
                  (a per-row scale), else support and the float scale
        (m, _, g_new) = dasha_update_ref(grad, h, g_local, mask, a, scale)

    ``indices`` (s_rows, k) int64; ``mask`` (s_rows, cols); ``scale`` a
    float or a (sc_rows,) / (sc_rows, 1) tensor; ``a`` a float or (G,)
    lane values (:func:`per_row`).  Returns (m, grad, g_new)."""
    cols = grad.shape[-1]
    rows = grad.numel() // cols if cols else 0
    if indices is not None:
        wide = torch.zeros((indices.shape[0], cols + 1), dtype=torch.float32,
                           device=grad.device)
        wide.scatter_(1, indices.clamp(max=cols), 1.0)
        support = wide[:, :cols]
    elif mask is not None:
        support = _as_float(mask).reshape(-1, cols)
    else:
        support = torch.ones((1, cols), dtype=torch.float32,
                             device=grad.device)
    full = _rows_of(support, rows)
    kscale = scale
    if isinstance(scale, torch.Tensor):
        full = full * _rows_of(scale.to(torch.float32).reshape(-1, 1), rows)
        kscale = 1.0
    m, _, g_new = dasha_update_ref(grad, h, g_local, full.view(grad.shape),
                                   a, kscale)
    return m, grad, g_new


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


def dasha_quantize_update_ref(h_new: torch.Tensor, h: torch.Tensor,
                              g_local: torch.Tensor, u: torch.Tensor,
                              a: float, scale, levels: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The fused backend's QDither estimator update (the reference's
    ``fused_estimator_update`` dither branch), as torch ops:

        delta = h_new - h - a * (g_local - h)
        m     = quantize(delta, u) * scale      (row-wise, s = levels)
        g_new = g_local + m

    ``h_new`` (..., n, d); ``u`` (n, d), broadcast over leading axes;
    ``scale`` a float or an (n, 1) tensor; ``a`` a float or (G,) lane
    values (:func:`per_row`).  Returns (m, h_new, g_new)."""
    delta = h_new - h - per_row(a, h_new) * (g_local - h)
    rows = delta.reshape(-1, delta.shape[-1])
    uu = u.expand(delta.shape).reshape(rows.shape)
    m = quantize_ref(rows, uu, levels).view(delta.shape) * scale
    return m, h_new, g_local + m


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
