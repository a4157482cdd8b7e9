"""Python wrappers of the DASHA round's CUDA kernels
(``csrc/dasha_update.cu``, built by :mod:`repro_torch.kernels.build`).

``dasha_update`` replaces ``repro/kernels/dasha_update.py:
dasha_update_pallas`` (body ``_dasha_update_kernel``): Alg. 1 lines 8-10
as one elementwise pass over n*d fp32 elements, four reads (grad, h,
g_local, mask) and three writes (m, h_new, g_new).  It does 6 flops per
element, far under the card's rate, so device-memory bytes bound it:
28 bytes an element, 1.564 GB at the ResNet-18 width (n = 5,
d = 11,173,962), 0.467 ms at 3.35 TB/s.  Its design streams them once: a
grid-stride loop over the flat storage (no (R, 128) lane padding), enough
256-thread blocks to fill every SM, 16-byte ``float4`` loads and stores
when every pointer is 16-byte aligned, and a scalar tail.  Each op is
rounded on its own (``__fsub_rn``/``__fmul_rn``/``__fadd_rn``) so the
kernel matches the plain version bit for bit.  ``h_new`` is written as a
copy of ``grad`` so the returned values match the reference's.

``dasha_mvr_update`` replaces ``repro/kernels/dasha_update.py:
dasha_mvr_update_pallas`` (body ``_dasha_mvr_update_kernel``): the same
pass with the MVR h-update fused in, h_new = gn + (1 - b)(h - go), five
reads (gn, go, h, g_local, mask) and three writes (m, h_new, g_new): 32
bytes an element, 9 flops.  The trainer launches it once per parameter
leaf per round; at Mamba2-780M's width with 16 layers and n = 4 that is
n*E = 1.247G elements, 39.9 GB, 11.9 ms at 3.35 TB/s.  Same design as
``dasha_update``: grid-stride float4 body when all eight pointers are
16-byte aligned, scalar tail, one rounding per op in the plain version's
order.  ``1 - b`` is formed in Python double and rounded to fp32 once, as
the plain version's scalar is, so the two agree bit for bit.

``quantize`` replaces ``repro/kernels/dasha_update.py:quantize_pallas``
(body ``_quantize_kernel``): row-wise QSGD of an (n, d) message matrix with
external uniforms.  Bytes bound it too: read x and u, write out, 12 bytes an
element (0.670 GB, 0.200 ms at the ResNet-18 width; 0.267 ms counting the
second read of x).  On the TPU a whole row sat in one block; a row here can
be 11.2M wide, so the kernel runs two passes: (i) per-(row, chunk) partial
sums of squares into an (n, ceil(d/8192)) scratch, (ii) an elementwise
pass in which every block first sums its row's partials in a fixed order
(no atomics, so repeated runs give the same bits) and then quantizes its
chunk.  One call is two kernel launches; its counter counts calls.  The
norm is summed in another order than ``torch.sum``, so it can differ from
the plain version's in the last ulp: every output then differs by a few
ulp, and an element whose uniform lies within ~1e-6 of ``y - floor(y)``
can land one level (``norm / s``) away (see :func:`quantize_agreement`).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates its outputs with ``torch.empty``, launches on the
current stream and raises when the launch reports an error.  There is no
fallback to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

#: launches of each kernel's wrapper since the last :func:`reset_counts`
COUNTS: Dict[str, int] = {"dasha_update": 0, "dasha_mvr_update": 0,
                          "quantize": 0}

_P = ctypes.c_void_p
_F = ctypes.c_float
_LL = ctypes.c_longlong


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("dasha_update")
    if not getattr(lib, "_typed", False):
        lib.dasha_update.argtypes = [_P, _P, _P, _P, _P, _P, _P, _F, _F,
                                     _LL, _P]
        lib.dasha_update.restype = ctypes.c_int
        lib.dasha_mvr_update.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _F,
                                         _F, _F, _LL, _P]
        lib.dasha_mvr_update.restype = ctypes.c_int
        lib.quantize_rows.argtypes = [_P, _P, _P, _P, _LL, _LL, _F, _P]
        lib.quantize_rows.restype = ctypes.c_int
        lib.quantize_chunk_elems.argtypes = []
        lib.quantize_chunk_elems.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(name: str, ref: torch.Tensor, *tensors: torch.Tensor) -> None:
    for t in (ref, *tensors):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != ref.device:
            raise ValueError(f"{name}: tensors on {ref.device} and "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.shape != ref.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def dasha_update(grad: torch.Tensor, h: torch.Tensor, g_local: torch.Tensor,
                 mask: torch.Tensor, a: float, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused update on the card: returns (m, h_new, g_new), each shaped
    like ``grad``.  ``a`` and ``scale`` are passed as fp32."""
    _check("dasha_update", grad, h, g_local, mask)
    m = torch.empty_like(grad)
    h_new = torch.empty_like(grad)
    g_new = torch.empty_like(grad)
    with torch.cuda.device(grad.device):
        lib = _lib()
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = lib.dasha_update(grad.data_ptr(), h.data_ptr(),
                               g_local.data_ptr(), mask.data_ptr(),
                               m.data_ptr(), h_new.data_ptr(),
                               g_new.data_ptr(), float(a), float(scale),
                               grad.numel(), stream)
    COUNTS["dasha_update"] += 1
    _raise_on("dasha_update", err)
    return m, h_new, g_new


def dasha_mvr_update(grad_new: torch.Tensor, grad_old: torch.Tensor,
                     h: torch.Tensor, g_local: torch.Tensor,
                     mask: torch.Tensor, a: float, b: float, scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused MVR update on the card: returns (m, h_new, g_new), each
    shaped like ``grad_new``.  ``a``, ``1 - b`` and ``scale`` are passed
    as fp32."""
    _check("dasha_mvr_update", grad_new, grad_old, h, g_local, mask)
    m = torch.empty_like(grad_new)
    h_new = torch.empty_like(grad_new)
    g_new = torch.empty_like(grad_new)
    with torch.cuda.device(grad_new.device):
        lib = _lib()
        stream = torch.cuda.current_stream(grad_new.device).cuda_stream
        err = lib.dasha_mvr_update(
            grad_new.data_ptr(), grad_old.data_ptr(), h.data_ptr(),
            g_local.data_ptr(), mask.data_ptr(), m.data_ptr(),
            h_new.data_ptr(), g_new.data_ptr(), float(a), 1.0 - float(b),
            float(scale), grad_new.numel(), stream)
    COUNTS["dasha_mvr_update"] += 1
    _raise_on("dasha_mvr_update", err)
    return m, h_new, g_new


def quantize(x: torch.Tensor, u: torch.Tensor, levels: int) -> torch.Tensor:
    """Row-wise QSGD of the 2-D ``x`` with uniforms ``u`` on the card."""
    _check("quantize", x, u)
    if x.dim() != 2:
        raise ValueError(f"quantize: expected (rows, cols), got "
                         f"{tuple(x.shape)}")
    rows, cols = x.shape
    if rows > 65535:
        raise ValueError(f"quantize: at most 65535 rows, got {rows}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        lib = _lib()
        chunk = lib.quantize_chunk_elems()
        partials = torch.empty((rows, max(-(-cols // chunk), 1)),
                               dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_rows(x.data_ptr(), u.data_ptr(), out.data_ptr(),
                                partials.data_ptr(), rows, cols,
                                float(levels), stream)
    COUNTS["quantize"] += 1
    _raise_on("quantize", err)
    return out


#: the one-level rule's tolerances: a few fp32 ulp relative, and how near
#: ``y - floor(y)`` a uniform must lie for a one-level difference
QUANTIZE_ULP_RTOL = 4e-7
QUANTIZE_BOUNDARY = 1e-5


def quantize_agreement(out: torch.Tensor, plain: torch.Tensor,
                       x: torch.Tensor, u: torch.Tensor,
                       levels: int) -> Dict[str, float]:
    """Hold a quantized output against the plain version by the one-level
    rule: every element agrees to a few ulp (:data:`QUANTIZE_ULP_RTOL`
    relative; the two norms may differ in the last ulp), except elements
    one level (``norm / s``) away, which are allowed only where the uniform
    lies within :data:`QUANTIZE_BOUNDARY` of ``y - floor(y)``.

    Returns ``max_abs_err`` over the agreeing elements, the count of
    one-level ``flips`` and ``ok``."""
    xf = x.to(torch.float32)
    norm = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    level = (norm / levels).expand_as(xf)
    err = (out - plain).abs()
    flip = err > 0.5 * level
    close = err <= QUANTIZE_ULP_RTOL * plain.abs()
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    y = xf.abs() / safe * levels
    frac = y - torch.floor(y)
    flip_ok = ((err - level).abs() <= 1e-5 * level) & \
        ((u - frac).abs() < QUANTIZE_BOUNDARY)
    ok = bool(torch.all(torch.where(flip, flip_ok, close)))
    agree = torch.where(flip, torch.zeros_like(err), err)
    return {"max_abs_err": float(agree.max()) if agree.numel() else 0.0,
            "flips": int(flip.sum()), "ok": ok}
