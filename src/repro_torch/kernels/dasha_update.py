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
element (0.00038 ms at the flat round's (5, 20,958), 0.200 ms at the
ResNet-18 width).  At the widths the main paths run (20,958, 4,096, the
figures' 60 and 256) a row is short and there are few of them, so the
old design (per-(row, 8192-chunk) blocks, two launches) left most SMs idle.
:func:`quantize_plan` now gives each row one thread-block *cluster* of up
to 16 blocks (aiming at one block per SM where the rows allow): each block
holds its slice of the row in registers (``float4`` loads where every row
starts 16-byte aligned, ``float2`` where only 8, scalar otherwise), sums
its squares in a fixed order into its shared memory, and after a cluster
barrier reads every block's partial through distributed shared memory in
rank order, so each block gets the same norm bits; then it quantizes from
registers.  One launch, x read once.  A cluster holds up to 8 vectors a
thread: 131,072 floats a row with ``float4``, 65,536 with ``float2``,
32,768 scalar (half that on a card that schedules clusters of 8 only).
Rows wider than a cluster holds (the ResNet-18 width) keep two passes: per-(row, chunk) partial sums of
squares into an (n, chunks) scratch, then a pass in which every block sums
its row's partials in a fixed order and quantizes its chunk (16 bytes an
element, 0.267 ms there).  Rows go on ``grid.x``, so any number of rows
runs.  The norm is summed in another order than ``torch.sum``, so it can
differ from the plain version's in the last ulp: every output then
differs by a few ulp, and an element whose uniform lies within ~1e-6 of
``y - floor(y)`` can land one level (``norm / s``) away (see
:func:`quantize_agreement`).

``dasha_quantize_update`` is the ``fused`` backend's QDither estimator
update as one launch of the same kernel with a prologue and an epilogue:
delta = (h_new - h) - a (g_local - h) rounded op by op as the torch chain
rounds it, then QSGD, m = out * scale and g_new = g_local + m.  Reads
h_new, h, g_local and u, writes m and g_new: 24 bytes an element
(0.00075 ms at (5, 20,958)), where the chain it replaces took about eight
launches.  The uniforms (and a per-row scale) are read at row ``r % n``,
so a lane axis needs no copy of them.  The reference runs this chain as
jnp ops around ``quantize_pallas``; its plain version is
``ref.dasha_quantize_update_ref``.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates its outputs with ``torch.empty``, launches on the
current stream and raises when the launch reports an error.  There is no
fallback to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

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
        plan = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _LL, _LL, _P]
        lib.quantize_rows.argtypes = [_P, _P, _P, _P, _LL, _LL, _LL, _F,
                                      *plan]
        lib.quantize_rows.restype = ctypes.c_int
        lib.dasha_quantize_update.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                                              _LL, _LL, _LL, _LL, _F, _F, _F,
                                              *plan]
        lib.dasha_quantize_update.restype = ctypes.c_int
        lib.quantize_init.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.quantize_init.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_one(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: tensors on {device} and {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")


def _check(name: str, ref: torch.Tensor, *tensors: torch.Tensor) -> None:
    for t in (ref, *tensors):
        _check_one(name, t, ref.device)
        if t.shape != ref.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")


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


#: kernel 2's plan limits, as ``csrc/dasha_update.cu`` instantiates them:
#: threads a block, vectors a thread holds (a power of two), floats of one
#: operand a thread holds, and the elements of a row one two-pass block
#: covers
QUANT_THREADS = 256
QUANT_MAX_VPT = 8
QUANT_MAX_ELEMS = 32
QUANT_WIDE_CHUNK = 16384
#: the fewest vectors a cluster block is given
QUANT_MIN_PER_BLOCK = 128
GRID_LIMIT = 2 ** 31 - 1


class QuantizePlan(NamedTuple):
    """How kernel 2 covers a (rows, cols) matrix: ``two_pass`` False is the
    cluster path, one cluster of ``blocks_per_row`` blocks a row, each
    block ``per_block`` vectors of ``vec`` floats, ``vpt`` of them a
    thread; True the two passes over chunks of ``per_block`` vectors,
    ``blocks_per_row`` chunks a row."""

    two_pass: bool
    vec: int
    threads: int
    vpt: int
    per_block: int
    blocks_per_row: int
    grid: int

    @property
    def capacity(self) -> int:
        """Elements of a row the blocks of that row cover."""
        return self.blocks_per_row * self.per_block * self.vec


def _vec_width(cols: int, aligned16: bool, aligned8: bool) -> int:
    if aligned16 and cols % 4 == 0:
        return 4
    if aligned8 and cols % 2 == 0:
        return 2
    return 1


def _pow2_at_least(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def _checked(plan: QuantizePlan) -> QuantizePlan:
    if plan.grid > GRID_LIMIT:
        raise ValueError(f"quantize: {plan.grid} blocks exceed the card's "
                         f"grid limit {GRID_LIMIT}")
    return plan


def quantize_two_pass_plan(rows: int, cols: int, aligned16: bool,
                           aligned8: bool) -> QuantizePlan:
    """The two-pass plan of any shape (the path :func:`quantize_plan`
    takes for rows wider than a cluster holds)."""
    vec = _vec_width(cols, aligned16, aligned8)
    chunk = QUANT_WIDE_CHUNK // vec
    chunks = max(-(-(cols // vec) // chunk), 1)
    return _checked(QuantizePlan(True, vec, QUANT_THREADS, 0, chunk, chunks,
                                 rows * chunks))


@functools.lru_cache(maxsize=512)
def quantize_plan(rows: int, cols: int, aligned16: bool, aligned8: bool,
                  max_cluster: int = 16) -> QuantizePlan:
    """Kernel 2's plan for a (rows, cols) matrix whose pointers are all
    16-byte (``aligned16``) or 8-byte (``aligned8``) aligned, on a card
    that schedules clusters of up to ``max_cluster`` blocks.

    The widest vector the rows' alignment allows; then the largest
    cluster (up to ``max_cluster``) that leaves each block at least
    :data:`QUANT_MIN_PER_BLOCK` vectors: on the H100, more and smaller
    blocks were faster at every row count measured (5 to 128 rows of
    20,958), as each thread's loads and the block's reduction are the
    latency a short row waits on; then threads and vectors a thread so
    that the cluster's registers hold the row, growing the cluster where
    they do not.  A row wider than the largest cluster holds takes the
    two-pass plan."""
    vec = _vec_width(cols, aligned16, aligned8)
    nvec = cols // vec
    max_vpt = min(QUANT_MAX_VPT, QUANT_MAX_ELEMS // vec)
    cl = 1
    while cl < max_cluster and nvec >= 2 * cl * QUANT_MIN_PER_BLOCK:
        cl *= 2
    while True:
        per = max(-(-nvec // cl), 1)
        threads = min(QUANT_THREADS, 32 * -(-per // 32))
        vpt = _pow2_at_least(-(-per // threads))
        if vpt <= max_vpt:
            return _checked(QuantizePlan(False, vec, threads, vpt, per, cl,
                                         rows * cl))
        if cl >= max_cluster:
            return quantize_two_pass_plan(rows, cols, aligned16, aligned8)
        cl *= 2


#: per device index: the largest cluster the card schedules
_MAX_CLUSTER: Dict[int, int] = {}


def _max_cluster(device: torch.device) -> int:
    """The largest cluster kernel 2 may take on ``device``; the first call
    for a device also lets the cluster kernels take 16 blocks."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    limit = _MAX_CLUSTER.get(idx)
    if limit is None:
        with torch.cuda.device(idx):
            out = ctypes.c_int(0)
            _raise_on("quantize_init", _lib().quantize_init(
                ctypes.byref(out)))
        limit = _MAX_CLUSTER[idx] = out.value
    return limit


def _aligned(tensors, nbytes: int) -> bool:
    return all(t.data_ptr() % nbytes == 0 for t in tensors)


def _plan_for(rows: int, cols: int, tensors) -> QuantizePlan:
    return quantize_plan(rows, cols, _aligned(tensors, 16),
                         _aligned(tensors, 8), _max_cluster(tensors[0].device))


def _plan_args(plan: QuantizePlan):
    return (int(plan.two_pass), plan.vec, plan.vpt, plan.threads,
            plan.per_block, plan.blocks_per_row)


def _partials(plan: QuantizePlan, rows: int, ref: torch.Tensor):
    """The two-pass scratch, (rows, chunks) fp32; None on the cluster
    path."""
    if not plan.two_pass:
        return None
    return torch.empty((rows, plan.blocks_per_row), dtype=torch.float32,
                       device=ref.device)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_rows(name: str, x: torch.Tensor) -> Tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"{name}: expected (rows, cols), got "
                         f"{tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def _quantize_with_plan(x: torch.Tensor, u: torch.Tensor, levels: int,
                        plan: QuantizePlan) -> torch.Tensor:
    """Launch kernel 2 on ``x`` (rows, cols) by ``plan``; ``u`` has rows or
    a divisor of them (row r reads u's row r % u_rows).  Counts one call
    of ``quantize``.  The private entry forces a plan (chip_smoke times
    the two-pass plan at the main paths' shapes with it)."""
    _check("quantize", x)
    _check_one("quantize", u, x.device)
    rows, cols = _check_rows("quantize", x)
    u_rows = u.numel() // cols if cols else 0
    if u.shape[-1:] != x.shape[-1:] or u_rows < 1 or rows % u_rows:
        raise ValueError(f"quantize: uniforms {tuple(u.shape)} do not "
                         f"cover rows of {tuple(x.shape)}")
    _max_cluster(x.device)          # the cluster kernels' attributes set
    out = torch.empty_like(x)
    partials = _partials(plan, rows, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().quantize_rows(
            x.data_ptr(), u.data_ptr(), out.data_ptr(), _ptr(partials),
            rows, cols, u_rows, float(levels), *_plan_args(plan), stream)
    COUNTS["quantize"] += 1
    _raise_on("quantize", err)
    return out


def quantize(x: torch.Tensor, u: torch.Tensor, levels: int) -> torch.Tensor:
    """Row-wise QSGD of the 2-D ``x`` with uniforms ``u`` (x's shape) on
    the card, by :func:`quantize_plan`."""
    _check("quantize", x, u)
    rows, cols = _check_rows("quantize", x)
    # the output comes from the caching allocator, 512-byte aligned
    return _quantize_with_plan(x, u, levels, _plan_for(rows, cols, (x, u)))


def _broadcast_rows(name: str, what: str, k: int, rows: int, n: int) -> int:
    """``k`` rows of ``what``, read at r % k, must be the rows, the node
    axis's n, or 1."""
    if k not in (rows, n, 1) or k < 1 or rows % k:
        raise ValueError(f"{name}: {k} rows of {what} do not broadcast over "
                         f"{rows} rows of {n} nodes")
    return k


def dasha_quantize_update(h_new: torch.Tensor, h: torch.Tensor,
                          g_local: torch.Tensor, u: torch.Tensor, a: float,
                          scale: Union[float, torch.Tensor], levels: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The QDither estimator update on the card in one launch, by
    :func:`quantize_plan`: returns (m, h_new, g_new), m and g_new shaped
    like ``h_new`` (any leading axes; the last is the row).  ``u``: (n, d)
    uniforms of the node axis (axis -2) or h_new's shape; ``scale``: a
    float, or an (n, 1) fp32 tensor.  ``a`` and a float scale are passed
    as fp32."""
    return _dasha_quantize_update_with_plan(h_new, h, g_local, u, a, scale,
                                            levels, None)


def _dasha_quantize_update_with_plan(
        h_new: torch.Tensor, h: torch.Tensor, g_local: torch.Tensor,
        u: torch.Tensor, a: float, scale: Union[float, torch.Tensor],
        levels: int, plan: Optional[QuantizePlan]
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`dasha_quantize_update` by ``plan``, or by
    :func:`quantize_plan` where it is None.  Counts one call of
    ``quantize``.  The private entry forces a plan (chip_smoke runs the
    plans of a card that schedules clusters of 8 with it)."""
    name = "dasha_quantize_update"
    _check(name, h_new, h, g_local)
    d = h_new.shape[-1]
    rows = h_new.numel() // d if d else 0
    n = h_new.shape[-2] if h_new.dim() >= 2 else 1
    _check_one(name, u, h_new.device)
    if u.shape[-1:] != h_new.shape[-1:]:
        raise ValueError(f"{name}: uniforms {tuple(u.shape)} against rows "
                         f"of {d}")
    u_rows = _broadcast_rows(name, "u", u.numel() // d if d else 0, rows, n)
    scale_t, scale_rows, kscale = None, 1, 1.0
    if isinstance(scale, torch.Tensor):
        _check_one(name, scale, h_new.device)
        scale_rows = _broadcast_rows(name, "scale", scale.numel(), rows, n)
        scale_t = scale
    else:
        kscale = float(scale)
    m = torch.empty_like(h_new)
    g_new = torch.empty_like(h_new)
    if plan is None:
        plan = _plan_for(rows, d, (h_new, h, g_local, u, m, g_new))
    else:
        _max_cluster(h_new.device)      # the cluster kernels' attributes set
    partials = _partials(plan, rows, h_new)
    with torch.cuda.device(h_new.device):
        stream = torch.cuda.current_stream(h_new.device).cuda_stream
        err = _lib().dasha_quantize_update(
            h_new.data_ptr(), h.data_ptr(), g_local.data_ptr(), u.data_ptr(),
            _ptr(scale_t), m.data_ptr(), g_new.data_ptr(), _ptr(partials),
            rows, d, u_rows, scale_rows, float(a), kscale, float(levels),
            *_plan_args(plan), stream)
    COUNTS["quantize"] += 1
    _raise_on(name, err)
    return m, h_new, g_new


#: the one-level rule's tolerances: a few fp32 ulp relative, and how near
#: ``y - floor(y)`` a uniform must lie for a one-level difference
QUANTIZE_ULP_RTOL = 4e-7
QUANTIZE_BOUNDARY = 1e-5


def quantize_agreement(out: torch.Tensor, plain: torch.Tensor,
                       x: torch.Tensor, u: torch.Tensor, levels: int,
                       scale: Union[float, torch.Tensor] = 1.0
                       ) -> Dict[str, float]:
    """Hold a quantized output against the plain version by the one-level
    rule: every element agrees to a few ulp (:data:`QUANTIZE_ULP_RTOL`
    relative; the two norms may differ in the last ulp), except elements
    one level (``norm / s``, times ``|scale|`` for outputs scaled by a
    float or an (R, 1) ``scale``) away, which are allowed only where the
    uniform lies within :data:`QUANTIZE_BOUNDARY` of ``y - floor(y)``.

    Returns ``max_abs_err`` over the agreeing elements, the count of
    one-level ``flips`` and ``ok``."""
    xf = x.to(torch.float32)
    norm = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    level = (norm / levels * torch.as_tensor(scale, dtype=torch.float32,
                                             device=xf.device).abs()
             ).expand_as(xf)
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
