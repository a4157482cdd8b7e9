"""Python wrappers of the DASHA round's CUDA kernels
(``csrc/dasha_update.cu``, built by :mod:`repro_torch.kernels.build`).

``dasha_update`` replaces ``repro/kernels/dasha_update.py:
dasha_update_pallas`` (body ``_dasha_update_kernel``): Alg. 1 lines 8-10
as one elementwise pass over fp32 rows (the last axis) on a dense fp32
mask of their shape, four reads (grad, h, g_local, mask) and three writes
(m, h_new, g_new), 28 bytes an element, 6 flops.  It launches the rows
kernel of ``dasha_sparsify_update`` below, by the same plan, on the mask
form, and writes ``h_new`` as a copy of ``grad``.  Each op is rounded on
its own (``__fsub_rn``/``__fmul_rn``/``__fadd_rn``) so the kernel matches
the plain version bit for bit.  No main path calls it now: it is the
counterpart of ``dasha_update_pallas`` as that kernel is specified.

``dasha_sparsify_update`` is kernel 1 as the main paths run it: the
``fused`` backend's estimator update for the sparsifiers (RandK, PermK,
Bernoulli) and passthrough in one launch, where the reference runs the
mask build as jnp ops around ``dasha_update_pallas``
(``repro/compress/backends.py:158-172``) and the port ran it as four to
six torch launches.  It takes the plan's support as it is drawn: (s_rows,
k) int64 indices, PAD-padded (each block builds its tile's selection
bitmap in shared memory from its row's indices, no dense mask anywhere),
an (s_rows, cols) fp32 or byte mask, or none; and a float or per-row scale,
which it folds into the support as the torch chain did (mask * scale, then
a kernel scale of 1), so it is bit-equal to that chain.  Row r reads
support row r % s_rows and scale row r % sc_rows: a lane axis and RandK
``shared_coords`` (one index row) need no copy.  ``h_new`` is ``grad``
itself, as the plain version returns it, so it moves 20 bytes an element:
0.000626 ms at the flat round's (5, 20,958), 0.3336 ms at (5,
11,173,962), at 3.35 TB/s.  A short row is a latency problem (its bytes
move faster than a launch's floor), so :func:`sparsify_plan` spreads the
rows over one wave of blocks, rows on ``grid.x`` (any number of rows), a
block a tile of one row (``float2`` at 20,958: odd rows start 8 bytes off
16), each thread holding a few vectors of every operand with all loads
issued before any arithmetic and the bitmap built while they are in
flight.

``dasha_mvr_update`` replaces ``repro/kernels/dasha_update.py:
dasha_mvr_update_pallas`` (body ``_dasha_mvr_update_kernel``): the same
pass with the MVR h-update fused in, h_new = gn + (1 - b)(h - go), by the
same rows kernel and plan over a leaf's n rows, on an fp32 mask or the
tree path's bool draw (row r % s_rows: one row for ``shared_coords``).
Five reads (gn, go, h, g_local, a mask byte) and three writes: 29 bytes an
element on the bool draw, 9 flops.  The trainer launches it once per
parameter leaf per round; at the tied embedding leaf (4, 77,463,552) the
bound is 2.682 ms at 3.35 TB/s.  ``1 - b`` is formed in Python double and
rounded to fp32 once, as the plain version's scalar is, so the two agree
bit for bit.

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

A sweep's G lanes may give ``a``, and kernel 3's ``1 - b`` (``c``), one
value a lane: the fused entries then take a (G,) fp32 tensor on the card,
G dividing the rows, and row r reads lane ``r // (rows // G)``'s value,
once a block, as ``scale_rows`` reads a per-row scale.  The methods layer
rounds each value to fp32 once (``1 - b`` formed in double first), as a
lane's scalar is, so lane j is bit-equal to a launch with its scalar.

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

#: launches of each kernel's wrappers since the last :func:`reset_counts`
#: (kernel 1's dense-mask entry as "dasha_update", its sparsifier entry as
#: "dasha_sparsify_update", kernel 2's two entries as "quantize")
COUNTS: Dict[str, int] = {"dasha_update": 0, "dasha_sparsify_update": 0,
                          "dasha_mvr_update": 0, "quantize": 0}

_P = ctypes.c_void_p
_F = ctypes.c_float
_LL = ctypes.c_longlong


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("dasha_update")
    if not getattr(lib, "_typed", False):
        lib.dasha_update.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _F, _F, _LL, _LL, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _LL, _LL, _P]
        lib.dasha_update.restype = ctypes.c_int
        lib.dasha_sparsify_update.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL,
            _F, _F, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _LL, _LL, _P]
        lib.dasha_sparsify_update.restype = ctypes.c_int
        lib.dasha_mvr_update.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _F,
            _F, _F, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _LL, _LL, _P]
        lib.dasha_mvr_update.restype = ctypes.c_int
        plan = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _LL, _LL, _P]
        lib.quantize_rows.argtypes = [_P, _P, _P, _P, _LL, _LL, _LL, _F,
                                      *plan]
        lib.quantize_rows.restype = ctypes.c_int
        lib.dasha_quantize_update.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                                              _P, _LL, _LL, _LL, _LL, _LL,
                                              _F, _F, _F, *plan]
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


def lane_values(name: str, what: str, v, rows: int,
                device: torch.device):
    """A scalar argument as a fused entry takes it: ``(float(v), None, 1)``
    for a number, or ``(0.0, v, rows // G)`` for a sweep's (G,) lane
    values, a contiguous fp32 tensor on ``device``.  G must divide the
    rows."""
    if not isinstance(v, torch.Tensor):
        return float(v), None, 1
    if v.dtype != torch.float32 or v.dim() != 1 or v.numel() < 1 \
            or rows % v.numel() or not v.is_contiguous() \
            or v.device != device:
        raise ValueError(f"{name}: lane values of {what} must be a "
                         f"contiguous 1-D fp32 tensor on {device} whose "
                         f"length divides {rows} rows, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")
    return 0.0, v, rows // v.numel()


def dasha_quantize_update(h_new: torch.Tensor, h: torch.Tensor,
                          g_local: torch.Tensor, u: torch.Tensor, a: float,
                          scale: Union[float, torch.Tensor], levels: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The QDither estimator update on the card in one launch, by
    :func:`quantize_plan`: returns (m, h_new, g_new), m and g_new shaped
    like ``h_new`` (any leading axes; the last is the row).  ``u``: (n, d)
    uniforms of the node axis (axis -2) or h_new's shape; ``scale``: a
    float, or an (n, 1) fp32 tensor.  ``a``: a float, or (G,) fp32 lane
    values (:func:`lane_values`).  ``a`` and a float scale are passed as
    fp32."""
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
    ka, a_t, a_div = lane_values(name, "a", a, rows, h_new.device)
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
            _ptr(scale_t), _ptr(a_t), m.data_ptr(), g_new.data_ptr(),
            _ptr(partials), rows, d, u_rows, scale_rows, a_div, ka, kscale,
            float(levels), *_plan_args(plan), stream)
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


# ---------------------------------------------------------------------------
# kernels 1 and 3 by rows: dasha_sparsify_update and dasha_mvr_update
# ---------------------------------------------------------------------------

#: vectors of each operand a thread may hold (at most ``kMaxVpt`` in the
#: source), and the block sizes a plan may take
ROWS_VPTS = (1, 2, 4)
ROWS_THREADS = (32, 64, 128, 256)
#: an index-form block covers at least k / ROWS_INDEX_SPAN elements, so its
#: scan of the row's k indices costs under half its streaming; and at most
#: a 48 KB bitmap's elements
ROWS_INDEX_SPAN = 2
ROWS_SPAN_MAX = 48 * 1024 * 8
#: the support forms, as the source numbers them
FORMS = {"dense": 0, "index": 1, "mask_f32": 2, "mask_u8": 3}
H100_SMS = 132


class SparsifyPlan(NamedTuple):
    """How kernels 1 and 3 cover a (rows, cols) matrix by rows: blocks of
    ``threads`` threads, each thread ``vpt`` vectors of ``vec`` floats a
    sub-tile, each block ``span`` elements of one row, ``blocks_per_row``
    blocks a row."""

    vec: int
    threads: int
    vpt: int
    span: int
    blocks_per_row: int
    grid: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=512)
def sparsify_plan(rows: int, cols: int, aligned16: bool, aligned8: bool,
                  form: str = "dense", k: int = 0,
                  sms: int = H100_SMS) -> SparsifyPlan:
    """The plan of kernel 1's entries (``form`` of :data:`FORMS`, ``k``
    indices a row) or of kernel 3 (a mask form) for a (rows, cols) matrix
    whose pointers are all 16-byte (``aligned16``) or 8-byte
    (``aligned8``) aligned, on a card of ``sms`` SMs.

    A short row is a latency problem: its bytes move in less time than a
    launch takes, so the plan spreads the rows over one wave of blocks:
    the fewest vectors a thread (:data:`ROWS_VPTS`), then the fewest
    threads a block, that keep the grid within ``sms`` blocks; past that,
    256 threads of 2 vectors.  The index form holds 4 vectors a thread,
    which amortize its bitmap (on the H100 the fastest at every RandK
    shape measured, PERF.md).  A block covers a tile of one row, with the
    widest vector the rows' alignment allows (rows of 20,958 floats:
    float2, as odd rows start 8 bytes off 16).  An index-form block spans
    at least k / :data:`ROWS_INDEX_SPAN` elements (a loop of sub-tiles),
    at most :data:`ROWS_SPAN_MAX` and the row."""
    if form not in FORMS:
        raise ValueError(f"sparsify_plan: unknown form {form!r}")
    if rows < 1 or cols < 1:
        raise ValueError(f"sparsify_plan: empty ({rows}, {cols})")
    vec = _vec_width(cols, aligned16, aligned8)
    # the index form builds one bitmap a block: 4 vectors a thread
    # amortize it; the others spread over the most threads that fit
    vpts = ROWS_VPTS[-1:] if form == "index" else ROWS_VPTS
    fits = [(v, t) for v in vpts for t in ROWS_THREADS
            if rows * _ceil(cols, t * v * vec) <= sms]
    vpt, threads = fits[0] if fits else (vpts[-1] if form == "index" else 2,
                                         ROWS_THREADS[-1])
    sub = threads * vpt * vec
    span = sub
    if form == "index" and k > 0:
        # no wider than the bitmap's room or the row
        room = min(ROWS_SPAN_MAX // sub, _ceil(cols, sub))
        span = sub * max(1, min(_ceil(k, ROWS_INDEX_SPAN * sub), room))
    bpr = _ceil(cols, span)
    plan = SparsifyPlan(vec, threads, vpt, span, bpr, rows * bpr)
    if plan.grid > GRID_LIMIT:
        raise ValueError(f"sparsify_plan: {plan.grid} blocks exceed the "
                         f"card's grid limit {GRID_LIMIT}")
    return plan


class RowsArgs(NamedTuple):
    """What a kernel-1 sparsifier or kernel-3 launch reads: (rows, cols)
    rows, the support's form, its rows (row r reads row r % s_rows) and
    indices a row, and the per-row scale's rows (0: a float scale)."""

    rows: int
    cols: int
    form: str
    s_rows: int
    k: int
    sc_rows: int


def _divides(name: str, what: str, k: int, rows: int) -> int:
    if k < 1 or rows % k:
        raise ValueError(f"{name}: {k} rows of {what} do not divide "
                         f"{rows} rows")
    return k


def _mask_form(name: str, mask: torch.Tensor) -> str:
    if mask.dtype == torch.float32:
        return "mask_f32"
    if mask.dtype in (torch.bool, torch.uint8):
        return "mask_u8"
    raise TypeError(f"{name}: a mask of float32, bool or uint8, got "
                    f"{mask.dtype}")


def sparsify_args(grad: torch.Tensor, indices: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  scale: Union[float, torch.Tensor] = 1.0) -> RowsArgs:
    """:func:`dasha_sparsify_update`'s arguments checked (on any device):
    rows of the last axis; at most one support, ``indices`` (s_rows, k)
    int64 or ``mask`` (s_rows, cols) float32 / bool / uint8, contiguous,
    s_rows dividing the rows; a float scale, or a contiguous float32
    (sc_rows,) or (sc_rows, 1) one, sc_rows dividing the rows."""
    name = "dasha_sparsify_update"
    if grad.dim() < 1:
        raise ValueError(f"{name}: expected (..., cols), got a scalar")
    cols = grad.shape[-1]
    rows = grad.numel() // cols if cols else 0
    form, s_rows, k = "dense", 1, 0
    if indices is not None and mask is not None:
        raise ValueError(f"{name}: give indices or a mask, not both")
    if indices is not None:
        if indices.dtype != torch.int64:
            raise TypeError(f"{name}: indices must be int64, got "
                            f"{indices.dtype}")
        if indices.dim() != 2 or not indices.is_contiguous():
            raise ValueError(f"{name}: indices must be a contiguous "
                             f"(s_rows, k), got {tuple(indices.shape)}")
        form, s_rows, k = "index", _divides(name, "indices",
                                            indices.shape[0], rows), \
            indices.shape[1]
    elif mask is not None:
        form = _mask_form(name, mask)
        if mask.dim() < 1 or mask.shape[-1] != cols or \
                not mask.is_contiguous():
            raise ValueError(f"{name}: mask {tuple(mask.shape)} must be a "
                             f"contiguous (s_rows, {cols})")
        s_rows = _divides(name, "mask", mask.numel() // cols, rows)
    sc_rows = 0
    if isinstance(scale, torch.Tensor):
        if scale.dtype != torch.float32:
            raise TypeError(f"{name}: a per-row scale must be float32, got "
                            f"{scale.dtype}")
        if scale.dim() not in (1, 2) or scale.shape[1:] not in ((), (1,)) \
                or not scale.is_contiguous():
            raise ValueError(f"{name}: a per-row scale must be a contiguous "
                             f"(sc_rows,) or (sc_rows, 1), got "
                             f"{tuple(scale.shape)}")
        sc_rows = _divides(name, "scale", scale.numel(), rows)
    return RowsArgs(rows, cols, form, s_rows, k, sc_rows)


def mvr_args(grad_new: torch.Tensor, mask: torch.Tensor) -> RowsArgs:
    """:func:`dasha_mvr_update`'s rows (checked on any device): a leaf
    (n, ...) is n rows (a 1-D one, one row), and its mask float32 / bool /
    uint8 of its shape or with fewer rows that divide n (row r reads mask
    row r % s_rows: (1, ...) for one mask of every node)."""
    name = "dasha_mvr_update"
    form = _mask_form(name, mask)
    if grad_new.dim() >= 2:
        rows = grad_new.shape[0]
        ok = mask.dim() == grad_new.dim() and \
            mask.shape[1:] == grad_new.shape[1:]
    else:
        rows = 1
        ok = mask.shape == grad_new.shape
    if not ok or not mask.is_contiguous():
        raise ValueError(f"{name}: mask {tuple(mask.shape)} against "
                         f"{tuple(grad_new.shape)}")
    cols = grad_new.numel() // rows if rows else 0
    s_rows = _divides(name, "mask", mask.numel() // cols, rows) if cols \
        else 1
    return RowsArgs(rows, cols, form, s_rows, 0, 0)


#: per device index: its SMs
_SMS: Dict[int, int] = {}


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _rows_plan(args: RowsArgs, floats,
               mask_u8: Optional[torch.Tensor]) -> SparsifyPlan:
    """:func:`sparsify_plan` for these tensors: the float pointers' and a
    byte mask's alignment (4 and 2 bytes for float4 and float2)."""
    a16 = _aligned(floats, 16) and (mask_u8 is None or
                                    mask_u8.data_ptr() % 4 == 0)
    a8 = _aligned(floats, 8) and (mask_u8 is None or
                                  mask_u8.data_ptr() % 2 == 0)
    return sparsify_plan(args.rows, args.cols, a16, a8, args.form, args.k,
                         _sms(floats[0].device))


def dasha_update(grad: torch.Tensor, h: torch.Tensor, g_local: torch.Tensor,
                 mask: torch.Tensor, a: float, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused update on the card on a dense fp32 ``mask``, by
    :func:`sparsify_plan` over the rows of the last axis: returns (m,
    h_new, g_new), each shaped like ``grad``, h_new a copy of it.  ``a``
    and ``scale`` are passed as fp32."""
    _check("dasha_update", grad, h, g_local, mask)
    cols = grad.shape[-1] if grad.dim() else 1
    rows = grad.numel() // cols if cols else 0
    m = torch.empty_like(grad)
    h_new = torch.empty_like(grad)
    g_new = torch.empty_like(grad)
    if grad.numel() == 0:
        return m, h_new, g_new
    args = RowsArgs(rows, cols, "mask_f32", rows, 0, 0)
    plan = _rows_plan(args, [grad, h, g_local, mask, m, h_new, g_new], None)
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = _lib().dasha_update(
            grad.data_ptr(), h.data_ptr(), g_local.data_ptr(),
            mask.data_ptr(), m.data_ptr(), h_new.data_ptr(),
            g_new.data_ptr(), float(a), float(scale), rows, cols, plan.vec,
            plan.threads, plan.vpt, plan.span, plan.blocks_per_row, stream)
    COUNTS["dasha_update"] += 1
    _raise_on("dasha_update", err)
    return m, h_new, g_new


def dasha_sparsify_update(grad: torch.Tensor, h: torch.Tensor,
                          g_local: torch.Tensor, a: float,
                          scale: Union[float, torch.Tensor], *,
                          indices: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Kernel 1's sparsifier estimator update on the card in one launch,
    by :func:`sparsify_plan`: returns (m, grad, g_new), m and g_new shaped
    like ``grad`` (any leading axes; the last is the row).  The support is
    ``indices`` (RandK, PermK; PAD and any index outside [0, cols)
    dropped), ``mask`` (Bernoulli, a tree leaf's draw) or none
    (passthrough); see :func:`sparsify_args`.  ``a``: a float or (G,)
    fp32 lane values (:func:`lane_values`).  ``a`` and a float scale are
    passed as fp32.  Counts one call of ``dasha_sparsify_update``."""
    name = "dasha_sparsify_update"
    _check(name, grad, h, g_local)
    support = indices if indices is not None else mask
    scale_t = scale if isinstance(scale, torch.Tensor) else None
    for t in (support, scale_t):
        if t is not None:
            if t.device != grad.device:
                raise ValueError(f"{name}: tensors on {grad.device} and "
                                 f"{t.device}")
    args = sparsify_args(grad, indices, mask, scale)
    ka, a_t, a_div = lane_values(name, "a", a, args.rows, grad.device)
    m = torch.empty_like(grad)
    g_new = torch.empty_like(grad)
    if grad.numel() == 0:
        return m, grad, g_new
    floats = [grad, h, g_local, m, g_new]
    if args.form == "mask_f32":
        floats.append(mask)
    plan = _rows_plan(args, floats, mask if args.form == "mask_u8" else None)
    kscale = 1.0 if scale_t is not None else float(scale)
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = _lib().dasha_sparsify_update(
            grad.data_ptr(), h.data_ptr(), g_local.data_ptr(), _ptr(support),
            _ptr(scale_t), _ptr(a_t), m.data_ptr(), g_new.data_ptr(),
            args.rows, args.cols, args.s_rows, args.k, max(args.sc_rows, 1),
            a_div, ka, kscale, FORMS[args.form], plan.vec, plan.threads, plan.vpt,
            plan.span, plan.blocks_per_row, stream)
    COUNTS["dasha_sparsify_update"] += 1
    _raise_on(name, err)
    return m, grad, g_new


def dasha_mvr_update(grad_new: torch.Tensor, grad_old: torch.Tensor,
                     h: torch.Tensor, g_local: torch.Tensor,
                     mask: torch.Tensor, a: float, b: float, scale: float,
                     *, c=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused MVR update on the card in one launch, by
    :func:`sparsify_plan` over the leaf's n rows: returns (m, h_new,
    g_new), each shaped like ``grad_new``.  ``mask``: float32, bool or
    uint8, of grad_new's shape or (s_rows, ...) read at row r % s_rows
    (:func:`mvr_args`).  ``a``: a float or (G,) fp32 lane values
    (:func:`lane_values`); ``c``: the lanes' (G,) fp32 ``1 - b``, which
    replaces ``b``.  ``a``, ``1 - b`` and ``scale`` are passed as fp32."""
    name = "dasha_mvr_update"
    _check(name, grad_new, grad_old, h, g_local)
    if mask.device != grad_new.device:
        raise ValueError(f"{name}: tensors on {grad_new.device} and "
                         f"{mask.device}")
    args = mvr_args(grad_new, mask)
    ka, a_t, a_div = lane_values(name, "a", a, args.rows, grad_new.device)
    kc, c_t, c_div = lane_values(name, "1 - b",
                                 1.0 - float(b) if c is None else c,
                                 args.rows, grad_new.device)
    if a_t is not None and c_t is not None and a_div != c_div:
        raise ValueError(f"{name}: {args.rows // a_div} lanes of a against "
                         f"{args.rows // c_div} of 1 - b")
    m = torch.empty_like(grad_new)
    h_new = torch.empty_like(grad_new)
    g_new = torch.empty_like(grad_new)
    if grad_new.numel() == 0:
        return m, h_new, g_new
    floats = [grad_new, grad_old, h, g_local, m, h_new, g_new]
    if args.form == "mask_f32":
        floats.append(mask)
    plan = _rows_plan(args, floats, mask if args.form == "mask_u8" else None)
    with torch.cuda.device(grad_new.device):
        stream = torch.cuda.current_stream(grad_new.device).cuda_stream
        err = _lib().dasha_mvr_update(
            grad_new.data_ptr(), grad_old.data_ptr(), h.data_ptr(),
            g_local.data_ptr(), mask.data_ptr(), _ptr(a_t), _ptr(c_t),
            m.data_ptr(), h_new.data_ptr(), g_new.data_ptr(), args.rows,
            args.cols, args.s_rows, a_div if a_t is not None else c_div, ka,
            kc, float(scale),
            FORMS[args.form], plan.vec, plan.threads, plan.vpt, plan.span,
            plan.blocks_per_row, stream)
    COUNTS["dasha_mvr_update"] += 1
    _raise_on(name, err)
    return m, h_new, g_new
