"""Python wrapper of the Mamba2 SSD intra-chunk CUDA kernel
(``csrc/ssd_chunk.cu``, built by :mod:`repro_torch.kernels.build`).

``ssd_chunk`` replaces ``repro/kernels/ssd_chunk.py:ssd_chunk_pallas``
(body ``_ssd_chunk_kernel``): per (batch * head, chunk), ``acs =
cumsum(dt A)``, ``y_diag = (tril(exp(acs_q - acs_k)) * c b^T)(x dt)``,
``state = b^T(exp(acs_end - acs) x dt)``, ``decay = exp(acs_end)``; its
plain version is :func:`repro_torch.kernels.ref.ssd_chunk_ref`.

Unlike the TPU wrapper, which copies ``x`` into (G, nc, Q, P) and
broadcasts ``b``/``c`` over heads (1.6 GB a matrix at the serving prefill
shape for 34 MB of data), the kernel reads the model's tensors where they
lie: x (B, S, H, P), dt (B, S, H), b/c (B, S, N), through their batch and
sequence strides, so the mixer's slices of the conv output go in without
a copy.  Outputs are float32 in the reference's layout: y_diag (G, nc, Q,
P), states (G, nc, N, P), decays (G, nc), acs (G, nc, Q), g = b * H + h.

What bounds it.  At the serving prefill shape (B = 4, S = 32,768, H = 48,
P = 64, N = 128, Q = 256) the work the inputs need — the lower triangle,
c b^T once per (batch, chunk) — is ~211 GFLOP a layer, 3.15 ms at the
card's 67 TFLOP/s float32 peak, against 3.3 GB (0.99 ms) of reads and
writes.  The kernel runs it on the tensor cores: a block forms c b^T once
for a group of heads (:func:`plan` picks the group and its shared
memory), and float32 operands are split into parts whose products are
exact — for bf16 inputs three bf16 parts of A against x itself (~633
GFLOP of bf16 a layer, 0.64 ms at 989 TFLOP/s: the bytes bind), for
float32 inputs TF32 hi/lo on both sides (3 passes).

The wrapper checks device, dtype and layout and raises on anything else,
allocates its outputs with ``torch.empty``, launches on the current stream
and raises when the launch reports an error.  There is no fallback to the
plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

#: launches of the wrapper since the last :func:`reset_counts`
COUNTS: Dict[str, int] = {"ssd_chunk": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest state size N and head width P the kernel takes
MAX_WIDTH = 128
#: the largest chunk Q (the score panel holds 64 query rows by Q keys)
MAX_CHUNK = 256
#: the most heads a block walks, and the most shared memory it may use
MAX_GROUP, MAX_SMEM = 16, 232448
_TILE = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def smem_bytes(elem_bytes: int, Q: int, N: int, hg: int) -> int:
    """Shared memory of a block walking ``hg`` heads (``layout`` in
    ``csrc/ssd_chunk.cu``): dt, acs and the state weights of its heads;
    the converted x dt of 2 units (hi/lo, 64 x 144 floats each), which the
    score pass's b tiles reuse (float32: c and one b tile; bf16: every b
    tile of the chunk, c going to the stage); the double-buffered x stage
    (2 buffers x 2 units of 64 x 64); the score panel (64 x Q float32),
    which the float32 states pass reuses for its double-buffered b tiles.
    b and c rows are padded to 64 or 128, x rows to 64, each plus 16
    bytes."""
    qp = -(-Q // _TILE) * _TILE
    ldn = (_TILE if N <= _TILE else 2 * _TILE) + 16 // elem_bytes
    ldx = _TILE + 16 // elem_bytes
    conv = 2 * _TILE * 144 * 4
    bc = (qp // _TILE if elem_bytes == 2 else 2) * _TILE * ldn * elem_bytes
    stage = 2 * 2 * _TILE * ldx * elem_bytes
    panel = _TILE * (qp + 8) * 4
    bstage = 0 if elem_bytes == 2 else bc
    return 3 * hg * qp * 4 + max(conv, bc) + stage + max(panel, bstage)


def plan(elem_bytes: int, H: int, Q: int, N: int) -> Tuple[int, int]:
    """(heads a block walks, its shared-memory bytes).  A block forms c b^T
    once and reuses it for each of its heads, so larger groups repeat the
    scores less; at most :data:`MAX_GROUP` heads, as many as the shared
    memory holds, split evenly so the last group is not a straggler.  At
    the serving shape (H 48, Q 256, N 128, bf16) that is 3 groups of 16:
    1,536 blocks for 512 (batch, chunk) pairs on 132 SMs."""
    cap = MAX_GROUP
    while cap > 1 and smem_bytes(elem_bytes, Q, N, cap) > MAX_SMEM:
        cap -= 1
    groups = -(-H // cap)
    hg = -(-H // groups)
    return hg, smem_bytes(elem_bytes, Q, N, hg)


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_chunk")
    if not getattr(lib, "_typed", False):
        lib.ssd_chunk.argtypes = [_P] * 9 + [_I] * 8 + [_LL] * 8 + [_P]
        lib.ssd_chunk.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int) -> None:
    """Raise unless the kernel takes these inputs: CUDA tensors on one
    device; x, dt, b, c float32 or bfloat16 alike and A float32; x (B, S,
    H, P) with (H, P) dense, dt (B, S, H) with H dense, b/c (B, S, N) with
    N dense, A (H,) contiguous; S a multiple of ``chunk``, at most
    :data:`MAX_CHUNK`; N, P at most :data:`MAX_WIDTH`."""
    name = "ssd_chunk"
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: expected float32 or bfloat16, got "
                        f"{x.dtype}")
    for t in (dt, b, c):
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: x is {x.dtype} but another input is "
                            f"{t.dtype}")
    if A.dtype != torch.float32:
        raise TypeError(f"{name}: A must be float32, got {A.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) or \
            tuple(b.shape) != (B, S, N) or tuple(c.shape) != (B, S, N):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)} do not fit")
    if chunk < 1 or S % chunk:
        raise ValueError(f"{name}: sequence {S} is not a multiple of the "
                         f"chunk {chunk}")
    if P > MAX_WIDTH or N > MAX_WIDTH:
        raise ValueError(f"{name}: P = {P} and N = {N} must be at most "
                         f"{MAX_WIDTH}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"{name}: chunk {chunk} exceeds {MAX_CHUNK}")
    if B > 65535 or S // chunk > 65535:
        raise ValueError(f"{name}: batch {B} and chunks {S // chunk} must "
                         "be at most 65535")
    dense = (x.stride(3) == 1 and x.stride(2) == P and dt.stride(2) == 1
             and b.stride(2) == 1 and c.stride(2) == 1
             and A.is_contiguous())
    if not dense:
        raise ValueError(f"{name}: the inner dims (x's (H, P), dt's H, "
                         "b's and c's N) must be contiguous")
    for t in (x, dt, A, b, c):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {x.device} and {t.device}")


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """The intra-chunk pass on the card: x (B, S, H, P), dt (B, S, H), A
    (H,), b/c (B, S, N), chunk length Q.  Returns float32 ``(y_diag (G, nc,
    Q, P), states (G, nc, N, P), decays (G, nc), acs (G, nc, Q))`` with G =
    B * H, nc = S / Q."""
    _check(x, dt, A, b, c, chunk)
    B, S, H, P = x.shape
    N = b.shape[-1]
    G, nc = B * H, S // chunk
    hg, _ = plan(x.element_size(), H, chunk, N)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((G, nc, chunk, P), **f32)
    states = torch.empty((G, nc, N, P), **f32)
    decays = torch.empty((G, nc), **f32)
    acs = torch.empty((G, nc, chunk), **f32)
    with torch.cuda.device(x.device):
        lib = _lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_chunk(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), states.data_ptr(),
            decays.data_ptr(), acs.data_ptr(), _DTYPES[x.dtype], B, H, nc,
            chunk, P, N, hg, x.stride(0), x.stride(1), dt.stride(0),
            dt.stride(1), b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            stream)
    COUNTS["ssd_chunk"] += 1
    if err != 0:
        raise RuntimeError(f"ssd_chunk: CUDA launch failed with error {err}")
    return y, states, decays, acs
