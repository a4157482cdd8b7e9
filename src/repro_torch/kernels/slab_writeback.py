"""Python wrapper of the slab-writeback CUDA kernel
(``csrc/slab_writeback.cu``, built by :mod:`repro_torch.kernels.build`).

``slab_writeback`` replaces ``repro/kernels/slab_writeback.py:
slab_writeback_pallas``: the federated slab store (DESIGN.md §16) runs a
chunk of rounds on a compact (U, d) slab of the client rows the chunk
touches, then writes the slab back into the persistent (n, d) store once
per chunk.  The kernel writes row ``j`` of the slab into store row
``idx[j]``, in place, for every ``idx[j]`` in [0, n); the sentinel ``n``
that pads ``idx`` to a static length is dropped.  ``accumulate=True``
adds the row instead of setting it.  Its plain version is
:func:`repro_torch.kernels.ref.slab_writeback_ref`.

What bounds it: device-memory bytes.  It moves each valid slab row once
and does one add at most per element: setting ``u`` valid rows reads and
writes ``2 u d 4`` bytes, accumulating reads one more ``u d 4``.  At the
cross-device cell (U = 8,192 rows padded, about 7,900 valid, d = 20,958)
a set moves 1.3 GB, 0.40 ms at 3.35 TB/s.  Its design moves those bytes
once: a 2-D grid of (slab row, column tile) blocks, each reading its row
id once and leaving at once on a sentinel, with 16-byte accesses where d,
the row strides and the base pointers allow, else 8- or 4-byte ones
(d = 20,958 gives 83,832-byte rows: 8-byte aligned, not 16).  Row offsets
are 64-bit, since the store there holds 2.1e9 elements.  The row ids are
unique, so the add needs no atomics, and the result is bit-equal to the
plain version's.

The wrapper checks device, dtype and layout (float32, unit column
stride, int32 ids, one device) and raises on anything else, launches on
the current stream and raises when the launch reports an error.  There is
no fallback to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

#: launches of the wrapper since the last :func:`reset_counts`
COUNTS: Dict[str, int] = {"slab_writeback": 0}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("slab_writeback")
    if not getattr(lib, "_typed", False):
        lib.slab_writeback.argtypes = [_P, _P, _P] + [_LL] * 5 + \
            [ctypes.c_int, _P]
        lib.slab_writeback.restype = ctypes.c_int
        lib.slab_writeback_vec_width.argtypes = [_P, _P, _LL, _LL, _LL]
        lib.slab_writeback_vec_width.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(full: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    name = "slab_writeback"
    for t in (full, idx, rows):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got "
                             f"{t.device}")
        if t.device != full.device:
            raise ValueError(f"{name}: tensors on {full.device} and "
                             f"{t.device}")
    if full.dtype != torch.float32 or rows.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 store and slab, got "
                        f"{full.dtype} and {rows.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 row ids, got {idx.dtype}")
    if full.dim() != 2 or rows.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: expected full (n, d), idx (u,), rows "
                         f"(u, d); got {tuple(full.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(rows.shape)}")
    if rows.shape[1] != full.shape[1] or rows.shape[0] != idx.shape[0]:
        raise ValueError(f"{name}: full {tuple(full.shape)}, idx "
                         f"{tuple(idx.shape)} and rows {tuple(rows.shape)} "
                         "do not fit")
    if full.stride(1) != 1 or rows.stride(1) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous")
    if not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be contiguous")
    if rows.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: at most 2^31 - 1 slab rows")


def vec_width(full: torch.Tensor, rows: torch.Tensor) -> int:
    """The access width in floats (4, 2 or 1) the kernel takes for this
    store and slab."""
    return _lib().slab_writeback_vec_width(
        full.data_ptr(), rows.data_ptr(), full.shape[1], full.stride(0),
        rows.stride(0))


def slab_writeback(full: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                   *, accumulate: bool = False) -> torch.Tensor:
    """Write ``rows`` into ``full`` at ``idx`` on the card, in place;
    returns ``full``."""
    _check(full, idx, rows)
    if idx.shape[0] == 0:
        return full
    with torch.cuda.device(full.device):
        lib = _lib()
        stream = torch.cuda.current_stream(full.device).cuda_stream
        err = lib.slab_writeback(full.data_ptr(), idx.data_ptr(),
                                 rows.data_ptr(), full.shape[0],
                                 full.shape[1], idx.shape[0], full.stride(0),
                                 rows.stride(0), int(bool(accumulate)),
                                 stream)
    COUNTS["slab_writeback"] += 1
    if err != 0:
        raise RuntimeError(f"slab_writeback: CUDA launch failed with error "
                           f"{err}")
    return full
