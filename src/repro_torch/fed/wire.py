"""Layer 1 of the federated transport subsystem, analytic part (port of
the constants and the static schema of ``repro.fed.wire``): what the
vectorized simulator needs to bill a round's bytes without encoding it.

Every message carries one 20-byte header (`<BBHIIII`: version, fmt, node,
round, d, count, crc32).  The body by format:

==============  =========================================  ===============
fmt             body                                       used by
==============  =========================================  ===============
``DENSE``       d raw float32 values                       identity,
                                                           qdither, sync
                                                           rounds
``SPARSE_IDX``  count packed ``(uint32 idx, float32        independent
                val)`` records                             RandK, Bernoulli
``SPARSE_SEED`` count raw float32 values; the support is   shared_coords
                rederived from the shared round seed       RandK, Bernoulli
``PERMK``       8-byte slice header (`<II`: shift,         PermK
                period) + blk raw float32 values
``PERMK_SLOT``  12-byte slice header (`<III`: slot,        PermK under
                shift, period) + blk raw float32 values    C-of-n sampling
==============  =========================================  ===============

The byte codec itself (``encode_round`` / ``decode``) is not ported yet.
"""
from __future__ import annotations

import struct
from typing import NamedTuple, Optional

FMT_DENSE = 0
FMT_SPARSE_IDX = 1
FMT_SPARSE_SEED = 2
FMT_PERMK = 3
FMT_PERMK_SLOT = 4

FMT_NAMES = {FMT_DENSE: "dense", FMT_SPARSE_IDX: "sparse_idx",
             FMT_SPARSE_SEED: "sparse_seed", FMT_PERMK: "permk",
             FMT_PERMK_SLOT: "permk_slot"}

_HEADER = struct.Struct("<BBHIIII")  # version, fmt, node, round, d, count, crc
_PERMK_EXT = struct.Struct("<II")       # shift, period (= n * blk)
_PERMK_SLOT_EXT = struct.Struct("<III")  # slot, shift, period (= C * blk)
HEADER_BYTES = _HEADER.size             # 20
PERMK_EXT_BYTES = _PERMK_EXT.size       # 8
PERMK_SLOT_EXT_BYTES = _PERMK_SLOT_EXT.size  # 12


class WireSchema(NamedTuple):
    """Static byte layout of one compressor x mode on the wire:

    * ``header_bytes``    — fixed per-message overhead (20, +8 for PERMK,
      +12 for PERMK_SLOT);
    * ``bytes_per_value`` — 4 (values only) or 8 (a private support ships
      its packed uint32 index next to every float32 value);
    * ``static_count``    — shipped value scalars per message when the
      count is data-independent; None for Bernoulli masks, whose realized
      counts come from the round's plan (the substrate's
      ``round_wire_counts`` / ``cohort_counts``).
    """

    fmt: int
    header_bytes: int
    bytes_per_value: int
    static_count: Optional[int]


def wire_schema(rc, *, slot_keyed: bool = False) -> WireSchema:
    """Classify a :class:`repro_torch.compress.RoundCompressor`'s non-sync
    wire format (sync rounds are always DENSE: ``HEADER_BYTES + 4 d``).

    ``slot_keyed`` marks a C-of-n sampled cohort: PermK slices then ship
    the 12-byte ``PERMK_SLOT`` header (the slot travels explicitly); every
    other format is unchanged."""
    spec, mode = rc.spec, rc.mode
    d = int(spec.d)
    if spec.name == "permk":
        blk = -(-d // spec.n)
        if slot_keyed:
            return WireSchema(FMT_PERMK_SLOT,
                              HEADER_BYTES + PERMK_SLOT_EXT_BYTES, 4, blk)
        return WireSchema(FMT_PERMK, HEADER_BYTES + PERMK_EXT_BYTES, 4, blk)
    if spec.name == "randk":
        if mode == "shared_coords":
            return WireSchema(FMT_SPARSE_SEED, HEADER_BYTES, 4, int(spec.k))
        return WireSchema(FMT_SPARSE_IDX, HEADER_BYTES, 8, int(spec.k))
    if spec.name == "bernoulli":
        if mode == "shared_coords":
            return WireSchema(FMT_SPARSE_SEED, HEADER_BYTES, 4, None)
        return WireSchema(FMT_SPARSE_IDX, HEADER_BYTES, 8, None)
    return WireSchema(FMT_DENSE, HEADER_BYTES, 4, d)   # identity / qdither
