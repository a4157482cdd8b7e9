"""Layer 1 of the federated transport subsystem: the wire codec (port of
``repro.fed.wire``, numpy and ``zlib.crc32`` as in the reference, so every
record is byte-identical to the reference's).

Every compressed message the plan layer can emit has a byte-exact
serialization here (DESIGN.md §12).  Five formats, one fixed 20-byte
header (`<BBHIIII`: version, fmt, node, round, d, count, crc32):

==============  =========================================  ===============
fmt             body                                       used by
==============  =========================================  ===============
``DENSE``       d raw float32 values                       identity,
                                                           qdither, sync
                                                           rounds
``SPARSE_IDX``  count packed ``(uint32 idx, float32        independent
                val)`` records                             RandK, Bernoulli,
                                                           TopK
``SPARSE_SEED`` count raw float32 values; the support is   shared_coords
                rederived from the shared round seed       RandK, Bernoulli
                (the receiver holds the same plan)
``PERMK``       8-byte slice header (`<II`: shift,         PermK (shared
                period) + blk raw float32 values; node     and independent)
                i's indices are ``(i*blk + j - shift)
                mod period``
``PERMK_SLOT``  12-byte slice header (`<III`: slot,        PermK under
                shift, period) + blk raw float32 values;   C-of-n sampling
                indices are ``(slot*blk + j - shift) mod
                period``
==============  =========================================  ===============

``PERMK_SLOT`` exists because a sampled cohort's permutation partitions d
over the C cohort slots, not over client ids: slot s owns block s of the
(period = C*blk)-cycle, whichever client holds it.  QDither ships its d
values as raw float32 (no entropy coding), so its wire bytes exceed its
Definition-1.3 payload; the gap is reported, never hidden.

The CRC32 over the first 16 header bytes plus the body sits at offset 16
(wire v2, DESIGN.md §18), so corruption anywhere in a record fails
:func:`decode` with :class:`WireCorruptionError`, and a buffer shorter
than its header declares fails with :class:`WireTruncatedError`.

Inputs may be torch tensors on any device (plans, messages, sync rows,
masks): :func:`encode_round` moves each to the host once, at its entry.
:func:`wire_schema` is the analytic side the vectorized simulator bills
from without encoding.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

WIRE_VERSION = 2

FMT_DENSE = 0
FMT_SPARSE_IDX = 1
FMT_SPARSE_SEED = 2
FMT_PERMK = 3
FMT_PERMK_SLOT = 4

FMT_NAMES = {FMT_DENSE: "dense", FMT_SPARSE_IDX: "sparse_idx",
             FMT_SPARSE_SEED: "sparse_seed", FMT_PERMK: "permk",
             FMT_PERMK_SLOT: "permk_slot"}

_HEADER = struct.Struct("<BBHIIII")  # version, fmt, node, round, d, count, crc
_HEAD16 = struct.Struct("<BBHIII")   # the CRC-covered field prefix (v1 layout)
_CRC = struct.Struct("<I")           # crc32 at offset 16
_PERMK_EXT = struct.Struct("<II")       # shift, period (= n * blk)
_PERMK_SLOT_EXT = struct.Struct("<III")  # slot, shift, period (= C * blk)
HEADER_BYTES = _HEADER.size             # 20
CRC_OFFSET = _HEAD16.size               # 16
PERMK_EXT_BYTES = _PERMK_EXT.size       # 8
PERMK_SLOT_EXT_BYTES = _PERMK_SLOT_EXT.size  # 12

#: packed (uint32 idx, float32 val) record: the SPARSE_IDX body
REC_DTYPE = np.dtype([("idx", "<u4"), ("val", "<f4")])

#: the 20-byte header as a packed numpy dtype (== _HEADER's layout), filled
#: by the vectorized round encoder
HDR_DTYPE = np.dtype([("ver", "u1"), ("fmt", "u1"), ("node", "<u2"),
                      ("round", "<u4"), ("d", "<u4"), ("count", "<u4"),
                      ("crc", "<u4")])
EXT_DTYPE = np.dtype([("shift", "<u4"), ("period", "<u4")])
SLOT_EXT_DTYPE = np.dtype([("slot", "<u4"), ("shift", "<u4"),
                           ("period", "<u4")])

#: int32 max: the PAD index of ragged PermK blocks (``compress.plan.PAD``)
_PAD = np.iinfo(np.int32).max


class WireDecodeError(ValueError):
    """A wire record failed to decode; the server drops the message."""


class WireTruncatedError(WireDecodeError):
    """The buffer is shorter than the header-declared record layout."""


class WireCorruptionError(WireDecodeError):
    """The header CRC32 does not match the record's bytes."""


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


class WireMessage(NamedTuple):
    """One decoded message; ``dense()`` reconstructs the (d,) vector."""

    fmt: int
    node: int
    round: int
    d: int
    values: np.ndarray                  # float32
    indices: Optional[np.ndarray]      # int64, None for DENSE
    shift: int = 0
    period: int = 0
    slot: int = -1                     # PERMK_SLOT cohort slot (-1 else)

    def dense(self) -> np.ndarray:
        out = np.zeros((self.d,), np.float32)
        if self.fmt == FMT_DENSE:
            out[:] = self.values
        elif self.fmt == FMT_SPARSE_SEED:
            out[self.indices] = self.values
        else:
            # scatter-ADD mirrors SparseMessages.dense() (0 + x on a
            # distinct support)
            np.add.at(out, self.indices, self.values)
        return out


def _host(x) -> Optional[np.ndarray]:
    """A tensor (torch, on any device) or array-like as a host numpy
    array; None stays None."""
    if x is None:
        return None
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(_host(x), np.float32))


def _seal(head16: bytes, body: bytes) -> bytes:
    """Assemble one record: the CRC32 of (16-byte field prefix + body)
    lands at offset 16, between the fields and the body."""
    crc = zlib.crc32(body, zlib.crc32(head16))
    return head16 + _CRC.pack(crc) + body


def encode_dense(node: int, t: int, values) -> bytes:
    values = _f32(values)
    head = _HEAD16.pack(WIRE_VERSION, FMT_DENSE, node, t,
                        values.size, values.size)
    return _seal(head, values.tobytes())


def encode_sparse_idx(node: int, t: int, d: int, indices, values) -> bytes:
    """Independent sparse message: packed (uint32 idx, float32 val) records
    (the receiver cannot rederive a private support, so it ships)."""
    idx = _host(indices)
    val = _f32(values)
    if idx.shape != val.shape:
        raise ValueError(f"indices {idx.shape} and values {val.shape} "
                         "differ in shape")
    rec = np.empty(idx.size, REC_DTYPE)
    rec["idx"] = idx.astype(np.uint32)
    rec["val"] = val
    head = _HEAD16.pack(WIRE_VERSION, FMT_SPARSE_IDX, node, t, d, idx.size)
    return _seal(head, rec.tobytes())


def encode_sparse_seed(node: int, t: int, d: int, values) -> bytes:
    """Shared-support sparse message: values only (the index set follows
    from the shared round seed, which the receiver also holds)."""
    val = _f32(values)
    head = _HEAD16.pack(WIRE_VERSION, FMT_SPARSE_SEED, node, t, d, val.size)
    return _seal(head, val.tobytes())


def encode_permk(node: int, t: int, d: int, shift: int, period: int,
                 values) -> bytes:
    """PermK slice: 8-byte permutation header + the node's block values.
    ``values`` has blk = period / n slots; slots whose reconstructed index
    falls at or beyond d are padding and decode to nothing."""
    val = _f32(values)
    head = _HEAD16.pack(WIRE_VERSION, FMT_PERMK, node, t, d, val.size)
    return _seal(head, _PERMK_EXT.pack(shift % max(period, 1), period)
                 + val.tobytes())


def encode_permk_slot(node: int, t: int, d: int, slot: int, shift: int,
                      period: int, values) -> bytes:
    """Sampled-cohort PermK slice: 12-byte (slot, shift, period) header +
    the slot's block values.  ``slot`` is the node's position in this
    round's cohort, so the receiver reconstructs ``(slot*blk + j - shift)
    mod period`` without knowing the cohort draw."""
    val = _f32(values)
    head = _HEAD16.pack(WIRE_VERSION, FMT_PERMK_SLOT, node, t, d, val.size)
    return _seal(head, _PERMK_SLOT_EXT.pack(slot, shift % max(period, 1),
                                            period) + val.tobytes())


def permk_shift(idx_row, node: int, n: int) -> int:
    """Recover the cyclic shift of the PermK partition from one node row:
    ``idx[j] = (node*blk + j - shift) mod (n*blk)``.  Rows that are all
    padding (every index >= d, encoded as PAD) return 0: their message
    carries no coordinates, so any shift decodes the same."""
    idx_row = _host(idx_row)
    blk = idx_row.size
    period = n * blk
    valid = np.nonzero(idx_row < period)[0]
    if valid.size == 0:
        return 0
    j = int(valid[0])
    return int((node * blk + j - int(idx_row[j])) % period)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _expected_len(fmt: int, count: int) -> int:
    """Record length the header declares: header + format ext + body."""
    if fmt == FMT_PERMK:
        return HEADER_BYTES + PERMK_EXT_BYTES + 4 * count
    if fmt == FMT_PERMK_SLOT:
        return HEADER_BYTES + PERMK_SLOT_EXT_BYTES + 4 * count
    if fmt == FMT_SPARSE_IDX:
        return HEADER_BYTES + REC_DTYPE.itemsize * count
    return HEADER_BYTES + 4 * count      # DENSE / SPARSE_SEED


def verify(buf: bytes) -> None:
    """Integrity-check one record without decoding its body.

    Raises :class:`WireTruncatedError` when the buffer cannot hold what
    the header declares, :class:`WireDecodeError` on an unknown version
    or format byte, and :class:`WireCorruptionError` when the CRC32 at
    offset 16 disagrees with the record's bytes.  Any of these means the
    server must treat the message as dropped."""
    if len(buf) < HEADER_BYTES:
        raise WireTruncatedError(
            f"buffer of {len(buf)} bytes is shorter than the "
            f"{HEADER_BYTES}-byte wire header")
    ver, fmt, _, _, _, count, crc = _HEADER.unpack_from(buf, 0)
    if ver != WIRE_VERSION:
        raise WireDecodeError(f"wire version {ver} != {WIRE_VERSION}")
    if fmt not in FMT_NAMES:
        raise WireDecodeError(f"unknown wire fmt {fmt}")
    need = _expected_len(fmt, count)
    if len(buf) < need:
        raise WireTruncatedError(
            f"{FMT_NAMES[fmt]} record declares count={count} "
            f"({need} bytes) but the buffer holds only {len(buf)}")
    got = zlib.crc32(buf[HEADER_BYTES:], zlib.crc32(buf[:CRC_OFFSET]))
    if got != crc:
        raise WireCorruptionError(
            f"crc32 mismatch on {FMT_NAMES[fmt]} record: header says "
            f"{crc:#010x}, bytes hash to {got:#010x}")


def decode(buf: bytes, *, shared_indices=None) -> WireMessage:
    """Decode one message.  ``shared_indices`` supplies the seed-derived
    support for ``SPARSE_SEED`` (the receiver recomputes it from the round
    plan); PERMK is self-describing (count + slice header).  Truncated or
    corrupted records raise a :class:`WireDecodeError` subclass (see
    :func:`verify`) instead of mis-parsing."""
    buf = bytes(buf)
    verify(buf)
    ver, fmt, node, t, d, count, _crc = _HEADER.unpack_from(buf, 0)
    off = HEADER_BYTES
    if fmt == FMT_DENSE:
        values = np.frombuffer(buf, "<f4", count, off)
        return WireMessage(fmt, node, t, d, values, None)
    if fmt == FMT_SPARSE_IDX:
        rec = np.frombuffer(buf, REC_DTYPE, count, off)
        return WireMessage(fmt, node, t, d, rec["val"],
                           rec["idx"].astype(np.int64))
    if fmt == FMT_SPARSE_SEED:
        values = np.frombuffer(buf, "<f4", count, off)
        if shared_indices is None:
            raise ValueError("SPARSE_SEED needs the shared round support "
                             "(pass shared_indices, derived from the plan)")
        idx = _host(shared_indices)[:count]
        return WireMessage(fmt, node, t, d, values, idx)
    if fmt == FMT_PERMK:
        shift, period = _PERMK_EXT.unpack_from(buf, off)
        off += PERMK_EXT_BYTES
        values = np.frombuffer(buf, "<f4", count, off)
        j = np.arange(count, dtype=np.int64)
        c = (node * count + j - shift) % max(period, 1)
        keep = c < d
        return WireMessage(fmt, node, t, d, values[keep], c[keep],
                           shift=shift, period=period)
    if fmt == FMT_PERMK_SLOT:
        slot, shift, period = _PERMK_SLOT_EXT.unpack_from(buf, off)
        off += PERMK_SLOT_EXT_BYTES
        values = np.frombuffer(buf, "<f4", count, off)
        j = np.arange(count, dtype=np.int64)
        c = (slot * count + j - shift) % max(period, 1)
        keep = c < d
        return WireMessage(fmt, node, t, d, values[keep], c[keep],
                           shift=shift, period=period, slot=slot)
    raise WireDecodeError(f"unknown wire fmt {fmt}")


def measured_bytes(buf: Optional[bytes]) -> int:
    """Bytes on the wire for one encoded message (0 for an absent node)."""
    return 0 if buf is None else len(buf)


class RoundBytes(NamedTuple):
    """Byte accounting for one round of encoded uploads.

    ``value_bytes`` counts 4 bytes per shipped value scalar (the measured
    Definition-1.3 payload); ``total_bytes`` adds shipped indices and the
    fixed headers (the measured wire cost, DESIGN.md §6)."""

    total_bytes: int
    value_bytes: int
    header_bytes: int
    index_bytes: int
    per_node: List[int]


def round_bytes(bufs: Sequence[Optional[bytes]]) -> RoundBytes:
    tot = val = head = idx = 0
    per_node = []
    for buf in bufs:
        per_node.append(measured_bytes(buf))
        if buf is None:
            continue
        ver, fmt, _, _, _, count, _crc = _HEADER.unpack_from(buf, 0)
        h = HEADER_BYTES
        if fmt == FMT_PERMK:
            h += PERMK_EXT_BYTES
        elif fmt == FMT_PERMK_SLOT:
            h += PERMK_SLOT_EXT_BYTES
        v = 4 * count
        tot += len(buf)
        val += v
        head += h
        idx += len(buf) - h - v
    return RoundBytes(tot, val, head, idx, per_node)


# ---------------------------------------------------------------------------
# plan-aware round encoding (the bridge from the compressed messages)
# ---------------------------------------------------------------------------

def shared_support(plan) -> Optional[np.ndarray]:
    """The seed-derived support a SPARSE_SEED receiver recomputes: the
    shared index set (RandK) or the shared mask's coordinates (Bernoulli).
    None when the plan has no shared support."""
    if plan.indices is not None:
        idx = _host(plan.indices[0])
        return idx[idx < _PAD].astype(np.int64)
    if plan.mask is not None:
        return np.nonzero(_host(plan.mask[0]))[0]
    return None


def _headers_u8(fmt: int, nodes: np.ndarray, t: int, d: int,
                counts) -> np.ndarray:
    """(rows, 20) uint8 header block for ``nodes``: one vectorized fill of
    :data:`HDR_DTYPE`.  The crc field is left zero; :func:`_emit_rows`
    seals each finished record."""
    if nodes.size and int(nodes.max()) > np.iinfo(np.uint16).max:
        # struct.pack('<BBHIII') would fail loudly here too: sampled
        # campaigns with n > 65535 must encode slot-keyed (slots=), since
        # slots are bounded by the cohort size C
        raise ValueError(
            f"node id {int(nodes.max())} exceeds the wire header's uint16 "
            "node field (65535): slot-key the round (slots=) instead of "
            "shipping global client ids")
    h = np.empty(nodes.size, HDR_DTYPE)
    h["ver"] = WIRE_VERSION
    h["fmt"] = fmt
    h["node"] = nodes.astype(np.uint16)
    h["round"] = t
    h["d"] = d
    h["count"] = counts
    h["crc"] = 0
    return h.view(np.uint8).reshape(nodes.size, HEADER_BYTES)


def _emit_rows(n: int, nodes: np.ndarray,
               packed: np.ndarray) -> List[Optional[bytes]]:
    """Scatter the (rows, L) uint8 matrix into the per-node buffer list
    (absent nodes stay None: zero bytes on the wire), sealing each row's
    crc32 as the scalar encoders' :func:`_seal` does."""
    out: List[Optional[bytes]] = [None] * n
    for pos, i in enumerate(nodes):
        b = packed[pos].tobytes()
        out[int(i)] = _seal(b[:CRC_OFFSET], b[HEADER_BYTES:])
    return out


def encode_round(rc, plan, msgs, t: int, *, coin: bool = False,
                 sync_values=None, present=None,
                 slots=None) -> List[Optional[bytes]]:
    """Serialize one round of per-node uploads.

    ``rc`` is the :class:`repro_torch.compress.RoundCompressor` (spec and
    mode pick the format), ``plan`` the round's plan, ``msgs`` the
    backend's message container (anything with ``.values`` and, for the
    sparse backend, ``.indices``).  ``plan`` may be None when the support
    already travels in the message records (independent sparse RandK) or
    the round is dense.  On a sync round (``coin``) every node ships
    ``sync_values`` dense: Alg. 2 / MARINA's synchronization upload.
    ``present`` marks the clients that upload; absent ones return None
    (zero bytes).  ``slots`` is the C-of-n sampled-cohort map, (n,) int,
    client -> cohort slot, -1 when unsampled: a slot-keyed round writes
    the slot into every record's uint16 node field (bounded by C, so safe
    at any n), and PermK rows emit the ``PERMK_SLOT`` record (the
    permutation partitions d over slots, period C*blk).

    Record packing is vectorized numpy (structured header and record
    arrays, one contiguous byte matrix sliced per node), byte-identical to
    a loop over the scalar encoders.
    """
    n = rc.n
    d = int(rc.spec.d)
    mode = rc.mode
    name = rc.spec.name

    if coin:
        rows = _f32(sync_values)
        hdr = _headers_u8(FMT_DENSE, np.arange(n), t, d, d)
        return _emit_rows(n, np.arange(n),
                          np.hstack([hdr, rows.view(np.uint8)]))

    pres = None if present is None else _host(present).astype(bool)
    nodes = np.arange(n) if pres is None else np.nonzero(pres)[0]
    # slot-keyed cohort: the u16 header field carries the slot (< C) for
    # every format; ``nodes`` (global) only places buffers in the host-
    # side per-client list, which has no width limit
    if slots is None:
        hdr_nodes = nodes
    else:
        slots = _host(slots).astype(np.int64)
        hdr_nodes = slots[nodes]
        if hdr_nodes.size and int(hdr_nodes.min()) < 0:
            raise ValueError("present client outside the cohort: slots= "
                             "maps it to -1, nothing to key its header by")
    vals = _f32(msgs.values)[nodes]
    msg_idx = _host(getattr(msgs, "indices", None))
    sparse = msg_idx is not None
    plan_idx = None if plan is None else _host(plan.indices)
    plan_mask = None if plan is None else _host(plan.mask)

    if name == "permk" and plan_idx is not None:
        idx = plan_idx[nodes]
        blk = idx.shape[1]
        if slots is not None:
            # cohort: the permutation cycles over the C slots (period
            # C*blk) and a client's base offset is its slot, not its id
            period = int((slots >= 0).sum()) * blk
            base = hdr_nodes * blk
        else:
            period = n * blk
            base = nodes * blk
        valid = idx < period
        j = np.argmax(valid, 1)
        taken = idx[np.arange(nodes.size), j]
        shifts = np.where(valid.any(1), (base + j - taken) % period, 0)
        if not sparse:                   # dense backend: gather the block
            safe = np.minimum(idx.astype(np.int64), d - 1)
            vals = np.where(idx < d, np.take_along_axis(vals, safe, 1),
                            np.float32(0))
        if slots is not None:
            hdr = _headers_u8(FMT_PERMK_SLOT, hdr_nodes, t, d, blk)
            ext = np.empty(nodes.size, SLOT_EXT_DTYPE)
            ext["slot"] = hdr_nodes.astype(np.uint32)
            ext["shift"] = shifts
            ext["period"] = period
            ext_u8 = ext.view(np.uint8).reshape(nodes.size,
                                                PERMK_SLOT_EXT_BYTES)
        else:
            hdr = _headers_u8(FMT_PERMK, hdr_nodes, t, d, blk)
            ext = np.empty(nodes.size, EXT_DTYPE)
            ext["shift"] = shifts
            ext["period"] = period
            ext_u8 = ext.view(np.uint8).reshape(nodes.size,
                                                PERMK_EXT_BYTES)
        return _emit_rows(n, nodes, np.hstack([
            hdr, ext_u8, np.ascontiguousarray(vals).view(np.uint8)]))

    if mode == "shared_coords":
        if not sparse:
            vals = vals[:, shared_support(plan)]
        hdr = _headers_u8(FMT_SPARSE_SEED, hdr_nodes, t, d,
                          vals.shape[1])
        return _emit_rows(n, nodes, np.hstack([
            hdr, np.ascontiguousarray(vals).view(np.uint8)]))

    if sparse or plan_idx is not None:   # private static-K support ships
        idx = msg_idx[nodes] if sparse else plan_idx[nodes].astype(np.int64)
        if not sparse:                   # dense backend: gather the support
            vals = np.take_along_axis(vals, idx, 1)
        rec = np.empty(idx.shape, REC_DTYPE)
        rec["idx"] = idx.astype(np.uint32)
        rec["val"] = vals
        hdr = _headers_u8(FMT_SPARSE_IDX, hdr_nodes, t, d,
                          idx.shape[1])
        return _emit_rows(n, nodes, np.hstack([hdr, rec.view(np.uint8)]))

    if plan_mask is not None:            # independent Bernoulli: ragged
        keep = plan_mask[nodes] != 0     # realized per-node supports
        counts = keep.sum(1)
        cc = np.nonzero(keep)[1]         # row-major: ascending cols per row
        rec = np.empty(cc.size, REC_DTYPE)
        rec["idx"] = cc.astype(np.uint32)
        rec["val"] = vals[keep]
        offs = np.zeros(nodes.size + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        hdr = _headers_u8(FMT_SPARSE_IDX, hdr_nodes, t, d, counts)
        out: List[Optional[bytes]] = [None] * n
        for pos, i in enumerate(nodes):
            out[int(i)] = _seal(hdr[pos].tobytes()[:CRC_OFFSET],
                                rec[offs[pos]:offs[pos + 1]].tobytes())
        return out

    # passthrough / dither: dense fp32 rows
    hdr = _headers_u8(FMT_DENSE, hdr_nodes, t, d, d)
    return _emit_rows(n, nodes, np.hstack([
        hdr, np.ascontiguousarray(vals).view(np.uint8)]))


def decode_round(bufs: Sequence[Optional[bytes]], d: int, *,
                 plan=None) -> np.ndarray:
    """Decode one round back to the (n, d) dense message matrix (absent
    nodes decode to zero rows): the bit-identity side of the codec."""
    shared = shared_support(plan) if plan is not None else None
    rows = []
    for buf in bufs:
        if buf is None:
            rows.append(np.zeros((d,), np.float32))
        else:
            rows.append(decode(buf, shared_indices=shared).dense())
    return np.stack(rows)


def topk_messages(rows, k: int):
    """Content-defined Top-K selection of an (n, d) matrix, as the
    (indices, values) pairs a ``SPARSE_IDX`` wire message ships.  TopK's
    support depends on the data, so unlike RandK there is no seed to
    rederive it from: the 8-byte records are the honest cost.  (TopK is a
    biased compressor outside the paper's U(omega) class; it exercises the
    codec, not the theory.)"""
    rows = _f32(rows)
    idx = np.argsort(-np.abs(rows), axis=1)[:, :k]
    vals = np.take_along_axis(rows, idx, axis=1)
    return idx.astype(np.int64), vals
