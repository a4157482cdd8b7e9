"""The port's wire codec against the reference's (CPU).

Every compressor x mode x backend case of ``tests/test_fed_wire.py``: the
reference draws a round (plan, messages) with JAX, and the same arrays
(as torch tensors for the port) go through both ``encode_round``s; the
records must be equal byte for byte, with and without Appendix-D
absentees and on a sync round.  The port reproduces the reference's
frozen golden digests, its decode round trips, and its error classes on
truncated, corrupted and unknown-version records.  The port's own
messages (its backends on the reference's plan) round-trip through its
codec: bit for bit where the format ships raw float32, value-equal where
a dense backend's mask multiply leaves -0.0 at a dropped coordinate.
Tolerance: none, everything here is exact.
"""
import hashlib
import struct

import jax
import numpy as np
import pytest
import torch
from torch_common import port_plan

from repro.compress import make_round_compressor as j_make_rc
from repro.compress.plan import Plan as JPlan
from repro.fed import wire as jwire
from repro_torch.compress import make_round_compressor as t_make_rc
from repro_torch.compress.backends import estimator_update_with_plan
from repro_torch.compress.plan import Plan as TPlan
from repro_torch.fed import wire as twire

torch.set_num_threads(1)

D, N, K = 40, 5, 6

#: the reference's compressor x mode x backend matrix (tests/test_fed_wire.py)
CASES = [
    ("randk", "independent", "sparse", dict(k=K)),
    ("randk", "shared_coords", "sparse", dict(k=K)),
    ("randk", "independent", "dense", dict(k=K)),
    ("randk", "shared_coords", "dense", dict(k=K)),
    ("permk", "permk", "sparse", {}),
    ("permk", "independent", "sparse", {}),
    ("permk", "permk", "dense", {}),
    ("bernoulli", "independent", "dense", dict(p=0.25)),
    ("bernoulli", "shared_coords", "dense", dict(p=0.25)),
    ("identity", "independent", "dense", {}),
    ("qdither", "independent", "dense", dict(s=7)),
]
IDS = ["-".join((c[0], c[1], c[2])) for c in CASES]


class _Msgs:
    def __init__(self, values, indices=None):
        self.values = values
        self.indices = indices


def _round(name, mode, backend, kw, key=0, d=D):
    """One reference round, and the same arrays for the port: its round
    compressor, plan (torch) and messages (torch)."""
    jrc = j_make_rc(name, d, N, mode=mode, backend=backend, **kw)
    trc = t_make_rc(name, d, N, mode=mode, backend=backend, device="cpu",
                    **kw)
    k = jax.random.PRNGKey(key)
    deltas = np.array(jax.random.normal(jax.random.fold_in(k, 1), (N, d)))
    jplan = jrc.plan(k)
    jmsgs = jrc.compress(k, deltas)
    idx = getattr(jmsgs, "indices", None)
    tmsgs = _Msgs(torch.as_tensor(np.array(jmsgs.values)),
                  None if idx is None else torch.as_tensor(np.array(idx)))
    return (jrc, jplan, jmsgs), (trc, port_plan(jplan), tmsgs), deltas


@pytest.mark.parametrize("name,mode,backend,kw", CASES, ids=IDS)
def test_encode_round_is_byte_identical_to_reference(name, mode, backend,
                                                     kw):
    (jrc, jplan, jmsgs), (trc, tplan, tmsgs), _ = _round(name, mode,
                                                         backend, kw)
    for present in (None, np.array([1, 0, 1, 1, 0], bool)):
        want = jwire.encode_round(jrc, jplan, jmsgs, 7, present=present)
        got = twire.encode_round(trc, tplan, tmsgs, 7, present=None
                                 if present is None
                                 else torch.as_tensor(present))
        assert got == want
        assert twire.round_bytes(got) == jwire.round_bytes(want)
        np.testing.assert_array_equal(
            twire.decode_round(got, D, plan=tplan),
            jwire.decode_round(want, D, plan=jplan))
    sync = np.arange(N * D, dtype=np.float32).reshape(N, D)
    want = jwire.encode_round(jrc, jplan, jmsgs, 9, coin=True,
                              sync_values=sync)
    assert twire.encode_round(trc, tplan, tmsgs, 9, coin=True,
                              sync_values=torch.as_tensor(sync)) == want


#: the fused backend (the CUDA kernels' path) emits dense rows too
FUSED = [("randk", "independent", "fused", dict(k=K)),
         ("permk", "permk", "fused", {}),
         ("bernoulli", "independent", "fused", dict(p=0.25)),
         ("qdither", "independent", "fused", dict(s=7))]


@pytest.mark.parametrize("name,mode,backend,kw", CASES + FUSED,
                         ids=IDS + ["-".join(c[:3]) for c in FUSED])
def test_port_messages_round_trip_through_the_port_codec(name, mode,
                                                         backend, kw):
    """The port's backends on the reference's plan: decode(encode) equals
    the messages' dense view, bit for bit for the wire-native formats
    (sparse records, raw dense rows), as values where a mask multiply
    leaves -0.0 at dropped coordinates (the wire carries none)."""
    _, (trc, tplan, _), deltas = _round(name, mode, backend, kw)
    zero = torch.zeros((N, D))
    msgs, _, _ = estimator_update_with_plan(
        backend, tplan, torch.as_tensor(deltas), zero, zero, 0.0)
    dec = twire.decode_round(twire.encode_round(trc, tplan, msgs, 3), D,
                             plan=tplan)
    dense = msgs.dense().numpy()
    np.testing.assert_array_equal(dec, dense)
    if backend == "sparse" or name in ("identity", "qdither"):
        assert dec.tobytes() == dense.tobytes()


def test_golden_round_bytes():
    """The reference's frozen digests (tests/test_fed_wire.py), from the
    port's codec on the same numpy rounds."""
    n, d, k = 4, 12, 3
    vals = (np.arange(n * k, dtype=np.float32).reshape(n, k) + 0.5)
    idx = (np.arange(n * k).reshape(n, k) * 3 % d).astype(np.int32)
    dense_vals = np.linspace(-1, 1, n * d, dtype=np.float32).reshape(n, d)

    def digest(bufs):
        return hashlib.sha256(
            b"".join(b if b is not None else b"\xff" for b in bufs)
        ).hexdigest()[:16]

    def rc(name, **kw):
        return t_make_rc(name, d, n, device="cpu", **kw)

    rc_sparse = rc("randk", k=k, backend="sparse")
    rc_seed = rc("randk", k=k, mode="shared_coords", backend="sparse")
    rc_permk = rc("permk", mode="permk", backend="sparse")
    seed_plan = TPlan(kind="sparsify", scale=1.0,
                      indices=np.broadcast_to(idx[0], (n, k)))
    mask = (np.arange(n * d).reshape(n, d) % 3 == 0)
    blk = d // n
    permk_idx = ((np.arange(n * blk).reshape(n, blk) + 5) % d) \
        .astype(np.int32)
    permk_plan = TPlan(kind="sparsify", scale=float(n), indices=permk_idx)
    cblk = d // 2
    slot_map = np.array([-1, 0, -1, 1], np.int64)
    slot_idx = np.zeros((n, cblk), np.int32)
    for s, i in enumerate((1, 3)):
        slot_idx[i] = (s * cblk + np.arange(cblk) - 2) % (2 * cblk)
    got = {
        "sparse_idx": digest(twire.encode_round(
            rc_sparse, None, _Msgs(vals, idx), 3)),
        "sparse_idx_absent": digest(twire.encode_round(
            rc_sparse, None, _Msgs(vals, idx), 3,
            present=np.array([1, 0, 0, 1], bool))),
        "seed": digest(twire.encode_round(
            rc_seed, seed_plan,
            _Msgs(vals, np.broadcast_to(idx[0], (n, k))), 4)),
        "dense": digest(twire.encode_round(
            rc("identity"), None, _Msgs(dense_vals), 5)),
        "bernoulli": digest(twire.encode_round(
            rc("bernoulli", p=0.5),
            TPlan(kind="sparsify", scale=2.0, mask=mask),
            _Msgs(dense_vals), 6)),
        "permk": digest(twire.encode_round(
            rc_permk, permk_plan, _Msgs(vals[:, :blk], permk_idx), 7)),
        "permk_slot": digest(twire.encode_round(
            rc_permk, TPlan(kind="sparsify", scale=float(n),
                            indices=slot_idx),
            _Msgs(vals[:, :cblk], slot_idx), 7,
            present=np.array([0, 1, 0, 1], bool), slots=slot_map)),
        "coin": digest(twire.encode_round(
            rc_sparse, None, _Msgs(vals, idx), 8, coin=True,
            sync_values=dense_vals)),
    }
    assert got == {
        "sparse_idx": "8d3234d6d4239bf1",
        "sparse_idx_absent": "051dc876eef2d07f",
        "seed": "b0a0d14adff37bdd",
        "dense": "f44e6b1fb18cf9ed",
        "bernoulli": "77ea0cd221089c47",
        "permk": "eaee3ce16b04d52d",
        "permk_slot": "107e5d9603de4a89",
        "coin": "ce49eecd423c2623",
    }, got


# ---------------------------------------------------------------------------
# the scalar encoders, headers and helpers
# ---------------------------------------------------------------------------

def _scalar_records():
    vals = np.array([1e-42, -0.0, np.inf, -1.5, 3.0], np.float32)
    idx = np.array([0, 3, 7, 11, 39])
    return [
        ("encode_dense", (2, 9, vals)),
        ("encode_sparse_idx", (2, 9, D, idx, vals)),
        ("encode_sparse_seed", (1, 4, D, vals)),
        ("encode_permk", (3, 6, 37, 12, 40, vals)),
        ("encode_permk_slot", (0, 6, 12, 1, 5, 12, vals)),
    ]


@pytest.mark.parametrize("fn,args", _scalar_records(),
                         ids=[r[0] for r in _scalar_records()])
def test_scalar_encoders_equal_reference_and_round_trip(fn, args):
    """Each scalar encoder writes the reference's bytes (awkward floats
    included: denormals, -0.0, inf) and decodes to the same message."""
    buf = getattr(twire, fn)(*args)
    assert buf == getattr(jwire, fn)(*args)
    shared = np.array([0, 3, 7, 11, 39]) if fn == "encode_sparse_seed" \
        else None
    got = twire.decode(buf, shared_indices=shared)
    want = jwire.decode(buf, shared_indices=shared)
    for f in ("fmt", "node", "round", "d", "shift", "period", "slot"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.values.tobytes() == want.values.tobytes()
    if want.indices is None:
        assert got.indices is None
    else:
        np.testing.assert_array_equal(got.indices, want.indices)
    assert got.dense().tobytes() == want.dense().tobytes()
    assert twire.measured_bytes(buf) == len(buf)


def test_header_dtype_matches_struct_layout():
    h = np.zeros(1, twire.HDR_DTYPE)
    h["ver"], h["fmt"], h["node"] = 2, 3, 517
    h["round"], h["d"], h["count"] = 123456, 40, 6
    h["crc"] = 0xDEADBEEF
    assert h.tobytes() == struct.pack("<BBHIIII", 2, 3, 517, 123456, 40, 6,
                                      0xDEADBEEF)
    assert h.tobytes()[:twire.CRC_OFFSET] \
        == twire._HEAD16.pack(2, 3, 517, 123456, 40, 6)
    for name in ("WIRE_VERSION", "HEADER_BYTES", "CRC_OFFSET",
                 "PERMK_EXT_BYTES", "PERMK_SLOT_EXT_BYTES"):
        assert getattr(twire, name) == getattr(jwire, name), name
    for name in ("REC_DTYPE", "HDR_DTYPE", "EXT_DTYPE", "SLOT_EXT_DTYPE"):
        assert getattr(twire, name) == getattr(jwire, name), name


def test_slot_keyed_headers_are_u16_safe_beyond_65535_clients():
    """n > 65535: a global client id overflows the header's u16 node
    field (a ValueError, never a silent wrap, in both codecs); the
    slot-keyed round carries the cohort slot instead."""
    n, d, k, c = 70_000, 8, 2, 3
    jrc = j_make_rc("randk", d, n, k=k, backend="sparse")
    trc = t_make_rc("randk", d, n, k=k, backend="sparse", device="cpu")
    sel = np.array([7, 66_000, 69_999])
    vals = np.zeros((n, k), np.float32)
    idx = np.zeros((n, k), np.int64)
    vals[sel] = np.arange(c * k, dtype=np.float32).reshape(c, k) + 0.5
    idx[sel] = np.arange(c * k).reshape(c, k) % d
    present = np.zeros(n, bool)
    present[sel] = True
    for w, rc in ((jwire, jrc), (twire, trc)):
        with pytest.raises(ValueError, match="uint16"):
            w.encode_round(rc, None, _Msgs(vals, idx), 0, present=present)
    slots = np.full(n, -1, np.int64)
    slots[sel] = np.arange(c)
    want = jwire.encode_round(jrc, None, _Msgs(vals, idx), 0,
                              present=present, slots=slots)
    got = twire.encode_round(trc, None, _Msgs(torch.as_tensor(vals),
                                              torch.as_tensor(idx)), 0,
                             present=present, slots=slots)
    assert got == want and sum(b is not None for b in got) == c
    for s, i in enumerate(sel):
        m = twire.decode(got[i])
        assert m.node == s
        np.testing.assert_array_equal(m.indices, idx[i])


def test_permk_helpers_equal_reference():
    rc = j_make_rc("permk", 37, N, mode="permk", backend="sparse")
    plan = rc.plan(jax.random.PRNGKey(5))
    idx = np.array(plan.indices)
    for i in range(N):
        assert twire.permk_shift(torch.as_tensor(idx[i]), i, N) \
            == jwire.permk_shift(idx[i], i, N)
    assert twire.permk_shift(np.full(4, 2 ** 31 - 1), 1, N) == 0
    tplan = port_plan(plan)
    np.testing.assert_array_equal(twire.shared_support(tplan),
                                  jwire.shared_support(plan))
    mask = np.arange(N * D).reshape(N, D) % 4 == 0
    np.testing.assert_array_equal(
        twire.shared_support(TPlan("sparsify", 1.0,
                                   mask=torch.as_tensor(mask))),
        jwire.shared_support(JPlan("sparsify", 1.0, mask=mask)))
    assert twire.shared_support(TPlan("passthrough", 1.0)) is None


def test_topk_messages_equal_reference():
    rows = np.array(jax.random.normal(jax.random.PRNGKey(2), (N, D)))
    gi, gv = twire.topk_messages(torch.as_tensor(rows), K)
    wi, wv = jwire.topk_messages(rows, K)
    np.testing.assert_array_equal(gi, wi)
    assert gv.tobytes() == wv.tobytes()
    for i in range(N):
        assert twire.encode_sparse_idx(i, 0, D, gi[i], gv[i]) \
            == jwire.encode_sparse_idx(i, 0, D, wi[i], wv[i])


# ---------------------------------------------------------------------------
# integrity: truncation, corruption, unknown versions
# ---------------------------------------------------------------------------

def _first_record(name, mode, backend, kw):
    (jrc, jplan, jmsgs), _, _ = _round(name, mode, backend, kw)
    return next(b for b in jwire.encode_round(jrc, jplan, jmsgs, t=2)
                if b is not None), jplan


def _raises(fn, *args, **kw):
    """The exception class ``fn`` raises, or None."""
    try:
        fn(*args, **kw)
    except Exception as e:               # noqa: BLE001 - compared below
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("name,mode,backend,kw", CASES, ids=IDS)
def test_damaged_records_raise_as_the_reference(name, mode, backend, kw):
    """Every prefix of a record (truncation) and every single-byte flip
    (corruption) raises the reference's exception class and message, all
    of them ``WireDecodeError``s."""
    buf, plan = _first_record(name, mode, backend, kw)
    shared = jwire.shared_support(plan)
    twire.verify(buf)
    damaged = [buf[:clip] for clip in range(len(buf))]
    for pos in range(len(buf)):
        bad = bytearray(buf)
        bad[pos] ^= 0x5A
        damaged.append(bytes(bad))
    for bad in damaged:
        got = _raises(twire.decode, bad, shared_indices=shared)
        assert got is not None
        assert got == _raises(jwire.decode, bad, shared_indices=shared)
        with pytest.raises(twire.WireDecodeError):
            twire.decode(bad, shared_indices=shared)


def test_error_taxonomy_and_unknown_version():
    buf = twire.encode_dense(1, 4, np.ones(8, np.float32))
    cases = {"short header": buf[:10], "short body": buf[:-4]}
    body_flip = bytearray(buf)
    body_flip[-1] ^= 0xFF
    cases["body flip"] = bytes(body_flip)
    cases["version"] = bytes([9]) + buf[1:]
    cases["fmt"] = buf[:1] + bytes([7]) + buf[2:]
    want = {"short header": twire.WireTruncatedError,
            "short body": twire.WireTruncatedError,
            "body flip": twire.WireCorruptionError,
            "version": twire.WireDecodeError, "fmt": twire.WireDecodeError}
    for label, bad in cases.items():
        with pytest.raises(want[label]):
            twire.decode(bad)
        assert _raises(twire.decode, bad) == _raises(jwire.decode, bad), \
            label
    assert issubclass(twire.WireCorruptionError, ValueError)
    assert issubclass(twire.WireTruncatedError, twire.WireDecodeError)
    # a seed-shared record needs the shared support to decode
    seed_buf = twire.encode_sparse_seed(0, 0, D, np.ones(3, np.float32))
    with pytest.raises(ValueError, match="shared round support"):
        twire.decode(seed_buf)
