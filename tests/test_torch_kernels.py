"""The port's kernels: plain versions against the reference (CPU), the
CPU/CUDA dispatch, the wrappers' input checks, and — on a card only — each
CUDA kernel against its plain version.

Tolerances: ``dasha_update``'s and ``dasha_mvr_update``'s plain versions
repeat the reference's op order, one rounding per op, so they match to
rtol 1e-6 (last-ulp drift of XLA's fused CPU loop); on the card each
kernel must match its plain version bit for bit.  ``quantize`` norms are summed in different orders in the
three implementations, so outputs follow the one-level rule
(``quantize_agreement``).  ``ssd_chunk`` sums its products and its cumsum
in another order than torch's matmul and cumsum: each output agrees with
the plain version to 1e-4 of its largest magnitude (the reference's
``tests/test_ssd_kernel.py`` tolerance).  Its plain version is held
against the reference in ``tests/test_torch_serve.py``.

On a card (no JAX needed):
    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dasha_update as kern
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as ssd_kern

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def reference():
    """The reference's kernel ops and plain versions.  Imported here, not
    at the top, so that the card tests of this file run where JAX is not
    installed."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref


def _arrays(shape, seed=0, mask_p=0.3):
    rng = np.random.default_rng(seed)
    grad, h, gl = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(3))
    mask = (rng.random(shape) < mask_p).astype(np.float32)
    return grad, h, gl, mask


@pytest.mark.parametrize("d", [1, 129, 1000, 128 * 3 + 7])
@pytest.mark.parametrize("a,scale", [(0.1, 32.0), (1.0, 1.0), (0.011, 8.0)])
def test_dasha_update_plain_matches_reference_kernel(reference, d, a,
                                                     scale):
    jnp, jops, _ = reference
    grad, h, gl, mask = _arrays((d,), seed=d)
    want = jops.dasha_update(*(jnp.asarray(t) for t in (grad, h, gl, mask)),
                             a, scale)
    got = ops.dasha_update(*(torch.as_tensor(t) for t in (grad, h, gl,
                                                          mask)), a, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_dasha_update_plain_matches_reference_ref_on_nodes(reference):
    jnp, _, jref = reference
    grad, h, gl, mask = _arrays((5, 300), seed=3)
    want = jref.dasha_update_ref(*(jnp.asarray(t) for t in (grad, h, gl,
                                                            mask)), 0.25, 4.0)
    got = ref.dasha_update_ref(*(torch.as_tensor(t) for t in (grad, h, gl,
                                                              mask)),
                               0.25, 4.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def _mvr_arrays(shape, seed=0, mask_p=0.3):
    grad, h, gl, mask = _arrays(shape, seed, mask_p)
    go = np.random.default_rng(seed + 1).standard_normal(shape) \
        .astype(np.float32)
    return grad, go, h, gl, mask


@pytest.mark.parametrize("d", [1, 129, 1000, 128 * 3 + 7])
@pytest.mark.parametrize("a,b,scale", [(0.1, 0.1, 32.0), (1.0, 1.0, 1.0),
                                       (0.011, 0.0, 8.0)])
def test_dasha_mvr_update_plain_matches_reference_kernel(reference, d, a, b,
                                                         scale):
    """Against ``repro.kernels.ops.dasha_mvr_update`` (the Pallas kernel in
    interpret mode, as the reference's tests run it); b = 0 is SARAH.
    rtol 1e-6: the Pallas body forms 1 - b in fp32, the plain version in
    double before one rounding, so the two may differ in the last ulp."""
    jnp, jops, _ = reference
    arrs = _mvr_arrays((d,), seed=d)
    want = jops.dasha_mvr_update(*(jnp.asarray(t) for t in arrs), a, b,
                                 scale)
    got = ops.dasha_mvr_update(*(torch.as_tensor(t) for t in arrs), a, b,
                               scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("b", [0.3, 0.0])
def test_dasha_mvr_update_plain_matches_reference_ref_on_nodes(reference, b):
    jnp, _, jref = reference
    arrs = _mvr_arrays((4, 300), seed=11)
    want = jref.dasha_mvr_update_ref(*(jnp.asarray(t) for t in arrs), 0.25,
                                     b, 4.0)
    got = ref.dasha_mvr_update_ref(*(torch.as_tensor(t) for t in arrs),
                                   0.25, b, 4.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_mvr_kernel_invariants():
    gn, go, h, gl, mask = (torch.as_tensor(t)
                           for t in _mvr_arrays((4, 257), 5))
    m, h_new, g_new = ops.dasha_mvr_update(gn, go, h, gl, mask, 0.2, 0.0,
                                           3.0)
    assert torch.equal(g_new, gl + m)
    assert torch.equal(h_new, gn + (h - go))       # b = 0: SARAH
    assert bool((m[mask == 0] == 0).all())
    # b = 1 is the plain DASHA update
    want = ops.dasha_update(gn, h, gl, mask, 0.2, 3.0)
    for g, w in zip(ops.dasha_mvr_update(gn, go, h, gl, mask, 0.2, 1.0,
                                         3.0), want):
        assert torch.equal(g, w)


def test_kernel_invariant_g_local_update():
    grad, h, gl, mask = (torch.as_tensor(t) for t in _arrays((4, 257), 5))
    m, h_new, g_new = ops.dasha_update(grad, h, gl, mask, 0.2, 3.0)
    assert torch.equal(g_new, gl + m)
    assert torch.equal(h_new, grad)
    assert bool((m[mask == 0] == 0).all())


@pytest.mark.parametrize("rows,cols,levels", [(1, 128, 1), (5, 300, 15),
                                              (7, 100, 7), (3, 1, 15)])
def test_quantize_plain_follows_one_level_rule_vs_reference(reference, rows,
                                                            cols, levels):
    jnp, jops, _ = reference
    rng = np.random.default_rng(rows * cols)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    x[0] = 0.0                              # a zero row passes through
    u = rng.random((rows, cols)).astype(np.float32)
    want = np.array(jops.quantize_with_u(jnp.asarray(x), jnp.asarray(u),
                                         levels))
    got = ops.quantize_with_u(torch.as_tensor(x), torch.as_tensor(u), levels)
    assert torch.all(got[0] == 0)
    agree = kern.quantize_agreement(got, torch.as_tensor(want),
                                    torch.as_tensor(x), torch.as_tensor(u),
                                    levels)
    assert agree["ok"], agree


def test_quantize_draws_its_own_uniforms_unbiased():
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 64)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    mean = sum(ops.quantize(x, gen, 3) for _ in range(3000)) / 3000
    level = float(x.norm(dim=1).max()) / 3
    assert float((mean - x).abs().max()) < 5 * level / np.sqrt(3000)


def test_dispatch_rejects_devices_without_a_kernel():
    t = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        ops.dasha_update(t, t, t, t, 0.1, 1.0)
    with pytest.raises(ValueError):
        ops.dasha_mvr_update(t, t, t, t, t, 0.1, 0.5, 1.0)
    with pytest.raises(ValueError):
        ops.quantize_with_u(t.view(1, 4), t.view(1, 4), 3)


def test_wrappers_refuse_cpu_tensors_and_launch_nothing():
    t = torch.zeros(8)
    kern.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kern.dasha_update(t, t, t, t, 0.1, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        kern.dasha_mvr_update(t, t, t, t, t, 0.1, 0.5, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        kern.quantize(t.view(2, 4), t.view(2, 4), 3)
    assert kern.COUNTS == {"dasha_update": 0, "dasha_mvr_update": 0,
                           "quantize": 0}


def _ssd_arrays(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, b, c


def _ssd_tensors(shape, device="cpu", dtype=torch.float32, seed=0):
    x, dt, A, b, c = (torch.as_tensor(a, device=device)
                      for a in _ssd_arrays(*shape, seed=seed))
    return x.to(dtype), dt.to(dtype), A, b.to(dtype), c.to(dtype)


def test_ssd_chunk_dispatch_takes_the_plain_version_on_the_cpu():
    x, dt, A, b, c = _ssd_tensors((2, 32, 3, 4, 5))
    ssd_kern.reset_counts()
    got = ops.ssd_chunk(x, dt, A, b, c, 8)
    want = ref.ssd_chunk_ref(*ops.chunk_layout(x, dt, A, b, c, 8))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [tuple(t.shape) for t in got] == [(6, 4, 8, 4), (6, 4, 5, 4),
                                             (6, 4), (6, 4, 8)]
    assert ssd_kern.COUNTS == {"ssd_chunk": 0}
    with pytest.raises(ValueError):
        ops.ssd_chunk(*(t.to("meta") for t in (x, dt, A, b, c)), 8)


def test_ssd_chunk_layout_matches_the_reference_wrapper():
    """chunk_layout builds what the reference's ops.ssd_chunk_scan hands
    its Pallas kernel: (G, nc, Q, ...) with g = batch * H + head."""
    B, S, H, P, N, Q = 2, 16, 3, 4, 5, 8
    x, dt, A, b, c = _ssd_tensors((B, S, H, P, N))
    xg, dtg, Ag, bg, cg = ops.chunk_layout(x, dt, A, b, c, Q)
    for g in range(B * H):
        bi, h = divmod(g, H)
        for j in range(S // Q):
            rows = slice(j * Q, (j + 1) * Q)
            assert torch.equal(xg[g, j], x[bi, rows, h])
            assert torch.equal(dtg[g, j], dt[bi, rows, h])
            assert torch.equal(bg[g, j], b[bi, rows])
            assert torch.equal(cg[g, j], c[bi, rows])
        assert Ag[g] == A[h]


def test_ssd_chunk_wrapper_rejects_bad_inputs_and_launches_nothing():
    """dtype, layout and device are checked before anything is built or
    launched (the device last, so each check shows here on the CPU)."""
    x, dt, A, b, c = _ssd_tensors((1, 32, 2, 4, 8))
    ssd_kern.reset_counts()
    with pytest.raises(TypeError):                       # float64
        ssd_kern.ssd_chunk(x.double(), dt.double(), A, b.double(),
                           c.double(), 8)
    with pytest.raises(TypeError):                       # mixed types
        ssd_kern.ssd_chunk(x.bfloat16(), dt, A, b, c, 8)
    with pytest.raises(TypeError):                       # A not float32
        ssd_kern.ssd_chunk(x, dt, A.double(), b, c, 8)
    with pytest.raises(ValueError, match="contiguous"):  # (H, P) not dense
        ssd_kern.ssd_chunk(x.transpose(2, 3).contiguous().transpose(2, 3),
                           dt, A, b, c, 8)
    with pytest.raises(ValueError, match="contiguous"):  # N not dense
        ssd_kern.ssd_chunk(x, dt, A, b, c.transpose(1, 2).contiguous()
                           .transpose(1, 2), 8)
    with pytest.raises(ValueError, match="multiple"):
        ssd_kern.ssd_chunk(x, dt, A, b, c, 5)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kern.ssd_chunk(x, dt, A, b, c, 8)
    assert ssd_kern.COUNTS == {"ssd_chunk": 0}


# ---------------------------------------------------------------------------
# on the card: kernel vs plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 20958), (3, 4099), (1, 3)])
@pytest.mark.parametrize("misalign", [False, True])
def test_cuda_dasha_update_bit_equal_to_plain(cuda_device, shape, misalign):
    grad, h, gl, mask = _arrays(shape, seed=7)

    def dev(a):
        off = int(misalign)
        buf = torch.empty(a.size + off, device=cuda_device)
        buf[off:] = torch.as_tensor(a.reshape(-1), device=cuda_device)
        return buf[off:].view(shape)

    args = [dev(t) for t in (grad, h, gl, mask)]
    before = kern.COUNTS["dasha_update"]
    got = kern.dasha_update(*args, 0.0024, 209.58)
    assert kern.COUNTS["dasha_update"] == before + 1
    want = ref.dasha_update_ref(*args, 0.0024, 209.58)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 20958), (4, 1536), (3, 4099),
                                   (1, 3)])
@pytest.mark.parametrize("misalign", [False, True])
@pytest.mark.parametrize("b", [0.1, 0.0])
def test_cuda_dasha_mvr_update_bit_equal_to_plain(cuda_device, shape,
                                                  misalign, b):
    def dev(a):
        off = int(misalign)
        buf = torch.empty(a.size + off, device=cuda_device)
        buf[off:] = torch.as_tensor(a.reshape(-1), device=cuda_device)
        return buf[off:].view(shape)

    args = [dev(t) for t in _mvr_arrays(shape, seed=9)]
    before = kern.COUNTS["dasha_mvr_update"]
    got = kern.dasha_mvr_update(*args, 0.0024, b, 32.0)
    assert kern.COUNTS["dasha_mvr_update"] == before + 1
    want = ref.dasha_mvr_update_ref(*args, 0.0024, b, 32.0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 20958), (3, 4099), (2, 9000)])
def test_cuda_quantize_follows_one_level_rule(cuda_device, shape):
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                        device=cuda_device)
    x[0] = 0.0
    u = torch.as_tensor(rng.random(shape).astype(np.float32),
                        device=cuda_device)
    got = kern.quantize(x, u, 15)
    again = kern.quantize(x, u, 15)
    agree = kern.quantize_agreement(got, ref.quantize_ref(x, u, 15), x, u,
                                    15)
    assert agree["ok"], agree
    assert torch.equal(got, again)
    assert bool((got[0] == 0).all())


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    t = torch.zeros((4, 8), device=cuda_device)
    with pytest.raises(TypeError):
        kern.dasha_update(t, t, t, t.double(), 0.1, 1.0)
    with pytest.raises(ValueError):
        kern.dasha_update(t, t, t.t().contiguous().t(), t[:, :4], 0.1, 1.0)
    with pytest.raises(ValueError):
        kern.dasha_mvr_update(t, t, t, t, t[:, :4], 0.1, 0.5, 1.0)
    with pytest.raises(ValueError):
        kern.quantize(t.t(), t.t(), 3)


def _ssd_agree(got, want):
    """Each output within 1e-4 of the plain version's largest magnitude."""
    for name, g, w in zip(("y_diag", "states", "decays", "acs"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,chunk", [
    ((1, 16, 1, 2, 3), 4), ((2, 32, 3, 4, 5), 8), ((1, 64, 2, 8, 16), 16),
    ((2, 24, 2, 4, 4), 24), ((1, 128, 4, 16, 8), 32),
    ((2, 64, 4, 32, 16), 32), ((1, 512, 3, 64, 128), 256),
    ((1, 256, 2, 128, 128), 128), ((1, 200, 2, 72, 100), 100)])
def test_cuda_ssd_chunk_matches_plain(cuda_device, shape, chunk, dtype):
    x, dt, A, b, c = _ssd_tensors(shape, cuda_device, dtype, seed=3)
    before = ssd_kern.COUNTS["ssd_chunk"]
    got = ssd_kern.ssd_chunk(x, dt, A, b, c, chunk)
    assert ssd_kern.COUNTS["ssd_chunk"] == before + 1
    want = ref.ssd_chunk_ref(*ops.chunk_layout(x, dt, A, b, c, chunk))
    torch.cuda.synchronize()
    _ssd_agree(got, want)
    assert all(torch.equal(g, a) for g, a in zip(
        got, ssd_kern.ssd_chunk(x, dt, A, b, c, chunk)))


@pytest.mark.cuda
def test_cuda_ssd_chunk_reads_strided_views_in_place(cuda_device):
    """The mixer's slices of the conv output: x, b, c as views of one
    (B, S, H*P + 2N) tensor, read through their row strides."""
    B, S, H, P, N, Q = 2, 64, 3, 8, 16, 32
    rng = np.random.default_rng(4)
    xbc = torch.as_tensor(rng.standard_normal((B, S, H * P + 2 * N))
                          .astype(np.float32), device=cuda_device)
    _, dt, A, _, _ = _ssd_tensors((B, S, H, P, N), cuda_device)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    assert not x.is_contiguous() and not b.is_contiguous()
    got = ssd_kern.ssd_chunk(x, dt, A, b, c, Q)
    want = ssd_kern.ssd_chunk(x.contiguous(), dt, A, b.contiguous(),
                              c.contiguous(), Q)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_ssd_chunk_scan_matches_plain_path(cuda_device):
    """The kernel path of the SSD forward against the plain chunked SSD on
    the card."""
    from repro_torch.models.ssm import ssd_chunked
    x, dt, A, b, c = _ssd_tensors((2, 512, 4, 64, 128), cuda_device, seed=5)
    D = torch.linspace(0.5, 1.5, 4, device=cuda_device)
    y, s = ops.ssd_chunk_scan(x, dt, A, b, c, D, 256)
    y_ref, s_ref = ssd_chunked(x, dt, A, b, c, D, 256)
    torch.cuda.synchronize()
    for g, w in ((y, y_ref), (s, s_ref)):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
def test_cuda_ssd_chunk_rejects_bad_inputs(cuda_device):
    x, dt, A, b, c = _ssd_tensors((1, 32, 2, 4, 8), cuda_device)
    with pytest.raises(TypeError):
        ssd_kern.ssd_chunk(x.half(), dt.half(), A, b.half(), c.half(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_kern.ssd_chunk(x.transpose(2, 3).contiguous().transpose(2, 3),
                           dt, A, b, c, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kern.ssd_chunk(x, dt, A.cpu(), b, c, 8)
    with pytest.raises(ValueError, match="at most"):
        big = torch.zeros((1, 8, 1, 256), device=cuda_device)
        ssd_kern.ssd_chunk(big, dt[:, :8, :1], A[:1], b[:, :8], c[:, :8], 8)
