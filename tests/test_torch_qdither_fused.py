"""Kernel 2 (row-wise QSGD) and the fused QDither estimator update.

On the CPU: ``ref.dasha_quantize_update_ref`` and the ``fused`` backend's
dither branch equal the unfused chain they replace bit for bit (signed
zeros included); the port's fused update on an injected reference plan
against the reference's ``fused_estimator_update`` (its Pallas kernel in
interpret mode, as the reference's own tests run it); kernel 2's plan;
the wrappers' refusals.  On a card only: every plan path against the plain
version by the one-level rule, two launches bit-identical, the cluster
kernels of 8 vectors a thread and the plans of a card that schedules
clusters of 8 only (forced), more than 65,535 rows, and the fused entry's
delta, m and g_new.

Tolerances: the kernel, torch and XLA sum a row's squares in different
orders, so a norm can differ in the last ulp: outputs agree to a few ulp
except one-level flips where a uniform lies within 1e-5 of ``y -
floor(y)`` (``quantize_agreement``, scaled by the plan scale for m); g_new
is then within 1e-6 where no element flipped.  On the card the fused
entry's delta is exact: the plain kernel on the torch chain's delta, by
the fused entry's own plan, gives its m bit for bit.

On a card (no JAX needed):
    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_qdither_fused.py
"""
import numpy as np
import pytest
import torch

from repro_torch.compress import backends
from repro_torch.convert import plan_from_numpy
from repro_torch.kernels import dasha_update as kern
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

LEVELS = 15


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def reference():
    """The reference's compression package, imported here so that the card
    tests of this file run where JAX is not installed."""
    import jax
    import jax.numpy as jnp
    from repro import compress as jc
    return jax, jnp, jc


def _arrays(shape, seed=0, n=None):
    """h_new, h, g_local of ``shape`` and (n, d) uniforms."""
    rng = np.random.default_rng(seed)
    h_new, h, gl = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(3))
    n = shape[-2] if n is None else n
    u = rng.random((n, shape[-1])).astype(np.float32)
    return h_new, h, gl, u


def _unfused_chain(h_new, h, g_local, u, a, scale, levels):
    """The fused backend's dither branch before the fused entry: torch
    delta, the quantize dispatch on (rows, d), * scale, + g_local."""
    delta = h_new - h - a * (g_local - h)
    rows = delta.reshape(-1, delta.shape[-1])
    uu = u.expand(delta.shape).reshape(rows.shape)
    m = ops.quantize_with_u(rows, uu, levels).view(delta.shape) * scale
    return m, h_new, g_local + m


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _scale(kind, n):
    if kind == "scalar":
        return 1.0
    if kind == "float":
        return 2.5
    s = np.full((n, 1), 2.0, np.float32)
    s[1] = 0.0                       # a node that sat the round out
    return torch.as_tensor(s)


CASES = [((5, 40), "scalar", False), ((5, 40), "float", False),
         ((4, 33), "coins", False), ((3, 4, 24), "scalar", False),
         ((3, 4, 24), "coins", False), ((5, 40), "coins", True),
         ((2, 5, 17), "float", True)]


@pytest.mark.parametrize("shape,scale_kind,zero_row", CASES)
def test_plain_version_equals_the_unfused_chain(shape, scale_kind,
                                                zero_row):
    h_new, h, gl, u = (torch.as_tensor(x) for x in _arrays(shape, 1))
    if zero_row:                      # delta = 0 on one row: zeros out
        h[..., 0, :] = h_new[..., 0, :]
        gl[..., 0, :] = h_new[..., 0, :]
    scale = _scale(scale_kind, shape[-2])
    a = 0.0371
    want = _unfused_chain(h_new, h, gl, u, a, scale, LEVELS)
    got = ref.dasha_quantize_update_ref(h_new, h, gl, u, a, scale, LEVELS)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    assert got[1] is h_new
    if zero_row:
        assert bool((got[0][..., 0, :] == 0).all())
    if scale_kind == "coins":
        assert bool((got[0][..., 1, :] == 0).all())
        assert _bits_equal(got[2][..., 1, :], gl[..., 1, :])


@pytest.mark.parametrize("shape,scale_kind,zero_row", CASES)
def test_fused_backend_on_the_cpu_equals_the_unfused_chain(shape, scale_kind,
                                                           zero_row):
    h_new, h, gl, u = (torch.as_tensor(x) for x in _arrays(shape, 2))
    if zero_row:
        h[..., 0, :] = h_new[..., 0, :]
        gl[..., 0, :] = h_new[..., 0, :]
    scale = _scale(scale_kind, shape[-2])
    plan = plan_from_numpy("dither", scale, dither_u=u.numpy(),
                           levels=LEVELS, payload_coords=3.0,
                           wire_coords=3.0, device="cpu")
    a = 0.25
    msgs, h_out, g_new = backends.fused_estimator_update(plan, h_new, h, gl,
                                                         a)
    want = _unfused_chain(h_new, h, gl, plan.dither_u, a, plan.scale,
                          LEVELS)
    assert _bits_equal(msgs.values, want[0])
    assert h_out is h_new
    assert _bits_equal(g_new, want[2])
    assert msgs.payload_coords == 3.0
    assert msgs.wire_coords == float(shape[-1])


@pytest.mark.parametrize("p_participate", [1.0, 0.5])
@pytest.mark.parametrize("s,d", [(15, 24), (3, 130), (1, 7)])
def test_fused_dither_matches_the_reference(reference, p_participate, s, d):
    jax, jnp, jc = reference
    n = 6
    rc = jc.make_round_compressor("qdither", d, n, s=s, backend="fused",
                                  p_participate=p_participate)
    jplan = rc.plan(jax.random.PRNGKey(11))
    scale = np.asarray(jplan.scale) if hasattr(jplan.scale, "shape") \
        else jplan.scale
    plan = plan_from_numpy("dither", scale,
                           dither_u=np.asarray(jplan.dither_u),
                           levels=jplan.levels,
                           payload_coords=jplan.payload_coords,
                           wire_coords=jplan.wire_coords, device="cpu")
    h_new, h, gl, _ = _arrays((n, d), 3 + s)
    h_new[0] = h[0] = gl[0] = 0.0           # a zero row
    a = 0.125
    r_msgs, r_h, r_gl = jc.backends.fused_estimator_update(
        jplan, jnp.asarray(h_new), jnp.asarray(h), jnp.asarray(gl), a)
    msgs, h_out, g_new = backends.fused_estimator_update(
        plan, torch.as_tensor(h_new), torch.as_tensor(h),
        torch.as_tensor(gl), a)
    np.testing.assert_array_equal(h_out.numpy(), np.asarray(r_h))
    delta = torch.as_tensor(h_new - h - np.float32(a) * (gl - h))
    agree = kern.quantize_agreement(
        msgs.values, torch.as_tensor(np.array(r_msgs.dense())), delta,
        plan.dither_u, plan.levels, scale=plan.scale)
    assert agree["ok"], agree
    assert bool((msgs.values[0] == 0).all())
    if agree["flips"] == 0:
        np.testing.assert_allclose(g_new.numpy(), np.asarray(r_gl),
                                   rtol=1e-6, atol=1e-6)


def test_fused_dither_lanes_match_the_reference_lane_by_lane(reference):
    jax, jnp, jc = reference
    G, n, d = 3, 4, 50
    rc = jc.make_round_compressor("qdither", d, n, s=7, backend="fused")
    jplan = rc.plan(jax.random.PRNGKey(5))
    plan = plan_from_numpy("dither", jplan.scale,
                           dither_u=np.asarray(jplan.dither_u),
                           levels=jplan.levels,
                           payload_coords=jplan.payload_coords,
                           wire_coords=jplan.wire_coords, device="cpu")
    h_new, h, gl, _ = _arrays((G, n, d), 9)
    a = 0.5
    msgs, _, g_new = backends.fused_estimator_update(
        plan, torch.as_tensor(h_new), torch.as_tensor(h),
        torch.as_tensor(gl), a)
    for g in range(G):
        r_msgs, _, r_gl = jc.backends.fused_estimator_update(
            jplan, jnp.asarray(h_new[g]), jnp.asarray(h[g]),
            jnp.asarray(gl[g]), a)
        delta = torch.as_tensor(h_new[g] - h[g] - np.float32(a)
                                * (gl[g] - h[g]))
        agree = kern.quantize_agreement(
            msgs.values[g], torch.as_tensor(np.array(r_msgs.dense())),
            delta, plan.dither_u, plan.levels)
        assert agree["ok"], (g, agree)
        if agree["flips"] == 0:
            np.testing.assert_allclose(g_new[g].numpy(), np.asarray(r_gl),
                                       rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# kernel 2's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols,a16,a8,vec,blocks", [
    (5, 20958, False, True, 2, 80),      # odd rows start 8 bytes off 16
    (20, 20958, False, True, 2, 320),
    (64, 20958, False, True, 2, 1024),
    (5, 4096, True, True, 4, 40),
    (3, 4099, False, False, 1, 48),      # the misaligned ragged rows
    (5, 60, True, True, 4, 5),
    (50, 256, True, True, 4, 50)])
def test_plan_takes_the_cluster_path_at_the_main_paths_widths(
        rows, cols, a16, a8, vec, blocks):
    plan = kern.quantize_plan(rows, cols, a16, a8)
    assert not plan.two_pass
    assert plan.vec == vec
    assert plan.grid == blocks == rows * plan.blocks_per_row
    assert plan.capacity >= cols


def test_plan_spreads_a_short_row_over_the_largest_cluster():
    for rows in (5, 20, 64):
        plan = kern.quantize_plan(rows, 20958, False, True)
        assert plan.blocks_per_row == 16 and plan.vpt * plan.vec == 8
    # a card that refuses clusters of 16 gets 8
    eight = kern.quantize_plan(5, 20958, False, True, 8)
    assert eight.blocks_per_row == 8 and eight.capacity >= 20958
    # each block keeps at least QUANT_MIN_PER_BLOCK vectors
    assert kern.quantize_plan(5, 4096, True, True).per_block == \
        kern.QUANT_MIN_PER_BLOCK
    # a row of a few hundred elements: one block a row, no cluster
    assert kern.quantize_plan(1000, 256, True, True).blocks_per_row == 1


def test_plan_keeps_two_passes_for_the_resnet18_width():
    plan = kern.quantize_plan(5, 11173962, False, True)
    assert plan.two_pass and plan.vec == 2
    assert plan.per_block * plan.vec == kern.QUANT_WIDE_CHUNK
    assert plan.blocks_per_row == -(-11173962 // kern.QUANT_WIDE_CHUNK)
    assert plan.capacity >= 11173962
    assert plan == kern.quantize_two_pass_plan(5, 11173962, False, True)


@pytest.mark.parametrize("rows,cols,a16,a8,max_cluster,vec,blocks", [
    (5, 100000, True, True, 16, 4, 16),      # float4
    (3, 30001, False, False, 16, 1, 16),     # scalar
    (5, 20958, False, True, 8, 2, 8),        # a card without clusters of 16
    (20, 20958, False, True, 8, 2, 8)])
def test_plan_takes_eight_vectors_a_thread_below_the_cluster_capacity(
        rows, cols, a16, a8, max_cluster, vec, blocks):
    plan = kern.quantize_plan(rows, cols, a16, a8, max_cluster)
    assert not plan.two_pass
    assert (plan.vec, plan.vpt, plan.blocks_per_row) == (vec, 8, blocks)
    assert plan.vpt == kern.QUANT_MAX_VPT
    assert plan.capacity >= cols


@pytest.mark.parametrize("cols,a16,a8,vec", [
    (131072, True, True, 4), (65536, False, True, 2), (32768, False, False, 1)])
def test_plan_takes_two_passes_just_past_the_cluster_capacity(cols, a16, a8,
                                                              vec):
    """A cluster of 16 holds 8 vectors a thread: 131,072 floats a row with
    float4, 65,536 with float2 and 32,768 scalar; one vector more takes the
    two-pass path."""
    at = kern.quantize_plan(5, cols, a16, a8)
    assert not at.two_pass and at.vec == vec and at.capacity == cols
    past = kern.quantize_plan(5, cols + vec, a16, a8)
    assert past.two_pass and past.vec == vec
    # a card that schedules clusters of 8 holds half as much
    assert kern.quantize_plan(5, cols // 2, a16, a8, 8).capacity == cols // 2
    assert kern.quantize_plan(5, cols // 2 + vec, a16, a8, 8).two_pass


@pytest.mark.parametrize("cols", [20958, 256, 11173962])
def test_plan_for_100000_rows_gives_a_grid_the_card_accepts(cols):
    plan = kern.quantize_plan(100000, cols, False, True)
    assert plan.grid == 100000 * plan.blocks_per_row <= kern.GRID_LIMIT
    assert plan.capacity >= cols


def test_plan_refuses_a_grid_past_the_card_limit():
    with pytest.raises(ValueError, match="grid limit"):
        kern.quantize_two_pass_plan(2 ** 30, 50000, True, True)


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("cols", [1, 2, 60, 256, 4096, 4099, 20958, 65536,
                                  65537, 131072, 131073, 11173962])
def test_every_plan_covers_its_rows_within_the_kernels_limits(cols,
                                                              max_cluster):
    for rows in (1, 3, 5, 20, 64, 133, 65600):
        for a16, a8 in ((True, True), (False, True), (False, False)):
            p = kern.quantize_plan(rows, cols, a16, a8, max_cluster)
            assert p.capacity >= cols, p
            assert cols % p.vec == 0 and (p.vec == 1 or a8), p
            assert p.vec != 4 or a16, p
            assert p.two_pass or 1 <= p.blocks_per_row <= max_cluster <= 16
            assert p.grid == rows * p.blocks_per_row <= kern.GRID_LIMIT
            assert p.threads % 32 == 0 and 32 <= p.threads <= 256, p
            if p.two_pass:
                assert p.per_block * p.vec == kern.QUANT_WIDE_CHUNK
            else:
                assert p.vpt & (p.vpt - 1) == 0, p
                assert p.vpt <= kern.QUANT_MAX_VPT, p
                assert p.vpt * p.vec <= kern.QUANT_MAX_ELEMS, p
                assert p.per_block <= p.vpt * p.threads, p


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------

def test_fused_wrapper_refuses_cpu_tensors_and_counts_nothing():
    t = torch.zeros((2, 4))
    kern.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kern.dasha_quantize_update(t, t, t, t, 0.1, 1.0, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kern.quantize(t, t, 3)
    plan = kern.quantize_two_pass_plan(2, 4, True, True)
    with pytest.raises(ValueError, match="CUDA"):
        kern._quantize_with_plan(t, t, 3, plan)
    with pytest.raises(ValueError, match="CUDA"):
        kern._dasha_quantize_update_with_plan(t, t, t, t, 0.1, 1.0, 3, plan)
    assert kern.COUNTS == {"dasha_update": 0, "dasha_sparsify_update": 0,
                           "dasha_mvr_update": 0, "quantize": 0}


def test_dispatch_refuses_devices_without_a_kernel():
    """A ``meta`` tensor (a dry run's) takes the plain version: shapes out,
    nothing launched."""
    t = torch.zeros((2, 4), device="meta")
    kern.reset_counts()
    out = ops.dasha_quantize_update(t, t, t, t, 0.1, 1.0, 3)
    assert all(o.device.type == "meta" and o.shape == (2, 4) for o in out)
    assert not any(kern.COUNTS.values())


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

def _on(device, *arrays):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _misaligned(device, a):
    """``a`` on the card one float past a 16-byte boundary."""
    buf = torch.empty(a.size + 1, device=device)
    buf[1:] = torch.as_tensor(a.reshape(-1), device=device)
    return buf[1:].view(a.shape)


def _check_quantize(x, u, plan=None):
    got = kern.quantize(x, u, LEVELS) if plan is None \
        else kern._quantize_with_plan(x, u, LEVELS, plan)
    again = kern.quantize(x, u, LEVELS) if plan is None \
        else kern._quantize_with_plan(x, u, LEVELS, plan)
    torch.cuda.synchronize()
    agree = kern.quantize_agreement(got, ref.quantize_ref(x, u, LEVELS), x,
                                    u, LEVELS)
    assert agree["ok"], agree
    assert torch.equal(got, again)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 20958), (20, 20958), (64, 20958),
                                   (5, 4096), (5, 60), (7, 256), (1, 1)])
def test_cuda_cluster_path_follows_one_level_rule(cuda_device, shape):
    rng = np.random.default_rng(3)
    x, u = _on(cuda_device, rng.standard_normal(shape).astype(np.float32),
               rng.random(shape).astype(np.float32))
    if shape[0] > 1:
        x[1] = 0.0
    got = _check_quantize(x, u)
    if shape[0] > 1:
        assert bool((got[1] == 0).all())


@pytest.mark.cuda
def test_cuda_scalar_path_on_misaligned_rows(cuda_device):
    rng = np.random.default_rng(4)
    x = _misaligned(cuda_device,
                    rng.standard_normal((3, 4099)).astype(np.float32))
    u = _misaligned(cuda_device, rng.random((3, 4099)).astype(np.float32))
    _check_quantize(x, u)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 20958), (2, 200003), (3, 262144)])
def test_cuda_two_pass_path_follows_one_level_rule(cuda_device, shape):
    rng = np.random.default_rng(5)
    x, u = _on(cuda_device, rng.standard_normal(shape).astype(np.float32),
               rng.random(shape).astype(np.float32))
    plan = kern.quantize_two_pass_plan(*shape, x.data_ptr() % 16 == 0,
                                       x.data_ptr() % 8 == 0)
    _check_quantize(x, u, plan)
    if kern.quantize_plan(*shape, True, True).two_pass:
        _check_quantize(x, u)


@pytest.mark.cuda
def test_cuda_more_than_65535_rows(cuda_device):
    rng = np.random.default_rng(6)
    shape = (65600, 256)
    x, u = _on(cuda_device, rng.standard_normal(shape).astype(np.float32),
               rng.random(shape).astype(np.float32))
    _check_quantize(x, u)
    _check_quantize(x, u, kern.quantize_two_pass_plan(*shape, True, True))


# the cluster kernels that hold 8 vectors a thread (max_cluster 16: this
# card's plan), and the plans of a card that schedules clusters of 8 only
# (max_cluster 8, forced)
LARGEST_PLANS = [((5, 100000), False, 16), ((3, 30001), True, 16),
                  ((5, 20958), False, 8), ((5, 4096), False, 8),
                  ((3, 4099), True, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,misaligned,max_cluster", LARGEST_PLANS)
def test_cuda_cluster_kernels_at_their_largest_plans(cuda_device, shape,
                                                     misaligned, max_cluster):
    rng = np.random.default_rng(8)
    x, u = (rng.standard_normal(shape).astype(np.float32),
            rng.random(shape).astype(np.float32))
    x, u = (_misaligned(cuda_device, x), _misaligned(cuda_device, u)) \
        if misaligned else _on(cuda_device, x, u)
    plan = kern.quantize_plan(*shape, kern._aligned((x, u), 16),
                              kern._aligned((x, u), 8), max_cluster)
    assert not plan.two_pass and plan.blocks_per_row == max_cluster
    _check_quantize(x, u, plan)


def _fused_case(device, shape, n, scale_kind, seed):
    h_new, h, gl, u = _on(device, *_arrays(shape, seed, n))
    scale = _scale(scale_kind, n)
    if isinstance(scale, torch.Tensor):
        scale = scale.to(device)
    return h_new, h, gl, u, scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape,scale_kind", [
    ((5, 20958), "scalar"), ((20, 20958), "float"), ((8, 5, 20958), "scalar"),
    ((5, 20958), "coins"), ((8, 5, 4096), "coins"),
    ((4, 3, 150000), "coins"), ((3, 200003), "float")])
def test_cuda_fused_entry_delta_m_and_g_new(cuda_device, shape, scale_kind):
    """Rows of 150,000 and 200,003 are wider than a cluster holds: the
    two-pass path, with lanes and coins, and with scalar loads."""
    n = shape[-2]
    h_new, h, gl, u, scale = _fused_case(cuda_device, shape, n, scale_kind,
                                         7)
    a = 0.0371
    d = shape[-1]
    rows = h_new.numel() // d
    m, h_out, g_new = kern.dasha_quantize_update(h_new, h, gl, u, a, scale,
                                                 LEVELS)
    again = kern.dasha_quantize_update(h_new, h, gl, u, a, scale, LEVELS)
    pm, _, pg = ref.dasha_quantize_update_ref(h_new, h, gl, u, a, scale,
                                              LEVELS)
    torch.cuda.synchronize()
    assert h_out is h_new
    assert torch.equal(m, again[0]) and torch.equal(g_new, again[2])
    assert _bits_equal(g_new, gl + m)
    delta = (h_new - h - a * (gl - h)).reshape(rows, d)
    uu = u.expand(h_new.shape).reshape(rows, d)
    sc = scale if not isinstance(scale, torch.Tensor) \
        else scale.expand(h_new.shape[:-1] + (1,)).reshape(rows, 1)
    agree = kern.quantize_agreement(m.reshape(rows, d), pm.reshape(rows, d),
                                    delta, uu, LEVELS, scale=sc)
    assert agree["ok"], agree
    # the kernel's delta is the chain's bit for bit: the plain kernel on
    # the chain's delta by the same plan gives the same m
    plan = kern._plan_for(rows, d, (h_new, h, gl, u, m, g_new))
    assert plan.two_pass == (d > 131072)
    q = kern._quantize_with_plan(delta.contiguous(), u.reshape(-1, d),
                                 LEVELS, plan)
    assert _bits_equal(m.reshape(rows, d), q * sc)
    if agree["flips"] == 0:
        torch.testing.assert_close(g_new, pg, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_cluster,scale_kind", [
    ((5, 100000), 16, "coins"), ((5, 20958), 8, "scalar"),
    ((8, 5, 20958), 8, "coins")])
def test_cuda_fused_entry_at_its_largest_cluster_plans(cuda_device, shape,
                                                       max_cluster,
                                                       scale_kind):
    """float4 with 8 vectors a thread, and float2 by the plan of a card
    that schedules clusters of 8 only, forced through the private entry."""
    n, d = shape[-2], shape[-1]
    h_new, h, gl, u, scale = _fused_case(cuda_device, shape, n, scale_kind,
                                         9)
    a = 0.0371
    rows = h_new.numel() // d
    plan = kern.quantize_plan(rows, d, kern._aligned((h_new, h, gl, u), 16),
                              kern._aligned((h_new, h, gl, u), 8),
                              max_cluster)
    assert not plan.two_pass and plan.vpt == 8
    m, h_out, g_new = kern._dasha_quantize_update_with_plan(
        h_new, h, gl, u, a, scale, LEVELS, plan)
    again = kern._dasha_quantize_update_with_plan(h_new, h, gl, u, a, scale,
                                                  LEVELS, plan)
    pm, _, _ = ref.dasha_quantize_update_ref(h_new, h, gl, u, a, scale,
                                             LEVELS)
    torch.cuda.synchronize()
    assert h_out is h_new
    assert torch.equal(m, again[0]) and torch.equal(g_new, again[2])
    assert _bits_equal(g_new, gl + m)
    delta = (h_new - h - a * (gl - h)).reshape(rows, d)
    sc = scale if not isinstance(scale, torch.Tensor) \
        else scale.expand(h_new.shape[:-1] + (1,)).reshape(rows, 1)
    agree = kern.quantize_agreement(m.reshape(rows, d), pm.reshape(rows, d),
                                    delta, u.expand(h_new.shape).reshape(
                                        rows, d), LEVELS, scale=sc)
    assert agree["ok"], agree
    q = kern._quantize_with_plan(delta.contiguous(), u, LEVELS, plan)
    assert _bits_equal(m.reshape(rows, d), q * sc)
