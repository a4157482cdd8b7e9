"""Kernel 1's sparsifier entry (``dasha_sparsify_update``) and kernel 3 by
rows.

On the CPU: ``ref.dasha_sparsify_update_ref`` (the chain the card's one
launch replaces: the support built from indices or a mask, a per-row scale
folded in, ``dasha_update``) against the reference's ``fused`` backend on
plans drawn by ``repro`` (its Pallas kernel in interpret mode, as the
reference's own tests run it); the port's ``fused`` backend and the tree
path bit-equal to the chains they ran before (signed zeros and NaN
included); ``sparsify_plan``'s grids; every plan walked block by block in
numpy as ``csrc/dasha_update.cu``'s ``rows_body`` walks it (each element
written once, support row r % s_rows, scale row r % sc_rows), bit-equal to
the plain version, and the dense-mask entry ``dasha_update`` walked the
same way on its mask; the wrappers' refusals.  On a card only: both
entries bit-equal to their plain versions at the paths' shapes and a
misaligned one.

Tolerances: against the reference, fp32 (rtol and atol 1e-6: XLA may
round the drift's ops in another order); indices and masks exactly; within
the port, bit for bit.

On a card (no JAX needed):
    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_sparsify_fused.py
"""
import numpy as np
import pytest
import torch

from repro_torch.compress import backends
from repro_torch.compress import treelevel
from repro_torch.compress.plan import (PAD, Plan, indices_to_masks,
                                       perm_partition)
from repro_torch.convert import plan_from_numpy
from repro_torch.core.rng import Draws, RoundRandom
from repro_torch.kernels import dasha_update as kern
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)


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


def _arrays(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
            for _ in range(3)]


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _port_plan(jplan):
    def arr(a):
        return None if a is None else np.asarray(a)
    scale = np.asarray(jplan.scale) if hasattr(jplan.scale, "shape") \
        else jplan.scale
    return plan_from_numpy(jplan.kind, scale, indices=arr(jplan.indices),
                           mask=arr(jplan.mask), levels=jplan.levels,
                           payload_coords=jplan.payload_coords,
                           wire_coords=jplan.wire_coords, device="cpu")


def _old_chain(plan, h_new, h, g_local, a):
    """The fused backend's sparsify and passthrough branch before the
    sparsifier entry: a dense fp32 mask, a per-node scale folded into it,
    expanded over lanes, then kernel 1's dense-mask entry."""
    if plan.kind == "passthrough":
        mask = torch.ones_like(h_new, dtype=torch.float32)
    elif plan.mask is not None:
        mask = plan.mask.to(torch.float32).contiguous()
    else:
        mask = indices_to_masks(plan.indices, h_new.shape[-1])
    if isinstance(plan.scale, torch.Tensor):
        mask = mask * plan.scale.to(torch.float32)
        kscale = 1.0
    else:
        kscale = float(plan.scale)
    if mask.shape != h_new.shape:
        mask = mask.expand(h_new.shape).contiguous()
    return ops.dasha_update(h_new.contiguous(), h.contiguous(),
                            g_local.contiguous(), mask, a, kscale)


# ---------------------------------------------------------------------------
# against the reference's fused backend
# ---------------------------------------------------------------------------

# (name, kw, mode, d): PermK at d = 23, n = 5 pads its last block (2 PAD)
REF_CASES = [("randk", dict(k=6), "independent", 24),
             ("randk", dict(k=6), "shared_coords", 24),
             ("randk", dict(k=6, p_participate=0.5), "independent", 24),
             ("permk", {}, "independent", 23),
             ("permk", {}, "permk", 23),
             ("permk", dict(p_participate=0.75), "permk", 23),
             ("bernoulli", dict(p=0.25), "independent", 24),
             ("bernoulli", dict(p=0.25), "shared_coords", 24),
             ("bernoulli", dict(p=0.5, p_participate=0.5), "independent", 24),
             ("identity", {}, "independent", 24),
             ("identity", dict(p_participate=0.5), "independent", 24)]
N_REF = 5


def _ref_plan(jax, jc, name, kw, mode, d, seed=7):
    rc = jc.make_round_compressor(name, d, N_REF, mode=mode,
                                  backend="fused", **kw)
    jplan = rc.plan(jax.random.PRNGKey(seed))
    plan = _port_plan(jplan)
    if jplan.indices is not None:
        np.testing.assert_array_equal(plan.indices.numpy(),
                                      np.asarray(jplan.indices))
    if jplan.mask is not None:
        np.testing.assert_array_equal(plan.mask.numpy(),
                                      np.asarray(jplan.mask))
    return jplan, plan


@pytest.mark.parametrize("name,kw,mode,d", REF_CASES)
def test_plain_version_matches_the_reference_fused_backend(reference, name,
                                                           kw, mode, d):
    jax, jnp, jc = reference
    jplan, plan = _ref_plan(jax, jc, name, kw, mode, d)
    h_new, h, gl = _arrays((N_REF, d), 1)
    a = 0.3
    r_msgs, r_h, r_gl = jc.backends.fused_estimator_update(
        jplan, jnp.asarray(h_new.numpy()), jnp.asarray(h.numpy()),
        jnp.asarray(gl.numpy()), a)
    indices, mask = backends._support(plan)
    scale = plan.scale if isinstance(plan.scale, torch.Tensor) \
        else float(plan.scale)
    m, h_out, g_new = ref.dasha_sparsify_update_ref(h_new, h, gl, a, scale,
                                                    indices=indices,
                                                    mask=mask)
    assert h_out is h_new
    np.testing.assert_array_equal(h_out.numpy(), np.asarray(r_h))
    np.testing.assert_allclose(m.numpy(), np.asarray(r_msgs.dense()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g_new.numpy(), np.asarray(r_gl), rtol=1e-6,
                               atol=1e-6)
    # the port's fused backend runs exactly that plain version on the CPU
    msgs, b_h, b_gl = backends.fused_estimator_update(plan, h_new, h, gl, a)
    assert b_h is h_new
    assert _bits_equal(msgs.values, m) and _bits_equal(b_gl, g_new)
    assert msgs.payload_coords == r_msgs.payload_coords
    assert msgs.wire_coords == r_msgs.wire_coords


@pytest.mark.parametrize("name,kw,mode,d", [
    ("randk", dict(k=6), "independent", 24),
    ("randk", dict(k=6, p_participate=0.5), "shared_coords", 24),
    ("permk", {}, "independent", 23),
    ("bernoulli", dict(p=0.25), "independent", 24),
    ("identity", dict(p_participate=0.5), "independent", 24)])
def test_lanes_match_the_reference_lane_by_lane(reference, name, kw, mode, d):
    """A lane axis of G = 8 x n = 5: one call on (8, 5, d), the plan's
    support and scale read at row r % 5."""
    jax, jnp, jc = reference
    G = 8
    jplan, plan = _ref_plan(jax, jc, name, kw, mode, d, seed=3)
    h_new, h, gl = _arrays((G, N_REF, d), 2)
    a = 0.125
    msgs, h_out, g_new = backends.fused_estimator_update(plan, h_new, h, gl,
                                                         a)
    assert h_out is h_new and msgs.values.shape == (G, N_REF, d)
    for g in range(G):
        r_msgs, _, r_gl = jc.backends.fused_estimator_update(
            jplan, jnp.asarray(h_new[g].numpy()), jnp.asarray(h[g].numpy()),
            jnp.asarray(gl[g].numpy()), a)
        np.testing.assert_allclose(msgs.values[g].numpy(),
                                   np.asarray(r_msgs.dense()), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(g_new[g].numpy(), np.asarray(r_gl),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# within the port: the old chains, bit for bit
# ---------------------------------------------------------------------------

def _plans(n, d, seed=0):
    """Port plans of every sparsifier route, a shared_coords RandK plan as
    the (n, k) view of one row, and coin scales with a zero node."""
    rng = np.random.default_rng(seed)
    coins = np.full((n, 1), 2.0, np.float32)
    coins[1] = 0.0
    idx = np.stack([rng.choice(d, 5, replace=False) for _ in range(n)])
    one = torch.as_tensor(rng.choice(d, 5, replace=False))[None]
    gen = torch.Generator().manual_seed(seed)
    permk = perm_partition(gen, d, n, device="cpu")
    mask = (rng.random((n, d)) < 0.3).astype(np.float32)
    return {
        "randk": plan_from_numpy("sparsify", d / 5.0, indices=idx,
                                 device="cpu"),
        "randk_coins": plan_from_numpy("sparsify", coins * (d / 5.0),
                                       indices=idx, device="cpu"),
        "randk_shared": Plan("sparsify", d / 5.0,
                                      indices=one.expand(n, 5)),
        "permk_pad": Plan("sparsify", float(n), indices=permk),
        "bernoulli": plan_from_numpy("sparsify", 1 / 0.3, mask=mask,
                                     device="cpu"),
        "bernoulli_coins": plan_from_numpy("sparsify", coins / 0.3,
                                           mask=mask, device="cpu"),
        "passthrough": Plan("passthrough", 1.0),
        "passthrough_coins": plan_from_numpy("passthrough", coins,
                                             device="cpu")}


PLAN_KINDS = ["randk", "randk_coins", "randk_shared", "permk_pad",
              "bernoulli", "bernoulli_coins", "passthrough",
              "passthrough_coins"]


@pytest.mark.parametrize("lanes", [0, 3])
@pytest.mark.parametrize("kind", PLAN_KINDS)
def test_fused_backend_on_the_cpu_equals_the_old_chain(kind, lanes):
    n, d = 5, 23
    plan = _plans(n, d)[kind]
    if kind == "permk_pad":
        assert int((plan.indices == PAD).sum()) == 2
    shape = (lanes, n, d) if lanes else (n, d)
    h_new, h, gl = _arrays(shape, 4)
    h_new.view(-1)[:3] = torch.tensor([float("nan"), -0.0, float("inf")])
    gl.view(-1)[1] = -0.0
    h.view(-1)[1] = 0.0
    a = 0.3
    msgs, h_out, g_new = backends.fused_estimator_update(plan, h_new, h, gl,
                                                         a)
    w_m, _, w_g = _old_chain(plan, h_new, h, gl, a)
    assert h_out is h_new
    assert _bits_equal(msgs.values, w_m) and _bits_equal(g_new, w_g)
    if kind.endswith("coins"):
        assert bool((msgs.values[..., 1, :] == 0).all())


def test_shared_coords_indices_go_as_one_row():
    plan = _plans(5, 23)["randk_shared"]
    indices, mask = backends._support(plan)
    assert mask is None and indices.shape == (1, 5)
    full = plan_from_numpy("sparsify", 1.0,
                           indices=plan.indices.contiguous().numpy(),
                           device="cpu")
    assert backends._support(full)[0].shape == (5, 5)


@pytest.mark.parametrize("variant", ["dasha", "mvr"])
@pytest.mark.parametrize("mode", ["independent", "shared_coords", "permk"])
def test_tree_path_equals_the_float_mask_chain(mode, variant):
    """The fused tree path hands the kernels the draw as it comes (bool,
    one row for shared_coords) and gives the results of the old path, the
    float32 mask of ``leaf_mask``, bit for bit."""
    n, p, a, b = 4, 0.3, 0.2, 0.1
    rng = np.random.default_rng(5)

    def leaf(*shape):
        return torch.as_tensor(rng.standard_normal((n,) + shape)
                               .astype(np.float32))
    gn = {"w": leaf(6, 5), "b": leaf(7), "s": leaf()}
    go, h, gl = ({k: leaf(*v.shape[1:]) for k, v in gn.items()}
                 for _ in range(3))
    rnd = RoundRandom(11, 3)
    got = treelevel.fused_tree_update(rnd, gn, h, gl, mode=mode, a=a, p=p,
                                      n=n, variant=variant, b=b,
                                      grads_old=go)
    scale = treelevel.mask_scale(mode, p, n)
    for path in gn:
        support = treelevel.leaf_support(rnd, path, gn[path], mode=mode, p=p,
                                         n=n)
        mask = treelevel.leaf_mask(rnd, path, gn[path], mode=mode, p=p, n=n)
        assert support.dtype == torch.bool
        assert support.shape[0] == (1 if mode == "shared_coords" else n)
        assert torch.equal(support.expand(gn[path].shape).float(), mask)
        if variant == "mvr":
            want = ops.dasha_mvr_update(gn[path], go[path], h[path],
                                        gl[path], mask, a, b, scale)
        else:
            want = ops.dasha_update(gn[path], h[path], gl[path], mask, a,
                                    scale)
        for tree_out, w in zip(got, want):
            assert _bits_equal(tree_out[path], w)
        if variant == "dasha":
            assert got[1][path] is gn[path]


def test_tree_path_takes_injected_float_masks():
    n = 3
    gn, h, gl = ({"w": t} for t in _arrays((n, 8), 6))
    mask = {"w": torch.as_tensor((np.arange(n * 8).reshape(n, 8) % 3 == 0)
                                 .astype(np.float32))}
    rnd = RoundRandom(0, 0, Draws(masks=mask))
    assert treelevel.leaf_support(rnd, "w", gn["w"], mode="independent",
                                  p=0.5, n=n) is mask["w"]
    m, _, g_new = treelevel.fused_tree_update(rnd, gn, h, gl,
                                              mode="independent", a=0.1,
                                              p=0.5, n=n)
    want = ops.dasha_update(gn["w"], h["w"], gl["w"], mask["w"], 0.1, 2.0)
    assert _bits_equal(m["w"], want[0]) and _bits_equal(g_new["w"], want[2])


# ---------------------------------------------------------------------------
# sparsify_plan, and every plan walked as the kernel walks it
# ---------------------------------------------------------------------------

def test_plan_runs_the_flat_round_as_one_wave():
    """(5, 20,958): odd rows start 8 bytes off 16, so float2 rows; the
    fewest threads whose blocks fit in one wave of the H100's 132 SMs."""
    plan = kern.sparsify_plan(5, 20958, False, True, "index", 100)
    assert plan.vec == 2
    assert plan.grid <= kern.H100_SMS
    assert plan.threads == 128 and plan.grid == 5 * plan.blocks_per_row
    assert plan.span == plan.threads * plan.vpt * plan.vec
    # more rows: the most threads, blocks by the row
    many = kern.sparsify_plan(64, 20958, False, True, "index", 100)
    assert many.threads == 256 and many.grid == 64 * many.blocks_per_row


@pytest.mark.parametrize("rows,cols", [(100000, 20958), (70000, 256),
                                       (2 ** 20 + 3, 4096),
                                       (5, 2 ** 31 // 5 + 7)])
def test_plan_grids_the_card_accepts(rows, cols):
    """Past 65,535 rows and past 2^31 elements (rows go on grid.x, element
    offsets are 64-bit)."""
    for form, k in (("dense", 0), ("index", 100), ("mask_u8", 0)):
        plan = kern.sparsify_plan(rows, cols, True, True, form, k)
        assert plan.grid <= kern.GRID_LIMIT
        assert plan.blocks_per_row * plan.span >= cols


def test_plan_refuses_what_no_launch_covers():
    with pytest.raises(ValueError, match="grid limit"):
        kern.sparsify_plan(2 ** 31, 4, True, True)
    with pytest.raises(ValueError, match="form"):
        kern.sparsify_plan(5, 20958, True, True, "mask_f16", 0)
    with pytest.raises(ValueError):
        kern.sparsify_plan(0, 10, True, True)


@pytest.mark.parametrize("cols", [1, 3, 60, 256, 4099, 20958, 11173962])
@pytest.mark.parametrize("form,k", [("dense", 0), ("index", 100),
                                    ("index", 4192), ("index", 2234793),
                                    ("mask_f32", 0), ("mask_u8", 0)])
def test_every_plan_covers_its_rows_within_the_kernels_limits(cols, form, k):
    for rows in (1, 3, 5, 20, 64, 70000):
        for a16, a8 in ((True, True), (False, True), (False, False)):
            p = kern.sparsify_plan(rows, cols, a16, a8, form, k)
            assert p.threads in kern.ROWS_THREADS
            assert p.span % (p.threads * p.vpt * p.vec) == 0
            assert p.grid <= kern.GRID_LIMIT
            sub = p.threads * p.vpt * p.vec
            if form == "index":
                # the k rule, unless the bitmap's room or the row stopped it
                assert p.span <= kern.ROWS_SPAN_MAX
                assert p.span * kern.ROWS_INDEX_SPAN >= k or \
                    p.span + sub > min(kern.ROWS_SPAN_MAX, cols)
            else:
                assert p.span == sub
            assert cols % p.vec == 0 and (p.vec == 1 or a8)
            assert p.vec != 4 or a16
            assert p.blocks_per_row * p.span >= cols
            assert (p.blocks_per_row - 1) * p.span < cols
            assert p.grid == rows * p.blocks_per_row


def _walk(plan, args, grad, h, gl, a, scale, support, mvr=None):
    """The launch of ``plan`` walked block by block in numpy, as
    ``rows_body`` in csrc/dasha_update.cu walks it: each block's tile
    [f0, f1) of one row, the index form's bitmap from the row's indices
    (row r % s_rows, PAD and other columns dropped) built in the block's
    first sub-tile, a mask row r % s_rows, a per-row scale r % sc_rows
    folded into the support, the ops in the plain order, h_new a copy of
    grad.  ``mvr`` = (grad_old, c): kernel 3.  Returns (m, h_new, g_new,
    hits)."""
    rows, cols = args.rows, args.cols
    total = rows * cols
    f32 = np.float32
    G, H, L = (t.reshape(-1).numpy() for t in (grad, h, gl))
    O = None if mvr is None else mvr[0].reshape(-1).numpy()
    out_m, out_h, out_g = (np.full(total, np.nan, f32) for _ in range(3))
    hits = np.zeros(total, np.int64)
    sup = None if support is None else support.numpy()
    sc = scale.reshape(-1).numpy() if isinstance(scale, torch.Tensor) \
        else None
    for blk in range(plan.grid):
        r = blk // plan.blocks_per_row
        c0 = blk % plan.blocks_per_row * plan.span
        f0, f1 = r * cols + c0, r * cols + min(c0 + plan.span, cols)
        # the kernel's first sub-tile, where the bitmap is built, runs in
        # every block: the block holds a whole vector at least
        assert f0 // plan.vec < f1 // plan.vec
        assert f0 % plan.vec == 0 and f1 % plan.vec == 0
        f = np.arange(f0, f1)
        c = f - r * cols
        if args.form == "index":
            bits = np.zeros(f1 - f0, bool)
            idx = sup[r % args.s_rows]
            idx = idx[(idx >= 0) & (idx < cols)]
            e = r * cols + idx - f0
            bits[e[(e >= 0) & (e < f1 - f0)]] = True
            mk = bits.astype(f32)
        elif args.form == "dense":
            mk = np.ones(f1 - f0, f32)
        else:
            mk = sup.reshape(-1, cols)[r % args.s_rows, c].astype(f32)
        ks = f32(scale) if sc is None else f32(1.0)
        if sc is not None:
            mk = mk * sc[r % args.sc_rows]
        g, hh, l = G[f], H[f], L[f]
        if mvr is not None:
            g = g + f32(mvr[1]) * (hh - O[f])
        out_h[f] = g
        delta = (g - hh) - f32(a) * (l - hh)
        mm = (mk * delta) * ks
        out_m[f], out_g[f] = mm, l + mm
        hits[f] += 1
    return out_m, out_h, out_g, hits


def _support_case(case, rows, cols, n, rng):
    """(indices, mask, scale) of a walk case."""
    coins = torch.full((n, 1), 2.0)
    coins[min(1, n - 1)] = 0.0
    if case == "randk":
        return torch.as_tensor(np.stack([rng.choice(cols, 100, replace=False)
                                         for _ in range(n)])), None, 209.58
    if case == "shared":
        return torch.as_tensor(rng.choice(cols, 100, replace=False))[None], \
            None, coins
    if case == "permk":
        gen = torch.Generator().manual_seed(3)
        return perm_partition(gen, cols, n, device="cpu"), \
            None, float(n)
    if case == "bernoulli":
        return None, torch.as_tensor((rng.random((n, cols)) < 0.3)
                                     .astype(np.float32)), 1 / 0.3
    if case == "bool_shared":
        return None, torch.as_tensor(rng.random((1, cols)) < 0.3), 1 / 0.3
    return None, None, coins                      # passthrough with coins


WALK_CASES = [((5, 20958), 5, "randk", ""),
              ((40, 20958), 5, "randk", ""), ((5, 20958), 5, "shared", ""),
              ((5, 20958), 5, "permk", ""),
              ((5, 20958), 5, "bernoulli", ""),
              ((4, 1536), 4, "bool_shared", ""),
              ((20, 20958), 20, "passthrough", ""),
              ((2, 1025), 2, "randk", ""),
              ((3, 4099), 3, "randk", "misaligned"),
              ((3, 4099), 3, "bernoulli", "misaligned")]


@pytest.mark.parametrize("shape,n,case,align", WALK_CASES)
def test_every_launch_walked_as_the_kernel_equals_the_plain_version(
        shape, n, case, align):
    rng = np.random.default_rng(8)
    rows, cols = shape
    grad, h, gl = _arrays(shape, 9)
    grad[0, :2] = torch.tensor([float("nan"), -0.0])
    indices, mask, scale = _support_case(case, rows, cols, n, rng)
    args = kern.sparsify_args(grad, indices, mask, scale)
    assert args.s_rows == (1 if case in ("shared", "bool_shared")
                           else n if case != "passthrough" else 1)
    misaligned = align == "misaligned"
    plan = kern.sparsify_plan(rows, cols, not misaligned, not misaligned,
                              args.form, args.k)
    support = indices if indices is not None else mask
    a = 0.0024
    m, _, g_new, hits = _walk(plan, args, grad, h, gl, a, scale, support)
    assert (hits == 1).all()
    want = ref.dasha_sparsify_update_ref(grad, h, gl, a, scale,
                                         indices=indices, mask=mask)
    assert _bits_equal(torch.as_tensor(m).view(shape), want[0])
    assert _bits_equal(torch.as_tensor(g_new).view(shape), want[2])


@pytest.mark.parametrize("shape,misaligned", [((5, 20958), False),
                                              ((20, 20958), False),
                                              ((3, 4099), True),
                                              ((1, 3), False)])
def test_dense_mask_entry_walked_as_the_kernel_equals_the_plain_version(
        shape, misaligned):
    """``dasha_update`` launches the same rows kernel on its fp32 mask
    (s_rows = rows, a float scale) and writes h_new as a copy of grad."""
    rng = np.random.default_rng(13)
    grad, h, gl = _arrays(shape, 14)
    grad[0, :2] = torch.tensor([float("nan"), -0.0])
    mask = torch.as_tensor((rng.random(shape) < 0.3).astype(np.float32))
    args = kern.RowsArgs(shape[0], shape[1], "mask_f32", shape[0], 0, 0)
    plan = kern.sparsify_plan(*shape, not misaligned, not misaligned,
                              "mask_f32")
    m, h_new, g_new, hits = _walk(plan, args, grad, h, gl, 0.0024, 209.58,
                                  mask)
    assert (hits == 1).all()
    want = ref.dasha_update_ref(grad, h, gl, mask, 0.0024, 209.58)
    for got, w in zip((m, h_new, g_new), want):
        assert _bits_equal(torch.as_tensor(got).view(shape), w)


@pytest.mark.parametrize("shape,s_rows,dtype", [
    ((4, 20958), 4, torch.bool), ((4, 20958), 1, torch.bool),
    ((4, 1536), 4, torch.float32), ((3, 4099), 3, torch.uint8),
    ((1, 3), 1, torch.bool)])
def test_kernel3_launch_walked_as_the_kernel_equals_the_plain_version(
        shape, s_rows, dtype):
    rng = np.random.default_rng(10)
    gn, h, gl = _arrays(shape, 11)
    go, _, _ = _arrays(shape, 12)
    mask = torch.as_tensor(rng.random((s_rows, shape[1])) < 0.4).to(dtype)
    args = kern.mvr_args(gn, mask)
    assert (args.rows, args.cols, args.s_rows) == (shape[0], shape[1],
                                                   s_rows)
    plan = kern.sparsify_plan(args.rows, args.cols, shape[1] % 4 == 0, True,
                              args.form, 0)
    a, b, scale = 0.0024, 0.1, 32.0
    m, h_new, g_new, hits = _walk(plan, args, gn, h, gl, a, scale, mask,
                                  mvr=(go, 1.0 - b))
    assert (hits == 1).all()
    want = ref.dasha_mvr_update_ref(gn, go, h, gl, mask, a, b, scale)
    for got, w in zip((m, h_new, g_new), want):
        assert _bits_equal(torch.as_tensor(got).view(shape), w)


# ---------------------------------------------------------------------------
# the wrappers' refusals
# ---------------------------------------------------------------------------

def test_arguments_are_refused_on_any_device():
    t = torch.zeros((6, 8))
    idx = torch.zeros((3, 2), dtype=torch.int64)
    with pytest.raises(TypeError, match="int64"):
        kern.sparsify_args(t, indices=idx.int())
    with pytest.raises(ValueError, match="contiguous"):
        kern.sparsify_args(t, indices=idx[:, 0])
    with pytest.raises(ValueError, match="do not divide"):
        kern.sparsify_args(t, indices=torch.zeros((4, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="not both"):
        kern.sparsify_args(t, indices=idx, mask=t)
    with pytest.raises(TypeError, match="mask"):
        kern.sparsify_args(t, mask=t.double())
    with pytest.raises(ValueError, match="do not divide"):
        kern.sparsify_args(t, mask=torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="mask"):
        kern.sparsify_args(t, mask=torch.zeros((6, 4)))
    with pytest.raises(TypeError, match="float32"):
        kern.sparsify_args(t, scale=torch.ones((6, 1), dtype=torch.float64))
    with pytest.raises(ValueError, match="do not divide"):
        kern.sparsify_args(t, scale=torch.ones((4, 1)))
    with pytest.raises(ValueError, match="per-row"):
        kern.sparsify_args(t, scale=torch.ones((6, 2)))
    with pytest.raises(ValueError):
        kern.mvr_args(t, t[:, :4].contiguous())
    with pytest.raises(ValueError, match="do not divide"):
        kern.mvr_args(t, torch.zeros((4, 8), dtype=torch.bool))
    with pytest.raises(TypeError):
        kern.mvr_args(t, t.int())
    ok = kern.sparsify_args(torch.zeros((8, 6, 8)), indices=idx,
                            scale=torch.ones(6))
    assert ok == kern.RowsArgs(48, 8, "index", 3, 2, 6)


def test_wrappers_refuse_cpu_tensors_and_launch_nothing():
    t = torch.zeros((2, 4))
    idx = torch.zeros((2, 1), dtype=torch.int64)
    kern.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kern.dasha_sparsify_update(t, t, t, 0.1, 1.0, indices=idx)
    with pytest.raises(ValueError, match="CUDA"):
        kern.dasha_sparsify_update(t, t, t, 0.1, 1.0, mask=t)
    with pytest.raises(ValueError, match="CUDA"):
        kern.dasha_mvr_update(t, t, t, t, t.bool(), 0.1, 0.5, 1.0)
    assert kern.COUNTS == {"dasha_update": 0, "dasha_sparsify_update": 0,
                           "dasha_mvr_update": 0, "quantize": 0}


def test_dispatch_refuses_devices_without_a_kernel():
    """A ``meta`` tensor (a dry run's) takes the plain version: shapes out,
    nothing launched."""
    t = torch.zeros((2, 4), device="meta")
    kern.reset_counts()
    out = ops.dasha_sparsify_update(t, t, t, 0.1, 1.0)
    assert all(o.device.type == "meta" and o.shape == (2, 4) for o in out)
    assert not any(kern.COUNTS.values())


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

def _on(device, t, misalign=False):
    off = int(misalign)
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=device)
    buf[off:] = t.reshape(-1).to(device)
    return buf[off:].view(t.shape)


CARD_CASES = [((5, 20958), 5, "randk", ""),
              ((20, 20958), 20, "passthrough", ""),
              ((40, 20958), 5, "randk", ""), ((2, 1025), 2, "randk", ""),
              ((5, 20958), 5, "shared", ""), ((5, 20958), 5, "permk", ""),
              ((5, 20958), 5, "bernoulli", ""),
              ((4, 1536), 4, "bool_shared", ""),
              ((3, 4099), 3, "randk", "misaligned"),
              ((3, 4099), 3, "bernoulli", "misaligned"),
              ((1, 3), 1, "passthrough", "")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n,case,align", CARD_CASES)
def test_cuda_sparsify_entry_bit_equal_to_plain(cuda_device, shape, n, case,
                                                align):
    rng = np.random.default_rng(8)
    misalign = align == "misaligned"
    grad, h, gl = (_on(cuda_device, t, misalign) for t in _arrays(shape, 9))
    indices, mask, scale = _support_case(case, shape[0], shape[1], n, rng)
    indices, mask = (None if t is None else _on(cuda_device, t, misalign)
                     for t in (indices, mask))
    if isinstance(scale, torch.Tensor):
        scale = scale.to(cuda_device)
    before = kern.COUNTS["dasha_sparsify_update"]
    got = kern.dasha_sparsify_update(grad, h, gl, 0.0024, scale,
                                     indices=indices, mask=mask)
    again = kern.dasha_sparsify_update(grad, h, gl, 0.0024, scale,
                                       indices=indices, mask=mask)
    assert kern.COUNTS["dasha_sparsify_update"] == before + 2
    want = ref.dasha_sparsify_update_ref(grad, h, gl, 0.0024, scale,
                                         indices=indices, mask=mask)
    torch.cuda.synchronize()
    assert got[1] is grad
    for g, a, w in zip(got, again, want):
        assert _bits_equal(g, w) and _bits_equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,s_rows,dtype,misalign", [
    ((4, 20958), 4, torch.bool, False), ((4, 20958), 1, torch.bool, False),
    ((4, 1536), 1, torch.uint8, False), ((4, 1536), 4, torch.float32, False),
    ((3, 4099), 3, torch.bool, True), ((1, 3), 1, torch.bool, False)])
def test_cuda_mvr_byte_mask_bit_equal_to_plain(cuda_device, shape, s_rows,
                                               dtype, misalign):
    rng = np.random.default_rng(10)
    gn, h, gl = (_on(cuda_device, t, misalign) for t in _arrays(shape, 11))
    go = _on(cuda_device, _arrays(shape, 12)[0], misalign)
    mask = _on(cuda_device, torch.as_tensor(
        rng.random((s_rows, shape[1])) < 0.4).to(dtype))
    for b in (0.1, 0.0):
        got = kern.dasha_mvr_update(gn, go, h, gl, mask, 0.0024, b, 32.0)
        want = ref.dasha_mvr_update_ref(gn, go, h, gl, mask, 0.0024, b, 32.0)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert _bits_equal(g, w)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs_and_launch_nothing(cuda_device):
    t = torch.zeros((4, 8), device=cuda_device)
    idx = torch.zeros((2, 3), dtype=torch.int64, device=cuda_device)
    kern.reset_counts()
    with pytest.raises(TypeError):
        kern.dasha_sparsify_update(t.double(), t.double(), t.double(), 0.1,
                                   1.0, indices=idx)
    with pytest.raises(TypeError):
        kern.dasha_sparsify_update(t, t, t, 0.1, 1.0, indices=idx.int())
    with pytest.raises(ValueError):
        kern.dasha_sparsify_update(t, t, t, 0.1, 1.0, indices=idx[0])
    with pytest.raises(ValueError):
        kern.dasha_sparsify_update(t, t, t, 0.1, 1.0,
                                   indices=idx.new_zeros((3, 3)))
    with pytest.raises(ValueError):
        kern.dasha_sparsify_update(t, t, t, 0.1, 1.0, indices=idx.cpu())
    with pytest.raises(ValueError):
        kern.dasha_mvr_update(t, t, t, t, t[:3].bool(), 0.1, 0.5, 1.0)
    assert kern.COUNTS == {"dasha_update": 0, "dasha_sparsify_update": 0,
                           "dasha_mvr_update": 0, "quantize": 0}
