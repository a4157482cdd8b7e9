"""The port's compression subsystem against the reference (CPU).

* spec formulas (omega, density, payload, wire) equal ``repro``'s for every
  compressor, mode and participation;
* with the reference's plans injected, the port's dense / sparse / fused
  backends give the reference's messages, aggregates and g_i updates;
* inside the port: sparse == dense bit for bit, and the invariant cube
  g == mean_i g_i over 4 variants x 3 modes x 3 backends;
* the port's own draws, by distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_common import (D, N, jax_stoch_problem, port_plan,
                          stoch_arrays, torch_glm_loss, torch_stoch_problem,
                          glm_arrays)

from repro import compress as jc
from repro_torch import compress as tc
from repro_torch.kernels.dasha_update import quantize_agreement

torch.set_num_threads(1)

SPEC_CASES = [("identity", {}), ("randk", dict(k=6)), ("permk", dict(n=N)),
              ("bernoulli", dict(p=0.25)), ("qdither", dict(s=7)),
              ("randk", dict(k=6, p_participate=0.5)),
              ("permk", dict(n=N, p_participate=0.75))]


@pytest.mark.parametrize("name,kw", SPEC_CASES)
def test_spec_formulas_match_reference(name, kw):
    ref = jc.make_spec(name, D, **kw)
    port = tc.make_spec(name, D, **kw)
    assert port.omega == ref.omega
    assert port.expected_density == ref.expected_density
    assert port.payload_coords == ref.payload_coords
    assert tc.REGISTRY[name].modes == jc.REGISTRY[name].modes
    for mode in tc.REGISTRY[name].modes:
        assert port.wire_coords(mode) == ref.wire_coords(mode)
        assert port.wire_bits(mode) == ref.wire_bits(mode)


def test_omega_calculus_matches_reference():
    for w in (0.0, 0.5, 3.0, 99.0):
        assert tc.momentum_a(w) == jc.momentum_a(w)
        assert tc.omega_participation(w, 0.3) == jc.omega_participation(w,
                                                                         0.3)
    assert tc.omega_bernoulli(0.2) == jc.omega_bernoulli(0.2)
    assert tc.omega_permk(7) == jc.omega_permk(7)


def test_registry_and_modes_raise_like_reference():
    with pytest.raises(ValueError):
        tc.make_spec("nope", D)
    with pytest.raises(ValueError):
        tc.make_round_compressor("qdither", D, N, mode="permk", device="cpu")
    with pytest.raises(ValueError):
        tc.make_round_compressor("randk", D, N, k=3, backend="x",
                                 device="cpu")
    with pytest.raises(ValueError):
        tc.make_spec("randk", D, k=D + 1)


# ---------------------------------------------------------------------------
# injected reference plans: dense / sparse / fused outputs
# ---------------------------------------------------------------------------

PLAN_CASES = [("randk", dict(k=6), "independent"),
              ("randk", dict(k=6), "shared_coords"),
              ("randk", dict(k=6, p_participate=0.5), "independent"),
              ("permk", {}, "permk"), ("permk", {}, "independent"),
              ("bernoulli", dict(p=0.25), "independent"),
              ("bernoulli", dict(p=0.25), "shared_coords"),
              ("identity", {}, "independent"),
              ("qdither", dict(s=7), "independent")]


def _tensors(seed=0, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((N, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("backend", ["dense", "sparse", "fused"])
@pytest.mark.parametrize("name,kw,mode", PLAN_CASES)
def test_backends_match_reference_with_injected_plan(name, kw, mode,
                                                      backend):
    h_new, h, g_local = _tensors()
    a = 0.3
    ref_rc = jc.make_round_compressor(name, D, N, mode=mode,
                                      backend=backend, **kw)
    tc.make_round_compressor(name, D, N, mode=mode, backend=backend,
                             device="cpu", **kw)      # the port takes it too
    jplan = ref_rc.plan(jax.random.PRNGKey(7))
    plan = port_plan(jplan)
    if jplan.indices is not None:
        np.testing.assert_array_equal(plan.indices.numpy(),
                                      np.asarray(jplan.indices))
    r_msgs, r_h, r_gl = jc.backends.estimator_update_with_plan(
        backend, jplan, jnp.asarray(h_new), jnp.asarray(h),
        jnp.asarray(g_local), a)
    msgs, h_out, gl = tc.estimator_update_with_plan(
        backend, plan, torch.as_tensor(h_new), torch.as_tensor(h),
        torch.as_tensor(g_local), a)
    assert type(msgs).__name__ == type(r_msgs).__name__
    assert msgs.payload_coords == r_msgs.payload_coords
    assert msgs.wire_coords == r_msgs.wire_coords
    np.testing.assert_array_equal(h_out.numpy(), np.asarray(r_h))
    if name == "qdither":
        delta = torch.as_tensor(h_new - h - a * (g_local - h))
        agree = quantize_agreement(msgs.dense(),
                                   torch.as_tensor(np.array(
                                       r_msgs.dense())),
                                   delta, plan.dither_u, plan.levels)
        assert agree["ok"], agree
        if agree["flips"] == 0:
            np.testing.assert_allclose(gl.numpy(), np.asarray(r_gl),
                                       rtol=1e-6, atol=1e-6)
        return
    np.testing.assert_allclose(msgs.dense().numpy(),
                               np.asarray(r_msgs.dense()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(msgs.mean().numpy(), np.asarray(r_msgs.mean()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gl.numpy(), np.asarray(r_gl), rtol=1e-6,
                               atol=1e-6)
    if backend == "sparse" and jplan.indices is not None:
        np.testing.assert_array_equal(msgs.indices.numpy(),
                                      np.asarray(r_msgs.indices))


# ---------------------------------------------------------------------------
# inside the port: sparse == dense, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw,mode,d", [
    ("randk", dict(k=6), "independent", D),
    ("randk", dict(k=6), "shared_coords", D),
    ("permk", {}, "permk", D), ("permk", {}, "permk", 22),
    ("permk", {}, "independent", 22),
    ("qdither", dict(s=7), "independent", D),
    ("identity", {}, "independent", D)])
def test_sparse_messages_bit_identical_to_dense(name, kw, mode, d):
    deltas = torch.as_tensor(_tensors(3, d)[0])
    dense = tc.make_round_compressor(name, d, N, mode=mode, backend="dense",
                                     device="cpu", **kw)
    sparse = tc.make_round_compressor(name, d, N, mode=mode,
                                      backend="sparse", device="cpu", **kw)
    md, ms = dense.compress(11, deltas), sparse.compress(11, deltas)
    assert torch.equal(md.dense(), ms.dense())
    if name == "permk" and mode == "permk":
        assert int((ms.dense() != 0).sum(0).max()) <= 1


# ---------------------------------------------------------------------------
# the invariant cube, inside the port
# ---------------------------------------------------------------------------

def _cube_comp(mode, backend):
    if mode == "permk":
        return tc.make_round_compressor("permk", D, N, mode=mode,
                                        backend=backend, device="cpu")
    return tc.make_round_compressor("randk", D, N, k=6, mode=mode,
                                    backend=backend, device="cpu")


def _cube_hyper(variant, omega):
    from repro_torch.methods import Hyper
    a = tc.momentum_a(omega)
    if variant == "page":
        return Hyper(gamma=0.05, a=a, variant="page", p=0.25, batch=2)
    if variant == "mvr":
        return Hyper(gamma=0.05, a=a, variant="mvr", b=0.3, batch=4)
    if variant == "sync_mvr":
        return Hyper(gamma=0.05, a=a, variant="sync_mvr", p=0.3, batch=4,
                     batch_sync=16)
    return Hyper(gamma=0.05, a=a)


@pytest.mark.parametrize("backend", ["dense", "sparse", "fused"])
@pytest.mark.parametrize("mode", ["independent", "shared_coords", "permk"])
@pytest.mark.parametrize("variant", ["dasha", "page", "mvr", "sync_mvr"])
def test_invariant_g_equals_mean_g_local(variant, mode, backend):
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.methods import FlatSubstrate, Method
    if variant in ("dasha", "page"):
        feats, labels = glm_arrays()
        problem = FiniteSumProblem(torch_glm_loss, torch.as_tensor(feats),
                                   torch.as_tensor(labels))
    else:
        problem = torch_stoch_problem(*stoch_arrays())
    comp = _cube_comp(mode, backend)
    hp = _cube_hyper(variant, comp.omega)
    method = Method.build(variant, comp, FlatSubstrate(problem, N, D), hp)
    st = method.init(torch.zeros(D), 1, device="cpu",
                     init_mode="exact" if variant in ("dasha", "page")
                     else "stoch")
    for _ in range(3):
        st = method.step(st)
        torch.testing.assert_close(st.g, st.g_local.mean(0), rtol=1e-5,
                                   atol=1e-6)


def test_stochastic_oracle_matches_reference_on_same_xi():
    A, b = stoch_arrays()
    jp, tp = jax_stoch_problem(A, b), torch_stoch_problem(A, b)
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    xi = np.stack([np.asarray(jp.sample(keys[i], i, 3)) for i in range(N)])
    x = np.linspace(-1, 1, D).astype(np.float32)
    ref = jp.stoch_grad(jax.random.PRNGKey(5), jnp.asarray(x), 3)
    got = tp.stoch_grad(torch.as_tensor(x), torch.as_tensor(xi))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the port's own draws, by distribution
# ---------------------------------------------------------------------------

def test_randk_draws_k_distinct_with_marginal_k_over_d():
    d, k, draws = 50, 10, 2000
    rc = tc.make_round_compressor("randk", d, 1, k=k, device="cpu")
    counts = np.zeros(d)
    for s in range(draws):
        idx = rc.plan(s).indices.numpy()[0]
        assert len(np.unique(idx)) == k and idx.min() >= 0 and idx.max() < d
        counts[idx] += 1
    p = k / d
    sigma = np.sqrt(p * (1 - p) / draws)
    assert np.all(np.abs(counts / draws - p) < 5 * sigma)


@pytest.mark.parametrize("d", [24, 22])
def test_permk_partition_covers_d_once(d):
    rc = tc.make_round_compressor("permk", d, N, mode="permk", device="cpu")
    for s in range(20):
        idx = rc.plan(s).indices.numpy()
        valid = idx[idx < d]
        np.testing.assert_array_equal(np.sort(valid), np.arange(d))
        assert np.all(idx[idx >= d] == tc.PAD)


def test_permk_independent_rows_are_private_blocks():
    d = 22
    rc = tc.make_round_compressor("permk", d, N, mode="independent",
                                  device="cpu")
    shifts = set()
    for s in range(30):
        idx = rc.plan(s).indices.numpy()
        for row in idx:
            v = row[row < d]
            assert len(np.unique(v)) == len(v)
        shifts.add(tuple(idx[:, 0]))
    assert len(shifts) > 1


@pytest.mark.parametrize("mode", ["independent", "shared_coords"])
def test_bernoulli_density_is_p(mode):
    d, p = 4000, 0.25
    rc = tc.make_round_compressor("bernoulli", d, N, p=p, mode=mode,
                                  device="cpu")
    mask = rc.plan(3).mask
    assert set(mask.unique().tolist()) <= {0.0, 1.0}
    dens = float(mask.mean())
    assert abs(dens - p) < 5 * np.sqrt(p * (1 - p) / mask.numel())
    if mode == "shared_coords":
        assert torch.equal(mask[0], mask[1])


def test_qdither_is_unbiased():
    d, reps = 40, 4000
    rc = tc.make_round_compressor("qdither", d, 2, s=3, device="cpu")
    x = torch.as_tensor(_tensors(1, d)[0][:2])
    acc = torch.zeros_like(x)
    for s in range(reps):
        acc += rc(s, x)
    err = (acc / reps - x).abs().max()
    level = (x.norm(dim=1, keepdim=True) / 3).max()
    assert float(err) < 5 * float(level) / np.sqrt(reps)


def test_participation_coins_are_unbiased():
    gen = torch.Generator().manual_seed(0)
    f = tc.participation_coins(gen, 20000, 0.3)
    assert f.shape == (20000, 1)
    assert abs(float(f.mean()) - 1.0) < 0.05


def test_plans_are_a_function_of_the_seed():
    rc = tc.make_round_compressor("randk", D, N, k=6, device="cpu")
    assert torch.equal(rc.plan(5).indices, rc.plan(5).indices)
    assert not torch.equal(rc.plan(5).indices, rc.plan(6).indices)


@pytest.mark.parametrize("backend", ["dense", "sparse", "fused"])
def test_round_compressor_estimator_update_uses_its_seeded_plan(backend):
    h_new, h, g_local = (torch.as_tensor(t) for t in _tensors(4))
    rc = tc.make_round_compressor("randk", D, N, k=6, backend=backend,
                                  device="cpu")
    got = rc.estimator_update(9, h_new, h, g_local, 0.2)
    want = tc.estimator_update_with_plan(backend, rc.plan(9), h_new, h,
                                         g_local, 0.2)
    assert torch.equal(got[0].dense(), want[0].dense())
    assert torch.equal(got[2], want[2])
    assert rc.wire_per_node == (2.0 * 6 if backend == "sparse" else D)
