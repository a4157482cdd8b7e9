"""The seed-era API of the port against the reference's, on the CPU:
``repro_torch.core.dasha`` / ``core.marina``, ``compress.legacy``, the
deprecated ``core.compressors`` / ``core.node_compress`` import paths,
``core.pytree_util``, ``treelevel.leaf_keys``, ``VariantRule.init_h`` /
``supports_client_sampling`` and ``SampledFlatSubstrate.round_cohort``.

* ``core.dasha.step`` / ``core.marina.step`` with the reference's plans,
  coins and samples replayed (``draws=``) against the reference's
  ``step``: the state within rtol 1e-5 / atol 1e-6 every round,
  ``bits_sent`` exactly, the ||grad f||^2 trace within 1e-5 relative;
  ``run`` equals a ``Method.build`` run of the same hyperparameters bit for
  bit (traces and state);
* the legacy classes' omega, density, payload and spec fields equal the
  reference's exactly; masks have the structure the reference's have
  (K ones; PermK's node blocks partition [d]); QDither is the plain
  quantizer on its generator's uniforms; ``empirical_omega`` lies within
  the reference test's bound (``omega * tol + 0.05``) in both packages;
* the two shims and the deprecated factories warn, as the reference's do;
* ``round_cohort`` gives the exact ids the round's step uses (its
  participation mask and the rows it moves), injected ids included.
"""
import importlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_common import (glm_arrays, jax_glm_loss, jax_stoch_problem,
                          key_chain, reference_draws, stoch_arrays,
                          torch_glm_loss, torch_stoch_problem)

import repro.compress.legacy as jlegacy
import repro.core.dasha as jdasha
import repro.core.marina as jmarina
import repro.methods as jm
from repro.compress import make_round_compressor as j_make_rc
from repro.compress.treelevel import leaf_keys as j_leaf_keys
from repro.core.oracles import FiniteSumProblem as JFiniteSum
from repro.core.pytree_util import ravel as j_ravel
from repro_torch import convert
from repro_torch.compress import legacy, make_round_compressor
from repro_torch.compress.treelevel import leaf_keys
from repro_torch.core import dasha, marina, pytree_util
from repro_torch.core.rng import Draws, cohort_schedule, draw_cohort
from repro_torch.methods import (VARIANTS, FlatSubstrate, Hyper, Method,
                                 SampledFlatSubstrate, VariantRule)
from repro_torch.methods.rules import _h_dasha

torch.set_num_threads(1)

N, M, D, K = 4, 16, 24, 6
ROUNDS = 3


@pytest.fixture(scope="module")
def glm():
    feats, labels = glm_arrays(N, M, D)
    return (JFiniteSum(loss=jax_glm_loss, features=jnp.asarray(feats),
                       labels=jnp.asarray(labels)),
            convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                       device="cpu"))


@pytest.fixture(scope="module")
def stoch():
    A, b = stoch_arrays(D)
    return jax_stoch_problem(A, b, N), torch_stoch_problem(A, b, N)


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


def _node_compressors(backend):
    jc = _quiet(jlegacy.NodeCompressor, _quiet(jlegacy.make_compressor,
                                                "randk", D, k=K), N)
    tc = _quiet(legacy.NodeCompressor, _quiet(legacy.make_compressor,
                                              "randk", D, k=K), N,
                backend=backend, device="cpu")
    return jc, tc


def _assert_close(got, want, t):
    for field in ("x", "g", "g_local", "h_local"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{field} @ {t}")
    assert got.bits_sent == np.float32(want.bits_sent)


# ---------------------------------------------------------------------------
# core.dasha
# ---------------------------------------------------------------------------

DASHA_HYPER = {"dasha": dict(), "page": dict(p=0.3, batch=2),
               "mvr": dict(b=0.4, batch=3)}


@pytest.mark.parametrize("variant", list(DASHA_HYPER))
def test_core_dasha_matches_the_reference(glm, variant):
    jprob, tprob = glm
    kw = dict(gamma=0.1, a=0.2, variant=variant, **DASHA_HYPER[variant])
    jhp, thp = jdasha.DashaHyper(**kw), dasha.DashaHyper(**kw)
    jc, tc = _node_compressors("fused")
    jst = jdasha.init(jnp.zeros(D), N, jax.random.PRNGKey(4), problem=jprob,
                      hyper=jhp)
    tst = dasha.init(torch.zeros(D), N, 0, problem=tprob, hyper=thp,
                     device="cpu")
    _assert_close(tst, jst, -1)
    keys = key_chain(jst.key, ROUNDS)
    for t in range(ROUNDS):
        draws = reference_draws(keys[t], jc.rc, jprob, jhp, variant)
        jst = jdasha.step(jst, jhp, jprob, jc)
        tst = dasha.step(tst, thp, tprob, tc, draws=draws)
        _assert_close(tst, jst, t)
        np.testing.assert_allclose(
            float(torch.sum(tprob.grad_f(tst.x) ** 2)),
            float(jnp.sum(jprob.grad_f(jst.x) ** 2)), rtol=1e-5)


def test_core_dasha_run_is_the_method_build_run(glm):
    tprob = glm[1]
    hp = dasha.DashaHyper(gamma=0.1, a=0.2, variant="page", p=0.3, batch=2)
    _, tc = _node_compressors("fused")
    st = dasha.init(torch.zeros(D), N, 5, problem=tprob, hyper=hp,
                    device="cpu")
    final, metric, bits = dasha.run(st, hp, tprob, tc, 6)
    m = Method.build("page", tc.rc, FlatSubstrate(tprob, N, D), hp)
    want, wmetric, wbits = m.run(st, 6)
    for field in ("x", "g", "g_local", "h_local"):
        assert torch.equal(getattr(final, field), getattr(want, field))
    np.testing.assert_array_equal(metric, wmetric)
    np.testing.assert_array_equal(bits, wbits)
    assert dasha.DashaState is type(st) and dasha.DashaHyper is Hyper


# ---------------------------------------------------------------------------
# core.marina
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["marina", "vr", "vr_online"])
def test_core_marina_matches_the_reference(glm, stoch, variant):
    jprob, tprob = stoch if variant == "vr_online" else glm
    kw = dict(gamma=0.05, p=0.3, variant=variant, batch=2, batch_sync=4)
    jhp, thp = jmarina.MarinaHyper(**kw), marina.MarinaHyper(**kw)
    jc, tc = _node_compressors("sparse")
    jst = jmarina.init(jnp.zeros(D), jax.random.PRNGKey(6), jprob)
    tst = marina.init(torch.zeros(D), 0, tprob, device="cpu")
    # the stochastic init draws a 64-sample minibatch: take the reference's
    tst = tst._replace(**{f: torch.as_tensor(np.asarray(getattr(jst, f)))
                          for f in ("g", "g_local", "h_local")})
    engine_hp = jmarina._hyper(jhp)
    assert marina._hyper(thp) == Hyper(**{
        f: getattr(engine_hp, f) for f in ("gamma", "a", "variant", "b", "p",
                                           "batch", "batch_sync")})
    keys = key_chain(jst.key, ROUNDS)
    for t in range(ROUNDS):
        draws = reference_draws(keys[t], jc.rc, jprob, engine_hp, "marina")
        jst = jmarina.step(jst, jhp, jprob, jc)
        tst = marina.step(tst, thp, tprob, tc, draws=draws)
        _assert_close(tst, jst, t)


def test_core_marina_run_and_oracle_checks(glm, stoch):
    tprob = glm[1]
    hp = marina.MarinaHyper(gamma=0.05, p=0.3)
    _, tc = _node_compressors("fused")
    st = marina.init(torch.zeros(D), 2, tprob, device="cpu")
    final, metric, bits = marina.run(st, hp, tprob, tc, 5)
    m = Method.build("marina", tc.rc, FlatSubstrate(tprob, N, D),
                     marina._hyper(hp))
    want, wmetric, wbits = m.run(st, 5)
    assert torch.equal(final.x, want.x) and torch.equal(final.g, want.g)
    np.testing.assert_array_equal(metric, wmetric)
    np.testing.assert_array_equal(bits, wbits)
    assert marina._hyper(hp).batch == 0 and marina._VARIANTS == \
        jmarina._VARIANTS
    for variant, problem in (("vr_online", tprob), ("marina", stoch[1]),
                             ("vr", stoch[1])):
        with pytest.raises(ValueError, match="oracle"):
            marina._check_oracle(problem, variant)
        with pytest.raises(ValueError, match="oracle"):
            jmarina._check_oracle(stoch[0] if problem is stoch[1] else glm[0],
                                  variant)
    with pytest.raises(ValueError):
        marina._hyper(marina.MarinaHyper(gamma=0.1, p=0.5, variant="sgd"))


# ---------------------------------------------------------------------------
# compress.legacy
# ---------------------------------------------------------------------------

LEGACY = [("identity", {}), ("randk", dict(k=5)), ("permk", dict(n=4)),
          ("qdither", dict(s=3)), ("randk", dict(k=5, p_participate=0.5))]


@pytest.mark.parametrize("name,kw", LEGACY)
def test_legacy_make_compressor_matches_the_reference(name, kw):
    with pytest.warns(DeprecationWarning, match="make_round_compressor"):
        tc = legacy.make_compressor(name, 32, **kw)
    with pytest.warns(DeprecationWarning):
        jc = jlegacy.make_compressor(name, 32, **kw)
    assert type(tc).__name__ == type(jc).__name__
    assert tc.omega == jc.omega
    assert tc.expected_density == jc.expected_density
    assert tc.payload(32) == jc.payload(32)
    ts, js = tc.as_spec(4), jc.as_spec(4)
    for f in ("name", "d", "k", "n", "s", "p", "p_participate"):
        assert getattr(ts, f) == getattr(js, f), f
    with pytest.warns(DeprecationWarning, match="NodeCompressor"):
        tn = legacy.NodeCompressor(tc, 4, device="cpu")
    jn = _quiet(jlegacy.NodeCompressor, jc, 4)
    assert tn.omega == jn.omega and tn.payload_per_node == jn.payload_per_node
    assert tn.rc.spec == tc.as_spec(4) and tn.rc.n == jn.rc.n == 4
    for f in ("name", "d", "k", "n", "s", "p", "p_participate"):
        assert getattr(tn.rc.spec, f) == getattr(jn.rc.spec, f), f


def test_legacy_masks_have_the_reference_structure():
    gen = torch.Generator().manual_seed(0)
    for k in (1, 5, 32):
        mask = legacy.RandK(32, k).mask(gen)
        jmask = jlegacy.RandK(32, k).mask(jax.random.PRNGKey(k))
        assert float(mask.sum()) == float(jnp.sum(jmask)) == k
        assert set(mask.unique().tolist()) <= {0.0, 1.0}
    # one round's PermK blocks (the same shift) partition [d]
    for d, n in ((32, 4), (30, 4)):
        blocks = [legacy.PermK(d, n, i).mask(torch.Generator().manual_seed(
            7)) for i in range(n)]
        jblocks = [jlegacy.PermK(d, n, i).mask(jax.random.PRNGKey(7))
                   for i in range(n)]
        assert torch.equal(sum(blocks), torch.ones(d))
        np.testing.assert_array_equal(np.asarray(sum(jblocks)), np.ones(d))
    x = torch.linspace(-1.0, 2.0, 32)
    q = legacy.QDither(32, 3)(torch.Generator().manual_seed(3), x)
    u = torch.rand((32,), generator=torch.Generator().manual_seed(3))
    from repro_torch.kernels.ref import quantize_ref
    assert torch.equal(q, quantize_ref(x[None], u[None], 3)[0])
    assert torch.equal(legacy.Identity(32)(None, x), x)


# the reference test's bounds: E||C(x)-x||^2 / ||x||^2 <= omega * tol + 0.05
OMEGA_TOL = {"randk": 1.25, "permk": 1.25, "qdither": 1.0}


@pytest.mark.parametrize("name,kw", [("randk", dict(k=7)),
                                     ("permk", dict(n=4)),
                                     ("qdither", dict(s=3))])
def test_empirical_omega_within_the_spec_bound(name, kw):
    tc = _quiet(legacy.make_compressor, name, 32, **kw)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(32),
                        dtype=torch.float32)
    emp = legacy.empirical_omega(tc, torch.Generator().manual_seed(1), x,
                                 trials=1024)
    assert emp <= tc.omega * OMEGA_TOL[name] + 0.05, (emp, tc.omega)
    jc = _quiet(jlegacy.make_compressor, name, 32, **kw)
    jemp = jlegacy.empirical_omega(jc, jax.random.PRNGKey(1),
                                   jnp.asarray(x.numpy()), trials=1024)
    assert jemp <= jc.omega * OMEGA_TOL[name] + 0.05
    if name == "randk":     # unbiased and exact in expectation
        assert abs(emp - tc.omega) < 0.4 * tc.omega


@pytest.mark.parametrize("mod", ["compressors", "node_compress"])
def test_seed_shims_warn_on_import(mod):
    for pkg in ("repro_torch.core", "repro.core"):
        sys.modules.pop(f"{pkg}.{mod}", None)
        with pytest.warns(DeprecationWarning, match="deprecated seed-era"):
            m = importlib.import_module(f"{pkg}.{mod}")
        assert hasattr(m, "NodeCompressor" if mod == "node_compress"
                       else "RandK")
    import repro_torch.core as core
    assert core.NodeCompressor is legacy.NodeCompressor
    assert core.init is dasha.init and core.marina is marina


# ---------------------------------------------------------------------------
# pytree_util and leaf_keys
# ---------------------------------------------------------------------------

def test_pytree_util_matches_ravel_pytree():
    rng = np.random.default_rng(0)
    arrays = {"b": rng.standard_normal(4).astype(np.float32),
              "a": {"w": rng.standard_normal((2, 3)).astype(np.float32)}}
    jflat, _ = j_ravel(jax.tree_util.tree_map(jnp.asarray, arrays))
    t = {"b": torch.as_tensor(arrays["b"]),
         "a": {"w": torch.as_tensor(arrays["a"]["w"])}}
    flat, unravel = pytree_util.ravel(t)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = unravel(flat)
    assert torch.equal(back["a"]["w"], t["a"]["w"])
    assert torch.equal(back["b"], t["b"])
    assert pytree_util.tree_dim(t) == 10
    assert torch.equal(pytree_util.tree_zeros_like_flat(t), torch.zeros(10))


def test_leaf_keys_fan_one_seed_out_per_leaf():
    t = {"a": torch.zeros(2), "b": {"c": torch.zeros(3), "d": torch.zeros(1)}}
    seeds = leaf_keys(9, t)
    jkeys = j_leaf_keys(jax.random.PRNGKey(9), {"a": 0, "b": {"c": 0,
                                                               "d": 0}})
    assert jax.tree_util.tree_structure(jkeys) == \
        jax.tree_util.tree_structure(seeds)
    flat = [seeds["a"], seeds["b"]["c"], seeds["b"]["d"]]
    assert len(set(flat)) == 3 and leaf_keys(9, t) == seeds
    gens = leaf_keys(9, t, device="cpu")
    assert torch.equal(torch.rand(3, generator=gens["b"]["c"]),
                       torch.rand(3, generator=leaf_keys(9, t, device="cpu")
                                  ["b"]["c"]))


# ---------------------------------------------------------------------------
# VariantRule.init_h, supports_client_sampling, round_cohort
# ---------------------------------------------------------------------------

def test_init_h_overrides_the_initialisation(glm):
    jprob, tprob = glm
    jrule = jm.VariantRule(
        name="dasha_scaled", h_update=jm.rules._h_dasha,
        init_h=lambda sub, key, hp, x0, data: sub.lin(
            lambda g: 0.5 * g, sub.grad(key, x0, data, 1)))
    trule = VariantRule(
        name="dasha_scaled", h_update=_h_dasha,
        init_h=lambda sub, rnd, hp, x0, data: sub.lin(
            lambda g: 0.5 * g, sub.grad(rnd, x0, data, 1)))
    jst = jm.Method.build(jrule, j_make_rc("randk", D, N, k=K),
                          jm.FlatSubstrate(jprob, N, D),
                          jm.Hyper(gamma=0.1, a=0.2)).init(
        jnp.zeros(D), jax.random.PRNGKey(0))
    m = Method.build(trule, make_round_compressor("randk", D, N, k=K,
                                                  device="cpu"),
                     FlatSubstrate(tprob, N, D), Hyper(gamma=0.1, a=0.2))
    # init_h wins over grads0, as the reference's engine orders them
    tst = m.init(torch.zeros(D), 0, device="cpu",
                 grads0=torch.ones(N, D))
    np.testing.assert_allclose(tst.h_local.numpy(), np.asarray(jst.h_local),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(tst.h_local, 0.5 * tprob.full_grad(torch.zeros(D)))
    assert tst.bits_sent == np.float32(jst.bits_sent)
    assert VARIANTS["dasha"].init_h is None


def test_supports_client_sampling_matches_the_reference(glm):
    for name, rule in VARIANTS.items():
        assert rule.supports_client_sampling == \
            jm.VARIANTS[name].supports_client_sampling, name
    sub = SampledFlatSubstrate(glm[1], N, D, c=2)
    rc = make_round_compressor("randk", D, N, k=K, device="cpu")
    for name in ("marina", "sync_mvr"):
        with pytest.raises(ValueError, match="sync_requires_all"):
            Method.build(name, rc, sub, Hyper(gamma=0.1, a=0.2))


def test_round_cohort_gives_the_rounds_exact_ids():
    n, c, d = 20, 5, 8
    feats, labels = glm_arrays(n, 6, d, seed=3)
    prob = convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                      device="cpu")
    rc = make_round_compressor("randk", d, n, k=3, backend="fused",
                               device="cpu")
    sub = SampledFlatSubstrate(prob, n, d, c=c)
    m = Method.build("dasha", rc, sub, Hyper(gamma=0.1, a=0.2))
    st = m.init(torch.zeros(d), 4, device="cpu")
    for t in range(3):
        ids = sub.with_compressor(rc).round_cohort(st.seed, st.t)
        assert ids.dtype == np.int32 and ids.shape == (c,)
        np.testing.assert_array_equal(ids, draw_cohort(4, t, n, c))
        np.testing.assert_array_equal(ids, cohort_schedule(4, t, 1, n, c)[0])
        new, info = m.step_full(st)
        np.testing.assert_array_equal(np.flatnonzero(info.present.numpy()),
                                      np.sort(ids))
        moved = np.flatnonzero((new.h_local != st.h_local).any(1).numpy())
        assert set(moved) <= set(ids.tolist())
        st = new
    injected = np.array([3, 1, 4, 15, 9])
    np.testing.assert_array_equal(
        sub.round_cohort(4, 0, Draws(cohort=injected)), injected)
