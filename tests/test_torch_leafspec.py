"""Registry compressors on the port's tree substrate
(``repro_torch.methods.LeafSpecCompressor`` / ``LeafProblemOracle``).

* a single-leaf ``TreeSubstrate`` over ``LeafProblemOracle`` equals the
  port's ``FlatSubstrate`` bit for bit (``torch.equal`` on x, g, h_i, g_i;
  ``bits_sent`` exactly), for the five variants x RandK, PermK, Bernoulli
  and QDither (one backend each: fused, sparse, fused, dense);
* the same single-leaf tree against the reference's ``LeafProblemOracle``
  tree, with the reference's plans, coins and samples replayed: the state
  within the shared fp32 tolerance (rtol 1e-5, atol 1e-6), ``bits_sent``
  exactly, the plan the round used equal to the reference's (indices,
  masks, uniforms) and, for Bernoulli, the wire counts exactly;
* a multi-leaf ``LeafSpecCompressor`` against the reference's with the
  reference's per-leaf plans (``split(key, n_leaves)``) injected through
  ``Draws.leaf_plans``: aggregates, h_i and g_i to rtol 1e-6, payload
  exactly; without injection each leaf draws its own plan, seeded by its
  path;
* ``with_compressor`` takes every form, RandK wider than a leaf raises,
  ``LeafProblemOracle`` refuses a tree of several leaves, and a sweep's
  lanes on the single-leaf tree equal sequential runs (rtol 1e-6 and 1e-6
  of the largest magnitude, 1e-4 for QDither: lanes take the problem's
  lane oracles, a matrix product where a run takes matrix-vector
  products).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_common import (glm_arrays, jax_glm_loss, jax_stoch_problem,
                          key_chain, port_plan, reference_draws,
                          stoch_arrays, torch_glm_loss, torch_stoch_problem)

import repro.methods as jm
from repro.compress import make_round_compressor as j_make_rc
from repro.core.oracles import FiniteSumProblem as JFiniteSum
from repro.optim.base import SGD as JSGD
from repro_torch import convert
from repro_torch.compress import make_round_compressor
from repro_torch.compress.legacy import NodeCompressor, RandK
from repro_torch.core import tree
from repro_torch.core.rng import Draws, RoundRandom
from repro_torch.methods import (Driver, FlatSubstrate, Hyper,
                                 LeafProblemOracle, LeafSpecCompressor,
                                 Method, TreeCompression, TreeSubstrate,
                                 sweep)
from repro_torch.optim.base import SGD

torch.set_num_threads(1)

N, M, D = 4, 16, 24
VARIANTS = ("dasha", "page", "mvr", "sync_mvr", "marina")
# registry name, its keywords, the port backend it runs on
COMPRESSORS = {"randk": (dict(k=6), "fused"), "permk": ({}, "sparse"),
               "bernoulli": (dict(p=0.3), "fused"),
               "qdither": (dict(s=7), "dense")}
ROUNDS = 3


def _hyper(variant):
    kw = dict(gamma=0.05, a=0.2, variant=variant)
    kw.update({"page": dict(p=0.25, batch=2), "mvr": dict(b=0.3, batch=4),
               "sync_mvr": dict(p=0.3, batch=4, batch_sync=8),
               "marina": dict(p=0.3, batch=0)}.get(variant, {}))
    return kw


def _stochastic(variant):
    return variant in ("mvr", "sync_mvr")


@pytest.fixture(scope="module")
def problems():
    feats, labels = glm_arrays(N, M, D)
    A, b = stoch_arrays(D)
    return {
        "glm": (JFiniteSum(loss=jax_glm_loss, features=jnp.asarray(feats),
                           labels=jnp.asarray(labels)),
                convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                           device="cpu")),
        "stoch": (jax_stoch_problem(A, b, N), torch_stoch_problem(A, b, N))}


def _pair(problems, variant):
    return problems["stoch" if _stochastic(variant) else "glm"]


def _port_methods(tprob, variant, name):
    kw, backend = COMPRESSORS[name]
    rc = make_round_compressor(name, D, N, backend=backend, device="cpu",
                               **kw)
    hp = Hyper(**_hyper(variant))
    flat = Method.build(variant, rc, FlatSubstrate(tprob, N, D), hp)
    oracle = LeafProblemOracle.wrapping(tprob, {"w": torch.zeros(D)})
    treem = Method.build(variant, rc, TreeSubstrate(
        oracle, N, SGD(lr=hp.gamma)), hp)
    return flat, treem


# ---------------------------------------------------------------------------
# single-leaf tree == flat, bit for bit, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(COMPRESSORS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_single_leaf_tree_equals_flat_bit_for_bit(problems, variant, name):
    tprob = _pair(problems, variant)[1]
    flat, treem = _port_methods(tprob, variant, name)
    mode = "stoch" if _stochastic(variant) else "exact"
    sf = flat.init(torch.zeros(D), 7, device="cpu", init_mode=mode,
                   batch_init=4)
    st = treem.init({"w": torch.zeros(D)}, 7, device="cpu", init_mode=mode,
                    batch_init=4)
    for t in range(ROUNDS + 1):
        sf, fi = flat.step_full(sf)
        st, ti = treem.step_full(st)
        for field in ("x", "g", "g_local", "h_local"):
            assert torch.equal(getattr(sf, field),
                               getattr(st, field)["w"]), (field, t)
        assert sf.bits_sent == st.bits_sent and fi.coin == ti.coin


# ---------------------------------------------------------------------------
# single-leaf tree against the reference's, on the reference's draws
# ---------------------------------------------------------------------------

def _reference_tree_run(jprob, variant, name):
    kw = COMPRESSORS[name][0]
    jrc = j_make_rc(name, D, N, **kw)
    jhp = jm.Hyper(**_hyper(variant))
    oracle = jm.LeafProblemOracle.wrapping(jprob, {"w": jnp.zeros(D)})
    jmeth = jm.Method.build(variant, jrc, jm.TreeSubstrate(
        oracle=oracle, n=N, server_opt=JSGD(lr=jhp.gamma)), jhp)
    mode = "stoch" if _stochastic(variant) else "exact"
    state = jmeth.init({"w": jnp.zeros(D)}, jax.random.PRNGKey(3),
                       init_mode=mode, batch_init=4)
    states = [state]
    for _ in range(ROUNDS):
        state = jmeth.step(state)
        states.append(state)
    return jrc, jhp, states


@pytest.fixture(scope="module")
def reference_runs(problems):
    cache = {}

    def get(variant, name):
        if (variant, name) not in cache:
            cache[variant, name] = _reference_tree_run(
                _pair(problems, variant)[0], variant, name)
        return cache[variant, name]
    return get


@pytest.mark.parametrize("name", list(COMPRESSORS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_single_leaf_tree_matches_the_reference(problems, reference_runs,
                                                variant, name):
    jprob, tprob = _pair(problems, variant)
    jrc, jhp, jstates = reference_runs(variant, name)
    treem = _port_methods(tprob, variant, name)[1]
    j0 = jstates[0]
    st = treem.init({"w": torch.zeros(D)}, 0, device="cpu",
                    grads0={"w": np.asarray(j0.h_local["w"])})
    keys = key_chain(j0.key, ROUNDS)
    for t in range(ROUNDS):
        draws = reference_draws(keys[t], jrc, jprob, jhp, variant)
        st, info = treem.step_full(st, draws=draws)
        want = jstates[t + 1]
        for field in ("x", "g", "g_local", "h_local"):
            np.testing.assert_allclose(
                getattr(st, field)["w"].numpy(),
                np.asarray(getattr(want, field)["w"]), rtol=1e-5, atol=1e-6,
                err_msg=f"{field} @ {t}")
        assert st.bits_sent == np.float32(want.bits_sent)
        # the round ran on the reference's plan, exactly
        ref = port_plan(jrc.plan(jax.random.split(keys[t], 4)[2]))
        for part in ("indices", "mask", "dither_u"):
            a, b = getattr(info.plan, part), getattr(ref, part)
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b), part
        if name == "bernoulli":
            np.testing.assert_array_equal(
                (info.plan.mask != 0).sum(1).numpy(),
                (ref.mask != 0).sum(1).numpy())


# ---------------------------------------------------------------------------
# several leaves
# ---------------------------------------------------------------------------

LEAVES = {"b": (5,), "w": (3, 4), "z": (2, 3)}


def _leaf_arrays(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((N,) + s).astype(np.float32)
            for k, s in LEAVES.items()}


@pytest.mark.parametrize("name", list(COMPRESSORS))
def test_multi_leaf_leafspec_matches_the_reference(name):
    kw, backend = COMPRESSORS[name]
    if name == "randk":
        kw = dict(k=2)
    hn, hh, gl = (_leaf_arrays(s) for s in (1, 2, 3))
    jlsc = jm.LeafSpecCompressor(j_make_rc(name, 30, N, **kw))
    key = jax.random.PRNGKey(11)
    jagg, jh, jg, jpay = jlsc.estimator_update(
        key, *({k: jnp.asarray(v) for k, v in t.items()}
               for t in (hn, hh, gl)), 0.25)
    # the reference's per-leaf plans: split(key, n_leaves), leaves in order
    keys = jax.random.split(key, len(LEAVES))
    plans = {}
    for k_leaf, (path, shape) in zip(keys, sorted(LEAVES.items())):
        d_leaf = int(np.prod(shape))
        jleaf = jm.LeafSpecCompressor(j_make_rc(name, d_leaf, N, **kw)).rc
        plans[path] = port_plan(jleaf.plan(k_leaf))
    lsc = LeafSpecCompressor(make_round_compressor(
        name, 30, N, backend=backend, device="cpu", **kw))
    rnd = RoundRandom(0, 0, Draws(leaf_plans=plans))
    agg, h_out, g_out, pay = lsc.estimator_update(
        rnd, *({k: torch.as_tensor(v) for k, v in t.items()}
               for t in (hn, hh, gl)), 0.25)
    assert pay == jpay
    for got, want in ((agg, jagg), (h_out, jh), (g_out, jg)):
        for path in LEAVES:
            np.testing.assert_allclose(got[path].numpy(),
                                       np.asarray(want[path]), rtol=1e-6,
                                       atol=1e-7, err_msg=path)


def test_leaf_plans_are_seeded_by_path_and_a_single_leaf_by_the_round():
    rc = make_round_compressor("bernoulli", 30, N, p=0.5, device="cpu")
    lsc = LeafSpecCompressor(rc)
    per_node = {"u": torch.zeros(N, 6), "v": torch.zeros(N, 6)}
    plans = lsc.leaf_plans(RoundRandom(5, 2), per_node)
    again = lsc.leaf_plans(RoundRandom(5, 2), per_node)
    later = lsc.leaf_plans(RoundRandom(5, 3), per_node)
    assert not torch.equal(plans["u"].mask, plans["v"].mask)
    assert torch.equal(plans["u"].mask, again["u"].mask)
    assert not torch.equal(plans["u"].mask, later["u"].mask)
    # a single leaf draws the flat round's own plan
    rnd = RoundRandom(5, 2)
    one = lsc.leaf_plans(rnd, {"u": torch.zeros(N, 6)})["u"]
    flat_rc = dataclasses.replace(rc, spec=dataclasses.replace(rc.spec, d=6))
    assert torch.equal(one.mask, RoundRandom(5, 2).plan(flat_rc).mask)
    assert rnd.drawn_plan is one


def test_with_compressor_takes_every_form_and_randk_must_fit_a_leaf(
        problems):
    tprob = problems["glm"][1]
    sub = TreeSubstrate(LeafProblemOracle.wrapping(tprob, {"w": torch.zeros(
        D)}), N, SGD(lr=0.1))
    rc = make_round_compressor("randk", D, N, k=6, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = NodeCompressor(RandK(D, 6), N, device="cpu")
    assert sub.with_compressor(rc).comp == LeafSpecCompressor(rc)
    assert sub.with_compressor(legacy).comp.rc == legacy.rc
    tc = TreeCompression(n=N, p=0.5, use_kernel=True)
    assert sub.with_compressor(tc).comp is tc
    assert sub.with_compressor(tc).fuses_mvr
    assert not sub.with_compressor(rc).fuses_mvr
    assert FlatSubstrate(tprob, N, D).with_compressor(legacy).rc == legacy.rc
    wide = LeafSpecCompressor(make_round_compressor("randk", 64, N, k=8,
                                                    device="cpu"))
    with pytest.raises(ValueError, match="randk needs 0 < k <= d, got k=8 "
                                         "d=6"):
        wide.payload_per_node({"a": torch.zeros(N, 2, 3)})
    with pytest.raises(ValueError, match="single-leaf only"):
        LeafProblemOracle.wrapping(tprob, {"a": torch.zeros(2),
                                           "b": torch.zeros(3)})
    bare = LeafProblemOracle.wrapping(tprob, torch.zeros(D))
    assert bare.path == "" and bare.grad(None, torch.zeros(D)).shape == (N, D)


@pytest.mark.parametrize("name", ["randk", "qdither"])
def test_single_leaf_tree_lanes_equal_sequential_runs(problems, name):
    """A sweep of 3 gammas on the single-leaf tree (LaneTreeSubstrate with
    a LeafSpecCompressor) against sequential runs.  QDither's levels are a
    step function of the row's norm: a last-ulp difference of the lane
    oracle's gradient can move an element one level, so its states are
    held to 1e-4 of their largest magnitude."""
    scale = 1e-6 if name == "randk" else 1e-4
    tprob = problems["glm"][1]
    kw, _ = COMPRESSORS[name]
    rc = make_round_compressor(name, D, N, backend="fused", device="cpu",
                               **kw)
    oracle = LeafProblemOracle.wrapping(tprob, {"w": torch.zeros(D)})

    def method_fn(gamma):
        return Method.build("page", rc, TreeSubstrate(oracle, N, SGD(
            lr=gamma)), Hyper(gamma=gamma, a=0.2, variant="page", p=0.4,
                              batch=2))
    state = method_fn(0.1).init({"w": torch.zeros(D)}, 2, device="cpu")
    gammas = np.array([0.02, 0.05, 0.1])
    final, traces = sweep(method_fn, gammas, state, 4, device="cpu")
    for j, g in enumerate(gammas):
        seq, tr = Driver(method_fn(float(g))).run(state, 4)
        np.testing.assert_array_equal(traces["bits_sent"][j],
                                      tr["bits_sent"])
        for field in ("x", "g", "g_local", "h_local"):
            want = getattr(seq, field)["w"].numpy()
            np.testing.assert_allclose(
                tree.get(getattr(final, field), "w")[j].numpy(), want,
                rtol=1e-6, atol=scale * np.abs(want).max(), err_msg=field)
