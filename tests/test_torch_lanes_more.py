"""Sweep lanes the port now takes, on the CPU: per-lane ``p``, per-lane
``a`` on the fused backend, per-lane ``b`` (and ``a``) on the fused tree
path, and lanes on ``SampledFlatSubstrate``.

* each lane against its sequential run: the coins (every round), the
  cohorts and ``bits_sent`` exactly; the state to rtol 1e-6 and 1e-6 of
  each field's largest magnitude (1e-5 for PAGE's sampled lanes, whose
  h_i sums gradient differences; 1e-4 for QDither, whose levels a
  last-ulp difference can move), because a flat lane takes the problem's
  lane oracle, a matrix product where a run takes matrix-vector products;
  the tree lanes, whose oracle takes each lane on its own, bit for bit;
* per-lane ``p`` against the reference's vmapped sweep over ``p`` with its
  plans, coins and samples replayed (state within 1e-5);
* the per-row ``a`` / ``b`` forms of the kernels' plain versions bit for
  bit against the scalar forms, lane by lane;
* per-lane ``batch`` still raises, and the reference's sweep fails on it
  too (a traced shape).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_common import (glm_arrays, jax_glm_loss, key_chain, port_plan,
                          stoch_arrays, torch_glm_loss, torch_stoch_problem)

import repro.methods as jm
from repro.compress import make_round_compressor as j_make_rc
from repro.core.oracles import FiniteSumProblem as JFiniteSum
from repro.methods import driver as jdriver
from repro_torch import convert
from repro_torch.compress import make_round_compressor
from repro_torch.core import tree
from repro_torch.core.rng import Draws, RoundRandom
from repro_torch.kernels import dasha_update as kern
from repro_torch.kernels import ops, ref
from repro_torch.methods import (BatchLossOracle, FlatSubstrate, Hyper,
                                 LaneSampledFlatSubstrate, Lanes, Method,
                                 SampledFlatSubstrate, TreeCompression,
                                 TreeSubstrate)
from repro_torch.methods.driver import _broadcast_lanes
from repro_torch.optim.base import SGD

torch.set_num_threads(1)

N, M, D, K = 4, 16, 24, 6
PS = np.array([0.15, 0.45, 0.7, 0.95])
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def glm():
    feats, labels = glm_arrays(N, M, D)
    return (JFiniteSum(loss=jax_glm_loss, features=jnp.asarray(feats),
                       labels=jnp.asarray(labels)),
            convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                       device="cpu"))


def _lanes_vs_runs(build, values, state, rounds, scale=1e-6, exact=False,
                   draws=None):
    """Step a method of G lanes and G one-lane methods side by side:
    every coin of every round (PAGE's and the sync round's, read where the
    round draws them), then the final states and bits_sent.  Returns the
    rounds whose coins differed by lane."""
    lanes = build(values)
    runs = [build(float(v)) for v in values]
    ls = _broadcast_lanes(state, len(values), CPU)
    ss = [state] * len(values)
    mixed = 0
    real = RoundRandom.coin
    seen = []

    def spy(self, p, tag):
        out = real(self, p, tag)
        seen.append(out)
        return out
    RoundRandom.coin = spy
    try:
        for t in range(rounds):
            dr = None if draws is None else draws(t)
            seen.clear()
            ls = lanes.step_full(ls, draws=dr)[0]
            lane_coins = list(seen)
            per_run = []
            for j, r in enumerate(runs):
                seen.clear()
                ss[j] = r.step_full(ss[j], draws=dr)[0]
                per_run.append(list(seen))
            for k, coins in enumerate(lane_coins):
                coins = np.broadcast_to(coins, len(values))
                np.testing.assert_array_equal(
                    coins, [c[k] for c in per_run])
                mixed += len(set(coins.tolist())) > 1
    finally:
        RoundRandom.coin = real
    for j, s in enumerate(ss):
        assert ls.bits_sent[j] == s.bits_sent and ls.t == s.t
        for field in ("x", "g", "g_local", "h_local"):
            got = tree.leaves(getattr(ls, field))
            want = tree.leaves(getattr(s, field))
            for a, b in zip(got, want):
                if exact:
                    assert torch.equal(a[j], b), field
                else:
                    np.testing.assert_allclose(
                        a[j].numpy(), b.numpy(), rtol=1e-6,
                        atol=scale * float(b.abs().max()), err_msg=field)
    return mixed


# ---------------------------------------------------------------------------
# per-lane p
# ---------------------------------------------------------------------------

P_CASES = {"page": dict(batch=2), "sync_mvr": dict(batch=2, batch_sync=3),
           "marina": dict(batch=0)}


@pytest.mark.parametrize("variant", list(P_CASES))
def test_per_lane_p_equals_sequential_runs(glm, variant):
    tprob = glm[1]
    rc = make_round_compressor("randk", D, N, k=K, backend="fused",
                               device="cpu")

    def build(p):
        return Method.build(variant, rc, FlatSubstrate(tprob, N, D),
                            Hyper(gamma=0.1, a=0.2, variant=variant, p=p,
                                  **P_CASES[variant]))
    state = build(0.5).init(torch.zeros(D), 3, device="cpu")
    mixed = _lanes_vs_runs(build, PS, state, 8)
    assert mixed > 0, "no round with coins that differ by lane"


def test_per_lane_p_matches_the_reference_sweep(glm):
    """The reference vmaps ``p``: each lane compares the round's one
    uniform with its own p.  Its plans, samples and per-lane coins are
    replayed into the port's lanes."""
    jprob, tprob = glm
    rounds = 4
    jrc = j_make_rc("randk", D, N, k=K)

    def jmethod(p):
        return jm.Method.build("page", jrc, jm.FlatSubstrate(jprob, N, D),
                               jm.Hyper(gamma=0.1, a=0.2, variant="page",
                                        p=p, batch=2))
    jst = jmethod(0.5).init(jnp.zeros(D), jax.random.PRNGKey(2))
    jfin, _ = jdriver.sweep(jmethod, jnp.asarray(PS, jnp.float32), jst,
                            rounds)
    keys = key_chain(jst.key, rounds)

    def draws(t):
        _, k_h, k_c, _ = jax.random.split(keys[t], 4)
        k_p, k_batch = jax.random.split(k_h)
        coins = np.array([bool(jax.random.bernoulli(k_p, jnp.float32(p)))
                          for p in PS])
        return Draws(plan=port_plan(jrc.plan(k_c)), page_coin=coins,
                     samples=np.array(jprob._sample_idx(k_batch, 2)))
    rc = make_round_compressor("randk", D, N, k=K, device="cpu")
    m = Method.build("page", rc, FlatSubstrate(tprob, N, D),
                     Hyper(gamma=0.1, a=0.2, variant="page", p=Lanes(PS),
                           batch=2))
    st = _broadcast_lanes(Method.build(
        "page", rc, FlatSubstrate(tprob, N, D),
        Hyper(gamma=0.1, a=0.2, variant="page", batch=2)).init(
        torch.zeros(D), 0, device="cpu", grads0=np.asarray(jst.h_local)),
        len(PS), CPU)
    for t in range(rounds):
        st = m.step_full(st, draws=draws(t))[0]
    for field in ("x", "g", "g_local", "h_local"):
        np.testing.assert_allclose(getattr(st, field).numpy(),
                                   np.asarray(getattr(jfin, field)),
                                   rtol=1e-5, atol=1e-6, err_msg=field)
    np.testing.assert_array_equal(st.bits_sent, np.asarray(jfin.bits_sent))


# ---------------------------------------------------------------------------
# per-lane a on the fused backend; the per-row plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["randk", "qdither"])
def test_per_lane_a_on_the_fused_backend_equals_sequential_runs(glm, name):
    tprob = glm[1]
    kw = dict(k=K) if name == "randk" else {}
    rc = make_round_compressor(name, D, N, backend="fused", device="cpu",
                               **kw)

    def build(a):
        return Method.build("page", rc, FlatSubstrate(tprob, N, D),
                            Hyper(gamma=0.1, a=a, variant="page", p=0.4,
                                  batch=2))
    state = build(0.2).init(torch.zeros(D), 1, device="cpu")
    _lanes_vs_runs(build, np.array([0.05, 0.2, 0.5]), state, 6,
                   scale=1e-6 if name == "randk" else 1e-4)


def _rows(g, n, d, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((g * n, d), generator=gen) for _ in range(4)]


def test_per_row_plain_versions_equal_the_scalar_ones_lane_by_lane():
    g, n, d = 3, 4, 10
    a_vals, b_vals = [0.1, 0.25, 0.7], [0.05, 0.3, 0.9]
    # as the methods layer hands them over: (G,) fp32, 1 - b in double
    # before its one rounding
    a = Lanes(a_vals).as_vector(CPU)
    c = (1.0 - Lanes(b_vals)).as_vector(CPU)
    gn, go, h, gl = _rows(g, n, d, 0)
    mask = (torch.rand((n, d), generator=torch.Generator().manual_seed(1))
            < 0.5)
    idx = torch.topk(torch.rand((n, d)), 3, dim=1).indices
    u = torch.rand((n, d), generator=torch.Generator().manual_seed(2))
    lanes = [slice(j * n, (j + 1) * n) for j in range(g)]

    def check(lane_out, scalar):
        for j, sl in enumerate(lanes):
            for got, want in zip(lane_out, scalar(j, sl)):
                assert torch.equal(got[sl], want), j

    check(ref.dasha_sparsify_update_ref(gn, h, gl, a, 2.5, indices=idx),
          lambda j, sl: ref.dasha_sparsify_update_ref(
              gn[sl], h[sl], gl[sl], a_vals[j], 2.5, indices=idx))
    check(ref.dasha_mvr_update_ref(gn, go, h, gl, mask, a, None, 2.0, c=c),
          lambda j, sl: ref.dasha_mvr_update_ref(
              gn[sl], go[sl], h[sl], gl[sl], mask, a_vals[j], b_vals[j],
              2.0))
    lq = ref.dasha_quantize_update_ref(gn.view(g, n, d), h.view(g, n, d),
                                       gl.view(g, n, d), u, a, 1.0, 7)
    check([t.reshape(g * n, d) for t in lq],
          lambda j, sl: ref.dasha_quantize_update_ref(
              gn[sl], h[sl], gl[sl], u, a_vals[j], 1.0, 7))
    # the dispatch passes the fp32 values through on the CPU
    via_ops = ops.dasha_mvr_update(gn, go, h, gl, mask, a, None, 2.0, c=c)
    for got, want in zip(via_ops, ref.dasha_mvr_update_ref(
            gn, go, h, gl, mask, a, None, 2.0, c=c)):
        assert torch.equal(got, want)
    # the card's wrappers take fp32 lane values only, never a conversion
    assert kern.lane_values("k", "a", a, g * n, a.device)[2] == n
    with pytest.raises(ValueError, match="fp32"):
        kern.lane_values("k", "a", a.double(), g * n, a.device)


# ---------------------------------------------------------------------------
# per-lane b and a on the fused tree path
# ---------------------------------------------------------------------------

def _mlp_loss(p, batch):
    hid = torch.tanh(batch["x"] @ p["w1"])
    return torch.mean((hid @ p["w2"] - batch["y"]) ** 2)


@pytest.mark.parametrize("field,variant", [("b", "mvr"), ("a", "mvr"),
                                           ("a", "dasha")])
def test_per_lane_b_and_a_on_the_fused_tree_path(field, variant):
    gen = torch.Generator().manual_seed(0)
    params = {"w1": 0.3 * torch.randn((5, 6), generator=gen),
              "w2": 0.3 * torch.randn((6, 2), generator=gen)}
    data = {"x": torch.randn((N, 8, 5), generator=gen),
            "y": torch.randn((N, 8, 2), generator=gen)}
    sub = TreeSubstrate(BatchLossOracle(_mlp_loss), N, SGD(lr=0.1))
    comp = TreeCompression(n=N, p=0.5, use_kernel=True)

    def build(v):
        kw = dict(gamma=0.1, a=0.2, b=0.3, variant=variant)
        kw[field] = v
        return Method.build(variant, comp, sub, Hyper(**kw))
    state = build(0.3).init(params, 1, device="cpu", data=data)

    def step_data(method):
        return lambda s, draws=None: method.step_full(s, data, draws=draws)
    lanes = build(np.array([0.1, 0.4, 0.8]))
    ls = _broadcast_lanes(state, 3, CPU)
    seq = []
    for j, v in enumerate((0.1, 0.4, 0.8)):
        s = state
        for _ in range(3):
            s = build(v).step(s, data)
        seq.append(s)
    for _ in range(3):
        ls = lanes.step(ls, data)
    for j, s in enumerate(seq):
        for name in ("x", "g", "g_local", "h_local"):
            for path, w in tree.items(getattr(s, name)):
                assert torch.equal(tree.get(getattr(ls, name), path)[j],
                                   w), (name, path, j)


# ---------------------------------------------------------------------------
# lanes on the sampled substrate
# ---------------------------------------------------------------------------

def test_sampled_lanes_equal_sequential_runs():
    n, c, d = 20, 5, D
    feats, labels = glm_arrays(n, 6, d, seed=3)
    prob = convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                      device="cpu")
    rc = make_round_compressor("randk", d, n, k=K, backend="fused",
                               device="cpu")

    def build(g):
        return Method.build("page", rc, SampledFlatSubstrate(prob, n, d,
                                                             c=c),
                            Hyper(gamma=g, a=0.2, variant="page", p=0.5,
                                  batch=2))
    lanes = build(np.array([0.05, 0.2, 0.4]))
    assert isinstance(lanes, Method)
    state = build(0.1).init(torch.zeros(d), 4, device="cpu")
    # PAGE's h_i sums the rounds' gradient differences, whose small entries
    # carry the larger ones' summation-order error (as the sweep tests)
    _lanes_vs_runs(build, np.array([0.05, 0.2, 0.4]), state, 5, scale=1e-5)


def test_sampled_lanes_stochastic_per_lane_a():
    n, c = 12, 4
    A, b = stoch_arrays(D)
    prob = torch_stoch_problem(A, b, n)
    rc = make_round_compressor("randk", D, n, k=K, backend="fused",
                               device="cpu")

    def build(a):
        return Method.build("mvr", rc, SampledFlatSubstrate(prob, n, D, c=c),
                            Hyper(gamma=0.1, a=a, variant="mvr", b=0.3,
                                  batch=2))
    state = build(0.2).init(torch.zeros(D), 2, device="cpu",
                            init_mode="stoch", batch_init=2)
    _lanes_vs_runs(build, np.array([0.1, 0.3]), state, 4)
    sub = SampledFlatSubstrate(prob, n, D, c=c).with_lanes(2)
    assert isinstance(sub, LaneSampledFlatSubstrate)
    with pytest.raises(ValueError, match="no lane form"):
        sub.window_view(None, None, None)


def test_per_lane_batch_raises_as_the_reference_sweep_fails(glm):
    jprob, tprob = glm
    rc = make_round_compressor("randk", D, N, k=K, device="cpu")
    with pytest.raises(ValueError, match="Hyper.batch cannot vary"):
        Method.build("page", rc, FlatSubstrate(tprob, N, D),
                     Hyper(gamma=0.1, a=0.2, variant="page",
                           batch=Lanes([1, 2])))
    jrc = j_make_rc("randk", D, N, k=K)

    def jmethod(batch):
        return jm.Method.build("page", jrc, jm.FlatSubstrate(jprob, N, D),
                               jm.Hyper(gamma=0.1, a=0.2, variant="page",
                                        p=0.5, batch=batch))
    jst = jmethod(1).init(jnp.zeros(D), jax.random.PRNGKey(0))
    with pytest.raises(Exception) as err:
        jdriver.sweep(jmethod, jnp.array([1, 2]), jst, 1)
    assert "shape" in str(err.value).lower() or \
        "concret" in str(err.value).lower() or \
        "tracer" in str(err.value).lower()
