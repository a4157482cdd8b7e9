"""The port's hyperparameter sweep (``repro_torch.methods.Sweeper`` /
``sweep``) on the CPU.

* lane j equals a sequential port ``Driver`` run at ``values[j]``, for the
  five variants x dense / sparse / fused, with G = n lanes (4 lanes, 4
  nodes), so that a lane value broadcast along the node axis fails the
  comparison instead of raising: ``bits_sent`` exactly, the traces and
  the iterate to the reference sweep test's rtol 1e-6 / atol 1e-8 (lanes
  take a matrix product where a single run takes matrix-vector products),
  the per-node estimators to 1e-5 of their largest magnitude;
* chunking is bit-invariant; zero rounds give (G, 0) traces;
* the port's sweep against the reference's ``repro.methods.driver.sweep``
  at ``tests/test_driver.py``'s shapes, with the reference's plans,
  samples and coins replayed through a bare ``step_full(..., draws=)``
  step: traces within 1e-4, ``bits_sent`` exactly;
* lane ``batch`` and ``batch_sync`` raise ValueError (the reference's
  vmapped sweep cannot take a traced shape either); lane ``p`` and fused
  ``a`` build and step, and the sampled substrate has lanes (each held
  against sequential runs in ``tests/test_torch_lanes_more.py``; the tree
  substrate's lanes in ``tests/test_torch_dense.py``);
* no op of a sweep round or of the lane metric allocates a tensor of
  G * n * m * d elements or more (a lanes-outermost gradient does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_common import (glm_arrays, jax_stoch_problem, key_chain,
                          reference_draws, state_arrays, stoch_arrays,
                          torch_stoch_problem)

import repro.methods as jm
from repro.compress import make_round_compressor as j_make_rc
from repro.core.oracles import FiniteSumProblem as JFiniteSum
from repro.methods import driver as jdriver
from repro_torch import convert
from repro_torch.compress import make_round_compressor
from repro_torch.methods import (Driver, FlatSubstrate, Hyper, Lanes,
                                 LaneTreeSubstrate, Method,
                                 SampledFlatSubstrate, Sweeper, TreeSubstrate,
                                 lane_metric, sweep)

torch.set_num_threads(1)


def jm_broadcast(state, lanes):
    """One state as the start of ``lanes`` lanes on the CPU."""
    from repro_torch.methods.driver import _broadcast_lanes
    return _broadcast_lanes(state, lanes, torch.device("cpu"))

N, M, D, K, ROUNDS = 4, 16, 24, 6, 8
GAMMAS = np.array([0.05, 0.1, 0.2, 0.4])
BS = np.array([0.1, 0.3, 0.6, 0.9])
# per variant: the Hyper's shared fields and whether b varies by lane
CASES = {
    "dasha": dict(),
    "page": dict(p=0.5, batch=2),
    "mvr": dict(batch=2),
    "sync_mvr": dict(p=0.3, batch=2, batch_sync=3),
    "marina": dict(p=0.3, batch=0),
}


def _loss(x, a, y):
    return (1.0 / (1.0 + torch.exp(y * torch.dot(a, x)))) ** 2


def _jloss(x, a, y):
    return (1.0 / (1.0 + jnp.exp(y * jnp.dot(a, x)))) ** 2


def _glm(n=N, m=M, d=D):
    feats, labels = glm_arrays(n, m, d, seed=0)
    return convert.problem_from_numpy(_loss, feats, labels, device="cpu")


def _grad_sq(problem):
    """||grad f||^2 with its lane form (the figures' metric)."""
    return lane_metric(
        lambda s, d: torch.sum(problem.grad_f(s.x) ** 2),
        lambda s, d: torch.sum(problem.grad_f_lanes(s.x) ** 2, -1))


def _method_fn(variant, problem, backend, n=N, d=D, k=K):
    comp = make_round_compressor("randk", d, n, k=k, backend=backend,
                                 device="cpu")
    kw = CASES[variant]

    def method_fn(v):
        gamma, b = (v["gamma"], v["b"]) if isinstance(v, dict) else (v, 1.0)
        return Method.build(variant, comp, FlatSubstrate(problem, n, d),
                            Hyper(gamma=gamma, a=0.2, variant=variant, b=b,
                                  **kw))
    return method_fn


def _values(variant):
    if variant == "mvr":
        return {"gamma": GAMMAS, "b": BS}
    return GAMMAS


def _lane_value(values, j):
    if isinstance(values, dict):
        return {k: float(v[j]) for k, v in values.items()}
    return float(values[j])


def _assert_lane_equals_run(fin, tr, j, fj, tj, rtol=1e-6, atol=1e-8):
    """The reference sweep test's contract: bits exactly, the traces and
    the iterate to rtol / atol.  The estimators are held to 1e-5 of their
    largest magnitude: PAGE's h_i sums eight rounds of gradient
    differences, whose small entries carry the summation-order error of
    the larger ones (1.5e-6 of the largest after 8 rounds)."""
    np.testing.assert_array_equal(tr["bits_sent"][j], tj["bits_sent"])
    for name in tj:
        if name != "bits_sent":
            np.testing.assert_allclose(tr[name][j], tj[name], rtol=rtol,
                                       atol=atol, err_msg=name)
    np.testing.assert_allclose(fin.x[j].numpy(), fj.x.numpy(), rtol=rtol,
                               atol=atol, err_msg="x")
    for name in ("g", "g_local", "h_local"):
        want = getattr(fj, name).numpy()
        np.testing.assert_allclose(getattr(fin, name)[j].numpy(), want,
                                   rtol=rtol,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    assert fin.bits_sent[j] == fj.bits_sent and fin.t == fj.t


@pytest.mark.parametrize("backend", ["dense", "sparse", "fused"])
@pytest.mark.parametrize("variant", list(CASES))
def test_lane_equals_a_sequential_run(variant, backend):
    """G = n = 4: lane j against a Driver run at values[j]."""
    problem = _glm()
    method_fn = _method_fn(variant, problem, backend)
    values = _values(variant)
    st0 = method_fn(_lane_value(values, 0)).init(torch.zeros(D), 1,
                                                 device="cpu")
    metrics = {"grad_sq": _grad_sq(problem)}
    fin, tr = sweep(method_fn, values, st0, ROUNDS, metrics=metrics,
                    chunk=3, device="cpu")
    assert tr["grad_sq"].shape == tr["bits_sent"].shape == (N, ROUNDS)
    assert fin.x.shape == (N, D) and fin.h_local.shape == (N, N, D)
    for j in range(N):
        fj, tj = Driver(method_fn(_lane_value(values, j)), metrics=metrics,
                        chunk=3).run(st0, ROUNDS)
        _assert_lane_equals_run(fin, tr, j, fj, tj)


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_qdither_lanes_equal_sequential_runs(backend):
    """QSGD's plan (one (n, d) block of uniforms) serves every lane: the
    fused path quantizes the G * n rows in one call."""
    problem = _glm()
    comp = make_round_compressor("qdither", D, N, s=7, backend=backend,
                                 device="cpu")

    def method_fn(gamma):
        return Method.build("dasha", comp, FlatSubstrate(problem, N, D),
                            Hyper(gamma=gamma, a=0.2))

    st0 = method_fn(0.0).init(torch.zeros(D), 1, device="cpu")
    metrics = {"grad_sq": _grad_sq(problem)}
    fin, tr = sweep(method_fn, GAMMAS, st0, 5, metrics=metrics,
                    device="cpu")
    for j in range(N):
        fj, tj = Driver(method_fn(float(GAMMAS[j])),
                        metrics=metrics).run(st0, 5)
        _assert_lane_equals_run(fin, tr, j, fj, tj)


def test_stochastic_mvr_lanes_equal_sequential_runs():
    """fig5's {gamma, b} axis on a stochastic problem: every lane shares
    the round's xi samples, as sequential runs from one seed draw them."""
    A, b = stoch_arrays(D)
    problem = torch_stoch_problem(A, b)
    comp = make_round_compressor("randk", D, N, k=K, device="cpu")

    def method_fn(v):
        return Method.build("mvr", comp, FlatSubstrate(problem, N, D),
                            Hyper(gamma=v["gamma"], a=0.2, variant="mvr",
                                  b=v["b"], batch=2))

    st0 = method_fn({"gamma": 0.0, "b": 0.0}).init(
        torch.zeros(D), 1, device="cpu", init_mode="stoch")
    metric = lane_metric(
        lambda s, d: torch.sum(problem.true_grad(s.x) ** 2),
        lambda s, d: torch.sum(problem.true_grad_lanes(s.x) ** 2, -1))
    values = {"gamma": GAMMAS[:3] / 4, "b": BS[:3]}
    fin, tr = sweep(method_fn, values, st0, 6, chunk=2,
                    metrics={"m": metric}, device="cpu")
    for j in range(3):
        fj, tj = Driver(method_fn(_lane_value(values, j)), chunk=2,
                        metrics={"m": metric}).run(st0, 6)
        _assert_lane_equals_run(fin, tr, j, fj, tj)


def test_a_metric_without_a_lane_form_runs_lane_by_lane():
    """A metric written as the reference writes it (a function of one
    lane's state) gives each lane the number a sequential run gives."""
    problem = _glm()
    method_fn = _method_fn("dasha", problem, "fused")
    st0 = method_fn(0.0).init(torch.zeros(D), 1, device="cpu")
    metrics = {"grad_sq": lambda s, d: torch.sum(problem.grad_f(s.x) ** 2),
               "x0": lambda s, d: s.x[0]}
    _, tr = sweep(method_fn, GAMMAS[:3], st0, 5, metrics=metrics,
                  metric_every=2, device="cpu")
    for j in range(3):
        _, tj = Driver(method_fn(float(GAMMAS[j])), metrics=metrics,
                       metric_every=2).run(st0, 5)
        np.testing.assert_allclose(tr["grad_sq"][j], tj["grad_sq"],
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(tr["x0"][j], tj["x0"], rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("chunk", [1, 3])
def test_sweep_chunking_is_bit_invariant(chunk):
    problem = _glm()
    method_fn = _method_fn("marina", problem, "sparse")
    st0 = method_fn(0.0).init(torch.zeros(D), 1, device="cpu")
    metrics = {"grad_sq": _grad_sq(problem)}
    sw = Sweeper(method_fn, metrics=metrics, metric_every=2)
    ref_fin, ref_tr = sw.run(GAMMAS, st0, 7, device="cpu")
    fin, tr = Sweeper(method_fn, metrics=metrics, metric_every=2,
                      chunk=chunk).run(GAMMAS, st0, 7, device="cpu")
    for name in ("x", "g", "g_local", "h_local"):
        assert torch.equal(getattr(fin, name), getattr(ref_fin, name))
    np.testing.assert_array_equal(fin.bits_sent, ref_fin.bits_sent)
    for k in ref_tr:
        np.testing.assert_array_equal(tr[k], ref_tr[k])


def test_zero_rounds_keep_the_lane_axis():
    problem = _glm()
    method_fn = _method_fn("dasha", problem, "dense")
    st0 = method_fn(0.0).init(torch.zeros(D), 1, device="cpu")
    fin, tr = sweep(method_fn, GAMMAS[:3], st0, 0,
                    metrics={"grad_sq": _grad_sq(problem)}, device="cpu")
    assert tr["grad_sq"].shape == (3, 0) and tr["bits_sent"].shape == (3, 0)
    assert fin.x.shape == (3, D) and fin.t == 0


# ---------------------------------------------------------------------------
# the port's sweep against the reference's, with replayed draws
# ---------------------------------------------------------------------------

def _reference_case(variant):
    feats, labels = glm_arrays(N, M, D, seed=0)
    if variant == "dasha":
        jp = JFiniteSum(loss=_jloss, features=jnp.asarray(feats),
                        labels=jnp.asarray(labels))
        tp = convert.problem_from_numpy(_loss, feats, labels, device="cpu")
        jmetric = lambda s, d: jnp.sum(jp.grad_f(s.x) ** 2)  # noqa: E731
        tmetric = _grad_sq(tp)
        values = np.array([0.02, 0.08], np.float32)
        rounds, chunk, init_kw, kw = 8, 3, {}, {}
    else:
        A, b = stoch_arrays(D)
        jp, tp = jax_stoch_problem(A, b), torch_stoch_problem(A, b)
        jmetric = lambda s, d: jnp.sum(jp.true_grad(s.x) ** 2)  # noqa: E731
        tmetric = lane_metric(
            lambda s, d: torch.sum(tp.true_grad(s.x) ** 2),
            lambda s, d: torch.sum(tp.true_grad_lanes(s.x) ** 2, -1))
        values = {"gamma": np.array([0.01, 0.05], np.float32),
                  "b": np.array([0.1, 0.5], np.float32)}
        rounds, chunk, init_kw, kw = 6, 2, dict(init_mode="stoch"), \
            dict(batch=2)
    return jp, tp, jmetric, tmetric, values, rounds, chunk, init_kw, kw


@pytest.mark.parametrize("variant", ["dasha", "mvr"])
def test_sweep_matches_the_reference_sweep(variant):
    jp, tp, jmetric, tmetric, values, rounds, chunk, init_kw, kw = \
        _reference_case(variant)
    jrc = j_make_rc("randk", D, N, k=K)
    trc = make_round_compressor("randk", D, N, k=K, device="cpu")

    def split(v):
        return (v["gamma"], v["b"]) if isinstance(v, dict) else (v, 1.0)

    def j_method(v):
        gamma, b = split(v)
        return jm.Method.build(variant, jrc, jm.FlatSubstrate(jp, N, D),
                               jm.Hyper(gamma=gamma, a=0.2, variant=variant,
                                        b=b, **kw))

    zero = {"gamma": 0.0, "b": 0.0} if isinstance(values, dict) else 0.0
    jst0 = j_method(zero).init(jnp.zeros(D), jax.random.PRNGKey(1),
                               **init_kw)
    jvalues = {k: jnp.asarray(v) for k, v in values.items()} \
        if isinstance(values, dict) else jnp.asarray(values)
    jfin, jtr = jdriver.sweep(j_method, jvalues, jst0, rounds,
                              metrics={"m": jmetric}, chunk=chunk)

    # the reference draws every lane's round t from the same key
    jhp = jm.Hyper(gamma=0.0, a=0.2, variant=variant, **kw)
    draws = [reference_draws(key, jrc, jp, jhp, variant)
             for key in key_chain(jst0.key, rounds)]

    def t_step(v):
        gamma, b = split(v)
        method = Method.build(variant, trc, FlatSubstrate(tp, N, D),
                              Hyper(gamma=gamma, a=0.2, variant=variant,
                                    b=b, **kw))
        return lambda s, d: method.step_full(s, d, draws=draws[s.t])[0]

    tst0 = convert.state_from_numpy(state_arrays(jst0), seed=0,
                                    device="cpu")
    tfin, ttr = sweep(t_step, values, tst0, rounds, metrics={"m": tmetric},
                      chunk=chunk, device="cpu")
    np.testing.assert_allclose(ttr["m"], np.asarray(jtr["m"]), rtol=1e-4)
    np.testing.assert_array_equal(ttr["bits_sent"],
                                  np.asarray(jtr["bits_sent"]))
    np.testing.assert_allclose(tfin.x.numpy(), np.asarray(jfin.x),
                               rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# what cannot vary by lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,backend", [("p", "dense"), ("batch", "dense"),
                                           ("batch_sync", "sparse"),
                                           ("a", "fused")])
def test_fields_that_cannot_vary_by_lane_raise(field, backend):
    """``batch`` and ``batch_sync`` set a shape, so they still raise;
    ``p`` (per-lane coins) and fused ``a`` (the kernels' per-lane
    argument) now build a method of two lanes that steps."""
    problem = _glm()
    comp = make_round_compressor("randk", D, N, k=K, backend=backend,
                                 device="cpu")
    kw = dict(gamma=0.1, a=0.2, variant="sync_mvr", p=0.5, batch=2,
              batch_sync=2)
    kw[field] = np.array([1, 2]) if "batch" in field else \
        np.array([0.2, 0.4])
    if "batch" in field:
        with pytest.raises(ValueError, match=f"Hyper.{field} cannot vary"):
            Method.build("sync_mvr", comp, FlatSubstrate(problem, N, D),
                         Hyper(**kw))
        return
    method = Method.build("sync_mvr", comp, FlatSubstrate(problem, N, D),
                          Hyper(**kw))
    one = Method.build("sync_mvr", comp, FlatSubstrate(problem, N, D),
                       Hyper(**dict(kw, **{field: 0.2})))
    st = one.init(torch.zeros(D), 1, device="cpu")
    lanes = method.step(jm_broadcast(st, 2))
    assert lanes.x.shape == (2, D) and lanes.bits_sent.shape == (2,)


def test_lane_a_runs_on_the_dense_backend_and_marina_ignores_it():
    problem = _glm()
    for variant, backend in (("dasha", "dense"), ("marina", "fused")):
        comp = make_round_compressor("randk", D, N, k=K, backend=backend,
                                     device="cpu")

        def method_fn(a):
            return Method.build(variant, comp, FlatSubstrate(problem, N, D),
                                Hyper(gamma=0.1, a=a, variant=variant, p=0.5,
                                      batch=0))
        st = method_fn(0.1).init(torch.zeros(D), 1, device="cpu")
        final, _ = sweep(method_fn, np.array([0.1, 0.3]), st, 1,
                         device="cpu")
        assert final.x.shape == (2, D)
        with pytest.raises(ValueError, match="sweep it"):
            method_fn(np.array([0.1, 0.3])).init(torch.zeros(D), 1,
                                                 device="cpu")


def test_sampled_and_tree_substrates_have_no_lanes_yet():
    """Both have lanes now: the sampled substrate's lane view
    (``tests/test_torch_lanes_more.py`` holds it against sequential runs)
    and the tree substrate's (``tests/test_torch_dense.py``)."""
    problem = _glm()
    comp = make_round_compressor("randk", D, N, k=K, device="cpu")
    m = Method.build("dasha", comp, SampledFlatSubstrate(problem, N, D, c=2),
                     Hyper(gamma=Lanes([0.1, 0.2]), a=0.2))
    one = Method.build("dasha", comp, SampledFlatSubstrate(problem, N, D,
                                                           c=2),
                       Hyper(gamma=0.1, a=0.2))
    st = m.step(jm_broadcast(one.init(torch.zeros(D), 1, device="cpu"), 2))
    assert st.x.shape == (2, D) and st.h_local.shape == (2, N, D)
    lanes = TreeSubstrate(oracle=None, n=N, server_opt=None).with_lanes(2)
    assert isinstance(lanes, LaneTreeSubstrate) and lanes.lanes == 2


def test_lanes_arithmetic_rounds_like_a_python_scalar():
    """``(1.0 - b) * t`` with b per lane equals, lane by lane, the same
    expression with b a Python float: the float64 expression is rounded to
    the tensor's dtype once."""
    b = [0.1, 0.7, 1.0 / 3.0]
    t = torch.randn(3, 2, 5, generator=torch.Generator().manual_seed(0))
    got = (1.0 - Lanes(b)) * t
    for j, bj in enumerate(b):
        assert torch.equal(got[j], (1.0 - bj) * t[j])
    got = t - Lanes(b) * t
    for j, bj in enumerate(b):
        assert torch.equal(got[j], t[j] - bj * t[j])


# ---------------------------------------------------------------------------
# memory: the lane axis sits inside the oracle
# ---------------------------------------------------------------------------

class _LargestAllocation(TorchDispatchMode):
    """The most elements any op's output storage holds."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.largest = max(self.largest, o.untyped_storage().nbytes()
                                   // o.element_size())
        return out


@pytest.mark.parametrize("variant,backend", [("dasha", "fused"),
                                             ("marina", "dense"),
                                             ("page", "sparse")])
def test_no_op_of_a_sweep_allocates_lanes_times_the_features(variant,
                                                             backend):
    G, n, m, d = 3, 5, 7, 11
    feats, labels = glm_arrays(n, m, d, seed=1)
    problem = convert.problem_from_numpy(_loss, feats, labels, device="cpu")
    limit = G * n * m * d
    comp = make_round_compressor("randk", d, n, k=3, backend=backend,
                                 device="cpu")
    kw = dict(CASES[variant])

    def method_fn(gamma):
        return Method.build(variant, comp, FlatSubstrate(problem, n, d),
                            Hyper(gamma=gamma, a=0.2, variant=variant, **kw))

    st0 = method_fn(0.0).init(torch.zeros(d), 1, device="cpu")
    with _LargestAllocation() as mode:
        sweep(method_fn, GAMMAS[:G], st0, 3,
              metrics={"grad_sq": _grad_sq(problem)}, device="cpu")
    assert 0 < mode.largest < limit, (mode.largest, limit)

    # the check has teeth: the lanes outside the nodes copy the features
    # once per lane in the backward pass
    X = torch.randn(G, d)
    with _LargestAllocation() as mode:
        torch.func.vmap(problem.full_grad)(X)
    assert mode.largest >= limit
