"""The port's chunked driver: the quickstart slice against the reference,
and the driver's own contracts (CPU).

Slice parity: the quickstart problem (n = 5, m = 64, d = 60, RandK K = 10,
theory hyperparameters x16) runs 50 rounds in both packages from one
carried-across state, the port replaying the reference's plans round by
round.  The ||grad f||^2 traces agree to rtol 1e-4 and ``bits_sent``
exactly.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_common import (glm_arrays, jax_glm_loss, port_plan, state_arrays,
                          torch_glm_loss)

import repro.methods as jm
from repro.compress import make_round_compressor as j_make_rc
from repro.core.oracles import FiniteSumProblem as JFiniteSum
from repro.methods import driver as jdriver
from repro_torch import convert
from repro_torch import methods as tm
from repro_torch.compress import make_round_compressor as t_make_rc
from repro_torch.core.rng import Draws
from repro_torch.methods import driver as tdriver

torch.set_num_threads(1)

N, M, D, K, ROUNDS = 5, 64, 60, 10, 50


def _quickstart(backend):
    feats, labels = glm_arrays(N, M, D, seed=0)
    jp = JFiniteSum(loss=jax_glm_loss, features=jnp.asarray(feats),
                    labels=jnp.asarray(labels))
    tp = convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                    device="cpu")
    jrc = j_make_rc("randk", D, N, k=K, backend=backend)
    trc = t_make_rc("randk", D, N, k=K, backend=backend, device="cpu")
    L = float(np.mean(np.sum(feats ** 2, -1)) * 2)
    jhp = jm.Hyper.from_theory("dasha", jrc.omega, N, L=L, gamma_mult=16)
    thp = tm.Hyper.from_theory("dasha", trc.omega, N, L=L, gamma_mult=16)
    jmethod = jm.Method.build("dasha", jrc, jm.FlatSubstrate(jp, N, D), jhp)
    tmethod = tm.Method.build("dasha", trc, tm.FlatSubstrate(tp, N, D), thp)
    return jp, tp, jrc, jmethod, tmethod


@pytest.mark.parametrize("backend", ["dense", "sparse", "fused"])
def test_quickstart_slice_matches_reference(backend):
    jp, tp, jrc, jmethod, tmethod = _quickstart(backend)
    jstate = jmethod.init(jnp.zeros(D), jax.random.PRNGKey(1))
    tstate = convert.state_from_numpy(state_arrays(jstate), seed=0,
                                      device="cpu")
    plans, key = [], jstate.key
    for _ in range(ROUNDS):
        key, _, k_c, _ = jax.random.split(key, 4)
        plans.append(port_plan(jrc.plan(k_c)))
    _, jtr = jdriver.run(jmethod, jstate, ROUNDS, metrics={
        "grad_sq": lambda s, d: jnp.sum(jp.grad_f(s.x) ** 2)})

    def step(s, data):
        return tmethod.step_full(s, data, draws=Draws(plan=plans[s.t]))[0]

    _, ttr = tdriver.run(step, tstate, ROUNDS, metrics={
        "grad_sq": lambda s, d: torch.sum(tp.grad_f(s.x) ** 2)})
    np.testing.assert_allclose(ttr["grad_sq"], np.asarray(jtr["grad_sq"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(ttr["bits_sent"],
                                  np.asarray(jtr["bits_sent"]))
    assert ttr["grad_sq"][-1] < ttr["grad_sq"][0]


def _port_run(chunk, rounds=23, metric_every=1, backend="dense"):
    _, tp, _, _, tmethod = _quickstart(backend)
    st = tmethod.init(torch.zeros(D), 4, device="cpu")
    return tdriver.run(tmethod, st, rounds, chunk=chunk,
                       metric_every=metric_every, metrics={
                           "grad_sq": lambda s, d: torch.sum(
                               tp.grad_f(s.x) ** 2)})


@pytest.mark.parametrize("chunk", [1, 7])
def test_chunking_is_bit_invariant(chunk):
    ref_state, ref_tr = _port_run(None)
    state, tr = _port_run(chunk)
    for name in ("x", "g", "g_local", "h_local"):
        assert torch.equal(getattr(state, name), getattr(ref_state, name))
    assert state.t == ref_state.t == 23
    for k in ref_tr:
        np.testing.assert_array_equal(tr[k], ref_tr[k])


def test_resume_is_bit_identical():
    _, tp, _, _, tmethod = _quickstart("fused")
    st = tmethod.init(torch.zeros(D), 4, device="cpu")
    full, _ = tdriver.run(tmethod, st, 20)
    half, _ = tdriver.run(tmethod, st, 8)
    resumed, _ = tdriver.run(tmethod, half, 12, chunk=5)
    for name in ("x", "g", "g_local", "h_local"):
        assert torch.equal(getattr(resumed, name), getattr(full, name))
    assert resumed.bits_sent == full.bits_sent


def test_metric_every_is_keyed_on_global_round():
    _, dense = _port_run(None, rounds=12)
    _, sub = _port_run(None, rounds=12, metric_every=4)
    g, s = dense["grad_sq"], sub["grad_sq"]
    for t in range(12):
        assert s[t] == g[t - t % 4]
    assert len(s) == 12 and s.dtype == np.float32


def test_method_run_returns_metric_and_bits_traces():
    _, tp, _, _, tmethod = _quickstart("dense")
    st = tmethod.init(torch.zeros(D), 4, device="cpu")
    final, metric, bits = tmethod.run(st, 5)
    assert metric.shape == (5,) and bits.shape == (5,)
    assert final.t == 5
    assert bits[-1] == D + 5 * K


class _Toy(NamedTuple):
    x: torch.Tensor
    t: int
    bits_sent: np.float32


def _toy_step(s, d):
    return _Toy(x=s.x + d, t=s.t + 1, bits_sent=s.bits_sent + np.float32(1))


def _toy_data(seed, t):
    return torch.rand((), generator=torch.Generator().manual_seed(seed))


def test_data_fn_seed_is_stateless_across_resume():
    s0 = _Toy(torch.zeros(()), 0, np.float32(0))
    full, tr = tdriver.run(_toy_step, s0, 9, data_fn=_toy_data, data_seed=3,
                           metrics={"x": lambda s, d: s.x})
    mid, _ = tdriver.run(_toy_step, s0, 4, data_fn=_toy_data, data_seed=3)
    end, _ = tdriver.run(_toy_step, mid, 5, data_fn=_toy_data, data_seed=3,
                         chunk=2)
    assert torch.equal(end.x, full.x)
    other, _ = tdriver.run(_toy_step, s0, 9, data_fn=_toy_data, data_seed=4)
    assert not torch.equal(other.x, full.x)
    assert tr["bits_sent"][-1] == 9


def test_checkpoint_hook_cadence():
    seen = []
    s0 = _Toy(torch.zeros(()), 0, np.float32(0))
    tdriver.run(_toy_step, s0, 10, data=torch.ones(()), chunk=3,
                checkpoint_every=2,
                checkpoint=lambda s, done, tr: seen.append(
                    (done, s.t, len(tr["bits_sent"]))))
    assert seen == [(6, 6, 3), (10, 10, 1)]


def test_driver_rejects_bad_configs():
    with pytest.raises(ValueError):
        tdriver.Driver(_toy_step, data_fn=_toy_data, data=1)
    with pytest.raises(ValueError):
        tdriver.Driver(_toy_step, data_fn=_toy_data).run(
            _Toy(torch.zeros(()), 0, np.float32(0)), 2)
    _, tr = tdriver.run(_toy_step, _Toy(torch.zeros(()), 0, np.float32(0)),
                        0, metrics={"x": lambda s, d: s.x})
    assert tr["x"].shape == (0,) and tr["bits_sent"].shape == (0,)


# ---------------------------------------------------------------------------
# a state without ``t``, zero-round traces: the reference's contracts
# ---------------------------------------------------------------------------

class _Bare(NamedTuple):
    x: torch.Tensor


class _JBare(NamedTuple):
    x: jax.Array


def test_state_without_t_is_indexed_by_the_run_counter():
    """A state without ``t``: the round index (and with it the data_fn
    round and the metric cadence) is the driver's per-run counter, as the
    reference's ``_round_index`` falls back to."""
    metrics = {"x": lambda s, d: s.x, "t": lambda s, d: d}
    st, tr = tdriver.run(lambda s, d: _Bare(s.x + 1), _Bare(torch.zeros(())),
                         3, data_fn=lambda seed, t: torch.tensor(t),
                         data_seed=0, metrics=metrics, chunk=2)
    _, jtr = jdriver.run(lambda s, d: _JBare(s.x + 1), _JBare(jnp.zeros(())),
                         3, data_fn=lambda k, t: t,
                         data_key=jax.random.PRNGKey(0), metrics=metrics)
    assert float(st.x) == 3.0
    np.testing.assert_array_equal(tr["x"], [1.0, 2.0, 3.0])
    for k in ("x", "t"):
        np.testing.assert_array_equal(tr[k], np.asarray(jtr[k]))
    assert "bits_sent" not in tr


@pytest.mark.parametrize("shape,dtype", [((3,), torch.float32),
                                         ((2, 2), torch.int64), ((), None)])
def test_zero_round_traces_keep_the_metric_shape_and_dtype(shape, dtype):
    metrics = {"m": lambda s, d: torch.ones(shape, dtype=dtype)}
    _, tr = tdriver.run(_toy_step, _Toy(torch.zeros(()), 0, np.float32(0)),
                        0, data=torch.ones(()), metrics=metrics)
    jdtype = None if dtype is None else \
        {torch.float32: jnp.float32, torch.int64: jnp.int32}[dtype]
    _, jtr = jdriver.run(
        lambda s, d: s, (jnp.zeros(()),), 0,
        metrics={"m": lambda s, d: jnp.ones(shape, jdtype)})
    assert tr["m"].shape == np.asarray(jtr["m"]).shape == (0,) + shape
    assert tr["m"].dtype == (np.float32 if dtype in (None, torch.float32)
                             else np.int64)
    assert tr["bits_sent"].shape == (0,)
    assert tr["bits_sent"].dtype == np.float32


def test_zero_round_traces_evaluate_the_metric_on_that_rounds_data():
    seen = []

    def data_fn(seed, t):
        seen.append(t)
        return torch.zeros(4)

    _, tr = tdriver.run(_toy_step, _Toy(torch.zeros(()), 5, np.float32(0)),
                        0, data_fn=data_fn, data_seed=1,
                        metrics={"d": lambda s, d: d})
    assert seen == [5] and tr["d"].shape == (0, 4)
