"""Shared helpers of the ``test_torch_*`` files: problems built once with
numpy and handed to both packages, and the reference's per-round draws
replayed into the port."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.rng import Draws

N, M, D = 4, 16, 24


def glm_arrays(n=N, m=M, d=D, seed=0):
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((n, m, d)) / np.sqrt(d)).astype(np.float32)
    teacher = rng.standard_normal(d).astype(np.float32)
    margin = feats @ teacher
    labels = np.where(rng.random(margin.shape) < 0.05, -1.0, 1.0) \
        * np.sign(margin)
    return feats, labels.astype(np.float32)


def jax_glm_loss(x, a, y):
    return (1 - 1 / (1 + jnp.exp(y * jnp.dot(a, x)))) ** 2


def torch_glm_loss(x, a, y):
    return (1 - 1 / (1 + torch.exp(y * torch.dot(a, x)))) ** 2


def stoch_arrays(d=D, seed=0):
    rng = np.random.default_rng(seed)
    A = np.diag(np.linspace(1.0, 2.0, d)).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    return A, b


def jax_stoch_problem(A, b, n=N):
    from repro.core.oracles import StochasticProblem
    A, b = jnp.asarray(A), jnp.asarray(b)

    def loss(x, xi, i):
        return 0.5 * x @ A @ x - b @ x + xi @ x

    def sample(k, i, batch):
        return 0.3 * jax.random.normal(k, (batch, A.shape[0]))

    return StochasticProblem(loss=loss, sample=sample, n=n,
                             true_grad=lambda x: A @ x - b)


def torch_stoch_problem(A, b, n=N):
    from repro_torch.core.oracles import StochasticProblem
    A, b = torch.as_tensor(A), torch.as_tensor(b)

    def loss(x, xi, i):
        return 0.5 * x @ A @ x - b @ x + xi @ x

    def sample(gen, i, batch):
        return 0.3 * torch.randn((batch, A.shape[0]), generator=gen)

    return StochasticProblem(loss=loss, sample=sample, n=n, device="cpu",
                             true_grad=lambda x: A @ x - b)


def port_plan(plan):
    """A reference Plan's arrays as a port Plan on the CPU."""
    def arr(a):
        return None if a is None else np.asarray(a)
    return convert.plan_from_numpy(
        plan.kind, np.asarray(plan.scale) if hasattr(plan.scale, "shape")
        else plan.scale, indices=arr(plan.indices), mask=arr(plan.mask),
        dither_u=arr(plan.dither_u), levels=plan.levels,
        payload_coords=plan.payload_coords, wire_coords=plan.wire_coords,
        device="cpu")


def state_arrays(st):
    return {"x": np.asarray(st.x), "g": np.asarray(st.g),
            "g_local": np.asarray(st.g_local),
            "h_local": np.asarray(st.h_local), "t": np.asarray(st.t),
            "bits_sent": np.asarray(st.bits_sent)}


def reference_draws(state_key, rc, problem, hp, variant) -> Draws:
    """The draws the reference engine makes from ``state_key`` in one round
    (``key, k_h, k_c, k_coin = split(key, 4)``), as port Draws."""
    _, k_h, k_c, k_coin = jax.random.split(state_key, 4)
    plan = port_plan(rc.plan(k_c))
    page_coin = samples = sync_coin = sync_samples = None
    stochastic = hasattr(problem, "stoch_grad")
    if variant == "page":
        k_p, k_batch = jax.random.split(k_h)
        page_coin = bool(jax.random.bernoulli(k_p, hp.p))
        samples = np.array(problem._sample_idx(k_batch, hp.batch))
    elif stochastic and variant in ("mvr", "sync_mvr", "marina", "dasha"):
        keys = jax.random.split(k_h, problem.n)
        samples = np.stack([np.asarray(problem.sample(keys[i], i, hp.batch))
                            for i in range(problem.n)])
        if variant in ("sync_mvr", "marina"):
            sync_samples = np.stack([
                np.asarray(problem.sample(keys[i], i, hp.batch_sync))
                for i in range(problem.n)])
    elif variant in ("mvr", "marina") and hp.batch > 0:
        samples = np.array(problem._sample_idx(k_h, hp.batch))
    if variant in ("sync_mvr", "marina"):
        sync_coin = bool(jax.random.bernoulli(k_coin, hp.p))
    return Draws(plan=plan, page_coin=page_coin, samples=samples,
                 sync_coin=sync_coin, sync_samples=sync_samples)


def assert_state_close(port_state, ref_state, rtol=1e-5, atol=1e-6):
    for name in ("x", "g", "g_local", "h_local"):
        np.testing.assert_allclose(
            getattr(port_state, name).numpy(),
            np.asarray(getattr(ref_state, name)), rtol=rtol, atol=atol,
            err_msg=name)
    assert port_state.t == int(ref_state.t)
    assert port_state.bits_sent == np.float32(ref_state.bits_sent)


def reference_sampled_draws(state_key, bound, problem, hp, variant) -> Draws:
    """The sampled counterpart of :func:`reference_draws`: the draws a
    round of the reference's ``SampledFlatSubstrate`` (``bound``, with its
    compressor) makes from ``state_key`` — the cohort
    (``permutation(fold_in(k_c, COHORT_TAG), n)[:c]``), the cohort's plan
    before the n/C scale, PAGE's coin and the cohort rows' samples (a
    finite-sum problem draws them for the row-restricted problem; a
    stochastic one per client id, ``split(k_h, n)[client]``).  At c == n
    the round is the flat one."""
    import dataclasses

    from repro.methods.substrates import cohort_indices
    if not bound.samples_clients:
        return reference_draws(state_key, bound.rc, problem, hp, variant)
    _, k_h, k_c, _ = jax.random.split(state_key, 4)
    sel = np.asarray(cohort_indices(k_c, bound.n, bound.c))
    plan = port_plan(bound.cohort_rc.plan(k_c))
    page_coin = samples = None
    stochastic = hasattr(problem, "stoch_grad")

    def rows_problem():
        return dataclasses.replace(problem, features=problem.features[sel],
                                   labels=problem.labels[sel])

    if variant == "page":
        k_p, k_batch = jax.random.split(k_h)
        page_coin = bool(jax.random.bernoulli(k_p, hp.p))
        samples = np.array(rows_problem()._sample_idx(k_batch, hp.batch))
    elif stochastic:
        keys = jax.random.split(k_h, problem.n)
        samples = np.stack([np.asarray(problem.sample(keys[i], i, hp.batch))
                            for i in sel])
    elif variant == "mvr" and hp.batch > 0:
        samples = np.array(rows_problem()._sample_idx(k_h, hp.batch))
    return Draws(plan=plan, page_coin=page_coin, samples=samples,
                 cohort=sel)


def key_chain(key, rounds):
    """The reference engine's per-round state keys from ``key``: round t's
    pre-step key (each round keeps ``split(key, 4)[0]``)."""
    keys = []
    for _ in range(rounds):
        keys.append(key)
        key = jax.random.split(key, 4)[0]
    return keys


# ---------------------------------------------------------------------------
# the SSD kernel's split arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero: the kernel's ``hi`` of a split."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` with its 13 low mantissa bits cleared: what a TF32
    tensor-core product reads of an operand that was not rounded (the
    kernel's ``lo``)."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to bf16 and back."""
    return t.to(torch.bfloat16).to(torch.float32)


def bf16_split3(t: torch.Tensor):
    """(hi, mid, lo) as the kernel splits a float32 operand into three bf16
    parts, each what the previous ones leave (exact subtractions)."""
    hi = bf16_round(t)
    mid = bf16_round(t - hi)
    return hi, mid, bf16_round(t - hi - mid)


def tf32_split(t: torch.Tensor):
    """(hi, lo) as the kernel splits a float32 operand: hi = tf32(t), lo =
    t - hi, of which the tensor core reads the TF32 part."""
    hi = tf32_round(t)
    return hi, tf32_trunc(t - hi)
