"""The port's Mamba2 serving path against the reference (CPU): the SSD
chunk kernel's plain version, the kernel SSD forward, the recurrent decode
step and its cache, the serving prefill and the serving loop, and the
driver on a state without ``bits_sent``.

The reference's Pallas ``ssd_chunk`` kernel runs in interpret mode, as its
own tests run it; the reference's parameters and caches are carried across
with ``convert.params_from_numpy`` / ``convert.cache_from_numpy``.

Tolerances: the intra-chunk block and the kernel SSD forward agree to rtol
1e-4 and atol 1e-4 (``tests/test_ssd_kernel.py``'s own tolerance: the two
frameworks take the cumsum, the exps and the matmul sums in different
orders); the kernel's plain version against the Pallas body with the same
float32 inputs to 1e-5.  One decode step of the SSD or the mixer agrees to
rtol and atol 1e-5 (a few float32 roundings); eight decode steps of the
smoke LM, logits and cache, to 1e-4 (the error grows with the steps and
the layers); decode against prefill to 5e-3, as
``tests/test_lm_parity.py``.  In bfloat16, the serving dtype, the decode
agrees to a few bf16 ulps (stated in each test, with the reason above
them).  Greedy tokens must be equal.
"""
import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro.methods.driver import Driver as JDriver
from repro.models import init_params as j_init
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.methods import driver as tdriver
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

# the shapes of tests/test_ssd_kernel.py: B, S, H, P, N, chunk
SSD_SHAPES = [(1, 16, 1, 2, 3, 4), (2, 32, 3, 4, 5, 8), (1, 64, 2, 8, 16, 16),
              (2, 24, 2, 4, 4, 24), (1, 128, 4, 16, 8, 32)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    D = np.linspace(0.5, 1.5, H).astype(np.float32)
    return x, dt, A, b, c, D


def _both(arrays):
    """numpy arrays (bfloat16 by its ml_dtypes dtype) as jax and torch."""
    return ([jnp.asarray(a) for a in arrays],
            [convert.params_from_numpy({"a": a}, device="cpu")["a"]
             for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the intra-chunk block and the kernel SSD forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_chunk_ref_matches_pallas_kernel(B, S, H, P, N, chunk, dtype):
    """All four outputs of the plain version against the Pallas body, on
    the reference wrapper's (G, nc, ...) layout."""
    x, dt, A, b, c, _ = _ssd_inputs(B * S + H, B, S, H, P, N)
    G, nc = B * H, S // chunk
    xg = x.transpose(0, 2, 1, 3).reshape(G, nc, chunk, P)
    dtg = dt.transpose(0, 2, 1).reshape(G, nc, chunk)
    Ag = np.broadcast_to(A[None], (B, H)).reshape(G)
    bg, cg = (np.broadcast_to(m[:, None], (B, H, S, N))
              .reshape(G, nc, chunk, N) for m in (b, c))
    cast = np.dtype(jnp.bfloat16) if dtype == "bfloat16" else np.float32
    arrs = [xg.astype(cast), dtg.astype(cast), Ag, bg.astype(cast),
            cg.astype(cast)]
    jarrs, tarrs = _both(arrs)
    want = ssd_chunk_pallas(*jarrs, interpret=True)
    got = ref.ssd_chunk_ref(*tarrs)
    for name, g, w in zip(("y_diag", "states", "decays", "acs"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_chunk_scan_matches_reference(B, S, H, P, N, chunk):
    arrs = _ssd_inputs(B * S + H, B, S, H, P, N)
    jarrs, tarrs = _both(arrs)
    y_ref, s_ref = jops.ssd_chunk_scan(*jarrs, chunk)
    y, s = ops.ssd_chunk_scan(*tarrs, chunk)
    assert y.shape == (B, S, H, P) and s.shape == (B, H, N, P)
    _close(y, y_ref, 1e-4)
    _close(s, s_ref, 1e-4)
    # and against the port's own chunked SSD (the oracle of both)
    y_o, s_o = tssm.ssd_chunked(*tarrs, chunk)
    _close(y, y_o, 1e-4)
    _close(s, s_o, 1e-4)


def test_ssd_chunk_scan_chunk_invariance():
    """As the reference's test_chunk_invariance_kernel."""
    _, tarrs = _both(_ssd_inputs(7, 1, 48, 2, 4, 3))
    y8, s8 = ops.ssd_chunk_scan(*tarrs, 8)
    y16, s16 = ops.ssd_chunk_scan(*tarrs, 16)
    np.testing.assert_allclose(y8.numpy(), y16.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s8.numpy(), s16.numpy(), rtol=1e-4, atol=1e-5)


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(j_smoke("mamba2-780m"), dtype=dtype, **kw),
            dataclasses.replace(t_smoke("mamba2-780m"), dtype=dtype, **kw))


@pytest.fixture(scope="module")
def smoke():
    """The float32 smoke configs with an 8-token chunk, the reference's
    parameters in both packages."""
    jcfg, tcfg = _cfgs(ssd_chunk=8)
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _layer(jparams, tparams, i=0):
    return (jax.tree_util.tree_map(lambda a: a[i], jparams["layers"]),
            {k: v[i] for k, v in tparams["layers"].items()})


def test_mixer_kernel_path_matches_reference_kernel_path(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    jcfg = dataclasses.replace(jcfg, use_ssd_kernel=True)
    tcfg = dataclasses.replace(tcfg, use_ssd_kernel=True)
    jl, tl = _layer(jparams, tparams, 1)
    x = np.random.default_rng(4).standard_normal((2, 32, tcfg.d_model)) \
        .astype(np.float32)
    want = jssm.mamba_mixer_prefill(jl, jnp.asarray(x), jcfg)
    got = tssm.mamba_mixer_prefill(tl, torch.as_tensor(x), tcfg)
    _close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# the recurrent decode step and its cache
# ---------------------------------------------------------------------------

# in bfloat16, the serving dtype: the port rounds each op of softplus and
# silu in bf16 in the reference's order (``models.common``), but the bf16
# matmuls sum in different orders, so the port agrees with the reference to
# within a bf16 ulp (2**-7 of the largest magnitude), not to float32
# rounding; a mixer step to an eighth of one (measured 6.8e-5; 2 ulps
# before the activations were rounded op by op)
BF16_ULP = 2.0 ** -7


def _rel(got, want):
    """max |got - want| as a fraction of max |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def smoke_bf16():
    """The bfloat16 smoke configs with an 8-token chunk (the serving
    dtype), the reference's parameters in both packages."""
    jcfg, tcfg = _cfgs("bfloat16", ssd_chunk=8)
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_matches_reference(dtype):
    """Three steps with the state carried across.  In bf16, x, dt, b and c
    are bf16 and the state float32; both cast to float32 before any
    product, so the state agrees to float32 rounding and y to one bf16
    rounding."""
    rng = np.random.default_rng(8)
    B, H, P, N = 3, 4, 8, 5
    cast = np.dtype(jnp.bfloat16) if dtype == "bfloat16" else np.float32
    x = rng.standard_normal((B, H, P)).astype(np.float32).astype(cast)
    dt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32) \
        .astype(cast)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    b, c = (rng.standard_normal((B, N)).astype(np.float32).astype(cast)
            for _ in range(2))
    D = np.linspace(0.5, 1.5, H).astype(np.float32)
    state = rng.standard_normal((B, H, N, P)).astype(np.float32)
    jarrs, tarrs = _both([x, dt, A, b, c, D, state])
    for _ in range(3):                          # the state carried across
        y_ref, s_ref = jssm.ssd_decode(*jarrs)
        y, s = tssm.ssd_decode(*tarrs)
        assert s.data_ptr() == tarrs[-1].data_ptr()       # in place
        assert str(y.dtype).split(".")[-1] == dtype
        assert s.dtype == torch.float32
        if dtype == "float32":
            _close(y, y_ref, 1e-5)
        else:
            assert _rel(y.float(), y_ref) <= BF16_ULP
        _close(s, s_ref, 1e-5)
        jarrs[-1] = s_ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_mixer_decode_matches_reference_with_a_carried_cache(
        dtype, request):
    """Three mixer steps in each layer with a carried cache (the conv
    window in the model's dtype, the state in float32).  float32: within
    1e-5; bf16: the output and both caches within an eighth of a bf16 ulp
    of their largest magnitude."""
    jcfg, tcfg, jparams, tparams = request.getfixturevalue(
        "smoke" if dtype == "float32" else "smoke_bf16")
    cast = np.dtype(jnp.bfloat16) if dtype == "bfloat16" else np.float32
    rng = np.random.default_rng(9)
    B = 2
    for i in range(tcfg.num_layers):
        jl, tl = _layer(jparams, tparams, i)
        jc = jax.tree_util.tree_map(lambda a: a[0],
                                    jlm.init_cache(jcfg, B, 8))
        jc = {k: jnp.asarray(rng.standard_normal(v.shape)
                             .astype(np.float32)).astype(v.dtype)
              for k, v in jc.items()}
        tc = convert.cache_from_numpy(_np(jc), device="cpu")
        assert str(tc["conv"].dtype).split(".")[-1] == dtype
        assert tc["ssm"].dtype == torch.float32
        for _ in range(3):
            (jx,), (tx,) = _both([rng.standard_normal(
                (B, 1, tcfg.d_model)).astype(np.float32).astype(cast)])
            want, jc = jssm.mamba_mixer_decode(jl, jx, jc, jcfg)
            got, tc = tssm.mamba_mixer_decode(tl, tx, tc, tcfg)
            assert str(got.dtype).split(".")[-1] == dtype
            if dtype == "float32":
                _close(got, want, 1e-5)
                for k in ("conv", "ssm"):
                    _close(tc[k], jc[k], 1e-5)
            else:
                assert _rel(got.float(), want) <= BF16_ULP / 8
                for k in ("conv", "ssm"):
                    assert _rel(tc[k].float(), jc[k]) <= BF16_ULP / 8, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference_structure(dtype):
    jcfg, tcfg = _cfgs(dtype)
    want = jlm.init_cache(jcfg, 3, 40)
    got = tlm.init_cache(tcfg, 3, 40, device="cpu")
    assert sorted(got) == sorted(want) == ["conv", "ssm"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert not got[k].any(), k
    assert got["ssm"].dtype == torch.float32


def test_decode_steps_match_reference(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    B, steps = 2, 8
    toks = np.random.default_rng(10).integers(1, tcfg.vocab_size, (B, steps))
    jc = jlm.init_cache(jcfg, B, steps)
    tc = convert.cache_from_numpy(_np(jc), device="cpu")
    for t in range(steps):
        jlog, jc = jlm.decode_step(jcfg, jparams, jc,
                                   jnp.asarray(toks[:, t], jnp.int32),
                                   jnp.int32(t))
        tlog, tc = tlm.decode_step(tcfg, tparams, tc,
                                   torch.as_tensor(toks[:, t]), t)
        assert tlog.shape == (B, tcfg.padded_vocab)
        _close(tlog, jlog, 1e-4)
    for k in ("conv", "ssm"):
        _close(tc[k], jc[k], 1e-4)


def test_decode_steps_bf16_match_reference(smoke_bf16):
    """Eight bf16 decode steps of the smoke LM.  Over two layers and the
    carried state the bf16 roundings add up to several ulps, and near-tied
    greedy tokens may flip, in the reference as much as in the port; so
    both bf16 decodes are held against the reference's float32 decode of
    the same (bf16-valued) weights: at every step the port's error is at
    most twice the reference's own, and the port and the reference differ
    by at most twice the reference's error (logits and caches)."""
    jcfg, tcfg, jparams, tparams = smoke_bf16
    j32 = dataclasses.replace(jcfg, dtype="float32")
    jparams32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                       jparams)
    B, steps = 2, 8
    toks = np.random.default_rng(10).integers(1, tcfg.vocab_size, (B, steps))
    jc, jc32 = jlm.init_cache(jcfg, B, steps), jlm.init_cache(j32, B, steps)
    tc = convert.cache_from_numpy(_np(jc), device="cpu")

    def within(got, want, want32, what):
        ref_err = _rel(want, want32)
        assert _rel(got, want32) <= 2 * ref_err, what
        assert _rel(got, want) <= 2 * ref_err, what

    for t in range(steps):
        tok = jnp.asarray(toks[:, t], jnp.int32)
        jlog, jc = jlm.decode_step(jcfg, jparams, jc, tok, jnp.int32(t))
        jlog32, jc32 = jlm.decode_step(j32, jparams32, jc32, tok,
                                       jnp.int32(t))
        tlog, tc = tlm.decode_step(tcfg, tparams, tc,
                                   torch.as_tensor(toks[:, t]), t)
        assert tlog.dtype == torch.bfloat16
        within(tlog.float(), jlog, jlog32, f"logits, step {t}")
    for k in ("conv", "ssm"):
        within(tc[k].float(), jc[k], jc32[k], k)


@pytest.mark.parametrize("layers", [2, 8])
def test_bf16_prefill_decode_gap_matches_reference(layers):
    """In bf16 the kernel prefill and the decode recurrence round in other
    places, so their last-position logits drift apart as depth grows.  The
    reference's own forward (its Pallas kernel path) and decode step drift
    the same way: at the same depth, the port's gap is within a factor of
    2 of the reference's, both ways."""
    jcfg, tcfg = _cfgs("bfloat16", ssd_chunk=8, num_layers=layers,
                       use_ssd_kernel=True)
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np(jparams), device="cpu")
    B, S = 2, 32
    toks = np.random.default_rng(12).integers(1, tcfg.vocab_size, (B, S))
    jfull, _ = jlm.forward(jcfg, jparams, jnp.asarray(toks, jnp.int32))
    jstep = jax.jit(lambda c, tok, t: jlm.decode_step(jcfg, jparams, c,
                                                      tok, t))
    jc = jlm.init_cache(jcfg, B, S)
    for t in range(S):
        jlog, jc = jstep(jc, jnp.asarray(toks[:, t], jnp.int32),
                         jnp.int32(t))
    first = tserve.prefill_logits(tcfg, tparams, torch.as_tensor(toks))
    tc = tlm.init_cache(tcfg, B, S, device="cpu")
    for t in range(S):
        tlog, tc = tlm.decode_step(tcfg, tparams, tc,
                                   torch.as_tensor(toks[:, t]), t)
    ref_gap = _rel(jfull[:, -1], jlog)
    port_gap = _rel(first[:, 0].float(), tlog.float())
    assert 0 < ref_gap and 0 < port_gap
    assert port_gap <= 2 * ref_gap and ref_gap <= 2 * port_gap, \
        (port_gap, ref_gap)


@pytest.mark.parametrize("kernel", [False, True])
def test_forward_last_only_is_the_last_position(smoke, kernel):
    _, tcfg, _, tparams = smoke
    tcfg = dataclasses.replace(tcfg, use_ssd_kernel=kernel)
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        1, tcfg.vocab_size, (2, 32)))
    full, _ = tlm.forward(tcfg, tparams, toks)
    last, _ = tlm.forward(tcfg, tparams, toks, last_only=True)
    assert last.shape == (2, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel", [False, True])
def test_prefill_decode_parity(smoke, kernel):
    """Every decode step's logits against the chunked forward's (with and
    without the kernel) at that position, as the reference's
    tests/test_lm_parity.py::test_prefill_decode_parity."""
    _, tcfg, _, tparams = smoke
    tcfg = dataclasses.replace(tcfg, use_ssd_kernel=kernel)
    B, S = 2, 32
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        1, tcfg.vocab_size, (B, S)))
    full, _ = tlm.forward(tcfg, tparams, toks)
    cache = tlm.init_cache(tcfg, B, S, device="cpu")
    for t in range(S):
        logits, cache = tlm.decode_step(tcfg, tparams, cache, toks[:, t], t)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# the serving loop
# ---------------------------------------------------------------------------

class _JDecodeState(NamedTuple):
    cache: object
    tok: jax.Array
    emitted: jax.Array
    t: jax.Array


def _reference_serve(cfg, params, prompt, new_tokens):
    """The reference's examples/serve_lm.py loop on its own functions."""
    B, S = prompt.shape

    def greedy(logits):
        return jnp.argmax(logits, -1).astype(jnp.int32) % cfg.vocab_size

    def prefill_step(s, data):
        tok = jax.lax.dynamic_index_in_dim(data["tokens"], s.t, axis=1,
                                           keepdims=False)
        logits, cache = jlm.decode_step(cfg, params, s.cache, tok, s.t)
        return _JDecodeState(cache, greedy(logits), tok, s.t + 1)

    def decode_step(s, data):
        logits, cache = jlm.decode_step(cfg, params, s.cache, s.tok, s.t)
        return _JDecodeState(cache, greedy(logits), s.tok, s.t + 1)

    zeros = jnp.zeros((B,), jnp.int32)
    state = _JDecodeState(jlm.init_cache(cfg, B, S + new_tokens), zeros,
                          zeros, jnp.zeros((), jnp.int32))
    state, _ = JDriver(prefill_step, data={"tokens": jnp.asarray(
        prompt, jnp.int32)}).run(state, S)
    _, traces = JDriver(decode_step, metrics={
        "token": lambda s, d: s.emitted}).run(state, new_tokens)
    return np.asarray(traces["token"]).T


def test_serve_matches_reference_serve_loop():
    jcfg, tcfg = _cfgs()
    jparams = j_init(jcfg, jax.random.PRNGKey(3))
    tparams = convert.params_from_numpy(_np(jparams), device="cpu")
    args = tserve.build_parser().parse_args(
        ["--batch", "3", "--prompt-len", "32", "--new-tokens", "16"])
    prompt = np.random.default_rng(13).integers(1, tcfg.vocab_size, (3, 32))
    want = _reference_serve(jcfg, jparams, prompt, 16)
    res = tserve.serve(tcfg, args, device="cpu", params=tparams,
                       prompt=torch.as_tensor(prompt), log=lambda _: None)
    assert res.tokens.shape == (3, 16)
    np.testing.assert_array_equal(res.tokens, want)
    assert res.state.t == 48
    # the kernel prefill and the recurrence agree at the last prompt token
    first = tserve.prefill_logits(tcfg, tparams, torch.as_tensor(prompt))
    assert res.last_logits.shape == (3, tcfg.padded_vocab)
    np.testing.assert_allclose(first[:, 0].numpy(), res.last_logits.numpy(),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_array_equal(
        res.tokens[:, 0], tserve.greedy(tcfg, first[:, 0]).numpy())


def test_serve_of_zero_new_tokens_returns_a_batch_of_empty_rows():
    """``new_tokens=0``: the generated tokens keep the batch axis, (B, 0),
    as the reference's loop gives (its driver's zero-round trace keeps the
    metric's shape)."""
    jcfg, tcfg = _cfgs()
    jparams = j_init(jcfg, jax.random.PRNGKey(3))
    tparams = convert.params_from_numpy(_np(jparams), device="cpu")
    args = tserve.build_parser().parse_args(
        ["--batch", "3", "--prompt-len", "8", "--new-tokens", "0"])
    prompt = np.random.default_rng(13).integers(1, tcfg.vocab_size, (3, 8))
    want = _reference_serve(jcfg, jparams, prompt, 0)
    res = tserve.serve(tcfg, args, device="cpu", params=tparams,
                       prompt=torch.as_tensor(prompt), log=lambda _: None)
    assert res.tokens.shape == want.shape == (3, 0)
    assert res.state.t == 8


def test_prefill_logits_is_the_kernel_forward(smoke):
    _, tcfg, _, tparams = smoke
    toks = torch.as_tensor(np.random.default_rng(14).integers(
        1, tcfg.vocab_size, (2, 32)))
    got = tserve.prefill_logits(tcfg, tparams, toks)
    want, _ = tlm.forward(dataclasses.replace(tcfg, use_ssd_kernel=True),
                          tparams, toks, last_only=True)
    assert torch.equal(got, want)
    assert got.is_inference()


# ---------------------------------------------------------------------------
# the driver on a state without bits_sent (a serving state)
# ---------------------------------------------------------------------------

class _Counter(NamedTuple):
    x: torch.Tensor
    t: int


def _count(s, d):
    return _Counter(x=s.x + d, t=s.t + 1)


class _JCounter(NamedTuple):
    x: jax.Array
    t: jax.Array


@pytest.mark.parametrize("rounds", [0, 5])
def test_driver_runs_a_state_without_bits_sent(rounds):
    state, tr = tdriver.Driver(_count, data=torch.ones(()), chunk=2,
                               metrics={"x": lambda s, d: s.x}).run(
        _Counter(torch.zeros(()), 0), rounds)
    _, jtr = JDriver(lambda s, d: _JCounter(s.x + d, s.t + 1),
                     data=jnp.ones(()), chunk=2,
                     metrics={"x": lambda s, d: s.x}).run(
        _JCounter(jnp.zeros(()), jnp.zeros((), jnp.int32)), rounds)
    assert sorted(tr) == sorted(jtr) == ["x"]
    assert state.t == rounds
    np.testing.assert_array_equal(tr["x"], np.asarray(jtr["x"]))
