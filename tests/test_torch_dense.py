"""The port's dense GQA family (starcoder2, minitron, qwen1.5) against the
reference (CPU).

* attention: the port's counterparts of ``tests/test_attention.py`` —
  streaming == dense with and without a window and softcap, the gradient
  through the streaming path, prefill/decode parity, sliding-window ring
  parity across the wrap, QKV bias — each also against the reference's
  function on the same arrays; the bf16 cast order of both paths; the
  non-ring cache clamp at t >= T (``lax.dynamic_update_slice``);
* ``lm.forward`` (dense and streaming), ``loss_fn`` with out-of-vocab
  labels masked, ``last_only``, ``init_cache`` and ``decode_step`` past
  the smoke window against the reference's for the three smoke configs in
  float32, on ``convert.params_from_numpy`` of the reference's
  parameters (``tests/test_lm_parity.py``'s ``PARITY_ARCHS`` entries);
* the configs field for field, and ``param_count`` of the full configs;
* the families still refused, each by name;
* a few trainer rounds of DASHA and DASHA-MVR on starcoder2 smoke with the
  reference's masks and batches replayed, plain and kernel routes;
* a sweep's lanes on the tree substrate against sequential runs.

Tolerances: float32 outputs agree to 1e-5 of their largest magnitude (the
two frameworks sum matmuls and einsums in different orders; measured:
forward and decode logits 7e-7 of max |logit|); the streaming path against
the dense one to rtol 2e-4 / atol 2e-5 (the reference's own test);
gradients to rtol 1e-3 / atol 1e-6 (the reference's).  bf16 attention
against the reference's bf16 to 2e-2 of the largest output (one bf16 ulp is
8e-3) and 4e-3 of the mean magnitude on average (measured: dense 1.9e-3 and
3e-7 with the scale rounded to bf16 as JAX rounds it, 1.6e-2 and 1.9e-3
unrounded; streaming 1.9e-3 and 2e-7; the dense path with the streaming
path's cast order reads 8.7e-3 on average).  Trainer states after three
rounds agree to 2e-4 of each leaf's largest magnitude
(``tests/test_torch_train.py``'s bound for the Mamba2 slice); tree lanes
equal sequential runs to fp32 rounding (rtol 1e-6; measured equal bit for
bit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import treelevel as jtl
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.data.pipeline import SyntheticTextConfig as JText
from repro.data.pipeline import make_node_batches as j_node_batches
from repro.methods.driver import Driver as JDriver
from repro.models import attention as jattn
from repro.models import init_params as j_init
from repro.models import lm as jlm
from repro.models.common import ArchConfig as JArchConfig
from repro.optim import distributed as jdist
from repro_torch import convert
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import tree
from repro_torch.core.rng import Draws
from repro_torch.data.pipeline import SyntheticTextConfig, make_node_batches
from repro_torch.launch import train as ttrain
from repro_torch.methods import Driver as TDriver
from repro_torch.methods import (BatchLossOracle, Hyper, Lanes,
                                 LaneTreeSubstrate, Method, TreeCompression,
                                 TreeSubstrate, sweep)
from repro_torch.models import attention as tattn
from repro_torch.models import init_params as t_init
from repro_torch.models import lm as tlm
from repro_torch.models.common import ArchConfig
from repro_torch.optim import distributed as tdist
from repro_torch.optim.base import SGD

torch.set_num_threads(1)

DENSE_ARCHS = ["starcoder2-3b", "minitron-8b", "qwen1.5-110b"]
N = 4


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _port(t):
    return convert.params_from_numpy(_np(t), device="cpu")


def _rand(seed, shape, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close_of_max(got, want, frac, what=""):
    """|got - want| <= frac * max|want|, elementwise."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= frac * scale, f"{what}: {err} > {frac} x {scale}"


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# attention (tests/test_attention.py on the port)
# ---------------------------------------------------------------------------

def _qkv(seed, B=1, S=1024, G=2, R=3, hd=32):
    return (_rand(seed, (B, S, G, R, hd)), _rand(seed + 1, (B, S, G, hd)),
            _rand(seed + 2, (B, S, G, hd)))


@pytest.mark.parametrize("window,cap", [(0, 0.0), (64, 0.0), (0, 30.0),
                                        (128, 20.0)])
def test_flash_matches_dense_and_the_reference(window, cap):
    q, k, v = _qkv(0)
    hd = q.shape[-1]
    pos = np.arange(q.shape[1])
    tq, tk, tv, tpos = _t(q), _t(k), _t(v), _t(pos)
    dense = tattn._sdpa(tq, tk, tv, tpos, tpos, window, cap, hd ** -0.5)
    flash = tattn._flash_sdpa(tq, tk, tv, tpos, tpos, window, cap,
                              hd ** -0.5)
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-5)
    jpos = jnp.asarray(pos)
    for fn, got in ((jattn._sdpa, dense), (jattn._flash_sdpa, flash)):
        want = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpos, jpos,
                  window, cap, hd ** -0.5)
        _close_of_max(got.numpy(), want, 1e-5, fn.__name__)


def test_flash_gradient_matches_dense_and_the_reference():
    q, k, v = _qkv(3, S=1024, G=1, R=2, hd=16)
    hd = q.shape[-1]
    pos = np.arange(q.shape[1])
    tpos = _t(pos)

    def grads(fn):
        ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
        loss = torch.sum(fn(*ts, tpos, tpos, 0, 0.0, hd ** -0.5) ** 2)
        return torch.autograd.grad(loss, ts)

    gd, gf = grads(tattn._sdpa), grads(tattn._flash_sdpa)
    jpos = jnp.asarray(pos)
    want = jax.grad(lambda *a: jnp.sum(jattn._flash_sdpa(
        *a, jpos, jpos, 0, 0.0, hd ** -0.5) ** 2), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b, w in zip(gd, gf, want):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-3,
                                   atol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-6)


@pytest.mark.parametrize("path", ["dense", "streaming"])
def test_bf16_attention_keeps_each_paths_cast_order(path):
    """bf16 inputs: the dense path scales in bf16 and casts at the mask,
    the streaming path casts before it scales; each against the
    reference's own path."""
    q, k, v = (a * 20 for a in _qkv(7, S=1024))
    hd = q.shape[-1]
    pos = np.arange(q.shape[1])
    tfn, jfn = {"dense": (tattn._sdpa, jattn._sdpa),
                "streaming": (tattn._flash_sdpa, jattn._flash_sdpa)}[path]
    got = tfn(*(_t(a).to(torch.bfloat16) for a in (q, k, v)), _t(pos),
              _t(pos), 0, 0.0, hd ** -0.5)
    want = jfn(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
               jnp.asarray(pos), jnp.asarray(pos), 0, 0.0, hd ** -0.5)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    _close_of_max(got, want, 2e-2, path)
    # the mean error tells the cast orders apart: the dense path scaled
    # after its float32 cast reads 8.7e-3 of the mean magnitude here
    assert np.abs(got - want).mean() <= 4e-3 * np.abs(want).mean()


def _gqa_cfgs(**kw):
    base = dict(name="t", arch_type="dense", num_layers=1, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                dtype="float32")
    base.update(kw)
    return JArchConfig(**base), ArchConfig(**base)


def _gqa_params(jcfg, seed):
    from repro.models.init import _gqa_params
    p = _gqa_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if jcfg.qkv_bias:       # nonzero biases, so that they are exercised
        p = dict(p, **{b: jnp.asarray(_rand(seed + i, p[b].shape, 0.3))
                       for i, b in enumerate(("bq", "bk", "bv"))})
    return p, _port(p)


def _empty_cache(B, T, cfg):
    return ({"k": jnp.zeros((B, T, cfg.num_kv_heads, cfg.head_dim)),
             "v": jnp.zeros((B, T, cfg.num_kv_heads, cfg.head_dim))},
            {"k": torch.zeros((B, T, cfg.num_kv_heads, cfg.head_dim)),
             "v": torch.zeros((B, T, cfg.num_kv_heads, cfg.head_dim))})


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_gqa_prefill_decode_parity(qkv_bias):
    """Decoding token by token reproduces the prefill, in both packages
    and between them."""
    jcfg, tcfg = _gqa_cfgs(qkv_bias=qkv_bias)
    jp, tp = _gqa_params(jcfg, 2)
    B, S = 2, 8
    x = _rand(3, (B, S, tcfg.d_model), 0.5)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    full = tattn.gqa_prefill(tp, _t(x), _t(pos), tcfg)
    jfull = jattn.gqa_prefill(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    _close_of_max(full.numpy(), jfull, 1e-5, "prefill")
    jcache, cache = _empty_cache(B, S, tcfg)
    for t in range(S):
        out, cache = tattn.gqa_decode(tp, _t(x[:, t:t + 1]), t, cache, tcfg)
        jout, jcache = jattn.gqa_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                        jnp.int32(t), jcache, jcfg)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-5)
        _close_of_max(out.numpy(), jout, 1e-5, f"decode {t}")
    _close_of_max(cache["k"].numpy(), jcache["k"], 1e-6, "k cache")


def test_gqa_sliding_window_ring_parity_across_the_wrap():
    """Ring-buffer decode == windowed prefill for window < S (the ring
    wraps twice), and == the reference's ring decode."""
    W = 4
    jcfg, tcfg = _gqa_cfgs(sliding_window=W)
    jp, tp = _gqa_params(jcfg, 4)
    B, S = 1, 10
    x = _rand(5, (B, S, tcfg.d_model), 0.5)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    full = tattn.gqa_prefill(tp, _t(x), _t(pos), tcfg, window=W)
    jcache, cache = _empty_cache(B, W, tcfg)
    for t in range(S):
        out, cache = tattn.gqa_decode(tp, _t(x[:, t:t + 1]), t, cache, tcfg,
                                      ring=True)
        jout, jcache = jattn.gqa_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                        jnp.int32(t), jcache, jcfg,
                                        ring=True)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-5)
        _close_of_max(out.numpy(), jout, 1e-5, f"ring decode {t}")
    _close_of_max(cache["v"].numpy(), jcache["v"], 1e-6, "ring v cache")


def test_ring_written_at_t_instead_of_t_mod_T_would_differ():
    """The ring's write slot matters: a cache written at slot t (clamped,
    no modulo) past the wrap gives other outputs than the ring."""
    W = 4
    _, tcfg = _gqa_cfgs(sliding_window=W)
    jcfg, _ = _gqa_cfgs(sliding_window=W)
    _, tp = _gqa_params(jcfg, 4)
    x = _rand(6, (1, 7, tcfg.d_model), 0.5)
    _, ring = _empty_cache(1, W, tcfg)
    _, flat = _empty_cache(1, W, tcfg)
    for t in range(7):
        a, ring = tattn.gqa_decode(tp, _t(x[:, t:t + 1]), t, ring, tcfg,
                                   ring=True)
        b, flat = tattn.gqa_decode(tp, _t(x[:, t:t + 1]), t, flat, tcfg)
    assert float((a - b).abs().max()) > 1e-4


@pytest.mark.parametrize("window", [0, 3])
def test_non_ring_cache_clamps_its_write_at_t_past_T(window):
    """``lax.dynamic_update_slice`` clamps its start index: a non-ring
    cache of T slots written at t >= T overwrites slot T - 1, where a torch
    index would raise.  The port mirrors the clamp."""
    jcfg, tcfg = _gqa_cfgs()
    jp, tp = _gqa_params(jcfg, 8)
    B, T = 2, 5
    x = _rand(9, (B, T + 3, tcfg.d_model), 0.5)
    jcache, cache = _empty_cache(B, T, tcfg)
    for t in range(T + 3):
        before = cache["k"].clone()
        out, cache = tattn.gqa_decode(tp, _t(x[:, t:t + 1]), t, cache, tcfg,
                                      window=window)
        jout, jcache = jattn.gqa_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                        jnp.int32(t), jcache, jcfg,
                                        window=window)
        _close_of_max(out.numpy(), jout, 1e-5, f"t={t}")
        _close_of_max(cache["k"].numpy(), jcache["k"], 1e-6, f"k t={t}")
        changed = (cache["k"] != before).flatten(2).any(-1).any(0)
        assert changed.nonzero().flatten().tolist() == [min(t, T - 1)]


def test_qkv_bias_is_applied():
    jcfg, tcfg = _gqa_cfgs(qkv_bias=True)
    _, tp = _gqa_params(jcfg, 10)
    x = _t(_rand(11, (1, 4, tcfg.d_model), 0.5))
    pos = torch.arange(4, dtype=torch.int32)[None]
    with_bias = tattn.gqa_prefill(tp, x, pos, tcfg)
    without = tattn.gqa_prefill(dict(tp, bq=torch.zeros_like(tp["bq"])), x,
                                pos, tcfg)
    assert float((with_bias - without).abs().max()) > 1e-4


@pytest.mark.parametrize("window", [0, 700])
def test_gqa_prefill_takes_the_streaming_path_at_2048(window):
    """S = 2,048: the 512-query blocks over 512-key blocks, against the
    reference's streaming prefill and the port's dense path."""
    jcfg, tcfg = _gqa_cfgs(d_model=32, num_heads=2, num_kv_heads=1,
                           qkv_bias=True)
    jp, tp = _gqa_params(jcfg, 12)
    S = tattn.QBLOCK_THRESHOLD
    x = _rand(13, (1, S, tcfg.d_model), 0.5)
    pos = np.arange(S, dtype=np.int32)[None]
    got = tattn.gqa_prefill(tp, _t(x), _t(pos), tcfg, window=window)
    want = jattn.gqa_prefill(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                             window=window)
    _close_of_max(got.numpy(), want, 1e-5, "streaming prefill")
    dense = tattn.gqa_prefill(tp, _t(x[:, :-1]), _t(pos[:, :-1]), tcfg,
                              window=window)
    np.testing.assert_allclose(got[:, :-1].numpy(), dense.numpy(),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("window", [0, 700, 1500])
def test_streaming_path_skips_hidden_blocks_bit_for_bit(window):
    """The streaming prefill skips the key blocks the mask hides from a
    whole query block; the carry is left exactly as visiting them would
    leave it, so the output equals the every-block loop bit for bit."""
    _, tcfg = _gqa_cfgs(d_model=32, num_heads=4, num_kv_heads=2)
    jcfg, _ = _gqa_cfgs(d_model=32, num_heads=4, num_kv_heads=2)
    _, tp = _gqa_params(jcfg, 14)
    S = 2 * tattn.QBLOCK_THRESHOLD
    x = _t(_rand(15, (1, S, tcfg.d_model), 0.5))
    pos = torch.arange(S, dtype=torch.int32)[None]
    got = tattn.gqa_prefill(tp, x, pos, tcfg, window=window)
    q, k, v = tattn._project_qkv(tp, x, pos, tcfg)
    q = q.reshape(1, S, 2, 2, tcfg.head_dim)
    every = torch.cat([tattn._flash_sdpa(
        q[:, i:i + tattn.QBLOCK], k, v, pos[0, i:i + tattn.QBLOCK], pos[0],
        window, 0.0, tcfg.head_dim ** -0.5)
        for i in range(0, S, tattn.QBLOCK)], 1).reshape(1, S, 4, -1)
    assert torch.equal(got, torch.einsum("bshk,hkd->bsd", every,
                                         tp["wo"]))
    visible = tattn._visible_blocks(S, window)
    n = S // tattn.QBLOCK
    assert sum(map(sum, visible)) < n * n
    assert all(row[i] and not any(row[i + 1:])
               for i, row in enumerate(visible))


# ---------------------------------------------------------------------------
# the LM against the reference (tests/test_lm_parity.py's dense entries)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=DENSE_ARCHS)
def dense_model(request):
    arch = request.param
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(t_smoke(arch), dtype="float32")
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    return arch, jcfg, tcfg, jp, _port(jp)


def _tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)) \
        .astype(np.int32)


def test_forward_matches_reference(dense_model):
    _, jcfg, tcfg, jp, tp = dense_model
    tok = _tokens(0, 2, 40)
    got, aux = tlm.forward(tcfg, tp, _t(tok).long())
    want, jaux = jlm.forward(jcfg, jp, jnp.asarray(tok), remat=False)
    assert got.shape == want.shape == (2, 40, tcfg.padded_vocab)
    _close_of_max(got.numpy(), want, 1e-5, "logits")
    assert float(aux) == float(jaux) == 0.0
    last, _ = tlm.forward(tcfg, tp, _t(tok).long(), last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_streaming_forward_matches_reference():
    """starcoder2 smoke at 2,048 tokens: every layer takes the streaming
    path under its 16-token window."""
    jcfg = dataclasses.replace(j_smoke("starcoder2-3b"), dtype="float32")
    tcfg = dataclasses.replace(t_smoke("starcoder2-3b"), dtype="float32")
    jp = j_init(jcfg, jax.random.PRNGKey(3))
    tok = _tokens(1, 1, tattn.QBLOCK_THRESHOLD)
    got, _ = tlm.forward(tcfg, _port(jp), _t(tok).long(), last_only=True)
    want, _ = jlm.forward(jcfg, jp, jnp.asarray(tok), remat=False,
                          last_only=True)
    _close_of_max(got.numpy(), want, 1e-5, "streaming logits")


def test_loss_matches_reference_and_masks_out_of_vocab_labels(dense_model):
    _, jcfg, tcfg, jp, tp = dense_model
    tok = _tokens(2, 2, 12)
    labels = _tokens(3, 2, 12)
    labels[0, 1], labels[0, 5], labels[1, 7] = -1, tcfg.vocab_size + 5, \
        tcfg.padded_vocab - 1
    batch = {"tokens": tok, "labels": labels}
    loss, m = tlm.loss_fn(tcfg, tp, {k: _t(v).long()
                                     for k, v in batch.items()})
    jloss, jm = jlm.loss_fn(jcfg, jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    clean = labels.copy()
    clean[0, 1], clean[0, 5], clean[1, 7] = 1, 1, 1
    other, _ = tlm.loss_fn(tcfg, tp, {"tokens": _t(tok).long(),
                                      "labels": _t(clean).long()})
    assert float(other) != float(loss)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("seq", [8, 40])
def test_init_cache_matches_reference(arch, seq):
    for jcfg, tcfg in ((j_smoke(arch), t_smoke(arch)),
                       (dataclasses.replace(j_smoke(arch), dtype="float32"),
                        dataclasses.replace(t_smoke(arch),
                                            dtype="float32"))):
        want = jlm.init_cache(jcfg, 3, seq)
        got = tlm.init_cache(tcfg, 3, seq, device="cpu")
        assert sorted(got) == sorted(want) == ["k", "v"]
        for k in got:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)
            assert not got[k].any()
    ring = tcfg.sliding_window and tcfg.sliding_window < 40
    assert tlm.init_cache(tcfg, 1, 40, device="cpu")["k"].shape[2] == \
        (tcfg.sliding_window if ring else 40)


def test_decode_steps_match_reference_past_the_window(dense_model):
    """24 steps, past starcoder2 smoke's 16-slot ring: logits and the
    cache against the reference's decode, and the last step against the
    forward's last position."""
    _, jcfg, tcfg, jp, tp = dense_model
    B, S = 2, 24
    tok = _tokens(4, B, S)
    jcache = jlm.init_cache(jcfg, B, S)
    cache = convert.cache_from_numpy(_np(jcache), device="cpu")
    for t in range(S):
        logits, cache = tlm.decode_step(tcfg, tp, cache, _t(tok[:, t]).long(),
                                        t)
        jlogits, jcache = jlm.decode_step(jcfg, jp, jcache,
                                          jnp.asarray(tok[:, t]),
                                          jnp.int32(t))
        _close_of_max(logits.numpy(), jlogits, 1e-5, f"step {t}")
    for k in ("k", "v"):
        _close_of_max(cache[k].numpy(), jcache[k], 1e-5, k)
    full, _ = tlm.forward(tcfg, tp, _t(tok).long(), last_only=True)
    _close_of_max(logits.numpy(), full[:, 0].numpy(), 1e-5, "vs forward")


# ---------------------------------------------------------------------------
# configs, counts and the families not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_configs_are_the_reference_configs_field_for_field(arch):
    for j, t in ((j_config(arch), t_config(arch)),
                 (j_smoke(arch), t_smoke(arch))):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.padded_vocab == j.padded_vocab
    assert t_config(arch).head_dim == j_config(arch).head_dim


@pytest.mark.parametrize("arch", DENSE_ARCHS + ["mamba2-780m"])
def test_param_count_is_the_reference_count(arch):
    t, j = t_config(arch), j_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_init_params_has_the_reference_tree():
    tcfg, jcfg = t_smoke("starcoder2-3b"), j_smoke("starcoder2-3b")
    got = t_init(tcfg, 5, device="cpu")
    want = jax.tree_util.tree_leaves_with_path(j_init(jcfg,
                                                      jax.random.PRNGKey(0)))
    assert [p for p, _ in tree.items(got)] == [
        "/".join(k.key for k in path) for path, _ in want]
    for (_, g), (_, w) in zip(tree.items(got), want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
    assert len(tree.leaves(got)) == 16
    w = got["layers"]["attn"]["wq"].float()
    assert abs(float(w.std()) * np.sqrt(tcfg.d_model) - 1.0) < 0.05
    assert not got["layers"]["ffn"]["b_in"].any()


def _family_cfg(**kw):
    base = dict(name="x", arch_type="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
    base.update(kw)
    return ArchConfig(**base)


@pytest.mark.parametrize("kw,family", [
    (dict(arch_type="retnet", num_experts=4, experts_per_token=2),
     "retnet"),
    (dict(arch_type="rwkv", hybrid_attn_every=2, ssm_state=16), "rwkv"),
    (dict(arch_type="retnet"), "retnet"),
    (dict(arch_type="retnet", use_mla=True, kv_lora_rank=16), "retnet"),
    (dict(arch_type="rwkv", global_every=2, sliding_window=16), "rwkv")])
def test_other_families_still_raise_naming_the_family(kw, family):
    """An ``arch_type`` that neither package has raises, naming the
    family, also when its config carries the MoE, MLA, grouped-attention
    or hybrid fields the port runs (every family of the reference is
    ported, so only an unknown one is refused)."""
    cfg = _family_cfg(**kw)
    tok = torch.ones((1, 4), dtype=torch.int64)
    for call in (lambda: t_init(cfg, 0, device="cpu"),
                 lambda: tlm.forward(cfg, {}, tok),
                 lambda: tlm.init_cache(cfg, 1, 4, device="cpu"),
                 lambda: tlm.decode_step(cfg, {}, {}, tok[:, 0], 0)):
        with pytest.raises(NotImplementedError, match=family):
            call()
    with pytest.raises(ValueError, match="not ported"):
        t_config(family)


# ---------------------------------------------------------------------------
# trainer rounds with the reference's draws replayed
# ---------------------------------------------------------------------------

ROUNDS, SEQ = 3, 32


def _reference_masks(key, h_local, cfg):
    _, _, k_c, _ = jax.random.split(key, 4)
    masks, _ = jtl.tree_masks(k_c, h_local, mode=cfg.mode,
                              p=cfg.compression, n=cfg.n_nodes)
    return Draws(masks=_port(masks))


def _state_arrays(s):
    opt = s.opt_state
    opt = {"mu": _np(opt.mu), "nu": _np(opt.nu), "count": np.asarray(
        opt.count)} if hasattr(opt, "mu") else ()
    return {"x": _np(s.x), "g": _np(s.g), "g_local": _np(s.g_local),
            "h_local": _np(s.h_local), "opt_state": opt,
            "t": np.asarray(s.t), "bits_sent": np.asarray(s.bits_sent)}


def _assert_trees_close_of_max(got, want, frac, what):
    flat_w = {"/".join(p.key for p in path): np.asarray(v, np.float32)
              for path, v in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = dict(tree.items(got))
    assert sorted(flat_g) == sorted(flat_w), what
    for name, g in flat_g.items():
        _close_of_max(g.to(torch.float32).numpy(), flat_w[name], frac,
                      f"{what} {name}")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("variant", ["dasha", "mvr"])
def test_trainer_rounds_match_reference_on_starcoder2_smoke(variant,
                                                            use_kernel):
    """make_method + Driver on starcoder2-smoke (float32), n = 4, three
    rounds with the reference's batches and masks replayed; SGD server
    (Adam turns gradient rounding noise into whole steps, see
    ``tests/test_torch_train.py``)."""
    jcfg = dataclasses.replace(j_smoke("starcoder2-3b"), dtype="float32")
    tcfg = dataclasses.replace(t_smoke("starcoder2-3b"), dtype="float32")
    kw = dict(gamma=0.05, compression=0.25, mode="independent",
              variant=variant, b=0.1, n_nodes=N, server_opt="sgd",
              use_kernel=use_kernel)
    jtc, ttc = jdist.DashaTrainConfig(**kw), tdist.DashaTrainConfig(**kw)
    jmethod = jdist.make_method(jtc, lambda p, b: jlm.loss_fn(jcfg, p, b)[0])
    tmethod = tdist.make_method(ttc, lambda p, b: tlm.loss_fn(tcfg, p, b)[0])
    jstate = jmethod.init(j_init(jcfg, jax.random.PRNGKey(0)),
                          jax.random.PRNGKey(1), init_mode="zeros")
    tstate = convert.tree_state_from_numpy(_state_arrays(jstate), seed=0,
                                           device="cpu")
    text = JText(vocab_size=jcfg.vocab_size, seq_len=SEQ)
    data_key = jax.random.PRNGKey(2)
    batches, draws, key = [], [], jstate.key
    for t in range(ROUNDS):
        b = j_node_batches(jax.random.fold_in(data_key, t), text, N, 2)
        batches.append({k: torch.as_tensor(np.array(v), dtype=torch.int64)
                        for k, v in b.items()})
        draws.append(_reference_masks(key, jstate.h_local, jtc))
        key = jax.random.split(key, 4)[0]
    jfinal, _ = JDriver(jmethod, data_fn=lambda k, t: j_node_batches(
        k, text, N, 2), chunk=ROUNDS).run(jstate, ROUNDS, data_key=data_key)

    def step(st, data):
        return tmethod.step_full(st, data, draws=draws[st.t])[0]

    tfinal, traces = TDriver(step, data_fn=lambda seed, t: batches[t]).run(
        tstate, ROUNDS, data_seed=0)
    for name in ("x", "g", "g_local", "h_local"):
        _assert_trees_close_of_max(getattr(tfinal, name),
                                   getattr(jfinal, name), 2e-4, name)
    assert tfinal.t == int(jfinal.t)
    assert tfinal.bits_sent == np.float32(jfinal.bits_sent)
    assert traces["bits_sent"].shape == (ROUNDS,)


def test_train_defaults_to_starcoder2_and_runs_it_on_the_cpu():
    args = ttrain.build_parser().parse_args(
        ["--steps", "2", "--log-every", "1", "--seq", "32", "--variant",
         "mvr", "--use-kernel"])
    assert args.arch == "starcoder2-3b"
    lines = []
    res = ttrain.train(t_smoke(args.arch), args, device="cpu",
                       log=lines.append)
    assert lines[0].startswith("[train] arch=starcoder2-smoke layers=2")
    assert len(tree.leaves(res.state.x)) == 16
    assert res.state.t == 2
    assert all(np.isfinite(c["loss"]) for c in res.chunks)


# ---------------------------------------------------------------------------
# a sweep's lanes on the tree substrate
# ---------------------------------------------------------------------------

GAMMAS = np.array([0.0005, 0.001, 0.003])


def _lane_setup(kw, use_kernel, server_opt="adam"):
    cfg = t_smoke("starcoder2-3b")
    params = t_init(cfg, 0, device="cpu")
    text = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=SEQ)

    def data_fn(seed, t):
        return make_node_batches(seed, text, N, 2, device="cpu")

    def method_fn(gamma):
        return tdist.make_method(tdist.DashaTrainConfig(
            gamma=gamma, n_nodes=N, server_opt=server_opt,
            use_kernel=use_kernel, **kw),
            lambda p, b: tlm.loss_fn(cfg, p, b)[0])

    state = method_fn(float(GAMMAS[0])).init(params, 1, init_mode="zeros",
                                             device="cpu")
    return method_fn, state, data_fn


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kw,server_opt", [
    (dict(compression=1 / 32), "adam"),
    (dict(compression=1 / 32, variant="mvr", b=0.2), "adam"),
    (dict(mode="permk"), "sgd")])
def test_tree_lanes_equal_sequential_runs(kw, server_opt, use_kernel):
    """Lane j of a 3-lane sweep on starcoder2 smoke (bf16 parameters,
    float32 state) is a sequential Driver run at gamma_j: the same masks
    and batches; every state leaf, Adam's moments, bits_sent."""
    method_fn, state, data_fn = _lane_setup(kw, use_kernel, server_opt)
    final, traces = sweep(method_fn, GAMMAS, state, 3, data_fn=data_fn,
                          data_seed=2, device="cpu")
    assert traces["bits_sent"].shape == (3, 3)
    for j, gamma in enumerate(GAMMAS):
        seq, tr = TDriver(method_fn(float(gamma)), data_fn=data_fn).run(
            state, 3, data_seed=2)
        names = ["x", "g", "g_local", "h_local"]
        pairs = [(getattr(final, n), getattr(seq, n)) for n in names]
        if server_opt == "adam":
            pairs += [(final.opt_state.mu, seq.opt_state.mu),
                      (final.opt_state.nu, seq.opt_state.nu)]
            assert final.opt_state.count == seq.opt_state.count
        for lanes_tree, one in pairs:
            for path, w in tree.items(one):
                g = tree.get(lanes_tree, path)[j]
                assert g.dtype == w.dtype, path
                np.testing.assert_allclose(g.float().numpy(),
                                           w.float().numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=path)
        np.testing.assert_array_equal(traces["bits_sent"][j],
                                      tr["bits_sent"])
    # the lanes moved apart: a lane run at its neighbour's gamma would not
    # pass the check above
    x = final.x["layers"]["attn"]["wq"].float()
    assert float((x[0] - x[2]).abs().max()) > 0


def test_tree_lanes_share_one_mask_draw_and_one_kernel_launch_a_leaf(
        monkeypatch):
    """The fused tree path launches its kernel once per leaf a round for
    all G * n rows, each reading the round's one draw."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.dasha_mvr_update

    def spy(gn, go, h, gl, mask, a, b, scale):
        calls.append((tuple(gn.shape), tuple(mask.shape)))
        return real(gn, go, h, gl, mask, a, b, scale)

    monkeypatch.setattr(ops, "dasha_mvr_update", spy)
    method_fn, state, data_fn = _lane_setup(
        dict(compression=1 / 32, variant="mvr", b=0.2), True)
    sweep(method_fn, GAMMAS, state, 1, data_fn=data_fn, data_seed=2,
          device="cpu")
    assert len(calls) == len(tree.leaves(state.x)) == 16
    for rows, mask in calls:
        assert rows[0] == len(GAMMAS) * N and mask[0] == N


def test_tree_lanes_refuse_kernel_scalars_and_deficits():
    """The kernels take a and 1 - b per lane now, so both may vary by
    lane on the fused tree path (held against sequential runs in
    ``tests/test_torch_lanes_more.py``); asynchronous deficits still have
    no lane form."""
    cfg = t_smoke("starcoder2-3b")
    sub = TreeSubstrate(
        oracle=BatchLossOracle(lambda p, b: tlm.loss_fn(cfg, p, b)[0]),
        n=N, server_opt=SGD(lr=0.1))
    comp = TreeCompression(n=N, p=0.5, use_kernel=True)
    for variant, hp in (("mvr", Hyper(gamma=0.1, a=0.2,
                                      b=Lanes([0.1, 0.2]))),
                        ("dasha", Hyper(gamma=0.1, a=Lanes([0.1, 0.2])))):
        m = Method.build(variant, comp, sub, hp)
        with pytest.raises(ValueError, match="sweep it"):
            m.init(None, 1)
    lanes = sub.with_compressor(comp).with_lanes(2)
    assert isinstance(lanes, LaneTreeSubstrate) and lanes.lanes == 2
    with pytest.raises(ValueError, match="no lane form"):
        lanes.sub_deficit({}, {})
