"""The port's cross-attention families against the reference (CPU): the
VLM (llama-3.2-vision-11b: a gated cross-attention block to the image
embeddings after every ``cross_attn_every``-th layer) and the
encoder-decoder (whisper-tiny: an encoder over the frame embeddings, a
cross block after every decoder layer), at their smoke configs.

* configs field for field, ``param_count`` of the full and smoke configs,
  ``init_params`` trees (names, shapes, dtypes; the full trees on the
  ``meta`` device) and ``params_from_numpy`` bit for bit;
* ``cross_attn``, ``cross_attn_cached`` and ``cross_kv`` in float32 and
  bf16 (the attention scale rounded to bf16 first, as JAX rounds the
  weak-typed scalar); the query-blocked cross attention equal to the
  dense one;
* ``forward`` and ``loss_fn`` in float32 and in bf16 (against the
  reference's blocks run one by one, as ``tests/test_torch_hybrid.py``
  does), the modality batches of ``make_lm_batch``;
* ``init_cache``, ``make_image_kv`` / ``make_enc_kv`` and ``decode_step``
  against the reference's decode and against the forward; ``serve``
  against ``prefill_logits``;
* the loss gradients of the gates and the cross weights against
  ``jax.grad``; DASHA-MVR trainer rounds on the reference's batches and
  replayed masks, plain and kernel routes;
* planted faults that must fail: the gates zeroed in the port only, the
  VLM's cross block after the wrong layers (``idx % every == 0``), and a
  bidirectional whisper encoder (the reference's attends causally).

The gates start at zero (a fresh cross block adds nothing), so every
parity check here runs on the reference's tree with the gates set to 0.5
(attention) and -0.3 (MLP) in numpy before it is carried across.

Tolerances: float32 logits within 1e-5 of the largest magnitude
(``tests/test_torch_dense.py``'s), decode logits and every cache leaf
within 1e-5, the decode against the forward's last position within 1e-5;
the cross-attention ops within 1e-6 (float32) and 1e-4 (bf16) of their
largest output (measured 0 and 2e-8: the same ops in the same order);
the blocked cross attention bit for bit; gradients within 1e-4 of each
leaf's largest magnitude (``tests/test_torch_hybrid.py``'s); trainer
states within 2e-4 of each leaf's largest magnitude
(``torch_models_common``'s bound).  bf16
forward against the reference's blocks one by one: within 0.05 of the
largest logit and a mean error of 0.015 of the mean magnitude (the
hybrid family's bounds).  A planted fault must move the logits by more
than 1e-2 of the largest.
"""
import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.data.pipeline import SyntheticTextConfig as JText
from repro.data.pipeline import make_node_batches as j_node_batches
from repro.methods.driver import Driver as JDriver
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import init_params as j_init
from repro.models import lm as jlm
from repro.optim import distributed as jdist
from repro_torch import convert
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import tree
from repro_torch.data.pipeline import (SyntheticTextConfig, make_lm_batch,
                                       make_node_batches, modality_kw)
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import init_params as t_init
from repro_torch.models import lm as tlm
from torch_models_common import (N_NODES, _reference_masks, _state_arrays,
                                 assert_configs_equal,
                                 assert_init_tree_matches,
                                 assert_param_counts,
                                 assert_port_trainer_rounds, close_of_max,
                                 f32_smoke, j_init_jit, np_tree, port, rand,
                                 tokens, tt)

torch.set_num_threads(1)

VLM, AUDIO = "llama-3.2-vision-11b", "whisper-tiny"
ARCHS = (VLM, AUDIO)
GATES = {"attn_gate": 0.5, "mlp_gate": -0.3}
SEQ = 24
FAULT = 1e-2


def _gated(jp):
    """The reference's tree as numpy, every cross block's gates set to
    ``GATES`` (the reference initialises them to zero)."""
    p = np_tree(jp)
    for name, value in GATES.items():
        g = p["cross_layers"][name]
        p["cross_layers"][name] = np.full(g.shape, value, g.dtype)
    return p


def _extra_key(cfg):
    return "image_embeds" if cfg.arch_type == "vlm" else "frames"


def _extra(cfg, B, seed=7):
    """The modality input of ``cfg`` (B, T, d) in float32 numpy."""
    T = cfg.num_image_tokens if cfg.arch_type == "vlm" \
        else cfg.num_audio_frames
    return rand(seed, (B, T, cfg.d_model), 1.0)


def _jkw(cfg, extra):
    return {_extra_key(cfg): jnp.asarray(extra, cfg.jax_dtype)}


def _tkw(cfg, extra):
    return {_extra_key(cfg): tt(extra).to(cfg.torch_dtype)}


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(jcfg, tcfg, the reference's float32 smoke params with gated cross
    blocks, the same params in the port)."""
    jcfg, tcfg = f32_smoke(arch)
    p = _gated(j_init_jit(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, p), port(p)


def _reference_forward(jcfg, jp, tok, extra, last_only=False):
    logits, _ = jlm.forward(jcfg, jp, jnp.asarray(tok), remat=False,
                            last_only=last_only, **_jkw(jcfg, extra))
    return np.asarray(logits, np.float32)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def test_cross_configs_are_the_reference_configs():
    for arch in ARCHS:
        assert_configs_equal(arch)
    v, a = t_config(VLM), t_config(AUDIO)
    assert (v.cross_attn_every, v.num_image_tokens) == (5, 1601)
    assert (a.is_encoder_decoder, a.num_encoder_layers,
            a.num_audio_frames) == (True, 4, 1500)
    assert (t_smoke(VLM).cross_attn_every, t_smoke(AUDIO).num_audio_frames) \
        == (2, 32)


@pytest.mark.parametrize("arch,full,smoke", [
    (VLM, 11_520_053_264, 1_017_476), (AUDIO, 61_178_120, 921_604)])
def test_cross_param_counts_are_the_reference_counts(arch, full, smoke):
    assert assert_param_counts(arch) == full
    assert t_smoke(arch).param_count() == j_smoke(arch).param_count() \
        == smoke


@pytest.mark.parametrize("arch,n_leaves", [(VLM, 23), (AUDIO, 36)])
def test_cross_init_params_have_the_reference_tree(arch, n_leaves):
    got = assert_init_tree_matches(arch, n_leaves)
    cfg = t_smoke(arch)
    n_cross = cfg.num_layers // cfg.cross_attn_every if arch == VLM \
        else cfg.num_layers
    cross = got["cross_layers"]
    assert tuple(cross["attn"]["wk"].shape) == (
        n_cross, cfg.d_model, cfg.num_kv_heads, cfg.head_dim)
    for gate in GATES:
        assert tuple(cross[gate].shape) == (n_cross, 1)
        assert not cross[gate].any()             # a fresh block adds nothing
    if arch == AUDIO:
        assert got["enc_layers"]["attn"]["wq"].shape[0] == \
            cfg.num_encoder_layers
        assert not got["enc_norm"].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_full_init_tree_on_meta_is_the_reference_tree(arch):
    got = t_init(t_config(arch), 0, device="meta")
    want = jax.tree_util.tree_leaves_with_path(jax.eval_shape(
        lambda: j_init(j_config(arch), jax.random.PRNGKey(0))))
    assert [p for p, _ in tree.items(got)] == [
        "/".join(k.key for k in path) for path, _ in want]
    for (path, g), (_, w) in zip(tree.items(got), want):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[1] == str(w.dtype), path


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_ops_match_reference(dtype):
    """``cross_kv``, ``cross_attn`` and ``cross_attn_cached`` on the VLM
    smoke block (hd = 32: the bf16 scale 0.1767578125 differs from the
    unrounded 0.17677669...; a planted fault, the unrounded scale, must
    miss the bf16 bound: it reads ~3e-3 of the largest output)."""
    jcfg = dataclasses.replace(j_smoke(VLM), dtype=dtype)
    tcfg = dataclasses.replace(t_smoke(VLM), dtype=dtype)
    jp = j_init_jit(jcfg, jax.random.PRNGKey(1))
    jblock = jax.tree_util.tree_map(lambda a: a[0], jp["cross_layers"])
    tblock = tree.map_leaves(lambda a: a[0], port(jp)["cross_layers"])
    x, src = rand(1, (2, 12, tcfg.d_model), 1.0), rand(2, (2, 16,
                                                         tcfg.d_model), 1.0)
    jx, jsrc = (jnp.asarray(a, jcfg.jax_dtype) for a in (x, src))
    tx, tsrc = (tt(a).to(tcfg.torch_dtype) for a in (x, src))
    frac = 1e-6 if dtype == "float32" else 1e-4
    jkv = jattn.cross_kv(jblock["attn"], jsrc, jcfg)
    tkv = tattn.cross_kv(tblock["attn"], tsrc, tcfg)
    for k in ("k", "v"):
        close_of_max(tkv[k].float().numpy(), np.asarray(jkv[k], np.float32),
                     frac, k)
    want = np.asarray(jattn.cross_attn(jblock["attn"], jx, jsrc, jcfg),
                      np.float32)
    got = tattn.cross_attn(tblock["attn"], tx, tsrc, tcfg)
    assert got.dtype == tcfg.torch_dtype
    close_of_max(got.float().numpy(), want, frac, "cross_attn")
    cached = tattn.cross_attn_cached(tblock["attn"], tx, tkv, tcfg)
    close_of_max(cached.float().numpy(), np.asarray(jattn.cross_attn_cached(
        jblock["attn"], jx, jkv, jcfg), np.float32), frac, "cached")
    assert torch.equal(cached, got)
    if dtype == "bfloat16":
        with mock.patch.object(tattn, "dtype_scalar",
                               lambda value, dt: value):
            bad = tattn.cross_attn(tblock["attn"], tx, tsrc, tcfg)
        gap = np.abs(bad.float().numpy() - want).max() / np.abs(want).max()
        assert gap > 10 * frac, gap


@pytest.mark.parametrize("arch", ARCHS)
def test_blocked_cross_attention_equals_the_dense_form(arch, monkeypatch):
    """Queries in blocks (of 7 and of 16 over 40) give the dense form's
    output bit for bit: no mask, one softmax per row."""
    _, tcfg, _, tp = _model(arch)
    p = tree.map_leaves(lambda a: a[0], tp["cross_layers"])["attn"]
    x = tt(rand(3, (2, 40, tcfg.d_model), 1.0))
    src = tt(rand(4, (2, 33, tcfg.d_model), 1.0))
    assert tattn.CROSS_QBLOCK < 8192          # the full prefill is blocked
    monkeypatch.setattr(tattn, "CROSS_QBLOCK", 40)
    dense = tattn.cross_attn(p, x, src, tcfg)
    for qb in (7, 16):
        monkeypatch.setattr(tattn, "CROSS_QBLOCK", qb)
        assert torch.equal(tattn.cross_attn(p, x, src, tcfg), dense)
        assert torch.equal(tattn.cross_attn_cached(
            p, x, tattn.cross_kv(p, src, tcfg), tcfg), dense)


# ---------------------------------------------------------------------------
# forward, loss, faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cross_forward_and_loss_match_reference(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    B = 2
    tok, extra = tokens(0, B, SEQ), _extra(tcfg, B)
    got, aux = tlm.forward(tcfg, tp, tt(tok).long(), **_tkw(tcfg, extra))
    want = _reference_forward(jcfg, jp, tok, extra)
    assert got.shape == want.shape == (B, SEQ, tcfg.padded_vocab)
    close_of_max(got.numpy(), want, 1e-5, "logits")
    assert float(aux) == 0.0
    last, _ = tlm.forward(tcfg, tp, tt(tok).long(), last_only=True,
                          **_tkw(tcfg, extra))
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
    labels = tokens(1, B, SEQ)
    labels[0, 1], labels[1, 3] = -1, tcfg.vocab_size + 5
    loss, m = tlm.loss_fn(tcfg, tp, {"tokens": tt(tok).long(),
                                     "labels": tt(labels).long(),
                                     **_tkw(tcfg, extra)})
    jloss, jm = jlm.loss_fn(jcfg, jp, {"tokens": jnp.asarray(tok),
                                       "labels": jnp.asarray(labels),
                                       **_jkw(jcfg, extra)}, remat=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    with pytest.raises(ValueError, match=_extra_key(tcfg)):
        tlm.forward(tcfg, tp, tt(tok).long())


def _fault_gap(arch, fault=None, params=None):
    """The largest gap between the port's logits (with ``fault`` planted:
    a context manager, or other ``params``) and the reference's, over the
    largest reference logit."""
    jcfg, tcfg, jp, tp = _model(arch)
    tok, extra = tokens(2, 2, SEQ), _extra(tcfg, 2, seed=9)
    want = _reference_forward(jcfg, jp, tok, extra)
    with fault or contextlib.nullcontext():
        got, _ = tlm.forward(tcfg, params or tp, tt(tok).long(),
                             **_tkw(tcfg, extra))
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _bidirectional_encoder():
    """The whisper encoder with every frame seeing every frame: the
    attention mask replaced by all-true inside ``_encoder_forward``."""
    real = tlm._encoder_forward

    def encoder(cfg, params, frames):
        with mock.patch.object(tattn, "_causal_window_mask",
                               lambda q, k, w: torch.ones(
                                   (q.shape[0], k.shape[0]),
                                   dtype=torch.bool)):
            return real(cfg, params, frames)
    return mock.patch.object(tlm, "_encoder_forward", encoder)


@pytest.mark.parametrize("arch,fault", [
    (VLM, "zero gates"), (VLM, "cross block after idx % every == 0"),
    (AUDIO, "zero gates"), (AUDIO, "bidirectional encoder")])
def test_planted_cross_faults_fail(arch, fault):
    """Each planted fault moves the logits by more than FAULT of the
    largest off the reference's; the unplanted port stays within 1e-5."""
    assert _fault_gap(arch) <= 1e-5
    _, tcfg, _, tp = _model(arch)
    if fault == "zero gates":
        zeroed = dict(tp, cross_layers=dict(tp["cross_layers"], **{
            g: torch.zeros_like(tp["cross_layers"][g]) for g in GATES}))
        gap = _fault_gap(arch, params=zeroed)
    elif arch == VLM:
        every = tcfg.cross_attn_every
        gap = _fault_gap(arch, mock.patch.object(
            tlm, "_cross_slot", lambda cfg, idx: idx // every
            if idx % every == 0 else None))
    else:
        gap = _fault_gap(arch, _bidirectional_encoder())
    assert gap > FAULT, (fault, gap)


def _reference_layer_by_layer(cfg, params, tok, extra):
    """The reference's forward with its blocks applied one by one, outside
    its layer scans (each jnp op rounded as it runs)."""
    B, S = tok.shape
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    x = jlm._embed(cfg, params, jnp.asarray(tok))
    src = jnp.asarray(extra, cfg.jax_dtype)

    def layer(stack, i):
        return jax.tree_util.tree_map(lambda a: a[i], stack)
    if cfg.arch_type == "audio":
        F = src.shape[1]
        fpos = jnp.broadcast_to(jnp.arange(F, dtype=jnp.int32)[None], (B, F))
        for i in range(cfg.num_encoder_layers):
            src, _ = jblocks.block_prefill(layer(params["enc_layers"], i),
                                           src, fpos, cfg)
        src = jlm.rms_norm(src, params["enc_norm"], cfg.norm_eps)
    every = cfg.cross_attn_every
    for idx in range(cfg.num_layers):
        x, _ = jblocks.block_prefill(layer(params["layers"], idx), x, pos,
                                     cfg)
        if cfg.arch_type == "audio":
            x = jblocks.cross_block(layer(params["cross_layers"], idx), x,
                                    src, cfg)
        elif idx % every == every - 1:
            x = jblocks.cross_block(layer(params["cross_layers"],
                                          idx // every), x, src, cfg)
    return jlm._logits(cfg, params, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_bf16_forward_matches_reference(arch):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    assert tcfg.dtype == "bfloat16"
    p = _gated(j_init_jit(jcfg, jax.random.PRNGKey(0)))
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), port(p)
    tok, extra = tokens(0, 2, SEQ), _extra(tcfg, 2)
    got, _ = tlm.forward(tcfg, tp, tt(tok).long(), **_tkw(tcfg, extra))
    assert got.dtype == torch.bfloat16
    want = np.asarray(_reference_layer_by_layer(jcfg, jp, tok, extra),
                      np.float32)
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 0.05 * np.abs(want).max(), err.max()
    assert err.mean() <= 0.015 * np.abs(want).mean(), err.mean()


def test_lm_batch_modality_stubs():
    """``with_images`` / ``with_frames``: standard normal (batch, n,
    d_model) in the model dtype from their own generators (the tokens are
    those of a batch without them); node batches keep the node axis."""
    text = SyntheticTextConfig(vocab_size=512, seq_len=20)
    plain = make_lm_batch(3, text, 4, device="cpu")
    for arch in ARCHS:
        cfg = t_smoke(arch)
        kw = modality_kw(cfg)
        b = make_lm_batch(3, text, 4, device="cpu", **kw)
        assert torch.equal(b["tokens"], plain["tokens"])
        e = b[_extra_key(cfg)]
        assert e.dtype == torch.bfloat16
        assert tuple(e.shape) == (4, kw.get("with_images",
                                            kw.get("with_frames")), 128)
        assert abs(float(e.float().std()) - 1.0) < 0.05
        nb = make_node_batches(3, text, 2, 2, device="cpu", **kw)
        assert tuple(nb[_extra_key(cfg)].shape) == (2, 2) + tuple(e.shape[1:])
    assert modality_kw(t_smoke("starcoder2-3b")) == {}


# ---------------------------------------------------------------------------
# decode and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cross_decode_steps_match_reference_and_forward(arch):
    """``make_image_kv`` / ``make_enc_kv`` and ``init_cache`` (the self
    K/V under ``kv``, the cross K/V under ``cross``) against the
    reference's, then teacher-forced decode steps against the reference's
    decode (logits and every cache leaf) and the last against the
    forward."""
    jcfg, tcfg, jp, tp = _model(arch)
    B, S = 2, 10
    tok, extra = tokens(4, B, S), _extra(tcfg, B, seed=5)
    if arch == VLM:
        jcross = jlm.make_image_kv(jcfg, jp, jnp.asarray(extra))
        cross = tlm.make_image_kv(tcfg, tp, tt(extra), device="cpu")
        jcache = jlm.init_cache(jcfg, B, S, image_kv=jcross)
        cache = tlm.init_cache(tcfg, B, S, image_kv=cross, device="cpu")
        n = tcfg.num_layers // tcfg.cross_attn_every
    else:
        jcross = jlm.make_enc_kv(jcfg, jp, jnp.asarray(extra))
        cross = tlm.make_enc_kv(tcfg, tp, tt(extra), device="cpu")
        jcache = jlm.init_cache(jcfg, B, S, enc_kv=jcross)
        cache = tlm.init_cache(tcfg, B, S, enc_kv=cross, device="cpu")
        n = tcfg.num_layers
    assert tuple(cross["k"].shape) == (n, B, extra.shape[1],
                                       tcfg.num_kv_heads, tcfg.head_dim)
    assert cache["cross"] is cross
    want_paths = ["/".join(k.key for k in path) for path, _ in
                  jax.tree_util.tree_leaves_with_path(jcache)]
    assert [p for p, _ in tree.items(cache)] == want_paths == [
        "cross/k", "cross/v", "kv/k", "kv/v"]
    for (path, g), (_, w) in zip(tree.items(cache),
                                 jax.tree_util.tree_leaves_with_path(jcache)):
        assert tuple(g.shape) == w.shape, path
        close_of_max(g.numpy(), np.asarray(w), 1e-5, path)
    with pytest.raises(ValueError, match="image_kv|enc_kv"):
        tlm.init_cache(tcfg, B, S, device="cpu")
    jstep = jax.jit(functools.partial(jlm.decode_step, jcfg))
    for t in range(S):
        logits, cache = tlm.decode_step(tcfg, tp, cache,
                                        tt(tok[:, t]).long(), t)
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(tok[:, t]),
                                jnp.int32(t))
        close_of_max(logits.numpy(), jlogits, 1e-5, f"step {t}")
    for (path, g), (_, w) in zip(tree.items(cache),
                                 jax.tree_util.tree_leaves_with_path(jcache)):
        close_of_max(g.numpy(), np.asarray(w), 1e-5, path)
    full, _ = tlm.forward(tcfg, tp, tt(tok).long(), last_only=True,
                          **_tkw(tcfg, extra))
    close_of_max(logits.numpy(), full[:, 0].numpy(), 1e-5, "vs forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_serve_matches_prefill(arch):
    """``serve`` on given params, prompt and modality input: its last
    prompt step's logits equal ``prefill_logits``'s within 1e-5 of the
    largest, its first token is their greedy token; drawn from the seed,
    the modality input comes with the prompt."""
    _, tcfg, _, tp = _model(arch)
    B, S = 2, 12
    prompt, extra = tokens(6, B, S), _extra(tcfg, B, seed=8)
    args = tserve.build_parser().parse_args(
        ["--arch", arch, "--batch", str(B), "--prompt-len", str(S),
         "--new-tokens", "4"])
    inputs = _tkw(tcfg, extra)
    res = tserve.serve(tcfg, args, device="cpu", params=tp,
                       prompt=tt(prompt).long(), inputs=inputs,
                       log=lambda _: None)
    first = tserve.prefill_logits(tcfg, tp, tt(prompt).long(), **inputs)
    close_of_max(res.last_logits.numpy(), first[:, 0].numpy(), 1e-5,
                 "serve vs prefill")
    np.testing.assert_array_equal(res.tokens[:, 0], tserve.greedy(
        tcfg, first[:, 0]).numpy())
    assert res.tokens.shape == (B, 4) and res.state.t == S + 4
    seeded = tserve.serve(t_smoke(arch), args, device="cpu",
                          log=lambda _: None)
    assert seeded.tokens.shape == (B, 4)


# ---------------------------------------------------------------------------
# gradients and trainer rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cross_gradients_match_jax_grad(arch):
    """The float32 loss gradient of every leaf against ``jax.grad``, the
    gates' and the cross weights' included (non-zero)."""
    jcfg, tcfg, jp, tp = _model(arch)
    tok, extra = tokens(5, 2, SEQ), _extra(tcfg, 2, seed=6)
    labels = tokens(6, 2, SEQ)
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels),
              **_jkw(jcfg, extra)}
    jg = jax.jit(jax.grad(lambda p: jlm.loss_fn(jcfg, p, jbatch,
                                                remat=False)[0]))(jp)
    params = tree.map_leaves(lambda w: w.clone().requires_grad_(True), tp)
    leaves = dict(tree.items(params))
    loss, _ = tlm.loss_fn(tcfg, params, {"tokens": tt(tok).long(),
                                         "labels": tt(labels).long(),
                                         **_tkw(tcfg, extra)})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    want = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jg)}
    assert sorted(grads) == sorted(want)
    for p, g in grads.items():
        close_of_max(g.numpy(), want[p], 1e-4, p)
    for p in ("cross_layers/attn_gate", "cross_layers/mlp_gate",
              "cross_layers/attn/wk", "cross_layers/attn/wq",
              "cross_layers/ffn/w_out"):
        assert float(grads[p].abs().max()) > 0, p
    if arch == AUDIO:
        assert float(grads["enc_layers/attn/wv"].abs().max()) > 0


@functools.lru_cache(maxsize=None)
def _reference_rounds(arch, rounds=2, seq=16):
    """Two rounds of the reference's DASHA-MVR trainer (plain route, SGD
    server, n = 4) on its node batches with the modality stubs, from the
    gated smoke params: what the port replays (initial state, batches,
    masks) and the reference's final state."""
    jcfg, tcfg, jp, _ = _model(arch)
    kw = dict(gamma=0.05, compression=0.25, mode="independent",
              variant="mvr", b=0.1, n_nodes=N_NODES, server_opt="sgd")
    jtc = jdist.DashaTrainConfig(use_kernel=False, **kw)
    jmethod = jdist.make_method(jtc, lambda p, b: jlm.loss_fn(
        jcfg, p, b, remat=False)[0])
    jstate = jmethod.init(jp, jax.random.PRNGKey(1), init_mode="zeros")
    text = JText(vocab_size=jcfg.vocab_size, seq_len=seq)
    n_extra = jcfg.num_image_tokens if arch == VLM else jcfg.num_audio_frames
    data_kw = {"with_images" if arch == VLM else "with_frames": n_extra,
               "d_model": jcfg.d_model, "dtype": jcfg.jax_dtype}

    def data_fn(k, t):
        return j_node_batches(k, text, N_NODES, 2, **data_kw)
    data_key = jax.random.PRNGKey(2)
    batches, draws, key = [], [], jstate.key
    for t in range(rounds):
        b = data_fn(jax.random.fold_in(data_key, t), t)
        batches.append({k: torch.as_tensor(np.array(v)).to(
            torch.int64 if k in ("tokens", "labels") else torch.float32)
            for k, v in b.items()})
        draws.append(_reference_masks(key, jstate.h_local, jtc))
        key = jax.random.split(key, 4)[0]
    jfinal, _ = JDriver(jmethod, data_fn=data_fn, chunk=rounds).run(
        jstate, rounds, data_key=data_key)
    return dict(tcfg=tcfg, kw=kw, rounds=rounds, jfinal=jfinal,
                init=_state_arrays(jstate), batches=batches, draws=draws)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_cross_trainer_rounds_match_reference(arch, use_kernel):
    """Two DASHA-MVR rounds on the reference's batches (image embeddings
    or frames included) and masks, the port's plain and kernel routes
    (kernel 3 once per parameter leaf a round) against the reference's
    plain route: every state leaf, the gates' included."""
    final = assert_port_trainer_rounds(_reference_rounds(arch), use_kernel)
    for gate in GATES:
        assert float(final.g["cross_layers"][gate].abs().max()) > 0


def test_cross_params_from_numpy_carry_every_tree_bit_for_bit():
    """``params_from_numpy`` and ``cache_from_numpy`` carry ``cross_layers``,
    ``enc_layers``, ``enc_norm`` and the cross caches bit for bit, in bf16
    and float32."""
    for arch in ARCHS:
        jcfg = j_smoke(arch)
        p = _gated(j_init_jit(jcfg, jax.random.PRNGKey(3)))
        got = convert.params_from_numpy(p, device="cpu")
        for (path, g), (_, w) in zip(
                tree.items(got), jax.tree_util.tree_leaves_with_path(p)):
            assert g.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32), path)
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        extra = jnp.asarray(_extra(jcfg, 1), jcfg.jax_dtype)
        cross = jlm.make_image_kv(jcfg, jp, extra) if arch == VLM \
            else jlm.make_enc_kv(jcfg, jp, extra)
        jcache = jlm.init_cache(jcfg, 1, 4, image_kv=cross, enc_kv=cross)
        cache = convert.cache_from_numpy(np_tree(jcache), device="cpu")
        for (path, g), (_, w) in zip(
                tree.items(cache),
                jax.tree_util.tree_leaves_with_path(jcache)):
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32), path)
