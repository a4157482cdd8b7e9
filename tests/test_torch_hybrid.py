"""The port's hybrid family (zamba2-1.2b: Mamba2 layers and one shared
transformer block run before every ``hybrid_attn_every``-th of them)
against the reference (CPU).

* config, ``init_params`` (stacked Mamba2 ``layers`` and one unstacked
  ``shared_attn`` block: names, shapes, dtypes at the smoke size and, on
  the ``meta`` device, at the full size; ``params_from_numpy`` of the
  reference's tree bit for bit), ``param_count`` of both configs;
* ``forward`` and ``loss_fn`` in float32 (aux zero), with the plain SSD
  and with ``use_ssd_kernel`` (the plain version of the port's kernel on
  the CPU against the reference's Pallas kernel in interpret mode); in
  bf16 against the reference's layers run one by one;
* ``init_cache`` (``mamba`` conv and state, ``attn`` K/V of one cache per
  use of the shared block) and ``decode_step`` against the reference's
  decode, cache leaf for cache leaf, and against the forward's logits;
* the loss gradient of the shared block, summed over its uses, against
  ``jax.grad``; DASHA-MVR trainer rounds on replayed masks, plain and
  kernel routes.

Tolerances: float32 logits at the last position and through the decode
within 1e-5 of the largest magnitude (``tests/test_torch_dense.py``'s);
at every position of the 64-token forward, and on the kernel path (as
``tests/test_torch_serve.py``'s kernel SSD forward), within 1e-4.  Each
block alone agrees to 8e-7 of its largest output, but the smoke model
amplifies float32 rounding: the port's own logits move by 1e-5 of the
largest when its embedding is perturbed by half a float32 ulp, and the
two packages' logits differ by 2.1e-5 at one position.  Gradients
within 1e-4 of each leaf's largest magnitude (measured at most 1.9e-5);
trainer states within 2e-4 of each leaf's largest magnitude.  bf16: the reference's compiled layer scan rounds some
fused ops otherwise than its own eager code (over the smoke model's
layers its scan and its eager layer chain drift apart by about as much
as bf16 differs from float32), so the port's bf16 forward is held
against the reference's blocks applied one by one, whose ops round as
the port's do: within 0.05 of the largest logit and a mean error of
0.015 of the mean magnitude (measured 0.035 and 0.0085).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import blocks as jblocks
from repro.models import init_params as j_init
from repro.models import lm as jlm
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import tree
from repro_torch.models import init_params as t_init
from repro_torch.models import lm as tlm
from torch_models_common import (assert_configs_equal, assert_decode_steps,
                                 assert_forward_and_loss, assert_init_cache,
                                 assert_init_tree_matches,
                                 assert_param_counts,
                                 assert_port_trainer_rounds, close_of_max,
                                 j_init_jit, port, reference_trainer_rounds,
                                 smoke_model, tokens, tt)

torch.set_num_threads(1)

ARCH = "zamba2-1.2b"
SEQ = 64          # two 32-token SSD chunks of the smoke config


@pytest.fixture(scope="module")
def model():
    """(jcfg, tcfg, reference params, the same params in the port), the
    float32 smoke config."""
    return smoke_model(ARCH)


def test_hybrid_configs_are_the_reference_configs():
    assert_configs_equal(ARCH)
    assert t_config(ARCH).hybrid_attn_every == 6
    assert t_smoke(ARCH).hybrid_attn_every == 2


def test_hybrid_init_params_have_the_reference_tree():
    got = assert_init_tree_matches(ARCH, 22)
    cfg = t_smoke(ARCH)
    assert "lm_head" not in got                      # tied head
    assert tuple(got["layers"]["w_xbc"].shape)[0] == cfg.num_layers
    # one block, not stacked: its use count is in the forward, not here
    assert tuple(got["shared_attn"]["attn"]["wq"].shape) == (
        cfg.d_model, cfg.num_heads, cfg.head_dim)
    assert tuple(got["shared_attn"]["ffn"]["w_gate"].shape) == (
        cfg.d_model, cfg.d_ff)


def test_hybrid_full_init_tree_on_meta_is_the_reference_tree():
    got = t_init(t_config(ARCH), 0, device="meta")
    want = jax.tree_util.tree_leaves_with_path(jax.eval_shape(
        lambda: j_init(j_config(ARCH), jax.random.PRNGKey(0))))
    assert [p for p, _ in tree.items(got)] == [
        "/".join(k.key for k in path) for path, _ in want]
    for (path, g), (_, w) in zip(tree.items(got), want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[1] == str(w.dtype), path


def test_hybrid_param_counts_are_the_reference_counts():
    assert assert_param_counts(ARCH) == 1_104_937_856
    assert t_smoke(ARCH).param_count() == j_smoke(ARCH).param_count() \
        == 650_848


def test_hybrid_forward_and_loss_match_reference(model):
    jcfg, tcfg, jp, tp = model
    assert_forward_and_loss(jcfg, tcfg, jp, tp, S=SEQ, frac=1e-4)


def test_hybrid_shared_block_runs_where_the_reference_runs_it(model,
                                                             monkeypatch):
    """A planted fault, the shared block before layers 1 and 3
    (``idx % every == every - 1``), moves the logits far off the
    reference's."""
    jcfg, tcfg, jp, tp = model
    tok = tokens(2, 2, SEQ)
    want, _ = jlm.forward(jcfg, jp, jnp.asarray(tok), remat=False,
                          last_only=True)
    got, _ = tlm.forward(tcfg, tp, tt(tok).long(), last_only=True)
    close_of_max(got.numpy(), want, 1e-5, "logits")
    every = tcfg.hybrid_attn_every
    monkeypatch.setattr(tlm, "_hybrid_slot", lambda cfg, idx: idx // every
                        if idx % every == every - 1 else None)
    bad, _ = tlm.forward(tcfg, tp, tt(tok).long(), last_only=True)
    w = np.asarray(want)
    assert np.abs(bad.numpy() - w).max() > 1e-2 * np.abs(w).max()


def test_hybrid_kernel_forward_matches_reference_kernel_path(model):
    """``use_ssd_kernel`` on both sides: the port's kernel dispatch takes
    the plain version on the CPU, the reference runs its Pallas kernel in
    interpret mode, as its own tests run it."""
    jcfg, tcfg, jp, tp = model
    jk = dataclasses.replace(jcfg, use_ssd_kernel=True)
    tk = dataclasses.replace(tcfg, use_ssd_kernel=True)
    tok = tokens(3, 2, SEQ)
    want, _ = jlm.forward(jk, jp, jnp.asarray(tok), remat=False)
    got, _ = tlm.forward(tk, tp, tt(tok).long())
    close_of_max(got.numpy(), want, 1e-4, "kernel-path logits")


def _reference_layer_by_layer(cfg, params, tok):
    """The reference's forward with its blocks applied one by one, outside
    its layer scan (each jnp op rounded as it runs)."""
    B, S = tok.shape
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    x = jlm._embed(cfg, params, jnp.asarray(tok))
    for idx in range(cfg.num_layers):
        lp = jax.tree_util.tree_map(lambda a: a[idx], params["layers"])
        if idx % cfg.hybrid_attn_every == 0:
            x, _ = jblocks.block_prefill(params["shared_attn"], x, pos, cfg)
        x = jblocks.mamba_block_prefill(lp, x, cfg)
    return jlm._logits(cfg, params, x)


def test_hybrid_bf16_forward_matches_reference():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    assert tcfg.dtype == "bfloat16"
    jp = j_init_jit(jcfg, jax.random.PRNGKey(0))
    tp = port(jp)
    tok = tokens(0, 2, SEQ)
    got, aux = tlm.forward(tcfg, tp, tt(tok).long())
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    want = np.asarray(_reference_layer_by_layer(jcfg, jp, tok), np.float32)
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 0.05 * np.abs(want).max(), err.max()
    assert err.mean() <= 0.015 * np.abs(want).mean(), err.mean()


def test_hybrid_init_cache_matches_reference():
    assert_init_cache(ARCH, 12, ["attn/k", "attn/v", "mamba/conv",
                                 "mamba/ssm"])
    cache = tlm.init_cache(t_smoke(ARCH), 1, 12, device="cpu")
    # ceil(4 layers / every 2) uses of the shared block, each its own K/V
    assert tuple(cache["attn"]["k"].shape[:3]) == (2, 1, 12)
    assert cache["mamba"]["ssm"].shape[0] == 4


def test_hybrid_decode_steps_match_reference_and_forward(model):
    """12 teacher-forced steps against the reference's decode (logits and
    every cache leaf, the shared block's use ``idx // every`` writing its
    own K/V), the last against the forward's last position."""
    jcfg, tcfg, jp, tp = model
    logits, cache, tok = assert_decode_steps(jcfg, tcfg, jp, tp, 12)
    full, _ = tlm.forward(tcfg, tp, tt(tok).long(), last_only=True)
    close_of_max(logits.numpy(), full[:, 0].numpy(), 1e-5, "vs forward")
    # both uses wrote their caches, with different K
    k = cache["attn"]["k"]
    assert bool(k[0].any()) and bool(k[1].any())
    assert not torch.equal(k[0], k[1])


def test_hybrid_shared_block_gradient_sums_over_its_uses(model):
    """The float32 loss gradient against ``jax.grad``: the shared block's
    leaves get the sum over both uses (one tensor tree, never copied)."""
    jcfg, tcfg, jp, tp = model
    tok = tokens(5, 2, SEQ)
    batch = {"tokens": tok, "labels": tokens(6, 2, SEQ)}
    jg = jax.jit(jax.grad(lambda p: jlm.loss_fn(jcfg, p, {
        k: jnp.asarray(v) for k, v in batch.items()})[0]))(jp)
    params = tree.map_leaves(lambda w: w.clone().requires_grad_(True), tp)
    leaves = dict(tree.items(params))
    loss, _ = tlm.loss_fn(tcfg, params, {k: tt(v).long()
                                         for k, v in batch.items()})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    want = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jg)}
    assert sorted(grads) == sorted(want)
    for p, g in grads.items():
        close_of_max(g.numpy(), want[p], 1e-4, p)
    assert float(grads["shared_attn/attn/wq"].abs().max()) > 0


@pytest.fixture(scope="module")
def reference_rounds():
    """Two rounds of the reference's trainer (its plain route), once."""
    return reference_trainer_rounds(ARCH)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_hybrid_trainer_rounds_match_reference(reference_rounds,
                                               use_kernel):
    """Two DASHA-MVR rounds on the reference's batches and masks, the
    port's plain and kernel routes against the reference's plain route:
    every state leaf, the shared block's included."""
    final = assert_port_trainer_rounds(reference_rounds, use_kernel)
    assert float(final.g["shared_attn"]["attn"]["wq"].abs().max()) > 0
