"""The port's Mamba2 model modules against the reference (CPU).

The reference's parameters (``repro.models.init_params`` on the
``mamba2-smoke`` config) are carried into the port by
``convert.params_from_numpy``, and the same numpy inputs go through both.

Tolerances: float32 runs agree to rtol 1e-5 with atol 1e-5 of the
output's largest magnitude (the two sum matmuls and einsums in different
orders; measured: logits max err 1.8e-5 at max |logit| 4.5, loss equal).
bfloat16 runs round each op of softplus and silu in bf16 in the
reference's order (``models.common``), so the mixer agrees to 1.1e-7 of
its largest magnitude and the block to 1.3e-3 (a few elements one bf16
ulp apart: the matmuls sum in other orders); the reference's compiled
layer scan rounds some fused ops otherwise than its eager code, and over
the two layers the logits agree to a max abs err of 0.03 of their largest
magnitude and a mean abs err of 0.015 of their mean magnitude (measured:
0.0155 and 0.0091; before the activations were rounded op by op 0.042 and
0.015), and the loss to rtol 1e-3 (measured 1.2e-4).
Gradients of the float32 loss agree with ``jax.grad`` to rtol 1e-4 and
atol 1e-6 of each leaf's largest magnitude (backward sums accumulate more
rounding than the forward).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import init_params as j_init
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.data.pipeline import (SyntheticTextConfig,
                                       make_node_batches)
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import init_params as t_init
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

SEQ, BATCH = 64, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(dtype):
    return (dataclasses.replace(j_smoke("mamba2-780m"), dtype=dtype),
            dataclasses.replace(t_smoke("mamba2-780m"), dtype=dtype))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    """Both configs, the reference's params in both packages, a batch."""
    jcfg, tcfg = _cfgs(request.param)
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np(jparams), device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, jcfg.vocab_size, (BATCH, SEQ + 1))
    batch = {"tokens": tokens[:, :-1].astype(np.int32),
             "labels": tokens[:, 1:].astype(np.int32)}
    return jcfg, tcfg, jparams, tparams, batch


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    D = np.linspace(0.5, 1.5, H).astype(np.float32)
    return x, dt, A, b, c, D


# the shapes of tests/test_ssd_kernel.py
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 16, 1, 2, 3, 4),
    (2, 32, 3, 4, 5, 8),
    (1, 64, 2, 8, 16, 16),
    (2, 24, 2, 4, 4, 24),      # single chunk
    (1, 128, 4, 16, 8, 32),
])
def test_ssd_chunked_matches_reference(B, S, H, P, N, chunk):
    arrs = _ssd_inputs(B * S + H, B, S, H, P, N)
    y_ref, s_ref = jssm.ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk)
    y, s = tssm.ssd_chunked(*(torch.as_tensor(a) for a in arrs), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-5)


def test_ssd_chunked_initial_state_matches_reference():
    arrs = _ssd_inputs(3, 2, 32, 3, 4, 5)
    s0 = np.random.default_rng(1).standard_normal((2, 3, 5, 4)) \
        .astype(np.float32)
    y_ref, s_ref = jssm.ssd_chunked(*(jnp.asarray(a) for a in arrs), 8,
                                    jnp.asarray(s0))
    y, s = tssm.ssd_chunked(*(torch.as_tensor(a) for a in arrs), 8,
                            torch.as_tensor(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-5)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tcommon.rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _check(cfg, got, want):
    got, want = _as_f32(got), _as_f32(want)
    scale = np.abs(want).max()
    if cfg.dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
        return
    err = np.abs(got - want)
    assert err.max() <= 0.03 * scale, (err.max(), scale)
    assert err.mean() <= 0.015 * np.abs(want).mean(), err.mean()


def _loss_rtol(cfg):
    return 1e-5 if cfg.dtype == "float32" else 1e-3


def _as_f32(t):
    return np.asarray(t, dtype=np.float32) if not isinstance(
        t, torch.Tensor) else t.to(torch.float32).numpy()


def _hidden(jcfg, jparams, batch, seed=3):
    """A (B, S, d) input in the model dtype, as both packages' arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, SEQ, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.jax_dtype)
    return jx, convert.params_from_numpy({"x": np.asarray(jx)},
                                         device="cpu")["x"]


def test_mixer_and_block_match_reference(model):
    jcfg, tcfg, jparams, tparams, batch = model
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    tlayer = {k: v[0] for k, v in tparams["layers"].items()}
    jx, tx = _hidden(jcfg, jparams, batch)
    want = jssm.mamba_mixer_prefill(jlayer, jx, jcfg)
    got = tssm.mamba_mixer_prefill(tlayer, tx, tcfg)
    assert got.dtype == tcfg.torch_dtype
    _check(tcfg, got, want)
    want = jblocks.mamba_block_prefill(jlayer, jx, jcfg)
    got = tblocks.mamba_block_prefill(tlayer, tx, tcfg)
    _check(tcfg, got, want)


def test_forward_and_loss_match_reference(model):
    jcfg, tcfg, jparams, tparams, batch = model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    jlogits, _ = jlm.forward(jcfg, jparams, jb["tokens"], remat=False)
    tlogits, aux = tlm.forward(tcfg, tparams, tb["tokens"])
    assert tlogits.shape == (BATCH, SEQ, tcfg.padded_vocab)
    assert float(aux) == 0.0
    _check(tcfg, tlogits, jlogits)
    jloss, jm = jlm.loss_fn(jcfg, jparams, jb)
    tloss, tm = tlm.loss_fn(tcfg, tparams, tb)
    rtol = _loss_rtol(tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=rtol)


def test_loss_masks_out_of_range_labels(model):
    jcfg, tcfg, jparams, tparams, batch = model
    labels = batch["labels"].copy()
    labels[0, :5] = -1
    labels[1, :3] = jcfg.vocab_size + 2     # a padded-vocab id
    jb = {"tokens": jnp.asarray(batch["tokens"]), "labels": jnp.asarray(
        labels)}
    tb = {"tokens": torch.as_tensor(batch["tokens"]),
          "labels": torch.as_tensor(labels)}
    np.testing.assert_allclose(float(tlm.loss_fn(tcfg, tparams, tb)[0]),
                               float(jlm.loss_fn(jcfg, jparams, jb)[0]),
                               rtol=_loss_rtol(tcfg))


def test_loss_gradients_match_jax_grad():
    jcfg, tcfg = _cfgs("float32")
    jparams = j_init(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_numpy(_np(jparams), device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, jcfg.vocab_size, (BATCH, SEQ + 1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    want = jax.grad(lambda p: jlm.loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jparams)
    leaves = {k: v for k, v in tparams.items() if k != "layers"}
    leaves.update({f"layers/{k}": v for k, v in tparams["layers"].items()})
    ps = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    tree = {k: v for k, v in ps.items() if "/" not in k}
    tree["layers"] = {k.split("/")[1]: v for k, v in ps.items() if "/" in k}
    loss = tlm.loss_fn(tcfg, tree, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})[0]
    grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    flat_want = {k: v for k, v in want.items() if k != "layers"}
    flat_want.update({f"layers/{k}": v for k, v in want["layers"].items()})
    assert sorted(grads) == sorted(flat_want)
    for name, g in grads.items():
        w = np.asarray(flat_want[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def test_ssd_kernel_forward_matches_reference_kernel_path():
    """The ``use_ssd_kernel`` forward (the kernel's plain version on the
    CPU) against the reference's kernel-path forward (Pallas in interpret
    mode), float32 smoke model with an 8-token chunk: rtol and atol 1e-4,
    as the reference's test_full_mixer_kernel_parity."""
    jcfg, tcfg = (dataclasses.replace(c, ssd_chunk=8, use_ssd_kernel=True)
                  for c in _cfgs("float32"))
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np(jparams), device="cpu")
    tokens = np.random.default_rng(6).integers(1, jcfg.vocab_size, (2, 32))
    want, _ = jlm.forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32),
                          remat=False)
    got, _ = tlm.forward(tcfg, tparams, torch.as_tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_init_params_match_reference_layout():
    """The port draws its own parameters: same tree, shapes and dtypes as
    the reference, with its init scales (mean ~0, std 1/sqrt(fan_in))."""
    for jcfg, tcfg in (_cfgs("bfloat16"), _cfgs("float32")):
        want = j_init(jcfg, jax.random.PRNGKey(0))
        got = t_init(tcfg, 7, device="cpu")
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        from repro_torch.core import tree
        flat_g = list(tree.items(got))
        assert len(flat_w) == len(flat_g)
        for (path, w), (gpath, g) in zip(flat_w, flat_g):
            assert gpath == "/".join(p.key for p in path)
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[1] == str(w.dtype)
    p = t_init(tcfg, 7, device="cpu")
    w = p["layers"]["w_xbc"].to(torch.float32)
    assert abs(float(w.std()) * np.sqrt(tcfg.d_model) - 1.0) < 0.05
    assert torch.equal(p["layers"]["D"], torch.ones_like(p["layers"]["D"]))


def test_full_config_is_the_reference_config():
    from repro.configs import get_config as j_config
    j, t = j_config("mamba2-780m"), t_config("mamba2-780m")
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.padded_vocab, t.d_inner, t.ssm_nheads) == \
        (j.padded_vocab, j.d_inner, j.ssm_nheads) == (50432, 3072, 48)
    j, t = j_config("whisper-tiny"), t_config("whisper-tiny")
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    with pytest.raises(ValueError, match="not ported"):
        t_config("whisper-large")


def test_node_batches_have_the_reference_structure():
    tc = SyntheticTextConfig(vocab_size=512, seq_len=40)
    b = make_node_batches(3, tc, 4, 2, device="cpu")
    assert b["tokens"].shape == b["labels"].shape == (4, 2, 40)
    assert torch.equal(b["tokens"][..., 1:], b["labels"][..., :-1])
    assert int(b["tokens"].min()) >= 1 and int(b["tokens"].max()) < 512
    # the copy structure: ~90% of tokens repeat with period 16
    t = b["tokens"].reshape(8, 40)
    same = (t[:, 16:] == t[:, :-16]).float().mean()
    assert 0.7 < float(same) < 0.95
    again = make_node_batches(3, tc, 4, 2, device="cpu")
    assert torch.equal(again["tokens"], b["tokens"])
