"""The port's multi-head latent attention (MLA) and the deepseek-v2-lite
family against the reference (CPU).

* ``mla_prefill`` by the dense path (S < 2,048) and the streaming path
  (S = 2,048: 512-query blocks over 512-key blocks), each against the
  reference's on its parameters and against each other; the streaming
  path's skipped blocks bit for bit against the every-block loop; the
  bf16 cast order of both paths; the gradient through the streaming path;
* ``mla_decode`` (the absorbed matrices on the latent ``(ckv, krope)``
  cache) step by step against the reference's and the prefill, and its
  write at t >= T clamped to slot T - 1 as ``lax.dynamic_update_slice``
  clamps;
* deepseek-v2-lite smoke: config, parameter tree, ``param_count`` /
  ``active_param_count`` of the full config, ``forward`` / ``loss_fn``
  (MLA + routed and shared experts, with the aux loss) by both dispatch
  modes and on the streaming path, ``init_cache``, ``decode_step`` past
  the cache's end, and DASHA-MVR trainer rounds on replayed masks, plain
  and kernel routes.

Tolerances as ``tests/test_torch_dense.py``'s: float32 outputs within
1e-5 of their largest magnitude; streaming against dense to rtol 2e-4 /
atol 2e-5; gradients within 1e-4 of their largest magnitude; bf16 against
the reference's bf16 within 5e-3 of the largest output and 1e-4 of the
mean magnitude on average (measured: 2e-3 and 3e-6 on both paths; one
bf16 ulp is 8e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models.common import ArchConfig as JArchConfig
from repro.models.init import _mla_params as j_mla_params
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.common import ArchConfig
from torch_models_common import (assert_configs_equal,
                                 assert_decode_steps,
                                 assert_forward_and_loss,
                                 assert_init_cache,
                                 assert_init_tree_matches,
                                 assert_param_counts,
                                 assert_streaming_forward,
                                 assert_trainer_rounds, close_of_max, port,
                                 rand, smoke_model, tt)

torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"


def _cfgs(**kw):
    base = dict(name="t", arch_type="moe", num_layers=1, d_model=32,
                num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                use_mla=True, kv_lora_rank=16, qk_nope_head_dim=8,
                qk_rope_head_dim=4, v_head_dim=8, dtype="float32")
    base.update(kw)
    return JArchConfig(**base), ArchConfig(**base)


def _params(jcfg, seed):
    p = j_mla_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return p, port(p)


def _pos(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))


def _empty(B, T, cfg):
    shapes = {"ckv": (B, T, cfg.kv_lora_rank),
              "krope": (B, T, cfg.qk_rope_head_dim)}
    return ({k: jnp.zeros(s) for k, s in shapes.items()},
            {k: torch.zeros(s) for k, s in shapes.items()})


def test_mla_prefill_dense_path_matches_reference_and_decode():
    """S = 8: the dense path against the reference's; decoding token by
    token reproduces it, in both packages and between them."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 0)
    B, S = 2, 8
    x = rand(1, (B, S, tcfg.d_model), 0.5)
    pos = _pos(B, S)
    full = tattn.mla_prefill(tp, tt(x), tt(pos), tcfg)
    want = jattn.mla_prefill(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    close_of_max(full.numpy(), want, 1e-5, "prefill")
    jcache, cache = _empty(B, S, tcfg)
    for t in range(S):
        out, cache = tattn.mla_decode(tp, tt(x[:, t:t + 1]), t, cache, tcfg)
        jout, jcache = jattn.mla_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                        jnp.int32(t), jcache, jcfg)
        close_of_max(out.numpy(), jout, 1e-5, f"decode {t}")
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-5)
    for k in ("ckv", "krope"):
        close_of_max(cache[k].numpy(), jcache[k], 1e-6, k)


def test_mla_prefill_streaming_path_matches_reference_and_dense():
    """S = 2,048: the streaming path against the reference's streaming
    prefill, and against the port's dense path on the first 2,047
    tokens."""
    jcfg, tcfg = _cfgs(d_model=16, num_heads=2)
    jp, tp = _params(jcfg, 2)
    S = tattn.QBLOCK_THRESHOLD
    x = rand(3, (1, S, tcfg.d_model), 0.5)
    pos = _pos(1, S)
    got = tattn.mla_prefill(tp, tt(x), tt(pos), tcfg)
    want = jattn.mla_prefill(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    close_of_max(got.numpy(), want, 1e-5, "streaming prefill")
    dense = tattn.mla_prefill(tp, tt(x[:, :-1]), tt(pos[:, :-1]), tcfg)
    np.testing.assert_allclose(got[:, :-1].numpy(), dense.numpy(),
                               rtol=2e-4, atol=2e-5)


def test_mla_streaming_path_skips_hidden_blocks_bit_for_bit():
    """The causal mask hides the key blocks after a query block's own; the
    streaming prefill skips them and equals the every-block loop bit for
    bit."""
    _, tcfg = _cfgs(d_model=16, num_heads=2)
    jcfg, _ = _cfgs(d_model=16, num_heads=2)
    _, tp = _params(jcfg, 4)
    S = 2 * tattn.QBLOCK_THRESHOLD
    x = tt(rand(5, (1, S, tcfg.d_model), 0.5))
    pos = torch.arange(S, dtype=torch.int32)[None]
    got = tattn.mla_prefill(tp, x, pos, tcfg)
    dn = tcfg.qk_nope_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, tp["wq"])
    qr = tattn.rope(q[..., dn:], pos, tcfg.rope_theta)
    ckv = torch.einsum("bsd,dr->bsr", x, tp["w_dkv"])
    kr = tattn.rope(torch.einsum("bsd,dk->bsk", x, tp["w_krope"])[:, :, None],
                    pos, tcfg.rope_theta)[:, :, 0]
    kn = torch.einsum("bsr,rhk->bshk", ckv, tp["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", ckv, tp["w_uv"])
    Q = tattn.QBLOCK
    every = torch.cat([tattn._mla_flash(
        q[:, i:i + Q, :, :dn], qr[:, i:i + Q], kn, kr, v, pos[0, i:i + Q],
        pos[0], (dn + tcfg.qk_rope_head_dim) ** -0.5)
        for i in range(0, S, Q)], 1)
    assert torch.equal(got, torch.einsum("bshk,hkd->bsd", every, tp["wo"]))
    visible = tattn._visible_blocks(S, 0)
    assert all(row[i] and not any(row[i + 1:])
               for i, row in enumerate(visible))


@pytest.mark.parametrize("path", ["dense", "streaming"])
def test_mla_bf16_keeps_each_paths_cast_order(path):
    """bf16: the dense path sums and scales the logits in bf16 (by the
    scale rounded to bf16) and casts at the mask, the streaming path casts
    each logit product to float32 before it adds and scales; each against
    the reference's own path."""
    jcfg, tcfg = _cfgs(d_model=16, num_heads=2, dtype="bfloat16")
    jp = j_mla_params(jax.random.PRNGKey(6), jcfg, jnp.bfloat16)
    tp = port(jp)
    S = 1024 if path == "dense" else tattn.QBLOCK_THRESHOLD
    x = rand(7, (1, S, tcfg.d_model), 3.0)
    pos = _pos(1, S)
    got = tattn.mla_prefill(tp, tt(x).to(torch.bfloat16), tt(pos), tcfg)
    want = jattn.mla_prefill(jp, jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(pos), jcfg)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    close_of_max(got, want, 5e-3, path)
    # the mean error tells the cast orders apart: the scale unrounded to
    # bf16 (dense), or the logit products added in bf16 (streaming), read
    # 9e-3 of the mean magnitude here
    assert np.abs(got - want).mean() <= 1e-4 * np.abs(want).mean()


def test_mla_streaming_gradient_matches_reference():
    jcfg, tcfg = _cfgs(d_model=16, num_heads=2)
    jp, tp = _params(jcfg, 8)
    S = tattn.QBLOCK_THRESHOLD
    x = rand(9, (1, S, tcfg.d_model), 0.5)
    pos = _pos(1, S)
    names = ("wq", "w_dkv", "w_krope", "w_uv")

    def jf(*ws):
        out = jattn.mla_prefill(dict(jp, **dict(zip(names, ws))),
                                jnp.asarray(x), jnp.asarray(pos), jcfg)
        return jnp.sum(out ** 2)

    want = jax.grad(jf, argnums=tuple(range(len(names))))(
        *(jp[n] for n in names))
    ws = [tp[n].clone().requires_grad_(True) for n in names]
    out = tattn.mla_prefill(dict(tp, **dict(zip(names, ws))), tt(x),
                            tt(pos), tcfg)
    got = torch.autograd.grad(torch.sum(out ** 2), ws)
    for n, g, w in zip(names, got, want):
        close_of_max(g.numpy(), w, 1e-4, n)


def test_mla_decode_clamps_its_write_at_t_past_T():
    """``lax.dynamic_update_slice`` clamps its start index: a latent cache
    of T slots written at t >= T overwrites slot T - 1 (where a torch
    index would raise), and the mask lets every slot through.  The port
    mirrors both, step for step against the reference."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 10)
    B, T = 2, 5
    x = rand(11, (B, T + 3, tcfg.d_model), 0.5)
    jcache, cache = _empty(B, T, tcfg)
    for t in range(T + 3):
        before = cache["ckv"].clone()
        out, cache = tattn.mla_decode(tp, tt(x[:, t:t + 1]), t, cache, tcfg)
        jout, jcache = jattn.mla_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                        jnp.int32(t), jcache, jcfg)
        close_of_max(out.numpy(), jout, 1e-5, f"t={t}")
        for k in ("ckv", "krope"):
            close_of_max(cache[k].numpy(), jcache[k], 1e-6, f"{k} t={t}")
        changed = (cache["ckv"] != before).any(-1).any(0)
        assert changed.nonzero().flatten().tolist() == [min(t, T - 1)]


# ---------------------------------------------------------------------------
# deepseek-v2-lite smoke against the reference
# ---------------------------------------------------------------------------

def test_deepseek_configs_are_the_reference_configs():
    assert_configs_equal(ARCH)


def test_deepseek_init_params_have_the_reference_tree():
    got = assert_init_tree_matches(ARCH, 18)
    ffn = got["layers"]["ffn"]
    assert tuple(ffn["shared_w_gate"].shape) == (2, 128, 64)
    assert tuple(got["layers"]["attn"]["w_uk"].shape) == (2, 32, 4, 16)


def test_deepseek_param_counts_are_the_reference_counts():
    assert assert_param_counts(ARCH) == 16_210_311_168


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_deepseek_forward_and_loss_match_reference(dispatch):
    jcfg, tcfg, jp, tp = smoke_model(ARCH, moe_dispatch=dispatch)
    assert_forward_and_loss(jcfg, tcfg, jp, tp, aux_nonzero=True)


def test_deepseek_streaming_forward_matches_reference():
    jcfg, tcfg, jp, tp = smoke_model(ARCH, seed=3)
    assert_streaming_forward(jcfg, tcfg, jp, tp)


def test_deepseek_init_cache_matches_reference():
    assert_init_cache(ARCH, 24, ["ckv", "krope"])


def test_deepseek_decode_steps_match_reference_and_forward():
    """Dropless decode on a cache as long as the prompt; the last step
    against the forward's last position (capacity 100: no drops)."""
    jcfg, tcfg, jp, tp = smoke_model(ARCH, capacity_factor=100.0)
    logits, _, tok = assert_decode_steps(jcfg, tcfg, jp, tp, 12)
    full, _ = tlm.forward(tcfg, tp, tt(tok).long(), last_only=True)
    close_of_max(logits.numpy(), full[:, 0].numpy(), 1e-5, "vs forward")


def test_deepseek_decode_past_the_cache_end_matches_reference():
    """14 steps on an 8-position latent cache: from t = 8 on, every layer
    writes slot 7 (the clamp), as the reference's decode does."""
    jcfg, tcfg, jp, tp = smoke_model(ARCH, seed=2)
    assert_decode_steps(jcfg, tcfg, jp, tp, 14, cache_seq=8)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_deepseek_trainer_rounds_match_reference(use_kernel):
    assert_trainer_rounds(ARCH, use_kernel)
