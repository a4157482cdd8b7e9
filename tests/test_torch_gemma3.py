"""The port's gemma3 family — the grouped local/global stack — against the
reference (CPU).

* config, ``init_params`` (``local_layers`` stacked (n_groups, n_local,
  ...) and ``global_layers`` (n_groups, ...): names, shapes, dtypes, and
  ``params_from_numpy`` of the reference's tree bit for bit),
  ``param_count`` / ``active_param_count`` of the full config;
* ``forward`` (local layers under the 16-token smoke window, the global
  layer of each group over everything; the dense path and the streaming
  path at 2,048 tokens), ``loss_fn`` with its aux loss (zero: gemma3 has
  no experts), ``init_cache`` (local rings and global caches) and
  ``decode_step`` across the local rings' wrap, on the reference's
  parameters;
* the embedding scale sqrt(d_model) rounded to bf16 before it multiplies
  (11.3125 for the smoke config's d = 128, 62.0 for the full d = 3,840),
  bit for bit against the reference's ``_embed`` in bf16;
* DASHA-MVR trainer rounds on replayed masks, plain and kernel routes.

Tolerances as ``tests/test_torch_dense.py``'s: float32 logits within 1e-5
of the largest magnitude; trainer states within 2e-4 of each leaf's
largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import init_params as j_init
from repro.models import lm as jlm
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import lm as tlm
from repro_torch.models.common import dtype_scalar
from torch_models_common import (assert_configs_equal,
                                 assert_decode_steps,
                                 assert_forward_and_loss,
                                 assert_init_cache,
                                 assert_init_tree_matches,
                                 assert_param_counts,
                                 assert_streaming_forward,
                                 assert_trainer_rounds, close_of_max, port,
                                 smoke_model, tokens, tt)

torch.set_num_threads(1)

ARCH = "gemma3-12b"


def test_gemma3_configs_are_the_reference_configs():
    assert_configs_equal(ARCH)


def test_gemma3_init_params_have_the_reference_tree():
    got = assert_init_tree_matches(ARCH, 20)
    cfg = t_smoke(ARCH)
    assert "layers" not in got and "lm_head" not in got   # tied head
    assert tuple(got["local_layers"]["attn"]["wq"].shape) == (
        2, 1, cfg.d_model, cfg.num_heads, cfg.head_dim)
    assert tuple(got["global_layers"]["ffn"]["w_out"].shape) == (
        2, cfg.d_ff, cfg.d_model)
    # every layer has its own draw
    wq = got["local_layers"]["attn"]["wq"].float()
    assert not torch.equal(wq[0, 0], wq[1, 0])
    assert not torch.equal(got["global_layers"]["attn"]["wq"][0].float(),
                           got["global_layers"]["attn"]["wq"][1].float())


def test_gemma3_param_counts_are_the_reference_counts():
    assert assert_param_counts(ARCH) == 11_765_395_200


def test_gemma3_forward_and_loss_match_reference():
    jcfg, tcfg, jp, tp = smoke_model(ARCH)
    assert_forward_and_loss(jcfg, tcfg, jp, tp)


def test_gemma3_streaming_forward_matches_reference():
    """2,048 tokens: the local layers on the streaming path under their
    16-token window, the global layers over all of it."""
    jcfg, tcfg, jp, tp = smoke_model(ARCH, seed=3)
    assert_streaming_forward(jcfg, tcfg, jp, tp)


@pytest.mark.parametrize("seq", [8, 40])
def test_gemma3_init_cache_matches_reference(seq):
    assert_init_cache(ARCH, seq, ["global/k", "global/v", "local/k",
                                  "local/v"])
    cache = tlm.init_cache(t_smoke(ARCH), 1, seq, device="cpu")
    assert cache["local"]["k"].shape[3] == min(16, seq)
    assert cache["global"]["k"].shape[2] == seq


def test_gemma3_decode_steps_match_reference_across_the_ring_wrap():
    """24 steps: past the 16-slot local rings (written at t % 16, no window
    mask) while the global caches fill; the last step against the
    forward's last position."""
    jcfg, tcfg, jp, tp = smoke_model(ARCH, seed=1)
    logits, cache, tok = assert_decode_steps(jcfg, tcfg, jp, tp, 24)
    full, _ = tlm.forward(tcfg, tp, tt(tok).long(), last_only=True)
    close_of_max(logits.numpy(), full[:, 0].numpy(), 1e-5, "vs forward")
    assert cache["local"]["k"].shape[3] == 16       # the rings wrapped


def test_gemma3_local_layers_decode_on_their_rings():
    """The local layers see the last W = 16 positions through their
    rings: the same decode on 20-slot rings (W = 20) differs once the
    16-slot rings have wrapped."""
    _, tcfg, _, tp = smoke_model(ARCH, seed=1)
    tok = tokens(5, 1, 20)
    ring = tlm.init_cache(tcfg, 1, 20, device="cpu")
    for t in range(20):
        a, ring = tlm.decode_step(tcfg, tp, ring, tt(tok[:, t]).long(), t)
    wide = dataclasses.replace(tcfg, sliding_window=20)
    flat = tlm.init_cache(wide, 1, 20, device="cpu")
    for t in range(20):
        b, flat = tlm.decode_step(wide, tp, flat, tt(tok[:, t]).long(), t)
    assert float((a - b).abs().max()) > 1e-4


def test_gemma3_embedding_scale_is_rounded_to_bf16():
    """bf16: the embeddings times sqrt(d) rounded to bf16 (11.3125 for d =
    128), bit for bit the reference's ``_embed``; multiplying by the
    unrounded 11.3137... gives other numbers."""
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    jp = j_init(jcfg, jax.random.PRNGKey(2))
    tp = port(jp)
    tok = tokens(6, 2, 64)
    got = tlm._embed(tcfg, tp, tt(tok).long())
    want = jlm._embed(jcfg, jp, jnp.asarray(tok))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert dtype_scalar(128 ** 0.5, torch.bfloat16) == 11.3125
    assert dtype_scalar(t_config(ARCH).d_model ** 0.5, torch.bfloat16) \
        == 62.0
    unrounded = tp["embed"][tt(tok).long()] * 128 ** 0.5
    assert not torch.equal(unrounded, got)
    # only gemma scales: a dense config without global_every does not
    plain = dataclasses.replace(tcfg, global_every=0)
    assert torch.equal(tlm._embed(plain, tp, tt(tok).long()),
                       tp["embed"][tt(tok).long()])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gemma3_trainer_rounds_match_reference(use_kernel):
    assert_trainer_rounds(ARCH, use_kernel)


def test_gemma3_trainer_resumes_from_a_checkpoint_bit_for_bit(tmp_path):
    """The doubly stacked local_layers tree through ``--ckpt`` /
    ``--resume``: 2 + 2 rounds equal 4 uninterrupted rounds."""
    from repro_torch.core import tree
    from repro_torch.launch import train as ttrain
    argv = ["--log-every", "2", "--seq", "32", "--variant", "mvr",
            "--use-kernel"]
    ckpt = ["--ckpt", str(tmp_path / "ck")]

    def run(*extra):
        args = ttrain.build_parser().parse_args([*argv, *extra])
        return ttrain.train(t_smoke(ARCH), args, device="cpu",
                            log=lambda m: None)

    full = run("--steps", "4")
    run("--steps", "2", *ckpt)
    res = run("--steps", "4", *ckpt, "--resume")
    assert res.start_step == 2 and res.state.t == full.state.t == 4
    for name in ("x", "g", "h_local"):
        for path, w in tree.items(getattr(full.state, name)):
            assert torch.equal(tree.get(getattr(res.state, name), path), w)
