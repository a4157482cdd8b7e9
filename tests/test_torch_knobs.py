"""The mesh knobs on one device, and the prefill's visible blocks (CPU).

* ``DashaTrainConfig``'s ``fsdp``, ``seq_shard`` and ``spmd_axes`` shape
  the train specs; on one device the train step with them set equals the
  step without them, bit for bit, as the reference's does on its 1x1
  host mesh (``lm.loss_fn(seq_shard=...)`` is an identity on plain
  tensors);
* ``attention._visible_blocks`` reckons the streaming prefill's visible
  key blocks from the positions' ints (a ``meta`` or sharded trace has no
  values to read): its rows equal the old mask-built ones, and the
  prefill through it is bit-equal to the prefill through the old form.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import tree
from repro_torch.data.pipeline import SyntheticTextConfig, make_node_batches
from repro_torch.models import attention as tattn
from repro_torch.models import init_params, lm
from repro_torch.optim import distributed as tdist


def _old_visible_blocks(q_pos, k_pos, window):
    """The form before: the mask over the position tensors, reduced a
    block at a time, read back with ``.tolist()``."""
    mask = tattn._causal_window_mask(q_pos, k_pos, window)
    nq, nk = q_pos.shape[0] // tattn.QBLOCK, k_pos.shape[0] // tattn.KBLOCK
    return mask.view(nq, tattn.QBLOCK, nk, tattn.KBLOCK).any(3).any(1) \
        .tolist()


@pytest.mark.parametrize("S", [2048, 2560, 4096, 8192])
def test_visible_blocks_from_ints_equal_the_mask_form(S):
    pos = torch.arange(S, dtype=torch.int32)
    for window in (0, 1, 2, 100, 511, 512, 513, 700, 1024, 1500, 4096,
                   5000):
        assert tattn._visible_blocks(S, window) == \
            _old_visible_blocks(pos, pos, window), window


@pytest.mark.parametrize("window", [0, 700])
def test_prefill_through_the_new_blocks_is_bit_equal(monkeypatch, window):
    cfg = dataclasses.replace(get_smoke_config("starcoder2-3b"),
                              dtype="float32", num_heads=2, num_kv_heads=1,
                              head_dim=8, d_model=16)
    p = init_params(cfg, 3, device="cpu")["layers"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    S = 2 * tattn.QBLOCK_THRESHOLD
    x = 0.5 * torch.randn((1, S, cfg.d_model),
                          generator=torch.Generator().manual_seed(5))
    pos = torch.arange(S, dtype=torch.int32)[None]
    new = tattn.gqa_prefill(p, x, pos, cfg, window=window)
    monkeypatch.setattr(tattn, "_visible_blocks",
                        lambda S_, w: _old_visible_blocks(pos[0], pos[0], w))
    old = tattn.gqa_prefill(p, x, pos, cfg, window=window)
    assert torch.equal(new, old)


KNOBS = [dict(fsdp=True), dict(seq_shard=True), dict(spmd_axes=("data",)),
         dict(fsdp=True, seq_shard=True, spmd_axes=("pod", "data"))]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(k))
@pytest.mark.parametrize("variant,server_opt", [("dasha", "sgd"),
                                                ("mvr", "adam")])
def test_train_step_with_mesh_knobs_equals_the_step_without(knobs, variant,
                                                           server_opt):
    cfg = dataclasses.replace(get_smoke_config("mamba2-780m"),
                              dtype="float32")
    n = 2
    base = tdist.DashaTrainConfig(gamma=0.05, variant=variant, n_nodes=n,
                                  server_opt=server_opt)
    knobbed = dataclasses.replace(base, **knobs)
    params = init_params(cfg, 0, device="cpu")
    batch = make_node_batches(1, SyntheticTextConfig(
        vocab_size=cfg.vocab_size, seq_len=32), n, 1, device="cpu")

    def run(dcfg):
        seq = "model" if dcfg.seq_shard else None
        step = tdist.make_train_step(
            dcfg, lambda p, b: lm.loss_fn(cfg, p, b, seq_shard=seq)[0])
        state = tdist.dasha_train_init(
            tree.map_leaves(torch.clone, params), dcfg, 7, device="cpu")
        infos = []
        for _ in range(2):
            state, info = step(state, batch)
            infos.append(float(info["g_norm_sq"]))
        return state, infos

    (want, want_info), (got, got_info) = run(base), run(knobbed)
    assert got_info == want_info
    for field in ("params", "g", "h_local", "g_local"):
        for (path, a), (_, b) in zip(tree.items(getattr(got, field)),
                                     tree.items(getattr(want, field))):
            assert torch.equal(a, b), (field, path)
    assert (got.seed, got.step) == (want.seed, want.step)
