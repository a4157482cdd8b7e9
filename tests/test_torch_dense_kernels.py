"""The fused tree path of a sweep's lanes, and the dense family on the card
(no JAX: the card tests run where it is not installed).

* CPU: ``treelevel.fused_leaf_updates(lanes=True)`` on (G, n, *shape)
  leaves equals G one-lane calls on the same masks bit for bit, for the
  MVR kernel (kernel 3) and kernel 1's sparsifier entry, on independent,
  shared_coords and PermK draws; the plain MVR update reads an (n, cols)
  mask for G * n rows at row r % n, as the kernel does;
* card (``cuda``): the same lane calls, on masks drawn once on the CPU,
  launch kernel 3 / kernel 1 once per leaf and equal the CPU's bit for
  bit; the starcoder2 smoke model's prefill (dense and streaming) and
  decode past its ring in float32 within 1e-4 of the CPU's largest
  logit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.compress import treelevel
from repro_torch.configs import get_smoke_config
from repro_torch.core import tree
from repro_torch.core.rng import Draws, RoundRandom
from repro_torch.kernels import dasha_update as kern
from repro_torch.kernels import ref
from repro_torch.launch import serve as S
from repro_torch.models import init_params, lm

torch.set_num_threads(1)

G, N = 3, 4
SHAPES = {"w": (6, 5), "layers": {"a": (2, 3, 4), "b": (2, 7)}, "c": (9,)}


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lane_tree(seed, dev="cpu"):
    gen = torch.Generator().manual_seed(seed)

    def make(s):
        return {k: make(v) if isinstance(v, dict)
                else torch.randn((G, N) + v, generator=gen).to(dev)
                for k, v in s.items()}
    return make(SHAPES)


def _lane_updates(dev, mode, variant, lanes=True, j=None, masks=None):
    """The fused lane path's outputs on ``dev``: the round's own draws, or
    ``masks`` (one CPU draw, so that the card and the CPU read the same
    masks: the card draws Bernoulli masks from its own generators)."""
    trees = [_lane_tree(s, dev) for s in (1, 2, 3, 4)]
    if j is not None:
        trees = [tree.map_leaves(lambda x: x[j], t) for t in trees]
    gn, go, h, gl = trees
    draws = None if masks is None else Draws(
        masks=tree.map_leaves(lambda m: m.to(dev), masks))
    rnd = RoundRandom(5, 2, draws)
    return list(treelevel.fused_leaf_updates(
        rnd, gn, h, gl, mode=mode, a=0.2, p=0.3, n=N, variant=variant,
        b=0.1, grads_old=go, lanes=lanes))


@pytest.mark.parametrize("variant", ["mvr", "dasha"])
@pytest.mark.parametrize("mode", ["independent", "shared_coords", "permk"])
def test_lane_fused_updates_equal_one_lane_calls(mode, variant):
    lanes = _lane_updates("cpu", mode, variant)
    for j in range(G):
        one = _lane_updates("cpu", mode, variant, lanes=False, j=j)
        for (path, *outs), (path1, *outs1) in zip(lanes, one):
            assert path == path1
            for o, o1 in zip(outs, outs1):
                assert torch.equal(o[j], o1), (path, j)


def test_plain_mvr_update_reads_node_rows_of_a_mask():
    gen = torch.Generator().manual_seed(0)
    gn, go, h, gl = (torch.randn((G * N, 11), generator=gen)
                     for _ in range(4))
    mask = torch.rand((N, 11), generator=gen) < 0.5
    m, h_new, g_new = ref.dasha_mvr_update_ref(gn, go, h, gl, mask, 0.2,
                                               0.1, 2.0)
    full = mask.repeat(G, 1)
    want = ref.dasha_mvr_update_ref(gn, go, h, gl, full, 0.2, 0.1, 2.0)
    for a, b in zip((m, h_new, g_new), want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,name", [("mvr", "dasha_mvr_update"),
                                          ("dasha", "dasha_sparsify_update")])
@pytest.mark.parametrize("mode", ["independent", "shared_coords", "permk"])
def test_cuda_lane_fused_updates_equal_the_cpu(cuda_device, mode, variant,
                                               name):
    one_lane = tree.map_leaves(lambda x: x[0], _lane_tree(1))
    masks, _ = treelevel.tree_masks(RoundRandom(5, 2), one_lane, mode=mode,
                                    p=0.3, n=N)
    kern.reset_counts()
    card = _lane_updates(cuda_device, mode, variant, masks=masks)
    assert kern.COUNTS[name] == len(card)
    for (path, *outs), (_, *cpu) in zip(card, _lane_updates(
            "cpu", mode, variant, masks=masks)):
        for o, c in zip(outs, cpu):
            assert torch.equal(o.cpu(), c), path


@pytest.mark.cuda
def test_cuda_starcoder2_smoke_matches_the_cpu(cuda_device):
    cfg = dataclasses.replace(get_smoke_config("starcoder2-3b"),
                              dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    card = tree.map_leaves(lambda p: p.to(cuda_device), params)
    gen = torch.Generator().manual_seed(1)
    for shape in ((2, 64), (1, 2048)):
        tok = torch.randint(1, cfg.vocab_size, shape, generator=gen)
        want = S.prefill_logits(cfg, params, tok)
        got = S.prefill_logits(cfg, card, tok.to(cuda_device)).cpu()
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
    steps = 24
    tok = torch.randint(1, cfg.vocab_size, (2, steps), generator=gen)
    caches = [lm.init_cache(cfg, 2, steps, device=d)
              for d in ("cpu", cuda_device)]
    with torch.inference_mode():
        for t in range(steps):
            want, _ = lm.decode_step(cfg, params, caches[0], tok[:, t], t)
            got, _ = lm.decode_step(cfg, card, caches[1],
                                    tok[:, t].to(cuda_device), t)
            np.testing.assert_allclose(
                got.cpu().numpy(), want.numpy(), rtol=0,
                atol=1e-4 * float(want.abs().max()))
