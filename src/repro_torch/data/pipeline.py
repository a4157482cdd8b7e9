"""Deterministic synthetic data (port of ``repro.data.pipeline``).

The paper's LIBSVM data is not in the repository, so the GLM experiments
run on a synthetic stand-in with the same statistical role (DESIGN.md §9);
LM training runs on a synthetic token stream with a copy structure.
Data is made on ``device`` (default the card) from explicit generators
seeded by ``seed``, so a full-size problem never crosses the host link.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.rng import generator


def synthetic_classification(seed: int, n_nodes: int, m: int, d: int, *,
                             separable_scale: float = 1.0,
                             device=DEFAULT_DEVICE
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Features (n, m, d) and +/-1 labels (n, m); a planted linear teacher
    generates labels (5% flipped) so the task is learnable (stands in for
    `mushrooms` / `real-sim`)."""
    dev = resolve_device(device)
    feats = torch.randn((n_nodes, m, d), device=dev,
                        generator=generator(dev, seed, "features"))
    feats.div_(math.sqrt(d))
    teacher = torch.randn((d,), device=dev,
                          generator=generator(dev, seed, "teacher"))
    teacher.mul_(separable_scale)
    margin = torch.matmul(feats, teacher)
    flips = torch.rand(margin.shape, device=dev,
                       generator=generator(dev, seed, "flips")) < 0.05
    sign = torch.sign(margin)
    labels = torch.where(flips, -sign, sign)
    return feats, labels


def synthetic_quadratic(seed: int, d: int, *, mu: float = 1.0,
                        L: float = 2.0, device=DEFAULT_DEVICE
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A = A^T > 0 with spectrum in [mu, L] (Appendix I), plus b."""
    dev = resolve_device(device)
    g = torch.randn((d, d), device=dev, generator=generator(dev, seed, "q"))
    q, _ = torch.linalg.qr(g)
    eigs = torch.linspace(mu, L, d, device=dev)
    A = (q * eigs) @ q.T
    b = torch.randn((d,), device=dev, generator=generator(dev, seed, "b"))
    return A, b


@dataclasses.dataclass(frozen=True)
class SyntheticTextConfig:
    vocab_size: int
    seq_len: int
    copy_period: int = 16     # tokens repeat with this period => learnable


def make_lm_batch(seed: int, cfg: SyntheticTextConfig, batch: int, *,
                  with_images: int = 0, with_frames: int = 0,
                  d_model: int = 0, dtype: torch.dtype = torch.bfloat16,
                  device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """Next-token LM batch ``{"tokens", "labels"}`` of (batch, seq_len)
    int64: a period-``copy_period`` stream with 10% of tokens replaced by
    noise (the reference's recipe).  ``with_images`` / ``with_frames``
    add the stubbed modality embeddings, standard normal (batch,
    with_images | with_frames, d_model) in ``dtype`` under
    ``"image_embeds"`` / ``"frames"``, each from a generator of its own
    (the tokens do not depend on them)."""
    dev = resolve_device(device)
    S, V = cfg.seq_len, cfg.vocab_size
    base = torch.randint(1, V, (batch, cfg.copy_period), device=dev,
                         generator=generator(dev, seed, "base"))
    reps = -(-S // cfg.copy_period) + 1
    stream = base.repeat(1, reps)
    noise = torch.randint(1, V, (batch, S + 1), device=dev,
                          generator=generator(dev, seed, "noise"))
    noisy = torch.rand((batch, S + 1), device=dev,
                       generator=generator(dev, seed, "noisy")) < 0.1
    seq = torch.where(noisy, noise, stream[:, :S + 1])
    out = {"tokens": seq[:, :S], "labels": seq[:, 1:]}
    for key, count in (("image_embeds", with_images),
                       ("frames", with_frames)):
        if count:
            out[key] = torch.randn(
                (batch, count, d_model), device=dev,
                generator=generator(dev, seed, key)).to(dtype)
    return out


def modality_kw(cfg) -> Dict:
    """:func:`make_lm_batch`'s keywords for an ``ArchConfig``'s stubbed
    inputs: the VLM's ``num_image_tokens`` image embeddings, the
    encoder-decoder's ``num_audio_frames`` frames, in the model dtype;
    none for the other families (the reference trainer's ``data_kw``)."""
    count = {"vlm": ("with_images", cfg.num_image_tokens),
             "audio": ("with_frames", cfg.num_audio_frames)}
    if cfg.arch_type not in count:
        return {}
    key, n = count[cfg.arch_type]
    return {key: n, "d_model": cfg.d_model, "dtype": cfg.torch_dtype}


def make_node_batches(seed: int, cfg: SyntheticTextConfig, n_nodes: int,
                      per_node_batch: int, *, device=DEFAULT_DEVICE,
                      **kw) -> Dict[str, torch.Tensor]:
    """Batch with a leading node axis (n, b, ...) for DASHA training;
    ``kw`` (the modality stubs) goes to :func:`make_lm_batch`."""
    batch = make_lm_batch(seed, cfg, n_nodes * per_node_batch,
                          device=device, **kw)
    return {k: v.reshape((n_nodes, per_node_batch) + v.shape[1:])
            for k, v in batch.items()}
