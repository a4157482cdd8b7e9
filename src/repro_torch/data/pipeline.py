"""Deterministic synthetic data (port of ``repro.data.pipeline``).

The paper's LIBSVM data is not in the repository, so the GLM experiments
run on a synthetic stand-in with the same statistical role (DESIGN.md §9).
Data is made on ``device`` (default the card) from explicit generators
seeded by ``seed``, so a full-size problem never crosses the host link.
"""
from __future__ import annotations

import math
from typing import Tuple

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
