"""Minimal functional optimizers over parameter trees (port of
``repro.optim.base``): SGD, momentum, Adam.

API as the reference's (optax-like): ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``, with updates to be
ADDED to params by :func:`apply_updates`.  Nothing is updated in place.
Adam's step count lives on the host, and its bias corrections are rounded
to float32 as the reference computes them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import tree

Tree = Any


class SGDState(NamedTuple):
    momentum: Tree


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float
    momentum: float = 0.0

    def init(self, params: Tree) -> SGDState:
        zeros = tree.map_leaves(torch.zeros_like, params) \
            if self.momentum else None
        return SGDState(momentum=zeros)

    def update(self, grads: Tree, state: SGDState, params=None
               ) -> Tuple[Tree, SGDState]:
        if not self.momentum:
            return tree.map_leaves(lambda g: -self.lr * g, grads), state
        mom = tree.map_leaves(lambda m, g: self.momentum * m + g,
                              state.momentum, grads)
        return (tree.map_leaves(lambda m: -self.lr * m, mom),
                SGDState(momentum=mom))


class AdamState(NamedTuple):
    mu: Tree
    nu: Tree
    count: int


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Tree) -> AdamState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamState(mu=tree.map_leaves(zeros, params),
                         nu=tree.map_leaves(zeros, params), count=0)

    def update(self, grads: Tree, state: AdamState, params: Tree = None
               ) -> Tuple[Tree, AdamState]:
        c = state.count + 1
        f32 = np.float32
        mu = tree.map_leaves(
            lambda m, g: self.b1 * m + (1 - self.b1) * g.to(torch.float32),
            state.mu, grads)
        nu = tree.map_leaves(
            lambda v, g: self.b2 * v
            + (1 - self.b2) * torch.square(g.to(torch.float32)),
            state.nu, grads)
        bc1 = float(f32(1) - f32(self.b1) ** f32(c))
        bc2 = float(f32(1) - f32(self.b2) ** f32(c))

        def upd(m, v, p=None):
            step = m / bc1 / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay and p is not None:
                step = step + self.weight_decay * p.to(torch.float32)
            return -self.lr * step

        if params is None:
            updates = tree.map_leaves(upd, mu, nu)
        else:
            updates = tree.map_leaves(upd, mu, nu, params)
        return updates, AdamState(mu=mu, nu=nu, count=c)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree.map_leaves(
        lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates)
