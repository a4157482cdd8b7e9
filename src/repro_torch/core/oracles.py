"""Gradient oracles for the settings of Section 1.2 (port of
``repro.core.oracles``).

Per-node quantities are stacked ``(n, d)`` tensors.  A problem is given as
a per-sample loss written in torch; gradients come from ``torch.func.grad``
and the node and sample axes from ``torch.func.vmap``.

Randomness is explicit: a problem draws its samples from a generator
(:meth:`draw_samples`), and every oracle takes the samples as an argument,
so a round's samples can be drawn by the reference and injected.

Memory: a gradient is the gradient of the mean loss over the samples
(``grad(mean(vmap(loss)))``), not the mean of per-sample gradients.  The
two are the same function, but the first never forms an (n, m, d)
per-sample tensor: under vmap the loss becomes one matrix-vector product
and its backward one more, so the intermediate is (n, m).  At the real-sim
shape (n = 5, m = 14,461, d = 20,958) the per-sample form would put a
second 6 GB tensor beside the features.

Lanes: every oracle has a ``*_lanes`` form that takes G iterates, (G, d),
and returns (G, n, d), for the hyperparameter sweep
(:class:`repro_torch.methods.driver.Sweeper`).  Every lane uses the same
samples.  The lane vmap sits *inside* the node vmap, so at the lane level
the features are unbatched: a node's loss over its samples becomes one
(m, d) @ (d, G) product and its backward one (d, m) @ (m, G) product,
which read the features once for all G lanes.  With the lanes outside the
nodes, the backward would copy the features once per lane (8 x 6.06 GB at
real-sim with G = 8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.func import grad, vmap

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device

Loss = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FiniteSumProblem:
    """f_i(x) = (1/m) sum_j loss(x, a_ij, y_ij)   (eq. (2)).

    ``features``: (n, m, ...), ``labels``: (n, m, ...), on one device.
    Samples are (n, B) int64 indices into the m axis.
    """

    loss: Loss
    features: torch.Tensor
    labels: torch.Tensor

    @property
    def n(self) -> int:
        return self.features.shape[0]

    @property
    def m(self) -> int:
        return self.features.shape[1]

    @property
    def device(self) -> torch.device:
        return self.features.device

    def _node_mean(self, x, a, y):
        return vmap(self.loss, in_dims=(None, 0, 0))(x, a, y).mean()

    def _grads(self, x: torch.Tensor, a: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
        """(n, d): gradient of each node's mean loss over its samples."""
        return vmap(grad(self._node_mean), in_dims=(None, 0, 0))(x, a, y)

    def _lane_grads(self, X: torch.Tensor, a: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
        """(G, n, d): :meth:`_grads` at each of the G iterates of X, the
        lane vmap inside the node vmap (see the module docstring)."""
        return _lanes_inside(grad(self._node_mean), X, a, y)

    # -- function values -------------------------------------------------
    def f(self, x: torch.Tensor) -> torch.Tensor:
        """Global objective f(x) = (1/n) sum_i f_i(x)."""
        return vmap(self._node_mean, in_dims=(None, 0, 0))(
            x, self.features, self.labels).mean()

    # -- oracles ----------------------------------------------------------
    def full_grad(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d): exact nabla f_i(x) for every node."""
        return self._grads(x, self.features, self.labels)

    def grad_f(self, x: torch.Tensor) -> torch.Tensor:
        return self.full_grad(x).mean(0)

    def full_grad_lanes(self, X: torch.Tensor) -> torch.Tensor:
        """(G, n, d): :meth:`full_grad` at each row of X (G, d)."""
        return self._lane_grads(X, self.features, self.labels)

    def grad_f_lanes(self, X: torch.Tensor) -> torch.Tensor:
        """(G, d): :meth:`grad_f` at each row of X."""
        return self.full_grad_lanes(X).mean(-2)

    def draw_samples(self, generator: torch.Generator,
                     batch: int) -> torch.Tensor:
        """(n, batch) indices, i.i.d. WITH replacement (the paper's
        multiset I_i)."""
        return torch.randint(0, self.m, (self.n, batch), generator=generator,
                             device=self.device)

    def as_samples(self, idx) -> torch.Tensor:
        return torch.as_tensor(idx, dtype=torch.int64, device=self.device)

    def _gather(self, idx: torch.Tensor):
        rows = torch.arange(self.n, device=self.device)[:, None]
        return self.features[rows, idx], self.labels[rows, idx]

    def minibatch_grad(self, x: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
        """(n, d): (1/B) sum_{j in I_i} nabla f_ij(x)."""
        return self._grads(x, *self._gather(idx))

    def minibatch_diff(self, x_new: torch.Tensor, x_old: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
        """(n, d): the same-sample gradient difference at two points
        (PAGE / MARINA)."""
        a, y = self._gather(idx)
        return self._grads(x_new, a, y) - self._grads(x_old, a, y)

    def minibatch_grad_lanes(self, X: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
        """(G, n, d): :meth:`minibatch_grad` at each row of X."""
        return self._lane_grads(X, *self._gather(idx))

    def minibatch_diff_lanes(self, X_new: torch.Tensor, X_old: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
        """(G, n, d): :meth:`minibatch_diff` for each lane's two
        iterates."""
        a, y = self._gather(idx)
        return self._lane_grads(X_new, a, y) - self._lane_grads(X_old, a, y)


@dataclasses.dataclass(frozen=True)
class StochasticProblem:
    """f_i(x) = E_xi[loss(x, xi, i)]  (eq. (3)).

    ``sample(generator, node_idx, batch)`` returns one node's batch of xi;
    ``loss(x, xi, i)`` is the per-sample stochastic loss (``i`` arrives as
    a 0-d tensor under vmap).  Samples are stacked (n, B, ...) xi.
    """

    loss: Loss
    sample: Callable[[torch.Generator, int, int], torch.Tensor]
    n: int
    device: torch.device = torch.device(DEFAULT_DEVICE)
    # exact gradient of E[f] when available (synthetic problems)
    true_grad: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def draw_samples(self, generator: torch.Generator,
                     batch: int) -> torch.Tensor:
        return torch.stack([self.sample(generator, i, batch)
                            for i in range(self.n)])

    def as_samples(self, xi) -> torch.Tensor:
        return torch.as_tensor(xi, dtype=torch.float32, device=self.device)

    def _node_mean(self, x, xi, i):
        return vmap(self.loss, in_dims=(None, 0, None))(x, xi, i).mean()

    def _grads(self, x: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        nodes = torch.arange(self.n, device=self.device)
        return vmap(grad(self._node_mean), in_dims=(None, 0, 0))(x, xi, nodes)

    def stoch_grad(self, x: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """(n, d): minibatch stochastic gradient per node."""
        return self._grads(x, xi)

    def stoch_grad_pair(self, x_new: torch.Tensor, x_old: torch.Tensor,
                        xi: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gradients at x_new and x_old with the SAME xi samples (MVR)."""
        return self._grads(x_new, xi), self._grads(x_old, xi)

    def _lane_grads(self, X: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        nodes = torch.arange(self.n, device=self.device)
        return _lanes_inside(grad(self._node_mean), X, xi, nodes)

    def stoch_grad_lanes(self, X: torch.Tensor,
                         xi: torch.Tensor) -> torch.Tensor:
        """(G, n, d): :meth:`stoch_grad` at each row of X."""
        return self._lane_grads(X, xi)

    def stoch_grad_pair_lanes(self, X_new: torch.Tensor, X_old: torch.Tensor,
                              xi: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`stoch_grad_pair` for each lane's two iterates."""
        return self._lane_grads(X_new, xi), self._lane_grads(X_old, xi)

    def true_grad_lanes(self, X: torch.Tensor) -> torch.Tensor:
        """(G, d): ``true_grad`` at each row of X."""
        return vmap(self.true_grad)(X)


def _lanes_inside(node_grad, X: torch.Tensor, *per_node) -> torch.Tensor:
    """``node_grad(x, *node_args)`` for every node (the outer vmap, over
    the leading axis of ``per_node``) and every row of X (the inner vmap),
    as a contiguous (G, n, d)."""
    inner = vmap(node_grad, in_dims=(0,) + (None,) * len(per_node))
    outer = vmap(inner, in_dims=(None,) + (0,) * len(per_node), out_dims=1)
    return outer(X, *per_node).contiguous()
