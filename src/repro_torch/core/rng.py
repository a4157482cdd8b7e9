"""Stateless per-round randomness.

The reference threads a JAX key through its state and splits it every
round (``key, k_h, k_c, k_coin = split(state.key, 4)``).  The port keeps an
integer ``seed`` in its state instead, and every draw gets its own
``torch.Generator`` seeded from ``(seed, t, tag)``.  A round's randomness
then depends only on the seed and the global round index, so chunking and
resume never change a run (DESIGN.md §7).

Torch's Philox streams cannot replay JAX's threefry, so every draw of a
round can also be injected (:class:`Draws`): the parity tests draw the
arrays with the reference and hand them over.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import tree


def derive_seed(*parts) -> int:
    """A 63-bit seed from a tuple of ints and strings (stable across
    processes and platforms)."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        if isinstance(p, str):
            h.update(b"s" + p.encode())
        else:
            h.update(b"i" + str(int(p)).encode())
        h.update(b"\0")
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def generator(device, *parts) -> torch.Generator:
    """A fresh generator on ``device`` seeded from ``parts``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(derive_seed(*parts))
    return g


class Draws(NamedTuple):
    """Injected randomness for one round of ``Method.step_full``.

    * ``plan``         — the compression plan (a ``repro_torch`` Plan);
    * ``page_coin``    — PAGE's full-reset coin;
    * ``samples``      — the h-update's samples: (n, B) indices for a
      finite-sum problem, (n, B, ...) xi for a stochastic one;
    * ``sync_coin``    — the sync-round coin (sync_mvr / marina);
    * ``sync_samples`` — the sync megabatch's xi (stochastic problems);
    * ``masks``        — the tree path's per-leaf (n, *shape) float32 {0,1}
      compression masks, as a tree shaped like the parameters.

    A field left None is drawn from the round's own generators.
    """

    plan: Any = None
    page_coin: Optional[bool] = None
    samples: Any = None
    sync_coin: Optional[bool] = None
    sync_samples: Any = None
    masks: Any = None


_SAMPLE_FIELD = {"h": "samples", "sync": "sync_samples"}
_COIN_FIELD = {"page": "page_coin", "sync": "sync_coin"}


class RoundRandom:
    """Every draw of one round: injected where :class:`Draws` holds it,
    else from a generator seeded by ``(seed, t, tag)``.  Coins are drawn on
    the host, so branching on them never waits for the device."""

    def __init__(self, seed: int, t: int, draws: Optional[Draws] = None):
        self.seed = int(seed)
        self.t = int(t)
        self.draws = draws or Draws()
        self._plan = None

    def samples(self, problem, batch: int, tag: str = "h"):
        field = _SAMPLE_FIELD.get(tag)
        injected = None if field is None else getattr(self.draws, field)
        if injected is not None:
            return problem.as_samples(injected)
        gen = generator(problem.device, self.seed, self.t, "samples", tag)
        return problem.draw_samples(gen, batch)

    def coin(self, p: float, tag: str) -> bool:
        injected = getattr(self.draws, _COIN_FIELD[tag])
        if injected is not None:
            return bool(injected)
        gen = generator("cpu", self.seed, self.t, "coin", tag)
        return bool(torch.rand((), generator=gen) < p)

    def leaf_mask(self, path: str, gen_device,
                  draw: Callable[[torch.Generator], torch.Tensor]
                  ) -> torch.Tensor:
        """The compression mask of the parameter leaf at ``path``: the
        injected one, else ``draw`` of a generator on ``gen_device`` seeded
        by ``(seed, t, "mask", path)``."""
        if self.draws.masks is not None:
            return tree.get(self.draws.masks, path)
        return draw(generator(gen_device, self.seed, self.t, "mask", path))

    def plan(self, rc):
        """The round's compression plan, drawn once and shared by every
        consumer of the round."""
        if self._plan is None:
            self._plan = self.draws.plan if self.draws.plan is not None \
                else rc.plan(derive_seed(self.seed, self.t, "compress"))
        return self._plan
