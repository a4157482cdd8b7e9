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

A sampled-client round's cohort (DESIGN.md §13) is a host-side numpy draw
from ``(seed, t, "cohort")``: :func:`cohort_schedule` reads the same
stream for a run of rounds, so a schedule computed ahead of a chunk and
the cohort a round draws for itself agree by construction.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
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
      compression masks, as a tree shaped like the parameters;
    * ``cohort``       — a sampled-client round's (C,) global client ids,
      in cohort-slot order.  On a sampled round ``plan`` is the cohort's
      plan before the n/C unbiasedness scale, and ``samples`` are the
      cohort rows' samples.

    A field left None is drawn from the round's own generators.
    """

    plan: Any = None
    page_coin: Optional[bool] = None
    samples: Any = None
    sync_coin: Optional[bool] = None
    sync_samples: Any = None
    masks: Any = None
    cohort: Any = None


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
        self._cohort = None

    def samples(self, problem, batch: int, tag: str = "h"):
        field = _SAMPLE_FIELD.get(tag)
        injected = None if field is None else getattr(self.draws, field)
        if injected is not None:
            return problem.as_samples(injected)
        gen = generator(problem.device, self.seed, self.t, "samples", tag)
        return problem.draw_samples(gen, batch)

    def client_samples(self, problem, batch: int, clients: np.ndarray,
                       tag: str = "h"):
        """Samples of a stochastic problem for the given clients only, each
        client's drawn from its own generator seeded by ``(seed, t,
        "samples", tag, client)``: a client's noise depends on its id and
        the round, never on which cohort slot it holds."""
        field = _SAMPLE_FIELD.get(tag)
        injected = None if field is None else getattr(self.draws, field)
        if injected is not None:
            return problem.as_samples(injected)
        return torch.stack([
            problem.sample(generator(problem.device, self.seed, self.t,
                                     "samples", tag, int(i)), int(i), batch)
            for i in clients])

    def cohort(self, n: int, c: int) -> np.ndarray:
        """The round's (c,) cohort of global client ids without
        replacement: the injected one, else :func:`draw_cohort`."""
        if self._cohort is None:
            injected = self.draws.cohort
            self._cohort = draw_cohort(self.seed, self.t, n, c) \
                if injected is None else np.asarray(
                    injected.cpu() if isinstance(injected, torch.Tensor)
                    else injected).astype(np.int64)
        return self._cohort

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


def draw_cohort(seed: int, t: int, n: int, c: int) -> np.ndarray:
    """Round ``t``'s uniform c-of-n cohort, (c,) int64 in random slot
    order, from a numpy generator seeded by ``(seed, t, "cohort")``."""
    rng = np.random.default_rng(derive_seed(seed, t, "cohort"))
    return rng.choice(n, size=c, replace=False).astype(np.int64)


def cohort_schedule(seed: int, t0: int, length: int, n: int, c: int,
                    draws: Optional[Callable[[int], Optional[Draws]]] = None
                    ) -> np.ndarray:
    """The cohorts of rounds ``t0 .. t0 + length - 1``, (length, c) int32:
    what each round's :meth:`RoundRandom.cohort` gives, with ``draws(t)``'s
    injected cohort where it has one."""
    out = np.empty((int(length), int(c)), np.int32)
    for j in range(int(length)):
        t = int(t0) + j
        out[j] = RoundRandom(seed, t, None if draws is None
                             else draws(t)).cohort(n, c)
    return out
