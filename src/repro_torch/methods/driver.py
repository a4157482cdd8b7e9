"""The chunked experiment driver (port of ``repro.methods.driver``,
DESIGN.md §10).

``run(method, state, rounds, ...)`` executes rounds in chunks.  Within a
chunk every metric value stays on the device; the chunk's traces leave it
in one transfer at the chunk's end, so no round waits on an ``.item()``.
Between chunks a checkpoint hook may fire.

Key contracts:

* **Chunking is invisible**: the method's randomness is keyed on the
  global round index ``state.t``, so ``chunk`` only sets how often traces
  leave the device and how often the hook may fire.  A state without a
  ``t`` is indexed by the driver's own per-run counter.
* **Data seeds are stateless**: ``data_fn(seed, t)`` gets
  ``derive_seed(data_seed, t, "data")``, so a resumed run regenerates the
  same data stream as an uninterrupted one.
* ``metric_every = k`` evaluates each metric on rounds whose pre-step
  global index is a multiple of k, and holds the last value in between
  (zeros before the first evaluation of a run).

``method`` may be a :class:`repro_torch.methods.Method` or a bare
``step(state, data) -> state`` callable.  ``bits_sent`` is traced only when
the state carries it (a serving state does not).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.rng import derive_seed

MetricFn = Callable[[Any, Any], torch.Tensor]     # (state, data) -> scalar

#: default chunk length: how many rounds' traces leave the device at once
DEFAULT_CHUNK = 128


def _resolve_step(method) -> Callable:
    return method.step if hasattr(method, "step") else method


def _to_host(values) -> np.ndarray:
    return torch.stack(values).cpu().numpy()


def _round_index(state, i: int) -> int:
    """The global round index: ``state.t`` when the state carries one (it
    survives a resume), else the driver's own per-run counter ``i``."""
    t = getattr(state, "t", None)
    return i if t is None else int(t)


class Driver:
    """Reusable runner for one (method, data, metrics) configuration."""

    def __init__(self, method, *, data_fn=None, data=None,
                 metrics: Optional[Dict[str, MetricFn]] = None,
                 metric_every: int = 1, chunk: Optional[int] = None):
        if data_fn is not None and data is not None:
            raise ValueError("pass data_fn (per round) OR data (static), "
                             "not both")
        if metric_every < 1:
            raise ValueError(f"metric_every must be >= 1, got "
                             f"{metric_every}")
        self.step = _resolve_step(method)
        self.data_fn = data_fn
        self.data = data
        self.metrics = dict(metrics or {})
        self.metric_every = int(metric_every)
        self.chunk = chunk

    def _data(self, data_seed: Optional[int], t: int):
        return self.data if self.data_fn is None else \
            self.data_fn(derive_seed(data_seed, t, "data"), t)

    def _run_chunk(self, box: list, i0: int, length: int,
                   data_seed: Optional[int], last: Dict[str, torch.Tensor]):
        """Advance ``box[0]`` by ``length`` rounds, the first being the
        run's round ``i0``.  The state lives only in ``box``, so a round's
        input state is freed as soon as the next one exists (a trainer's
        state is tens of GB)."""
        vals = {name: [] for name in self.metrics}
        bits = []
        for j in range(length):
            t = _round_index(box[0], i0 + j)
            d = self._data(data_seed, t)
            state = box[0] = self.step(box[0], d)
            for name, fn in self.metrics.items():
                if t % self.metric_every == 0:
                    last[name] = fn(state, d)
                elif name not in last:
                    last[name] = torch.zeros_like(fn(state, d))
                vals[name].append(last[name])
            if hasattr(state, "bits_sent"):
                bits.append(state.bits_sent)
        traces = {name: _to_host(v) for name, v in vals.items()}
        if bits:
            traces["bits_sent"] = np.asarray(bits, dtype=np.float32)
        return traces

    def run(self, state, rounds: int, *, data_seed: Optional[int] = None,
            checkpoint: Optional[Callable] = None,
            checkpoint_every: int = 1):
        """Drive ``rounds`` rounds; returns ``(final_state, traces)`` with
        ``traces`` a dict of length-``rounds`` numpy arrays (the named
        metrics plus ``bits_sent`` when the state carries it).

        ``checkpoint(state, rounds_done, chunk_traces)`` fires after every
        ``checkpoint_every``-th chunk and after the final one."""
        if self.data_fn is not None and data_seed is None:
            raise ValueError("data_fn requires an explicit data_seed")
        chunk = self.chunk or min(max(rounds, 1), DEFAULT_CHUNK)
        last: Dict[str, torch.Tensor] = {}
        done, n_chunk, parts = 0, 0, []
        # hold no reference of our own to the initial state: a caller that
        # passes it as a temporary lets it go after the first round
        box = [state]
        del state
        while done < rounds:
            length = min(chunk, rounds - done)
            tr = self._run_chunk(box, done, length, data_seed, last)
            done += length
            n_chunk += 1
            parts.append(tr)
            if checkpoint is not None and \
                    (done >= rounds or n_chunk % checkpoint_every == 0):
                checkpoint(box[0], done, tr)
        state = box[0]
        if not parts:
            return state, self._empty_traces(state, data_seed)
        return state, {k: np.concatenate([p[k] for p in parts])
                       for k in parts[0]}

    def _empty_traces(self, state, data_seed: Optional[int]):
        """A zero-round run's traces: each metric's ``(0,) + shape`` in its
        dtype, from one evaluation on the initial state (with the data of
        its round), as a run of any length would trace it."""
        d = self._data(data_seed, _round_index(state, 0))
        traces = {}
        for name, fn in self.metrics.items():
            v = torch.as_tensor(fn(state, d)).cpu().numpy()
            traces[name] = np.zeros((0,) + v.shape, v.dtype)
        if hasattr(state, "bits_sent"):
            traces["bits_sent"] = np.zeros((0,), np.float32)
        return traces


def run(method, state, rounds: int, *, data_fn=None, data=None,
        data_seed=None, metrics=None, metric_every: int = 1,
        chunk: Optional[int] = None, checkpoint=None,
        checkpoint_every: int = 1):
    """One-shot convenience over :class:`Driver` (see its docs)."""
    drv = Driver(method, data_fn=data_fn, data=data, metrics=metrics,
                 metric_every=metric_every, chunk=chunk)
    return drv.run(state, rounds, data_seed=data_seed,
                   checkpoint=checkpoint, checkpoint_every=checkpoint_every)
