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

``sweep(method_fn, values, state, rounds, ...)`` runs G hyperparameter
values side by side as one run of G lanes (the Appendix-A powers-of-two
stepsize tunes; :class:`Sweeper`).

``obs=`` (a :class:`repro_torch.obs.Obs`) records each chunk as a HOST
span and in the ``driver.chunk_s`` histogram, closed once the chunk's
traces are on the host, and the run's rounds in ``driver.rounds``: host
work between chunks, no launch and no device synchronization of its own.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.rng import derive_seed
from repro_torch.methods.lanes import as_lanes
from repro_torch.obs.handle import maybe as _obs_scope, record_chunk

MetricFn = Callable[[Any, Any], torch.Tensor]     # (state, data) -> scalar

#: default chunk length: how many rounds' traces leave the device at once
DEFAULT_CHUNK = 128


def _resolve_step(method) -> Callable:
    return method.step if hasattr(method, "step") else method


def _to_host(values) -> np.ndarray:
    return torch.stack(values).cpu().numpy()


def _obs_driver_done(h, rounds: int) -> None:
    c = h.counter("driver.rounds")
    if c is not None:
        c.inc(int(rounds))


def _round_index(state, i: int) -> int:
    """The global round index: ``state.t`` when the state carries one (it
    survives a resume), else the driver's own per-run counter ``i``."""
    t = getattr(state, "t", None)
    return i if t is None else int(t)


class Driver:
    """Reusable runner for one (method, data, metrics) configuration."""

    #: rounds a round bills to the ``driver.rounds`` counter (a sweep's G)
    lanes = 1

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

    def _metric(self, fn: MetricFn, state, d):
        return fn(state, d)

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
                    last[name] = self._metric(fn, state, d)
                elif name not in last:
                    last[name] = torch.zeros_like(self._metric(fn, state, d))
                vals[name].append(last[name])
            if hasattr(state, "bits_sent"):
                bits.append(state.bits_sent)
        traces = {name: _to_host(v) for name, v in vals.items()}
        if bits:
            traces["bits_sent"] = np.asarray(bits, dtype=np.float32)
        return traces

    def run(self, state, rounds: int, *, data_seed: Optional[int] = None,
            checkpoint: Optional[Callable] = None,
            checkpoint_every: int = 1, obs=None):
        """Drive ``rounds`` rounds; returns ``(final_state, traces)`` with
        ``traces`` a dict of length-``rounds`` numpy arrays (the named
        metrics plus ``bits_sent`` when the state carries it).

        ``checkpoint(state, rounds_done, chunk_traces)`` fires after every
        ``checkpoint_every``-th chunk and after the final one.  ``obs`` is
        an optional :class:`repro_torch.obs.Obs` handle: per-chunk
        HOST-track wall spans, kernel-build spans and ``driver.*``
        metrics, recorded between chunks."""
        if self.data_fn is not None and data_seed is None:
            raise ValueError("data_fn requires an explicit data_seed")
        chunk = self.chunk or min(max(rounds, 1), DEFAULT_CHUNK)
        last: Dict[str, torch.Tensor] = {}
        done, n_chunk, parts = 0, 0, []
        # hold no reference of our own to the initial state: a caller that
        # passes it as a temporary lets it go after the first round
        box = [state]
        del state
        with _obs_scope(obs) as h:
            while done < rounds:
                length = min(chunk, rounds - done)
                t0 = time.perf_counter() if h else 0.0
                # the chunk's traces are on the host when it returns
                tr = self._run_chunk(box, done, length, data_seed, last)
                done += length
                n_chunk += 1
                parts.append(tr)
                if h:
                    record_chunk(h, t0, done - length, length,
                                 "driver.chunk_s")
                if checkpoint is not None and \
                        (done >= rounds or n_chunk % checkpoint_every == 0):
                    checkpoint(box[0], done, tr)
            if h and rounds > 0:
                _obs_driver_done(h, rounds * self.lanes)
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
            v = torch.as_tensor(self._metric(fn, state, d)).cpu().numpy()
            traces[name] = np.zeros((0,) + v.shape, v.dtype)
        if hasattr(state, "bits_sent"):
            traces["bits_sent"] = np.zeros(
                (0,) + np.shape(state.bits_sent), np.float32)
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


# ---------------------------------------------------------------------------
# hyperparameter sweeps (Appendix A stepsize tunes)
# ---------------------------------------------------------------------------

def _lane_map(state, tensor_fn, array_fn):
    """``state`` with ``tensor_fn`` applied to its tensor leaves and
    ``array_fn`` to its numpy leaves; other leaves (a round seed, the round
    index ``t``: every lane shares them) are kept."""
    if isinstance(state, torch.Tensor):
        return tensor_fn(state)
    if isinstance(state, (np.ndarray, np.generic)):
        return array_fn(state)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_lane_map(v, tensor_fn, array_fn)
                             for v in state))
    if isinstance(state, (tuple, list)):
        return type(state)(_lane_map(v, tensor_fn, array_fn) for v in state)
    if isinstance(state, dict):
        return {k: _lane_map(v, tensor_fn, array_fn)
                for k, v in state.items()}
    return state


def _broadcast_lanes(state, lanes: int, device):
    """One state as the start of G lanes on ``device``: every tensor and
    numpy leaf gets a leading (G,) axis holding G copies (the paper's
    tuning protocol: every lane starts from the same iterate and seed)."""
    return _lane_map(
        state,
        lambda t: t.to(device).expand((lanes,) + tuple(t.shape)).clone(),
        lambda a: np.repeat(np.asarray(a)[None], lanes, axis=0))


def _lane_state(state, j: int):
    """Lane ``j`` of a lane state, as the state of a one-lane run."""
    return _lane_map(state, lambda t: t[j], lambda a: a[j])


class _LaneDriver(Driver):
    """The :class:`Driver` loop over a lane state: each metric is evaluated
    through its lane form (:func:`repro_torch.methods.lanes.lane_metric`)
    where it has one, else lane by lane, and traces gain a lane axis."""

    def __init__(self, step, lanes: int, **kw):
        super().__init__(step, **kw)
        self.lanes = lanes

    def _metric(self, fn: MetricFn, state, d):
        lanes_fn = getattr(fn, "lanes", None)
        if lanes_fn is not None:
            return lanes_fn(state, d)
        return torch.stack([torch.as_tensor(fn(_lane_state(state, j), d))
                            for j in range(self.lanes)])


class Sweeper:
    """Runner of one hyperparameter sweep configuration (port of the
    reference's ``Sweeper``; no ``donate`` or ``host_traces``).

    ``method_fn(values) -> Method`` (or a bare lane step) is called once a
    run with the G values as :class:`repro_torch.methods.lanes.Lanes` (a
    dict of them for a dict of value axes), where a one-lane method takes
    a Python float: a Hyper field that holds them builds a method of G
    lanes (:meth:`repro_torch.methods.Method.build`).  The values may only
    enter arithmetic (a stepsize, a momentum b), never control flow or a
    shape: ``p``, ``batch`` and ``batch_sync`` raise ValueError, as does
    ``a`` on the fused backend.

    The G lanes run as one state with a leading lane axis: one oracle pass
    over the features serves every lane, one compression plan a round is
    shared by every lane, and the fused backend's kernel runs once a round
    on all G * n rows.  Lane j is a sequential :class:`Driver` run at
    ``values[j]``: the same samples, plan, coins and ``bits_sent``, and
    the same floats up to the summation order of a matrix product against
    a matrix-vector product.

    Metrics are functions of one lane's state, as a :class:`Driver`'s; one
    with a lane form (:func:`repro_torch.methods.lanes.lane_metric`) is
    evaluated for all lanes at once, any other lane by lane.
    ``metric_every`` and ``chunk`` keep the :class:`Driver`'s meaning, and
    chunking stays invisible.
    """

    def __init__(self, method_fn, *, data_fn=None, data=None,
                 metrics: Optional[Dict[str, MetricFn]] = None,
                 metric_every: int = 1, chunk: Optional[int] = None):
        if data_fn is not None and data is not None:
            raise ValueError("pass data_fn (per round) OR data (static), "
                             "not both")
        if metric_every < 1:
            raise ValueError(f"metric_every must be >= 1, got "
                             f"{metric_every}")
        self.method_fn = method_fn
        self.data_fn = data_fn
        self.data = data
        self.metrics = dict(metrics or {})
        self.metric_every = int(metric_every)
        self.chunk = chunk

    def run(self, values, state, rounds: int, *,
            data_seed: Optional[int] = None, device=DEFAULT_DEVICE,
            obs=None):
        """Run ``rounds`` rounds of every lane from ``state`` (one state,
        broadcast to the G lanes); returns ``(final_states, traces)`` with
        a leading (G,) axis on every tensor leaf and ``bits_sent``, and
        (G, rounds) traces.  The lanes' state is made on ``device``
        (default the card; raises without one).  ``obs`` as in
        :meth:`Driver.run` (the ``driver.rounds`` counter bills rounds x
        lanes)."""
        dev = resolve_device(device)
        lanes, G = as_lanes(values)
        step = _resolve_step(self.method_fn(lanes))
        drv = _LaneDriver(step, G, data_fn=self.data_fn, data=self.data,
                          metrics=self.metrics,
                          metric_every=self.metric_every, chunk=self.chunk)
        final, traces = drv.run(_broadcast_lanes(state, G, dev), rounds,
                                data_seed=data_seed, obs=obs)
        return final, {k: np.moveaxis(v, 0, 1) for k, v in traces.items()}


def sweep(method_fn, values, state, rounds: int, *, data_fn=None, data=None,
          data_seed=None, metrics: Optional[Dict[str, MetricFn]] = None,
          metric_every: int = 1, chunk: Optional[int] = None,
          device=DEFAULT_DEVICE):
    """One-shot convenience over :class:`Sweeper` (see its docs): lane j
    of the result is a sequential run at ``values[j]``."""
    sw = Sweeper(method_fn, data_fn=data_fn, data=data, metrics=metrics,
                 metric_every=metric_every, chunk=chunk)
    return sw.run(values, state, rounds, data_seed=data_seed, device=device)
