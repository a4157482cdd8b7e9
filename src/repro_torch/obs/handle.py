"""The nullable observability handle (port of ``repro.obs.handle``,
DESIGN.md §17).

Every run loop of the port accepts ``obs=None``: an :class:`Obs` bundles
an optional :class:`~repro_torch.obs.timeline.Timeline` and an optional
:class:`~repro_torch.obs.metrics.MetricsRegistry`, and the loops guard
every recording with ``if obs``, so disabled observability is one falsy
check per chunk.  Enabled, the handle records on the host from values the
loops already hold there: it launches no kernel, builds none and adds no
device synchronization (``tests/test_torch_obs.py`` holds the runs with
and without a handle bit for bit; ``chip_smoke.py`` phase 17 holds the
overhead under 3% of the wall clock and the launch counts equal).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, Optional

from repro_torch.kernels import build
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, JsonlSink,
                                     MetricsRegistry)
from repro_torch.obs.timeline import COMPILER, HOST, Timeline


@dataclasses.dataclass
class Obs:
    """Observability handle: ``timeline`` and/or ``metrics``, either may
    be None.  Falsy when both are None, so run loops can guard with a
    bare ``if obs:``."""

    timeline: Optional[Timeline] = None
    metrics: Optional[MetricsRegistry] = None

    def __bool__(self) -> bool:
        return self.timeline is not None or self.metrics is not None

    # -- constructors -----------------------------------------------------

    @classmethod
    def full(cls, label: str = "campaign",
             labels: Optional[Dict[str, Any]] = None) -> "Obs":
        """Timeline + in-memory metrics — the interactive default."""
        return cls(timeline=Timeline(label),
                   metrics=MetricsRegistry(labels=labels))

    @classmethod
    def metrics_only(cls, *sinks,
                     labels: Optional[Dict[str, Any]] = None) -> "Obs":
        """Metrics without a timeline — the big-n campaign default (per
        -client timeline events at n = 10^4+ would swamp the host)."""
        return cls(metrics=MetricsRegistry(*sinks, labels=labels))

    @classmethod
    def to_jsonl(cls, path: str,
                 labels: Optional[Dict[str, Any]] = None) -> "Obs":
        return cls.metrics_only(JsonlSink(path), labels=labels)

    # -- guarded instrument access ---------------------------------------

    def counter(self, name: str) -> Optional[Counter]:
        return None if self.metrics is None else self.metrics.counter(name)

    def gauge(self, name: str) -> Optional[Gauge]:
        return None if self.metrics is None else self.metrics.gauge(name)

    def histogram(self, name: str) -> Optional[Histogram]:
        return None if self.metrics is None \
            else self.metrics.histogram(name)

    def flush(self) -> None:
        if self.metrics is not None:
            self.metrics.flush()

    def close(self) -> None:
        if self.metrics is not None:
            self.metrics.close()

    # -- compile capture --------------------------------------------------

    @contextlib.contextmanager
    def compile_spans(self) -> Iterator["Obs"]:
        """Record the kernel builds that happen inside the block onto the
        timeline's ``compiler`` track (a ``backend_compile`` span in wall
        seconds since the timeline epoch, with the source's name and the
        build's seconds) and into a ``compiles`` counter.  The port's
        compiles are its ``nvcc`` builds, reported through
        :func:`repro_torch.kernels.build.subscribe` for each library
        actually built (an up-to-date one reports nothing).  The port uses
        neither ``torch.compile`` nor CUDA graphs, so there is nothing
        else to capture.  A no-op when the handle has no timeline and no
        metrics."""
        if not self:
            yield self
            return
        tl, ctr = self.timeline, self.counter("compiles")

        def on_build(name: str, seconds: float) -> None:
            if ctr is not None:
                ctr.inc()
            if tl is not None:
                end = tl.now()
                tl.span(COMPILER, "backend_compile",
                        max(end - seconds, 0.0), end, kernel=name,
                        duration_s=round(seconds, 6))

        build.subscribe(on_build)
        try:
            yield self
        finally:
            build.unsubscribe(on_build)


#: module-level null handle — ``obs or NULL`` never allocates
NULL = Obs()


@contextlib.contextmanager
def host_span(tl: Optional[Timeline], name: str, **args) -> Iterator[None]:
    """A HOST-track wall span around the block on a live timeline ``tl``
    (None records nothing): the slab store's gather and writeback."""
    if tl is None:
        yield
        return
    t0 = tl.now()
    yield
    tl.span(HOST, name, t0, tl.now(), **args)


def record_chunk(h: Obs, t0: float, start_round: int, length: int,
                 histogram: str) -> None:
    """The run loops' per-chunk host record: a HOST-track wall span from
    ``t0`` (``time.perf_counter()`` at the chunk's start) to now, and the
    chunk's seconds in the ``histogram`` (``driver.chunk_s`` /
    ``vec.chunk_s``).  Callers guard with ``if h``: a disabled handle costs
    one falsy check per chunk."""
    dt = time.perf_counter() - t0
    tl = h.timeline
    if tl is not None:
        end = tl.now()
        tl.span(HOST, "chunk", end - dt, end,
                start_round=int(start_round), rounds=int(length))
    hist = h.histogram(histogram)
    if hist is not None:
        hist.observe(dt)


@contextlib.contextmanager
def maybe(obs: Optional[Obs]) -> Iterator[Obs]:
    """Normalize an ``obs=`` argument: yields a (possibly null) Obs with
    build capture active exactly when the handle is live."""
    h = obs or NULL
    with h.compile_spans():
        yield h
