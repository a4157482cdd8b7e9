"""Runtime build sentinels — Layer 3 of ``repro_torch.analysis`` (port of
``repro.analysis.recompile``).

Eager torch compiles nothing at run time; the port's only compiler is
``nvcc``, run by :mod:`repro_torch.kernels.build` the first time a kernel
library is needed (or by ``build_all``).  So the reference's two counters
become:

* :func:`watch` — a region counter over the build events that
  ``kernels.build`` reports to its :func:`~repro_torch.kernels.build.
  subscribe` listeners, one per library actually compiled (an up-to-date
  library reports nothing).  The steady-state invariant the benches and
  ``chip_smoke.py`` assert is ``count == 0``: a warmed campaign builds
  nothing (the reference's "compiles nothing").
* :func:`wrap` — a :class:`CallSentinel` around a Python callable.  The
  reference's wrapper counts jit *lowerings* (jit calls the Python
  function only while tracing); eager torch calls it every time, so the
  port's sentinel counts calls, and :meth:`CallSentinel.assert_calls`
  pins how many a region made (a per-gamma rebuild of a step that should
  have been built once shows as an extra call of its factory).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Iterator, Tuple

from repro_torch.kernels import build as _build

#: observers of build events, ``fn(name, seconds)``: ``kernels.build``'s own
subscribe = _build.subscribe
unsubscribe = _build.unsubscribe


@dataclasses.dataclass
class BuildRegion:
    """Mutable record yielded by :func:`watch`; ``count`` and ``builds``
    are final once the with-block exits."""

    label: str
    count: int = 0
    builds: Tuple[str, ...] = ()

    def snapshot(self) -> int:
        """Builds so far inside the region (usable mid-block)."""
        return len(self.builds)


@contextlib.contextmanager
def watch(label: str = "region") -> Iterator[BuildRegion]:
    """Count kernel builds inside the block::

        with recompile.watch("steady state") as region:
            sim.run(...)          # second, warmed run
        recompile.assert_no_builds(region)
    """
    region = BuildRegion(label)

    def listener(name: str, seconds: float) -> None:
        region.builds += (name,)

    subscribe(listener)
    try:
        yield region
    finally:
        unsubscribe(listener)
        region.count = len(region.builds)


def assert_no_builds(region: BuildRegion) -> None:
    if region.count != 0:
        raise AssertionError(
            f"build sentinel: region {region.label!r} built "
            f"{region.count} kernel librar(y/ies) {list(region.builds)}; "
            "expected a warm cache")


class CallSentinel:
    """Counts calls of the wrapped Python callable (the reference's
    ``LoweringSentinel``, which counts jit traces: eager torch has no
    lowering, so every call counts)."""

    def __init__(self, fn: Callable, name: str = ""):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "<fn>")
        self.calls = 0

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        self.calls += 1
        return self._fn(*args, **kwargs)

    def assert_calls(self, expected: int) -> None:
        if self.calls != expected:
            raise AssertionError(
                f"call sentinel {self.name!r}: {self.calls} calls, "
                f"expected {expected}")

    def __repr__(self) -> str:
        return f"CallSentinel({self.name!r}, calls={self.calls})"


def wrap(fn: Callable, name: str = "") -> CallSentinel:
    return CallSentinel(fn, name)
