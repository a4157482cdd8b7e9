"""Typed metrics — Layer 2 of ``repro_torch.obs`` (port of
``repro.obs.metrics``, DESIGN.md §17).

A :class:`MetricsRegistry` holds named :class:`Counter` / :class:`Gauge`
/ :class:`Histogram` instruments and flushes snapshots to pluggable
sinks.  Everything is host-side Python on post-processed chunk outputs —
attaching a registry to a simulator or driver changes nothing the device
runs, so it can neither launch or build a kernel nor perturb a random
stream.

The JSONL sink's line schema is STABLE for external tooling (dashboards,
regression scripts) — one JSON object per line::

    {"seq": 3, "wall_s": 1.25, "name": "fed.bytes_up",
     "kind": "counter", "value": 81920.0, "labels": {"engine": "vec"}}

Histogram lines replace ``value`` with ``{"count", "sum", "min", "max",
"buckets"}`` where ``buckets`` maps the power-of-two upper bound of each
occupied bucket (as a string key, ``"inf"`` for the overflow bucket) to
its count.  ``seq`` is the flush ordinal; every flush re-emits the full
current value of every instrument (cumulative, not deltas), so a reader
may keep only the last line per name.
"""
from __future__ import annotations

import json
import math
import time
from typing import Any, Dict, List, Optional

#: instrument kinds the schema admits
KINDS = ("counter", "gauge", "histogram")


class Counter:
    """Monotone cumulative count; ``inc`` rejects negative deltas."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, delta: float = 1.0) -> None:
        if delta < 0:
            raise ValueError(f"counter {self.name!r}: negative increment "
                             f"{delta!r} (use a gauge)")
        self.value += float(delta)

    def snapshot(self) -> Dict[str, Any]:
        return {"value": self.value}


class Gauge:
    """Last-set value (e.g. final wall clock, current queue depth)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = math.nan

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> Dict[str, Any]:
        return {"value": self.value}


class Histogram:
    """Power-of-two-bucketed distribution with exact count/sum/min/max.

    Buckets are ``(2^(i-1), 2^i]`` around 1.0 (seconds, bytes — any
    positive unit); zero and negative observations land in the ``"0"``
    bucket.  O(1) memory, enough resolution for wait-time and
    chunk-duration distributions."""

    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[str, int] = {}

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if v <= 0:
            key = "0"
        elif math.isinf(v):
            key = "inf"
        else:
            key = repr(2.0 ** math.ceil(math.log2(v)))
        self.buckets[key] = self.buckets.get(key, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": dict(self.buckets)}


class MemorySink:
    """In-memory sink: flushed records append to ``.records``."""

    def write(self, record: Dict[str, Any]) -> None:
        if not hasattr(self, "records"):
            self.records: List[Dict[str, Any]] = []
        self.records.append(record)

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-only JSONL file sink (schema above; stable)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f = open(self.path, "a")

    def write(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(record, allow_nan=False,
                                 default=_jsonable) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(x):
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL sink file back into records (the round-trip the CI
    observability job checks)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class MetricsRegistry:
    """Get-or-create instrument registry + sink fan-out.

    ``labels`` attach to every flushed record (engine name, n, variant —
    whatever identifies the campaign).  Instruments are keyed by name;
    asking for an existing name with a different kind raises."""

    def __init__(self, *sinks, labels: Optional[Dict[str, Any]] = None):
        self.sinks = list(sinks) or [MemorySink()]
        self.labels = dict(labels or {})
        self._metrics: Dict[str, Any] = {}
        self._seq = 0
        self._t0 = time.perf_counter()

    def _get(self, cls, name: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(Gauge, name)

    def histogram(self, name: str) -> Histogram:
        return self._get(Histogram, name)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {name: dict(kind=m.kind, **m.snapshot())
                for name, m in sorted(self._metrics.items())}

    def flush(self) -> int:
        """Emit every instrument's current value to every sink; returns
        the flush's ``seq``.  NaN-valued gauges (never set) flush as
        null values rather than being dropped."""
        seq = self._seq
        self._seq += 1
        wall = time.perf_counter() - self._t0
        for name, m in sorted(self._metrics.items()):
            rec: Dict[str, Any] = {"seq": seq, "wall_s": round(wall, 6),
                                   "name": name, "kind": m.kind}
            snap = m.snapshot()
            if m.kind in ("counter", "gauge"):
                v = snap["value"]
                rec["value"] = None if isinstance(v, float) \
                    and math.isnan(v) else v
            else:
                rec.update(snap)
            if self.labels:
                rec["labels"] = self.labels
            for sink in self.sinks:
                sink.write(rec)
        return seq

    def close(self) -> None:
        self.flush()
        for sink in self.sinks:
            sink.close()
