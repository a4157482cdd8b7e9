"""repro_torch.obs — campaign telemetry (port of ``repro.obs``, DESIGN.md
§17).

Four layers, all on the host (observability never touches the device:
attaching it launches no kernel, builds none and adds no device
synchronization):

* :mod:`~repro_torch.obs.timeline` — event timelines: per-client message
  lifetimes, round/coin barriers, cohort draws, chunk and slab spans,
  kernel builds; exported as Perfetto/Chrome-trace JSON.
* :mod:`~repro_torch.obs.metrics` — typed counters/gauges/histograms with
  pluggable sinks (in-memory, JSONL; the JSONL line schema is the
  reference's, stable for external tooling).
* :mod:`~repro_torch.obs.attrib` — per-client straggler attribution:
  barrier blame decomposition + markdown report.
* :mod:`~repro_torch.obs.vecreplay` — post-hoc timeline reconstruction
  for :class:`repro_torch.fed.vecsim.VecFedSim` campaigns, event for
  event equal to the heap oracle's live recording.

Entry point: build an :class:`Obs` handle and pass it as ``obs=`` to
``FedSim.run`` / ``VecFedSim.run`` / ``simulate`` / ``Driver.run`` /
``Sweeper.run``.
"""
from .attrib import Attribution, ClientStats, attribute, report
from .handle import NULL, Obs, maybe
from .metrics import (Counter, Gauge, Histogram, JsonlSink, MemorySink,
                      MetricsRegistry, read_jsonl)
from .timeline import (COMPILER, HOST, SERVER, Timeline, TimelineEvent,
                       client_track, merge, record_fed_round)
from .vecreplay import reconstruct_vec_timeline

__all__ = [
    "Attribution", "ClientStats", "attribute", "report",
    "NULL", "Obs", "maybe",
    "Counter", "Gauge", "Histogram", "JsonlSink", "MemorySink",
    "MetricsRegistry", "read_jsonl",
    "COMPILER", "HOST", "SERVER", "Timeline", "TimelineEvent",
    "client_track", "merge", "record_fed_round",
    "reconstruct_vec_timeline",
]
