"""Event timelines — Layer 1 of ``repro_torch.obs`` (port of
``repro.obs.timeline``, DESIGN.md §17).

A :class:`Timeline` is a host-side recorder of what a federated campaign
*did in time*: per-client message lifetimes (broadcast reception ->
local compute -> upload in flight -> landing), server round/coin/sync
barriers, cohort draws, chunk boundaries, slab gather/writeback spans,
and kernel builds reported by :mod:`repro_torch.kernels.build`.  It
never touches the device: every event is appended by the simulators'
host loops (or reconstructed post hoc from the vectorized simulator's
round arrays, :mod:`repro_torch.obs.vecreplay`), on values those loops
already hold on the host, so an attached timeline launches nothing and
builds nothing.

Time bases (one timeline may mix them — each TRACK uses exactly one):

* client / server tracks carry SIMULATED seconds (the sims' clock,
  starting at 0 per campaign);
* host / compiler tracks carry WALL seconds since the timeline's epoch
  (``time.perf_counter()`` at construction) — chunk boundaries and
  compile spans are real time, not modeled time.

Export is Chrome-trace/Perfetto JSON (:meth:`Timeline.to_perfetto`):
one trace-event per span/instant, one ``tid`` per track, thread-name
metadata so ``ui.perfetto.dev`` labels each client — open the file
there and MARINA's all-client coin barriers sit visibly next to
DASHA's participant-only rounds.
"""
from __future__ import annotations

import json
import math
import time
from typing import Any, Dict, Iterable, List, NamedTuple, Optional

import numpy as np

#: canonical track names (clients are ``client/<i>``)
SERVER = "server"
COMPILER = "compiler"
HOST = "host"

#: event kinds the schema admits
KINDS = ("span", "instant", "counter")

#: required fields of one event record (the JSONL/validate schema)
REQUIRED_FIELDS = ("track", "name", "kind", "t0")


class TimelineEvent(NamedTuple):
    """One recorded event.  ``t1`` is None for instants/counters; spans
    carry ``t1 >= t0``.  ``args`` is a small JSON-able dict (byte counts,
    round ids, coin flags) — the reconciliation tests sum these."""

    track: str
    name: str
    kind: str                       # "span" | "instant" | "counter"
    t0: float
    t1: Optional[float] = None
    args: Optional[Dict[str, Any]] = None


def client_track(i: int) -> str:
    return f"client/{int(i)}"


class Timeline:
    """Append-only event recorder with schema validation and Perfetto
    export.  ``label`` names the campaign in the exported trace."""

    def __init__(self, label: str = "campaign"):
        self.label = str(label)
        self.events: List[TimelineEvent] = []
        self.epoch = time.perf_counter()
        self._open: Dict[str, TimelineEvent] = {}   # begin() awaiting end()

    # -- recording --------------------------------------------------------

    def span(self, track: str, name: str, t0: float, t1: float,
             **args) -> None:
        self.events.append(TimelineEvent(track, name, "span", float(t0),
                                         float(t1), args or None))

    def instant(self, track: str, name: str, t: float, **args) -> None:
        self.events.append(TimelineEvent(track, name, "instant", float(t),
                                         None, args or None))

    def counter(self, track: str, name: str, t: float,
                value: float) -> None:
        self.events.append(TimelineEvent(track, name, "counter", float(t),
                                         None, {"value": float(value)}))

    def begin(self, track: str, name: str, t: float, **args) -> None:
        """Open a span on ``track``; one open span per track at a time
        (the chunk-boundary usage).  :meth:`end` closes it."""
        if track in self._open:
            raise ValueError(f"track {track!r} already has an open span "
                             f"({self._open[track].name!r})")
        self._open[track] = TimelineEvent(track, name, "span", float(t),
                                          None, args or None)

    def end(self, track: str, t: float) -> None:
        ev = self._open.pop(track, None)
        if ev is None:
            raise ValueError(f"end() without begin() on track {track!r}")
        self.events.append(ev._replace(t1=float(t)))

    def now(self) -> float:
        """Wall seconds since the timeline epoch (the host/compiler
        tracks' time base)."""
        return time.perf_counter() - self.epoch

    # -- validation -------------------------------------------------------

    def validate(self) -> List[str]:
        """Schema self-check; returns problem strings (empty = valid).

        Rules: required fields present and well-typed, finite
        timestamps, spans have ``t1 >= t0``, every ``begin`` was
        ``end``-ed, and per track the events that carry a ``round`` arg
        appear in non-decreasing round order (the monotone-progress
        invariant both the barrier and the pipelined-async recorders
        satisfy — async wall clocks may interleave across rounds, round
        ids never run backwards on one track)."""
        problems: List[str] = []
        for name in self._open:
            problems.append(f"unclosed begin() on track {name!r}")
        last_round: Dict[str, int] = {}
        for i, ev in enumerate(self.events):
            where = f"event[{i}] ({ev.track}/{ev.name})"
            if not ev.track or not isinstance(ev.track, str):
                problems.append(f"{where}: missing track")
            if not ev.name or not isinstance(ev.name, str):
                problems.append(f"{where}: missing name")
            if ev.kind not in KINDS:
                problems.append(f"{where}: unknown kind {ev.kind!r}")
            if not math.isfinite(ev.t0):
                problems.append(f"{where}: non-finite t0 {ev.t0!r}")
            if ev.kind == "span":
                if ev.t1 is None or not math.isfinite(ev.t1):
                    problems.append(f"{where}: span without finite t1")
                elif ev.t1 < ev.t0:
                    problems.append(f"{where}: span ends before it starts "
                                    f"({ev.t1} < {ev.t0})")
            elif ev.t1 is not None:
                problems.append(f"{where}: {ev.kind} carries a t1")
            rnd = (ev.args or {}).get("round")
            if rnd is not None:
                prev = last_round.get(ev.track)
                if prev is not None and rnd < prev:
                    problems.append(
                        f"{where}: round ran backwards on track "
                        f"{ev.track!r} ({rnd} < {prev})")
                last_round[ev.track] = rnd
        return problems

    def assert_valid(self) -> "Timeline":
        problems = self.validate()
        if problems:
            raise AssertionError(
                "timeline schema violations:\n  " + "\n  ".join(problems))
        return self

    # -- aggregation ------------------------------------------------------

    def tracks(self) -> List[str]:
        seen: Dict[str, None] = {}
        for ev in self.events:
            seen.setdefault(ev.track, None)
        return list(seen)

    def round_byte_sums(self) -> Dict[str, np.ndarray]:
        """Per-round byte totals re-derived from EVENTS alone: uplink =
        the sum of client ``up`` span ``bytes`` args, downlink = the
        server round span's ``bytes_down`` arg (the billed receiver
        count — under Appendix-D participation every client still
        refreshes locally, so billed downlink can exceed the sum of the
        active clients' ``down`` spans).  The reconciliation tests
        compare these against the sims' traced ``bytes_up`` /
        ``bytes_down`` exactly."""
        up: Dict[int, int] = {}
        down: Dict[int, int] = {}
        for ev in self.events:
            a = ev.args or {}
            if "round" not in a:
                continue
            t = int(a["round"])
            if ev.kind == "span" and ev.name == "up" and \
                    ev.track.startswith("client/"):
                up[t] = up.get(t, 0) + int(a.get("bytes", 0))
            if ev.track == SERVER and ev.kind == "span":
                down[t] = int(a.get("bytes_down", 0))
                up.setdefault(t, 0)
        rounds = sorted(set(up) | set(down))
        return {
            "round": np.asarray(rounds, np.int64),
            "bytes_up": np.asarray([up.get(t, 0) for t in rounds],
                                   np.int64),
            "bytes_down": np.asarray([down.get(t, 0) for t in rounds],
                                     np.int64),
        }

    # -- export -----------------------------------------------------------

    def to_perfetto(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome-trace JSON: ``{"traceEvents": [...]}`` with one pid for
        the campaign and one tid per track (server = 0, compiler = 1,
        host = 2, clients = 10 + i), timestamps in microseconds.  Pass
        ``path`` to also write the file — drop it onto ``ui.perfetto.dev``
        (or ``chrome://tracing``) to browse the campaign."""
        self.assert_valid()
        tids: Dict[str, int] = {}

        def tid(track: str) -> int:
            t = tids.get(track)
            if t is None:
                if track == SERVER:
                    t = 0
                elif track == COMPILER:
                    t = 1
                elif track == HOST:
                    t = 2
                elif track.startswith("client/"):
                    t = 10 + int(track.split("/", 1)[1])
                else:
                    t = 1000 + len(tids)
                tids[track] = t
            return t

        out: List[Dict[str, Any]] = []
        for ev in self.events:
            base = {"name": ev.name, "pid": 1, "tid": tid(ev.track),
                    "ts": ev.t0 * 1e6}
            if ev.args:
                base["args"] = ev.args
            if ev.kind == "span":
                base.update(ph="X", dur=(ev.t1 - ev.t0) * 1e6)
            elif ev.kind == "instant":
                base.update(ph="i", s="t")
            else:                                    # counter
                base.update(ph="C",
                            args={"value": (ev.args or {}).get("value", 0)})
            out.append(base)
        out.sort(key=lambda e: e["ts"])
        meta = [{"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": self.label}}]
        for track, t in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": t, "args": {"name": track}})
            meta.append({"name": "thread_sort_index", "ph": "M", "pid": 1,
                         "tid": t, "args": {"sort_index": t}})
        trace = {"traceEvents": meta + out, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace


# ---------------------------------------------------------------------------
# the shared federated-round recorder
# ---------------------------------------------------------------------------

def record_fed_round(tl: Timeline, *, round: int, bcast: float,
                     completion: float, active: np.ndarray,
                     arrivals: np.ndarray, t_down: np.ndarray,
                     t_up: np.ndarray, per_node_bytes: np.ndarray,
                     down_bytes: np.ndarray, compute_s: float,
                     coin: bool, server_down_bytes: int,
                     cohort: Optional[np.ndarray] = None) -> None:
    """Record one federated round onto a timeline — the ONE event shape
    both the heap simulator and the vectorized reconstruction
    (:mod:`repro_torch.obs.vecreplay`) emit, which is what makes their
    timelines comparable event for event.

    Per active client i: a ``down`` span (broadcast in flight to i), a
    ``compute`` span, and an ``up`` span whose END is the landing on the
    server (``arrivals[i]``) and whose ``bytes`` arg is the client's wire
    bytes this round.  The server track gets one barrier span
    (``sync_round`` on a coin round, else ``round``) from broadcast to
    the round's completing arrival, carrying the billed byte totals; a
    sampled round first marks the cohort draw."""
    t = int(round)
    active = np.asarray(active, bool)
    if cohort is not None:
        tl.instant(SERVER, "cohort_draw", bcast, round=t,
                   c=int(len(cohort)))
    idx = np.nonzero(active)[0]
    for i in idx:
        i = int(i)
        arr = float(arrivals[i])
        up_start = arr - float(t_up[i])
        track = client_track(i)
        tl.span(track, "down", bcast, bcast + float(t_down[i]),
                round=t, bytes=int(down_bytes[i]))
        tl.span(track, "compute", up_start - compute_s, up_start, round=t)
        tl.span(track, "up", up_start, arr, round=t,
                bytes=int(per_node_bytes[i]))
    tl.span(SERVER, "sync_round" if coin else "round", bcast, completion,
            round=t, coin=bool(coin), participants=int(active.sum()),
            bytes_up=int(np.asarray(per_node_bytes)[active].sum()),
            bytes_down=int(server_down_bytes))


def merge(timelines: Iterable[Timeline], label: str = "merged") -> Timeline:
    """Concatenate timelines (e.g. a campaign timeline + a compile-only
    one) into a fresh Timeline for joint export."""
    out = Timeline(label)
    for tl in timelines:
        out.events.extend(tl.events)
    return out
