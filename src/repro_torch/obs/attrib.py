"""Straggler attribution — Layer 3 of ``repro_torch.obs`` (port of
``repro.obs.attrib``, DESIGN.md §17).

The paper's no-synchronization claim is an aggregate (wall-clock vs
severity curves in BENCH_fed.json); this module makes it inspectable
PER CLIENT: who sat on the critical path of each barrier, how long
everyone else waited for them, and how the blame splits between sync
(coin) rounds and compressed rounds.  MARINA's signature shows up
immediately — its coin rounds put the single slowest of ALL n clients
on the critical path, while DASHA's rounds only ever blame a
participant — which is exactly the per-client view of why its
degradation curve grows faster.

Everything derives from a :class:`~repro_torch.obs.timeline.Timeline`'s
events (client ``up`` spans end at the landing; the server round span
ends at the barrier), so heap campaigns and reconstructed vectorized
campaigns attribute identically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import numpy as np

from repro_torch.obs.timeline import SERVER, Timeline


@dataclasses.dataclass
class ClientStats:
    """Per-client attribution over one campaign."""

    client: int
    rounds: int = 0                 # rounds participated (sent an upload)
    blamed: int = 0                 # rounds where this client landed LAST
    blamed_sync: int = 0            # ... of which were coin/sync barriers
    wait_s: float = 0.0             # total time spent waiting at barriers
    blame_s: float = 0.0            # total time the round waited on THIS
    #                                 client past the runner-up's landing
    waits: List[float] = dataclasses.field(default_factory=list)

    @property
    def blame_frac(self) -> float:
        return self.blamed / self.rounds if self.rounds else 0.0

    def wait_quantiles(self) -> Dict[str, float]:
        if not self.waits:
            return {"p50": 0.0, "p95": 0.0}
        w = np.asarray(self.waits)
        return {"p50": float(np.quantile(w, 0.5)),
                "p95": float(np.quantile(w, 0.95))}


@dataclasses.dataclass
class Attribution:
    """Campaign-level blame decomposition (see :func:`attribute`)."""

    clients: Dict[int, ClientStats]
    rounds: int
    sync_rounds: int
    barrier_s: float                # sum over rounds of (completion-bcast)
    critical_path: List[int]        # blamed client per round (-1 = empty)

    def top_blamed(self, k: int = 10) -> List[ClientStats]:
        return sorted(self.clients.values(),
                      key=lambda c: (-c.blamed, -c.blame_s))[:k]


def attribute(tl: Timeline) -> Attribution:
    """Decompose a campaign timeline into per-client barrier blame.

    Per round: landings are the END times of the client ``up`` spans;
    the barrier completes at the server round span's end.  The blamed
    client is the last landing; its ``blame_s`` for the round is the gap
    to the runner-up's landing (what the round would have saved without
    it); every other participant's ``wait_s`` grows by (completion -
    its own landing)."""
    landings: Dict[int, Dict[int, float]] = {}       # round -> client -> t
    server: Dict[int, tuple] = {}                    # round -> (t1, coin)
    for ev in tl.events:
        a = ev.args or {}
        if "round" not in a or ev.kind != "span":
            continue
        t = int(a["round"])
        if ev.track.startswith("client/") and ev.name == "up":
            landings.setdefault(t, {})[int(ev.track.split("/", 1)[1])] = \
                ev.t1
        elif ev.track == SERVER:
            server[t] = (ev.t0, ev.t1, bool(a.get("coin", False)))
    clients: Dict[int, ClientStats] = {}
    critical: List[int] = []
    sync_rounds = 0
    barrier_s = 0.0
    for t in sorted(server):
        t0, t1, coin = server[t]
        sync_rounds += int(coin)
        barrier_s += t1 - t0
        lands = landings.get(t, {})
        if not lands:
            critical.append(-1)
            continue
        order = sorted(lands.items(), key=lambda kv: kv[1])
        blamed_i, blamed_t = order[-1]
        critical.append(blamed_i)
        runner_up = order[-2][1] if len(order) > 1 else t0
        for i, land in lands.items():
            c = clients.setdefault(i, ClientStats(i))
            c.rounds += 1
            wait = max(t1 - land, 0.0)
            c.wait_s += wait
            c.waits.append(wait)
        b = clients[blamed_i]
        b.blamed += 1
        b.blamed_sync += int(coin)
        b.blame_s += max(blamed_t - runner_up, 0.0)
    return Attribution(clients=clients, rounds=len(server),
                       sync_rounds=sync_rounds, barrier_s=barrier_s,
                       critical_path=critical)


def report(timelines: Mapping[str, Timeline], *, top: int = 10,
           path: Optional[str] = None) -> str:
    """Markdown straggler report over one or more labeled campaigns
    (label -> timeline; e.g. ``{"dasha": tl_d, "marina": tl_m}`` or one
    entry per link-model severity).  Renders, per campaign, the summary
    line plus a per-client table of the ``top`` most-blamed clients.
    Pass ``path`` to also write the file."""
    lines: List[str] = ["# Straggler attribution", ""]
    for label, tl in timelines.items():
        at = attribute(tl)
        lines += [
            f"## {label}",
            "",
            f"- rounds: {at.rounds} ({at.sync_rounds} sync barriers)",
            f"- total barrier time: {at.barrier_s:.3f} s",
            f"- distinct critical-path clients: "
            f"{len(set(c for c in at.critical_path if c >= 0))}",
            "",
            "| client | rounds | blamed | blame% | blamed@sync "
            "| blame s | wait s | wait p50 | wait p95 |",
            "|---:|---:|---:|---:|---:|---:|---:|---:|---:|",
        ]
        for c in at.top_blamed(top):
            q = c.wait_quantiles()
            lines.append(
                f"| {c.client} | {c.rounds} | {c.blamed} "
                f"| {100 * c.blame_frac:.1f} | {c.blamed_sync} "
                f"| {c.blame_s:.3f} | {c.wait_s:.3f} "
                f"| {q['p50']:.4f} | {q['p95']:.4f} |")
        lines.append("")
    out = "\n".join(lines)
    if path is not None:
        with open(path, "w") as f:
            f.write(out)
    return out
