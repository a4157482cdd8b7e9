"""Observability tour: trace a straggler-prone campaign and see the paper's
no-synchronization claim per client (port of ``examples/obs_trace.py``,
DESIGN.md §17).

    PYTHONPATH=src python -m repro_torch.bench.obs_trace [--device cpu]

Runs MARINA and DASHA over the same 32 clients behind a Pareto-tailed
uplink (common random numbers: both methods face identical straggler
draws) through the heap oracle, with a full
:class:`repro_torch.obs.Obs` handle attached, and writes into the working
directory:

* ``obs_trace_dasha.json`` / ``obs_trace_marina.json`` — Perfetto
  timelines.  Open either at https://ui.perfetto.dev: one lane per
  client plus the server lane.  On MARINA's ``sync_round`` barriers all
  32 clients upload dense vectors and the barrier stretches to the
  slowest of them; DASHA's rounds wait only for its compressed
  participants, so its server lane stays tight.
* ``obs_trace_stragglers.md`` — per-client blame: who sat on each
  barrier's critical path and how long everyone else waited.
* ``obs_trace_metrics.jsonl`` — the campaign counters (rounds, bytes,
  round-duration histogram) in the stable JSONL schema.

``REPRO_EXAMPLE_ROUNDS`` shrinks the run for smoke jobs; ``--device``
defaults to the card.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.compress import make_round_compressor
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.oracles import FiniteSumProblem
from repro_torch.data.pipeline import synthetic_classification
from repro_torch.fed import FedSim, LinkModel, Pareto
from repro_torch.methods import FlatSubstrate, Hyper
from repro_torch.obs import (JsonlSink, MetricsRegistry, Obs, Timeline,
                             attribute, report)

N, M, D, K = 32, 8, 40, 8
SEED = 3
FILES = ("obs_trace_dasha.json", "obs_trace_marina.json",
         "obs_trace_stragglers.md", "obs_trace_metrics.jsonl")


def build(variant: str, device, p_participate: float = 1.0) -> FedSim:
    feats, labels = synthetic_classification(0, N, M, D, device=device)
    prob = FiniteSumProblem(
        loss=lambda x, a, y: (1 - 1 / (1 + torch.exp(y * torch.dot(a, x))))
        ** 2, features=feats, labels=labels)
    rc = make_round_compressor("randk", D, N, k=K, backend="sparse",
                               p_participate=p_participate, device=device)
    L = float(torch.mean(torch.sum(feats ** 2, -1)) * 2)
    hp = Hyper.from_theory(variant, rc.omega, N, L=L, d=D, gamma_mult=4)
    # Pareto-tailed uplink: a few clients are brutally slow some rounds,
    # the regime where waiting on all n (MARINA's coin rounds) hurts most
    uplink = LinkModel(latency_s=1e-3, bandwidth_Bps=1e6,
                       straggler=Pareto(alpha=1.5))
    downlink = LinkModel(latency_s=1e-3, bandwidth_Bps=1e8)
    return FedSim(variant, rc, FlatSubstrate(prob, N, D), hp, uplink=uplink,
                  downlink=downlink, seed=SEED)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rounds = int(os.environ.get("REPRO_EXAMPLE_ROUNDS", "60"))

    timelines, results = {}, {}
    # DASHA takes Appendix-D partial participation (p = 0.6: rounds wait
    # only for the clients whose presence coin landed); MARINA refuses it
    # by construction, since its sync rounds need all n: the contrast the
    # two Perfetto files show lane by lane
    for variant, pp in (("dasha", 0.6), ("marina", 1.0)):
        sim = build(variant, dev, p_participate=pp)
        st = sim.init(torch.zeros(D, device=dev), 1, device=dev)
        obs = Obs(timeline=Timeline(f"{variant} n={N} pareto"),
                  metrics=MetricsRegistry(
                      JsonlSink("obs_trace_metrics.jsonl"),
                      labels={"variant": variant, "n": N}))
        res = sim.run(st, rounds, obs=obs)
        obs.close()
        obs.timeline.to_perfetto(f"obs_trace_{variant}.json")
        timelines[variant], results[variant] = obs.timeline, res
        at = attribute(obs.timeline)
        print(f"{variant:8s}: wall {res.summary['wall_clock_s']:8.2f}s  "
              f"sync barriers {at.sync_rounds:3d}  "
              f"bytes_up {int(res.summary['bytes_up']):>9d}  "
              f"distinct stragglers "
              f"{len(set(c for c in at.critical_path if c >= 0))}")

    report(timelines, top=8, path="obs_trace_stragglers.md")
    print("\nwrote obs_trace_dasha.json / obs_trace_marina.json "
          "(drop onto https://ui.perfetto.dev),")
    print("obs_trace_stragglers.md, obs_trace_metrics.jsonl")

    d, m = (attribute(timelines[v]) for v in ("dasha", "marina"))
    print(f"\nMARINA spent {m.barrier_s:.2f}s at barriers "
          f"({m.sync_rounds} of them all-client sync) vs DASHA's "
          f"{d.barrier_s:.2f}s with zero sync barriers: the "
          f"no-client-synchronization claim, per client.")
    return {"rounds": rounds, "timelines": timelines, "results": results,
            "barrier_s": {"dasha": d.barrier_s, "marina": m.barrier_s},
            "sync_rounds": {"dasha": d.sync_rounds,
                            "marina": m.sync_rounds}}


if __name__ == "__main__":
    main()
