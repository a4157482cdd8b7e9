"""Harness of the port's paper benchmarks (port of ``benchmarks/run.py``
over the figures, the table, the fault bench, the async bench and the
driver bench ported so far).

    PYTHONPATH=src python -m repro_torch.bench.run [--only fig1,table1]
        [--device cpu] [--rounds-scale 0.1]

Each module exposes ``run(device=..., rounds_scale=...) -> list[dict]``;
rows are printed as CSV with a leading ``bench`` column.  ``--device``
defaults to the card; ``--rounds-scale`` multiplies every figure's rounds
(CPU smoke runs).  The exit code is 1 when any bench raised.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.bench.common import emit
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device

BENCHES = ["fig1_gradient", "fig2_finite_sum", "fig3_stochastic",
           "fig4_dnn", "fig5_quadratic_pl", "table1_complexity",
           "fed_faults", "fed_async", "driver_bench"]


def select(only) -> list:
    """The benches whose names start with one of the comma-separated
    prefixes of ``only`` (all of them for None); a prefix that matches
    none raises."""
    if not only:
        return list(BENCHES)
    pats = only.split(",")
    unknown = [p for p in pats if not any(b.startswith(p) for b in BENCHES)]
    if unknown:
        raise SystemExit(f"--only: no bench matches {unknown}; benches: "
                         f"{BENCHES}")
    return [b for b in BENCHES if any(b.startswith(p) for p in pats)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated bench names (prefix match)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--rounds-scale", type=float, default=1.0,
                    help="multiply every figure's rounds (smoke runs)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    failures = 0
    for name in select(args.only):
        mod = __import__(f"repro_torch.bench.{name}", fromlist=["run"])
        t0 = time.time()
        print(f"\n=== {name} ===")
        try:
            rows = mod.run(device=dev, rounds_scale=args.rounds_scale)
            emit(rows)
            print(f"[{name}] done in {time.time() - t0:.1f}s")
        except Exception as e:
            failures += 1
            print(f"[{name}] FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
