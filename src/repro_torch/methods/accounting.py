"""Unified payload accounting for the methods layer (port of
``repro.methods.accounting``, DESIGN.md §6-§7).

* :func:`round_payload` — the per-round coords/node, coin-aware;
* :func:`expected_payload_frac` — the static expectation
  (payload + p * (dense - payload), Definition 1.3).

Coins are host booleans in the port, so every number here is a Python
float (a float32 array over a sweep's lanes for per-lane coins).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def round_payload(payload_compressed: float, dense_coords: float,
                  coin: Optional[bool] = None) -> float:
    """Coords per node actually sent this round: on a sync round (``coin``
    True) every node uploads the full dense vector, otherwise the
    compressor's payload.  ``coin`` is None for variants with no sync
    branch, and a (G,) bool array for a sweep's per-lane coins."""
    if isinstance(coin, np.ndarray):
        return np.where(coin, dense_coords, payload_compressed).astype(
            np.float32)
    if coin:
        return dense_coords
    return payload_compressed


def expected_payload_frac(rule, hyper, payload_per_node: float,
                          dense_coords: float = 1.0) -> float:
    """E[coords sent] / d for one round of ``rule`` under ``hyper``."""
    extra = rule.extra_payload(hyper, payload_per_node, dense_coords)
    return float((payload_per_node + extra) / dense_coords)


def sampled_per_node(cohort_coords: float, n: int, c: int) -> float:
    """Per-node-per-round average coords under C-of-n client sampling:
    exactly c of the n clients send ``cohort_coords`` each round."""
    return float(c) / float(n) * cohort_coords


def downlink_receivers(n: int, cohort: Optional[int] = None) -> int:
    """How many clients the server's dense broadcast reaches per round: all
    n under full or Appendix-D participation, only the cohort under C-of-n
    client sampling."""
    return int(n) if cohort is None else int(cohort)


def expected_wire_coords(rule, hyper, wire_per_node: float,
                         dense_coords: float) -> float:
    """E[scalars the wire moves] per node per round of ``rule``: a sync
    round replaces the compressed wire message with a dense upload."""
    extra = rule.extra_payload(hyper, wire_per_node, dense_coords)
    return float(wire_per_node + extra)
