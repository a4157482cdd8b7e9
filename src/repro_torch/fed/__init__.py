"""Federated transport layer (port of ``repro.fed``, DESIGN.md §12):

* :mod:`repro_torch.fed.wire`   — the wire formats' constants and static
  byte schema (the byte codec is not ported yet);
* :mod:`repro_torch.fed.net`    — latency / bandwidth / straggler link
  models and the per-round common-random-number streams, numpy as in the
  reference;
* :mod:`repro_torch.fed.vecsim` — the vectorized simulator with round
  barriers, on the scatter and the slab client stores.
"""
from repro_torch.fed.net import (Constant, LinkModel,  # noqa: F401
                                 Lognormal, Pareto, Straggler,
                                 campaign_streams, round_multipliers)
from repro_torch.fed.sim import SimResult  # noqa: F401
from repro_torch.fed.vecsim import VecFedSim  # noqa: F401
from repro_torch.fed.wire import WireSchema, wire_schema  # noqa: F401
