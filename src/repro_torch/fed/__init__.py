"""Federated transport layer (port of ``repro.fed``, DESIGN.md §12):

* :mod:`repro_torch.fed.wire`   — the byte-exact wire codec (five record
  formats, crc32-sealed 20-byte headers) and the static byte schema;
* :mod:`repro_torch.fed.net`    — latency / bandwidth / straggler link
  models and the per-round common-random-number streams, numpy as in the
  reference;
* :mod:`repro_torch.fed.faults` — seeded fault campaigns (crashes with
  stale or reset rejoins, lossy links, corruption, deadlines and retries),
  numpy as in the reference;
* :mod:`repro_torch.fed.sim`    — the event-driven heap oracle
  :class:`FedSim`, which bills every upload through the codec, and
  :func:`simulate`;
* :mod:`repro_torch.fed.vecsim` — the vectorized simulator with round
  barriers, on the scatter and the slab client stores.
"""
from repro_torch.fed.faults import (FaultCampaign,  # noqa: F401
                                    FaultModel, corrupt_bytes)
from repro_torch.fed.net import (Constant, LinkModel,  # noqa: F401
                                 Lognormal, Pareto, Straggler,
                                 campaign_multipliers, campaign_streams,
                                 round_multipliers, severity_grid)
from repro_torch.fed.sim import (FAULT_TRACES, FedEvent,  # noqa: F401
                                 FedSim, SimResult, simulate)
from repro_torch.fed.vecsim import VecFedSim  # noqa: F401
from repro_torch.fed.wire import (FMT_DENSE, FMT_PERMK,  # noqa: F401
                                  FMT_PERMK_SLOT, FMT_SPARSE_IDX,
                                  FMT_SPARSE_SEED, HEADER_BYTES, RoundBytes,
                                  WireCorruptionError, WireDecodeError,
                                  WireMessage, WireSchema,
                                  WireTruncatedError, decode, decode_round,
                                  encode_round, measured_bytes, round_bytes,
                                  topk_messages, verify, wire_schema)
