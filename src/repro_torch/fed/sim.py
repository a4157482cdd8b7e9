"""What the federated simulators share (port of the shared part of
``repro.fed.sim``): the result type and the campaign constants.  The
event-driven heap oracle ``FedSim`` is not ported yet."""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

X_BYTES_PER_COORD = 4                  # the server broadcast is dense fp32

DEFAULT_CHUNK = 128                    # rounds per chunk (memory knob)


class SimResult(NamedTuple):
    state: Any                         # final MethodState
    traces: Dict[str, np.ndarray]      # driver-style named metric traces
    events: Optional[List[Any]]        # the heap oracle's event log
    summary: Dict[str, float]
