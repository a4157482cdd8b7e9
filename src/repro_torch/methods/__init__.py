"""One-method API (port of ``repro.methods``, DESIGN.md §7): variant rules
x the flat, sampled-flat and tree substrates (registry compressors on the
tree through ``LeafSpecCompressor``, flat problems through
``LeafProblemOracle``), the engine, the chunked driver, hyperparameter
sweeps and accounting."""
from repro_torch.methods.accounting import (  # noqa: F401
    expected_payload_frac, expected_wire_coords, round_payload,
    sampled_per_node)
from repro_torch.methods.driver import Driver, Sweeper, sweep  # noqa: F401
from repro_torch.methods.engine import (FaultStep, Hyper,  # noqa: F401
                                        Method, MethodState, StepInfo)
from repro_torch.methods.lanes import Lanes, lane_metric  # noqa: F401
from repro_torch.methods.rules import (VARIANTS, MvrFusion,  # noqa: F401
                                       VariantRule, get_rule,
                                       register_variant)
from repro_torch.methods.substrates import (BatchLossOracle,  # noqa: F401
                                            FlatSubstrate,
                                            LaneFlatSubstrate,
                                            LaneSampledFlatSubstrate,
                                            LaneTreeSubstrate,
                                            LeafProblemOracle,
                                            LeafSpecCompressor,
                                            SampledFlatSubstrate,
                                            TreeCompression, TreeSubstrate)
