"""One-method API (port of ``repro.methods``, DESIGN.md §7): variant rules
x the flat, sampled-flat and tree substrates, the engine, the chunked
driver and accounting."""
from repro_torch.methods.accounting import (  # noqa: F401
    expected_payload_frac, expected_wire_coords, round_payload,
    sampled_per_node)
from repro_torch.methods.driver import Driver  # noqa: F401
from repro_torch.methods.engine import (Hyper, Method,  # noqa: F401
                                        MethodState, StepInfo)
from repro_torch.methods.rules import (VARIANTS, MvrFusion,  # noqa: F401
                                       VariantRule, get_rule,
                                       register_variant)
from repro_torch.methods.substrates import (BatchLossOracle,  # noqa: F401
                                            FlatSubstrate,
                                            SampledFlatSubstrate,
                                            TreeCompression, TreeSubstrate)
