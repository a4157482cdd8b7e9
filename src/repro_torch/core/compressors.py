"""Deprecated seed-era import path: the compressors live in
:mod:`repro_torch.compress` (port of ``repro.core.compressors``).

Kept so ``from repro_torch.core.compressors import RandK`` keeps working;
import from :mod:`repro_torch.compress` (or build a
:class:`repro_torch.compress.RoundCompressor`) instead.
"""
import warnings

warnings.warn(
    "repro_torch.core.compressors is a deprecated seed-era shim; import "
    "from repro_torch.compress instead (see DESIGN.md §2).",
    DeprecationWarning, stacklevel=2)

from repro_torch.compress.legacy import (Compressor,  # noqa: F401,E402
                                         Identity, PartialParticipation,
                                         PermK, QDither, RandK,
                                         empirical_omega, make_compressor)
from repro_torch.compress.spec import (CompressorSpec,  # noqa: F401,E402
                                       make_spec)
