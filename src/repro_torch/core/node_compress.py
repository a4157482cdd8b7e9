"""Deprecated seed-era import path: NodeCompressor lives in
:mod:`repro_torch.compress` (port of ``repro.core.node_compress``).

The (n, d) execution modes (independent | shared_coords | permk) are in
DESIGN.md §3, the backends (dense | sparse | fused) in §5.  Build a
:class:`repro_torch.compress.RoundCompressor` (or use
:func:`repro_torch.compress.make_round_compressor`) instead.
"""
import warnings

warnings.warn(
    "repro_torch.core.node_compress is a deprecated seed-era shim; use "
    "repro_torch.compress.RoundCompressor / make_round_compressor instead.",
    DeprecationWarning, stacklevel=2)

from repro_torch.compress.legacy import NodeCompressor  # noqa: F401,E402
