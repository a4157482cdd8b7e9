"""Core DASHA library of the port: oracles, theory constants, device
resolution, trees and stateless RNG, and the paper-named entry points.

The algorithm layer lives in :mod:`repro_torch.methods` (variant rules x
state substrates); :mod:`repro_torch.core.dasha` and
:mod:`repro_torch.core.marina` are paper-named shims over it.  The legacy
compressor names re-export from :mod:`repro_torch.compress.legacy` (the
seed-era ``core.compressors`` / ``core.node_compress`` module paths still
import, with a DeprecationWarning).

The re-exports resolve on first access: every layer above imports this
package's small modules (``device``, ``rng``, ``tree``), so importing the
methods layer here, up front, would import it inside its own imports.
"""
import importlib

#: re-exported name -> the module that defines it
_EXPORTS = {
    "RoundCompressor": "repro_torch.compress",
    "make_round_compressor": "repro_torch.compress",
    **{name: "repro_torch.compress.legacy" for name in (
        "Identity", "NodeCompressor", "PartialParticipation", "PermK",
        "QDither", "RandK", "make_compressor")},
    **{name: "repro_torch.core.dasha" for name in (
        "DashaHyper", "DashaState", "init", "run", "step")},
    **{name: "repro_torch.methods" for name in (
        "Hyper", "Method", "MethodState")},
}
_MODULES = ("dasha", "marina", "oracles", "theory")

__all__ = sorted(_EXPORTS) + list(_MODULES)


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"repro_torch.core.{name}")
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute "
                         f"{name!r}")
