"""repro_torch.analysis — machine-checked contracts of the port (port of
``repro.analysis``, DESIGN.md §15).

Three layers:

* :mod:`~repro_torch.analysis.dispatch_audit` — a ``TorchDispatchMode``
  walk of one call: large-output counts, the live-bytes peak over the
  arguments, flops, in-place updates of the state and the bytes a chunk
  carries (the counterpart of the reference's jaxpr/HLO walker).
* :mod:`~repro_torch.analysis.rng_lint` — AST lint of the RNG discipline
  (global draws, fixed seeds, stream reuse, generator fanout) and of host
  syncs and tensor ``if`` s on the round loops, with the stream-part
  registry in :mod:`~repro_torch.analysis.tags` as the single source of
  truth.
* :mod:`~repro_torch.analysis.recompile` — runtime sentinels: kernel
  builds in a region (the port compiles only its nvcc builds) and call
  counters.

Run the static layers via ``scripts/torch_lint.py``; intentional
exceptions live in ``src/repro_torch/analysis/allowlist.toml``.

``tags``, ``findings`` and the AST layer import no torch so the CLI stays
fast; import the dispatch and recompile layers via their submodules.
"""
from . import tags                                             # noqa: F401
from .findings import (                                        # noqa: F401
    AllowEntry, Finding, apply_allowlist, load_allowlist, DEFAULT_ALLOWLIST,
)
from .rng_lint import LOOP_ROOTS, lint_paths, lint_source      # noqa: F401
