"""Compression subsystem (port of ``repro.compress``): specs and the omega
calculus (:mod:`.spec`), per-round plans (:mod:`.plan`), and the dense /
sparse / fused execution backends (:mod:`.backends`)."""
from repro_torch.compress.backends import (BACKENDS,  # noqa: F401
                                           DenseMessages, Messages,
                                           RoundCompressor, SparseMessages,
                                           apply_dense, apply_sparse,
                                           estimator_update_with_plan,
                                           fused_estimator_update,
                                           make_round_compressor)
from repro_torch.compress.plan import (PAD, Plan, draw_mask,  # noqa: F401
                                       indices_to_masks,
                                       participation_coins, perm_partition,
                                       permk_owner, randk_indices)
from repro_torch.compress.spec import (MODES, REGISTRY,  # noqa: F401
                                       CompressorDef, CompressorSpec,
                                       make_plan, make_spec, momentum_a,
                                       omega_bernoulli, omega_participation,
                                       omega_permk, register)
