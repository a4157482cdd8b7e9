"""Compression subsystem (port of ``repro.compress``): specs and the omega
calculus (:mod:`.spec`), per-round plans (:mod:`.plan`), the dense /
sparse / fused execution backends (:mod:`.backends`), the parameter-tree
adapter (:mod:`.treelevel`) and the seed-era object API (:mod:`.legacy`).
"""
from repro_torch.compress.backends import (BACKENDS,  # noqa: F401
                                           DenseMessages, Messages,
                                           RoundCompressor, SparseMessages,
                                           apply_dense, apply_sparse,
                                           estimator_update_with_plan,
                                           fused_estimator_update,
                                           make_round_compressor)
from repro_torch.compress.legacy import (Compressor,  # noqa: F401
                                         Identity, NodeCompressor,
                                         PartialParticipation, PermK,
                                         QDither, RandK, empirical_omega,
                                         make_compressor)
from repro_torch.compress.plan import (PAD, Plan, draw_mask,  # noqa: F401
                                       indices_to_masks,
                                       participation_coins, perm_partition,
                                       permk_owner, randk_indices)
from repro_torch.compress.spec import (MODES, REGISTRY,  # noqa: F401
                                       CompressorDef, CompressorSpec,
                                       make_plan, make_spec, momentum_a,
                                       omega_bernoulli, omega_participation,
                                       omega_permk, register)
from repro_torch.compress.treelevel import (bernoulli_compress,  # noqa: F401
                                            fused_tree_update, leaf_keys,
                                            permk_compress, tree_masks)


def as_round_compressor(comp) -> RoundCompressor:
    """A :class:`RoundCompressor` as it is, or a legacy
    :class:`NodeCompressor`'s view of one."""
    if isinstance(comp, RoundCompressor):
        return comp
    return comp.rc
