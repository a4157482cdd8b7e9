"""Language models (port of ``repro.models``): the config and norms
(:mod:`.common`), stacked-layer initialisation (:mod:`.init`), the Mamba2
mixer (:mod:`.ssm`), blocks (:mod:`.blocks`) and the LM forward and loss
(:mod:`.lm`).  Only the ``ssm`` family is ported so far."""
from repro_torch.models import lm  # noqa: F401
from repro_torch.models.common import ArchConfig  # noqa: F401
from repro_torch.models.init import init_params  # noqa: F401
