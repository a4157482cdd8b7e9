"""Language models (port of ``repro.models``): the config, norms, RoPE
and MLPs (:mod:`.common`), stacked-layer initialisation (:mod:`.init`),
the Mamba2 mixer (:mod:`.ssm`), grouped-query and latent attention
(:mod:`.attention`), the routed experts (:mod:`.moe`), blocks
(:mod:`.blocks`) and the LM forward, loss and decode (:mod:`.lm`).  The
``ssm`` family, the dense GQA stack, gemma3's grouped stack, the ``moe``
family and the ``hybrid`` family (zamba2) are ported; the VLM and audio
families raise NotImplementedError."""
from repro_torch.models import lm  # noqa: F401
from repro_torch.models.common import ArchConfig  # noqa: F401
from repro_torch.models.init import init_params  # noqa: F401
