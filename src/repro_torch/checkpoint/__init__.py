"""Full-state checkpoints (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.io import (FORMAT_VERSION,  # noqa: F401
                                       RETIRED_FIELDS, checkpoint_meta,
                                       checkpoint_step, load_checkpoint,
                                       load_method_state, load_state,
                                       save_checkpoint, save_method_state,
                                       save_state)
