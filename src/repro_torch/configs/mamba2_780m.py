"""mamba2-780m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1536, attention-free, vocab=50280, ssm_state=128.  A copy of
``repro/configs/mamba2_780m.py``.
"""
import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    arch_type="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    source="SSD / Mamba2 [arXiv:2405.21060]",
    head_dim=1,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    conv_width=4,
    ssd_chunk=256,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke", num_layers=2, d_model=128, vocab_size=512,
    ssm_state=16, ssm_headdim=32, ssd_chunk=32)
