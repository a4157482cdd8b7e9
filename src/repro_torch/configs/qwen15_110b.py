"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B family].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.  A copy of
``repro/configs/qwen15_110b.py``.
"""
import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    source="Qwen1.5 [hf:Qwen/Qwen1.5-0.5B]",
    qkv_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen15-smoke", num_layers=2, d_model=128, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256)
