"""minitron-8b [dense] — pruned Nemotron [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.  A copy of
``repro/configs/minitron_8b.py``.
"""
import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    source="Minitron [arXiv:2407.14679]",
)

SMOKE = dataclasses.replace(
    CONFIG, name="minitron-smoke", num_layers=2, d_model=128, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256)
