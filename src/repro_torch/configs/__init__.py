"""Architecture registry (port of ``repro.configs``): one module per
architecture, each holding the full config ``CONFIG`` and its reduced
same-family ``SMOKE`` variant.  The Mamba2 family, the dense GQA family
(starcoder2, minitron, qwen1.5), gemma3's grouped local/global stack, the
mixture-of-experts family (phi3.5-moe, deepseek-v2-lite with MLA), the
hybrid family (zamba2) and the cross-attention families (llama-3.2-vision,
whisper) are ported: all ten of the reference's ids.  A name that is none
of them raises ValueError."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.common import ArchConfig

ARCHS: List[str] = ["mamba2_780m", "deepseek_v2_lite_16b", "starcoder2_3b",
                    "phi35_moe_42b", "gemma3_12b", "minitron_8b",
                    "qwen15_110b", "zamba2_1p2b", "llama32_vision_11b",
                    "whisper_tiny"]

# CLI ids (assignment spelling) -> module name
ALIASES = {"mamba2-780m": "mamba2_780m",
           "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
           "starcoder2-3b": "starcoder2_3b",
           "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
           "gemma3-12b": "gemma3_12b", "minitron-8b": "minitron_8b",
           "qwen1.5-110b": "qwen15_110b", "zamba2-1.2b": "zamba2_1p2b",
           "llama-3.2-vision-11b": "llama32_vision_11b",
           "whisper-tiny": "whisper_tiny"}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ARCHS:
        raise ValueError(f"architecture {name!r} is not ported to "
                         f"repro_torch; ported: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE


def all_arch_ids() -> List[str]:
    return list(ALIASES.keys())
