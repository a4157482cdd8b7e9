"""Roofline terms of a dry-run pair (port of ``repro.launch.roofline``).

    compute term    = FLOPs / (ranks * chip.peak_flops)
    memory term     = HBM bytes / (ranks * chip.hbm_bw)
    collective term = collective bytes / (ranks * chip.link_bw)

The FLOPs and HBM bytes are the analytic totals of
:mod:`repro_torch.launch.analytic`; the collective bytes are counted over the
traced call (:mod:`repro_torch.launch.collectives`).  The port's one chip is
:data:`H100_SXM5`.  Its collective term assumes NVLink 4 at 450 GB/s each
way a GPU: a 16-wide ``model`` axis spans two 8-GPU HGX boards, so it holds
only where the two boards are joined by NVLink switches (an NVL
domain); across InfiniBand (400 Gb/s, 50 GB/s a GPU) that axis's term
would be 9x longer.  :func:`memory_per_device` reads the live local bytes a
:class:`~repro_torch.launch.collectives.CallTrace` counted.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class Chip:
    peak_flops: float            # dense bf16 FLOP/s
    hbm_bw: float                # bytes/s
    link_bw: float               # bytes/s one way, per GPU
    tf32_flops: Optional[float] = None
    fp32_flops: Optional[float] = None
    name: str = ""


#: NVIDIA H100 SXM5 80GB at its 700 W limit, from NVIDIA's H100 data sheet:
#: 989 TFLOP/s dense bf16 (1,979 with sparsity), 3.35 TB/s HBM3, NVLink 4
#: at 900 GB/s both ways (450 GB/s each), 495 TFLOP/s dense TF32, 67
#: TFLOP/s float32 on the CUDA cores
H100_SXM5 = Chip(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
                 tf32_flops=495e12, fp32_flops=67e12,
                 name="H100 SXM5 80GB, 700 W")


@dataclasses.dataclass
class Roofline:
    flops: float                 # total FLOPs (all ranks)
    hbm_bytes: float             # total bytes accessed (all ranks)
    coll_bytes: float            # collective bytes counted
    chips: int
    coll_detail: Dict[str, int]
    model_flops: Optional[float] = None   # 6*N*D (or 6*N_active*D)
    chip: Chip = H100_SXM5

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.chip.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.chip.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * self.chip.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if not self.model_flops or not self.flops:
            return None
        return self.model_flops / self.flops

    def row(self) -> Dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_gflops": self.flops / 1e9,
            "hbm_gb": self.hbm_bytes / 1e9,
            "coll_gb": self.coll_bytes / 1e9,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def memory_per_device(trace, outputs: Any) -> Dict[str, float]:
    """Live local bytes of one rank over the traced call: the arguments',
    the outputs' new storages, the outputs that are argument storages
    written in place (``alias``: the decode cache, the counterpart of the
    reference's donated state) and the peak of all live storages; ``temp``
    is what the peak holds beyond them, so that peak = argument + temp +
    output - alias, as the reference's keys add up."""
    st = trace.storage_bytes(outputs)
    arg, out, alias = trace.arg_bytes, st["output"], st["alias"]
    peak = trace.peak_bytes
    return {
        "argument_gb": arg / 1e9,
        "output_gb": out / 1e9,
        "temp_gb": (peak - arg - out + alias) / 1e9,
        "alias_gb": alias / 1e9,
        "peak_gb": peak / 1e9,
    }
