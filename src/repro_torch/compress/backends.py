"""Layer 3 of the compression subsystem: interchangeable execution backends.

Port of ``repro.compress.backends``.  Three ways to execute the same
:class:`~repro_torch.compress.plan.Plan` on a stacked (n, d) message matrix:

* ``dense``  — reference semantics: messages are materialized d-vectors;
* ``sparse`` — wire format: a RandK/PermK message is ``(indices, values)``;
  its values are bit-identical to ``dense`` under the same plan;
* ``fused``  — the CUDA kernel path (:mod:`repro_torch.kernels.ops`): the
  whole estimator update (Alg. 1 lines 8-10) in one device-memory pass.

Lanes: a sweep's message matrices carry a leading lane axis, (G, n, d)
(:class:`repro_torch.methods.substrates.LaneFlatSubstrate`).  The plan
stays (n, d): every lane shares it, and the backends broadcast it over the
lanes.  Reductions run over the node axis, which is then axis -2.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple, Union

import torch

from repro_torch.compress.plan import Plan, indices_to_masks
from repro_torch.compress.spec import (REGISTRY, CompressorSpec, make_plan,
                                       make_spec)
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import quantize_ref

BACKENDS = ("dense", "sparse", "fused")


class DenseMessages(NamedTuple):
    """n per-node messages, materialized as (n, d) dense rows ((G, n, d)
    with a lane axis)."""

    values: torch.Tensor          # (n, d)
    payload_coords: float
    wire_coords: float

    @property
    def n(self) -> int:
        return self.values.shape[-2]

    def dense(self) -> torch.Tensor:
        return self.values

    def mean(self) -> torch.Tensor:
        """Server aggregate (1/n) sum_i m_i, fp32."""
        return self.values.to(torch.float32).mean(-2)

    def add_to(self, g_local: torch.Tensor) -> torch.Tensor:
        """g_i <- g_i + m_i (Alg. 1 line 10)."""
        return g_local + self.values.to(g_local.dtype)


def _scatter_rows(base: torch.Tensor, indices: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``base`` (..., n, d) plus ``values`` (..., n, k) at each row's
    ``indices`` (n, k); PAD slots land in a dropped extra column.  Indices
    are distinct within a row, so no two additions meet: the result does
    not depend on their order."""
    d = base.shape[-1]
    wide = torch.cat([base, base.new_zeros(base.shape[:-1] + (1,))], dim=-1)
    wide.scatter_add_(-1, indices.clamp(max=d).expand(values.shape),
                      values.to(base.dtype))
    return wide[..., :d].contiguous()


class SparseMessages(NamedTuple):
    """n per-node messages in wire format: (indices, values) pairs;
    ``indices`` (n, k) PAD-padded (pad slots carry zero values).  With a
    lane axis the values are (G, n, k) and every lane shares the
    indices."""

    indices: torch.Tensor         # (n, k) int64
    values: torch.Tensor          # (n, k)
    d: int
    payload_coords: float
    wire_coords: float

    @property
    def n(self) -> int:
        return self.values.shape[-2]

    def dense(self) -> torch.Tensor:
        base = self.values.new_zeros(self.values.shape[:-1] + (self.d,))
        return _scatter_rows(base, self.indices, self.values)

    def mean(self) -> torch.Tensor:
        """Server aggregate, node by node in index order (the reference's
        flat scatter order; deterministic on the card, unlike one
        scatter with colliding indices)."""
        out = torch.zeros(self.values.shape[:-2] + (self.d + 1,),
                          dtype=torch.float32, device=self.values.device)
        vals = self.values.to(torch.float32) / self.n
        idx = self.indices.clamp(max=self.d)
        for i in range(self.n):
            out.index_add_(-1, idx[i], vals[..., i, :])
        return out[..., :self.d]

    def add_to(self, g_local: torch.Tensor) -> torch.Tensor:
        return _scatter_rows(g_local, self.indices, self.values)


Messages = Union[DenseMessages, SparseMessages]


def _dense_values(plan: Plan, deltas: torch.Tensor) -> torch.Tensor:
    """(n, d) messages with reference (dense-multiply) semantics."""
    if plan.kind == "passthrough":
        return deltas * plan.scale
    if plan.kind == "dither":
        return quantize_ref(deltas, plan.dither_u, plan.levels) * plan.scale
    mask = plan.mask
    if mask is None:
        mask = indices_to_masks(plan.indices, deltas.shape[-1],
                                dtype=deltas.dtype)
    return deltas * mask.to(deltas.dtype) * plan.scale


def apply_dense(plan: Plan, deltas: torch.Tensor) -> DenseMessages:
    return DenseMessages(values=_dense_values(plan, deltas),
                         payload_coords=plan.payload_coords,
                         wire_coords=float(deltas.shape[-1]))


def apply_sparse(plan: Plan, deltas: torch.Tensor) -> Messages:
    """Wire-format execution.  Static-K compressors (RandK/PermK) gather the
    kept coordinates; mask/dither compressors have no static support, so
    they keep dense values with honest wire accounting."""
    if plan.indices is None:
        return apply_dense(plan, deltas)._replace(
            wire_coords=plan.wire_coords)
    d = deltas.shape[-1]
    idx = plan.indices
    valid = (idx < d).to(deltas.dtype)
    support = idx.clamp(max=d - 1).expand(deltas.shape[:-1] + idx.shape[-1:])
    vals = torch.gather(deltas, -1, support) * valid * plan.scale
    return SparseMessages(indices=idx, values=vals, d=d,
                          payload_coords=plan.payload_coords,
                          wire_coords=plan.wire_coords)


def fused_estimator_update(plan: Plan, h_new: torch.Tensor, h: torch.Tensor,
                           g_local: torch.Tensor, a: float
                           ) -> Tuple[Messages, torch.Tensor, torch.Tensor]:
    """Alg. 1 lines 9-10 through the fused kernel, one device-memory pass:
    m = C(h_new - h - a (g_local - h)); g_i <- g_i + m_i.  On the card one
    launch: kernel 2's fused entry for QDither, kernel 1's sparsifier
    entry for RandK, PermK, Bernoulli and passthrough, which builds the
    support from the plan's indices (or reads its mask) inside the launch
    and folds a per-node scale in as the reference's mask * scale does.

    With a lane axis, (G, n, d) inputs, the plan's (n, d) support, scale
    and uniforms are read at row r % n: the kernel runs once on the G * n
    rows and nothing is copied per lane.  ``h_out`` is ``h_new`` itself.

    Returns (messages, h_out, g_local_new)."""
    d = float(h_new.shape[-1])            # fused messages stay dense
    if plan.kind == "dither":
        scale = plan.scale.contiguous() \
            if isinstance(plan.scale, torch.Tensor) else plan.scale
        m, h_out, gl_new = kops.dasha_quantize_update(
            h_new.contiguous(), h.contiguous(), g_local.contiguous(),
            plan.dither_u.contiguous(), a, scale, plan.levels)
        return (DenseMessages(m, plan.payload_coords, d), h_out, gl_new)

    scale = plan.scale.to(torch.float32).contiguous() \
        if isinstance(plan.scale, torch.Tensor) else float(plan.scale)
    indices, mask = _support(plan)
    m, h_out, gl_new = kops.dasha_sparsify_update(
        h_new.contiguous(), h.contiguous(), g_local.contiguous(), a, scale,
        indices=indices, mask=mask)
    return (DenseMessages(m, plan.payload_coords, d), h_out, gl_new)


def _support(plan: Plan):
    """A sparsify or passthrough plan's support as the fused entry takes
    it, (indices, mask): a RandK ``shared_coords`` plan's (n, k) view of
    one row goes as that row (the kernel reads row r % 1); a mask of
    another dtype is read as float32, as the reference converts it."""
    if plan.kind == "passthrough":
        return None, None
    if plan.mask is not None:
        mask = plan.mask
        if mask.dtype not in (torch.float32, torch.bool, torch.uint8):
            mask = mask.to(torch.float32)
        return None, mask.contiguous()
    idx = plan.indices
    if idx.dim() == 2 and idx.shape[0] > 1 and idx.stride(0) == 0:
        idx = idx[:1]
    return idx.contiguous(), None


@dataclasses.dataclass(frozen=True)
class RoundCompressor:
    """A per-round node-collection compressor: spec x mode x backend, whose
    plans are drawn on ``device``."""

    spec: CompressorSpec
    n: int
    mode: str = "independent"
    backend: str = "dense"
    device: torch.device = torch.device(DEFAULT_DEVICE)

    def __post_init__(self):
        defn = REGISTRY[self.spec.name]
        if self.mode not in defn.modes:
            raise ValueError(f"{self.spec.name} does not support mode "
                             f"{self.mode!r} (has {defn.modes})")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def omega(self) -> float:
        return self.spec.omega

    @property
    def payload_per_node(self) -> float:
        """Ideal-coding scalar coords per node message (Definition 1.3)."""
        return self.spec.expected_density

    @property
    def wire_per_node(self) -> float:
        """Coords the selected backend actually moves per node message."""
        if self.backend == "sparse":
            return self.spec.wire_coords(self.mode)
        return float(self.spec.d)

    def plan(self, seed: int) -> Plan:
        return make_plan(self.spec, seed, self.n, self.mode,
                         device=self.device)

    def compress(self, seed: int, deltas: torch.Tensor) -> Messages:
        """deltas: (n, d) -> per-node messages in this backend's format."""
        plan = self.plan(seed)
        if self.backend == "sparse":
            return apply_sparse(plan, deltas)
        return apply_dense(plan, deltas)

    def __call__(self, seed: int, deltas: torch.Tensor) -> torch.Tensor:
        """Dense entry point: (n, d) -> (n, d) messages."""
        return self.compress(seed, deltas).dense()

    def estimator_update(self, seed: int, h_new: torch.Tensor,
                         h: torch.Tensor, g_local: torch.Tensor, a: float
                         ) -> Tuple[Messages, torch.Tensor, torch.Tensor]:
        """One-call Alg. 1 lines 9-10: compress the drift and update g_i.
        Returns (messages, h_out, g_local_new)."""
        return estimator_update_with_plan(self.backend, self.plan(seed),
                                          h_new, h, g_local, a)


def estimator_update_with_plan(backend: str, plan: Plan,
                               h_new: torch.Tensor, h: torch.Tensor,
                               g_local: torch.Tensor, a: float
                               ) -> Tuple[Messages, torch.Tensor,
                                          torch.Tensor]:
    """:meth:`RoundCompressor.estimator_update` with a supplied plan."""
    if backend == "fused":
        return fused_estimator_update(plan, h_new, h, g_local, a)
    delta = h_new - h - a * (g_local - h)
    if backend == "sparse":
        msgs = apply_sparse(plan, delta)
    else:
        msgs = apply_dense(plan, delta)
    return msgs, h_new, msgs.add_to(g_local)


def make_round_compressor(name: str, d: int, n: int, *,
                          mode: str = "independent",
                          backend: str = "dense",
                          device=DEFAULT_DEVICE, **kw) -> RoundCompressor:
    """Factory: registry name -> RoundCompressor drawing plans on
    ``device`` (default the card; raises without one)."""
    if name.lower() == "permk":
        kw.setdefault("n", n)
    return RoundCompressor(make_spec(name, d, **kw), n, mode, backend,
                           resolve_device(device))
