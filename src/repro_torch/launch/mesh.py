"""Production mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants, so importing never touches a process
group.  Single pod: (data=16, model=16) = 256 ranks.  Multi-pod adds a
leading "pod" axis: (pod=2, data=16, model=16) = 512 ranks.

The production meshes are ``DeviceMesh`` objects over a ``"fake"`` process
group (``torch.testing._internal.distributed.fake_pg``): this process is rank
0 of 256 or 512, its collectives return at once and write nothing, so a
sharded program traces (and, on the card, computes rank 0's local part) with
no peer.  :func:`make_host_mesh` is a real one-rank group (``nccl`` on the
card, ``gloo`` on the CPU) under the single pod's axis names.

A process group is global to its process: one mesh at a time, made by
``make_*_mesh`` and given back by :func:`enter_mesh`, which destroys the
group on exit.  :func:`abstract_mesh` has axis names and sizes and no group;
the spec code (:mod:`repro_torch.models.sharding`) runs on it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))

@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: ``.shape`` maps name -> size (the
    reference's ``AbstractMesh.shape``), ``.axis_names`` lists them."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         "differ in length")
    return AbstractMesh(tuple(axes), tuple(int(s) for s in shape))


def mesh_axes(mesh) -> Dict[str, int]:
    """name -> size of an :class:`AbstractMesh` or a named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no dim names")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def _device_type(device) -> str:
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no mesh for device {dev}")
    return dev.type


def _init_group(backend: str, world: int, store) -> None:
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialised in this process; leave "
            "the mesh that made it (enter_mesh) before making another")
    dist.init_process_group(backend, store=store, rank=0, world_size=world)


def _device_mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    if device_type == "cuda":
        torch.cuda.set_device(0)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_fake_mesh(shape: Sequence[int], axes: Sequence[str], *,
                   device=DEFAULT_DEVICE):
    """Rank 0 of a ``shape`` mesh named ``axes`` over a fake process group
    of prod(shape) ranks, on ``device``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dtype = _device_type(device)
    world = 1
    for s in shape:
        world *= s
    _init_group("fake", world, FakeStore())
    return _device_mesh(dtype, shape, axes)


def make_production_mesh(*, multi_pod: bool = False, device=DEFAULT_DEVICE):
    """Rank 0 of the 16x16 (or 2x16x16) production mesh over a fake process
    group of 256 (or 512) ranks, on ``device`` (the card unless the caller
    asks for the CPU)."""
    return make_fake_mesh(*(MULTI_POD if multi_pod else SINGLE_POD),
                          device=device)


def make_host_mesh(device=DEFAULT_DEVICE):
    """A 1x1 ("data", "model") mesh on a real one-rank process group:
    ``nccl`` on the card, ``gloo`` on the CPU (an in-process store, no
    socket)."""
    dtype = _device_type(device)
    _init_group("nccl" if dtype == "cuda" else "gloo", 1, dist.HashStore())
    return _device_mesh(dtype, (1, 1), SINGLE_POD[1])


@contextlib.contextmanager
def enter_mesh(mesh) -> Iterator:
    """``with jax.set_mesh(mesh):``'s counterpart: yields ``mesh`` (from
    ``make_*_mesh``, which made its process group) and destroys the group
    on exit, whatever happens inside."""
    try:
        yield mesh
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
