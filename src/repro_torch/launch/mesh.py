"""Mesh builders of the PyTorch port (the JAX package's ``launch/mesh.py``).

Single pod: 16×16 = 256 devices ("data", "model"); multi-pod: 2×16×16 = 512
("pod", "data", "model").  The "model" axis is the intra-pod H-tree analogue
(reductions stay local); "pod" carries only data-parallel traffic (PIMSAB's
inter-tile rule: no cross-tile partial-sum reduction).

:func:`make_production_mesh` describes such a mesh without ranks: the
sharding specs, the input specs and the memory model read only its axes.
:func:`make_host_mesh` builds a ``torch.distributed`` device mesh over the
process group the caller initialised — NCCL on the card, gloo when the
caller asks for the CPU, or gloo staged through host memory when the caller
asks for ``host_collectives`` (several ranks sharing one card, where NCCL
refuses) — and is what a step runs on.  Hardware rates are
not kept here: the card's are named beside their source where they are used.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.kernels import api


class MeshDescription:
    """Axis names and sizes, with no ranks behind them."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


class ProcessMesh(MeshDescription):
    """A ``torch.distributed.device_mesh.DeviceMesh`` with the process group
    and this rank's coordinate of each axis."""

    def __init__(self, device_mesh, device_type: str = None):
        super().__init__(tuple(device_mesh.mesh.shape), device_mesh.mesh_dim_names)
        self.device_mesh = device_mesh
        self.device_type = device_type or device_mesh.device_type

    @staticmethod
    def _axis(axes: Union[str, Tuple[str, ...]]) -> str:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) != 1:
            raise ValueError(f"a host mesh has one data axis; got {axes}")
        return axes[0]

    def group(self, axes: Union[str, Tuple[str, ...]]):
        """The process group of one axis ("data" or "model")."""
        return self.device_mesh.get_group(self._axis(axes))

    def coordinate(self, axes: Union[str, Tuple[str, ...]]) -> int:
        return self.device_mesh.get_local_rank(self._axis(axes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshDescription:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshDescription(shape, axes)


def make_host_mesh(model: int = 1, *, device: Any = "cuda", host_collectives: bool = False) -> ProcessMesh:
    """A (world // model, model) ("data", "model") mesh over the initialised
    process group: NCCL with one card a rank (``device="cuda"``, the
    default), gloo where the caller asks for ``device="cpu"``.  Raises when
    no process group is initialised, its backend does not serve ``device``
    or ``model`` does not divide the world.

    ``host_collectives=True`` (with ``device="cuda"`` and a gloo process
    group) is the one way to put several ranks on one card, where NCCL
    refuses: the model runs on the card and every collective copies its
    tensors to the host, runs gloo there and copies the result back
    (``dist.collectives.stage_through_host``).  It is never chosen for the
    caller."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives

    dev = api.resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group with its address, world size and rank)")
    if host_collectives and dev.type != "cuda":
        raise ValueError(f"host_collectives stages CUDA tensors through the host; device {dev.type} has none")
    want = "gloo" if host_collectives or dev.type != "cuda" else "nccl"
    backend = str(dist.get_backend())
    if backend != want:
        raise RuntimeError(f"a {dev.type} mesh{' with host_collectives' if host_collectives else ''} takes the "
                           f"{want} backend; the process group is {backend}")
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide the world of {n} ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    if not host_collectives:
        return ProcessMesh(init_device_mesh(dev.type, (n // model, model), mesh_dim_names=("data", "model")))
    mesh = ProcessMesh(init_device_mesh("cpu", (n // model, model), mesh_dim_names=("data", "model")),
                       device_type="cuda")
    for axis in mesh.axis_names:
        collectives.stage_through_host(mesh.group(axis))
    return mesh
