"""Mesh builders of the PyTorch port (the JAX package's ``launch/mesh.py``).

Single pod: 16×16 = 256 devices ("data", "model"); multi-pod: 2×16×16 = 512
("pod", "data", "model").  The "model" axis is the intra-pod H-tree analogue
(reductions stay local); "pod" carries only data-parallel traffic (PIMSAB's
inter-tile rule: no cross-tile partial-sum reduction).

:func:`make_production_mesh` describes such a mesh without ranks: the
sharding specs, the input specs and the memory model read only its axes.
:func:`make_dryrun_mesh` puts one rank of such a mesh on a fake process
group (``torch.distributed``'s ``"fake"`` backend, which moves nothing and
takes only ``meta`` tensors here): the dry run (``launch.dryrun``) runs a
step on it as that rank, touching no device.
:func:`make_host_mesh` builds a ``torch.distributed`` device mesh over the
process group the caller initialised — NCCL on the card, gloo when the
caller asks for the CPU, or gloo staged through host memory when the caller
asks for ``host_collectives`` (several ranks sharing one card, where NCCL
refuses) — and is what a step runs on.  Hardware rates are
not kept here: the card's are named beside their source where they are used.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional, Tuple, Union

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
        self._flat: Dict[Tuple[str, ...], Any] = {}

    def _flattened(self, axes: Tuple[str, ...]):
        """The device mesh of several data axes flattened in row-major order
        (("pod", "data") on the multi-pod mesh)."""
        if "model" in axes:
            raise ValueError(f"a process group spans one data axis, the data axes together or the model axis; "
                             f"got {axes}")
        if axes not in self._flat:
            self._flat[axes] = self.device_mesh[axes]._flatten()
        return self._flat[axes]

    def group(self, axes: Union[str, Tuple[str, ...]]):
        """The process group of one axis ("data" or "model"), or of the data
        axes together."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._flattened(axes).get_group()

    def coordinate(self, axes: Union[str, Tuple[str, ...]]) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self.device_mesh.get_local_rank(axes[0])
        return self._flattened(axes).get_local_rank()


def make_production_mesh(*, multi_pod: bool = False) -> MeshDescription:
    return MeshDescription(*_production_shape(multi_pod))


def _production_shape(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


@contextlib.contextmanager
def make_dryrun_mesh(multi_pod: bool = False, rank: int = 0, *,
                     shape: Optional[Tuple[int, ...]] = None) -> Iterator[ProcessMesh]:
    """Rank ``rank`` of a production mesh (16×16, or 2×16×16 with
    ``multi_pod``; or ``shape``, two axes ("data", "model") or three
    ("pod", "data", "model")) on a fake process group, for the block:

        with make_dryrun_mesh(rank=0) as mesh:
            rules = MeshRules.from_mesh(mesh)

    A fake group moves nothing and ``dist.collectives`` hands it only
    ``meta`` tensors, so whatever runs on this mesh touches no device.
    Refuses to start while a process group exists (a live run's), and
    destroys its own when the block ends."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers the "fake" backend)
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_initialized():
        raise RuntimeError(f"make_dryrun_mesh starts its own fake process group; one already exists "
                           f"(backend {dist.get_backend()}, world {dist.get_world_size()})")
    if shape is None:
        shape, axes = _production_shape(multi_pod)
    else:
        shape = tuple(shape)
        axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    n = 1
    for v in shape:
        n *= v
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is not in a mesh of {n} ranks")
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank, world_size=n)
    try:
        yield ProcessMesh(init_device_mesh("cpu", shape, mesh_dim_names=axes), device_type="meta")
    finally:
        dist.destroy_process_group()


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
