"""Collective traffic and the three roofline terms of a step, the port's
counterpart of the JAX package's ``launch/hlo_analysis.py``.

The port lowers nothing to HLO: there is no compiled module to parse, so
JAX's ``parse_collectives`` (a regex over the partitioned HLO text) has no
counterpart here.  :func:`collective_stats` builds the same
:class:`CollectiveStats` from the records ``dist.collectives`` keeps of each
``torch.distributed`` call it makes (``collectives.collective_records()``):
the op, the bytes of the operand this rank hands it and the group size.
JAX reconstructs each operand from the printed output shape; a record has
the operand itself, and the output follows by the same op semantics:

  all-reduce:         output == operand
  all-gather:         output == operand × group
  reduce-scatter:     output == operand / group
  all-to-all:         output == operand
  collective-permute: output == operand   (a send/recv pair)

and the same ring factors give the wire bytes (all-reduce moves
2(g-1)/g × payload per rank; gather/scatter (g-1)/g).  Each record also
names the link its group crosses (NVLink within an HGX node of
``collectives.GPUS_PER_NODE`` GPUs, InfiniBand across nodes), kept as
``link_wire_bytes``.

:func:`roofline_terms` is JAX's with the rates as arguments.  The port's
rates are one H100 SXM's (:data:`H100_SXM`), each with its source; no TPU
rate is used here.  All operations are priced at one rate, the dense BF16
peak, whatever their type (:func:`roofline_terms`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Union


@dataclass(frozen=True)
class DeviceRates:
    """Peak rates of one device, per direction for links, with the card's
    name and power limit as ``nvidia-smi`` gives them and the source."""

    name: str
    power_limit_w: float
    peak_flops: float
    hbm_bytes_per_s: float
    memory_bytes: int
    link_bytes_per_s: Mapping[str, float]
    source: str

    def to_json(self) -> Dict:
        return dataclasses.asdict(self) | {"link_bytes_per_s": dict(self.link_bytes_per_s)}


# One H100 SXM5 of an HGX H100 node at its 700 W limit.  Dense BF16 on the
# tensor cores (the data sheet's 1979 TFLOPS counts 2:4 sparsity); HBM3;
# NVLink 4 at 900 GB/s both directions, so 450 GB/s each way; one 400 Gb/s
# ConnectX-7 InfiniBand port a GPU, 50 GB/s each way.
H100_SXM = DeviceRates(
    name="NVIDIA H100 80GB HBM3",
    power_limit_w=700.0,
    peak_flops=989e12,
    hbm_bytes_per_s=3.35e12,
    memory_bytes=80 * 10**9,
    link_bytes_per_s={"nvlink": 900e9 / 2, "infiniband": 400e9 / 8},
    source="NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column (BF16 tensor core 1,979 TFLOPS with "
           "sparsity, 989 dense; GPU memory 80 GB at 3.35 TB/s; NVLink 900 GB/s); NVIDIA DGX H100 data sheet "
           "(8 GPUs a node on NVSwitch, one 400 Gb/s ConnectX-7 InfiniBand/Ethernet port a GPU)",
)


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    operand_bytes: Dict[str, int] = field(default_factory=dict)
    wire_bytes: Dict[str, float] = field(default_factory=dict)
    link_wire_bytes: Dict[str, float] = field(default_factory=dict)

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def to_json(self) -> Dict:
        return {
            "counts": self.counts,
            "operand_bytes": self.operand_bytes,
            "wire_bytes": {k: float(v) for k, v in self.wire_bytes.items()},
            "total_operand_bytes": self.total_operand_bytes,
            "total_wire_bytes": float(self.total_wire_bytes),
            "link_wire_bytes": {k: float(v) for k, v in self.link_wire_bytes.items()},
        }


def collective_stats(records: Iterable) -> CollectiveStats:
    """:class:`CollectiveStats` of ``collectives.collective_records()`` (or
    any records with ``op``, ``operand_bytes``, ``group_size``, ``link`` and
    ``count``), with JAX's operand and wire bytes for each op."""
    stats = CollectiveStats()
    for r in records:
        op, operand, g = r.op, int(r.operand_bytes), int(r.group_size)
        if op == "all-gather":
            out_bytes = operand * g
            wire = out_bytes * (g - 1) / max(g, 1)
        elif op == "reduce-scatter":
            wire = operand * (g - 1) / max(g, 1)
        elif op == "all-reduce":
            wire = 2 * operand * (g - 1) / max(g, 1)
        elif op == "all-to-all":
            wire = operand * (g - 1) / max(g, 1)
        elif op == "collective-permute":
            wire = operand
        else:
            raise ValueError(f"unknown collective {op!r}")
        for _ in range(int(r.count)):  # added call by call, in JAX's order of float adds
            stats.counts[op] = stats.counts.get(op, 0) + 1
            stats.operand_bytes[op] = stats.operand_bytes.get(op, 0) + operand
            stats.wire_bytes[op] = stats.wire_bytes.get(op, 0) + wire
            stats.link_wire_bytes[r.link] = stats.link_wire_bytes.get(r.link, 0) + wire
    return stats


@dataclass
class Roofline:
    """Per-device, per-step roofline terms (seconds)."""

    flops: float
    hbm_bytes: float
    collective_operand_bytes: float
    collective_wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_terms(
    per_device_flops: float,
    per_device_bytes: float,
    coll: CollectiveStats,
    model_flops_per_device: float = 0.0,
    links: int = 1,
    *,
    peak_flops: float,
    hbm_bytes_per_s: float,
    link_bytes_per_s: Union[float, Mapping[str, float]],
) -> Roofline:
    """JAX's three terms at the rates given.  ``link_bytes_per_s`` is one
    rate for all wire bytes (JAX's form), or a rate for each link of
    ``coll.link_wire_bytes``, whose times add up.

    Every counted operation is priced at the one ``peak_flops``, whatever
    its type, as JAX prices XLA's count at one rate: at :data:`H100_SXM`'s
    dense BF16 rate the compute term blends the bfloat16 products with the
    bit-sliced GEMM's int8 multiply-adds (whose dense peak is twice as high)
    and the RG-LRU scan's float32 CUDA-core fmas (whose peak is far lower),
    so it is a model of the step's compute, not the card's bound on it."""
    compute_s = per_device_flops / peak_flops
    memory_s = per_device_bytes / hbm_bytes_per_s
    if isinstance(link_bytes_per_s, Mapping):
        collective_s = sum(b / (links * link_bytes_per_s[k]) for k, b in coll.link_wire_bytes.items())
    else:
        collective_s = coll.total_wire_bytes / (links * link_bytes_per_s)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops_per_device / per_device_flops if per_device_flops else 0.0
    return Roofline(
        flops=per_device_flops,
        hbm_bytes=per_device_bytes,
        collective_operand_bytes=float(coll.total_operand_bytes),
        collective_wire_bytes=float(coll.total_wire_bytes),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops_per_device,
        useful_ratio=useful,
    )

