"""Mesh-level collectives of the PyTorch port, shaped like PIMSAB's
spatially-aware communication: the JAX package's ``dist/collectives.py`` on
``torch.distributed``.

JAX writes each as a ``shard_map`` over the mesh; here every rank calls the
function with its own shard and gets back the local result that
``shard_map`` gives its device.  ``mesh`` is a process mesh
(``launch.mesh.make_host_mesh``), whose ``group(axis)`` is the process
group of an axis; an axis of size 1 needs no group.

* :func:`htree_allreduce` — log-depth butterfly (recursive halving/doubling
  order), the mesh twin of ``kernels/htree_reduce``'s intra-tile tree.
* :func:`ring_allgather_matmul` — K-sharded matmul whose partial sums
  circulate a neighbor ring (the systolic collective-matmul overlap).
* :func:`compressed_psum_with_feedback` — int8 error-feedback gradient
  reduction (bit-serial-aware communication: ship the live bits only).
* :func:`shuffle` — all-to-all across an axis (MoE dispatch traffic).

The SPMD helpers below them (:func:`all_reduce_`, :func:`all_gather_dim`,
:func:`gather_rows`, :func:`mean_over`) are what the model, the train step
and the serving steps call on the data axes; Megatron's conjugate pairs
(:func:`copy_to_model`, :func:`reduce_from_model`,
:func:`gather_from_model`, :func:`all_reduce_max`) are what the model calls
on the model axis.  Every ``torch.distributed`` call is counted by its name,
and every conjugate by its own (:func:`call_counts`); inside
:func:`recording_collectives` each call also leaves a record of what it
moves (:func:`collective_records`: the op under its HLO name, the operand
bytes, the group size and the link the group crosses), which
``launch.hlo_analysis.collective_stats`` turns into the JAX package's
``CollectiveStats``.  A CUDA tensor goes only to an NCCL group, a CPU tensor
only to a gloo one and a ``meta`` tensor only to a ``"fake"`` one (the dry
run's, ``launch.mesh.make_dryrun_mesh``, which moves nothing): anything else
raises, so no collective runs on another device than asked and no real run
passes through a fake group.  The one exception is asked for by name: a gloo
group registered by :func:`stage_through_host` (``launch.mesh.make_host_mesh(...,
host_collectives=True)``, for several ranks sharing one card, where NCCL
refuses) takes CUDA tensors, each call copying them to the host, running
gloo there and copying the result back.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

_CALLS: Dict[str, int] = {}

_BACKEND_OF = {"cuda": "nccl", "cpu": "gloo", "meta": "fake"}

# GPUs one NVLink domain holds: an HGX H100 node (NVIDIA DGX H100 data
# sheet: 8 GPUs on NVSwitch); a group whose ranks span nodes crosses
# InfiniBand.  Rank r lies in node r // GPUS_PER_NODE.
GPUS_PER_NODE = 8


class CollectiveRecord(NamedTuple):
    """``count`` calls of one kind: the op under its HLO name
    (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute`` for a send/recv pair), the bytes of the operand
    this rank hands it (a gather's shard, a scatter's whole input), the
    group's size and the link it crosses (``"nvlink"`` within a node,
    ``"infiniband"`` across nodes)."""

    op: str
    operand_bytes: int
    group_size: int
    link: str
    count: int


_RECORDS: Dict[Tuple[str, int, int, str], int] = {}
_recording = 0  # open recording_collectives scopes
_LINKS: Dict[Any, str] = {}  # group_link of each group, while a scope is open

# gloo groups whose CUDA tensors are staged through host memory (by
# identity); forgotten once torch.distributed's process groups are destroyed
_HOST_STAGED: list = []


def call_counts() -> Dict[str, int]:
    """``torch.distributed`` calls made by this module since the last
    :func:`reset_call_counts`, by name."""
    return dict(_CALLS)


def reset_call_counts() -> None:
    _CALLS.clear()


def _count(name: str) -> None:
    _CALLS[name] = _CALLS.get(name, 0) + 1


@contextlib.contextmanager
def recording_collectives() -> Iterator[None]:
    """While the block runs, each ``torch.distributed`` call of this module
    leaves its record (:func:`collective_records`); outside it none does,
    and a call does no work for the records."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1
        if not _recording:
            _LINKS.clear()


def collective_records() -> List[CollectiveRecord]:
    """What each ``torch.distributed`` call of this module moved inside
    :func:`recording_collectives` since the last
    :func:`reset_collective_records`, equal calls merged (``count``), in the
    order each kind first came."""
    return [CollectiveRecord(*key, n) for key, n in _RECORDS.items()]


def reset_collective_records() -> None:
    _RECORDS.clear()


def group_link(group) -> str:
    """``"nvlink"`` when every rank of ``group`` lies in one node of
    ``GPUS_PER_NODE`` GPUs, else ``"infiniband"``."""
    nodes = {r // GPUS_PER_NODE for r in dist.get_process_group_ranks(group)}
    return "nvlink" if len(nodes) == 1 else "infiniband"


def _record(op: str, operand: torch.Tensor, group) -> None:
    if not _recording:
        return
    link = _LINKS.get(group)
    if link is None:
        link = _LINKS[group] = group_link(group)
    key = (op, operand.numel() * operand.element_size(), dist.get_world_size(group), link)
    _RECORDS[key] = _RECORDS.get(key, 0) + 1


def _fake(group) -> bool:
    """Whether ``group`` is a fake process group (the dry run's)."""
    return str(dist.get_backend(group)) == "fake"


def stage_through_host(group) -> None:
    """Let the gloo ``group`` take CUDA tensors, staged through host memory
    (the explicit opt-in of ``make_host_mesh(..., host_collectives=True)``)."""
    if str(dist.get_backend(group)) != "gloo":
        raise ValueError(f"only a gloo group stages through the host, not {dist.get_backend(group)}")
    if not host_staged(group):
        _HOST_STAGED.append(group)


def host_staged(group) -> bool:
    """Whether ``group`` stages CUDA tensors through host memory (never
    after ``torch.distributed.destroy_process_group``)."""
    if not dist.is_initialized():
        _HOST_STAGED.clear()
    return any(g is group for g in _HOST_STAGED)


def _checked(group, *tensors: torch.Tensor):
    """``group``, after checking that its backend serves the tensors' device
    (NCCL for CUDA, gloo for the CPU, the fake backend for ``meta``; gloo
    also for CUDA on a group that :func:`stage_through_host` registered)."""
    backend = str(dist.get_backend(group))
    staged = host_staged(group)
    for t in tensors:
        want = _BACKEND_OF.get(t.device.type)
        if backend != want and not (staged and t.device.type == "cuda"):
            raise RuntimeError(f"a {t.device.type} tensor on a {backend} process group: "
                               f"{t.device.type} tensors take {want}")
    return group


def _host(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where ``group``'s backend reads it: a host copy of a CUDA
    tensor on a host-staged group, else ``t``."""
    return t.cpu() if t.is_cuda and host_staged(group) else t


def _group(mesh, axis: str, *tensors: torch.Tensor):
    """The process group of ``axis``, or None for an axis of size 1 on a
    mesh with no ranks."""
    if hasattr(mesh, "group"):
        return _checked(mesh.group(axis), *tensors)
    if mesh.shape[axis] > 1:
        raise ValueError(f"axis {axis!r} of size {mesh.shape[axis]} needs a process mesh "
                         "(launch.mesh.make_host_mesh)")
    return None


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    # a divisor on the operand's device: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which rounds differently from the division
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _exchange(send: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``send`` to group rank ``to`` and receive its like from group
    rank ``frm`` (one ``batch_isend_irecv`` pair)."""
    dev = send.device
    send = _host(send.contiguous(), group)
    recv = torch.empty_like(send)
    _count("batch_isend_irecv")
    _record("collective-permute", send, group)
    if _fake(group):  # the fake backend pairs no sends with receives (it moves nothing anyway)
        return recv
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(dev)


def htree_allreduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-reduce over ``axis`` in H-tree (butterfly) order.

    ``x`` is this rank's shard of an array whose leading dim is sharded
    over ``axis``; every shard receives the sum of all shards.  For
    power-of-two axis sizes the schedule is the log-depth pairwise exchange
    (adjacent pairs first — numerically the H-tree order:
    ``acc = acc + acc[rank ^ k]`` for k = 1, 2, 4, …); otherwise it falls
    back to ``all_reduce`` (JAX's ``psum``).  Integer sums wrap.
    """
    n = mesh.shape[axis]
    group = _group(mesh, axis, x)
    if n & (n - 1) == 0:
        acc = x
        if n > 1:
            i = dist.get_rank(group)
            k = 1
            while k < n:
                acc = acc + _exchange(acc, i ^ k, i ^ k, group)
                k *= 2
        return acc if n > 1 else acc.clone()
    out = x.clone()
    return all_reduce_(out, group)


def ring_allgather_matmul(a: torch.Tensor, w: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``a (M, K) @ w (K, N)`` with K sharded over ``axis``: ``a`` is this
    rank's (M, K/n) columns and ``w`` its (K/n, N) rows.  The partial
    products circulate the neighbor ring (rank i sends to i + 1), each
    received one added to the sum in JAX's order; the result is replicated
    over ``axis``."""
    n = mesh.shape[axis]
    group = _group(mesh, axis, a, w)
    part = torch.matmul(a, w)  # JAX's einsum, outside any kernel
    acc = part
    if n > 1:
        i = dist.get_rank(group)
        for _ in range(n - 1):
            part = _exchange(part, (i + 1) % n, (i - 1) % n, group)
            acc = acc + part
    return acc


def compressed_psum_with_feedback(
    g: torch.Tensor, err: torch.Tensor, mesh, axes: Tuple[str, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed mean-reduction of a (replicated-shape) gradient with
    error feedback: the quantization residual is returned and added to the
    next step's gradient, so compression error does not accumulate.

    ``x = g + err`` is scaled by ``max|x| / 127``, rounded half to even,
    clipped to ±127 and cast to int8; the dequantized values are summed over
    each axis of ``axes`` in turn and divided by their product.  Returns
    ``(reduced, new_err)``; ``|new_err| <= max|g + err| / 127``.
    """
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    x = g + err
    q, scale = quantize_int8(x)
    deq = q.to(torch.float32) * scale
    new_err = x - deq
    red = deq
    for a in axes:
        group = _group(mesh, a, red)
        if group is not None:
            red = all_reduce_(red.clone(), group)
    return red / _const(float(n), red), new_err


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, scale): ``x`` scaled by ``max|x| / 127`` (at least 1e-30 / 127),
    rounded half to even and clipped to ±127, as int8."""
    scale = torch.clamp(torch.amax(torch.abs(x)), min=1e-30) / _const(127.0, x)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def shuffle(x: torch.Tensor, mesh, axis: str, *, split_dim: int = 0) -> torch.Tensor:
    """All-to-all over ``axis``: transpose the (devices, chunks) layout —
    the MoE token-dispatch collective.  This rank's shard splits into n
    chunks along ``split_dim``, chunk j going to rank j; the chunks received
    are concatenated in rank order (JAX's tiled ``all_to_all``)."""
    group = _group(mesh, axis, x)
    xs = x.movedim(split_dim, 0).contiguous()
    if group is None:
        return xs.clone().movedim(0, split_dim)
    hx = _host(xs, group)
    out = torch.empty_like(hx)
    _count("all_to_all_single")
    _record("all-to-all", hx, group)
    dist.all_to_all_single(out, hx, group=group)
    return out.to(x.device).movedim(0, split_dim).contiguous()


# ---------------------------------------------------------------------------
# SPMD helpers on the data axes
# ---------------------------------------------------------------------------


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` over ``group`` in place by ``op`` (a sum by default;
    nothing without a group); returns ``x``."""
    if group is not None:
        _count("all_reduce")
        h = _host(x, _checked(group, x))
        _record("all-reduce", h, group)
        dist.all_reduce(h, op=op, group=group)
        if h is not x:
            x.copy_(h)
    return x


def all_gather_dim(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """The ``n`` ranks' shards of ``group`` concatenated along ``dim`` in
    rank order (a copy of ``x`` without a group)."""
    if group is None:
        return x.clone()
    h = _host(x.contiguous(), _checked(group, x))
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=h.device)
    _count("all_gather_into_tensor")
    _record("all-gather", h, group)
    dist.all_gather_into_tensor(out, h, group=group)
    out = out.to(x.device)
    return torch.cat(out.view(n, *x.shape).unbind(0), dim=dim) if dim else out


class _GatherRows(torch.autograd.Function):
    """The global rows, all-gathered; backward sums each rank's gradient of
    them over the group and keeps the rank's own rows."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return all_gather_dim(x, 0, shard.dp, shard.group)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        grad = all_reduce_(grad.contiguous().clone(), s.group)
        return grad[s.start:s.start + s.rows], None


def gather_rows(x: torch.Tensor, shard) -> torch.Tensor:
    """The global rows of a tensor whose leading dim this rank holds
    ``shard``'s slice of (the tensor itself when the batch is replicated).
    Autograd passes the gradient of the gathered rows back to the rank that
    holds them."""
    if not shard.sharded or shard.group is None:
        return x
    return _GatherRows.apply(x, shard)


def mean_over(x: torch.Tensor, shard: Optional[Any]) -> torch.Tensor:
    """The mean over the data shards of a value each rank computed from its
    rows (a sum over the group, then ``/ dp``); the value itself when every
    rank computed it from the whole batch."""
    if shard is None or not shard.sharded or shard.group is None:
        return x
    return all_reduce_(x.clone(), shard.group) / _const(float(shard.dp), x)


# ---------------------------------------------------------------------------
# Megatron's conjugates on the model axis
# ---------------------------------------------------------------------------
#
# ``ms`` is this rank's ``dist.sharding.ModelShard``; with none (a model axis
# of one) each is the identity.  A tensor is either replicated (every rank of
# the model axis holds the same values and, through these functions, gets
# the same gradient) or a rank's slice of a dim.


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ms):
        ctx.ms = ms
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.ms.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ms):
        return all_reduce_(x.contiguous().clone(), ms.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ms):
        ctx.dim, ctx.ms, ctx.size = dim, ms, x.shape[dim]
        return all_gather_dim(x, dim, ms.tp, ms.group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.ms.index * ctx.size, ctx.size), None, None


def copy_to_model(x: torch.Tensor, ms) -> torch.Tensor:
    """A replicated tensor entering a rank's slice of the work: the
    identity; its gradient, each rank's part, summed over the model axis."""
    if ms is None:
        return x
    _count("copy_to_model")
    return _CopyToModel.apply(x, ms)


def reduce_from_model(x: torch.Tensor, ms) -> torch.Tensor:
    """Each rank's partial sum, summed over the model axis (replicated);
    the gradient passes through to each rank's part."""
    if ms is None:
        return x
    _count("reduce_from_model")
    return _ReduceFromModel.apply(x, ms)


def gather_from_model(x: torch.Tensor, dim: int, ms) -> torch.Tensor:
    """Each rank's slice along ``dim``, concatenated in rank order
    (replicated); the gradient's own slice goes back to each rank."""
    if ms is None:
        return x
    _count("gather_from_model")
    return _GatherFromModel.apply(x, dim % x.dim(), ms)


def all_reduce_max(x: torch.Tensor, ms) -> torch.Tensor:
    """The elementwise max over the model axis (a row's quantization scale
    over its slices); carries no gradient."""
    if ms is None:
        return x
    _count("all_reduce_max")
    return all_reduce_(x.detach().contiguous().clone(), ms.group, op=dist.ReduceOp.MAX)
