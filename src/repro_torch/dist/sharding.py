"""Sharding rules of the PyTorch port: param / activation / cache partition
specs with fallbacks, the port's copy of the JAX package's
``dist/sharding.py``.

The mesh is ("data", "model") (optionally a leading "pod" axis).  "model" is
the intra-pod H-tree analogue — tensor-parallel reductions stay on it; the
data axes carry only batch parallelism (PIMSAB's inter-tile rule: no
cross-tile partial-sum reduction).

Every rule has a *divisibility fallback*: a dimension that does not divide
the axis size replicates instead (recorded in ``MeshRules.decisions`` so the
dry-run can report what the planner actually did).  All emitted specs are
full-rank (one entry per dim) so tests can assert them structurally.  Trees
are visited in sorted key order, ``jax.tree_util``'s order for dicts, so the
decision log grows in the JAX package's order.

The port runs SPMD: each rank holds its shard, so :func:`constrain` is the
identity, and the batch is split where it enters a step
(:func:`batch_shard`).  On a "model" axis wider than one each rank holds its
slices of the leaves the specs shard (:func:`shard_params`,
:func:`gather_params`) and the model runs them tensor-parallel
(:class:`ModelShard`).  :class:`P` is the port's ``PartitionSpec``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def _canonical(entry: Any) -> Any:
    """A spec entry as JAX keeps it: a list becomes a tuple, a tuple of one
    axis that axis."""
    if isinstance(entry, (list, tuple)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


class P:
    """A partition spec: one entry per dim — ``None`` (replicated), an axis
    name, or a tuple of axis names — with ``jax.sharding.PartitionSpec``'s
    equality (against a ``P`` or a tuple), iteration and ``repr``."""

    __slots__ = ("_partitions",)

    def __init__(self, *partitions: Any):
        self._partitions = tuple(_canonical(p) for p in partitions)

    def __iter__(self):
        return iter(self._partitions)

    def __len__(self) -> int:
        return len(self._partitions)

    def __getitem__(self, i):
        return self._partitions[i]

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, P):
            return self._partitions == other._partitions
        if isinstance(other, tuple):
            return self._partitions == tuple(_canonical(o) for o in other)
        return False

    def __hash__(self) -> int:
        return hash(self._partitions)

    def __repr__(self) -> str:
        return f"PartitionSpec({repr(self._partitions)[1:-1]})"


@dataclass
class MeshRules:
    """Mesh + axis roles + the decision log of the sharding planner.

    ``mesh`` only needs ``.shape`` (axis → size dict) and ``.axis_names``:
    test fakes, a mesh description with no ranks
    (``launch.mesh.make_production_mesh``) or a process mesh
    (``launch.mesh.make_host_mesh``), which also gives each axis's process
    group and this rank's coordinate and is the only kind a step runs on.
    """

    mesh: Any
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    decisions: List[str] = field(default_factory=list)

    @classmethod
    def from_mesh(cls, mesh) -> "MeshRules":
        """All non-"model" axes are data-parallel (e.g. ("pod", "data"))."""
        dp = tuple(a for a in mesh.axis_names if a != "model")
        return cls(mesh=mesh, dp_axes=dp)

    # -- axis sizes --
    @property
    def dp(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def tp(self) -> int:
        return self.mesh.shape.get(self.tp_axis, 1) if self.tp_axis in self.mesh.axis_names else 1

    # -- decisions --
    def note(self, msg: str) -> None:
        if msg not in self.decisions:
            self.decisions.append(msg)

    def batch_axes(self, batch: int) -> Optional[Tuple[str, ...]]:
        """Data axes for a batch dim, or None (replicate) when it can't divide."""
        if batch % self.dp == 0 and batch >= self.dp:
            return self.dp_axes
        self.note(f"batch={batch} replicated: not divisible by dp={self.dp}")
        return None

    def tp_if(self, size: int, what: str) -> Optional[str]:
        """"model" if ``size`` divides the TP axis cleanly, else None."""
        if self.tp > 1 and size % self.tp == 0:
            return self.tp_axis
        self.note(f"{what}={size} replicated: not divisible by tp={self.tp}")
        return None


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _rep(ndim: int) -> P:
    return P(*([None] * ndim))


def _tp_both(rules: MeshRules, semantic: int, dim: int, what: str) -> Optional[str]:
    """Shard only when the *semantic* count (heads/experts/d_ff) AND the
    actual tensor dim both divide tp — mixer blocks reuse linear-layer key
    names (w_up/w_down) at other widths, and an indivisible dim would fail
    to lower."""
    ax = rules.tp_if(semantic, what)
    if ax is not None and dim % rules.tp != 0:
        rules.note(f"{what}: dim={dim} !% tp={rules.tp}, replicated")
        return None
    return ax


def _matmul_leaf_spec(path: Tuple[str, ...], shape, cfg, rules: MeshRules) -> P:
    """Spec of one linear-layer weight leaf (``w`` or ``w_q``).

    Stacked block leaves carry a leading scan-group axis which never shards;
    the matmul dims follow the Megatron pattern: column-parallel in
    (wq/wk/wv, w_gate/w_up, embed), row-parallel out (wo, w_down), experts
    on the TP axis for MoE.
    """
    grouped = path[0] in ("blocks", "enc_blocks")
    ndim = len(shape)
    # {"w": ...} leaf-dicts name the layer one level up; raw leaves (the MoE
    # expert stacks) name it directly
    owner = path[-1]
    if owner in ("w", "w_q") and len(path) >= 2:
        owner = path[-2]

    def spec(*inner):
        inner = list(inner) + [None] * ((ndim - (1 if grouped else 0)) - len(inner))
        return P(*((None,) if grouped else ()), *inner)

    if owner == "embed":
        return P(_tp_both(rules, cfg.padded_vocab(), shape[0], "vocab"), None)
    if owner == "lm_head":
        return P(None, _tp_both(rules, cfg.padded_vocab(), shape[-1], "vocab"))
    if owner == "wq":
        return spec(None, _tp_both(rules, cfg.n_heads, shape[-1], "q_heads"))
    if owner in ("wk", "wv"):
        return spec(None, _tp_both(rules, cfg.n_kv_heads, shape[-1], "kv_heads"))
    if owner == "wo":
        return spec(_tp_both(rules, cfg.n_heads, shape[-2], "q_heads"), None)
    if owner in ("w_gate", "w_up"):
        if ndim - (1 if grouped else 0) == 3:  # MoE: (E, d, f) → shard experts
            return spec(_tp_both(rules, cfg.n_experts, shape[-3], "experts"), None, None)
        return spec(None, _tp_both(rules, cfg.d_ff, shape[-1], "d_ff"))
    if owner == "w_down":
        if ndim - (1 if grouped else 0) == 3:
            return spec(_tp_both(rules, cfg.n_experts, shape[-3], "experts"), None, None)
        return spec(_tp_both(rules, cfg.d_ff, shape[-2], "d_ff"), None)
    return _rep(ndim)


def param_specs(shapes: Any, cfg, rules: MeshRules) -> Any:
    """Spec tree mirroring a param tree (tensors, ``meta`` ones included).

    Linear leaf-dicts ({"w"| "w_q", ["w_scale"], ["b"]}) shard together:
    scale/bias follow the weight's output-dim entry.  Everything unrecognized
    (norm scales, recurrent mixers, adapters) replicates — safe on any mesh.
    """

    def visit(path: Tuple[str, ...], node) -> Any:
        if not isinstance(node, dict):
            return _matmul_leaf_spec(path, node.shape, cfg, rules)
        wkey = "w" if "w" in node else ("w_q" if "w_q" in node else None)
        if wkey is not None and hasattr(node[wkey], "shape"):
            wspec = _matmul_leaf_spec(path + (wkey,), node[wkey].shape, cfg, rules)
            out = {wkey: wspec}
            out_axis = tuple(wspec)[-1] if len(tuple(wspec)) else None
            for extra in ("w_scale", "b"):
                if extra in node:
                    nd = len(node[extra].shape)
                    out[extra] = P(*([None] * (nd - 1)), out_axis)
            for k in sorted(node):
                if k not in out:
                    out[k] = visit(path + (k,), node[k])
            return out
        return {k: visit(path + (k,), node[k]) for k in sorted(node)}

    return visit((), shapes)


# ---------------------------------------------------------------------------
# activation / cache specs
# ---------------------------------------------------------------------------


def act_spec(batch: int, rules: MeshRules) -> P:
    """(B, S, D) activations: batch over the data axes, rest replicated."""
    return P(rules.batch_axes(batch), None, None)


def constrain(x, rules: Optional[MeshRules], spec: Optional[P]):
    """The identity: a rank's tensor already is its shard of ``spec`` (JAX
    places a ``with_sharding_constraint`` here for GSPMD)."""
    return x


def cache_entry_spec(
    shape: Tuple[int, ...], cfg, rules: MeshRules, *, seq_shard_kv: bool = False
) -> P:
    """Spec for one decode-cache entry leaf (group axis already stripped).

    KV layout (B, T, H, hd) (+ (B, T, H) scales): heads shard on "model"
    when kv-heads divide tp; otherwise, with ``seq_shard_kv``, the sequence
    dim shards instead (ring-attention-style distributed decode); otherwise
    replicate everything but batch.  Recurrent states (B, W): batch only.
    """
    ndim = len(shape)
    parts: List[Any] = [None] * ndim
    if ndim >= 1:
        parts[0] = rules.batch_axes(shape[0])
    if ndim >= 3:
        # dim 2 is the kv-head axis on 4D kv and 3D scale entries
        if rules.tp > 1 and cfg.n_kv_heads % rules.tp == 0 and shape[2] == cfg.n_kv_heads:
            parts[2] = rules.tp_axis
        elif seq_shard_kv and rules.tp > 1 and shape[1] % rules.tp == 0:
            parts[1] = rules.tp_axis
            rules.note(
                f"kv_heads={cfg.n_kv_heads} !% tp={rules.tp}: sequence-sharded KV cache"
            )
    return P(*parts)


# ---------------------------------------------------------------------------
# the SPMD side: this rank on the data axes
# ---------------------------------------------------------------------------


def data_group(rules: MeshRules):
    """The process group over the data axes, or None on a mesh with no ranks
    and one data shard; a mesh with no ranks and more data shards describes
    a layout and cannot run a step (ValueError)."""
    if hasattr(rules.mesh, "group"):
        return rules.mesh.group(rules.dp_axes)
    if rules.dp > 1:
        raise ValueError(f"a mesh with no process groups cannot run {rules.dp} data shards; "
                         "build one with launch.mesh.make_host_mesh")
    return None


def data_index(rules: MeshRules) -> int:
    """This rank's coordinate on the data axes (0 on a mesh with no ranks)."""
    return rules.mesh.coordinate(rules.dp_axes) if hasattr(rules.mesh, "coordinate") else 0


def model_group(rules: MeshRules):
    """The process group of the model axis, or None on a mesh with no ranks
    and one model shard; a mesh with no ranks and more model shards
    describes a layout and cannot run a step (ValueError)."""
    if hasattr(rules.mesh, "group"):
        return rules.mesh.group(rules.tp_axis)
    if rules.tp > 1:
        raise ValueError(f"a mesh with no process groups cannot run {rules.tp} model shards; "
                         "build one with launch.mesh.make_host_mesh")
    return None


def model_index(rules: MeshRules) -> int:
    """This rank's coordinate on the model axis (0 on a mesh with no ranks)."""
    return rules.mesh.coordinate(rules.tp_axis) if hasattr(rules.mesh, "coordinate") else 0


@dataclass(frozen=True)
class BatchShard:
    """This rank's rows of a global batch of ``batch`` rows: rows
    ``[start, start + rows)`` when the batch splits over the ``dp`` data
    shards, all of them when it is replicated (``sharded`` false)."""

    batch: int
    dp: int
    index: int
    sharded: bool
    group: Any

    @property
    def rows(self) -> int:
        return self.batch // self.dp if self.sharded else self.batch

    @property
    def start(self) -> int:
        return self.index * self.rows if self.sharded else 0

    def take(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of every entry of a batch dict (leading dim B)."""
        return {k: v[self.start:self.start + self.rows] for k, v in batch.items()}


def batch_shard(rules: MeshRules, batch: int) -> BatchShard:
    """Where this rank's rows of a ``batch``-row global batch lie, by
    :meth:`MeshRules.batch_axes` (whose fallback it notes)."""
    sharded = rules.batch_axes(batch) is not None
    return BatchShard(batch, rules.dp, data_index(rules), sharded, data_group(rules))


@dataclass(frozen=True)
class ModelShard:
    """This rank's place on a model axis of ``tp`` > 1 ranks: its
    coordinate ``index`` and the axis's process group.  A dim that the specs
    shard on "model" is cut into ``tp`` contiguous slices, the rank holding
    slice ``index``."""

    tp: int
    index: int
    group: Any

    def start(self, size: int) -> int:
        """Where this rank's slice of a dim of global ``size`` starts."""
        return self.index * (size // self.tp)


def model_shard(rules: Optional[MeshRules]) -> Optional[ModelShard]:
    """This rank's :class:`ModelShard` under ``rules``, None without rules or
    on a model axis of one."""
    if rules is None or rules.tp == 1:
        return None
    return ModelShard(rules.tp, model_index(rules), model_group(rules))


def _axis_dims(spec: P, rules: MeshRules):
    """(dim, n, index, group) of each dim ``spec`` shards: the model axis or
    the data axes."""
    dp = P(rules.dp_axes)[0]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        if ax == rules.tp_axis:
            yield d, rules.tp, model_index(rules), model_group(rules)
        elif ax == dp:
            yield d, rules.dp, data_index(rules), data_group(rules)
        else:
            raise ValueError(f"spec {spec} shards on {ax!r}, neither the model axis nor the data axes")


def shard_leaf(x, spec: P, rules: MeshRules):
    """This rank's slice of the global leaf ``x`` by ``spec`` (a copy; ``x``
    itself when the spec shards nothing)."""
    out = x
    for d, n, i, _ in _axis_dims(spec, rules):
        c = x.shape[d] // n
        out = out.narrow(d, i * c, c)
    return x if out is x else out.clone()


def gather_leaf(x, spec: P, rules: MeshRules):
    """The global leaf of which every rank holds ``x``, its slice of
    ``spec`` (``x`` itself when the spec shards nothing)."""
    from repro_torch.dist import collectives

    for d, n, _, group in _axis_dims(spec, rules):
        x = collectives.all_gather_dim(x, d, n, group)
    return x


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_params(tree: Any, cfg, rules: MeshRules) -> Any:
    """This rank's slices of a global parameter tree (the model's or its
    serving form) by :func:`param_specs`."""
    return _map_specs(lambda x, sp: shard_leaf(x, sp, rules), tree, param_specs(tree, cfg, rules))


def _quantized(tree: Any) -> bool:
    """Whether a parameter tree is the serving form (int8 weights)."""
    if isinstance(tree, dict):
        return any(_quantized(v) for v in tree.values())
    return str(tree.dtype) == "torch.int8"


def gather_params(tree: Any, cfg, rules: MeshRules) -> Any:
    """The global parameter tree from every rank's :func:`shard_params`, by
    the :func:`param_specs` of the global shapes (the model's parameters, or
    their serving form when ``tree`` holds int8 weights), since a rank holds
    only its slices."""
    from repro_torch.models import common, transformer

    shapes = transformer.params_shape(cfg)
    if _quantized(tree):
        shapes = common.maybe_quantize_tree(shapes, cfg)
    return _map_specs(lambda x, sp: gather_leaf(x, sp, rules), tree, param_specs(shapes, cfg, rules))
