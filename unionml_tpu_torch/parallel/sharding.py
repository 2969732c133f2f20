"""Sharding strategies: one mesh, named axes, partition rules.

The port of :mod:`unionml_tpu.parallel.sharding` on DTensor. The
vocabulary is the reference's: **dp** (batch rows over ``data``, the
gradient summed over it), **fsdp** (params and optimizer state sharded
over ``fsdp``, gathered where a product needs them whole), **tp**
(Megatron layouts from the partition rules over ``tensor``); ``sequence``,
``pipeline`` and ``expert`` are axes of the mesh whose strategies are
ported with sequence, pipeline and expert parallelism (ROADMAP.md, A6b).
A :class:`ShardingConfig` names the axis sizes, how batches shard and how
parameters partition, with the same regex rules and the same ``sanitize``
as the reference, so a rule set written for the JAX package means the
same placements here.

A JAX ``PartitionSpec`` becomes DTensor placements on the
:class:`~torch.distributed.device_mesh.DeviceMesh`: mesh dimension ``a``
is ``Shard(d)`` where the spec names ``a`` at tensor dimension ``d``, else
``Replicate()``. A tuple entry shards one dimension over several axes
jointly, in mesh order (the reference's rule sets list them in that
order). :func:`compile_step` then runs a ``(state, batch) -> (state,
metrics)`` step eagerly on the placed state: DTensor inserts the
collectives GSPMD inserts in the reference (a gradient's sum over the
batch axes, the gathers of sharded params), the gradients are brought to
their params' placements before the optimizer sees them
(:func:`resolve_grads`), and the kernel wrappers receive local shards
(:func:`~unionml_tpu_torch.parallel.compat.local_call`).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from unionml_tpu_torch.parallel.compat import is_dtensor
from unionml_tpu_torch.parallel.mesh import make_mesh, mesh_array, mesh_shape

# outermost -> innermost; axes that span hosts (pipeline, data) first
AXIS_ORDER = ("pipeline", "data", "fsdp", "expert", "sequence", "tensor")

__all__ = [
    "AXIS_ORDER",
    "NamedSharding",
    "PartitionRule",
    "PendingGrads",
    "PartitionSpec",
    "ShardingConfig",
    "compile_step",
    "gather_state",
    "local_slices",
    "named_sharding",
    "resolve_grads",
    "shard_pytree",
    "spec_placements",
    "state_shardings",
]


class PartitionSpec(tuple):
    """A tensor's layout over mesh axes, one entry per dimension: an axis
    name, a tuple of names, or ``None`` (whole); ``jax.sharding
    .PartitionSpec``'s tuple. Trailing dimensions left out are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class PartitionRule:
    """Regex over the '/'-joined parameter path -> PartitionSpec entries."""

    pattern: str
    spec: Tuple[Any, ...]

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


def spec_placements(mesh: Any, spec: Any, ndim: int) -> List[Any]:
    """DTensor placements on ``mesh`` for a tensor of ``ndim`` dimensions
    laid out by ``spec`` (see the module docstring)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    placements: List[Any] = [Replicate() for _ in names]
    for d, entry in enumerate(tuple(spec or ())[:ndim]):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name not in names:
                raise ValueError(f"spec {spec} names axis {name!r}, not in the mesh {names}")
            i = names.index(name)
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"spec {spec} shards two dimensions over axis {name!r}")
            placements[i] = Shard(d)
    return placements


def local_slices(shape: Sequence[int], mesh: Any, placements: Sequence[Any]) -> Tuple[slice, ...]:
    """This rank's block of a tensor of global ``shape`` under
    ``placements``: each ``Shard(d)``, in mesh order, cuts dimension ``d``
    of the block so far into that mesh dimension's size of chunks
    (``torch.chunk``'s sizes) and keeps this rank's."""
    from torch.distributed.tensor import Shard

    bounds = [[0, int(n)] for n in shape]
    coord = mesh.get_coordinate()
    for i, placement in enumerate(placements):
        if not isinstance(placement, Shard):
            continue
        lo, hi = bounds[placement.dim]
        k = mesh.size(i)
        chunk = -(-(hi - lo) // k)
        start = min(lo + coord[i] * chunk, hi)
        bounds[placement.dim] = [start, min(start + chunk, hi)]
    return tuple(slice(lo, hi) for lo, hi in bounds)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a :class:`PartitionSpec` (``jax.sharding.NamedSharding``);
    :meth:`placements` gives the DTensor placements for a rank."""

    mesh: Any
    spec: PartitionSpec

    def placements(self, ndim: int) -> List[Any]:
        return spec_placements(self.mesh, self.spec, ndim)


@dataclass
class ShardingConfig:
    """Declarative parallelism config attached to ``@model.train_step``.

    Axis sizes multiply to the rank count; ``data=-1`` absorbs the
    remainder. ``rules`` map parameter paths to PartitionSpecs (tensor
    parallelism); unmatched parameters fall back to FSDP sharding of their
    largest divisible dimension when ``fsdp > 1``, else replication.
    ``devices`` are the ranks to build the mesh over (default: every rank
    of the default process group)."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    pipeline: int = 1
    expert: int = 1
    rules: Sequence[PartitionRule] = ()
    batch_spec: Optional[Tuple[Any, ...]] = None  # default: dim0 over (data, fsdp)
    devices: Optional[Sequence[Any]] = None
    dcn_axes: Optional[Dict[str, int]] = None

    _mesh: Any = field(default=None, repr=False, compare=False)

    def axis_sizes(self) -> Dict[str, int]:
        sizes = {name: getattr(self, name) for name in AXIS_ORDER}
        # keep axes that are inferred (-1) or used (>1); always keep data
        return {k: v for k, v in sizes.items() if v == -1 or v > 1 or k == "data"}

    def mesh(self):
        if self._mesh is None:
            self._mesh = make_mesh(self.axis_sizes(), devices=self.devices,
                                   dcn_axes=self.dcn_axes)
        return self._mesh

    def mesh_shape(self) -> Dict[str, int]:
        """``{axis: size}`` of the mesh, resolved without building it when
        ``devices`` is given (so rules can be checked with no process
        group)."""
        if self._mesh is not None:
            return mesh_shape(self._mesh)
        axes, _ = mesh_array(self.axis_sizes(), devices=self.devices, dcn_axes=self.dcn_axes)
        return axes

    # -- batch sharding ------------------------------------------------- #

    def _batch_axes(self):
        axes = [a for a in ("data", "fsdp") if a in self.axis_sizes()]
        return tuple(axes) if len(axes) > 1 else axes[0] if axes else None

    def batch_pspec(self) -> PartitionSpec:
        if self.batch_spec is not None:
            return P(*self.batch_spec)
        return P(self._batch_axes())

    def batch_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh(), self.batch_pspec())

    def microbatched(self) -> "ShardingConfig":
        """Copy whose batch spec carries a leading UNSHARDED microbatch
        axis (gradient accumulation: batches are ``[n_micro, batch, ...]``;
        the microbatch axis stays whole on every rank, the batch axis keeps
        the data / fsdp sharding)."""
        if self.batch_spec is not None:
            spec = (None,) + tuple(self.batch_spec)
        else:
            spec = (None, self._batch_axes())
        return dataclasses.replace(self, batch_spec=spec)

    # -- parameter sharding --------------------------------------------- #

    def param_pspec(self, path: str, leaf: Any) -> PartitionSpec:
        shape = tuple(getattr(leaf, "shape", ()))
        mesh_axes = self.mesh_shape()

        def sanitize(entry, dim_size):
            # drop axes absent from the mesh (e.g. tensor=1 configs) or that
            # the dim cannot divide (e.g. GQA kv heads < tensor); tuple
            # entries shard one dim over several axes jointly
            axes = entry if isinstance(entry, tuple) else (entry,)
            kept, divisor = [], 1
            for a in axes:
                if a in mesh_axes and dim_size % (divisor * mesh_axes[a]) == 0:
                    kept.append(a)
                    divisor *= mesh_axes[a]
            if not kept:
                return None
            return tuple(kept) if isinstance(entry, tuple) else kept[0]

        for rule in self.rules:
            if rule.matches(path):
                return P(*[
                    sanitize(entry, shape[i]) if entry is not None and i < len(shape) else None
                    for i, entry in enumerate(rule.spec)
                ])
        if self.fsdp > 1 and shape:
            # FSDP fallback: shard the largest divisible axis
            candidates = [(n, i) for i, n in enumerate(shape) if n % self.fsdp == 0]
            if candidates:
                _, dim = max(candidates)
                spec: List[Any] = [None] * len(shape)
                spec[dim] = "fsdp"
                return P(*spec)
        return P()

    def state_shardings(self, state: Any) -> Any:
        """``state``'s tree with a :class:`NamedSharding` in place of each
        tensor (other leaves kept)."""
        mesh = self.mesh()
        return _map_with_path(
            lambda path, leaf: NamedSharding(mesh, self.param_pspec(path, leaf))
            if isinstance(leaf, torch.Tensor) else leaf,
            state,
        )


# --------------------------------------------------------------------- #
# state trees with paths
# --------------------------------------------------------------------- #


def _state_fields(state: Any) -> Optional[Dict[str, Any]]:
    """The data fields of a train state (its ``state_dict()`` keys: step,
    params, opt_state, a LoRA state's frozen_params), or None for a plain
    tree."""
    if dataclasses.is_dataclass(state) and hasattr(state, "state_dict"):
        return state.state_dict()
    return None


def _map_tree(fn: Callable, tree: Any, prefix: str) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_tree(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _map_with_path(fn: Callable, state: Any) -> Any:
    """``fn(path, leaf)`` over a state's leaves, paths '/'-joined as the
    reference's ``_path_str`` (``params/block_0/attn/q/kernel``); a train
    state maps field by field and comes back as the same dataclass."""
    fields = _state_fields(state)
    if fields is None:
        return _map_tree(fn, state, "")
    mapped = {k: _map_tree(fn, v, f"{k}/") for k, v in fields.items()}
    return dataclasses.replace(state, **mapped)


def _map_pairs(fn: Callable, state: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over corresponding leaves of ``state`` and
    ``other`` (trees, or train states, of one structure); ``state``'s
    structure and non-leaf fields kept."""
    from unionml_tpu_torch.models.train import tree_leaves

    fields = _state_fields(other)
    others = iter(tree_leaves(fields if fields is not None else other))
    return _map_with_path(lambda path, leaf: fn(leaf, next(others)), state)


def gather_state(state: Any) -> Any:
    """``state`` with every DTensor replaced by its whole value, a plain
    tensor on this rank's device (every rank calls it: it gathers)."""
    return _map_with_path(lambda path, leaf: leaf.full_tensor() if is_dtensor(leaf) else leaf,
                          state)


def named_sharding(mesh: Any, *spec: Any) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*spec))


def state_shardings(config: ShardingConfig, state: Any) -> Any:
    return config.state_shardings(state)


def _mesh_device(mesh: Any) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _place(t: torch.Tensor, sharding: NamedSharding) -> Any:
    """A DTensor of ``t``'s global value under ``sharding``, cut from the
    copy every rank holds (no collective): this rank's block, copied."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    placements = sharding.placements(t.dim())
    if is_dtensor(t):
        return t if tuple(t.placements) == tuple(placements) \
            else t.redistribute(mesh, placements)
    local = t.detach()[local_slices(t.shape, mesh, placements)]
    local = local.to(_mesh_device(mesh)).clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=_contiguous_stride(t.shape))


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def shard_pytree(state: Any, config: ShardingConfig) -> Any:
    """Place a state (or tree) on the config's mesh per its partition
    rules: every tensor becomes a DTensor holding this rank's block."""
    return _constrain(state, config.state_shardings(state))


def _constrain(state: Any, shardings: Any) -> Any:
    """Every tensor of ``state`` at its sharding in ``shardings`` (the same
    structure): plain tensors placed, DTensors redistributed if they
    differ."""
    return _map_pairs(lambda leaf, sh: _place(leaf, sh) if isinstance(leaf, torch.Tensor)
                      else leaf, state, shardings)


class PendingGrads:
    """The reduction of a gradient tree, issued: for each DTensor gradient
    that differs from its param's placements, the sum over its first
    ``Partial`` mesh dim is in flight (an asynchronous all-gather). The
    sums run in rank order (:func:`~unionml_tpu_torch.parallel.collectives
    .ordered_sum`), so the result does not depend on when it is waited
    for. :meth:`wait` finishes every sum (a second ``Partial`` dim
    synchronously), cuts each gradient to a sharded param's block and
    returns the tree."""

    def __init__(self, params: Any, grads: Any):
        from torch.distributed.tensor import Partial

        from unionml_tpu_torch.models.train import tree_leaves
        from unionml_tpu_torch.parallel.collectives import _Gathered

        self._like = grads
        self._items = []
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            gathered = dims = None
            if is_dtensor(g) and is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
                dims = [i for i, pl in enumerate(g.placements) if isinstance(pl, Partial)]
                if dims:
                    gathered = _Gathered(g.to_local(), g.device_mesh.get_group(dims[0]),
                                         async_op=True)
            self._items.append((p, g, dims, gathered))

    def wait(self) -> Any:
        from torch.distributed.tensor import DTensor, Replicate

        from unionml_tpu_torch.models.train import tree_unflatten
        from unionml_tpu_torch.parallel.collectives import ordered_sum

        out = []
        for p, g, dims, gathered in self._items:
            if dims:
                mesh = g.device_mesh
                placements = list(g.placements)
                local = gathered.wait()
                for n, i in enumerate(dims):
                    if n:
                        local = ordered_sum(local, mesh.get_group(i))
                    op = placements[i].reduce_op
                    if op == "avg":
                        local = local / mesh.size(i)
                    elif op != "sum":
                        raise NotImplementedError(f"a gradient with a Partial({op}) placement")
                    placements[i] = Replicate()
                g = DTensor.from_local(local, mesh, placements, run_check=False, shape=g.shape,
                                       stride=g.stride())
            if dims is not None and tuple(g.placements) != tuple(p.placements):
                g = g.redistribute(p.device_mesh, p.placements)
            out.append(g)
        return tree_unflatten(self._like, out)


def resolve_grads(params: Any, grads: Any) -> Any:
    """Each DTensor gradient brought to its param's placements: a
    ``Partial`` sum over the batch axes is reduced here, in rank order
    (deterministic, so the serial and the overlapped steps agree bit for
    bit), then cut to a sharded param's block. The optimizer only ever
    sees gradients laid out as their params. (:class:`PendingGrads` is
    the same reduction, waited for later.)"""
    return PendingGrads(params, grads).wait()


def place_batch(batch: Any, sharding: NamedSharding) -> Any:
    """A batch tree as DTensors under the batch sharding: DTensors are
    redistributed if they differ; plain tensors / arrays are global values
    every rank holds, cut to this rank's rows."""
    import numpy as np

    from unionml_tpu_torch.models.train import tree_map

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            if not hasattr(x, "__array__"):
                return x
            x = torch.as_tensor(np.asarray(x))
        return _place(x, sharding)

    return tree_map(leaf, batch)


def _donate(placed: Any, new: Any) -> Any:
    """``new``'s values written into ``placed``'s tensors in place (the
    donated state's memory is updated) and ``placed``'s tensor objects
    kept; every other leaf and field (the step counters, the apply
    function) comes from ``new``."""
    def write(old, fresh):
        if not isinstance(old, torch.Tensor) or not isinstance(fresh, torch.Tensor):
            return fresh
        if fresh is not old:
            with torch.no_grad():
                dst = old.to_local() if is_dtensor(old) else old
                dst.copy_(fresh.to_local() if is_dtensor(fresh) else fresh)
        return old

    kept = _map_pairs(write, placed, new)
    fields = _state_fields(new)
    if fields is None:
        return kept
    return dataclasses.replace(new, **{k: getattr(kept, k) for k in fields})


def compile_step(
    step_fn: Callable,
    state: Any,
    *,
    sharding: ShardingConfig,
    donate_state: bool = True,
    donate_batch: bool = False,
) -> Tuple[Callable, Any]:
    """Run ``step_fn(state, batch) -> (state, metrics)`` over the mesh.

    Returns ``(step, placed_state)``: the state placed once per the
    partition rules (:func:`shard_pytree`), and a step that places the
    batch by :meth:`ShardingConfig.batch_pspec`, runs ``step_fn`` eagerly
    on DTensors (plain tensors the step makes, masks and rotary tables,
    join as replicated values), returns the state at its placements and
    the metrics replicated (plain tensors, the same on every rank). A
    gradient left ``Partial`` by the backward is resolved to its param's
    placement inside the train step (:func:`resolve_grads`), never by the
    optimizer. ``donate_state`` writes each new state tensor into the
    placed state's memory, so the state is updated in place;
    ``donate_batch`` drops the step's reference to the batch once it is
    placed (eager PyTorch frees a buffer when its last reference goes)."""
    from torch.distributed.tensor.experimental import implicit_replication

    shardings = sharding.state_shardings(state)
    placed = _constrain(state, shardings)
    batch_sharding = sharding.batch_sharding()
    del donate_batch  # the fed batch is referenced by the caller only

    def step(state: Any, batch: Any):
        batch = place_batch(batch, batch_sharding)
        with implicit_replication():
            new_state, metrics = step_fn(state, batch)
        new_state = _constrain(new_state, shardings)
        if donate_state:
            new_state = _donate(state, new_state)
        return new_state, gather_state(metrics)

    return step, placed
