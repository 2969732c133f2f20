"""Local-shard execution over a mesh: the port's ``shard_map``.

The port of :mod:`unionml_tpu.parallel.compat`. ``jax.shard_map`` runs a
function on each device's block of its inputs with the mesh axes bound,
so the function's collectives name axes. Here :func:`shard_map` does the
same on ``torch.distributed``: every rank takes the local shards of its
inputs (a DTensor is first redistributed to the spec's placements; a
plain tensor holding the global value is cut to this rank's block),
runs the function on plain tensors with the mesh bound, so the
collectives of :mod:`~unionml_tpu_torch.parallel.collectives` find each
axis's process group, and wraps the outputs back as DTensors by
``out_specs``. The to_local / from_local pair is differentiable, so
autograd crosses the boundary with the reference's transpose
(``shard_map(check_vma=False)``): an output replicated over a mesh axis
(its spec leaves the axis out) passes each rank ``1/n`` of its cotangent,
and an input's gradient is ``Partial`` (a sum still to take) over every
axis its spec leaves out; with the backward of
:func:`~unionml_tpu_torch.parallel.collectives.psum` a psum, every
gradient is the serial one. An input that was a plain tensor needing a
gradient enters as the global value every rank holds and gets the whole
gradient back.

:func:`local_call` is the same boundary for one call on DTensors whose
placements the caller has already checked: the kernel wrappers take
plain local tensors only, and the layers reach them through it.
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
from typing import Any, Callable, Optional, Sequence

__all__ = [
    "axis_size",
    "bound_mesh",
    "checkpoint_context_fn",
    "is_dtensor",
    "local_call",
    "refuse_dtensor",
    "shard_map",
]

_MESH: contextvars.ContextVar = contextvars.ContextVar("unionml_torch_mesh", default=None)


def is_dtensor(x: Any) -> bool:
    """True for a :class:`torch.distributed.tensor.DTensor` (without
    importing the DTensor package when nothing has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def refuse_dtensor(name: str, *tensors: Any) -> None:
    """Raise ``TypeError`` when a kernel wrapper is handed a DTensor: the
    kernels read raw pointers, which must be a rank's local shard (the
    layers cross through :func:`local_call`)."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            f"{name} takes local shards, not DTensors: call it through "
            "unionml_tpu_torch.parallel.compat.local_call (the model layers do)"
        )


@contextlib.contextmanager
def _mesh_scope(mesh: Any):
    """Bind ``mesh``'s axis names for the collectives run inside."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def checkpoint_context_fn() -> Callable:
    """A ``context_fn`` for non-reentrant ``torch.utils.checkpoint``: the
    recomputation in the backward runs with the mesh the forward had bound
    (a recomputed ring or all-to-all finds its axes; the backward runs
    outside the forward's :func:`shard_map`)."""
    mesh = _MESH.get()

    def contexts():
        recompute = _mesh_scope(mesh) if mesh is not None else contextlib.nullcontext()
        return contextlib.nullcontext(), recompute

    return contexts


def bound_mesh() -> Any:
    """The mesh bound by the innermost :func:`shard_map`;
    raises outside one (an axis name means nothing there)."""
    mesh = _MESH.get()
    if mesh is None:
        raise NameError("no mesh axis is bound here: call inside shard_map(...)")
    return mesh


def _axes(axis: Any) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def axis_size(axis: Any) -> int:
    """Size of a bound mesh axis (or the product over a tuple of axes)."""
    mesh = bound_mesh()
    size = 1
    for name in _axes(axis):
        size *= mesh.size(mesh.mesh_dim_names.index(name))
    return size


def _with_specs(fn: Callable, x: Any, spec: Any) -> Any:
    """``fn(tensor, spec)`` over ``x``'s tensors, ``spec`` a prefix of
    ``x``'s tree: a PartitionSpec (or None) covers every tensor below it,
    a tuple of specs pairs with a tuple / list of subtrees."""
    import torch

    from unionml_tpu_torch.models.train import tree_map
    from unionml_tpu_torch.parallel.sharding import PartitionSpec

    if spec is None or isinstance(spec, PartitionSpec):
        return tree_map(lambda t: fn(t, spec) if isinstance(t, torch.Tensor) else t, x)
    if not isinstance(x, (tuple, list)) or len(x) != len(spec):
        raise ValueError(f"specs {spec!r} do not match the structure of {type(x).__name__}")
    return type(x)(_with_specs(fn, a, s) for a, s in zip(x, spec))


def _local_in(t: Any, mesh: Any, spec: Any) -> Any:
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from unionml_tpu_torch.parallel.sharding import local_slices, spec_placements

    placements = spec_placements(mesh, spec, t.dim())
    if not is_dtensor(t):
        if not (torch.is_grad_enabled() and t.requires_grad):
            return t[local_slices(t.shape, mesh, placements)]
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(mesh, placements)
    return t.to_local(grad_placements=[Partial() if isinstance(p, Replicate) else p
                                       for p in placements])


def _global_out(t: Any, mesh: Any, spec: Any) -> Any:
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from unionml_tpu_torch.parallel import collectives
    from unionml_tpu_torch.parallel.sharding import spec_placements

    placements = spec_placements(mesh, spec, t.dim())
    if torch.is_grad_enabled() and t.requires_grad:
        # an output replicated over an axis: each of its ranks holds the
        # whole value, so each takes 1/n of its cotangent (the reference's
        # transpose; the backward of the body's psum sums the shares)
        n = 1
        for i, p in enumerate(placements):
            if isinstance(p, Replicate):
                n *= mesh.size(i)
        if n > 1:
            t = collectives.scale_grad(t, 1.0 / n)
    return DTensor.from_local(t, mesh, placements, run_check=False)


def shard_map(
    f: Callable,
    mesh: Any = None,
    *,
    in_specs: Any,
    out_specs: Any,
    check_vma: Optional[bool] = None,
    check_rep: Optional[bool] = None,
) -> Callable:
    """``f`` run on each rank's local shards (see the module docstring).

    ``in_specs``: one :class:`~unionml_tpu_torch.parallel.sharding
    .PartitionSpec` for every argument, or one per argument (each applying
    to every tensor of that argument's tree); ``out_specs`` likewise for
    the outputs (a tuple of outputs takes one per element). Axes a spec
    leaves out are replicated. The replication-check flag is accepted
    under either of the reference's names (passing both is an error) and
    has nothing to check here: eager ranks have no replication types."""
    if check_vma is not None and check_rep is not None:
        raise ValueError(
            "pass only one of check_vma/check_rep (they are the same flag under "
            "different JAX versions)"
        )
    if mesh is None:
        raise ValueError("shard_map needs a mesh")

    def mapped(*args):
        local = _with_specs(lambda t, s: _local_in(t, mesh, s), tuple(args), in_specs)
        with _mesh_scope(mesh):
            out = f(*local)
        return _with_specs(lambda t, s: _global_out(t, mesh, s), out, out_specs)

    return mapped


def local_call(
    fn: Callable,
    args: Sequence[Any],
    grad_placements: Sequence[Any],
    out_placements: Any,
    mesh: Any,
) -> Any:
    """``fn`` on the local tensors of DTensor ``args`` (other arguments
    pass through), its tensor outputs wrapped back as DTensors with
    ``out_placements`` (one sequence, or one per output of a tuple). Each
    DTensor argument must already hold the placements ``fn`` needs;
    ``grad_placements[i]`` states how its local gradient relates to the
    global one (``Partial`` where each rank holds a share of a sum)."""
    from torch.distributed.tensor import DTensor

    local = [a.to_local(grad_placements=g) if is_dtensor(a) else a
             for a, g in zip(args, grad_placements)]
    out = fn(*local)

    def wrap(t, placements):
        return DTensor.from_local(t, mesh, placements, run_check=False)

    if isinstance(out, tuple):
        return tuple(wrap(t, p) for t, p in zip(out, out_placements))
    return wrap(out, out_placements)
