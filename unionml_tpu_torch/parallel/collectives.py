"""Named collectives for functions run under :func:`shard_map`.

The port of :mod:`unionml_tpu.parallel.collectives` on
``torch.distributed``: inside :func:`~unionml_tpu_torch.parallel.compat
.shard_map` an axis name resolves to that mesh dimension's process group
(NCCL on the card, gloo on the CPU), and each wrapper issues one
collective on it over local tensors. :func:`bucketed_psum` issues one
asynchronous ``all_reduce`` per byte-bounded bucket of a gradient tree
and can hand back the pending handles, so the overlapped accumulation
waits for microbatch *i*'s sums only where it consumes them, during
microbatch *i + 1*. Every collective issued counts in :data:`COLLECTIVES`.
:func:`psum`, :func:`bucketed_psum`, :func:`all_gather` and
:func:`reduce_scatter` also take a tuple of axes: they run over the
product of those axes, its blocks in ``lax``'s order (row-major in the
tuple's order), through each axis's own group in turn.

Sums are deterministic: a psum gathers every rank's block and adds them
in rank order (:func:`ordered_sum`), so an element's sum does not depend
on the size of the buffer it travelled in (a ring all-reduce adds each
chunk starting from another rank). That is what makes a bucketed psum bit
for bit the leaf-wise one, and the explicit data-axis reduction of the
overlapped accumulation bit for bit the serial step's
(:func:`~unionml_tpu_torch.parallel.sharding.resolve_grads` reduces with
it too). The price is an all-gather's traffic instead of an all-reduce's.

:func:`psum`, :func:`pmean`, :func:`ppermute_shift` and :func:`all_to_all`
are differentiable (``torch.autograd.Function``), each backward the
transpose ``jax.grad`` takes through the same collective under the
reference's ``shard_map(check_vma=False)``:

- ``ppermute_shift`` by ``+shift`` goes back by ``-shift``;
- a tiled ``all_to_all(split, concat)`` goes back as ``all_to_all(concat,
  split)``;
- ``psum`` goes back as a ``psum`` of the cotangents (``pmean`` divided by
  the axis size). It pairs with :func:`~unionml_tpu_torch.parallel.compat
  .shard_map`, which divides the cotangent of an output replicated over an
  axis by that axis's size and sums the gradient of an input replicated
  over it: at every replicating call site (the sequence-parallel loss's
  token sums and MoE fractions, the pipeline's final psum of the last
  stage's outputs, the expert-parallel aux loss) each rank's share then
  receives the whole cotangent once, not ``n`` times it. The parameters a
  body sees replicated get exactly one reduction, where they leave the
  shard_map (their gradient ``Partial`` over the axes the spec leaves
  out, summed in rank order by :func:`~unionml_tpu_torch.parallel.sharding
  .resolve_grads`).
- :func:`psum_invariant` / :func:`pmean_invariant` are the sums of a
  DTensor local call (:func:`~unionml_tpu_torch.parallel.compat
  .local_call`), whose replicated output's cotangent arrives whole on every
  rank undivided: their backward passes each rank's cotangent through (the
  MoE block's output over the expert-weight axes and its routing fractions
  over the batch axes).

The ranks' backward graphs are the same, so they issue their collectives
in the same order; the process group's timeout bounds every wait.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Sequence, Union

import torch
import torch.distributed as dist

from unionml_tpu_torch.parallel import compat

AxisName = Union[str, Sequence[str]]

#: Default all-reduce bucket size for :func:`bucketed_psum` (the
#: reference's): big enough that per-collective overhead amortizes, small
#: enough that the first bucket's all-reduce starts while later buckets
#: are still being produced.
DEFAULT_PSUM_BUCKET_BYTES = 4 << 20


class CollectiveCounter:
    """Counts of the collectives issued through this module, by name."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.counts.values())

    def reset(self) -> None:
        with self._lock:
            self.counts.clear()


COLLECTIVES = CollectiveCounter()


def _groups(axis: AxisName) -> List[Any]:
    mesh = compat.bound_mesh()
    names = compat._axes(axis)
    for name in names:
        if name not in mesh.mesh_dim_names:
            raise NameError(f"unbound axis name {name!r}; the mesh has {mesh.mesh_dim_names}")
    return [mesh.get_group(name) for name in names]


def _single_group(axis: AxisName, what: str) -> Any:
    groups = _groups(axis)
    if len(groups) != 1:
        raise ValueError(f"{what} takes one mesh axis, got {axis!r}")
    return groups[0]


def _product_index(axis: AxisName) -> int:
    """This rank's index in the product of the named axes, laid out as
    ``lax`` lays out a tuple of axes: row-major in the tuple's order."""
    mesh = compat.bound_mesh()
    index = 0
    for name in compat._axes(axis):
        index = index * mesh.size(mesh.mesh_dim_names.index(name)) + mesh.get_local_rank(name)
    return index


class _Gathered:
    """One in-flight all-gather whose blocks are summed in rank order."""

    def __init__(self, x: torch.Tensor, group: Any, async_op: bool):
        n = dist.get_world_size(group)
        self.parts = [torch.empty_like(x) for _ in range(n)]
        self.handle = dist.all_gather(self.parts, x.contiguous(), group=group,
                                      async_op=async_op)
        COLLECTIVES.add("all_gather")

    def wait(self) -> torch.Tensor:
        if self.handle is not None:
            self.handle.wait()
            self.handle = None
        out = self.parts[0].clone()
        for part in self.parts[1:]:
            out += part
        return out


def ordered_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, added in rank order
    (the same bits whatever buffer ``x`` is part of)."""
    return _Gathered(x, group, async_op=False).wait()


def _ordered_sums(x: torch.Tensor, groups) -> torch.Tensor:
    for group in groups:
        x = ordered_sum(x, group)
    return x


class _Psum(torch.autograd.Function):
    """The rank-ordered sum over ``groups``; its backward is the sum of the
    cotangents over the same groups (module docstring)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _ordered_sums(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return _ordered_sums(grad, ctx.groups), None


class _PsumInvariant(torch.autograd.Function):
    """The rank-ordered sum over ``groups`` whose cotangent is the same on
    every rank: the backward passes it through."""

    @staticmethod
    def forward(ctx, x, groups):
        return _ordered_sums(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` unchanged; its cotangent times ``scale`` (a replicated
    output's per-rank share at the ``shard_map`` boundary)."""
    return _ScaleGrad.apply(x, scale)


def psum(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    """Sum-reduce across an axis (or, in order, across each of a tuple);
    differentiable, the backward a psum of the cotangents."""
    return _Psum.apply(x, _groups(axis))


def pmean(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    return psum(x, axis) / compat.axis_size(axis)


def psum_invariant(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    """:func:`psum` for a DTensor local call, whose cotangent arrives the
    same on every rank: the backward hands each rank its cotangent."""
    return _PsumInvariant.apply(x, _groups(axis))


def pmean_invariant(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    return psum_invariant(x, axis) / compat.axis_size(axis)


class PendingPsum:
    """The in-flight buckets of one :func:`bucketed_psum`; :meth:`wait`
    blocks for them and returns the reduced tree."""

    def __init__(self, like: Any, leaves: List[torch.Tensor], pieces: List[Any],
                 rest: List[Any] = ()):
        self._like = like
        self._leaves = leaves
        self._pieces = pieces   # (gathered bucket, [(leaf index, numel, shape)])
        self._rest = list(rest)  # the groups of the tuple's later axes

    def wait(self) -> Any:
        from unionml_tpu_torch.models.train import tree_unflatten

        out: List[Any] = list(self._leaves)
        for gathered, members in self._pieces:
            flat = _ordered_sums(gathered.wait(), self._rest)
            offset = 0
            for i, numel, shape in members:
                out[i] = flat[offset:offset + numel].view(shape)
                offset += numel
        self._pieces = []
        return tree_unflatten(self._like, out)


def bucketed_psum(
    tree: Any,
    axis: AxisName,
    *,
    bucket_bytes: int = DEFAULT_PSUM_BUCKET_BYTES,
    wait: bool = True,
) -> Any:
    """``psum`` of every leaf of ``tree``, one asynchronous collective per
    byte-bounded bucket of leaves (in tree order; a leaf above
    ``bucket_bytes`` gets its own bucket, a tensor is never split; a
    bucket's leaves travel as one flat buffer per dtype). The values are
    the plain psum's, bit for bit: bucketing changes how many collectives
    run, never which shards sum nor in what order. Over a tuple of axes
    the sum runs over their product as :func:`psum`'s does: each bucket's
    asynchronous gather over the first axis, then rank-ordered sums over
    the others where it is waited for. ``wait=False`` returns a
    :class:`PendingPsum` whose ``wait()`` gives the tree, so the caller
    consumes the sums later."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
    from unionml_tpu_torch.models.train import tree_leaves

    group, *rest = _groups(axis)
    leaves = tree_leaves(tree)
    buckets: List[List[int]] = []
    sizes: List[int] = []
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size()
        if buckets and sizes[-1] + nbytes <= bucket_bytes:
            buckets[-1].append(i)
            sizes[-1] += nbytes
        else:
            buckets.append([i])
            sizes.append(nbytes)
    pieces = []
    for bucket in buckets:
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i in bucket:
            by_dtype.setdefault(leaves[i].dtype, []).append(i)
        for members in by_dtype.values():
            flat = torch.cat([leaves[i].reshape(-1) for i in members])
            pieces.append((_Gathered(flat, group, async_op=True),
                           [(i, leaves[i].numel(), leaves[i].shape) for i in members]))
    pending = PendingPsum(tree, leaves, pieces, rest)
    return pending.wait() if wait else pending


def all_gather(x: torch.Tensor, axis: AxisName, *, gather_axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Gather shards along ``gather_axis`` (fsdp param gather); untiled
    stacks them on a new leading-at-``gather_axis`` dimension. Over a
    tuple of axes the blocks come in ``lax``'s order of the product
    (row-major in the tuple's order): gathered over the last axis first,
    then each earlier one."""
    for i, group in enumerate(reversed(_groups(axis))):
        x = gather_group(x, group, gather_axis, tiled=tiled or i > 0)
    return x


def gather_group(x: torch.Tensor, group: Any, dim: int, *, tiled: bool = True) -> torch.Tensor:
    """Every rank of ``group``'s ``x``, in rank order, concatenated along
    ``dim`` (stacked on a new ``dim`` when not ``tiled``)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    COLLECTIVES.add("all_gather")
    return torch.cat(parts, dim=dim) if tiled else torch.stack(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, axis: AxisName, *, scatter_axis: int = 0) -> torch.Tensor:
    """Sum-reduce then keep this rank's block of ``scatter_axis`` (fsdp
    gradient shard). Over a tuple of axes: the sum over their product
    (as :func:`psum`), and the block at this rank's index in it, in
    ``lax``'s order."""
    groups = _groups(axis)
    total = _ordered_sums(x, groups)
    n = 1
    for group in groups:
        n *= dist.get_world_size(group)
    return total.chunk(n, dim=scatter_axis)[_product_index(axis)].contiguous()


def _ppermute(x: torch.Tensor, group: Any, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[(me + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COLLECTIVES.add("ppermute")
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _ppermute(grad, ctx.group, -ctx.shift), None, None


def ppermute_shift(x: torch.Tensor, axis: str, *, shift: int = 1) -> torch.Tensor:
    """Rotate shards around a ring: rank ``i`` of the axis receives rank
    ``i - shift``'s block. Differentiable: the backward rotates the
    cotangent by ``-shift``. On an axis of size 1 the input comes back
    as it is, with no collective (a ring of one)."""
    group = _single_group(axis, "ppermute_shift")
    if shift % dist.get_world_size(group) == 0:
        return x
    return _Ppermute.apply(x, group, shift)


def _all_to_all(x: torch.Tensor, group: Any, split_axis: int, concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    sends = [c.contiguous() for c in x.chunk(n, dim=split_axis)]
    # gathered, so gloo (which has no all_to_all on the CPU) runs it too
    gathered = [[torch.empty_like(c) for c in sends] for _ in range(n)]
    for j in range(n):
        dist.all_gather(gathered[j], sends[j], group=group)
    COLLECTIVES.add("all_to_all")
    me = dist.get_rank(group)
    return torch.cat([gathered[me][src] for src in range(n)], dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(grad, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, axis: str, *, split_axis: int, concat_axis: int,
               tiled: bool = True) -> torch.Tensor:
    """Split ``split_axis`` into one block per rank, send block ``j`` to
    rank ``j`` and concatenate what arrives along ``concat_axis``.
    ``tiled=False`` is ``lax.all_to_all``'s untiled form: ``split_axis``
    must have one entry per rank; it is removed, and the entries that
    arrive are stacked along a new axis at ``concat_axis`` (a position of
    the result). Differentiable: the backward is ``all_to_all(concat_axis,
    split_axis)`` (untiled: with the same axis moves undone)."""
    group = _single_group(axis, "all_to_all")
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if tiled:
        return _AllToAll.apply(x, group, split_axis, concat_axis)
    n = dist.get_world_size(group)
    if x.shape[split_axis] != n:
        raise ValueError(f"untiled all_to_all needs split_axis {split_axis} of size {n} (the "
                         f"axis size), got {tuple(x.shape)}")
    # the reference's reshaping around the tiled exchange
    if split_axis < concat_axis:
        concat_axis += 1
        x = x.unsqueeze(concat_axis)
    elif split_axis > concat_axis:
        x = x.unsqueeze(concat_axis)
        split_axis += 1
    out = _AllToAll.apply(x, group, split_axis, concat_axis)
    return out if split_axis == concat_axis else out.squeeze(split_axis)


def axis_index(axis: str) -> int:
    mesh = compat.bound_mesh()
    return mesh.get_local_rank(axis)


def axis_size(axis: AxisName) -> int:
    return compat.axis_size(axis)
