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

Sums are deterministic: a psum gathers every rank's block and adds them
in rank order (:func:`ordered_sum`), so an element's sum does not depend
on the size of the buffer it travelled in (a ring all-reduce adds each
chunk starting from another rank). That is what makes a bucketed psum bit
for bit the leaf-wise one, and the explicit data-axis reduction of the
overlapped accumulation bit for bit the serial step's
(:func:`~unionml_tpu_torch.parallel.sharding.resolve_grads` reduces with
it too). The price is an all-gather's traffic instead of an all-reduce's.
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
        raise NotImplementedError(f"{what} over several axes at once is not ported")
    return groups[0]


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


def psum(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    """Sum-reduce across an axis (or, in order, across each of a tuple)."""
    for group in _groups(axis):
        x = ordered_sum(x, group)
    return x


def pmean(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    return psum(x, axis) / compat.axis_size(axis)


class PendingPsum:
    """The in-flight buckets of one :func:`bucketed_psum`; :meth:`wait`
    blocks for them and returns the reduced tree."""

    def __init__(self, like: Any, leaves: List[torch.Tensor], pieces: List[Any]):
        self._like = like
        self._leaves = leaves
        self._pieces = pieces   # (gathered bucket, [(leaf index, numel, shape)])

    def wait(self) -> Any:
        from unionml_tpu_torch.models.train import tree_unflatten

        out: List[Any] = list(self._leaves)
        for gathered, members in self._pieces:
            flat = gathered.wait()
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
    run, never which shards sum nor in what order. ``wait=False`` returns
    a :class:`PendingPsum` whose ``wait()`` gives the tree, so the caller
    consumes the sums later."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
    from unionml_tpu_torch.models.train import tree_leaves

    group = _single_group(axis, "bucketed_psum")
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
    pending = PendingPsum(tree, leaves, pieces)
    return pending.wait() if wait else pending


def all_gather(x: torch.Tensor, axis: AxisName, *, gather_axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Gather shards along ``gather_axis`` (fsdp param gather); untiled
    stacks them on a new leading-at-``gather_axis`` dimension."""
    group = _single_group(axis, "all_gather")
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    COLLECTIVES.add("all_gather")
    return torch.cat(parts, dim=gather_axis) if tiled else torch.stack(parts, dim=gather_axis)


def reduce_scatter(x: torch.Tensor, axis: AxisName, *, scatter_axis: int = 0) -> torch.Tensor:
    """Sum-reduce then keep this rank's block of ``scatter_axis`` (fsdp
    gradient shard)."""
    group = _single_group(axis, "reduce_scatter")
    total = ordered_sum(x, group)
    n = dist.get_world_size(group)
    return total.chunk(n, dim=scatter_axis)[dist.get_rank(group)].contiguous()


def ppermute_shift(x: torch.Tensor, axis: str, *, shift: int = 1) -> torch.Tensor:
    """Rotate shards around a ring: rank ``i`` of the axis receives rank
    ``i - shift``'s block."""
    group = _single_group(axis, "ppermute_shift")
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[(me + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COLLECTIVES.add("ppermute")
    return out


def all_to_all(x: torch.Tensor, axis: str, *, split_axis: int, concat_axis: int,
               tiled: bool = True) -> torch.Tensor:
    """Split ``split_axis`` into one block per rank, send block ``j`` to
    rank ``j`` and concatenate what arrives along ``concat_axis``."""
    if not tiled:
        raise NotImplementedError("untiled all_to_all is not ported")
    group = _single_group(axis, "all_to_all")
    n = dist.get_world_size(group)
    sends = [c.contiguous() for c in x.chunk(n, dim=split_axis)]
    # gathered, so gloo (which has no all_to_all on the CPU) runs it too
    gathered = [[torch.empty_like(c) for c in sends] for _ in range(n)]
    for j in range(n):
        dist.all_gather(gathered[j], sends[j], group=group)
    COLLECTIVES.add("all_to_all")
    me = dist.get_rank(group)
    return torch.cat([gathered[me][src] for src in range(n)], dim=concat_axis)


def axis_index(axis: str) -> int:
    mesh = compat.bound_mesh()
    return mesh.get_local_rank(axis)


def axis_size(axis: AxisName) -> int:
    return compat.axis_size(axis)
