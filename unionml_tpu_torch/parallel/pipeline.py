"""Pipeline parallelism: the GPipe microbatch schedule as one SPMD program.

The port of :mod:`unionml_tpu.parallel.pipeline`. Every pipeline stage
lives on one rank of the ``pipeline`` mesh axis; the whole schedule
(fill, steady state, drain) is one loop of ticks inside
:func:`~unionml_tpu_torch.parallel.compat.shard_map`, and activations move
between neighbouring stages with the differentiable
:func:`~unionml_tpu_torch.parallel.collectives.ppermute_shift`. Autograd
differentiates straight through the schedule: the backward's rotations
are the forward's, transposed, so pipeline-parallel training needs no
backward scheduler of its own.

Memory: each stage recomputes its microbatch activations in the backward
(``torch.utils.checkpoint`` around the stage body, non-reentrant), the
GPipe trade.

Stack per-stage parameters on a leading axis (stage ``s`` owns
``stacked_params[s]``, :func:`stack_stage_params`) and pick
``num_microbatches >= num_stages``: the bubble is ``(n-1)/(m+n-1)`` of
the ticks.

The final ``psum`` replicates the last stage's outputs to every stage so
the loss after the pipeline is stage-agnostic. Every stage then computes
that same loss, so the backward must hand each stage its own cotangent,
not the sum over stages, which would make the stage gradients ``n`` times
too large: ``shard_map`` passes each stage ``1/n`` of the replicated
output's cotangent and the psum's backward sums the ``n`` shares.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from unionml_tpu_torch.parallel.compat import checkpoint_context_fn

__all__ = ["pipeline_apply", "pipeline_spmd", "stack_stage_params"]


def _unstack_local(tree: Any) -> Any:
    """Drop the singleton leading (stage) axis of a rank's param shard."""
    from unionml_tpu_torch.models.train import tree_map

    return tree_map(lambda x: x[0], tree)


def pipeline_spmd(
    stage_fn: Callable,
    stage_params: Any,
    microbatches: torch.Tensor,
    *,
    axis: str = "pipeline",
    remat: bool = True,
) -> torch.Tensor:
    """Run the GPipe schedule inside ``shard_map``: ``stage_fn(params, x)
    -> y`` is this stage's computation, ``stage_params`` the local stage's
    params, ``microbatches`` [M, mb, ...] the whole microbatched input on
    every stage (only stage 0 reads it). Returns [M, mb, ...] outputs,
    the last stage's, replicated to every stage by the final ``psum``."""
    from unionml_tpu_torch.parallel.collectives import axis_index, axis_size, ppermute_shift, psum

    n = axis_size(axis)
    idx = axis_index(axis)
    num_micro = microbatches.shape[0]

    def fn(params, x):
        if remat and torch.is_grad_enabled():
            return checkpoint(stage_fn, params, x, use_reentrant=False,
                              context_fn=checkpoint_context_fn())
        return stage_fn(params, x)

    # every rank runs the same ops (masked by its stage, as the reference's
    # jnp.where): each rank's backward then reaches every rotation of its
    # own graph, in the same order as its neighbours'
    first = torch.tensor(idx == 0, device=microbatches.device)
    last = torch.tensor(idx == n - 1, device=microbatches.device)
    state = torch.zeros_like(microbatches[0])
    outs = [torch.zeros_like(microbatches[0]) for _ in range(num_micro)]
    for t in range(num_micro + n - 1):
        # stage 0 takes microbatch t during the fill and the steady state
        state = torch.where(first, microbatches[min(t, num_micro - 1)].to(state.dtype), state)
        y = fn(stage_params, state)
        if t == 0 and (y.shape != state.shape or y.dtype != state.dtype):
            # every stage checks its first tick before any collective
            raise ValueError(
                f"pipeline stage_fn must preserve activation shape/dtype (the carried "
                f"activation): got {tuple(y.shape)}/{y.dtype} from "
                f"{tuple(state.shape)}/{state.dtype}. Fold projections/dtype casts into "
                "the last stage's OUTPUT consumer instead, or pad activations to a common "
                "shape."
            )
        # the last stage banks microbatch t - (n - 1) once the pipe is full
        done = t - (n - 1)
        if done >= 0:
            outs[done] = torch.where(last, y.to(outs[done].dtype), outs[done])
        if t < num_micro + n - 2:
            state = ppermute_shift(y, axis, shift=1)
    out = torch.stack(outs)
    # the last stage's outputs replicated to every stage: zeros elsewhere,
    # so the psum is a broadcast (its backward: module docstring)
    return psum(torch.where(last, out, torch.zeros_like(out)), axis)


def pipeline_apply(
    stage_fn: Callable,
    stacked_params: Any,
    batch: torch.Tensor,
    *,
    mesh,
    axis: str = "pipeline",
    num_microbatches: int,
    remat: bool = True,
    data_axis: Optional[str] = None,
):
    """Pipeline execution over globally-shaped tensors (differentiable):
    ``stacked_params`` a tree with a leading stage axis of
    ``mesh[axis]``'s size, ``batch`` [B, ...] with ``B`` divisible by
    ``num_microbatches``. Returns [B, ...] outputs replicated on every
    rank (a DTensor). A stage that changes its activation's shape or dtype
    raises ``ValueError`` at the first tick.

    ``data_axis`` composes PP x DP: the microbatch rows shard over that
    axis (each data shard runs its own pipeline over the same stage
    weights; the rotations and the psum stay on ``axis``), so a rank's
    microbatch is ``B / num_microbatches / mesh[data_axis]`` rows."""
    from torch.distributed.tensor import Replicate

    from unionml_tpu_torch.parallel.compat import shard_map
    from unionml_tpu_torch.parallel.mesh import mesh_shape
    from unionml_tpu_torch.parallel.sharding import PartitionSpec as P

    shape = mesh_shape(mesh)
    n = shape[axis]
    b = batch.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by num_microbatches {num_microbatches}")
    if num_microbatches < n:
        raise ValueError(
            f"num_microbatches {num_microbatches} < pipeline stages {n}: the bubble would "
            "dominate; use at least one microbatch per stage"
        )
    mb_rows = b // num_microbatches
    if data_axis is not None:
        if data_axis not in shape:
            raise ValueError(f"data_axis {data_axis!r} is not a mesh axis {tuple(shape)}")
        if mb_rows % shape[data_axis]:
            raise ValueError(f"microbatch rows {mb_rows} not divisible by data axis size "
                             f"{shape[data_axis]}")
    micro = batch.reshape((num_microbatches, mb_rows) + tuple(batch.shape[1:]))
    batch_spec = P(None, data_axis) if data_axis is not None else P()

    def body(params, mb):
        return pipeline_spmd(stage_fn, _unstack_local(params), mb, axis=axis, remat=remat)

    out = shard_map(body, mesh=mesh, in_specs=(P(axis), batch_spec),
                    out_specs=batch_spec)(stacked_params, micro)
    # the rows whole on every rank (an all-gather over data_axis; its
    # backward cuts each rank's rows again), then the microbatches merged
    out = out.redistribute(mesh, [Replicate()] * mesh.ndim)
    return out.reshape((b,) + tuple(out.shape[2:]))


def stack_stage_params(per_stage: list) -> Any:
    """Stack a list of per-stage param trees along a new leading axis
    (shard it over ``pipeline`` with
    :data:`~unionml_tpu_torch.models.pipeline_lm.PIPELINE_PARTITION_RULES`,
    which targets the ``stages/`` subtree only)."""
    from unionml_tpu_torch.models.train import tree_leaves, tree_unflatten

    leaves = [tree_leaves(tree) for tree in per_stage]
    return tree_unflatten(per_stage[0], [torch.stack(xs) for xs in zip(*leaves)])
