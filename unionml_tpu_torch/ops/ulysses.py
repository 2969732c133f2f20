"""Ulysses sequence parallelism: all-to-all head <-> sequence reshuffle.

The port of :mod:`unionml_tpu.ops.ulysses`. Instead of rotating kv shards
(:mod:`~unionml_tpu_torch.ops.ring_attention`), one
:func:`~unionml_tpu_torch.parallel.collectives.all_to_all` re-shards the
sequence-sharded q/k/v into head-sharded ones, every rank runs
*full-sequence* attention over its subset of heads through
:func:`~unionml_tpu_torch.ops.attention.attention` (so ``impl="auto"``
reaches the fused kernels, rows 12-13, or the flash kernels, rows 9-11,
on the card), and a second all-to-all restores sequence sharding. Both
all-to-alls are differentiable (the backward is the reverse all-to-all).
q and kv head counts must divide the axis size.
"""

from __future__ import annotations

from typing import Optional

import torch

from unionml_tpu_torch.parallel.collectives import all_to_all, axis_size

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def _seq_to_heads(x: torch.Tensor, axis: str) -> torch.Tensor:
    """[B, S/n, H, D] -> [B, S, H/n, D]: split the heads across ranks,
    concatenate the sequence."""
    return all_to_all(x, axis, split_axis=2, concat_axis=1)


def _heads_to_seq(x: torch.Tensor, axis: str) -> torch.Tensor:
    """[B, S, H/n, D] -> [B, S/n, H, D]."""
    return all_to_all(x, axis, split_axis=1, concat_axis=2)


def ulysses_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis: str = "sequence",
    causal: bool = False,
    impl: str = "xla",
    scale: Optional[float] = None,
    block_size: int = 512,
) -> torch.Tensor:
    """Per-shard Ulysses body (call inside ``shard_map``): local shards
    [B, S/n, H, D]; kv may have fewer (GQA) heads, which must still divide
    the axis size (checked before any collective)."""
    from unionml_tpu_torch.ops.attention import attention

    n = axis_size(axis)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[2] % n:
            raise ValueError(
                f"ulysses requires {name} heads ({t.shape[2]}) divisible by axis size ({n})"
            )
    kwargs = {} if scale is None else {"scale": scale}
    out = attention(_seq_to_heads(q, axis), _seq_to_heads(k, axis), _seq_to_heads(v, axis),
                    causal=causal, impl=impl, block_size=block_size, **kwargs)
    return _heads_to_seq(out, axis)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis: str = "sequence",
    causal: bool = False,
    impl: str = "xla",
    scale: Optional[float] = None,
    block_size: int = 512,
):
    """Ulysses attention over globally-shaped [B,S,H,D] tensors (the output
    a DTensor sharded over ``mesh[axis]``)."""
    from unionml_tpu_torch.ops.ring_attention import _global

    return _global(lambda a, b, c: ulysses_attention_sharded(
        a, b, c, axis=axis, causal=causal, impl=impl, scale=scale, block_size=block_size),
        q, k, v, mesh, axis)
