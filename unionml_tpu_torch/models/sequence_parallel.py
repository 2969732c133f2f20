"""Sequence-parallel Llama training: the loss under ``shard_map``.

The port of :mod:`unionml_tpu.models.sequence_parallel`. Activations, not
parameters, are the memory bottleneck of long-context training, so the
sequence dimension shards over the mesh's ``sequence`` axis and attention
runs sequence-sharded: a ring (``attn="ring"``, or ``"ring_flash"`` with
the flash kernels as the per-step compute,
:mod:`~unionml_tpu_torch.ops.ring_attention`) or ``"ulysses"``
(:mod:`~unionml_tpu_torch.ops.ulysses`). Everything else in the decoder is
position-local, so attention's collectives are the forward's only
cross-shard exchange.

- The whole loss runs inside one :func:`~unionml_tpu_torch.parallel
  .compat.shard_map` over ``(data, sequence)``; parameters enter
  replicated (spec ``P()``), so their gradients leave it ``Partial`` over
  both axes and are summed once, in rank order, by
  :func:`~unionml_tpu_torch.models.train.value_and_grad` (exact global
  gradients, no manual collective on them).
- RoPE positions are global: each shard offsets by ``axis_index(sequence)
  * S_local``.
- Next-token targets are built outside the shard_map by shifting the full
  sequence (the last global position gets ``ignore_id``), so a shard
  boundary never needs its neighbour's first token.
- The loss is a masked-CE ratio of two ``psum``s (token sums over both
  mesh axes), the same on every rank: ``shard_map`` passes each rank
  ``1/n`` of its cotangent and the psums' backward sums the shares, so the
  loss is counted once.
- MoE composes: each block's token-mean routing and gate fractions
  (``moe_stats``) are ``pmean``-ed over the mesh axes and the load-balance
  loss is re-formed from the global fractions, ``E * sum(rf * gf)``: the
  serial ``lm_step``'s aux exactly, since the shards hold equal token
  counts (a mean of per-shard products would not be).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from unionml_tpu_torch.models.llama import Llama, LlamaConfig

__all__ = ["sequence_parallel_config", "sequence_parallel_lm_step"]

SP_ATTN_IMPLS = ("ring", "ring_flash", "ulysses")


def sequence_parallel_config(cfg: LlamaConfig, *, attn: str = "ring",
                             seq_axis: str = "sequence") -> LlamaConfig:
    """The same model with sequence-sharded attention bound to the axis:
    ``attn`` ``"ring"`` / ``"ring_flash"`` (kv rotation) or ``"ulysses"``
    (all-to-all head <-> sequence reshuffle; q AND kv head counts must
    divide the axis size)."""
    if attn not in SP_ATTN_IMPLS:
        raise ValueError(
            f"sequence-parallel attention must be ring/ring_flash/ulysses, got {attn!r}"
        )
    return dataclasses.replace(cfg, attn_impl=attn, sequence_axis=seq_axis)


def _whole(x):
    from unionml_tpu_torch.parallel.compat import is_dtensor

    return x.full_tensor() if is_dtensor(x) else x


def sequence_parallel_lm_step(
    cfg: LlamaConfig,
    *,
    mesh,
    attn: str = "ring",
    data_axis: Optional[str] = "data",
    seq_axis: str = "sequence",
    ignore_id: int = -100,
    aux_loss_weight: float = 0.01,
) -> Callable:
    """``step(state, tokens [B, S]) -> (state, metrics)`` with the sequence
    dimension sharded over ``mesh[seq_axis]`` (``S`` divisible by its size,
    ``B`` by the data axis's). Run it on a state placed by ``compile_step``
    under ``ShardingConfig(data=m, sequence=n)`` (parameters replicate),
    or on plain tensors every rank holds in full. Metrics ``loss`` (the
    cross entropy), ``perplexity`` and ``aux_loss``, replicated."""
    from unionml_tpu_torch.models.train import value_and_grad
    from unionml_tpu_torch.parallel.collectives import axis_index, pmean, psum
    from unionml_tpu_torch.parallel.compat import shard_map
    from unionml_tpu_torch.parallel.mesh import mesh_shape
    from unionml_tpu_torch.parallel.sharding import PartitionSpec as P

    sp_cfg = sequence_parallel_config(cfg, attn=attn, seq_axis=seq_axis)
    n_seq = mesh_shape(mesh)[seq_axis]
    kv_heads = cfg.num_kv_heads or cfg.num_heads
    if attn == "ulysses" and (cfg.num_heads % n_seq or kv_heads % n_seq):
        # at config time, not inside the first step
        raise ValueError(
            f"ulysses needs q heads ({cfg.num_heads}) and kv heads ({kv_heads}) divisible by "
            f"the sequence axis size ({n_seq}); use ring/ring_flash instead"
        )
    module = Llama(sp_cfg)
    axes = (data_axis, seq_axis) if data_axis else (seq_axis,)

    def sharded_loss(params, tokens, targets):
        s_loc = tokens.shape[1]
        positions = axis_index(seq_axis) * s_loc + torch.arange(s_loc, device=tokens.device)
        sown: dict = {}
        logits = module(params, tokens, positions=positions[None, :], sow=sown).float()
        mask = (targets != ignore_id).float()
        safe = torch.where(targets == ignore_id, torch.zeros_like(targets), targets)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), safe.reshape(-1).long(),
                             reduction="none").reshape(targets.shape)
        ce_sum, count = (ce * mask).sum(), mask.sum()
        fracs = sown.get("moe_stats", [])
        for ax in axes:
            ce_sum, count = psum(ce_sum, ax), psum(count, ax)
            # token-MEAN fractions over equal-size shards: their mean over
            # the shards is the global token mean
            fracs = [pmean(f, ax) for f in fracs]
        ce = ce_sum / count.clamp_min(1.0)
        if fracs:
            aux = sum(cfg.num_experts * (f[0] * f[1]).sum() for f in fracs) / len(fracs)
        else:
            aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux_loss_weight * aux, ce, aux

    batch_spec = P(data_axis, seq_axis) if data_axis else P(None, seq_axis)
    loss_sm = shard_map(sharded_loss, mesh=mesh, in_specs=(P(), batch_spec, batch_spec),
                        out_specs=(P(), P(), P()))

    def loss_fn(params, batch):
        total, ce, aux = loss_sm(params, *batch)
        return total, {"ce": ce, "aux": aux}

    def step(state, tokens):
        tokens = _whole(torch.as_tensor(tokens) if not isinstance(tokens, torch.Tensor)
                        else tokens)
        # the global shift: the last position's target is ignore_id, so
        # shard boundaries never need the neighbour's first token
        targets = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], ignore_id)], dim=1)
        (_, aux), grads = value_and_grad(loss_fn, state.params, (tokens, targets))
        state = state.apply_gradients(grads=grads)
        loss = _whole(aux["ce"])
        return state, {"loss": loss, "perplexity": torch.exp(loss),
                       "aux_loss": _whole(aux["aux"])}

    return step
