"""Pipeline-parallel Llama training: GPipe stages over the ``pipeline`` axis.

The port of :mod:`unionml_tpu.models.pipeline_lm`. The decoder's block
stack splits into ``num_stages`` runs of consecutive blocks; each stage's
parameters live on one rank of the ``pipeline`` mesh axis, and
:func:`~unionml_tpu_torch.parallel.pipeline.pipeline_apply` runs the
differentiable GPipe schedule (microbatches flow between stages by the
differentiable rotation). The embedding and the LM head run outside the
pipeline, on the whole batch, the same on every rank.

PP composes with DP: ``ShardingConfig(pipeline=n, data=m,
rules=PIPELINE_PARTITION_RULES)`` through
:func:`~unionml_tpu_torch.parallel.compile_step` and ``data_axis="data"``:
microbatch rows shard over ``data`` while stage weights shard over
``pipeline``; each stage's gradient is summed over ``data`` once, in rank
order.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from unionml_tpu_torch._device import torch_dtype
from unionml_tpu_torch.models.layers import RMSNorm, gather_rows, make_dense
from unionml_tpu_torch.models.llama import LlamaBlock, LlamaConfig
from unionml_tpu_torch.models.train import (
    Optimizer,
    TrainState,
    adamw,
    masked_cross_entropy,
    value_and_grad,
)
from unionml_tpu_torch.parallel.compat import is_dtensor
from unionml_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from unionml_tpu_torch.parallel.sharding import PartitionRule

__all__ = [
    "PIPELINE_PARTITION_RULES",
    "LlamaStage",
    "create_pipelined_lm_state",
    "pipelined_lm_apply",
    "pipelined_lm_step",
    "to_pipeline_params",
]

PIPELINE_PARTITION_RULES = (
    # stacked stage params carry a leading stage dim; unanchored so it
    # matches both params/stages/... and opt_state/.../stages/...
    PartitionRule(r"stages/", ("pipeline",)),
)


class LlamaStage(nn.Module):
    """A run of ``num_blocks`` consecutive Llama blocks (one pipeline
    stage): ``forward(params, x)`` with ``params`` ``{block_i: ...}``."""

    def __init__(self, config: LlamaConfig, num_blocks: int):
        super().__init__()
        self.blocks = nn.ModuleList(LlamaBlock(config) for _ in range(num_blocks))

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.blocks):
            x, _ = block(params[f"block_{i}"], x)
        return x


class _Embedder(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.dtype = torch_dtype(config.dtype)

    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return gather_rows(params["embed"]["embedding"], tokens.long()).to(self.dtype)


class _Head(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.final_norm = RMSNorm(eps=config.norm_eps, dtype=torch_dtype(config.dtype),
                                  impl=config.norm_impl)
        # the same bias-free dense as Llama's lm_head, so param trees stay
        # interchangeable (to_pipeline_params)
        self.lm_head = make_dense(quantized=False, features=config.vocab_size,
                                  dtype=torch.float32)

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(params["final_norm"], x)
        return self.lm_head(params["lm_head"], x.float())


def _modules(cfg: LlamaConfig, num_stages: int):
    if cfg.num_layers % num_stages:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by num_stages {num_stages}")
    if cfg.num_experts:
        raise NotImplementedError(
            "pipelined MoE is not supported: the per-layer aux losses of the stages "
            "cannot reach the loss"
        )
    if cfg.quantized:
        raise NotImplementedError("pipelined training does not support int8 serving quantization")
    per = cfg.num_layers // num_stages
    return _Embedder(cfg), LlamaStage(cfg, per), _Head(cfg)


def to_pipeline_params(flat_params: Any, cfg: LlamaConfig, num_stages: int) -> Any:
    """Regroup a flat :class:`~unionml_tpu_torch.models.llama.Llama` param
    tree into the pipelined layout: ``block_i`` goes to stage ``i //
    (L / num_stages)`` as its local ``block_{i mod per}``; the embedding and
    final_norm / lm_head move to the ``embed`` / ``head`` groups (serial
    and pipelined checkpoints migrate both ways)."""
    _modules(cfg, num_stages)   # the trainer path's checks
    per = cfg.num_layers // num_stages
    stages = [{f"block_{i}": flat_params[f"block_{s * per + i}"] for i in range(per)}
              for s in range(num_stages)]
    return {
        "embed": {"embed": flat_params["embed"]},
        "stages": stack_stage_params(stages),
        "head": {"final_norm": flat_params["final_norm"], "lm_head": flat_params["lm_head"]},
    }


def create_pipelined_lm_state(
    cfg: LlamaConfig,
    num_stages: int,
    example_tokens: torch.Tensor,
    *,
    optimizer: Optional[Optimizer] = None,
    learning_rate: float = 1e-3,
    weight_decay: float = 0.0,
    seed: int = 0,
) -> TrainState:
    """A TrainState whose params are ``{embed, stages, head}`` on
    ``example_tokens``' device (``stages`` stacks the per-stage block
    params on a leading axis: shard it over ``pipeline`` with
    :data:`PIPELINE_PARTITION_RULES`). The values are
    :func:`~unionml_tpu_torch.models.llama.init_params` ``(cfg, seed)``
    regrouped."""
    from unionml_tpu_torch.models.llama import init_params

    _modules(cfg, num_stages)
    flat = init_params(cfg, seed=seed, device=example_tokens.device)
    tx = optimizer or adamw(learning_rate, weight_decay=weight_decay)
    return TrainState.create(apply_fn=None, params=to_pipeline_params(flat, cfg, num_stages),
                             tx=tx)


def pipelined_lm_apply(
    params: Any,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    num_stages: int,
    *,
    mesh,
    num_microbatches: int,
    data_axis: Optional[str] = None,
    remat: bool = True,
) -> torch.Tensor:
    """Forward logits [B, S, V] through the pipelined decoder: a DTensor
    replicated on every rank when ``params`` are placed, else a plain
    tensor (every rank holding them in full)."""
    embedder, stage_module, head = _modules(cfg, num_stages)
    if is_dtensor(tokens):
        tokens = tokens.full_tensor()
    placed = is_dtensor(params["head"]["lm_head"]["kernel"])
    h = embedder(params["embed"], tokens)
    h = pipeline_apply(stage_module, params["stages"], h, mesh=mesh,
                       num_microbatches=num_microbatches, data_axis=data_axis, remat=remat)
    if not placed:
        h = h.to_local()
    return head(params["head"], h)


def pipelined_lm_step(
    cfg: LlamaConfig,
    num_stages: int,
    *,
    mesh,
    num_microbatches: int,
    data_axis: Optional[str] = None,
    ignore_id: int = -100,
) -> Callable:
    """``step(state, batch) -> (state, metrics)`` with the block stack
    pipelined: run it through ``compile_step`` with
    ``ShardingConfig(pipeline=n, data=m, rules=PIPELINE_PARTITION_RULES)``,
    or on plain tensors every rank holds in full. ``batch``: token ids
    [B, S] (shifted pairs) or an ``(inputs, labels)`` tuple. Metrics
    ``loss`` and ``perplexity``."""

    def loss_fn(params, batch):
        inputs, targets = batch
        logits = pipelined_lm_apply(params, inputs, cfg, num_stages, mesh=mesh,
                                    num_microbatches=num_microbatches, data_axis=data_axis)
        if is_dtensor(targets):
            targets = targets.full_tensor()
        loss = masked_cross_entropy(logits, targets, ignore_id=ignore_id)
        return loss, {}

    def step(state: TrainState, batch):
        if isinstance(batch, tuple):
            inputs, targets = batch
        else:
            if is_dtensor(batch):
                batch = batch.full_tensor()
            inputs, targets = batch[:, :-1], batch[:, 1:]
        (loss, _), grads = value_and_grad(loss_fn, state.params, (inputs, targets))
        state = state.apply_gradients(grads=grads)
        if is_dtensor(loss):
            loss = loss.full_tensor()
        return state, {"loss": loss, "perplexity": torch.exp(loss)}

    return step
