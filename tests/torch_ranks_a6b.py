"""Rank bodies of the sequence-, pipeline- and expert-parallel tests.

Called in every gloo rank of a :class:`torch_ranks.RankPool` as
``"torch_ranks_a6b:<function>"``. Like ``torch_ranks.py`` this module
imports neither JAX nor the JAX package: numpy in, numpy out, held against
the JAX package in the pytest process. :class:`Faults` plants the faults
the parity tests must catch.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np


def _t(a: Any, dtype: str = "float32", grad: bool = False):
    import torch

    t = torch.from_numpy(np.array(a)).to(getattr(torch, dtype))
    return t.requires_grad_(True) if grad else t


def _np(x: Any) -> np.ndarray:
    import torch

    from unionml_tpu_torch.parallel.compat import is_dtensor

    if is_dtensor(x):
        x = x.full_tensor()
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


class Faults:
    """Planted faults: ``ppermute_wrong_way`` (a rotation whose backward
    shifts the cotangent the forward's way), ``psum_sums_stages`` (the
    pipeline's final psum handing every stage the sum of the stages' whole
    cotangents), ``local_lse``
    (a ring flash backward that takes each step's own lse in place of the
    global one)."""

    def __init__(self, name: str):
        self.name = name
        self.undo: List[Any] = []

    def _patch(self, obj, attr, value):
        self.undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def __enter__(self):
        from unionml_tpu_torch.ops import ring_attention as ring
        from unionml_tpu_torch.parallel import collectives as c

        if self.name == "ppermute_wrong_way":
            def backward(ctx, grad):
                return c._ppermute(grad, ctx.group, ctx.shift), None, None

            self._patch(c._Ppermute, "backward", staticmethod(backward))
        elif self.name == "psum_sums_stages":
            # each stage's whole cotangent of the replicated outputs goes
            # into the psum's backward sum (no 1/n share): every stage is
            # handed the sum over the stages
            self._patch(c, "scale_grad", lambda t, scale: t)
        elif self.name == "local_lse":
            from unionml_tpu_torch.ops.flash_attention import flash_fwd_plain

            def own_lse(fn):
                def step(q, k, v, do, lse, *rest, kind, scale):
                    if kind != "skip":
                        lse = flash_fwd_plain(q, k, v, causal=kind == "diagonal",
                                              scale=scale)[1]
                    return fn(q, k, v, do, lse, *rest, kind=kind, scale=scale)
                return step

            self._patch(ring, "ring_delta_step", own_lse(ring.ring_delta_step))
            self._patch(ring, "ring_grad_step", own_lse(ring.ring_grad_step))
        elif self.name:
            raise KeyError(self.name)
        return self

    def __exit__(self, *exc):
        for obj, attr, value in reversed(self.undo):
            setattr(obj, attr, value)


# --------------------------------------------------------------------- #
# sequence-sharded attention
# --------------------------------------------------------------------- #


def attention_case(impl: str, q, k, v, *, axes: dict, causal: bool, block_size: int = 8,
                   do=None, dtype: str = "float32", delta_impl: str = "pass",
                   fault: str = "") -> dict:
    """``impl`` (ring, ring_flash, ulysses) over globally-shaped q/k/v on a
    mesh of ``axes``: the whole output and, with a cotangent ``do``
    (whole, numpy), the gradients of q, k and v (whole)."""
    import torch

    from unionml_tpu_torch.ops.ring_attention import ring_attention, ring_flash_attention
    from unionml_tpu_torch.ops.ulysses import ulysses_attention
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axes)
    grads = do is not None
    tensors = [_t(a, dtype, grads) for a in (q, k, v)]
    kw = dict(causal=causal, block_size=block_size)
    with Faults(fault):
        if impl == "ring":
            out = ring_attention(*tensors, mesh, **kw)
        elif impl == "ring_flash":
            out = ring_flash_attention(*tensors, mesh, delta_impl=delta_impl, **kw)
        else:
            out = ulysses_attention(*tensors, mesh, causal=causal)
        whole = out.full_tensor()
        result = {"out": _np(whole)}
        if grads:
            gs = torch.autograd.grad(whole, tensors, grad_outputs=_t(do, dtype))
            result["grads"] = [_np(g) for g in gs]
    return result


def ulysses_refusal() -> str:
    """The eager head-divisibility check: kv heads 2 over sequence 4."""
    from unionml_tpu_torch.ops.ulysses import ulysses_attention
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"sequence": 4})
    q = _t(np.zeros((1, 8, 4, 8)))
    k = _t(np.zeros((1, 8, 2, 8)))
    try:
        ulysses_attention(q, k, k, mesh)
    except ValueError as e:
        return str(e)
    return ""


# --------------------------------------------------------------------- #
# sequence-parallel training
# --------------------------------------------------------------------- #


def _llama(cfg: dict):
    from unionml_tpu_torch.models.llama import Llama, LlamaConfig

    config = LlamaConfig(**cfg)
    return Llama(config), config


def sp_steps(cfg: dict, jax_params: Any, batches: List[Any], *, axes: dict, attn: str,
             data_axis: Optional[str] = "data", lr: float = 1e-2, placed: bool = True,
             fault: str = "") -> dict:
    """``sequence_parallel_lm_step`` SGD steps from the reference's params
    (bridged): through ``compile_step`` under ``ShardingConfig(**axes)``
    with the batch sharded over (data, sequence), or (``placed=False``)
    on plain tensors every rank holds. Losses, aux losses, final params."""
    import torch_ranks

    from unionml_tpu_torch.models import convert
    from unionml_tpu_torch.models.sequence_parallel import sequence_parallel_lm_step
    from unionml_tpu_torch.models.train import TrainState
    from unionml_tpu_torch.parallel import ShardingConfig, compile_step

    module, config = _llama(cfg)
    params = convert.from_jax_params(jax_params, config, device="cpu")
    state = TrainState.create(apply_fn=module, params=params, tx=torch_ranks.sgd(lr))
    spec = (data_axis, "sequence") if data_axis else (None, "sequence")
    sc = ShardingConfig(**axes, batch_spec=spec)
    step = sequence_parallel_lm_step(config, mesh=sc.mesh(), attn=attn, data_axis=data_axis)
    if placed:
        step, state = compile_step(step, state, sharding=sc)
    losses, auxes = [], []
    with Faults(fault):
        for batch in batches:
            state, metrics = step(state, _t(batch, "int64"))
            losses.append(float(metrics["loss"]))
            auxes.append(float(metrics["aux_loss"]))
    return {"losses": losses, "aux": auxes,
            "params": torch_ranks._numpy_tree(state.params)}


def sp_refusals() -> dict:
    """The eager checks of the sequence-parallel step."""
    from unionml_tpu_torch.models.llama import LlamaConfig
    from unionml_tpu_torch.models.sequence_parallel import (
        sequence_parallel_config,
        sequence_parallel_lm_step,
    )
    from unionml_tpu_torch.parallel import make_mesh

    out = {}
    try:
        sequence_parallel_config(LlamaConfig.tiny(), attn="flash")
    except ValueError as e:
        out["attn"] = str(e)
    try:
        sequence_parallel_lm_step(LlamaConfig.tiny(), mesh=make_mesh({"sequence": 4}),
                                  attn="ulysses")
    except ValueError as e:
        out["ulysses"] = str(e)
    return out


def sp_model_train(cfg: dict, n: int, epochs: int, batch_size: int) -> dict:
    """The reference's spec-level case: ``@dataset.reader`` ->
    ``@model.train_step(sequence-parallel step)`` -> ``model.train()``."""
    import torch

    from unionml_tpu_torch import Dataset, Model
    from unionml_tpu_torch.models import create_train_state
    from unionml_tpu_torch.models.sequence_parallel import sequence_parallel_lm_step
    from unionml_tpu_torch.parallel import make_mesh

    module, config = _llama(cfg)
    mesh = make_mesh({"data": 2, "sequence": 2})
    dataset = Dataset(name="sp_tokens", targets=[])

    @dataset.reader
    def reader(n: int = 32) -> np.ndarray:
        rng = np.random.default_rng(0)
        return rng.integers(0, config.vocab_size, size=(n, 32)).astype(np.int64)

    model = Model(name="sp_lm", init=lambda: create_train_state(
        module, torch.zeros(1, 8, dtype=torch.long), learning_rate=5e-3), dataset=dataset)
    sp_step = sequence_parallel_lm_step(config, mesh=mesh)
    model.train_step(sp_step, donate_state=False)

    @model.evaluator
    def evaluator(state, features, targets=None) -> float:
        _, metrics = sp_step(state, torch.as_tensor(np.asarray(features)))
        return float(metrics["loss"])

    _, metrics = model.train(trainer_kwargs={"num_epochs": epochs, "batch_size": batch_size},
                             n=n)
    return {"train": float(metrics["train"])}


# --------------------------------------------------------------------- #
# pipeline parallelism
# --------------------------------------------------------------------- #


def pipeline_case(stages: List[dict], x, *, axes: dict, num_microbatches: int, y=None,
                  fault: str = "") -> dict:
    """``pipeline_apply`` of the tanh stage over ``stages`` (numpy trees):
    the output and, with a target ``y``, the mean-square loss's gradients
    of the stacked params."""
    import torch

    from unionml_tpu_torch.models.train import tree_leaves, tree_map
    from unionml_tpu_torch.parallel import make_mesh, pipeline_apply, stack_stage_params

    mesh = make_mesh(axes)
    stacked = tree_map(lambda a: a.requires_grad_(y is not None),
                       stack_stage_params([{k: _t(v) for k, v in s.items()} for s in stages]))

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    with Faults(fault):
        out = pipeline_apply(stage_fn, stacked, _t(x), mesh=mesh,
                             num_microbatches=num_microbatches).to_local()
        result = {"out": _np(out)}
        if y is not None:
            loss = ((out - _t(y)) ** 2).mean()
            gs = torch.autograd.grad(loss, tree_leaves(stacked))
            result["grads"] = {k: _np(g) for k, g in zip(stacked, gs)}
    return result


def pipeline_refusals() -> dict:
    import torch

    from unionml_tpu_torch.parallel import make_mesh, pipeline_apply

    mesh = make_mesh({"pipeline": 4, "data": -1})
    stacked = {"w": torch.zeros(4, 8, 8), "b": torch.zeros(4, 8)}
    x = torch.zeros(16, 8)
    out = {}
    for key, micro in (("divisible", 5), ("bubble", 2)):
        try:
            pipeline_apply(lambda p, h: h, stacked, x, mesh=mesh, num_microbatches=micro)
        except ValueError as e:
            out[key] = str(e)
    try:
        pipeline_apply(lambda p, h: h[:, :4], stacked, x, mesh=mesh, num_microbatches=4)
    except ValueError as e:
        out["shape"] = str(e)
    return out


def pipelined_llama(cfg: dict, jax_flat: Any, tokens, *, axes: dict, num_stages: int,
                    num_microbatches: int, data_axis: Optional[str] = None,
                    steps: int = 0, lr: float = 1e-2, compiled: bool = False,
                    fault: str = "") -> dict:
    """The pipelined Llama from the reference's flat params (bridged and
    regrouped): its logits (``steps=0``), or ``steps`` SGD
    ``pipelined_lm_step``s, on plain tensors or (``compiled``) through
    ``compile_step`` under ``ShardingConfig(**axes,
    rules=PIPELINE_PARTITION_RULES)``: losses and final params (whole)."""
    import torch_ranks

    from unionml_tpu_torch.models import convert
    from unionml_tpu_torch.models.pipeline_lm import (
        PIPELINE_PARTITION_RULES,
        pipelined_lm_apply,
        pipelined_lm_step,
        to_pipeline_params,
    )
    from unionml_tpu_torch.models.train import TrainState
    from unionml_tpu_torch.parallel import ShardingConfig, compile_step, make_mesh

    _, config = _llama(cfg)
    params = to_pipeline_params(convert.from_jax_params(jax_flat, config, device="cpu"),
                                config, num_stages)
    tokens = _t(tokens, "int64")
    with Faults(fault):
        if not steps:
            mesh = make_mesh(axes)
            logits = pipelined_lm_apply(params, tokens, config, num_stages, mesh=mesh,
                                        num_microbatches=num_microbatches, data_axis=data_axis)
            return {"logits": _np(logits)}
        state = TrainState.create(apply_fn=None, params=params, tx=torch_ranks.sgd(lr))
        if compiled:
            sc = ShardingConfig(**axes, rules=PIPELINE_PARTITION_RULES)
            mesh = sc.mesh()
        else:
            mesh = make_mesh(axes)
        step = pipelined_lm_step(config, num_stages, mesh=mesh,
                                 num_microbatches=num_microbatches, data_axis=data_axis)
        placements = None
        if compiled:
            step, state = compile_step(step, state, sharding=sc)
            placements = {
                "stage": str(state.params["stages"]["block_0"]["attn"]["q"]["kernel"].placements),
                "embed": str(state.params["embed"]["embed"]["embedding"].placements)}
        losses = []
        for _ in range(steps):
            state, metrics = step(state, tokens)
            losses.append(float(metrics["loss"]))
    return {"losses": losses, "params": torch_ranks._numpy_tree(state.params),
            "placements": placements}


# --------------------------------------------------------------------- #
# expert parallelism
# --------------------------------------------------------------------- #


def ep_moe(x, router, w_gate, w_up, w_down, *, axes: dict, num_selected: int,
           capacity: Optional[int] = None, do=None, argnums=(0, 2, 4)) -> dict:
    """``expert_parallel_moe`` over globally-shaped tensors: the output,
    the aux loss and, with a cotangent ``do``, the gradients of the
    arguments ``argnums`` (whole)."""
    import torch

    from unionml_tpu_torch.ops.moe import expert_parallel_moe
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axes)
    args = [_t(a, grad=do is not None and i in argnums)
            for i, a in enumerate((x, router, w_gate, w_up, w_down))]
    out, aux = expert_parallel_moe(*args, mesh, num_selected=num_selected, capacity=capacity)
    whole = out.full_tensor()
    result = {"out": _np(whole), "aux": float(aux.full_tensor())}
    if do is not None:
        gs = torch.autograd.grad(whole, [args[i] for i in argnums], grad_outputs=_t(do))
        result["grads"] = [_np(g) for g in gs]
    return result
