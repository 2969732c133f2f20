"""Train state, optimizer and step-function factories of the model zoo.

The port of :mod:`unionml_tpu.models.train`: :class:`TrainState` (params,
optimizer state, apply function, step counter), :func:`adamw` (the
reference's optax chain ``scale_by_adam -> add_decayed_weights ->
scale_by_learning_rate``, ``mu_dtype`` for the first moment only),
:func:`create_train_state`, the serial :func:`accumulated_value_and_grad`
(a Python loop with an fp32 accumulator), :func:`classification_step`,
:func:`lm_step`, :func:`masked_cross_entropy`, :func:`make_evaluator` and
:func:`make_predictor`. A step function is ``step(state, batch) -> (state,
metrics)`` as in the reference; autograd takes the place of
``jax.value_and_grad`` and the optimizer builds new param tensors (the
reference's functional update), with the multi-tensor ``torch._foreach``
ops where the dtypes allow. A state with ``frozen_params`` (the LoRA
train state of :mod:`~unionml_tpu_torch.models.lora`) is differentiated
in its ``params`` only, the frozen tree merged in inside the loss.

Under a :class:`~unionml_tpu_torch.parallel.ShardingConfig` the params are
DTensors: :func:`value_and_grad` brings each gradient to its param's
placements (the batch axes' sum) before anything consumes it, and an
elementwise optimizer (``Optimizer.elementwise``, :func:`adamw`) updates
each rank's local shards. :class:`GradOverlap` restructures gradient
accumulation so the gradient collectives of one microbatch run during the
next one's backward (``"defer"``, or ``"shard_map"`` with explicit
:func:`~unionml_tpu_torch.parallel.collectives.bucketed_psum` buckets).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from unionml_tpu_torch._device import torch_dtype

# --------------------------------------------------------------------- #
# param trees (nested dicts / tuples / lists of tensors)
# --------------------------------------------------------------------- #


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a nested dict / tuple / list in a fixed order (dict
    insertion order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _build(node: Any, it) -> Any:
    if isinstance(node, dict):
        return {k: _build(v, it) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order. The recursion is a module function: a
    nested recursive function would keep the leaves in a reference cycle
    (the function, its closure cell) until the cyclic collector ran,
    holding a step's whole param and gradient trees on the card
    (ROADMAP.md C12)."""
    return _build(like, iter(leaves))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


def tree_device(tree: Any) -> torch.device:
    """The device of a tree's first tensor leaf."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("the tree holds no tensor")


# --------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------- #


class Optimizer(NamedTuple):
    """An optax-style gradient transformation: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, state)``. ``elementwise``:
    each output element depends on the same element of its inputs only
    (no norm over a tensor), so sharded params update shard by shard."""

    init: Callable
    update: Callable
    elementwise: bool = False


def _foreach_add(a: List[torch.Tensor], b: List[torch.Tensor]) -> List[torch.Tensor]:
    if all(x.dtype == y.dtype for x, y in zip(a, b)):
        return list(torch._foreach_add(a, b))
    return [x + y for x, y in zip(a, b)]  # type promotion, per tensor


def adamw(
    learning_rate: Union[float, Callable[[int], float]],
    *,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    mu_dtype: Optional[Any] = None,
) -> Optimizer:
    """AdamW as the reference's explicit chain: ``scale_by_adam(b1, b2,
    eps, mu_dtype)``, then ``add_decayed_weights(weight_decay)`` when it is
    non-zero, then ``scale_by_learning_rate(learning_rate)`` (a float, or a
    schedule of the step count). The arithmetic is optax's: ``mu = (1 - b1)
    g + b1 mu`` (``b1 mu`` in ``mu``'s stored dtype, ``b1`` rounded to it),
    ``nu = (1 - b2) g^2 + b2 nu``, bias corrections ``1 - b^count`` in
    fp32, ``update = mu_hat / (sqrt(nu_hat) + eps)``, the new ``mu`` stored
    in ``mu_dtype`` (e.g. bf16, the first moment only) and ``nu`` in the
    params' dtype."""
    mu_dt = torch_dtype(mu_dtype) if mu_dtype is not None else None

    def init(params):
        leaves = tree_leaves(params)
        return {
            "count": 0,
            "mu": tree_unflatten(params, [torch.zeros_like(p, dtype=mu_dt or p.dtype)
                                          for p in leaves]),
            "nu": tree_unflatten(params, [torch.zeros_like(p) for p in leaves]),
        }

    def update(grads, state, params):
        g = tree_leaves(grads)
        p = tree_leaves(params)
        count = state["count"] + 1
        # b1 * mu runs in mu's stored dtype with b1 rounded to it (0.9 is
        # 0.8984375 in bf16), as JAX multiplies by a weakly typed scalar
        b1_mu = float(torch.tensor(b1, dtype=mu_dt)) if mu_dt is not None else b1
        mu = _foreach_add(list(torch._foreach_mul(g, 1 - b1)),
                          list(torch._foreach_mul(tree_leaves(state["mu"]), b1_mu)))
        nu = _foreach_add(list(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2)),
                          list(torch._foreach_mul(tree_leaves(state["nu"]), b2)))
        # 1 - decay**count in fp32, as optax computes it
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if weight_decay:
            upd = _foreach_add(list(upd), list(torch._foreach_mul(p, weight_decay)))
        lr = learning_rate(state["count"]) if callable(learning_rate) else learning_rate
        upd = torch._foreach_mul(upd, -lr)
        if mu_dt is not None:
            mu = [m.to(mu_dt) for m in mu]
        new_state = {
            "count": count,
            "mu": tree_unflatten(params, mu),
            "nu": tree_unflatten(params, nu),
        }
        return tree_unflatten(params, list(upd)), new_state

    return Optimizer(init, update, elementwise=True)


def apply_updates(params: Any, updates: Any) -> Any:
    """``params + updates``, each in its param's dtype (optax's rule)."""
    p, u = tree_leaves(params), tree_leaves(updates)
    return tree_unflatten(params, [x.to(a.dtype) for a, x in zip(p, _foreach_add(p, u))])


# --------------------------------------------------------------------- #
# train state
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class TrainState:
    """Params + optimizer state + apply function + step counter (flax's
    TrainState). ``apply_fn(params, inputs)`` runs the model."""

    step: int
    apply_fn: Callable
    params: Any
    tx: Optimizer
    opt_state: Any

    @classmethod
    def create(cls, *, apply_fn: Callable, params: Any, tx: Optimizer) -> "TrainState":
        return cls(step=0, apply_fn=apply_fn, params=params, tx=tx, opt_state=tx.init(params))

    def apply_gradients(self, *, grads: Any) -> "TrainState":
        """One optimizer update; returns a new state (new tensors). Sharded
        params under an elementwise optimizer update on each rank's local
        shards (the same arithmetic as unsharded, no DTensor dispatch)."""
        with torch.no_grad():
            if self.tx.elementwise and _any_dtensor(self.params):
                params, opt_state = _local_update(self.tx, grads, self.opt_state, self.params)
            else:
                updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
                params = apply_updates(self.params, updates)
        return dataclasses.replace(self, step=self.step + 1, params=params, opt_state=opt_state)

    def state_dict(self) -> dict:
        """The tensors and counters an artifact keeps (no functions)."""
        return {"step": self.step, "params": self.params, "opt_state": self.opt_state}

    def load_state_dict(self, state: dict) -> "TrainState":
        """A copy of this state (same apply function and optimizer) holding
        ``state``'s values (every tree ``state_dict()`` gives), each tensor
        moved onto this state's device and dtype."""
        def take(mine, saved):
            if isinstance(mine, torch.Tensor):
                return saved.to(device=mine.device, dtype=mine.dtype)
            return saved

        trees = {key: tree_map(take, getattr(self, key), saved)
                 for key, saved in state.items() if key != "step"}
        return dataclasses.replace(self, step=int(state["step"]), **trees)


def _any_dtensor(tree: Any) -> bool:
    from unionml_tpu_torch.parallel.compat import is_dtensor

    return any(is_dtensor(leaf) for leaf in tree_leaves(tree))


def _local_update(tx: Optimizer, grads: Any, opt_state: Any, params: Any):
    """``tx`` applied to the local shards of DTensor params, grads and
    optimizer state (each grad already at its param's placements), the
    results wrapped back with the placements of the leaves they replace."""
    from torch.distributed.tensor import DTensor

    from unionml_tpu_torch.parallel.compat import is_dtensor

    def local(t):
        return t.to_local() if is_dtensor(t) else t

    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        if is_dtensor(p) and (not is_dtensor(g) or tuple(g.placements) != tuple(p.placements)
                              or g.to_local().shape != p.to_local().shape):
            raise ValueError(
                f"a gradient ({getattr(g, 'placements', None)}, local "
                f"{tuple(local(g).shape)}) is not laid out as its param ({p.placements}, "
                f"local {tuple(p.to_local().shape)}): resolve it with "
                "parallel.sharding.resolve_grads before the optimizer"
            )

    def wrap(old, new):
        if not is_dtensor(old):
            return new
        return DTensor.from_local(new, old.device_mesh, old.placements, run_check=False,
                                  shape=old.shape, stride=old.stride())

    lp = tree_map(local, params)
    updates, new_opt = tx.update(tree_map(local, grads), tree_map(local, opt_state), lp)
    new_params = apply_updates(lp, updates)
    return tree_map(wrap, params, new_params), tree_map(wrap, opt_state, new_opt)


def create_train_state(
    module: torch.nn.Module,
    example_input: torch.Tensor,
    *,
    optimizer: Optional[Optimizer] = None,
    learning_rate: float = 1e-3,
    weight_decay: float = 0.0,
    seed: int = 0,
    init_kwargs: Optional[dict] = None,
) -> TrainState:
    """Initialize params on ``example_input``'s device with
    ``module.init(generator, example_input)`` (a :class:`torch.Generator`
    seeded with ``seed``) and wrap them with :func:`adamw` (or
    ``optimizer``)."""
    gen = torch.Generator(device=example_input.device).manual_seed(seed)
    params = module.init(gen, example_input, **(init_kwargs or {}))
    tx = optimizer or adamw(learning_rate, weight_decay=weight_decay)
    return TrainState.create(apply_fn=module, params=params, tx=tx)


def resolve_params(state: Any) -> Any:
    """The full param tree behind a state-or-params argument: a bare
    tree passes through, a state with ``full_params()`` (LoRA) resolves
    to it, any other state to its ``.params``."""
    if hasattr(state, "full_params"):
        return state.full_params()
    return state.params if hasattr(state, "params") else state


# --------------------------------------------------------------------- #
# gradients and steps
# --------------------------------------------------------------------- #


def _value_and_partial_grad(loss_fn: Callable, params: Any, batch: Any):
    """:func:`value_and_grad` with each DTensor gradient as the backward
    left it (a ``Partial`` sum over the batch axes not yet reduced)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    aux = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor) else a, aux)
    return (loss.detach(), aux), tree_unflatten(params, grads)


def _pending_grads(params: Any, grads: Any):
    """The reduction of ``grads`` to their params' placements, issued
    (its ``wait()`` gives the tree; plain gradients need none)."""
    from unionml_tpu_torch.parallel.sharding import PendingGrads

    return PendingGrads(params, grads)


def value_and_grad(loss_fn: Callable, params: Any, batch: Any):
    """``((loss, aux), grads)`` of ``loss_fn(params, batch) -> (loss,
    aux)`` with respect to every tensor of ``params`` (autograd; a param
    the loss does not reach gets zeros). DTensor gradients come laid out as
    their params (:func:`~unionml_tpu_torch.parallel.sharding
    .resolve_grads`)."""
    (loss, aux), grads = _value_and_partial_grad(loss_fn, params, batch)
    if _any_dtensor(grads):
        grads = _pending_grads(params, grads).wait()
    return (loss, aux), grads


class GradOverlap(NamedTuple):
    """How gradient accumulation overlaps the gradient collectives with
    compute (the reference's :class:`unionml_tpu.models.train.GradOverlap`).

    ``mode="defer"`` keeps the reduction of each microbatch's gradients
    to their params' placements but issues it asynchronously
    (:class:`~unionml_tpu_torch.parallel.sharding.PendingGrads`) and
    consumes it in iteration *i + 1*, after that microbatch's backward.
    Any mesh; the same adds in the same order as the serial loop.

    ``mode="shard_map"`` takes the data-axis all-reduce manual: the loop
    runs under :func:`~unionml_tpu_torch.parallel.compat.shard_map` over
    ``axes`` (params replicated across them) on plain local tensors, and
    each microbatch's fp32 gradients go out as asynchronous
    :func:`~unionml_tpu_torch.parallel.collectives.bucketed_psum` buckets,
    waited during the next microbatch. Valid only when every other mesh
    axis is trivial."""

    mode: str
    mesh: Any = None
    axes: Tuple[str, ...] = ()
    #: None = bucketed_psum's own DEFAULT_PSUM_BUCKET_BYTES
    bucket_bytes: Optional[int] = None


_GRAD_OVERLAP: contextvars.ContextVar = contextvars.ContextVar(
    "unionml_torch_grad_overlap", default=None
)


@contextlib.contextmanager
def grad_overlap_scope(overlap: Optional[GradOverlap]):
    """Make ``overlap`` the ambient accumulation strategy: every
    :func:`accumulated_value_and_grad` run inside the scope (the zoo's
    step factories under a trainer loop with ``overlap_grads=True``)
    adopts it without the step author passing it through."""
    token = _GRAD_OVERLAP.set(overlap)
    try:
        yield overlap
    finally:
        _GRAD_OVERLAP.reset(token)


def current_grad_overlap() -> Optional[GradOverlap]:
    """The ambient :class:`GradOverlap` (None = serial accumulation)."""
    return _GRAD_OVERLAP.get()


def _as_f32(a: Any, like: torch.Tensor) -> torch.Tensor:
    return a.float() if isinstance(a, torch.Tensor) else \
        torch.as_tensor(a, dtype=torch.float32, device=like.device)


def accumulated_value_and_grad(
    loss_fn: Callable, params: Any, batch: Any, *, overlap: Optional[GradOverlap] = None
) -> Tuple[Tuple[torch.Tensor, Any], Any]:
    """Mean ``(loss, aux)`` and grads of ``loss_fn(params, microbatch)``
    over the leading microbatch axis of ``batch`` (leaves ``[n_micro,
    micro_batch, ...]``): one forward + backward per microbatch in a Python
    loop, loss / aux / grads summed in fp32, then divided by ``n_micro``
    (grads cast back to their params' dtype), as the reference's serial
    scan does. ``aux`` must be a tree of scalars. ``overlap`` (default:
    the ambient :func:`grad_overlap_scope`) selects a :class:`GradOverlap`
    mode; each gives the serial loop's values."""
    if overlap is None:
        overlap = _GRAD_OVERLAP.get()
    if overlap is not None and overlap.mode not in ("defer", "shard_map"):
        raise ValueError(
            f"unknown GradOverlap mode {overlap.mode!r}: expected 'defer' or 'shard_map'"
        )
    if overlap is not None and overlap.mode == "shard_map":
        return _shard_map_accumulated(loss_fn, params, batch, overlap)
    defer = overlap is not None
    n = tree_leaves(batch)[0].shape[0]
    loss_acc = aux_acc = grad_acc = pending = None

    def consume(grad_acc, grads):
        grads32 = [g.float() for g in tree_leaves(grads)]
        return grads32 if grad_acc is None else _foreach_add(grad_acc, grads32)

    for i in range(n):
        micro = tree_map(lambda x: x[i], batch)
        if defer:
            (loss, aux), grads = _value_and_partial_grad(loss_fn, params, micro)
            if pending is not None:
                # the previous microbatch's reduction ran behind this one's
                # backward; consume it now, before issuing this one's
                grad_acc = consume(grad_acc, pending.wait())
            pending = _pending_grads(params, grads)
        else:
            (loss, aux), grads = value_and_grad(loss_fn, params, micro)
            grad_acc = consume(grad_acc, grads)
        loss32 = loss.float()
        aux32 = tree_map(lambda a: _as_f32(a, loss), aux)
        if loss_acc is None:
            loss_acc, aux_acc = loss32, aux32
        else:
            loss_acc = loss_acc + loss32
            aux_acc = tree_map(torch.add, aux_acc, aux32)
    if defer:
        grad_acc = consume(grad_acc, pending.wait())
    p = tree_leaves(params)
    grads = tree_unflatten(params, [(g / n).to(x.dtype) for g, x in zip(grad_acc, p)])
    return (loss_acc / n, tree_map(lambda a: a / n, aux_acc)), grads


def _shard_map_accumulated(
    loss_fn: Callable, params: Any, batch: Any, overlap: GradOverlap
) -> Tuple[Tuple[torch.Tensor, Any], Any]:
    """The manual-collective accumulation: the loop inside
    :func:`~unionml_tpu_torch.parallel.compat.shard_map` over the batch
    axes on plain local tensors, each microbatch's fp32 gradients issued
    as asynchronous :func:`bucketed_psum` buckets and waited in the next
    iteration; loss and aux ``pmean``-ed. The sum over ``ndev`` ranks of
    local-mean gradients is divided by ``n * ndev`` in one division."""
    from unionml_tpu_torch.parallel.collectives import bucketed_psum, pmean
    from unionml_tpu_torch.parallel.compat import axis_size, shard_map
    from unionml_tpu_torch.parallel.sharding import PartitionSpec as P

    axes = tuple(overlap.axes)
    if overlap.mesh is None or not axes:
        raise ValueError(
            "GradOverlap(mode='shard_map') needs a mesh and at least one reduce axis "
            "(the batch axes the grads all-reduce over)"
        )
    axis_arg = axes if len(axes) > 1 else axes[0]
    bucket_kw = {} if overlap.bucket_bytes is None else {"bucket_bytes": overlap.bucket_bytes}

    def local(params, batch):
        n = tree_leaves(batch)[0].shape[0]
        loss_acc = aux_acc = grad_acc = pending = None
        for i in range(n):
            micro = tree_map(lambda x: x[i], batch)
            if pending is not None:
                reduced = tree_leaves(pending.wait())
                grad_acc = reduced if grad_acc is None else _foreach_add(grad_acc, reduced)
            (loss, aux), grads = value_and_grad(loss_fn, params, micro)
            pending = bucketed_psum([g.float() for g in tree_leaves(grads)], axis_arg,
                                    wait=False, **bucket_kw)
            loss32 = pmean(loss.float(), axis_arg)
            aux32 = tree_map(lambda a: pmean(_as_f32(a, loss), axis_arg), aux)
            if loss_acc is None:
                loss_acc, aux_acc = loss32, aux32
            else:
                loss_acc = loss_acc + loss32
                aux_acc = tree_map(torch.add, aux_acc, aux32)
        reduced = tree_leaves(pending.wait())
        grad_acc = reduced if grad_acc is None else _foreach_add(grad_acc, reduced)
        scale = n * axis_size(axis_arg)
        p = tree_leaves(params)
        grads = tree_unflatten(params, [(g / scale).to(x.dtype) for g, x in zip(grad_acc, p)])
        return (loss_acc / n, tree_map(lambda a: a / n, aux_acc)), grads

    fn = shard_map(local, overlap.mesh, in_specs=(P(), P(None, axis_arg)),
                   out_specs=((P(), P()), P()), check_rep=False)
    (loss, aux), grads = fn(params, batch)
    from unionml_tpu_torch.parallel.compat import is_dtensor

    # the replicated sums cut to each param's own layout (an fsdp-sharded
    # param takes its block, no collective), as GSPMD reshards them
    grads = tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                     if is_dtensor(p) and tuple(g.placements) != tuple(p.placements) else g,
                     grads, params)
    return (loss, aux), grads


def _bind_frozen(loss_fn: Callable, state: Any) -> Callable:
    """A loss over FULL params adapted to a state that differentiates a
    subset: for a state with ``frozen_params`` (the LoRA train state) the
    trainable tree (``state.params``, the adapters) is merged over the
    frozen base inside the loss, so autograd sees only the adapters (the
    int8 base could not require a gradient) and the optimizer state stays
    adapter-sized."""
    frozen = getattr(state, "frozen_params", None)
    if frozen is None:
        return loss_fn
    from unionml_tpu_torch.models.lora import merge_param_trees

    return lambda params, batch: loss_fn(merge_param_trees(frozen, params), batch)


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


def masked_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, *, ignore_id: int = -100
) -> torch.Tensor:
    """Mean cross entropy over positions where ``targets != ignore_id``
    (fp32 math)."""
    logits = logits.float()
    mask = (targets != ignore_id).float()
    safe = torch.where(targets == ignore_id, torch.zeros_like(targets), targets)
    ce = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), safe.reshape(-1).long(), reduction="none"
    ).reshape(targets.shape)
    return (ce * mask).sum() / mask.sum().clamp_min(1.0)


def classification_step(module: torch.nn.Module, *, accumulate_steps: int = 1) -> Callable:
    """softmax-CE step for ``(features, int_labels)`` batches; metrics
    ``loss`` and ``accuracy`` stay on the device. ``accumulate_steps > 1``:
    the batch leaves carry a leading microbatch axis and one optimizer
    update follows the grad mean over it (gradient accumulation)."""

    def loss_fn(params, microbatch):
        features, labels = microbatch
        logits = module(params, features)
        loss = F.cross_entropy(logits.float(), labels.long())
        return loss, {"accuracy": _accuracy(logits, labels)}

    def step(state: TrainState, batch: Tuple[Any, Any]):
        bound = _bind_frozen(loss_fn, state)
        if accumulate_steps > 1:
            (loss, aux), grads = accumulated_value_and_grad(bound, state.params, batch)
        else:
            (loss, aux), grads = value_and_grad(bound, state.params, batch)
        state = state.apply_gradients(grads=grads)
        return state, {"loss": loss, "accuracy": aux["accuracy"]}

    return step


def lm_step(
    module: torch.nn.Module,
    *,
    ignore_id: int = -100,
    aux_loss_weight: float = 0.01,
    accumulate_steps: int = 1,
) -> Callable:
    """Next-token LM step: the batch is token ids [B, S] and the loss runs
    over the shifted pairs (``tokens[:, :-1]`` predicts ``tokens[:, 1:]``),
    or an ``(inputs, labels)`` tuple whose labels carry ``ignore_id`` at
    unsupervised positions. The loss is :func:`masked_cross_entropy` plus
    ``aux_loss_weight`` times the layer-mean of the load-balance losses
    the model's MoE blocks sow (``forward(..., sow=)``; 0 for a dense
    model). Metrics ``loss`` (the cross entropy), ``perplexity`` and
    ``aux_loss`` (that layer-mean) stay on the device.
    ``accumulate_steps > 1``: the batch leaves carry a leading microbatch
    axis and one optimizer update follows the fp32 grad mean over it."""

    import inspect

    # a model with auxiliary losses takes a ``sow`` dict (Llama's MoE blocks)
    sows = "sow" in inspect.signature(module.forward).parameters

    def loss_fn(params, microbatch):
        if isinstance(microbatch, tuple):
            inputs, targets = microbatch
        else:
            inputs, targets = microbatch[:, :-1], microbatch[:, 1:]
        sown: dict = {}
        logits = module(params, inputs, sow=sown) if sows else module(params, inputs)
        ce = masked_cross_entropy(logits, targets, ignore_id=ignore_id)
        losses = sown.get("aux_losses", [])
        if losses:
            aux = sum(a.float() for a in losses) / len(losses)
        else:
            aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux_loss_weight * aux, {"ce": ce, "aux": aux}

    def step(state: TrainState, batch):
        bound = _bind_frozen(loss_fn, state)
        if accumulate_steps > 1:
            (_, aux), grads = accumulated_value_and_grad(bound, state.params, batch)
        else:
            (_, aux), grads = value_and_grad(bound, state.params, batch)
        state = state.apply_gradients(grads=grads)
        loss = aux["ce"]
        return state, {"loss": loss, "perplexity": torch.exp(loss), "aux_loss": aux["aux"]}

    return step


def _as_input(features: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(features) if not isinstance(features, torch.Tensor)
                           else features, device=device)


def make_evaluator(module: torch.nn.Module) -> Callable:
    """An ``@model.evaluator``-compatible fn: ``(state, features, labels)
    -> accuracy`` as a float."""

    def evaluator(state: Any, features: Any, labels: Any) -> float:
        params = resolve_params(state)
        dev = tree_device(params)
        with torch.no_grad():
            logits = module(params, _as_input(features, dev))
        return float(_accuracy(logits, _as_input(labels, dev)))

    return evaluator


def make_predictor(module: torch.nn.Module) -> Callable:
    """An ``@model.predictor``-compatible fn: argmax class predictions (a
    tensor on the params' device)."""

    def predictor(state: Any, features: Any) -> torch.Tensor:
        params = resolve_params(state)
        with torch.no_grad():
            return module(params, _as_input(features, tree_device(params))).argmax(dim=-1)

    return predictor
