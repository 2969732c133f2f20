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
in its ``params`` only, the frozen tree merged in inside the loss. The
gradient-overlap modes wait for parallelism (ROADMAP.md, A6).
"""

from __future__ import annotations

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


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


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
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


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

    return Optimizer(init, update)


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
        """One optimizer update; returns a new state (new tensors)."""
        with torch.no_grad():
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


def value_and_grad(loss_fn: Callable, params: Any, batch: Any):
    """``((loss, aux), grads)`` of ``loss_fn(params, batch) -> (loss,
    aux)`` with respect to every tensor of ``params`` (autograd; a param
    the loss does not reach gets zeros)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    aux = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor) else a, aux)
    return (loss.detach(), aux), tree_unflatten(params, grads)


def accumulated_value_and_grad(
    loss_fn: Callable, params: Any, batch: Any, *, overlap: Any = None
) -> Tuple[Tuple[torch.Tensor, Any], Any]:
    """Mean ``(loss, aux)`` and grads of ``loss_fn(params, microbatch)``
    over the leading microbatch axis of ``batch`` (leaves ``[n_micro,
    micro_batch, ...]``): one forward + backward per microbatch in a Python
    loop, loss / aux / grads summed in fp32, then divided by ``n_micro``
    (grads cast back to their params' dtype), as the reference's serial
    scan does. ``aux`` must be a tree of scalars."""
    if overlap is not None:
        raise NotImplementedError(
            "GradOverlap accumulation modes need the parallelism port (ROADMAP.md, A11)"
        )
    n = tree_leaves(batch)[0].shape[0]
    loss_acc = aux_acc = grad_acc = None
    for i in range(n):
        micro = tree_map(lambda x: x[i], batch)
        (loss, aux), grads = value_and_grad(loss_fn, params, micro)
        loss32 = loss.float()
        aux32 = tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32, device=loss.device),
                         aux)
        grads32 = [g.float() for g in tree_leaves(grads)]
        if loss_acc is None:
            loss_acc, aux_acc, grad_acc = loss32, aux32, grads32
        else:
            loss_acc = loss_acc + loss32
            aux_acc = tree_map(torch.add, aux_acc, aux32)
            grad_acc = _foreach_add(grad_acc, grads32)
    p = tree_leaves(params)
    grads = tree_unflatten(params, [(g / n).to(x.dtype) for g, x in zip(grad_acc, p)])
    return (loss_acc / n, tree_map(lambda a: a / n, aux_acc)), grads


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
    ``aux_loss_weight`` times the layer-mean of the model's auxiliary
    losses, which the port's dense model does not have (its ``aux_loss``
    is 0; MoE waits for A11). Metrics ``loss`` (the cross entropy),
    ``perplexity`` and ``aux_loss`` stay on the device.
    ``accumulate_steps > 1``: the batch leaves carry a leading microbatch
    axis and one optimizer update follows the fp32 grad mean over it."""

    def loss_fn(params, microbatch):
        if isinstance(microbatch, tuple):
            inputs, targets = microbatch
        else:
            inputs, targets = microbatch[:, :-1], microbatch[:, 1:]
        logits = module(params, inputs)
        ce = masked_cross_entropy(logits, targets, ignore_id=ignore_id)
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
