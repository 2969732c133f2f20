"""LoRA / QLoRA parameter-efficient fine-tuning.

The port of :mod:`unionml_tpu.models.lora`. The motivating config is the
serving flagship run in reverse: fine-tune Llama-3-8B on ONE card. Full
fine-tuning does not fit (bf16 params + fp32 master + AdamW m/v ~ 96 GB
against 80 GB); QLoRA does: the int8 base (the tree the serving path
streams) stays frozen, and only rank-r adapters (~0.5% of the params)
carry gradients and optimizer state.

- :class:`LoRADenseGeneral`: what :func:`~unionml_tpu_torch.models.layers
  .make_dense` builds when ``lora_rank > 0``. It reads the base at the
  paths of the layer it replaces (fp ``kernel`` [+ ``bias``], or int8
  ``kernel_q`` + ``scale``) plus ``lora_a`` [K, r] / ``lora_b`` [r, N],
  and adds ``(x @ A) @ (B * alpha / r)`` to the base product: two skinny
  products, never the [K, N] delta.
- :func:`split_lora_params` / :func:`merge_param_trees`: a param tree
  into (adapters, frozen base) and back.
- :class:`LoRATrainState` / :func:`create_lora_train_state`: a train
  state whose ``params`` (and so its AdamW state) are the adapters, with
  the frozen base beside them; the step functions of
  :mod:`~unionml_tpu_torch.models.train` differentiate the adapters only.
- :func:`merge_lora`: the adapters folded into the base for serving (fp
  exactly; int8 by dequantize, add, requantize), a tree the
  ``lora_rank=0`` config loads.

:data:`LORA_PARTITION_RULES`: adapters follow their base kernel's
Megatron layout under ``ShardingConfig(tensor=...)``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Optional, Tuple

import torch
from torch import nn

from unionml_tpu_torch._device import torch_dtype
from unionml_tpu_torch.models.convert import _dense_shapes, _expected
from unionml_tpu_torch.models.quantization import (
    _dense_geometry,
    _quantize_kernel_2d,
    weight_product,
)
from unionml_tpu_torch.models.train import Optimizer, TrainState, adamw
from unionml_tpu_torch.parallel.sharding import PartitionRule

LORA_PARAM_NAMES = ("lora_a", "lora_b")


class LoRADenseGeneral(nn.Module):
    """DenseGeneral with a low-rank trainable delta on a frozen base.

    Params: the fp base ``kernel`` ``[*contracted, *features]`` (plus
    ``bias`` with ``use_bias``) or, ``quantized``, ``kernel_q`` int8
    ``[K, N]`` + ``scale`` fp32 ``[N]``; the adapters ``lora_a`` ``[K, r]``
    and ``lora_b`` ``[r, N]``. The base product accumulates in fp32 with an
    fp32 result (times ``scale`` for int8), the adapter branch is ``x @ A``
    in the compute dtype, then that times ``B * alpha / r`` (cast to the
    compute dtype) accumulated in fp32, and the sum is cast once: the
    reference's rounding points.
    """

    def __init__(self, features, lora_rank: int, lora_alpha: float = 16.0, axis=-1,
                 quantized: bool = False, use_bias: bool = False,
                 dtype: Any = torch.bfloat16):
        super().__init__()
        if lora_rank <= 0:
            raise ValueError("LoRADenseGeneral needs lora_rank >= 1")
        if quantized and use_bias:
            raise ValueError("quantized dense layers are bias-free")
        self.features = features
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.axis = axis
        self.quantized = quantized
        self.use_bias = use_bias
        self.dtype = torch_dtype(dtype)

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        xt, lead, feats, k, n = _dense_geometry(x, self.axis, self.features)
        x2 = xt.reshape(-1, k).to(self.dtype)
        if self.quantized:
            kernel_q = params["kernel_q"]
            if tuple(kernel_q.shape) != (k, n):
                raise ValueError(f"kernel_q is {tuple(kernel_q.shape)}, expected {(k, n)}")
            y = weight_product(x2, kernel_q, params["scale"])
        else:
            y = weight_product(x2, params["kernel"].reshape(k, n).to(self.dtype))
            if self.use_bias:
                y = y + params["bias"].float().reshape(n)
        # the alpha / r scale rides the small [r, N] factor, not the
        # activations
        scale_b = (params["lora_b"] * (self.lora_alpha / self.lora_rank)).to(self.dtype)
        delta = weight_product(x2 @ params["lora_a"].to(self.dtype), scale_b)
        return (y + delta).to(self.dtype).reshape(lead + feats)


# --------------------------------------------------------------------- #
# param-tree surgery
# --------------------------------------------------------------------- #


def split_lora_params(params: Any) -> Tuple[Any, Any]:
    """Partition a param tree into ``(adapters, base)``: ``adapters`` keeps
    the ``lora_a`` / ``lora_b`` leaves in their nesting, ``base`` the rest;
    either side drops the nodes left empty. Walks any ``Mapping``."""

    def walk(tree):
        if not isinstance(tree, Mapping):
            return None, tree
        lora, base = {}, {}
        for key, value in tree.items():
            if key in LORA_PARAM_NAMES:
                lora[key] = value
            elif isinstance(value, Mapping):
                sub_lora, sub_base = walk(value)
                if sub_lora:
                    lora[key] = sub_lora
                if sub_base:
                    base[key] = sub_base
            else:
                base[key] = value
        return lora, base

    lora, base = walk(params)
    return lora or {}, base or {}


def merge_param_trees(base: Any, overlay: Any) -> Any:
    """Structural union of two param trees (``overlay`` wins on a clash);
    new dicts, the leaves themselves shared."""
    if not isinstance(base, Mapping) or not isinstance(overlay, Mapping):
        return overlay
    out = dict(base)
    for key, value in overlay.items():
        out[key] = merge_param_trees(base[key], value) if key in base else value
    return out


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class LoRATrainState(TrainState):
    """A :class:`~unionml_tpu_torch.models.train.TrainState` over the
    adapter tree: ``params`` (and so ``opt_state``) hold only the lora
    leaves; ``frozen_params`` is the base, never differentiated.
    ``full_params()`` is what the model consumes. ``state_dict()`` carries
    the base too, so checkpoints save and restore the whole state."""

    frozen_params: Any = None

    @classmethod
    def create(cls, *, apply_fn, params: Any, tx: Optimizer,
               frozen_params: Any = None) -> "LoRATrainState":
        return cls(step=0, apply_fn=apply_fn, params=params, tx=tx,
                   opt_state=tx.init(params), frozen_params=frozen_params)

    def full_params(self) -> Any:
        return merge_param_trees(self.frozen_params, self.params)

    def state_dict(self) -> dict:
        return {**super().state_dict(), "frozen_params": self.frozen_params}


def _lora_shapes(config) -> dict:
    """The adapter tree's shapes for a Llama ``config``: per block and
    dense site, ``lora_a`` ``[K, r]`` and ``lora_b`` ``[r, N]`` (the LM
    head and the embedding carry none)."""
    r = config.lora_rank
    out: dict = {}
    for i in range(config.num_layers):
        block = out.setdefault(f"block_{i}", {})
        for (part, site), (_, (k, n)) in _dense_shapes(config).items():
            block.setdefault(part, {})[site] = {"lora_a": (k, r), "lora_b": (r, n)}
    return out


def _base_shapes(config) -> dict:
    """The frozen base tree's shapes for a Llama ``config``: fp kernels in
    their DenseGeneral geometry, or (``quantized``) int8 ``kernel_q``
    ``[K, N]`` + ``scale`` ``[N]``, the LM head included."""
    out: dict = {}
    for path, shapes in _expected(config).items():
        if isinstance(shapes[0], tuple):  # a dense site: (fp shape, [K, N])
            fp_shape, (k, n) = shapes
            leaves = ({"kernel_q": (k, n), "scale": (n,)} if config.quantized
                      else {"kernel": fp_shape})
        else:
            path, leaves = path[:-1], {path[-1]: shapes}
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node.update(leaves)
    return out


def init_lora_params(config, generator: torch.Generator, *,
                     dtype: torch.dtype = torch.float32) -> dict:
    """Fresh adapters for ``config`` on ``generator``'s device: ``lora_a``
    normal with std 1/sqrt(K) (fan-in), ``lora_b`` zeros, so the delta
    starts at 0 and step 0 is the base model bit for bit."""
    dev = generator.device

    def draw(path, shape):
        if path[-1] == "lora_b":
            return torch.zeros(shape, device=dev, dtype=dtype)
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (w * shape[0] ** -0.5).to(dtype)

    return _map_shapes(draw, _lora_shapes(config))


def _map_shapes(fn, shapes: dict, path: tuple = ()) -> dict:
    return {key: _map_shapes(fn, val, path + (key,)) if isinstance(val, dict)
            else fn(path + (key,), val) for key, val in shapes.items()}


def _skeleton(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {key: _skeleton(val) for key, val in tree.items()}
    return None


def _check_base(config, base: Mapping) -> None:
    want = _base_shapes(config)
    if _skeleton(want) != _skeleton(base):
        raise ValueError(
            "base_params structure does not match the module's frozen parameters:\n"
            f"  expected {_skeleton(want)}\n  got      {_skeleton(base)}"
        )

    def check(path, shape):
        leaf = base
        for key in path:
            leaf = leaf[key]
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(
                f"base_params leaf shape {tuple(leaf.shape)} does not match the module's "
                f"expected {tuple(shape)} ({'/'.join(path)})"
            )

    _map_shapes(check, want)


def create_lora_train_state(
    module: nn.Module,
    example_input: torch.Tensor,
    *,
    base_params: Optional[Any] = None,
    optimizer: Optional[Optimizer] = None,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.0,
    seed: int = 0,
) -> LoRATrainState:
    """A LoRA fine-tune state for ``module`` (a ``Llama`` whose config has
    ``lora_rank > 0``) on ``example_input``'s device.

    The frozen base is ``base_params`` when given (a trained or
    ``quantize_params``-converted tree matching the module's non-lora
    params, checked against the config's shapes; never copied), else the
    base of ``module.init``. Adapters come from a :class:`torch.Generator`
    seeded with ``seed`` (:func:`init_lora_params`). ``optimizer``
    defaults to :func:`~unionml_tpu_torch.models.train.adamw` at
    ``learning_rate``."""
    config = getattr(module, "config", None)
    if config is None or getattr(config, "lora_rank", 0) <= 0:
        raise ValueError(
            "module has no lora_a/lora_b parameters — set lora_rank > 0 "
            "on its config before building a LoRA train state"
        )
    gen = torch.Generator(device=example_input.device).manual_seed(seed)
    if base_params is None:
        adapters, frozen = split_lora_params(module.init(gen, example_input))
    else:
        base_lora, frozen = split_lora_params(base_params)
        if base_lora:
            raise ValueError(
                "base_params already contain lora adapters; merge or strip "
                "them first (merge_lora / split_lora_params)"
            )
        _check_base(config, frozen)
        adapters = init_lora_params(config, gen)
    tx = optimizer or adamw(learning_rate, weight_decay=weight_decay)
    return LoRATrainState.create(apply_fn=module, params=adapters, tx=tx, frozen_params=frozen)


# --------------------------------------------------------------------- #
# serving-time merge
# --------------------------------------------------------------------- #


def merge_lora(params: Any, *, alpha: float) -> Any:
    """Fold the adapters into their base kernels; returns a lora-free tree
    that the same architecture with ``lora_rank=0`` loads, so every
    serving surface takes fine-tuned weights with no LoRA plumbing.

    ``delta = (A @ B) * alpha / r`` in fp32 (r read off the shapes). fp
    kernels: ``kernel + delta`` in fp32, reshaped to the kernel's geometry,
    cast back to its dtype. int8 kernels: ``kernel_q * scale + delta``
    requantized per output channel (:func:`~unionml_tpu_torch.models
    .quantization._quantize_kernel_2d`). ``alpha`` is required and must be
    the config's ``lora_alpha`` the adapters were trained with: the tree
    does not hold it, and a wrong one gives a valid-looking, wrong tree.
    Tensors stay on their device."""

    def walk(tree):
        if not isinstance(tree, Mapping):
            return tree
        if "lora_a" in tree and "lora_b" in tree:
            a, b = tree["lora_a"].float(), tree["lora_b"].float()
            delta = (a @ b) * (alpha / a.shape[-1])                 # [K, N]
            out = {key: val for key, val in tree.items() if key not in LORA_PARAM_NAMES}
            if "kernel" in tree:
                kernel = tree["kernel"]
                out["kernel"] = (kernel.float() + delta.reshape(kernel.shape)).to(kernel.dtype)
            elif "kernel_q" in tree:
                w = tree["kernel_q"].float() * tree["scale"].float()
                out["kernel_q"], out["scale"] = _quantize_kernel_2d(w + delta)
            else:
                raise ValueError(
                    "lora adapters found beside neither 'kernel' nor "
                    f"'kernel_q' (keys: {sorted(tree)})"
                )
            return out
        return {key: walk(val) for key, val in tree.items()}

    return walk(params)


# adapters follow their base kernel's Megatron layout: B shards N where the
# base shards N (column-parallel q/k/v/gate/up), A shards K where the base
# shards K (row-parallel o/down). The rank dim stays whole. lm_head and the
# embedding carry no adapters.
LORA_PARTITION_RULES = (
    PartitionRule(r"attn/(q|k|v)/lora_b$", (None, "tensor")),
    PartitionRule(r"attn/(q|k|v)/lora_a$", (None, None)),
    PartitionRule(r"attn/o/lora_a$", ("tensor", None)),
    PartitionRule(r"attn/o/lora_b$", (None, None)),
    PartitionRule(r"mlp/(gate|up)/lora_b$", (None, "tensor")),
    PartitionRule(r"mlp/(gate|up)/lora_a$", (None, None)),
    PartitionRule(r"mlp/down/lora_a$", ("tensor", None)),
    PartitionRule(r"mlp/down/lora_b$", (None, None)),
)
