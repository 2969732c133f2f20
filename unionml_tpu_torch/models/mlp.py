"""MLP classifier, the single-chip MNIST-style config, in PyTorch.

The port of :mod:`unionml_tpu.models.mlp`: flatten, then a Dense + ReLU
per hidden width in ``config.dtype`` (bf16 by default), then an fp32
``head``. Params are fp32, in the reference's layout (``dense_{i}`` and
``head``, each ``kernel`` ``[in, out]`` and ``bias`` ``[out]``), so
:func:`~unionml_tpu_torch.models.convert.mlp_from_jax_params` carries a
JAX tree over unchanged. Dropout (``train=True`` with ``dropout > 0``)
draws its keep mask from an explicit :class:`torch.Generator`; the
reference's flax draws cannot be matched (ROADMAP.md, documented
reference behaviours). :data:`MLP_PARTITION_RULES` is empty, as in the
reference: the model replicates, and the FSDP fallback applies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device, torch_dtype
from unionml_tpu_torch.models.quantization import DenseGeneral

MLP_PARTITION_RULES = ()  # small enough to replicate; FSDP fallback applies


@dataclass(frozen=True)
class MlpConfig:
    num_classes: int = 10
    hidden_dims: Sequence[int] = (256, 256)
    dropout: float = 0.0
    dtype: str = "bfloat16"


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax's: keep each element with probability
    ``1 - rate`` (a uniform draw from ``generator`` below it) and divide
    the kept ones by that probability."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator (generator=)")
    keep_prob = 1.0 - rate
    if keep_prob == 0.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Mlp(nn.Module):
    """``forward(params, x, *, train=False, generator=None)`` over ``x``
    ``[B, ...]`` (flattened) returns fp32 logits ``[B, num_classes]``."""

    def __init__(self, config: Optional[MlpConfig] = None):
        super().__init__()
        self.config = config or MlpConfig()
        dtype = torch_dtype(self.config.dtype)
        self.dtype = dtype
        self.hidden = nn.ModuleList(
            DenseGeneral(dim, dtype=dtype, use_bias=True) for dim in self.config.hidden_dims
        )
        self.head = DenseGeneral(self.config.num_classes, dtype=torch.float32, use_bias=True)

    def init(self, generator: torch.Generator, example_input: torch.Tensor) -> dict:
        """Random params for inputs shaped like ``example_input`` on its
        device (:func:`init_params`)."""
        in_features = example_input.reshape(example_input.shape[0], -1).shape[1]
        return init_params(self.config, in_features, generator=generator,
                           device=example_input.device)

    def forward(self, params, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i, dense in enumerate(self.hidden):
            x = torch.relu(dense(params[f"dense_{i}"], x))
            if cfg.dropout and train:
                x = dropout(x, cfg.dropout, generator)
        return self.head(params["head"], x)


def init_params(
    config: MlpConfig,
    in_features: int,
    *,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> dict:
    """A random fp32 param tree in the reference's layout for inputs of
    ``in_features`` (after flattening) on ``device`` (``None`` = CUDA,
    raising without one), drawn from ``generator`` (seed 0 when omitted):
    kernels normal with std 1/sqrt(fan_in), biases zero."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    params = {}
    fan_in = in_features
    widths = [*config.hidden_dims, config.num_classes]
    names = [f"dense_{i}" for i in range(len(config.hidden_dims))] + ["head"]
    for name, width in zip(names, widths):
        kernel = torch.randn((fan_in, width), generator=gen, device=dev) * fan_in**-0.5
        params[name] = {"kernel": kernel, "bias": torch.zeros(width, device=dev)}
        fan_in = width
    return params
