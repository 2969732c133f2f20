"""Weight-only int8 quantization for serving.

The port of the int8 half of :mod:`unionml_tpu.models.quantization`:
:class:`QuantizedDenseGeneral` (DenseGeneral geometry, ``kernel_q`` int8
``[K, N]`` + ``scale`` fp32 ``[N]``) and :func:`quantize_params` with
``bits=8``. The product runs as a plain matrix product with fp32
accumulation and an fp32 result, then ``* scale``, then ONE cast to the
compute dtype — the
reference's rounding point (a product that rounds to bf16 before the
scale would be a different result). The packed-int4 layout and MoE
expert blocks are not ported yet and raise.
"""

from __future__ import annotations

import re
from typing import Any, Sequence, Tuple

import torch
from torch import nn

from unionml_tpu_torch._device import torch_dtype


def _dense_geometry(x: torch.Tensor, axis, features):
    """Shared DenseGeneral geometry: normalize contraction axes, flatten
    the input to ``[..., K]`` and report ``(xt, lead, feats, k, n)``."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % x.dim() for a in axes)
    feats = (features,) if isinstance(features, int) else tuple(features)
    k = 1
    for a in axes:
        k *= x.shape[a]
    n = 1
    for f in feats:
        n *= f
    batch_axes = tuple(i for i in range(x.dim()) if i not in axes)
    xt = x.permute(*batch_axes, *axes).reshape(
        tuple(x.shape[i] for i in batch_axes) + (k,)
    )
    return xt, tuple(xt.shape[:-1]), feats, k, n


class DenseGeneral(nn.Module):
    """Bias-free fp dense layer with flax ``DenseGeneral`` geometry: the
    kernel is ``[*contracted dims, *features]`` and input and kernel are
    cast to ``dtype`` before the product."""

    def __init__(self, features, axis=-1, dtype: Any = torch.bfloat16):
        super().__init__()
        self.features = features
        self.axis = axis
        self.dtype = torch_dtype(dtype)

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        axes = (self.axis,) if isinstance(self.axis, int) else tuple(self.axis)
        axes = [a % x.dim() for a in axes]
        kernel = params["kernel"].to(self.dtype)
        return torch.tensordot(
            x.to(self.dtype), kernel, dims=(axes, list(range(len(axes))))
        )


class QuantizedDenseGeneral(nn.Module):
    """Weight-only int8 dense layer matching DenseGeneral geometry.

    ``axis``: input dims to contract (int or tuple, negative indices);
    ``features``: output dims (int or tuple). The kernel is stored 2D
    ``[K, N]`` int8 with a per-output-channel fp32 ``scale`` ``[N]``.
    """

    def __init__(self, features, axis=-1, dtype: Any = torch.bfloat16):
        super().__init__()
        self.features = features
        self.axis = axis
        self.dtype = torch_dtype(dtype)

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        xt, lead, feats, k, n = _dense_geometry(x, self.axis, self.features)
        kernel_q, scale = params["kernel_q"], params["scale"]
        if tuple(kernel_q.shape) != (k, n):
            raise ValueError(f"kernel_q is {tuple(kernel_q.shape)}, expected {(k, n)}")
        # inputs round to the compute dtype as in the reference; the
        # product then accumulates in fp32 and is NOT rounded before the
        # scale. On the card a bf16/fp16 product runs on the tensor cores
        # with an fp32 result; elsewhere an fp32 product of the same
        # values (int8 and bf16 are exact in fp32) gives the same numbers
        x2 = xt.reshape(-1, k).to(self.dtype)
        if x2.is_cuda and self.dtype in (torch.bfloat16, torch.float16):
            y = torch.mm(x2, kernel_q.to(self.dtype), out_dtype=torch.float32)
        else:
            y = x2.float() @ kernel_q.float()
        y = y * scale.float()
        return y.to(self.dtype).reshape(lead + feats)


def _quantize_kernel_2d(w2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: returns (kernel_q, scale)."""
    w = w2d.float()
    absmax = w.abs().amax(dim=0)                                       # [N]
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


LLAMA_QUANT_PATTERNS = (
    r"attn/(q|k|v|o)$", r"mlp/(gate|up|down)$", r"lm_head$", r"moe$"
)


def quantize_params(params: Any, patterns: Sequence[str], *, bits: int = 8) -> Any:
    """Convert fp dense kernels to the int8 param structure.

    Walks the tree; any dict holding a ``kernel`` tensor whose path
    (``/``-joined keys) matches one of ``patterns`` becomes
    ``{"kernel_q": int8 [K, N], "scale": fp32 [N]}``: a projection named
    ``o`` contracts its LEADING dims (``[heads, dim, out]`` → K=heads*dim),
    every other one its single leading input dim (``[in, ...features]`` →
    K=in, N=prod(features)). Non-matching subtrees pass through. Tensors
    stay on their device. ``bits=4`` and MoE expert blocks are not ported.
    """
    if bits != 8:
        raise NotImplementedError("only int8 quantize_params is ported (see ROADMAP.md)")
    compiled = [re.compile(p) for p in patterns]

    def walk(path, tree):
        if isinstance(tree, dict) and "w_gate" in tree and "w_down" in tree:
            if any(c.search("/".join(path)) for c in compiled):
                raise NotImplementedError("MoE expert quantization is not ported")
        if isinstance(tree, dict) and isinstance(tree.get("kernel"), torch.Tensor):
            if any(c.search("/".join(path)) for c in compiled):
                w = tree["kernel"]
                if path and path[-1] == "o":
                    w2d = w.reshape(-1, w.shape[-1])
                else:
                    w2d = w.reshape(w.shape[0], -1)
                q, scale = _quantize_kernel_2d(w2d)
                out = {"kernel_q": q, "scale": scale}
                for extra, v in tree.items():
                    if extra != "kernel":
                        out[extra] = v
                return out
        if isinstance(tree, dict):
            return {k: walk(path + (k,), v) for k, v in tree.items()}
        return tree

    return walk((), params)

