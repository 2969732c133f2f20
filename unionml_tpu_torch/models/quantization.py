"""Weight-only int8 and packed-int4 quantization for serving.

The port of :mod:`unionml_tpu.models.quantization` for dense layers:
:class:`QuantizedDenseGeneral` (DenseGeneral geometry, ``kernel_q`` int8
``[K, N]`` + ``scale`` fp32 ``[N]``), :class:`Int4DenseGeneral`
(``kernel_p`` int8 ``[K, N/2]``, two nibbles a byte, + ``scale [N]`` or
group-wise ``scale_g [K/g, N]``, through
:func:`~unionml_tpu_torch.ops.int4_matmul.int4_matmul`) and
:func:`quantize_params` with ``bits=8`` or ``bits=4``. The int8 product
runs as a plain matrix product with fp32 accumulation and an fp32
result, then ``* scale``, then ONE cast to the compute dtype — the
reference's rounding point (a product that rounds to bf16 before the
scale would be a different result). MoE expert blocks are not ported yet
and raise.
"""

from __future__ import annotations

import re
from typing import Any, Sequence, Tuple

import torch
from torch import nn

from unionml_tpu_torch._device import torch_dtype
from unionml_tpu_torch.ops.int4_matmul import (
    fp32_product,
    int4_matmul,
    quantize_kernel_int4,
    tile_for,
)

# dense sites sharded along N (column-parallel) under tensor parallelism:
# their int4 tile divides the per-device width; o, down and the LM head
# shard K and pack for one device
INT4_COLUMN_PARALLEL = ("q", "k", "v", "gate", "up")


def int4_tile(k: int, n: int, *, shards: int = 1, group_size: int = 0) -> int:
    """The packing tile of an int4 site ``[K, N]``, or 0 where the site
    stays int8 (no conforming tile, or a group that does not divide K) —
    the one rule :class:`Int4DenseGeneral`, :func:`quantize_params` and the
    weight bridge share."""
    if group_size and k % group_size:
        return 0
    return tile_for(n, k, shards=shards)


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
    """fp dense layer with flax ``DenseGeneral`` geometry: the kernel is
    ``[*contracted dims, *features]``; input, kernel and (with
    ``use_bias``) the ``bias`` ``[*features]`` are cast to ``dtype``, and
    the bias is added after the product, as flax does."""

    def __init__(self, features, axis=-1, dtype: Any = torch.bfloat16, use_bias: bool = False):
        super().__init__()
        self.features = features
        self.axis = axis
        self.dtype = torch_dtype(dtype)
        self.use_bias = use_bias

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        axes = (self.axis,) if isinstance(self.axis, int) else tuple(self.axis)
        axes = [a % x.dim() for a in axes]
        kernel = params["kernel"].to(self.dtype)
        y = torch.tensordot(x.to(self.dtype), kernel, dims=(axes, list(range(len(axes)))))
        if self.use_bias:
            y = y + params["bias"].to(self.dtype)
        return y


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
        # scale
        y = fp32_product(xt.reshape(-1, k).to(self.dtype), kernel_q) * scale.float()
        return y.to(self.dtype).reshape(lead + feats)


class Int4DenseGeneral(nn.Module):
    """Weight-only packed-int4 dense layer (DenseGeneral geometry).

    Params ``kernel_p`` int8 ``[K, N/2]`` (the tile-slab order of
    :mod:`unionml_tpu_torch.ops.int4_matmul`) + fp32 ``scale [N]``, or
    ``scale_g [K/group_size, N]`` when ``group_size`` is set. A layer with
    no conforming tile (``tile_for`` gives 0) or a group that does not
    divide K is the int8 fallback ``kernel_q`` + ``scale``, as
    :func:`quantize_params` (``bits=4``) writes it, so a mixed int4/int8
    tree serves through one module.

    ``shards``: the tensor-parallel degree the packing tile must survive
    (column-parallel sites q/k/v and gate/up; o, down and the LM head keep
    1). It MUST match the ``tensor=`` the tree was quantized with, or the
    baked slab order and the layer's tile disagree.
    """

    def __init__(self, features, axis=-1, dtype: Any = torch.bfloat16,
                 group_size: int = 0, shards: int = 1):
        super().__init__()
        self.features = features
        self.axis = axis
        self.dtype = torch_dtype(dtype)
        self.group_size = group_size
        self.shards = shards
        self._int8 = QuantizedDenseGeneral(features, axis=axis, dtype=dtype)

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        xt, lead, feats, k, n = _dense_geometry(x, self.axis, self.features)
        tile = int4_tile(k, n, shards=self.shards, group_size=self.group_size)
        if not tile:
            return self._int8(params, x)
        kernel_p = params["kernel_p"]
        scale = params["scale_g"] if self.group_size else params["scale"]
        if tuple(kernel_p.shape) != (k, n // 2):
            raise ValueError(f"kernel_p is {tuple(kernel_p.shape)}, expected {(k, n // 2)}")
        y = int4_matmul(
            xt.reshape(-1, k), kernel_p, scale, tile_n=tile,
            dtype=self.dtype, group_size=self.group_size,
        )
        return y.reshape(lead + feats)


def _quantize_kernel_2d(w2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: returns (kernel_q, scale)."""
    w = w2d.float()
    absmax = w.abs().amax(dim=0)                                       # [N]
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_int4_site(path, w2d: torch.Tensor, group_size: int, tensor: int):
    """The packed-int4 leaves of one dense site, or ``None`` when the site
    stays int8."""
    shards = tensor if path and path[-1] in INT4_COLUMN_PARALLEL else 1
    tile = int4_tile(w2d.shape[0], w2d.shape[1], shards=shards, group_size=group_size)
    if not tile:
        return None
    packed, scale = quantize_kernel_int4(w2d, tile, group_size=group_size)
    return {"kernel_p": packed, ("scale_g" if group_size else "scale"): scale}


LLAMA_QUANT_PATTERNS = (
    r"attn/(q|k|v|o)$", r"mlp/(gate|up|down)$", r"lm_head$", r"moe$"
)


def quantize_params(
    params: Any,
    patterns: Sequence[str],
    *,
    bits: int = 8,
    group_size: int = 0,
    tensor: int = 1,
) -> Any:
    """Convert fp dense kernels to the quantized param structure.

    Walks the tree; any dict holding a ``kernel`` tensor whose path
    (``/``-joined keys) matches one of ``patterns`` becomes
    ``{"kernel_q": int8 [K, N], "scale": fp32 [N]}``: a projection named
    ``o`` contracts its LEADING dims (``[heads, dim, out]`` → K=heads*dim),
    every other one its single leading input dim (``[in, ...features]`` →
    K=in, N=prod(features)). Non-matching subtrees pass through. Tensors
    stay on their device. MoE expert blocks are not ported and raise.

    ``bits=4``: the packed-int4 layout (``kernel_p`` + ``scale``, or
    ``scale_g`` with ``group_size``) for layers with a conforming tile; a
    layer with none (odd width) or whose K the group does not divide stays
    int8. ``tensor``: the tensor-parallel degree to pack for — the
    column-parallel sites (q/k/v, gate/up) take a tile dividing their
    per-device width (``LlamaConfig.int4_tp`` must match).
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
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
                out = _quantize_int4_site(path, w2d, group_size, tensor) if bits == 4 else None
                if out is None:
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

