"""Building blocks of the Llama serving path, in PyTorch.

The port of the parts of :mod:`unionml_tpu.models.layers` the serving
path runs. Modules hold their configuration only; weights are passed to
``forward`` as the param subtree of the reference's flax layout (the
same nesting and names, e.g. ``params["q"]["kernel_q"]``), so one module
serves any weight set, as ``module.apply({"params": ...})`` does in the
reference, and :func:`~unionml_tpu_torch.models.convert.from_jax_params`
carries a JAX tree over unchanged.

Ported: :func:`make_dense`, :class:`RMSNorm` (``impl="fused"`` runs the
CUDA kernel of :mod:`unionml_tpu_torch.ops.fused_norm`),
:func:`llama3_rope_frequencies` and :func:`rotary_embedding` (split
halves, fp32), the cached path of :class:`Attention` (contiguous KV
cache, scalar or per-row fill index, ``prefill_impl="flash"`` through the
kernel of :mod:`unionml_tpu_torch.ops.flash_attention`), the cache-free
path with the ``xla`` reference attention, and the gated
:class:`MlpBlock`. Block-paged caches, the int8 KV cache, cross
attention and the GELU MLP raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch._device import torch_dtype
from unionml_tpu_torch.models.quantization import DenseGeneral, QuantizedDenseGeneral
from unionml_tpu_torch.ops.attention import cached_attention, mha_reference


def make_dense(*, quantized: bool, features, dtype: Any, axis=-1) -> nn.Module:
    """Dense-projection factory shared by every matmul site of the
    serving path (attention q/k/v/o, gated MLP, lm_head): int8
    :class:`QuantizedDenseGeneral` when ``quantized``, else the fp
    :class:`DenseGeneral`. (The reference's int4 and LoRA sites are not
    ported; :class:`~unionml_tpu_torch.models.llama.LlamaConfig` refuses
    them.)"""
    if quantized:
        return QuantizedDenseGeneral(features, axis=axis, dtype=dtype)
    return DenseGeneral(features, axis=axis, dtype=dtype)


class RMSNorm(nn.Module):
    """Root-mean-square norm (Llama-style, no mean subtraction), fp32
    statistics, output in ``dtype``. ``impl="fused"`` routes through the
    fused RMSNorm kernel."""

    def __init__(self, eps: float = 1e-5, dtype: Any = torch.bfloat16, impl: str = "xla"):
        super().__init__()
        if impl not in ("xla", "fused"):
            raise ValueError(f"unknown norm impl {impl!r}")
        self.eps = eps
        self.dtype = torch_dtype(dtype)
        self.impl = impl

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        scale = params["scale"]
        if self.impl == "fused":
            from unionml_tpu_torch.ops.fused_norm import fused_rms_norm

            return fused_rms_norm(x, scale, eps=self.eps).to(self.dtype)
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (normed * scale.float()).to(self.dtype)


def llama3_rope_frequencies(
    freqs: torch.Tensor,
    *,
    factor: float,
    low_freq_factor: float,
    high_freq_factor: float,
    original_max_len: int,
) -> torch.Tensor:
    """Llama-3.1/3.2 long-context RoPE frequency rescaling (the "llama3"
    ``rope_scaling`` scheme): short wavelengths keep their frequency,
    long ones divide by ``factor``, the band between interpolates."""
    wavelen = 2.0 * math.pi / freqs
    ratio = original_max_len / wavelen
    smooth = (ratio - low_freq_factor) / (high_freq_factor - low_freq_factor)
    smooth = smooth.clamp(0.0, 1.0)
    return ((1.0 - smooth) / factor + smooth) * freqs


def rotary_embedding(
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    theta: float = 10_000.0,
    scaling: Optional[Tuple[float, float, float, int]] = None,
) -> torch.Tensor:
    """Apply rotary position embedding to ``x`` of shape (..., seq, heads,
    head_dim), rotating the two HALVES of head_dim (not interleaved
    pairs), in fp32. ``positions``: integers broadcastable to (..., seq)."""
    half = x.shape[-1] // 2
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exponent)
    if scaling is not None:
        factor, low, high, orig = scaling
        freqs = llama3_rope_frequencies(
            freqs, factor=factor, low_freq_factor=low,
            high_freq_factor=high, original_max_len=orig,
        )
    angles = positions[..., None].float() * freqs          # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                   # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _update_cache(buf: torch.Tensor, new: torch.Tensor, index) -> None:
    """Write ``new`` [B, seq, ...] into ``buf`` [B, max_len, ...] IN PLACE at
    fill ``index`` (an int shared by every row, or a [B] tensor of per-row
    fills). The reference builds a new buffer; the port writes into the
    caller's cache, which every caller owns for the whole generation, to
    avoid a copy of the cache per layer per step."""
    seq = new.shape[1]
    new = new.to(buf.dtype)
    if isinstance(index, torch.Tensor) and index.dim() == 1:
        pos = index.long()[:, None] + torch.arange(seq, device=buf.device)[None, :]
        if int(pos.max()) >= buf.shape[1]:
            raise ValueError(f"cache write past max_len {buf.shape[1]}")
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows, pos] = new
        return
    index = int(index)
    if index + seq > buf.shape[1]:
        raise ValueError(
            f"cache write [{index}, {index + seq}) past max_len {buf.shape[1]}"
        )
    buf[:, index:index + seq] = new


class Attention(nn.Module):
    """Grouped-query self-attention with RoPE and an optional KV cache.

    Params: ``q``/``k``/``v`` dense kernels with features ``(heads,
    head_dim)`` and ``o`` contracting ``(heads, head_dim)`` — the
    reference's layout, fp (``kernel``) or int8 (``kernel_q`` +
    ``scale``).
    """

    def __init__(
        self,
        num_heads: int,
        num_kv_heads: Optional[int] = None,
        head_dim: Optional[int] = None,
        *,
        features: int,
        rope: bool = False,
        rope_theta: float = 10_000.0,
        rope_scaling: Optional[Tuple[float, float, float, int]] = None,
        causal: bool = False,
        attn_impl: str = "xla",
        prefill_impl: str = "cached",
        quantized: bool = False,
        dtype: Any = torch.bfloat16,
    ):
        super().__init__()
        if prefill_impl not in ("cached", "flash"):
            raise ValueError(f"unknown prefill impl {prefill_impl!r}")
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = head_dim or features // num_heads
        self.rope = rope
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        self.causal = causal
        self.attn_impl = attn_impl
        self.prefill_impl = prefill_impl
        self.dtype = torch_dtype(dtype)

        def dense(feats, axis=-1):
            return make_dense(quantized=quantized, features=feats, dtype=self.dtype, axis=axis)

        self.q = dense((num_heads, self.head_dim))
        self.k = dense((self.num_kv_heads, self.head_dim))
        self.v = dense((self.num_kv_heads, self.head_dim))
        self.o = dense(features, axis=(-2, -1))

    def forward(
        self,
        params,
        x: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        cache_index=None,
        kv_mask: Optional[torch.Tensor] = None,
        block_table: Optional[torch.Tensor] = None,
        full_prefill: bool = False,
    ):
        """Returns ``out`` or ``(out, cache)`` when a cache is given.

        ``cache``: (k, v) of [batch, max_len, kv_heads, head_dim], written
        in place at ``cache_index`` (an int, or a [batch] tensor of
        per-row fills); ``kv_mask``: bool [batch, max_len], False slots
        are never attended to (left padding). ``full_prefill``: the
        caller's promise that this call covers the whole visible history
        (empty cache, index 0, no prefix), which lets
        ``prefill_impl="flash"`` attend over the fresh k/v alone.
        """
        if block_table is not None:
            raise NotImplementedError("block-paged KV caches are not ported (see ROADMAP.md)")
        batch, seq, _ = x.shape
        q = self.q(params["q"], x)
        k = self.k(params["k"], x)
        v = self.v(params["v"], x)
        if positions is None:
            if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
                base = cache_index[:, None]
            else:
                base = int(cache_index or 0)
            positions = base + torch.arange(seq, device=x.device)[None, :]
        if self.rope:
            q = rotary_embedding(q, positions, theta=self.rope_theta, scaling=self.rope_scaling)
            k = rotary_embedding(k, positions, theta=self.rope_theta, scaling=self.rope_scaling)

        if cache is None:
            if kv_mask is not None:
                raise ValueError("kv_mask requires a KV cache (generation path)")
            if self.attn_impl != "xla":
                raise NotImplementedError(
                    f"attn_impl {self.attn_impl!r} is not ported; only 'xla' is"
                )
            out = mha_reference(q, k, v, causal=self.causal)
            return self.o(params["o"], out)

        if len(cache) != 2:
            raise NotImplementedError("the int8 KV cache (kv_quant) is not ported (see ROADMAP.md)")
        ck, cv = cache
        _update_cache(ck, k, cache_index)
        _update_cache(cv, v, cache_index)
        if full_prefill and seq > 1 and self.prefill_impl == "flash":
            from unionml_tpu_torch.ops.flash_attention import flash_attention

            # per-row LEADING-invalid count: argmax finds the first True,
            # so an all-False or non-contiguous mask reads as 0 pads, as in
            # the reference
            pads = (
                torch.zeros(batch, dtype=torch.int32, device=x.device)
                if kv_mask is None
                else torch.argmax(kv_mask[:, :seq].int(), dim=-1).int()
            )
            out = flash_attention(q, k, v, causal=True, kv_valid_start=pads)
        else:
            kv_pos = torch.arange(ck.shape[1], device=x.device)[None, :]
            if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
                q_pos = (
                    cache_index.long()[:, None, None]
                    + torch.arange(seq, device=x.device)[None, :, None]
                )
                visible = kv_pos[None] <= q_pos               # (batch, seq, max_len)
                if kv_mask is not None:
                    visible = visible & kv_mask[:, None, :]
                visible = visible[:, None]
            else:
                q_pos = int(cache_index) + torch.arange(seq, device=x.device)[:, None]
                visible = kv_pos <= q_pos                     # (seq, max_len)
                if kv_mask is not None:
                    visible = (visible[None] & kv_mask[:, None, :])[:, None]
                else:
                    visible = visible[None, None]
            bias = torch.where(
                visible, torch.zeros((), device=x.device), torch.full((), -1e30, device=x.device)
            )
            out = cached_attention(q, ck.to(self.dtype), cv.to(self.dtype), bias=bias)
        return self.o(params["o"], out), (ck, cv)


class MlpBlock(nn.Module):
    """The gated (SwiGLU) transformer MLP of Llama: ``down(silu(gate(x)) *
    up(x))``. The GELU form (ViT/BERT) is not ported."""

    def __init__(
        self,
        hidden_dim: int,
        features: int,
        *,
        gated: bool = True,
        quantized: bool = False,
        dtype: Any = torch.bfloat16,
    ):
        super().__init__()
        if not gated:
            raise NotImplementedError("the GELU MLP is not ported (see ROADMAP.md)")
        dtype = torch_dtype(dtype)

        def dense(feats):
            return make_dense(quantized=quantized, features=feats, dtype=dtype)

        self.gate = dense(hidden_dim)
        self.up = dense(hidden_dim)
        self.down = dense(features)

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        gate = F.silu(self.gate(params["gate"], x))
        up = self.up(params["up"], x)
        return self.down(params["down"], gate * up)
