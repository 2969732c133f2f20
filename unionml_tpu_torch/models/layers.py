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
padded kernel of :mod:`unionml_tpu_torch.ops.flash_attention`), the
cache-free path (``attn_impl`` ``xla``, ``fused`` through the
differentiable kernels of :mod:`unionml_tpu_torch.ops.fused_attention`,
``flash`` through the differentiable kernels of
:mod:`unionml_tpu_torch.ops.flash_attention`, or ``auto``),
the block-paged decode step (``block_table=``, through
:mod:`unionml_tpu_torch.ops.paged_attention`), the int8 KV cache,
:class:`LayerNorm` (flax's statistics, or ``impl="fused"`` through
:mod:`unionml_tpu_torch.ops.fused_norm`), q/k/v/o biases, and the gated
and GELU :class:`MlpBlock`, with int8 or packed-int4 (``weight_bits=4``)
weight-only projections and LoRA adapters (``lora_rank``) on q/k/v/o and
gate/up/down. Cross attention raises ``NotImplementedError``.

Under a sharded step (DTensor activations and params) the kernel-backed
norms and the cache-free attention cross to local shards here
(:func:`_sharded_norm`, :func:`_sharded_attention`): the kernel wrappers
take plain tensors only. A rank holding q heads ``[h0, h0 + Hl)`` of a
GQA layer whose kv heads stay whole (``num_kv_heads`` not divisible by
``tensor``) attends each local head ``h`` with kv head ``(h0 + h) //
group``, the offset GSPMD applies silently in the reference.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch._device import torch_dtype
from unionml_tpu_torch.models.quantization import (
    DenseGeneral,
    Int4DenseGeneral,
    QuantizedDenseGeneral,
)
from unionml_tpu_torch.ops.attention import (
    cached_attention,
    mha_reference,
    quantized_cache_attention,
)
from unionml_tpu_torch.parallel.compat import is_dtensor, local_call


# --------------------------------------------------------------------- #
# the kernel boundary under placements
# --------------------------------------------------------------------- #


def _whole(t: Any, *dims: int) -> Any:
    """``t``'s placements with every ``Partial`` resolved and the given
    tensor dims whole (``Replicate`` where they were sharded)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    want = [Replicate() if isinstance(p, Partial)
            or (isinstance(p, Shard) and p.dim % t.dim() in [d % t.dim() for d in dims])
            else p for p in t.placements]
    return t if list(t.placements) == want else t.redistribute(t.device_mesh, want)


def _replicated(t: Any, mesh: Any) -> Any:
    from torch.distributed.tensor import Replicate

    want = [Replicate()] * mesh.ndim
    return t if list(t.placements) == want else t.redistribute(mesh, want)


def _row_grads(x: Any) -> list:
    """Gradient placements of a whole param used on ``x``'s local rows:
    a share of a sum over every mesh dim that splits ``x``, else whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [Partial() if isinstance(p, Shard) else Replicate() for p in x.placements]


def _sharded_norm(fn, x, others, params):
    """``fn(*locals)`` for a row-wise norm: ``x`` and the ``others``
    (residual addends) on their local rows with the last dim whole, the
    norm ``params`` (scale, bias or None) whole on every rank."""
    x = _whole(x, -1)
    mesh = x.device_mesh
    others = [o if not is_dtensor(o) or list(o.placements) == list(x.placements)
              else o.redistribute(mesh, x.placements) for o in others]
    params = [None if p is None else _replicated(p, mesh) for p in params]
    args = [x, *others, *params]
    grads = [x.placements] * (1 + len(others)) + [_row_grads(x)] * len(params)
    return fn, args, grads, x.placements, mesh


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (an embedding lookup). Under placements the lookup
    runs on each rank's ids with the table whole, so every rank indexes
    as the plain path does (DTensor's own index strategy is not used)."""
    if not (is_dtensor(table) or is_dtensor(ids)):
        return table[ids]
    from torch.distributed.tensor import DTensor, Replicate

    mesh = (ids if is_dtensor(ids) else table).device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    ids = _whole(ids)
    whole = table if is_dtensor(table) else DTensor.from_local(
        table, mesh, [Replicate()] * mesh.ndim, run_check=False)
    whole = _replicated(whole, mesh)
    return local_call(lambda t, i: t[i], [whole, ids], [_row_grads(ids), ids.placements],
                      ids.placements, mesh)


def _local_kv_heads(num_local: int, offset: int, group: int, device) -> torch.Tensor:
    """The kv head of each of a rank's ``num_local`` q heads, whose first
    is global head ``offset``: ``(offset + h) // group``."""
    return (torch.arange(num_local, device=device) + offset) // group


class _GatherHeads(torch.autograd.Function):
    """``kv[:, :, index]`` whose backward sums each kv head's copies in
    fp32 and rounds once (the per-head dk / dv rounding point of the GQA
    backward, C3, held on each shard)."""

    @staticmethod
    def forward(ctx, kv, index):
        ctx.save_for_backward(index)
        ctx.heads = kv.shape[2]
        return kv.index_select(2, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        shape = list(grad.shape)
        shape[2] = ctx.heads
        total = torch.zeros(shape, dtype=torch.float32, device=grad.device)
        total.index_add_(2, index, grad.float())
        return total.to(grad.dtype), None


def _sharded_attention(q, k, v, *, impl: str, causal: bool):
    """Cache-free attention on each rank's local heads (see the module
    docstring): batch rows and q heads as placed, sequence and head dims
    whole; kv heads sharded as q's or whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    q = _whole(q, 1, 3)
    mesh = q.device_mesh
    k, v = (_whole(t, 1, 3) for t in (k, v))
    head_dims = [i for i, p in enumerate(q.placements) if isinstance(p, Shard) and p.dim == 2]
    kv_placements = [p if i not in head_dims else Replicate() for i, p in enumerate(q.placements)]
    if list(k.placements) != list(q.placements):
        k, v = (t.redistribute(mesh, kv_placements) for t in (k, v))
    expand = bool(head_dims) and list(k.placements) != list(q.placements)
    kv_grads = [Partial() if i in head_dims and expand else p
                for i, p in enumerate(k.placements)]
    from unionml_tpu_torch.parallel.sharding import local_slices

    offset = local_slices(q.shape, mesh, q.placements)[2].start
    group = q.shape[2] // k.shape[2]

    def attend(ql, kl, vl):
        if expand:
            index = _local_kv_heads(ql.shape[2], offset, group, ql.device)
            kl, vl = _GatherHeads.apply(kl, index), _GatherHeads.apply(vl, index)
        return _run_attention(ql, kl, vl, impl=impl, causal=causal)

    return local_call(attend, [q, k, v], [q.placements, kv_grads, kv_grads],
                      q.placements, mesh)


def make_dense(
    *,
    quantized: bool,
    features,
    dtype: Any,
    axis=-1,
    weight_bits: int = 8,
    int4_group: int = 0,
    int4_shards: int = 1,
    use_bias: bool = False,
    lora_rank: int = 0,
    lora_alpha: float = 16.0,
) -> nn.Module:
    """Dense-projection factory shared by every matmul site of the
    serving path (attention q/k/v/o, gated MLP, lm_head): when
    ``quantized``, int8 :class:`QuantizedDenseGeneral` or, with
    ``weight_bits=4``, packed-int4 :class:`Int4DenseGeneral` (group-wise
    scales with ``int4_group``, a packing that survives ``int4_shards``-way
    column sharding); else the fp :class:`DenseGeneral`. ``use_bias`` adds
    the fp layer's ``bias``; quantized layers are bias-free.

    ``lora_rank > 0`` builds :class:`~unionml_tpu_torch.models.lora
    .LoRADenseGeneral` instead: the same base params (fp ``kernel`` or
    int8 ``kernel_q`` + ``scale``) plus trainable ``lora_a`` / ``lora_b``
    adapters (QLoRA with ``quantized``). Adapters compose with the fp or
    int8 base only."""
    if lora_rank > 0:
        if weight_bits != 8:
            # silently dropping an int4 request would train against the
            # wrong base
            raise ValueError("LoRA/QLoRA requires weight_bits=8")
        from unionml_tpu_torch.models.lora import LoRADenseGeneral

        return LoRADenseGeneral(
            features, lora_rank, lora_alpha, axis=axis, quantized=quantized,
            use_bias=use_bias, dtype=dtype,
        )
    if quantized:
        if use_bias:
            raise ValueError("quantized dense layers are bias-free")
        if weight_bits == 4:
            return Int4DenseGeneral(
                features, axis=axis, dtype=dtype, group_size=int4_group, shards=int4_shards,
            )
        return QuantizedDenseGeneral(features, axis=axis, dtype=dtype)
    return DenseGeneral(features, axis=axis, dtype=dtype, use_bias=use_bias)


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

            if is_dtensor(x):
                return local_call(*_sharded_norm(
                    lambda xl, g: fused_rms_norm(xl, g, eps=self.eps), x, [], [scale],
                )).to(self.dtype)
            return fused_rms_norm(x, scale, eps=self.eps).to(self.dtype)
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (normed * scale.float()).to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with ``scale`` / ``bias`` params (the
    reference's param names, so either impl loads the other's weights),
    output in ``dtype``. ``impl="xla"`` is flax's ``nn.LayerNorm``
    arithmetic (fp32 ``E[x^2] - E[x]^2`` variance, clipped at 0);
    ``impl="fused"`` runs the fused LayerNorm kernel pair (fp32
    ``E[(x - mu)^2]``, differentiable through the backward kernel)."""

    def __init__(self, eps: float = 1e-6, dtype: Any = torch.bfloat16, impl: str = "xla"):
        super().__init__()
        if impl not in ("xla", "fused"):
            raise ValueError(f"unknown norm impl {impl!r}")
        self.eps = eps
        self.dtype = torch_dtype(dtype)
        self.impl = impl

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        scale, bias = params["scale"], params["bias"]
        if self.impl == "fused":
            from unionml_tpu_torch.ops.fused_norm import fused_layer_norm

            if is_dtensor(x):
                return local_call(*_sharded_norm(
                    lambda xl, g, b: fused_layer_norm(xl, g, b, self.eps), x, [], [scale, bias],
                )).to(self.dtype)
            return fused_layer_norm(x, scale, bias, self.eps).to(self.dtype)
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * scale.float()
        return ((x32 - mu) * mul + bias.float()).to(self.dtype)


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
    avoid a copy of the cache per layer per step. A per-row fill is
    clamped into ``[0, max_len - seq]`` on the device, as the reference's
    vmapped ``dynamic_update_slice`` clamps it (checking it on the host
    would wait for the device at every layer of every decode step)."""
    seq = new.shape[1]
    new = new.to(buf.dtype)
    if isinstance(index, torch.Tensor) and index.dim() == 1:
        start = index.long().clamp(0, max(0, buf.shape[1] - seq))
        pos = start[:, None] + torch.arange(seq, device=buf.device)[None, :]
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows, pos] = new
        return
    index = int(index)
    if index + seq > buf.shape[1]:
        raise ValueError(
            f"cache write [{index}, {index + seq}) past max_len {buf.shape[1]}"
        )
    buf[:, index:index + seq] = new


ATTN_IMPLS = ("auto", "xla", "fused", "flash")


def _run_attention(q, k, v, *, impl: str, causal: bool) -> torch.Tensor:
    """Cache-free attention over [B, S, H, D]: ``xla`` is the full-score
    reference, ``fused`` the fused short-sequence kernels, ``flash`` the
    differentiable flash-attention kernels, ``auto`` fused up to
    :data:`~unionml_tpu_torch.ops.fused_attention.MAX_FUSED_SEQ`
    equal-length tokens and flash above it (or for unequal lengths), as
    the reference picks."""
    from unionml_tpu_torch.ops.fused_attention import MAX_FUSED_SEQ

    if is_dtensor(q):
        return _sharded_attention(q, k, v, impl=impl, causal=causal)
    if impl == "auto":
        impl = "fused" if q.shape[1] <= MAX_FUSED_SEQ and k.shape[1] == q.shape[1] else "flash"
    if impl == "xla":
        return mha_reference(q, k, v, causal=causal)
    if impl == "fused":
        from unionml_tpu_torch.ops.fused_attention import fused_attention

        return fused_attention(q, k, v, causal=causal)
    if impl == "flash":
        from unionml_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    raise NotImplementedError(
        f"attn_impl {impl!r} is not ported; the cache-free path takes {ATTN_IMPLS}"
    )


def quantize_kv(x: torch.Tensor):
    """int8 KV-cache quantization of ``x`` [..., head_dim]: per-(row, head)
    scale ``absmax / 127`` floored at ``1e-8``, values rounded half to even
    and clipped to +-127. Returns ``(int8 values, fp32 scales [...])``."""
    x32 = x.float()
    s = (x32.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return q, s


class Attention(nn.Module):
    """Grouped-query self-attention with RoPE and an optional KV cache.

    Params: ``q``/``k``/``v`` dense kernels with features ``(heads,
    head_dim)`` and ``o`` contracting ``(heads, head_dim)`` — the
    reference's layout, fp (``kernel``), int8 (``kernel_q`` + ``scale``)
    or packed int4 (``kernel_p`` + ``scale`` / ``scale_g``); with
    ``lora_rank > 0`` each also carries ``lora_a`` / ``lora_b``.
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
        paged_impl: str = "auto",
        quantized: bool = False,
        weight_bits: int = 8,
        int4_group: int = 0,
        int4_tp: int = 1,
        use_bias: bool = False,
        lora_rank: int = 0,
        lora_alpha: float = 16.0,
        dtype: Any = torch.bfloat16,
    ):
        super().__init__()
        if prefill_impl not in ("cached", "flash"):
            raise ValueError(f"unknown prefill impl {prefill_impl!r}")
        if paged_impl not in ("auto", "pallas", "reference"):
            raise ValueError(f"unknown paged impl {paged_impl!r}")
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = head_dim or features // num_heads
        self.rope = rope
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        self.causal = causal
        self.attn_impl = attn_impl
        self.prefill_impl = prefill_impl
        # decode attention over a block-paged pool (block_table=): the
        # reference's names — "pallas" = the hand-written CUDA kernel,
        # "reference" = its plain version, "auto" = the kernel for CUDA
        # tensors and the plain version for CPU ones
        self.paged_impl = paged_impl
        self.dtype = torch_dtype(dtype)

        def dense(feats, axis=-1, shards=1):
            return make_dense(
                quantized=quantized, features=feats, dtype=self.dtype, axis=axis,
                weight_bits=weight_bits, int4_group=int4_group, int4_shards=shards,
                use_bias=use_bias, lora_rank=lora_rank, lora_alpha=lora_alpha,
            )

        # q/k/v are column-parallel under tensor parallelism: their int4
        # tile divides the per-device width; o is row-parallel
        self.q = dense((num_heads, self.head_dim), shards=int4_tp)
        self.k = dense((self.num_kv_heads, self.head_dim), shards=int4_tp)
        self.v = dense((self.num_kv_heads, self.head_dim), shards=int4_tp)
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

        ``cache``: (k, v) of [batch, max_len, kv_heads, head_dim], or the
        int8 form (k_q, v_q, k_scale, v_scale) with fp32 scales [batch,
        max_len, kv_heads], written in place at ``cache_index`` (an int, or
        a [batch] tensor of per-row fills); ``kv_mask``: bool [batch,
        max_len], False slots are never attended to (left padding).
        ``full_prefill``: the caller's promise that this call covers the
        whole visible history (empty cache, index 0, no prefix), which
        lets ``prefill_impl="flash"`` attend over the fresh k/v alone.

        ``block_table``: int [batch, table_width] — marks ``cache`` as a
        block-paged pool (per buffer [num_blocks, block, kv_heads, ...])
        addressed through the table. Decode steps only: ``seq == 1``, a
        [batch] ``cache_index`` and no ``kv_mask``; the step's k/v row goes
        to pool block ``table[b, fill // block]`` at offset ``fill %
        block`` and attention reads through
        :func:`~unionml_tpu_torch.ops.paged_attention.paged_attention`
        with ``lengths = fill + 1`` (the written row sees itself).
        """
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
            out = _run_attention(q, k, v, impl=self.attn_impl, causal=self.causal)
            return self.o(params["o"], out)

        if len(cache) not in (2, 4):
            raise ValueError(
                f"cache must be (k, v) or (k_q, v_q, k_scale, v_scale), got {len(cache)} buffers"
            )
        if block_table is not None:
            if seq != 1 or not (
                isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1
            ):
                raise ValueError(
                    "block-paged caches support vector-index decode steps only "
                    f"(seq == 1), got seq={seq}, cache_index {cache_index!r}"
                )
            if kv_mask is not None:
                raise ValueError(
                    "kv_mask is incompatible with block_table — paged "
                    "visibility derives from the fills"
                )
            blk = cache[0].shape[1]
            fill = cache_index.long()
            pid = torch.gather(block_table.long(), 1, (fill // blk)[:, None])[:, 0]
            off = fill % blk

            def write(buf, new):
                # one indexed write at (pool block, offset) per buffer
                buf[pid, off] = new[:, 0].to(buf.dtype)
        else:
            def write(buf, new):
                _update_cache(buf, new, cache_index)

        quant = len(cache) == 4
        if quant:
            # int8 KV cache: per-(row, head) scales; the scales fold into
            # the attention math (never a dequantized cache copy)
            ck, cv, ks, vs = cache
            k_q, k_s = quantize_kv(k)
            v_q, v_s = quantize_kv(v)
            for buf, new in ((ck, k_q), (cv, v_q), (ks, k_s), (vs, v_s)):
                write(buf, new)
            new_cache = (ck, cv, ks, vs)
        else:
            ck, cv = cache
            write(ck, k)
            write(cv, v)
            new_cache = (ck, cv)
        scales = dict(k_scale=ks, v_scale=vs) if quant else {}

        out = None
        if block_table is not None:
            from unionml_tpu_torch.ops.paged_attention import paged_attention

            out = paged_attention(
                q[:, 0], ck, cv, block_table, cache_index + 1,
                impl=self.paged_impl, **scales,
            )[:, None]
        elif full_prefill and seq > 1 and self.prefill_impl == "flash":
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

            def attend(q_rows, bias_rows):
                if quant:
                    return quantized_cache_attention(q_rows, ck, cv, ks, vs, bias=bias_rows)
                return cached_attention(q_rows, ck.to(self.dtype), cv.to(self.dtype),
                                        bias=bias_rows)

            if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1 and seq > 1:
                # a speculative verify: each query row attends as a one-token
                # decode step does, at the step's shapes, so its bits do not
                # depend on how many rows share the product (a batched GEMM
                # picks its algorithm by shape) and a draft equal to the
                # target sees its proposals accepted
                out = torch.cat([attend(q[:, i:i + 1].contiguous(),
                                        bias[:, :, i:i + 1].contiguous())
                                 for i in range(seq)], dim=1)
            else:
                out = attend(q, bias)
        return self.o(params["o"], out), new_cache


class MlpBlock(nn.Module):
    """Transformer MLP: the gated (SwiGLU) form of Llama, ``down(silu(gate(x))
    * up(x))``, or (``gated=False``) the GELU form of ViT/BERT, ``down(gelu(
    up(x)))`` with biases, tanh-approximate GELU unless
    ``gelu_approximate=False``."""

    def __init__(
        self,
        hidden_dim: int,
        features: int,
        *,
        gated: bool = True,
        quantized: bool = False,
        weight_bits: int = 8,
        int4_group: int = 0,
        int4_tp: int = 1,
        gelu_approximate: bool = True,
        lora_rank: int = 0,
        lora_alpha: float = 16.0,
        dtype: Any = torch.bfloat16,
    ):
        super().__init__()
        if quantized and not gated:
            raise ValueError("quantized MlpBlock supports the bias-free gated form")
        dtype = torch_dtype(dtype)
        self.gated = gated
        self.gelu_approximate = gelu_approximate

        def dense(feats, shards=1):
            return make_dense(
                quantized=quantized, features=feats, dtype=dtype, weight_bits=weight_bits,
                int4_group=int4_group, int4_shards=shards, use_bias=not gated,
                lora_rank=lora_rank, lora_alpha=lora_alpha,
            )

        # gate/up are column-parallel under tensor parallelism, down is not
        if gated:
            self.gate = dense(hidden_dim, shards=int4_tp)
        self.up = dense(hidden_dim, shards=int4_tp)
        self.down = dense(features)

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        if not self.gated:
            h = F.gelu(
                self.up(params["up"], x),
                approximate="tanh" if self.gelu_approximate else "none",
            )
            return self.down(params["down"], h)
        gate = F.silu(self.gate(params["gate"], x))
        up = self.up(params["up"], x)
        return self.down(params["down"], gate * up)
