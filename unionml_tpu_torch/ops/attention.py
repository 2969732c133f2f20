"""Multi-head attention in plain PyTorch: the full-score reference and the
KV-cache decode engine.

The port of the parts of :mod:`unionml_tpu.ops.attention` that the Llama
serving path runs (the reference computes them outside any Pallas
kernel, so plain tensor code is their port). Tensors are
``[batch, seq, heads, head_dim]``; GQA is supported everywhere — ``k`` /
``v`` may have fewer heads than ``q`` as long as the count divides.
Products take their inputs in the working dtype and accumulate in fp32,
as the reference's ``preferred_element_type=float32`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """GQA: repeat kv heads to match q heads."""
    num_kv_heads = k.shape[2]
    if num_kv_heads == num_q_heads:
        return k
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q heads {num_q_heads} must be a multiple of kv heads {num_kv_heads}")
    return torch.repeat_interleave(k, num_q_heads // num_kv_heads, dim=2)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full-score multi-head attention ([B,S,H,D] in/out); ``bias``
    broadcasts against [B, H, Sq, Skv]. Causal masking is bottom-right
    aligned (with q_len < kv_len the queries are the LAST positions)."""
    num_q_heads, head_dim = q.shape[2], q.shape[3]
    k = _repeat_kv(k, num_q_heads)
    v = _repeat_kv(v, num_q_heads)
    scale = scale if scale is not None else head_dim**-0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias
    if causal:
        q_len, kv_len = q.shape[1], k.shape[1]
        q_pos = torch.arange(q_len, device=q.device)[:, None] + (kv_len - q_len)
        mask = q_pos >= torch.arange(kv_len, device=q.device)[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _grouped_cache_attention(
    q,
    k,
    v,
    *,
    k_scale=None,
    v_scale=None,
    bias=None,
    scale=None,
    block_threshold: int = 2048,
):
    """Shared engine for cached-decode attention (bf16 or int8 KV).

    ``k``/``v``: [B, S, Hk, D] (bf16, or int8 with ``k_scale``/``v_scale``
    fp32 [B, S, Hk] per-(position, head) dequant scales). As in the
    reference: the GQA group folds into the products (q reshaped to
    [B, Sq, Hk, G, D]) so the cache is never repeated; int8 scales ride
    the small tensors (``k_scale`` multiplies the scores, ``v_scale`` the
    softmax weights); above ``block_threshold`` keys an online softmax
    walks the cache in blocks, with a non-dividing tail merged last.

    ``bias`` must broadcast over heads (head dim 1). Output
    [B, Sq, Hq, D] in ``q.dtype``.
    """
    batch, q_len, num_q_heads, head_dim = q.shape
    num_kv_heads = k.shape[2]
    if num_q_heads % num_kv_heads:
        raise ValueError(
            f"q heads {num_q_heads} must be a multiple of kv heads {num_kv_heads}"
        )
    group = num_q_heads // num_kv_heads
    if bias is not None and bias.shape[1] != 1:
        raise ValueError(
            f"bias head dim must be 1 (broadcast over heads), got {tuple(bias.shape)}"
        )
    scale = scale if scale is not None else head_dim**-0.5
    kv_len = k.shape[1]
    dtype = q.dtype
    # [B, Sq, Hk, G, D]: contiguous head groups share a kv head
    qg = q.reshape(batch, q_len, num_kv_heads, group, head_dim).float()

    def scores_for(k_c, ks_c, bias_c):
        """k-scale-folded scores for one key slab: [B, Hk, G, Q, K]."""
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_c.to(dtype).float()) * scale
        if ks_c is not None:
            s = s * ks_c.permute(0, 2, 1)[:, :, None, None, :]
        if bias_c is not None:
            s = s + bias_c[:, :, None]  # [B,1,Q,K] -> [B,1,1,Q,K]
        return s

    def weighted_values(w, v_c, vs_c):
        if vs_c is not None:
            w = w * vs_c.permute(0, 2, 1)[:, :, None, None, :]
        return torch.einsum(
            "bhgqk,bkhd->bqhgd", w.to(dtype).float(), v_c.to(dtype).float()
        )

    if kv_len <= block_threshold:
        weights = torch.softmax(scores_for(k, k_scale, bias), dim=-1)
        out = weighted_values(weights, v, v_scale)
        return out.reshape(batch, q_len, num_q_heads, head_dim).to(dtype)

    def slab(x, start, size, dim=1):
        return None if x is None else x.narrow(dim, start, size)

    def merge(carry, start, size):
        """Online-softmax update with the [start, start+size) key slab."""
        m, l, acc = carry
        s = scores_for(
            slab(k, start, size), slab(k_scale, start, size),
            slab(bias, start, size, dim=3),
        )
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + weighted_values(
            p, slab(v, start, size), slab(v_scale, start, size)
        )
        return m_new, l, acc

    stat = (batch, num_kv_heads, group, q_len)
    carry = (
        torch.full(stat, NEG_INF, dtype=torch.float32, device=q.device),
        torch.zeros(stat, dtype=torch.float32, device=q.device),
        torch.zeros(
            (batch, q_len, num_kv_heads, group, head_dim),
            dtype=torch.float32, device=q.device,
        ),
    )
    n_full, tail = divmod(kv_len, block_threshold)
    for i in range(n_full):
        carry = merge(carry, i * block_threshold, block_threshold)
    if tail:
        carry = merge(carry, n_full * block_threshold, tail)
    _, l, acc = carry
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(batch, q_len, num_q_heads, head_dim).to(dtype)


def cached_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_threshold: int = 2048,
) -> torch.Tensor:
    """bf16 KV-cache decode attention: grouped GQA (no cache repeat),
    block-walked at long context. See :func:`_grouped_cache_attention`."""
    return _grouped_cache_attention(
        q, k, v, bias=bias, scale=scale, block_threshold=block_threshold
    )


def quantized_cache_attention(
    q: torch.Tensor,
    k_q: torch.Tensor,
    v_q: torch.Tensor,
    k_s: torch.Tensor,
    v_s: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_threshold: int = 2048,
) -> torch.Tensor:
    """int8 KV-cache decode attention, dequant scales folded into the
    attention math (never a dequantized cache copy). See
    :func:`_grouped_cache_attention`."""
    return _grouped_cache_attention(
        q, k_q, v_q, k_scale=k_s, v_scale=v_s, bias=bias, scale=scale,
        block_threshold=block_threshold,
    )
