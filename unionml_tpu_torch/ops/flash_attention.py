"""Padded causal flash-attention forward: the Hopper kernel, its plain
version, the op.

The port of :mod:`unionml_tpu.ops.flash_attention`'s forward-only padded
path (``_fwd_kernel`` through ``_flash_fwd_padded``), the attention of a
full prefill under ``prefill_impl="flash"``. Tensors are
``[batch, seq, heads, head_dim]``; k/v keep their kv-head width (GQA:
contiguous q-head groups share a kv head, never repeated); a per-batch
``kv_valid_start`` masks left padding; query rows with nothing visible
return zeros. The kernel is ``csrc/flash_attention.cu``;
:func:`flash_fwd_padded_plain` is the same arithmetic in plain PyTorch
(scores in fp32, probabilities cast to the value dtype before the
product, fp32 accumulation).

The reference's differentiable path (the lse-form forward and the
FlashAttention-2 backward) is not ported yet: calling
:func:`flash_attention` without ``kv_valid_start`` raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from unionml_tpu_torch.ops._build import Kernel

NEG_INF = -1e30

KERNEL = Kernel(
    "flash_attention", "flash_fwd_padded",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_int, ctypes.c_void_p],
)
HEAD_DIMS = (64, 128)


def _visible(pad: torch.Tensor, q_len: int, kv_len: int, causal: bool) -> torch.Tensor:
    """bool [B, 1, 1, Sq, Skv]: kv j visible to query i (bottom-right
    causal alignment, kv positions below the row's pad hidden)."""
    dev = pad.device
    kv_pos = torch.arange(kv_len, device=dev)
    vis = kv_pos[None, None, :] >= pad.long()[:, None, None]          # [B,1,K]
    if causal:
        q_pos = torch.arange(q_len, device=dev)[:, None] + (kv_len - q_len)
        vis = vis & (q_pos >= kv_pos[None, :])[None]                    # [B,Q,K]
    else:
        vis = vis.expand(-1, q_len, -1)
    return vis[:, None, None]


def flash_fwd_padded_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pad: torch.Tensor,
    *, causal: bool, scale: float,
) -> torch.Tensor:
    """Plain PyTorch padded attention (the kernel's reference)."""
    b, q_len, h, d = q.shape
    kv_len, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, q_len, kvh, h // kvh, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    vis = _visible(pad, q_len, kv_len, causal)
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == NEG_INF, torch.zeros_like(m), m)
    p = torch.where(vis, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1)                                                 # [B,KVH,G,Q]
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, q_len, h, d).to(q.dtype)


def flash_fwd_padded_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pad: torch.Tensor,
    *, causal: bool, scale: float,
) -> torch.Tensor:
    """Launch the padded flash kernel: q [B, Sq, H, D], k/v [B, Skv, KVH,
    D] bf16 contiguous on one CUDA device, pad [B] int32 there too."""
    tensors = (q, k, v, pad)
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError("flash_fwd_padded_cuda needs all tensors on one CUDA device")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(
            f"flash_fwd_padded_cuda takes [B,S,H,D] q and matching k/v, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, q_len, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
            "(batch, head_dim, or q heads not a multiple of kv heads)"
        )
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_fwd_padded_cuda takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd_padded_cuda takes head_dim in {HEAD_DIMS}, got {d}")
    if pad.dtype != torch.int32 or pad.shape != (b,):
        raise ValueError(f"pad must be int32 [{b}], got {pad.dtype} {tuple(pad.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_fwd_padded_cuda needs contiguous tensors")
    if b * h > 65535:
        raise ValueError(f"batch * heads must be at most 65535, got {b * h}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            out.data_ptr(), b, q_len, k.shape[1], h, k.shape[2], d,
            float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_valid_start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Forward-only flash attention over [B,S,H,D] tensors with per-row
    left padding (``kv_valid_start``: [B] first visible kv position).
    The CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if kv_valid_start is None:
        raise NotImplementedError(
            "only the padded forward (kv_valid_start=...) of flash_attention "
            "is ported; the differentiable path is not (see ROADMAP.md)"
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    pad = kv_valid_start.to(device=q.device, dtype=torch.int32)
    if q.is_cuda:
        return flash_fwd_padded_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), pad.contiguous(),
            causal=causal, scale=scale,
        )
    if q.device.type == "cpu":
        return flash_fwd_padded_plain(q, k, v, pad, causal=causal, scale=scale)
    raise ValueError(f"flash_attention has no path for device {q.device}")
