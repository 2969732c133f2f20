"""Fused short-sequence attention (forward and backward): the Hopper
kernels, their plain versions, the differentiable op.

The port of :mod:`unionml_tpu.ops.fused_attention`, the ViT/BERT attention
of ``attn_impl="fused"``: full-row softmax attention over ``[B, S, H, D]``
tensors for ``S <= MAX_FUSED_SEQ``, scores in log2 space (``scale *
log2(e)`` rides q outside the autograd function, so autograd gives dq that
factor), normalization after the P.V product, and a backward that
recomputes the softmax and sums ``delta = rowsum(e * dp) / z`` in fp32.
The reference kernel takes ``delta = rowsum(do * o)`` from the bf16
output; where a row's value vectors are nearly equal ``dp - delta``
cancels, and that rounding then turns dq and dk (ROADMAP.md C7). The
backward needs no saved output. GQA repeats the kv heads outside the
function, so the repeat's own backward group-sums dk/dv.

:data:`FWD_KERNEL` and :data:`BWD_KERNEL` (``csrc/fused_attention.cu``)
count their launches; :func:`fused_attention_fwd_plain` and
:func:`fused_attention_bwd_plain` are the same arithmetic in plain
PyTorch, rounding where the TPU kernel rounds (``e`` before P.V, ``do /
z`` and ``ds`` before their products). The op launches the kernels for
CUDA tensors (bf16) and takes the plain versions only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from unionml_tpu_torch.ops._build import Kernel, charged, checked, nbytes, row_label
from unionml_tpu_torch.parallel.compat import refuse_dtensor
from unionml_tpu_torch.ops.attention import NEG_INF, _repeat_kv

# Above this sequence length use flash attention (the TPU kernel's S x S
# tile stops fitting VMEM; the reference's contract is kept)
MAX_FUSED_SEQ = 1024
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
HEAD_DIMS = (64, 128)

FWD_KERNEL = Kernel(
    "fused_attention", "fused_attention_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p],
)
BWD_KERNEL = Kernel(
    "fused_attention", "fused_attention_bwd",
    [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p],
)
# the rows' names under the NaN guard (the ROADMAP.md kernel table's rows)
ROW_FWD, ROW_BWD = row_label(12, FWD_KERNEL), row_label(13, BWD_KERNEL)


# --------------------------------------------------------------------- #
# plain versions (q pre-scaled, equal head counts)
# --------------------------------------------------------------------- #


def _softmax_parts(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """``e = exp2(s - rowmax(s))`` and ``z = rowsum(e)``, [B, H, Sq, Skv]
    and [B, H, Sq, 1], fp32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if causal:
        n = s.shape[-1]
        pos = torch.arange(n, device=s.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, torch.full_like(s, NEG_INF))
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return e, e.sum(dim=-1, keepdim=True)


def fused_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool
) -> torch.Tensor:
    """Plain forward (the kernel's reference) over [B, S, H, D]."""
    e, z = _softmax_parts(q, k, causal)
    o = torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype).float(), v.float())
    return (o / z).permute(0, 2, 1, 3).to(q.dtype)


def fused_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward (the kernel's reference): ``(dq, dk, dv)``."""
    e, z = _softmax_parts(q, k, causal)
    do_bh = do.permute(0, 2, 1, 3)                                   # [B, H, S, D]
    do_n = (do_bh.float() / z).to(do.dtype)
    dv = torch.einsum("bhqk,bhqd->bkhd", e.to(do.dtype).float(), do_n.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = (e * dp).sum(dim=-1, keepdim=True) / z
    ds = (e * (dp - delta) * (LN2 / z)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------- #


def _check(name: str, *tensors: torch.Tensor) -> Tuple[int, int, int, int]:
    q = tensors[0]
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name} needs all tensors on one CUDA device")
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(
            f"{name} takes [B, S, H, D] tensors of one shape, got "
            f"{[tuple(t.shape) for t in tensors]}"
        )
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(
            f"{name} takes bf16 tensors, got {[t.dtype for t in tensors]} "
            "(the CPU path takes any float dtype)"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned tensors (16-byte loads, TMA)")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS}, got {d}")
    if s > MAX_FUSED_SEQ:
        raise ValueError(f"{name} takes at most {MAX_FUSED_SEQ} tokens, got {s}")
    if b * h > 65535:
        raise ValueError(f"{name} takes batch * heads <= 65535, got {b * h}")
    return b, s, h, d


def fused_attention_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool
) -> torch.Tensor:
    """Launch the forward kernel: q (pre-scaled), k, v [B, S, H, D] bf16."""
    b, s, h, d = _check("fused_attention_fwd_cuda", q, k, v)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        FWD_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h, d,
            int(causal), torch.cuda.current_stream(q.device).cuda_stream,
        )
    return o


def fused_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (a dq pass over query tiles, then a
    dk/dv pass over key tiles, ordered on the current stream). The scratch
    holds the dq pass's per-row m, ln2 / z and delta (fp32, rows padded to
    a multiple of 64) and its ``do / z`` (bf16, do's shape) for the dk/dv
    pass."""
    b, s, h, d = _check("fused_attention_bwd_cuda", q, k, v, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    s_pad = -(-s // 64) * 64
    scratch = torch.empty(3 * b * h * s_pad * 4 + q.numel() * 2, dtype=torch.uint8,
                          device=q.device)
    with torch.cuda.device(q.device):
        BWD_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, s, h, d, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return dq, dk, dv


# --------------------------------------------------------------------- #
# the differentiable op
# --------------------------------------------------------------------- #


def _pairs(q: torch.Tensor, causal: bool) -> int:
    b, s, h = q.shape[:3]
    return b * h * (s * (s + 1) // 2 if causal else s * s)


def fused_attention_fwd_cost(q, k, v, *, causal: bool) -> Tuple[float, float]:
    """Row 12, ``(flops, bytes)`` of one call: ``q . k`` and ``p . v`` over
    the visible pairs (2 operations a multiply-add); q, k, v read and out
    written once."""
    return float(4 * _pairs(q, causal) * q.shape[-1]), float(2 * nbytes(q) + nbytes(k, v))


def fused_attention_bwd_cost(q, k, v, *, causal: bool) -> Tuple[float, float]:
    """Row 13: S and dP again, then dq, dk and dv (and the row sums of
    ``e . dP``) over the visible pairs; q, k, v, dO read and dq, dk, dv
    written once."""
    return float(10 * _pairs(q, causal) * q.shape[-1]), float(3 * nbytes(q) + 2 * nbytes(k, v))


def _on_card(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"fused_attention has no path for device {x.device}")


def _fwd(q, k, v, causal):
    with charged(fused_attention_fwd_cost, q, k, v, causal=causal):
        if _on_card(q):
            out = fused_attention_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                           causal=causal)
        else:
            out = fused_attention_fwd_plain(q, k, v, causal=causal)
        return checked(out, ROW_FWD)


class _Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        # the backward recomputes the softmax (and delta) from q, k, v
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _fwd(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with charged(fused_attention_bwd_cost, q, k, v, causal=ctx.causal):
            if _on_card(q):
                grads = fused_attention_bwd_cuda(
                    q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
                    causal=ctx.causal,
                )
            else:
                grads = fused_attention_bwd_plain(q, k, v, do, causal=ctx.causal)
            checked(grads, ROW_BWD)
        return (*grads, None)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused short-sequence attention over [B, S, H, D] tensors
    (differentiable). GQA-aware: kv heads repeat to the query heads
    outside the autograd function. Sequences longer than
    :data:`MAX_FUSED_SEQ` and unequal q/kv lengths raise ``ValueError``."""
    refuse_dtensor("fused_attention", q, k, v)
    if q.shape[1] > MAX_FUSED_SEQ:
        raise ValueError(
            f"fused_attention is for short sequences (<= {MAX_FUSED_SEQ}); "
            f"got {q.shape[1]} — use flash_attention"
        )
    if k.shape[1] != q.shape[1]:
        raise ValueError(
            f"fused_attention requires q_len == kv_len (got {q.shape[1]} vs "
            f"{k.shape[1]}) — use flash_attention or the xla reference"
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    num_heads = q.shape[2]
    k = _repeat_kv(k, num_heads)
    v = _repeat_kv(v, num_heads)
    # the factor is rounded to q's dtype, as the reference multiplies by
    # jnp.asarray(scale * LOG2E, q.dtype)
    factor = float(torch.tensor(scale * LOG2E, dtype=q.dtype))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Fused.apply(q * factor, k, v, causal)
    return _fwd(q * factor, k, v, causal)
