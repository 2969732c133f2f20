"""Flash attention: the Hopper kernels, their plain versions, the ops.

The port of :mod:`unionml_tpu.ops.flash_attention`, in both its paths.
Tensors are ``[batch, seq, heads, head_dim]``; k/v keep their kv-head width
(GQA: contiguous q-head groups share a kv head, never repeated); causal
alignment is bottom-right (with ``q_len < kv_len`` the queries are the
last ``q_len`` positions).

- The forward-only padded path (``_fwd_kernel`` through
  ``_flash_fwd_padded``), the attention of a full prefill under
  ``prefill_impl="flash"``: a per-batch ``kv_valid_start`` masks left
  padding; query rows with nothing visible return zeros. Kernel
  ``flash_fwd_padded`` of ``csrc/flash_attention.cu`` (:data:`KERNEL`);
  :func:`flash_fwd_padded_plain` is its plain version.
- The differentiable path (``_flash`` and its ``custom_vjp``), the
  attention of ``attn_impl="flash"`` in long-context training: the
  forward writes ``out`` and the per-row logsumexp ``lse`` ([B, H, Sq]
  fp32, natural log, 0 for a row that sees nothing); the FlashAttention-2
  backward recomputes ``p = exp(s - lse)`` tile by tile: first ``delta =
  sum_j p_ij dp_ij`` in fp32 (``dp = dO v^T``) by a delta pass over query
  tiles, then a dq kernel over query tiles and a dk/dv kernel over key
  tiles of each q head; each head's dk / dv is rounded to the input dtype,
  then each GQA group is summed in fp32 and rounded once (a torch sum
  outside the kernel, as in the reference). The reference takes ``delta =
  rowsum(dO * O)`` from the bf16 output (:func:`output_delta`, kept for
  tests that hold the rounding points against it): where a row's value
  rows are nearly equal, ``dp - delta`` cancels and O's rounding turns dq
  and dk (ROADMAP.md C7), so the port sums the backward's own ``p``, as the
  fused attention's backward does. Kernels :data:`FWD_KERNEL`
  (``flash_fwd_lse``, the padded kernel in its lse mode),
  :data:`DELTA_KERNEL` (the dq kernel in its delta mode), :data:`DQ_KERNEL`
  and :data:`DKV_KERNEL` (``csrc/flash_bwd.cu``); :func:`flash_fwd_plain`,
  :func:`flash_delta` and :func:`flash_bwd_plain` are the same arithmetic
  in plain PyTorch, rounding where the TPU kernels round (``p`` to the
  value dtype before ``p @ v`` and ``p^T @ dO``, ``ds`` to the input dtype
  before ``ds @ k`` and ``ds^T @ q``, each q head's dk / dv before the
  group sum).

Every op launches the kernels for CUDA tensors (bf16, head_dim 64 or 128;
anything else raises) and takes the plain versions only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from unionml_tpu_torch.ops._build import Kernel
from unionml_tpu_torch.parallel.compat import refuse_dtensor

NEG_INF = -1e30

_SHAPE_ARGS = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
KERNEL = Kernel("flash_attention", "flash_fwd_padded", [ctypes.c_void_p] * 5 + _SHAPE_ARGS)
FWD_KERNEL = Kernel("flash_attention", "flash_fwd_lse", [ctypes.c_void_p] * 5 + _SHAPE_ARGS)
DELTA_KERNEL = Kernel("flash_bwd", "flash_bwd_delta", [ctypes.c_void_p] * 6 + _SHAPE_ARGS)
DQ_KERNEL = Kernel("flash_bwd", "flash_bwd_dq", [ctypes.c_void_p] * 7 + _SHAPE_ARGS)
DKV_KERNEL = Kernel("flash_bwd", "flash_bwd_dkv", [ctypes.c_void_p] * 7 + _SHAPE_ARGS)
HEAD_DIMS = (64, 128)
LOG2E = 1.4426950408889634
STAT_ROWS = 64   # the dk/dv kernel copies lse / delta in 64-row (256-byte) segments


def _causal_visible(q_len: int, kv_len: int, device) -> torch.Tensor:
    """bool [Sq, Skv]: key j visible to query i under bottom-right causal
    alignment (query i sits at position i + Skv - Sq)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    return q_pos >= torch.arange(kv_len, device=device)[None, :]


def _visible(pad: torch.Tensor, q_len: int, kv_len: int, causal: bool) -> torch.Tensor:
    """bool [B, 1, 1, Sq, Skv]: kv j visible to query i (bottom-right
    causal alignment, kv positions below the row's pad hidden)."""
    kv_pos = torch.arange(kv_len, device=pad.device)
    vis = kv_pos[None, None, :] >= pad.long()[:, None, None]          # [B,1,K]
    if causal:
        vis = vis & _causal_visible(q_len, kv_len, pad.device)[None]    # [B,Q,K]
    else:
        vis = vis.expand(-1, q_len, -1)
    return vis[:, None, None]


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 ``q k^T * scale`` per GQA group: [B, KVH, G, Sq, Skv]."""
    b, q_len, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, q_len, kvh, h // kvh, d).float()
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale


def _plain_forward(q, k, v, vis: Optional[torch.Tensor], scale: float):
    """Softmax attention over the visible pairs (``vis`` broadcasts against
    [B, KVH, G, Sq, Skv]; None = all): ``(out [B, Sq, H, D] in q's dtype,
    lse [B, H, Sq] fp32)``. Scores and statistics in fp32, ``p`` rounded to
    the value dtype before ``p @ v``, normalised after."""
    b, q_len, h, d = q.shape
    s = _scores(q, k, scale)
    if vis is not None:
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    if vis is not None:
        p = torch.where(vis, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)                                   # [B,KVH,G,Q,1]
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2, 4)
    lse = torch.where(l > 0, m_safe + torch.log(l.clamp_min(1e-30)), torch.zeros_like(l))
    return out.reshape(b, q_len, h, d).to(q.dtype), lse.reshape(b, h, q_len)


def flash_fwd_padded_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pad: torch.Tensor,
    *, causal: bool, scale: float,
) -> torch.Tensor:
    """Plain PyTorch padded attention (the padded kernel's reference)."""
    return _plain_forward(q, k, v, _visible(pad, q.shape[1], k.shape[1], causal), scale)[0]


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward of the differentiable path (the lse kernel's
    reference): ``(out, lse)``, ``lse`` [B, H, Sq] fp32."""
    vis = _causal_visible(q.shape[1], k.shape[1], q.device) if causal else None
    return _plain_forward(q, k, v, vis, scale)


def output_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The reference's ``delta = rowsum(dO * O)`` from the output, fp32
    [B, H, Sq]. No path of the op uses it: tests feed it to the plain
    backward to hold the rounding points against the JAX kernels, and
    ``chip_smoke.py`` plants it as the fault its BERT check must catch."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _probs(q, k, v, do, lse, vis: Optional[torch.Tensor], scale: float):
    """fp32 ``p = exp(s - lse)`` over the visible pairs and ``dp = dO v^T``,
    both [B, KVH, G, Sq, Skv], and dO grouped as [B, Sq, KVH, G, D]."""
    b, q_len, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    p = torch.exp(_scores(q, k, scale) - lse.reshape(b, kvh, g, q_len, 1))
    if vis is not None:
        p = torch.where(vis, p, torch.zeros_like(p))
    dog = do.reshape(b, q_len, kvh, g, d).float()
    return p, torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float()), dog


def flash_delta(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    *, causal: bool, scale: float,
) -> torch.Tensor:
    """Plain PyTorch ``delta = sum_j p_ij dp_ij`` in fp32, [B, H, Sq] (the
    delta kernel's reference): ``p = exp(s - lse)`` over the keys of ``k``
    that query i sees, ``dp = dO v^T``; 0 for a row that sees nothing. For
    one global ``lse``, sums over shards of the keys add up to the whole."""
    vis = _causal_visible(q.shape[1], k.shape[1], q.device) if causal else None
    p, dp, _ = _probs(q, k, v, do, lse, vis, scale)
    b, q_len, h, _ = q.shape
    return (p * dp).sum(-1).reshape(b, h, q_len)


def _plain_backward(q, k, v, do, lse, delta, vis: Optional[torch.Tensor], scale: float):
    """The FlashAttention-2 backward over the visible pairs (``vis`` as in
    :func:`_plain_forward`; ``delta`` [B, H, Sq] fp32, None = summed here
    from ``p`` and ``dp``): ``(dq, dk, dv)`` in the inputs' dtypes; each q
    head's dk/dv rounded to the input dtype, then each GQA group summed in
    fp32 and rounded once."""
    b, q_len, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    p, dp, dog = _probs(q, k, v, do, lse, vis, scale)
    if delta is None:
        delta = (p * dp).sum(-1, keepdim=True)
    else:
        delta = delta.reshape(b, kvh, g, q_len, 1)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(b, q_len, h, d)
    # each q head's dk / dv rounds to the input dtype (the TPU kernels' output),
    # then the group is summed in fp32 and rounded once (the reference's sum)
    qg = q.reshape(b, q_len, kvh, g, d).float()
    dv = torch.einsum("bhgqk,bqhgd->bkhgd", p.to(do.dtype).float(), dog).to(v.dtype)
    dk = torch.einsum("bhgqk,bqhgd->bkhgd", ds, qg).to(k.dtype)
    return dq.to(q.dtype), dk.float().sum(3).to(k.dtype), dv.float().sum(3).to(v.dtype)


def flash_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    *, causal: bool, scale: float, delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch FlashAttention-2 backward (the dq and dk/dv kernels'
    reference): ``(dq, dk, dv)`` in the inputs' dtypes; each q head's dk/dv
    rounded to the input dtype, then each GQA group summed in fp32 and
    rounded once (the reference's rounding points). ``delta`` (fp32 [B, H,
    Sq]) is :func:`flash_delta`'s sum when not given."""
    vis = _causal_visible(q.shape[1], k.shape[1], q.device) if causal else None
    return _plain_backward(q, k, v, do, lse, delta, vis, scale)


# --------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------- #


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *rest: torch.Tensor):
    """Device, layout, dtype and shape checks of every flash kernel:
    returns ``(b, q_len, kv_len, h, kvh, d)``."""
    tensors = (q, k, v, *rest)
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name} needs all tensors on one CUDA device")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(
            f"{name} takes [B,S,H,D] q and matching k/v, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, q_len, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
            "(batch, head_dim, or q heads not a multiple of kv heads)"
        )
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS}, got {d}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if b * h > 65535:
        raise ValueError(f"batch * heads must be at most 65535, got {b * h}")
    return b, q_len, k.shape[1], h, k.shape[2], d


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The kernels read and write through TMA (and bulk copies), which
    need 16-byte aligned base addresses."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned tensors (TMA)")


def flash_fwd_padded_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pad: torch.Tensor,
    *, causal: bool, scale: float,
) -> torch.Tensor:
    """Launch the padded flash kernel: q [B, Sq, H, D], k/v [B, Skv, KVH,
    D] bf16 contiguous on one CUDA device, pad [B] int32 there too."""
    b, q_len, kv_len, h, kvh, d = _check("flash_fwd_padded_cuda", q, k, v, pad)
    if pad.dtype != torch.int32 or pad.shape != (b,):
        raise ValueError(f"pad must be int32 [{b}], got {pad.dtype} {tuple(pad.shape)}")
    _check_aligned("flash_fwd_padded_cuda", q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(), out.data_ptr(),
            b, q_len, kv_len, h, kvh, d, float(scale), int(causal), _stream(q),
        )
    return out


def flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the lse-form forward kernel (row 9): q [B, Sq, H, D], k/v
    [B, Skv, KVH, D] bf16 contiguous on one CUDA device; returns ``(out,
    lse [B, H, Sq] fp32)``."""
    b, q_len, kv_len, h, kvh, d = _check("flash_fwd_cuda", q, k, v)
    _check_aligned("flash_fwd_cuda", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, q_len, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        FWD_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, q_len, kv_len, h, kvh, d, float(scale), int(causal), _stream(q),
        )
    return out, lse


def _check_bwd(name, q, k, v, do, *stats):
    """:func:`_check` of the backward's operands, then ``do`` against q and
    each of ``stats`` (lse, and delta where given) as fp32 [B, H, Sq]."""
    b, q_len, kv_len, h, kvh, d = _check(name, q, k, v, do, *stats)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for stat, t in zip(("lse", "delta"), stats):
        if t.dtype != torch.float32 or t.shape != (b, h, q_len):
            raise ValueError(f"{stat} must be fp32 [{b}, {h}, {q_len}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return b, q_len, kv_len, h, kvh, d


def flash_delta_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    *, causal: bool, scale: float,
) -> torch.Tensor:
    """Launch the delta pass (the dq kernel in its delta mode): the
    operands of :func:`flash_bwd_dq_cuda` without ``delta``; returns
    :func:`flash_delta`'s sum, fp32 [B, H, Sq]."""
    b, q_len, kv_len, h, kvh, d = _check_bwd("flash_delta_cuda", q, k, v, do, lse)
    _check_aligned("flash_delta_cuda", q, k, v, do)
    delta = torch.empty(b, h, q_len, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        DELTA_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(), b, q_len, kv_len, h, kvh, d, float(scale), int(causal),
                     _stream(q))
    return delta


def flash_bwd_dq_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, scale: float,
) -> torch.Tensor:
    """Launch the dq kernel (row 10): q/do [B, Sq, H, D], k/v [B, Skv,
    KVH, D] bf16, lse/delta [B, H, Sq] fp32, all contiguous on one CUDA
    device; returns dq (bf16)."""
    b, q_len, kv_len, h, kvh, d = _check_bwd("flash_bwd_dq_cuda", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _check_aligned("flash_bwd_dq_cuda", q, k, v, do, dq)
    with torch.cuda.device(q.device):
        DQ_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), b, q_len, kv_len, h, kvh, d,
                  float(scale), int(causal), _stream(q))
    return dq


def flash_bwd_dkv_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel (row 11) on the operands of
    :func:`flash_bwd_dq_cuda`; returns ``(dk, dv)`` (bf16, [B, Skv, KVH,
    D]). The kernel reads lse * log2(e) and delta from one padded fp32 copy
    ([2, B * H, Sq rounded up to 64]: its rows are bulk-copied, which needs
    16-byte aligned rows) and writes each q head's dk / dv rounded to bf16
    (into one [2, B, Skv, H, D] tensor); under GQA each group is then
    summed in fp32 and rounded once, as the reference sums it outside its
    kernel. dk and dv are views of one [2, ...] tensor."""
    b, q_len, kv_len, h, kvh, d = _check_bwd("flash_bwd_dkv_cuda", q, k, v, do, lse, delta)
    g = h // kvh
    stats = torch.zeros(2, b * h, -(-q_len // STAT_ROWS) * STAT_ROWS, dtype=torch.float32,
                        device=q.device)
    stats[0, :, :q_len] = lse.view(b * h, q_len) * LOG2E
    stats[1, :, :q_len] = delta.view(b * h, q_len)
    heads = torch.empty(2, b, kv_len, h, d, dtype=k.dtype, device=k.device)  # dk, dv per q head
    _check_aligned("flash_bwd_dkv_cuda", q, k, v, do, stats, heads[0], heads[1])
    with torch.cuda.device(q.device):
        DKV_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats.data_ptr(),
                   heads[0].data_ptr(), heads[1].data_ptr(), b, q_len, kv_len, h, kvh, d,
                   float(scale), int(causal), _stream(q))
    if g > 1:
        heads = heads.view(2, b, kv_len, kvh, g, d).sum(4, dtype=torch.float32).to(k.dtype)
    return heads[0], heads[1]


def flash_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    *, causal: bool, scale: float, delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the card: the delta pass (unless ``delta`` is
    given), then the dq kernel and the dk/dv kernel, ordered on the
    current stream."""
    kw = dict(causal=causal, scale=scale)
    if delta is None:
        delta = flash_delta_cuda(q, k, v, do, lse, **kw)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw))


# --------------------------------------------------------------------- #
# the ops
# --------------------------------------------------------------------- #


def _on_card(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"flash_attention has no path for device {x.device}")


def _fwd(q, k, v, causal: bool, scale: float):
    if _on_card(q):
        return flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, scale=scale)
    return flash_fwd_plain(q, k, v, causal=causal, scale=scale)


def _padded_fwd(q, k, v, pad, causal: bool, scale: float):
    if _on_card(q):
        return flash_fwd_padded_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                     pad.contiguous(), causal=causal, scale=scale)
    return flash_fwd_padded_plain(q, k, v, pad, causal=causal, scale=scale)


class _PaddedForwardOnly(torch.autograd.Function):
    """The padded path under autograd: the forward runs, differentiating it
    raises, as ``jax.grad`` through the reference's padded path does."""

    @staticmethod
    def forward(ctx, q, k, v, pad, causal, scale):
        return _padded_fwd(q, k, v, pad, causal, scale)

    @staticmethod
    def backward(ctx, do):
        raise RuntimeError(
            "flash_attention with kv_valid_start is forward-only (the reference's "
            "padded path has no backward); differentiate the path without it"
        )


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _fwd(q, k, v, causal, scale)
        # the backward recomputes p from lse, and delta from p: the output
        # is not a residual (the reference keeps it for its delta)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        if _on_card(q):
            grads = flash_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                   do.contiguous(), lse, **kw)
        else:
            grads = flash_bwd_plain(q, k, v, do, lse, **kw)
        return (*grads, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: Optional[int] = None,
    kv_valid_start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention over [B,S,H,D] tensors (GQA-aware), the reference's
    signature. Without ``kv_valid_start`` it is the differentiable path
    (the lse forward and the FlashAttention-2 backward kernels). With it
    (``[B]`` first visible kv position per row: left-padded prompts) it is
    the forward-only padded path; fully masked query rows return zeros, and
    a backward through it raises ``RuntimeError``, as in the reference.
    ``block_q`` / ``block_kv`` are the TPU kernels' tile sizes and are
    accepted for the reference's callers only: the CUDA kernels keep their
    own tiles (the forward: 128 queries by 128 keys; the backward's dq:
    192 queries at head_dim 64 and 128 at 128, by 64 keys; its dk/dv: 192
    or 128 keys of one q head by 64 queries). The CUDA
    kernels for CUDA tensors, the plain versions for CPU ones."""
    del block_q, block_kv  # the TPU's tile knobs; see the docstring
    refuse_dtensor("flash_attention", q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kv_valid_start is not None:
        pad = kv_valid_start.to(device=q.device, dtype=torch.int32)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return _PaddedForwardOnly.apply(q, k, v, pad, causal, float(scale))
        return _padded_fwd(q, k, v, pad, causal, float(scale))
    if q.shape[2] % k.shape[2] or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: q heads {q.shape[2]} must be a multiple of kv heads "
            f"{k.shape[2]}, and k {tuple(k.shape)} must match v {tuple(v.shape)}"
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, float(scale))
    return _fwd(q, k, v, causal, float(scale))[0]
