"""Fused RMSNorm / LayerNorm (+ residual add) and their backward: the
Hopper kernels, their plain versions, the differentiable ops.

The port of :mod:`unionml_tpu.ops.fused_norm`. Over the last axis of
``x`` (flattened to ``[rows, D]``): fp32 statistics, ``y = ((x - mu) *
rstd) * gamma (+ beta)`` in ``x``'s dtype, no statistics saved (the
backward recomputes them). The ``add`` form computes ``s = x + r`` in fp32,
writes ``s`` in ``x``'s dtype and normalizes the fp32 sum; its backward
recomputes the statistics from the stored, rounded ``s`` and sends ``dx +
ds_in`` to both ``x`` and ``r``. The backward returns ``dx`` and fp32
``dgamma`` / ``dbeta`` (per-CTA partial rows summed in a fixed order by the
kernel's second pass).

Four kernel rows, all in ``csrc/fused_norm.cu``: the RMS forward
(:data:`KERNEL`), the LayerNorm forward (:data:`LN_KERNEL`, the same CUDA
kernel in its LayerNorm mode), the add forward (:data:`ADD_KERNEL`) and the
shared backward (:data:`BWD_KERNEL`), each with its launch count.
:func:`norm_fwd_plain`, :func:`norm_add_fwd_plain` and
:func:`norm_bwd_plain` are the same arithmetic in plain PyTorch. The ops
launch the kernels for CUDA tensors and take the plain versions only for
CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from unionml_tpu_torch.ops._build import Kernel

_FWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_BWD_ARGS = [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
KERNEL = Kernel("fused_norm", "norm_fwd", _FWD_ARGS)          # RMS forward
LN_KERNEL = Kernel("fused_norm", "norm_fwd", _FWD_ARGS)       # LayerNorm forward
ADD_KERNEL = Kernel("fused_norm", "norm_fwd", _FWD_ARGS)      # residual add + norm
BWD_KERNEL = Kernel("fused_norm", "norm_bwd", _BWD_ARGS)      # backward, both modes
_DTYPES = (torch.bfloat16, torch.float32)
# 16-byte vectors a row: the forward's 8 warps hold at most 8 a lane, the
# backward's 4
_MAX_VECS_FWD = 2048
_MAX_VECS_BWD = 1024
# rows per CTA of the backward: one fp32 partial row of dgamma/dbeta each
_BWD_ROWS_PER_CTA = 64


# --------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------- #


def _stats(x32: torch.Tensor, rms: bool, eps: float):
    if rms:
        mu = torch.zeros((), dtype=torch.float32, device=x32.device)
        var = (x32 * x32).mean(dim=-1, keepdim=True)
    else:
        mu = x32.mean(dim=-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


def _normalize(s32, gamma, beta, eps: float, rms: bool) -> torch.Tensor:
    mu, rstd = _stats(s32, rms, eps)
    out = (s32 - mu) * rstd * gamma.float()
    if beta is not None:
        out = out + beta.float()
    return out


def norm_fwd_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor], eps: float, rms: bool
) -> torch.Tensor:
    """Plain PyTorch norm forward over ``x`` [rows, D] (the kernel's
    reference); ``y`` in ``x``'s dtype."""
    return _normalize(x.float(), gamma, beta, eps, rms).to(x.dtype)


def rms_norm_plain(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch RMSNorm over ``x`` [rows, D]."""
    return norm_fwd_plain(x, gamma, None, eps, True)


def norm_add_fwd_plain(
    x: torch.Tensor, r: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
    eps: float, rms: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``s = x + r`` (fp32) and ``y = norm(s)``; both in ``x``'s dtype."""
    s32 = x.float() + r.float()
    return s32.to(x.dtype), _normalize(s32, gamma, beta, eps, rms).to(x.dtype)


def norm_bwd_plain(
    x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float, rms: bool,
    with_beta: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain norm backward over ``x``, ``dy`` [rows, D]: statistics
    recomputed from ``x``; returns ``dx`` (``x``'s dtype) and fp32
    ``dgamma``, ``dbeta`` (None unless ``with_beta``)."""
    x32, dy32 = x.float(), dy.float()
    mu, rstd = _stats(x32, rms, eps)
    xhat = (x32 - mu) * rstd
    dyg = dy32 * gamma.float()
    c2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    if rms:
        dx = rstd * (dyg - xhat * c2)
    else:
        c1 = dyg.mean(dim=-1, keepdim=True)
        dx = rstd * (dyg - c1 - xhat * c2)
    dbeta = dy32.sum(dim=0) if with_beta else None
    return dx.to(x.dtype), (dy32 * xhat).sum(dim=0), dbeta


# --------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------- #


def _check_rows(name: str, x: torch.Tensor, max_vecs: int, *others: torch.Tensor) -> None:
    if not x.is_cuda or any(t.device != x.device for t in others):
        raise ValueError(f"{name} needs all tensors on one CUDA device")
    if x.dim() != 2:
        raise ValueError(f"{name} takes x [rows, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes bf16 or fp32 x, got {x.dtype}")
    if not all(t.is_contiguous() for t in (x, *others)):
        raise ValueError(f"{name} needs contiguous tensors")
    rows, d = x.shape
    vec = 16 // x.element_size()
    if d % vec or d // vec > max_vecs:
        raise ValueError(
            f"{name} needs D a multiple of {vec} and at most {max_vecs * vec} for "
            f"{x.dtype}, got D={d}"
        )
    if rows >= 2**31:
        raise ValueError(f"{name} takes fewer than 2**31 rows, got {rows}")


def _check_params(name: str, d: int, gamma, beta) -> None:
    for t in (gamma, beta):
        if t is None:
            continue
        if t.shape != (d,) or t.dtype not in _DTYPES:
            raise ValueError(
                f"{name} takes gamma/beta [{d}] in bf16 or fp32, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
    if beta is not None and beta.dtype != gamma.dtype:
        raise ValueError(f"{name} needs gamma and beta in one dtype")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a 16-byte aligned copy of it (the forward reads gamma and
    beta as 16-byte vectors; they are [D], so a copy costs little)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _launch_fwd(kernel: Kernel, x, r, gamma, beta, s, y, eps: float, rms: bool) -> None:
    rows, d = x.shape
    if x.data_ptr() % 16 or (r is not None and r.data_ptr() % 16):
        raise ValueError("the norm forward needs x (and r) 16-byte aligned")
    if rows == 0:
        return
    gamma, beta = _aligned(gamma), _aligned(beta)
    with torch.cuda.device(x.device):
        kernel(
            x.data_ptr(), _ptr(r), gamma.data_ptr(), _ptr(beta), _ptr(s), y.data_ptr(),
            rows, d, float(eps), int(rms), int(x.dtype == torch.bfloat16),
            int(gamma.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )


def norm_fwd_cuda(
    x: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor], eps: float, rms: bool
) -> torch.Tensor:
    """Launch the norm forward on ``x`` [rows, D] (CUDA, contiguous, bf16 or
    fp32) with ``gamma`` (and ``beta``) [D]: the RMS kernel row when
    ``rms``, the LayerNorm row otherwise."""
    others = (gamma,) if beta is None else (gamma, beta)
    _check_rows("norm_fwd_cuda", x, _MAX_VECS_FWD, *others)
    _check_params("norm_fwd_cuda", x.shape[1], gamma, beta)
    y = torch.empty_like(x)
    _launch_fwd(KERNEL if rms else LN_KERNEL, x, None, gamma, beta, None, y, eps, rms)
    return y


def rms_norm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the RMSNorm kernel on ``x`` [rows, D]."""
    return norm_fwd_cuda(x, gamma, None, eps, True)


def norm_add_fwd_cuda(
    x: torch.Tensor, r: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
    eps: float, rms: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the add-norm forward: ``x``, ``r`` [rows, D] in one dtype."""
    others = (r, gamma) if beta is None else (r, gamma, beta)
    _check_rows("norm_add_fwd_cuda", x, _MAX_VECS_FWD, *others)
    _check_params("norm_add_fwd_cuda", x.shape[1], gamma, beta)
    if r.shape != x.shape or r.dtype != x.dtype:
        raise ValueError(
            f"norm_add_fwd_cuda needs r like x, got {tuple(r.shape)} {r.dtype} and "
            f"{tuple(x.shape)} {x.dtype}"
        )
    s, y = torch.empty_like(x), torch.empty_like(x)
    _launch_fwd(ADD_KERNEL, x, r, gamma, beta, s, y, eps, rms)
    return s, y


def norm_bwd_cuda(
    x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float, rms: bool,
    with_beta: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Launch the norm backward: ``x``, ``dy`` [rows, D] in one dtype
    (16-byte aligned), ``gamma`` [D] (taken in fp32). Returns ``dx`` and
    the fp32 column sums ``dgamma`` (and ``dbeta``), which the kernel's
    second pass sums from its per-CTA partial rows."""
    g32 = gamma.float().contiguous()
    _check_rows("norm_bwd_cuda", x, _MAX_VECS_BWD, g32, dy)
    _check_params("norm_bwd_cuda", x.shape[1], g32, None)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(
            f"norm_bwd_cuda needs dy like x, got {tuple(dy.shape)} {dy.dtype} and "
            f"{tuple(x.shape)} {x.dtype}"
        )
    if x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("norm_bwd_cuda needs x and dy 16-byte aligned")
    rows, d = x.shape
    dx = torch.empty_like(x)
    if rows == 0:
        zeros = torch.zeros(d, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone() if with_beta else None
    ctas = -(-rows // _BWD_ROWS_PER_CTA)
    parts = torch.empty(2 if with_beta else 1, ctas, d, dtype=torch.float32, device=x.device)
    dg = torch.empty(d, dtype=torch.float32, device=x.device)
    db = torch.empty_like(dg) if with_beta else None
    with torch.cuda.device(x.device):
        BWD_KERNEL(
            x.data_ptr(), g32.data_ptr(), dy.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr() if with_beta else None, dg.data_ptr(), _ptr(db), rows, d,
            float(eps), int(rms), int(x.dtype == torch.bfloat16), _BWD_ROWS_PER_CTA,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    return dx, dg, db


# --------------------------------------------------------------------- #
# differentiable ops
# --------------------------------------------------------------------- #


def _on(x: torch.Tensor, what: str) -> bool:
    """True for CUDA, False for CPU; any other device raises."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what} has no path for device {x.device}")


def _needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd must record the call (else the forward runs
    without the autograd function's per-call cost, as in serving)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _fwd(x2, gamma, beta, eps, rms):
    if _on(x2, "fused_layer_norm"):
        return norm_fwd_cuda(x2.contiguous(), gamma.contiguous(),
                             None if beta is None else beta.contiguous(), eps, rms)
    return norm_fwd_plain(x2, gamma, beta, eps, rms)


def _bwd(x2, gamma, dy2, eps, rms, with_beta):
    if _on(x2, "fused_layer_norm"):
        return norm_bwd_cuda(x2.contiguous(), gamma, dy2.contiguous(), eps, rms, with_beta)
    return norm_bwd_plain(x2, gamma, dy2, eps, rms, with_beta)


def _param_grads(ctx, dgamma, dbeta):
    gamma_dtype, beta_dtype = ctx.param_dtypes
    return dgamma.to(gamma_dtype), None if dbeta is None else dbeta.to(beta_dtype)


def _add_fwd(x2, r2, gamma, beta, eps, rms):
    if _on(x2, "fused_add_layer_norm"):
        return norm_add_fwd_cuda(x2.contiguous(), r2.contiguous(), gamma.contiguous(),
                                 None if beta is None else beta.contiguous(), eps, rms)
    return norm_add_fwd_plain(x2, r2, gamma, beta, eps, rms)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, rms):
        ctx.save_for_backward(x2, gamma)
        ctx.eps, ctx.rms = eps, rms
        ctx.param_dtypes = (gamma.dtype, None if beta is None else beta.dtype)
        return _fwd(x2, gamma, beta, eps, rms)

    @staticmethod
    def backward(ctx, dy):
        x2, gamma = ctx.saved_tensors
        with_beta = ctx.param_dtypes[1] is not None
        dx, dgamma, dbeta = _bwd(x2, gamma, dy, ctx.eps, ctx.rms, with_beta)
        return (dx, *_param_grads(ctx, dgamma, dbeta), None, None)


class _AddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, r2, gamma, beta, eps, rms):
        s, y = _add_fwd(x2, r2, gamma, beta, eps, rms)
        ctx.save_for_backward(s, gamma)
        ctx.eps, ctx.rms = eps, rms
        ctx.param_dtypes = (gamma.dtype, None if beta is None else beta.dtype)
        ctx.r_dtype = r2.dtype
        return s, y

    @staticmethod
    def backward(ctx, ds_in, dy):
        s, gamma = ctx.saved_tensors
        with_beta = ctx.param_dtypes[1] is not None
        if dy is None:
            dy = torch.zeros_like(s)
        dx, dgamma, dbeta = _bwd(s, gamma, dy, ctx.eps, ctx.rms, with_beta)
        # the norm's ds joins the incoming residual gradient and flows to
        # both addends
        ds_total = dx if ds_in is None else dx + ds_in
        return (ds_total, ds_total.to(ctx.r_dtype), *_param_grads(ctx, dgamma, dbeta),
                None, None)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def fused_layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
    eps: float = 1e-6, rms: bool = False,
) -> torch.Tensor:
    """``layer_norm(x) * gamma + beta`` over the last axis (any leading
    dims), one fused pass each way; ``rms=True`` drops the mean (pass
    ``beta=None``): Llama-style RMSNorm. Differentiable in ``x``,
    ``gamma`` and ``beta``."""
    if not _needs_grad(x, gamma, beta):
        return _fwd(_flat(x), gamma, beta, eps, rms).reshape(x.shape)
    return _LayerNorm.apply(_flat(x), gamma, beta, eps, rms).reshape(x.shape)


def fused_add_layer_norm(
    x: torch.Tensor, r: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
    eps: float = 1e-6, rms: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s = x + r; y = norm(s)`` in one pass; returns ``(s, y)``, both in
    ``x``'s dtype. The backward sends ``dx + ds`` to both ``x`` and ``r``."""
    if _needs_grad(x, r, gamma, beta):
        s, y = _AddLayerNorm.apply(_flat(x), _flat(r), gamma, beta, eps, rms)
    else:
        s, y = _add_fwd(_flat(x), _flat(r), gamma, beta, eps, rms)
    return s.reshape(x.shape), y.reshape(x.shape)


def fused_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Llama-style RMSNorm over the last axis of ``x`` through the fused
    kernel pair (differentiable)."""
    return fused_layer_norm(x, scale, None, eps, True)
