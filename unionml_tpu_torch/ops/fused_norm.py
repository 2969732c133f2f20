"""Fused RMSNorm forward: the Hopper kernel, its plain version, the op.

The port of :mod:`unionml_tpu.ops.fused_norm`'s RMS forward
(``_fwd_kernel`` with ``rms=True`` and no beta, through ``_norm_fwd``):
``y = x * rsqrt(mean(x^2) + eps) * gamma`` over the last axis, fp32
statistics, ``y`` in ``x``'s dtype, no statistics written. The kernel is
``csrc/fused_norm.cu``; :func:`rms_norm_plain` is the same arithmetic in
plain PyTorch. :func:`fused_rms_norm` launches the kernel for a CUDA
tensor and takes the plain version only for a CPU tensor.

The LayerNorm and residual-add forms and the backward are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

from unionml_tpu_torch.ops._build import Kernel

KERNEL = Kernel(
    "fused_norm", "rms_norm_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p],
)
_DTYPES = (torch.bfloat16, torch.float32)


def rms_norm_plain(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch RMSNorm over ``x`` [rows, D] (the kernel's reference)."""
    x32 = x.float()
    rstd = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rstd * gamma.float()).to(x.dtype)


def rms_norm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the RMSNorm kernel on ``x`` [rows, D] (CUDA, contiguous,
    bf16 or fp32) with ``gamma`` [D] (bf16 or fp32) on the same device."""
    if not x.is_cuda or gamma.device != x.device:
        raise ValueError("rms_norm_cuda needs x and gamma on one CUDA device")
    if x.dim() != 2 or gamma.shape != (x.shape[1],):
        raise ValueError(
            f"rms_norm_cuda takes x [rows, D] and gamma [D], got "
            f"{tuple(x.shape)} and {tuple(gamma.shape)}"
        )
    if x.dtype not in _DTYPES or gamma.dtype not in _DTYPES:
        raise ValueError(
            f"rms_norm_cuda takes bf16/fp32 tensors, got {x.dtype} and {gamma.dtype}"
        )
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rms_norm_cuda needs contiguous x and gamma")
    rows, d = x.shape
    vec = 16 // x.element_size()
    if d % vec:
        raise ValueError(f"rms_norm_cuda needs D % {vec} == 0 for {x.dtype}, got D={d}")
    if rows >= 2**31:
        raise ValueError(f"rms_norm_cuda takes fewer than 2**31 rows, got {rows}")
    y = torch.empty_like(x)
    if rows == 0:
        return y
    with torch.cuda.device(x.device):
        KERNEL(
            x.data_ptr(), gamma.data_ptr(), y.data_ptr(), rows, d, float(eps),
            int(x.dtype == torch.bfloat16), int(gamma.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    return y


def fused_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Llama-style RMSNorm over the last axis of ``x`` (any leading dims):
    the CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        y = rms_norm_cuda(x2.contiguous(), scale.contiguous(), eps)
    elif x.device.type == "cpu":
        y = rms_norm_plain(x2, scale, eps)
    else:
        raise ValueError(f"fused_rms_norm has no path for device {x.device}")
    return y.reshape(x.shape)
