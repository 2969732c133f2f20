"""Paged decode attention: the Hopper kernel, its plain version, the op.

The port of :mod:`unionml_tpu.ops.paged_attention`: one query per batch
row attends over a block-paged KV pool through an int32 block table —
the decode step of the engine's paged mode. Per layer the pool is
``[num_blocks, block, kv_heads, head_dim]`` (bf16, or int8 with fp32
per-(row, head) scales ``[num_blocks, block, kv_heads]``); row ``b``
owns the pool blocks ``block_table[b, :]`` and sees its first
``lengths[b]`` rows.

- :func:`paged_attention_plain` — the reference's
  ``paged_attention_reference`` in PyTorch: gather the table's blocks
  into a contiguous ``[B, W*block, Hk, D]`` view and run the contiguous
  engine's cached-decode math (``_grouped_cache_attention`` with the
  same ``-1e30`` bias), so it is bit-identical to the contiguous cache
  path on the same rows.
- :func:`paged_attention_cuda` — the kernels of ``csrc/paged_attention.cu``
  (the port of the reference's ``_paged_kernel``): they read the pool
  blocks in place through the table (no gathered copy), keep fp32
  online-softmax statistics, read K/V at kv-head width (GQA) and fold
  int8 scales into the scores (k) and the weights (v). Each row's visible
  rows are cut into splits of :func:`split_blocks` pool blocks, one CTA
  each, whose fp32 statistics a second kernel merges in split order
  (flash-decoding; one launch of :data:`KERNEL` runs both).

:func:`paged_attention` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors. A row with nothing visible
returns zeros from the kernel (as the reference's Pallas kernel does) and
a uniform average from the plain version (as the reference's gather
path does); the engine never decodes such a row (``lengths = fill + 1``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from unionml_tpu_torch.ops._build import Kernel
from unionml_tpu_torch.ops.attention import _grouped_cache_attention

NEG_INF = -1e30

KERNEL = Kernel(
    "paged_attention", "paged_attention_fwd",
    [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
HEAD_DIMS = (64, 128)
MAX_GROUP = 8          # q heads per kv head the kernel holds in registers
IMPLS = ("auto", "pallas", "reference")
# The kernel cuts each row's visible rows into splits of whole pool blocks,
# about this many rows, one CTA each (flash-decoding).
SPLIT_ROWS = 128


def split_blocks(block: int) -> int:
    """Pool blocks per split of the kernel: fixed by the block size alone,
    never by ``lengths`` (reading those would make the host wait for the
    card)."""
    return max(1, -(-SPLIT_ROWS // block))


def _check_shapes(q, k, v, block_table, lengths, k_scale, v_scale):
    if q.dim() != 3:
        raise ValueError(f"q must be [batch, q_heads, head_dim], got {tuple(q.shape)}")
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            "k/v pools must be [num_blocks, block_size, kv_heads, "
            f"head_dim], got {tuple(k.shape)} / {tuple(v.shape)}"
        )
    if block_table.dim() != 2 or block_table.shape[0] != q.shape[0]:
        raise ValueError(
            f"block_table must be [batch, table_width], got "
            f"{tuple(block_table.shape)} for batch {q.shape[0]}"
        )
    if tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"lengths must be [batch], got {tuple(lengths.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together (int8 pools)")
    if q.shape[1] % k.shape[2]:
        raise ValueError(
            f"q heads {q.shape[1]} must be a multiple of kv heads {k.shape[2]}"
        )


def paged_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch paged decode attention (the kernel's reference):
    gather, then the contiguous cached-decode math. Shapes as in
    :func:`paged_attention`; returns [B, Hq, D] in ``q.dtype``."""
    _check_shapes(q, k, v, block_table, lengths, k_scale, v_scale)
    batch, w = block_table.shape
    block = k.shape[1]
    flat = block_table.reshape(-1).long()

    def gather(pool):
        return pool[flat].reshape((batch, w * block) + tuple(pool.shape[2:]))

    gks = None if k_scale is None else gather(k_scale)
    gvs = None if v_scale is None else gather(v_scale)
    # the contiguous engine's decode bias: kv slot j visible to the
    # single query iff j <= lengths - 1
    kv_pos = torch.arange(w * block, device=q.device)[None, :]
    visible = kv_pos[None] <= (lengths.long() - 1)[:, None, None]
    bias = torch.where(
        visible, torch.zeros((), device=q.device), torch.full((), NEG_INF, device=q.device)
    )[:, None]                                                # [B, 1, 1, W*block]
    out = _grouped_cache_attention(
        q[:, None], gather(k), gather(v), k_scale=gks, v_scale=gvs,
        bias=bias, scale=scale,
    )
    return out[:, 0]


def paged_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the paged decode kernel: q [B, Hq, D] bf16 or fp32; pools
    [N, block, Hk, D] bf16, or int8 with fp32 scales [N, block, Hk];
    block_table [B, W] int32; lengths [B] int32; all contiguous on one
    CUDA device. Returns [B, Hq, D] in ``q.dtype``."""
    _check_shapes(q, k, v, block_table, lengths, k_scale, v_scale)
    quantized = k_scale is not None
    tensors = [q, k, v, block_table, lengths] + ([k_scale, v_scale] if quantized else [])
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention_cuda needs all tensors on one CUDA device")
    batch, hq, d = q.shape
    n_blocks, block, hk, d_kv = k.shape
    if d_kv != d:
        raise ValueError(f"pool head_dim {d_kv} != q head_dim {d}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention_cuda takes head_dim in {HEAD_DIMS}, got {d}")
    if hq // hk > MAX_GROUP:
        raise ValueError(
            f"paged_attention_cuda takes at most {MAX_GROUP} q heads per kv head, "
            f"got {hq // hk}"
        )
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"paged_attention_cuda takes bf16 or fp32 q, got {q.dtype}")
    if quantized:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise ValueError(f"scaled pools must be int8, got {k.dtype} / {v.dtype}")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (n_blocks, block, hk):
                raise ValueError(
                    f"pool scales must be fp32 [{n_blocks}, {block}, {hk}], "
                    f"got {s.dtype} {tuple(s.shape)}"
                )
    elif k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError(
            f"paged_attention_cuda takes bf16 pools (or int8 with scales), "
            f"got {k.dtype} / {v.dtype}"
        )
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(
            f"block_table and lengths must be int32, got {block_table.dtype} / "
            f"{lengths.dtype}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("paged_attention_cuda needs 16-byte aligned q and pools "
                         "(16-byte asynchronous copies)")
    width = block_table.shape[1]
    splits = split_blocks(block)
    n_splits = -(-width // splits)
    if batch * max(hk * n_splits, hq) >= 2**31 or n_blocks * block * hk * d >= 2**62:
        raise ValueError(f"paged_attention_cuda grid out of range: batch {batch}, kv heads {hk}")
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    if batch == 0:
        return out
    # each split's fp32 (m, l, acc[D]) per (batch row, q head), merged by
    # the second kernel
    part = torch.empty(batch * hq * n_splits * (d + 2), dtype=torch.float32, device=q.device)
    null = 0
    with torch.cuda.device(q.device):
        KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else null,
            v_scale.data_ptr() if quantized else null,
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
            batch, hq, hk, d, n_blocks, block, width, splits,
            float(scale), int(q.dtype == torch.bfloat16), int(quantized),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return out


def paged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Single-step decode attention over a block-paged KV pool.

    Shapes: ``q`` [B, Hq, D]; ``k``/``v`` [num_blocks, block, Hk, D]
    pools (bf16, or int8 with fp32 ``k_scale``/``v_scale``
    [num_blocks, block, Hk]); ``block_table`` [B, W] (entries past a
    row's coverage point at the trash block); ``lengths`` [B] visible
    rows. Returns [B, Hq, D] in ``q.dtype``.

    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``impl`` keeps the reference's names: ``"pallas"`` asks for the
    kernel and ``"reference"`` for the plain version, and each raises on
    a tensor of the other device; ``"auto"`` picks by device.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown paged attention impl {impl!r}")
    _check_shapes(q, k, v, block_table, lengths, k_scale, v_scale)
    kwargs = dict(k_scale=k_scale, v_scale=v_scale, scale=scale)
    if q.is_cuda and impl in ("auto", "pallas"):
        return paged_attention_cuda(
            q.contiguous(), k, v, block_table.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous(), **kwargs,
        )
    if q.device.type == "cpu" and impl in ("auto", "reference"):
        return paged_attention_plain(q, k, v, block_table, lengths, **kwargs)
    raise ValueError(
        f"paged_attention impl {impl!r} has no path for device {q.device} "
        "(the kernel runs on CUDA tensors, the plain version on CPU tensors)"
    )
