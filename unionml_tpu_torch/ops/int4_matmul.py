"""Packed-int4 weight-only matmul: the Hopper kernel, its plain version, the op.

The port of :mod:`unionml_tpu.ops.int4_matmul`. Weights are stored TWO
NIBBLES PER int8 BYTE, ``[K, N/2]``, so a decode step reads them at 4 bits
a weight; the kernel unpacks them on the card and never writes a wider
weight to device memory.

Packing layout (``pack_int4``): output channels are tiled by ``tile_n``;
within tile ``j`` the LOW nibbles hold channels ``[j*T, j*T + T/2)`` and
the HIGH nibbles ``[j*T + T/2, (j+1)*T)``. A low nibble is sign-extended
as ``((q & 15) ^ 8) - 8``, a high nibble is the arithmetic ``q >> 4`` of
the int8 byte. The layout functions (``_grid_for``, ``_k_block_for``,
``tile_for``) are kept as the reference has them, VMEM budget included:
they decide which layers pack as int4 and with which tile, so a tree
carried over from the JAX package must get the same answers here.

- :func:`int4_matmul_plain` — the kernel's plain version: per-channel,
  the fp32-accumulated product then ``* scale``; grouped, each K-group's
  fp32 partial times its ``scale_g`` row, summed in fp32 in group order;
  one cast to ``dtype`` at the end.
- :func:`int4_matmul_cuda` — the kernel of ``csrc/int4_matmul.cu``, one
  design for both scale forms (the port of ``_kernel`` and of
  ``_kernel_grouped``): bf16 ``wgmma`` products with fp32 accumulation
  over a K split fixed by ``(K, N)`` and the group, grouped partials
  scaled at each group end, the slices summed in a thread block cluster;
  fp32 FMA for an fp32 compute dtype. A row's result never depends on how
  many rows share the launch.
- :func:`int4_matmul` routes as the reference's ``use_pallas`` test does:
  ``0 < rows <= MAX_PALLAS_ROWS``, a tile, a K block, and a tile that is a
  multiple of 256 or the whole width take the kernel for CUDA tensors and
  the plain version for CPU tensors; every other call takes the
  reference's unpack fallback (one ``torch.matmul``; grouped, the weight
  dequantized at fp32 and cast to the compute dtype first — a different
  rounding point, kept distinct so both packages take the same route).
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Tuple

import torch

from unionml_tpu_torch.ops._build import Kernel

__all__ = [
    "MAX_PALLAS_ROWS",
    "fp32_product",
    "int4_matmul",
    "int4_matmul_cuda",
    "int4_matmul_plain",
    "pack_int4",
    "quantize_kernel_int4",
    "tile_for",
    "unpack_int4",
]

TILE_N = 512          # output-channel tile; N must divide by a tile choice
MAX_PALLAS_ROWS = 64  # decode/verify row counts; larger rows -> the fallback

# the reference's per-program VMEM budget for the weight-side buffers; it
# means nothing on the card but fixes the tile and K-block choices, which
# are part of the parameter layout
_VMEM_WEIGHT_BYTES = 11_000_000

# one C entry for both scale forms, bound twice so that each kernel row
# keeps its own launch count: the per-channel form (the port of
# ``_kernel``) and the group-wise form (the port of ``_kernel_grouped``)
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
KERNEL = Kernel("int4_matmul", "int4_matmul_fwd", _ARGS)
KERNEL_GROUPED = Kernel("int4_matmul", "int4_matmul_fwd", _ARGS)
KERNEL_GROUP_ALIGN = 128   # the kernel's K chunk: a group is a multiple of it or all of K

# the bf16 kernel's K split: its CTAs own 128 output channels of one K-slice
# of whole units (128-row chunks, or whole scale groups), and the slices of
# a channel tile are summed in rank order. The split is a function of (K,
# N) and the group alone, so a row's result never depends on the row
# count.
CHANNEL_TILE = 128
K_CHUNK = 128
MAX_K_SPLITS = 8
_SMS = 132    # the H100's SMs: the split fills the card with CTAs


def _k_splits(k: int, n: int, group: int = 0) -> int:
    """The bf16 kernel's number of K-slices for ``K``, ``N`` and the scale
    group (0: per-channel): the smallest power of two that gives
    ``ceil(N / 128) * S >= 132`` CTAs, at most 8 and at least one unit a
    slice, a unit being a 128-row chunk (per-channel) or a whole group."""
    tiles, units = -(-n // CHANNEL_TILE), -(-k // (group or K_CHUNK))
    s = 1
    while s < MAX_K_SPLITS and tiles * s < _SMS and 2 * s <= units:
        s *= 2
    return s


def _k_slices(k: int, splits: int, group: int = 0):
    """The ``[start, end)`` K rows of each slice, in rank order, as the
    kernel cuts them: whole units (128-row chunks, or whole groups), the
    tail in the last."""
    unit = group or K_CHUNK
    units = -(-k // unit)
    cuts = [r * units // splits * unit for r in range(splits + 1)]
    return [(a, min(b, k)) for a, b in zip(cuts, cuts[1:])]


def _tma_path(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor = None,
              tile_n: int = 0, group_size: int = 0) -> bool:
    """Whether the kernel reads x and the weights by TMA: 16-byte aligned
    bases and row strides; grouped bf16 also reads a tile's low (high)
    channels' scales by TMA as one run of 64 (a 16-byte aligned scale
    base, and a half tile a multiple of 64 channels or the tile all of N).
    Any other call takes the kernel's simple path."""
    k, half = packed.shape
    scale_runs = (not group_size or x.dtype == torch.float32) or (
        scale.data_ptr() % 16 == 0 and ((tile_n // 2) % 64 == 0 or tile_n == 2 * half))
    return (half % 16 == 0 and (k * x.element_size()) % 16 == 0 and scale_runs
            and x.data_ptr() % 16 == 0 and packed.data_ptr() % 16 == 0)


def _grid_for(n: int, k: int, shards: int = 1, group_size: int = 0):
    """``(tile_n, k_block)`` for N output channels at contraction width K,
    as the reference picks them (``(0, 0)``: no conforming tile). The tile
    divides the per-device width ``n // shards``; multi-tile means tile in
    {512, 256, 128}; any even N works single-tile when ``shards == 1``."""
    if n % 2 or n % max(1, shards):
        return 0, 0
    local = n // max(1, shards)
    candidates = [t for t in (512, 256, 128) if local % t == 0]
    if not candidates and shards == 1:
        candidates = [n]  # single-tile: any even width
    for t in candidates:
        kb = _k_block_for(k, t, group_size)
        if kb:
            return t, kb
    return 0, 0


def _k_block_for(k: int, tile_n: int, group_size: int = 0) -> int:
    """The reference's K block for a GIVEN tile: halve from K (or the
    scale group) until the weight-side buffers fit its budget; 0 when no
    block of K (or a multiple of 128) fits."""
    kb = min(k, group_size) if group_size else k
    while 9 * kb * (tile_n // 2) > _VMEM_WEIGHT_BYTES and kb % 2 == 0:
        kb //= 2
    if 9 * kb * (tile_n // 2) <= _VMEM_WEIGHT_BYTES and (
        kb == k or kb % 128 == 0
    ):
        return kb
    return 0


def tile_for(n: int, k: int, shards: int = 1) -> int:
    """The packing tile for ``N`` output channels at contraction width
    ``K`` (0 = no conforming tile; the layer stays int8). ``shards``: the
    tensor-parallel degree the packing must survive (the tile divides the
    per-device channel count)."""
    return _grid_for(n, k, shards=shards)[0]


def pack_int4(nibbles: torch.Tensor, tile_n: int) -> torch.Tensor:
    """Pack int8 nibble values (in [-8, 7]) ``[K, N]`` -> ``[K, N/2]`` int8,
    tile-slab order (see the module docstring)."""
    k, n = nibbles.shape
    t = nibbles.reshape(k, n // tile_n, tile_n).to(torch.int32)
    lo = t[:, :, : tile_n // 2] & 0xF
    hi = (t[:, :, tile_n // 2:] & 0xF) << 4
    p = (lo | hi).reshape(k, n // 2)
    return torch.where(p > 127, p - 256, p).to(torch.int8)


def unpack_int4(packed: torch.Tensor, tile_n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``[K, N/2]`` int8 -> ``[K, N]`` int8."""
    k, half = packed.shape
    q = packed.to(torch.int32)
    hi = q >> 4
    lo = ((q & 15) ^ 8) - 8
    t = torch.cat(
        [lo.reshape(k, half // (tile_n // 2), tile_n // 2),
         hi.reshape(k, half // (tile_n // 2), tile_n // 2)],
        dim=2,
    )
    return t.reshape(k, 2 * half).to(torch.int8)


def quantize_kernel_int4(
    w2d: torch.Tensor, tile_n: int, group_size: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4: ``[K, N]`` fp -> ``(packed [K, N/2] int8, scale)``.
    ``group_size=0``: per-output-channel absmax/7, scale ``[N]``;
    ``group_size=g``: per-(K-group, channel) absmax/7, scale ``[K/g, N]``
    (g must divide K). ``tile_n`` bakes the slab order into the packing."""
    w = w2d.float()
    k, n = w.shape
    if group_size:
        if group_size < 1 or k % group_size:
            raise ValueError(f"group_size {group_size} must divide K={k}")
        g = w.reshape(k // group_size, group_size, n)
        absmax = g.abs().amax(dim=1)                                  # [K/g, N]
        scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
        nib = torch.clamp(torch.round(g / scale[:, None, :]), -8, 7).to(torch.int8)
        return pack_int4(nib.reshape(k, n), tile_n), scale
    absmax = w.abs().amax(dim=0)                                      # [N]
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    nib = torch.clamp(torch.round(w / scale), -8, 7).to(torch.int8)
    return pack_int4(nib, tile_n), scale


def _check_scale(x, scale, group_size: int) -> None:
    k = x.shape[1]
    n = scale.shape[-1]
    if group_size:
        if scale.dim() != 2 or scale.shape[0] != k // group_size:
            raise ValueError(
                f"group_size={group_size} needs scale [K/g, N] = "
                f"[{k // group_size}, {n}], got {tuple(scale.shape)}"
            )
    elif scale.dim() != 1:
        raise ValueError(
            f"per-channel int4 needs scale [N], got {tuple(scale.shape)} — pass "
            "group_size for group-wise scales"
        )


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.bfloat16


def fp32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in fp32 with an fp32 result, NOT rounded to
    the compute dtype (the weight-only layers' rounding point: the scale
    is applied to this fp32 product). ``x`` is in the compute dtype; ``w``
    holds values exact in it (int8, nibbles, or weights already cast). A
    bf16/fp16 product on the card runs on the tensor cores; otherwise an
    fp32 product of the same values gives the same numbers."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(x, w.to(x.dtype), out_dtype=torch.float32)
    return x.float() @ w.float()


def int4_matmul_plain(
    x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
    tile_n: int, dtype: torch.dtype = torch.bfloat16, group_size: int = 0,
) -> torch.Tensor:
    """The kernel's plain version (shapes as :func:`int4_matmul`): what
    ``_kernel`` / ``_kernel_grouped`` compute, in fp32 on the unpacked
    nibbles. Per-channel: ``(x @ W) * scale``; grouped: the sum over
    K-groups, in group order, of each group's fp32 partial times its
    ``scale_g`` row. One cast to ``dtype``."""
    _check_scale(x, scale, group_size)
    compute = _compute_dtype(dtype)
    xc = x.to(compute).float()
    w = unpack_int4(packed, tile_n).float()
    if not group_size:
        return ((xc @ w) * scale.float()).to(dtype)
    rows, k = xc.shape
    groups = k // group_size
    partial = torch.bmm(
        xc.reshape(rows, groups, group_size).transpose(0, 1),
        w.reshape(groups, group_size, -1),
    ) * scale.float()[:, None, :]                                      # [G, rows, N]
    y = partial[0].clone()
    for g in range(1, groups):
        y += partial[g]
    return y.to(dtype)


def _fallback(x, packed, scale, *, tile_n, dtype, group_size):
    """The reference's unpack path for every shape the kernel does not
    take (prefill rows, untileable or small-group layers)."""
    compute = _compute_dtype(dtype)
    w = unpack_int4(packed, tile_n)
    if group_size:
        # dequantize at fp32 so group scales keep their precision, cast the
        # weight to the compute dtype, then one product
        k, n = w.shape
        per_row = scale.float()[:, None, :].expand(k // group_size, group_size, n)
        w_f = w.float() * per_row.reshape(k, n)
        return fp32_product(x.to(compute), w_f.to(compute)).to(dtype)
    y = fp32_product(x.to(compute), w)
    return (y * scale.float()).to(dtype)


def int4_matmul_cuda(
    x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
    tile_n: int, group_size: int = 0,
) -> torch.Tensor:
    """Launch the int4 kernel: x ``[rows <= 64, K]`` bf16 or fp32 (the
    compute dtype, also the output's), packed ``[K, N/2]`` int8, scale fp32
    ``[N]`` or ``[K/g, N]``; all contiguous on one CUDA device. Returns
    ``[rows, N]`` in x's dtype."""
    _check_scale(x, scale, group_size)
    if not x.is_cuda or packed.device != x.device or scale.device != x.device:
        raise ValueError("int4_matmul_cuda needs all tensors on one CUDA device")
    rows, k = x.shape
    n = scale.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int4_matmul_cuda computes in bf16 or fp32, got {x.dtype}")
    if packed.dtype != torch.int8 or tuple(packed.shape) != (k, n // 2) or n % 2:
        raise ValueError(
            f"packed must be int8 [K, N/2] = [{k}, {n // 2}], got {packed.dtype} "
            f"{tuple(packed.shape)}"
        )
    if scale.dtype != torch.float32:
        raise ValueError(f"int4 scales must be fp32, got {scale.dtype}")
    if not 1 <= rows <= MAX_PALLAS_ROWS:
        raise ValueError(f"int4_matmul_cuda takes 1..{MAX_PALLAS_ROWS} rows, got {rows}")
    if tile_n <= 0 or tile_n % 2 or n % tile_n:
        raise ValueError(f"tile_n {tile_n} must be even and divide N={n}")
    group = group_size or k
    if k % group or (group != k and group % KERNEL_GROUP_ALIGN):
        raise ValueError(
            f"int4_matmul_cuda takes groups that divide K={k} and are a multiple "
            f"of {KERNEL_GROUP_ALIGN} or all of K, got {group_size}"
        )
    if not all(t.is_contiguous() for t in (x, packed, scale)):
        raise ValueError("int4_matmul_cuda needs contiguous tensors")
    if k * max(rows, n // 2) >= 2**31 or rows * n >= 2**31:
        raise ValueError(f"int4_matmul_cuda index range exceeded: rows {rows}, K {k}, N {n}")
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    fp32 = int(x.dtype == torch.float32)
    splits = 1 if fp32 else _k_splits(k, n, group_size)
    simple = int(not _tma_path(x, packed, scale, tile_n, group_size))
    with torch.cuda.device(x.device):
        (KERNEL_GROUPED if group_size else KERNEL)(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, k, n,
            tile_n, group_size, splits, fp32, simple,
            torch.cuda.current_stream(x.device).cuda_stream)
    return out


def int4_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    tile_n: int,
    dtype: torch.dtype = torch.bfloat16,
    group_size: int = 0,
) -> torch.Tensor:
    """``x [rows, K] @ W4`` where ``W4`` is ``pack_int4``-packed ``[K,
    N/2]`` with fp32 ``scale``: per-output-channel ``[N]``
    (``group_size=0``) or group-wise ``[K/group_size, N]``. The compute
    dtype follows ``dtype`` (fp32 for the LM head's logits contract, bf16
    otherwise); the result is in ``dtype``.

    Routed as the reference routes its Pallas kernel: decode-sized row
    counts with a conforming tile run the kernel (CUDA tensors) or its
    plain version (CPU tensors); anything else takes the unpack
    fallback."""
    _check_scale(x, scale, group_size)
    rows, k = x.shape
    n = scale.shape[-1]
    compute = _compute_dtype(dtype)
    k_block = _k_block_for(k, tile_n, group_size) if tile_n > 0 else 0
    tile_ok = tile_n % 256 == 0 or tile_n == n
    use_kernel = 0 < rows <= MAX_PALLAS_ROWS and tile_n > 0 and k_block > 0 and tile_ok
    if group_size and group_size % 128 and tile_n > 0 and 0 < rows <= MAX_PALLAS_ROWS:
        warnings.warn(
            f"int4 group_size={group_size} is not a multiple of 128: decode "
            "takes the unpack path at full-width weight reads instead of the "
            "packed-width kernel. Use group_size=128 to keep the kernel.",
            stacklevel=2,
        )
    kwargs = dict(tile_n=tile_n, group_size=group_size)
    if not use_kernel:
        return _fallback(x, packed, scale, dtype=dtype, **kwargs)
    if x.is_cuda:
        return int4_matmul_cuda(
            x.to(compute).contiguous(), packed.contiguous(), scale.float().contiguous(),
            **kwargs,
        ).to(dtype)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale, dtype=dtype, **kwargs)
    raise ValueError(
        f"int4_matmul has no kernel path for device {x.device} (the kernel runs "
        "on CUDA tensors, the plain version on CPU tensors)"
    )
