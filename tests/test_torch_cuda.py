"""The port's CUDA kernels and its paged engine on the card.

These tests import neither JAX nor the JAX package, so they run on the
machine with the card (``python -m pytest tests/test_torch_cuda.py``);
without a CUDA device each one skips. Each kernel is held against its
plain PyTorch version on the same inputs, within the tolerance stated at
the assertion, and its launch count must rise.
"""

import dataclasses

import pytest
import torch

from unionml_tpu_torch.models import (
    LLAMA_QUANT_PATTERNS,
    Llama,
    LlamaConfig,
    init_params,
    quantize_params,
)
from unionml_tpu_torch.ops import flash_attention as tflash
from unionml_tpu_torch.ops import fused_attention as tfused
from unionml_tpu_torch.ops import fused_norm as tnorm
from unionml_tpu_torch.ops import int4_matmul as tint4
from unionml_tpu_torch.ops import paged_attention as tpaged
from unionml_tpu_torch.serving import DecodeEngine


def _verify_and_steps(cfg, params, device, prompt_len=32):
    """One speculative round's two sides over 8 slots with their own fills
    (below ``prompt_len``): the target's multi-token verify of k + 1
    tokens, and the same tokens fed one at a time as a draft's decode steps
    (the engine's masks). Returns (verify logits, step logits), each [8,
    k + 1, vocab]."""
    from unionml_tpu_torch.models.llama import init_cache

    module = Llama(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    b, k = 8, 4
    length = prompt_len + 2 * k
    cache = init_cache(cfg, b, length, device=device)
    prompt = torch.randint(1, cfg.vocab_size, (b, prompt_len), generator=gen, device=device)
    with torch.inference_mode():
        _, cache = module(params, prompt, cache=cache, cache_index=0)
        fills = torch.tensor([prompt_len * f // 20 for f in (2, 11, 6, 19, 3, 8, 13, 5)],
                             dtype=torch.int32, device=device)
        rows = torch.arange(length, device=device)[None, :]
        kv_mask = rows < fills[:, None]
        tokens = torch.randint(1, cfg.vocab_size, (b, k + 1), generator=gen, device=device)

        def copy(c):
            return tuple(tuple(buf.clone() for buf in layer) for layer in c)

        def vis(last):
            return kv_mask | ((rows >= fills[:, None]) & (rows <= (fills + last)[:, None]))

        verify, _ = module(params, tokens, cache=copy(cache), cache_index=fills, kv_mask=vis(k))
        steps, c = [], copy(cache)
        for i in range(k + 1):
            logits, c = module(params, tokens[:, i:i + 1], cache=c, cache_index=fills + i,
                               kv_mask=vis(i))
            steps.append(logits[:, -1])
    return verify, torch.stack(steps, dim=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(300, 64), (4096, 4096), (4, 4096)])
def test_rms_norm_kernel_matches_plain_on_card(cuda, rows, d):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(rows, d, device=cuda, generator=gen).bfloat16()
    g = (1 + 0.1 * torch.randn(d, device=cuda, generator=gen)).bfloat16()
    before = tnorm.KERNEL.launches
    got = tnorm.fused_rms_norm(x, g, 1e-5)
    torch.cuda.synchronize()
    assert tnorm.KERNEL.launches == before + 1
    # <= 2 bf16 ulps: the same fp32 statistic in another summation order
    torch.testing.assert_close(got, tnorm.rms_norm_plain(x, g, 1e-5), rtol=1 / 64, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kvh,d,pads", [
    (2, 100, 4, 2, 64, [0, 37]),
    (4, 1024, 32, 8, 128, [0, 17, 333, 1000]),
])
def test_flash_kernel_matches_plain_on_card(cuda, b, s, h, kvh, d, pads):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, s, h, d, device=cuda, generator=gen).bfloat16()
    k = torch.randn(b, s, kvh, d, device=cuda, generator=gen).bfloat16()
    v = torch.randn(b, s, kvh, d, device=cuda, generator=gen).bfloat16()
    pad = torch.tensor(pads, dtype=torch.int32, device=cuda)
    got = tflash.flash_attention(q, k, v, causal=True, kv_valid_start=pad)
    torch.cuda.synchronize()
    want = tflash.flash_fwd_padded_plain(q, k, v, pad, causal=True, scale=d**-0.5)
    # bf16 P rounds at the kernel's running max, the plain version's row max
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    for row, p in enumerate(pads):
        assert not got[row, :p].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("form", ["bf16", "int8", "fp32-q"])
def test_paged_kernel_matches_plain_on_card(cuda, d, form):
    """Engine-shaped case: duplicate and trash entries, ragged lengths
    (block edges, several 32-row passes of a 48-row block), GQA 4."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, hq, hk, blk, n = 8, 16, 4, 48, 128
    lengths = torch.tensor([1, 47, 48, 49, 300, 500, 0, 1], dtype=torch.int32, device=cuda)
    width = -(-int(lengths.max()) // blk)
    perm = torch.randperm(n - 1, generator=gen, device=cuda)[: b * width] % (n - 1) + 1
    table = perm.reshape(b, width).int()
    cover = -(-lengths.long() // blk)
    table = torch.where(torch.arange(width, device=cuda)[None] < cover[:, None], table, 0).int()
    qdt = torch.float32 if form == "fp32-q" else torch.bfloat16
    q = torch.randn(b, hq, d, device=cuda, generator=gen).to(qdt)
    scales = {}
    if form == "int8":
        k = torch.randint(-127, 128, (n, blk, hk, d), device=cuda, generator=gen).to(torch.int8)
        v = torch.randint(-127, 128, (n, blk, hk, d), device=cuda, generator=gen).to(torch.int8)
        scales = {
            "k_scale": torch.rand(n, blk, hk, device=cuda, generator=gen) * 0.02 + 1e-3,
            "v_scale": torch.rand(n, blk, hk, device=cuda, generator=gen) * 0.02 + 1e-3,
        }
    else:
        k = torch.randn(n, blk, hk, d, device=cuda, generator=gen).bfloat16()
        v = torch.randn(n, blk, hk, d, device=cuda, generator=gen).bfloat16()
    before = tpaged.KERNEL.launches
    got = tpaged.paged_attention(q, k, v, table, lengths, **scales)
    torch.cuda.synchronize()
    assert tpaged.KERNEL.launches == before + 1
    want = tpaged.paged_attention_plain(q, k, v, table, lengths, **scales)
    live = lengths > 0
    # bf16 p is rounded before (kernel) or after (plain) normalisation
    torch.testing.assert_close(got[live].float(), want[live].float(), rtol=2e-2, atol=2e-2)
    assert not got[~live].any()
    # and each (row, q head) within chip_smoke's row limit of its own max
    # |plain|, which rejects the plain version with each row's last pool
    # block dropped
    smoke = _chip_smoke()
    fault = smoke.dropped_block_fault(q, k, v, table, lengths, **scales)
    smoke.check_paged_rows(f"paged d={d} {form}", got[live], want[live], fault[live])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("form", ["bf16", "int8", "fp32-q"])
@pytest.mark.parametrize("blk", [16, 48])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_paged_kernel_split_edges_on_card(cuda, d, form, blk, group):
    """The kernel's splits: lengths one row short of a split, on it and one
    past it, two splits and a few rows, a row that covers the whole table,
    lengths 0 and 1, GQA groups 1, 4 and 8, blocks of 16 and 48 rows. Row
    by row against the plain version (the dropped-block fault rejected);
    two runs give the same bits; the call makes the host wait for nothing
    (sync debug mode "error")."""
    smoke = _chip_smoke()
    split = tpaged.split_blocks(blk) * blk
    width = 3 * tpaged.split_blocks(blk) + 1          # a ragged last split
    lengths = [split - 1, split, split + 1, width * blk, 0, 1, 2 * split + 5, 17]
    b, hk = len(lengths), 2
    hq, n = hk * group, len(lengths) * width + 1
    gen = torch.Generator(device=cuda).manual_seed(7 * group + d)
    perm = torch.randperm(n - 1, generator=gen, device=cuda) + 1
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    cover = -(-lens.long() // blk)
    table = torch.where(torch.arange(width, device=cuda)[None] < cover[:, None],
                        perm.reshape(b, width), 0).int()
    qdt = torch.float32 if form == "fp32-q" else torch.bfloat16
    q = torch.randn(b, hq, d, device=cuda, generator=gen).to(qdt)
    scales = {}
    if form == "int8":
        k, v = (torch.randint(-127, 128, (n, blk, hk, d), device=cuda, generator=gen)
                .to(torch.int8) for _ in range(2))
        scales = {name: torch.rand(n, blk, hk, device=cuda, generator=gen) * 0.02 + 1e-3
                  for name in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn(n, blk, hk, d, device=cuda, generator=gen).bfloat16()
                for _ in range(2))
    before = tpaged.KERNEL.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tpaged.paged_attention(q, k, v, table, lens, **scales)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = tpaged.paged_attention(q, k, v, table, lens, **scales)
    torch.cuda.synchronize()
    assert tpaged.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    want = tpaged.paged_attention_plain(q, k, v, table, lens, **scales)
    fault = smoke.dropped_block_fault(q, k, v, table, lens, **scales)
    live = lens > 0
    smoke.check_paged_rows(f"paged d={d} {form} block={blk} G={group}", got[live], want[live],
                           fault[live])
    assert not got[~live].any()


@pytest.mark.cuda
def test_paged_engine_runs_the_kernel_and_matches_contiguous_on_card(cuda):
    """A small fp32-activation model (head_dim 64) on the card: the paged
    engine launches the kernel (fp32 queries) and gives the contiguous
    engine's greedy tokens."""
    cfg = LlamaConfig.tiny(vocab_size=512, hidden_dim=256, num_heads=4, num_kv_heads=2,
                           dtype="float32", norm_impl="fused")
    params = init_params(cfg, seed=0, device=cuda)
    prompts = [list(range(1, n + 1)) for n in (3, 17, 40)]
    outs = {}
    before = tpaged.KERNEL.launches
    for paged in (True, False):
        engine = DecodeEngine(Llama(cfg), paged=paged, slots=2, max_new_tokens=8,
                              prompt_buckets=(16, 64), chunk_steps=4, device=cuda)
        try:
            outs[paged] = engine.generate(params, prompts)
        finally:
            engine.close()
    assert tpaged.KERNEL.launches > before
    assert outs[True] == outs[False]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n,tile,group", [
    (1, 256, 512, 512, 0), (16, 4096, 1024, 512, 0), (40, 1024, 4096, 512, 0),
    (64, 256, 768, 256, 128), (16, 4096, 14336, 512, 128), (5, 96, 200, 200, 0),
    (3, 384, 640, 128, 0), (7, 256, 1536, 256, 256),
    # the int4 paged engine's g=128 projections of Llama-3-8B (q/o, k/v,
    # down) at one to 64 rows; a single-tile width, a 128-channel tile and
    # unaligned widths (the simple path) with group scales
    (1, 4096, 4096, 512, 128), (33, 4096, 1024, 512, 128), (64, 14336, 4096, 512, 128),
    (9, 512, 96, 96, 128), (24, 640, 1280, 128, 128), (5, 256, 200, 200, 128),
    (3, 384, 512, 512, 128), (2, 1024, 1536, 256, 512),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_kernel_matches_plain_on_card(cuda, rows, k, n, tile, group, dtype):
    """Aligned and unaligned widths (N/2 not a multiple of 16, K not of 8,
    a single 200-channel tile), one to 64 rows, per-channel and grouped,
    both compute dtypes; the first rows of a launch equal a smaller
    launch bit for bit (no reduction order depends on the row count); the
    grouped bf16 form also passes chip_smoke's bit check."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    packed = torch.randint(-128, 128, (k, n // 2), device=cuda, generator=gen, dtype=torch.int8)
    scale = torch.rand((k // group, n) if group else (n,), device=cuda, generator=gen) * 0.05
    x = torch.randn(rows, k, device=cuda, generator=gen).to(dtype)
    kernel = tint4.KERNEL_GROUPED if group else tint4.KERNEL
    before = kernel.launches
    got = tint4.int4_matmul_cuda(x, packed, scale, tile_n=tile, group_size=group)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.dtype == dtype
    want = tint4.int4_matmul_plain(x, packed, scale, tile_n=tile, dtype=dtype, group_size=group)
    # the same fp32 products in another summation order, then (bf16) one rounding
    tol = dict(rtol=1 / 64, atol=1e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, want, **tol)
    if group and dtype == torch.bfloat16:
        smoke = _chip_smoke()
        assert smoke.rounding_mismatch(got, want) <= smoke.INT4_MISMATCH_MAX
    head = tint4.int4_matmul_cuda(x[:1].contiguous(), packed, scale, tile_n=tile,
                                  group_size=group)
    assert torch.equal(head, got[:1])


def _chip_smoke():
    """The repository's chip_smoke module (its int4 bit check and planted
    K-split faults), imported from the repository root."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _int4_channel_inputs(cuda, rows, k, n, dtype, seed=0, group=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    packed = torch.randint(-128, 128, (k, n // 2), device=cuda, generator=gen, dtype=torch.int8)
    scale = torch.rand((k // group, n) if group else (n,), device=cuda, generator=gen) * 0.05
    x = torch.randn(rows, k, device=cuda, generator=gen).to(dtype)
    return x, packed, scale


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,tile,dtype,splits,group", [
    (4096, 1024, 512, torch.bfloat16, 8, 0),      # the k/v projection: the narrowest grid
    (14336, 4096, 512, torch.bfloat16, 8, 0),     # down: long K slices
    (4096, 14336, 512, torch.bfloat16, 2, 0),     # gate/up: the widest bf16 grid
    (4096, 2048, 256, torch.float32, 1, 0),       # the LM head's fp32 form at a reduced N
    # the int4 paged engine's g=128 shapes, and the grouped fp32 LM head
    (4096, 4096, 512, torch.bfloat16, 8, 128),
    (4096, 1024, 512, torch.bfloat16, 8, 128),
    (4096, 14336, 512, torch.bfloat16, 2, 128),
    (14336, 4096, 512, torch.bfloat16, 8, 128),
    (4096, 2048, 256, torch.float32, 1, 128),
])
def test_int4_channel_rows_are_bit_invariant_on_card(cuda, k, n, tile, dtype, splits, group):
    """Every row count 1..64 gives each row the bits it gets in a one-row
    launch and in the 64-row launch (the K split and every summation order
    follow (K, N) and the group alone; the wgmma width follows the row
    count), and a rerun gives the same bits; per-channel and g=128."""
    if dtype == torch.bfloat16:   # the fp32 form walks all of K in every CTA
        assert tint4._k_splits(k, n, group) == splits
    x, packed, scale = _int4_channel_inputs(cuda, 64, k, n, dtype, group=group)

    def run(rows):
        return tint4.int4_matmul_cuda(x[:rows].contiguous(), packed, scale, tile_n=tile,
                                      group_size=group)

    full = run(64)
    want = tint4.int4_matmul_plain(x, packed, scale, tile_n=tile, dtype=dtype, group_size=group)
    tol = dict(rtol=1 / 64, atol=1e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(full, want, **tol)
    singles = torch.cat([
        tint4.int4_matmul_cuda(x[r:r + 1].contiguous(), packed, scale, tile_n=tile,
                               group_size=group)
        for r in range(64)
    ])
    assert torch.equal(singles, full)
    for rows in range(1, 65):
        assert torch.equal(run(rows), full[:rows]), rows
    assert torch.equal(run(64), full)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_channel_dequantizes_every_byte_on_card(cuda, dtype):
    """Each packed column holds all 256 byte values down K; one-hot x rows
    pick one K row each, so every output is exactly nibble x scale,
    rounded once (both nibbles of every byte, through the K split)."""
    k, n, tile = 256, 1024, 512
    byte = (torch.arange(k)[:, None] + 37 * torch.arange(n // 2)[None, :]) % 256
    packed = torch.where(byte > 127, byte - 256, byte).to(torch.int8).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    scale = torch.rand(n, device=cuda, generator=gen) + 0.5
    nibbles = tint4.unpack_int4(packed, tile).float()
    for r0 in range(0, k, 64):
        x = torch.zeros(64, k, device=cuda)
        x[torch.arange(64), r0 + torch.arange(64)] = 1.0
        got = tint4.int4_matmul_cuda(x.to(dtype), packed, scale, tile_n=tile)
        assert torch.equal(got, (nibbles[r0:r0 + 64] * scale).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n,tile,x_off,w_off", [
    (5, 96, 200, 200, 0, 0),      # N/2 = 100: no 16-byte weight row stride
    (3, 98, 512, 512, 0, 0),      # 2K and 4K bytes not multiples of 16: no x row stride
    (40, 256, 1024, 512, 1, 0),   # x's base 2 or 4 bytes off 16
    (8, 256, 1024, 512, 0, 1),    # the weights' base one byte off
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_channel_simple_path_on_card(cuda, rows, k, n, tile, x_off, w_off, dtype):
    """Shapes and bases that TMA cannot read take the kernel's simple path
    (never the plain version), match the plain version, keep a row's bits
    at any row count, and the TMA path itself refuses them."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    wbuf = torch.randint(-128, 128, (k * n // 2 + w_off,), device=cuda, generator=gen,
                         dtype=torch.int8)
    packed = wbuf[w_off:].view(k, n // 2)
    scale = torch.rand(n, device=cuda, generator=gen) * 0.05
    xbuf = torch.randn(rows * k + x_off, device=cuda, generator=gen).to(dtype)
    x = xbuf[x_off:].view(rows, k)
    assert not tint4._tma_path(x, packed)
    before = tint4.KERNEL.launches
    got = tint4.int4_matmul_cuda(x, packed, scale, tile_n=tile)
    torch.cuda.synchronize()
    assert tint4.KERNEL.launches == before + 1
    want = tint4.int4_matmul_plain(x, packed, scale, tile_n=tile, dtype=dtype)
    tol = dict(rtol=1 / 64, atol=1e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, want, **tol)
    head = tint4.int4_matmul_cuda(x[:1].contiguous(), packed, scale, tile_n=tile)
    assert torch.equal(head, got[:1])
    out = torch.empty(rows, n, dtype=dtype, device=cuda)
    with pytest.raises(RuntimeError, match="failed to launch"):
        tint4.KERNEL(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), rows,
                     k, n, tile, 0, 1, int(dtype == torch.float32), 0,
                     torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024)])
def test_int4_channel_bit_check_rejects_planted_faults_on_card(cuda, k, n):
    """chip_smoke's per-channel bit check at the verify's 40 rows: the
    kernel passes it, and a kernel that dropped the last K-slice or summed
    the slices out of rank order in bf16 (emulated from the plain math)
    fails it."""
    smoke = _chip_smoke()
    x, packed, scale = _int4_channel_inputs(cuda, 40, k, n, torch.bfloat16, seed=3)
    scale = scale / (k ** 0.5)
    want = tint4.int4_matmul_plain(x, packed, scale, tile_n=512, dtype=torch.bfloat16)
    got = tint4.int4_matmul_cuda(x, packed, scale, tile_n=512)
    assert smoke.rounding_mismatch(got, want) <= smoke.INT4_MISMATCH_MAX
    for fault, bad in smoke.int4_slice_faults(x, packed, scale, 512).items():
        assert smoke.rounding_mismatch(bad, want) > smoke.INT4_MISMATCH_MAX, fault


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 512), (4096, 1024)])
def test_int4_grouped_bit_check_rejects_planted_faults_on_card(cuda, k, n):
    """chip_smoke's grouped bit check at the engine's 16 rows, g=128, at a
    K with 8 slices: the kernel passes it, and the three planted faults
    (the last group dropped, each slice's scale rows one group off, the
    slices rounded to bf16 and summed in reverse rank order), emulated
    from the plain math, fail it."""
    smoke = _chip_smoke()
    assert tint4._k_splits(k, n, 128) == 8
    x, packed, scale = _int4_channel_inputs(cuda, 16, k, n, torch.bfloat16, seed=3, group=128)
    scale = scale / (k ** 0.5)
    want = tint4.int4_matmul_plain(x, packed, scale, tile_n=512, dtype=torch.bfloat16,
                                   group_size=128)
    got = tint4.int4_matmul_cuda(x, packed, scale, tile_n=512, group_size=128)
    checks = {}
    smoke.int4_bit_check("grouped", got, want, checks)
    smoke.int4_fault_checks("grouped", smoke.int4_group_faults(x, packed, scale, 512, 128),
                            want, checks)
    assert len([key for key in checks if key.endswith("_passes_int4_tol")]) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n,tile,tma", [
    (16, 4096, 4096, 512, True),   # the engine's q/o: groups 0 and 1 in the first of 8 K-slices
    (1, 2048, 512, 512, True), (64, 2048, 512, 512, True),
    (5, 256, 200, 200, False),     # the simple path
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_grouped_rounding_point_on_card(cuda, rows, k, n, tile, tma, dtype):
    """chip_smoke's grouped rounding probe through the kernel: on inputs
    where every value but the group-scale rounding is exact, the kernel
    gives the plain version's bits on every output (multiply, then add),
    and the FMA fault does not."""
    smoke = _chip_smoke()
    if dtype == torch.bfloat16 and tma:
        assert tint4._k_slices(k, tint4._k_splits(k, n, 128), 128)[0][1] >= 256
    gen = torch.Generator(device=cuda).manual_seed(rows + k)
    x, packed, scale, want, fma = smoke.int4_rounding_probe(rows, k, n, tile, 128, dtype, gen)
    assert tint4._tma_path(x, packed, scale, tile, 128) == tma
    got = tint4.int4_matmul_cuda(x, packed, scale, tile_n=tile, group_size=128)
    smoke.int4_rounding_check("probe", got, want, fma)


@pytest.mark.cuda
def test_int4_routing_on_card(cuda):
    """Decode rows launch the kernel (never the plain version); prefill
    rows take the fallback; a CUDA call the kernel cannot take raises."""
    w = torch.randn(256, 512, device=cuda)
    packed, scale = tint4.quantize_kernel_int4(w, 512)
    before = tint4.KERNEL.launches
    tint4.int4_matmul(torch.randn(8, 256, device=cuda), packed, scale, tile_n=512)
    tint4.int4_matmul(torch.randn(65, 256, device=cuda), packed, scale, tile_n=512)
    assert tint4.KERNEL.launches == before + 1
    with pytest.raises(ValueError, match="rows"):
        tint4.int4_matmul_cuda(torch.randn(65, 256, device=cuda).bfloat16(), packed, scale,
                               tile_n=512)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tint4.int4_matmul_cuda(torch.randn(8, 256, device=cuda).half(), packed, scale,
                               tile_n=512)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 128])
def test_int4_engines_run_the_kernel_on_card(cuda, group):
    """An fp32-activation int4 model on the card: the paged engine and the
    speculative engine (self-draft) give the plain contiguous engine's
    greedy tokens, through the int4 kernel's fp32 form."""
    cfg = LlamaConfig.tiny(vocab_size=512, hidden_dim=256, num_heads=4, num_kv_heads=2,
                           mlp_dim=512, dtype="float32", quantized=True, weight_bits=4,
                           int4_group=group)
    fp = init_params(dataclasses.replace(cfg, quantized=False), seed=0, device=cuda)
    params = quantize_params(fp, LLAMA_QUANT_PATTERNS, bits=4, group_size=group)
    prompts = [list(range(1, n + 1)) for n in (3, 17, 40)]
    kernel = tint4.KERNEL_GROUPED if group else tint4.KERNEL
    before = kernel.launches
    kw = dict(slots=2, max_new_tokens=8, prompt_buckets=(16, 64), chunk_steps=4, device=cuda)
    outs = {}
    for name, extra in (("plain", {}), ("paged", dict(paged=True)),
                        ("spec", dict(draft_module=Llama(cfg), speculate_k=3))):
        engine = DecodeEngine(Llama(cfg), **kw, **extra)
        try:
            p = {"target": params, "draft": params} if name == "spec" else params
            outs[name] = engine.generate(p, prompts)
        finally:
            engine.close()
    assert kernel.launches > before
    assert outs["paged"] == outs["plain"] and outs["spec"] == outs["plain"]


def _max_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|: gradients hold many entries near 0
    next to large ones, so their bf16 rounding is judged against the
    tensor's scale."""
    scale = want.float().abs().max().clamp_min(1e-30)
    return float((got.float() - want.float()).abs().max() / scale)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype", [
    (12608, 768, torch.bfloat16), (37, 64, torch.float32), (300, 4096, torch.bfloat16),
    (5, 8192, torch.bfloat16),
])
@pytest.mark.parametrize("rms", [False, True])
def test_norm_kernels_match_plain_on_card(cuda, rows, d, dtype, rms):
    """Rows 2-5 at the ViT-B shape (12608 rows: 788 backward blocks, the
    last ragged), a narrow fp32 case and Llama widths: LayerNorm/RMS
    forward, add forward and the backward against their plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(rows, d, device=cuda, generator=gen).to(dtype)
    r = torch.randn(rows, d, device=cuda, generator=gen).to(dtype)
    dy = torch.randn(rows, d, device=cuda, generator=gen).to(dtype)
    g = 1 + 0.1 * torch.randn(d, device=cuda, generator=gen)
    b = None if rms else 0.1 * torch.randn(d, device=cuda, generator=gen)
    eps = 1e-6
    counts = [k.launches for k in (tnorm.KERNEL, tnorm.LN_KERNEL, tnorm.ADD_KERNEL,
                                   tnorm.BWD_KERNEL)]
    y = tnorm.norm_fwd_cuda(x, g, b, eps, rms)
    s, ys = tnorm.norm_add_fwd_cuda(x, r, g, b, eps, rms)
    dx, dg, db = tnorm.norm_bwd_cuda(s, g, dy, eps, rms, not rms)
    torch.cuda.synchronize()
    fwd_row = 0 if rms else 1
    after = [k.launches for k in (tnorm.KERNEL, tnorm.LN_KERNEL, tnorm.ADD_KERNEL,
                                  tnorm.BWD_KERNEL)]
    assert [a - c for a, c in zip(after, counts)] == [
        int(fwd_row == 0), int(fwd_row == 1), 1, 1]
    # <= 2 ulps of the output dtype: the same fp32 statistics summed in
    # another order
    tol = dict(rtol=1 / 64, atol=1e-3) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y, tnorm.norm_fwd_plain(x, g, b, eps, rms), **tol)
    ps, pys = tnorm.norm_add_fwd_plain(x, r, g, b, eps, rms)
    assert torch.equal(s, ps)   # one fp32 add, one rounding
    torch.testing.assert_close(ys, pys, **tol)
    pdx, pdg, pdb = tnorm.norm_bwd_plain(s, g, dy, eps, rms, not rms)
    assert _max_rel_err(dx, pdx) < (1e-2 if dtype == torch.bfloat16 else 1e-5)
    # fp32 column sums over all rows, in per-block order against torch's
    assert _max_rel_err(dg, pdg) < 1e-4
    if not rms:
        assert _max_rel_err(db, pdb) < 1e-4
    else:
        assert db is None


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 15, 16, 17, 12608])
@pytest.mark.parametrize("d", [768, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rms", [False, True])
def test_norm_backward_rows_and_columns_on_card(cuda, rows, d, dtype, rms):
    """Row 5 held as chip_smoke holds it: dx row by row, dgamma / dbeta
    column by column (and against the tensor's max), the three planted
    faults rejected at the ViT-B row count (a fault on one or two rows of
    random data can fall below the limit), the one-row fault also passing
    the whole-tensor check; a rerun gives the same bits; one launch a
    call."""
    smoke = _chip_smoke()
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x, dy = (torch.randn(rows, d, device=cuda, generator=gen).to(dtype) for _ in range(2))
    g = 1 + 0.1 * torch.randn(d, device=cuda, generator=gen)
    before = tnorm.BWD_KERNEL.launches
    got = tnorm.norm_bwd_cuda(x, g, dy, 1e-6, rms, not rms)
    again = tnorm.norm_bwd_cuda(x, g, dy, 1e-6, rms, not rms)
    torch.cuda.synchronize()
    assert tnorm.BWD_KERNEL.launches == before + 2
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    names = ("dx", "dgamma", "dbeta")
    want = dict(zip(names, tnorm.norm_bwd_plain(x, g, dy, 1e-6, rms, not rms)))
    faults = smoke.norm_bwd_faults(x, g, dy, 1e-6, rms, not rms) if rows > 1000 else {}
    checks = smoke.check_norm_bwd(f"norm_bwd rows={rows} d={d} {dtype} rms={rms}",
                                  dict(zip(names, got)), want, faults)
    if faults:   # the one-row fault is seen by the row check alone
        assert checks["fault_c2_dropped_one_row"]["passes_scaled_check"]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 15, 16, 17, 4096, 12608])
@pytest.mark.parametrize("d", [64, 768, 4096, 8192])
@pytest.mark.parametrize("dtype,gdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32),
])
@pytest.mark.parametrize("mode", ["rms", "layer_norm", "add"])
def test_norm_forward_bits_rows_and_faults_on_card(cuda, rows, d, dtype, gdtype, mode):
    """Rows 2-4 held as chip_smoke holds them (``norm_fwd_cases``): bf16
    outputs within NORM_FWD_MISMATCH_MAX of the plain version's bits,
    every row within NORM_FWD_ROW_LIMIT, on random inputs and on the
    statistics probe; every planted fault rejected on one of the two; a
    row's bits the same alone, in a 16-row call and in the full call, and
    on a rerun; one launch a call, on the mode's counter only."""
    smoke = _chip_smoke()
    rms, add = mode == "rms", mode == "add"
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    g = (1 + 0.1 * torch.randn(d, device=cuda, generator=gen)).to(gdtype)
    b = None if rms else (0.1 * torch.randn(d, device=cuda, generator=gen)).to(gdtype)
    counters = (tnorm.KERNEL, tnorm.LN_KERNEL, tnorm.ADD_KERNEL)
    mine = counters[2 if add else int(not rms)]
    calls = []

    def fwd(x, r):
        calls.append(1)
        if r is None:
            return {"y": tnorm.norm_fwd_cuda(x, g, b, 1e-6, rms)}
        return dict(zip(("s", "y"), tnorm.norm_add_fwd_cuda(x, r, g, b, 1e-6, rms)))

    before = [k.launches for k in counters]
    smoke.norm_fwd_cases(f"norm_fwd {mode} x[{rows},{d}] {dtype} g {gdtype}", fwd, rows, d,
                         dtype, g, b, 1e-6, rms, add, gen)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(counters, before)] == [
        len(calls) if k is mine else 0 for k in counters]


@pytest.mark.cuda
def test_norm_forward_widths_and_refusals_on_card(cuda):
    """Every width the port's models and tests use is taken (64, 128, 768,
    4096, 8192, and the 2048-vector limit); wider rows, widths that are not
    whole 16-byte vectors and x not 16-byte aligned are refused; gamma and
    beta at any alignment are taken."""
    for d, dtype in ((64, torch.bfloat16), (128, torch.bfloat16), (768, torch.bfloat16),
                     (4096, torch.bfloat16), (8192, torch.bfloat16), (16384, torch.bfloat16),
                     (8192, torch.float32)):
        x = torch.randn(3, d, device=cuda).to(dtype)
        g = torch.randn(d, device=cuda)
        y = tnorm.norm_fwd_cuda(x, g, None, 1e-6, True)
        assert torch.equal(y, tnorm.norm_fwd_cuda(x, g, None, 1e-6, True))
        torch.testing.assert_close(y, tnorm.norm_fwd_plain(x, g, None, 1e-6, True),
                                   **(dict(rtol=1 / 64, atol=1e-3) if dtype == torch.bfloat16
                                      else dict(rtol=1e-5, atol=1e-5)))
    g = torch.randn(16392, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        tnorm.norm_fwd_cuda(torch.randn(2, 16392, device=cuda).bfloat16(), g, None, 1e-6, True)
    with pytest.raises(ValueError, match="multiple of"):
        tnorm.norm_fwd_cuda(torch.randn(2, 100, device=cuda).bfloat16(), g[:100], None, 1e-6,
                            True)
    flat = torch.randn(2 * 768 + 1, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="aligned"):
        tnorm.norm_fwd_cuda(flat[1:].view(2, 768), g[:768], None, 1e-6, True)
    with pytest.raises(ValueError, match="aligned"):
        x = torch.randn(2, 768, device=cuda).bfloat16()
        tnorm.norm_add_fwd_cuda(x, flat[1:].view(2, 768), g[:768], None, 1e-6, True)
    x = torch.randn(5, 768, device=cuda).bfloat16()
    params = torch.randn(2 * 768 + 1, device=cuda)
    g1, b1 = params[1:769], params[769:]   # 4-byte aligned views
    torch.testing.assert_close(tnorm.norm_fwd_cuda(x, g1, b1, 1e-6, False),
                               tnorm.norm_fwd_plain(x, g1, b1, 1e-6, False),
                               rtol=1 / 64, atol=1e-3)


def _max_row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows (the last dim) of |got - want| over the row's max
    |want|: under causal attention a row's scale falls with the positions
    it averages, so each row is judged against its own, floored at 1e-3 of
    the tensor's max (a row that is 0 in exact arithmetic, such as dq of a
    query that sees one key, holds fp32 residues)."""
    err = (got.float() - want.float()).abs().amax(dim=-1)
    scale = want.float().abs().amax(dim=-1)
    scale = scale.clamp_min(1e-3 * float(scale.max())).clamp_min(1e-30)
    return float((err / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [
    (64, 197, 12, 64), (2, 17, 4, 64), (2, 512, 12, 64), (1, 1024, 12, 64), (2, 130, 4, 128),
    # one row, and each side of the 64-row tile and the 256-key row edges
    *[(2, s, 3, d) for d in (64, 128) for s in (1, 63, 64, 65, 255, 256, 257)],
    # the forward's resident forms (1-4 key chunks at head_dim 64)
    *[(2, s, 3, 64) for s in (128, 129, 192, 193)],
])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_kernels_match_plain_on_card(cuda, b, s, h, d, causal):
    """Rows 12-13 at the ViT-B shape, BERT's 512, the 1024 limit, ragged
    lengths at the tile edges and head_dim 128: forward and backward
    against their plain versions, row by row; the forward and the backward
    each give the same bits twice."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(b, s, h, d, device=cuda, generator=gen).bfloat16()
                   for _ in range(4))
    q = q * float(torch.tensor(d ** -0.5 * tfused.LOG2E, dtype=torch.bfloat16))
    before = (tfused.FWD_KERNEL.launches, tfused.BWD_KERNEL.launches)
    o = tfused.fused_attention_fwd_cuda(q, k, v, causal=causal)
    o_again = tfused.fused_attention_fwd_cuda(q, k, v, causal=causal)
    grads = tfused.fused_attention_bwd_cuda(q, k, v, do, o, causal=causal)
    again = tfused.fused_attention_bwd_cuda(q, k, v, do, o, causal=causal)
    torch.cuda.synchronize()
    assert (tfused.FWD_KERNEL.launches, tfused.BWD_KERNEL.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(o, o_again)
    # the same rounding points; bf16 outputs and fp32 sums in another order
    # (query rows of o and dq, key rows of dk and dv)
    assert _max_row_rel_err(o, tfused.fused_attention_fwd_plain(q, k, v, causal=causal)) < 1e-2
    want = tfused.fused_attention_bwd_plain(q, k, v, do, o, causal=causal)
    for name, got, ref, same in zip(("dq", "dk", "dv"), grads, want, again):
        assert torch.isfinite(got.float()).all()
        if s == 1 and name != "dv":
            # one key: ds = p (dp - delta) is 0 in exact arithmetic (delta =
            # do . o = do . v = dp), so both sides hold fp32 cancellation
            # residues only, far below dv's scale
            assert float(got.float().abs().max()) < 1e-3 * float(want[2].float().abs().max())
        else:
            assert _max_row_rel_err(got, ref) < 2e-2
        assert torch.equal(got, same)


@pytest.mark.cuda
def test_fused_attention_kernels_refuse_misaligned_bases_on_card(cuda):
    """The kernels read and write through TMA: a contiguous view off a
    16-byte boundary is refused before any launch."""
    q = torch.randn(2, 65, 3, 64, device=cuda).bfloat16()
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    off = buf[1:].view(q.shape)
    before = (tfused.FWD_KERNEL.launches, tfused.BWD_KERNEL.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfused.fused_attention_fwd_cuda(off, q, q, causal=False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfused.fused_attention_bwd_cuda(q, q, q, off, q, causal=False)
    assert (tfused.FWD_KERNEL.launches, tfused.BWD_KERNEL.launches) == before


@pytest.mark.cuda
def test_fused_attention_op_gradients_on_card(cuda):
    """The differentiable op on the card (GQA, causal) against autograd
    through the plain forward on fp32 copies of the same inputs."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 197, 8, 64, device=cuda, generator=gen).bfloat16().requires_grad_()
    k = torch.randn(2, 197, 2, 64, device=cuda, generator=gen).bfloat16().requires_grad_()
    v = torch.randn(2, 197, 2, 64, device=cuda, generator=gen).bfloat16().requires_grad_()
    out = tfused.fused_attention(q, k, v, causal=True)
    (out.float() ** 2).sum().backward()
    refs = [t.detach().float().requires_grad_() for t in (q, k, v)]
    from unionml_tpu_torch.ops.attention import mha_reference

    (mha_reference(*refs, causal=True) ** 2).sum().backward()
    for t, ref in zip((q, k, v), refs):
        assert _max_rel_err(t.grad, ref.grad) < 3e-2
    with pytest.raises(ValueError, match="bf16"):
        tfused.fused_attention_fwd_cuda(*(t.detach().float() for t in (q, q, q)), causal=False)


def _flash_inputs(cuda, b, sq, skv, h, kvh, d, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, sq, h, d, device=cuda, generator=gen).bfloat16()
    k = torch.randn(b, skv, kvh, d, device=cuda, generator=gen).bfloat16()
    v = torch.randn(b, skv, kvh, d, device=cuda, generator=gen).bfloat16()
    do = torch.randn(b, sq, h, d, device=cuda, generator=gen).bfloat16()
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal", [
    (2, 4095, 4095, 12, 4, 64, True),     # the llama_lc training shape
    (1, 2048, 2048, 32, 8, 128, True),    # the Llama-3-8B head geometry
    (2, 200, 200, 4, 2, 64, False),
    (2, 40, 200, 4, 2, 64, True),         # cross-length, bottom-right aligned
    (2, 200, 40, 4, 4, 128, True),        # q_len > kv_len: rows that see nothing
    (1, 17, 17, 2, 1, 64, True),
])
def test_flash_train_kernels_match_plain_on_card(cuda, b, sq, skv, h, kvh, d, causal):
    """Rows 9-11: the lse forward, the dq and the dk/dv kernels against
    their plain versions on the same inputs (the backward on the kernel's
    own out and lse); the backward gives the same bits twice."""
    q, k, v, do = _flash_inputs(cuda, b, sq, skv, h, kvh, d)
    scale = d ** -0.5
    kernels = (tflash.FWD_KERNEL, tflash.DQ_KERNEL, tflash.DKV_KERNEL)
    before = [kern.launches for kern in kernels]
    out, lse = tflash.flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
    grads = tflash.flash_bwd_cuda(q, k, v, do, out, lse, causal=causal, scale=scale)
    again = tflash.flash_bwd_cuda(q, k, v, do, out, lse, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert [kern.launches - n for kern, n in zip(kernels, before)] == [1, 2, 2]
    want_out, want_lse = tflash.flash_fwd_plain(q, k, v, causal=causal, scale=scale)
    # bf16 P rounds at the kernel's running max, the plain version's row
    # max: ~2.5 bf16 ulps of each query row's largest entry
    assert _max_row_rel_err(out, want_out) < 2e-2
    # fp32 statistics, exp and sums in another order
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    want = tflash.flash_bwd_plain(q, k, v, do, out, lse, causal=causal, scale=scale)
    for got, ref, same in zip(grads, want, again):
        assert torch.isfinite(got.float()).all()
        # the same rounding points; bf16 outputs and fp32 sums in another
        # order (query rows of dq, key rows of dk and dv)
        assert _max_row_rel_err(got, ref) < 2e-2
        assert torch.equal(got, same)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal", [
    (1, 4095, 4095, 8, 1, 64, True),      # S = 4095, GQA group 8
    (2, 300, 300, 6, 2, 128, True),       # group 3, head_dim 128
    (2, 127, 127, 4, 2, 128, True),       # around the CTA tiles: 128 rows at
    (2, 128, 128, 4, 2, 128, True),       # head_dim 128, 192 at 64
    (2, 129, 129, 4, 4, 128, True),
    (2, 191, 191, 4, 2, 64, True),
    (2, 192, 192, 4, 2, 64, True),
    (2, 193, 193, 4, 4, 64, True),
    (2, 300, 40, 4, 2, 64, True),         # q_len > kv_len: rows that see nothing
    (2, 40, 300, 6, 2, 128, True),        # cross-length, bottom-right
    (2, 1, 300, 4, 2, 64, True),          # one query
    (2, 1, 300, 4, 1, 128, False),
    (2, 300, 200, 4, 1, 64, False),       # non-causal
])
def test_flash_backward_kernel_edges_on_card(cuda, b, sq, skv, h, kvh, d, causal):
    """The dq and dk/dv kernels (rows 10-11) at their tile edges against
    the plain backward (on the kernel forward's own out and lse): ragged
    ends around the CTA tiles (128 rows at head_dim 128, 192 at 64) and
    the 64-row steps, GQA groups of
    1, 2, 3 and 8, head_dim 64 and 128, rows that see nothing, one query,
    cross-length and non-causal; row by row, one launch of each kernel per
    backward, and a second backward giving the same bits."""
    q, k, v, do = _flash_inputs(cuda, b, sq, skv, h, kvh, d, seed=4)
    scale = d ** -0.5
    out, lse = tflash.flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
    before = (tflash.DQ_KERNEL.launches, tflash.DKV_KERNEL.launches)
    grads = tflash.flash_bwd_cuda(q, k, v, do, out, lse, causal=causal, scale=scale)
    again = tflash.flash_bwd_cuda(q, k, v, do, out, lse, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert (tflash.DQ_KERNEL.launches, tflash.DKV_KERNEL.launches) == (
        before[0] + 2, before[1] + 2)
    want = tflash.flash_bwd_plain(q, k, v, do, out, lse, causal=causal, scale=scale)
    for got, ref, same in zip(grads, want, again):
        assert got.shape == ref.shape and torch.isfinite(got.float()).all()
        # the same rounding points; bf16 outputs and fp32 sums in another
        # order (query rows of dq, key rows of dk and dv)
        assert _max_row_rel_err(got, ref) < 2e-2
        assert torch.equal(got, same)
    if causal and sq > skv:  # the first sq - skv queries see no key
        assert not grads[0][:, :sq - skv].any()


@pytest.mark.cuda
def test_flash_backward_kernels_refuse_misaligned_bases_on_card(cuda):
    """The backward kernels read and write through TMA: a contiguous view
    off a 16-byte boundary is refused before any launch."""
    q, k, v, do = _flash_inputs(cuda, 2, 65, 65, 4, 2, 64, seed=5)
    out, lse = tflash.flash_fwd_cuda(q, k, v, causal=True, scale=0.125)
    delta = tflash.flash_delta(do, out)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    off = buf[1:].view(q.shape)
    off.copy_(do)
    kbuf = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)
    koff = kbuf[1:].view(k.shape)
    koff.copy_(k)
    before = (tflash.DQ_KERNEL.launches, tflash.DKV_KERNEL.launches)
    kw = dict(causal=True, scale=0.125)
    for args in ((q, k, v, off), (off, k, v, do), (q, koff, v, do), (q, k, koff, do)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tflash.flash_bwd_dq_cuda(*args, lse, delta, **kw)
        with pytest.raises(ValueError, match="16-byte aligned"):
            tflash.flash_bwd_dkv_cuda(*args, lse, delta, **kw)
    assert (tflash.DQ_KERNEL.launches, tflash.DKV_KERNEL.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,pads", [
    (1, 4095, 4095, 8, 1, 64, True, None),                # S = 4095, GQA group 8
    (2, 300, 300, 6, 2, 128, True, None),                 # group 3, head_dim 128
    (2, 129, 129, 4, 4, 64, True, None),                  # group 1, one row past a tile
    (4, 300, 300, 8, 1, 128, True, [63, 64, 65, 299]),    # pads at a tile edge and S - 1
    (3, 129, 129, 6, 2, 64, True, [63, 64, 128]),
    (2, 300, 300, 4, 4, 64, False, [0, 65]),
    (2, 40, 200, 6, 2, 64, True, None),                   # cross-length, bottom-right
    (2, 40, 200, 8, 1, 128, False, None),
    (1, 17, 4095, 2, 1, 64, False, None),                 # one busy warpgroup, 32 tiles
])
def test_flash_forward_kernel_edges_on_card(cuda, b, sq, skv, h, kvh, d, causal, pads):
    """The forward kernel (rows 1 and 9) at its tile edges against the
    plain versions: ragged sequence ends, left pads around a 64-row edge
    and at S - 1, head_dim 64 and 128, GQA groups of 1, 3 and 8,
    cross-length causal and non-causal; lse within its tolerance, padded
    query rows zero, and a second run giving the same bits."""
    q, k, v, _ = _flash_inputs(cuda, b, sq, skv, h, kvh, d, seed=2)
    scale = d ** -0.5
    kern = tflash.FWD_KERNEL if pads is None else tflash.KERNEL
    before = kern.launches
    if pads is None:
        def run():
            return tflash.flash_fwd_cuda(q, k, v, causal=causal, scale=scale)

        (out, lse), (again, lse_again) = run(), run()
        torch.cuda.synchronize()
        want, want_lse = tflash.flash_fwd_plain(q, k, v, causal=causal, scale=scale)
        # fp32 statistics, exp and sums in another order
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
        assert torch.equal(lse, lse_again)
    else:
        pad = torch.tensor(pads, dtype=torch.int32, device=cuda)

        def run():
            return tflash.flash_fwd_padded_cuda(q, k, v, pad, causal=causal, scale=scale)

        out, again = run(), run()
        torch.cuda.synchronize()
        want = tflash.flash_fwd_padded_plain(q, k, v, pad, causal=causal, scale=scale)
        if causal:  # query rows inside the padding see nothing
            for row, p in enumerate(pads):
                assert not out[row, :p].any()
    assert kern.launches == before + 2
    assert torch.isfinite(out.float()).all()
    # bf16 P rounds at the kernel's running max, the plain version's row
    # max: ~2.5 bf16 ulps of each query row's largest entry
    assert _max_row_rel_err(out, want) < 2e-2
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_flash_padded_path_is_forward_only_on_card(cuda):
    """With ``kv_valid_start`` on the card: inputs that require grad give
    the same values as without grad, and a backward raises."""
    q, k, v, _ = _flash_inputs(cuda, 2, 100, 100, 4, 2, 64, seed=3)
    pad = torch.tensor([0, 37], dtype=torch.int32, device=cuda)
    want = tflash.flash_attention(q, k, v, causal=True, kv_valid_start=pad)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    got = tflash.flash_attention(qg, kg, vg, causal=True, kv_valid_start=pad)
    assert torch.equal(got.detach(), want)
    with pytest.raises(RuntimeError, match="forward-only"):
        got.float().sum().backward()
    with torch.inference_mode():  # the serving path: the direct call
        out = tflash.flash_attention(qg, kg, vg, causal=True, kv_valid_start=pad)
    assert out.grad_fn is None and torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_verify_rows_match_one_token_steps_on_card(cuda, kv_quant):
    """On the card a batched GEMM picks its algorithm by shape: a
    speculative verify over 8 slots must still give, row for row, the bits
    of the one-token decode steps of the same tokens, so self-speculation
    accepts everything. The int4 serving form at Llama-3-8B head geometry
    (two layers): the int4 kernel and the fused RMSNorm give a row the same
    bits at any row count, so the attention is what this holds."""
    cfg = LlamaConfig.tiny(vocab_size=4096, hidden_dim=4096, num_heads=32, num_kv_heads=8,
                           mlp_dim=1024, max_len=512, kv_quant=kv_quant, quantized=True,
                           weight_bits=4, norm_impl="fused")
    fp = init_params(dataclasses.replace(cfg, quantized=False), seed=0, device=cuda)
    params = quantize_params(fp, LLAMA_QUANT_PATTERNS, bits=4)

    def int8_sites(tree):
        return sum(int8_sites(v) for v in tree.values()) + ("kernel_q" in tree) \
            if isinstance(tree, dict) else 0

    assert int8_sites(params) == 0   # every projection and the LM head in int4
    verify, steps = _verify_and_steps(cfg, params, cuda, prompt_len=376)
    assert torch.equal(verify, steps)


@pytest.mark.cuda
def test_flash_op_gradients_on_card(cuda):
    """The differentiable op on the card (GQA, causal, ragged) against
    autograd through the fp32 reference attention on fp32 copies; a dtype,
    a head_dim or a base address the kernels do not take raises."""
    q, k, v, do = _flash_inputs(cuda, 2, 300, 300, 8, 2, 64, seed=1)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tflash.flash_attention(q, k, v, causal=True)
    out.backward(do)
    refs = [t.detach().float().requires_grad_() for t in (q, k, v)]
    from unionml_tpu_torch.ops.attention import mha_reference

    mha_reference(*refs, causal=True).backward(do.float())
    for t, ref in zip((q, k, v), refs):
        assert _max_rel_err(t.grad, ref.grad) < 3e-2
    with pytest.raises(ValueError, match="bf16"):
        tflash.flash_attention(*(t.detach().float() for t in (q, k, v)), causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_fwd_cuda(*(t[..., :32].contiguous().detach() for t in (q, k, v)),
                              causal=True, scale=1.0)
    # the forward reads through TMA: a contiguous view off a 16-byte boundary
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash.flash_fwd_cuda(buf[1:].view(q.shape), k.detach(), v.detach(), causal=True,
                              scale=1.0)


@pytest.mark.cuda
def test_llama_flash_training_step_on_card(cuda):
    """Two lm_steps of a small bf16 Llama with attn_impl="flash" on the
    card: every layer launches rows 9, 10 and 11 once a step, the loss is
    finite, and remat gives the same loss (the forward runs twice)."""
    from unionml_tpu_torch.models import create_train_state, lm_step

    cfg = LlamaConfig.tiny(vocab_size=512, hidden_dim=256, num_heads=4, num_kv_heads=2,
                           max_len=512, attn_impl="flash")
    tokens = torch.randint(0, 512, (2, 301), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    kernels = (tflash.FWD_KERNEL, tflash.DQ_KERNEL, tflash.DKV_KERNEL)
    losses = {}
    for remat in (False, True):
        module = Llama(dataclasses.replace(cfg, remat=remat))
        state = create_train_state(module, tokens[:1, :8])
        step = lm_step(module)
        before = [kern.launches for kern in kernels]
        state, metrics = step(state, tokens)
        torch.cuda.synchronize()
        per_step = [kern.launches - n for kern, n in zip(kernels, before)]
        layers = cfg.num_layers
        assert per_step == [layers * (2 if remat else 1), layers, layers]
        losses[remat] = float(metrics["loss"])
    assert all(map(lambda x: x == x, losses.values()))
    assert losses[True] == losses[False]
