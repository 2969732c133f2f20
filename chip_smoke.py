#!/usr/bin/env python3
"""Drive the PyTorch port (unionml_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--layers 32] [--max-new-tokens 32]

Phases, each of which fails the run with a non-zero exit:

1. card    — print the card's name and power limit (nvidia-smi);
2. build   — build every CUDA kernel under unionml_tpu_torch/csrc/ with
             nvcc (one process per source, in parallel) into build/kernels/;
3. kernels — run each kernel's wrapper at the main path's shapes, hold it
             against its plain PyTorch version on the same inputs within
             the stated tolerance, and time kernel, plain version, the
             card's least possible time for the same work (bound) and one
             PyTorch library call computing the same function (yardstick
             only; the port never calls it); check that waiting on a CUDA
             event lets other Python threads run (the engine's harvester
             waits so while its dispatcher launches); row 1 (the padded
             prefill) also row by row against a skipped left-pad start
             tile; row 6 (paged decode, bf16 and int8 pools) also row by
             row against a planted dropped-block fault and timed cold,
             each call on its own copy of the pools; rows 7 and 8 (int4,
             per-channel and g=128) bit for bit against planted faults of
             each scale form, timed cold; rows 2-4 (the norm forward:
             RMSNorm at 4096 x 4096, 4 x 4096 and the paged engine's
             16 x 4096, LayerNorm and add-LayerNorm at ViT-B/16's
             12608 x 768) bit for bit and row by row, on random inputs and
             on a statistics probe, against four planted faults, a row's
             bits the same alone, in 16 rows and in the full call; the ViT
             rows (LayerNorm,
             add-LayerNorm and norm backward at ViT-B/16's 12608 x 768,
             the backward row by row and column by column against three
             planted faults and run twice for the same bits; fused
             attention forward and backward at S = 197, 512 and 1024; the
             backward run twice for the same bits);
3b. vit    — train ViT-B/16 (bf16 compute, fp32 params, fused attention and
             fused norms) through the ported vision_tpu template's
             model.train at batch 64 for 54 steps (2 warm-up): samples/s,
             step ms, the trainer's samples/sec gauge, peak memory, the
             loss falling, each ViT kernel's launches per step; then one
             step's loss and gradients against the plain path (per-tensor
             cosine) and two 3-step runs from one state (the same loss
             bits);
3c. llama — rows 9-11 (the flash-attention training forward with its
             logsumexp, the dq and the dk/dv backward kernels) at the
             llama_lc shape (q[2,4095,12,64], kv[2,4095,4,64], causal), at
             the Llama-3-8B head geometry and at small non-causal and
             cross-length shapes, each against its plain version, the
             backward twice (the same bits); then the long-context Llama of
             benchmarks/train_throughput.py (12 x 768, 125M params, flash
             attention) trained through an LM app's model.train
             (@model.train_step -> lm_step) at batch 2 x 4096 tokens for 54
             steps: tokens/s, step ms, the trainer's gauge, peak memory,
             the loss falling, rows 9/10/11 launched 12/12/12 times a step;
             then, at 2 layers and full width, one step's loss and gradients
             against the plain path (per-tensor cosine) and two 3-step runs
             from one state (the same loss bits);
4. serve   — build the ported llm_serving template at Llama-3-8B width
             (int8 weights, padded flash prefill, fused RMSNorm; random
             weights from a seeded torch.Generator on the card), check its
             kernel path against the plain-PyTorch path
             on a small input, serve it through ServingApp(batch=True,
             row_lists=True) on a local port, POST ragged /predict requests
             (some concurrent), check every reply and /health, and check
             that both kernels launched during the requests;
5. engine  — the same template at all --layers behind the block-paged
             DecodeEngine (16 slots, paged attention kernel) and
             ServingApp(batch=False): check the paged decode step's logits
             against the contiguous plain path, POST 24 ragged prompts in
             staggered concurrent waves (requests join mid-decode) and one
             /predict/stream, check every reply, /health and that the
             pool's blocks in use are back at 0 in /metrics, check that
             the paged, flash and norm kernels launched during the
             requests and that no operation made the host wait for the
             card meanwhile (torch.cuda.set_sync_debug_mode), and count the requests whose tokens equal a
             contiguous engine's (printed; bf16 near-ties may flip);
6. int8 kv — a 4-layer paged engine with kv_quant=True serves a few
             requests through the kernel's int8 form;
7. fp32    — an 8-layer fp32-activation model: a paged engine (the kernel
             with fp32 queries) and a contiguous engine must give the same
             tokens (at most one flip in 12 requests);
8. int4    — packed-int4 weights (random, made on the card from a seeded
             generator) at all --layers: the paged engine phase of 5. with
             group-wise scales (g=128, the grouped int4 kernel at every
             decode-step projection and the LM head, launch count checked
             against the steps taken, decode-step logits against the plain
             int4 path); then the speculative engine (per-channel int4
             target, the 0.3B int8 draft, 8 slots, k=4) behind
             ServingApp(batch=False): every reply, no host waits, the
             verify's 40 rows through the per-channel kernel, acceptance,
             and self-speculation accepting >= 99%; then fp32 parity at 8
             layers: int4 paged vs contiguous, speculative (draft and self)
             vs plain (at most one flip in 12 requests); last, every int4
             launch shape these phases gave the kernel is run again on
             random inputs and held against the plain version (grouped
             bf16 also bit for bit);
9. report  — one JSON line of per-kernel numbers, the nvidia-smi line, and
             last the result line {"ok": true, "device": {...}}.

It needs the repository beside it and a CUDA device; it imports nothing of
JAX or of the unionml_tpu package.
"""

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_OPS_S = 989e12
PEAK_FP32_OPS_S = 67e12

NORM_TOL = dict(rtol=1 / 64, atol=1e-3)   # <= 2 bf16 ulps: same fp32 statistic, other sum order
FLASH_TOL = dict(rtol=2e-2, atol=2e-2)    # bf16 P rounded at the running (kernel) vs row (plain) max
PAGED_TOL = dict(rtol=2e-2, atol=2e-2)    # bf16 p rounded before (kernel) vs after (plain) normalising
INT4_TOL = {                              # the same fp32 products in another summation order:
    torch.bfloat16: dict(rtol=1 / 64, atol=1e-2),   # <= 2 bf16 ulps after the one final rounding
    torch.float32: dict(rtol=1e-4, atol=1e-4),      # fp32 FMA (kernel) vs fp32 GEMM (plain), no TF32
}
INT4_MISMATCH_MAX = 0.02                  # bf16, both scale forms: share of outputs rounding apart
LOGIT_COSINE_MIN = 0.99                   # 8B kernel path vs plain path, bf16 through every layer
SPEC_SELF_ACCEPT_MIN = 0.99               # self-speculation: draft == target

# the engine phase's serving configuration
ENGINE_BUCKETS = (64, 256, 1024)
ENGINE_NEW_TOKENS = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. The
    card first spins (``torch.cuda._sleep``, about 1 ms a call) while the
    host enqueues the calls, so a wrapper's host cost does not show up as
    device time for a kernel shorter than its launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6) * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


L2_BYTES = 50e6                           # the H100's L2


def cold_copies(t: torch.Tensor, nbytes: float = None) -> list:
    """``t`` and as many copies as make one pass over them read more than
    twice the L2, so a call that rotates over them finds its copy cold.
    ``nbytes`` is what one call reads of its copy (default: all of ``t``;
    a paged call reads only the visible rows of its pools)."""
    count = int(2 * L2_BYTES // (nbytes or t.numel() * t.element_size())) + 1
    return [t] + [t.clone() for _ in range(count - 1)]


def time_ms_cold(fns: list, iters: int = 20) -> float:
    """Mean device time of one call, the calls rotating over ``fns`` (each
    on its own copy of the weights, from :func:`cold_copies`): at least
    ``iters`` calls and at least two full rotations."""
    calls = max(iters, 2 * len(fns))
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6) * calls)
    start.record()
    for i in range(calls):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got.float() - want.float()).abs()
    limit = tol["atol"] + tol["rtol"] * want.float().abs()
    if bool((err > limit).any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs err "
            f"{err.max().item()} beyond atol {tol['atol']} + rtol {tol['rtol']}"
        )
    return float(err.max().item())


# --------------------------------------------------------------------- #
# kernel phase
# --------------------------------------------------------------------- #


def norm_case(rows: int, d: int, gen: torch.Generator) -> dict:
    """Row 2 (RMSNorm, bf16 x and gamma, eps 1e-5) at one shape: the
    checks of :func:`norm_fwd_cases` (bit for bit, row by row, the
    statistics probe, the planted faults, a row's bits independent of the
    call), then timed beside its bound and ``F.rms_norm``."""
    import torch.nn.functional as F

    from unionml_tpu_torch.ops import fused_norm

    eps = 1e-5
    g = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).bfloat16()
    name = f"rms_norm rows={rows}"
    case = norm_fwd_cases(name, lambda x, r: {"y": fused_norm.rms_norm_cuda(x, g, eps)},
                          rows, d, torch.bfloat16, g, None, eps, True, False, gen)
    log_norm_fwd_checks(name, case["checks"])
    x, _ = case["inputs"]
    err = check_close(name, case["got"]["y"], fused_norm.rms_norm_plain(x, g, eps), NORM_TOL)
    b_ms, b_by = bound(2 * rows * d * 2 + d * 2, 4 * rows * d, PEAK_FP32_OPS_S)
    return {
        "shape": f"x[{rows},{d}] bf16, g[{d}] bf16",
        "max_abs_err": err, "checks": case["checks"], "rows_invariant": True,
        "ms": time_ms(lambda: fused_norm.rms_norm_cuda(x, g, eps)),
        "plain_ms": time_ms(lambda: fused_norm.rms_norm_plain(x, g, eps)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.rms_norm(x, (d,), weight=g, eps=eps)),
    }


def flash_case(b: int, s: int, h: int, kvh: int, d: int, pads, gen) -> dict:
    import torch.nn.functional as F

    from unionml_tpu_torch.ops import flash_attention as fa

    scale = d**-0.5
    q = torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16()
    k = torch.randn(b, s, kvh, d, device="cuda", generator=gen).bfloat16()
    v = torch.randn(b, s, kvh, d, device="cuda", generator=gen).bfloat16()
    pad = torch.tensor(pads, dtype=torch.int32, device="cuda")
    got = fa.flash_fwd_padded_cuda(q, k, v, pad, causal=True, scale=scale)
    again = fa.flash_fwd_padded_cuda(q, k, v, pad, causal=True, scale=scale)
    torch.cuda.synchronize()
    want = fa.flash_fwd_padded_plain(q, k, v, pad, causal=True, scale=scale)
    err = check_close(f"flash B={b} S={s}", got, want, FLASH_TOL)
    for row, p in enumerate(pads):  # queries inside the padding return zeros
        if p and bool(got[row, :p].any()):
            raise AssertionError(f"flash: padded query rows of batch row {row} are not zero")
    # row by row (each (batch row, query, head)), against the padded start
    # tile dropped; the queries inside the padding are all zero on both sides
    checks = check_rows_with_fault(
        f"flash B={b} S={s}", {"out": got}, {"out": want},
        {"out": padded_start_tile_fault(q, k, v, pad, scale=scale)}, {"out": FLASH_ROW_LIMIT},
        "each row's first visible key tile (its left-pad start tile) skipped")
    del want
    if not torch.equal(got, again):
        raise AssertionError(f"flash B={b} S={s}: two forward runs differ")
    # work this data needs: visible (q, kv) pairs under causal + left padding
    pairs = sum((s - p) * (s - p + 1) // 2 for p in pads)
    ops = 4 * pairs * h * d                       # QK^T and PV, 2 flops per MAC
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * b
    b_ms, b_by = bound(nbytes, ops, PEAK_BF16_OPS_S)
    vis = fa._visible(pad, s, s, True)[:, 0]       # [B, 1, Sq, Skv]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = time_ms(lambda: fa.flash_fwd_padded_cuda(q, k, v, pad, causal=True, scale=scale))
    return {
        "shape": f"q[{b},{s},{h},{d}] kv[{b},{s},{kvh},{d}] bf16, pads {list(pads)}",
        "max_abs_err": err, "rerun_same_bits": True, "row_checks": checks,
        "ms": ms, "tflop_s": ops / ms / 1e9,
        "plain_ms": time_ms(
            lambda: fa.flash_fwd_padded_plain(q, k, v, pad, causal=True, scale=scale), iters=3
        ),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis, enable_gqa=True)
        ),
    }


def padded_start_tile_fault(q, k, v, pad, *, scale: float) -> torch.Tensor:
    """A planted fault the row check of row 1 must reject: the plain padded
    forward with each batch row's first visible key tile (the
    :data:`FLASH_TILE`-key tile that holds its pad count, where the
    kernel's key loop starts) skipped, for queries that see past that tile,
    as a kernel that started its key loop one tile late would compute."""
    from unionml_tpu_torch.ops import flash_attention as fa

    s = q.shape[1]
    vis = fa._visible(pad, s, s, True)                                 # [B, 1, 1, Sq, Skv]
    pos = torch.arange(s, device=q.device)
    start_end = ((pad.long() // FLASH_TILE + 1) * FLASH_TILE)[:, None, None]   # [B, 1, 1]
    in_start = (pos[None, None, :] < start_end) & vis[:, 0, 0]         # keys of the start tile
    sees_past = pos[None, :, None] >= start_end                        # [B, Sq, 1]
    vis = vis & ~(in_start & sees_past)[:, None, None]
    return fa._plain_forward(q, k, v, vis, scale)[0]


PAGED_LENGTHS = (1, 15, 16, 17, 300, 1000, 1100)


def paged_case(batch: int, hq: int, hk: int, d: int, blk: int, width: int, int8: bool,
               gen) -> dict:
    """Engine-shaped paged decode attention: a shuffled block allocation,
    trash entries past each row's coverage, ragged lengths and a dead row
    (all-trash table, length 1, as dead slots decode)."""
    import torch.nn.functional as F

    from unionml_tpu_torch.ops import paged_attention as pa

    n_blocks = 1 + batch * width
    lengths = [PAGED_LENGTHS[i % len(PAGED_LENGTHS)] for i in range(batch - 1)] + [1]
    perm = (torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(1)) + 1)
    table = torch.zeros(batch, width, dtype=torch.int32)
    for b, n in enumerate(lengths[:-1]):
        cover = -(-n // blk)
        table[b, :cover] = perm[b * width: b * width + cover].int()
    table = table.cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn(batch, hq, d, device="cuda", generator=gen).bfloat16()
    shape = (n_blocks, blk, hk, d)
    scales = {}
    if int8:
        k = torch.randint(-127, 128, shape, device="cuda", generator=gen).to(torch.int8)
        v = torch.randint(-127, 128, shape, device="cuda", generator=gen).to(torch.int8)
        scales = {name: torch.rand(shape[:3], device="cuda", generator=gen) * 0.01 + 1e-3
                  for name in ("k_scale", "v_scale")}
    else:
        k = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        v = torch.randn(shape, device="cuda", generator=gen).bfloat16()
    run = lambda: pa.paged_attention_cuda(q, k, v, table, lens, **scales)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(q, k, v, table, lens, **scales)
    form = "int8" if int8 else "bf16"
    err = check_close(f"paged_attention {form}", got, want, PAGED_TOL)
    checks = check_paged_rows(f"paged_attention {form}", got, want,
                              dropped_block_fault(q, k, v, table, lens, **scales))
    # bytes this data needs: every visible K/V row once at kv-head width
    # (int8: 1 byte a value plus a 4-byte scale per head), q, out, table,
    # lengths
    rows = sum(lengths)
    per_row = hk * d * (1 if int8 else 2) + (hk * 4 if int8 else 0)
    nbytes = 2 * rows * per_row + 2 * q.numel() * 2 + table.numel() * 4 + batch * 4
    ops = 4 * rows * hq * d                       # q.k and p.v, 2 flops per MAC
    b_ms, b_by = bound(nbytes, ops, PEAK_BF16_OPS_S)
    # yardstick: no single PyTorch call pages, so SDPA over the same rows
    # gathered contiguous (int8: dequantized to bf16), gather not timed
    flat = table.reshape(-1).long()

    def gathered(pool, sc):
        g = pool[flat].reshape(batch, width * blk, hk, d)
        if sc is not None:
            g = g.float() * sc[flat].reshape(batch, width * blk, hk, 1)
        return g.bfloat16().transpose(1, 2)

    gk = gathered(k, scales.get("k_scale"))
    gv = gathered(v, scales.get("v_scale"))
    mask = (torch.arange(width * blk, device="cuda")[None] < lens[:, None])[:, None, None]
    q4 = q[:, :, None]
    # cold: each call on its own copy of the pools (and scales), rotating
    # over copies that together hold more than twice the L2 of what one
    # call reads; the library call over copies of the gathered rows
    pools = [(k, v, scales)] + [
        (k.clone(), v.clone(), {n: t.clone() for n, t in scales.items()})
        for _ in cold_copies(k, nbytes)[1:]
    ]
    ms_cold = time_ms_cold([
        lambda c=c: pa.paged_attention_cuda(q, c[0], c[1], table, lens, **c[2]) for c in pools
    ])
    del pools
    lib_ms_cold = time_ms_cold([
        lambda c=c: F.scaled_dot_product_attention(q4, c[0], c[1], attn_mask=mask,
                                                   enable_gqa=True)
        for c in zip(cold_copies(gk), cold_copies(gv))
    ])
    return {
        "shape": f"q[{batch},{hq},{d}] bf16, {form} pools[{n_blocks},{blk},{hk},{d}], "
                 f"table[{batch},{width}], lengths {lengths}",
        "form": form,
        "max_abs_err": err, "row_checks": {"out": checks},
        "ms": time_ms(run), "ms_cold": ms_cold,
        "plain_ms": time_ms(
            lambda: pa.paged_attention_plain(q, k, v, table, lens, **scales), iters=5
        ),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(q4, gk, gv, attn_mask=mask, enable_gqa=True)
        ),
        "library_ms_cold": lib_ms_cold,
        "library_call": "scaled_dot_product_attention(enable_gqa) over the rows gathered "
                        "contiguous beforehand (gather not timed)",
    }


def random_int4_weight(k: int, n: int, group: int, gen, device: str = "cuda") -> tuple:
    """Random packed int4 weights ``[k, n/2]`` and fp32 scales (``[n]``, or
    ``[k/group, n]``) whose dequantized values have mean 0 and std about
    1/sqrt(k). Each nibble is uniform in [-7, 7] (std 4.32): a uniform byte
    would give nibbles in [-8, 7], whose mean of -0.5 adds the same value to
    every output channel and drowns a random model in one direction."""
    lo, hi = (torch.randint(-7, 8, (k, n // 2), device=device, generator=gen,
                            dtype=torch.int16) & 15 for _ in range(2))
    byte = lo | (hi << 4)
    packed = torch.where(byte > 127, byte - 256, byte).to(torch.int8)
    shape = (k // group, n) if group else (n,)
    scale = (0.75 + 0.5 * torch.rand(shape, device=device, generator=gen)) / (4.32 * k**0.5)
    return packed, scale


def _int4pack_library(x, packed, scale, tile, group):
    """``torch._weight_int4pack_mm`` on the same nibbles (bf16 scales, zero
    point 8; repacking not timed): a yardstick, not an oracle. Returns
    ``(ms, ms_cold, note)``; the times are None where the card's build
    lacks the op."""
    from unionml_tpu_torch.ops import int4_matmul as i4

    k, n = x.shape[1], scale.shape[-1]
    try:
        unsigned = (i4.unpack_int4(packed, tile).to(torch.int32) + 8).t().contiguous()  # [n, k]
        as_bytes = ((unsigned[:, ::2] << 4) | unsigned[:, 1::2]).to(torch.uint8)
        try:
            w = torch._convert_weight_to_int4pack(as_bytes, 8)
        except RuntimeError:
            w = torch._convert_weight_to_int4pack(unsigned, 8)
        sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).bfloat16().contiguous()
        xb = x.bfloat16()
        torch._weight_int4pack_mm(xb, w, group, sz)
        cold = [lambda c=c: torch._weight_int4pack_mm(xb, c, group, sz) for c in cold_copies(w)]
        return time_ms(lambda: torch._weight_int4pack_mm(xb, w, group, sz)), time_ms_cold(cold), (
            f"torch._weight_int4pack_mm, group {group}, bf16 scales (repack not timed)"
        )
    except (RuntimeError, AttributeError, TypeError) as exc:
        return None, None, f"torch._weight_int4pack_mm unavailable on this build: {exc!r}"[:300]


def rounding_mismatch(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of outputs whose bits differ from the plain version's. The
    kernel and the plain version sum the same fp32 products in two orders
    and round once, so only near-ties may round apart."""
    return float((got != want).float().mean().item())


def int4_slice_faults(x, packed, scale, tile: int) -> dict:
    """Two planted faults of the per-channel kernel's K split, computed from
    the plain version's math on the same inputs: the last K-slice dropped,
    and the slices' partials rounded to bf16 and summed in reverse rank
    order in bf16. The bit check must reject both."""
    from unionml_tpu_torch.ops import int4_matmul as i4

    k, n = x.shape[1], scale.shape[-1]
    w = i4.unpack_int4(packed, tile).float()
    xf = x.float()
    parts = [xf[:, a:b] @ w[a:b] for a, b in i4._k_slices(k, i4._k_splits(k, n))]
    dropped = (sum(parts[:-1], torch.zeros_like(parts[0])) * scale).to(x.dtype)
    rounded = parts[-1].to(x.dtype)
    for p in reversed(parts[:-1]):
        rounded = rounded + p.to(x.dtype)
    reordered = (rounded.float() * scale).to(x.dtype)
    return {"last_slice_dropped": dropped, "bf16_reverse_rank_sum": reordered}


def int4_group_faults(x, packed, scale, tile: int, group: int) -> dict:
    """Three planted faults of the grouped kernel, computed from the plain
    version's math on the same inputs (each K group's fp32 partial, times
    its scale row, rounded as the reference rounds it): the last K group
    dropped; each group's partial times the scale row of the next group
    inside its K-slice (an off-by-one in a slice's scale offset, the last
    group of a slice taking the slice's first row); the slices' scaled
    partials rounded to bf16 and summed in reverse rank order in bf16. The
    bit check must reject all three."""
    from unionml_tpu_torch.ops import int4_matmul as i4

    k, n = x.shape[1], scale.shape[-1]
    w = i4.unpack_int4(packed, tile).float()
    xf = x.float()
    groups = k // group
    parts = [xf[:, g * group:(g + 1) * group] @ w[g * group:(g + 1) * group]
             for g in range(groups)]
    slices = [(a // group, b // group) for a, b in i4._k_slices(k, i4._k_splits(k, n, group),
                                                                 group)]

    def summed(pairs):   # in order: each (group, scale row), the partial times the row
        total = None
        for g, row in pairs:
            term = parts[g] * scale[row]
            total = term if total is None else total + term
        return total

    dropped = summed((g, g) for g in range(groups - 1))
    shifted = summed((g, a + (g - a + 1) % (b - a)) for a, b in slices for g in range(a, b))
    slice_sums = [summed((g, g) for g in range(a, b)).to(x.dtype) for a, b in slices]
    reordered = slice_sums[-1]
    for t in reversed(slice_sums[:-1]):
        reordered = reordered + t
    return {"last_group_dropped": dropped.to(x.dtype),
            "scale_row_off_by_one": shifted.to(x.dtype),
            "bf16_reverse_rank_sum": reordered.to(x.dtype)}


def int4_fma_scale(x, packed, scale, tile: int, group: int) -> torch.Tensor:
    """The grouped plain math with each group's scale applied by an FMA:
    the running total plus the group's fp32 partial times its scale row,
    rounded once (emulated in fp64, where the product of two fp32 values is
    exact), in group order, then one rounding to x's dtype. The rounding
    point the kernel must not take: the reference multiplies, rounds, then
    adds (:func:`int4_rounding_probe` tells the two apart)."""
    from unionml_tpu_torch.ops import int4_matmul as i4

    rows, k = x.shape
    groups = k // group
    w = i4.unpack_int4(packed, tile).float()
    partial = torch.bmm(x.float().reshape(rows, groups, group).transpose(0, 1),
                        w.reshape(groups, group, -1))     # as int4_matmul_plain forms it
    total = torch.zeros_like(partial[0])
    for g in range(groups):
        total = (partial[g].double() * scale[g].double() + total.double()).float()
    return total.to(x.dtype)


def int4_rounding_probe(rows: int, k: int, n: int, tile: int, group: int, dtype, gen) -> tuple:
    """Grouped inputs on which the kernel's rounding point shows bit for bit.
    x is 1 at the first K row of groups 0 and 1 and 0 elsewhere, and those
    weight rows hold the nibbles 1 and 3, so each output's partials are the
    exact integers 1 and 3 (every other group's is 0). Scale row 1 is s1 in
    [2/3, 1), so 3 * s1 is inexact in fp32; scale row 0 is m - fl(3 * s1),
    with m a tie between two bf16 values. Multiplying, rounding, then adding
    (the reference) gives m exactly in every summation order; an FMA gives
    m + (3 * s1 - fl(3 * s1)) instead, which is another fp32 value for about
    3/4 of the outputs and rounds to the other bf16 for about half of those.
    Returns ``(x, packed, scale, want, fma)``: the plain version's output
    and the planted fault's (:func:`int4_fma_scale`), on ``gen``'s
    device."""
    from unionml_tpu_torch.ops import int4_matmul as i4

    dev = gen.device
    nib = torch.randint(-7, 8, (k, n), generator=gen, device=dev, dtype=torch.int8)
    nib[0], nib[group] = 1, 3
    packed = i4.pack_int4(nib, tile)
    scale = 0.5 + 0.5 * torch.rand(k // group, n, generator=gen, device=dev)
    s1 = 2 / 3 + torch.rand(n, generator=gen, device=dev) / 3
    c = (3 * s1).double()          # fl(3 * s1): one fp32 multiply, exact in fp64
    odd = 2 * torch.randint(0, 128, (n,), generator=gen, device=dev) + 1
    m = (1 + odd.double() / 256) / 16
    s0 = (m - c).float()
    if not torch.equal(s0.double() + c, m):
        raise AssertionError("int4 rounding probe: m - fl(3 * s1) is not exact in fp32")
    scale[0], scale[1] = s0, s1
    x = torch.zeros(rows, k, device=dev)
    x[:, 0] = x[:, group] = 1
    x = x.to(dtype)
    want = i4.int4_matmul_plain(x, packed, scale, tile_n=tile, dtype=dtype, group_size=group)
    return x, packed, scale, want, int4_fma_scale(x, packed, scale, tile, group)


def int4_rounding_check(name: str, got, want, fma) -> dict:
    """The rounding probe's check: the kernel gives the plain version's bits
    on every output (every value but the planted rounding is exact), and
    the FMA fault does not."""
    checks = {"mismatch": rounding_mismatch(got, want),
              "fma_fault_mismatch": rounding_mismatch(fma, want)}
    if checks["mismatch"] != 0:
        raise AssertionError(f"{name}: {checks['mismatch']:.4f} of outputs differ from the "
                             "plain version on the rounding probe (not multiply, then add)")
    if checks["fma_fault_mismatch"] == 0:
        raise AssertionError(f"{name}: the probe does not tell an FMA from multiply, then add")
    return checks


def int4_rounding_cases(gen) -> list:
    """The rounding probe through the grouped kernel at the int4 paged
    engine's q/o shape (bf16, 16 rows, g=128: groups 0 and 1 share the
    first of 8 K-slices) and at its fp32 LM head (16 rows, tile 256)."""
    from unionml_tpu_torch.ops import int4_matmul as i4

    cases = []
    for rows, k, n, tile, dtype in ((16, 4096, 4096, 512, torch.bfloat16),
                                    (16, 4096, 128256, 256, torch.float32)):
        first_slice = i4._k_slices(k, i4._k_splits(k, n, 128), 128)[0]
        if dtype == torch.bfloat16 and first_slice[1] < 2 * 128:
            raise AssertionError("int4 rounding probe: groups 0 and 1 fall in two K-slices")
        x, packed, scale, want, fma = int4_rounding_probe(rows, k, n, tile, 128, dtype, gen)
        got = i4.int4_matmul_cuda(x, packed, scale, tile_n=tile, group_size=128)
        name = f"int4_matmul g128 rounding probe x[{rows},{k}] {str(dtype).split('.')[-1]} N={n}"
        checks = int4_rounding_check(name, got, want, fma)
        log(f"{name}: {checks}")
        cases.append({"shape": name, **checks})
        del x, packed, scale, want, fma, got
    return cases


def int4_bit_check(name: str, got, want, checks: dict) -> None:
    """The bf16 bit check: at most :data:`INT4_MISMATCH_MAX` of outputs may
    round apart from the plain version."""
    checks["mismatch"] = rounding_mismatch(got, want)
    if checks["mismatch"] > INT4_MISMATCH_MAX:
        raise AssertionError(f"{name}: {checks['mismatch']:.4f} of outputs round apart from the "
                             f"plain version (limit {INT4_MISMATCH_MAX})")


def int4_fault_checks(name: str, faults: dict, want, checks: dict) -> None:
    """Each planted fault must fail the bit check (more than
    :data:`INT4_MISMATCH_MAX` of outputs apart); records its share and
    whether the elementwise :data:`INT4_TOL` check alone would pass it."""
    tol = INT4_TOL[want.dtype]
    for fault, bad in faults.items():
        share = rounding_mismatch(bad, want)
        checks[f"fault_{fault}"] = share
        limit = tol["atol"] + tol["rtol"] * want.float().abs()
        checks[f"fault_{fault}_passes_int4_tol"] = bool(
            ((bad.float() - want.float()).abs() <= limit).all())
        if share <= INT4_MISMATCH_MAX:
            raise AssertionError(
                f"{name}: the planted fault {fault} passes the bit check ({share:.4f} apart)")


def int4_case(rows: int, k: int, n: int, group: int, dtype, gen, tile: int = None,
              faults: bool = False) -> dict:
    """One int4 matmul at a main-path shape: the kernel against its plain
    version, the per-row independence of its result (the first 8 rows of a
    ``rows``-row launch equal an 8-row launch bit for bit), warm and cold
    times beside the library call's; bf16 also bit for bit
    (:func:`int4_bit_check`), and with ``faults`` the planted faults of its
    scale form (per-channel: :func:`int4_slice_faults`; grouped:
    :func:`int4_group_faults`), which that check must reject; grouped, the
    share of outputs the FMA fault (:func:`int4_fma_scale`) puts apart is
    recorded beside the kernel's, as ``fma_scale_mismatch``."""
    from unionml_tpu_torch.ops import int4_matmul as i4

    tile = tile or i4.tile_for(n, k)
    packed, scale = random_int4_weight(k, n, group, gen)
    x = torch.randn(rows, k, device="cuda", generator=gen).to(dtype)
    run = lambda: i4.int4_matmul_cuda(x, packed, scale, tile_n=tile, group_size=group)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    want = i4.int4_matmul_plain(x, packed, scale, tile_n=tile, dtype=dtype, group_size=group)
    form = f"g{group}" if group else "per-channel"
    name = f"int4_matmul {form} x[{rows},{k}] {str(dtype).split('.')[-1]} N={n}"
    err = check_close(name, got, want, INT4_TOL[dtype])
    checks = {}
    if dtype == torch.bfloat16:
        int4_bit_check(name, got, want, checks)
        if faults:
            planted = (int4_group_faults(x, packed, scale, tile, group) if group
                       else int4_slice_faults(x, packed, scale, tile))
            int4_fault_checks(name, planted, want, checks)
            if group:
                checks["fma_scale_mismatch"] = rounding_mismatch(
                    int4_fma_scale(x, packed, scale, tile, group), want)
            del planted
        log(f"{name}: {checks}")
    if rows > 8:
        head = i4.int4_matmul_cuda(x[:8].contiguous(), packed, scale, tile_n=tile, group_size=group)
        if not torch.equal(head, got[:8]):
            raise AssertionError(f"{name}: a row's result depends on the launch's row count")
    elt = x.element_size()
    nbytes = packed.numel() + scale.numel() * 4 + rows * k * elt + rows * n * elt
    peak = PEAK_FP32_OPS_S if dtype == torch.float32 else PEAK_BF16_OPS_S
    b_ms, b_by = bound(nbytes, 2 * rows * k * n, peak)
    cold = [
        (lambda p=p: i4.int4_matmul_cuda(x, p, scale, tile_n=tile, group_size=group))
        for p in cold_copies(packed)
    ]
    ms, ms_cold = time_ms(run), time_ms_cold(cold)
    del cold
    if group and dtype == torch.bfloat16:
        lib_ms, lib_ms_cold, lib_note = _int4pack_library(x, packed, scale, tile, group)
    else:
        w = i4.unpack_int4(packed, tile)  # dequantized beforehand, not timed
        w = (w.float() * (scale.repeat_interleave(group, 0) if group else scale)).to(dtype)
        lib_ms = time_ms(lambda: torch.mm(x, w))
        lib_ms_cold = time_ms_cold([lambda c=c: torch.mm(x, c) for c in cold_copies(w)])
        lib_note = f"torch.mm of {str(dtype).split('.')[-1]} x against the weight dequantized " \
                   "beforehand (dequantization not timed)"
        del w
    return {
        "shape": f"x[{rows},{k}] {str(dtype).split('.')[-1]} @ W4[{k},{n}] tile {tile}, {form}",
        "form": form, "rows": rows,
        "max_abs_err": err, **checks,
        "ms": ms, "ms_cold": ms_cold,
        "plain_ms": time_ms(
            lambda: i4.int4_matmul_plain(x, packed, scale, tile_n=tile, dtype=dtype,
                                         group_size=group), iters=3,
        ),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library_ms_cold": lib_ms_cold, "library_call": lib_note,
    }


def event_wait_releases_gil() -> int:
    """Count Python loop iterations the main thread makes while another
    thread waits on a CUDA event behind ~0.2 s of device work. A wait
    that held the interpreter lock would leave the count near 0."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e8))
    event = torch.cuda.Event()
    event.record()
    waiter = threading.Thread(target=event.synchronize)
    waiter.start()
    count = 0
    while waiter.is_alive():
        count += 1
    waiter.join()
    return count


# ViT-B/16 at batch 64: 196 patches + cls, 12 heads of 64, width 768
VIT_B, VIT_S, VIT_H, VIT_HD, VIT_D = 64, 197, 12, 64, 768
# max |kernel - plain| over max |plain|: gradients hold many entries near 0
# beside large ones, so bf16 rounding is judged against the tensor's scale
SCALED_LIMIT = {
    "norm_dx": 1e-2,        # bf16 dx, fp32 statistics in another sum order
    "norm_params": 1e-4,    # fp32 dgamma/dbeta: per-block partials vs one sum
}
# row 5 (the norm backward): dx row by row within NORM_BWD_ROW_LIMIT of the
# row's max |plain|: one bf16 rounding of the output is up to 2**-8 (0.0039)
# of the row's max, the fp32 statistics summed in another order add ~1e-6;
# 1e-2 is ~2.5 bf16 ulps of the row's largest entry. dgamma and dbeta
# column by column within NORM_PARAM_COL_LIMIT of the column's own |plain|
# (floored at ROW_FLOOR x the tensor's max): fp32 sums over 12608 rows in
# another order differ by ~1e-4 of the smallest columns at ViT-B
# (emulated), 1e-3 leaves 10x that. Both beside the whole-tensor
# SCALED_LIMIT checks.
NORM_BWD_ROW_LIMIT = 1e-2
NORM_PARAM_COL_LIMIT = 1e-3
NORM_FAULT_BLOCK = 16   # the planted faults' row period and dropped block

# rows 12-13 against their plain versions, row by row (check_rows: query
# rows of out and dq, key rows of dk and dv, each against its own max
# |plain|): out within 1e-2 (e rounded to bf16 against the same final row
# max as the plain version; one bf16 ulp of output rounding and fp32 sums
# in another order), dq/dk/dv within 2e-2 (do / z and ds rounded at the
# same points, then fp32 sums in another order)
FUSED_ROW_LIMIT = {"out": 1e-2, "dq": 2e-2, "dk": 2e-2, "dv": 2e-2}
FUSED_CHUNK = 64        # the key chunk the planted fault of rows 12-13 skips
ROW_FLOOR = 1e-3        # of the tensor's max |plain|, see row_rel_err


def check_scaled(name: str, got: torch.Tensor, want: torch.Tensor, limit: float) -> float:
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if err > limit * max(scale, 1e-30):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs err {err} beyond "
            f"{limit} x max |plain| {scale}"
        )
    return err


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row (all but the last dim): max |got - want| over the row's max
    |want|, that scale floored at ``ROW_FLOOR`` x the tensor's max
    |want|. A row that far below the rest holds fp32 cancellation noise:
    a query that sees one key has ds = p (dp - delta) = 0 in exact
    arithmetic, and the plain and kernel sums leave different residues."""
    err = (got.float() - want.float()).abs().amax(dim=-1)
    scale = want.float().abs().amax(dim=-1)
    scale = scale.clamp_min(ROW_FLOOR * float(scale.max())).clamp_min(1e-30)
    return err / scale


def check_rows(name: str, got: torch.Tensor, want: torch.Tensor, limit: float) -> dict:
    """Hold ``got`` to ``want`` row by row (:func:`row_rel_err` at most
    ``limit``); returns the worst row's error and the scale of ``want``."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    rel = row_rel_err(got, want)
    worst = int(rel.argmax())
    mag = want.float().abs()
    stats = {"max_row_rel_err": float(rel.max()), "limit": limit,
             "plain_abs_max": float(mag.max()), "plain_abs_median": float(mag.median()),
             "max_abs_err": float((got.float() - want.float()).abs().max())}
    if stats["max_row_rel_err"] > limit:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: row {worst} (flat index over "
            f"{tuple(rel.shape)}) is off by {stats['max_row_rel_err']} of its max |plain| "
            f"{float(mag.amax(dim=-1).flatten()[worst])}, beyond {limit}"
        )
    return stats


def check_rows_with_fault(name: str, got: dict, want: dict, fault: dict, limits: dict,
                          fault_name: str) -> dict:
    """:func:`check_rows` for each tensor named in ``limits``, then the
    planted fault against the same plain versions: it must fail the check
    (the share of its rows beyond the limit is recorded)."""
    checks = {}
    for t_name, limit in limits.items():
        checks[t_name] = check_rows(f"{name} {t_name}", got[t_name], want[t_name], limit)
        over = row_rel_err(fault[t_name], want[t_name]) > limit
        checks[t_name]["fault_rows_over_limit"] = float(over.float().mean())
        if not bool(over.any()):
            raise AssertionError(f"{name} {t_name}: the row check passed a planted fault "
                                 f"({fault_name})")
    return checks


def skipped_chunk_fault(q, k, v, do, o, *, causal: bool):
    """A planted fault the row check of rows 12-13 must reject: the plain
    forward and backward (the arithmetic of ``fused_attention_*_plain``)
    with each query's last visible 64-key chunk skipped, for queries that
    see more than one chunk, as kernels whose key loop stops one chunk
    short would compute. ``(out, dq, dk, dv)``; the backward uses the given
    ``o``, as the backward kernel does."""
    from unionml_tpu_torch.ops import fused_attention as tfa

    pos = torch.arange(q.shape[1], device=q.device)
    vis = pos[None, :] <= pos[:, None] if causal else \
        torch.ones(len(pos), len(pos), dtype=torch.bool, device=q.device)
    last = (pos if causal else torch.full_like(pos, len(pos) - 1)) // FUSED_CHUNK
    vis = vis & ~((pos[None, :] // FUSED_CHUNK == last[:, None]) & (last[:, None] > 0))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = torch.where(vis, s, torch.full_like(s, tfa.NEG_INF))
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    z = e.sum(dim=-1, keepdim=True)
    bad_out = (torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype).float(), v.float()) / z)
    do_bh = do.permute(0, 2, 1, 3)
    do_n = (do_bh.float() / z).to(do.dtype)
    dv = torch.einsum("bhqk,bhqd->bkhd", e.to(do.dtype).float(), do_n.float())
    delta = (do_bh.float() * o.permute(0, 2, 1, 3).float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (e * (dp - delta) * (tfa.LN2 / z)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return (bad_out.permute(0, 2, 1, 3).to(q.dtype), dq.to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def check_fused_rows(name: str, got: dict, want: dict, fault: dict) -> dict:
    """Rows 12-13 (out, dq, dk, dv) row by row within
    :data:`FUSED_ROW_LIMIT`; the skipped-chunk fault must fail."""
    return check_rows_with_fault(name, got, want, fault, FUSED_ROW_LIMIT,
                                 "each query's last 64-key chunk skipped")


# row 6: each (batch row, q head) output row within 2e-2 of its own max
# |plain|. The kernel rounds each weight p to q's dtype before normalising
# (against its running maximum), the plain version the normalised weight:
# each is one bf16 rounding of each weight, which moves a row by well under
# 1e-3 of its max at these lengths; then the output rounds once to bf16,
# and one ulp of it is up to 2**-7 (0.0078) of a row's max. 2e-2 leaves
# 2.5x that; dropping one 16-row block of a 1000-row row moves the row by
# several times the limit.
PAGED_ROW_LIMIT = 2e-2


def dropped_block_fault(q, k, v, table, lengths, **scales) -> torch.Tensor:
    """A planted fault the row check of row 6 must reject: the plain version
    with the last visible pool block of every row that covers more than one
    block dropped, as a kernel whose walk over a row's blocks (or over the
    splits of a row) stops one block short would compute."""
    from unionml_tpu_torch.ops import paged_attention as pa

    blk = k.shape[1]
    n = lengths.long().clamp(0, table.shape[1] * blk)
    cover = (n + blk - 1) // blk
    short = torch.where(cover > 1, (cover - 1) * blk, n).to(lengths.dtype)
    return pa.paged_attention_plain(q, k, v, table, short, **scales)


def check_paged_rows(name: str, got: torch.Tensor, want: torch.Tensor,
                     fault: torch.Tensor) -> dict:
    """Row 6 row by row within :data:`PAGED_ROW_LIMIT`; the dropped-block
    fault must fail."""
    return check_rows_with_fault(name, {"out": got}, {"out": want}, {"out": fault},
                                 {"out": PAGED_ROW_LIMIT},
                                 "each row's last visible pool block dropped")["out"]


def log_row_checks(checks: dict) -> None:
    for t_name, chk in checks.items():
        log(f"  row check {t_name}: max row err {chk['max_row_rel_err']} of the row's "
            f"max |plain| (limit {chk['limit']}); |plain| max {chk['plain_abs_max']} "
            f"median {chk['plain_abs_median']}; planted fault: "
            f"{chk['fault_rows_over_limit']} of rows beyond the limit")


def norm_bwd_faults(x, gamma, dy, eps: float, rms: bool, with_beta: bool) -> dict:
    """Three planted faults of row 5, each built from the plain backward's
    arithmetic (:func:`norm_bwd_plain`): ``c2_dropped``, dx with the
    ``mean(dyg * xhat)`` term left out of one row in 16 (rows 0, 16, ...);
    ``c2_dropped_one_row``, the same term left out of one row only, the row
    (of those it moves by more than 1.5x :data:`NORM_BWD_ROW_LIMIT` of
    their max) that it moves least: a fault a check against the whole
    tensor's max can miss; ``partial_dropped``, dgamma / dbeta without the
    last 16-row block's partial. Each maps "dx", "dgamma", "dbeta" to its
    tensors (the untouched ones are the plain version's)."""
    from unionml_tpu_torch.ops import fused_norm as fn

    dx, dg, db = fn.norm_bwd_plain(x, gamma, dy, eps, rms, with_beta)
    x32, dy32 = x.float(), dy.float()
    mu, rstd = fn._stats(x32, rms, eps)
    xhat = (x32 - mu) * rstd
    dyg = dy32 * gamma.float()
    c1 = 0.0 if rms else dyg.mean(dim=-1, keepdim=True)
    no_c2 = (rstd * (dyg - c1)).to(x.dtype)
    hit = (torch.arange(x.shape[0], device=x.device) % NORM_FAULT_BLOCK == 0)[:, None]
    bad_dx = torch.where(hit, no_c2, dx)
    moved = (no_c2.float() - dx.float()).abs().amax(dim=-1)
    seen = row_rel_err(no_c2, dx) > 1.5 * NORM_BWD_ROW_LIMIT
    row = int(torch.where(seen, moved, torch.full_like(moved, float("inf"))).argmin())
    one_dx = dx.clone()
    one_dx[row] = no_c2[row]
    keep = (x.shape[0] - 1) // NORM_FAULT_BLOCK * NORM_FAULT_BLOCK   # the last block's first row
    bad_dg = (dy32[:keep] * xhat[:keep]).sum(dim=0)
    bad_db = dy32[:keep].sum(dim=0) if with_beta else None
    return {"c2_dropped": {"dx": bad_dx, "dgamma": dg, "dbeta": db},
            "c2_dropped_one_row": {"dx": one_dx, "dgamma": dg, "dbeta": db},
            "partial_dropped": {"dx": dx, "dgamma": bad_dg, "dbeta": bad_db}}


def check_norm_bwd(name: str, got: dict, want: dict, faults: dict) -> dict:
    """Row 5 ("dx", "dgamma", "dbeta"; dbeta may be None): dx row by row
    within :data:`NORM_BWD_ROW_LIMIT`, dgamma and dbeta column by column
    within :data:`NORM_PARAM_COL_LIMIT` (each column a row of
    :func:`row_rel_err`) and against the tensor's max within
    ``SCALED_LIMIT``. Each planted fault of :func:`norm_bwd_faults` must
    fail the row or column check; the share of its rows (columns) beyond
    the limit is recorded, and whether the whole-tensor check alone
    (:func:`check_scaled`) would have passed it."""
    limits = {"dx": NORM_BWD_ROW_LIMIT, "dgamma": NORM_PARAM_COL_LIMIT,
              "dbeta": NORM_PARAM_COL_LIMIT}
    scaled = {"dx": SCALED_LIMIT["norm_dx"], "dgamma": SCALED_LIMIT["norm_params"],
              "dbeta": SCALED_LIMIT["norm_params"]}

    def rows_of(t_name, t):
        return t if t_name == "dx" else t[:, None]

    def scaled_passes(t_name, bad):
        try:
            check_scaled(t_name, bad, want[t_name], scaled[t_name])
            return True
        except AssertionError:
            return False

    checks = {}
    for t_name, limit in limits.items():
        if want[t_name] is None:
            continue
        check_scaled(f"{name} {t_name}", got[t_name], want[t_name], scaled[t_name])
        checks[t_name] = check_rows(f"{name} {t_name}", rows_of(t_name, got[t_name]),
                                    rows_of(t_name, want[t_name]), limit)
    for fault, bad in faults.items():
        over = {t_name: float((row_rel_err(rows_of(t_name, bad[t_name]),
                                           rows_of(t_name, want[t_name])) > limit).float().mean())
                for t_name, limit in limits.items() if want[t_name] is not None}
        if not any(over.values()):
            raise AssertionError(f"{name}: the row and column check passed a planted fault "
                                 f"({fault})")
        checks[f"fault_{fault}"] = {
            "rows_over_limit": over,
            "passes_scaled_check": all(scaled_passes(t_name, bad[t_name])
                                       for t_name in over),
        }
    return checks


# rows 2-4 (the norm forward) bit for bit. The kernel and its plain version
# compute the same fp32 statistics (LayerNorm: the mean, then the centred
# variance; RMS: the mean square), the same (v - mu) * rstd * g (+ b) and
# round once; only the order of the fp32 sums differs. That moves mu or
# rstd by an ulp in some rows, which puts a bf16 output apart only at a
# near-tie: at most 3e-5 of outputs (emulated on the CPU with seeded bf16
# inputs). NORM_FWD_MISMATCH_MAX leaves 30x that; the mildest planted fault
# (the last vector left out of the statistics of one row in 16) puts ~4e-3
# of outputs apart at x[4096, 4096]. fp32 outputs are held by the row
# check alone: there an ulp of mu or rstd moves most of a row's bits.
NORM_FWD_MISMATCH_MAX = 1e-3
# ... and row by row (check_rows: each row against its own max |plain|):
# one bf16 output rounding apart is up to 2**-7 (0.0078) of its row's max,
# so bf16 is held within 1e-2; fp32 statistics summed in another order move
# an fp32 row by ~1e-6 of its max at d = 8192, so fp32 within 1e-5
NORM_FWD_ROW_LIMIT = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
NORM_SPIKE = 16.0       # the statistics probe's spike: exact in bf16


def norm_stats_probe(rows: int, d: int, dtype, gen, add: bool = False) -> tuple:
    """Inputs on which every 16-byte vector of a row weighs in its
    statistics: ``x`` random, with two of row i's vectors (``vec``
    elements of x's dtype each) scaled by :data:`NORM_SPIKE`: vector ``i
    mod n`` and its mirror ``n - 1 - (i mod n)``, ``n = d / vec``. The
    spikes walk over every vector position as the rows go on (from both
    ends, so a call of a few rows still spikes the first and the last
    vectors), and a vector left out of the sums moves its rows far past
    every limit, at every width. Returns ``(x, r)``; ``r`` (random, no
    spike) is None unless ``add``."""
    dev = gen.device
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    n = d // vec
    x = torch.randn(rows, d, device=dev, generator=gen)
    at = torch.arange(rows, device=dev) % n
    lanes = torch.arange(vec, device=dev)[None, :]
    cols = torch.cat([at[:, None] * vec + lanes, (n - 1 - at)[:, None] * vec + lanes], dim=1)
    x.scatter_(1, cols, x.gather(1, cols) * NORM_SPIKE)
    r = torch.randn(rows, d, device=dev, generator=gen).to(dtype) if add else None
    return x.to(dtype), r


def norm_fwd_faults(x, r, g, b, eps: float, rms: bool) -> dict:
    """The planted faults of rows 2-4, each ``y`` built from the plain
    forward's arithmetic (:func:`norm_fwd_plain` / :func:`norm_add_fwd_plain`)
    on the same inputs: ``last_vector_dropped``, the row's last 16-byte
    vector left out of the statistics (the sums still divided by d);
    ``last_vector_dropped_1_in_16``, the same in rows 0, 16, ... only;
    ``next_row_stats``, rows 0, 16, ... normalized with the next row's
    statistics (a ring slot off by one; rows with a next row only); with
    ``r`` in bf16, ``rounded_sum_normalized``: y from the bf16-rounded
    ``s`` instead of the fp32 sum."""
    from unionml_tpu_torch.ops import fused_norm as fn

    s32 = x.float() if r is None else x.float() + r.float()
    rows, d = s32.shape
    vec = 16 // x.element_size()

    def apply(mu, rstd):
        out = (s32 - mu) * rstd * g.float()
        return (out if b is None else out + b.float()).to(x.dtype)

    kept = s32[:, :d - vec]
    if rms:
        mu = torch.zeros_like(s32[:, :1])
        var = (kept * kept).sum(dim=-1, keepdim=True) / d
    else:
        mu = kept.sum(dim=-1, keepdim=True) / d
        var = ((kept - mu) ** 2).sum(dim=-1, keepdim=True) / d
    dropped = apply(mu, torch.rsqrt(var + eps))
    want = fn._normalize(s32, g, b, eps, rms).to(x.dtype)
    hit = (torch.arange(rows, device=x.device) % NORM_FAULT_BLOCK == 0)[:, None]
    faults = {"last_vector_dropped": dropped,
              "last_vector_dropped_1_in_16": torch.where(hit, dropped, want)}
    if rows > 1:
        mu, rstd = fn._stats(s32, rms, eps)
        nxt = torch.arange(rows, device=x.device).add(1).clamp_max(rows - 1)
        shifted = apply(mu if rms else mu[nxt], rstd[nxt])
        faults["next_row_stats"] = torch.where(hit & (nxt != torch.arange(
            rows, device=x.device))[:, None], shifted, want)
    if r is not None and x.dtype == torch.bfloat16:
        faults["rounded_sum_normalized"] = fn._normalize(
            s32.to(x.dtype).float(), g, b, eps, rms).to(x.dtype)
    return faults


def norm_fwd_check(name: str, got: dict, want: dict, faults: dict) -> dict:
    """Hold one forward call (``got``: "y", and "s" for the add form) to its
    plain version (``want``): s bit for bit (one fp32 add, one rounding),
    y row by row within :data:`NORM_FWD_ROW_LIMIT` and, in bf16, at most
    :data:`NORM_FWD_MISMATCH_MAX` of its outputs off the plain version's
    bits. For each planted fault (``faults``: name -> y) the same measures
    are recorded, with ``fails``: whether this check rejects it, and
    ``passes_norm_tol``: whether the elementwise :data:`NORM_TOL` alone
    would pass it."""
    y, wy = got["y"], want["y"]
    if "s" in want and not torch.equal(got["s"], want["s"]):
        raise AssertionError(f"{name}: s differs from the plain x + r")
    limit = NORM_FWD_ROW_LIMIT[wy.dtype]
    bits = wy.dtype == torch.bfloat16
    checks = {"rows": check_rows(f"{name} y", y, wy, limit)}
    if bits:
        checks["mismatch"] = rounding_mismatch(y, wy)
        if checks["mismatch"] > NORM_FWD_MISMATCH_MAX:
            raise AssertionError(f"{name}: {checks['mismatch']:.2e} of outputs are off the plain "
                                 f"version's bits (limit {NORM_FWD_MISMATCH_MAX})")
    tol = NORM_TOL["atol"] + NORM_TOL["rtol"] * wy.float().abs()
    for fault, bad in faults.items():
        share = rounding_mismatch(bad, wy)
        worst = float(row_rel_err(bad, wy).max())
        checks[f"fault_{fault}"] = {
            "mismatch": share, "max_row_rel_err": worst,
            "fails": worst > limit or (bits and share > NORM_FWD_MISMATCH_MAX),
            "passes_norm_tol": bool(((bad.float() - wy.float()).abs() <= tol).all()),
        }
    return checks


def norm_row_invariance(name: str, fwd, x, r, full: dict) -> None:
    """A row's output bits depend neither on the call's row count nor on
    where the row sits: rows 0, rows / 2 and the last alone, a 16-row call
    of rows spread over the tensor (the paged engine's decode shape), each
    equal to the full call's rows (``full``); and a rerun of the full call
    gives the same bits. ``fwd(x, r)`` returns {"y": ...} (and "s")."""
    rows = x.shape[0]
    picks = [torch.tensor([i], device=x.device) for i in sorted({0, rows // 2, rows - 1})]
    if rows >= 16:
        step = rows // 16
        picks.append(torch.arange(16, device=x.device) * step + step - 1)
    for idx in picks:
        part = fwd(x[idx].contiguous(), None if r is None else r[idx].contiguous())
        for t_name, t in part.items():
            if not torch.equal(t, full[t_name][idx]):
                raise AssertionError(f"{name}: {t_name} of rows {idx.tolist()[:4]}... depends on "
                                     f"the call's row count or on where the rows sit")
    again = fwd(x, r)
    if not all(torch.equal(again[k], full[k]) for k in full):
        raise AssertionError(f"{name}: two runs differ")


def norm_fwd_cases(name: str, fwd, rows: int, d: int, dtype, g, b, eps: float, rms: bool,
                   add: bool, gen) -> dict:
    """Rows 2-4 at one shape: ``fwd(x, r)`` (the kernel, or on the CPU the
    plain version) on random inputs and on :func:`norm_stats_probe`, each
    held by :func:`norm_fwd_check` against the plain version; every
    planted fault (:func:`norm_fwd_faults`) must fail that check on one of
    the two; a row's bits must not depend on the call
    (:func:`norm_row_invariance`). Returns the checks by input, with the
    random inputs and the full call's outputs under "inputs" / "got"."""
    from unionml_tpu_torch.ops import fused_norm as fn

    def plain(x, r):
        if r is None:
            return {"y": fn.norm_fwd_plain(x, g, b, eps, rms)}
        return dict(zip(("s", "y"), fn.norm_add_fwd_plain(x, r, g, b, eps, rms)))

    dev = gen.device
    x = torch.randn(rows, d, device=dev, generator=gen).to(dtype)
    r = torch.randn(rows, d, device=dev, generator=gen).to(dtype) if add else None
    inputs = {"random": (x, r), "probe": norm_stats_probe(rows, d, dtype, gen, add)}
    checks, full = {}, None
    for kind, (xi, ri) in inputs.items():
        got = fwd(xi, ri)
        if full is None:
            full = got
        checks[kind] = norm_fwd_check(f"{name} {kind}", got, plain(xi, ri),
                                      norm_fwd_faults(xi, ri, g, b, eps, rms))
    for fault in checks["random"]:
        if fault.startswith("fault_") and not any(checks[k][fault]["fails"] for k in checks):
            raise AssertionError(f"{name}: the bit and row check passed the planted fault "
                                 f"{fault[6:]} on random inputs and on the probe")
    norm_row_invariance(name, fwd, x, r, full)
    return {"checks": checks, "inputs": (x, r), "got": full}


def log_norm_fwd_checks(name: str, checks: dict) -> None:
    for kind, chk in checks.items():
        faults = {k[6:]: (v["mismatch"], v["max_row_rel_err"], v["passes_norm_tol"])
                  for k, v in chk.items() if k.startswith("fault_")}
        log(f"  {name} {kind}: mismatch {chk.get('mismatch')} worst row "
            f"{chk['rows']['max_row_rel_err']}; faults (mismatch, worst row, passes "
            f"NORM_TOL): {faults}")


def vit_norm_cases(rows: int, d: int, gen: torch.Generator) -> dict:
    """Rows 3, 4 and 5 at the ViT-B shape (bf16 activations, fp32 gamma
    and beta, eps 1e-6, the LayerNorm mode): rows 3 and 4 through
    :func:`norm_fwd_cases`."""
    import torch.nn.functional as F

    from unionml_tpu_torch.ops import fused_norm as fn

    eps = 1e-6
    g = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
    b = 0.1 * torch.randn(d, device="cuda", generator=gen)
    gb, bb = g.bfloat16(), b.bfloat16()    # the library call's bf16 affine params
    shape = f"x[{rows},{d}] bf16, gamma/beta[{d}] fp32"
    n = rows * d

    fwd_cases = {}
    for name, fwd in (
        ("layer_norm_fwd", lambda x, r: {"y": fn.norm_fwd_cuda(x, g, b, eps, False)}),
        ("add_layer_norm_fwd",
         lambda x, r: dict(zip(("s", "y"), fn.norm_add_fwd_cuda(x, r, g, b, eps, False)))),
    ):
        fwd_cases[name] = norm_fwd_cases(name, fwd, rows, d, torch.bfloat16, g, b, eps, False,
                                         name.startswith("add"), gen)
        log_norm_fwd_checks(f"{name} {shape}", fwd_cases[name]["checks"])
    xl = fwd_cases["layer_norm_fwd"]["inputs"][0]
    x, r = fwd_cases["add_layer_norm_fwd"]["inputs"]
    s, ys = (fwd_cases["add_layer_norm_fwd"]["got"][k] for k in ("s", "y"))
    ln_err = check_close("layer_norm_fwd", fwd_cases["layer_norm_fwd"]["got"]["y"],
                         fn.norm_fwd_plain(xl, g, b, eps, False), NORM_TOL)
    add_err = check_close("add_layer_norm_fwd", ys, fn.norm_add_fwd_plain(x, r, g, b, eps, False)[1],
                          NORM_TOL)
    dy = torch.randn(rows, d, device="cuda", generator=gen).bfloat16()
    dx, dg, db = fn.norm_bwd_cuda(s, g, dy, eps, False, True)
    torch.cuda.synchronize()
    pdx, pdg, pdb = fn.norm_bwd_plain(s, g, dy, eps, False, True)
    names = ("dx", "dgamma", "dbeta")
    bwd_checks = check_norm_bwd("norm_bwd", dict(zip(names, (dx, dg, db))),
                                dict(zip(names, (pdx, pdg, pdb))),
                                norm_bwd_faults(s, g, dy, eps, False, True))
    bwd_err = max(bwd_checks[t]["max_abs_err"] for t in names)
    again = fn.norm_bwd_cuda(s, g, dy, eps, False, True)
    if not all(torch.equal(a, b) for a, b in zip((dx, dg, db), again)):
        raise AssertionError("norm_bwd: two runs differ")
    log(f"norm_bwd x[{rows},{d}]: {bwd_checks}")

    xr = s.detach().requires_grad_()
    w, wb = gb.detach().requires_grad_(), bb.detach().requires_grad_()
    lib_y = F.layer_norm(xr, (d,), w, wb, eps)
    cases = {}
    for name, err, run, plain, nbytes, ops, lib, call in (
        ("layer_norm_fwd", ln_err, lambda: fn.norm_fwd_cuda(xl, g, b, eps, False),
         lambda: fn.norm_fwd_plain(xl, g, b, eps, False), 2 * n * 2 + 2 * d * 4, 8 * n,
         lambda: F.layer_norm(xl, (d,), gb, bb, eps), "F.layer_norm, bf16 affine params"),
        ("add_layer_norm_fwd", add_err, lambda: fn.norm_add_fwd_cuda(x, r, g, b, eps, False),
         lambda: fn.norm_add_fwd_plain(x, r, g, b, eps, False), 4 * n * 2 + 2 * d * 4, 9 * n,
         lambda: F.layer_norm(x + r, (d,), gb, bb, eps), "x + r, then F.layer_norm"),
        ("norm_bwd", bwd_err, lambda: fn.norm_bwd_cuda(s, g, dy, eps, False, True),
         lambda: fn.norm_bwd_plain(s, g, dy, eps, False, True), 3 * n * 2 + 3 * d * 4, 15 * n,
         lambda: torch.autograd.grad(lib_y, (xr, w, wb), dy, retain_graph=True),
         "the backward of F.layer_norm (autograd.grad over a recorded forward)"),
    ):
        b_ms, b_by = bound(nbytes, ops, PEAK_FP32_OPS_S)
        cases[name] = [{
            "shape": shape, "max_abs_err": err, "ms": time_ms(run),
            "plain_ms": time_ms(plain, iters=5), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lib), "library_call": call,
        }]
    cases["norm_bwd"][0].update(checks=bwd_checks, rerun_same_bits=True)
    for name, case in fwd_cases.items():
        cases[name][0].update(checks=case["checks"], rows_invariant=True, rerun_same_bits=True)
    return cases


def fused_attention_case(b: int, s: int, h: int, d: int, gen) -> dict:
    """Rows 12 and 13 at one shape (non-causal, as ViT and BERT run them):
    each against its plain version, the backward twice (same bits), and
    the library yardsticks: SDPA forward (row 12), SDPA's backward alone
    (row 13) and SDPA forward + backward (rows 12 + 13)."""
    import torch.nn.functional as F

    from unionml_tpu_torch.ops import fused_attention as tfa

    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16()
                   for _ in range(4))
    q = q * float(torch.tensor(d**-0.5 * tfa.LOG2E, dtype=torch.bfloat16))
    fwd = lambda: tfa.fused_attention_fwd_cuda(q, k, v, causal=False)  # noqa: E731
    o = fwd()
    bwd = lambda: tfa.fused_attention_bwd_cuda(q, k, v, do, o, causal=False)  # noqa: E731
    grads, again = bwd(), bwd()
    torch.cuda.synchronize()
    want = dict(zip(("out", "dq", "dk", "dv"),
                    (tfa.fused_attention_fwd_plain(q, k, v, causal=False),
                     *tfa.fused_attention_bwd_plain(q, k, v, do, o, causal=False))))
    fault = dict(zip(want, skipped_chunk_fault(q, k, v, do, o, causal=False)))
    checks = check_fused_rows(f"fused_attention S={s}", dict(zip(want, (o, *grads))), want,
                              fault)
    del want, fault
    for name, got, same in zip(("dq", "dk", "dv"), grads, again):
        if not torch.equal(got, same):
            raise AssertionError(f"fused_attention_bwd {name}: two runs differ")
    fwd_err = checks["out"]["max_abs_err"]
    bwd_err = max(checks[name]["max_abs_err"] for name in ("dq", "dk", "dv"))
    numel = q.numel()
    pairs = b * h * s * s
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    lq, lk, lv = (t.detach().requires_grad_() for t in (qt, kt, vt))
    lib_o = F.scaled_dot_product_attention(lq, lk, lv)

    def lib_fwd_bwd():
        out = F.scaled_dot_product_attention(lq, lk, lv)
        return torch.autograd.grad(out, (lq, lk, lv), dot)

    shape = f"q/k/v[{b},{s},{h},{d}] bf16, non-causal"
    f_ms, fb_ms = bound(4 * numel * 2, 4 * pairs * d, PEAK_BF16_OPS_S)
    b_ms, bb_ms = bound(8 * numel * 2, 10 * pairs * d, PEAK_BF16_OPS_S)
    fwd_case = {
        "shape": shape, "max_abs_err": fwd_err, "row_checks": {"out": checks["out"]},
        "ms": time_ms(fwd),
        "plain_ms": time_ms(lambda: tfa.fused_attention_fwd_plain(q, k, v, causal=False),
                            iters=3),
        "bound_ms": f_ms, "bound_by": fb_ms,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
        "library_call": "F.scaled_dot_product_attention",
    }
    bwd_case = {
        "shape": shape, "max_abs_err": bwd_err,
        "row_checks": {name: checks[name] for name in ("dq", "dk", "dv")},
        "ms": time_ms(bwd),
        "plain_ms": time_ms(lambda: tfa.fused_attention_bwd_plain(q, k, v, do, o, causal=False),
                            iters=3),
        "bound_ms": b_ms, "bound_by": bb_ms,
        "library_ms": time_ms(lambda: torch.autograd.grad(lib_o, (lq, lk, lv), dot,
                                                          retain_graph=True)),
        "library_call": "the backward of F.scaled_dot_product_attention (autograd.grad "
                        "over a recorded forward)",
        "fwd_bwd_ms": time_ms(lambda: (fwd(), bwd())),
        "library_fwd_bwd_ms": time_ms(lib_fwd_bwd),
    }
    return {"fused_attention_fwd": fwd_case, "fused_attention_bwd": bwd_case}


def vit_kernel_phase() -> dict:
    """Rows 3, 4, 5, 12, 13 at the ViT-B shapes; rows 12-13 also at
    S = 512 (BERT-base) and 1024 (the fused limit)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = vit_norm_cases(VIT_B * VIT_S, VIT_D, gen)
    for b, s in ((VIT_B, VIT_S), (16, 512), (8, 1024)):
        for name, case in fused_attention_case(b, s, VIT_H, VIT_HD, gen).items():
            out.setdefault(name, []).append(case)
    for name, cases in out.items():
        for c in cases:
            log(f"kernel {name} {c['shape']}: max_abs_err {c['max_abs_err']} ms {c['ms']} "
                f"plain_ms {c['plain_ms']} bound_ms {c['bound_ms']} ({c['bound_by']}) "
                f"library_ms {c['library_ms']}"
                + (f" fwd+bwd ms {c['fwd_bwd_ms']} library fwd+bwd ms "
                   f"{c['library_fwd_bwd_ms']}" if "fwd_bwd_ms" in c else ""))
            log_row_checks(c.get("row_checks", {}))
    return out


# --------------------------------------------------------------------- #
# ViT-B/16 training
# --------------------------------------------------------------------- #

# per training step of ViT-B/16 with norm_impl="fused" and attn_impl="fused":
# ln1 x 12 + ln_final, ln2 (add form) x 12, their backwards, attention x 12
VIT_LAUNCHES_PER_STEP = {"layer_norm_fwd": 13, "add_layer_norm_fwd": 12, "norm_bwd": 25,
                         "fused_attention_fwd": 12, "fused_attention_bwd": 12}
VIT_GRAD_COSINE_MIN = 0.99   # bf16 kernel path vs bf16 plain path, per gradient tensor


def vit_kernels() -> dict:
    """The wrappers (launch counters) of the ViT training path's kernels."""
    from unionml_tpu_torch.ops import fused_attention as tfa
    from unionml_tpu_torch.ops import fused_norm as fn

    return {"layer_norm_fwd": fn.LN_KERNEL, "add_layer_norm_fwd": fn.ADD_KERNEL,
            "norm_bwd": fn.BWD_KERNEL, "fused_attention_fwd": tfa.FWD_KERNEL,
            "fused_attention_bwd": tfa.BWD_KERNEL}


def vit_batches(config, batch: int, count: int, device: str, seed: int) -> list:
    """``count`` batches of random images with the template's learnable
    labels (channel mean above 0), made from a numpy seed."""
    rng = np.random.default_rng(seed)
    size = config.image_size
    out = []
    for _ in range(count):
        images = torch.from_numpy(rng.normal(size=(batch, size, size, 3)).astype(np.float32))
        out.append((images.to(device), (images.mean(dim=(1, 2, 3)) > 0).long().to(device)))
    return out


def path_agreement(name: str, module_cls, kernel_cfg, plain_cfg, loss, step_factory, params,
                   batches, *, lr: float, cosine_min: float) -> dict:
    """One step's loss and gradients of ``module_cls(kernel_cfg)`` against
    ``module_cls(plain_cfg)`` from the same ``params`` and first batch
    (``loss(outputs, labels)``; per-tensor cosine at least
    ``cosine_min``), then two runs of ``step_factory(module)`` over all
    ``batches`` from one AdamW state, whose losses must be the same bits
    (the kernels use no atomics)."""
    import torch.nn.functional as F

    from unionml_tpu_torch.models import TrainState, adamw
    from unionml_tpu_torch.models.train import tree_leaves, value_and_grad

    results = {}
    for path, cfg in (("kernel", kernel_cfg), ("plain", plain_cfg)):
        module = module_cls(cfg)

        def loss_fn(p, b, module=module):
            return loss(module(p, b[0]), b[1]), {}

        (value, _), grads = value_and_grad(loss_fn, params, batches[0])
        results[path] = (float(value), [g.float().flatten() for g in tree_leaves(grads)])
        del grads
    (k_loss, k_grads), (p_loss, p_grads) = results["kernel"], results["plain"]
    cosines = [float(F.cosine_similarity(a, b, dim=0)) for a, b in zip(k_grads, p_grads)]
    if not all(np.isfinite([k_loss, p_loss])) or min(cosines) < cosine_min:
        raise AssertionError(
            f"{name} kernel-path gradients disagree with the plain path: losses {k_loss} vs "
            f"{p_loss}, min per-tensor cosine {min(cosines)}"
        )
    del results, k_grads, p_grads

    step = step_factory(module_cls(kernel_cfg))
    runs = []
    for _ in range(2):
        state = TrainState.create(apply_fn=module_cls(kernel_cfg), params=params, tx=adamw(lr))
        losses = []
        for b in batches:
            state, metrics = step(state, b)
            losses.append(metrics["loss"])
        runs.append((torch.stack(losses), state.params))
    same_losses = torch.equal(runs[0][0], runs[1][0])
    same_params = all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])))
    losses = runs[0][0].tolist()
    if not same_losses:
        raise AssertionError(
            f"two {len(batches)}-step runs from one state gave different losses: {losses} vs "
            f"{runs[1][0].tolist()}"
        )
    out = {"kernel_loss": k_loss, "plain_loss": p_loss, "min_grad_cosine": min(cosines),
           "grad_tensors": len(cosines), "rerun_losses": losses,
           "rerun_same_loss_bits": same_losses, "rerun_same_param_bits": same_params}
    log(f"{name}: one step, kernel path vs plain path: loss {k_loss} vs {p_loss}, min cosine "
        f"over {len(cosines)} gradient tensors {min(cosines)}; two {len(batches)}-step runs: "
        f"losses {losses}, same loss bits {same_losses}, same param bits {same_params}")
    return out


def vit_grad_agreement(config, *, device: str = "cuda", batch: int = 64) -> dict:
    """One step's loss and gradients of ``config`` (kernel path) against the
    plain path (``attn_impl`` and ``norm_impl`` "xla") from the same params
    and batch on ``device`` (per-tensor cosine), then two 3-step runs of the
    kernel path's ``classification_step`` from one state, whose losses must
    be the same bits (the backward has no atomics)."""
    import torch.nn.functional as F

    from unionml_tpu_torch.models import ViT, classification_step, init_vit_params

    gen = torch.Generator(device=device).manual_seed(5)
    return path_agreement(
        "vit", ViT, config, dataclasses.replace(config, attn_impl="xla", norm_impl="xla"),
        lambda logits, labels: F.cross_entropy(logits.float(), labels), classification_step,
        init_vit_params(config, generator=gen, device=device),
        vit_batches(config, batch, 3, device, seed=5), lr=3e-4, cosine_min=VIT_GRAD_COSINE_MIN,
    )


def marked_training(build, kernels: dict, *, steps: int, warmup: int, on_card: bool,
                    **train_kwargs) -> dict:
    """``build(on_step).train(**train_kwargs)``, with the host clock, the
    ``kernels``' launch counts and the peak memory marked after step
    ``warmup`` and after the last of ``steps`` (each after a wait for the
    card). Returns the trained state and metrics, the per-step losses, the
    wall time, step ms and launches per step over the timed steps, the
    run's launches, the peak memory and the trainer's samples/sec gauge."""
    from unionml_tpu_torch import telemetry

    marks = {}
    losses = []

    def counts():
        return {name: k.launches for name, k in kernels.items()}

    def on_step(state, metrics):
        losses.append(metrics["loss"])
        if state.step in (warmup, steps):
            if on_card:
                torch.cuda.synchronize()
            marks[state.step] = (time.perf_counter(), counts(),
                                 torch.cuda.max_memory_allocated() if on_card else None)

    model = build(on_step)
    for k in kernels.values():
        k.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = model.train(**train_kwargs)
    wall_s = time.perf_counter() - t0
    if len(losses) != steps or set(marks) != {warmup, steps}:
        raise AssertionError(f"the trainer ran {len(losses)} steps, expected {steps}")
    (t_a, c_a, _), (t_b, c_b, peak) = marks[warmup], marks[steps]
    timed = steps - warmup
    losses = torch.stack(losses).float().tolist()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    return {
        "state": state, "eval": metrics, "losses": losses, "wall_s": wall_s, "timed_steps": timed,
        "step_ms": (t_b - t_a) / timed * 1e3, "launches": counts(),
        "launches_per_step": {name: (c_b[name] - c_a[name]) / timed for name in kernels},
        "peak_mem_gib": peak / 2**30 if on_card else None,
        "samples_per_sec_gauge": telemetry.get_registry().gauge(
            "unionml_trainer_samples_per_sec").value,
    }


def vit_train_phase(config, *, device: str = "cuda", batch: int = 64,
                    batches_per_epoch: int = 18, epochs: int = 3, warmup: int = 2) -> dict:
    """Train ``config`` through the ported vision_tpu template
    (``build_model``, ``@model.train_step``, ``model.train``) on synthetic
    images with learnable labels: ``epochs`` x ``batches_per_epoch`` steps
    of ``batch`` (54 steps by default, so the trainer's 50-step throughput
    window closes and sets the ``unionml_trainer_samples_per_sec`` gauge).
    The steps after the first ``warmup`` are timed (host clock between two
    waits for the card); the kernels' launches per timed step must be
    :data:`VIT_LAUNCHES_PER_STEP` and the last loss below the first."""
    from unionml_tpu_torch.templates.vision_tpu.app import build_model

    on_card = device == "cuda"
    steps = batches_per_epoch * epochs
    run = marked_training(
        lambda on_step: build_model(config, name="chip_smoke_vit", reader_cache=False,
                                    on_step=on_step),
        vit_kernels(), steps=steps, warmup=warmup, on_card=on_card,
        hyperparameters={"device": device, "learning_rate": 3e-4},
        # the template's split keeps 80% for training
        trainer_kwargs={"num_epochs": epochs, "batch_size": batch},
        n=batch * batches_per_epoch * 5 // 4, seed=0,
    )
    del run["state"]
    step_ms, per_step, gauge = run["step_ms"], run["launches_per_step"], run[
        "samples_per_sec_gauge"]
    losses = run["losses"]
    out = {
        "config": f"ViT patch {config.patch_size}, image {config.image_size}, width "
                  f"{config.hidden_dim}, {config.num_layers} layers, {config.num_heads} heads, "
                  f"mlp {config.mlp_dim}, {config.num_classes} classes, {config.dtype} compute, "
                  f"fp32 params, attn {config.attn_impl}, norm {config.norm_impl}",
        "batch": batch, "steps": steps, "samples_per_s": batch / step_ms * 1e3,
        "first_loss": losses[0], "last_loss": losses[-1], **run,
    }
    log(f"vit: {steps} steps of batch {batch} ({warmup} warm-up): step_ms {step_ms} "
        f"samples/s {out['samples_per_s']} gauge unionml_trainer_samples_per_sec {gauge} "
        f"peak memory {out['peak_mem_gib']} GiB, wall {out['wall_s']} s (reader, split, "
        f"evaluation included)")
    log(f"vit: loss first {losses[0]} last {losses[-1]}; eval {out['eval']}; launches per "
        f"timed step {per_step}; launches in the run {out['launches']}")
    if on_card:
        if per_step != VIT_LAUNCHES_PER_STEP:
            raise AssertionError(f"ViT kernel launches per step {per_step}, expected "
                                 f"{VIT_LAUNCHES_PER_STEP}")
        if not gauge > 0:
            raise AssertionError("the trainer set no unionml_trainer_samples_per_sec gauge")
    return out


# --------------------------------------------------------------------- #
# long-context Llama training (llama_lc)
# --------------------------------------------------------------------- #

# the Llama phase trains LlamaConfig.llama_lc() (benchmarks/train_throughput.py's
# long-context Llama, RMSNorm in plain PyTorch as there) on batches of
# 2 x 4096 tokens, AdamW at lr 1e-3
LM_GRAD_COSINE_MIN = 0.99    # bf16 kernel path vs bf16 plain (xla attention) path, per tensor
# rows 9-11 against their plain versions, row by row: max |kernel - plain|
# over the row's max |plain| (query rows for out and dq, key rows for dk
# and dv). Under causal attention the scale of a row falls with the number
# of positions it averages, so a whole-tensor scale would hide late rows.
# 2e-2 is ~2.5 bf16 ulps of the row's largest entry: one ulp of output
# rounding plus p and ds rounded at other points in fp32 sums of another
# order.
FLASH_ROW_LIMIT = 2e-2
LSE_TOL = dict(rtol=1e-5, atol=1e-4)   # fp32 statistics, exp and sums in another order
# the key tile of the planted fault: the dq kernel's key tile (the dk/dv
# kernel's query stages are 64 rows too; the forward's key tiles are 128);
# a kernel one 128-key tile short fails the same check
FLASH_TILE = 64


def dropped_tile_fault(q, k, v, do, out, lse, *, causal: bool, scale: float):
    """A planted fault the row check must reject: the plain forward and
    backward with each query's last visible key tile skipped (for queries
    that see more than one tile), as a kernel with its key loop one tile
    short would compute. ``(out, dq, dk, dv)``; the backward recomputes on
    the given ``out`` and ``lse``, as the kernels do."""
    from unionml_tpu_torch.ops import flash_attention as fa

    q_len, kv_len = q.shape[1], k.shape[1]
    rows = torch.arange(q_len, device=q.device)
    last = (rows + (kv_len - q_len)).clamp(0, kv_len - 1) if causal else \
        torch.full_like(rows, kv_len - 1)
    last_tile = (last // FLASH_TILE)[:, None]
    key_tile = (torch.arange(kv_len, device=q.device) // FLASH_TILE)[None, :]
    vis = fa._causal_visible(q_len, kv_len, q.device) if causal else \
        torch.ones(q_len, kv_len, dtype=torch.bool, device=q.device)
    vis = vis & ~((key_tile == last_tile) & (last_tile > 0))
    bad_out = fa._plain_forward(q, k, v, vis, scale)[0]
    return (bad_out, *fa._plain_backward(q, k, v, do, out, lse, vis, scale))


def check_flash_rows(name: str, got: dict, want: dict, fault: dict) -> dict:
    """Rows 9-11 (out, dq, dk, dv) row by row within
    :data:`FLASH_ROW_LIMIT`; the dropped-tile fault must fail."""
    return check_rows_with_fault(name, got, want, fault,
                                 dict.fromkeys(("out", "dq", "dk", "dv"), FLASH_ROW_LIMIT),
                                 "the last visible key tile skipped")


def lm_kernels() -> dict:
    """The wrappers (launch counters) of the Llama training path's kernels."""
    from unionml_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.FWD_KERNEL, "flash_bwd_dq": fa.DQ_KERNEL,
            "flash_bwd_dkv": fa.DKV_KERNEL}


def _visible_pairs(q_len: int, kv_len: int, causal: bool) -> int:
    """(query, key) pairs one head attends over (bottom-right causal)."""
    if not causal:
        return q_len * kv_len
    off = kv_len - q_len
    return sum(min(kv_len, max(0, i + off + 1)) for i in range(q_len))


def flash_train_case(b: int, sq: int, skv: int, h: int, kvh: int, d: int, causal: bool,
                     gen) -> dict:
    """Rows 9, 10 and 11 at one shape: the lse forward against its plain
    version (out and lse), the dq and dk/dv kernels against the plain
    backward on the kernel's own out and lse, the forward and the backward
    each run twice (the same bits); times of each kernel, the plain versions, the bounds and
    the SDPA yardsticks (its forward for row 9, its backward alone for
    rows 10 and 11, and forward + backward against rows 9-11's total)."""
    import torch.nn.functional as F

    from unionml_tpu_torch.ops import flash_attention as fa

    scale = d**-0.5
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).bfloat16()
    k = torch.randn(b, skv, kvh, d, device="cuda", generator=gen).bfloat16()
    v = torch.randn(b, skv, kvh, d, device="cuda", generator=gen).bfloat16()
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen).bfloat16()
    kw = dict(causal=causal, scale=scale)
    fwd = lambda: fa.flash_fwd_cuda(q, k, v, **kw)  # noqa: E731
    (out, lse), (out_again, lse_again) = fwd(), fwd()
    delta = fa.flash_delta(do, out)
    dq_run = lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)  # noqa: E731
    dkv_run = lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)  # noqa: E731
    grads, again = (dq_run(), *dkv_run()), (dq_run(), *dkv_run())
    torch.cuda.synchronize()
    name = f"flash b={b} sq={sq} skv={skv} h={h}/{kvh} d={d} causal={causal}"
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, **kw)
    check_close(f"{name} lse", lse, want_lse, LSE_TOL)
    want = dict(zip(("out", "dq", "dk", "dv"),
                    (want_out, *fa.flash_bwd_plain(q, k, v, do, out, lse, **kw))))
    fault = dict(zip(want, dropped_tile_fault(q, k, v, do, out, lse, **kw)))
    checks = check_flash_rows(name, dict(zip(want, (out, *grads))), want, fault)
    if not (torch.equal(out, out_again) and torch.equal(lse, lse_again)):
        raise AssertionError(f"{name}: two forward runs differ")
    del out_again, lse_again
    for g_name, got, same in zip(("dq", "dk", "dv"), grads, again):
        if not torch.equal(got, same):
            raise AssertionError(f"{name} {g_name}: two backward runs differ")
    errs = {t_name: c["max_abs_err"] for t_name, c in checks.items()}
    del want, want_out, want_lse, fault
    # work these inputs need: every visible (query, key) pair of every head
    pairs = b * h * _visible_pairs(sq, skv, causal)
    q_bytes, kv_bytes, stat_bytes = q.numel() * 2, k.numel() * 2, b * h * sq * 4
    bounds = {
        "flash_fwd": bound(2 * q_bytes + 2 * kv_bytes + stat_bytes,          # q, out, k, v, lse
                           4 * pairs * d, PEAK_BF16_OPS_S),
        "flash_bwd_dq": bound(3 * q_bytes + 2 * kv_bytes + 2 * stat_bytes,   # q, do, dq, k, v
                              6 * pairs * d, PEAK_BF16_OPS_S),
        "flash_bwd_dkv": bound(2 * q_bytes + 4 * kv_bytes + 2 * stat_bytes,  # q, do, k, v, dk, dv
                               8 * pairs * d, PEAK_BF16_OPS_S),
    }
    plain_fwd_ms = time_ms(lambda: fa.flash_fwd_plain(q, k, v, **kw), iters=3, warmup=1)
    plain_bwd_ms = time_ms(lambda: fa.flash_bwd_plain(q, k, v, do, out, lse, **kw), iters=3,
                           warmup=1)
    # yardsticks: SDPA over [B, H, S, D] (top-left causal alignment, the
    # same as bottom-right for equal lengths; unequal lengths get a mask)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    mask = None
    if causal and sq != skv:
        mask = torch.ones(sq, skv, dtype=torch.bool, device="cuda").tril(skv - sq)
    sdpa_kw = dict(attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)
    lq, lk, lv = (t.detach().requires_grad_() for t in (qt, kt, vt))
    lib_o = F.scaled_dot_product_attention(lq, lk, lv, **sdpa_kw)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(lq, lk, lv, **sdpa_kw)
        return torch.autograd.grad(o, (lq, lk, lv), dot)

    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(lib_o, (lq, lk, lv), dot, retain_graph=True))
    shape = f"q[{b},{sq},{h},{d}] kv[{b},{skv},{kvh},{d}] bf16, causal={causal}"
    fwd_ms = time_ms(fwd)
    cases = {
        "flash_fwd": {"max_abs_err": errs["out"], "ms": fwd_ms, "plain_ms": plain_fwd_ms,
                      "tflop_s": 4 * pairs * d / fwd_ms / 1e9, "rerun_same_bits": True,
                      "library_ms": time_ms(
                          lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)),
                      "library_call": "F.scaled_dot_product_attention(enable_gqa) forward",
                      "row_checks": {"out": checks["out"]}},
        "flash_bwd_dq": {"max_abs_err": errs["dq"], "ms": time_ms(dq_run),
                         "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms,
                         "row_checks": {"dq": checks["dq"]}},
        "flash_bwd_dkv": {"max_abs_err": max(errs["dk"], errs["dv"]), "ms": time_ms(dkv_run),
                          "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms,
                          "row_checks": {"dk": checks["dk"], "dv": checks["dv"]}},
    }
    for row, case in cases.items():
        case.update(shape=shape, bound_ms=bounds[row][0], bound_by=bounds[row][1])
        if row != "flash_fwd":
            case["plain_call"] = "flash_bwd_plain (dq, dk and dv together)"
            case["library_call"] = ("the backward of F.scaled_dot_product_attention(enable_gqa) "
                                    "alone (dq, dk and dv together; autograd.grad over a "
                                    "recorded forward)")
    total = lambda: (fwd(), fa.flash_bwd_cuda(q, k, v, do, out, lse, **kw))  # noqa: E731
    cases["flash_bwd_dkv"]["fwd_bwd_ms"] = time_ms(total)
    cases["flash_bwd_dkv"]["library_fwd_bwd_ms"] = time_ms(lib_fwd_bwd)
    return cases


def flash_train_kernel_phase() -> dict:
    """Rows 9-11 at the llama_lc training shape (S = 4095: lm_step trains
    on tokens[:, :-1]), at the Llama-3-8B head geometry, and at small
    non-causal and cross-length shapes."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for shape in ((2, 4095, 4095, 12, 4, 64, True), (1, 2048, 2048, 32, 8, 128, True),
                  (2, 200, 200, 4, 2, 64, False), (2, 40, 200, 4, 2, 64, True)):
        for name, case in flash_train_case(*shape, gen).items():
            out.setdefault(name, []).append(case)
    for name, cases in out.items():
        for c in cases:
            log(f"kernel {name} {c['shape']}: max_abs_err {c['max_abs_err']} ms {c['ms']} "
                f"plain_ms {c['plain_ms']} bound_ms {c['bound_ms']} ({c['bound_by']}) "
                f"library_ms {c['library_ms']}"
                + (f" TFLOP/s {c['tflop_s']}" if "tflop_s" in c else "")
                + (f" rows 9-11 ms {c['fwd_bwd_ms']} library fwd+bwd ms "
                   f"{c['library_fwd_bwd_ms']}" if "fwd_bwd_ms" in c else ""))
            log_row_checks(c["row_checks"])
    return out


def lm_tokens(n: int, seq: int, vocab: int, seed: int) -> np.ndarray:
    """``n`` token sequences of ``seq`` ids with a learnable structure:
    strided progressions mod ``vocab`` (a random start and a stride in
    [1, 16) per row), from a numpy seed."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(n, 1))
    stride = rng.integers(1, 16, size=(n, 1))
    return (start + stride * np.arange(seq)[None]) % vocab


def build_lm_app(config, *, name: str, on_step=None, eval_batch: int = 2):
    """The LM app's Dataset/Model spec for ``config``: the reader makes
    ``n`` sequences of ``seq`` tokens and returns the shifted pairs
    (``features = tokens[:, :-1]``, ``targets = tokens[:, 1:]``), a seeded
    splitter cuts them, the parser returns the pair; the Model's ``init=``
    builds an AdamW ``TrainState`` of ``Llama(config)`` on the ``device``
    hyperparameter (``None`` = CUDA), ``@model.train_step`` runs
    ``lm_step`` on the ``(inputs, labels)`` batches the trainer feeds, and
    the evaluator returns the mean cross entropy (``eval_batch`` rows at a
    time). ``on_step(state, metrics)`` is called after every step."""
    from typing import Optional

    from unionml_tpu_torch import Dataset, Model
    from unionml_tpu_torch._device import resolve_device
    from unionml_tpu_torch.models import (
        Llama,
        TrainState,
        create_train_state,
        lm_step,
        masked_cross_entropy,
    )

    module = Llama(config)
    dataset = Dataset(name=f"{name}_dataset", test_size=0.2)

    @dataset.reader
    def reader(n: int = 64, seq: int = 4096, seed: int = 0) -> dict:
        tokens = lm_tokens(n, seq, config.vocab_size, seed)
        return {"features": tokens[:, :-1], "targets": tokens[:, 1:]}

    @dataset.splitter
    def splitter(data: dict, test_size: float, shuffle: bool, random_state: int):
        idx = np.arange(len(data["features"]))
        if shuffle:
            np.random.default_rng(random_state).shuffle(idx)
        cut = int(len(idx) * (1 - test_size))
        return ({key: val[idx[:cut]] for key, val in data.items()},
                {key: val[idx[cut:]] for key, val in data.items()})

    @dataset.parser
    def parser(data: dict, features, targets):
        return (data["features"], data["targets"])

    def init(learning_rate: float = 1e-3, device: Optional[str] = None) -> TrainState:
        example = torch.zeros(1, 8, dtype=torch.long, device=resolve_device(device))
        return create_train_state(module, example, learning_rate=learning_rate)

    model = Model(name=name, init=init, dataset=dataset)
    step = lm_step(module)

    @model.train_step
    def train_step(state, batch):
        state, metrics = step(state, batch)
        if on_step is not None:
            on_step(state, metrics)
        return state, metrics

    @model.evaluator
    def evaluator(state: TrainState, features: np.ndarray, targets: np.ndarray) -> float:
        device = state.params["lm_head"]["kernel"].device
        total = 0.0
        with torch.no_grad():
            for i in range(0, len(features), eval_batch):
                x = torch.as_tensor(features[i:i + eval_batch], device=device)
                y = torch.as_tensor(targets[i:i + eval_batch], device=device)
                total += float(masked_cross_entropy(module(state.params, x), y)) * len(x)
        return total / len(features)

    return model


def lm_train_phase(config, *, device: str = "cuda", batch: int = 2, seq: int = 4096,
                   batches_per_epoch: int = 18, epochs: int = 3, warmup: int = 2) -> dict:
    """Train ``config`` through the LM app's ``model.train``
    (``@model.train_step`` -> ``run_step_trainer`` -> ``lm_step``) on
    strided token sequences: ``epochs`` x ``batches_per_epoch`` steps of
    ``batch`` sequences of ``seq`` tokens (54 steps by default, so the
    trainer's 50-step window sets ``unionml_trainer_samples_per_sec``).
    The steps after the first ``warmup`` are timed (host clock between two
    waits for the card); rows 9, 10 and 11 must launch once per layer per
    timed step (the forward twice under ``remat``) and the last loss must
    be below the first."""
    from unionml_tpu_torch.models.train import tree_leaves

    on_card = device == "cuda"
    steps = batches_per_epoch * epochs
    run = marked_training(
        lambda on_step: build_lm_app(config, name="chip_smoke_llama", on_step=on_step),
        lm_kernels(), steps=steps, warmup=warmup, on_card=on_card,
        hyperparameters={"device": device, "learning_rate": 1e-3},
        # the splitter keeps 80% for training
        trainer_kwargs={"num_epochs": epochs, "batch_size": batch},
        n=batch * batches_per_epoch * 5 // 4, seq=seq, seed=0,
    )
    n_params = sum(p.numel() for p in tree_leaves(run.pop("state").params))
    step_ms, per_step, gauge = run["step_ms"], run["launches_per_step"], run[
        "samples_per_sec_gauge"]
    losses = run["losses"]
    out = {
        "config": f"Llama vocab {config.vocab_size}, width {config.hidden_dim}, "
                  f"{config.num_layers} layers, {config.num_heads}/{config.num_kv_heads} heads, "
                  f"mlp {config.mlp_dim}, {config.dtype} compute, fp32 params and LM head, "
                  f"attn {config.attn_impl}, norm {config.norm_impl}, remat {config.remat}",
        "params": n_params, "batch": batch, "seq": seq, "steps": steps,
        "tokens_per_s": batch * (seq - 1) / step_ms * 1e3,
        "first_loss": losses[0], "last_loss": losses[-1], **run,
    }
    log(f"llama: {n_params} params, {steps} steps of {batch} x {seq} tokens ({warmup} warm-up): "
        f"step_ms {step_ms} tokens/s {out['tokens_per_s']} gauge "
        f"unionml_trainer_samples_per_sec {gauge} peak memory {out['peak_mem_gib']} GiB, wall "
        f"{out['wall_s']} s (reader, split, evaluation included)")
    log(f"llama: loss first {losses[0]} last {losses[-1]}; eval {out['eval']}; launches per "
        f"timed step {per_step}; launches in the run {out['launches']}")
    if on_card:
        layers = float(config.num_layers)
        want = {"flash_fwd": layers * (2 if config.remat else 1), "flash_bwd_dq": layers,
                "flash_bwd_dkv": layers}
        if per_step != want:
            raise AssertionError(f"Llama kernel launches per step {per_step}, expected {want}")
        if not gauge > 0:
            raise AssertionError("the trainer set no unionml_trainer_samples_per_sec gauge")
    return out


def lm_grad_agreement(config, *, device: str = "cuda", batch: int = 2, seq: int = 4096,
                      layers: int = 2) -> dict:
    """One step's loss and gradients of ``config`` cut to ``layers`` layers
    (kernel path) against the plain path (``attn_impl="xla"``: full fp32
    scores) from the same params and batch on ``device`` (per-tensor
    cosine), then two 3-step ``lm_step`` runs of the kernel path from one
    state, whose losses must be the same bits (no atomics)."""
    from unionml_tpu_torch.models import Llama, init_params, lm_step, masked_cross_entropy

    config = dataclasses.replace(config, num_layers=layers)
    params = init_params(config, seed=5, device=device)
    tokens = torch.from_numpy(lm_tokens(3 * batch, seq, config.vocab_size, seed=5)).to(device)
    out = path_agreement(
        f"llama ({layers} layers)", Llama, config, dataclasses.replace(config, attn_impl="xla"),
        masked_cross_entropy, lm_step, params,
        [(t[:, :-1], t[:, 1:]) for t in tokens.split(batch)], lr=1e-3,
        cosine_min=LM_GRAD_COSINE_MIN,
    )
    return {"layers": layers, **out}


def kernel_phase(batch: int, bucket: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    # row 2 at the micro-batcher's prefill and decode and the paged
    # engine's 16-slot decode step
    norms = [norm_case(batch * bucket, 4096, gen), norm_case(batch, 4096, gen),
             norm_case(16, 4096, gen)]
    flashes = [
        flash_case(batch, bucket, 32, 8, 128, [0, 17, 333, bucket - 24][:batch], gen),
        flash_case(1, 4096, 32, 8, 128, [0], gen),
    ]
    # the engine's decode step: 16 slots, Llama-3-8B heads, block 16,
    # table width of a 1024-bucket engine with 64 new tokens
    pageds = [paged_case(16, 32, 8, 128, 16, 73, int8, gen) for int8 in (False, True)]
    # the 0.3B draft's prefill (head_dim 64) through the flash kernel
    flashes.append(flash_case(batch, 256, 16, 8, 64, [0, 17, 100, 200][:batch], gen))
    # int4 at Llama-3-8B shapes: per-channel at the speculative verify's
    # 40 rows (8 slots x 5), grouped at the paged engine's 16-slot decode;
    # q/o, k/v, gate/up, down and the fp32 LM head (tile 256). Planted
    # faults: per-channel at q/o and k/v (the narrowest grid, 8 K-slices),
    # grouped at every bf16 shape; the grouped rounding probe at q/o and the
    # LM head. The 4-row LM-head cases are extras, off the main paths.
    bf16, fp32 = torch.bfloat16, torch.float32
    per_channel = [int4_case(40, 4096, 4096, 0, bf16, gen, faults=True),
                   int4_case(40, 4096, 1024, 0, bf16, gen, faults=True),
                   int4_case(40, 4096, 14336, 0, bf16, gen),
                   int4_case(40, 14336, 4096, 0, bf16, gen), int4_case(40, 4096, 128256, 0, fp32, gen),
                   int4_case(4, 4096, 128256, 0, fp32, gen)]
    grouped = [int4_case(16, k, n, 128, bf16, gen, faults=True)
               for k, n in ((4096, 14336), (14336, 4096), (4096, 4096), (4096, 1024))]
    grouped += [int4_case(16, 4096, 128256, 128, fp32, gen),
                int4_case(4, 4096, 128256, 128, fp32, gen)]
    grouped[0]["rounding_probe"] = int4_rounding_cases(gen)
    out = {"rms_norm_fwd": norms, "flash_fwd_padded": flashes, "paged_attention": pageds,
           "int4_matmul": per_channel, "int4_matmul_grouped": grouped}
    for name, cases in out.items():
        for c in cases:
            log(f"kernel {name} {c['shape']}: max_abs_err {c['max_abs_err']} "
                f"ms {c['ms']} plain_ms {c['plain_ms']} bound_ms {c['bound_ms']} "
                f"({c['bound_by']}) library_ms {c['library_ms']}"
                + (f" TFLOP/s {c['tflop_s']}" if "tflop_s" in c else "")
                + (f" ms_cold {c['ms_cold']} library_ms_cold {c['library_ms_cold']}"
                   if "ms_cold" in c else ""))
            log_row_checks(c.get("row_checks", {}))
    count = event_wait_releases_gil()
    log(f"kernels: main-thread loop iterations during a CUDA event wait: {count}")
    if count < 10_000:
        raise AssertionError(
            f"waiting on a CUDA event held the interpreter lock ({count} iterations)"
        )
    return out


# --------------------------------------------------------------------- #
# main path
# --------------------------------------------------------------------- #


def post(url: str, payload: dict, timeout: float = 600.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def logits_agreement(config, params, device: str) -> float:
    """Cosine similarity of the prefill logits of the kernel path
    (flash + fused) and the plain path (cached attention + plain norm) of
    the same weights on a small left-padded batch."""
    from unionml_tpu_torch.models import Llama, init_cache

    plain_cfg = dataclasses.replace(config, prefill_impl="cached", norm_impl="xla")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(1, config.vocab_size, size=(2, 64))).to(device)
    mask = torch.ones(2, 64, dtype=torch.bool, device=device)
    mask[1, :20] = False
    pad = 64 - mask.sum(1)
    positions = torch.clamp(torch.arange(64, device=device)[None] - pad[:, None], min=0)
    kv_mask = torch.cat([mask, torch.ones(2, 8, dtype=torch.bool, device=device)], 1)
    outs = []
    with torch.inference_mode():
        for cfg, full in ((config, True), (plain_cfg, False)):
            cache = init_cache(cfg, 2, 72, device=device)
            logits, _ = Llama(cfg)(
                params, tokens, positions=positions, cache=cache, cache_index=0,
                kv_mask=kv_mask, logit_index=torch.full((2,), 63, device=device),
                full_prefill=full,
            )
            outs.append(logits[:, -1].float())
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("prefill logits are not finite")
    return float(torch.nn.functional.cosine_similarity(outs[0], outs[1], dim=-1).min())


def serving_config(config):
    """The template's serving knobs: int8 weights, flash prefill, fused
    norm (the paged decode attention is ``paged_impl="auto"``)."""
    return dataclasses.replace(
        config, quantized=True, prefill_impl="flash", norm_impl="fused", paged_impl="auto"
    )


def build_template(config, max_new_tokens: int, buckets: tuple, device: str):
    """The ported llm_serving template's Model at ``config`` and its
    trained (random, seeded) weights on ``device``."""
    from unionml_tpu_torch.templates.llm_serving.app import build_model

    model = build_model(
        config, name="chip_smoke", max_new_tokens=max_new_tokens, bucket_lens=buckets
    )
    t0 = time.perf_counter()
    params, _ = model.train(hyperparameters={"seed": 0, "device": device})
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"{config.num_layers}-layer int8 weights (hidden {config.hidden_dim}) "
        f"built on {device} in {time.perf_counter() - t0:.2f} s")
    return model, params


def random_quantized_params(config, seed: int, device: str = "cuda") -> dict:
    """Random serving weights in the layout ``quantize_params`` writes for
    ``config`` (int8 everywhere, or packed int4 with the per-site int8
    fallback for ``weight_bits=4``), made straight from a seeded
    ``torch.Generator`` on ``device``: no fp weights are quantized."""
    from unionml_tpu_torch._device import torch_dtype
    from unionml_tpu_torch.models.convert import _dense_shapes, _int4_site

    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = torch_dtype(config.dtype)
    d = config.hidden_dim

    def dense(path, k, n):
        int4 = config.weight_bits == 4 and _int4_site(config, path, k, n)
        if not int4:
            q = torch.randint(-127, 128, (k, n), device=device, generator=gen, dtype=torch.int8)
            scale = (0.75 + 0.5 * torch.rand(n, device=device, generator=gen)) / (73.0 * k**0.5)
            return {"kernel_q": q, "scale": scale}
        group = config.int4_group
        packed, scale = random_int4_weight(k, n, group, gen, device)
        return {"kernel_p": packed, ("scale_g" if group else "scale"): scale}

    def ones():
        return torch.ones(d, device=device, dtype=dtype)

    emb = torch.randn(config.vocab_size, d, device=device, generator=gen) * d**-0.5
    params = {"embed": {"embedding": emb.to(dtype)}}
    for i in range(config.num_layers):
        block = {"attn_norm": {"scale": ones()}, "mlp_norm": {"scale": ones()},
                 "attn": {}, "mlp": {}}
        for (part, site), (_, (k, n)) in _dense_shapes(config).items():
            block[part][site] = dense((part, site), k, n)
        params[f"block_{i}"] = block
    params["final_norm"] = {"scale": ones()}
    params["lm_head"] = dense(("lm_head",), d, config.vocab_size)
    return params


class Int4Probe:
    """Harness-side instrumentation of the int4 kernel wrapper: records the
    row count of every launch (``rows``) and every launch shape (``shapes``:
    rows, K, N, group, dtype, tile) and, inside ``plain()``, routes the
    CUDA calls to the kernel's plain version (the reference math on the
    card, for logits comparisons). The port itself never does this."""

    def __init__(self):
        from unionml_tpu_torch.ops import int4_matmul as i4

        self._mod = i4
        self._real = i4.int4_matmul_cuda
        self.rows: set = set()
        self.shapes: set = set()
        self._plain = False

        def wrapper(x, packed, scale, *, tile_n, group_size=0):
            if self._plain:
                return i4.int4_matmul_plain(x, packed, scale, tile_n=tile_n, dtype=x.dtype,
                                            group_size=group_size)
            rows, k = (int(d) for d in x.shape)
            self.rows.add(rows)
            self.shapes.add((rows, k, int(scale.shape[-1]), int(group_size), x.dtype, int(tile_n)))
            return self._real(x, packed, scale, tile_n=tile_n, group_size=group_size)

        i4.int4_matmul_cuda = wrapper

    @contextlib.contextmanager
    def plain(self):
        self._plain = True
        try:
            yield
        finally:
            self._plain = False

    def close(self):
        self._mod.int4_matmul_cuda = self._real


def int4_launch_shape_checks(shapes, seed: int = 3) -> dict:
    """Every launch shape the int4 phases gave the kernel (as an
    :class:`Int4Probe` recorded them), run again on seeded random inputs of
    that shape and held against the plain version, so each instance the
    engines ran (row-tile count, per-channel or grouped, bf16 or fp32, LM
    head included) is checked on the card at its own shape; grouped bf16
    shapes also by the bit check. Returns ``{kernel name: [{"shape",
    "max_abs_err" (, "mismatch")}]}``."""
    from unionml_tpu_torch.ops import int4_matmul as i4

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"int4_matmul": [], "int4_matmul_grouped": []}
    weight_key, weight = None, None
    for rows, k, n, group, dtype, tile in sorted(shapes, key=lambda s: (s[1:4], s[5], str(s[4]),
                                                                         s[0])):
        if weight_key != (k, n, group, tile):   # one weight resident at a time
            weight_key, weight = (k, n, group, tile), None
            weight = random_int4_weight(k, n, group, gen)
        packed, scale = weight
        x = torch.randn(rows, k, device="cuda", generator=gen).to(dtype)
        got = i4.int4_matmul_cuda(x, packed, scale, tile_n=tile, group_size=group)
        want = i4.int4_matmul_plain(x, packed, scale, tile_n=tile, dtype=dtype, group_size=group)
        form = f"g{group}" if group else "per-channel"
        shape = f"x[{rows},{k}] {str(dtype).split('.')[-1]} @ W4[{k},{n}] tile {tile}, {form}"
        name = f"int4_matmul launch shape {shape}"
        checked = {"shape": shape, "max_abs_err": check_close(name, got, want, INT4_TOL[dtype])}
        if group and dtype == torch.bfloat16:
            int4_bit_check(name, got, want, checked)
        out["int4_matmul_grouped" if group else "int4_matmul"].append(checked)
    for name, checked in out.items():
        log(f"int4 launch shapes: {name}: {len(checked)} shapes held against the plain version, "
            f"max abs err {max((c['max_abs_err'] for c in checked), default=None)}, worst bf16 "
            f"mismatch {max((c['mismatch'] for c in checked if 'mismatch' in c), default=None)}")
    return out


def layer_subset(params: dict, layers: int) -> dict:
    """The first ``layers`` blocks of a Llama param tree (a shallower
    model over the same embedding, norm and head)."""
    return {
        k: v for k, v in params.items()
        if not k.startswith("block_") or int(k.split("_")[1]) < layers
    }


def serve_phase(
    config, max_new_tokens: int, *, device: str = "cuda",
    buckets: tuple = (16, 64, 256, 1024),
    lengths: tuple = (5, 40, 200, 1000, 700, 12, 900, 130),
) -> dict:
    """Serve ``config`` (int8, flash prefill, fused norm) through the
    ported template and ServingApp; ``device="cpu"`` rehearses the phase
    at a small config, with the kernels' plain versions."""
    from unionml_tpu_torch.models import Llama, make_lm_predictor
    from unionml_tpu_torch.ops import flash_attention as fa
    from unionml_tpu_torch.ops import fused_norm

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    config = serving_config(config)
    model, params = build_template(config, max_new_tokens, buckets, device)

    cos = logits_agreement(config, params, device)
    log(f"serve: kernel path vs plain path prefill logits, min cosine {cos}")
    if cos < LOGIT_COSINE_MIN:
        raise AssertionError(f"kernel-path logits disagree with the plain path (cosine {cos})")

    # time to first token: one prefill + first sample, batch 1, 1000-token prompt
    first = make_lm_predictor(Llama(config), max_new_tokens=1, bucket_lens=buckets)
    rng = np.random.default_rng(0)
    long_prompt = rng.integers(1, config.vocab_size, size=max(lengths)).tolist()
    first(params, [long_prompt])
    sync()
    t0 = time.perf_counter()
    first(params, [long_prompt])
    sync()
    ttft_ms = (time.perf_counter() - t0) * 1e3

    fused_norm.KERNEL.launches = 0
    fa.KERNEL.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    app = model.serve(batch=True, row_lists=True, max_wait_ms=50.0)
    host, port = app.serve(host="127.0.0.1", port=0, blocking=False)
    base = f"http://{host}:{port}"
    results, errors = [], []

    def request(n):
        prompt = rng_req.integers(1, config.vocab_size, size=n).tolist()
        t = time.perf_counter()
        try:
            status, body = post(f"{base}/predict", {"features": [prompt]})
            results.append((n, status, body, (time.perf_counter() - t) * 1e3))
        except Exception as exc:  # reported below; any failure fails the run
            errors.append(f"prompt of {n} tokens: {exc!r}")

    rng_req = np.random.default_rng(2)
    try:
        t_start = time.perf_counter()
        request(lengths[0])                                # one alone
        for wave in (lengths[1:5], lengths[5:]):           # then concurrent waves
            threads = [threading.Thread(target=request, args=(n,)) for n in wave]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            if any(th.is_alive() for th in threads):
                raise AssertionError("a /predict request did not finish in 900 s")
        sync()
        wall_s = time.perf_counter() - t_start
        with urllib.request.urlopen(f"{base}/health", timeout=60) as resp:
            health = json.loads(resp.read())
            health_status = resp.status
        stats = app.stats()
    finally:
        app.shutdown()
    if errors:
        raise AssertionError("; ".join(errors))
    for n, status, body, ms in sorted(results):
        if status != 200 or len(body) != 1 or len(body[0]) != max_new_tokens or not all(
            isinstance(t, int) and 0 <= t < config.vocab_size for t in body[0]
        ):
            raise AssertionError(f"bad /predict reply for a {n}-token prompt: {status} {body}")
        log(f"serve: /predict {n}-token prompt -> {max_new_tokens} tokens in {ms:.1f} ms")
    if health_status != 200 or health.get("status") != "ok":
        raise AssertionError(f"/health not ok: {health_status} {health}")
    launches = {"rms_norm_fwd": fused_norm.KERNEL.launches,
                "flash_fwd_padded": fa.KERNEL.launches}
    if on_card:
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"kernel {name} was never launched on the main path")
    out = {
        "layers": config.num_layers,
        "requests": len(results),
        "ttft_ms": ttft_ms,
        "tokens_per_s": len(results) * max_new_tokens / wall_s,
        "wall_s": wall_s,
        "batches": stats.get("batches"),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
        "logit_cosine": cos,
        "launches": launches,
    }
    log(f"serve: ttft_ms {ttft_ms} ({len(long_prompt)}-token prompt, batch 1, "
        "prefill + first token)")
    log(f"serve: {out['requests']} requests, {out['batches']} batches, wall {wall_s} s, "
        f"{out['tokens_per_s']} generated tokens/s, "
        f"peak memory {out['peak_mem_gib']} GiB, launches {launches}")
    return out


def paged_logits_agreement(config, params, device: str, probe=None) -> float:
    """Cosine similarity of one decode step's logits through the paged
    path (pool + block table + paged attention, kernel on the card) and
    the contiguous plain path, on the same prefilled rows of 2 sequences.
    With an :class:`Int4Probe` the contiguous step also runs the int4
    matmuls' plain version."""
    from unionml_tpu_torch.models import Llama, init_cache

    rng = np.random.default_rng(3)
    blk, n_rows, seq = 16, 48, 37
    model = Llama(config)
    tokens = torch.from_numpy(rng.integers(1, config.vocab_size, size=(2, seq))).to(device)
    outs = []
    with torch.inference_mode():
        cache = init_cache(config, 2, n_rows, device=device)
        logits, cache = model(params, tokens, cache=cache, cache_index=0)
        step = logits[:, -1].argmax(-1)[:, None]
        fill = torch.full((2,), seq, dtype=torch.int32, device=device)
        kv_mask = torch.arange(n_rows, device=device)[None].expand(2, -1) <= seq
        # the same rows in a pool: row b's blocks are 1 + b*3 .. 3 + b*3
        width = n_rows // blk
        pool = init_cache(config, 1 + 2 * width, blk, device=device)
        for layer, cached in zip(pool, cache):
            for pbuf, cbuf in zip(layer, cached):
                pbuf[1:] = cbuf.reshape((2 * width, blk) + tuple(cbuf.shape[2:]))
        table = (1 + torch.arange(2 * width, device=device).reshape(2, width)).int()
        if probe is not None:
            with probe.plain():
                contiguous, _ = model(params, step, cache=cache, cache_index=fill,
                                      kv_mask=kv_mask)
        else:
            contiguous, _ = model(params, step, cache=cache, cache_index=fill, kv_mask=kv_mask)
        paged, _ = model(params, step, cache=pool, cache_index=fill, block_table=table)
        outs = [contiguous[:, -1].float(), paged[:, -1].float()]
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("decode-step logits are not finite")
    return float(torch.nn.functional.cosine_similarity(outs[0], outs[1], dim=-1).min())


def _pool_blocks_in_use(metrics: str) -> list:
    return [float(line.rsplit(" ", 1)[1]) for line in metrics.splitlines()
            if line.startswith("unionml_kv_pool_blocks_in_use{")]


def engine_phase(
    config, max_new_tokens: int, *, device: str = "cuda", model=None, params=None,
    slots: int = 16, probe=None,
    buckets: tuple = ENGINE_BUCKETS, chunk_steps: int = 8, waves: int = 3,
    lengths: tuple = (5, 1000, 37, 260, 700, 16, 129, 900, 64, 12, 480, 1000,
                      300, 8, 999, 77, 550, 20, 1001, 250, 128, 45, 620, 5),
) -> dict:
    """Serve ``config`` through the block-paged DecodeEngine behind
    ServingApp(batch=False); ``device="cpu"`` rehearses the phase at a
    small config, with the kernels' plain versions."""
    from unionml_tpu_torch.models import Llama
    from unionml_tpu_torch.ops import flash_attention as fa
    from unionml_tpu_torch.ops import fused_norm
    from unionml_tpu_torch.ops import int4_matmul as i4
    from unionml_tpu_torch.ops import paged_attention as pa
    from unionml_tpu_torch.serving import DecodeEngine, ServingApp

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    config = serving_config(config)
    if model is None:
        model, params = build_template(config, max_new_tokens, buckets, device)
    counters = {"paged_attention": pa.KERNEL, "flash_fwd_padded": fa.KERNEL,
                "rms_norm_fwd": fused_norm.KERNEL}
    if config.weight_bits == 4:
        if config.int4_group:
            counters["int4_matmul_grouped"] = i4.KERNEL_GROUPED
        else:
            counters["int4_matmul"] = i4.KERNEL
    cos = paged_logits_agreement(config, params, device, probe=probe)
    log(f"engine: paged vs contiguous decode-step logits, min cosine {cos}")
    if cos < LOGIT_COSINE_MIN:
        raise AssertionError(f"paged decode step disagrees with the contiguous path ({cos})")

    kw = dict(slots=slots, prompt_buckets=buckets, max_new_tokens=max_new_tokens,
              chunk_steps=chunk_steps, device=device)
    engine = DecodeEngine(Llama(config), paged=True, **kw)

    @model.predictor
    def predictor(params: dict, prompts: list) -> list:
        return engine.generate(params, prompts)

    t0 = time.perf_counter()
    engine.warmup(params)
    sync()
    log(f"engine: warmup ({len(engine.buckets)} buckets) {time.perf_counter() - t0:.2f} s, "
        f"cache_len {engine.cache_len}, pool {engine.kv_pool.capacity} blocks of "
        f"{engine.kv_pool.block_size}")
    engine.reset_stats()
    app = ServingApp(
        model, batch=False, health=engine.health, stats=engine.stats,
        stream=lambda p, features: engine.generate_stream(p, features[0]),
    )
    host, port = app.serve(host="127.0.0.1", port=0, blocking=False)
    base = f"http://{host}:{port}"
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, config.vocab_size, size=n).tolist() for n in lengths]
    stream_prompt = rng.integers(1, config.vocab_size, size=333).tolist()
    results, errors, streamed = {}, [], []

    def request(i):
        try:
            status, body = post(f"{base}/predict", {"features": [prompts[i]]})
            results[i] = (status, body)
        except Exception as exc:  # reported below; any failure fails the run
            errors.append(f"prompt {i} ({len(prompts[i])} tokens): {exc!r}")

    def stream():
        try:
            req = urllib.request.Request(
                f"{base}/predict/stream", data=json.dumps({"features": [stream_prompt]}).encode(),
                method="POST", headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=600) as resp:
                for line in resp.read().decode().splitlines():
                    if line.startswith("data:"):
                        event = json.loads(line[5:])
                        streamed.extend(event.get("tokens", []))
        except Exception as exc:
            errors.append(f"stream: {exc!r}")

    for counter in counters.values():
        counter.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    threads = [threading.Thread(target=stream)]
    per_wave = -(-len(prompts) // waves)
    # count operations that make the host wait for the card while the
    # requests run (the dispatcher must never wait; the harvester waits on
    # CUDA events, which this mode does not count)
    sync_warnings = warnings.catch_warnings(record=True)
    caught = sync_warnings.__enter__()
    warnings.simplefilter("always")
    if on_card:
        torch.cuda.set_sync_debug_mode("warn")
    try:
        t_start = time.perf_counter()
        threads[0].start()
        for w in range(waves):   # staggered waves: later ones join mid-decode
            wave = [threading.Thread(target=request, args=(i,))
                    for i in range(w * per_wave, min(len(prompts), (w + 1) * per_wave))]
            for th in wave:
                th.start()
            threads += wave
            time.sleep(0.5 if on_card else 0.05)
        give_up = time.monotonic() + 300
        for th in threads:
            th.join(timeout=max(0.0, give_up - time.monotonic()))
        if any(th.is_alive() for th in threads):
            raise AssertionError("the engine's requests did not finish in 300 s")
        sync()
        wall_s = time.perf_counter() - t_start
        launches = {name: c.launches for name, c in counters.items()}
        with urllib.request.urlopen(f"{base}/health", timeout=60) as resp:
            health_status, health = resp.status, json.loads(resp.read())
        deadline = time.monotonic() + 60
        while engine.stats()["kv_pool"]["blocks_in_use"] and time.monotonic() < deadline:
            time.sleep(0.05)
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as resp:
            in_use = _pool_blocks_in_use(resp.read().decode())
        stats = engine.stats()
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
        sync_warnings.__exit__(None, None, None)
        app.shutdown()
        engine.close()
    host_syncs = [str(w.message) for w in caught
                  if "synchronizing CUDA operation" in str(w.message)]
    if errors:
        raise AssertionError("; ".join(errors))
    n_tokens = 0
    for i, prompt in enumerate(prompts):
        status, body = results[i]
        if status != 200 or len(body) != 1 or len(body[0]) != max_new_tokens or not all(
            isinstance(t, int) and 0 <= t < config.vocab_size for t in body[0]
        ):
            raise AssertionError(f"bad /predict reply for a {len(prompt)}-token prompt: "
                                 f"{status} {body}")
        n_tokens += len(body[0])
    if len(streamed) != max_new_tokens:
        raise AssertionError(f"/predict/stream gave {len(streamed)} tokens")
    if health_status != 200 or health.get("status") != "ok":
        raise AssertionError(f"/health not ok: {health_status} {health}")
    if host_syncs:
        raise AssertionError(f"{len(host_syncs)} operations waited for the card while the "
                             "engine served (the dispatcher must never wait)")
    if not in_use or any(in_use):
        raise AssertionError(f"kv pool blocks in use after the drain: {in_use}")
    if on_card:
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"kernel {name} was never launched on the engine path")
    int4_expected = None
    if config.weight_bits == 4:
        # every decode step runs the 7 projections of every layer and the LM
        # head through the kernel (16 rows), every admission the LM head
        # once (its one logit row); the other prefill rows take the fallback
        int4_expected = stats["decode_steps"] * (7 * config.num_layers + 1) + len(prompts) + 1
        name = "int4_matmul_grouped" if config.int4_group else "int4_matmul"
        log(f"engine: {name} launches {launches[name]}, expected at least {int4_expected} "
            f"({stats['decode_steps']} decode steps x {7 * config.num_layers + 1} + "
            f"{len(prompts) + 1} admissions)")
        if on_card and launches[name] < int4_expected:
            raise AssertionError(f"{name} launched {launches[name]} times, expected at least "
                                 f"{int4_expected}")

    # the same prompts through a contiguous engine (printed, not gated)
    contiguous = DecodeEngine(Llama(config), paged=False, **kw)
    try:
        want = contiguous.generate(params, prompts)
    finally:
        contiguous.close()
    matching = sum(results[i][1][0] == want[i] for i in range(len(prompts)))
    itl = stats.get("itl_ms", {})
    out = {
        "layers": config.num_layers,
        "requests": len(prompts) + 1,
        "wall_s": wall_s,
        "tokens_per_s": (n_tokens + len(streamed)) / wall_s,
        "ttft_ms_p50": stats["ttft_ms"]["p50"],
        "ttft_ms_p99": stats["ttft_ms"]["p99"],
        "decode_ms_per_step_p50": itl.get("p50"),
        "decode_ms_per_step_mean": itl.get("mean"),
        "slot_occupancy": stats["slot_occupancy"],
        "decode_steps": stats["decode_steps"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
        "paged_logit_cosine": cos,
        "match_contiguous": f"{matching}/{len(prompts)}",
        "host_syncs": len(host_syncs),
        "launches": launches,
        "int4_expected_launches": int4_expected,
    }
    log(f"engine: {out['requests']} requests ({len(prompts)} /predict in {waves} staggered "
        f"waves + 1 stream), wall {wall_s} s, {out['tokens_per_s']} generated tokens/s")
    log(f"engine: ttft_ms p50 {out['ttft_ms_p50']} p99 {out['ttft_ms_p99']}; decode ms per "
        f"step (harvest spacing / tokens) p50 {out['decode_ms_per_step_p50']} mean "
        f"{out['decode_ms_per_step_mean']}; {out['decode_steps']} decode steps at slot "
        f"occupancy {out['slot_occupancy']}")
    log(f"engine: peak memory {out['peak_mem_gib']} GiB, launches {launches}, requests "
        f"token-identical to a contiguous engine: {out['match_contiguous']}")
    log(f"engine: operations that waited for the card during the requests: {len(host_syncs)}")
    return out


def kv_quant_phase(config, params, max_new_tokens: int, *, device: str = "cuda",
                   layers: int = 4, buckets: tuple = (64, 256)) -> dict:
    """A paged engine with the int8 KV cache at ``layers`` layers serves a
    few requests: the paged kernel's int8 form on a real path."""
    from unionml_tpu_torch.models import Llama
    from unionml_tpu_torch.ops import paged_attention as pa
    from unionml_tpu_torch.serving import DecodeEngine

    config = dataclasses.replace(serving_config(config), num_layers=layers, kv_quant=True)
    engine = DecodeEngine(Llama(config), paged=True, slots=4, prompt_buckets=buckets,
                          max_new_tokens=max_new_tokens, chunk_steps=8, device=device)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, config.vocab_size, size=n).tolist() for n in (9, 200, 64, 31, 150)]
    pa.KERNEL.launches = 0
    try:
        outs = engine.generate(layer_subset(params, layers), prompts)
        blocks = engine.stats()["kv_pool"]
    finally:
        engine.close()
    launches = pa.KERNEL.launches
    if any(len(o) != max_new_tokens or not all(0 <= t < config.vocab_size for t in o)
           for o in outs):
        raise AssertionError(f"bad int8-KV engine replies: {outs}")
    if device == "cuda" and launches == 0:
        raise AssertionError("the paged kernel's int8 form was never launched")
    log(f"int8 kv: {len(prompts)} requests on a {layers}-layer kv_quant paged engine, "
        f"paged_attention int8 launches {launches}, pool allocated "
        f"{blocks['allocated_blocks']} blocks")
    return {"layers": layers, "requests": len(prompts), "launches": launches}


def fp32_config(config, layers: int):
    """``config`` served with fp32 activations at ``layers`` layers (the
    flash prefill kernel takes bf16 only: fp32 prefills stay cached)."""
    return dataclasses.replace(
        serving_config(config), num_layers=layers, dtype="float32", prefill_impl="cached"
    )


def fp32_parity_phase(config, max_new_tokens: int, *, device: str = "cuda", layers: int = 8,
                      buckets: tuple = ENGINE_BUCKETS,
                      lengths: tuple = (5, 1000, 37, 260, 700, 16, 129, 900, 64, 12, 480, 300)
                      ) -> dict:
    """The same prompts through a paged engine (the paged kernel with fp32
    queries) and a contiguous engine (plain cached attention) of one
    fp32-activation model: with no bf16 rounding of the softmax weights
    the two must agree token for token (at most one near-tie flip). An int4
    config runs its int4 kernel's fp32 form in both engines."""
    from unionml_tpu_torch.models import Llama
    from unionml_tpu_torch.ops import paged_attention as pa
    from unionml_tpu_torch.serving import DecodeEngine

    config = fp32_config(config, layers)
    if config.weight_bits == 4:
        params = random_quantized_params(config, 0, device)
    else:
        _, params = build_template(config, max_new_tokens, buckets, device)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, config.vocab_size, size=n).tolist() for n in lengths]
    outs = {}
    pa.KERNEL.launches = 0
    for paged in (True, False):
        engine = DecodeEngine(Llama(config), paged=paged, slots=16, prompt_buckets=buckets,
                              max_new_tokens=max_new_tokens, chunk_steps=8, device=device)
        try:
            outs[paged] = engine.generate(params, prompts)
        finally:
            engine.close()
    launches = pa.KERNEL.launches
    matching = sum(a == b for a, b in zip(outs[True], outs[False]))
    log(f"fp32 parity: {matching}/{len(prompts)} requests token-identical, paged kernel "
        f"(fp32 queries) vs contiguous plain path, {layers} layers, weight_bits "
        f"{config.weight_bits} group {config.int4_group}; paged_attention launches {launches}")
    if matching < len(prompts) - 1:
        raise AssertionError(f"fp32 paged engine disagrees with the contiguous engine: "
                             f"{matching}/{len(prompts)}")
    if device == "cuda" and launches == 0:
        raise AssertionError("the paged kernel was never launched in the fp32 engine")
    return {"layers": layers, "match": f"{matching}/{len(prompts)}", "launches": launches}


# the 0.3B draft of the JAX package's speculative benchmark
DRAFT_WIDTHS = dict(hidden_dim=1024, num_layers=10, num_heads=16, num_kv_heads=8, mlp_dim=2816)


def _spec_engine(target_cfg, draft_cfg, device, **kw):
    from unionml_tpu_torch.models import Llama
    from unionml_tpu_torch.serving import DecodeEngine

    draft = Llama(target_cfg) if draft_cfg is None else Llama(draft_cfg)
    return DecodeEngine(Llama(target_cfg), draft_module=draft, device=device, **kw)


def spec_phase(target_cfg, target_params, draft_cfg, draft_params, max_new_tokens: int, *,
               device: str = "cuda", probe=None, slots: int = 8, k: int = 4,
               buckets: tuple = (64, 256), chunk_steps: int = 4,
               lengths: tuple = (5, 200, 37, 120, 64, 12, 180, 90), self_requests: int = 4) -> dict:
    """Serve the int4 target with the draft through the speculative
    DecodeEngine behind ServingApp(batch=False): every prompt at once plus
    one /predict/stream, no host waits while serving, the per-channel int4
    kernel launched with the verify's slots * (k+1) rows among its row
    counts; then self-speculation (draft = target) must accept nearly
    every proposal. ``device="cpu"`` rehearses it at a small config."""
    from unionml_tpu_torch import ModelArtifact
    from unionml_tpu_torch.models import Llama
    from unionml_tpu_torch.ops import int4_matmul as i4
    from unionml_tpu_torch.serving import DecodeEngine, ServingApp
    from unionml_tpu_torch.templates.llm_serving.app import build_model

    on_card = device == "cuda"
    kw = dict(speculate_k=k, slots=slots, prompt_buckets=buckets, max_new_tokens=max_new_tokens,
              chunk_steps=chunk_steps)
    params = {"target": target_params, "draft": draft_params}
    engine = _spec_engine(target_cfg, draft_cfg, device, **kw)
    model = build_model(target_cfg, name="chip_smoke_spec")
    model.artifact = ModelArtifact(params)

    @model.predictor
    def predictor(params: dict, prompts: list) -> list:
        return engine.generate(params, prompts)

    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, target_cfg.vocab_size, size=n).tolist() for n in lengths]
    results, errors, streamed = {}, [], []
    t0 = time.perf_counter()
    engine.warmup(params)
    if on_card:
        torch.cuda.synchronize()
    log(f"spec: warmup {time.perf_counter() - t0:.2f} s, cache_len {engine.cache_len}")
    engine.reset_stats()
    app = ServingApp(model, batch=False, health=engine.health, stats=engine.stats,
                     stream=lambda p, features: engine.generate_stream(p, features[0]))
    host, port = app.serve(host="127.0.0.1", port=0, blocking=False)
    base = f"http://{host}:{port}"

    def request(i):
        try:
            results[i] = post(f"{base}/predict", {"features": [prompts[i]]})
        except Exception as exc:  # reported below; any failure fails the run
            errors.append(f"prompt {i}: {exc!r}")

    def stream():
        try:
            req = urllib.request.Request(
                f"{base}/predict/stream", data=json.dumps({"features": [prompts[0]]}).encode(),
                method="POST", headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=600) as resp:
                for line in resp.read().decode().splitlines():
                    if line.startswith("data:"):
                        streamed.extend(json.loads(line[5:]).get("tokens", []))
        except Exception as exc:
            errors.append(f"stream: {exc!r}")

    i4.KERNEL.launches = 0
    if probe is not None:
        probe.rows.clear()
    threads = [threading.Thread(target=stream)] + [
        threading.Thread(target=request, args=(i,)) for i in range(len(prompts))
    ]
    sync_warnings = warnings.catch_warnings(record=True)
    caught = sync_warnings.__enter__()
    warnings.simplefilter("always")
    if on_card:
        torch.cuda.set_sync_debug_mode("warn")
    try:
        t_start = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        if any(th.is_alive() for th in threads):
            raise AssertionError("the speculative engine's requests did not finish in 300 s")
        if on_card:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_start
        launches = i4.KERNEL.launches
        stats = engine.stats()
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
        sync_warnings.__exit__(None, None, None)
        app.shutdown()
        engine.close()
    rows_seen = sorted(probe.rows) if probe is not None else []
    host_syncs = [str(w.message) for w in caught
                  if "synchronizing CUDA operation" in str(w.message)]
    if errors:
        raise AssertionError("; ".join(errors))
    for i, prompt in enumerate(prompts):
        status, body = results[i]
        if status != 200 or len(body) != 1 or len(body[0]) != max_new_tokens or not all(
            isinstance(t, int) and 0 <= t < target_cfg.vocab_size for t in body[0]
        ):
            raise AssertionError(f"bad speculative reply for a {len(prompt)}-token prompt: "
                                 f"{status} {body}")
    if len(streamed) != max_new_tokens:
        raise AssertionError(f"speculative /predict/stream gave {len(streamed)} tokens")
    if host_syncs:
        raise AssertionError(f"{len(host_syncs)} operations waited for the card while the "
                             "speculative engine served")
    if on_card and (launches == 0 or slots * (k + 1) not in rows_seen):
        raise AssertionError(f"int4_matmul launches {launches}, row counts {rows_seen}: the "
                             f"verify's {slots * (k + 1)} rows never reached the kernel")

    # the same prompts through the plain int4 engine (bf16 agreement, printed)
    plain = DecodeEngine(Llama(target_cfg), device=device, slots=slots, prompt_buckets=buckets,
                         max_new_tokens=max_new_tokens, chunk_steps=chunk_steps)
    try:
        want = plain.generate(target_params, prompts)
    finally:
        plain.close()
    matching = sum(results[i][1][0] == want[i] for i in range(len(prompts)))

    # self-speculation: draft = target
    self_engine = _spec_engine(target_cfg, None, device, **kw)
    try:
        self_engine.generate({"target": target_params, "draft": target_params},
                             prompts[:self_requests])
        self_acc = self_engine.stats()["speculative"]["acceptance_rate"]
    finally:
        self_engine.close()
    spec = stats["speculative"]
    n_tokens = len(prompts) * max_new_tokens + len(streamed)
    out = {
        "layers": target_cfg.num_layers, "draft_layers": draft_cfg.num_layers,
        "requests": len(prompts) + 1, "k": k, "slots": slots,
        "wall_s": wall_s, "tokens_per_s": n_tokens / wall_s,
        "acceptance_rate": spec["acceptance_rate"], "rounds": spec["rounds"],
        "self_acceptance_rate": self_acc,
        "ttft_ms_p50": stats["ttft_ms"]["p50"],
        "itl_ms_p50": stats.get("itl_ms", {}).get("p50"),
        "int4_rows_seen": rows_seen, "launches": {"int4_matmul": launches},
        "match_plain_bf16": f"{matching}/{len(prompts)}", "host_syncs": len(host_syncs),
    }
    log(f"spec: {out['requests']} requests, k={k}, {slots} slots, wall {wall_s} s, "
        f"{out['tokens_per_s']} generated tokens/s, acceptance {out['acceptance_rate']} over "
        f"{out['rounds']} rounds, ttft p50 {out['ttft_ms_p50']} ms, itl p50 {out['itl_ms_p50']}")
    log(f"spec: int4_matmul launches {launches}, row counts seen {rows_seen}; requests "
        f"token-identical to the plain int4 engine (bf16, not gated): {out['match_plain_bf16']}; "
        f"self-speculation acceptance {self_acc}")
    if self_acc < SPEC_SELF_ACCEPT_MIN:
        raise AssertionError(f"self-speculation accepted {self_acc} of proposals "
                             f"(< {SPEC_SELF_ACCEPT_MIN})")
    return out


def spec_fp32_parity_phase(target_cfg, draft_cfg, max_new_tokens: int, *, device: str = "cuda",
                           layers: int = 8, buckets: tuple = (64, 256),
                           lengths: tuple = (5, 200, 37, 120, 64, 12, 180, 90, 16, 250, 33, 7)
                           ) -> dict:
    """fp32 activations, ``layers`` layers: the speculative engine (the
    0.3B draft, and self-speculation) and the plain int4 engine must give
    the same tokens (at most one near-tie flip in 12 requests); the int4
    kernel runs its fp32 form."""
    from unionml_tpu_torch.models import Llama
    from unionml_tpu_torch.serving import DecodeEngine

    target_cfg = fp32_config(target_cfg, layers)
    draft_cfg = fp32_config(draft_cfg, draft_cfg.num_layers)
    tp = random_quantized_params(target_cfg, 1, device)
    dp = random_quantized_params(draft_cfg, 2, device)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, target_cfg.vocab_size, size=n).tolist() for n in lengths]
    kw = dict(slots=8, prompt_buckets=buckets, max_new_tokens=max_new_tokens, chunk_steps=4)
    plain = DecodeEngine(Llama(target_cfg), device=device, **kw)
    try:
        want = plain.generate(tp, prompts)
    finally:
        plain.close()
    out = {"layers": layers}
    for name, draft, params in (("draft", draft_cfg, dp), ("self", None, tp)):
        engine = _spec_engine(target_cfg, draft, device, speculate_k=4, **kw)
        try:
            got = engine.generate({"target": tp, "draft": params}, prompts)
            acc = engine.stats()["speculative"]["acceptance_rate"]
        finally:
            engine.close()
        matching = sum(a == b for a, b in zip(got, want))
        log(f"spec fp32 parity ({name} draft): {matching}/{len(prompts)} requests "
            f"token-identical to the plain int4 engine, {layers} layers, acceptance {acc}")
        if matching < len(prompts) - 1:
            raise AssertionError(f"fp32 speculative engine ({name} draft) disagrees with the "
                                 f"plain engine: {matching}/{len(prompts)}")
        out[name] = {"match": f"{matching}/{len(prompts)}", "acceptance_rate": acc}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--layers", type=int, default=32)
    parser.add_argument("--max-new-tokens", type=int, default=32)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if not (HERE / "unionml_tpu_torch").is_dir():
        print("chip_smoke: the unionml_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 LM head in full fp32
    torch.backends.cudnn.allow_tf32 = False
    t_run = time.perf_counter()

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from unionml_tpu_torch.ops import _build

    log(f"build: {len(_build.SOURCES)} kernel sources built in {_build.build_all():.2f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    batch, bucket = 4, 1024
    kernels = kernel_phase(batch, bucket)
    kernels.update(vit_kernel_phase())
    kernels.update(flash_train_kernel_phase())
    log(f"time: kernels done at {time.perf_counter() - t_run:.1f} s")

    from unionml_tpu_torch.models import ViTConfig

    vit_cfg = dataclasses.replace(ViTConfig.base16(num_classes=1000), norm_impl="fused")
    vit = vit_train_phase(vit_cfg)
    vit["agreement"] = vit_grad_agreement(vit_cfg)
    log(f"time: vit training done at {time.perf_counter() - t_run:.1f} s")

    from unionml_tpu_torch.models import LlamaConfig

    llama_cfg = LlamaConfig.llama_lc()
    llama = lm_train_phase(llama_cfg)
    llama["agreement"] = lm_grad_agreement(llama_cfg)
    log(f"time: llama training done at {time.perf_counter() - t_run:.1f} s")

    base = LlamaConfig.llama3_8b()
    served = serve_phase(dataclasses.replace(base, num_layers=args.layers),
                         args.max_new_tokens)
    log(f"time: serve done at {time.perf_counter() - t_run:.1f} s")
    config = serving_config(dataclasses.replace(base, num_layers=args.layers))
    model, params = build_template(config, ENGINE_NEW_TOKENS, ENGINE_BUCKETS, "cuda")
    engine = engine_phase(config, ENGINE_NEW_TOKENS, model=model, params=params)
    log(f"time: engine done at {time.perf_counter() - t_run:.1f} s")
    int8_kv = kv_quant_phase(config, params, 16)
    del model, params
    log(f"time: int8 kv done at {time.perf_counter() - t_run:.1f} s")
    fp32 = fp32_parity_phase(base, 32)
    log(f"time: fp32 parity done at {time.perf_counter() - t_run:.1f} s")

    from unionml_tpu_torch import ModelArtifact
    from unionml_tpu_torch.templates.llm_serving.app import build_model

    probe = Int4Probe()
    try:
        cfg4 = serving_config(dataclasses.replace(base, num_layers=args.layers, weight_bits=4,
                                                  int4_group=128))
        params4 = random_quantized_params(cfg4, 0)
        model4 = build_model(cfg4, name="chip_smoke_int4", max_new_tokens=ENGINE_NEW_TOKENS,
                             bucket_lens=ENGINE_BUCKETS)
        model4.artifact = ModelArtifact(params4)
        int4_engine = engine_phase(cfg4, ENGINE_NEW_TOKENS, model=model4, params=params4,
                                   probe=probe)
        del model4, params4
        log(f"time: int4 paged engine done at {time.perf_counter() - t_run:.1f} s")
        target_cfg = serving_config(dataclasses.replace(base, num_layers=args.layers,
                                                        weight_bits=4))
        draft_cfg = serving_config(dataclasses.replace(base, **DRAFT_WIDTHS))
        spec = spec_phase(target_cfg, random_quantized_params(target_cfg, 1), draft_cfg,
                          random_quantized_params(draft_cfg, 2), 32, probe=probe)
        log(f"time: int4 speculative engine done at {time.perf_counter() - t_run:.1f} s")
        int4_fp32 = fp32_parity_phase(dataclasses.replace(base, weight_bits=4, int4_group=128), 32)
        spec_fp32 = spec_fp32_parity_phase(dataclasses.replace(base, weight_bits=4),
                                           dataclasses.replace(base, **DRAFT_WIDTHS), 32)
        log(f"time: int4 fp32 parity done at {time.perf_counter() - t_run:.1f} s")
    finally:
        probe.close()
    shape_checks = int4_launch_shape_checks(probe.shapes)
    log(f"time: int4 launch-shape checks done at {time.perf_counter() - t_run:.1f} s")

    replaces = {
        "rms_norm_fwd": ("unionml_tpu_torch/csrc/fused_norm.cu", "unionml_tpu/ops/fused_norm.py:72"),
        "flash_fwd_padded": ("unionml_tpu_torch/csrc/flash_attention.cu",
                             "unionml_tpu/ops/flash_attention.py:63"),
        "paged_attention": ("unionml_tpu_torch/csrc/paged_attention.cu",
                            "unionml_tpu/ops/paged_attention.py:141"),
        "int4_matmul": ("unionml_tpu_torch/csrc/int4_matmul.cu",
                        "unionml_tpu/ops/int4_matmul.py:136"),
        "int4_matmul_grouped": ("unionml_tpu_torch/csrc/int4_matmul.cu",
                                "unionml_tpu/ops/int4_matmul.py:184"),
        "layer_norm_fwd": ("unionml_tpu_torch/csrc/fused_norm.cu",
                           "unionml_tpu/ops/fused_norm.py:72"),
        "add_layer_norm_fwd": ("unionml_tpu_torch/csrc/fused_norm.cu",
                               "unionml_tpu/ops/fused_norm.py:85"),
        "norm_bwd": ("unionml_tpu_torch/csrc/fused_norm.cu", "unionml_tpu/ops/fused_norm.py:99"),
        "fused_attention_fwd": ("unionml_tpu_torch/csrc/fused_attention.cu",
                                "unionml_tpu/ops/fused_attention.py:66"),
        "fused_attention_bwd": ("unionml_tpu_torch/csrc/fused_attention.cu",
                                "unionml_tpu/ops/fused_attention.py:92"),
        "flash_fwd": ("unionml_tpu_torch/csrc/flash_attention.cu",
                      "unionml_tpu/ops/flash_attention.py:63"),
        "flash_bwd_dq": ("unionml_tpu_torch/csrc/flash_bwd.cu",
                         "unionml_tpu/ops/flash_attention.py:262"),
        "flash_bwd_dkv": ("unionml_tpu_torch/csrc/flash_bwd.cu",
                          "unionml_tpu/ops/flash_attention.py:311"),
    }
    # launches on each kernel's main path: the int8 engine phase for rows
    # 1, 2 and 6, the speculative engine for row 7, the int4 paged engine
    # for row 8, the ViT-B/16 training run for rows 3, 4, 5, 12 and 13,
    # the llama_lc training run for rows 9, 10 and 11
    main_launches = dict(engine["launches"])
    main_launches.update(vit["launches"])
    main_launches.update(llama["launches"])
    per_train_step = {**vit["launches_per_step"], **llama["launches_per_step"]}
    main_launches["int4_matmul"] = spec["launches"]["int4_matmul"]
    main_launches["int4_matmul_grouped"] = int4_engine["launches"]["int4_matmul_grouped"]
    rows = []
    for name, cases in kernels.items():
        main_case = cases[0]
        launches = main_launches[name]
        if name == "paged_attention":
            for c in cases:   # launches of each form on its own engine path
                c["launches"] = launches if c["form"] == "bf16" else int8_kv["launches"]
            launches += int8_kv["launches"]
        checked = cases + shape_checks.get(name, [])
        rows.append({
            "name": name, "route": "cuda", "source": replaces[name][0],
            "replaces": replaces[name][1], "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in checked),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "shape": main_case["shape"],
            **{key: main_case[key] for key in ("ms_cold", "library_ms_cold", "rounding_probe")
               if key in main_case},
            "serve_launches": served["launches"].get(name),
            "launches_per_train_step": per_train_step.get(name),
            "shapes": cases, "launch_shape_checks": shape_checks.get(name),
        })
    print(json.dumps({"kernels": rows, "serve": served, "engine": engine, "int8_kv": int8_kv,
                      "fp32_parity": fp32, "int4_engine": int4_engine, "spec": spec,
                      "int4_fp32_parity": int4_fp32, "spec_fp32_parity": spec_fp32,
                      "vit_train": vit, "llama_train": llama,
                      "seconds": time.perf_counter() - t_run}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
