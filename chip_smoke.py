#!/usr/bin/env python3
"""Drive the PyTorch port (unionml_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--layers 16] [--max-new-tokens 32]

Phases, each of which fails the run with a non-zero exit:

1. card    — print the card's name and power limit (nvidia-smi);
2. build   — build the C++ host loader (unionml_tpu_torch/data/_native/
             hostloader.cpp, g++) into build/host/ and every CUDA kernel
             under unionml_tpu_torch/csrc/ with nvcc (one process per
             source, in parallel) into build/kernels/;
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
             attention forward and backward at S = 197, at BERT-base's
             32 x 128, at S = 512 and 1024; the backward run twice for the
             same bits; rows 12-13 row by row against a planted skipped
             key chunk at each shape);
3b. vit    — train ViT-B/16 (bf16 compute, fp32 params, fused attention and
             fused norms) through the ported vision_tpu template's
             model.train at batch 64 for 54 steps (2 warm-up): samples/s,
             step ms, the trainer's samples/sec gauge, peak memory, the
             loss falling, each ViT kernel's launches per step; then one
             step's loss and gradients against the plain path (per-tensor
             cosine) and two 3-step runs from one state (the same loss
             bits);
3d. feed   — 3b's run again with train_step(double_buffer=True, goodput=...):
             the feed on a feeder thread with its own copy stream, batches
             from the C++ host loader (which must be the one in use): the
             same per-step loss bits and final state bits as 3b's inline
             run, the same launches per step, the goodput buckets
             explaining >= 0.95 of the trainer's wall time; step ms and
             samples/s of both feeds; then 16 steps with
             train_step(checkpoint_dir=<temporary dir under build/>,
             save_every=4, double_buffer=True, goodput=...) uninterrupted,
             the same run preempted after step 10 (the elastic trainer's
             fault hook) and relaunched from a fresh state: it resumes at
             step 8 and ends at the uninterrupted run's bits (params and
             AdamW state); the checkpoint's bytes, the save stall on the
             loop, the commit, the restore and the checkpoint /
             preemption buckets;
3c. llama — rows 9-11 (the flash-attention training forward with its
             logsumexp, the dq and the dk/dv backward kernels) at the
             llama_lc shape (q[2,4095,12,64], kv[2,4095,4,64], causal), at
             the Llama-3-8B head geometry (S = 2048, and S = 1023, the
             QLoRA phase's) and at small non-causal and cross-length
             shapes, each against its plain version, the backward twice
             (the same bits); then the long-context Llama of
             benchmarks/train_throughput.py (12 x 768, 125M params, flash
             attention) trained through an LM app's model.train
             (@model.train_step -> lm_step) at batch 2 x 4096 tokens for 54
             steps: tokens/s, step ms, the trainer's gauge, peak memory,
             the loss falling, rows 9/10/11 launched 12/12/12 times a step;
             then, at 2 layers and full width, one step's loss and gradients
             against the plain path (per-tensor cosine) and two 3-step runs
             from one state (the same loss bits);
3e. qlora — the qlora_8b preset of benchmarks/train_throughput.py: rank-16
             LoRA adapters on q/k/v/o and gate/up/down over a frozen random
             int8 Llama-3-8B base (32 layers, fp32 embedding and norm scales,
             built leaf by leaf on the card), remat, flash attention, trained
             through an LM app's model.train (create_lora_train_state ->
             @model.train_step -> lm_step) for 12 steps of one repeated
             1 x 1024-token batch: step ms, tokens/s, peak memory, the loss
             falling, the base's bits unchanged (per-leaf checksums), AdamW
             state of exactly 2 x 41,943,040 adapter elements, rows 9/10/11
             launched 64/32/32 times a step; then, at 4 layers, the adapters'
             gradients against the plain path (per-tensor cosine), two 3-step
             runs from one state (the same loss bits), the merged tree
             (merge_lora) on the rank-0 model against the unmerged forward
             and 4 tokens served from it; the phase frees its state before
             phase 4;
3f. bert  — BERT-base (vocab 30522, 12 x 768, 12 heads, MLP 3072,
             max_len 512, bf16 compute, fp32 params and heads; seeded random
             weights made on the card): fine-tuned through a Dataset/Model
             spec's model.train (@model.train_step -> classification_step)
             on one repeated 32 x 128 batch of unmasked ids, 22 steps (2
             warm-up), once with attn_impl="xla" and once with "fused":
             step ms, samples/s, the loss falling, rows 12/13 launched
             12/12 times a step under fused and never under xla; rows 12-13
             on every block's own q, k, v and do of one fused step (the
             step's attention output again bit for bit, then row by row
             against the same arithmetic with fp64 sums, the planted
             skipped chunk failing); that step's gradients fused vs xla
             (per-tensor cosine >= 0.99) and two 3-step runs with the same
             loss bits; then masked-LM training (mlm_step) on
             one repeated 16 x 512 batch padded to lengths in [128, 512]
             (the full-score path with the padding bias; rows 12-13 never
             launched): the loss falling over 10 steps, the shortest row's
             logits at its real positions against the row run alone, and
             one unmasked 16 x 512 step with attn_impl="fused" (rows 12/13
             12/12 times, the two-pass forward);
3g. basic_tpu — the ported basic_tpu template (a two-layer MLP through
             @model.train_step) on the card over digit-shaped synthetic
             data: its first 5 steps against the same steps on the CPU
             from one initial state (params within rtol 1e-4, atol 2e-5),
             then model.train: params on the card, test accuracy above
             0.7, model.predict of two rows;
3h. sharded — a one-rank NCCL process group over a local TCP store
             (multihost_initialize(device="cuda")), then (a) ViT-B/16 twice
             through a Dataset/Model spec's model.train, batch 64 as two
             accumulated microbatches of 32, 6 steps (2 warm-up), plain and
             with train_step(sharding=ShardingConfig(data=-1,
             rules=VIT_PARTITION_RULES), overlap_grads=True): the params
             after every step and at the end bit for bit the plain run's,
             rows 3-5 and 12-13 launched twice their per-step counts; (b)
             2 lm_steps of llama_lc at 2 x 4096 tokens plain and through
             compile_step under ShardingConfig(data=-1, tensor=1,
             rules=LLAMA_PARTITION_RULES): bit for bit after every step,
             rows 9-11 and the delta pass launched; (c) an async sharded
             CheckpointManager save of (a)'s placed state and a restore into
             a fresh placed target, bit for bit (the save stall on the loop
             and the commit in ms); (d) bucketed_psum over the NCCL group of
             a ViT-B gradient tree equal to its input, the collective
             counter above 0; step ms plain and sharded; the phase within
             60 s;
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
5b. prefix — the same weights behind DecodeEngine(paged, system_prefix of 512 seeded
             ids, RadixPrefixCache(block_size=16, max_bytes=1 GiB), a 320-block pool,
             mix_prefill_tokens=512) and ServingApp(batch=False): a cold seed request,
             then 8 three-turn chat conversations (each turn the previous prompt, its
             reply and a new user turn, sent when the reply arrives) beside 8 one-shot
             prompts; check every reply, /health, tokens saved equal to what the prompt
             lengths imply (no eviction), a pool_pressure flight record (the pool
             filled), pool blocks and leases back at 0, the 32 pinned prefix blocks, no
             host wait, rows 1 / 2 / 6 launched; then a warm admission's spliced pool
             rows, read through its block table, against the host store bit for bit
             (two planted splice faults must fail), its first-token logits against its
             cold twin's (cosine), cold / warm TTFT pairs on the idle engine, splice and
             extract device times; a 4-layer int8-KV run of the splice-bit check (scale
             planes included); after phase 7, fp32 parity of a prefix-cache engine and a
             plain one at 8 layers, and a stream preempted at a full pool and resumed
             with its unpreempted tokens;
6. int8 kv — a 4-layer paged engine with kv_quant=True serves a few
             requests through the kernel's int8 form;
6b. serverless — the llm_serving template over the engine phases'
             --layers int8 weights behind the serverless handlers: a POST
             /predict gateway event (a 1000-token prompt) alone, then it and
             a 300-token one sent at once, which must share one
             micro-batch, and an object-upload event (5- and 200-token
             prompts in a LocalObjectStore in a temporary directory) must
             give the tokens of the same requests through
             ServingApp.predict, with the request id, tenant and
             traceparent headers back; the step where each row of the
             shared batch leaves its tokens alone is reported (ROADMAP
             C10); rows 1 and 2 launched; the handler's own ms around each
             predict;
6c. rollout — Llama-3-8B width, int8, the first 4 blocks: a VersionRegistry
             publishes v1, v1b (the same bits) and v2 (the last block
             reseeded); one live paged engine behind a FleetRouter serves 8
             prompts without a rollout, then the RolloutController warm-joins
             a canary for each version and shadows 8 live requests of 16
             tokens: v1b must promote (drain, bind, rejoin) with 0 shadow
             divergences at the default tolerance; v2 must roll back as
             parity_regression with the live weights' checksums unchanged,
             its pool at rest and the canary's device memory handed back;
             publish, restore, join, promote and rollback ms, ITL p50 with
             and without shadowing, rows 1, 2 and 6 launched;
6d. remote — LocalBackend in a temporary root: an app written to a
             temporary directory (an MLP, classification_step, a trainer
             stage asking for one card) is deployed with an explicit
             version, trained by the runner process on the card
             (remote_train, remote_wait, remote_load; the runner's log
             names the card), its params bit-equal to the same steps run
             in this process, and predict / ServingApp(remote=True) equal
             to the in-process model's;
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
import os
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
INT4_ENGINE_NEW_TOKENS = 32               # the int4 engine's requests: the int8 one's at half depth


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


def fused_exact(q, k, v, do, *, causal: bool, skip_last_chunk: bool = False):
    """The arithmetic of rows 12-13 (``fused_attention_*_plain``: e rounded
    to bf16 before P.V, do / z and ds rounded before their products) with
    every sum in fp64: ``(out, dq, dk, dv)`` in the inputs' dtypes. With
    ``skip_last_chunk`` each query's last visible 64-key chunk is hidden,
    for queries that see more than one chunk (:func:`skipped_chunk_fault`)."""
    from unionml_tpu_torch.ops import fused_attention as tfa

    f64 = torch.float64
    pos = torch.arange(q.shape[1], device=q.device)
    vis = pos[None, :] <= pos[:, None] if causal else \
        torch.ones(len(pos), len(pos), dtype=torch.bool, device=q.device)
    if skip_last_chunk:
        last = (pos if causal else torch.full_like(pos, len(pos) - 1)) // FUSED_CHUNK
        vis = vis & ~((pos[None, :] // FUSED_CHUNK == last[:, None]) & (last[:, None] > 0))
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f64), k.to(f64))
    s = torch.where(vis, s, torch.full_like(s, tfa.NEG_INF))
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    z = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype).to(f64), v.to(f64)) / z
    do_bh = do.permute(0, 2, 1, 3)
    do_n = (do_bh.to(f64) / z).to(do.dtype)
    dv = torch.einsum("bhqk,bhqd->bkhd", e.to(do.dtype).to(f64), do_n.to(f64))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(f64), v.to(f64))
    delta = (e * dp).sum(dim=-1, keepdim=True) / z
    ds = (e * (dp - delta) * (tfa.LN2 / z)).to(q.dtype).to(f64)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(f64))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(f64))
    return (out.permute(0, 2, 1, 3).to(q.dtype), dq.to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def skipped_chunk_fault(q, k, v, do, *, causal: bool):
    """A planted fault the row check of rows 12-13 must reject: their
    arithmetic with each query's last visible 64-key chunk skipped, for
    queries that see more than one chunk, as kernels whose key loop stops
    one chunk short would compute. ``(out, dq, dk, dv)``."""
    return fused_exact(q, k, v, do, causal=causal, skip_last_chunk=True)


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
    bwd = lambda: tfa.fused_attention_bwd_cuda(q, k, v, do, causal=False)  # noqa: E731
    grads, again = bwd(), bwd()
    torch.cuda.synchronize()
    want = dict(zip(("out", "dq", "dk", "dv"),
                    (tfa.fused_attention_fwd_plain(q, k, v, causal=False),
                     *tfa.fused_attention_bwd_plain(q, k, v, do, causal=False))))
    fault = dict(zip(want, skipped_chunk_fault(q, k, v, do, causal=False)))
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
    # the backward reads q, k, v, do and writes dq, dk, dv
    b_ms, bb_ms = bound(7 * numel * 2, 10 * pairs * d, PEAK_BF16_OPS_S)
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
        "plain_ms": time_ms(lambda: tfa.fused_attention_bwd_plain(q, k, v, do, causal=False),
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
    BERT-base's fine-tune shape (32 x 128, the resident form), at S = 512
    (BERT-base's max_len, the two-pass form) and 1024 (the fused limit)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = vit_norm_cases(VIT_B * VIT_S, VIT_D, gen)
    for b, s in ((VIT_B, VIT_S), (BERT_BATCH, BERT_SEQ), (16, 512), (8, 1024)):
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


def tree_paths(tree, prefix: tuple = ()) -> list:
    """The key path of every leaf of a nested dict, in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in tree_paths(v, prefix + (k,))]
    return [prefix]


def path_agreement(name: str, module_cls, kernel_cfg, plain_cfg, loss, step_factory, params,
                   batches, *, lr: float, cosine_min: float, frozen=None,
                   null_grads: tuple = ()) -> dict:
    """One step's loss and gradients of ``module_cls(kernel_cfg)`` against
    ``module_cls(plain_cfg)`` from the same ``params`` and first batch
    (``loss(outputs, labels)``; per-tensor cosine at least
    ``cosine_min``), then two runs of ``step_factory(module)`` over all
    ``batches`` from one AdamW state, whose losses must be the same bits
    (the kernels use no atomics). With ``frozen`` (a LoRA base), ``params``
    are the adapters: the gradients are theirs and the runs train a
    ``LoRATrainState``. A leaf whose path ends with one of ``null_grads``
    has a gradient that is zero in exact arithmetic, so both paths hold
    rounding only: its norms are reported, not held to the cosine."""
    import torch.nn.functional as F

    from unionml_tpu_torch.models import LoRATrainState, TrainState, adamw, merge_param_trees
    from unionml_tpu_torch.models.train import tree_leaves, value_and_grad

    def full(p):
        return p if frozen is None else merge_param_trees(frozen, p)

    paths = ["/".join(p) for p in tree_paths(params)]
    null = [any(p.endswith("/".join(n)) for n in null_grads) for p in paths]
    results = []
    for cfg in (kernel_cfg, plain_cfg):
        module = module_cls(cfg)

        def loss_fn(p, b, module=module):
            return loss(module(full(p), b[0]), b[1]), {}

        (value, _), grads = value_and_grad(loss_fn, params, batches[0])
        results.append((float(value), [g.float().flatten() for g in tree_leaves(grads)]))
        del grads
    (k_loss, k_grads), (p_loss, p_grads) = results
    null_norms = {p: (float(a.norm()), float(b.norm()))
                  for p, a, b, skip in zip(paths, k_grads, p_grads, null) if skip}
    per_tensor = [float(F.cosine_similarity(a, b, dim=0)) if not skip else None
                  for a, b, skip in zip(k_grads, p_grads, null)]
    cosines = [c for c in per_tensor if c is not None]
    bad = [(p, c) for p, c in zip(paths, per_tensor) if c is not None and not c >= cosine_min]
    if not all(np.isfinite([k_loss, p_loss])) or bad:
        raise AssertionError(
            f"{name} kernel-path gradients disagree with the plain path: losses {k_loss} vs "
            f"{p_loss}, tensors under cosine {cosine_min} (path, cosine) {bad[:5]}"
        )
    del results, k_grads, p_grads

    step = step_factory(module_cls(kernel_cfg))
    runs = []
    for _ in range(2):
        if frozen is None:
            state = TrainState.create(apply_fn=module_cls(kernel_cfg), params=params,
                                      tx=adamw(lr))
        else:
            state = LoRATrainState.create(apply_fn=module_cls(kernel_cfg), params=params,
                                          tx=adamw(lr), frozen_params=frozen)
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
           "grad_tensors": len(cosines), "null_grad_norms": null_norms,
           "rerun_losses": losses, "rerun_same_loss_bits": same_losses,
           "rerun_same_param_bits": same_params}
    log(f"{name}: one step, kernel path vs plain path: loss {k_loss} vs {p_loss}, min cosine "
        f"over {len(cosines)} gradient tensors {min(cosines)}"
        + (f" (norms of the {len(null_norms)} null gradients, kernel / plain: {null_norms})"
           if null_norms else "")
        + f"; two {len(batches)}-step runs: "
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
                    batches_per_epoch: int = 18, epochs: int = 3, warmup: int = 2,
                    train_step_options: dict = None, name: str = "vit",
                    keep_state: bool = False) -> dict:
    """Train ``config`` through the ported vision_tpu template
    (``build_model``, ``@model.train_step(**train_step_options)``,
    ``model.train``) on synthetic images with learnable labels: ``epochs``
    x ``batches_per_epoch`` steps of ``batch`` (54 steps by default, so the
    trainer's 50-step throughput window closes and sets the
    ``unionml_trainer_samples_per_sec`` gauge). The steps after the first
    ``warmup`` are timed (host clock between two waits for the card); the
    kernels' launches per timed step must be :data:`VIT_LAUNCHES_PER_STEP`
    and the last loss below the first. ``keep_state`` keeps the trained
    state under ``"state"`` (not JSON: the caller takes it out)."""
    from unionml_tpu_torch.templates.vision_tpu.app import build_model

    on_card = device == "cuda"
    steps = batches_per_epoch * epochs
    run = marked_training(
        lambda on_step: build_model(config, name=f"chip_smoke_{name}", reader_cache=False,
                                    on_step=on_step, train_step_options=train_step_options),
        vit_kernels(), steps=steps, warmup=warmup, on_card=on_card,
        hyperparameters={"device": device, "learning_rate": 3e-4},
        # the template's split keeps 80% for training
        trainer_kwargs={"num_epochs": epochs, "batch_size": batch},
        n=batch * batches_per_epoch * 5 // 4, seed=0,
    )
    if not keep_state:
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
    log(f"{name}: {steps} steps of batch {batch} ({warmup} warm-up): step_ms {step_ms} "
        f"samples/s {out['samples_per_s']} gauge unionml_trainer_samples_per_sec {gauge} "
        f"peak memory {out['peak_mem_gib']} GiB, wall {out['wall_s']} s (reader, split, "
        f"evaluation included)")
    log(f"{name}: loss first {losses[0]} last {losses[-1]}; eval {out['eval']}; launches per "
        f"timed step {per_step}; launches in the run {out['launches']}")
    if on_card:
        if per_step != VIT_LAUNCHES_PER_STEP:
            raise AssertionError(f"ViT kernel launches per step {per_step}, expected "
                                 f"{VIT_LAUNCHES_PER_STEP}")
        if not gauge > 0:
            raise AssertionError("the trainer set no unionml_trainer_samples_per_sec gauge")
    return out


# --------------------------------------------------------------------- #
# 3d: the threaded feed, goodput and checkpoints on ViT-B/16
# --------------------------------------------------------------------- #

GOODPUT_ATTRIBUTED_MIN = 0.95   # share of the trainer's wall time the goodput buckets explain


def same_state_bits(a, b) -> bool:
    """Whether two states (or trees) hold the same leaves: tensors bit for
    bit, counters equal."""
    from unionml_tpu_torch.checkpoint.pytree_io import state_tree
    from unionml_tpu_torch.models.train import tree_leaves

    la, lb = tree_leaves(state_tree(a)), tree_leaves(state_tree(b))
    return len(la) == len(lb) and all(
        (isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.shape == y.shape
         and torch.equal(_bits(x), _bits(y))) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb)
    )


def vit_feed_phase(config, inline: dict, inline_state, *, device: str = "cuda", batch: int = 64,
                   batches_per_epoch: int = 18, epochs: int = 3, warmup: int = 2) -> dict:
    """3b's run again with ``train_step(double_buffer=True, goodput=tracker)``:
    the feed on a feeder thread with its own copy stream, batches from the
    C++ host loader. The per-step losses and the final state must be the
    bits of the inline run (``inline``, ``inline_state``: the same seeded
    init and batch stream, kernels without atomics), the ViT launches per
    step :data:`VIT_LAUNCHES_PER_STEP` (checked by :func:`vit_train_phase`
    on the card), and the goodput buckets must explain at least
    :data:`GOODPUT_ATTRIBUTED_MIN` of the trainer's wall time."""
    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.data.native import get_library
    from unionml_tpu_torch.goodput import GoodputTracker

    if device == "cuda" and get_library() is None:
        raise AssertionError("the C++ host loader did not build: the feed would take the "
                             "numpy path")
    tracker = GoodputTracker(registry=telemetry.MetricsRegistry())
    run = vit_train_phase(config, device=device, batch=batch,
                          batches_per_epoch=batches_per_epoch, epochs=epochs, warmup=warmup,
                          train_step_options={"double_buffer": True, "goodput": tracker},
                          name="vit_feed", keep_state=True)
    same_state = same_state_bits(run.pop("state"), inline_state)
    same_losses = run["losses"] == inline["losses"]
    report = tracker.report()
    buckets = report["buckets_s"]
    out = {"native_loader": get_library() is not None, "threaded": run,
           "inline_step_ms": inline["step_ms"], "threaded_step_ms": run["step_ms"],
           "inline_samples_per_s": inline["samples_per_s"],
           "threaded_samples_per_s": run["samples_per_s"],
           "same_loss_bits": same_losses, "same_state_bits": same_state, "goodput": report}
    log(f"vit_feed: step_ms inline {inline['step_ms']} threaded {run['step_ms']}; samples/s "
        f"inline {inline['samples_per_s']} threaded {run['samples_per_s']}; native loader "
        f"{out['native_loader']}")
    log(f"vit_feed: goodput wall {report['wall_s']} s, attributed "
        f"{report['attributed_fraction']}, goodput ratio {report['goodput_ratio']}; compute "
        f"{buckets['compute']} s, data_wait {buckets['data_wait']} s, host_to_device "
        f"{buckets['host_to_device']} s")
    log(f"vit_feed: threaded vs inline: same loss bits {same_losses}, same state bits "
        f"{same_state}")
    if not (same_losses and same_state):
        raise AssertionError("the threaded feed's run differs from the inline run's bits")
    if report["attributed_fraction"] < GOODPUT_ATTRIBUTED_MIN:
        raise AssertionError(f"goodput attributes {report['attributed_fraction']} of the "
                             f"wall time, below {GOODPUT_ATTRIBUTED_MIN}")
    return out


def vit_elastic_phase(config, *, device: str = "cuda", batch: int = 64, steps: int = 16,
                      save_every: int = 4, preempt_at: int = 10) -> dict:
    """ViT ``config`` through the template's ``model.train`` with
    ``train_step(checkpoint_dir=..., save_every=4, double_buffer=True,
    goodput=tracker)`` for ``steps`` steps, uninterrupted; then the same
    run with a :class:`Preemption` raised by the elastic trainer's fault
    hook after step ``preempt_at``, and a relaunch from a fresh state,
    which must resume at the newest checkpoint before it and end at the
    uninterrupted run's bits (params and optimizer state). Records the
    checkpoint's bytes, the save stall on the loop, the background commit,
    the restore, and the ``checkpoint`` / ``preemption`` buckets. The
    checkpoints live in a temporary directory under ``build/``, deleted at
    the end."""
    import shutil
    import tempfile

    from unionml_tpu_torch import elastic, telemetry
    from unionml_tpu_torch.checkpoint._metrics import checkpoint_metrics, tree_nbytes
    from unionml_tpu_torch.checkpoint.async_writer import AsyncCheckpointManager
    from unionml_tpu_torch.checkpoint.pytree_io import state_tree
    from unionml_tpu_torch.goodput import GoodputTracker
    from unionml_tpu_torch.templates.vision_tpu.app import build_model

    (HERE / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="elastic-", dir=HERE / "build"))

    def train(ckpt: Path) -> tuple:
        tracker = GoodputTracker(registry=telemetry.MetricsRegistry())
        model = build_model(config, name="chip_smoke_vit_elastic", reader_cache=False,
                            train_step_options=dict(checkpoint_dir=str(ckpt),
                                                    save_every=save_every, max_checkpoints=2,
                                                    double_buffer=True, goodput=tracker))
        state, _ = model.train(hyperparameters={"device": device, "learning_rate": 3e-4},
                               trainer_kwargs={"num_epochs": 1, "batch_size": batch},
                               # the template's split keeps 80% for training
                               n=batch * steps * 5 // 4, seed=0)
        return state, tracker

    def samples(tracker, series: str) -> list:
        return checkpoint_metrics(tracker.registry)[series].labels("async").samples()

    real = elastic.run_elastic_trainer

    def with_fault(**kwargs):
        def hook(step: int) -> None:
            if step == preempt_at:
                raise elastic.Preemption(f"preempted after step {step}")

        return real(fault_hook=hook, **kwargs)

    try:
        whole, whole_tracker = train(root / "whole")
        elastic.run_elastic_trainer = with_fault
        try:
            train(root / "preempted")
            raise AssertionError("the injected preemption did not stop the run")
        except elastic.Preemption:
            pass
        finally:
            elastic.run_elastic_trainer = real
        resume_step = AsyncCheckpointManager(root / "preempted").latest_step()
        resumed, resumed_tracker = train(root / "preempted")
        same = same_state_bits(whole, resumed)
        nbytes = tree_nbytes(state_tree(whole))
        whole_report, resumed_report = whole_tracker.report(), resumed_tracker.report()
        out = {
            "steps": steps, "save_every": save_every, "preempt_at": preempt_at,
            "resume_step": resume_step, "final_step": resumed.step,
            "optimizer_count": resumed.opt_state["count"], "same_state_bits": same,
            "checkpoint_bytes": nbytes,
            "save_stall_ms": samples(whole_tracker, "save_ms"),
            "commit_ms": samples(whole_tracker, "commit_ms"),
            "restore_ms": samples(resumed_tracker, "restore_ms"),
            "whole_checkpoint_s": whole_report["badput_s"]["checkpoint"],
            "resumed_checkpoint_s": resumed_report["badput_s"]["checkpoint"],
            "resumed_preemption_s": resumed_report["badput_s"]["preemption"],
            "whole_attributed": whole_report["attributed_fraction"],
            "whole_wall_s": whole_report["wall_s"], "resumed_wall_s": resumed_report["wall_s"],
        }
        del whole, resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"vit_elastic: {steps} steps, a save every {save_every}: checkpoint {nbytes} bytes; "
        f"save stall on the loop ms {out['save_stall_ms']}; commit ms {out['commit_ms']}; "
        f"buckets: checkpoint {out['whole_checkpoint_s']} s of {out['whole_wall_s']} s wall "
        f"(attributed {out['whole_attributed']})")
    log(f"vit_elastic: preempted after step {preempt_at}, resumed at step {resume_step}: "
        f"restore ms {out['restore_ms']}; buckets: preemption {out['resumed_preemption_s']} s, "
        f"checkpoint {out['resumed_checkpoint_s']} s; final step {out['final_step']}, "
        f"optimizer count {out['optimizer_count']}; same bits as the uninterrupted run {same}")
    expected_resume = preempt_at - preempt_at % save_every
    if resume_step != expected_resume or out["final_step"] != steps \
            or out["optimizer_count"] != steps:
        raise AssertionError(f"the relaunch resumed at step {resume_step} (expected "
                             f"{expected_resume}) and ended at step {out['final_step']}")
    if not same:
        raise AssertionError("the preempted and resumed run ended at other bits than the "
                             "uninterrupted run")
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


# the delta pass (sum_j p_ij dp_ij in fp32) row by row against the same sum
# in fp64 on the same lse: |kernel - fp64| over the row's sum of |p_ij
# dp_ij|. fp32 sums of a few thousand terms in another order, and p from
# exp2 in fp32, stay near 1e-5 of it; a row whose last visible key tile is
# skipped loses that tile's share of its terms.
DELTA_ROW_LIMIT = 1e-3


def _dropped_tile_visible(q_len: int, kv_len: int, causal: bool, device) -> torch.Tensor:
    """bool [Sq, Skv]: the pairs a kernel sees whose key loop stops one
    tile short: each query's last visible key tile hidden (for queries that
    see more than one tile)."""
    from unionml_tpu_torch.ops import flash_attention as fa

    rows = torch.arange(q_len, device=device)
    last = (rows + (kv_len - q_len)).clamp(0, kv_len - 1) if causal else \
        torch.full_like(rows, kv_len - 1)
    last_tile = (last // FLASH_TILE)[:, None]
    key_tile = (torch.arange(kv_len, device=device) // FLASH_TILE)[None, :]
    vis = fa._causal_visible(q_len, kv_len, device) if causal else \
        torch.ones(q_len, kv_len, dtype=torch.bool, device=device)
    return vis & ~((key_tile == last_tile) & (last_tile > 0))


def dropped_tile_fault(q, k, v, do, lse, *, causal: bool, scale: float):
    """A planted fault the row check must reject: the plain forward and
    backward with each query's last visible key tile skipped (for queries
    that see more than one tile), as a kernel with its key loop one tile
    short would compute. ``(out, dq, dk, dv)``; the backward recomputes p
    on the given ``lse`` and sums its delta over the same pairs, as the
    kernels do."""
    from unionml_tpu_torch.ops import flash_attention as fa

    vis = _dropped_tile_visible(q.shape[1], k.shape[1], causal, q.device)
    bad_out = fa._plain_forward(q, k, v, vis, scale)[0]
    return (bad_out, *fa._plain_backward(q, k, v, do, lse, None, vis, scale))


def delta_exact(q, k, v, do, lse, *, causal: bool, scale: float,
                skip_last_tile: bool = False) -> tuple:
    """The delta pass's sum in fp64 on the given ``lse``: ``(delta, row
    scale)``, both fp64 [B, H, Sq], the scale being the row's sum of
    |p_ij dp_ij| (1e-30 for a row that sees nothing). With
    ``skip_last_tile`` each query's last visible key tile is hidden (the
    planted fault of :func:`check_delta_rows`). Summed one kv head at a time."""
    from unionml_tpu_torch.ops import flash_attention as fa

    b, q_len, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    vis = (_dropped_tile_visible(q_len, k.shape[1], causal, q.device) if skip_last_tile else
           fa._causal_visible(q_len, k.shape[1], q.device) if causal else None)
    f64 = torch.float64
    lse_g = lse.reshape(b, kvh, g, q_len, 1).to(f64)
    sums, scales = [], []
    for j in range(kvh):
        qj = q[:, :, j * g:(j + 1) * g].to(f64)
        doj = do[:, :, j * g:(j + 1) * g].to(f64)
        kj, vj = k[:, :, j].to(f64), v[:, :, j].to(f64)
        p = torch.exp(torch.einsum("bqgd,bkd->bgqk", qj, kj) * scale - lse_g[:, j])
        if vis is not None:
            p = torch.where(vis, p, torch.zeros_like(p))
        t = p * torch.einsum("bqgd,bkd->bgqk", doj, vj)
        sums.append(t.sum(-1))
        scales.append(t.abs().sum(-1))
        del p, t
    return (torch.cat(sums, 1).reshape(b, h, q_len),
            torch.cat(scales, 1).reshape(b, h, q_len).clamp_min(1e-30))


def check_delta_rows(name: str, got: torch.Tensor, q, k, v, do, lse, *, causal: bool,
                     scale: float) -> dict:
    """The delta pass row by row within :data:`DELTA_ROW_LIMIT` of the fp64
    sum (:func:`delta_exact`); the planted fault (each query's last visible
    key tile skipped) must fail the same check."""
    kw = dict(causal=causal, scale=scale)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} delta: kernel output is not finite")
    exact, row_scale = delta_exact(q, k, v, do, lse, **kw)
    rel = (got.double() - exact).abs() / row_scale
    stats = {"max_row_rel_err": float(rel.max()), "limit": DELTA_ROW_LIMIT,
             "plain_abs_max": float(exact.abs().max()),
             "plain_abs_median": float(exact.abs().median()),
             "max_abs_err": float((got.double() - exact).abs().max())}
    if stats["max_row_rel_err"] > DELTA_ROW_LIMIT:
        worst = int(rel.argmax())
        raise AssertionError(
            f"{name} delta: kernel disagrees with the fp64 sum: row {worst} (flat index over "
            f"{tuple(rel.shape)}) is off by {stats['max_row_rel_err']} of its sum of |p dp|, "
            f"beyond {DELTA_ROW_LIMIT}")
    fault = delta_exact(q, k, v, do, lse, skip_last_tile=True, **kw)[0]
    over = (fault - exact).abs() / row_scale > DELTA_ROW_LIMIT
    stats["fault_rows_over_limit"] = float(over.float().mean())
    if not bool(over.any()):
        raise AssertionError(f"{name} delta: the row check passed a planted fault (the last "
                             f"visible key tile skipped)")
    return stats


@contextlib.contextmanager
def output_delta_fault():
    """A planted fault for the flash backward's gradient checks: the
    reference kernel's ``delta = rowsum(dO * O)`` from the bf16 output
    (the forward run again for O) in place of the delta pass on the card,
    and of the plain version's sum on the CPU."""
    from unionml_tpu_torch.ops import flash_attention as fa

    delta_cuda, bwd_plain = fa.flash_delta_cuda, fa.flash_bwd_plain

    def planted_cuda(q, k, v, do, lse, *, causal, scale):
        return fa.output_delta(do, fa.flash_fwd_cuda(q, k, v, causal=causal, scale=scale)[0])

    def planted_plain(q, k, v, do, lse, *, causal, scale, delta=None):
        out = fa.flash_fwd_plain(q, k, v, causal=causal, scale=scale)[0]
        return bwd_plain(q, k, v, do, lse, causal=causal, scale=scale,
                         delta=fa.output_delta(do, out))

    fa.flash_delta_cuda, fa.flash_bwd_plain = planted_cuda, planted_plain
    try:
        yield
    finally:
        fa.flash_delta_cuda, fa.flash_bwd_plain = delta_cuda, bwd_plain


def check_flash_rows(name: str, got: dict, want: dict, fault: dict) -> dict:
    """Rows 9-11 (out, dq, dk, dv) row by row within
    :data:`FLASH_ROW_LIMIT`; the dropped-tile fault must fail."""
    return check_rows_with_fault(name, got, want, fault,
                                 dict.fromkeys(("out", "dq", "dk", "dv"), FLASH_ROW_LIMIT),
                                 "the last visible key tile skipped")


def lm_kernels() -> dict:
    """The wrappers (launch counters) of the Llama training path's kernels."""
    from unionml_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.FWD_KERNEL, "flash_bwd_delta": fa.DELTA_KERNEL,
            "flash_bwd_dq": fa.DQ_KERNEL, "flash_bwd_dkv": fa.DKV_KERNEL}


def _visible_pairs(q_len: int, kv_len: int, causal: bool) -> int:
    """(query, key) pairs one head attends over (bottom-right causal)."""
    if not causal:
        return q_len * kv_len
    off = kv_len - q_len
    return sum(min(kv_len, max(0, i + off + 1)) for i in range(q_len))


def flash_train_case(b: int, sq: int, skv: int, h: int, kvh: int, d: int, causal: bool,
                     gen) -> dict:
    """Rows 9, 10 and 11 at one shape: the lse forward against its plain
    version (out and lse), the delta pass row by row against fp64 sums
    (:func:`check_delta_rows`), the dq and dk/dv kernels against the plain
    backward on the kernel's own lse and delta, the forward, the delta
    pass and the backward each run twice (the same bits); times of each
    kernel, the plain versions, the bounds and the SDPA yardsticks (its
    forward for row 9, its backward alone for rows 10 and 11, and forward +
    backward against rows 9-11's total), and the backward (delta, dq,
    dk/dv) beside the same dq and dk/dv on the reference's ``delta =
    rowsum(dO * O)`` (one torch expression), the cost of the C7 repair."""
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
    delta_run = lambda: fa.flash_delta_cuda(q, k, v, do, lse, **kw)  # noqa: E731
    delta, delta_again = delta_run(), delta_run()
    dq_run = lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)  # noqa: E731
    dkv_run = lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)  # noqa: E731
    grads, again = (dq_run(), *dkv_run()), (dq_run(), *dkv_run())
    torch.cuda.synchronize()
    name = f"flash b={b} sq={sq} skv={skv} h={h}/{kvh} d={d} causal={causal}"
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, **kw)
    check_close(f"{name} lse", lse, want_lse, LSE_TOL)
    delta_check = check_delta_rows(name, delta, q, k, v, do, lse, **kw)
    want = dict(zip(("out", "dq", "dk", "dv"),
                    (want_out, *fa.flash_bwd_plain(q, k, v, do, lse, **kw))))
    fault = dict(zip(want, dropped_tile_fault(q, k, v, do, lse, **kw)))
    checks = check_flash_rows(name, dict(zip(want, (out, *grads))), want, fault)
    if not (torch.equal(out, out_again) and torch.equal(lse, lse_again)):
        raise AssertionError(f"{name}: two forward runs differ")
    if not torch.equal(delta, delta_again):
        raise AssertionError(f"{name}: two delta passes differ")
    del out_again, lse_again, delta_again
    for g_name, got, same in zip(("dq", "dk", "dv"), grads, again):
        if not torch.equal(got, same):
            raise AssertionError(f"{name} {g_name}: two backward runs differ")
    errs = {t_name: c["max_abs_err"] for t_name, c in checks.items()}
    del want, want_out, want_lse, fault
    # work these inputs need: every visible (query, key) pair of every head
    pairs = b * h * _visible_pairs(sq, skv, causal)
    q_bytes, kv_bytes, stat_bytes = q.numel() * 2, k.numel() * 2, b * h * sq * 4
    bounds = {
        "flash_bwd_delta": bound(2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes,  # q, do, k, v
                                 4 * pairs * d, PEAK_BF16_OPS_S),          # S and dP
        "flash_fwd": bound(2 * q_bytes + 2 * kv_bytes + stat_bytes,          # q, out, k, v, lse
                           4 * pairs * d, PEAK_BF16_OPS_S),
        "flash_bwd_dq": bound(3 * q_bytes + 2 * kv_bytes + 2 * stat_bytes,   # q, do, dq, k, v
                              6 * pairs * d, PEAK_BF16_OPS_S),
        "flash_bwd_dkv": bound(2 * q_bytes + 4 * kv_bytes + 2 * stat_bytes,  # q, do, k, v, dk, dv
                               8 * pairs * d, PEAK_BF16_OPS_S),
    }
    plain_fwd_ms = time_ms(lambda: fa.flash_fwd_plain(q, k, v, **kw), iters=3, warmup=1)
    plain_bwd_ms = time_ms(lambda: fa.flash_bwd_plain(q, k, v, do, lse, **kw), iters=3,
                           warmup=1)
    plain_delta_ms = time_ms(lambda: fa.flash_delta(q, k, v, do, lse, **kw), iters=3, warmup=1)
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
        "flash_bwd_delta": {"max_abs_err": delta_check["max_abs_err"], "ms": time_ms(delta_run),
                            "plain_ms": plain_delta_ms, "library_ms": None,
                            "plain_call": "flash_delta",
                            "library_call": "none: no PyTorch call computes sum_j p_ij dp_ij "
                                            "alone",
                            "row_checks": {"delta": delta_check}},
        "flash_bwd_dq": {"max_abs_err": errs["dq"], "ms": time_ms(dq_run),
                         "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms,
                         "row_checks": {"dq": checks["dq"]}},
        "flash_bwd_dkv": {"max_abs_err": max(errs["dk"], errs["dv"]), "ms": time_ms(dkv_run),
                          "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms,
                          "row_checks": {"dk": checks["dk"], "dv": checks["dv"]}},
    }
    for row, case in cases.items():
        case.update(shape=shape, bound_ms=bounds[row][0], bound_by=bounds[row][1])
        if row in ("flash_bwd_dq", "flash_bwd_dkv"):
            case["plain_call"] = "flash_bwd_plain (dq, dk and dv together)"
            case["library_call"] = ("the backward of F.scaled_dot_product_attention(enable_gqa) "
                                    "alone (dq, dk and dv together; autograd.grad over a "
                                    "recorded forward)")
    total = lambda: (fwd(), fa.flash_bwd_cuda(q, k, v, do, lse, **kw))  # noqa: E731
    cases["flash_bwd_dkv"]["fwd_bwd_ms"] = time_ms(total)
    cases["flash_bwd_dkv"]["library_fwd_bwd_ms"] = time_ms(lib_fwd_bwd)
    # the backward with the delta pass, and the same dq and dk/dv kernels on
    # the reference's delta from the output (before the C7 repair), in turns
    bwd = lambda: fa.flash_bwd_cuda(q, k, v, do, lse, **kw)  # noqa: E731
    bwd_out = lambda: fa.flash_bwd_cuda(  # noqa: E731
        q, k, v, do, lse, delta=fa.output_delta(do, out), **kw)
    times = [time_ms(fn) for fn in (bwd_out, bwd, bwd, bwd_out)]
    cases["flash_bwd_delta"].update(
        bwd_ms=(times[1] + times[2]) / 2, bwd_output_delta_ms=(times[0] + times[3]) / 2,
        bwd_note="delta pass + dq + dk/dv against output delta (one torch expression) + "
                 "dq + dk/dv, timed in turns (output, pass, pass, output)")
    return cases


def flash_train_kernel_phase() -> dict:
    """Rows 9-11 at the llama_lc training shape (S = 4095: lm_step trains
    on tokens[:, :-1]), at the Llama-3-8B head geometry (S = 2048, and
    S = 1023, the QLoRA phase's shape), and at small non-causal and
    cross-length shapes."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for shape in ((2, 4095, 4095, 12, 4, 64, True), (1, 2048, 2048, 32, 8, 128, True),
                  (1, 1023, 1023, 32, 8, 128, True),
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
                   f"{c['library_fwd_bwd_ms']}" if "fwd_bwd_ms" in c else "")
                + (f" backward (delta, dq, dk/dv) ms {c['bwd_ms']}, on the output's delta "
                   f"{c['bwd_output_delta_ms']}" if "bwd_ms" in c else ""))
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


def build_lm_app(config, *, name: str, on_step=None, eval_batch: int = 2, make_state=None):
    """The LM app's Dataset/Model spec for ``config``: the reader makes
    ``n`` sequences of ``seq`` tokens (``rows > 0``: the first ``rows``
    of them repeated, a repeated batch) and returns the shifted pairs
    (``features = tokens[:, :-1]``, ``targets = tokens[:, 1:]``), a seeded
    splitter cuts them, the parser returns the pair; the Model's ``init=``
    builds an AdamW ``TrainState`` of ``Llama(config)`` on the ``device``
    hyperparameter (``None`` = CUDA), or ``make_state(learning_rate,
    device)`` when given (a LoRA state over a base built beforehand),
    ``@model.train_step`` runs ``lm_step`` on the ``(inputs, labels)``
    batches the trainer feeds, and the evaluator returns the mean cross
    entropy (``eval_batch`` rows at a time). ``on_step(state, metrics)`` is
    called after every step."""
    from typing import Optional

    from unionml_tpu_torch import Dataset, Model
    from unionml_tpu_torch._device import resolve_device
    from unionml_tpu_torch.models import (
        Llama,
        TrainState,
        create_train_state,
        lm_step,
        masked_cross_entropy,
        resolve_params,
    )

    module = Llama(config)
    dataset = Dataset(name=f"{name}_dataset", test_size=0.2)

    @dataset.reader
    def reader(n: int = 64, seq: int = 4096, seed: int = 0, rows: int = 0) -> dict:
        tokens = lm_tokens(rows or n, seq, config.vocab_size, seed)
        if rows:
            tokens = np.resize(tokens, (n, seq))
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
        if make_state is not None:
            return make_state(learning_rate, device)
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
        params = resolve_params(state)
        device = params["final_norm"]["scale"].device
        total = 0.0
        with torch.no_grad():
            for i in range(0, len(features), eval_batch):
                x = torch.as_tensor(features[i:i + eval_batch], device=device)
                y = torch.as_tensor(targets[i:i + eval_batch], device=device)
                total += float(masked_cross_entropy(module(params, x), y)) * len(x)
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
    waits for the card); rows 9, 10 and 11 and the delta pass must launch
    once per layer per timed step (the forward twice under ``remat``) and the last loss must
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
        want = {"flash_fwd": layers * (2 if config.remat else 1), "flash_bwd_delta": layers,
                "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
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


# --------------------------------------------------------------------- #
# QLoRA fine-tuning of Llama-3-8B (qlora_8b)
# --------------------------------------------------------------------- #

# the qlora_8b preset of benchmarks/train_throughput.py: a frozen int8
# Llama-3-8B base (fp32 embedding and norm scales, as the reference's
# training tree holds them), rank-16 adapters on q/k/v/o and gate/up/down,
# per-block recomputation, flash attention, batch 1 x 1024 tokens
QLORA_RANK = 16
QLORA_SEQ = 1024
# AdamW on the adapters at 1e-3: the loss must fall over 12 steps of one
# repeated batch (the reference's preset trains at 1e-4 and only times)
QLORA_LR = 1e-3
# adapter-tree gradients, bf16 kernel path vs bf16 plain (xla attention)
# path, per tensor
QLORA_GRAD_COSINE_MIN = 0.99
# logits of the merged tree on the rank-0 model vs the unmerged forward:
# max |merged - unmerged| over max |unmerged| (int8 requantization of the
# delta-shifted weights on top of bf16 noise; the reference's own bound)
QLORA_MERGE_LIMIT = 0.05
# lora_b's std in the agreement's adapters: non-zero so both factors get a
# gradient (lora_b = 0 gives lora_a none), the delta ~8% of a base product
QLORA_AGREEMENT_B_STD = 0.02


def qlora_config(**overrides):
    from unionml_tpu_torch.models import LlamaConfig

    kwargs = dict(quantized=True, remat=True, attn_impl="flash", max_len=2048,
                  lora_rank=QLORA_RANK)
    kwargs.update(overrides)
    return LlamaConfig(**kwargs)


def adapter_count(config) -> int:
    """Adapter elements of a Llama config: r (K + N) per dense site of
    every block."""
    from unionml_tpu_torch.models.convert import _dense_shapes

    return config.num_layers * sum(config.lora_rank * (k + n)
                                   for _, (k, n) in _dense_shapes(config).values())


def leaf_checksums(tree, chunk: int = 1 << 24) -> list:
    """One checksum of the bits of each tensor leaf of ``tree``, computed
    where the leaf lives, ``chunk`` words at a time (no copy of the tree):
    the sum of its 32-bit words (16- or 8-bit when its size asks) and their
    sum weighted by position (mod 8191, plus 1), in int64 (wrapping), as a
    list of integer pairs."""
    from unionml_tpu_torch.models.train import tree_leaves

    sums = []
    for leaf in tree_leaves(tree):
        flat = leaf.contiguous().flatten()
        nbytes = flat.numel() * flat.element_size()
        word = torch.int32 if nbytes % 4 == 0 else (
            torch.int16 if flat.element_size() == 2 else torch.int8)
        words = flat.view(word)
        total = torch.zeros(2, dtype=torch.long, device=words.device)
        for start in range(0, words.numel(), chunk):
            w = words[start:start + chunk].long()
            pos = torch.arange(start, start + w.numel(), device=w.device) % 8191 + 1
            total += torch.stack([w.sum(), (w * pos).sum()])
        sums.append(total)
    return torch.stack(sums).tolist()


def qlora_train_phase(config, *, device: str = "cuda", seq: int = QLORA_SEQ, steps: int = 12,
                      warmup: int = 2) -> dict:
    """QLoRA fine-tuning through the LM app's ``model.train``
    (``@model.train_step`` -> ``run_step_trainer`` -> ``lm_step``) of
    rank-``config.lora_rank`` adapters on a frozen random int8 base built
    leaf by leaf on ``device``, batch 1 x ``seq`` tokens, ``steps`` steps of
    one repeated sequence at lr :data:`QLORA_LR`, the steps after
    ``warmup`` timed. Checks: the base's bits unchanged (per-leaf
    checksums), AdamW state of exactly twice the adapter elements (plus
    the step counter), the loss falling, and (on the card) rows 9 / 10 /
    11 launched twice / once / once per layer per timed step (the forward
    twice under ``remat``)."""
    from unionml_tpu_torch.models import Llama, create_lora_train_state
    from unionml_tpu_torch.models.train import tree_leaves

    on_card = device == "cuda"
    t0 = time.perf_counter()
    base = random_quantized_params(config, 7, device=device, float_dtype=torch.float32)
    base_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(base))
    before = leaf_checksums(base)
    build_s = time.perf_counter() - t0

    def make_state(learning_rate, device_arg):
        example = torch.zeros(1, 8, dtype=torch.long, device=device)
        return create_lora_train_state(Llama(config), example, base_params=base,
                                       learning_rate=learning_rate)

    run = marked_training(
        lambda on_step: build_lm_app(config, name="chip_smoke_qlora", on_step=on_step,
                                     make_state=make_state),
        lm_kernels(), steps=steps, warmup=warmup, on_card=on_card,
        hyperparameters={"device": device, "learning_rate": QLORA_LR},
        # the splitter keeps 80% for training: `steps` rows of batch 1
        trainer_kwargs={"num_epochs": 1, "batch_size": 1},
        n=steps * 5 // 4, seq=seq, seed=0, rows=1,
    )
    state = run.pop("state")
    del base
    adapters = sum(t.numel() for t in tree_leaves(state.params))
    moments = sum(t.numel() for t in tree_leaves((state.opt_state["mu"], state.opt_state["nu"])))
    counters = [k for k, v in state.opt_state.items() if not isinstance(v, dict)]
    same_base = leaf_checksums(state.frozen_params) == before
    if adapters != adapter_count(config):
        raise AssertionError(f"{adapters} adapter elements, expected {adapter_count(config)}")
    if moments != 2 * adapters or counters != ["count"]:
        raise AssertionError(f"AdamW state of {moments} elements and counters {counters}, "
                             f"expected {2 * adapters} and ['count']")
    if not same_base:
        raise AssertionError("the frozen base's bits changed in training")
    del state
    step_ms, per_step, losses = run["step_ms"], run["launches_per_step"], run["losses"]
    out = {
        "config": f"Llama vocab {config.vocab_size}, width {config.hidden_dim}, "
                  f"{config.num_layers} layers, {config.num_heads}/{config.num_kv_heads} heads, "
                  f"mlp {config.mlp_dim}, int8 base (fp32 embedding, norms and scales), "
                  f"{config.dtype} compute, LoRA rank {config.lora_rank} alpha "
                  f"{config.lora_alpha} on q/k/v/o/gate/up/down, attn {config.attn_impl}, "
                  f"norm {config.norm_impl}, remat {config.remat}",
        "base_bytes": base_bytes, "base_build_s": build_s, "adapters": adapters,
        "adamw_moment_elements": moments, "adamw_counters": counters,
        "base_bits_unchanged": same_base, "batch": 1, "seq": seq, "steps": steps,
        "learning_rate": QLORA_LR, "tokens_per_s": (seq - 1) / step_ms * 1e3,
        "first_loss": losses[0], "last_loss": losses[-1], **run,
    }
    log(f"qlora: {config.num_layers} layers, base {base_bytes} bytes built in {build_s:.2f} s, "
        f"{adapters} adapter params, AdamW moments {moments}; {steps} steps of 1 x {seq} tokens "
        f"({warmup} warm-up): step_ms {step_ms} tokens/s {out['tokens_per_s']} peak memory "
        f"{out['peak_mem_gib']} GiB, wall {out['wall_s']} s")
    log(f"qlora: loss first {losses[0]} last {losses[-1]}; eval {out['eval']}; base bits "
        f"unchanged {same_base}; launches per timed step {per_step}")
    if on_card:
        layers = float(config.num_layers)
        want = {"flash_fwd": 2 * layers if config.remat else layers, "flash_bwd_delta": layers,
                "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
        if per_step != want:
            raise AssertionError(f"QLoRA kernel launches per step {per_step}, expected {want}")
    return out


def qlora_agreement(config, *, device: str = "cuda", seq: int = QLORA_SEQ,
                    layers: int = 4) -> dict:
    """At ``layers`` layers and full width: one step's adapter gradients
    of the kernel path against the plain path (``attn_impl="xla"``) from
    one random int8 base and adapters with a non-zero ``lora_b``
    (per-tensor cosine at least :data:`QLORA_GRAD_COSINE_MIN`), two 3-step
    ``lm_step`` runs from one LoRA state with the same loss bits; then the
    adapters folded in with ``merge_lora``: the merged tree's logits on the
    rank-0 model within :data:`QLORA_MERGE_LIMIT` of the unmerged forward,
    and 4 tokens served from it through ``make_lm_predictor``."""
    from unionml_tpu_torch.models import (
        Llama,
        lm_step,
        make_lm_predictor,
        masked_cross_entropy,
        merge_lora,
        merge_param_trees,
    )
    from unionml_tpu_torch.models.lora import init_lora_params

    config = dataclasses.replace(config, num_layers=layers)
    base = random_quantized_params(config, 8, device=device, float_dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(9)
    adapters = init_lora_params(config, gen)
    for block in adapters.values():
        for part in block.values():
            for site in part.values():
                site["lora_b"] = QLORA_AGREEMENT_B_STD * torch.randn(
                    site["lora_b"].shape, generator=gen, device=device)
    tokens = torch.from_numpy(lm_tokens(3, seq, config.vocab_size, seed=9)).to(device)
    out = path_agreement(
        f"qlora ({layers} layers)", Llama, config, dataclasses.replace(config, attn_impl="xla"),
        masked_cross_entropy, lm_step, adapters,
        [(t[:, :-1], t[:, 1:]) for t in tokens.split(1)], lr=QLORA_LR,
        cosine_min=QLORA_GRAD_COSINE_MIN, frozen=base,
    )
    full = merge_param_trees(base, adapters)
    merged = merge_lora(full, alpha=config.lora_alpha)
    serve_cfg = dataclasses.replace(config, lora_rank=0)
    with torch.no_grad():
        want = Llama(config)(full, tokens[:1, :128]).float()
        got = Llama(serve_cfg)(merged, tokens[:1, :128]).float()
    merge_err = float((got - want).abs().max() / want.abs().max())
    predictor = make_lm_predictor(Llama(serve_cfg), max_new_tokens=4, bucket_lens=(16,))
    served = predictor(merged, [[5, 6, 7, 8]])
    if not merge_err <= QLORA_MERGE_LIMIT:
        raise AssertionError(f"merged-tree logits off the unmerged forward by {merge_err} of "
                             f"their max, limit {QLORA_MERGE_LIMIT}")
    if len(served) != 1 or len(served[0]) != 4 or not all(
            0 <= t < config.vocab_size for t in served[0]):
        raise AssertionError(f"the merged tree served {served}, expected 4 token ids")
    log(f"qlora ({layers} layers): merged-tree logits max err / max {merge_err}; served "
        f"{served[0]} from the merged tree")
    return {"layers": layers, **out, "merge_rel_err": merge_err, "merged_served": served[0]}


# --------------------------------------------------------------------- #
# 3f: BERT-base fine-tuning and masked-LM training
# --------------------------------------------------------------------- #

# benchmarks/train_throughput.py's BERT-base fine-tune: 32 x 128 ids and
# random binary labels, no padding mask, AdamW
BERT_BATCH, BERT_SEQ = 32, 128
BERT_LR = 1e-4
# the MLM batches: 16 rows of max_len ids, right-padded to lengths drawn in
# [128, 512], the BERT masking rule with [MASK] = 103
BERT_MLM_BATCH, BERT_MLM_MIN_LEN, BERT_MASK_ID = 16, 128, 103
BERT_GRAD_COSINE_MIN = 0.99   # bf16 kernel path vs bf16 plain path, per gradient tensor
# a padded row's logits against the row run alone: the tolerance of the
# reference's padding test (tests/unit/test_models.py:76), bf16 through
# every layer
BERT_PAD_TOL = dict(rtol=2e-2, atol=2e-2)


def bert_kernels() -> dict:
    """The wrappers (launch counters) of BERT's unmasked training path."""
    from unionml_tpu_torch.ops import fused_attention as tfa

    return {"fused_attention_fwd": tfa.FWD_KERNEL, "fused_attention_bwd": tfa.BWD_KERNEL}


def bert_launches_per_step(config, seq: int) -> dict:
    """Rows 12-13 a training step of an unmasked batch: once a layer each
    under ``fused`` (or ``auto`` up to the fused limit), else none."""
    from unionml_tpu_torch.ops.fused_attention import MAX_FUSED_SEQ

    fused = config.attn_impl == "fused" or (config.attn_impl == "auto" and seq <= MAX_FUSED_SEQ)
    return dict.fromkeys(bert_kernels(), float(config.num_layers) if fused else 0.0)


def bert_batch(n: int, seq: int, config, seed: int) -> tuple:
    """``n`` rows of ``seq`` uniform token ids and uniform class labels
    (the benchmark's batch), from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, config.vocab_size, size=(n, seq)),
            rng.integers(0, config.num_classes, size=(n,)))


def build_bert_app(config, *, name: str, on_step=None):
    """The BERT fine-tune app's Dataset/Model spec for ``config``: the
    reader makes ``n`` rows of ``seq`` ids with labels
    (:func:`bert_batch`), a seeded splitter cuts them, the parser returns
    ``(ids, labels)``; the Model's ``init=`` builds an AdamW ``TrainState``
    of ``BertClassifier(config)`` on the ``device`` hyperparameter
    (``None`` = CUDA), ``@model.train_step`` runs ``classification_step``
    and the evaluator returns the accuracy. ``on_step(state, metrics)`` is
    called after every step."""
    from typing import Optional

    from unionml_tpu_torch import Dataset, Model
    from unionml_tpu_torch._device import resolve_device
    from unionml_tpu_torch.models import (
        BertClassifier,
        TrainState,
        classification_step,
        create_train_state,
        make_evaluator,
    )

    module = BertClassifier(config)
    dataset = Dataset(name=f"{name}_dataset", test_size=0.2)

    @dataset.reader
    def reader(n: int = 40, seq: int = BERT_SEQ, seed: int = 0) -> dict:
        ids, labels = bert_batch(n, seq, config, seed)
        return {"features": ids, "targets": labels}

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

    def init(learning_rate: float = BERT_LR, device: Optional[str] = None) -> TrainState:
        example = torch.zeros(1, 8, dtype=torch.long, device=resolve_device(device))
        return create_train_state(module, example, learning_rate=learning_rate)

    model = Model(name=name, init=init, dataset=dataset)
    step = classification_step(module)

    @model.train_step
    def train_step(state, batch):
        state, metrics = step(state, batch)
        if on_step is not None:
            on_step(state, metrics)
        return state, metrics

    model.evaluator(make_evaluator(module))
    return model


def bert_finetune_phase(config, *, device: str = "cuda", batch: int = BERT_BATCH,
                        seq: int = BERT_SEQ, steps: int = 22, warmup: int = 2) -> dict:
    """Fine-tune ``BertClassifier(config)`` through the app's
    ``model.train`` (``@model.train_step`` -> ``run_step_trainer`` ->
    ``classification_step``) on one repeated batch: the reader's ``batch *
    5 / 4`` rows split to ``batch`` training rows, so each of the ``steps``
    epochs is one step over the same rows, shuffled. The steps after the
    first ``warmup`` are timed; rows 12-13 must launch
    :func:`bert_launches_per_step` times a timed step and the last loss
    must be below the first."""
    on_card = device == "cuda"
    run = marked_training(
        lambda on_step: build_bert_app(config, name=f"chip_smoke_bert_{config.attn_impl}",
                                       on_step=on_step),
        bert_kernels(), steps=steps, warmup=warmup, on_card=on_card,
        hyperparameters={"device": device, "learning_rate": BERT_LR},
        trainer_kwargs={"num_epochs": steps, "batch_size": batch},
        n=batch * 5 // 4, seq=seq, seed=0,
    )
    del run["state"]
    step_ms, per_step, losses = run["step_ms"], run["launches_per_step"], run["losses"]
    out = {"attn_impl": config.attn_impl, "batch": batch, "seq": seq, "steps": steps,
           "samples_per_s": batch / step_ms * 1e3, "first_loss": losses[0],
           "last_loss": losses[-1], **run}
    log(f"bert fine-tune ({config.attn_impl}): {steps} steps of {batch} x {seq} ids ({warmup} "
        f"warm-up): step_ms {step_ms} samples/s {out['samples_per_s']} peak memory "
        f"{out['peak_mem_gib']} GiB, wall {out['wall_s']} s; loss first {losses[0]} last "
        f"{losses[-1]}; eval {out['eval']}; launches per timed step {per_step}")
    want = bert_launches_per_step(config, seq)
    if on_card and per_step != want:
        raise AssertionError(f"BERT ({config.attn_impl}) kernel launches per step {per_step}, "
                             f"expected {want}")
    return out


def capture_attention(module, params, batch, loss) -> list:
    """One forward and backward of ``module`` (a BERT model, unmasked) on
    ``batch`` (``(ids, labels)``) with each block's attention recorded
    through the block's own layers: forward hooks on ``attn_q`` /
    ``attn_k`` / ``attn_v`` take q, k and v, a pre-hook on ``attn_o``
    takes the attention output o, and a gradient hook on o takes do. One
    dict a block."""
    from unionml_tpu_torch.models.train import value_and_grad

    layers = [{} for _ in module.encoder.blocks]
    handles = []

    def keep(rec, name):
        return lambda mod, args, out: rec.__setitem__(name, out.detach())

    def keep_o(rec):
        def hook(mod, args):
            rec["o"] = args[1].detach()
            args[1].register_hook(lambda g: rec.__setitem__("do", g.detach()))
        return hook

    for rec, block in zip(layers, module.encoder.blocks):
        for name in ("q", "k", "v"):
            handles.append(getattr(block, f"attn_{name}").register_forward_hook(keep(rec, name)))
        handles.append(block.attn_o.register_forward_pre_hook(keep_o(rec)))
    try:
        value_and_grad(lambda p, b: (loss(module(p, b[0]), b[1]), {}), params, batch)
    finally:
        for h in handles:
            h.remove()
    if any(set(rec) != {"q", "k", "v", "o", "do"} for rec in layers):
        raise AssertionError(f"the capture missed a block's attention: {[sorted(r) for r in layers]}")
    return layers


def bert_layer_rows(layers: list, *, on_card: bool) -> list:
    """Rows 12-13 on each BERT block's own attention (``capture_attention``
    of the kernel path): the forward again on the captured q (times the
    op's bf16 factor), k and v must give the captured o bit for bit; then
    the kernels' forward and backward (at the captured do) row by row
    within :data:`FUSED_ROW_LIMIT` of the same arithmetic with fp64 sums
    (:func:`fused_exact`), where the skipped-chunk fault must fail
    (:func:`check_fused_rows`). In the last blocks ``dp - delta`` and the
    rows of dq and dk cancel, and the plain version's own fp32 sums move a
    row of dk by up to 2.3% of its max there, so the kernel is held to the
    exact sums, not to a second rounding of them; the plain version's and
    the kernel's distances from each other are reported. On the CPU the
    plain versions stand in for the kernels, as the op's own CPU path
    does."""
    from unionml_tpu_torch.ops import fused_attention as tfa

    fwd, bwd = ((tfa.fused_attention_fwd_cuda, tfa.fused_attention_bwd_cuda) if on_card else
                (tfa.fused_attention_fwd_plain, tfa.fused_attention_bwd_plain))
    names = ("out", "dq", "dk", "dv")
    out = []
    for i, rec in enumerate(layers):
        k, v, do = (rec[n].contiguous() for n in ("k", "v", "do"))
        q = rec["q"]
        q = q * float(torch.tensor(q.shape[-1] ** -0.5 * tfa.LOG2E, dtype=q.dtype))
        o = fwd(q, k, v, causal=False)
        if not torch.equal(o, rec["o"]):
            raise AssertionError(f"bert block {i}: the forward on the captured inputs differs "
                                 f"from the step's attention output")
        got = dict(zip(names, (o, *bwd(q, k, v, do, causal=False))))
        plain = dict(zip(names, (tfa.fused_attention_fwd_plain(q, k, v, causal=False),
                                 *tfa.fused_attention_bwd_plain(q, k, v, do, causal=False))))
        want = dict(zip(names, fused_exact(q, k, v, do, causal=False)))
        fault = dict(zip(names, skipped_chunk_fault(q, k, v, do, causal=False)))
        checks = check_fused_rows(f"bert block {i} attention", got, want, fault)
        plain_err = {n: float(row_rel_err(plain[n], want[n]).max()) for n in names}
        vs_plain = {n: float(row_rel_err(got[n], plain[n]).max()) for n in names}
        out.append({"kernel": checks, "plain_version_vs_exact": plain_err,
                    "kernel_vs_plain_version": vs_plain})
        log(f"bert block {i} attention, rows 12-13 on the step's own inputs against fp64 "
            f"sums: kernel max row err "
            + ", ".join(f"{n} {checks[n]['max_row_rel_err']}" for n in names)
            + f" (limits {FUSED_ROW_LIMIT}); planted fault: rows over "
            f"{min(c['fault_rows_over_limit'] for c in checks.values())}; not held: plain "
            f"version vs fp64 sums {plain_err}, kernel vs plain version {vs_plain}")
    return out


def bert_grad_agreement(config, *, device: str = "cuda", batch: int = BERT_BATCH,
                        seq: int = BERT_SEQ, delta_fault: bool = True) -> dict:
    """Under ``fused``: rows 12-13 on every block's own attention of one
    kernel-path step (:func:`bert_layer_rows`). Then that step's loss and
    gradients of ``BertClassifier(config)`` against ``attn_impl="xla"``
    from the same params and batch (per-tensor cosine
    :data:`BERT_GRAD_COSINE_MIN`, :func:`path_agreement`), then two 3-step
    ``classification_step`` runs of the kernel path from one state, whose
    losses must be the same bits. The key projection's bias adds one
    constant to every score of a row, which the softmax cancels: its
    gradient is rounding only, reported beside the cosines. Under
    ``flash`` (rows 9-11 and the delta pass) with ``delta_fault``, the same
    step again with the reference's delta from the bf16 output planted
    (:func:`bert_flash_delta_fault`): it must read under the cosine on the
    last blocks, which is what the delta pass repairs (ROADMAP.md C7)."""
    import torch.nn.functional as F

    from unionml_tpu_torch.models import BertClassifier, classification_step, init_bert_params

    gen = torch.Generator(device=device).manual_seed(5)
    ids, labels = bert_batch(3 * batch, seq, config, seed=5)
    ids, labels = torch.from_numpy(ids).to(device), torch.from_numpy(labels).to(device)
    params = init_bert_params(config, head="classifier", generator=gen, device=device)
    batches = list(zip(ids.split(batch), labels.split(batch)))
    loss = lambda logits, y: F.cross_entropy(logits.float(), y)  # noqa: E731
    rows = None
    if config.attn_impl == "fused":
        layers = capture_attention(BertClassifier(config), params, batches[0], loss)
        rows = bert_layer_rows(layers, on_card=device == "cuda")
        del layers
    out = path_agreement(
        f"bert ({config.attn_impl} vs xla)", BertClassifier, config,
        dataclasses.replace(config, attn_impl="xla"), loss, classification_step, params,
        batches, lr=BERT_LR, cosine_min=BERT_GRAD_COSINE_MIN, null_grads=(("attn_k", "bias"),),
    )
    if rows is not None:
        out["layer_rows"] = rows
    if config.attn_impl == "flash" and delta_fault:
        out["output_delta_fault"] = bert_flash_delta_fault(config, params, batches[0], loss)
    return out


def block_cosines(module_cls, config, plain_config, loss, params, batch,
                  null_grads: tuple = ()) -> dict:
    """One step's gradients of ``module_cls(config)`` against
    ``module_cls(plain_config)``: the cosine of every tensor (but those
    whose path ends with one of ``null_grads``), by path."""
    import torch.nn.functional as F

    from unionml_tpu_torch.models.train import tree_leaves, value_and_grad

    paths = ["/".join(p) for p in tree_paths(params)]
    grads = []
    for cfg in (config, plain_config):
        module = module_cls(cfg)
        g = value_and_grad(lambda p, b, m=module: (loss(m(p, b[0]), b[1]), {}), params, batch)[1]
        grads.append([t.float().flatten() for t in tree_leaves(g)])
        del g
    return {p: float(F.cosine_similarity(a, b, dim=0)) for p, a, b in zip(paths, *grads)
            if not any(p.endswith("/".join(n)) for n in null_grads)}


def bert_flash_delta_fault(config, params, batch, loss, *, deep: int = 2) -> dict:
    """The flash backward with the reference's ``delta = rowsum(dO * O)``
    from the bf16 output planted (:func:`output_delta_fault`), one step of
    ``BertClassifier(config)`` against ``attn_impl="xla"``: the least
    cosine of each block's gradients; the last ``deep`` blocks' least must
    be under :data:`BERT_GRAD_COSINE_MIN`, or the check could not tell the
    repaired backward from the reference's."""
    from unionml_tpu_torch.models import BertClassifier

    with output_delta_fault():
        cos = block_cosines(BertClassifier, config, dataclasses.replace(config, attn_impl="xla"),
                            loss, params, batch, null_grads=(("attn_k", "bias"),))
    blocks = {}
    for path, c in cos.items():
        part = path.split("/")
        if len(part) > 1 and part[1].startswith("block_"):
            blocks[part[1]] = min(blocks.get(part[1], 1.0), c)
    deep_min = min(blocks[f"block_{i}"] for i in range(config.num_layers - deep,
                                                       config.num_layers))
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:4]
    log(f"bert (flash, planted: delta from the bf16 output) vs xla: least cosine per block "
        f"{blocks}; worst tensors {worst}")
    if not deep_min < BERT_GRAD_COSINE_MIN:
        raise AssertionError(
            f"the flash gradient check passed a planted fault (delta from the bf16 output): "
            f"the last {deep} blocks' least cosine {deep_min} is not under "
            f"{BERT_GRAD_COSINE_MIN}")
    return {"least_cosine_per_block": blocks, "deep_blocks_least": deep_min, "worst": worst}


def bert_mlm_batch(config, *, batch: int, seq: int, min_len: int, seed: int) -> tuple:
    """``batch`` rows of ``seq`` ids (ids 4 and up), right-padded with id
    0 to lengths drawn in ``[min_len, seq]`` (the shortest first), through
    the BERT masking rule: ``(inputs, labels, attention_mask, lengths)``,
    numpy, pads never supervised."""
    from unionml_tpu_torch.models import make_mlm_batch

    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, config.vocab_size, size=(batch, seq))
    lengths = np.sort(rng.integers(min_len, seq + 1, size=batch))
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int64)
    tokens = np.where(mask == 1, tokens, 0)
    inputs, labels = make_mlm_batch(tokens, mask_id=BERT_MASK_ID, vocab_size=config.vocab_size,
                                    rng=rng, special_ids=(0,))
    return inputs, labels, mask, lengths


def bert_mlm_phase(config, *, device: str = "cuda", batch: int = BERT_MLM_BATCH,
                   seq: int = None, min_len: int = BERT_MLM_MIN_LEN, steps: int = 10) -> dict:
    """Masked-LM training of ``BertMlm(config)`` (``seq`` = ``max_len``
    by default): ``steps`` ``mlm_step``s over one repeated padded batch
    (:func:`bert_mlm_batch`), the full-score reference with the padding
    bias whatever ``attn_impl`` says (rows 12-13 must not launch); the
    loss must fall. Then the shortest row's logits at its real positions
    against the same row run alone without padding (``BERT_PAD_TOL``),
    and one unmasked ``mlm_step`` at ``batch x seq`` (every row at full
    length), where ``attn_impl="fused"`` runs rows 12-13 once a layer
    each (the two-pass forward above 256 tokens)."""
    from unionml_tpu_torch.models import BertMlm, create_train_state, mlm_step

    on_card = device == "cuda"
    seq = seq or config.max_len
    module = BertMlm(config)
    inputs, labels, mask, lengths = bert_mlm_batch(config, batch=batch, seq=seq,
                                                   min_len=min_len, seed=7)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    padded = (to(inputs), to(labels), to(mask))
    state = create_train_state(module, padded[0][:1], learning_rate=BERT_LR, seed=7)
    step = mlm_step(module)
    kernels = bert_kernels()
    for k in kernels.values():
        k.launches = 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, t0 = [], time.perf_counter()
    for i in range(steps):
        state, metrics = step(state, padded)
        losses.append(metrics["loss"])
        if i == 0:
            if on_card:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
    if on_card:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    masked_launches = {name: k.launches for name, k in kernels.items()}
    losses = torch.stack(losses).float().tolist()
    step_ms = (t2 - t1) / max(steps - 1, 1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the MLM loss did not fall: {losses}")
    if any(masked_launches.values()):
        raise AssertionError(f"padded MLM steps launched rows 12-13: {masked_launches}")

    row = 0   # the shortest row
    length = int(lengths[row])
    with torch.no_grad():
        batch_logits = module(state.params, padded[0], attention_mask=padded[2])
        got = batch_logits[row, :length].float()
        del batch_logits
        alone = module(state.params, padded[0][row:row + 1, :length],
                       attention_mask=padded[2][row:row + 1, :length])[0].float()
    pad_err = float((got - alone).abs().max())
    outside = float((~torch.isclose(got, alone, **BERT_PAD_TOL)).float().mean())
    pad_cos = float(torch.nn.functional.cosine_similarity(got.flatten(), alone.flatten(), dim=0))
    del got, alone
    if outside:
        raise AssertionError(f"a padded row's logits differ from the row run alone beyond "
                             f"{BERT_PAD_TOL}: max |diff| {pad_err}, share outside {outside}")

    # every row at full length, no mask: the unmasked path of attn_impl
    full_inputs, full_labels = to(np.where(inputs == 0, BERT_MASK_ID, inputs)), to(labels)
    for k in kernels.values():
        k.launches = 0
    if on_card:
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    state, metrics = step(state, (full_inputs, full_labels, None))
    if on_card:
        torch.cuda.synchronize()
    unmasked_ms = (time.perf_counter() - t3) * 1e3
    unmasked_launches = {name: float(k.launches) for name, k in kernels.items()}
    want = bert_launches_per_step(config, seq)
    if on_card and unmasked_launches != want:
        raise AssertionError(f"unmasked MLM step launched {unmasked_launches}, expected {want}")
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"the unmasked MLM step's loss is {float(metrics['loss'])}")
    out = {"batch": batch, "seq": seq, "lengths": lengths.tolist(), "steps": steps,
           "step_ms": step_ms, "tokens_per_s": float(mask.sum()) / step_ms * 1e3,
           "supervised_per_step": int((labels != -100).sum()), "losses": losses,
           "first_loss": losses[0], "last_loss": losses[-1], "peak_mem_gib": peak,
           "masked_launches": masked_launches, "pad_row_length": length,
           "pad_max_abs_err": pad_err, "pad_logit_cosine": pad_cos,
           "unmasked_step_ms": unmasked_ms, "unmasked_loss": float(metrics["loss"]),
           "launches_per_unmasked_step": unmasked_launches}
    log(f"bert mlm: {steps} steps of {batch} x {seq} padded ids (lengths {lengths.tolist()}): "
        f"step_ms {step_ms} (first step excluded) real tokens/s {out['tokens_per_s']} peak "
        f"memory {peak} GiB; loss first {losses[0]} last {losses[-1]}; launches of rows 12-13 "
        f"{masked_launches}")
    log(f"bert mlm: padded row {row} (length {length}) vs alone: max |diff| {pad_err}, cosine "
        f"{pad_cos}; unmasked step ({config.attn_impl}) {unmasked_ms} ms, loss "
        f"{out['unmasked_loss']}, launches {unmasked_launches}")
    return out


# --------------------------------------------------------------------- #
# 3g: the basic_tpu template on the card
# --------------------------------------------------------------------- #

BASIC_TPU_ACCURACY_MIN = 0.7   # the template's own test (tests/test_app.py)
# the template's first steps on the card against the same steps on CPU
# tensors from one initial state: fp32 throughout (TF32 off), so the
# tolerance of the CPU parity test (tests/test_torch_templates.py)
BASIC_TPU_PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
BASIC_TPU_HYPERPARAMETERS = {"hidden": 128, "learning_rate": 1e-3}


def digit_like(n: int = 1797, seed: int = 0) -> dict:
    """Digit-shaped data without scikit-learn: ``n`` 8 x 8 images of 10
    classes (the digits' 1797 rows, 64 features in [0, 1], int32 labels),
    each a class prototype of integer intensities 0-16 plus Gaussian noise,
    clipped and rounded as the digits are, from a numpy seed."""
    rng = np.random.default_rng(seed)
    prototypes = rng.integers(0, 17, size=(10, 64))
    targets = rng.integers(0, 10, size=n).astype(np.int32)
    images = np.clip(np.rint(prototypes[targets] + rng.normal(0, 5, size=(n, 64))), 0, 16)
    return {"features": (images / 16.0).astype(np.float32), "targets": targets}


def basic_tpu_steps_against_cpu(app, data: dict, *, device: str, steps: int,
                                batch: int) -> float:
    """The template's ``init`` and ``train_step`` for ``steps`` batches of
    ``data`` on ``device`` and on the CPU from the CPU's initial state:
    every param within :data:`BASIC_TPU_PARAM_TOL`. Returns the largest
    |card - cpu| over the params."""
    from unionml_tpu_torch.models.train import tree_leaves

    cpu = app.init({**BASIC_TPU_HYPERPARAMETERS, "device": "cpu"})
    card = app.init({**BASIC_TPU_HYPERPARAMETERS, "device": device})
    card = card.load_state_dict(cpu.state_dict())
    x, y = torch.from_numpy(data["features"]), torch.from_numpy(data["targets"])
    for i in range(steps):
        rows = slice(i * batch, (i + 1) * batch)
        cpu, _ = app.train_step(cpu, (x[rows], y[rows]))
        card, _ = app.train_step(card, (x[rows].to(device), y[rows].to(device)))
    pairs = [(a.cpu(), b) for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params))]
    worst = max(float((a - b).abs().max()) for a, b in pairs)
    if not all(torch.allclose(a, b, **BASIC_TPU_PARAM_TOL) for a, b in pairs):
        raise AssertionError(f"basic_tpu: {steps} steps on {device} leave params off the "
                             f"CPU's beyond {BASIC_TPU_PARAM_TOL} (max |diff| {worst})")
    return worst


def basic_tpu_phase(*, device: str = "cuda", epochs: int = 5, batch: int = 64,
                    steps_vs_cpu: int = 5) -> dict:
    """The ported basic_tpu template (an MLP through ``@model.train_step``)
    trained by ``model.train`` on ``device``, with its reader swapped for
    :func:`digit_like` (the template's reader loads scikit-learn's digits,
    an optional dependency of the port): its first ``steps_vs_cpu`` steps
    against the same steps on the CPU
    (:func:`basic_tpu_steps_against_cpu`), then params on ``device``, test
    accuracy above ``BASIC_TPU_ACCURACY_MIN``, two predictions from
    ``model.predict``."""
    import importlib

    app = importlib.import_module("unionml_tpu_torch.templates.basic_tpu.app")
    app.dataset.reader(digit_like)
    vs_cpu = basic_tpu_steps_against_cpu(app, digit_like(), device=device, steps=steps_vs_cpu,
                                         batch=batch)
    t0 = time.perf_counter()
    state, metrics = app.model.train(
        hyperparameters={**BASIC_TPU_HYPERPARAMETERS, "device": device},
        trainer_kwargs={"num_epochs": epochs, "batch_size": batch},
    )
    wall_s = time.perf_counter() - t0
    devices = {str(p.device.type) for p in (state.params["Dense_0"]["kernel"],
                                            state.params["Dense_1"]["bias"])}
    preds = np.asarray(app.model.predict(features=np.zeros((2, 64), np.float32)))
    out = {"steps": state.step, "metrics": metrics, "params_on": sorted(devices),
           "predict_shape": list(preds.shape), "wall_s": wall_s,
           "steps_vs_cpu": steps_vs_cpu, "max_param_diff_vs_cpu": vs_cpu}
    log(f"basic_tpu: {steps_vs_cpu} steps on {device} vs the CPU from one state: max param "
        f"|diff| {vs_cpu} (tolerance {BASIC_TPU_PARAM_TOL}); {state.step} steps of {batch} in "
        f"{wall_s} s on {sorted(devices)}; metrics {metrics}; predict shape {preds.shape}")
    if devices != {torch.device(device).type}:
        raise AssertionError(f"basic_tpu params live on {devices}, expected {device}")
    if not metrics["test"] > BASIC_TPU_ACCURACY_MIN:
        raise AssertionError(f"basic_tpu test accuracy {metrics['test']} <= "
                             f"{BASIC_TPU_ACCURACY_MIN}")
    if preds.shape != (2,):
        raise AssertionError(f"basic_tpu predicted shape {preds.shape}, expected (2,)")
    return out


# --------------------------------------------------------------------- #
# 3h: the sharded training step (parallelism on torch.distributed)
# --------------------------------------------------------------------- #

SHARDED_PHASE_MAX_S = 60.0   # the phase's own time limit


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_leaves(tree) -> list:
    """A state's or tree's tensor leaves, each rank's block of a DTensor
    (the whole tensor on one rank)."""
    from unionml_tpu_torch.checkpoint.pytree_io import state_tree
    from unionml_tpu_torch.models.train import tree_leaves
    from unionml_tpu_torch.parallel.compat import is_dtensor

    return [(x.to_local() if is_dtensor(x) else x) for x in tree_leaves(state_tree(tree))
            if isinstance(x, torch.Tensor)]


def leaves_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(a, b))


def build_vit_app(config, *, name: str, on_step, train_step_options: dict,
                  accumulate_steps: int):
    """A Dataset/Model spec for ViT ``config`` (the vision template's reader
    and seeded split) whose ``@model.train_step(**train_step_options)`` runs
    ``classification_step(module, accumulate_steps=...)``, calling
    ``on_step(state, metrics)`` after every step."""
    from unionml_tpu_torch import Dataset, Model
    from unionml_tpu_torch._device import resolve_device
    from unionml_tpu_torch.models import ViT, classification_step, create_train_state

    module = ViT(config)
    size = config.image_size
    dataset = Dataset(name=f"{name}_dataset", test_size=0.2)

    @dataset.reader
    def reader(n: int = 512, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        images = rng.normal(size=(n, size, size, 3)).astype(np.float32)
        return {"features": images,
                "targets": (images.mean(axis=(1, 2, 3)) > 0).astype(np.int64)}

    @dataset.splitter
    def splitter(data: dict, test_size: float, shuffle: bool, random_state: int):
        idx = np.arange(len(data["features"]))
        if shuffle:
            np.random.default_rng(random_state).shuffle(idx)
        cut = int(len(idx) * (1 - test_size))
        return ({k: v[idx[:cut]] for k, v in data.items()},
                {k: v[idx[cut:]] for k, v in data.items()})

    @dataset.parser
    def parser(data: dict, features, targets):
        return (data["features"], data["targets"])

    def init(learning_rate: float = 3e-4, device=None):
        example = torch.zeros(1, size, size, 3, device=resolve_device(device))
        return create_train_state(module, example, learning_rate=learning_rate)

    model = Model(name=name, init=init, dataset=dataset)
    step = classification_step(module, accumulate_steps=accumulate_steps)

    @model.train_step(accumulate_steps=accumulate_steps, **train_step_options)
    def train_step(state, batch):
        state, metrics = step(state, batch)
        on_step(state, metrics)
        return state, metrics

    @model.evaluator
    def evaluator(state, features: np.ndarray, targets: np.ndarray) -> float:
        params = state.params
        device = params["cls"].device
        with torch.no_grad():
            logits = module(params, torch.as_tensor(features[:64], device=device))
        return float((logits.argmax(-1).cpu().numpy() == targets[:64]).mean())

    return model


def sharded_vit(config, *, device: str, batch: int, steps: int, warmup: int,
                accumulate_steps: int = 2) -> dict:
    """(a): the ViT app's model.train with ``accumulate_steps=2`` twice from
    one seed and one batch stream: plain, then under
    ``train_step(sharding=ShardingConfig(data=-1, rules=VIT_PARTITION_RULES),
    overlap_grads=True)``. The params after every step must be the plain
    run's bits; the ViT kernels must launch on the sharded run, twice
    VIT_LAUNCHES_PER_STEP a step on the card (two microbatches)."""
    from unionml_tpu_torch.models.vit import VIT_PARTITION_RULES
    from unionml_tpu_torch.parallel import ShardingConfig

    on_card = device == "cuda"
    kernels = vit_kernels()

    def run(options: dict, name: str, check=None) -> dict:
        per_step, marks, last = [], {}, {}

        def on_step(state, metrics):
            leaves = local_leaves(state.params)
            if check is None:
                per_step.append([x.clone() for x in leaves])
            else:
                per_step.append(leaves_equal(leaves, check[len(per_step)]))
            last["state"] = state
            if state.step in (warmup, steps):
                if on_card:
                    torch.cuda.synchronize()
                marks[state.step] = (time.perf_counter(),
                                     {k: kern.launches for k, kern in kernels.items()})

        model = build_vit_app(config, name=name, on_step=on_step, train_step_options=options,
                              accumulate_steps=accumulate_steps)
        for kern in kernels.values():
            kern.launches = 0
        t0 = time.perf_counter()
        trained, metrics = model.train(
            hyperparameters={"device": device, "learning_rate": 3e-4},
            trainer_kwargs={"num_epochs": 1, "batch_size": batch // accumulate_steps},
            n=batch * steps * 5 // 4, seed=0)
        wall = time.perf_counter() - t0
        if len(per_step) != steps:
            raise AssertionError(f"{name}: the trainer ran {len(per_step)} steps, not {steps}")
        (t_a, c_a), (t_b, c_b) = marks[warmup], marks[steps]
        return {"per_step": per_step, "state": last["state"], "trained": trained,
                "eval": metrics, "wall_s": wall,
                "step_ms": (t_b - t_a) / (steps - warmup) * 1e3,
                "launches": {k: kern.launches for k, kern in kernels.items()},
                "launches_per_step": {k: (c_b[k] - c_a[k]) / (steps - warmup) for k in kernels}}

    plain = run({}, "chip_smoke_vit_plain")
    sharding = ShardingConfig(data=-1, rules=VIT_PARTITION_RULES)
    sharded = run({"sharding": sharding, "overlap_grads": True}, "chip_smoke_vit_sharded",
                  check=plain["per_step"])
    final_equal = leaves_equal(local_leaves(sharded["trained"].params),
                               plain["per_step"][-1])
    out = {
        "config": f"ViT patch {config.patch_size}, width {config.hidden_dim}, "
                  f"{config.num_layers} layers, attn {config.attn_impl}, norm "
                  f"{config.norm_impl}; batch {batch} as {accumulate_steps} microbatches, "
                  f"{steps} steps ({warmup} warm-up)",
        "plain_step_ms": plain["step_ms"], "sharded_step_ms": sharded["step_ms"],
        "plain_wall_s": plain["wall_s"], "sharded_wall_s": sharded["wall_s"],
        "bit_equal_per_step": sharded["per_step"], "final_bit_equal": final_equal,
        "launches": sharded["launches"], "launches_per_step": sharded["launches_per_step"],
        "plain_launches_per_step": plain["launches_per_step"], "eval": sharded["eval"],
        "placements": sorted({str(tuple(p.placements))
                              for p in local_placed(sharded["state"].params)}),
    }
    log(f"sharded_vit: step_ms plain {out['plain_step_ms']} sharded {out['sharded_step_ms']}; "
        f"bit-equal per step {out['bit_equal_per_step']}, final {final_equal}; launches per "
        f"step {out['launches_per_step']}; placements {out['placements']}")
    if not (all(sharded["per_step"]) and final_equal):
        raise AssertionError("the sharded ViT run's params left the plain run's bits")
    want = {k: v * accumulate_steps for k, v in VIT_LAUNCHES_PER_STEP.items()}
    if on_card and (sharded["launches_per_step"] != want
                    or plain["launches_per_step"] != want):
        raise AssertionError(f"ViT launches per step plain {plain['launches_per_step']} "
                             f"sharded {sharded['launches_per_step']}, expected {want}")
    if on_card and not all(sharded["launches"].values()):
        raise AssertionError(f"a ViT kernel never launched on the sharded path: "
                             f"{sharded['launches']}")
    out["state"] = sharded["state"]
    return out


def local_placed(tree) -> list:
    from unionml_tpu_torch.models.train import tree_leaves
    from unionml_tpu_torch.parallel.compat import is_dtensor

    return [x for x in tree_leaves(tree) if is_dtensor(x)]


def sharded_lm(config, *, device: str, batch: int, seq: int, steps: int) -> dict:
    """(b): ``steps`` lm_steps of ``config`` plain, then through
    ``compile_step`` under ``ShardingConfig(data=-1, tensor=1,
    rules=LLAMA_PARTITION_RULES)``, from one seeded state on the same
    token batches: the params after every step must be the plain step's
    bits; rows 9-11 and the delta pass must launch on the sharded steps."""
    from unionml_tpu_torch.models import Llama, create_train_state, lm_step
    from unionml_tpu_torch.models.llama import LLAMA_PARTITION_RULES
    from unionml_tpu_torch.parallel import ShardingConfig, compile_step

    on_card = device == "cuda"
    module = Llama(config)
    tokens = torch.from_numpy(lm_tokens(batch * steps, seq, config.vocab_size, 1)).to(device)
    batches = [tokens[i * batch:(i + 1) * batch] for i in range(steps)]
    kernels = lm_kernels()
    example = torch.zeros(1, 8, dtype=torch.long, device=device)

    def run(sharding):
        state = create_train_state(module, example, learning_rate=1e-3)
        step = lm_step(module)
        if sharding is not None:
            step, state = compile_step(step, state, sharding=sharding)
        for kern in kernels.values():
            kern.launches = 0
        per_step, times = [], []
        for b in batches:
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            if on_card:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            per_step.append([x.clone() for x in local_leaves(state.params)])
        return per_step, times, {k: kern.launches for k, kern in kernels.items()}, \
            float(metrics["loss"])

    plain, plain_ms, _, plain_loss = run(None)
    sharded, sharded_ms, launches, loss = run(
        ShardingConfig(data=-1, tensor=1, rules=LLAMA_PARTITION_RULES))
    equal = [leaves_equal(a, b) for a, b in zip(sharded, plain)]
    out = {"config": f"Llama width {config.hidden_dim}, {config.num_layers} layers, "
                     f"{config.num_heads}/{config.num_kv_heads} heads, attn {config.attn_impl}; "
                     f"{steps} steps of {batch} x {seq} tokens",
           "plain_step_ms": plain_ms, "sharded_step_ms": sharded_ms,
           "bit_equal_per_step": equal, "launches": launches, "loss": loss,
           "plain_loss": plain_loss}
    log(f"sharded_lm: step_ms plain {plain_ms} sharded {sharded_ms}; bit-equal per step "
        f"{equal}; loss {loss} (plain {plain_loss}); launches {launches}")
    if not all(equal):
        raise AssertionError("the sharded llama_lc steps left the plain steps' bits")
    if on_card and not all(launches.values()):
        raise AssertionError(f"a flash kernel never launched on the sharded path: {launches}")
    return out


def sharded_checkpoint(state, make_target, *, device: str) -> dict:
    """(c): an async sharded CheckpointManager save of ``state`` (placed),
    then a restore into a fresh placed target (other values): bit for bit.
    The caller's stall and the background commit, in ms."""
    import shutil
    import tempfile

    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.checkpoint._metrics import checkpoint_metrics
    from unionml_tpu_torch.checkpoint.sharded import CheckpointManager

    (HERE / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="sharded-", dir=HERE / "build"))
    reg = telemetry.MetricsRegistry()
    try:
        manager = CheckpointManager(root, registry=reg)
        t0 = time.perf_counter()
        manager.save(state.step, state)
        stall_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        manager.wait()
        wait_ms = (time.perf_counter() - t1) * 1e3
        target = make_target()
        if leaves_equal(local_leaves(target), local_leaves(state)):
            raise AssertionError("the fresh target already holds the saved bits")
        restored = manager.restore(target)
        manager.close()
        equal = leaves_equal(local_leaves(restored), local_leaves(state))
        metrics = checkpoint_metrics(reg)
        out = {"stall_ms": stall_ms, "wait_ms": wait_ms,
               "commit_ms": metrics["commit_ms"].labels("sharded").samples(),
               "restore_ms": metrics["restore_ms"].labels("sharded").samples(),
               "bytes": sum(p.stat().st_size for p in root.rglob("*") if p.is_file()),
               "bit_equal": equal, "step": restored.step}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"sharded_ckpt: {out['bytes']} bytes; save stall on the loop {stall_ms} ms, commit "
        f"{out['commit_ms']} ms, restore {out['restore_ms']} ms; bit-equal {equal}")
    if not equal or out["step"] != state.step:
        raise AssertionError("the sharded checkpoint did not restore the saved bits")
    return out


def sharded_collectives(grads, mesh) -> dict:
    """(d): bucketed_psum over the mesh's data axis (the group's own
    backend: NCCL on the card) of a gradient tree equals the tree on one
    rank, and the collective counter moved."""
    from unionml_tpu_torch.models.train import tree_leaves
    from unionml_tpu_torch.parallel import bucketed_psum, shard_map
    from unionml_tpu_torch.parallel.collectives import COLLECTIVES
    from unionml_tpu_torch.parallel.sharding import PartitionSpec as P

    COLLECTIVES.reset()
    summed = shard_map(lambda t: bucketed_psum(t, "data"), mesh=mesh, in_specs=P(),
                       out_specs=P())(grads)
    equal = leaves_equal([x.to_local() for x in tree_leaves(summed)], tree_leaves(grads))
    out = {"bit_equal": equal, "collectives": dict(COLLECTIVES.counts),
           "leaves": len(tree_leaves(grads)),
           "bytes": sum(g.nbytes for g in tree_leaves(grads))}
    log(f"sharded_collectives: bucketed_psum of {out['leaves']} gradient tensors "
        f"({out['bytes']} bytes) equal to its input {equal}; collectives issued "
        f"{out['collectives']}")
    if not equal or COLLECTIVES.total == 0:
        raise AssertionError("bucketed_psum over the group changed the tree or issued nothing")
    return out


def sharded_phase(vit_cfg, llama_cfg, *, device: str = "cuda", vit_batch: int = 64,
                  vit_steps: int = 6, warmup: int = 2, lm_batch: int = 2, lm_seq: int = 4096,
                  lm_steps: int = 2) -> dict:
    """3h: a one-rank process group (NCCL on the card, over a local TCP
    store), then (a) :func:`sharded_vit`, (b) :func:`sharded_lm`, (c)
    :func:`sharded_checkpoint` of (a)'s state and (d)
    :func:`sharded_collectives` on a gradient tree of (a)'s model. The
    group is destroyed at the end. Fails past :data:`SHARDED_PHASE_MAX_S`."""
    import torch.distributed as dist

    from unionml_tpu_torch.models import ViT, create_train_state
    from unionml_tpu_torch.models.train import value_and_grad
    from unionml_tpu_torch.models.vit import VIT_PARTITION_RULES
    from unionml_tpu_torch.parallel import ShardingConfig, multihost_initialize, shard_pytree

    t0 = time.perf_counter()
    if not multihost_initialize(f"127.0.0.1:{free_port()}", 1, 0, device=device):
        raise AssertionError("the process group did not start")
    try:
        backend = dist.get_backend()
        if device == "cuda" and backend != "nccl":
            raise AssertionError(f"the card's group runs {backend}, not NCCL")
        vit = sharded_vit(vit_cfg, device=device, batch=vit_batch, steps=vit_steps,
                          warmup=warmup)
        state = vit.pop("state")
        sharding = ShardingConfig(data=-1, rules=VIT_PARTITION_RULES)
        module = ViT(vit_cfg)
        example = torch.zeros(1, vit_cfg.image_size, vit_cfg.image_size, 3, device=device)
        ckpt = sharded_checkpoint(
            state, lambda: shard_pytree(create_train_state(module, example, seed=1), sharding),
            device=device)
        images, labels = vit_batches(vit_cfg, 8, 1, device, seed=3)[0]

        def loss_fn(params, batch):
            logits = module(params, batch[0])
            return torch.nn.functional.cross_entropy(logits.float(), batch[1]), {}

        from unionml_tpu_torch.parallel.sharding import gather_state

        _, grads = value_and_grad(loss_fn, gather_state(state.params), (images, labels))
        del state
        collectives = sharded_collectives(grads, sharding.mesh())
        del grads
        lm = sharded_lm(llama_cfg, device=device, batch=lm_batch, seq=lm_seq, steps=lm_steps)
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    log(f"sharded: backend {backend}, phase {seconds:.1f} s")
    if device == "cuda" and seconds > SHARDED_PHASE_MAX_S:
        raise AssertionError(f"the sharded phase took {seconds:.1f} s, over "
                             f"{SHARDED_PHASE_MAX_S} s")
    return {"backend": backend, "vit": vit, "lm": lm, "checkpoint": ckpt,
            "collectives": collectives, "seconds": seconds}


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


def random_quantized_params(config, seed: int, device: str = "cuda",
                            float_dtype: torch.dtype = None) -> dict:
    """Random serving weights in the layout ``quantize_params`` writes for
    ``config`` (int8 everywhere, or packed int4 with the per-site int8
    fallback for ``weight_bits=4``), made straight from a seeded
    ``torch.Generator`` on ``device``, leaf by leaf: no fp weights are
    quantized. The embedding and the norm scales are in ``float_dtype``
    (default the config's compute dtype, serving residency; fp32 is the
    reference's training tree)."""
    from unionml_tpu_torch._device import torch_dtype
    from unionml_tpu_torch.models.convert import _dense_shapes, _int4_site

    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = float_dtype or torch_dtype(config.dtype)
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


# --------------------------------------------------------------------- #
# prefix phase: the prefix cache and shared-prefix serving on the paged
# engine (ServingApp(batch=False) -> DecodeEngine(paged, prefix_cache,
# system_prefix) -> splice + suffix prefill -> paged decode -> insert)
# --------------------------------------------------------------------- #

PREFIX_SYSTEM_TOKENS = 512
PREFIX_BLOCK = 16
PREFIX_POOL_BLOCKS = 320                  # the traffic below fills it
PREFIX_STORE_BYTES = 1 << 30              # the host store: ~512 blocks at 8B width


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s raw bits as an integer tensor of the same element size."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def slot_pool_rows(engine, slot: int, n: int) -> list:
    """The first ``n`` pool blocks of ``slot``, read through its block
    table: per layer, per buffer, one ``[n, block, ...]`` host tensor."""
    with engine._lock:
        ids = torch.from_numpy(engine._table[slot, :n].astype(np.int64))
        pool = engine._state["pool"]
    return [[buf[ids.to(buf.device)].cpu() for buf in layer] for layer in pool]


def host_store_rows(blocks: list) -> list:
    """Host block trees stacked the same way: per layer, per buffer
    ``[n, block, ...]``."""
    return [[torch.cat([b[li][bi] for b in blocks]) for bi in range(len(blocks[0][li]))]
            for li in range(len(blocks[0]))]


def splice_bit_mismatches(pool_rows: list, host_rows: list) -> list:
    """Blocks whose pool rows differ from the host store's in any bit of
    any buffer (scale planes included)."""
    n = pool_rows[0][0].shape[0]
    bad = torch.zeros(n, dtype=torch.bool)
    for p_layer, h_layer in zip(pool_rows, host_rows):
        for p, h in zip(p_layer, h_layer):
            if p.dtype != h.dtype or p.shape != h.shape:
                raise AssertionError(f"pool rows {p.dtype} {tuple(p.shape)} vs host store "
                                     f"{h.dtype} {tuple(h.shape)}")
            bad |= (_bits(p) != _bits(h)).reshape(n, -1).any(1)
    return torch.nonzero(bad).flatten().tolist()


def splice_faults(pool_rows: list) -> dict:
    """The pool rows a faulty splice would have left: every unit one unit
    off (unit i written at row (i + 1) * unit), or units 0 and 1 swapped."""
    def reorder(order):
        return [[buf[order] for buf in layer] for layer in pool_rows]

    n = pool_rows[0][0].shape[0]
    return {
        "one_unit_off": reorder([0] + list(range(n - 1))),
        "units_swapped": reorder([1, 0] + list(range(2, n))),
    }


def check_splice_bits(name: str, engine, slot: int, host_blocks: list) -> dict:
    """A warm admission's spliced rows in the pool, read through the
    slot's block table, equal the host store's blocks bit for bit; each
    planted splice fault must fail the same check."""
    n = len(host_blocks)
    if n < 2:
        raise AssertionError(f"{name}: {n} spliced blocks, the check needs at least 2")
    pool_rows = slot_pool_rows(engine, slot, n)
    host_rows = host_store_rows(host_blocks)
    bad = splice_bit_mismatches(pool_rows, host_rows)
    if bad:
        raise AssertionError(f"{name}: spliced blocks {bad} differ from the host store")
    caught = {}
    for fault, rows in splice_faults(pool_rows).items():
        caught[fault] = len(splice_bit_mismatches(rows, host_rows))
        if not caught[fault]:
            raise AssertionError(f"{name}: the splice-bit check passes the planted fault {fault}")
    leaves = sum(len(layer) for layer in host_blocks[0])
    log(f"{name}: {n} spliced blocks ({leaves} buffers each) equal the host store bit for "
        f"bit; planted faults caught in {caught} blocks")
    return {"blocks": n, "buffers_per_block": leaves, "faults_caught": caught}


def warm_splice_check(name: str, engine, params, prompt: list) -> dict:
    """Admit ``prompt`` (already cached) on an otherwise idle engine, and
    while it is resident hold its spliced pool rows against the host
    store's blocks (:func:`check_splice_bits`)."""
    cache = engine.prefix_cache
    row = engine._canonical_row(prompt)
    blk = cache.block_size
    used = min(cache.peek(row) // blk, (len(row) - 1) // blk)
    stream = engine.generate_stream(params, prompt)
    try:
        first = next(stream)   # the prefill (its scatter included) has landed
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        with engine._lock:
            slots = [s for s, r in enumerate(engine._occupant) if r is not None]
        if len(slots) != 1:
            raise AssertionError(f"{name}: expected one resident request, found {slots}")
        lease = cache.lease(row)
        try:
            out = check_splice_bits(name, engine, slots[0], lease.rows[:used])
        finally:
            lease.release()
        tokens = list(first) + [t for chunk in stream for t in chunk]
    finally:
        stream.close()
    out["tokens"] = len(tokens)
    return out


def expected_saved_tokens(rows: list, matched_blocks: list, blk: int) -> int:
    """Prompt tokens a cached admission skips: the matched blocks, capped
    one token short of the prompt, in whole units (the engine's
    ``_start_admission``; the unit is one block without prefill_chunk)."""
    return sum(min(m, (n - 1) // blk) * blk for n, m in zip(rows, matched_blocks))


def warm_cold_logit_cosine(engine, params, prompt: list) -> float:
    """First-token logits of ``prompt``'s cold admission (one monolithic
    prefill: the padded flash kernel) and of its warm twin (the cached
    blocks spliced through the engine's own programs, the suffix in
    block-sized chunks through the cached path), min cosine."""
    dev = engine.device
    row = engine._canonical_row(prompt)
    n = len(row)
    bucket = engine._bucket_for(n)
    blk = engine.prefix_cache.block_size
    lease = engine.prefix_cache.lease(row)
    try:
        used = min(lease.n_blocks, (n - 1) // blk)
        if used < 1:
            raise AssertionError("the warm twin has no cached block to splice")
        padded = np.zeros(bucket, np.int64)
        padded[:n] = row
        toks = torch.from_numpy(padded).to(dev)[None]
        kv_mask = (torch.arange(bucket, device=dev) < n)[None]
        outs = []
        with torch.inference_mode():
            fresh = engine._init_fresh(bucket=bucket)
            logits, _ = engine.module(
                params, toks, positions=torch.arange(bucket, device=dev)[None], cache=fresh,
                cache_index=0, kv_mask=kv_mask,
                logit_index=torch.full((1,), n - 1, device=dev), full_prefill=True,
            )
            outs.append(logits[:, 0].float())
            fresh = engine._init_fresh(bucket=bucket)
            for u in range(used):
                fresh = engine._splice_block(
                    fresh, engine._device_splice_rows((lease.rows[u],)), u * blk)
            n_chunks = -(-n // blk)
            for c in range(used, n_chunks - 1):
                fresh = engine._prefill_step(params, fresh, toks[:, c * blk:(c + 1) * blk], c * blk)
            start = (n_chunks - 1) * blk
            logits, _ = engine.module(
                params, toks[:, start:start + blk],
                positions=start + torch.arange(blk, device=dev)[None], cache=fresh,
                cache_index=start, kv_mask=kv_mask,
                logit_index=torch.full((1,), n - 1 - start, device=dev),
            )
            outs.append(logits[:, 0].float())
    finally:
        lease.release()
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("warm / cold first-token logits are not finite")
    return float(torch.nn.functional.cosine_similarity(outs[0], outs[1], dim=-1).min())


def conversation_turns(rng, vocab: int, conversations: int, turns: int, lengths: tuple) -> list:
    """Each conversation's user turns (token lists, ``lengths`` inclusive)."""
    return [[rng.integers(1, vocab, size=int(rng.integers(lengths[0], lengths[1] + 1))).tolist()
             for _ in range(turns)] for _ in range(conversations)]


def prefix_phase(
    config, max_new_tokens: int, *, device: str = "cuda", model=None, params=None,
    slots: int = 16, buckets: tuple = ENGINE_BUCKETS, chunk_steps: int = 8,
    system_tokens: int = PREFIX_SYSTEM_TOKENS, pool_blocks: int = PREFIX_POOL_BLOCKS,
    store_bytes: int = PREFIX_STORE_BYTES, conversations: int = 8, turns: int = 3,
    turn_lengths: tuple = (20, 250), one_shots: int = 8, one_shot_lengths: tuple = (5, 500),
    pairs: int = 4, mix_prefill_tokens: int = 512,
) -> dict:
    """Serve ``config`` through DecodeEngine(paged, system_prefix, prefix
    cache) behind ServingApp(batch=False): a cold seed request, then chat
    conversations (each turn is the previous prompt + its reply + a new
    user turn, sent when the reply arrives) beside a concurrent wave of
    one-shot prompts, all under one system prefix, into a pool they fill.
    A cached admission's suffix runs in block-sized chunks, so the engine
    gets a stall-free mixing budget of ``mix_prefill_tokens`` (its splices
    and suffix chunks dispatch together, not one per dispatcher pass).
    ``device="cpu"`` rehearses the phase at a small config, with the
    kernels' plain versions."""
    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.models import Llama
    from unionml_tpu_torch.ops import flash_attention as fa
    from unionml_tpu_torch.ops import fused_norm
    from unionml_tpu_torch.ops import paged_attention as pa
    from unionml_tpu_torch.serving import DecodeEngine, ServingApp
    from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache
    from unionml_tpu_torch.serving.scheduler import SchedulerConfig

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    config = serving_config(config)
    if model is None:
        model, params = build_template(config, max_new_tokens, buckets, device)
    counters = {"paged_attention": pa.KERNEL, "flash_fwd_padded": fa.KERNEL,
                "rms_norm_fwd": fused_norm.KERNEL}
    rng = np.random.default_rng(13)
    system = rng.integers(1, config.vocab_size, size=system_tokens).tolist()
    block_bytes = (config.num_layers * 2 * PREFIX_BLOCK * config.num_kv_heads
                   * config.head_dim * 2)
    flight = telemetry.FlightRecorder()
    cache = RadixPrefixCache(block_size=PREFIX_BLOCK, max_bytes=store_bytes)
    engine = DecodeEngine(
        Llama(config), paged=True, slots=slots, prompt_buckets=buckets,
        max_new_tokens=max_new_tokens, chunk_steps=chunk_steps, system_prefix=system,
        prefix_cache=cache, kv_pool_bytes=pool_blocks * block_bytes, flight=flight,
        scheduler=SchedulerConfig(mix_prefill_tokens=mix_prefill_tokens), device=device,
    )

    @model.predictor
    def predictor(params: dict, prompts: list) -> list:
        return engine.generate(params, prompts)

    app = None
    try:
        t0 = time.perf_counter()
        engine.warmup(params)
        sync()
        log(f"prefix: warmup ({len(engine.buckets)} buckets {engine.buckets}, cold + hit + "
            f"partial hit each) {time.perf_counter() - t0:.2f} s, cache_len {engine.cache_len}, "
            f"pool {engine.kv_pool.capacity} blocks of {engine.kv_pool.block_size}")
        engine.reset_stats()
        app = ServingApp(model, batch=False, health=engine.health, stats=engine.stats,
                         flight=flight)
        host, port = app.serve(host="127.0.0.1", port=0, blocking=False)
        base = f"http://{host}:{port}"
        user_max = engine.buckets[-1] - system_tokens
        seed = rng.integers(1, config.vocab_size, size=40).tolist()
        convs = conversation_turns(rng, config.vocab_size, conversations, turns, turn_lengths)
        shots = [rng.integers(1, config.vocab_size, size=int(n)).tolist()
                 for n in rng.integers(one_shot_lengths[0], one_shot_lengths[1] + 1,
                                       size=one_shots)]
        sent, errors = [], []   # (user prompt, matched blocks the traffic implies)
        lock = threading.Lock()

        def ask(prompt, matched):
            status, body = post(f"{base}/predict", {"features": [prompt]})
            if status != 200 or len(body) != 1 or len(body[0]) != max_new_tokens or not all(
                    isinstance(t, int) and 0 <= t < config.vocab_size for t in body[0]):
                raise AssertionError(f"bad /predict reply for a {len(prompt)}-token prompt: "
                                     f"{status} {body}")
            with lock:
                sent.append((prompt, matched))
            return body[0]

        def conversation(turns_):
            try:
                history, matched = [], system_tokens // PREFIX_BLOCK
                for turn in turns_:
                    prompt = history + turn
                    if len(prompt) > user_max:
                        raise AssertionError(f"a {len(prompt)}-token turn exceeds {user_max}")
                    reply = ask(prompt, matched)
                    # the next turn matches every full block of this prompt
                    # (its insert lands before its reply)
                    matched = (system_tokens + len(prompt)) // PREFIX_BLOCK
                    history = prompt + reply
            except Exception as exc:
                errors.append(f"conversation: {exc!r}")

        def one_shot(prompt):
            try:
                ask(prompt, system_tokens // PREFIX_BLOCK)
            except Exception as exc:
                errors.append(f"one-shot ({len(prompt)} tokens): {exc!r}")

        for counter in counters.values():
            counter.launches = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        warm_events = len(flight.dump())
        sync_warnings = warnings.catch_warnings(record=True)
        caught = sync_warnings.__enter__()
        warnings.simplefilter("always")
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t_start = time.perf_counter()
            ask(seed, 0)    # cold: the store is empty, it prefills the system prefix
            threads = [threading.Thread(target=conversation, args=(c,)) for c in convs]
            threads += [threading.Thread(target=one_shot, args=(p,)) for p in shots]
            for th in threads:
                th.start()
            give_up = time.monotonic() + 400
            for th in threads:
                th.join(timeout=max(0.0, give_up - time.monotonic()))
            if any(th.is_alive() for th in threads):
                raise AssertionError("the prefix phase's requests did not finish in 400 s")
            sync()
            wall_s = time.perf_counter() - t_start
            launches = {name: c.launches for name, c in counters.items()}
            with urllib.request.urlopen(f"{base}/health", timeout=60) as resp:
                health_status, health = resp.status, json.loads(resp.read())
            deadline = time.monotonic() + 60
            while (engine.stats()["kv_pool"]["blocks_in_use"] or cache.refcounts()) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            with urllib.request.urlopen(f"{base}/metrics", timeout=60) as resp:
                in_use = _pool_blocks_in_use(resp.read().decode())
            with urllib.request.urlopen(f"{base}/debug/flight?kind=pool_pressure",
                                        timeout=60) as resp:
                pressure = json.loads(resp.read())["events"]
            stats = engine.stats()
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
            sync_warnings.__exit__(None, None, None)
        host_syncs = [str(w.message) for w in caught
                      if "synchronizing CUDA operation" in str(w.message)]
        if errors:
            raise AssertionError("; ".join(errors))
        pc = stats["prefix_cache"]
        rows = [system_tokens + len(p) for p, _ in sent]
        expected = expected_saved_tokens(rows, [m for _, m in sent], PREFIX_BLOCK)
        log(f"prefix: {len(sent)} requests (1 cold seed, {conversations} conversations x "
            f"{turns} turns, {one_shots} one-shots) in {wall_s} s; prefill tokens saved "
            f"{pc['prefill_tokens_saved']} (the traffic implies {expected}); hits {pc['hits']} "
            f"partial {pc['partial_hits']} misses {pc['misses']}, store {pc['entries']} blocks "
            f"{pc['bytes']} bytes, evictions {pc['evictions']}, rejected "
            f"{pc['insert_rejected_blocks']}")
        log(f"prefix: kv pool {stats['kv_pool']}; scheduler {stats['scheduler']}")
        if pc["evictions"] or pc["insert_rejected_blocks"]:
            raise AssertionError(f"the host store evicted or rejected blocks: {pc}")
        if pc["prefill_tokens_saved"] != expected:
            raise AssertionError(f"prefill tokens saved {pc['prefill_tokens_saved']}, the "
                                 f"traffic implies {expected}")
        if health_status != 200 or health.get("status") != "ok":
            raise AssertionError(f"/health not ok: {health_status} {health}")
        if host_syncs:
            raise AssertionError(f"{len(host_syncs)} operations waited for the card while the "
                                 "prefix engine served")
        if not in_use or any(in_use):
            raise AssertionError(f"kv pool blocks in use after the drain: {in_use}")
        leases = cache.refcounts()
        pinned = cache.pinned_blocks()
        if leases:
            raise AssertionError(f"{leases} prefix-cache leases still held after the drain")
        if pinned != system_tokens // PREFIX_BLOCK:
            raise AssertionError(f"{pinned} pinned blocks, the system prefix has "
                                 f"{system_tokens // PREFIX_BLOCK}")
        pressure = [e for e in pressure if e.get("engine") == engine.instance]
        if not pressure:
            raise AssertionError("no pool_pressure flight record: the pool never filled")
        if on_card:
            for name, n in launches.items():
                if n == 0:
                    raise AssertionError(f"kernel {name} was never launched on the prefix path")
        events = flight.dump()[warm_events:]     # the traffic's, not the warmup's
        cached = {e["rid"]: e.get("cached_tokens", 0) for e in events if e["kind"] == "prefill"}
        ttft = {"cold": [], "warm": []}
        for e in events:
            if e["kind"] == "finish" and e["rid"] in cached:
                ttft["warm" if cached[e["rid"]] else "cold"].append(e["ttft_ms"])

        # splice bits, logits, then cold / warm pairs on the idle engine
        splice = warm_splice_check("prefix splice bits", engine, params, convs[0][0])
        cos = warm_cold_logit_cosine(engine, params, convs[1][0] + convs[1][1])
        log(f"prefix: warm vs cold first-token logits, min cosine {cos}")
        if cos < LOGIT_COSINE_MIN:
            raise AssertionError(f"warm admission's logits disagree with its cold twin ({cos})")
        engine.reset_stats()
        pair_ttft = {"cold": [], "warm": []}
        pair_rows = []
        for p in shots[:pairs]:
            cache.clear()
            row = engine._canonical_row(p)
            for kind in ("cold", "warm"):
                t0 = time.perf_counter()
                for _ in engine.generate_stream(params, p, max_new_tokens=1):
                    pass
                pair_ttft[kind].append((time.perf_counter() - t0) * 1e3)
                # a 1-token request finishes at its prefill harvest, before
                # its insert: the warm twin waits for the stored blocks
                deadline = time.monotonic() + 60
                while cache.peek(row) < len(row) // PREFIX_BLOCK * PREFIX_BLOCK \
                        and time.monotonic() < deadline:
                    time.sleep(0.005)
            pair_rows.append(len(row))
        pair_saved = engine.stats()["prefix_cache"]["prefill_tokens_saved"]
        pair_expected = expected_saved_tokens(pair_rows, [n // PREFIX_BLOCK for n in pair_rows],
                                              PREFIX_BLOCK)
        if pair_saved != pair_expected:
            raise AssertionError(f"cold / warm pairs saved {pair_saved} tokens, expected "
                                 f"{pair_expected}")
        timing = {}
        if on_card:
            # device time of one unit's splice (upload + copy, and from the
            # device memo) and of one block's extract to the host
            lease = cache.lease(engine._canonical_row(shots[0]))
            try:
                unit = (lease.rows[0],)
                fresh = engine._init_fresh(bucket=engine.buckets[0])

                def splice_cold():
                    engine._dev_splice.clear()
                    engine._splice_block(fresh, engine._device_splice_rows(unit), 0)

                timing["splice_ms_per_unit"] = time_ms(splice_cold)
                timing["splice_ms_per_unit_memo"] = time_ms(
                    lambda: engine._splice_block(fresh, engine._device_splice_rows(unit), 0))
                st = engine._state
                ids = np.arange(1, 9, dtype=np.int32)
                # few calls: each one allocates pinned buffers the host
                # cannot reuse until the card has copied into them
                timing["extract_ms_per_block"] = time_ms(
                    lambda: engine._extract_blocks(st, 0, ids, 0, len(ids)),
                    iters=3) / len(ids)
            finally:
                lease.release()
                engine._dev_splice.clear()
    finally:
        if app is not None:
            app.shutdown()
        engine.close()

    def pct(xs, q):
        return float(np.percentile(xs, q)) if xs else None

    out = {
        "layers": config.num_layers,
        "requests": len(sent),
        "wall_s": wall_s,
        "system_prefix_tokens": system_tokens,
        "pool_blocks": engine.kv_pool.capacity,
        "pool_pressure_events": len(pressure),
        "prefill_tokens_saved": pc["prefill_tokens_saved"],
        "expected_tokens_saved": expected,
        "hits": pc["hits"], "partial_hits": pc["partial_hits"], "misses": pc["misses"],
        "host_store_bytes": pc["bytes"], "host_store_blocks": pc["entries"],
        "insert_host_ms": pc.get("insert_ms"),
        "lookup_host_ms": pc.get("lookup_ms"),
        "ttft_ms_traffic": {k: {"n": len(v), "p50": pct(v, 50), "p99": pct(v, 99)}
                            for k, v in ttft.items()},
        "ttft_ms_idle_pairs": {k: {"n": len(v), "p50": pct(v, 50), "p99": pct(v, 99)}
                               for k, v in pair_ttft.items()},
        "warm_cold_logit_cosine": cos,
        "splice_bits": splice,
        "leases_after": leases, "pinned_blocks": pinned,
        "host_syncs": len(host_syncs),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
        "launches": launches,
        **timing,
    }
    log(f"prefix: ttft ms (traffic) {out['ttft_ms_traffic']}; idle cold / warm pairs "
        f"{out['ttft_ms_idle_pairs']}; insert host ms {out['insert_host_ms']}; device "
        f"{timing}; pool_pressure events {len(pressure)}; launches {launches}; leases "
        f"{leases}, pinned {pinned}; host waits {len(host_syncs)}")
    return out


def prefix_kv_quant_check(config, params, *, device: str = "cuda", layers: int = 4,
                          buckets: tuple = (64, 256)) -> dict:
    """A short kv_quant run: a paged prefix-cache engine over the int8
    cache serves a prompt cold, then warm; the warm admission's spliced
    rows — int8 k / v and their fp32 scale planes — equal the host
    store's bit for bit."""
    from unionml_tpu_torch.models import Llama
    from unionml_tpu_torch.serving import DecodeEngine
    from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

    config = dataclasses.replace(serving_config(config), num_layers=layers, kv_quant=True)
    engine = DecodeEngine(Llama(config), paged=True, slots=4, prompt_buckets=buckets,
                          max_new_tokens=8, chunk_steps=8, device=device,
                          prefix_cache=RadixPrefixCache(block_size=PREFIX_BLOCK))
    rng = np.random.default_rng(17)
    prompt = rng.integers(1, config.vocab_size, size=150).tolist()
    try:
        p = layer_subset(params, layers)
        engine.generate(p, [prompt])
        deadline = time.monotonic() + 60
        while engine.prefix_cache.refcounts() and time.monotonic() < deadline:
            time.sleep(0.01)
        out = warm_splice_check("int8 kv splice bits", engine, p, prompt)
    finally:
        engine.close()
    if out["buffers_per_block"] != 4 * layers:
        raise AssertionError(f"int8 KV blocks carry {out['buffers_per_block']} buffers, "
                             f"expected k, v and both scale planes of {layers} layers")
    return out


def prefix_fp32_parity_phase(config, max_new_tokens: int, *, device: str = "cuda",
                             layers: int = 8, buckets: tuple = ENGINE_BUCKETS,
                             shared: tuple = (300, 120, 600), per_group: int = 4,
                             suffix: tuple = (5, 200), preempt_prompt: int = 40,
                             preempt_new_tokens: int = 64) -> dict:
    """fp32 activations at ``layers`` layers: a paged prefix-cache engine
    and a plain paged engine give the same tokens on prompts that share
    prefixes (sent in turn, so later ones splice; at most one flip), and a
    low-priority stream preempted at a full pool by a high-priority
    request resumes and gives the tokens of its unpreempted run."""
    from unionml_tpu_torch.models import Llama
    from unionml_tpu_torch.serving import DecodeEngine
    from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

    config = fp32_config(config, layers)
    _, params = build_template(config, max_new_tokens, buckets, device)
    rng = np.random.default_rng(19)
    prompts = []
    for n in shared:
        head = rng.integers(1, config.vocab_size, size=n).tolist()
        prompts += [head + rng.integers(1, config.vocab_size, size=int(k)).tolist()
                    for k in rng.integers(suffix[0], suffix[1], size=per_group)]
    kw = dict(slots=4, prompt_buckets=buckets, max_new_tokens=max_new_tokens, chunk_steps=8,
              device=device)
    outs = {}
    for cached in (True, False):
        engine = DecodeEngine(Llama(config), paged=True, **kw,
                              prefix_cache=RadixPrefixCache(block_size=PREFIX_BLOCK)
                              if cached else None)
        try:
            outs[cached] = [engine.generate(params, [p])[0] for p in prompts]
            saved = engine.stats()["prefix_cache"]["prefill_tokens_saved"] if cached else 0
        finally:
            engine.close()
        if cached:
            cached_saved = saved
    matching = sum(a == b for a, b in zip(outs[True], outs[False]))
    log(f"prefix fp32: {matching}/{len(prompts)} requests token-identical, prefix-cache engine "
        f"({cached_saved} prefill tokens saved) vs plain engine, {layers} layers")
    if matching < len(prompts) - 1:
        raise AssertionError(f"fp32 prefix-cache engine disagrees with the plain engine: "
                             f"{matching}/{len(prompts)}")
    if cached_saved == 0:
        raise AssertionError("the fp32 prefix-cache engine spliced nothing")

    # preemption: a pool that holds ONE resident; short chunks and a
    # shallow pipeline keep the low stream resident while the high
    # request arrives
    low_prompt = rng.integers(1, config.vocab_size, size=preempt_prompt).tolist()
    high_prompt = rng.integers(1, config.vocab_size, size=preempt_prompt).tolist()
    pkw = dict(slots=2, prompt_buckets=buckets, max_new_tokens=preempt_new_tokens,
               chunk_steps=2, pipeline_depth=2, device=device)
    solo = DecodeEngine(Llama(config), paged=True, **pkw)
    try:
        want_low = solo.generate(params, [low_prompt])[0]
        want_high = solo.generate(params, [high_prompt], max_new_tokens=8)[0]
    finally:
        solo.close()
    engine = DecodeEngine(
        Llama(config), paged=True, **pkw, kv_block_size=PREFIX_BLOCK,
        # room for the low stream's worst case and one block more: the high
        # request cannot admit beside it
        kv_pool_blocks=2 + -(-(preempt_prompt + preempt_new_tokens) // PREFIX_BLOCK),
        prefix_cache=RadixPrefixCache(block_size=PREFIX_BLOCK),
    )
    low_out, low_err = [], []
    try:
        def low_client():
            try:
                for chunk in engine.generate_stream(params, low_prompt, priority="low"):
                    low_out.extend(chunk)
            except Exception as exc:
                low_err.append(exc)

        t = threading.Thread(target=low_client)
        t.start()
        deadline = time.monotonic() + 120
        while not low_out and time.monotonic() < deadline:
            time.sleep(0.002)
        high_out = engine.generate(params, [high_prompt], max_new_tokens=8, priority="high")[0]
        t.join(timeout=300)
        if t.is_alive() or low_err:
            raise AssertionError(f"the preempted stream failed: {low_err}")
        preemptions = engine.stats()["scheduler"]["preemptions"]
    finally:
        engine.close()
    log(f"prefix fp32: preemptions {preemptions}; resumed stream "
        f"{'equals' if low_out == want_low else 'DIFFERS from'} its unpreempted run, the "
        f"high-priority request {'equals' if high_out == want_high else 'DIFFERS from'} its own")
    if preemptions < 1:
        raise AssertionError("the high-priority request did not preempt the low-priority stream")
    if low_out != want_low or high_out != want_high:
        raise AssertionError("a preempted / preempting request's tokens differ from its "
                             "unpreempted run")
    return {"layers": layers, "match": f"{matching}/{len(prompts)}",
            "tokens_saved": cached_saved, "preemptions": preemptions}


# --------------------------------------------------------------------- #
# fleet phase: the fleet tier over two paged Llama-3-8B engines on one
# card (FleetRouter with a SloWatchdog per replica, failover, the
# FleetAutoscaler's warm join and scale-in, DisaggRouter, make_router_app
# over an HttpReplica with OTLP export, choose_serving_mode)
# --------------------------------------------------------------------- #

FLEET_PREFIX_TOKENS = 256          # each traffic family's shared prefix
FLEET_FAMILIES = 4
FLEET_FOLLOW_UPS = 1               # requests per family after its first
FLEET_SUFFIX_LENGTHS = (16, 200)
FLEET_NEW_TOKENS = 16               # the routing and HTTP requests
FLEET_SHORT_NEW_TOKENS = 16        # the failover, disaggregation and burst requests
FLEET_SLOTS = 8
FLEET_POOL_BLOCKS = 256            # per engine: 512 MiB at 8B width
FLEET_STORE_BYTES = 1 << 30        # per engine's host block store
FLEET_TTFT_OBJECTIVE_MS = 5000.0   # each replica's TTFT p90 objective
FLEET_WARM_BLOCKS = 32             # a joiner's import from the warmest donor
FLEET_BURST = 4                    # concurrent requests timed for ITL / idle share
DISAGG_PROMPTS = 8
DISAGG_LENGTHS = (300, 1000)


def kv_block_bytes(config) -> int:
    """Bytes of one ``PREFIX_BLOCK``-token KV block of ``config`` (every
    layer, K and V; fp32 KV under fp32 activations, else bf16)."""
    kv = 4 if config.dtype == "float32" else 2
    return config.num_layers * 2 * PREFIX_BLOCK * config.num_kv_heads * config.head_dim * kv


def fleet_engine(config, *, device: str, phase: str = "colocated", fault_injector=None,
                 buckets: tuple = ENGINE_BUCKETS, max_new_tokens: int = FLEET_NEW_TOKENS):
    """One fleet member: a paged ``DecodeEngine`` with its own pool,
    ``RadixPrefixCache``, registry, flight and trace recorders."""
    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.models import Llama
    from unionml_tpu_torch.serving import DecodeEngine
    from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

    reg = telemetry.MetricsRegistry()
    return DecodeEngine(
        Llama(config), paged=True, slots=FLEET_SLOTS, prompt_buckets=buckets,
        max_new_tokens=max_new_tokens, chunk_steps=8,
        prefix_cache=RadixPrefixCache(block_size=PREFIX_BLOCK, max_bytes=FLEET_STORE_BYTES,
                                      registry=reg),
        kv_pool_bytes=FLEET_POOL_BLOCKS * kv_block_bytes(config), registry=reg,
        flight=telemetry.FlightRecorder(), tracer=telemetry.TraceRecorder(registry=reg),
        fault_injector=fault_injector, phase=phase, device=device,
    )


def engine_app(engine, params, *, name: str, **kw):
    """A stdlib ``ServingApp`` over ``engine``: /predict through
    ``engine.generate``, /predict/stream, health, stats, drain, the cache
    peek and KV routes, on the engine's own registry and recorders."""
    from unionml_tpu_torch import Dataset, Model
    from unionml_tpu_torch.model import ModelArtifact
    from unionml_tpu_torch.serving import ServingApp

    dataset = Dataset(name=f"{name}_dataset", targets=[])

    @dataset.reader
    def reader() -> list:
        return []

    lm = Model(name=name, init=lambda: params, dataset=dataset)

    @lm.trainer
    def trainer(p: dict, features: list) -> dict:
        return p

    @lm.predictor
    def predictor(p: dict, prompts: list) -> list:
        return engine.generate(p, prompts)

    lm.artifact = ModelArtifact(params, {}, {})
    return ServingApp(
        lm, batch=False, stats=engine.stats, health=engine.health, drain=engine.drain,
        stream=lambda p, prompts: engine.generate_stream(p, prompts[0]),
        cache_peek=engine.prefix_cache.peek, kv_export=engine.kv_export,
        kv_import=engine.kv_import, registry=engine.registry, tracer=engine.tracer,
        flight=engine.flight, **kw,
    )


def wait_until(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.01)


def engine_at_rest(engine) -> bool:
    """No pool block in use or reserved, no prefix-cache lease held."""
    pool = engine.stats()["kv_pool"]
    return (pool["blocks_in_use"] == 0 and pool["blocks_reserved"] == 0
            and not engine.prefix_cache.refcounts())


def store_bit_mismatches(got_blocks: list, want_blocks: list) -> int:
    """Blocks (host block trees) whose buffers differ from the other list's
    in any bit."""
    if len(got_blocks) != len(want_blocks):
        raise AssertionError(f"{len(got_blocks)} blocks vs {len(want_blocks)}")
    if not got_blocks:
        return 0
    return len(splice_bit_mismatches(host_store_rows(got_blocks), host_store_rows(want_blocks)))


def fleet_routing(router, engines, prompts_by_family: list, *, max_new_tokens: int,
                  prefix_tokens: int, vocab: int) -> dict:
    """Each family's first request, then its follow-ups, one at a time
    through ``router``: the first request of a family lands by the
    round-robin tie-break of two cold replicas; every follow-up must route
    to the replica that holds the family's prefix (the router's route
    events and ``unionml_router_requests_total``), the prefill tokens the
    engines saved must equal what the prompt lengths imply, and every
    reply has its full length."""
    names = [f"r{i}" for i in range(len(engines))]
    flight = router._flight
    home, misroutes, rows, matched = [], [], [], []

    def ask(prompt):
        out = router.generate(prompt)
        if len(out) != max_new_tokens or not all(0 <= t < vocab for t in out):
            raise AssertionError(f"bad fleet reply for a {len(prompt)}-token prompt: {out}")
        return flight.dump(kind="route")[-1]["replica"]

    for fam in prompts_by_family:
        first = fam[0]
        where = ask(first)
        home.append(where)
        cache = engines[names.index(where)].prefix_cache
        # the first request's blocks land after its reply: the follow-ups
        # are routed on them
        wait_until(lambda: cache.peek(first) >= prefix_tokens // PREFIX_BLOCK * PREFIX_BLOCK,
                   f"the prefix of a family stored on {where}")
    for f, fam in enumerate(prompts_by_family):
        for prompt in fam[1:]:
            where = ask(prompt)
            if where != home[f]:
                misroutes.append((f, where, home[f]))
            rows.append(len(prompt))
            matched.append(prefix_tokens // PREFIX_BLOCK)
    routed = router._registry.snapshot().get("unionml_router_requests_total", {})
    saved = sum(e.stats()["prefix_cache"]["prefill_tokens_saved"] for e in engines)
    expected = expected_saved_tokens(rows, matched, PREFIX_BLOCK)
    out = {"home": home, "misroutes": misroutes, "route_counters": routed,
           "prefill_tokens_saved": saved, "expected_tokens_saved": expected,
           "requests": sum(len(f) for f in prompts_by_family)}
    log(f"fleet routing: {out['requests']} requests of {len(prompts_by_family)} families, homes "
        f"{home}; follow-ups off their family's replica {misroutes}; router counters {routed}; "
        f"prefill tokens saved {saved} (the prompt lengths imply {expected})")
    if misroutes:
        raise AssertionError(f"follow-ups routed off their prefix's replica: {misroutes}")
    if set(home) != set(names):
        raise AssertionError(f"the families' first requests all landed on {home}")
    if saved != expected:
        raise AssertionError(f"prefill tokens saved {saved}, the prompt lengths imply {expected}")
    return out


def fleet_failover(router, engines, fis, prompts: list, *, max_new_tokens: int,
                   victim: str = "r1") -> dict:
    """Kill ``victim`` mid-stream (its FaultInjector fails its second
    decode dispatch with an OOM-shaped error) under ``prompts`` streamed
    concurrently: every caller gets a full answer with no error, the
    router's eject and retry counters and flight events show the
    failover, the victim's pool blocks and leases go back to 0, and after
    its cooldown the half-open probe rejoins it."""
    from unionml_tpu_torch.serving.faults import xla_oom_error

    names = [f"r{i}" for i in range(len(engines))]
    vi = names.index(victim)
    flight = router._flight
    before = len(flight.dump())
    fis[vi].arm("engine.dispatch", nth=2, exc=xla_oom_error())
    results, errors = [None] * len(prompts), []

    def call(i, prompt):
        try:
            results[i] = [t for chunk in router.generate_stream(
                prompt, max_new_tokens=max_new_tokens) for t in chunk]
        except Exception as exc:
            errors.append(f"{len(prompt)}-token prompt: {exc!r}")

    threads = [threading.Thread(target=call, args=(i, p)) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(th.is_alive() for th in threads):
        raise AssertionError("the failover callers did not finish in 300 s")
    wall_s = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"callers saw errors in the failover: {errors}")
    short = [len(r) for r in results if r is None or len(r) != max_new_tokens]
    if short:
        raise AssertionError(f"failover replies of {short} tokens, expected {max_new_tokens}")
    injected = fis[vi].injected("engine.dispatch")
    events = flight.dump()[before:]
    kinds = [e["kind"] for e in events]
    snap = router._registry.snapshot()
    ejections = int(router._m_ejections.labels(victim).value)
    retries = sum(snap.get("unionml_router_retries_total", {}).values())
    if injected != 1 or ejections < 1 or retries < 1 or "retry" not in kinds \
            or "eject" not in kinds:
        raise AssertionError(f"the failover left no trace: injected {injected}, ejections "
                             f"{ejections}, retries {retries}, events {sorted(set(kinds))}")
    wait_until(lambda: engine_at_rest(engines[vi]), f"{victim}'s pool and leases at rest")
    pool_after = engines[vi].stats()["kv_pool"]["blocks_in_use"]
    leases_after = engines[vi].prefix_cache.refcounts()
    # the cooldown, then traffic until the half-open probe rejoins it
    cooldown = router.policy.eject_cooldown_s
    time.sleep(cooldown)
    t_probe = time.perf_counter()
    probes = 0
    while router.health()["replicas"][victim]["state"] != "live":
        if probes >= 24:
            raise AssertionError(f"{victim} did not rejoin after {probes} requests past its "
                                 f"cooldown: {router.health()['replicas'][victim]}")
        router.generate(prompts[probes % len(prompts)])
        probes += 1
    rejoin_s = time.perf_counter() - t_probe
    later = [e["kind"] for e in flight.dump()[before:]]
    if "probe" not in later or "rejoin" not in later:
        raise AssertionError(f"no probe / rejoin flight event: {sorted(set(later))}")
    wait_until(lambda: all(engine_at_rest(e) for e in engines), "the fleet at rest")
    out = {"callers": len(prompts), "wall_s": wall_s, "injected": injected,
           "ejections": ejections, "retries": retries,
           "rejoins": int(router._m_rejoins.labels(victim).value),
           "victim_pool_blocks_after": pool_after, "victim_leases_after": leases_after,
           "requests_to_rejoin": probes, "rejoin_s": rejoin_s,
           "recoveries": int(engines[vi]._m_recoveries.value)}
    log(f"fleet failover: {victim} killed mid-stream under {len(prompts)} concurrent streams, "
        f"all answered in full in {wall_s} s; ejections {ejections}, retries {retries}, "
        f"engine recoveries {out['recoveries']}; {victim} pool blocks {pool_after}, leases "
        f"{leases_after} after; rejoined through the half-open probe after {probes} requests "
        f"({rejoin_s} s past its {cooldown} s cooldown)")
    return out


def sample_utilization(interval_ms: int = 200):
    """Start ``nvidia-smi`` sampling card 0's ``utilization.gpu`` (the share
    of each sample period in which a kernel ran) every ``interval_ms``;
    returns a ``stop()`` that ends the process and gives the samples (%),
    or None without ``nvidia-smi``."""
    try:
        proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", f"--loop-ms={interval_ms}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None

    def stop() -> list:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        return [float(x) for x in out.split() if x.strip().replace(".", "", 1).isdigit()]

    return stop


def fleet_burst(router, engines, prompts: list, *, on_card: bool, max_new_tokens: int) -> dict:
    """``prompts`` through ``router`` from as many threads at once: each
    replica's ITL and TTFT summaries, and the card's idle share over the
    burst (one minus the mean of ``nvidia-smi``'s ``utilization.gpu``
    sampled every 200 ms), reported, not held. Held: no thread waits for
    the whole card while the two engines serve (``torch.cuda.synchronize``
    is counted; an engine waits on its own events), and the implicit host
    waits CUDA's sync debug mode reports are counted."""
    for e in engines:
        e.reset_stats()
    errors, device_syncs = [], []

    def call(p):
        try:
            router.generate(p, max_new_tokens=max_new_tokens)
        except Exception as exc:
            errors.append(repr(exc))

    real_sync = torch.cuda.synchronize

    def counted_sync(*args, **kwargs):
        device_syncs.append(threading.current_thread().name)
        return real_sync(*args, **kwargs)

    threads = [threading.Thread(target=call, args=(p,)) for p in prompts]
    if on_card:
        real_sync()
    stop = sample_utilization() if on_card else None
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize = counted_sync
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
        finally:
            torch.cuda.synchronize = real_sync
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
                real_sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    util = stop() if stop is not None else []
    host_syncs = [str(w.message) for w in caught
                  if "synchronizing CUDA operation" in str(w.message)]
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"the burst's requests failed: {errors}")
    if device_syncs:
        raise AssertionError(f"{len(device_syncs)} waits for the whole card while two engines "
                             f"served ({sorted(set(device_syncs))})")
    per = {}
    for i, e in enumerate(engines):
        st = e.stats()
        per[f"r{i}"] = {"itl_ms": st.get("itl_ms"), "ttft_ms": st.get("ttft_ms")}
    busy = sum(util) / len(util) / 100 if util else None
    out = {"requests": len(prompts), "wall_ms": wall_ms, "utilization_samples": len(util),
           "idle_share": None if busy is None else 1 - busy,
           "device_syncs": len(device_syncs), "host_syncs": len(host_syncs), "replicas": per}
    log(f"fleet burst: {len(prompts)} concurrent requests in {wall_ms} ms; idle share "
        f"{out['idle_share']} ({len(util)} nvidia-smi utilization samples); waits for the "
        f"whole card 0, implicit host waits {len(host_syncs)}; per replica {per}")
    return out


def fleet_autoscale(router, config, params, engines, *, device: str, warm_blocks: int,
                    flight, **engine_kw) -> dict:
    """``FleetAutoscaler`` with an ``EngineReplicaProvisioner`` whose
    factory shares the weight tree: one scale-out (below its floor of
    three) imports the warmest donor's hot blocks, bit-equal to the
    donor's, and a request on the joiner splices them into its pool bit
    for bit; then, the floor lowered to two, one scale-in drains and
    releases the joiner, and the card's allocated bytes fall by at least
    its pool's."""
    import gc

    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.serving import (
        AutoscalerPolicy,
        EngineReplicaProvisioner,
        FleetAutoscaler,
    )

    on_card = device == "cuda"
    made = []

    def factory():
        engine = fleet_engine(config, device=device, **engine_kw)
        made.append(engine)
        return engine, params

    auto = FleetAutoscaler(
        router, EngineReplicaProvisioner(factory),
        policy=AutoscalerPolicy(min_replicas=3, max_replicas=3, cooldown_out_s=0.0,
                                cooldown_in_s=0.0, warm_blocks=warm_blocks),
        registry=telemetry.MetricsRegistry(), flight=flight,
    )
    try:
        out_d = auto.evaluate()
        if out_d["decision"] != "scale_out" or not made:
            raise AssertionError(f"the autoscaler did not scale out below its floor: {out_d}")
        joiner = made[0]
        name = next(n for n in router.health()["replicas"] if n not in ("r0", "r1"))
        donor = out_d.get("donor")
        warmed = int(out_d.get("warmed_blocks") or 0)
        if donor not in ("r0", "r1") or warmed < 2:
            raise AssertionError(f"the joiner was not warmed from a donor: {out_d}")
        donor_cache = engines[int(donor[1:])].prefix_cache
        entries = joiner.prefix_cache.export_hot(max_blocks=1 << 20)
        if len(entries) != warmed:
            raise AssertionError(f"the joiner holds {len(entries)} blocks, {warmed} were warmed")
        mine, theirs = [], []
        for entry in entries:
            lease = donor_cache.lease(entry["tokens"])
            try:
                if lease.n_blocks <= entry["first_block"]:
                    raise AssertionError("a warmed block is not in the donor's store")
                theirs.append(lease.rows[entry["first_block"]])
            finally:
                lease.release()
            mine.append(entry["rows"])
        bad = store_bit_mismatches(mine, theirs)
        if bad:
            raise AssertionError(f"{bad} warmed blocks differ from the donor's")
        # a request on the joiner splices its deepest warmed path into its pool
        deepest = max(entries, key=lambda e: e["first_block"])
        splice = warm_splice_check("fleet warm join splice bits", joiner, params,
                                   deepest["tokens"].tolist() + [1])
        wait_until(lambda: engine_at_rest(joiner), "the joiner at rest")
        if on_card:
            torch.cuda.synchronize()
        mem_joined = torch.cuda.memory_allocated() if on_card else None
        pool_bytes = joiner.stats()["kv_pool"]["capacity_blocks"] * kv_block_bytes(config)
        auto.policy.min_replicas = 2
        in_d = auto.evaluate()
        if in_d["decision"] != "scale_in" or in_d.get("replica") != name:
            raise AssertionError(f"the scale-in did not remove the joiner {name}: {in_d}")
        if name in router.health()["replicas"]:
            raise AssertionError(f"{name} is still a fleet member after its scale-in")
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
        freed = None if mem_joined is None else mem_joined - torch.cuda.memory_allocated()
        if on_card and freed < pool_bytes:
            raise AssertionError(f"the scale-in gave back {freed} bytes of the card, the "
                                 f"joiner's pool held {pool_bytes}")
        kinds = [e["kind"] for e in flight.dump()]
        if "scale_out" not in kinds or "scale_in" not in kinds:
            raise AssertionError(f"no scale_out / scale_in flight events: {sorted(set(kinds))}")
    finally:
        auto.close()
        for engine in made:
            engine.close()
    out = {"scale_out": {k: out_d.get(k) for k in ("reason", "donor", "warmed_blocks")},
           "joiner": name, "warmed_blocks_bit_equal": warmed, "joiner_splice_bits": splice,
           "scale_in": {k: in_d.get(k) for k in ("reason", "replica")},
           "bytes_freed": freed, "pool_bytes": pool_bytes}
    log(f"fleet autoscaler: scale-out ({out_d.get('reason')}) warmed {name} with {warmed} "
        f"blocks from {donor}, bit-equal to the donor's; the joiner's pool rows equal its "
        f"store; scale-in ({in_d.get('reason')}) removed {name} and gave back {freed} bytes of "
        f"the card (its pool held {pool_bytes})")
    return out


def fleet_disagg(config, params, prompts: list, *, device: str, colocated,
                 max_new_tokens: int, buckets: tuple = ENGINE_BUCKETS) -> dict:
    """``DisaggRouter`` over a ``phase="prefill"`` engine and a
    ``phase="decode"`` engine with separate host stores, the prompts sent
    at once: each prompt prefills on the first, its KV blocks move device
    -> the prefill store -> the decode store, and the decode leg splices
    them. Every
    reply has its full length; the decode store's blocks equal the
    prefill engine's export bit for bit, and a decode admission's pool
    rows equal its store; handoff leases and both pools go back to 0.
    The handoff's ms and bytes and the tokens' agreement with the
    colocated engine ``colocated`` (bf16: reported) are returned."""
    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.serving import DisaggRouter, EngineReplica, RouterPolicy

    kw = dict(device=device, buckets=buckets, max_new_tokens=max_new_tokens)
    pre = fleet_engine(config, phase="prefill", **kw)
    dec = fleet_engine(config, phase="decode", **kw)
    flight = telemetry.FlightRecorder()
    router = DisaggRouter(
        [EngineReplica(pre, params, name="p0"), EngineReplica(dec, params, name="d0")],
        policy=RouterPolicy(health_ttl_s=0.0, backoff_base_s=0.0, jitter_s=0.0),
        registry=telemetry.MetricsRegistry(), flight=flight,
    )
    try:
        outs, errors = [None] * len(prompts), []

        def call(i, p):
            try:
                outs[i] = [t for chunk in router.generate_stream(p) for t in chunk]
            except Exception as exc:
                errors.append(repr(exc))

        threads = [threading.Thread(target=call, args=(i, p)) for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall_s = time.perf_counter() - t0
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"disaggregated requests failed: {errors}")
        short = [len(o) for o in outs if len(o) != max_new_tokens]
        if short:
            raise AssertionError(f"disagg replies of {short} tokens, expected {max_new_tokens}")
        handoffs = flight.dump(kind="handoff")
        results = [h["result"] for h in handoffs]
        if results != ["transfer"] * len(prompts):
            raise AssertionError(f"handoff outcomes {results}, expected a transfer each")
        wait_until(lambda: engine_at_rest(pre) and engine_at_rest(dec), "both pools at rest")
        bad, blocks = 0, 0
        for p in prompts:
            exported = pre.kv_export(p)
            lease = dec.prefix_cache.lease(dec._canonical_row(p))
            try:
                if lease.n_blocks < len(exported):
                    raise AssertionError(f"the decode store holds {lease.n_blocks} of the "
                                         f"{len(exported)} exported blocks")
                bad += store_bit_mismatches([e["rows"] for e in exported],
                                            list(lease.rows[:len(exported)]))
                blocks += len(exported)
            finally:
                lease.release()
        if bad:
            raise AssertionError(f"{bad} of {blocks} transferred blocks differ from the export")
        splice = warm_splice_check("disagg decode splice bits", dec, params,
                                   max(prompts, key=len))
        wait_until(lambda: engine_at_rest(pre) and engine_at_rest(dec), "both pools at rest")
        pools = [e.stats()["kv_pool"]["blocks_in_use"] for e in (pre, dec)]
        leases = [e.prefix_cache.refcounts() for e in (pre, dec)]
        block_bytes = kv_block_bytes(config)
        ms = [h["handoff_ms"] for h in handoffs]
        moved = [h["blocks"] for h in handoffs]
    finally:
        pre.close()
        dec.close()
    solo = (colocated.generate(params, prompts, max_new_tokens=max_new_tokens)
            if colocated is not None else None)
    same = None if solo is None else sum(a == b for a, b in zip(outs, solo))
    lead = None if solo is None else [
        next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
        for x, y in zip(outs, solo)]
    out = {"prompts": len(prompts), "lengths": [len(p) for p in prompts], "wall_s": wall_s,
           "handoff_ms": ms, "handoff_blocks": moved,
           "handoff_bytes": [b * block_bytes for b in moved],
           "transferred_blocks_bit_equal": blocks, "decode_splice_bits": splice,
           "pool_blocks_after": pools, "leases_after": leases,
           "token_identical_to_colocated": same, "leading_tokens_equal": lead,
           "outputs": outs}
    log(f"fleet disagg: {len(prompts)} prompts of {out['lengths']} ids in {wall_s} s; handoff "
        f"ms {ms}, blocks {moved} ({out['handoff_bytes']} bytes); {blocks} transferred blocks "
        f"equal the prefill export bit for bit; pools {pools} and leases {leases} after; "
        f"token-identical to the colocated engine {same}/{len(prompts)} (leading tokens equal "
        f"{lead})")
    return out


def post_traced(url: str, payload: dict, headers: dict, timeout: float = 600.0):
    """POST ``payload`` with ``headers``: ``(status, body, response headers)``."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **headers})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def fleet_http(engines, params, prompts: list, *, max_new_tokens: int) -> dict:
    """``make_router_app`` on loopback over ``r0`` in process and ``r1`` as
    an ``HttpReplica`` over a stdlib ``ServingApp`` of the second engine
    that exports to an ``OtlpCollectorStub``: each prompt (of a family
    that ``r1`` holds) is one ``POST /predict`` with its own
    ``traceparent``, through two hops. Each reply has its full length and
    echoes the trace id with an ``X-Request-ID``; the front door's ``GET
    /debug/trace?rid=`` of that id answers with the caller's trace,
    stitched across the hop (``r1``'s server span parented to one of the
    front door's attempt spans); the stub receives ``r1``'s spans of every
    trace."""
    import uuid

    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.exporters import OtlpCollectorStub
    from unionml_tpu_torch.serving import (
        EngineReplica,
        FleetRouter,
        HttpReplica,
        RouterPolicy,
        make_router_app,
    )

    stub = OtlpCollectorStub()
    app = engine_app(engines[1], params, name="chip_smoke_fleet_r1", otlp_endpoint=stub.endpoint)
    front = None
    try:
        host, port = app.serve(host="127.0.0.1", port=0, blocking=False)
        tracer = telemetry.TraceRecorder()
        router = FleetRouter(
            [EngineReplica(engines[0], params, name="r0"),
             HttpReplica(f"http://{host}:{port}", name="r1")],
            policy=RouterPolicy(health_ttl_s=0.0, backoff_base_s=0.0, jitter_s=0.0),
            registry=telemetry.MetricsRegistry(), flight=telemetry.FlightRecorder(),
            tracer=tracer,
        )
        front = make_router_app(router, registry=router._registry, tracer=tracer,
                                flight=router._flight)
        fhost, fport = front.serve(host="127.0.0.1", port=0, blocking=False)
        traces, rids = [], []
        for prompt in prompts:
            trace_id = uuid.uuid4().hex
            status, body, hdrs = post_traced(
                f"http://{fhost}:{fport}/predict", {"features": [prompt]},
                {"traceparent": f"00-{trace_id}-{uuid.uuid4().hex[:16]}-01"})
            echo = {k.lower(): v for k, v in hdrs.items()}
            if status != 200 or len(body) != 1 or len(body[0]) != max_new_tokens:
                raise AssertionError(f"bad front-door reply: {status} {body}")
            if trace_id not in echo.get("traceparent", "") or not echo.get("x-request-id"):
                raise AssertionError(f"the reply does not echo the trace / a request id: {echo}")
            traces.append(trace_id)
            rids.append(echo["x-request-id"])
        routes = [e["replica"] for e in router._flight.dump(kind="route")]
        if routes != ["r1"] * len(prompts):
            raise AssertionError(f"the front door routed {routes}, expected r1 (its prefix) "
                                 f"each time")
        stitched = []
        for trace_id, rid in zip(traces, rids):
            wait_until(lambda: engines[1].tracer.requests_for_trace(trace_id),
                       "r1's server timeline in the trace")
            with urllib.request.urlopen(f"http://{fhost}:{fport}/debug/trace?rid={rid}",
                                        timeout=60) as resp:
                doc = json.loads(resp.read())
            if doc.get("trace_id") != trace_id:
                raise AssertionError(f"/debug/trace?rid={rid} answers trace "
                                     f"{doc.get('trace_id')}, the caller's is {trace_id}")
            attempts = {s["span_id"] for s in doc["spans"] if s.get("name") == "attempt"}
            remote = [s for s in doc["spans"] if s.get("root") and s.get("kind") == "http"
                      and s.get("replica") == "r1"]
            if not attempts or len(remote) != 1 or remote[0]["parent_span_id"] not in attempts:
                raise AssertionError(f"trace {trace_id} does not stitch across the hop: "
                                     f"attempts {attempts}, r1 server spans {remote}")
            stitched.append(len(doc["spans"]))
        seen = set()
        deadline = time.monotonic() + 30
        while not set(traces) <= seen and time.monotonic() < deadline:
            app._otlp.flush()
            seen = {s["traceId"] for p in stub.payloads("/v1/traces")
                    for rs in p["resourceSpans"] for ss in rs["scopeSpans"] for s in ss["spans"]}
            time.sleep(0.05)
        if not set(traces) <= seen:
            raise AssertionError(f"the OTLP stub received {len(seen & set(traces))} of the "
                                 f"{len(traces)} traces")
        n_spans = sum(len(ss["spans"]) for p in stub.payloads("/v1/traces")
                      for rs in p["resourceSpans"] for ss in rs["scopeSpans"])
    finally:
        if front is not None:
            front.shutdown()
        app.shutdown()
        stub.close()
    out = {"requests": len(prompts), "routes": routes, "stitched_spans": stitched,
           "otlp_traces": len(seen & set(traces)), "otlp_spans": n_spans}
    log(f"fleet http: {len(prompts)} POST /predict through the front door and r1's "
        f"ServingApp, each one stitched trace ({stitched} spans); the OTLP stub received "
        f"{n_spans} spans of all {len(traces)} traces")
    return out


def fleet_phase(config, params, *, device: str = "cuda", families: int = FLEET_FAMILIES,
                follow_ups: int = FLEET_FOLLOW_UPS, prefix_tokens: int = FLEET_PREFIX_TOKENS,
                suffix_lengths: tuple = FLEET_SUFFIX_LENGTHS,
                max_new_tokens: int = FLEET_NEW_TOKENS,
                short_new_tokens: int = FLEET_SHORT_NEW_TOKENS, burst: int = FLEET_BURST,
                warm_blocks: int = FLEET_WARM_BLOCKS, disagg_prompts: int = DISAGG_PROMPTS,
                disagg_lengths: tuple = DISAGG_LENGTHS, fp32_layers: int = 4,
                buckets: tuple = ENGINE_BUCKETS) -> dict:
    """The fleet tier over two paged engines of ``config`` that share
    ``params`` (one weight tree), in this order: locality routing, the
    autoscaler's warm join and scale-in, the HTTP front door with OTLP
    export, failover, disaggregated prefill / decode, a concurrent burst
    (ITL per replica, idle share), the serving-mode choice on the card,
    then the disaggregation again in fp32 activations at ``fp32_layers``
    layers held token for token against a colocated engine (at most one
    near-tie flip). The routing and HTTP requests ask for
    ``max_new_tokens``, the failover, disaggregation and burst requests for
    ``short_new_tokens``. Rows 1, 2 and 6 are counted over the bf16 fleet
    traffic (routing to the burst). Each step's seconds are logged.
    ``device="cpu"`` rehearses the phase at a small config."""
    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.models import Llama
    from unionml_tpu_torch.ops import flash_attention as fa
    from unionml_tpu_torch.ops import fused_norm
    from unionml_tpu_torch.ops import paged_attention as pa
    from unionml_tpu_torch.serving import EngineReplica, FleetRouter, RouterPolicy
    from unionml_tpu_torch.serving.auto import choose_serving_mode
    from unionml_tpu_torch.serving.faults import FaultInjector
    from unionml_tpu_torch.slo import LatencyObjective, SloWatchdog

    on_card = device == "cuda"
    config = serving_config(config)
    t_phase = time.perf_counter()
    counters = {"paged_attention": pa.KERNEL, "flash_fwd_padded": fa.KERNEL,
                "rms_norm_fwd": fused_norm.KERNEL}
    rng = np.random.default_rng(17)
    vocab = config.vocab_size

    def prompt_of(prefix):
        n = int(rng.integers(suffix_lengths[0], suffix_lengths[1] + 1))
        return prefix + rng.integers(1, vocab, size=n).tolist()

    prefixes = [rng.integers(1, vocab, size=prefix_tokens).tolist() for _ in range(families)]
    by_family = [[prompt_of(p) for _ in range(1 + follow_ups)] for p in prefixes]
    fis = [FaultInjector(), FaultInjector()]
    engines = [fleet_engine(config, device=device, fault_injector=fi, buckets=buckets,
                            max_new_tokens=max_new_tokens) for fi in fis]
    watchdogs = [SloWatchdog([LatencyObjective("ttft_p90", "unionml_engine_ttft_ms",
                                               FLEET_TTFT_OBJECTIVE_MS, target=0.9)],
                             registry=e.registry) for e in engines]
    flight = telemetry.FlightRecorder()
    router = FleetRouter(
        [EngineReplica(e, params, name=f"r{i}", slo=w)
         for i, (e, w) in enumerate(zip(engines, watchdogs))],
        policy=RouterPolicy(health_ttl_s=0.0, backoff_base_s=0.0, jitter_s=0.0,
                            eject_consecutive=1, eject_cooldown_s=1.0),
        registry=telemetry.MetricsRegistry(), flight=flight,
    )
    out = {"layers": config.num_layers, "families": families, "prefix_tokens": prefix_tokens,
           "step_s": {}}

    def step(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        out["step_s"][name] = time.perf_counter() - t0
        log(f"time: fleet {name} done in {out['step_s'][name]:.1f} s")
        return out[name]

    try:
        # no warm-up: the prefix phase served this config, kernels and
        # buckets, in this process
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        step("routing", lambda: fleet_routing(router, engines, by_family,
                                              max_new_tokens=max_new_tokens,
                                              prefix_tokens=prefix_tokens, vocab=vocab))
        r1_families = [f for f, h in enumerate(out["routing"]["home"]) if h == "r1"]
        # before any burst: a scale-in waits for every replica's SLO burn to
        # clear, and a burst's queueing burns the TTFT objective
        step("autoscaler", lambda: fleet_autoscale(
            router, config, params, engines, device=device, warm_blocks=warm_blocks,
            flight=flight, buckets=buckets, max_new_tokens=max_new_tokens))
        # the front door while r1 alone holds its families' prefixes
        step("http", lambda: fleet_http(
            engines, params, [prompt_of(prefixes[r1_families[-1]]) for _ in range(4)],
            max_new_tokens=max_new_tokens))
        step("failover", lambda: fleet_failover(
            router, engines, fis, [prompt_of(prefixes[r1_families[0]]) for _ in range(4)],
            max_new_tokens=short_new_tokens))
        lengths = rng.integers(disagg_lengths[0], disagg_lengths[1] + 1, size=disagg_prompts)
        dprompts = [rng.integers(1, vocab, size=int(n)).tolist() for n in lengths]
        step("disagg", lambda: fleet_disagg(config, params, dprompts, device=device,
                                            colocated=engines[0],
                                            max_new_tokens=short_new_tokens, buckets=buckets))
        step("burst", lambda: fleet_burst(
            router, engines, [prompt_of(prefixes[i % families]) for i in range(burst)],
            on_card=on_card, max_new_tokens=short_new_tokens))
        if on_card:
            torch.cuda.synchronize()
        out["launches"] = {name: c.launches for name, c in counters.items()}
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
        mode = step("mode", lambda: choose_serving_mode(Llama(config), params, device=device))
        log(f"fleet mode choice: rtt_ms {mode['rtt_ms']} decode_chunk_ms "
            f"{mode['decode_chunk_ms']} -> {mode['mode']} ({mode['rule']})")
    finally:
        router.close()
        for e in engines:
            e.close()
    out["disagg"].pop("outputs")
    if on_card:
        for name, n in out["launches"].items():
            if n == 0:
                raise AssertionError(f"kernel {name} was never launched on the fleet path")

    # fp32 activations at reduced depth: disaggregated vs colocated, token for token
    t_fp32 = time.perf_counter()
    cfg32 = fp32_config(config, fp32_layers)
    _, params32 = build_template(cfg32, max_new_tokens, buckets, device)
    solo = fleet_engine(cfg32, device=device, buckets=buckets, max_new_tokens=max_new_tokens)
    try:
        fp32 = fleet_disagg(cfg32, params32, dprompts, device=device, colocated=solo,
                            max_new_tokens=short_new_tokens, buckets=buckets)
    finally:
        solo.close()
    if fp32["token_identical_to_colocated"] < len(dprompts) - 1:
        raise AssertionError(f"fp32 disaggregated serving disagrees with the colocated engine: "
                             f"{fp32['token_identical_to_colocated']}/{len(dprompts)}")
    fp32.pop("outputs")
    out["disagg_fp32"] = {"layers": fp32_layers,
                          "match": f"{fp32['token_identical_to_colocated']}/{len(dprompts)}",
                          "handoff_ms": fp32["handoff_ms"]}
    out["step_s"]["disagg_fp32"] = time.perf_counter() - t_fp32
    log(f"time: fleet disagg_fp32 done in {out['step_s']['disagg_fp32']:.1f} s")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"fleet: fp32 disaggregated vs colocated at {fp32_layers} layers "
        f"{out['disagg_fp32']['match']} token-identical; launches {out['launches']}; peak "
        f"memory {out['peak_mem_gib']} GiB; phase {out['seconds']:.1f} s")
    return out


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


# --------------------------------------------------------------------- #
# the deployment front: serverless handlers, versioned rollouts with
# shadow traffic, the remote backend
# --------------------------------------------------------------------- #

SERVERLESS_LENGTHS = (1000, 300)    # the gateway prompts: the first alone, then both at once
SERVERLESS_UPLOAD_LENGTHS = (5, 200)  # the rows of the one uploaded object


def first_difference(got, want):
    """The index of the first token where ``got`` and ``want`` differ
    (``None`` where they are equal)."""
    if got == want:
        return None
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))


def serverless_phase(config, params, *, device: str = "cuda", lengths: tuple = SERVERLESS_LENGTHS,
                     upload_lengths: tuple = SERVERLESS_UPLOAD_LENGTHS,
                     max_new_tokens: int = ENGINE_NEW_TOKENS, buckets: tuple = ENGINE_BUCKETS,
                     ) -> dict:
    """The serverless handlers over the llm_serving template's Model at
    ``config`` with ``params`` (the weights the engine phases served) as
    its artifact; a fresh spec, since those phases registered their
    engines' predictors on theirs. ``POST /predict`` gateway events
    (``X-Tenant-ID``, ``X-Request-ID`` and ``traceparent`` headers) go
    through ``gateway_handler(model, batch=True, row_lists=True)``, the
    micro-batcher set up: the first prompt of ``lengths`` alone, whose
    tokens must equal the same request through the model's
    ``ServingApp.predict``; then every prompt of ``lengths`` at once from
    threads, which must share one batch and give the tokens of the same
    prompts sent together through ``ServingApp.predict``. How far each of
    those rows keeps its tokens alone is reported, not held: a row's bf16
    tokens on the card depend on its batch neighbours (ROADMAP C10). Then
    one object-upload event whose object (a JSON file of the
    ``upload_lengths`` prompts in a ``LocalObjectStore`` in a temporary
    directory) goes through ``object_event_handler`` and must give the
    tokens of the same rows through ``ServingApp.predict``. Each header
    must come back. Reports rows 1 and 2's launches over the handlers'
    requests, each call's wall ms and the handler's own ms around its
    predict (the wall less the predict inside). ``device="cpu"``
    rehearses the phase."""
    import tempfile
    import threading

    from unionml_tpu_torch import ModelArtifact
    from unionml_tpu_torch.ops import flash_attention as fa
    from unionml_tpu_torch.ops import fused_norm
    from unionml_tpu_torch.serving.serverless import (
        LocalObjectStore,
        gateway_handler,
        object_event_handler,
    )

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    from unionml_tpu_torch.templates.llm_serving.app import build_model

    t_phase = time.perf_counter()
    model = build_model(config, name="chip_smoke_serverless", max_new_tokens=max_new_tokens,
                        bucket_lens=buckets)
    model.artifact = ModelArtifact(params)
    counters = {"flash_fwd_padded": fa.KERNEL, "rms_norm_fwd": fused_norm.KERNEL}
    rng = np.random.default_rng(23)
    vocab = config.vocab_size
    prompts = [rng.integers(1, vocab, size=n).tolist() for n in lengths]
    rows = [rng.integers(1, vocab, size=n).tolist() for n in upload_lengths]

    def timed(app, into: dict):
        """``into[thread id]``: the ms of that thread's last predict call."""
        inner = app.predict

        def predict(payload):
            t0 = time.perf_counter()
            try:
                return inner(payload)
            finally:
                sync()
                into[threading.get_ident()] = (time.perf_counter() - t0) * 1e3

        app.predict = predict

    # a batch leaves once it holds every prompt, or 200 ms after its first
    handler = gateway_handler(model, batch=True, row_lists=True,
                              max_batch_size=len(prompts), max_wait_ms=200.0)
    app = handler.serving_app
    app.setup_model()   # the artifact is loaded: build the micro-batcher
    if app._batcher is None:
        raise AssertionError("the gateway's ServingApp built no micro-batcher")
    inner_ms, sent = {}, {}

    def send(i, prompt):
        trace = f"{i + 1:032x}"
        event = {"httpMethod": "POST", "path": "/predict",
                 "headers": {"X-Tenant-ID": "smoke", "X-Request-ID": f"serverless-{i}",
                             "traceparent": f"00-{trace}-{i + 1:016x}-01"},
                 "body": json.dumps({"features": [prompt]})}
        t0 = time.perf_counter()
        resp = handler(event)
        wall = (time.perf_counter() - t0) * 1e3
        h = resp["headers"]
        if (resp["statusCode"] != 200 or h["X-Request-ID"] != f"serverless-{i}"
                or h["X-Tenant-ID"] != "smoke" or trace not in h["traceparent"]):
            raise AssertionError(f"bad gateway reply for a {len(prompt)}-token prompt: "
                                 f"{resp['statusCode']} {h} {resp['body'][:200]}")
        sent[i] = (json.loads(resp["body"])[0], wall, inner_ms[threading.get_ident()])

    timed(app, inner_ms)
    try:
        sync()
        for c in counters.values():
            c.launches = 0
        send(0, prompts[0])
        app.reset_stats()
        threads = [threading.Thread(target=send, args=(1 + i, p)) for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if len(sent) != 1 + len(prompts):
            raise AssertionError("a gateway event sent at once failed or did not finish")
        pair_stats = app.stats()
        if pair_stats["batches"] != 1 or pair_stats["mean_batch_rows"] != len(prompts):
            raise AssertionError(f"the {len(prompts)} gateway events sent at once did not share "
                                 f"one batch: {pair_stats['batches']} batches, "
                                 f"{pair_stats['mean_batch_rows']} rows each")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_objects_") as tmp:
            store = LocalObjectStore(tmp)
            store.put("uploads", "batch-001.json", json.dumps(rows).encode())
            upload = object_event_handler(model, store)
            upload_inner_ms = {}
            timed(upload.serving_app, upload_inner_ms)
            t0 = time.perf_counter()
            resp = upload({"Records": [{"s3": {"bucket": {"name": "uploads"},
                                               "object": {"key": "batch-001.json"}}}]})
            upload_ms = (time.perf_counter() - t0) * 1e3
            if resp["statusCode"] != 200:
                raise AssertionError(f"object event failed: {resp}")
            uploaded = json.loads(store.get("uploads", "batch-001.json.predictions.json"))
        sync()
        launches = {name: c.launches for name, c in counters.items()}
        health = handler({"httpMethod": "GET", "path": "/health"})
        metrics = handler({"httpMethod": "GET", "path": "/metrics"})
    finally:
        app.shutdown()
    if health["statusCode"] != 200 or 'transport="serverless"' not in metrics["body"]:
        raise AssertionError(f"serverless /health or /metrics wrong: {health}")
    replies = [sent[i][0] for i in range(len(sent))]
    direct = model.serve()
    alone = [direct.predict({"features": [p]})[0] for p in prompts]
    together = direct.predict({"features": prompts})
    if replies[0] != alone[0]:
        raise AssertionError("the gateway event's tokens differ from ServingApp.predict's: "
                             f"{first_difference(replies[0], alone[0])}")
    if replies[1:] != together:
        raise AssertionError("the gateway events' shared batch differs from the same prompts "
                             "through ServingApp.predict together: "
                             f"{[first_difference(a, b) for a, b in zip(replies[1:], together)]}")
    if uploaded != direct.predict({"features": rows}):
        raise AssertionError("object-event tokens differ from ServingApp.predict's")
    if on_card:
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"kernel {name} was never launched on the serverless path")
    calls = [sent[i][1] for i in range(len(sent))]
    predict_ms = [sent[i][2] for i in range(len(sent))]
    out = {
        "gateway_events": len(sent), "prompt_lengths": list(lengths),
        "upload_rows": len(rows), "tokens_equal_direct": True,
        "batches": pair_stats["batches"], "batch_rows": pair_stats["mean_batch_rows"],
        # the step at which each row of the shared batch leaves its tokens
        # alone (None: it keeps them)
        "batched_vs_alone": [first_difference(a, b) for a, b in zip(replies[1:], alone)],
        "handler_ms": calls, "predict_ms": predict_ms,
        "handler_own_ms": [a - b for a, b in zip(calls, predict_ms)],
        "upload_ms": upload_ms, "upload_predict_ms": sum(upload_inner_ms.values()),
        "upload_own_ms": upload_ms - sum(upload_inner_ms.values()),
        "launches": launches, "seconds": time.perf_counter() - t_phase,
    }
    log(f"serverless: a gateway event alone, then {len(prompts)} at once in "
        f"{out['batches']} batch of {out['batch_rows']} rows, "
        f"{[round(x, 2) for x in calls]} ms (handler's own "
        f"{[round(x, 3) for x in out['handler_own_ms']]} ms); one upload of {len(rows)} rows "
        f"{upload_ms:.2f} ms (own {out['upload_own_ms']:.3f} ms); tokens equal to "
        f"ServingApp.predict's for the same requests; the shared batch's rows leave their "
        f"tokens alone at steps {out['batched_vs_alone']} (None: never); launches {launches}; "
        f"phase {out['seconds']:.1f} s")
    return out


ROLLOUT_LAYERS = 4
ROLLOUT_REQUESTS = 8                # live requests shadowed per version
ROLLOUT_NEW_TOKENS = 16
ROLLOUT_LENGTHS = (40, 400)         # the live prompts' lengths


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def rollout_phase(config, params, *, device: str = "cuda", layers: int = ROLLOUT_LAYERS,
                  requests: int = ROLLOUT_REQUESTS, max_new_tokens: int = ROLLOUT_NEW_TOKENS,
                  lengths: tuple = ROLLOUT_LENGTHS, buckets: tuple = ENGINE_BUCKETS) -> dict:
    """Versioned rollouts at ``config``'s width over the first ``layers``
    blocks of ``params`` (``layer_subset``): a ``VersionRegistry`` in a
    temporary directory publishes v1 (those weights), v1b (the same bits
    again) and v2 (v1 with its last block drawn from another seed); a
    ``FleetRouter`` has one live paged ``EngineReplica`` ``r0`` on v1, which
    first serves ``requests`` prompts without a rollout (the ITL baseline,
    and the prefix blocks a canary warms from). Then, for each of v1b and
    v2, ``RolloutController(router, EngineReplicaProvisioner(...),
    registry, state_target=v1)`` with the default policy (divergence
    tolerance 0, shadowing on, warm joins): ``start_rollout(v, percent=0)``
    restores the version onto the card, one ``evaluate`` warm-joins a
    canary engine, and ``requests`` fresh live prompts of
    ``max_new_tokens`` each go to ``r0`` at once while the canary decodes
    their shadows. v1b must bake with 0 divergences and promote (drain →
    ``bind`` → rejoin, then the canary reaped); v2 must roll back as
    ``parity_regression`` with ``r0``'s weight checksums unchanged, its
    pool and leases at rest and the canary's device memory handed back.
    Reports publish ms and bytes, restore and join ms, divergences (and
    the first diverging step of each), promote and rollback ms, ``r0``'s
    ITL p50 without and with shadowing, and rows 1, 2 and 6's launches.
    ``device="cpu"`` rehearses the phase at a small config."""
    import gc
    import tempfile

    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.ops import flash_attention as fa
    from unionml_tpu_torch.ops import fused_norm
    from unionml_tpu_torch.ops import paged_attention as pa
    from unionml_tpu_torch.serving import (
        EngineReplica,
        EngineReplicaProvisioner,
        FleetRouter,
        RouterPolicy,
    )
    from unionml_tpu_torch.serving.rollout import (
        RolloutController,
        RolloutPolicy,
        VersionRegistry,
    )

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def allocated():
        sync()
        gc.collect()
        return torch.cuda.memory_allocated() if on_card else 0

    t_phase = time.perf_counter()
    cfg = serving_config(dataclasses.replace(config, num_layers=layers))
    counters = {"paged_attention": pa.KERNEL, "flash_fwd_padded": fa.KERNEL,
                "rms_norm_fwd": fused_norm.KERNEL}
    v1 = layer_subset(params, layers)
    other = random_quantized_params(dataclasses.replace(cfg, num_layers=1), 7, device=device,
                                    float_dtype=v1[f"block_{layers - 1}"]["attn_norm"]["scale"].dtype)
    v2 = {**v1, f"block_{layers - 1}": other["block_0"]}
    rng = np.random.default_rng(31)

    def fresh_prompts():
        return [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
                for n in rng.integers(lengths[0], lengths[1] + 1, size=requests)]

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_versions_")
    vreg = VersionRegistry(Path(tmp.name) / "versions")
    out = {"layers": layers, "requests": requests, "max_new_tokens": max_new_tokens,
           "publish_ms": {}, "publish_bytes": {}}
    for vid, tree in (("v1", v1), ("v1b", v1), ("v2", v2)):
        sync()
        t0 = time.perf_counter()
        vreg.publish(vid, tree, metadata={"note": {"v1b": "v1 republished",
                                                   "v2": "last block reseeded"}.get(vid, "")})
        out["publish_ms"][vid] = (time.perf_counter() - t0) * 1e3
        out["publish_bytes"][vid] = dir_bytes(vreg.root / f"step_{vreg.resolve(vid)['step']}")
    log(f"rollout: published {list(vreg.versions())}: ms {out['publish_ms']}, bytes "
        f"{out['publish_bytes']}")

    live = fleet_engine(cfg, device=device, buckets=buckets, max_new_tokens=max_new_tokens)
    canaries = []

    def factory():
        engine = fleet_engine(cfg, device=device, buckets=buckets,
                              max_new_tokens=max_new_tokens)
        canaries.append(engine)
        return engine, v1

    flight = telemetry.FlightRecorder()
    router = FleetRouter([EngineReplica(live, v1, name="r0")],
                         policy=RouterPolicy(health_ttl_s=0.0, backoff_base_s=0.0, jitter_s=0.0),
                         registry=telemetry.MetricsRegistry(), flight=flight)
    r0 = router.replica_handle("r0")

    def traffic(prompts):
        """The prompts to the router at once; ``r0``'s ITL p50 over them."""
        live.reset_stats()
        replies, errors = [None] * len(prompts), []

        def ask(i):
            try:
                replies[i] = router.generate(prompts[i])
            except Exception as exc:  # reported below; any failure fails the run
                errors.append(repr(exc))

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if errors or any(r is None or len(r) != max_new_tokens for r in replies):
            raise AssertionError(f"rollout live traffic failed: {errors} {replies}")
        return live.stats().get("itl_ms", {}).get("p50")

    def controller():
        return RolloutController(router, EngineReplicaProvisioner(factory), vreg,
                                 policy=RolloutPolicy(), state_target=v1,
                                 registry=router._registry, flight=flight)

    def timed_eval(ctl):
        t0 = time.perf_counter()
        d = ctl.evaluate()
        return d, (time.perf_counter() - t0) * 1e3

    def start_and_join(ctl, vid):
        sync()
        t0 = time.perf_counter()
        ctl.start_rollout(vid, percent=0.0)
        sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
        d, join_ms = timed_eval(ctl)
        sync()
        if d["reason"] != "canary_ready":
            raise AssertionError(f"rollout of {vid}: the canary did not join: {d}")
        return {"restore_ms": restore_ms, "join_ms": join_ms, "warmed_blocks": d["warmed_blocks"]}

    def shadow_done(ctl, n):
        s = ctl.dashboard()["shadow"]
        return s["match"] + s["diverged"] + s["error"] + s["dropped"] >= n

    def first_diffs():
        return [e["first_diff"] for e in flight.dump(kind="rollout_shadow")]

    try:
        # no warm-up of kernels or buckets: the engine phases ran this config
        sync()
        for c in counters.values():
            c.launches = 0
        out["itl_p50_ms_without_shadow"] = traffic(fresh_prompts())
        wait_until(lambda: engine_at_rest(live), "r0 at rest after the baseline")

        # ---- v1b: the same bits republished must bake clean and promote
        ctl = controller()
        try:
            v1b = start_and_join(ctl, "v1b")
            v1b["itl_p50_ms_with_shadow"] = traffic(fresh_prompts())
            wait_until(lambda: shadow_done(ctl, requests), "v1b's shadows", timeout=600)
            v1b["shadow"] = {k: v for k, v in ctl.dashboard()["shadow"].items()
                             if k in ("match", "diverged", "error", "dropped")}
            v1b["first_diffs"] = first_diffs()
            decisions = []
            for _ in range(RolloutPolicy().bake_evals):
                decisions.append(ctl.evaluate())
            v1b["bake"] = [d["reason"] for d in decisions]
            if decisions[-1]["reason"] != "bake_complete" or v1b["shadow"]["diverged"]:
                raise AssertionError(f"v1b (v1's bits republished) did not bake clean: "
                                     f"{v1b['shadow']} first diverging steps "
                                     f"{v1b['first_diffs']} decisions {v1b['bake']}")
            d, v1b["promote_ms"] = timed_eval(ctl)
            if d["reason"] != "promote_replica" or r0.version != "v1b":
                raise AssertionError(f"v1b did not promote r0: {d}")
            d, v1b["reap_ms"] = timed_eval(ctl)
            d2 = ctl.evaluate()
            if (d["reason"], d2["reason"]) != ("reap_canary", "complete"):
                raise AssertionError(f"v1b's promotion did not complete: {d} {d2}")
            if router.live_version != "v1b" or set(router.members()) != {"r0"}:
                raise AssertionError(f"after v1b: live {router.live_version}, members "
                                     f"{router.members()}")
        finally:
            ctl.close()
        out["v1b"] = v1b
        if leaf_checksums(r0.params) != leaf_checksums(v1):
            raise AssertionError("r0's promoted v1b weights are not v1's bits")
        wait_until(lambda: engine_at_rest(live), "r0 at rest after v1b")

        # ---- v2: a reseeded block must roll back on its shadow diffs
        before = leaf_checksums(r0.params)
        mem_before = allocated()
        ctl = controller()
        try:
            v2r = start_and_join(ctl, "v2")
            prompts = fresh_prompts()
            box = {}
            th = threading.Thread(target=lambda: box.update(itl=traffic(prompts)))
            th.start()
            decision, seen, rollback_ms = None, 0, None
            deadline = time.monotonic() + 600
            while time.monotonic() < deadline:
                diverged = ctl.dashboard()["shadow"]["diverged"]
                if diverged > seen:
                    seen = diverged
                    decision, ms = timed_eval(ctl)
                    if decision["decision"] == "rollout_rollback":
                        rollback_ms = ms
                        break
                elif not th.is_alive() and shadow_done(ctl, requests):
                    break
                time.sleep(0.005)
            th.join(timeout=600)
            v2r["itl_p50_ms_with_shadow"] = box.get("itl")
            v2r["shadow"] = {k: v for k, v in ctl.dashboard()["shadow"].items()
                             if k in ("match", "diverged", "error", "dropped")}
            v2r["first_diffs"] = first_diffs()[len(v1b["first_diffs"]):]
            v2r["rollback_ms"] = rollback_ms
            if decision is None or (decision["decision"], decision["reason"]) != (
                    "rollout_rollback", "parity_regression"):
                raise AssertionError(f"v2 did not roll back as parity_regression: {decision} "
                                     f"{v2r['shadow']}")
        finally:
            ctl.close()
        del ctl
        wait_until(lambda: engine_at_rest(live), "r0 at rest after v2")
        v2r["r0_checksums_unchanged"] = leaf_checksums(r0.params) == before
        v2r["canaries_stopped"] = all(e._stop.is_set() for e in canaries)
        mem_after = allocated()
        v2r["allocated_before_gib"] = mem_before / 2**30
        v2r["allocated_after_gib"] = mem_after / 2**30
        if not v2r["canaries_stopped"]:
            raise AssertionError("a reaped or rolled-back canary's engine was not closed")
        if not v2r["r0_checksums_unchanged"]:
            raise AssertionError("v2's rollback touched r0's weights")
        if r0.version != "v1b" or router.live_version != "v1b" or set(router.members()) != {"r0"}:
            raise AssertionError(f"after v2's rollback: r0 {r0.version}, live "
                                 f"{router.live_version}, members {router.members()}")
        if on_card and mem_after > mem_before + (64 << 20):
            raise AssertionError(f"the v2 canary's device memory was not handed back: "
                                 f"{mem_before} -> {mem_after} bytes")
        out["v2"] = v2r
        sync()
        out["launches"] = {name: c.launches for name, c in counters.items()}
    finally:
        router.close()
        live.close()
        for e in canaries:
            e.close()
        vreg.close()
        tmp.cleanup()
    if on_card:
        for name, n in out["launches"].items():
            if n == 0:
                raise AssertionError(f"kernel {name} was never launched on the rollout path")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"rollout: v1b restore {v1b['restore_ms']:.1f} ms, join {v1b['join_ms']:.1f} ms "
        f"({v1b['warmed_blocks']} blocks warmed), shadows {v1b['shadow']}, promote "
        f"{v1b['promote_ms']:.1f} ms; v2 shadows {v2r['shadow']} (first diverging steps "
        f"{v2r['first_diffs']}), rollback {v2r['rollback_ms']:.1f} ms; r0 ITL p50 "
        f"{out['itl_p50_ms_without_shadow']} ms without shadowing, "
        f"{v1b['itl_p50_ms_with_shadow']} / {v2r['itl_p50_ms_with_shadow']} with; launches "
        f"{out['launches']}; phase {out['seconds']:.1f} s")
    return out


REMOTE_APP = '''"""The remote phase's app (written by chip_smoke.py): an MLP trained
with classification_step; its trainer stage asks for {chips} card(s)."""

import numpy as np
import torch

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.defaults import Resources
from unionml_tpu_torch.models import Mlp, MlpConfig, classification_step, create_train_state
from unionml_tpu_torch.models.train import TrainState

dataset = Dataset(name="smoke_remote_data", test_size=0.25)
model = Model(name="smoke_remote_model", dataset=dataset)
_module = Mlp(MlpConfig(num_classes=10, hidden_dims=(256, 256)))


@dataset.reader
def reader(n: int = 1024) -> dict:
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, 64)).astype(np.float32)
    return {{"features": x, "targets": x[:, :10].argmax(axis=1).astype(np.int64)}}


@dataset.splitter
def splitter(data: dict, test_size: float, shuffle: bool, random_state: int):
    k = int(len(data["features"]) * (1 - test_size))
    return (
        {{"features": data["features"][:k], "targets": data["targets"][:k]}},
        {{"features": data["features"][k:], "targets": data["targets"][k:]}},
    )


@dataset.parser
def parser(data: dict, features, targets):
    return (data["features"], data["targets"])


@model.init
def init(hyperparameters: dict) -> TrainState:
    device = resolve_device(hyperparameters.get("device", {device!r}))
    return create_train_state(_module, torch.zeros(1, 64, device=device),
                              learning_rate=hyperparameters.get("learning_rate", 1e-2))


@model.trainer(resources=Resources(cpu="4", mem="8Gi", chips={chips}))
def trainer(state: TrainState, features: np.ndarray, targets: np.ndarray,
            *, steps: int = 8, batch: int = 128) -> TrainState:
    step = classification_step(_module)
    device = state.params["head"]["kernel"].device
    x = torch.as_tensor(features, device=device)
    y = torch.as_tensor(targets, device=device)
    for i in range(steps):
        lo = i * batch % len(x)
        state, _ = step(state, (x[lo:lo + batch], y[lo:lo + batch]))
    return state


@model.predictor
def predictor(state: TrainState, features: np.ndarray) -> list:
    device = state.params["head"]["kernel"].device
    with torch.no_grad():
        logits = state.apply_fn(state.params, torch.as_tensor(np.asarray(features), device=device))
    return [int(i) for i in logits.argmax(dim=-1).tolist()]


@model.evaluator
def evaluator(state: TrainState, features: np.ndarray, targets: np.ndarray) -> float:
    return float((np.asarray(predictor(state, features)) == np.asarray(targets)).mean())
'''


def remote_phase(*, device: str = "cuda", steps: int = 8) -> dict:
    """The remote backend end to end: ``LocalBackend`` in a temporary root
    deploys an app that this phase writes into a temporary directory (an
    MLP trained with ``classification_step``; its trainer stage asks for
    one card), with an explicit ``app_version`` (no git); then
    ``remote_train(wait=False)``, ``remote_wait`` and ``remote_load``: the
    runner (``python -m unionml_tpu_torch.remote.runner``, a process of its
    own) trains ``steps`` steps on the card, and its log must name the
    card. The trained params must equal, bit for bit, the same steps run
    in this process; ``model.predict`` on the loaded artifact and
    ``ServingApp(remote=True)`` (which loads the newest version through the
    registry) must give the in-process model's predictions. ``device="cpu"``
    rehearses the phase with a host-only stage (``chips=0``)."""
    import importlib
    import tempfile

    from unionml_tpu_torch.models.train import tree_leaves
    from unionml_tpu_torch.serving.http import ServingApp

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_remote_")
    app_dir = Path(tmp.name) / "app"
    app_dir.mkdir()
    (app_dir / "smoke_remote_app.py").write_text(REMOTE_APP.format(
        chips=1 if on_card else 0, device=None if on_card else "cpu"))
    sys.path.insert(0, str(app_dir))
    saved_home = os.environ.get("UNIONML_TPU_HOME")
    os.environ["UNIONML_TPU_HOME"] = str(Path(tmp.name) / "backend")
    try:
        app = importlib.import_module("smoke_remote_app")
        model = app.model
        model.remote(project="chip-smoke")
        hp = {"learning_rate": 1e-2}
        t0 = time.perf_counter()
        version = model.remote_deploy(app_version="smoke-1")
        deploy_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        execution = model.remote_train(app_version=version, wait=False, hyperparameters=hp,
                                       trainer_kwargs={"steps": steps})
        execution = model.remote_wait(execution, timeout=300)
        train_s = time.perf_counter() - t0
        artifact = model.remote_load(execution)
        runner_log = (Path(execution.exec_dir) / "runner.log").read_text()
        want_line = (f"device cuda ({torch.cuda.get_device_name(0)})" if on_card
                     else "device cpu")
        if want_line not in runner_log:
            raise AssertionError(f"the runner's log does not name {want_line!r}:\n"
                                 f"{runner_log[-2000:]}")
        remote_state = artifact.model_object
        x = np.random.default_rng(5).normal(size=(16, 64)).astype(np.float32)
        remote_preds = model.predict(features=x)

        served = ServingApp(model, remote=True, app_version=version)
        model.artifact = None
        served.setup_model()
        served_preds = served.predict({"features": x.tolist()})

        local_state, _ = model.train(hyperparameters=hp, trainer_kwargs={"steps": steps})
        local_preds = model.predict(features=x)
        pairs = list(zip(tree_leaves(remote_state.params), tree_leaves(local_state.params)))
        bit_equal = all(a.device == b.device and torch.equal(a, b) for a, b in pairs)
        if not bit_equal:
            raise AssertionError("remote-trained params differ from the in-process run's")
        if remote_state.step != local_state.step or remote_state.step != steps:
            raise AssertionError(f"steps: remote {remote_state.step}, local {local_state.step}")
        if remote_preds != local_preds or served_preds != local_preds:
            raise AssertionError("remote predictions differ from the in-process model's")
        out = {"steps": steps, "leaves": len(pairs), "params_bit_equal": bit_equal,
               "device": str(tree_leaves(remote_state.params)[0].device),
               "deploy_ms": deploy_ms, "train_wait_s": train_s,
               "versions": model.remote_list_model_versions(),
               "runner_device_line": want_line}
    finally:
        sys.path.remove(str(app_dir))
        sys.modules.pop("smoke_remote_app", None)
        if saved_home is None:
            os.environ.pop("UNIONML_TPU_HOME", None)
        else:
            os.environ["UNIONML_TPU_HOME"] = saved_home
        tmp.cleanup()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"remote: deploy {deploy_ms:.1f} ms, train + wait {train_s:.1f} s ({steps} steps in the "
        f"runner on {out['device']}), {len(pairs)} param leaves bit-equal to the in-process run, "
        f"predictions equal (model.predict and ServingApp(remote=True)); phase "
        f"{out['seconds']:.1f} s")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # the serving phases' Llama-3-8B depth: half of its 32 layers keeps the
    # run within its time on a slow host (every width is the model's)
    parser.add_argument("--layers", type=int, default=16)
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

    from unionml_tpu_torch.data import native

    t_host = time.perf_counter()
    if native.get_library() is None:
        raise AssertionError("the C++ host loader (unionml_tpu_torch/data/_native/"
                             "hostloader.cpp) did not build")
    log(f"build: the host loader built in {time.perf_counter() - t_host:.2f} s "
        f"({native.library_path().name})")
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
    vit = vit_train_phase(vit_cfg, keep_state=True)
    inline_state = vit.pop("state")
    vit["agreement"] = vit_grad_agreement(vit_cfg)
    log(f"time: vit training done at {time.perf_counter() - t_run:.1f} s")
    vit["feed"] = vit_feed_phase(vit_cfg, vit, inline_state)
    del inline_state
    vit["elastic"] = vit_elastic_phase(vit_cfg)
    log(f"time: vit feed and checkpoints done at {time.perf_counter() - t_run:.1f} s")

    from unionml_tpu_torch.models import LlamaConfig

    llama_cfg = LlamaConfig.llama_lc()
    llama = lm_train_phase(llama_cfg)
    llama["agreement"] = lm_grad_agreement(llama_cfg)
    log(f"time: llama training done at {time.perf_counter() - t_run:.1f} s")

    qlora_cfg = qlora_config()
    qlora = qlora_train_phase(qlora_cfg)
    qlora["agreement"] = qlora_agreement(qlora_cfg)
    torch.cuda.empty_cache()   # the phase's base and states are gone: hand their blocks back
    log(f"time: qlora done at {time.perf_counter() - t_run:.1f} s")

    from unionml_tpu_torch.models import BertConfig

    t_phase = time.perf_counter()
    bert_cfg = BertConfig.base()
    bert = {impl: bert_finetune_phase(dataclasses.replace(bert_cfg, attn_impl=impl))
            for impl in ("xla", "fused")}
    bert["agreement"] = bert_grad_agreement(dataclasses.replace(bert_cfg, attn_impl="fused"))
    bert["agreement_flash"] = bert_grad_agreement(dataclasses.replace(bert_cfg,
                                                                      attn_impl="flash"))
    bert["mlm"] = bert_mlm_phase(dataclasses.replace(bert_cfg, attn_impl="fused"))
    bert["config"] = (f"BERT vocab {bert_cfg.vocab_size}, max_len {bert_cfg.max_len}, width "
                      f"{bert_cfg.hidden_dim}, {bert_cfg.num_layers} layers, "
                      f"{bert_cfg.num_heads} heads, mlp {bert_cfg.mlp_dim}, {bert_cfg.dtype} "
                      "compute, fp32 params and heads")
    bert["seconds"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    log(f"time: bert done at {time.perf_counter() - t_run:.1f} s (phase {bert['seconds']:.1f} s)")
    t_phase = time.perf_counter()
    basic_tpu = basic_tpu_phase()
    basic_tpu["seconds"] = time.perf_counter() - t_phase
    log(f"time: basic_tpu done at {time.perf_counter() - t_run:.1f} s (phase "
        f"{basic_tpu['seconds']:.1f} s)")
    sharded = sharded_phase(vit_cfg, llama_cfg)
    torch.cuda.empty_cache()
    log(f"time: sharded done at {time.perf_counter() - t_run:.1f} s (phase "
        f"{sharded['seconds']:.1f} s)")

    base = LlamaConfig.llama3_8b()
    served = serve_phase(dataclasses.replace(base, num_layers=args.layers),
                         args.max_new_tokens)
    log(f"time: serve done at {time.perf_counter() - t_run:.1f} s")
    config = serving_config(dataclasses.replace(base, num_layers=args.layers))
    model, params = build_template(config, ENGINE_NEW_TOKENS, ENGINE_BUCKETS, "cuda")
    engine = engine_phase(config, ENGINE_NEW_TOKENS, model=model, params=params)
    log(f"time: engine done at {time.perf_counter() - t_run:.1f} s")
    prefix = prefix_phase(config, ENGINE_NEW_TOKENS, model=model, params=params)
    prefix["int8_kv"] = prefix_kv_quant_check(config, params)
    log(f"time: prefix done at {time.perf_counter() - t_run:.1f} s")
    fleet = fleet_phase(config, params)
    torch.cuda.empty_cache()
    log(f"time: fleet done at {time.perf_counter() - t_run:.1f} s (phase "
        f"{fleet['seconds']:.1f} s)")
    int8_kv = kv_quant_phase(config, params, 16)
    log(f"time: int8 kv done at {time.perf_counter() - t_run:.1f} s")
    serverless = serverless_phase(config, params)
    log(f"time: serverless done at {time.perf_counter() - t_run:.1f} s")
    rollout = rollout_phase(config, params)
    del model, params
    torch.cuda.empty_cache()
    log(f"time: rollout done at {time.perf_counter() - t_run:.1f} s")
    remote = remote_phase()
    log(f"time: remote done at {time.perf_counter() - t_run:.1f} s")
    fp32 = fp32_parity_phase(base, 32)
    prefix["fp32"] = prefix_fp32_parity_phase(base, 32)
    log(f"time: fp32 parity done at {time.perf_counter() - t_run:.1f} s")

    from unionml_tpu_torch import ModelArtifact
    from unionml_tpu_torch.templates.llm_serving.app import build_model

    probe = Int4Probe()
    try:
        cfg4 = serving_config(dataclasses.replace(base, num_layers=args.layers, weight_bits=4,
                                                  int4_group=128))
        params4 = random_quantized_params(cfg4, 0)
        model4 = build_model(cfg4, name="chip_smoke_int4", max_new_tokens=INT4_ENGINE_NEW_TOKENS,
                             bucket_lens=ENGINE_BUCKETS)
        model4.artifact = ModelArtifact(params4)
        int4_engine = engine_phase(cfg4, INT4_ENGINE_NEW_TOKENS, model=model4, params=params4,
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
        "flash_bwd_delta": ("unionml_tpu_torch/csrc/flash_bwd.cu",
                            "unionml_tpu/ops/flash_attention.py:464"),
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
            "launches_per_qlora_step": qlora["launches_per_step"].get(name),
            "launches_per_bert_step": bert["fused"]["launches_per_step"].get(name),
            "launches_per_bert_mlm_step": bert["mlm"]["launches_per_unmasked_step"].get(name),
            "fleet_launches": fleet["launches"].get(name),
            "serverless_launches": serverless["launches"].get(name),
            "rollout_launches": rollout["launches"].get(name),
            "sharded_launches": sharded["vit"]["launches"].get(
                name, sharded["lm"]["launches"].get(name)),
            "shapes": cases, "launch_shape_checks": shape_checks.get(name),
        })
    print(json.dumps({"kernels": rows, "serve": served, "engine": engine, "prefix": prefix,
                      "fleet": fleet, "serverless": serverless, "rollout": rollout,
                      "remote": remote, "int8_kv": int8_kv,
                      "fp32_parity": fp32, "int4_engine": int4_engine, "spec": spec,
                      "int4_fp32_parity": int4_fp32, "spec_fp32_parity": spec_fp32,
                      "vit_train": vit, "llama_train": llama, "qlora_train": qlora,
                      "bert_train": bert, "basic_tpu": basic_tpu, "sharded": sharded,
                      "seconds": time.perf_counter() - t_run}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
