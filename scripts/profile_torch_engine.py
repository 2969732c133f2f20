#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's paged decode engine, on one card.

    python3 scripts/profile_torch_engine.py [--layers 32] [--slots 16]
        [--max-new-tokens 64] [--chunk-steps 8] [--weight-bits 4 --int4-group 128]
        [--root DIR]

Builds the ported llm_serving template at Llama-3-8B width (int8 weights,
padded flash prefill, fused RMSNorm, paged decode attention; random
weights from a seeded generator on the card) behind a block-paged
``DecodeEngine`` with ``--slots`` slots, warms it, then:

1. submits one prompt per slot at once (ragged lengths up to 1000 tokens)
   and times the call with the host clock (the call returns once every
   token is harvested), twice; prints the engine's TTFT and inter-token
   latency, and the dispatcher's host time per decode chunk;
2. traces the same call with ``torch.profiler`` (CPU + CUDA) and prints
   the device time by kernel class (the port's kernels, GEMMs, the rest)
   and per decode step, by kernel name, and the launches of the port's
   three kernels. The idle share is one minus the traced device-busy time
   over the UNTRACED call's wall time.

``--weight-bits 4`` serves packed-int4 weights instead (``--int4-group``
0 for per-channel scales, 128 for the int4 paged engine of
``chip_smoke.py``; random packed weights made on the card by
``chip_smoke.random_quantized_params``), and the int4 kernel's device time
and launches are reported per decode step. ``--root`` imports the package
of another checkout (its own kernels, built into its own ``build/``), so
two trees can be profiled in one call.

Prints the card's name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# kernel-name fragments -> class, first match wins
CLASSES = (
    ("port: paged attention", ("paged_split_kernel", "paged_combine_kernel")),
    ("port: flash prefill", ("flash_fwd_kernel",)),
    ("port: fused norm", ("norm_fwd_kernel",)),
    ("port: int4 matmul", ("int4_",)),
    ("GEMM (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "gemv")),
    ("copy / cast", ("copy", "Memcpy", "Memset", "cat_", "CatArray")),
    ("elementwise", ("elementwise", "vectorized")),
    ("reduction / softmax", ("reduce_kernel", "softmax")),
)


def kernel_class(name: str) -> str:
    for label, keys in CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--chunk-steps", type=int, default=8)
    ap.add_argument("--weight-bits", type=int, choices=(4, 8), default=8)
    ap.add_argument("--int4-group", type=int, default=128)
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_engine: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)

    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.models import Llama, LlamaConfig
    from unionml_tpu_torch.ops import flash_attention as fa
    from unionml_tpu_torch.ops import fused_norm
    from unionml_tpu_torch.ops import int4_matmul as i4
    from unionml_tpu_torch.ops import paged_attention as pa
    from unionml_tpu_torch.serving import DecodeEngine
    from unionml_tpu_torch.templates.llm_serving.app import build_model

    print("root:", args.root.resolve(), flush=True)
    int4 = args.weight_bits == 4
    config = dataclasses.replace(
        LlamaConfig.llama3_8b(), num_layers=args.layers, quantized=True,
        prefill_impl="flash", norm_impl="fused", paged_impl="auto",
        weight_bits=args.weight_bits, int4_group=args.int4_group if int4 else 0,
    )
    buckets = (64, 256, 1024)
    if int4:
        params = cs.random_quantized_params(config, 0)
        int4_kernel = i4.KERNEL_GROUPED if config.int4_group else i4.KERNEL
    else:
        model = build_model(config, name="profile", max_new_tokens=args.max_new_tokens,
                            bucket_lens=buckets)
        params, _ = model.train(hyperparameters={"seed": 0})
    engine = DecodeEngine(
        Llama(config), paged=True, slots=args.slots, prompt_buckets=buckets,
        max_new_tokens=args.max_new_tokens, chunk_steps=args.chunk_steps,
        registry=telemetry.MetricsRegistry(), device="cuda",
    )
    rng = np.random.default_rng(0)
    lengths = np.linspace(5, 1000, args.slots).astype(int)
    prompts = [rng.integers(1, config.vocab_size, size=n).tolist() for n in lengths]
    try:
        engine.warmup(params)
        engine.generate(params, prompts)

        def timed():
            engine.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(params, prompts)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        calls = [timed(), timed()]
        stats = engine.stats()
        print(f"shape: {args.slots} prompts of {lengths.tolist()} tokens at once, "
              f"{args.max_new_tokens} new tokens, {args.layers} layers, chunk_steps "
              f"{args.chunk_steps}")
        print(f"call_ms {calls}")
        print(f"ttft_ms {stats['ttft_ms']}")
        print(f"itl_ms {stats.get('itl_ms')}")
        print(f"dispatch_ms_per_chunk {engine._h_dispatch.summary()}; decode_steps "
              f"{stats['decode_steps']}")

        from torch.profiler import ProfilerActivity, profile

        for k in (pa.KERNEL, fa.KERNEL, fused_norm.KERNEL, i4.KERNEL, i4.KERNEL_GROUPED):
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.generate(params, prompts)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        engine.close()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    busy_ms = sum(getattr(e, attr) for e in events) / 1e3
    call_ms = min(calls)
    print(f"traced call: wall_ms {wall_ms}, device busy_ms {busy_ms}; "
          f"idle share of the untraced call {1 - busy_ms / call_ms}")
    print(f"launches: paged_attention {pa.KERNEL.launches}, flash_fwd_padded "
          f"{fa.KERNEL.launches}, rms_norm_fwd {fused_norm.KERNEL.launches}"
          + (f", int4 matmul {int4_kernel.launches}" if int4 else ""))
    # each decode step launches the paged kernel once per layer
    steps = max(1, pa.KERNEL.launches // args.layers)
    if int4:
        print(f"int4 matmul launches per decode step {int4_kernel.launches / steps} "
              f"(prefill projections of 64 rows or fewer included)")
    by_class = {}
    for e in events:
        label = kernel_class(e.key)
        by_class[label] = by_class.get(label, 0.0) + getattr(e, attr) / 1e3
    for label, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  class {label:24s} {ms:10.3f} ms {100 * ms / busy_ms:6.2f}% "
              f"{ms / steps:8.3f} ms per decode step ({steps} steps)")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:15]:
        ms = getattr(e, attr) / 1e3
        print(f"  {ms:10.3f} ms {100 * ms / busy_ms:6.2f}% x{e.count:<6d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
