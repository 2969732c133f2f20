#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one card.

    python3 scripts/profile_torch_serving.py [--layers 32] [--batch 4]
        [--bucket 1024] [--max-new-tokens 32]

Builds the ported llm_serving template at Llama-3-8B width (int8 weights,
padded flash prefill, fused RMSNorm; random weights from a seeded
generator on the card), warms it, then:

1. times one generate call split into prefill (max_new_tokens=1) and the
   whole call, with the host clock around ``torch.cuda.synchronize()``;
2. traces one whole call with ``torch.profiler`` (CPU + CUDA) and prints
   the device time by kernel name and the launches of the port's two
   kernels. The idle share is one minus the traced device-busy time over
   the UNTRACED call's wall time (host-side tracing stretches the traced
   call's own wall time several-fold).

Prints the card's name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--bucket", type=int, default=1024)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)

    from unionml_tpu_torch.models import Llama, LlamaConfig, make_lm_predictor
    from unionml_tpu_torch.ops import flash_attention as fa
    from unionml_tpu_torch.ops import fused_norm
    from unionml_tpu_torch.templates.llm_serving.app import build_model

    config = dataclasses.replace(
        LlamaConfig.llama3_8b(), num_layers=args.layers, quantized=True,
        prefill_impl="flash", norm_impl="fused",
    )
    model = build_model(config, name="profile", max_new_tokens=args.max_new_tokens,
                        bucket_lens=(args.bucket,))
    params, _ = model.train(hyperparameters={"seed": 0})
    module = Llama(config)
    full = make_lm_predictor(module, max_new_tokens=args.max_new_tokens,
                             bucket_lens=(args.bucket,))
    first = make_lm_predictor(module, max_new_tokens=1, bucket_lens=(args.bucket,))
    rng = np.random.default_rng(0)
    lengths = np.linspace(args.bucket // 8, args.bucket, args.batch).astype(int)
    prompts = [rng.integers(1, config.vocab_size, size=n).tolist() for n in lengths]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(params, prompts)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for fn in (first, full):
        timed(fn)  # warm: kernel build, allocator
    prefill_ms = min(timed(first) for _ in range(3))
    call_ms = min(timed(full) for _ in range(2))
    decode_steps = args.max_new_tokens - 1
    print(f"shape: batch {args.batch}, bucket {args.bucket}, prompt lengths "
          f"{lengths.tolist()}, {args.max_new_tokens} new tokens, {args.layers} layers")
    print(f"prefill_ms {prefill_ms} (prefill + first token)")
    print(f"call_ms {call_ms}; decode_ms_per_step {(call_ms - prefill_ms) / decode_steps}")

    from torch.profiler import ProfilerActivity, profile

    fused_norm.KERNEL.launches = 0
    fa.KERNEL.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        full(params, prompts)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    busy_ms = sum(getattr(e, attr) for e in events) / 1e3
    print(f"traced call: wall_ms {wall_ms}, device busy_ms {busy_ms}; "
          f"idle share of the untraced call {1 - busy_ms / call_ms}")
    print(f"launches: rms_norm_fwd {fused_norm.KERNEL.launches}, "
          f"flash_fwd_padded {fa.KERNEL.launches}")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:15]:
        ms = getattr(e, attr) / 1e3
        print(f"  {ms:10.3f} ms {100 * ms / busy_ms:6.2f}% x{e.count:<6d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
