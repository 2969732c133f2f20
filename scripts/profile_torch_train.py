#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on one card.

    python3 scripts/profile_torch_train.py [--model vit_b16] [--layers 12]
        [--batch 64] [--steps 10] [--impl fused]
    python3 scripts/profile_torch_train.py --model llama_lc [--batch 2]

``--model vit_b16`` (the default) builds ViT-B/16 (``ViTConfig.base16``,
bf16 compute, fp32 params; with ``--impl fused`` the fused attention and
fused LayerNorm kernels, with ``--impl xla`` the plain PyTorch path) and
the step the vision_tpu template trains with (``classification_step``:
softmax cross entropy, autograd, AdamW at lr 3e-4). ``--model llama_lc``
builds ``LlamaConfig.llama_lc()`` (the long-context Llama of
``benchmarks/train_throughput.py``: 12 x 768, flash attention; ``--impl
xla`` for the plain attention) and ``lm_step`` over one resident batch of
``--batch`` random sequences of 4096 tokens (AdamW at lr 1e-3).
Weights are random, from a seeded generator on the card. Then:

1. runs 3 warm-up steps, then ``--steps`` steps between two waits for the
   card, and prints the step time, samples/s (ViT) or tokens/s (Llama)
   and the peak memory (host clock);
2. traces 5 more steps with ``torch.profiler`` (CPU + CUDA) and prints the
   device time per step by kernel class (GEMMs, the port's kernels,
   elementwise, reductions, the optimizer's multi-tensor passes, copies)
   and the 20 kernels with the most device time. The idle share is one
   minus the traced device-busy time per step over the UNTRACED step time.

Prints the card's name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# kernel-name fragments -> class, first match wins
CLASSES = (
    ("port: fused attention fwd", ("fused_fwd_kernel", "fused_fwd_resident_kernel")),
    ("port: fused attention bwd", ("fused_bwd_dq_kernel", "fused_bwd_dkv_kernel")),
    ("port: flash attention fwd", ("flash_fwd_kernel",)),
    ("port: flash attention dq", ("flash_dq_kernel",)),
    ("port: flash attention dk/dv", ("flash_dkv_kernel",)),
    ("port: fused norm", ("norm_fwd_kernel", "norm_bwd_kernel", "norm_bwd_sum_kernel")),
    ("GEMM fp32 (cuBLAS, no TF32)", ("sgemm", "f32f32_f32f32", "gemmSN", "gemv2T")),
    ("GEMM (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet", "sm90_")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel",)),
    ("copy / cast", ("copy", "Memcpy", "Memset", "cat_", "CatArray")),
    ("elementwise", ("elementwise", "gelu", "GeluCUDA", "vectorized")),
    ("softmax / cross entropy", ("softmax", "nll_loss", "log_softmax")),
)


def kernel_class(name: str) -> str:
    for label, keys in CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("vit_b16", "llama_lc"), default="vit_b16")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=None,
                    help="64 images for vit_b16, 2 sequences for llama_lc")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--impl", choices=("fused", "xla"), default="fused",
                    help="the port's kernels (fused; flash attention for llama_lc) or plain")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)

    from unionml_tpu_torch.models import TrainState, adamw

    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.model == "vit_b16":
        from unionml_tpu_torch.models import ViT, ViTConfig, classification_step
        from unionml_tpu_torch.models import init_vit_params

        batch_size = args.batch or 64
        config = dataclasses.replace(ViTConfig.base16(num_classes=1000), num_layers=args.layers,
                                     attn_impl=args.impl, norm_impl=args.impl)
        module = ViT(config)
        state = TrainState.create(apply_fn=module,
                                  params=init_vit_params(config, generator=gen, device="cuda"),
                                  tx=adamw(3e-4, weight_decay=1e-4))
        step = classification_step(module)
        rng = np.random.default_rng(0)
        size = config.image_size
        images = torch.from_numpy(
            rng.normal(size=(batch_size, size, size, 3)).astype(np.float32)).cuda()
        batch = (images, (images.mean(dim=(1, 2, 3)) > 0).long())
        shape = f"ViT-B/16 {args.layers} layers, batch {batch_size}, impl {args.impl}"
        unit, per_step = "samples", batch_size
    else:
        from unionml_tpu_torch.models import Llama, LlamaConfig, init_params, lm_step

        batch_size = args.batch or 2
        config = LlamaConfig.llama_lc(num_layers=args.layers,
                                      attn_impl="flash" if args.impl == "fused" else "xla")
        module = Llama(config)
        state = TrainState.create(apply_fn=module,
                                  params=init_params(config, seed=0, device="cuda"),
                                  tx=adamw(1e-3))
        step = lm_step(module)
        batch = torch.randint(0, config.vocab_size, (batch_size, 4096), generator=gen,
                              device="cuda")
        shape = (f"llama_lc {args.layers} layers, batch {batch_size} x 4096 tokens, attn "
                 f"{config.attn_impl}")
        unit, per_step = "tokens", batch_size * 4095

    for _ in range(3):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    print(f"shape: {shape}")
    print(f"step_ms {step_ms} {unit}_per_s {per_step / step_ms * 1e3} "
          f"loss {float(metrics['loss'])} peak_mem_gib "
          f"{torch.cuda.max_memory_allocated() / 2**30}")

    from torch.profiler import ProfilerActivity, profile

    traced = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    busy_ms = sum(getattr(e, attr) for e in events) / 1e3 / traced
    print(f"device busy_ms per step {busy_ms}; idle share of the untraced step "
          f"{1 - busy_ms / step_ms}")
    by_class = collections.Counter()
    for e in events:
        by_class[kernel_class(e.key)] += getattr(e, attr) / 1e3 / traced
    for label, ms in by_class.most_common():
        print(f"  class {label:28s} {ms:9.3f} ms/step {100 * ms / busy_ms:6.2f}%")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:20]:
        ms = getattr(e, attr) / 1e3 / traced
        print(f"  {ms:9.3f} ms/step {100 * ms / busy_ms:6.2f}% x{e.count // traced:<5d} "
              f"[{kernel_class(e.key)}] {e.key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
