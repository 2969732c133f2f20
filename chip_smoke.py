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
             only; the port never calls it);
4. serve   — build the ported llm_serving template at Llama-3-8B width
             (int8 weights, padded flash prefill, fused RMSNorm; random
             weights from a seeded torch.Generator on the card), check its
             kernel path against the plain-PyTorch path on a small input,
             serve it through ServingApp(batch=True, row_lists=True) on a
             local port, POST ragged /predict requests (some concurrent),
             check every reply and /health, and check that both kernels
             launched during the requests;
5. report  — one JSON line of per-kernel numbers, the nvidia-smi line, and
             last the result line {"ok": true, "device": {...}}.

It needs the repository beside it and a CUDA device; it imports nothing of
JAX or of the unionml_tpu package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.request
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
LOGIT_COSINE_MIN = 0.99                   # 8B kernel path vs plain path, bf16 through every layer


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    import torch.nn.functional as F

    from unionml_tpu_torch.ops import fused_norm

    eps = 1e-5
    x = torch.randn(rows, d, device="cuda", generator=gen).bfloat16()
    g = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).bfloat16()
    got = fused_norm.rms_norm_cuda(x, g, eps)
    torch.cuda.synchronize()
    err = check_close(f"rms_norm rows={rows}", got, fused_norm.rms_norm_plain(x, g, eps), NORM_TOL)
    b_ms, b_by = bound(2 * rows * d * 2 + d * 2, 4 * rows * d, PEAK_FP32_OPS_S)
    return {
        "shape": f"x[{rows},{d}] bf16, g[{d}] bf16",
        "max_abs_err": err,
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
    torch.cuda.synchronize()
    want = fa.flash_fwd_padded_plain(q, k, v, pad, causal=True, scale=scale)
    err = check_close(f"flash B={b} S={s}", got, want, FLASH_TOL)
    for row, p in enumerate(pads):  # queries inside the padding return zeros
        if p and bool(got[row, :p].any()):
            raise AssertionError(f"flash: padded query rows of batch row {row} are not zero")
    # work this data needs: visible (q, kv) pairs under causal + left padding
    pairs = sum((s - p) * (s - p + 1) // 2 for p in pads)
    ops = 4 * pairs * h * d                       # QK^T and PV, 2 flops per MAC
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * b
    b_ms, b_by = bound(nbytes, ops, PEAK_BF16_OPS_S)
    vis = fa._visible(pad, s, s, True)[:, 0]       # [B, 1, Sq, Skv]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return {
        "shape": f"q[{b},{s},{h},{d}] kv[{b},{s},{kvh},{d}] bf16, pads {list(pads)}",
        "max_abs_err": err,
        "ms": time_ms(lambda: fa.flash_fwd_padded_cuda(q, k, v, pad, causal=True, scale=scale)),
        "plain_ms": time_ms(
            lambda: fa.flash_fwd_padded_plain(q, k, v, pad, causal=True, scale=scale), iters=3
        ),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis, enable_gqa=True)
        ),
    }


def kernel_phase(batch: int, bucket: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    norms = [norm_case(batch * bucket, 4096, gen), norm_case(batch, 4096, gen)]
    flashes = [
        flash_case(batch, bucket, 32, 8, 128, [0, 17, 333, bucket - 24][:batch], gen),
        flash_case(1, 4096, 32, 8, 128, [0], gen),
    ]
    for name, cases in (("rms_norm_fwd", norms), ("flash_fwd_padded", flashes)):
        for c in cases:
            log(f"kernel {name} {c['shape']}: max_abs_err {c['max_abs_err']} "
                f"ms {c['ms']} plain_ms {c['plain_ms']} bound_ms {c['bound_ms']} "
                f"({c['bound_by']}) library_ms {c['library_ms']}")
    return {"rms_norm_fwd": norms, "flash_fwd_padded": flashes}


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
    from unionml_tpu_torch.templates.llm_serving.app import build_model

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    config = dataclasses.replace(
        config, quantized=True, prefill_impl="flash", norm_impl="fused"
    )
    model = build_model(
        config, name="chip_smoke", max_new_tokens=max_new_tokens, bucket_lens=buckets
    )
    t0 = time.perf_counter()
    params, _ = model.train(hyperparameters={"seed": 0, "device": device})
    sync()
    log(f"serve: {config.num_layers}-layer int8 weights (hidden {config.hidden_dim}) "
        f"built on {device} in {time.perf_counter() - t0:.2f} s")

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

    from unionml_tpu_torch.models import LlamaConfig

    config = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=args.layers)
    served = serve_phase(config, args.max_new_tokens)

    replaces = {
        "rms_norm_fwd": ("unionml_tpu_torch/csrc/fused_norm.cu", "unionml_tpu/ops/fused_norm.py:72"),
        "flash_fwd_padded": ("unionml_tpu_torch/csrc/flash_attention.cu",
                             "unionml_tpu/ops/flash_attention.py:63"),
    }
    rows = []
    for name, cases in kernels.items():
        main_case = cases[0]
        rows.append({
            "name": name, "route": "cuda", "source": replaces[name][0],
            "replaces": replaces[name][1], "launches": served["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "shape": main_case["shape"],
            "shapes": cases,
        })
    print(json.dumps({"kernels": rows, "serve": served}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
