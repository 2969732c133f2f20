"""Serving-mode auto-selection: encode the engine-vs-batcher crossover
instead of making the operator guess it.

The full-batch micro-batcher wins closed-loop p50 when the host↔device
round trip dominates a decode chunk (the engine pays per-chunk
dispatch/harvest interactions that the monolithic generate amortizes);
the continuous-batching engine wins the tail — and open-loop traffic —
once a decode chunk costs at least a round trip, because late arrivals
join at chunk boundaries instead of waiting out a whole in-flight
generation. The crossover is therefore ``decode_chunk_ms >= rtt_ms``:
when the device does a round-trip's worth of work per chunk, chunk
pipelining is free and the join granularity pays for itself.

:func:`choose_serving_mode` measures both sides at warmup (a few
host → device → host round trips + two short generates through
:func:`~unionml_tpu_torch.models.generate.make_generator`) on an explicit
device (``None`` = the CUDA card, as every entry point of the port) and
returns the decision with its evidence — surfaced in ``/stats`` by the
serving benches so an operator can audit the choice.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from unionml_tpu_torch._device import DeviceLike, resolve_device

__all__ = [
    "choose_serving_mode",
    "decide_mode",
    "measure_decode_chunk_ms",
    "measure_rtt_ms",
]


def decide_mode(*, rtt_ms: float, decode_chunk_ms: float) -> str:
    """The pure decision rule (unit-tested both ways): ``"engine"`` when
    one decode chunk costs at least one host↔device round trip, else
    ``"batcher"``."""
    if rtt_ms < 0 or decode_chunk_ms < 0:
        raise ValueError(
            f"timings must be non-negative (rtt={rtt_ms}, "
            f"chunk={decode_chunk_ms})"
        )
    return "engine" if decode_chunk_ms >= rtt_ms else "batcher"


def measure_rtt_ms(reps: int = 10, *, device: DeviceLike = None) -> float:
    """Median host→device→host round trip of a one-element tensor on
    ``device`` (``None`` = the CUDA card) — the per-interaction cost the
    engine pays per chunk. The copy back to the host waits for the copy
    out."""
    import numpy as np
    import torch

    dev = resolve_device(device)
    times = []
    for i in range(max(3, reps)):
        t0 = time.perf_counter()
        arr = torch.tensor([i], dtype=torch.int32).to(dev)
        arr.cpu()  # blocks on the readback
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


def measure_decode_chunk_ms(
    module: Any,
    params: Any,
    *,
    chunk_steps: int = 8,
    prompt_len: int = 16,
    reps: int = 3,
    device: DeviceLike = None,
) -> float:
    """One decode chunk's time: generate ``chunk_steps + 1`` tokens and
    ``1`` token from the same short prompt on ``device`` (``None`` = the
    CUDA card; ``params`` must live there); the difference isolates
    ``chunk_steps`` decode steps from prefill + dispatch. Each generator
    runs once untimed first — run at warmup, not per request."""
    import torch

    from unionml_tpu_torch.models.generate import make_generator

    dev = resolve_device(device)
    max_len = prompt_len + chunk_steps + 1
    prompt = torch.ones((1, prompt_len), dtype=torch.long, device=dev)

    def best_of(gen):
        gen(params, prompt).cpu()  # warm-up
        best = float("inf")
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            gen(params, prompt).cpu()  # the copy back waits for the tokens
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    long_ms = best_of(
        make_generator(module, max_new_tokens=chunk_steps + 1, max_len=max_len)
    )
    short_ms = best_of(
        make_generator(module, max_new_tokens=1, max_len=max_len)
    )
    return max(0.0, long_ms - short_ms)


def choose_serving_mode(
    module: Any = None,
    params: Any = None,
    *,
    chunk_steps: int = 8,
    rtt_ms: Optional[float] = None,
    decode_chunk_ms: Optional[float] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Measure (or accept) both timings and pick the serving mode.

    Returns ``{"mode", "rtt_ms", "decode_chunk_ms", "rule"}`` — pass the
    dict into the serving stats so ``/stats`` records why this mode is
    running. Provide ``module``+``params`` to measure on ``device``
    (``None`` = the CUDA card), or inject both timings directly (tests,
    pre-measured deployments).
    """
    if rtt_ms is None:
        rtt_ms = measure_rtt_ms(device=device)
    if decode_chunk_ms is None:
        if module is None or params is None:
            raise ValueError(
                "either pass decode_chunk_ms or module+params to measure it"
            )
        decode_chunk_ms = measure_decode_chunk_ms(
            module, params, chunk_steps=chunk_steps, device=device
        )
    return {
        "mode": decide_mode(rtt_ms=rtt_ms, decode_chunk_ms=decode_chunk_ms),
        "rtt_ms": round(rtt_ms, 2),
        "decode_chunk_ms": round(decode_chunk_ms, 2),
        "rule": "engine iff decode_chunk_ms >= rtt_ms",
    }
