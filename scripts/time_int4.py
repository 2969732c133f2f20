#!/usr/bin/env python3
"""Time the int4 kernels (rows 7 and 8) at the main paths' shapes, on one card.

    python3 scripts/time_int4.py [--root DIR] [--out FILE]

Runs ``chip_smoke.int4_case`` at every shape ``chip_smoke.py`` times: the
per-channel kernel at the speculative verify's 40 rows (q/o, k/v, gate/up,
down of Llama-3-8B in bf16, the fp32 LM head) and the grouped kernel at
the int4 paged engine's 16 rows (g=128: q/o, k/v, gate/up, down, the fp32
LM head at 16 and 4 rows). Each case holds the kernel against its plain
version (bf16 also bit for bit) and times it warm (20 back-to-back calls
on one weight) and cold (rotating over copies of the weight that together
exceed twice the L2), beside the library call; ``host_us`` is the host
time of one ``int4_matmul_cuda`` call while the card is kept busy (the
launch cost an engine's dispatcher pays; the least of 20 runs). Then the
grouped rounding probe (``chip_smoke.int4_rounding_probe``, bf16 at q/o
and the fp32 LM head): the share of outputs the kernel and the FMA fault
put apart from the plain version (0 for the kernel when it multiplies,
then adds). Prints the card's name and power limit, then one JSON line of
the cases. ``--root`` imports the package of another checkout (its own
kernels, built into its own ``build/``) under this checkout's
``chip_smoke``, so two trees can be compared in one call; ``--grouped``
times the grouped shapes only. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch


def host_us(fn, calls: int = 100, reps: int = 20) -> float:
    """Host microseconds per call of ``fn`` with a spin kernel queued ahead
    of the calls (about 50 ms on an H100), so that no call waits for the
    card; the least of ``reps`` runs of ``calls`` calls (the run that other
    work on the host's cores disturbed least)."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(runs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON line here")
    ap.add_argument("--grouped", action="store_true", help="the grouped (g=128) shapes only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_int4: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from unionml_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # the fp32 yardstick in full fp32
    print("card:", cs.card_line(), flush=True)
    print("root:", args.root.resolve(), flush=True)
    _build.build_all(["int4_matmul"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, fp32 = torch.bfloat16, torch.float32
    shapes = [
        ("q/o", 40, 4096, 4096, 0, bf16), ("k/v", 40, 4096, 1024, 0, bf16),
        ("gate/up", 40, 4096, 14336, 0, bf16), ("down", 40, 14336, 4096, 0, bf16),
        ("lm_head", 40, 4096, 128256, 0, fp32),
    ] * (not args.grouped) + [
        ("q/o g128", 16, 4096, 4096, 128, bf16), ("k/v g128", 16, 4096, 1024, 128, bf16),
        ("gate/up g128", 16, 4096, 14336, 128, bf16), ("down g128", 16, 14336, 4096, 128, bf16),
        ("lm_head g128", 16, 4096, 128256, 128, fp32), ("lm_head g128 4 rows", 4, 4096, 128256,
                                                        128, fp32),
    ]
    from unionml_tpu_torch.ops import int4_matmul as i4

    cases = []
    for name, rows, k, n, group, dtype in shapes:
        case = {"name": name, **cs.int4_case(rows, k, n, group, dtype, gen)}
        tile = i4.tile_for(n, k)
        packed, scale = cs.random_int4_weight(k, n, group, gen)
        x = torch.randn(rows, k, device="cuda", generator=gen).to(dtype)
        case["host_us"] = host_us(
            lambda: i4.int4_matmul_cuda(x, packed, scale, tile_n=tile, group_size=group))
        del packed, scale, x
        cases.append(case)
        print(f"{name} {case['shape']}: ms {case['ms']} ms_cold {case['ms_cold']} "
              f"library_ms {case['library_ms']} library_ms_cold {case['library_ms_cold']} "
              f"bound_ms {case['bound_ms']} ({case['bound_by']}) plain_ms {case['plain_ms']} "
              f"host_us {case['host_us']} max_abs_err {case['max_abs_err']} mismatch "
              f"{case.get('mismatch')}", flush=True)
    for rows, k, n, tile, dtype in ((16, 4096, 4096, 512, bf16), (16, 4096, 128256, 256, fp32)):
        x, packed, scale, want, fma = cs.int4_rounding_probe(rows, k, n, tile, 128, dtype, gen)
        got = i4.int4_matmul_cuda(x, packed, scale, tile_n=tile, group_size=128)
        probe = {"name": f"rounding probe g128 x[{rows},{k}] {str(dtype).split('.')[-1]} N={n}",
                 "mismatch": cs.rounding_mismatch(got, want),
                 "fma_fault_mismatch": cs.rounding_mismatch(fma, want)}
        del x, packed, scale, want, fma, got
        cases.append(probe)
        print(probe, flush=True)
    line = json.dumps({"root": str(args.root.resolve()), "card": cs.card_line(), "cases": cases})
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
