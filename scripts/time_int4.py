#!/usr/bin/env python3
"""Time the int4 kernels (rows 7 and 8) at the main paths' shapes, on one card.

    python3 scripts/time_int4.py [--root DIR] [--out FILE]

Runs ``chip_smoke.int4_case`` at every shape ``chip_smoke.py`` times: the
per-channel kernel at the speculative verify's 40 rows (q/o, k/v, gate/up,
down of Llama-3-8B in bf16, the fp32 LM head) and the grouped kernel at
the int4 paged engine's 16 rows (g=128). Each case holds the kernel
against its plain version and times it warm (20 back-to-back calls on one
weight) and cold (rotating over copies of the weight that together exceed
twice the L2), beside the library call. Prints the card's name and power
limit, then one JSON line of the cases. ``--root`` imports the package of
another checkout (its own kernels, built into its own ``build/``) under
this checkout's ``chip_smoke.int4_case``, so two trees can be compared in
one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON line here")
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
        ("gate/up g128", 16, 4096, 14336, 128, bf16), ("down g128", 16, 14336, 4096, 128, bf16),
        ("lm_head g128", 16, 4096, 128256, 128, fp32),
    ]
    cases = []
    for name, rows, k, n, group, dtype in shapes:
        case = {"name": name, **cs.int4_case(rows, k, n, group, dtype, gen)}
        cases.append(case)
        print(f"{name} {case['shape']}: ms {case['ms']} ms_cold {case['ms_cold']} "
              f"library_ms {case['library_ms']} library_ms_cold {case['library_ms_cold']} "
              f"bound_ms {case['bound_ms']} ({case['bound_by']})", flush=True)
    line = json.dumps({"root": str(args.root.resolve()), "card": cs.card_line(), "cases": cases})
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
