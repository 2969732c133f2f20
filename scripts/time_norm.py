#!/usr/bin/env python3
"""Time the norm kernels (rows 2-5) at their main-path shapes, on one card.

    python3 scripts/time_norm.py [--root DIR] [--out FILE]

Runs ``chip_smoke.norm_case`` for row 2 (RMSNorm, bf16 x and gamma) at
``x[4096, 4096]`` (the micro-batcher's 4 x 1024 prefill at Llama-3-8B
width) and ``x[16, 4096]`` (the 16-slot paged engine's decode step), then
``chip_smoke.vit_norm_cases`` at ``x[12608, 768]`` bf16 (ViT-B/16 at
batch 64, fp32 gamma / beta, the LayerNorm mode): the LayerNorm forward,
the add-LayerNorm forward and the norm backward. Each forward is held bit
for bit and row by row against its plain version, on random inputs and on
the statistics probe, against its planted faults, with a row's bits
independent of the call; the backward row by row and column by column,
against its planted faults, and run twice for the same bits. Each is
timed beside its bound and the library call. Prints the card's name and
power limit, then one line a case, then one JSON line of the cases. ``--root`` imports the package of another
checkout (its own kernels, built into its own ``build/``) under this
checkout's ``chip_smoke.vit_norm_cases``, so two trees can be compared in
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
        print("time_norm: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from unionml_tpu_torch.ops import _build

    print("card:", cs.card_line(), flush=True)
    print("root:", args.root.resolve(), flush=True)
    _build.build_all(["fused_norm"])
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = {"rms_norm_fwd": [cs.norm_case(rows, 4096, gen) for rows in (4096, 16)]}
    cases.update(cs.vit_norm_cases(cs.VIT_B * cs.VIT_S, cs.VIT_D, gen))
    for name, shapes in cases.items():
        for case in shapes:
            print(f"{name} {case['shape']}: ms {case['ms']} plain_ms {case['plain_ms']} "
                  f"bound_ms {case['bound_ms']} ({case['bound_by']}) library_ms "
                  f"{case['library_ms']} max_abs_err {case['max_abs_err']}", flush=True)
    line = json.dumps({"root": str(args.root.resolve()), "card": cs.card_line(), "cases": cases})
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
