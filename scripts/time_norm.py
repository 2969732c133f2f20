#!/usr/bin/env python3
"""Time the ViT norm kernels (rows 3, 4 and 5) at ViT-B/16's shape, on one card.

    python3 scripts/time_norm.py [--root DIR] [--out FILE]

Runs ``chip_smoke.vit_norm_cases`` at ``x[12608, 768]`` bf16 (ViT-B/16 at
batch 64, fp32 gamma / beta, the LayerNorm mode): the LayerNorm forward,
the add-LayerNorm forward and the norm backward, each held against its
plain version (the backward row by row and column by column, against its
two planted faults, and run twice for the same bits) and timed beside its
bound and the library call. Prints the card's name and power limit, then
one JSON line of the cases. ``--root`` imports the package of another
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
    cases = cs.vit_norm_cases(cs.VIT_B * cs.VIT_S, cs.VIT_D, gen)
    for name, (case,) in cases.items():
        print(f"{name} {case['shape']}: ms {case['ms']} plain_ms {case['plain_ms']} bound_ms "
              f"{case['bound_ms']} ({case['bound_by']}) library_ms {case['library_ms']} "
              f"max_abs_err {case['max_abs_err']}", flush=True)
    line = json.dumps({"root": str(args.root.resolve()), "card": cs.card_line(), "cases": cases})
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
