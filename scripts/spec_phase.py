#!/usr/bin/env python3
"""One speculative-engine phase of chip_smoke.py, on one card.

    python3 scripts/spec_phase.py [--root DIR]

Runs ``chip_smoke.spec_phase`` once: the int4 Llama-3-8B target (32
layers, per-channel packed int4, seeded random weights made on the card)
with the 0.3B int8 draft, k = 4, 8 slots, behind ``ServingApp(batch=False)``,
the verify's int4 launches recorded by ``chip_smoke.Int4Probe``. Prints
one line, ``AB <root name> {json}``, with the phase's ITL p50, tokens/s,
self-speculation acceptance and TTFT p50. ``--root`` imports the package
and ``chip_smoke.py`` of another checkout, so runs of two trees can be
alternated in one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spec_phase: needs a CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from unionml_tpu_torch.models import LlamaConfig
    from unionml_tpu_torch.ops import _build

    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    base = LlamaConfig.llama3_8b()
    target_cfg = cs.serving_config(dataclasses.replace(base, weight_bits=4))
    draft_cfg = cs.serving_config(dataclasses.replace(base, **cs.DRAFT_WIDTHS))
    probe = cs.Int4Probe()
    try:
        out = cs.spec_phase(target_cfg, cs.random_quantized_params(target_cfg, 1), draft_cfg,
                            cs.random_quantized_params(draft_cfg, 2), 32, probe=probe)
    finally:
        probe.close()
    keys = ("itl_ms_p50", "tokens_per_s", "self_acceptance_rate", "ttft_ms_p50")
    print("AB", root.name, json.dumps({k: out.get(k) for k in keys}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
