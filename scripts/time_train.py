#!/usr/bin/env python3
"""Time the ViT-B/16 and llama_lc training steps of one or more checkouts,
in turns, on one card.

    python3 scripts/time_train.py [ROOT ...]

For each checkout given (default: this one), in the order given, starts
one Python process in it that builds its kernels and runs its own
``chip_smoke.vit_train_phase`` (ViT-B/16 through the vision template's
``model.train``, batch 64, 54 steps, 2 warm-up) and
``chip_smoke.lm_train_phase`` (llama_lc, 2 x 4096 tokens, 54 steps), and
prints the checkout with both step ms (host clock between two waits for
the card over the timed steps). Pass a checkout more than once to
alternate (parent, tree, tree, parent): a host's speed moves these
host-bound steps, so only runs in one call compare. Prints the card's
name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CODE = r"""
import dataclasses, json, sys
sys.path.insert(0, ".")
import chip_smoke
from unionml_tpu_torch.ops import _build
from unionml_tpu_torch.models import LlamaConfig, ViTConfig

_build.build_all()
vit = chip_smoke.vit_train_phase(
    dataclasses.replace(ViTConfig.base16(num_classes=1000), norm_impl="fused"))
lm = chip_smoke.lm_train_phase(LlamaConfig.llama_lc())
print("RESULT " + json.dumps({"vit_step_ms": vit["step_ms"], "lm_step_ms": lm["step_ms"]}))
"""


def main() -> int:
    roots = [Path(r) for r in sys.argv[1:]] or [Path(__file__).resolve().parents[1]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(f"card: {card.stdout.strip()}", flush=True)
    failed = False
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", CODE], cwd=root, capture_output=True,
                              text=True)
        result = [line[len("RESULT "):] for line in proc.stdout.splitlines()
                  if line.startswith("RESULT ")]
        if proc.returncode or not result:
            failed = True
            print(f"{root}: failed (exit {proc.returncode})\n{proc.stderr[-4000:]}", flush=True)
            continue
        print(f"{root}: {json.loads(result[0])}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
