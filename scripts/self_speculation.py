#!/usr/bin/env python3
"""Self-speculation acceptance of the port's speculative engine, on one card.

    python3 scripts/self_speculation.py [--layers 32] [--seeds 1 2 3] [--root DIR]

Builds the int4 Llama-3-8B target of ``chip_smoke.py``'s speculative phase
(per-channel packed int4, fused RMSNorm, flash prefill; random weights made
on the card from each seed) and serves two groups of four prompts through
``DecodeEngine(draft_module=Llama(target), speculate_k=4, slots=8)`` with
the draft's weights equal to the target's. Every proposal should then be
accepted: a rate below 1 means the draft's one-token decode steps and the
target's multi-token verify gave a row different bits. Prints the card's
name and power limit, then one line per seed with the two groups' rates.
``--root`` imports the package and ``chip_smoke.py`` of another checkout
(to compare two trees in one call). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("self_speculation: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke as cs
    from unionml_tpu_torch.models import LlamaConfig

    print("card:", cs.card_line(), flush=True)
    print("root:", args.root.resolve(), flush=True)
    base = LlamaConfig.llama3_8b()
    cfg = cs.serving_config(dataclasses.replace(base, num_layers=args.layers, weight_bits=4))
    rng = np.random.default_rng(13)   # chip_smoke.spec_phase's prompts
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (5, 200, 37, 120, 64, 12, 180, 90)]
    kw = dict(speculate_k=4, slots=8, prompt_buckets=(64, 256), max_new_tokens=32,
              chunk_steps=4)
    for seed in args.seeds:
        params = cs.random_quantized_params(cfg, seed)
        engine = cs._spec_engine(cfg, None, "cuda", **kw)
        rates = []
        try:
            for group in (prompts[:4], prompts[4:]):
                engine.reset_stats()
                engine.generate({"target": params, "draft": params}, group)
                rates.append(engine.stats()["speculative"]["acceptance_rate"])
        finally:
            engine.close()
        print(f"seed {seed}: self-speculation acceptance {rates[0]} (prompts 1-4) "
              f"{rates[1]} (prompts 5-8)", flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
