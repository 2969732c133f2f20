#!/usr/bin/env python3
"""Where a threaded-feed training run's wall time escapes the goodput
buckets, on one card.

    python3 scripts/goodput_gaps.py [--runs 3] [--burners 0] [--urandom-ids]
                                    [--device cuda]

Trains ViT-B/16 as ``chip_smoke.py``'s phase 3d does (the vision
template's ``model.train`` with ``train_step(double_buffer=True,
goodput=tracker)``, batch 64, 54 steps) ``--runs`` times after one inline
run that warms the kernels, and prints one JSON line a run: the tracker's
``attributed_fraction`` and ``unattributed_s``, the wall time from
``start()`` to the first phase (``head_s``) and from the last phase to
``finish()`` (``tail_s``), the main thread's gaps between two phases
(count, seconds, the largest, how many over 1 ms) by the pair of phases
they separate, and the seconds the tracker spends in its own phase-end
bookkeeping (``end_phase``), which falls in those gaps.

``--urandom-ids`` runs each run twice, first with the trace's span ids
drawn by ``os.urandom`` (a system call) and then with the telemetry
module's own ids, so the two compare within one call. ``--burners N``
runs N busy-looping processes beside the runs (a loaded host).
``--device cpu`` rehearses the script at ViT-tiny size. Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _instrument(events: list, spent: dict) -> None:
    """Record every phase's enter / exit on the tracker's clock, and the
    main thread's time inside ``GoodputTracker._end_phase``."""
    from unionml_tpu_torch import goodput

    scope = goodput._PhaseScope
    enter, exit_ = scope.__enter__, scope.__exit__

    def timed_enter(self):
        out = enter(self)
        events.append(("enter", self._name, self._t0, threading.get_ident()))
        return out

    def timed_exit(self, *exc):
        events.append(("exit", self._name, time.perf_counter(), threading.get_ident()))
        return exit_(self, *exc)

    end_phase = goodput.GoodputTracker._end_phase

    def timed_end_phase(self, *args):
        t = time.perf_counter()
        try:
            return end_phase(self, *args)
        finally:
            if threading.current_thread() is threading.main_thread():
                dt = time.perf_counter() - t
                spent["n"] += 1
                spent["s"] += dt
                spent["max"] = max(spent["max"], dt)

    scope.__enter__, scope.__exit__ = timed_enter, timed_exit
    goodput.GoodputTracker._end_phase = timed_end_phase


def _run(label: str, config, kwargs: dict, events: list, spent: dict) -> dict:
    import chip_smoke
    from unionml_tpu_torch import goodput, telemetry

    events.clear()
    spent.update(n=0, s=0.0, max=0.0)
    tracker = goodput.GoodputTracker(registry=telemetry.MetricsRegistry())
    run = chip_smoke.vit_train_phase(
        config, train_step_options={"double_buffer": True, "goodput": tracker},
        name="goodput_gaps", **kwargs)
    report = tracker.report()
    main = threading.main_thread().ident
    mine = [e for e in events if e[3] == main]
    gaps: dict = {}
    for a, b in zip(mine, mine[1:]):
        if a[0] == "exit" and b[0] == "enter":
            gap = gaps.setdefault(f"{a[1]}->{b[1]}", {"n": 0, "s": 0.0, "max_s": 0.0,
                                                     "over_1ms": 0})
            dt = b[2] - a[2]
            gap["n"] += 1
            gap["s"] += dt
            gap["max_s"] = max(gap["max_s"], dt)
            gap["over_1ms"] += dt > 1e-3
    return {
        "run": label, "step_ms": run["step_ms"], "wall_s": report["wall_s"],
        "attributed_fraction": report["attributed_fraction"],
        "unattributed_s": report["unattributed_s"], "buckets_s": report["buckets_s"],
        "head_s": mine[0][2] - tracker._t_start, "tail_s": tracker._t_stop - mine[-1][2],
        "gaps": gaps, "end_phase": dict(spent),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--burners", type=int, default=0)
    parser.add_argument("--urandom-ids", action="store_true")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.models import ViTConfig

    if args.device == "cuda":
        from unionml_tpu_torch.ops import _build

        print(f"card: {chip_smoke.card_line()}", flush=True)
        _build.build_all()
        config = dataclasses.replace(ViTConfig.base16(num_classes=1000), norm_impl="fused")
        kwargs: dict = {}
    else:
        config = dataclasses.replace(ViTConfig.tiny(num_classes=10), norm_impl="fused")
        kwargs = {"device": "cpu", "batch": 8, "batches_per_epoch": 4, "epochs": 2}
    inline = chip_smoke.vit_train_phase(config, **kwargs)
    print(json.dumps({"run": "inline warm-up", "step_ms": inline["step_ms"]}), flush=True)

    events: list = []
    spent: dict = {}
    _instrument(events, spent)
    own_ids = telemetry.new_span_id
    burners = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
               for _ in range(args.burners)]
    try:
        for r in range(args.runs):
            sources = (("urandom", lambda: uuid.uuid4().hex[:16]), ("own", own_ids)) \
                if args.urandom_ids else (("own", own_ids),)
            for name, ids in sources:
                telemetry.new_span_id = ids
                try:
                    out = _run(f"{r} ids={name} burners={args.burners}", config, kwargs,
                               events, spent)
                finally:
                    telemetry.new_span_id = own_ids
                print(json.dumps(out), flush=True)
    finally:
        for p in burners:
            p.kill()
        for p in burners:
            p.wait(timeout=30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
