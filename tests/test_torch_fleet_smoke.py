"""A CPU rehearsal of chip_smoke.py's fleet phase at the tiny geometry
(the kernels' plain versions), as the script drives it on the card: two
paged engines sharing one weight tree behind a FleetRouter with a
SloWatchdog per replica (locality routing and the prefill tokens it
saves), the HTTP front door over an HttpReplica with OTLP export, a
mid-stream kill with failover and half-open rejoin, a concurrent burst,
the autoscaler's warm join and scale-in, disaggregated prefill / decode
with its bit checks, the fp32 disaggregation against a colocated engine
token for token, and the serving-mode choice."""

import sys
from pathlib import Path

from unionml_tpu_torch.models import LlamaConfig

import torch_threads

torch_threads.share_cores()


def _chip_smoke():
    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


def test_chip_smoke_fleet_phase_rehearsal_on_cpu():
    smoke = _chip_smoke()
    cfg = LlamaConfig.tiny(vocab_size=97)
    params = smoke.build_template(smoke.serving_config(cfg), 8, (64,), "cpu")[1]
    out = smoke.fleet_phase(
        cfg, params, device="cpu", families=4, follow_ups=2, prefix_tokens=32,
        suffix_lengths=(4, 20), max_new_tokens=8, short_new_tokens=4, burst=6, warm_blocks=3,
        disagg_prompts=3, disagg_lengths=(20, 60), fp32_layers=2, buckets=(64,),
    )
    routing = out["routing"]
    assert routing["misroutes"] == [] and sorted(set(routing["home"])) == ["r0", "r1"]
    assert routing["prefill_tokens_saved"] == routing["expected_tokens_saved"] > 0
    assert out["http"]["routes"] == ["r1"] * 4 and out["http"]["otlp_traces"] == 4
    fo = out["failover"]
    assert fo["injected"] == 1 and fo["ejections"] >= 1 and fo["retries"] >= 1
    assert fo["victim_pool_blocks_after"] == 0 and fo["victim_leases_after"] == 0
    assert fo["rejoins"] >= 1
    auto = out["autoscaler"]
    assert auto["scale_out"]["warmed_blocks"] == auto["warmed_blocks_bit_equal"] >= 2
    assert auto["scale_in"]["replica"] == auto["joiner"]
    assert all(n > 0 for n in auto["joiner_splice_bits"]["faults_caught"].values())
    dis = out["disagg"]
    assert dis["transferred_blocks_bit_equal"] > 0 and all(b > 0 for b in dis["handoff_blocks"])
    assert dis["pool_blocks_after"] == [0, 0] and dis["leases_after"] == [0, 0]
    assert out["disagg_fp32"]["match"] in ("3/3", "2/3")
    assert out["mode"]["mode"] in ("engine", "batcher")
    assert out["burst"]["idle_share"] is None     # a device number: the card's only
