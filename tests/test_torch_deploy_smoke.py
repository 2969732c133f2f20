"""A CPU rehearsal of chip_smoke.py's deployment-front phases at the tiny
geometry (the kernels' plain versions), as the script drives them on the
card: the serverless handlers over the llm_serving template model (a
gateway event alone, then two sent at once that share one micro-batch, and
an object-upload event of two rows; tokens equal to ServingApp.predict's
for the same requests, and here each row's alone too), a rollout over a live paged engine (v1
republished bakes clean with its shadows matching and promotes; a
reseeded block rolls back as parity_regression with the live weights
untouched), and the remote backend (a runner process trains a host-only
stage, params bit-equal to the in-process run)."""

import sys
from pathlib import Path

from unionml_tpu_torch.models import LlamaConfig


def _chip_smoke():
    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


def test_chip_smoke_serverless_and_rollout_phases_rehearsal_on_cpu():
    smoke = _chip_smoke()
    cfg = LlamaConfig.tiny(vocab_size=97)
    config = smoke.serving_config(cfg)
    _, params = smoke.build_template(config, 8, (64,), "cpu")
    sl = smoke.serverless_phase(config, params, device="cpu", lengths=(5, 40),
                                upload_lengths=(20, 7), max_new_tokens=8, buckets=(64,))
    assert sl["tokens_equal_direct"] and sl["batches"] == 1 and sl["batch_rows"] == 2
    # in fp32 on the CPU the shared batch's rows keep their tokens alone
    assert sl["batched_vs_alone"] == [None, None] and sl["upload_rows"] == 2
    assert all(ms >= 0 for ms in sl["handler_own_ms"])
    ro = smoke.rollout_phase(cfg, params, device="cpu", layers=2, requests=4,
                             max_new_tokens=8, lengths=(10, 40), buckets=(64,))
    v1b, v2 = ro["v1b"], ro["v2"]
    assert v1b["shadow"] == {"match": 4, "diverged": 0, "error": 0, "dropped": 0}
    assert v1b["bake"] == ["baking", "baking", "bake_complete"] and v1b["warmed_blocks"] > 0
    assert v2["shadow"]["diverged"] >= 2 and v2["first_diffs"]
    assert v2["r0_checksums_unchanged"] and v2["canaries_stopped"]
    assert set(ro["publish_bytes"]) == {"v1", "v1b", "v2"}


def test_chip_smoke_remote_phase_rehearsal_on_cpu():
    out = _chip_smoke().remote_phase(device="cpu", steps=4)
    assert out["params_bit_equal"] and out["device"] == "cpu" and out["leaves"] == 6
    assert out["runner_device_line"] == "device cpu" and len(out["versions"]) == 1
