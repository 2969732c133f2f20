"""Serving-mode auto-selection (serving/auto.py) in the port: the
reference's cases of ``tests/unit/test_serving_auto.py`` on the CPU (the
decision rule both ways, injected timings, the refusal without a
measurement source, and the measurements through the port's
``make_generator`` on an explicit device), plus the rule against the JAX
package's on a grid of timings and the refusal to measure on a machine
without a card unless the CPU is asked for."""

import pytest
import torch

from unionml_tpu.serving import auto as jauto

from unionml_tpu_torch.models import Llama, LlamaConfig, init_params
from unionml_tpu_torch.serving.auto import (
    choose_serving_mode,
    decide_mode,
    measure_decode_chunk_ms,
    measure_rtt_ms,
)

import torch_threads

torch_threads.share_cores()

pytestmark = pytest.mark.quick


def test_decide_mode_both_ways():
    # round trip >> chunk compute → batcher
    assert decide_mode(rtt_ms=119.0, decode_chunk_ms=26.0) == "batcher"
    # chunk >= round trip → engine
    assert decide_mode(rtt_ms=0.5, decode_chunk_ms=26.0) == "engine"
    assert decide_mode(rtt_ms=88.0, decode_chunk_ms=88.0) == "engine"  # tie
    with pytest.raises(ValueError, match="non-negative"):
        decide_mode(rtt_ms=-1.0, decode_chunk_ms=1.0)


def test_choose_serving_mode_injected_timings():
    out = choose_serving_mode(rtt_ms=119.0, decode_chunk_ms=26.7)
    assert out["mode"] == "batcher"
    assert out["rtt_ms"] == 119.0 and out["decode_chunk_ms"] == 26.7
    assert "rule" in out
    out = choose_serving_mode(rtt_ms=10.0, decode_chunk_ms=88.0)
    assert out["mode"] == "engine"


def test_choose_serving_mode_requires_a_measurement_source():
    with pytest.raises(ValueError, match="decode_chunk_ms"):
        choose_serving_mode(rtt_ms=1.0)


def test_measurements_run_and_are_positive():
    rtt = measure_rtt_ms(reps=3, device="cpu")
    assert rtt >= 0.0
    cfg = LlamaConfig.tiny(vocab_size=64)
    module = Llama(cfg)
    params = init_params(cfg, seed=0, device="cpu")
    chunk = measure_decode_chunk_ms(
        module, params, chunk_steps=4, prompt_len=8, reps=1, device="cpu"
    )
    assert chunk >= 0.0
    decision = choose_serving_mode(module, params, chunk_steps=4, device="cpu")
    assert decision["mode"] in ("engine", "batcher")
    assert set(decision) == {"mode", "rtt_ms", "decode_chunk_ms", "rule"}


@pytest.mark.parametrize("rtt", [0.0, 0.05, 1.0, 26.0, 119.0])
@pytest.mark.parametrize("chunk", [0.0, 0.05, 26.0, 88.0])
def test_decide_mode_matches_the_reference(rtt, chunk):
    assert decide_mode(rtt_ms=rtt, decode_chunk_ms=chunk) == jauto.decide_mode(
        rtt_ms=rtt, decode_chunk_ms=chunk)
    ours = choose_serving_mode(rtt_ms=rtt, decode_chunk_ms=chunk)
    theirs = jauto.choose_serving_mode(rtt_ms=rtt, decode_chunk_ms=chunk)
    assert {k: ours[k] for k in ("mode", "rtt_ms", "decode_chunk_ms")} == {
        k: theirs[k] for k in ("mode", "rtt_ms", "decode_chunk_ms")}


def test_measurement_refuses_to_fall_back_to_cpu(monkeypatch):
    """Without a card, measuring with ``device=None`` raises instead of
    timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_rtt_ms(reps=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        choose_serving_mode(rtt_ms=1.0, module=object(), params={})
