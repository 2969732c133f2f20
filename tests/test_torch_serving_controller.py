"""One controller for a placed engine over several ranks (ROADMAP.md C14).

Four gloo ranks (:class:`torch_ranks.RankPool`, started once for the
module; rank bodies in ``tests/torch_ranks_a8.py``) serve a tiny Llama's
int8 tree placed by ``LLAMA_QUANT_PARTITION_RULES`` over
``ShardingConfig(data=-1, tensor=2)``: two tensor groups, each with its
own engine, whose first rank is the controller and whose other rank
follows. The reference's engine is one controller over the mesh; its
oracle is the solo run under the same placement
(``tests/unit/test_engine.py:270``), fp32 here, tokens exact.

Held: ``ServingApp`` on the controller answers ``POST /predict`` and
``/predict/stream`` with the solo tokens, also two callers at once at the
default pipeline depth; a deadline that expires in the queue is shed and
the next request keeps its tokens; the queue bound answers overload;
``prefill_export``'s blocks, each rank's kv heads put together, import
into a solo engine that gives the same tokens; a follower refuses
requests, naming the controller. Planted fault: a follower that applies a
plan's arrivals in another order must fail the parity check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import RankPool
from unionml_tpu.models.llama import Llama as JLlama
from unionml_tpu.models.llama import LlamaConfig as JLlamaConfig
from unionml_tpu_torch import telemetry
from unionml_tpu_torch.models import convert
from unionml_tpu_torch.models.llama import Llama, LlamaConfig
from unionml_tpu_torch.models.quantization import LLAMA_QUANT_PATTERNS, quantize_params
from unionml_tpu_torch.serving.engine import DecodeEngine
from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

PROMPTS = [[1, 2, 3, 4, 5], [6, 7, 8], [9, 10, 11, 12], [13, 14]]


def _tiny(**over):
    # the reference's tiny_llama (vocab 97), in fp32 for token parity
    kw = dict(vocab_size=97, hidden_dim=64, num_layers=2, num_heads=4, num_kv_heads=2,
              mlp_dim=128, max_len=256, rope_theta=10_000.0, dtype="float32")
    kw.update(over)
    return kw


def _plain_dict(tree):
    if hasattr(tree, "items"):
        return {k: _plain_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4, connect=False)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def weights():
    module = JLlama(JLlamaConfig(**_tiny()))
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return _plain_dict(params)


@pytest.fixture(scope="module")
def http_run(ranks, weights):
    return ranks.run("torch_ranks_a8:controller_http", _tiny(quantized=True), weights, PROMPTS[:2],
                     max_new_tokens=6, timeout=120)


def test_serving_app_on_the_controller_answers_with_the_solo_tokens(http_run):
    """``POST /predict`` on each tensor group's controller: the placed
    solo run's tokens, every prompt."""
    for rank, got in enumerate(http_run):
        assert got["role"] == ("controller" if rank % 2 == 0 else "follower")
        assert any("block_0/attn/q" in p for p in got["sharded"]), got["sharded"]
        assert got["predict"] == got["solo"]


def test_stream_on_the_controller_streams_the_solo_tokens(http_run):
    for got in http_run:
        assert got["stream"] == got["solo"][1]


def test_two_callers_at_the_default_pipeline_depth_keep_their_solo_tokens(http_run):
    """Two ``POST /predict`` from two threads at once (the C14 stagger
    case: the arrivals reach the engine at passes of its own choosing)."""
    for got in http_run:
        assert got["pair"] == [[got["solo"][0]], [got["solo"][1]]]


def test_a_follower_refuses_requests_naming_the_controller(http_run):
    for rank, got in enumerate(http_run):
        if rank % 2:
            controller = rank - 1
            assert len(got["refusals"]) == 3
            for msg in got["refusals"]:
                assert f"rank {controller}, the controller" in msg and "follow()" in msg
        else:
            assert got["refusals"] == []


@pytest.fixture(scope="module")
def queue_run(ranks, weights):
    return ranks.run("torch_ranks_a8:controller_queue", _tiny(quantized=True), weights, PROMPTS,
                     max_new_tokens=16, timeout=120)


def test_a_deadline_that_expires_in_the_queue_is_shed(queue_run):
    """One slot: the second request's 1 ms deadline expires behind the
    first; it is shed at dequeue on the controller's clock, and the third
    request then decodes its solo tokens, as the first does."""
    for got in queue_run:
        assert got["shed"] == "DeadlineExceeded"
        assert [got["first"], got["after"]] == got["solo"]


def test_the_queue_bound_answers_overload(queue_run):
    for got in queue_run:
        assert got["overload"] == "Overloaded"


def test_prefill_export_imports_into_a_solo_engine(ranks, weights):
    """``prefill_export`` on the controller leaves the prompt's blocks in
    every rank's host store (its own kv head each); put together (rows
    [1, block, kv_heads, head_dim], the heads in rank order) they
    import into an unplaced engine, whose tokens for the prompt, spliced
    from them, are the placed engine's."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    got = ranks.run("torch_ranks_a8:controller_export", _tiny(quantized=True), weights, prompt,
                    max_new_tokens=6, timeout=120)
    for r in got:
        assert r["cached"] == 8 and r["lease_blocks"] == 2 and r["first"] == r["tokens"][:1]
    cfg = LlamaConfig(**_tiny(quantized=True))
    params = quantize_params(
        convert.from_jax_params(weights, LlamaConfig(**_tiny()), device="cpu"),
        LLAMA_QUANT_PATTERNS)
    for group in ((0, 1), (2, 3)):
        parts = [got[r]["entries"] for r in group]
        assert [len(p) for p in parts] == [2, 2]
        entries = [
            {"tokens": e0["tokens"], "first_block": e0["first_block"],
             "rows": tuple(tuple(torch.from_numpy(np.concatenate([b0, b1], axis=2))
                                 .to(getattr(torch, dtype))
                                 for (b0, dtype), (b1, _) in zip(l0, l1))
                           for l0, l1 in zip(e0["rows"], e1["rows"]))}
            for e0, e1 in zip(*parts)
        ]
        solo = DecodeEngine(
            Llama(cfg), slots=2, max_new_tokens=6, prompt_buckets=(16,), chunk_steps=3,
            paged=True, kv_block_size=4, kv_pool_bytes=1 << 20, device="cpu",
            prefix_cache=RadixPrefixCache(block_size=4, registry=telemetry.MetricsRegistry()))
        try:
            assert solo.cache_len == got[group[0]]["cache_len"]
            assert solo.kv_import(entries) == 2
            assert solo.generate(params, [prompt])[0] == got[group[0]]["tokens"]
            assert solo.stats()["prefix_cache"]["prefill_tokens_saved"] == 8
        finally:
            solo.close()


def test_planted_fault_reordered_arrivals_fail_parity(ranks, weights):
    """A follower that puts a plan's two arrivals into its waiting room in
    the reverse order prefills the other prompt in each slot: the
    row-parallel sums mix the two, and the controller's tokens leave the
    solo run's (two prompts of one length: the collectives keep their
    sizes, so the fault shows as wrong tokens, not an abort)."""
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]]
    got = ranks.run("torch_ranks_a8:follower_fault", _tiny(quantized=True), weights, prompts,
                    max_new_tokens=6, timeout=120)
    for r in got:
        assert r["tokens"] != r["solo"]


def test_the_plan_holds_the_controllers_fair_weights():
    """The usage-fed DRR weights read the controller's clock: a plan ships
    the controller's (``WaitingRoom.fair_weights``) and every rank holds
    them for the pass (``hold_weights``); without a ledger there are none."""
    from unionml_tpu_torch.serving.scheduler import WaitingRoom
    from unionml_tpu_torch.serving.usage import UsageLedger

    assert WaitingRoom().fair_weights({"a"}) is None
    room = WaitingRoom(usage=UsageLedger(registry=telemetry.MetricsRegistry()))
    live = room.fair_weights({"a", "b"})
    assert sorted(live) == ["a", "b"]
    room.hold_weights({"a": 0.25})
    assert room._fair_weight("a") == 0.25 and room._fair_weight("b") == 1.0
    room.hold_weights(None)
    assert room._fair_weight("a") == live["a"]
