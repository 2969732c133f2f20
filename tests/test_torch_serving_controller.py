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
``prefill_export``'s blocks, each rank's kv heads put together by the
controller's ``kv_export``, import into a solo engine that gives the same
tokens; a solo engine's export imports through the controller's plan
(every rank its own kv heads) and the prompt then hits; ``kv_export``
from caller threads keeps the ranks' host stores (blocks, LRU stamps,
evictions) alike; a follower refuses requests, naming the controller.
Planted faults: a follower that applies a plan's arrivals in another
order, one that imports another rank's kv heads, and one that bumps its
store's clock on its own must each fail.
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

import torch_threads

torch_threads.share_cores()

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
    every rank's host store (its own kv head each); the controller's
    ``kv_export`` puts them together (rows [1, block, kv_heads, head_dim],
    every kv head, as the reference's one store holds them) and they
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
        assert len(got[group[0]]["entries"]) == 2
        entries = [
            {"tokens": e["tokens"], "first_block": e["first_block"],
             "rows": tuple(tuple(torch.from_numpy(buf).to(getattr(torch, dtype))
                                 for buf, dtype in layer) for layer in e["rows"])}
            for e in got[group[0]]["entries"]
        ]
        assert all(buf.shape[2] == cfg.num_kv_heads for e in entries for layer in e["rows"]
                   for buf in layer)
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


def test_kv_import_is_served_through_the_plan(ranks, weights):
    """A solo engine's ``kv_export`` (whole kv heads) imported through the
    controller: every rank attaches its own kv head of each block at one
    plan position; the prompt then admitted gets a prefix hit, every rank
    saves the same prefill tokens, and its tokens are the solo run's under
    the same placement."""
    got = ranks.run("torch_ranks_a8:controller_kv_import", _tiny(quantized=True), weights,
                    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3], max_new_tokens=6, timeout=120)
    for r in got:
        assert r["exported"] == 2 and r["attached"] == 2
        assert r["hits"] == 1 and r["saved"] == 8 and r["rows_match"]
        assert r["tokens"] == r["solo"]


def test_planted_fault_foreign_kv_heads_fail(ranks, weights):
    """A follower that imports another rank's kv heads of each block keeps
    rows that are not its heads', and the prompt spliced from them leaves
    the solo tokens."""
    got = ranks.run("torch_ranks_a8:controller_kv_import", _tiny(quantized=True), weights,
                    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3], max_new_tokens=6, fault="foreign_heads",
                    timeout=120)
    assert not got[1]["rows_match"] and not got[3]["rows_match"]
    assert got[0]["tokens"] != got[0]["solo"]


def _lru_run(ranks, weights, fault=""):
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [9, 8, 7, 6, 5, 4, 3, 2], [5, 5, 6, 6, 7, 7, 8, 8, 1],
               [2, 4, 6, 8, 10, 12, 14, 16, 3]]
    return ranks.run("torch_ranks_a8:controller_kv_lru", _tiny(quantized=True), weights, prompts,
                     max_new_tokens=4, max_bytes=4096, fault=fault, timeout=120)


def test_caller_thread_exports_keep_the_ranks_stores_alike(ranks, weights):
    """``kv_export`` from two caller threads interleaved with the traffic,
    then prompts past the stores' byte bound: every export is whole (both
    kv heads), and the two ranks of each engine hold the same blocks with
    the same LRU stamps after the same evictions."""
    got = _lru_run(ranks, weights)
    for group in ((0, 1), (2, 3)):
        a, b = (got[r] for r in group)
        assert not a["errors"] and a["exports"] and all(
            heads == 2 for entry in a["exports"] for heads in entry)
        assert a["evictions"] > 0 and a["evictions"] == b["evictions"]
        assert a["store"] == b["store"]


def test_planted_fault_a_follower_clock_fails(ranks, weights):
    """A follower that looks each planned export up once more on its own
    bumps its clock: its stamps leave the controller's."""
    got = _lru_run(ranks, weights, fault="follower_clock")
    assert got[0]["store"] != got[1]["store"] and got[2]["store"] != got[3]["store"]


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
