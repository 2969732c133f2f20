"""Rank bodies of the multi-rank serving tests: one controller over a
placed engine (ROADMAP.md C14) and placed MoE and LoRA trees (A8).

Called in every gloo rank of a :class:`torch_ranks.RankPool` as
``"torch_ranks_a8:<function>"``. Like ``torch_ranks.py`` this module
imports neither JAX nor the JAX package: numpy in, numpy out. The
engine's controller (the first rank of each tree's ranks) takes the
requests, the other ranks follow (``torch_ranks_a6c.serve_placed``).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Any, List

from torch_ranks_a6c import Faults, _placed, serve_placed


def _paged(**over: Any) -> dict:
    kw = dict(slots=2, max_new_tokens=6, prompt_buckets=(8,), chunk_steps=3, paged=True,
              kv_block_size=4, kv_pool_bytes=1 << 20, device="cpu")
    kw.update(over)
    return kw


def _solo(module: Any, placed: Any, prompts: List[List[int]], n: int, max_len: int) -> list:
    """The placed tree's greedy tokens for each prompt alone (every rank)."""
    import torch

    from unionml_tpu_torch.models.generate import make_generator

    gen = make_generator(module, max_new_tokens=n, max_len=max_len)
    return [gen(placed, torch.tensor([p])).numpy()[0].tolist() for p in prompts]


def _post(base: str, route: str, body: dict) -> Any:
    req = urllib.request.Request(base + route, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            text = resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code
    if route.endswith("/stream"):
        events = [json.loads(line[5:]) for line in text.splitlines() if line.startswith("data:")]
        return sum((e["tokens"] for e in events if "tokens" in e), [])
    return json.loads(text)


def _serving_model(engine: Any, params: Any) -> Any:
    import unionml_tpu_torch
    from unionml_tpu_torch import ModelArtifact

    dataset = unionml_tpu_torch.Dataset(name="controller_dataset")

    @dataset.reader
    def reader() -> list:
        return [[1, 2, 3]]

    @dataset.feature_loader
    def feature_loader(raw: list) -> list:
        return raw

    model = unionml_tpu_torch.Model(name="controller_llm", dataset=dataset)

    @model.init
    def init(hyperparameters: dict) -> dict:
        return params

    @model.predictor
    def predictor(params: dict, prompts: list) -> list:
        return engine.generate(params, prompts)

    model.artifact = ModelArtifact(params)
    return model


def controller_http(cfg: dict, jax_params: Any, prompts: List[List[int]], *,
                    max_new_tokens: int) -> dict:
    """One ``ServingApp`` on each tensor group's controller over the placed
    int8 tree's paged engine at the default pipeline depth: ``POST
    /predict``, ``POST /predict/stream``, then two ``POST /predict`` from
    two threads at once. A follower first tries the calls it must refuse,
    then follows. Every rank then runs the placed solo generator."""
    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.serving import ServingApp
    from unionml_tpu_torch.serving.engine import DecodeEngine
    from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

    module, _, placed, sharded = _placed(cfg, jax_params, "LLAMA_QUANT_PARTITION_RULES",
                                         bits=8)
    engine = DecodeEngine(module, **_paged(
        max_new_tokens=max_new_tokens, prompt_buckets=(8, 16), pipeline_depth=8,
        prefix_cache=RadixPrefixCache(block_size=4, registry=telemetry.MetricsRegistry())))
    engine.bind(placed)
    refusals = []
    if engine.role == "follower":
        for call in (lambda: engine.generate(placed, prompts),
                     lambda: list(engine.generate_stream(placed, prompts[0])),
                     lambda: engine.prefill_export(placed, prompts[0])):
            try:
                call()
                refusals.append("")
            except RuntimeError as exc:
                refusals.append(str(exc))

    def serve(engine, placed):
        app = ServingApp(_serving_model(engine, placed), batch=False, health=engine.health,
                         stream=lambda p, f: engine.generate_stream(p, f[0]))
        host, port = app.serve(host="127.0.0.1", port=0, blocking=False)
        base = f"http://{host}:{port}"
        try:
            got = {"predict": _post(base, "/predict", {"features": prompts}),
                   "stream": _post(base, "/predict/stream", {"features": [prompts[1]]})}
            pair: List[Any] = [None, None]

            def call(i):
                pair[i] = _post(base, "/predict", {"features": [prompts[i]]})

            threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            got["pair"] = pair
        finally:
            app.shutdown()
        return got

    got, _ = serve_placed(engine, placed, serve)
    return dict(got, role=engine.role, refusals=refusals, sharded=sharded,
                solo=_solo(module, placed, prompts, max_new_tokens, engine.cache_len))


def controller_queue(cfg: dict, jax_params: Any, prompts: List[List[int]], *,
                     max_new_tokens: int) -> dict:
    """One slot and ``max_queue_depth=2`` on the placed int8 tree: while
    the first prompt decodes, a second with a 1 ms deadline and a third
    queue, and a fourth is refused as overload; the second is shed at
    dequeue, the third then decodes."""
    from unionml_tpu_torch.serving.engine import DecodeEngine
    from unionml_tpu_torch.serving.faults import DeadlineExceeded, Overloaded

    module, _, placed, _ = _placed(cfg, jax_params, "LLAMA_QUANT_PARTITION_RULES", bits=8)
    engine = DecodeEngine(module, **_paged(slots=1, max_new_tokens=max_new_tokens,
                                           chunk_steps=2, max_queue_depth=2))

    def run(engine, placed):
        out: dict = {}

        def call(key, prompt, **kw):
            try:
                out[key] = engine.generate(placed, [prompt], **kw)[0]
            except (DeadlineExceeded, Overloaded) as exc:
                out[key] = type(exc).__name__

        first = threading.Thread(target=call, args=("first", prompts[0]))
        first.start()
        due = time.monotonic() + 30
        while engine.stats()["decode_steps"] < 2 and time.monotonic() < due:
            time.sleep(0.001)
        queued = [threading.Thread(target=call, args=("shed", prompts[1]),
                                   kwargs={"deadline_ms": 1.0}),
                  threading.Thread(target=call, args=("after", prompts[2]))]
        for t in queued:
            t.start()
            while engine.health()["queue_depth"] < queued.index(t) + 1 and t.is_alive():
                time.sleep(0.0005)
        call("overload", prompts[3])
        for t in [first, *queued]:
            t.join()
        out["first_active"] = engine.stats()["decode_steps"]
        return out

    got, _ = serve_placed(engine, placed, run)
    solo = _solo(module, placed, [prompts[0], prompts[2]], max_new_tokens, engine.cache_len)
    return dict(got, solo=solo)


def controller_export(cfg: dict, jax_params: Any, prompt: List[int], *,
                      max_new_tokens: int) -> dict:
    """``prefill_export`` from the placed int8 tree's prefix-cached engine
    on the controller (its lease released through the plan), the
    controller's tokens for the prompt, generated on the exported blocks,
    and its ``kv_export`` of them (every rank's kv heads put together)."""
    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.serving.engine import DecodeEngine
    from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

    module, _, placed, _ = _placed(cfg, jax_params, "LLAMA_QUANT_PARTITION_RULES", bits=8)
    engine = DecodeEngine(module, **_paged(
        max_new_tokens=max_new_tokens, prompt_buckets=(16,),
        prefix_cache=RadixPrefixCache(block_size=4, registry=telemetry.MetricsRegistry())))

    def run(engine, placed):
        handle = engine.prefill_export(placed, prompt)
        lease_blocks = handle["lease"].n_blocks
        handle["lease"].release()
        tokens = engine.generate(placed, [prompt])[0]
        # the controller's kv_export: every rank's kv heads put together
        entries = [{"tokens": e["tokens"], "first_block": e["first_block"],
                    # as fp32 (exact for a bf16 cache) with the dtype's name
                    "rows": [[(buf.float().numpy(), str(buf.dtype).split(".")[-1])
                              for buf in layer] for layer in e["rows"]]}
                   for e in engine.kv_export(prompt, wait_s=30.0)]
        return {"first": handle["tokens"], "cached": handle["cached_tokens"],
                "lease_blocks": lease_blocks, "tokens": tokens, "entries": entries,
                "saved": engine.stats()["prefix_cache"]["prefill_tokens_saved"]}

    got, _ = serve_placed(engine, placed, run)
    return dict(got, cache_len=engine.cache_len)


def _store_state(cache: Any) -> dict:
    """A host prefix store's LRU state: its clock, and every stored
    block's token path with its stamp, in path order."""
    nodes, stack = [], [(cache._root, b"")]
    while stack:
        node, path = stack.pop()
        for key, child in node.children.items():
            nodes.append((path + key).hex() + f"@{child.last_used}")
            stack.append((child, path + key))
    return {"clock": cache._clock, "blocks": sorted(nodes)}


def _prefix_engine(module: Any, max_new_tokens: int, **over: Any) -> Any:
    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.serving.engine import DecodeEngine
    from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

    store = dict(block_size=4, registry=telemetry.MetricsRegistry())
    store.update(over.pop("store", {}))
    return DecodeEngine(module, **_paged(max_new_tokens=max_new_tokens, prompt_buckets=(16,),
                                         prefix_cache=RadixPrefixCache(**store), **over))


def controller_kv_import(cfg: dict, jax_params: Any, prompt: List[int], *,
                         max_new_tokens: int, fault: str = "") -> dict:
    """A solo engine's ``kv_export`` of ``prompt`` (the unplaced tree,
    whole kv heads) imported through the multi-rank engine's controller,
    then the prompt admitted there: the blocks attached, the prompt's
    tokens, and on every rank the prefill tokens saved and its store's
    rows against the solo export's heads this rank keeps."""
    import torch

    from unionml_tpu_torch.models.layers import local_kv_index

    module, params, placed, _ = _placed(cfg, jax_params, "LLAMA_QUANT_PARTITION_RULES", bits=8)
    solo = _prefix_engine(module, max_new_tokens)
    try:
        solo.generate(params, [prompt])
        entries = solo.kv_export(prompt, wait_s=30.0)
    finally:
        solo.close()
    engine = _prefix_engine(module, max_new_tokens)
    engine.bind(placed)
    fault = fault if engine.role == "follower" else ""

    def run(engine, placed):
        attached = engine.kv_import(entries)
        return {"attached": attached, "tokens": engine.generate(placed, [prompt])[0]}

    def after(engine):
        index = local_kv_index(engine.cfg, engine._params)
        lease = engine.prefix_cache.lease(prompt)
        try:
            rows_match = len(lease.rows) == len(entries) and all(
                torch.equal(mine, whole[:, :, index])
                for e, stored in zip(entries, lease.rows)
                for layer, stored_layer in zip(e["rows"], stored)
                for whole, mine in zip(layer, stored_layer))
        finally:
            lease.release()
        return {"saved": engine.stats()["prefix_cache"]["prefill_tokens_saved"],
                "hits": engine.stats()["prefix_cache"]["hits"], "rows_match": rows_match}

    with Faults(fault):
        got, mine = serve_placed(engine, placed, run, after)
    return dict(got, **mine, exported=len(entries),
                solo=_solo(module, placed, [prompt], max_new_tokens, engine.cache_len)[0])


def controller_kv_lru(cfg: dict, jax_params: Any, prompts: List[List[int]], *,
                      max_new_tokens: int, max_bytes: int, fault: str = "") -> dict:
    """``kv_export`` from two caller threads interleaved with the engine's
    traffic on the controller, then more prompts than the host store's
    byte bound holds: the whole-head entries the exports returned, and
    every rank's store (clock, blocks and stamps) and evictions."""
    module, _, placed, _ = _placed(cfg, jax_params, "LLAMA_QUANT_PARTITION_RULES", bits=8)
    engine = _prefix_engine(module, max_new_tokens, store={"max_bytes": max_bytes})
    engine.bind(placed)
    fault = fault if engine.role == "follower" else ""

    def run(engine, placed):
        exported, errors = [], []
        stop = threading.Event()

        def exporter(k):
            try:
                while not stop.is_set():
                    for p in prompts[k::2]:
                        # the kv heads of each entry's first buffer
                        exported.append([e["rows"][0][0].shape[2]
                                         for e in engine.kv_export(p, wait_s=0.0)])
            except Exception as exc:
                errors.append(repr(exc))

        threads = [threading.Thread(target=exporter, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        tokens = [engine.generate(placed, [p])[0] for p in prompts]
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        # past the byte bound: more prompts than the store holds
        tokens += [engine.generate(placed, [[t + 1 for t in p][::-1] + [50]])[0] for p in prompts]
        return {"tokens": tokens, "exports": exported, "errors": errors}

    def after(engine):
        stats = engine.stats()["prefix_cache"]
        return {"store": _store_state(engine.prefix_cache), "evictions": stats["evictions"]}

    with Faults(fault):
        got, mine = serve_placed(engine, placed, run, after)
    return dict(got, **mine)


def follower_fault(cfg: dict, jax_params: Any, prompts: List[List[int]], *,
                   max_new_tokens: int) -> dict:
    """The planted fault: a follower that applies a plan's arrivals in
    the reverse order; the controller's tokens against the placed solo
    run's."""
    from unionml_tpu_torch.serving.engine import DecodeEngine

    module, _, placed, _ = _placed(cfg, jax_params, "LLAMA_QUANT_PARTITION_RULES", bits=8)
    engine = DecodeEngine(module, **_paged(max_new_tokens=max_new_tokens))
    engine.bind(placed)
    fault = "reorder_arrivals" if engine.role == "follower" else ""
    with Faults(fault):
        tokens, _ = serve_placed(engine, placed, lambda e, p: e.generate(p, prompts))
    return {"tokens": tokens,
            "solo": _solo(module, placed, prompts, max_new_tokens, engine.cache_len)}


# --------------------------------------------------------------------- #
# placed MoE and LoRA trees (A8)
# --------------------------------------------------------------------- #


def _paths(tree: Any, axis: str, prefix: str = "") -> List[str]:
    """The '/'-joined paths of the leaves sharded over ``axis``."""
    from torch.distributed.tensor import Shard

    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, axis, f"{prefix}{k}/")]
    names = tree.device_mesh.mesh_dim_names
    if any(isinstance(p, Shard) and names[i] == axis for i, p in enumerate(tree.placements)):
        return [prefix[:-1]]
    return []


def moe_serving(cfg: dict, jax_params: Any, prompts: List[List[int]], *, bits: int,
                max_new_tokens: int, fault: str = "") -> dict:
    """The MoE tree (int8 experts with ``bits=8``) placed by
    ``LLAMA_MOE_PARTITION_RULES`` over ``ShardingConfig(data=-1, expert=2,
    tensor=2)``: one engine over the four ranks (the paged ``DecodeEngine``,
    rank 0 the controller) and ``make_generator``, against the placed solo
    run at the engine's cache length; the unplaced engine's tokens; the
    placed and unplaced forwards' logits."""
    import torch

    from unionml_tpu_torch.models import convert, llama
    from unionml_tpu_torch.models.generate import make_generator
    from unionml_tpu_torch.models.quantization import LLAMA_QUANT_PATTERNS, quantize_params
    from unionml_tpu_torch.parallel import ShardingConfig, shard_pytree
    from unionml_tpu_torch.serving.engine import DecodeEngine

    config = llama.LlamaConfig(**dict(cfg, quantized=bool(bits)))
    params = convert.from_jax_params(jax_params, llama.LlamaConfig(**cfg), device="cpu")
    if bits:
        params = quantize_params(params, LLAMA_QUANT_PATTERNS)
    placed = shard_pytree(params, ShardingConfig(data=-1, expert=2, tensor=2,
                                                 rules=llama.LLAMA_MOE_PARTITION_RULES))
    module = llama.Llama(config)
    prompt = torch.tensor([prompts[0]])
    out = {"expert": _paths(placed, "expert"), "tensor": _paths(placed, "tensor")}
    with Faults(fault):
        engine = DecodeEngine(module, **_paged(max_new_tokens=max_new_tokens))
        out["engine"], _ = serve_placed(engine, placed, lambda e, p: e.generate(p, prompts))
        out["solo"] = _solo(module, placed, prompts, max_new_tokens, engine.cache_len)
        with torch.no_grad():
            out["tp_logits"] = module(placed, prompt).numpy()
    with torch.no_grad():
        out["logits"] = module(params, prompt).numpy()
    plain = DecodeEngine(module, **_paged(max_new_tokens=max_new_tokens))
    try:
        out["plain_engine"] = plain.generate(params, prompts)
    finally:
        plain.close()
    gen = make_generator(module, max_new_tokens=max_new_tokens, max_len=engine.cache_len)
    out["generator"] = gen(placed, torch.tensor(prompts[:1])).numpy().tolist()
    out["cache_len"] = engine.cache_len
    return out


def lora_serving(cfg: dict, jax_params: Any, prompts: List[List[int]], *, quantized: bool,
                 system_prefix: List[int], max_new_tokens: int) -> dict:
    """A LoRA (QLoRA with ``quantized``) state whose base and random
    adapters are placed by ``LLAMA_LORA_PARTITION_RULES`` over
    ``ShardingConfig(data=-1, tensor=2)``, served by ``make_lm_predictor(
    system_prefix=...)`` twice (the prefix cache built once a state), and
    the unplaced state's predictor and the generator on the merged tree
    with the prefix prepended."""
    import dataclasses

    import torch

    from unionml_tpu_torch.models import convert, llama
    from unionml_tpu_torch.models import generate as gen_mod
    from unionml_tpu_torch.models.lora import create_lora_train_state
    from unionml_tpu_torch.models.quantization import LLAMA_QUANT_PATTERNS, quantize_params
    from unionml_tpu_torch.parallel import ShardingConfig, shard_pytree

    base_cfg = llama.LlamaConfig(**cfg)
    base = convert.from_jax_params(jax_params, base_cfg, device="cpu")
    if quantized:
        base = quantize_params(base, LLAMA_QUANT_PATTERNS)
    config = dataclasses.replace(base_cfg, quantized=quantized, lora_rank=2)
    module = llama.Llama(config)
    state = create_lora_train_state(module, torch.zeros((1, 8), dtype=torch.long),
                                    base_params=base)
    gen = torch.Generator().manual_seed(7)
    state.params = _map(state.params, lambda t: 0.05 * torch.randn(t.shape, generator=gen))
    sc = ShardingConfig(data=-1, tensor=2, rules=llama.LLAMA_LORA_PARTITION_RULES)
    placed = dataclasses.replace(state, params=shard_pytree(state.params, sc),
                                 frozen_params=shard_pytree(state.frozen_params, sc))
    calls = []
    real = gen_mod.make_prefix_cache

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    gen_mod.make_prefix_cache = spy
    try:
        pred = gen_mod.make_lm_predictor(module, max_new_tokens=max_new_tokens, bucket_lens=(8,),
                                         max_len=32, system_prefix=system_prefix)
        first = pred(placed, prompts)
        second = pred(placed, prompts)
    finally:
        gen_mod.make_prefix_cache = real
    plain = gen_mod.make_lm_predictor(module, max_new_tokens=max_new_tokens, bucket_lens=(8,),
                                      max_len=32, system_prefix=system_prefix)
    full = gen_mod.make_generator(module, max_new_tokens=max_new_tokens, max_len=64)
    merged = placed.full_params()
    return {"first": first, "second": second, "prefix_builds": len(calls),
            "plain": plain(state, prompts),
            "generator": [full(merged, torch.tensor([system_prefix + p])).numpy()[0].tolist()
                          for p in prompts],
            "lora_tensor": [p for p in _paths(placed.params, "tensor")]}


def _map(tree: Any, fn: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)
