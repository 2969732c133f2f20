"""Rank bodies of the multi-axis collective and tensor-parallel serving
tests.

Called in every gloo rank of a :class:`torch_ranks.RankPool` as
``"torch_ranks_a6c:<function>"``. Like ``torch_ranks.py`` this module
imports neither JAX nor the JAX package: numpy in, numpy out, held against
the JAX package in the pytest process. :class:`Faults` plants the faults
the parity tests must catch.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np


class Faults:
    """Planted faults: ``one_axis`` (a collective over a tuple of axes that
    reduces, gathers or scatters over its first axis only),
    ``drop_row_sum`` (row-parallel sites that keep their rank's partial
    product instead of the sum over the ranks), ``drop_expert_sum`` (a
    served MoE block that keeps its local experts' output instead of the
    sum over ``expert``), ``reorder_arrivals`` (a multi-rank engine's
    follower that applies a plan's arrivals in the reverse order),
    ``follower_clock`` (a follower that looks a planned export's prompt up
    in its host store once more on its own, bumping its LRU clock), and
    ``foreign_heads`` (a follower that imports another rank's kv heads of
    each block)."""

    def __init__(self, name: str):
        self.name = name
        self.undo: List[Any] = []

    def _patch(self, obj, attr, value):
        self.undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def __enter__(self):
        if self.name == "one_axis":
            from unionml_tpu_torch.parallel import collectives as c

            groups = c._groups
            self._patch(c, "_groups", lambda axis: groups(axis)[:1])
            self._patch(c, "_product_index",
                        lambda axis: c.compat.bound_mesh().get_local_rank(
                            c.compat._axes(axis)[0]))
        elif self.name == "drop_row_sum":
            from unionml_tpu_torch.models import layers, llama

            for mod in (layers, llama):
                self._patch(mod, "row_parallel_sum", lambda tp, y: y)
        elif self.name == "drop_expert_sum":
            from unionml_tpu_torch.ops import moe

            axis_sum = moe._axis_sum
            self._patch(moe, "_axis_sum",
                        lambda out, axis, name: out if name == "expert"
                        else axis_sum(out, axis, name))
        elif self.name == "reorder_arrivals":
            from unionml_tpu_torch.serving.engine import DecodeEngine

            requests = DecodeEngine._follower_requests
            self._patch(DecodeEngine, "_follower_requests",
                        lambda engine, arrivals: requests(engine, arrivals)[::-1])
        elif self.name == "follower_clock":
            import numpy as np

            from unionml_tpu_torch.serving.engine import DecodeEngine

            apply_kv = DecodeEngine._apply_kv

            def extra_lookup(engine, item):
                if item[0] == "export":
                    engine.prefix_cache.lease(np.asarray(item[2], np.int32)).release()
                apply_kv(engine, item)

            self._patch(DecodeEngine, "_apply_kv", extra_lookup)
        elif self.name == "foreign_heads":
            from unionml_tpu_torch.serving.engine import DecodeEngine

            index = DecodeEngine._kv_head_index
            self._patch(DecodeEngine, "_kv_head_index",
                        lambda engine: [[(h + 1) % engine.cfg.num_kv_heads for h in heads]
                                        for heads in index(engine)])
        elif self.name:
            raise KeyError(self.name)
        return self

    def __exit__(self, *exc):
        for obj, attr, value in reversed(self.undo):
            setattr(obj, attr, value)


def multi_axis_collectives(x: Any, tree: Any, bucket_sizes: List[int], *,
                           fault: str = "") -> dict:
    """psum, bucketed_psum, all_gather and reduce_scatter over ("data",
    "fsdp") on a data 2 x fsdp 2 mesh, ``x``'s rows (and every leaf's)
    split over the product as ``P(("data", "fsdp"))`` splits them; each
    result whole."""
    import torch

    from unionml_tpu_torch.parallel import collectives as c
    from unionml_tpu_torch.parallel import make_mesh, shard_map
    from unionml_tpu_torch.parallel.sharding import PartitionSpec as P

    axes = ("data", "fsdp")
    mesh = make_mesh({"data": 2, "fsdp": 2})
    x = torch.from_numpy(np.array(x))
    tree = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}

    def run(fn, arg, out_spec):
        out = shard_map(fn, mesh=mesh, in_specs=P(axes), out_specs=out_spec)(arg)
        if isinstance(out, dict):
            return {k: v.full_tensor().numpy() for k, v in out.items()}
        return out.full_tensor().numpy()

    out = {}
    with Faults(fault):
        out["psum"] = run(lambda t: {k: c.psum(v, axes) for k, v in t.items()}, tree, P())
        out["bucketed"] = [run(lambda t: c.bucketed_psum(t, axes, bucket_bytes=size), tree, P())
                           for size in bucket_sizes]
        out["all_gather"] = run(lambda b: c.all_gather(b, axes, gather_axis=1), x, P())
        out["all_gather_untiled"] = run(
            lambda b: c.all_gather(b, axes, gather_axis=0, tiled=False)[None], x, P(axes))
        out["reduce_scatter"] = run(lambda b: c.reduce_scatter(b, axes, scatter_axis=1), x,
                                    P(axes))
    return out


# --------------------------------------------------------------------- #
# serving a placed tree (tensor parallelism)
# --------------------------------------------------------------------- #


def _placed(cfg: dict, jax_params: Any, rules: str, *, bits: int = 0, group_size: int = 0,
            quant_tensor: int = 1, tensor: int = 2):
    """The reference's params bridged into the port (quantized with
    ``bits`` when given) and placed by ``rules`` over
    ``ShardingConfig(data=-1, tensor=tensor)``; also the '/'-joined paths
    of the leaves really sharded over ``tensor``."""
    from unionml_tpu_torch.models import convert, llama
    from unionml_tpu_torch.models.quantization import LLAMA_QUANT_PATTERNS, quantize_params
    from unionml_tpu_torch.parallel import ShardingConfig, shard_pytree

    config = llama.LlamaConfig(**cfg)
    fp = dict(cfg, quantized=False, weight_bits=8, int4_group=0, int4_tp=1)
    params = convert.from_jax_params(jax_params, llama.LlamaConfig(**fp) if bits else config,
                                     device="cpu")
    if bits:
        params = quantize_params(params, LLAMA_QUANT_PATTERNS, bits=bits, group_size=group_size,
                                 tensor=quant_tensor)
    if bits == 4:
        llama.assert_int4_tp_compatible(config, tensor)
    sc = ShardingConfig(data=-1, tensor=tensor, rules=getattr(llama, rules))
    placed = shard_pytree(params, sc)
    return llama.Llama(config), params, placed, _sharded_paths(placed)


def _sharded_paths(tree: Any, prefix: str = "") -> List[str]:
    from torch.distributed.tensor import Shard

    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _sharded_paths(v, f"{prefix}{k}/")]
    names = tree.device_mesh.mesh_dim_names
    if any(isinstance(p, Shard) and names[i] == "tensor" for i, p in enumerate(tree.placements)):
        return [prefix[:-1]]
    return []


def tp_generate(cfg: dict, jax_params: Any, prompt: Any, *, max_new_tokens: int,
                max_len: int, rules: str = "LLAMA_PARTITION_RULES", bits: int = 0,
                group_size: int = 0, quant_tensor: int = 1, fault: str = "") -> dict:
    """``make_generator`` and ``make_lm_predictor`` on the placed tree and
    on the plain one (every rank the same prompts), and the full forward's
    logits on both."""
    import torch

    from unionml_tpu_torch.models.generate import make_generator, make_lm_predictor
    from unionml_tpu_torch.parallel.collectives import COLLECTIVES

    module, params, placed, sharded = _placed(cfg, jax_params, rules, bits=bits,
                                              group_size=group_size, quant_tensor=quant_tensor)
    gen = make_generator(module, max_new_tokens=max_new_tokens, max_len=max_len)
    prompt = torch.from_numpy(np.array(prompt))
    with Faults(fault):
        COLLECTIVES.reset()
        tp_tokens = gen(placed, prompt).numpy()
        issued = COLLECTIVES.total
        with torch.no_grad():
            tp_logits = module(placed, prompt).numpy()
    with torch.no_grad():
        logits = module(params, prompt).numpy()
    pred = make_lm_predictor(module, max_new_tokens=max_new_tokens, bucket_lens=(8,))
    rows = [[5, 3, 9], [7, 1, 2, 8, 4, 6]]
    return {"tp": tp_tokens, "plain": gen(params, prompt).numpy(), "tp_logits": tp_logits,
            "logits": logits, "sharded": sharded, "collectives": issued,
            "predictor": (pred(placed, rows), pred(params, rows))}


def tp_spec_engine(cfg: dict, jax_params: Any, prompts: List[List[int]], *,
                   max_new_tokens: int) -> dict:
    """The speculative engine with an int4 target (quantized with tensor=2)
    placed by LLAMA_INT4_PARTITION_RULES and the same weights' int8 tree as
    its unplaced draft, against the same engine on the unplaced target."""
    from unionml_tpu_torch.models import convert
    from unionml_tpu_torch.models.llama import Llama, LlamaConfig
    from unionml_tpu_torch.models.quantization import LLAMA_QUANT_PATTERNS, quantize_params
    from unionml_tpu_torch.serving.engine import DecodeEngine

    target_cfg = dict(cfg, quantized=True, weight_bits=4, int4_tp=2)
    _, params, placed, sharded = _placed(target_cfg, jax_params, "LLAMA_INT4_PARTITION_RULES",
                                         bits=4, quant_tensor=2)
    draft_cfg = LlamaConfig(**dict(cfg, quantized=True))
    fp = convert.from_jax_params(jax_params, LlamaConfig(**cfg), device="cpu")
    draft = quantize_params(fp, LLAMA_QUANT_PATTERNS)
    out = {"sharded": sharded}
    for name, target in (("tp", placed), ("plain", params)):
        engine = DecodeEngine(Llama(LlamaConfig(**target_cfg)), draft_module=Llama(draft_cfg),
                              **spec_engine_kwargs(max_new_tokens))
        out[name], _ = serve_placed(engine, {"target": target, "draft": draft},
                                    lambda e, p: e.generate(p, prompts))
        out["cache_len"] = engine.cache_len
    return out


def serve_placed(engine: Any, params: Any, call: Any, after: Any = None) -> tuple:
    """Serve ``params`` with ``engine`` as a multi-rank engine is served:
    ``call(engine, params)`` on the controller (its only caller; every
    call of an engine that is not served over several ranks), ``follow()``
    on the other ranks; then ``after(engine)`` on every rank, and the
    engine closed. Returns the controller's result (sent to every rank of
    the engine) and ``after``'s."""
    import torch.distributed as dist

    engine.bind(params)
    tree = engine._params["target"] if engine.draft is not None else engine._params
    value = None
    try:
        if engine.role == "follower":
            engine.follow(params)
        else:
            value = call(engine, params)
        extra = after(engine) if after is not None else None
    finally:
        engine.close()
    if engine.role != "solo":
        # the tests' engines span the world or one tensor group
        box = [value]
        group = None if len(tree.ranks) == dist.get_world_size() else tree.tp.group
        dist.broadcast_object_list(box, src=tree.ranks[0], group=group)
        value = box[0]
    return value, extra


def spec_engine_kwargs(max_new_tokens: int) -> dict:
    """The speculative engines' settings in :func:`tp_spec_engine`."""
    return dict(speculate_k=3, slots=2, max_new_tokens=max_new_tokens, prompt_buckets=(8, 16),
                chunk_steps=2, pipeline_depth=1, device="cpu")


def engine_kwargs(max_new_tokens: int, paged: bool, pipeline_depth: int = 1) -> dict:
    """The engines' settings in :func:`tp_engine` (``pipeline_depth=None``:
    the engine's default)."""
    kw = dict(slots=2, max_new_tokens=max_new_tokens, prompt_buckets=(8,), chunk_steps=3,
              device="cpu")
    if pipeline_depth is not None:
        kw["pipeline_depth"] = pipeline_depth
    if paged:
        kw.update(paged=True, kv_block_size=4, kv_pool_bytes=1 << 20)
    return kw


def engine_cache_len(cfg: dict, draft_cfg: Any = None, **kw: Any) -> int:
    """The cache length of an engine built with ``kw`` (the solo oracle's
    ``max_len``), without binding weights."""
    from unionml_tpu_torch.models.llama import Llama, LlamaConfig
    from unionml_tpu_torch.serving.engine import DecodeEngine

    if draft_cfg is not None:
        kw = dict(kw, draft_module=Llama(LlamaConfig(**draft_cfg)))
    engine = DecodeEngine(Llama(LlamaConfig(**cfg)), **kw)
    engine.close()
    return engine.cache_len


def tp_engine(cfg: dict, jax_params: Any, prompts: List[List[int]], *, max_new_tokens: int,
              paged: bool, rules: str = "LLAMA_PARTITION_RULES", bits: int = 0,
              quant_tensor: int = 1, kv_quant: bool = False, system_prefix: Any = None,
              pipeline_depth: Any = 1, stagger: int = 0, fault: str = "") -> dict:
    """``DecodeEngine`` on the placed tree (the controller takes the
    requests, the other rank of its tensor group follows) and the solo
    generator under the same placement at the engine's cache length, per
    prompt; the pool's block bytes against the unplaced engine's. With
    ``system_prefix`` both engines hold it in a prefix cache (blocks of 4)
    and splice it into every admission; no solo run then. With ``stagger``
    the controller takes the prompts in two ``generate()`` calls from two
    threads, the second once the engine has dispatched ``stagger`` decode
    steps (mid-decode), then a call with a deadline, a stream and an
    engine with a queue bound, which C14's controller serves (``lifted``:
    their tokens)."""
    import threading
    import time

    import torch

    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

    from unionml_tpu_torch.models.generate import make_generator
    from unionml_tpu_torch.models.llama import Llama, LlamaConfig
    from unionml_tpu_torch.serving.engine import DecodeEngine

    cfg = dict(cfg, kv_quant=kv_quant)
    module, params, placed, sharded = _placed(cfg, jax_params, rules, bits=bits,
                                              quant_tensor=quant_tensor)
    kw = engine_kwargs(max_new_tokens, paged, pipeline_depth)

    def staggered(engine, placed):
        half = len(prompts) // 2
        first: List[Any] = []
        caller = threading.Thread(target=lambda: first.extend(engine.generate(placed,
                                                                              prompts[:half])))
        caller.start()
        due = time.monotonic() + 30
        while engine.stats()["decode_steps"] < stagger and time.monotonic() < due:
            time.sleep(0.001)
        second = engine.generate(placed, prompts[half:])
        caller.join()
        lifted = [engine.generate(placed, prompts[:1], deadline_ms=1e4),
                  sum(engine.generate_stream(placed, prompts[0]), [])]
        lifted.append(bounded.generate(placed, prompts[:1]))
        return first + second, lifted

    def engine_kw():
        if system_prefix is None:
            return kw
        return dict(kw, system_prefix=system_prefix,
                    prefix_cache=RadixPrefixCache(block_size=4,
                                                  registry=telemetry.MetricsRegistry()))

    def measure(engine):
        got = {"cache_len": engine.cache_len}
        if paged:
            got["block_nbytes"] = (plain_bytes, engine.kv_pool.block_nbytes)
            got["pool_blocks"] = engine.kv_pool.num_blocks
            got["pool_heads"] = int(engine._state["pool"][0][0].shape[2])
        if system_prefix is not None:
            got["saved"] = engine.stats()["prefix_cache"]["prefill_tokens_saved"]
        return got

    out = {"sharded": sharded}
    with Faults(fault):
        engine = DecodeEngine(module, **engine_kw())
        plain_bytes = engine.kv_pool.block_nbytes if paged else None
        if stagger:
            # bound in the same order on every rank: the engine, then the
            # bounded one (followed meanwhile on the other rank)
            bounded = DecodeEngine(module, **dict(kw, max_queue_depth=4))
            engine.bind(placed)
            bounded.bind(placed)
            (out["engine"], out["lifted"]), got = serve_placed(engine, placed, staggered,
                                                               measure)
            serve_placed(bounded, placed, lambda e, p: None)
        else:
            out["engine"], got = serve_placed(engine, placed,
                                              lambda e, p: e.generate(p, prompts), measure)
        out.update(got)
        if system_prefix is None:
            gen = make_generator(module, max_new_tokens=max_new_tokens,
                                 max_len=engine.cache_len)
            out["solo"] = [gen(placed, torch.tensor([p])).numpy()[0].tolist()
                           for p in prompts]
    plain = DecodeEngine(Llama(LlamaConfig(**cfg)), **engine_kw())
    try:
        if system_prefix is None:
            out["plain_engine"] = plain.generate(params, prompts)
        else:
            # one call a prompt: a later admission then always finds the
            # prefix's blocks (one call of all would race the harvest's
            # insert, which the placed engine waits for, against the next
            # admission)
            out["plain_engine"] = [plain.generate(params, [p])[0] for p in prompts]
        if system_prefix is not None:
            out["plain_saved"] = plain.stats()["prefix_cache"]["prefill_tokens_saved"]
    finally:
        plain.close()
    return out


def tp_encdec(cfg: dict, jax_params: Any, src: Any, *, max_new_tokens: int) -> dict:
    """The encoder-decoder's greedy tokens from the tree placed by
    ENCDEC_PARTITION_RULES over ``ShardingConfig(data=-1, tensor=2)`` and
    from the plain tree."""
    import torch

    from unionml_tpu_torch.models import convert
    from unionml_tpu_torch.models.encdec import (ENCDEC_PARTITION_RULES, EncDecConfig,
                                                 EncoderDecoder, make_seq2seq_generator)
    from unionml_tpu_torch.parallel import ShardingConfig, shard_pytree

    config = EncDecConfig(**cfg)
    params = convert.encdec_from_jax_params(jax_params, config, device="cpu")
    placed = shard_pytree(params, ShardingConfig(data=-1, tensor=2,
                                                 rules=ENCDEC_PARTITION_RULES))
    gen = make_seq2seq_generator(EncoderDecoder(config), max_new_tokens=max_new_tokens)
    src = torch.from_numpy(np.array(src))
    return {"tp": gen(placed, src, None, src != 0).numpy(),
            "plain": gen(params, src, None, src != 0).numpy(),
            "sharded": _sharded_paths(placed)}
