"""Autoregressive generation: one prefill, then a decode loop.

The port of :mod:`unionml_tpu.models.generate`. The reference runs the
decode as a ``lax.scan`` inside one compiled program; PyTorch runs
eagerly, so here the decode is a Python loop of single-token steps over
a KV cache that each step writes in place. Everything else keeps the
reference's contract: left-padded prompts with logical RoPE positions
(a padded prompt generates what its unpadded version would), greedy or
temperature / top-k / top-p sampling, eos freezing with static shapes,
chunked prefill, bucketed prompt lengths with a cache sized per bucket,
and power-of-two batch padding. Random draws come from a
:class:`torch.Generator` in place of the reference's PRNG key.

Generation runs on the device of the weights it is given. A tree placed
under tensor parallelism (:func:`~unionml_tpu_torch.parallel.shard_pytree`
with the Llama partition rules) is served on each rank's local shards:
the cache holds the rank's kv heads and the logits are whole on every
rank before sampling (every rank of the mesh calls ``generate`` with the
same prompts). Shared-prefix
serving (``make_prefix_cache``, ``make_generator(prefix_len=)``,
``make_lm_predictor(system_prefix=)``) prefills a system prompt once per
weights and copies its rows into each request batch's cache.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from unionml_tpu_torch.models.layers import localize_params
from unionml_tpu_torch.models.llama import Llama, LlamaConfig, cache_config, init_cache
from unionml_tpu_torch.models.train import resolve_params


def _params_device(params) -> torch.device:
    node = params
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
    if hasattr(node, "to_local"):     # a placed tree: its local shards' device
        return node.to_local().device
    return node.device


def make_sampler(
    *,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> Callable:
    """Build ``sample(logits[B, V], generator) -> token[B]``.

    Greedy at ``temperature == 0``; otherwise categorical over
    temperature-scaled logits, optionally filtered by ``top_k`` and then
    nucleus ``top_p`` (keep the smallest prefix of probability-descending
    tokens whose mass reaches ``top_p``).
    """
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")

    def sample(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        scaled = logits / temperature
        if top_k is not None:
            cutoff = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
            scaled = torch.where(scaled < cutoff, torch.full_like(scaled, -torch.inf), scaled)
        if top_p is not None and top_p < 1.0:
            probs = torch.softmax(scaled, dim=-1)
            sorted_probs, sort_idx = torch.sort(probs, dim=-1, descending=True)
            cum = torch.cumsum(sorted_probs, dim=-1)
            keep_sorted = (cum - sorted_probs) < top_p
            keep = torch.empty_like(keep_sorted).scatter_(-1, sort_idx, keep_sorted)
            scaled = torch.where(keep, scaled, torch.full_like(scaled, -torch.inf))
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return sample


def make_generator(
    module: Llama,
    *,
    max_new_tokens: int,
    max_len: Optional[int] = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    prefill_chunk: Optional[int] = None,
    prefix_len: int = 0,
) -> Callable:
    """Build ``generate(params, tokens, generator=None, prompt_mask=None,
    prefix_cache=None) -> tokens[B, max_new_tokens]`` (int64, on the
    weights' device).

    ``tokens``: int [B, prompt_len] (equal lengths per call);
    ``prompt_mask``: bool [B, prompt_len], False marks left padding
    (never attended to; RoPE positions count real tokens only).
    ``prefill_chunk`` bounds the cached-attention score buffer by
    prefilling in chunks; with ``prefill_impl="flash"`` the prefill goes
    through the flash kernel exactly when one call covers the whole
    prompt and no shared prefix precedes it.

    ``prefix_len > 0`` enables shared-prefix serving: ``generate`` then
    takes a :class:`PrefixCache` from :func:`make_prefix_cache` holding the
    prefix's KV rows at ``[0, prefix_len)``; each call copies them into its
    batch's cache and prefills only the prompts.
    """
    cfg: LlamaConfig = module.config
    total_len = max_len or cfg.max_len
    sample = make_sampler(temperature=temperature, top_k=top_k, top_p=top_p)

    @torch.inference_mode()
    def generate(params, tokens, generator=None, prompt_mask=None,
                 prefix_cache=None) -> torch.Tensor:
        if (prefix_cache is None) != (prefix_len == 0):
            raise ValueError(
                "prefix_cache must be passed exactly when the generator was "
                f"built with prefix_len > 0 (prefix_len={prefix_len})"
            )
        if prefix_cache is not None:
            if not isinstance(prefix_cache, PrefixCache):
                raise TypeError(
                    "prefix_cache must come from make_prefix_cache "
                    f"(got {type(prefix_cache).__name__})"
                )
            if prefix_cache.length != prefix_len or prefix_cache.total_len != total_len:
                raise ValueError(
                    f"prefix_cache was built for prefix_len={prefix_cache.length}, "
                    f"max_len={prefix_cache.total_len}; this generator needs "
                    f"prefix_len={prefix_len}, max_len={total_len}"
                )
        params = localize_params(params)
        device = _params_device(params)
        tokens = torch.as_tensor(tokens, device=device).long()
        batch, prompt_len = tokens.shape
        if prefix_len + prompt_len + max_new_tokens > total_len:
            raise ValueError(
                f"prefix_len {prefix_len} + prompt_len {prompt_len} + "
                f"max_new_tokens {max_new_tokens} exceeds the KV cache length "
                f"{total_len}; raise max_len"
            )
        if temperature != 0.0 and generator is None:
            raise ValueError(
                "temperature sampling needs an explicit torch.Generator: "
                "generate(params, tokens, generator)"
            )
        if prompt_mask is None:
            prompt_mask = torch.ones((batch, prompt_len), dtype=torch.bool, device=device)
        prompt_mask = torch.as_tensor(prompt_mask, device=device).bool()
        pad_counts = prompt_len - prompt_mask.sum(dim=1)               # [B]
        # logical (RoPE) positions continue from the prefix's real tokens
        positions = prefix_len + torch.clamp(
            torch.arange(prompt_len, device=device)[None, :] - pad_counts[:, None], min=0
        )
        kv_mask = torch.cat(
            [torch.ones((batch, prefix_len), dtype=torch.bool, device=device),
             prompt_mask,
             torch.ones((batch, total_len - prefix_len - prompt_len), dtype=torch.bool,
                        device=device)],
            dim=1,
        )
        if prefix_cache is not None:
            # the prefix rows were prefilled once; each call writes its own
            # copy (the port's cache is written in place)
            cache = tuple(
                tuple(buf.expand((batch,) + tuple(buf.shape[1:])).clone() for buf in layer)
                for layer in prefix_cache.cache
            )
        else:
            cache = init_cache(cache_config(cfg, params), batch, total_len, device=device)

        # prefill: optional lead chunks fill cache rows only; the tail's
        # head runs on the LAST position (prompts are left-padded)
        step_size = prefill_chunk or prompt_len
        n_chunks = max(0, (prompt_len - 1) // step_size)
        tail_start = n_chunks * step_size
        for c in range(n_chunks):
            start = c * step_size
            _, cache = module(
                params, tokens[:, start:start + step_size],
                positions=positions[:, start:start + step_size],
                cache=cache, cache_index=prefix_len + start, kv_mask=kv_mask,
                logit_index=torch.zeros(batch, dtype=torch.long, device=device),
            )
        tail_len = prompt_len - tail_start
        logits, cache = module(
            params, tokens[:, tail_start:], positions=positions[:, tail_start:],
            cache=cache, cache_index=prefix_len + tail_start, kv_mask=kv_mask,
            logit_index=torch.full((batch,), tail_len - 1, dtype=torch.long, device=device),
            full_prefill=cfg.prefill_impl == "flash" and prefix_len + tail_start == 0,
        )
        tok = sample(logits[:, -1], generator)
        done = (tok == eos_id) if eos_id is not None else None
        out = [tok]
        index = prefix_len + prompt_len
        for _ in range(max_new_tokens - 1):
            pos = (index - pad_counts)[:, None]                         # logical [B, 1]
            logits, cache = module(
                params, tok[:, None], positions=pos, cache=cache,
                cache_index=index, kv_mask=kv_mask,
            )
            tok = sample(logits[:, -1], generator)
            if eos_id is not None:
                tok = torch.where(done, torch.full_like(tok, pad_id), tok)
                done = done | (tok == eos_id)
            out.append(tok)
            index += 1
        return torch.stack(out, dim=1)

    return generate


@dataclass(frozen=True)
class PrefixCache:
    """A prefilled shared-prefix KV cache plus the geometry it was built
    for: :func:`make_generator`'s prefixed form checks ``length`` and
    ``total_len`` against its own, so a cache built for another prefix or
    cache size is refused."""

    cache: Any
    length: int
    total_len: int


def make_prefix_cache(
    module: Llama,
    params,
    prefix_tokens,
    *,
    max_len: Optional[int] = None,
    prefill_chunk: Optional[int] = None,
) -> PrefixCache:
    """Prefill a shared prefix (system prompt) ONCE into a ``[1, max_len]``
    KV cache, on the weights' device, for :func:`make_generator`'s
    ``prefix_len`` mode. Rows ``[0, len(prefix_tokens))`` are filled (bf16,
    or int8 + scales under ``config.kv_quant``); rebuild whenever the
    params change (the predictor's ``system_prefix`` mode memoizes per
    state identity)."""
    cfg: LlamaConfig = module.config
    total_len = max_len or cfg.max_len
    params = localize_params(params)
    device = _params_device(params)
    toks = torch.as_tensor(np.asarray(prefix_tokens, np.int64), device=device)[None]
    prefix_len = toks.shape[1]
    if prefix_len == 0:
        raise ValueError("prefix_tokens must be non-empty")
    if prefix_len >= total_len:
        raise ValueError(
            f"prefix of {prefix_len} tokens leaves no cache room within max_len {total_len}"
        )
    with torch.inference_mode():
        cache = init_cache(cache_config(cfg, params), 1, total_len, device=device)
        step_size = prefill_chunk or prefix_len
        n_chunks = max(0, (prefix_len - 1) // step_size)
        tail_start = n_chunks * step_size
        positions = torch.arange(prefix_len, device=device)[None, :]
        zero = torch.zeros((1,), dtype=torch.long, device=device)
        for c in range(n_chunks):
            start = c * step_size
            _, cache = module(
                params, toks[:, start:start + step_size],
                positions=positions[:, start:start + step_size],
                cache=cache, cache_index=start, logit_index=zero,
            )
        # the tail covers the whole prefix exactly when nothing precedes it
        _, cache = module(
            params, toks[:, tail_start:], positions=positions[:, tail_start:],
            cache=cache, cache_index=tail_start, logit_index=zero,
            full_prefill=cfg.prefill_impl == "flash" and tail_start == 0,
        )
    return PrefixCache(cache=cache, length=prefix_len, total_len=total_len)


def make_lm_predictor(
    module: Llama,
    *,
    max_new_tokens: int = 32,
    max_len: Optional[int] = None,
    bucket_lens: tuple = (16, 32, 64, 128, 256, 512),
    pad_id: int = 0,
    seed: int = 0,
    system_prefix=None,
    **gen_kwargs,
) -> Callable:
    """An ``@model.predictor``-compatible fn over token-id prompts.

    Accepts a list of token-id lists (or an int array); left-truncates /
    right-aligns each prompt into the smallest bucket length, pads the
    batch to the next power of two (pad rows replicate the last prompt),
    generates on the weights' device, and returns one token list per
    prompt. With ``temperature > 0`` a :class:`torch.Generator` seeded by
    ``seed`` (one per device) advances across calls.

    ``system_prefix`` (token ids): a shared prefix every request is
    conditioned on. Its KV rows are prefilled ONCE per weights
    (:func:`make_prefix_cache`, one cache per bucket, memoized on the
    STATE object's identity) and copied into each request batch, so the
    per-request prefill covers only the user prompt — outputs are exactly
    those of prepending the prefix to every prompt. Serving must hold one
    state object per weight set: a new wrapper around the same weights
    re-prefills the prefix (logged).
    """
    prefix = None if system_prefix is None else np.asarray(system_prefix, np.int32).ravel()
    if prefix is not None and prefix.size == 0:
        raise ValueError("system_prefix must be non-empty when given")
    prefix_len = 0 if prefix is None else len(prefix)
    total_len = max_len or module.config.max_len
    usable = tuple(sorted(
        b for b in bucket_lens if prefix_len + b + max_new_tokens <= total_len
    ))
    if not usable:
        raise ValueError(
            f"no bucket in {bucket_lens} leaves room for {max_new_tokens} new "
            f"tokens{f' + a {prefix_len}-token system_prefix' if prefix_len else ''} "
            f"within max_len {total_len}"
        )
    # one generator per bucket, each with a cache sized to the bucket:
    # decode attention reads the whole cache every step
    generators = {
        b: make_generator(
            module, max_new_tokens=max_new_tokens,
            max_len=prefix_len + b + max_new_tokens, pad_id=pad_id,
            prefix_len=prefix_len, **gen_kwargs,
        )
        for b in usable
    }
    rngs: dict = {}
    # single-slot memo keyed on the STATE object, with a strong reference
    # held (an id() key could be recycled once the state is freed)
    prefix_state: dict = {"ref": None, "caches": {}, "leaf_id": None}

    def _prefix_cache(state, params, bucket):
        if prefix is None:
            return None
        if prefix_state["ref"] is not state:
            leaf = params
            while isinstance(leaf, Mapping):
                leaf = next(iter(leaf.values()), None)
            leaf_id = id(leaf) if leaf is not None else None
            if (
                prefix_state["ref"] is not None
                and leaf_id is not None
                and leaf_id == prefix_state["leaf_id"]
            ):
                from unionml_tpu_torch._logging import logger

                logger.info(
                    "system_prefix cache rebuilt for a state wrapping the SAME "
                    "weight tensors — hold one state object per weight set or "
                    "every request re-prefills the prefix"
                )
            prefix_state.update(ref=state, caches={}, leaf_id=leaf_id)
        caches = prefix_state["caches"]
        if bucket not in caches:
            caches[bucket] = make_prefix_cache(
                module, params, prefix,
                max_len=prefix_len + bucket + max_new_tokens,
                prefill_chunk=gen_kwargs.get("prefill_chunk"),
            )
        return caches[bucket]

    def predictor(state, prompts) -> list:
        params = resolve_params(state)
        if isinstance(prompts, (list, tuple)):
            rows = [np.asarray(p, dtype=np.int64).ravel() for p in prompts]
        else:
            arr = np.asarray(prompts, dtype=np.int64)
            rows = [arr] if arr.ndim == 1 else list(arr)
        longest = max(len(r) for r in rows)
        bucket = next((b for b in usable if b >= longest), usable[-1])
        n = len(rows)
        n_padded = 1 << (n - 1).bit_length()
        batch = np.full((n_padded, bucket), pad_id, np.int64)
        mask = np.zeros((n_padded, bucket), bool)
        for i in range(n_padded):
            r = rows[min(i, n - 1)][-bucket:]     # left-truncate long prompts
            batch[i, bucket - len(r):] = r        # right-align (left-pad)
            mask[i, bucket - len(r):] = True
        device = _params_device(params)
        if device not in rngs:
            rngs[device] = torch.Generator(device=device).manual_seed(seed)
        out = generators[bucket](
            params, torch.from_numpy(batch), rngs[device], torch.from_numpy(mask),
            prefix_cache=_prefix_cache(state, params, bucket),
        )
        return out[:n].cpu().tolist()

    return predictor


def serving_params(params, dtype: torch.dtype = torch.bfloat16):
    """Cast float params once for serving residency.

    Integer leaves (int8 ``kernel_q``, packed int4 ``kernel_p``) pass
    through unchanged, and so does a ``scale`` or group-wise ``scale_g``
    next to its ``kernel_q`` / ``kernel_p`` (the dequant contract is
    "apply the fp32 scale, then one cast down"); norm params, also named
    ``scale``, cast. (The reference's MoE leaves do not occur in the
    port's trees yet.)
    """

    def walk(node):
        if isinstance(node, Mapping):
            quant = "kernel_q" in node or "kernel_p" in node
            return {
                k: v if k in ("scale", "scale_g") and quant else walk(v)
                for k, v in node.items()
            }
        if torch.is_floating_point(node):
            return node.to(dtype)
        return node

    return walk(params)
