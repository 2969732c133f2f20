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

Generation runs on the device of the weights it is given. The shared
system-prefix cache (``system_prefix`` / ``make_prefix_cache``) is not
ported yet and raises.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Optional

import numpy as np
import torch

from unionml_tpu_torch.models.llama import Llama, LlamaConfig, init_cache
from unionml_tpu_torch.models.train import resolve_params


def _params_device(params) -> torch.device:
    node = params
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
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
    """Build ``generate(params, tokens, generator=None, prompt_mask=None)
    -> tokens[B, max_new_tokens]`` (int64, on the weights' device).

    ``tokens``: int [B, prompt_len] (equal lengths per call);
    ``prompt_mask``: bool [B, prompt_len], False marks left padding
    (never attended to; RoPE positions count real tokens only).
    ``prefill_chunk`` bounds the cached-attention score buffer by
    prefilling in chunks; with ``prefill_impl="flash"`` the prefill goes
    through the flash kernel exactly when one call covers the whole
    prompt.
    """
    if prefix_len:
        raise NotImplementedError("shared-prefix generation is not ported (see ROADMAP.md)")
    cfg: LlamaConfig = module.config
    total_len = max_len or cfg.max_len
    sample = make_sampler(temperature=temperature, top_k=top_k, top_p=top_p)

    @torch.inference_mode()
    def generate(params, tokens, generator=None, prompt_mask=None) -> torch.Tensor:
        device = _params_device(params)
        tokens = torch.as_tensor(tokens, device=device).long()
        batch, prompt_len = tokens.shape
        if prompt_len + max_new_tokens > total_len:
            raise ValueError(
                f"prompt_len {prompt_len} + max_new_tokens {max_new_tokens} "
                f"exceeds the KV cache length {total_len}; raise max_len"
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
        positions = torch.clamp(
            torch.arange(prompt_len, device=device)[None, :] - pad_counts[:, None], min=0
        )
        kv_mask = torch.cat(
            [prompt_mask,
             torch.ones((batch, total_len - prompt_len), dtype=torch.bool, device=device)],
            dim=1,
        )
        cache = init_cache(cfg, batch, total_len, device=device)

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
                cache=cache, cache_index=start, kv_mask=kv_mask,
                logit_index=torch.zeros(batch, dtype=torch.long, device=device),
            )
        tail_len = prompt_len - tail_start
        logits, cache = module(
            params, tokens[:, tail_start:], positions=positions[:, tail_start:],
            cache=cache, cache_index=tail_start, kv_mask=kv_mask,
            logit_index=torch.full((batch,), tail_len - 1, dtype=torch.long, device=device),
            full_prefill=cfg.prefill_impl == "flash" and tail_start == 0,
        )
        tok = sample(logits[:, -1], generator)
        done = (tok == eos_id) if eos_id is not None else None
        out = [tok]
        index = prompt_len
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
    """
    if system_prefix is not None:
        raise NotImplementedError("system_prefix is not ported (see ROADMAP.md)")
    total_len = max_len or module.config.max_len
    usable = tuple(sorted(b for b in bucket_lens if b + max_new_tokens <= total_len))
    if not usable:
        raise ValueError(
            f"no bucket in {bucket_lens} leaves room for {max_new_tokens} new "
            f"tokens within max_len {total_len}"
        )
    # one generator per bucket, each with a cache sized to the bucket:
    # decode attention reads the whole cache every step
    generators = {
        b: make_generator(
            module, max_new_tokens=max_new_tokens, max_len=b + max_new_tokens,
            pad_id=pad_id, **gen_kwargs,
        )
        for b in usable
    }
    rngs: dict = {}

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
            params, torch.from_numpy(batch), rngs[device], torch.from_numpy(mask)
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
