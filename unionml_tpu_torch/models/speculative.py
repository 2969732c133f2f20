"""Speculative decoding: the draft proposes, the target verifies in one forward.

The port of :mod:`unionml_tpu.models.speculative`. A small DRAFT model
greedily proposes ``k`` tokens, the TARGET scores all ``k + 1`` positions
in ONE forward, and the longest prefix of draft tokens matching the
target's own greedy choices is accepted, plus the target's next token as
a free correction. With the greedy rule the output is token-identical to
plain greedy decoding of the target, for any draft.

The reference runs the rounds as one ``lax.while_loop``; here they are a
Python loop over the same device arithmetic (acceptance, emission, eos
truncation and fill advance stay tensors on the weights' device). Both
caches advance by per-row amounts through the vector ``cache_index`` path
of :class:`~unionml_tpu_torch.models.layers.Attention`; rejected draft
rows become stale cache entries above each row's fill, and every one is
rewritten by the next round before it could become visible.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Optional

import numpy as np
import torch

from unionml_tpu_torch.models.generate import _params_device
from unionml_tpu_torch.models.layers import localize_params
from unionml_tpu_torch.models.llama import Llama, cache_config, init_cache
from unionml_tpu_torch.models.train import resolve_params

__all__ = [
    "greedy_acceptance",
    "make_speculative_generator",
    "make_speculative_predictor",
]


def greedy_acceptance(proposals: torch.Tensor, greedy: torch.Tensor):
    """The greedy acceptance rule — ONE home (the generator's round and the
    decode engine's speculative round both call it).

    ``proposals`` [B, k] (draft tokens), ``greedy`` [B, k+1] (the target's
    argmax at each verify position). Draft token i is accepted iff it
    equals the target's choice after position i-1 AND every earlier
    proposal was accepted. Returns ``(accepted [B], correction [B], emit
    [B, k+1])``: the count of accepted draft tokens, the target's next
    token after the accepted prefix, and the emission buffer holding the
    accepted prefix with the correction at position ``accepted``.
    """
    batch, k = proposals.shape
    match = proposals == greedy[:, :k]
    accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
    correction = torch.gather(greedy, 1, accepted[:, None])[:, 0]
    emit = torch.cat([proposals, torch.zeros_like(proposals[:, :1])], dim=1)
    emit = emit.scatter(1, accepted[:, None], correction[:, None])
    return accepted, correction, emit


def make_speculative_generator(
    target: Llama,
    draft: Llama,
    *,
    max_new_tokens: int,
    speculate_k: int = 4,
    max_len: Optional[int] = None,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    with_stats: bool = False,
) -> Callable:
    """Build ``generate(target_params, draft_params, tokens, true_lens=None)
    -> tokens [B, max_new_tokens]`` (greedy, equal to plain target
    decoding; int64 on the weights' device).

    ``tokens``: int [B, prompt_len]; ``true_lens`` (optional int [B]) marks
    RIGHT-padded rows' real lengths. ``target`` and ``draft`` must share
    the vocabulary. A round costs ``k + 1`` draft steps (the extra step
    writes the last proposal's KV, so a fully accepted round leaves no
    draft-cache hole) plus one ``(k+1)``-token target forward.
    ``with_stats=True`` returns ``(tokens, {"rounds": [B], "accepted":
    [B]})``.
    """
    t_cfg, d_cfg = target.config, draft.config
    if t_cfg.vocab_size != d_cfg.vocab_size:
        raise ValueError(
            f"target/draft vocabularies differ: {t_cfg.vocab_size} vs {d_cfg.vocab_size}"
        )
    k = int(speculate_k)
    if k < 1:
        raise ValueError(f"speculate_k must be >= 1, got {k}")

    @torch.inference_mode()
    def generate(target_params, draft_params, tokens, true_lens=None):
        # a placed target (or draft) runs on its local shards
        target_params, draft_params = localize_params(target_params), localize_params(draft_params)
        dev = _params_device(target_params)
        tokens = torch.as_tensor(tokens, device=dev).long()
        batch, prompt_len = tokens.shape
        # + k + 1 slack: a round writes up to k+1 rows past a row's fill
        total = (max_len or (prompt_len + max_new_tokens)) + k + 1
        rows = torch.arange(batch, device=dev)
        t_cache = init_cache(cache_config(t_cfg, target_params), batch, total, device=dev)
        d_cache = init_cache(cache_config(d_cfg, draft_params), batch, total, device=dev)
        if true_lens is None:
            true_lens = torch.full((batch,), prompt_len, dtype=torch.long, device=dev)
        else:
            true_lens = torch.as_tensor(true_lens, device=dev).long()
        # the head on each row's last REAL position only
        t_logits, t_cache = target(
            target_params, tokens, cache=t_cache, cache_index=0, logit_index=true_lens - 1,
        )
        _, d_cache = draft(
            draft_params, tokens, cache=d_cache, cache_index=0,
            logit_index=torch.zeros(batch, dtype=torch.long, device=dev),
        )
        first = torch.argmax(t_logits[:, 0], -1)

        out = torch.full((batch, max_new_tokens + k + 1), pad_id, dtype=torch.long, device=dev)
        out[:, 0] = first
        fill = true_lens.clone()
        last = first
        done = torch.full((batch,), max_new_tokens <= 1, dtype=torch.bool, device=dev)
        if eos_id is not None:
            done = done | (first == eos_id)
        emitted = torch.ones(batch, dtype=torch.long, device=dev)
        n_rounds = torch.zeros(batch, dtype=torch.long, device=dev)
        acc_total = torch.zeros(batch, dtype=torch.long, device=dev)
        steps = torch.arange(k + 1, device=dev)[None, :]

        # every live row emits at least one token per round
        while not bool(done.all()):
            tok, f, props = last, fill, []
            for _ in range(k + 1):
                logits, d_cache = draft(draft_params, tok[:, None], cache=d_cache, cache_index=f)
                tok = torch.argmax(logits[:, -1], -1)
                props.append(tok)
                f = f + 1
            proposals = torch.stack(props[:k], dim=1)                     # [B, k]

            verify_in = torch.cat([last[:, None], proposals], dim=1)
            v_logits, t_cache = target(target_params, verify_in, cache=t_cache, cache_index=fill)
            greedy = torch.argmax(v_logits, -1)                           # [B, k+1]
            accepted, correction, emit_toks = greedy_acceptance(proposals, greedy)
            emit_len = torch.where(done, 0, accepted + 1)

            pos = emitted[:, None] + steps
            valid = steps < emit_len[:, None]
            if eos_id is not None:
                # nothing after the first eos of the round is emitted
                is_eos = (emit_toks == eos_id).long()
                after_eos = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
                valid = valid & ~after_eos
            emit_count = valid.sum(dim=1)
            safe_pos = torch.where(valid, pos, out.shape[1] - 1)
            out[rows[:, None], safe_pos] = torch.where(
                valid, emit_toks, out[rows[:, None], safe_pos]
            )

            new_emitted = emitted + emit_count
            new_done = done | (new_emitted >= max_new_tokens)
            if eos_id is not None:
                new_done = new_done | (valid & (emit_toks == eos_id)).any(dim=1)
            fill = torch.where(done, fill, fill + accepted + 1)
            last = torch.where(done, last, correction)
            n_rounds = n_rounds + (~done).long()
            acc_total = acc_total + torch.where(done, 0, accepted)
            emitted, done = new_emitted, new_done
        toks = out[:, :max_new_tokens]
        if with_stats:
            return toks, {"rounds": n_rounds, "accepted": acc_total}
        return toks

    return generate


def make_speculative_predictor(
    target: Llama,
    draft: Llama,
    *,
    max_new_tokens: int = 32,
    bucket_lens: tuple = (16, 32, 64, 128),
    speculate_k: int = 4,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
) -> Callable:
    """An ``@model.predictor``-compatible fn with speculative decoding.

    Ragged token-id prompts are RIGHT-padded to the smallest covering
    bucket and the batch to the next power of two (pad rows replicate the
    last prompt), with per-row true lengths keeping padded rows exact.
    ``state`` must carry the paired trees as a mapping ``{"target": ...,
    "draft": ...}`` (or an object whose ``.params`` holds it). Output trims
    at ``eos_id`` when set. ``.warmup(state, max_batch=...)`` runs every
    (bucket, power-of-two batch) once.
    """
    buckets = tuple(sorted(set(int(b) for b in bucket_lens)))
    gens = {
        b: make_speculative_generator(
            target, draft, max_new_tokens=max_new_tokens, speculate_k=speculate_k,
            max_len=b + max_new_tokens, eos_id=eos_id, pad_id=pad_id,
        )
        for b in buckets
    }

    def predictor(state, prompts) -> list:
        params = resolve_params(state)
        if not isinstance(params, Mapping) or "target" not in params or "draft" not in params:
            raise ValueError(
                'speculative predictor state must be a mapping {"target": params, "draft": params}'
            )
        rows = [np.asarray(p, dtype=np.int64).ravel() for p in prompts]
        if any(len(r) == 0 for r in rows):
            raise ValueError("empty prompt")
        longest = max(len(r) for r in rows)
        bucket = next((b for b in buckets if b >= longest), None)
        if bucket is None:
            raise ValueError(
                f"prompt length {longest} exceeds the largest bucket {buckets[-1]}; "
                "add a larger bucket to bucket_lens"
            )
        n = len(rows)
        n_padded = 1 << (n - 1).bit_length()
        batch = np.full((n_padded, bucket), pad_id, np.int64)
        true_lens = np.ones((n_padded,), np.int64)
        for i in range(n_padded):
            r = rows[min(i, n - 1)]
            batch[i, : len(r)] = r
            true_lens[i] = len(r)
        out = gens[bucket](
            params["target"], params["draft"], torch.from_numpy(batch),
            torch.from_numpy(true_lens),
        ).cpu().tolist()
        results = []
        for toks in out[:n]:
            if eos_id is not None and eos_id in toks:
                toks = toks[: toks.index(eos_id) + 1]
            results.append(toks)
        return results

    def warmup(state, *, max_batch: int = 8, buckets: Optional[tuple] = None,
               _all=buckets) -> int:
        if buckets is not None and not buckets:
            raise ValueError(
                "warmup got an empty bucket tuple — pass buckets=None to warm every "
                "configured bucket"
            )
        use = _all if buckets is None else tuple(buckets)
        unknown = sorted(set(use) - set(_all))
        if unknown:
            raise ValueError(f"warmup buckets {unknown} are not configured ({_all})")
        ran = 0
        top = 1 << (max(1, max_batch) - 1).bit_length()
        for b in use:
            size = 1
            while size <= top:
                predictor(state, np.ones((size, b), np.int64))
                ran += 1
                size *= 2
        return ran

    predictor.warmup = warmup
    return predictor
