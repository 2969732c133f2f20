"""Encoder-decoder transformer — the seq2seq family of the model zoo.

The port of :mod:`unionml_tpu.models.encdec`, with its choices kept:

- pre-LN blocks (RMSNorm, fp32 statistics), compute in ``dtype``, a shared
  source / target embedding and an fp32 LM head with a bias;
- the encoder's self-attention is bidirectional, through the cross path
  (``kv=h`` with the source mask): padded source tokens are hidden by the
  fp32 bias ``where(mask, 0, -1e30)``;
- the decoder's self-attention carries RoPE and the same KV cache as the
  Llama generator; its cross-attention is position-free and fully
  visible, masked only by the source mask, with k / v recomputed from the
  encoder output at every step (there is no cross-KV cache, as in the
  reference);
- every attention runs the full-score ``xla`` path and the plain RMSNorm,
  so the module reaches no kernel.

Weights are the reference's param tree (``params["enc_0"]["attn"]["q"]
["kernel"]``, ``params["lm_head"]["bias"]``; bridged by
:func:`~unionml_tpu_torch.models.convert.encdec_from_jax_params`) passed
to each call. A tree placed by :data:`ENCDEC_PARTITION_RULES` is served
on each rank's local shards, as :class:`~unionml_tpu_torch.models.llama
.Llama` serves one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device, torch_dtype
from unionml_tpu_torch.models.layers import (
    _TP,
    Attention,
    MlpBlock,
    RMSNorm,
    _site_width,
    gather_rows,
    local_forward,
    local_embed,
)
from unionml_tpu_torch.parallel.sharding import PartitionRule

Cache = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


@dataclass(frozen=True)
class EncDecConfig:
    vocab_size: int = 32_128
    hidden_dim: int = 768
    num_encoder_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 2048
    rope_theta: float = 10_000.0
    max_len: int = 512
    dtype: str = "bfloat16"

    @staticmethod
    def tiny(vocab_size: int = 512, **overrides) -> "EncDecConfig":
        kwargs = dict(vocab_size=vocab_size, hidden_dim=64, num_encoder_layers=2,
                      num_decoder_layers=2, num_heads=4, mlp_dim=128, max_len=64)
        kwargs.update(overrides)
        return EncDecConfig(**kwargs)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads


class _EncoderBlock(nn.Module):
    def __init__(self, cfg: EncDecConfig):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        self.attn_norm = RMSNorm(dtype=dtype)
        self.attn = Attention(cfg.num_heads, head_dim=cfg.head_dim, features=cfg.hidden_dim,
                              rope=False, causal=False, dtype=dtype)
        self.mlp_norm = RMSNorm(dtype=dtype)
        self.mlp = MlpBlock(cfg.mlp_dim, cfg.hidden_dim, gated=True, dtype=dtype)

    def forward(self, params, x, src_mask):
        h = self.attn_norm(params["attn_norm"], x)
        # bidirectional: the source's padding hidden through the kv path
        x = x + self.attn(params["attn"], h, kv=h, kv_mask=src_mask)
        h = self.mlp_norm(params["mlp_norm"], x)
        return x + self.mlp(params["mlp"], h)


class _DecoderBlock(nn.Module):
    def __init__(self, cfg: EncDecConfig):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        self.self_norm = RMSNorm(dtype=dtype)
        self.self_attn = Attention(cfg.num_heads, head_dim=cfg.head_dim,
                                   features=cfg.hidden_dim, rope=True,
                                   rope_theta=cfg.rope_theta, causal=True, dtype=dtype)
        self.cross_norm = RMSNorm(dtype=dtype)
        self.cross_attn = Attention(cfg.num_heads, head_dim=cfg.head_dim,
                                    features=cfg.hidden_dim, rope=False, causal=False,
                                    dtype=dtype)
        self.mlp_norm = RMSNorm(dtype=dtype)
        self.mlp = MlpBlock(cfg.mlp_dim, cfg.hidden_dim, gated=True, dtype=dtype)

    def forward(self, params, x, enc_out, src_mask, *, cache=None, cache_index=None):
        h = self.self_norm(params["self_norm"], x)
        if cache is not None:
            a, new_cache = self.self_attn(params["self_attn"], h, cache=cache,
                                          cache_index=cache_index)
        else:
            a, new_cache = self.self_attn(params["self_attn"], h), None
        x = x + a
        h = self.cross_norm(params["cross_norm"], x)
        x = x + self.cross_attn(params["cross_attn"], h, kv=enc_out, kv_mask=src_mask)
        h = self.mlp_norm(params["mlp_norm"], x)
        return x + self.mlp(params["mlp"], h), new_cache


class EncoderDecoder(nn.Module):
    """Seq2seq transformer with a shared source / target embedding.

    - training: ``module(params, src_ids, tgt_ids, src_mask=...)`` →
      decoder logits [B, S_tgt, V] fp32 (teacher forcing; shift outside);
    - encode once: ``module.encode(params, src_ids, src_mask=...)``;
    - a cached decode step: ``module.decode(params, tgt_tok, enc_out,
      src_mask, cache, cache_index)`` → ``(logits, cache)``, the cache
      written in place.
    """

    def __init__(self, config: EncDecConfig = EncDecConfig()):
        super().__init__()
        self.config = config
        self.dtype = torch_dtype(config.dtype)
        self.enc_blocks = nn.ModuleList(_EncoderBlock(config)
                                        for _ in range(config.num_encoder_layers))
        self.enc_norm = RMSNorm(dtype=self.dtype)
        self.dec_blocks = nn.ModuleList(_DecoderBlock(config)
                                        for _ in range(config.num_decoder_layers))
        self.dec_norm = RMSNorm(dtype=self.dtype)

    def init(self, generator: torch.Generator, example_input: torch.Tensor) -> dict:
        """Random fp32 params on ``example_input``'s device
        (:func:`init_params` with a seed drawn from ``generator``)."""
        seed = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
        return init_params(self.config, seed=seed, device=example_input.device)

    def _embed(self, params, ids):
        table = params["embed"]["embedding"]
        tp = _TP.get()
        if tp is None:
            return gather_rows(table, ids.long()).to(self.dtype)
        return local_embed(tp, table, ids.long(), self.config.vocab_size).to(self.dtype)

    def encode(self, params, src_ids, *, src_mask=None):
        with local_forward(params, src_ids) as params:
            if src_mask is None:
                src_mask = torch.ones(src_ids.shape, dtype=torch.bool, device=src_ids.device)
            x = self._embed(params, src_ids)
            for i, block in enumerate(self.enc_blocks):
                x = block(params[f"enc_{i}"], x, src_mask)
            return self.enc_norm(params["enc_norm"], x)

    def decode(self, params, tgt_ids, enc_out, src_mask=None, cache=None, cache_index=None):
        with local_forward(params, tgt_ids) as params:
            if src_mask is None:
                src_mask = torch.ones(enc_out.shape[:2], dtype=torch.bool, device=enc_out.device)
            x = self._embed(params, tgt_ids)
            new_cache = []
            for i, block in enumerate(self.dec_blocks):
                x, c = block(params[f"dec_{i}"], x, enc_out, src_mask,
                             cache=cache[i] if cache is not None else None,
                             cache_index=cache_index)
                new_cache.append(c)
            x = self.dec_norm(params["dec_norm"], x)
            logits = self._head(params["lm_head"], x.float())
            if cache is not None:
                return logits, tuple(new_cache)
            return logits

    def _head(self, p, x):
        """The fp32 LM head and its bias; a vocab-sharded kernel's blocks
        gathered whole before the bias is added."""
        y = torch.tensordot(x, p["kernel"].float(), dims=([x.dim() - 1], [0]))
        tp = _TP.get()
        if tp is not None and _site_width(p) < self.config.vocab_size:
            y = tp.gather(y, -1)
        return y + p["bias"].float()

    def forward(self, params, src_ids, tgt_ids, *, src_mask=None):
        with local_forward(params, src_ids) as params:
            enc_out = self.encode(params, src_ids, src_mask=src_mask)
            return self.decode(params, tgt_ids, enc_out, src_mask)


def init_params(config: EncDecConfig, *, seed: int = 0, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> dict:
    """A random fp param tree in the reference's layout on ``device``
    (``None`` = CUDA, raising without one) from a generator there seeded
    with ``seed``: kernels normal with std 1/sqrt(fan_in), the embedding
    normal with std 1/sqrt(hidden), norm scales one, the LM head's bias
    zero. (Parity tests carry JAX weights over with
    :func:`~unionml_tpu_torch.models.convert.encdec_from_jax_params`.)"""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = config
    d, h, hd = c.hidden_dim, c.num_heads, c.head_dim

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * fan_in**-0.5).to(dtype)

    def norm():
        return {"scale": torch.ones(d, device=dev, dtype=dtype)}

    def attn():
        return {"q": {"kernel": normal((d, h, hd), d)}, "k": {"kernel": normal((d, h, hd), d)},
                "v": {"kernel": normal((d, h, hd), d)},
                "o": {"kernel": normal((h, hd, d), h * hd)}}

    def mlp():
        return {"gate": {"kernel": normal((d, c.mlp_dim), d)},
                "up": {"kernel": normal((d, c.mlp_dim), d)},
                "down": {"kernel": normal((c.mlp_dim, d), c.mlp_dim)}}

    params: dict = {"embed": {"embedding": normal((c.vocab_size, d), d)}}
    for i in range(c.num_encoder_layers):
        params[f"enc_{i}"] = {"attn_norm": norm(), "attn": attn(), "mlp_norm": norm(),
                              "mlp": mlp()}
    params["enc_norm"] = norm()
    for i in range(c.num_decoder_layers):
        params[f"dec_{i}"] = {"self_norm": norm(), "self_attn": attn(), "cross_norm": norm(),
                              "cross_attn": attn(), "mlp_norm": norm(), "mlp": mlp()}
    params["dec_norm"] = norm()
    params["lm_head"] = {"kernel": normal((d, c.vocab_size), d),
                         "bias": torch.zeros(c.vocab_size, device=dev, dtype=dtype)}
    return params


def init_decoder_cache(config: EncDecConfig, batch: int, max_len: Optional[int] = None,
                       dtype: Any = torch.bfloat16, device: DeviceLike = None,
                       num_heads: Optional[int] = None) -> Cache:
    """Zero-filled decoder self-attention cache (cross attention needs
    none): per decoder layer (k, v) of [batch, max_len, heads, head_dim],
    each its own allocation (written in place). ``num_heads``: a rank's
    local heads under tensor parallelism (default: the config's)."""
    dev = resolve_device(device)
    shape = (batch, max_len or config.max_len, num_heads or config.num_heads, config.head_dim)
    dt = torch_dtype(dtype)
    return tuple((torch.zeros(shape, dtype=dt, device=dev), torch.zeros(shape, dtype=dt, device=dev))
                 for _ in range(config.num_decoder_layers))


def make_seq2seq_generator(
    module: EncoderDecoder,
    *,
    max_new_tokens: int,
    bos_id: int = 1,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> Callable:
    """Build ``generate(params, src_ids, generator=None, src_mask=None) ->
    tokens [B, max_new_tokens]`` (int64, on the weights' device): encode
    once, then one decode step a token over the self-attention cache (in
    the module's compute dtype), ``bos_id`` first. Sampling as
    :func:`~unionml_tpu_torch.models.generate.make_sampler`; temperature
    sampling needs a :class:`torch.Generator` (the reference's PRNG key)."""
    from unionml_tpu_torch.models.generate import _params_device, make_sampler
    from unionml_tpu_torch.models.layers import LocalParams, localize_params

    cfg = module.config
    sample = make_sampler(temperature=temperature, top_k=top_k, top_p=top_p)
    total = max_new_tokens + 1  # bos takes row 0

    @torch.inference_mode()
    def generate(params, src_ids, generator=None, src_mask=None) -> torch.Tensor:
        if temperature != 0.0 and generator is None:
            raise ValueError("temperature sampling needs an explicit torch.Generator: "
                             "generate(params, src_ids, generator)")
        params = localize_params(params)
        dev = _params_device(params)
        src_ids = torch.as_tensor(src_ids, device=dev).long()
        if src_mask is not None:
            src_mask = torch.as_tensor(src_mask, device=dev).bool()
        batch = src_ids.shape[0]
        enc_out = module.encode(params, src_ids, src_mask=src_mask)
        heads = None
        if isinstance(params, LocalParams):
            heads = _site_width(params["dec_0"]["self_attn"]["q"]) // cfg.head_dim
        cache = init_decoder_cache(cfg, batch, total, dtype=cfg.dtype, device=dev,
                                   num_heads=heads)
        tok = torch.full((batch, 1), bos_id, dtype=torch.long, device=dev)
        done = torch.zeros(batch, dtype=torch.bool, device=dev)
        out = []
        for index in range(max_new_tokens):
            logits, cache = module.decode(params, tok, enc_out, src_mask, cache, index)
            nxt = sample(logits[:, -1], generator)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
                done = done | (nxt == eos_id)
            out.append(nxt)
            tok = nxt[:, None]
        return torch.stack(out, dim=1)

    return generate


def seq2seq_step(module: EncoderDecoder, *, ignore_id: int = -100, pad_id: int = 0,
                 accumulate_steps: int = 1) -> Callable:
    """Teacher-forced seq2seq training step, ``(state, batch) -> (state,
    metrics)``: ``batch = (src_ids, tgt_ids)``; the decoder reads
    ``tgt_ids[:, :-1]`` and is supervised on ``tgt_ids[:, 1:]``, positions
    at ``ignore_id`` left out of the mean cross entropy; ``src_ids ==
    pad_id`` is hidden from every attention over the source.
    ``accumulate_steps > 1``: the batch carries a leading microbatch axis."""
    from unionml_tpu_torch.models.train import (
        _bind_frozen,
        accumulated_value_and_grad,
        masked_cross_entropy,
        value_and_grad,
    )

    def loss_fn(params, microbatch):
        src_ids, tgt_ids = microbatch
        inputs, targets = tgt_ids[:, :-1], tgt_ids[:, 1:]
        logits = module(params, src_ids, inputs, src_mask=src_ids != pad_id)
        loss = masked_cross_entropy(logits, targets, ignore_id=ignore_id)
        return loss, {"z": torch.zeros((), dtype=torch.float32, device=loss.device)}

    def step(state, batch):
        bound = _bind_frozen(loss_fn, state)
        if accumulate_steps > 1:
            (loss, _), grads = accumulated_value_and_grad(bound, state.params, batch)
        else:
            (loss, _), grads = value_and_grad(bound, state.params, batch)
        state = state.apply_gradients(grads=grads)
        return state, {"loss": loss, "perplexity": torch.exp(loss)}

    return step


def make_seq2seq_predictor(
    module: EncoderDecoder,
    *,
    max_new_tokens: int = 32,
    src_buckets: tuple = (16, 32, 64, 128),
    bos_id: int = 1,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    seed: int = 0,
    **gen_kwargs,
) -> Callable:
    """An ``@model.predictor``-compatible fn over token-id sources: ragged
    sources right-padded to the smallest covering bucket (masked out of
    every attention, so a padded source generates what its unpadded form
    does), the batch padded to the next power of two, one token list per
    source back, trimmed after ``eos_id`` when set. A source longer than
    the largest bucket raises. ``.warmup(state, max_batch=, buckets=)``
    runs every (bucket, power-of-two batch) shape once."""
    from unionml_tpu_torch.models.train import resolve_params

    buckets = tuple(sorted(set(int(b) for b in src_buckets)))
    gen = make_seq2seq_generator(module, max_new_tokens=max_new_tokens, bos_id=bos_id,
                                 eos_id=eos_id, pad_id=pad_id, **gen_kwargs)
    temperature = gen_kwargs.get("temperature", 0.0)
    rngs: dict = {}

    def predictor(state, sources) -> list:
        params = resolve_params(state)
        rows = [np.asarray(s, dtype=np.int64).ravel() for s in sources]
        longest = max(len(r) for r in rows)
        if longest > buckets[-1]:
            raise ValueError(f"source length {longest} exceeds the largest configured "
                             f"bucket {buckets[-1]}; add a larger bucket to src_buckets")
        bucket = next(b for b in buckets if b >= longest)
        n = len(rows)
        n_padded = 1 << (n - 1).bit_length()
        batch = np.full((n_padded, bucket), pad_id, np.int64)
        mask = np.zeros((n_padded, bucket), bool)
        for i in range(n_padded):
            r = rows[min(i, n - 1)]
            batch[i, :len(r)] = r
            mask[i, :len(r)] = True
        generator = None
        if temperature != 0.0:
            from unionml_tpu_torch.models.generate import _params_device

            dev = _params_device(params)
            if dev not in rngs:
                rngs[dev] = torch.Generator(device=dev).manual_seed(seed)
            generator = rngs[dev]
        out = gen(params, torch.from_numpy(batch), generator, torch.from_numpy(mask))
        results = []
        for row in out[:n].cpu().tolist():
            if eos_id is not None and eos_id in row:
                row = row[:row.index(eos_id) + 1]
            results.append(row)
        return results

    def warmup(state, *, max_batch: int = 8, buckets: Optional[tuple] = None,
               _all=buckets) -> int:
        if buckets is not None and not buckets:
            raise ValueError("warmup got an empty bucket tuple — pass buckets=None to warm "
                             "every configured bucket")
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


# Megatron-style tensor parallelism over ``tensor``: q/k/v/gate/up shard
# their output features, o/down their input features (one sum after each
# attention's o and each MLP's down); the shared embedding and the head
# shard the vocab.
ENCDEC_PARTITION_RULES = (
    PartitionRule(r"(self_attn|cross_attn|attn)/(q|k|v)/kernel$", (None, "tensor", None)),
    PartitionRule(r"(self_attn|cross_attn|attn)/o/kernel$", ("tensor", None, None)),
    PartitionRule(r"mlp/(gate|up)/kernel$", (None, "tensor")),
    PartitionRule(r"mlp/down/kernel$", ("tensor", None)),
    PartitionRule(r"embed/embedding$", ("tensor", None)),
    PartitionRule(r"lm_head/kernel$", (None, "tensor")),
)
