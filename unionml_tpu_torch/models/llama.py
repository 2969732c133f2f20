"""Llama-3-style decoder in PyTorch — the serving flagship.

The port of :mod:`unionml_tpu.models.llama`: RMSNorm, rotary embeddings,
grouped-query attention, SwiGLU MLP, untied fp32 LM head. Weights are
the reference's param tree (nested dicts with the flax names) passed to
``forward``; :func:`init_params` (or ``Llama.init``, what
:func:`~unionml_tpu_torch.models.train.create_train_state` calls) makes a
random tree of that layout on a device, and :func:`init_cache` the KV
cache. Only the dense model is ported, with int8 or packed-int4
(``weight_bits=4``) weight-only matmuls, the int8 KV cache
(``kv_quant``), the block-paged decode step (``block_table=``) and, for
training, per-block recomputation (``remat``) and LoRA adapters on an fp
or int8 base (``lora_rank``, :mod:`~unionml_tpu_torch.models.lora`): MoE
raises ``NotImplementedError``. :data:`LLAMA_PARTITION_RULES`,
:data:`LLAMA_QUANT_PARTITION_RULES` and :data:`LLAMA_LORA_PARTITION_RULES`
are the reference's tensor-parallel layouts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from unionml_tpu_torch._device import DeviceLike, resolve_device, torch_dtype
from unionml_tpu_torch.models.layers import (
    Attention,
    MlpBlock,
    RMSNorm,
    gather_rows,
    make_dense,
)
from unionml_tpu_torch.parallel.sharding import PartitionRule

# per layer (k, v), or (k_q, v_q, k_scale, v_scale) under kv_quant
Cache = Tuple[Tuple[torch.Tensor, ...], ...]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden_dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    mlp_dim: int = 14_336
    rope_theta: float = 500_000.0
    # llama3-type long-context RoPE rescale (factor, low_freq_factor,
    # high_freq_factor, original_max_len)
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    norm_eps: float = 1e-5
    max_len: int = 8192
    attn_impl: str = "xla"
    # attention for FULL prefills: "flash" runs the padded flash kernel
    # over the fresh k/v; "cached" keeps the masked cached-attention path
    prefill_impl: str = "cached"
    # decode attention over a BLOCK-PAGED pool (block_table=): "pallas" =
    # the hand-written CUDA kernel (ops/paged_attention.py), "reference" =
    # its plain version, "auto" = the kernel for CUDA tensors and the
    # plain version for CPU ones (the reference's names, so configs carry
    # over)
    paged_impl: str = "auto"
    # "fused" = the fused RMSNorm kernel (ops/fused_norm.py)
    norm_impl: str = "xla"
    quantized: bool = False  # weight-only quantized matmuls (serving path)
    # 8 = int8; 4 = packed int4 through the int4 kernel (ops/int4_matmul.py)
    weight_bits: int = 8
    # weight_bits=4 only: int4_group > 0 = group-wise scales [K/g, N]
    # (quantize_params(group_size=...) must match); int4_tp = the tensor
    # degree the packing tiles survive (quantize_params(tensor=...))
    int4_group: int = 0
    int4_tp: int = 1
    # gradient checkpointing per block (long-context training): the
    # cache-free forward recomputes each block's activations in the
    # backward instead of keeping them
    remat: bool = False
    num_experts: int = 0
    # > 0: trainable rank-r adapters on q/k/v/o and gate/up/down
    # (models/lora.py); with quantized=True the QLoRA configuration. The
    # LM head and the embedding carry none.
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # int8 KV cache (generation paths): per-(position, kv_head) fp32
    # scales; init_cache builds the quantized layout and Attention infers
    # it from the cache structure
    kv_quant: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.num_experts:
            raise NotImplementedError(
                "LlamaConfig num_experts is not ported to unionml_tpu_torch "
                "(see ROADMAP.md)"
            )
        if self.weight_bits not in (4, 8):
            raise ValueError(f"weight_bits must be 8 or 4, got {self.weight_bits}")

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama_lc(**overrides) -> "LlamaConfig":
        """The long-context training Llama of
        ``benchmarks/train_throughput.py`` (124.7M params): 12 layers of
        width 768, GQA 12/4 at head_dim 64, MLP 2048, vocab 32000, flash
        attention, trained on 2 x 4096 tokens."""
        kwargs = dict(
            vocab_size=32_000, hidden_dim=768, num_layers=12, num_heads=12,
            num_kv_heads=4, mlp_dim=2048, max_len=4096, attn_impl="flash",
        )
        kwargs.update(overrides)
        return LlamaConfig(**kwargs)

    @staticmethod
    def tiny(vocab_size: int = 512, **overrides) -> "LlamaConfig":
        kwargs = dict(
            vocab_size=vocab_size, hidden_dim=64, num_layers=2, num_heads=4,
            num_kv_heads=2, mlp_dim=128, max_len=256, rope_theta=10_000.0,
        )
        kwargs.update(overrides)
        return LlamaConfig(**kwargs)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        cfg = config
        dtype = torch_dtype(cfg.dtype)
        self.attn_norm = RMSNorm(eps=cfg.norm_eps, dtype=dtype, impl=cfg.norm_impl)
        self.attn = Attention(
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            features=cfg.hidden_dim, rope=True, rope_theta=cfg.rope_theta,
            rope_scaling=cfg.rope_scaling, causal=True, attn_impl=cfg.attn_impl,
            prefill_impl=cfg.prefill_impl, paged_impl=cfg.paged_impl,
            quantized=cfg.quantized, weight_bits=cfg.weight_bits,
            int4_group=cfg.int4_group, int4_tp=cfg.int4_tp, lora_rank=cfg.lora_rank,
            lora_alpha=cfg.lora_alpha, dtype=dtype,
        )
        self.mlp_norm = RMSNorm(eps=cfg.norm_eps, dtype=dtype, impl=cfg.norm_impl)
        self.mlp = MlpBlock(
            cfg.mlp_dim, cfg.hidden_dim, gated=True, quantized=cfg.quantized,
            weight_bits=cfg.weight_bits, int4_group=cfg.int4_group, int4_tp=cfg.int4_tp,
            lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha, dtype=dtype,
        )

    def forward(self, params, x, *, positions=None, cache=None, cache_index=None,
                kv_mask=None, block_table=None, full_prefill=False):
        h = self.attn_norm(params["attn_norm"], x)
        if cache is not None:
            a, new_cache = self.attn(
                params["attn"], h, positions=positions, cache=cache,
                cache_index=cache_index, kv_mask=kv_mask,
                block_table=block_table, full_prefill=full_prefill,
            )
        else:
            if kv_mask is not None:
                raise ValueError(
                    "kv_mask requires a KV cache (generation path); the "
                    "non-cache attention path has no mask plumbing"
                )
            a, new_cache = self.attn(params["attn"], h, positions=positions), None
        x = x + a
        h = self.mlp_norm(params["mlp_norm"], x)
        x = x + self.mlp(params["mlp"], h)
        return x, new_cache


class Llama(nn.Module):
    """The decoder. ``forward(params, tokens, ...)`` with ``params`` the
    reference's param tree (``params["block_0"]["attn"]["q"]...``).

    The LM head runs in fp32, as in the reference. On the card that needs
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default;
    ``chip_smoke.py`` sets it explicitly): TF32 would keep ~3 digits."""

    def __init__(self, config: LlamaConfig = LlamaConfig()):
        super().__init__()
        self.config = config
        self.dtype = torch_dtype(config.dtype)
        self.blocks = nn.ModuleList(LlamaBlock(config) for _ in range(config.num_layers))
        self.final_norm = RMSNorm(eps=config.norm_eps, dtype=self.dtype, impl=config.norm_impl)
        # the LM head is row-parallel under int4 tensor parallelism (K
        # sharded), so its packing ignores int4_tp (shards=1)
        self.lm_head = make_dense(
            quantized=config.quantized, features=config.vocab_size, dtype=torch.float32,
            weight_bits=config.weight_bits, int4_group=config.int4_group,
        )

    def init(self, generator: torch.Generator, example_input: torch.Tensor) -> dict:
        """Random fp32 params for this config on ``example_input``'s device
        (:func:`init_params` with a seed drawn from ``generator``); the
        example fixes nothing else."""
        seed = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
        return init_params(self.config, seed=seed, device=example_input.device)

    def forward(
        self,
        params,
        tokens: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        cache_index=None,
        kv_mask: Optional[torch.Tensor] = None,
        block_table: Optional[torch.Tensor] = None,
        logit_index: Optional[torch.Tensor] = None,
        full_prefill: bool = False,
    ):
        """logits [B,S,V] fp32; with ``cache`` returns (logits, cache).

        ``block_table``: int [B, table_width] — marks ``cache`` as a
        block-paged pool (per layer [num_blocks, block, kv_heads, ...])
        addressed through the table; decode steps only (``seq == 1``,
        vector ``cache_index``). See :class:`~unionml_tpu_torch.models
        .layers.Attention`.

        ``kv_mask``: bool (batch, max_len), False cache slots are never
        attended to. ``logit_index``: optional int [B] — the LM head runs
        on that one position per row (logits [B, 1, V]). ``full_prefill``:
        the caller's promise that this cached call covers the whole
        visible history (see :class:`~unionml_tpu_torch.models.layers
        .Attention`).
        """
        cfg = self.config
        x = gather_rows(params["embed"]["embedding"], tokens.long()).to(self.dtype)
        if positions is None and cache_index is not None:
            if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
                base = cache_index[:, None]
            else:
                base = int(cache_index)
            positions = base + torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        new_cache = []
        # remat: recompute each block's activations in the backward instead
        # of storing them; the cache path (decode) has no backward
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            if remat:
                x, c = checkpoint(block, params[f"block_{i}"], x, positions=positions,
                                  kv_mask=kv_mask, use_reentrant=False)
            else:
                x, c = block(
                    params[f"block_{i}"], x, positions=positions,
                    cache=cache[i] if cache is not None else None,
                    cache_index=cache_index, kv_mask=kv_mask,
                    block_table=block_table, full_prefill=full_prefill,
                )
            new_cache.append(c)
        if logit_index is not None:
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, logit_index.long()][:, None, :]         # [B, 1, D]
        x = self.final_norm(params["final_norm"], x)
        logits = self.lm_head(params["lm_head"], x.float())
        if cache is not None:
            return logits, tuple(new_cache)
        return logits


def assert_int4_tp_compatible(config: LlamaConfig, tensor: int) -> None:
    """Refuse tensor-parallel degrees whose per-device channel ranges split
    an int4 packing tile — a misaligned shard pairs nibbles with the wrong
    output channels and decodes garbage with no exception. With
    ``config.int4_tp`` set (the degree ``quantize_params(tensor=...)``
    packed for), any ``tensor`` dividing it is slab-aligned. The LM head is
    exempt: it shards K. (Tensor parallelism itself is not ported yet;
    this is the guard it will call.)"""
    from unionml_tpu_torch.ops.int4_matmul import tile_for

    if tensor <= 1 or config.weight_bits != 4:
        return
    # column-parallel sites only (o/down/lm_head shard K)
    sites = (
        ("attn/q", config.num_heads * config.head_dim, config.hidden_dim),
        ("attn/k", config.num_kv_heads * config.head_dim, config.hidden_dim),
        ("mlp/gate", config.mlp_dim, config.hidden_dim),
    )
    for name, n, k in sites:
        tile = tile_for(n, k, shards=config.int4_tp)
        if tile and (n // tensor) % tile:
            raise ValueError(
                f"int4 layer {name}: {n} channels / tensor={tensor} = "
                f"{n // tensor} per device, not a multiple of the packing "
                f"tile {tile} (tree packed for int4_tp={config.int4_tp}) — "
                "the shard would unpack wrong channels. Re-quantize with "
                f"quantize_params(tensor={tensor}) and "
                f"LlamaConfig(int4_tp={tensor}), serve at a divisor of "
                f"{config.int4_tp}, or serve this model int8."
            )


def init_params(
    config: LlamaConfig,
    *,
    seed: int = 0,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """A random fp param tree in the reference's layout, made on ``device``
    (``None`` = CUDA, raising without one) from a generator there seeded
    with ``seed``: kernels normal with std 1/sqrt(fan_in),
    embedding normal with std 1/sqrt(hidden), norm scales one; with
    ``lora_rank > 0`` also the adapters of
    :func:`~unionml_tpu_torch.models.lora.init_lora_params`, drawn after
    the base. (The reference draws flax's initializers from a JAX key; the
    two give different numbers, so parity tests carry JAX weights over
    with :func:`~unionml_tpu_torch.models.convert.from_jax_params`.)"""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = config
    d, hd = cfg.hidden_dim, cfg.head_dim

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * fan_in**-0.5).to(dtype)

    def ones(n):
        return torch.ones(n, device=dev, dtype=dtype)

    params = {"embed": {"embedding": normal((cfg.vocab_size, d), d)}}
    for i in range(cfg.num_layers):
        params[f"block_{i}"] = {
            "attn_norm": {"scale": ones(d)},
            "attn": {
                "q": {"kernel": normal((d, cfg.num_heads, hd), d)},
                "k": {"kernel": normal((d, cfg.num_kv_heads, hd), d)},
                "v": {"kernel": normal((d, cfg.num_kv_heads, hd), d)},
                "o": {"kernel": normal((cfg.num_heads, hd, d), cfg.num_heads * hd)},
            },
            "mlp_norm": {"scale": ones(d)},
            "mlp": {
                "gate": {"kernel": normal((d, cfg.mlp_dim), d)},
                "up": {"kernel": normal((d, cfg.mlp_dim), d)},
                "down": {"kernel": normal((cfg.mlp_dim, d), cfg.mlp_dim)},
            },
        }
    params["final_norm"] = {"scale": ones(d)}
    params["lm_head"] = {"kernel": normal((d, cfg.vocab_size), d)}
    if cfg.lora_rank > 0:
        from unionml_tpu_torch.models.lora import init_lora_params, merge_param_trees

        params = merge_param_trees(params, init_lora_params(cfg, gen, dtype=dtype))
    return params


def init_cache(
    config: LlamaConfig,
    batch: int,
    max_len: Optional[int] = None,
    dtype: Any = torch.bfloat16,
    device: DeviceLike = None,
) -> Cache:
    """Zero-filled KV cache: per-layer (k, v) of [B, max_len, kv_heads,
    head_dim] on ``device`` (``None`` = CUDA). With ``config.kv_quant``
    each layer is instead ``(k_q int8, v_q int8, k_scale fp32 [B,
    max_len, kv_heads], v_scale)``, scales one. Every buffer is its own
    allocation: the port writes the cache in place. (The engine's paged
    pool is this cache with ``batch`` = pool blocks and ``max_len`` = the
    block size.)"""
    dev = resolve_device(device)
    max_len = max_len or config.max_len
    shape = (batch, max_len, config.num_kv_heads, config.head_dim)
    if config.kv_quant:
        if torch_dtype(dtype) != torch.bfloat16:
            # the dtype argument governs the bf16 cache form only
            raise ValueError(
                f"kv_quant caches are int8 + fp32 scales; dtype={dtype} "
                "cannot apply (drop the dtype argument or kv_quant)"
            )
        return tuple(
            (torch.zeros(shape, dtype=torch.int8, device=dev),
             torch.zeros(shape, dtype=torch.int8, device=dev),
             torch.ones(shape[:-1], dtype=torch.float32, device=dev),
             torch.ones(shape[:-1], dtype=torch.float32, device=dev))
            for _ in range(config.num_layers)
        )
    return tuple(
        (torch.zeros(shape, dtype=dtype, device=dev),
         torch.zeros(shape, dtype=dtype, device=dev))
        for _ in range(config.num_layers)
    )


LLAMA_PARTITION_RULES = (
    # `$`-anchored so `kernel` never matches the quantized `kernel_q` params
    PartitionRule(r"attn/(q|k|v)/kernel$", (None, "tensor", None)),
    PartitionRule(r"attn/o/kernel$", ("tensor", None, None)),
    PartitionRule(r"mlp/(gate|up)/kernel$", (None, "tensor")),
    PartitionRule(r"mlp/down/kernel$", ("tensor", None)),
    PartitionRule(r"embed/embedding$", ("tensor", None)),
    PartitionRule(r"lm_head/kernel$", (None, "tensor")),
)

# int8 (LlamaConfig.quantized=True): kernels are 2D [K, N] with a
# per-output-channel scale [N]. qkv/gate/up/lm_head shard N (their scales
# shard with it); o/down shard K (their scales replicate).
LLAMA_QUANT_PARTITION_RULES = LLAMA_PARTITION_RULES + (
    PartitionRule(r"attn/(q|k|v)/kernel_q$", (None, "tensor")),
    PartitionRule(r"attn/(q|k|v)/scale$", ("tensor",)),
    PartitionRule(r"attn/o/kernel_q$", ("tensor", None)),
    PartitionRule(r"mlp/(gate|up)/kernel_q$", (None, "tensor")),
    PartitionRule(r"mlp/(gate|up)/scale$", ("tensor",)),
    PartitionRule(r"mlp/down/kernel_q$", ("tensor", None)),
    PartitionRule(r"lm_head/kernel_q$", (None, "tensor")),
    PartitionRule(r"lm_head/scale$", ("tensor",)),
)



def __getattr__(name):
    # LLAMA_LORA_PARTITION_RULES, for LoRA fine-tune configs (lora_rank >
    # 0): adapter factors follow their base kernel's layout, the union
    # covering fp and QLoRA (int8 base) alike. Built on first use, since
    # models.lora imports this module.
    if name == "LLAMA_LORA_PARTITION_RULES":
        from unionml_tpu_torch.models.lora import LORA_PARTITION_RULES

        return LORA_PARTITION_RULES + LLAMA_QUANT_PARTITION_RULES
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
