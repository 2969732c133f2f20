"""The weight bridges: a JAX Llama, ViT, BERT or MLP param tree → the
port's state.

:func:`from_jax_params` takes the reference's param tree (nested dicts
of numpy arrays — ``jax.tree_util.tree_map(np.asarray, params)`` of a
``unionml_tpu`` Llama, fp or after its ``quantize_params`` with
``bits=8`` or ``bits=4``) and
returns the same tree of torch tensors on a device, checked leaf by leaf
against the config's geometry. The layout is kept as it is (kernels
``[K, N]`` for ``x @ W``; the DenseGeneral q/k/v kernels ``[D, H, hd]``
and o ``[H, hd, D]``; int8 ``kernel_q`` ``[K, N]`` + ``scale`` ``[N]``;
packed int4 ``kernel_p`` ``[K, N/2]`` + ``scale`` ``[N]`` or ``scale_g``
``[K/g, N]``), so both packages compute the same products on the same
numbers. For a ``weight_bits=4`` config each site must carry the form
the config's layer declares there (int4 where ``tile_for`` gives a tile
and the group divides K, the int8 fallback elsewhere); a tree packed for
another tile or group is refused rather than decoded wrong. For a
``num_experts > 0`` config each block carries its MoE leaves instead
of the dense MLP (``moe/router_kernel`` fp32 ``[d, E]``, ``moe/w_gate`` /
``w_up`` ``[E, d, h]`` and ``w_down`` ``[E, h, d]``, or their int8
``w_*_q`` with ``w_*_scale`` ``[E, N]``). For a
``lora_rank > 0`` config a dense site may also carry its adapters,
``lora_a`` ``[K, r]`` and ``lora_b`` ``[r, N]``, beside an fp or int8 base;
:func:`lora_from_jax_state` turns a JAX ``LoRATrainState`` (adapters and
frozen base) into the port's, and :func:`pipeline_from_jax_params` a
pipelined tree (stage params stacked). The rest of the reference's
converter (HF safetensors import/export) is not ported yet.

:func:`vit_from_jax_params` does the same for a ``unionml_tpu`` ViT tree
(fp32 params): the flax Conv kernel ``[p, p, C, D]`` (HWIO), Dense kernels
``[in, out]``, q/k/v ``[D, H, hd]`` and o ``[H, hd, D]`` (with their biases
under ``qkv_bias``), LayerNorm ``scale`` / ``bias``, ``cls``, ``pos_embed``
and ``head``, every leaf checked against the shape the
:class:`~unionml_tpu_torch.models.vit.ViTConfig` declares.
:func:`bert_from_jax_params` and :func:`mlp_from_jax_params` do the same
for a ``unionml_tpu`` BERT tree (``BertClassifier``, ``BertMlm`` or a bare
encoder, with or without ``type_embed``) and an ``Mlp`` tree.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.bert import BertConfig
from unionml_tpu_torch.models.llama import LlamaConfig
from unionml_tpu_torch.models.mlp import MlpConfig
from unionml_tpu_torch.models.quantization import INT4_COLUMN_PARALLEL, int4_tile
from unionml_tpu_torch.models.vit import ViTConfig


def _to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy torch may own
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _dense_shapes(config: LlamaConfig) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...], Tuple[int, int]]]:
    """Per dense site (path relative to its block or the root): the fp
    kernel shape and the int8 ``[K, N]`` shape."""
    c = config
    d, hd, h, kvh = c.hidden_dim, c.head_dim, c.num_heads, c.num_kv_heads
    sites = {
        ("attn", "q"): ((d, h, hd), (d, h * hd)),
        ("attn", "k"): ((d, kvh, hd), (d, kvh * hd)),
        ("attn", "v"): ((d, kvh, hd), (d, kvh * hd)),
        ("attn", "o"): ((h, hd, d), (h * hd, d)),
    }
    if not c.num_experts:   # an MoE block has experts in place of the dense MLP
        sites.update({
            ("mlp", "gate"): ((d, c.mlp_dim), (d, c.mlp_dim)),
            ("mlp", "up"): ((d, c.mlp_dim), (d, c.mlp_dim)),
            ("mlp", "down"): ((c.mlp_dim, d), (c.mlp_dim, d)),
        })
    return sites


def _moe_shapes(config: LlamaConfig) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """An MoE block's leaves (path under the block) and shapes: the fp32
    router and the experts, fp or (``quantized``) int8 with per-(expert,
    out-channel) scales."""
    d, h, e = config.hidden_dim, config.mlp_dim, config.num_experts
    kn = {"gate": (d, h), "up": (d, h), "down": (h, d)}
    out = {("moe", "router_kernel"): (d, e)}
    for name, (k, n) in kn.items():
        if config.quantized:
            out[("moe", f"w_{name}_q")] = (e, k, n)
            out[("moe", f"w_{name}_scale")] = (e, n)
        else:
            out[("moe", f"w_{name}")] = (e, k, n)
    return out


def _int4_site(config: LlamaConfig, path: Tuple[str, ...], k: int, n: int) -> bool:
    """Whether the config's layer at ``path`` (``[K, N]``) is packed int4
    (else the int8 fallback), as ``Int4DenseGeneral`` decides it."""
    shards = config.int4_tp if path[-1] in INT4_COLUMN_PARALLEL else 1
    return bool(int4_tile(k, n, shards=shards, group_size=config.int4_group))


def _check_dense(config: LlamaConfig, path, node, shapes, leaf_shape, seen) -> None:
    fp_shape, (k, n) = shapes
    if config.quantized and config.weight_bits == 4:
        form = "int4" if _int4_site(config, path, k, n) else "int8"
    else:
        form = "int8" if "kernel_q" in node else "fp"
    if form == "int4":
        if "kernel_p" not in node:
            raise ValueError(
                f"param {'/'.join(path)}: this int4 config packs the site "
                f"(kernel_p), the tree has {sorted(node)}"
            )
        g = config.int4_group
        leaves = {"kernel_p": (k, n // 2), ("scale_g" if g else "scale"): ((k // g, n) if g else (n,))}
    elif form == "int8":
        if "kernel_q" not in node:
            raise ValueError(
                f"param {'/'.join(path)}: expected the int8 form (kernel_q + scale), "
                f"the tree has {sorted(node)}"
            )
        leaves = {"kernel_q": (k, n), "scale": (n,)}
    else:
        leaves = {"kernel": fp_shape}
    r = config.lora_rank
    if r > 0 and path[-1] != "lm_head" and ("lora_a" in node or "lora_b" in node):
        leaves.update(lora_a=(k, r), lora_b=(r, n))
    for name, want in leaves.items():
        _check(path + (name,), leaf_shape(path + (name,)), want)
        seen.add(path + (name,))


def _expected(config: LlamaConfig) -> Dict[Tuple[str, ...], Any]:
    """Every dense site's path → (fp shape, int8 shape), and every other
    leaf's path → its shape."""
    d, v = config.hidden_dim, config.vocab_size
    out: Dict[Tuple[str, ...], Any] = {
        ("embed", "embedding"): (v, d),
        ("final_norm", "scale"): (d,),
        ("lm_head",): ((d, v), (d, v)),
    }
    for i in range(config.num_layers):
        block = f"block_{i}"
        out[(block, "attn_norm", "scale")] = (d,)
        out[(block, "mlp_norm", "scale")] = (d,)
        for site, shapes in _dense_shapes(config).items():
            out[(block,) + site] = shapes
        if config.num_experts:
            for leaf, shape in _moe_shapes(config).items():
                out[(block,) + leaf] = shape
    return out


def from_jax_params(params: Mapping, config: LlamaConfig, device: DeviceLike = None) -> dict:
    """The reference's Llama param tree (numpy leaves) as torch tensors on
    ``device`` (``None`` = CUDA, raising without one), same nesting and
    layout. Raises ``ValueError`` on a missing or extra leaf or a shape
    that does not match ``config``."""
    dev = resolve_device(device)
    expected = _expected(config)

    def leaf_shape(path):
        return tuple(np.shape(_get(params, path)))

    seen = set()
    for path, shapes in expected.items():
        node = _get(params, path)
        if isinstance(shapes[0], tuple):  # a dense site: fp, int8 or int4
            _check_dense(config, path, node, shapes, leaf_shape, seen)
        else:
            _check(path, tuple(np.shape(node)), shapes)
            seen.add(path)

    def convert(node, path):
        if isinstance(node, Mapping):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        if path not in seen:
            raise ValueError(f"unexpected leaf {'/'.join(path)} for this LlamaConfig")
        return _to_tensor(node, dev)

    return convert(params, ())


def pipeline_from_jax_params(params: Mapping, config: LlamaConfig, num_stages: int,
                             device: DeviceLike = None) -> dict:
    """The reference's pipelined Llama tree (``{embed, stages, head}``,
    stage params stacked on a leading axis of ``num_stages``, as
    ``unionml_tpu.models.to_pipeline_params`` or ``create_pipelined_lm_state``
    lay it out) as the port's: unstacked into the flat Llama tree, checked
    leaf by leaf by :func:`from_jax_params`, and stacked again by
    :func:`~unionml_tpu_torch.models.pipeline_lm.to_pipeline_params`."""
    from unionml_tpu_torch.models.pipeline_lm import to_pipeline_params

    if config.num_layers % num_stages:
        raise ValueError(f"num_layers {config.num_layers} not divisible by num_stages "
                         f"{num_stages}")
    per = config.num_layers // num_stages

    def stage_slice(tree, s):
        if isinstance(tree, Mapping):
            return {k: stage_slice(v, s) for k, v in tree.items()}
        arr = np.asarray(tree)
        if arr.shape[:1] != (num_stages,):
            raise ValueError(f"a stage leaf of shape {arr.shape} has no leading stage axis "
                             f"of {num_stages}")
        return arr[s]

    stages = _get(params, ("stages",))
    flat = {"embed": _get(params, ("embed", "embed")),
            "final_norm": _get(params, ("head", "final_norm")),
            "lm_head": _get(params, ("head", "lm_head"))}
    for s in range(num_stages):
        local = stage_slice(stages, s)
        for i in range(per):
            if f"block_{i}" not in local:
                raise ValueError(f"missing param stages/block_{i}")
            flat[f"block_{s * per + i}"] = local[f"block_{i}"]
        if len(local) != per:
            raise ValueError(f"stages hold {len(local)} blocks a stage, expected {per}")
    return to_pipeline_params(from_jax_params(flat, config, device), config, num_stages)


def lora_from_jax_state(state: Any, config: LlamaConfig, device: DeviceLike = None, *,
                        learning_rate: float = 1e-4):
    """A fresh JAX ``LoRATrainState`` (``unionml_tpu.models.lora``: its
    ``params`` the adapters, its ``frozen_params`` the base; any leaves
    ``np.asarray`` reads) as the port's
    :class:`~unionml_tpu_torch.models.lora.LoRATrainState` on ``device``:
    both trees through :func:`from_jax_params` (the adapters checked in
    their sites), the module ``Llama(config)``, a new AdamW state at
    ``learning_rate``. The JAX optimizer state is not carried over, so a
    state past step 0 is refused."""
    from unionml_tpu_torch.models.llama import Llama
    from unionml_tpu_torch.models.lora import LoRATrainState, merge_param_trees, split_lora_params
    from unionml_tpu_torch.models.train import adamw

    if int(np.asarray(state.step)) != 0:
        raise ValueError(
            f"lora_from_jax_state carries a fresh state only (step 0), got step "
            f"{int(np.asarray(state.step))}: the JAX optimizer state is not bridged"
        )
    full = merge_param_trees(_numpy_tree(state.frozen_params), _numpy_tree(state.params))
    adapters, frozen = split_lora_params(from_jax_params(full, config, device))
    return LoRATrainState.create(apply_fn=Llama(config), params=adapters,
                                 tx=adamw(learning_rate), frozen_params=frozen)


def _numpy_tree(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _get(tree: Mapping, path: Tuple[str, ...]):
    node = tree
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            raise ValueError(f"missing param {'/'.join(path)}")
        node = node[key]
    return node


def _check(path, got, want) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"param {'/'.join(path)} has shape {tuple(got)}, expected {tuple(want)}")


def _vit_shapes(config: ViTConfig, channels: int) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Every leaf of a ViT tree and its shape."""
    c = config
    d, h, m, p = c.hidden_dim, c.num_heads, c.mlp_dim, c.patch_size
    hd = d // h
    out: Dict[Tuple[str, ...], Tuple[int, ...]] = {
        ("patch_embed", "kernel"): (p, p, channels, d),
        ("patch_embed", "bias"): (d,),
        ("cls",): (1, 1, d),
        ("pos_embed",): (1, c.num_patches + 1, d),
        ("ln_final", "scale"): (d,),
        ("ln_final", "bias"): (d,),
        ("head", "kernel"): (d, c.num_classes),
        ("head", "bias"): (c.num_classes,),
    }
    for i in range(c.num_layers):
        b = f"block_{i}"
        for ln in ("ln1", "ln2"):
            out[(b, ln, "scale")] = (d,)
            out[(b, ln, "bias")] = (d,)
        for name in ("q", "k", "v"):
            out[(b, "attn", name, "kernel")] = (d, h, hd)
            if c.qkv_bias:
                out[(b, "attn", name, "bias")] = (h, hd)
        out[(b, "attn", "o", "kernel")] = (h, hd, d)
        if c.qkv_bias:
            out[(b, "attn", "o", "bias")] = (d,)
        out[(b, "mlp", "up", "kernel")] = (d, m)
        out[(b, "mlp", "up", "bias")] = (m,)
        out[(b, "mlp", "down", "kernel")] = (m, d)
        out[(b, "mlp", "down", "bias")] = (d,)
    return out


def _convert_checked(params: Mapping, expected: Mapping, dev: torch.device, what: str) -> dict:
    """Every leaf of ``expected`` checked for its shape, then the tree
    as torch tensors on ``dev``; a leaf ``expected`` lacks raises."""
    for path, shape in expected.items():
        _check(path, tuple(np.shape(_get(params, path))), shape)

    def convert(node, path):
        if isinstance(node, Mapping):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        if path not in expected:
            raise ValueError(f"unexpected leaf {'/'.join(path)} for this {what}")
        return _to_tensor(node, dev)

    return convert(params, ())


def vit_from_jax_params(params: Mapping, config: ViTConfig, device: DeviceLike = None) -> dict:
    """The reference's ViT param tree (numpy leaves) as torch tensors on
    ``device`` (``None`` = CUDA, raising without one), same nesting and
    layout. The patch kernel's input channels come from the tree; every
    other dimension must match ``config``. Raises ``ValueError`` on a
    missing or extra leaf or a wrong shape."""
    dev = resolve_device(device)
    kernel = np.shape(_get(params, ("patch_embed", "kernel")))
    if len(kernel) != 4:
        raise ValueError(f"param patch_embed/kernel has shape {kernel}, expected [p, p, C, D]")
    return _convert_checked(params, _vit_shapes(config, kernel[2]), dev, "ViTConfig")


def _bert_encoder_shapes(config: BertConfig, prefix: Tuple[str, ...],
                         token_types: bool) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Every leaf of a BERT encoder tree under ``prefix`` and its shape."""
    c = config
    d, h, m = c.hidden_dim, c.num_heads, c.mlp_dim
    hd = d // h
    out: Dict[Tuple[str, ...], Tuple[int, ...]] = {
        prefix + ("tok_embed", "embedding"): (c.vocab_size, d),
        prefix + ("pos_embed", "embedding"): (c.max_len, d),
        prefix + ("ln_embed", "scale"): (d,),
        prefix + ("ln_embed", "bias"): (d,),
    }
    if token_types:
        out[prefix + ("type_embed", "embedding")] = (c.num_types, d)
    for i in range(c.num_layers):
        b = prefix + (f"block_{i}",)
        for name in ("attn_q", "attn_k", "attn_v"):
            out[b + (name, "kernel")] = (d, h, hd)
            out[b + (name, "bias")] = (h, hd)
        out[b + ("attn_o", "kernel")] = (h, hd, d)
        out[b + ("attn_o", "bias")] = (d,)
        for ln in ("ln1", "ln2"):
            out[b + (ln, "scale")] = (d,)
            out[b + (ln, "bias")] = (d,)
        out[b + ("mlp", "up", "kernel")] = (d, m)
        out[b + ("mlp", "up", "bias")] = (m,)
        out[b + ("mlp", "down", "kernel")] = (m, d)
        out[b + ("mlp", "down", "bias")] = (d,)
    return out


def bert_from_jax_params(params: Mapping, config: BertConfig, device: DeviceLike = None) -> dict:
    """The reference's BERT param tree (numpy leaves) as torch tensors on
    ``device`` (``None`` = CUDA, raising without one), same nesting and
    layout: a ``BertClassifier`` tree (``encoder``, ``pooler``, ``head``),
    a ``BertMlm`` tree (``encoder``, ``mlm_dense``, ``mlm_ln``,
    ``mlm_head``) or a bare ``BertEncoder`` tree, each with or without
    ``type_embed``. Raises ``ValueError`` on a missing or extra leaf or a
    shape that does not match ``config``."""
    dev = resolve_device(device)
    c = config
    d = c.hidden_dim
    wrapped = "encoder" in params
    prefix = ("encoder",) if wrapped else ()
    encoder = params["encoder"] if wrapped else params
    expected = _bert_encoder_shapes(c, prefix, "type_embed" in encoder)
    if not wrapped:
        what = "BertConfig (a bare encoder tree)"
    elif "mlm_head" in params:
        what = "BertConfig (a BertMlm tree)"
        expected.update({
            ("mlm_dense", "kernel"): (d, d), ("mlm_dense", "bias"): (d,),
            ("mlm_ln", "scale"): (d,), ("mlm_ln", "bias"): (d,),
            ("mlm_head", "kernel"): (d, c.vocab_size), ("mlm_head", "bias"): (c.vocab_size,),
        })
    else:
        what = "BertConfig (a BertClassifier tree)"
        expected.update({
            ("pooler", "kernel"): (d, d), ("pooler", "bias"): (d,),
            ("head", "kernel"): (d, c.num_classes), ("head", "bias"): (c.num_classes,),
        })
    return _convert_checked(params, expected, dev, what)


def mlp_from_jax_params(params: Mapping, config: MlpConfig, device: DeviceLike = None) -> dict:
    """The reference's ``Mlp`` param tree (numpy leaves) as torch tensors
    on ``device`` (``None`` = CUDA, raising without one): ``dense_{i}``
    per hidden width and ``head``, each ``kernel`` ``[in, out]`` and
    ``bias`` ``[out]``. The input width comes from the tree (the first
    kernel's rows); every other dimension must match ``config``. Raises
    ``ValueError`` on a missing or extra leaf or a wrong shape."""
    dev = resolve_device(device)
    names = [f"dense_{i}" for i in range(len(config.hidden_dims))] + ["head"]
    first = np.shape(_get(params, (names[0], "kernel")))
    if len(first) != 2:
        raise ValueError(f"param {names[0]}/kernel has shape {first}, expected [in, out]")
    expected: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
    fan_in = first[0]
    for name, width in zip(names, [*config.hidden_dims, config.num_classes]):
        expected[(name, "kernel")] = (fan_in, width)
        expected[(name, "bias")] = (width,)
        fan_in = width
    return _convert_checked(params, expected, dev, "MlpConfig")
