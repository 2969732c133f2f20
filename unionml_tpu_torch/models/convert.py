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
pipelined tree (stage params stacked).

The HF half: :func:`load_llama_checkpoint`, :func:`load_bert_checkpoint`
and :func:`load_vit_checkpoint` stream a safetensors checkpoint (one file,
a directory, or ``model.safetensors.index.json`` with its shards) into the
port's params, one tensor at a time through the name / layout maps
(:func:`llama_tensor_specs` with Mixtral's expert groups,
:func:`bert_tensor_specs`, :func:`vit_tensor_specs`), each tensor moved to
the device as it is read and, for a quantized Llama, quantized there to
int8 or packed int4 by :func:`~unionml_tpu_torch.models.quantization
.quantize_params`' recipe (the same tree, bit for bit, with the fp tree
never whole). :func:`llama_config_from_hf`, :func:`bert_config_from_hf`
and :func:`vit_config_from_hf` read ``config.json``;
:func:`merge_pretrained` overlays a load on a fresh init; the
``export_*_safetensors`` functions write the inverse layout. The format
is read and written here (``_SafetensorsFile``, ``_save_safetensors``):
an 8-byte little-endian header length, a JSON header, the raw bytes, each
tensor mapped alone (``numpy.memmap`` at its offset), bf16 as its raw
``uint16`` bits viewed as ``torch.bfloat16``; neither ``safetensors`` nor
``transformers`` is imported. :func:`encdec_from_jax_params` bridges the
encoder-decoder's tree.

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

import dataclasses
import json
import math
import os
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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


# --------------------------------------------------------------------- #
# HF safetensors checkpoints: the format, without the package
# --------------------------------------------------------------------- #

#: safetensors dtype names and their numpy storage (bf16 is kept as its
#: raw uint16 bits and viewed as ``torch.bfloat16`` on the way to torch)
_ST_NUMPY = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_,
}
_TORCH_ST = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
    torch.uint8: "U8", torch.bool: "BOOL",
}


class _SafetensorsFile:
    """One ``.safetensors`` file: an 8-byte little-endian header length, a
    JSON header (each tensor's ``dtype`` / ``shape`` / ``data_offsets``
    into the data section, and ``__metadata__``), then the raw bytes.
    :meth:`read` maps one tensor's bytes alone (``numpy.memmap`` at its
    offset), never the file."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            if size < 8 or n > size - 8:
                raise ValueError(f"{path}: a header of {n} bytes does not fit a file of "
                                 f"{size} bytes (not a safetensors file, or truncated)")
            try:
                header = json.loads(f.read(n))
            except ValueError as exc:
                raise ValueError(f"{path}: unreadable safetensors header ({exc})") from None
        self.data_start = 8 + n
        self.metadata = header.pop("__metadata__", None) or {}
        self.entries: Dict[str, Dict[str, Any]] = header
        data = size - self.data_start
        for name, entry in header.items():
            begin, end = entry["data_offsets"]
            if not 0 <= begin <= end <= data:
                raise ValueError(f"{path}: {name!r} spans bytes [{begin}, {end}) of a data "
                                 f"section of {data} bytes (truncated file?)")

    def read(self, name: str) -> Tuple[np.ndarray, str]:
        """``(array, safetensors dtype)``: bf16 as its uint16 bits."""
        entry = self.entries[name]
        dtype = entry["dtype"]
        if dtype not in _ST_NUMPY:
            raise NotImplementedError(f"safetensors dtype {dtype!r} of {name!r} is not read")
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        np_dtype = np.dtype(_ST_NUMPY[dtype])
        if end - begin != int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize:
            raise ValueError(f"{self.path}: {name!r} spans {end - begin} bytes for {shape} {dtype}")
        if end == begin:
            return np.zeros(shape, np_dtype), dtype
        # copy-on-write: a writable view torch can take without a copy
        return np.memmap(self.path, dtype=np_dtype, mode="c", offset=self.data_start + begin,
                         shape=shape), dtype


def _st_bytes(arr: np.ndarray) -> memoryview:
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _save_safetensors(plan: Any, path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write one ``.safetensors`` file from ``plan``, a sequence of
    ``(name, shape, safetensors dtype, nbytes, fetch)`` in file order;
    ``fetch()`` gives ``(array, dtype)`` when the tensor's bytes are due,
    so the caller hands over one tensor at a time."""
    offset = 0
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name, shape, dtype, nbytes, _ in plan:
        header[name] = {"dtype": dtype, "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)       # the data section starts 8-aligned
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name, shape, dtype, nbytes, fetch in plan:
            arr, got = fetch()
            if got != dtype or tuple(arr.shape) != tuple(shape) or arr.nbytes != nbytes:
                raise ValueError(f"{name!r}: planned {shape} {dtype}, got {arr.shape} {got}")
            f.write(_st_bytes(arr))


def _numpy_of(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor (on any device) on the host as ``(array, safetensors
    dtype)``: bf16 as its uint16 bits."""
    t = t.detach()
    dtype = _TORCH_ST.get(t.dtype)
    if dtype is None:
        raise TypeError(f"no safetensors dtype for {t.dtype}")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.cpu().numpy()
    return (arr.view(np.uint16) if dtype == "BF16" else arr), dtype


def _to_torch(arr: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    """A host array read from a checkpoint (a mapped tensor) as a tensor
    of its own on ``device``, copied from the mapping once."""
    if dtype == "BF16":
        arr = arr.view(np.int16)
    t = torch.from_numpy(arr)
    if dtype == "BF16":
        t = t.view(torch.bfloat16)
    return t.to(device, copy=True)


# --------------------------------------------------------------------- #
# HF checkpoints: the tensor maps
# --------------------------------------------------------------------- #


@dataclass(frozen=True)
class TensorSpec:
    """One checkpoint tensor ↔ one param. ``to_framework`` / ``to_hf`` are
    inverse layout transforms of torch tensors (transpose / reshape only,
    run where the tensor is: on the card as it arrives; dtypes are the
    loader's). ``quantizable`` marks the matmul kernels the streamed
    int8 / int4 path quantizes; ``fallback`` names another HF tensor (tied
    checkpoints omit ``lm_head.weight``); ``optional`` tensors may be
    absent; ``keep_dtype`` leaves are never cast (the MoE router)."""

    path: Tuple[str, ...]
    hf_name: str
    to_framework: Callable[[np.ndarray], np.ndarray]
    to_hf: Callable[[np.ndarray], np.ndarray]
    quantizable: bool = False
    fallback: Optional[str] = None
    optional: bool = False
    keep_dtype: bool = False


@dataclass(frozen=True)
class GroupSpec:
    """N checkpoint tensors ↔ one stacked param (Mixtral's per-expert
    ``w1`` / ``w2`` / ``w3`` as the ``[E, K, N]`` stacks). The transforms
    are per element; one expert tensor is resident at a time, written into
    the stack on the device."""

    path: Tuple[str, ...]
    hf_names: Tuple[str, ...]
    to_framework: Callable[[np.ndarray], np.ndarray]
    to_hf: Callable[[np.ndarray], np.ndarray]
    quantizable: bool = False


def _ident(w: torch.Tensor) -> torch.Tensor:
    return w


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.t().contiguous()


def _split_heads(heads: int, head_dim: int):
    """HF ``[heads*hd, D]`` projection → ``[D, heads, hd]``."""

    def fwd(w: torch.Tensor) -> torch.Tensor:
        return w.t().contiguous().reshape(w.shape[1], heads, head_dim)

    def inv(w: torch.Tensor) -> torch.Tensor:
        return w.reshape(w.shape[0], heads * head_dim).t().contiguous()

    return fwd, inv


def _merge_heads(heads: int, head_dim: int):
    """HF ``[D, heads*hd]`` out projection → ``[heads, hd, D]``."""

    def fwd(w: torch.Tensor) -> torch.Tensor:
        return w.t().contiguous().reshape(heads, head_dim, w.shape[0])

    def inv(w: torch.Tensor) -> torch.Tensor:
        return w.reshape(heads * head_dim, w.shape[-1]).t().contiguous()

    return fwd, inv


def _head_bias(heads: int, head_dim: int):
    """HF ``[heads*hd]`` q/k/v bias → ``[heads, hd]``."""

    def fwd(w: torch.Tensor) -> torch.Tensor:
        return w.reshape(heads, head_dim)

    def inv(w: torch.Tensor) -> torch.Tensor:
        return w.reshape(heads * head_dim)

    return fwd, inv


def llama_tensor_specs(config: LlamaConfig) -> List[Any]:
    """The HF Llama / Mixtral ↔ :class:`~unionml_tpu_torch.models.llama
    .Llama` tensor map: the embedding, per block q/k/v/o, the norms and the
    SwiGLU MLP (or, with ``num_experts``, Mixtral's fp32 router and three
    per-expert :class:`GroupSpec` stacks), the final norm and the LM head
    (falling back to the tied ``model.embed_tokens.weight``). The rotary
    embedding is HF's rotate-half convention, so q / k map by a transpose
    and a reshape."""
    hd = config.head_dim
    qf, qi = _split_heads(config.num_heads, hd)
    kf, ki = _split_heads(config.num_kv_heads, hd)
    of, oi = _merge_heads(config.num_heads, hd)
    specs: List[Any] = [
        TensorSpec(("embed", "embedding"), "model.embed_tokens.weight", _ident, _ident),
    ]
    for i in range(config.num_layers):
        b, L = f"block_{i}", f"model.layers.{i}"
        specs += [
            TensorSpec((b, "attn", "q", "kernel"), f"{L}.self_attn.q_proj.weight", qf, qi, True),
            TensorSpec((b, "attn", "k", "kernel"), f"{L}.self_attn.k_proj.weight", kf, ki, True),
            TensorSpec((b, "attn", "v", "kernel"), f"{L}.self_attn.v_proj.weight", kf, ki, True),
            TensorSpec((b, "attn", "o", "kernel"), f"{L}.self_attn.o_proj.weight", of, oi, True),
            TensorSpec((b, "attn_norm", "scale"), f"{L}.input_layernorm.weight", _ident, _ident),
            TensorSpec((b, "mlp_norm", "scale"), f"{L}.post_attention_layernorm.weight",
                       _ident, _ident),
        ]
        if config.num_experts:
            M = f"{L}.block_sparse_moe"
            experts = range(config.num_experts)
            specs += [
                TensorSpec((b, "moe", "router_kernel"), f"{M}.gate.weight", _t, _t,
                           keep_dtype=True),
                GroupSpec((b, "moe", "w_gate"),
                          tuple(f"{M}.experts.{e}.w1.weight" for e in experts), _t, _t, True),
                GroupSpec((b, "moe", "w_up"),
                          tuple(f"{M}.experts.{e}.w3.weight" for e in experts), _t, _t, True),
                GroupSpec((b, "moe", "w_down"),
                          tuple(f"{M}.experts.{e}.w2.weight" for e in experts), _t, _t, True),
            ]
        else:
            specs += [
                TensorSpec((b, "mlp", "gate", "kernel"), f"{L}.mlp.gate_proj.weight", _t, _t, True),
                TensorSpec((b, "mlp", "up", "kernel"), f"{L}.mlp.up_proj.weight", _t, _t, True),
                TensorSpec((b, "mlp", "down", "kernel"), f"{L}.mlp.down_proj.weight", _t, _t, True),
            ]
    specs.append(TensorSpec(("final_norm", "scale"), "model.norm.weight", _ident, _ident))
    specs.append(TensorSpec(("lm_head", "kernel"), "lm_head.weight", _t, _t, True,
                            fallback="model.embed_tokens.weight"))
    return specs


def llama_config_from_hf(config_json: Dict[str, Any], **overrides: Any) -> LlamaConfig:
    """A :class:`LlamaConfig` from an HF ``config.json`` dict (``rope_scaling``
    of the llama3 type, ``rms_norm_eps``, Mixtral's experts);
    ``overrides`` pass through (``quantized=True``, ``max_len=8192``)."""
    kwargs: Dict[str, Any] = dict(
        vocab_size=config_json["vocab_size"],
        hidden_dim=config_json["hidden_size"],
        num_layers=config_json["num_hidden_layers"],
        num_heads=config_json["num_attention_heads"],
        num_kv_heads=config_json.get("num_key_value_heads", config_json["num_attention_heads"]),
        mlp_dim=config_json["intermediate_size"],
        rope_theta=float(config_json.get("rope_theta", 10_000.0)),
        norm_eps=float(config_json.get("rms_norm_eps", 1e-5)),
        max_len=config_json.get("max_position_embeddings", 8192),
    )
    if config_json.get("num_local_experts"):
        kwargs["num_experts"] = config_json["num_local_experts"]
        kwargs["num_selected"] = config_json.get("num_experts_per_tok", 2)
    scaling = config_json.get("rope_scaling")
    if scaling:
        # dropping it silently would compute unscaled frequencies
        rope_type = scaling.get("rope_type", scaling.get("type"))
        if rope_type != "llama3":
            raise NotImplementedError(
                f"rope_scaling type {rope_type!r} is not supported (llama3-type rescaling only)"
            )
        kwargs["rope_scaling"] = (
            float(scaling["factor"]), float(scaling["low_freq_factor"]),
            float(scaling["high_freq_factor"]), int(scaling["original_max_position_embeddings"]),
        )
    kwargs.update(overrides)
    return LlamaConfig(**kwargs)


def bert_tensor_specs(config: BertConfig, *, encoder_key: str = "encoder") -> List[TensorSpec]:
    """The HF BERT ↔ :class:`~unionml_tpu_torch.models.bert.BertClassifier`
    map, rooted under ``encoder_key`` (``""`` for a bare encoder tree):
    the embeddings and their LayerNorm, every post-LN block, the pooler
    (optional). Task heads stay at their initialization
    (:func:`merge_pretrained`)."""
    hd = config.hidden_dim // config.num_heads
    qf, qi = _split_heads(config.num_heads, hd)
    of, oi = _merge_heads(config.num_heads, hd)
    bf, bi = _head_bias(config.num_heads, hd)
    root: Tuple[str, ...] = (encoder_key,) if encoder_key else ()

    def enc(*p):
        return root + p

    specs: List[TensorSpec] = [
        TensorSpec(enc("tok_embed", "embedding"), "embeddings.word_embeddings.weight",
                   _ident, _ident),
        TensorSpec(enc("pos_embed", "embedding"), "embeddings.position_embeddings.weight",
                   _ident, _ident),
        TensorSpec(enc("type_embed", "embedding"), "embeddings.token_type_embeddings.weight",
                   _ident, _ident),
        TensorSpec(enc("ln_embed", "scale"), "embeddings.LayerNorm.weight", _ident, _ident),
        TensorSpec(enc("ln_embed", "bias"), "embeddings.LayerNorm.bias", _ident, _ident),
    ]
    for i in range(config.num_layers):
        b, L = f"block_{i}", f"encoder.layer.{i}"
        for ours, theirs in {"q": "query", "k": "key", "v": "value"}.items():
            specs += [
                TensorSpec(enc(b, f"attn_{ours}", "kernel"),
                           f"{L}.attention.self.{theirs}.weight", qf, qi),
                TensorSpec(enc(b, f"attn_{ours}", "bias"),
                           f"{L}.attention.self.{theirs}.bias", bf, bi),
            ]
        specs += [
            TensorSpec(enc(b, "attn_o", "kernel"), f"{L}.attention.output.dense.weight", of, oi),
            TensorSpec(enc(b, "attn_o", "bias"), f"{L}.attention.output.dense.bias",
                       _ident, _ident),
            TensorSpec(enc(b, "ln1", "scale"), f"{L}.attention.output.LayerNorm.weight",
                       _ident, _ident),
            TensorSpec(enc(b, "ln1", "bias"), f"{L}.attention.output.LayerNorm.bias",
                       _ident, _ident),
            TensorSpec(enc(b, "mlp", "up", "kernel"), f"{L}.intermediate.dense.weight", _t, _t),
            TensorSpec(enc(b, "mlp", "up", "bias"), f"{L}.intermediate.dense.bias",
                       _ident, _ident),
            TensorSpec(enc(b, "mlp", "down", "kernel"), f"{L}.output.dense.weight", _t, _t),
            TensorSpec(enc(b, "mlp", "down", "bias"), f"{L}.output.dense.bias", _ident, _ident),
            TensorSpec(enc(b, "ln2", "scale"), f"{L}.output.LayerNorm.weight", _ident, _ident),
            TensorSpec(enc(b, "ln2", "bias"), f"{L}.output.LayerNorm.bias", _ident, _ident),
        ]
    specs += [
        TensorSpec(("pooler", "kernel"), "pooler.dense.weight", _t, _t, optional=True),
        TensorSpec(("pooler", "bias"), "pooler.dense.bias", _ident, _ident, optional=True),
    ]
    return specs


def _gelu_exact(config_json: Dict[str, Any]) -> bool:
    act = config_json.get("hidden_act", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        raise NotImplementedError(f"hidden_act {act!r} is not supported (gelu variants only)")
    # "gelu" is the erf form the checkpoints were trained with
    return act == "gelu"


def bert_config_from_hf(config_json: Dict[str, Any], **overrides: Any) -> BertConfig:
    """A :class:`BertConfig` from an HF ``config.json`` dict (``gelu_exact``
    for the erf ``gelu``)."""
    kwargs: Dict[str, Any] = dict(
        vocab_size=config_json["vocab_size"],
        max_len=config_json.get("max_position_embeddings", 512),
        num_types=config_json.get("type_vocab_size", 2),
        hidden_dim=config_json["hidden_size"],
        num_layers=config_json["num_hidden_layers"],
        num_heads=config_json["num_attention_heads"],
        mlp_dim=config_json["intermediate_size"],
        gelu_exact=_gelu_exact(config_json),
    )
    kwargs.update(overrides)
    return BertConfig(**kwargs)


def vit_tensor_specs(config: ViTConfig) -> List[TensorSpec]:
    """The HF ViT ↔ :class:`~unionml_tpu_torch.models.vit.ViT` map: pre-LN
    blocks (``layernorm_before`` → ``ln1``, ``layernorm_after`` → ``ln2``),
    the patch conv OIHW → HWIO, q/k/v/o biases under ``qkv_bias``, the
    ``classifier`` head when present (optional)."""
    hd = config.hidden_dim // config.num_heads
    qf, qi = _split_heads(config.num_heads, hd)
    of, oi = _merge_heads(config.num_heads, hd)
    bf, bi = _head_bias(config.num_heads, hd)

    def conv_fwd(w: torch.Tensor) -> torch.Tensor:   # OIHW → HWIO
        return w.permute(2, 3, 1, 0).contiguous()

    def conv_inv(w: torch.Tensor) -> torch.Tensor:
        return w.permute(3, 2, 0, 1).contiguous()

    specs: List[TensorSpec] = [
        TensorSpec(("cls",), "embeddings.cls_token", _ident, _ident),
        TensorSpec(("pos_embed",), "embeddings.position_embeddings", _ident, _ident),
        TensorSpec(("patch_embed", "kernel"), "embeddings.patch_embeddings.projection.weight",
                   conv_fwd, conv_inv),
        TensorSpec(("patch_embed", "bias"), "embeddings.patch_embeddings.projection.bias",
                   _ident, _ident),
    ]
    for i in range(config.num_layers):
        b, L = f"block_{i}", f"encoder.layer.{i}"
        for ours, theirs in {"q": "query", "k": "key", "v": "value"}.items():
            specs.append(TensorSpec((b, "attn", ours, "kernel"),
                                    f"{L}.attention.attention.{theirs}.weight", qf, qi))
            if config.qkv_bias:
                specs.append(TensorSpec((b, "attn", ours, "bias"),
                                        f"{L}.attention.attention.{theirs}.bias", bf, bi))
        specs.append(TensorSpec((b, "attn", "o", "kernel"),
                                f"{L}.attention.output.dense.weight", of, oi))
        if config.qkv_bias:
            specs.append(TensorSpec((b, "attn", "o", "bias"),
                                    f"{L}.attention.output.dense.bias", _ident, _ident))
        specs += [
            TensorSpec((b, "ln1", "scale"), f"{L}.layernorm_before.weight", _ident, _ident),
            TensorSpec((b, "ln1", "bias"), f"{L}.layernorm_before.bias", _ident, _ident),
            TensorSpec((b, "ln2", "scale"), f"{L}.layernorm_after.weight", _ident, _ident),
            TensorSpec((b, "ln2", "bias"), f"{L}.layernorm_after.bias", _ident, _ident),
            TensorSpec((b, "mlp", "up", "kernel"), f"{L}.intermediate.dense.weight", _t, _t),
            TensorSpec((b, "mlp", "up", "bias"), f"{L}.intermediate.dense.bias", _ident, _ident),
            TensorSpec((b, "mlp", "down", "kernel"), f"{L}.output.dense.weight", _t, _t),
            TensorSpec((b, "mlp", "down", "bias"), f"{L}.output.dense.bias", _ident, _ident),
        ]
    specs += [
        TensorSpec(("ln_final", "scale"), "layernorm.weight", _ident, _ident),
        TensorSpec(("ln_final", "bias"), "layernorm.bias", _ident, _ident),
        TensorSpec(("head", "kernel"), "classifier.weight", _t, _t, optional=True),
        TensorSpec(("head", "bias"), "classifier.bias", _ident, _ident, optional=True),
    ]
    return specs


def vit_config_from_hf(config_json: Dict[str, Any], **overrides: Any) -> ViTConfig:
    """A :class:`ViTConfig` from an HF ``config.json`` dict (qkv biases and
    the erf GELU, as the checkpoints have them)."""
    kwargs: Dict[str, Any] = dict(
        image_size=config_json.get("image_size", 224),
        patch_size=config_json.get("patch_size", 16),
        hidden_dim=config_json["hidden_size"],
        num_layers=config_json["num_hidden_layers"],
        num_heads=config_json["num_attention_heads"],
        mlp_dim=config_json["intermediate_size"],
        qkv_bias=config_json.get("qkv_bias", True),
        gelu_exact=_gelu_exact(config_json),
    )
    if config_json.get("id2label"):
        kwargs["num_classes"] = len(config_json["id2label"])
    kwargs.update(overrides)
    return ViTConfig(**kwargs)


# --------------------------------------------------------------------- #
# HF checkpoints: reading (streamed) and writing
# --------------------------------------------------------------------- #


class _CheckpointReader:
    """Name → shard resolution and one-tensor reads over a single
    ``.safetensors`` file, a directory holding some, or a sharded layout
    (``model.safetensors.index.json`` → ``weight_map``). Each read maps
    only the requested tensor's bytes."""

    def __init__(self, path: str):
        self._file_of: Dict[str, _SafetensorsFile] = {}
        files: Dict[str, _SafetensorsFile] = {}

        def open_file(p: str) -> _SafetensorsFile:
            if p not in files:
                files[p] = _SafetensorsFile(p)
            return files[p]

        if os.path.isfile(path):
            shards = [path]
        else:
            index = os.path.join(path, "model.safetensors.index.json")
            if os.path.exists(index):
                with open(index) as f:
                    weight_map = json.load(f)["weight_map"]
                for name, shard in weight_map.items():
                    self._file_of[name] = open_file(os.path.join(path, shard))
                shards = []
            else:
                shards = sorted(os.path.join(path, f) for f in os.listdir(path)
                                if f.endswith(".safetensors"))
                if not shards:
                    raise FileNotFoundError(f"no .safetensors files or index.json under {path!r}")
        for shard in shards:
            st = open_file(shard)
            for name in st.entries:
                self._file_of[name] = st

    def __contains__(self, name: str) -> bool:
        return name in self._file_of

    def names(self) -> Sequence[str]:
        return tuple(self._file_of)

    def read(self, name: str) -> Tuple[np.ndarray, str]:
        return self._file_of[name].read(name)


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _load_checkpoint(path: str, specs: Sequence[Any], *, quantize: bool, dtype: torch.dtype,
                     device: DeviceLike, strict: bool,
                     reader: Optional[_CheckpointReader] = None, bits: int = 8,
                     group_size: int = 0, tensor: int = 1) -> Dict[str, Any]:
    """Every spec's tensor read, laid out, moved to ``device`` and (for a
    ``quantizable`` kernel under ``quantize``) quantized there in fp32 by
    the recipe :func:`~unionml_tpu_torch.models.quantization.quantize_params`
    applies, before the next tensor is read: the host holds one tensor at
    a time."""
    from unionml_tpu_torch.models.quantization import _quantize_int4_site, _quantize_kernel_2d

    dev = resolve_device(device)
    reader = reader if reader is not None else _CheckpointReader(path)
    params: Dict[str, Any] = {}
    missing: List[str] = []

    def cast(t: torch.Tensor, keep: bool = False) -> torch.Tensor:
        return t.to(dtype) if t.is_floating_point() and not keep else t

    for spec in specs:
        if isinstance(spec, GroupSpec):
            absent = [n for n in spec.hf_names if n not in reader]
            if absent:
                missing.extend(absent)
                continue
            stacked = scales = None
            for e, n in enumerate(spec.hf_names):
                w = spec.to_framework(_to_torch(*reader.read(n), dev))
                if quantize and spec.quantizable:
                    # one expert at a time through the 2-D int8 recipe
                    w, scale = _quantize_kernel_2d(w.float())
                    if scales is None:
                        scales = torch.empty((len(spec.hf_names),) + scale.shape,
                                             dtype=scale.dtype, device=dev)
                    scales[e] = scale
                else:
                    w = cast(w)
                if stacked is None:
                    stacked = torch.empty((len(spec.hf_names),) + tuple(w.shape), dtype=w.dtype,
                                          device=dev)
                stacked[e] = w
                del w
            if scales is not None:
                parent, leaf = spec.path[:-1], spec.path[-1]
                _set_path(params, parent + (f"{leaf}_q",), stacked)
                _set_path(params, parent + (f"{leaf}_scale",), scales)
            else:
                _set_path(params, spec.path, stacked)
            continue
        name = spec.hf_name
        if name not in reader:
            if spec.fallback is not None and spec.fallback in reader:
                name = spec.fallback
            elif spec.optional:
                continue
            else:
                missing.append(spec.hf_name)
                continue
        w = spec.to_framework(_to_torch(*reader.read(name), dev))
        if quantize and spec.quantizable:
            # quantize_params' geometry: o contracts its leading dims,
            # every other site its one leading input dim
            k = math.prod(w.shape[:-1]) if spec.path[-2] == "o" else w.shape[0]
            w2d = w.float().reshape(k, -1)
            parent = spec.path[:-1]
            out = _quantize_int4_site(parent, w2d, group_size, tensor) if bits == 4 else None
            if out is None:
                q, scale = _quantize_kernel_2d(w2d)
                out = {"kernel_q": q, "scale": scale}
            for leaf, value in out.items():
                _set_path(params, parent + (leaf,), value)
            del w2d
        else:
            _set_path(params, spec.path, cast(w, spec.keep_dtype))
        del w   # one tensor resident at a time
    if missing:
        raise KeyError(
            f"checkpoint at {path!r} is missing {len(missing)} expected tensors "
            f"(first: {missing[:3]}); wrong config geometry?"
        )
    if strict:
        expected = set()
        for s in specs:
            if isinstance(s, GroupSpec):
                expected.update(s.hf_names)
            else:
                expected.add(s.hf_name)
                if s.fallback:
                    expected.add(s.fallback)
        extra = [n for n in reader.names() if n not in expected]
        if extra:
            raise KeyError(
                f"checkpoint at {path!r} holds {len(extra)} tensors the "
                f"{specs[0].path[0]}-family mapping does not consume "
                f"(first: {extra[:3]}); pass strict=False to ignore"
            )
    return params


def _config_json(path: str) -> Dict[str, Any]:
    cfg_path = os.path.join(path, "config.json") if os.path.isdir(path) else None
    if cfg_path is None or not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"config=None needs a checkpoint DIRECTORY with config.json (got {path!r})"
        )
    with open(cfg_path) as f:
        return json.load(f)


def load_llama_checkpoint(path: str, config: Optional[LlamaConfig] = None, *,
                          quantize: Optional[bool] = None, dtype: Any = torch.bfloat16,
                          device: DeviceLike = None, strict: bool = False,
                          **config_overrides: Any) -> Tuple[Dict[str, Any], LlamaConfig]:
    """Stream an HF Llama safetensors checkpoint into the port's params on
    ``device`` (``None`` = CUDA, raising without one). Returns ``(params,
    config)``; with ``config=None`` the geometry comes from the directory's
    ``config.json`` (``config_overrides`` pass through). ``quantize``
    (default ``config.quantized``) quantizes each kernel as it arrives:
    int8, or packed int4 under ``weight_bits=4`` (``int4_group``,
    ``int4_tp``), the same tree as :func:`~unionml_tpu_torch.models
    .quantization.quantize_params` of the fp load, bit for bit, without
    the fp tree ever being whole. Float leaves on the fp path are cast to
    ``dtype``."""
    if config is None:
        config = llama_config_from_hf(_config_json(path), **config_overrides)
    if quantize is None:
        quantize = config.quantized
    params = _load_checkpoint(path, llama_tensor_specs(config), quantize=quantize, dtype=dtype,
                              device=device, strict=strict, bits=config.weight_bits,
                              group_size=config.int4_group, tensor=config.int4_tp)
    return params, config


def _prefixed(specs: List[TensorSpec], reader: _CheckpointReader, prefix: str,
              keep=lambda s: False) -> List[TensorSpec]:
    """The specs with ``prefix`` on their names when the checkpoint is a
    task model's (``bert.`` / ``vit.`` names)."""
    if specs[0].hf_name in reader or f"{prefix}{specs[0].hf_name}" not in reader:
        return specs
    return [s if keep(s) else dataclasses.replace(s, hf_name=f"{prefix}{s.hf_name}")
            for s in specs]


def load_bert_checkpoint(path: str, config: Optional[BertConfig] = None, *,
                         dtype: Any = torch.float32, device: DeviceLike = None,
                         encoder_key: str = "encoder",
                         **config_overrides: Any) -> Tuple[Dict[str, Any], BertConfig]:
    """Stream an HF BERT safetensors checkpoint into the encoder and pooler
    params (bare ``BertModel`` names or a task model's ``bert.`` ones);
    task heads come from a fresh init through :func:`merge_pretrained`."""
    if config is None:
        config = bert_config_from_hf(_config_json(path), **config_overrides)
    reader = _CheckpointReader(path)
    specs = _prefixed(bert_tensor_specs(config, encoder_key=encoder_key), reader, "bert.")
    params = _load_checkpoint(path, specs, quantize=False, dtype=dtype, device=device,
                              strict=False, reader=reader)
    return params, config


def load_vit_checkpoint(path: str, config: Optional[ViTConfig] = None, *,
                        dtype: Any = torch.float32, device: DeviceLike = None,
                        **config_overrides: Any) -> Tuple[Dict[str, Any], ViTConfig]:
    """Stream an HF ViT safetensors checkpoint into the port's params (bare
    ``ViTModel`` names or ``ViTForImageClassification``'s ``vit.`` ones and
    its ``classifier`` head)."""
    if config is None:
        config = vit_config_from_hf(_config_json(path), **config_overrides)
    reader = _CheckpointReader(path)
    specs = _prefixed(vit_tensor_specs(config), reader, "vit.",
                      keep=lambda s: s.hf_name.startswith("classifier"))
    params = _load_checkpoint(path, specs, quantize=False, dtype=dtype, device=device,
                              strict=False, reader=reader)
    return params, config


def merge_pretrained(init_params: Any, loaded: Dict[str, Any]) -> Dict[str, Any]:
    """Overlay ``loaded`` pretrained subtrees onto a fresh ``init_params``
    tree (task heads keep their initialization). Raises on a loaded path
    or shape the init tree does not have."""

    def walk(path: Tuple[str, ...], base: Any, over: Any) -> Any:
        if isinstance(over, Mapping):
            if not isinstance(base, Mapping):
                raise KeyError(f"pretrained subtree {'/'.join(path)} has no counterpart in "
                               "the model's param tree (geometry mismatch?)")
            out = dict(base)
            for k, v in over.items():
                if k not in base:
                    raise KeyError(f"pretrained param {'/'.join(path + (k,))} has no "
                                   "counterpart in the model's param tree")
                out[k] = walk(path + (k,), base[k], v)
            return out
        if hasattr(base, "shape") and tuple(base.shape) != tuple(over.shape):
            raise ValueError(f"pretrained param {'/'.join(path)} has shape "
                             f"{tuple(over.shape)}, model expects {tuple(base.shape)}")
        return over

    return walk((), init_params, loaded)


def _export_checkpoint(params: Any, specs: Sequence[Any], directory: str, *,
                       config_json: Optional[Dict[str, Any]], max_shard_bytes: Optional[int],
                       skip_missing: bool = False) -> List[str]:
    """Write ``params`` in the HF layout: shards planned greedily in spec
    order from the tensors' sizes, each tensor laid out where it is and
    copied to the host only when its bytes are written (one tensor on the
    host at a time); an index when there is more than one shard."""
    os.makedirs(directory, exist_ok=True)
    flat: List[Tuple[str, Tuple[int, ...], str, int, Callable]] = []
    for spec in specs:
        node: Any = params
        try:
            for key in spec.path:
                node = node[key]
        except (KeyError, TypeError):
            if skip_missing:
                continue
            raise KeyError(f"param tree is missing {'/'.join(spec.path)} (export specs must "
                           "match the tree — was the model built with this config?)")
        names = spec.hf_names if isinstance(spec, GroupSpec) else (spec.hf_name,)
        if not isinstance(node, torch.Tensor):
            node = torch.from_numpy(np.asarray(node))
        for e, hf_name in enumerate(names):
            part = node[e] if isinstance(spec, GroupSpec) else node
            shape = tuple(spec.to_hf(torch.empty(tuple(part.shape), dtype=torch.uint8,
                                                 device="meta")).shape)
            dtype = _TORCH_ST[part.dtype]
            itemsize = np.dtype(_ST_NUMPY[dtype]).itemsize

            def fetch(part=part, spec=spec):
                # laid out where the tensor is (on the card), then copied over
                return _numpy_of(spec.to_hf(part.detach()))

            flat.append((hf_name, shape, dtype, math.prod(shape) * itemsize, fetch))
    shards: List[List[Any]] = [[]]
    size = 0
    for item in flat:
        if max_shard_bytes and shards[-1] and size + item[3] > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(item)
        size += item[3]
    meta = {"format": "pt"}
    written: List[str] = []
    if len(shards) == 1:
        out = os.path.join(directory, "model.safetensors")
        _save_safetensors(shards[0], out, meta)
        written.append(out)
    else:
        weight_map: Dict[str, str] = {}
        for i, group in enumerate(shards):
            fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            _save_safetensors(group, os.path.join(directory, fname), meta)
            written.append(os.path.join(directory, fname))
            for item in group:
                weight_map[item[0]] = fname
        index = {"metadata": {"total_size": sum(item[3] for item in flat)},
                 "weight_map": weight_map}
        with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
            json.dump(index, f, indent=2)
    if config_json is not None:
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(config_json, f, indent=2)
    return written


def export_llama_safetensors(params: Any, config: LlamaConfig, directory: str, *,
                             max_shard_bytes: Optional[int] = None,
                             tie_lm_head: bool = False) -> List[str]:
    """Write the port's fp Llama params as an HF-layout checkpoint (and its
    ``config.json``): ``max_shard_bytes`` splits it into indexed shards,
    ``tie_lm_head`` omits ``lm_head.weight``. Returns the shard paths."""
    specs = llama_tensor_specs(config)
    if tie_lm_head:
        specs = [s for s in specs if getattr(s, "hf_name", None) != "lm_head.weight"]
    config_json: Dict[str, Any] = {
        "architectures": ["MixtralForCausalLM" if config.num_experts else "LlamaForCausalLM"],
        "model_type": "mixtral" if config.num_experts else "llama",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_dim,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "num_key_value_heads": config.num_kv_heads,
        "intermediate_size": config.mlp_dim,
        "rope_theta": config.rope_theta,
        "rms_norm_eps": config.norm_eps,
        "max_position_embeddings": config.max_len,
        "tie_word_embeddings": tie_lm_head,
    }
    if config.rope_scaling is not None:
        factor, low, high, orig = config.rope_scaling
        config_json["rope_scaling"] = {
            "rope_type": "llama3", "factor": factor, "low_freq_factor": low,
            "high_freq_factor": high, "original_max_position_embeddings": orig,
        }
    if config.num_experts:
        config_json["num_local_experts"] = config.num_experts
        config_json["num_experts_per_tok"] = config.num_selected
    return _export_checkpoint(params, specs, directory, config_json=config_json,
                              max_shard_bytes=max_shard_bytes)


def export_bert_safetensors(params: Any, config: BertConfig, directory: str, *,
                            max_shard_bytes: Optional[int] = None,
                            encoder_key: str = "encoder") -> List[str]:
    """Write the port's BERT encoder and pooler params as an HF-layout
    checkpoint (task heads are not exported)."""
    config_json = {
        "architectures": ["BertModel"],
        "model_type": "bert",
        "vocab_size": config.vocab_size,
        "max_position_embeddings": config.max_len,
        "type_vocab_size": config.num_types,
        "hidden_size": config.hidden_dim,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "intermediate_size": config.mlp_dim,
        # recorded, or a tanh-GELU BERT would reload as the erf form
        "hidden_act": "gelu" if config.gelu_exact else "gelu_pytorch_tanh",
    }
    return _export_checkpoint(params, bert_tensor_specs(config, encoder_key=encoder_key),
                              directory, config_json=config_json,
                              max_shard_bytes=max_shard_bytes, skip_missing=True)


def export_vit_safetensors(params: Any, config: ViTConfig, directory: str, *,
                           max_shard_bytes: Optional[int] = None) -> List[str]:
    """Write the port's ViT params as an HF-layout checkpoint."""
    config_json = {
        "architectures": ["ViTForImageClassification"],
        "model_type": "vit",
        "image_size": config.image_size,
        "patch_size": config.patch_size,
        "hidden_size": config.hidden_dim,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "intermediate_size": config.mlp_dim,
        "qkv_bias": config.qkv_bias,
        "hidden_act": "gelu" if config.gelu_exact else "gelu_pytorch_tanh",
        "id2label": {str(i): str(i) for i in range(config.num_classes)},
    }
    return _export_checkpoint(params, vit_tensor_specs(config), directory,
                              config_json=config_json, max_shard_bytes=max_shard_bytes,
                              skip_missing=True)


def _encdec_shapes(config: Any) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    c = config
    d, h, hd, m = c.hidden_dim, c.num_heads, c.head_dim, c.mlp_dim
    out: Dict[Tuple[str, ...], Tuple[int, ...]] = {
        ("embed", "embedding"): (c.vocab_size, d), ("enc_norm", "scale"): (d,),
        ("dec_norm", "scale"): (d,), ("lm_head", "kernel"): (d, c.vocab_size),
        ("lm_head", "bias"): (c.vocab_size,),
    }

    def attn(prefix):
        for name, shape in (("q", (d, h, hd)), ("k", (d, h, hd)), ("v", (d, h, hd)),
                            ("o", (h, hd, d))):
            out[prefix + (name, "kernel")] = shape

    def block(prefix, attns, norms):
        for a in attns:
            attn(prefix + (a,))
        for n in norms:
            out[prefix + (n, "scale")] = (d,)
        for name, shape in (("gate", (d, m)), ("up", (d, m)), ("down", (m, d))):
            out[prefix + ("mlp", name, "kernel")] = shape

    for i in range(c.num_encoder_layers):
        block((f"enc_{i}",), ("attn",), ("attn_norm", "mlp_norm"))
    for i in range(c.num_decoder_layers):
        block((f"dec_{i}",), ("self_attn", "cross_attn"), ("self_norm", "cross_norm", "mlp_norm"))
    return out


def encdec_from_jax_params(params: Mapping, config: Any, device: DeviceLike = None) -> dict:
    """The reference's ``EncoderDecoder`` param tree (numpy leaves) as
    torch tensors on ``device`` (``None`` = CUDA, raising without one), same
    nesting and layout (q/k/v ``[D, H, hd]``, o ``[H, hd, D]``, the MLP
    kernels ``[in, out]``, the LM head's kernel and bias), every leaf
    checked against the :class:`~unionml_tpu_torch.models.encdec
    .EncDecConfig`. Raises ``ValueError`` on a missing or extra leaf or a
    wrong shape."""
    return _convert_checked(params, _encdec_shapes(config), resolve_device(device),
                            "encoder-decoder")
