"""The port's HF checkpoint converter against the JAX package's.

Twins of ``tests/unit/test_convert.py``: the same reference params (a JAX
init, bridged into the port) go out through the port's
``export_*_safetensors`` and back through its streamed loaders, bit for
bit; the JAX package reads the port's checkpoints and the port reads the
JAX package's, bit for bit; the streamed int8 / packed-int4 trees equal
the port's own ``quantize_params`` of the fp load bit for bit and the JAX
package's streamed trees in fp32 on the CPU. The port reads and writes
the format itself: the ``safetensors`` package (imported by this test
only) is the oracle in both directions.
"""

import json
import os
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import convert as jconvert
from unionml_tpu.models.bert import BertClassifier as JBertClassifier
from unionml_tpu.models.bert import BertConfig as JBertConfig
from unionml_tpu.models.bert import BertEncoder as JBertEncoder
from unionml_tpu.models.llama import Llama as JLlama
from unionml_tpu.models.llama import LlamaConfig as JLlamaConfig
from unionml_tpu_torch.models import convert
from unionml_tpu_torch.models.bert import BertClassifier, BertConfig
from unionml_tpu_torch.models.llama import Llama, LlamaConfig
from unionml_tpu_torch.models.quantization import LLAMA_QUANT_PATTERNS, quantize_params

import torch_threads

torch_threads.share_cores()

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The module's torch work on one intra-op thread: its ops are small,
    and under a loaded host (the suite's parallel workers) a pool of
    threads waiting on each other makes each of them far slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _flat(tree, prefix=""):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return {prefix[:-1]: (t.view(torch.int16).numpy().view(np.uint16), "bfloat16")
                if t.dtype == torch.bfloat16 else (t.numpy(), str(t.numpy().dtype))}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return {prefix[:-1]: (arr.view(np.uint16), "bfloat16")}
    return {prefix[:-1]: (arr, str(arr.dtype))}


def _assert_trees_equal(a, b, exact=True):
    """Same paths, dtypes, shapes; values bit for bit (or within 1e-6)."""
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys(), sorted(set(fa) ^ set(fb))
    for path, (x, dx) in fa.items():
        y, dy = fb[path]
        assert dx == dy, (path, dx, dy)
        assert x.shape == y.shape, path
        if exact:
            np.testing.assert_array_equal(x, y, err_msg=path)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=path)


def _tiny(**over):
    return dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4, num_kv_heads=2,
                mlp_dim=128, max_len=256, rope_theta=10_000.0, dtype="float32", **over)


def _jax_llama(**over):
    cfg = JLlamaConfig(**_tiny(**over))
    params = JLlama(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    return _np(params)


@pytest.fixture(scope="module")
def tiny_llama():
    """(port config, port params, the JAX package's params)."""
    jparams = _jax_llama()
    cfg = LlamaConfig(**_tiny())
    return cfg, convert.from_jax_params(jparams, cfg, device=CPU), jparams


# --------------------------------------------------------------------- #
# the format: the port's reader and writer against the safetensors package
# --------------------------------------------------------------------- #


def _mixed_tensors():
    rng = np.random.default_rng(0)
    return {
        "f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.normal(size=(7,)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.normal(size=(4, 2, 3)).astype(np.float32)).bfloat16(),
        "i8": torch.from_numpy(rng.integers(-127, 128, size=(6, 4)).astype(np.int8)),
        "i64": torch.from_numpy(rng.integers(0, 1 << 40, size=(2,)).astype(np.int64)),
        "u8": torch.from_numpy(rng.integers(0, 256, size=(9,)).astype(np.uint8)),
        "empty": torch.zeros((0, 3)),
        "scalar": torch.tensor(3.5),
    }


def _plan(tensors):
    """The writer's plan of ``tensors``: each one fetched when its bytes
    are due."""
    plan = []
    for name, t in tensors.items():
        arr, dtype = convert._numpy_of(t)
        plan.append((name, tuple(arr.shape), dtype, arr.nbytes, lambda a=arr, d=dtype: (a, d)))
    return plan


def _bits(t):
    t = t.detach()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_reader_reads_the_packages_files_bit_for_bit(tmp_path):
    """Files written by ``safetensors.torch.save_file`` (with metadata) and
    ``safetensors.numpy.save_file``: every dtype (bf16 too), empty and
    scalar tensors, the metadata."""
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import save_file

    tensors = _mixed_tensors()
    path = str(tmp_path / "a.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    st = convert._SafetensorsFile(path)
    assert st.metadata == {"format": "pt"}
    for name, t in tensors.items():
        arr, dtype = st.read(name)
        got = convert._to_torch(arr, dtype, torch.device(CPU))
        assert got.dtype == t.dtype and tuple(got.shape) == tuple(t.shape), name
        np.testing.assert_array_equal(_bits(got), _bits(t), err_msg=name)
    np_path = str(tmp_path / "b.safetensors")
    arrays = {k: _bits(v) for k, v in tensors.items() if v.dtype != torch.bfloat16}
    np_save(arrays, np_path)
    st = convert._SafetensorsFile(np_path)
    for name, a in arrays.items():
        np.testing.assert_array_equal(np.asarray(st.read(name)[0]), a, err_msg=name)


def test_package_reads_the_ports_files_bit_for_bit(tmp_path):
    """The port's writer read back by ``safetensors.safe_open``: every
    dtype, the metadata, the data section 8-aligned."""
    from safetensors import safe_open

    tensors = _mixed_tensors()
    path = str(tmp_path / "port.safetensors")
    convert._save_safetensors(_plan(tensors), path, {"format": "pt"})
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert sorted(f.keys()) == sorted(tensors)
        for name, t in tensors.items():
            got = f.get_tensor(name)
            assert got.dtype == t.dtype, name
            np.testing.assert_array_equal(_bits(got), _bits(t), err_msg=name)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert (8 + n) % 8 == 0


def test_reader_maps_one_tensor_not_the_file(tmp_path):
    """A read is a memory map of that tensor's bytes at its offset."""
    tensors = {"a": torch.arange(1000, dtype=torch.float32),
               "b": torch.arange(10, dtype=torch.int64)}
    path = str(tmp_path / "m.safetensors")
    convert._save_safetensors(_plan(tensors), path)
    st = convert._SafetensorsFile(path)
    arr, _ = st.read("b")
    assert isinstance(arr, np.memmap)
    assert arr.offset == st.data_start + st.entries["b"]["data_offsets"][0]
    assert arr.nbytes == 80


def test_reader_refuses_truncated_and_corrupt_files(tmp_path):
    """A file cut inside its data section, inside its header, or with a
    header length past its end raises ``ValueError`` naming the file (and
    the tensor whose bytes are missing), before any tensor is mapped."""
    tensors = {"a": torch.arange(1000, dtype=torch.float32),
               "b": torch.arange(10, dtype=torch.int64)}
    path = tmp_path / "whole.safetensors"
    convert._save_safetensors(_plan(tensors), str(path))
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    cut = tmp_path / "cut.safetensors"
    cut.write_bytes(raw[:-40])
    with pytest.raises(ValueError, match=r"cut\.safetensors.*'b' spans bytes"):
        convert._SafetensorsFile(str(cut))
    cut.write_bytes(raw[:8 + n // 2])
    with pytest.raises(ValueError, match=r"cut\.safetensors.*header of"):
        convert._SafetensorsFile(str(cut))
    cut.write_bytes((1 << 60).to_bytes(8, "little") + raw[8:])
    with pytest.raises(ValueError, match=r"cut\.safetensors.*header of"):
        convert._SafetensorsFile(str(cut))
    cut.write_bytes(raw[:8] + b"{" * n + raw[8 + n:])
    with pytest.raises(ValueError, match=r"cut\.safetensors: unreadable safetensors header"):
        convert._SafetensorsFile(str(cut))
    cut.write_bytes(raw[:5])
    with pytest.raises(ValueError, match=r"cut\.safetensors"):
        convert._SafetensorsFile(str(cut))


# --------------------------------------------------------------------- #
# twins of tests/unit/test_convert.py
# --------------------------------------------------------------------- #


def test_llama_roundtrip_bit_exact(tiny_llama, tmp_path):
    cfg, params, jparams = tiny_llama
    convert.export_llama_safetensors(params, cfg, str(tmp_path))
    assert (tmp_path / "model.safetensors").exists()
    loaded, loaded_cfg = convert.load_llama_checkpoint(str(tmp_path), dtype=torch.float32,
                                                       strict=True, device=CPU)
    assert loaded_cfg.hidden_dim == cfg.hidden_dim
    assert loaded_cfg.num_kv_heads == cfg.num_kv_heads
    _assert_trees_equal(params, loaded)
    # the JAX package reads the port's checkpoint, and the port the JAX
    # package's, bit for bit
    jloaded, _ = jconvert.load_llama_checkpoint(str(tmp_path), dtype=jnp.float32, strict=True)
    _assert_trees_equal(jparams, _np(jloaded))
    jdir = tmp_path / "jax"
    jconvert.export_llama_safetensors(jparams, JLlamaConfig(**_tiny()), str(jdir))
    back, _ = convert.load_llama_checkpoint(str(jdir), dtype=torch.float32, strict=True,
                                            device=CPU)
    _assert_trees_equal(params, back)


def test_llama_roundtrip_multishard(tiny_llama, tmp_path):
    cfg, params, _ = tiny_llama
    written = convert.export_llama_safetensors(params, cfg, str(tmp_path),
                                               max_shard_bytes=200_000)
    assert len(written) > 1
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert set(index["weight_map"].values()) == {os.path.basename(p) for p in written}
    loaded, _ = convert.load_llama_checkpoint(str(tmp_path), cfg, dtype=torch.float32,
                                              device=CPU)
    _assert_trees_equal(params, loaded)


def test_llama_tied_lm_head_fallback(tiny_llama, tmp_path):
    cfg, params, _ = tiny_llama
    convert.export_llama_safetensors(params, cfg, str(tmp_path), tie_lm_head=True)
    loaded, _ = convert.load_llama_checkpoint(str(tmp_path), cfg, dtype=torch.float32,
                                              device=CPU)
    np.testing.assert_array_equal(loaded["lm_head"]["kernel"].numpy(),
                                  params["embed"]["embedding"].numpy().T)


@pytest.mark.parametrize("bits,group", [(8, 0), (4, 0), (4, 32)],
                         ids=["int8", "int4", "int4_g32"])
def test_llama_streamed_quantized_matches_quantize_params(tiny_llama, tmp_path, bits, group):
    """The streamed int8 / int4 tree equals the port's quantize_params of
    the fp load bit for bit, and the JAX package's streamed tree (fp32 on
    the CPU); it loads into the quantized module."""
    cfg, params, _ = tiny_llama
    convert.export_llama_safetensors(params, cfg, str(tmp_path))
    qkw = dict(quantized=True, weight_bits=bits, int4_group=group)
    qcfg = LlamaConfig(**_tiny(**qkw))
    streamed, _ = convert.load_llama_checkpoint(str(tmp_path), qcfg, dtype=torch.float32,
                                                device=CPU)
    direct, _ = convert.load_llama_checkpoint(str(tmp_path), cfg, dtype=torch.float32,
                                              device=CPU)
    _assert_trees_equal(streamed, quantize_params(direct, LLAMA_QUANT_PATTERNS, bits=bits,
                                                  group_size=group))
    jstreamed, _ = jconvert.load_llama_checkpoint(str(tmp_path), JLlamaConfig(**_tiny(**qkw)),
                                                  dtype=jnp.float32)
    _assert_trees_equal(streamed, _np(jstreamed))
    with torch.no_grad():
        logits = Llama(qcfg)(streamed, torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 4, cfg.vocab_size)


def test_streaming_memory_bound(tmp_path):
    """Peak host staging memory stays about one tensor, not the
    checkpoint (the loaded tensors are the device's, here torch's own
    allocations, which tracemalloc does not count)."""
    over = dict(vocab_size=2048, hidden_dim=256, num_layers=6, num_heads=8, num_kv_heads=4,
                mlp_dim=1024)
    cfg = LlamaConfig(**{**_tiny(), **over})
    from unionml_tpu_torch.models.llama import init_params

    params = init_params(cfg, seed=0, device=CPU)
    convert.export_llama_safetensors(params, cfg, str(tmp_path))
    from unionml_tpu_torch.models.train import tree_leaves

    leaves = tree_leaves(params)
    total = sum(t.numel() * 4 for t in leaves)
    largest = max(t.numel() * 4 for t in leaves)
    del params, leaves
    tracemalloc.start()
    convert.load_llama_checkpoint(str(tmp_path), cfg, dtype=torch.float32, device=CPU)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert total > 4 * largest, "fixture too small to discriminate"
    assert peak < max(4 * largest, total // 2), f"peak host staging {peak} vs checkpoint {total}"


def test_missing_tensor_is_loud(tiny_llama, tmp_path):
    cfg, params, _ = tiny_llama
    convert.export_llama_safetensors(params, cfg, str(tmp_path))
    with pytest.raises(KeyError, match="missing"):
        convert.load_llama_checkpoint(str(tmp_path), LlamaConfig(**{**_tiny(), "num_layers": 3}),
                                      device=CPU)


def test_strict_rejects_unconsumed_tensors(tiny_llama, tmp_path):
    cfg, params, _ = tiny_llama
    convert.export_llama_safetensors(params, cfg, str(tmp_path))
    from safetensors.numpy import save_file

    save_file({"model.rotary.inv_freq": np.zeros(4, np.float32)},
              str(tmp_path / "extra.safetensors"))
    with pytest.raises(KeyError, match="does not consume"):
        convert.load_llama_checkpoint(str(tmp_path), cfg, strict=True, device=CPU)
    loaded, _ = convert.load_llama_checkpoint(str(tmp_path), cfg, dtype=torch.float32,
                                              device=CPU)
    _assert_trees_equal(params, loaded)


def test_llama_config_from_hf_mapping():
    hf = {"vocab_size": 128256, "hidden_size": 4096, "num_hidden_layers": 32,
          "num_attention_heads": 32, "num_key_value_heads": 8, "intermediate_size": 14336,
          "rope_theta": 500000.0, "max_position_embeddings": 131072}
    cfg = convert.llama_config_from_hf(hf, max_len=8192, quantized=True)
    assert cfg.num_kv_heads == 8
    assert cfg.max_len == 8192
    assert cfg.quantized
    want = jconvert.llama_config_from_hf(hf, max_len=8192, quantized=True)
    assert {k: getattr(cfg, k) for k in want.__dataclass_fields__} == want.__dict__


def _jax_bert(encoder_only=False):
    jcfg = JBertConfig.tiny()
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": "float32"})
    module = JBertEncoder(jcfg) if encoder_only else JBertClassifier(jcfg)
    toks = jnp.zeros((1, 8), jnp.int32)
    params = module.init(jax.random.PRNGKey(0), toks,
                         token_type_ids=jnp.zeros((1, 8), jnp.int32))["params"]
    return _np(params)


def _port_bert():
    cfg = BertConfig.tiny()
    return BertConfig(**{**cfg.__dict__, "dtype": "float32"})


def test_bert_roundtrip_and_merge(tmp_path):
    cfg = _port_bert()
    params = convert.bert_from_jax_params(_jax_bert(), cfg, device=CPU)
    convert.export_bert_safetensors(params, cfg, str(tmp_path))
    loaded, loaded_cfg = convert.load_bert_checkpoint(str(tmp_path), device=CPU)
    assert loaded_cfg.hidden_dim == cfg.hidden_dim
    merged = convert.merge_pretrained(params, loaded)
    _assert_trees_equal(merged["encoder"], params["encoder"])
    _assert_trees_equal(merged["pooler"], params["pooler"])
    np.testing.assert_array_equal(merged["head"]["kernel"].numpy(),
                                  params["head"]["kernel"].numpy())
    toks = torch.zeros((1, 8), dtype=torch.long)
    out = BertClassifier(cfg)(merged, toks, token_type_ids=toks)
    assert out.shape == (1, cfg.num_classes)
    # the JAX package reads the port's BERT checkpoint bit for bit
    jloaded, _ = jconvert.load_bert_checkpoint(str(tmp_path), dtype=jnp.float32)
    _assert_trees_equal(loaded, _np(jloaded))


def test_bert_encoder_key_empty_roots_tree(tmp_path):
    cfg = _port_bert()
    params = convert.bert_from_jax_params(_jax_bert(encoder_only=True), cfg, device=CPU)
    convert.export_bert_safetensors(params, cfg, str(tmp_path), encoder_key="")
    loaded, _ = convert.load_bert_checkpoint(str(tmp_path), cfg, encoder_key="", device=CPU)
    _assert_trees_equal(params, loaded, exact=False)


def test_bert_prefixed_checkpoint_names(tmp_path):
    """A task model's checkpoint carries a ``bert.`` prefix: detected."""
    cfg = _port_bert()
    params = convert.bert_from_jax_params(_jax_bert(), cfg, device=CPU)
    convert.export_bert_safetensors(params, cfg, str(tmp_path))
    from safetensors.numpy import load_file, save_file

    tensors = load_file(str(tmp_path / "model.safetensors"))
    save_file({f"bert.{k}": v for k, v in tensors.items()}, str(tmp_path / "model.safetensors"))
    loaded, _ = convert.load_bert_checkpoint(str(tmp_path), cfg, device=CPU)
    _assert_trees_equal(loaded["encoder"], params["encoder"])


def test_merge_pretrained_rejects_unknown_and_mismatched():
    base = {"a": {"w": torch.zeros((2, 2))}}
    with pytest.raises(KeyError, match="no counterpart"):
        convert.merge_pretrained(base, {"b": {"w": torch.zeros((2, 2))}})
    with pytest.raises(ValueError, match="shape"):
        convert.merge_pretrained(base, {"a": {"w": torch.zeros((3, 2))}})


@pytest.fixture(scope="module")
def tiny_moe():
    jparams = _jax_llama(num_experts=4, num_selected=2)
    cfg = LlamaConfig(**_tiny(num_experts=4, num_selected=2))
    return cfg, convert.from_jax_params(jparams, cfg, device=CPU), jparams


def test_moe_roundtrip_bit_exact(tiny_moe, tmp_path):
    cfg, params, jparams = tiny_moe
    convert.export_llama_safetensors(params, cfg, str(tmp_path))
    loaded, loaded_cfg = convert.load_llama_checkpoint(str(tmp_path), dtype=torch.float32,
                                                       strict=True, device=CPU)
    assert loaded_cfg.num_experts == 4 and loaded_cfg.num_selected == 2
    _assert_trees_equal(params, loaded)
    bf16, _ = convert.load_llama_checkpoint(str(tmp_path), cfg, device=CPU)
    assert bf16["block_0"]["moe"]["router_kernel"].dtype == torch.float32
    assert bf16["block_0"]["moe"]["w_gate"].dtype == torch.bfloat16
    jloaded, _ = jconvert.load_llama_checkpoint(str(tmp_path), dtype=jnp.float32, strict=True)
    _assert_trees_equal(jparams, _np(jloaded))


def test_moe_streamed_int8_matches_quantize_params(tiny_moe, tmp_path):
    cfg, params, _ = tiny_moe
    convert.export_llama_safetensors(params, cfg, str(tmp_path))
    streamed, _ = convert.load_llama_checkpoint(str(tmp_path), cfg, quantize=True, device=CPU)
    reference = quantize_params(params, LLAMA_QUANT_PATTERNS)
    moe_s, moe_r = streamed["block_0"]["moe"], reference["block_0"]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        for leaf in (f"{name}_q", f"{name}_scale"):
            np.testing.assert_array_equal(moe_s[leaf].numpy(), moe_r[leaf].numpy())
    qcfg = LlamaConfig(**_tiny(num_experts=4, num_selected=2, quantized=True))
    with torch.no_grad():
        logits = Llama(qcfg)(streamed, torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 4, cfg.vocab_size)


@pytest.mark.parametrize("qkv_bias", [True, False], ids=["qkv_bias", "bias_free"])
def test_vit_roundtrip_bit_exact(tmp_path, qkv_bias):
    """Twins of the reference's ViT round trip and its bias-free form (the
    bias specs are emitted only when the config carries biases)."""
    from unionml_tpu.models.vit import ViT as JViT
    from unionml_tpu.models.vit import ViTConfig as JViTConfig
    from unionml_tpu_torch.models.vit import ViTConfig

    jcfg = JViTConfig.tiny()
    jcfg = type(jcfg)(**{**jcfg.__dict__, "qkv_bias": qkv_bias, "dtype": "float32"})
    jparams = _np(JViT(jcfg).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3)))["params"])
    cfg = ViTConfig(**{**ViTConfig.tiny().__dict__, "qkv_bias": qkv_bias, "dtype": "float32"})
    params = convert.vit_from_jax_params(jparams, cfg, device=CPU)
    convert.export_vit_safetensors(params, cfg, str(tmp_path))
    loaded, loaded_cfg = convert.load_vit_checkpoint(
        str(tmp_path), num_classes=cfg.num_classes, dtype=torch.float32,
        image_size=cfg.image_size, patch_size=cfg.patch_size, device=CPU)
    assert loaded_cfg.qkv_bias == qkv_bias and loaded_cfg.hidden_dim == cfg.hidden_dim
    _assert_trees_equal(params, loaded)
    jloaded, _ = jconvert.load_vit_checkpoint(
        str(tmp_path), num_classes=cfg.num_classes, dtype=jnp.float32,
        image_size=cfg.image_size, patch_size=cfg.patch_size)
    _assert_trees_equal(jparams, _np(jloaded))


def test_llama_export_preserves_rope_scaling_and_eps(tmp_path):
    over = dict(rope_scaling=(8.0, 1.0, 4.0, 32), norm_eps=1e-6)
    cfg = LlamaConfig(**_tiny(**over))
    params = convert.from_jax_params(_jax_llama(**over), cfg, device=CPU)
    convert.export_llama_safetensors(params, cfg, str(tmp_path))
    _, loaded_cfg = convert.load_llama_checkpoint(str(tmp_path), dtype=torch.float32,
                                                  device=CPU)
    assert loaded_cfg.rope_scaling == (8.0, 1.0, 4.0, 32)
    assert loaded_cfg.norm_eps == 1e-6


def test_loader_defaults_to_cuda():
    """An entry point without ``device`` asks for the card, and raises
    without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        convert._load_checkpoint("unused", [], quantize=False, dtype=torch.float32,
                                 device=None, strict=False, reader=object())


def _chip_smoke():
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(repo))
    return chip_smoke


def test_chip_smoke_hf_import_rehearsal_on_cpu():
    """chip_smoke.py's phase 9b at a tiny config on the CPU: two indexed
    shards and a config.json, the streamed int8 tree bit for bit
    quantize_params', the engine's tokens equal from both."""
    smoke = _chip_smoke()
    cfg = LlamaConfig(**{**_tiny(), "hidden_dim": 128, "mlp_dim": 256, "dtype": "bfloat16"})
    out = smoke.hf_import_check(cfg, device="cpu", new_tokens=4, lengths=(5, 20),
                                buckets=(32, 64))
    assert out["tokens_equal"] and out["bytes"] > 0 and out["leaves"] > 0
