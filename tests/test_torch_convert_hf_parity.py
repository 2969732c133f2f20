"""Checkpoints written by ``transformers``' torch models load through the
port's converter and reproduce both the ``transformers`` logits and the
JAX package's (which loads the same checkpoint through its own
converter).

Twins of ``tests/unit/test_convert_hf_parity.py``: the HF models are built
here from configs with random weights and saved with ``save_pretrained``
(the port reads those files with its own safetensors reader). Only this
test imports ``transformers``; the port never does. Tolerances are the
reference's: a transposed kernel, a permuted head or a wrong RoPE
convention moves logits by O(1).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads

torch_threads.share_cores()

transformers = pytest.importorskip("transformers")

from unionml_tpu.models import convert as jconvert  # noqa: E402
from unionml_tpu.models.bert import BertEncoder as JBertEncoder  # noqa: E402
from unionml_tpu.models.generate import make_generator as jmake_generator  # noqa: E402
from unionml_tpu.models.llama import Llama as JLlama  # noqa: E402
from unionml_tpu_torch.models import convert  # noqa: E402
from unionml_tpu_torch.models.bert import BertEncoder  # noqa: E402
from unionml_tpu_torch.models.generate import make_generator  # noqa: E402
from unionml_tpu_torch.models.llama import Llama  # noqa: E402

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


def _llama_hf_config(**over):
    kw = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, intermediate_size=128, max_position_embeddings=256,
              rms_norm_eps=1e-5, rope_theta=10_000.0, tie_word_embeddings=False)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def hf_llama_checkpoint(tmp_path_factory):
    cfg = transformers.LlamaConfig(**_llama_hf_config(attention_bias=False, mlp_bias=False))
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval().to(torch.float32)
    path = tmp_path_factory.mktemp("hf_llama")
    model.save_pretrained(path, safe_serialization=True)
    return model, str(path)


def _llama_three_ways(path, tokens, **cfg_over):
    """The port's logits, the JAX package's and the loaded configs."""
    params, cfg = convert.load_llama_checkpoint(path, dtype=torch.float32, device=CPU,
                                                **cfg_over)
    with torch.no_grad():
        ours = Llama(dataclasses.replace(cfg, dtype="float32"))(
            params, torch.from_numpy(tokens).long()).numpy()
    jparams, jcfg = jconvert.load_llama_checkpoint(path, dtype=jnp.float32, **cfg_over)
    jax_logits = np.asarray(JLlama(dataclasses.replace(jcfg, dtype="float32")).apply(
        {"params": jparams}, jnp.asarray(tokens)))
    return ours, jax_logits, cfg


def test_llama_logits_match_torch_reference(hf_llama_checkpoint):
    hf_model, path = hf_llama_checkpoint
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 16), dtype=np.int32)
    ours, jax_logits, _ = _llama_three_ways(path, tokens, max_len=256)
    with torch.no_grad():
        theirs = hf_model(torch.tensor(tokens, dtype=torch.long)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(ours.argmax(-1), theirs.argmax(-1))
    np.testing.assert_allclose(ours, jax_logits, atol=1e-4, rtol=1e-4)


def test_llama_greedy_generation_matches_torch(hf_llama_checkpoint):
    hf_model, path = hf_llama_checkpoint
    prompt = np.random.default_rng(2).integers(0, 512, size=(2, 12), dtype=np.int32)
    params, cfg = convert.load_llama_checkpoint(path, dtype=torch.float32, max_len=256,
                                                device=CPU)
    generate = make_generator(Llama(dataclasses.replace(cfg, dtype="float32", max_len=64)),
                              max_new_tokens=8, max_len=64)
    ours = generate(params, torch.from_numpy(prompt).long()).numpy()
    with torch.no_grad():
        theirs = hf_model.generate(torch.tensor(prompt, dtype=torch.long), max_new_tokens=8,
                                   do_sample=False).numpy()[:, 12:]
    np.testing.assert_array_equal(ours, theirs)
    jparams, jcfg = jconvert.load_llama_checkpoint(path, dtype=jnp.float32, max_len=256)
    jgen = jmake_generator(JLlama(dataclasses.replace(jcfg, dtype="float32", max_len=64)),
                           max_new_tokens=8, max_len=64)
    np.testing.assert_array_equal(ours, np.asarray(jgen(jparams, jnp.asarray(prompt))))


def test_llama3_rope_scaling_matches_torch(tmp_path):
    """A Llama-3.2-style checkpoint (llama3 rope_scaling, a tied LM head)
    over more positions than its original context."""
    cfg = transformers.LlamaConfig(**_llama_hf_config(
        tie_word_embeddings=True,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 32}))
    torch.manual_seed(1)
    hf_model = transformers.LlamaForCausalLM(cfg).eval().to(torch.float32)
    hf_model.save_pretrained(tmp_path, safe_serialization=True)
    tokens = np.random.default_rng(4).integers(0, 512, size=(1, 48), dtype=np.int32)
    ours, jax_logits, loaded = _llama_three_ways(str(tmp_path), tokens)
    assert loaded.rope_scaling == (8.0, 1.0, 4.0, 32)
    with torch.no_grad():
        theirs = hf_model(torch.tensor(tokens, dtype=torch.long)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(ours.argmax(-1), theirs.argmax(-1))
    np.testing.assert_allclose(ours, jax_logits, atol=1e-4, rtol=1e-4)


def test_unsupported_rope_scaling_is_loud():
    hf = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
          "num_attention_heads": 4, "intermediate_size": 128,
          "rope_scaling": {"rope_type": "yarn", "factor": 4.0}}
    for fn in (convert.llama_config_from_hf, jconvert.llama_config_from_hf):
        with pytest.raises(NotImplementedError, match="rope_scaling"):
            fn(hf)


def test_bert_encoder_matches_torch_reference(tmp_path):
    hf_cfg = transformers.BertConfig(
        vocab_size=1024, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, max_position_embeddings=128, type_vocab_size=2,
        hidden_act="gelu",
    )
    torch.manual_seed(0)
    hf_model = transformers.BertModel(hf_cfg).eval().to(torch.float32)
    hf_model.save_pretrained(tmp_path, safe_serialization=True)
    params, cfg = convert.load_bert_checkpoint(str(tmp_path), encoder_key="", device=CPU)
    assert cfg.gelu_exact
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 1024, size=(2, 10), dtype=np.int32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 7:] = 0
    types = np.zeros((2, 10), np.int32)
    encoder = {k: v for k, v in params.items() if k != "pooler"}
    with torch.no_grad():
        ours = BertEncoder(dataclasses.replace(cfg, dtype="float32"))(
            encoder, torch.from_numpy(tokens).long(),
            attention_mask=torch.from_numpy(mask).bool(),
            token_type_ids=torch.from_numpy(types).long()).numpy()
        out = hf_model(torch.tensor(tokens, dtype=torch.long),
                       attention_mask=torch.tensor(mask, dtype=torch.long),
                       token_type_ids=torch.tensor(types, dtype=torch.long))
    theirs, their_pooled = out.last_hidden_state.numpy(), out.pooler_output.numpy()
    # padded positions attend nothing meaningful in either: real ones only
    np.testing.assert_allclose(ours[0], theirs[0], atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(ours[1, :7], theirs[1, :7], atol=2e-3, rtol=1e-3)
    pk, pb = params["pooler"]["kernel"].numpy(), params["pooler"]["bias"].numpy()
    np.testing.assert_allclose(np.tanh(ours[:, 0] @ pk + pb), their_pooled, atol=2e-3,
                               rtol=1e-3)
    jparams, jcfg = jconvert.load_bert_checkpoint(str(tmp_path), encoder_key="")
    jout = np.asarray(JBertEncoder(dataclasses.replace(jcfg, dtype="float32")).apply(
        {"params": {k: v for k, v in jparams.items() if k != "pooler"}}, jnp.asarray(tokens),
        attention_mask=jnp.asarray(mask), token_type_ids=jnp.asarray(types)))
    np.testing.assert_allclose(ours[0], jout[0], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ours[1, :7], jout[1, :7], atol=1e-4, rtol=1e-4)


def test_mixtral_logits_match_torch_reference(tmp_path):
    """Mixtral's router, per-expert w1 / w3 / w2 stacks and renormalized
    top-k routing, against both implementations."""
    cfg = transformers.MixtralConfig(**_llama_hf_config(num_local_experts=4,
                                                        num_experts_per_tok=2))
    torch.manual_seed(3)
    hf_model = transformers.MixtralForCausalLM(cfg).eval().to(torch.float32)
    hf_model.save_pretrained(tmp_path, safe_serialization=True)
    tokens = np.random.default_rng(6).integers(0, 512, size=(2, 12), dtype=np.int32)
    ours, jax_logits, loaded = _llama_three_ways(str(tmp_path), tokens)
    assert loaded.num_experts == 4 and loaded.num_selected == 2
    with torch.no_grad():
        theirs = hf_model(torch.tensor(tokens, dtype=torch.long)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-3, rtol=2e-3)
    np.testing.assert_array_equal(ours.argmax(-1), theirs.argmax(-1))
    np.testing.assert_allclose(ours, jax_logits, atol=1e-4, rtol=1e-4)


def test_vit_logits_match_torch_reference(tmp_path):
    """HF ViT (pre-LN, qkv biases, erf GELU, the OIHW patch conv)."""
    from unionml_tpu.models.vit import ViT as JViT
    from unionml_tpu_torch.models.vit import ViT

    hf_cfg = transformers.ViTConfig(image_size=32, patch_size=8, hidden_size=64,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    intermediate_size=128, hidden_act="gelu", num_labels=10)
    torch.manual_seed(4)
    hf_model = transformers.ViTForImageClassification(hf_cfg).eval().to(torch.float32)
    hf_model.save_pretrained(tmp_path, safe_serialization=True)
    params, cfg = convert.load_vit_checkpoint(str(tmp_path), device=CPU)
    assert cfg.qkv_bias and cfg.gelu_exact and cfg.num_classes == 10
    images = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ours = ViT(dataclasses.replace(cfg, dtype="float32"))(
            params, torch.from_numpy(images)).numpy()
        theirs = hf_model(torch.tensor(images.transpose(0, 3, 1, 2))).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-3, rtol=2e-3)
    np.testing.assert_array_equal(ours.argmax(-1), theirs.argmax(-1))
    jparams, jcfg = jconvert.load_vit_checkpoint(str(tmp_path))
    jout = np.asarray(JViT(dataclasses.replace(jcfg, dtype="float32")).apply(
        {"params": jparams}, jnp.asarray(images)))
    np.testing.assert_allclose(ours, jout, atol=1e-4, rtol=1e-4)
