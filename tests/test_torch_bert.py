"""The port's BERT against the JAX package on the CPU.

``BertClassifier`` and ``BertMlm`` at the tiny geometry with the JAX
weights carried over by ``bert_from_jax_params``: logits with a padding
mask (the full-score reference with the additive bias), without one under
``xla``, ``fused`` (kernel rows 12-13, the JAX Pallas kernels in
interpret mode, the port's plain versions) and ``flash`` (rows 9-11),
with token types, and in bf16; the gradients of ``classification_step``'s
and ``mlm_step``'s losses; ten ``mlm_step`` updates; then the reference's
own BERT tests mirrored on the port (padding invariance, the masking
rule, unsigned token ids, ``mlm_step`` over padded batches), the masking
rule array for array, and the refusals. The card twins are in
``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu.models import BertClassifier as JBertClassifier
from unionml_tpu.models import BertConfig as JBertConfig
from unionml_tpu.models import BertEncoder as JBertEncoder
from unionml_tpu.models import BertMlm as JBertMlm
from unionml_tpu.models import make_mlm_batch as jmake_mlm_batch
from unionml_tpu.models import mlm_step as jmlm_step
from unionml_tpu.models import train as jtrain

from unionml_tpu_torch.models import (
    BertClassifier,
    BertConfig,
    BertEncoder,
    BertMlm,
    TrainState,
    adamw,
    bert_from_jax_params,
    classification_step,
    create_train_state,
    init_bert_params,
    lm_step,
    make_mlm_batch,
    masked_cross_entropy,
    mlm_step,
)
from unionml_tpu_torch.models.train import tree_leaves, value_and_grad

import torch_threads

torch_threads.share_cores()

VOCAB = 96
# fp32 on both sides: the same arithmetic in another summation order
FP32 = dict(rtol=1e-5, atol=1e-5)
# bf16: the same rounding points; a sum-order difference can move a value
# across a rounding boundary, one or two bf16 ulps (2**-7 relative)
BF16 = dict(rtol=2**-6, atol=2**-6)
# gradients: fp32 through ~40 ops each way
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# after a few Adam steps of lr 1e-3 (each moves a param by up to ~1e-3)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
LENGTHS = (24, 17, 9)

MODULES = {"classifier": (JBertClassifier, BertClassifier), "mlm": (JBertMlm, BertMlm),
           "encoder": (JBertEncoder, BertEncoder)}


def _configs(**overrides):
    jcfg = dataclasses.replace(JBertConfig.tiny(vocab_size=VOCAB, num_classes=3),
                               **{"dtype": "float32", **overrides})
    return jcfg, BertConfig(**dataclasses.asdict(jcfg))


def _inputs(seed=0, lengths=LENGTHS, seq=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, size=(len(lengths), seq)).astype(np.int32)
    mask = (np.arange(seq)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 0).astype(np.int32)
    types = (np.arange(seq)[None, :] >= seq // 2).astype(np.int32).repeat(len(lengths), 0)
    return ids, mask, types


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(kind, types=False, seed=0, **overrides):
    """The JAX module, its params, and the port's module and bridged
    params for ``kind`` at the tiny fp32 config (``overrides`` on both)."""
    jcfg, cfg = _configs(**overrides)
    jcls, tcls = MODULES[kind]
    jmodule = jcls(jcfg)
    ids, _, tt = _inputs()
    kwargs = {"token_type_ids": jnp.asarray(tt)} if types else {}
    jparams = jmodule.init(jax.random.PRNGKey(seed), jnp.asarray(ids), **kwargs)["params"]
    params = bert_from_jax_params(_np_tree(jparams), cfg, device="cpu")
    return jmodule, jparams, tcls(cfg), params


def _assert_trees_close(torch_tree, jax_tree, **tol):
    want = jax.tree_util.tree_leaves_with_path(jax_tree)
    got = dict((jax.tree_util.keystr(p), x)
               for p, x in jax.tree_util.tree_leaves_with_path(torch_tree))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[jax.tree_util.keystr(path)].detach().float().numpy(),
                                   np.asarray(leaf, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)


# --------------------------------------------------------------------- #
# logits
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["classifier", "mlm"])
@pytest.mark.parametrize("case", ["mask", "xla", "fused", "flash", "auto"])
def test_bert_logits_match_jax(kind, case):
    """fp32 logits from the same weights and ids: a padded batch (the
    full-score reference with the additive bias, whatever ``attn_impl``
    says), or an unmasked one through each attention impl."""
    impl = "fused" if case == "mask" else case
    jmodule, jparams, module, params = _pair(kind, attn_impl=impl)
    ids, mask, _ = _inputs(1)
    kw = {"attention_mask": mask} if case == "mask" else {}
    want = jmodule.apply({"params": jparams}, jnp.asarray(ids),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = module(params, _t(ids), **{k: _t(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_token_types_match_jax(masked):
    """A classifier tree with ``type_embed`` (flax makes it only when the
    model is first called with token types)."""
    jmodule, jparams, module, params = _pair("classifier", types=True)
    assert "type_embed" in params["encoder"]
    ids, mask, types = _inputs(2)
    kw = {"token_type_ids": types}
    if masked:
        kw["attention_mask"] = mask
    want = jmodule.apply({"params": jparams}, jnp.asarray(ids),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = module(params, _t(ids), **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_bert_encoder_tree_matches_jax():
    """A bare encoder: its tree bridged as it is, its bf16-free fp32
    output equal to the JAX encoder's."""
    jmodule, jparams, module, params = _pair("encoder")
    assert "tok_embed" in params
    ids, mask, _ = _inputs(3)
    want = jmodule.apply({"params": jparams}, jnp.asarray(ids),
                         attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = module(params, _t(ids), attention_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("kind", ["classifier", "mlm"])
@pytest.mark.parametrize("masked", [False, True])
def test_bert_bf16_logits_match_jax(kind, masked):
    """bf16 compute (the default dtype): the embeddings, products,
    attention and norms round where the reference rounds them, the heads
    are fp32. The GELU rounds once where the reference on the CPU rounds
    after each bf16 op (ROADMAP.md C6; one bf16 ulp on ~45% of the MLP's
    hidden values), so the logits are held to 2**-6 of their largest
    magnitude: the fp32 MLM head carries a one-ulp change of the encoder's
    output into every vocabulary logit."""
    jmodule, jparams, module, params = _pair(kind, dtype="bfloat16", attn_impl="fused")
    ids, mask, _ = _inputs(4)
    kw = {"attention_mask": mask} if masked else {}
    want = jmodule.apply({"params": jparams}, jnp.asarray(ids),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = module(params, _t(ids), **{k: _t(v) for k, v in kw.items()})
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2**-6, atol=2**-6 * np.abs(want).max())


def test_gelu_rounds_once_in_bf16():
    """C6: the port's GELU MLP computes the GELU in fp32 and rounds it
    once to bf16; the reference on the CPU rounds after each bf16 op. The
    two differ by at most one bf16 ulp of the larger of ``|x|`` and
    ``|gelu(x)|`` (far below zero the reference's ``1 + tanh`` rounds to
    0); the port's equals the fp32 GELU rounded once, bit for bit."""
    from flax import linen as nn

    h = np.random.default_rng(13).normal(size=(4, 128)).astype(np.float32) * 2
    x = torch.tensor(h).bfloat16()
    for approximate in (True, False):
        got = torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")
        once = torch.nn.functional.gelu(x.float(), approximate="tanh" if approximate else "none")
        assert torch.equal(got, once.bfloat16())
        want = np.asarray(nn.gelu(jnp.asarray(h, jnp.bfloat16), approximate=approximate),
                          np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), np.abs(h)))) - 7)
        assert (np.abs(got.float().numpy() - want) <= ulp).all()


# --------------------------------------------------------------------- #
# gradients and steps
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_classification_gradients_match_jax(impl):
    """The gradients of ``classification_step``'s loss (softmax CE of the
    pooled logits) with respect to every param."""
    jmodule, jparams, module, params = _pair("classifier", attn_impl=impl)
    ids, _, _ = _inputs(5)
    labels = np.array([0, 2, 1], np.int32)

    def jloss(p):
        logits = jmodule.apply({"params": p}, jnp.asarray(ids))
        import optax

        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    jvalue, jgrads = jax.value_and_grad(jloss)(jparams)

    def loss(p, batch):
        return torch.nn.functional.cross_entropy(module(p, batch[0]), batch[1].long()), {}

    (value, _), grads = value_and_grad(loss, params, (_t(ids), _t(labels)))
    np.testing.assert_allclose(float(value), float(jvalue), rtol=1e-5)
    _assert_trees_close(grads, jgrads, **GRAD_TOL)


def test_mlm_gradients_with_padding_match_jax():
    """The gradients of ``mlm_step``'s loss (masked CE, the padding mask
    through the encoder) with respect to every param."""
    jmodule, jparams, module, params = _pair("mlm")
    ids, mask, _ = _inputs(6)
    rng = np.random.default_rng(6)
    inputs, labels = make_mlm_batch(ids, mask_id=3, vocab_size=VOCAB, rng=rng)
    labels = np.where(mask == 1, labels, -100)

    def jloss(p):
        logits = jmodule.apply({"params": p}, jnp.asarray(inputs),
                               attention_mask=jnp.asarray(mask))
        return jtrain.masked_cross_entropy(logits, jnp.asarray(labels), ignore_id=-100)

    jvalue, jgrads = jax.value_and_grad(jloss)(jparams)

    def loss(p, batch):
        logits = module(p, batch[0], attention_mask=batch[2])
        return masked_cross_entropy(logits, batch[1]), {}

    (value, _), grads = value_and_grad(loss, params, (_t(inputs), _t(labels), _t(mask)))
    np.testing.assert_allclose(float(value), float(jvalue), rtol=1e-5)
    _assert_trees_close(grads, jgrads, **GRAD_TOL)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_mlm_steps_match_jax(accumulate):
    """Ten ``mlm_step`` updates (AdamW) from the same params and padded
    batches end at the JAX package's params; with ``accumulate_steps=2``
    each batch is two microbatches. The key projection's bias adds one
    constant to every score of a row, which the softmax cancels: its
    gradient is zero but for rounding in both packages, and Adam scales
    such noise up to steps of ~lr. It is held to that bound on both
    sides; every other param to ``PARAM_TOL``."""
    jmodule, jparams, module, params = _pair("mlm")
    jstate = jtrain.TrainState.create(apply_fn=jmodule.apply, params=jparams,
                                      tx=jtrain.adamw(1e-3, weight_decay=1e-4))
    state = TrainState.create(apply_fn=module, params=params, tx=adamw(1e-3, weight_decay=1e-4))
    jstep = jax.jit(jmlm_step(jmodule, accumulate_steps=accumulate))
    step = mlm_step(module, accumulate_steps=accumulate)
    rng = np.random.default_rng(7)
    lengths = (24, 20, 13, 5)
    for i in range(10):
        ids, mask, _ = _inputs(10 + i, lengths=lengths)
        inputs, labels = make_mlm_batch(ids, mask_id=3, vocab_size=VOCAB, rng=rng)
        labels = np.where(mask == 1, labels, -100)
        batch = [inputs, labels, mask]
        if accumulate > 1:
            batch = [b.reshape((accumulate, -1) + b.shape[1:]) for b in batch]
        jstate, jm = jstep(jstate, tuple(jnp.asarray(b) for b in batch))
        state, m = step(state, tuple(_t(b) for b in batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(m["perplexity"]), float(jm["perplexity"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 10
    null = [f"block_{i}" for i in range(2)]
    for block in null:
        for tree in (state.params, jstate.params):
            k_bias = np.asarray(tree["encoder"][block]["attn_k"]["bias"], np.float32)
            start = np.asarray(jparams["encoder"][block]["attn_k"]["bias"], np.float32)
            assert np.abs(k_bias - start).max() <= 10 * 1e-3 * 1.01
    strip = lambda tree: {**tree, "encoder": {  # noqa: E731
        **tree["encoder"], **{b: {k: v for k, v in tree["encoder"][b].items() if k != "attn_k"}
                              for b in null}}}
    _assert_trees_close(strip(state.params), strip(jstate.params), **PARAM_TOL)
    for block in null:
        _assert_trees_close(state.params["encoder"][block]["attn_k"]["kernel"],
                            jstate.params["encoder"][block]["attn_k"]["kernel"], **PARAM_TOL)


# --------------------------------------------------------------------- #
# the reference's own tests, mirrored on the port
# --------------------------------------------------------------------- #


def test_bert_tiny_classifier_forward_with_mask():
    """tests/unit/test_models.py:66 on the port: padding must not change
    the [CLS] logits (bf16, as the reference's test)."""
    cfg = BertConfig.tiny(vocab_size=100, num_classes=4)
    module = BertClassifier(cfg)
    ids = torch.ones((2, 10), dtype=torch.int32)
    mask = torch.tensor([[1] * 10, [1] * 5 + [0] * 5])
    params = module.init(torch.Generator().manual_seed(0), ids, attention_mask=mask)
    with torch.no_grad():
        logits = module(params, ids, attention_mask=mask)
        short = module(params, ids[:, :5], attention_mask=mask[:, :5])
    assert logits.shape == (2, 4)
    np.testing.assert_allclose(logits[1].numpy(), short[1].numpy(), rtol=2e-2, atol=2e-2)


def test_mlm_masking_rule_and_pretraining_step():
    """tests/unit/test_models.py:172 on the port: the masking rule's
    shares, and ``lm_step(BertMlm)`` over its ``(inputs, labels)`` batches
    reduces the masked CE."""
    rng = np.random.default_rng(0)
    vocab, mask_id = 1024, 103
    tokens = rng.integers(4, vocab, size=(64, 32))
    tokens[:, 0] = 0
    inputs, labels = make_mlm_batch(tokens, mask_id=mask_id, vocab_size=vocab, rng=rng,
                                    special_ids=(0,))
    selected = labels != -100
    assert 0.10 < selected.mean() < 0.20
    assert not selected[:, 0].any()
    assert (labels[selected] == tokens[selected]).all()
    assert 0.65 < (inputs[selected] == mask_id).mean() < 0.92
    assert (inputs[~selected] == tokens[~selected]).all()

    module = BertMlm(BertConfig.tiny(vocab_size=vocab))
    state = create_train_state(module, _t(inputs[:1]), learning_rate=5e-3, seed=1)
    step = lm_step(module)
    batch = (_t(inputs), _t(labels))
    state, first = step(state, batch)
    for _ in range(15):
        state, metrics = step(state, batch)
    assert float(metrics["loss"]) < float(first["loss"])


def test_mlm_masking_handles_unsigned_token_dtypes():
    """tests/unit/test_models.py:211 on the port, and the encoder takes
    the unsigned ids."""
    rng = np.random.default_rng(2)
    tokens = rng.integers(4, 1000, size=(8, 16)).astype(np.uint16)
    inputs, labels = make_mlm_batch(tokens, mask_id=103, vocab_size=1024, rng=rng)
    assert labels.dtype.kind == "i"
    assert (labels == -100).any()
    selected = labels != -100
    assert (labels[selected] == tokens.astype(np.int64)[selected]).all()
    module = BertMlm(BertConfig.tiny(vocab_size=1024))
    params = module.init(torch.Generator().manual_seed(0), torch.zeros(1, 16))
    with torch.no_grad():
        a = module(params, torch.from_numpy(tokens))
        b = module(params, torch.from_numpy(tokens.astype(np.int64)))
    assert torch.equal(a, b)


def test_mlm_step_masks_padding_and_trains():
    """tests/unit/test_models.py:226 on the port: ``mlm_step`` threads the
    attention mask and reduces the masked CE over a right-padded batch."""
    rng = np.random.default_rng(3)
    vocab = 512
    module = BertMlm(BertConfig.tiny(vocab_size=vocab))
    tokens = rng.integers(4, vocab, size=(32, 24))
    tokens[:, 20:] = 0
    inputs, labels = make_mlm_batch(tokens, mask_id=103, vocab_size=vocab, rng=rng,
                                    special_ids=(0,))
    mask = (tokens != 0).astype(np.int32)
    state = create_train_state(module, _t(inputs[:1]), learning_rate=5e-3)
    step = mlm_step(module)
    batch = (_t(inputs), _t(labels), _t(mask))
    state, first = step(state, batch)
    for _ in range(10):
        state, metrics = step(state, batch)
    assert float(metrics["loss"]) < float(first["loss"])


# --------------------------------------------------------------------- #
# the masking rule, the trees, the refusals
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint16])
def test_make_mlm_batch_equals_the_reference(dtype):
    """The same numpy generator state gives the same arrays."""
    tokens = np.random.default_rng(8).integers(0, 500, size=(16, 40)).astype(dtype)
    got = make_mlm_batch(tokens, mask_id=7, vocab_size=500, rng=np.random.default_rng(9),
                         special_ids=(0, 1, 2), mask_prob=0.3)
    want = jmake_mlm_batch(tokens, mask_id=7, vocab_size=500, rng=np.random.default_rng(9),
                           special_ids=(0, 1, 2), mask_prob=0.3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,types", [("classifier", False), ("classifier", True),
                                        ("mlm", False), ("encoder", False),
                                        ("encoder", True)])
def test_init_params_follow_the_reference_tree(kind, types):
    """``init_bert_params`` writes the JAX module's tree: the same paths
    and shapes, fp32."""
    jcfg, cfg = _configs()
    ids, _, tt = _inputs()
    kwargs = {"token_type_ids": jnp.asarray(tt)} if types else {}
    jparams = MODULES[kind][0](jcfg).init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                          **kwargs)["params"]
    head = {"classifier": "classifier", "mlm": "mlm", "encoder": None}[kind]
    params = init_bert_params(cfg, head=head, token_types=types,
                              generator=torch.Generator().manual_seed(0), device="cpu")
    want = {jax.tree_util.keystr(p): x.shape
            for p, x in jax.tree_util.tree_leaves_with_path(jparams)}
    got = {jax.tree_util.keystr(p): tuple(x.shape)
           for p, x in jax.tree_util.tree_leaves_with_path(params)}
    assert got == want
    assert all(x.dtype == torch.float32 for x in tree_leaves(params))
    # the module's own init builds the same tree
    module_params = MODULES[kind][1](cfg).init(torch.Generator().manual_seed(0), _t(ids),
                                               **({"token_type_ids": _t(tt)} if types else {}))
    assert {jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(module_params)} == set(want)


def test_bert_bridge_refuses_wrong_trees():
    jcfg, cfg = _configs()
    jparams = _np_tree(JBertClassifier(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    with pytest.raises(ValueError, match="attn_q/kernel has shape"):
        bert_from_jax_params(jparams, dataclasses.replace(cfg, num_heads=8), device="cpu")
    with pytest.raises(ValueError, match="head/kernel has shape"):
        bert_from_jax_params(jparams, dataclasses.replace(cfg, num_classes=5), device="cpu")
    with pytest.raises(ValueError, match="missing param encoder/block_2"):
        bert_from_jax_params(jparams, dataclasses.replace(cfg, num_layers=3), device="cpu")
    extra = dict(jparams, extra={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unexpected leaf extra/kernel"):
        bert_from_jax_params(extra, cfg, device="cpu")


def test_attention_impls_that_are_not_ported_raise():
    """``blockwise`` is ported: an unmasked classifier forward under it
    matches the JAX package's blockwise forward in fp32. The
    sequence-parallel impls (no sequence axis in BERT) and unknown names
    raise ``ValueError`` as in the reference."""
    jmodule, jparams, _, params = _pair("classifier", attn_impl="blockwise")
    jcfg, cfg = _configs(attn_impl="blockwise")
    ids, _, _ = _inputs()
    want = JBertClassifier(jcfg).apply({"params": jparams}, jnp.asarray(ids))
    got = BertClassifier(cfg)(params, _t(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FP32)
    for impl in ("ring", "ring_flash", "ulysses", "nope"):
        with pytest.raises(ValueError, match="unknown attention impl"):
            BertMlm(dataclasses.replace(cfg, attn_impl=impl))


def test_overlong_sequence_raises_where_the_reference_gives_nan():
    """A sequence past ``max_len``: the reference's position gather fills
    the missing rows with NaN (its logits are NaN); the port raises from
    the shape (ROADMAP.md C5)."""
    jcfg, cfg = _configs()
    jmodule, jparams, module, params = _pair("classifier")
    ids = np.ones((1, cfg.max_len + 1), np.int32)
    want = jmodule.apply({"params": jparams}, jnp.asarray(ids))
    assert np.isnan(np.asarray(want)).all()
    with pytest.raises(ValueError, match="longer than max_len"):
        module(params, _t(ids))


def test_fully_masked_row_softmaxes_uniformly_as_the_reference():
    """A row whose mask is all zeros attends every position equally in
    both packages (the bias is added to every score)."""
    jmodule, jparams, module, params = _pair("mlm")
    ids, mask, _ = _inputs(11)
    mask[1] = 0
    want = jmodule.apply({"params": jparams}, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = module(params, _t(ids), attention_mask=_t(mask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, cfg = _configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_bert_params(cfg)
    jparams = _np_tree(JBertMlm(jcfg).init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 8), jnp.int32))["params"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bert_from_jax_params(jparams, cfg)


def test_classification_step_trains_the_classifier():
    """``classification_step(BertClassifier)`` over ``(ids, labels)``
    batches (the fine-tune path the card runs): the loss falls."""
    module = BertClassifier(BertConfig.tiny(vocab_size=VOCAB, num_classes=2))
    rng = np.random.default_rng(12)
    ids = rng.integers(1, VOCAB, size=(16, 12))
    labels = (ids[:, 1] % 2).astype(np.int64)
    state = create_train_state(module, _t(ids[:1]), learning_rate=3e-3)
    step = classification_step(module)
    state, first = step(state, (_t(ids), _t(labels)))
    for _ in range(10):
        state, metrics = step(state, (_t(ids), _t(labels)))
    assert float(metrics["loss"]) < float(first["loss"])


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def test_fused_backward_keeps_the_deep_blocks_gradients_at_bert_base_width():
    """BERT-base's width and depth (12 x 768, 12 heads of 64) in bf16 from
    a random init: the last blocks' value rows are nearly equal, so ``dp -
    delta`` cancels in the attention backward. The fused backward sums
    ``delta = rowsum(e * dp) / z`` in fp32, and the flash backward sums
    ``delta = sum_j p_ij dp_ij`` in fp32 from its own p, so under both
    every gradient but the key bias (zero in exact arithmetic) keeps
    cosine 0.99 against the xla path, as chip_smoke.py's phase 3f holds it
    on the card. A ``delta`` from the bf16 output (the reference kernel's
    arithmetic, ROADMAP.md C7) puts blocks 10-11's q / k gradients at
    cosine 0.74-0.91 here under fused; under flash it read 0.57-0.61 on
    block 11 on the card before the flash backward's delta pass. Planted
    here in the flash path (chip_smoke.py's ``output_delta_fault``), it
    must read under 0.99 on the last two blocks. The port's kernels differ
    from the reference there, so the JAX package is not run."""
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    cfg = BertConfig(vocab_size=1024, num_classes=2)
    params = init_bert_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    rng = np.random.default_rng(5)
    batch = (_t(rng.integers(0, 1024, size=(2, 128))), _t(rng.integers(0, 2, size=(2,))))
    grads = {}
    for impl in ("xla", "fused", "flash"):
        module = BertClassifier(dataclasses.replace(cfg, attn_impl=impl))
        loss = lambda p, b, m=module: (torch.nn.functional.cross_entropy(m(p, b[0]), b[1]), {})  # noqa: E731
        grads[impl] = _named_leaves(value_and_grad(loss, params, batch)[1])
    for impl in ("fused", "flash"):
        cosines = {
            path: float(torch.nn.functional.cosine_similarity(a.float().flatten(),
                                                              b.float().flatten(), dim=0))
            for (path, a), (_, b) in zip(grads[impl], grads["xla"])
            if not path.endswith("attn_k/bias")
        }
        assert len(cosines) == len(grads["xla"]) - cfg.num_layers
        low = {p: c for p, c in cosines.items() if not c >= 0.99}
        assert not low, (impl, low)
    # the xla step's gradients above are the planted check's plain side too
    fault = chip_smoke.bert_flash_delta_fault(
        dataclasses.replace(cfg, attn_impl="flash"), params, batch,
        lambda logits, y: torch.nn.functional.cross_entropy(logits.float(), y),
        xla_grads=[g for _, g in grads["xla"]])
    assert fault["deep_blocks_least"] < 0.99


def test_chip_smoke_bert_phases_rehearsal_on_cpu():
    """chip_smoke.py's phases 3f and 3g at the tiny geometry on the CPU
    (the kernels' plain versions), as the script drives them on the card:
    the fine-tune through the app's model.train under both impls, the
    fused-vs-xla gradient agreement, the padded MLM steps with the padded
    row against the row alone and the unmasked step, and the basic_tpu
    template's training."""
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    _, cfg = _configs(attn_impl="fused", vocab_size=1024)   # [MASK] is id 103
    for impl in ("xla", "fused"):
        out = chip_smoke.bert_finetune_phase(dataclasses.replace(cfg, attn_impl=impl),
                                             device="cpu", batch=8, seq=16, steps=6)
        assert out["timed_steps"] == 4 and out["last_loss"] < out["first_loss"]
        assert out["launches"] == dict.fromkeys(chip_smoke.bert_kernels(), 0)
    assert chip_smoke.bert_launches_per_step(cfg, 16) == dict.fromkeys(
        chip_smoke.bert_kernels(), 2.0)
    # 96 tokens: two 64-key chunks, so the planted skipped chunk moves rows
    agree = chip_smoke.bert_grad_agreement(cfg, device="cpu", batch=4, seq=96)
    assert agree["min_grad_cosine"] > 0.9999 and agree["rerun_same_loss_bits"]
    # the flash agreement beside it; the planted bf16-output delta reads
    # under 0.99 only at BERT-base depth (the test above), not at this size
    flash = chip_smoke.bert_grad_agreement(dataclasses.replace(cfg, attn_impl="flash"),
                                           device="cpu", batch=4, seq=96, delta_fault=False)
    assert flash["min_grad_cosine"] > 0.9999 and flash["rerun_same_loss_bits"]
    assert "layer_rows" not in flash
    assert len(agree["layer_rows"]) == cfg.num_layers
    for block in agree["layer_rows"]:
        assert set(block["kernel"]) == {"out", "dq", "dk", "dv"}
        assert all(c["max_row_rel_err"] < c["limit"] and c["fault_rows_over_limit"] > 0
                   for c in block["kernel"].values())
        assert block["plain_version_vs_exact"] == {
            n: c["max_row_rel_err"] for n, c in block["kernel"].items()}
        assert block["kernel_vs_plain_version"] == dict.fromkeys(block["kernel"], 0.0)
    # a kernel path off the plain path fails the per-tensor cosine: on the
    # CPU the plain versions stand in for the kernels, so the fault is
    # planted there
    from unionml_tpu_torch.ops import fused_attention as tfa

    plain_fwd = tfa.fused_attention_fwd_plain

    def planted(q, k, v, *, causal):
        return plain_fwd(q, k, v, causal=causal) * 0.5

    tfa.fused_attention_fwd_plain = planted
    try:
        with pytest.raises(AssertionError, match="under cosine 0.99"):
            chip_smoke.path_agreement(
                "planted", BertClassifier, cfg, dataclasses.replace(cfg, attn_impl="xla"),
                lambda logits, y: torch.nn.functional.cross_entropy(logits, y),
                classification_step,
                init_bert_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
                [(torch.randint(0, 1024, (4, 16)), torch.tensor([0, 1, 1, 0]))], lr=1e-4,
                cosine_min=0.99, null_grads=(("attn_k", "bias"),))
        # and the per-block row check fails it on the block's own inputs
        layers = chip_smoke.capture_attention(
            BertClassifier(cfg),
            init_bert_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
            (torch.randint(0, 1024, (2, 96)), torch.tensor([0, 1])),
            lambda logits, y: torch.nn.functional.cross_entropy(logits, y))
    finally:
        tfa.fused_attention_fwd_plain = plain_fwd
    with pytest.raises(AssertionError, match="differs from the step's attention output"):
        chip_smoke.bert_layer_rows(layers, on_card=False)
    mlm = chip_smoke.bert_mlm_phase(cfg, device="cpu", batch=4, seq=32, min_len=8, steps=6)
    assert mlm["last_loss"] < mlm["first_loss"] and mlm["pad_max_abs_err"] < 1e-4
    assert mlm["lengths"][0] >= 8 and mlm["lengths"] == sorted(mlm["lengths"])
    basic = chip_smoke.basic_tpu_phase(device="cpu")
    assert basic["metrics"]["test"] > 0.7 and basic["params_on"] == ["cpu"]
    assert basic["steps_vs_cpu"] == 5 and basic["max_param_diff_vs_cpu"] == 0
