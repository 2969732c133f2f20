"""The port's encoder-decoder against the JAX package's.

Twins of ``tests/unit/test_encdec.py``: the reference's weights (a JAX
init, bridged by ``encdec_from_jax_params``) and the same numpy sources go
through both packages in fp32 on the CPU. Greedy tokens must be equal;
logits, losses and gradients within the tolerance each test states. The
reference's tensor-parallel twin runs in the A6c rank pool
(``tests/test_torch_serving_tp.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import encdec as jencdec
from unionml_tpu.models.train import TrainState as JTrainState
from unionml_tpu.models.train import adamw as jadamw
from unionml_tpu_torch.models import convert
from unionml_tpu_torch.models.encdec import (
    ENCDEC_PARTITION_RULES,
    EncDecConfig,
    EncoderDecoder,
    make_seq2seq_generator,
    make_seq2seq_predictor,
    seq2seq_step,
)
from unionml_tpu_torch.models.train import TrainState, adamw

import torch_threads

torch_threads.share_cores()

CPU = "cpu"
#: fp32 CPU, the same arithmetic in two frameworks: logits and losses
#: (measured <= 3e-6 on these sizes)
LOGIT_ATOL = 1e-4


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


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _flat(tree, prefix=""):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


def _pair(vocab_size=97, seed=0, src_len=8, tgt_len=4):
    """(port module, port params, JAX module, JAX params)."""
    jcfg = jencdec.EncDecConfig.tiny(vocab_size=vocab_size, dtype="float32")
    jmod = jencdec.EncoderDecoder(jcfg)
    jparams = _plain(jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, src_len), jnp.int32),
                               jnp.zeros((1, tgt_len), jnp.int32))["params"])
    cfg = EncDecConfig.tiny(vocab_size=vocab_size, dtype="float32")
    return EncoderDecoder(cfg), convert.encdec_from_jax_params(jparams, cfg, device=CPU), \
        jmod, jparams


@pytest.fixture(scope="module")
def tiny_encdec():
    return _pair()


def _full_prefix_greedy(module, params, src, n_new, bos=1):
    """The gold standard: the cache-free decoder on the growing prefix."""
    src = torch.as_tensor(np.asarray(src)).long()
    toks = torch.full((src.shape[0], 1), bos, dtype=torch.long)
    out = []
    with torch.no_grad():
        for _ in range(n_new):
            logits = module(params, src, toks, src_mask=src != 0)
            nxt = logits[:, -1].argmax(-1)
            out.append(nxt)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1).numpy()


def test_cached_decode_matches_full_prefix_and_jax(tiny_encdec):
    """Cached greedy tokens equal the full-prefix recompute and the JAX
    package's scan; the training-form logits within LOGIT_ATOL of JAX's."""
    module, params, jmod, jparams = tiny_encdec
    src = np.random.default_rng(0).integers(1, 97, size=(2, 10)).astype(np.int32)
    got = make_seq2seq_generator(module, max_new_tokens=6)(params, src, None, src != 0).numpy()
    np.testing.assert_array_equal(got, _full_prefix_greedy(module, params, src, 6))
    want = np.asarray(jencdec.make_seq2seq_generator(jmod, max_new_tokens=6)(
        jparams, jnp.asarray(src), None, jnp.asarray(src != 0)))
    np.testing.assert_array_equal(got, want)
    tgt = np.concatenate([np.ones((2, 1), np.int32), got[:, :5].astype(np.int32)], axis=1)
    with torch.no_grad():
        ours = module(params, torch.from_numpy(src).long(), torch.from_numpy(tgt).long(),
                      src_mask=torch.from_numpy(src != 0)).numpy()
    theirs = np.asarray(jmod.apply({"params": jparams}, jnp.asarray(src), jnp.asarray(tgt),
                                   src_mask=jnp.asarray(src != 0)))
    np.testing.assert_allclose(ours, theirs, atol=LOGIT_ATOL, rtol=0)


def test_source_padding_is_invisible(tiny_encdec):
    module, params, _, _ = tiny_encdec
    src = np.random.default_rng(1).integers(1, 97, size=(1, 7)).astype(np.int32)
    padded = np.zeros((1, 12), np.int32)
    padded[:, :7] = src
    gen = make_seq2seq_generator(module, max_new_tokens=5)
    np.testing.assert_array_equal(gen(params, src, None, src != 0).numpy(),
                                  gen(params, padded, None, padded != 0).numpy())


def test_seq2seq_step_trains():
    """Teacher-forced training on the reference's copy-ish task: the loss
    falls over 21 AdamW steps (lr 5e-3); the first step's loss is the JAX
    package's within rtol 1e-5, and one SGD step (lr 0.5: Adam's m /
    sqrt(v) would turn near-zero gradients into +-lr coin flips) updates
    every param to the JAX package's within 1e-5 (one JAX compile: the
    loss a step reports is taken before its update, whatever the
    optimizer)."""
    import optax

    from unionml_tpu_torch.models.train import Optimizer, tree_leaves, tree_unflatten

    rng = np.random.default_rng(2)
    src = rng.integers(1, 64, size=(32, 10)).astype(np.int32)
    tgt = np.concatenate([np.full((32, 1), 1, np.int32), src[:, :6]], axis=1)
    module, params, jmod, jparams = _pair(vocab_size=64, seed=3, tgt_len=7)
    step = seq2seq_step(module)
    batch = (torch.from_numpy(src).long(), torch.from_numpy(tgt).long())
    sgd = Optimizer(lambda p: {}, lambda g, st, p: (
        tree_unflatten(g, [x * -0.5 for x in tree_leaves(g)]), st), elementwise=True)
    sgd_state, _ = step(TrainState.create(apply_fn=module, params=params, tx=sgd), batch)
    jsgd, jfirst = jax.jit(jencdec.seq2seq_step(jmod))(
        JTrainState.create(apply_fn=jmod.apply, params=jparams, tx=optax.sgd(0.5)),
        (jnp.asarray(src), jnp.asarray(tgt)))
    got, want = _flat(sgd_state.params), _flat(_np(jsgd.params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)

    state = TrainState.create(apply_fn=module, params=params, tx=adamw(5e-3))
    state, first = step(state, batch)
    np.testing.assert_allclose(float(first["loss"]), float(jfirst["loss"]), rtol=1e-5)
    for _ in range(20):
        state, metrics = step(state, batch)
    assert float(metrics["loss"]) < float(first["loss"])


def test_eos_freezes_and_cross_attention_guard(tiny_encdec):
    module, params, _, _ = tiny_encdec
    src = np.asarray([[5, 6, 7, 8]], np.int32)
    first = int(_full_prefix_greedy(module, params, src, 1)[0, 0])
    gen = make_seq2seq_generator(module, max_new_tokens=5, eos_id=first, pad_id=0)
    out = gen(params, src, None, src != 0).numpy()[0]
    assert out[0] == first and (out[1:] == 0).all()

    from unionml_tpu_torch.models.layers import Attention

    attn = Attention(num_heads=2, causal=True, features=16)
    x = torch.zeros((1, 4, 16))
    p = {n: {"kernel": torch.zeros((16, 2, 8))} for n in "qkv"}
    p["o"] = {"kernel": torch.zeros((2, 8, 16))}
    with pytest.raises(ValueError, match="cross attention"):
        attn(p, x, kv=x)


def test_seq2seq_step_accumulation_and_pad_id():
    """accumulate_steps=2 gives the single batch's loss (rtol 2e-3, the
    reference's bound), each as the JAX package's; a custom pad_id hides
    its ids."""
    rng = np.random.default_rng(5)
    src = rng.integers(2, 64, size=(16, 8)).astype(np.int32)
    tgt = np.concatenate([np.full((16, 1), 1, np.int32), src[:, :4]], axis=1)
    module, params, jmod, jparams = _pair(vocab_size=64, seed=0, tgt_len=5)

    def fresh():
        return TrainState.create(apply_fn=module, params=params, tx=adamw(1e-3))

    _, m_base = seq2seq_step(module)(fresh(), (torch.from_numpy(src).long(),
                                               torch.from_numpy(tgt).long()))
    micro = (torch.from_numpy(src.reshape(2, 8, 8)).long(),
             torch.from_numpy(tgt.reshape(2, 8, 5)).long())
    _, m_acc = seq2seq_step(module, accumulate_steps=2)(fresh(), micro)
    np.testing.assert_allclose(float(m_base["loss"]), float(m_acc["loss"]), rtol=2e-3)
    jstate = JTrainState.create(apply_fn=jmod.apply, params=jparams, tx=jadamw(1e-3))
    _, jm = jax.jit(jencdec.seq2seq_step(jmod, accumulate_steps=2))(
        jstate, (jnp.asarray(src.reshape(2, 8, 8)), jnp.asarray(tgt.reshape(2, 8, 5))))
    np.testing.assert_allclose(float(m_acc["loss"]), float(jm["loss"]), rtol=1e-5)

    gen = make_seq2seq_generator(module, max_new_tokens=4)
    src1 = rng.integers(2, 62, size=(1, 6)).astype(np.int32)
    padded = np.concatenate([src1, np.full((1, 4), 63, np.int32)], axis=1)
    np.testing.assert_array_equal(gen(params, src1, None, src1 != 63).numpy(),
                                  gen(params, padded, None, padded != 63).numpy())


class _State:
    def __init__(self, params):
        self.params = params


def test_seq2seq_predictor_ragged_buckets_and_warmup(tiny_encdec):
    module, params, _, _ = tiny_encdec
    s = _State(params)
    pred = make_seq2seq_predictor(module, max_new_tokens=5, src_buckets=(8, 16))
    sources = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10]]
    out = pred(s, sources)
    assert len(out) == 2 and all(len(r) == 5 for r in out)
    for src_row, got in zip(sources, out):
        want = _full_prefix_greedy(module, params, np.asarray([src_row], np.int32), 5)[0]
        assert got == want.tolist(), (got, want)
    assert pred.warmup(s, max_batch=4) == 2 * 3
    with pytest.raises(ValueError, match="not configured"):
        pred.warmup(s, max_batch=1, buckets=(64,))
    with pytest.raises(ValueError, match="empty bucket tuple"):
        pred.warmup(s, max_batch=1, buckets=())
    first = out[0][0]
    pred_eos = make_seq2seq_predictor(module, max_new_tokens=5, src_buckets=(8,), eos_id=first)
    assert pred_eos(s, [sources[0]])[0] == [first]


def test_seq2seq_predictor_rejects_oversized_source(tiny_encdec):
    module, params, _, _ = tiny_encdec
    pred = make_seq2seq_predictor(module, max_new_tokens=3, src_buckets=(8,))
    with pytest.raises(ValueError, match="exceeds the largest"):
        pred(_State(params), [list(range(1, 12))])


def test_partition_rules_match_reference():
    got = [(r.pattern, tuple(r.spec)) for r in ENCDEC_PARTITION_RULES]
    want = [(r.pattern, tuple(r.spec)) for r in jencdec.ENCDEC_PARTITION_RULES]
    assert got == want


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


def test_chip_smoke_encdec_rehearsal_on_cpu():
    """chip_smoke.py's phase 9c at the tiny config on the CPU (bf16
    training and predictor, the fp32 cached-vs-recomputed check)."""
    smoke = _chip_smoke()
    out = smoke.encdec_check(EncDecConfig.tiny(), device="cpu", batch=4, src_len=16,
                             tgt_len=8, new_tokens=4)
    assert out["cached_equals_recompute"] and out["losses"][-1] < out["losses"][0]
