"""The port's diagnostics (:mod:`unionml_tpu_torch.diagnostics`) against
the JAX package's, on the CPU.

The same numpy-seeded trees go through both packages: ``StepTimer``,
``assert_finite`` (its messages string for string, on the reference's
test trees, on the tiny Llama's tree bridged by ``from_jax_params`` in
fp32, bf16 and int8, and on a train state), ``nan_guard`` (a planted NaN
in ``block_0``'s ``attn_norm`` scale raising ``FloatingPointError`` from
the Llama forward and from a ``DecodeEngine`` in both packages; the port
names kernel row 2 on its plain version; a clean run keeps its tokens;
the engine's, batcher's and feed's threads see a guard entered on the
caller's; C15, the engine made before the guard; a planted row whose
check is bypassed), and ``describe_sharding`` / ``assert_sharding`` on
four gloo ranks (:mod:`torch_ranks`) against the reference's on four of
the virtual CPU devices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unionml_tpu import diagnostics as jdiag
from unionml_tpu import telemetry as jtelemetry
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.serving.engine import DecodeEngine as JEngine

from torch_ranks import RankPool
from unionml_tpu_torch import telemetry
from unionml_tpu_torch.diagnostics import (
    StepTimer,
    assert_finite,
    nan_guard,
)
from unionml_tpu_torch.models import Llama, LlamaConfig, from_jax_params
from unionml_tpu_torch.ops import _build, fused_norm
from unionml_tpu_torch.serving import DecodeEngine

import torch_threads

torch_threads.share_cores()

VOCAB = 61
PLANT = ("block_0", "attn_norm", "scale")
ROW_2 = "row 2, fused_norm.norm_fwd"
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8]]


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4, connect=False)   # the ranks boot while the first cases run
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jax_params():
    jcfg = JConfig.tiny(vocab_size=VOCAB, dtype="float32")
    jp = JLlama(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, jp)


def _configs(**kw):
    return (JConfig.tiny(vocab_size=VOCAB, dtype="float32"),
            LlamaConfig.tiny(vocab_size=VOCAB, dtype="float32", norm_impl="fused", **kw))


def _planted(tree, value=np.nan, index=3):
    """A copy of ``tree`` with ``value`` at ``index`` of the PLANT leaf."""
    def copy(node, path):
        if not path:
            leaf = node.clone() if isinstance(node, torch.Tensor) else np.array(node)
            leaf.reshape(-1)[index] = value
            return leaf
        return {**node, path[0]: copy(node[path[0]], path[1:])}

    return copy(tree, PLANT)


def _message(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except (FloatingPointError, AssertionError) as exc:
        return str(exc)
    return None


# --------------------------------------------------------------------- #
# StepTimer and assert_finite
# --------------------------------------------------------------------- #


def test_step_timer_windows_and_summary():
    """Twin of tests/unit/test_diagnostics.py:22."""
    ours, theirs = StepTimer(window=5), jdiag.StepTimer(window=5)
    for _ in range(12):
        ours.tick(32)
        theirs.tick(32)
    s, r = ours.summary(), theirs.summary()
    assert (s["steps"], s["examples"]) == (r["steps"], r["examples"]) == (12, 12 * 32)
    assert len(ours.rates) == len(theirs.rates) == 2
    assert s["samples_per_sec_median"] > 0


def test_assert_finite_names_the_leaf():
    """Twin of tests/unit/test_diagnostics.py:33: the same trees give the
    same messages."""
    good = {"a": np.ones((3,), np.float32), "b": {"c": np.zeros((2, 2), np.float32)}}
    bad = {"a": np.ones((3,), np.float32), "b": {"c": np.array([1.0, np.nan], np.float32)}}
    ints = {"i": np.arange(3)}
    for tree in (good, ints):
        assert _message(assert_finite, _torch(tree), name="state") is None
        assert _message(jdiag.assert_finite, _jnp(tree), name="state") is None
    ours = _message(assert_finite, _torch(bad), name="state")
    assert ours == _message(jdiag.assert_finite, _jnp(bad), name="state")
    assert ours == "state['b']['c'] has 1 non-finite value(s) (shape (2,), dtype float32)"


def _torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("form", ["fp32", "fp16", "int8"])
def test_assert_finite_messages_match_on_the_llama_tree(jax_params, form):
    """The tiny Llama's tree bridged by ``from_jax_params``: a NaN in
    ``block_0``'s ``attn_norm`` scale and an inf in a later leaf name the
    same first leaf, count and dtype in both packages (fp16: the tree cast
    in both; int8: ``quantize_params`` in both, its int8 kernels skipped,
    the inf planted in a quantization scale); a clean tree passes."""
    ref, port = _llama_trees(jax_params, form)
    assert _message(assert_finite, port, name="params") is None
    assert _message(jdiag.assert_finite, ref, name="params") is None
    if form == "int8":
        # the int8 kernels are skipped: a planted scale is the first bad leaf
        path = ("block_1", "mlp", "down", "scale")
    else:
        path = ("lm_head", "kernel")
    ref_bad = _plant_at(_planted_jnp(ref), path, np.inf)
    port_bad = _plant_at(_planted(port), path, np.inf)
    ours = _message(assert_finite, port_bad, name="params")
    assert ours == _message(jdiag.assert_finite, ref_bad, name="params")
    assert ours.startswith("params['block_0']['attn_norm']['scale'] has 1 non-finite")
    dtype = {"fp32": "float32", "fp16": "float16", "int8": "float32"}[form]
    assert ours.endswith(f"(shape (64,), dtype {dtype})")
    # the first bad leaf fixed, the inf is named next, in both
    fixed = _message(assert_finite, _planted(port_bad, 1.0), name="params")
    assert fixed == _message(jdiag.assert_finite, _planted(ref_bad, 1.0), name="params")
    assert fixed.startswith(f"params[{']['.join(repr(k) for k in path)}] has 1 non-finite")


def _llama_trees(jax_params, form):
    from unionml_tpu.models.quantization import LLAMA_QUANT_PATTERNS as JPATTERNS
    from unionml_tpu.models.quantization import quantize_params as jquantize
    from unionml_tpu_torch.models import LLAMA_QUANT_PATTERNS, quantize_params

    _, cfg = _configs()
    port = from_jax_params(jax_params, cfg, device="cpu")
    ref = jax.tree_util.tree_map(jnp.asarray, jax_params)
    dtypes = {"fp16": (jnp.float16, torch.float16), "bf16": (jnp.bfloat16, torch.bfloat16)}
    if form in dtypes:
        ref = jax.tree_util.tree_map(lambda a: a.astype(dtypes[form][0]), ref)
        port = jax.tree_util.tree_map(lambda t: t.to(dtypes[form][1]), port)
    if form == "int8":
        ref, port = jquantize(ref, JPATTERNS), quantize_params(port, LLAMA_QUANT_PATTERNS)
    return ref, port


def test_assert_finite_checks_bf16_leaves_c16(jax_params):
    """C16 (a chosen divergence): the reference skips bf16 leaves
    (``np.issubdtype(bfloat16, np.floating)`` is false for ml_dtypes'
    bf16), so a NaN in a bf16 tree passes it; the port checks every
    floating leaf and names it with the reference's words."""
    ref, port = _llama_trees(jax_params, "bf16")
    assert _message(jdiag.assert_finite, _planted_jnp(ref), name="params") is None
    assert _message(assert_finite, _planted(port), name="params") == (
        "params['block_0']['attn_norm']['scale'] has 1 non-finite value(s) "
        "(shape (64,), dtype bfloat16)")


def _planted_jnp(tree):
    host = jax.tree_util.tree_map(np.asarray, tree)
    return jax.tree_util.tree_map(jnp.asarray, _planted(host))


def _plant_at(tree, path, value):
    def copy(node, rest):
        if not rest:
            if isinstance(node, torch.Tensor):
                out = node.clone()
                out.reshape(-1)[0] = value
                return out
            out = np.array(node)
            out.reshape(-1)[0] = value
            return jnp.asarray(out)
        return {**node, rest[0]: copy(node[rest[0]], rest[1:])}

    return copy(tree, path)


def test_assert_finite_messages_match_on_a_train_state(jax_params):
    """A flax ``TrainState`` and the port's over the same params: the
    fields read as ``.params`` (the step and the optimizer state follow
    the reference's order), the messages equal."""
    import optax
    from flax.training.train_state import TrainState as JTrainState

    from unionml_tpu_torch.models import TrainState, adamw

    jcfg, cfg = _configs()
    ref = JTrainState.create(apply_fn=None, params=_planted_jnp(jax_params),
                             tx=optax.adamw(1e-3))
    port = TrainState.create(apply_fn=None,
                             params=_planted(from_jax_params(jax_params, cfg, device="cpu")),
                             tx=adamw(1e-3))
    ours = _message(assert_finite, port, name="state")
    assert ours == _message(jdiag.assert_finite, ref, name="state")
    assert ours == ("state.params['block_0']['attn_norm']['scale'] has 1 non-finite "
                    "value(s) (shape (64,), dtype float32)")


# --------------------------------------------------------------------- #
# nan_guard
# --------------------------------------------------------------------- #


def test_nan_guard_toggles_and_restores():
    """Twin of tests/unit/test_diagnostics.py:43: on inside the scope, a
    NaN op raises in both, ``enable=False`` changes nothing, nested scopes
    restore the previous state."""
    assert not jax.config.jax_debug_nans and not _build.NAN_GUARD
    with jdiag.nan_guard(), nan_guard():
        assert jax.config.jax_debug_nans and _build.NAN_GUARD
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: 0.0 / x)(jnp.zeros(()))
        with pytest.raises(FloatingPointError, match=r"invalid value \(nan\) encountered in "
                                                     r"aten\.div"):
            torch.zeros(()) / torch.zeros(())
        with jdiag.nan_guard(False), nan_guard(False):
            assert jax.config.jax_debug_nans and _build.NAN_GUARD
        with jdiag.nan_guard(), nan_guard():
            pass
        assert jax.config.jax_debug_nans and _build.NAN_GUARD
        # inf passes, as under jax_debug_nans
        assert torch.isinf(1.0 / torch.zeros(()))
    assert not jax.config.jax_debug_nans and not _build.NAN_GUARD
    assert not torch._C._len_torch_dispatch_stack()
    assert torch.isnan(torch.zeros(()) / torch.zeros(()))


def _port_forward_error(cfg, params):
    ids = torch.tensor([[1, 2, 3, 4]])
    with nan_guard():
        return _message(Llama(cfg), params, ids)


def test_nan_guard_on_the_llama_forward(jax_params):
    """The planted NaN raises from the forward in both packages; the
    port's message names row 2 (its plain version here) and the clean
    forward passes the guard with the same logits."""
    jcfg, cfg = _configs()
    ids = np.array([[1, 2, 3, 4]], np.int32)
    with jdiag.nan_guard():
        with pytest.raises(FloatingPointError, match="invalid value"):
            JLlama(jcfg).apply({"params": _planted_jnp(jax_params)}, ids)
    port = from_jax_params(jax_params, cfg, device="cpu")
    assert _port_forward_error(cfg, _planted(port)) == f"invalid value (nan) encountered in {ROW_2}"
    plain = Llama(cfg)(port, torch.from_numpy(ids))
    with nan_guard():
        guarded = Llama(cfg)(port, torch.from_numpy(ids))
    assert torch.equal(plain, guarded)


def test_planted_bypassed_row_check_fails(jax_params, monkeypatch):
    """Planted fault: row 2's check bypassed. The NaN then surfaces at a
    later aten op, and the message no longer names the row, so the
    forward test's assertion fails on it."""
    _, cfg = _configs()
    bad = _planted(from_jax_params(jax_params, cfg, device="cpu"))
    monkeypatch.setattr(fused_norm, "checked", lambda out, row: out)
    message = _port_forward_error(cfg, bad)
    assert message is not None and message.startswith("invalid value (nan) encountered in aten.")
    assert message != f"invalid value (nan) encountered in {ROW_2}"


def _jax_engine(jcfg):
    return JEngine(JLlama(jcfg), slots=2, max_new_tokens=4, prompt_buckets=(8,),
                   registry=jtelemetry.MetricsRegistry())


def _engine(cfg, **kw):
    return DecodeEngine(Llama(cfg), device="cpu", slots=2, max_new_tokens=4,
                        prompt_buckets=(8,), registry=telemetry.MetricsRegistry(), **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_nan_guard_engine_built_inside_the_guard(jax_params, paged):
    """An engine made inside the guard: the planted NaN raises
    ``FloatingPointError`` from ``generate`` in both packages, the port's
    naming row 2 (raised on the engine's dispatcher thread, re-raised in
    the caller); the clean tree gives the reference's tokens under the
    guard and without it."""
    jcfg, cfg = _configs()
    port = from_jax_params(jax_params, cfg, device="cpu")
    ref_engine = _jax_engine(jcfg)
    try:
        want = ref_engine.generate(jax_params, PROMPTS)
    finally:
        ref_engine.close()
    plain = _engine(cfg, paged=paged)
    try:
        assert plain.generate(port, PROMPTS) == want
    finally:
        plain.close()
    ref_bad = _planted_jnp(jax_params)   # on the device before the guard
    with jdiag.nan_guard():
        ref_engine = _jax_engine(jcfg)
        try:
            with pytest.raises(FloatingPointError):
                ref_engine.generate(ref_bad, [[1, 2, 3]])
        finally:
            ref_engine.close()
    bad = _planted(port)
    with nan_guard():
        engine = _engine(cfg, paged=paged)
        try:
            assert engine.generate(port, PROMPTS) == want
            with pytest.raises(FloatingPointError, match=ROW_2):
                engine.generate(bad, [[1, 2, 3]])
        finally:
            engine.close()


def test_nan_guard_reaches_an_engine_built_before_it_c15(jax_params):
    """C15 (a chosen divergence): an engine made, and run on the planted
    tree, before the guard was entered. The reference's compiled programs
    do not see ``jax_debug_nans`` and give the same tokens again inside
    the guard; the port's guard reaches the engine's threads and raises,
    naming row 2. Without the guard both give the same tokens. (JAX's
    caches are cleared first: an earlier engine's programs compiled under
    the guard would carry its checks.)"""
    jax.clear_caches()
    jcfg, cfg = _configs()
    bad, ref_bad = _planted(from_jax_params(jax_params, cfg, device="cpu")), \
        _planted_jnp(jax_params)
    ref_engine = _jax_engine(jcfg)
    engine = _engine(cfg, paged=True)
    try:
        tokens = ref_engine.generate(ref_bad, [[1, 2, 3]])
        assert engine.generate(bad, [[1, 2, 3]]) == tokens
        with jdiag.nan_guard():
            assert ref_engine.generate(ref_bad, [[1, 2, 3]]) == tokens
        with nan_guard():
            with pytest.raises(FloatingPointError, match=ROW_2):
                engine.generate(bad, [[1, 2, 3]])
    finally:
        engine.close()
        ref_engine.close()


def test_nan_guard_reaches_the_batcher_and_the_feed():
    """The batcher's worker and the threaded feed's producer (its source
    and its copies) check under a guard entered on the caller's thread;
    the error reaches the caller, as the inline feed's does. Without the
    guard both pass the NaN on."""
    from unionml_tpu_torch.data.pipeline import prefetch_to_device
    from unionml_tpu_torch.serving.batcher import MicroBatcher

    batcher = MicroBatcher(lambda rows: (torch.tensor(rows) * 0.0 / 0.0).tolist(),
                           row_lists=True, max_wait_ms=1.0, registry=telemetry.MetricsRegistry(),
                           flight=telemetry.FlightRecorder())
    try:
        assert np.isnan(batcher.submit([[1.0, 2.0]])).all()
        with nan_guard():
            with pytest.raises(FloatingPointError, match=r"aten\.div\.Tensor"):
                batcher.submit([[1.0, 2.0]])
    finally:
        batcher.close()

    def source():
        yield torch.ones(2, 3)
        yield torch.zeros(2, 3) / torch.zeros(2, 3)

    for threaded in (False, True):
        got = list(prefetch_to_device(source(), device="cpu", double_buffer=threaded))
        assert torch.isnan(got[1]).all()
        with nan_guard():
            with pytest.raises(FloatingPointError, match=r"aten\.div\.Tensor"):
                list(prefetch_to_device(source(), device="cpu", double_buffer=threaded))


def test_nan_guard_names_the_norm_backward():
    """A backward's rows are checked too: a NaN cotangent through the
    fused RMSNorm raises naming row 5."""
    x = torch.randn(4, 8, requires_grad=True)
    y = fused_norm.fused_rms_norm(x, torch.ones(8))
    cotangent = torch.full_like(y, float("nan"))
    with nan_guard():
        with pytest.raises(FloatingPointError, match="row 5, fused_norm.norm_bwd"):
            y.backward(cotangent)


# --------------------------------------------------------------------- #
# describe_sharding / assert_sharding on four gloo ranks
# --------------------------------------------------------------------- #


def test_sharding_sanitizers_on_four_ranks(ranks, jax_params):
    """Twin of tests/unit/test_diagnostics.py:52 over ``data=4``: the same
    descriptions' content and the same messages, ``P("data", None)``
    apart from ``P("data")`` as in JAX; the tiny Llama placed by
    ``LLAMA_PARTITION_RULES`` over ``data=2, tensor=2`` realizes the
    reference's spec at every leaf; ``assert_finite`` reduces a DTensor
    over the whole tensor (the reference's message on every rank); the
    guard checks a DTensor op by each rank's shard (rank 2 only)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    import unionml_tpu.parallel as jpar
    from unionml_tpu.models import LLAMA_PARTITION_RULES as JRULES

    _, cfg = _configs()
    ranks.submit("sanitizers", dict(vars(cfg)), jax_params, PLANT)

    mesh = jpar.make_mesh({"data": 4}, devices=jax.devices()[:4])
    x = jax.device_put(jnp.ones((16, 4)), NamedSharding(mesh, JP("data", None)))
    tree = {"batch": x, "host": np.ones(3)}
    ref_asserts = {
        name: _message(jdiag.assert_sharding, tree, want)
        for name, want in (("placed", {"batch": JP("data", None)}),
                           ("short", {"batch": JP("data")}),
                           ("other", {"batch": JP(None, "data")}),
                           ("callable", {"batch": lambda spec: spec[0] == "data"}),
                           ("missing", {"nonexistent": JP()}))}
    config = jpar.ShardingConfig(data=2, tensor=2, rules=JRULES, devices=jax.devices()[:4])
    placed = jpar.shard_pytree(jax.tree_util.tree_map(jnp.asarray, jax_params), config)
    ref_specs = {path: tuple(leaf.sharding.spec) for path, leaf in jdiag._leaf_paths(placed)}
    ref_finite = _message(jdiag.assert_finite, _planted_jnp(jax_params), name="params")

    results = ranks.collect(timeout=180)
    for rank, out in enumerate(results):
        assert out["rank"] == rank
        assert "data" in out["describe"]["['batch']"] and "'data': 4" in out["describe"]["['batch']"]
        assert out["describe"]["['host']"] == "<host>"
        assert out["asserts"] == {k: v and f"AssertionError: {v}" for k, v in ref_asserts.items()}
        assert out["asserts"]["placed"] is None and out["asserts"]["short"] is not None
        assert out["distributed"] == (None, "data")
        assert out["llama_specs"] == ref_specs
        assert out["llama_asserts"]["kernels"] is None
        assert "realized sharding spec PartitionSpec(None, 'tensor', None)" in \
            out["llama_asserts"]["wrong"]
        assert out["finite"] == f"FloatingPointError: {ref_finite}"
        assert out["finite_clean"] is None
        want = "FloatingPointError: invalid value (nan) encountered in aten.mul.Tensor"
        assert out["guard"] == (want if rank == 2 else None)
