"""The port's parallelism layer (``unionml_tpu_torch.parallel``), its
sharded feed, sharded checkpoints, skew gather and the elastic trainer
under a mesh, against the JAX package's.

Meshes, sharding configs and partition rules are compared directly: the
port resolves axis sizes and parameter specs without a process group,
and each spec must equal the reference's ``param_pspec`` for the same
path and mesh (8 virtual CPU devices here). Everything that needs ranks
runs in four gloo ranks started once for the module
(:class:`torch_ranks.RankPool`, which imports no JAX): the mesh, the
collectives under ``shard_map``, ``compile_step``. Their results are
held against the JAX package's on the same mesh shape over four of the
virtual devices, with the tolerance stated at each assertion. Where one
JAX process owns every row, each rank's rows are held against the
reference sharding's per-device index map at the same mesh position.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import unionml_tpu.parallel as jpar
from torch_ranks import RankPool
from torch_ranks import _rules as _port_rules
from unionml_tpu_torch import parallel as tpar
from unionml_tpu_torch import telemetry
from unionml_tpu_torch.models.train import tree_leaves
from unionml_tpu_torch.parallel.mesh import mesh_array
from unionml_tpu_torch.parallel.sharding import _map_with_path


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _devices(n):
    return jax.devices()[:n]


# --------------------------------------------------------------------- #
# meshes
# --------------------------------------------------------------------- #


def test_make_mesh_inferred_axis():
    for axes in ({"data": -1}, {"data": -1, "tensor": 2}):
        ref = jpar.make_mesh(axes)
        resolved, arr = mesh_array(axes, devices=range(8))
        assert resolved == dict(ref.shape)
        assert arr.shape == ref.devices.shape


def test_make_mesh_bad_sizes():
    for axes in ({"data": 3}, {"data": -1, "tensor": -1}, {"data": -1, "tensor": 3}):
        with pytest.raises(ValueError):
            jpar.make_mesh(axes)
        with pytest.raises(ValueError):
            mesh_array(axes, devices=range(8))


def test_make_mesh_rank_layout_matches_the_reference():
    """The ranks' places in the mesh are the reference's device ids on the
    simulated mesh (plain and hybrid), and a real DeviceMesh in the ranks
    holds that layout with each rank at its coordinate."""
    for axes, dcn in (({"data": 2, "tensor": 2}, None), ({"data": 2, "tensor": 2}, {"data": 2}),
                      ({"data": 4, "tensor": 2}, {"data": 2})):
        n = int(np.prod(list(axes.values())))
        ref = jpar.make_mesh(axes, devices=_devices(n), dcn_axes=dcn)
        ids = np.vectorize(lambda d: d.id)(ref.devices)
        _, arr = mesh_array(axes, devices=range(n), dcn_axes=dcn)
        np.testing.assert_array_equal(arr, ids - ids.min())


def test_make_mesh_hybrid_dcn_axes(ranks):
    """`data` spans 2 hosts while `tensor` stays inside one: a psum over
    `data` reduces the right groups (the reference's case, on 4 ranks)."""
    layout = ranks.run("mesh_layout", {"data": 2, "tensor": 2}, {"data": 2})
    _, arr = mesh_array({"data": 2, "tensor": 2}, devices=range(4), dcn_axes={"data": 2})
    for rank, got in enumerate(layout):
        np.testing.assert_array_equal(got["ranks"], arr)
        assert got["shape"] == {"data": 2, "tensor": 2}
        assert arr[tuple(got["coordinate"])] == rank
    mesh = jpar.make_mesh({"data": 2, "tensor": 2}, devices=_devices(4), dcn_axes={"data": 2})
    want = jpar.shard_map(lambda x: jax.lax.psum(x, "data"), mesh=mesh,
                          in_specs=JP(("data", "tensor")),
                          out_specs=JP(("data", "tensor")))(jnp.arange(4.0))
    for got in ranks.run("hybrid_psum"):
        np.testing.assert_array_equal(got, np.asarray(want))   # exact: small integers


def test_make_mesh_dcn_axes_validated():
    for dcn, match in (({"dat": 2}, "not a mesh axis"), ({"data": 3}, "must divide"),
                       ({"data": 0}, "must divide")):
        with pytest.raises(ValueError, match=match):
            jpar.make_mesh({"data": 4, "tensor": 2}, dcn_axes=dcn)
        with pytest.raises(ValueError, match=match):
            mesh_array({"data": 4, "tensor": 2}, devices=range(8), dcn_axes=dcn)


def test_mesh_needs_a_process_group_and_bring_up_follows_the_device(monkeypatch):
    assert tpar.cpu_multiprocess_supported()
    assert tpar.mesh_devices() == [0]
    with pytest.raises(ValueError, match="requested 2 devices"):
        tpar.mesh_devices(2)
    with pytest.raises(RuntimeError, match="multihost_initialize"):
        tpar.make_mesh({"data": -1})
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    # single process, no coordinator: nothing to bring up
    assert tpar.multihost_initialize(device="cpu") is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.multihost_initialize("127.0.0.1:1", 2, 0)


# --------------------------------------------------------------------- #
# sharding configs and partition rules
# --------------------------------------------------------------------- #


def _pair(**kw):
    return (jpar.ShardingConfig(**kw),
            tpar.ShardingConfig(**{k: v for k, v in kw.items() if k != "rules"},
                                rules=kw.get("port_rules", kw.get("rules", ())),
                                devices=range(8)))


def test_sharding_config_dp():
    ref, port = _pair(data=-1)
    assert port.mesh_shape() == dict(ref.mesh().shape) == {"data": 8}
    assert tuple(port.batch_pspec()) == tuple(ref.batch_pspec()) == ("data",)


def test_sharding_config_dp_fsdp_batch_axes():
    ref, port = _pair(data=2, fsdp=4)
    assert tuple(port.batch_pspec()) == tuple(ref.batch_pspec()) == (("data", "fsdp"),)
    assert tuple(port.microbatched().batch_pspec()) == tuple(ref.microbatched().batch_pspec())
    # fsdp fallback shards the largest divisible dim
    for path, shape in (("dense/kernel", (16, 3)), ("step", ()), ("x/y", (6, 12, 4))):
        leaf = np.zeros(shape)
        assert tuple(port.param_pspec(path, leaf)) == tuple(ref.param_pspec(path, leaf))
    assert tuple(port.param_pspec("dense/kernel", np.zeros((16, 3)))) == ("fsdp", None)


def test_partition_rules_tensor_parallel():
    spec = [(r"attn/.*kernel", (None, "tensor")), (r"mlp/out/kernel", ("tensor", None))]
    ref = jpar.ShardingConfig(data=-1, tensor=2, rules=[jpar.PartitionRule(*r) for r in spec])
    port = tpar.ShardingConfig(data=-1, tensor=2, rules=[tpar.PartitionRule(*r) for r in spec],
                               devices=range(8))
    leaf = np.zeros((8, 8))
    for path in ("layer0/attn/q/kernel", "layer0/mlp/out/kernel", "layer0/norm/scale"):
        assert tuple(port.param_pspec(path, leaf)) == tuple(ref.param_pspec(path, leaf))
    assert tuple(port.param_pspec("layer0/attn/q/kernel", leaf)) == (None, "tensor")


def test_partition_rule_tuple_entries_and_fallbacks():
    """Tuple entries shard one dim over several axes; axes missing from
    the mesh or not dividing the dim are dropped, not errors."""
    spec = [(r"big/kernel", (("fsdp", "tensor"), None)), (r"odd/kernel", (None, "tensor")),
            (r"gone/kernel", ("expert", None))]
    ref = jpar.ShardingConfig(data=2, fsdp=2, tensor=2,
                              rules=tuple(jpar.PartitionRule(*r) for r in spec))
    port = tpar.ShardingConfig(data=2, fsdp=2, tensor=2, devices=range(8),
                               rules=tuple(tpar.PartitionRule(*r) for r in spec))
    for path, shape, want in (("big/kernel", (8, 4), (("fsdp", "tensor"), None)),
                              ("odd/kernel", (4, 3), (None, None)),
                              ("gone/kernel", (4, 4), (None, None))):
        leaf = np.zeros(shape)
        assert tuple(port.param_pspec(path, leaf)) == tuple(ref.param_pspec(path, leaf)) == want


def _port_states():
    """Tiny port states of every model family, named as the reference's
    trees (params, AdamW moments, a LoRA state's frozen base)."""
    from unionml_tpu_torch.models import bert, llama, lora, mlp, vit
    from unionml_tpu_torch.models.quantization import quantize_params
    from unionml_tpu_torch.models.train import TrainState, adamw

    def state(params):
        return TrainState.create(apply_fn=None, params=params, tx=adamw(1e-3))

    lcfg = llama.LlamaConfig.tiny(vocab_size=64)
    gen = torch.Generator().manual_seed(0)
    fp = llama.init_params(lcfg, seed=0, device="cpu")
    from unionml_tpu_torch.models import LLAMA_QUANT_PATTERNS

    quant = quantize_params(fp, LLAMA_QUANT_PATTERNS)
    lora_cfg = dataclasses.replace(lcfg, lora_rank=4)
    lora_state = lora.create_lora_train_state(llama.Llama(lora_cfg), torch.zeros(1, 4, dtype=torch.long))
    qlora_cfg = dataclasses.replace(lcfg, lora_rank=4, quantized=True)
    qlora_state = lora.create_lora_train_state(llama.Llama(qlora_cfg),
                                               torch.zeros(1, 4, dtype=torch.long),
                                               base_params=quant)
    bcfg = bert.BertConfig.tiny(vocab_size=64)
    return {
        "LLAMA_PARTITION_RULES": [state(fp)],
        "LLAMA_QUANT_PARTITION_RULES": [state(quant), state(fp)],
        "LLAMA_LORA_PARTITION_RULES": [lora_state, qlora_state],
        "LORA_PARTITION_RULES": [lora_state],
        "VIT_PARTITION_RULES": [state(vit.init_params(vit.ViTConfig.tiny(), generator=gen,
                                                      device="cpu"))],
        "BERT_PARTITION_RULES": [state(bert.init_params(bcfg, head=h, device="cpu"))
                                 for h in ("classifier", "mlm")],
        "MLP_PARTITION_RULES": [state(mlp.init_params(mlp.MlpConfig(), 12, device="cpu"))],
    }


RULE_SETS = ["LLAMA_PARTITION_RULES", "LLAMA_QUANT_PARTITION_RULES",
             "LLAMA_LORA_PARTITION_RULES", "LORA_PARTITION_RULES", "VIT_PARTITION_RULES",
             "BERT_PARTITION_RULES", "MLP_PARTITION_RULES"]


def _reference_rules(name):
    from unionml_tpu.models import bert, llama, lora, mlp, vit

    for mod in (llama, vit, bert, mlp, lora):
        if hasattr(mod, name):
            return getattr(mod, name)
    raise KeyError(name)


@pytest.fixture(scope="module")
def port_states():
    return _port_states()


@pytest.mark.parametrize("name", RULE_SETS)
def test_placement_table_matches_the_reference(name, port_states):
    """For every leaf of tiny states of the family (params, both AdamW
    moments, a LoRA state's frozen base), the port's spec equals the
    reference's ``param_pspec`` for the same path and mesh (data 2 x fsdp
    2 x tensor 2, so the FSDP fallback and sanitize both act), and the
    DTensor placements follow the spec. Every rule matches some leaf."""
    ref_rules, rules = _reference_rules(name), _port_rules(name)
    assert [(r.pattern, r.spec) for r in rules] == [(r.pattern, r.spec) for r in ref_rules]
    ref = jpar.ShardingConfig(data=2, fsdp=2, tensor=2, rules=ref_rules)
    port = tpar.ShardingConfig(data=2, fsdp=2, tensor=2, rules=rules, devices=range(8))
    leaves = []
    for state in port_states[name]:
        _map_with_path(lambda path, leaf: leaves.append((path, leaf))
                       if isinstance(leaf, torch.Tensor) else None, state)
    assert leaves
    for path, leaf in leaves:
        want = ref.param_pspec(path, np.zeros(tuple(leaf.shape)))
        got = port.param_pspec(path, leaf)
        assert tuple(got) == tuple(want), path
    unmatched = [r.pattern for r in rules if not any(r.matches(p) for p, _ in leaves)]
    assert not unmatched, f"rules matching no leaf: {unmatched}"


def test_port_param_paths_are_the_reference_names():
    """The port's param trees carry the reference's flax names, so the
    rules' regexes mean the same leaves: the path sets of fresh trees are
    equal."""
    from unionml_tpu.models import llama as jllama
    from unionml_tpu.models import vit as jvit
    from unionml_tpu_torch.models import llama, vit

    def paths(tree):
        out = set()
        _map_with_path(lambda p, leaf: out.add(p), tree)
        return out

    def shapes(module, example):
        # the reference's tree by abstract evaluation (no compile)
        tree = jax.eval_shape(module.init, jax.random.PRNGKey(0), example)["params"]
        return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), tree)

    lcfg = llama.LlamaConfig.tiny(vocab_size=64)
    jl = shapes(jllama.Llama(jllama.LlamaConfig.tiny(vocab_size=64)), jnp.zeros((1, 4), jnp.int32))
    assert paths(llama.init_params(lcfg, seed=0, device="cpu")) == paths(jl)
    jv = shapes(jvit.ViT(jvit.ViTConfig.tiny()), jnp.zeros((1, 32, 32, 3)))
    assert paths(vit.init_params(vit.ViTConfig.tiny(), device="cpu")) == paths(jv)


def test_pipeline_parallelism_names_a6b():
    for name in ("pipeline_apply", "pipeline_spmd", "stack_stage_params"):
        with pytest.raises(ImportError, match="A6b"):
            __import__("unionml_tpu_torch.parallel", fromlist=[name])
    assert set(tpar.__all__) == set(jpar.__all__) - {"pipeline_apply", "pipeline_spmd",
                                                     "stack_stage_params"}


# --------------------------------------------------------------------- #
# compile_step, collectives (in the ranks)
# --------------------------------------------------------------------- #


def test_compile_step_dp_training(ranks):
    """The reference's linear regression over data=-1 (4 ranks): a user
    step differentiating by hand, its partial sums resolved by DTensor;
    the fit and the reference's on 4 devices agree."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    true_w = np.array([1.0, -2.0, 0.5, 3.0], dtype=np.float32)
    y = x @ true_w + 0.25
    cfg = jpar.ShardingConfig(data=-1, devices=_devices(4))

    def step(state, batch):
        xb, yb = batch

        def loss_fn(w, b):
            return jnp.mean((xb @ w + b - yb) ** 2)

        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(state["w"], state["b"])
        return {"w": state["w"] - 0.1 * grads[0], "b": state["b"] - 0.1 * grads[1]}, {"loss": loss}

    compiled, state = jpar.compile_step(step, {"w": jnp.zeros((4,)), "b": jnp.zeros(())},
                                        sharding=cfg, donate_state=False)
    batch = jax.device_put((x, y), cfg.batch_sharding())
    ranks.submit("linreg", x, y, 100)
    for _ in range(100):
        state, _ = compiled(state, batch)
    for got in ranks.collect():
        np.testing.assert_allclose(got["w"], true_w, atol=0.05)
        assert got["loss"] < 1e-3 and got["placement"] == "(Replicate(),)"
        # fp32 CPU, both converged: the two fits within 1e-5
        np.testing.assert_allclose(got["w"], np.asarray(state["w"]), atol=1e-5)
        np.testing.assert_allclose(got["b"], float(state["b"]), atol=1e-5)


def test_compile_step_fsdp_state_sharded(ranks):
    """data 2 x fsdp 2: the param is physically sharded over fsdp before
    and after a step, and the donated state is updated in place."""
    for got in ranks.run("fsdp_state"):
        assert got["placed"] == got["out"] == "(Replicate(), Shard(dim=0))"
        assert got["local"] == (4, 4) and got["in_place"]
        np.testing.assert_array_equal(got["value"], np.full((8, 4), 2.0, np.float32))


def test_collectives_match_the_reference(ranks):
    """Each named collective under shard_map over data=4, against
    jax.lax's under the reference's shard_map on 4 devices (exact: small
    integers)."""
    from unionml_tpu.parallel import collectives as jc

    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    mesh = jpar.make_mesh({"data": 4}, devices=_devices(4))

    def run(fn, out_spec):
        return np.asarray(jpar.shard_map(fn, mesh=mesh, in_specs=JP("data"),
                                         out_specs=out_spec, check_rep=False)(x))

    want = {
        "psum": run(lambda b: jc.psum(b, "data"), JP()),
        "pmean": run(lambda b: jc.pmean(b, "data"), JP()),
        "all_gather": run(lambda b: jc.all_gather(b, "data", gather_axis=1), JP()),
        "reduce_scatter": run(lambda b: jc.reduce_scatter(b, "data", scatter_axis=1),
                              JP("data")),
        "ppermute": run(lambda b: jc.ppermute_shift(b, "data", shift=1), JP("data")),
        "all_to_all": run(lambda b: jc.all_to_all(b, "data", split_axis=1, concat_axis=0),
                          JP("data")),
        "axis_index": run(lambda b: b * 0 + jc.axis_index("data"), JP("data")),
        "axis_size": run(lambda b: b * 0 + jc.axis_size("data"), JP("data")),
    }
    for got in ranks.run("collectives", x):
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)
        assert sum(got["issued"].values()) >= 6


def test_bucketed_psum_matches_plain_psum(ranks):
    """Bucketing changes how many collectives run, never the values: bit
    for bit the leaf-wise psum for buckets from one-per-leaf to one, each
    the reference's psum within 1 ulp-scale (its reduction order is
    XLA's); the greedy grouping puts an oversized leaf alone."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(8, 128)).astype(np.float32),
            "b": rng.normal(size=(8, 4)).astype(np.float32),
            "c": rng.normal(size=(8, 513)).astype(np.float32)}
    mesh = jpar.make_mesh({"data": 4}, devices=_devices(4))
    want = jpar.shard_map(lambda t: jax.lax.psum(t, "data"), mesh=mesh,
                          in_specs=(JP("data"),), out_specs=JP(), check_rep=False)(tree)
    for got in ranks.run("bucketed", tree, [1, 600, 1 << 20]):
        assert got["equal"] == [True, True, True]
        assert got["issued"] == [3, 3, 1]
        assert got["grouped"] == 4   # [2 leaves], [1], [oversized alone], [1]
        for k in tree:
            np.testing.assert_allclose(got["psum"][k], np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="bucket_bytes"):
        tpar.bucketed_psum({"a": torch.ones(2)}, "data", bucket_bytes=0)


def test_kernel_wrappers_take_local_shards_only(ranks):
    """A DTensor handed to a kernel wrapper raises TypeError (the kernels
    read raw pointers; the layers cross through local_call); a second
    bring-up in a rank is a no-op."""
    for got in ranks.run("refusals"):
        for name in ("fused_layer_norm", "fused_attention", "flash_attention"):
            assert got[name] and "local shards" in got[name]
        assert got["initialize_again"] is False


@pytest.fixture(scope="module")
def feed(ranks):
    return ranks.run("feed_cases")


def _jax_cfg():
    return jpar.ShardingConfig(data=2, fsdp=2, devices=_devices(4))


def _device_rows(sharding, n):
    """The reference's row range of each mesh position for a batch of n."""
    index = sharding.devices_indices_map((n,))
    mesh = sharding.mesh
    out = {}
    for pos in np.ndindex(*mesh.devices.shape):
        sl = index[mesh.devices[pos]][0]
        out[pos] = slice(sl.start or 0, n if sl.stop is None else sl.stop)
    return out


# --------------------------------------------------------------------- #
# the sharded feed (the sharded cases of tests/unit/test_data_pipeline.py)
# --------------------------------------------------------------------- #


def test_process_batch_slice_owns_the_reference_rows(feed):
    """Each rank's row range is the reference sharding's rows for the
    device at the same mesh position (rank r sits at position r here)."""
    want = _device_rows(_jax_cfg().batch_sharding(), 16)
    for rank, got in enumerate(feed):
        assert got["slice16"] == want[np.unravel_index(rank, (2, 2))]


def test_process_batch_slice_replicated_spec_owns_everything(feed):
    for got in feed:
        assert got["slice_replicated"] == slice(0, 8)


def test_process_batch_slice_rejects_row_starved_ranks(feed):
    """Two rows over four batch shards: ranks 2 and 3 own none and
    raise (one process never starves, so the reference cannot show it)."""
    assert feed[0]["starved"] is None
    assert "owns no rows" in feed[3]["starved"]


@pytest.mark.parametrize("mode", ["inline", "threaded"])
def test_prefetch_preserves_order_and_sharding(feed, mode):
    """Five batches through the inline and the threaded feed: the order
    kept, every batch assembled whole from the ranks' blocks with the
    batch sharding (rows over data and fsdp jointly)."""
    for got in feed:
        assert len(got[mode]) == 5
        for i, (x, y, placements, local) in enumerate(got[mode]):
            np.testing.assert_array_equal(x, np.full((8, 4), i, np.float32))
            np.testing.assert_array_equal(y, np.full((8,), i, np.float32))
            assert placements == "(Shard(dim=0), Shard(dim=0))" and local == (2, 4)


def test_local_batches_slices_global_batches(feed):
    g = np.arange(16, dtype=np.float32) * (1 + np.arange(16) % 3)
    want = _device_rows(_jax_cfg().batch_sharding(), 16)
    for rank, got in enumerate(feed):
        rows = want[np.unravel_index(rank, (2, 2))]
        np.testing.assert_array_equal(got["local_rows"][0], g[rows])
        np.testing.assert_array_equal(got["local_rows"][1], g[rows] * 2)


def test_local_batches_feed_roundtrip_matches_direct_put(feed):
    """local_batches -> DeviceFeed.put lands the reference's global values
    of a sharded device_put of the global batch."""
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    direct = jax.device_put(x, _jax_cfg().batch_sharding())
    for got in feed:
        np.testing.assert_array_equal(got["roundtrip"], np.asarray(direct))


def test_batch_pytree_placement(feed):
    """A dict batch: every leaf under the batch sharding, dtypes kept, the
    global rows the four ranks' blocks make."""
    for got in feed:
        assert got["pytree"]["x"] == ("(Shard(dim=0), Shard(dim=0))", (8, 3), "torch.float32")
        assert got["pytree"]["y"] == ("(Shard(dim=0), Shard(dim=0))", (8,), "torch.int32")


def test_microbatched_feed_keeps_the_microbatch_axis_whole(feed):
    ref = _jax_cfg().microbatched().batch_pspec()
    assert tuple(ref) == (None, ("data", "fsdp"))
    for got in feed:
        assert got["micro"] == ("(Shard(dim=1), Shard(dim=1))", (4, 8, 3), (4, 2, 3))


# --------------------------------------------------------------------- #
# sharded checkpoints (the orbax-backend cases)
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def ckpt(ranks, tmp_path_factory):
    return ranks.run("ckpt_cases", str(tmp_path_factory.mktemp("sharded")))


def test_sharded_roundtrip_is_bit_exact(ckpt):
    for got in ckpt:
        assert got["same_bits"] and got["same_placements"] and got["plain"]


def test_restore_re_places_onto_the_target(ckpt):
    """A checkpoint saved under data 2 x fsdp 2 restores onto fsdp 4, each
    rank reading the blocks that overlap its own."""
    for got in ckpt:
        assert got["replaced"] == ("(Replicate(), Shard(dim=0))", True)


def test_manager_rotation_latest_and_torn_dirs(ckpt):
    """max_to_keep=2 keeps the newest two committed steps; restore of the
    newest and of an older step is bit-exact; a torn tmp dir is never a
    step, and "auto" stays with a directory of sharded checkpoints."""
    for got in ckpt:
        assert got["steps"] == ["step_2", "step_3"] and got["latest"] == 3
        assert got["latest_bits"] and got["older_bits"]
        assert got["auto_kind"] == "unionml_tpu_torch.checkpoint.sharded"
        assert got["latest_after_torn"] == 3


def test_sharded_manager_publishes_split_metrics(ckpt):
    """The caller's stall and the background commit land in their own
    series (kind="sharded"); nothing is pending after the drain."""
    for got in ckpt:
        m = got["metrics"]
        assert m["unionml_checkpoint_save_ms"]["kind=sharded"]["count"] == 3
        assert m["unionml_checkpoint_commit_ms"]["kind=sharded"]["count"] == 3
        assert m["unionml_checkpoint_restore_ms"]["kind=sharded"]["count"] == 2
        assert m["unionml_checkpoint_pending"][""] == 0.0


def test_checkpoint_manager_publishes_metrics(tmp_path):
    """The reference's one-process case, through the port's sharded
    manager with no process group."""
    from unionml_tpu_torch.checkpoint.sharded import CheckpointManager

    reg = telemetry.MetricsRegistry()
    state = {"w": torch.arange(8, dtype=torch.float32)}
    with CheckpointManager(tmp_path, registry=reg) as manager:
        manager.save(1, state)
        manager.wait()
        restored = manager.restore(state)
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(8))
    snap = reg.snapshot()
    assert snap["unionml_checkpoint_save_ms"]["kind=sharded"]["count"] == 1
    assert snap["unionml_checkpoint_save_bytes_total"]["kind=sharded"] == 32.0
    assert snap["unionml_checkpoint_restore_ms"]["kind=sharded"]["count"] == 1
    assert snap["unionml_checkpoint_restore_bytes_total"]["kind=sharded"] == 32.0


def _mlp_problem():
    from unionml_tpu.models.mlp import Mlp, MlpConfig

    cfg = MlpConfig(num_classes=4, hidden_dims=(32,), dtype="float32")
    params = jax.jit(Mlp(cfg).init)(jax.random.PRNGKey(4), np.zeros((1, 8), np.float32))["params"]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(128,)).astype(np.int32)
    return (dict(num_classes=4, hidden_dims=(32,), dtype="float32"),
            jax.tree_util.tree_map(np.asarray, params), x, y)


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap_grads"])
def test_elastic_async_preemption_resume_bit_identical(ranks, tmp_path, overlap):
    """run_elastic_trainer(sharding=data 2 x fsdp 2) on the sharded
    manager: a run preempted after step 5 (between checkpoints) and
    relaunched ends at the uninterrupted run's params bit for bit, each
    state leaf at its placement; with overlap_grads and accumulation
    too."""
    cfg, params, x, y = _mlp_problem()
    kw = dict(overlap_grads=overlap, accumulate_steps=2 if overlap else 1)
    full = ranks.run("elastic_resume", str(tmp_path / "full"), cfg, params, x, y, **kw)
    resumed = ranks.run("elastic_resume", str(tmp_path / "killed"), cfg, params, x, y,
                        kill_after=3 if overlap else 5, **kw)
    for a, b in zip(full, resumed):
        assert b["killed"] and a["step"] == b["step"] == (8 if overlap else 16)
        assert all(np.array_equal(p, q) for p, q in zip(tree_leaves(a["params"]),
                                                        tree_leaves(b["params"])))
        assert a["placement"] == "(Replicate(), Shard(dim=1))"
        assert a["dirs"] == b["dirs"]


# --------------------------------------------------------------------- #
# the skew monitor's input
# --------------------------------------------------------------------- #


def test_allgather_step_times(ranks):
    """Every rank's step time, index-aligned with the rank; None in one
    process."""
    from unionml_tpu_torch.goodput import allgather_step_times

    assert allgather_step_times(0.5) is None
    # rank r sent 0.25 * (r + 1): every rank sees the same rank-aligned list
    assert ranks.run("skew_sample", 0.25) == [[0.25, 0.5, 0.75, 1.0]] * 4


def test_trainer_publishes_step_skew(ranks):
    """run_step_trainer(goodput=, skew_every=2) under sharding gathers the
    ranks' step times and publishes the skew gauges per process."""
    cfg, params, x, y = _mlp_problem()
    for got in ranks.run("trainer_run", cfg, params, x, y, sharding={"data": 2, "fsdp": 2},
                         num_epochs=1, goodput=True, skew_every=2):
        hosts = got["skew"]["unionml_train_host_step_ms"]
        assert sorted(hosts) == [f"process={r}" for r in range(4)]
        assert got["skew"]["unionml_train_step_skew_ms"][""] >= 0.0
