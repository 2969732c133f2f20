"""The port's packed-int4 serving path against the JAX package's, on the CPU.

Trees are quantized by ``unionml_tpu``'s ``quantize_params(bits=4)`` and
carried over with ``from_jax_params``; the JAX side runs its Pallas int4
kernel in interpret mode (its CPU route), the port the kernel's plain
version. Layout functions and packed bytes must be identical; kernel-level
results are held within the stated tolerances; greedy tokens in fp32 must
be identical through ``make_generator``, ``make_lm_predictor`` and the
contiguous and paged engines, per-channel, grouped, for a mixed int4/int8
tree and for a tree packed for ``tensor=2``.
"""

import dataclasses
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu import telemetry as jtelemetry
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.models.generate import make_generator as jmake_generator
from unionml_tpu.models.generate import make_lm_predictor as jmake_lm_predictor
from unionml_tpu.models.quantization import quantize_params as jquantize_params
from unionml_tpu.ops import int4_matmul as jint4
from unionml_tpu.serving.engine import DecodeEngine as JEngine

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.models import (
    LLAMA_QUANT_PATTERNS,
    Llama,
    LlamaConfig,
    from_jax_params,
    make_generator,
    make_lm_predictor,
    quantize_params,
    serving_params,
)
from unionml_tpu_torch.models.llama import assert_int4_tp_compatible
from unionml_tpu_torch.ops import int4_matmul as tint4
from unionml_tpu_torch.serving import DecodeEngine

VOCAB = 512


def _cfgs(**over):
    kw = dict(vocab_size=VOCAB, dtype="float32", quantized=True, weight_bits=4)
    kw.update(over)
    return JConfig.tiny(**kw), LlamaConfig.tiny(**kw)


def _trees(seed=0, *, group=0, tensor=1, **over):
    """A JAX fp tree quantized by the JAX package (bits=4) and the same
    tree carried into the port, plus both int4 configs."""
    jcfg, cfg = _cfgs(int4_group=group, int4_tp=tensor, **over)
    jfp = dataclasses.replace(jcfg, quantized=False, weight_bits=8, int4_group=0, int4_tp=1)
    jp = JLlama(jfp).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        q4 = jquantize_params(jp, LLAMA_QUANT_PATTERNS, bits=4, group_size=group, tensor=tensor)
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, q4), cfg, device="cpu")
    return jcfg, cfg, jp, q4, port


def _jax_tokens(jcfg, q4, toks, n_new, max_len):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gen = jmake_generator(JLlama(jcfg), max_new_tokens=n_new, max_len=max_len)
        return np.asarray(gen(q4, jnp.asarray(toks, jnp.int32)))


def _port_tokens(cfg, port, toks, n_new, max_len):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return make_generator(Llama(cfg), max_new_tokens=n_new, max_len=max_len)(port, toks).numpy()


def test_tile_selection_matches_jax():
    cases = [(14336, 4096, 1, 0), (4096, 14336, 1, 0), (128256, 4096, 1, 0), (128, 64, 1, 0),
             (97, 64, 1, 0), (4096, 4096, 1, 128), (4096, 4096, 1, 64), (1024, 4096, 4, 0),
             (1024, 4096, 8, 0), (14336, 4096, 8, 0), (96, 64, 2, 0), (14336, 4096, 1, 128)]
    for n, k, shards, group in cases:
        assert tint4._grid_for(n, k, shards, group) == jint4._grid_for(n, k, shards, group)
        assert tint4.tile_for(n, k, shards) == jint4.tile_for(n, k, shards)
    assert tint4._grid_for(14336, 4096) == (512, 4096)
    assert tint4._grid_for(4096, 14336) == (512, 3584)
    assert tint4.tile_for(128256, 4096) == 256
    for k, t, g in ((14336, 512, 0), (14336, 256, 0), (14336, 512, 128), (64, 384, 0)):
        assert tint4._k_block_for(k, t, g) == jint4._k_block_for(k, t, g)


@pytest.mark.parametrize("n,tile", [(512, 512), (1024, 512), (128, 128), (384, 384)])
def test_pack_unpack_match_jax(n, tile):
    nib = np.random.default_rng(0).integers(-8, 8, size=(32, n)).astype(np.int8)
    packed = tint4.pack_int4(torch.from_numpy(nib), tile)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jint4.pack_int4(jnp.asarray(nib), tile)))
    np.testing.assert_array_equal(tint4.unpack_int4(packed, tile).numpy(), nib)


@pytest.mark.parametrize("group", [0, 16, 128])
def test_quantize_kernel_matches_jax(group):
    w = np.random.default_rng(1).normal(size=(256, 512)).astype(np.float32)
    w[7] *= 50.0
    jp, js = jint4.quantize_kernel_int4(jnp.asarray(w), 256, group_size=group)
    tp, ts = tint4.quantize_kernel_int4(torch.from_numpy(w), 256, group_size=group)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("rows", [1, 8, 40, tint4.MAX_PALLAS_ROWS + 1])
@pytest.mark.parametrize("group,k", [(0, 64), (0, 256), (16, 64), (128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_matches_jax(rows, group, k, dtype):
    """The JAX op (its Pallas kernel in interpret mode at decode rows, the
    XLA fallback above) against the port's op (the plain kernel version,
    the fallback): fp32 outputs within fp32 summation-order tolerance,
    bf16 outputs within one bf16 ulp."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(k, 512)).astype(np.float32)
    x = rng.normal(size=(rows, k)).astype(np.float32)
    jp, js = jint4.quantize_kernel_int4(jnp.asarray(w), 512, group_size=group)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(jint4.int4_matmul(
            jnp.asarray(x), jp, js, tile_n=512, dtype=jnp.dtype(dtype), group_size=group
        )).astype(np.float32)
        got = tint4.int4_matmul(
            torch.from_numpy(x), torch.from_numpy(np.asarray(jp)), torch.from_numpy(np.asarray(js)),
            tile_n=512, dtype=getattr(torch, dtype), group_size=group,
        ).float().numpy()
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(got, want, **tol)
    if dtype == "bfloat16":
        return
    # and against the dequantized reference (4-bit math)
    wdq = tint4.unpack_int4(torch.from_numpy(np.asarray(jp)), 512).float().numpy()
    wdq = wdq * (np.repeat(np.asarray(js), group, axis=0) if group else np.asarray(js))
    np.testing.assert_allclose(got, x @ wdq, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("k,n,splits", [
    (4096, 1024, 8), (4096, 4096, 8), (4096, 14336, 2), (14336, 4096, 8),
    (4096, 128256, 1), (256, 1024, 2), (96, 200, 1), (1000, 512, 8),
])
def test_k_split_is_fixed_by_k_and_n(k, n, splits):
    """The per-channel kernel's K split: a function of (K, N) alone (so a
    row's bits never follow the row count), a power of two up to 8 that
    fills the card's 132 SMs where K allows, and slices of whole 128-row
    chunks that cover K in rank order, the tail in the last."""
    assert tint4._k_splits(k, n) == splits
    tiles = -(-n // tint4.CHANNEL_TILE)
    assert splits in (1, 2, 4, 8)
    assert tiles * splits >= 132 or splits == 8 or 2 * splits > -(-k // 128)
    assert splits == 1 or tiles * splits // 2 < 132
    slices = tint4._k_slices(k, splits)
    assert len(slices) == splits and slices[0][0] == 0 and slices[-1][1] == k
    for (a, b), (c, _) in zip(slices, slices[1:]):
        assert b == c and a < b and b % tint4.K_CHUNK == 0


def test_tma_path_follows_alignment():
    """The per-channel kernel reads by TMA only 16-byte aligned bases and
    row strides; everything else takes its simple path."""
    packed = torch.zeros(256, 512, dtype=torch.int8)
    x = torch.zeros(8, 256, dtype=torch.bfloat16)
    assert tint4._tma_path(x, packed)
    assert not tint4._tma_path(x, torch.zeros(256, 100, dtype=torch.int8))
    assert not tint4._tma_path(torch.zeros(8, 98, dtype=torch.bfloat16),
                               torch.zeros(98, 512, dtype=torch.int8))
    assert tint4._tma_path(torch.zeros(8, 100), torch.zeros(100, 512, dtype=torch.int8))
    assert not tint4._tma_path(torch.zeros(8 * 256 + 1, dtype=torch.bfloat16)[1:].view(8, 256),
                               packed)
    assert not tint4._tma_path(x, torch.zeros(256 * 512 + 1, dtype=torch.int8)[1:].view(256, 512))


def test_chip_smoke_int4_bit_check_rejects_planted_faults_on_cpu():
    """chip_smoke's per-channel bit check on the CPU (the plain version
    against itself, then the two planted K-split faults), at 8 slices."""
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(repo))
    k, n, tile = 2048, 512, 512
    assert tint4._k_splits(k, n) == 8
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(40, k)).astype(np.float32)).bfloat16()
    packed = torch.from_numpy(rng.integers(-128, 128, size=(k, n // 2)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(0.5, 1.0, size=n).astype(np.float32)) / k ** 0.5
    want = tint4.int4_matmul_plain(x, packed, scale, tile_n=tile, dtype=torch.bfloat16)
    assert chip_smoke.rounding_mismatch(want, want) == 0.0
    faults = chip_smoke.int4_slice_faults(x, packed, scale, tile)
    assert set(faults) == {"last_slice_dropped", "bf16_reverse_rank_sum"}
    for bad in faults.values():
        assert chip_smoke.rounding_mismatch(bad, want) > chip_smoke.INT4_MISMATCH_MAX


@pytest.mark.parametrize("k,n,group,splits", [
    (4096, 14336, 128, 2), (14336, 4096, 128, 8), (4096, 4096, 128, 8), (4096, 1024, 128, 8),
    (2048, 512, 128, 8), (256, 1536, 256, 1), (1024, 512, 256, 4),
])
def test_grouped_k_split_cuts_whole_groups(k, n, group, splits):
    """The grouped kernel's K split: the per-channel rule over whole scale
    groups (a 128-row group is one chunk, so the engines' g=128 shapes
    split as the per-channel form does), every slice a run of whole
    groups in rank order."""
    assert tint4._k_splits(k, n, group) == splits
    if group == tint4.K_CHUNK:
        assert splits == tint4._k_splits(k, n)
    slices = tint4._k_slices(k, splits, group)
    assert len(slices) == splits and slices[0][0] == 0 and slices[-1][1] == k
    for a, b in slices:
        assert a < b and a % group == 0 and b % group == 0


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


def test_chip_smoke_int4_grouped_bit_check_rejects_planted_faults_on_cpu():
    """chip_smoke's grouped (g=128) bit check on the CPU, at 8 K-slices of
    two groups: the plain version passes against itself, and each of the
    three planted faults (the last group dropped, each slice's scale rows
    one group off, the slices rounded to bf16 and summed in reverse rank
    order) fails it; whether the elementwise tolerance alone would pass
    each is recorded."""
    chip_smoke = _chip_smoke()
    k, n, tile, group = 2048, 512, 512, 128
    assert tint4._k_splits(k, n, group) == 8
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(16, k)).astype(np.float32)).bfloat16()
    packed = torch.from_numpy(rng.integers(-128, 128, size=(k, n // 2)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(0.5, 1.0, size=(k // group, n)).astype(np.float32))
    scale = scale / k ** 0.5
    want = tint4.int4_matmul_plain(x, packed, scale, tile_n=tile, dtype=torch.bfloat16,
                                   group_size=group)
    checks = {}
    chip_smoke.int4_bit_check("plain", want, want, checks)
    assert checks["mismatch"] == 0.0
    faults = chip_smoke.int4_group_faults(x, packed, scale, tile, group)
    assert set(faults) == {"last_group_dropped", "scale_row_off_by_one", "bf16_reverse_rank_sum"}
    for bad in faults.values():
        assert chip_smoke.rounding_mismatch(bad, want) > chip_smoke.INT4_MISMATCH_MAX
    chip_smoke.int4_fault_checks("plain", faults, want, checks)
    assert all(isinstance(checks[f"fault_{f}_passes_int4_tol"], bool) for f in faults)
    assert not checks["fault_last_group_dropped_passes_int4_tol"]
    # a fault that passes the bit check fails the run
    with pytest.raises(AssertionError, match="planted fault"):
        chip_smoke.int4_fault_checks("plain", {"none": want}, want, {})
    # the FMA fault passes the bit check on random inputs (here no output
    # rounds apart): only the rounding probe tells it apart
    fma = chip_smoke.int4_fma_scale(x, packed, scale, tile, group)
    assert chip_smoke.rounding_mismatch(fma, want) <= chip_smoke.INT4_MISMATCH_MAX


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,k,n,tile", [(16, 2048, 512, 512), (3, 512, 768, 256),
                                           (5, 256, 200, 200)])
def test_chip_smoke_int4_rounding_probe_on_cpu(rows, k, n, tile, dtype):
    """chip_smoke's grouped rounding probe on the CPU: the plain version
    passes against itself, and so does the plain math summed as the bf16
    kernel sums it (each K-slice's groups in order, then the slices in rank
    order), because every value but the planted rounding is exact; the
    FMA fault (the group scale applied by one FMA) fails it, in about 3/8
    of the bf16 outputs and 3/4 of the fp32 ones."""
    chip_smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(rows + k)
    x, packed, scale, want, fma = chip_smoke.int4_rounding_probe(rows, k, n, tile, 128, dtype,
                                                                 gen)
    assert chip_smoke.int4_rounding_check("plain", want, want, fma) == {
        "mismatch": 0.0, "fma_fault_mismatch": chip_smoke.rounding_mismatch(fma, want)}
    w = tint4.unpack_int4(packed, tile).float()
    slices = []
    for a, b in tint4._k_slices(k, tint4._k_splits(k, n, 128), 128):
        total = torch.zeros(rows, n)
        for g in range(a, b, 128):
            total = total + (x[:, g:g + 128].float() @ w[g:g + 128]) * scale[g // 128]
        slices.append(total)
    assert torch.equal(sum(slices[1:], slices[0]).to(dtype), want)
    share = chip_smoke.rounding_mismatch(fma, want)
    assert share > (0.2 if dtype == torch.bfloat16 else 0.5)
    with pytest.raises(AssertionError, match="rounding probe"):
        chip_smoke.int4_rounding_check("fma", fma, want, fma)


def test_routing_plain_fallback_and_warning(monkeypatch):
    """Decode rows with a conforming tile take the kernel's plain version
    on the CPU; prefill rows, 128 tiles and small groups take the
    fallback; small groups warn; the CUDA wrapper refuses CPU tensors."""
    calls = []
    real = tint4.int4_matmul_plain
    monkeypatch.setattr(tint4, "int4_matmul_plain", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(64, 512)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    p512, s512 = tint4.quantize_kernel_int4(w, 512)
    tint4.int4_matmul(x, p512, s512, tile_n=512, dtype=torch.float32)
    assert calls == [1]
    tint4.int4_matmul(torch.ones(65, 64), p512, s512, tile_n=512, dtype=torch.float32)
    p128, s128 = tint4.quantize_kernel_int4(w, 128)
    tint4.int4_matmul(x, p128, s128, tile_n=128, dtype=torch.float32)
    pg, sg = tint4.quantize_kernel_int4(w, 512, group_size=16)
    with pytest.warns(UserWarning, match="multiple of 128"):
        tint4.int4_matmul(x, pg, sg, tile_n=512, group_size=16)
    assert calls == [1]
    with pytest.raises(ValueError, match="CUDA"):
        tint4.int4_matmul_cuda(x, p512, s512, tile_n=512)
    with pytest.raises(ValueError, match="scale"):
        tint4.int4_matmul(x, p512, sg, tile_n=512)


@pytest.mark.parametrize("group,tensor", [(0, 1), (16, 1), (0, 2)])
def test_quantize_params_bits4_matches_jax(group, tensor):
    """The port's quantize_params(bits=4) of the same fp tree writes the
    JAX package's leaves bit for bit (structure, packing, scales)."""
    jcfg, cfg, jp, q4, _ = _trees(group=group, tensor=tensor)
    port_fp = from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp),
        dataclasses.replace(cfg, quantized=False, weight_bits=8, int4_group=0, int4_tp=1),
        device="cpu",
    )
    ported = quantize_params(port_fp, LLAMA_QUANT_PATTERNS, bits=4, group_size=group, tensor=tensor)
    flat_j = jax.tree_util.tree_flatten_with_path(q4)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(ported))
    for path, leaf in flat_j:
        node = ported
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    attn_q = ported["block_0"]["attn"]["q"]
    if tensor == 1:
        assert set(attn_q) == {"kernel_p", "scale_g" if group else "scale"}
        assert tuple(attn_q["kernel_p"].shape) == (64, 32)
    else:  # 64 channels leave no tile per device at tensor=2: int8
        assert set(attn_q) == {"kernel_q", "scale"}
    odd = {"mlp": {"down": {"kernel": torch.ones(10, 7)}}}
    assert "kernel_q" in quantize_params(odd, (r"mlp/(gate|up|down)$",), bits=4)["mlp"]["down"]


@pytest.mark.parametrize("group", [0, 64, 16])
def test_int4_llama_greedy_matches_jax(group):
    """Per-channel, grouped (the kernel route at g=64 = K; the fallback
    at g=16): logits and greedy tokens against the JAX package."""
    jcfg, cfg, _, q4, port = _trees(group=group)
    toks = np.random.default_rng(3).integers(1, VOCAB, size=(2, 9)).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(JLlama(jcfg).apply({"params": q4}, jnp.asarray(toks)))
        with torch.inference_mode():
            got = Llama(cfg)(port, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        _port_tokens(cfg, port, toks, 6, 32), _jax_tokens(jcfg, q4, toks, 6, 32)
    )


def test_untileable_layer_falls_back_to_int8_and_matches_jax():
    """A mixed int4/int8 tree (odd vocab: the LM head stays int8; a group
    that divides no K: every site int8) carries over and generates the
    JAX package's tokens."""
    for over in (dict(vocab_size=97), dict(int4_group=48)):
        group = over.pop("int4_group", 0)
        jcfg, cfg, _, q4, port = _trees(group=group, **over)
        if group:
            assert "kernel_q" in port["block_0"]["attn"]["q"]
        else:
            assert "kernel_q" in port["lm_head"] and "kernel_p" in port["block_0"]["attn"]["q"]
        toks = np.random.default_rng(4).integers(1, cfg.vocab_size, size=(1, 6)).astype(np.int32)
        np.testing.assert_array_equal(
            _port_tokens(cfg, port, toks, 5, 32), _jax_tokens(jcfg, q4, toks, 5, 32)
        )


def test_bridge_refuses_a_tree_of_another_packing():
    """A per-channel tree into a grouped config (and an int8 tree into an
    int4 config) is refused at conversion, not decoded wrong."""
    _, _, jp, q4, _ = _trees()
    _, grouped = _cfgs(int4_group=16)
    with pytest.raises(ValueError, match="scale_g"):
        from_jax_params(jax.tree_util.tree_map(np.asarray, q4), grouped, device="cpu")
    q8 = jquantize_params(jp, LLAMA_QUANT_PATTERNS, bits=8)
    with pytest.raises(ValueError, match="kernel_p"):
        from_jax_params(jax.tree_util.tree_map(np.asarray, q8), _cfgs()[1], device="cpu")


def test_tp_packed_tree_served_unsharded_matches_jax():
    """A tree packed for tensor=2 (int4_tp=2) passes the TP guard and
    serves on one device with the JAX package's tokens."""
    over = dict(hidden_dim=128, num_heads=4, num_kv_heads=2, mlp_dim=256)
    jcfg, cfg, _, q4, port = _trees(tensor=2, **over)
    assert_int4_tp_compatible(cfg, 2)
    toks = np.random.default_rng(6).integers(1, VOCAB, size=(2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        _port_tokens(cfg, port, toks, 5, 32), _jax_tokens(jcfg, q4, toks, 5, 32)
    )
    cfg8b = LlamaConfig(quantized=True, weight_bits=4)
    assert_int4_tp_compatible(cfg8b, 2)
    with pytest.raises(ValueError, match="packing tile"):
        assert_int4_tp_compatible(cfg8b, 4)
    for tp in (2, 4, 8):
        assert_int4_tp_compatible(dataclasses.replace(cfg8b, int4_tp=8), tp)
    assert_int4_tp_compatible(LlamaConfig(quantized=True), 8)


def test_grouped_scales_improve_outlier_quality():
    """One outlier K-row poisons a per-channel column; groups contain it."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(128, 512)).astype(np.float32) * 0.02
    w[7] *= 100.0
    pc_p, pc_s = tint4.quantize_kernel_int4(torch.from_numpy(w), 512)
    g_p, g_s = tint4.quantize_kernel_int4(torch.from_numpy(w), 512, group_size=16)
    dq_pc = tint4.unpack_int4(pc_p, 512).float().numpy() * pc_s.numpy()
    dq_g = tint4.unpack_int4(g_p, 512).float().numpy() * np.repeat(g_s.numpy(), 16, axis=0)
    mask = np.ones(128, bool)
    mask[7] = False
    err_pc = np.abs(dq_pc[mask] - w[mask]).mean()
    err_g = np.abs(dq_g[mask] - w[mask]).mean()
    assert err_g < err_pc / 4, (err_pc, err_g)


def test_serving_params_keeps_int4_scales():
    tree = {
        "gate": {"kernel_p": torch.zeros(16, 16, dtype=torch.int8), "scale_g": torch.ones(2, 32)},
        "o": {"kernel_p": torch.zeros(16, 16, dtype=torch.int8), "scale": torch.ones(32)},
        "norm": {"scale": torch.ones(8)},
    }
    out = serving_params(tree)
    assert out["gate"]["scale_g"].dtype == torch.float32
    assert out["o"]["scale"].dtype == torch.float32
    assert out["norm"]["scale"].dtype == torch.bfloat16
    assert out["gate"]["kernel_p"].dtype == torch.int8


@pytest.mark.parametrize("kv_quant", [False, True])
def test_predictor_and_engines_match_jax(kv_quant):
    """make_lm_predictor and the contiguous and paged engines (chunked
    admission included) over a grouped int4 tree give the JAX package's
    tokens, with and without the int8 KV cache."""
    jcfg, cfg, _, q4, port = _trees(seed=2, group=64, kv_quant=kv_quant)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, VOCAB, size=n).tolist() for n in (5, 17, 40)]
    kw = dict(max_new_tokens=5, bucket_lens=(8, 16, 64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want_pred = [list(map(int, r)) for r in jmake_lm_predictor(JLlama(jcfg), **kw)(q4, prompts)]
        assert make_lm_predictor(Llama(cfg), **kw)(port, prompts) == want_pred
        ekw = dict(slots=2, max_new_tokens=6, prompt_buckets=(16, 48), prefill_chunk=16,
                   chunk_steps=3)
        jengine = JEngine(JLlama(jcfg), registry=jtelemetry.MetricsRegistry(), **ekw)
        try:
            want = jengine.generate(q4, prompts)
        finally:
            jengine.close()
        for paged in (False, True):
            engine = DecodeEngine(Llama(cfg), device="cpu", paged=paged,
                                  registry=telemetry.MetricsRegistry(), **ekw)
            try:
                assert engine.generate(port, prompts) == want
            finally:
                engine.close()


def test_chip_smoke_int4_phases_rehearsal_on_cpu():
    """chip_smoke.py's int4 paged-engine, speculative and fp32 phases at a
    tiny config on the CPU (the kernels' plain versions)."""
    import sys
    from pathlib import Path

    from unionml_tpu_torch import ModelArtifact
    from unionml_tpu_torch.templates.llm_serving.app import build_model

    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(repo))
    base = LlamaConfig.tiny(vocab_size=97)
    cfg4 = chip_smoke.serving_config(dataclasses.replace(base, weight_bits=4, int4_group=32))
    params = chip_smoke.random_quantized_params(cfg4, 0, "cpu")
    assert "scale_g" in params["block_0"]["mlp"]["down"] and "kernel_q" in params["lm_head"]
    model = build_model(cfg4, name="rehearsal_int4", max_new_tokens=4, bucket_lens=(8, 16, 32))
    model.artifact = ModelArtifact(params)
    out = chip_smoke.engine_phase(
        cfg4, 4, device="cpu", model=model, params=params, slots=4, buckets=(8, 16, 32),
        chunk_steps=2, waves=2, lengths=(3, 7, 20, 30, 5, 12),
    )
    assert out["requests"] == 7 and out["int4_expected_launches"] > 0
    target = chip_smoke.serving_config(dataclasses.replace(base, weight_bits=4))
    draft = chip_smoke.serving_config(dataclasses.replace(base, hidden_dim=32, num_heads=2,
                                                          num_kv_heads=1, mlp_dim=64))
    spec = chip_smoke.spec_phase(
        target, chip_smoke.random_quantized_params(target, 1, "cpu"), draft,
        chip_smoke.random_quantized_params(draft, 2, "cpu"), 6, device="cpu", slots=4, k=3,
        buckets=(8, 32), chunk_steps=2, lengths=(3, 20, 7, 12, 5), self_requests=2,
    )
    assert spec["requests"] == 6 and spec["self_acceptance_rate"] >= 0.99
    assert chip_smoke.fp32_parity_phase(
        dataclasses.replace(base, weight_bits=4, int4_group=32), 4, device="cpu", layers=2,
        buckets=(8, 32), lengths=(3, 20, 9),
    )["match"] == "3/3"
    res = chip_smoke.spec_fp32_parity_phase(
        dataclasses.replace(base, weight_bits=4), dataclasses.replace(draft, num_layers=1), 4,
        device="cpu", layers=2, buckets=(8, 32), lengths=(3, 20, 9),
    )
    assert res["draft"]["match"] == res["self"]["match"] == "3/3"
