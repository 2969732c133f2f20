"""The port's ViT path against the JAX package on the CPU.

Kernel rows 3-5 (fused LayerNorm / add-LayerNorm forward and their shared
backward) and 12-13 (fused short-sequence attention forward and
backward): the port's ops, which take their plain versions for CPU
tensors, against the JAX ops, whose Pallas kernels run in interpret mode
here, on the same numpy inputs; then ViT-tiny logits for every
``attn_impl`` x ``norm_impl`` with the JAX weights carried over by the
bridge. The kernels themselves run on the card in
``tests/test_torch_cuda.py``.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu.models import ViT as JViT
from unionml_tpu.models import ViTConfig as JViTConfig
from unionml_tpu.ops.fused_attention import fused_attention as jfused_attention
from unionml_tpu.ops.fused_norm import fused_add_layer_norm as jadd_ln
from unionml_tpu.ops.fused_norm import fused_layer_norm as jln

from unionml_tpu_torch.models import ViT, ViTConfig, vit_from_jax_params
from unionml_tpu_torch.ops import fused_attention as tfa
from unionml_tpu_torch.ops import fused_norm as tnorm

# fp32 through the same arithmetic in another summation order
FP32 = dict(rtol=1e-5, atol=1e-5)
# bf16: the same rounding points; a sum-order difference can move a value
# across a rounding boundary, one or two bf16 ulps (2**-7 relative)
BF16 = dict(rtol=2**-6, atol=2**-6)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32, grad=True):
    t = torch.tensor(np.asarray(a, np.float32)).to(dtype)
    return t.requires_grad_(grad)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


# --------------------------------------------------------------------- #
# rows 12-13: fused attention
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2)])
def test_fused_attention_matches_jax(causal, heads, kv_heads):
    """Output and dq/dk/dv (GQA: group-summed by the repeat's backward)
    at a ragged length, fp32."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 17, heads, 16))
    k = rng.normal(size=(2, 17, kv_heads, 16))
    v = rng.normal(size=(2, 17, kv_heads, 16))
    g = rng.normal(size=(2, 17, heads, 16))
    out, vjp = jax.vjp(lambda q, k, v: jfused_attention(q, k, v, causal=causal),
                       _j(q), _j(k), _j(v))
    jgrads = vjp(_j(g))
    tq, tk, tv = _t(q), _t(k), _t(v)
    tout = tfa.fused_attention(tq, tk, tv, causal=causal)
    tout.backward(torch.tensor(g, dtype=torch.float32))
    np.testing.assert_allclose(tout.detach().numpy(), _np(out), **FP32)
    for got, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), _np(want), **FP32)


def test_fused_attention_matches_jax_bf16():
    """bf16 inputs: e, do / z and ds round to bf16 where the TPU kernel
    rounds them, so values and gradients agree within bf16 ulps."""
    rng = np.random.default_rng(1)
    q, k, v, g = (rng.normal(size=(2, 24, 2, 32)) for _ in range(4))
    out, vjp = jax.vjp(lambda q, k, v: jfused_attention(q, k, v, causal=True),
                       _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16))
    jgrads = vjp(_j(g, jnp.bfloat16))
    tq, tk, tv = (_t(a, torch.bfloat16).detach().requires_grad_() for a in (q, k, v))
    tout = tfa.fused_attention(tq, tk, tv, causal=True)
    assert tout.dtype == torch.bfloat16
    tout.backward(torch.tensor(g, dtype=torch.float32).bfloat16())
    np.testing.assert_allclose(tout.float().detach().numpy(), _np(out), **BF16)
    for got, want in zip((tq, tk, tv), jgrads):
        scale = np.abs(_np(want)).max()
        np.testing.assert_allclose(got.grad.float().numpy() / scale, _np(want) / scale,
                                   rtol=0, atol=2**-6)


def test_fused_attention_refusals():
    with pytest.raises(ValueError, match="short sequences"):
        tfa.fused_attention(*(torch.zeros(1, 1025, 1, 8) for _ in range(3)))
    with pytest.raises(ValueError, match="q_len == kv_len"):
        tfa.fused_attention(torch.zeros(1, 8, 1, 8), torch.zeros(1, 9, 1, 8),
                            torch.zeros(1, 9, 1, 8))


def test_fused_attention_plain_backward_is_the_kernels_arithmetic():
    """The plain backward equals autograd through the plain forward's
    math in fp32 (the rounding points are no-ops there)."""
    rng = np.random.default_rng(2)
    q, k, v, g = (torch.tensor(rng.normal(size=(1, 9, 2, 8)), dtype=torch.float32)
                  for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = tfa.fused_attention_fwd_plain(q, k, v, causal=True)
    o.backward(g)
    dq, dk, dv = tfa.fused_attention_bwd_plain(q.detach(), k.detach(), v.detach(), g,
                                               o.detach(), causal=True)
    for got, t in zip((dq, dk, dv), (q, k, v)):
        torch.testing.assert_close(got, t.grad, **FP32)


@pytest.mark.parametrize("s,causal", [(197, False), (130, True), (65, False)])
def test_chip_smoke_row_check_rejects_a_skipped_chunk(s, causal):
    """chip_smoke.py's check of rows 12-13 on the CPU: the plain versions
    pass against themselves, and the planted fault (each query's last
    visible 64-key chunk skipped) fails it in out, dq, dk and dv, in a
    share of rows that the check reports."""
    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, s, 2, 64)).astype(np.float32)).bfloat16()
                   for _ in range(4))
    q = q * float(torch.tensor(64 ** -0.5 * tfa.LOG2E, dtype=torch.bfloat16))
    o = tfa.fused_attention_fwd_plain(q, k, v, causal=causal)
    want = dict(zip(("out", "dq", "dk", "dv"),
                    (o, *tfa.fused_attention_bwd_plain(q, k, v, do, o, causal=causal))))
    fault = dict(zip(want, chip_smoke.skipped_chunk_fault(q, k, v, do, o, causal=causal)))
    checks = chip_smoke.check_fused_rows("plain", want, want, fault)
    assert set(checks) == {"out", "dq", "dk", "dv"}
    for name, chk in checks.items():
        assert chk["max_row_rel_err"] == 0 and chk["fault_rows_over_limit"] > 0
        assert chk["limit"] == chip_smoke.FUSED_ROW_LIMIT[name]
        with pytest.raises(AssertionError, match="disagrees"):
            chip_smoke.check_rows(name, fault[name], want[name], chk["limit"])
    # the check passes a fault only by failing: want against itself as the fault
    with pytest.raises(AssertionError, match="planted fault"):
        chip_smoke.check_fused_rows("plain", want, want, want)


# --------------------------------------------------------------------- #
# rows 3-5: fused LayerNorm / add-LayerNorm and the backward
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(4, 17, 64), (300, 128)])
@pytest.mark.parametrize("rms", [False, True])
def test_layer_norm_matches_jax(shape, rms):
    """Values and x / gamma / beta gradients, row counts that are not a
    multiple of the TPU kernel's 256-row block, LayerNorm and RMS modes."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape)
    gamma = rng.normal(size=shape[-1]) + 1.0
    beta = None if rms else rng.normal(size=shape[-1])
    dy = rng.normal(size=shape)
    args = (_j(x), _j(gamma)) + (() if rms else (_j(beta),))
    y, vjp = jax.vjp(lambda x, g, *b: jln(x, g, b[0] if b else None, 1e-6, rms), *args)
    jgrads = vjp(_j(dy))
    targs = [_t(x), _t(gamma)] + ([] if rms else [_t(beta)])
    ty = tnorm.fused_layer_norm(targs[0], targs[1], None if rms else targs[2], 1e-6, rms)
    ty.backward(torch.tensor(dy, dtype=torch.float32))
    np.testing.assert_allclose(ty.detach().numpy(), _np(y), **FP32)
    for got, want in zip(targs, jgrads):
        np.testing.assert_allclose(got.grad.numpy(), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rms", [False, True])
def test_add_layer_norm_matches_jax(rms):
    """``(s, y)`` and the gradients of x, r, gamma, beta: ``dx + ds``
    flows to both addends."""
    rng = np.random.default_rng(1)
    x, r, ds, dy = (rng.normal(size=(3, 37, 64)) for _ in range(4))
    gamma = rng.normal(size=64) + 1.0
    beta = None if rms else rng.normal(size=64)
    args = (_j(x), _j(r), _j(gamma)) + (() if rms else (_j(beta),))
    (s, y), vjp = jax.vjp(lambda x, r, g, *b: jadd_ln(x, r, g, b[0] if b else None, 1e-6, rms),
                          *args)
    jgrads = vjp((_j(ds), _j(dy)))
    targs = [_t(x), _t(r), _t(gamma)] + ([] if rms else [_t(beta)])
    ts, ty = tnorm.fused_add_layer_norm(targs[0], targs[1], targs[2],
                                        None if rms else targs[3], 1e-6, rms)
    torch.autograd.backward((ts, ty), (torch.tensor(ds, dtype=torch.float32),
                                       torch.tensor(dy, dtype=torch.float32)))
    np.testing.assert_allclose(ts.detach().numpy(), _np(s), **FP32)
    np.testing.assert_allclose(ty.detach().numpy(), _np(y), **FP32)
    for got, want in zip(targs, jgrads):
        np.testing.assert_allclose(got.grad.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_norms_match_jax_bf16_inputs():
    """bf16 activations with fp32 statistics and fp32 gamma/beta: y, s and
    dx in bf16 within bf16 ulps, dgamma / dbeta in fp32."""
    rng = np.random.default_rng(3)
    x, r, dy = (rng.normal(size=(300, 128)) for _ in range(3))
    gamma, beta = rng.normal(size=128) + 1.0, rng.normal(size=128)
    (s, y), vjp = jax.vjp(lambda x, r, g, b: jadd_ln(x, r, g, b, 1e-6),
                          _j(x, jnp.bfloat16), _j(r, jnp.bfloat16), _j(gamma), _j(beta))
    jgrads = vjp((jnp.zeros_like(s), _j(dy, jnp.bfloat16)))
    tx, tr = (_t(a, torch.bfloat16).detach().requires_grad_() for a in (x, r))
    tg, tb = _t(gamma), _t(beta)
    ts, ty = tnorm.fused_add_layer_norm(tx, tr, tg, tb, 1e-6)
    assert ts.dtype == ty.dtype == torch.bfloat16
    ty.backward(torch.tensor(dy, dtype=torch.float32).bfloat16())
    np.testing.assert_allclose(ts.float().detach().numpy(), _np(s), rtol=0, atol=0)
    np.testing.assert_allclose(ty.float().detach().numpy(), _np(y), **BF16)
    np.testing.assert_allclose(tx.grad.float().numpy(), _np(jgrads[0]), **BF16)
    np.testing.assert_allclose(tr.grad.float().numpy(), _np(jgrads[1]), **BF16)
    for got, want in zip((tg, tb), jgrads[2:]):
        np.testing.assert_allclose(got.grad.numpy(), _np(want), rtol=1e-3, atol=1e-2)


def test_rms_norm_backward_mode():
    """``fused_rms_norm`` is differentiable through the backward's RMS
    mode (no beta partials) and matches the JAX RMS pair."""
    from unionml_tpu.ops.fused_norm import fused_rms_norm as jrms

    rng = np.random.default_rng(4)
    x, dy = rng.normal(size=(6, 9, 128)), rng.normal(size=(6, 9, 128))
    scale = rng.normal(size=128) + 1.0
    y, vjp = jax.vjp(lambda x, s: jrms(x, s, 1e-5), _j(x), _j(scale))
    jgrads = vjp(_j(dy))
    tx, ts = _t(x), _t(scale)
    ty = tnorm.fused_rms_norm(tx, ts, 1e-5)
    ty.backward(torch.tensor(dy, dtype=torch.float32))
    np.testing.assert_allclose(ty.detach().numpy(), _np(y), **FP32)
    for got, want in zip((tx, ts), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    _, _, dbeta = tnorm.norm_bwd_plain(tx.detach().reshape(-1, 128), ts.detach(),
                                       torch.ones(54, 128), 1e-5, True, False)
    assert dbeta is None


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("rows,d", [(300, 128), (64 * 197 // 16, 768)])
def test_chip_smoke_norm_bwd_check_rejects_planted_faults(rows, d, rms):
    """chip_smoke.py's check of row 5 on the CPU: the plain backward passes
    its row (dx) and column (dgamma, dbeta) check against itself, and the
    three planted faults (the mean(dyg * xhat) term dropped from one row in
    16, or from one row only; the last 16-row block's dgamma / dbeta
    partial dropped) fail it, in a share of rows or columns the check
    reports. The one-row fault passes the whole-tensor check_scaled: the
    row check is the one that sees it."""
    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    rng = np.random.default_rng(6)
    x, dy = (torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).bfloat16()
             for _ in range(2))
    g = torch.from_numpy((1 + 0.1 * rng.normal(size=d)).astype(np.float32))
    names = ("dx", "dgamma", "dbeta")
    want = dict(zip(names, tnorm.norm_bwd_plain(x, g, dy, 1e-6, rms, not rms)))
    faults = chip_smoke.norm_bwd_faults(x, g, dy, 1e-6, rms, not rms)
    assert set(faults) == {"c2_dropped", "c2_dropped_one_row", "partial_dropped"}
    checks = chip_smoke.check_norm_bwd("plain", want, want, faults)
    assert set(checks) == {"dx", "dgamma", "fault_c2_dropped", "fault_c2_dropped_one_row",
                           "fault_partial_dropped"} | (set() if rms else {"dbeta"})
    assert checks["dx"]["limit"] == chip_smoke.NORM_BWD_ROW_LIMIT
    assert checks["dgamma"]["limit"] == chip_smoke.NORM_PARAM_COL_LIMIT
    for name in names:
        if name in checks:
            assert checks[name]["max_row_rel_err"] == 0
    assert checks["fault_c2_dropped"]["rows_over_limit"]["dx"] > 0
    assert checks["fault_partial_dropped"]["rows_over_limit"]["dgamma"] > 0
    one_row = checks["fault_c2_dropped_one_row"]
    assert one_row["rows_over_limit"]["dx"] * rows == pytest.approx(1)
    assert one_row["passes_scaled_check"]
    chip_smoke.check_scaled("dx", faults["c2_dropped_one_row"]["dx"], want["dx"],
                            chip_smoke.SCALED_LIMIT["norm_dx"])
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_rows("dx", faults["c2_dropped_one_row"]["dx"], want["dx"],
                              chip_smoke.NORM_BWD_ROW_LIMIT)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_rows("dx", faults["c2_dropped"]["dx"], want["dx"],
                              chip_smoke.NORM_BWD_ROW_LIMIT)
    # the check passes a fault only by failing: the plain version as the fault
    with pytest.raises(AssertionError, match="planted fault"):
        chip_smoke.check_norm_bwd("plain", want, want, {"none": want})


# --------------------------------------------------------------------- #
# the ViT forward
# --------------------------------------------------------------------- #


def _jax_vit(cfg_kwargs, seed=0):
    jcfg = JViTConfig(**cfg_kwargs)
    module = JViT(jcfg)
    images = np.random.default_rng(seed).normal(size=(3, jcfg.image_size, jcfg.image_size, 3))
    params = module.init(jax.random.PRNGKey(seed), _j(images))["params"]
    return module, params, images.astype(np.float32)


TINY = dict(image_size=32, patch_size=8, num_classes=10, hidden_dim=64, num_layers=2,
            num_heads=4, mlp_dim=128, dtype="float32")


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
@pytest.mark.parametrize("norm_impl", ["xla", "fused"])
def test_vit_logits_match_jax(attn_impl, norm_impl):
    """ViT-tiny (2 layers, width 64, 17 tokens) in fp32: the same logits
    from the bridged weights for every attention / norm implementation."""
    cfg = dict(TINY, attn_impl=attn_impl, norm_impl=norm_impl)
    module, params, images = _jax_vit(cfg)
    want = np.asarray(module.apply({"params": params}, _j(images)))
    tparams = vit_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                  ViTConfig(**cfg), device="cpu")
    with torch.no_grad():
        got = ViT(ViTConfig(**cfg))(tparams, torch.from_numpy(images))
    assert got.shape == (3, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


def test_vit_qkv_bias_and_exact_gelu_match_jax():
    """The HF-style options: q/k/v/o biases and erf GELU."""
    cfg = dict(TINY, qkv_bias=True, gelu_exact=True)
    module, params, images = _jax_vit(cfg, seed=1)
    # flax initializes biases to zero: give them values so they count
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.1 if "bias" in jax.tree_util.keystr(p) else x, params)
    want = np.asarray(module.apply({"params": params}, _j(images)))
    tparams = vit_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                  ViTConfig(**cfg), device="cpu")
    with torch.no_grad():
        got = ViT(ViTConfig(**cfg))(tparams, torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


def test_vit_bridge_refuses_wrong_trees():
    cfg = dict(TINY)
    _, params, _ = _jax_vit(cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError, match="pos_embed"):
        vit_from_jax_params(tree, ViTConfig(**dict(cfg, image_size=40)), device="cpu")
    with pytest.raises(ValueError, match="block_2"):
        vit_from_jax_params(tree, ViTConfig(**dict(cfg, num_layers=3)), device="cpu")
    extra = dict(tree, stray={"kernel": np.zeros(3)})
    with pytest.raises(ValueError, match="unexpected leaf stray"):
        vit_from_jax_params(extra, ViTConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="missing param"):
        vit_from_jax_params(tree, ViTConfig(**dict(cfg, qkv_bias=True)), device="cpu")


def test_vit_init_params_follow_the_config():
    """The port's own init gives the reference's tree (names and shapes)."""
    cfg = dict(TINY, qkv_bias=True)
    _, params, _ = _jax_vit(cfg)
    mine = ViT(ViTConfig(**cfg)).init(torch.Generator().manual_seed(0), torch.zeros(1))
    want = {jax.tree_util.keystr(p): np.shape(x)
            for p, x in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(p): tuple(x.shape)
           for p, x in jax.tree_util.tree_leaves_with_path(mine)}
    assert got == want
    base = ViTConfig.base16()
    assert base.attn_impl == "fused" and base.num_patches == 196
    assert dataclasses.replace(base, norm_impl="fused").hidden_dim == 768


def test_auto_attention_takes_the_fused_path_up_to_its_limit():
    """``attn_impl="auto"`` runs the fused op up to MAX_FUSED_SEQ tokens;
    above it, as in the reference, the differentiable flash op (rows
    9-11), which ``attn_impl="flash"`` also names."""
    from unionml_tpu_torch.models.layers import _run_attention
    from unionml_tpu_torch.ops import flash_attention as tflash

    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=(1, 12, 2, 8)), dtype=torch.float32)
               for _ in range(3))
    torch.testing.assert_close(_run_attention(q, k, v, impl="auto", causal=False),
                               tfa.fused_attention(q, k, v), rtol=0, atol=0)
    long = torch.tensor(rng.normal(size=(1, tfa.MAX_FUSED_SEQ + 1, 1, 8)), dtype=torch.float32)
    torch.testing.assert_close(_run_attention(long, long, long, impl="auto", causal=True),
                               tflash.flash_attention(long, long, long, causal=True),
                               rtol=0, atol=0)
    torch.testing.assert_close(_run_attention(q, k, v, impl="flash", causal=False),
                               tflash.flash_attention(q, k, v), rtol=0, atol=0)
