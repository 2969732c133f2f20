"""Parity of the PyTorch port's ops with the JAX package's.

Inputs are made with numpy from a seed and fed to both packages. The JAX
Pallas kernels run in interpret mode on the CPU (as the JAX package's own
tests run them); the port's kernel wrappers take their plain PyTorch
versions for CPU tensors. Tolerances are fp32: the two sides compute the
same function in a different summation order.

The CUDA kernels are held against their plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu.ops.flash_attention import flash_attention as jflash
from unionml_tpu.ops.fused_norm import fused_rms_norm as jrms

from unionml_tpu_torch.ops import attention as tattn
from unionml_tpu_torch.ops import flash_attention as tflash
from unionml_tpu_torch.ops import fused_norm as tnorm

# the module, not the dispatcher function unionml_tpu.ops re-exports
jattn = importlib.import_module("unionml_tpu.ops.attention")

FP32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape", [(300, 64), (3, 100, 32)])
def test_rms_norm_plain_matches_jax_kernel(shape):
    """Ragged row counts above the reference's 256-row block, fp32."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = np.asarray(jrms(jnp.asarray(x), jnp.asarray(g), 1e-5))
    got = tnorm.fused_rms_norm(_t(x), _t(g), eps=1e-5).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def _flash_inputs(b=2, s=40, h=4, kvh=2, d=16, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    return q, k, v


def test_flash_padded_plain_matches_jax_kernel():
    """GQA 4/2, a row padded past several queries (and past whole 16-kv
    blocks of the JAX kernel), causal, fp32."""
    q, k, v = _flash_inputs()
    pads = np.array([0, 23], np.int32)
    want = np.asarray(jflash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        kv_valid_start=jnp.asarray(pads), block_q=16, block_kv=16,
    ))
    got = tflash.flash_attention(
        _t(q), _t(k), _t(v), causal=True, kv_valid_start=_t(pads)
    ).numpy()
    np.testing.assert_allclose(got, want, **FP32)
    # queries inside the padding return zeros, not NaN
    assert np.all(got[1, :23] == 0.0)


def test_flash_padded_path_is_forward_only():
    """With ``kv_valid_start`` the op is forward-only, as the reference is:
    inputs that require grad give the same values as without grad, and a
    backward through the result raises ``RuntimeError``. The reference
    fails the same way under ``jax.grad`` (its padded kernel has no VJP)."""
    q, k, v = _flash_inputs()
    pads = np.array([0, 23], np.int32)
    want = tflash.flash_attention(_t(q), _t(k), _t(v), causal=True, kv_valid_start=_t(pads))
    qg, kg, vg = (_t(a).requires_grad_() for a in (q, k, v))
    got = tflash.flash_attention(qg, kg, vg, causal=True, kv_valid_start=_t(pads))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="forward-only"):
        got.sum().backward()
    with torch.no_grad():  # no graph: the direct call, as under inference_mode
        assert tflash.flash_attention(qg, kg, vg, causal=True,
                                      kv_valid_start=_t(pads)).grad_fn is None

    def ref_loss(x):
        return jflash(x, jnp.asarray(k), jnp.asarray(v), causal=True,
                      kv_valid_start=jnp.asarray(pads), block_q=16, block_kv=16).sum()

    with pytest.raises(AssertionError):
        jax.grad(ref_loss)(jnp.asarray(q))


def test_flash_plain_casts_probabilities_to_value_dtype():
    """bf16 inputs: P is rounded to bf16 before the P.V product, as the
    TPU kernel does; the result is bf16."""
    q, k, v = (_t(a).bfloat16() for a in _flash_inputs(s=24))
    pads = torch.tensor([3, 0], dtype=torch.int32)
    out = tflash.flash_fwd_padded_plain(q, k, v, pads, causal=True, scale=0.25)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_flash_without_padding_is_not_ported():
    """The differentiable path (no ``kv_valid_start``) runs, and the padded
    path with zero pads gives the same values, as the reference's kernels
    do (the full check against the JAX package is
    ``tests/test_torch_flash.py``)."""
    q, k, v = (_t(a) for a in _flash_inputs())
    out = tflash.flash_attention(q, k, v, causal=True)
    padded = tflash.flash_attention(q, k, v, causal=True,
                                    kv_valid_start=torch.zeros(2, dtype=torch.int32))
    torch.testing.assert_close(out, padded, rtol=0, atol=0)


@pytest.mark.parametrize("block_threshold", [2048, 8])
def test_cached_attention_matches_jax(block_threshold):
    """Grouped GQA over a left-padded cache with a per-row bias; the small
    threshold walks the cache in blocks with a ragged tail."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    visible = np.arange(20)[None, None, :] <= (14 + np.arange(3))[None, :, None]
    visible = visible & (np.arange(20) >= np.array([0, 5])[:, None])[:, None, :]
    bias = np.where(visible, 0.0, -1e30).astype(np.float32)[:, None]
    want = np.asarray(jattn.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias),
        block_threshold=block_threshold,
    ))
    got = tattn.cached_attention(
        _t(q), _t(k), _t(v), bias=_t(bias), block_threshold=block_threshold
    ).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def test_quantized_cache_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kq = rng.integers(-127, 128, size=(2, 12, 2, 16)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(2, 12, 2, 16)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, size=(2, 12, 2)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, size=(2, 12, 2)).astype(np.float32)
    want = np.asarray(jattn.quantized_cache_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(vs)
    ))
    got = tattn.quantized_cache_attention(_t(q), _t(kq), _t(vq), _t(ks), _t(vs)).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def test_mha_reference_matches_jax():
    q, k, v = _flash_inputs(s=12)
    want = np.asarray(jattn.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True
    ))
    got = tattn.mha_reference(_t(q), _t(k), _t(v), causal=True).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entry points take CUDA tensors only; the CPU path is the
    op's plain version, chosen by the tensor's device."""
    x = torch.ones(4, 64)
    with pytest.raises(ValueError):
        tnorm.rms_norm_cuda(x, torch.ones(64), 1e-5)
    q, k, v = (_t(a).bfloat16() for a in _flash_inputs())
    with pytest.raises(ValueError):
        tflash.flash_fwd_padded_cuda(
            q, k, v, torch.zeros(2, dtype=torch.int32), causal=True, scale=0.25
        )


def test_kernel_library_name_follows_the_source_and_its_headers(tmp_path, monkeypatch):
    """A kernel library is named by a hash of its source, every header
    under ``csrc/`` and the nvcc flags: editing a header gives every
    source a new library name, so no stale library is loaded."""
    from unionml_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = _build._target("kern")
    assert first == _build._target("kern") and first.name.startswith("kern-")
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _build._target("kern")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build._target("kern") not in (first, second)
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build._target("kern") not in (first, second)
    # the real sources: every one is named, and the header is among the inputs
    monkeypatch.undo()
    assert (_build.CSRC / "hopper.cuh").exists()
    assert all((_build.CSRC / f"{n}.cu").exists() for n in _build.SOURCES)
