"""Parity of the port's differentiable flash attention with the JAX
package's (the lse forward and the FlashAttention-2 backward).

Inputs are made with numpy from a seed and fed to both packages. The JAX
Pallas kernels run in interpret mode on the CPU with small tiles, so they
walk several query and key tiles (ragged tails included); the port's op
takes its plain PyTorch versions for CPU tensors. The cases mirror the JAX
package's own flash tests (``tests/unit/test_ops.py``): causal and not,
GQA 4/2, ragged S = 72, cross-length 8/40 and 16/32. The CUDA kernels are
held against the plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu.ops import flash_attention as jfa

from unionml_tpu_torch.ops import flash_attention as tfa

# fp32 on both sides: the same function in another summation order
FWD_TOL = dict(rtol=0, atol=2e-5)
GRAD_TOL = dict(rtol=0, atol=3e-4)   # the JAX package's own gradient tolerance
# bf16 with the same rounding points (one JAX tile, so its running maximum
# is the row maximum): at most one bf16 ulp (2**-8 relative) on an element,
# from fp32 sums taken in another order landing on either side of a
# rounding boundary
BF16_TOL = dict(rtol=2**-7, atol=2**-10)

# (batch, q_len, kv_len, heads, kv_heads, head_dim, causal, JAX tile)
CASES = [
    pytest.param(2, 128, 128, 4, 4, 32, False, 32, id="full-s128"),
    pytest.param(2, 128, 128, 4, 4, 32, True, 32, id="causal-s128"),
    pytest.param(2, 72, 72, 4, 2, 32, True, 32, id="causal-gqa-ragged72"),
    pytest.param(2, 64, 64, 4, 4, 16, True, 32, id="causal-d16"),
    pytest.param(2, 8, 40, 4, 4, 16, True, 16, id="causal-cross-8-40"),
    pytest.param(1, 16, 32, 4, 2, 8, False, 16, id="full-gqa-cross-16-32"),
    pytest.param(2, 72, 72, 4, 2, 32, False, 32, id="full-gqa-ragged72"),
]


def _inputs(b, sq, skv, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, g


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_side(q, k, v, g, *, causal, tile, dtype):
    """The JAX op's output, lse residual [B, H, Sq] and (dq, dk, dv) for
    the cotangent ``g``."""
    jq, jk, jv, jg = (jnp.asarray(x).astype(dtype) for x in (q, k, v, g))

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, block_q=tile, block_kv=tile)

    out, vjp = jax.vjp(f, jq, jk, jv)
    scale = q.shape[-1] ** -0.5
    _, (*_, lse) = jfa._flash_fwd_res(jq, jk, jv, causal, scale, tile, tile)
    b, sq, h, _ = q.shape
    return _f32(out), _f32(lse).reshape(b, h, sq), [_f32(x) for x in vjp(jg)]


def _torch_side(q, k, v, g, *, causal, dtype):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(g).to(dtype))
    _, lse = tfa.flash_fwd_plain(tq.detach(), tk.detach(), tv.detach(), causal=causal,
                                 scale=q.shape[-1] ** -0.5)
    grads = [t.grad.float().numpy() for t in (tq, tk, tv)]
    return out.detach().float().numpy(), lse.numpy(), grads


@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,tile", CASES)
def test_flash_forward_lse_and_grads_match_jax(b, sq, skv, h, kvh, d, causal, tile):
    """fp32: the output at the forward tolerance, the lse against the JAX
    forward's residual, and dq/dk/dv (dk/dv summed over each GQA group) at
    the JAX tests' gradient tolerance."""
    q, k, v, g = _inputs(b, sq, skv, h, kvh, d)
    j_out, j_lse, j_grads = _jax_side(q, k, v, g, causal=causal, tile=tile, dtype=jnp.float32)
    t_out, t_lse, t_grads = _torch_side(q, k, v, g, causal=causal, dtype=torch.float32)
    np.testing.assert_allclose(t_out, j_out, **FWD_TOL)
    np.testing.assert_allclose(t_lse, j_lse, **FWD_TOL)
    for name, got, want in zip("qkv", t_grads, j_grads):
        np.testing.assert_allclose(got, want, err_msg=f"d{name}", **GRAD_TOL)


def test_flash_bf16_rounding_points_match_jax():
    """bf16 inputs, causal, ragged S = 72 at head_dim 64, one JAX tile:
    the plain versions round p (before p @ v and p^T @ dO) and ds (before
    ds @ k and ds^T @ q) where the Pallas kernels do, so the two agree to
    a bf16 ulp (a rounding point left out would miss by far more)."""
    q, k, v, g = _inputs(2, 72, 72, 4, 4, 64, seed=3)
    j_out, j_lse, j_grads = _jax_side(q, k, v, g, causal=True, tile=128, dtype=jnp.bfloat16)
    t_out, t_lse, t_grads = _torch_side(q, k, v, g, causal=True, dtype=torch.bfloat16)
    np.testing.assert_allclose(t_out, j_out, **BF16_TOL)
    np.testing.assert_allclose(t_lse, j_lse, rtol=1e-6, atol=1e-5)   # fp32 statistics
    for name, got, want in zip("qkv", t_grads, j_grads):
        np.testing.assert_allclose(got, want, err_msg=f"d{name}", **BF16_TOL)


@pytest.mark.parametrize("b,s,h,kvh,d", [
    pytest.param(2, 72, 12, 4, 64, id="gqa-12-4"),
    pytest.param(2, 72, 6, 2, 64, id="gqa-6-2"),
    pytest.param(1, 128, 8, 1, 64, id="gqa-8-1"),
])
def test_flash_bf16_gqa_grads_match_jax(b, s, h, kvh, d):
    """bf16 GQA inputs, causal, one JAX tile: each q head's dk / dv rounds
    to bf16 where the Pallas kernel writes it, before the group is summed
    (in fp32, rounded once, as the reference's sum outside the kernel).
    Summing the group in fp32 and rounding once instead misses by several
    ulps on about 1% of the elements. dk / dv are held at two bf16 ulps:
    one from each head's rounding landing on either side of a boundary,
    one from the rounded sum."""
    q, k, v, g = _inputs(b, s, s, h, kvh, d, seed=3)
    j_out, _, j_grads = _jax_side(q, k, v, g, causal=True, tile=128, dtype=jnp.bfloat16)
    t_out, _, t_grads = _torch_side(q, k, v, g, causal=True, dtype=torch.bfloat16)
    np.testing.assert_allclose(t_out, j_out, **BF16_TOL)
    np.testing.assert_allclose(t_grads[0], j_grads[0], err_msg="dq", **BF16_TOL)
    for name, got, want in zip("kv", t_grads[1:], j_grads[1:]):
        np.testing.assert_allclose(got, want, err_msg=f"d{name}", rtol=2**-6, atol=2**-9)


def test_flash_lse_of_rows_that_see_nothing_is_zero():
    """Causal with q_len > kv_len: the first rows see no key; their output
    is zero and their lse 0 (so the backward's exp(s - lse) stays 0), as in
    the reference, and their gradients are zero."""
    q, k, v, g = _inputs(1, 12, 8, 2, 1, 16, seed=4)
    t_out, t_lse, (dq, _, _) = _torch_side(q, k, v, g, causal=True, dtype=torch.float32)
    assert np.all(t_out[:, :4] == 0) and np.all(t_lse[:, :, :4] == 0) and np.all(dq[:, :4] == 0)
    j_out, j_lse, j_grads = _jax_side(q, k, v, g, causal=True, tile=8, dtype=jnp.float32)
    np.testing.assert_allclose(t_out, j_out, **FWD_TOL)
    np.testing.assert_allclose(t_lse, j_lse, **FWD_TOL)
    np.testing.assert_allclose(dq, j_grads[0], **GRAD_TOL)


def test_flash_without_grad_is_the_forward():
    """Without autograd the op returns the forward's output; with it the
    same values through the autograd function."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 40, 40, 4, 2, 16, seed=5))
    with torch.no_grad():
        plain = tfa.flash_attention(q, k, v, causal=True)
    out, _ = tfa.flash_fwd_plain(q, k, v, causal=True, scale=0.25)
    assert torch.equal(plain, out)
    graded = tfa.flash_attention(q.requires_grad_(), k, v, causal=True)
    assert graded.grad_fn is not None and torch.equal(graded.detach(), out)


def test_flash_refusals():
    """The kernel wrappers take CUDA tensors only (a CPU tensor never
    reaches a kernel), and the op refuses a head count that is not a
    multiple of the kv heads."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 16, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_cuda(q, k, v, causal=True, scale=0.25)
    lse = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_cuda(q, k, v, q, q, lse, causal=True, scale=0.25)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention(q[:, :, :3], k, v, causal=True)


@pytest.mark.parametrize("pads", [[0, 17], [63, 100], [64, 5]])
def test_chip_smoke_padded_row_check_rejects_a_skipped_start_tile(pads):
    """chip_smoke.py's check of row 1 (the padded serving prefill) on the
    CPU: the plain padded forward passes its row check against itself,
    and the planted fault (each batch row's first visible 64-key tile, the
    one that holds its pad count, skipped for queries that see past it)
    fails it; queries inside the padding stay zero in both."""
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    q, k, v, _ = (torch.from_numpy(x).bfloat16() for x in _inputs(2, 200, 200, 4, 2, 32))
    pad = torch.tensor(pads, dtype=torch.int32)
    want = tfa.flash_fwd_padded_plain(q, k, v, pad, causal=True, scale=32**-0.5)
    fault = chip_smoke.padded_start_tile_fault(q, k, v, pad, scale=32**-0.5)
    for row, p in enumerate(pads):
        assert not fault[row, :p].any()
        start_end = (p // chip_smoke.FLASH_TILE + 1) * chip_smoke.FLASH_TILE
        assert torch.equal(fault[row, p:start_end], want[row, p:start_end])
    checks = chip_smoke.check_rows_with_fault(
        "plain", {"out": want}, {"out": want}, {"out": fault},
        {"out": chip_smoke.FLASH_ROW_LIMIT}, "start tile skipped")
    assert checks["out"]["max_row_rel_err"] == 0 and checks["out"]["fault_rows_over_limit"] > 0
