"""The port's paged decode attention against the JAX package's.

Pools, tables and lengths are made with numpy from a seed and fed to
both packages: the port's plain version against the JAX reference
(``paged_attention_reference``, the gather path) and against the JAX
Pallas kernel in interpret mode. The tables carry trash entries past each
row's coverage, duplicate ids across rows, lengths on block edges and a
zero-length row. Tolerances: 1e-6 in fp32 (the same function, another
summation order), one bf16 ulp for bf16 pools.

``tests/test_torch_cuda.py`` holds the CUDA kernel against the plain
version on the card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from unionml_tpu.ops.paged_attention import paged_attention as jpaged
from unionml_tpu.ops.paged_attention import paged_attention_reference as jpaged_ref

from unionml_tpu_torch.ops import attention as tattn
from unionml_tpu_torch.ops import paged_attention as tpaged

import torch_threads

torch_threads.share_cores()

B, H, KVH, D, BS, W, N = 4, 4, 2, 16, 8, 4, 12
# a zero-length row, one row, a full block, one past a block edge, and
# the whole table
LENGTHS = [0, 8, 9, W * BS]
BF16_ULP = 2.0**-7  # relative spacing of bf16 near 1


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(seed=0, int8=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (N, BS, KVH, D)).astype(np.int8)
        v = rng.integers(-127, 128, (N, BS, KVH, D)).astype(np.int8)
    else:
        k = rng.standard_normal((N, BS, KVH, D)).astype(np.float32)
        v = rng.standard_normal((N, BS, KVH, D)).astype(np.float32)
    table = rng.integers(1, N, (B, W)).astype(np.int32)
    table[1, 0] = table[2, 0]          # one pool block shared by two rows
    for b, n in enumerate(LENGTHS):    # entries past coverage: trash block
        table[b, -(-n // BS):] = 0
    lengths = np.asarray(LENGTHS, np.int32)
    scales = None
    if int8:
        scales = tuple(
            (rng.random((N, BS, KVH)) * 0.02 + 1e-3).astype(np.float32) for _ in range(2)
        )
    return q, k, v, table, lengths, scales


def _port(q, k, v, table, lengths, scales, dtype=torch.float32, **kw):
    ks, vs = (None, None) if scales is None else (_t(scales[0]), _t(scales[1]))
    kv = (lambda a: _t(a).to(dtype)) if k.dtype != np.int8 else _t
    return tpaged.paged_attention(
        _t(q).to(dtype), kv(k), kv(v), _t(table), _t(lengths), k_scale=ks, v_scale=vs, **kw
    )


def _jax(fn, q, k, v, table, lengths, scales, dtype=jnp.float32, **kw):
    ks, vs = (None, None) if scales is None else (jnp.asarray(scales[0]), jnp.asarray(scales[1]))
    kv = (lambda a: jnp.asarray(a, dtype)) if k.dtype != np.int8 else jnp.asarray
    return fn(
        jnp.asarray(q, dtype), kv(k), kv(v), jnp.asarray(table), jnp.asarray(lengths),
        k_scale=ks, v_scale=vs, **kw,
    )


@pytest.mark.parametrize("int8", [False, True])
def test_plain_matches_jax_reference(int8):
    args = _inputs(seed=1, int8=int8)
    want = np.asarray(_jax(jpaged_ref, *args))
    got = _port(*args, impl="reference").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_plain_matches_jax_reference_bf16():
    """bf16 q and pools: within one bf16 ulp of the JAX reference."""
    args = _inputs(seed=2)
    want = np.asarray(_jax(jpaged_ref, *args, dtype=jnp.bfloat16).astype(jnp.float32))
    got = _port(*args, dtype=torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=BF16_ULP)


@pytest.mark.parametrize("int8", [False, True])
def test_plain_matches_jax_pallas_kernel(int8):
    """Against the TPU kernel in interpret mode, on the rows that see
    something (an empty row is zeros there and a uniform average in the
    gather path, in both packages)."""
    args = _inputs(seed=3, int8=int8)
    want = np.asarray(_jax(jpaged, *args, impl="pallas"))
    got = _port(*args).numpy()
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5, atol=1e-5)
    assert np.all(want[0] == 0.0)


@pytest.mark.parametrize("int8", [False, True])
def test_plain_bit_identical_to_contiguous(int8):
    """The plain version is the contiguous cache path on gathered rows,
    bit for bit: what makes the paged engine token-identical to the
    contiguous one."""
    q, k, v, table, lengths, scales = _inputs(seed=4, int8=int8)
    got = _port(q, k, v, table, lengths, scales)

    def contiguous(pool):
        return _t(pool)[_t(table).reshape(-1).long()].reshape((B, W * BS) + pool.shape[2:])

    visible = np.arange(W * BS)[None, None, :] <= (lengths - 1)[:, None, None]
    bias = _t(np.where(visible, 0.0, -1e30).astype(np.float32)[:, None])
    if int8:
        want = tattn.quantized_cache_attention(
            _t(q)[:, None], contiguous(k), contiguous(v), contiguous(scales[0]),
            contiguous(scales[1]), bias=bias,
        )[:, 0]
    else:
        want = tattn.cached_attention(_t(q)[:, None], contiguous(k), contiguous(v), bias=bias)[:, 0]
    assert torch.equal(got, want)


def test_zero_length_rows_are_finite():
    q, k, v, table, _, scales = _inputs(seed=5)
    out = _port(q, k, v, table, np.zeros(B, np.int32), scales)
    assert torch.isfinite(out).all()


def test_gqa_groups_share_kv_head():
    """A pool whose kv heads hold identical rows gives identical outputs
    across the full q-head width (the q-head -> kv-head mapping)."""
    rng = np.random.default_rng(6)
    q = np.tile(rng.standard_normal((B, 1, D)), (1, H, 1)).astype(np.float32)
    one = rng.standard_normal((N, BS, 1, D))
    k = np.tile(one, (1, 1, KVH, 1)).astype(np.float32)
    table = rng.integers(1, N, (B, W)).astype(np.int32)
    out = _port(q, k, k, table, np.asarray([5, 17, 30, 1], np.int32), None)
    assert float((out - out[:, :1]).abs().max()) < 1e-5


def test_shape_validation():
    q, k, v, table, lengths, _ = (_t(a) if a is not None else None for a in _inputs())
    with pytest.raises(ValueError):
        tpaged.paged_attention(q[0], k, v, table, lengths)           # q rank
    with pytest.raises(ValueError):
        tpaged.paged_attention(q, k, v, table[:1], lengths)          # batch
    with pytest.raises(ValueError):
        tpaged.paged_attention(q, k, v, table, lengths[:1])          # lengths
    with pytest.raises(ValueError):
        tpaged.paged_attention(q, k, v, table, lengths, k_scale=torch.ones(N, BS, KVH))
    with pytest.raises(ValueError):
        tpaged.paged_attention(q, k, v, table, lengths, impl="nope")


def test_op_never_gives_way_to_the_other_path():
    """The kernel for CUDA tensors, the plain version for CPU tensors:
    asking for the kernel on the CPU, or any path on another device,
    raises instead of falling back."""
    q, k, v, table, lengths, _ = (_t(a) if a is not None else None for a in _inputs())
    with pytest.raises(ValueError, match="no path"):
        tpaged.paged_attention(q, k, v, table, lengths, impl="pallas")
    meta = [t.to("meta") for t in (q, k, v, table, lengths)]
    for impl in tpaged.IMPLS:
        with pytest.raises(ValueError, match="no path"):
            tpaged.paged_attention(*meta, impl=impl)
    with pytest.raises(ValueError, match="CUDA"):
        tpaged.paged_attention_cuda(
            q.bfloat16(), k.bfloat16(), v.bfloat16(), table, lengths
        )


@pytest.mark.parametrize("int8", [False, True])
def test_chip_smoke_row_check_rejects_a_dropped_block(int8):
    """chip_smoke.py's check of row 6 on the CPU: the plain version passes
    against itself, and the planted fault (each row's last visible pool
    block dropped, for rows that cover more than one block) fails it in a
    share of rows that the check reports."""
    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    q, k, v, table, lengths, scales = _inputs(seed=7, int8=int8)
    kv = (lambda a: _t(a).bfloat16()) if not int8 else _t
    args = (_t(q).bfloat16(), kv(k), kv(v), _t(table), _t(lengths))
    kw = {} if scales is None else {"k_scale": _t(scales[0]), "v_scale": _t(scales[1])}
    want = tpaged.paged_attention_plain(*args, **kw)
    fault = chip_smoke.dropped_block_fault(*args, **kw)
    # rows that cover one block or none are left as they are
    cover = -(-np.asarray(LENGTHS) // BS)
    assert torch.equal(fault[cover <= 1], want[cover <= 1])
    chk = chip_smoke.check_paged_rows("plain", want, want, fault)
    assert chk["max_row_rel_err"] == 0 and chk["fault_rows_over_limit"] > 0
    assert chk["limit"] == chip_smoke.PAGED_ROW_LIMIT
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_rows("out", fault, want, chk["limit"])
    # the check passes a fault only by failing: want against itself as the fault
    with pytest.raises(AssertionError, match="planted fault"):
        chip_smoke.check_paged_rows("plain", want, want, want)
