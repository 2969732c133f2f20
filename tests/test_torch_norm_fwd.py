"""The norm forward's bit check, statistics probe and planted faults on the CPU.

``chip_smoke.py`` holds kernel rows 2-4 (the RMS / LayerNorm forward and
the add form, one CUDA kernel) bit for bit and row by row against their
plain versions, on random inputs and on a statistics probe, and rejects
four planted faults. Here the same checks run with the plain version in
the kernel's place: it must pass them, and each planted fault, put in the
kernel's place, must fail them. Then the probe's inputs go through the
JAX package's fused norms (their Pallas kernels in interpret mode) and the
port's plain versions, which must agree. The kernel itself is held by
these checks on the card in ``tests/test_torch_cuda.py``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from unionml_tpu.ops.fused_norm import fused_add_layer_norm as jadd_ln
from unionml_tpu.ops.fused_norm import fused_layer_norm as jln

from unionml_tpu_torch.ops import fused_norm as tnorm

import torch_threads

torch_threads.share_cores()

# as test_torch_vit.py's norm parity: fp32 through the same arithmetic in
# another summation order
FP32 = dict(rtol=1e-5, atol=1e-5)


def _chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _params(d: int, rms: bool, gdtype, seed: int):
    gen = torch.Generator().manual_seed(seed)
    g = (1 + 0.1 * torch.randn(d, generator=gen)).to(gdtype)
    b = None if rms else (0.1 * torch.randn(d, generator=gen)).to(gdtype)
    return g, b


def _plain(g, b, eps: float, rms: bool):
    def fwd(x, r):
        if r is None:
            return {"y": tnorm.norm_fwd_plain(x, g, b, eps, rms)}
        return dict(zip(("s", "y"), tnorm.norm_add_fwd_plain(x, r, g, b, eps, rms)))
    return fwd


def _faulty(fault: str, g, b, eps: float, rms: bool):
    """A forward that computes ``fault`` (its ``y``; ``s`` stays right)."""
    smoke = _chip_smoke()
    plain = _plain(g, b, eps, rms)

    def fwd(x, r):
        out = plain(x, r)
        out["y"] = smoke.norm_fwd_faults(x, r, g, b, eps, rms)[fault]
        return out
    return fwd


# (rows, d, x dtype, gamma dtype, rms, add): the ViT-B width (768, a
# ragged 788-row slice of its 12608 rows), Llama's 4096, a row count that
# is not a multiple of 16, a single row, and fp32 x
CASES = [
    (788, 768, torch.bfloat16, torch.float32, False, False),
    (788, 768, torch.bfloat16, torch.float32, False, True),
    (300, 4096, torch.bfloat16, torch.bfloat16, True, False),
    (37, 4096, torch.bfloat16, torch.float32, False, True),
    (16, 4096, torch.bfloat16, torch.bfloat16, True, True),
    (1, 768, torch.bfloat16, torch.float32, False, False),
    (53, 768, torch.float32, torch.float32, True, True),
    (17, 64, torch.float32, torch.bfloat16, False, False),
]


def _ids(case):
    rows, d, dtype, gdtype, rms, add = case
    return (f"{rows}x{d}-{str(dtype)[6:]}-g{str(gdtype)[6:]}-"
            f"{'rms' if rms else 'ln'}{'-add' if add else ''}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_forward_passes_the_norm_fwd_check(case):
    """The plain forward in the kernel's place: no output off its own bits,
    no row apart, on random inputs and on the probe; its bits do not
    depend on the call's rows; and every planted fault fails the check on
    one of the two inputs (the shares are recorded)."""
    smoke = _chip_smoke()
    rows, d, dtype, gdtype, rms, add = case
    g, b = _params(d, rms, gdtype, rows + d)
    gen = torch.Generator().manual_seed(rows * d)
    out = smoke.norm_fwd_cases("plain", _plain(g, b, 1e-6, rms), rows, d, dtype, g, b, 1e-6,
                               rms, add, gen)
    checks = out["checks"]
    assert set(checks) == {"random", "probe"}
    expected = {"last_vector_dropped", "last_vector_dropped_1_in_16"}
    expected |= {"next_row_stats"} if rows > 1 else set()
    expected |= {"rounded_sum_normalized"} if add and dtype == torch.bfloat16 else set()
    for chk in checks.values():
        assert chk["rows"]["max_row_rel_err"] == 0
        assert chk["rows"]["limit"] == smoke.NORM_FWD_ROW_LIMIT[dtype]
        assert chk.get("mismatch", 0) == 0
        assert ("mismatch" in chk) == (dtype == torch.bfloat16)
        assert {k[6:] for k in chk if k.startswith("fault_")} == expected
    for fault in expected:
        assert any(checks[k][f"fault_{fault}"]["fails"] for k in checks), fault


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_planted_norm_fwd_fault_fails_the_check(case):
    """Each planted fault, put in the kernel's place, is rejected: by the
    bit check or the row check, on random inputs or on the probe."""
    smoke = _chip_smoke()
    rows, d, dtype, gdtype, rms, add = case
    g, b = _params(d, rms, gdtype, rows + d)
    faults = ["last_vector_dropped", "last_vector_dropped_1_in_16"]
    faults += ["next_row_stats"] if rows > 1 else []
    faults += ["rounded_sum_normalized"] if add and dtype == torch.bfloat16 else []
    for fault in faults:
        gen = torch.Generator().manual_seed(rows * d)
        with pytest.raises(AssertionError, match="off the plain version's bits|disagrees"):
            smoke.norm_fwd_cases("fault", _faulty(fault, g, b, 1e-6, rms), rows, d, dtype, g, b,
                                 1e-6, rms, add, gen)


def test_last_vector_dropped_passes_norm_tol_at_llama_width():
    """Why the bit check exists: at Llama's width (RMS, bf16, d = 4096) the
    last 16-byte vector left out of every row's statistics stays within
    the elementwise NORM_TOL and within the row limit on random inputs,
    but puts several percent of outputs off the plain version's bits; the
    probe moves its rows far past the row limit."""
    smoke = _chip_smoke()
    g, b = _params(4096, True, torch.bfloat16, 0)
    gen = torch.Generator().manual_seed(1)
    out = smoke.norm_fwd_cases("plain", _plain(g, b, 1e-5, True), 256, 4096, torch.bfloat16,
                               g, b, 1e-5, True, False, gen)
    random = out["checks"]["random"]["fault_last_vector_dropped"]
    assert random["passes_norm_tol"]
    assert random["max_row_rel_err"] <= smoke.NORM_FWD_ROW_LIMIT[torch.bfloat16]
    assert random["mismatch"] > 10 * smoke.NORM_FWD_MISMATCH_MAX
    probe = out["checks"]["probe"]["fault_last_vector_dropped"]
    assert probe["max_row_rel_err"] > 5 * smoke.NORM_FWD_ROW_LIMIT[torch.bfloat16]


def test_rounded_sum_fault_passes_the_row_check_at_vit_width():
    """The add form normalizing the bf16-rounded s instead of the fp32 sum
    (what staging s rounded would do) stays within the row limit at the
    ViT-B width; only the bit check sees it."""
    smoke = _chip_smoke()
    g, b = _params(768, False, torch.float32, 2)
    gen = torch.Generator().manual_seed(3)
    out = smoke.norm_fwd_cases("plain", _plain(g, b, 1e-6, False), 788, 768, torch.bfloat16,
                               g, b, 1e-6, False, True, gen)
    for chk in out["checks"].values():
        fault = chk["fault_rounded_sum_normalized"]
        assert fault["max_row_rel_err"] <= smoke.NORM_FWD_ROW_LIMIT[torch.bfloat16]
        assert fault["mismatch"] > 10 * smoke.NORM_FWD_MISMATCH_MAX


@pytest.mark.parametrize("rows,d", [(1, 64), (16, 4096), (40, 768)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_stats_probe_spikes_every_vector_position(rows, d, dtype):
    """Row i of the probe holds two spiked 16-byte vectors, i mod n and its
    mirror (n vectors a row): over the rows, both ends and, given n / 2
    rows, every position."""
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    x, r = smoke.norm_stats_probe(rows, d, dtype, gen)
    assert r is None and x.dtype == dtype and x.shape == (rows, d)
    vec = 16 // x.element_size()
    n = d // vec
    base = torch.randn(rows, d, generator=torch.Generator().manual_seed(0)).to(dtype)
    ratio = (x.float() / base.float()).reshape(rows, n, vec)
    spiked = (ratio == smoke.NORM_SPIKE).all(dim=-1)
    for i in range(rows):
        assert set(torch.nonzero(spiked[i]).flatten().tolist()) == {i % n, n - 1 - i % n}
    _, r = smoke.norm_stats_probe(rows, d, dtype, torch.Generator().manual_seed(0), add=True)
    assert r.shape == x.shape and r.dtype == dtype


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("rows,d", [(40, 128), (24, 768)])
def test_norm_stats_probe_through_jax_and_the_port(rows, d, rms, add):
    """The probe's inputs (fp32) through the JAX package's fused norm
    (Pallas in interpret mode) and the port's plain forward agree, as
    ``test_torch_vit.py``'s norm parity holds them."""
    smoke = _chip_smoke()
    x, r = smoke.norm_stats_probe(rows, d, torch.float32, torch.Generator().manual_seed(5), add)
    rng = np.random.default_rng(7)
    gamma = (rng.normal(size=d) + 1.0).astype(np.float32)
    beta = None if rms else rng.normal(size=d).astype(np.float32)
    jb = None if rms else jnp.asarray(beta)
    tb = None if rms else torch.from_numpy(beta)
    if add:
        js, jy = jadd_ln(jnp.asarray(x.numpy()), jnp.asarray(r.numpy()), jnp.asarray(gamma),
                         jb, 1e-6, rms)
        ts, ty = tnorm.norm_add_fwd_plain(x, r, torch.from_numpy(gamma), tb, 1e-6, rms)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **FP32)
    else:
        jy = jln(jnp.asarray(x.numpy()), jnp.asarray(gamma), jb, 1e-6, rms)
        ty = tnorm.norm_fwd_plain(x, torch.from_numpy(gamma), tb, 1e-6, rms)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FP32)
