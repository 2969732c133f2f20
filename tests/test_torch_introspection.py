"""Program costs, device peaks and program tracking in the port, on the CPU.

Twins of the reference's introspection and usage tests
(``tests/unit/test_introspection.py``, ``tests/unit/test_usage.py``) on
:mod:`unionml_tpu_torch.introspection`: the tracker per signature
(the first dispatch of a signature is the port's compile event, counted
under :class:`~unionml_tpu_torch.introspection.CostCounter`), the peak
table and its env override, the engine's, the batcher's and the trainers'
programs in ``stats()`` and ``/metrics``, and FLOPs billed to tenants.
Then the costs themselves: every kernel row's cost function against the
bound PERF.md §6 lists at its shapes, each row charging its cost function
and nothing of its plain version's ops, the counter's thread-locality, and
the counted FLOPs of the engine's, the batcher's and the trainer's
programs against the JAX package's ``cost_analysis()`` of the same tiny
Llama.
"""

import threading

import numpy as np
import pytest
import torch

from unionml_tpu_torch import introspection
from unionml_tpu_torch.execution import jit_predictor, run_step_trainer
from unionml_tpu_torch.introspection import CostCounter, ProgramTracker, resolve_device_peaks
from unionml_tpu_torch.models import Llama, LlamaConfig, init_params
from unionml_tpu_torch.ops import _build
from unionml_tpu_torch.ops import flash_attention as fa
from unionml_tpu_torch.ops import fused_attention as tfa
from unionml_tpu_torch.ops import fused_norm as fn
from unionml_tpu_torch.ops import int4_matmul as i4
from unionml_tpu_torch.ops import paged_attention as pa
from unionml_tpu_torch.serving import DecodeEngine
from unionml_tpu_torch.serving.batcher import MicroBatcher
from unionml_tpu_torch.serving.usage import UsageLedger, tenant_scope
from unionml_tpu_torch.telemetry import FlightRecorder, MetricsRegistry, TraceRecorder

import torch_threads

torch_threads.share_cores()


def _row(text: str, name: str, **labels) -> float:
    want = [f'{k}="{v}"' for k, v in labels.items()]
    line = next(line for line in text.splitlines()
                if line.startswith(name + "{") and all(w in line for w in want))
    return float(line.rsplit(" ", 1)[1])


# ------------------------------------------------------------- tracker


def test_tracker_records_cost_and_compiles_per_signature():
    reg = MetricsRegistry()
    tracker = ProgramTracker(registry=reg, component="t0")
    fn_ = tracker.wrap("t.matmul", lambda x: (x @ x).sum(), sig_fn=lambda x: tuple(x.shape))
    fn_(torch.ones(16, 16))            # compile #1
    fn_(torch.ones(16, 16))            # counted signature: a lookup
    fn_(torch.ones(32, 32))            # compile #2 (new shape)
    stats = tracker.stats()["t.matmul"]
    assert stats["calls"] == 3 and stats["compiles"] == 2
    # the mm's 2 * n^3 and the sum's n^2; bytes: each distinct operand and
    # each result once (x @ x reads x once)
    assert stats["flops_per_call"] == 2 * 32**3 + 32**2
    assert stats["bytes_per_call"] == 2 * 32 * 32 * 4 + 32 * 32 * 4 + 4
    assert stats["flops_total"] == 2 * (2 * 16**3 + 16**2) + 2 * 32**3 + 32**2
    assert stats["compile_ms"]["n"] == 2
    assert 0 <= stats["mfu"] < 10
    text = reg.exposition()
    for name in ("unionml_program_calls_total", "unionml_program_compiles_total",
                 "unionml_program_flops_total", "unionml_program_bytes_total",
                 "unionml_program_compile_ms_bucket", "unionml_program_mfu_ratio",
                 "unionml_program_hbm_ratio"):
        assert name in text, name
    assert _row(text, "unionml_program_compiles_total", program="t.matmul") == 2


def test_tracker_counts_one_compile_for_a_repeated_shape():
    """A signature revisited stays counted (no phantom recompiles), as the
    reference's twin holds for a donated state."""
    tracker = ProgramTracker(registry=MetricsRegistry(), component="t1")
    fn_ = tracker.wrap("t.state", lambda s, x: {"a": s["a"] + x.sum()})
    state = {"a": torch.ones(8, 8)}
    for _ in range(3):
        state = fn_(state, torch.ones(8, 8))
    stats = tracker.stats()["t.state"]
    assert stats["calls"] == 3 and stats["compiles"] == 1
    assert stats["bytes_per_call"] > 0


def test_tracker_callable_that_launches_nothing_costs_zero():
    """The reference's opaque callable: here its first call is still the
    signature's counted dispatch, and it costs (0, 0)."""
    tracker = ProgramTracker(registry=MetricsRegistry(), component="t2")
    fn_ = tracker.wrap("t.plain", lambda x: x + 1)
    assert fn_(1) == 2 and fn_(2) == 3
    stats = tracker.stats()["t.plain"]
    assert stats["calls"] == 2 and stats["compiles"] == 1
    assert stats["flops_total"] == 0 and stats["bytes_total"] == 0


def test_tracker_reset_keeps_learned_costs():
    tracker = ProgramTracker(registry=MetricsRegistry(), component="t3")
    fn_ = tracker.wrap("t.fn", lambda x: x * 2.0)
    fn_(torch.ones(64))
    tracker.reset()
    stats = tracker.stats()["t.fn"]
    assert stats["calls"] == 0 and stats["flops_total"] == 0
    fn_(torch.ones(64))  # a call after reset still knows its cost
    assert tracker.stats()["t.fn"]["bytes_total"] == 2 * 64 * 4
    assert tracker.stats()["t.fn"]["compiles"] == 0


def test_on_compile_hears_each_signature_once():
    heard = []
    tracker = ProgramTracker(registry=MetricsRegistry(), component="t5",
                             on_compile=lambda key, ms: heard.append((key, ms)))
    fn_ = tracker.wrap("t.step", lambda x: x * 3, sig_fn=lambda x: x.shape[0])
    for n in (4, 4, 8, 4):
        fn_(torch.ones(n))
    assert [k for k, _ in heard] == ["t.step", "t.step"] and all(ms >= 0 for _, ms in heard)


def test_counter_counts_only_its_own_threads_calls():
    """The engine's dispatcher and harvester and the batcher's callers
    dispatch on several threads at once: each counter sees its thread's
    ops only."""
    barrier = threading.Barrier(2)
    costs = {}

    def work(name: str, n: int) -> None:
        x = torch.ones(n, n)
        with CostCounter() as counter:
            barrier.wait()
            for _ in range(5):
                x = x @ torch.eye(n)
            barrier.wait()
        costs[name] = counter.cost

    threads = [threading.Thread(target=work, args=a) for a in (("a", 8), ("b", 32))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    # eye writes n*n, the mm reads two n*n operands and writes one
    assert costs["a"] == (5 * 2 * 8**3, 5 * (8 * 8 * 4 + 3 * 8 * 8 * 4))
    assert costs["b"] == (5 * 2 * 32**3, 5 * (32 * 32 * 4 + 3 * 32 * 32 * 4))


def test_views_and_inference_mode_composites():
    """A view moves nothing; a composite op that reaches the mode whole
    (tensordot under inference mode) counts what it decomposes into; a
    gather and a scatter move their selected rows, not the whole table."""
    table = torch.randn(1000, 16)
    idx = torch.tensor([3, 5])
    with torch.inference_mode(), CostCounter() as counter:
        table.view(16000)
        y = torch.tensordot(torch.ones(4, 16), torch.ones(16, 8), dims=1)
    assert counter.flops == 2 * 4 * 16 * 8 and y.shape == (4, 8)
    with CostCounter() as gather:
        table[idx]
    assert gather.cost == (0.0, 2 * 2 * 16 * 4 + 2 * 8)
    with CostCounter() as scatter:
        table[idx] = torch.zeros(2, 16)
    assert scatter.bytes == 2 * 2 * 16 * 4 + 2 * 8 + 2 * 16 * 4   # the zeros written too


# ------------------------------------------------------- peaks and MFU


def test_peak_table_resolution_on_cpu():
    peaks = resolve_device_peaks("cpu")
    assert peaks["platform"] == "cpu" and peaks["source"] == "table"
    assert peaks["peak_flops"] and peaks["peak_bytes_per_s"]


@pytest.mark.parametrize("name, want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 2.0e12)),
    ("Some Other Card", (None, None)),
])
def test_peak_table_names_the_card(monkeypatch, name, want):
    """The H100 SXM (as the card names itself) resolves from the table to
    the data-sheet peaks chip_smoke.py bounds each kernel by; an unknown
    card keeps the reference's behaviour: unknown peaks, gauges at 0."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    peaks = resolve_device_peaks(0)
    assert (peaks["platform"], peaks["kind"]) == ("gpu", name)
    assert (peaks["peak_flops"], peaks["peak_bytes_per_s"]) == want
    assert peaks["source"] == ("unknown" if want[0] is None else "table")
    if want[0] is None:
        tracker = ProgramTracker(registry=MetricsRegistry(), component="t6")
        tracker._peaks = peaks
        fn_ = tracker.wrap("t.fn", lambda x: x @ x)
        for _ in range(3):
            fn_(torch.ones(8, 8))
        assert tracker.stats()["t.fn"]["mfu"] == 0 == tracker.stats()["t.fn"]["hbm_utilization"]


def test_peak_env_override(monkeypatch):
    monkeypatch.setenv(introspection.PEAK_FLOPS_ENV, "1e6")
    monkeypatch.setenv(introspection.PEAK_HBM_ENV, "0.000001")  # 1e3 B/s
    peaks = resolve_device_peaks()
    assert peaks["source"] == "env"
    assert peaks["peak_flops"] == 1e6
    assert peaks["peak_bytes_per_s"] == pytest.approx(1e3)
    reg = MetricsRegistry()
    tracker = ProgramTracker(registry=reg, component="t4")
    fn_ = tracker.wrap("t.fn", lambda x: (x @ x).sum())
    for _ in range(4):
        fn_(torch.ones(64, 64))
    stats = tracker.stats()
    assert stats["device"]["source"] == "env"
    assert stats["t.fn"]["mfu"] > 0 and stats["t.fn"]["hbm_utilization"] > 0
    assert _row(reg.exposition(), "unionml_program_mfu_ratio", program="t.fn") > 0


def test_malformed_peak_override_falls_back(monkeypatch):
    monkeypatch.setenv(introspection.PEAK_FLOPS_ENV, "not-a-number")
    assert resolve_device_peaks("cpu")["source"] == "table"  # malformed override ignored


# ----------------------------------------------------- engine, batcher


CFG = LlamaConfig.tiny(vocab_size=61, dtype="float32")


@pytest.fixture(scope="module")
def tiny_params():
    return init_params(CFG, seed=0, device="cpu")


def _engine(**kwargs):
    defaults = dict(slots=2, max_new_tokens=6, prompt_buckets=(8,), chunk_steps=2,
                    registry=MetricsRegistry(), tracer=TraceRecorder(), device="cpu")
    defaults.update(kwargs)
    return DecodeEngine(Llama(CFG), **defaults)


def test_engine_stats_programs_and_metrics(tiny_params):
    engine = _engine(flight=FlightRecorder(), paged=True)
    try:
        engine.generate(tiny_params, [[1, 2, 3], [4, 5, 6]])
        programs = engine.stats()["programs"]
        assert programs["device"]["platform"] == "cpu"
        decode = programs["engine.decode"]
        assert decode["calls"] >= 1 and decode["compiles"] == 1
        assert decode["flops_per_call"] > 0 and decode["bytes_per_call"] > 0
        assert decode["compile_ms"]["n"] == 1
        assert 0 <= decode["mfu"] < 10
        prefill = programs["engine.prefill"]
        assert prefill["calls"] == 2 and prefill["flops_total"] > 0
        assert _row(engine._registry.exposition(), "unionml_program_flops_total",
                    program="engine.decode", component=engine.instance) > 0
    finally:
        engine.close()


def test_engine_bills_tenants_flops(tiny_params):
    """The FLOPs attribution of the reference's three-tenant stream: each
    tenant's decode and prefill programs' counted FLOPs land on its
    vector and in ``unionml_tenant_flops_total``."""
    registry = MetricsRegistry()
    ledger = UsageLedger(registry=registry, top_k=8)
    engine = _engine(registry=registry, usage=ledger, paged=True)
    try:
        rng = np.random.default_rng(0)
        for tenant in ("a", "b", "a"):
            with tenant_scope(tenant):
                engine.generate(tiny_params, [rng.integers(1, 61, 5).tolist()])
        report = ledger.report()
        assert report["tenants"]["a"]["flops"] > report["tenants"]["b"]["flops"] > 0
        assert _row(registry.exposition(), "unionml_tenant_flops_total", tenant="a") > 0
    finally:
        engine.close()


def test_batcher_programs_and_flight():
    reg, flight = MetricsRegistry(), FlightRecorder()
    w = torch.ones(3, 5)
    batcher = MicroBatcher(lambda f: torch.as_tensor(f) @ w, max_batch_size=8, max_wait_ms=5.0,
                           registry=reg, flight=flight)
    try:
        batcher.submit(np.ones((2, 3), np.float32))
        prog = batcher.stats()["programs"]["batcher.predict"]
        assert prog["calls"] >= 1 and prog["compiles"] >= 1
        # the product over the padded bucket's rows
        assert prog["flops_per_call"] == 2 * batcher._bucket(2) * 3 * 5
        assert {"submit", "batch"} <= {e["kind"] for e in flight.dump()}
    finally:
        batcher.close()


def test_batcher_introspect_off():
    batcher = MicroBatcher(lambda f: f.sum(axis=1), max_batch_size=4, max_wait_ms=2.0,
                           registry=MetricsRegistry(), introspect=False)
    try:
        np.testing.assert_allclose(batcher.submit(np.ones((1, 3), np.float32)), [3.0])
        assert "programs" not in batcher.stats() and batcher._programs is None
    finally:
        batcher.close()


def test_batcher_bills_flops_by_rows():
    """The reference's per-row billing: a shared call's FLOPs split by row
    share (3:1 when both entries land in one batch)."""
    registry = MetricsRegistry()
    ledger = UsageLedger(registry=registry, top_k=4)
    w = torch.ones(4, 4)
    batcher = MicroBatcher(lambda f: torch.as_tensor(f) @ w, max_batch_size=16,
                           max_wait_ms=50.0, registry=registry, tracer=TraceRecorder(),
                           usage=ledger)
    try:
        def submit(tenant, rows):
            with tenant_scope(tenant):
                batcher.submit(np.full((rows, 4), 1.0, np.float32))

        threads = [threading.Thread(target=submit, args=a) for a in (("big", 3), ("small", 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        report = ledger.report()
        big, small = report["tenants"]["big"]["flops"], report["tenants"]["small"]["flops"]
        assert big > 0 and small > 0
        cost = batcher.stats()["programs"]["batcher.predict"]
        assert big + small == pytest.approx(cost["flops_total"])
        if cost["calls"] == 1:   # batched together: a 3:1 split
            assert big == pytest.approx(3 * small)
    finally:
        batcher.close()


# ------------------------------------------------------------- trainers


def _linear_problem():
    def step(state, batch):
        x, y = batch
        err = x @ state["w"] - y
        return {"w": state["w"] - 0.01 * x.T @ err}, {"loss": (err ** 2).mean()}

    rng = np.random.default_rng(0)
    return (step, {"w": torch.zeros(4)}, rng.normal(size=(32, 4)).astype(np.float32),
            rng.normal(size=(32,)).astype(np.float32))


def test_trainer_step_program_in_metrics():
    step, state, x, y = _linear_problem()
    reg = MetricsRegistry()
    run_step_trainer(step_fn=step, state=state, features=x, targets=y, num_epochs=1,
                     batch_size=8, registry=reg)
    text = reg.exposition()
    assert _row(text, "unionml_program_flops_total", component="trainer",
                program="trainer.step") > 0
    assert _row(text, "unionml_program_compiles_total", program="trainer.step") == 1
    assert "unionml_program_mfu_ratio" in text


def test_elastic_trainer_step_is_tracked_and_debits_compile(tmp_path):
    from unionml_tpu_torch.elastic import run_elastic_trainer
    from unionml_tpu_torch.goodput import GoodputTracker

    step, state, x, y = _linear_problem()
    reg = MetricsRegistry()
    tracker = GoodputTracker(registry=reg, tracer=TraceRecorder(registry=reg),
                             flight=FlightRecorder())
    run_elastic_trainer(step_fn=step, state=state, arrays=[x, y], checkpoint_dir=str(tmp_path),
                        batch_size=8, goodput=tracker, checkpoint_every=100)
    text = reg.exposition()
    assert _row(text, "unionml_program_flops_total", program="trainer.elastic_step") > 0
    assert _row(text, "unionml_program_compiles_total", program="trainer.elastic_step") == 1
    assert tracker.report()["badput_s"]["compile"] > 0


def test_jit_predictor_warm_up_is_the_counted_compile():
    """On the CPU the body runs as called; its first call per signature is
    counted, and the later calls are credited that cost."""
    def body(state, features):
        return torch.as_tensor(features) @ state["w"]

    graphed = jit_predictor(body)
    state = {"w": torch.ones(3, 2)}
    for _ in range(3):
        graphed(state, np.ones((4, 3), np.float32))
    stats = graphed.programs.stats()["predictor.jit"]
    assert stats["calls"] == 3 and stats["compiles"] == 1
    assert stats["flops_per_call"] == 2 * 4 * 3 * 2


# ------------------------------------------------ kernel rows' costs

# the published H100 SXM peaks chip_smoke.py bounds each row by
PEAK_BYTES, PEAK_BF16 = introspection.DEVICE_PEAKS["h100 80gb hbm3"][::-1]
PEAK_FP32 = 67e12
PAGED_LENGTHS = [(1, 15, 16, 17, 300, 1000, 1100)[i % 7] for i in range(15)] + [1]


def _t(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _flash(cost_fn, **kw):
    return cost_fn(_t(2, 4095, 12, 64), _t(2, 4095, 4, 64), _t(2, 4095, 4, 64), causal=True,
                   **kw)


VIT_X = _t(12608, 768)
VIT_P = _t(768, dtype=torch.float32)
VIT_Q = _t(64, 197, 12, 64)

# each row: its cost at PERF.md §6's shape, the peak of its operations'
# type, the bound PERF.md lists
BOUNDS = {
    "1 flash_fwd_padded": (fa.flash_fwd_padded_cost(
        _t(4, 1024, 32, 128), _t(4, 1024, 8, 128), _t(4, 1024, 8, 128), causal=True,
        pads=[0, 17, 333, 1000]), PEAK_BF16, 0.02504062567164179),
    "2 rms_norm": (fn.norm_fwd_cost(_t(4096, 4096), _t(4096), None, True), PEAK_FP32,
                   0.020034942089552237),
    "3 layer_norm_fwd": (fn.norm_fwd_cost(VIT_X, VIT_P, VIT_P, False), PEAK_FP32,
                         0.011563558208955224),
    "4 add_layer_norm_fwd": (fn.norm_add_fwd_cost(VIT_X, VIT_P, VIT_P, False), PEAK_FP32,
                             0.023125282388059703),
    "5 norm_bwd": (fn.norm_bwd_cost(VIT_X, VIT_P, False, True), PEAK_FP32,
                   0.017345337313432834),
    "6 paged_attention": (pa.paged_attention_cost(
        _t(16, 32, 128), _t(1169, 16, 8, 128), _t(16, 73, dtype=torch.int32),
        lengths=PAGED_LENGTHS), PEAK_BF16, 0.006070829850746268),
    "7 int4_matmul": (i4.int4_matmul_cost(_t(40, 4096), _t(4096, 2048, dtype=torch.int8),
                                          _t(4096, dtype=torch.float32)), PEAK_BF16,
                      0.0027045826865671643),
    "8 int4_matmul_grouped": (i4.int4_matmul_cost(
        _t(16, 4096), _t(4096, 7168, dtype=torch.int8), _t(32, 14336, dtype=torch.float32)),
        PEAK_BF16, 0.009488047761194031),
    "9 flash_fwd": (_flash(fa.flash_fwd_cost), PEAK_BF16, 0.05210012602628918),
    "10 flash_bwd_dq": (_flash(fa.flash_bwd_dq_cost), PEAK_BF16, 0.07815018903943377),
    "11 flash_bwd_dkv": (_flash(fa.flash_bwd_dkv_cost), PEAK_BF16, 0.10420025205257837),
    "delta flash_bwd_delta": (_flash(fa.flash_delta_cost), PEAK_BF16, 0.05210012602628918),
    "12 fused_attention_fwd": (tfa.fused_attention_fwd_cost(VIT_Q, VIT_Q, VIT_Q, causal=False),
                               PEAK_BF16, 0.023123448358208953),
    "13 fused_attention_bwd": (tfa.fused_attention_bwd_cost(VIT_Q, VIT_Q, VIT_Q, causal=False),
                               PEAK_BF16, 0.040466034626865675),
}


@pytest.mark.parametrize("row", sorted(BOUNDS))
def test_kernel_cost_reproduces_the_perf_bound(row):
    cost, peak, want = BOUNDS[row]
    got, _ = _build.bound_ms(cost, peak, PEAK_BYTES)
    assert got == pytest.approx(want, rel=1e-9)


def _cpu_rows():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    x, gam, bet = r(24, 64), r(64), r(64)
    q, k, v = r(2, 40, 4, 16), r(2, 40, 2, 16), r(2, 40, 2, 16)
    qf = r(2, 24, 4, 16)
    pq, pool = r(3, 4, 16), r(9, 8, 2, 16)
    table = torch.tensor([[1, 2, 0], [3, 4, 5], [6, 0, 0]], dtype=torch.int32)
    xi = r(5, 256)
    packed = torch.randint(-128, 128, (256, 64), dtype=torch.int8, generator=g)
    scale = r(128).abs()

    def flash_train():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        fa.flash_attention(qq, kk, vv, causal=True).sum().backward()

    def fused_train():
        qq = qf.clone().requires_grad_()
        tfa.fused_attention(qq, qq.detach()[:, :, :4], qq.detach()[:, :, :4]).sum().backward()

    return {
        "norm_fwd": (lambda: fn.fused_layer_norm(x, gam, bet),
                     [fn.norm_fwd_cost(x, gam, bet, False)]),
        "add_norm_fwd": (lambda: fn.fused_add_layer_norm(x, x, gam, None, rms=True),
                         [fn.norm_add_fwd_cost(x, gam, None, True)]),
        "flash_train": (flash_train, [fa.flash_fwd_cost(q, k, v, causal=True),
                                      fa.flash_bwd_cost(q, k, v, causal=True)]),
        "paged": (lambda: pa.paged_attention(pq, pool, pool, table, torch.tensor([3, 20, 1])),
                  [pa.paged_attention_cost(pq, pool, table)]),
        "int4": (lambda: i4.int4_matmul(xi, packed, scale, tile_n=128),
                 [i4.int4_matmul_cost(xi, packed, scale, torch.bfloat16)]),
        "fused_train": (fused_train, [tfa.fused_attention_fwd_cost(qf, qf, qf, causal=False),
                                      tfa.fused_attention_bwd_cost(qf, qf, qf, causal=False)]),
    }


@pytest.mark.parametrize("name", ["norm_fwd", "add_norm_fwd", "flash_train", "paged", "int4",
                                  "fused_train"])
def test_kernel_rows_charge_their_cost_on_the_cpu(name):
    """On the CPU a row runs its plain version; the counter is charged the
    row's cost function (the card's arithmetic) and none of the plain
    version's own ops."""
    run, costs = _cpu_rows()[name]
    with CostCounter() as counter:
        run()
    assert counter.kernel_flops == sum(c[0] for c in costs)
    assert counter.kernel_bytes == sum(c[1] for c in costs)


# ------------------------------------------ cost parity with the JAX package

# XLA's cost analysis counts the same products and one operation per
# element of each elementwise op and reduction, as the counter does, in
# another op graph: the counts found here (hidden 256, 2 layers) sit
# within 3% of each other; XLA counts a scan's body once, so the engine's
# decode chunk is compared per decode step
PARITY_REL = 0.04


def test_program_flops_match_the_jax_cost_analysis():
    import jax
    import jax.numpy as jnp

    from unionml_tpu import telemetry as jtelemetry
    from unionml_tpu.execution import run_step_trainer as jrun_step_trainer
    from unionml_tpu.models import Llama as JLlama
    from unionml_tpu.models import LlamaConfig as JConfig
    from unionml_tpu.models import train as jtrain
    from unionml_tpu.serving.batcher import MicroBatcher as JBatcher
    from unionml_tpu.serving.engine import DecodeEngine as JEngine

    from unionml_tpu_torch.models import TrainState, adamw, from_jax_params, lm_step

    kw = dict(vocab_size=97, dtype="float32", hidden_dim=256, num_heads=4, num_kv_heads=2,
              mlp_dim=512, num_layers=2)
    jcfg, cfg = JConfig.tiny(**kw), LlamaConfig.tiny(**kw)
    jmodule = JLlama(jcfg)
    jstate = jtrain.create_train_state(jmodule, jnp.zeros((1, 8), jnp.int32),
                                       optimizer=jtrain.adamw(1e-3))
    params = from_jax_params(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                                    jstate.params), cfg, device="cpu")
    flops, nbytes = {}, {}

    def record(key, j, t, per=1):
        flops[key] = (j["flops_per_call"], t["flops_per_call"] / per)
        nbytes[key] = (j["bytes_per_call"], t["bytes_per_call"] / per)

    steps = 2
    ekw = dict(slots=2, max_new_tokens=6, prompt_buckets=(16,), chunk_steps=steps, paged=True)
    jengine = JEngine(jmodule, registry=jtelemetry.MetricsRegistry(), **ekw)
    engine = DecodeEngine(Llama(cfg), device="cpu", registry=MetricsRegistry(), **ekw)
    try:
        prompts = [[1, 2, 3, 4, 5], [6, 7, 8]]
        assert engine.generate(params, prompts) == jengine.generate(jstate.params, prompts)
        jp, tp = jengine.stats()["programs"], engine.stats()["programs"]
        record("engine.prefill", jp["engine.prefill"], tp["engine.prefill"])
        record("engine.decode", jp["engine.decode"], tp["engine.decode"], per=steps)
    finally:
        jengine.close()
        engine.close()

    tokens = np.random.default_rng(0).integers(1, 97, size=(8, 33)).astype(np.int32)

    def jforward(x):
        out = jmodule.apply({"params": jstate.params}, x)
        return out[0] if isinstance(out, tuple) else out

    def forward(x):
        with torch.no_grad():
            out = Llama(cfg)(params, torch.as_tensor(x).long())
        return out[0] if isinstance(out, tuple) else out

    jbatcher = JBatcher(jax.jit(jforward), max_batch_size=4, max_wait_ms=1.0,
                        registry=jtelemetry.MetricsRegistry())
    batcher = MicroBatcher(forward, max_batch_size=4, max_wait_ms=1.0, registry=MetricsRegistry())
    try:
        jbatcher.submit(tokens[:4, :32])
        batcher.submit(tokens[:4, :32])
        record("batcher.predict", jbatcher.stats()["programs"]["batcher.predict"],
               batcher.stats()["programs"]["batcher.predict"])
    finally:
        jbatcher.close()
        batcher.close()

    jreg, reg = jtelemetry.MetricsRegistry(), MetricsRegistry()
    jrun_step_trainer(step_fn=jtrain.lm_step(jmodule), state=jstate, features=tokens,
                      batch_size=4, registry=jreg, donate_state=False)
    run_step_trainer(step_fn=lm_step(Llama(cfg)),
                     state=TrainState.create(apply_fn=Llama(cfg), params=params, tx=adamw(1e-3)),
                     features=tokens, batch_size=4, registry=reg)
    record("trainer.step", *[
        {f"{n}_per_call": _row(r.exposition(), f"unionml_program_{n}_total",
                               program="trainer.step") / 2 for n in ("flops", "bytes")}
        for r in (jreg, reg)])

    weights = sum(t.numel() * 4 for t in _tree_tensors(params))
    for key, (want, got) in flops.items():
        print(f"{key}: flops port {got} / jax {want} = {got / want:.4f}; bytes port "
              f"{nbytes[key][1]} / jax {nbytes[key][0]} = {nbytes[key][1] / nbytes[key][0]:.4f}")
        assert got == pytest.approx(want, rel=PARITY_REL), key
        # every weight the program reads at least once (the decode chunk's
        # per-step share included)
        assert nbytes[key][1] >= weights, key


def _tree_tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tree_tensors(v)]
    return []
