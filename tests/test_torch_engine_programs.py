"""The decode engine's compiled programs (A11) on the CPU.

On the card each decode chunk (contiguous, paged, speculative) and each
paged admission program is captured once per signature as a CUDA graph
and replayed (``unionml_tpu_torch.serving._programs``). Here, with no
card, the same programs run through the same program cache with the
capture stubbed (:func:`_stub_capture`: the warm-up runs and is counted,
and a "replay" runs the body again on the graph's static inputs, as a
graph replays its recorded kernels), so the bookkeeping and the static
input buffers are held against the JAX package's ``DecodeEngine`` token
for token. Each program also runs under a dispatch mode that raises on
any operation that reads a device value on the host (the CPU's proof
that it can be captured), and keeps every state tensor's storage from
chunk to chunk and admission to admission (the reference donates it).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from unionml_tpu import telemetry as jtelemetry
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.serving.engine import DecodeEngine as JEngine
from unionml_tpu.serving.prefix_cache import RadixPrefixCache as JRadixPrefixCache

from unionml_tpu_torch import _graphs, telemetry
from unionml_tpu_torch.diagnostics import nan_guard
from unionml_tpu_torch.introspection import CostCounter
from unionml_tpu_torch.models import Llama, LlamaConfig, from_jax_params
from unionml_tpu_torch.ops import _build
from unionml_tpu_torch.serving import DecodeEngine, FaultInjector
from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

import torch_threads

torch_threads.share_cores()

VOCAB = 97
DRAFT = dict(hidden_dim=32, num_layers=1, num_heads=2, num_kv_heads=1, mlp_dim=64)
PROGRAMS = {"engine.decode", "engine.prefill", "engine.prefill_chunk", "engine.prefill_final"}


def _cfgs(**over):
    kw = dict(vocab_size=VOCAB, dtype="float32", **over)
    return JConfig.tiny(**kw), LlamaConfig.tiny(**kw)


def _port(tree, cfg):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg, device="cpu")


@pytest.fixture(scope="module")
def weights():
    (jt, t), (jd, d) = _cfgs(), _cfgs(**DRAFT)
    jtp = JLlama(jt).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jdp = JLlama(jd).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    return dict(jt=jt, jd=jd, t=t, d=d, jtp=jtp, jdp=jdp, tp=_port(jtp, t), dp=_port(jdp, d))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=n).tolist() for n in lengths]


class _Kernel:
    """Stands in for a kernel row's launch counter."""

    launches = 0


class _Rerun:
    """A stubbed graph: its replay runs the captured body again."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


class _Stub:
    """The card's capture without a card (see the module docstring); each
    "graph" launches :attr:`kernel` once a replay."""

    def __init__(self):
        self.kernel = _Kernel()
        self.captured = []

    def __call__(self, body, device, what, *, pool=None, generators=(),
                 mode="global", hint=""):
        counter = CostCounter()
        with counter:
            warm = body()
        self.captured.append(what)
        return _graphs.Graph(_Rerun(body), warm, warm, {self.kernel: 1}, counter.cost)


def _graphed(engine, stub=None):
    """The engine's programs through the program cache, captured by
    ``stub`` (the seam the card takes with the real capture)."""
    engine._graphs.capturable = True
    engine._graphs.capture = stub if stub is not None else _Stub()
    return engine


def _state_ptrs(engine) -> dict:
    """Every device buffer the programs update in place, by name."""
    out = {}

    def walk(name, x):
        if isinstance(x, torch.Tensor):
            out[name] = x.data_ptr()
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{name}.{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{name}[{i}]", v)

    walk("state", engine._state)
    walk("fresh", engine._fresh)
    return out


HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "is_nonzero", "equal",
              "item", "_unique", "_unique2", "unique_consecutive", "unique_dim",
              "repeat_interleave"}


class _NoHostReads(TorchDispatchMode):
    """Raises on an op that reads a device value on the host: a scalar
    read, a data-dependent shape (nonzero, masked_select, a bool-mask
    index, unique, repeat_interleave by a tensor), a copy to pinned or
    host memory. Such an op waits for the card and breaks a capture."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        bad = name in HOST_READS
        if name in ("index", "index_put", "index_put_"):
            bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                      for i in (args[1] or ()))
        if name == "_to_copy" and kwargs.get("device") == torch.device("cpu"):
            bad = True
        if name == "copy_" and args[0].is_pinned():
            bad = True
        if bad:
            raise AssertionError(f"a program read the device on the host: {func}")
        return func(*args, **kwargs)


def _checked(fn):
    def run(*args, **kwargs):
        with _NoHostReads():
            return fn(*args, **kwargs)
    return run


def _no_host_reads(engine):
    """Each device program of ``engine`` runs under :class:`_NoHostReads`."""
    for name in ("_decode_chunk", "_prefill", "_prefill_step", "_prefill_final"):
        setattr(engine, name, _checked(getattr(engine, name)))
    return engine


# --------------------------------------------------------------------- #
# (a, b, c) token parity, storage kept, no host read
# --------------------------------------------------------------------- #

BASE = dict(slots=2, max_new_tokens=12, prompt_buckets=(8, 32), prefill_chunk=8,
            chunk_steps=2, pipeline_depth=2)
MODES = {
    "contiguous": {},
    "paged": dict(paged=True, kv_block_size=8),
    "int8_kv": dict(paged=True, kv_block_size=8, kv_quant=True),
    "speculative": dict(speculate_k=2, draft=True),
}


def _mode(weights, mode):
    kw = dict(BASE, **MODES[mode])
    quant = kw.pop("kv_quant", False)
    draft = kw.pop("draft", False)
    jt, t = weights["jt"], weights["t"]
    jp, tp = weights["jtp"], weights["tp"]
    if quant:
        jt, t = (dataclasses.replace(c, kv_quant=True) for c in (jt, t))
        tp = _port(jp, t)
    jkw, pkw = dict(kw), dict(kw)
    if draft:
        jkw["draft_module"] = JLlama(weights["jd"])
        pkw["draft_module"] = Llama(weights["d"])
        jp, tp = ({"target": jp, "draft": weights["jdp"]},
                  {"target": tp, "draft": weights["dp"]})
    return jt, t, jp, tp, jkw, pkw


@pytest.mark.parametrize("mode", list(MODES))
def test_programs_match_jax_keep_storage_and_read_no_host_value(weights, mode):
    """Two warm requests, then a 12-token stream joined mid-decode by four
    more (slot reuse, both buckets: monolithic and chunked admissions),
    ``pipeline_depth=2``: every request's tokens equal the JAX engine's;
    no state tensor (the token buffer included) nor per-bucket fresh
    cache changes storage after the first admission; no program reads
    the device on the host."""
    jt, t, jp, tp, jkw, pkw = _mode(weights, mode)
    warm = _prompts(3, (7, 20))              # one per bucket
    lead = _prompts(4, (20,))[0]
    joins = _prompts(5, (5, 30, 8, 13))
    engine = _no_host_reads(_graphed(DecodeEngine(
        Llama(t), device="cpu", registry=telemetry.MetricsRegistry(), **pkw)))
    try:
        got_warm = engine.generate(tp, warm, max_new_tokens=6)
        ptrs = _state_ptrs(engine)
        streamed, errors, first = [], [], threading.Event()

        def stream():
            try:
                for chunk in engine.generate_stream(tp, lead):
                    streamed.extend(chunk)
                    first.set()
            except BaseException as exc:
                errors.append(exc)
                first.set()

        th = threading.Thread(target=stream)
        th.start()
        assert first.wait(60)
        got = engine.generate(tp, joins, max_new_tokens=6)
        th.join(timeout=60)
        assert not th.is_alive() and not errors
        assert _state_ptrs(engine) == ptrs
        replays = sum(s["replays"] for s in engine._graphs.stats().values())
    finally:
        engine.close()
    jengine = JEngine(JLlama(jt), registry=jtelemetry.MetricsRegistry(), **jkw)
    try:
        want = jengine.generate(jp, warm + joins, max_new_tokens=6)
        want_lead = jengine.generate(jp, [lead])[0]
    finally:
        jengine.close()
    assert got_warm + got == want
    assert streamed == want_lead
    assert replays > 0


def test_preempted_stream_through_the_programs_matches_jax(weights):
    """A low-priority stream preempted by a high-priority request at a
    full pool (its blocks saved to the host store and spliced back into
    the static fresh cache on resume) gives the JAX engine's tokens."""
    jt, t, jp, tp = weights["jt"], weights["t"], weights["jtp"], weights["tp"]
    kw = dict(slots=2, max_new_tokens=24, prompt_buckets=(32,), chunk_steps=2,
              pipeline_depth=2, paged=True, kv_block_size=16, kv_pool_blocks=3)
    registry = telemetry.MetricsRegistry()
    engine = _graphed(DecodeEngine(
        Llama(t), device="cpu", registry=registry,
        prefix_cache=RadixPrefixCache(block_size=16, registry=registry), **kw))
    low_prompt, high_prompt = _prompts(0, (8, 8))
    low_out, started = [], threading.Event()
    try:
        def low():
            for chunk in engine.generate_stream(tp, low_prompt, priority="low"):
                low_out.extend(chunk)
                started.set()

        th = threading.Thread(target=low)
        th.start()
        assert started.wait(60)
        high = engine.generate(tp, [high_prompt], max_new_tokens=8, priority="high")[0]
        th.join(timeout=60)
        assert not th.is_alive()
        assert engine.stats()["scheduler"]["preemptions"] >= 1
        assert {k[0] for k in engine._graphs.keys()} >= {"engine.decode", "engine.prefill"}
    finally:
        engine.close()
    jkw = {k: v for k, v in kw.items() if k != "kv_pool_blocks"}
    jengine = JEngine(JLlama(jt), registry=jtelemetry.MetricsRegistry(),
                      prefix_cache=JRadixPrefixCache(block_size=16), **jkw)
    try:
        assert high == jengine.generate(jp, [high_prompt], max_new_tokens=8)[0]
        assert low_out == jengine.generate(jp, [low_prompt])[0]
    finally:
        jengine.close()


# --------------------------------------------------------------------- #
# (d) the program cache's bookkeeping
# --------------------------------------------------------------------- #


def _paged(weights, **kw):
    for key, value in dict(BASE, max_new_tokens=6, paged=True, kv_block_size=8).items():
        kw.setdefault(key, value)
    return DecodeEngine(Llama(weights["t"]), device="cpu",
                        registry=telemetry.MetricsRegistry(), **kw)


def test_program_cache_keys_replays_and_invalidation(weights):
    """One graph per signature (decode; each bucket's monolithic prefill;
    the chunked bucket's lead and final programs), the capture recorded as
    each signature's compile event and every replay as a call charged its
    cost with its launches credited; ``bind`` to other params drops every
    graph, ``_recover`` drops the graphs of the state it dropped (the next
    admission captures on the fresh state), ``close`` drops every graph
    and the pool."""
    tp = weights["tp"]
    stub = _Stub()
    engine = _graphed(_paged(weights), stub)
    try:
        prompts = _prompts(1, (5, 30, 7, 20))
        first = engine.generate(tp, prompts)
        keys = engine._graphs.keys()
        by_program = {}
        for key in keys:
            by_program.setdefault(key[0], []).append(key)
        assert set(by_program) == PROGRAMS
        assert len(by_program["engine.decode"]) == 1
        assert len(by_program["engine.prefill"]) == 1                # bucket 8
        assert len(by_program["engine.prefill_chunk"]) == 1          # bucket 32
        assert len(by_program["engine.prefill_final"]) == 1
        assert len(stub.captured) == len(keys) == len(set(keys))
        graphs = engine._graphs.stats()
        replays = sum(s["replays"] for s in graphs.values())
        assert stub.kernel.launches == replays > 0
        programs = engine.stats()["programs"]
        decode = programs["engine.decode"]
        assert decode["compiles"] == 1
        assert decode["calls"] == 1 + graphs["engine.decode"]["replays"]
        assert decode["flops_per_call"] > 0
        assert decode["flops_total"] == pytest.approx(decode["calls"] * decode["flops_per_call"])
        assert engine.stats()["graphs"]["engine.decode"]["graphs"] == 1

        # the same signatures replay: nothing new is captured
        assert engine.generate(tp, prompts) == first
        assert len(stub.captured) == len(keys)

        # a recovery drops the graphs of the dropped state, and the next
        # admission captures on the new one
        fi = FaultInjector()
        engine._faults = fi
        fi.arm("engine.dispatch", exc=RuntimeError("injected"))
        with pytest.raises(RuntimeError):
            engine.generate(tp, [prompts[0]])
        assert engine._state is None
        assert {k[0] for k in engine._graphs.keys()} == {"engine.prefill_chunk"}
        assert engine.generate(tp, prompts) == first
        assert len(engine._graphs) == len(keys)

        # other params: every graph goes, and with them the pool handle
        # (the allocator will not share a pool no live graph holds)
        pool = engine._graphs.pool
        engine.bind({k: v for k, v in tp.items()})
        assert len(engine._graphs) == 0 and engine._graphs.pool is None
        assert engine.generate(tp, prompts) == first
        assert engine._graphs.pool is not None and engine._graphs.pool is not pool
    finally:
        engine.close()
    assert len(engine._graphs) == 0 and engine._graphs.pool is None
    assert engine._fresh == {}


def test_launches_recorded_by_a_capture_stay_on_its_thread():
    """Launches inside a capture are recorded on the capturing thread
    alone: two threads capturing at once while two others launch the same
    kernel eagerly leave the kernel's count at the eager launches exactly,
    each record holds its own thread's launches, and replays from four
    threads at once credit exactly what the captures recorded."""
    kernel = _build.Kernel("none", "none", [])
    kernel._fn = lambda *args: 0     # a launch that reaches no library
    captures, eager, rounds = 2, 2, 300
    barrier = threading.Barrier(captures + eager)
    records = []

    def capture():
        barrier.wait()
        with _build.launches_recorded() as record:
            for _ in range(rounds):
                kernel()
        records.append(dict(record))

    def launch():
        barrier.wait()
        for _ in range(rounds):
            kernel()

    threads = ([threading.Thread(target=capture) for _ in range(captures)]
               + [threading.Thread(target=launch) for _ in range(eager)])
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernel.launches == eager * rounds
    assert records == [{kernel: rounds}] * captures

    graph = _graphs.Graph(_Rerun(lambda: None), None, None, records[0], (0.0, 0.0))
    kernel.launches = 0
    replays = [threading.Thread(target=lambda: [graph.replay() for _ in range(50)])
               for _ in range(4)]
    for t in replays:
        t.start()
    for t in replays:
        t.join()
    assert kernel.launches == 4 * 50 * rounds


def test_stale_rows_of_the_static_fresh_caches_are_never_read(weights):
    """Every admission of a bucket fills the same static fresh cache and
    nothing zeroes it: rows an admission does not write (past its true
    length) hold earlier rows and must never be read. Filled with large
    random values between two runs, the tokens stay the same (monolithic
    and chunked admissions)."""
    tp = weights["tp"]
    prompts = _prompts(8, (5, 20, 7, 11))
    engine = _graphed(_paged(weights))
    try:
        want = engine.generate(tp, prompts)
        gen = torch.Generator().manual_seed(0)
        with torch.inference_mode():
            for fresh in engine._fresh.values():
                for layer in fresh:
                    for buf in layer:
                        buf.copy_(100 * torch.randn(buf.shape, generator=gen))
        assert engine.generate(tp, prompts) == want
    finally:
        engine.close()


def test_closed_engine_drops_its_graphs_and_eager_seam(weights):
    """The private eager seam runs every program eagerly (no capture, the
    same tokens); ``close`` drops every graph with the state."""
    tp = weights["tp"]
    prompts = _prompts(2, (6, 9))
    stub = _Stub()
    engine = _graphed(_paged(weights), stub)
    try:
        engine._graphs.eager = True
        eager = engine.generate(tp, prompts)
        assert stub.captured == [] and len(engine._graphs) == 0
        engine._graphs.eager = False
        assert engine.generate(tp, prompts) == eager
        assert len(engine._graphs) > 0
    finally:
        engine.close()
    assert len(engine._graphs) == 0 and engine._state is None


def test_failed_first_capture_lets_its_pool_handle_go(weights):
    """A capture that fails fails its request naming the program, and
    when no graph is left it lets the pool handle go (the allocator will
    not share a pool that no live graph holds), so the next capture takes
    a new one and succeeds."""
    tp = weights["tp"]
    stub = _Stub()
    calls = []

    def capture(body, *args, **kwargs):
        calls.append(kwargs["pool"])
        if len(calls) == 1:
            raise RuntimeError("engine program 'engine.prefill' cannot be captured as a CUDA graph")
        return stub(body, *args, **kwargs)

    engine = _graphed(_paged(weights), capture)
    try:
        with pytest.raises(RuntimeError, match="engine.prefill"):
            engine.generate(tp, _prompts(5, (6,)))
        assert engine._graphs.pool is None and len(engine._graphs) == 0
        assert len(engine.generate(tp, _prompts(5, (6,)))[0]) > 0
        assert len(calls) > 1 and calls[1] is not calls[0] and len(engine._graphs) > 0
    finally:
        engine.close()


# --------------------------------------------------------------------- #
# sampling with the engine's generator
# --------------------------------------------------------------------- #


def test_sampling_registers_the_engine_generator_and_repeats_by_seed(weights):
    """A sampling engine hands its generator to every capture (a CUDA
    graph then draws fresh numbers at each replay); the same prompt sent
    again samples other tokens, and two engines of one seed sample the same
    ones, through the programs and eagerly alike."""
    tp = weights["tp"]
    prompt = _prompts(4, (6,))[0]

    def run(graphed, seed):
        seen = []

        def capture(body, device, what, *, generators=(), **kw):
            seen.append(generators)
            return _Stub()(body, device, what, generators=generators, **kw)

        engine = _paged(weights, temperature=1.0, seed=seed)
        if graphed:
            _graphed(engine, capture)
        try:
            out = [engine.generate(tp, [prompt])[0] for _ in range(2)]
            assert len(seen) == (2 if graphed else 0)   # decode, prefill
            assert all(g == (engine._gen,) for g in seen)
            return out
        finally:
            engine.close()

    a = run(True, 3)
    assert a[0] != a[1]
    assert a == run(True, 3) == run(False, 3)


# --------------------------------------------------------------------- #
# (e) C17: under nan_guard the engine runs its eager programs
# --------------------------------------------------------------------- #


def test_nan_guard_runs_the_eager_programs_c17(weights):
    """ROADMAP.md C17, a chosen divergence: a replayed graph cannot have
    its rows checked (a check reads the device on the host), and a donated
    chunk cannot be re-run as the captured predictor re-runs a call, so
    while a NaN guard is open the engine runs its eager programs — every
    row and op checked — and captures nothing; after it, the graphs serve
    again. The reference re-runs a de-optimized program instead."""
    tp = weights["tp"]
    prompts = _prompts(5, (6, 9))
    stub = _Stub()
    engine = _graphed(_paged(weights), stub)
    try:
        with nan_guard():
            assert not engine._graphs.active()
            guarded = engine.generate(tp, prompts)
        assert stub.captured == []
        assert engine._graphs.active()
        assert engine.generate(tp, prompts) == guarded
        assert stub.captured
    finally:
        engine.close()


def test_chip_smoke_programs_phase_rehearsal_on_cpu(weights):
    """chip_smoke.py's phase 5c at a tiny config: the paged engine eager
    through the private seam, then through the program cache (the capture
    stubbed): the same tokens and stream, the decode chunk replayed."""
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(repo))

    def make():
        return _graphed(DecodeEngine(
            Llama(weights["t"]), paged=True, slots=2, prompt_buckets=(8, 32), max_new_tokens=4,
            chunk_steps=2, device="cpu", registry=telemetry.MetricsRegistry()))

    out = chip_smoke.programs_phase("paged", make, weights["tp"], _prompts(6, (3, 20, 9)),
                                    _prompts(7, (12,))[0], {}, device="cpu")
    assert out["tokens_equal"] and out["launches_equal"]
    assert out["runs"]["replayed"]["graphs"]["engine.decode"]["replays"] > 0
    assert out["runs"]["eager"]["graphs"] == {}
