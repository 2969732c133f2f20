"""Disaggregated prefill/decode serving (docs/serving.md
"Disaggregated serving"): phase-split pools, the prefix-cache KV
handoff, cross-host transfer over /debug/kv/export ↔ /debug/kv/import,
degrade-never-error, per-pool operations — and THE chaos acceptance:
an engine-backed 1-prefill + 2-decode fleet over the stdlib transport
with the prefill replica killed between export and splice.

The PyTorch port's twin of the reference's ``tests/unit/test_disagg.py``: the same
cases against :mod:`unionml_tpu_torch` on the CPU. Cases with fake replicas
carry over as they are; the engine-backed ones run the port's
``DecodeEngine(device="cpu")`` on the JAX tiny Llama's weights
(``from_jax_params``, fp32 activations) and hold its tokens to the JAX
package's solo greedy generate, token for token.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.models.generate import make_generator as jmake_generator

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.models import Llama, LlamaConfig, from_jax_params
from unionml_tpu_torch.serving.autoscaler import (
    AutoscalerPolicy,
    FleetAutoscaler,
    ReplicaProvisioner,
)
from unionml_tpu_torch.serving.disagg import DisaggRouter
from unionml_tpu_torch.serving.engine import DecodeEngine as _DecodeEngine
from unionml_tpu_torch.serving.prefix_cache import (
    RadixPrefixCache,
    decode_entries,
    encode_entries,
)
from unionml_tpu_torch.serving.router import (
    EngineReplica,
    FleetRouter,
    HttpReplica,
    ReplicaHandle,
    RouterPolicy,
    make_router_app,
)
from unionml_tpu_torch.serving.scheduler import validate_phase

import torch_threads

torch_threads.share_cores()

pytestmark = pytest.mark.chaos

N_NEW = 12
BUCKET = 32


_JAX_TWIN = {}


@pytest.fixture(scope="module")
def tiny_llama():
    """The port's tiny Llama in fp32 activations and its weights, bridged
    from a JAX init (``from_jax_params``); the JAX pair is kept for
    :func:`_solo`."""
    kw = dict(vocab_size=97, dtype="float32")
    jmodule = JLlama(JConfig.tiny(**kw))
    jparams = jmodule.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    cfg = LlamaConfig.tiny(**kw)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    _JAX_TWIN[id(params)] = (jmodule, jparams)
    return Llama(cfg), params


def DecodeEngine(module, *args, **kw):
    """The port's engine on the CPU, every other knob as the reference
    test sets it."""
    kw.setdefault("device", "cpu")
    return _DecodeEngine(module, *args, **kw)


def _solo(module, params, prompt, n_new=N_NEW, max_len=128):
    """The JAX package's solo greedy generate, in fp32, on the JAX twin of
    the port's ``params``: the oracle each engine-backed case holds the
    port's tokens to, token for token. Pass ``max_len=engine.cache_len``
    when comparing against an engine, as the reference's oracle does."""
    jmodule, jparams = _JAX_TWIN[id(params)]
    gen = jmake_generator(jmodule, max_new_tokens=n_new, max_len=max_len)
    return np.asarray(gen(jparams, jnp.asarray([prompt], jnp.int32)))[0].tolist()


def _engine(module, reg, *, phase, cache=None, paged=False, **kw):
    if cache is None:
        cache = RadixPrefixCache(registry=reg)
    return DecodeEngine(
        module, slots=2, max_new_tokens=N_NEW, prompt_buckets=(BUCKET,),
        chunk_steps=4, prefix_cache=cache, phase=phase, registry=reg,
        paged=paged, **kw,
    )


def _disagg(replicas, reg=None, **kw):
    kw.setdefault("policy", RouterPolicy(
        health_ttl_s=0.0, backoff_base_s=0.0, jitter_s=0.0,
    ))
    kw.setdefault("registry", reg or telemetry.MetricsRegistry())
    kw.setdefault("flight", telemetry.FlightRecorder())
    return DisaggRouter(replicas, **kw)


def _collect(stream):
    return [t for chunk in stream for t in chunk]


def _walk_refcounts(cache):
    """Every node's live lease refcount — must be all-zero at rest."""
    bad = []
    stack = list(cache._root.children.values())
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        if node.refcount != 0:
            bad.append((node.depth, node.refcount))
    return bad


# ----------------------------------------------------------- vocabulary


def test_phase_vocabulary_and_construction(tiny_llama):
    module, params = tiny_llama
    assert validate_phase(None) == "colocated"
    assert validate_phase("PREFILL") == "prefill"
    with pytest.raises(ValueError, match="phase"):
        validate_phase("warmup")
    with pytest.raises(ValueError, match="phase"):
        DecodeEngine(module, prompt_buckets=(8,), phase="warmup")
    # a prefill-only fleet cannot serve streams
    class _P(ReplicaHandle):
        name, phase = "p", "prefill"
    with pytest.raises(ValueError, match="decode-capable"):
        DisaggRouter([_P()], registry=telemetry.MetricsRegistry(),
                     flight=telemetry.FlightRecorder())
    with pytest.raises(ValueError, match="handoff_min_tokens"):
        DisaggRouter(
            [_P(), type("_D", (ReplicaHandle,), {"name": "d",
                                                 "phase": "decode"})()],
            handoff_min_tokens=0, registry=telemetry.MetricsRegistry(),
            flight=telemetry.FlightRecorder(),
        )


def test_engine_phase_surfaces(tiny_llama):
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    eng = _engine(module, reg, phase="prefill")
    try:
        assert eng.health()["phase"] == "prefill"
        assert eng.stats()["phase"] == "prefill"
        assert eng.stats()["scheduler"]["phase"] == "prefill"
        # EngineReplica inherits the engine's declaration
        rep = EngineReplica(eng, params, name="r0")
        assert rep.phase == "prefill"
        # explicit wins
        assert EngineReplica(eng, params, name="r1",
                             phase="colocated").phase == "colocated"
    finally:
        eng.close()
    # a colocated engine keeps the historical health shape
    reg2 = telemetry.MetricsRegistry()
    eng2 = _engine(module, reg2, phase=None)
    try:
        assert "phase" not in eng2.health()
    finally:
        eng2.close()


# ------------------------------------------------------- prefill export


def test_prefill_export_handle_and_lease(tiny_llama):
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    eng = _engine(module, reg, phase="prefill")
    prompt = list(range(1, 21))  # 20 tokens -> one full 16-block
    try:
        solo = _solo(module, params, prompt, max_len=eng.cache_len)
        handle = eng.prefill_export(params, prompt)
        assert handle["tokens"] == [solo[0]]
        blk = eng.prefix_cache.block_size
        full = (len(prompt) // blk) * blk
        assert handle["cached_tokens"] == full
        # the exported path is resident AND pinned until release
        assert eng.prefix_cache.peek(prompt) == full
        assert _walk_refcounts(eng.prefix_cache), (
            "the handle's lease must pin the exported path"
        )
        handle["lease"].release()
        handle["lease"].release()  # idempotent
        assert _walk_refcounts(eng.prefix_cache) == []
        # kv_export serves the same blocks as importable entries
        entries = eng.kv_export(prompt)
        assert len(entries) == full // blk
    finally:
        eng.close()


def test_prefill_export_requires_cache(tiny_llama):
    module, params = tiny_llama
    eng = DecodeEngine(
        module, slots=2, max_new_tokens=N_NEW, prompt_buckets=(BUCKET,),
        chunk_steps=4, registry=telemetry.MetricsRegistry(),
    )
    try:
        with pytest.raises(ValueError, match="prefix cache"):
            eng.prefill_export(params, [1, 2, 3])
        with pytest.raises(ValueError, match="prefix cache"):
            eng.kv_export([1, 2, 3])
        with pytest.raises(ValueError, match="prefix cache"):
            eng.kv_import([])
    finally:
        eng.close()


# -------------------------------------------------- two-leg dispatch


def test_two_leg_shared_store_parity(tiny_llama):
    """Same-host pools over ONE host block store: the handoff is a
    pointer handoff (result=shared), the decode admission splices the
    prefill leg's blocks, tokens are bit-identical to solo, and both
    legs' spans land under one routing rid."""
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    rec = telemetry.TraceRecorder()
    flight = telemetry.FlightRecorder()
    shared = RadixPrefixCache(registry=reg)
    pre = _engine(module, reg, phase="prefill", cache=shared, tracer=rec,
                  flight=flight)
    dec = _engine(module, reg, phase="decode", cache=shared, tracer=rec,
                  flight=flight)
    router = _disagg(
        [EngineReplica(pre, params, name="p0"),
         EngineReplica(dec, params, name="d0")],
        reg=reg, tracer=rec, flight=flight,
    )
    prompt = list(range(1, 21))
    try:
        solo = _solo(module, params, prompt, max_len=dec.cache_len)
        out = _collect(router.generate_stream(prompt))
        assert out == solo
        # the prefill engine served the 1-token leg; the decode engine
        # spliced instead of re-prefilling
        assert pre.stats()["completed_requests"] == 1
        assert dec.stats()["prefix_cache"]["prefill_tokens_saved"] > 0
        snap = reg.snapshot()
        assert snap["unionml_disagg_handoffs_total"] == {
            "result=shared": 1.0
        }
        assert snap["unionml_disagg_requests_total"] == {
            "path=two_leg": 1.0
        }
        # both legs under ONE routing rid: handoff event names both
        # pools, and the stitched trace holds the three joining spans
        handoffs = flight.dump(kind="handoff")
        assert len(handoffs) == 1
        rid = handoffs[0]["rid"]
        assert handoffs[0]["phases"] == ["prefill", "decode"]
        trace_id = rec.find_trace_id(rid)
        doc = telemetry.stitched_trace(
            trace_id, rec.requests_for_trace(trace_id),
        )
        names = {s["name"] for s in doc["spans"]}
        assert {"prefill-leg", "handoff", "decode-leg"} <= names, names
        # the engine legs' own spans joined the same trace
        assert "prefill" in names
        # no leaked pins anywhere
        assert _walk_refcounts(shared) == []
        # blocking surface rides the same pipeline
        assert router.generate(prompt) == solo
    finally:
        pre.close()
        dec.close()


def test_short_prompt_stays_single_leg(tiny_llama):
    """Below handoff_min_tokens the prefill pool is bypassed entirely
    — colocated still wins for short prompts, and the decode pool
    (freed of long prefills) serves them directly."""
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    pre = _engine(module, reg, phase="prefill")
    dec = _engine(module, reg, phase="decode")
    router = _disagg(
        [EngineReplica(pre, params, name="p0"),
         EngineReplica(dec, params, name="d0")],
        reg=reg, handoff_min_tokens=16,
    )
    prompt = [1, 2, 3, 4, 5]
    try:
        assert _collect(router.generate_stream(prompt)) == _solo(
            module, params, prompt, max_len=dec.cache_len,
        )
        assert pre.stats()["completed_requests"] == 0
        assert dec.stats()["completed_requests"] == 1
        assert reg.snapshot()["unionml_disagg_requests_total"] == {
            "path=single_leg": 1.0
        }
    finally:
        pre.close()
        dec.close()


def test_cross_store_transfer_warms_decode(tiny_llama):
    """Distinct host stores (the cross-process shape): the prefill
    leg's blocks transfer into the decode replica's store before its
    dispatch, so the decode admission still splices instead of
    recomputing — and the transferred bytes are the same pointers
    in-process (no copy)."""
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    pre = _engine(module, reg, phase="prefill")
    dec = _engine(module, reg, phase="decode")
    router = _disagg(
        [EngineReplica(pre, params, name="p0"),
         EngineReplica(dec, params, name="d0")],
        reg=reg,
    )
    prompt = list(range(1, 21))
    try:
        assert _collect(router.generate_stream(prompt)) == _solo(
            module, params, prompt, max_len=dec.cache_len,
        )
        assert dec.stats()["prefix_cache"]["prefill_tokens_saved"] > 0
        snap = reg.snapshot()
        assert snap["unionml_disagg_handoffs_total"] == {
            "result=transfer": 1.0
        }
        assert snap["unionml_disagg_kv_blocks_transferred_total"][""] >= 1
        assert _walk_refcounts(pre.prefix_cache) == []
        assert _walk_refcounts(dec.prefix_cache) == []
    finally:
        pre.close()
        dec.close()


def test_transfer_disabled_decodes_cold(tiny_llama):
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    pre = _engine(module, reg, phase="prefill")
    dec = _engine(module, reg, phase="decode")
    router = _disagg(
        [EngineReplica(pre, params, name="p0"),
         EngineReplica(dec, params, name="d0")],
        reg=reg, transfer=False,
    )
    prompt = list(range(1, 21))
    try:
        assert _collect(router.generate_stream(prompt)) == _solo(
            module, params, prompt, max_len=dec.cache_len,
        )
        assert reg.snapshot()["unionml_disagg_handoffs_total"] == {
            "result=skipped": 1.0
        }
        # cold decode: the decode engine prefilled the prompt itself
        assert dec.stats()["prefix_cache"]["prefill_tokens_saved"] == 0
    finally:
        pre.close()
        dec.close()


def test_early_close_releases_the_handoff_lease(tiny_llama):
    """A caller abandoning the stream right after its TTFT chunk —
    GeneratorExit at the first yield, before the decode leg ever ran —
    must still release the prefill leg's lease (the code-review
    regression: the finally used to see only the post-loop handle)."""
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    shared = RadixPrefixCache(registry=reg)
    pre = _engine(module, reg, phase="prefill", cache=shared)
    dec = _engine(module, reg, phase="decode", cache=shared)
    router = _disagg(
        [EngineReplica(pre, params, name="p0"),
         EngineReplica(dec, params, name="d0")],
        reg=reg,
    )
    prompt = list(range(1, 21))
    try:
        stream = router.generate_stream(prompt)
        first = next(iter(stream))
        assert len(first) == 1
        stream.close()  # client disconnected after the TTFT token
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and _walk_refcounts(shared):
            time.sleep(0.02)
        assert _walk_refcounts(shared) == [], (
            "abandoning the stream after the prefill leg leaked the "
            "handoff lease"
        )
    finally:
        pre.close()
        dec.close()


def test_caller_faults_surface_instead_of_degrading(tiny_llama):
    """Deterministic caller faults (bad request, expired deadline)
    from the prefill leg must SURFACE — a second dispatch is doomed
    work wearing a 'degraded' label; only infra-class failures
    degrade (incl. a misconfigured cache-less prefill replica)."""
    from unionml_tpu_torch.serving.faults import DeadlineExceeded

    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    pre = _engine(module, reg, phase="prefill")
    dec = _engine(module, reg, phase="decode")
    router = _disagg(
        [EngineReplica(pre, params, name="p0"),
         EngineReplica(dec, params, name="d0")],
        reg=reg,
    )
    prompt = list(range(1, 21))
    try:
        p0 = router.replica_handle("p0")
        p0.prefill_export = lambda *a, **k: (_ for _ in ()).throw(
            DeadlineExceeded("expired while queued")
        )
        with pytest.raises(DeadlineExceeded):
            _collect(router.generate_stream(prompt))
        # the doomed decode dispatch never happened
        assert dec.stats()["completed_requests"] == 0
        snap = reg.snapshot()
        assert "path=degraded" not in snap.get(
            "unionml_disagg_requests_total", {}
        )
    finally:
        pre.close()
        dec.close()
    # a cache-less prefill replica is a POOL misconfiguration: the
    # EngineReplica hook speaks the infra vocabulary, so the request
    # degrades to a cold decode prefill instead of erroring
    reg2 = telemetry.MetricsRegistry()
    bare = DecodeEngine(
        module, slots=2, max_new_tokens=N_NEW, prompt_buckets=(BUCKET,),
        chunk_steps=4, registry=reg2, phase="prefill",
    )
    dec2 = _engine(module, reg2, phase="decode")
    router2 = _disagg(
        [EngineReplica(bare, params, name="p0"),
         EngineReplica(dec2, params, name="d0")],
        reg=reg2,
    )
    try:
        assert _collect(router2.generate_stream(prompt)) == _solo(
            module, params, prompt, max_len=dec2.cache_len,
        )
        assert reg2.snapshot()["unionml_disagg_requests_total"] == {
            "path=degraded": 1.0
        }
    finally:
        bare.close()
        dec2.close()


def test_dead_prefill_pool_degrades_not_errors(tiny_llama):
    """The prefill leg exhausting its whole retry envelope is NOT a
    caller-visible failure: the decode pool prefills cold, tokens
    identical."""
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    pre = _engine(module, reg, phase="prefill")
    dec = _engine(module, reg, phase="decode")
    router = _disagg(
        [EngineReplica(pre, params, name="p0"),
         EngineReplica(dec, params, name="d0")],
        reg=reg,
    )
    prompt = list(range(1, 21))
    try:
        router.replica_handle("p0").prefill_export = (
            lambda *a, **k: (_ for _ in ()).throw(
                RuntimeError("prefill replica dead")
            )
        )
        assert _collect(router.generate_stream(prompt)) == _solo(
            module, params, prompt, max_len=dec.cache_len,
        )
        snap = reg.snapshot()
        assert snap["unionml_disagg_requests_total"] == {
            "path=degraded": 1.0
        }
        degrade = [
            e for e in router._flight.dump(kind="handoff")
            if e.get("degraded")
        ]
        assert degrade and degrade[0]["result"] == "cold"
    finally:
        pre.close()
        dec.close()


def test_token_cap_rides_the_two_leg_pipeline(tiny_llama):
    """max_new_tokens caps BOTH legs consistently; a 1-token request
    is answered by the prefill leg alone."""
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    pre = _engine(module, reg, phase="prefill")
    dec = _engine(module, reg, phase="decode")
    router = _disagg(
        [EngineReplica(pre, params, name="p0"),
         EngineReplica(dec, params, name="d0")],
        reg=reg,
    )
    prompt = list(range(1, 21))
    try:
        solo = _solo(module, params, prompt, max_len=dec.cache_len)
        assert router.generate(prompt, max_new_tokens=3) == solo[:3]
        assert router.generate(prompt, max_new_tokens=1) == solo[:1]
        # the 1-token request never touched the decode pool
        assert dec.stats()["completed_requests"] == 1  # the 3-token one
    finally:
        pre.close()
        dec.close()


# --------------------------------------------- HTTP transport surfaces


def _lm_app(engine, params, module):
    """An engine-backed ServingApp with the full disagg wiring (the
    test_serving _lm_serving_app pattern + kv hooks)."""
    from unionml_tpu_torch import Dataset, Model
    from unionml_tpu_torch.model import ModelArtifact
    from unionml_tpu_torch.serving.http import ServingApp

    dataset = Dataset(name=f"d_{id(engine)}", targets=[])

    @dataset.reader
    def reader() -> list:
        return []

    lm = Model(name=f"m_{id(engine)}", init=lambda: params,
               dataset=dataset)

    @lm.trainer
    def trainer(p: dict, features: list) -> dict:
        return p

    @lm.predictor
    def predictor(p: dict, prompts: list) -> list:
        return engine.generate(p, prompts)

    lm.artifact = ModelArtifact(params, {}, {})
    return ServingApp(
        lm,
        stats=engine.stats, health=engine.health, drain=engine.drain,
        stream=lambda p, prompts: engine.generate_stream(p, prompts[0]),
        cache_peek=engine.prefix_cache.peek,
        kv_export=engine.kv_export, kv_import=engine.kv_import,
        registry=engine.registry, tracer=engine.tracer,
        flight=engine.flight,
    )


def test_max_new_tokens_survives_the_http_hop(tiny_llama):
    """Satellite contract: the cap rides the /predict payload on the
    stdlib transport and HttpReplica forwards it — remote responses
    honor the caller's cap exactly (token parity with the solo
    prefix)."""
    httpx = pytest.importorskip("httpx")
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    eng = _engine(module, reg, phase=None, tracer=telemetry.TraceRecorder(),
                  flight=telemetry.FlightRecorder())
    app = _lm_app(eng, params, module)
    host, port = app.serve(port=0, blocking=False)
    base = f"http://{host}:{port}"
    prompt = list(range(1, 9))
    try:
        solo = _solo(module, params, prompt, max_len=eng.cache_len)
        remote = HttpReplica(base, name="r")
        assert remote.generate(prompt, max_new_tokens=3) == solo[:3]
        assert _collect(
            remote.generate_stream(prompt, max_new_tokens=5)
        ) == solo[:5]
        # raw payload field on both routes
        resp = httpx.post(
            f"{base}/predict",
            json={"features": [prompt], "max_new_tokens": 4}, timeout=120,
        )
        assert resp.status_code == 200 and resp.json() == [solo[:4]]
        # the PUBLIC predict_stream surface honors the cap standalone
        # (its wrapper covers the lazy generator's first pull — the
        # code-review regression: the old scope closed before the
        # engine body ever ran)
        out = _collect(app.predict_stream(
            {"features": prompt, "max_new_tokens": 3}
        ))
        assert out == solo[:3], out
        # garbage caps answer 422 at the boundary
        for bad in ("nope", 0, -3, 1.5, True):
            resp = httpx.post(
                f"{base}/predict",
                json={"features": [prompt], "max_new_tokens": bad},
                timeout=30,
            )
            assert resp.status_code == 422, (bad, resp.status_code)
    finally:
        app.shutdown()
        eng.close()


def test_kv_export_import_http_roundtrip(tiny_llama):
    """The cross-host handoff wire: blocks exported from host A over
    POST /debug/kv/export import into host B over POST
    /debug/kv/import, numerically identical, after which B's peek
    covers the prompt; unwired apps answer 422."""
    httpx = pytest.importorskip("httpx")
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    a = _engine(module, reg, phase="prefill",
                tracer=telemetry.TraceRecorder(),
                flight=telemetry.FlightRecorder())
    b = _engine(module, reg, phase="decode",
                tracer=telemetry.TraceRecorder(),
                flight=telemetry.FlightRecorder())
    app_a = _lm_app(a, params, module)
    app_b = _lm_app(b, params, module)
    ha, pa = app_a.serve(port=0, blocking=False)
    hb, pb = app_b.serve(port=0, blocking=False)
    prompt = list(range(1, 21))
    try:
        a.prefill_export(params, prompt)["lease"].release()
        ra = HttpReplica(f"http://{ha}:{pa}", name="a", phase="prefill")
        rb = HttpReplica(f"http://{hb}:{pb}", name="b", phase="decode")
        entries = ra.export_request_blocks(prompt)
        assert entries, "export must cover the prefilled prompt"
        # wire codec round-trips bit-exactly (bf16 KV included)
        for orig, back in zip(
            a.kv_export(prompt), decode_entries(encode_entries(entries)),
        ):
            assert np.array_equal(orig["tokens"], back["tokens"])
            for lo, lb in zip(orig["rows"], back["rows"]):
                for bo, bb in zip(lo, lb):
                    # torch rows (bf16 has no numpy dtype): same dtype, same bits
                    assert bo.dtype == bb.dtype
                    assert torch.equal(bo, bb)
        attached = rb.import_cache_blocks(entries)
        assert attached == len(entries)
        blk = b.prefix_cache.block_size
        assert b.prefix_cache.peek(
            a._canonical_row(prompt)
        ) == (len(prompt) // blk) * blk
        # unwired surfaces: 422, not 500
        resp = httpx.post(
            f"http://{ha}:{pa}/debug/kv/export", json={"prompt": []},
            timeout=30,
        )
        assert resp.status_code == 422
        resp = httpx.post(
            f"http://{ha}:{pa}/debug/kv/import", json={"entries": "x"},
            timeout=30,
        )
        assert resp.status_code == 422
    finally:
        app_a.shutdown()
        app_b.shutdown()
        a.close()
        b.close()


# --------------------------------------------- per-pool fleet surfaces


def test_fleet_report_and_flight_carry_phase(tiny_llama):
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    pre = _engine(module, reg, phase="prefill")
    dec = _engine(module, reg, phase="decode")
    router = _disagg(
        [EngineReplica(pre, params, name="p0"),
         EngineReplica(dec, params, name="d0")],
        reg=reg,
    )
    app = make_router_app(router, registry=reg)
    prompt = list(range(1, 21))
    try:
        _collect(router.generate_stream(prompt))
        report = app.debug_fleet()
        assert report["replicas"]["p0"]["phase"] == "prefill"
        assert report["replicas"]["d0"]["phase"] == "decode"
        assert report["phases"]["prefill"]["replicas"] == 1
        assert report["phases"]["decode"]["routable"] == 1
        # pool gauges track membership
        snap = reg.snapshot()
        assert snap["unionml_disagg_pool_replicas"]["phase=prefill"] == 1.0
        assert snap["unionml_disagg_pool_replicas"]["phase=decode"] == 1.0
        # /debug/flight?phase= isolates one pool; handoff matches both
        body = app.debug_flight(phase="prefill")
        kinds = {e["kind"] for e in body["events"]}
        assert "handoff" in kinds
        assert all(
            e.get("phase") == "prefill"
            or "prefill" in e.get("phases", ())
            for e in body["events"]
        )
        decode_body = app.debug_flight(phase="decode")
        assert any(
            e["kind"] == "prefill" and e.get("phase") == "decode"
            for e in decode_body["events"]
        ), "the decode engine's lifecycle events carry its pool tag"
    finally:
        pre.close()
        dec.close()


def test_usage_vector_splits_by_phase(tiny_llama):
    module, params = tiny_llama
    reg = telemetry.MetricsRegistry()
    eng = _engine(module, reg, phase="decode", usage=True)
    try:
        eng.generate(params, [[1, 2, 3, 4]], tenant="acme")
        vec = eng.usage.report()["tenants"]["acme"]
        assert vec["requests_by_phase"] == {"decode": 1}
    finally:
        eng.close()


class _PoolStub(ReplicaHandle):
    def __init__(self, name, phase, queue_depth=0, blocks=0):
        self.name = name
        self.phase = phase
        self._qd = queue_depth
        self._blocks = blocks

    def health(self):
        return {"status": "ok", "queue_depth": self._qd}

    def cache_blocks(self):
        return self._blocks


class _StubProvisioner(ReplicaProvisioner):
    def __init__(self):
        self.provisioned = []
        self.released = []

    def provision(self, name):
        handle = _PoolStub(name, "colocated")
        self.provisioned.append(handle)
        return handle

    def release(self, handle):
        self.released.append(handle.name)


def test_autoscaler_scales_one_pool(tiny_llama):
    """FleetAutoscaler(phase=...) observes its pool (shared colocated
    members included — they serve either leg), acts only on owned
    exact-phase members: repair counts pool capacity, the joiner is
    stamped with the pool's phase, scale-in victims never cross pools
    or drain shared colocated replicas, and both pool autoscalers
    register on the router for the dashboard."""
    clock_t = [1000.0]
    router = FleetRouter(
        [_PoolStub("p0", "prefill", blocks=0),
         _PoolStub("c0", "colocated", blocks=0),  # coldest of all
         _PoolStub("d0", "decode", blocks=5),
         _PoolStub("d1", "decode", blocks=9)],
        policy=RouterPolicy(health_ttl_s=0.0, min_live=1),
        registry=telemetry.MetricsRegistry(),
        flight=telemetry.FlightRecorder(),
        clock=lambda: clock_t[0],
    )
    prov = _StubProvisioner()
    reg = telemetry.MetricsRegistry()
    auto_d = FleetAutoscaler(
        router, prov,
        policy=AutoscalerPolicy(min_replicas=4, max_replicas=5,
                                cooldown_in_s=0.0),
        registry=reg, flight=telemetry.FlightRecorder(),
        clock=lambda: clock_t[0], phase="decode",
    )
    auto_p = FleetAutoscaler(
        router, prov,
        # floor 2: the pool's capacity INCLUDES the shared colocated
        # member, so p0 + c0 sits exactly at the floor — steady
        policy=AutoscalerPolicy(min_replicas=2, max_replicas=3),
        registry=reg, flight=telemetry.FlightRecorder(),
        clock=lambda: clock_t[0], phase="prefill",
    )
    # pool registration: both visible for the dashboard
    assert set(router.autoscalers) == {"prefill", "decode"}
    # the decode pool counts d0 + d1 + the shared c0 = 3 < 4: repair —
    # and the joiner is phase-stamped + pool-named
    out = auto_d.evaluate()
    assert (out["decision"], out["reason"]) == ("scale_out", "below_min")
    assert out["live"] == 3  # colocated capacity observed
    joiner = router.members()[out["replica"]]
    assert joiner.phase == "decode"
    assert out["replica"].startswith("auto-decode-")
    # the prefill pool reads its OWN capacity (p0 + shared c0): steady
    out = auto_p.evaluate()
    assert (out["decision"], out["reason"]) == ("scale_hold", "steady")
    assert auto_p.dashboard()["phase"] == "prefill"
    # decode scale-in (idle: no ledger, empty queues) drains the
    # coldest OWNED decode replica — never p0, and never the shared
    # colocated c0 even though it is the globally coldest cache
    auto_d.policy.min_replicas = 2  # the repaired pool (4) has surplus
    clock_t[0] += 1.0
    out = auto_d.evaluate()
    assert (out["decision"], out["reason"]) == ("scale_in", "idle")
    assert out["replica"] not in ("p0", "c0")
    assert "p0" in router.members() and "c0" in router.members()
    # a pool whose only drainable capacity is SHARED colocated holds
    # with no_pool_victim instead of stealing it from the peer pool
    router2 = FleetRouter(
        [_PoolStub("c0", "colocated"), _PoolStub("c1", "colocated")],
        policy=RouterPolicy(health_ttl_s=0.0, min_live=1),
        registry=telemetry.MetricsRegistry(),
        flight=telemetry.FlightRecorder(),
        clock=lambda: clock_t[0],
    )
    auto2 = FleetAutoscaler(
        router2, _StubProvisioner(),
        policy=AutoscalerPolicy(min_replicas=1, max_replicas=2,
                                cooldown_in_s=0.0),
        registry=telemetry.MetricsRegistry(),
        flight=telemetry.FlightRecorder(),
        clock=lambda: clock_t[0], phase="prefill",
    )
    out = auto2.evaluate()
    assert (out["decision"], out["reason"]) == (
        "scale_hold", "no_pool_victim",
    )
    assert set(router2.members()) == {"c0", "c1"}


# ------------------------------------------------- THE chaos acceptance


class _KillAfterExport(HttpReplica):
    """The deterministic chaos window: the prefill replica dies AFTER
    its prefill leg exported (the handle exists, the KV sits in the
    dead process's store) and BEFORE the decode leg splices."""

    def __init__(self, *args, kill=None, kill_on_call=1, **kwargs):
        super().__init__(*args, **kwargs)
        self._kill = kill
        self._calls = 0
        self._kill_on_call = kill_on_call

    def prefill_export(self, prompt, *, max_new_tokens=None):
        handle = super().prefill_export(
            prompt, max_new_tokens=max_new_tokens,
        )
        self._calls += 1
        if self._calls == self._kill_on_call and self._kill is not None:
            kill, self._kill = self._kill, None
            kill()  # between export and splice
        return handle


def test_disagg_chaos_prefill_killed_between_export_and_splice(tiny_llama):
    """THE acceptance (ISSUE 15): engine-backed 1-prefill + 2-decode
    fleet over the stdlib transport; the prefill replica is OOM-killed
    between one request's KV export and its decode-side splice. Zero
    caller-visible failures, every completion bit-identical to the
    colocated solo oracle, no leaked PrefixLease refcounts or pool
    blocks, and GET /debug/trace?rid= stitches both legs under one
    trace."""
    httpx = pytest.importorskip("httpx")
    from unionml_tpu_torch.serving.faults import FaultInjector, xla_oom_error

    module, params = tiny_llama
    fi = FaultInjector()
    engines, apps, bases = [], [], []
    for i, phase in enumerate(["prefill", "decode", "decode"]):
        reg = telemetry.MetricsRegistry()
        eng = _engine(
            module, reg, phase=phase, paged=True,
            tracer=telemetry.TraceRecorder(),
            flight=telemetry.FlightRecorder(),
            **({"fault_injector": fi} if phase == "prefill" else {}),
        )
        app = _lm_app(eng, params, module)
        host, port = app.serve(port=0, blocking=False)
        engines.append(eng)
        apps.append(app)
        bases.append(f"http://{host}:{port}")
    pre = engines[0]

    def kill_prefill():
        # OOM-poison the prefill engine's next device dispatch and take
        # the whole process off the network — the dead-process shape
        # the fleet tier is built for
        fi.arm("engine.prefill", exc=xla_oom_error())
        apps[0].shutdown()

    replicas = [
        _KillAfterExport(bases[0], name="p0", phase="prefill",
                         kill=kill_prefill, kill_on_call=2,
                         obs_timeout_s=2.0),
        HttpReplica(bases[1], name="d0", phase="decode"),
        HttpReplica(bases[2], name="d1", phase="decode"),
    ]
    router = _disagg(replicas, policy=RouterPolicy(
        health_ttl_s=0.0, backoff_base_s=0.001, jitter_s=0.0,
    ))
    front = make_router_app(router, registry=router._registry)
    fhost, fport = front.serve(port=0, blocking=False)
    fbase = f"http://{fhost}:{fport}"

    rng = np.random.default_rng(7)
    prompts = [
        rng.integers(1, 97, 20).tolist() for _ in range(6)
    ]
    try:
        solo = {
            tuple(p): _solo(
                module, params, p, max_len=engines[0].cache_len,
            ) for p in prompts
        }

        def sse(prompt):
            out, rid = [], None
            with httpx.stream(
                "POST", f"{fbase}/predict/stream",
                json={"features": prompt}, timeout=240,
            ) as resp:
                assert resp.status_code == 200
                rid = resp.headers.get("x-request-id")
                for line in resp.iter_lines():
                    if line.startswith("data: "):
                        import json as _json

                        event = _json.loads(line[len("data: "):])
                        if not event.get("done"):
                            out.extend(event["tokens"])
            return out, rid

        # request 0: the full cross-host path works (export → wire →
        # import → splice) BEFORE the kill
        out0, _ = sse(prompts[0])
        assert out0 == solo[tuple(prompts[0])]
        handoffs = router._flight.dump(kind="handoff")
        assert handoffs and handoffs[-1]["result"] == "transfer"

        # request 1: the prefill replica dies between export and
        # splice — the transfer fails against the dead host, the
        # decode leg prefills cold, the caller sees nothing
        kill_rid = None
        out1, kill_rid = sse(prompts[1])
        assert out1 == solo[tuple(prompts[1])]
        handoffs = router._flight.dump(kind="handoff")
        assert handoffs[-1]["result"] == "cold"

        # the rest of the flood (concurrent): prefill pool is gone —
        # requests degrade to the decode pool, ZERO failures
        results, failures, lock = [], [], threading.Lock()

        def client(ps):
            for p in ps:
                try:
                    out, _ = sse(p)
                    with lock:
                        results.append((tuple(p), out))
                except BaseException as exc:
                    with lock:
                        failures.append(f"{type(exc).__name__}: {exc}")

        threads = [
            threading.Thread(target=client, args=(prompts[2:][i::2],))
            for i in range(2)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads), "clients hung"
        assert not failures, failures
        assert all(out == solo[key] for key, out in results), (
            "token parity lost after the prefill-pool death"
        )

        # stitched trace: the killed-window request's BOTH legs under
        # one trace — prefill-leg (served by p0 before it died),
        # handoff, decode-leg, with attempts on both pools
        doc = httpx.get(
            f"{fbase}/debug/trace?rid={kill_rid}", timeout=30,
        ).json()
        names = {s["name"] for s in doc["spans"]}
        assert {"prefill-leg", "handoff", "decode-leg"} <= names, names
        attempt_replicas = {
            s.get("replica")
            for s in doc["spans"] if s["name"] == "attempt"
        }
        assert "p0" in attempt_replicas
        assert attempt_replicas & {"d0", "d1"}
        assert doc["trace_id"]

        # resource hygiene on the survivors: no leaked lease refcounts,
        # every pool block back
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            stats = [e.kv_pool.stats() for e in engines[1:]]
            if all(
                s["blocks_in_use"] == 0 and s["blocks_reserved"] == 0
                for s in stats
            ):
                break
            time.sleep(0.05)
        for eng in engines[1:]:
            s = eng.kv_pool.stats()
            assert s["blocks_in_use"] == 0, s
            assert s["blocks_reserved"] == 0, s
            assert _walk_refcounts(eng.prefix_cache) == [], eng.instance
        # the kill actually fired as an OOM arm + dead process
        assert router._flight.dump(kind="handoff")
    finally:
        front.shutdown()
        for app in apps[1:]:
            app.shutdown()
        for eng in engines:
            eng.close()
