"""The port's serving front and spec core against the JAX package's, and
the port's package rules, on the CPU.

The ported llm_serving template (flash prefill, fused norm, int8
weights) behind ``ServingApp`` must answer ``/predict`` with the same
tokens as the JAX package's app on the same weights (fp32, where no
near-tie flips).
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import unionml_tpu
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.models.generate import make_lm_predictor as jmake_lm_predictor
from unionml_tpu.models.generate import serving_params as jserving_params
from unionml_tpu.models.quantization import LLAMA_QUANT_PATTERNS as JPATTERNS
from unionml_tpu.models.quantization import quantize_params as jquantize
from unionml_tpu.serving.http import ServingApp as JServingApp

import unionml_tpu_torch
from unionml_tpu_torch import ModelArtifact
from unionml_tpu_torch import telemetry
from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.models import Llama, LlamaConfig, from_jax_params, init_params
from unionml_tpu_torch.serving import DecodeEngine, MicroBatcher
from unionml_tpu_torch.serving.http import ServingApp
from unionml_tpu_torch.templates.llm_serving import app as template

REPO = Path(__file__).resolve().parents[1]
VOCAB = 97
KNOBS = dict(prefill_impl="flash", norm_impl="fused", quantized=True)
GEN = dict(max_new_tokens=5, bucket_lens=(8, 16, 32))


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _jax_app_model(params):
    """The JAX package's llm_serving template, at the test's config."""
    jcfg = JConfig.tiny(vocab_size=VOCAB, dtype="float32", **KNOBS)
    dataset = unionml_tpu.Dataset(name="jax_llm_dataset")

    @dataset.reader
    def reader() -> list:
        return [[1, 2, 3]]

    @dataset.feature_loader
    def feature_loader(raw: list) -> list:
        return raw

    model = unionml_tpu.Model(name="jax_llm", dataset=dataset)

    @model.init
    def init(hyperparameters: dict) -> dict:
        return params

    @model.trainer
    def trainer(params: dict, features: list, targets: list) -> dict:
        return params

    generate = jmake_lm_predictor(JLlama(jcfg), **GEN)

    @model.predictor
    def predictor(params: dict, prompts: list) -> list:
        return generate(params, prompts)

    model.train()
    return model


@pytest.fixture(scope="module")
def served_params():
    jcfg = JConfig.tiny(vocab_size=VOCAB, dtype="float32")
    params = JLlama(jcfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    return jserving_params(jquantize(params, JPATTERNS), dtype=jnp.float32)


@pytest.fixture
def port_app_model(served_params):
    cfg = LlamaConfig.tiny(vocab_size=VOCAB, dtype="float32", **KNOBS)
    model = template.build_model(cfg, name="port_llm", **GEN)
    tree = jax.tree_util.tree_map(np.asarray, served_params)
    model.artifact = ModelArtifact(from_jax_params(tree, cfg, device="cpu"))
    return model


def test_template_serving_app_matches_jax_app(served_params, port_app_model):
    requests = [
        [[1, 5, 9], [2, 4, 6, 8]],
        [list(range(3, 23))],
        [[7], list(np.random.default_rng(0).integers(1, VOCAB, size=40).tolist()), [3, 3]],
    ]
    replies = []
    for app in (
        JServingApp(_jax_app_model(served_params), batch=True, row_lists=True),
        ServingApp(port_app_model, batch=True, row_lists=True),
    ):
        host, port = app.serve(port=0, blocking=False)
        try:
            out = [_post(f"http://{host}:{port}", "/predict", {"features": r}) for r in requests]
        finally:
            app.shutdown()
        assert all(status == 200 for status, _ in out)
        replies.append([body for _, body in out])
    jax_replies, port_replies = replies
    assert port_replies == jax_replies
    assert [len(r) for r in port_replies] == [2, 1, 3]
    assert all(len(toks) == GEN["max_new_tokens"] for r in port_replies for toks in r)


def test_serving_app_routes(port_app_model):
    app = port_app_model.serve(batch=True, row_lists=True)
    host, port = app.serve(port=0, blocking=False)
    base = f"http://{host}:{port}"
    try:
        status, body = _get(base, "/health")
        assert status == 200 and json.loads(body)["status"] == "ok"
        status, body = _get(base, "/metrics")
        assert status == 200 and "unionml_tpu_torch_build_info" in body
        assert f'torch_version="{torch.__version__}"' in body
        status, body = _get(base, "/stats")
        assert status == 200 and json.loads(body)["engine"] == "micro-batch"
        # introspection routes answer; the KV handoff routes are unwired
        # on a micro-batch app: 422
        status, body = _get(base, "/debug/memory")
        assert status == 200 and json.loads(body)["live_tensors"]["count"] > 0
        status, body = _post(base, "/debug/profile", {"seconds": 0.05})
        assert status == 200 and body["file_count"] >= 1
        assert _post(base, "/debug/profile", {"seconds": -1})[0] == 422
        assert _post(base, "/debug/kv/export", {"prompt": [1, 2]})[0] == 422
        assert _post(base, "/debug/kv/import", {"entries": []})[0] == 422
        status, body = _post(base, "/predict", {"features": [[4, 5]], "max_new_tokens": 2})
        assert status == 422
    finally:
        app.shutdown()


def test_template_trains_saves_and_loads_on_cpu(tmp_path):
    """The template's own init (random weights on the CPU, int8, serving
    cast) and the state-dict saver/loader round trip."""
    cfg = LlamaConfig.tiny(vocab_size=VOCAB, **KNOBS)
    model = template.build_model(cfg, name="roundtrip", **GEN)
    params, _ = model.train(hyperparameters={"device": "cpu", "seed": 3})
    q = params["block_0"]["attn"]["q"]
    assert q["kernel_q"].dtype == torch.int8 and q["scale"].dtype == torch.float32
    assert params["embed"]["embedding"].dtype == torch.bfloat16
    out = model.predict(features=[[1, 5, 9], [2, 4, 6, 8]])
    assert np.asarray(out).shape == (2, GEN["max_new_tokens"])
    path = tmp_path / "model.pt"
    model.save(str(path))
    fresh = template.build_model(cfg, name="roundtrip", **GEN)
    fresh.load(str(path))
    assert fresh.predict(features=[[1, 5, 9], [2, 4, 6, 8]]) == out


def test_port_imports_neither_jax_nor_reference():
    """Every module of unionml_tpu_torch imports without JAX, the JAX
    package or ``ml_dtypes`` (bf16 host rows are torch tensors; checked in
    a fresh interpreter), the prefix cache, the feed, goodput, checkpoint,
    elastic, LoRA, MLP and BERT modules, the templates' scaffolded tests
    the fleet tier (SLO watchdog, OTLP exporter, mode chooser, router,
    autoscaler, disaggregation) and the deployment front (FastAPI seam,
    serverless handlers and template, rollouts, the remote backend and
    its runner, the CLI) and the parallelism layer (mesh, collectives,
    sharding, sharded checkpoints) among them. ``fastapi`` and ``yaml`` stay
    unimported: the modules import them only where they are used."""
    code = (
        "import importlib, pathlib, sys\n"
        "root = pathlib.Path('unionml_tpu_torch')\n"
        "mods = sorted('.'.join(p.with_suffix('').parts) for p in root.rglob('*.py'))\n"
        "mods = [m[: -len('.__init__')] if m.endswith('.__init__') else m for m in mods]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "for new in ('serving.prefix_cache', 'elastic', 'goodput', 'checkpoint',\n"
        "            'checkpoint.async_writer', 'checkpoint.pytree_io', 'checkpoint._metrics',\n"
        "            'data.native', 'data.pipeline', 'models.lora', 'models.mlp',\n"
        "            'models.bert', 'templates.basic.app', 'templates.basic_tpu.app',\n"
        "            'templates.basic.tests.test_app', 'templates.basic_tpu.tests.test_app',\n"
        "            'templates.llm_serving.tests.test_app',\n"
        "            'templates.vision_tpu.tests.test_app', 'slo', 'exporters',\n"
        "            'serving.auto', 'serving.router', 'serving.autoscaler',\n"
        "            'serving.disagg', 'serving.fastapi', 'serving.serverless',\n"
        "            'serving.rollout', 'remote', 'remote.artifacts', 'remote.backend',\n"
        "            'remote.packaging', 'remote.runner', 'cli',\n"
        "            'templates.serverless.app', 'templates.serverless.tests.test_app',\n"
        "            'parallel', 'parallel.mesh', 'parallel.compat', 'parallel.collectives',\n"
        "            'parallel.sharding', 'checkpoint.sharded'):\n"
        "    assert 'unionml_tpu_torch.' + new in mods, (new, mods)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'flax' or m == 'unionml_tpu' or m.startswith('unionml_tpu.')\n"
        "             or m == 'ml_dtypes' or m.startswith('ml_dtypes.')\n"
        "             or m.split('.')[0] in ('orbax', 'msgpack', 'fastapi', 'yaml'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert int(res.stdout.strip().splitlines()[-1]) >= 35


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, served_params):
    """Without a CUDA device, an entry point called without ``device``
    raises instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny(vocab_size=VOCAB, **KNOBS)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params(jax.tree_util.tree_map(np.asarray, served_params), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        template.build_model(cfg, name="no_card", **GEN).train()
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(Llama(cfg), slots=1, max_new_tokens=2, prompt_buckets=(8,))
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(Llama(cfg), paged=True, slots=1, max_new_tokens=2, prompt_buckets=(8,))


def test_unported_model_paths_raise():
    model = template.build_model(name="unported")
    with pytest.raises(NotImplementedError):
        model.predictor(lambda params, prompts: prompts, jit=True)
    with pytest.raises(NotImplementedError):
        LlamaConfig.tiny(num_experts=2)


def test_model_remote_configures_a_backend(tmp_path, monkeypatch):
    """``Model.remote`` configures the port's backend (lazily built, the
    local sandbox without a config file)."""
    from unionml_tpu_torch.remote import LocalBackend

    monkeypatch.setenv("UNIONML_TPU_HOME", str(tmp_path))
    model = template.build_model(name="remote_cfg")
    assert model.remote(project="p") is None
    backend = model._remote
    assert isinstance(backend, LocalBackend) and model._remote is backend
    assert (backend.project, backend.domain, backend.root) == ("p", "development", tmp_path)


def test_model_serve_with_an_app_raises_as_the_reference():
    """``Model.serve(app=...)`` goes through the FastAPI seam and raises
    what the JAX package's ``serving_app`` raises for the same argument
    (``ImportError`` without fastapi, ``TypeError`` for a non-FastAPI app
    with it)."""
    from unionml_tpu.serving.fastapi import serving_app as jserving_app

    model = template.build_model(name="serve_app")
    with pytest.raises(Exception) as want:
        jserving_app(model, object(), core=object())
    with pytest.raises(type(want.value)):
        model.serve(app=object())
    if importlib.util.find_spec("fastapi") is None:
        assert want.type is ImportError


def test_batcher_array_mode_coalesces_trees():
    """Array-mode requests (dicts of arrays) coalesce, pad and split with
    the port's own tree helpers."""
    calls = []

    def predict(features):
        calls.append(features["x"].shape[0])
        return {"y": features["x"] * 2, "n": features["x"].sum(axis=1)}

    batcher = MicroBatcher(predict, max_batch_size=8, max_wait_ms=1.0, buckets=(4, 8))
    try:
        out = batcher.submit({"x": np.arange(6).reshape(3, 2)}, timeout=30)
    finally:
        batcher.close()
    np.testing.assert_array_equal(out["y"], np.arange(6).reshape(3, 2) * 2)
    np.testing.assert_array_equal(out["n"], [1, 5, 9])
    assert calls == [4]


def test_build_info_reports_torch():
    reg = telemetry.MetricsRegistry()
    telemetry.publish_process_metrics(reg)
    text = reg.exposition()
    assert "unionml_tpu_torch_build_info" in text and "jax_version" not in text
    assert unionml_tpu_torch.__version__ in text


def test_chip_smoke_serve_phase_rehearsal_on_cpu():
    """chip_smoke.py's main-path phase at a tiny config on the CPU (the
    kernels' plain versions), as the script drives it on the card."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=VOCAB), max_len=128)
    out = chip_smoke.serve_phase(
        cfg, 4, device="cpu", buckets=(8, 16, 32), lengths=(3, 7, 20, 30, 5)
    )
    assert out["requests"] == 5 and out["logit_cosine"] > chip_smoke.LOGIT_COSINE_MIN


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """Alone in a directory (and here, without a card) the script exits
    non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
