"""The port's serverless adapters on the CPU: the twin of every case of the
JAX package's ``tests/unit/test_serverless.py`` (synthetic API-Gateway and
S3 events invoked directly as functions, object I/O against a local
store), then the same gateway and object events through both packages'
handlers over a tiny Llama with bridged weights: equal tokens, and equal
status codes and headers apart from ids and timings.
"""

import json

import numpy as np
import pandas as pd
import pytest

import jax
import jax.numpy as jnp

import unionml_tpu
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.models.generate import make_lm_predictor as jmake_lm_predictor
from unionml_tpu.models.generate import serving_params as jserving_params
from unionml_tpu.models.quantization import LLAMA_QUANT_PATTERNS as JPATTERNS
from unionml_tpu.models.quantization import quantize_params as jquantize
from unionml_tpu.serving import serverless as jserverless

from unionml_tpu_torch import Dataset, Model, ModelArtifact
from unionml_tpu_torch.models import LlamaConfig, from_jax_params
from unionml_tpu_torch.serving.serverless import (
    LocalObjectStore,
    gateway_handler,
    object_event_handler,
)
from unionml_tpu_torch.templates.llm_serving import app as template

pytestmark = pytest.mark.quick


@pytest.fixture
def dataset():
    rng = np.random.default_rng(42)
    data = pd.DataFrame({"x": rng.normal(size=100), "x2": rng.normal(size=100),
                         "y": rng.integers(0, 2, size=100)})
    ds = Dataset(name="test_dataset", features=["x", "x2"], targets=["y"],
                 test_size=0.2, shuffle=True, random_state=99)

    @ds.reader
    def reader(sample_frac: float = 1.0, random_state: int = 123) -> pd.DataFrame:
        return data.sample(frac=sample_frac, random_state=random_state)

    return ds


@pytest.fixture
def trained_model(dataset):
    from sklearn.linear_model import LogisticRegression

    model = Model(name="test_model", init=LogisticRegression, dataset=dataset)

    @model.trainer
    def trainer(m: LogisticRegression, features: pd.DataFrame,
                target: pd.DataFrame) -> LogisticRegression:
        return m.fit(features, target.squeeze())

    @model.predictor
    def predictor(m: LogisticRegression, features: pd.DataFrame) -> list:
        return [float(x) for x in m.predict(features)]

    @model.evaluator
    def evaluator(m: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> float:
        return float(m.score(features, target.squeeze()))

    model.train(hyperparameters={"max_iter": 500}, sample_frac=1.0, random_state=123)
    return model


def test_gateway_routes(trained_model):
    handler = gateway_handler(trained_model)
    assert handler({"httpMethod": "GET", "path": "/"})["statusCode"] == 200
    health = handler({"httpMethod": "GET", "path": "/health"})
    assert json.loads(health["body"])["model_loaded"] is True
    assert handler({"httpMethod": "GET", "path": "/nope"})["statusCode"] == 404


def test_gateway_predict_and_validation(trained_model, dataset):
    handler = gateway_handler(trained_model)
    features = [[0.1, 0.2], [1.5, -0.3], [0.0, 0.9]]
    resp = handler({
        "httpMethod": "POST", "path": "/predict",
        "body": json.dumps({"features": features}),
    })
    assert resp["statusCode"] == 200
    preds = json.loads(resp["body"])
    assert len(preds) == 3
    # both inputs and features -> 422, the status the HTTP transports
    # answer for the identical payload
    bad = handler({
        "httpMethod": "POST", "path": "/predict",
        "body": json.dumps({"features": features, "inputs": {}}),
    })
    assert bad["statusCode"] == 422
    assert "exactly one" in json.loads(bad["body"])["error"]


def test_gateway_http_api_v2_event_shape(trained_model):
    # API-Gateway v2 events carry method/path differently
    handler = gateway_handler(trained_model)
    resp = handler({
        "requestContext": {"http": {"method": "GET"}},
        "rawPath": "/health",
    })
    assert resp["statusCode"] == 200


def test_gateway_metrics_and_request_id(trained_model):
    """GET /metrics serves the Prometheus exposition and every response
    carries X-Request-ID — echoed when the gateway forwarded one, minted
    otherwise."""
    handler = gateway_handler(trained_model)
    r = handler({"httpMethod": "GET", "path": "/health"})
    rid = r["headers"]["X-Request-ID"]
    assert rid and len(rid) == 16 and int(rid, 16) >= 0
    r = handler({
        "httpMethod": "GET", "path": "/health",
        "headers": {"X-Request-Id": "trace-me-123"},
    })
    assert r["headers"]["X-Request-ID"] == "trace-me-123"
    handler({
        "httpMethod": "POST", "path": "/predict",
        "body": json.dumps({"features": [[0.1, 0.2]]}),
    })
    m = handler({"httpMethod": "GET", "path": "/metrics"})
    assert m["statusCode"] == 200
    assert m["headers"]["Content-Type"].startswith("text/plain")
    assert "unionml_http_requests_total" in m["body"]
    assert 'transport="serverless"' in m["body"]
    assert 'path="/predict"' in m["body"]
    # the standard process gauges ride along (the port's build info)
    assert "process_start_time_seconds" in m["body"]
    assert "unionml_tpu_torch_build_info" in m["body"]
    s = handler({"httpMethod": "GET", "path": "/stats"})
    assert s["statusCode"] == 200
    assert json.loads(s["body"])["engine"] == "direct"


def test_gateway_health_non_ok_maps_503(trained_model):
    """Any non-ok health answers 503 so gateway health checks stop routing
    here; draining predicts get the typed 503 + Retry-After."""
    handler = gateway_handler(trained_model)
    app = handler.serving_app
    assert handler({"httpMethod": "GET", "path": "/health"})["statusCode"] == 200
    app.drain()
    try:
        h = handler({"httpMethod": "GET", "path": "/health"})
        assert h["statusCode"] == 503
        assert json.loads(h["body"])["status"] == "draining"
        r = handler({
            "httpMethod": "POST", "path": "/predict",
            "body": json.dumps({"features": [[0.1, 0.2]]}),
        })
        assert r["statusCode"] == 503
        assert json.loads(r["body"])["reason"] == "draining"
        assert int(r["headers"]["Retry-After"]) >= 1
    finally:
        app.resume()
    ok = handler({
        "httpMethod": "POST", "path": "/predict",
        "body": json.dumps({"features": [[0.1, 0.2]]}),
    })
    assert ok["statusCode"] == 200


def test_gateway_deadline_header_contract(trained_model):
    """X-Deadline-Ms flows through the shared parser: malformed values are
    a 422, valid ones open the deadline scope around the predictor call."""
    handler = gateway_handler(trained_model)
    bad = handler({
        "httpMethod": "POST", "path": "/predict",
        "headers": {"X-Deadline-Ms": "banana"},
        "body": json.dumps({"features": [[0.1, 0.2]]}),
    })
    assert bad["statusCode"] == 422
    assert "X-Deadline-Ms" in json.loads(bad["body"])["error"]
    ok = handler({
        "httpMethod": "POST", "path": "/predict",
        "headers": {"X-Deadline-Ms": "30000"},
        "body": json.dumps({"features": [[0.1, 0.2]]}),
    })
    assert ok["statusCode"] == 200


def test_object_event_batch_prediction(trained_model, tmp_path):
    store = LocalObjectStore(str(tmp_path))
    features = [[0.1, 0.2], [1.5, -0.3]]
    store.put("uploads", "batch-001.json", json.dumps(features).encode())

    handler = object_event_handler(trained_model, store)
    event = {"Records": [{"s3": {"bucket": {"name": "uploads"},
                                 "object": {"key": "batch-001.json"}}}]}
    resp = handler(event)
    assert resp["statusCode"] == 200
    out = json.loads(resp["body"])["outputs"]
    assert out == [{"bucket": "uploads", "key": "batch-001.json.predictions.json"}]
    preds = json.loads(store.get("uploads", "batch-001.json.predictions.json"))
    assert len(preds) == 2
    # malformed records are skipped, not fatal
    assert handler({"Records": [{"s3": {}}]})["statusCode"] == 200


def test_object_event_url_encoded_keys_and_partial_errors(trained_model, tmp_path):
    store = LocalObjectStore(str(tmp_path))
    store.put("uploads", "my batch.json", json.dumps([[0.1, 0.2]]).encode())

    handler = object_event_handler(trained_model, store)

    def rec(key):
        return {"s3": {"bucket": {"name": "uploads"}, "object": {"key": key}}}

    # S3 notifications URL-encode keys; one missing object must not abort
    # the good record's output
    resp = handler({"Records": [rec("my+batch.json"), rec("missing.json")]})
    assert resp["statusCode"] == 207
    body = json.loads(resp["body"])
    assert body["outputs"] == [
        {"bucket": "uploads", "key": "my batch.json.predictions.json"}
    ]
    assert body["errors"][0]["key"] == "missing.json"


def test_local_object_store_rejects_traversal(tmp_path):
    store = LocalObjectStore(str(tmp_path / "store"))
    with pytest.raises(ValueError, match="escapes store root"):
        store.get("uploads", "../../secrets.txt")
    with pytest.raises(ValueError, match="escapes store root"):
        store.put("..", "x.json", b"{}")


# ------------------------------------------- parity with the JAX package

VOCAB = 97
KNOBS = dict(prefill_impl="flash", norm_impl="fused", quantized=True)
GEN = dict(max_new_tokens=6, bucket_lens=(8, 16, 32))
# ids and timings differ run to run; the trace id is the caller's
VOLATILE = {"X-Request-ID", "traceparent"}


def _llm_models():
    """The same int8 tiny Llama (fp32 activations) behind a JAX package
    Model and the ported llm_serving template's Model."""
    jcfg = JConfig.tiny(vocab_size=VOCAB, dtype="float32", **KNOBS)
    raw = JLlama(JConfig.tiny(vocab_size=VOCAB, dtype="float32")).init(
        jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))["params"]
    jparams = jserving_params(jquantize(raw, JPATTERNS), dtype=jnp.float32)

    jds = unionml_tpu.Dataset(name="jax_llm_dataset")

    @jds.reader
    def reader() -> list:
        return [[1, 2, 3]]

    @jds.feature_loader
    def feature_loader(rows: list) -> list:
        return rows

    jmodel = unionml_tpu.Model(name="jax_llm", dataset=jds)

    @jmodel.init
    def init(hyperparameters: dict) -> dict:
        return jparams

    @jmodel.trainer
    def trainer(params: dict, features: list, targets: list) -> dict:
        return params

    generate = jmake_lm_predictor(JLlama(jcfg), **GEN)

    @jmodel.predictor
    def predictor(params: dict, prompts: list) -> list:
        return generate(params, prompts)

    jmodel.train()
    cfg = LlamaConfig.tiny(vocab_size=VOCAB, dtype="float32", **KNOBS)
    model = template.build_model(cfg, name="port_llm", **GEN)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    model.artifact = ModelArtifact(from_jax_params(tree, cfg, device="cpu"))
    return jmodel, model


def _stable(resp):
    return resp["statusCode"], {k: v for k, v in resp["headers"].items() if k not in VOLATILE}


def test_gateway_and_object_events_match_the_jax_handlers(tmp_path):
    """Gateway events (predict, a bad tenant, a bad deadline, health, a
    404) and an object-upload event through both packages' handlers over
    the same weights: token for token, and the same status codes and
    headers apart from ids and timings."""
    jmodel, model = _llm_models()
    jhandler, handler = jserverless.gateway_handler(jmodel), gateway_handler(model)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, VOCAB, size=n).tolist() for n in (3, 9, 20)]
    trace = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    events = [
        {"httpMethod": "POST", "path": "/predict",
         "headers": {"X-Tenant-ID": "acme", "X-Request-ID": "r-1", "traceparent": trace},
         "body": json.dumps({"features": prompts})},
        {"httpMethod": "POST", "path": "/predict",
         "headers": {"X-Priority": "high", "X-Model-Version": "rel-2"},
         "body": json.dumps({"features": prompts[:1]})},
        {"httpMethod": "POST", "path": "/predict", "headers": {"X-Tenant-ID": "x" * 65},
         "body": json.dumps({"features": prompts[:1]})},
        {"httpMethod": "POST", "path": "/predict", "headers": {"X-Deadline-Ms": "-5"},
         "body": json.dumps({"features": prompts[:1]})},
        {"httpMethod": "GET", "path": "/health"},
        {"httpMethod": "GET", "path": "/nope"},
    ]
    for event in events:
        want, got = jhandler(event), handler(event)
        assert _stable(got) == _stable(want), event
        if event["path"] == "/predict" and want["statusCode"] == 200:
            assert json.loads(got["body"]) == json.loads(want["body"])
    first = handler(events[0])
    assert first["headers"]["X-Request-ID"] == "r-1"
    assert "ab" * 16 in first["headers"]["traceparent"]

    records = {"Records": [{"s3": {"bucket": {"name": "uploads"},
                                   "object": {"key": "batch.json"}}}]}
    outs = []
    for pkg, m in ((jserverless, jmodel), (None, model)):
        store = (pkg.LocalObjectStore if pkg else LocalObjectStore)(str(tmp_path / str(len(outs))))
        store.put("uploads", "batch.json", json.dumps(prompts).encode())
        resp = (pkg.object_event_handler if pkg else object_event_handler)(m, store)(records)
        outs.append((resp["statusCode"],
                     json.loads(store.get("uploads", "batch.json.predictions.json"))))
    assert outs[0] == outs[1] and outs[1][0] == 200
    assert len(outs[1][1]) == 3 and all(len(r) == GEN["max_new_tokens"] for r in outs[1][1])
