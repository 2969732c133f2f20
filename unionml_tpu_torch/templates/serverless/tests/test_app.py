"""Scaffolded smoke test: both serverless handlers answer their events."""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _load_app():
    # by path, under a name of its own: every template has an ``app``
    spec = importlib.util.spec_from_file_location("serverless_template_app", ROOT / "app.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


app = _load_app()


def test_gateway_and_upload_handlers(tmp_path):
    app.model.train(hyperparameters={"max_iter": 200})
    health = app.handler({"httpMethod": "GET", "path": "/health"})
    assert health["statusCode"] == 200

    event = json.loads((ROOT / "events" / "gateway_predict.json").read_text())
    resp = app.handler(event)
    assert resp["statusCode"] == 200
    assert json.loads(resp["body"])

    # object-store upload event (fixture: events/object_upload.json)
    store = app.LocalObjectStore(str(tmp_path))
    frame = app.reader().drop(columns=["target"]).head(2)
    store.put("uploads", "batch-001.json",
              json.dumps(frame.to_dict(orient="records")).encode())
    on_upload = app.object_event_handler(app.model, store)
    upload_event = json.loads((ROOT / "events" / "object_upload.json").read_text())
    out = on_upload(upload_event)
    assert out["statusCode"] == 200
    written = json.loads(store.get("uploads", "batch-001.json.predictions.json"))
    assert len(written) == 2
