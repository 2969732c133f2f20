"""Model-object transport across the execution boundary.

The port of :mod:`unionml_tpu.remote.artifacts`. The backend moves
workflow outputs as a pickle. A model object that does not pickle (a
:class:`~unionml_tpu_torch.models.train.TrainState` whose optimizer
closes over local functions, say) rides as the app's own saved-artifact
bytes (``Model._saver``) and is rehydrated on the consuming side with
``Model._loader``, which rebuilds the structure through the app's
``init`` exactly like ``Model.load`` does.
"""

from __future__ import annotations

import io
import pickle
from typing import Any

SAVED_KEY = "__unionml_tpu_torch_saved_artifact__"


def encode_model_object(model, model_object: Any, hyperparameters: Any = None) -> Any:
    """Saved-artifact stand-in for an unpicklable ``model_object``."""
    buf = io.BytesIO()
    model._saver(model_object, hyperparameters, buf)
    return {SAVED_KEY: buf.getvalue()}


def dump_outputs(model, outputs: dict, file) -> None:
    """Pickle workflow outputs, falling back to saver-encoded model bytes.

    The success path serializes exactly once (no throwaway picklability
    probe of a possibly multi-hundred-MB object); only when the whole
    outputs dict fails to pickle is the model object re-encoded through
    the app's saver and the dump retried.
    """
    try:
        blob = pickle.dumps(outputs)
    except Exception as e:
        # name the actual offender before retrying: the saver fallback only
        # helps when model_object is what failed — if some other key is
        # unpicklable the retry would fail again with a second traceback
        # masking the original cause. Probe the cheap keys FIRST: serializing
        # a possibly multi-hundred-MB model_object is pointless whenever any
        # other key is already known bad.
        bad = []
        for k, v in sorted(outputs.items(), key=lambda kv: kv[0] == "model_object"):
            if bad and k == "model_object":
                break  # another offender already decides the outcome
            try:
                pickle.dumps(v)
            except Exception:
                bad.append(k)
        if bad != ["model_object"]:
            # bad == []: the failure isn't attributable to any single value
            # (unpicklable dict key, cross-value cycle) — re-encoding the
            # model object can't help and would misdirect the diagnosis
            raise RuntimeError(
                "workflow outputs are not picklable: "
                + (
                    f"offending key(s) {bad}; only 'model_object' has a "
                    "saver-encoded fallback"
                    if bad
                    else "no single value is at fault (every value pickles "
                    "alone) — likely an unpicklable key or a cycle spanning "
                    "values"
                )
            ) from e
        outputs = {
            **outputs,
            "model_object": encode_model_object(
                model, outputs.get("model_object"), outputs.get("hyperparameters")
            ),
        }
        try:
            blob = pickle.dumps(outputs)
        except Exception as e2:
            raise RuntimeError(
                "model_object could not be pickled directly and its "
                "saver-encoded fallback also failed to pickle"
            ) from e2
    file.write(blob)


def decode_model_object(model, obj: Any) -> Any:
    """Inverse of :func:`encode_model_object` on the consuming side."""
    if isinstance(obj, dict) and SAVED_KEY in obj:
        return model._loader(io.BytesIO(obj[SAVED_KEY]))
    return obj
