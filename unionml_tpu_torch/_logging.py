"""Framework logger (reference: unionml/_logging.py:3-7), env-tunable.

- ``UNIONML_TPU_LOG_LEVEL`` — level name (``DEBUG``/``INFO``/...; default
  ``INFO``); unknown names fall back to ``INFO`` instead of crashing at
  import.
- ``UNIONML_TPU_LOG_JSON=1`` — one JSON object per line (``ts``,
  ``level``, ``logger``, ``msg``[, ``exc``]) so engine/batcher error
  logs are machine-parseable alongside the :mod:`unionml_tpu_torch.telemetry`
  metrics and trace exports.

Handler registration is guarded so a re-import (tests reloading the
module, notebooks) cannot double-emit every line.
"""

import json
import logging
import os


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def _configure(logger: logging.Logger) -> None:
    level_name = os.environ.get("UNIONML_TPU_LOG_LEVEL", "INFO").upper()
    level = logging.getLevelName(level_name)
    logger.setLevel(level if isinstance(level, int) else logging.INFO)
    if not logger.handlers:  # re-import must not stack handlers
        handler = logging.StreamHandler()
        if os.environ.get("UNIONML_TPU_LOG_JSON") == "1":
            handler.setFormatter(_JsonFormatter())
        else:
            handler.setFormatter(logging.Formatter("[unionml-tpu] %(message)s"))
        logger.addHandler(handler)
    logger.propagate = False


logger = logging.getLogger("unionml_tpu_torch")
_configure(logger)
