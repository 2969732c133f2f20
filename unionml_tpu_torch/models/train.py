"""Training helpers of the model zoo — the serving half only.

The port of :func:`unionml_tpu.models.train.resolve_params`; the
reference's train state, optimizer chain and step functions are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any


def resolve_params(state: Any) -> Any:
    """The full param tree behind a state-or-params argument: a bare
    tree passes through, a state with ``full_params()`` (LoRA) resolves
    to it, any other state to its ``.params``."""
    if hasattr(state, "full_params"):
        return state.full_params()
    return state.params if hasattr(state, "params") else state
