"""Instance tracking for stage rehydration.

The reference leans on ``flytekit.core.tracker.TrackedInstance`` so that a
dynamically generated task can be serialized as a pointer ``(app module,
variable name, generator method)`` and regenerated inside a remote container
(reference: unionml/task_resolver.py:16-31). We implement the same idea
natively: a :class:`TrackedInstance` records the module it was instantiated
in at ``__init__`` time and lazily discovers the module-level variable name
that refers to it.
"""

from __future__ import annotations

import importlib
import inspect
import sys
from typing import Optional, Tuple


class TrackedInstance:
    """Records instantiation module so instances can be found by name later."""

    def __init__(self, *args, **kwargs):
        self._instantiated_in: Optional[str] = None
        self._lhs: Optional[str] = None
        frame = inspect.currentframe()
        # walk out of unionml_tpu_torch-internal frames (subclass __init__ chains)
        while frame is not None:
            mod = frame.f_globals.get("__name__", "")
            if not mod.startswith("unionml_tpu_torch"):
                self._instantiated_in = mod
                break
            frame = frame.f_back

    @property
    def instantiated_in(self) -> Optional[str]:
        return self._instantiated_in

    def find_lhs(self) -> str:
        """Find the module-level variable name bound to this instance."""
        if self._lhs is not None:
            return self._lhs
        if self._instantiated_in and self._instantiated_in in sys.modules:
            module = sys.modules[self._instantiated_in]
            for k, v in vars(module).items():
                if v is self:
                    self._lhs = k
                    return k
        raise ValueError(
            f"Could not find a module-level variable referencing {self!r} in "
            f"module {self._instantiated_in!r}. Assign the instance to a "
            "module-level variable so it can be rehydrated remotely."
        )

    def loader_path(self) -> Tuple[str, str]:
        """``(module, variable)`` pointer used by the stage resolver."""
        return self._instantiated_in or "", self.find_lhs()


def load_instance(module_name: str, var_name: str) -> TrackedInstance:
    """Re-import ``module_name`` and return its ``var_name`` instance.

    This is the rehydration half of the resolver trick
    (reference: unionml/task_resolver.py:16-21).
    """
    module = importlib.import_module(module_name)
    return getattr(module, var_name)
