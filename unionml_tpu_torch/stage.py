"""Compiled stages and workflows: the execution substrate.

This module replaces the reference's flytekit dependency. The reference
compiles user functions into flytekit tasks via ``inner_task``
(reference: unionml/utils.py:10-59) and assembles them into flytekit
workflows (reference: unionml/model.py:292-338). Here a compiled unit is a
:class:`Stage`:

- **named** ``{object_name}.{fn_name}`` (reference: utils.py:58),
- **directly callable** — the local executor is plain Python, which doubles
  as the unit-test fake (reference test strategy, tests/unit/test_model.py),
- **resource-annotated** (:class:`unionml_tpu_torch.defaults.Resources`),
- **cacheable** — ``cache=True, cache_version=...`` produces a
  content-addressed on-disk cache, replicating the flytekit caching knob the
  quickdraw template uses (reference: templates/quickdraw/.../app.py:18-62),
- **rehydratable** — a stage serializes as ``(module, variable,
  stage_method)`` and is regenerated remotely by re-importing the app module
  (reference: unionml/task_resolver.py:16-31).

A :class:`Workflow` is a plain-Python DAG of stages with named inputs and
outputs; calling it executes the DAG in-process. Device placement happens
*inside* stage bodies (jit/pjit over a mesh) — the workflow layer is
host-side orchestration only, so XLA owns all on-device scheduling.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pickle
from dataclasses import dataclass, field
from inspect import Parameter, Signature

from unionml_tpu_torch.type_guards import signature
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.defaults import DEFAULT_RESOURCES, Resources
from unionml_tpu_torch.tracking import load_instance

CACHE_DIR_ENV = "UNIONML_TPU_CACHE_DIR"
DEFAULT_CACHE_DIR = "~/.cache/unionml_tpu_torch/stages"


def _stable_hash(obj: Any) -> str:
    """Content hash of arbitrary Python objects for stage caching."""
    try:
        import joblib

        return joblib.hash(obj) or "none"
    except Exception:
        try:
            return hashlib.sha256(pickle.dumps(obj)).hexdigest()
        except Exception:
            return hashlib.sha256(repr(obj).encode()).hexdigest()


@dataclass
class StageRef:
    """Serializable pointer to a dynamically generated stage.

    Reference: unionml/task_resolver.py:23-31 — ``loader_args`` records the
    app module, the Dataset/Model variable name, and the generator method.
    """

    module: str
    var_name: str
    stage_method: str

    def load(self) -> "Stage":
        instance = load_instance(self.module, self.var_name)
        return getattr(instance, self.stage_method)()


class Stage:
    """A named, cached, resource-annotated compiled unit of work."""

    def __init__(
        self,
        fn: Callable,
        *,
        name: str,
        parameters: Sequence[Parameter],
        return_annotation: Any = Signature.empty,
        resources: Resources = DEFAULT_RESOURCES,
        cache: bool = False,
        cache_version: str = "0",
        ref: Optional[StageRef] = None,
        owner: Any = None,
    ):
        self._fn = fn
        self.name = name
        self.resources = resources
        self.cache = cache
        self.cache_version = cache_version
        self.ref = ref
        # backref so a stage can be traced to its Dataset/Model
        # (reference: utils.py:33 __unionml_object__)
        self.__unionml_object__ = owner
        params = [
            p.replace(kind=Parameter.KEYWORD_ONLY)
            if p.kind in (Parameter.POSITIONAL_ONLY, Parameter.POSITIONAL_OR_KEYWORD)
            else p
            for p in parameters
        ]
        self.__signature__ = Signature(params, return_annotation=return_annotation)
        self.__name__ = name
        functools.update_wrapper(self, fn, assigned=("__doc__", "__module__"))
        self.__annotations__ = {p.name: p.annotation for p in params}
        if return_annotation is not Signature.empty:
            self.__annotations__["return"] = return_annotation

    # -- interface introspection (reference asserts task input/output types:
    #    tests/unit/test_model.py:25-44)
    @property
    def input_types(self) -> Dict[str, Any]:
        return {
            k: p.annotation for k, p in self.__signature__.parameters.items()
        }

    @property
    def output_type(self) -> Any:
        return self.__signature__.return_annotation

    def _cache_path(self, key: str) -> Path:
        root = Path(os.environ.get(CACHE_DIR_ENV, DEFAULT_CACHE_DIR)).expanduser()
        return root / self.name / self.cache_version / f"{key}.pkl"

    def __call__(self, **kwargs) -> Any:
        bound = self.__signature__.bind(**kwargs)
        bound.apply_defaults()
        if self.cache:
            key = _stable_hash((self.name, self.cache_version, bound.arguments))
            path = self._cache_path(key)
            if path.exists():
                logger.info(f"stage {self.name}: cache hit ({key[:12]})")
                with open(path, "rb") as f:
                    return pickle.load(f)
            result = self._fn(**bound.arguments)
            try:
                path.parent.mkdir(parents=True, exist_ok=True)
                with open(path, "wb") as f:
                    pickle.dump(result, f)
            except Exception as exc:  # non-picklable results stay uncached
                logger.info(f"stage {self.name}: result not cacheable ({exc})")
            return result
        return self._fn(**bound.arguments)

    def __repr__(self) -> str:
        return f"Stage(name={self.name!r}, inputs={list(self.input_types)})"


def stage_from_fn(
    fn: Callable,
    *,
    owner: Any,
    name: Optional[str] = None,
    parameters: Optional[Sequence[Parameter]] = None,
    return_annotation: Any = None,
    stage_method: Optional[str] = None,
    resources: Optional[Resources] = None,
    cache: bool = False,
    cache_version: str = "0",
) -> Stage:
    """Compile a function into a :class:`Stage` owned by ``owner``.

    The synthesized name is ``{owner.name}.{fn.__name__}``
    (reference: utils.py:58) and the stage records a :class:`StageRef` for
    remote rehydration when the owner is module-tracked.
    """
    sig = signature(fn)
    ref = None
    if stage_method is not None:
        try:
            module, var = owner.loader_path()
            ref = StageRef(module=module, var_name=var, stage_method=stage_method)
        except Exception:
            ref = None  # interactively defined objects can't be rehydrated
    return Stage(
        fn,
        name=name or f"{owner.name}.{fn.__name__}",
        parameters=parameters if parameters is not None else list(sig.parameters.values()),
        return_annotation=(
            return_annotation if return_annotation is not None else sig.return_annotation
        ),
        resources=resources or DEFAULT_RESOURCES,
        cache=cache,
        cache_version=cache_version,
        ref=ref,
        owner=owner,
    )


@dataclass(frozen=True)
class Literal:
    """Wrap a literal string value in a workflow binding (bare strings name
    workflow inputs)."""

    value: Any


@dataclass
class WorkflowNode:
    """One stage invocation in a workflow DAG."""

    stage: Stage
    # mapping of stage-kwarg name -> workflow input name or (node_idx, key)
    bindings: Dict[str, Any] = field(default_factory=dict)
    output_name: Optional[str] = None


class Workflow:
    """A named, directly-callable DAG of stages.

    Reference analog: the flytekit ``Workflow`` assembled at
    unionml/model.py:292-338. Inputs are declared with names + types;
    each node binds stage kwargs either to workflow inputs or to upstream
    node outputs; outputs select node results by name.
    """

    def __init__(self, name: str):
        self.name = name
        self.inputs: Dict[str, Tuple[Any, Any]] = {}  # name -> (type, default)
        self.nodes: List[WorkflowNode] = []
        self.outputs: Dict[str, Tuple[int, Optional[Any]]] = {}  # name -> (node idx, selector)

    _EMPTY = object()

    def add_input(self, name: str, annotation: Any = Any, default: Any = _EMPTY) -> str:
        self.inputs[name] = (annotation, default)
        return name

    def add_node(self, stage: Stage, bindings: Dict[str, Any]) -> int:
        self.nodes.append(WorkflowNode(stage=stage, bindings=bindings))
        return len(self.nodes) - 1

    def add_output(self, name: str, node_idx: int, selector: Optional[Callable] = None):
        self.outputs[name] = (node_idx, selector)

    def __call__(self, **kwargs) -> Any:
        # resolve inputs with defaults
        values: Dict[str, Any] = {}
        for name, (_, default) in self.inputs.items():
            if name in kwargs:
                values[name] = kwargs.pop(name)
            elif default is not self._EMPTY:
                values[name] = default
            else:
                raise TypeError(f"workflow {self.name!r} missing required input {name!r}")
        if kwargs:
            raise TypeError(f"workflow {self.name!r} got unexpected inputs {sorted(kwargs)}")

        node_results: List[Any] = []
        for node in self.nodes:
            stage_kwargs = {}
            for arg_name, binding in node.bindings.items():
                if isinstance(binding, tuple) and len(binding) == 2 and isinstance(binding[0], int):
                    upstream, selector = binding
                    result = node_results[upstream]
                    stage_kwargs[arg_name] = selector(result) if callable(selector) else result
                elif isinstance(binding, str):
                    # string bindings always name a workflow input; a typo is
                    # an assembly error, not a literal value
                    if binding not in values:
                        raise TypeError(
                            f"workflow {self.name!r}: node argument {arg_name!r} is "
                            f"bound to unknown input {binding!r} (inputs: "
                            f"{sorted(values)}). Use Literal(...) for literal strings."
                        )
                    stage_kwargs[arg_name] = values[binding]
                elif isinstance(binding, Literal):
                    stage_kwargs[arg_name] = binding.value
                else:
                    stage_kwargs[arg_name] = binding  # literal
            node_results.append(node.stage(**stage_kwargs))

        if not self.outputs:
            return node_results[-1] if node_results else None
        out = {
            name: (selector(node_results[idx]) if callable(selector) else node_results[idx])
            for name, (idx, selector) in self.outputs.items()
        }
        if len(out) == 1:
            return next(iter(out.values()))
        return out

    def __repr__(self) -> str:
        return (
            f"Workflow(name={self.name!r}, inputs={list(self.inputs)}, "
            f"nodes={[n.stage.name for n in self.nodes]}, outputs={list(self.outputs)})"
        )
