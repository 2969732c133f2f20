"""Model: training, evaluation, prediction, artifacts, serving.

The PyTorch port of :mod:`unionml_tpu.model` (reference: unionml/model.py
:55-988). ``@model.trainer`` keeps the reference contract: any Python
function ``(model_object, *data, **kwargs) -> model_object``, run
host-side. The second tier, ``@model.train_step`` (a per-batch step with a
synthesized epoch/batch loop,
:func:`~unionml_tpu_torch.execution.run_step_trainer`, or with
``checkpoint_dir`` the preemption-safe
:func:`~unionml_tpu_torch.elastic.run_elastic_trainer`), is ported with its
threaded feed, goodput, checkpoint, sharding and overlap options. The remote lifecycle (``remote``,
``remote_deploy`` / ``_train`` / ``_predict`` / ``_wait`` / ``_load``)
runs on :mod:`unionml_tpu_torch.remote`.

Everything else mirrors the reference surface: hyperparameter dataclass
synthesis (model.py:137-161), three compiled tasks (model.py:377-502),
three workflows (model.py:292-375), local train/predict (model.py:504-578),
artifact save/load (model.py:580-608) and serving (model.py:610-623). The
default saver writes a tree of torch tensors (the port's model state) as
a state dict with ``torch.save``, and a
:class:`~unionml_tpu_torch.models.train.TrainState` as its tensors and
counters, which the default loader restores into the state the
registered ``init`` builds.
"""

from __future__ import annotations

import copy
import inspect
import os
from dataclasses import asdict, field, is_dataclass, make_dataclass
from inspect import Parameter

from unionml_tpu_torch.type_guards import signature
from typing import IO, Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Type, Union

from unionml_tpu_torch import type_guards
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.dataset import Dataset
from unionml_tpu_torch.defaults import DEFAULT_DEVICE_RESOURCES, DEFAULT_RESOURCES
from unionml_tpu_torch.stage import Stage, Workflow, stage_from_fn
from unionml_tpu_torch.tracking import TrackedInstance


class BaseHyperparameters:
    """Base class for synthesized hyperparameter dataclasses
    (reference: model.py:31-40)."""


class ModelArtifact(NamedTuple):
    """Model artifact: trained object + hyperparameters + metrics
    (reference: model.py:42-52)."""

    model_object: Any
    hyperparameters: Optional[Union[BaseHyperparameters, dict]] = None
    metrics: Optional[Dict[str, Any]] = None


def is_pytorch_model(model_type: Any) -> bool:
    """Reference: unionml/utils.py:62-64."""
    try:
        import torch.nn

        return inspect.isclass(model_type) and issubclass(model_type, torch.nn.Module)
    except ImportError:
        return False


def is_sklearn_model(obj_or_type: Any) -> bool:
    try:
        import sklearn.base

        t = obj_or_type if inspect.isclass(obj_or_type) else type(obj_or_type)
        return issubclass(t, sklearn.base.BaseEstimator)
    except ImportError:
        return False


def is_tensor_tree(obj: Any) -> bool:
    """True when ``obj`` is a nested dict/list/tuple whose leaves are all
    torch tensors (a state dict, or the port's nested model state)."""
    import torch

    def leaves(node):
        if isinstance(node, dict):
            return [x for v in node.values() for x in leaves(v)]
        if isinstance(node, (list, tuple)):
            return [x for v in node for x in leaves(v)]
        return [node]

    if not isinstance(obj, (dict, list, tuple)):
        return False
    found = leaves(obj)
    return bool(found) and all(isinstance(x, torch.Tensor) for x in found)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to unionml_tpu_torch yet (see ROADMAP.md)"
    )


class Model(TrackedInstance):
    """Declarative model spec (reference: unionml/model.py:55)."""

    def __init__(
        self,
        name: str = "model",
        *,
        init: Optional[Union[Type, Callable]] = None,
        hyperparameter_config: Optional[Dict[str, Type]] = None,
        dataset: Optional[Dataset] = None,
    ):
        super().__init__()
        self.name = name
        self._init_callable = init
        self._hyperparameter_config = hyperparameter_config
        self._dataset = dataset if dataset is not None else Dataset(f"{name}.dataset")
        if self._dataset.name is None:
            self._dataset.name = f"{name}.dataset"

        self._artifact: Optional[ModelArtifact] = None

        # registered components
        self._init: Callable = self._default_init
        self._trainer: Optional[Callable] = None
        self._predictor: Optional[Callable] = None
        self._evaluator: Optional[Callable] = None
        self._saver: Callable = self._default_saver
        self._loader: Callable = self._default_loader

        self._predict_step_options: Dict[str, Any] = {}
        self._train_step: Optional[Callable] = None
        self._train_step_options: Dict[str, Any] = {}

        # compiled stages (lazily built)
        self._train_task: Optional[Stage] = None
        self._predict_task: Optional[Stage] = None
        self._predict_from_features_task: Optional[Stage] = None

        self._train_task_kwargs: Optional[Dict[str, Any]] = None
        self._predict_task_kwargs: Dict[str, Any] = {}

        self._hyperparameter_type: Optional[Type] = None

        # deployment configuration (reference: model.py:96-102, 625-654)
        self._registry: Optional[str] = None
        self._image_name: Optional[str] = None
        self._config_file: Optional[str] = None
        self._dockerfile: Optional[str] = None
        self._project: Optional[str] = None
        self._domain: Optional[str] = None
        self._backend = None  # unionml_tpu_torch.remote backend handle
        self._patch_destination_dir: Optional[str] = None

    # ------------------------------------------------------------------ #
    # properties
    # ------------------------------------------------------------------ #

    @property
    def artifact(self) -> Optional[ModelArtifact]:
        return self._artifact

    @artifact.setter
    def artifact(self, new_value: ModelArtifact):
        self._artifact = new_value

    @property
    def dataset(self) -> Dataset:
        return self._dataset

    @property
    def hyperparameter_type(self) -> Type:
        """Synthesize the hyperparameter dataclass from the ``init``
        signature or ``hyperparameter_config`` (reference: model.py:137-161).
        Falls back to ``dict`` when any init argument is unannotated."""
        if self._hyperparameter_type is not None:
            return self._hyperparameter_type

        hyperparameter_fields: List[Any] = []
        if self._hyperparameter_config is None:
            if self._init_callable is None:
                self._hyperparameter_type = dict
                return dict
            sig = signature(self._init_callable)
            if any(p.annotation is inspect.Parameter.empty for p in sig.parameters.values()):
                self._hyperparameter_type = dict
                return dict
            for hparam_name, hparam in sig.parameters.items():
                hyperparameter_fields.append(
                    (hparam_name, hparam.annotation, field(default=hparam.default))
                )
        else:
            for hparam_name, hparam_type in self._hyperparameter_config.items():
                hyperparameter_fields.append((hparam_name, hparam_type))

        self._hyperparameter_type = make_dataclass(
            "Hyperparameters", hyperparameter_fields, bases=(BaseHyperparameters,)
        )
        return self._hyperparameter_type

    @property
    def train_workflow_name(self) -> str:
        return f"{self.name}.train"

    @property
    def predict_workflow_name(self) -> str:
        return f"{self.name}.predict"

    @property
    def predict_from_features_workflow_name(self) -> str:
        return f"{self.name}.predict_from_features"

    @property
    def model_type(self) -> Any:
        """Model object type from init (reference: model.py:920-922)."""
        init = (
            self._init_callable
            if self._init == self._default_init
            else self._init or self._init_callable
        )
        if init is None:
            return Any
        return init if inspect.isclass(init) else signature(init).return_annotation

    # ------------------------------------------------------------------ #
    # registration decorators (reference: model.py:193-283)
    # ------------------------------------------------------------------ #

    def init(self, fn):
        """Register a model-object initializer (reference: model.py:193-196)."""
        self._init = fn
        self._hyperparameter_type = None
        return fn

    def _expected_data_types(self) -> Tuple[Any, ...]:
        """Types the parser hands to trainer/evaluator
        (reference: model.py:210-223 — DataFrame special-cased into
        features+targets frames)."""
        ds = self._dataset
        if ds._parser == ds._default_parser:
            try:
                dtype = ds.dataset_datatype["data"]
            except ValueError:
                return ()  # no reader yet: decoration-order tolerance
            try:
                import pandas as pd

                if dtype is pd.DataFrame:
                    return (dtype, dtype)
            except ImportError:
                pass
            # the default parser ALWAYS yields two outputs — (features,
            # targets-or-None) — so the guard must demand two data args or
            # the runtime call `trainer(model, *parsed)` breaks
            # (reference parity: dataset.py:472-487 returns [features, targets])
            return (dtype, Any)
        return ds.parser_return_types

    def trainer(self, fn: Optional[Callable] = None, **train_task_kwargs):
        """Register the trainer (reference: model.py:198-228).

        ``**train_task_kwargs`` forward stage knobs: ``cache``,
        ``cache_version``, ``resources``. Host-opaque tier — for the
        jit/pjit tier use :meth:`train_step`.
        """
        if fn is None:
            return lambda f: self.trainer(f, **train_task_kwargs)
        type_guards.guard_trainer(fn, self.model_type, self._expected_data_types())
        self._trainer = fn
        self._train_task_kwargs = {
            "resources": self._default_stage_resources(), **train_task_kwargs
        }
        self._train_task = None
        return fn

    def _default_stage_resources(self):
        """scikit-learn estimators, the one host-only model family, default
        to ``chips=0`` (:mod:`unionml_tpu_torch.defaults`); everything else
        (``torch.nn.Module`` classes and tensor-tree apps, which the port
        runs on the card) advertises a chip. Override per stage with
        ``resources=Resources(...)``. (The reference's Keras branch is not
        carried over: importing TensorFlow can pull in JAX, which the port
        never imports.)"""
        if is_sklearn_model(self.model_type):
            return DEFAULT_RESOURCES
        return DEFAULT_DEVICE_RESOURCES

    def train_step(
        self,
        fn: Optional[Callable] = None,
        *,
        sharding: Any = None,
        donate_state: bool = True,
        accumulate_steps: int = 1,
        overlap_grads: bool = False,
        double_buffer: bool = False,
        donate_batch: Optional[bool] = None,
        checkpoint_dir: Optional[str] = None,
        save_every: int = 100,
        max_checkpoints: int = 3,
        checkpoint_backend: str = "auto",
        goodput: Any = None,
        measure_device_time: bool = False,
        **train_task_kwargs,
    ):
        """Register a per-batch training step (the reference's second tier,
        :meth:`unionml_tpu.model.Model.train_step`).

        Contract: ``step(state, batch) -> (state, metrics)`` where ``state``
        holds tensors on the training device (e.g. a
        :class:`~unionml_tpu_torch.models.train.TrainState`) and ``batch``
        has a leading batch axis. The framework synthesizes the trainer
        (epochs, batching, device feed) around it
        (:func:`~unionml_tpu_torch.execution.run_step_trainer`).
        ``accumulate_steps=N`` feeds ``[N, batch_size, ...]`` microbatched
        batches for a step that accumulates them into one update;
        ``measure_device_time`` waits for the card after every step (plain
        route only).

        ``double_buffer=True`` moves the data feed (host batch pull, pin,
        copy enqueue) onto a feeder thread with its own copy stream.
        ``goodput=True`` (or a
        :class:`~unionml_tpu_torch.goodput.GoodputTracker`) attributes the
        synthesized loop's wall time into compute and badput buckets on
        both routes.

        ``checkpoint_dir``: preemption safety — the synthesized trainer
        routes through :func:`unionml_tpu_torch.elastic.run_elastic_trainer`:
        the state is checkpointed every ``save_every`` optimizer steps
        (keeping ``max_checkpoints``; ``checkpoint_backend`` ``"auto"`` /
        ``"async"`` / ``"sync"``), and a killed-and-relaunched run resumes
        from the newest checkpoint to the bit-identical final state of an
        uninterrupted run. A relative path resolves against the working
        directory.

        ``sharding`` (a :class:`~unionml_tpu_torch.parallel.ShardingConfig`)
        runs the step over the config's mesh through
        :func:`~unionml_tpu_torch.parallel.compile_step`: the state is placed
        once by the partition rules (``donate_state`` updates it in place)
        and every rank feeds its rows; the trained state the evaluator,
        predictor and artifact receive is gathered to whole tensors on every
        rank. ``overlap_grads=True`` overlaps the
        gradient collectives of microbatch *i* with the backward of *i + 1*
        (the serial accumulation's values); ``donate_batch`` (default:
        ``double_buffer``) lets the step drop each fed batch.
        """
        if fn is None:
            return lambda f: self.train_step(
                f, sharding=sharding, donate_state=donate_state,
                accumulate_steps=accumulate_steps, overlap_grads=overlap_grads,
                double_buffer=double_buffer, donate_batch=donate_batch,
                checkpoint_dir=checkpoint_dir, save_every=save_every,
                max_checkpoints=max_checkpoints, checkpoint_backend=checkpoint_backend,
                goodput=goodput, measure_device_time=measure_device_time,
                **train_task_kwargs,
            )
        type_guards.guard_train_step(fn)
        self._train_step = fn
        self._train_step_options = {
            "sharding": sharding,
            "donate_state": donate_state,
            "accumulate_steps": accumulate_steps,
            "overlap_grads": overlap_grads,
            "double_buffer": double_buffer,
            "donate_batch": donate_batch,
            "checkpoint_dir": checkpoint_dir,
            "save_every": save_every,
            "max_checkpoints": max_checkpoints,
            "checkpoint_backend": checkpoint_backend,
            "goodput": goodput,
            "measure_device_time": measure_device_time,
        }
        self._trainer = self._make_step_trainer()
        self._train_task_kwargs = {"resources": DEFAULT_DEVICE_RESOURCES, **train_task_kwargs}
        self._train_task = None
        return fn

    def _make_step_trainer(self) -> Callable:
        """Synthesize an epoch/batch trainer loop around the registered
        ``train_step``."""
        from unionml_tpu_torch.execution import run_step_trainer

        model = self

        def trainer(
            model_object,
            features,
            targets=None,
            *,
            num_epochs: int = 1,
            batch_size: int = 32,
            seed: int = 0,
        ):
            opts = model._train_step_options
            if opts["checkpoint_dir"]:
                state = model._run_checkpointed(model_object, features, targets,
                                                num_epochs=num_epochs, batch_size=batch_size,
                                                seed=seed)
            else:
                state = run_step_trainer(
                    step_fn=model._train_step,
                    state=model_object,
                    features=features,
                    targets=targets,
                    num_epochs=num_epochs,
                    batch_size=batch_size,
                    seed=seed,
                    sharding=opts["sharding"],
                    donate_state=opts["donate_state"],
                    accumulate_steps=opts["accumulate_steps"],
                    overlap_grads=opts["overlap_grads"],
                    double_buffer=opts["double_buffer"],
                    donate_batch=opts["donate_batch"],
                    goodput=opts["goodput"],
                    measure_device_time=opts["measure_device_time"],
                )
            if opts["sharding"] is not None:
                # the evaluator, predictor and artifact take whole tensors
                from unionml_tpu_torch.parallel.sharding import gather_state

                state = gather_state(state)
            return state

        trainer.__name__ = "synthesized_step_trainer"
        return trainer

    def _run_checkpointed(self, state, features, targets, *, num_epochs: int, batch_size: int,
                          seed: int):
        """The preemption-safe route of the synthesized trainer: periodic
        checkpoints, and a resume from the newest one on relaunch."""
        # looked up at call time, so a test can wrap it (a fault hook)
        from unionml_tpu_torch import elastic
        from unionml_tpu_torch.execution import _host, is_stream

        opts = self._train_step_options
        common = dict(
            step_fn=self._train_step,
            state=state,
            checkpoint_dir=opts["checkpoint_dir"],
            checkpoint_every=opts["save_every"],
            max_to_keep=opts["max_checkpoints"],
            checkpoint_backend=opts["checkpoint_backend"],
            batch_size=batch_size,
            seed=seed,
            sharding=opts["sharding"],
            donate_state=opts["donate_state"],
            accumulate_steps=opts["accumulate_steps"],
            overlap_grads=opts["overlap_grads"],
            double_buffer=opts["double_buffer"],
            donate_batch=opts["donate_batch"],
            goodput=opts["goodput"],
        )
        if is_stream(features):
            # a resumable stream must be a SEEKABLE or REPLAYABLE callable: a
            # one-shot iterator cannot reproduce consumed batches after a
            # preemption, and epochs don't apply to a step-indexed stream
            if not callable(features):
                raise ValueError(
                    "checkpoint_dir training needs a CALLABLE stream — stream() "
                    "replayable or stream(start_step) seekable — so a relaunch can "
                    "resume; a one-shot iterator cannot reproduce consumed batches"
                )
            if targets is not None:
                raise ValueError(
                    "streaming trainers take batches from `features` alone — yield "
                    "(x, y) tuples from the stream instead of passing targets"
                )
            if num_epochs != 1:
                raise ValueError(
                    "a checkpointed stream is ONE step-indexed sequence (got "
                    f"num_epochs={num_epochs}); bound it with the stream itself and "
                    "keep num_epochs=1"
                )
            state, _step = elastic.run_elastic_trainer(stream=features, **common)
            return state

        arrays = [_host(features)] + ([_host(targets)] if targets is not None else [])
        state, _step = elastic.run_elastic_trainer(arrays=arrays, num_epochs=num_epochs,
                                                   **common)
        return state

    def predictor(self, fn: Optional[Callable] = None, **predict_task_kwargs):
        """Register the predictor (reference: model.py:230-252).

        ``batch_axis`` hints at the micro-batching axis for the serving
        batcher. The reference's ``jit=True`` has no meaning here (PyTorch
        runs eagerly) and raises.
        """
        if fn is None:
            return lambda f: self.predictor(f, **predict_task_kwargs)
        if predict_task_kwargs.pop("jit", False):
            raise _not_ported("predictor(jit=True)")
        batch_axis = predict_task_kwargs.pop("batch_axis", 0)
        type_guards.guard_predictor(fn, self.model_type, self._dataset.feature_type)
        self._predictor = fn
        self._predict_step_options = {"batch_axis": batch_axis}
        self._predict_task_kwargs = {
            "resources": self._default_stage_resources(), **predict_task_kwargs
        }
        self._predict_task = None
        self._predict_from_features_task = None
        return fn

    def evaluator(self, fn):
        """Register the evaluator (reference: model.py:254-271)."""
        type_guards.guard_evaluator(fn, self.model_type, self._expected_data_types())
        self._evaluator = fn
        return fn

    def saver(self, fn):
        """Register a model-object serializer (reference: model.py:273-276)."""
        self._saver = fn
        return fn

    def loader(self, fn):
        """Register a model-object deserializer (reference: model.py:278-281)."""
        self._loader = fn
        return fn

    # ------------------------------------------------------------------ #
    # compiled stages (reference: model.py:377-502)
    # ------------------------------------------------------------------ #

    @property
    def trainer_params(self) -> Dict[str, Parameter]:
        """Keyword-only params of the trainer → workflow inputs
        (reference: model.py:284-291)."""
        if self._trainer is None:
            return {}
        return {
            name: param
            for name, param in signature(self._trainer).parameters.items()
            if param.kind == Parameter.KEYWORD_ONLY
        }

    def train_task(self) -> Stage:
        """Compile trainer+evaluator into the train stage
        (reference: model.py:377-443)."""
        if self._train_task is not None:
            return self._train_task
        if self._trainer is None:
            raise ValueError(
                f"Model {self.name!r} has no trainer. Register one with "
                "@model.trainer or @model.train_step."
            )

        [(data_arg_name, data_arg_type)] = self._dataset.dataset_datatype.items()
        hyperparam_param = Parameter(
            "hyperparameters", Parameter.KEYWORD_ONLY, annotation=self.hyperparameter_type
        )
        parameters = [
            hyperparam_param,
            Parameter(data_arg_name, Parameter.KEYWORD_ONLY, annotation=data_arg_type),
            *[
                Parameter(arg, Parameter.KEYWORD_ONLY, annotation=dict, default=None)
                for arg in ("loader_kwargs", "splitter_kwargs", "parser_kwargs")
            ],
            *self.trainer_params.values(),
        ]
        trainer_ret = signature(self._trainer).return_annotation
        eval_ret = (
            signature(self._evaluator).return_annotation if self._evaluator else Any
        )
        return_annotation = NamedTuple(
            "ModelArtifact",
            model_object=trainer_ret,
            # plain data on the way OUT (the synthesized dataclass is the
            # INPUT type only): see the normalization note at the return
            hyperparameters=Optional[dict],  # type: ignore[valid-type]
            metrics=Dict[str, eval_ret],  # type: ignore[valid-type]
        )

        def train_task(**kwargs):
            hyperparameters = kwargs["hyperparameters"]
            raw_data = kwargs[data_arg_name]
            trainer_kwargs = {p: kwargs[p] for p in self.trainer_params if p in kwargs}

            hp_dict = asdict(hyperparameters) if is_dataclass(hyperparameters) else hyperparameters
            # insulate BEFORE init runs: an init that mutates its
            # hyperparameters dict (even nested values) must corrupt
            # neither the recorded artifact nor the caller's own dict
            if isinstance(hp_dict, dict):
                hp_out = copy.deepcopy(hp_dict)
                hp_dict = copy.deepcopy(hp_dict)
            else:
                hp_out = hp_dict

            def dc_kwargs(key):
                v = kwargs.get(key)
                return asdict(v) if is_dataclass(v) else v

            training_data = self._dataset.get_data(
                raw_data,
                loader_kwargs=dc_kwargs("loader_kwargs"),
                splitter_kwargs=dc_kwargs("splitter_kwargs"),
                parser_kwargs=dc_kwargs("parser_kwargs"),
            )
            model_object = self._trainer(
                self._init(hyperparameters=hp_dict),
                *training_data["train"],
                **trainer_kwargs,
            )
            metrics = (
                {
                    split_key: self._evaluator(model_object, *training_data[split_key])
                    for split_key in training_data
                }
                if self._evaluator is not None
                else {}
            )
            # hyperparameters cross the artifact boundary as plain data:
            # the synthesized dataclass (hyperparameter_type) has no
            # importable home, so its instances cannot be pickled by the
            # remote runner's output dump — the reference has the same
            # normalization implicitly (flytekit ships dataclasses as
            # JSON and regenerates the type via the task resolver;
            # reference: model.py:137-161, task_resolver.py:16-31).
            return return_annotation(model_object, hp_out, metrics)

        self._train_task = stage_from_fn(
            train_task,
            owner=self,
            name=f"{self.name}.train_task",
            parameters=parameters,
            return_annotation=return_annotation,
            stage_method="train_task",
            **(self._train_task_kwargs or {}),
        )
        return self._train_task

    def predict_task(self) -> Stage:
        """Compile the predictor over reader output
        (reference: model.py:445-474)."""
        if self._predict_task is not None:
            return self._predict_task
        if self._predictor is None:
            raise ValueError(
                f"Model {self.name!r} has no predictor. Register one with @model.predictor."
            )

        predictor_sig = signature(self._predictor)
        model_param, *_ = predictor_sig.parameters.values()
        model_param = model_param.replace(name="model_object", kind=Parameter.KEYWORD_ONLY)
        [(data_arg_name, data_arg_type)] = self._dataset.dataset_datatype.items()
        data_param = Parameter(data_arg_name, Parameter.KEYWORD_ONLY, annotation=data_arg_type)

        def predict_task(**kwargs):
            model_object = kwargs["model_object"]
            parsed = self._dataset._parser(kwargs[data_arg_name], **self._dataset.parser_kwargs)
            features = parsed[self._dataset._parser_feature_key]
            return self._call_predictor(model_object, features)

        self._predict_task = stage_from_fn(
            predict_task,
            owner=self,
            name=f"{self.name}.predict_task",
            parameters=[model_param, data_param],
            return_annotation=predictor_sig.return_annotation,
            stage_method="predict_task",
            **self._predict_task_kwargs,
        )
        return self._predict_task

    def predict_from_features_task(self) -> Stage:
        """Compile the predictor over raw features
        (reference: model.py:476-502)."""
        if self._predict_from_features_task is not None:
            return self._predict_from_features_task
        if self._predictor is None:
            raise ValueError(
                f"Model {self.name!r} has no predictor. Register one with @model.predictor."
            )

        predictor_sig = signature(self._predictor)
        model_param, features_param = list(predictor_sig.parameters.values())[:2]
        model_param = model_param.replace(name="model_object", kind=Parameter.KEYWORD_ONLY)
        features_param = Parameter(
            "features", Parameter.KEYWORD_ONLY, annotation=features_param.annotation
        )

        def predict_from_features_task(**kwargs):
            return self._call_predictor(kwargs["model_object"], kwargs["features"])

        self._predict_from_features_task = stage_from_fn(
            predict_from_features_task,
            owner=self,
            name=f"{self.name}.predict_from_features_task",
            parameters=[model_param, features_param],
            return_annotation=predictor_sig.return_annotation,
            stage_method="predict_from_features_task",
            **self._predict_task_kwargs,
        )
        return self._predict_from_features_task

    def _call_predictor(self, model_object, features):
        return self._predictor(model_object, features)

    # ------------------------------------------------------------------ #
    # workflows (reference: model.py:292-375)
    # ------------------------------------------------------------------ #

    def train_workflow(self) -> Workflow:
        """reader → train stage, wired as a named DAG
        (reference: model.py:292-338)."""
        dataset_task = self._dataset.dataset_task()
        train_task = self.train_task()

        wf = Workflow(self.train_workflow_name)
        wf.add_input("hyperparameters", self.hyperparameter_type)
        for arg in ("loader_kwargs", "splitter_kwargs", "parser_kwargs"):
            wf.add_input(arg, dict, default=None)
        for arg, param in dataset_task.__signature__.parameters.items():
            default = param.default if param.default is not Parameter.empty else Workflow._EMPTY
            wf.add_input(arg, param.annotation, default=default)
        for arg, param in self.trainer_params.items():
            default = param.default if param.default is not Parameter.empty else Workflow._EMPTY
            wf.add_input(arg, param.annotation, default=default)

        ds_idx = wf.add_node(dataset_task, {k: k for k in dataset_task.input_types})
        [(data_arg_name, _)] = self._dataset.dataset_datatype.items()
        train_bindings: Dict[str, Any] = {
            "hyperparameters": "hyperparameters",
            data_arg_name: (ds_idx, None),
            "loader_kwargs": "loader_kwargs",
            "splitter_kwargs": "splitter_kwargs",
            "parser_kwargs": "parser_kwargs",
        }
        for arg in self.trainer_params:
            train_bindings[arg] = arg
        tr_idx = wf.add_node(train_task, train_bindings)

        wf.add_output("model_object", tr_idx, lambda r: r.model_object)
        wf.add_output("hyperparameters", tr_idx, lambda r: r.hyperparameters)
        wf.add_output("metrics", tr_idx, lambda r: r.metrics)
        return wf

    def predict_workflow(self) -> Workflow:
        """reader → predict stage (reference: model.py:340-361)."""
        dataset_task = self._dataset.dataset_task()
        predict_task = self.predict_task()

        wf = Workflow(self.predict_workflow_name)
        wf.add_input("model_object", predict_task.input_types["model_object"])
        for arg, param in dataset_task.__signature__.parameters.items():
            default = param.default if param.default is not Parameter.empty else Workflow._EMPTY
            wf.add_input(arg, param.annotation, default=default)

        ds_idx = wf.add_node(dataset_task, {k: k for k in dataset_task.input_types})
        [(data_arg_name, _)] = self._dataset.dataset_datatype.items()
        p_idx = wf.add_node(
            predict_task, {"model_object": "model_object", data_arg_name: (ds_idx, None)}
        )
        wf.add_output("predictions", p_idx, None)
        return wf

    def predict_from_features_workflow(self) -> Workflow:
        """raw features → predict stage (reference: model.py:363-375)."""
        predict_task = self.predict_from_features_task()
        wf = Workflow(self.predict_from_features_workflow_name)
        for arg, annotation in predict_task.input_types.items():
            wf.add_input(arg, annotation)
        p_idx = wf.add_node(predict_task, {k: k for k in predict_task.input_types})
        wf.add_output("predictions", p_idx, None)
        return wf

    # ------------------------------------------------------------------ #
    # local execution (reference: model.py:504-578)
    # ------------------------------------------------------------------ #

    def train(
        self,
        hyperparameters: Optional[Dict[str, Any]] = None,
        loader_kwargs: Optional[Dict[str, Any]] = None,
        splitter_kwargs: Optional[Dict[str, Any]] = None,
        parser_kwargs: Optional[Dict[str, Any]] = None,
        trainer_kwargs: Optional[Dict[str, Any]] = None,
        **reader_kwargs,
    ) -> Tuple[Any, Any]:
        """Train locally through the compiled workflow
        (reference: model.py:504-547)."""
        trainer_kwargs = trainer_kwargs or {}
        hp_type = self.hyperparameter_type
        hp_value = (
            hp_type(**(hyperparameters or {})) if hp_type is not dict else (hyperparameters or {})
        )
        result = self.train_workflow()(
            hyperparameters=hp_value,
            loader_kwargs=self._dataset.loader_kwargs_type(**(loader_kwargs or {})),
            splitter_kwargs=self._dataset.splitter_kwargs_type(**(splitter_kwargs or {})),
            parser_kwargs=self._dataset.parser_kwargs_type(**(parser_kwargs or {})),
            **{**reader_kwargs, **trainer_kwargs},
        )
        model_obj = result["model_object"]
        hp = result["hyperparameters"]
        metrics = result["metrics"]
        self.artifact = ModelArtifact(model_obj, hp, metrics)
        return model_obj, metrics

    def predict(self, features: Any = None, **reader_kwargs):
        """Predict locally from features or reader kwargs
        (reference: model.py:549-578)."""
        if features is None and not reader_kwargs:
            raise ValueError("At least one of features or **reader_kwargs must be provided")
        if self.artifact is None:
            raise RuntimeError(
                "ModelArtifact not found. Train a model first with the `train` method "
                "before generating predictions."
            )
        if features is None:
            return self.predict_workflow()(
                model_object=self.artifact.model_object, **reader_kwargs
            )
        return self.predict_from_features_workflow()(
            model_object=self.artifact.model_object,
            features=self._dataset.get_features(features),
        )

    # ------------------------------------------------------------------ #
    # artifact save/load (reference: model.py:580-608, 931-988)
    # ------------------------------------------------------------------ #

    def save(self, file: Union[str, os.PathLike, IO], *args, **kwargs):
        if self.artifact is None:
            raise AttributeError(
                "`artifact` property is None. Call the `train` method to train a model first"
            )
        return self._saver(
            self.artifact.model_object, self.artifact.hyperparameters, file, *args, **kwargs
        )

    def load(self, file: Union[str, os.PathLike, IO], *args, **kwargs):
        self.artifact = ModelArtifact(self._loader(file, *args, **kwargs))
        return self.artifact.model_object

    def load_from_env(self, env_var: str = "UNIONML_MODEL_PATH", *args, **kwargs):
        model_path = os.getenv(env_var)
        # empty string counts as unset (containers often export VAR="")
        if not model_path:
            raise ValueError(f"env var for model path {env_var} doesn't exist.")
        return self.load(model_path, *args, **kwargs)

    def _default_init(self, hyperparameters: dict) -> Any:
        if self._init_callable is None:
            raise ValueError(
                "When using the default init, you must specify the init argument "
                "to the Model constructor."
            )
        return self._init_callable(**hyperparameters)

    def _default_saver(
        self,
        model_obj: Any,
        hyperparameters: Union[dict, BaseHyperparameters, None],
        file: Union[str, os.PathLike, IO],
        *args,
        **kwargs,
    ) -> Any:
        """Framework-dispatch saver (reference: model.py:931-963). A tree of
        torch tensors (the port's model state) is saved as a state dict
        with ``torch.save``, beside its hyperparameters."""
        hp = (
            asdict(hyperparameters)
            if hyperparameters is not None and is_dataclass(hyperparameters)
            else hyperparameters
        )
        if is_sklearn_model(model_obj):
            import joblib

            return joblib.dump({"model_obj": model_obj, "hyperparameters": hp}, file, *args, **kwargs)
        model_type = self.model_type
        if is_pytorch_model(model_type):
            import torch

            torch.save({"model_obj": model_obj.state_dict(), "hyperparameters": hp}, file)
            return file
        if is_tensor_tree(model_obj):
            import torch

            torch.save({"model_obj": model_obj, "hyperparameters": hp}, file)
            return file
        from unionml_tpu_torch.models.train import TrainState

        if isinstance(model_obj, TrainState):
            import torch

            torch.save(
                {"model_obj": model_obj.state_dict(), "train_state": True, "hyperparameters": hp},
                file,
            )
            return file
        raise NotImplementedError(
            f"Default saver not defined for type {type(model_obj)}. Use the "
            "Model.saver decorator to define one."
        )

    def _default_loader(self, file: Union[str, os.PathLike, IO], *args, **kwargs) -> Any:
        """Framework-dispatch loader (reference: model.py:965-988)."""
        model_type = self.model_type
        if inspect.isclass(model_type) and is_sklearn_model(model_type):
            import joblib

            return joblib.load(file, *args, **kwargs)["model_obj"]
        if is_pytorch_model(model_type):
            import torch

            payload = torch.load(file, *args, **kwargs)
            if self._init_callable is not None:
                model = self._init(hyperparameters=payload["hyperparameters"] or {})
            else:
                model = model_type(**(payload["hyperparameters"] or {}))
            model.load_state_dict(payload["model_obj"])
            return model
        # tensor-tree branch: the state dict restores its own structure,
        # each tensor onto the device it was saved from; a train state is
        # restored into the state the registered init builds (its apply
        # function and optimizer are code, not data)
        import torch

        payload = torch.load(file, weights_only=True)
        if payload.get("train_state"):
            target = self._init(hyperparameters=payload["hyperparameters"] or {})
            return target.load_state_dict(payload["model_obj"])
        return payload["model_obj"]

    # ------------------------------------------------------------------ #
    # serving (reference: model.py:610-623)
    # ------------------------------------------------------------------ #

    def serve(
        self,
        app=None,
        remote: bool = False,
        app_version: Optional[str] = None,
        model_version: str = "latest",
        batch: bool = False,
        **batcher_kwargs,
    ):
        """Mount serving endpoints (reference: model.py:610-623).

        ``app`` may be a FastAPI instance (mounted by
        :func:`~unionml_tpu_torch.serving.fastapi.serving_app`, which
        imports fastapi only then) or ``None`` for the dependency-free
        stdlib :class:`~unionml_tpu_torch.serving.http.ServingApp`.
        ``batch=True`` enables the micro-batcher. Returns the app.
        """
        from unionml_tpu_torch.serving.fastapi import serving_app

        return serving_app(
            self,
            app,
            remote=remote,
            app_version=app_version,
            model_version=model_version,
            batch=batch,
            **batcher_kwargs,
        )

    def serve_gradio(self, **interface_kwargs):
        """Launchable Gradio interface over the predictor
        (reference parity: the mnist tutorial's Gradio integration,
        docs/source/tutorials/mnist.md:37). Optional dependency — raises
        with install guidance when gradio is absent.
        """
        try:
            import gradio
        except ImportError as e:
            raise ImportError(
                "model.serve_gradio() needs the optional gradio dependency: "
                "pip install gradio"
            ) from e
        if self.artifact is None:
            raise ValueError("no model artifact loaded — train or load first")

        def fn(features):
            return self.predict(features=features)

        interface_kwargs.setdefault("inputs", "json")
        interface_kwargs.setdefault("outputs", "json")
        return gradio.Interface(fn=fn, **interface_kwargs)

    # ------------------------------------------------------------------ #
    # remote lifecycle (reference: model.py:625-917)
    # ------------------------------------------------------------------ #

    def remote(
        self,
        registry: Optional[str] = None,
        image_name: Optional[str] = None,
        config_file: Optional[str] = None,
        project: Optional[str] = None,
        domain: Optional[str] = None,
        dockerfile: str = "Dockerfile",
        patch_destination_dir: str = "/root",
    ):
        """Configure the remote backend (reference: model.py:625-654)."""
        self._registry = registry
        self._image_name = image_name
        self._config_file = config_file
        self._project = project or self.name.replace("_", "-")
        self._domain = domain or "development"
        self._dockerfile = dockerfile
        self._patch_destination_dir = patch_destination_dir
        self._backend = None

    @property
    def _remote(self):
        """Lazily construct the backend handle (reference: model.py:657-670)."""
        if self._backend is not None:
            return self._backend
        from unionml_tpu_torch.remote import get_backend

        self._backend = get_backend(
            config_file=self._config_file,
            project=self._project or self.name.replace("_", "-"),
            domain=self._domain or "development",
        )
        return self._backend

    def remote_deploy(
        self, app_version: Optional[str] = None, allow_uncommitted: bool = False, patch: bool = False
    ) -> str:
        """Package and register the app (reference: model.py:672-730)."""
        from unionml_tpu_torch import remote as remote_module

        app_version = app_version or remote_module.get_app_version(allow_uncommitted)
        if patch:
            app_version = f"{app_version}-patch{remote_module.patch_suffix()}"
        self._remote.deploy(self, app_version=app_version, patch=patch)
        logger.info(f"deployed {self.name} version {app_version}")
        return app_version

    def remote_train(
        self,
        app_version: Optional[str] = None,
        wait: bool = True,
        *,
        hyperparameters: Optional[Dict[str, Any]] = None,
        loader_kwargs: Optional[Dict[str, Any]] = None,
        splitter_kwargs: Optional[Dict[str, Any]] = None,
        parser_kwargs: Optional[Dict[str, Any]] = None,
        trainer_kwargs: Optional[Dict[str, Any]] = None,
        **reader_kwargs,
    ):
        """Launch training on the backend (reference: model.py:732-796)."""
        execution = self._remote.execute(
            self,
            workflow="train",
            app_version=app_version,
            inputs=dict(
                hyperparameters=hyperparameters or {},
                loader_kwargs=loader_kwargs,
                splitter_kwargs=splitter_kwargs,
                parser_kwargs=parser_kwargs,
                trainer_kwargs=trainer_kwargs or {},
                **reader_kwargs,
            ),
            wait=wait,
        )
        if wait:
            self.remote_load(execution)
            return self.artifact
        return execution

    def remote_predict(
        self,
        app_version: Optional[str] = None,
        model_version: Optional[str] = None,
        wait: bool = True,
        *,
        features: Any = None,
        **reader_kwargs,
    ):
        """Launch prediction on the backend (reference: model.py:798-864)."""
        workflow = "predict" if features is None else "predict_from_features"
        inputs: Dict[str, Any] = dict(reader_kwargs)
        if features is not None:
            inputs["features"] = features
        execution = self._remote.execute(
            self,
            workflow=workflow,
            app_version=app_version,
            model_version=model_version,
            inputs=inputs,
            wait=wait,
        )
        if wait:
            return self.remote_fetch_predictions(execution)
        return execution

    def remote_wait(self, execution, **kwargs):
        """Block until an execution completes (reference: model.py:866-870)."""
        return self._remote.wait(execution, **kwargs)

    def remote_load(self, execution):
        """Load the model artifact from an execution
        (reference: model.py:872-894)."""
        from unionml_tpu_torch.remote.artifacts import decode_model_object

        execution = self._remote.wait(execution)
        outputs = self._remote.fetch_outputs(execution)
        self.artifact = ModelArtifact(
            decode_model_object(self, outputs.get("model_object")),
            outputs.get("hyperparameters"),
            outputs.get("metrics"),
        )
        return self.artifact

    def remote_list_model_versions(self, app_version: Optional[str] = None, limit: int = 10):
        """Model versions = successful train executions
        (reference: model.py:896-906)."""
        return self._remote.list_model_versions(self, app_version=app_version, limit=limit)

    def remote_fetch_predictions(self, execution):
        """Fetch predictions from an execution (reference: model.py:908-917)."""
        execution = self._remote.wait(execution)
        outputs = self._remote.fetch_outputs(execution)
        return outputs.get("predictions")
