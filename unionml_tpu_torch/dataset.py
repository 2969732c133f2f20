"""Dataset: declarative data source, splitting, parsing, and feature pipeline.

Capability parity with reference unionml/dataset.py:35-510, redesigned
array-first for TPU: the canonical in-memory format is numpy/JAX arrays (a
pandas adapter is kept for tabular workflows, matching the reference's
pandas-first defaults). The reader compiles into a named, cacheable
:class:`~unionml_tpu_torch.stage.Stage`; the loader→splitter→parser pipeline runs
host-side and feeds the device data path
(:mod:`unionml_tpu_torch.data.pipeline`).

Registration points (all decoration-time type-checked, reference
dataset.py:95-205):

- ``reader`` (required): fetch raw data, annotated return type defines the
  dataset datatype.
- ``loader``: raw → loaded form (e.g. JSON str → DataFrame).
- ``splitter``: loaded → train/test splits.
- ``parser``: one split → model-ready tuple (features, targets).
- ``feature_loader``: raw serving input → loaded features.
- ``feature_transformer``: loaded features → model-ready features.
"""

from __future__ import annotations

import json
from dataclasses import field, make_dataclass
from enum import Enum
from inspect import Parameter

from unionml_tpu_torch.type_guards import signature
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union, get_args

import numpy as np

from unionml_tpu_torch import type_guards
from unionml_tpu_torch.stage import Stage, stage_from_fn
from unionml_tpu_torch.tracking import TrackedInstance


class ReaderReturnTypeSource(Enum):
    """Which registered fn determines the dataset datatype (reference: dataset.py:30)."""

    READER = "reader"
    LOADER = "loader"


class Dataset(TrackedInstance):
    """Declarative dataset spec (reference: unionml/dataset.py:35)."""

    def __init__(
        self,
        name: str = "dataset",
        *,
        features: Optional[List[str]] = None,
        targets: Optional[List[str]] = None,
        test_size: float = 0.2,
        shuffle: bool = True,
        random_state: int = 12345,
    ):
        super().__init__()
        self.name = name
        self._features = features
        self._targets = targets or []
        self._test_size = test_size
        self._shuffle = shuffle
        self._random_state = random_state

        self._reader: Optional[Callable] = None
        self._reader_task_kwargs: Dict[str, Any] = {}
        self._loader: Callable = self._default_loader
        self._splitter: Callable = self._default_splitter
        self._parser: Callable = self._default_parser
        self._parser_feature_key: int = 0
        self._feature_loader: Callable = self._default_feature_loader
        self._feature_transformer: Callable = self._default_feature_transformer

        self._dataset_task: Optional[Stage] = None
        self._dataset_datatype: Optional[Dict[str, Any]] = None
        self._reader_input_types: Optional[List[Parameter]] = None
        self._loader_kwargs_type: Optional[type] = None
        self._splitter_kwargs_type: Optional[type] = None
        self._parser_kwargs_type: Optional[type] = None

    # ------------------------------------------------------------------ #
    # registration decorators (reference: dataset.py:95-205)
    # ------------------------------------------------------------------ #

    def reader(self, fn=None, **reader_task_kwargs):
        """Register the data reader; ``**reader_task_kwargs`` forward stage
        knobs like ``cache=True, cache_version="1"`` and ``resources=``
        (reference: dataset.py:95-108; caching used by the quickdraw
        template)."""
        if fn is None:
            return lambda f: self.reader(f, **reader_task_kwargs)
        type_guards.guard_reader(fn)
        self._reader = fn
        self._reader_task_kwargs = reader_task_kwargs
        self._dataset_task = None
        return fn

    def loader(self, fn):
        """Register raw-data loader (reference: dataset.py:110-123)."""
        type_guards.guard_loader(fn, self._reader_datatype())
        self._loader = fn
        self._loader_kwargs_type = None
        return fn

    def splitter(self, fn):
        """Register train/test splitter (reference: dataset.py:125-148)."""
        type_guards.guard_splitter(fn, self.dataset_datatype["data"], self.dataset_datatype_source.value)
        self._splitter = fn
        self._splitter_kwargs_type = None
        return fn

    def parser(self, fn=None, feature_key: int = 0):
        """Register split parser; ``feature_key`` indexes the features element
        in the parser output tuple (reference: dataset.py:150-174)."""
        if fn is None:
            return lambda f: self.parser(f, feature_key=feature_key)
        type_guards.guard_parser(fn, self.dataset_datatype["data"], self.dataset_datatype_source.value)
        self._parser = fn
        self._parser_feature_key = feature_key
        self._parser_kwargs_type = None
        return fn

    def feature_loader(self, fn):
        """Register raw-serving-input loader (reference: dataset.py:176-190)."""
        type_guards.guard_feature_loader(fn)
        self._feature_loader = fn
        return fn

    def feature_transformer(self, fn):
        """Register features transformer (reference: dataset.py:192-205)."""
        type_guards.guard_feature_transformer(fn)
        self._feature_transformer = fn
        return fn

    # ------------------------------------------------------------------ #
    # canonical kwargs + dynamic dataclass synthesis
    # (reference: dataset.py:207-272)
    # ------------------------------------------------------------------ #

    @property
    def splitter_kwargs(self) -> Dict[str, Any]:
        """Canonical kwargs always forwarded to the splitter
        (reference: dataset.py:207-214)."""
        return {
            "test_size": self._test_size,
            "shuffle": self._shuffle,
            "random_state": self._random_state,
        }

    @property
    def parser_kwargs(self) -> Dict[str, Any]:
        """Canonical kwargs always forwarded to the parser
        (reference: dataset.py:216-222)."""
        return {"features": self._features, "targets": self._targets}

    @staticmethod
    def _fn_default_kwargs(fn: Callable) -> Dict[str, Any]:
        """Keyword defaults of ``fn`` past its first (data) argument."""
        out: Dict[str, Any] = {}
        for i, (k, p) in enumerate(signature(fn).parameters.items()):
            if i == 0 or p.kind in (Parameter.VAR_KEYWORD, Parameter.VAR_POSITIONAL):
                continue
            if p.default is not Parameter.empty:
                out[k] = p.default
        return out

    def _make_kwargs_type(self, type_name: str, fn: Callable, defaults: Dict[str, Any]) -> type:
        """Synthesize a dataclass from ``fn``'s post-data keyword interface
        (reference: dataset.py:224-272)."""
        fields = []
        for i, (k, p) in enumerate(signature(fn).parameters.items()):
            if i == 0 or p.kind in (Parameter.VAR_KEYWORD, Parameter.VAR_POSITIONAL):
                continue
            annotation = p.annotation if p.annotation is not Parameter.empty else Any
            if k in defaults:
                default = defaults[k]
            elif p.default is not Parameter.empty:
                default = p.default
            else:
                fields.append((k, annotation))
                continue
            # mutable defaults need default_factory (reference: dataset.py:224-231)
            if isinstance(default, (list, dict, set)):
                fields.append(
                    (k, annotation, field(default_factory=lambda d=default: d))
                )
            else:
                fields.append((k, annotation, default))
        return make_dataclass(type_name, fields)

    @property
    def loader_kwargs_type(self) -> type:
        if self._loader_kwargs_type is None:
            self._loader_kwargs_type = self._make_kwargs_type(
                "LoaderKwargs", self._loader, self._fn_default_kwargs(self._loader)
            )
        return self._loader_kwargs_type

    @property
    def splitter_kwargs_type(self) -> type:
        if self._splitter_kwargs_type is None:
            self._splitter_kwargs_type = self._make_kwargs_type(
                "SplitterKwargs", self._splitter, self.splitter_kwargs
            )
        return self._splitter_kwargs_type

    @property
    def parser_kwargs_type(self) -> type:
        if self._parser_kwargs_type is None:
            self._parser_kwargs_type = self._make_kwargs_type(
                "ParserKwargs", self._parser, self.parser_kwargs
            )
        return self._parser_kwargs_type

    # ------------------------------------------------------------------ #
    # compilation + execution (reference: dataset.py:274-345)
    # ------------------------------------------------------------------ #

    def dataset_task(self) -> Stage:
        """Compile the reader into a named stage (reference: dataset.py:274-292)."""
        if self._dataset_task is not None:
            return self._dataset_task
        if self._reader is None:
            raise ValueError(
                f"Dataset {self.name!r} has no reader. Register one with @dataset.reader."
            )
        reader = self._reader
        reader_sig = signature(reader)

        def dataset_task(**kwargs):
            return reader(**kwargs)

        self._dataset_task = stage_from_fn(
            dataset_task,
            owner=self,
            name=f"{self.name}.reader",
            parameters=list(reader_sig.parameters.values()),
            return_annotation=reader_sig.return_annotation,
            stage_method="dataset_task",
            **self._reader_task_kwargs,
        )
        return self._dataset_task

    def get_data(
        self,
        raw_data,
        loader_kwargs: Optional[Dict[str, Any]] = None,
        splitter_kwargs: Optional[Dict[str, Any]] = None,
        parser_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """raw → loaded → split → parsed, keyed ``{"train": ..., "test": ...}``
        (reference: dataset.py:294-334)."""
        loader_kwargs = {**(loader_kwargs or {})}
        splitter_kwargs = {**self.splitter_kwargs, **(splitter_kwargs or {})}
        parser_kwargs = {**self.parser_kwargs, **(parser_kwargs or {})}

        data = self._loader(raw_data, **loader_kwargs)
        splits = self._splitter(data, **splitter_kwargs)
        if len(splits) == 1:
            return {"train": self._parser(splits[0], **parser_kwargs)}
        train_split, test_split = splits
        return {
            "train": self._parser(train_split, **parser_kwargs),
            "test": self._parser(test_split, **parser_kwargs),
        }

    def get_features(self, features) -> Any:
        """raw serving input → model-ready features (reference: dataset.py:336-345)."""
        return self._feature_transformer(self._feature_loader(features))

    # ------------------------------------------------------------------ #
    # type introspection (reference: dataset.py:348-408)
    # ------------------------------------------------------------------ #

    def _reader_datatype(self) -> Any:
        if self._reader is not None:
            return signature(self._reader).return_annotation
        if self._dataset_datatype is not None:
            return self._dataset_datatype["data"]
        return Any

    @property
    def reader_input_types(self) -> Optional[List[Parameter]]:
        if self._reader is not None and self._reader_input_types is None:
            return list(signature(self._reader).parameters.values())
        return self._reader_input_types

    @property
    def dataset_datatype(self) -> Dict[str, Any]:
        """Loader return type takes precedence over reader's
        (reference: dataset.py:355-369)."""
        if self._loader != self._default_loader:
            return {"data": signature(self._loader).return_annotation}
        if self._reader is not None:
            return {"data": signature(self._reader).return_annotation}
        if self._dataset_datatype is not None:
            return self._dataset_datatype
        raise ValueError(
            "dataset_datatype is not defined. Define a @dataset.reader with a "
            "return annotation."
        )

    @property
    def dataset_datatype_source(self) -> ReaderReturnTypeSource:
        if self._loader != self._default_loader:
            return ReaderReturnTypeSource.LOADER
        return ReaderReturnTypeSource.READER

    @property
    def parser_return_types(self) -> Tuple[Any, ...]:
        return get_args(signature(self._parser).return_annotation)

    @property
    def feature_type(self) -> Any:
        """Feature type for predictors (reference: dataset.py:385-408)."""
        parser_type = (
            self.dataset_datatype["data"]
            if self._parser == self._default_parser
            else (
                self.parser_return_types[self._parser_feature_key]
                if self.parser_return_types
                else Any
            )
        )
        if self._feature_transformer == self._default_feature_transformer:
            ft_type = signature(self._feature_loader).return_annotation
        else:
            ft_type = signature(self._feature_transformer).return_annotation
        if ft_type is Parameter.empty or ft_type is Any:
            return parser_type
        if parser_type != ft_type and parser_type not in (Parameter.empty, Any):
            return Union[ft_type, parser_type]
        return ft_type

    # ------------------------------------------------------------------ #
    # SQL data sources (reference: dataset.py:426-453)
    # ------------------------------------------------------------------ #

    @classmethod
    def from_sqlite_task(
        cls,
        name: str,
        *,
        db_path: str,
        query_template: str,
        **dataset_kwargs,
    ) -> "Dataset":
        """Dataset whose reader executes a SQLite query → DataFrame
        (reference: dataset.py:426-439). The query template is formatted
        with the reader kwargs, which become workflow inputs."""
        import pandas as pd

        dataset = cls(name, **dataset_kwargs)

        def reader(**query_kwargs) -> pd.DataFrame:
            import sqlite3

            # sqlite3's context manager only scopes transactions, not the
            # connection — close explicitly to avoid fd leaks in serving
            conn = sqlite3.connect(db_path)
            try:
                return pd.read_sql_query(query_template.format(**query_kwargs), conn)
            finally:
                conn.close()

        # surface the template's format fields as reader inputs
        import string

        field_names = [f for _, f, _, _ in string.Formatter().parse(query_template) if f]
        params = [Parameter(f, Parameter.KEYWORD_ONLY, annotation=Any) for f in field_names]
        reader.__signature__ = signature(reader).replace(
            parameters=params, return_annotation=pd.DataFrame
        )
        reader.__annotations__ = {f: Any for f in field_names}
        reader.__annotations__["return"] = pd.DataFrame
        dataset.reader(reader)
        return dataset

    @classmethod
    def from_sqlalchemy_task(
        cls,
        name: str,
        *,
        uri: str,
        query_template: str,
        **dataset_kwargs,
    ) -> "Dataset":
        """Dataset whose reader executes a SQLAlchemy query → DataFrame
        (reference: dataset.py:441-453)."""
        import pandas as pd

        dataset = cls(name, **dataset_kwargs)

        def reader(**query_kwargs) -> pd.DataFrame:
            import sqlalchemy  # gated: optional dependency

            engine = sqlalchemy.create_engine(uri)
            with engine.connect() as conn:
                return pd.read_sql_query(query_template.format(**query_kwargs), conn)

        import string

        field_names = [f for _, f, _, _ in string.Formatter().parse(query_template) if f]
        params = [Parameter(f, Parameter.KEYWORD_ONLY, annotation=Any) for f in field_names]
        reader.__signature__ = signature(reader).replace(
            parameters=params, return_annotation=pd.DataFrame
        )
        reader.__annotations__ = {f: Any for f in field_names}
        reader.__annotations__["return"] = pd.DataFrame
        dataset.reader(reader)
        return dataset

    # ------------------------------------------------------------------ #
    # array-first defaults (reference pandas defaults: dataset.py:455-510)
    # ------------------------------------------------------------------ #

    def _default_loader(self, data):
        """Identity: reader output is already the loaded form
        (reference: dataset.py:455-459)."""
        return data

    @staticmethod
    def _is_xy_pair(data) -> bool:
        """True for an ``(X, y)`` tuple of equal-length array-likes (the
        array-first reader contract) — vs. a plain 2-element sequence."""
        return (
            isinstance(data, (tuple, list))
            and len(data) == 2
            and any(hasattr(el, "shape") or hasattr(el, "iloc") for el in data)
            and all(hasattr(el, "__len__") for el in data)
            and len(data[0]) == len(data[1])
        )

    def _default_splitter(self, data, test_size: float, shuffle: bool, random_state: int):
        """Split DataFrames, arrays, (X, y) pairs, or sequences into
        (train, test) (reference sklearn-based splitter: dataset.py:461-470;
        rewritten with a numpy RNG so the core has no sklearn dependency)."""

        def take(d, idx):
            if hasattr(d, "iloc"):  # pandas
                return d.iloc[idx]
            if hasattr(d, "shape"):  # numpy/jax array
                return d[idx]
            return [d[int(i)] for i in idx]

        xy_pair = self._is_xy_pair(data)
        n = len(data[0]) if xy_pair else len(data)
        indices = np.arange(n)
        if shuffle:
            rng = np.random.default_rng(random_state)
            rng.shuffle(indices)
        n_test = int(np.floor(n * test_size))
        test_idx, train_idx = indices[:n_test], indices[n_test:]

        if xy_pair:  # split X and y along rows with shared indices
            return (
                tuple(take(el, train_idx) for el in data),
                tuple(take(el, test_idx) for el in data),
            )
        return take(data, train_idx), take(data, test_idx)

    def _default_parser(self, data, features: Optional[List[str]], targets: List[str]):
        """Split one data split into (features, targets)
        (reference: dataset.py:472-487).

        - pandas DataFrame: select feature/target columns.
        - dict of arrays: ``features``/``targets`` name keys.
        - tuple/list of two arrays: passthrough ``(X, y)``.
        """
        if hasattr(data, "loc"):  # pandas DataFrame
            if not features:
                features = [c for c in data.columns if c not in targets]
            try:
                target_frame = data[targets]
            except KeyError:
                target_frame = data.head(0)[[]]  # serving features: no targets
            return [data[features], target_frame]
        if isinstance(data, dict):
            feat = data["features"] if "features" in data else data[(features or ["x"])[0]]
            targ = data.get("targets")
            if targ is None and targets:
                targ = data.get(targets[0])
            return [feat, targ]
        if isinstance(data, (tuple, list)) and len(data) == 2:
            return [data[0], data[1]]
        return [data, None]

    def _default_feature_loader(self, features):
        """Accept a file path / JSON string / dict / list / array and return
        loaded features (reference: dataset.py:489-503). pandas is imported
        only on the tabular branches so array-first apps run pandas-free."""
        if isinstance(features, (str, Path)) and Path(str(features)).exists():
            with open(features) as f:
                features = json.load(f)
        elif isinstance(features, (str, bytes)):
            features = json.loads(features)
        if isinstance(features, np.ndarray):
            return features
        if hasattr(features, "loc"):  # already a DataFrame
            return features
        if isinstance(features, dict):
            import pandas as pd

            return pd.DataFrame(features)
        if isinstance(features, list) and features and isinstance(features[0], dict):
            import pandas as pd

            return pd.DataFrame.from_records(features)
        return np.asarray(features)

    def _default_feature_transformer(self, features):
        """Identity, after aligning DataFrame columns to the declared feature
        list (reference: dataset.py:505-510)."""
        if hasattr(features, "loc") and self._features:
            cols = [c for c in self._features if c in features.columns]
            if cols:
                return features[cols]
        return features
