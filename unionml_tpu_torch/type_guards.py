"""Decoration-time signature contracts for user functions.

Capability parity with reference unionml/type_guards.py:79-191: every
registered function is checked at decoration time so that spec errors
surface immediately with a helpful message, not at execution time.

Differences from the reference are deliberate and TPU-motivated:
- ``typing.Any`` and missing dataset types are tolerated permissively (a
  JAX pytree has no single static type), but *declared* annotations must
  agree.
- JAX array / pytree types are treated as compatible with numpy array
  annotations, since host staging converts between them.
"""

from __future__ import annotations

import inspect
import typing
from inspect import Parameter
from typing import Any, Callable, Dict, Iterable, Mapping


def signature(fn: Callable) -> inspect.Signature:
    """``inspect.signature`` resolving PEP 563 string annotations.

    User app modules often use ``from __future__ import annotations``;
    guards must compare real types, not their string forms. Falls back to
    unresolved strings when a name can't be evaluated (the permissive
    ``_is_compatible`` then treats only exact matches as compatible).
    """
    try:
        return inspect.signature(fn, eval_str=True)
    except (NameError, TypeError, ValueError):
        return inspect.signature(fn)

# canonical keyword interfaces (reference: type_guards.py:12-22)
SPLITTER_KWARGS = {"test_size": float, "shuffle": bool, "random_state": int}
PARSER_KWARGS = {"features": typing.Optional[typing.List[str]], "targets": typing.List[str]}


class SignatureError(TypeError):
    """Raised when a registered function's signature violates its contract."""


def _type_name(t: Any) -> str:
    return getattr(t, "__name__", str(t))


def _is_compatible(actual: Any, expected: Any) -> bool:
    """Union-aware type compatibility (reference: type_guards.py:28-40).

    ``actual`` is compatible with ``expected`` when they are equal, either
    side is ``Any``/unannotated, or when one is a Union whose args contain
    (or are contained by) the other side's args.
    """
    if expected is None or actual is None:
        return True
    if actual is Any or expected is Any:
        return True
    if actual is Parameter.empty or expected is Parameter.empty:
        return True
    if actual == expected:
        return True

    actual_args = set(typing.get_args(actual)) if _is_union(actual) else {actual}
    expected_args = set(typing.get_args(expected)) if _is_union(expected) else {expected}
    if actual_args & expected_args:
        return True
    # generic aliases: compare origins (List[float] vs list, etc.)
    a_origin = {typing.get_origin(t) or t for t in actual_args}
    e_origin = {typing.get_origin(t) or t for t in expected_args}
    return bool(a_origin & e_origin) and _args_overlap(actual, expected)


def _is_union(t: Any) -> bool:
    origin = typing.get_origin(t)
    if origin is typing.Union:
        return True
    # PEP 604 `X | Y`
    return type(t).__name__ == "UnionType"


def _args_overlap(actual: Any, expected: Any) -> bool:
    a_args, e_args = typing.get_args(actual), typing.get_args(expected)
    if not a_args or not e_args:
        return True
    return all(_is_compatible(a, e) for a, e in zip(a_args, e_args))


def _positional_params(fn: Callable) -> Dict[str, Parameter]:
    return {
        k: p
        for k, p in signature(fn).parameters.items()
        if p.kind in (Parameter.POSITIONAL_ONLY, Parameter.POSITIONAL_OR_KEYWORD)
    }


def _check_kwargs_accepted(fn_name: str, fn: Callable, kwtypes: Mapping[str, Any]) -> None:
    """Check that ``fn`` accepts the canonical keyword interface.

    Reference: type_guards.py:60-70. Functions may accept ``**kwargs`` to
    satisfy the contract wholesale.
    """
    params = signature(fn).parameters
    if any(p.kind is Parameter.VAR_KEYWORD for p in params.values()):
        return
    for key in kwtypes:
        if key not in params:
            raise SignatureError(
                f"'{fn_name}' must accept a '{key}' keyword argument "
                f"(canonical interface: {sorted(kwtypes)})."
            )


def guard_reader(reader: Callable) -> None:
    """Reader must declare a return annotation (reference: type_guards.py:79-85)."""
    ret = signature(reader).return_annotation
    if ret is inspect.Signature.empty:
        raise SignatureError(
            "The 'reader' function must have a return type annotation — it "
            "defines the dataset datatype for every downstream function."
        )


def guard_loader(loader: Callable, expected_data_type: Any) -> None:
    """Loader first arg must match the dataset datatype (reference: type_guards.py:88-92)."""
    params = _positional_params(loader)
    if not params:
        raise SignatureError("'loader' must take the raw dataset as its first argument.")
    first = next(iter(params.values()))
    if not _is_compatible(first.annotation, expected_data_type):
        raise SignatureError(
            f"'loader' first argument must be of type {_type_name(expected_data_type)}, "
            f"found {_type_name(first.annotation)}."
        )


def guard_splitter(splitter: Callable, expected_data_type: Any, source: str) -> None:
    """Splitter contract (reference: type_guards.py:95-104)."""
    params = _positional_params(splitter)
    if not params:
        raise SignatureError("'splitter' must take the loaded dataset as its first argument.")
    first = next(iter(params.values()))
    if not _is_compatible(first.annotation, expected_data_type):
        raise SignatureError(
            f"'splitter' first argument must match the {source} return type "
            f"{_type_name(expected_data_type)}, found {_type_name(first.annotation)}."
        )
    _check_kwargs_accepted("splitter", splitter, SPLITTER_KWARGS)


def guard_parser(parser: Callable, expected_data_type: Any, source: str) -> None:
    """Parser contract (reference: type_guards.py:107-115)."""
    params = _positional_params(parser)
    if not params:
        raise SignatureError("'parser' must take one data split as its first argument.")
    first = next(iter(params.values()))
    if not _is_compatible(first.annotation, expected_data_type):
        raise SignatureError(
            f"'parser' first argument must match the {source} return type "
            f"{_type_name(expected_data_type)}, found {_type_name(first.annotation)}."
        )
    _check_kwargs_accepted("parser", parser, PARSER_KWARGS)


def guard_trainer(
    trainer: Callable, expected_model_type: Any, expected_data_types: Iterable[Any]
) -> None:
    """Trainer contract (reference: type_guards.py:118-132).

    First argument and return type must be the model type; subsequent
    positional args must match the parsed-data types.
    """
    sig = signature(trainer)
    params = list(_positional_params(trainer).values())
    if not params:
        raise SignatureError("'trainer' must take the model object as its first argument.")
    if not _is_compatible(params[0].annotation, expected_model_type):
        raise SignatureError(
            f"'trainer' first argument must be the model type "
            f"{_type_name(expected_model_type)}, found {_type_name(params[0].annotation)}."
        )
    if not _is_compatible(sig.return_annotation, expected_model_type):
        raise SignatureError(
            f"'trainer' must return the model type {_type_name(expected_model_type)}, "
            f"found {_type_name(sig.return_annotation)}."
        )
    data_params = params[1:]
    expected = list(expected_data_types)
    if expected and data_params and len(data_params) > len(expected):
        raise SignatureError(
            f"'trainer' takes {len(data_params)} data arguments but the parser "
            f"produces {len(expected)} outputs."
        )
    for p, t in zip(data_params, expected):
        if not _is_compatible(p.annotation, t):
            raise SignatureError(
                f"'trainer' data argument '{p.name}' must be of type {_type_name(t)}, "
                f"found {_type_name(p.annotation)}."
            )


def guard_train_step(step: Callable) -> None:
    """A jittable step must accept exactly (state, batch) positionally.

    No reference counterpart (train_step is the TPU-native tier); same
    decoration-time contract philosophy as the reference's guards —
    misregistered steps fail at registration with a named error, not at
    first jit trace.
    """
    sig = signature(step)
    all_params = list(sig.parameters.values())
    params = [
        p
        for p in all_params
        if p.kind in (Parameter.POSITIONAL_ONLY, Parameter.POSITIONAL_OR_KEYWORD)
    ]
    has_var_pos = any(p.kind is Parameter.VAR_POSITIONAL for p in all_params)
    required = [p for p in params if p.default is Parameter.empty]
    required_kw_only = [
        p
        for p in all_params
        if p.kind is Parameter.KEYWORD_ONLY and p.default is Parameter.empty
    ]
    if (
        len(required) > 2
        or (len(params) < 2 and not has_var_pos)
        or required_kw_only
    ):
        raise SignatureError(
            f"'train_step' must be callable as step(state, batch) -> "
            f"(state, metrics); got signature {sig}."
        )


def guard_evaluator(
    evaluator: Callable, expected_model_type: Any, expected_data_types: Iterable[Any]
) -> None:
    """Evaluator contract (reference: type_guards.py:135-148)."""
    params = list(_positional_params(evaluator).values())
    if not params:
        raise SignatureError("'evaluator' must take the model object as its first argument.")
    if not _is_compatible(params[0].annotation, expected_model_type):
        raise SignatureError(
            f"'evaluator' first argument must be the model type "
            f"{_type_name(expected_model_type)}, found {_type_name(params[0].annotation)}."
        )
    for p, t in zip(params[1:], list(expected_data_types)):
        if not _is_compatible(p.annotation, t):
            raise SignatureError(
                f"'evaluator' data argument '{p.name}' must be of type {_type_name(t)}, "
                f"found {_type_name(p.annotation)}."
            )


def guard_predictor(predictor: Callable, expected_model_type: Any, expected_data_type: Any) -> None:
    """Predictor contract (reference: type_guards.py:151-169).

    Takes the model object plus exactly one features argument, and must
    declare a return annotation.
    """
    sig = signature(predictor)
    params = list(_positional_params(predictor).values())
    if not params:
        raise SignatureError("'predictor' must take the model object as its first argument.")
    if not _is_compatible(params[0].annotation, expected_model_type):
        raise SignatureError(
            f"'predictor' first argument must be the model type "
            f"{_type_name(expected_model_type)}, found {_type_name(params[0].annotation)}."
        )
    feature_params = params[1:]
    if len(feature_params) != 1:
        raise SignatureError(
            f"'predictor' must take exactly one features argument after the model "
            f"object, found {len(feature_params)}."
        )
    if not _is_compatible(feature_params[0].annotation, expected_data_type):
        raise SignatureError(
            f"'predictor' features argument must be of type "
            f"{_type_name(expected_data_type)}, found "
            f"{_type_name(feature_params[0].annotation)}."
        )
    if sig.return_annotation is inspect.Signature.empty:
        raise SignatureError("'predictor' must have a return type annotation.")


def guard_feature_loader(feature_loader: Callable) -> None:
    """Feature loader takes a single argument (reference: type_guards.py:172-181)."""
    params = list(_positional_params(feature_loader).values())
    if len(params) != 1:
        raise SignatureError(
            f"'feature_loader' must take exactly one argument (the raw features), "
            f"found {len(params)}."
        )


def guard_feature_transformer(feature_transformer: Callable) -> None:
    """Feature transformer takes a single argument (reference: type_guards.py:184-191)."""
    params = list(_positional_params(feature_transformer).values())
    if len(params) != 1:
        raise SignatureError(
            f"'feature_transformer' must take exactly one argument (loaded features), "
            f"found {len(params)}."
        )
