"""The port's public surface against the JAX package's.

For every module of ``unionml_tpu`` (its templates apart: they are apps,
ported with their own tests), each public name the module defines (a
top-level function, class or assignment not starting with ``_``) or
lists in ``__all__`` must exist in the port module at the same path.
The reference's modules are read as source (nothing of JAX is imported
for this); the port's are imported. A name or module the port does not
carry must be listed in :data:`DIVERGENCES` with its counterpart and why;
an entry that no longer matches a gap fails too, so the list stays the
port's whole set of chosen differences.
"""

import ast
import importlib
from pathlib import Path

import pytest

import torch_threads

torch_threads.share_cores()

REPO = Path(__file__).resolve().parent.parent
REFERENCE = REPO / "unionml_tpu"

#: ``module`` (``module.name`` for one name) -> (the port's counterpart,
#: ``module.name`` or ``module``, or None; why)
DIVERGENCES = {
    "remote.TPUVMBackend": (
        "remote.GPUHostBackend",
        "the port provisions GPU hosts, not TPU VMs (same BaseBackend contract)"),
    "remote.backend.TPUVMBackend": (
        "remote.backend.GPUHostBackend",
        "the port provisions GPU hosts, not TPU VMs (same BaseBackend contract)"),
    "ops.paged_attention.paged_attention_reference": (
        "ops.paged_attention.paged_attention_plain",
        "every kernel's plain PyTorch version is named *_plain in the port"),
    "model.is_jax_pytree": (
        None, "the port drops JAX: models are torch modules and tensor trees"),
    "model.is_keras_model": (
        None, "the port drops Keras (importing TensorFlow pulls in JAX)"),
    "serving._stats": (
        "telemetry",
        "the port keeps percentile_summary in telemetry, its one home"),
}


def _public(path: Path) -> set:
    """The names ``path`` defines at top level (inside top-level ``if`` /
    ``try`` blocks too) that do not start with ``_``, and its literal
    ``__all__``."""
    names, listed = set(), set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for target in targets:
                    if isinstance(target, ast.Name) and target.id == "__all__":
                        listed.update(ast.literal_eval(node.value))
                    elif isinstance(target, ast.Name):
                        names.add(target.id)
            elif isinstance(node, ast.Try):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)

    visit(ast.parse(path.read_text()).body)
    return {n for n in names if not n.startswith("_")} | listed


def _modules() -> dict:
    """``module path`` (``serving.engine``; ``""`` for the package) ->
    its file, for every reference module but the templates."""
    out = {}
    for path in sorted(REFERENCE.rglob("*.py")):
        rel = path.relative_to(REFERENCE).with_suffix("")
        if rel.parts[0] == "templates":
            continue
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out[".".join(parts)] = path
    return out


MODULES = _modules()


def _port(module: str):
    return importlib.import_module("unionml_tpu_torch" + (f".{module}" if module else ""))


def _gaps(module: str) -> list:
    """The reference's public names of ``module`` the port module lacks
    (``["*"]`` when the port has no such module)."""
    try:
        port = _port(module)
    except ModuleNotFoundError:
        return ["*"]
    return sorted(n for n in _public(MODULES[module]) if not hasattr(port, n))


def _resolves(counterpart: str) -> bool:
    """Whether ``module`` or ``module.name`` exists in the port."""
    try:
        _port(counterpart)
        return True
    except ModuleNotFoundError:
        module, _, name = counterpart.rpartition(".")
        return hasattr(_port(module), name)


@pytest.mark.parametrize("module", sorted(MODULES), ids=lambda m: m or "unionml_tpu")
def test_every_public_name_has_a_port(module):
    unexplained = []
    for name in _gaps(module):
        key = module if name == "*" else f"{module}.{name}" if module else name
        if key not in DIVERGENCES:
            unexplained.append(key)
            continue
        counterpart, why = DIVERGENCES[key]
        assert why, key
        if counterpart is not None:
            assert _resolves(counterpart), f"{key}: its counterpart {counterpart} is not in the port"
    assert not unexplained, (
        f"unionml_tpu.{module or ''} has public names the port lacks: {unexplained} "
        "(port them, or list each in DIVERGENCES with its counterpart and why)")


def test_the_divergences_are_still_gaps():
    """Every DIVERGENCES entry names a reference module or name the port
    really lacks, and its counterpart exists."""
    for key, (counterpart, why) in DIVERGENCES.items():
        if key in MODULES:
            assert _gaps(key) == ["*"], f"{key} now exists in the port: drop its entry"
        else:
            module, _, name = key.rpartition(".")
            assert name in _public(MODULES[module]), f"{key} is not in the reference"
            assert name in _gaps(module), f"{key} now exists in the port: drop its entry"
        if counterpart is not None:
            assert _resolves(counterpart), counterpart
        assert why


def test_the_stats_module_s_names_live_in_telemetry():
    """``serving/_stats.py``'s names are all in the port's telemetry."""
    telemetry = _port("telemetry")
    assert all(hasattr(telemetry, n) for n in _public(MODULES["serving._stats"]))
