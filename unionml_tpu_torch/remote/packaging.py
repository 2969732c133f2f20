"""App versioning + source packaging.

The port of :mod:`unionml_tpu.remote.packaging`: the same versioning and
source packaging; the environment it describes is the port's
(``unionml_tpu_torch`` and the ``torch`` extra of ``pyproject.toml``).

Reference behavior being replicated:
- ``get_app_version`` (remote.py:43-57): version = git HEAD SHA; raises
  :class:`VersionFetchError` on a dirty tree unless ``allow_uncommitted``.
- fast/patch registration (remote.py:126-138): package source only,
  skipping the expensive image build — here the "image" is the full
  deployment copy and a patch overlays source files onto an existing
  deployment.

git is invoked via subprocess (no gitpython dependency).
"""

from __future__ import annotations

import shutil
import subprocess
import uuid
from pathlib import Path
from typing import Iterable, Optional

EXCLUDE_DIRS = {".git", "__pycache__", ".pytest_cache", ".unionml_tpu", ".unionml_tpu_torch",
                ".cache", "node_modules"}


class VersionFetchError(RuntimeError):
    """Raised when an app version cannot be derived (reference: remote.py:24)."""


def _git(args, cwd=None) -> str:
    out = subprocess.run(
        ["git", *args], cwd=cwd, capture_output=True, text=True, check=True
    )
    return out.stdout.strip()


def get_app_version(allow_uncommitted: bool = False, cwd: Optional[str] = None) -> str:
    """Git-SHA app version with dirty-tree guard (reference: remote.py:43-57)."""
    try:
        dirty = _git(["status", "--porcelain"], cwd=cwd)
        if dirty and not allow_uncommitted:
            raise VersionFetchError(
                "Git working tree has uncommitted changes; commit them or pass "
                "allow_uncommitted=True to version the app anyway."
            )
        sha = _git(["rev-parse", "HEAD"], cwd=cwd)
        return sha[:7] if not dirty else f"{sha[:7]}-dirty"
    except subprocess.CalledProcessError as exc:
        raise VersionFetchError(
            f"Could not derive app version from git: {exc.stderr or exc}"
        ) from exc
    except FileNotFoundError as exc:
        raise VersionFetchError("git binary not found") from exc


def patch_suffix() -> str:
    """Short unique suffix for patch versions (reference: model.py:700-701)."""
    return uuid.uuid4().hex[:8]


def iter_source_files(src: Path) -> Iterable[Path]:
    for path in sorted(src.rglob("*")):
        rel = path.relative_to(src)
        if any(part in EXCLUDE_DIRS for part in rel.parts):
            continue
        if path.is_file():
            yield path


def framework_root() -> Path:
    """Repo root of the installed-from-source framework (has pyproject.toml)."""
    return Path(__file__).resolve().parents[2]


def _parse_dependencies_toml(
    text: str, table: str = "project", key: str = "dependencies"
) -> list:
    """The ``[table] key = [...]`` array (by default ``[project]
    dependencies``) as a list of spec strings, parsed textually for hosts
    without :mod:`tomllib` (Python < 3.11). Handles the shape this repo's
    pyproject.toml uses — one bracketed array of quoted strings with
    optional ``#`` comments — including specs that themselves contain
    brackets (``"torch[opt]>=2.4"``): the closing ``]`` only terminates
    the array when scanned OUTSIDE a quoted string."""
    import re

    in_project = False
    buf = None
    done = False
    for line in text.splitlines():
        stripped = line.strip()
        if buf is None:
            if stripped.startswith("["):
                in_project = stripped == f"[{table}]"
                continue
            match = (
                re.match(rf"{re.escape(key)}\s*=\s*\[", stripped)
                if in_project else None
            )
            if match is None:
                continue
            buf = ""
            stripped = stripped[match.end():]
        # append up to the first closing bracket outside quotes
        quote = None
        for i, ch in enumerate(stripped):
            if quote is not None:
                if ch == quote:
                    quote = None
            elif ch in "\"'":
                quote = ch
            elif ch == "#":        # comment: rest of line ignored
                stripped = stripped[:i]
                break
            elif ch == "]":
                stripped = stripped[:i]
                done = True
                break
        buf += stripped
        if done:
            break
    if buf is None:
        raise KeyError(key)
    return [
        a or b for a, b in re.findall(r'"([^"]+)"|\'([^\']+)\'', buf)
    ]


#: where the port's runtime dependencies live in pyproject.toml: the
#: ``torch`` extra (the ``[project]`` dependencies are the JAX package's)
_DEPS_TABLE = ("project.optional-dependencies", "torch")


def pinned_requirements() -> str:
    """``name==version`` lines for the port's runtime dependencies (the
    ``torch`` extra of ``pyproject.toml``).

    The pins come from the versions importable HERE, so a provisioned host
    reproduces the deploying machine's environment — the role the
    reference's docker image plays (reference: remote.py:69-108). Deps
    that aren't installed locally fall back to the unpinned spec.
    """
    import re
    from importlib import metadata

    try:
        import tomllib  # Python >= 3.11
    except ModuleNotFoundError:
        tomllib = None
    try:
        pyproject = framework_root() / "pyproject.toml"
        if tomllib is not None:
            with open(pyproject, "rb") as f:
                specs = tomllib.load(f)["project"]["optional-dependencies"][_DEPS_TABLE[1]]
        else:
            # Python 3.10 hosts: extract the array textually — the
            # narrow subset of TOML this file actually uses — instead of
            # shipping an unpinned environment
            specs = _parse_dependencies_toml(pyproject.read_text(), *_DEPS_TABLE)
    except (FileNotFoundError, KeyError):
        specs = []
    lines = []
    for spec in specs:
        name = re.split(r"[><=!~\[;]", spec, maxsplit=1)[0].strip()
        try:
            lines.append(f"{name}=={metadata.version(name)}")
        except metadata.PackageNotFoundError:
            lines.append(spec)
    return "\n".join(lines) + "\n"


def _port_pyproject(text: str) -> str:
    """A ``pyproject.toml`` for the port alone, from the repo's ``text``.

    The repo's own file names the JAX package's distribution
    (``unionml_tpu``) and its dependencies; a wheel built from it and
    force-reinstalled on a host would replace a JAX installation there.
    This one names ``unionml_tpu_torch`` and the ``torch`` extra.
    """
    import re

    version = re.search(r'^version\s*=\s*"([^"]+)"', text, re.M).group(1)
    deps = ", ".join(f'"{d}"' for d in _parse_dependencies_toml(text, *_DEPS_TABLE))
    return (
        '[build-system]\nrequires = ["setuptools>=68"]\n'
        'build-backend = "setuptools.build_meta"\n\n'
        f'[project]\nname = "unionml_tpu_torch"\nversion = "{version}"\n'
        f'requires-python = ">=3.10"\ndependencies = [{deps}]\n\n'
        '[project.scripts]\nunionml-tpu-torch = "unionml_tpu_torch.cli:app"\n\n'
        '[tool.setuptools.packages.find]\ninclude = ["unionml_tpu_torch*"]\n\n'
        '[tool.setuptools.package-data]\n'
        'unionml_tpu_torch = ["templates/**/*", "csrc/*.cu", "csrc/*.cuh"]\n'
    )


def build_environment_bundle(dest_dir) -> Path:
    """Build the deployable environment under ``{dest}/_env``.

    Contents: the framework wheel (``unionml_tpu_torch``, built offline
    via ``pip wheel --no-deps --no-build-isolation`` from
    :func:`_port_pyproject`) and ``requirements.lock`` (pinned runtime
    deps). :class:`~unionml_tpu_torch.remote.backend.GPUHostBackend`
    pip-installs the bundle on every host at deploy time — the analog of
    the reference's image build+push (remote.py:69-108) without a
    container registry in the loop.
    """
    import subprocess
    import sys
    import tempfile

    env_dir = Path(dest_dir) / "_env"
    env_dir.mkdir(parents=True, exist_ok=True)
    root = framework_root()
    if not (root / "pyproject.toml").exists():
        raise RuntimeError(
            "environment provisioning requires a source checkout of "
            f"unionml_tpu_torch (no pyproject.toml at {root}); for a pip-installed "
            "framework, pre-provision the hosts and set provision: false in "
            "the backend config"
        )
    with tempfile.TemporaryDirectory(prefix="unionml_tpu_torch_wheel_") as tmp:
        # build from a minimal copy: setuptools writes build/ + *.egg-info
        # into the source dir, which would dirty the git tree and trip the
        # get_app_version dirty-tree guard on the next deploy
        stage = Path(tmp) / "src"
        stage.mkdir()
        (stage / "pyproject.toml").write_text(
            _port_pyproject((root / "pyproject.toml").read_text()))
        shutil.copytree(
            root / "unionml_tpu_torch", stage / "unionml_tpu_torch",
            ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so"),
        )
        proc = subprocess.run(
            [sys.executable, "-m", "pip", "wheel", "--no-deps",
             "--no-build-isolation", "-w", str(env_dir), str(stage)],
            capture_output=True, text=True,
        )
    if proc.returncode != 0:
        raise RuntimeError(f"framework wheel build failed:\n{proc.stderr[-1000:]}")
    (env_dir / "requirements.lock").write_text(pinned_requirements())
    return env_dir


def package_source(src_dir, dest_dir, *, patch: bool = False) -> int:
    """Copy the app source tree into a deployment directory.

    Full mode replaces ``dest_dir``; patch mode overlays files onto the
    existing deployment (the fast-registration analog,
    reference remote.py:126-138). Returns the number of files packaged.
    """
    src, dest = Path(src_dir), Path(dest_dir)
    if not patch and dest.exists():
        shutil.rmtree(dest)
    dest.mkdir(parents=True, exist_ok=True)
    count = 0
    for f in iter_source_files(src):
        target = dest / f.relative_to(src)
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(f, target)
        count += 1
    return count
