"""Execution backends: local subprocess sandbox + GPU hosts over SSH.

The port of :mod:`unionml_tpu.remote.backend`. The reference delegates
remote execution to a Flyte cluster (admin gRPC + containers; reference
remote.py:111-147, model.py:732-917). Here:

- :class:`LocalBackend` runs each workflow in a **separate process**
  (``python -m unionml_tpu_torch.remote.runner``) with cwd set to the
  versioned deployment directory — a faithful analog of the container
  boundary, and the single-node sandbox the tests use. The framework root
  rides ``PYTHONPATH``, so the runner finds the kernels already built
  under ``build/kernels/`` and builds nothing again.
- :class:`GPUHostBackend` drives GPU hosts over SSH (the counterpart of
  the reference's ``TPUVMBackend``): source is pushed to every host, the
  runner is launched on all of them with the :mod:`torch.distributed`
  env (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``),
  and rank 0's outputs are fetched back.

Both share the registry layout::

    {root}/deployments/{project}/{domain}/{app_version}/   # packaged source
    {root}/executions/{project}/{execution_id}/            # inputs/outputs/status/logs
"""

from __future__ import annotations

import json
import os
import pickle
import re
import subprocess
import sys
import time
import uuid
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.defaults import Resources, cpu_count, resources_env


def _workflow_resources(workflow) -> Resources:
    """The launch-time resource envelope of a workflow: the max over its
    stages (one launcher process hosts the whole DAG, so it must satisfy
    the hungriest stage)."""
    reqs = [node.stage.resources for node in workflow.nodes]
    if not reqs:
        return Resources()
    hungriest = max(reqs, key=lambda r: r.chips)
    return Resources(
        cpu=str(max(cpu_count(r) for r in reqs)),
        mem=max((r.mem for r in reqs), key=_mem_bytes),
        chips=hungriest.chips,
        # the accelerator TYPE must come from the stage that asked for
        # the most chips — pairing max-chips with another stage's type
        # would provision the wrong hardware; if the hungriest stage
        # left it unset, record None honestly rather than guess
        accelerator=hungriest.accelerator,
    )


def _mem_bytes(mem: str) -> int:
    """Parse k8s-style memory ("1Gi", "512Mi", "2G") for comparison."""
    units = {
        "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
        "K": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    }
    raw = str(mem).strip()
    for suffix, mult in sorted(units.items(), key=lambda kv: -len(kv[0])):
        if raw.endswith(suffix):
            try:
                return int(float(raw[: -len(suffix)]) * mult)
            except ValueError:
                return 0
    try:
        return int(float(raw))
    except ValueError:
        return 0


def _model_resources_table(model) -> Dict[str, Dict[str, Any]]:
    """Per-workflow resource records for the deploy manifest. Workflows
    that cannot build yet (a trainer-only app has no predictor) are
    simply absent — deploy must not demand more of the model than
    execution will (the pre-round-4 behavior recorded names only)."""
    table: Dict[str, Dict[str, Any]] = {}
    for build in (
        model.train_workflow,
        model.predict_workflow,
        model.predict_from_features_workflow,
    ):
        try:
            wf = build()
        except ValueError:
            # the registration guards ("has no predictor/trainer") — a
            # trainer-only app legitimately lacks predict workflows.
            # Anything else (a real dataset/model bug) must fail the
            # deploy, not silently drop the workflow's resource record.
            continue
        table[wf.name] = asdict(_workflow_resources(wf))
    return table


def _manifest_env(manifest: Dict[str, Any], workflow: str) -> Dict[str, str]:
    """Runner env derived from the deployed manifest's resource record
    (absent on pre-round-4 manifests → no overrides, old behavior)."""
    table = manifest.get("resources") or {}
    rec = table.get(workflow)
    if rec is None:
        # executions may name workflows by their short form ("train")
        # while the manifest records "<model>.train"
        rec = next(
            (r for name, r in table.items() if name.endswith(f".{workflow}")),
            None,
        )
    if not rec:
        return {}
    return resources_env(Resources(**rec))

DEFAULT_ROOT_ENV = "UNIONML_TPU_HOME"
DEFAULT_ROOT = "~/.unionml_tpu_torch"


@dataclass
class ExecutionRecord:
    """One workflow execution (the FlyteWorkflowExecution analog)."""

    execution_id: str
    project: str
    workflow: str
    app_version: str
    status: str = "QUEUED"  # QUEUED | RUNNING | SUCCEEDED | FAILED
    created_at: float = field(default_factory=time.time)
    exec_dir: str = ""
    console_url: str = ""
    # "" = app-reported failure (deterministic — never worth relaunching);
    # "preempted" = the runner died without reporting (set by the
    # dead-runner detector) — the only failure max_restarts retries
    failure_kind: str = ""

    def save(self):
        # atomic write: wait() polls this file from another process
        path = Path(self.exec_dir) / "record.json"
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(asdict(self)))
        os.replace(tmp, path)

    @classmethod
    def load(cls, exec_dir) -> "ExecutionRecord":
        data = json.loads((Path(exec_dir) / "record.json").read_text())
        return cls(**data)


class BaseBackend:
    def __init__(self, *, project: str, domain: str = "development", root: Optional[str] = None):
        self.project = project
        self.domain = domain
        self.root = Path(
            root or os.environ.get(DEFAULT_ROOT_ENV, DEFAULT_ROOT)
        ).expanduser()

    # ---------- layout ----------

    def deployment_dir(self, app_version: str) -> Path:
        return self.root / "deployments" / self.project / self.domain / app_version

    def executions_dir(self) -> Path:
        return self.root / "executions" / self.project

    def _latest_app_version(self) -> str:
        base = self.root / "deployments" / self.project / self.domain
        if not base.exists():
            raise FileNotFoundError(
                f"no deployments for project {self.project!r}; run remote_deploy first"
            )
        versions = sorted(base.iterdir(), key=lambda p: p.stat().st_mtime)
        return versions[-1].name

    # ---------- deploy ----------

    def deploy(self, model, *, app_version: str, patch: bool = False) -> Path:
        """Package the app source (reference deploy_wf: remote.py:111-147).

        The app source dir is the directory containing the module where the
        Model was defined; the manifest records the ``module:variable``
        loader path (the task-resolver pointer, task_resolver.py:23-31).
        """
        from unionml_tpu_torch.remote.packaging import package_source

        module_name, var_name = model.loader_path()
        module = sys.modules[module_name]
        module_file = getattr(module, "__file__", None)
        if module_file is None:
            raise ValueError(
                f"cannot deploy: app module {module_name!r} has no file (interactive?)"
            )
        src_dir = Path(module_file).parent
        dest = self.deployment_dir(app_version)
        n = package_source(src_dir, dest, patch=patch)
        manifest = {
            "app": f"{Path(module_file).stem}:{var_name}",
            "model_name": model.name,
            "app_version": app_version,
            "project": self.project,
            "domain": self.domain,
            "workflows": [
                model.train_workflow_name,
                model.predict_workflow_name,
                model.predict_from_features_workflow_name,
            ],
            # per-workflow resource maxima (reference parity:
            # unionml/defaults.py:5 sizes the task container; here the
            # launcher derives the runner env from these — defaults.py
            # resources_env)
            "resources": _model_resources_table(model),
        }
        (dest / ".unionml_manifest.json").write_text(json.dumps(manifest, indent=2))
        logger.info(f"deployed {n} files to {dest}")
        return dest

    # ---------- execute ----------

    def execute(
        self,
        model,
        *,
        workflow: str,
        app_version: Optional[str] = None,
        model_version: Optional[str] = None,
        inputs: Optional[Dict[str, Any]] = None,
        wait: bool = True,
        max_restarts: int = 0,
    ) -> ExecutionRecord:
        """``max_restarts``: preemption recovery (SURVEY §5.3) — when the
        runner dies (slice preemption, OOM-kill, spot eviction) the SAME
        execution relaunches up to this many times. With the train step
        registered as ``@model.train_step(checkpoint_dir=...)`` each
        relaunch resumes from the newest checkpoint, reaching the
        bit-identical state of an uninterrupted run instead of training
        from scratch (the reference delegates this retry loop to Flyte;
        reference: tests/integration/test_flyte_remote.py:72-79 is its
        only in-repo trace). Requires ``wait=True``."""
        if max_restarts and not wait:
            raise ValueError(
                "max_restarts needs wait=True (the relaunch loop watches "
                "the execution to completion)"
            )
        app_version = app_version or self._latest_app_version()
        dep_dir = self.deployment_dir(app_version)
        if not dep_dir.exists():
            raise FileNotFoundError(
                f"app version {app_version!r} is not deployed (looked in {dep_dir})"
            )
        manifest = json.loads((dep_dir / ".unionml_manifest.json").read_text())

        execution_id = f"{workflow}-{uuid.uuid4().hex[:10]}"
        exec_dir = self.executions_dir() / execution_id
        exec_dir.mkdir(parents=True, exist_ok=True)
        with open(exec_dir / "inputs.pkl", "wb") as f:
            pickle.dump(inputs or {}, f)

        record = ExecutionRecord(
            execution_id=execution_id,
            project=self.project,
            workflow=workflow,
            app_version=app_version,
            exec_dir=str(exec_dir),
            console_url=f"file://{exec_dir}",
        )
        record.save()
        self._launch(record, dep_dir, manifest, model_version=model_version)
        # surface the console URL (reference: model.py:785-789)
        logger.info(f"execution {execution_id}: {record.console_url}")
        if wait:
            attempt = 0
            while True:
                try:
                    return self.wait(record)
                except RuntimeError:
                    # relaunch ONLY genuine preemptions (runner died
                    # without reporting): an app-reported FAILED is
                    # deterministic — retrying it just repeats the crash
                    try:
                        kind = ExecutionRecord.load(record.exec_dir).failure_kind
                    except (OSError, json.JSONDecodeError, TypeError):
                        kind = ""
                    if attempt >= max_restarts or kind != "preempted":
                        raise
                    attempt += 1
                    logger.info(
                        f"execution {execution_id} died; relaunching "
                        f"(attempt {attempt}/{max_restarts}) — a "
                        "checkpoint_dir train step resumes from its "
                        "newest checkpoint"
                    )
                    # reset the FAILED record BEFORE relaunching, or the
                    # next wait() reads the stale terminal status and
                    # raises before the runner sets RUNNING
                    record = ExecutionRecord.load(record.exec_dir)
                    record.status = "QUEUED"
                    record.failure_kind = ""
                    record.save()
                    self._launch(
                        record, dep_dir, manifest, model_version=model_version
                    )
        return record

    def _launch(self, record, dep_dir, manifest, *, model_version):  # pragma: no cover
        raise NotImplementedError

    # ---------- status / outputs ----------

    def wait(self, execution: ExecutionRecord, timeout: float = 3600.0, poll: float = 0.2) -> ExecutionRecord:
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                execution = ExecutionRecord.load(execution.exec_dir)
            except (json.JSONDecodeError, FileNotFoundError):
                time.sleep(poll)  # mid-write record; retry
                continue
            if execution.status in ("SUCCEEDED", "FAILED"):
                if execution.status == "FAILED":
                    log = Path(execution.exec_dir) / "runner.log"
                    tail = log.read_text()[-2000:] if log.exists() else "<no log>"
                    raise RuntimeError(
                        f"execution {execution.execution_id} FAILED. Log tail:\n{tail}"
                    )
                return execution
            time.sleep(poll)
        raise TimeoutError(f"execution {execution.execution_id} did not finish in {timeout}s")

    def fetch_outputs(self, execution: ExecutionRecord) -> Dict[str, Any]:
        with open(Path(execution.exec_dir) / "outputs.pkl", "rb") as f:
            return pickle.load(f)

    # ---------- registry = execution history (reference: remote.py:150-218) ----

    def _train_executions(self, model, app_version: Optional[str]) -> List[ExecutionRecord]:
        base = self.executions_dir()
        if not base.exists():
            return []
        records = []
        for d in base.iterdir():
            try:
                rec = ExecutionRecord.load(d)
            except (FileNotFoundError, json.JSONDecodeError):
                continue
            if rec.workflow != "train" or rec.status != "SUCCEEDED":
                continue
            if app_version is not None and rec.app_version != app_version:
                continue
            records.append(rec)
        return sorted(records, key=lambda r: r.created_at, reverse=True)

    def get_model_execution(
        self, model, *, app_version: Optional[str] = None, model_version: str = "latest"
    ) -> ExecutionRecord:
        """latest-or-pinned model version (reference: remote.py:150-183)."""
        if model_version != "latest":
            exec_dir = self.executions_dir() / model_version
            record = ExecutionRecord.load(exec_dir)
            if record.workflow != "train" or record.status != "SUCCEEDED":
                raise ValueError(
                    f"model_version {model_version!r} is not a SUCCEEDED train "
                    f"execution (workflow={record.workflow!r}, status={record.status!r})"
                )
            return record
        records = self._train_executions(model, app_version)
        if not records:
            raise FileNotFoundError(
                f"no successful train executions for project {self.project!r}"
                + (f" app_version {app_version!r}" if app_version else "")
            )
        return records[0]

    def list_model_versions(self, model, *, app_version=None, limit: int = 10) -> List[str]:
        """Model versions = succeeded train execution ids
        (reference: remote.py:197-218)."""
        return [r.execution_id for r in self._train_executions(model, app_version)[:limit]]


def _runner_dead(pid: int) -> bool:
    """True when the runner process is gone OR a zombie.

    The launcher never blocks on its Popen, so a hard-killed runner
    lingers as a ZOMBIE in this process — and zombies still accept
    ``os.kill(pid, 0)``, which is exactly how the naive liveness probe
    missed the death (found by the preemption e2e hanging). Reap our own
    children with ``waitpid(WNOHANG)``; for runners launched by another
    process (rehydrated backend), probe with signal 0 plus a /proc
    zombie-state check."""
    try:
        done, _status = os.waitpid(pid, os.WNOHANG)
        return done == pid
    except ChildProcessError:
        pass  # not our child: fall through to the probe
    except OSError:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except PermissionError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            # field 3 (after the parenthesized comm) is the state
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return False


class LocalBackend(BaseBackend):
    """Subprocess sandbox: the single-node stand-in for a real backend."""

    def _launch(self, record, dep_dir, manifest, *, model_version):
        cmd = [
            sys.executable,
            "-m",
            "unionml_tpu_torch.remote.runner",
            "--app", manifest["app"],
            "--workflow", record.workflow,
            "--exec-dir", record.exec_dir,
        ]
        if model_version:
            cmd += ["--model-version", model_version]
        env = dict(os.environ)
        # the deployed source + the framework itself must be importable
        # (the framework root also holds the built kernels, build/kernels/)
        fw_root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            [str(dep_dir), fw_root, env.get("PYTHONPATH", "")]
        )
        env[DEFAULT_ROOT_ENV] = str(self.root)
        env["UNIONML_TPU_PROJECT"] = self.project
        res_env = _manifest_env(manifest, record.workflow)
        if res_env:
            env.update(res_env)
            logger.info(
                f"resources applied to {record.workflow}: {res_env}"
            )
        # append: a max_restarts relaunch must not destroy the previous
        # attempt's log (the preemption evidence an operator debugs with)
        log = open(Path(record.exec_dir) / "runner.log", "a")
        proc = subprocess.Popen(cmd, cwd=dep_dir, env=env, stdout=log, stderr=log)
        (Path(record.exec_dir) / "pid").write_text(str(proc.pid))

    def wait(self, execution: ExecutionRecord, timeout: float = 3600.0, poll: float = 0.2) -> ExecutionRecord:
        """Base wait + DEAD-RUNNER detection: a hard-killed runner
        (preemption, OOM-kill, ``kill -9``) never writes a terminal
        status, so the record stays RUNNING forever. Here a non-terminal
        record whose pid is gone is marked FAILED — which is what lets
        ``execute(..., max_restarts=N)`` relaunch it (the §5.3
        preemption-recovery loop) instead of hanging to timeout."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                execution = ExecutionRecord.load(execution.exec_dir)
            except (json.JSONDecodeError, FileNotFoundError):
                time.sleep(poll)
                continue
            if execution.status in ("SUCCEEDED", "FAILED"):
                return super().wait(execution, timeout=poll * 2, poll=poll)
            pid_path = Path(execution.exec_dir) / "pid"
            # QUEUED counts too: a runner that dies before reaching its
            # RUNNING write (bad interpreter, import crash, instant
            # preemption) must fail the execution, not hang it
            if execution.status in ("QUEUED", "RUNNING") and pid_path.exists():
                try:
                    pid = int(pid_path.read_text())
                except ValueError:
                    pid = None
                if pid is not None and _runner_dead(pid):
                    # grace re-read: the runner may have just written its
                    # terminal status before exiting
                    execution = ExecutionRecord.load(execution.exec_dir)
                    if execution.status not in ("SUCCEEDED", "FAILED"):
                        log = Path(execution.exec_dir) / "runner.log"
                        with open(log, "a") as f:
                            f.write(
                                f"\nrunner pid {pid} died without "
                                "reporting a terminal status (preempted?)\n"
                            )
                        execution.status = "FAILED"
                        execution.failure_kind = "preempted"
                        execution.save()
                        continue
            time.sleep(poll)
        raise TimeoutError(
            f"execution {execution.execution_id} did not finish in {timeout}s"
        )


class GPUHostBackend(BaseBackend):
    """SSH control plane for GPU hosts (multi-host): the port's
    counterpart of the reference's ``TPUVMBackend``
    (``unionml_tpu/remote/backend.py``), with the same SSH, scp, docker and
    provisioning steps and the same failure reporting.

    Config (from the backend YAML, ``type: gpu_hosts``): ``hosts`` (host
    addresses, host 0 is the rendezvous master), ``ssh_user``,
    ``workdir``, ``shared_fs`` (whether the exec dir is visible on every
    host — NFS; when False, inputs are scp'd out and host 0's outputs
    scp'd back), ``provision`` (build the framework wheel + pinned
    requirements and pip-install them on every host at deploy time — the
    ``docker_build_push`` analog, reference remote.py:69-108). Source is
    pushed to every host; the runner launches on all hosts with
    :mod:`torch.distributed`'s env (``MASTER_ADDR`` = host 0,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) in place of the reference's
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``, and the runner calls
    ``torch.distributed.init_process_group`` (``nccl`` with a card).

    ``_launch`` keeps every SSH process; :meth:`wait` joins them all and
    aggregates per-host failures (rc + log tail) instead of silently
    returning — a host-1 crash fails the execution, like a lost Flyte pod
    fails the workflow.
    """

    def __init__(self, *, hosts: List[str], ssh_user: str = "root",
                 workdir: str = "/tmp/unionml_tpu_torch_app", coordinator_port: int = 29500,
                 shared_fs: bool = True, provision: bool = True,
                 image: Optional[str] = None, image_push: bool = True,
                 dockerfile: Optional[str] = None, **kwargs):
        """``coordinator_port``: host 0's ``MASTER_PORT``.

        ``image``: optional container repository (e.g.
        ``registry.example/unionml-tpu-torch``). When set, full deploys
        build the port's CUDA ``Dockerfile.cuda`` (a CUDA PyTorch base
        image) tagged ``{image}:{app_version}``, push
        it (unless ``image_push: false`` — e.g. a registry mirrored to
        the hosts), and pull it on every host; executions then run the
        runner INSIDE the container (workdir and registry bind-mounted)
        so the remote environment is an immutable per-version artifact —
        the reference's ``docker_build_push`` mode (remote.py:69-108).
        Patch deploys skip the build/pull, mirroring fast registration.
        ``dockerfile`` overrides the default (the framework root's
        ``Dockerfile.cuda``).
        """
        super().__init__(**kwargs)
        if not hosts:
            raise ValueError("GPUHostBackend requires at least one host")
        self.hosts = hosts
        self.ssh_user = ssh_user
        self.workdir = workdir
        self.coordinator_port = coordinator_port
        self.shared_fs = shared_fs
        self.provision = provision
        self.image = image
        self.image_push = image_push
        self.dockerfile = dockerfile
        # execution_id -> {"procs": [(host, Popen, logfile)], "targets": [...]}
        self._procs: Dict[str, Dict[str, Any]] = {}
        # (host, app_version) pairs already pushed by THIS process: execute()
        # after deploy() skips re-pushing the identical tree (incl. wheels)
        self._pushed: set = set()

    # ---------- transport primitives (monkeypatch points for tests) ----------

    def _ssh(self, host: str, command: str, **popen_kwargs):
        """Streaming remote command (non-blocking Popen)."""
        return subprocess.Popen(
            ["ssh", "-o", "StrictHostKeyChecking=no", f"{self.ssh_user}@{host}", command],
            **popen_kwargs,
        )

    def _run_ssh(self, host: str, command: str) -> subprocess.CompletedProcess:
        """Blocking remote command with captured output."""
        return subprocess.run(
            ["ssh", "-o", "StrictHostKeyChecking=no", f"{self.ssh_user}@{host}", command],
            capture_output=True, text=True,
        )

    def _run_ssh_checked(self, host: str, command: str):
        """Blocking remote command; raises with stderr on failure."""
        proc = self._run_ssh(host, command)
        if proc.returncode != 0:
            raise RuntimeError(
                f"remote command failed on {host} (rc={proc.returncode}): "
                f"{command}\n{(proc.stderr or '').strip()[-500:]}"
            )
        return proc

    def _scp_to(self, host: str, src: str, dst: str):
        subprocess.run(
            ["scp", "-r", "-q", "-o", "StrictHostKeyChecking=no", src,
             f"{self.ssh_user}@{host}:{dst}"],
            check=True,
        )

    def _scp_from(self, host: str, src: str, dst: str):
        subprocess.run(
            ["scp", "-r", "-q", "-o", "StrictHostKeyChecking=no",
             f"{self.ssh_user}@{host}:{src}", dst],
            check=True,
        )

    def _run_docker(self, args: List[str]) -> subprocess.CompletedProcess:
        """Local docker invocation (build/push run on the deploying
        machine; hosts only pull). Monkeypatch point for tests."""
        return subprocess.run(["docker"] + args, capture_output=True, text=True)

    # ---------- image mode (docker_build_push analog) ----------

    def _image_tag(self, app_version: str) -> str:
        # patch deploys skip the image build and run in the BASE
        # version's container — fast registration semantics: source
        # changes ride the scp push, the environment is pinned. Only a
        # TRAILING "-patch<hex>" (the exact suffix deploy() appends) is
        # stripped; user versions that merely contain "-patch" keep
        # their own tag.
        base = re.sub(r"-patch[0-9a-f]+$", "", app_version)
        return f"{self.image}:{base}"

    def _build_and_distribute_image(self, app_version: str) -> str:
        """Build the framework image for this version, push it, and pull
        it on every host. The image pins the ENVIRONMENT; app source
        still rides the scp push (so patch redeploys stay seconds)."""
        tag = self._image_tag(app_version)
        fw_root = Path(__file__).resolve().parents[2]
        dockerfile = self.dockerfile or str(fw_root / "Dockerfile.cuda")
        if not Path(dockerfile).exists():
            # a pip-installed package has no Dockerfile next to it — the
            # default only works from a source checkout
            raise RuntimeError(
                f"image mode needs a Dockerfile: {dockerfile} does not "
                "exist (the framework appears to be installed as a "
                "package, not a source checkout). Set `dockerfile:` in "
                "the backend config to your build file."
            )
        context = str(Path(dockerfile).parent)
        proc = self._run_docker(
            ["build", "-t", tag, "-f", dockerfile, context]
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"docker build failed for {tag}:\n{(proc.stderr or '')[-800:]}"
            )
        if self.image_push:
            proc = self._run_docker(["push", tag])
            if proc.returncode != 0:
                raise RuntimeError(
                    f"docker push failed for {tag}:\n{(proc.stderr or '')[-800:]}"
                )
        from concurrent.futures import ThreadPoolExecutor

        def pull_host(host: str) -> Optional[str]:
            pull = self._run_ssh(host, f"docker pull {tag}")
            if pull.returncode != 0:
                return f"{host}: {(pull.stderr or '').strip()[-300:]}"
            return None

        # hosts pull independently: multi-GB images at max(host), not
        # sum(hosts), on big slices (same reason as pip provisioning)
        with ThreadPoolExecutor(max_workers=min(16, len(self.hosts))) as pool:
            errors = [e for e in pool.map(pull_host, self.hosts) if e]
        if errors:
            raise RuntimeError(
                f"docker pull failed on {len(errors)}/{len(self.hosts)} "
                "hosts:\n" + "\n".join(errors)
            )
        logger.info(f"image {tag} built and distributed to {len(self.hosts)} hosts")
        return tag

    # ---------- deploy + environment provisioning ----------

    def deploy(self, model, *, app_version: str, patch: bool = False) -> Path:
        """Package source; build + install the pinned environment.

        Full deploys build an environment bundle (framework wheel +
        ``requirements.lock`` pinned to the versions running here) and
        pip-install it on every host, so the remote env is reproducible —
        the reference's image build/push (remote.py:69-108). Patch deploys
        skip provisioning, mirroring fast registration (remote.py:126-138).
        """
        dest = super().deploy(model, app_version=app_version, patch=patch)
        # a re-deploy of the same version string (e.g. a second '-dirty'
        # deploy after edits) must re-push: drop its push-dedup entries
        self._pushed = {p for p in self._pushed if p[1] != app_version}
        if self.image:
            # image mode supersedes pip provisioning: the environment is
            # the container, built once per version
            if not patch:
                self._build_and_distribute_image(app_version)
            return dest
        if self.provision and not patch:
            from concurrent.futures import ThreadPoolExecutor

            from unionml_tpu_torch.remote import packaging

            packaging.build_environment_bundle(dest)

            def provision_host(host: str) -> Optional[str]:
                target = self._push(host, dest, app_version)
                proc = self._run_ssh(
                    host,
                    f"python -m pip install -q -r {target}/_env/requirements.lock "
                    f"--no-index --find-links {target}/_env && "
                    f"python -m pip install -q --no-deps --force-reinstall "
                    f"{target}/_env/*.whl || "
                    # no local wheel cache for the pinned deps (fresh VM with
                    # network): fall back to a plain pinned install
                    f"(python -m pip install -q -r {target}/_env/requirements.lock && "
                    f"python -m pip install -q --no-deps --force-reinstall "
                    f"{target}/_env/*.whl)",
                )
                if proc.returncode != 0:
                    return f"{host}: {proc.stderr.strip()[-500:]}"
                return None

            # hosts are independent: provision concurrently so deploy time
            # is max(host), not sum(hosts), on big slices
            with ThreadPoolExecutor(max_workers=min(16, len(self.hosts))) as pool:
                errors = [e for e in pool.map(provision_host, self.hosts) if e]
            if errors:
                raise RuntimeError(
                    "environment provisioning failed on "
                    f"{len(errors)}/{len(self.hosts)} hosts:\n" + "\n".join(errors)
                )
            logger.info(
                f"provisioned pinned environment on {len(self.hosts)} hosts"
            )
        return dest

    def _push(self, host: str, src: Path, app_version: str) -> str:
        """Push the deployment to a per-version dir so repeated deploys never
        nest inside (or silently reuse) a previous version's workdir.

        Idempotent within one process: a version already pushed to a host
        (e.g. by deploy(), or a previous execute()) is not re-transferred.
        """
        target = f"{self.workdir}/{app_version}"
        if (host, app_version) in self._pushed:
            return target
        self._run_ssh_checked(host, f"rm -rf {target} && mkdir -p {target}")
        self._scp_to(host, f"{src}/.", target)
        self._pushed.add((host, app_version))
        return target

    # ---------- launch / wait ----------

    def _stage_model_registry(self, model_version):
        """Copy the resolved train execution to every host's local registry.

        Without a shared filesystem the hosts cannot see this machine's
        execution history, so predict workflows could never resolve a
        trained model: stage the one SUCCEEDED train execution the runner
        will ask for (latest or pinned) into ``{root}/executions`` on each
        host — the runner's ``_load_model_artifact`` then finds it through
        the same registry layout it uses locally. The staged record's
        ``exec_dir`` is rewritten to the HOST-side path first: the
        deployer-local path inside record.json would send the runner's
        ``fetch_outputs`` to a directory that doesn't exist over there.
        """
        import shutil
        import tempfile

        src = self.get_model_execution(None, model_version=model_version or "latest")
        remote_dir = f"{self.root}/executions/{self.project}/{src.execution_id}"
        with tempfile.TemporaryDirectory(prefix="unionml_tpu_torch_stage_") as tmp:
            stage = Path(tmp) / src.execution_id
            shutil.copytree(src.exec_dir, stage)
            data = json.loads((stage / "record.json").read_text())
            data["exec_dir"] = remote_dir
            (stage / "record.json").write_text(json.dumps(data))
            for host in self.hosts:
                self._run_ssh_checked(host, f"mkdir -p {remote_dir}")
                self._scp_to(host, f"{stage}/.", remote_dir)

    def _launch(self, record, dep_dir, manifest, *, model_version):
        targets = [self._push(host, dep_dir, record.app_version) for host in self.hosts]
        if not self.shared_fs and record.workflow != "train":
            self._stage_model_registry(model_version)
        procs = []
        for i, host in enumerate(self.hosts):
            if self.shared_fs:
                remote_exec = record.exec_dir
            else:
                # private filesystems: stage inputs+record into a
                # per-execution dir in the pushed workdir; host 0's copy is
                # fetched back in wait()
                remote_exec = f"{targets[i]}/_exec/{record.execution_id}"
                self._run_ssh_checked(host, f"mkdir -p {remote_exec}")
                self._scp_to(host, f"{record.exec_dir}/.", remote_exec)
            env = {
                DEFAULT_ROOT_ENV: str(self.root),
                "UNIONML_TPU_PROJECT": self.project,
            }
            res_env = _manifest_env(manifest, record.workflow)
            if res_env:
                env.update(res_env)
                logger.info(
                    f"resources applied to {record.workflow} on {host}: "
                    f"{res_env}"
                )
            if len(self.hosts) > 1:
                # single-host runs skip torch.distributed entirely
                env.update({
                    "MASTER_ADDR": self.hosts[0],
                    "MASTER_PORT": str(self.coordinator_port),
                    "WORLD_SIZE": str(len(self.hosts)),
                    "RANK": str(i),
                })
            runner = (
                f"python -m unionml_tpu_torch.remote.runner --app {manifest['app']} "
                f"--workflow {record.workflow} --exec-dir {remote_exec}"
                + (f" --model-version {model_version}" if model_version else "")
            )
            if self.image:
                # run the runner inside the per-version container: host
                # networking for the torch.distributed rendezvous and
                # NCCL, --gpus all for the cards, the host IPC namespace
                # for NCCL's shared memory, workdir + registry
                # bind-mounted so pushes/records work exactly as uncontained
                env_flags = " ".join(f"-e {k}={v}" for k, v in env.items())
                cmd = (
                    f"docker run --rm --gpus all --ipc host --network host "
                    f"-v {targets[i]}:{targets[i]} -v {self.root}:{self.root} "
                    f"-w {targets[i]} {env_flags} "
                    f"{self._image_tag(record.app_version)} {runner}"
                )
            else:
                env_prefix = " ".join(f"{k}={v}" for k, v in env.items())
                cmd = f"cd {targets[i]} && {env_prefix} {runner}"
            log_path = Path(record.exec_dir) / f"runner.host{i}.log"
            log = open(log_path, "w")
            procs.append((host, self._ssh(host, cmd, stdout=log, stderr=log), log))
        self._procs[record.execution_id] = {"procs": procs, "targets": targets}

    def wait(self, execution: ExecutionRecord, timeout: float = 3600.0, poll: float = 0.2) -> ExecutionRecord:
        """Join every host's SSH process, aggregate failures, fetch outputs.

        Unlike the base class (which only polls the record file), a dead
        or non-zero host process fails the execution with that host's rc
        and log tail — per-host failures propagate instead of hanging the
        poll loop until timeout.
        """
        launched = self._procs.pop(execution.execution_id, None)
        if launched is None:
            # not launched by this process: record polling. With
            # shared_fs: false the local record only turns terminal when
            # the LAUNCHING process's wait() scp's it back — a re-wait
            # after that fetch, or a monitor process on the launcher's
            # machine, still succeeds; on timeout, append the likely cause
            # (keeping the TimeoutError type so retry loops still work)
            try:
                return super().wait(execution, timeout=timeout, poll=poll)
            except TimeoutError as e:
                if not self.shared_fs:
                    raise TimeoutError(
                        f"{e} — note: this backend has shared_fs: false and "
                        "this process did not launch the execution, so the "
                        "local record only updates when the launching "
                        "process's wait() fetches it back. If the launcher "
                        "is gone, this wait can never succeed; call wait() "
                        "from the process that called execute(), or enable "
                        "shared_fs."
                    ) from e
                raise
        deadline = time.time() + timeout
        failures = []
        # poll ALL hosts concurrently: a crashed worker is detected
        # immediately even while host 0 blocks in a collective waiting for
        # the dead peer — the survivors are then killed rather than letting
        # them hang until the deadline
        pending = {i: hp for i, hp in enumerate(launched["procs"])}
        while pending and time.time() < deadline and not failures:
            for i in sorted(pending):
                host, proc, log = pending[i]
                rc = proc.poll()
                if rc is None:
                    continue
                del pending[i]
                log.close()
                if rc != 0:
                    failures.append((i, host, f"rc={rc}"))
            if pending and not failures:
                time.sleep(poll)
        for i in sorted(pending):  # first failure or deadline: reap survivors
            host, proc, log = pending[i]
            proc.kill()
            proc.wait()
            log.close()
            why = ("killed after another host failed" if failures
                   else f"timeout after {timeout}s")
            failures.append((i, host, why))
        if not self.shared_fs and not failures:
            # host 0 holds the authoritative record + outputs
            self._scp_from(
                self.hosts[0],
                f"{launched['targets'][0]}/_exec/{execution.execution_id}/.",
                execution.exec_dir,
            )
        if failures:
            detail = []
            for i, host, why in failures:
                log_path = Path(execution.exec_dir) / f"runner.host{i}.log"
                tail = log_path.read_text()[-1000:] if log_path.exists() else "<no log>"
                detail.append(f"host {i} ({host}): {why}\n{tail}")
            if not self.shared_fs:
                # best-effort record fetch from EVERY failing host (an
                # app crash may be reported by a non-coordinator host —
                # fetching only host 0 would misclassify it), falling
                # back to host 0 for the survivor-kill case
                for i in sorted({i for i, _, _ in failures} | {0}):
                    try:
                        self._scp_from(
                            self.hosts[i],
                            f"{launched['targets'][i]}/_exec/"
                            f"{execution.execution_id}/record.json",
                            execution.exec_dir,
                        )
                    except Exception:  # pragma: no cover - transport
                        continue
                    try:
                        if ExecutionRecord.load(execution.exec_dir).status == "FAILED":
                            break
                    except (OSError, json.JSONDecodeError, TypeError):
                        continue
            # classify for the max_restarts loop: a runner that wrote its
            # own FAILED status crashed deterministically (never worth
            # relaunching); a host PROCESS that died without reporting
            # (slice preemption, eviction, OOM-kill) is retryable. A pure
            # wall-clock timeout is NEITHER — the remote runners may
            # still be alive, and relaunching over them would race two
            # coordinators on the same ports/exec dir.
            try:
                reported = (
                    ExecutionRecord.load(execution.exec_dir).status == "FAILED"
                )
            except (OSError, json.JSONDecodeError, TypeError):
                reported = False
            host_died = any(why.startswith("rc=") for _, _, why in failures)
            execution.status = "FAILED"
            if host_died and not reported:
                execution.failure_kind = "preempted"
            execution.save()
            raise RuntimeError(
                f"execution {execution.execution_id} FAILED on "
                f"{len(failures)}/{len(self.hosts)} hosts:\n" + "\n".join(detail)
            )
        return super().wait(execution, timeout=max(1.0, deadline - time.time()), poll=poll)


def get_backend(
    config_file: Optional[str] = None,
    *,
    project: str,
    domain: str = "development",
) -> BaseBackend:
    """Build a backend from YAML config, defaulting to the local sandbox
    (the reference's Config.auto localhost fallback, model.py:661-663).

    ``type: gpu_hosts`` builds a :class:`GPUHostBackend`; no type (or
    ``local``) the :class:`LocalBackend`. Any other type raises: the
    reference's ``tpu_vm`` in particular must not fall through to the
    local sandbox, which would quietly run a multi-host job on one
    machine."""
    if config_file:
        import yaml

        with open(config_file) as f:
            cfg = yaml.safe_load(f) or {}
        backend_cfg = cfg.get("backend", {})
        kind = backend_cfg.get("type")
        if kind == "gpu_hosts":
            return GPUHostBackend(
                hosts=backend_cfg["hosts"],
                ssh_user=backend_cfg.get("ssh_user", "root"),
                workdir=backend_cfg.get("workdir", "/tmp/unionml_tpu_torch_app"),
                coordinator_port=backend_cfg.get("coordinator_port", 29500),
                shared_fs=backend_cfg.get("shared_fs", True),
                provision=backend_cfg.get("provision", True),
                project=project,
                domain=domain,
                root=backend_cfg.get("root"),
            )
        if kind not in (None, "local"):
            raise ValueError(
                f"unknown backend type {kind!r}: unionml_tpu_torch drives GPU "
                "hosts with 'type: gpu_hosts' (or the local sandbox with no "
                "type / 'type: local')"
            )
        return LocalBackend(project=project, domain=domain, root=backend_cfg.get("root"))
    return LocalBackend(project=project, domain=domain)
