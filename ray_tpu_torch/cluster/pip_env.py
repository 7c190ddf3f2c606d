"""Per-requirements pip/uv/conda runtime environments, agent-side.

Capability analog of the reference's runtime-env builders
(Ray's python/ray/_private/runtime_env/pip.py, uv.py,
conda.py: cache keyed by a hash of the resolved config, concurrent
builds deduplicated, idle environments garbage-collected).

Redesigned for this runtime: instead of full virtualenvs (venv +
ensurepip cost per env), a ``pip`` or ``uv`` environment is an
``install --target`` directory keyed by the hash of its normalized
requirements + install args + interpreter version. A worker serving the
env runs with the directory prepended to ``sys.path``, shadowing base
site-packages — so two workers on one node can hold conflicting
versions of the same package concurrently, which is the isolation
property the builders exist for. A ``conda`` environment is a full
env directory (``conda create -p``) whose OWN interpreter runs the
worker — the env must therefore provide python and have ray_tpu_torch
importable (reference conda.py injects ray the same way). All kinds
share one key/lock/refcount/GC machinery: builds are serialized per key
with a file lock; the winner writes a completion marker, losers wait on
it.

No-network images: callers pass explicit install args (e.g.
``--no-index --find-links /wheels``); nothing here reaches for an index
by itself beyond what the tool is told. The conda binary resolves from
``RAY_TPU_CONDA_BINARY`` or PATH (conda/mamba/micromamba) and its
absence is a loud build error, not a silent fallback.

Port of ``ray_tpu/cluster/pip_env.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple


ENV_KINDS = ("pip", "uv", "conda")


def has_env(runtime_env) -> bool:
    """True when a runtime_env needs an isolated-env-bound worker."""
    return bool(runtime_env) and any(
        runtime_env.get(k) is not None for k in ENV_KINDS
    )


def env_slice(runtime_env) -> Optional[Dict[str, object]]:
    """The isolated-env portion of a runtime_env: {"pip": ...},
    {"uv": ...}, or {"conda": ...} (at most one), else None."""
    if not runtime_env:
        return None
    present = [k for k in ENV_KINDS if runtime_env.get(k) is not None]
    if not present:
        return None
    if len(present) > 1:
        raise ValueError(
            f"runtime_env may specify at most one of {ENV_KINDS}, "
            f"got {present}"
        )
    k = present[0]
    return {k: runtime_env[k]}


def normalize_pip(pip) -> Tuple[List[str], List[str]]:
    """Accepts the reference's shapes: a list of requirement strings, or
    {"packages": [...], "pip_install_args"/"install_args": [...]}."""
    if pip is None:
        return [], []
    if isinstance(pip, (list, tuple)):
        return sorted(str(p) for p in pip), []
    if isinstance(pip, dict):
        pkgs = sorted(str(p) for p in pip.get("packages", ()))
        args = list(
            pip.get("pip_install_args")
            or pip.get("uv_pip_install_args")
            or pip.get("conda_create_args")
            or pip.get("install_args")
            or ()
        )
        return pkgs, args
    raise TypeError(f"runtime_env env spec must be list or dict, got {pip!r}")


def normalize_conda(spec) -> Tuple[List[str], List[str]]:
    """Accepts a list of package specs or a dict with "packages" OR the
    reference environment-yaml shape's "dependencies" list (conda.py).
    Nested dependency specs (e.g. {"pip": [...]} inside dependencies)
    are rejected loudly — silently dropping them would cache an env
    missing what the user asked for."""
    if spec is None:
        return [], []
    if isinstance(spec, (list, tuple)):
        deps: List[object] = list(spec)
        args: List[str] = []
    elif isinstance(spec, dict):
        deps = list(spec.get("packages") or spec.get("dependencies") or ())
        args = list(
            spec.get("conda_create_args") or spec.get("install_args") or ()
        )
    else:
        raise TypeError(
            f"runtime_env['conda'] must be list or dict, got {spec!r}"
        )
    bad = [d for d in deps if not isinstance(d, str)]
    if bad:
        raise TypeError(
            "nested conda dependency specs are not supported "
            f"(got {bad!r}); list plain 'name=version' strings"
        )
    return sorted(str(d) for d in deps), args


def _normalize_any(env) -> Tuple[str, List[str], List[str]]:
    """(kind, packages, args) from either a {"pip"/"uv"/"conda": spec}
    slice or a bare pip spec (legacy callers)."""
    if isinstance(env, dict) and len(env) == 1 and next(iter(env)) in ENV_KINDS:
        kind = next(iter(env))
        if kind == "conda":
            pkgs, args = normalize_conda(env[kind])
        else:
            pkgs, args = normalize_pip(env[kind])
        return kind, pkgs, args
    pkgs, args = normalize_pip(env)
    return "pip", pkgs, args


def conda_binary() -> Optional[str]:
    """The conda-family binary to build envs with (injection point:
    RAY_TPU_CONDA_BINARY overrides PATH discovery — also how tests stub
    it on images without conda)."""
    override = os.environ.get("RAY_TPU_CONDA_BINARY")
    if override:
        return override
    for name in ("conda", "mamba", "micromamba"):
        path = shutil.which(name)
        if path:
            return path
    return None


class PipEnvManager:
    """Hash-keyed --target environments with refcounts and LRU GC."""

    BUILD_TIMEOUT_S = 600.0

    def __init__(self, base_dir: str, max_cached: int = 8):
        self.base_dir = base_dir
        self.max_cached = max_cached
        os.makedirs(base_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._refs: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def key_of(self, env) -> str:
        kind, pkgs, args = _normalize_any(env)
        blob = "\n".join(
            [kind] + pkgs + ["--"] + args + [sys.version.split()[0]]
        ).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def env_dir(self, key: str) -> str:
        return os.path.join(self.base_dir, key)

    @staticmethod
    def _build_cmd(kind: str, tmp: str, pkgs, args) -> List[str]:
        if kind == "pip":
            return [
                sys.executable,
                "-m",
                "pip",
                "install",
                "--target",
                tmp,
                "--disable-pip-version-check",
                "--no-input",
                *args,
                *pkgs,
            ]
        if kind == "uv":
            uv = shutil.which("uv")
            if uv is None:
                raise RuntimeError(
                    "runtime_env['uv'] requested but no 'uv' binary on PATH"
                )
            # same --target layout as pip (the worker shadows
            # site-packages identically); --python pins resolution to the
            # cluster interpreter (uv.py reference semantics)
            return [
                uv,
                "pip",
                "install",
                "--target",
                tmp,
                "--python",
                sys.executable,
                *args,
                *pkgs,
            ]
        if kind == "conda":
            conda = conda_binary()
            if conda is None:
                raise RuntimeError(
                    "runtime_env['conda'] requested but no conda/mamba/"
                    "micromamba binary found (set RAY_TPU_CONDA_BINARY)"
                )
            return [conda, "create", "--yes", "-p", tmp, *args, *pkgs]
        raise ValueError(f"unknown env kind {kind!r}")

    def ensure(self, env) -> Tuple[str, str]:
        """Return (key, env_dir), building the environment if it doesn't
        exist yet. ``env`` is a {"pip"/"uv"/"conda": spec} slice or a bare
        pip spec. Concurrent callers for one key serialize on a file
        lock; only the winner runs the builder."""
        kind, pkgs, args = _normalize_any(env)
        key = self.key_of(env)
        env_dir = self.env_dir(key)
        marker = env_dir + ".built"
        with self._lock:  # serialized vs gc(): marker+dir vanish atomically
            if os.path.exists(marker):
                return key, env_dir
        lock_path = env_dir + ".lock"
        with open(lock_path, "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                if os.path.exists(marker):  # built while we waited
                    return key, env_dir
                if kind == "conda":
                    # conda embeds its absolute creation prefix (shebangs,
                    # prefix-replaced files) — a build-at-tmp-then-rename
                    # env is broken by design, so build in place; the
                    # marker (written only on success, under the flock) is
                    # what distinguishes a finished env from a partial one
                    shutil.rmtree(env_dir, ignore_errors=True)
                    target = env_dir
                else:
                    target = env_dir + ".tmp"
                    shutil.rmtree(target, ignore_errors=True)
                cmd = self._build_cmd(kind, target, pkgs, args)
                proc = subprocess.run(
                    cmd,
                    capture_output=True,
                    text=True,
                    timeout=self.BUILD_TIMEOUT_S,
                    env={**os.environ, "PIP_NO_COLOR": "1"},
                )
                if proc.returncode != 0:
                    shutil.rmtree(target, ignore_errors=True)
                    raise RuntimeError(
                        f"{kind} env build failed (key {key}): "
                        + (proc.stderr or proc.stdout)[-1500:]
                    )
                if target != env_dir:
                    shutil.rmtree(env_dir, ignore_errors=True)
                    os.replace(target, env_dir)
                with open(marker, "w") as mf:
                    mf.write(kind + "\n" + " ".join(pkgs))
                return key, env_dir
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    @staticmethod
    def interpreter_for(kind: str, env_dir: str) -> str:
        """The python that runs a worker bound to this env: conda envs
        bring their own; pip/uv --target dirs ride the base interpreter
        with sys.path shadowing."""
        if kind == "conda":
            return os.path.join(env_dir, "bin", "python")
        return sys.executable

    # ------------------------------------------------------------------
    def acquire(self, key: str) -> None:
        with self._lock:
            self._refs[key] = self._refs.get(key, 0) + 1

    def release(self, key: str) -> None:
        with self._lock:
            c = self._refs.get(key, 0) - 1
            if c <= 0:
                self._refs.pop(key, None)
            else:
                self._refs[key] = c

    def gc(self) -> int:
        """Remove unreferenced environments beyond max_cached, oldest
        first (the reference GCs per-env on last-actor-exit; a small LRU
        cache keeps warm envs for repeat jobs). Returns removed count.

        The lock covers only the cheap part — liveness read, marker
        unlink, and an atomic rename of each doomed dir to a .tmp name —
        so an acquire() racing the sweep either lands before the read
        (env survives) or sees the env already gone and rebuilds. The
        slow recursive deletes run after the lock is released (rmtree of
        a large env must not stall pip dispatch node-wide)."""
        doomed: List[str] = []
        with self._lock:
            live = set(self._refs)
            envs = []
            try:
                for name in os.listdir(self.base_dir):
                    p = os.path.join(self.base_dir, name)
                    if not os.path.isdir(p):
                        continue
                    if name.endswith(".gc.tmp"):
                        # grave from a sweep interrupted by process death:
                        # always finish the burial
                        doomed.append(p)
                    elif not name.endswith(".tmp"):
                        envs.append((os.path.getmtime(p), name))
            except OSError:
                return 0
            envs.sort()
            removed = 0
            excess = len(envs) - self.max_cached
            for _, name in envs:
                if excess <= removed or name in live:
                    continue
                for suffix in (".built", ".lock"):
                    try:
                        os.unlink(os.path.join(self.base_dir, name + suffix))
                    except OSError:
                        pass
                grave = os.path.join(
                    self.base_dir, f"{name}.{os.getpid()}.gc.tmp"
                )
                try:
                    os.rename(os.path.join(self.base_dir, name), grave)
                except OSError:
                    continue
                doomed.append(grave)
                removed += 1
        for grave in doomed:
            shutil.rmtree(grave, ignore_errors=True)
        return removed
