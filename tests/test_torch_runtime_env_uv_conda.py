"""Mirror of ``tests/test_runtime_env_uv_conda.py`` on the port, with ``ray_tpu``
read as ``ray_tpu_torch`` and the scheduler's rounds on the host.

uv and conda runtime environments (reference capability: python/ray/_private/runtime_env/uv.py + conda.py) sharing the pip builders' key/lock/refcount/GC machinery (cluster/pip_env.py).
"""
import os
import stat
import sys
import threading

import pytest

import ray_tpu_torch
from tests.test_torch_runtime_env_pip import _make_wheel


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def _uv_env(wheels: str, version: str) -> dict:
    return {
        "uv": {
            "packages": [f"conflictpkg=={version}"],
            "uv_pip_install_args": [
                "--no-index",
                "--no-deps",
                "--quiet",
                "--find-links",
                wheels,
            ],
        }
    }


def _ver():
    import conflictpkg

    return conflictpkg.__version__


# ---------------------------------------------------------------------------
# uv
# ---------------------------------------------------------------------------


def test_uv_key_differs_from_pip(tmp_path):
    from ray_tpu_torch.cluster.pip_env import PipEnvManager

    mgr = PipEnvManager(str(tmp_path / "envs"))
    pip_slice = {"pip": {"packages": ["a==1.0"], "install_args": ["-q"]}}
    uv_slice = {"uv": {"packages": ["a==1.0"], "install_args": ["-q"]}}
    assert mgr.key_of(pip_slice) != mgr.key_of(uv_slice)
    assert mgr.key_of(uv_slice) == mgr.key_of(dict(uv_slice))


def test_uv_concurrent_build_dedup(tmp_path):
    from ray_tpu_torch.cluster.pip_env import PipEnvManager

    wheels = tmp_path / "wheels"
    wheels.mkdir()
    _make_wheel(str(wheels), "conflictpkg", "1.0.0")
    mgr = PipEnvManager(str(tmp_path / "envs"))
    spec = _uv_env(str(wheels), "1.0.0")
    results = []

    def build():
        results.append(mgr.ensure(spec))

    ts = [threading.Thread(target=build) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len({r[1] for r in results}) == 1
    env_dir = results[0][1]
    assert os.path.isdir(os.path.join(env_dir, "conflictpkg"))


def test_conflicting_uv_envs_one_node(tmp_path, monkeypatch):
    """Two uv envs with conflicting versions of one package run
    concurrently on one node — same isolation property as pip, built by
    uv (tasks report the version their env-bound worker imports)."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    wheels = tmp_path / "wheels"
    wheels.mkdir()
    _make_wheel(str(wheels), "conflictpkg", "1.0.0")
    _make_wheel(str(wheels), "conflictpkg", "2.0.0")
    monkeypatch.setenv("RAY_TPU_PIP_ENV_DIR_BASE", str(tmp_path / "envs"))
    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        f1 = ray_tpu_torch.remote(_ver).options(
            num_cpus=0.5,
            max_retries=0,
            runtime_env=_uv_env(str(wheels), "1.0.0"),
        )
        f2 = ray_tpu_torch.remote(_ver).options(
            num_cpus=0.5,
            max_retries=0,
            runtime_env=_uv_env(str(wheels), "2.0.0"),
        )
        r1, r2 = f1.remote(), f2.remote()
        assert ray_tpu_torch.get([r1, r2], timeout=300) == ["1.0.0", "2.0.0"]
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


# ---------------------------------------------------------------------------
# conda (stubbed binary: machinery test + loud-absence test)
# ---------------------------------------------------------------------------


_STUB = """#!/bin/sh
# fake `conda create --yes -p <dir> [pkgs...]`: records args, fabricates
# an env with its own bin/python
set -e
shift  # "create"
shift  # "--yes"
shift  # "-p"
dir="$1"; shift
mkdir -p "$dir/bin" "$dir/conda-meta"
ln -s "{python}" "$dir/bin/python"
echo "$@" > "$dir/conda-meta/requested.txt"
"""


@pytest.fixture()
def conda_stub(tmp_path, monkeypatch):
    stub = tmp_path / "fake-conda"
    stub.write_text(_STUB.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("RAY_TPU_CONDA_BINARY", str(stub))
    return stub


def test_conda_build_and_interpreter(tmp_path, conda_stub):
    from ray_tpu_torch.cluster.pip_env import PipEnvManager

    mgr = PipEnvManager(str(tmp_path / "envs"))
    spec = {"conda": {"packages": ["numpy=1.26"]}}
    key, env_dir = mgr.ensure(spec)
    assert os.path.isdir(env_dir)
    py = PipEnvManager.interpreter_for("conda", env_dir)
    assert py == os.path.join(env_dir, "bin", "python")
    assert os.path.exists(py)
    meta = open(os.path.join(env_dir, "conda-meta", "requested.txt")).read()
    assert "numpy=1.26" in meta
    # idempotent: second ensure reuses the built env
    assert mgr.ensure(spec) == (key, env_dir)
    # key space is disjoint from pip/uv for identical packages
    assert key != mgr.key_of({"pip": {"packages": ["numpy=1.26"]}})


def test_conda_concurrent_build_dedup(tmp_path, conda_stub):
    from ray_tpu_torch.cluster.pip_env import PipEnvManager

    mgr = PipEnvManager(str(tmp_path / "envs"))
    spec = {"conda": {"packages": ["pkg-a"]}}
    results = []

    def build():
        results.append(mgr.ensure(spec))

    ts = [threading.Thread(target=build) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len({r[1] for r in results}) == 1


def test_conda_missing_binary_is_loud(tmp_path, monkeypatch):
    from ray_tpu_torch.cluster import pip_env as pe

    monkeypatch.delenv("RAY_TPU_CONDA_BINARY", raising=False)
    monkeypatch.setattr(pe.shutil, "which", lambda name: None)
    mgr = pe.PipEnvManager(str(tmp_path / "envs"))
    with pytest.raises(RuntimeError, match="conda/mamba/micromamba"):
        mgr.ensure({"conda": {"packages": ["anything"]}})


def test_env_kinds_mutually_exclusive():
    from ray_tpu_torch.cluster.pip_env import env_slice

    with pytest.raises(ValueError, match="at most one"):
        env_slice({"pip": ["a"], "uv": ["b"]})
    assert env_slice({"env_vars": {"X": "1"}}) is None
    assert env_slice({"conda": {"packages": ["a"]}}) == {
        "conda": {"packages": ["a"]}
    }


def test_conda_dependencies_shape_and_nested_rejection(tmp_path, conda_stub):
    from ray_tpu_torch.cluster.pip_env import PipEnvManager

    mgr = PipEnvManager(str(tmp_path / "envs"))
    # reference environment-yaml shape: "dependencies"
    key, env_dir = mgr.ensure(
        {"conda": {"dependencies": ["python=3.12", "numpy=1.26"]}}
    )
    meta = open(os.path.join(env_dir, "conda-meta", "requested.txt")).read()
    assert "numpy=1.26" in meta and "python=3.12" in meta
    # nested pip sub-specs must fail loudly, not be silently dropped
    with pytest.raises(TypeError, match="nested conda"):
        mgr.ensure(
            {"conda": {"dependencies": ["python=3.12", {"pip": ["x"]}]}}
        )
