"""Mirror of ``tests/test_runtime_env_pip.py`` on the port, with ``ray_tpu``
read as ``ray_tpu_torch`` and the scheduler's rounds on the host.

pip runtime-env isolation: per-requirements environments on one node (reference capability: python/ray/_private/runtime_env/pip.py + uv.py — cache key, concurrent builds, idle GC). No network: environments install from locally built wheels via --no-index --find-links.
"""
import os
import threading
import zipfile

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def _make_wheel(dirpath: str, name: str, version: str) -> str:
    """Minimal pure-python wheel with just __version__."""
    fn = os.path.join(dirpath, f"{name}-{version}-py3-none-any.whl")
    di = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(fn, "w") as z:
        z.writestr(f"{name}/__init__.py", f'__version__ = "{version}"\n')
        z.writestr(
            f"{di}/METADATA",
            f"Metadata-Version: 2.1\nName: {name}\nVersion: {version}\n",
        )
        z.writestr(
            f"{di}/WHEEL",
            "Wheel-Version: 1.0\nGenerator: test\n"
            "Root-Is-Purelib: true\nTag: py3-none-any\n",
        )
        z.writestr(
            f"{di}/RECORD",
            f"{name}/__init__.py,,\n{di}/METADATA,,\n"
            f"{di}/WHEEL,,\n{di}/RECORD,,\n",
        )
    return fn


def _pip_env(wheels: str, version: str) -> dict:
    return {
        "pip": {
            "packages": [f"conflictpkg=={version}"],
            "pip_install_args": [
                "--no-index",
                "--no-deps",
                "--quiet",
                "--find-links",
                wheels,
            ],
        }
    }


# ---------------------------------------------------------------------------
# manager unit tests
# ---------------------------------------------------------------------------


def test_env_manager_key_and_concurrent_build(tmp_path):
    from ray_tpu_torch.cluster.pip_env import PipEnvManager

    wheels = tmp_path / "wheels"
    wheels.mkdir()
    _make_wheel(str(wheels), "conflictpkg", "1.0.0")
    mgr = PipEnvManager(str(tmp_path / "envs"))
    spec = _pip_env(str(wheels), "1.0.0")["pip"]
    assert mgr.key_of(spec) == mgr.key_of(dict(spec))  # stable

    results = []

    def build():
        results.append(mgr.ensure(spec))

    ts = [threading.Thread(target=build) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    # all three converge on ONE env dir (the flock dedup)
    assert len({r[1] for r in results}) == 1
    env_dir = results[0][1]
    assert os.path.isdir(os.path.join(env_dir, "conflictpkg"))


def test_env_manager_gc_keeps_referenced(tmp_path):
    from ray_tpu_torch.cluster.pip_env import PipEnvManager

    wheels = tmp_path / "wheels"
    wheels.mkdir()
    for v in ("1.0.0", "2.0.0", "3.0.0"):
        _make_wheel(str(wheels), "conflictpkg", v)
    mgr = PipEnvManager(str(tmp_path / "envs"), max_cached=1)
    keys = []
    for v in ("1.0.0", "2.0.0", "3.0.0"):
        k, _ = mgr.ensure(_pip_env(str(wheels), v)["pip"])
        keys.append(k)
    mgr.acquire(keys[0])  # referenced: must survive GC
    removed = mgr.gc()
    assert removed == 2  # both unreferenced envs over the cap go
    assert os.path.isdir(mgr.env_dir(keys[0]))
    assert not os.path.isdir(mgr.env_dir(keys[1]))
    assert not os.path.isdir(mgr.env_dir(keys[2]))


def test_build_failure_is_loud(tmp_path):
    from ray_tpu_torch.cluster.pip_env import PipEnvManager

    mgr = PipEnvManager(str(tmp_path / "envs"))
    with pytest.raises(RuntimeError, match="pip env build failed"):
        mgr.ensure(
            {
                "packages": ["definitely-not-a-package==9.9"],
                "pip_install_args": ["--no-index", "--quiet"],
            }
        )


# ---------------------------------------------------------------------------
# cluster: conflicting versions concurrently on one node
# ---------------------------------------------------------------------------


def _ver():
    import conflictpkg

    return conflictpkg.__version__


def test_conflicting_pip_envs_one_node(tmp_path, monkeypatch):
    wheels = tmp_path / "wheels"
    wheels.mkdir()
    _make_wheel(str(wheels), "conflictpkg", "1.0.0")
    _make_wheel(str(wheels), "conflictpkg", "2.0.0")
    monkeypatch.setenv("RAY_TPU_PIP_ENV_BASE", str(tmp_path / "envs"))

    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    client = c.client()
    set_runtime(client)
    try:
        f = ray_tpu_torch.remote(_ver).options(num_cpus=0.5, max_retries=0)
        # both versions IN FLIGHT at once, one node: two env builds, two
        # env-bound workers, no cross-contamination
        r1 = f.options(
            runtime_env=_pip_env(str(wheels), "1.0.0")
        ).remote()
        r2 = f.options(
            runtime_env=_pip_env(str(wheels), "2.0.0")
        ).remote()
        assert ray_tpu_torch.get([r1, r2], timeout=240) == ["1.0.0", "2.0.0"]
        # env reuse: a third task on env 1 rides the existing worker
        r3 = f.options(
            runtime_env=_pip_env(str(wheels), "1.0.0")
        ).remote()
        assert ray_tpu_torch.get(r3, timeout=120) == "1.0.0"
    finally:
        set_runtime(None)
        client.shutdown()
        c.shutdown()


def test_local_runtime_rejects_pip_env():
    ray_tpu_torch.init(
        num_nodes=1,
        resources_per_node={"CPU": 2},
        ignore_reinit_error=True,
    )
    try:
        f = ray_tpu_torch.remote(_ver).options(
            runtime_env={"pip": ["conflictpkg==1.0.0"]}
        )
        with pytest.raises(NotImplementedError, match="pip/uv/conda runtime"):
            f.remote()
    finally:
        ray_tpu_torch.shutdown()


class _VerActor:
    def ver(self):
        import conflictpkg

        return conflictpkg.__version__


def test_actor_pip_env(tmp_path, monkeypatch):
    """Per-ACTOR runtime_env: the actor pins an env-bound worker for life."""
    wheels = tmp_path / "wheels"
    wheels.mkdir()
    _make_wheel(str(wheels), "conflictpkg", "3.1.0")
    monkeypatch.setenv("RAY_TPU_PIP_ENV_BASE", str(tmp_path / "envs"))

    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=1)
    client = c.client()
    set_runtime(client)
    try:
        A = ray_tpu_torch.remote(_VerActor).options(
            num_cpus=0.5,
            runtime_env=_pip_env(str(wheels), "3.1.0"),
        )
        a = A.remote()
        assert ray_tpu_torch.get(a.ver.remote(), timeout=180) == "3.1.0"
        assert ray_tpu_torch.get(a.ver.remote(), timeout=60) == "3.1.0"
    finally:
        set_runtime(None)
        client.shutdown()
        c.shutdown()
