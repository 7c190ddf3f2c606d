"""Mirror of ``tests/test_worker_pool.py`` on the port, with ``ray_tpu``
read as ``ray_tpu_torch`` and the scheduler's rounds on the host.

Warm worker pool: fork-server spawn, scrub-based actor-worker reuse, reuse isolation, runtime-env denial, prestart hints, cold-spawn fallback.
"""
import os
import textwrap
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.cluster.rpc import RpcClient
from ray_tpu_torch.core.runtime import set_runtime


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield

LEAKY_MOD = "ray_tpu_test_leaky_mod"


def _write_leaky_module(tmp_path) -> str:
    (tmp_path / f"{LEAKY_MOD}.py").write_text(
        textwrap.dedent(
            """
            COUNTER = 0

            def bump():
                global COUNTER
                COUNTER += 1
                return COUNTER
            """
        )
    )
    return str(tmp_path)


def _pool_stats(cluster) -> dict:
    out = {}
    for nid, info in cluster.head.nodes.items():
        client = RpcClient(info.address)
        try:
            out[nid] = client.call("DebugState", timeout=10.0)["pool"]
        finally:
            client.close()
    return out


class _PoolCluster:
    """One-node cluster with the runtime installed, torn down cleanly."""

    def __init__(self, num_workers: int = 1):
        self.cluster = Cluster(use_device_scheduler=False)
        self.cluster.add_node({"CPU": 4.0}, num_workers=num_workers)
        self.rt = self.cluster.client()
        set_runtime(self.rt)

    def shutdown(self):
        set_runtime(None)
        try:
            self.rt.shutdown()
        finally:
            self.cluster.shutdown()


@pytest.fixture()
def pool_cluster(monkeypatch, tmp_path):
    monkeypatch.setenv("PYTHONPATH", _write_leaky_module(tmp_path))
    pc = _PoolCluster(num_workers=1)
    yield pc
    pc.shutdown()


class Leaker:
    """Mutates a module-global in an importable module — the canonical
    state leak a reused worker must not carry to its next actor."""

    def bump(self):
        import importlib

        m = importlib.import_module(LEAKY_MOD)
        return m.bump()

    def pid(self):
        return os.getpid()


def test_reused_worker_does_not_leak_module_state(pool_cluster):
    A = ray_tpu_torch.remote(Leaker)
    seen = []  # (pid, first_bump)
    for _ in range(4):
        a = A.options(num_cpus=0.1, max_restarts=0).remote()
        first = ray_tpu_torch.get(a.bump.remote(), timeout=60)
        assert ray_tpu_torch.get(a.bump.remote(), timeout=60) == first + 1
        seen.append((ray_tpu_torch.get(a.pid.remote(), timeout=60), first))
        ray_tpu_torch.kill(a)
        time.sleep(0.2)
    # EVERY actor saw a fresh module (counter restarts at 1), including
    # the ones placed on a scrubbed, reused worker process
    assert all(first == 1 for _, first in seen), seen
    pids = [pid for pid, _ in seen]
    assert len(set(pids)) < len(pids), (
        f"no worker process was ever reused across {len(pids)} "
        f"create/kill cycles: {pids}"
    )
    stats = _pool_stats(pool_cluster.cluster)
    assert sum(p["reused"] for p in stats.values()) >= 1, stats


def test_reuse_denied_across_runtime_envs(pool_cluster):
    A = ray_tpu_torch.remote(Leaker)
    a = A.options(
        num_cpus=0.1,
        max_restarts=0,
        runtime_env={"env_vars": {"RAY_TPU_TEST_LEAK": "1"}},
    ).remote()
    pid_env = ray_tpu_torch.get(a.pid.remote(), timeout=60)
    ray_tpu_torch.kill(a)
    time.sleep(0.5)
    # the env-tainted worker must have been killed, not returned to the
    # pool: no reuse recorded yet, and later actors land on other
    # processes (stats read BEFORE killing b — b's own clean exit may
    # legitimately reuse b's worker)
    stats = _pool_stats(pool_cluster.cluster)
    assert sum(p["reused"] for p in stats.values()) == 0, stats
    b = A.options(num_cpus=0.1, max_restarts=0).remote()
    pid_plain = ray_tpu_torch.get(b.pid.remote(), timeout=60)
    ray_tpu_torch.kill(b)
    assert pid_plain != pid_env


def test_unreloadable_import_refuses_reuse(pool_cluster):
    """An actor that drags a C-extension package (scipy here — outside
    the worker's import baseline, unlike numpy which rides in with jax)
    past the baseline makes the process unscrubbabe: the agent must
    re-fork instead of reusing it."""
    pytest.importorskip("scipy")

    @ray_tpu_torch.remote
    class ScipyUser:
        def use(self):
            import scipy.sparse as sp

            return int(sp.eye(3).nnz)

        def pid(self):
            return os.getpid()

    a = ScipyUser.options(num_cpus=0.1, max_restarts=0).remote()
    assert ray_tpu_torch.get(a.use.remote(), timeout=60) == 3
    pid_sp = ray_tpu_torch.get(a.pid.remote(), timeout=60)
    before = _pool_stats(pool_cluster.cluster)
    reused_before = sum(p["reused"] for p in before.values())
    ray_tpu_torch.kill(a)
    time.sleep(0.5)
    after = _pool_stats(pool_cluster.cluster)
    assert sum(p["reused"] for p in after.values()) == reused_before, after
    b = ScipyUser.options(num_cpus=0.1, max_restarts=0).remote()
    assert ray_tpu_torch.get(b.pid.remote(), timeout=60) != pid_sp
    ray_tpu_torch.kill(b)


def test_prestart_workers_hint_grows_pool(pool_cluster):
    cluster = pool_cluster.cluster
    info = next(iter(cluster.head.nodes.values()))
    agent = RpcClient(info.address)
    st = agent.call("DebugState", timeout=10.0)
    base = st["num_workers"]
    reply = agent.call("PrestartWorkers", {"count": base + 2}, timeout=30.0)
    assert reply["spawned"] >= 1
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        st = agent.call("DebugState", timeout=10.0)
        if (
            st["num_workers"] >= base + reply["spawned"]
            and len(st["idle_workers"]) >= reply["spawned"]
        ):
            break
        time.sleep(0.1)
    else:
        pytest.fail(f"prestarted workers never became idle: {st}")
    # idempotent: capacity already warm → a second identical hint is a no-op
    reply2 = agent.call("PrestartWorkers", {"count": base + 2}, timeout=30.0)
    assert reply2["spawned"] == 0


def test_fork_disabled_cold_spawn_fallback(monkeypatch, tmp_path):
    """RAY_TPU_FORK_SERVER=0: every worker cold-spawns and the cluster
    still creates actors + runs tasks (the chaos tier relies on this
    path surviving)."""
    monkeypatch.setenv("RAY_TPU_FORK_SERVER", "0")
    pc = _PoolCluster(num_workers=1)
    try:
        assert ray_tpu_torch.get(
            ray_tpu_torch.remote(lambda: 7).options(num_cpus=0.1).remote(),
            timeout=120,
        ) == 7

        @ray_tpu_torch.remote
        class Echo:
            def ping(self, v):
                return v

        a = Echo.options(num_cpus=0.1, max_restarts=0).remote()
        assert ray_tpu_torch.get(a.ping.remote(5), timeout=120) == 5
        ray_tpu_torch.kill(a)
        stats = _pool_stats(pc.cluster)
        for pool in stats.values():
            assert pool["forked"] == 0, stats
            assert pool["cold_spawned"] >= 1, stats
            assert pool["zygote_alive"] is False, stats
    finally:
        pc.shutdown()


def _cmdline(pid: int) -> str:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().replace(b"\0", b" ").decode()


@pytest.mark.skipif(not os.path.exists("/proc/self/cmdline"), reason="needs /proc")
def test_first_zygote_is_forked_from_the_agent_and_a_replacement_follows():
    """The agent forks its first zygote from itself before it starts a
    thread (its imports already paid), so that zygote's command line is
    the agent's; workers fork from it. After the zygote is killed, the
    agent spawns a replacement zygote process, and new workers keep
    forking."""
    pc = _PoolCluster(num_workers=1)
    try:
        f = ray_tpu_torch.remote(lambda i: i + 1).options(num_cpus=0.1)
        assert ray_tpu_torch.get(f.remote(1), timeout=120) == 2
        (nid, pool), = _pool_stats(pc.cluster).items()
        assert pool["zygote_alive"] and pool["forked"] >= 1, pool
        assert "ray_tpu_torch.cluster.agent" in _cmdline(pool["zygote_pid"])
        client = RpcClient(pc.cluster.agent_address(nid))
        try:
            reply = client.call("ChaosKillZygote", timeout=10.0)
        finally:
            client.close()
        assert reply["killed"] and reply["pid"] == pool["zygote_pid"]

        @ray_tpu_torch.remote
        class Echo:
            def ping(self, v):
                return v

        # the dead zygote's workers end within their 1 s parent watch;
        # then an actor pins a new worker: the fork finds the zygote dead
        # and the agent replaces it
        time.sleep(2.0)
        a = Echo.options(num_cpus=0.1, max_restarts=2).remote()
        assert ray_tpu_torch.get(a.ping.remote(5), timeout=120) == 5
        deadline = time.monotonic() + 60
        while True:
            (_, after), = _pool_stats(pc.cluster).items()
            if after["zygote_alive"] and after["zygote_pid"] != pool["zygote_pid"]:
                break
            assert time.monotonic() < deadline, after
            b = Echo.options(num_cpus=0.1, max_restarts=2).remote()
            assert ray_tpu_torch.get(b.ping.remote(6), timeout=120) == 6
        assert "ray_tpu_torch.cluster.zygote" in _cmdline(after["zygote_pid"])
        assert after["forked"] > pool["forked"], after
        ray_tpu_torch.kill(a)
    finally:
        pc.shutdown()


def test_concurrent_function_loads_do_not_deadlock_on_imports(tmp_path, monkeypatch):
    """A worker loads two task functions at once, one from a package and
    one from its submodule, whose imports cross: the package's import
    (held up while its spec is found, as a slow file system does) reaches
    for the submodule while the submodule's import holds its own lock and
    waits for the package. Loaded concurrently, as the reference's worker
    does, one load raises ``_DeadlockError`` (a shuffle task failed so
    under the test command's load); the worker loads one blob at a
    time."""
    import sys
    import threading
    from collections import deque
    from types import SimpleNamespace

    from ray_tpu_torch.cluster.worker import Worker

    pkg = "ray_tpu_test_crossed_imports"
    (tmp_path / pkg).mkdir()
    (tmp_path / pkg / "__init__.py").write_text(textwrap.dedent("""
        from . import sub

        def f():
            return "f"
        """))
    (tmp_path / pkg / "sub.py").write_text("def g():\n    return 'g'\n")
    monkeypatch.syspath_prepend(str(tmp_path))

    class SlowFinder:  # the package's spec takes 0.4 s to find
        def find_spec(self, name, path=None, target=None):
            if name == pkg:
                time.sleep(0.4)
            return None

    monkeypatch.setattr(sys, "meta_path", [SlowFinder(), *sys.meta_path])
    worker = SimpleNamespace(_fn_cache={}, _fn_cache_order=deque(),
                             _fn_load_lock=threading.Lock())
    blobs = {"f": f"c{pkg}\nf\n.".encode(), "g": f"c{pkg}.sub\ng\n.".encode()}
    got, errors = {}, []

    def load(name):
        try:
            got[name] = Worker._fn_from_blob(worker, name, blobs[name], True)()
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=load, args=("f",)),
                   threading.Thread(target=load, args=("g",))]
        threads[0].start()
        time.sleep(0.1)
        threads[1].start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
        assert errors == [] and got == {"f": "f", "g": "g"}
    finally:
        for name in (pkg, f"{pkg}.sub"):
            sys.modules.pop(name, None)
