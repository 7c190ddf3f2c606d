"""Distributed multi-process runtime tests.

The analog of the reference's multi-node pytest tier
(Ray's python/ray/tests/ with ray_start_cluster,
conftest.py:696): a real head + real node-agent subprocesses + real worker
subprocesses on one machine, exercising cross-process task execution,
object transfer, actors, placement groups, and failure handling.

Mirror of ``tests/test_cluster.py`` on the port (``ray_tpu_torch``), the same
cases and assertions. ``_collective_rank`` runs the port's copy of the host collectives
(``ray_tpu_torch.collective``).
"""
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.object_store import TaskError


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's head brings its scheduler up on cuda and raises without it;
    # here its rounds run the same programs on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


# module-scope: one 2-node cluster shared by the happy-path tests
@pytest.fixture(scope="module")
def cluster():
    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    c.add_node({"CPU": 4.0}, num_workers=2)
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def client(cluster):
    rt = cluster.client()
    from ray_tpu_torch.core.runtime import set_runtime

    set_runtime(rt)
    yield rt
    set_runtime(None)


def _square(x):
    return x * x


def _add(a, b):
    return a + b


def _whoami():
    import os

    return os.getpid(), os.environ.get("RAY_TPU_NODE_ID")


def _big_array(n):
    return np.arange(n, dtype=np.float32)


class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
        return self.value

    def set(self, v):
        self.value = v
        return self.value

    def get(self):
        return self.value


def test_task_round_trip(client):
    f = ray_tpu_torch.remote(_square)
    assert ray_tpu_torch.get(f.remote(7), timeout=60) == 49


def test_tasks_spread_across_processes(client):
    f = ray_tpu_torch.remote(_whoami)
    out = ray_tpu_torch.get([f.remote() for _ in range(16)], timeout=60)
    pids = {pid for pid, _ in out}
    nodes = {node for _, node in out}
    assert len(pids) >= 2, f"expected multiple worker processes, got {pids}"
    assert len(nodes) >= 2, f"expected both nodes used, got {nodes}"


def test_task_chaining_and_object_transfer(client):
    f = ray_tpu_torch.remote(_big_array)
    g = ray_tpu_torch.remote(_add)
    a = f.remote(50_000)  # ~200KB -> shared-memory store
    b = f.remote(50_000)
    total = ray_tpu_torch.get(g.remote(a, b), timeout=60)
    np.testing.assert_allclose(total, 2 * np.arange(50_000, dtype=np.float32))


def test_driver_put_and_get(client):
    small = ray_tpu_torch.put({"k": 1})
    big = ray_tpu_torch.put(np.ones(100_000, dtype=np.float32))
    assert ray_tpu_torch.get(small, timeout=30) == {"k": 1}
    np.testing.assert_allclose(
        ray_tpu_torch.get(big, timeout=30), np.ones(100_000, dtype=np.float32)
    )


def test_task_error_propagates(client):
    def boom():
        raise ValueError("kaboom")

    f = ray_tpu_torch.remote(boom)
    with pytest.raises(TaskError, match="kaboom"):
        ray_tpu_torch.get(f.remote(), timeout=60)


def test_wait(client):
    def slow(t):
        time.sleep(t)
        return t

    f = ray_tpu_torch.remote(slow)
    refs = [f.remote(0.05), f.remote(5.0)]
    ready, pending = ray_tpu_torch.wait(refs, num_returns=1, timeout=30)
    assert ready == [refs[0]] and pending == [refs[1]]


def test_nested_tasks(client):
    def outer(n):
        import ray_tpu_torch as rt

        inner = rt.remote(_square)
        return sum(rt.get([inner.remote(i) for i in range(n)], timeout=60))

    f = ray_tpu_torch.remote(outer)
    assert ray_tpu_torch.get(f.remote(4), timeout=90) == 0 + 1 + 4 + 9


def test_actor_lifecycle(client):
    Actor = ray_tpu_torch.remote(Counter)
    c = Actor.options(name="counter").remote(10)
    assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 11
    assert ray_tpu_torch.get(c.incr.remote(5), timeout=30) == 16
    # method ordering: many increments land sequentially
    refs = [c.incr.remote() for _ in range(10)]
    assert ray_tpu_torch.get(refs[-1], timeout=30) == 26
    # named lookup from the driver
    again = ray_tpu_torch.get_actor("counter")
    assert ray_tpu_torch.get(again.get.remote(), timeout=30) == 26
    ray_tpu_torch.kill(again)
    time.sleep(0.3)
    with pytest.raises(Exception):
        ray_tpu_torch.get(again.get.remote(), timeout=10)


def test_actor_method_ordering(client):
    """Non-commutative ops: submission order must be execution order."""
    Actor = ray_tpu_torch.remote(Counter)
    c = Actor.remote(0)
    refs = [c.set.remote(i) for i in range(1, 30)]
    ray_tpu_torch.get(refs, timeout=60)
    assert ray_tpu_torch.get(c.get.remote(), timeout=30) == 29


def test_placement_group_cluster(client):
    pg = ray_tpu_torch.placement_group(
        [{"CPU": 1.0}, {"CPU": 1.0}], strategy="STRICT_SPREAD"
    )
    assert pg.wait(30)
    from ray_tpu_torch.core.scheduling_strategies import PlacementGroupSchedulingStrategy

    f = ray_tpu_torch.remote(_whoami).options(
        num_cpus=1,
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0
        ),
    )
    g = ray_tpu_torch.remote(_whoami).options(
        num_cpus=1,
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=1
        ),
    )
    (_, n0), (_, n1) = ray_tpu_torch.get([f.remote(), g.remote()], timeout=60)
    assert n0 != n1, "STRICT_SPREAD bundles must land on distinct nodes"
    ray_tpu_torch.remove_placement_group(pg)


def _foreign_modules():
    import sys

    return sorted(
        m for m in sys.modules
        if m in ("jax", "ray_tpu") or m.startswith(("jax.", "ray_tpu."))
    )


def test_worker_loads_neither_jax_nor_ray_tpu(client):
    """A worker of the port's cluster runs tasks with neither ``jax`` nor
    any module of the JAX package loaded."""
    f = ray_tpu_torch.remote(_foreign_modules)
    assert ray_tpu_torch.get([f.remote() for _ in range(4)], timeout=60) == [[]] * 4


def test_kv_store(client):
    client.kv_put("jobs/1", b"cfg")
    assert client.kv_get("jobs/1") == b"cfg"
    assert "jobs/1" in client.kv_keys("jobs/")
    client.kv_del("jobs/1")
    assert client.kv_get("jobs/1") is None


def test_state_queries(client):
    info = client.query_state()
    assert info["num_nodes"] == 2
    nodes = ray_tpu_torch.nodes()
    assert sum(1 for n in nodes if n["Alive"]) == 2
    assert client.cluster_resources()["CPU"] == 8.0


def _collective_rank(rank, world):
    import numpy as np

    import ray_tpu_torch.collective as col

    col.init_collective_group(world, rank, backend="distributed", group_name="g1")
    red = col.allreduce(np.ones(4) * (rank + 1), group_name="g1")
    bc = col.broadcast(
        np.arange(3.0) if rank == 0 else np.zeros(3), 0, group_name="g1"
    )
    col.barrier(group_name="g1")
    if rank == 0:
        col.send(np.array([7.0]), 1, group_name="g1")
        p2p = 7.0
    else:
        p2p = float(col.recv(0, group_name="g1", timeout=60)[0])
    return red.tolist(), bc.tolist(), p2p


def test_distributed_collectives(client):
    """DCN host collectives: ranks in separate worker processes rendezvous
    through a named actor (NCCL/Gloo host-group analog)."""
    f = ray_tpu_torch.remote(_collective_rank)
    out = ray_tpu_torch.get([f.remote(r, 2) for r in range(2)], timeout=240)
    for red, bc, p2p in out:
        assert red == [3.0, 3.0, 3.0, 3.0]  # 1+2
        assert bc == [0.0, 1.0, 2.0]
        assert p2p == 7.0


# --- chaos: node failure ---------------------------------------------------


def test_node_death_task_retry_and_actor_restart():
    c = Cluster()
    n1 = c.add_node({"CPU": 2.0}, num_workers=2)
    n2 = c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    from ray_tpu_torch.core.runtime import set_runtime

    set_runtime(rt)
    try:
        Actor = ray_tpu_torch.remote(Counter)
        a = Actor.options(max_restarts=1).remote(0)
        assert ray_tpu_torch.get(a.incr.remote(), timeout=60) == 1
        info = rt.wait_actor_alive(a)
        actor_node = info.node_id

        # a long task pinned on the doomed node via affinity
        def slow_value():
            time.sleep(1.0)
            return 42

        from ray_tpu_torch.core.scheduling_strategies import NodeAffinitySchedulingStrategy

        f = ray_tpu_torch.remote(slow_value).options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=actor_node, soft=True
            )
        )
        ref = f.remote()
        time.sleep(0.2)
        c.kill_node(actor_node)
        # task retries on the surviving node (lease respawn / lineage)
        assert ray_tpu_torch.get(ref, timeout=90) == 42
        # actor restarts on the surviving node (fresh state)
        deadline = time.monotonic() + 60
        value = None
        while time.monotonic() < deadline:
            try:
                value = ray_tpu_torch.get(a.incr.remote(), timeout=20)
                break
            except Exception:
                time.sleep(0.5)
        assert value == 1, f"restarted actor should reset state, got {value}"
        survivors = [n["NodeID"] for n in ray_tpu_torch.nodes() if n["Alive"]]
        assert survivors == [n2] or survivors == [n1]
    finally:
        set_runtime(None)
        c.shutdown()


def _sleepy(t):
    import time as _t

    _t.sleep(t)
    return t


def test_cancel_queued_task(client):
    """ray.cancel parity in cluster mode: a task still queued behind a
    full cluster is dropped and its get() raises; running tasks are not
    preempted by a non-force cancel."""
    from ray_tpu_torch.core.runtime import set_runtime

    set_runtime(client)  # an earlier test may have cleared the global
    # saturate the CPUs so later submissions stay queued at the head
    blockers = [
        ray_tpu_torch.remote(_sleepy).options(num_cpus=4.0, max_retries=0).remote(4)
        for _ in range(2)
    ]
    victim = (
        ray_tpu_torch.remote(_sleepy).options(num_cpus=4.0, max_retries=0).remote(0)
    )
    time.sleep(0.5)  # let the victim reach the head queue
    ray_tpu_torch.cancel(victim)
    with pytest.raises(Exception) as ei:
        ray_tpu_torch.get(victim, timeout=30)
    assert "cancel" in repr(ei.value).lower()
    # the blockers were running: unaffected, they complete normally
    assert ray_tpu_torch.get(blockers, timeout=60) == [4, 4]


def test_repeated_connect_teardown_no_stray_threads(cluster):
    """Repeated connect/shutdown cycles leave no sender/retry threads
    behind and raise no unhandled thread exceptions (the r4 suite ended
    with cannot-schedule-new-futures from the control-item sender racing
    the channel close; _PipelinedSender.stop now joins first)."""
    import threading

    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.cluster.client import connect

    # the module-scoped client fixture legitimately keeps ITS sender
    # thread alive for the whole module: assert no NEW ones appear
    before = {
        id(t)
        for t in threading.enumerate()
        if t.name.startswith("lease-pipeline")
    }
    for _ in range(4):
        rt = connect(cluster.address)
        set_runtime(rt)
        try:
            f = ray_tpu_torch.remote(_square).options(
                num_cpus=0.5, max_retries=0
            )
            assert ray_tpu_torch.get(
                [f.remote(i) for i in range(8)], timeout=60
            ) == [i * i for i in range(8)]
        finally:
            set_runtime(None)
            rt.shutdown()
    time.sleep(0.5)
    stray = [
        t.name
        for t in threading.enumerate()
        if t.is_alive()
        and t.name.startswith("lease-pipeline")
        and id(t) not in before
    ]
    assert not stray, stray


class _KVStore:
    def __init__(self):
        self.d = {}

    def put(self, k, v):
        self.d[k] = v
        return True

    def get(self, k):
        return self.d.get(k)


def test_detached_actor_lifetime():
    """lifetime="detached" actors survive their creating driver's
    disconnect and stay reachable by name from a new driver; default
    (non-detached) actors are reaped at driver disconnect (reference
    actor.py:1875 detached lifetimes / job-exit reaping)."""
    from ray_tpu_torch.cluster.client import connect
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    try:
        # driver A: one detached, one default actor
        rtA = connect(c.address)
        set_runtime(rtA)
        KV = ray_tpu_torch.remote(_KVStore)
        det = KV.options(
            name="detached-store", lifetime="detached", num_cpus=0.5
        ).remote()
        tmp = KV.options(name="temp-store", num_cpus=0.5).remote()
        assert ray_tpu_torch.get(det.put.remote("x", 42), timeout=60)
        assert ray_tpu_torch.get(tmp.put.remote("y", 7), timeout=60)
        set_runtime(None)
        rtA.shutdown()

        # driver B: detached actor reachable with state intact; the
        # non-detached one was reaped with driver A
        rtB = connect(c.address)
        set_runtime(rtB)
        try:
            h = ray_tpu_torch.get_actor("detached-store")
            assert ray_tpu_torch.get(h.get.remote("x"), timeout=60) == 42
            dead = True
            try:
                h2 = ray_tpu_torch.get_actor("temp-store")
                ray_tpu_torch.get(h2.get.remote("y"), timeout=20)
                dead = False
            except Exception:
                pass
            assert dead, "non-detached actor survived its driver"
            # explicit kill is the only way a detached actor dies
            ray_tpu_torch.kill(h)
            deadline = time.monotonic() + 30
            gone = False
            while time.monotonic() < deadline and not gone:
                try:
                    ray_tpu_torch.get(
                        ray_tpu_torch.get_actor("detached-store").get.remote("x"),
                        timeout=5,
                    )
                    time.sleep(0.5)
                except Exception:
                    gone = True
            assert gone
        finally:
            set_runtime(None)
            rtB.shutdown()
    finally:
        c.shutdown()


def test_detached_actor_survives_head_restart(tmp_path):
    """Detached actor + its name registration persist across a head
    restart (WAL actor records + agent re-attach)."""
    from ray_tpu_torch.cluster.client import connect
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster(persist_path=str(tmp_path / "head_state.pkl"))
    c.add_node({"CPU": 4.0}, num_workers=2)
    try:
        rtA = connect(c.address)
        set_runtime(rtA)
        det = (
            ray_tpu_torch.remote(_KVStore)
            .options(
                name="restart-store",
                lifetime="detached",
                num_cpus=0.5,
            )
            .remote()
        )
        assert ray_tpu_torch.get(det.put.remote("k", 99), timeout=60)
        set_runtime(None)
        rtA.shutdown()

        c.restart_head()

        rtB = connect(c.address)
        set_runtime(rtB)
        try:
            h = ray_tpu_torch.get_actor("restart-store")
            assert ray_tpu_torch.get(h.get.remote("k"), timeout=90) == 99
        finally:
            set_runtime(None)
            rtB.shutdown()
    finally:
        c.shutdown()
