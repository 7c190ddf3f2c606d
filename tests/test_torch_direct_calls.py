"""Mirror of ``tests/test_direct_calls.py`` on the port, with ``ray_tpu``
read as ``ray_tpu_torch`` and the scheduler's rounds on the host.

Direct actor-call submission (caller -> worker, head off the hot path).
"""
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.runtime import set_runtime


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


@pytest.fixture(scope="module")
def cluster():
    from ray_tpu_torch.cluster import Cluster

    c = Cluster()
    c.add_node({"CPU": 8.0}, num_workers=3)
    yield c
    c.shutdown()


@pytest.fixture()
def client(cluster):
    rt = cluster.client()
    set_runtime(rt)
    yield rt
    set_runtime(None)
    rt.shutdown()


class _Seq:
    def __init__(self):
        self.log = []

    def add(self, i):
        self.log.append(i)
        return i

    def get_log(self):
        return list(self.log)


def test_sync_actor_ordering_under_burst(client):
    """A sync actor must observe one caller's methods in submission order
    even when they ride several DirectPushBatch RPCs."""
    A = ray_tpu_torch.remote(_Seq).options(num_cpus=0.5)
    a = A.remote()
    refs = [a.add.remote(i) for i in range(200)]
    assert ray_tpu_torch.get(refs, timeout=120) == list(range(200))
    assert ray_tpu_torch.get(a.get_log.remote(), timeout=60) == list(range(200))


def test_direct_result_kinds(client):
    """Small inline results, large store-sealed results, and errors all
    resolve correctly through the direct path."""
    import numpy as np

    @ray_tpu_torch.remote(num_cpus=0.5)
    class W:
        def small(self):
            return {"x": 1}

        def big(self, n):
            return np.ones(n, dtype=np.float32)

        def boom(self):
            raise ValueError("direct boom")

    w = W.remote()
    assert ray_tpu_torch.get(w.small.remote(), timeout=60) == {"x": 1}
    arr = ray_tpu_torch.get(w.big.remote(300_000), timeout=60)
    assert arr.shape == (300_000,) and float(arr.sum()) == 300_000.0
    from ray_tpu_torch.core.object_store import TaskError

    with pytest.raises(TaskError, match="direct boom"):
        ray_tpu_torch.get(w.boom.remote(), timeout=60)


def test_direct_ref_passed_to_task(client):
    """A direct-call return ref must be resolvable by OTHER consumers (the
    seal reaches the head's directory): pass it as a dependency of a
    scheduled task on another worker."""

    @ray_tpu_torch.remote(num_cpus=0.5)
    class P:
        def make(self, v):
            return v * 2

    @ray_tpu_torch.remote
    def consume(x):
        return x + 1

    p = P.remote()
    ref = p.make.remote(21)
    assert ray_tpu_torch.get(consume.remote(ref), timeout=60) == 43


def test_direct_disabled_env(cluster, monkeypatch):
    monkeypatch.setenv("RAY_TPU_DIRECT_ACTOR_CALLS", "0")
    rt = cluster.client()
    set_runtime(rt)
    try:
        assert not rt._direct_enabled

        @ray_tpu_torch.remote(num_cpus=0.5)
        class E:
            def f(self, x):
                return x * 3

        e = E.remote()
        assert ray_tpu_torch.get(e.f.remote(4), timeout=60) == 12
    finally:
        set_runtime(None)
        rt.shutdown()


def test_direct_fallback_on_actor_death(client):
    """Killing the actor mid-stream must surface a clean death error via
    the fallback path, not hang the caller."""

    @ray_tpu_torch.remote(num_cpus=0.5)
    class D:
        def f(self, x):
            return x

    d = D.remote()
    assert ray_tpu_torch.get(d.f.remote(1), timeout=60) == 1
    ray_tpu_torch.kill(d)
    time.sleep(0.5)
    with pytest.raises(Exception):
        ray_tpu_torch.get(d.f.remote(2), timeout=30)


def test_deferred_seal_share_after_consume(client):
    """Owner-held direct results (cfg.direct_deferred_seals): the head
    never hears about a small result until its ref is shared — then the
    owner uploads it and any node can resolve it."""

    @ray_tpu_torch.remote(num_cpus=0.5)
    class P:
        def make(self, v):
            return {"v": v}

    @ray_tpu_torch.remote
    def consume(x):
        return x["v"] + 1

    p = P.remote()
    ref = p.make.remote(10)
    # consume locally first (entry must stay cached for the later share)
    assert ray_tpu_torch.get(ref, timeout=60) == {"v": 10}
    assert ray_tpu_torch.get(ref, timeout=60) == {"v": 10}  # repeat get works
    # now share into a scheduled task: triggers the owner upload
    assert ray_tpu_torch.get(consume.remote(ref), timeout=60) == 11


def test_deferred_seal_nested_in_put(client):
    """A put() whose value CONTAINS an owner-held ref uploads that object
    first, so a task receiving the outer ref can resolve the inner one."""

    @ray_tpu_torch.remote(num_cpus=0.5)
    class P:
        def make(self, v):
            return v * 3

    @ray_tpu_torch.remote
    def consume(box):
        return ray_tpu_torch.get(box["inner"]) + 1

    p = P.remote()
    inner = p.make.remote(5)
    ray_tpu_torch.get(inner, timeout=60)
    outer = ray_tpu_torch.put({"inner": inner})
    assert ray_tpu_torch.get(consume.remote(outer), timeout=60) == 16
