"""Async (asyncio) actors on a cluster: the cluster cases of
``tests/test_async_actors.py`` on the port, with ``ray_tpu`` read as
``ray_tpu_torch`` and the scheduler's rounds on the host
(``tests/test_torch_core_api.py`` mirrors the in-process ones).
"""
import asyncio
import time

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


def test_cluster_signal_actor_many_waiters():
    """40 parked waiters + one signal: the worker must not pin a thread per
    in-flight method (the async_pending/TaskDone protocol)."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    class Signal:
        def __init__(self):
            self.event = asyncio.Event()

        async def wait(self):
            await self.event.wait()
            return 1

        async def fire(self):
            self.event.set()
            return "fired"

    c = Cluster()
    c.add_node({"CPU": 2.0}, num_workers=1)
    crt = c.client()
    set_runtime(crt)
    try:
        S = ray_tpu_torch.remote(Signal)
        s = S.remote()
        waiters = [s.wait.remote() for _ in range(40)]
        time.sleep(0.5)  # let them all park on the event
        assert ray_tpu_torch.get(s.fire.remote(), timeout=60) == "fired"
        assert ray_tpu_torch.get(waiters, timeout=60) == [1] * 40
    finally:
        set_runtime(None)
        crt.shutdown()
        c.shutdown()


def test_cluster_kill_async_actor_unblocks_inflight():
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    class Hang:
        async def forever(self):
            await asyncio.sleep(3600)

        async def ping(self):
            return "pong"

    c = Cluster()
    c.add_node({"CPU": 2.0}, num_workers=1)
    crt = c.client()
    set_runtime(crt)
    try:
        H = ray_tpu_torch.remote(Hang)
        h = H.remote()
        assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"
        refs = [h.forever.remote() for _ in range(3)]
        time.sleep(0.3)
        ray_tpu_torch.kill(h)
        for ref in refs:
            with pytest.raises(Exception):
                ray_tpu_torch.get(ref, timeout=20)
    finally:
        set_runtime(None)
        crt.shutdown()
        c.shutdown()


def test_cluster_async_actor_multiplexes():
    """Cluster mode: async methods interleave on the worker's event loop
    (agent bypasses the per-actor FIFO for asyncio actors)."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    class Sleeper:
        async def nap(self):
            await asyncio.sleep(0.3)
            return 1

        async def ping(self):
            return "pong"

    c = Cluster()
    c.add_node({"CPU": 2.0}, num_workers=1)
    crt = c.client()
    set_runtime(crt)
    try:
        S = ray_tpu_torch.remote(Sleeper)
        s = S.remote()
        # warm the scheduling path (first-round kernel compile) off the clock
        assert ray_tpu_torch.get(s.ping.remote(), timeout=60) == "pong"
        t0 = time.monotonic()
        refs = [s.nap.remote() for _ in range(8)]
        # a quick method is not stuck behind the naps
        assert ray_tpu_torch.get(s.ping.remote(), timeout=30) == "pong"
        assert ray_tpu_torch.get(refs, timeout=60) == [1] * 8
        dt = time.monotonic() - t0
        assert dt < 1.6, f"cluster async naps serialized: {dt:.2f}s"
    finally:
        set_runtime(None)
        crt.shutdown()
        c.shutdown()


def test_await_object_ref_cluster():
    """Awaitable refs work from inside cluster worker processes too."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    client = c.client()
    set_runtime(client)
    try:

        @ray_tpu_torch.remote
        def produce(x):
            return x + 100

        @ray_tpu_torch.remote(num_cpus=0.25)
        class Waiter:
            async def sum_refs(self, refs):
                total = 0
                for r in refs:
                    total += await r
                return total

        w = Waiter.remote()
        refs = [produce.remote(i) for i in range(4)]
        assert ray_tpu_torch.get(w.sum_refs.remote(list(refs)), timeout=120) == 406
    finally:
        set_runtime(None)
        client.shutdown()
        c.shutdown()
