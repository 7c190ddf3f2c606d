"""The local runtime of the port (``ray_tpu_torch.core``), on the CPU path.

Mirrors, case for case, ``tests/test_core_api.py`` (all 27 cases, same
3-node fixture) and the in-process cases of ``test_native_store.py``,
``test_streaming_generators.py``, ``test_async_actors.py``,
``test_dependency_dispatch.py`` and ``test_refcounting.py``, with each
case's own cluster shape. Every case schedules through
``DeviceSchedulerState`` on the CPU (``RAY_TPU_SCHED_PLATFORM=cpu``); the
last case checks that ``init()`` raises without CUDA when no platform is
set.
"""
import asyncio
import gc
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rtt
from ray_tpu_torch.core.object_store import ObjectRefGenerator, TaskError
from ray_tpu_torch.core.refcount import TRACKER
from ray_tpu_torch.core.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)
from ray_tpu_torch.native import NativeObjectStore


@pytest.fixture(autouse=True)
def _cpu_scheduler(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")


def _runtime(**shape):
    """The cluster a case runs on, where it differs from test_core_api's."""

    def mark(fn):
        fn._runtime_shape = shape
        return fn

    return mark


@pytest.fixture()
def rt(request, monkeypatch):
    shape = dict(getattr(request.function, "_runtime_shape", None) or dict(
        num_nodes=3, resources_per_node={"CPU": 4, "memory": float(1 << 30)}))
    store_bytes = shape.pop("store_bytes", None)
    if store_bytes is not None:
        monkeypatch.setenv("RAY_TPU_STORE_BYTES", str(store_bytes))
    runtime = rtt.init(**shape, ignore_reinit_error=False)
    assert runtime.device_state is not None and runtime.device_state.device.type == "cpu"
    yield runtime
    rtt.shutdown()


@pytest.fixture()
def store(tmp_path):
    s = NativeObjectStore(path=str(tmp_path / "test.shm"), capacity=1 << 22)
    yield s
    s.close(unlink=True)


# ---------------------------------------------------------------------------
# tests/test_core_api.py
# ---------------------------------------------------------------------------

def test_put_get(rt):
    ref = rtt.put({"a": 1})
    assert rtt.get(ref) == {"a": 1}


def test_task_roundtrip(rt):
    @rtt.remote
    def add(a, b):
        return a + b

    assert rtt.get(add.remote(2, 3)) == 5


def test_task_with_object_ref_args(rt):
    @rtt.remote
    def double(x):
        return 2 * x

    r1 = double.remote(10)
    r2 = double.remote(r1)
    assert rtt.get(r2) == 40


def test_many_tasks_parallel(rt):
    @rtt.remote
    def f(i):
        return i * i

    refs = [f.remote(i) for i in range(100)]
    assert rtt.get(refs) == [i * i for i in range(100)]


def test_multiple_returns(rt):
    @rtt.remote(num_returns=2)
    def two():
        return 1, 2

    a, b = two.remote()
    assert rtt.get(a) == 1 and rtt.get(b) == 2


def test_task_error_propagates(rt):
    @rtt.remote
    def boom():
        raise ValueError("bad")

    with pytest.raises(rtt.core.object_store.TaskError) as ei:
        rtt.get(boom.remote())
    assert isinstance(ei.value.cause, ValueError)


def test_wait(rt):
    @rtt.remote
    def slow(t):
        time.sleep(t)
        return t

    refs = [slow.remote(0.01), slow.remote(5)]
    ready, not_ready = rtt.wait(refs, num_returns=1, timeout=2)
    assert len(ready) == 1 and len(not_ready) == 1
    assert rtt.get(ready[0]) == 0.01


def test_resources_respected(rt):
    # 3 nodes x 4 CPUs; 4-CPU tasks must land on distinct nodes.
    @rtt.remote(num_cpus=4)
    def whereami():
        from ray_tpu_torch.core.runtime import get_context

        time.sleep(0.2)
        return get_context().node_id

    nodes = rtt.get([whereami.remote() for _ in range(3)])
    assert len(set(nodes)) == 3


def test_infeasible_task_waits_then_runs_after_node_add(rt):
    @rtt.remote(num_cpus=64)
    def big():
        return "ok"

    ref = big.remote()
    ready, _ = rtt.wait([ref], timeout=0.3)
    assert not ready  # infeasible: parked
    rt.add_node({"CPU": 64, "memory": float(1 << 30)})
    assert rtt.get(ref, timeout=10) == "ok"


def test_actor_basic(rt):
    @rtt.remote
    class Counter:
        def __init__(self, start=0):
            self.v = start

        def inc(self, by=1):
            self.v += by
            return self.v

        def value(self):
            return self.v

    c = Counter.remote(10)
    assert rtt.get(c.inc.remote()) == 11
    assert rtt.get(c.inc.remote(5)) == 16
    assert rtt.get(c.value.remote()) == 16


def test_actor_methods_ordered(rt):
    @rtt.remote
    class Appender:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)
            return list(self.items)

    a = Appender.remote()
    refs = [a.add.remote(i) for i in range(20)]
    final = rtt.get(refs[-1])
    assert final == list(range(20))


def test_named_actor(rt):
    @rtt.remote
    class Svc:
        def ping(self):
            return "pong"

    Svc.options(name="svc").remote()
    h = rtt.core.api.get_actor("svc")
    assert rtt.get(h.ping.remote()) == "pong"


def test_kill_actor(rt):
    @rtt.remote
    class A:
        def f(self):
            return 1

    a = A.remote()
    assert rtt.get(a.f.remote()) == 1
    rtt.kill(a)
    with pytest.raises(Exception):
        rtt.get(a.f.remote(), timeout=5)


def test_actor_restart_on_node_death(rt):
    @rtt.remote(max_restarts=1, num_cpus=1)
    class Stateful:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

        def where(self):
            from ray_tpu_torch.core.runtime import get_context

            return get_context().node_id

    s = Stateful.remote()
    assert rtt.get(s.bump.remote()) == 1
    node = rtt.get(s.where.remote())
    rt.kill_node(node)
    # restarted elsewhere, state reset (reference restart semantics)
    assert rtt.get(s.bump.remote(), timeout=10) == 1
    assert rtt.get(s.where.remote()) != node


def test_node_affinity_strategy(rt):
    target = rtt.nodes()[1]["NodeID"]

    @rtt.remote(scheduling_strategy=NodeAffinitySchedulingStrategy(target))
    def whereami():
        from ray_tpu_torch.core.runtime import get_context

        return get_context().node_id

    assert rtt.get(whereami.remote()) == target


def test_placement_group_pack_and_task(rt):
    pg = rtt.placement_group([{"CPU": 2}, {"CPU": 2}], strategy="PACK")
    assert rtt.get(pg.ready(), timeout=10) is True
    table = rtt.placement_group_table()[pg.id]
    assert table["state"] == "CREATED"
    b0 = table["bundles"][0]["node_id"]
    b1 = table["bundles"][1]["node_id"]
    assert b0 == b1  # PACK on a fresh cluster → same node

    @rtt.remote(
        num_cpus=2,
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0
        ),
    )
    def inside():
        from ray_tpu_torch.core.runtime import get_context

        return get_context().node_id

    assert rtt.get(inside.remote(), timeout=10) == b0
    rtt.remove_placement_group(pg)


def test_placement_group_strict_spread(rt):
    pg = rtt.placement_group(
        [{"CPU": 1}] * 3, strategy="STRICT_SPREAD"
    )
    assert rtt.get(pg.ready(), timeout=10) is True
    t = rtt.placement_group_table()[pg.id]
    hosts = {b["node_id"] for b in t["bundles"].values()}
    assert len(hosts) == 3


def test_pg_infeasible_until_node_added(rt):
    pg = rtt.placement_group([{"CPU": 32}], strategy="PACK")
    assert not pg.wait(timeout_seconds=0.3)
    rt.add_node({"CPU": 32, "memory": float(1 << 30)})
    assert pg.wait(timeout_seconds=10)


def test_cluster_and_available_resources(rt):
    total = rtt.cluster_resources()
    assert total["CPU"] == 12.0

    @rtt.remote(num_cpus=4)
    def hold():
        time.sleep(0.5)
        return 1

    ref = hold.remote()
    time.sleep(0.2)
    avail = rtt.available_resources()
    assert avail["CPU"] <= 8.0
    rtt.get(ref)


def test_nested_tasks(rt):
    @rtt.remote
    def inner(x):
        return x + 1

    @rtt.remote
    def outer(x):
        return rtt.get(inner.remote(x)) * 10

    assert rtt.get(outer.remote(1)) == 20


def test_lineage_reconstruction_on_node_death(rt):
    calls = []

    @rtt.remote(num_cpus=1)
    def produce():
        from ray_tpu_torch.core.runtime import get_context

        calls.append(1)
        return ("data", get_context().node_id)

    ref = produce.remote()
    _, node = rtt.get(ref)
    rt.kill_node(node)
    data, node2 = rtt.get(ref, timeout=10)  # rebuilt via lineage
    assert data == "data"
    assert len(calls) == 2


def test_wait_num_returns_validation(rt):
    ref = rtt.put(1)
    with pytest.raises(ValueError):
        rtt.wait([ref], num_returns=2)


def test_cancel_seals_all_sibling_returns(rt):
    @rtt.remote(num_cpus=999, num_returns=2)  # infeasible → stays queued
    def two():
        return 1, 2

    r1, r2 = two.remote()
    time.sleep(0.2)
    rtt.cancel(r1)
    for r in (r1, r2):
        with pytest.raises(Exception):
            rtt.get(r, timeout=5)


def test_get_actor_exported(rt):
    @rtt.remote
    class S:
        def ping(self):
            return "pong"

    S.options(name="s2").remote()
    assert rtt.get(rtt.get_actor("s2").ping.remote()) == "pong"


def test_hard_node_affinity_to_dead_node_fails_fast(rt):
    victim = rtt.nodes()[0]["NodeID"]
    rt.kill_node(victim)

    @rtt.remote(
        scheduling_strategy=NodeAffinitySchedulingStrategy(victim, soft=False)
    )
    def f():
        return 1

    with pytest.raises(Exception):
        rtt.get(f.remote(), timeout=5)


def test_feasible_but_busy_task_parks_then_runs(rt):
    # Occupy every CPU, then submit one more task; it must park (not spin)
    # and run when capacity frees.
    import threading

    gate = threading.Event()

    @rtt.remote(num_cpus=4)
    def hog():
        gate.wait(5)
        return "hog"

    hogs = [hog.remote() for _ in range(3)]  # 3 nodes x 4 CPU all busy
    time.sleep(0.3)

    @rtt.remote(num_cpus=4)
    def late():
        return "late"

    late_ref = late.remote()
    time.sleep(0.3)
    rounds_before = rt.metrics["sched_rounds"]
    time.sleep(0.5)
    assert rt.metrics["sched_rounds"] - rounds_before < 20  # parked, not spinning
    gate.set()
    assert rtt.get(late_ref, timeout=10) == "late"
    rtt.get(hogs)


def test_large_arrays_route_through_native_store(rt):
    if rt.native_store is None:
        pytest.skip("native toolchain unavailable")

    @rtt.remote
    def produce():
        return np.arange(100_000, dtype=np.float32)  # 400 KB > threshold

    ref = produce.remote()
    out = rtt.get(ref)
    assert out.shape == (100_000,)
    assert out[-1] == 99_999.0
    assert rt.native_store.stats()["num_objects"] >= 1
    # zero-copy views are read-only
    with pytest.raises(ValueError):
        out[0] = 1.0

# ---------------------------------------------------------------------------
# tests/test_native_store.py (a store of its own, no runtime)
# ---------------------------------------------------------------------------

def test_put_get_bytes(store):
    store.put_bytes("obj1", b"hello world")
    assert store.get_bytes("obj1") == b"hello world"
    assert store.contains("obj1")
    assert not store.contains("missing")


def test_duplicate_put_rejected(store):
    store.put_bytes("dup", b"a")
    with pytest.raises(KeyError):
        store.put_bytes("dup", b"b")


def test_numpy_roundtrip_zero_copy(store):
    arr = np.arange(10000, dtype=np.float32).reshape(100, 100)
    store.put_numpy("arr", arr)
    out = store.get_numpy("arr")
    np.testing.assert_array_equal(out, arr)
    assert not out.flags.writeable  # shared pages are read-only views


def test_delete_frees_space(store):
    before = store.stats()["used"]
    store.put_bytes("tmp", b"x" * 100000)
    assert store.stats()["used"] > before
    store.delete("tmp")
    assert store.stats()["used"] == before
    assert not store.contains("tmp")
    # space is reusable
    store.put_bytes("tmp2", b"y" * 100000)
    assert store.get_bytes("tmp2") == b"y" * 100000


def test_allocation_failure_raises(store):
    with pytest.raises(MemoryError):
        store.put_bytes("huge", b"z" * (1 << 23))  # 8 MiB > 4 MiB arena


def test_many_objects_and_reuse(store):
    for i in range(500):
        store.put_bytes(f"o{i}", bytes([i % 256]) * 128)
    assert store.stats()["num_objects"] == 500
    for i in range(0, 500, 2):
        store.delete(f"o{i}")
    for i in range(1, 500, 2):
        assert store.get_bytes(f"o{i}") == bytes([i % 256]) * 128


CHILD = """
import sys
import numpy as np
from ray_tpu_torch.native import NativeObjectStore
s = NativeObjectStore(path=sys.argv[1], create=False)
arr = s.get_numpy("shared")          # zero-copy view from another process
assert arr.sum() == 499500, arr.sum()
s.put_bytes("reply", b"seen-by-child")
s.close()
print("CHILD_OK")
"""


def test_cross_process_sharing(store):
    store.put_numpy("shared", np.arange(1000, dtype=np.int64))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, store.path],
        capture_output=True,
        text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=60,
    )
    assert "CHILD_OK" in proc.stdout, proc.stderr
    assert store.get_bytes("reply") == b"seen-by-child"

# ---------------------------------------------------------------------------
# tests/test_streaming_generators.py, in-process cases
# ---------------------------------------------------------------------------

def _count(n):
    for i in range(n):
        yield i * 2


@_runtime(num_nodes=2, resources_per_node={"CPU": 4.0})
def test_local_streaming_basic(rt):
    g = (
        rtt.remote(_count)
        .options(num_returns="streaming", num_cpus=0.5)
        .remote(10)
    )
    assert isinstance(g, ObjectRefGenerator)
    vals = [rtt.get(r, timeout=30) for r in g]
    assert vals == [i * 2 for i in range(10)]


@_runtime(num_nodes=2, resources_per_node={"CPU": 4.0})
def test_local_streaming_error_surfaces_then_stops(rt):
    def bad():
        yield "first"
        raise ValueError("mid-stream boom")

    g = (
        rtt.remote(bad)
        .options(num_returns="streaming", num_cpus=0.5, max_retries=0)
        .remote()
    )
    it = iter(g)
    assert rtt.get(next(it), timeout=30) == "first"
    with pytest.raises(TaskError):
        rtt.get(next(it), timeout=30)
    with pytest.raises(StopIteration):
        next(it)


@_runtime(num_nodes=2, resources_per_node={"CPU": 4.0})
def test_local_streaming_refs_are_plain_objects(rt):
    """Stream items compose with the rest of the API: rtt.wait and
    passing a yielded ref into another task both work."""

    def double(x):
        return x * 2

    g = (
        rtt.remote(_count)
        .options(num_returns="streaming", num_cpus=0.5)
        .remote(3)
    )
    refs = list(g)
    ready, not_ready = rtt.wait(refs, num_returns=3, timeout=30)
    assert len(ready) == 3 and not not_ready
    d = rtt.remote(double).options(num_cpus=0.5).remote(refs[2])
    assert rtt.get(d, timeout=30) == 8


@_runtime(num_nodes=2, resources_per_node={"CPU": 4.0})
def test_local_actor_method_streaming(rt):
    """num_returns="streaming" on a sync actor method, in-process
    runtime (parity with the cluster path)."""

    @rtt.remote
    class Gen:
        def __init__(self):
            self.base = 100

        def stream(self, n):
            for i in range(n):
                yield self.base + i

        def boom(self):
            yield 1
            raise ValueError("mid-stream")

    a = Gen.options(num_cpus=0.5).remote()
    g = a.stream.options(num_returns="streaming").remote(6)
    assert isinstance(g, ObjectRefGenerator)
    assert [rtt.get(r, timeout=30) for r in g] == [
        100 + i for i in range(6)
    ]
    it = iter(a.boom.options(num_returns="streaming").remote())
    assert rtt.get(next(it), timeout=30) == 1
    with pytest.raises(TaskError):
        rtt.get(next(it), timeout=30)
    with pytest.raises(StopIteration):
        next(it)


@_runtime(num_nodes=2, resources_per_node={"CPU": 4.0})
def test_local_async_actor_streaming_rejected(rt):
    @rtt.remote
    class A:
        async def m(self):
            yield 1

    a = A.options(num_cpus=0.5).remote()
    with pytest.raises(TypeError, match="async actors"):
        a.m.options(num_returns="streaming").remote()


@_runtime(num_nodes=2, resources_per_node={"CPU": 4.0})
def test_local_actor_streaming_bad_arg_fails_stream(rt):
    """A failure BEFORE the generator exists (argument resolution) still
    ends the stream with an error item — the consumer never hangs."""

    @rtt.remote
    def explode():
        raise RuntimeError("dep failed")

    @rtt.remote
    class Gen:
        def stream(self, x):
            yield x

    bad_ref = explode.options(num_cpus=0.5, max_retries=0).remote()
    a = Gen.options(num_cpus=0.5).remote()
    it = iter(a.stream.options(num_returns="streaming").remote(bad_ref))
    with pytest.raises(TaskError):
        rtt.get(next(it), timeout=30)
    with pytest.raises(StopIteration):
        next(it)


@_runtime(num_nodes=2, resources_per_node={"CPU": 4.0})
def test_local_abandon_before_start_does_not_wedge_actor(rt):
    """Dropping a generator before its call starts must NOT let the
    executor drive the whole (long) generator on the actor's only
    thread — the pre-registered stream state keeps the abandon."""
    import gc

    @rtt.remote
    class Gen:
        def block(self, t):
            time.sleep(t)
            return "done"

        def endless(self):
            i = 0
            while True:
                yield i
                i += 1

    a = Gen.options(num_cpus=0.5).remote()
    blocker = a.block.remote(1.0)  # the stream call queues behind this
    g = a.endless.options(num_returns="streaming").remote()
    del g  # abandoned before the executor ever starts it
    gc.collect()
    assert rtt.get(blocker, timeout=30) == "done"
    # the actor still serves calls promptly (not stuck in endless())
    assert rtt.get(a.block.remote(0.0), timeout=10) == "done"


@_runtime(num_nodes=2, resources_per_node={"CPU": 4.0})
def test_local_stream_state_reclaimed_after_drain(rt):
    """Fully-drained streams drop their runtime state (no per-call
    leak)."""

    @rtt.remote
    class Gen:
        def stream(self, n):
            yield from range(n)

    a = Gen.options(num_cpus=0.5).remote()
    for _ in range(5):
        g = a.stream.options(num_returns="streaming").remote(3)
        assert [rtt.get(r, timeout=30) for r in g] == [0, 1, 2]
    assert len(rt._streams) == 0


@_runtime(num_nodes=2, resources_per_node={"CPU": 4.0})
def test_local_exhausted_generator_keeps_raising(rt):
    """Iterator protocol: next() on an exhausted generator raises
    StopIteration immediately, forever — the runtime dropped the drained
    stream state, so asking it again must not block on a stream that no
    longer exists."""
    g = (
        rtt.remote(_count)
        .options(num_returns="streaming", num_cpus=0.5)
        .remote(2)
    )
    assert [rtt.get(r, timeout=30) for r in g] == [0, 2]
    t0 = time.monotonic()
    with pytest.raises(StopIteration):
        next(g)
    with pytest.raises(StopIteration):
        g.next_ref(timeout=5.0)
    assert time.monotonic() - t0 < 1.0, "post-drain next() blocked"


@_runtime(num_nodes=2, resources_per_node={"CPU": 4.0})
def test_local_abandoned_stream_not_resurrected_by_reexecution(rt):
    """An abandoned stream stays abandoned across re-executions of the
    same task id: a lineage retry must not drive the generator to
    completion with no consumer."""
    g = (
        rtt.remote(_count)
        .options(num_returns="streaming", num_cpus=0.5)
        .remote(1000)
    )
    task_id = g.task_id
    first = next(g)
    assert rtt.get(first, timeout=30) == 0
    del g  # abandon mid-stream
    import gc

    gc.collect()
    deadline = time.monotonic() + 10
    while task_id not in rt._abandoned_streams and time.monotonic() < deadline:
        time.sleep(0.05)
    assert task_id in rt._abandoned_streams
    # simulate the lineage re-execution path re-driving the same task id
    rt._drive_stream(task_id, None, iter(range(1000)))
    with rt._stream_cv:
        st = rt._streams.get(task_id)
    assert st is None, "re-execution resurrected an abandoned stream"

# ---------------------------------------------------------------------------
# tests/test_async_actors.py, in-process cases
# ---------------------------------------------------------------------------

@_runtime(num_nodes=1, resources_per_node={"CPU": 8.0})
def test_async_methods_interleave(rt):
    @rtt.remote
    class Gate:
        def __init__(self):
            self.event = asyncio.Event()

        async def wait_open(self):
            await self.event.wait()
            return "opened"

        async def open(self):
            self.event.set()
            return "ok"

    g = Gate.remote()
    blocked = g.wait_open.remote()
    # wait_open is parked on the event; open() must get to run concurrently
    assert rtt.get(g.open.remote(), timeout=10) == "ok"
    assert rtt.get(blocked, timeout=10) == "opened"


@_runtime(num_nodes=1, resources_per_node={"CPU": 8.0})
def test_async_concurrency_bound(rt):
    @rtt.remote(max_concurrency=4)
    class Bounded:
        def __init__(self):
            self.active = 0
            self.peak = 0

        async def work(self):
            self.active += 1
            self.peak = max(self.peak, self.active)
            await asyncio.sleep(0.05)
            self.active -= 1
            return self.peak

        async def peak_seen(self):
            return self.peak

    b = Bounded.remote()
    refs = [b.work.remote() for _ in range(16)]
    rtt.get(refs, timeout=30)
    peak = rtt.get(b.peak_seen.remote(), timeout=10)
    assert 2 <= peak <= 4, f"peak concurrency {peak}, want >=2 (interleaved) <=4 (bounded)"


@_runtime(num_nodes=1, resources_per_node={"CPU": 8.0})
def test_async_default_high_concurrency(rt):
    @rtt.remote
    class Sleeper:
        async def nap(self):
            await asyncio.sleep(0.2)
            return 1

    s = Sleeper.remote()
    t0 = time.monotonic()
    out = rtt.get([s.nap.remote() for _ in range(50)], timeout=30)
    dt = time.monotonic() - t0
    assert out == [1] * 50
    # serial would take 10s; asyncio multiplexing keeps it near 0.2s
    assert dt < 2.0, f"async naps did not interleave: {dt:.2f}s"


@_runtime(num_nodes=1, resources_per_node={"CPU": 8.0})
def test_concurrency_groups_isolate(rt):
    @rtt.remote(concurrency_groups={"io": 1, "compute": 2})
    class Grouped:
        def __init__(self):
            self.lock = threading.Lock()
            self.compute_active = 0
            self.compute_peak = 0

        @rtt.method(concurrency_group="io")
        def slow_io(self):
            time.sleep(0.5)
            return "io"

        @rtt.method(concurrency_group="compute")
        def compute(self):
            with self.lock:
                self.compute_active += 1
                self.compute_peak = max(self.compute_peak, self.compute_active)
            time.sleep(0.05)
            with self.lock:
                self.compute_active -= 1
            return "c"

        def peak(self):
            return self.compute_peak

    g = Grouped.remote()
    io_ref = g.slow_io.remote()  # occupies the io group
    t0 = time.monotonic()
    out = rtt.get([g.compute.remote() for _ in range(6)], timeout=30)
    compute_done = time.monotonic() - t0
    assert out == ["c"] * 6
    # compute group (2 threads) is not starved by the busy io group
    assert compute_done < 0.45, f"compute starved behind io: {compute_done:.2f}s"
    assert rtt.get(io_ref, timeout=30) == "io"
    assert rtt.get(g.peak.remote(), timeout=10) <= 2


@_runtime(num_nodes=1, resources_per_node={"CPU": 8.0})
def test_async_actor_error_and_sync_method(rt):
    @rtt.remote
    class Mixed:
        def __init__(self):
            self.n = 0

        def bump(self):  # sync method on an async actor runs on the loop
            self.n += 1
            return self.n

        async def boom(self):
            raise ValueError("kapow")

    m = Mixed.remote()
    assert rtt.get(m.bump.remote(), timeout=10) == 1
    with pytest.raises(Exception) as ei:
        rtt.get(m.boom.remote(), timeout=10)
    assert "kapow" in str(ei.value)
    assert rtt.get(m.bump.remote(), timeout=10) == 2


@_runtime(num_nodes=1, resources_per_node={"CPU": 8.0})
def test_async_actor_kill_seals_inflight(rt):
    @rtt.remote
    class Hang:
        async def forever(self):
            await asyncio.sleep(3600)

    h = Hang.remote()
    ref = h.forever.remote()
    time.sleep(0.2)
    rtt.kill(h)
    with pytest.raises(Exception):
        rtt.get(ref, timeout=10)


@_runtime(num_nodes=1, resources_per_node={"CPU": 8.0})
def test_explicit_max_concurrency_one_serializes_async(rt):
    @rtt.remote(max_concurrency=1)
    class Serial:
        def __init__(self):
            self.active = 0
            self.peak = 0

        async def work(self):
            self.active += 1
            self.peak = max(self.peak, self.active)
            await asyncio.sleep(0.02)
            self.active -= 1
            return self.peak

    s = Serial.remote()
    rtt.get([s.work.remote() for _ in range(8)], timeout=30)
    assert rtt.get(s.work.remote(), timeout=10) == 1, (
        "explicit max_concurrency=1 must serialize async methods"
    )


@_runtime(num_nodes=1, resources_per_node={"CPU": 8.0})
def test_async_actor_restart(rt):
    @rtt.remote(max_restarts=1)
    class Counter:
        def __init__(self):
            self.n = 0

        async def incr(self):
            self.n += 1
            return self.n

        async def where(self):
            from ray_tpu_torch.core.runtime import get_context

            return get_context().node_id

    rt.add_node({"CPU": 8.0})
    c = Counter.remote()
    assert rtt.get(c.incr.remote(), timeout=10) == 1
    node = rtt.get(c.where.remote(), timeout=10)
    rt.kill_node(node)
    # restarted elsewhere with fresh state, still an async actor
    assert rtt.get(c.incr.remote(), timeout=30) == 1


def test_await_object_ref_local():
    """`await ref` inside an async actor method resolves other tasks'
    outputs without blocking the actor's event loop (awaitable ObjectRef,
    reference object_ref.pxi semantics)."""
    rtt.init(num_nodes=1, resources_per_node={"CPU": 4})
    try:

        @rtt.remote
        def produce(x):
            return x * 3

        @rtt.remote
        class Combiner:
            async def combine_refs(self, pair):
                a = await pair[0]
                b = await pair[1]
                return a + b

        c = Combiner.remote()
        r1, r2 = produce.remote(1), produce.remote(2)
        out = rtt.get(c.combine_refs.remote([r1, r2]), timeout=60)
        assert out == 9

        # .future() view
        f = produce.remote(7).future()
        assert f.result(timeout=30) == 21

        # a method RETURNING a ref hands the ref over (never auto-awaited)
        @rtt.remote
        class Maker:
            async def make(self):
                return produce.remote(5)

        m = Maker.remote()
        inner = rtt.get(m.make.remote(), timeout=30)
        assert isinstance(inner, rtt.ObjectRef)
        assert rtt.get(inner, timeout=30) == 15
    finally:
        rtt.shutdown()

# ---------------------------------------------------------------------------
# tests/test_dependency_dispatch.py, in-process case
# ---------------------------------------------------------------------------

def _slow_value(delay):
    import time as _t

    _t.sleep(delay)
    return 41


def _consume(x):
    return x + 1


def _quick():
    return "quick"


def test_inprocess_ready_task_interleaves_past_arg_blocked():
    rt = rtt.init(num_nodes=2, resources_per_node={"CPU": 1})
    try:
        node_a, node_b = list(rt.nodes)
        on_a = NodeAffinitySchedulingStrategy(node_a)
        on_b = NodeAffinitySchedulingStrategy(node_b)
        slow = rtt.remote(_slow_value).options(scheduling_strategy=on_b)
        consume = rtt.remote(_consume).options(scheduling_strategy=on_a)
        quick = rtt.remote(_quick).options(scheduling_strategy=on_a)

        dep = slow.remote(2.0)  # runs on B for 2s
        blocked = consume.remote(dep)  # on A, arg not sealed yet
        t0 = time.monotonic()
        ready = quick.remote()  # on A: must NOT wait behind `blocked`
        assert rtt.get(ready, timeout=30) == "quick"
        ready_latency = time.monotonic() - t0
        assert ready_latency < 1.5, (
            f"ready task waited {ready_latency:.2f}s behind an arg-blocked "
            "lease on the 1-slot node"
        )
        assert rtt.get(blocked, timeout=30) == 42
    finally:
        rtt.shutdown()

# ---------------------------------------------------------------------------
# tests/test_refcounting.py, in-process cases
# ---------------------------------------------------------------------------

def _wait_for(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


@_runtime(num_nodes=2, resources_per_node={"CPU": 4}, store_bytes=32 << 20)
def test_put_drop_frees_entry(rt):
    ref = rtt.put(np.arange(1000))
    hex_id = ref.hex
    assert TRACKER.count(hex_id) >= 1
    del ref
    gc.collect()
    _wait_for(
        lambda: hex_id not in rt.store._objects, msg="store entry freed"
    )
    assert TRACKER.count(hex_id) == 0


@_runtime(num_nodes=2, resources_per_node={"CPU": 4}, store_bytes=32 << 20)
def test_task_output_freed_and_lineage_released(rt):
    @rtt.remote
    def produce():
        return np.ones(100)

    ref = produce.remote()
    assert rtt.get(ref)[0] == 1.0
    hex_id = ref.hex
    assert hex_id in rt._lineage
    del ref
    gc.collect()
    _wait_for(lambda: hex_id not in rt.store._objects, msg="output freed")
    _wait_for(lambda: hex_id not in rt._lineage, msg="lineage released")


@_runtime(num_nodes=2, resources_per_node={"CPU": 4}, store_bytes=32 << 20)
def test_arg_refs_freed_by_lineage_release(rt):
    """While `b` lives, its lineage pins arg `a` (reconstruction needs it);
    dropping `b` releases the lineage, which cascades the free to `a`."""

    @rtt.remote
    def inc(x):
        return x + 1

    a = rtt.put(1)
    b = inc.remote(a)
    a_hex, b_hex = a.hex, b.hex
    del a  # lineage of b keeps the value alive
    assert rtt.get(b) == 2
    gc.collect()
    time.sleep(0.2)
    assert a_hex in rt.store._objects, "lineage should pin the arg"
    del b
    gc.collect()
    _wait_for(lambda: b_hex not in rt.store._objects, msg="output freed")
    _wait_for(lambda: a_hex not in rt.store._objects, msg="arg freed")


@_runtime(num_nodes=2, resources_per_node={"CPU": 4}, store_bytes=32 << 20)
def test_unreferenced_before_seal_freed_at_seal(rt):
    import threading

    gate = threading.Event()

    @rtt.remote
    def slow():
        gate.wait(5.0)
        return np.zeros(64)

    ref = slow.remote()
    hex_id = ref.hex
    del ref
    gc.collect()
    _wait_for(lambda: TRACKER.count(hex_id) == 0, msg="handle dropped")
    gate.set()
    # the seal must observe the drop and free instead of storing
    _wait_for(
        lambda: hex_id not in rt.store._objects
        or rt.store._objects[hex_id].unreferenced,
        msg="freed at seal",
    )
    _wait_for(lambda: hex_id not in rt.store._objects, msg="entry gone")


@_runtime(num_nodes=2, resources_per_node={"CPU": 4}, store_bytes=32 << 20)
def test_bounded_store_survives_many_large_puts(rt):
    """10k-object style loop: total bytes written far exceed the arena, no
    manual frees anywhere (the round-3 'done' criterion)."""
    chunk = np.zeros(128 * 1024 // 8)  # 128 KiB each
    for i in range(500):  # ~64 MiB total through a 32 MiB arena
        ref = rtt.put(chunk + i)
        if i % 97 == 0:
            assert rtt.get(ref)[0] == i
        del ref
    gc.collect()
    _wait_for(
        lambda: rt.store.stats()["num_objects"] < 50, msg="store drained"
    )
    if rt.native_store is not None:
        # the shm arena itself must have been released, not just the table
        _wait_for(
            lambda: rt.native_store.stats()["used"] < (8 << 20),
            msg="arena reclaimed",
        )


@_runtime(num_nodes=2, resources_per_node={"CPU": 4}, store_bytes=32 << 20)
def test_manual_free_objects_still_works(rt):
    ref = rtt.put(np.arange(10))
    rt.free_objects([ref])
    assert ref.hex not in rt.store._objects


# ---------------------------------------------------------------------------
# no fallback from the card
# ---------------------------------------------------------------------------


def test_init_raises_without_cuda(monkeypatch):
    """With no platform set the scheduler runs on ``cuda``; this host has
    none, so ``init()`` raises, naming the platform, and leaves no runtime
    behind (the reference would degrade to its golden model)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("RAY_TPU_SCHED_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="'cuda'"):
        rtt.init(num_nodes=1)
    assert not rtt.is_initialized()
    monkeypatch.setenv("RAY_TPU_DEVICE_SCHEDULER", "0")
    with pytest.raises(RuntimeError, match="'cuda'"):
        rtt.init(num_nodes=1)  # the bundle programs need the device too
    assert not rtt.is_initialized()


def test_unpark_device_failure_surfaces(rt, monkeypatch, caplog):
    """A failing ``shape_slots`` raises out of the unpark, the scheduler
    loop logs it as a failed round, and the parked work stays parked: no
    host scan stands in for the device."""
    import logging
    from types import SimpleNamespace

    def broken(mat):
        raise RuntimeError("estimator died")

    monkeypatch.setattr(rt.device_state, "shape_slots", broken)
    parked = [SimpleNamespace(strategy=None, resources={"CPU": 1.0}) for _ in range(100)]
    with caplog.at_level(logging.ERROR, logger="ray_tpu_torch"), rt._cond:
        rt._infeasible = list(parked)
        try:
            with pytest.raises(RuntimeError, match="estimator died"):
                rt._unpark_grantable()
            assert rt._infeasible == parked and not rt._pending
            rt._last_park_retry = 0.0
            rt._maybe_unpark_locked()
            assert rt._infeasible == parked and not rt._pending
        finally:
            rt._infeasible = []
    failed = [r for r in caplog.records if "scheduler round failed" in r.getMessage()]
    assert failed and "estimator died" in str(failed[0].exc_info[1])


def test_cluster_address_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        rtt.init(address="localhost:1")
