"""Execution-plane hot path: C wire framing and the fused submit/result
event loop.

Covers: C-vs-Python framing round-trip parity over fuzzed objects
(non-contiguous numpy, 0-buffer, >64-buffer, truncated-frame error cases —
BOTH paths, byte-identical frames), fused event-loop ordering/coalescing/
error containment, and the hot-path observability surfaces.

Mirror of the framing, serialization and ``FusedEventLoop`` cases of
``tests/test_hotpath.py`` on the port (``ray_tpu_torch``), the same
assertions. Its ring and compiled-pipeline cases are in
``tests/test_torch_ring_channels.py`` and ``tests/test_torch_pipeline.py``.
"""
import struct
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster import serialization as wire
from ray_tpu_torch.core.runtime import set_runtime


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's head brings its scheduler up on cuda and raises without it;
    # here its rounds run the same programs on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield

needs_native = pytest.mark.skipif(
    not wire.NATIVE_WIRE,
    reason="native wire.cc unavailable (no toolchain); Python framing "
    "fallback is in force and covered by the parity tests",
)


# ---------------------------------------------------------------------------
# framing parity: native C path vs pure-Python fallback
# ---------------------------------------------------------------------------


def _fuzz_objects():
    rng = np.random.default_rng(7)
    return [
        None,
        42,
        "plain string",
        {"k": [1, 2, 3], "n": None},  # 0 out-of-band buffers
        {"a": rng.standard_normal(4096).astype(np.float32)},  # 1 buffer
        [rng.integers(0, 255, 8192, dtype=np.uint8) for _ in range(3)],
        np.arange(30000, dtype=np.int64)[::2],  # non-contiguous: in-band
        {"big": rng.standard_normal((128, 128))},
        # >64 out-of-band buffers in one frame
        [np.full(1024, i, dtype=np.int64) for i in range(70)],
        {"mixed": (b"x" * 5000, rng.standard_normal(2048), "tail")},
    ]


def _deep_eq(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_deep_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return set(a) == set(b) and all(_deep_eq(a[k], b[k]) for k in a)
    return a == b


def test_python_fallback_round_trips(monkeypatch):
    monkeypatch.setattr(wire, "_NATIVE", None)
    for obj in _fuzz_objects():
        blob = wire.dumps(obj)
        assert _deep_eq(obj, wire.loads(blob))
        parts, total = wire.dumps_parts(obj)
        assert total == wire.frames_total(parts)
        assert wire.join_parts(parts) == blob
        assert _deep_eq(obj, wire.loads(wire.join_parts(parts)))


@needs_native
def test_native_round_trips_and_cross_parity(monkeypatch):
    for obj in _fuzz_objects():
        native_blob = wire.dumps(obj)
        assert _deep_eq(obj, wire.loads(native_blob))
        # frames are byte-identical across paths: a native writer and a
        # fallback reader (or vice versa) interoperate transparently
        monkeypatch.setattr(wire, "_NATIVE", None)
        py_blob = wire.dumps(obj)
        assert py_blob == native_blob
        assert _deep_eq(obj, wire.loads(native_blob))
        monkeypatch.undo()
        assert _deep_eq(obj, wire.loads(py_blob))


@needs_native
def test_native_wire_counters_advance():
    before = wire.wire_stats()
    blob = wire.dumps({"a": np.zeros(4096, dtype=np.uint8)})
    wire.loads(blob)
    after = wire.wire_stats()
    assert after["native_wire_dumps_total"] > before["native_wire_dumps_total"]
    assert after["native_wire_loads_total"] > before["native_wire_loads_total"]
    assert (
        after["native_wire_dumps_fallback_total"]
        == before["native_wire_dumps_fallback_total"]
    )


@pytest.mark.parametrize("force_python", [False, True])
def test_truncated_frames_raise(monkeypatch, force_python):
    if force_python:
        monkeypatch.setattr(wire, "_NATIVE", None)
    elif not wire.NATIVE_WIRE:
        pytest.skip("native wire unavailable")
    blob = wire.dumps({"a": np.arange(4096, dtype=np.float64)})
    assert blob[:4] == wire.MAGIC
    for cut in (5, 8, 15, len(blob) // 3, len(blob) - 1):
        with pytest.raises(ValueError):
            wire.loads(blob[:cut])
    # a lying buffer-length table must not read out of bounds
    corrupt = bytearray(blob)
    struct.pack_into("<Q", corrupt, 4 + 2 + 2 + 8, 1 << 60)
    with pytest.raises(ValueError):
        wire.loads(bytes(corrupt))


def test_plain_pickles_still_load():
    import cloudpickle

    assert wire.loads(cloudpickle.dumps({"x": 1})) == {"x": 1}


# ---------------------------------------------------------------------------
# fused event loop
# ---------------------------------------------------------------------------


class _FakeSource:
    def __init__(self, loop):
        self.loop = loop
        self.steps = 0
        self.stepped_at = []
        self.deadline = None
        self.raise_on_step = False
        self.offload_done = threading.Event()

    def step(self, now):
        self.steps += 1
        self.stepped_at.append(now)
        if self.raise_on_step:
            raise RuntimeError("boom")
        return self.deadline


def test_event_loop_wake_coalescing_and_offload():
    from ray_tpu_torch.cluster.event_loop import FusedEventLoop

    loop = FusedEventLoop(name="t", senders=2)
    try:
        src = _FakeSource(loop)
        loop.register(src)
        _wait_until(lambda: src.steps >= 1)
        base = src.steps
        # a burst of wakes while the loop is between steps coalesces
        for _ in range(50):
            loop.wake(src)
        _wait_until(lambda: src.steps > base)
        time.sleep(0.1)
        assert src.steps - base <= 10  # nowhere near 50
        # offload runs on the pool and re-wakes the source
        before = src.steps
        loop.offload(src, src.offload_done.set)
        assert src.offload_done.wait(5.0)
        _wait_until(lambda: src.steps > before)
        st = loop.stats()
        assert st["wakes_total"] >= 1 and st["steps_total"] >= 1
    finally:
        loop.stop()


def test_event_loop_error_containment_and_timers():
    from ray_tpu_torch.cluster.event_loop import FusedEventLoop

    loop = FusedEventLoop(name="t2", senders=1)
    try:
        bad = _FakeSource(loop)
        bad.raise_on_step = True
        good = _FakeSource(loop)
        loop.register(bad)
        loop.register(good)
        _wait_until(lambda: bad.steps >= 1 and good.steps >= 1)
        # a raising source does not take the loop down
        loop.wake(good)
        _wait_until(lambda: good.steps >= 2)
        # timer-driven re-step without any wake
        t0 = time.monotonic()
        good.deadline = t0 + 0.2
        loop.wake(good)
        _wait_until(lambda: good.steps >= 4, timeout=5.0)
    finally:
        loop.stop()


def test_event_loop_unregister_stops_steps():
    from ray_tpu_torch.cluster.event_loop import FusedEventLoop

    loop = FusedEventLoop(name="t3", senders=1)
    try:
        src = _FakeSource(loop)
        loop.register(src)
        _wait_until(lambda: src.steps >= 1)
        loop.unregister(src)
        n = src.steps
        loop.wake(src)  # no-op after unregister
        time.sleep(0.2)
        assert src.steps == n
    finally:
        loop.stop()


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise TimeoutError("condition not reached")


# ---------------------------------------------------------------------------
# cluster for the observability case
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    from ray_tpu_torch.cluster import Cluster

    c = Cluster(use_device_scheduler=False)
    c.add_node({"CPU": 8.0}, num_workers=2)
    yield c
    c.shutdown()


@pytest.fixture()
def client(cluster):
    rt = cluster.client()
    set_runtime(rt)
    yield rt
    set_runtime(None)
    rt.shutdown()


def _add1(x):
    return x + 1


# ---------------------------------------------------------------------------
# hot-path observability surfaces
# ---------------------------------------------------------------------------


def test_query_state_hotpath_and_debugstate(cluster, client):
    f = ray_tpu_torch.remote(_add1).options(num_cpus=0.25, max_retries=0)
    assert ray_tpu_torch.get([f.remote(i) for i in range(20)], timeout=60) == [
        i + 1 for i in range(20)
    ]
    hp = client.query_state("hotpath")
    assert "native_wire" in hp and "wire" in hp
    assert set(hp["wire"]) == {
        "native_wire_dumps_total",
        "native_wire_loads_total",
        "native_wire_dumps_fallback_total",
        "native_wire_loads_fallback_total",
    }
    assert "dispatch_overhead_us" in hp
    # the owner-side fused loop is live and carries the lease channels
    st = client._hotloop.stats()
    assert st["sources"] >= 1  # at least the result sink
    assert st["steps_total"] >= 1
    # agent DebugState exposes the same block
    from ray_tpu_torch.cluster.rpc import RpcClient

    info = next(iter(cluster.head.nodes.values()))
    agent = RpcClient(info.address)
    try:
        dbg = agent.call("DebugState", timeout=10.0)
    finally:
        agent.close()
    assert "hotpath" in dbg
    assert "event_loops" in dbg["hotpath"]
