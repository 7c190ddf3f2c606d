"""Zero-copy object plane: pickle-5 out-of-band wire format, shm arena
views + deferred free, chunked resumable peer pulls, and the same-node
zero-copy ``get`` contract.

Covers the test satellite: oob round-trips (numpy, nested,
non-contiguous), concurrent arena put/get/delete with the arena-full
spill fallback, chunked-fetch resume under a dropped-chunk chaos rule,
and a worker resolving a same-node block as a READ-ONLY view.

Mirror of ``tests/test_object_plane.py`` on the port (``ray_tpu_torch``), the same
cases and assertions.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from ray_tpu_torch.cluster import serialization as wire
from ray_tpu_torch.native.shm_store import (
    NativeObjectStore,
    sweep_orphan_stores,
)


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's head brings its scheduler up on cuda and raises without it;
    # here its rounds run the same programs on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


# ---------------------------------------------------------------------------
# pickle-5 out-of-band wire format
# ---------------------------------------------------------------------------


def test_oob_roundtrip_numpy_zero_copy():
    arr = np.arange(100_000, dtype=np.float64)
    blob = wire.dumps({"x": arr, "tag": "t"})
    out = wire.loads(blob)
    np.testing.assert_array_equal(out["x"], arr)
    # the loaded array is a VIEW over the wire buffer, not a copy
    assert not out["x"].flags.writeable
    assert np.shares_memory(
        out["x"], np.frombuffer(memoryview(blob), np.uint8)
    )


def test_oob_roundtrip_nested_buffers():
    obj = {
        "a": [np.ones((128, 64), dtype=np.float32), {"b": np.arange(5000)}],
        "raw": b"\x00\x01" * 4000,
        "s": "text",
    }
    out = wire.loads(wire.dumps(obj))
    np.testing.assert_array_equal(out["a"][0], obj["a"][0])
    np.testing.assert_array_equal(out["a"][1]["b"], obj["a"][1]["b"])
    assert out["raw"] == obj["raw"] and out["s"] == "text"


def test_oob_roundtrip_non_contiguous():
    base = np.arange(10_000, dtype=np.int64).reshape(100, 100)
    nc = base[:, ::3]  # non-contiguous: pickled in-band via a copy
    out = wire.loads(wire.dumps(nc))
    np.testing.assert_array_equal(out, nc)


def test_oob_small_objects_skip_framing_and_plain_pickles_load():
    import cloudpickle

    blob = wire.dumps([1, 2, 3])
    assert blob[:4] != wire.MAGIC  # no buffers -> no frame overhead
    assert wire.loads(blob) == [1, 2, 3]
    # legacy/plain pickles (spill files, mixed callers) still load
    assert wire.loads(cloudpickle.dumps({"k": 1})) == {"k": 1}


def test_oob_parts_join_equals_dumps():
    obj = {"arr": np.arange(20_000)}
    parts, total = wire.dumps_parts(obj)
    assert total == sum(
        p.nbytes if isinstance(p, memoryview) else len(p) for p in parts
    )
    assert wire.join_parts(parts) == wire.dumps(obj)


# ---------------------------------------------------------------------------
# shm arena: views, deferred free, concurrency, arena-full fallback
# ---------------------------------------------------------------------------


@pytest.fixture()
def store(tmp_path):
    s = NativeObjectStore(path=str(tmp_path / "plane.shm"), capacity=1 << 22)
    yield s
    s.close(unlink=True)


def test_view_survives_delete_then_frees(store):
    arr = np.arange(50_000, dtype=np.float32)
    store.put_numpy("obj", arr)
    view = store.get_numpy("obj")
    used_before = store.stats()["used"]
    store.delete("obj")
    # zombie entry: the pinned view still reads the original bytes and
    # the arena space is NOT reused under it
    np.testing.assert_array_equal(view, arr)
    assert store.stats()["used"] == used_before
    del view
    import gc

    gc.collect()
    assert store.stats()["used"] < used_before


def test_same_id_reput_does_not_corrupt_old_view(store):
    store.put_bytes("z", b"OLD" * 2000)
    view = store.get_view("z")
    store.delete("z")
    store.put_bytes("z", b"NEW" * 2000)
    assert bytes(view[:3]) == b"OLD"
    assert store.get_bytes("z")[:3] == b"NEW"


def test_concurrent_put_get_delete(store):
    errors = []

    def hammer(k: int) -> None:
        try:
            for i in range(60):
                oid = f"w{k}_{i}"
                store.put_bytes(oid, bytes([k]) * 512)
                assert store.get_bytes(oid) == bytes([k]) * 512
                if i % 2:
                    store.delete(oid)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [
        threading.Thread(target=hammer, args=(k,)) for k in range(8)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def test_arena_full_spills_instead_of_erroring(tmp_path):
    from ray_tpu_torch.native.spill import SHM_EVICTIONS, SpillingStore

    inner = NativeObjectStore(
        path=str(tmp_path / "small.shm"), capacity=1 << 20
    )
    s = SpillingStore(inner, spill_dir=str(tmp_path / "spill"))
    before = SHM_EVICTIONS.value()
    try:
        blobs = {f"o{i}": os.urandom(300_000) for i in range(8)}
        for oid, data in blobs.items():
            s.put_frames(oid, [data[:1000], data[1000:]])
        # every object still readable (restored from disk when evicted)
        for oid, data in blobs.items():
            assert s.get_bytes(oid) == data
        assert s.metrics["spilled_objects"] > 0
        assert SHM_EVICTIONS.value() > before
        # chunk serving spans both tiers
        some = next(iter(blobs))
        assert s.get_range(some, 10, 100) == blobs[some][10:110]
    finally:
        s.close(unlink=True)


def test_unlink_exactly_once_and_orphan_sweep(tmp_path):
    p = str(tmp_path / "once.shm")
    s = NativeObjectStore(path=p, capacity=1 << 20)
    s.put_bytes("a", b"x")
    s.close(unlink=True)
    assert not os.path.exists(p)
    s.close(unlink=True)  # idempotent; __del__ after close is a no-op too
    del s

    # orphan sweep: dead-pid files go, live-pid files stay
    dead = tmp_path / "ray_tpu_torch_store_nodeX_99999999.shm"
    dead.write_bytes(b"")
    dead_spill = tmp_path / "ray_tpu_torch_spill_nodeX_99999999"
    dead_spill.mkdir()
    live = tmp_path / f"ray_tpu_torch_store_nodeY_{os.getpid()}.shm"
    live.write_bytes(b"")
    removed = sweep_orphan_stores(str(tmp_path))
    assert str(dead) in removed and str(dead_spill) in removed
    assert not dead.exists() and not dead_spill.exists()
    assert live.exists()


# ---------------------------------------------------------------------------
# cluster: same-node zero-copy get + chunked transfer resume
# ---------------------------------------------------------------------------

_ZC_SCRIPT = r"""
import numpy as np
import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.runtime import set_runtime

def probe(arr):
    # the worker must see a READ-ONLY zero-copy view over the arena
    assert isinstance(arr, np.ndarray), type(arr)
    assert not arr.flags.writeable, "expected a read-only shm view"
    try:
        arr[0] = 1.0
        raise AssertionError("in-place write to a shm view succeeded")
    except ValueError:
        pass
    return float(arr.sum())

c = Cluster()
c.add_node({"CPU": 4.0}, num_workers=2)
client = c.client()
set_runtime(client)
try:
    big = np.arange(1 << 18, dtype=np.float64)  # 2 MB > inline max
    ref = ray_tpu_torch.put(big)
    f = ray_tpu_torch.remote(probe).options(num_cpus=0.1)
    out = ray_tpu_torch.get(f.remote(ref), timeout=120)
    assert out == float(big.sum()), out
    print("ZC_OK")
finally:
    set_runtime(None)
    client.shutdown()
    c.shutdown()
"""


_CHUNK_RESUME_SCRIPT = r"""
import numpy as np
import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.runtime import set_runtime
from ray_tpu_torch.cluster.object_plane import TRANSFER_CHUNK_MS

c = Cluster()
c.add_node({"CPU": 4.0}, num_workers=2)
c.add_node({"CPU": 4.0}, num_workers=2)
client = c.client()
set_runtime(client)
try:
    # node 1 holds the block; a task pinned to node 2 must pull it
    # chunked while RAY_TPU_RPC_CHAOS drops 25% of the chunk RPCs —
    # per-chunk retry (resume) must still deliver intact bytes
    big = np.arange(1 << 19, dtype=np.float64)  # 4 MB, 1 MB chunks
    ref = ray_tpu_torch.put(big)

    from ray_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    nid2 = [n["NodeID"] for n in client.nodes_info()][1]

    def readsum(arr):
        return float(arr.sum())

    g = ray_tpu_torch.remote(readsum).options(
        num_cpus=0.1,
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=nid2, soft=False
        ),
    )
    out = ray_tpu_torch.get(g.remote(ref), timeout=180)
    assert out == float(big.sum()), out
    print("CHUNK_OK")
finally:
    set_runtime(None)
    client.shutdown()
    c.shutdown()
"""


def _run_script(tmp_path, name: str, body: str, env_extra: dict):
    script = tmp_path / name
    script.write_text(body)
    env = dict(os.environ)
    env.update(env_extra)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    return subprocess.run(
        [sys.executable, str(script)],
        capture_output=True,
        text=True,
        timeout=300,
        env=env,
    )


def test_same_node_get_is_zero_copy_view(tmp_path):
    out = _run_script(tmp_path, "zc.py", _ZC_SCRIPT, {})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ZC_OK" in out.stdout


def test_chunked_fetch_resumes_after_dropped_chunks(tmp_path):
    out = _run_script(
        tmp_path,
        "chunk.py",
        _CHUNK_RESUME_SCRIPT,
        {
            "RAY_TPU_TRANSFER_CHUNK_BYTES": str(1 << 20),
            # the chaos object-drop analog at the transfer layer: chunk
            # RPCs drop before send and must resume individually
            "RAY_TPU_RPC_CHAOS": "FetchObjectChunk:drop=0.25",
        },
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CHUNK_OK" in out.stdout


def test_dead_reader_pin_log_replay_reclaims_zombie(tmp_path):
    """Zombie-pin reclamation: a reader SIGKILLed with a zero-copy view
    outstanding never runs its finalizer — its crash-durable pin log
    (`<arena>.pins.<pid>`) lets the agent-side replay release the pin
    `(id, offset)`-precise, reclaiming the deleted entry immediately
    instead of at the next arena restart (the PR 3 known limitation)."""
    import subprocess
    import sys

    path = str(tmp_path / "plane.shm")
    s = NativeObjectStore(path=path, capacity=1 << 22)
    try:
        s.put_bytes("obj", b"pinned" * 4096)
        child = subprocess.Popen(
            [
                sys.executable,
                "-c",
                "import sys, time\n"
                "from ray_tpu_torch.native import NativeObjectStore\n"
                f"s = NativeObjectStore(path={path!r}, create=False)\n"
                "s.enable_pin_tracking()\n"
                "v = s.get_view('obj')\n"
                "print('pinned', flush=True)\n"
                "time.sleep(600)\n",
            ],
            stdout=subprocess.PIPE,
        )
        try:
            assert child.stdout.readline().strip() == b"pinned"
            # delete under the live remote pin: the entry turns zombie,
            # its arena space deferred to a finalizer that will never run
            used_before = s.stats()["used"]
            s.delete("obj")
            assert s.zombie_count() == 1
            assert s.stats()["used"] == used_before
            child.kill()  # SIGKILL: no finalizer, no atexit
            child.wait(timeout=10)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=10)
        # the agent's worker-death path: replay the dead reader's log
        released = s.release_dead_pins(child.pid)
        assert released == 1
        assert s.zombie_count() == 0
        assert s.stats()["used"] < used_before
        # replay is idempotent — the log is consumed with the release
        assert s.release_dead_pins(child.pid) == 0
    finally:
        s.close(unlink=True)


def test_clean_release_nets_pin_log_to_empty(tmp_path):
    """A reader that releases its views normally leaves a fully-netted
    pin log: a later replay (e.g. the agent processing a clean worker
    exit) must release NOTHING — the log's P-after-pin / R-before-release
    ordering makes double-release impossible."""
    from ray_tpu_torch.native.shm_store import read_outstanding_pins, pin_log_path
    import os

    path = str(tmp_path / "plane.shm")
    s = NativeObjectStore(path=path, capacity=1 << 22)
    try:
        s.enable_pin_tracking()
        s.put_bytes("a", b"x" * 8192)
        view = s.get_view("a")
        log = pin_log_path(path, os.getpid())
        assert sum(read_outstanding_pins(log).values()) == 1
        del view
        import gc

        gc.collect()
        assert sum(read_outstanding_pins(log).values()) == 0
        assert s.release_dead_pins(os.getpid()) == 0
        assert s.zombie_count() == 0
    finally:
        s.close(unlink=True)
