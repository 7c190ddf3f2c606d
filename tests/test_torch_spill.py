"""Mirror of ``tests/test_spill.py`` on the port, with ``ray_tpu``
read as ``ray_tpu_torch`` and the scheduler's rounds on the host.

Object-store eviction + disk spill/restore + create backpressure.
"""
import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.native.spill import SpillingStore


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


class _TinyStore:
    """In-memory arena with a hard byte budget (native-store stand-in)."""

    def __init__(self, capacity):
        self.capacity = capacity
        self.data = {}

    def put_bytes(self, oid, data):
        if self.used() + len(data) > self.capacity:
            raise MemoryError("arena full")
        if oid in self.data:
            raise KeyError(oid)
        self.data[oid] = data

    def get_bytes(self, oid):
        return self.data[oid]

    def contains(self, oid):
        return oid in self.data

    def delete(self, oid):
        self.data.pop(oid, None)

    def used(self):
        return sum(len(v) for v in self.data.values())

    def stats(self):
        return {
            "capacity": self.capacity,
            "used": self.used(),
            "num_objects": len(self.data),
        }

    def close(self, unlink=False):
        self.data.clear()


@pytest.fixture()
def store(tmp_path):
    inner = _TinyStore(capacity=1 << 20)  # 1 MiB
    s = SpillingStore(inner, spill_dir=str(tmp_path / "spill"), capacity=1 << 20)
    yield s
    s.close(unlink=True)


def test_writes_4x_capacity_complete_and_read_back(store):
    blobs = {}
    for i in range(16):  # 16 x 256 KiB = 4 MiB through a 1 MiB arena
        oid = f"obj{i:04d}" + "0" * 20
        data = bytes([i % 251]) * (256 << 10)
        store.put_bytes(oid, data)
        blobs[oid] = data
    # everything is still readable (spilled ones restore from disk)
    for oid, data in blobs.items():
        assert store.get_bytes(oid) == data
    st = store.stats()
    assert st["spilled_objects"] > 0, st  # spill actually happened
    assert st["used"] <= (1 << 20), st  # arena stayed within capacity


def test_lru_order_spills_cold_objects_first(store):
    a = "aaaa" + "0" * 24
    b = "bbbb" + "0" * 24
    store.put_bytes(a, b"x" * (400 << 10))
    store.put_bytes(b, b"y" * (400 << 10))
    store.get_bytes(a)  # touch a → b becomes LRU
    store.put_bytes("cccc" + "0" * 24, b"z" * (400 << 10))
    # b (cold) was spilled; a (hot) stayed resident
    assert store.inner.contains(a)
    assert not store.inner.contains(b)
    assert store.contains(b)  # still readable via disk


def test_oversized_object_goes_to_disk(store):
    big = "big0" + "0" * 24
    store.put_bytes(big, b"w" * (2 << 20))  # 2 MiB > 1 MiB arena
    assert store.contains(big)
    assert store.get_bytes(big) == b"w" * (2 << 20)
    assert store.stats()["spilled_objects"] >= 1


def test_restore_to_arena(store):
    a = "resa" + "0" * 24
    store.put_bytes(a, b"r" * (600 << 10))
    store.put_bytes("resb" + "0" * 24, b"s" * (600 << 10))  # spills a
    assert not store.inner.contains(a)
    assert store.restore_to_arena(a)
    assert store.inner.contains(a)


def test_delete_reaches_both_tiers(store):
    a = "dela" + "0" * 24
    store.put_bytes(a, b"d" * (600 << 10))
    store.put_bytes("delb" + "0" * 24, b"e" * (600 << 10))  # spills a to disk
    store.delete(a)
    assert not store.contains(a)
    assert not store.backend.exists(a)


def test_cluster_workload_4x_store_capacity():
    """End-to-end: tasks producing 4x the node's arena capacity all succeed
    and every output is readable (GC disabled by holding all the refs)."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2, store_capacity=4 << 20)  # 4 MiB
    client = c.client()
    set_runtime(client)
    try:
        def produce(i):
            import numpy as np

            return np.full(512 * 1024 // 4, i, dtype=np.float32)  # 512 KiB

        f = ray_tpu_torch.remote(produce)
        refs = [f.remote(i) for i in range(32)]  # 16 MiB total
        for i in (0, 13, 31):
            assert ray_tpu_torch.get(refs[i], timeout=120)[0] == i
        # batch read-back of everything — spilled outputs restore
        vals = ray_tpu_torch.get(refs, timeout=180)
        assert all(v[0] == i for i, v in enumerate(vals))
    finally:
        set_runtime(None)
        client.shutdown()
        c.shutdown()


# ---------------------------------------------------------------------------
# remote spill storage (external_storage.py analog)
# ---------------------------------------------------------------------------


def test_spill_through_memory_backend(tmp_path):
    """The full spill/restore/delete cycle against a non-filesystem
    backend: objects overflow the arena into the backend and restore
    transparently."""
    from ray_tpu_torch.native.spill import SpillingStore
    from ray_tpu_torch.native.spill_storage import MemoryBackend

    inner = _TinyStore(capacity=1 << 16)
    backend = MemoryBackend()
    s = SpillingStore(
        inner,
        spill_dir=str(tmp_path / "sp"),
        capacity=1 << 16,
        backend=backend,
    )
    blobs = {f"oid{i:02d}": bytes([i]) * (1 << 14) for i in range(8)}
    for oid, data in blobs.items():
        s.put_bytes(oid, data)
    assert s.stats()["spilled_objects"] > 0
    assert len(backend._d) > 0  # objects really live in the backend
    for oid, data in blobs.items():
        assert s.get_bytes(oid) == data
    for oid in blobs:
        s.delete(oid)
    assert not backend._d
    s.close(unlink=True)


class _FakeS3Client:
    """put/get/delete/head surface of an S3 client (boto3 absent here;
    the injected-client path is also how S3-compatibles slot in)."""

    def __init__(self):
        self.objects = {}

    def put_object(self, Bucket, Key, Body):
        self.objects[(Bucket, Key)] = Body

    def get_object(self, Bucket, Key):
        if (Bucket, Key) not in self.objects:
            raise KeyError(Key)
        import io

        return {"Body": io.BytesIO(self.objects[(Bucket, Key)])}

    def head_object(self, Bucket, Key):
        if (Bucket, Key) not in self.objects:
            raise KeyError(Key)
        return {}

    def delete_object(self, Bucket, Key):
        self.objects.pop((Bucket, Key), None)


def test_spill_to_s3_backend(tmp_path):
    from ray_tpu_torch.native.spill import SpillingStore
    from ray_tpu_torch.native.spill_storage import storage_from_uri

    client = _FakeS3Client()
    backend = storage_from_uri(
        "s3://my-bucket/spill/prefix", str(tmp_path), client=client
    )
    inner = _TinyStore(capacity=1 << 15)
    s = SpillingStore(
        inner, spill_dir=str(tmp_path / "sp"), capacity=1 << 15,
        backend=backend,
    )
    big = b"z" * (1 << 14)
    for i in range(6):
        s.put_bytes(f"obj{i}", big)
    # spilled keys landed under the bucket/prefix
    assert any(
        b == "my-bucket" and k.startswith("spill/prefix/")
        for b, k in client.objects
    )
    for i in range(6):
        assert s.get_bytes(f"obj{i}") == big
    s.close(unlink=True)


def test_storage_uri_parsing(tmp_path):
    from ray_tpu_torch.native import spill_storage as ss

    assert isinstance(
        ss.storage_from_uri("", str(tmp_path)), ss.FileSystemBackend
    )
    assert isinstance(
        ss.storage_from_uri(f"file://{tmp_path}", ""), ss.FileSystemBackend
    )
    assert isinstance(
        ss.storage_from_uri("memory://", str(tmp_path)), ss.MemoryBackend
    )
    import pytest as _pytest

    with _pytest.raises(ValueError, match="unsupported"):
        ss.storage_from_uri("gs://bucket/x", str(tmp_path))
    with _pytest.raises(ValueError, match="malformed"):
        ss.storage_from_uri("s3://", str(tmp_path))
    with _pytest.raises(RuntimeError, match="boto3"):
        ss.storage_from_uri("s3://bucket/x", str(tmp_path))
