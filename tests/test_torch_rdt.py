"""The port's RDT tensor transport: same-process by reference,
cross-process raw-codec staging, compiled-DAG tensor edges.

Mirrors the seven cases of ``tests/test_rdt.py`` on ``ray_tpu_torch``,
with torch tensors where the reference has ``jax.Array``s and the same
assertions.
"""
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import rdt
from ray_tpu_torch.dag import InputNode


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtime and head bring their scheduler up on cuda and
    # raise without it; here the programs run on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


@pytest.fixture()
def rt():
    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 8})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_codec_roundtrip_numpy():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    data = rdt.encode_tensor(arr)
    ok, out = rdt.decode_tensor(data)
    assert ok and out.dtype == np.float32 and np.array_equal(out, arr)
    out[0, 0] = 99  # decoded arrays are writable


def test_codec_roundtrip_torch():
    arr = torch.arange(8, dtype=torch.float32) * 2
    data = rdt.encode_tensor(arr)
    ok, out = rdt.decode_tensor(data)
    assert ok and isinstance(out, torch.Tensor)
    assert out.device.type == "cpu" and torch.equal(out, arr)
    out[0] = 99  # decoded tensors are writable and decoupled
    assert arr[0] == 0


def test_codec_rejects_non_tensor():
    assert rdt.encode_tensor({"x": 1}) is None
    with pytest.raises(TypeError):
        rdt.put_tensor([1, 2, 3])


def test_codec_rejects_exotic_arrays():
    """Structured/object/masked/datetime arrays must fall through to
    pickle — a raw name+bytes round trip would corrupt them."""
    structured = np.zeros(3, dtype=[("a", "i4"), ("b", "f8")])
    assert rdt.encode_tensor(structured) is None
    obj = np.array([{"x": 1}, None], dtype=object)
    assert rdt.encode_tensor(obj) is None
    masked = np.ma.masked_array([1, 2, 3], mask=[0, 1, 0])
    assert rdt.encode_tensor(masked) is None
    dt = np.array(["2026-01-01"], dtype="datetime64[D]")
    assert rdt.encode_tensor(dt) is None
    # but bfloat16 IS accepted, as a torch tensor and as a numpy array of
    # ml_dtypes (loaded here by the JAX package)
    bf = torch.zeros(4, dtype=torch.bfloat16)
    ok, out = rdt.decode_tensor(rdt.encode_tensor(bf))
    assert ok and out.dtype == torch.bfloat16
    import ml_dtypes

    nbf = np.zeros(4, dtype=ml_dtypes.bfloat16)
    ok, out = rdt.decode_tensor(rdt.encode_tensor(nbf))
    assert ok and out.dtype == nbf.dtype


def test_put_get_tensor(rt):
    ref = rdt.put_tensor(torch.ones((16, 16), dtype=torch.bfloat16))
    out = rdt.get_tensor(ref)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (16, 16)


def test_local_dag_device_array_by_reference(rt):
    """Same-process edges hand the tensor over without any copy."""

    @ray_tpu_torch.remote
    class Holder:
        def echo(self, x):
            return x

    a = Holder.remote()
    with InputNode() as inp:
        dag = a.echo.bind(inp)
    compiled = dag.experimental_compile()
    try:
        arr = torch.arange(32, dtype=torch.float32)
        out = compiled.execute(arr).get(timeout=30)
        assert out is arr  # by reference: zero transport
    finally:
        compiled.teardown()


@pytest.fixture(scope="module")
def cluster_client(_sched_on_cpu):
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    client = c.client()
    set_runtime(client)
    yield client
    set_runtime(None)
    client.shutdown()
    c.shutdown()


class _Scaler:
    def scale(self, x):
        return x * 2.0


def test_cluster_dag_tensor_edge(cluster_client):
    """Cross-process ring edges carry tensors via the raw codec — the
    consumer stage receives a live tensor and computes on it."""
    S = ray_tpu_torch.remote(_Scaler).options(num_cpus=0.5)
    a, b = S.remote(), S.remote()
    with InputNode() as inp:
        dag = b.scale.bind(a.scale.bind(inp))
    compiled = dag.experimental_compile()
    try:
        arr = np.full((64,), 3.0, dtype=np.float32)
        out = compiled.execute(torch.from_numpy(arr)).get(timeout=240)
        assert isinstance(out, torch.Tensor)
        assert np.allclose(out.numpy(), arr * 4.0)
    finally:
        compiled.teardown()
        for h in (a, b):
            try:
                ray_tpu_torch.kill(h)
            except Exception:  # noqa: BLE001
                pass
