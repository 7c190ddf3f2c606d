"""The port's AOT-compiled actor pipelines (``compile_pipeline``), and
their parity with the JAX package's.

Mirrors the four pipeline cases of ``tests/test_hotpath.py`` on
``ray_tpu_torch`` with the same assertions: end to end with ordering and
backpressure (and a method stage), a stage error that the pipeline
survives, a stage worker SIGKILLed mid-stream whose unresolved items
respill to the eager task path (``respilled`` counted, zero loss), and
the local mode. Parity: the same seeded inputs through the same stages,
compiled in each package's local runtime, give equal outputs in order.
"""
import os
import signal

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core.runtime import set_runtime


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtime and head bring their scheduler up on cuda and
    # raise without it; here the programs run on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


@pytest.fixture(scope="module")
def cluster(_sched_on_cpu):
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


def _mul10(x):
    return x * 10


def _explode(x):
    if x == 13:
        raise ValueError("unlucky")
    return x


def test_pipeline_end_to_end_and_ordering(cluster, client):
    from ray_tpu_torch.dag import compile_pipeline

    @ray_tpu_torch.remote
    class Host:
        def bump(self, x):
            return x + 100

    a1 = Host.options(num_cpus=0.25).remote()
    a2 = Host.options(num_cpus=0.25).remote()
    pipe = compile_pipeline([a1, a2], [_add1, _mul10], max_inflight=8)
    try:
        # backpressure: way more in flight than max_inflight
        refs = pipe.map(list(range(64)))
        assert [r.get(timeout=60) for r in refs] == [
            (i + 1) * 10 for i in range(64)
        ]
        st = pipe.stats()
        assert st["submitted"] == 64 and st["completed"] == 64
        assert st["respilled"] == 0 and st["broken"] is None
        # method stages bind the hosted actor instance
        pipe2 = compile_pipeline([a1], [_add1, "bump"])
        try:
            assert pipe2.submit(5).get(timeout=60) == 106
        finally:
            pipe2.teardown()
    finally:
        pipe.teardown()
    for h in (a1, a2):
        ray_tpu_torch.kill(h)


def test_pipeline_stage_error_propagates_pipeline_survives(cluster, client):
    from ray_tpu_torch.core.object_store import TaskError
    from ray_tpu_torch.dag import compile_pipeline

    @ray_tpu_torch.remote
    class Host:
        pass

    a = Host.options(num_cpus=0.25).remote()
    pipe = compile_pipeline([a], [_explode, _add1])
    try:
        ok = pipe.map([1, 13, 2])
        assert ok[0].get(timeout=60) == 2
        with pytest.raises(TaskError):
            ok[1].get(timeout=60)
        assert ok[2].get(timeout=60) == 3  # pipeline survived the error
        assert pipe.stats()["broken"] is None
    finally:
        pipe.teardown()
    ray_tpu_torch.kill(a)


def _slow_add(x):
    import time as _t

    _t.sleep(0.02)
    return x + 1


def _tag_pid(x):
    import os as _os

    return (x, _os.getpid())


def test_pipeline_survives_worker_kill_spills_to_eager(
    cluster, client, monkeypatch
):
    """Chaos: SIGKILL the stage worker mid-stream. Unresolved executions
    respill through the eager task path from their retained input frames
    — zero acked loss, later submits ride the eager path transparently."""
    monkeypatch.setenv("RAY_TPU_PIPELINE_STALL_S", "1.0")
    from ray_tpu_torch.dag import compile_pipeline

    @ray_tpu_torch.remote
    class Host:
        def pid(self):
            import os as _os

            return _os.getpid()

    a = Host.options(num_cpus=0.25, max_restarts=0).remote()
    wpid = ray_tpu_torch.get(a.pid.remote(), timeout=60)
    pipe = compile_pipeline([a], [_slow_add, _tag_pid], max_inflight=8)
    try:
        refs = pipe.map(list(range(30)))
        os.kill(wpid, signal.SIGKILL)
        out = [r.get(timeout=120) for r in refs]
        assert [v for v, _ in out] == [i + 1 for i in range(30)]
        st = pipe.stats()
        assert st["broken"] is not None
        assert st["respilled"] > 0
        assert st["completed"] + st["respilled"] == 30
        # the pipeline stays usable: post-break submits go eager
        assert pipe.submit(99).get(timeout=60)[0] == 100
    finally:
        pipe.teardown()


def test_pipeline_local_mode():
    """No cluster: stages run on in-process threads over LocalChannels
    (tensors cross by reference, compiled-DAG style)."""
    from ray_tpu_torch.dag import compile_pipeline

    ray_tpu_torch.init()
    try:

        @ray_tpu_torch.remote
        class Host:
            def bump(self, x):
                return x + 100

        a = Host.remote()
        pipe = compile_pipeline([a], [_add1, "bump"])
        try:
            refs = pipe.map([1, 2, 3])
            assert [r.get(timeout=30) for r in refs] == [102, 103, 104]
        finally:
            pipe.teardown()
    finally:
        ray_tpu_torch.shutdown()


class _Host:
    def bump(self, x):
        return x + 100


def _pipeline_outputs(pkg, inputs):
    import importlib

    api = importlib.import_module(pkg)
    dag_mod = importlib.import_module(f"{pkg}.dag")
    api.init(num_nodes=1, resources_per_node={"CPU": 8})
    try:
        H = api.remote(_Host)
        a, b = H.remote(), H.remote()
        pipe = dag_mod.compile_pipeline(
            [a, b], [_add1, _mul10, "bump"], max_inflight=16
        )
        try:
            return [r.get(timeout=60) for r in pipe.map(inputs)], pipe.stats()
        finally:
            pipe.teardown()
    finally:
        api.shutdown()


def test_pipeline_equal_to_the_reference():
    """The same 300 seeded inputs (ints and f64 arrays) through the same
    three stages: equal outputs in order from both packages, and equal
    submitted/completed/respilled counts."""
    rng = np.random.default_rng(3)
    inputs = [int(v) for v in rng.integers(-10**6, 10**6, 200)]
    inputs += [rng.standard_normal(8) for _ in range(100)]
    want, wst = _pipeline_outputs("ray_tpu", inputs)
    got, gst = _pipeline_outputs("ray_tpu_torch", inputs)
    assert len(got) == len(want) == 300
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        else:
            assert g == w
    for key in ("submitted", "completed", "respilled", "broken"):
        assert gst[key] == wst[key], key
