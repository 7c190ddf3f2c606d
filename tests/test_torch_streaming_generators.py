"""Streaming generator returns (num_returns="streaming") on a cluster:
the cluster cases of ``tests/test_streaming_generators.py`` on the port,
with ``ray_tpu`` read as ``ray_tpu_torch`` and the scheduler's rounds on
the host (``tests/test_torch_core_api.py`` mirrors the in-process ones).
"""
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def _count(n):
    for i in range(n):
        yield i * 2


# ---------------------------------------------------------------------------
# cluster runtime
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    c.add_node({"CPU": 4.0}, num_workers=2)
    yield c
    c.shutdown()


@pytest.fixture()
def client(cluster):
    rt = cluster.client()
    from ray_tpu_torch.core.runtime import set_runtime

    set_runtime(rt)
    yield rt
    set_runtime(None)
    rt.shutdown()


def _tagged(n):
    import os

    node = os.environ.get("RAY_TPU_NODE_ID")
    for i in range(n):
        yield {"i": i, "node": node}


def test_cluster_streaming_1000_items_incremental(client):
    """1,000 yields consumed incrementally across nodes: the consumer
    overlaps with production (first item arrives long before the
    generator finishes) and sees every item in order."""

    def slow_tail(n):
        for i in range(n):
            if i == n - 1:
                time.sleep(1.0)  # consumer must not need the last item
            yield i

    t0 = time.monotonic()
    g = (
        ray_tpu_torch.remote(slow_tail)
        .options(num_returns="streaming", num_cpus=0.5, max_retries=0)
        .remote(1000)
    )
    it = iter(g)
    first = ray_tpu_torch.get(next(it), timeout=60)
    t_first = time.monotonic() - t0
    assert first == 0
    rest = [ray_tpu_torch.get(r, timeout=60) for r in it]
    assert rest == list(range(1, 1000))
    # incremental: item 0 was consumable before the tail sleep finished
    assert t_first < 30.0


def test_cluster_streaming_small_window_backpressure(cluster):
    """A window smaller than the item count forces producer pauses; the
    stream still delivers everything in order (credit flow through
    StreamConsumed)."""
    import os

    os.environ["RAY_TPU_STREAMING_WINDOW"] = "8"
    try:
        rt = cluster.client()
        from ray_tpu_torch.core.runtime import set_runtime

        set_runtime(rt)
        try:
            g = (
                ray_tpu_torch.remote(_count)
                .options(
                    num_returns="streaming", num_cpus=0.5, max_retries=0
                )
                .remote(100)
            )
            vals = []
            for r in g:
                vals.append(ray_tpu_torch.get(r, timeout=60))
                time.sleep(0.002)  # slow consumer
            assert vals == [i * 2 for i in range(100)]
        finally:
            set_runtime(None)
            rt.shutdown()
    finally:
        os.environ.pop("RAY_TPU_STREAMING_WINDOW", None)


def test_cluster_streaming_worker_kill_mid_stream_recovers():
    """Mid-stream executor death: the lease retries on the surviving
    node, the deterministic item ids re-seal, and the consumer sees the
    full sequence (reference: generator task lineage reconstruction)."""
    c = Cluster()
    c.add_node({"CPU": 2.0}, num_workers=2)
    c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    from ray_tpu_torch.core.runtime import set_runtime

    set_runtime(rt)
    try:

        def slow_gen(n):
            import os
            import time as _t

            node = os.environ.get("RAY_TPU_NODE_ID")
            for i in range(n):
                _t.sleep(0.05)
                yield {"i": i, "node": node}

        g = (
            ray_tpu_torch.remote(slow_gen)
            .options(num_returns="streaming", num_cpus=0.5, max_retries=2)
            .remote(40)
        )
        it = iter(g)
        first = ray_tpu_torch.get(next(it), timeout=60)
        c.kill_node(first["node"])  # executor dies mid-stream
        vals = [first["i"]] + [
            ray_tpu_torch.get(r, timeout=120)["i"] for r in it
        ]
        assert vals == list(range(40))
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


