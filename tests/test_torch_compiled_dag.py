"""The port's compiled DAGs, local and cluster, and their parity with the
JAX package's.

Mirrors ``tests/test_compiled_dag.py`` and ``tests/test_observability.py``'s
``test_dag_bind_and_compile`` on ``ray_tpu_torch``, with the same
assertions. Parity: bench.py's three-stage ``_Stage`` chain, compiled in
each package's local runtime, gives equal outputs in order over the same
200 seeded inputs; and a CPU tensor crosses a local edge by reference
(same ``data_ptr()``).
"""
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core.object_store import TaskError
from ray_tpu_torch.dag import InputNode, MultiOutputNode


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtime and head bring their scheduler up on cuda and
    # raise without it; here the programs run on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


@pytest.fixture()
def rt():
    ray_tpu_torch.init(num_nodes=2, resources_per_node={"CPU": 8})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


class TestLocalCompiledDag:
    def test_chain_correctness_and_pipelining(self, rt):
        @ray_tpu_torch.remote
        class Stage:
            def __init__(self, k):
                self.k = k

            def f(self, x):
                return x + self.k

        a, b, c = Stage.remote(1), Stage.remote(10), Stage.remote(100)
        with InputNode() as inp:
            dag = c.f.bind(b.f.bind(a.f.bind(inp)))
        compiled = dag.experimental_compile()
        try:
            # pipelined: submit all, then collect
            refs = [compiled.execute(i) for i in range(20)]
            for i, r in enumerate(refs):
                assert r.get(timeout=30) == i + 111
        finally:
            compiled.teardown()

    def test_fan_out_fan_in(self, rt):
        @ray_tpu_torch.remote
        class W:
            def mul(self, x, y):
                return x * y

            def add(self, x, y):
                return x + y

        w1, w2, w3 = W.remote(), W.remote(), W.remote()
        with InputNode() as inp:
            left = w1.mul.bind(inp, 2)
            right = w2.add.bind(inp, 5)
            dag = w3.add.bind(left, right)
        compiled = dag.experimental_compile()
        try:
            for i in range(8):
                assert compiled.execute(i).get(timeout=30) == 2 * i + i + 5
        finally:
            compiled.teardown()

    def test_error_propagates_in_order(self, rt):
        @ray_tpu_torch.remote
        class S:
            def f(self, x):
                if x == 3:
                    raise ValueError("boom at 3")
                return x * 2

            def g(self, x):
                return x + 1

        a, b = S.remote(), S.remote()
        with InputNode() as inp:
            dag = b.g.bind(a.f.bind(inp))
        compiled = dag.experimental_compile()
        try:
            refs = [compiled.execute(i) for i in range(6)]
            for i, r in enumerate(refs):
                if i == 3:
                    with pytest.raises(TaskError):
                        r.get(timeout=30)
                else:
                    assert r.get(timeout=30) == i * 2 + 1
        finally:
            compiled.teardown()

    def test_objects_pass_by_reference(self, rt):
        """Local edges hand objects over without serialization — a CUDA
        tensor crossing a local edge stays on the card (in-process RDT)."""

        @ray_tpu_torch.remote
        class Echo:
            def f(self, x):
                return x

        marker = object()
        payload = {"k": marker}

        a, b = Echo.remote(), Echo.remote()
        with InputNode() as inp:
            dag = b.f.bind(a.f.bind(inp))
        compiled = dag.experimental_compile()
        try:
            out = compiled.execute(payload).get(timeout=30)
            assert out is payload  # same object, zero copies
        finally:
            compiled.teardown()

    def test_multi_output(self, rt):
        @ray_tpu_torch.remote
        class S:
            def inc(self, x):
                return x + 1

            def dec(self, x):
                return x - 1

        a, b = S.remote(), S.remote()
        with InputNode() as inp:
            dag = MultiOutputNode([a.inc.bind(inp), b.dec.bind(inp), inp])
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(7).get(timeout=30) == [8, 6, 7]
        finally:
            compiled.teardown()


class TestShmRing:
    def test_large_messages_wrap(self, tmp_path):
        """Messages bigger than half the ring must still flow (byte-wise
        wrap; the no-wrap design would stall forever at an unlucky
        offset)."""
        from ray_tpu_torch.dag.channel import OK, ShmChannel

        path = str(tmp_path / "wrap.ring")
        w = ShmChannel(path, capacity=1 << 16, create=True)
        r = ShmChannel(path, capacity=1 << 16)
        import threading

        big = os.urandom(40_000)  # > cap/2 after the 4 KiB round-up
        got = []

        def reader():
            for _ in range(12):
                got.append(r.get(timeout=20))

        t = threading.Thread(target=reader)
        t.start()
        # odd sizes walk the write offset through every alignment
        for i in range(12):
            w.put(OK, big + bytes([i]) * (i * 7 + 1), timeout=20)
        t.join(timeout=30)
        assert not t.is_alive()
        for i, (tag, v) in enumerate(got):
            assert tag == OK and v == big + bytes([i]) * (i * 7 + 1)
        w.unlink()
        r.close()

    def test_oversize_rejected(self, tmp_path):
        from ray_tpu_torch.dag.channel import OK, ShmChannel

        w = ShmChannel(str(tmp_path / "o.ring"), capacity=1 << 12, create=True)
        with pytest.raises(ValueError, match="buffer_size_bytes"):
            w.put(OK, b"z" * (1 << 13))
        w.unlink()


# ---------------------------------------------------------------------------
# tests/test_observability.py: bind, execute and compile
# ---------------------------------------------------------------------------


def test_dag_bind_and_compile(rt):
    @ray_tpu_torch.remote
    class Adder:
        def __init__(self, k):
            self.k = k

        def add(self, x):
            return x + self.k

    @ray_tpu_torch.remote
    def square(x):
        return x * x

    a1 = Adder.remote(1)
    a2 = Adder.remote(10)
    with InputNode() as inp:
        dag = MultiOutputNode(
            [a2.add.bind(square.bind(a1.add.bind(inp))), a1.add.bind(inp)]
        )
    assert dag.execute(3) == [(3 + 1) ** 2 + 10, 4]
    compiled = dag.experimental_compile()
    try:
        for i in range(5):
            assert compiled.execute(i).get(timeout=30) == [
                (i + 1) ** 2 + 10,
                i + 1,
            ]
    finally:
        compiled.teardown()


# ---------------------------------------------------------------------------
# parity with the JAX package, and the local edge's by-reference hand-over
# ---------------------------------------------------------------------------


class _BenchStage:
    """bench.py's tier-4 ``_Stage``."""

    def __init__(self, k):
        self.k = k

    def f(self, x):
        return x + self.k


def _chain_outputs(pkg, inputs):
    import importlib

    api = importlib.import_module(pkg)
    dag_mod = importlib.import_module(f"{pkg}.dag")
    api.init(num_nodes=1, resources_per_node={"CPU": 8})
    try:
        S = api.remote(_BenchStage).options(num_cpus=0.25, max_retries=0)
        sa, sb, sc = S.remote(1), S.remote(10), S.remote(100)
        with dag_mod.InputNode() as inp:
            dag = sc.f.bind(sb.f.bind(sa.f.bind(inp)))
        compiled = dag.experimental_compile()
        try:
            refs = [compiled.execute(x) for x in inputs]
            return [r.get(timeout=60) for r in refs]
        finally:
            compiled.teardown()
    finally:
        api.shutdown()


def test_bench_chain_equal_to_the_reference():
    """bench.py's three-stage chain over 200 seeded inputs (ints and f64
    arrays): the same outputs, in the same order, from both packages."""
    rng = np.random.default_rng(12)
    inputs = [int(v) for v in rng.integers(-10**6, 10**6, 100)]
    inputs += [rng.standard_normal(16) for _ in range(100)]
    want = _chain_outputs("ray_tpu", inputs)
    got = _chain_outputs("ray_tpu_torch", inputs)
    assert len(got) == len(want) == 200
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        else:
            assert g == w


def test_local_edge_keeps_the_tensor(rt):
    """Same-process edges hand the tensor over without a copy: the output
    is the input tensor, ``data_ptr()`` and all."""

    @ray_tpu_torch.remote
    class Holder:
        def echo(self, x):
            return x

    a, b = Holder.remote(), Holder.remote()
    with InputNode() as inp:
        dag = b.echo.bind(a.echo.bind(inp))
    compiled = dag.experimental_compile()
    try:
        t = torch.arange(4096, dtype=torch.float32)
        out = compiled.execute(t).get(timeout=30)
        assert out is t and out.data_ptr() == t.data_ptr()
    finally:
        compiled.teardown()


# ---------------------------------------------------------------------------
# cluster mode (last: its module-scoped client stays the runtime until the end)
# ---------------------------------------------------------------------------


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


class _ChainStage:
    def __init__(self, k):
        self.k = k

    def f(self, x):
        return x + self.k


def _kill_quietly(*actors):
    for a in actors:
        try:
            ray_tpu_torch.kill(a)
        except Exception:  # noqa: BLE001
            pass


class TestClusterCompiledDag:
    def test_chain_correctness(self, cluster_client):
        S = ray_tpu_torch.remote(_ChainStage).options(num_cpus=0.25)
        a, b, c = S.remote(1), S.remote(10), S.remote(100)
        with InputNode() as inp:
            dag = c.f.bind(b.f.bind(a.f.bind(inp)))
        compiled = dag.experimental_compile()
        try:
            refs = [compiled.execute(i) for i in range(10)]
            for i, r in enumerate(refs):
                assert r.get(timeout=60) == i + 111
        finally:
            compiled.teardown()
            _kill_quietly(a, b, c)

    def test_throughput_beats_eager_5x(self, cluster_client):
        """3-actor chain, compiled >= 5x the eager .remote() path at batch
        1 (sequential round trips), the reference's acceptance bar."""
        S = ray_tpu_torch.remote(_ChainStage).options(num_cpus=0.25)
        a, b, c = S.remote(1), S.remote(10), S.remote(100)

        # eager: each hop is a scheduled actor method (chained refs)
        N = 30
        # warmup both paths
        ray_tpu_torch.get(c.f.remote(b.f.remote(a.f.remote(0))), timeout=60)
        t0 = time.perf_counter()
        for i in range(N):
            out = ray_tpu_torch.get(
                c.f.remote(b.f.remote(a.f.remote(i))), timeout=60
            )
        eager_s = time.perf_counter() - t0
        assert out == N - 1 + 111

        with InputNode() as inp:
            dag = c.f.bind(b.f.bind(a.f.bind(inp)))
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(0).get(timeout=60) == 111  # warm
            t0 = time.perf_counter()
            for i in range(N):
                out = compiled.execute(i).get(timeout=60)
            compiled_s = time.perf_counter() - t0
            assert out == N - 1 + 111
        finally:
            compiled.teardown()
            _kill_quietly(a, b, c)
        speedup = eager_s / compiled_s
        assert speedup >= 5.0, (
            f"compiled DAG only {speedup:.1f}x faster "
            f"(eager {eager_s*1e3/N:.2f} ms/iter, "
            f"compiled {compiled_s*1e3/N:.2f} ms/iter)"
        )

    def test_error_propagation(self, cluster_client):
        @ray_tpu_torch.remote(num_cpus=0.25)
        class Boom:
            def f(self, x):
                if x < 0:
                    raise RuntimeError("negative")
                return x

        a, b = Boom.remote(), Boom.remote()
        with InputNode() as inp:
            dag = b.f.bind(a.f.bind(inp))
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(5).get(timeout=60) == 5
            with pytest.raises(TaskError):
                compiled.execute(-1).get(timeout=60)
            # pipeline still healthy after an error
            assert compiled.execute(9).get(timeout=60) == 9
        finally:
            compiled.teardown()
            _kill_quietly(a, b)

    def test_teardown_unlinks_channels(self, cluster_client):
        from ray_tpu_torch.dag.channel import channel_dir

        S = ray_tpu_torch.remote(_ChainStage).options(num_cpus=0.25)
        a = S.remote(1)
        with InputNode() as inp:
            dag = a.f.bind(inp)
        compiled = dag.experimental_compile()
        dag_id = compiled._dag_id
        assert compiled.execute(1).get(timeout=60) == 2
        files = [
            f for f in os.listdir(channel_dir()) if f.startswith(dag_id)
        ]
        assert files, "ring files should exist while the DAG is live"
        compiled.teardown()
        _kill_quietly(a)
        files = [
            f for f in os.listdir(channel_dir()) if f.startswith(dag_id)
        ]
        assert not files, "teardown must unlink ring files"


def test_dag_actor_death_fails_cleanly(cluster_client):
    """Killing a participating actor must surface as an error/timeout on
    pending executions — never a silent hang past the get timeout — and
    teardown must still reclaim the channels."""
    from ray_tpu_torch.dag.channel import channel_dir

    S = ray_tpu_torch.remote(_ChainStage).options(num_cpus=0.25)
    a, b = S.remote(1), S.remote(10)
    with InputNode() as inp:
        dag = b.f.bind(a.f.bind(inp))
    compiled = dag.experimental_compile()
    dag_id = compiled._dag_id
    try:
        assert compiled.execute(5).get(timeout=60) == 16
        ray_tpu_torch.kill(a)
        time.sleep(0.5)
        ref = compiled.execute(7)
        with pytest.raises(Exception):  # error or bounded timeout, no hang
            ref.get(timeout=15)
    finally:
        compiled.teardown()
        _kill_quietly(a, b)
    leftover = [f for f in os.listdir(channel_dir()) if f.startswith(dag_id)]
    assert not leftover, "teardown must unlink ring files after a death"
