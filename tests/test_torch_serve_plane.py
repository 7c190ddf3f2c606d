"""The serving plane on the port: the seven cases of
``tests/test_serve_plane.py`` that ``tests/test_torch_prefix_cache.py``
does not mirror (the push-plane stream sink, the relay fallback, the SLO
autoscaler, zero per-request head RPCs in the steady state, a stream end
to end with an admission shed, a disconnect mid-stream, the
``QueryState("serve")`` surface), with ``ray_tpu`` read as
``ray_tpu_torch`` and the scheduler's rounds on the host; and its slow
case, two replica kills mid-stream under the port's chaos orchestrator
(``ray_tpu_torch.chaos``), the replicas' engines on the CPU.
"""
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.runtime import set_runtime


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def _wait_for(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise TimeoutError(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# push-plane stream transport (sink + writer units)
# ---------------------------------------------------------------------------
def test_stream_sink_push_ordering_and_cancel():
    from ray_tpu_torch.experimental import ChannelClosed as RingClosed
    from ray_tpu_torch.serve.router import (
        ChannelClosed,
        PushWriter,
        StreamSink,
    )

    sink = StreamSink()
    try:
        sid, stream = sink.open()
        w = PushWriter(sink.address, sid)
        for i in range(5):
            w.write(i)
        w.close_channel()
        got = []
        while True:
            try:
                got.append(stream.read(timeout=5))
            except ChannelClosed:
                break
        assert got == [0, 1, 2, 3, 4]
        # cancel propagation: a discarded stream rejects further pushes
        # (spaced past the writer's micro-batch window so every write
        # flushes and observes the cancel reply)
        sid2, _stream2 = sink.open()
        w2 = PushWriter(sink.address, sid2)
        w2.write("x")
        sink.discard(sid2)
        with pytest.raises(RingClosed):
            for _ in range(10):
                w2.write("y")
                time.sleep(0.01)
    finally:
        sink.stop()


def test_relay_fallback_bounded_and_cancellable():
    """The legacy polling relay (RAY_TPU_SERVE_PUSH_STREAMS=0 fallback):
    cancel drops buffered items and pushes -1 back at the writer."""
    import asyncio

    from ray_tpu_torch.serve.proxy import _StreamRelayActor

    actor = _StreamRelayActor(max_buffer=8)

    async def drive():
        assert await actor.push(0, ["a", "b"]) == 2
        await actor.cancel()
        assert await actor.push(1, ["c"]) == -1  # writer must stop
        assert await actor.depth() == -1
        items, ended = await actor.pop(timeout=0.05)
        assert items == [] and ended

    asyncio.run(drive())


# ---------------------------------------------------------------------------
# SLO autoscaler (in-process runtime)
# ---------------------------------------------------------------------------
def _grant_order(cls, arrivals=40, idle_s=1.0):
    """Park ``arrivals`` requests of two tenants behind one held slot of a
    ``cls`` admission controller, leave them idle ``idle_s``, then release:
    (the order they were admitted in, the controller)."""
    import threading

    adm = cls(max_inflight=1, wait_cap=64, wait_timeout_s=10.0)
    held = adm.admit("a")
    order, lock, threads = [], threading.Lock(), []

    def arrive(i):
        ticket = adm.admit("ab"[i % 2])
        with lock:
            order.append(i)
        time.sleep(0.005)
        ticket.done()

    for i in range(arrivals):
        threads.append(threading.Thread(target=arrive, args=(i,)))
        threads[-1].start()
        _wait_for(lambda: adm.stats()["waiting"] == i + 1, msg=f"arrival {i} parked")
    time.sleep(idle_s)
    held.done()
    for th in threads:
        th.join(timeout=30)
    return order, adm


def test_parked_arrivals_wake_only_for_their_grant():
    """Queue C 25: a parked arrival sleeps until the pump grants it or its
    deadline passes (the bucket here is unlimited, so no refill can grant
    it). The reference's waiters poll every 50 ms, and under 2x overload
    on the card (124 parked) they starved the client process's other threads: the
    router's pressure export and the in-process head's elasticity ticks
    (3.4-7.0 s each) ran too late for the controller to cede at the peak.
    The grant order is the reference's, tenant for tenant."""
    from ray_tpu.serve.admission import AdmissionController as JAdmissionController
    from ray_tpu_torch.serve.admission import AdmissionController

    order, adm = _grant_order(AdmissionController)
    want, _ = _grant_order(JAdmissionController)
    assert sorted(order) == list(range(40))
    assert order == want
    assert adm.stats()["wakeups"] == 0  # 40 parked for 1 s: none woke but to run
    assert adm.stats()["inflight"] == 0 and adm.stats()["waiting"] == 0


def test_admission_under_contention_never_exceeds_its_depth():
    """Stress of the waiting room's per-waiter wakeups: 64 threads (more
    than the cores) admit, hold and release against a depth of 4 under a
    shortened switch interval; the in-flight count never passes 4, every
    arrival is admitted or shed, and the room ends empty."""
    import sys
    import threading

    from ray_tpu_torch.serve.admission import AdmissionController, Overloaded

    adm = AdmissionController(max_inflight=4, wait_cap=32, wait_timeout_s=5.0)
    lock, seen, outcomes = threading.Lock(), [0], {"admitted": 0, "shed": 0}

    def arrive(i):
        for _ in range(5):
            try:
                ticket = adm.admit("ab"[i % 2])
            except Overloaded:
                with lock:
                    outcomes["shed"] += 1
                continue
            with lock:
                outcomes["admitted"] += 1
                seen[0] = max(seen[0], adm.stats()["inflight"])
            time.sleep(0.001)
            ticket.done()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=arrive, args=(i,)) for i in range(64)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert seen[0] <= 4
    assert outcomes["admitted"] + outcomes["shed"] == 64 * 5
    assert outcomes["admitted"] == adm.stats()["admitted"] and outcomes["admitted"] > 0
    assert adm.stats()["inflight"] == 0 and adm.stats()["waiting"] == 0


def test_slo_autoscaler_scales_up_then_drains():
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.serve.slo_autoscaler import SLOAutoscaler, SLOConfig

    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 8})
    try:

        @serve.deployment(name="scaled", num_replicas=1)
        class Echo:
            def __call__(self, payload):
                return payload

        serve.run(Echo.bind())
        router = serve.get_router("scaled")
        rs = router._rs
        metrics = {"inflight": 50, "ttft_p50_ms": 0.0}
        now = [0.0]
        scaler = SLOAutoscaler(
            router,
            SLOConfig(
                min_replicas=1,
                max_replicas=3,
                target_queue_per_replica=4.0,
                upscale_delay_s=1.0,
                downscale_delay_s=1.0,
            ),
            metrics_fn=lambda: {
                **metrics, "replicas": rs.num_replicas,
            },
            clock=lambda: now[0],
        )
        assert scaler.tick() == "hold"  # arms the over-window
        now[0] += 2.0
        assert scaler.tick() == "up"
        assert rs.num_replicas == 2
        assert rs.target == 2
        # sustained idleness drains one replica gracefully
        metrics["inflight"] = 0
        scaler.tick()
        now[0] += 2.0
        assert scaler.tick() == "down"
        _wait_for(
            lambda: rs.num_replicas == 1, msg="drained replica removed"
        )
        assert rs.target == 1
        assert scaler.state()["scale_ups"] == 1
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# cluster tier: zero head RPCs, streaming, failover
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cluster():
    from ray_tpu_torch.cluster import Cluster

    c = Cluster(use_device_scheduler=False)
    c.add_node({"CPU": 8.0}, num_workers=3)
    c.add_node({"CPU": 8.0}, num_workers=3)
    yield c
    c.shutdown()


@pytest.fixture()
def client(cluster):
    import ray_tpu_torch.serve as serve

    rt = cluster.client()
    set_runtime(rt)
    yield rt
    serve.shutdown()
    set_runtime(None)
    rt.shutdown()


class _EchoServer:
    def __call__(self, payload):
        return {"echo": payload}


def test_unary_zero_head_rpcs_steady_state(cluster, client):
    """Steady-state routed requests ride the direct channels: the head's
    per-request surfaces (lease submissions, object waits, actor
    creations) must NOT grow with request count."""
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.cluster.rpc import HANDLER_STATS

    app = serve.deployment(name="echo", num_replicas=2)(_EchoServer).bind()
    serve.run(app)
    router = serve.get_router("echo")
    # warm: replica actors alive, direct channels resolved
    for i in range(8):
        assert router.call({"i": i}, timeout=60)["echo"]["i"] == i
    _wait_for(
        lambda: any(
            not k.startswith("lease:") and getattr(c, "_worker", None)
            for k, c in client._direct_channels.items()
        ),
        msg="a warm direct actor channel",
    )

    def head_counters():
        snap = HANDLER_STATS.snapshot()
        names = (
            "SubmitLease", "WaitObjectBatch", "WaitObject", "PutObject",
            "GrantTaskLease", "CreateActor", "WaitActor", "LocateObjects",
        )
        return {
            n: (snap.get(n) or {}).get("count", 0) for n in names
        }, cluster.head.metrics["leases_submitted"]

    before, leases_before = head_counters()
    n = 100
    reqs = [router.submit({"i": i}) for i in range(n)]
    for i, r in enumerate(reqs):
        assert r.result(60)["echo"]["i"] == i
    after, leases_after = head_counters()
    growth = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    assert sum(growth.values()) < n // 2, (
        f"per-request head RPCs in steady state: {growth}"
    )
    assert leases_after - leases_before < n // 2, (
        "routed requests fell back to head-scheduled leases"
    )
    from ray_tpu_torch.serve.router import SERVE_LEASE_HITS

    assert SERVE_LEASE_HITS.value({"deployment": "echo"}) > 0
    stats = router.stats()
    assert stats["codes"].get("200", 0) >= n
    assert len(stats["replicas"]) == 2
    # the completion watcher drains ongoing counts asynchronously —
    # wait for the drain rather than racing it on a loaded box
    _wait_for(
        lambda: all(
            r["ongoing"] == 0 for r in router.stats()["replicas"]
        ),
        msg="replica ongoing counts drained",
    )


class _SlowTokenServer:
    """Streams tokens slowly enough that a client disconnect lands
    mid-generation; counts writes so the test can observe the abort."""

    def __init__(self):
        self.written = 0

    def stream_to(self, writer, request):
        from ray_tpu_torch.experimental import ChannelClosed

        n = int(request.get("n", 100))
        try:
            for i in range(n):
                writer.write(f"tok{i}")
                self.written += 1
                time.sleep(0.03)
            writer.close_channel()
        except ChannelClosed:
            pass  # consumer cancelled: stop generating
        return self.written

    def count(self):
        return self.written


def test_stream_end_to_end_and_admission_shed(cluster, client, monkeypatch):
    """Full stream through the router (push transport), then a shed:
    depth-capped admission rejects the second concurrent stream with a
    typed Overloaded before any replica work is accepted."""
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.serve.admission import AdmissionController, Overloaded
    from ray_tpu_torch.serve.router import ChannelClosed

    monkeypatch.setenv("RAY_TPU_SERVE_SHM_STREAMS", "0")
    app = serve.deployment(name="tok", num_replicas=1)(
        _SlowTokenServer
    ).bind()
    serve.run(app)
    router = serve.get_router("tok")
    router.admission = AdmissionController(max_inflight=1, wait_cap=0)
    stream = router.stream({"n": 5})
    with pytest.raises(Overloaded):
        router.stream({"n": 5})
    got = list(stream)
    assert got == [f"tok{i}" for i in range(5)]
    # finished stream released its admission slot
    assert router.admission.stats()["inflight"] == 0
    second = router.stream({"n": 2})
    assert list(second) == ["tok0", "tok1"]


def test_disconnect_mid_stream_stops_generation(cluster, client, monkeypatch):
    import ray_tpu_torch.serve as serve

    monkeypatch.setenv("RAY_TPU_SERVE_SHM_STREAMS", "0")
    app = serve.deployment(name="aborted", num_replicas=1)(
        _SlowTokenServer
    ).bind()
    handle = serve.run(app)
    router = serve.get_router("aborted")
    stream = router.stream({"n": 300})
    for _ in range(3):
        stream.read(timeout=30)
    stream.close()  # cancel: the sink now rejects the replica's pushes
    # generation must stop well short of 300 writes
    time.sleep(1.0)
    c1 = ray_tpu_torch.get(handle.count.remote(), timeout=30)
    time.sleep(1.0)
    c2 = ray_tpu_torch.get(handle.count.remote(), timeout=30)
    assert c2 == c1, "replica kept generating after client disconnect"
    assert c2 < 300


def test_query_state_serve_surface(cluster, client):
    """The router's periodic report lands in head QueryState('serve')."""
    import ray_tpu_torch.serve as serve

    app = serve.deployment(name="observed", num_replicas=1)(
        _EchoServer
    ).bind()
    serve.run(app)
    router = serve.get_router("observed")
    assert router.call({"x": 1}, timeout=60)["echo"]["x"] == 1

    def reported():
        state = client.query_state("serve")
        return "observed" in (state or {}).get("deployments", {})

    _wait_for(reported, timeout=15.0, msg="serve state reported to head")
    blob = client.query_state("serve")["deployments"]["observed"]
    assert blob["admission"]["admitted"] >= 1
    assert len(blob["replicas"]) == 1
    assert "lease_hit_rate" in blob and "ttft_ms" in blob


# ---------------------------------------------------------------------------
# slow tier: replica SIGKILL mid-stream under the chaos orchestrator
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_replica_kill_mid_stream_recovers():
    """Open-loop verified streams + two replica_kill faults: streams
    fail over with resume_from (no duplicated/dropped acked tokens),
    the replica set backfills, and no arena pins leak."""
    import torch

    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.chaos import (
        SERVE_MIX,
        ChaosOrchestrator,
        ChaosWorkload,
        ServeStreamWorkload,
        make_plan,
    )
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.llm.continuous import ContinuousBatchingEngine
    from ray_tpu_torch.llm.engine import GenerationConfig
    from ray_tpu_torch.llm.serving import build_llm_deployment
    from ray_tpu_torch.models import transformer as tfm

    # vocab 258 where the reference has 64: the byte tokenizer's BOS is
    # 256, which JAX's embedding gather clamps into a 64-row table and
    # torch's indexing refuses
    mcfg = tfm.ModelConfig(
        vocab_size=258, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=96, max_seq_len=96, dtype=torch.float32,
    )
    params = tfm.init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
    prompt = "chaos stream"
    max_new = 10
    # the deterministic reference sequence: the replicas' weights, on the
    # same engine
    ref_engine = ContinuousBatchingEngine(
        mcfg, params, max_batch=2, page_size=8, n_pages=64, device="cpu"
    )
    gen = GenerationConfig(max_new_tokens=max_new, temperature=0.0, seed=0)
    expected = [
        ref_engine.tokenizer.decode([int(t)])
        for t in ref_engine.stream_ids(
            ref_engine.tokenizer.encode(prompt), gen
        )
    ]
    assert len(expected) == max_new

    cluster = Cluster(use_device_scheduler=False)
    cluster.add_node({"CPU": 8.0}, num_workers=3)
    cluster.add_node({"CPU": 8.0}, num_workers=3)
    rt = cluster.client()
    set_runtime(rt)
    workload = None
    try:
        app = build_llm_deployment(
            mcfg,
            params,
            name="chaos-llm",
            num_replicas=2,
            engine="continuous",
            max_batch=2,
            page_size=8,
            n_pages=64,
            device="cpu",
        )
        serve.run(app)
        router = serve.get_router("chaos-llm")
        assert router.resumable
        payload = {"prompt": prompt, "max_new_tokens": max_new}
        workload = ServeStreamWorkload(
            router, payload, expected, concurrency=2
        )
        workload.start()
        # warm: both replicas up, streams completing
        _wait_for(
            lambda: workload.completed >= 2,
            timeout=180.0,
            msg="warm serve streams",
        )
        assert not workload.verify_failures
        plan = make_plan(
            seed=11, num_faults=2, mix=SERVE_MIX, allow=("replica_kill",),
            min_delay_s=0.5, max_delay_s=1.0,
        )
        assert plan.counts() == {"replica_kill": 2}
        chaos_wl = ChaosWorkload(rt, payload_bytes=150_000, num_actors=1)
        orch = ChaosOrchestrator(
            cluster,
            chaos_wl,
            plan,
            node_resources={"CPU": 8.0},
            convergence_budget_s=120.0,
            serve_adapter=workload,
        )
        result = orch.run()
        workload.stop()
        assert result.ok, result.summary()
        assert not workload.verify_failures, workload.verify_failures
        assert workload.completed >= 3
        # acceptance: no leaked pins anywhere (SIGKILLed replicas'
        # prefix-cache pins were replayed from their pin logs)
        assert result.arena_zombies_after == 0
    finally:
        if workload is not None:
            workload.stop()
        serve.shutdown()
        set_runtime(None)
        try:
            rt.shutdown()
        finally:
            cluster.shutdown()
