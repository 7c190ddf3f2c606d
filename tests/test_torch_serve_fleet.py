"""The router fleet on the port: ``tests/test_router_fleet.py``'s fast
cases on ``ray_tpu_torch`` (consistent-hash tenant assignment,
head-reconciled admission shards, epoch-fenced stream leases, token-exact
cross-router stream failover), plus ``HashRing`` and
``compute_budget_shares`` held equal to the JAX package's for the same
inputs; and its slow case, a router kill mid-stream under the port's
chaos orchestrator (``ray_tpu_torch.chaos``).
"""
import threading
import time

import pytest

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
# consistent-hash ring (pure units)
# ---------------------------------------------------------------------------
def test_hash_ring_deterministic_across_instances():
    from ray_tpu_torch.serve.fleet import HashRing

    members = ["d/r0", "d/r1", "d/r2"]
    a = HashRing(members)
    b = HashRing(list(reversed(members)))  # order-insensitive
    for i in range(200):
        key = f"tenant-{i}"
        assert a.owner(key) == b.owner(key)
    # every member owns some range
    owners = {a.owner(f"tenant-{i}") for i in range(200)}
    assert owners == set(members)


def test_hash_ring_minimal_motion_on_member_removal():
    """Removing one member moves ONLY its keys: survivors keep every
    assignment they had (the consistent-hash contract the token-exact
    failover leans on)."""
    from ray_tpu_torch.serve.fleet import HashRing

    full = HashRing(["d/r0", "d/r1", "d/r2"])
    small = HashRing(["d/r0", "d/r2"])
    for i in range(300):
        key = f"tenant-{i}"
        before = full.owner(key)
        after = small.owner(key)
        if before != "d/r1":
            assert after == before, f"{key} moved off a surviving router"
        else:
            assert after in ("d/r0", "d/r2")


# ---------------------------------------------------------------------------
# global budget arithmetic (pure units)
# ---------------------------------------------------------------------------
def test_budget_shares_split_by_active_tenant_weights():
    from ray_tpu_torch.serve.fleet import compute_budget_shares

    reports = {
        "r0": {"usage": {"gold": 5}, "waiting": {}, "weights": {"gold": 3.0}},
        "r1": {"usage": {"bronze": 5}, "waiting": {}, "weights": {}},
    }
    shares = compute_budget_shares(reports, qps=100.0, burst=20.0, window_s=0.25)
    assert shares["r0"]["rate"] == pytest.approx(75.0)
    assert shares["r1"]["rate"] == pytest.approx(25.0)
    # parked demand counts as active too (a starved tenant still earns
    # its share before it ever admits)
    reports["r1"]["usage"] = {}
    reports["r1"]["waiting"] = {"bronze": 3}
    shares = compute_budget_shares(reports, qps=100.0, burst=20.0, window_s=0.25)
    assert shares["r1"]["rate"] == pytest.approx(25.0)


def test_budget_shares_idle_even_split_floor_and_unlimited():
    from ray_tpu_torch.serve.fleet import compute_budget_shares

    idle = {
        "r0": {"usage": {}, "waiting": {}, "weights": {}},
        "r1": {"usage": {}, "waiting": {}, "weights": {}},
    }
    shares = compute_budget_shares(idle, qps=100.0, burst=20.0, window_s=0.25)
    assert shares["r0"]["rate"] == pytest.approx(50.0)
    assert shares["r1"]["rate"] == pytest.approx(50.0)
    # a router with no active tenants keeps the 2% floor when others are
    # busy — a cold tenant's first burst is not starved for a window
    mixed = {
        "r0": {"usage": {"a": 9}, "waiting": {}, "weights": {}},
        "r1": {"usage": {}, "waiting": {}, "weights": {}},
    }
    shares = compute_budget_shares(mixed, qps=100.0, burst=20.0, window_s=0.25)
    assert shares["r1"]["rate"] == pytest.approx(2.0)
    # qps<=0 = unlimited stays unlimited per shard
    shares = compute_budget_shares(mixed, qps=0.0, burst=20.0, window_s=0.25)
    assert shares["r0"]["rate"] == 0.0 and shares["r0"]["headroom"]


def test_budget_headroom_tracks_cluster_usage():
    from ray_tpu_torch.serve.fleet import compute_budget_shares

    # window budget = 100 qps * 0.25 s = 25 admits; 95% cut-off
    low = {"r0": {"usage": {"a": 5}, "waiting": {}, "weights": {}}}
    hot = {"r0": {"usage": {"a": 30}, "waiting": {}, "weights": {}}}
    assert compute_budget_shares(low, 100.0, 20.0, 0.25)["r0"]["headroom"]
    assert not compute_budget_shares(hot, 100.0, 20.0, 0.25)["r0"]["headroom"]


def test_shed_retry_hint_uses_reconcile_window_under_global_headroom():
    """Satellite: when the LOCAL shard's bucket is dry but the head says
    the GLOBAL budget has headroom, the Overloaded retry hint is one
    reconcile window — not the local bucket's misleadingly long refill
    time."""
    from ray_tpu_torch.serve.admission import AdmissionController, Overloaded

    ctl = AdmissionController(qps=0.01, burst=1.0, wait_cap=0)
    ctl.admit().done()  # drains the single burst token
    with pytest.raises(Overloaded) as ei:
        ctl.admit()
    # no budget word yet: the hint is the (huge) local refill time
    assert ei.value.retry_after_s > 10.0
    ctl.note_global_budget(True, 0.15)
    with pytest.raises(Overloaded) as ei:
        ctl.admit()
    assert ei.value.retry_after_s == pytest.approx(0.15)
    # headroom withdrawn: back to the honest local refill time
    ctl.note_global_budget(False, 0.15)
    with pytest.raises(Overloaded) as ei:
        ctl.admit()
    assert ei.value.retry_after_s > 10.0


# ---------------------------------------------------------------------------
# local coordinator: epoch fencing + stream leases (pure units)
# ---------------------------------------------------------------------------
def test_local_coordinator_epoch_fencing_and_lease_protocol():
    from ray_tpu_torch.serve.fleet import (
        RouterDeposedError,
        _LocalFleetCoordinator,
    )

    coord = _LocalFleetCoordinator()
    assert coord.join("d", "d/r0")["epoch"] == 1
    view = coord.join("d", "d/r1")
    assert view["epoch"] == 2 and view["members"] == ["d/r0", "d/r1"]
    coord.join("d", "d/r1")  # idempotent: no epoch bump
    assert coord.assignment("d")["epoch"] == 2

    row = coord.stream_acquire("d", "d/r0", 2, "s1", "gold", 0)
    assert row["delivered"] == 0 and row["router_id"] == "d/r0"
    coord.stream_ckpt("d", "d/r0", 2, {"s1": 7})
    assert coord.stream_lookup("s1")["delivered"] == 7
    # a sibling's checkpoint for a stream it does not own is dropped
    coord.stream_ckpt("d", "d/r1", 2, {"s1": 99})
    assert coord.stream_lookup("s1")["delivered"] == 7
    # delivered is monotone across re-acquires
    row = coord.stream_acquire("d", "d/r1", 2, "s1", "gold", 3)
    assert row["delivered"] == 7 and row["router_id"] == "d/r1"

    # stale epoch -> typed fence carrying the current epoch
    with pytest.raises(RouterDeposedError) as ei:
        coord.stream_acquire("d", "d/r0", 1, "s2", "t", 0)
    assert ei.value.current_epoch == 2
    coord.leave("d", "d/r0")
    assert coord.assignment("d")["epoch"] == 3
    with pytest.raises(RouterDeposedError):
        coord.stream_ckpt("d", "d/r1", 2, {"s1": 8})

    coord.stream_release(["s1"])
    assert coord.stream_lookup("s1") is None


def test_stream_sink_depose_redirects_pushes_and_fails_streams():
    """Satellite: a deposed router's sink answers pushes with a TYPED
    redirect (never a silent accept into a buffer nobody reads), and its
    registered streams end with RouterKilled — but buffered acked deltas
    drain first (the failover resume point must count them)."""
    from ray_tpu_torch.serve.router import RouterKilled, StreamSink

    sink = StreamSink(router_id="d/r0")
    try:
        sid, stream = sink.open()
        sink._h_push({"stream_id": sid, "seq": 0, "items": ["tok0"]})
        sink.depose(epoch=5)
        reply = sink._h_push({"stream_id": sid, "seq": 1, "items": ["x"]})
        assert reply["redirect"] is True and reply["epoch"] == 5
        assert reply["cancelled"] is True
        # the buffered delta was acked to the writer: still readable
        assert stream.read(timeout=1.0) == "tok0"
        with pytest.raises(RouterKilled):
            stream.read(timeout=1.0)
    finally:
        sink.stop()


# ---------------------------------------------------------------------------
# off-cluster fleet (stub replica set + local coordinator)
# ---------------------------------------------------------------------------
class _StubDep:
    def __init__(self, name, resumable=False, weights=None):
        self.name = name
        self.resumable_streams = resumable
        self.tenant_weights = dict(weights or {})


class _StubReplicaSet:
    def __init__(self, name, resumable=False, weights=None):
        self.dep = _StubDep(name, resumable, weights)
        self.lock = threading.Lock()
        self.replicas = []
        self.target = 1


class _StubRoutedStream:
    def __init__(self, router, start):
        self._router = router
        self._idx = start

    def read(self, timeout=None):
        from ray_tpu_torch.serve.router import ChannelClosed, RouterKilled

        r = self._router
        if r.killed:
            raise RouterKilled(f"router {r.router_id} killed mid-stream")
        if r.fail_at is not None and self._idx >= r.fail_at:
            raise RouterKilled(f"router {r.router_id} died")
        if self._idx >= r.total:
            raise ChannelClosed("stream ended")
        value = f"tok{self._idx}"
        self._idx += 1
        return value

    def close(self):
        pass


class _StubRouter:
    """Router-protocol stub: deterministic token source that can be told
    to die mid-stream, recording every resume_base it is dispatched
    with."""

    def __init__(self, rid, total=10, fail_at=None):
        self.router_id = rid
        self.total = total
        self.fail_at = fail_at
        self.killed = False
        self.resume_bases = []

    def stream(self, payload, tenant, resume_base=0):
        self.resume_bases.append(int(resume_base))
        return _StubRoutedStream(self, int(resume_base))

    def chaos_kill(self):
        self.killed = True

    def depose(self, epoch):
        self.killed = True

    def close(self):
        pass


def _make_fleet(monkeypatch, name, n, resumable=False, weights=None, **env):
    from ray_tpu_torch.serve.fleet import RouterFleet, _LocalFleetCoordinator

    for key, value in env.items():
        monkeypatch.setenv(key, value)
    fleet = RouterFleet(
        _StubReplicaSet(name, resumable, weights),
        num_routers=n,
        coordinator=_LocalFleetCoordinator(),
    )
    return fleet


def test_fleet_assignment_and_stable_routing(monkeypatch):
    fleet = _make_fleet(
        monkeypatch, "asn", 3, RAY_TPU_SERVE_BUDGET_RECONCILE_S="30"
    )
    try:
        view = fleet.assignment()
        assert view["epoch"] == 3  # three joins
        assert view["members"] == ["asn/r0", "asn/r1", "asn/r2"]
        owners = {fleet.router_for(f"t{i}") for i in range(100)}
        assert owners == set(view["members"])
        assert fleet.router_for("t7") == fleet.router_for("t7")
    finally:
        fleet.close()


def test_fleet_kill_reassigns_fences_and_refuses_lone_router(monkeypatch):
    from ray_tpu_torch.serve.fleet import RouterDeposedError

    fleet = _make_fleet(
        monkeypatch, "fence", 2, RAY_TPU_SERVE_BUDGET_RECONCILE_S="30"
    )
    try:
        victim = fleet.router_for("tenant-a")
        assert fleet.chaos_kill_router(rid=victim) == victim
        sibling = ({"fence/r0", "fence/r1"} - {victim}).pop()
        view = fleet.assignment()
        assert view["epoch"] == 3  # two joins + one leave
        assert view["members"] == [sibling]
        assert fleet.is_dead(victim)
        # every tenant now lands on the survivor
        assert all(
            fleet.router_for(f"t{i}") == sibling for i in range(50)
        )
        # the corpse's late control traffic is fenced with the current
        # epoch
        with pytest.raises(RouterDeposedError) as ei:
            fleet._coord.stream_acquire("fence", victim, 2, "sX", "t", 0)
        assert ei.value.current_epoch == 3
        # killing the last router would be an outage, not a failover test
        assert fleet.chaos_kill_router() is None
    finally:
        fleet.close()


def test_stream_failing_over_during_a_kill_is_routed_to_the_sibling(monkeypatch):
    """A killed router's streams fail over while the kill is still
    running (its push endpoint closes before the assignment table hears
    of the leave). The ring must already have dropped the router then:
    the reference rebuilt it only after the leave, so a stream failing
    over in that window met a KeyError in ``_owner`` and ended in an error
    instead of resuming (Queue C 17)."""
    fleet = _make_fleet(
        monkeypatch, "race", 2, RAY_TPU_SERVE_BUDGET_RECONCILE_S="30"
    )
    try:
        victim = fleet.router_for("tenant-a")
        sibling = ({"race/r0", "race/r1"} - {victim}).pop()
        router = fleet.routers[victim]
        kill = router.chaos_kill
        seen = []

        def chaos_kill():
            # what a failing-over stream's thread asks while the kill runs
            seen.append(fleet._owner("tenant-a")[0])
            kill()

        router.chaos_kill = chaos_kill
        assert fleet.chaos_kill_router(rid=victim) == victim
        assert seen == [sibling]
    finally:
        fleet.close()


def test_fleet_stream_failover_token_exact_with_skip_window(monkeypatch):
    """The tentpole promise, hermetically: the owning router dies after
    5 delivered tokens with the replicated checkpoint at 3. The sibling
    re-dispatches from the CHECKPOINT (resume_from=3 — all a sibling
    with no sight of this consumer could know) and the consumer-side
    skip window discards the 2-token overlap: the stitched sequence is
    exact, nothing duplicated, nothing dropped."""
    fleet = _make_fleet(
        monkeypatch,
        "ftok",
        2,
        resumable=True,
        RAY_TPU_SERVE_BUDGET_RECONCILE_S="30",
        RAY_TPU_SERVE_STREAM_CKPT_EVERY="1",
    )
    try:
        tenant = next(
            f"t{i}"
            for i in range(100)
            if fleet.router_for(f"t{i}") == "ftok/r0"
        )
        stubs = {
            "ftok/r0": _StubRouter("ftok/r0", total=10, fail_at=5),
            "ftok/r1": _StubRouter("ftok/r1", total=10),
        }
        with fleet._lock:
            fleet.routers.update(stubs)

        stream = fleet.stream({"n": 10}, tenant)
        got = [stream.read(timeout=5) for _ in range(3)]
        fleet._flush_ckpts()  # replicated checkpoint: delivered=3
        assert fleet._coord.stream_lookup(stream.stream_id)["delivered"] == 3
        got += [stream.read(timeout=5) for _ in range(2)]  # delivered=5
        # next read hits the corpse -> cross-router failover
        got += list(stream)
        assert got == [f"tok{i}" for i in range(10)]
        assert stream.router_failovers == 1
        assert stubs["ftok/r0"].killed and fleet.is_dead("ftok/r0")
        # the sibling was dispatched from the checkpoint, not from the
        # consumer's acked count — the skip window bridged the gap
        assert stubs["ftok/r1"].resume_bases == [3]
        assert fleet.assignment()["epoch"] == 3
        # end-of-stream released the lease row
        assert fleet._coord.stream_lookup(stream.stream_id) is None
    finally:
        fleet.close()


class _SheddingRouter(_StubRouter):
    """A router whose admission sheds every request."""

    def stream(self, payload, tenant, resume_base=0):
        from ray_tpu_torch.serve.admission import Overloaded

        raise Overloaded("queue_full")


def test_a_shed_stream_takes_no_lease(monkeypatch):
    """Queue C 25: a stream lease is taken after admission, so a request
    the router sheds never reaches the head (the reference leases first:
    under 2x overload every shed request cost the in-process head an
    acquire and a release). An admitted stream still takes its lease and
    releases it at its end."""
    from ray_tpu_torch.serve.admission import Overloaded

    fleet = _make_fleet(monkeypatch, "shed", 1, resumable=True,
                        RAY_TPU_SERVE_BUDGET_RECONCILE_S="30")
    try:
        calls = []
        coord = fleet._coord
        acquire, release = coord.stream_acquire, coord.stream_release

        def counted_acquire(*args, **kwargs):
            calls.append("acquire")
            return acquire(*args, **kwargs)

        def counted_release(ids):
            calls.append("release")
            return release(ids)

        monkeypatch.setattr(coord, "stream_acquire", counted_acquire)
        monkeypatch.setattr(coord, "stream_release", counted_release)
        with fleet._lock:
            fleet.routers["shed/r0"] = _SheddingRouter("shed/r0")
        for _ in range(5):
            with pytest.raises(Overloaded):
                fleet.stream({"n": 3}, "t")
        assert calls == [] and fleet._streams == {}
        with fleet._lock:
            fleet.routers["shed/r0"] = _StubRouter("shed/r0", total=3)
        stream = fleet.stream({"n": 3}, "t")
        assert fleet._coord.stream_lookup(stream.stream_id) is not None
        assert list(stream) == ["tok0", "tok1", "tok2"]
        assert calls == ["acquire", "release"]
        assert fleet._coord.stream_lookup(stream.stream_id) is None
    finally:
        fleet.close()


def test_fleet_cross_router_wfq_ratio(monkeypatch):
    """Cluster-wide weighted fairness: a weight-3 tenant and a weight-1
    tenant pinned to DIFFERENT routers drain ~3:1 once the reconcile
    loop re-splits the global admission rate by active tenant weights —
    WFQ is a fleet invariant, not a per-process accident."""
    from ray_tpu_torch.serve.admission import Overloaded

    fleet = _make_fleet(
        monkeypatch,
        "wfq",
        2,
        RAY_TPU_SERVE_ADMISSION_QPS="60",
        RAY_TPU_SERVE_ADMISSION_BURST="4",
        RAY_TPU_SERVE_BUDGET_RECONCILE_S="0.1",
    )
    try:
        tenants = [f"t{i}" for i in range(200)]
        gold = next(t for t in tenants if fleet.router_for(t) == "wfq/r0")
        bronze = next(t for t in tenants if fleet.router_for(t) == "wfq/r1")
        fleet._weights = {gold: 3.0, bronze: 1.0}

        counts = {gold: 0, bronze: 0}
        measuring = threading.Event()
        stop = threading.Event()
        lock = threading.Lock()

        def hammer(tenant):
            while not stop.is_set():
                try:
                    ticket = fleet.admission.admit(tenant, timeout_s=0.05)
                    ticket.done()
                    if measuring.is_set():
                        with lock:
                            counts[tenant] += 1
                except Overloaded as exc:
                    time.sleep(min(0.02, exc.retry_after_s))

        threads = [
            threading.Thread(target=hammer, args=(t,), daemon=True)
            for t in (gold, bronze)
        ]
        for t in threads:
            t.start()
        time.sleep(0.8)  # several reconcile windows: shares converged
        with lock:
            counts = {gold: 0, bronze: 0}
        measuring.set()
        time.sleep(3.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        with lock:
            g, b = counts[gold], counts[bronze]
        assert b > 0, "bronze starved entirely"
        ratio = g / b
        assert 2.5 <= ratio <= 3.5, (
            f"cross-router WFQ ratio {ratio:.2f} (gold={g} bronze={b}), "
            f"expected ~3.0"
        )
    finally:
        fleet.close()


def test_fleet_duck_types_single_router_surface(monkeypatch):
    """Back-compat: with serve_routers=1 the fleet IS the old layout —
    admission passthrough + setter, stats() shape, _rs property."""
    from ray_tpu_torch.serve.admission import AdmissionController

    fleet = _make_fleet(
        monkeypatch, "duck", 1, RAY_TPU_SERVE_BUDGET_RECONCILE_S="30"
    )
    try:
        assert fleet.chaos_kill_router() is None
        only = fleet.live_routers()[0][1]
        assert fleet.admission is only.admission
        override = AdmissionController(max_inflight=1, wait_cap=0)
        fleet.admission = override
        assert fleet.admission is override and only.admission is override
        stats = fleet.stats()
        assert stats["deployment"] == "duck"
        assert "codes" in stats and "replicas" in stats
        assert stats["fleet"]["members"] == ["duck/r0"]
        assert stats["fleet"]["epoch"] == 1
        assert "duck/r0" in stats["fleet"]["routers"]
        assert fleet._rs.dep.name == "duck"
    finally:
        fleet.close()


def test_fleet_multi_router_admission_aggregates_shards(monkeypatch):
    fleet = _make_fleet(
        monkeypatch, "agg", 2, RAY_TPU_SERVE_BUDGET_RECONCILE_S="30"
    )
    try:
        tenants = [f"t{i}" for i in range(50)]
        spread = {fleet.router_for(t) for t in tenants}
        assert spread == {"agg/r0", "agg/r1"}
        for t in tenants[:10]:
            fleet.admission.admit(t).done()
        stats = fleet.admission.stats()
        assert stats["admitted"] == 10
        assert set(stats["shards"]) == {"agg/r0", "agg/r1"}
        assert (
            sum(s["admitted"] for s in stats["shards"].values()) == 10
        )
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# head: WAL-persisted assignment + stream-lease tables
# ---------------------------------------------------------------------------
def test_head_fleet_and_stream_tables_survive_hard_crash(
    tmp_path, monkeypatch
):
    from ray_tpu_torch.cluster.head import HeadServer

    monkeypatch.setattr(HeadServer, "_persist_loop", lambda self: None)
    path = str(tmp_path / "state.pkl")
    h1 = HeadServer(port=0, persist_path=path, use_device_scheduler=False)
    assert h1._h_serve_fleet_join(
        {"deployment": "d", "router_id": "d/r0"}
    )["epoch"] == 1
    assert h1._h_serve_fleet_join(
        {"deployment": "d", "router_id": "d/r1"}
    )["epoch"] == 2
    reply = h1._h_serve_stream_acquire(
        {
            "deployment": "d",
            "router_id": "d/r0",
            "epoch": 2,
            "stream_id": "s1",
            "tenant": "gold",
            "delivered": 0,
        }
    )
    assert reply["row"]["delivered"] == 0
    assert h1._h_serve_stream_ckpt(
        {
            "deployment": "d",
            "router_id": "d/r0",
            "epoch": 2,
            "ckpts": {"s1": 7},
        }
    )["applied"] == 1
    # stale-epoch control traffic gets the typed stale reply
    stale = h1._h_serve_stream_acquire(
        {
            "deployment": "d",
            "router_id": "d/r0",
            "epoch": 1,
            "stream_id": "s2",
            "tenant": "t",
            "delivered": 0,
        }
    )
    assert stale.get("stale") is True and stale["epoch"] == 2
    # budget reply carries the share + the reconcile window
    budget = h1._h_serve_budget(
        {
            "deployment": "d",
            "router_id": "d/r0",
            "epoch": 2,
            "usage": {"gold": 3},
            "waiting": {},
            "weights": {"gold": 3.0},
        }
    )
    assert {"rate", "burst", "headroom", "window_s"} <= set(budget)
    # hard crash: no snapshot flush, only the WAL
    h1._server.stop()
    h1._shutdown = True

    h2 = HeadServer(port=0, persist_path=path, use_device_scheduler=False)
    try:
        f = h2._serve_fleets["d"]
        assert f["epoch"] == 2 and f["members"] == ["d/r0", "d/r1"]
        row = h2._serve_streams.get("s1")
        assert row is not None and row["delivered"] == 7
        assert row["router_id"] == "d/r0" and row["tenant"] == "gold"
        # released rows stay gone across the next crash
        assert h2._h_serve_stream_release({"stream_ids": ["s1"]})[
            "dropped"
        ] == 1
    finally:
        h2._server.stop()
        h2._shutdown = True

    h3 = HeadServer(port=0, persist_path=path, use_device_scheduler=False)
    try:
        assert h3._serve_streams.get("s1") is None
        assert h3._serve_fleets["d"]["epoch"] == 2
    finally:
        h3._server.stop()
        h3._shutdown = True


def test_stream_lease_wal_records_shard_by_stream_id():
    """Replication layer: stream-lease records route to the owner shard
    by stream_id (the same sharding the standby's tables use), and
    fleet-membership records stay unsharded."""
    from ray_tpu_torch.cluster.standby import record_shard_key

    row = {"stream_id": "abc123", "deployment": "d", "delivered": 4}
    assert record_shard_key(("serve_stream", row)) == "abc123"
    assert (
        record_shard_key(
            ("serve_stream_ckpt", {"stream_id": "abc123", "delivered": 9})
        )
        == "abc123"
    )
    assert record_shard_key(("serve_stream_gone", "abc123")) == "abc123"
    assert (
        record_shard_key(
            ("serve_fleet", {"deployment": "d", "epoch": 1, "members": []})
        )
        is None
    )


# ---------------------------------------------------------------------------
# live cluster: cross-router token-exact failover + QueryState surface
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


class _FleetTokenServer:
    """Resumable deterministic token source: honors resume_from so a
    failed-over dispatch continues instead of restarting."""

    def stream_to(self, writer, request):
        from ray_tpu_torch.experimental import ChannelClosed

        n = int(request.get("n", 20))
        delay = float(request.get("delay_s", 0.02))
        try:
            for i in range(int(request.get("resume_from", 0)), n):
                writer.write(f"tok{i}")
                if delay:
                    time.sleep(delay)
            writer.close_channel()
        except ChannelClosed:
            pass  # consumer cancelled / sink redirected: stop generating

    def pid(self):
        import os

        return os.getpid()


def test_cluster_cross_router_failover_token_exact(
    cluster, client, monkeypatch
):
    """Two routers, streams on tenants owned by each; kill the router
    owning one mid-stream. Its stream resumes on the sibling with zero
    duplicated/dropped acked tokens; the other stream is untouched; the
    head's published assignment drops the corpse at a bumped epoch."""
    import ray_tpu_torch.serve as serve

    monkeypatch.setenv("RAY_TPU_SERVE_ROUTERS", "2")
    # force the push transport: a router kill severs push-sink streams;
    # same-host shm rings would ride out the death
    monkeypatch.setenv("RAY_TPU_SERVE_SHM_STREAMS", "0")
    app = serve.deployment(
        name="fleetok", num_replicas=2, resumable_streams=True
    )(_FleetTokenServer).bind()
    serve.run(app)
    fleet = serve.get_router("fleetok")
    assert fleet.resumable and len(fleet.routers) == 2
    tenants = [f"t{i}" for i in range(100)]
    ta = next(t for t in tenants if fleet.router_for(t) == "fleetok/r0")
    tb = next(t for t in tenants if fleet.router_for(t) == "fleetok/r1")
    payload = {"n": 30, "delay_s": 0.05}
    sa = fleet.stream(payload, ta)
    sb = fleet.stream(payload, tb)
    got_a = [sa.read(timeout=30) for _ in range(3)]
    got_b = [sb.read(timeout=30) for _ in range(3)]
    victim = sa._rid
    assert fleet.chaos_kill_router(rid=victim) == victim
    got_a += list(sa)
    got_b += list(sb)
    expected = [f"tok{i}" for i in range(30)]
    assert got_a == expected, "failed-over stream not token-exact"
    assert got_b == expected, "sibling-owned stream disturbed"
    assert sa.router_failovers >= 1
    assert sb.router_failovers == 0
    assert fleet.is_dead(victim)
    view = fleet.assignment()
    assert victim not in view["members"] and view["epoch"] >= 3
    # the head publishes the fleet through QueryState("serve")
    state = client.query_state("serve")
    fleets = (state or {}).get("fleets") or {}
    assert "fleetok" in fleets
    assert victim not in fleets["fleetok"]["members"]
    assert fleets["fleetok"]["epoch"] >= 3
    assert "stream_leases" in state


class _EchoForFleet:
    def __call__(self, payload):
        return payload


def test_cluster_fleet_unary_and_stats_surface(cluster, client, monkeypatch):
    """Unary requests route through the fleet unchanged and the merged
    stats blob keeps the single-router shape plus the fleet block."""
    import ray_tpu_torch.serve as serve

    monkeypatch.setenv("RAY_TPU_SERVE_ROUTERS", "2")

    app = serve.deployment(name="fleetecho", num_replicas=2)(
        _EchoForFleet
    ).bind()
    serve.run(app)
    fleet = serve.get_router("fleetecho")
    for i in range(8):
        assert fleet.call({"i": i}, tenant=f"t{i}", timeout=60)["i"] == i
    stats = fleet.stats()
    assert stats["codes"].get("200", 0) >= 8
    assert stats["fleet"]["epoch"] == 2
    assert len(stats["fleet"]["routers"]) == 2
    assert stats["admission"]["admitted"] >= 8


# ---------------------------------------------------------------------------
# slow tier: router_kill faults under the chaos orchestrator
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_router_kill_streams_resume_cross_router(monkeypatch):
    """Open-loop verified token streams across a 2-router fleet + a
    router_kill fault: every stream in flight on the corpse completes
    token-exact on the sibling (the cross-router resume invariant),
    fresh streams keep completing, and no arena pins leak."""
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.chaos import (
        ROUTER_MIX,
        ChaosOrchestrator,
        ChaosWorkload,
        ServeStreamWorkload,
        make_plan,
    )
    from ray_tpu_torch.cluster import Cluster

    monkeypatch.setenv("RAY_TPU_SERVE_ROUTERS", "2")
    monkeypatch.setenv("RAY_TPU_SERVE_SHM_STREAMS", "0")
    n_tokens = 12
    expected = [f"tok{i}" for i in range(n_tokens)]
    cluster = Cluster(use_device_scheduler=False)
    cluster.add_node({"CPU": 8.0}, num_workers=3)
    cluster.add_node({"CPU": 8.0}, num_workers=3)
    rt = cluster.client()
    set_runtime(rt)
    workload = None
    try:
        app = serve.deployment(
            name="chaos-fleet", num_replicas=2, resumable_streams=True
        )(_FleetTokenServer).bind()
        serve.run(app)
        fleet = serve.get_router("chaos-fleet")
        assert fleet.resumable and len(fleet.routers) == 2
        payload = {"n": n_tokens, "delay_s": 0.05}
        workload = ServeStreamWorkload(
            fleet,
            payload,
            expected,
            concurrency=4,
            tenants=[f"t{i}" for i in range(4)],
        )
        workload.start()
        _wait_for(
            lambda: workload.completed >= 4,
            timeout=120.0,
            msg="warm fleet streams",
        )
        assert not workload.verify_failures
        plan = make_plan(
            seed=7,
            num_faults=1,
            mix=ROUTER_MIX,
            allow=("router_kill",),
            min_delay_s=0.5,
            max_delay_s=1.0,
        )
        assert plan.counts() == {"router_kill": 1}
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
        assert workload.routers_killed == 1
        outcomes = workload.watched_outcomes()
        assert outcomes, "router_kill landed on no in-flight streams"
        assert all(v == "ok" for v in outcomes.values()), outcomes
        assert workload.routers_live() == 1
        # acceptance: zero leaked arena pins after the fault
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


# ---------------------------------------------------------------------------
# the same inputs through both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("members", [["d/r0"], ["d/r0", "d/r1"], ["a", "b", "c", "d", "e"]])
def test_hash_ring_assignment_equals_the_reference(members):
    from ray_tpu.serve.fleet import HashRing as JHashRing

    from ray_tpu_torch.serve.fleet import HashRing

    keys = [f"tenant{i}" for i in range(500)] + ["", "default", "ü"]
    ring, ref = HashRing(members), JHashRing(members)
    assert [ring.owner(k) for k in keys] == [ref.owner(k) for k in keys]


def test_budget_shares_equal_the_reference():
    import numpy as np
    from ray_tpu.serve.fleet import compute_budget_shares as j_shares

    from ray_tpu_torch.serve.fleet import compute_budget_shares

    rng = np.random.default_rng(7)
    for trial in range(20):
        reports = {}
        for r in range(int(rng.integers(1, 5))):
            tenants = [f"t{i}" for i in range(int(rng.integers(0, 6)))]
            reports[f"r{r}"] = {
                "usage": {t: float(rng.integers(0, 20)) for t in tenants},
                "waiting": {t: int(rng.integers(0, 4)) for t in tenants},
                "weights": {t: float(rng.choice([1.0, 2.0, 3.0])) for t in tenants},
            }
        rate = float(rng.choice([0.0, 10.0, 250.0]))
        args = (reports, rate, 20.0, float(rng.choice([0.1, 0.5])))
        assert compute_budget_shares(*args) == j_shares(*args), trial
