"""Lease-cached direct task dispatch (task leases).

The head grants owners cacheable worker leases per task shape; same-shape
tasks stream caller->worker with no head hop (reference analog: the
raylet's worker leases, local_lease_manager.h + direct task calls).
Covered here: the hot path actually rides leases, the
RAY_TPU_TASK_LEASES=0 kill switch restores per-task head scheduling,
lease loss under chaos (worker kill mid-stream) spills every queued task
back to head scheduling with zero acked-object loss, cancel parity for
lease-queued tasks, and idle-TTL lease return.

Mirror of ``tests/test_task_leases.py`` on the port (``ray_tpu_torch``), the same
cases and assertions.
"""
import os
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.runtime import set_runtime


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's head brings its scheduler up on cuda and raises without it;
    # here its rounds run the same programs on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


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
    rt = cluster.client()
    set_runtime(rt)
    yield rt
    set_runtime(None)
    rt.shutdown()


def _sq(x):
    return x * x


def _wait_for(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise TimeoutError(f"timed out waiting for {msg}")


def test_same_shape_tasks_ride_cached_leases(cluster, client):
    """A warm shape streams caller->worker: cache hits dominate, the
    head's lease table shows active leases, and leases_submitted does
    NOT grow per task (the head schedules grants, not tasks)."""
    f = ray_tpu_torch.remote(_sq).options(num_cpus=0.5, max_retries=0)
    # warm the shape (the first WARMUP submissions miss by design)
    assert ray_tpu_torch.get([f.remote(i) for i in range(4)], timeout=60) == [
        0,
        1,
        4,
        9,
    ]
    _wait_for(
        lambda: any(
            e["state"] == "active"
            for e in cluster.head._task_leases.values()
        ),
        msg="an active task lease",
    )
    submitted_before = cluster.head.metrics["leases_submitted"]
    hits_before = client.metrics["lease_cache_hits"]
    n = 200
    refs = [f.remote(i) for i in range(n)]
    assert ray_tpu_torch.get(refs, timeout=120) == [i * i for i in range(n)]
    hits = client.metrics["lease_cache_hits"] - hits_before
    assert hits > n // 2, f"expected mostly cache hits, got {hits}/{n}"
    # leased tasks never become head-scheduled leases
    assert (
        cluster.head.metrics["leases_submitted"] - submitted_before
        < n // 2
    )
    assert cluster.head.metrics["task_leases_granted"] >= 1
    # observability surfaces know about the dispatch plane
    dispatch = client.query_state("dispatch")
    assert dispatch["granted"] >= 1
    assert isinstance(dispatch["task_leases"], list)


def test_kill_switch_falls_back_to_head_path(cluster, monkeypatch):
    """RAY_TPU_TASK_LEASES=0: every task rides the per-task head path —
    submissions show up as head-scheduled leases again."""
    monkeypatch.setenv("RAY_TPU_TASK_LEASES", "0")
    rt = cluster.client()
    set_runtime(rt)
    try:
        assert rt._lease_mgr is None
        submitted_before = cluster.head.metrics["leases_submitted"]
        f = ray_tpu_torch.remote(_sq).options(num_cpus=0.5, max_retries=0)
        n = 20
        assert ray_tpu_torch.get(
            [f.remote(i) for i in range(n)], timeout=60
        ) == [i * i for i in range(n)]
        assert (
            cluster.head.metrics["leases_submitted"] - submitted_before
            >= n
        )
        assert rt.metrics["lease_cache_hits"] == 0
    finally:
        set_runtime(None)
        rt.shutdown()


def _pid_then_sleep(i, delay):
    import os as _os
    import time as _t

    _t.sleep(delay)
    return (_os.getpid(), i)


def test_lease_loss_spillback_on_worker_kill(cluster, client):
    """Chaos: SIGKILL the leased worker while a stream of tasks is
    queued on it. Every queued task must re-run via head scheduling
    (spillback) with zero acked-object loss — each ref resolves to a
    correct value, some from a different worker process."""
    f = ray_tpu_torch.remote(_pid_then_sleep).options(num_cpus=0.5, max_retries=2)
    # warm the shape so a lease exists, and learn the leased worker's pid
    warm = ray_tpu_torch.get([f.remote(i, 0.0) for i in range(4)], timeout=60)
    _wait_for(
        lambda: any(
            c
            for key, c in client._direct_channels.items()
            if key.startswith("lease:")
        ),
        msg="a cached lease channel",
    )
    # stream slow-ish tasks so a deep window is queued on the lease, then
    # learn the pid of whichever worker serves the stream's head
    n = 30
    refs = [f.remote(i, 0.05) for i in range(n)]
    first_pid, _ = ray_tpu_torch.get(refs[0], timeout=60)
    spill_before = client.metrics["lease_spillbacks"]
    os.kill(first_pid, signal.SIGKILL)
    # zero acked-object loss: every queued task re-executes somewhere
    out = ray_tpu_torch.get(refs, timeout=180)
    assert [i for _, i in out] == list(range(n))
    pids = {pid for pid, _ in out}
    if client.metrics["lease_spillbacks"] > spill_before:
        # the kill landed while tasks were queued on the lease: they
        # spilled to head scheduling and ran on other workers
        assert len(pids) > 1
    # the dead worker's lease is revoked head-side (report or TTL sweep)
    _wait_for(
        lambda: cluster.head.metrics["task_leases_revoked"] >= 1,
        timeout=40.0,
        msg="lease revocation",
    )


def _sleepy(t):
    import time as _t

    _t.sleep(t)
    return t


def test_cancel_lease_queued_task(cluster, client):
    """ray.cancel parity on the lease path: a task queued behind a
    running leased task is recalled before execution and its get()
    raises; the running task is not preempted."""
    f = ray_tpu_torch.remote(_sleepy).options(num_cpus=0.5, max_retries=0)
    ray_tpu_torch.get([f.remote(0.0) for _ in range(3)], timeout=60)  # warm
    _wait_for(
        lambda: any(
            key.startswith("lease:") for key in client._direct_channels
        ),
        msg="a cached lease channel",
    )
    blocker = f.remote(3.0)
    victims = [f.remote(0.0) for _ in range(8)]
    time.sleep(0.3)  # let the window reach the worker's lease FIFO
    cancelled = [v for v in victims if client.cancel_object(v)]
    assert cancelled, "at least one queued leased task should cancel"
    for v in cancelled:
        with pytest.raises(Exception) as ei:
            ray_tpu_torch.get(v, timeout=30)
        assert "cancel" in repr(ei.value).lower()
    # non-cancelled work and the running blocker complete normally
    assert ray_tpu_torch.get(blocker, timeout=60) == 3.0
    for v in victims:
        if v not in cancelled:
            assert ray_tpu_torch.get(v, timeout=60) == 0.0


def test_force_cancel_running_leased_task(cluster, client):
    """force=True on a RUNNING leased task kills its worker (the head's
    force semantics): the get() raises cancelled, and the shape keeps
    working afterwards (worker respawned, lease re-granted or head
    path)."""
    f = ray_tpu_torch.remote(_sleepy).options(num_cpus=0.5, max_retries=0)
    ray_tpu_torch.get([f.remote(0.0) for _ in range(3)], timeout=60)  # warm
    _wait_for(
        lambda: any(
            key.startswith("lease:") for key in client._direct_channels
        ),
        msg="a cached lease channel",
    )
    victim = f.remote(30.0)
    deadline = time.monotonic() + 10
    cancelled = False
    while time.monotonic() < deadline and not cancelled:
        time.sleep(0.2)  # wait until it is actually executing
        cancelled = client.cancel_object(victim, force=True)
    assert cancelled, "force-cancel of a running leased task"
    with pytest.raises(Exception) as ei:
        ray_tpu_torch.get(victim, timeout=30)
    assert "cancel" in repr(ei.value).lower()
    # the shape still works after the kill
    assert ray_tpu_torch.get([f.remote(0.0) for _ in range(4)], timeout=120) == [
        0.0
    ] * 4


def test_idle_lease_returns_to_pool(cluster, monkeypatch):
    """Queue drain + idle TTL: the owner hands the lease back and the
    head's table empties (the worker is back in its agent's pool)."""
    monkeypatch.setenv("RAY_TPU_TASK_LEASE_TTL_S", "1.0")
    rt = cluster.client()
    set_runtime(rt)
    try:
        returned_before = cluster.head.metrics["task_leases_returned"]
        f = ray_tpu_torch.remote(_sq).options(num_cpus=0.5, max_retries=3)
        assert ray_tpu_torch.get(
            [f.remote(i) for i in range(6)], timeout=60
        ) == [i * i for i in range(6)]
        # keep submitting until the grant lands (the cluster may be busy
        # respawning workers from earlier tests)
        def _owner_lease_active():
            return any(
                e.get("client_id") == rt.client_id
                and e["state"] == "active"
                for e in cluster.head._task_leases.values()
            )

        deadline = time.monotonic() + 30.0
        while not _owner_lease_active():
            assert time.monotonic() < deadline, "no lease ever granted"
            assert ray_tpu_torch.get(f.remote(2), timeout=60) == 4
            time.sleep(0.2)
        _wait_for(
            lambda: not any(
                e.get("client_id") == rt.client_id
                for e in cluster.head._task_leases.values()
            ),
            timeout=30.0,
            msg="idle lease return",
        )
        assert (
            cluster.head.metrics["task_leases_returned"] > returned_before
        )
    finally:
        set_runtime(None)
        rt.shutdown()


def _big_payload(i, n):
    return bytes([i % 251]) * n


def test_owner_lineage_rebuilds_lost_leased_object(cluster, client):
    """Leased direct-dispatch tasks never register a spec with the head —
    the OWNER is their lineage. When every copy of such an object dies
    and the head seals it ObjectLostError (no head-side lineage), the
    owner's get transparently resubmits the retained task item through
    head scheduling and returns the rebuilt value; the resubmitted lease
    ALSO registers head-side lineage for any future loss."""
    task = ray_tpu_torch.remote(_big_payload)
    refs = []
    # waves keep the queue deep so the shape turns hot and leases carry
    # the traffic (payload > inline_object_max: store-resident, droppable)
    for wave in range(6):
        batch = [
            task.options(max_retries=3).remote(wave * 8 + k, 150_000)
            for k in range(8)
        ]
        refs.extend(batch)
        for r in batch:
            ray_tpu_torch.get(r, timeout=60)
    head = cluster.head
    naked = []
    with head._lock:
        for i, r in enumerate(refs):
            e = head._objects.get(r.hex)
            if e is not None and e.creating_lease is None and e.locations:
                naked.append((i, r))
    assert naked, "no lease-dispatched store-resident objects this run"
    idx, victim = naked[-1]
    before = client.metrics["lineage_resubmits"]
    assert head.chaos_drop_objects([victim.hex]) == 1
    # the owner-held direct copy (when present) would serve the get
    # locally; the loss path under test is the head-reported one
    with client._direct_cv:
        client._direct_results.pop(victim.hex, None)
    assert ray_tpu_torch.get(victim, timeout=60) == bytes([idx % 251]) * 150_000
    assert client.metrics["lineage_resubmits"] == before + 1
    with head._lock:
        e = head._objects.get(victim.hex)
        assert e is not None and e.creating_lease is not None, (
            "resubmission should register head-side lineage"
        )
