"""Head (GCS) fault tolerance: restart the head, keep the cluster.

Reference behavior: with Redis persistence the GCS can restart and raylets
resubscribe/replay (store_client/redis_store_client.cc, gcs_init_data.cc).
Here: the head persists its durable tables (KV, actor directory, jobs) to a
pickle snapshot; on restart, agents get told they're unknown, re-register
with the actors their workers still host, and named actors re-attach with
their in-memory state intact.

Mirror of ``tests/test_head_recovery.py`` on the port (``ray_tpu_torch``), the same
cases and assertions.
"""
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.runtime import set_runtime


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's head brings its scheduler up on cuda and raises without it;
    # here its rounds run the same programs on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


class Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n


def test_wal_survives_crash_between_snapshots(tmp_path, monkeypatch):
    """Registrations landing BETWEEN snapshot ticks are write-ahead
    logged: a hard crash (no shutdown flush) must not lose them
    (store_client write-through analog; VERDICT r2 weak #10)."""
    from ray_tpu_torch.cluster.head import HeadServer

    # deterministic: the 1s snapshot tick must not fire mid-test on a
    # loaded machine (it would truncate the WAL we are asserting on)
    monkeypatch.setattr(HeadServer, "_persist_loop", lambda self: None)
    path = str(tmp_path / "state.pkl")
    h1 = HeadServer(port=0, persist_path=path, use_device_scheduler=False)
    h1._h_kv_put({"key": "a", "value": b"1"})
    h1._h_kv_put({"key": "b", "value": b"2"})
    h1._h_kv_del({"key": "a"})
    # simulate a hard crash: NO snapshot flush, only the WAL exists
    h1._server.stop()
    h1._shutdown = True
    import os

    assert os.path.exists(path + ".wal")
    assert not os.path.exists(path)

    h2 = HeadServer(port=0, persist_path=path, use_device_scheduler=False)
    try:
        assert h2._kv.get("b") == b"2"
        assert "a" not in h2._kv
    finally:
        h2._server.stop()
        h2._shutdown = True


def test_wal_truncated_by_snapshot(tmp_path):
    from ray_tpu_torch.cluster.persistence import FilePersistence

    p = FilePersistence(str(tmp_path / "s.pkl"))
    p.wal_append(("kv_put", "x", b"1"))
    assert len(p.wal_replay()) == 1
    p.save_snapshot({"kv": {"x": b"1"}})
    assert p.wal_replay() == []  # superseded
    # torn tail write is ignored, earlier records survive
    p.wal_append(("kv_put", "y", b"2"))
    with open(p.wal_path, "ab") as f:
        f.write(b"\x40\x00\x00\x00partial")
    assert p.wal_replay() == [("kv_put", "y", b"2")]


def test_head_restart_recovers_state(tmp_path):
    c = Cluster(persist_path=str(tmp_path / "head_state.pkl"))
    c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        # durable state before the crash
        rt.kv_put("cfg/replicas", b"3")
        Actor = ray_tpu_torch.remote(Counter)
        a = Actor.options(name="survivor", max_restarts=1).remote()
        assert ray_tpu_torch.get(a.incr.remote(), timeout=60) == 1
        assert ray_tpu_torch.get(a.incr.remote(), timeout=30) == 2
        # timeline has head-side lease events
        assert len(ray_tpu_torch.timeline()) > 0
        # no sleep: shutdown flushes the dirty persistence window

        c.restart_head()

        # wait for the agent to re-register with the new head
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if any(n["Alive"] for n in rt.nodes_info()):
                break
            time.sleep(0.2)
        # KV survived the restart
        assert rt.kv_get("cfg/replicas") == b"3"
        # the actor survived WITH ITS IN-MEMORY STATE (its worker process
        # never died) and the name still resolves
        b = ray_tpu_torch.get_actor("survivor")
        deadline = time.monotonic() + 60
        value = None
        while time.monotonic() < deadline:
            try:
                value = ray_tpu_torch.get(b.incr.remote(), timeout=20)
                break
            except Exception:
                time.sleep(0.5)
        assert value == 3, f"expected preserved actor state 3, got {value}"
        # new work schedules normally
        f = ray_tpu_torch.remote(lambda x: x * 2)
        assert ray_tpu_torch.get(f.remote(21), timeout=60) == 42
    finally:
        set_runtime(None)
        c.shutdown()


def test_fair_batch_round_robins_classes():
    """An overflow round must interleave scheduling classes instead of
    letting one shape monopolize dispatch (per-class throttling analog)."""
    from collections import deque
    from ray_tpu_torch.cluster import head as head_mod
    from ray_tpu_torch.cluster.common import LeaseRequest

    class _H:
        _pop_fair_batch = head_mod.HeadServer._pop_fair_batch

    h = _H()
    h._cancelled_leases = set()
    mk = lambda i, res: LeaseRequest(  # noqa: E731
        task_id=f"t{i}", name="x", payload=b"", return_ids=[], resources=res
    )
    big = [mk(i, {"CPU": 1.0}) for i in range(head_mod.MAX_BATCH + 100)]
    small = [mk(10_000 + i, {"TPU": 1.0}) for i in range(10)]
    h._pending = deque(big + small)  # the storm queued first
    batch = h._pop_fair_batch()
    assert len(batch) == head_mod.MAX_BATCH
    # every TPU lease made it into the first round despite the CPU storm
    assert sum(1 for s in batch if "TPU" in s.resources) == 10
    assert len(h._pending) == 110  # remainder, all CPU-class


def test_oom_victim_is_newest_plain_task():
    from ray_tpu_torch.cluster.agent import NodeAgent, _WorkerHandle
    import threading

    class _A:
        _pick_oom_victim = NodeAgent._pick_oom_victim
        _lock = threading.RLock()

    a = _A()
    w_old = _WorkerHandle("old", proc=None)
    w_old.running = {"t1": 1.0}
    w_new = _WorkerHandle("new", proc=None)
    w_new.running = {"t2": 5.0}
    w_actor = _WorkerHandle("act", proc=None)
    w_actor.actor_id = "a1"
    w_actor.running = {"t3": 9.0}
    w_idle = _WorkerHandle("idle", proc=None)
    a._workers = {
        "old": w_old, "new": w_new, "act": w_actor, "idle": w_idle
    }
    victim = a._pick_oom_victim()
    assert victim is w_new  # newest task first; actor workers exempt

    a._workers = {"act": w_actor, "idle": w_idle}
    assert a._pick_oom_victim() is None


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnraisableExceptionWarning"
)
def test_actor_max_task_retries_redelivery_on_chaos_kill():
    """Chaos-kill the actor's node mid-call: in-flight calls with retry
    budget redeliver after the restart IN SUBMISSION ORDER; every caller
    still gets its result (actor.py mark_died redelivery machinery)."""
    import threading

    import ray_tpu_torch as rtpu
    from ray_tpu_torch.core.runtime import get_runtime

    log = []
    first_run = threading.Event()

    class Recorder:
        def __init__(self):
            log.append("start")

        async def work(self, tag):
            import asyncio

            log.append(f"begin:{tag}")
            if not first_run.is_set() and tag == "m1":
                first_run.set()
                # park until the chaos kill stops this instance's loop;
                # the redelivered attempt takes the fast path
                await asyncio.sleep(30)
            log.append(f"end:{tag}")
            return tag

    rtpu.init(num_nodes=2, resources_per_node={"CPU": 4})
    try:
        Actor = rtpu.remote(Recorder)
        a = Actor.options(
            max_restarts=1, max_task_retries=1, max_concurrency=1
        ).remote()
        r1 = a.work.remote("m1")
        deadline = time.monotonic() + 10
        while not first_run.is_set():
            assert time.monotonic() < deadline, "m1 never started"
            time.sleep(0.01)
        # queued behind the in-flight m1 (max_concurrency=1)
        r2 = a.work.remote("m2")
        r3 = a.work.remote("m3")
        node = a._actor_state.node_id
        get_runtime().kill_node(node)
        assert rtpu.get(r1, timeout=30) == "m1"
        assert rtpu.get(r2, timeout=30) == "m2"
        assert rtpu.get(r3, timeout=30) == "m3"
        # the actor restarted exactly once and redelivery preserved
        # submission order: m1 (retried) before m2 before m3
        assert log.count("start") == 2
        post = log[log.index("start", 1) :]
        order = [e for e in post if e.startswith("end:")]
        assert order == ["end:m1", "end:m2", "end:m3"], log
    finally:
        rtpu.shutdown()


def test_an_abandoned_async_call_seals_nothing_when_reaped():
    """The port's own case (ROADMAP Queue C 15): an async call parked when
    its actor's loop stopped is reaped later by the garbage collector, in
    whatever thread runs it. Its coroutine sealed a GeneratorExit failure
    there: over a result the redelivered call had sealed (the reference's
    chaos-kill case fails so under load), or, in a thread inside the
    object store's lock, into a deadlock that hung the process at
    shutdown. Closing it now seals nothing."""
    import asyncio

    import ray_tpu_torch as rtpu
    from ray_tpu_torch.core.runtime import get_runtime

    class Parker:
        async def park(self):
            await asyncio.sleep(60)

    rtpu.init(num_nodes=1, resources_per_node={"CPU": 2})
    try:
        a = rtpu.remote(Parker).remote()
        ref = a.park.remote()
        state = a._actor_state
        deadline = time.monotonic() + 10
        while not state._inflight or state._loop is None:
            assert time.monotonic() < deadline, "the call never started"
            time.sleep(0.01)
        loop, thread = state._loop, state._loop_thread
        time.sleep(0.2)  # let the call reach its await
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        tasks = asyncio.all_tasks(loop)
        assert tasks
        for task in tasks:
            task.get_coro().close()  # what the garbage collector does
        assert not get_runtime().store.contains(ref)
    finally:
        rtpu.shutdown()


def test_head_restart_with_unconsumed_stream_items(tmp_path):
    """Head restart while a streaming generator has unconsumed items:
    stream state rides the snapshot (items/done/consumed watermarks plus
    inline item values), so the consumer drains every item instead of
    parking forever on a stream the new head never heard of."""
    c = Cluster(persist_path=str(tmp_path / "head_state.pkl"))
    c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:

        def gen(n):
            for i in range(n):
                yield i * 10

        g = (
            ray_tpu_torch.remote(gen)
            .options(num_returns="streaming", max_retries=0)
            .remote(6)
        )
        it = iter(g)
        # consume two items, leave the rest unconsumed on the head
        assert ray_tpu_torch.get(next(it), timeout=60) == 0
        assert ray_tpu_torch.get(next(it), timeout=60) == 10
        # let the executor finish sealing all items + done marker
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with c.head._stream_cv:
                st = list(c.head._streams.values())
            if st and st[0]["done"] and len(st[0]["items"]) == 6:
                break
            time.sleep(0.1)

        c.restart_head()

        got = [ray_tpu_torch.get(r, timeout=60) for r in it]
        assert got == [20, 30, 40, 50]
    finally:
        set_runtime(None)
        c.shutdown()


def test_wal_recovered_actor_resubmits_creation(tmp_path, monkeypatch):
    """An actor REGISTERED but never created when the head crashed (the
    WAL window) has no hosting agent to re-attach it — recovery must
    resubmit its creation lease or it parks RESTARTING forever."""
    from ray_tpu_torch.cluster.common import LeaseRequest, new_id
    from ray_tpu_torch.cluster.head import HeadServer

    monkeypatch.setattr(HeadServer, "_persist_loop", lambda self: None)
    path = str(tmp_path / "state.pkl")
    h1 = HeadServer(port=0, persist_path=path, use_device_scheduler=False)
    spec = LeaseRequest(
        task_id=new_id(),
        name="Ghost.__init__",
        payload=b"\x80\x04N.",  # pickled None placeholder
        return_ids=[],
        resources={"CPU": 1.0},
        kind="actor_creation",
        actor_id=new_id(),
    )
    h1._h_create_actor(
        {"spec": spec, "name": "ghost", "class_name": "Ghost"}
    )
    # hard crash: no snapshot flush; the registration lives in the WAL
    h1._server.stop()
    h1._shutdown = True

    h2 = HeadServer(port=0, persist_path=path, use_device_scheduler=False)
    try:
        info = h2._actors[spec.actor_id]
        assert info.state == "RESTARTING"
        assert h2._named_actors.get("ghost") == spec.actor_id
        before = len(h2._pending)
        h2._recover_orphan_actors(grace_s=0)  # deterministic grace
        creations = [
            s
            for s in h2._pending
            if s.kind == "actor_creation" and s.actor_id == spec.actor_id
        ]
        assert len(creations) == 1, (before, len(h2._pending))
    finally:
        h2._server.stop()
        h2._shutdown = True


# ---------------------------------------------------------------------------
# recursive lineage reconstruction + epoch-fenced control plane (PR 5)
# ---------------------------------------------------------------------------

# > inline_object_max (100KiB): the chain's objects are store-resident,
# so losing their node genuinely loses the bytes
_CHAIN_PAD = 256 * 1024


def _chain_seed():
    return b"a" * _CHAIN_PAD


def _chain_step(prev, tag):
    # deterministic transform: the tail value proves every upstream
    # re-execution reproduced its input exactly
    import hashlib

    return hashlib.sha256(prev).digest() + tag.encode() * _CHAIN_PAD


def _touch_and_seed(marker_path):
    with open(marker_path, "a") as f:
        f.write("x")
    return b"o" * _CHAIN_PAD


def test_deep_lineage_reconstruction_after_node_kill(monkeypatch):
    """3-task chain seed -> mid -> tail; SIGKILL the node holding the
    mid-chain object. The reconstruction walk re-executes mid's creating
    lease — and, recursively, seed's too when its copy died with the same
    node — and both the mid and tail values stay correct
    (ObjectRecoveryManager's recursive re-execution analog)."""
    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "4.0")
    c = Cluster(use_device_scheduler=False)
    c.add_node({"CPU": 2.0}, num_workers=2)
    c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        seed = ray_tpu_torch.remote(_chain_seed)
        step = ray_tpu_torch.remote(_chain_step)
        a = seed.remote()
        b = step.remote(a, "b")
        tail = step.remote(b, "t")
        expect_b = _chain_step(_chain_seed(), "b")
        expect_tail = _chain_step(expect_b, "t")
        assert ray_tpu_torch.get(tail, timeout=120) == expect_tail
        head = c.head
        with head._lock:
            locs = set(head._objects[b.hex].locations)
        assert locs, "mid-chain object never landed in the store"
        for nid in locs:
            c.kill_node(nid)
        with head._lock:
            survivors = [
                nid
                for nid, n in head.nodes.items()
                if n.alive and nid not in locs
            ]
        if not survivors:
            # the chain colocated on every node we killed: reconstruction
            # still needs somewhere to run
            c.add_node({"CPU": 2.0}, num_workers=2)
        # the get parks until the health loop declares the node dead and
        # the requeued lineage re-seals the same object ids
        assert ray_tpu_torch.get(b, timeout=120) == expect_b
        assert ray_tpu_torch.get(tail, timeout=120) == expect_tail
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


def test_recursive_reconstruction_of_dropped_chain():
    """Drop the intermediate object AND its producer's input in one shot:
    rebuilding mid requires first re-executing seed's lineage (the
    recursive walk), and the reconstruction metrics record the depth-1
    rebuild."""
    from ray_tpu_torch.cluster.head import OBJECTS_RECONSTRUCTED

    c = Cluster(use_device_scheduler=False)
    c.add_node({"CPU": 4.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        seed = ray_tpu_torch.remote(_chain_seed)
        step = ray_tpu_torch.remote(_chain_step)
        a = seed.remote()
        b = step.remote(a, "b")
        expect_b = _chain_step(_chain_seed(), "b")
        assert ray_tpu_torch.get(b, timeout=120) == expect_b
        depth1_before = OBJECTS_RECONSTRUCTED.value(labels={"depth": "1"})
        # mid FIRST: its reconstruction must DISCOVER the lost input and
        # recurse (passing the input first would trivially rebuild it at
        # depth 0 before the walk ever reaches it)
        dropped = c.head.chaos_drop_objects([b.hex, a.hex])
        assert dropped == 2, "chain objects were not both store-resident"
        assert ray_tpu_torch.get(b, timeout=120) == expect_b
        # seed was rebuilt as depth-1 lineage of mid's depth-0 rebuild
        assert (
            OBJECTS_RECONSTRUCTED.value(labels={"depth": "1"})
            >= depth1_before + 1
        )
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


def test_max_retries_zero_object_fails_not_reexecuted(tmp_path):
    """At-most-once semantics survive reconstruction: a max_retries=0
    object that loses its only copy FAILS (ObjectLostError) instead of
    silently re-running its task."""
    from ray_tpu_torch import ObjectLostError

    c = Cluster(use_device_scheduler=False)
    c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        marker = str(tmp_path / "ran")
        task = ray_tpu_torch.remote(_touch_and_seed)
        r = task.options(max_retries=0).remote(marker)
        assert ray_tpu_torch.get(r, timeout=120) == b"o" * _CHAIN_PAD
        assert c.head.chaos_drop_objects([r.hex]) == 1
        with pytest.raises(ObjectLostError, match="at-most-once"):
            ray_tpu_torch.get(r, timeout=60)
        with open(marker) as f:
            assert f.read() == "x", "max_retries=0 task was re-executed"
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


def test_stale_epoch_rpc_rejected_after_head_restart(tmp_path):
    """Epoch-fenced control plane: a peer that registered with the
    PREVIOUS head incarnation stamps its RPCs with the old epoch; the
    rebuilt head rejects them (RpcStaleEpochError, non-retryable — not an
    RpcError) BEFORE any handler can touch the rebuilt tables."""
    from ray_tpu_torch.cluster.common import SealInfo
    from ray_tpu_torch.cluster.rpc import RpcClient, RpcError, RpcStaleEpochError

    c = Cluster(
        persist_path=str(tmp_path / "head_state.pkl"),
        use_device_scheduler=False,
    )
    c.add_node({"CPU": 2.0}, num_workers=1)
    try:
        old_epoch = c.head.cluster_epoch
        c.restart_head()
        assert c.head.cluster_epoch > old_epoch, "epoch must bump on restart"
        head = c.head
        with head._lock:
            leases_before = dict(head._task_leases)
        phantom_oid = "ee" * 14
        stale_report = {
            "node_id": "phantom-pre-restart-node",
            "seals": [
                SealInfo(
                    object_id=phantom_oid,
                    node_id="phantom-pre-restart-node",
                    size=1,
                )
            ],
            "task_leases": [{"lease_id": "phantom-lease", "ok": True}],
        }
        client = RpcClient(c.address)
        try:
            with pytest.raises(RpcStaleEpochError) as exc_info:
                client.call(
                    "ReportSeals",
                    stale_report,
                    timeout=10.0,
                    retries=5,
                    epoch=old_epoch,
                )
            # non-retryable by construction: a handler-level exception,
            # NOT a transport RpcError eating the retry budget
            assert not isinstance(exc_info.value, RpcError)
            with head._lock:
                assert phantom_oid not in head._objects, (
                    "stale seal mutated the rebuilt object directory"
                )
                assert head._task_leases == leases_before, (
                    "stale report mutated the rebuilt lease table"
                )
            # the SAME payload stamped with the current epoch passes the
            # fence (and a fence-exempt Ping always does)
            assert client.call("Ping", None, timeout=5.0) == "pong"
            client.call(
                "ReportSeals",
                stale_report,
                timeout=10.0,
                epoch=head.cluster_epoch,
            )
            with head._lock:
                assert phantom_oid in head._objects
        finally:
            client.close()
    finally:
        c.shutdown()


def test_actor_method_waits_for_the_creation_push():
    """Queue C 13: the agent publishes an actor's worker before it pushes
    the creation, and the creation's backfill can take a fork in between;
    a method lease drained meanwhile must reach the worker after the
    creation, never ahead of the instance (the worker's KeyError that
    ``chip_smoke.py``'s standby phase met after a promotion)."""
    import threading

    from ray_tpu_torch.cluster.agent import NodeAgent, _WorkerHandle
    from ray_tpu_torch.cluster.common import LeaseRequest

    pushed = []

    class _Client:
        def call(self, method, req, timeout=None):
            pushed.append(req["kind"])
            return {"status": "ok"}

    handle = _WorkerHandle("w1", proc=None)
    handle.client = _Client()
    published = threading.Event()

    class _A:
        _dispatch_to_worker = NodeAgent._dispatch_to_worker
        _create_actor_on = NodeAgent._create_actor_on
        _drain_actor_fifo = NodeAgent._drain_actor_fifo
        _run_on_worker = NodeAgent._run_on_worker

        def __init__(self):
            self._lock = threading.RLock()
            self._idle_cv = threading.Condition()
            self._idle, self._spawns_pending, self._num_workers = [], 0, 1
            self._actor_workers, self._actor_meta = {}, {}
            self._workers = {"w1": handle}
            self._actor_fifo, self._actor_draining = {}, set()
            self._shutdown = False

        def _pop_idle_worker(self):
            return handle

        def _spawn_worker(self):  # the backfill's fork, after the mapping
            published.set()
            time.sleep(0.5)

        def _push_req(self, spec, env=None):
            return {"kind": spec.kind}

        def _alloc_env(self, alloc):
            return {}

        def _finish_worker_reply(self, spec, handle, alloc, reply):
            pass

    agent = _A()

    def lease(kind):
        return LeaseRequest(task_id=kind, name="A", payload=b"", return_ids=[],
                            resources={}, kind=kind, actor_id="a1")

    creator = threading.Thread(target=agent._dispatch_to_worker,
                               args=(lease("actor_creation"), None))
    creator.start()
    assert published.wait(5.0)
    assert agent._actor_workers == {"a1": "w1"}  # methods can find the worker
    agent._actor_fifo["a1"] = [lease("actor_method")]
    agent._actor_draining.add("a1")
    drainer = threading.Thread(target=agent._drain_actor_fifo, args=("a1",))
    drainer.start()
    creator.join(10.0)
    drainer.join(10.0)
    assert not creator.is_alive() and not drainer.is_alive()
    assert pushed == ["actor_creation", "actor_method"]


def test_head_restart_releases_the_old_heads_scheduler_state(tmp_path):
    """A restarted head runs in the same process, so the stopped head
    frees its scheduler state's device tensors at ``shutdown``, and only
    the new head's state stays resident; the new head's rounds place."""
    c = Cluster(persist_path=str(tmp_path / "head_state.pkl"))
    c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        f = ray_tpu_torch.remote(lambda x: x + 1)
        assert ray_tpu_torch.get([f.remote(i) for i in range(8)], timeout=60) == list(
            range(1, 9))
        old = c.head.device_state
        assert old is not None and old.resident_bytes() > 0
        c.restart_head()
        assert old.resident_bytes() == 0
        assert old.resident_arrays() == (None, None, None)
        assert c.head.device_state is not old
        assert ray_tpu_torch.get([f.remote(i) for i in range(8, 16)], timeout=60) == list(
            range(9, 17))
        # a shape's first submission misses the client's lease cache, so
        # it takes a round of the new head (cached leases skip the head)
        deadline = time.monotonic() + 30
        k = 0
        while c.head.device_state.resident_bytes() == 0:
            assert time.monotonic() < deadline, "the new head never synced its state"
            k += 1
            g = f.options(num_cpus=0.01 * k)
            assert ray_tpu_torch.get(g.remote(k), timeout=60) == k + 1
        assert old.resident_bytes() == 0
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


def _task_value(i):
    return i * 3


def test_tasks_queued_at_a_restarted_head_complete(tmp_path):
    """Tasks the head held unfinished when it restarted (here parked: no
    node has their resource yet) live only in that head's queue. The new
    head re-drives them from the persisted lineage once a grace period
    lets agents redeliver what they ran, so the tasks run when the
    resource arrives and their getters return (Queue C 16: the reference's
    head forgets them and the getters wait forever); a max_retries=0 task
    fails with ObjectLostError instead of hanging."""
    from ray_tpu_torch.core.object_store import ObjectLostError

    c = Cluster(persist_path=str(tmp_path / "head_state.pkl"))
    c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        f = ray_tpu_torch.remote(_task_value)
        assert ray_tpu_torch.get(f.remote(1), timeout=60) == 3
        parked = [f.options(resources={"late": 1.0}).remote(i) for i in range(3)]
        once = f.options(resources={"late": 1.0}, max_retries=0).remote(9)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            with c.head._lock:
                held = len(c.head._infeasible) + len(c.head._pending)
            if held >= 4:
                break
            time.sleep(0.1)
        assert held >= 4, f"the head holds {held} of the 4 parked tasks"
        c.restart_head()
        c.add_node({"CPU": 2.0, "late": 1.0}, num_workers=1)
        assert ray_tpu_torch.get(parked, timeout=90) == [0, 3, 6]
        with pytest.raises(ObjectLostError):
            ray_tpu_torch.get(once, timeout=60)
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


def _slow_value(path, i, sleep_s):
    with open(path, "a") as fh:
        fh.write(f"{i}\n")
    time.sleep(sleep_s)
    return i * 3


def test_a_task_running_across_a_head_restart_runs_once(tmp_path, monkeypatch):
    """Tasks the head dispatched that still run on their agent when the
    head restarts, and run on past the new head's grace period, are named
    by the re-registering agent as on hand: the new head lets them finish
    there, so each runs once and returns its value, a max_retries=0 one
    too (re-driving them would run them twice, or fail the second with
    ObjectLostError while it still runs)."""
    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "2.0")
    log = tmp_path / "runs.txt"
    c = Cluster(persist_path=str(tmp_path / "head_state.pkl"))
    c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        f = ray_tpu_torch.remote(_slow_value)
        # two shapes, each submitted once: both go through the head
        refs = [
            f.options(num_cpus=1.0, max_retries=3).remote(str(log), 1, 7.0),
            f.options(num_cpus=0.5, max_retries=0).remote(str(log), 2, 7.0),
        ]
        deadline = time.monotonic() + 30
        while not (log.exists() and len(log.read_text().split()) >= 2):
            assert time.monotonic() < deadline, "the tasks never started"
            time.sleep(0.05)
        with c.head._lock:
            assert len(c.head._in_flight) == 2
        c.restart_head()
        assert ray_tpu_torch.get(refs, timeout=60) == [3, 6]
        assert sorted(log.read_text().split()) == ["1", "2"]
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


class _Named:
    def ping(self):
        return "pong"


def test_a_restarted_actor_keeps_its_name_through_a_head_that_lost_it(monkeypatch):
    """An actor restarted after its node died is re-created from a copy of
    its creation lease; that copy now carries the actor's name, restart
    budget, lifetime and owner (``actor_meta``) to the new agent, as the
    reference's head-restart path copies them (its node-death path, like
    the port's before, does not). A head that lost its tables (here one
    restarted without persistence; on the card, a standby promoted in the
    RL soak) re-attaches the running actor from the agent's report: it
    binds the name again and keeps the restart budget."""
    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "2.0")
    c = Cluster(use_device_scheduler=False)
    c.add_node({"CPU": 2.0}, num_workers=2)
    c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        actor = ray_tpu_torch.remote(_Named).options(name="kept-name", max_restarts=3).remote()
        assert ray_tpu_torch.get(actor.ping.remote(), timeout=60) == "pong"
        aid = actor._actor_id
        c.kill_node(c.head._actors[aid].node_id)
        c.add_node({"CPU": 2.0}, num_workers=2)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                c.head._actors[aid].num_restarts == 1 and c.head._actors[aid].state == "ALIVE"):
            time.sleep(0.1)
        assert ray_tpu_torch.get(actor.ping.remote(), timeout=60) == "pong"
        c.restart_head()  # no persist_path: the new head knows no actor
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and aid not in c.head._actors:
            time.sleep(0.1)
        info = c.head._actors[aid]
        assert c.head._named_actors.get("kept-name") == aid
        assert (info.name, info.max_restarts) == ("kept-name", 3)
        assert ray_tpu_torch.get(ray_tpu_torch.get_actor("kept-name").ping.remote(),
                                 timeout=60) == "pong"
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()
