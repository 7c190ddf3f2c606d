"""Replicated control plane: warm-standby heads, WAL shipping, fenced
failover, owner-sharded tables.

The leader's persistence stream (WAL records + snapshot barriers) ships
to a StandbyHead that continuously replays it into fully-built,
owner-sharded head tables; promotion is an epoch bump + listener bind
(HandoffPersistence — no disk replay). Split-brain is impossible by
construction: the promoted epoch is strictly higher, every mutating RPC
is epoch-stamped, and a deposed leader fences itself the moment it
observes the higher epoch (from its own shipping stream or from any
newer-stamped request).

Mirror of ``tests/test_head_failover.py``'s fast cases on the port
(``ray_tpu_torch``), the same cases and assertions, and of its slow chaos
soak on the port's ``ray_tpu_torch.chaos``. The promoted head
brings its scheduler state up on the scheduler device, here the CPU
(``RAY_TPU_SCHED_PLATFORM=cpu``). One case more holds the port's standby
against the JAX package's: given the same bootstrap snapshot and the same
shipped WAL batches of a port leader, both standbys' tables are equal.
Every wait has a deadline, every ``get`` a timeout.
"""
import pickle
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.runtime import set_runtime


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's heads (a promoted standby's too) bring their scheduler up
    # on cuda and raise without it; here the programs run on the host
    # (agents and workers inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def _mk_head(tmp_path, monkeypatch=None, name="state.pkl"):
    from ray_tpu_torch.cluster.head import HeadServer

    return HeadServer(
        port=0,
        persist_path=str(tmp_path / name),
        use_device_scheduler=False,
    )


def _wait(cond, timeout=15.0, every=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(every)
    return cond()


def _mk_lease_row(head, lid, client_id="owner1"):
    row = {
        "lease_id": lid,
        "state": "active",
        "resources": {"CPU": 1.0},
        "client_id": client_id,
        "fn_id": "fn",
        "node_id": "n1",
        "worker_address": "127.0.0.1:1",
        "worker_id": "w1",
        "accel_env": None,
        "expires_at": time.monotonic() + 100.0,
        "abandoned": False,
    }
    with head._cond:
        head._task_leases[lid] = row
        head._wal(("task_lease", head._lease_snapshot_row(row)))
    head._wal_flush()


def _normalize(snap):
    """Volatile fields out, deterministic order in: ttl_remaining_s is
    recomputed at snapshot time and lease/link rows iterate in shard
    order — neither is state."""
    out = dict(snap)
    for key in ("task_leases", "peer_links"):
        rows = []
        for row in out.get(key, []):
            row = dict(row)
            row.pop("ttl_remaining_s", None)
            rows.append(row)
        out[key] = sorted(
            rows, key=lambda r: r.get("lease_id") or r.get("link_id")
        )
    return out


# ---------------------------------------------------------------------------
# owner-shard routing layer
# ---------------------------------------------------------------------------


def test_sharded_table_routing_equivalence():
    """The owner-sharded table is observationally identical to the
    monolithic dict it replaced, under a randomized op sequence."""
    import random

    from ray_tpu_torch.cluster.shards import ShardedTable

    rng = random.Random(7)
    table, ref = ShardedTable(8), {}
    keys = [f"k{i:04x}" for i in range(200)]
    for _ in range(3000):
        k = rng.choice(keys)
        op = rng.randrange(5)
        if op == 0:
            table[k] = ref[k] = rng.random()
        elif op == 1:
            assert table.get(k, -1) == ref.get(k, -1)
        elif op == 2:
            assert table.pop(k, None) == ref.pop(k, None)
        elif op == 3:
            assert (k in table) == (k in ref)
        else:
            assert table.setdefault(k, 0.5) == ref.setdefault(k, 0.5)
        assert len(table) == len(ref)
    assert table == ref
    assert dict(table) == ref
    assert sorted(table.keys()) == sorted(ref.keys())
    assert sum(table.shard_sizes()) == len(ref)
    # routing is stable: every key reads back from its computed shard
    for k in list(ref)[:50]:
        assert table._shards[table.shard_index(k)][k] == ref[k]


def test_shard_grouped_wal_replay_equivalence():
    """Shipped-WAL replay partitioned by owner shard converges to the
    exact sequential-replay state: records for different shards commute
    (the property that makes shipped replay cheap and conflict-free)."""
    import random

    from ray_tpu_torch.cluster.shards import group_records_by_shard, shard_of
    from ray_tpu_torch.cluster.standby import record_shard_key

    rng = random.Random(11)
    records = []
    for i in range(500):
        lid = f"lease{rng.randrange(60):03d}"
        if rng.random() < 0.6:
            records.append(
                ("task_lease", {"lease_id": lid, "n": i})
            )
        else:
            records.append(("task_lease_gone", lid))

    def replay(recs):
        state = {}
        for rec in recs:
            if rec[0] == "task_lease":
                state[rec[1]["lease_id"]] = dict(rec[1])
            else:
                state.pop(rec[1], None)
        return state

    sequential = replay(records)
    groups, residue = group_records_by_shard(
        records, record_shard_key, 8
    )
    assert not residue
    sharded = {}
    # apply shard groups in arbitrary (reversed) order: cross-shard
    # records must commute
    for shard in sorted(groups, reverse=True):
        sharded.update(replay(groups[shard]))
    assert sharded == sequential
    # every grouped record actually routed by its mutated key
    for shard, recs in groups.items():
        for rec in recs:
            assert shard_of(record_shard_key(rec), 8) == shard


# ---------------------------------------------------------------------------
# WAL shipping + convergence
# ---------------------------------------------------------------------------


def test_wal_shipping_convergence(tmp_path):
    """After N mutations across every WAL-recorded table, the standby's
    continuously-replayed tables equal the leader's snapshot exactly
    (bit-equal modulo recomputed TTL remainders)."""
    from ray_tpu_torch.cluster.common import LeaseRequest, new_id
    from ray_tpu_torch.cluster.standby import StandbyHead

    h = _mk_head(tmp_path)
    sb = None
    try:
        h._h_kv_put({"key": "pre", "value": b"before-bootstrap"})
        sb = StandbyHead(
            h.address,
            persist_path=str(tmp_path / "state.pkl"),
            auto_promote=False,
        )
        for i in range(40):
            h._h_kv_put({"key": f"k{i}", "value": str(i).encode()})
        for i in range(0, 40, 3):
            h._h_kv_del({"key": f"k{i}"})
        spec = LeaseRequest(
            task_id=new_id(),
            name="Ghost.__init__",
            payload=b"\x80\x04N.",
            return_ids=[],
            resources={"CPU": 1.0},
            kind="actor_creation",
            actor_id=new_id(),
        )
        h._h_create_actor(
            {"spec": spec, "name": "ghost", "class_name": "Ghost"}
        )
        for i in range(12):
            _mk_lease_row(h, f"lease{i:02d}", client_id=f"owner{i % 3}")
        assert _wait(lambda: sb.applied_seq >= h._repl.seq), (
            sb.applied_seq,
            h._repl.seq,
        )
        leader_snap = _normalize(h._snapshot_state())
        standby_snap = _normalize(sb.tables_snapshot())
        for key in leader_snap:
            assert standby_snap.get(key) == leader_snap[key], key
        assert set(standby_snap) == set(leader_snap)
        # equal when re-serialized through the same wire the snapshot
        # itself rides (structural equality; raw pickle bytes differ
        # only by memoization of shared objects, which is not state)
        assert pickle.loads(pickle.dumps(standby_snap)) == pickle.loads(
            pickle.dumps(leader_snap)
        )
        # owner-shard occupancy is visible through the routing layer
        assert sum(sb._task_leases.shard_sizes()) == 12
        from ray_tpu_torch.cluster.rpc import RpcClient

        c = RpcClient(h.address)
        try:
            state = c.call("QueryState", {"kind": "replication"})
        finally:
            c.close()
        assert state["role"] == "leader"
        assert state["standbys"][0]["lag_records"] == 0
        assert state["last_shipped_seq"] == h._repl.seq
        assert sum(state["shards"]["task_leases"]) == 12
    finally:
        if sb is not None:
            sb.shutdown()
        h._shutdown = True
        h._repl.stop()
        h._server.stop()


def test_gap_resync_after_dropped_batch(tmp_path):
    """Sequence gaps heal without data loss: a standby that missed a
    shipped batch asks to rewind (resync_from) and, when the leader's
    ring no longer holds the records, re-bootstraps from a fresh
    snapshot barrier — converging either way."""
    from ray_tpu_torch.cluster.replication import WAL_SHIP_RESYNCS
    from ray_tpu_torch.cluster.standby import StandbyHead

    h = _mk_head(tmp_path)
    sb = None
    try:
        sb = StandbyHead(
            h.address,
            persist_path=str(tmp_path / "state.pkl"),
            auto_promote=False,
        )
        for i in range(30):
            h._h_kv_put({"key": f"a{i}", "value": b"x"})
        assert _wait(lambda: sb.applied_seq >= h._repl.seq)
        resyncs0 = WAL_SHIP_RESYNCS.value()
        # simulate a dropped batch: the leader believes 5 more records
        # were delivered than the standby ever saw
        with h._repl._cv:
            sid = next(iter(h._repl._standbys))
            h._repl._standbys[sid]["acked"] += 5
        for i in range(10):
            h._h_kv_put({"key": f"b{i}", "value": b"y"})
        assert _wait(
            lambda: sb.applied_seq >= h._repl.seq
            and sb._kv.get("b9") == b"y"
        )
        assert sb.metrics["resyncs_requested"] >= 1
        assert WAL_SHIP_RESYNCS.value() >= resyncs0 + 1
        assert {k: v for k, v in sb._kv.items()} == dict(h._kv)
        # now a gap PAST the ring: rewind cannot serve it, so the leader
        # ships a fresh snapshot instead
        resyncs1 = WAL_SHIP_RESYNCS.value()
        with h._repl._cv:
            h._repl._standbys[sid]["acked"] = 0
            h._repl._ring.clear()
        h._h_kv_put({"key": "post-gap", "value": b"z"})
        assert _wait(
            lambda: sb._kv.get("post-gap") == b"z"
            and dict(sb._kv) == dict(h._kv)
        )
        assert WAL_SHIP_RESYNCS.value() >= resyncs1 + 1
        assert sb.metrics["snapshots_installed"] >= 2  # bootstrap + resync
    finally:
        if sb is not None:
            sb.shutdown()
        h._shutdown = True
        h._repl.stop()
        h._server.stop()


# ---------------------------------------------------------------------------
# fenced promotion + deposed-leader self-fencing
# ---------------------------------------------------------------------------


def test_deposed_leader_self_fences(tmp_path):
    """A leader that was only PARTITIONED (standby promoted over it)
    fences itself off its own shipping stream: late writes are rejected
    at the RPC layer, the persistence file is never touched again, and
    a request stamped with the newer epoch deposes it too."""
    import os

    from ray_tpu_torch.cluster.rpc import (
        RpcClient,
        RpcError,
        RpcNotLeaderError,
    )
    from ray_tpu_torch.cluster.standby import StandbyHead

    h1 = _mk_head(tmp_path)
    sb = None
    h2 = None
    try:
        # no shared persist path: this standby models a DIFFERENT
        # machine (the partition scenario), so the in-process
        # file-ownership guard cannot mask the epoch fence under test
        sb = StandbyHead(h1.address, auto_promote=False)
        h1._h_kv_put({"key": "durable", "value": b"1"})
        h1._persist_now()  # pre-fence flush: the file the corpse must
        # never touch again exists before the fence drops
        assert _wait(lambda: sb.applied_seq >= h1._repl.seq)
        # promote onto a FREE port: the old leader is alive (partition
        # scenario), so the standby cannot take its listener — the
        # epoch fence alone must prevent split-brain
        h2 = sb.promote(port=0)
        assert h2.cluster_epoch > h1.cluster_epoch
        # the deposed leader's next ship attempt meets {"fenced"}:
        h1._h_kv_put({"key": "late", "value": b"2"})
        assert _wait(lambda: h1._fenced), "leader never fenced itself"
        assert h1.role == "fenced"
        # late writes rejected at the RPC layer, with the leader hint
        c = RpcClient(h1.address)
        try:
            with pytest.raises(RpcNotLeaderError) as exc_info:
                c.call("KvPut", {"key": "x", "value": b"3"}, timeout=5.0)
            # an RpcError SUBCLASS by design: legacy except-RpcError
            # paths degrade to retry/requeue, failover-aware ones catch
            # it first and walk the hint
            assert isinstance(exc_info.value, RpcError)
            assert exc_info.value.leader_hint == h2.address
            # the role probe still answers (stragglers get redirected)
            role = c.call("HeadRole", {}, timeout=5.0)
            assert role["role"] == "fenced"
            assert role["leader_hint"] == h2.address
        finally:
            c.close()
        # the fenced corpse never writes its persistence file again
        path = str(tmp_path / "state.pkl")
        mtime = os.path.getmtime(path)
        snap_before = pickle.load(open(path, "rb"))
        h1.mark_dirty()
        h1._persist_now()  # refused: self._fenced gates the write
        h1._h_kv_put({"key": "never", "value": b"x"})  # WAL also inert
        assert os.path.getmtime(path) == mtime
        assert pickle.load(open(path, "rb")) == snap_before
        # the promoted head carries everything replicated pre-promotion
        # ("late" landed on the deposed leader after the promotion cut
        # and is rejected from the stream — the async-shipping window,
        # same durability contract as an unreplicated hard crash)
        assert h2._kv.get("durable") == b"1"
        assert "late" not in h2._kv
    finally:
        if h2 is not None:
            h2.shutdown()
        if sb is not None:
            sb.shutdown()
        h1._shutdown = True
        h1._repl.stop()
        h1._server.stop()


def test_newer_epoch_stamp_deposes_leader(tmp_path):
    """The other fencing path: any request stamped with a HIGHER epoch
    (its sender registered with a newer incarnation) makes this head
    step down before the handler runs."""
    from ray_tpu_torch.cluster.rpc import RpcClient, RpcNotLeaderError

    h = _mk_head(tmp_path)
    try:
        c = RpcClient(h.address)
        try:
            with pytest.raises(RpcNotLeaderError):
                c.call(
                    "KvPut",
                    {"key": "x", "value": b"1"},
                    timeout=5.0,
                    epoch=h.cluster_epoch + 1000,
                )
        finally:
            c.close()
        assert h._fenced and h.role == "fenced"
        assert "x" not in h._kv
    finally:
        h._shutdown = True
        h._repl.stop()
        h._server.stop()


def test_pending_revoke_records_redriven_after_promotion(tmp_path):
    """Revocation fan-outs are WAL records, not best-effort last
    breaths: one queued by a leader that died before delivering is
    re-driven by the promoted head, idempotently, once the target node
    (re-)registers."""
    import threading

    from ray_tpu_torch.cluster.common import NodeInfo
    from ray_tpu_torch.cluster.rpc import RpcServer
    from ray_tpu_torch.cluster.standby import StandbyHead

    h1 = _mk_head(tmp_path)
    sb = None
    h2 = None
    agent_srv = None
    try:
        sb = StandbyHead(
            h1.address,
            persist_path=str(tmp_path / "state.pkl"),
            auto_promote=False,
        )
        # queue a revoke for a node that is not connected: it stays
        # pending (WAL'd) — the dying leader "never delivered it"
        h1._queue_revoke(
            "ReturnWorkerLease", "nodeA", {"lease_id": "leaseX"}
        )
        assert _wait(lambda: "leaseX" in str(sb._pending_revokes))
        assert len(h1._pending_revokes) == 1
        # leader dies; standby promotes (fresh port: no cluster here)
        h1._server.stop()
        h1._shutdown = True
        h1._repl.stop()
        h2 = sb.promote(port=0)
        assert len(h2._pending_revokes) == 1
        # the target node registers with the new leader: the pending
        # revoke re-drives to it
        got = threading.Event()
        received = []

        def _return_lease(req):
            received.append(req)
            got.set()
            return {"ok": True}

        agent_srv = RpcServer(
            {"ReturnWorkerLease": _return_lease, "Ping": lambda r: "pong"}
        )
        h2._h_register_node(
            NodeInfo(
                node_id="nodeA",
                address=agent_srv.address,
                resources={"CPU": 1.0},
            )
        )
        assert got.wait(15.0), "pending revoke was never re-driven"
        assert received[0]["lease_id"] == "leaseX"
        assert _wait(lambda: len(h2._pending_revokes) == 0)
    finally:
        if agent_srv is not None:
            agent_srv.stop()
        if h2 is not None:
            h2.shutdown()
        if sb is not None:
            sb.shutdown()
        h1._shutdown = True
        h1._repl.stop()
        h1._server.stop()


# ---------------------------------------------------------------------------
# end-to-end: kill the leader under load, promote, nothing lost
# ---------------------------------------------------------------------------

_PAYLOAD = 200 * 1024  # > inline max: results live in node stores


def _produce(i):
    return bytes([i % 251]) * _PAYLOAD


def test_promotion_under_mid_wave_load(tmp_path, monkeypatch):
    """SIGKILL the leader with a task wave in flight; the auto-promoting
    standby detects the death (strike-based watch), binds the leader's
    port, and every pre-kill submission completes with correct bytes;
    fresh work schedules through the new leader; the epoch strictly
    increased."""
    monkeypatch.setenv("RAY_TPU_HEAD_HEALTH_TIMEOUT_S", "1.5")
    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "4.0")
    c = Cluster(
        persist_path=str(tmp_path / "head_state.pkl"),
        use_device_scheduler=False,
    )
    c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        standby = c.start_standby(auto_promote=True)
        pre_epoch = c.head.cluster_epoch
        task = ray_tpu_torch.remote(_produce)
        # warm the task shape HOT (2nd submission turns it leased): the
        # wave below then streams owner->worker on cached leases — the
        # plane that provably keeps flowing while the head is down
        warm = task.options(max_retries=20).remote(0)
        warm2 = task.options(max_retries=20).remote(1)
        assert ray_tpu_torch.get(warm, timeout=60) == _produce(0)
        assert ray_tpu_torch.get(warm2, timeout=60) == _produce(1)
        refs = [task.options(max_retries=20).remote(i) for i in range(24)]
        c.kill_head()
        head = standby.wait_promoted(timeout=30.0)
        assert head is not None, "standby never auto-promoted"
        assert c.head is head  # on_promoted swapped the cluster handle
        assert head.cluster_epoch > pre_epoch
        assert head.address == c.address  # listener bound on the old port
        for i, ref in enumerate(refs):
            assert ray_tpu_torch.get(ref, timeout=120) == _produce(i)
        # acked pre-kill object still resolves (zero acked loss)
        assert ray_tpu_torch.get(warm, timeout=60) == _produce(0)
        # fresh work schedules through the promoted head
        assert ray_tpu_torch.get(task.remote(77), timeout=120) == _produce(77)
        # the corpse is provably inert
        dead = c._dead_heads[-1]
        assert dead._shutdown
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


# ---------------------------------------------------------------------------
# the port's standby against the JAX package's, on one shipped stream
# ---------------------------------------------------------------------------


def test_standby_tables_match_the_reference_standby(tmp_path, monkeypatch):
    """A port leader ships its WAL to a port standby; the bootstrap reply
    and every shipped batch are recorded and replayed into the JAX
    package's StandbyHead (bootstrapped from a stub leader that answers
    with the same reply). Both standbys' tables must be equal."""
    from ray_tpu.cluster.rpc import RpcServer as JRpcServer
    from ray_tpu.cluster.standby import StandbyHead as JStandbyHead
    from ray_tpu_torch.cluster.common import LeaseRequest, new_id
    from ray_tpu_torch.cluster.head import HeadServer
    from ray_tpu_torch.cluster.standby import StandbyHead

    hellos, batches = [], []
    real_hello = HeadServer._h_standby_hello
    real_wal = StandbyHead._h_repl_wal

    def hello(self, req):
        reply = real_hello(self, req)
        hellos.append(reply)
        return reply

    def repl_wal(self, batch):
        out = real_wal(self, batch)
        batches.append(batch)
        return out

    monkeypatch.setattr(HeadServer, "_h_standby_hello", hello)
    monkeypatch.setattr(StandbyHead, "_h_repl_wal", repl_wal)
    h = _mk_head(tmp_path)
    sb = jsb = stub = None
    try:
        h._h_kv_put({"key": "pre", "value": b"before-bootstrap"})
        sb = StandbyHead(h.address, auto_promote=False)
        for i in range(30):
            h._h_kv_put({"key": f"k{i}", "value": str(i).encode()})
        for i in range(0, 30, 4):
            h._h_kv_del({"key": f"k{i}"})
        spec = LeaseRequest(
            task_id=new_id(),
            name="Ghost.__init__",
            payload=b"\x80\x04N.",
            return_ids=[],
            resources={"CPU": 1.0},
            kind="actor_creation",
            actor_id=new_id(),
        )
        h._h_create_actor({"spec": spec, "name": "ghost", "class_name": "Ghost"})
        for i in range(10):
            _mk_lease_row(h, f"lease{i:02d}", client_id=f"owner{i % 3}")
        h._queue_revoke("ReturnWorkerLease", "nodeA", {"lease_id": "lease03"})
        assert _wait(lambda: sb.applied_seq >= h._repl.seq)
        assert len(hellos) == 1 and batches
        stub = JRpcServer({"StandbyHello": lambda r: hellos[0], "Ping": lambda r: "pong"})
        jsb = JStandbyHead(stub.address, auto_promote=False)
        for batch in list(batches):
            jsb._h_repl_wal(batch)
        assert jsb.applied_seq == sb.applied_seq
        got = _normalize(sb.tables_snapshot())
        want = _normalize(jsb.tables_snapshot())
        # the port's snapshot also names the leases left unfinished, which
        # a restarted or promoted head re-drives (Queue C 16); no task ran
        assert got.pop("unfinished_leases") == []
        assert got == want
        assert got["kv"]["k1"] == b"1" and "k0" not in got["kv"]
        assert len(got["task_leases"]) == 10 and got["pending_revokes"]
    finally:
        for s in (jsb, sb):
            if s is not None:
                s.shutdown()
        if stub is not None:
            stub.stop()
        h._shutdown = True
        h._repl.stop()
        h._server.stop()


def test_equal_creation_payloads_are_snapshotted_once(tmp_path):
    """Queue C 20: the replicas of one deployment carry equal creation
    payloads (the class, and its weights where a closure holds them:
    ~170 MB at ``ModelConfig()`` f32). The head keeps one bytes object for
    equal large payloads, so a snapshot (and its barrier to the standbys)
    carries it once; two replicas' 340 MB outgrew the RPC message limit and
    froze the standby of the RL soak on the card."""
    from ray_tpu_torch.cluster.common import LeaseRequest

    h = _mk_head(tmp_path)
    try:
        blob = bytes(range(256)) * (8 << 10)  # 2 MiB
        for i in range(3):
            spec = LeaseRequest(task_id=f"t{i}", name="Replica", payload=bytes(bytearray(blob)),
                                return_ids=[], resources={"CPU": 1.0}, kind="actor_creation",
                                actor_id=f"a{i}")
            h._h_create_actor({"spec": spec, "class_name": "Replica", "max_restarts": 1})
        specs = [h._actor_specs[f"a{i}"] for i in range(3)]
        assert all(s.payload is specs[0].payload for s in specs)
        assert len(pickle.dumps(h._snapshot_state())) < 2 * len(blob)
        small = LeaseRequest(task_id="t9", name="Small", payload=b"x" * 64, return_ids=[],
                             resources={"CPU": 1.0}, kind="actor_creation", actor_id="a9")
        h._h_create_actor({"spec": small, "class_name": "Small"})
        assert h._actor_specs["a9"].payload == b"x" * 64
    finally:
        h._shutdown = True
        h._repl.stop()
        h._server.stop()

def _resident_sched_states():
    import gc
    import warnings

    from ray_tpu_torch.scheduler.device import DeviceSchedulerState

    with warnings.catch_warnings():  # isinstance reaches deprecated module attributes
        warnings.simplefilter("ignore")
        return [o for o in gc.get_objects()
                if isinstance(o, DeviceSchedulerState) and o.resident_bytes() > 0]


def test_kill_head_frees_the_corpse_scheduler_state(tmp_path, monkeypatch):
    """``Cluster.kill_head`` frees the killed leader's scheduler state, as
    a killed process frees its card memory, and keeps the corpse with its
    tables in ``_dead_heads`` for the split-brain probe: after the standby
    promotes, the probe runs over the corpse and one state is resident."""
    from ray_tpu_torch.chaos.invariants import InvariantChecker

    monkeypatch.setenv("RAY_TPU_HEAD_HEALTH_TIMEOUT_S", "1.5")
    c = Cluster(persist_path=str(tmp_path / "head_state.pkl"))
    c.add_node({"CPU": 1.0}, num_workers=1)
    rt = c.client()
    set_runtime(rt)
    try:
        f = ray_tpu_torch.remote(_produce)
        assert ray_tpu_torch.get(f.remote(1), timeout=60) == _produce(1)
        corpse = c.head
        assert corpse.device_state.resident_bytes() > 0
        c.start_standby(auto_promote=True)
        pre_epoch = corpse.cluster_epoch
        c.kill_head()
        assert c._dead_heads == [corpse]
        assert corpse.device_state.resident_bytes() == 0
        assert InvariantChecker(c, workload=None).wait_standby_promoted(
            pre_epoch, timeout=30.0) == []
        assert c.head is not corpse and c.head.cluster_epoch > pre_epoch
        assert corpse.address and corpse.nodes  # the probe's tables stay
        assert ray_tpu_torch.get(f.remote(2), timeout=60) == _produce(2)
        assert _resident_sched_states() == [c.head.device_state]
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


@pytest.mark.slow
def test_failover_chaos_soak(monkeypatch):
    """Slow soak: leader kills + promotions interleaved with partitions
    and object drops under a verified workload — standby promotes every
    time, in-flight waves complete, zero acked-object loss."""
    import tempfile

    from ray_tpu_torch.chaos import (
        FAILOVER_MIX,
        ChaosOrchestrator,
        ChaosWorkload,
        chaos_seed,
        make_plan,
    )

    monkeypatch.setenv("RAY_TPU_HEAD_HEALTH_TIMEOUT_S", "1.5")
    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "4.0")
    monkeypatch.setenv("RAY_TPU_RPC_BREAKER_WINDOW_S", "2.0")
    # the reference's default seed: its 8-fault schedule carries 3
    # failovers, 2 partitions, 3 object drops
    seed = chaos_seed(default=20260805)
    tmp = tempfile.mkdtemp(prefix="ray_tpu_torch_failover_soak_")
    c = Cluster(
        use_device_scheduler=False,
        persist_path=f"{tmp}/head_state.pkl",
    )
    c.add_node({"CPU": 2.0}, num_workers=2)
    c.add_node({"CPU": 2.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        c.start_standby(auto_promote=True)
        workload = ChaosWorkload(rt, payload_bytes=150_000, num_actors=1)
        plan = make_plan(
            seed,
            8,
            mix=FAILOVER_MIX,
            allow=("head_kill_promote", "partition", "object_drop"),
        )
        assert plan.counts().get("head_kill_promote", 0) >= 2, (
            "seed produced too few failovers; pick another default"
        )
        orch = ChaosOrchestrator(
            c,
            workload,
            plan,
            node_resources={"CPU": 2.0},
            partition_hold_s=1.0,
            convergence_budget_s=90.0,
        )
        result = orch.run()
        assert result.ok, (
            f"failover soak failed — replay with RAY_TPU_CHAOS_SEED="
            f"{seed}: {result.summary()['failures']}"
        )
        assert result.objects_acked > 0
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()
