"""Warm-standby head: snapshot bootstrap + live WAL replay + promotion.

A :class:`StandbyHead` tails the leader's persistence stream (one
``StandbyHello`` bootstrap, then pushed ``ReplWal`` batches from the
leader's :class:`~ray_tpu_torch.cluster.replication.ReplicationHub`) and
continuously replays it into fully-built, snapshot-shaped head tables —
owner-sharded exactly like the leader's, applied per shard group
(conflict-free: records for different shards commute). Promotion is
therefore an epoch bump + listener bind: the merged tables hand off
in-memory to a fresh :class:`~ray_tpu_torch.cluster.head.HeadServer`
(``HandoffPersistence``) on the dead leader's port; no disk replay.

Leader election needs no external coordinator: the standby runs the same
strike-based health shape agents use (``head_miss_threshold`` strikes of
``head_health_timeout_s / threshold`` windows, shipped batches counting
as liveness), declares the leader dead, and promotes. Split-brain is
impossible by construction — the promoted head's epoch is strictly
higher, every mutating RPC is epoch-stamped, and a deposed leader that
was merely partitioned fences itself the moment it observes the higher
epoch (from its own shipping stream's ``{"fenced"}`` replies, or from
any request stamped with the newer epoch).

Port of ``ray_tpu/cluster/standby.py``, copied with its imports rewritten,
and one order changed: ``promote`` runs ``on_promoted`` before it
publishes the new head, so ``wait_promoted`` never returns ahead of the
callback. The promoted ``HeadServer`` brings its scheduler state up on the card in
its constructor, as every head of the port does: a device that fails to
come up fails the promotion (logged, and the watch resumes), and the
standby never promotes onto a host path.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.config import cfg

from .common import new_id
from .replication import FAILOVER_MS
from .rpc import RpcClient, RpcError, RpcNotLeaderError, RpcServer
from .shards import ShardedTable, group_records_by_shard

logger = logging.getLogger("ray_tpu_torch.cluster.standby")

# WAL record kind -> the sharded-table key it mutates (None = applies to
# an unsharded table and must replay in stream order). The ONE map both
# the shard-group replay and the routing-equivalence test use.
_SHARDED_KINDS = {
    "task_lease": lambda rec: rec[1]["lease_id"],
    "task_lease_gone": lambda rec: rec[1],
    "peer_link": lambda rec: rec[1]["link_id"],
    "peer_link_gone": lambda rec: rec[1],
    "serve_stream": lambda rec: rec[1]["stream_id"],
    "serve_stream_ckpt": lambda rec: rec[1]["stream_id"],
    "serve_stream_gone": lambda rec: rec[1],
}


def record_shard_key(rec: tuple) -> Optional[str]:
    fn = _SHARDED_KINDS.get(rec[0])
    try:
        return fn(rec) if fn is not None else None
    except (KeyError, IndexError, TypeError):
        return None


class StandbyHead:
    """One warm standby following one leader."""

    def __init__(
        self,
        leader_address: str,
        host: str = "127.0.0.1",
        port: int = 0,
        persist_path: Optional[str] = None,
        standby_id: Optional[str] = None,
        auto_promote: bool = True,
        use_device_scheduler: Optional[bool] = None,
    ):
        self.leader_address = leader_address
        self.persist_path = persist_path
        self.standby_id = standby_id or f"sb-{new_id()}"
        self.auto_promote = auto_promote
        self.use_device_scheduler = use_device_scheduler
        self.role = "standby"
        self.promoted: Optional[Any] = None  # the HeadServer once leader
        self.on_promoted = None  # callback(head) after a promotion
        self.leader_epoch = 0
        self.applied_seq = 0
        self._expected = 1
        self._lock = threading.RLock()
        # the pieces of the one framed batch in flight (ReplWalPiece)
        self._xfer: Optional[str] = None
        self._xfer_parts: List[bytes] = []
        self._shutdown = False
        self._leader_seen = time.monotonic()
        self._last_batch = time.monotonic()  # ship-stream silence clock
        n = max(1, int(cfg.head_shards))
        self._num_shards = n
        # snapshot-shaped mirror tables (the leader's _snapshot_state
        # layout), continuously replayed; lease tables owner-sharded
        self._kv: Dict[str, bytes] = {}
        self._named_actors: Dict[str, str] = {}
        self._actors: Dict[str, dict] = {}
        self._actor_specs: Dict[str, Any] = {}
        self._leases: Dict[str, Any] = {}
        self._unfinished_leases: List[str] = []
        self._jobs: list = []
        self._streams: Dict[str, dict] = {}
        self._stream_tombstones: list = []
        self._stream_inline: Dict[str, tuple] = {}
        self._task_leases: ShardedTable = ShardedTable(n)
        self._peer_links: ShardedTable = ShardedTable(n)
        self._pending_revokes: Dict[str, dict] = {}
        self._serve_fleets: Dict[str, dict] = {}
        self._weights_epochs: Dict[str, dict] = {}
        self._serve_streams: ShardedTable = ShardedTable(n)
        self.metrics = {
            "wal_applied": 0,
            "snapshots_installed": 0,
            "resyncs_requested": 0,
            "batches_received": 0,
        }
        self._server = RpcServer(
            {
                "ReplWal": self._h_repl_wal,
                "ReplWalPiece": self._h_repl_wal_piece,
                "HeadRole": self._h_head_role,
                "QueryState": self._h_query_state,
                "Ping": lambda r: "pong",
            },
            host=host,
            port=port,
        )
        self.address = self._server.address
        try:
            self._hello()
        except Exception:
            self._server.stop()
            raise
        self._watch_thread = threading.Thread(
            target=self._watch_loop, name="standby-watch", daemon=True
        )
        self._watch_thread.start()

    # -- bootstrap -------------------------------------------------------
    def _hello(self) -> None:
        client = RpcClient(self.leader_address)
        try:
            reply = client.call(
                "StandbyHello",
                {"standby_id": self.standby_id, "address": self.address},
                timeout=30.0,
                retries=3,
                retry_interval=0.2,
            )
        finally:
            client.close()
        with self._lock:
            if reply["snapshot"] is not None:
                # else it was too big for one message: the leader ships
                # it as a re-sync, in pieces, before any record
                self._install_snapshot(reply["snapshot"])
            self.applied_seq = int(reply["from_seq"])
            self._expected = self.applied_seq + 1
            self.leader_epoch = int(reply.get("epoch", 0))
            self._leader_seen = time.monotonic()
            self._last_batch = time.monotonic()
        logger.info(
            "standby %s bootstrapped from %s (seq %d, epoch %d)",
            self.standby_id[:8],
            self.leader_address,
            self.applied_seq,
            self.leader_epoch,
        )

    def _install_snapshot(self, snap: dict) -> None:
        """Reset every mirror table from a leader snapshot (bootstrap,
        seq'd barrier, or gap re-sync). Caller holds self._lock."""
        self._kv = dict(snap.get("kv", {}))
        self._named_actors = dict(snap.get("named_actors", {}))
        self._actors = {
            aid: dict(fields)
            for aid, fields in snap.get("actors", {}).items()
        }
        self._actor_specs = dict(snap.get("actor_specs", {}))
        self._leases = dict(snap.get("leases", {}))
        self._unfinished_leases = list(snap.get("unfinished_leases", []))
        self._jobs = list(snap.get("jobs", []))
        self._streams = {
            tid: dict(st) for tid, st in snap.get("streams", {}).items()
        }
        self._stream_tombstones = list(snap.get("stream_tombstones", []))
        self._stream_inline = dict(snap.get("stream_inline", {}))
        self._task_leases = ShardedTable(self._num_shards)
        for row in snap.get("task_leases", []):
            self._task_leases[row["lease_id"]] = dict(row)
        self._peer_links = ShardedTable(self._num_shards)
        for row in snap.get("peer_links", []):
            self._peer_links[row["link_id"]] = dict(row)
        self._pending_revokes = {
            rid: dict(row)
            for rid, row in snap.get("pending_revokes", {}).items()
        }
        self._serve_fleets = {
            dep: dict(f) for dep, f in snap.get("serve_fleets", {}).items()
        }
        self._weights_epochs = {
            dep: {
                "committed": int(w.get("committed", 0)),
                "meta": dict(w.get("meta", {})),
                "sealed": dict(w["sealed"]) if w.get("sealed") else None,
            }
            for dep, w in snap.get("weights_epochs", {}).items()
        }
        self._serve_streams = ShardedTable(self._num_shards)
        for row in snap.get("serve_streams", []):
            self._serve_streams[row["stream_id"]] = dict(row)
        if "epoch" in snap:
            self.leader_epoch = max(
                self.leader_epoch, int(snap.get("epoch", 0))
            )
        self.metrics["snapshots_installed"] += 1

    # -- live replay -----------------------------------------------------
    def _h_repl_wal_piece(self, req: dict) -> dict:
        """One piece of a batch's wire frame (``replication.ship_in_pieces``).
        The last piece's reply is the batch's; a piece out of order drops
        the batch, and the leader ships it anew."""
        from . import serialization as wire

        with self._lock:
            if req["xfer"] != self._xfer:
                self._xfer, self._xfer_parts = req["xfer"], []
            if int(req["index"]) != len(self._xfer_parts):
                self._xfer, self._xfer_parts = None, []
                return {"piece_gap": int(req["index"])}
            self._xfer_parts.append(bytes(req["data"]))
            if len(self._xfer_parts) < int(req["count"]):
                return {"piece": int(req["index"])}
            blob = b"".join(self._xfer_parts)
            self._xfer, self._xfer_parts = None, []
        return self._h_repl_wal(wire.loads(blob))

    def _h_repl_wal(self, batch) -> dict:
        with self._lock:
            if self.promoted is not None:
                # promoted: fence the deposed leader off its own
                # shipping stream
                return {
                    "fenced": self.promoted.cluster_epoch,
                    "leader": self.promoted.address,
                }
            if self.role != "standby":
                # promotion IN FLIGHT — and it may yet abort (the bind
                # interlock exists precisely for the leader-was-alive
                # false positive). Fencing here would depose a live
                # leader that can never be replaced (it holds the port).
                # Neither fence nor apply: leave the records pending;
                # the shipper re-sends them and this standby either
                # resumes (abort) or starts fencing (promoted).
                return {"applied_to": self.applied_seq}
            epoch = int(batch.epoch)
            if epoch < self.leader_epoch:
                # a deposed leader still shipping: refuse (and tell it)
                return {"fenced": self.leader_epoch, "leader": ""}
            self.leader_epoch = max(self.leader_epoch, epoch)
            self._leader_seen = time.monotonic()
            self._last_batch = time.monotonic()
            self.metrics["batches_received"] += 1
            if batch.snapshot is not None:
                # gap re-sync: full reset at snap_seq, tail ships after
                self._install_snapshot(batch.snapshot)
                self.applied_seq = int(batch.snap_seq)
                self._expected = self.applied_seq + 1
            records = batch.records or []
            start = int(batch.start_seq)
            if records:
                if start > self._expected:
                    # a batch went missing (dropped send, ring eviction
                    # upstream): ask the leader to rewind / re-sync
                    self.metrics["resyncs_requested"] += 1
                    return {"resync_from": self._expected}
                fresh = [
                    (s, item)
                    for s, item in zip(
                        range(start, start + len(records)), records
                    )
                    if s >= self._expected
                ]
                self._apply_items([item for _, item in fresh])
                if fresh:
                    self.applied_seq = fresh[-1][0]
                    self._expected = self.applied_seq + 1
            return {"applied_to": self.applied_seq}

    def _apply_items(self, items: List[tuple]) -> None:
        """Apply a contiguous run of stream items. Runs of consecutive
        WAL records apply as shard groups (the owner-sharded replay:
        per-shard order preserved, cross-shard records commute); snapshot
        barriers reset everything and cut the stream at their position.
        Caller holds self._lock."""
        run: List[tuple] = []
        for kind, payload in items:
            if kind == "snap":
                self._apply_wal_run(run)
                run = []
                self._install_snapshot(payload)
            else:
                run.append(payload)
        self._apply_wal_run(run)

    def _apply_wal_run(self, records: List[tuple]) -> None:
        if not records:
            return
        groups, residue = group_records_by_shard(
            records, record_shard_key, self._num_shards
        )
        for shard in sorted(groups):
            for rec in groups[shard]:
                self._apply_record(rec)
        for rec in residue:
            self._apply_record(rec)
        self.metrics["wal_applied"] += len(records)

    def _apply_record(self, rec: tuple) -> None:
        """One WAL record into the snapshot-shaped mirrors. Kinds match
        head._load_persisted's replay switch; unknown kinds are ignored
        (forward compatibility — a newer leader may ship records an
        older standby build cannot interpret, and losing them is exactly
        what the next snapshot barrier repairs)."""
        kind = rec[0]
        if kind == "kv_put":
            self._kv[rec[1]] = rec[2]
        elif kind == "kv_del":
            self._kv.pop(rec[1], None)
        elif kind == "actor":
            fields, spec, name = rec[1], rec[2], rec[3]
            self._actors[fields["actor_id"]] = dict(fields)
            if spec is not None:
                self._actor_specs[fields["actor_id"]] = spec
            if name:
                self._named_actors[name] = fields["actor_id"]
        elif kind == "actor_dead":
            info = self._actors.get(rec[1])
            if info is not None:
                info["state"] = "DEAD"
                name = info.get("name")
                if name and self._named_actors.get(name) == rec[1]:
                    del self._named_actors[name]
        elif kind == "task_lease":
            self._task_leases[rec[1]["lease_id"]] = dict(rec[1])
        elif kind == "task_lease_gone":
            self._task_leases.pop(rec[1], None)
        elif kind == "peer_link":
            self._peer_links[rec[1]["link_id"]] = dict(rec[1])
        elif kind == "peer_link_gone":
            self._peer_links.pop(rec[1], None)
        elif kind == "revoke_pending":
            self._pending_revokes[rec[1]["revoke_id"]] = dict(rec[1])
        elif kind == "revoke_done":
            self._pending_revokes.pop(rec[1], None)
        elif kind == "serve_fleet":
            row = rec[1]
            self._serve_fleets[row["deployment"]] = {
                "epoch": int(row.get("epoch", 0)),
                "members": list(row.get("members", ())),
            }
        elif kind == "serve_stream":
            self._serve_streams[rec[1]["stream_id"]] = dict(rec[1])
        elif kind == "serve_stream_ckpt":
            row = self._serve_streams.get(rec[1]["stream_id"])
            if row is not None:
                row["delivered"] = max(
                    int(row.get("delivered", 0)),
                    int(rec[1].get("delivered", 0)),
                )
                if rec[1].get("router_id"):
                    row["router_id"] = rec[1]["router_id"]
        elif kind == "serve_stream_gone":
            self._serve_streams.pop(rec[1], None)
        elif kind == "weights_epoch":
            # two-phase publish fence: mirror seal/commit so a promoted
            # standby exposes exactly the old or the new epoch — the
            # sealed-but-uncommitted phase survives but never reads as
            # committed (the publisher's retry re-seals + commits)
            row = rec[1]
            w = self._weights_epochs.setdefault(
                row["deployment"],
                {"committed": 0, "meta": {}, "sealed": None},
            )
            if row.get("phase") == "seal":
                w["sealed"] = {
                    "epoch": int(row["epoch"]),
                    "meta": dict(row.get("meta", {})),
                }
            else:
                w["committed"] = int(row["epoch"])
                w["meta"] = dict(row.get("meta", {}))
                w["sealed"] = None

    # -- promotion -------------------------------------------------------
    def tables_snapshot(self) -> dict:
        """The mirror tables in the leader's exact snapshot shape —
        what promotion hands the new HeadServer, and what the
        convergence test compares against the leader's
        _snapshot_state()."""
        with self._lock:
            return {
                "epoch": self.leader_epoch,
                "kv": dict(self._kv),
                "named_actors": dict(self._named_actors),
                "actors": {
                    aid: dict(f) for aid, f in self._actors.items()
                },
                "actor_specs": dict(self._actor_specs),
                "jobs": list(self._jobs),
                "leases": dict(self._leases),
                "unfinished_leases": list(self._unfinished_leases),
                "task_leases": [
                    dict(r) for r in self._task_leases.values()
                ],
                "peer_links": [
                    dict(r) for r in self._peer_links.values()
                ],
                "streams": {
                    tid: dict(st) for tid, st in self._streams.items()
                },
                "stream_tombstones": list(self._stream_tombstones),
                "stream_inline": dict(self._stream_inline),
                "pending_revokes": {
                    rid: dict(r)
                    for rid, r in self._pending_revokes.items()
                },
                "serve_fleets": {
                    dep: dict(f)
                    for dep, f in self._serve_fleets.items()
                },
                "weights_epochs": {
                    dep: dict(w)
                    for dep, w in self._weights_epochs.items()
                },
                "serve_streams": [
                    dict(r) for r in self._serve_streams.values()
                ],
            }

    def promote(
        self,
        port: Optional[int] = None,
        host: str = "127.0.0.1",
        bind_timeout_s: float = 10.0,
    ):
        """Fenced promotion: epoch bump + listener bind. Binds the dead
        leader's port by default (agents/clients reconnect untouched —
        their next stamped RPC is fenced stale and they re-register,
        exactly the restart resync protocol). On one host the bind
        doubles as a leadership interlock: a leader that is actually
        alive still holds its port and the promotion aborts."""
        with self._lock:
            if self.promoted is not None:
                return self.promoted
            if self.role == "promoting":
                raise RuntimeError("promotion already in flight")
            self.role = "promoting"
        t0 = time.monotonic()
        try:
            head = self._promote_inner(port, host, bind_timeout_s)
        except BaseException:
            # ANY failure (bind interlock, handoff backend I/O, ...)
            # returns this standby to following — a wedged "promoting"
            # role would block every later attempt
            with self._lock:
                if self.promoted is None:
                    self.role = "standby"
            raise
        elapsed_ms = (time.monotonic() - t0) * 1e3
        FAILOVER_MS.observe(elapsed_ms)
        # the head is published once on_promoted has run, so a caller of
        # wait_promoted() finds the cluster already holding it (the
        # reference publishes first and runs the callback after)
        self._finish_promote(head, elapsed_ms)
        with self._lock:
            self.promoted = head
            self.role = "leader"
        return head

    def _promote_inner(self, port, host, bind_timeout_s):
        snap = self.tables_snapshot()
        from .head import HeadServer
        from .persistence import (
            FilePersistence,
            HandoffPersistence,
            MemPersistence,
        )

        inner = (
            FilePersistence(self.persist_path)
            if self.persist_path
            else MemPersistence()
        )
        backend = HandoffPersistence(inner, snap)
        if port is None:
            port = int(self.leader_address.rsplit(":", 1)[1])
        deadline = time.monotonic() + bind_timeout_s
        while True:
            try:
                return HeadServer(
                    host=host,
                    port=port,
                    use_device_scheduler=self.use_device_scheduler,
                    persist_path=self.persist_path,
                    persist_backend=backend,
                )
            except RpcError:
                # port still held (late TIME_WAIT, or the leader is in
                # fact alive): retry briefly, then abort the promotion.
                # Each retry re-loads the SAME handoff snapshot —
                # HandoffPersistence.load() is not consumed on read.
                if time.monotonic() >= deadline:
                    logger.warning(
                        "promotion aborted: could not bind %s:%d "
                        "(leader still alive?)",
                        host,
                        port,
                    )
                    raise
                time.sleep(0.05)

    def _finish_promote(self, head, elapsed_ms: float):
        logger.warning(
            "standby %s promoted to leader at %s (epoch %d -> %d, "
            "%.0f ms)",
            self.standby_id[:8],
            head.address,
            self.leader_epoch,
            head.cluster_epoch,
            elapsed_ms,
        )
        try:
            # failover is a post-mortem moment: the promoted
            # head snapshots a flight-recorder bundle of what it
            # inherited, and the promotion lands as a trace span
            from ray_tpu_torch.util.tracing import SPANS

            SPANS.record(
                "head_failover",
                "control",
                time.time() - elapsed_ms / 1e3,
                elapsed_ms / 1e3,
                pid="head",
                from_epoch=self.leader_epoch,
                to_epoch=head.cluster_epoch,
            )
            head._dump_crash_bundle(
                f"head-failover-epoch{head.cluster_epoch}"
            )
        except Exception:  # noqa: BLE001 - observability only
            logger.debug("failover bundle failed", exc_info=True)
        cb = self.on_promoted
        if cb is not None:
            try:
                cb(head)
            except Exception:  # noqa: BLE001 - observer only
                logger.exception("on_promoted callback failed")
        return head

    # -- leader election (strike-based, agents' health shape) -----------
    def _watch_loop(self) -> None:
        strikes = 0
        client = RpcClient(self.leader_address)
        try:
            while not self._shutdown:
                threshold = max(1, int(cfg.head_miss_threshold))
                window = max(
                    0.05, float(cfg.head_health_timeout_s) / threshold
                )
                time.sleep(window)
                with self._lock:
                    if self._shutdown or self.role != "standby":
                        return
                    seen_gap = time.monotonic() - self._leader_seen
                if seen_gap < window:
                    # shipped batches ARE liveness: no probe needed
                    strikes = 0
                    continue
                try:
                    client.call("Ping", timeout=max(0.2, window))
                    strikes = 0
                    self._leader_seen = time.monotonic()
                    # leader alive but silent on the ship stream (its
                    # keepalives stopped): it dropped us during an
                    # outage on OUR side — re-hello to re-register and
                    # re-bootstrap (resync, not an error)
                    if (
                        time.monotonic() - self._last_batch
                        > max(3.0, 5.0 * window)
                    ):
                        try:
                            self._hello()
                        except Exception:  # noqa: BLE001 - retried next tick
                            logger.debug(
                                "standby re-hello failed", exc_info=True
                            )
                except RpcNotLeaderError:
                    # the leader fenced itself (someone else promoted):
                    # this standby is stale — keep following; a re-hello
                    # against the hint would be the HA-pair extension
                    strikes = 0
                except (RpcError, Exception):  # noqa: BLE001
                    strikes += 1
                if strikes >= threshold:
                    logger.warning(
                        "standby %s: leader %s missed %d consecutive "
                        "probe windows; declaring it dead",
                        self.standby_id[:8],
                        self.leader_address,
                        threshold,
                    )
                    if not self.auto_promote:
                        return
                    try:
                        self.promote()
                    except Exception:  # noqa: BLE001
                        # bind interlock (leader alive after all), disk
                        # error building the handoff backend, a racing
                        # manual promote — whatever it was, the watch
                        # must SURVIVE it: resume following with a clean
                        # slate and try again on the next strike-out,
                        # never die silently leaving the cluster
                        # leaderless
                        logger.exception(
                            "standby %s promotion attempt failed; "
                            "resuming watch",
                            self.standby_id[:8],
                        )
                        with self._lock:
                            if self.promoted is None:
                                self.role = "standby"
                        strikes = 0
                        continue
                    return
        finally:
            client.close()

    # -- RPC surface -----------------------------------------------------
    def _h_head_role(self, req) -> dict:
        with self._lock:
            head = self.promoted
            return {
                "role": "leader" if head is not None else self.role,
                "standby_id": self.standby_id,
                "epoch": (
                    head.cluster_epoch
                    if head is not None
                    else self.leader_epoch
                ),
                "leader_hint": (
                    head.address if head is not None else ""
                ),
            }

    def _h_query_state(self, req) -> dict:
        with self._lock:
            return {
                "role": self.role,
                "standby_id": self.standby_id,
                "leader": self.leader_address,
                "leader_epoch": self.leader_epoch,
                "applied_seq": self.applied_seq,
                "metrics": dict(self.metrics),
                "shards": {
                    "task_leases": self._task_leases.shard_sizes(),
                    "peer_links": self._peer_links.shard_sizes(),
                },
                "tables": {
                    "kv": len(self._kv),
                    "actors": len(self._actors),
                    "leases": len(self._leases),
                    "task_leases": len(self._task_leases),
                    "peer_links": len(self._peer_links),
                    "pending_revokes": len(self._pending_revokes),
                    "serve_fleets": len(self._serve_fleets),
                    "weights_epochs": len(self._weights_epochs),
                    "serve_streams": len(self._serve_streams),
                },
            }

    def shutdown(self) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        self._server.stop()

    def wait_promoted(self, timeout: float = 30.0):
        """Block until this standby's auto-promotion completed; returns
        the promoted HeadServer (or None on timeout)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self.promoted is not None:
                    return self.promoted
            time.sleep(0.05)
        return None
