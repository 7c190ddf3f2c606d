"""Leader-side control-plane replication: WAL shipping to warm standbys.

The head's persistence stream (WAL records + debounced snapshots,
persistence.py) doubles as a replication stream: every durable record
gets a monotonically increasing sequence number and lands in a bounded
in-memory ring; a shipper thread pushes ``ReplWal`` batches to every
registered :class:`~ray_tpu_torch.cluster.standby.StandbyHead` over the
ordinary RPC layer. Snapshots enter the ring as seq-stamped barriers —
captured while the persist lock is held, so a barrier can never be
ordered ahead of a record it does not contain (records racing the
capture double-apply, which is idempotent; nothing is ever lost).

Gap handling is the standby's ``resync_from`` reply: the shipper rewinds
to the requested seq when the ring still holds it, or ships a fresh
snapshot + tail when it fell off (``wal_ship_resyncs_total``). Shipping
is asynchronous by default; ``RAY_TPU_WAL_SHIP_ACKED=1`` makes the WAL
flush wait (bounded) for standby acks.

A standby that answers ``{"fenced": epoch}`` has promoted: the hub
routes that into the head's step-down path — the deposed leader fences
itself off its own shipping stream, no external coordinator needed.

Every batch the shipper sends crosses as its wire frame in pieces of at
most ``PIECE_BYTES`` (``ReplWalPiece``), which the standby joins and
applies as one ``ReplWal``; a bootstrap snapshot past it follows the
hello as a re-sync. One creation payload (a deployment closure's
weights) can outgrow the RPC message limit (``rpc._MAX_MSG``), and a
barrier that never ships leaves the standby frozen behind it. The
reference ships each batch as one message (``ray_tpu/cluster/head.py:668``
snapshots the payloads whole).

Port of ``ray_tpu/cluster/replication.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch.config import cfg
from ray_tpu_torch.util.metrics import Counter as _Counter
from ray_tpu_torch.util.metrics import Gauge as _Gauge
from ray_tpu_torch.util.metrics import Histogram as _Histogram

logger = logging.getLogger("ray_tpu_torch.cluster.replication")

# 1 for this process's current head role, 0 for the others — one gauge,
# role as label, so dashboards see transitions (leader -> fenced) as a
# flip, not a new series
HEAD_ROLE = _Gauge(
    "head_role",
    "1 for this head process's current role (leader|standby|fenced).",
    label_names=("role",),
)
WAL_SHIPPED = _Counter(
    "wal_shipped_total",
    "WAL records (and snapshot barriers) acked by standbys.",
)
WAL_SHIP_LAG = _Gauge(
    "wal_ship_lag_records",
    "Largest standby replication lag in records (leader seq - ack).",
)
WAL_SHIP_RESYNCS = _Counter(
    "wal_ship_resyncs_total",
    "Standby re-syncs (gap past the ring -> fresh snapshot shipped).",
)
FAILOVER_MS = _Histogram(
    "failover_ms",
    "Standby promotion latency: leader-declared-dead to the promoted "
    "head's listener bound and serving.",
    boundaries=(10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 15000),
)

_ROLES = ("leader", "standby", "fenced")

# the largest piece of a shipped batch's frame, well below rpc._MAX_MSG
PIECE_BYTES = 64 << 20


def frame_too_big(obj) -> bool:
    """Whether ``obj``'s wire frame is longer than one piece."""
    from . import serialization as wire

    return len(wire.dumps(obj)) > PIECE_BYTES


def ship_in_pieces(client, batch, timeout: float):
    """Send a ``WalShipBatch`` as its frame in pieces of at most
    ``PIECE_BYTES``; returns the standby's reply to the whole batch, or
    its reply to the first piece it did not take (a fence, a gap)."""
    from . import serialization as wire

    blob = wire.dumps(batch)
    count = max(1, -(-len(blob) // PIECE_BYTES))
    xfer = uuid.uuid4().hex
    reply = None
    for i in range(count):
        piece = blob if count == 1 else blob[i * PIECE_BYTES:(i + 1) * PIECE_BYTES]
        reply = client.call(
            "ReplWalPiece",
            {"xfer": xfer, "index": i, "count": count, "data": piece},
            timeout=timeout,
        )
        if i < count - 1 and reply != {"piece": i}:
            return reply
    return reply


def set_role(role: str) -> None:
    for r in _ROLES:
        HEAD_ROLE.set(1.0 if r == role else 0.0, labels={"role": r})


# a standby unreachable for this many consecutive ship attempts is
# dropped from the registry (it re-hellos when it returns); generous —
# a dropped standby silently stops replicating
_STANDBY_MAX_STRIKES = 8


class ReplicationHub:
    """Sequenced replication ring + standby registry + shipper thread.

    ``publish``/``publish_snapshot`` are called with the head's persist
    lock held — that lock is what serializes seq assignment with the
    on-disk WAL/snapshot order. The shipper thread takes only this hub's
    own lock, so acked waits can never deadlock against it.
    """

    def __init__(self, head):
        self._head = head
        self._cv = threading.Condition()
        self.seq = 0
        # (seq, ("wal", record) | ("snap", snapshot_dict))
        self._ring: deque = deque()
        self._standbys: Dict[str, dict] = {}
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    # -- stream production (leader, under the persist lock) -------------
    def publish(self, records) -> int:
        """Append WAL records to the replication stream; returns the last
        assigned seq (0 when replication is inert)."""
        if not records:
            return 0
        with self._cv:
            if self._stopped:
                return 0
            # with no standby registered the ring retains nothing (a
            # late joiner bootstraps from a fresh snapshot at the
            # current seq); seq still advances so positions stay valid
            retain = bool(self._standbys)
            for rec in records:
                self.seq += 1
                if retain:
                    self._ring.append((self.seq, ("wal", rec)))
            self._trim_locked()
            last = self.seq
            if retain:
                self._cv.notify_all()
        return last

    def publish_snapshot(self, snap: dict) -> int:
        """A snapshot barrier: the standby resets its tables from it.
        Must be called while the caller still holds the persist lock the
        snapshot was captured under (see module docstring ordering
        argument)."""
        with self._cv:
            if self._stopped:
                return 0
            self.seq += 1
            if self._standbys:
                self._ring.append((self.seq, ("snap", snap)))
                self._trim_locked()
                self._cv.notify_all()
            return self.seq

    def _trim_locked(self) -> None:
        cap = max(64, int(cfg.wal_ship_ring))
        while len(self._ring) > cap:
            self._ring.popleft()

    # -- standby registry -----------------------------------------------
    def register_standby(
        self, standby_id: str, address: str, from_seq: int
    ) -> None:
        """Ship to ``address`` from ``from_seq`` on."""
        with self._cv:
            if self._stopped:
                return
            old = self._standbys.get(standby_id)
            if old is not None and old.get("client") is not None:
                try:
                    old["client"].close()
                except Exception:  # noqa: BLE001
                    pass
            self._standbys[standby_id] = {
                "address": address,
                "acked": int(from_seq),
                "strikes": 0,
                "client": None,
                "last_sent": time.monotonic(),
                "resync": False,
            }
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._ship_loop,
                    name="head-wal-shipper",
                    daemon=True,
                )
                self._thread.start()
            self._cv.notify_all()
        logger.info(
            "standby %s registered at %s (from seq %d)",
            standby_id[:8],
            address,
            from_seq,
        )

    def resync_standby(self, standby_id: str) -> None:
        """Ship ``standby_id`` a fresh snapshot before anything else (its
        bootstrap snapshot was too big for the hello's reply)."""
        with self._cv:
            e = self._standbys.get(standby_id)
            if e is not None:
                e["resync"] = True
                self._cv.notify_all()

    def wait_acked(self, seq: int, timeout: float) -> bool:
        """Acked shipping: block until every live standby applied
        ``seq`` (or none are registered / the timeout passes)."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cv:
            while not self._stopped:
                live = [
                    e
                    for e in self._standbys.values()
                    if e["strikes"] < _STANDBY_MAX_STRIKES
                ]
                if not live or all(e["acked"] >= seq for e in live):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.1))
        return False

    # -- shipping --------------------------------------------------------
    def _ship_loop(self) -> None:
        while True:
            with self._cv:
                if self._stopped:
                    return
                pending = any(
                    e["acked"] < self.seq or e["resync"]
                    for e in self._standbys.values()
                )
                if not self._standbys or not pending:
                    self._cv.wait(timeout=0.2)
                    if self._stopped:
                        return
                targets = list(self._standbys.keys())
            struck_before = self._total_strikes()
            for sid in targets:
                try:
                    self._ship_to(sid)
                except Exception:  # noqa: BLE001 - one standby, one strike
                    logger.exception("WAL ship to standby %s failed", sid[:8])
                    self._strike(sid)
            self._keepalives()
            self._update_lag()
            if self._total_strikes() > struck_before:
                # an unreachable standby must accrue strikes on a real
                # clock, not at connect-refused speed — a sub-second
                # blip would otherwise burn the whole strike budget
                time.sleep(0.25)

    def _total_strikes(self) -> int:
        with self._cv:
            return sum(e["strikes"] for e in self._standbys.values())

    def _keepalives(self) -> None:
        """An up-to-date standby still needs to hear from the leader:
        the shipped stream is its liveness signal (and a standby the
        leader silently dropped notices the silence and re-hellos)."""
        from .common import WalShipBatch
        from .rpc import RpcError

        now = time.monotonic()
        with self._cv:
            due = [
                (sid, e["acked"])
                for sid, e in self._standbys.items()
                if e["acked"] >= self.seq
                and now - e.get("last_sent", 0.0) > 1.0
            ]
        for sid, acked in due:
            client = self._client_for(sid)
            if client is None:
                continue
            try:
                reply = client.call(
                    "ReplWal",
                    WalShipBatch(
                        epoch=self._head.cluster_epoch,
                        leader=self._head.address,
                        start_seq=acked + 1,
                    ),
                    timeout=5.0,
                )
            except RpcError:
                self._strike(sid)
                continue
            if isinstance(reply, dict) and "fenced" in reply:
                self._head._step_down(
                    int(reply["fenced"]),
                    "standby promoted over us",
                    leader_hint=reply.get("leader", ""),
                )
                return
            with self._cv:
                e = self._standbys.get(sid)
                if e is not None:
                    e["last_sent"] = now
                    e["strikes"] = 0

    def _client_for(self, sid: str):
        from .rpc import RpcClient

        with self._cv:
            e = self._standbys.get(sid)
            if e is None:
                return None
            if e["client"] is None:
                e["client"] = RpcClient(e["address"])
            return e["client"]

    def _ship_to(self, sid: str) -> None:
        from .rpc import RpcError

        while True:
            with self._cv:
                e = self._standbys.get(sid)
                if e is None or self._stopped:
                    return
                acked = e["acked"]
                if acked >= self.seq and not e["resync"]:
                    return
                ring_start = self._ring[0][0] if self._ring else self.seq + 1
                behind_ring = acked + 1 < ring_start or e["resync"]
                batch_cap = max(1, int(cfg.wal_ship_batch))
                items = (
                    []
                    if behind_ring
                    else [
                        (s, item)
                        for s, item in self._ring
                        if s > acked
                    ][:batch_cap]
                )
            if behind_ring:
                self._resync(sid)
                return
            if not items:
                return
            from .common import WalShipBatch

            payload = WalShipBatch(
                epoch=self._head.cluster_epoch,
                leader=self._head.address,
                start_seq=items[0][0],
                records=[item for _, item in items],
            )
            client = self._client_for(sid)
            if client is None:
                return
            try:
                reply = ship_in_pieces(client, payload, timeout=10.0)
            except RpcError:
                self._strike(sid)
                return
            if not isinstance(reply, dict):
                self._strike(sid)
                return
            if "fenced" in reply:
                # the standby promoted: this leader is deposed — fence
                # ourselves off our own shipping stream
                self._head._step_down(
                    int(reply["fenced"]),
                    "standby promoted over us",
                    leader_hint=reply.get("leader", ""),
                )
                return
            if "resync_from" in reply:
                want = int(reply["resync_from"])
                WAL_SHIP_RESYNCS.inc()
                with self._cv:
                    e = self._standbys.get(sid)
                    if e is not None:
                        e["acked"] = want - 1
                        e["strikes"] = 0
                continue  # retry immediately from the rewound position
            applied = int(reply.get("applied_to", acked))
            shipped = 0
            with self._cv:
                e = self._standbys.get(sid)
                if e is not None:
                    shipped = max(0, applied - e["acked"])
                    e["acked"] = max(e["acked"], applied)
                    e["strikes"] = 0
                    e["last_sent"] = time.monotonic()
                    self._cv.notify_all()
            if shipped:
                WAL_SHIPPED.inc(shipped)
            else:
                # no progress (e.g. the standby is mid-promotion and
                # neither applies nor fences): back off to the outer
                # loop's cadence instead of re-sending in a tight spin
                return

    def _resync(self, sid: str) -> None:
        """The standby's position fell off the ring: ship a fresh
        snapshot (captured now, seq read first so the overlap
        double-applies instead of losing records) plus nothing — the
        tail records ship normally on the next pass."""
        from .rpc import RpcError

        WAL_SHIP_RESYNCS.inc()
        from .common import WalShipBatch

        from_seq = self.seq
        snap = self._head._snapshot_state()
        payload = WalShipBatch(
            epoch=self._head.cluster_epoch,
            leader=self._head.address,
            start_seq=from_seq + 1,
            snapshot=snap,
            snap_seq=from_seq,
        )
        client = self._client_for(sid)
        if client is None:
            return
        try:
            reply = ship_in_pieces(client, payload, timeout=30.0)
        except RpcError:
            self._strike(sid)
            return
        if isinstance(reply, dict) and "fenced" in reply:
            self._head._step_down(
                int(reply["fenced"]),
                "standby promoted over us",
                leader_hint=reply.get("leader", ""),
            )
            return
        if not (isinstance(reply, dict) and "applied_to" in reply):
            self._strike(sid)  # a piece went missing: ship it anew later
            return
        with self._cv:
            e = self._standbys.get(sid)
            if e is not None:
                e["acked"] = max(e["acked"], from_seq)
                e["strikes"] = 0
                e["resync"] = False
                self._cv.notify_all()

    def _strike(self, sid: str) -> None:
        with self._cv:
            e = self._standbys.get(sid)
            if e is None:
                return
            e["strikes"] += 1
            if e["strikes"] >= _STANDBY_MAX_STRIKES:
                logger.warning(
                    "standby %s unreachable for %d ship attempts; "
                    "dropping (it re-registers via StandbyHello)",
                    sid[:8],
                    e["strikes"],
                )
                dead = self._standbys.pop(sid)
                if dead.get("client") is not None:
                    try:
                        dead["client"].close()
                    except Exception:  # noqa: BLE001
                        pass
            self._cv.notify_all()

    def _update_lag(self) -> None:
        with self._cv:
            lags = [
                self.seq - e["acked"] for e in self._standbys.values()
            ]
        WAL_SHIP_LAG.set(float(max(lags) if lags else 0))

    # -- lifecycle / observability --------------------------------------
    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            standbys = list(self._standbys.values())
            self._standbys.clear()
            self._cv.notify_all()
        for e in standbys:
            if e.get("client") is not None:
                try:
                    e["client"].close()
                except Exception:  # noqa: BLE001
                    pass

    def state(self) -> dict:
        with self._cv:
            return {
                "seq": self.seq,
                "ring_records": len(self._ring),
                "standbys": [
                    {
                        "standby_id": sid,
                        "address": e["address"],
                        "acked_seq": e["acked"],
                        "lag_records": self.seq - e["acked"],
                        "strikes": e["strikes"],
                    }
                    for sid, e in self._standbys.items()
                ],
            }
