"""Horizontally scaled ingress: the router fleet.

Port of ``ray_tpu/serve/fleet.py`` (no JAX in it). ``HashRing`` hashes
with ``zlib.crc32``, so its assignment equals the reference's for the same
members and keys.

The standby head removed the head as a single point of failure; this module does
the same for the serving-plane front door. One deployment's ingress is
now N :class:`~.router.ServeRouter` replicas behind a consistent-hash
tenant→router assignment:

- **Assignment** — the head owns the member list and a monotone
  *assignment epoch* per deployment (``ServeFleetJoin`` /
  ``ServeFleetLeave``), published via ``QueryState("serve")``. Both
  sides derive the hash ring deterministically from the member ids
  (crc32 virtual nodes — never Python ``hash``), so the head and every
  fleet client agree on ownership without shipping ring state.
- **Sharded admission, global fairness** — each router runs its own
  :class:`~.admission.AdmissionController` token bucket. A reconcile
  loop (``serve_budget_reconcile_s``) reports per-tenant usage/demand
  to the head and receives this router's share of the GLOBAL admission
  rate, split ∝ the summed WFQ weights of the tenants active on it
  (Gavel-style partition+reconcile, arxiv 2008.09213): a weight-3
  tenant drains ~3× a weight-1 tenant even when the two land on
  different routers — weighted fairness is a cluster-wide invariant,
  not a per-process accident (Synergy, arxiv 2110.06073).
- **Token-exact router failover** — every resumable
  :class:`FleetStream`'s delivered count checkpoints into the head's
  replicated stream-lease table (``ShardedTable`` + WAL, the standby's
  machinery, so a promoted standby inherits the rows). When a router
  dies mid-stream, the sibling inheriting the tenant's hash range
  re-dispatches with ``resume_from=<checkpointed delivered>``; the
  consumer-side skip window discards the (checkpoint .. locally-acked)
  overlap, so acked deltas are neither duplicated nor dropped even
  when the table checkpoint lags the consumer.
- **Epoch fencing** — every acquire/checkpoint/budget RPC is stamped
  with the assignment epoch; a deposed router's late traffic is
  rejected with a typed stale reply (``RouterDeposedError``), mirroring
  the cluster-epoch fence on every other control surface.

Off-cluster (in-process runtime) the same protocol runs against a
:class:`_LocalFleetCoordinator`, so fleet semantics are unit-testable
head-free.
"""
from __future__ import annotations

import threading
import time
import uuid
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

from .admission import AdmissionController, controller_from_cfg
from .router import ChannelClosed, RouterKilled, ServeRouter

SERVE_ROUTERS_LIVE = Gauge(
    "serve_routers_live",
    "Live ingress routers in the fleet, per deployment.",
    label_names=("deployment",),
)
SERVE_ROUTER_FAILOVERS = Counter(
    "serve_router_failovers_total",
    "Mid-stream ROUTER failovers (cross-router re-dispatches).",
    label_names=("deployment",),
)
SERVE_ROUTER_FAILOVER_S = Histogram(
    "serve_router_failover_s",
    "Router-death to sibling re-dispatch latency (s).",
    boundaries=(0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0),
    label_names=("deployment",),
)


class RouterDeposedError(RuntimeError):
    """Epoch fence: the control RPC was stamped with a stale assignment
    epoch — the sender was deposed (its hash ranges moved)."""

    def __init__(self, current_epoch: int, detail: str = ""):
        super().__init__(
            f"stale assignment epoch (current {current_epoch})"
            + (f": {detail}" if detail else "")
        )
        self.current_epoch = int(current_epoch)


# ---------------------------------------------------------------------------
# consistent-hash assignment
# ---------------------------------------------------------------------------
class HashRing:
    """Tenant→router consistent hashing over crc32 virtual nodes.

    Derived purely from ``(members, vnodes)``: the head and every
    client rebuild the identical ring from the published member list —
    stable across processes and restarts (crc32, never Python ``hash``,
    exactly like :func:`~ray_tpu_torch.cluster.shards.shard_of`). Removing a
    member moves ONLY the ranges it owned to the surviving siblings."""

    def __init__(self, members: List[str], vnodes: int = 64):
        self.members = sorted(set(members))
        self.vnodes = max(1, int(vnodes))
        self._ring: List[Tuple[int, str]] = sorted(
            (zlib.crc32(f"{m}#{v}".encode()), m)
            for m in self.members
            for v in range(self.vnodes)
        )

    def owner(self, key: str) -> str:
        if not self._ring:
            raise RuntimeError("hash ring is empty (no live routers)")
        h = zlib.crc32(key.encode() if isinstance(key, str) else key)
        # first vnode clockwise of the key's point (wraps)
        lo, hi = 0, len(self._ring)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._ring[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        return self._ring[lo % len(self._ring)][1]


# ---------------------------------------------------------------------------
# budget arithmetic (shared by the head handler and the local coordinator)
# ---------------------------------------------------------------------------
def compute_budget_shares(
    reports: Dict[str, dict],
    qps: float,
    burst: float,
    window_s: float,
) -> Dict[str, dict]:
    """Split the global admission rate across routers ∝ the summed WFQ
    weights of the tenants ACTIVE on each (active = admitted or parked
    demand in the last reconcile window). ``reports`` maps router_id →
    ``{"usage": {tenant: n}, "waiting": {tenant: n},
    "weights": {tenant: w}}``.

    An idle router keeps a small floor share (2% of global) so a cold
    tenant's first burst is not starved for a full reconcile window.
    ``headroom`` says whether the CLUSTER-wide admitted rate is below
    the global budget — the honest retry hint when one shard's bucket
    is dry (see ``AdmissionController.note_global_budget``)."""
    rids = sorted(reports)
    if not rids:
        return {}
    if qps <= 0:
        # unlimited global rate: shards stay unlimited too
        return {
            rid: {"rate": 0.0, "burst": burst, "headroom": True}
            for rid in rids
        }
    weights: Dict[str, float] = {}
    for rep in reports.values():
        weights.update(rep.get("weights") or {})

    def _wt(tenant: str) -> float:
        return max(1e-6, float(weights.get(tenant, 1.0)))

    active_w: Dict[str, float] = {}
    for rid in rids:
        rep = reports[rid]
        active = {
            t for t, n in (rep.get("usage") or {}).items() if n > 0
        } | {t for t, n in (rep.get("waiting") or {}).items() if n > 0}
        active_w[rid] = sum(_wt(t) for t in active)
    total_w = sum(active_w.values())
    used = sum(
        sum((reports[rid].get("usage") or {}).values()) for rid in rids
    )
    headroom = used < qps * max(window_s, 1e-3) * 0.95
    out: Dict[str, dict] = {}
    for rid in rids:
        frac = (
            active_w[rid] / total_w if total_w > 0 else 1.0 / len(rids)
        )
        out[rid] = {
            "rate": max(qps * frac, 0.02 * qps),
            "burst": max(1.0, burst * max(frac, 0.05)),
            "headroom": headroom,
        }
    return out


# ---------------------------------------------------------------------------
# coordinators: who owns the assignment table + stream leases
# ---------------------------------------------------------------------------
class _LocalFleetCoordinator:
    """In-process assignment/lease authority for the off-cluster
    runtime: the exact head protocol (epochs, fencing, stream rows,
    budget shares) against process-local dicts, so every fleet
    code path — including the fences — runs identically in unit
    tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fleets: Dict[str, dict] = {}  # dep -> {"epoch","members"}
        self._streams: Dict[str, dict] = {}  # stream_id -> row
        self._budget: Dict[str, dict] = {}  # dep -> rid -> report

    # -- membership -----------------------------------------------------
    def join(self, deployment: str, router_id: str) -> dict:
        with self._lock:
            f = self._fleets.setdefault(
                deployment, {"epoch": 0, "members": []}
            )
            if router_id not in f["members"]:
                f["members"] = sorted(f["members"] + [router_id])
                f["epoch"] += 1
            return {"epoch": f["epoch"], "members": list(f["members"])}

    def leave(self, deployment: str, router_id: str) -> dict:
        with self._lock:
            f = self._fleets.setdefault(
                deployment, {"epoch": 0, "members": []}
            )
            if router_id in f["members"]:
                f["members"] = [
                    m for m in f["members"] if m != router_id
                ]
                f["epoch"] += 1
            (self._budget.get(deployment) or {}).pop(router_id, None)
            return {"epoch": f["epoch"], "members": list(f["members"])}

    def assignment(self, deployment: str) -> dict:
        with self._lock:
            f = self._fleets.get(deployment) or {
                "epoch": 0,
                "members": [],
            }
            return {"epoch": f["epoch"], "members": list(f["members"])}

    # -- stream leases ---------------------------------------------------
    def _fence_locked(self, deployment: str, epoch: int) -> None:
        f = self._fleets.get(deployment)
        cur = f["epoch"] if f else 0
        if int(epoch) != cur:
            raise RouterDeposedError(cur)

    def stream_acquire(
        self,
        deployment: str,
        router_id: str,
        epoch: int,
        stream_id: str,
        tenant: str,
        delivered: int,
    ) -> dict:
        with self._lock:
            self._fence_locked(deployment, epoch)
            row = self._streams.get(stream_id) or {
                "stream_id": stream_id,
                "deployment": deployment,
                "tenant": tenant,
                "delivered": 0,
            }
            row["router_id"] = router_id
            row["delivered"] = max(
                int(row["delivered"]), int(delivered)
            )
            self._streams[stream_id] = row
            return dict(row)

    def stream_ckpt(
        self,
        deployment: str,
        router_id: str,
        epoch: int,
        ckpts: Dict[str, int],
    ) -> None:
        with self._lock:
            self._fence_locked(deployment, epoch)
            for sid, delivered in ckpts.items():
                row = self._streams.get(sid)
                if row is None or row["router_id"] != router_id:
                    continue  # moved to a sibling: the ckpt is stale
                row["delivered"] = max(
                    int(row["delivered"]), int(delivered)
                )

    def stream_release(self, stream_ids) -> None:
        with self._lock:
            for sid in stream_ids:
                self._streams.pop(sid, None)

    def stream_lookup(self, stream_id: str) -> Optional[dict]:
        with self._lock:
            row = self._streams.get(stream_id)
            return dict(row) if row else None

    # -- budget ----------------------------------------------------------
    def budget(
        self,
        deployment: str,
        router_id: str,
        epoch: int,
        usage: Dict[str, int],
        waiting: Dict[str, int],
        weights: Dict[str, float],
        pressure: Optional[Dict[str, dict]] = None,
    ) -> dict:
        from ray_tpu_torch.config import cfg

        window = max(0.05, float(cfg.serve_budget_reconcile_s))
        with self._lock:
            self._fence_locked(deployment, epoch)
            members = set(
                (self._fleets.get(deployment) or {}).get("members", ())
            )
            reports = self._budget.setdefault(deployment, {})
            reports[router_id] = {
                "usage": dict(usage),
                "waiting": dict(waiting),
                "weights": dict(weights or {}),
                "pressure": dict(pressure or {}),
                "ts": time.monotonic(),
            }
            now = time.monotonic()
            fresh = {
                rid: rep
                for rid, rep in reports.items()
                if rid in members and now - rep["ts"] < 3.0
            }
            shares = compute_budget_shares(
                fresh,
                float(cfg.serve_admission_qps),
                float(cfg.serve_admission_burst),
                window,
            )
            share = shares.get(router_id) or {
                "rate": 0.0,
                "burst": float(cfg.serve_admission_burst),
                "headroom": True,
            }
            hint = _capacity_hint_local(fresh)
        # capacity_hint is ALWAYS present: None is the positive "demand
        # drained" signal that clears the fleet's hold-capacity latch
        # immediately (hold-capacity latch fix) instead of letting a
        # stale blocking hint ride out its staleness window
        reply = {**share, "window_s": window}
        reply["capacity_hint"] = hint
        return reply


def _capacity_hint_local(fresh: Dict[str, dict]) -> Optional[dict]:
    """Serve pressure → capacity hint for the OFF-cluster coordinator:
    the same demand-row kernel path the head runs, against this
    process's CPU count as the lone avail row — so unit tests exercise
    the full pressure→kernel→hint loop without a cluster. The program runs
    on the scheduler's device (``cfg.sched_platform``)."""
    try:
        from ray_tpu_torch.config import cfg
        from ray_tpu_torch.core.runtime import _scheduler_device
        from ray_tpu_torch.scheduler.serve_demand import (
            capacity_plan,
            pressure_rollup,
        )

        pressure = pressure_rollup(fresh)
        if not pressure:
            return None
        import os

        return capacity_plan([float(os.cpu_count() or 1)], pressure,
                             device=_scheduler_device(cfg.sched_platform))
    except Exception:  # noqa: BLE001 - hint is advisory, never fatal
        return None


class _HeadFleetCoordinator:
    """The on-cluster authority: every call is one head RPC against the
    replicated assignment/stream-lease tables (WAL-persisted, standby-
    mirrored). Stale-epoch replies surface as
    :class:`RouterDeposedError` — the same typed fence the local
    coordinator raises."""

    def __init__(self, rt):
        self._rt = rt

    def _call(self, method: str, req: dict, timeout: float = 5.0):
        reply = self._rt.head.call(method, req, timeout=timeout)
        if isinstance(reply, dict) and reply.get("stale"):
            raise RouterDeposedError(int(reply.get("epoch") or 0), method)
        return reply

    def join(self, deployment: str, router_id: str) -> dict:
        return self._call(
            "ServeFleetJoin",
            {"deployment": deployment, "router_id": router_id},
        )

    def leave(self, deployment: str, router_id: str) -> dict:
        return self._call(
            "ServeFleetLeave",
            {"deployment": deployment, "router_id": router_id},
        )

    def assignment(self, deployment: str) -> dict:
        return self._call("ServeAssignment", {"deployment": deployment})

    def stream_acquire(
        self, deployment, router_id, epoch, stream_id, tenant, delivered
    ) -> dict:
        reply = self._call(
            "ServeStreamAcquire",
            {
                "deployment": deployment,
                "router_id": router_id,
                "epoch": int(epoch),
                "stream_id": stream_id,
                "tenant": tenant,
                "delivered": int(delivered),
            },
        )
        return reply.get("row") or {}

    def stream_ckpt(self, deployment, router_id, epoch, ckpts) -> None:
        self._call(
            "ServeStreamCkpt",
            {
                "deployment": deployment,
                "router_id": router_id,
                "epoch": int(epoch),
                "ckpts": {sid: int(d) for sid, d in ckpts.items()},
            },
        )

    def stream_release(self, stream_ids) -> None:
        self._call(
            "ServeStreamRelease", {"stream_ids": list(stream_ids)}
        )

    def stream_lookup(self, stream_id: str) -> Optional[dict]:
        reply = self._call("ServeStreamLookup", {"stream_id": stream_id})
        return reply.get("row")

    def budget(
        self, deployment, router_id, epoch, usage, waiting, weights,
        pressure=None,
    ) -> dict:
        return self._call(
            "ServeBudget",
            {
                "deployment": deployment,
                "router_id": router_id,
                "epoch": int(epoch),
                "usage": dict(usage),
                "waiting": dict(waiting),
                "weights": dict(weights or {}),
                "pressure": dict(pressure or {}),
            },
        )


def _pick_coordinator():
    try:
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()
        if getattr(rt, "is_remote", False):
            return _HeadFleetCoordinator(rt)
    except Exception:  # noqa: BLE001 - no runtime yet: local authority
        pass
    return _LocalFleetCoordinator()


# ---------------------------------------------------------------------------
# fleet streams (cross-router failover)
# ---------------------------------------------------------------------------
class FleetStream:
    """Consumer view of one tenant stream routed through the fleet:
    ``read()`` yields deltas in order across transports, replica
    failovers (the inner :class:`~.router.RoutedStream`), AND router
    failovers. When the owning router dies, the sibling inheriting the
    tenant's hash range re-dispatches with ``resume_from`` taken from
    the replicated stream-lease checkpoint; the skip window discards
    the (checkpoint .. locally-acked) overlap so the continuation is
    token-exact."""

    def __init__(self, fleet: "RouterFleet", payload, tenant: str):
        self._fleet = fleet
        self._payload = payload
        self.tenant = tenant
        self.stream_id = uuid.uuid4().hex
        self.delivered = 0  # deltas handed to the consumer, fleet-level
        self.router_failovers = 0
        self._skip = 0  # failover overlap still to discard
        self._flushed = 0  # delivered count last checkpointed
        self._released = False
        self._rid, router = fleet._owner(tenant)
        self._leased = False
        self._routed = router.stream(payload, tenant)
        # the lease comes after admission: a request the router sheds
        # (Overloaded) never reaches the head. The reference leases
        # first, so under overload every shed request cost the head an
        # acquire and a release (Queue C 25 of the port). A router lost
        # before the lease lands resumes from the consumer's count.
        self._leased = fleet.resumable
        if self._leased:
            fleet._stream_acquire(self, self._rid, 0)
        fleet._track(self)

    # -- consumption ----------------------------------------------------
    def read(self, timeout: Optional[float] = None):
        while True:
            try:
                value = self._routed.read(timeout=timeout)
            except ChannelClosed:
                self._release()
                raise
            except BaseException as exc:  # noqa: BLE001
                if isinstance(
                    exc, RouterKilled
                ) or self._fleet.is_dead(self._rid):
                    self._failover(exc)
                    continue
                if not isinstance(exc, TimeoutError):
                    self._release()
                raise
            if self._skip > 0:
                # overlap between the table checkpoint we resumed from
                # and what this consumer already acked: discard, exactly
                # once each
                self._skip -= 1
                continue
            self.delivered += 1
            return value

    def __iter__(self):
        while True:
            try:
                yield self.read()
            except ChannelClosed:
                return

    # -- router failover -------------------------------------------------
    def _failover(self, exc: BaseException) -> None:
        from ray_tpu_torch.config import cfg

        fleet = self._fleet
        if not fleet.resumable:
            self._release()
            raise exc
        if self.router_failovers >= int(cfg.serve_stream_failover):
            self._release()
            raise RouterKilled(
                f"stream {self.stream_id[:8]} exhausted "
                f"{self.router_failovers} router failovers"
            ) from exc
        t0 = time.monotonic()
        self.router_failovers += 1
        SERVE_ROUTER_FAILOVERS.inc(labels=fleet._labels)
        try:
            self._routed.close()
        except Exception:  # noqa: BLE001 - corpse-side cleanup
            pass
        fleet._note_router_failure(self._rid)
        # resume point: the replicated checkpoint (what a sibling with
        # NO sight of this consumer would know), clamped by the local
        # acked count; the gap becomes the consumer-side skip window
        ckpt = None
        try:
            row = fleet._coord.stream_lookup(self.stream_id)
            if row is not None:
                ckpt = int(row.get("delivered") or 0)
        except Exception:  # noqa: BLE001 - head mid-failover
            ckpt = None
        resume = (
            min(ckpt, self.delivered) if ckpt is not None else self.delivered
        )
        self._rid, router = fleet._owner(self.tenant)
        if self._leased:
            fleet._stream_acquire(self, self._rid, self.delivered)
        self._skip = self.delivered - resume
        self._routed = router.stream(
            self._payload, self.tenant, resume_base=resume
        )
        SERVE_ROUTER_FAILOVER_S.observe(
            time.monotonic() - t0, labels=fleet._labels
        )

    # -- teardown --------------------------------------------------------
    def _release(self) -> None:
        if self._released:
            return
        self._released = True
        self._fleet._untrack(self)
        if self._leased:
            try:
                self._fleet._coord.stream_release([self.stream_id])
            except Exception:  # noqa: BLE001 - lease GC is best-effort
                pass

    def close(self) -> None:
        try:
            self._routed.close()
        except Exception:  # noqa: BLE001
            pass
        self._release()


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------
class _FleetAdmission:
    """Aggregate admission facade over the live routers' shards (the
    SLO autoscaler and dashboards read one controller-shaped stats
    blob)."""

    def __init__(self, fleet: "RouterFleet"):
        self._fleet = fleet

    def admit(self, tenant: str = "default", timeout_s=None):
        _, router = self._fleet._owner(tenant)
        return router.admission.admit(tenant, timeout_s)

    def stats(self) -> dict:
        shards = [
            (rid, r.admission.stats())
            for rid, r in self._fleet.live_routers()
        ]
        out = {
            "inflight": sum(s["inflight"] for _, s in shards),
            "waiting": sum(s["waiting"] for _, s in shards),
            "admitted": sum(s["admitted"] for _, s in shards),
            "sheds": sum(s["sheds"] for _, s in shards),
            "max_inflight": sum(s["max_inflight"] for _, s in shards),
            "qps_limit": sum(s["qps_limit"] for _, s in shards),
            "shards": {rid: s for rid, s in shards},
        }
        return out


class RouterFleet:
    """N ingress routers over ONE replica set, with consistent-hash
    tenant assignment, head-reconciled admission shards, and
    token-exact cross-router stream failover. Duck-types the single
    :class:`~.router.ServeRouter` surface (``submit``/``call``/
    ``stream``/``stats``/``admission``/``_rs``/``resumable``) so every
    existing caller — proxy, autoscaler, tests — works unchanged; with
    ``serve_routers=1`` the fleet IS the old single-router layout plus
    an assignment table of size one."""

    def __init__(
        self,
        replica_set,
        num_routers: Optional[int] = None,
        coordinator=None,
    ):
        from ray_tpu_torch.config import cfg

        self._rs_ref = replica_set
        self._dep = replica_set.dep.name
        self._labels = {"deployment": self._dep}
        self.resumable = bool(
            getattr(replica_set.dep, "resumable_streams", False)
        )
        self._weights = dict(
            getattr(replica_set.dep, "tenant_weights", None) or {}
        )
        self._coord = (
            coordinator if coordinator is not None else _pick_coordinator()
        )
        self._lock = threading.RLock()
        n = max(1, int(num_routers or cfg.serve_routers))
        self._vnodes = max(1, int(cfg.serve_ring_vnodes))
        self.routers: Dict[str, ServeRouter] = {}
        self.dead: set = set()
        self.epoch = 0
        self._ring: Optional[HashRing] = None
        self._admission_override: Optional[AdmissionController] = None
        self._streams: Dict[str, FleetStream] = {}
        self._closed = False
        self._reconciler: Optional[threading.Thread] = None
        self._reporter: Optional[threading.Thread] = None
        # last scheduler capacity hint from the budget reply (serve
        # pressure fed through the autoscaler kernel); advisory
        self._capacity_hint: Optional[dict] = None
        self._capacity_hint_ts = 0.0
        qps = float(cfg.serve_admission_qps)
        burst = float(cfg.serve_admission_burst)
        for i in range(n):
            rid = f"{self._dep}/r{i}"
            adm = controller_from_cfg(tenant_weights=self._weights)
            if n > 1 and qps > 0:
                # initial even split; the reconcile loop re-splits
                # ∝ active tenant weights within one window
                adm.set_rate(qps / n, max(1.0, burst / n))
            self.routers[rid] = ServeRouter(
                replica_set, admission=adm, router_id=rid
            )
            reply = self._coord.join(self._dep, rid)
            self.epoch = int(reply.get("epoch") or 0)
        self._rebuild_ring()
        SERVE_ROUTERS_LIVE.set(len(self.routers), labels=self._labels)
        self._start_reconciler()

    # -- assignment ------------------------------------------------------
    def _rebuild_ring(self) -> None:
        with self._lock:
            live = sorted(self.routers)
            self._ring = HashRing(live, self._vnodes) if live else None

    def _owner(self, tenant: str) -> Tuple[str, ServeRouter]:
        with self._lock:
            if self._ring is None:
                raise RouterKilled(
                    f"fleet {self._dep} has no live routers"
                )
            rid = self._ring.owner(tenant)
            return rid, self.routers[rid]

    def router_for(self, tenant: str) -> str:
        """The router id currently owning ``tenant`` (assignment
        probe)."""
        return self._owner(tenant)[0]

    def assignment(self) -> dict:
        with self._lock:
            return {
                "epoch": self.epoch,
                "members": sorted(self.routers),
                "dead": sorted(self.dead),
            }

    def _refresh_assignment(self) -> None:
        """Adopt the coordinator's current epoch + member view (after a
        stale-epoch rejection): routers the table no longer lists are
        deposed — their sinks start redirecting and their streams
        re-dispatch through the survivors."""
        try:
            view = self._coord.assignment(self._dep)
        except Exception:  # noqa: BLE001 - head mid-failover
            return
        with self._lock:
            self.epoch = max(self.epoch, int(view.get("epoch") or 0))
            members = set(view.get("members") or ())
            for rid in list(self.routers):
                if rid not in members:
                    router = self.routers.pop(rid)
                    self.dead.add(rid)
                    router.depose(self.epoch)
            self._rebuild_ring()
        SERVE_ROUTERS_LIVE.set(
            len(self.routers), labels=self._labels
        )

    def is_dead(self, rid: str) -> bool:
        with self._lock:
            return rid in self.dead

    def live_routers(self) -> List[Tuple[str, ServeRouter]]:
        with self._lock:
            return sorted(self.routers.items())

    def _note_router_failure(self, rid: str) -> None:
        """A stream observed router ``rid`` dead: make sure the fleet
        and the assignment table agree before re-routing (idempotent —
        chaos_kill_router already did both)."""
        with self._lock:
            router = self.routers.pop(rid, None)
            if router is None:
                return  # already processed
            self.dead.add(rid)
            # the ring drops the router in the same step: a stream that
            # fails over while the kill and the leave below run must not
            # be routed back to it (_owner would find no router)
            self._rebuild_ring()
        router.chaos_kill()
        try:
            reply = self._coord.leave(self._dep, rid)
            with self._lock:
                self.epoch = max(
                    self.epoch, int(reply.get("epoch") or 0)
                )
        except Exception:  # noqa: BLE001 - head mid-failover
            pass
        SERVE_ROUTERS_LIVE.set(len(self.routers), labels=self._labels)

    # -- request surface (router protocol) ------------------------------
    def submit(
        self, payload, tenant: str = "default", method: str = "__call__"
    ):
        _, router = self._owner(tenant)
        return router.submit(payload, tenant, method)

    def call(
        self,
        payload,
        tenant: str = "default",
        timeout: float = 60.0,
        method: str = "__call__",
    ):
        return self.submit(payload, tenant, method).result(timeout)

    def stream(self, payload, tenant: str = "default") -> FleetStream:
        return FleetStream(self, payload, tenant)

    # -- stream lease bookkeeping ----------------------------------------
    def _track(self, fs: FleetStream) -> None:
        with self._lock:
            self._streams[fs.stream_id] = fs

    def _untrack(self, fs: FleetStream) -> None:
        with self._lock:
            self._streams.pop(fs.stream_id, None)

    def _stream_acquire(
        self, fs: FleetStream, rid: str, delivered: int
    ) -> None:
        """Register/move one stream's lease row (epoch-fenced). A stale
        epoch triggers one assignment refresh + retry; other failures
        degrade to consumer-local resume (the stream still works, the
        table just lags)."""
        for attempt in (0, 1):
            with self._lock:
                epoch = self.epoch
            try:
                self._coord.stream_acquire(
                    self._dep,
                    rid,
                    epoch,
                    fs.stream_id,
                    fs.tenant,
                    int(delivered),
                )
                fs._flushed = int(delivered)
                return
            except RouterDeposedError:
                if attempt:
                    return
                self._refresh_assignment()
            except Exception:  # noqa: BLE001 - head mid-failover
                return

    def _flush_ckpts(self) -> None:
        """Ship dirty delivered counts into the replicated lease table
        (one batched RPC per owning router per window)."""
        from ray_tpu_torch.config import cfg

        every = max(1, int(cfg.serve_stream_ckpt_every))
        with self._lock:
            epoch = self.epoch
            by_rid: Dict[str, Dict[str, int]] = {}
            for fs in self._streams.values():
                if not fs._leased or fs.delivered - fs._flushed < every:
                    continue
                by_rid.setdefault(fs._rid, {})[
                    fs.stream_id
                ] = fs.delivered
        for rid, ckpts in by_rid.items():
            try:
                self._coord.stream_ckpt(self._dep, rid, epoch, ckpts)
            except RouterDeposedError:
                self._refresh_assignment()
                return
            except Exception:  # noqa: BLE001 - head mid-failover
                return
            with self._lock:
                for sid, delivered in ckpts.items():
                    fs = self._streams.get(sid)
                    if fs is not None:
                        fs._flushed = max(fs._flushed, delivered)

    # -- budget reconciliation -------------------------------------------
    def _start_reconciler(self) -> None:
        def loop():
            from ray_tpu_torch.config import cfg

            while not self._closed:
                time.sleep(
                    max(0.05, float(cfg.serve_budget_reconcile_s))
                )
                try:
                    self._reconcile_once()
                except Exception:  # noqa: BLE001 - must not die
                    pass

        self._reconciler = threading.Thread(
            target=loop, name=f"serve-fleet-{self._dep}", daemon=True
        )
        self._reconciler.start()

    def _reconcile_once(self) -> None:
        from ray_tpu_torch.config import cfg

        self._flush_ckpts()
        with self._lock:
            live = list(self.routers.items())
            epoch = self.epoch
        reconciled = float(cfg.serve_admission_qps) > 0
        for rid, router in live:
            adm = router.admission
            usage = adm.take_usage()
            waiting = adm.waiting_by_tenant()
            # serve pressure export: queued prefill tokens +
            # parked requests per tenant ride the budget RPC to the
            # coordinator, which feeds them as demand rows to the
            # autoscaler kernel — the reply's capacity_hint closes the
            # loop back into the SLO autoscaler
            pressure = (
                adm.pressure_by_tenant()
                if hasattr(adm, "pressure_by_tenant")
                else {}
            )
            try:
                reply = self._coord.budget(
                    self._dep, rid, epoch, usage, waiting, self._weights,
                    pressure=pressure,
                )
            except RouterDeposedError:
                self._refresh_assignment()
                return
            except Exception:  # noqa: BLE001 - head mid-failover
                continue
            if not isinstance(reply, dict):
                continue
            window = float(
                reply.get("window_s") or cfg.serve_budget_reconcile_s
            )
            if reconciled and reply.get("rate") is not None:
                adm.set_rate(
                    float(reply["rate"]), float(reply.get("burst") or 1.0)
                )
            adm.note_global_budget(
                bool(reply.get("headroom")), window
            )
            if reply.get("capacity_hint") is not None:
                with self._lock:
                    self._capacity_hint = dict(reply["capacity_hint"])
                    self._capacity_hint_ts = time.monotonic()
            elif self._capacity_hint is not None and (
                "capacity_hint" in reply or self._hint_drained(reply)
            ):
                # hold-capacity latch fix: a reconcile
                # reply carrying hint=None (pressure drained) — or one
                # proving the fleet shrank / this tenant's parked demand
                # emptied — clears the latched blocking hint NOW; the
                # SLO autoscaler must not sit in hold-capacity for up to
                # the full staleness window on a verdict about demand
                # that no longer exists
                with self._lock:
                    self._capacity_hint = None
                    self._capacity_hint_ts = 0.0

    # -- chaos -----------------------------------------------------------
    def chaos_kill_router(self, rid: Optional[str] = None, rng=None):
        """Abruptly kill one live router (chaos ``router_kill``): its
        push endpoint vanishes, its registered streams FAIL, the
        assignment table drops it (epoch bump), and the survivors
        inherit its hash ranges. Returns the victim's id, or None when
        the fleet has a lone router (killing it would be an outage, not
        a failover test)."""
        with self._lock:
            live = sorted(self.routers)
            if len(live) < 2:
                return None
            if rid is None:
                rid = (
                    rng.choice(live)
                    if rng is not None
                    else live[0]
                )
            if rid not in self.routers:
                return None
        self._note_router_failure(rid)
        return rid

    # -- router protocol: observability + lifecycle ----------------------
    @property
    def _rs(self):
        return self._rs_ref

    @property
    def admission(self):
        with self._lock:
            if self._admission_override is not None:
                return self._admission_override
            if len(self.routers) == 1:
                return next(iter(self.routers.values())).admission
        return _FleetAdmission(self)

    @admission.setter
    def admission(self, controller) -> None:
        # test lever (single-router heritage): one shared controller
        # replaces every shard
        with self._lock:
            self._admission_override = controller
            for router in self.routers.values():
                router.admission = controller

    def stats(self) -> dict:
        with self._lock:
            live = sorted(self.routers.items())
        if not live:
            return {
                "deployment": self._dep,
                "codes": {},
                "replicas": [],
                "fleet": self.assignment(),
            }
        base = live[0][1].stats()
        codes: Dict[str, int] = {}
        for _, router in live:
            for code, n in router.stats()["codes"].items():
                codes[code] = codes.get(code, 0) + n
        base["codes"] = codes
        base["admission"] = self.admission.stats()
        base["fleet"] = {
            **self.assignment(),
            "routers": {
                rid: {
                    "codes": r.stats()["codes"],
                    "admission": r.admission.stats(),
                }
                for rid, r in live
            },
            "streams_tracked": len(self._streams),
            "router_failovers": SERVE_ROUTER_FAILOVERS.value(
                self._labels
            ),
            "failover_s": SERVE_ROUTER_FAILOVER_S.summary(self._labels),
            "capacity_hint": self.capacity_hint(),
        }
        return base

    def _hint_drained(self, reply: dict) -> bool:
        """Drain evidence for replies from a coordinator that predates
        the always-present ``capacity_hint`` key: the latched blocking
        hint is moot once this fleet's routers no longer park demand
        (every tenant's waiting queue and pending-token backlog is
        empty) — the verdict described pressure that has drained."""
        try:
            with self._lock:
                live = list(self.routers.values())
            for router in live:
                adm = router.admission
                pressure = (
                    adm.pressure_by_tenant()
                    if hasattr(adm, "pressure_by_tenant")
                    else {}
                )
                for row in (pressure or {}).values():
                    if (
                        int(row.get("waiting") or 0) > 0
                        or int(row.get("waiting_tokens") or 0) > 0
                    ):
                        return False
            return True
        except Exception:  # noqa: BLE001 - advisory path only
            return False

    def capacity_hint(self, max_age_s: float = 10.0) -> Optional[dict]:
        """The scheduler's last serve-pressure capacity verdict (how
        many replica-equivalents the queued demand justifies and
        whether the cluster could place them), or None when stale or
        never reported. SLO autoscalers read it as an upscale
        corroboration signal."""
        with self._lock:
            if (
                self._capacity_hint is None
                or time.monotonic() - self._capacity_hint_ts > max_age_s
            ):
                return None
            return dict(self._capacity_hint)

    def note_ttft_sample(self, ttft_ms: float) -> None:
        for _, router in self.live_routers():
            router.note_ttft_sample(ttft_ms)
            return

    def start_reporting(
        self, extra_stats_fn: Optional[Callable[[], Any]] = None
    ) -> None:
        """One merged 1 Hz report per deployment (router protocol): the
        head's QueryState("serve") carries the fleet block — assignment
        epoch, member list, per-router admission shards."""
        from ray_tpu_torch.config import cfg
        from ray_tpu_torch.core.runtime import get_runtime

        try:
            rt = get_runtime()
        except Exception:  # noqa: BLE001
            return
        if not getattr(rt, "is_remote", False) or self._reporter is not None:
            return

        def loop():
            while not self._closed:
                time.sleep(max(0.1, float(cfg.serve_report_period_s)))
                blob = self.stats()
                if extra_stats_fn is not None:
                    try:
                        blob["engine"] = extra_stats_fn()
                    except Exception:  # noqa: BLE001
                        pass
                try:
                    rt.head.call(
                        "ReportServeState",
                        {
                            "client_id": rt.client_id,
                            "deployment": self._dep,
                            "state": blob,
                        },
                        timeout=5.0,
                    )
                except Exception:  # noqa: BLE001 - head mid-restart
                    pass

        self._reporter = threading.Thread(
            target=loop,
            name=f"serve-report-{self._dep}",
            daemon=True,
        )
        self._reporter.start()

    def close(self) -> None:
        self._closed = True
        with self._lock:
            routers = list(self.routers.items())
            self.routers.clear()
            self._ring = None
        for rid, router in routers:
            try:
                router.close()
            except Exception:  # noqa: BLE001
                pass
            try:
                self._coord.leave(self._dep, rid)
            except Exception:  # noqa: BLE001 - head already gone
                pass
        SERVE_ROUTERS_LIVE.set(0, labels=self._labels)
