"""Admission control for the serving plane.

Port of ``ray_tpu/serve/admission.py`` (no JAX in it; copied over the
port's ``util/metrics.py`` and ``config.py``).

Synergy-motivated (arxiv 2110.06073) resource-sensitive admission
instead of blind FIFO queueing: overload is rejected BEFORE any work is
accepted, with a typed :class:`Overloaded` the ingress maps to a
retryable 503 — never a silent queue that converts overload into
timeout storms. Three gates compose, checked in order:

1. **Token bucket** — sustained accept rate (``serve_admission_qps``)
   with a burst allowance; 0 disables the rate gate.
2. **In-flight depth** — admitted-but-unfinished requests are bounded
   (``serve_admission_max_inflight``); past the bound new arrivals
   queue (gate 3) or shed.
3. **Per-tenant weighted fair queueing** — arrivals that cannot be
   admitted immediately park in per-tenant queues and are granted in
   weighted virtual-finish-time order (classic WFQ): a tenant with
   weight 2 drains twice as fast as weight 1 under contention, and no
   tenant can starve another by flooding. The waiting room itself is
   bounded (``serve_admission_wait_cap``); beyond it arrivals shed
   immediately with ``reason="queue_full"``.

Every shed increments ``serve_shed_total{reason}`` and the router maps
it to ``serve_requests_total{code="503"}``.

A parked arrival sleeps until the pump grants it (which wakes it alone)
or its deadline; it polls every 50 ms only while a rate-limited bucket
may be what holds it. The reference's waiters all poll every 50 ms, and
under overload (a hundred and more parked) they starve every other
thread of the process: the router's pressure export and the in-process
head's elasticity ticks ran seconds late (Queue C 25 of the port).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Optional

from ray_tpu_torch.util.metrics import Counter, Gauge

SERVE_SHED = Counter(
    "serve_shed_total",
    "Requests shed by serving-plane admission control.",
    label_names=("reason",),
)
SERVE_QUEUE_DEPTH = Gauge(
    "serve_queue_depth",
    "Admitted-but-unfinished serving requests (router in-flight depth).",
)
SERVE_WAITING = Gauge(
    "serve_admission_waiting",
    "Arrivals parked in the admission waiting room (WFQ queues).",
)


class Overloaded(RuntimeError):
    """Typed backpressure: the serving plane refused the request BEFORE
    accepting any work. Carries a client hint for retry pacing."""

    def __init__(self, reason: str, retry_after_s: float = 1.0):
        super().__init__(
            f"serving plane overloaded ({reason}); "
            f"retry after {retry_after_s:.2f}s"
        )
        self.reason = reason
        self.retry_after_s = retry_after_s


class TokenBucket:
    """Standard token bucket; ``rate <= 0`` means unlimited."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()

    def _refill(self, now: float) -> None:
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate
        )
        self._last = now

    def try_take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        self._refill(self._clock())
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def next_available_s(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens could be available (retry hint)."""
        if self.rate <= 0:
            return 0.0
        self._refill(self._clock())
        deficit = n - self._tokens
        return max(0.0, deficit / self.rate)


class Ticket:
    """One admitted request's hold on the in-flight depth; ``done()``
    releases it (idempotent)."""

    __slots__ = ("_ctl", "_released", "tenant")

    def __init__(self, ctl: "AdmissionController", tenant: str):
        self._ctl = ctl
        self.tenant = tenant
        self._released = False

    def done(self) -> None:
        if not self._released:
            self._released = True
            self._ctl._release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.done()


class _Waiter:
    __slots__ = ("tenant", "vft", "seq", "granted", "abandoned", "cost", "wake")

    def __init__(self, tenant: str, vft: float, seq: int, wake, cost: int = 0):
        self.tenant = tenant
        self.vft = vft  # WFQ virtual finish time
        self.seq = seq
        self.granted = False
        self.abandoned = False
        # approximate prefill cost (prompt tokens): aggregated per
        # tenant into the scheduler-facing demand pressure export
        self.cost = int(cost)
        # this waiter's own condition on the controller's lock: a grant
        # wakes the granted waiter only
        self.wake = wake


class AdmissionController:
    def __init__(
        self,
        *,
        qps: float = 0.0,
        burst: float = 32.0,
        max_inflight: int = 256,
        wait_cap: int = 128,
        wait_timeout_s: float = 2.0,
        tenant_weights: Optional[Dict[str, float]] = None,
        clock=time.monotonic,
    ):
        self._bucket = TokenBucket(qps, burst, clock=clock)
        self.max_inflight = max(1, int(max_inflight))
        self.wait_cap = max(0, int(wait_cap))
        self.wait_timeout_s = float(wait_timeout_s)
        self._weights = dict(tenant_weights or {})
        self._mu = threading.RLock()
        self._cv = threading.Condition(self._mu)
        self._inflight = 0
        self._queues: Dict[str, deque] = {}
        self._waiting = 0
        self._vtime = 0.0  # global WFQ virtual time
        self._granted_pending = 0  # granted waiters not yet woken/claimed
        self._tenant_vft: Dict[str, float] = {}
        self._seq = itertools.count()
        self.sheds = 0
        self.admitted = 0
        self.wakeups = 0  # parked waiters woken and not (yet) granted
        # fleet-shard state (router fleet): per-tenant admits since the
        # last reconcile drain, plus the head's last global-budget word
        # (is there cluster-wide headroom, and how soon does the next
        # reconcile re-split rates) — used to fix the retry hint when
        # the LOCAL bucket is dry but the GLOBAL budget is not
        self._usage: Dict[str, int] = {}
        self._global_headroom = False
        self._reconcile_window_s = 0.0

    def _weight(self, tenant: str) -> float:
        return max(1e-6, float(self._weights.get(tenant, 1.0)))

    # -- the one public gate -------------------------------------------
    def admit(
        self,
        tenant: str = "default",
        timeout_s: Optional[float] = None,
        cost: int = 0,
    ) -> Ticket:
        """Admit one request or raise :class:`Overloaded`. Blocks up to
        ``timeout_s`` in the WFQ waiting room when the fast path is
        contended; a granted admission returns a :class:`Ticket` whose
        ``done()`` releases the in-flight slot. ``cost`` is the
        request's approximate prefill cost in prompt tokens — it does
        not change WFQ ordering, only the per-tenant pressure export."""
        timeout_s = (
            self.wait_timeout_s if timeout_s is None else float(timeout_s)
        )
        with self._cv:
            # fast path: nobody parked ahead of us and both gates open
            # (granted-but-unclaimed waiters already own depth slots —
            # ignoring them here would breach max_inflight under the
            # exact contention this gate exists for)
            if (
                self._waiting == 0
                and self._inflight + self._granted_pending
                < self.max_inflight
                and self._bucket.try_take()
            ):
                return self._grant_locked(tenant)
            if self._waiting >= self.wait_cap:
                return self._shed_locked("queue_full")
            waiter = self._park_locked(tenant, cost)
            deadline = time.monotonic() + timeout_s
            try:
                while True:
                    self._pump_locked()
                    if waiter.granted:
                        return self._grant_locked(tenant, pumped=True)
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return self._shed_locked("timeout", waiter)
                    if self._bucket.rate > 0:
                        # no event marks the bucket's refill: re-check it
                        remaining = min(remaining, 0.05)
                    waiter.wake.wait(timeout=remaining)
                    if not waiter.granted:
                        self.wakeups += 1
            except BaseException:
                self._abandon_locked(waiter)
                raise

    # -- internals (caller holds self._cv) -----------------------------
    def _grant_locked(self, tenant: str, pumped: bool = False) -> Ticket:
        if not pumped:
            # WFQ accounting for fast-path grants too, so virtual time
            # keeps moving and a later contended phase stays fair
            self._account_locked(tenant)
        else:
            # the pump reserved this slot when it granted the waiter
            self._granted_pending -= 1
        self._inflight += 1
        self.admitted += 1
        self._usage[tenant] = self._usage.get(tenant, 0) + 1
        SERVE_QUEUE_DEPTH.set(self._inflight)
        return Ticket(self, tenant)

    def _account_locked(self, tenant: str) -> float:
        start = max(self._vtime, self._tenant_vft.get(tenant, 0.0))
        vft = start + 1.0 / self._weight(tenant)
        self._tenant_vft[tenant] = vft
        return vft

    def _park_locked(self, tenant: str, cost: int = 0) -> _Waiter:
        waiter = _Waiter(
            tenant, self._account_locked(tenant), next(self._seq),
            threading.Condition(self._mu), cost,
        )
        self._queues.setdefault(tenant, deque()).append(waiter)
        self._waiting += 1
        SERVE_WAITING.set(self._waiting)
        return waiter

    def _pump_locked(self) -> None:
        """Grant parked waiters in WFQ order while both gates are open.
        A granted-but-unclaimed waiter reserves depth via
        ``_granted_pending`` until its thread wakes and claims it."""
        while (
            self._waiting > 0
            and self._inflight + self._granted_pending < self.max_inflight
        ):
            head = None
            for q in self._queues.values():
                while q and q[0].abandoned:
                    q.popleft()
                if q and (
                    head is None
                    or (q[0].vft, q[0].seq) < (head.vft, head.seq)
                ):
                    head = q[0]
            if head is None:
                self._waiting = 0
                SERVE_WAITING.set(0)
                return
            if not self._bucket.try_take():
                return
            self._queues[head.tenant].popleft()
            self._waiting -= 1
            SERVE_WAITING.set(self._waiting)
            self._vtime = max(self._vtime, head.vft)
            head.granted = True
            self._granted_pending += 1
            head.wake.notify()

    def _shed_locked(self, reason: str, waiter: Optional[_Waiter] = None):
        if waiter is not None:
            if waiter.granted:
                # granted between our timeout check and now: take it
                self._granted_pending -= 1
                self._inflight += 1
                self.admitted += 1
                self._usage[waiter.tenant] = (
                    self._usage.get(waiter.tenant, 0) + 1
                )
                SERVE_QUEUE_DEPTH.set(self._inflight)
                return Ticket(self, waiter.tenant)
            self._abandon_locked(waiter)
        self.sheds += 1
        SERVE_SHED.inc(labels={"reason": reason})
        hint = self._bucket.next_available_s()
        if self._global_headroom and hint > self._reconcile_window_s > 0:
            # this shard's bucket is dry but the CLUSTER budget is not:
            # the next reconcile re-splits rates toward this router's
            # demand, so the honest backoff is one reconcile window —
            # not the local bucket's (misleadingly long) refill time
            hint = self._reconcile_window_s
        raise Overloaded(reason, retry_after_s=max(0.1, hint))

    def _abandon_locked(self, waiter: _Waiter) -> None:
        if waiter.abandoned:
            return
        if waiter.granted:
            # granted but never claimed (the waiting thread was
            # interrupted before waking): return the reserved depth slot
            # and hand it to the next waiter — leaving it would shrink
            # effective max_inflight by one forever
            waiter.abandoned = True
            self._granted_pending -= 1
            self._pump_locked()
            return
        waiter.abandoned = True
        self._waiting -= 1
        SERVE_WAITING.set(self._waiting)

    def _release(self) -> None:
        with self._cv:
            self._inflight = max(0, self._inflight - 1)
            SERVE_QUEUE_DEPTH.set(self._inflight)
            self._pump_locked()

    # -- fleet sharding (router fleet budget reconciliation) -----------
    def set_rate(self, rate: float, burst: Optional[float] = None) -> None:
        """Re-split: adopt this shard's share of the global admission
        rate. Accrued tokens are clamped to the new burst so a shrinking
        share cannot be spent from the old allowance."""
        with self._cv:
            bucket = self._bucket
            bucket._refill(bucket._clock())
            bucket.rate = float(rate)
            if burst is not None:
                bucket.burst = max(1.0, float(burst))
            bucket._tokens = min(bucket._tokens, bucket.burst)
            self._pump_locked()

    def note_global_budget(
        self, headroom: bool, reconcile_window_s: float
    ) -> None:
        """The head's last budget word: whether the CLUSTER-wide rate
        has headroom, and how long until the next re-split. Shapes the
        :class:`Overloaded` retry hint (see ``_shed_locked``)."""
        with self._cv:
            self._global_headroom = bool(headroom)
            self._reconcile_window_s = float(reconcile_window_s)

    def take_usage(self) -> Dict[str, int]:
        """Per-tenant admits since the last call (reconcile report);
        drains the counters."""
        with self._cv:
            usage, self._usage = self._usage, {}
            return usage

    def waiting_by_tenant(self) -> Dict[str, int]:
        """Parked demand per tenant (reconcile report)."""
        with self._cv:
            return {
                t: sum(1 for w in q if not w.abandoned)
                for t, q in self._queues.items()
                if q
            }

    def pressure_by_tenant(self) -> Dict[str, Dict[str, int]]:
        """Scheduler-facing serve pressure per tenant: parked request
        count AND their queued prefill tokens (the ``cost`` each admit
        carried). The fleet reconcile ships this to the head, which
        feeds it as demand rows to the multi-objective capacity
        kernel — capacity follows serve pressure, not just counts."""
        with self._cv:
            out: Dict[str, Dict[str, int]] = {}
            for t, q in self._queues.items():
                live = [w for w in q if not w.abandoned]
                if live:
                    out[t] = {
                        "waiting": len(live),
                        "waiting_tokens": sum(w.cost for w in live),
                    }
            return out

    def set_tenant_weights(self, weights: Dict[str, float]) -> None:
        with self._cv:
            self._weights = dict(weights or {})

    @property
    def tenant_weights(self) -> Dict[str, float]:
        with self._cv:
            return dict(self._weights)

    # -- observability -------------------------------------------------
    def stats(self) -> dict:
        with self._cv:
            return {
                "inflight": self._inflight,
                "waiting": self._waiting,
                "admitted": self.admitted,
                "sheds": self.sheds,
                "wakeups": self.wakeups,
                "max_inflight": self.max_inflight,
                "qps_limit": self._bucket.rate,
            }


def controller_from_cfg(
    tenant_weights: Optional[Dict[str, float]] = None,
) -> AdmissionController:
    from ray_tpu_torch.config import cfg

    return AdmissionController(
        qps=float(cfg.serve_admission_qps),
        burst=float(cfg.serve_admission_burst),
        max_inflight=int(cfg.serve_admission_max_inflight),
        wait_cap=int(cfg.serve_admission_wait_cap),
        wait_timeout_s=float(cfg.serve_admission_timeout_s),
        tenant_weights=tenant_weights,
    )
