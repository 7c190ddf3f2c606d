"""SLO-driven replica autoscaling for the serving plane.

Port of ``ray_tpu/serve/slo_autoscaler.py`` (no JAX in it).

A control loop on token-throughput/latency metrics rather than raw
``ongoing`` counts (the legacy :class:`AutoscalingConfig` tick): the
scaler watches the router's admitted-in-flight depth and a rolling
window of TTFT observations, and

- **scales up** when in-flight depth sustainedly exceeds
  ``target_queue_per_replica`` per active replica, or the windowed TTFT
  p50 sustainedly violates ``target_ttft_ms`` (when set);
- **scales down** by *graceful drain* when the fleet is sustainedly
  under-utilized: the victim replica stops receiving new requests and
  is killed only once its in-flight streams complete (deployment.py
  drain semantics), so scale-down never cuts a stream mid-token.

New replicas are ordinary actor creations: the head scheduler places
them with the heterogeneity-aware multi-objective program, so a
mixed fleet puts replicas on the node types that serve them fastest.

Decisions are windowed (``upscale_delay_s`` / ``downscale_delay_s``)
to ride out bursts, and every action is counted in
``serve_autoscale_events_total{direction}``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ray_tpu_torch.util.metrics import Counter, Gauge, percentile_from_buckets

SERVE_AUTOSCALE_EVENTS = Counter(
    "serve_autoscale_events_total",
    "Serving-plane autoscaling actions.",
    label_names=("direction",),
)
SERVE_REPLICAS = Gauge(
    "serve_replicas",
    "Active (non-draining) replicas per deployment.",
    label_names=("deployment",),
)


@dataclass
class SLOConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ttft_ms: float = 0.0  # 0 = depth-only scaling
    target_queue_per_replica: float = 4.0
    upscale_delay_s: float = 1.0
    downscale_delay_s: float = 5.0

    @classmethod
    def from_cfg(cls, **overrides) -> "SLOConfig":
        from ray_tpu_torch.config import cfg

        base = cls(
            target_ttft_ms=float(cfg.serve_slo_ttft_ms),
            target_queue_per_replica=float(cfg.serve_slo_queue_per_replica),
        )
        for k, v in overrides.items():
            setattr(base, k, v)
        return base


class SLOAutoscaler:
    """One deployment's scaling loop. ``metrics_fn`` is injectable for
    tests: it must return ``{"inflight": int, "replicas": int,
    "ttft_p50_ms": float}``; the default reads the router."""

    def __init__(
        self,
        router,
        slo: Optional[SLOConfig] = None,
        *,
        metrics_fn: Optional[Callable[[], dict]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.router = router
        self.slo = slo or SLOConfig.from_cfg()
        self._clock = clock
        self._metrics_fn = metrics_fn or self._default_metrics
        self._over_since: Optional[float] = None
        self._under_since: Optional[float] = None
        self._ttft_buckets = None  # last histogram snapshot (window diff)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_decision = "init"
        self.scale_ups = 0
        self.scale_downs = 0
        self.capacity_blocks = 0

    # -- metrics --------------------------------------------------------
    def _default_metrics(self) -> dict:
        from .router import SERVE_TTFT_MS

        rs = self.router._rs
        snap = SERVE_TTFT_MS.buckets_snapshot(
            {"deployment": rs.dep.name}
        )
        if self._ttft_buckets is None:
            window = snap
        else:
            window = [
                max(0, a - b) for a, b in zip(snap, self._ttft_buckets)
            ]
        self._ttft_buckets = snap
        return {
            "inflight": self.router.admission.stats()["inflight"],
            "replicas": rs.num_replicas,
            "ttft_p50_ms": percentile_from_buckets(
                SERVE_TTFT_MS.boundaries, window, 0.50
            ),
        }

    # -- one decision ---------------------------------------------------
    def tick(self) -> str:
        slo = self.slo
        m = self._metrics_fn()
        replicas = max(1, int(m["replicas"]))
        now = self._clock()
        SERVE_REPLICAS.set(
            m["replicas"], labels={"deployment": self.router._rs.dep.name}
        )
        over = m["inflight"] > slo.target_queue_per_replica * replicas or (
            slo.target_ttft_ms > 0
            and m["ttft_p50_ms"] > slo.target_ttft_ms
        )
        under = (
            m["inflight"]
            < 0.5 * slo.target_queue_per_replica * max(1, replicas - 1)
        )
        decision = "hold"
        if over:
            self._under_since = None
            if self._over_since is None:
                self._over_since = now
            elif (
                now - self._over_since >= slo.upscale_delay_s
                and m["replicas"] < slo.max_replicas
            ):
                # Corroborate against the scheduler kernel's serve-
                # pressure verdict when the fleet reconcile has a fresh
                # one: if bin-packing found zero residual room for
                # another replica-shaped row, adding a replica would
                # only oversubscribe the same nodes — hold the window
                # armed and retry next tick instead.
                if self._capacity_blocked():
                    self.capacity_blocks += 1
                    decision = "hold-capacity"
                else:
                    self.router._rs.add_replica()
                    self._over_since = None
                    self.scale_ups += 1
                    SERVE_AUTOSCALE_EVENTS.inc(
                        labels={"direction": "up"}
                    )
                    decision = "up"
        elif under:
            self._over_since = None
            if self._under_since is None:
                self._under_since = now
            elif (
                now - self._under_since >= slo.downscale_delay_s
                and m["replicas"] > slo.min_replicas
            ):
                self.router._rs.drain_one_replica()
                self._under_since = None
                self.scale_downs += 1
                SERVE_AUTOSCALE_EVENTS.inc(labels={"direction": "down"})
                decision = "down"
        else:
            self._over_since = None
            self._under_since = None
        self.last_decision = decision
        return decision

    def _capacity_blocked(self) -> bool:
        """True when a fresh fleet capacity hint (per-tenant serve
        pressure pushed through the bin-pack kernel) reports zero
        placeable replica rows. Routers without a fleet — or with a
        stale hint — never block."""
        hint_fn = getattr(self.router, "capacity_hint", None)
        if not callable(hint_fn):
            return False
        try:
            hint = hint_fn()
        except Exception:  # noqa: BLE001 - advisory signal only
            return False
        if not isinstance(hint, dict):
            return False
        try:
            return int(hint.get("replicas_placeable", 1)) <= 0
        except (TypeError, ValueError):
            return False

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        from ray_tpu_torch.config import cfg

        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(
                max(0.05, float(cfg.serve_autoscale_interval_s))
            ):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - scaling must not die
                    pass

        self._thread = threading.Thread(
            target=loop,
            name=f"serve-slo-{self.router._rs.dep.name}",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def state(self) -> dict:
        hint_fn = getattr(self.router, "capacity_hint", None)
        try:
            hint = hint_fn() if callable(hint_fn) else None
        except Exception:  # noqa: BLE001 - advisory signal only
            hint = None
        return {
            "last_decision": self.last_decision,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "capacity_blocks": self.capacity_blocks,
            "capacity_hint": hint,
            "capacity_blocked": self._capacity_blocked(),
            "min_replicas": self.slo.min_replicas,
            "max_replicas": self.slo.max_replicas,
            "target_ttft_ms": self.slo.target_ttft_ms,
            "target_queue_per_replica": self.slo.target_queue_per_replica,
        }
