"""Serving-plane chaos workload: verified token streams under faults.

Drives a *resumable* streaming deployment (the LLM continuous engine —
per-request deterministic generation) through the serving router while
the orchestrator injects ``replica_kill`` / ``router_kill`` faults, and
verifies the serving plane's core promise end to end: every completed
stream's token sequence equals the expected sequence EXACTLY — a
mid-stream replica SIGKILL (or ingress-router kill, when ``router`` is
a :class:`~ray_tpu_torch.serve.fleet.RouterFleet`) that fails over may
neither duplicate nor drop a single acked token.

The workload doubles as the orchestrator's ``serve_adapter``: it knows
how to pick a live replica worker pid (or a live router) to kill, how
many replicas are supposed to exist, and whether the streams that were
in flight at a fault completed token-exact afterwards.

Port of ``ray_tpu/chaos/serve.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import ray_tpu_torch


class ServeStreamWorkload:
    """``concurrency`` threads open stream after stream against
    ``router`` and verify each completed stream against
    ``expected_tokens`` (the deterministic reference sequence). With a
    fleet and multiple ``tenants``, the threads' streams spread across
    the routers (consistent-hash assignment), so a router kill lands
    mid-stream."""

    def __init__(
        self,
        router,
        payload: dict,
        expected_tokens: List[str],
        concurrency: int = 2,
        tenants: Optional[List[str]] = None,
        prefill_rs=None,
    ):
        self.router = router
        self.payload = dict(payload)
        self.expected = list(expected_tokens)
        self.concurrency = concurrency
        self.tenants = list(tenants or ["default"])
        # disaggregated deployments: the prefill tier's replica set, so
        # prefill_kill can pick victims and verify backfill. None for
        # monolithic deployments (prefill faults then report skipped).
        self.prefill_rs = prefill_rs
        self.completed = 0
        self.stream_errors = 0
        self.verify_failures: List[str] = []
        self.routers_killed = 0
        # router-kill accounting: stream_id -> outcome ("ok" |
        # "verify_fail" | "error") for every stream that was IN FLIGHT
        # at the moment of a router kill — the cross-router resume
        # invariant reads this
        self._watched: Dict[str, str] = {}
        self._inflight: Dict[int, object] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- stream loop ----------------------------------------------------
    def _loop(self, idx: int) -> None:
        from ray_tpu_torch.serve.router import ChannelClosed

        tenant = self.tenants[idx % len(self.tenants)]
        while not self._stop.is_set():
            got: List[str] = []
            stream = None
            sid = None
            try:
                stream = self.router.stream(self.payload, tenant)
                sid = getattr(stream, "stream_id", None)
                with self._lock:
                    self._inflight[idx] = stream
                while True:
                    try:
                        got.append(stream.read(timeout=30.0))
                    except ChannelClosed:
                        break
            except Exception:  # noqa: BLE001
                # failover exhaustion surfaces here; only token
                # CORRUPTION is an invariant failure — a hard error on
                # an unlucky double-kill is counted but tolerated
                with self._lock:
                    self.stream_errors += 1
                    self._inflight.pop(idx, None)
                    if sid in self._watched:
                        self._watched[sid] = "error"
                time.sleep(0.2)
                continue
            finally:
                if stream is not None:
                    stream.close()
            ok = got == self.expected
            if not ok:
                div = next(
                    (
                        i
                        for i, (a, b) in enumerate(zip(got, self.expected))
                        if a != b
                    ),
                    min(len(got), len(self.expected)),
                )
                with self._lock:
                    self.verify_failures.append(
                        f"stream returned {len(got)} tokens, expected "
                        f"{len(self.expected)}; first divergence at "
                        f"index {div} (duplicated/dropped acked tokens)"
                    )
            else:
                with self._lock:
                    self.completed += 1
            with self._lock:
                self._inflight.pop(idx, None)
                if sid in self._watched:
                    self._watched[sid] = "ok" if ok else "verify_fail"

    def start(self) -> None:
        for i in range(self.concurrency):
            t = threading.Thread(
                target=self._loop,
                args=(i,),
                name=f"serve-chaos-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)

    # -- orchestrator adapter surface -----------------------------------
    def pick_replica_pid(self, rng) -> Optional[int]:
        """A live replica worker's pid (victim selection); None when no
        replica answers."""
        rs = self.router._rs
        with rs.lock:
            replicas = [r for r in rs.replicas if not r.draining]
        if not replicas:
            return None
        for r in rng.sample(replicas, len(replicas)):
            try:
                return int(
                    ray_tpu_torch.get(r.actor.pid.remote(), timeout=10.0)
                )
            except Exception:  # noqa: BLE001 - already dead: next
                continue
        return None

    def live_replicas(self) -> int:
        """Replicas that actually answer a call right now."""
        rs = self.router._rs
        with rs.lock:
            replicas = [r for r in rs.replicas if not r.draining]
        alive = 0
        for r in replicas:
            try:
                ray_tpu_torch.get(r.actor.pid.remote(), timeout=10.0)
                alive += 1
            except Exception:  # noqa: BLE001
                pass
        return alive

    def target_replicas(self) -> int:
        return self.router._rs.target

    # -- prefill-tier adapter surface ------------------------------------
    def pick_prefill_pid(self, rng) -> Optional[int]:
        """A live PREFILL worker's pid (prefill_kill victim selection);
        None when the deployment is monolithic or no prefill replica
        answers."""
        rs = self.prefill_rs
        if rs is None:
            return None
        with rs.lock:
            replicas = [r for r in rs.replicas if not r.draining]
        if not replicas:
            return None
        for r in rng.sample(replicas, len(replicas)):
            try:
                return int(
                    ray_tpu_torch.get(r.actor.pid.remote(), timeout=10.0)
                )
            except Exception:  # noqa: BLE001 - already dead: next
                continue
        return None

    def live_prefill(self) -> int:
        """Prefill replicas that actually answer a call right now."""
        rs = self.prefill_rs
        if rs is None:
            return 0
        with rs.lock:
            replicas = [r for r in rs.replicas if not r.draining]
        alive = 0
        for r in replicas:
            try:
                ray_tpu_torch.get(r.actor.pid.remote(), timeout=10.0)
                alive += 1
            except Exception:  # noqa: BLE001
                pass
        return alive

    def target_prefill(self) -> int:
        return self.prefill_rs.target if self.prefill_rs else 0

    # -- router-fleet adapter surface ------------------------------------
    def kill_router(self, rng) -> Optional[str]:
        """Abruptly kill one live ingress router (fleet deployments
        only), preferring one that currently owns in-flight streams so
        the kill actually lands mid-stream. Snapshots those streams
        into the cross-router resume watchlist. Returns the victim's
        router id, or None when no kill is possible (single router /
        plain ServeRouter)."""
        fleet = self.router
        if not hasattr(fleet, "chaos_kill_router"):
            return None
        with self._lock:
            inflight = [
                s
                for s in self._inflight.values()
                if getattr(s, "stream_id", None) is not None
            ]
        owned: Dict[str, List[object]] = {}
        for s in inflight:
            owned.setdefault(getattr(s, "_rid", ""), []).append(s)
        victim = None
        candidates = [rid for rid, _ in fleet.live_routers() if rid in owned]
        if candidates:
            victim = rng.choice(sorted(candidates))
        # register the watchlist BEFORE the kill: a stream completing in
        # the gap then records "ok" instead of dangling as pending
        pre = [s.stream_id for s in owned.get(victim, ())] if victim else []
        with self._lock:
            for sid in pre:
                self._watched.setdefault(sid, "pending")
        rid = fleet.chaos_kill_router(rid=victim, rng=rng)
        if rid is None:
            with self._lock:
                for sid in pre:
                    if self._watched.get(sid) == "pending":
                        del self._watched[sid]
            return None
        with self._lock:
            self.routers_killed += 1
        return rid

    def watched_outcomes(self) -> Dict[str, str]:
        """Outcome per stream that was in flight on a killed router."""
        with self._lock:
            return dict(self._watched)

    def routers_live(self) -> int:
        fleet = self.router
        if not hasattr(fleet, "live_routers"):
            return 1
        return len(fleet.live_routers())
