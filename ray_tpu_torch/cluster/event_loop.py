"""Fused owner-side submit/result event loop (the execution-plane hot
path's control thread).

Before this module, every ``_TaskLeaseChannel`` (batched lease windows),
every ``_DirectActorChannel`` (direct actor pushes), and the
direct-results delivery each ran their own thread, each parking on its
own condition variable on a 0.25–1 s poll — per-channel wakeups, one
lock hop per item, and O(channels) idle threads. This module collapses
them into ONE event loop per runtime:

- **sources** register with ``step(now) -> next_deadline``; the loop
  calls ``step`` when a source is woken (``wake``) or its timer expires.
  ``step`` is non-blocking by contract: it inspects state, forms a
  whole batch, and offloads any RPC to the bounded sender pool.
- **one wake per window**: ``wake`` marks the source ready and notifies
  the single loop condition variable; N submissions racing in while the
  loop is busy coalesce into one ``step`` that drains them all.
- **senders**: blocking RPCs (lease windows, direct pushes, probes)
  run on a small shared pool instead of per-channel threads; a source
  is guarded by its own in-flight flag so ordering within a channel is
  preserved (at most one action in flight per source).
- **result sink**: incoming ``DirectResults`` RPC batches enqueue and
  wake the loop; the sink's ``step`` drains EVERY queued batch in one
  pass under one lock acquisition (batch-at-once result delivery).

The reference's shape is core_worker's C++ submit loop: the Python that
remains per item is the user-visible serialize; everything else is
per-window.

Port of ``ray_tpu/cluster/event_loop.py``, copied with its imports
rewritten.
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("ray_tpu_torch.cluster.event_loop")

# process-wide registry (weak) so observability surfaces can report
# occupancy for every live loop without plumbing references around
import weakref

_LOOPS: "weakref.WeakSet" = weakref.WeakSet()


def loop_stats() -> List[dict]:
    return [lp.stats() for lp in list(_LOOPS)]


def publish_dark_plane() -> None:
    """Sync every dark-plane accumulator (plain-int wire counters, the
    shm counter page shared with wire.cc/net.cc, compiled-pipeline
    slots, ring fill levels) into the typed metrics registry. Called
    from observability ticks — agent report loop, head scrape, DebugState
    — never from a hot path; from there the federation ships them to the
    head scrape."""
    from ray_tpu_torch.cluster import serialization as wire_mod

    wire_mod.publish_wire_metrics()
    try:
        from ray_tpu_torch.cluster import device_plane

        device_plane.publish_device_metrics()
    except Exception:  # noqa: BLE001 - device plane is optional
        pass
    try:
        from ray_tpu_torch.native import counters as dark

        dark.publish()
    except Exception:  # noqa: BLE001 - counters are optional
        pass
    try:
        from ray_tpu_torch.dag.channel import ring_stats
        from ray_tpu_torch.util.metrics import sync_gauge

        fills = ring_stats()
        if fills:
            sync_gauge(
                "pipeline_ring_used_bytes",
                float(sum(r["used"] for r in fills)),
                "Bytes currently occupying this process's open shm rings.",
            )
            sync_gauge(
                "pipeline_ring_fill_max",
                float(max(r["fill"] for r in fills)),
                "Highest fill fraction across this process's open shm "
                "rings at the last observability tick.",
            )
    except Exception:  # noqa: BLE001 - toolchain missing
        pass


def hotpath_state() -> dict:
    """One self-describing snapshot of this PROCESS's execution-plane hot
    path: framing-path selection + counters, fused-event-loop occupancy
    and window sizes, open-ring fill levels, live pipeline stats, and the
    dispatch-overhead decomposition. Embedded by the agent's DebugState
    ``hotpath`` block and the head's ``QueryState("hotpath")``."""
    from ray_tpu_torch.cluster import serialization as wire_mod
    from ray_tpu_torch.util.metrics import _registry

    state = {
        "native_wire": wire_mod.NATIVE_WIRE,
        "wire": wire_mod.publish_wire_metrics(),
        "event_loops": loop_stats(),
    }
    try:
        from ray_tpu_torch.native import counters as dark

        state["dark_counters"] = dark.publish()
    except Exception:  # noqa: BLE001 - counters are optional
        state["dark_counters"] = {}
    try:
        from ray_tpu_torch.dag.channel import ring_stats

        state["rings"] = ring_stats()
    except Exception:  # noqa: BLE001 - toolchain missing
        state["rings"] = []
    try:
        from ray_tpu_torch.dag.pipeline import pipeline_stats

        state["pipelines"] = pipeline_stats()
    except Exception:  # noqa: BLE001
        state["pipelines"] = []
    hist = _registry.get("dispatch_overhead_us")
    if hist is not None:
        state["dispatch_overhead_us"] = {
            stage: hist.summary({"stage": stage})
            for stage in ("serialize", "enqueue", "wire", "execute", "result")
        }
    return state


class FusedEventLoop:
    """Single-threaded ready-set/timer loop + bounded sender pool."""

    def __init__(self, name: str = "hotpath", senders: int = 8):
        self._name = name
        self._cv = threading.Condition()
        self._ready: List[Any] = []
        self._ready_set: set = set()
        # timers: authoritative map + lazy heap (stale heap entries are
        # skipped on pop) — O(log n) per re-arm instead of an O(n) scan
        # per wake on the one thread the submit plane serializes through
        self._deadlines: Dict[int, float] = {}  # id(src) -> deadline
        self._timer_heap: List[tuple] = []  # (deadline, id(src), src)
        self._sources: Dict[int, Any] = {}
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, senders), thread_name_prefix=f"{name}-send"
        )
        # stats (loop-thread-written, racily read)
        self._wakes = 0
        self._steps = 0
        self._offloads = 0
        self._busy_s = 0.0
        self._started_at = time.monotonic()
        self._batch_hist: List[int] = [0] * 12  # log2 batch-size buckets
        _LOOPS.add(self)

    def alive(self) -> bool:
        return not self._stop

    # -- registration --------------------------------------------------
    def register(self, source: Any) -> bool:
        """False = the loop is stopped (runtime shutdown): the caller
        must fail over itself — a silently unscheduled source would
        strand its queue forever."""
        with self._cv:
            if self._stop:
                return False
            self._sources[id(source)] = source
            self._ensure_thread_locked()
        self.wake(source)
        return True

    def unregister(self, source: Any) -> None:
        with self._cv:
            self._sources.pop(id(source), None)
            self._deadlines.pop(id(source), None)
            self._ready_set.discard(id(source))

    def _ensure_thread_locked(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=f"{self._name}-loop", daemon=True
            )
            self._thread.start()

    # -- signalling ----------------------------------------------------
    def wake(self, source: Any) -> bool:
        """Mark ``source`` ready; one notify regardless of how much work
        was queued since its last step. False = not registered (loop
        stopped or source unregistered)."""
        with self._cv:
            if self._stop or id(source) not in self._sources:
                return False
            if id(source) not in self._ready_set:
                self._ready_set.add(id(source))
                self._ready.append(source)
                self._wakes += 1
                self._cv.notify()
            return True

    def offload(self, source: Any, fn: Callable, *args) -> bool:
        """Run a blocking action on the sender pool; wake ``source`` when
        it finishes (its step() observes completion and re-plans)."""

        def _run_action() -> None:
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 - actions own their errors
                logger.warning(
                    "hotpath action %r raised", fn, exc_info=True
                )
            finally:
                self.wake(source)

        self._offloads += 1
        try:
            self._pool.submit(_run_action)
            return True
        except RuntimeError:  # pool shut down under us (runtime exit)
            return False

    def note_batch(self, n: int) -> None:
        """Record a drained window size (log2-bucketed, lock-free)."""
        if n > 0:
            self._batch_hist[min(n.bit_length() - 1, 11)] += 1

    # -- loop ----------------------------------------------------------
    def _drop_stale_timers_locked(self) -> None:
        import heapq

        heap = self._timer_heap
        while heap and self._deadlines.get(heap[0][1]) != heap[0][0]:
            heapq.heappop(heap)  # re-armed or cancelled entry

    def _run(self) -> None:
        import heapq

        while True:
            with self._cv:
                while not self._ready and not self._stop:
                    self._drop_stale_timers_locked()
                    gap = 1.0
                    if self._timer_heap:
                        gap = self._timer_heap[0][0] - time.monotonic()
                        if gap <= 0.0:
                            break
                    self._cv.wait(timeout=gap)
                if self._stop:
                    return
                now = time.monotonic()
                batch = self._ready
                self._ready = []
                self._ready_set.clear()
                in_batch = {id(s) for s in batch}
                self._drop_stale_timers_locked()
                while self._timer_heap and self._timer_heap[0][0] <= now:
                    _, key, src = heapq.heappop(self._timer_heap)
                    self._deadlines.pop(key, None)
                    if key not in in_batch:
                        in_batch.add(key)
                        batch.append(src)
                    self._drop_stale_timers_locked()
            t0 = time.monotonic()
            for src in batch:
                with self._cv:
                    alive = id(src) in self._sources
                if not alive:
                    continue
                self._steps += 1
                try:
                    deadline = src.step(time.monotonic())
                except Exception:  # noqa: BLE001 - a source must not
                    # take the loop down; its own failure paths run on
                    # its next wake
                    logger.warning(
                        "hotpath source %r step raised", src, exc_info=True
                    )
                    deadline = time.monotonic() + 1.0
                with self._cv:
                    if id(src) in self._sources:
                        if deadline is not None:
                            self._deadlines[id(src)] = deadline
                            heapq.heappush(
                                self._timer_heap, (deadline, id(src), src)
                            )
                        else:
                            self._deadlines.pop(id(src), None)
            self._busy_s += time.monotonic() - t0

    def stats(self) -> dict:
        elapsed = max(1e-9, time.monotonic() - self._started_at)
        return {
            "name": self._name,
            "sources": len(self._sources),
            "wakes_total": self._wakes,
            "steps_total": self._steps,
            "offloads_total": self._offloads,
            "occupancy": round(self._busy_s / elapsed, 6),
            "busy_s": round(self._busy_s, 3),
            "batch_size_log2_hist": list(self._batch_hist),
        }

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._pool.shutdown(wait=False)
        t = self._thread
        if t is not None:
            t.join(timeout=3.0)
