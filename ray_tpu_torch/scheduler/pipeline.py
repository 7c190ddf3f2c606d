"""Pipelined scheduling rounds: dispatch and readback on separate threads.

Port of ``ray_tpu/scheduler/pipeline.py``, copied with its imports
rewritten. ``PendingRound.result()`` waits on a CUDA event here
(``scheduler/device.py``), which is what lets later rounds run behind it.

The synchronous round (unpipelined) interleaved four phases on one
thread: host prep → upload/dispatch → blocking readback → grant fan-out.
The kernel and the device→host copy are async on every XLA backend, so
the readback wait and the per-grant Python bookkeeping were dead time on
the dispatch path — the delivered scheduler throughput was capped at
1/(sum of all four) even though the phases use disjoint resources.

``SchedulerPipeline`` is the request queue between them:

  scheduler thread                 completion thread
  ────────────────                 ─────────────────
  prep batch N+2                   rows = pending[N].result()  (readback)
  sync + dispatch N+2  ──submit──▶ on_complete(ctx, rows)      (grants)
  prep batch N+3                   rows = pending[N+1].result()
  ...                              ...

Rounds complete strictly in dispatch order (the donated avail chain makes
order the semantics). ``depth`` bounds rounds in flight — submit blocks
when the completion thread falls behind, so the host mirror's lag (and a
grant's worst-case queue latency) stays bounded. ``flush()`` drains the
queue for barrier callers (tests, shutdown, mode switches).

Error contract: an ``on_complete`` raise is caught, logged, and reported
through ``on_error`` (the head respills that round's specs back to its
pending queue) — one poisoned round must not kill the completion thread.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class SchedulerPipeline:
    """Bounded in-order completion queue for dispatched scheduling rounds."""

    def __init__(
        self,
        on_complete: Callable,          # (ctx, rows, round_ms) -> None
        on_error: Optional[Callable] = None,  # (ctx, exc) -> None
        depth: Optional[int] = None,
    ):
        if depth is None:
            from ray_tpu_torch.config import cfg

            depth = max(1, int(cfg.sched_pipeline_depth))
        self.depth = depth
        self._on_complete = on_complete
        self._on_error = on_error
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._stopped = False
        self._waiting = 0  # submitters parked in backpressure
        self._inflight_peak = 0
        self.completed = 0
        self._thread = threading.Thread(
            target=self._drain, name="sched-pipeline", daemon=True
        )
        self._thread.start()

    # -- submit side ----------------------------------------------------

    def submit(self, round_) -> None:
        """Enqueue a dispatched PendingRound for completion; blocks while
        ``depth`` rounds are already awaiting readback (backpressure —
        the dispatch side must not outrun the grant side unboundedly)."""
        with self._cv:
            # counted while parked in backpressure so flush()'s "everything
            # submitted has completed" covers a submitter about to append
            # (a completion wakes flush and the parked submit together —
            # without the count, flush could observe the queue momentarily
            # empty and return before the woken submit appends its round)
            self._waiting += 1
            try:
                while len(self._q) >= self.depth and not self._stopped:
                    self._cv.wait(timeout=0.5)
                if self._stopped:
                    raise RuntimeError("scheduler pipeline stopped")
                self._q.append(round_)
            finally:
                self._waiting -= 1
            self._inflight_peak = max(self._inflight_peak, len(self._q))
            self._cv.notify_all()

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every submitted round — including rounds whose
        submit() is still parked in backpressure — has completed (or
        timeout)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while (self._q or self._waiting) and time.monotonic() < deadline:
                self._cv.wait(timeout=0.1)
            return not (self._q or self._waiting)

    def inflight(self) -> int:
        with self._cv:
            return len(self._q)

    def stats(self) -> dict:
        with self._cv:
            return {
                "depth": self.depth,
                "inflight": len(self._q),
                "inflight_peak": self._inflight_peak,
                "completed": self.completed,
            }

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)

    # -- completion side ------------------------------------------------

    def _drain(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stopped:
                    self._cv.wait(timeout=0.5)
                if not self._q:
                    if self._stopped:
                        return
                    continue
                round_ = self._q[0]  # keep queued until completed: flush()
                # and inflight() must count rounds whose grants are still
                # being fanned out, not only unread ones
            try:
                rows = round_.result()
                round_ms = (time.perf_counter() - round_.dispatched_at) * 1e3
                self._on_complete(round_.ctx, rows, round_ms)
            except Exception as exc:  # noqa: BLE001 - round must not kill us
                logger.exception("scheduler round completion failed")
                if self._on_error is not None:
                    try:
                        self._on_error(round_.ctx, exc)
                    except Exception:  # noqa: BLE001
                        logger.exception("scheduler round error handler failed")
            with self._cv:
                self._q.popleft()
                self.completed += 1
                self._cv.notify_all()
