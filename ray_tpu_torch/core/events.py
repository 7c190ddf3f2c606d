"""Task lifecycle events + chrome-trace timeline export.

Port of ``ray_tpu/core/events.py``, copied with its imports rewritten.


Analog of the reference's TaskEventBuffer → GcsTaskManager pipeline
(src/ray/core_worker/task_event_buffer.h:304) and ray.timeline()
(python/ray/_private/state.py:1010): every task transition is recorded in a
bounded ring buffer; ``dump_timeline`` renders Chrome tracing JSON.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class TaskEvent:
    task_id: str
    name: str
    state: str  # SUBMITTED | SCHEDULED | RUNNING | FINISHED | FAILED
    timestamp: float
    node_id: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


class TaskEventBuffer:
    def __init__(self, max_events: int = 100_000):
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()

    def record(self, task_id: str, name: str, state: str,
               node_id: str = "", **extra) -> None:
        with self._lock:
            self._events.append(
                TaskEvent(task_id, name, state, time.time(), node_id, extra)
            )

    def events(self, task_id: Optional[str] = None) -> List[TaskEvent]:
        with self._lock:
            evs = list(self._events)
        if task_id is not None:
            evs = [e for e in evs if e.task_id == task_id]
        return evs

    def task_states(self) -> Dict[str, TaskEvent]:
        """Latest event per task."""
        out: Dict[str, TaskEvent] = {}
        for e in self.events():
            out[e.task_id] = e
        return out

    def dump_timeline(
        self, path: Optional[str] = None, include_process_spans: bool = True
    ) -> List[dict]:
        """Chrome tracing format: one complete ('X') slice per RUNNING →
        FINISHED/FAILED pair, plus instant events for queueing states.

        Instant events carry their recorded ``extra`` (trace ids, and —
        for SCHEDULED events the head stamps — the scheduler's per-term
        cost breakdown), so one trace answers both "where did it run"
        and "why was it placed there". Process-level spans from
        ``util.tracing.SPANS`` (scheduler rounds, serve requests, socket
        stripes, elastic reshape phases) merge into the same export."""
        spans: List[dict] = []
        open_running: Dict[str, TaskEvent] = {}
        for e in self.events():
            if e.state == "RUNNING":
                open_running[e.task_id] = e
            elif e.state in ("FINISHED", "FAILED") and e.task_id in open_running:
                start = open_running.pop(e.task_id)
                trace_args = {
                    k: v
                    for src in (start.extra, e.extra)
                    for k, v in src.items()
                    if k in ("trace_id", "parent_id")
                }
                spans.append(
                    {
                        "name": e.name,
                        "cat": "task",
                        "ph": "X",
                        "ts": start.timestamp * 1e6,
                        "dur": (e.timestamp - start.timestamp) * 1e6,
                        "pid": start.node_id or "cluster",
                        "tid": e.extra.get("worker", 0),
                        "args": {
                            "state": e.state,
                            "task_id": e.task_id,
                            **trace_args,
                        },
                    }
                )
            elif e.state in ("SUBMITTED", "SCHEDULED"):
                span = {
                    "name": f"{e.name}:{e.state.lower()}",
                    "cat": "scheduler",
                    "ph": "i",
                    "s": "p",
                    "ts": e.timestamp * 1e6,
                    "pid": e.node_id or "cluster",
                    "tid": 0,
                }
                if e.extra:
                    span["args"] = {"task_id": e.task_id, **e.extra}
                spans.append(span)
        if include_process_spans:
            try:
                from ..util.tracing import SPANS

                spans.extend(SPANS.slices())
            except Exception:  # noqa: BLE001 - export must not fail
                pass
        if path:
            with open(path, "w") as f:
                json.dump(spans, f)
        return spans
