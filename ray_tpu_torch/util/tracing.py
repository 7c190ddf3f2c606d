"""Distributed trace-context propagation.

Port of ``ray_tpu/util/tracing.py``, copied with its imports rewritten.

Capability analog of the reference's OpenTelemetry task tracing
(Ray's python/ray/util/tracing/tracing_helper.py: the ambient
span context is serialized into every task spec at submission and
re-installed around execution on the worker, so spans from every hop of
a task tree share one trace id).

Here the context is a small dict ``{"trace_id", "span_id"}`` carried in
``TaskSpec.trace`` / ``LeaseRequest.trace`` / direct-call items:

- the driver's first submission in a tree mints a trace id;
- the worker installs the received context (contextvar) around user-code
  execution, so NESTED submissions inherit the same trace id with the
  executing task as their parent span;
- every lifecycle event recorded against the task (head + local runtime
  timelines) carries ``trace_id``/``parent_id``, and the Chrome-trace
  export exposes them in ``args`` — one trace is filterable across every
  node it touched.
"""
from __future__ import annotations

import contextvars
import threading
import time as _time
from collections import deque
from contextlib import contextmanager
from typing import List, Optional

from ray_tpu_torch._ids import rand_hex
from ray_tpu_torch.config import cfg

_ctx: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "ray_tpu_trace", default=None
)


def current() -> Optional[dict]:
    return _ctx.get()


def child_context(task_id: str, autostart: Optional[bool] = None) -> Optional[dict]:
    """Trace context for a task being SUBMITTED now: inherits the ambient
    trace (nested call) or — when root minting is enabled
    (``cfg.trace_tasks``, default on) — mints a fresh trace id (tree
    root). The new task's span id is its task id. With ``trace_tasks``
    off, only explicitly-started traces (``start_trace`` or a context
    installed by an executing traced task) propagate; untraced
    submissions carry ``None`` and pay zero minting cost."""
    amb = _ctx.get()
    if amb is not None:
        return {
            "trace_id": amb["trace_id"],
            "span_id": task_id,
            "parent_id": amb["span_id"],
        }
    # ``autostart`` lets hot callers pass a cached copy of the flag: the
    # cfg read consults os.environ live, measurable per-call at thousands
    # of submissions per second
    if not (cfg.trace_tasks if autostart is None else autostart):
        return None
    return {
        "trace_id": rand_hex(8),
        "span_id": task_id,
        "parent_id": None,
    }


def start_trace() -> "object":
    """Explicitly open a trace at the caller (driver code): submissions
    made while the returned token is installed share one trace id even
    when ``cfg.trace_tasks`` is off. Returns a token for ``uninstall``."""
    return _ctx.set(
        {"trace_id": rand_hex(8), "span_id": "driver", "parent_id": None}
    )


def install(trace: Optional[dict]):
    """Install the received context around task execution; returns a
    token for ``uninstall``."""
    return _ctx.set(trace)


def uninstall(token) -> None:
    _ctx.reset(token)


def event_args(trace: Optional[dict]) -> dict:
    """kwargs for TaskEventBuffer.record."""
    if not trace:
        return {}
    out = {"trace_id": trace["trace_id"]}
    if trace.get("parent_id"):
        out["parent_id"] = trace["parent_id"]
    return out


# ---------------------------------------------------------------------------
# process-local span recorder: named duration spans beyond the
# per-task lifecycle — scheduler rounds, serve request lifecycle,
# socket-plane stripes, elastic reshape phases. Spans land in a bounded
# ring and merge into every Chrome-trace export
# (core/events.TaskEventBuffer.dump_timeline) and crash bundle.
# ---------------------------------------------------------------------------


class SpanBuffer:
    """Bounded ring of completed spans in Chrome-trace 'X' form."""

    def __init__(self, max_spans: int = 50_000):
        self._spans: deque = deque(maxlen=max_spans)
        self._lock = threading.Lock()

    def record(
        self,
        name: str,
        cat: str,
        start_ts: float,
        dur_s: float,
        pid: str = "",
        tid=0,
        **args,
    ) -> None:
        """One completed span: ``start_ts`` is epoch seconds
        (time.time()), ``dur_s`` its wall duration. ``args`` must be
        JSON-serializable (they land in trace exports verbatim)."""
        if not cfg.trace_spans:
            return
        span = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": start_ts * 1e6,
            "dur": max(0.0, dur_s) * 1e6,
            "pid": pid or "process",
            "tid": tid,
        }
        if args:
            span["args"] = args
        with self._lock:
            self._spans.append(span)

    @contextmanager
    def span(self, name: str, cat: str = "runtime", pid: str = "", **args):
        t0 = _time.time()
        try:
            yield
        finally:
            self.record(name, cat, t0, _time.time() - t0, pid=pid, **args)

    def slices(
        self, since_s: Optional[float] = None, cat: Optional[str] = None
    ) -> List[dict]:
        """Snapshot (optionally only spans STARTING within the last
        ``since_s`` seconds, the crash-bundle window)."""
        with self._lock:
            spans = list(self._spans)
        if since_s is not None:
            cutoff = (_time.time() - since_s) * 1e6
            spans = [s for s in spans if s["ts"] >= cutoff]
        if cat is not None:
            spans = [s for s in spans if s["cat"] == cat]
        return spans

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


#: the process's span ring (one per process, like the metrics registry)
SPANS = SpanBuffer()
