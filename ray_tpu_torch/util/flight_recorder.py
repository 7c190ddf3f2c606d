"""Crash bundles: post-mortems that don't need a live cluster.

On a chaos fault, a task failure with its retries exhausted, or a head
failover, the process dumps a bounded flight-recorder bundle to a
per-run directory:

    <base>/run-<ts>-<pid>/bundle-<seq>-<reason>/
        meta.json     — reason, wall time, pid, host, cluster epoch
        events.json   — last ``crash_bundle_window_s`` of task events
        trace.json    — Chrome-trace slices (task spans + process spans)
        metrics.prom  — a full exposition snapshot (federated on the head)
        state.json    — caller-supplied debug state (QueryState/DebugState)

Bundles are small and bounded three ways: the event/span window, a
per-run rotation cap (``crash_bundle_keep``), and a per-process dump
throttle (``crash_bundle_min_interval_s``) so a failure storm cannot
turn the recorder itself into the outage. Dumping is best-effort by
design — every caller wraps it so a full disk can never break a failure
path that was working.

Port of ``ray_tpu/util/flight_recorder.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import socket
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.config import cfg

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_run_dir: Optional[str] = None
_seq = 0
_last_dump = 0.0


def _slug(reason: str) -> str:
    out = "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)
    return out[:80] or "unknown"


def run_dir() -> str:
    """This process's per-run bundle directory (created on first use)."""
    global _run_dir
    with _lock:
        if _run_dir is None:
            base = cfg.crash_bundle_dir or os.path.join(
                tempfile.gettempdir(), "ray_tpu_bundles"
            )
            stamp = time.strftime("%Y%m%d-%H%M%S")
            _run_dir = os.path.join(base, f"run-{stamp}-{os.getpid()}")
            os.makedirs(_run_dir, exist_ok=True)
        return _run_dir


def _rotate(run_path: str, keep: int) -> None:
    bundles = sorted(
        d for d in os.listdir(run_path)
        if d.startswith("bundle-")
        and os.path.isdir(os.path.join(run_path, d))
    )
    for stale in bundles[: max(0, len(bundles) - keep)]:
        shutil.rmtree(os.path.join(run_path, stale), ignore_errors=True)


def throttled() -> bool:
    """Non-consuming peek at the storm throttle: True when a dump
    attempted NOW would be dropped. Callers with expensive state to
    collect (the head's QueryState snapshots) check this first so a
    failure storm doesn't burn pool threads producing bundles the real
    throttle then discards."""
    if not cfg.crash_bundles:
        return True
    with _lock:
        return (
            time.monotonic() - _last_dump
            < cfg.crash_bundle_min_interval_s
        )


def dump_bundle(
    reason: str,
    events=None,
    state: Optional[Dict[str, Any]] = None,
    metrics_text: Optional[Callable[[], str]] = None,
    extra_meta: Optional[Dict[str, Any]] = None,
    force: bool = False,
) -> Optional[str]:
    """Write one bundle; returns its path, or None when disabled,
    throttled, or failed (always best-effort).

    ``events``: a ``TaskEventBuffer`` (its recent window is serialized
    and its timeline — which already merges ``tracing.SPANS`` — becomes
    trace.json; with None only process spans are dumped).
    ``metrics_text``: exposition renderer (default: the process-local
    registry; the head passes its federated renderer).
    ``force`` bypasses the storm throttle (explicit operator dumps)."""
    global _seq, _last_dump
    if not cfg.crash_bundles:
        return None
    now = time.monotonic()
    with _lock:
        if not force and now - _last_dump < cfg.crash_bundle_min_interval_s:
            return None
        _last_dump = now
        _seq += 1
        seq = _seq
    try:
        window_s = float(cfg.crash_bundle_window_s)
        run_path = run_dir()
        path = os.path.join(run_path, f"bundle-{seq:04d}-{_slug(reason)}")
        os.makedirs(path, exist_ok=True)

        meta = {
            "reason": reason,
            "time": time.time(),
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "window_s": window_s,
            **(extra_meta or {}),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)

        ev_rows: List[dict] = []
        trace: List[dict] = []
        cutoff = time.time() - window_s
        if events is not None:
            for e in events.events():
                if e.timestamp >= cutoff:
                    ev_rows.append(
                        {
                            "task_id": e.task_id,
                            "name": e.name,
                            "state": e.state,
                            "ts": e.timestamp,
                            "node_id": e.node_id,
                            **({"extra": e.extra} if e.extra else {}),
                        }
                    )
            trace = [
                s
                for s in events.dump_timeline(None)
                if s.get("ts", 0) >= cutoff * 1e6
            ]
        else:
            from ray_tpu_torch.util.tracing import SPANS

            trace = SPANS.slices(since_s=window_s)
        with open(os.path.join(path, "events.json"), "w") as f:
            json.dump(ev_rows, f, default=str)
        with open(os.path.join(path, "trace.json"), "w") as f:
            json.dump(trace, f, default=str)

        if metrics_text is None:
            from ray_tpu_torch.util.metrics import prometheus_text

            metrics_text = prometheus_text
        with open(os.path.join(path, "metrics.prom"), "w") as f:
            f.write(metrics_text())

        with open(os.path.join(path, "state.json"), "w") as f:
            json.dump(state or {}, f, indent=2, default=str)

        _rotate(run_path, int(cfg.crash_bundle_keep))
        logger.warning("flight-recorder bundle (%s) at %s", reason, path)
        return path
    except Exception:  # noqa: BLE001 - never break a failure path
        logger.exception("crash-bundle dump failed (%s)", reason)
        return None
