"""Device-direct data plane: the surface the wire format reads, with
device frames off.

Port of ``ray_tpu/cluster/device_plane.py``: only what
``serialization.py``, ``transport.py``, ``event_loop.py``, the agent and
the worker call. The reference seals ``jax.Array`` leaves as *device
frames* (a dlpack/``__array__`` export riding the out-of-band buffers,
landed with ``device_put`` on the far side) and overlaps H2D with the
socket receive through a ``DeviceLandingZone``. The port has no device
frames yet: ``dumps_oob`` is a plain protocol-5 cloudpickle with
``buffer_callback``, and ``landing_zone_worthwhile()`` is false, so a CUDA
tensor travels through torch's own reducer, which copies it through the
host. Device frames for CUDA tensors (a D2H into pinned chunks on seal, an
H2D on land) are ROADMAP Queue A item 6.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

# hot-path counters, as the reference keeps them: they stay at zero
# until device frames exist, and the observability surfaces still read them
_stats = {
    "device_frame_seals_total": 0,
    "device_frame_zero_copy_total": 0,
    "device_frame_lands_total": 0,
    "device_frame_lands_device_total": 0,
    "device_frame_bytes_total": 0,
    "device_pump_chunks_total": 0,
    "device_land_chunks_total": 0,
}


def device_stats() -> dict:
    return dict(_stats)


def publish_device_metrics() -> dict:
    """Sync the counters into the metrics registry (observability
    surfaces only, never the data path)."""
    from ray_tpu_torch.util.metrics import sync_counter

    for name, v in _stats.items():
        sync_counter(name, v, "Device-direct data plane frame events.")
    return device_stats()


def device_plane_enabled() -> bool:
    """False: the port seals no device frames yet (Queue A item 6)."""
    return False


_LANDING = threading.local()


def landing_mode() -> str:
    return getattr(_LANDING, "mode", "device")


def landing_requested() -> bool:
    """True only while an explicit ``landing("device")`` scope is active
    on this thread (the scope-less default does not count)."""
    return getattr(_LANDING, "mode", None) == "device"


@contextlib.contextmanager
def landing(mode: str):
    """Scope the landing mode for deserialization on this thread. With no
    device frames both modes land the same host values; the scope is kept
    so that callers written against the reference run unchanged."""
    if mode not in ("device", "host"):
        raise ValueError(f"unknown landing mode {mode!r}")
    prev = getattr(_LANDING, "mode", None)
    _LANDING.mode = mode
    try:
        yield
    finally:
        if prev is None:
            del _LANDING.mode
        else:
            _LANDING.mode = prev


def flush_landing_keepalive() -> None:
    """No-op: nothing lands on a device, so no transfer keeps a host view
    alive (the reference drains jax's keepalive queue here)."""


def landing_zone_worthwhile() -> bool:
    """False: a socket fetch never overlaps H2D with the receive until
    device frames exist."""
    return False


def dumps_oob(obj: Any, protocol: int, buffer_callback) -> bytes:
    """``cloudpickle.dumps(obj, protocol, buffer_callback=...)``: the
    reference's disabled-plane path, which is the port's only path."""
    import cloudpickle

    return cloudpickle.dumps(obj, protocol=protocol, buffer_callback=buffer_callback)


class DeviceLandingZone:
    """The reference's in-flight H2D landing zone. Never built in the port
    (``landing_zone_worthwhile()`` is false); constructing one raises."""

    def __init__(self, dest, chunk_bytes=None):
        raise NotImplementedError(
            "device landing zones need device frames for CUDA tensors, which "
            "are not ported yet (ROADMAP Queue A item 6)"
        )


def debug_block() -> dict:
    """DebugState ``object_plane.device`` block (agent/worker surfaces)."""
    out = {"enabled": device_plane_enabled()}
    out.update(device_stats())
    return out
