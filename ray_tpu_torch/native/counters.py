"""Shm-resident dark-plane counter slots.

The zero-Python steady-state paths (compiled-pipeline event loop, the C
framing/socket planes in ``wire.cc``/``net.cc``) cannot afford a locked
``Counter.inc`` per event — and the C halves cannot touch Python at all.
This module gives every process ONE mmap-backed page of int64 slots:

- Python hot wrappers bump slots lock-free through a ``memoryview``
  (single 8-byte store; increments may race a torn observation but
  never corrupt — these are rate indicators, same contract as the
  plain-int ``serialization._stats`` counters);
- the C libraries get the SAME page registered once via
  ``rtpu_wire_set_counters`` / ``rtpu_net_set_counters`` and bump their
  slots with relaxed atomics — bytes and frames are counted where they
  move, with zero FFI or interpreter cost per event;
- observability ticks (agent report loop, head scrape) read the slots
  out into the typed registry via the existing ``sync_counter`` pattern
  (``publish()``), where federation ships them to the head.

The backing file is pid-stamped in the tempdir (like ring/endpoint
sidecars) so a post-mortem can read a SIGKILLed process's last counts;
``sweep_orphan_counters`` reaps dead-pid files at agent start beside
``sweep_orphan_stores``.

Port of ``ray_tpu/native/counters.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import atexit
import ctypes
import mmap
import os
import tempfile
import threading
from typing import Dict, Optional

#: slot layout — indices are ABI shared with wire.cc / net.cc (their
#: kSlot* constants); append only, never reorder.
SLOTS = (
    "native_wire_c_joins_total",      # 0: frames gather-joined in C
    "native_wire_c_parses_total",     # 1: frames parsed in C
    "native_wire_c_bytes_total",      # 2: frame bytes built in C
    "net_c_tx_bytes_total",           # 3: socket-plane bytes sendmsg'd in C
    "net_c_tx_frames_total",          # 4: sendmsg gather calls in C
    "net_c_rx_bytes_total",           # 5: socket-plane bytes recv'd in C
    "net_py_tx_bytes_total",          # 6: python-fallback socket tx bytes
    "net_py_rx_bytes_total",          # 7: python-fallback socket rx bytes
    "net_stripe_retries_total",       # 8: striped-transfer resume redials
    "pipeline_items_submitted_total",  # 9: compiled-pipeline submits
    "pipeline_items_completed_total",  # 10: compiled-pipeline completions
    "pipeline_items_respilled_total",  # 11: pipeline → eager respills
)

_HELP: Dict[str, str] = {
    "native_wire_c_joins_total": "RTP5 frames gather-joined by wire.cc.",
    "native_wire_c_parses_total": "RTP5 frames parsed by wire.cc.",
    "native_wire_c_bytes_total": "RTP5 frame bytes built by wire.cc.",
    "net_c_tx_bytes_total": "Socket-plane bytes sent by net.cc sendmsg.",
    "net_c_tx_frames_total": "Socket-plane sendmsg gather calls in net.cc.",
    "net_c_rx_bytes_total": "Socket-plane bytes received by net.cc.",
    "net_py_tx_bytes_total": "Socket-plane bytes sent on the Python path.",
    "net_py_rx_bytes_total": "Socket-plane bytes received on the Python path.",
    "net_stripe_retries_total": "Striped-transfer per-stripe resume redials.",
    "pipeline_items_submitted_total": "Compiled-pipeline items submitted.",
    "pipeline_items_completed_total": "Compiled-pipeline items completed.",
    "pipeline_items_respilled_total": "Compiled-pipeline items respilled "
    "to the eager path after a break.",
}

N_SLOTS = 64  # fixed page layout; SLOTS may grow into the tail
assert len(SLOTS) <= N_SLOTS

_PREFIX = "ray_tpu_torch_counters."
_SUFFIX = ".cnt"


class CounterBlock:
    """One process's mmap-backed int64 slot page."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.path.join(
            tempfile.gettempdir(), f"{_PREFIX}p{os.getpid()}{_SUFFIX}"
        )
        size = N_SLOTS * 8
        existed = os.path.exists(self.path)
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        if existed:
            # a recycled pid must not inherit a dead process's totals
            # (they'd ship as one giant spurious delta); post-mortem
            # reads only ever target OTHER (dead) pids' pages
            self._mm[:] = b"\0" * size
        self._slots = memoryview(self._mm).cast("q")
        self._closed = False
        # set by register_with_wire/net: once the raw page address is
        # handed to a C library, the mapping must outlive every daemon
        # thread — close() then only unlinks, never unmaps
        self.pinned = False

    # -- hot-path ops (no locks; single-store per bump) ----------------
    def add(self, idx: int, v: int = 1) -> None:
        self._slots[idx] += v

    def get(self, idx: int) -> int:
        return int(self._slots[idx])

    def c_pointer(self) -> ctypes.c_void_p:
        """The page's base address for C-side registration."""
        addr = ctypes.addressof(ctypes.c_char.from_buffer(self._mm))
        return ctypes.c_void_p(addr)

    def snapshot(self) -> Dict[str, int]:
        return {name: int(self._slots[i]) for i, name in enumerate(SLOTS)}

    def close(self, unlink: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        if not self.pinned:
            # no C library saw the address: safe to unmap. A pinned page
            # stays mapped for the process lifetime — wire.cc/net.cc
            # keep the raw pointer and daemon threads may bump it right
            # through interpreter shutdown.
            try:
                self._slots.release()
                self._mm.close()
            except (BufferError, ValueError):
                pass
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class _NullBlock:
    """Fallback when the page cannot be created (tempdir unwritable,
    disk full): counting silently no-ops — observability must never
    crash a data-plane hot path that was working."""

    path = None

    def add(self, idx: int, v: int = 1) -> None:
        pass

    def get(self, idx: int) -> int:
        return 0

    def snapshot(self) -> Dict[str, int]:
        return {name: 0 for name in SLOTS}

    def close(self, unlink: bool = True) -> None:
        pass


_lock = threading.Lock()
_block = None  # CounterBlock | _NullBlock
_IDX = {name: i for i, name in enumerate(SLOTS)}


def block():
    """The process's counter page (created on first touch; a no-op
    stand-in on creation failure)."""
    global _block
    if _block is None:
        with _lock:
            if _block is None:
                try:
                    b = CounterBlock()
                    atexit.register(b.close)
                except OSError:
                    b = _NullBlock()
                _block = b
    return _block


def add(name: str, v: int = 1) -> None:
    """Bump one named slot (Python-side dark-path accumulators)."""
    block().add(_IDX[name], v)


def publish() -> Dict[str, int]:
    """Sync every slot into the typed registry (``sync_counter``
    pattern — called from observability ticks, never hot paths)."""
    from ray_tpu_torch.util.metrics import sync_counter

    snap = block().snapshot()
    for name, v in snap.items():
        sync_counter(name, v, _HELP.get(name, ""))
    return snap


def register_with_wire(lib) -> bool:
    """Hand the page to wire.cc (idempotent). Returns False when the
    library predates the counter ABI or the page could not be created."""
    b = block()
    if not isinstance(b, CounterBlock):
        return False
    try:
        fn = lib.rtpu_wire_set_counters
    except AttributeError:
        return False
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p]
    fn(b.c_pointer())
    b.pinned = True
    return True


def register_with_net(lib) -> bool:
    """Hand the page to net.cc (idempotent)."""
    b = block()
    if not isinstance(b, CounterBlock):
        return False
    try:
        fn = lib.rtpu_net_set_counters
    except AttributeError:
        return False
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p]
    fn(b.c_pointer())
    b.pinned = True
    return True


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def sweep_orphan_counters(directory: Optional[str] = None) -> int:
    """Unlink counter pages left by SIGKILLed processes (dead pids only
    — same live-pid protection as the ring/arena sweeps)."""
    directory = directory or tempfile.gettempdir()
    swept = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for name in names:
        if not (name.startswith(_PREFIX) and name.endswith(_SUFFIX)):
            continue
        pid_part = name[len(_PREFIX):-len(_SUFFIX)]
        if not pid_part.startswith("p"):
            continue
        try:
            pid = int(pid_part[1:])
        except ValueError:
            continue
        if _pid_alive(pid):
            continue
        try:
            os.unlink(os.path.join(directory, name))
            swept += 1
        except OSError:
            pass
    return swept
