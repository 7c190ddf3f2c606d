"""Buffered random id generation for the submission hot path.

Port of ``ray_tpu/_ids.py``, copied.

Every task submission mints several ids (task id, return-object ids,
trace id). ``os.urandom()`` per id is one syscall each — measurable at
thousands of submissions per second (the reference burns the same cost
in C++ where it is free; here the syscall + bytes.hex() dominate).
One 8 KiB urandom refill amortizes the syscall over ~500 ids while
keeping full-entropy uniqueness across processes and threads.
"""
from __future__ import annotations

import os
import threading

_REFILL = 8192


class _Buf(threading.local):
    def __init__(self):
        self.data = b""
        self.pos = 0


_buf = _Buf()

# fork safety: a forked child inherits the parent's unconsumed buffer and
# would mint byte-identical ids (os.urandom per call was fork-safe; the
# pool is not). Discard the inherited bytes in the child.


def _reset_after_fork() -> None:
    _buf.data = b""
    _buf.pos = 0


os.register_at_fork(after_in_child=_reset_after_fork)


def rand_hex(nbytes: int) -> str:
    """Hex string of ``nbytes`` random bytes (2*nbytes chars)."""
    b = _buf
    end = b.pos + nbytes
    if end > len(b.data):
        b.data = os.urandom(_REFILL)
        b.pos, end = 0, nbytes
    out = b.data[b.pos:end].hex()
    b.pos = end
    return out
