"""Mutable-object channels: a writable slot shared between processes.

The user-facing analog of the reference's mutable objects / channel API
(Ray's python/ray/experimental/channel/shared_memory_channel.py,
common.py ChannelInterface): a ``Channel`` is a named, bounded,
shared-memory pipe a writer task/actor can write repeatedly and readers
consume in order — the primitive under compiled DAGs, exposed directly
for streaming between processes without per-message object-store churn.

Built on the native futex-woken SPSC ring (ray_tpu_torch/native/ring.cc) plus
the RDT tensor codec, so torch tensors and numpy arrays travel as raw
dtype+bytes.
One writer, one reader per channel (SPSC); fan-out = one channel per
reader, same as the reference's per-reader channels.

Handles are picklable: pass a ``ChannelWriter``/``ChannelReader`` to a
task or actor on the SAME HOST and it reopens the ring by path (the
reference's shared-memory channel has the same same-node scope;
cross-host streaming rides the object plane).

Port of ``ray_tpu/experimental/channel.py``, copied with its imports
rewritten.
"""
from __future__ import annotations

import os
import uuid
from typing import Any, Optional

from ray_tpu_torch.dag.channel import (
    ERR,
    OK,
    STOP,
    ChannelClosed,
    ChannelTimeout,
    ShmChannel,
    channel_dir,
)

__all__ = ["Channel", "ChannelReader", "ChannelWriter", "ChannelClosed"]


class _End:
    """Shared open-by-path plumbing for both ends."""

    def __init__(self, path: str, capacity: int):
        self._path = path
        self._capacity = capacity
        self._ch: Optional[ShmChannel] = None

    def _chan(self) -> ShmChannel:
        if self._ch is None:
            self._ch = ShmChannel(self._path, capacity=self._capacity)
        return self._ch

    def close(self) -> None:
        if self._ch is not None:
            self._ch.close()
            self._ch = None


class ChannelWriter(_End):
    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        """Blocks when the ring is full (backpressure — the reference's
        bounded channel semantics)."""
        self._chan().put(OK, value, timeout=timeout)

    def close_channel(self) -> None:
        """Signal end-of-stream: readers drain buffered items, then see
        ChannelClosed."""
        try:
            self._chan().put(STOP, None, timeout=1.0)
        except (ChannelTimeout, ChannelClosed, OSError):
            pass
        self._chan().close_write()

    def __reduce__(self):
        return (ChannelWriter, (self._path, self._capacity))


class ChannelReader(_End):
    def read(self, timeout: Optional[float] = None) -> Any:
        """Next value in order; raises ChannelClosed after end-of-stream,
        TimeoutError when ``timeout`` elapses with nothing to read."""
        try:
            tag, value = self._chan().get(timeout=timeout)
        except ChannelTimeout as exc:
            raise TimeoutError(str(exc)) from exc
        if tag == STOP:
            raise ChannelClosed(self._path)
        if tag == ERR:
            raise value
        return value

    def __iter__(self):
        while True:
            try:
                yield self.read()
            except ChannelClosed:
                return

    def __reduce__(self):
        return (ChannelReader, (self._path, self._capacity))


class Channel:
    """Create a same-host SPSC channel; hand ``.writer`` / ``.reader`` to
    the producing and consuming task/actor."""

    def __init__(self, buffer_size_bytes: int = 1 << 22, name: Optional[str] = None):
        self._path = os.path.join(
            channel_dir(), f"chan_{name or uuid.uuid4().hex[:12]}.ring"
        )
        self._capacity = buffer_size_bytes
        ch = ShmChannel(self._path, capacity=buffer_size_bytes, create=True)
        ch.close()  # materialize + size the file; ends reopen by path
        self.writer = ChannelWriter(self._path, self._capacity)
        self.reader = ChannelReader(self._path, self._capacity)

    def destroy(self) -> None:
        # set the ring's closed flag FIRST: a producer in another process
        # parked on a full ring only wakes when the flag is set — closing
        # our mapping alone would wedge it forever
        try:
            self.writer._chan().close_write()
        except OSError:
            pass
        self.writer.close()
        self.reader.close()
        try:
            os.unlink(self._path)
        except OSError:
            pass
