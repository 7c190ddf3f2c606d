"""Device-direct data plane: seal, ship, and land torch tensors without
the host bounce of torch's own reducer.

Port of ``ray_tpu/cluster/device_plane.py``. Where the reference seals
``jax.Array`` leaves, the port seals dense ``torch.Tensor`` leaves on the
CPU or a CUDA card. Without the plane, a CUDA tensor rides torch's own
reducer: a full host copy inside the pickle pass, another host copy on
the far side, then a separate H2D. The seams and the frame format are the
reference's:

- **Seal side** — :class:`DeviceAwarePickler` intercepts sealable tensor
  leaves in ``reducer_override`` and reduces them to
  ``(_land_device_leaf, (meta, PickleBuffer(raw)))``: ``raw`` is a
  ``uint8`` view of the tensor's bytes and ``meta`` names the dtype by
  torch's name (``bfloat16``, ``float8_e4m3fn``, ...), the shape, the
  device the tensor was sealed from and ``requires_grad``. A contiguous
  CPU tensor exports as a view of its own storage (zero-copy). A CUDA
  tensor exports through one D2H copy, and at or above the pump threshold
  through :class:`DeviceChunkPump`: chunked D2H copies into pinned host
  buffers on a side CUDA stream, each chunk with its own event, so chunk
  *k* is copied out of pinned memory while chunk *k+1* is on the bus. The
  PickleBuffer rides the existing out-of-band frame machinery, so arena
  puts and socket sends carry the bytes with no change of format.
- **Land side** — ``_land_device_leaf`` is an ordinary module function
  referenced from the pickle stream, so every transport that carries RTP5
  frames (shm views, socket stripes, chunked RPC, spill files) lands
  device frames unchanged. Under :func:`landing` ``"device"`` (the
  default) a frame sealed from a CUDA tensor lands on this process's
  current CUDA device: one H2D copy from the arriving buffer, staged
  through a small ring of pinned buffers (:func:`h2d`,
  :class:`_H2DStager`); a frame sealed from a CPU tensor lands as a fresh
  CPU tensor. A process with no card cannot land a CUDA frame on the
  device: the land raises and names the frame, it never hands back a CPU
  tensor instead. Under ``"host"`` the land returns the read-only host
  view, as a numpy array (a fresh CPU tensor for a dtype numpy cannot
  name, such as bfloat16 without ``ml_dtypes``, since a tensor cannot be
  read-only).
- **Overlap** — :class:`DeviceLandingZone` wraps the host buffer of a
  socket fetch (``fetch_bytes`` with ``land="device"``): as disjoint
  stripes land, H2D copies of the completed contiguous prefix are issued
  through the same pinned ring into one device buffer the size of the
  object, overlapping the remaining recv. Under an explicit
  ``landing("device")`` scope the finished zone is kept for the thread
  (:func:`keep_landed`), and a frame whose bytes lie in that buffer lands
  from the device copy (one device-to-device copy) instead of a second
  H2D. Aborts drop the partial device buffer; the staged pages are the
  caller's (``abort_put``), and per-stripe retry/resume still works
  because the zone only consumes contiguous-prefix bytes.

Kill switch: ``RAY_TPU_DEVICE_PLANE=0`` disables frame interception and
landing zones everywhere (tensors ride torch's own reducer); sealed device
frames remain loadable and land host-side.
"""
from __future__ import annotations

import contextlib
import ctypes
import sys
import threading
import time
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# hot-path counters (plain-int increments, wire.py contract: rate
# indicators whose flat-vs-nonzero proof is race-safe)
# ---------------------------------------------------------------------------
_stats = {
    "device_frame_seals_total": 0,  # tensor leaves sealed as device frames
    "device_frame_zero_copy_total": 0,  # of which the export aliased storage
    "device_frame_lands_total": 0,  # leaves landed (any mode)
    "device_frame_lands_device_total": 0,  # of which landed as a tensor
    "device_frame_bytes_total": 0,  # payload bytes moved as device frames
    "device_pump_chunks_total": 0,  # chunked D2H pump chunks drained
    "device_land_chunks_total": 0,  # landing-zone H2D chunks issued
}


def device_stats() -> dict:
    return dict(_stats)


def publish_device_metrics() -> dict:
    """Sync the hot-path counters into the metrics registry (called from
    observability surfaces, never the data path itself)."""
    from ray_tpu_torch.util.metrics import sync_counter

    for name, v in _stats.items():
        sync_counter(name, v, "Device-direct data plane frame events.")
    return device_stats()


def device_plane_enabled() -> bool:
    """The kill switch (RAY_TPU_DEVICE_PLANE, read live). torch is the
    port's own dependency, so unlike the reference there is no framework
    to probe for."""
    try:
        from ray_tpu_torch.config import cfg

        return bool(cfg.device_plane)
    except Exception:  # noqa: BLE001 - config unavailable (bootstrap)
        import os

        return os.environ.get("RAY_TPU_DEVICE_PLANE", "1").lower() not in (
            "0",
            "false",
            "no",
        )


def _torch():
    import torch

    return torch


# ---------------------------------------------------------------------------
# sealability + export
# ---------------------------------------------------------------------------


def is_sealable_device_array(value: Any) -> bool:
    """True when ``value`` is a plain dense ``torch.Tensor`` on the CPU or
    a CUDA card that the plane can export as one frame. Subclasses
    (``nn.Parameter``), sparse and quantized tensors, lazy conjugates,
    non-leaf tensors that require grad and empty tensors fall through to
    torch's own reducer — the plane never changes semantics, only the
    copy count. A process that never imported torch holds no tensor, so
    the check costs one dict lookup there."""
    torch = sys.modules.get("torch")
    if torch is None or type(value) is not torch.Tensor:
        return False
    try:
        if value.layout is not torch.strided or value.is_quantized:
            return False
        if value.device.type not in ("cpu", "cuda"):
            return False
        if value.is_conj() or value.is_neg():
            return False
        if value.requires_grad and not value.is_leaf:
            return False
        if value.numel() == 0:
            return False  # torch's own path; nothing to win on 0 bytes
    except RuntimeError:  # noqa: BLE001 - freed or fake tensor
        return False
    return dtype_name(value.dtype) is not None


def dtype_name(dtype) -> Optional[str]:
    """torch's name for ``dtype`` (``torch.bfloat16`` -> ``"bfloat16"``),
    or None when the name does not resolve back to it."""
    torch = _torch()
    name = str(dtype).rpartition(".")[2]
    return name if getattr(torch, name, None) is dtype else None


def resolve_dtype(name: str):
    """The torch dtype of a frame's name."""
    torch = _torch()
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"device frame names unknown dtype {name!r}")
    return dt


def numpy_dtype(name: str) -> Optional[np.dtype]:
    """numpy's dtype of that name, or None where numpy cannot name it
    (bfloat16 and float8 unless ``ml_dtypes`` was loaded by someone)."""
    try:
        return np.dtype(name)
    except TypeError:
        return None


def _uint8_numpy(t) -> np.ndarray:
    """``uint8`` ndarray over a contiguous CPU tensor's bytes (shares its
    memory and keeps it alive): every dtype is viewable as bytes, where
    the buffer protocol has no format char for bfloat16 or float8."""
    return t.reshape(-1).view(_torch().uint8).numpy()


def export_device_view(t) -> Tuple[Any, bool]:
    """``(host_tensor, zero_copy)`` for a sealable tensor: a contiguous CPU
    tensor exports as itself (zero-copy); a non-contiguous one is made
    contiguous once; a CUDA tensor takes one D2H copy. The returned CPU
    tensor keeps its storage alive for the seal's gather-copy."""
    t = t.detach()
    if t.device.type == "cpu":
        if t.is_contiguous():
            return t, True
        return t.contiguous(), False
    return t.contiguous().cpu(), False


# ---------------------------------------------------------------------------
# landing mode (thread-local: fetch paths scope it around deserialize)
# ---------------------------------------------------------------------------

_LANDING = threading.local()


def landing_mode() -> str:
    return getattr(_LANDING, "mode", "device")


def landing_requested() -> bool:
    """True only while an explicit ``landing("device")`` scope is active
    on this thread — the scope-less default ("device") does NOT count.
    Transport callers use this to decide whether a socket get should pay
    for a :class:`DeviceLandingZone`: only consumers that declared the
    payload tensor-heavy opt in (rdt pulls); a generic get must not copy
    an arbitrary pickled object's raw byte stream — headers, pickle
    opcodes, multi-GB non-tensor payloads — onto the card just to discard
    the chunks after ``finish()``."""
    return getattr(_LANDING, "mode", None) == "device"


@contextlib.contextmanager
def landing(mode: str):
    """Scope the device-frame landing mode for deserialization on this
    thread: ``"device"`` (default) lands leaves as tensors on the device
    they were sealed from; ``"host"`` returns read-only host views
    (consumers that only re-export)."""
    if mode not in ("device", "host"):
        raise ValueError(f"unknown landing mode {mode!r}")
    prev = getattr(_LANDING, "mode", None)
    prev_landed = getattr(_LANDING, "landed", None)
    _LANDING.mode = mode
    try:
        yield
    finally:
        # a zone kept inside this scope ends with it
        _LANDING.landed = prev_landed
        if prev is None:
            del _LANDING.mode
        else:
            _LANDING.mode = prev


def keep_landed(host, device_copy) -> None:
    """Keep a finished landing zone's device copy for this thread until
    the enclosing ``landing("device")`` scope ends, so the deserialize
    that follows the fetch lands the frames inside ``host`` from it.
    ``host`` is the zone's host buffer, held here so that its addresses
    cannot be reused while the copy is kept. Does nothing outside an
    explicit device scope (nothing would release the copy)."""
    if landing_requested():
        _LANDING.landed = (np.frombuffer(host, dtype=np.uint8), device_copy)


def _from_landed(raw: np.ndarray, device_type: str):
    """A fresh tensor of ``raw``'s bytes copied out of the kept zone's
    device buffer, when ``raw`` lies inside that zone's host buffer and
    the buffer is on ``device_type``; None otherwise."""
    kept = getattr(_LANDING, "landed", None)
    if kept is None:
        return None
    host, dev = kept
    if dev.device.type != device_type:
        return None
    a = raw.ctypes.data - host.ctypes.data
    if a < 0 or a + raw.nbytes > host.nbytes:
        return None
    return dev[a : a + raw.nbytes].clone()


def _land_device_leaf(meta: dict, buf) -> Any:
    """Reconstruct one device frame. Referenced BY NAME from pickle
    streams — its module path is wire format; do not move or rename.

    ``buf`` arrives as a zero-copy memoryview slice of the incoming frame
    (PEP 574), an arena view, or in-band bytes. A CUDA landing is one H2D
    copy from that buffer, or one device-to-device copy where a kept
    landing zone already holds the bytes on the card; a CPU landing is one
    copy into a fresh tensor, so the landed value never pins the arena
    page it came from."""
    raw = np.frombuffer(buf, dtype=np.uint8)
    _stats["device_frame_lands_total"] += 1
    _stats["device_frame_bytes_total"] += raw.nbytes
    try:
        from ray_tpu_torch.cluster.object_plane import OBJECT_TRANSFER_BYTES

        OBJECT_TRANSFER_BYTES.inc(raw.nbytes, labels={"path": "device"})
    except Exception:  # noqa: BLE001 - metrics are optional at land time
        pass
    # the kill switch disables DEVICE behavior end to end: with the plane
    # off, frames sealed earlier (or by a peer with it on) still load, but
    # land host-side
    if landing_mode() == "host" or not device_plane_enabled():
        return _host_value(raw, meta)
    torch = _torch()
    dtype = resolve_dtype(meta["d"])
    if meta.get("dev") == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device frame ({meta['d']}{list(meta['s'])}, sealed from a "
                "CUDA tensor) cannot land on the device: this process sees "
                "no CUDA device; land it with landing('host') instead"
            )
        out = _from_landed(raw, "cuda")
        if out is None:
            out = h2d(raw)
    else:
        out = _from_landed(raw, "cpu")
        if out is None:
            out = torch.from_numpy(raw.copy())
    out = out.view(dtype).reshape(meta["s"])
    _stats["device_frame_lands_device_total"] += 1
    if meta.get("g"):
        out.requires_grad_(True)
    return out


def _host_value(raw: np.ndarray, meta: dict) -> Any:
    """The host landing: a read-only numpy view over the frame bytes, or a
    fresh CPU tensor where numpy cannot name the dtype."""
    npd = numpy_dtype(meta["d"])
    if npd is not None:
        return raw.view(npd).reshape(meta["s"])
    torch = _torch()
    return torch.from_numpy(raw.copy()).view(resolve_dtype(meta["d"])).reshape(
        meta["s"]
    )


def on_card() -> bool:
    """Whether this process sees a CUDA card."""
    return _torch().cuda.is_available()


def landing_zone_worthwhile() -> bool:
    """Whether a socket fetch should overlap H2D with recv via a
    :class:`DeviceLandingZone`: only where a card exists (there is a real
    H2D hop to hide). On the CPU the zone would add a copy instead of
    hiding one — gated off unless ``RAY_TPU_DEVICE_LAND_ALWAYS`` forces it
    (tests / A-B)."""
    if not device_plane_enabled():
        return False
    try:
        from ray_tpu_torch.config import cfg

        if cfg.device_land_always:
            return True
    except Exception:  # noqa: BLE001 - config unavailable
        pass
    return on_card()


# ---------------------------------------------------------------------------
# H2D (land side)
# ---------------------------------------------------------------------------


class _H2DStager:
    """H2D copies from pageable host memory through a ring of pinned
    buffers on a side CUDA stream.

    The source is whatever buffer a frame arrived in: an arena view, a
    socket landing buffer, in-band bytes. Registering it with
    ``cudaHostRegister`` would let the DMA read it in place, but the land
    sees a slice of an arbitrary buffer, not a long-lived mapping it could
    register once, and pinning and unpinning its pages on every land costs
    more than the copy it saves. So each chunk is copied into a pinned
    slot on the CPU and its H2D issued asynchronously; the CPU copy of
    chunk *k+1* overlaps the DMA of chunk *k*. A slot is refilled only
    after its event says the DMA that read it is done. This beats a plain
    pageable ``copy_``, which the CUDA driver stages the same way but
    without the overlap (chip_smoke.py's ``h2d_staging_rates`` measures
    both). One ring per process, shared under a lock: the copies share
    one copy engine either way."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: List[Any] = []
        self._events: List[Any] = []
        self._stream = None
        self._chunk = 0

    def _ensure(self, torch) -> None:
        if self._stream is not None:
            return
        from ray_tpu_torch.config import cfg

        self._chunk = max(1 << 20, int(cfg.device_land_chunk_bytes))
        self._stream = torch.cuda.Stream()
        self._slots = [
            torch.empty(self._chunk, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)
        ]
        self._events = [None, None]

    def copy(self, dst, src: np.ndarray) -> None:
        """``dst`` (a CUDA uint8 tensor) <- ``src`` (host bytes). Returns
        once every byte is out of ``src``; the current stream waits for
        the copies before it touches ``dst``."""
        torch = _torch()
        with self._lock:
            self._ensure(torch)
            side = self._stream
            side.wait_stream(torch.cuda.current_stream())
            n = src.nbytes
            host = cpu_bytes(src)
            k = 0
            for off in range(0, n, self._chunk):
                m = min(self._chunk, n - off)
                slot = k % 2
                ev = self._events[slot]
                if ev is not None:
                    ev.synchronize()
                staged = self._slots[slot][:m]
                staged.copy_(host[off : off + m])
                with torch.cuda.stream(side):
                    dst[off : off + m].copy_(staged, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(side)
                self._events[slot] = ev
                k += 1
            torch.cuda.current_stream().wait_stream(side)
            dst.record_stream(side)

    def wait(self) -> None:
        """Until every copy issued so far is on the card; the current
        stream waits for them too."""
        torch = _torch()
        with self._lock:
            if self._stream is not None:
                torch.cuda.current_stream().wait_stream(self._stream)
                self._stream.synchronize()


_STAGER = _H2DStager()



def h2d(raw: np.ndarray):
    """One H2D copy of host bytes into a fresh CUDA ``uint8`` tensor on
    the current device, through the pinned ring; returns once every byte
    is out of ``raw``. The device plane's lands and the RDT codec's."""
    torch = _torch()
    out = torch.empty(raw.nbytes, dtype=torch.uint8, device="cuda")
    _STAGER.copy(out, raw)
    return out


def cpu_bytes(src: np.ndarray):
    """A CPU uint8 tensor over ``src``'s bytes without a copy, also when
    ``src`` is read-only (an arena view, ``bytes``): the callers only read
    it, and ``torch.from_numpy`` would warn on a read-only array."""
    if not src.flags.writeable:
        src = np.ctypeslib.as_array(
            (ctypes.c_uint8 * src.nbytes).from_address(src.ctypes.data)
        )
    return _torch().from_numpy(src)


# ---------------------------------------------------------------------------
# seal side: the device-aware pickler
# ---------------------------------------------------------------------------


def make_device_reducer(pump_threshold: Optional[int] = None):
    """Reducer for sealable tensor leaves, shaped for ``reducer_override``.

    Leaves at or above ``pump_threshold`` bytes on a CUDA card read out
    through :class:`DeviceChunkPump`; below it, one plain export. Export
    errors propagate: with the plane on, a sealable CUDA tensor that
    cannot be exported is a failed seal, never a silent host-copy
    pickle."""
    import pickle

    from ray_tpu_torch.config import cfg

    threshold = (
        int(cfg.device_pump_min_bytes)
        if pump_threshold is None
        else pump_threshold
    )

    def _reduce(t):
        meta = {
            "d": dtype_name(t.dtype),
            "s": list(t.shape),
            "dev": t.device.type,
            "g": bool(t.requires_grad),
        }
        if t.numel() * t.element_size() >= threshold:
            host, zero_copy = _pumped_export(t)
        else:
            host, zero_copy = export_device_view(t)
        _stats["device_frame_seals_total"] += 1
        if zero_copy:
            _stats["device_frame_zero_copy_total"] += 1
        # frames travel as raw bytes: extension dtypes (bfloat16, float8)
        # have no buffer-protocol format char, and meta carries the dtype
        # by name — a uint8 view is always exportable and stays zero-copy
        return _land_device_leaf, (meta, pickle.PickleBuffer(_uint8_numpy(host)))

    return _reduce


def _host_aliasing(t) -> bool:
    """True when the tensor lives in host memory: the plain export is
    zero-copy or one cheap move, and the pump has no D2H to overlap."""
    return t.device.type == "cpu"


def _pumped_export(t) -> Tuple[Any, bool]:
    """Export via the chunked D2H pump when the tensor is on a card. The
    probe is the device, NOT a trial export: ``export_device_view`` of a
    CUDA tensor is a full monolithic D2H, so probing with it would pay
    the bus twice plus a discarded host copy on exactly the path the pump
    exists for."""
    if _host_aliasing(t):
        return export_device_view(t)
    return DeviceChunkPump(t).gather(), False


class DeviceAwarePickler:
    """Mixin factory: builds a CloudPickler subclass whose
    ``reducer_override`` seals tensor leaves as device frames. Constructed
    lazily (cloudpickle import stays off the module import path)."""

    _cls = None

    @classmethod
    def pickler_class(cls):
        if cls._cls is None:
            import cloudpickle

            class _P(cloudpickle.CloudPickler):
                _device_reduce: Optional[Callable] = None

                def reducer_override(self, obj):
                    red = self._device_reduce
                    if red is not None and is_sealable_device_array(obj):
                        return red(obj)
                    return super().reducer_override(obj)

            cls._cls = _P
        return cls._cls


def dumps_oob(obj: Any, protocol: int, buffer_callback) -> bytes:
    """Device-aware drop-in for ``cloudpickle.dumps(obj, protocol,
    buffer_callback=...)``: tensor leaves seal as device frames when the
    plane is enabled; everything else (and the disabled path) follows
    cloudpickle exactly."""
    import io

    import cloudpickle

    if not device_plane_enabled():
        return cloudpickle.dumps(
            obj, protocol=protocol, buffer_callback=buffer_callback
        )
    f = io.BytesIO()
    p = DeviceAwarePickler.pickler_class()(
        f, protocol=protocol, buffer_callback=buffer_callback
    )
    p._device_reduce = make_device_reducer()
    p.dump(obj)
    return f.getvalue()


# ---------------------------------------------------------------------------
# chunked D2H pump (seal side, CUDA tensors)
# ---------------------------------------------------------------------------


class DeviceChunkPump:
    """Chunked D2H readout of one tensor.

    Splits the tensor's bytes into ``chunk_bytes`` windows and keeps up to
    ``depth`` async D2H copies in flight on a side CUDA stream, each into
    its own pinned host buffer with its own event, yielding host chunks in
    order: the consumer (the seal's gather-copy) works on chunk *k* while
    chunks *k+1..k+depth* read out. Records one ``d2h_overlap_ms`` span
    per drained pump. A CPU tensor (tests force one through the pump)
    yields plain views of its bytes."""

    def __init__(
        self,
        arr,
        chunk_bytes: Optional[int] = None,
        depth: Optional[int] = None,
    ):
        from ray_tpu_torch.config import cfg

        self.arr = arr.detach().contiguous()
        self.chunk_bytes = max(
            1 << 20,
            int(cfg.device_pump_chunk_bytes)
            if chunk_bytes is None
            else chunk_bytes,
        )
        self.depth = max(
            1, int(cfg.device_pump_depth) if depth is None else depth
        )

    def chunks(self) -> Iterator[Tuple[int, Any]]:
        """Yield ``(byte_offset, host_uint8_tensor)`` in order with D2H
        lookahead. A yielded chunk is valid until the next one is asked
        for (its pinned buffer is then refilled)."""
        torch = _torch()
        flat = self.arr.reshape(-1).view(torch.uint8)
        n = flat.numel()
        t0 = time.time()
        tp0 = time.perf_counter()
        on_card = flat.device.type == "cuda"
        if on_card:
            side = torch.cuda.Stream(device=flat.device)
            # the producer's writes to the tensor come first
            side.wait_stream(torch.cuda.current_stream(flat.device))
            slots = [
                torch.empty(self.chunk_bytes, dtype=torch.uint8, pin_memory=True)
                for _ in range(self.depth)
            ]
        pending: List[Tuple[int, Any, Any]] = []
        issued = 0
        k = 0
        while issued < n or pending:
            while issued < n and len(pending) < self.depth:
                m = min(self.chunk_bytes, n - issued)
                part = flat[issued : issued + m]
                ev = None
                if on_card:
                    host = slots[k % self.depth][:m]
                    with torch.cuda.stream(side):
                        host.copy_(part, non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record(side)
                    k += 1
                    part = host
                pending.append((issued, part, ev))
                issued += m
            off, part, ev = pending.pop(0)
            if ev is not None:
                ev.synchronize()
            _stats["device_pump_chunks_total"] += 1
            yield off, part
        if on_card:
            flat.record_stream(side)
        try:
            from ray_tpu_torch.util.tracing import SPANS

            SPANS.record(
                "d2h_overlap_ms",
                "device_plane",
                t0,
                time.perf_counter() - tp0,
                bytes=int(n),
                chunks=int(-(-n // self.chunk_bytes)),
            )
        except Exception:  # noqa: BLE001 - observability only
            pass

    def gather(self):
        """Drain the pump into one contiguous CPU tensor of the source's
        dtype and shape (callers that need the whole buffer; streamed
        consumers iterate chunks()). Copies as ``uint8`` views, never
        through the buffer protocol, which has no format char for
        bfloat16 or float8."""
        torch = _torch()
        out = torch.empty(self.arr.shape, dtype=self.arr.dtype)
        dst = out.reshape(-1).view(torch.uint8)
        for off, chunk in self.chunks():
            dst[off : off + chunk.numel()].copy_(chunk)
        return out


# ---------------------------------------------------------------------------
# landing zone (receive side: H2D overlapped with recv)
# ---------------------------------------------------------------------------


class DeviceLandingZone:
    """Overlaps H2D with an in-flight striped socket receive.

    Wraps the staged host destination (an unsealed arena entry, a
    bytearray view, or a pinned buffer from :func:`pinned_landing_buffer`)
    and one device buffer of the same size. ``note_stripe(off, n)`` is
    called from the fetch loop as each disjoint stripe lands; whenever a
    full ``chunk_bytes`` window of the CONTIGUOUS PREFIX has landed, the
    zone copies that window into the device buffer, so the copy rides
    under the remaining recv. From a pinned destination the copy is an
    async DMA on the zone's side stream that costs the receiving threads
    no CPU; from pageable pages it goes through the pinned ring
    (:class:`_H2DStager`), whose host memcpy competes with the recv for
    the CPU. ``finish()`` waits until every issued chunk is on
    the card and records the ``h2d_overlap_ms`` span; ``abort()`` drops the
    device buffer (its backing host pages are freed separately via
    ``abort_put``).

    The buffer lies on the current CUDA device, or on the CPU where there
    is none (``device_land_always`` on a CPU host). ``fetch_bytes`` keeps
    a finished zone for the deserialize that follows (:func:`keep_landed`),
    whose frames then land from the device buffer, not from the host
    bytes; single-tensor consumers may instead read the finished chunks
    as one tensor (:func:`assemble_device_tensor`)."""

    def __init__(self, dest, chunk_bytes: Optional[int] = None, pinned=None):
        """``pinned``: the pinned CPU ``uint8`` tensor ``dest`` views, when
        the destination is one (:func:`pinned_landing_buffer`)."""
        from ray_tpu_torch.config import cfg

        torch = _torch()
        self.dest = dest
        self.total = dest.nbytes
        self.chunk_bytes = max(
            1 << 20,
            int(cfg.device_land_chunk_bytes)
            if chunk_bytes is None
            else chunk_bytes,
        )
        # a side stream writes it, the pinned ring's or the zone's own
        # (each after whatever the current stream still runs on that
        # memory; a buffer dropped by abort() is not handed out again
        # before those writes are done)
        self._on_card = torch.cuda.is_available()
        self._buf = torch.empty(
            self.total,
            dtype=torch.uint8,
            device="cuda" if self._on_card else "cpu",
        )
        self._pinned = pinned if self._on_card else None
        self._stream = None
        if self._pinned is not None:
            self._stream = torch.cuda.Stream()
            self._stream.wait_stream(torch.cuda.current_stream())
            self._buf.record_stream(self._stream)
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)  # no copy in flight
        self._inflight = 0  # claimed ranges still being copied
        self._landed: List[Tuple[int, int]] = []  # merged [off, end) spans
        self._shipped = 0  # contiguous prefix bytes claimed for copying
        self._chunks: List[Tuple[int, int]] = []  # claimed windows, in order
        self._aborted = False
        self._t0 = time.time()
        self._tp0 = time.perf_counter()
        self._h2d_s = 0.0

    @property
    def device_buffer(self):
        """The device copy of the whole object (complete after a
        ``finish()`` that returned every chunk); None after an abort."""
        return self._buf

    # -- stripe accounting ---------------------------------------------
    def note_stripe(self, off: int, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            if self._aborted:
                return
            self._merge(off, off + n)
            claimed = self._claim()
        self._ship(claimed)

    def _claim(self) -> Tuple[int, int, int]:
        """Claim the landed prefix not yet copied, in whole ``chunk_bytes``
        windows (and the tail once the whole object has landed); zone lock
        held. Returns ``(a, b, windows)``, ``windows`` 0 when there is
        nothing to copy."""
        prefix = min(self._prefix(), self.total)
        a = self._shipped
        if prefix >= self.total:
            b = self.total
        else:
            b = a + (prefix - a) // self.chunk_bytes * self.chunk_bytes
        if b <= a:
            return a, a, 0
        windows = list(range(a, b, self.chunk_bytes))
        self._chunks.extend((w, min(w + self.chunk_bytes, b)) for w in windows)
        self._shipped = b
        self._inflight += 1
        return a, b, len(windows)

    def _ship(self, claimed: Tuple[int, int, int]) -> None:
        """Copy a claimed range of ``dest`` into the device buffer, through
        an async DMA from a pinned destination, else through the pinned
        ring. Runs outside the zone lock, so the threads of the other
        stripes go on receiving. A ring copy returns once the source has
        been read out, and ``abort()`` waits for it, so ``abort_put`` may
        free staged arena pages once ``abort()`` returns; a pinned
        destination is the zone's caller's, and torch's pinned allocator
        holds it until the DMAs that read it are done."""
        a, b, windows = claimed
        if not windows:
            return
        t0 = time.perf_counter()
        try:
            if self._stream is not None:
                torch = _torch()
                with torch.cuda.stream(self._stream):
                    self._buf[a:b].copy_(self._pinned[a:b], non_blocking=True)
            elif self._on_card:
                src = np.frombuffer(self.dest[a:b], dtype=np.uint8)
                _STAGER.copy(self._buf[a:b], src)
            else:
                src = np.frombuffer(self.dest[a:b], dtype=np.uint8)
                self._buf[a:b].copy_(cpu_bytes(src))
            _stats["device_land_chunks_total"] += windows
        finally:
            with self._lock:
                self._h2d_s += time.perf_counter() - t0
                self._inflight -= 1
                self._idle.notify_all()

    def _merge(self, a: int, b: int) -> None:
        spans = self._landed
        spans.append((a, b))
        spans.sort()
        merged = [spans[0]]
        for s, e in spans[1:]:
            ls, le = merged[-1]
            if s <= le:
                merged[-1] = (ls, max(le, e))
            else:
                merged.append((s, e))
        self._landed = merged

    def _prefix(self) -> int:
        if not self._landed or self._landed[0][0] != 0:
            return 0
        return self._landed[0][1]

    # -- completion ----------------------------------------------------
    def finish(self) -> List[Any]:
        """Wait until every issued chunk is on the device; returns the
        ordered chunks (``uint8`` views of the device buffer, covering the
        whole object for a fully landed transfer)."""
        with self._lock:
            # a transfer smaller than one chunk (or whose tail stripe was
            # never reported) ships its remainder here
            claimed = (0, 0, 0) if self._aborted else self._claim()
        self._ship(claimed)
        with self._lock:
            while self._inflight:
                self._idle.wait()
            chunks = [self._buf[a:b] for a, b in self._chunks]
        if self._on_card and chunks:
            t0 = time.perf_counter()
            if self._stream is not None:
                torch = _torch()
                torch.cuda.current_stream().wait_stream(self._stream)
                self._stream.synchronize()
            else:
                _STAGER.wait()
            self._h2d_s += time.perf_counter() - t0
        try:
            from ray_tpu_torch.util.tracing import SPANS

            SPANS.record(
                "h2d_overlap_ms",
                "device_plane",
                self._t0,
                time.perf_counter() - self._tp0,
                bytes=int(self.total),
                chunks=len(chunks),
                h2d_ms=round(self._h2d_s * 1e3, 3),
            )
        except Exception:  # noqa: BLE001 - observability only
            pass
        return chunks

    def abort(self) -> None:
        """Drop the device buffer. The staged HOST pages are the caller's
        to free (``store.abort_put`` — the zone never owns them), so an
        aborted device landing leaks neither side. It returns once no copy
        reads the staged pages any more, so ``abort_put`` may free them
        at once."""
        with self._lock:
            self._aborted = True
            while self._inflight:  # copies still reading the staged pages
                self._idle.wait()
            self._chunks = []
            self._buf = None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "total": self.total,
                "prefix": self._prefix(),
                "shipped": self._shipped,
                "chunks": len(self._chunks),
                "aborted": self._aborted,
            }


def pinned_landing_buffer(total: int):
    """``(ndarray, tensor)``: a pinned host buffer of ``total`` bytes for a
    socket fetch that opens a landing zone on a card — the stripes land in
    pinned memory, so the zone's copies are DMAs alone. The block comes
    from, and returns to, torch's pinned-memory cache."""
    torch = _torch()
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    return host.numpy(), host


def assemble_device_tensor(
    chunks: Sequence[Any], dtype_name: str, shape: Sequence[int]
):
    """Reassemble a tensor from a landing zone's ordered uint8 chunks —
    concatenate, reinterpret and reshape on the chunks' device, so a raw
    single-tensor receive never builds a second host copy."""
    torch = _torch()
    flat = chunks[0] if len(chunks) == 1 else torch.cat(list(chunks))
    return flat.view(resolve_dtype(dtype_name)).reshape(tuple(shape))


def debug_block() -> dict:
    """DebugState ``object_plane.device`` block (agent/worker surfaces)."""
    out = {"enabled": device_plane_enabled()}
    out.update(device_stats())
    return out
