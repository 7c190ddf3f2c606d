"""RDT — tensor transport between actors/tasks.

Port of ``ray_tpu/rdt.py`` (the reference's RDT tier moves GPU buffers
process to process over NIXL/NCCL side channels,
Ray's python/ray/experimental/rdt/nixl_tensor_transport.py). The
transports, as the port has them:

1. **same process** — hand the ``torch.Tensor`` over by reference: zero
   copies, a CUDA buffer never leaves the card (local-runtime
   compiled-DAG edges and direct returns already do this).
2. **cross process, same host** — one D2H copy into the *shared-memory
   arena* (no pickle, no socket), then one H2D copy on the consumer. This
   module implements that: raw dtype/shape header + buffer bytes staged
   zero-copy through the node's shm store / DAG ring.
3. **cross host** — the reference rides the ICI/DCN mesh inside jit. The
   port's counterpart is the in-program plane of ``ray_tpu_torch.parallel``
   (``torch.distributed`` groups over a mesh, NCCL between cards): a
   program launched on every rank moves tensors with its collectives
   (``parallel.collectives``). RDT adds no API of its own for it, as the
   reference adds none.

``put_tensor``/``get_tensor`` give the explicit API; the tensor codec is
also used by compiled-DAG shm edges so tensors crossing a ring skip
cloudpickle entirely.

The codec's bytes for a numpy array are the reference's, byte for byte.
A torch tensor encodes as kind ``"torch"`` with its dtype by torch's name
and the device it came from: a CUDA tensor takes one D2H copy and decodes
back onto the card (a process without one raises rather than hand back a
CPU tensor), a CPU tensor decodes as a CPU tensor. A numpy frame whose
dtype numpy cannot name here (bfloat16 without ``ml_dtypes``) decodes as
a CPU tensor of torch's dtype of that name.
"""
from __future__ import annotations

import json
from typing import Any, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.cluster import device_plane as dp

_MAGIC = b"RDT1"


def encode_tensor(value: Any) -> Optional[bytes]:
    """Raw wire form for torch tensors and numpy arrays (None: not a
    tensor). One D2H copy for a CUDA tensor; CPU tensors and numpy
    arrays encode without a copy of the payload beyond the write
    itself."""
    if isinstance(value, torch.Tensor):
        return _encode_torch(value)
    if type(value) is not np.ndarray:  # subclasses (MaskedArray) need pickle
        return None
    host = value
    # only plain numeric/bool buffers: structured dtypes, object dtypes,
    # and datetime-ish kinds don't survive a raw name+bytes round trip
    d = host.dtype
    if d.names is not None or d.hasobject or d.kind not in "biufcV":
        return None
    if d.kind == "V" and d.name.startswith("void"):
        return None  # raw void blobs (e.g. structured leftovers)
    if not d.isnative:
        # dtype travels by NAME (no byte order): normalize to native first
        host = host.astype(d.newbyteorder("="))
    # reshape: ascontiguousarray lifts a 0-d array to 1-d, which the
    # reference's frame then records as shape [1]
    host = np.ascontiguousarray(host).reshape(host.shape)
    # dtype by NAME: extension types (bfloat16, float8_*) have no loadable
    # numpy .str form, but their names resolve on decode
    header = json.dumps(
        {"k": "np", "d": host.dtype.name, "s": list(host.shape)}
    ).encode()
    return _MAGIC + len(header).to_bytes(4, "little") + header + host.tobytes()


def _encode_torch(t) -> Optional[bytes]:
    name = dp.dtype_name(t.dtype)
    if (
        name is None
        or t.layout is not torch.strided
        or t.is_quantized
        or t.device.type not in ("cpu", "cuda")
    ):
        return None
    host = t.detach().resolve_conj().resolve_neg().contiguous().cpu()
    header = json.dumps(
        {"k": "torch", "d": name, "s": list(host.shape), "dev": t.device.type}
    ).encode()
    raw = host.reshape(-1).view(torch.uint8).numpy().tobytes()
    return _MAGIC + len(header).to_bytes(4, "little") + header + raw


def decode_tensor(data: bytes) -> Tuple[bool, Any]:
    """(is_tensor, value). A CUDA tensor lands back on the current CUDA
    device via one H2D copy; everything else stays host-side, writable
    and decoupled from the wire buffer."""
    if not data.startswith(_MAGIC):
        return False, None
    hlen = int.from_bytes(data[4:8], "little")
    meta = json.loads(data[8 : 8 + hlen])
    npd = dp.numpy_dtype(meta["d"])
    if meta["k"] != "torch" and npd is not None:
        arr = np.frombuffer(data, dtype=npd, offset=8 + hlen).reshape(meta["s"])
        return True, arr.copy()  # writable, decoupled from the wire buffer
    raw = np.frombuffer(data, dtype=np.uint8, offset=8 + hlen)
    if meta.get("dev") == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"tensor frame {meta['d']}{list(meta['s'])} was encoded from a "
                "CUDA tensor, and this process sees no CUDA device"
            )
        out = dp.h2d(raw)  # the device plane's land copy
    else:
        out = dp.cpu_bytes(raw).clone()
    return True, out.view(dp.resolve_dtype(meta["d"])).reshape(meta["s"])


def put_tensor(value: Any) -> "ray_tpu_torch.ObjectRef":
    """Stage a tensor into the object plane with the raw codec (no
    pickle). Plain ``ray_tpu_torch.put`` works too — this path skips the
    serializer and keeps dtype/shape as a 1-line header.

    Device-plane fast path: a sealable ``torch.Tensor`` skips this codec
    entirely and seals as a DEVICE FRAME (cluster/device_plane) — the
    encode here pays a full host copy of the payload (``tobytes``), where
    the device frame exports a CPU tensor zero-copy and lands a CUDA one
    back on the card with one H2D straight from the arriving arena view.
    The codec stays as the fallback for numpy arrays and a disabled
    plane."""
    if dp.device_plane_enabled() and dp.is_sealable_device_array(value):
        return ray_tpu_torch.put(value)
    data = encode_tensor(value)
    if data is None:
        raise TypeError(
            f"put_tensor expects a torch tensor or numpy array, got {type(value)}"
        )
    return ray_tpu_torch.put(_RdtBlob(data))


def get_tensor(ref: "ray_tpu_torch.ObjectRef", timeout: Optional[float] = None) -> Any:
    # explicit landing scope: rdt payloads are tensors by contract, so
    # this pull opts the socket fetch into the device landing zone
    # (stripes stream to the card in flight, and the frame lands from
    # that copy) — generic gets don't
    with dp.landing("device"):
        out = ray_tpu_torch.get(ref, timeout=timeout)
    if isinstance(out, _RdtBlob):
        ok, value = decode_tensor(out.data)
        if ok:
            return value
    return out


class _RdtBlob:
    """Pickle-thin wrapper: the payload is already raw bytes, so pickling
    this object is a header + one memcpy (no element-wise serialization)."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data

    def __reduce__(self):
        return (_RdtBlob, (self.data,))
