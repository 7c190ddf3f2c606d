"""ctypes binding for the C++ fixed-point resource ledger (ledger.cc).

Drop-in replacement for the pure-Python NodeResourceLedger
(ray_tpu_torch/scheduler/resources.py): same interface, native admission path
(the LocalResourceManager analog the node agent hits on every lease).

Port of ``ray_tpu/native/native_ledger.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Mapping

import numpy as np

from .build import build_native

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_native("ledger"))
            lib.rtpu_ledger_create.restype = ctypes.c_void_p
            lib.rtpu_ledger_create.argtypes = [ctypes.c_uint64]
            lib.rtpu_ledger_destroy.argtypes = [ctypes.c_void_p]
            lib.rtpu_ledger_grow.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            for fn in (
                "rtpu_ledger_add_capacity",
                "rtpu_ledger_try_allocate",
                "rtpu_ledger_release",
                "rtpu_ledger_is_feasible",
            ):
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                f.argtypes = [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_uint32),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_uint64,
                ]
            lib.rtpu_ledger_snapshot.restype = ctypes.c_int
            lib.rtpu_ledger_snapshot.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_uint64,
            ]
            _lib = lib
    return _lib


def _as_arrays(fp_map: Dict[int, int]):
    n = len(fp_map)
    cols = (ctypes.c_uint32 * n)(*fp_map.keys())
    amts = (ctypes.c_int64 * n)(*fp_map.values())
    return cols, amts, n


class NativeNodeResourceLedger:
    """Same contract as scheduler.resources.NodeResourceLedger, C++ core."""

    def __init__(self, vocab, total: Mapping[str, float]):
        self.vocab = vocab
        self._lib = _load()
        self._cap = max(vocab.capacity, 16)
        self._h = self._lib.rtpu_ledger_create(self._cap)
        if not self._h:
            raise MemoryError("native ledger allocation failed")
        self.add_capacity(total)

    def _ensure_cap(self) -> None:
        if self.vocab.capacity > self._cap:
            self._cap = self.vocab.capacity
            self._lib.rtpu_ledger_grow(self._h, self._cap)

    def add_capacity(self, extra: Mapping[str, float]) -> None:
        fp = self.vocab.pack_fp(extra)  # interning may grow the vocab...
        self._ensure_cap()  # ...so grow the native arrays after packing
        cols, amts, n = _as_arrays(fp)
        rc = self._lib.rtpu_ledger_add_capacity(self._h, cols, amts, n)
        assert rc == 0, f"native ledger add_capacity failed ({rc})"

    def is_feasible(self, req) -> bool:
        self._ensure_cap()
        cols, amts, n = _as_arrays(req.demands)
        return self._lib.rtpu_ledger_is_feasible(self._h, cols, amts, n) == 1

    def is_available(self, req) -> bool:
        avail = self._snapshot()[1]
        return all(avail[c] >= q for c, q in req.demands.items())

    def try_allocate(self, req) -> bool:
        self._ensure_cap()
        cols, amts, n = _as_arrays(req.demands)
        return self._lib.rtpu_ledger_try_allocate(self._h, cols, amts, n) == 1

    def release(self, req) -> None:
        self._ensure_cap()
        cols, amts, n = _as_arrays(req.demands)
        rc = self._lib.rtpu_ledger_release(self._h, cols, amts, n)
        assert rc != -2, "over-release detected by native ledger"

    def _snapshot(self):
        total = (ctypes.c_int64 * self._cap)()
        avail = (ctypes.c_int64 * self._cap)()
        n = self._lib.rtpu_ledger_snapshot(self._h, total, avail, self._cap)
        if n < 0:  # vocab grew since; retry once at the new capacity
            self._ensure_cap()
            return self._snapshot()
        return np.frombuffer(total, np.int64, n), np.frombuffer(avail, np.int64, n)

    def _fp_to_map(self, arr) -> Dict[str, float]:
        from ray_tpu_torch.scheduler.resources import from_fp

        return {
            self.vocab.name(c): from_fp(int(v))
            for c, v in enumerate(arr)
            if v and c < self.vocab.num_resources
        }

    def total_map(self) -> Dict[str, float]:
        return self._fp_to_map(self._snapshot()[0])

    def avail_map(self) -> Dict[str, float]:
        return self._fp_to_map(self._snapshot()[1])

    def __del__(self):
        try:
            if self._h:
                self._lib.rtpu_ledger_destroy(self._h)
                self._h = None
        except Exception:  # noqa: BLE001
            pass
