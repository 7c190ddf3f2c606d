"""On-demand compilation of the native components (no pybind11 — pure C ABI
consumed via ctypes).

Port of ``ray_tpu/native/build.py``. The port compiles its own copy of the
C++ sources (``native/*.cc`` here) with the system ``g++`` at first use,
into the git-ignored ``native/_build/``. Only the shared-memory object store
is ported so far; the ledger, ring, wire and net sources wait for the
cluster runtime.
"""
from __future__ import annotations

import os
import subprocess
import threading

_lock = threading.Lock()
_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_HERE, "_build")

SOURCES = {
    "objstore": "object_store.cc",
}


def build_native(name: str = "objstore") -> str:
    """Compile (if stale) and return the path to lib<name>.so."""
    src = os.path.join(_HERE, SOURCES[name])
    out = os.path.join(_BUILD_DIR, f"lib{name}.so")
    with _lock:
        if (
            os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)
        ):
            return out
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # per-pid tmp: concurrent processes may compile simultaneously;
        # os.replace keeps the publish atomic either way
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(
            [
                "g++",
                "-O2",
                "-std=c++17",
                "-shared",
                "-fPIC",
                "-o",
                tmp,
                src,
                "-lpthread",
            ],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, out)
    return out
