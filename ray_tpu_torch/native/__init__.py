"""Native (C++) runtime components, built on demand with the system g++.

Port of ``ray_tpu/native/``: the shared-memory object store
(``object_store.cc``, ``shm_store.py``), the node resource ledger
(``ledger.cc``, ``native_ledger.py``), the wire framing (``wire.cc``), the
socket data plane (``net.cc``, ``net.py``), the dark-plane counters, the
spilling store, the shared-memory ring channels that ``dag/`` runs on
(``ring.cc``) and their build step.
"""
from .build import build_native  # noqa: F401
from .shm_store import NativeObjectStore  # noqa: F401
