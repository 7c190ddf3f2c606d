"""Native (C++) runtime components, built on demand with the system g++.

Port of ``ray_tpu/native/``: the shared-memory object store
(``object_store.cc``, ``shm_store.py``) and its build step.
"""
from .build import build_native  # noqa: F401
from .shm_store import NativeObjectStore  # noqa: F401
