"""Ids shared by the runtimes.

Port of ``ray_tpu/cluster/common.py``: only ``new_id`` (``:27``) and
``stream_item_id`` (``:57``), the two the local runtime calls. The
control-plane dataclasses wait for the cluster runtime that sends them.
"""
from __future__ import annotations


def new_id() -> str:
    from .._ids import rand_hex

    return rand_hex(8)  # buffered urandom: no syscall per id


def stream_item_id(task_id: str, index: int) -> str:
    """Deterministic object id for item ``index`` of a streaming-generator
    task. Determinism is the recovery story: a retried generator re-seals
    the SAME ids, so refs a consumer already iterated resolve to the
    re-executed copies (the reference derives generator return ids from
    task id + return index the same way)."""
    import hashlib

    return hashlib.blake2b(
        f"{task_id}:{index}".encode(), digest_size=14
    ).hexdigest()
