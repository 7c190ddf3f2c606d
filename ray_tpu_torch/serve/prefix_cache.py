"""Cross-replica prefix/KV cache in the shared-memory arena.

Port of ``ray_tpu/serve/prefix_cache.py`` over the port's
``native/shm_store.NativeObjectStore``, ``cluster/serialization`` and
``cluster/device_plane``. Where the reference's device-frame hits are
``jax.Array``, the port's are torch tensors: a block sealed from a CUDA
tensor lands on the card with one H2D copy (``PrefixHit.on_device``), a
host-sealed block comes back as a read-only numpy view over the arena, and
``PrefixHit.to_device`` makes the one H2D hop for it.

Replica engines on the same node share prefilled KV pages through the
node's shm arena (the object plane): an entry is the head-major KV
block ``[n_layers, n_kv_heads, pages, page, head_dim]`` for a
page-aligned token prefix, stored under a DETERMINISTIC object id
derived from a rolling page-chain hash — the arena itself is the index,
so there is no side table to keep consistent across replica processes
and no coordination on insert (first writer wins; a concurrent second
insert of the same prefix is a benign no-op).

Hits are **read-only view pins, not copies**: ``lookup`` resolves the
entry via ``NativeObjectStore.get_view`` and the zero-copy wire format,
so the returned numpy arrays alias the arena pages directly. The pin
follows the arena's view semantics — a concurrent delete defers the arena free
to the last view's finalizer, and a SIGKILLed replica's outstanding
pins are replayed from its pin log by the agent (never leaked). The
engine copies the views into its device pool and drops them; the pin
dies with the views.

Capacity is self-policed per inserting process (``max_bytes``): the
oldest own entries are deleted first, and an arena-full put evicts then
retries once before giving up (caching is always best-effort — a miss
just recomputes prefill).
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.cluster import device_plane
from ray_tpu_torch.cluster import serialization as wire
from ray_tpu_torch.util.metrics import Counter, Gauge

PREFIX_HITS = Counter(
    "serve_prefix_cache_hits_total",
    "Prefix-cache lookups that returned a pinned KV view.",
)
PREFIX_MISSES = Counter(
    "serve_prefix_cache_misses_total",
    "Prefix-cache lookups that found no cached prefix.",
)
PREFIX_INSERTS = Counter(
    "serve_prefix_cache_inserts_total",
    "Prefix KV blocks inserted into the shared arena.",
)
PREFIX_BYTES = Gauge(
    "serve_prefix_cache_bytes",
    "Bytes of prefix KV this process currently has inserted.",
)
PREFIX_HIT_TOKENS = Counter(
    "serve_prefix_cache_hit_tokens_total",
    "Prompt tokens whose prefill was skipped via cached KV.",
)


def _chain_hashes(tokens: Sequence[int], page: int) -> List[bytes]:
    """Rolling hash per FULL page: ``out[i]`` commits to tokens
    ``[0, (i+1)*page)``. A prefix of a prompt therefore shares the
    prompt's leading hashes — longest-prefix probing is just walking
    this list backwards."""
    out: List[bytes] = []
    h = hashlib.sha256()
    n_full = len(tokens) // page
    for i in range(n_full):
        chunk = tokens[i * page : (i + 1) * page]
        h.update(np.asarray(chunk, dtype=np.int64).tobytes())
        out.append(h.digest())
    return out


def as_tensor(x, device) -> torch.Tensor:
    """A KV block (a tensor, or a numpy array such as a read-only arena
    view, bfloat16 included) as a tensor on ``device``, with one copy: one
    H2D copy through the device plane's pinned ring for a host array bound
    for a card."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.ascontiguousarray(x)
    raw = a.reshape(-1).view(np.uint8)
    t = device_plane.h2d(raw) if device.type == "cuda" else torch.from_numpy(raw.copy())
    return t.view(device_plane.resolve_dtype(a.dtype.name)).reshape(a.shape)


class PrefixHit:
    """One pinned cache hit: ``k``/``v`` cover ``tokens`` prompt tokens
    with shape ``[L, KH, pages, page, hd]``. For entries sealed from CUDA
    tensors (device-plane inserts) they are already CUDA tensors, landed
    with one H2D copy straight from the arena page; host-sealed entries
    come back as READ-ONLY numpy views over the arena. ``release()`` drops
    the views (and with them the arena pin) once the caller has
    copied/consumed them."""

    __slots__ = ("tokens", "k", "v", "_view")

    def __init__(self, tokens: int, k, v, view):
        self.tokens = tokens
        self.k = k
        self.v = v
        self._view = view

    def on_device(self) -> bool:
        """True when ``k``/``v`` landed as CUDA tensors (device frames)."""
        return isinstance(self.k, torch.Tensor) and self.k.is_cuda

    def to_device(self, device="cuda"):
        """``(k, v)`` on ``device``: device-frame hits already there return
        their tensors as they are; host-view hits pay the one H2D hop here
        (after which the caller may ``release()``: the copy owns its
        memory)."""
        return as_tensor(self.k, device), as_tensor(self.v, device)

    def release(self) -> None:
        self.k = self.v = self._view = None


class SharedPrefixCache:
    """Prefix-hash → KV-block cache over a ``NativeObjectStore``-like
    object (needs ``put_frames``/``get_view``/``contains``/``delete``/
    ``object_size``)."""

    def __init__(
        self,
        store,
        *,
        page_size: int,
        model_sig: str,
        max_bytes: int = 64 << 20,
        max_prefix_pages: int = 64,
    ):
        self.store = store
        self.page = int(page_size)
        self.model_sig = model_sig
        self._base_sig = model_sig
        self.max_bytes = int(max_bytes)
        self.max_prefix_pages = int(max_prefix_pages)
        self._lock = threading.Lock()
        # own inserts, insertion-ordered, oid -> size (self-policed budget)
        self._mine: "OrderedDict[str, int]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0

    def _oid(self, chain_hash: bytes) -> str:
        return hashlib.sha256(
            b"pfx\0" + self.model_sig.encode() + b"\0" + chain_hash
        ).hexdigest()[:32]

    def retag(self, tag: str) -> None:
        """Re-namespace the cache for a weights swap: KV computed under
        the previous weights must never be restored for the new ones, so
        the signature (and with it every object id) changes. Entries
        from the old epoch age out of the store via the shared budget;
        engines on other replicas that swap to the same ``tag`` land on
        the same namespace and keep sharing."""
        self.model_sig = f"{self._base_sig}|{tag}"

    # -- lookup --------------------------------------------------------
    def lookup(
        self, tokens: Sequence[int], max_tokens: Optional[int] = None
    ) -> Optional[PrefixHit]:
        """Longest cached page-aligned prefix of ``tokens`` (capped at
        ``max_tokens``), longest-first probe. Returns a pinned
        :class:`PrefixHit` or None."""
        hashes = _chain_hashes(tokens, self.page)
        if max_tokens is not None:
            hashes = hashes[: max(0, int(max_tokens)) // self.page]
        hashes = hashes[: self.max_prefix_pages]
        for i in range(len(hashes) - 1, -1, -1):
            oid = self._oid(hashes[i])
            try:
                view = self.store.get_view(oid)
            except KeyError:
                continue  # this prefix length not cached; try shorter
            except Exception:  # noqa: BLE001
                break  # store trouble: treat as a miss, don't spin
            try:
                meta, k, v = wire.loads(view)
            except Exception:  # noqa: BLE001 - corrupt entry: skip it
                continue
            if meta.get("tokens") != (i + 1) * self.page or meta.get(
                "page"
            ) != self.page:
                continue
            self.hits += 1
            PREFIX_HITS.inc()
            PREFIX_HIT_TOKENS.inc(meta["tokens"])
            return PrefixHit(meta["tokens"], k, v, view)
        self.misses += 1
        PREFIX_MISSES.inc()
        return None

    def contains_prefix(self, tokens: Sequence[int]) -> bool:
        """Cheap existence probe (hash + store.contains, no data read):
        callers use it to skip expensive KV extraction when the entry is
        already published."""
        n = (len(tokens) // self.page) * self.page
        if n == 0:
            return False
        chain = _chain_hashes(tokens[:n], self.page)
        try:
            return self.store.contains(self._oid(chain[-1]))
        except Exception:  # noqa: BLE001
            return True  # store trouble: claim present so callers skip

    # -- insert --------------------------------------------------------
    def insert(
        self,
        tokens: Sequence[int],
        k: np.ndarray,
        v: np.ndarray,
    ) -> bool:
        """Insert the KV block for the FULL pages of ``tokens``
        (``len(tokens)`` must be a page multiple matching ``k``'s page
        axis). Best-effort: returns False when the entry already exists
        or the arena cannot take it."""
        n = len(tokens)
        if n == 0 or n % self.page != 0:
            return False
        pages = n // self.page
        if pages > self.max_prefix_pages or k.shape[2] != pages:
            return False
        chain = _chain_hashes(tokens, self.page)
        oid = self._oid(chain[pages - 1])
        try:
            if self.store.contains(oid):
                return False
        except Exception:  # noqa: BLE001
            return False
        meta = {"tokens": n, "page": self.page}
        # numpy blocks need the contiguity fix-up here; tensors go in
        # as they are: the device-aware pickler seals them as device frames
        # (a CPU tensor's export is zero-copy, a CUDA tensor's one D2H copy
        # or the pump) and the export itself owns contiguity
        parts, total = wire.dumps_parts(
            (
                meta,
                np.ascontiguousarray(k) if isinstance(k, np.ndarray) else k,
                np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v,
            )
        )
        with self._lock:
            self._evict_locked(self.max_bytes - total)
        for attempt in (0, 1):
            try:
                self.store.put_frames(oid, parts)
                break
            except KeyError:
                return False  # concurrent insert won the race
            except MemoryError:
                if attempt == 1:
                    return False
                with self._lock:
                    # arena pressure: give back half our budget and retry
                    self._evict_locked(self._bytes // 2)
            except Exception:  # noqa: BLE001 - store gone
                return False
        with self._lock:
            self._mine[oid] = total
            self._bytes += total
            PREFIX_BYTES.set(self._bytes)
        self.inserts += 1
        PREFIX_INSERTS.inc()
        return True

    def _evict_locked(self, budget: int) -> None:
        """Delete own oldest entries until our bytes fit ``budget``.
        Outstanding reader pins are safe: delete defers the arena free
        to the last view finalizer (zombie semantics)."""
        while self._mine and self._bytes > max(0, budget):
            oid, size = self._mine.popitem(last=False)
            self._bytes -= size
            try:
                self.store.delete(oid)
            except Exception:  # noqa: BLE001 - already evicted/spilled
                pass
        PREFIX_BYTES.set(self._bytes)

    # -- observability -------------------------------------------------
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "inserts": self.inserts,
            "hit_rate": round(self.hits / total, 4) if total else None,
            "bytes": self._bytes,
        }


# ---------------------------------------------------------------------------
# store discovery: replicas bind to whatever arena their process can see
# ---------------------------------------------------------------------------
_local_store = None
_local_lock = threading.Lock()


def node_store():
    """The shm store shared by this process's node, if any.

    Inside a cluster worker this is the worker's already-open arena
    handle (pin tracking enabled, so SIGKILL replay covers cache pins).
    In a single-process runtime (tests, notebooks) a process-local
    arena is created on first use so co-resident replicas still share;
    returns None when the native store is unavailable.
    """
    from ray_tpu_torch.cluster import worker as worker_mod

    w = getattr(worker_mod, "_CURRENT_WORKER", None)
    if w is not None and getattr(w, "store", None) is not None:
        return w.store
    global _local_store
    with _local_lock:
        if _local_store is None:
            try:
                import os
                import tempfile

                from ray_tpu_torch.native import NativeObjectStore

                path = os.path.join(
                    tempfile.gettempdir(),
                    f"ray_tpu_torch_prefix_{os.getpid()}.shm",
                )
                _local_store = NativeObjectStore(
                    path=path, capacity=128 << 20
                )
            except Exception:  # noqa: BLE001 - toolchain missing
                _local_store = False
    return _local_store or None


def cache_from_cfg(
    *, page_size: int, model_sig: str
) -> Optional[SharedPrefixCache]:
    """Build the node-shared cache per config; None when disabled or no
    arena is reachable."""
    from ray_tpu_torch.config import cfg

    if not cfg.serve_prefix_cache:
        return None
    store = node_store()
    if store is None:
        return None
    return SharedPrefixCache(
        store,
        page_size=page_size,
        model_sig=model_sig,
        max_bytes=int(cfg.serve_prefix_cache_bytes),
    )
