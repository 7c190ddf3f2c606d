"""Model-weights hub in the shared-memory arena (hot-swap plane).

Port of ``ray_tpu/serve/model_store.py``. Where the reference seals
``jax.Array`` leaves as device frames and lands them with one
``device_put`` each, the port seals CUDA tensors as the device frames of
``cluster/device_plane.py`` and lands them on the caller's device. Host
tensors travel as numpy arrays, so a pull gives tensors over READ-ONLY
views of the arena, as the reference's numpy views are; a bf16 host
tensor goes as its ``uint16`` bits with its dtype recorded, as
``train/checkpoint.py`` writes it (numpy cannot name bf16 without
``ml_dtypes``).

Variant/LoRA weights a deployment multiplexes are published ONCE per
node into the shm arena under a deterministic object id derived from
``(deployment, model_id, version)`` — the arena itself is the index,
first writer wins, concurrent publishes of the same version are benign
no-ops (same idiom as the prefix cache).

Swap observability lives here too: every hot-swap's wall-clock, drain
time, and the first-token-on-new-weights latency are exported so the
zero-stream-errors swap check has numbers to gate on.
"""
from __future__ import annotations

import hashlib
import threading
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.cluster import serialization as wire
from ray_tpu_torch.train import pytree
from ray_tpu_torch.util.metrics import Counter, Histogram

WEIGHT_SWAPS = Counter(
    "serve_weight_swaps_total",
    "Completed replica weight hot-swaps.",
    label_names=("deployment", "model"),
)
WEIGHT_SWAP_FAILURES = Counter(
    "serve_weight_swap_failures_total",
    "Weight hot-swaps that failed (pull miss, bad version, error).",
    label_names=("deployment", "model"),
)
WEIGHT_SWAP_MS = Histogram(
    "serve_weight_swap_ms",
    "End-to-end hot-swap wall time: drain + pull + install (ms).",
    boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000),
    label_names=("deployment", "model"),
)
WEIGHT_SWAP_DRAIN_MS = Histogram(
    "serve_weight_swap_drain_ms",
    "Time draining in-flight generation on the old weights-epoch (ms).",
    boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000),
    label_names=("deployment", "model"),
)
FIRST_TOKEN_NEW_WEIGHTS_MS = Histogram(
    "serve_first_token_new_weights_ms",
    "Latency from swap completion to the first token generated on the "
    "new weights-epoch (ms).",
    boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000),
    label_names=("deployment", "model"),
)


def _seal_leaves(params: Any) -> Tuple[pytree.TreeDef, List[Any], List[Optional[str]]]:
    """(treedef, leaves, dtype names): a CUDA tensor stays a tensor (a
    device frame); a host tensor becomes a numpy array over its bytes
    (bf16 as ``uint16`` bits) with its dtype's name beside it."""
    leaves, treedef = pytree.flatten(params)
    out, names = [], []
    for leaf in leaves:
        name = None
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu":
            t = leaf.detach().contiguous()
            name = str(t.dtype).rpartition(".")[2]
            leaf = (t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16
                    else t.numpy())
        out.append(leaf)
        names.append(name)
    return treedef, out, names


def _land_leaf(leaf: Any, name: Optional[str], device: Optional[torch.device]) -> Any:
    """A pulled leaf as a tensor on ``device`` (default: where it landed;
    no copy when it is already there): a landed device frame as it is, a
    host leaf as a tensor over the read-only arena view."""
    if isinstance(leaf, np.ndarray):
        with warnings.catch_warnings():  # the view is read-only, and stays unwritten
            warnings.simplefilter("ignore", UserWarning)
            leaf = (torch.from_numpy(leaf.view(np.int16)).view(torch.bfloat16)
                    if name == "bfloat16" else torch.from_numpy(leaf))
    if isinstance(leaf, torch.Tensor) and device is not None:
        return leaf.to(device)
    return leaf


def weights_oid(deployment: str, model_id: str, version: int) -> str:
    """Deterministic arena object id for one published weights pytree —
    any process on the node derives the same id, so there is no side
    table to reconcile."""
    return hashlib.sha256(
        b"wts\0"
        + deployment.encode()
        + b"\0"
        + model_id.encode()
        + b"\0"
        + str(int(version)).encode()
    ).hexdigest()[:32]


class WeightsHub:
    """Publish/pull weights pytrees through a ``NativeObjectStore``-like
    object (needs ``put_frames``/``get_view``/``contains``/``delete``).

    Best-effort by design: a failed publish or a pull miss just means
    the caller falls back to its closure-captured variant params (the
    cold-start path) — correctness never depends on the arena.
    """

    def __init__(self, store, deployment: str):
        self.store = store
        self.deployment = deployment
        self._lock = threading.Lock()
        self._mine: dict = {}  # oid -> size, for best-effort cleanup

    # -- publish -------------------------------------------------------
    def publish(self, model_id: str, version: int, params: Any) -> bool:
        """Seal ``params`` into the arena under its deterministic oid.
        CUDA tensors go in as device frames (one D2H copy each), host
        tensors as numpy arrays. Returns False when the entry already
        exists or the arena cannot take it."""
        oid = weights_oid(self.deployment, model_id, version)
        try:
            if self.store.contains(oid):
                return False
        except Exception:  # noqa: BLE001
            return False
        meta = {
            "deployment": self.deployment,
            "model": model_id,
            "version": int(version),
        }
        try:
            parts, total = wire.dumps_parts((meta, *_seal_leaves(params)))
        except Exception:  # noqa: BLE001 - unsealable leaf
            return False
        for attempt in (0, 1):
            try:
                self.store.put_frames(oid, parts)
                break
            except KeyError:
                return False  # concurrent publisher won the race
            except MemoryError:
                if attempt == 1:
                    return False
                with self._lock:
                    # arena pressure: drop our own older versions first
                    self._evict_locked()
            except Exception:  # noqa: BLE001 - store gone
                return False
        with self._lock:
            self._mine[oid] = total
        return True

    def _evict_locked(self) -> None:
        while self._mine:
            oid, _size = self._mine.popitem()
            try:
                self.store.delete(oid)
            except Exception:  # noqa: BLE001 - already gone
                pass

    # -- pull ----------------------------------------------------------
    def pull(self, model_id: str, version: int,
             device: Optional[torch.device] = None) -> Optional[Any]:
        """The published pytree for ``(model_id, version)``, or None on
        a miss. Device-frame leaves come back as CUDA tensors on
        ``device`` (one H2D copy each, straight from the arena page —
        request the device landing explicitly so the wire layer knows the
        frames should not bounce through host staging); host-sealed
        leaves are tensors over READ-ONLY views that alias the arena until
        the returned tree is garbage collected."""
        oid = weights_oid(self.deployment, model_id, version)
        try:
            view = self.store.get_view(oid)
        except KeyError:
            return None
        except Exception:  # noqa: BLE001
            return None
        try:
            from ray_tpu_torch.cluster import device_plane as _dp

            if _dp.device_plane_enabled():
                with _dp.landing("device"):
                    meta, treedef, leaves, names = wire.loads(view)
            else:
                meta, treedef, leaves, names = wire.loads(view)
        except Exception:  # noqa: BLE001 - corrupt entry
            return None
        if meta.get("model") != model_id or meta.get("version") != int(
            version
        ):
            return None
        return pytree.unflatten(
            treedef, [_land_leaf(x, n, device) for x, n in zip(leaves, names)])

    def ensure(self, model_id: str, version: int, params: Any) -> bool:
        """Publish-or-already-present: the idempotent shape a retrying
        publisher needs (the online-RL two-phase publish re-runs its
        whole cycle after a head failover — a version its earlier
        attempt already sealed must read as success, not a race loss)."""
        if self.contains(model_id, version):
            return True
        if self.publish(model_id, version, params):
            return True
        return self.contains(model_id, version)

    def contains(self, model_id: str, version: int) -> bool:
        try:
            return self.store.contains(
                weights_oid(self.deployment, model_id, version)
            )
        except Exception:  # noqa: BLE001
            return False


def hub_from_node(deployment: str) -> Optional[WeightsHub]:
    """A :class:`WeightsHub` over this node's shm arena (the worker's
    open handle, or the process-local fallback arena the prefix cache
    also uses); None when no native store is reachable."""
    from ray_tpu_torch.serve.prefix_cache import node_store

    store = node_store()
    if store is None:
        return None
    return WeightsHub(store, deployment)
