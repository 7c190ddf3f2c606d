"""Per-worker training session context (ray.train.get_context analog).

Port of ``ray_tpu/train/session.py``: the same context, ``report`` with
its durable ``_latest_checkpoint`` pointer, and ``DataIterator`` over a
rank's shard of a ``ray_tpu_torch.data.Dataset`` passed in ``datasets=``.
Batches stay numpy; the loop moves them to its device."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from .checkpoint import Checkpoint


class DataIterator:
    """Per-worker view of one dataset shard (ray.train DataIterator
    analog): ``iter_batches`` defaults to streaming ingest at
    cfg.data_prefetch_batches depth, so the train step overlaps the
    shard's object-plane pulls (and the shuffle reduce tail feeding
    them) instead of stalling between batches."""

    def __init__(self, dataset: Any):
        self._ds = dataset

    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        batch_format: str = "numpy",
        prefetch_batches: Optional[int] = None,
    ) -> Iterator[Any]:
        if prefetch_batches is None:
            from ray_tpu_torch.config import cfg

            prefetch_batches = int(cfg.data_prefetch_batches)
        return self._ds.iter_batches(
            batch_size=batch_size,
            batch_format=batch_format,
            prefetch_batches=prefetch_batches,
        )

    def iter_rows(self) -> Iterator[Any]:
        return self._ds.iter_rows()

    def count(self) -> int:
        return self._ds.count()

    def materialize(self):
        return self._ds.materialize()


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    node_rank: int = 0
    experiment_name: str = ""
    trial_dir: str = ""
    latest_checkpoint: Optional[Checkpoint] = None
    # elastic runs: this rank's GangContext (epoch-fenced collectives
    # over the virtual-shard grid); None under the legacy TorchTrainer
    gang: Optional[Any] = None
    # per-rank dataset shards (TorchTrainer datasets=), wrapped as
    # DataIterators at access time
    dataset_shards: Dict[str, Any] = field(default_factory=dict)
    # reporting channel back to the controller
    _reports: List[Dict[str, Any]] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest_checkpoint

    def get_gang(self) -> Any:
        if self.gang is None:
            raise RuntimeError(
                "no gang context (not an elastic run; use ElasticTrainer)"
            )
        return self.gang

    def get_dataset_shard(self, name: str = "train") -> DataIterator:
        ds = self.dataset_shards.get(name)
        if ds is None:
            raise KeyError(
                f"no dataset shard {name!r}; pass datasets={{{name!r}: ds}} "
                "to TorchTrainer"
            )
        return DataIterator(ds)


_session = threading.local()


def _set_context(ctx: Optional[TrainContext]) -> None:
    _session.ctx = ctx


def get_context() -> TrainContext:
    ctx = getattr(_session, "ctx", None)
    if ctx is None:
        raise RuntimeError("not inside a train worker (no session context)")
    return ctx


def get_dataset_shard(name: str = "train") -> DataIterator:
    """ray.train.get_dataset_shard parity: this rank's shard of a
    dataset passed to TorchTrainer(datasets=...), as a streaming
    DataIterator."""
    return get_context().get_dataset_shard(name)


def report(
    metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None
) -> None:
    """ray.train.report parity: record metrics (+ checkpoint) for this step."""
    import os

    ctx = get_context()
    with ctx._lock:
        ctx._reports.append(
            {"metrics": dict(metrics), "checkpoint": checkpoint}
        )
    if checkpoint is not None and ctx.trial_dir and ctx.world_rank == 0:
        # Durable pointer so the controller can restore after a crash even
        # when the checkpoint directory lives outside trial_dir.
        pointer = os.path.join(ctx.trial_dir, "_latest_checkpoint")
        tmp = pointer + ".tmp"
        with open(tmp, "w") as f:
            f.write(checkpoint.path)
        os.replace(tmp, pointer)
