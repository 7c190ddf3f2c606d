"""TorchTrainer: controller + worker-group execution with fault tolerance.

Port of ``ray_tpu/train/trainer.py``; ``TorchTrainer`` is the counterpart
of ``ray_tpu/train/trainer.py::JaxTrainer`` under Ray's own name for it.
Reference shape: train/v2 controller & worker group
(Ray's python/ray/train/v2/_internal/execution/worker_group/
worker_group.py:113). Workers are actors gang-placed via a placement
group; each runs the user's train_loop_per_worker with a TrainContext
carrying rank/world info and the restore checkpoint. On worker failure
the whole group restarts from the latest reported checkpoint
(FailurePolicy semantics). The compute inside the loop is the user's
torch code; the workers are the control plane. As the reference sets no
``jax.distributed`` environment, the port sets no ``torch.distributed``
one: only ``RAY_TPU_WORLD_SIZE``.
"""
from __future__ import annotations

import os
import tempfile
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.scheduling_strategies import PlacementGroupSchedulingStrategy
from .checkpoint import Checkpoint
from .session import TrainContext, _set_context


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_tpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_tpu:
            res.setdefault("TPU", 1.0)
        return res


@dataclass
class FailureConfig:
    # ray parity: -1 means retry forever (elastic/chaos runs where the
    # cluster is expected to heal); 0 means fail on the first error
    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)


@dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)


def kill_actors_bounded(actors, deadline_s: float) -> None:
    """Best-effort parallel kill of a worker group under ONE wall-clock
    deadline. Runs on daemon threads, not a pool: a kill RPC that
    wedges past the deadline is simply abandoned — a daemon thread
    can't block interpreter exit, and an infinite-retry trainer doesn't
    accrue stuck pool threads across attempts."""
    import threading

    def _kill(w):
        try:
            ray_tpu_torch.kill(w)
        except Exception:  # noqa: BLE001
            pass

    threads = [
        threading.Thread(
            target=_kill, args=(w,), daemon=True,
            name="train-teardown-kill",
        )
        for w in actors
    ]
    for t in threads:
        t.start()
    deadline = time.monotonic() + float(deadline_s)
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))


@ray_tpu_torch.remote
class _TrainWorker:
    """One rank of the worker group."""

    def __init__(self, rank: int, world_size: int, experiment_name: str,
                 trial_dir: str):
        self.ctx = TrainContext(
            world_rank=rank,
            world_size=world_size,
            local_rank=rank,
            experiment_name=experiment_name,
            trial_dir=trial_dir,
        )
        # Multi-host wiring: like the reference, which sets no
        # jax.distributed coordinator here, only the world size is
        # exported; a loop that wants a process group builds its own.
        os.environ.setdefault("RAY_TPU_WORLD_SIZE", str(world_size))

    def run(self, fn: Callable, config: Dict[str, Any],
            restore: Optional[str],
            dataset_shards: Optional[Dict[str, Any]] = None,
            ) -> List[Dict[str, Any]]:
        self.ctx.latest_checkpoint = (
            Checkpoint(restore) if restore else None
        )
        self.ctx.dataset_shards = dict(dataset_shards or {})
        self.ctx._reports = []
        _set_context(self.ctx)
        try:
            fn(config)
        finally:
            _set_context(None)
        # checkpoints are serialized by path
        return [
            {
                "metrics": r["metrics"],
                "checkpoint": r["checkpoint"].path if r["checkpoint"] else None,
            }
            for r in self.ctx._reports
        ]


class TorchTrainer:
    """Data-parallel trainer driving a gang of workers.

    train_loop_per_worker(config) runs on every rank; use
    ray_tpu_torch.train.get_context() / report() inside it.
    """

    def __init__(
        self,
        train_loop_per_worker: Callable[[Dict[str, Any]], None],
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: ScalingConfig = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self.train_loop = train_loop_per_worker
        self.config = dict(train_loop_config or {})
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        # name -> Dataset; split() into one shard per rank at launch,
        # consumed in the loop via train.get_dataset_shard(name)
        # (streaming iter_batches with prefetch — ingest overlaps the
        # train step)
        self.datasets = dict(datasets or {})

    # retry backoff bounds (class attrs so tests can shrink them):
    # decorrelated jitter keeps a persistently-unschedulable placement
    # group from hot-looping create/remove against the head
    RETRY_BACKOFF_BASE_S = 0.2
    RETRY_BACKOFF_CAP_S = 10.0

    def fit(self) -> Result:
        import random

        name = self.run_config.name or f"train-{uuid.uuid4().hex[:6]}"
        storage = self.run_config.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_results"
        )
        trial_dir = os.path.join(storage, name)
        os.makedirs(trial_dir, exist_ok=True)

        max_failures = self.run_config.failure_config.max_failures
        restore_path: Optional[str] = None
        attempt = 0
        rng = random.Random()
        sleep_s = self.RETRY_BACKOFF_BASE_S
        while True:
            try:
                reports = self._run_attempt(name, trial_dir, restore_path)
                return self._build_result(trial_dir, reports)
            except Exception as exc:  # noqa: BLE001
                attempt += 1
                restore_path = self._latest_checkpoint_path(trial_dir)
                # max_failures=-1: infinite retries (ray parity)
                if 0 <= max_failures < attempt:
                    return Result(
                        metrics={},
                        checkpoint=(
                            Checkpoint(restore_path) if restore_path else None
                        ),
                        path=trial_dir,
                        error=exc,
                    )
                # decorrelated jitter (AWS backoff family): sleep in
                # [base, 3*prev], capped — retries de-phase instead of
                # hammering an unschedulable PG in lockstep
                sleep_s = min(
                    self.RETRY_BACKOFF_CAP_S,
                    rng.uniform(
                        self.RETRY_BACKOFF_BASE_S, sleep_s * 3.0
                    ),
                )
                time.sleep(sleep_s)

    # teardown budget for killing the gang: a kill RPC against a node
    # that died mid-attempt can wedge past its transport retries — the
    # bundle reservation must not leak behind a hung finally
    TEARDOWN_KILL_DEADLINE_S = 10.0

    # -- internals ------------------------------------------------------
    def _run_attempt(self, name, trial_dir, restore_path):
        n = self.scaling.num_workers
        res = self.scaling.worker_resources()
        pg = ray_tpu_torch.placement_group(
            [dict(res)] * n, strategy=self.scaling.placement_strategy
        )
        workers = []
        try:
            if not pg.wait(timeout_seconds=30):
                # raise INSIDE the try: the finally below removes the
                # pending PG — before this, an unschedulable attempt
                # leaked one parked reservation per retry
                raise TimeoutError(
                    f"placement group for {n} workers x {res} not schedulable"
                )
            # one shard per rank, split ONCE per attempt: blocks become
            # ObjectRefs here (pending ops execute through the streaming
            # shuffle plane) and only the refs ship to the workers — each
            # rank pulls its own shard's blocks over the object plane as
            # its prefetching iterator reaches them
            shard_lists = {
                dname: ds.split(n) for dname, ds in self.datasets.items()
            }
            workers = [
                _TrainWorker.options(
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=pg, placement_group_bundle_index=i
                    ),
                    resources={},  # held by the bundle reservation
                ).remote(i, n, name, trial_dir)
                for i in range(n)
            ]
            refs = [
                w.run.remote(
                    self.train_loop,
                    self.config,
                    restore_path,
                    {
                        dname: shards[i]
                        for dname, shards in shard_lists.items()
                    },
                )
                for i, w in enumerate(workers)
            ]
            reports_per_rank = ray_tpu_torch.get(refs)
            return reports_per_rank[0]  # rank-0 reports are authoritative
        finally:
            self._teardown(workers, pg)

    def _teardown(self, workers, pg) -> None:
        """Bounded gang teardown: kills run concurrently under one
        deadline (a kill against a dead node can hang on transport
        retries), and the placement group is removed REGARDLESS — a
        wedged kill must not leak the whole bundle reservation."""
        kill_actors_bounded(workers, self.TEARDOWN_KILL_DEADLINE_S)
        try:
            ray_tpu_torch.remove_placement_group(pg)
        except Exception:  # noqa: BLE001 - head blip; lease sweeps cover
            pass

    @staticmethod
    def _latest_checkpoint_path(trial_dir: str) -> Optional[str]:
        # Only COMPLETE checkpoints count: from_state writes
        # checkpoint_meta.json last (inside its temp dir, atomically
        # renamed into place), so its presence is the commit marker — a
        # crash mid-write must not leave a half-written directory the
        # retry loop happily restores from.
        def _complete(path: str) -> bool:
            return os.path.isdir(path) and os.path.isfile(
                os.path.join(path, "checkpoint_meta.json")
            )

        # 1. durable pointer written by train.report (works for checkpoint
        # dirs outside trial_dir too)
        pointer = os.path.join(trial_dir, "_latest_checkpoint")
        if os.path.isfile(pointer):
            with open(pointer) as f:
                path = f.read().strip()
            if _complete(path):
                return path
        # 2. fall back to the checkpoint_* naming convention inside
        # trial_dir, newest COMPLETE directory wins
        ckpts = sorted(
            d for d in os.listdir(trial_dir) if d.startswith("checkpoint_")
        ) if os.path.isdir(trial_dir) else []
        for d in reversed(ckpts):
            path = os.path.join(trial_dir, d)
            if _complete(path):
                return path
        return None

    def _build_result(self, trial_dir, reports) -> Result:
        metrics = reports[-1]["metrics"] if reports else {}
        ckpt_path = None
        for r in reversed(reports):
            if r["checkpoint"]:
                ckpt_path = r["checkpoint"]
                break
        if ckpt_path is None:
            ckpt_path = self._latest_checkpoint_path(trial_dir)
        return Result(
            metrics=metrics,
            checkpoint=Checkpoint(ckpt_path) if ckpt_path else None,
            path=trial_dir,
            metrics_history=[r["metrics"] for r in reports],
        )
