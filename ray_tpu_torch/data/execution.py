"""Streaming operator topology + autoscaling actor pools for ray_tpu_torch.data.

Port of ``ray_tpu/data/execution.py``, on the port's runtime
(``core.runtime.get_runtime``, ``cluster.client._ship_module_by_value``).
The execution half of Ray Data, rebuilt for this runtime (Ray's
capabilities: python/ray/data/_internal/execution/ —
streaming_executor_state.py select_operator_to_run:626,
actor_pool_map_operator.py:77 with locality ranking :380-429,
resource_manager.py:55 memory budgets):

- a Dataset plan compiles to STAGES: consecutive row/batch task ops fuse
  into one task stage (one remote call per block); a ``map_batches`` with
  an actor compute strategy forms its own stage backed by an autoscaling
  actor pool (stateful / callable-class UDFs run here).
- consumption runs all stages as one pipeline: every stage has bounded
  in-flight work, dispatch favors the most-downstream runnable stage (the
  select_operator_to_run bias — finishing blocks closest to the output
  releases memory earliest), and blocks flow between stages as ObjectRefs
  without ever funneling through the driver.
- backpressure is a BYTE budget, not a CPU-count window: each stage's
  admission window is cfg.data_inflight_budget_bytes divided by a block
  size estimated from the first block of its input (sampled-uniform
  assumption; re-estimated as real blocks complete).
- actor pools autoscale in [min_size, max_size]: scale up one actor per
  loop tick while input is queued and every live actor is at its
  in-flight cap; actors idle past cfg.data_actor_idle_reap_s (above
  min_size) are reaped; dispatch prefers an actor on a node that already
  holds the input block (locality ranking via the head's object
  directory), tie-broken by least load.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.config import cfg


class ActorPoolStrategy:
    """compute= strategy for map_batches: an autoscaling pool of actor
    workers (reference: ray.data.ActorPoolStrategy / compute.py)."""

    def __init__(
        self,
        min_size: int = 1,
        max_size: Optional[int] = None,
        max_tasks_in_flight_per_actor: Optional[int] = None,
    ):
        if min_size < 1:
            raise ValueError("min_size must be >= 1")
        if max_size is not None and max_size < min_size:
            raise ValueError("max_size must be >= min_size")
        self.min_size = min_size
        self.max_size = max_size or max(min_size, min_size * 4)
        self.max_tasks_in_flight = (
            max_tasks_in_flight_per_actor
            or cfg.data_max_tasks_in_flight_per_actor
        )

    def __repr__(self) -> str:
        return f"ActorPoolStrategy({self.min_size}, {self.max_size})"


def actors(min_size: int = 1, max_size: Optional[int] = None) -> ActorPoolStrategy:
    """Shorthand: compute=actors(2, 8)."""
    return ActorPoolStrategy(min_size, max_size)


@dataclass
class TaskStage:
    """Fused chain of row/batch ops, one stateless remote task per block."""

    ops: List[tuple]
    num_cpus: Optional[float] = None
    max_concurrency: Optional[int] = None  # explicit concurrency= cap


@dataclass
class ActorStage:
    """One map_batches op executed on an autoscaling actor pool."""

    fn: Any  # callable or callable class
    kwargs: dict  # batch_size / batch_format / zero_copy
    pool: ActorPoolStrategy = field(default_factory=ActorPoolStrategy)
    num_cpus: Optional[float] = None
    fn_constructor_args: tuple = ()
    fn_constructor_kwargs: dict = field(default_factory=dict)


class _BatchWorker:
    """Actor-pool map worker: instantiates a callable-class UDF once and
    applies it per block (actor_pool_map_operator's _MapWorker)."""

    def __init__(self, fn_ser: bytes, ctor_args: tuple, ctor_kwargs: dict):
        fn = cloudpickle.loads(fn_ser)
        self._fn = (
            fn(*ctor_args, **ctor_kwargs) if isinstance(fn, type) else fn
        )

    def ready(self) -> bool:
        return True

    def apply(self, op_kwargs: dict, block: List[Any]) -> List[Any]:
        from .dataset import _apply_batches

        return _apply_batches(self._fn, block, op_kwargs)


class _PoolActor:
    __slots__ = ("handle", "node_id", "ongoing", "idle_since")

    def __init__(self, handle, node_id):
        self.handle = handle
        self.node_id = node_id
        self.ongoing = 0
        self.idle_since = time.monotonic()


class _ActorPool:
    """Driver-side pool state for one ActorStage."""

    def __init__(self, stage: ActorStage, rt):
        self._stage = stage
        self._rt = rt
        # UDFs defined in driver scripts/tests aren't importable on
        # workers: register their module for by-value pickling first
        # (same treatment task/actor submission applies to user code)
        from ray_tpu_torch.cluster.client import _ship_module_by_value

        _ship_module_by_value(stage.fn)
        self._fn_ser = cloudpickle.dumps(stage.fn)
        self.actors: List[_PoolActor] = []
        for _ in range(stage.pool.min_size):
            self._spawn()

    def _spawn(self) -> None:
        opts: dict = {"max_restarts": 1}
        if self._stage.num_cpus is not None:
            opts["num_cpus"] = self._stage.num_cpus
        handle = (
            ray_tpu_torch.remote(_BatchWorker)
            .options(**opts)
            .remote(
                self._fn_ser,
                self._stage.fn_constructor_args,
                self._stage.fn_constructor_kwargs,
            )
        )
        node_id = None
        loc = getattr(self._rt, "actor_location", None)
        if loc is not None:
            try:
                node_id, _ = loc(handle._actor_id)
            except Exception:  # noqa: BLE001
                node_id = None
        self.actors.append(_PoolActor(handle, node_id))

    @property
    def size(self) -> int:
        return len(self.actors)

    def has_capacity(self) -> bool:
        cap = self._stage.pool.max_tasks_in_flight
        return any(a.ongoing < cap for a in self.actors)

    def maybe_scale_up(self, queued: int) -> None:
        if (
            queued > 0
            and self.size < self._stage.pool.max_size
            and not self.has_capacity()
        ):
            self._spawn()

    def reap_idle(self) -> None:
        now = time.monotonic()
        reap_after = cfg.data_actor_idle_reap_s
        while self.size > self._stage.pool.min_size:
            victim = next(
                (
                    a
                    for a in self.actors
                    if a.ongoing == 0 and now - a.idle_since > reap_after
                ),
                None,
            )
            if victim is None:
                return
            self.actors.remove(victim)
            try:
                ray_tpu_torch.kill(victim.handle)
            except Exception:  # noqa: BLE001
                pass

    def pick(self, block_locations: List[str]) -> Optional[_PoolActor]:
        """Locality-ranked pick (actor_pool_map_operator.py:380-429
        capability): among actors with capacity, prefer one whose node
        already holds the block; tie-break by least ongoing work."""
        cap = self._stage.pool.max_tasks_in_flight
        cands = [a for a in self.actors if a.ongoing < cap]
        if not cands:
            return None
        if block_locations:
            local = [a for a in cands if a.node_id in block_locations]
            if local:
                cands = local
        best = min(cands, key=lambda a: a.ongoing)
        # refresh unknown node ids lazily — but only when locality is in
        # play: host-resident blocks have no locations, and polling
        # WaitActor per pick for them was a measurable RPC storm during
        # pool ramp (pending actors answer slowly)
        if best.node_id is None and block_locations:
            loc = getattr(self._rt, "actor_location", None)
            if loc is not None:
                try:
                    best.node_id, _ = loc(best.handle._actor_id)
                except Exception:  # noqa: BLE001
                    pass
        return best

    def submit(self, actor: _PoolActor, op_kwargs: dict, block):
        actor.ongoing += 1
        return actor.handle.apply.remote(op_kwargs, block)

    def submit_window(
        self, actor: _PoolActor, op_kwargs: dict, blocks: List[Any]
    ) -> List[Any]:
        """Submit a window of blocks to ONE actor in one batched pass —
        rides the runtime's ordered submission batch (one bookkeeping
        lock + one channel wakeup per window instead of per block).
        Falls back to per-block submission on runtimes without the
        batch API (the in-process local runtime)."""
        batch = getattr(self._rt, "submit_actor_method_batch", None)
        actor.ongoing += len(blocks)
        if batch is None:
            return [
                actor.handle.apply.remote(op_kwargs, b) for b in blocks
            ]
        return batch(
            actor.handle._actor_id,
            "apply",
            [((op_kwargs, b), {}) for b in blocks],
        )

    def complete(self, actor: _PoolActor) -> None:
        actor.ongoing -= 1
        if actor.ongoing == 0:
            actor.idle_since = time.monotonic()

    def shutdown(self) -> None:
        for a in self.actors:
            try:
                ray_tpu_torch.kill(a.handle)
            except Exception:  # noqa: BLE001
                pass
        self.actors.clear()


def _est_bytes(block: Any) -> int:
    """Cheap block-size estimate for the byte budget."""
    try:
        return max(1, len(cloudpickle.dumps(block)))
    except Exception:  # noqa: BLE001
        return 1 << 16


@dataclass
class _StageState:
    stage: Any  # TaskStage | ActorStage
    queue: Any = field(default_factory=deque)  # input blocks/refs
    in_flight: Dict[str, tuple] = field(default_factory=dict)  # hex -> meta
    pool: Optional[_ActorPool] = None
    est_block_bytes: Optional[int] = None
    # True once est came from a MEASURED block (seal size of a completed
    # output), not an inherited/seeded guess
    est_measured: bool = False
    sample_attempts: int = 0  # bounded retries when a measurement fails

    def window(self) -> int:
        """Byte-budget admission window (resource_manager.py:55 analog):
        budget / estimated block size, clamped to keep the pipeline both
        alive and bounded. Until a REAL size sample lands the window stays
        conservative — the old 64KiB default admitted 1024 in-flight
        multi-MB blocks, gigabytes past the budget."""
        if self.est_block_bytes is None:
            return 16
        w = int(cfg.data_inflight_budget_bytes // self.est_block_bytes)
        cap = 1024 if self.est_measured else 16
        return max(2, min(w, cap))


class StreamingExecutor:
    """Pull-based pipeline over the stage list; yields output blocks (or
    refs) in completion order."""

    def __init__(self, input_blocks: List[Any], stages: List[Any]):
        from ray_tpu_torch.core.runtime import get_runtime

        self._rt = get_runtime()
        self._stages = [_StageState(s) for s in stages]
        if self._stages:
            self._stages[0].queue = deque(input_blocks)
            # byte-budget seed: sample the first host-resident block (ref
            # inputs start from the conservative default and inherit
            # estimates downstream)
            if input_blocks and not isinstance(
                input_blocks[0], ray_tpu_torch.ObjectRef
            ):
                self._stages[0].est_block_bytes = _est_bytes(input_blocks[0])
                self._stages[0].est_measured = True
            elif input_blocks:
                # ObjectRef inputs: calibrate stage 0 from one input's
                # seal size (nothing downstream ever samples INTO stage
                # 0, which would otherwise sit at the conservative window
                # forever — a ~64x parallelism cap for small blocks)
                size = self._measure_block(input_blocks[0], fetch_timeout=0.5)
                if size:
                    self._stages[0].est_block_bytes = size
                    self._stages[0].est_measured = True
        for st in self._stages:
            if isinstance(st.stage, ActorStage):
                st.pool = _ActorPool(st.stage, self._rt)
        self._locations: Dict[str, List[str]] = {}
        # refs MINTED by this pipeline (stage outputs fed downstream):
        # owned exclusively by the executor, so the moment the consuming
        # task completes they are garbage — freed eagerly in batches so a
        # 50k-block run doesn't accrete dead blocks in the stores until
        # the Python GC happens to run
        self._intermediate: set = set()
        self._free_batch: List[ray_tpu_torch.ObjectRef] = []

    def _note_consumed(self, block: Any) -> None:
        # Same semantics as dropping the executor's last ObjectRef (the
        # head runs the identical free cascade, lineage release included,
        # when the decref lands) — just eager and batched instead of
        # waiting on Python GC + the flusher. Downstream blocks whose
        # reconstruction would need a freed input were equally
        # unreconstructable under the drop-ref path.
        if (
            isinstance(block, ray_tpu_torch.ObjectRef)
            and block.hex in self._intermediate
        ):
            self._intermediate.discard(block.hex)
            self._free_batch.append(block)

    def _flush_frees(self, force: bool = False) -> None:
        if not self._free_batch or (len(self._free_batch) < 64 and not force):
            return
        batch, self._free_batch = self._free_batch, []
        free = getattr(self._rt, "free_objects", None)
        if free is None:
            return
        try:
            free(batch)
        except Exception:  # noqa: BLE001 - GC is advisory
            pass

    def _measure_block(
        self, ref: ray_tpu_torch.ObjectRef, fetch_timeout: float = 5.0
    ) -> int:
        """Real byte size of a completed block: seal size from the object
        directory. On a cluster runtime the directory answer is FINAL —
        the old fallback pulled the entire remote block to the driver
        just to size it (a multi-MB fetch per stage calibration); when
        the seal size is unknown the conservative window default stands.
        Only the in-process local runtime (no directory, objects already
        in this heap) still samples one pickle."""
        sizes_fn = getattr(self._rt, "object_sizes", None)
        if sizes_fn is not None:
            size = sizes_fn([ref]).get(ref.hex, 0)
            return int(size) if size else 0
        try:
            return _est_bytes(self._rt.get_object(ref, fetch_timeout))
        except Exception:  # noqa: BLE001
            return 0

    # ------------------------------------------------------------------
    def _locate(self, refs: List[ray_tpu_torch.ObjectRef]) -> None:
        """Batch-resolve block locations for locality ranking (head object
        directory; no-op on the local runtime)."""
        fn = getattr(self._rt, "object_locations", None)
        if fn is None:
            return
        missing = [r for r in refs if r.hex not in self._locations]
        if not missing:
            return
        try:
            self._locations.update(fn(missing))
        except Exception:  # noqa: BLE001
            for r in missing:
                self._locations[r.hex] = []

    def _dispatch_one(self, si: int, st: _StageState) -> bool:
        block = st.queue[0]
        if isinstance(st.stage, TaskStage):
            from .dataset import _apply_chain

            opts = {}
            if st.stage.num_cpus is not None:
                opts["num_cpus"] = st.stage.num_cpus
            task = _apply_chain.options(**opts) if opts else _apply_chain
            ref = task.remote(block, st.stage.ops)
        else:
            return self._dispatch_actor_window(si, st, budget=1) > 0
        st.in_flight[ref.hex] = (ref, si, None, block)
        st.queue.popleft()
        return True

    def _dispatch_actor_window(
        self, si: int, st: _StageState, budget: int
    ) -> int:
        """Dispatch up to ``budget`` queued blocks onto pool actors, a
        per-actor WINDOW per submission batch: each window rides one
        batched submit (one channel wakeup / one pipelined message)
        instead of a per-block round through the submission path."""
        dispatched = 0
        cap = st.stage.pool.max_tasks_in_flight
        while st.queue and dispatched < budget:
            head = st.queue[0]
            locs = (
                self._locations.get(head.hex, [])
                if isinstance(head, ray_tpu_torch.ObjectRef)
                else []
            )
            actor = st.pool.pick(locs)
            if actor is None:
                st.pool.maybe_scale_up(len(st.queue))
                break
            window = min(
                budget - dispatched, max(1, cap - actor.ongoing), len(st.queue)
            )
            blocks = [st.queue.popleft() for _ in range(window)]
            refs = st.pool.submit_window(actor, st.stage.kwargs, blocks)
            for ref, block in zip(refs, blocks):
                st.in_flight[ref.hex] = (ref, si, actor, block)
            dispatched += window
        return dispatched

    def _stage_capacity(self, st: _StageState) -> int:
        cap = st.window() - len(st.in_flight)
        if isinstance(st.stage, TaskStage) and st.stage.max_concurrency:
            cap = min(cap, st.stage.max_concurrency - len(st.in_flight))
        return cap

    def run(self) -> Iterator[ray_tpu_torch.ObjectRef]:
        """Yields final-stage output refs as they complete."""
        stages = self._stages
        if not stages:
            return
        try:
            while True:
                # 1) dispatch, most-downstream stage first: finishing
                #    near-output blocks releases pipeline memory earliest
                for si in range(len(stages) - 1, -1, -1):
                    st = stages[si]
                    if st.pool is not None and st.queue:
                        refs = [
                            b
                            for b in itertools.islice(st.queue, 64)
                            if isinstance(b, ray_tpu_torch.ObjectRef)
                        ]
                        self._locate(refs)
                    budget = self._stage_capacity(st)
                    if st.pool is not None:
                        if budget > 0:
                            self._dispatch_actor_window(si, st, budget)
                        st.pool.maybe_scale_up(len(st.queue))
                        st.pool.reap_idle()
                    else:
                        while st.queue and budget > 0:
                            if not self._dispatch_one(si, st):
                                break
                            budget -= 1
                all_inflight = [
                    meta[0]
                    for st in stages
                    for meta in st.in_flight.values()
                ]
                if not all_inflight:
                    if all(not st.queue for st in stages):
                        return
                    # queues non-empty but nothing dispatchable (pool
                    # saturated edge): brief yield, loop again
                    time.sleep(0.005)
                    continue
                # 2) wait for completions anywhere in the pipeline; after
                # the first is ready, sweep everything already completed
                # in the same pass (one dispatch scan amortizes over the
                # whole batch instead of one scan per block)
                ready, rest = ray_tpu_torch.wait(
                    all_inflight,
                    num_returns=1,
                    timeout=1.0,
                )
                if ready and rest:
                    more, _ = ray_tpu_torch.wait(
                        rest, num_returns=len(rest), timeout=0.0
                    )
                    ready = ready + more
                for ref in ready:
                    for si, st in enumerate(stages):
                        meta = st.in_flight.pop(ref.hex, None)
                        if meta is None:
                            continue
                        if meta[2] is not None:
                            st.pool.complete(meta[2])
                        # the consuming task is done with its input: an
                        # executor-owned intermediate block is garbage NOW
                        self._note_consumed(meta[3])
                        # calibrate the byte budget from the first MEASURED
                        # output of this stage (seal size from the
                        # directory; local fallback re-pickles one block) —
                        # the module's backpressure claim was previously
                        # seeded-only. Measure only
                        # when a downstream stage still needs it; bounded
                        # retries when a measurement comes back empty.
                        tgt = (
                            stages[si + 1] if si + 1 < len(stages) else None
                        )
                        if (
                            tgt is not None
                            and not tgt.est_measured
                            and st.sample_attempts < 5
                        ):
                            st.sample_attempts += 1
                            size = self._measure_block(ref)
                            if size:
                                tgt.est_block_bytes = size
                                tgt.est_measured = True
                        nxt = si + 1
                        if nxt < len(stages):
                            # executor-minted ref flowing downstream: we
                            # are its only holder — eligible for the
                            # eager free once its consumer completes
                            self._intermediate.add(ref.hex)
                            stages[nxt].queue.append(ref)
                            if stages[nxt].est_block_bytes is None:
                                stages[nxt].est_block_bytes = (
                                    st.est_block_bytes
                                )
                        else:
                            yield ref
                        break
                self._flush_frees()
        finally:
            self._flush_frees(force=True)
            for st in stages:
                if st.pool is not None:
                    st.pool.shutdown()

    def run_refs(self) -> List[ray_tpu_torch.ObjectRef]:
        return list(self.run())
