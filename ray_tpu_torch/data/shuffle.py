"""Distributed shuffle primitives: hash/range partition + reduce.

Port of ``ray_tpu/data/shuffle.py``: for the same blocks, seed and
partition count every partition equals the reference's element for
element (the hash is hashlib's, the RNG numpy's).

The analog of Ray's hash-shuffle operator family
(python/ray/data/_internal/execution/operators/
hash_shuffle.py and planner/exchange/): a map stage partitions every
block by key (hash or sampled range), a reduce stage gathers one
partition id from all map outputs — all as framework tasks over the
object plane, so shuffles ride the same lease/object machinery as any
other workload.

Streaming-shuffle plane:

- **Map side** is vectorized for numeric blocks: destinations come from
  one hashed/bincounted pass and partitions are gathered with a stable
  argsort (``_gather_parts``) instead of per-row list appends; ndarray
  blocks keep their partitions as buffer-backed arrays, so each
  partition's pickle-5 frames scatter-write straight into the local shm
  arena at seal time (worker ``put_value`` → ``put_frames``) — map
  outputs are sealed arena objects from birth, never driver round-trips.
  The row loop remains the generic fallback (non-numeric keys,
  ``RAY_TPU_DATA_VECTOR_SHUFFLE=0``).
- **Placement**: reduce tasks carry ObjectRef deps, which routes them
  through the head kernel; with ``cfg.sched_w_locality`` > 0 the round
  prep uploads per-(shape, node) resident-bytes and the kernel's
  locality term lands each reduce where its map partitions live
  (cluster/head.py ``_round_shapes``, scheduler/hybrid.py
  ``_shape_cost``).
- **Reduce side**: non-resident partitions fetch over the peer-leased
  socket plane with the cross-fetch in-flight byte gate as arena
  backpressure (cluster/transport.py); consumed map-partition refs are
  freed eagerly per reduce seal (``_EagerFreeWatcher``) so a shuffle is
  out-of-core — arena fill is bounded by in-flight reduces, not dataset
  size.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.config import cfg
from ray_tpu_torch.util.metrics import Counter as _Counter

SHUFFLE_PARTS_FREED = _Counter(
    "shuffle_partitions_freed_total",
    "Map-partition refs freed eagerly as their reduce task sealed.",
)


def _stable_hash(value: Any) -> int:
    """Deterministic across worker processes (builtin hash() is salted) and
    type-insensitive for numerics: 1, 1.0, and np.float64(1.0) must land in
    the same partition or groupby/join silently split equal keys."""
    if isinstance(value, (bool, np.bool_)):
        # np.bool_ is NOT a bool subclass: without this it fell through
        # to the repr digest, so True and np.True_ did not co-partition
        value = int(value)
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, (float, np.floating)):
        f = float(value)
        if f.is_integer():
            return int(f)
        data = repr(f).encode()
    elif isinstance(value, (str, np.str_)):
        data = str(value).encode()
    else:
        data = repr(value).encode()
    return int.from_bytes(hashlib.md5(data).digest()[:8], "little")


def _hash_dests(keys: np.ndarray, num_parts: int) -> Optional[np.ndarray]:
    """Vectorized ``_stable_hash(key) % num_parts`` for numeric key
    arrays, or None when the dtype needs the scalar path. Must agree
    with the scalar digest EXACTLY across dtypes (1, 1.0 and
    np.float64(1.0) co-partition): integers hash to themselves, integral
    floats to int(f), and only the non-integral minority takes the
    per-element md5 fallback."""
    if keys.ndim != 1:
        return None
    if keys.dtype == bool:
        keys = keys.astype(np.int64)
    if np.issubdtype(keys.dtype, np.unsignedinteger):
        if keys.size and int(keys.max()) > np.iinfo(np.int64).max:
            return None  # int64 cast would wrap; scalar path is exact
        keys = keys.astype(np.int64)
    if np.issubdtype(keys.dtype, np.integer):
        # int64 % positive is a floor mod, matching Python's
        return (keys.astype(np.int64, copy=False) % num_parts).astype(
            np.int64
        )
    if not np.issubdtype(keys.dtype, np.floating):
        return None
    f = keys.astype(np.float64, copy=False)
    dest = np.empty(f.shape[0], dtype=np.int64)
    integral = np.isfinite(f) & (np.floor(f) == f) & (np.abs(f) < 2.0**63)
    dest[integral] = f[integral].astype(np.int64) % num_parts
    for i in np.flatnonzero(~integral):
        dest[i] = _stable_hash(float(f[i])) % num_parts
    return dest


def _vector_dests(
    rows: Any,
    num_parts: int,
    mode: str,
    key_list: Optional[List[Any]],
    bounds: Optional[List[Any]],
    seed: Optional[int],
) -> Optional[np.ndarray]:
    """int64[n] partition destination per row, or None when this block
    needs the generic row loop. Must compute destinations IDENTICAL to
    the row loop's — both paths coexist across workers in one shuffle.
    ``key_list``: pre-extracted per-row keys when a key_fn exists —
    extracted ONCE by the caller so a vectorization bail-out doesn't pay
    the key_fn pass twice."""
    n = len(rows)
    if mode == "random":
        rng = np.random.default_rng(seed)
        return rng.integers(0, num_parts, size=n).astype(np.int64)
    if key_list is not None:
        try:
            keys = np.asarray(key_list)
        except (TypeError, ValueError):  # ragged / exotic keys
            return None
    elif isinstance(rows, np.ndarray):
        keys = rows
    else:
        try:
            keys = np.asarray(rows)
        except (TypeError, ValueError):
            return None
    if keys.ndim != 1 or keys.dtype.kind not in "biuf":
        return None
    if mode == "hash":
        return _hash_dests(keys, num_parts)
    if mode == "range":
        try:
            barr = np.asarray(bounds)
        except (TypeError, ValueError):
            return None
        if barr.ndim != 1 or barr.dtype.kind not in "biuf":
            return None
        # first bound > key == bisect_right, the row loop's binary search
        dest = np.searchsorted(barr, keys, side="right").astype(np.int64)
        if keys.dtype.kind == "f":
            # NaN: every `bound <= key` comparison in the row loop is
            # False, so it lands in partition 0 — searchsorted would
            # send it to the LAST partition (NaN sorts greatest), and
            # the two paths must agree block-to-block
            dest[np.isnan(keys)] = 0
        return dest
    return None


def _gather_parts(
    rows: Any, dest: np.ndarray, num_parts: int
) -> List[Any]:
    """Partition lists from a destination vector. ndarray blocks gather
    with one stable argsort and stay ndarray partitions (contiguous
    slices → buffer-backed pickle-5 frames → arena scatter writes);
    other blocks keep list partitions with the vectorized destinations
    (row order within a partition matches the append loop's)."""
    if isinstance(rows, np.ndarray):
        order = np.argsort(dest, kind="stable")
        counts = np.bincount(dest, minlength=num_parts)
        ends = np.cumsum(counts)
        g = rows[order]
        return [
            g[e - c : e] for c, e in zip(counts.tolist(), ends.tolist())
        ]
    parts: List[List[Any]] = [[] for _ in range(num_parts)]
    for row, d in zip(rows, dest):
        parts[d].append(row)
    return parts


def _compute_parts(
    block: Any,
    num_parts: int,
    mode: str,
    key_fn: Optional[Callable],
    bounds: Optional[List[Any]],
    seed: Optional[int],
) -> List[Any]:
    """Split one block into num_parts row containers (shared by both map
    tasks): vectorized destinations + gather when the block/keys are
    numeric, the generic row loop otherwise."""
    from .block import block_rows

    block = block_rows(block)  # hash/range partitioning is row-wise
    if mode not in ("random", "hash", "range"):
        raise ValueError(f"unknown partition mode {mode}")
    # keys extracted ONCE: both the vectorized digest and the row-loop
    # fallback consume this list, so a vectorization bail-out never runs
    # the key_fn over the block a second time
    key_list: Optional[List[Any]] = (
        [key_fn(r) for r in block]
        if key_fn is not None and mode in ("hash", "range")
        else None
    )
    if len(block) and num_parts > 0 and cfg.data_vector_shuffle:
        dest = _vector_dests(
            block, num_parts, mode, key_list, bounds, seed
        )
        if dest is not None:
            return _gather_parts(block, dest, num_parts)
    parts: List[List[Any]] = [[] for _ in range(num_parts)]
    if mode == "random":
        rng = np.random.default_rng(seed)
        dest = rng.integers(0, num_parts, size=len(block))
        for row, d in zip(block, dest):
            parts[int(d)].append(row)
    elif mode == "hash":
        keys = key_list if key_list is not None else block
        for row, key in zip(block, keys):
            parts[_stable_hash(key) % num_parts].append(row)
    elif mode == "range":
        keys = key_list if key_list is not None else block
        for row, key in zip(block, keys):
            lo, hi = 0, len(bounds)  # first bound > key
            while lo < hi:
                mid = (lo + hi) // 2
                if bounds[mid] <= key:
                    lo = mid + 1
                else:
                    hi = mid
            parts[lo].append(row)
    return parts


@ray_tpu_torch.remote
def _partition_block(
    block: List[Any],
    num_parts: int,
    mode: str,
    key_fn: Optional[Callable],
    bounds: Optional[List[Any]],
    seed: Optional[int],
) -> tuple:
    """Map side (N-return form): split one block into num_parts lists."""
    parts = _compute_parts(block, num_parts, mode, key_fn, bounds, seed)
    if num_parts == 1:
        return parts[0]  # num_returns=1 -> single (unwrapped) return value
    return tuple(parts)


@ray_tpu_torch.remote
def _partition_block_stream(
    block: List[Any],
    num_parts: int,
    mode: str,
    key_fn: Optional[Callable],
    bounds: Optional[List[Any]],
    seed: Optional[int],
):
    """Map side (streaming form): yield partitions in index order.

    Each partition seals as its own object the moment it is yielded
    (num_returns="streaming"), so reduce p launches as soon as every map
    has emitted its p-th partition — the reference's streaming block
    emission for shuffles (hash_shuffle.py rides ObjectRefGenerator the
    same way) instead of waiting for whole map tasks."""
    for part in _compute_parts(block, num_parts, mode, key_fn, bounds, seed):
        yield part


def _all_ndarray(parts: Sequence[Any]) -> bool:
    return bool(parts) and all(
        isinstance(p, np.ndarray) and p.ndim >= 1 for p in parts
    )


@ray_tpu_torch.remote
def _reduce_concat(*parts: List[Any]) -> List[Any]:
    if _all_ndarray(parts):
        # ndarray partitions concat into an ndarray block: the reduce
        # output stays a single buffer → one arena entry, zero-copy
        # batch slicing downstream
        return np.concatenate(parts)
    out: List[Any] = []
    for p in parts:
        out.extend(p)
    return out


@ray_tpu_torch.remote
def _reduce_shuffled(seed: int, *parts: List[Any]) -> List[Any]:
    rng = np.random.default_rng(seed)
    if _all_ndarray(parts):
        merged = np.concatenate(parts)
        return merged[rng.permutation(len(merged))]
    out: List[Any] = []
    for p in parts:
        out.extend(p)
    return [out[i] for i in rng.permutation(len(out))]


@ray_tpu_torch.remote
def _reduce_sorted(key_fn: Optional[Callable], descending: bool, *parts) -> List[Any]:
    if (
        key_fn is None
        and _all_ndarray(parts)
        and all(p.ndim == 1 for p in parts)
    ):
        # 1-D only: np.sort's axis=-1 would reorder WITHIN rows of a
        # multi-dim partition (silent corruption), not order the rows
        merged = np.sort(np.concatenate(parts), kind="stable")
        return merged[::-1].copy() if descending else merged
    out: List[Any] = []
    for p in parts:
        out.extend(p)
    out.sort(key=key_fn, reverse=descending)
    return out


class _EagerFreeWatcher(threading.Thread):
    """Frees each map-partition ref the moment its LAST consuming reduce
    SEALS (success or exhausted-retries error), in _flush_frees-style
    batches — the shuffle analog of the streaming executor's eager
    intermediate frees. Tracking is per INPUT ref, not per reduce: the
    streaming form can hand one ref to several reduces (a map that
    errors mid-stream repeats its sealed-error ref for every remaining
    partition), and freeing it at the first consumer's seal would strand
    the rest on an unresolvable dep. Bounds arena fill by in-flight
    reduces instead of the whole map stage; the trade (documented on
    cfg.data_shuffle_eager_free) is that an already-sealed reduce output
    can no longer re-reconstruct from freed inputs. Partitions of
    reduces still PENDING are untouched, so mid-shuffle lineage
    reconstruction (node death) keeps working on exactly the lost
    partitions."""

    _BATCH = 64

    def __init__(self, rt, pairs: List[Tuple[Any, List[Any]]]):
        super().__init__(name="shuffle-eager-free", daemon=True)
        self._rt = rt
        self._pairs = pairs

    def run(self) -> None:
        reduces: dict = {}  # reduce hex -> (reduce ref, [input hexes])
        inputs: dict = {}   # input hex -> [input ref, remaining consumers]
        for r, ins in self._pairs:
            reduces[r.hex] = (r, [i.hex for i in ins])
            for i in ins:
                ent = inputs.get(i.hex)
                if ent is None:
                    inputs[i.hex] = [i, 1]
                else:
                    ent[1] += 1
        batch: List[Any] = []
        try:
            while reduces:
                # fate-share with the runtime that owns these refs: a
                # shut-down or replaced runtime makes the frees moot, and
                # a watcher polling wait() against a LATER runtime would
                # spin (and sleep) forever on refs it never knew
                from ray_tpu_torch.core.runtime import get_runtime

                try:
                    cur = get_runtime()
                except Exception:  # noqa: BLE001 - no runtime: exit
                    return
                if (
                    cur is not self._rt
                    or getattr(self._rt, "_shutdown", False)
                    or getattr(self._rt, "_shutdown_done", False)
                ):
                    return
                refs = [v[0] for v in reduces.values()]
                ready, _ = ray_tpu_torch.wait(
                    refs, num_returns=len(refs), timeout=2.0
                )
                for r in ready:
                    _, in_hexes = reduces.pop(r.hex, (None, []))
                    for h in in_hexes:
                        ent = inputs.get(h)
                        if ent is None:
                            continue
                        ent[1] -= 1
                        if ent[1] <= 0:
                            batch.append(ent[0])
                            del inputs[h]
                if batch and (len(batch) >= self._BATCH or not reduces):
                    self._free(batch)
                    batch = []
        except Exception:  # noqa: BLE001 - eager GC is advisory
            pass

    def _free(self, refs: List[Any]) -> None:
        free = getattr(self._rt, "free_objects", None)
        if free is None:
            return
        try:
            free(refs)
            SHUFFLE_PARTS_FREED.inc(len(refs))
        except Exception:  # noqa: BLE001
            pass


def _watch_eager_free(pairs: List[Tuple[Any, List[Any]]]) -> None:
    """Start the per-shuffle eager-free watcher when the runtime supports
    hard frees (no-op on the in-process local runtime) and the knob is
    on."""
    if not cfg.data_shuffle_eager_free or not pairs:
        return
    pairs = [
        (r, [i for i in ins if isinstance(i, ray_tpu_torch.ObjectRef)])
        for r, ins in pairs
        if isinstance(r, ray_tpu_torch.ObjectRef)
    ]
    pairs = [(r, ins) for r, ins in pairs if ins]
    if not pairs:
        return
    try:
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()
    except Exception:  # noqa: BLE001
        return
    if getattr(rt, "free_objects", None) is None:
        return
    _EagerFreeWatcher(rt, pairs).start()


def shuffle_blocks(
    blocks: List[List[Any]],
    num_parts: int,
    *,
    mode: str = "hash",
    key_fn: Optional[Callable] = None,
    bounds: Optional[List[Any]] = None,
    seed: Optional[int] = None,
    reduce_fn=None,
    reduce_args: tuple = (),
    streaming: Optional[bool] = None,
) -> List[Any]:
    """Run the two-stage shuffle; returns one ObjectRef per output part.

    Default (``streaming=None``): the N-return map form — fully
    non-blocking, every task submitted before returning (callers keep
    driver/laziness overlap) — UNLESS locality scheduling is on
    (cfg.sched_w_locality > 0), which auto-selects the streaming form:
    a reduce submitted in lockstep with its partitions' seals carries
    LOCATED deps, so the head's locality term can score it against the
    partitions' actual residency (a reduce submitted before its maps
    ran has nothing to score). ``streaming=True``: maps emit partitions
    through ``num_returns="streaming"`` generators and reduces launch
    as each partition row lands — per-partition seals spread
    object-plane pressure across the map stage instead of one burst per
    map, at the cost of the driver walking the streams (reference:
    hash_shuffle block emission over ObjectRefGenerator).

    Each reduce's map-partition refs are freed eagerly as that reduce
    seals (cfg.data_shuffle_eager_free), so arena fill is bounded by
    in-flight reduces — a 10k-partition shuffle is out-of-core."""
    if reduce_fn is None:
        reduce_fn = _reduce_concat
    if streaming is None:
        streaming = float(cfg.sched_w_locality) > 0
    if streaming:
        return _shuffle_blocks_streaming(
            blocks, num_parts, mode, key_fn, bounds, seed,
            reduce_fn, reduce_args,
        )
    map_refs = [
        _partition_block.options(num_returns=num_parts).remote(
            block,
            num_parts,
            mode,
            key_fn,
            bounds,
            None if seed is None else seed + i,
        )
        for i, block in enumerate(blocks)
    ]
    if num_parts == 1:
        map_refs = [[r] for r in map_refs]
    out = [
        reduce_fn.remote(*reduce_args, *[m[p] for m in map_refs])
        for p in range(num_parts)
    ]
    _watch_eager_free(
        [(out[p], [m[p] for m in map_refs]) for p in range(num_parts)]
    )
    return out


def _shuffle_blocks_streaming(
    blocks, num_parts, mode, key_fn, bounds, seed, reduce_fn, reduce_args
) -> List[Any]:
    gens = [
        _partition_block_stream.options(num_returns="streaming").remote(
            block,
            num_parts,
            mode,
            key_fn,
            bounds,
            None if seed is None else seed + i,
        )
        for i, block in enumerate(blocks)
    ]
    iters = [iter(g) for g in gens]
    last: List[Any] = [None] * len(iters)

    def next_part(i: int):
        try:
            last[i] = next(iters[i])
        except StopIteration:
            # the stream ended early: its final item is the map task's
            # sealed error — hand that ref to the reduce so the failure
            # surfaces as a TaskError on get(), like the N-return form
            if last[i] is None:
                raise RuntimeError(
                    f"shuffle map {i} produced no partitions"
                ) from None
        return last[i]

    out = []
    pairs = []
    for _p in range(num_parts):
        # generators yield in partition order: one lockstep row across
        # all maps unlocks reduce _p
        parts_p = [next_part(i) for i in range(len(iters))]
        out.append(reduce_fn.remote(*reduce_args, *parts_p))
        pairs.append((out[-1], list(parts_p)))
    _watch_eager_free(pairs)
    return out


def sample_bounds(
    blocks: List[List[Any]],
    num_parts: int,
    key_fn: Optional[Callable],
    samples_per_block: int = 64,
) -> List[Any]:
    """Range-partition boundaries from per-block samples (the reference's
    sort sampling stage, planner/exchange/sort_task_spec.py)."""

    @ray_tpu_torch.remote
    def sample(block):
        from ray_tpu_torch.data.block import block_rows

        keys = [key_fn(r) if key_fn else r for r in block_rows(block)]
        if len(keys) <= samples_per_block:
            return keys
        idx = np.random.default_rng(0).choice(
            len(keys), samples_per_block, replace=False
        )
        return [keys[i] for i in idx]

    all_keys = sorted(
        k
        for block_keys in ray_tpu_torch.get([sample.remote(b) for b in blocks])
        for k in block_keys
    )
    if not all_keys:
        return []
    step = max(1, len(all_keys) // num_parts)
    return [all_keys[i] for i in range(step, len(all_keys), step)][: num_parts - 1]
