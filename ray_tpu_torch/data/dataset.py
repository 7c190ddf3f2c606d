"""Lazy Dataset + streaming block executor.

Port of ``ray_tpu/data/dataset.py``. Batches stay numpy (dicts of
arrays), as in the reference; a consumer moves them to the card.
"""
from __future__ import annotations

import builtins
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

import ray_tpu_torch


# -- block-level task (executed remotely) -----------------------------------


def _apply_batches(fn: Callable, block: Any, kwargs: dict):
    """One map_batches op over one block: slice into batches (zero-copy
    for Arrow blocks), convert to the requested batch_format, apply,
    convert back to a block (Arrow preferred for tabular results)."""
    from . import block as blk

    n = blk.block_len(block)
    size = kwargs.get("batch_size") or n or 1
    fmt = kwargs.get("batch_format") or "numpy"
    if blk.is_arrow(block):
        results = []
        for i in range(0, n, size):
            piece = blk.slice_block(block, i, min(size, n - i))
            results.append(
                blk.batch_to_block(fn(blk.arrow_to_batch(piece, fmt)))
            )
        if not results:
            return block
        if all(blk.is_arrow(r) for r in results):
            return blk.concat_blocks(results)
        out: List[Any] = []
        for r in results:
            out.extend(blk.block_rows(r))
        return out
    out = []
    for i in range(0, n, size):
        rows = block[i : i + size]
        scalar_rows = not (rows and isinstance(rows[0], dict))
        result = fn(_rows_to_batch(rows, fmt))
        out.extend(_batch_to_rows(result, unwrap_scalar=scalar_rows))
    return out


def _apply_chain_local(block: Any, ops: List[tuple]) -> Any:
    from . import block as blk

    for kind, fn, kwargs in ops:
        if kind != "map_batches" and blk.is_arrow(block):
            # row-wise ops see rows (block-accessor row view): one
            # materialization at the op boundary
            block = blk.block_rows(block)
        if kind == "map":
            block = [fn(row) for row in block]
        elif kind == "filter":
            block = [row for row in block if fn(row)]
        elif kind == "flat_map":
            block = [out for row in block for out in fn(row)]
        elif kind == "map_batches":
            block = _apply_batches(fn, block, kwargs)
    return block


_apply_chain = ray_tpu_torch.remote(_apply_chain_local)

_BATCH_FORMATS = ("numpy", "default", "pandas", "pyarrow")


def _rows_to_batch(rows: List[Any], batch_format: str = "numpy"):
    """Batch conversion. "numpy"/"default": dict of numpy arrays (the
    reference's default); "pandas": a DataFrame; "pyarrow": a Table."""
    if batch_format == "pyarrow":
        from . import block as blk

        return blk.rows_to_arrow(rows)
    if batch_format == "pandas":
        import pandas as pd

        if rows and isinstance(rows[0], dict):
            return pd.DataFrame(rows)
        return pd.DataFrame({"data": list(rows)})
    if rows and isinstance(rows[0], dict):
        keys = rows[0].keys()
        return {k: np.asarray([r[k] for r in rows]) for k in keys}
    return {"data": np.asarray(rows)}


def _batch_to_rows(batch: Any, unwrap_scalar: bool = False) -> List[Any]:
    """``unwrap_scalar`` is set ONLY when the batch was built by wrapping
    NON-dict rows into a synthetic "data" column (_rows_to_batch): a real
    dataset whose rows are {"data": ...} dicts must keep its shape
    (matching block.py's metadata-marker discipline for Arrow blocks)."""
    from . import block as blk

    if blk.is_arrow(batch):
        return blk.block_rows(batch)
    if type(batch).__name__ == "DataFrame":  # pandas without the import
        return batch.to_dict("records")
    if isinstance(batch, dict):
        keys = list(batch.keys())
        n = len(batch[keys[0]])
        rows = [{k: batch[k][i] for k in keys} for i in range(n)]
        if unwrap_scalar and keys == ["data"]:
            return [r["data"] for r in rows]
        return rows
    return list(batch)


# -- dataset ----------------------------------------------------------------


class Dataset:
    """Lazy, immutable; transformations return new Datasets."""

    def __init__(self, input_blocks: List[Any], ops: List[tuple]):
        self._input_blocks = input_blocks  # host lists (lazy materialization)
        self._ops = ops

    # transformations (lazy)
    def map(self, fn: Callable) -> "Dataset":
        return Dataset(self._input_blocks, self._ops + [("map", fn, {})])

    def filter(self, fn: Callable) -> "Dataset":
        return Dataset(self._input_blocks, self._ops + [("filter", fn, {})])

    def flat_map(self, fn: Callable) -> "Dataset":
        return Dataset(self._input_blocks, self._ops + [("flat_map", fn, {})])

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        compute: Optional[Any] = None,
        concurrency: Optional[Any] = None,
        batch_format: str = "numpy",
        fn_constructor_args: Optional[tuple] = None,
        fn_constructor_kwargs: Optional[dict] = None,
        num_cpus: Optional[float] = None,
        **unknown,
    ) -> "Dataset":
        """Batch transform. Stateless callables run as fused block tasks;
        ``compute=ActorPoolStrategy(...)`` (or a tuple ``concurrency``,
        or a callable-class ``fn``) runs on an autoscaling actor pool with
        locality-ranked dispatch (execution.py). Unsupported arguments
        raise instead of being silently dropped."""
        if unknown:
            raise TypeError(
                f"map_batches got unsupported argument(s) "
                f"{sorted(unknown)}; supported: batch_size, compute, "
                "concurrency, batch_format, fn_constructor_args, "
                "fn_constructor_kwargs, num_cpus"
            )
        if batch_format not in _BATCH_FORMATS:
            raise ValueError(
                f"batch_format={batch_format!r} not supported "
                f"(one of {_BATCH_FORMATS})"
            )
        from .execution import ActorPoolStrategy

        pool: Optional[ActorPoolStrategy] = None
        task_cap: Optional[int] = None
        if isinstance(compute, ActorPoolStrategy):
            pool = compute
        elif compute is not None:
            raise TypeError(
                "compute must be an ActorPoolStrategy (or use "
                "concurrency=(min, max) for an autoscaling pool)"
            )
        if pool is not None and concurrency is not None:
            raise ValueError(
                "pass either compute=ActorPoolStrategy(...) or "
                "concurrency=, not both"
            )
        if isinstance(concurrency, tuple):
            pool = ActorPoolStrategy(*concurrency)
        elif isinstance(concurrency, int):
            if isinstance(fn, type):
                pool = ActorPoolStrategy(concurrency, concurrency)
            else:
                task_cap = concurrency
        if isinstance(fn, type) and pool is None:
            raise ValueError(
                "a callable-class UDF is stateful and must run on an "
                "actor pool: pass concurrency=n / (min, max) or "
                "compute=ActorPoolStrategy(...)"
            )
        op_kwargs = {"batch_size": batch_size, "batch_format": batch_format}
        if pool is not None:
            op = (
                "map_batches_actors",
                fn,
                {
                    **op_kwargs,
                    "pool": pool,
                    "num_cpus": num_cpus,
                    "fn_constructor_args": tuple(fn_constructor_args or ()),
                    "fn_constructor_kwargs": dict(fn_constructor_kwargs or {}),
                },
            )
        else:
            if fn_constructor_args or fn_constructor_kwargs:
                raise ValueError(
                    "fn_constructor_args/kwargs require an actor pool "
                    "(callable-class fn with concurrency/compute)"
                )
            op = (
                "map_batches",
                fn,
                {**op_kwargs, "num_cpus": num_cpus, "task_cap": task_cap},
            )
        return Dataset(self._input_blocks, self._ops + [op])

    def repartition(
        self,
        num_blocks: Optional[int] = None,
        *,
        target_block_bytes: Optional[int] = None,
    ) -> "Dataset":
        """Rebalance blocks. ``num_blocks``: all-to-all via the
        distributed shuffle (round-robin random partition; reference
        repartition exchange ops). ``target_block_bytes``: block-SIZE-
        aware local coalesce/split — adjacent blocks merge until the
        byte target (Arrow ``nbytes``; pickled estimate for row lists)
        and oversized blocks split, preserving row order (the
        reference's target-size block splitting)."""
        if (num_blocks is None) == (target_block_bytes is None):
            raise ValueError(
                "pass exactly one of num_blocks / target_block_bytes"
            )
        if num_blocks is not None:
            from .shuffle import shuffle_blocks

            refs = shuffle_blocks(
                self._executed_blocks(), num_blocks, mode="random", seed=0
            )
            return Dataset(refs, [])
        from . import block as blk

        out: List[Any] = []
        acc: List[Any] = []
        acc_bytes = 0
        for b in self.iter_blocks():
            n = blk.block_len(b)
            if n == 0:
                continue
            nbytes = blk.block_nbytes(b)
            if nbytes > target_block_bytes and n > 1:
                if acc:
                    out.append(blk.concat_blocks(acc))
                    acc, acc_bytes = [], 0
                per_row = max(1, nbytes // n)
                rows_per = max(1, int(target_block_bytes // per_row))
                for i in range(0, n, rows_per):
                    out.append(blk.slice_block(b, i, min(rows_per, n - i)))
                continue
            acc.append(b)
            acc_bytes += nbytes
            if acc_bytes >= target_block_bytes:
                out.append(blk.concat_blocks(acc))
                acc, acc_bytes = [], 0
        if acc:
            out.append(blk.concat_blocks(acc))
        return Dataset(out, [])

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        """Distributed two-stage random shuffle (hash-shuffle op analog):
        map tasks scatter rows to random partitions, reduce tasks gather —
        rows never funnel through the driver."""
        from .shuffle import shuffle_blocks

        num = max(1, len(self._input_blocks))
        # unseeded shuffles must differ call-to-call (epoch reshuffling)
        eff_seed = (
            seed
            if seed is not None
            else int(np.random.default_rng().integers(1 << 31))
        )
        from .shuffle import _reduce_shuffled

        refs = shuffle_blocks(
            self._executed_blocks(),
            num,
            mode="random",
            seed=eff_seed,
            reduce_fn=_reduce_shuffled,
            reduce_args=(eff_seed,),
        )
        return Dataset(refs, [])

    def sort(
        self,
        key: Optional[Any] = None,
        descending: bool = False,
    ) -> "Dataset":
        """Distributed sample sort: sample range bounds, range-partition,
        per-partition sorted reduce (sort_task_spec.py analog)."""
        from .shuffle import _reduce_sorted, sample_bounds, shuffle_blocks

        key_fn = _key_fn(key)
        blocks = self._executed_blocks()
        num = max(1, len(blocks))
        bounds = sample_bounds(blocks, num, key_fn)
        refs = shuffle_blocks(
            blocks,
            len(bounds) + 1,
            mode="range",
            key_fn=key_fn,
            bounds=bounds,
            reduce_fn=_reduce_sorted,
            reduce_args=(key_fn, descending),
            # sort's sampling stage already blocked the driver; the
            # streaming map emits each range partition as its own sealed
            # object (num_returns="streaming" block emission)
            streaming=True,
        )
        if descending:
            refs = refs[::-1]
        return Dataset(refs, [])

    def groupby(self, key: Any) -> "GroupedData":
        return GroupedData(self, key)

    def join(
        self,
        other: "Dataset",
        on: str,
        how: str = "inner",
        num_partitions: Optional[int] = None,
    ) -> "Dataset":
        """Distributed hash join (hash_shuffle join op analog): both sides
        hash-partition on the key; one join task per partition."""
        from .shuffle import shuffle_blocks

        key_fn = _key_fn(on)
        num = num_partitions or max(
            1, len(self._input_blocks), len(other._input_blocks)
        )
        left = shuffle_blocks(
            self._executed_blocks(), num, mode="hash", key_fn=key_fn
        )
        right = shuffle_blocks(
            other._executed_blocks(), num, mode="hash", key_fn=key_fn
        )
        refs = [
            _join_partition.remote(on, how, lp, rp)
            for lp, rp in zip(left, right)
        ]
        return Dataset(refs, [])

    def zip(self, other: "Dataset") -> "Dataset":
        rows_a, rows_b = self._materialize_rows(), other._materialize_rows()
        if len(rows_a) != len(rows_b):
            raise ValueError("zip requires datasets of equal row count")
        out = []
        for a, b in builtins.zip(rows_a, rows_b):
            row = dict(a) if isinstance(a, dict) else {"data": a}
            if isinstance(b, dict):
                for k, v in b.items():
                    row[k if k not in row else f"{k}_1"] = v
            else:
                row["data_1"] = b
            out.append(row)
        return from_items(out, override_num_blocks=len(self._input_blocks))

    def limit(self, n: int) -> "Dataset":
        return from_items(self.take(n), override_num_blocks=1)

    def unique(self, key: Optional[Any] = None) -> List[Any]:
        key_fn = _key_fn(key)
        seen, out = set(), []
        for row in self.iter_rows():
            k = key_fn(row) if key_fn else row
            marker = repr(k)
            if marker not in seen:
                seen.add(marker)
                out.append(k)
        return out

    # column ops (dict rows)
    def add_column(self, name: str, fn: Callable) -> "Dataset":
        return self.map(lambda row, _n=name, _f=fn: {**row, _n: _f(row)})

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self.map(
            lambda row, _c=tuple(cols): {
                k: v for k, v in row.items() if k not in _c
            }
        )

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self.map(
            lambda row, _c=tuple(cols): {k: row[k] for k in _c}
        )

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self.map(
            lambda row, _m=dict(mapping): {_m.get(k, k): v for k, v in row.items()}
        )

    # global aggregates (distributed partials, combined on the driver)
    def sum(self, on: Optional[str] = None):
        parts = self._block_aggregate("sum", on)
        return builtins.sum(p for p in parts if p is not None)

    def min(self, on: Optional[str] = None):
        parts = [p for p in self._block_aggregate("min", on) if p is not None]
        return builtins.min(parts) if parts else None

    def max(self, on: Optional[str] = None):
        parts = [p for p in self._block_aggregate("max", on) if p is not None]
        return builtins.max(parts) if parts else None

    def mean(self, on: Optional[str] = None):
        parts = [p for p in self._block_aggregate("moments", on) if p[0]]
        n = builtins.sum(p[0] for p in parts)
        return builtins.sum(p[1] for p in parts) / n if n else None

    def std(self, on: Optional[str] = None, ddof: int = 1):
        parts = [p for p in self._block_aggregate("moments", on) if p[0]]
        n = builtins.sum(p[0] for p in parts)
        if n <= ddof:
            return None
        total = builtins.sum(p[1] for p in parts)
        sq = builtins.sum(p[2] for p in parts)
        var = (sq - total * total / n) / (n - ddof)
        return float(np.sqrt(builtins.max(var, 0.0)))

    def _block_aggregate(self, agg: str, on: Optional[str]) -> List[Any]:
        if self._has_actor_stage():
            # actor stages can't fuse into the aggregate task: run the
            # pipeline to refs, then aggregate per block
            refs = [
                _block_agg.remote(b, [], agg, on)
                for b in self._executed_blocks()
            ]
        else:
            refs = [
                _block_agg.remote(b, self._ops, agg, on)
                for b in self._input_blocks
            ]
        return ray_tpu_torch.get(refs)

    def _has_actor_stage(self) -> bool:
        return any(op[0] == "map_batches_actors" for op in self._ops)

    def _build_stages(self) -> List[Any]:
        """Compile the op list into executor stages: consecutive task ops
        fuse into one TaskStage; each actor map_batches is its own
        ActorStage (execution.py topology)."""
        from .execution import ActorStage, TaskStage

        stages: List[Any] = []
        cur: List[tuple] = []
        cur_cpus: Optional[float] = None
        cur_cap: Optional[int] = None

        def flush():
            nonlocal cur, cur_cpus, cur_cap
            if cur:
                stages.append(
                    TaskStage(cur, num_cpus=cur_cpus, max_concurrency=cur_cap)
                )
                cur, cur_cpus, cur_cap = [], None, None

        for kind, fn, kwargs in self._ops:
            if kind == "map_batches_actors":
                flush()
                stages.append(
                    ActorStage(
                        fn=fn,
                        kwargs={
                            "batch_size": kwargs.get("batch_size"),
                            "batch_format": kwargs.get("batch_format"),
                        },
                        pool=kwargs["pool"],
                        num_cpus=kwargs.get("num_cpus"),
                        fn_constructor_args=kwargs.get(
                            "fn_constructor_args", ()
                        ),
                        fn_constructor_kwargs=kwargs.get(
                            "fn_constructor_kwargs", {}
                        ),
                    )
                )
            else:
                cur.append((kind, fn, kwargs))
                if kwargs.get("num_cpus") is not None:
                    cur_cpus = max(cur_cpus or 0.0, kwargs["num_cpus"])
                if kwargs.get("task_cap") is not None:
                    cur_cap = (
                        kwargs["task_cap"]
                        if cur_cap is None
                        else min(cur_cap, kwargs["task_cap"])
                    )
        flush()
        return stages

    def _executed_blocks(self) -> List[Any]:
        """Apply pending ops, returning blocks as ObjectRefs — blocks stay
        in the object store end-to-end (streaming_executor.py:77
        semantics); nothing funnels through the driver. Host-list input
        blocks with no pending ops pass through as-is (they are already
        driver-resident; shipping them is the consumer's decision)."""
        if not self._ops:
            return list(self._input_blocks)
        from .execution import StreamingExecutor

        return StreamingExecutor(
            self._input_blocks, self._build_stages()
        ).run_refs()

    def union(self, other: "Dataset") -> "Dataset":
        """Concatenate block lists — no row materialization; each side's
        pending ops are submitted as block tasks and the refs carried
        over."""
        return Dataset(
            list(self._executed_blocks()) + list(other._executed_blocks()),
            [],
        )

    def split(self, n: int) -> List["Dataset"]:
        """Block-granularity split (the reference's equal=False default,
        dataset.py split): blocks stay refs. When there are fewer blocks
        than splits, fall back to row-level rebalancing."""
        if len(self._input_blocks) >= n:
            blocks = self._executed_blocks()
            return [
                Dataset([blocks[i] for i in idx], [])
                for idx in np.array_split(np.arange(len(blocks)), n)
            ]
        rows = self._materialize_rows()
        splits = np.array_split(np.arange(len(rows)), n)
        return [
            from_items([rows[i] for i in idx], override_num_blocks=1)
            for idx in splits
        ]

    # execution (streaming)
    def iter_blocks(self, *, prefetch_blocks: int = 0) -> Iterator[List[Any]]:
        """Streaming executor: the op plan compiles to a stage topology
        (task fusion + actor-pool stages) executed as a pipeline with a
        byte-budget admission window per stage (execution.py). Blocks may
        be host lists or ObjectRefs (shuffle outputs stay in the object
        store until consumed — the driver only materializes a block at
        its own consumption point, here).

        ``prefetch_blocks``: pull up to this many upcoming blocks over
        the object plane concurrently with the consumer (depth-N
        prefetch) — a reduce output that seals while the consumer is
        busy is already local by the time the iterator reaches it, so a
        training step overlaps shuffle tail latency instead of stalling
        per block."""
        if not self._ops:
            yield from _prefetched_blocks(
                iter(self._input_blocks), prefetch_blocks
            )
            return
        from .execution import StreamingExecutor

        yield from _prefetched_blocks(
            StreamingExecutor(self._input_blocks, self._build_stages()).run(),
            prefetch_blocks,
        )

    def iter_rows(self) -> Iterator[Any]:
        from . import block as blk

        for block in self.iter_blocks():
            yield from blk.rows_iter(block)

    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        batch_format: str = "numpy",
        prefetch_batches: int = 0,
    ) -> Iterator[Any]:
        """Arrow blocks batch as zero-copy slices (a block boundary may
        yield a short batch); ndarray blocks slice their buffer
        (zero-copy views); row-list blocks buffer across blocks.

        ``prefetch_batches``: streaming-ingest depth, in BLOCKS — up to
        this many upcoming blocks are pulled over the object plane while
        the consumer processes the current one, overlapping fetch (and
        the shuffle's reduce tail) with the train step. 0 (default) =
        fully synchronous pulls; training dataset shards default to
        cfg.data_prefetch_batches (train/session.py DataIterator)."""
        from . import block as blk

        buf: List[Any] = []
        for block in self.iter_blocks(
            prefetch_blocks=max(0, int(prefetch_batches))
        ):
            if blk.is_arrow(block):
                if buf:
                    yield _rows_to_batch(buf, batch_format)
                    buf = []
                n = block.num_rows
                for i in range(0, n, batch_size):
                    piece = blk.slice_block(
                        block, i, min(batch_size, n - i)
                    )
                    yield blk.arrow_to_batch(piece, batch_format)
                continue
            if blk.is_ndarray(block):
                if buf:
                    yield _rows_to_batch(buf, batch_format)
                    buf = []
                for i in range(0, len(block), batch_size):
                    yield _ndarray_to_batch(
                        block[i : i + batch_size], batch_format
                    )
                continue
            for row in block:
                buf.append(row)
                if len(buf) >= batch_size:
                    yield _rows_to_batch(buf, batch_format)
                    buf = []
        if buf:
            yield _rows_to_batch(buf, batch_format)

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(len(b) for b in self.iter_blocks())

    def materialize(self) -> "Dataset":
        """Execute pending ops; blocks land in the object store as refs
        (MaterializedDataset semantics — NOT a driver copy)."""
        return Dataset(self._executed_blocks(), [])

    def num_blocks(self) -> int:
        return len(self._input_blocks)

    def _materialize_rows(self) -> List[Any]:
        return self.take_all()

    def __repr__(self) -> str:
        return (
            f"Dataset(num_blocks={len(self._input_blocks)}, "
            f"num_ops={len(self._ops)})"
        )


def _resolve_block(b: Any) -> Any:
    return ray_tpu_torch.get(b) if isinstance(b, ray_tpu_torch.ObjectRef) else b


def _prefetched_blocks(block_iter: Iterator[Any], depth: int) -> Iterator[Any]:
    """Depth-N streaming consumption: keep up to ``depth`` upcoming
    blocks' object-plane pulls in flight while the consumer holds the
    current one. Results yield in ITERATOR order (a Dataset's block
    order is its row order); the pulls themselves overlap both each
    other and the consumer's step."""
    if depth <= 0:
        for b in block_iter:
            yield _resolve_block(b)
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(
        max_workers=min(depth, 8), thread_name_prefix="data-prefetch"
    )
    try:
        window: Any = deque()
        for b in block_iter:
            window.append(pool.submit(_resolve_block, b))
            if len(window) > depth:
                yield window.popleft().result()
        while window:
            yield window.popleft().result()
    finally:
        # an abandoned iterator (consumer breaks out of its loop) must
        # not block on up-to-`depth` in-flight fetches nobody will read:
        # cancel queued pulls and return without joining — any running
        # pull drains in its pool thread
        pool.shutdown(wait=False, cancel_futures=True)


def _ndarray_to_batch(piece: np.ndarray, batch_format: str):
    """An ndarray block slice as a batch — the same shapes
    _rows_to_batch builds from scalar rows, without materializing rows
    ("numpy": a zero-copy {"data": view})."""
    if batch_format == "pyarrow":
        import pyarrow as pa

        from . import block as blk

        # pa.array only accepts 1-D input; multi-dim rows become list
        # rows (the same shape rows_to_arrow produced for them)
        arr = pa.array(piece if piece.ndim == 1 else list(piece))
        return blk.synthetic_table(arr, "data")
    if batch_format == "pandas":
        import pandas as pd

        return pd.DataFrame({"data": list(piece)})
    return {"data": piece}


def _key_fn(key: Any) -> Optional[Callable]:
    """None | column-name | callable -> row-key extractor."""
    if key is None or callable(key):
        return key
    return lambda row, _k=key: row[_k]


def _scalar(row: Any, on: Optional[str]) -> Any:
    return row[on] if on is not None else row


@ray_tpu_torch.remote
def _block_agg(block: List[Any], ops: List[tuple], agg: str, on: Optional[str]):
    from . import block as blk

    block = blk.block_rows(_apply_chain_local(block, ops))
    values = [_scalar(r, on) for r in block]
    if agg == "sum":
        return builtins.sum(values) if values else None
    if agg == "min":
        return builtins.min(values) if values else None
    if agg == "max":
        return builtins.max(values) if values else None
    if agg == "moments":  # (count, sum, sum of squares)
        arr = np.asarray(values, dtype=np.float64)
        return (arr.size, float(arr.sum()), float((arr * arr).sum()))
    raise ValueError(agg)


@ray_tpu_torch.remote
def _join_partition(on: str, how: str, left: List[Any], right: List[Any]):
    index: Dict[Any, List[dict]] = {}
    for row in right:
        index.setdefault(row[on], []).append(row)
    out: List[dict] = []
    matched_right = set()
    for row in left:
        matches = index.get(row[on], [])
        if matches:
            for m in matches:
                merged = dict(row)
                for k, v in m.items():
                    if k != on:
                        merged[k if k not in merged else f"{k}_right"] = v
                out.append(merged)
            matched_right.add(row[on])
        elif how in ("left", "outer"):
            out.append(dict(row))
    if how in ("right", "outer"):
        for key, rows in index.items():
            if key not in matched_right:
                out.extend(dict(r) for r in rows)
    return out


@ray_tpu_torch.remote
def _group_partition(
    key_is_col: bool,
    key: Any,
    agg: str,
    on: Optional[str],
    fn: Optional[Callable],
    part: List[Any],
):
    key_fn = _key_fn(key)
    groups: Dict[Any, List[Any]] = {}
    for row in part:
        groups.setdefault(key_fn(row) if key_fn else row, []).append(row)
    out = []
    for gkey, rows in groups.items():
        if agg == "map_groups":
            out.extend(fn(rows))
            continue
        values = [_scalar(r, on) for r in rows]
        if agg == "count":
            stat = len(rows)
        elif agg == "sum":
            stat = builtins.sum(values)
        elif agg == "min":
            stat = builtins.min(values)
        elif agg == "max":
            stat = builtins.max(values)
        elif agg == "mean":
            stat = float(np.mean(np.asarray(values, dtype=np.float64)))
        else:
            raise ValueError(agg)
        name = f"{agg}({on})" if on else agg
        if key_is_col:
            out.append({key: gkey, name: stat})
        else:
            out.append({"key": gkey, name: stat})
    return out


class GroupedData:
    """Hash-partition by key, then per-partition group/aggregate
    (reference: Dataset.groupby -> hash aggregate ops)."""

    def __init__(self, ds: Dataset, key: Any):
        self._ds = ds
        self._key = key

    def _run(self, agg: str, on: Optional[str] = None, fn=None) -> Dataset:
        from .shuffle import shuffle_blocks

        blocks = self._ds._executed_blocks()
        num = max(1, len(blocks))
        parts = shuffle_blocks(
            blocks, num, mode="hash", key_fn=_key_fn(self._key)
        )
        refs = [
            _group_partition.remote(
                isinstance(self._key, str), self._key, agg, on, fn, p
            )
            for p in parts
        ]
        return Dataset(refs, [])

    def count(self) -> Dataset:
        return self._run("count")

    def sum(self, on: Optional[str] = None) -> Dataset:
        return self._run("sum", on)

    def min(self, on: Optional[str] = None) -> Dataset:
        return self._run("min", on)

    def max(self, on: Optional[str] = None) -> Dataset:
        return self._run("max", on)

    def mean(self, on: Optional[str] = None) -> Dataset:
        return self._run("mean", on)

    def map_groups(self, fn: Callable) -> Dataset:
        return self._run("map_groups", fn=fn)


def from_items(
    items: Sequence[Any], *, override_num_blocks: Optional[int] = None
) -> Dataset:
    items = list(items)
    n_blocks = override_num_blocks or min(
        max(1, len(items) // 1000 or 1), 200
    )
    idx = np.array_split(np.arange(len(items)), n_blocks)
    blocks = [[items[i] for i in part] for part in idx]
    return Dataset(blocks, [])


def range_(n: int, *, override_num_blocks: Optional[int] = None) -> Dataset:
    return from_items(
        builtins.range(n), override_num_blocks=override_num_blocks
    )


def from_numpy(arr: np.ndarray, **kwargs) -> Dataset:
    return from_items(list(arr), **kwargs)


def from_numpy_blocks(
    arr: np.ndarray, *, override_num_blocks: Optional[int] = None
) -> Dataset:
    """Dataset over raw ndarray blocks (rows along axis 0) — the
    zero-copy shuffle path: blocks, map partitions, and reduce outputs
    stay buffer-backed arrays end-to-end, so their pickle-5 frames
    scatter-write straight into the shm arena at every seal and
    iter_batches serves zero-copy {"data": view} batches. Use
    ``io.from_numpy`` for the Arrow-table (named-column) form."""
    n_blocks = override_num_blocks or min(
        max(1, len(arr) // 65536 or 1), 200
    )
    return Dataset(
        [b for b in np.array_split(arr, n_blocks) if len(b)], []
    )
