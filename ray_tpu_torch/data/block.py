"""Block representations: Python row-lists, ndarrays and Arrow tables.

Port of ``ray_tpu/data/block.py``; pyarrow is imported lazily at the same
places, so row-list and ndarray blocks never need it. No block holds a
torch tensor: whoever consumes a batch moves it to the card.

Capability analog of Ray's Arrow block format
(python/ray/data/_internal/arrow_block.py): a Dataset
block is either a plain Python list of rows (``from_items``/``range``
data) or a ``pyarrow.Table`` (everything tabular: the file readers,
``from_numpy``/``from_pandas``). Table blocks give the batch paths
zero-copy views — ``batch_format="pyarrow"`` slices the table,
``batch_format="numpy"`` wraps column buffers without copying where
Arrow allows (numeric, no nulls) — while row-oriented ops
(map/filter/iter_rows, hash partitioning) materialize rows once at the
op boundary, mirroring the reference's block-accessor row views.
"""
from __future__ import annotations

from typing import Any, Iterator, List


def is_arrow(block: Any) -> bool:
    # cheap structural check: avoid importing pyarrow for list blocks
    return type(block).__module__.startswith("pyarrow")


def block_len(block: Any) -> int:
    return block.num_rows if is_arrow(block) else len(block)


_SYNTH_KEY = b"ray_tpu_synthetic_column"


def _is_synthetic(table: Any) -> bool:
    """True only for tables WE built around scalar rows (schema-metadata
    marker) — matching on a user-visible column name would corrupt real
    datasets whose only column happens to be called "data"."""
    meta = table.schema.metadata
    return bool(meta) and _SYNTH_KEY in meta


def block_rows(block: Any) -> List[Any]:
    """Row-list view (materializes a Table; unwraps the marker-tagged
    synthetic scalar column so scalar datasets round-trip)."""
    if not is_arrow(block):
        return block
    if _is_synthetic(block):
        name = block.schema.metadata[_SYNTH_KEY].decode()
        return block.column(name).to_pylist()
    return block.to_pylist()


def rows_iter(block: Any) -> Iterator[Any]:
    if is_arrow(block):
        yield from block_rows(block)
    else:
        yield from block


def is_ndarray(block: Any) -> bool:
    """ndarray blocks: rows along axis 0 (shuffle map/reduce outputs of
    numeric datasets, ``from_numpy``). They ride the object plane as
    buffer-backed pickle-5 frames — arena scatter writes on seal,
    zero-copy views on same-node reads."""
    import numpy as np

    return isinstance(block, np.ndarray)


def block_nbytes(block: Any) -> int:
    """Byte size for block-size-aware repartitioning."""
    if is_arrow(block):
        return int(block.nbytes)
    if is_ndarray(block):
        return int(block.nbytes)
    import cloudpickle

    try:
        return len(cloudpickle.dumps(block))
    except Exception:  # noqa: BLE001
        return 64 << 10


def arrow_to_batch(table: Any, batch_format: str):
    """A batch view of a Table slice. "pyarrow": the slice itself
    (zero-copy). "numpy"/"default": dict of numpy arrays over the column
    buffers — zero-copy where Arrow permits. "pandas": DataFrame."""
    if batch_format == "pyarrow":
        return table
    if batch_format == "pandas":
        return table.to_pandas()
    out = {}
    for name in table.column_names:
        col = table.column(name)
        try:
            if col.num_chunks == 1:
                # single chunk: a true buffer view (combine_chunks would
                # consolidate into a fresh allocation even for one chunk)
                out[name] = col.chunk(0).to_numpy(zero_copy_only=True)
            else:
                out[name] = col.combine_chunks().to_numpy(
                    zero_copy_only=True
                )
        except Exception:  # noqa: BLE001 - nulls/strings: copy is required
            out[name] = col.to_numpy(zero_copy_only=False)
    return out


def batch_to_block(result: Any):
    """A map_batches result back to a block, preferring Arrow for
    tabular shapes (Table stays Table; DataFrame and dict-of-arrays
    become Tables) so downstream batch stages keep zero-copy views."""
    if is_arrow(result):
        return result
    import pyarrow as pa

    if type(result).__name__ == "DataFrame":
        # preserve_index=False: a filtered frame's non-trivial index must
        # not become a spurious __index_level_0__ column
        return pa.Table.from_pandas(result, preserve_index=False)
    if isinstance(result, dict):
        return pa.table(result)
    return list(result)  # row list


def rows_to_arrow(rows: List[Any]):
    import pyarrow as pa

    if rows and isinstance(rows[0], dict):
        return pa.Table.from_pylist(rows)
    return synthetic_table(pa.array(list(rows)), "data")


def synthetic_table(arr: Any, column: str):
    """A single-column table tagged as wrapping scalar rows (see
    _is_synthetic)."""
    import pyarrow as pa

    return pa.table({column: arr}).replace_schema_metadata(
        {_SYNTH_KEY: column.encode()}
    )


def block_to_table(block: Any):
    """A writable Table from any block (shared by the parquet/csv
    writers): Arrow blocks pass through; scalar rows wrap in a "data"
    column like the reference's tensor/scalar handling."""
    if is_arrow(block):
        return block
    import pyarrow as pa

    rows = [r if isinstance(r, dict) else {"data": r} for r in block]
    return pa.Table.from_pylist(rows)


def concat_blocks(blocks: List[Any]):
    """One block from many (repartition coalescing): all-Arrow inputs
    concat zero-copy; all-ndarray inputs concat into one buffer;
    otherwise rows."""
    if blocks and all(is_arrow(b) for b in blocks):
        import pyarrow as pa

        return pa.concat_tables(blocks)
    if blocks and all(is_ndarray(b) for b in blocks):
        import numpy as np

        try:
            return np.concatenate(blocks)
        except ValueError:  # mismatched shapes/dtypes: fall through
            pass
    out: List[Any] = []
    for b in blocks:
        out.extend(block_rows(b))
    return out


def slice_block(block: Any, start: int, length: int):
    if is_arrow(block):
        return block.slice(start, length)  # zero-copy
    return block[start:start + length]
