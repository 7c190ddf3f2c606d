"""Dataset IO: parquet / CSV / JSON / numpy / pandas interchange.

Port of ``ray_tpu/data/io.py``; pyarrow and pandas stay lazy imports
inside each function. The slim analog of Ray's datasource layer
(python/ray/data/read_api.py + _internal/datasource/):
file discovery on the driver, one read task per file (parallel via the
task layer). Readers produce **Arrow-table blocks** (block.py — the
reference's arrow_block.py format) so downstream ``map_batches`` /
``iter_batches`` get zero-copy views; row-oriented consumers see rows
through the block accessors.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

import ray_tpu_torch

from .dataset import Dataset, from_items


def _discover(paths, suffixes: tuple) -> List[str]:
    """Regular files with a matching extension only — foreign entries
    (_SUCCESS markers, subdirs, mixed formats) must not fail the read."""
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(
                fp
                for f in sorted(os.listdir(p))
                if not f.startswith(".")
                and f.lower().endswith(suffixes)
                and os.path.isfile(fp := os.path.join(p, f))
            )
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no {suffixes} files under {paths}")
    return files


@ray_tpu_torch.remote
def _read_parquet_file(path: str, columns):
    import pyarrow.parquet as pq

    return pq.read_table(path, columns=columns)  # Arrow block


@ray_tpu_torch.remote
def _read_csv_file(path: str):
    import pyarrow.csv as pacsv

    return pacsv.read_csv(path)  # Arrow block


@ray_tpu_torch.remote
def _read_json_file(path: str):
    """JSON-lines or a top-level JSON array of objects → Arrow block."""
    import json

    import pyarrow as pa

    with open(path, "r") as f:
        text = f.read()
    if text.lstrip().startswith("["):
        rows = json.loads(text)
    else:
        rows = [
            json.loads(line) for line in text.splitlines() if line.strip()
        ]
    return pa.Table.from_pylist(rows)


def read_parquet(paths, *, columns: Optional[List[str]] = None) -> Dataset:
    refs = [
        _read_parquet_file.remote(p, columns)
        for p in _discover(paths, (".parquet", ".pq"))
    ]
    return Dataset(refs, [])


def read_csv(paths) -> Dataset:
    refs = [_read_csv_file.remote(p) for p in _discover(paths, (".csv",))]
    return Dataset(refs, [])


def read_json(paths) -> Dataset:
    """read_json parity (reference read_api.py read_json): .json /
    .jsonl files, JSON-lines or array-of-objects."""
    refs = [
        _read_json_file.remote(p)
        for p in _discover(paths, (".json", ".jsonl"))
    ]
    return Dataset(refs, [])


def from_numpy(arr, *, column: str = "data", num_blocks: int = 1) -> Dataset:
    """Dataset over a numpy array (reference from_numpy): Arrow-table
    blocks whose column references the array's buffer zero-copy. 1-D
    arrays become scalar rows, 2-D arrays one fixed-size-list row per
    outer index; higher ranks are rejected loudly (a flattened
    FixedSizeList would silently change the row count)."""
    import pyarrow as pa

    arr = np.asarray(arr)
    if arr.ndim > 2:
        raise ValueError(
            f"from_numpy supports 1-D and 2-D arrays; got shape {arr.shape}"
            " — reshape to (rows, features) first"
        )
    blocks = []
    for chunk in np.array_split(arr, max(1, num_blocks)):
        if chunk.ndim <= 1:
            col = pa.array(chunk)
        else:
            col = pa.FixedSizeListArray.from_arrays(
                pa.array(chunk.reshape(-1)), chunk.shape[-1]
            )
        blocks.append(pa.table({column: col}))
    return Dataset(blocks, [])


def write_parquet(ds: Dataset, path: str) -> List[str]:
    """One file per block (the reference writes one file per block task)."""
    import pyarrow.parquet as pq

    from . import block as blk

    os.makedirs(path, exist_ok=True)
    out = []
    for i, block in enumerate(ds.iter_blocks()):
        if blk.block_len(block) == 0:
            continue
        file_path = os.path.join(path, f"part-{i:05d}.parquet")
        pq.write_table(blk.block_to_table(block), file_path)
        out.append(file_path)
    return out


def write_csv(ds: Dataset, path: str) -> List[str]:
    import pyarrow.csv as pacsv

    from . import block as blk

    os.makedirs(path, exist_ok=True)
    out = []
    for i, block in enumerate(ds.iter_blocks()):
        if blk.block_len(block) == 0:
            continue
        file_path = os.path.join(path, f"part-{i:05d}.csv")
        pacsv.write_csv(blk.block_to_table(block), file_path)
        out.append(file_path)
    return out


def from_pandas(df) -> Dataset:
    """Arrow-table block over the DataFrame (zero-copy for numeric
    columns via pyarrow's pandas bridge)."""
    import pyarrow as pa

    return Dataset([pa.Table.from_pandas(df, preserve_index=False)], [])


def to_pandas(ds: Dataset):
    import pandas as pd

    rows = [
        r if isinstance(r, dict) else {"data": r} for r in ds.iter_rows()
    ]
    return pd.DataFrame(rows)
