"""The port's Arrow blocks, readers and block-size-aware repartition on the
CPU (``ray_tpu_torch.data.block``, ``ray_tpu_torch.data.io``).

Mirrors ``tests/test_data_arrow.py`` on ``ray_tpu_torch`` with the same
assertions, then feeds the same seeded numpy arrays and files to both
packages: ``from_numpy``, ``repartition(target_block_bytes=...)``, the
readers, and ``sort``/``groupby`` over Arrow blocks give equal rows and
equal block boundaries; and the ndarray block helpers run without
importing pyarrow, in a fresh process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

import ray_tpu_torch
import ray_tpu_torch.data as rd
from ray_tpu_torch.data import block as blk

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture()
def rt(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
    rt = ray_tpu_torch.init(num_nodes=2, resources_per_node={"CPU": 4.0})
    yield rt
    ray_tpu_torch.shutdown()


def test_zero_copy_batch_views():
    """A numpy column round-trips through an Arrow block and back to a
    numpy batch view without copying: the view shares the buffer."""
    src = np.arange(100_000, dtype=np.float32)
    table = pa.table({"x": pa.array(src)})
    batch = blk.arrow_to_batch(table, "numpy")
    assert np.shares_memory(batch["x"], src)
    piece = blk.slice_block(table, 1000, 50_000)
    view = blk.arrow_to_batch(piece, "numpy")["x"]
    assert np.shares_memory(view, src)
    assert view[0] == 1000.0


def test_map_batches_pyarrow_format(rt):
    ds = rd.from_numpy(np.arange(1000, dtype=np.int64), column="v")

    def double(t):
        assert isinstance(t, pa.Table)
        return t.set_column(0, "v", pa.compute.multiply(t.column("v"), 2))

    out = ds.map_batches(double, batch_size=256, batch_format="pyarrow")
    rows = out.take_all()
    assert rows[:3] == [{"v": 0}, {"v": 2}, {"v": 4}]
    assert len(rows) == 1000


def test_readers_produce_arrow_blocks(rt, tmp_path):
    import pandas as pd

    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    pq_dir = tmp_path / "pq"
    rd.write_parquet(rd.from_pandas(df), str(pq_dir))
    ds = rd.read_parquet(str(pq_dir))
    first = next(iter(ds.iter_blocks()))
    assert blk.is_arrow(first)
    assert ds.take_all() == df.to_dict("records")


def test_read_json_lines_and_array(rt, tmp_path):
    rows = [{"a": i, "b": f"s{i}"} for i in range(10)]
    jl = tmp_path / "d1.jsonl"
    jl.write_text("\n".join(json.dumps(r) for r in rows))
    arr = tmp_path / "d2.json"
    arr.write_text(json.dumps(rows))
    assert rd.read_json(str(jl)).take_all() == rows
    assert rd.read_json(str(arr)).take_all() == rows
    ds = rd.read_json(str(jl)).filter(lambda r: r["a"] % 2 == 0)
    assert [r["a"] for r in ds.take_all()] == [0, 2, 4, 6, 8]


def test_from_numpy_rows_and_2d(rt):
    a1 = np.arange(64, dtype=np.float64)
    ds = rd.from_numpy(a1, num_blocks=4)
    assert ds.num_blocks() == 4
    assert ds.take_all()[:3] == [{"data": 0.0}, {"data": 1.0}, {"data": 2.0}]
    a2 = np.arange(12, dtype=np.float32).reshape(4, 3)
    rows = rd.from_numpy(a2).take_all()
    assert list(rows[1]["data"]) == [3.0, 4.0, 5.0]
    with pytest.raises(ValueError, match="1-D and 2-D"):
        rd.from_numpy(np.zeros((4, 2, 3)))
    # a user table whose only column is named "data" keeps dict rows
    t = pa.table({"data": [1, 2, 3]})
    assert blk.block_rows(t) == [{"data": 1}, {"data": 2}, {"data": 3}]


def test_repartition_by_target_bytes(rt):
    src = np.arange(10_000, dtype=np.int64)
    ds = rd.from_numpy(src, num_blocks=50)
    per_block = blk.block_nbytes(next(iter(ds.iter_blocks())))
    merged = ds.repartition(target_block_bytes=per_block * 10)
    assert merged.num_blocks() <= 8
    want = [{"data": i} for i in range(10_000)]
    assert merged.take_all() == want
    fat = rd.from_numpy(src, num_blocks=1)
    split = fat.repartition(target_block_bytes=per_block * 2)
    assert split.num_blocks() >= 20
    assert split.take_all() == want
    with pytest.raises(ValueError, match="exactly one"):
        ds.repartition(4, target_block_bytes=100)


def test_arrow_blocks_through_shuffle_sort_groupby(rt):
    ds = rd.from_numpy(np.array([5, 3, 9, 1, 7], dtype=np.int64), column="k")
    out = ds.sort(key="k").take_all()
    assert [r["k"] for r in out] == [1, 3, 5, 7, 9]
    counts = (
        rd.from_numpy(np.array([1, 2, 1, 1, 2], dtype=np.int64), column="g")
        .groupby("g")
        .count()
    )
    assert sorted((r["g"], r["count"]) for r in counts.take_all()) == [(1, 3), (2, 2)]


# -- the port against the JAX package ----------------------------------------


def _arrow_cases(d, files):
    rng = np.random.default_rng(21)
    a2 = rng.standard_normal((40, 3)).astype(np.float32)
    keys = rng.integers(0, 6, 300)
    out = {
        "from_numpy_2d": d.from_numpy(a2, num_blocks=3).take_all(),
        "repartition": [
            blk_rows for blk_rows in (
                d.from_numpy(np.arange(3000, dtype=np.int64), num_blocks=30)
                .repartition(target_block_bytes=2000).iter_blocks()
            )
        ],
        "sort": d.from_numpy(rng.standard_normal(500), column="x", num_blocks=4)
        .sort(key="x", descending=True).take_all(),
        "groupby": d.from_numpy(keys, column="g", num_blocks=5).groupby("g").count().take_all(),
        "pyarrow_batches": [
            t.to_pydict() for t in d.from_numpy(np.arange(100), column="v", num_blocks=2)
            .iter_batches(batch_size=30, batch_format="pyarrow")
        ],
        "read_parquet": d.read_parquet(files["pq"]).take_all(),
        "read_csv": d.read_csv(files["csv"]).take_all(),
        "read_json": d.read_json(files["json"]).take_all(),
        "to_pandas": d.to_pandas(d.from_items([{"a": i, "b": i / 7} for i in range(9)]))
        .to_dict("list"),
    }
    out["repartition"] = [blk.block_rows(b) for b in out["repartition"]]
    return out


def test_arrow_paths_equal_the_reference(rt, tmp_path):
    import pandas as pd
    import ray_tpu
    import ray_tpu.data as ref_rd

    rng = np.random.default_rng(8)
    df = pd.DataFrame({"i": np.arange(50), "f": rng.standard_normal(50), "s": [f"r{i}" for i in range(50)]})
    files = {"pq": str(tmp_path / "pq"), "csv": str(tmp_path / "csv"), "json": str(tmp_path / "j.jsonl")}
    rd.write_parquet(rd.from_pandas(df), files["pq"])
    rd.write_csv(rd.from_pandas(df), files["csv"])
    Path(files["json"]).write_text("\n".join(json.dumps(r) for r in df.to_dict("records")))
    got = _arrow_cases(rd, files)
    ray_tpu.init(num_nodes=2, resources_per_node={"CPU": 4.0})
    try:
        want = _arrow_cases(ref_rd, files)
    finally:
        ray_tpu.shutdown()
    assert list(got) == list(want)
    for name in want:
        g, w = got[name], want[name]
        if name == "from_numpy_2d":
            assert [list(r["data"]) for r in g] == [list(r["data"]) for r in w]
        else:
            assert g == w, name


def test_ndarray_blocks_never_import_pyarrow():
    code = (
        "import sys, numpy as np\n"
        "from ray_tpu_torch.data import block as blk\n"
        "from ray_tpu_torch.data.shuffle import _compute_parts\n"
        "a = np.arange(10.0)\n"
        "assert blk.is_ndarray(a) and blk.block_nbytes(a) == 80\n"
        "assert blk.concat_blocks([a[:4], a[4:]]).tolist() == a.tolist()\n"
        "assert blk.slice_block(a, 2, 3).tolist() == [2.0, 3.0, 4.0]\n"
        "assert sum(len(p) for p in _compute_parts(a, 3, 'hash', None, None, None)) == 10\n"
        "print(','.join(m for m in sys.modules if m.split('.')[0] in ('pyarrow', 'pandas')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True,
                         env={**os.environ, "RAY_TPU_SCHED_PLATFORM": "cpu"})
    assert out.stdout.strip() == "", out.stdout
