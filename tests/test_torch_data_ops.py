"""The port's distributed data ops (``ray_tpu_torch.data``) on the CPU.

Mirrors ``tests/test_data_ops.py`` on ``ray_tpu_torch`` with the same
assertions, then holds the port against the JAX package: the same seeded
rows go through both packages' ``Dataset`` (each on its own local runtime,
both up in this process), and the outputs must be equal element for
element: ``random_shuffle`` order, ``repartition``, ``sort``, every
``groupby`` aggregate, ``join``, ``unique``, ``zip``, ``split``, the
global aggregates and ``iter_batches``.

The port's runtime runs its scheduler on the CPU
(``RAY_TPU_SCHED_PLATFORM=cpu``).
"""
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd


def _init_port():
    ray_tpu_torch.init(
        num_nodes=2,
        resources_per_node={"CPU": 4, "memory": 1 << 30},
        ignore_reinit_error=True,
    )


@pytest.fixture(scope="module", autouse=True)
def runtime():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        _init_port()
        yield
        ray_tpu_torch.shutdown()


def test_random_shuffle_distributed():
    ds = rd.range(1000, override_num_blocks=8).random_shuffle(seed=7)
    rows = ds.take_all()
    assert sorted(rows) == list(range(1000))
    assert rows != list(range(1000))
    assert ds.num_blocks() == 8


def test_repartition():
    ds = rd.range(100, override_num_blocks=10).repartition(3)
    assert ds.num_blocks() == 3
    assert sorted(ds.take_all()) == list(range(100))


def test_sort_scalars_and_records():
    ds = rd.range(500, override_num_blocks=5).random_shuffle(seed=1)
    assert ds.sort().take_all() == list(range(500))
    assert ds.sort(descending=True).take(3) == [499, 498, 497]
    recs = rd.from_items([{"k": i % 7, "v": i} for i in range(200)]).sort(
        key="v", descending=False
    )
    vs = [r["v"] for r in recs.take_all()]
    assert vs == sorted(vs)


def test_groupby_aggregates():
    ds = rd.from_items([{"k": i % 3, "v": i} for i in range(30)])
    counts = {r["k"]: r["count"] for r in ds.groupby("k").count().take_all()}
    assert counts == {0: 10, 1: 10, 2: 10}
    sums = {r["k"]: r["sum(v)"] for r in ds.groupby("k").sum("v").take_all()}
    assert sums[0] == sum(i for i in range(30) if i % 3 == 0)
    means = {r["k"]: r["mean(v)"] for r in ds.groupby("k").mean("v").take_all()}
    assert means[1] == np.mean([i for i in range(30) if i % 3 == 1])


def test_groupby_map_groups():
    ds = rd.from_items([{"k": i % 2, "v": i} for i in range(10)])
    out = ds.groupby("k").map_groups(lambda rows: [{"k": rows[0]["k"], "n": len(rows)}])
    assert sorted((r["k"], r["n"]) for r in out.take_all()) == [(0, 5), (1, 5)]


def test_join_inner_left_outer():
    left = rd.from_items([{"id": i, "a": i * 10} for i in range(6)])
    right = rd.from_items([{"id": i, "b": i * 100} for i in range(3, 9)])
    inner = left.join(right, on="id").take_all()
    assert sorted(r["id"] for r in inner) == [3, 4, 5]
    assert all(r["a"] == r["id"] * 10 and r["b"] == r["id"] * 100 for r in inner)
    lj = left.join(right, on="id", how="left").take_all()
    assert sorted(r["id"] for r in lj) == list(range(6))
    outer = left.join(right, on="id", how="outer").take_all()
    assert sorted(r["id"] for r in outer) == list(range(9))


def test_global_aggregates():
    ds = rd.range(100, override_num_blocks=7)
    assert ds.sum() == 4950
    assert ds.min() == 0 and ds.max() == 99
    assert ds.mean() == 49.5
    assert abs(ds.std() - np.std(np.arange(100), ddof=1)) < 1e-9
    recs = rd.from_items([{"v": float(i)} for i in range(10)])
    assert recs.sum("v") == 45.0


def test_column_ops_and_unique():
    ds = rd.from_items([{"a": i, "b": i * 2} for i in range(10)])
    wide = ds.add_column("c", lambda r: r["a"] + r["b"])
    assert wide.take(1)[0]["c"] == 0
    assert set(wide.select_columns(["a", "c"]).take(1)[0].keys()) == {"a", "c"}
    assert set(wide.drop_columns(["b"]).take(1)[0].keys()) == {"a", "c"}
    renamed = ds.rename_columns({"a": "x"})
    assert "x" in renamed.take(1)[0]
    assert sorted(rd.from_items([1, 2, 2, 3, 3, 3]).unique()) == [1, 2, 3]


def test_zip_and_limit():
    a = rd.from_items([{"x": i} for i in range(5)])
    b = rd.from_items([{"y": i * 2} for i in range(5)])
    z = a.zip(b).take_all()
    assert all(r["y"] == r["x"] * 2 for r in z)
    assert rd.range(100).limit(5).take_all() == [0, 1, 2, 3, 4]


def test_parquet_csv_roundtrip(tmp_path):
    ds = rd.from_items([{"id": i, "val": float(i) / 3} for i in range(50)])
    pq_dir = str(tmp_path / "pq")
    files = rd.write_parquet(ds, pq_dir)
    assert files
    back = rd.read_parquet(pq_dir).sort(key="id").take_all()
    assert [r["id"] for r in back] == list(range(50))
    csv_dir = str(tmp_path / "csv")
    rd.write_csv(ds, csv_dir)
    back2 = rd.read_csv(csv_dir).sort(key="id").take_all()
    assert [r["id"] for r in back2] == list(range(50))


def test_pandas_interchange():
    import pandas as pd

    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    ds = rd.from_pandas(df)
    assert ds.count() == 3
    df2 = rd.to_pandas(ds.map(lambda r: {**r, "a": r["a"] * 10}))
    assert list(df2["a"]) == [10, 20, 30]


# -- streaming executor: actor pools, stage topology, batch formats ---------


class _AddBias:
    """Stateful callable-class UDF (must run on an actor pool)."""

    def __init__(self, bias=100):
        self.bias = bias
        self.calls = 0

    def __call__(self, batch):
        self.calls += 1
        return {"data": batch["data"] + self.bias}


def test_map_batches_rejects_unknown_kwargs():
    ds = rd.range(10)
    with pytest.raises(TypeError, match="unsupported argument"):
        ds.map_batches(lambda b: b, zero_copy_batch=True)
    with pytest.raises(ValueError, match="batch_format"):
        ds.map_batches(lambda b: b, batch_format="arrow")
    with pytest.raises(ValueError, match="actor pool"):
        ds.map_batches(_AddBias)  # class UDF needs concurrency/compute


def test_map_batches_actor_pool_class_udf():
    ds = rd.range(200, override_num_blocks=16).map_batches(
        _AddBias, concurrency=(1, 3), fn_constructor_args=(1000,), batch_size=32
    )
    assert sorted(ds.take_all()) == [i + 1000 for i in range(200)]


def test_map_batches_actor_pool_function():
    from ray_tpu_torch.data import ActorPoolStrategy

    ds = rd.range(100, override_num_blocks=8).map_batches(
        lambda b: {"data": b["data"] * 2}, compute=ActorPoolStrategy(2, 2)
    )
    assert sorted(ds.take_all()) == [2 * i for i in range(100)]


def test_map_batches_pipeline_mixed_stages():
    # task stage -> actor stage -> task stage, all streaming
    ds = (
        rd.range(120, override_num_blocks=6)
        .map(lambda x: x + 1)
        .map_batches(_AddBias, concurrency=2, fn_constructor_args=(10,))
        .filter(lambda x: x % 2 == 0)
    )
    expect = sorted(x for x in (i + 11 for i in range(120)) if x % 2 == 0)
    assert sorted(ds.take_all()) == expect


def test_map_batches_pandas_format():
    pd = pytest.importorskip("pandas")

    def add_col(df):
        assert isinstance(df, pd.DataFrame)
        df = df.copy()
        df["y"] = df["x"] * 3
        return df

    ds = rd.from_items([{"x": i} for i in range(30)]).map_batches(
        add_col, batch_format="pandas", batch_size=10
    )
    rows = ds.take_all()
    assert all(r["y"] == r["x"] * 3 for r in rows)


def test_map_batches_concurrency_int_tasks():
    # concurrency=int with a plain function caps task parallelism
    ds = rd.range(50, override_num_blocks=10).map_batches(
        lambda b: {"data": b["data"] + 1}, concurrency=2
    )
    assert sorted(ds.take_all()) == list(range(1, 51))


def test_actor_pool_autoscales_and_reuses_state():
    # min=1, max=4: with 16 blocks in flight the pool must grow past 1
    from ray_tpu_torch.data.execution import ActorPoolStrategy, StreamingExecutor

    ds = rd.range(320, override_num_blocks=16).map_batches(
        _AddBias, compute=ActorPoolStrategy(1, 4), fn_constructor_args=(7,)
    )
    ex = StreamingExecutor(ds._input_blocks, ds._build_stages())
    rows = [r for ref in ex.run_refs() for r in ray_tpu_torch.get(ref)]
    assert sorted(rows) == [i + 7 for i in range(320)]


def test_actor_pool_on_cluster_runtime():
    """Actor-pool map_batches through the port's multi-process cluster:
    exercises object_locations (the head's LocateObjects) and
    actor_location for the locality-ranked dispatch path, and keeps
    blocks as refs end to end."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    c.add_node({"CPU": 4.0}, num_workers=2)
    client = c.client()
    set_runtime(client)
    try:
        ds = rd.range(96, override_num_blocks=8).map_batches(
            _AddBias, concurrency=(1, 2), fn_constructor_args=(5,)
        )
        assert sorted(ds.take_all()) == [i + 5 for i in range(96)]
        # locations RPC answers (possibly empty lists for inline objects)
        ref = ray_tpu_torch.put(list(range(100000)))
        locs = client.object_locations([ref])
        assert ref.hex in locs
    finally:
        set_runtime(None)
        client.shutdown()
        c.shutdown()
        _init_port()


# -- the port against the JAX package, element for element -------------------


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return [
        {"k": int(k), "v": int(v), "x": float(x)}
        for k, v, x in zip(rng.integers(0, 9, n), rng.integers(-500, 500, n), rng.standard_normal(n))
    ]


def _shuffle_order(d):
    return d.range(1000, override_num_blocks=8).random_shuffle(seed=7).take_all()


def _shuffle_ndarray_blocks(d):
    arr = np.random.default_rng(3).standard_normal(5000)
    ds = d.from_numpy_blocks(arr, override_num_blocks=6).random_shuffle(seed=5)
    return [np.asarray(b) for b in ds.iter_blocks()]


def _shuffle_records(d):
    return d.from_items(_rows(300, 1), override_num_blocks=4).random_shuffle(seed=9).take_all()


def _repartition(d):
    return [list(b) for b in d.range(100, override_num_blocks=10).repartition(3).iter_blocks()]


def _sort_scalars(d):
    ds = d.range(500, override_num_blocks=5).random_shuffle(seed=1)
    return ds.sort().take_all(), ds.sort(descending=True).take_all()


def _sort_records(d):
    ds = d.from_items(_rows(400, 2), override_num_blocks=4)
    return ds.sort(key="x").take_all(), ds.sort(key="v", descending=True).take_all()


def _groupby(d):
    ds = d.from_items(_rows(600, 3), override_num_blocks=5)
    g = ds.groupby("k")
    return [
        g.count().take_all(), g.sum("v").take_all(), g.min("x").take_all(),
        g.max("v").take_all(), g.mean("x").take_all(),
        g.map_groups(lambda rows: [{"k": rows[0]["k"], "n": len(rows)}]).take_all(),
    ]


def _join(d):
    left = d.from_items([{"id": i % 40, "a": i} for i in range(0, 90, 3)], override_num_blocks=3)
    right = d.from_items([{"id": i % 50, "b": -i} for i in range(0, 120, 4)], override_num_blocks=4)
    return [left.join(right, on="id", how=how).take_all() for how in ("inner", "left", "right", "outer")]


def _aggregates(d):
    ds = d.from_items(_rows(500, 4), override_num_blocks=6)
    return [ds.sum("v"), ds.min("x"), ds.max("x"), ds.mean("x"), ds.std("x"), ds.std("v", ddof=0)]


def _unique_zip_split(d):
    ds = d.from_items(_rows(200, 5), override_num_blocks=4)
    return [
        ds.unique("k"), ds.zip(d.range(200, override_num_blocks=4)).take(50),
        [s.take_all() for s in ds.split(3)], ds.limit(7).take_all(),
    ]


def _batches(d):
    ds = d.from_items(_rows(100, 6), override_num_blocks=3)
    mapped = ds.map(lambda r: {**r, "w": r["v"] * 2}).map_batches(
        lambda b: {"v": b["v"] + 1, "w": b["w"] * 2}, batch_size=8)
    # a pipeline's blocks stream back in the order their tasks finish
    blocks = sorted((list(b) for b in mapped.iter_blocks()), key=repr)
    return list(ds.iter_batches(batch_size=16)), blocks


PARITY = {
    "shuffle_order": _shuffle_order,
    "shuffle_ndarray_blocks": _shuffle_ndarray_blocks,
    "shuffle_records": _shuffle_records,
    "repartition": _repartition,
    "sort_scalars": _sort_scalars,
    "sort_records": _sort_records,
    "groupby": _groupby,
    "join": _join,
    "aggregates": _aggregates,
    "unique_zip_split": _unique_zip_split,
    "batches": _batches,
}


def assert_same(got, want, path="out"):
    """Equal element for element: containers by structure, arrays by dtype,
    shape and bits, scalars by value."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want, equal_nan=want.dtype.kind == "f"), path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture(scope="module")
def reference():
    """Each case's output on the JAX package, on its own local runtime."""
    import ray_tpu
    import ray_tpu.data as ref_rd

    ray_tpu.init(num_nodes=2, resources_per_node={"CPU": 4, "memory": 1 << 30})
    try:
        yield {name: fn(ref_rd) for name, fn in PARITY.items()}
    finally:
        ray_tpu.shutdown()


@pytest.mark.parametrize("case", sorted(PARITY))
def test_outputs_equal_the_reference(reference, case):
    assert_same(PARITY[case](rd), reference[case])
