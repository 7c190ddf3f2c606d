"""The port's streaming shuffle (``ray_tpu_torch.data.shuffle``) on the CPU.

Mirrors ``tests/test_shuffle_plane.py`` on ``ray_tpu_torch`` with the same
assertions: vectorized partitioning equal to the row loop (cross-dtype
hash equality included), the scheduler program's locality term (steering,
weight-0 bit-equivalence, neutral all-zero rows), head-path locality
routing of dep-carrying tasks, shuffle content under the transport kill
switch, eager partition frees, prefetching ingest, ``TorchTrainer``'s
dataset shards, and a node death mid-shuffle reconstructing only the lost
partitions.

Then holds the port against the JAX package on the same seeded blocks:
every partition of every mode, on both paths, equals the reference's
element for element, and so do the remote map and reduce functions and
the locality program's placements. Two more of the port's own: the
runtime hooks the data layer finds by ``getattr`` exist on the port's
runtimes exactly where the reference has them (a rename would switch off
eager frees, locality or batching with no error), and a cluster started
with ``RAY_TPU_DATA_VECTOR_SHUFFLE=0`` partitions on the row loop in its
workers.
"""
import inspect
import os
import re
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.data.shuffle import _compute_parts, _hash_dests, _stable_hash

DATA_DIR = Path(__file__).resolve().parents[1] / "ray_tpu_torch" / "data"


@pytest.fixture(autouse=True)
def _cpu_scheduler(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")


# -- vectorized partitioning (pure host) --------------------------------------


def test_hash_dests_matches_stable_hash_across_dtypes():
    num_parts = 7
    cases = [
        np.array([0, 1, -1, 5, -17, 2**40, -(2**40)], dtype=np.int64),
        np.array([3, 1, 4, 1, 5], dtype=np.int32),
        np.array([0, 1, 2, 255], dtype=np.uint8),
        np.array([True, False, True]),
        np.array([1.0, -2.0, 3.5, -0.0, 1e300, np.nan, np.inf]),
        np.array([1.5, 2.25], dtype=np.float32),
    ]
    for arr in cases:
        dest = _hash_dests(arr, num_parts)
        assert dest is not None, arr.dtype
        assert dest.tolist() == [_stable_hash(v) % num_parts for v in arr], arr.dtype


def test_cross_dtype_keys_co_partition():
    num_parts = 13
    variants = [1, 1.0, np.float64(1.0), np.int32(1), np.float32(1.0), True]
    scalar = {_stable_hash(v) % num_parts for v in variants}
    assert len(scalar) == 1
    for v in variants:
        dest = _hash_dests(np.array([v]), num_parts)
        assert dest is not None
        assert dest[0] == next(iter(scalar))


def _parts_with(vector: bool, *args, compute=_compute_parts, **kwargs):
    old = os.environ.get("RAY_TPU_DATA_VECTOR_SHUFFLE")
    os.environ["RAY_TPU_DATA_VECTOR_SHUFFLE"] = "1" if vector else "0"
    try:
        return compute(*args, **kwargs)
    finally:
        if old is None:
            os.environ.pop("RAY_TPU_DATA_VECTOR_SHUFFLE", None)
        else:
            os.environ["RAY_TPU_DATA_VECTOR_SHUFFLE"] = old


@pytest.mark.parametrize("mode", ["random", "hash", "range"])
def test_vector_partition_matches_row_loop(mode):
    rng = np.random.default_rng(5)
    arr = rng.integers(-1000, 1000, size=2000).astype(np.int64)
    bounds = [-500, 0, 250, 700] if mode == "range" else None
    for block in (arr, arr.tolist()):
        fast = _parts_with(True, block, 6, mode, None, bounds, 42)
        slow = _parts_with(False, block, 6, mode, None, bounds, 42)
        assert len(fast) == len(slow) == 6
        for f, s in zip(fast, slow):
            assert [int(x) for x in f] == [int(x) for x in s]


def test_vector_partition_ndarray_stays_ndarray():
    arr = np.arange(512, dtype=np.float64)
    parts = _parts_with(True, arr, 4, "hash", None, None, None)
    assert all(isinstance(p, np.ndarray) for p in parts)
    assert sum(len(p) for p in parts) == 512
    assert np.array_equal(np.sort(np.concatenate(parts)), arr)


def test_vector_partition_dict_rows_with_key_fn():
    rows = [{"k": i % 17, "v": i} for i in range(500)]
    fast = _parts_with(True, rows, 5, "hash", lambda r: r["k"], None, None)
    slow = _parts_with(False, rows, 5, "hash", lambda r: r["k"], None, None)
    assert fast == slow


def test_range_mode_nan_keys_match_row_loop():
    arr = np.array([1.0, -2.5, np.nan, 7.0, np.nan, 3.25, np.inf, -np.inf])
    bounds = [0.0, 2.0, 5.0]
    fast = _parts_with(True, arr, 4, "range", None, bounds, None)
    slow = _parts_with(False, arr.tolist(), 4, "range", None, bounds, None)
    for f, s in zip(fast, slow):
        np.testing.assert_array_equal(np.asarray(list(f), dtype=float), np.asarray(s, dtype=float))


def test_reduce_sorted_ndarray_fast_path_is_1d_only():
    from ray_tpu_torch.data.shuffle import _reduce_sorted

    one_d = _reduce_sorted._fn(None, False, np.array([3.0, 1.0]), np.array([2.0]))
    assert np.array_equal(one_d, np.array([1.0, 2.0, 3.0]))
    with pytest.raises(ValueError):
        _reduce_sorted._fn(None, False, np.array([[3, 1], [1, 9]]), np.array([[2, 5]]))


def test_non_numeric_keys_fall_back_to_row_loop():
    rows = ["a", "b", "a", "c"] * 10
    fast = _parts_with(True, rows, 3, "hash", None, None, None)
    slow = _parts_with(False, rows, 3, "hash", None, None, None)
    assert fast == slow


# -- the scheduler program's locality term ------------------------------------


def _program_inputs():
    totals = np.array([[8.0, 0.0], [8.0, 0.0]], dtype=np.float32)
    return (totals, totals, np.array([True, True]), np.zeros(2, dtype=np.int32),
            np.ones((1, 2), dtype=np.float32), np.array([[1.0, 0.0]], dtype=np.float32),
            np.zeros(4, dtype=np.int32), np.zeros(1, dtype=np.float32))


def _shapes(pkg, seed, weights=None, locality=None):
    import importlib

    hybrid = importlib.import_module(f"{pkg}.scheduler.hybrid")
    kw = {}
    if weights is not None:
        kw = dict(weights=hybrid.ScoreWeights(*weights), locality=locality)
    inputs = _program_inputs()
    if pkg == "ray_tpu_torch":
        kw["device"] = "cpu"
    else:  # the reference's program takes jax arrays, as its own test passes them
        import jax.numpy as jnp

        inputs = [jnp.asarray(x) for x in inputs]
        if locality is not None:
            kw["locality"] = jnp.asarray(locality)
    res = hybrid.hybrid_schedule_shapes_multi_impl(*inputs, np.uint32(seed), **kw)
    return np.asarray(res.node), np.asarray(res.avail_out)


def test_locality_term_steers_to_partition_heavy_node():
    loc = np.array([[0.0, 1.0]], dtype=np.float32)
    node, _ = _shapes("ray_tpu_torch", 3, (1.0, 0.0, 0.0, 0.0, 2.0), loc)
    assert node.tolist() == [1, 1, 1, 1]


def test_locality_weight_zero_bit_equivalent():
    loc = np.array([[0.0, 1.0]], dtype=np.float32)
    base = _shapes("ray_tpu_torch", 9)
    w0 = _shapes("ray_tpu_torch", 9, (1.0, 0.0, 0.0, 0.0, 0.0), loc)
    assert np.array_equal(base[0], w0[0])
    assert np.array_equal(base[1], w0[1])


def test_all_zero_locality_rows_are_neutral():
    zeros = np.zeros((1, 2), dtype=np.float32)
    base = _shapes("ray_tpu_torch", 11)
    wloc = _shapes("ray_tpu_torch", 11, (1.0, 0.0, 0.0, 0.0, 3.0), zeros)
    assert np.array_equal(base[0], wloc[0])


@pytest.mark.parametrize("seed,weights,loc", [
    (3, (1.0, 0.0, 0.0, 0.0, 2.0), [[0.0, 1.0]]),
    (9, (1.0, 0.0, 0.0, 0.0, 0.0), [[0.0, 1.0]]),
    (11, (1.0, 0.0, 0.0, 0.0, 3.0), [[0.0, 0.0]]),
    (5, (1.0, 0.0, 0.0, 0.0, 0.5), [[0.7, 0.2]]),
])
def test_locality_program_equals_the_reference(seed, weights, loc):
    loc = np.asarray(loc, dtype=np.float32)
    got = _shapes("ray_tpu_torch", seed, weights, loc)
    want = _shapes("ray_tpu", seed, weights, loc)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


# -- head-path locality routing -----------------------------------------------


def _make_payload(kb):
    import numpy as _np

    return _np.zeros(kb * 128, dtype=_np.float64)  # kb KiB


def _consume_payload(arr):
    import numpy as _np

    return _np.zeros(32 * 1024, dtype=_np.float64)  # above the inline size: gets a location


def test_head_locality_routes_consumer_to_data_node(monkeypatch):
    """With sched_w_locality > 0, a task whose sealed, located dep lives on
    node A runs on node A: its output seals there."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.core.scheduling_strategies import NodeAffinitySchedulingStrategy

    monkeypatch.setenv("RAY_TPU_SCHED_W_LOCALITY", "4.0")
    c = Cluster()
    node_a = c.add_node({"CPU": 4.0}, num_workers=2)
    c.add_node({"CPU": 4.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        make = ray_tpu_torch.remote(_make_payload).options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(node_a))
        dep = make.remote(1024)  # 1 MiB, seals on node A
        ray_tpu_torch.wait([dep], timeout=60)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if node_a in (rt.object_locations([dep]).get(dep.hex) or []):
                break
            time.sleep(0.1)
        assert node_a in (rt.object_locations([dep]).get(dep.hex) or [])
        consume = ray_tpu_torch.remote(_consume_payload)
        outs = [consume.remote(dep) for _ in range(4)]
        ray_tpu_torch.get(outs, timeout=60)
        out_locs = rt.object_locations(outs)
        on_a = sum(1 for r in outs if node_a in (out_locs.get(r.hex) or []))
        assert on_a == len(outs), f"only {on_a}/{len(outs)} consumers ran on the data node ({out_locs})"
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


# -- shuffle content across the transport kill switch ------------------------


def _run_cluster_shuffle():
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    c.add_node({"CPU": 4.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        arr = np.arange(20000, dtype=np.float64)
        ds = rd.from_numpy_blocks(arr, override_num_blocks=8).random_shuffle(seed=11)
        blocks = [np.asarray(list(b)) for b in ds.iter_blocks()]
        grouped = (
            rd.range(2000, override_num_blocks=4)
            .map(lambda x: {"k": x % 10, "v": x})
            .groupby("k")
            .count()
            .take_all()
        )
        return blocks, {r["k"]: r["count"] for r in grouped}
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


def _replay_random_shuffle(blocks, seed):
    """The shuffle of ``Dataset.random_shuffle(seed)`` computed in this
    process with the port's own map and reduce functions."""
    from ray_tpu_torch.data.shuffle import _partition_block, _reduce_shuffled

    n = len(blocks)
    maps = [_partition_block._fn(b, n, "random", None, None, seed + i) for i, b in enumerate(blocks)]
    return [_reduce_shuffled._fn(seed, *[m[p] for m in maps]) for p in range(n)]


@pytest.mark.parametrize("native_net", ["1", "0"])
def test_shuffle_content_exact_under_transport_killswitch(monkeypatch, native_net):
    """Socket plane on, and the chunked-RPC fallback (RAY_TPU_NATIVE_NET=0):
    the same content-exact shuffle either way, equal to the in-process
    replay of the port's map and reduce functions."""
    monkeypatch.setenv("RAY_TPU_NATIVE_NET", native_net)
    blocks, counts = _run_cluster_shuffle()
    rows = np.concatenate(blocks)
    assert np.array_equal(np.sort(rows), np.arange(20000, dtype=np.float64))
    assert counts == {i: 200 for i in range(10)}
    replay = _replay_random_shuffle(np.array_split(np.arange(20000, dtype=np.float64), 8), 11)
    assert np.array_equal(rows, np.concatenate(replay))


# -- eager frees + prefetching ingest ----------------------------------------


def test_eager_free_releases_partitions_as_reduces_seal():
    from ray_tpu_torch.data.shuffle import SHUFFLE_PARTS_FREED, shuffle_blocks

    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4})
    try:
        base = SHUFFLE_PARTS_FREED.value()
        blocks = [list(range(i * 100, (i + 1) * 100)) for i in range(4)]
        refs = shuffle_blocks(blocks, 4, mode="random", seed=0)
        got = ray_tpu_torch.get(refs, timeout=60)
        assert sorted(x for part in got for x in part) == list(range(400))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if SHUFFLE_PARTS_FREED.value() - base >= 16:  # 4 maps x 4 parts
                break
            time.sleep(0.2)
        assert SHUFFLE_PARTS_FREED.value() - base >= 16, "map partitions were not freed as reduces sealed"
    finally:
        ray_tpu_torch.shutdown()


def test_iter_batches_prefetch_matches_sync():
    from ray_tpu_torch import data as rd

    ray_tpu_torch.init(num_nodes=2, resources_per_node={"CPU": 4})
    try:
        ds = rd.from_numpy_blocks(np.arange(30000, dtype=np.int64),
                                  override_num_blocks=10).random_shuffle(seed=3).materialize()
        sync = np.concatenate([b["data"] for b in ds.iter_batches(batch_size=4096)])
        pre = np.concatenate([b["data"] for b in ds.iter_batches(batch_size=4096, prefetch_batches=3)])
        assert np.array_equal(sync, pre)
        assert np.array_equal(np.sort(sync), np.arange(30000))
    finally:
        ray_tpu_torch.shutdown()


def test_trainer_dataset_shards_stream_batches():
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    ray_tpu_torch.init(num_nodes=2, resources_per_node={"CPU": 4})
    try:
        ds = rd.from_numpy_blocks(np.arange(4000, dtype=np.float64),
                                  override_num_blocks=8).random_shuffle(seed=2)

        def loop(config):
            from ray_tpu_torch import train

            seen = 0
            for batch in train.get_dataset_shard("train").iter_batches(batch_size=256):
                seen += len(batch["data"])
            train.report({"rows": seen})

        result = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=2),
                              datasets={"train": ds}).fit()
        assert result.error is None
        # rank-0 report carries its shard; both shards partition the rows
        assert 0 < result.metrics["rows"] < 4000
    finally:
        ray_tpu_torch.shutdown()


# -- a node death mid-shuffle reconstructs only the lost partitions ---------

_CHAOS_ROWS = 120_000  # ~960KB blocks -> ~160KB partitions (above the inline size)


def _block_at(i):
    import numpy as _np

    return _np.arange(i * _CHAOS_ROWS, (i + 1) * _CHAOS_ROWS, dtype=_np.float64)


def test_node_death_mid_shuffle_reconstructs_only_lost_partitions():
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.cluster.head import OBJECTS_RECONSTRUCTED
    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.core.scheduling_strategies import NodeAffinitySchedulingStrategy
    from ray_tpu_torch.data.shuffle import _partition_block, _reduce_concat

    c = Cluster()
    nodes = [c.add_node({"CPU": 2.0}, num_workers=2) for _ in range(3)]
    rt = c.client()
    set_runtime(rt)
    try:
        n_blocks, n_parts = 6, 6
        make = ray_tpu_torch.remote(_block_at)
        blocks = [
            make.options(scheduling_strategy=NodeAffinitySchedulingStrategy(nodes[i % 3], soft=True)).remote(i)
            for i in range(n_blocks)
        ]
        ray_tpu_torch.wait(blocks, num_returns=n_blocks, timeout=120)
        map_refs = [
            _partition_block.options(num_returns=n_parts).remote(b, n_parts, "random", None, None, 100 + i)
            for i, b in enumerate(blocks)
        ]
        flat = [r for m in map_refs for r in m]
        ready, _ = ray_tpu_torch.wait(flat, num_returns=len(flat), timeout=180)
        assert len(ready) == len(flat), "map stage did not finish"
        base = sum(OBJECTS_RECONSTRUCTED.values_by_label().values())
        locs = rt.object_locations(flat)
        by_node = {}
        for r in flat:
            for nid in locs.get(r.hex) or []:
                by_node[nid] = by_node.get(nid, 0) + 1
        victim = max(by_node, key=by_node.get)
        assert by_node[victim] < len(flat)  # the kill must not hold everything
        c.kill_node(victim)
        reduces = [_reduce_concat.remote(*[m[p] for m in map_refs]) for p in range(n_parts)]
        out = ray_tpu_torch.get(reduces, timeout=300)
        rows = np.sort(np.concatenate([np.asarray(list(p)) for p in out]))
        assert np.array_equal(rows, np.arange(n_blocks * _CHAOS_ROWS, dtype=np.float64)), \
            "shuffle lost or duplicated rows across the node death"
        delta = sum(OBJECTS_RECONSTRUCTED.values_by_label().values()) - base
        assert delta >= 1, "nothing was reconstructed?"
        assert delta < len(flat), f"reconstructed {delta} objects: the whole map stage re-ran"
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


# -- the port against the JAX package -----------------------------------------


def _seeded_blocks():
    rng = np.random.default_rng(17)
    ints = rng.integers(-10**6, 10**6, 3000).astype(np.int64)
    floats = rng.standard_normal(3000) * 50
    floats[::97] = np.round(floats[::97])  # integral floats hash to int(f)
    floats[5] = np.nan
    return {
        "int64": ints,
        "float64": floats,
        "uint8": rng.integers(0, 256, 500).astype(np.uint8),
        "int_rows": ints[:800].tolist(),
        "str_rows": [f"k{int(x) % 37}" for x in ints[:600]],
        "dict_rows": [{"k": int(x) % 23, "v": float(y)} for x, y in zip(ints[:700], floats)],
    }


def _block_cases():
    for name in ("int64", "float64", "uint8", "int_rows", "str_rows", "dict_rows"):
        for mode in ("random", "hash", "range"):
            if mode == "range" and name in ("str_rows", "dict_rows", "float64"):
                continue  # range bounds compare keys; NaN is covered above
            yield f"{name}-{mode}"


def _compute(pkg, name, mode, vector):
    import importlib

    shuffle = importlib.import_module(f"{pkg}.data.shuffle")
    block = _seeded_blocks()[name]
    key_fn = (lambda r: r["k"]) if name == "dict_rows" else None
    bounds = None
    if mode == "range":
        bounds = [int(b) for b in np.quantile(np.asarray(block, dtype=np.float64), [0.2, 0.5, 0.9])]
    return _parts_with(vector, block, 5, mode, key_fn, bounds, 1234, compute=shuffle._compute_parts)


@pytest.mark.parametrize("vector", [True, False], ids=["vector", "rowloop"])
@pytest.mark.parametrize("case", list(_block_cases()))
def test_partitions_equal_the_reference(case, vector):
    name, mode = case.split("-")
    got = _compute("ray_tpu_torch", name, mode, vector)
    want = _compute("ray_tpu", name, mode, vector)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert type(g) is type(w)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=w.dtype.kind == "f")
        else:  # repr: exact for floats, and NaN rows compare equal
            assert repr(g) == repr(w)


def test_map_and_reduce_functions_equal_the_reference():
    """The remote map and reduce bodies, called in this process, equal the
    reference's on the same seeded blocks: ``_partition_block`` (both
    return forms), ``_partition_block_stream``, ``_reduce_concat``,
    ``_reduce_shuffled`` and ``_reduce_sorted``, and ``sample_bounds``'s
    sampling."""
    import importlib

    blocks = np.array_split(np.random.default_rng(4).standard_normal(6000), 4)
    outs = {}
    for pkg in ("ray_tpu_torch", "ray_tpu"):
        s = importlib.import_module(f"{pkg}.data.shuffle")
        maps = [s._partition_block._fn(b, 4, "random", None, None, 40 + i) for i, b in enumerate(blocks)]
        streamed = [list(s._partition_block_stream._fn(b, 4, "hash", None, None, None)) for b in blocks]
        one = s._partition_block._fn(blocks[0], 1, "random", None, None, 3)
        outs[pkg] = (
            [s._reduce_concat._fn(*[m[p] for m in maps]) for p in range(4)]
            + [s._reduce_shuffled._fn(7, *[m[p] for m in maps]) for p in range(4)]
            + [s._reduce_sorted._fn(None, True, *[m[p] for m in streamed]) for p in range(4)]
            + [s._reduce_sorted._fn(abs, False, *[list(m[p]) for m in streamed]) for p in range(4)]
            + [one]
        )
    for g, w in zip(outs["ray_tpu_torch"], outs["ray_tpu"]):
        assert type(g) is type(w) and np.array_equal(np.asarray(g), np.asarray(w))


def test_sample_bounds_and_shuffle_blocks_equal_the_reference():
    import importlib

    import ray_tpu

    blocks = [list(np.random.default_rng(i).integers(0, 10**5, 400)) for i in range(5)]
    outs = {}
    for pkg, mod in (("ray_tpu_torch", ray_tpu_torch), ("ray_tpu", ray_tpu)):
        s = importlib.import_module(f"{pkg}.data.shuffle")
        mod.init(num_nodes=2, resources_per_node={"CPU": 4})
        try:
            bounds = s.sample_bounds(blocks, 5, None)
            parts = mod.get(s.shuffle_blocks(blocks, 5, mode="range", bounds=bounds,
                                             reduce_fn=s._reduce_sorted, reduce_args=(None, False),
                                             streaming=True), timeout=60)
            hashed = mod.get(s.shuffle_blocks(blocks, 3, mode="hash"), timeout=60)
            outs[pkg] = (bounds, parts, hashed)
        finally:
            mod.shutdown()
    assert outs["ray_tpu_torch"] == outs["ray_tpu"]


# -- the runtime hooks the data layer finds by name ---------------------------

HOOKS = {"free_objects", "actor_location", "submit_actor_method_batch", "object_sizes",
         "object_locations", "_shutdown", "_shutdown_done"}


def _sets_attr(cls, name):
    return hasattr(cls, name) or re.search(rf"self\.{name}\s*=", inspect.getsource(cls)) is not None


def test_runtime_hooks_exist_where_the_reference_has_them():
    """``getattr(rt, name, None)`` turns a path off quietly when the name is
    missing, so each hook the port's data layer asks for is held to exist on
    the port's runtimes exactly where it exists on the reference's."""
    from ray_tpu.cluster.client import RemoteRuntime as RefRemote
    from ray_tpu.core.runtime import Runtime as RefLocal

    from ray_tpu_torch.cluster.client import RemoteRuntime
    from ray_tpu_torch.core.runtime import Runtime

    asked = set()
    for path in DATA_DIR.glob("*.py"):
        asked |= set(re.findall(r'getattr\(\s*self\._rt,\s*"(\w+)"', path.read_text()))
        asked |= set(re.findall(r'getattr\(\s*rt,\s*"(\w+)"', path.read_text()))
    assert asked == HOOKS
    for name in sorted(HOOKS):
        assert _sets_attr(RemoteRuntime, name) == _sets_attr(RefRemote, name), name
        assert _sets_attr(Runtime, name) == _sets_attr(RefLocal, name), name
    # the cluster runtime has every hook: eager frees, locality, batching and sizing
    assert all(_sets_attr(RemoteRuntime, n) for n in HOOKS - {"_shutdown"})
    assert _sets_attr(Runtime, "free_objects") and _sets_attr(Runtime, "_shutdown")


# -- RAY_TPU_DATA_VECTOR_SHUFFLE is read in the workers -------------------------


@pytest.mark.parametrize("vector", ["0", "1"], ids=["rowloop", "vector"])
def test_cluster_workers_read_the_vector_switch(monkeypatch, vector):
    """The partitioning path is chosen in the workers: a cluster whose
    agents start with ``RAY_TPU_DATA_VECTOR_SHUFFLE=0`` partitions ndarray
    blocks on the row loop (list partitions) even with the driver's switch
    on, and one started with ``=1`` on the vectorized path (ndarray
    partitions). Both give the same rows, equal to the reference's."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.data.shuffle import _partition_block

    monkeypatch.setenv("RAY_TPU_DATA_VECTOR_SHUFFLE", vector)
    c = Cluster()
    for _ in range(2):
        c.add_node({"CPU": 4.0}, num_workers=2, wait=False)
    c.wait_for_nodes(2)
    monkeypatch.setenv("RAY_TPU_DATA_VECTOR_SHUFFLE", "1")  # the driver's own switch on
    rt = c.client()
    set_runtime(rt)
    try:
        block = np.arange(4000, dtype=np.float64)
        parts = ray_tpu_torch.get(
            list(_partition_block.options(num_returns=4).remote(block, 4, "random", None, None, 7)),
            timeout=120)
        ran = {type(p) for p in parts}
        assert ran == ({list} if vector == "0" else {np.ndarray}), ran
        ds = rd.from_numpy_blocks(np.arange(20000, dtype=np.float64),
                                  override_num_blocks=4).random_shuffle(seed=11)
        rows = np.concatenate([np.asarray(list(b), dtype=np.float64) for b in ds.iter_blocks()])
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()
    want = np.concatenate(_parts_with(True, block, 4, "random", None, None, 7))
    assert np.array_equal(np.concatenate([np.asarray(p) for p in parts]), want)
    replay = _replay_random_shuffle(np.array_split(np.arange(20000, dtype=np.float64), 4), 11)
    assert np.array_equal(rows, np.concatenate(replay))
