"""The resident scheduler state, its pipeline and the unpark estimator on
the port, mirroring ``tests/test_device_scheduler.py``,
``tests/test_sched_pipeline.py`` (the cases that need no ``cluster/head.py``
or ``sim.py``) and ``tests/test_resource_units.py``.

``DeviceSchedulerState(platform="cpu")`` of the port is driven beside the
reference's ``DeviceSchedulerState(platform="cpu")`` on the same view
mutations and demand stream: every round places each request on the same
node, nominates the same victims, and leaves the same resident
availability.
"""
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu.scheduler import device as JD
from ray_tpu.scheduler.resources import ClusterView as JClusterView
from ray_tpu.scheduler.resources import ResourceVocab as JResourceVocab
from ray_tpu_torch.scheduler import device as TD
from ray_tpu_torch.scheduler.binpack import DeltaBinPacker, bin_pack_residual
from ray_tpu_torch.scheduler.device import DeviceSchedulerState, pad_scatter
from ray_tpu_torch.scheduler.pipeline import SchedulerPipeline
from ray_tpu_torch.scheduler.resources import (
    FP_SCALE,
    MAX_EXACT_VIEW_TOTAL,
    ClusterView,
    ResourceRequest,
    ResourceVocab,
    from_fp,
    to_fp,
)
from ray_tpu_torch.scheduler.unpark import select_unparkable


def make_view(n_nodes=4, cpu=8.0, mem=64.0, cls=(ResourceVocab, ClusterView)):
    vocab = cls[0]()
    view = cls[1](vocab)
    for i in range(n_nodes):
        view.add_node(f"node{i}", {"CPU": cpu, "memory": mem})
    return vocab, view


def dense(vocab, view, res):
    return ResourceRequest.from_map(vocab, res).dense(view.totals.shape[1])


def cpu_state():
    return DeviceSchedulerState(platform="cpu")


def test_default_platform_is_cuda_and_raises_without_it():
    """No platform means cfg.sched_platform, "cuda": on a host without CUDA
    the state raises rather than fall back to the CPU."""
    from ray_tpu_torch.config import cfg

    assert cfg.sched_platform == "cuda"
    if torch.cuda.is_available():
        assert DeviceSchedulerState().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceSchedulerState()
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceSchedulerState(platform="cuda")


def test_schedule_and_delta_sync():
    vocab, view = make_view(2, cpu=4.0)
    st = cpu_state()
    st.sync(view)
    d = dense(vocab, view, {"CPU": 4.0})
    assert sorted(st.schedule(np.stack([d, d])).tolist()) == [0, 1]
    view.update_available("node0", {"CPU": 4.0, "memory": 64.0})
    assert view.dirty_rows
    st.sync(view)
    assert not view.dirty_rows
    assert st.schedule(np.stack([d])).tolist() == [0]
    assert st.schedule(np.stack([d])).tolist() == [-1]


def test_a_released_state_never_uploads_again():
    """Queue C 22: a stopped owner's state is released for good. A sync,
    round, ring round or slot estimate that a handler still running on the
    stopped owner asks for raises ``StateReleased`` and uploads nothing,
    so the state stays at 0 resident bytes."""
    vocab, view = make_view(2, cpu=4.0)
    st = cpu_state()
    st.sync(view)
    d = dense(vocab, view, {"CPU": 4.0})
    assert st.ring_park(("cpu4",), d)
    st.ring_schedule({0: 1})
    assert st.resident_bytes() > 0
    st.release()
    assert st.released and st.resident_bytes() == 0
    view.update_available("node0", {"CPU": 2.0, "memory": 64.0})
    for ask in (lambda: st.sync(view), lambda: st.schedule(np.stack([d])),
                lambda: st.ring_schedule({0: 1}), lambda: st.shape_slots(np.stack([d]))):
        with pytest.raises(TD.StateReleased):
            ask()
        assert st.resident_bytes() == 0


def test_runtime_shutdown_releases_its_state(monkeypatch):
    """A shut-down local runtime frees its scheduler state at shutdown,
    not when the collector reaches the runtime's cycles (Queue C 22: a
    state left for the collector made a process-wide count of resident
    states see one more than the live head's)."""
    import ray_tpu_torch

    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
    rt = ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 2})
    try:
        f = ray_tpu_torch.remote(lambda x: x + 1)
        assert ray_tpu_torch.get(f.remote(1), timeout=60) == 2
        state = rt.device_state
        assert state.resident_bytes() > 0
    finally:
        ray_tpu_torch.shutdown()
    assert state.released and state.resident_bytes() == 0


def test_full_resync_on_topology_change():
    vocab, view = make_view(1, cpu=2.0)
    st = cpu_state()
    st.sync(view)
    d = dense(vocab, view, {"CPU": 2.0})
    assert st.schedule(np.stack([d])).tolist() == [0]
    view.subtract(0, d)
    view.add_node("nodeX", {"CPU": 2.0, "memory": 1e9})
    st.sync(view)
    assert st.schedule(np.stack([dense(vocab, view, {"CPU": 2.0})])).tolist() == [1]


def test_no_node_zero_hotspot_and_capacity_exactness():
    vocab, view = make_view(8, cpu=64.0)
    st = cpu_state()
    st.sync(view)
    d = dense(vocab, view, {"CPU": 1.0})
    counts = np.zeros(8, dtype=int)
    for _ in range(48):
        counts[int(st.schedule(np.stack([d]))[0])] += 1
    assert counts[0] < 24 and (counts > 0).sum() >= 4, counts.tolist()
    vocab, view = make_view(3, cpu=2.0)
    st = cpu_state()
    st.sync(view)
    rows = st.schedule(np.stack([dense(vocab, view, {"CPU": 1.0})] * 10))
    placed = rows[rows >= 0]
    assert placed.shape[0] == 6 and np.bincount(placed, minlength=3).max() <= 2


def _pair_views(n, hetero):
    out = []
    for cls in ((ResourceVocab, ClusterView), (JResourceVocab, JClusterView)):
        vocab = cls[0]()
        view = cls[1](vocab)
        if hetero:
            view.register_node_type("dense", {"CPU": 1.25, "memory": 1.1})
            view.register_node_type("highmem", {"memory": 1.2, "CPU": 0.8})
        for i in range(n):
            kind = ("std", "dense", "highmem")[i % 3] if hetero else None
            res = {"CPU": (64.0, 128.0, 32.0)[i % 3], "memory": (256.0, 512.0, 1024.0)[i % 3]}
            view.add_node(f"n{i}", res, node_type=None if kind == "std" else kind)
        out.append((vocab, view))
    return out


@pytest.mark.parametrize("multi", [False, True], ids=["defaults", "multi-objective"])
def test_rounds_match_the_reference_state(monkeypatch, multi):
    """The port's state and the reference's, fed the same view and demand
    stream (sim.py's mix: 0.25 CPU, 0.5 CPU + 1 memory, 1 CPU, some 16 CPU
    + 64 memory), place identically round after round, with preemption
    and explain armed."""
    if multi:
        for k, v in (("HET", "0.5"), ("FRAG", "1.0"), ("STARVE", "1.0")):
            monkeypatch.setenv(f"RAY_TPU_SCHED_W_{k}", v)
    (tv, tview), (jv, jview) = _pair_views(48, hetero=multi)
    ts, js = cpu_state(), JD.DeviceSchedulerState(platform="cpu")
    rng = np.random.default_rng(11)
    shapes = ({"CPU": 0.25}, {"CPU": 0.5, "memory": 1.0}, {"CPU": 1.0},
              {"CPU": 16.0, "memory": 64.0})
    for rnd in range(6):
        ts.sync(tview)
        js.sync(jview)
        kinds = rng.choice(4, 300, p=[0.6, 0.15, 0.15, 0.1])
        dem = np.stack([dense(tv, tview, shapes[k]) for k in kinds])
        from ray_tpu.scheduler.hybrid import dedupe_shapes

        sd, sid = dedupe_shapes(dem)
        ages = np.linspace(0.0, 1.5, sd.shape[0]).astype(np.float32)
        pt = ts.schedule_async(shapes=(sd, sid), ages=ages)
        pj = js.schedule_async(shapes=(sd, sid), ages=ages)
        rows_t, rows_j = pt.result(), pj.result()
        np.testing.assert_array_equal(rows_j, rows_t)
        np.testing.assert_array_equal(pj.preempt_rows(), pt.preempt_rows())
        np.testing.assert_allclose(pt.terms_rows(), pj.terms_rows(), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(js._avail), ts._avail.numpy())
        ok = rows_t >= 0
        for view in (tview, jview):  # what the head's fan-out does
            view.subtract_many(rows_t[ok], dem[ok])
            view.update_available(f"n{rnd}", {"CPU": 8.0, "memory": 64.0})


def test_mirror_equivalence_randomized_stream():
    """Joins, deaths, grants, returns and pushes: after every sync the
    resident avail equals the host mirror bit for bit, through both the
    full-upload and the dirty-row path."""
    rng = np.random.default_rng(1234)
    vocab, view = make_view(4, cpu=16.0)
    st = cpu_state()
    st.sync(view)
    full = delta = 0
    for step in range(120):
        op = rng.choice(["grant", "return", "join", "death", "noop"],
                        p=[0.45, 0.25, 0.08, 0.07, 0.15])
        d = np.zeros(view.totals.shape[1], dtype=np.float32)
        if op == "grant":
            d[0] = float(rng.choice([0.25, 0.5, 1.0]))
            if rng.random() < 0.5:
                view.subtract(int(rng.integers(0, view.num_nodes)), d)
            else:
                k = int(rng.integers(1, 4))
                view.subtract_many(rng.integers(0, view.num_nodes, k),
                                   np.broadcast_to(d, (k, d.shape[0])).copy())
        elif op == "return":
            d[0] = 0.25
            view.add(int(rng.integers(0, view.num_nodes)), d)
        elif op == "join":
            view.add_node(f"extra{step}", {"CPU": 8.0, "memory": 32.0})
        elif op == "death":
            nid = f"node{int(rng.integers(0, 4))}"
            if view.alive[view.row_of(nid)]:
                view.remove_node(nid)
            else:
                view.add_node(nid, {"CPU": 16.0, "memory": 64.0})
        f0, d0 = st.stats["full_syncs"], st.stats["delta_pushes"]
        st.sync(view)
        full += st.stats["full_syncs"] - f0
        delta += st.stats["delta_pushes"] - d0
        np.testing.assert_array_equal(st._avail.numpy(), view.avail, err_msg=f"step {step}")
        assert not view.dirty_rows
    assert full >= 1 and delta >= 10


def test_duplicate_index_scatter_is_deterministic():
    """pad_scatter repeats row 0 with its own values, so the bucket-padded
    index_copy writes one row several times with identical values: the
    result is the same whichever duplicate lands last."""
    rows, vals = pad_scatter(np.asarray([5, 2, 7], np.int64),
                             np.arange(3 * 4, dtype=np.float32).reshape(3, 4))
    assert rows.tolist() == [5, 2, 7, 5] and (vals[3] == vals[0]).all()
    st = cpu_state()
    base = torch.zeros((8, 4))
    out = st._scatter_push(base, np.asarray([5, 2, 7], np.int64),
                           np.arange(12, dtype=np.float32).reshape(3, 4))
    want = np.zeros((8, 4), np.float32)
    want[[5, 2, 7]] = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(out.numpy(), want)
    assert base.abs().sum() == 0  # a new buffer, as the reference's push returns


def test_async_round_deductions_visible_before_readback():
    vocab, view = make_view(2, cpu=1.0)
    st = cpu_state()
    st.sync(view)
    d = np.zeros(view.totals.shape[1], dtype=np.float32)
    d[0] = 1.0
    p1 = st.schedule_async(np.stack([d, d]))
    p2 = st.schedule_async(np.stack([d]))
    assert p2.result().tolist() == [-1]
    assert sorted(p1.result().tolist()) == [0, 1]
    with pytest.raises(RuntimeError, match="consumed twice"):
        p1.result()


def test_pipeline_backpressure_flush_and_order():
    done = []
    gate = threading.Event()

    class FakeRound:
        def __init__(self, i):
            self.ctx = i
            self.dispatched_at = time.perf_counter()

        def result(self):
            assert gate.wait(timeout=60.0)
            return np.array([self.ctx])

    pipe = SchedulerPipeline(on_complete=lambda ctx, rows, ms: done.append(ctx), depth=2)
    try:
        pipe.submit(FakeRound(0))
        pipe.submit(FakeRound(1))
        unblocked = threading.Event()

        def third():
            pipe.submit(FakeRound(2))
            unblocked.set()

        t = threading.Thread(target=third, daemon=True)
        t.start()
        time.sleep(0.2)
        assert not unblocked.is_set()
        gate.set()
        assert pipe.flush(timeout=10.0)
        t.join(timeout=5.0)
        assert done == [0, 1, 2] and pipe.stats()["completed"] == 3
    finally:
        pipe.stop()


def test_pipeline_error_reports_and_survives():
    errors, done = [], []

    class Boom:
        ctx = "boom"
        dispatched_at = 0.0

        def result(self):
            raise RuntimeError("kernel died")

    class Ok:
        ctx = "ok"
        dispatched_at = 0.0

        def result(self):
            return np.array([1])

    pipe = SchedulerPipeline(on_complete=lambda ctx, rows, ms: done.append(ctx),
                             on_error=lambda ctx, exc: errors.append((ctx, str(exc))), depth=2)
    try:
        pipe.submit(Boom())
        pipe.submit(Ok())
        assert pipe.flush(timeout=10.0)
        assert errors == [("boom", "kernel died")] and done == ["ok"]
    finally:
        pipe.stop()


def test_pipelined_rounds_place_like_synchronous_rounds():
    """The same demand stream through SchedulerPipeline (depth 3) and
    through schedule(): every request lands on the same node."""
    rng = np.random.default_rng(3)
    batches = [rng.choice([0.25, 0.5, 1.0], 64) for _ in range(8)]

    def run(pipelined):
        vocab, view = make_view(16, cpu=8.0)
        st = cpu_state()
        st.sync(view)
        out = []
        pipe = SchedulerPipeline(on_complete=lambda ctx, rows, ms: out.append((ctx, rows)),
                                 depth=3) if pipelined else None
        try:
            for i, cpus in enumerate(batches):
                dem = np.zeros((64, view.totals.shape[1]), np.float32)
                dem[:, 0] = cpus
                if pipelined:
                    pipe.submit(st.schedule_async(dem, ctx=i))
                else:
                    out.append((i, st.schedule(dem)))
            if pipelined:
                assert pipe.flush(timeout=30.0)
        finally:
            if pipe is not None:
                pipe.stop()
        return out

    sync, piped = run(False), run(True)
    assert [c for c, _ in piped] == list(range(8))
    for (_, a), (_, b) in zip(sync, piped):
        np.testing.assert_array_equal(a, b)


def test_ring_park_schedule_drop_against_the_reference():
    outs = []
    for cls, state in (((ResourceVocab, ClusterView), cpu_state),
                       ((JResourceVocab, JClusterView),
                        lambda: JD.DeviceSchedulerState(platform="cpu"))):
        vocab, view = make_view(3, cpu=2.0, cls=cls)
        st = state()
        st.sync(view)
        d = np.zeros(view.totals.shape[1], dtype=np.float32)
        d[0] = 1.0
        d2 = d.copy()
        d2[0] = 0.5
        assert st.ring_park((("CPU", 1.0),), d) and st.ring_park((("CPU", 1.0),), d)
        assert st.ring_park((("CPU", 0.5),), d2)
        assert st.ring_occupancy() == 2
        slot, slot2 = st.ring_slot_of((("CPU", 1.0),)), st.ring_slot_of((("CPU", 0.5),))
        placed, per_node, pre = st.ring_schedule({slot: 4, slot2: 10}, ages_by_slot={slot2: 2.0})
        outs.append((np.asarray(placed), np.asarray(per_node), np.asarray(pre),
                     np.asarray(st._avail)))
        st.ring_drop((("CPU", 1.0),))
        assert st.ring_occupancy() == 1 and st.ring_slot_of((("CPU", 1.0),)) is None
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert outs[0][0].sum() > 0
    assert (outs[0][3][:3, 0] >= -1e-5).all()  # 3 nodes x 2 CPU, never over-committed


def test_ring_full_falls_back():
    os.environ["RAY_TPU_SCHED_RING_SLOTS"] = "1"
    try:
        vocab, view = make_view(1, cpu=4.0)
        st = cpu_state()
        st.sync(view)
        d = np.zeros(view.totals.shape[1], dtype=np.float32)
        d[0] = 1.0
        assert st.ring_park((("CPU", 1.0),), d)
        d2 = d.copy()
        d2[0] = 2.0
        assert not st.ring_park((("CPU", 2.0),), d2)
    finally:
        os.environ.pop("RAY_TPU_SCHED_RING_SLOTS", None)


def test_shape_slots_matches_host_scan():
    vocab, view = make_view(3, cpu=4.0, mem=8.0)
    st = cpu_state()
    view.subtract(0, np.asarray([2.0] + [0.0] * (view.totals.shape[1] - 1), np.float32))
    st.sync(view)
    shapes = np.zeros((4, view.totals.shape[1]), dtype=np.float32)
    shapes[0, 0] = 1.0
    shapes[1, 0], shapes[1, 1] = 2.0, 4.0
    shapes[2, 0] = 8.0
    got = st.shape_slots(shapes)
    assert got[3] == 2**31 - 1  # zero-demand: "huge"
    for i in range(3):
        d = shapes[i]
        cols = d > 0
        slots = np.floor(view.avail[:, cols] / d[cols][None, :]).min(axis=1)
        slots = np.where(view.alive, np.maximum(slots, 0.0), 0.0)
        feas = (view.totals >= d[None, :] - 1e-6).all(axis=1)
        assert int(got[i]) == int((slots * feas).sum())


class _Spec:
    def __init__(self, res):
        self.resources = res


def _unpark_common(vocab):
    return dict(is_constrained=lambda s: False, resources_of=lambda s: s.resources,
                request_of=lambda s: ResourceRequest.from_map(vocab, s.resources), slack=8)


def test_select_unparkable_device_estimator_agrees_with_host():
    vocab, view = make_view(2, cpu=2.0)
    st = cpu_state()
    st.sync(view)
    parked = [_Spec({"CPU": 1.0}) for _ in range(100)]
    common = _unpark_common(vocab)
    take_h, keep_h = select_unparkable(parked, view.avail.copy(), view.alive.copy(), **common)
    take_d, keep_d = select_unparkable(parked, view.avail, view.alive, slots_fn=st.shape_slots,
                                       **common)
    assert len(take_d) == len(take_h) == 12 and len(keep_d) == len(keep_h)


def test_select_unparkable_device_estimator_failure_raises():
    """A failing device estimator raises: no host scan stands in for it."""
    vocab, view = make_view(2, cpu=2.0)
    st = cpu_state()
    st.sync(view)
    parked = [_Spec({"CPU": 1.0}) for _ in range(100)]

    def broken(mat):
        raise RuntimeError("estimator died")

    with pytest.raises(RuntimeError, match="estimator died"):
        select_unparkable(parked, view.avail, view.alive, slots_fn=broken,
                          **_unpark_common(vocab))


def test_delta_binpacker_matches_direct_pack():
    from ray_tpu.scheduler.binpack import DeltaBinPacker as JPacker

    rng = np.random.default_rng(3)
    packer, ref = DeltaBinPacker(device="cpu"), JPacker()
    ids = [f"n{i}" for i in range(6)]
    rows = rng.uniform(1.0, 8.0, (6, 4)).astype(np.float32)
    for _ in range(6):
        for j in rng.integers(0, 6, 2):
            rows[j] = rng.uniform(1.0, 8.0, 4).astype(np.float32)
        demands = rng.uniform(0.5, 3.0, (5, 4)).astype(np.float32)
        got = packer.pack(ids, rows, demands)
        np.testing.assert_array_equal(got, bin_pack_residual(rows, demands, device="cpu").node.numpy())
        np.testing.assert_array_equal(got, ref.pack(ids, rows, demands))
    ids2 = ids + ["n6"]
    rows2 = np.vstack([rows, rng.uniform(1.0, 8.0, (1, 4))]).astype(np.float32)
    demands = rng.uniform(0.5, 3.0, (5, 4)).astype(np.float32)
    np.testing.assert_array_equal(packer.pack(ids2, rows2, demands),
                                  bin_pack_residual(rows2, demands, device="cpu").node.numpy())


def test_elastic_pack_solve_and_prewarm(monkeypatch):
    rng = np.random.default_rng(2)
    avail = rng.integers(1, 9, (5, 4)).astype(np.float32)
    shapes = np.asarray([[1, 1, 0, 0], [2, 0, 0, 0]], np.float32)
    counts = np.asarray([6, 3], np.float32)
    from ray_tpu.scheduler.device import elastic_pack_solve as jsolve

    pj, nj = jsolve(avail, shapes, counts)
    pt, nt = TD.elastic_pack_solve(avail, shapes, counts, device="cpu")
    np.testing.assert_array_equal(pj, pt)
    assert nt.shape == (2, 5) and (nt.sum(axis=1) == pt).all()
    monkeypatch.setenv("RAY_TPU_SCHED_PREWARM", "1")
    st = cpu_state()
    st.prewarm(8, 4)
    st._prewarm_thread.join(timeout=120)
    assert st.stats["prewarmed"] >= 4


# -- tests/test_resource_units.py and the metrics the state reports ---------


def test_fixed_point_exact_for_bytes_values():
    gib = 2**30
    assert to_fp(gib) == gib * FP_SCALE and from_fp(to_fp(gib)) == gib
    q = to_fp(gib / 4)
    assert 4 * q == to_fp(gib)
    assert to_fp(gib) + 1 == to_fp(gib + 0.0001)


def test_view_precision_warning_once(caplog):
    from ray_tpu_torch.scheduler import resources as res

    res._warned_view_precision.discard("memory")
    v = ClusterView(ResourceVocab())
    with caplog.at_level(logging.WARNING, logger="ray_tpu.scheduler"):
        v.add_node("n1", {"CPU": 4.0, "memory": float(2**30)})
        v.add_node("n2", {"CPU": 4.0, "memory": float(2**30)})
    assert len([r for r in caplog.records if "MAX_EXACT_VIEW_TOTAL" in r.message]) == 1
    assert MAX_EXACT_VIEW_TOTAL == pytest.approx((1 << 24) / 10_000)


def test_ledger_admits_to_the_last_quantum():
    from ray_tpu_torch.scheduler.resources import make_ledger

    vocab = ResourceVocab()
    ledger = make_ledger(vocab, {"CPU": 4.0, "memory": float(2**30)})
    quarter = ResourceRequest.from_map(vocab, {"memory": 2**30 / 4})
    assert all(ledger.try_allocate(quarter) for _ in range(4))
    assert not ledger.try_allocate(ResourceRequest.from_map(vocab, {"memory": 0.0001}))
    ledger.release(quarter)
    assert ledger.try_allocate(ResourceRequest.from_map(vocab, {"memory": 0.0001}))


def test_round_histograms_record_each_round():
    before = {h.name: h.summary()["count"] for h in
              (TD.SCHED_UPLOAD_MS, TD.SCHED_KERNEL_MS, TD.SCHED_READBACK_MS)}
    vocab, view = make_view(2)
    st = cpu_state()
    st.sync(view)
    st.schedule(np.stack([dense(vocab, view, {"CPU": 1.0})]))
    for h in (TD.SCHED_UPLOAD_MS, TD.SCHED_KERNEL_MS, TD.SCHED_READBACK_MS):
        assert h.summary()["count"] >= before[h.name] + 1
