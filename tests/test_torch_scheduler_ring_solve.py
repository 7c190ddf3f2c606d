"""Two scheduler programs on the head's path, held on the CPU.

- The parked-demand ring walks only the slots that hold demand
  (``ring_schedule_impl(..., slots=...)``). Every output must be bit-equal
  to the walk over all 64 slots, at 0, 1, 7 and 64 occupied slots, with
  preemption on and off and under the fragmentation weight (whose
  reference shape spans every occupied slot); and equal to the JAX ring
  at one occupancy.
- ``solve_pack_counts`` above 32 nodes, where the port's node sums take a
  pairwise tree: the same seeded inputs through the JAX program on host
  XLA and the port, at 64, 256 and 1,024 nodes. ``per_node`` and
  ``placed`` must be equal, the residual within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.scheduler import binpack as JP
from ray_tpu.scheduler import hybrid as J
from ray_tpu_torch.scheduler import binpack as TP
from ray_tpu_torch.scheduler import hybrid as T
from ray_tpu_torch.scheduler.resources import CPU, MEMORY, OBJECT_STORE_MEMORY

R = 16
SLOTS = 64
WEIGHTS = {"util": T.ScoreWeights(), "multi": T.ScoreWeights(1.0, 0.5, 1.0, 1.0)}


def _ring_inputs(seed, occupied):
    """A tight 40-node cluster and a 64-slot ring: ``occupied`` slots hold
    a shape and a count; of the rest, half keep a parked shape with no
    count and half are zero rows (dropped slots)."""
    rng = np.random.default_rng(seed)
    n = 40
    totals = np.zeros((n, R), np.float32)
    totals[:, CPU] = rng.integers(2, 17, n)
    totals[:, MEMORY] = rng.integers(8, 65, n)
    totals[:, OBJECT_STORE_MEMORY] = 16
    avail = totals.copy()
    avail[:, :2] = np.round(totals[:, :2] * rng.uniform(0.1, 0.8, (n, 2)) * 64) / 64
    alive = rng.random(n) >= 0.1
    ntypes = (np.arange(n) % 3).astype(np.int32)
    thr = np.ones((4, R), np.float32)
    thr[1, CPU] = 2.0
    thr[2, MEMORY] = 0.5
    ring = np.zeros((SLOTS, R), np.float32)
    ring[:, CPU] = rng.choice([0.25, 0.5, 1.0, 2.0, 4.0, 8.0], SLOTS)
    ring[::3, MEMORY] = rng.choice([1.0, 4.0], len(ring[::3]))
    occ = np.sort(rng.choice(SLOTS, occupied, replace=False))
    counts = np.zeros(SLOTS, np.int32)
    counts[occ] = rng.integers(1, 120, occupied)
    empty = np.setdiff1d(np.arange(SLOTS), occ)
    ring[empty[::2]] = 0.0
    ages = rng.choice([0.0, 0.5, 2.0], SLOTS).astype(np.float32)
    return (totals, avail.astype(np.float32), alive, ntypes, thr, ring, counts, ages), occ


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy().view(np.int32), y.numpy().view(np.int32))


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("preempt", [False, True], ids=["no_preempt", "preempt"])
@pytest.mark.parametrize("occupied", [0, 1, 7, 64])
def test_ring_occupied_walk_equals_full_walk(occupied, preempt, weights):
    args, occ = _ring_inputs(occupied, occupied)
    kw = dict(weights=WEIGHTS[weights], preempt=preempt, device="cpu")
    full = T.ring_schedule_impl(*args, 11, **kw)
    walk = T.ring_schedule_impl(*args, 11, slots=occ.tolist(), **kw)
    _assert_same(full, walk)
    placed, per_node, _, pre = walk
    skipped = np.setdiff1d(np.arange(SLOTS), occ)
    assert (placed.numpy()[skipped] == 0).all()
    assert (per_node.numpy()[skipped] == 0).all()
    assert (pre.numpy()[skipped] == -1).all()
    if occupied:
        assert placed.numpy().sum() > 0
    if preempt and occupied == 64:
        assert (pre.numpy() >= 0).any()  # the tight cluster starves a slot


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
def test_ring_occupied_walk_against_jax(weights):
    args, occ = _ring_inputs(3, 7)
    w = WEIGHTS[weights]
    rj = J.ring_schedule_impl(*(jnp.asarray(a) for a in args), np.uint32(11),
                              weights=J.ScoreWeights(*w), preempt=True)
    rt = T.ring_schedule_impl(*args, 11, weights=w, preempt=True, slots=occ.tolist(),
                              device="cpu")
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32), b.numpy().view(np.int32))


def test_device_ring_schedule_passes_only_occupied_slots(monkeypatch):
    from ray_tpu_torch.scheduler import device as D
    from ray_tpu_torch.scheduler.resources import ClusterView, ResourceVocab

    view = ClusterView(ResourceVocab())
    for i in range(3):
        view.add_node(f"n{i}", {"CPU": 4.0, "memory": 8.0})
    st = D.DeviceSchedulerState(platform="cpu")
    st.sync(view)
    d = np.zeros(view.totals.shape[1], np.float32)
    d[CPU] = 1.0
    d2 = d.copy()
    d2[CPU] = 2.0
    assert st.ring_park((("CPU", 1.0),), d) and st.ring_park((("CPU", 2.0),), d2)
    s1, s2 = st.ring_slot_of((("CPU", 1.0),)), st.ring_slot_of((("CPU", 2.0),))
    seen = []
    real = T.ring_schedule_impl

    def spy(*a, **kw):
        seen.append(kw["slots"])
        return real(*a, **kw)

    monkeypatch.setattr(T, "ring_schedule_impl", spy)
    placed, per_node, pre = st.ring_schedule({s1: 5, s2: 0})
    assert seen == [[s1]]
    assert int(placed[s1]) == 5 and int(per_node[s1].sum()) == 5
    assert int(placed[s2]) == 0 and (pre == -1).all()


def test_shape_slots_without_pad_rows_equals_padded():
    from ray_tpu_torch.scheduler import device as D
    from ray_tpu_torch.scheduler.resources import ClusterView, ResourceVocab

    view = ClusterView(ResourceVocab())
    for i in range(5):
        view.add_node(f"n{i}", {"CPU": float(2 + i), "memory": 8.0})
    st = D.DeviceSchedulerState(platform="cpu")
    st.sync(view)
    r = view.totals.shape[1]
    for s in (1, 3, 5):
        shapes = np.zeros((s, r), np.float32)
        shapes[:, CPU] = np.arange(1, s + 1) * 0.75
        padded = np.full((D._bucket(s, 1), r), D._BIG, np.float32)
        padded[:s] = shapes
        ref = T.shape_slots_impl(st._totals, st._avail, st._alive, padded).numpy()[:s]
        np.testing.assert_array_equal(st.shape_slots(shapes), ref.astype(np.int64))
    assert st.shape_slots(np.zeros((0, r), np.float32)).shape == (0,)


def _solve_inputs(seed, quant, n):
    """``tests/test_torch_scheduler_multi.py``'s solve inputs (same seeds,
    quantisation and draw order) at ``n`` nodes."""
    rng = np.random.default_rng(seed)
    totals = np.zeros((n, R), np.float32)
    totals[:, 0] = rng.integers(2, 17, n)
    totals[:, 1] = rng.integers(4, 33, n)
    totals[:5, 3] = 2
    if seed % 2:
        totals[:] = totals[0]
    rows = (np.round(totals * rng.uniform(0.3, 1, (n, 1)) * quant) / quant).astype(np.float32)
    rng.random(n)
    dem = np.zeros((12, R), np.float32)
    dem[:, 0] = np.round(rng.uniform(0.2, 3, 12) * quant) / quant
    dem[::3, 1] = 2
    dem[::5, 3] = 1
    shapes = np.unique(dem, axis=0)
    shapes = shapes[JP.sort_demands(shapes)]
    counts = rng.integers(1, 40, shapes.shape[0]).astype(np.float32)
    return rows, shapes, counts


@pytest.mark.parametrize("quant", [64, 10_000], ids=["q64", "q1e-4"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7])
@pytest.mark.parametrize("n", [64, 256, 1024])
def test_solve_pack_counts_above_32_nodes_against_jax(n, seed, quant):
    rows, shapes, counts = _solve_inputs(seed, quant, n)
    rj = JP.solve_pack_counts(rows, shapes, counts, iters=24)
    rt = TP.solve_pack_counts(rows, shapes, counts, iters=24, device="cpu")
    np.testing.assert_array_equal(np.asarray(rj.per_node), rt.per_node.numpy())
    np.testing.assert_array_equal(np.asarray(rj.placed), rt.placed.numpy())
    np.testing.assert_allclose(rt.avail_out.numpy(), np.asarray(rj.avail_out), rtol=0, atol=1e-5)
    assert rt.placed.numpy().sum() > 0
