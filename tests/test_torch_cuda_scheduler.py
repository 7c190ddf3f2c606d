"""The port's scheduler programs on the card against the same programs on
the CPU: every output bit-identical.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor ray_tpu, so it runs where only the port's dependencies
are installed; there, skip the jax-importing tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_scheduler.py
"""
import numpy as np
import pytest
import torch

from ray_tpu_torch.scheduler import binpack as TP
from ray_tpu_torch.scheduler import bundles as TB
from ray_tpu_torch.scheduler import hybrid as T
from ray_tpu_torch.scheduler.device import DeviceSchedulerState
from ray_tpu_torch.scheduler.resources import ClusterView, ResourceVocab

pytestmark = pytest.mark.cuda
R = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def test_duplicate_index_scatter_and_stable_sort_on_cuda(cuda):
    """index_copy with pad_scatter's duplicates (one row, identical values)
    gives the CPU's result, and a stable argsort of all-tied keys keeps
    index order, on the card as on the CPU."""
    st = DeviceSchedulerState(platform="cuda")
    rows = np.asarray([9, 3, 0, 7, 12], np.int64)
    vals = np.random.default_rng(0).random((5, R)).astype(np.float32)
    base = torch.zeros((16, R))
    for _ in range(20):
        got = st._scatter_push(base.to(cuda), rows, vals)
        want = DeviceSchedulerState(platform="cpu")._scatter_push(base, rows, vals)
        assert _equal(got, want)
    keys = torch.tensor([2.0, 1.0, 1.0, 2.0] * 4096)
    for x in (keys, torch.zeros(50_000)):
        assert torch.equal(T._stable_argsort(x.to(cuda)).cpu(), T._stable_argsort(x))
    ones = torch.ones(100_000, device=cuda)
    idx = torch.randint(0, 7, (100_000,), device=cuda)
    counts = torch.zeros(8, device=cuda).index_add_(0, idx, ones)
    assert torch.equal(counts.cpu(), torch.bincount(idx.cpu(), minlength=8).float())


def _cluster(seed, n, identical=False):
    rng = np.random.default_rng(seed)
    totals = np.zeros((n, R), np.float32)
    totals[:, 0] = rng.integers(4, 65, n)
    totals[:, 1] = rng.integers(16, 257, n)
    totals[:, 2] = 64
    totals[: n // 4, 4] = 4
    if identical:
        totals[:] = totals[0]
    avail = totals.copy()
    avail[:, :3] = totals[:, :3] * rng.uniform(0.3, 1.0, (n, 3))  # not quantized
    return totals, avail.astype(np.float32), rng.random(n) > 0.05


def _demands(seed, b):
    rng = np.random.default_rng(seed + 1)
    base = np.zeros((6, R), np.float32)
    base[:, 0] = rng.uniform(0.1, 3.0, 6)
    base[1, 1] = 1.0
    base[5, 4] = 1.0
    return base[rng.integers(0, 6, b)]


@pytest.mark.parametrize("identical", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_programs_card_equals_cpu(cuda, seed, identical):
    totals, avail, alive = _cluster(seed, 512, identical)
    dem = _demands(seed, 4000)
    sd, sid = T.dedupe_shapes(dem)
    ntypes = (np.arange(512) % 3).astype(np.int32)
    thr = np.ones((4, R), np.float32)
    thr[1, 0], thr[2, 1] = 1.3, 0.7
    ages = np.linspace(0, 2, sd.shape[0]).astype(np.float32)
    for w in (T.ScoreWeights(), T.ScoreWeights(1.0, 0.5, 2.0, 1.0)):
        outs = [T.hybrid_schedule_shapes_multi_impl(
            totals, avail, alive, ntypes, thr, sd, sid, ages, seed, weights=w, preempt=True,
            explain=True, device=dev) for dev in (cuda, "cpu")]
        for a, b in zip(*outs):
            assert _equal(a, b)
    outs = [T.hybrid_schedule_rounds(totals, avail, alive, dem[:512], seed, rounds=4, device=d)
            for d in (cuda, "cpu")]
    for a, b in zip(*outs):
        assert _equal(a, b)
    pref = np.zeros(64, np.int32)
    spill = np.zeros(64, bool)
    outs = [T.hybrid_schedule_batch(totals, avail, alive, dem[:64], pref, spill, seed,
                                    device=d) for d in (cuda, "cpu")]
    for a, b in zip(*outs):
        assert _equal(a, b)
    counts = np.arange(sd.shape[0], dtype=np.int32) * 50
    outs = [T.ring_schedule_impl(totals, avail, alive, ntypes, thr, sd, counts, ages, seed,
                                 weights=T.ScoreWeights(1.0, 0.5, 1.0, 1.0), preempt=True,
                                 device=d) for d in (cuda, "cpu")]
    for a, b in zip(*outs):
        assert _equal(a, b)
    assert _equal(T.shape_slots_impl(totals, avail, alive, sd, device=cuda),
                  T.shape_slots_impl(totals, avail, alive, sd, device="cpu"))
    bund = dem[:32][TB.sort_bundles(dem[:32])]
    for fn in (TB.pack_bundles, TB.strict_pack_bundles,
               lambda *a, **k: TB.spread_bundles(*a, strict=True, **k)):
        for a, b in zip(*[fn(totals, avail, alive, bund, device=d) for d in (cuda, "cpu")]):
            assert _equal(a, b)
    counts_f = np.arange(1, sd.shape[0] + 1, dtype=np.float32) * 20
    for a, b in zip(*[TP.solve_pack_counts(avail, sd, counts_f, iters=24, device=d)
                      for d in (cuda, "cpu")]):
        assert _equal(a, b)


def test_rounds_dispatch_without_a_host_sync(cuda):
    """A round's program reads nothing back to the host: under
    torch.cuda.set_sync_debug_mode("error") schedule_async dispatches, and
    result() returns the CPU state's placements."""
    states = []
    for platform in ("cuda", "cpu"):
        view = ClusterView(ResourceVocab())
        for i in range(64):
            view.add_node(f"n{i}", {"CPU": 8.0, "memory": 32.0})
        st = DeviceSchedulerState(platform=platform)
        st.sync(view)
        states.append(st)
    dem = np.zeros((600, states[0]._totals.shape[1]), np.float32)
    dem[:, 0] = np.random.default_rng(4).choice([0.25, 0.5, 1.0], 600)
    dem[::5, 1] = 1.0
    states[0].schedule(dem)  # first touch outside the check
    states[1].schedule(dem)
    ages = np.ones(T.dedupe_shapes(dem)[0].shape[0], np.float32)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [states[0].schedule_async(dem, ages=ages) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = [states[1].schedule_async(dem, ages=ages) for _ in range(3)]
    for p, q in zip(pending, want):
        np.testing.assert_array_equal(p.result(), q.result())
        np.testing.assert_array_equal(p.preempt_rows(), q.preempt_rows())
