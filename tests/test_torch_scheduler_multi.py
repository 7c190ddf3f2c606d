"""The multi-objective waterfall, preemption nomination and the
autoscaler's solve on the port, mirroring ``tests/test_multi_objective.py``:
each case runs the JAX program and the port on the same inputs, asserts the
reference's property on the port, and holds integer outputs equal.

``solve_pack_counts`` sums its fractional allocation in XLA's CPU order at
these sizes (30 nodes): the load ``jnp.einsum("un,ur->nr", x, shapes)``
(``ray_tpu/scheduler/binpack.py:162``) as a sequential FMA over the shapes,
the ``ur,nr->un`` gradient as a tree over the resources, and the node sums
node after node. ``SOLVE_DIVERGES`` lists the seeds where the per-node
placements still differ from JAX's; on them the placed counts are equal
and both packings respect every node's capacity.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.scheduler import binpack as JP
from ray_tpu.scheduler import hybrid as J
from ray_tpu_torch.scheduler import binpack as TP
from ray_tpu_torch.scheduler import hybrid as T
from ray_tpu_torch.scheduler.resources import CPU, ClusterView, ResourceVocab


def _mk(rows):
    totals = np.asarray(rows, dtype=np.float32)
    return totals, totals.copy(), np.ones(totals.shape[0], dtype=bool)


def _both(totals, avail, alive, demands, *, weights=J.ScoreWeights(), ntypes=None, thr=None,
          ages=None, preempt=False, seed=0):
    shapes, sids = J.dedupe_shapes(np.asarray(demands, dtype=np.float32))
    n, r = totals.shape
    ntypes = np.zeros(n, np.int32) if ntypes is None else ntypes
    thr = np.ones((1, r), np.float32) if thr is None else thr
    ages = np.zeros(shapes.shape[0], np.float32) if ages is None else np.asarray(ages, np.float32)
    rj = J.hybrid_schedule_shapes_multi_impl(
        jnp.asarray(totals), jnp.asarray(avail), jnp.asarray(alive), jnp.asarray(ntypes),
        jnp.asarray(thr), jnp.asarray(shapes), jnp.asarray(sids), jnp.asarray(ages),
        np.uint32(seed), weights=weights, preempt=preempt)
    rt = T.hybrid_schedule_shapes_multi_impl(
        totals, avail, alive, ntypes, thr, shapes, sids, ages, seed,
        weights=T.ScoreWeights(*weights), preempt=preempt, device="cpu")
    np.testing.assert_array_equal(np.asarray(rj.node), rt.node.numpy())
    np.testing.assert_array_equal(np.asarray(rj.preempt_node), rt.preempt_node.numpy())
    return rt


def test_default_weights_match_single_objective_exactly():
    rng = np.random.default_rng(0)
    totals, avail, alive = _mk(rng.uniform(4, 16, (12, 6)))
    demands = rng.uniform(0.25, 2.0, (40, 6)).astype(np.float32)
    base = _both(totals, avail, alive, demands, seed=7)
    armed = _both(totals, avail, alive, demands, seed=7, preempt=True)
    zeroed = _both(totals, avail, alive, demands, seed=7, weights=J.ScoreWeights(1.0, 0, 0, 0))
    assert torch.equal(base.node, armed.node) and torch.equal(base.node, zeroed.node)
    assert torch.equal(base.avail_out, armed.avail_out)
    assert (armed.preempt_node.numpy() == -1).all()  # unaged shapes never nominate


def test_het_term_prefers_high_throughput_type():
    totals, avail, alive = _mk([[8.0, 8.0]] * 8)
    ntypes = np.asarray([0, 1] * 4, dtype=np.int32)
    thr = np.asarray([[1.0, 1.0], [2.0, 1.0]], dtype=np.float32)
    demands = np.tile(np.asarray([[1.0, 0.0]], dtype=np.float32), (8, 1))
    res = _both(totals, avail, alive, demands, weights=J.ScoreWeights(1.0, 1.0, 0.0, 0.0),
                ntypes=ntypes, thr=thr)
    nodes = res.node.numpy()
    assert (nodes >= 0).all() and set(ntypes[nodes]) == {1}


FRAG = ([[16.0, 16.0], [16.0, 16.0], [4.0, 4.0]], [[16.0, 16.0], [16.0, 16.0], [2.0, 2.0]])


def test_frag_term_protects_large_capable_node():
    totals = np.asarray(FRAG[0], np.float32)
    avail = np.asarray(FRAG[1], np.float32)
    alive = np.ones(3, bool)
    demands = np.asarray([[16.0, 8.0], [1.0, 0.0]], dtype=np.float32)
    plain = _both(totals, avail, alive, demands, seed=1).node.numpy()
    frag = _both(totals, avail, alive, demands, seed=1,
                 weights=J.ScoreWeights(1.0, 0.0, 4.0, 0.0)).node.numpy()
    assert frag[0] in (0, 1) and frag[1] == 2
    assert plain[1] == 1 - plain[0]


def test_starvation_discount_overrides_soft_terms():
    totals = np.asarray(FRAG[0], np.float32)
    avail = np.asarray(FRAG[1], np.float32)
    alive = np.ones(3, bool)
    demands = np.asarray([[16.0, 8.0], [1.0, 0.0]], dtype=np.float32)
    shapes, _ = J.dedupe_shapes(demands)
    ages = np.zeros(shapes.shape[0], np.float32)
    ages[int(np.flatnonzero(shapes[:, 0] < 2.0)[0])] = 4.0
    res = _both(totals, avail, alive, demands, seed=1, ages=ages,
                weights=J.ScoreWeights(1.0, 0.0, 4.0, 8.0))
    assert res.node.numpy()[1] != 2


@pytest.mark.parametrize("age, nominated", [(0.0, False), (1.5, True)])
def test_starving_unmet_shape_nominates_feasible_node(age, nominated):
    totals, _, alive = _mk([[4.0, 4.0], [4.0, 4.0]])
    avail = np.zeros_like(totals)
    res = _both(totals, avail, alive, np.asarray([[4.0, 1.0]], np.float32), ages=[age],
                preempt=True)
    assert res.node.numpy()[0] == -1
    assert (res.preempt_node.numpy()[0] in (0, 1)) == nominated
    assert (res.preempt_node.numpy()[0] == -1) == (not nominated)


def test_ring_kernel_nominates_for_starving_slot():
    totals = np.asarray([[4.0, 4.0]], dtype=np.float32)
    avail = np.zeros_like(totals)
    args = (totals, avail, np.ones(1, bool), np.zeros(1, np.int32), np.ones((1, 2), np.float32),
            np.asarray([[2.0, 1.0]], np.float32), np.asarray([5], np.int32),
            np.asarray([2.0], np.float32))
    rj = J.ring_schedule_impl(*(jnp.asarray(a) for a in args), np.uint32(0), preempt=True)
    rt = T.ring_schedule_impl(*args, 0, preempt=True, device="cpu")
    assert int(rt.placed[0]) == int(rj.placed[0]) == 0
    assert int(rt.preempt_node[0]) == int(rj.preempt_node[0]) == 0


def test_cluster_view_node_types_and_throughput():
    vocab = ResourceVocab()
    view = ClusterView(vocab)
    topo0 = view.topo_version
    assert view.register_node_type("fast", {"CPU": 2.0}) == 1
    assert view.topo_version > topo0
    view.add_node("a", {"CPU": 8.0}, node_type="fast")
    view.add_node("b", {"CPU": 8.0})
    view.add_node("c", {"CPU": 8.0}, labels={ClusterView.NODE_TYPE_LABEL: "fast"})
    ntypes, thr = view.active_type_arrays()
    assert ntypes.tolist() == [1, 0, 1] and thr.shape[0] == 2
    assert thr[1, CPU] == 2.0 and thr[0, CPU] == 1.0
    view.register_node_type("fast", {"CPU": 3.0})
    assert view.active_type_arrays()[1][1, CPU] == 3.0


# -- the autoscaler's projected-gradient solve --------------------------------


def _valid(rows, demands, packed):
    used = np.zeros_like(rows)
    for b, node in enumerate(packed):
        if node >= 0:
            used[node] += demands[b]
    assert (used <= rows + 1e-3).all(), "solver over-committed a node"


def _solve_inputs(seed, quant):
    """30 nodes (R = 16; five with 2 GPUs; every node alike on odd seeds)
    at 30-100% availability, and a dozen bundle-like demands deduped into
    shapes with counts."""
    rng = np.random.default_rng(seed)
    n, r = 30, 16
    totals = np.zeros((n, r), np.float32)
    totals[:, 0] = rng.integers(2, 17, n)
    totals[:, 1] = rng.integers(4, 33, n)
    totals[:5, 3] = 2
    if seed % 2:
        totals[:] = totals[0]
    rows = (np.round(totals * rng.uniform(0.3, 1, (n, 1)) * quant) / quant).astype(np.float32)
    rng.random(n)
    dem = np.zeros((12, r), np.float32)
    dem[:, 0] = np.round(rng.uniform(0.2, 3, 12) * quant) / quant
    dem[::3, 1] = 2
    dem[::5, 3] = 1
    shapes = np.unique(dem, axis=0)
    shapes = shapes[JP.sort_demands(shapes)]
    counts = rng.integers(1, 40, shapes.shape[0]).astype(np.float32)
    return rows, shapes, counts


# (seed, quant) pairs where the per-node placements differ from JAX's
SOLVE_DIVERGES = set()


@pytest.mark.parametrize("quant", [64, 10_000], ids=["q64", "q1e-4"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7])
def test_solve_pack_counts_against_jax(seed, quant):
    rows, shapes, counts = _solve_inputs(seed, quant)
    rj = JP.solve_pack_counts(rows, shapes, counts, iters=24)
    rt = TP.solve_pack_counts(rows, shapes, counts, iters=24, device="cpu")
    np.testing.assert_array_equal(np.asarray(rj.placed), rt.placed.numpy())
    for per_node in (np.asarray(rj.per_node), rt.per_node.numpy()):
        assert (per_node == np.round(per_node)).all()
        used = per_node.T @ shapes
        assert (used <= rows + 1e-4).all()
        np.testing.assert_array_equal(per_node.sum(axis=1), rt.placed.numpy())
    equal = np.array_equal(np.asarray(rj.per_node), rt.per_node.numpy())
    assert equal == ((seed, quant) not in SOLVE_DIVERGES)
    if equal:
        np.testing.assert_allclose(rt.avail_out.numpy(), np.asarray(rj.avail_out), atol=1e-5)


def test_solve_matches_first_fit_on_uniform_demand(monkeypatch):
    monkeypatch.setenv("RAY_TPU_AUTOSCALER_SOLVE_MIN_DEMANDS", "1")
    packer = TP.DeltaBinPacker(device="cpu")
    ids = [f"n{i}" for i in range(5)]
    rows = np.full((5, 4), 4.0, dtype=np.float32)
    demands = np.tile(np.asarray([[1.0, 1.0, 0.0, 0.0]], dtype=np.float32), (30, 1))
    got = packer.pack_or_solve(ids, rows, demands)
    oracle = packer.pack(ids, rows, demands)
    assert (got >= 0).sum() == (oracle >= 0).sum() == 20
    _valid(rows, demands, got)
    ref = JP.DeltaBinPacker()
    np.testing.assert_array_equal(ref.pack_or_solve(ids, rows, demands), got)


def test_solve_validity_and_residual_quality(monkeypatch):
    monkeypatch.setenv("RAY_TPU_AUTOSCALER_SOLVE_MIN_DEMANDS", "1")
    rng = np.random.default_rng(5)
    packer = TP.DeltaBinPacker(device="cpu")
    ids = [f"n{i}" for i in range(8)]
    rows = rng.uniform(2.0, 8.0, (8, 4)).astype(np.float32)
    base = rng.uniform(0.5, 2.0, (4, 4)).astype(np.float32)
    demands = base[rng.integers(0, 4, 60)]
    demands = demands[TP.sort_demands(demands)]
    got = packer.pack_or_solve(ids, rows, demands)
    oracle = packer.pack(ids, rows, demands)
    _valid(rows, demands, got)
    assert (got < 0).sum() <= (oracle < 0).sum() + 3


def test_solve_falls_back_to_first_fit_on_failure(monkeypatch):
    monkeypatch.setenv("RAY_TPU_AUTOSCALER_SOLVE_MIN_DEMANDS", "1")

    def boom(*a, **k):
        raise RuntimeError("solver died")

    monkeypatch.setattr(TP, "solve_pack_counts", boom)
    packer = TP.DeltaBinPacker(device="cpu")
    ids = ["n0", "n1"]
    rows = np.full((2, 4), 4.0, dtype=np.float32)
    demands = np.tile(np.asarray([[1.0, 0.0, 0.0, 0.0]], dtype=np.float32), (10, 1))
    before = TP.SOLVER_FALLBACKS.value()
    got = packer.pack_or_solve(ids, rows, demands)
    assert TP.SOLVER_FALLBACKS.value() == before + 1
    np.testing.assert_array_equal(got, packer.pack(ids, rows, demands))


def test_small_batches_skip_the_solver(monkeypatch):
    monkeypatch.setenv("RAY_TPU_AUTOSCALER_SOLVE_MIN_DEMANDS", "64")
    packer = TP.DeltaBinPacker(device="cpu")
    before = TP.SOLVER_RUNS.value()
    packer.pack_or_solve(["n0"], np.full((1, 4), 4.0, np.float32), np.ones((3, 4), np.float32))
    assert TP.SOLVER_RUNS.value() == before
