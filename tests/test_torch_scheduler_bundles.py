"""ray_tpu_torch.scheduler.bundles and binpack against the JAX programs on
the CPU, mirroring ``tests/test_scheduler_bundles.py``: PACK, SPREAD,
STRICT_SPREAD and STRICT_PACK, first-fit residual packing and the node-type
scorer. Placements, success flags and type scores are bit-identical; so is
``avail_out`` on inputs that are multiples of 1/64, and within 1e-5 on
inputs quantized at 1e-4."""
import numpy as np
import pytest
import torch

from ray_tpu.scheduler import binpack as JP
from ray_tpu.scheduler import bundles as JB
from ray_tpu_torch.scheduler import binpack as TP
from ray_tpu_torch.scheduler import bundles as TB
from ray_tpu_torch.scheduler.resources import CPU, GPU, MEMORY

R = 16


def cluster(seed, quant, n=30):
    rng = np.random.default_rng(seed)
    totals = np.zeros((n, R), np.float32)
    totals[:, CPU] = rng.integers(2, 17, n)
    totals[:, MEMORY] = rng.integers(4, 33, n)
    totals[:5, GPU] = 2
    if seed % 2:  # every node alike: LeastResourceScorer ties everywhere
        totals[:] = totals[0]
    avail = (np.round(totals * rng.uniform(0.3, 1, (n, 1)) * quant) / quant).astype(np.float32)
    alive = rng.random(n) > 0.1
    bund = np.zeros((12, R), np.float32)
    bund[:, CPU] = np.round(rng.uniform(0.2, 3, 12) * quant) / quant
    bund[::3, MEMORY] = 2
    bund[::5, GPU] = 1
    return totals, avail, alive, bund


def assert_avail(a, b, quant):
    a, b = np.asarray(a), b.numpy()
    if quant == 64:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


PROGRAMS = {
    "pack": (JB.pack_bundles, TB.pack_bundles),
    "spread": (lambda *a: JB.spread_bundles(*a, strict=False),
               lambda *a, **k: TB.spread_bundles(*a, strict=False, **k)),
    "strict_spread": (lambda *a: JB.spread_bundles(*a, strict=True),
                      lambda *a, **k: TB.spread_bundles(*a, strict=True, **k)),
    "strict_pack": (JB.strict_pack_bundles, TB.strict_pack_bundles),
}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
@pytest.mark.parametrize("quant", [64, 10_000], ids=["q64", "q1e-4"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bundle_programs_match_jax(seed, quant, program):
    totals, avail, alive, bund = cluster(seed, quant)
    sb = bund[JB.sort_bundles(bund)]
    fj, ft = PROGRAMS[program]
    rj = fj(totals, avail, alive, sb)
    rt = ft(totals, avail, alive, sb, device="cpu")
    np.testing.assert_array_equal(np.asarray(rj.node), rt.node.numpy())
    assert bool(rj.success) == bool(rt.success)
    assert_avail(rj.avail_out, rt.avail_out, quant)


@pytest.mark.parametrize("strategy", ["PACK", "SPREAD", "STRICT_SPREAD", "STRICT_PACK"])
@pytest.mark.parametrize("seed", [0, 1])
def test_schedule_bundles_host_entry_matches_jax(seed, strategy):
    totals, avail, alive, bund = cluster(seed, 64)
    avoid = [0, 3, None, 99]
    a = JB.schedule_bundles(totals, avail, alive, bund, strategy)
    b = TB.schedule_bundles(totals, avail, alive, bund, strategy, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]
    a = JB.schedule_bundles_soft_avoid(totals, avail, alive, bund, strategy, avoid)
    b = TB.schedule_bundles_soft_avoid(totals, avail, alive, bund, strategy, avoid, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]


# -- the semantic cases of tests/test_scheduler_bundles.py, on the port ------


def mk_nodes(specs):
    totals = np.zeros((len(specs), R), np.float32)
    for i, s in enumerate(specs):
        for col, q in s.items():
            totals[i, col] = q
    return totals, totals.copy(), np.ones(len(specs), bool)


def bundle(cpu=0.0, gpu=0.0, mem=0.0):
    d = np.zeros(R, np.float32)
    d[CPU], d[GPU], d[MEMORY] = cpu, gpu, mem
    return d


def sched(totals, avail, alive, bundles, strategy):
    return TB.schedule_bundles(totals, avail, alive, np.stack(bundles), strategy, device="cpu")


def test_bundle_semantics_of_the_reference_suite():
    order = TB.sort_bundles(np.stack([bundle(cpu=4), bundle(gpu=1), bundle(cpu=1, mem=10),
                                      bundle(gpu=2)]))
    assert list(order) == [3, 1, 2, 0]
    totals, avail, alive = mk_nodes([{CPU: 4}, {CPU: 4}])
    nodes, ok, _ = sched(totals, avail, alive, [bundle(cpu=1)] * 3, "PACK")
    assert ok and len(set(nodes.tolist())) == 1  # fills one node first
    nodes, ok, _ = sched(totals, avail, alive, [bundle(cpu=2)] * 3, "PACK")
    assert ok and sorted(np.bincount(nodes).tolist()) == [1, 2]  # overflows to a second
    _, ok, _ = sched(totals, avail, alive, [bundle(cpu=3)] * 3, "PACK")
    assert not ok
    nodes, ok, out = sched(totals, avail, alive, [bundle(cpu=2), bundle(cpu=1)], "STRICT_PACK")
    assert ok and nodes[0] == nodes[1]
    assert torch.as_tensor(out)[:, CPU].sum().item() == 5.0
    _, ok, _ = sched(totals, avail, alive, [bundle(cpu=3)] * 2, "STRICT_PACK")
    assert not ok
    nodes, ok, _ = sched(totals, avail, alive, [bundle(cpu=1)] * 3, "SPREAD")
    assert ok and len(set(nodes[:2].tolist())) == 2  # distinct first, then reuse
    nodes, ok, _ = sched(totals, avail, alive, [bundle(cpu=1)] * 2, "STRICT_SPREAD")
    assert ok and len(set(nodes.tolist())) == 2
    _, ok, _ = sched(totals, avail, alive, [bundle(cpu=1)] * 3, "STRICT_SPREAD")
    assert not ok
    totals, avail, alive = mk_nodes([{CPU: 8}, {CPU: 8, GPU: 2}])
    nodes, ok, _ = sched(totals, avail, alive, [bundle(cpu=1, gpu=1), bundle(cpu=1)], "PACK")
    assert ok and nodes[0] == 1


@pytest.mark.parametrize("strict_spread", [False, True])
@pytest.mark.parametrize("quant", [64, 10_000], ids=["q64", "q1e-4"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_pack_residual_matches_jax(seed, quant, strict_spread):
    _, avail, _, bund = cluster(seed, quant)
    dem = np.concatenate([bund, bund[::2]])
    dem = dem[JP.sort_demands(dem)]
    rj = JP.bin_pack_residual(avail, dem, strict_spread=strict_spread)
    rt = TP.bin_pack_residual(avail, dem, strict_spread=strict_spread, device="cpu")
    np.testing.assert_array_equal(np.asarray(rj.node), rt.node.numpy())
    assert_avail(rj.avail_out, rt.avail_out, quant)


@pytest.mark.parametrize("conserve", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_utilization_scores_match_jax(seed, conserve):
    totals, _, _, bund = cluster(seed, 64)
    types = np.concatenate([totals[:4], totals[-2:]])
    dem = bund[JP.sort_demands(bund)]
    sj = JP.utilization_scores(types, dem, conserve_accel_nodes=conserve)
    st = TP.utilization_scores(types, dem, conserve_accel_nodes=conserve, device="cpu")
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert JP.pick_best_node_type(sj) == TP.pick_best_node_type(st)


def test_binpack_semantics_of_the_reference_suite():
    nodes_avail = np.zeros((2, R), np.float32)
    nodes_avail[:, CPU] = 4
    demands = np.zeros((3, R), np.float32)
    demands[:, CPU] = 3
    res = TP.bin_pack_residual(nodes_avail, demands[TP.sort_demands(demands)], device="cpu")
    assert (res.node.numpy() >= 0).sum() == 2
    assert res.avail_out.numpy()[:, CPU].tolist() == [1.0, 1.0]
    nodes_avail[:, CPU] = 8
    demands[:, CPU] = 1
    res = TP.bin_pack_residual(nodes_avail, demands, strict_spread=True, device="cpu")
    assert (res.node.numpy() >= 0).sum() == 2
    demands = np.zeros((3, R), np.float32)
    demands[0, CPU] = 8
    demands[1, CPU], demands[1, GPU] = 1, 1
    demands[2, CPU] = 2
    assert list(TP.sort_demands(demands)[:2]) == [1, 0]
    types = np.zeros((2, R), np.float32)
    types[0, CPU] = 8
    types[1, CPU], types[1, GPU] = 8, 4
    cpu_dem = np.zeros((4, R), np.float32)
    cpu_dem[:, CPU] = 2
    assert TP.pick_best_node_type(TP.utilization_scores(types, cpu_dem, device="cpu")) == 0
    cpu_dem[:, GPU] = 1
    assert TP.pick_best_node_type(TP.utilization_scores(types, cpu_dem, device="cpu")) == 1
