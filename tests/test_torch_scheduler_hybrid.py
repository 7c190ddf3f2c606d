"""ray_tpu_torch.scheduler.hybrid against ray_tpu.scheduler.hybrid on the CPU.

The same seeded numpy inputs go through the JAX program and the port.
Integer outputs (placements, grants, preemption nominations, ring counts,
slot estimates) must be bit-identical; ``avail_out`` too on inputs that are
multiples of 1/64, and within 1e-5 (``_EPS``) on inputs quantized at 1e-4,
where XLA's CPU compiler fuses ``avail - count * demand`` into an FMA that
the port's separate ops do not. The semantic cases of
``tests/test_scheduler_hybrid.py`` run on the port as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.scheduler import hybrid as J
from ray_tpu_torch.scheduler import hybrid as T
from ray_tpu_torch.scheduler.resources import CPU, GPU, MEMORY, OBJECT_STORE_MEMORY

R = 16
CPU_DEV = "cpu"


def cluster(seed, n, quant, identical=False, dead=0.0):
    """Nodes with integer totals (a quarter of them with 4 TPUs) and
    availability quantized at 1/quant; ``identical`` makes every node the
    same, so every score ties and the tie order decides."""
    rng = np.random.default_rng(seed)
    totals = np.zeros((n, R), np.float32)
    totals[:, CPU] = rng.integers(4, 65, n)
    totals[:, MEMORY] = rng.integers(16, 257, n)
    totals[:, OBJECT_STORE_MEMORY] = 64
    totals[: n // 4, 4] = 4
    if identical:
        totals[:] = totals[0]
        avail = totals.copy()
    else:
        avail = totals.copy()
        avail[:, :3] = totals[:, :3] * rng.uniform(0.3, 1.0, (n, 3))
        avail = np.round(avail * quant) / quant
    alive = rng.random(n) >= dead
    return totals, avail.astype(np.float32), alive


def demand_mix(seed, b, quant):
    rng = np.random.default_rng(seed + 100)
    base = np.zeros((6, R), np.float32)
    base[:, CPU] = [0.25, 0.5, 1.0, 2.0, 0.125, 3.0]
    base[1, MEMORY] = 1.0
    base[3, MEMORY] = 4.0
    base[5, 4] = 1.0
    if quant != 64:
        base[:, CPU] = np.round(rng.uniform(0.1, 3.0, 6) * quant) / quant
    return base[rng.integers(0, 6, b)].astype(np.float32)


def node_types(n):
    ntypes = (np.arange(n) % 3).astype(np.int32)
    thr = np.ones((4, R), np.float32)
    thr[1, CPU] = 2.0
    thr[2, MEMORY] = 0.5
    return ntypes, thr


def assert_avail(jax_out, port_out, quant):
    a, b = np.asarray(jax_out), port_out.numpy()
    if quant == 64:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


_multi_jit = jax.jit(
    J.hybrid_schedule_shapes_multi_impl,
    static_argnames=("spread_threshold", "weights", "preempt", "explain"),
)
_ring_jit = jax.jit(J.ring_schedule_impl, static_argnames=("spread_threshold", "weights", "preempt"))
_slots_jit = jax.jit(J.shape_slots_impl)

WEIGHTS = [
    pytest.param(J.ScoreWeights(), id="default"),
    pytest.param(J.ScoreWeights(1.0, 0.5, 2.0, 1.0), id="het-frag-starve"),
    pytest.param(J.ScoreWeights(0.5, 0.0, 1.0, 0.0), id="util-frag"),
]


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("identical", [False, True], ids=["mixed", "identical-nodes"])
@pytest.mark.parametrize("quant", [64, 10_000], ids=["q64", "q1e-4"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shapes_multi_matches_jax(seed, quant, identical, weights):
    totals, avail, alive = cluster(seed, 40, quant, identical, dead=0.1)
    dem = demand_mix(seed, 300, quant)
    sd, sid = J.dedupe_shapes(dem)
    ntypes, thr = node_types(40)
    ages = np.linspace(0.0, 2.0, sd.shape[0]).astype(np.float32)
    kw = dict(weights=weights, preempt=True, explain=True)
    rj = _multi_jit(totals, avail, alive, ntypes, thr, sd, sid, ages, np.uint32(seed + 5), **kw)
    rt = T.hybrid_schedule_shapes_multi_impl(
        totals, avail, alive, ntypes, thr, sd, sid, ages, seed + 5,
        weights=T.ScoreWeights(*weights), preempt=True, explain=True, device=CPU_DEV)
    same(rj.node, rt.node)
    same(rj.preempt_node, rt.preempt_node)
    assert_avail(rj.avail_out, rt.avail_out, quant)
    # the attribution terms are floats: to f32 rounding of the same ops
    np.testing.assert_allclose(rt.terms.numpy(), np.asarray(rj.terms), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_explain_and_preempt_place_bit_identically(seed):
    """explain=True and preempt=True leave placements and avail_out as
    they are (the reference's contract, on the port)."""
    totals, avail, alive = cluster(seed, 24, 64)
    sd, sid = J.dedupe_shapes(demand_mix(seed, 200, 64))
    ntypes, thr = node_types(24)
    ages = np.full(sd.shape[0], 1.5, np.float32)
    w = T.ScoreWeights(1.0, 0.5, 1.0, 0.5)
    outs = [T.hybrid_schedule_shapes_multi_impl(totals, avail, alive, ntypes, thr, sd, sid, ages,
                                                seed, weights=w, preempt=p, explain=e,
                                                device=CPU_DEV)
            for p, e in ((False, False), (True, False), (False, True), (True, True))]
    for o in outs[1:]:
        assert torch.equal(o.node, outs[0].node)
        assert torch.equal(o.avail_out, outs[0].avail_out)
    assert outs[0].terms.shape == (1, 5) and outs[2].terms.shape == (sid.shape[0], 5)


def test_default_weights_emit_the_single_objective_program():
    """weights=(1,0,0,0,0) and the single-objective entry point give the
    same placements (the short-circuit emits no extra terms)."""
    totals, avail, alive = cluster(4, 32, 64)
    sd, sid = J.dedupe_shapes(demand_mix(4, 120, 64))
    single = T.hybrid_schedule_shapes(totals, avail, alive, sd, sid, 9, device=CPU_DEV)
    multi = T.hybrid_schedule_shapes_multi_impl(
        totals, avail, alive, np.zeros(32, np.int32), np.ones((1, R), np.float32), sd, sid,
        np.zeros(sd.shape[0], np.float32), 9, weights=T.ScoreWeights(1.0, 0.0, 0.0, 0.0),
        device=CPU_DEV)
    assert torch.equal(single.node, multi.node)
    assert torch.equal(single.avail_out, multi.avail_out)
    ref = J.hybrid_schedule_shapes(totals, avail, alive, sd, sid, np.uint32(9))
    same(ref.node, single.node)


def test_tie_order_identical_nodes_first_index_wins():
    """Every node identical and every score tied: the stable sort and
    the lower-index rule decide. With the jitter equal too (one uniform
    row per shape), placements must still follow JAX's order exactly, and
    the cost order of equal costs must be by node index."""
    cost = torch.tensor([3.0, 1.0, 1.0, 3.0, 1.0, float("inf"), 1.0])
    assert T._stable_argsort(cost).tolist() == [1, 2, 4, 6, 0, 3, 5]
    _, top = jax.lax.top_k(-jnp.asarray(cost.numpy()), 5)
    assert np.asarray(top).tolist() == T._stable_argsort(cost)[:5].tolist()
    totals, avail, alive = cluster(0, 64, 64, identical=True)
    sd, sid = J.dedupe_shapes(demand_mix(0, 500, 64))
    rj = J.hybrid_schedule_shapes(totals, avail, alive, sd, sid, np.uint32(1))
    rt = T.hybrid_schedule_shapes(totals, avail, alive, sd, sid, 1, device=CPU_DEV)
    same(rj.node, rt.node)


def test_count_sums_stay_exact():
    """The per-node placement counts are an index_add_ of 0/1 values:
    exact while they are small integers. 4096 requests of one shape onto 3
    nodes must deduct exactly count * demand per node."""
    totals = np.zeros((3, R), np.float32)
    totals[:, CPU] = 2048.0
    avail, alive = totals.copy(), np.ones(3, bool)
    dem = np.zeros((4096, R), np.float32)
    dem[:, CPU] = 0.5
    sd, sid = J.dedupe_shapes(dem)
    rt = T.hybrid_schedule_shapes(totals, avail, alive, sd, sid, 2, device=CPU_DEV)
    rj = J.hybrid_schedule_shapes(totals, avail, alive, sd, sid, np.uint32(2))
    same(rj.node, rt.node)
    counts = np.bincount(rt.node.numpy(), minlength=3)
    assert counts.sum() == 4096
    np.testing.assert_array_equal(rt.avail_out.numpy()[:, CPU], 2048.0 - 0.5 * counts)


@pytest.mark.parametrize("n", [1, 7, 16, 17, 100, 1000, 4099])
def test_cumsum_takes_xla_cpu_order(n):
    """_cumsum adds in XLA's CPU order (blocks of 16): bit-identical to
    jnp.cumsum on arbitrary f32 values, 1-D and over the rows of [n, R]."""
    rng = np.random.default_rng(n)
    x = rng.random(n).astype(np.float32)
    xx = rng.random((n, R)).astype(np.float32)
    want = np.asarray(jax.jit(jnp.cumsum)(x))
    np.testing.assert_array_equal(want.view(np.int32), T._cumsum(torch.from_numpy(x)).numpy().view(np.int32))
    want2 = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=0))(xx))
    got2 = T._cumsum(torch.from_numpy(xx)).numpy()
    np.testing.assert_array_equal(want2.view(np.int32), got2.view(np.int32))


@pytest.mark.parametrize("quant", [64, 10_000], ids=["q64", "q1e-4"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rounds_and_chunked_match_jax(seed, quant):
    totals, avail, alive = cluster(seed, 24, quant, identical=seed == 3)
    dem = demand_mix(seed, 96, quant)
    rj = J.hybrid_schedule_rounds(totals, avail, alive, dem, np.uint32(seed), rounds=4)
    rt = T.hybrid_schedule_rounds(totals, avail, alive, dem, seed, rounds=4, device=CPU_DEV)
    same(rj.node, rt.node)
    assert_avail(rj.avail_out, rt.avail_out, quant)
    chunks = dem.reshape(3, 32, R)
    cj = J.hybrid_schedule_rounds_chunked(totals, avail, alive, chunks, np.uint32(seed), rounds=3)
    ct = T.hybrid_schedule_rounds_chunked(totals, avail, alive, chunks, seed, rounds=3,
                                          device=CPU_DEV)
    same(cj.node, ct.node)
    assert_avail(cj.avail_out, ct.avail_out, quant)


@pytest.mark.parametrize("k", [None, 1, 3])
@pytest.mark.parametrize("quant", [64, 10_000], ids=["q64", "q1e-4"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_matches_jax(seed, quant, k):
    """The fidelity kernel: B sequential steps, top-k draws by randint,
    preferred nodes and forced spills."""
    totals, avail, alive = cluster(seed, 20, quant, identical=seed == 2)
    b = 32
    dem = demand_mix(seed, b, quant)
    rng = np.random.default_rng(seed)
    pref = rng.integers(0, 20, b).astype(np.int32)
    spill = rng.random(b) < 0.3
    for config in (J.HybridConfig(), J.HybridConfig(require_available=True, avoid_accel_nodes=False)):
        rj = J.hybrid_schedule_batch(totals, avail, alive, dem, pref, spill, np.uint32(seed),
                                     config=config, num_candidates=k)
        rt = T.hybrid_schedule_batch(totals, avail, alive, dem, pref, spill, seed,
                                     config=T.HybridConfig(*config), num_candidates=k,
                                     device=CPU_DEV)
        same(rj.node, rt.node)
        same(rj.available, rt.available)
        assert_avail(rj.avail_out, rt.avail_out, quant)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("quant", [64, 10_000], ids=["q64", "q1e-4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ring_and_slots_match_jax(seed, quant, weights):
    totals, avail, alive = cluster(seed, 32, quant, identical=seed == 1, dead=0.1)
    sd, _ = J.dedupe_shapes(demand_mix(seed, 200, quant))
    ring = np.concatenate([sd, np.zeros((2, R), np.float32)])  # empty slots
    counts = np.random.default_rng(seed).integers(0, 60, ring.shape[0]).astype(np.int32)
    counts[-1] = 0
    ntypes, thr = node_types(32)
    ages = np.linspace(0.0, 2.0, ring.shape[0]).astype(np.float32)
    rj = _ring_jit(totals, avail, alive, ntypes, thr, ring, counts, ages, np.uint32(seed),
                   weights=weights, preempt=True)
    rt = T.ring_schedule_impl(totals, avail, alive, ntypes, thr, ring, counts, ages, seed,
                              weights=T.ScoreWeights(*weights), preempt=True, device=CPU_DEV)
    same(rj.placed, rt.placed)
    same(rj.per_node, rt.per_node)
    same(rj.preempt_node, rt.preempt_node)
    assert_avail(rj.avail_out, rt.avail_out, quant)
    big = np.full((1, R), 1e18, np.float32)
    shapes = np.concatenate([sd, np.zeros((1, R), np.float32), big])  # zero-demand: "huge"
    same(_slots_jit(totals, avail, alive, shapes),
         T.shape_slots_impl(totals, avail, alive, shapes, device=CPU_DEV))


def test_retire_scores_and_host_helpers_match_jax():
    totals, avail, alive = cluster(5, 30, 64)
    dmd = (np.random.default_rng(5).random(30) < 0.3).astype(np.float32)
    a = np.asarray(J.retire_scores_impl(totals, avail, dmd))
    b = T.retire_scores_impl(totals, avail, dmd, device=CPU_DEV).numpy()
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    np.testing.assert_array_equal(J.retire_order(totals, avail, dmd),
                                  T.retire_order(totals, avail, dmd, device=CPU_DEV))
    dem = demand_mix(5, 50, 64)
    for x, y in zip(J.dedupe_shapes(dem), T.dedupe_shapes(dem)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(J.hardest_first_order(dem), T.hardest_first_order(dem))


@pytest.mark.parametrize("seed", [42, 7])
def test_batch_matches_the_numpy_golden_model(seed):
    """The reference's golden-model check (test_scheduler_hybrid.py), on
    the port: k=1, deterministic."""
    rng = np.random.default_rng(seed)
    for _ in range(5):
        n = int(rng.integers(2, 12))
        totals = np.zeros((n, R), np.float32)
        totals[:, CPU] = rng.integers(1, 16, n)
        totals[:, MEMORY] = rng.integers(1, 64, n)
        avail = totals.copy()
        avail[:, CPU] = np.floor(avail[:, CPU] * rng.uniform(0.2, 1.0, n))
        alive = np.ones(n, bool)
        dem = np.zeros((6, R), np.float32)
        dem[:, CPU] = rng.integers(1, 4, 6)
        zeros_i, zeros_b = np.zeros(6, np.int32), np.zeros(6, bool)
        res = T.hybrid_schedule_batch(totals, avail, alive, dem, zeros_i, zeros_b, 0,
                                      num_candidates=1, device=CPU_DEV)
        ref_nodes, ref_granted, _ = T.hybrid_schedule_reference(
            totals, avail, alive, dem, zeros_i, zeros_b, rng=None, top_k_override=1)
        np.testing.assert_array_equal(res.node.numpy(), ref_nodes)
        np.testing.assert_array_equal(res.available.numpy(), ref_granted)


# -- the semantic cases of tests/test_scheduler_hybrid.py, on the port --------


def mk_nodes(specs):
    totals = np.zeros((len(specs), R), np.float32)
    for i, s in enumerate(specs):
        for col, q in s.items():
            totals[i, col] = q
    return totals, totals.copy(), np.ones(len(specs), bool)


def dvec(**cols):
    d = np.zeros(R, np.float32)
    for k, v in cols.items():
        d[{"cpu": CPU, "mem": MEMORY, "gpu": GPU}[k]] = v
    return d


def run_batch(totals, avail, alive, demands, config=T.HybridConfig(), k=1, prefer=None,
              spill=None):
    b = len(demands)
    prefer = np.zeros(b, np.int32) if prefer is None else prefer
    spill = np.zeros(b, bool) if spill is None else spill
    return T.hybrid_schedule_batch(totals, avail, alive, np.stack(demands), prefer, spill, 0,
                                   config=config, num_candidates=k, device=CPU_DEV)


def test_batch_semantics_of_the_reference_suite():
    totals, avail, alive = mk_nodes([{CPU: 2}, {CPU: 4}])
    assert int(run_batch(totals, avail, alive, [dvec(cpu=8)]).node[0]) == -1  # infeasible
    totals, avail, alive = mk_nodes([{CPU: 4}])
    avail[0, CPU] = 0.0
    res = run_batch(totals, avail, alive, [dvec(cpu=4)])
    assert int(res.node[0]) == 0 and not bool(res.available[0])  # queued, not granted
    res = run_batch(totals, avail, alive, [dvec(cpu=4)],
                    config=T.HybridConfig(require_available=True))
    assert int(res.node[0]) == -1
    totals, avail, alive = mk_nodes([{CPU: 8, MEMORY: 100}, {CPU: 8, MEMORY: 100}])
    avail[0, CPU] = 1.0
    assert int(run_batch(totals, avail, alive, [dvec(cpu=1)]).node[0]) == 1  # lower utilization
    totals, avail, alive = mk_nodes([{CPU: 10}, {CPU: 10}])
    avail[0, CPU] = 7.0
    assert int(run_batch(totals, avail, alive, [dvec(cpu=1)]).node[0]) == 0  # threshold zeroes
    totals, avail, alive = mk_nodes([{CPU: 2}, {CPU: 2}])
    res = run_batch(totals, avail, alive, [dvec(cpu=2)] * 2)
    assert sorted(res.node.tolist()) == [0, 1]  # deducts between requests
    assert np.allclose(res.avail_out.numpy()[:, CPU], 0.0)
    totals, avail, alive = mk_nodes([{CPU: 8, GPU: 4}, {CPU: 8}])
    assert int(run_batch(totals, avail, alive, [dvec(cpu=1)]).node[0]) == 1  # accel avoided
    assert int(run_batch(totals, avail, alive, [dvec(cpu=1, gpu=1)]).node[0]) == 0
    totals, avail, alive = mk_nodes([{CPU: 8}, {CPU: 8}])
    res = run_batch(totals, avail, alive, [dvec(cpu=1)], prefer=np.array([0], np.int32),
                    spill=np.array([True]))
    assert int(res.node[0]) == 1  # forced spill avoids the preferred node


def test_rounds_and_shapes_semantics_of_the_reference_suite():
    totals, avail, alive = mk_nodes([{CPU: 8}] * 4)
    dem = np.zeros((32, R), np.float32)
    dem[:, CPU] = 1.0
    nodes = T.hybrid_schedule_rounds(totals, avail, alive, dem, 0, rounds=8,
                                     device=CPU_DEV).node.numpy()
    assert (nodes >= 0).all() and (np.bincount(nodes, minlength=4) <= 8).all()
    totals, avail, alive = mk_nodes([{CPU: 2}, {CPU: 2}])
    res = T.hybrid_schedule_rounds(totals, avail, alive, dem[:10], 1, rounds=6, device=CPU_DEV)
    assert (res.node.numpy() >= 0).sum() == 4
    assert res.avail_out.numpy()[:, CPU].min() >= -1e-4
    # shapes: capacity-exact, overflow unplaced, infeasible shape -1
    res = T.hybrid_schedule_shapes(totals, avail, alive, *T.dedupe_shapes(dem[:10]), 0,
                                   device=CPU_DEV)
    assert (res.node.numpy() >= 0).sum() == 4
    totals, avail, alive = mk_nodes([{CPU: 4}, {CPU: 4}])
    dem3 = np.stack([dvec(cpu=1), dvec(gpu=1), dvec(cpu=2)])
    nodes = T.hybrid_schedule_shapes(totals, avail, alive, *T.dedupe_shapes(dem3), 0,
                                     device=CPU_DEV).node.numpy()
    assert nodes[1] == -1 and nodes[0] >= 0 and nodes[2] >= 0


def test_programs_default_to_cuda():
    """No device and host inputs: the programs run on cuda, so on a host
    without CUDA they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    totals, avail, alive = mk_nodes([{CPU: 4}])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.hybrid_schedule_shapes(totals, avail, alive, *T.dedupe_shapes(dvec(cpu=1)[None]), 0)
