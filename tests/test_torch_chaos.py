"""The chaos package on the port (``ray_tpu_torch.chaos``) against the JAX
package's (``ray_tpu.chaos``), with the scheduler's rounds on the host.

``tests/test_chaos.py``'s four fast cases and its two slow soaks, with
``ray_tpu`` read as ``ray_tpu_torch``. Then the two packages side by side:
``make_plan`` equal field for field over every mix, the seeds below and an
allow-list of one kind; the mixes and ``KINDS``; ``expected_payload`` byte
for byte; ``ChaosRunResult.summary()`` and ``recovery_percentiles()`` on
the same fault results; the fast tier on both packages, ``ok`` with the
same kinds injected in the same order; and importing the port's package
loads neither ``jax`` nor ``ray_tpu``.
"""
import os
import pathlib
import random
import subprocess
import sys
import tempfile

import pytest

from ray_tpu_torch.chaos import chaos_seed, make_plan

REPO = pathlib.Path(__file__).resolve().parents[1]

# seed 51's first three faults under this allow-list are one partition,
# one object_drop, one straggler — all three fast kinds in one smoke
FAST_SEED = 51
FAST_ALLOW = ("straggler", "object_drop", "partition")

MIXES = ("DEFAULT_MIX", "SERVE_MIX", "NET_MIX", "FAILOVER_MIX", "TRAIN_MIX",
         "ELASTIC_MIX", "ROUTER_MIX", "RL_MIX")
SEEDS = (0, 7, 11, 51, 20260803)


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


# -- tests/test_chaos.py's fast cases ----------------------------------------


def test_plan_is_deterministic_per_seed():
    p1 = make_plan(42, 50)
    p2 = make_plan(42, 50)
    p3 = make_plan(43, 50)
    assert p1 == p2, "same seed must reproduce the same fault schedule"
    assert p1 != p3, "different seeds must differ"
    assert len(p1.faults) == 50
    # every fault kind shows up in a 50-fault default-mix plan
    assert set(p1.counts()) == {
        "partition",
        "straggler",
        "object_drop",
        "kill_node",
        "owner_kill",
        "zygote_kill",
        "head_restart",
    }


def test_plan_allow_list_filters_kinds():
    p = make_plan(7, 30, allow=("straggler", "object_drop"))
    assert set(p.counts()) <= {"straggler", "object_drop"}


def test_chaos_seed_env_round_trip(monkeypatch):
    monkeypatch.setenv("RAY_TPU_CHAOS_SEED", "909")
    assert chaos_seed() == 909
    monkeypatch.delenv("RAY_TPU_CHAOS_SEED")
    assert chaos_seed(default=5) == 5


def _run_chaos(
    pkg,
    num_faults: int,
    allow,
    seed: int,
    num_nodes: int = 1,
    convergence_budget_s: float = 45.0,
    partition_hold_s: float = 0.5,
    mix=None,
    payload_bytes: int = 150_000,
):
    """``tests/test_chaos.py``'s ``_run_chaos`` on package ``pkg``
    (``ray_tpu_torch`` or ``ray_tpu``)."""
    import importlib

    chaos = importlib.import_module(f"{pkg}.chaos")
    Cluster = importlib.import_module(f"{pkg}.cluster").Cluster
    set_runtime = importlib.import_module(f"{pkg}.core.runtime").set_runtime

    tmp = tempfile.mkdtemp(prefix=f"{pkg}_chaos_test_")
    cluster = Cluster(
        use_device_scheduler=False,
        persist_path=os.path.join(tmp, "head_state.pkl"),
    )
    for _ in range(num_nodes):
        cluster.add_node({"CPU": 2.0}, num_workers=2)
    rt = cluster.client()
    set_runtime(rt)
    try:
        workload = chaos.ChaosWorkload(
            rt, payload_bytes=payload_bytes, num_actors=1
        )
        if mix is not None:
            plan = chaos.make_plan(seed, num_faults, mix=mix, allow=allow)
        else:
            plan = chaos.make_plan(seed, num_faults, allow=allow)
        orch = chaos.ChaosOrchestrator(
            cluster,
            workload,
            plan,
            node_resources={"CPU": 2.0},
            partition_hold_s=partition_hold_s,
            straggler_peak_s=0.2,
            convergence_budget_s=convergence_budget_s,
        )
        return orch.run()
    finally:
        set_runtime(None)
        try:
            rt.shutdown()
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()


@pytest.fixture(scope="module")
def port_fast_tier():
    """The port's fast tier, run once for the mirror and the parity case."""
    from ray_tpu_torch.core import refcount

    # a client an earlier test of this process never shut down would leave
    # its RefFlusher installed as the consumer, and the new client would
    # run no owner session
    refcount.clear_consumer()
    return _run_chaos(
        "ray_tpu_torch",
        num_faults=3,
        allow=FAST_ALLOW,
        seed=FAST_SEED,
        convergence_budget_s=30.0,
    )


def test_fast_deterministic_chaos_tier(port_fast_tier):
    """Tier-1 smoke: a fixed-seed 3-fault plan (no process kills — those
    live in the slow soak) converges with every invariant green."""
    result = port_fast_tier
    assert result.ok, (
        f"invariants failed (replay with RAY_TPU_CHAOS_SEED={FAST_SEED}): "
        f"{result.summary()}"
    )
    assert len(result.faults) == 3
    assert result.objects_acked > 0


# -- the same inputs through both packages -----------------------------------


def _mix_allow_cases():
    from ray_tpu_torch import chaos

    cases = []
    for mix in MIXES:
        # the kind each mix adds to the default, or the default's last
        last = getattr(chaos.plan, mix)[-1][0]
        for seed in SEEDS:
            cases.append((mix, seed, None))
            cases.append((mix, seed, (last,)))
    return cases


def _fields(plan):
    return [(f.index, f.kind, f.delay_s, f.target, f.magnitude) for f in plan.faults]


@pytest.mark.parametrize("mix,seed,allow", _mix_allow_cases())
def test_make_plan_equals_the_reference(mix, seed, allow):
    from ray_tpu.chaos import plan as jplan

    from ray_tpu_torch.chaos import plan as tplan

    kw = dict(mix=getattr(tplan, mix), allow=allow)
    jkw = dict(mix=getattr(jplan, mix), allow=allow)
    for n in (1, 12, 20):
        t, j = tplan.make_plan(seed, n, **kw), jplan.make_plan(seed, n, **jkw)
        assert t.seed == j.seed
        assert _fields(t) == _fields(j)
        assert t.counts() == j.counts()
    # the serve cases' delay window too
    t = tplan.make_plan(seed, 4, min_delay_s=0.5, max_delay_s=1.0, **kw)
    j = jplan.make_plan(seed, 4, min_delay_s=0.5, max_delay_s=1.0, **jkw)
    assert _fields(t) == _fields(j)


def test_mixes_and_kinds_equal_the_reference():
    from ray_tpu.chaos import plan as jplan

    from ray_tpu_torch.chaos import plan as tplan

    for mix in MIXES:
        assert getattr(tplan, mix) == getattr(jplan, mix), mix
    assert tplan.KINDS == jplan.KINDS
    with pytest.raises(ValueError):
        tplan.make_plan(0, 1, allow=("no_such_kind",))


def test_twelve_fault_prefix_of_the_bench_plan():
    """The chip phase runs the first 12 of bench.py's 20 faults: they are
    the 20-fault plan's prefix, hold all six of its kinds, and equal the
    JAX package's."""
    from ray_tpu.chaos import make_plan as jmake

    full, cut = make_plan(20260803, 20), make_plan(20260803, 12)
    assert cut.faults == full.faults[:12]
    assert set(cut.counts()) == set(full.counts())
    assert "head_restart" not in full.counts()
    assert _fields(cut) == _fields(jmake(20260803, 12))
    restart = make_plan(20260803, 1, allow=("head_restart",))
    assert restart.counts() == {"head_restart": 1}
    assert _fields(restart) == _fields(jmake(20260803, 1, allow=("head_restart",)))


@pytest.mark.parametrize("i,n", [(0, 0), (0, 1), (7, 4096), (250, 13), (251, 13),
                                 (1000, 150_000), (12345, 200_000)])
def test_expected_payload_equals_the_reference(i, n):
    from ray_tpu.chaos.workload import expected_payload as jpayload

    from ray_tpu_torch.chaos.workload import expected_payload

    assert expected_payload(i, n) == jpayload(i, n)
    assert len(expected_payload(i, n)) == n


def _results(pkg, seed, n, n_bad):
    """``n`` fault results (``n_bad`` of them failed) of package ``pkg``,
    drawn from ``seed``."""
    import importlib

    orch = importlib.import_module(f"{pkg}.chaos.orchestrator")
    plan = importlib.import_module(f"{pkg}.chaos.plan")
    rng = random.Random(seed)
    specs = plan.make_plan(seed, n, mix=plan.ROUTER_MIX).faults
    res = orch.ChaosRunResult(seed=seed, objects_reconstructed=rng.randrange(9),
                              objects_acked=rng.randrange(200),
                              arena_zombies_after=rng.randrange(2),
                              owners_killed=rng.randrange(3))
    bad = set(rng.sample(range(n), n_bad))
    for spec in specs:
        res.faults.append(orch.FaultResult(
            spec=spec, ok=spec.index not in bad, recovery_s=rng.expovariate(1.0),
            failures=[f"why {spec.index}"] if spec.index in bad else [],
            detail=f"detail {spec.index}"))
    return res


@pytest.mark.parametrize("seed,n,n_bad", [(0, 0, 0), (1, 1, 0), (2, 1, 1), (3, 7, 2),
                                          (20260803, 20, 0), (5, 20, 3), (6, 40, 1)])
def test_run_result_summary_equals_the_reference(seed, n, n_bad):
    t, j = _results("ray_tpu_torch", seed, n, n_bad), _results("ray_tpu", seed, n, n_bad)
    assert t.ok == j.ok == (n_bad == 0)
    assert t.recovery_percentiles() == j.recovery_percentiles()
    assert t.summary() == j.summary()


def test_fast_tier_injects_the_reference_schedule(port_fast_tier):
    """The fast tier on both packages: both ``ok``, the same kinds
    injected in the same order, each fault injected (not skipped) on both."""
    ref = _run_chaos(
        "ray_tpu",
        num_faults=3,
        allow=FAST_ALLOW,
        seed=FAST_SEED,
        convergence_budget_s=30.0,
    )
    assert ref.ok, ref.summary()
    assert port_fast_tier.ok, port_fast_tier.summary()

    def schedule(res):
        return [(f.spec.index, f.spec.kind, f.detail.split()[0]) for f in res.faults]

    assert schedule(port_fast_tier) == schedule(ref)
    assert [k for _, k, _ in schedule(ref)] == ["partition", "object_drop", "straggler"]
    assert all(verb != "skipped:" for _, _, verb in schedule(ref))
    assert port_fast_tier.summary()["fault_counts"] == ref.summary()["fault_counts"]


def test_chaos_package_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import ray_tpu_torch.chaos as c\n"
        "from ray_tpu_torch.chaos import owner_proc, orchestrator, invariants, serve, rl\n"
        "c.make_plan(20260803, 12)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'ray_tpu' or m.startswith('ray_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert out.stdout.strip() == "", out.stdout


def test_the_owner_process_is_the_ports():
    """The sacrificial owner is spawned as the port's module: the chip
    machine has no jax, so a ``ray_tpu`` module there would fail only
    there."""
    import inspect

    from ray_tpu_torch.chaos import orchestrator

    src = inspect.getsource(orchestrator.ChaosOrchestrator._spawn_owner_proc)
    assert '"ray_tpu_torch.chaos.owner_proc"' in src
    assert '"ray_tpu.chaos.owner_proc"' not in src


# -- tests/test_chaos.py's slow soaks ----------------------------------------


@pytest.mark.slow
def test_chaos_soak_twenty_faults_zero_acked_loss(monkeypatch):
    """The acceptance soak: >=20 faults across every kind (kills,
    partitions, head restarts, owner kills, zygote kills included)
    against a running workload — zero acked-object loss, zero leaked
    arena zombies, zero leaked actors/leases after owner death, all
    invariant checks green."""
    # tight-but-real failure detection: the soak spends its wall clock on
    # faults, not on twenty 8s death timeouts
    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "4.0")
    monkeypatch.setenv("RAY_TPU_RPC_BREAKER_WINDOW_S", "2.0")
    # owner-death detection ~ ttl x threshold: keep it a few seconds so
    # each owner_kill fault converges well inside its budget
    monkeypatch.setenv("RAY_TPU_OWNER_LEASE_TTL_S", "1.5")
    monkeypatch.setenv("RAY_TPU_OWNER_MISS_THRESHOLD", "2")
    seed = chaos_seed(default=20260803)
    result = _run_chaos(
        "ray_tpu_torch",
        num_faults=20,
        allow=None,  # full default mix
        seed=seed,
        num_nodes=2,
        convergence_budget_s=60.0,
        partition_hold_s=1.0,
    )
    assert len(result.faults) == 20
    assert result.ok, (
        f"soak failed — replay with RAY_TPU_CHAOS_SEED={seed}: "
        f"{result.summary()}"
    )
    counts = result.summary()["fault_counts"]
    assert counts.get("kill_node", 0) >= 1
    assert counts.get("partition", 0) >= 1
    assert counts.get("owner_kill", 0) >= 1
    assert counts.get("zygote_kill", 0) >= 1
    assert result.objects_acked >= 20
    # zombie-pin reclamation: no arena entry may stay deleted-with-pins
    # once every reader released or died (pin-log replay)
    assert result.arena_zombies_after == 0, (
        f"{result.arena_zombies_after} arena zombies leaked after soak"
    )
    # replaying the seed reproduces the same schedule
    assert make_plan(seed, 20) == make_plan(seed, 20)


@pytest.mark.slow
def test_chaos_net_mix_peer_conn_drop_soak(monkeypatch):
    """Cross-node transport under chaos: a NET_MIX plan (peer_conn_drop
    severing served data sockets mid-transfer, plus partitions and
    object drops) against a 2-node cluster moving multi-stripe objects.
    Invariant: zero acked-object loss — severed stripes RESUME (and, on
    harder faults, transfers fall back to chunked RPC / lineage), never
    corrupt or lose an acked value."""
    from ray_tpu_torch.chaos import NET_MIX

    # small stripes so the 1.5 MB workload payloads stripe across
    # connections, widening the mid-transfer window the severs land in
    monkeypatch.setenv("RAY_TPU_NET_STRIPE_BYTES", str(1 << 20))
    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "4.0")
    # the reference's default seed: its 8-draw schedule includes >=1
    # peer_conn_drop (the kind under test) beside the other faults
    seed = chaos_seed(default=20261104)
    result = _run_chaos(
        "ray_tpu_torch",
        num_faults=8,
        allow=("peer_conn_drop", "object_drop", "partition"),
        seed=seed,
        num_nodes=2,
        mix=NET_MIX,
        payload_bytes=1_500_000,
        convergence_budget_s=60.0,
    )
    assert result.ok, (
        f"invariants failed (replay with RAY_TPU_CHAOS_SEED={seed}): "
        f"{result.summary()}"
    )
    assert result.summary()["fault_counts"].get("peer_conn_drop", 0) >= 1
    assert result.objects_acked > 0
