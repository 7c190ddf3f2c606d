"""The port's elastic SPMD training (``ray_tpu_torch.train.elastic``) on
the CPU.

Mirrors the twelve non-slow cases of ``tests/test_elastic_train.py`` and
its slow chaos case (through ``ray_tpu_torch.chaos``'s invariant checker) on
``ray_tpu_torch`` with the same assertions: partition rules and the
shard/gather functions (specs are the port's tuples of axis names, the
mesh a CPU one), seal/regather round trips (full and ZeRO-style
virtual-sharded), the gang hub's epoch fence, an elastic run end to end,
the dp shrink/grow bit-exactness pin, the head's gang protocol under node
death, and the checkpoint/retry/teardown satellites. Then holds the port
against the JAX package on the same inputs: tree paths, leaf order and
specs; ``_split_sizes`` against ``np.array_split``; the same numpy state
sealed by each package regathers to equal leaves (and, through the
port's device plane, as tensors); both packages' ``_fit_elastic`` on the
reference tests' own numpy step, with and without the 2→1→2 resize, end
bit-equal; and the ROADMAP gate: a small transformer trained by
``ElasticTrainer`` on the CPU, shrunk 2→1→2, ends bit-exact against the
unreshaped run and against one process, its first loss within 1e-5 of
JAX's ``loss_fn`` on the same parameters.

The port's runtime schedules on the CPU (``RAY_TPU_SCHED_PLATFORM=cpu``).
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch


@pytest.fixture(autouse=True)
def _cpu_scheduler(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")


@pytest.fixture()
def rt(_cpu_scheduler):
    rt = ray_tpu_torch.init(
        num_nodes=2,
        resources_per_node={"CPU": 8, "memory": float(1 << 30)},
    )
    yield rt
    ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# declarative parameter sharding
# ---------------------------------------------------------------------------


def test_match_partition_rules_paths_scalars_and_misses():
    from ray_tpu_torch.train.elastic import match_partition_rules

    params = {
        "dense": {"kernel": np.zeros((8, 4)), "bias": np.zeros(4)},
        "scale": np.float32(2.0),  # scalar: never partitioned
    }
    specs = match_partition_rules(
        [(r"dense/kernel$", ("dp", None)), (r"bias$", (None,))], params
    )
    assert specs["dense"]["kernel"] == ("dp", None)
    assert specs["dense"]["bias"] == (None,)
    assert specs["scale"] == ()
    with pytest.raises(ValueError, match="partition rule not found"):
        match_partition_rules([(r"bias$", ())], params)


def test_shard_and_gather_fns_roundtrip():
    from ray_tpu_torch.parallel.mesh import Mesh, MeshConfig, local_mesh
    from ray_tpu_torch.train.elastic import (
        apply_shard_rules,
        make_shard_and_gather_fns,
        match_partition_rules,
    )

    mesh = local_mesh("cpu")
    params = {"w": np.arange(8, dtype=np.float32).reshape(4, 2), "b": np.ones(2, np.float32)}
    rules = [(r"w$", ("dp", None)), (r"b$", (None,))]
    specs = match_partition_rules(rules, params)
    shard_fns, gather_fns = make_shard_and_gather_fns(specs, mesh)
    # a spec is a tuple: the fn trees must mirror the PARAM tree, not
    # recurse into the specs themselves
    assert callable(shard_fns["w"]) and callable(gather_fns["b"])
    placed = {k: shard_fns[k](v) for k, v in params.items()}
    back = {k: gather_fns[k](v) for k, v in placed.items()}
    for k in params:
        assert np.array_equal(back[k].numpy(), params[k])
    placed2 = apply_shard_rules(params, rules, mesh)
    for k in params:
        assert np.array_equal(placed2[k].numpy(), params[k])
    # on a dp=2 mesh each rank's shard is its block of rows, the blocks
    # jointly the whole leaf (the layout NamedSharding gives JAX)
    blocks = [
        make_shard_and_gather_fns(specs, Mesh(MeshConfig(dp=2), r, torch.device("cpu")))[0]["w"](
            params["w"])
        for r in range(2)
    ]
    assert [tuple(b.shape) for b in blocks] == [(2, 2), (2, 2)]
    assert np.array_equal(torch.cat(blocks).numpy(), params["w"])


# ---------------------------------------------------------------------------
# state seal / regather over the object plane
# ---------------------------------------------------------------------------


def _toy_state(dim: int = 12):
    return {
        "w": np.arange(dim, dtype=np.float64),
        "opt": {"m": np.arange(dim, dtype=np.float64) * 0.5, "count": 7},
    }


def test_seal_regather_roundtrip_sharded(rt):
    from ray_tpu_torch.train.elastic import (
        ElasticStateIncomplete,
        fetch_sealed,
        regather_state,
        seal_rank_state,
    )

    state = _toy_state()
    vshards = 4
    hexes = [
        seal_rank_state(
            state, 5, rank, 2, vshards, elastic_shard_rules=(r"^opt/m$",)
        )[0]
        for rank in range(2)
    ]
    payloads = [fetch_sealed(h) for h in hexes]
    assert payloads[0]["sharded"], "rule matched nothing"
    rebuilt, step = regather_state(payloads)
    assert step == 5
    assert np.array_equal(rebuilt["w"], state["w"])
    assert np.array_equal(rebuilt["opt"]["m"], state["opt"]["m"])
    assert rebuilt["opt"]["count"] == 7
    with pytest.raises(ElasticStateIncomplete, match="virtual shards"):
        regather_state(payloads[:1])
    h2, _ = seal_rank_state(
        state, 6, 0, 2, vshards, elastic_shard_rules=(r"^opt/m$",)
    )
    with pytest.raises(ElasticStateIncomplete, match="mixed-step"):
        regather_state([payloads[1], fetch_sealed(h2)])


def test_seal_regather_replicated_any_single_survivor(rt):
    from ray_tpu_torch.train.elastic import (
        fetch_sealed,
        regather_state,
        seal_rank_state,
    )

    state = _toy_state()
    hexes = [
        seal_rank_state(state, 3, rank, 2, 4)[0] for rank in range(2)
    ]
    for h in hexes:
        rebuilt, step = regather_state([fetch_sealed(h)])
        assert step == 3
        assert np.array_equal(rebuilt["w"], state["w"])


# ---------------------------------------------------------------------------
# gang hub: epoch-fenced rendezvous
# ---------------------------------------------------------------------------


def test_gang_hub_rejects_stale_epoch_and_wakes_parked_waiters():
    import asyncio

    from ray_tpu_torch.train.elastic import _GangHubActor

    hub = _GangHubActor("g1", epoch=3, world=2)

    async def drive():
        out = await hub.collect("op:0", 2, 0, "old")
        assert out == {"revoked": 3}
        await hub.note_seal(0, 10, "deadbeef", [0], epoch=2)
        assert await hub.seal_registry() == {}
        t = asyncio.create_task(hub.collect("op:1", 3, 0, "a", timeout=30))
        await asyncio.sleep(0.05)
        await hub.set_epoch(4)
        out = await asyncio.wait_for(t, timeout=5)
        assert out == {"revoked": 4}
        t0 = asyncio.create_task(hub.collect("op:2", 4, 0, "x", timeout=10))
        out1 = await hub.collect("op:2", 4, 1, "y", timeout=10)
        out0 = await asyncio.wait_for(t0, timeout=5)
        assert out0 == ["x", "y"] and out1 == ["x", "y"]

    asyncio.run(drive())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gang_hub_folds_the_shards_once_in_shard_order(dtype):
    """``collect_sum`` answers both ranks with one sum over the shards in
    ascending order, bit-equal to the fold a rank made of the gathered
    partials (the hub now folds, so a rank takes one sum instead of every
    rank's partials), and frees the op once both ranks took it."""
    import asyncio
    from functools import reduce

    from ray_tpu_torch.train import pytree
    from ray_tpu_torch.train.elastic import _GangHubActor

    g = torch.Generator().manual_seed(5)
    parts = {v: {"w": torch.randn(64, generator=g).to(dtype),
                 "b": {"c": torch.randn(3, generator=g).to(dtype)}} for v in range(4)}
    want = pytree.tree_map(lambda *xs: reduce(lambda a, b: a + b, xs),
                           *[parts[v] for v in range(4)])
    hub = _GangHubActor("g2", epoch=1, world=2)

    async def drive():
        t1 = asyncio.create_task(
            hub.collect_sum("allreduce_shards:0", 1, 1, {1: parts[1], 3: parts[3]}, timeout=10))
        out0 = await hub.collect_sum("allreduce_shards:0", 1, 0, {0: parts[0], 2: parts[2]},
                                     timeout=10)
        out1 = await asyncio.wait_for(t1, timeout=5)
        assert await hub.collect_sum("op:9", 0, 0, {}) == {"revoked": 1}
        return out0, out1

    out0, out1 = asyncio.run(drive())
    for out in (out0, out1):
        assert out["shards"] == [0, 1, 2, 3]
        for a, b in zip(pytree.leaves(out["sum"]), pytree.leaves(want)):
            assert a.dtype == dtype and torch.equal(a, b)
    assert hub.sums == {} and hub.sum_remaining == {}


# ---------------------------------------------------------------------------
# elastic runs: end-to-end + reshape correctness
# ---------------------------------------------------------------------------


def _el_init(config):
    d = int(config["dim"])
    return {"w": np.zeros(d), "opt": {"m": np.zeros(d)}}


def _el_step(state, step, gang, config):
    d = int(config["dim"])
    partials = {}
    for v in gang.owned_shards():
        # integer-valued synthetic grads: float64 sums of these are
        # exactly representable, so bit-exactness is meaningful
        partials[v] = {"g": np.full(d, float((v + step) % 7))}
    g = gang.allreduce_shards(partials)
    time.sleep(float(config.get("step_sleep", 0.0)))
    return (
        {"w": state["w"] + g["g"], "opt": {"m": state["opt"]["m"] + 1.0}},
        {"step": step, "world": gang.world, "w0": float(state["w"][0])},
    )


def _expected_w(dim: int, steps: int, vshards: int) -> np.ndarray:
    w = np.zeros(dim)
    for s in range(steps):
        w += sum(float((v + s) % 7) for v in range(vshards))
    return w


def _fit_elastic(
    total_steps, resizes=(), grow=False, shard_rules=(), dim=32, step_sleep=0.0,
    train=None, init_fn=_el_init, step_fn=_el_step, config=None,
):
    """One elastic run; ``train`` is the package's ``train`` module (the
    port's by default), so both packages run the same driver."""
    if train is None:
        from ray_tpu_torch import train
    trainer = train.ElasticTrainer(
        init_fn,
        step_fn,
        total_steps=total_steps,
        train_loop_config=config or {"dim": dim, "step_sleep": step_sleep},
        elastic_config=train.ElasticConfig(
            min_workers=1,
            max_workers=2,
            virtual_shards=4,
            seal_interval_steps=2,
            elastic_shard_rules=tuple(shard_rules),
            grow=grow,
            resources_per_worker={"CPU": 1.0},
        ),
    )
    box = {}
    th = threading.Thread(target=lambda: box.update(res=trainer.fit()))
    th.start()
    for trigger, world in resizes:
        if not callable(trigger):
            at_step = trigger
            trigger = lambda t: t.progress()["step"] >= at_step  # noqa: E731,B023
        deadline = time.monotonic() + 60
        while (
            not trigger(trainer)
            and time.monotonic() < deadline
            and th.is_alive()
        ):
            time.sleep(0.02)
        trainer.request_resize(world)
    th.join(timeout=180)
    assert not th.is_alive(), "elastic fit() wedged"
    res = box["res"]
    assert res.error is None, res.error
    return trainer, res


# the reference test's resizes: shrink once real progress exists, grow the
# moment the shrunk generation is up
SHRINK_GROW = (
    (4, 1),
    (lambda t: any(r["direction"] == "shrink" for r in t.reshape_log), 2),
)


def test_elastic_end_to_end_no_fault(rt):
    trainer, res = _fit_elastic(total_steps=10)
    hist = res.metrics_history
    assert [m["step"] for m in hist] == list(range(10))
    state = trainer.final_state()
    assert np.array_equal(state["w"], _expected_w(32, 10, 4))
    assert np.array_equal(state["opt"]["m"], np.full(32, 10.0))
    assert res.metrics["elastic"]["disk_restores"] == 0
    assert res.metrics["elastic"]["reshapes"] == []


def test_dp_shrink_grow_preserves_params_bit_exact(rt):
    """A run that shrinks 2 -> 1 mid-way and grows back 1 -> 2 ends with
    params (and dp-sharded optimizer state regathered through the object
    plane) BIT-EXACT vs the unreshaped run, with a contiguous step
    history."""
    total = 20
    _, ref = _fit_elastic(total_steps=total, shard_rules=(r"^opt/m$",))
    trainer, res = _fit_elastic(
        total_steps=total,
        resizes=SHRINK_GROW,
        shard_rules=(r"^opt/m$",),
        step_sleep=0.15,
    )
    directions = [r["direction"] for r in trainer.reshape_log]
    assert "shrink" in directions and "grow" in directions, directions
    assert res.metrics["elastic"]["disk_restores"] == 0
    assert [m["step"] for m in res.metrics_history] == list(range(total))
    assert [m["w0"] for m in res.metrics_history] == [
        m["w0"] for m in ref.metrics_history
    ]
    state = trainer.final_state()
    assert np.array_equal(state["w"], _expected_w(32, total, 4))
    assert np.array_equal(state["opt"]["m"], np.full(32, float(total)))


def test_grow_waits_for_the_old_generations_capacity(rt, monkeypatch):
    """A grow re-forms the gang after tearing the old generation down, and
    the nodes it held read as busy until their agents report the returned
    leases. Here the first capacity read after the grow request misses
    one node: the reshape reads again and grows to 2. Deciding on the
    first read (as the reference does) re-forms at world 1, a "flat"
    reshape: the chip smoke's elastic phase saw [shrink, flat, grow]."""
    from ray_tpu_torch.train import elastic as el

    real = el.ElasticTrainer._placeable_ranks
    stale = [0]

    def lagging(self, exclude_nodes=()):
        n = real(self, exclude_nodes)
        if stale[0]:
            stale[0] -= 1
            return min(n, 1)
        return n

    def shrunk(t):
        if any(r["direction"] == "shrink" for r in t.reshape_log):
            stale[0] = 1
            return True
        return False

    monkeypatch.setattr(el.ElasticTrainer, "_placeable_ranks", lagging)
    trainer, res = _fit_elastic(total_steps=24, resizes=((4, 1), (shrunk, 2)), step_sleep=0.15)
    assert [r["direction"] for r in trainer.reshape_log] == ["shrink", "grow"]
    assert [m["step"] for m in res.metrics_history] == list(range(24))


# ---------------------------------------------------------------------------
# head gang membership protocol
# ---------------------------------------------------------------------------


def test_gang_membership_epoch_protocol_under_node_death(monkeypatch):
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "2.0")
    cluster = Cluster(use_device_scheduler=False)
    node_a = cluster.add_node({"CPU": 2.0}, num_workers=1)
    node_b = cluster.add_node({"CPU": 2.0}, num_workers=1)
    rt = cluster.client()
    set_runtime(rt)
    try:
        e1 = rt.gang_register("g-test", {0: node_a, 1: node_b}, min_size=1)
        assert e1 >= 1
        e2 = rt.gang_register(
            "g-test", {0: node_a, 1: node_b}, epoch_floor=e1 + 10
        )
        assert e2 == e1 + 11
        e3 = rt.gang_fence("g-test", reason="resize")
        assert e3 == e2 + 1
        reply = rt.gang_sync("g-test", epoch=e2, timeout=5.0)
        assert reply["epoch"] == e3 and reply["dead_ranks"] == []
        t0 = time.monotonic()
        cluster.kill_node(node_b)
        deadline = time.monotonic() + 30
        reply = rt.gang_sync("g-test", epoch=e3, timeout=25.0)
        assert time.monotonic() < deadline
        assert reply["epoch"] > e3
        assert reply["dead_ranks"] == [1], reply
        gangs = rt.head.call("QueryState", {"kind": "gangs"})
        assert gangs["g-test"]["dead_ranks"] == [1]
        assert time.monotonic() - t0 < 25.0
        rt.gang_unregister("g-test")
        assert rt.head.call("QueryState", {"kind": "gangs"}) == {}
    finally:
        set_runtime(None)
        try:
            rt.shutdown()
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()


def test_rank_survives_its_hub_dying_with_its_node(monkeypatch):
    """The port's own case (ROADMAP Queue C 5): the node hosting the gang's
    rendezvous hub dies with a rank on it. The surviving rank learns of
    the fence from the head's gang table instead of waiting on the dead
    hub's call, seals its boundary and returns: the gang shrinks with
    every step reported once and no disk restore."""
    _hub_node_death(monkeypatch, "node")


def test_rank_beside_a_dead_hub_answering_before_its_node_dies(monkeypatch):
    """Killing a node is not atomic: under load the rank beside the hub saw
    the hub gone and answered "reshape" before its own process died. No
    rank then failed, so the driver trusted that node's seals and placed
    the next generation's new hub on it before the head's verdict: a
    second, "flat" reshape after a 90 s hang. The driver now counts the
    lost hub's node as dead and places a new hub beside its ranks."""
    _hub_node_death(monkeypatch, "hub_first")


def test_ranks_outliving_their_dead_agent_count_as_dead(monkeypatch):
    """Under load the workers of a killed node can outlive their agent until
    the head's verdict: the gang trains on, then both ranks answer
    "reshape" (fenced at the head) and none fails. The driver restored
    from seals held only in the dead node's arena, and the next
    generation broke again (a "flat" reshape). The driver now counts the
    ranks the head named dead as dead, answered or not. Here the dead
    node's zygote is stopped, so its workers live on as they did."""
    _hub_node_death(monkeypatch, "orphans")


def _zygote_of(cluster, node_id: str) -> int:
    """The pid of ``node_id``'s zygote, as its agent reports it (the first
    zygote is forked from the agent, so it shares the agent's command
    line, as do the workers it forks), checked to be the agent's child."""
    from ray_tpu_torch.cluster.rpc import RpcClient

    agent = cluster._agents[node_id].pid
    client = RpcClient(cluster.agent_address(node_id))
    try:
        pid = client.call("DebugState", timeout=10.0)["pool"]["zygote_pid"]
    finally:
        client.close()
    try:
        stat = open(f"/proc/{pid}/stat").read() if pid else ""
    except OSError:
        stat = ""
    if stat and int(stat.rsplit(")", 1)[1].split()[1]) == agent:
        return int(pid)
    raise AssertionError(f"no zygote under the agent of {node_id}")


@pytest.mark.slow
def test_chaos_node_kill_reshape_and_grow_back(monkeypatch, tmp_path):
    from ray_tpu_torch.chaos.invariants import InvariantChecker
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.train import ElasticConfig, ElasticTrainer

    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "2.0")
    total_steps = 40

    # closures (not module-level fns): cloudpickle ships them BY VALUE,
    # so the cluster's worker processes never need this test module on
    # their import path
    def el_init(config):
        d = int(config["dim"])
        return {"w": np.zeros(d), "opt": {"m": np.zeros(d)}}

    def el_step(state, step, gang, config):
        d = int(config["dim"])
        partials = {}
        for v in gang.owned_shards():
            partials[v] = {"g": np.full(d, float((v + step) % 7))}
        g = gang.allreduce_shards(partials)
        time.sleep(float(config.get("step_sleep", 0.0)))
        # the shrunk gang waits (bounded) for the replacement node to
        # register: an agent's start (its imports) can outlast the steps
        # left after the shrink, and a run that ends first never sees
        # capacity return
        deadline = time.monotonic() + 60.0
        while (gang.world == 1 and not os.path.exists(config["capacity_back"])
               and time.monotonic() < deadline):
            time.sleep(0.05)
        return (
            {"w": state["w"] + g["g"], "opt": {"m": state["opt"]["m"] + 1.0}},
            {"step": step, "world": gang.world, "w0": float(state["w"][0])},
        )

    capacity_back = tmp_path / "capacity_back"
    cluster = Cluster(use_device_scheduler=False)
    cluster.add_node({"CPU": 2.0}, num_workers=2)
    cluster.add_node({"CPU": 2.0}, num_workers=2)
    rt = cluster.client()
    set_runtime(rt)
    try:
        trainer = ElasticTrainer(
            el_init,
            el_step,
            total_steps=total_steps,
            train_loop_config={"dim": 64, "step_sleep": 0.08,
                               "capacity_back": str(capacity_back)},
            elastic_config=ElasticConfig(
                min_workers=1,
                max_workers=2,
                virtual_shards=4,
                seal_interval_steps=2,
                elastic_shard_rules=(r"^opt/m$",),
                grow=True,
                placement_strategy="STRICT_SPREAD",
                resources_per_worker={"CPU": 1.0},
            ),
        )
        box = {}
        th = threading.Thread(target=lambda: box.update(res=trainer.fit()))
        th.start()
        # let it make real progress, then SIGKILL the node hosting rank 1
        deadline = time.monotonic() + 90
        while (
            trainer.progress()["step"] < 8
            and time.monotonic() < deadline
            and th.is_alive()
        ):
            time.sleep(0.1)
        gangs = rt.head.call("QueryState", {"kind": "gangs"})
        gang = gangs[trainer.gang_id]
        victim = gang["members"]["1"]
        pre_epochs = {trainer.gang_id: gang["epoch"]}
        cluster.kill_node(victim)
        # membership invariant: the gang fences the dead generation and
        # re-registers a membership whose nodes are all alive
        checker = InvariantChecker(cluster, workload=None)
        assert checker.wait_gang_reshaped(pre_epochs, timeout=60) == []
        # capacity returns: the watch loop must fence + grow back
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and th.is_alive():
            if any(r["direction"] == "shrink" for r in trainer.reshape_log):
                break
            time.sleep(0.2)
        cluster.add_node({"CPU": 2.0}, num_workers=2)  # returns once it is registered
        capacity_back.touch()
        th.join(timeout=240)
        assert not th.is_alive(), "elastic fit() wedged after node kill"
        res = box["res"]
        assert res.error is None, res.error
        el = res.metrics["elastic"]
        directions = [r["direction"] for r in el["reshapes"]]
        assert "shrink" in directions, el["reshapes"]
        assert "grow" in directions, el["reshapes"]
        # checkpoint-free: lineage/object-plane only, zero disk reads
        assert el["disk_restores"] == 0
        # loss-curve continuity across the reshapes: every step reported
        # exactly once, and the reported scalar matches the closed form
        # of the unreshaped run at every step (bit-exact: integer sums)
        hist = res.metrics_history
        assert [m["step"] for m in hist] == list(range(total_steps))
        expected = 0.0
        for s in range(total_steps):
            assert hist[s]["w0"] == expected, f"divergence at step {s}"
            expected += sum(float((v + s) % 7) for v in range(4))
        state = trainer.final_state()
        assert np.array_equal(state["w"], _expected_w(64, total_steps, 4))
        assert np.array_equal(state["opt"]["m"], np.full(64, float(total_steps)))
    finally:
        set_runtime(None)
        try:
            rt.shutdown()
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()


def _hub_node_death(monkeypatch, order: str):
    """Kills the node of the gang's hub (a rank beside it) at step 6. With
    ``order`` "hub_first" the hub's process goes half a second before the
    rest of its node, so the rank beside it answers "reshape" before it
    dies; with "orphans" the node's zygote is stopped first, so its
    workers outlive the agent until the test ends."""
    import signal
    from ray_tpu_torch import train
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "2.0")
    DIM = 1 << 18  # 2 MiB partials: a call's arguments ride the object plane

    # closures: cloudpickle ships them by value, so the workers never
    # import this test module (the reference's chaos case does the same)
    def el_init(config):
        d = int(config["dim"])
        return {"w": np.zeros(d), "opt": {"m": np.zeros(d)}}

    def el_step(state, step, gang, config):
        d = int(config["dim"])
        partials = {v: {"g": np.full(d, float((v + step) % 7))} for v in gang.owned_shards()}
        g = gang.allreduce_shards(partials)
        time.sleep(float(config["step_sleep"]))
        return (
            {"w": state["w"] + g["g"], "opt": {"m": state["opt"]["m"] + 1.0}},
            {"step": step, "world": gang.world, "w0": float(state["w"][0])},
        )

    cluster = Cluster(use_device_scheduler=False)
    cluster.add_node({"CPU": 2.0}, num_workers=2)
    cluster.add_node({"CPU": 2.0}, num_workers=2)
    rt = cluster.client()
    set_runtime(rt)
    try:
        trainer = train.ElasticTrainer(
            el_init, el_step, total_steps=24,
            train_loop_config={"dim": DIM, "step_sleep": 0.1},
            elastic_config=train.ElasticConfig(
                min_workers=1, max_workers=2, virtual_shards=4, seal_interval_steps=2,
                elastic_shard_rules=(r"^opt/m$",), grow=False,
                placement_strategy="STRICT_SPREAD", resources_per_worker={"CPU": 1.0}),
        )
        box = {}
        th = threading.Thread(target=lambda: box.update(res=trainer.fit()))
        th.start()
        deadline = time.monotonic() + 60
        while trainer.progress()["step"] < 6 and time.monotonic() < deadline:
            time.sleep(0.05)
        actors = rt.head.call("QueryState", {"kind": "actors"})
        hub_node = next(a["node_id"] for a in actors if a["class_name"] == "_GangHubActor")
        assert hub_node
        zygote = None
        if order == "hub_first":
            ray_tpu_torch.kill(trainer._hub)
            time.sleep(0.5)
        elif order == "orphans":
            zygote = _zygote_of(cluster, hub_node)
            os.kill(zygote, signal.SIGSTOP)
        cluster.kill_node(hub_node)
        th.join(timeout=120)
        if zygote is not None:
            os.kill(zygote, signal.SIGKILL)  # its workers then follow
        assert not th.is_alive(), "elastic fit() wedged"
        res = box["res"]
        assert res.error is None, res.error
        assert [r["direction"] for r in trainer.reshape_log] == ["shrink"], trainer.reshape_log
        assert res.metrics["elastic"]["disk_restores"] == 0
        assert [m["step"] for m in res.metrics_history] == list(range(24))
        state = trainer.final_state()
        assert np.array_equal(state["w"], _expected_w(DIM, 24, 4))
        assert np.array_equal(state["opt"]["m"], np.full(DIM, 24.0))
    finally:
        set_runtime(None)
        try:
            rt.shutdown()
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()


def test_lost_seal_wave_is_not_picked_again(monkeypatch):
    """The port's own case (ROADMAP Queue C 6): with buddy replication off,
    rank 1's ZeRO shards exist only on its node, so its death loses every
    wave's copy while the head's directory still answers their sizes. A
    seal counts as live only with a copy on a node not seen dead, so no
    wave is picked and the run ends (here with no state to restore)
    instead of re-picking a lost wave forever."""
    from ray_tpu_torch import train
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "2.0")
    monkeypatch.setenv("RAY_TPU_ELASTIC_BUDDY_REPLICATE", "0")
    DIM = 1 << 18

    def el_init(config):
        d = int(config["dim"])
        return {"w": np.zeros(d), "opt": {"m": np.zeros(d)}}

    def el_step(state, step, gang, config):
        d = int(config["dim"])
        partials = {v: {"g": np.full(d, float((v + step) % 7))} for v in gang.owned_shards()}
        g = gang.allreduce_shards(partials)
        time.sleep(float(config["step_sleep"]))
        return (
            {"w": state["w"] + g["g"], "opt": {"m": state["opt"]["m"] + 1.0}},
            {"step": step, "world": gang.world, "w0": float(state["w"][0])},
        )

    cluster = Cluster(use_device_scheduler=False)
    cluster.add_node({"CPU": 2.0}, num_workers=2)
    cluster.add_node({"CPU": 2.0}, num_workers=2)
    rt = cluster.client()
    set_runtime(rt)
    try:
        trainer = train.ElasticTrainer(
            el_init, el_step, total_steps=40,
            train_loop_config={"dim": DIM, "step_sleep": 0.1},
            elastic_config=train.ElasticConfig(
                min_workers=1, max_workers=2, virtual_shards=4, seal_interval_steps=2,
                elastic_shard_rules=(r"^opt/m$",), grow=False,
                placement_strategy="STRICT_SPREAD", resources_per_worker={"CPU": 1.0}),
        )
        box = {}
        th = threading.Thread(target=lambda: box.update(res=trainer.fit()))
        th.start()
        deadline = time.monotonic() + 60
        while trainer.progress()["step"] < 8 and time.monotonic() < deadline:
            time.sleep(0.05)
        gangs = rt.head.call("QueryState", {"kind": "gangs"})
        cluster.kill_node(gangs[trainer.gang_id]["members"]["1"])
        th.join(timeout=120)
        assert not th.is_alive(), "elastic fit() re-picked a lost seal wave"
        res = box["res"]
        assert res.error is not None and "no restorable state" in str(res.error)
        assert res.metrics["elastic"]["generations"] <= 15, res.metrics["elastic"]
    finally:
        set_runtime(None)
        try:
            rt.shutdown()
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()



def test_inline_sized_seal_stays_live_after_its_node_dies():
    """Queue C 18: a seal small enough for the head to hold inline keeps
    its sealing node in the directory's locations after that node dies.
    It stays live (the head still holds its bytes); an arena seal whose
    only copy was on that node does not (Queue C 6)."""
    from types import SimpleNamespace

    from ray_tpu_torch import config as rcfg
    from ray_tpu_torch.train.elastic import ElasticTrainer

    inline_max = int(rcfg.cfg.inline_object_max)
    sizes = {"small": 1239, "big": inline_max + 1, "lost": 0, "moved": inline_max + 1}
    locs = {"small": ["dead"], "big": ["dead"], "lost": [], "moved": ["dead", "alive"]}
    runtime = SimpleNamespace(
        object_sizes=lambda refs: {r.hex: sizes[r.hex] for r in refs},
        object_locations=lambda refs: {r.hex: locs[r.hex] for r in refs},
    )
    fake = SimpleNamespace(_is_remote=lambda: True, _runtime=lambda: runtime,
                           _recent_dead={"dead": 0.0})
    live = ElasticTrainer._live_hexes(fake, ["small", "big", "lost", "moved"])
    assert live == ["small", "moved"]


def test_add_node_returns_once_its_own_node_is_registered():
    """Queue C 18: a node killed but not yet declared dead still counts
    as alive at the head, so ``add_node(wait=True)`` waiting for a count
    of live nodes returned before the replacement registered."""
    from ray_tpu_torch.cluster import Cluster

    cluster = Cluster(use_device_scheduler=False)
    try:
        first = cluster.add_node({"CPU": 1.0}, num_workers=1)
        cluster.kill_node(first)
        assert cluster.head.nodes[first].alive  # no verdict yet
        second = cluster.add_node({"CPU": 1.0}, num_workers=1)
        assert second in cluster.head.nodes and cluster.head.nodes[second].alive
    finally:
        cluster.shutdown()


def test_small_seal_wave_restores_after_its_node_dies(monkeypatch):
    """Queue C 18 end to end: with buddy replication off and ``dim`` 64,
    every periodic seal (1,239 bytes) is held inline at the head. After
    rank 1's node dies the gang restores from the last wave and finishes
    at world 1 with the unreshaped run's state, where the version before
    the repair ended with "no restorable state"."""
    from ray_tpu_torch import train
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "2.0")
    monkeypatch.setenv("RAY_TPU_ELASTIC_BUDDY_REPLICATE", "0")

    def el_init(config):
        d = int(config["dim"])
        return {"w": np.zeros(d), "opt": {"m": np.zeros(d)}}

    def el_step(state, step, gang, config):
        d = int(config["dim"])
        partials = {v: {"g": np.full(d, float((v + step) % 7))} for v in gang.owned_shards()}
        g = gang.allreduce_shards(partials)
        time.sleep(float(config["step_sleep"]))
        return (
            {"w": state["w"] + g["g"], "opt": {"m": state["opt"]["m"] + 1.0}},
            {"step": step, "world": gang.world, "w0": float(state["w"][0])},
        )

    total_steps = 24
    cluster = Cluster(use_device_scheduler=False)
    cluster.add_node({"CPU": 2.0}, num_workers=2)
    cluster.add_node({"CPU": 2.0}, num_workers=2)
    rt = cluster.client()
    set_runtime(rt)
    try:
        trainer = train.ElasticTrainer(
            el_init, el_step, total_steps=total_steps,
            train_loop_config={"dim": 64, "step_sleep": 0.08},
            elastic_config=train.ElasticConfig(
                min_workers=1, max_workers=2, virtual_shards=4, seal_interval_steps=2,
                elastic_shard_rules=(r"^opt/m$",), grow=False,
                placement_strategy="STRICT_SPREAD", resources_per_worker={"CPU": 1.0}),
        )
        box = {}
        th = threading.Thread(target=lambda: box.update(res=trainer.fit()))
        th.start()
        deadline = time.monotonic() + 60
        while trainer.progress()["step"] < 8 and time.monotonic() < deadline:
            time.sleep(0.05)
        gangs = rt.head.call("QueryState", {"kind": "gangs"})
        cluster.kill_node(gangs[trainer.gang_id]["members"]["1"])
        th.join(timeout=120)
        assert not th.is_alive(), "elastic fit() wedged after the node kill"
        res = box["res"]
        assert res.error is None, res.error
        el = res.metrics["elastic"]
        assert "shrink" in [r["direction"] for r in el["reshapes"]], el["reshapes"]
        assert el["disk_restores"] == 0
        assert [m["step"] for m in res.metrics_history] == list(range(total_steps))
        state = trainer.final_state()
        assert np.array_equal(state["w"], _expected_w(64, total_steps, 4))
        assert np.array_equal(state["opt"]["m"], np.full(64, float(total_steps)))
    finally:
        set_runtime(None)
        try:
            rt.shutdown()
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()


# ---------------------------------------------------------------------------
# satellites: atomic checkpoints, retry policy, bounded teardown
# ---------------------------------------------------------------------------


def test_checkpoint_from_state_is_atomic(tmp_path):
    from ray_tpu_torch.train import Checkpoint

    path = str(tmp_path / "ckpt")
    Checkpoint.from_state({"w": np.arange(4.0), "meta": {"epoch": 1}}, path)
    assert os.path.isfile(os.path.join(path, "checkpoint_meta.json"))
    Checkpoint.from_state({"w": np.arange(8.0), "meta": {"epoch": 2}}, path)
    state = Checkpoint(path).load_state()
    assert state["meta"]["epoch"] == 2 and state["w"].shape == (8,)

    class Unpicklable:
        def __reduce__(self):
            raise RuntimeError("boom mid-write")

    crash = str(tmp_path / "crash")
    with pytest.raises(RuntimeError, match="boom"):
        Checkpoint.from_state(
            {"a": np.zeros(2), "b": Unpicklable()}, crash
        )
    assert not os.path.exists(crash)
    assert [d for d in os.listdir(tmp_path) if "crash" in d] == []


def test_latest_checkpoint_path_skips_incomplete_dirs(tmp_path):
    import json

    from ray_tpu_torch.train.trainer import TorchTrainer

    trial = tmp_path / "trial"
    trial.mkdir()
    good = trial / "checkpoint_000001"
    good.mkdir()
    (good / "checkpoint_meta.json").write_text(json.dumps({}))
    half = trial / "checkpoint_000002"  # newer but no commit marker
    half.mkdir()
    (half / "w.npz").write_bytes(b"partial")
    t = TorchTrainer(lambda config: None)
    assert t._latest_checkpoint_path(str(trial)) == str(good)
    (trial / "_latest_checkpoint").write_text(str(half))
    assert t._latest_checkpoint_path(str(trial)) == str(good)
    assert t._latest_checkpoint_path(str(tmp_path / "missing")) is None


def test_max_failures_minus_one_retries_forever(rt, tmp_path, monkeypatch):
    from ray_tpu_torch import train
    from ray_tpu_torch.train import (
        FailureConfig,
        RunConfig,
        ScalingConfig,
        TorchTrainer,
    )

    monkeypatch.setattr(TorchTrainer, "RETRY_BACKOFF_BASE_S", 0.01)
    monkeypatch.setattr(TorchTrainer, "RETRY_BACKOFF_CAP_S", 0.05)
    marker = tmp_path / "attempts"

    def loop(config):
        n = int(marker.read_text()) if marker.exists() else 0
        marker.write_text(str(n + 1))
        if n < 3:
            raise RuntimeError(f"injected failure {n}")
        train.report({"ok": True, "attempts": n + 1})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="inf-retry",
            storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=-1),
        ),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["attempts"] == 4


def test_teardown_bounded_when_kill_wedges(monkeypatch):
    from ray_tpu_torch.train import trainer as trainer_mod
    from ray_tpu_torch.train.trainer import TorchTrainer

    t = TorchTrainer(lambda config: None)
    monkeypatch.setattr(TorchTrainer, "TEARDOWN_KILL_DEADLINE_S", 0.5)
    removed = []

    def wedged_kill(w):
        time.sleep(60)  # a kill against a dead node hanging on retries

    monkeypatch.setattr(trainer_mod.ray_tpu_torch, "kill", wedged_kill)
    monkeypatch.setattr(
        trainer_mod.ray_tpu_torch,
        "remove_placement_group",
        lambda pg: removed.append(pg),
    )
    t0 = time.monotonic()
    t._teardown([object(), object()], pg="pg-sentinel")
    took = time.monotonic() - t0
    assert took < 5.0, f"teardown hung {took:.1f}s behind a wedged kill"
    assert removed == ["pg-sentinel"], "bundle reservation leaked"


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _nested_tree():
    rng = np.random.default_rng(2)
    return {
        "b": [rng.standard_normal(3), (np.int32(4), None, [1.5, rng.standard_normal((2, 2))])],
        "a": {"z": np.float32(1.0), "y": rng.standard_normal((5, 3)), "n": None},
        "c": {10: "leaf-string", 2: (rng.standard_normal(6),)},
    }


def _paths_and_specs(elastic, tree, rules):
    paths, leaves, _ = elastic.tree_paths_and_leaves(tree)
    specs = elastic.match_partition_rules(rules, tree)
    return paths, leaves, specs


def test_tree_paths_leaf_order_and_specs_equal_the_reference():
    import jax
    from jax.sharding import PartitionSpec as P

    from ray_tpu.models import transformer as J
    from ray_tpu.train import elastic as jel

    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.train import elastic as el
    from ray_tpu_torch.train import pytree

    tree = _nested_tree()
    jp, jl, _ = jel.tree_paths_and_leaves(tree)
    tp, tl, _ = el.tree_paths_and_leaves(tree)
    assert tp == jp
    assert all(a is b for a, b in zip(tl, jl))
    assert len(tl) == len(jax.tree.leaves(tree))

    rules = [(r"^b/1/2/1$", ("dp", None)), (r"^a/y$", (None, "tp")), (r".", (None,))]
    want = jel.match_partition_rules([(r, P(*s)) for r, s in rules], tree)
    got = el.match_partition_rules(rules, tree)
    want_leaves = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, P))
    got_leaves = pytree.leaves(got, is_leaf=el.is_spec)
    assert [tuple(s) for s in want_leaves] == got_leaves

    small = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=128, max_seq_len=32)
    pj = jax.tree.map(np.asarray, J.init_params(
        J.ModelConfig(dtype=jax.numpy.float32, **small), jax.random.PRNGKey(0)))
    pt = T.params_from_jax(pj, device="cpu")
    jp, jl, _ = jel.tree_paths_and_leaves(pj)
    tp, tl, _ = el.tree_paths_and_leaves(pt)
    assert tp == jp
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(jl, tl))
    rules = [(r"blocks/w[qkv]$", (None, None, "tp")), (r"blocks/wo$", (None, "tp", None)),
             (r"embed$", ("tp", None)), (r".", ())]
    want = jel.match_partition_rules([(r, P(*s)) for r, s in rules], pj)
    got = el.match_partition_rules(rules, pt)
    assert [tuple(s) for s in jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, P))] \
        == pytree.leaves(got, is_leaf=el.is_spec)
    # the model's own spec table, as the rules the port's param_specs give
    specs = T.param_specs(T.ModelConfig(dtype=torch.float32, **small))
    flat_specs = pytree.flatten_with_path(specs, is_leaf=el.is_spec)[0]
    model_rules = [(f"^{pytree.path_str(p)}$", s) for p, s in flat_specs]
    got = el.match_partition_rules(model_rules, pt)
    want = jel.match_partition_rules([(r, P(*s)) for r, s in model_rules], pj)
    assert [tuple(s) for s in jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, P))] \
        == pytree.leaves(got, is_leaf=el.is_spec)


def test_split_sizes_equal_array_split():
    from ray_tpu.train.elastic import _split_sizes as jsplit

    from ray_tpu_torch.train.elastic import _split_sizes

    for n in range(0, 40):
        for parts in range(1, 9):
            want = [len(c) for c in np.array_split(np.arange(n), parts)]
            assert _split_sizes(n, parts) == want == jsplit(n, parts), (n, parts)
            t = torch.arange(n)
            assert [len(c) for c in t.split(_split_sizes(n, parts))] == want


def test_sealed_state_regathers_equal_in_both_packages(rt, monkeypatch):
    """The same numpy state sealed by each package at world 1 and 2
    regathers to equal leaves; through the port's device plane the same
    state as tensors regathers to the same bytes, plane on or off."""
    import ray_tpu
    from ray_tpu.train import elastic as jel

    from ray_tpu_torch.train import elastic as el

    rng = np.random.default_rng(4)
    state = {
        "w": rng.standard_normal((37, 8)).astype(np.float32),
        "opt": {"m": rng.standard_normal(513).astype(np.float32), "count": 7},
    }
    rules = (r"^opt/m$",)

    def run(mod, st, world):
        hexes = [
            mod.seal_rank_state(st, 5, r, world, 4, elastic_shard_rules=rules)[0]
            for r in range(world)
        ]
        rebuilt, step = mod.regather_state([mod.fetch_sealed(h) for h in hexes])
        assert step == 5
        return rebuilt

    ray_tpu.init(num_nodes=1, resources_per_node={"CPU": 4})
    try:
        for world in (1, 2):
            want = run(jel, state, world)
            got = run(el, state, world)
            for get in (lambda s: s["w"], lambda s: s["opt"]["m"]):
                a, b = np.asarray(get(want)), np.asarray(get(got))
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            assert got["opt"]["count"] == want["opt"]["count"] == 7
            tstate = {"w": torch.from_numpy(state["w"]),
                      "opt": {"m": torch.from_numpy(state["opt"]["m"]).to(torch.bfloat16),
                              "count": 7}}
            for plane in ("1", "0"):
                monkeypatch.setenv("RAY_TPU_DEVICE_PLANE", plane)
                dev = run(el, tstate, world)
                assert isinstance(dev["opt"]["m"], torch.Tensor)
                assert dev["opt"]["m"].dtype == torch.bfloat16
                assert torch.equal(dev["w"], tstate["w"])
                assert torch.equal(dev["opt"]["m"].view(torch.int16),
                                   tstate["opt"]["m"].view(torch.int16))
            monkeypatch.delenv("RAY_TPU_DEVICE_PLANE")
    finally:
        ray_tpu.shutdown()


@pytest.mark.parametrize("resize", [False, True], ids=["steady", "shrink-grow"])
def test_fit_elastic_equals_the_reference_bit_for_bit(rt, resize):
    """Both packages' ElasticTrainer on the reference tests' own numpy
    step: bit-equal final ``w`` and ``opt/m`` and the same ``w0`` stream,
    with and without the 2 -> 1 -> 2 resize."""
    import ray_tpu
    import test_elastic_train as ref_tests
    from ray_tpu import train as jtrain

    from ray_tpu_torch import train

    total = 20  # the reference test's run and pacing
    kw = dict(total_steps=total, shard_rules=(r"^opt/m$",), init_fn=ref_tests._el_init,
              step_fn=ref_tests._el_step)
    if resize:
        kw.update(resizes=SHRINK_GROW, step_sleep=0.15)
    ray_tpu.init(num_nodes=2, resources_per_node={"CPU": 8, "memory": float(1 << 30)})
    try:
        jt, jres = _fit_elastic(train=jtrain, **kw)
        jstate = jt.final_state()
    finally:
        ray_tpu.shutdown()
    pt, pres = _fit_elastic(train=train, **kw)
    pstate = pt.final_state()
    if resize:
        for t in (jt, pt):
            directions = [r["direction"] for r in t.reshape_log]
            assert "shrink" in directions and "grow" in directions, directions
    assert [m["step"] for m in pres.metrics_history] == list(range(total))
    assert [m["w0"] for m in pres.metrics_history] == [m["w0"] for m in jres.metrics_history]
    assert pstate["w"].tobytes() == jstate["w"].tobytes()
    assert pstate["opt"]["m"].tobytes() == jstate["opt"]["m"].tobytes()


LM_CONFIG = {
    "model": dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
                  d_ff=64, max_seq_len=16, dtype="float32"),
    "device": "cpu", "seed": 3, "batch": 2, "seq": 9, "lr": 1e-2,
}


def _lm_step_paced(state, step, gang, config):
    from ray_tpu_torch.train import programs

    time.sleep(float(config.get("step_sleep", 0.0)))
    return programs.lm_step(state, step, gang, config)


def test_transformer_shrink_grow_bit_exact_and_loss_equals_jax(rt):
    """The ROADMAP gate on the CPU: a small transformer trained by
    ElasticTrainer, shrunk 2 -> 1 -> 2 with its Adam moments sealed
    ZeRO-style, ends bit-exact against the unreshaped run and the
    one-process run (parameters, moments, every step's loss); its first
    loss equals JAX's loss_fn on the same parameters within 1e-5."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as J
    from ray_tpu_torch.train import programs, pytree

    total = 20  # paced as the reference's shrink/grow pin
    kw = dict(total_steps=total, shard_rules=(r"^opt/",), init_fn=programs.lm_init,
              step_fn=_lm_step_paced)
    _, ref = _fit_elastic(config=dict(LM_CONFIG), **kw)
    trainer, res = _fit_elastic(config=dict(LM_CONFIG, step_sleep=0.15),
                                resizes=SHRINK_GROW, **kw)
    directions = [r["direction"] for r in trainer.reshape_log]
    assert "shrink" in directions and "grow" in directions, directions
    assert res.metrics["elastic"]["disk_restores"] == 0
    assert [m["step"] for m in res.metrics_history] == list(range(total))
    losses = [m["loss"] for m in res.metrics_history]
    assert losses == [m["loss"] for m in ref.metrics_history]
    one, one_losses = programs.lm_reference(LM_CONFIG, total, 4)
    assert losses == one_losses
    assert losses[-1] < losses[0]
    final = trainer.final_state()
    for a, b in zip(pytree.leaves(final), pytree.leaves(one)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the first loss against JAX's loss_fn: the mean of the four shards'
    cfg = programs.model_config(LM_CONFIG)
    jcfg = J.ModelConfig(**dict(LM_CONFIG["model"], dtype=jnp.float32))
    params = jax.tree.map(lambda x: jnp.asarray(x.numpy()),
                          programs.lm_init(LM_CONFIG)["params"])
    want = np.mean([
        float(J.loss_fn(params, jnp.asarray(programs.lm_tokens(LM_CONFIG, 0, v).numpy()), jcfg))
        for v in range(4)
    ])
    assert cfg.vocab_size == jcfg.vocab_size
    assert abs(losses[0] - want) <= 1e-5, (losses[0], want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_update_equals_optax(dtype):
    """``programs.adam_update`` is ``optax.adam(lr)`` then
    ``optax.apply_updates``: the same parameters, moments and step count
    after 40 steps on the same gradients, bit for bit, optax run outside
    ``jit`` so each of its ops rounds to the parameters' dtype."""
    import jax.numpy as jnp
    import optax

    from ray_tpu_torch.train import programs, pytree

    lr = 3e-3
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 5), "b": (7,), "c": {"d": (2, 2, 4)}}
    init = _jtree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
    grads = [_jtree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
             for _ in range(40)]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)

    def to_t(x):
        return torch.from_numpy(x).to(tdt)

    def to_j(x):
        return jnp.asarray(x).astype(jdt)

    params = pytree.tree_map(to_t, init)
    state = {"params": params, "opt": {"m": pytree.tree_map(torch.zeros_like, params),
                                       "v": pytree.tree_map(torch.zeros_like, params),
                                       "t": torch.zeros((), dtype=torch.int32)}}
    jparams = _jtree_map(to_j, init)
    opt = optax.adam(lr)
    jopt = opt.init(jparams)
    for g in grads:
        state = programs.adam_update(state, pytree.leaves(pytree.tree_map(to_t, g)), lr)
        upd, jopt = opt.update(_jtree_map(to_j, g), jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)

    def f32(x):
        return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))

    adam = jopt[0]
    for got, want in ((state["params"], jparams), (state["opt"]["m"], adam.mu),
                      (state["opt"]["v"], adam.nu)):
        for a, b in zip(pytree.leaves(got), _jleaves(want)):
            assert a.dtype == tdt and b.dtype == jdt
            assert np.array_equal(f32(a), f32(b))
    assert int(state["opt"]["t"]) == int(adam.count) == len(grads)


def _jtree_map(fn, tree):
    import jax

    return jax.tree.map(fn, tree, is_leaf=lambda x: isinstance(x, tuple))


def _jleaves(tree):
    import jax

    return jax.tree.leaves(tree)
