"""The port's cluster runtime held against the JAX package's, on the CPU.

Three parities, each with both packages fed the same seeded inputs:

1. **The head's decisions.** Both ``HeadServer``s get the same nodes and
   fake agents (the network is faked, the head's real round, spread,
   affinity and placement-group paths run) and the same lease batches;
   every task and bundle lands on the same node, mapped by node order. A
   fresh pair of heads takes each batch, since the round seed advances
   once a round.
2. **The wire.** ``serialization``'s frames are byte-equal for plain
   payloads (seeded numpy, dicts, the RPC reply); for ``LeaseRequest`` and
   the RPC envelope (``FencedPayload``), whose pickles name their class's
   module, the frames are equal opcode for opcode once the package names
   are mapped, and their out-of-band buffers byte-equal.
3. **End to end.** One fixed workload gives equal values on a two-node
   cluster of each package.

Also here: the port's head raises without CUDA (no host fallback), and a
failing device unpark grants nothing from the host.
"""
import importlib
import logging
import pickletools
import struct
import time

import numpy as np
import pytest

PKGS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's head brings its scheduler up on cuda and raises without it;
    # here both heads run their programs on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------------------
# 1. the head's decisions
# ---------------------------------------------------------------------------


class _FakeAgentClient:
    """Stands in for an agent RpcClient: grants every lease and prepares
    every bundle, recording which task landed on which node."""

    def __init__(self, node_id, granted):
        self.node_id = node_id
        self._granted = granted

    def call(self, method, payload=None, timeout=None, **kw):
        if method == "ExecuteLeaseBatch":
            self._granted.update({s.task_id: self.node_id for s in payload})
            return {"statuses": ["granted"] * len(payload)}
        if method == "ExecuteLease":
            self._granted[payload.task_id] = self.node_id
            return {"status": "granted"}
        if method == "PrepareBundles":
            return {"ok": True}
        return {}

    def close(self):
        pass


def _seeded_nodes(seed=11, n=6):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n):
        res = {"CPU": float(rng.choice([4.0, 8.0, 16.0]))}
        if rng.random() < 0.4:
            res["GPU"] = float(rng.choice([1.0, 2.0]))
        res["memory"] = float(rng.choice([8.0, 16.0, 32.0]))
        nodes.append((f"n{i}", res))
    return nodes


def _head_with_fake_nodes(pkg, node_specs):
    common = _mod(pkg, "cluster.common")
    head = _mod(pkg, "cluster.head").HeadServer(dashboard_port=None)
    granted = {}
    with head._cond:
        for nid, res in node_specs:
            head.nodes[nid] = common.NodeInfo(node_id=nid, address="", resources=res)
            head.view.add_node(nid, res)
            head._clients[nid] = _FakeAgentClient(nid, granted)
    return head, granted


def _lease(pkg, i, resources, strategy=None):
    return _mod(pkg, "cluster.common").LeaseRequest(
        task_id=f"t{i:04d}", name="t", payload=b"", return_ids=[],
        resources=dict(resources), max_retries=0, strategy=strategy,
    )


def _mixed_batch(pkg, seed=3, n=64):
    rng = np.random.default_rng(seed)
    shapes = [
        {"CPU": 1.0}, {"CPU": 2.0}, {"CPU": 0.5, "memory": 2.0},
        {"CPU": 1.0, "GPU": 1.0}, {"CPU": 4.0}, {"CPU": 0.25},
    ]
    return [_lease(pkg, i, shapes[int(rng.integers(len(shapes)))]) for i in range(n)]


def _spread_batch(pkg, seed=5, n=24):
    rng = np.random.default_rng(seed)
    strat = _mod(pkg, "core.scheduling_strategies")
    out = [
        _lease(pkg, i, {"CPU": float(rng.choice([0.5, 1.0]))}, strategy="SPREAD")
        for i in range(n)
    ]
    # one hard and one soft node-affinity lease
    out.append(_lease(pkg, n, {"CPU": 1.0},
                      strat.NodeAffinitySchedulingStrategy(node_id="n3", soft=False)))
    out.append(_lease(pkg, n + 1, {"CPU": 1.0},
                      strat.NodeAffinitySchedulingStrategy(node_id="n9", soft=True)))
    return out


def _settle(head, granted, n, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with head._cond:
            if (
                len(granted) + len(head._infeasible) >= n
                and not head._pending
                and not head._deferred_rounds
                and not head._scheduling_batch
            ):
                return
        time.sleep(0.05)
    raise TimeoutError(f"head did not settle: {len(granted)} of {n} granted")


def _decisions(pkg, make_batch):
    head, granted = _head_with_fake_nodes(pkg, _seeded_nodes())
    try:
        batch = make_batch(pkg)
        with head._cond:
            head._pending.extend(batch)
            head._cond.notify_all()
        _settle(head, granted, len(batch))
        with head._cond:
            parked = sorted(s.task_id for s in head._infeasible)
        return dict(granted), parked
    finally:
        head.shutdown(stop_agents=False)


@pytest.mark.parametrize("make_batch", [_mixed_batch, _spread_batch], ids=["mixed", "spread"])
def test_head_grants_equal_jax(make_batch):
    (jg, jp), (tg, tp) = (_decisions(pkg, make_batch) for pkg in PKGS)
    assert len(jg) > 0
    assert tg == jg
    assert tp == jp


def _pg_decisions(pkg):
    head, granted = _head_with_fake_nodes(pkg, _seeded_nodes())
    try:
        groups = [
            ([{"CPU": 2.0}, {"CPU": 2.0}, {"CPU": 1.0, "memory": 4.0}], "STRICT_SPREAD"),
            ([{"CPU": 1.0}] * 4 + [{"CPU": 2.0, "GPU": 1.0}], "PACK"),
        ]
        placed = []
        for bundles, strategy in groups:
            pg_id = head._h_create_pg({"bundles": bundles, "strategy": strategy})["pg_id"]
            state = head._pgs[pg_id]
            assert state.ready.wait(60), f"{strategy} group never placed"
            placed.append(list(state.node_per_bundle))
        return placed
    finally:
        head.shutdown(stop_agents=False)


def test_head_placement_groups_equal_jax():
    jax_pg, port_pg = (_pg_decisions(pkg) for pkg in PKGS)
    assert len(set(jax_pg[0])) == 3  # STRICT_SPREAD: distinct nodes
    assert port_pg == jax_pg


# ---------------------------------------------------------------------------
# 2. the wire
# ---------------------------------------------------------------------------


def _wire(pkg):
    return _mod(pkg, "cluster.serialization")


def _plain_payloads(seed=17):
    rng = np.random.default_rng(seed)
    return [
        {"a": rng.standard_normal(4096).astype(np.float32)},
        [rng.integers(0, 255, 8192, dtype=np.uint8) for _ in range(3)],
        np.arange(30000, dtype=np.int64)[::2],
        {"big": rng.standard_normal((128, 128)), "k": [1, 2, 3], "s": "x"},
        [np.full(1024, i, dtype=np.int64) for i in range(70)],
        (True, {"statuses": ["granted"] * 5, "available": {"CPU": 3.5}}),
        {"small": 1},
    ]


@pytest.mark.parametrize("i", range(len(_plain_payloads())))
def test_wire_frames_byte_equal(i):
    obj = _plain_payloads()[i]
    jblob, tblob = (_wire(pkg).dumps(obj) for pkg in PKGS)
    assert tblob == jblob
    # and each package reads the other's frame back to the payload
    for blob, pkg in ((jblob, "ray_tpu_torch"), (tblob, "ray_tpu")):
        assert _same(_wire(pkg).loads(blob), obj)


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _split_frame(blob):
    """(header, pickle, buffers) of an RTP5 frame, or (None, blob, [])
    for a plain pickle (small objects skip the framing)."""
    if blob[:4] != b"RTP5":
        return None, blob, []
    version, nbufs, pkl_len = struct.unpack_from("<HHQ", blob, 4)
    lens = struct.unpack_from(f"<{nbufs}Q", blob, 16)
    off = 16 + 8 * nbufs
    pkl = blob[off:off + pkl_len]
    off += pkl_len
    bufs = []
    for n in lens:
        bufs.append(blob[off:off + n])
        off += n
    assert off == len(blob)
    return (version, nbufs), pkl, bufs


def _ops(pkl):
    """The pickle's opcodes and arguments with the port's package name
    mapped onto the reference's; FRAME lengths are left out (they count
    the names' bytes)."""
    out = []
    for op, arg, _ in pickletools.genops(pkl):
        if op.name == "FRAME":
            continue
        if isinstance(arg, str):
            arg = arg.replace("ray_tpu_torch.", "ray_tpu.")
        out.append((op.name, arg))
    return out


def _classed_payloads(pkg):
    rng = np.random.default_rng(23)
    common = _mod(pkg, "cluster.common")
    rpc = _mod(pkg, "cluster.rpc")
    leases = [
        common.LeaseRequest(
            task_id=f"t{i}", name=f"f{i}", payload=rng.bytes(64 * (i + 1)),
            return_ids=[f"r{i}"], resources={"CPU": 0.5 * (i + 1)},
            arg_ids=[f"a{i}"], client_id="c0",
        )
        for i in range(3)
    ]
    envelope = rpc.FencedPayload(7, {"batch": leases, "x": rng.standard_normal(2048)})
    return leases + [envelope]


def test_wire_lease_and_envelope_frames_equal():
    jobjs, tobjs = (_classed_payloads(pkg) for pkg in PKGS)
    for jo, to in zip(jobjs, tobjs):
        jh, jpkl, jbufs = _split_frame(_wire("ray_tpu").dumps(jo))
        th, tpkl, tbufs = _split_frame(_wire("ray_tpu_torch").dumps(to))
        assert th == jh
        assert tbufs == jbufs
        assert _ops(tpkl) == _ops(jpkl)
        assert b"ray_tpu.cluster" not in tpkl  # the port names its own classes


# ---------------------------------------------------------------------------
# 3. end to end: the same workload on a two-node cluster of each package
# ---------------------------------------------------------------------------


def _inc(x):
    return x + 1


def _make(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _dot(a, b):
    return float(np.dot(a.astype(np.float64), b.astype(np.float64)))


def _checksum(a):
    return a.shape, float(a.astype(np.float64).sum()), float(a[::4097].astype(np.float64).sum())


def _count_up(n):
    for i in range(n):
        yield i * i


class _Acc:
    def __init__(self, start):
        self.total = start

    def add(self, x):
        self.total += x
        return self.total


def _workload(pkg):
    p = importlib.import_module(pkg)
    cluster_mod = _mod(pkg, "cluster")
    set_runtime = _mod(pkg, "core.runtime").set_runtime
    strat = _mod(pkg, "core.scheduling_strategies")
    c = cluster_mod.Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    c.add_node({"CPU": 4.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        out = {}
        inc = p.remote(_inc)
        r = inc.remote(0)
        for _ in range(6):
            r = inc.remote(r)
        out["chain"] = p.get(r, timeout=60)

        nids = sorted(n["NodeID"] for n in p.nodes() if n["Alive"])
        on = [
            strat.NodeAffinitySchedulingStrategy(node_id=nid, soft=False) for nid in nids
        ]
        a = p.remote(_make).options(scheduling_strategy=on[0]).remote(50_000, 1)
        b = p.remote(_make).options(scheduling_strategy=on[1]).remote(50_000, 2)
        out["cross_node"] = p.get(
            p.remote(_dot).options(scheduling_strategy=on[1]).remote(a, b), timeout=60
        )
        big = p.remote(_make).options(scheduling_strategy=on[0]).remote(4 << 20, 3)
        out["big_16mib"] = p.get(
            p.remote(_checksum).options(scheduling_strategy=on[1]).remote(big), timeout=120
        )

        acc = p.remote(_Acc).remote(10)
        out["actor"] = p.get([acc.add.remote(i) for i in range(20)], timeout=60)

        pg = p.placement_group([{"CPU": 1.0}, {"CPU": 1.0}], strategy="STRICT_SPREAD")
        assert pg.wait(60)
        in_pg = [
            p.remote(_inc).options(
                num_cpus=1,
                scheduling_strategy=strat.PlacementGroupSchedulingStrategy(
                    placement_group=pg, placement_group_bundle_index=i
                ),
            ).remote(100 + i)
            for i in range(2)
        ]
        out["pg"] = p.get(in_pg, timeout=60)
        p.remove_placement_group(pg)

        g = p.remote(_count_up).options(num_returns="streaming", num_cpus=0.5).remote(12)
        out["stream"] = [p.get(ref, timeout=60) for ref in g]
        return out
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


def test_end_to_end_values_equal_jax():
    jax_out, port_out = (_workload(pkg) for pkg in PKGS)
    assert jax_out["chain"] == 7
    assert jax_out["big_16mib"][0] == (4 << 20,)
    assert port_out == jax_out


# ---------------------------------------------------------------------------
# no fallback from the card
# ---------------------------------------------------------------------------


def test_head_raises_without_cuda(monkeypatch):
    """With no platform set the head schedules on ``cuda``; this host has
    none, so ``HeadServer()`` raises, naming the platform (the reference
    would degrade to its golden model). ``RAY_TPU_SCHED_PLATFORM=cpu`` and
    the golden model, asked for, both start."""
    import torch

    from ray_tpu_torch.cluster import HeadServer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("RAY_TPU_SCHED_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="'cuda'"):
        HeadServer()
    head = HeadServer(use_device_scheduler=False)
    try:
        assert head.device_state is None
    finally:
        head.shutdown(stop_agents=False)
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
    head = HeadServer()
    try:
        assert head.device_state.device.type == "cpu"
    finally:
        head.shutdown(stop_agents=False)


@pytest.mark.parametrize("ring_slots", [64, 0], ids=["ring_schedule", "shape_slots"])
def test_head_unpark_device_failure_grants_nothing(monkeypatch, caplog, ring_slots):
    """A failing ring round or slot estimate in the head's unpark is a
    failed round: logged as "scheduler round failed", and the parked work
    stays parked. No host scan grants any of it."""
    monkeypatch.setenv("RAY_TPU_SCHED_RING_SLOTS", str(ring_slots))
    head, granted = _head_with_fake_nodes("ray_tpu_torch", [("n0", {"CPU": 64.0})])
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("device round died")

    ds = head.device_state
    monkeypatch.setattr(ds, "ring_schedule", broken)
    monkeypatch.setattr(ds, "shape_slots", broken)
    try:
        parked = [_lease("ray_tpu_torch", i, {"CPU": 1.0}) for i in range(100)]
        with caplog.at_level(logging.ERROR, logger="ray_tpu_torch"), head._cond:
            head._infeasible = list(parked)
            head._last_park_retry = 0.0
            head._parked_at_change = -1
            head._maybe_unpark_locked()
            assert head._infeasible == parked and not head._pending
        time.sleep(0.3)
        assert calls and not granted
        failed = [r for r in caplog.records if "scheduler round failed" in r.getMessage()]
        assert failed and "device round died" in str(failed[0].exc_info[1])
    finally:
        with head._cond:
            head._infeasible = []
        head.shutdown(stop_agents=False)

