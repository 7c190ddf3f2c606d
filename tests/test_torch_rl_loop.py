"""The online-RL loop on the port (``ray_tpu_torch/rl/``), on the CPU.

First the fast cases of ``tests/test_rl_loop.py`` on the port: the
trajectory plane's conservation law and staleness window, the two-phase
(seal -> commit) weights-epoch fence across head crashes at every phase
boundary (WAL replay and standby promotion), the publisher's whole-cycle
retry, the engine's hot-swap drain, and the deterministic fenced loop.
Then the port against the JAX package on the same inputs: prompts,
encoded blocks dtype for dtype, the local ledger's replies, the model
config's dict, the whole loop from the same weights (every trajectory
token-equal, the losses within 1e-5) and one elastic trainer step. Last,
what JAX's immutable arrays gave the reference for free and the port must
keep by building new tensors: a published epoch's stored weights and a
rollout between publishes both stay on the published weights.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.models import transformer as tfm


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's head brings its scheduler up on cuda and raises without
    # it; here it runs on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def _wait_for(cond, timeout=60.0, every=0.1, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(every)
    if not cond():
        raise TimeoutError(f"timed out waiting for {msg}")


SMALL = dict(vocab_size=64, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96,
             max_seq_len=96)
LOOP = dict(d_model=32, n_layers=1, d_ff=64, max_seq_len=64)


def _small_cfg(**over):
    return tfm.ModelConfig(**dict(SMALL, dtype=torch.float32, **over))


def _jax_cfg(**over):
    from ray_tpu.models import transformer as jtfm

    return jtfm.ModelConfig(**dict(SMALL, dtype=jnp.float32, **over))


def _params(mcfg, seed):
    return tfm.init_params(mcfg, torch.Generator().manual_seed(seed), "cpu")


def _jax_params(jcfg, seed):
    """(JAX's init_params(PRNGKey(seed)), the same weights as the port's)."""
    from ray_tpu.models import transformer as jtfm

    pj = jtfm.init_params(jcfg, jax.random.PRNGKey(seed))
    return pj, tfm.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")


def _traj(tid, epoch, toks=(1, 2, 3, 4)):
    from ray_tpu_torch.rl import Trajectory

    return Trajectory(
        traj_id=tid,
        prompt=list(toks[:2]),
        tokens=list(toks),
        weights_epoch=epoch,
        rollout_id="r0",
    )


def _kill_head(head):
    """SIGKILL-equivalent for an in-process HeadServer (as
    Cluster.kill_head): the listener drops mid-flight, no final snapshot
    is flushed — the persistence dir holds only what the WAL already has."""
    head._shutdown = True
    with head._cond:
        head._cond.notify_all()
    head._repl.stop()
    head._server.stop(grace=0)
    if head._pipeline is not None:
        try:
            head._pipeline.stop()
        except Exception:  # noqa: BLE001
            pass
    head._dispatch_pool.shutdown(wait=False, cancel_futures=True)
    try:
        head.jobs.shutdown()
    except Exception:  # noqa: BLE001
        pass
    with head._lock:
        clients = list(head._clients.values())
    for client in clients:
        try:
            client.close()
        except Exception:  # noqa: BLE001
            pass


def _head(tmp_path):
    from ray_tpu_torch.cluster.head import HeadServer

    return HeadServer(port=0, persist_path=str(tmp_path / "h"), use_device_scheduler=False)


# ---------------------------------------------------------------------------
# trajectory plane: dedup, staleness window, idempotent step batches
# ---------------------------------------------------------------------------
def test_feed_staleness_window_boundary_and_dedup():
    """Epoch == committed - K is ON the boundary and kept; older is
    dropped AND counted; duplicate traj_ids never enter ``emitted``;
    the conservation law balances throughout."""
    from ray_tpu_torch.rl import TrajectoryFeed, encode_block

    feed = TrajectoryFeed(staleness_window=2)
    feed.emit(encode_block([_traj("a", 2), _traj("b", 3), _traj("c", 5), _traj("d", 5)]))
    dup = feed.emit(encode_block([_traj("b", 3)]))
    assert dup == {"accepted": 0, "duplicates": 1}
    acct = feed.accounting()
    assert acct["emitted"] == 4 and acct["duplicates"] == 1
    assert acct["unaccounted"] == 0

    # floor = 5 - 2 = 3: epoch 2 dropped, epoch 3 (boundary) kept
    block = feed.take_for_step(0, 8, current_epoch=5, staleness_window=2)
    assert sorted(block["traj_ids"]) == ["b", "c", "d"]
    assert 3 in [int(e) for e in block["epochs"]]
    acct = feed.accounting()
    assert acct["dropped_stale"] == 1
    assert acct["trained"] == 3
    assert acct["unaccounted"] == 0


def test_feed_step_batches_idempotent_including_empty():
    """``take_for_step`` replays return the identical cached block — and
    a step that originally saw an empty buffer stays empty on replay.
    Nothing double-counts."""
    from ray_tpu_torch.rl import TrajectoryFeed, encode_block

    feed = TrajectoryFeed(staleness_window=2)
    assert feed.take_for_step(0, 4) is None
    feed.emit(encode_block([_traj(f"t{i}", 1) for i in range(6)]))
    assert feed.take_for_step(0, 4) is None  # replay: still empty
    b1 = feed.take_for_step(1, 4)
    b1_replay = feed.take_for_step(1, 4)
    assert b1["traj_ids"] == b1_replay["traj_ids"]
    assert np.array_equal(b1["tokens"], b1_replay["tokens"])
    b2 = feed.take_for_step(2, 4)
    assert len(b2["traj_ids"]) == 2
    acct = feed.accounting()
    assert acct["trained"] == 6 and acct["unaccounted"] == 0


# ---------------------------------------------------------------------------
# two-phase publish fence: crash points via persistence replay
# ---------------------------------------------------------------------------
def test_seal_crash_leaves_old_epoch_fully_visible(tmp_path):
    """Head killed AFTER seal but BEFORE commit: the restarted head shows
    the OLD committed epoch with a dangling seal, and a retried publish
    lands exactly one epoch."""
    from ray_tpu_torch.cluster.rpc import RpcClient
    from ray_tpu_torch.rl import WeightsPublisher

    head = _head(tmp_path)
    c = RpcClient(head.address)
    sealed = c.call("WeightsPublishSeal", {"deployment": "pol", "meta": {}}, timeout=10.0)
    assert sealed == {"epoch": 1, "committed": 0}
    c.close()
    _kill_head(head)

    head2 = _head(tmp_path)
    try:
        c2 = RpcClient(head2.address)
        st = c2.call("WeightsEpochGet", {"deployment": "pol"}, timeout=10.0)
        assert st["committed"] == 0
        assert st["sealed"] == {"epoch": 1, "meta": {}}
        c2.close()
        pub = WeightsPublisher("pol", head_address=head2.address)
        try:
            assert pub.publish({"w": 1}) == 1
            assert pub.current_epoch()["committed"] == 1
            assert pub.current_epoch()["sealed"] is None
        finally:
            pub.close()
    finally:
        head2.shutdown()


def test_commit_crash_keeps_new_epoch(tmp_path):
    """Head killed right AFTER commit: the WAL commit record replays; a
    re-commit of the same epoch is idempotent, a never-sealed one stale."""
    from ray_tpu_torch.cluster.rpc import RpcClient

    head = _head(tmp_path)
    c = RpcClient(head.address)
    c.call("WeightsPublishSeal", {"deployment": "pol", "meta": {}}, timeout=10.0)
    r = c.call("WeightsPublishCommit", {"deployment": "pol", "epoch": 1}, timeout=10.0)
    assert r == {"committed": 1, "stale": False}
    c.close()
    _kill_head(head)

    head2 = _head(tmp_path)
    try:
        c2 = RpcClient(head2.address)
        st = c2.call("WeightsEpochGet", {"deployment": "pol"}, timeout=10.0)
        assert st["committed"] == 1 and st["sealed"] is None
        again = c2.call("WeightsPublishCommit", {"deployment": "pol", "epoch": 1}, timeout=10.0)
        assert again == {"committed": 1, "stale": False}
        bogus = c2.call("WeightsPublishCommit", {"deployment": "pol", "epoch": 2}, timeout=10.0)
        assert bogus == {"committed": 1, "stale": True}
        c2.close()
    finally:
        head2.shutdown()


def test_publisher_retries_whole_cycle_on_stale_commit():
    """A commit answered ``stale`` restarts the WHOLE cycle (re-seal,
    re-stash, commit) and exactly one epoch lands."""
    from ray_tpu_torch.rl import WeightsPublisher

    pub = WeightsPublisher("pol")  # LocalEpochLedger
    calls = []

    def lose_seal_once(epoch):
        calls.append(epoch)
        if len(calls) == 1:
            with pub._client._lock:
                pub._client._row("pol")["sealed"] = None

    pub.between_phases = lose_seal_once
    assert pub.publish({"w": 1}) == 1
    assert calls == [1, 1]
    st = pub.current_epoch()
    assert st["committed"] == 1 and st["sealed"] is None
    pub.close()


def test_publish_replicates_to_standby_and_survives_promotion(tmp_path):
    """Committed epochs replicate to the warm standby; after the leader
    dies and the standby promotes onto its port, the SAME publisher keeps
    publishing — the fence only moves forward."""
    from ray_tpu_torch.cluster.standby import StandbyHead
    from ray_tpu_torch.rl import WeightsPublisher

    head = _head(tmp_path)
    sb = StandbyHead(head.address, auto_promote=False)
    head2 = None
    pub = WeightsPublisher("pol", head_address=head.address)
    try:
        assert pub.publish({"w": 1}) == 1
        assert pub.publish({"w": 2}) == 2
        _wait_for(
            lambda: sb.tables_snapshot().get("weights_epochs", {}).get("pol", {})
            .get("committed") == 2,
            timeout=20.0,
            msg="weights_epochs replicated to standby",
        )
        _kill_head(head)
        head2 = sb.promote()
        assert pub.publish({"w": 3}) == 3
        st = pub.current_epoch()
        assert st["committed"] == 3 and st["sealed"] is None
    finally:
        pub.close()
        sb.shutdown()
        if head2 is not None:
            head2.shutdown()


def test_head_killed_inside_publish_window_is_atomic(tmp_path):
    """The leader dies BETWEEN seal and commit, the standby promotes on
    the same port, and the in-flight publish retries until exactly one
    epoch is committed."""
    from ray_tpu_torch.cluster.rpc import RpcClient
    from ray_tpu_torch.cluster.standby import StandbyHead
    from ray_tpu_torch.rl import WeightsPublisher

    head = _head(tmp_path)
    sb = StandbyHead(head.address, auto_promote=False)

    def _registered():
        c = RpcClient(head.address)
        try:
            st = c.call("QueryState", {"kind": "replication"}, timeout=5.0)
            return bool(st.get("standbys"))
        finally:
            c.close()

    _wait_for(_registered, timeout=15.0, msg="standby registered")
    pub = WeightsPublisher("pol", head_address=head.address)
    killed = []

    def kill_in_window(epoch):
        if killed:
            return
        killed.append(epoch)
        _kill_head(head)
        sb.promote()

    pub.between_phases = kill_in_window
    head2 = None
    try:
        epoch = pub.publish({"w": 1})
        head2 = sb.promoted
        assert killed == [1]
        assert epoch == 1
        st = pub.current_epoch()
        assert st["committed"] == epoch and st["sealed"] is None
    finally:
        pub.close()
        sb.shutdown()
        if head2 is not None:
            head2.shutdown()


# ---------------------------------------------------------------------------
# engine hot-swap: token-exact drain + bounded drain with typed shed
# ---------------------------------------------------------------------------
def _engine(mcfg, params, **kw):
    from ray_tpu_torch.llm.continuous import ContinuousBatchingEngine

    return ContinuousBatchingEngine(mcfg, params, max_batch=2, page_size=8, n_pages=32,
                                    device="cpu", **kw)


def test_swap_params_mid_stream_drains_token_exact():
    """Requests in flight when ``swap_params`` lands finish on the OLD
    weights (token-exact vs a never-swapped twin); requests after the
    swap match the NEW-weights twin."""
    from ray_tpu_torch.llm.engine import GenerationConfig

    mcfg = _small_cfg()
    old_params, new_params = _params(mcfg, 7), _params(mcfg, 8)
    gen = GenerationConfig(max_new_tokens=8, temperature=0.0)
    prompt = [1, 2, 3, 4]
    ref_old = _engine(mcfg, old_params).generate_ids([prompt], gen)[0]
    ref_new = _engine(mcfg, new_params).generate_ids([prompt], gen)[0]

    eng = _engine(mcfg, old_params, model_id="epoch-0")
    rid = eng.submit(list(prompt), gen)
    for _ in range(3):
        eng.step()
    assert rid not in eng.results
    epoch = eng.swap_params(new_params, model_id="epoch-1")
    assert epoch == 1 and eng.model_id == "epoch-1"
    assert eng.results.pop(rid) == ref_old
    assert eng.generate_ids([prompt], gen)[0] == ref_new


def test_swap_drain_deadline_force_evicts_and_sheds(monkeypatch):
    """A wedged drain is bounded: past ``serve_swap_drain_deadline_s``
    still-active slots are force-evicted with their partial output, pages
    freed, and the swap lands; admission during an expired drain sheds
    typed ``Overloaded(reason="weights_swap")``."""
    from ray_tpu_torch.llm.engine import GenerationConfig
    from ray_tpu_torch.serve.admission import Overloaded

    monkeypatch.setenv("RAY_TPU_SERVE_SWAP_DRAIN_DEADLINE_S", "0.0001")
    mcfg = _small_cfg()
    eng = _engine(mcfg, _params(mcfg, 7))
    eng.generate_ids([[1, 2, 3]], GenerationConfig(max_new_tokens=1))
    free_before = len(eng.pool._free)
    rid = eng.submit([1, 2, 3, 4], GenerationConfig(max_new_tokens=64))
    eng.step()
    eng.step()
    epoch = eng.swap_params(_params(mcfg, 8), model_id="epoch-1")
    assert epoch >= 1
    assert eng.swap_force_evicted == 1
    out = eng.results.pop(rid)
    assert 0 < len(out) < 64
    assert not any(s.active for s in eng.slots)
    assert len(eng.pool._free) == free_before
    assert eng.stats()["swap_force_evicted"] == 1

    eng._swapping = True
    eng._swap_started = time.monotonic() - 10.0
    try:
        with pytest.raises(Overloaded) as ei:
            eng.submit([1, 2, 3], GenerationConfig(max_new_tokens=4))
        assert ei.value.reason == "weights_swap"
        assert ei.value.retry_after_s > 0
    finally:
        eng._swapping = False
        eng._swap_started = None


# ---------------------------------------------------------------------------
# the in-process loop: deterministic fenced cycle
# ---------------------------------------------------------------------------
LC = dict(n_rollout_workers=2, prompts_per_step=2, prompt_len=6, max_new_tokens=6,
          batch_size=4, total_steps=6, seed=11, publish_interval=2, staleness_window=2)


def test_online_rl_loop_fenced_and_deterministic():
    """Two loops built from identical inputs produce identical loss
    curves; every published epoch reaches every rollout worker; the
    conservation law balances at the end."""
    from ray_tpu_torch.rl import OnlineRLLoop, RLLoopConfig

    mcfg = _small_cfg(**LOOP)
    params = _params(mcfg, 5)
    lc = RLLoopConfig(**LC)

    def run_once():
        loop = OnlineRLLoop(mcfg, params, lc, device="cpu")
        try:
            res = loop.run()
            return (res, [w.weights_epoch for w in loop.workers],
                    [w.engine.model_id for w in loop.workers])
        finally:
            loop.close()

    res_a, epochs_a, models_a = run_once()
    res_b, _, _ = run_once()
    assert res_a["weights_epoch"] == 3
    assert epochs_a == [3, 3]
    assert models_a == ["epoch-3", "epoch-3"]
    assert res_a["losses"] == res_b["losses"]
    assert len(res_a["losses"]) == 6
    assert res_a["accounting"]["unaccounted"] == 0
    assert len(res_a["publish_to_first_token_ms"]) == 3
    assert res_a["samples_trained"] == 24


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------
def test_make_prompt_equals_the_reference():
    from ray_tpu.rl import make_prompt as jmake
    from ray_tpu_torch.rl import make_prompt

    for args in [(11, 0, 0, 0, 6, 64), (3, 7, 1, 1, 6, 32000), (0, 5, 3, 2, 12, 96),
                 (2**20, 99, 7, 9, 8, 258)]:
        assert make_prompt(*args) == jmake(*args)


def test_encode_block_equals_the_reference_dtype_for_dtype():
    from ray_tpu.rl import Trajectory as JT, decode_block as jdecode, encode_block as jencode
    from ray_tpu_torch.rl import Trajectory, decode_block, encode_block

    specs = [("a", [5, 6], [5, 6, 7, 8, 9], 3, "r0", 11), ("b", [1], [1, 2], 4, "r1", 2**40),
             ("c", [9, 9, 9], [9, 9, 9], 0, "r0", 0)]
    mine = encode_block([Trajectory(*s) for s in specs])
    ref = jencode([JT(*s) for s in specs])
    assert sorted(mine) == sorted(ref)
    for k in ("tokens", "lengths", "prompt_lengths", "epochs", "seeds"):
        assert mine[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(mine[k], ref[k])
    assert mine["traj_ids"] == ref["traj_ids"] and mine["rollout_ids"] == ref["rollout_ids"]
    assert [t.__dict__ for t in decode_block(mine)] == [t.__dict__ for t in jdecode(ref)]
    empty, jempty = encode_block([]), jencode([])
    assert empty["tokens"].shape == jempty["tokens"].shape == (0, 1)


def test_local_epoch_ledger_replies_equal_the_reference():
    from ray_tpu.rl import LocalEpochLedger as JL
    from ray_tpu_torch.rl import LocalEpochLedger

    script = [
        ("WeightsEpochGet", {"deployment": "p"}),
        ("WeightsPublishCommit", {"deployment": "p", "epoch": 1}),  # never sealed
        ("WeightsPublishSeal", {"deployment": "p", "meta": {"model": "m"}}),
        ("WeightsEpochGet", {"deployment": "p"}),
        ("WeightsPublishCommit", {"deployment": "p", "epoch": 2}),  # stale epoch
        ("WeightsPublishCommit", {"deployment": "p", "epoch": 1}),
        ("WeightsPublishCommit", {"deployment": "p", "epoch": 1}),  # lost reply
        ("WeightsPublishSeal", {"deployment": "p"}),
        ("WeightsPublishSeal", {"deployment": "q", "meta": {"model": "x"}}),
        ("WeightsEpochGet", {"deployment": "p"}),
        ("WeightsPublishCommit", {"deployment": "p", "epoch": 2}),
        ("WeightsEpochGet", {"deployment": "p"}),
        ("WeightsEpochGet", {"deployment": "q"}),
    ]
    mine, ref = LocalEpochLedger(), JL()
    for method, req in script:
        assert mine.call(method, dict(req)) == ref.call(method, dict(req)), (method, req)
    with pytest.raises(ValueError):
        mine.call("Nope", {"deployment": "p"})


def test_model_config_dict_equals_the_reference():
    from ray_tpu.models import transformer as jtfm
    from ray_tpu.rl import model_config_from_dict as jfrom, model_config_to_dict as jto
    from ray_tpu_torch.rl import model_config_from_dict, model_config_to_dict

    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        mine = model_config_to_dict(tfm.ModelConfig(dtype=tdt, n_layers=2))
        ref = jto(jtfm.ModelConfig(dtype=jdt, n_layers=2))
        assert mine == ref
        assert model_config_from_dict(mine) == tfm.ModelConfig(dtype=tdt, n_layers=2)
        assert jfrom(mine).dtype == jnp.dtype(jdt)


def _step_tokens(loop):
    return [np.asarray(loop.feed._step_cache[s]["tokens"]) for s in sorted(loop.feed._step_cache)]


def test_online_rl_loop_equals_the_reference():
    """The reference test's f32 model and loop, the same weights in both
    packages: every trajectory token-equal, the losses within 1e-5, the
    epochs and the accounting equal."""
    from ray_tpu.rl import OnlineRLLoop as JLoop, RLLoopConfig as JLC
    from ray_tpu_torch.rl import OnlineRLLoop, RLLoopConfig

    jcfg = _jax_cfg(**LOOP)
    pj, pt = _jax_params(jcfg, 5)
    jloop = JLoop(jcfg, pj, JLC(**LC))
    loop = OnlineRLLoop(_small_cfg(**LOOP), pt, RLLoopConfig(**LC), device="cpu")
    try:
        jres, res = jloop.run(), loop.run()
    finally:
        jloop.close()
        loop.close()
    mine, ref = _step_tokens(loop), _step_tokens(jloop)
    assert len(mine) == len(ref) == 6
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=0, atol=1e-5)
    assert res["weights_epoch"] == jres["weights_epoch"] == 3
    assert res["accounting"] == jres["accounting"]
    assert res["stale_dropped_frac"] == jres["stale_dropped_frac"]
    assert ([w.weights_epoch for w in loop.workers]
            == [w.weights_epoch for w in jloop.workers])


class _StubGang:
    """A gang of one whose collective records what it was handed."""

    world = 1

    def __init__(self):
        self.partials = None

    def owned_shards(self):
        return [0, 1]

    def allreduce_shards(self, partials):
        self.partials = partials
        return partials


class _StubHandle:
    """An actor handle over a local object: ``handle.m.remote(...)``
    returns the value; the JAX package's ``ray_tpu.get`` is stubbed to
    pass it through."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        fn = getattr(self._obj, name)
        return type("M", (), {"remote": staticmethod(fn)})


def test_elastic_rl_step_equals_the_reference(monkeypatch):
    """One elastic RL step from the same weights and the same feed batch:
    the port's through a real feed actor on its local runtime, JAX's
    through a stub handle. The loss and every new parameter within 1e-5."""
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.rl import TrajectoryFeed as JFeed, elastic_rl_step as jstep
    from ray_tpu.rl import model_config_to_dict as jto
    from ray_tpu_torch.rl import TrajectoryFeed, elastic_rl_init, elastic_rl_step
    from ray_tpu_torch.rl import encode_block, model_config_to_dict

    jcfg = _jax_cfg(**LOOP)
    pj, pt = _jax_params(jcfg, 3)
    rng = np.random.default_rng(0)
    trajs = [_traj(f"t{i}", 0, tuple(int(x) for x in rng.integers(1, 64, 12)))
             for i in range(4)]
    base = dict(seed=3, batch_size=4, lr=0.01, feed_actor="rl-feed")

    jfeed = JFeed(2)
    jfeed.emit(encode_block(trajs))
    monkeypatch.setattr(ray_tpu, "get_actor", lambda name: _StubHandle(jfeed))
    monkeypatch.setattr(ray_tpu, "get", lambda x, timeout=None: x)
    jstate, jm = jstep({"params": pj}, 0, _StubGang(), dict(base, model=jto(jcfg)))

    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4})
    try:
        feed = ray_tpu_torch.remote(TrajectoryFeed).options(name="rl-feed").remote(2)
        ray_tpu_torch.get(feed.emit.remote(encode_block(trajs)), timeout=30)
        config = dict(base, model=model_config_to_dict(_small_cfg(**LOOP)), device="cpu")
        assert set(elastic_rl_init(config)["params"]) == set(pt)
        gang = _StubGang()
        state, m = elastic_rl_step({"params": pt}, 0, gang, config)
    finally:
        ray_tpu_torch.shutdown()
    assert sorted(gang.partials) == [0, 1]
    assert abs(m["loss"] - jm["loss"]) < 1e-5
    assert m["traj_ids"] == jm["traj_ids"] == [f"t{i}" for i in range(4)]
    assert (m["tok_max"], m["world"], m["stop"], m["params_finite"]) == (
        jm["tok_max"], jm["world"], jm["stop"], jm["params_finite"])
    ref = tfm.params_from_jax(jax.tree.map(np.asarray, jstate["params"]), device="cpu")
    from ray_tpu_torch.train import pytree

    for a, b in zip(pytree.leaves(state["params"]), pytree.leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# what JAX's immutable arrays gave the reference: snapshots stay snapshots
# ---------------------------------------------------------------------------
def _clone(tree):
    from ray_tpu_torch.train import pytree

    return pytree.tree_map(lambda t: t.detach().clone(), tree)


def _equal(a, b):
    from ray_tpu_torch.train import pytree

    return all(torch.equal(x, y) for x, y in zip(pytree.leaves(a), pytree.leaves(b)))


def test_published_epoch_keeps_its_weights_under_later_training():
    from ray_tpu_torch.rl import OnlineRLLoop, RLLoopConfig

    mcfg = _small_cfg(**LOOP)
    loop = OnlineRLLoop(mcfg, _params(mcfg, 5), RLLoopConfig(**dict(LC, publish_interval=1,
                                                                    total_steps=1)),
                        device="cpu")
    try:
        loop.run()
        published = _clone(loop.publisher.params_for(1))
        assert _equal(published, loop.params)
        for step in range(1, 4):
            loop._collect(step)
            assert loop._train_step(step) is not None
        assert not _equal(published, loop.params)  # training moved on
        assert _equal(loop.publisher.params_for(1), published)
        for w in loop.workers:
            assert _equal(w.engine.params, published)
    finally:
        loop.close()


def test_rollout_between_publishes_runs_on_the_published_weights():
    from ray_tpu_torch.llm.engine import GenerationConfig
    from ray_tpu_torch.rl import OnlineRLLoop, RLLoopConfig

    mcfg = _small_cfg(**LOOP)
    init = _params(mcfg, 5)
    snapshot = _clone(init)
    loop = OnlineRLLoop(mcfg, init, RLLoopConfig(**LC), device="cpu")
    try:
        loop._collect(0)
        loop._train_step(0)  # trained, not yet published (interval 2)
        assert loop.epoch == 0 and not _equal(loop.params, snapshot)
        assert _equal(init, snapshot)
        for w in loop.workers:
            assert w.weights_epoch == 0 and _equal(w.engine.params, snapshot)
        prompt = [3, 1, 4, 1, 5, 9]
        block = loop.workers[0].rollout([{"traj_id": "x", "prompt": prompt, "seed": 0}], 6)
        fresh = _engine(mcfg, snapshot).generate_ids([prompt], GenerationConfig(max_new_tokens=6))
        assert block["tokens"][0].tolist() == prompt + fresh[0]
        assert int(block["epochs"][0]) == 0
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# slow tier: the triple-plane chaos soak (tests/test_rl_loop.py's)
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_rl_triple_chaos_soak(tmp_path):
    """One run, three planes of chaos: a rollout replica SIGKILLed
    mid-trajectory (token-exact resume + trajectory dedup), a
    trainer-rank node SIGKILLed mid-step (gang reshape + loss-curve
    continuity against a shadow trainer replaying the identical step
    batches), and the head SIGKILLed INSIDE a seal->commit window
    (standby promotes; publish atomicity). After every fault: weights
    epochs converge and zero trajectories go unaccounted."""
    import threading

    import ray_tpu_torch
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.chaos import (
        RL_MIX,
        ChaosOrchestrator,
        ChaosWorkload,
        RLRolloutWorkload,
        make_plan,
    )
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.llm.continuous import ContinuousBatchingEngine
    from ray_tpu_torch.llm.engine import GenerationConfig
    from ray_tpu_torch.llm.serving import build_llm_deployment
    from ray_tpu_torch.rl import (
        TrajectoryFeed,
        WeightsPublisher,
        elastic_rl_init,
        elastic_rl_step,
        model_config_to_dict,
    )
    from ray_tpu_torch.rl.loop import sgd_step
    from ray_tpu_torch.train import ElasticConfig, ElasticTrainer

    # the serve plane byte-tokenizes prompts (ids up to bos=256), and the
    # trainer computes CE loss over those same token ids — the model vocab
    # must cover the tokenizer or loss_fn NaNs on out-of-vocab labels
    mcfg = _small_cfg(vocab_size=258)
    prompt = "rl rollout"
    max_new = 8
    gen = GenerationConfig(max_new_tokens=max_new, temperature=0.0, seed=0)
    # replicas and the trainer draw the same seed-0 weights: one base
    # model everywhere
    base_params = _params(mcfg, 0)
    ref_engine = ContinuousBatchingEngine(
        mcfg, base_params, max_batch=2, page_size=8, n_pages=64, device="cpu"
    )

    def expected_tokens():
        return [
            ref_engine.tokenizer.decode([int(t)])
            for t in ref_engine.stream_ids(
                ref_engine.tokenizer.encode(prompt), gen
            )
        ]

    expected_base = expected_tokens()
    assert len(expected_base) == max_new

    # head persistence is what feeds WAL shipping to the armed standby
    cluster = Cluster(
        use_device_scheduler=False,
        persist_path=str(tmp_path / "head_state.pkl"),
    )
    cluster.add_node({"CPU": 8.0}, num_workers=3)
    cluster.add_node({"CPU": 8.0}, num_workers=3)
    # the feed actor gets its own tiny node so trainer_rank_kill (which
    # SIGKILLs a node hosting trainer ranks) can never take the
    # accounting ledger down with it
    cluster.add_node({"CPU": 0.5, "FEED": 1.0}, num_workers=1)
    rt = cluster.client()
    set_runtime(rt)
    cluster.start_standby(auto_promote=False)
    workload = None
    pump = None
    stop_evt = threading.Event()
    try:
        FeedActor = ray_tpu_torch.remote(TrajectoryFeed)
        feed = FeedActor.options(
            name="rl-feed", num_cpus=0.25, resources={"FEED": 1.0}
        ).remote(2)
        ray_tpu_torch.get(feed.latest_epoch.remote(), timeout=60.0)

        app = build_llm_deployment(
            mcfg,
            base_params,
            name="rl-policy",
            num_replicas=2,
            engine="continuous",
            max_batch=2,
            page_size=8,
            n_pages=64,
            device="cpu",
        )
        serve.run(app)
        router = serve.get_router("rl-policy")
        assert router.resumable

        publisher = WeightsPublisher(
            "rl-policy", head_address=cluster.address
        )
        payload = {"prompt": prompt, "max_new_tokens": max_new}
        workload = RLRolloutWorkload(
            router,
            payload,
            {"base": expected_base},
            publisher=publisher,
            feed=feed,
            concurrency=2,
            # hashed trajectory ids must live inside the trainer model's
            # vocab — OOV labels NaN the CE loss on both curve and shadow
            token_space=mcfg.vocab_size,
        )
        workload.start()
        _wait_for(
            lambda: workload.completed >= 2,
            timeout=240.0,
            msg="warm rollout streams",
        )
        assert not workload.verify_failures

        # throttled through the fault schedule (the trainer must outlive
        # every fault), sprinted to the finish once chaos is done
        ray_tpu_torch.get(feed.set_pace.remote(0.2), timeout=30.0)
        trainer = ElasticTrainer(
            elastic_rl_init,
            elastic_rl_step,
            total_steps=2500,
            train_loop_config={
                "model": model_config_to_dict(mcfg),
                "seed": 0,
                "batch_size": 4,
                "lr": 0.01,
                "feed_actor": "rl-feed",
                "device": "cpu",
            },
            elastic_config=ElasticConfig(
                min_workers=1,
                max_workers=2,
                virtual_shards=4,
                seal_interval_steps=2,
                grow=True,
                placement_strategy="STRICT_SPREAD",
                resources_per_worker={"CPU": 1.0},
            ),
        )
        workload.trainer = trainer
        fit_box = {}

        def _fit():
            try:
                fit_box["res"] = trainer.fit()
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                fit_box["exc"] = exc

        fit_th = threading.Thread(target=_fit, daemon=True)
        fit_th.start()
        _wait_for(
            lambda: trainer.progress()["step"] >= 2 or "exc" in fit_box,
            timeout=240.0,
            msg="trainer first steps",
        )
        if "exc" in fit_box:
            raise fit_box["exc"]

        # shadow trainer + publish pump: replays the feed's cached step
        # batches in the driver (byte-identical to what the gang
        # trained), publishes the shadow params under the two-phase
        # fence, hot-swaps every replica, and registers the new epoch's
        # reference sequence for verification
        shadow = {"params": base_params, "step": 0}
        shadow_losses = {}
        pump_errors = []

        def _pump():
            while not stop_evt.is_set():
                try:
                    target = trainer.progress()["step"]
                    while shadow["step"] < target and not stop_evt.is_set():
                        s = shadow["step"]
                        block = ray_tpu_torch.get(
                            feed.take_for_step.remote(s, 4), timeout=60.0
                        )
                        if block is not None:
                            tokens = torch.from_numpy(
                                np.asarray(block["tokens"])
                            ).to(torch.int64)
                            loss, shadow["params"] = sgd_step(
                                shadow["params"], tokens, mcfg, 0.01
                            )
                            shadow_losses[s] = float(loss)
                        shadow["step"] = s + 1
                    epoch = publisher.publish(shadow["params"])
                    ray_tpu_torch.get(feed.note_epoch.remote(epoch), timeout=30.0)
                    model_id = f"epoch-{epoch}"
                    ref_engine.swap_params(
                        shadow["params"], model_id=model_id
                    )
                    expected = expected_tokens()
                    workload.broadcast_weights(
                        shadow["params"], model_id, epoch
                    )
                    workload.register_model(model_id, expected)
                except Exception as exc:  # noqa: BLE001 - head mid-failover
                    pump_errors.append(repr(exc))
                stop_evt.wait(1.0)

        pump = threading.Thread(target=_pump, daemon=True)
        pump.start()
        try:
            _wait_for(
                lambda: workload.published_epoch() >= 1,
                timeout=120.0,
                msg="first weights publish",
            )
        except TimeoutError as exc:
            raise AssertionError(
                f"first publish never landed; shadow_step={shadow['step']} "
                f"pump_errors={pump_errors[-5:]}"
            ) from exc

        plan = make_plan(
            seed=14,
            num_faults=4,
            mix=RL_MIX,
            allow=(
                "rollout_kill",
                "trainer_rank_kill",
                "head_kill_mid_publish",
            ),
            min_delay_s=0.5,
            max_delay_s=1.5,
        )
        # all three planes in ONE run (seed pinned for that property)
        assert set(plan.counts()) == {
            "rollout_kill",
            "trainer_rank_kill",
            "head_kill_mid_publish",
        }
        chaos_wl = ChaosWorkload(rt, payload_bytes=150_000, num_actors=1)
        orch = ChaosOrchestrator(
            cluster,
            chaos_wl,
            plan,
            node_resources={"CPU": 8.0},
            workers_per_node=3,
            convergence_budget_s=180.0,
            serve_adapter=workload,
            rl_adapter=workload,
        )
        result = orch.run()
        stop_evt.set()
        workload.stop()
        # cooperative finish now that chaos is over: unpace and latch
        # the feed's stop flag — the gang completes its current step and
        # exits together
        ray_tpu_torch.get(feed.set_pace.remote(0.0), timeout=30.0)
        ray_tpu_torch.get(feed.request_stop.remote(), timeout=30.0)
        fit_th.join(timeout=420)
        assert not fit_th.is_alive(), (
            "trainer did not finish",
            trainer.progress(),
        )
        if "exc" in fit_box:
            raise fit_box["exc"]
        res = fit_box["res"]
        assert res.error is None, res.error
        assert result.ok, result.summary()
        # every fault genuinely fired — a skipped fault would publish a
        # green soak for a scenario that never ran
        for f in result.faults:
            assert not f.detail.startswith("skipped"), (
                f.spec.kind,
                f.detail,
            )
        assert not workload.verify_failures, workload.verify_failures

        # conservation law after the dust settles
        acct = workload.trajectory_accounting()
        assert acct["unaccounted"] == 0, acct
        assert acct["emitted"] > 0

        # loss-curve continuity: the gang's recorded losses equal the
        # shadow's, computed from the identical cached step batches
        hist = res.metrics_history
        gang_losses = {
            m["step"]: m["loss"]
            for m in hist
            if m.get("loss") == m.get("loss")  # drop NaN (empty steps)
        }
        diag = (
            f"gang_trained={sorted(gang_losses)} "
            f"shadow_trained={sorted(shadow_losses)} "
            f"pump_errors={pump_errors[:6]} acct={acct}"
        )
        compared = 0
        for s, lv in shadow_losses.items():
            if s in gang_losses:
                assert abs(gang_losses[s] - lv) < 1e-3, (
                    s,
                    gang_losses[s],
                    lv,
                    diag,
                )
                compared += 1
        assert compared >= 5, (
            f"only {compared} overlapping trained steps "
            f"(shadow={len(shadow_losses)}, gang={len(gang_losses)}); "
            + diag
        )

        # the publish fence kept moving through all three fault planes
        assert workload.published_epoch() >= 3
    finally:
        stop_evt.set()
        if pump is not None:
            pump.join(timeout=30)
        if workload is not None:
            workload.stop()
        serve.shutdown()
        set_runtime(None)
        try:
            rt.shutdown()
        finally:
            cluster.shutdown()
