"""RL training on the port (``ray_tpu_torch/rllib/``), on the CPU.

First the four cases of ``tests/test_rllib.py`` on the port, with the
reference's seeds and learning thresholds, each learner on
``device="cpu"``. Then the port against the JAX package with the same
parameters carried across (``policy_params_from_jax``,
``qnet_params_from_jax``): ``_jaxrng.normal`` against ``jax.random.normal``,
the initial networks, the environment, GAE, the replay buffer's sample,
the forward passes, one step of each learner's update (PPO's clipped
surrogate, DQN's Huber TD step, IMPALA's V-trace at T=192) with its Adam
state, and a whole env-runner rollout. Last, DQN's target network stays a
snapshot between syncs, which JAX's immutable arrays gave the reference
and the port keeps by building new tensors in every step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import _jaxrng
from ray_tpu_torch.rllib import (
    DQN,
    DQNConfig,
    IMPALA,
    ImpalaConfig,
    PPO,
    PPOConfig,
    CartPoleEnv,
)
from ray_tpu_torch.train import pytree

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtime brings its scheduler up on cuda and raises
    # without it; here it runs on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def _on_cpu(tree):
    return all(t.device == CPU for t in pytree.leaves(tree))


def _np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close(mine, ref, atol=1e-6):
    a, b = [t.detach().numpy() for t in pytree.leaves(mine)], _np(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


# -- tests/test_rllib.py on the port -----------------------------------------


def test_cartpole_dynamics():
    env = CartPoleEnv(seed=0)
    obs, _ = env.reset()
    assert obs.shape == (4,)
    total = 0.0
    for _ in range(600):
        obs, r, term, trunc, _ = env.step(1)
        total += r
        if term or trunc:
            break
    assert term  # constant action falls over
    assert 5 < total < 200


def test_ppo_improves_on_cartpole(tmp_path):
    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4, "memory": 1e9})
    try:
        algo = PPO(PPOConfig(num_env_runners=2, rollout_steps=256, seed=3, device="cpu"))
        first = algo.train()
        assert first["num_env_steps"] == 512
        early = first["episode_return_mean"]
        last = None
        for _ in range(7):
            last = algo.train()
        assert last["episode_return_mean"] > early + 10, (early, last)
        assert _on_cpu(algo.params) and _on_cpu(algo.opt_state)
        algo.save(str(tmp_path / "ppo_ckpt"))
        algo2 = PPO(PPOConfig(num_env_runners=1, rollout_steps=64, device="cpu"))
        algo2.restore(str(tmp_path / "ppo_ckpt"))
        assert all(torch.equal(a, b) for a, b in
                   zip(pytree.leaves(algo2.params), pytree.leaves(algo.params)))
        r = algo2.train()
        assert np.isfinite(r["total_loss"])
    finally:
        ray_tpu_torch.shutdown()


def test_dqn_learns_and_buffer_fills(tmp_path):
    from ray_tpu_torch.rllib.dqn import q_forward

    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4, "memory": 1e9})
    try:
        algo = DQN(
            DQNConfig(
                num_env_runners=2,
                rollout_steps=128,
                sgd_steps_per_iter=48,
                batch_size=64,
                eps_decay_iters=6,
                seed=1,
                device="cpu",
            )
        )
        first = algo.train()
        assert first["buffer_size"] >= 128
        results = [algo.train() for _ in range(11)]
        last = results[-1]
        assert np.isfinite(last["td_loss"]) and last["sgd_steps"] > 0
        early = first["episode_return_mean"]
        assert last["episode_return_mean"] > early + 10, (early, last)
        algo.save(str(tmp_path / "dqn_ckpt"))
        algo2 = DQN(DQNConfig(num_env_runners=1, rollout_steps=32, device="cpu"))
        algo2.restore(str(tmp_path / "dqn_ckpt"))
        r2 = algo2.train()
        assert r2["sgd_steps"] == 0 or np.isfinite(r2["td_loss"])
        algo3 = DQN(DQNConfig(num_env_runners=1, rollout_steps=32, device="cpu"))
        algo3.restore(str(tmp_path / "dqn_ckpt"))
        probe = torch.from_numpy(np.linspace(-1, 1, 16).reshape(4, 4).astype(np.float32))
        assert torch.allclose(q_forward(algo3.params, probe), q_forward(algo.params, probe))
    finally:
        ray_tpu_torch.shutdown()


def test_impala_async_pipeline_learns(tmp_path):
    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4, "memory": 1e9})
    try:
        algo = IMPALA(
            ImpalaConfig(
                num_env_runners=2,
                rollout_steps=192,
                updates_per_iter=4,
                seed=5,
                device="cpu",
            )
        )
        first = algo.train()
        assert first["num_env_steps"] > 0
        last = None
        for _ in range(7):
            last = algo.train()
        assert np.isfinite(last["total_loss"])
        early = first["episode_return_mean"]
        assert last["episode_return_mean"] > early + 10, (early, last)
        assert len(algo._in_flight) == 2
    finally:
        ray_tpu_torch.shutdown()


# -- the port against the JAX package ----------------------------------------


def _key(seed):
    return _jaxrng.prng_key(seed)


@pytest.mark.parametrize("seed", [0, 1, 3, 5, 42])
def test_normal_within_1e6_of_jax(seed):
    keys = [(jax.random.PRNGKey(seed), _key(seed))]
    for jk, tk in zip(jax.random.split(jax.random.PRNGKey(seed), 3), _jaxrng.split(_key(seed), 3)):
        keys.append((jk, tk))
    for jk, tk in keys:
        np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
        for shape in [(4, 64), (64, 64), (64, 2), (64, 1), (5000,)]:
            ref = np.asarray(jax.random.normal(jk, shape, jnp.float32))
            mine = _jaxrng.normal(tk, shape)
            assert mine.dtype == torch.float32
            np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=1e-6)


def test_erf_inv_edges_equal_xla():
    x = np.array([-1.0, -0.999999, -0.5, 0.0, 1e-8, 0.3, 0.9999, 1.0], np.float32)
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    mine = _jaxrng.erf_inv(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(ref) | (np.abs(ref) > 1e38), np.abs(mine) > 1e38)
    finite = np.abs(ref) < 1e38
    np.testing.assert_allclose(mine[finite], ref[finite], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 3, 5])
def test_initial_networks_equal_the_reference(seed):
    from ray_tpu.rllib.dqn import init_qnet as jqnet
    from ray_tpu.rllib.ppo import init_policy as jpolicy
    from ray_tpu_torch.rllib.dqn import init_qnet
    from ray_tpu_torch.rllib.ppo import init_policy

    _close(init_policy(_key(seed), 4, 2, 64), jpolicy(jax.random.PRNGKey(seed), 4, 2, 64))
    _close(init_qnet(_key(seed), 4, 2, 64), jqnet(jax.random.PRNGKey(seed), 4, 2, 64))


def test_cartpole_trajectories_equal_the_reference():
    from ray_tpu.rllib.cartpole import CartPoleEnv as JEnv

    env, ref = CartPoleEnv(seed=7), JEnv(seed=7)
    acts = np.random.default_rng(0).integers(0, 2, 500)
    np.testing.assert_array_equal(env.reset()[0], ref.reset()[0])
    for a in acts:
        mine, theirs = env.step(int(a)), ref.step(int(a))
        np.testing.assert_array_equal(mine[0], theirs[0])
        assert mine[1:4] == theirs[1:4]
        if mine[2] or mine[3]:
            np.testing.assert_array_equal(env.reset()[0], ref.reset()[0])


def test_compute_gae_equals_the_reference():
    from ray_tpu.rllib.ppo import compute_gae as jgae
    from ray_tpu_torch.rllib.ppo import compute_gae

    rng = np.random.default_rng(1)
    r = rng.random(300).astype(np.float32)
    v = rng.normal(size=300).astype(np.float32)
    d = rng.random(300) < 0.05
    for a, b in zip(compute_gae(r, v, d, 0.7, 0.99, 0.95), jgae(r, v, d, 0.7, 0.99, 0.95)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_replay_sample_equals_the_reference():
    from ray_tpu.rllib.replay import ReplayBuffer as JBuf
    from ray_tpu_torch.rllib.replay import ReplayBuffer

    mine, ref = ReplayBuffer._cls(100, seed=4), JBuf._cls(100, seed=4)
    rng = np.random.default_rng(2)
    for n in (40, 50, 30):
        batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, n).astype(np.int32),
                 "dones": rng.random(n) < 0.1}
        assert mine.add(batch) == ref.add(batch)
    assert mine.sample(200) is None and ref.sample(200) is None
    for _ in range(3):
        a, b = mine.sample(32), ref.sample(32)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def _policy_pair(seed=3):
    from ray_tpu.rllib.ppo import init_policy as jpolicy
    from ray_tpu_torch.rllib.ppo import policy_params_from_jax

    jp = jpolicy(jax.random.PRNGKey(seed), 4, 2, 64)
    return jp, policy_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def test_forward_passes_within_1e6():
    from ray_tpu.rllib.dqn import init_qnet as jqnet, q_forward as jq
    from ray_tpu.rllib.ppo import policy_forward as jpf
    from ray_tpu_torch.rllib.dqn import q_forward, qnet_params_from_jax
    from ray_tpu_torch.rllib.ppo import policy_forward

    obs = np.random.default_rng(3).normal(size=(64, 4)).astype(np.float32)
    jp, tp = _policy_pair()
    for a, b in zip(policy_forward(tp, torch.from_numpy(obs)), jpf(jp, jnp.asarray(obs))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    jq_params = jqnet(jax.random.PRNGKey(1), 4, 2, 64)
    tq = qnet_params_from_jax(jax.tree.map(np.asarray, jq_params), device="cpu")
    np.testing.assert_allclose(q_forward(tq, torch.from_numpy(obs)).numpy(),
                               np.asarray(jq(jq_params, jnp.asarray(obs))), rtol=0, atol=1e-6)


def _adam_close(mine, ref, atol=1e-6):
    """The port's {"m", "v", "t"} against optax.adam's state."""
    adam = ref[0]
    assert int(mine["t"]) == int(adam.count)
    _close(mine["m"], adam.mu, atol)
    _close(mine["v"], adam.nu, atol)


class _RefGradTap:
    """The reference learner's ``optax.adam``, handing each update's
    gradients to the host (a callback inside its jitted step); installed
    before the step's first call, so its trace takes it."""

    def __init__(self, algo):
        self.inner, self.seen = algo.optimizer, []
        algo.optimizer = self

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params=None):
        jax.debug.callback(lambda g: self.seen.append(_np(g)), grads)
        return self.inner.update(grads, state, params)


def _port_grad_tap(monkeypatch):
    """The gradients each of the port's learner steps hands ``adam_update``
    (PPO, DQN and IMPALA all step through ``ppo.adam_step``)."""
    from ray_tpu_torch.rllib import ppo as tppo

    seen, real = [], tppo.adam_update

    def tapped(state, grads, lr):
        seen.append([g.detach().clone() for g in grads])
        return real(state, grads, lr)

    monkeypatch.setattr(tppo, "adam_update", tapped)
    return seen


def _update_close(carried, mine, my_taps, ref, opt_ref, ref_taps, lr):
    """One Adam step from the same state (the taps' last gradients),
    checked in its two halves, every element within 1e-6: the port's
    gradients against the reference's, and the port's ``adam_update`` fed
    the reference's own gradients against the reference's new parameters
    and moments. The port's step is that update of its own gradients, bit
    for bit. (Comparing the two whole
    steps would not hold 1e-6 everywhere: where sqrt(v_hat) nears Adam's
    eps, m_hat / (sqrt(v_hat) + eps) turns the gradients' ~1e-8
    float-ordering noise between XLA's and torch's matmuls into a
    different step.)"""
    from ray_tpu_torch.train.programs import adam_update

    jax.effects_barrier()  # the reference step's callback has run
    assert len(my_taps) == len(ref_taps)
    tp, to = carried
    mine_grads, ref_grads = my_taps[-1], ref_taps[-1]
    assert len(mine_grads) == len(ref_grads)
    for g, r in zip(mine_grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-6)
    fed = adam_update({"params": tp, "opt": to}, [torch.tensor(r) for r in ref_grads], lr)
    _close(fed["params"], ref)
    _adam_close(fed["opt"], opt_ref)
    own = adam_update({"params": tp, "opt": to}, mine_grads, lr)["params"]
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(own), pytree.leaves(mine)))


def _carry(jp, jo):
    """JAX's parameters and optax.adam state as the port's, so each step
    below starts both packages from the same state."""
    from ray_tpu_torch.rllib.ppo import policy_params_from_jax as from_jax

    adam = jo[0]
    return (from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            {"m": from_jax(jax.tree.map(np.asarray, adam.mu), "cpu"),
             "v": from_jax(jax.tree.map(np.asarray, adam.nu), "cpu"),
             "t": torch.tensor(int(adam.count), dtype=torch.int32)})


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _values_close(mine, ref, atol=1e-6):
    np.testing.assert_allclose([float(x) for x in mine], [float(x) for x in ref],
                               rtol=1e-6, atol=atol)


def test_ppo_sgd_step_equals_the_reference(monkeypatch):
    from ray_tpu.rllib.ppo import PPO as JPPO, PPOConfig as JConfig

    jalgo = JPPO(JConfig(num_env_runners=0, seed=3))
    algo = PPO(PPOConfig(num_env_runners=0, seed=3, device="cpu"))
    ref_grads, my_grads = _RefGradTap(jalgo).seen, _port_grad_tap(monkeypatch)
    _close(algo.params, jalgo.params)
    _adam_close(algo.opt_state, jalgo.opt_state)
    rng = np.random.default_rng(5)
    jp, jo = jalgo.params, jalgo.opt_state
    for _ in range(3):  # later steps: moments nonzero, ratios away from 1
        tp, to = _carry(jp, jo)
        adv = rng.normal(size=128).astype(np.float32)
        batch = {"obs": rng.normal(size=(128, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, 128).astype(np.int32),
                 "logp": np.log(rng.uniform(0.3, 0.7, 128)).astype(np.float32),
                 "advantages": (adv - adv.mean()) / (adv.std() + 1e-8),
                 "returns": rng.normal(size=128).astype(np.float32)}
        jp, jo, jloss, jaux = jalgo._sgd_step(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        p, o, loss, aux = algo._sgd_step(tp, to, _torch_batch(batch))
        _values_close([loss, *aux], [jloss, *jaux])
        _update_close((tp, to), p, my_grads, jp, jo, ref_grads, algo.config.lr)
        _adam_close(o, jo)


def test_dqn_sgd_step_equals_the_reference(monkeypatch):
    """Double-DQN with the Huber TD loss against ``optax.huber_loss``."""
    from ray_tpu.rllib import dqn as jdqn
    from ray_tpu_torch.rllib import dqn as tdqn

    # the learners' replay buffer actors are not needed for one step
    monkeypatch.setattr(jdqn.ReplayBuffer, "remote", lambda *a, **k: None)
    monkeypatch.setattr(tdqn.ReplayBuffer, "remote", lambda *a, **k: None)
    jalgo = jdqn.DQN(jdqn.DQNConfig(num_env_runners=0, seed=1))
    algo = DQN(DQNConfig(num_env_runners=0, seed=1, device="cpu"))
    ref_grads, my_grads = _RefGradTap(jalgo).seen, _port_grad_tap(monkeypatch)
    _close(algo.params, jalgo.params)
    rng = np.random.default_rng(6)
    x = np.linspace(-3, 3, 601).astype(np.float32)
    np.testing.assert_allclose(tdqn.huber_loss(torch.from_numpy(x)).numpy(),
                               np.asarray(optax.huber_loss(jnp.asarray(x))), rtol=0, atol=1e-7)
    jp, jo = jalgo.params, jalgo.opt_state
    for _ in range(3):
        tp, to = _carry(jp, jo)
        batch = {"obs": rng.normal(size=(64, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, 64).astype(np.int32),
                 "rewards": np.ones(64, np.float32),
                 "next_obs": rng.normal(size=(64, 4)).astype(np.float32),
                 "dones": rng.random(64) < 0.1}
        jp, jo, jloss = jalgo._sgd_step(jp, jalgo.target_params, jo,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
        p, o, loss = algo._sgd_step(tp, algo.target_params, to, _torch_batch(batch))
        _values_close([loss], [jloss])
        _update_close((tp, to), p, my_grads, jp, jo, ref_grads, algo.config.lr)
        _adam_close(o, jo)


def test_impala_update_equals_the_reference(monkeypatch):
    """One V-trace update at T=192 (the reverse loop against lax.scan)."""
    from ray_tpu.rllib.impala import IMPALA as JIMPALA, ImpalaConfig as JConfig

    jalgo = JIMPALA(JConfig(num_env_runners=0, seed=5))
    algo = IMPALA(ImpalaConfig(num_env_runners=0, seed=5, device="cpu"))
    ref_grads, my_grads = _RefGradTap(jalgo).seen, _port_grad_tap(monkeypatch)
    _close(algo.params, jalgo.params)
    rng = np.random.default_rng(7)
    jp, jo = jalgo.params, jalgo.opt_state
    for _ in range(3):
        tp, to = _carry(jp, jo)
        seg = {"obs": rng.normal(size=(192, 4)).astype(np.float32),
               "actions": rng.integers(0, 2, 192).astype(np.int32),
               "rewards": np.ones(192, np.float32),
               "dones": rng.random(192) < 0.05,
               "behavior_logp": np.log(rng.uniform(0.3, 0.7, 192)).astype(np.float32),
               "bootstrap_obs": rng.normal(size=4).astype(np.float32)}
        jp, jo, jloss, jaux = jalgo._update(jp, jo, {k: jnp.asarray(v) for k, v in seg.items()})
        p, o, loss, aux = algo._update(tp, to, _torch_batch(seg))
        _values_close([loss, *aux], [jloss, *jaux])
        _update_close((tp, to), p, my_grads, jp, jo, ref_grads, algo.config.lr)
        _adam_close(o, jo)


def test_env_runner_rollout_equals_the_reference():
    """From the same parameters and seed, 256 steps: every action equal,
    logp and values within 1e-5."""
    from ray_tpu.rllib.ppo import EnvRunner as JRunner
    from ray_tpu.rllib.cartpole import CartPoleEnv as JEnv
    from ray_tpu_torch.rllib.ppo import EnvRunner, host_copy

    jp, tp = _policy_pair(3)
    mine = EnvRunner._cls(CartPoleEnv, 103).rollout(host_copy(tp), 256)
    ref = JRunner._cls(JEnv, 103).rollout(jp, 256)
    for k in ("obs", "actions", "rewards", "dones", "episode_returns"):
        assert mine[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    for k in ("logp", "values"):
        np.testing.assert_allclose(mine[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
    assert abs(mine["last_value"] - ref["last_value"]) < 1e-5


# -- snapshots stay snapshots -------------------------------------------------


def test_dqn_target_net_is_unchanged_by_steps_between_syncs():
    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4, "memory": 1e9})
    try:
        algo = DQN(DQNConfig(num_env_runners=1, rollout_steps=64, batch_size=32,
                             sgd_steps_per_iter=4, target_sync_every=2, device="cpu"))
        algo.train()
        algo.train()  # iteration 2 syncs the target
        assert algo.target_params is algo.params
        synced = pytree.tree_map(lambda t: t.clone(), algo.target_params)
        assert algo.train()["sgd_steps"] == 4  # iteration 3: steps, no sync
        same = [torch.equal(a, b) for a, b in
                zip(pytree.leaves(algo.target_params), pytree.leaves(synced))]
        assert all(same)
        moved = [torch.equal(a, b) for a, b in
                 zip(pytree.leaves(algo.params), pytree.leaves(synced))]
        assert not all(moved)
        algo.train()  # iteration 4 syncs again
        assert algo.target_params is algo.params
    finally:
        ray_tpu_torch.shutdown()


def test_dqn_learning_curve_follows_the_seed():
    """The runners add to the buffer in runner order, so two DQN runs from
    one seed give the same returns and parameters (the reference's runners
    race their adds, and its curve differs from run to run)."""
    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4, "memory": 1e9})
    try:
        runs = []
        for _ in range(2):
            algo = DQN(DQNConfig(num_env_runners=2, rollout_steps=64, batch_size=32,
                                 sgd_steps_per_iter=8, seed=1, device="cpu"))
            results = [algo.train() for _ in range(3)]
            runs.append(([r["episode_return_mean"] for r in results],
                         [r["buffer_size"] for r in results], pytree.leaves(algo.params)))
        (ret_a, size_a, p_a), (ret_b, size_b, p_b) = runs
        assert ret_a == ret_b and size_a == size_b == [128, 256, 384]
        assert all(torch.equal(a, b) for a, b in zip(p_a, p_b))
    finally:
        ray_tpu_torch.shutdown()
