"""DQN: epsilon-greedy env runners -> replay buffer actor -> double-DQN
learner with a periodically synced target network.

Port of ``ray_tpu/rllib/dqn.py`` (reference shape: rllib/algorithms/dqn/:
replay buffer + target network + TD loss). The Q-network is drawn as JAX
draws it (``ppo.dense_init``); ``optax.adam`` is ``adam_update`` and
``optax.huber_loss`` (delta 1.0) is written out as optax computes it:
``0.5 * min(|x|, 1)**2 + (|x| - min(|x|, 1))``, i.e. ``0.5 * x**2`` where
``|x| <= 1``, else ``|x| - 0.5``.

Devices, as in ``ppo.py``: the learner, its Adam state and the target
network live on ``config.device`` (default the card); the runners act on
the CPU with host copies of the parameters. The reference's runners race
their adds into the shared buffer, so its seed does not fix the buffer's
order and its learning curve differs from run to run; the port's runners
act in parallel and add in runner order. ``target_params = params``
shares the tree, which is a snapshot because every SGD step builds new
tensors (JAX's arrays are immutable; the port never writes a parameter in
place).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

import ray_tpu_torch

from .. import _jaxrng
from .._device import resolve_device
from ..models.transformer import params_to
from ..train.programs import adam_init
from .cartpole import CartPoleEnv
from .ppo import adam_step, host_copy, policy_params_from_jax
from .replay import ReplayBuffer


def init_qnet(key: torch.Tensor, obs_size: int, num_actions: int, hidden: int = 64):
    from .ppo import dense_init as dense

    k1, k2, k3 = _jaxrng.split(key, 3)
    return {
        "l1": dense(k1, obs_size, hidden),
        "l2": dense(k2, hidden, hidden),
        "out": dense(k3, hidden, num_actions),
    }


# ``init_qnet``'s tree from the JAX package's: the same conversion
qnet_params_from_jax = policy_params_from_jax


def q_forward(params, obs: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(obs @ params["l1"]["w"] + params["l1"]["b"])
    h = torch.tanh(h @ params["l2"]["w"] + params["l2"]["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """``optax.huber_loss(x, delta=delta)``, in optax's arithmetic."""
    abs_x = torch.abs(x)
    quadratic = torch.minimum(abs_x, torch.tensor(delta, dtype=x.dtype, device=x.device))
    return 0.5 * quadratic**2 + delta * (abs_x - quadratic)


@ray_tpu_torch.remote
class DQNRunner:
    """Steps the env epsilon-greedily, shipping transitions to the replay
    buffer actor (ApeX actor analog: acting decoupled from learning)."""

    def __init__(self, env_factory: Callable, buffer, seed: int):
        self.env = env_factory()
        self.buffer = buffer
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self.episode_return = 0.0

    def collect(
        self, params, num_steps: int, eps: float, after: Sequence[Any] = ()
    ) -> Dict[str, Any]:
        """Steps the env, then adds the transitions to the buffer once the
        ``collect`` calls in ``after`` (the runners before this one, as
        refs inside a list, which are not resolved before the call) have
        added theirs."""
        obs_b, act_b, rew_b, nobs_b, done_b = [], [], [], [], []
        returns: List[float] = []
        for _ in range(num_steps):
            if self.rng.random() < eps:
                action = int(self.rng.integers(self.env.num_actions))
            else:
                with torch.no_grad():
                    q = q_forward(params, torch.from_numpy(self.obs[None]))
                action = int(torch.argmax(q[0]))
            nobs, reward, term, trunc, _ = self.env.step(action)
            obs_b.append(self.obs)
            act_b.append(action)
            rew_b.append(reward)
            nobs_b.append(nobs)
            done_b.append(term)  # bootstrap through time-limit truncation
            self.episode_return += reward
            if term or trunc:
                returns.append(self.episode_return)
                self.episode_return = 0.0
                self.obs, _ = self.env.reset()
            else:
                self.obs = nobs
        if after:
            ray_tpu_torch.get(list(after))
        size = ray_tpu_torch.get(
            self.buffer.add.remote(
                {
                    "obs": np.asarray(obs_b, np.float32),
                    "actions": np.asarray(act_b, np.int32),
                    "rewards": np.asarray(rew_b, np.float32),
                    "next_obs": np.asarray(nobs_b, np.float32),
                    "dones": np.asarray(done_b, np.bool_),
                }
            )
        )
        return {
            "episode_returns": returns,
            "steps": num_steps,
            "buffer_size": size,
        }


@dataclass
class DQNConfig:
    env_factory: Callable = CartPoleEnv
    num_env_runners: int = 2
    rollout_steps: int = 128        # per runner per iteration
    buffer_capacity: int = 20_000
    batch_size: int = 128
    sgd_steps_per_iter: int = 32
    gamma: float = 0.99
    lr: float = 1e-3
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_iters: int = 12
    target_sync_every: int = 2      # iterations between target syncs
    hidden: int = 64
    seed: int = 0
    device: Optional[str] = None    # the learner's; None -> the card


class DQN:
    """Algorithm driver (reference Algorithm.train() shape)."""

    def __init__(self, config: DQNConfig = DQNConfig()):
        self.config = config
        self.device = resolve_device(config.device)
        env = config.env_factory()
        key = _jaxrng.prng_key(config.seed)
        self.params = params_to(init_qnet(
            key, env.observation_size, env.num_actions, config.hidden
        ), self.device)
        # every SGD step builds new tensors, so sharing the tree IS the
        # snapshot (as sharing JAX's immutable leaves is)
        self.target_params = self.params
        self.opt_state = adam_init(self.params)
        self.buffer = ReplayBuffer.remote(config.buffer_capacity, config.seed)
        self.runners = [
            DQNRunner.remote(
                config.env_factory, self.buffer, config.seed + 10 + i
            )
            for i in range(config.num_env_runners)
        ]
        self.iteration = 0

    def _sgd_step(self, params, target_params, opt_state, batch):
        """One TD step: (params, opt_state, loss), as the reference's
        jitted ``sgd_step``."""
        cfg = self.config
        with torch.no_grad():
            # double DQN: online net picks, target net evaluates; the
            # target is a constant of the loss (stop_gradient)
            next_act = torch.argmax(q_forward(params, batch["next_obs"]), dim=-1)
            next_q = q_forward(target_params, batch["next_obs"]).gather(
                1, next_act[:, None])[:, 0]
            target = batch["rewards"] + cfg.gamma * next_q * (
                1.0 - batch["dones"].to(torch.float32)
            )

        def loss_fn(params):
            q = q_forward(params, batch["obs"])
            q_taken = q.gather(1, batch["actions"].long()[:, None])[:, 0]
            return torch.mean(huber_loss(q_taken - target)), ()

        params, opt_state, loss, _ = adam_step(params, opt_state, loss_fn, cfg.lr)
        return params, opt_state, loss

    def _epsilon(self) -> float:
        """Linear schedule; the FIRST iteration explores at eps_start."""
        cfg = self.config
        frac = min(
            1.0, (self.iteration - 1) / max(1, cfg.eps_decay_iters)
        )
        return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        self.iteration += 1
        eps = self._epsilon()
        host = host_copy(self.params)
        # the runners act in parallel and add to the buffer in runner
        # order, so the buffer (and the learning curve) follows the seed
        refs: List[Any] = []
        for r in self.runners:
            refs.append(r.collect.remote(host, cfg.rollout_steps, eps, refs[-1:]))
        stats = ray_tpu_torch.get(refs)
        ep_returns = [x for s in stats for x in s["episode_returns"]]
        loss = float("nan")
        sgd_done = 0
        for _ in range(cfg.sgd_steps_per_iter):
            batch = ray_tpu_torch.get(self.buffer.sample.remote(cfg.batch_size))
            if batch is None:
                break
            tb = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            self.params, self.opt_state, loss_t = self._sgd_step(
                self.params, self.target_params, self.opt_state, tb
            )
            loss = float(loss_t)
            sgd_done += 1
        if self.iteration % cfg.target_sync_every == 0:
            self.target_params = self.params
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (
                float(np.mean(ep_returns)) if ep_returns else float("nan")
            ),
            "num_episodes": len(ep_returns),
            "num_env_steps": cfg.rollout_steps * cfg.num_env_runners,
            "buffer_size": stats[-1]["buffer_size"],
            "epsilon": eps,
            "td_loss": loss,
            "sgd_steps": sgd_done,
        }

    def save(self, path: str):
        from ..train.checkpoint import Checkpoint

        return Checkpoint.from_state({"params": self.params}, path)

    def restore(self, path: str):
        from ..train.checkpoint import Checkpoint

        self.params = params_to(Checkpoint(path).load_state()["params"], self.device)
        self.target_params = self.params
