"""PPO: env-runner actors + a clipped-surrogate learner.

Port of ``ray_tpu/rllib/ppo.py``. The policy/value MLP is a tree of
tensors in the reference's layout (``torso`` a list of two dense layers,
``pi``, ``vf``), drawn as JAX draws it: ``_jaxrng.prng_key``, ``split``
and ``normal`` give ``jax.random``'s keys and (within 1e-6) its normals,
so ``PPO(PPOConfig(seed=3))`` starts from the reference's parameters.
``optax.adam`` is ``train/programs.py::adam_update``, which equals it bit
for bit; the clipped surrogate, value and entropy loss are written out in
torch.

Devices: the learner's parameters, Adam state and SGD steps run on
``config.device`` (default the card; raises without one). The runners
are ``@remote`` actors without a GPU lease, as in the reference: they act
on the CPU, one observation at a time, so each iteration the learner
hands them host copies of the parameters (a few thousand floats), never
tensors on the card. Every update builds new tensors, so a tree handed
out (to a runner, or kept as a snapshot) never changes under it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from .. import _jaxrng
from .._device import DeviceLike, resolve_device
from ..models.transformer import params_to
from ..train import pytree
from ..train.programs import adam_init, adam_update, value_and_grad
from .cartpole import CartPoleEnv

# -- policy/value MLP (a tree of tensors) -----------------------------------


def dense_init(k: torch.Tensor, i: int, o: int) -> Dict[str, torch.Tensor]:
    """Fan-in-scaled dense layer init (shared by PPO/DQN/IMPALA nets),
    from a ``_jaxrng`` key, on the key's device."""
    return {
        "w": _jaxrng.normal(k, (i, o)) * (i**-0.5),
        "b": torch.zeros((o,), dtype=torch.float32, device=k.device),
    }


def init_policy(key: torch.Tensor, obs_size: int, num_actions: int, hidden: int = 64):
    k1, k2, k3, k4 = _jaxrng.split(key, 4)
    dense = dense_init

    return {
        "torso": [dense(k1, obs_size, hidden), dense(k2, hidden, hidden)],
        "pi": dense(k3, hidden, num_actions),
        "vf": dense(k4, hidden, 1),
    }


def policy_forward(params, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    h = obs
    for layer in params["torso"]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = (h @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def host_copy(tree: Any) -> Any:
    """The tree's tensors on the host, detached: what a runner is handed."""
    return pytree.tree_map(lambda t: t.detach().to("cpu"), tree)


def policy_params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """An rllib network's parameter tree from the JAX package (``init_policy``'s
    or ``init_qnet``'s), given as nested dicts and lists of numpy arrays, as
    f32 tensors on ``device``."""
    device = resolve_device(device)
    return pytree.tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device), tree)


def adam_step(params: Any, opt_state: Dict[str, Any], loss_fn: Callable, lr: float):
    """(new params, new Adam state, loss, aux) of one ``optax.adam`` step
    on ``loss_fn(params) -> (loss, aux)``; new trees, the inputs untouched."""
    (loss, aux), grads = value_and_grad(loss_fn, params, has_aux=True)
    new = adam_update({"params": params, "opt": opt_state}, grads, lr)
    return new["params"], new["opt"], loss.detach(), tuple(a.detach() for a in aux)


def entropy_of(logp_all: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


# -- rollout worker ----------------------------------------------------------


@ray_tpu_torch.remote
class EnvRunner:
    """Collects one rollout segment per call under given (host) policy
    params."""

    def __init__(self, env_factory: Callable, seed: int):
        self.env = env_factory()
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self.episode_return = 0.0
        self.completed_returns: List[float] = []

    def rollout(self, params, num_steps: int) -> Dict[str, np.ndarray]:
        obs_buf, act_buf, rew_buf, done_buf, logp_buf, val_buf = (
            [], [], [], [], [], [],
        )
        self.completed_returns = []
        with torch.no_grad():
            for _ in range(num_steps):
                logits, value = policy_forward(
                    params, torch.from_numpy(self.obs[None])
                )
                probs = torch.softmax(logits[0], dim=-1).numpy()
                action = int(self.rng.choice(len(probs), p=probs / probs.sum()))
                logp = float(np.log(probs[action] + 1e-9))
                nobs, reward, term, trunc, _ = self.env.step(action)
                obs_buf.append(self.obs)
                act_buf.append(action)
                rew_buf.append(reward)
                done_buf.append(term or trunc)
                logp_buf.append(logp)
                val_buf.append(float(value[0]))
                self.episode_return += reward
                if term or trunc:
                    self.completed_returns.append(self.episode_return)
                    self.episode_return = 0.0
                    self.obs, _ = self.env.reset()
                else:
                    self.obs = nobs
            _, last_value = policy_forward(params, torch.from_numpy(self.obs[None]))
        return {
            "obs": np.asarray(obs_buf, np.float32),
            "actions": np.asarray(act_buf, np.int32),
            "rewards": np.asarray(rew_buf, np.float32),
            "dones": np.asarray(done_buf, np.bool_),
            "logp": np.asarray(logp_buf, np.float32),
            "values": np.asarray(val_buf, np.float32),
            "last_value": float(last_value[0]),
            "episode_returns": np.asarray(self.completed_returns, np.float32),
        }


# -- learner -----------------------------------------------------------------


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    adv = np.zeros_like(rewards)
    gae = 0.0
    next_value = last_value
    for t in reversed(range(len(rewards))):
        nonterminal = 0.0 if dones[t] else 1.0
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        next_value = values[t]
    returns = adv + values
    return adv, returns


@dataclass
class PPOConfig:
    env_factory: Callable = CartPoleEnv
    num_env_runners: int = 2
    rollout_steps: int = 256          # per runner per iteration
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-3
    num_sgd_epochs: int = 6
    minibatch_size: int = 128
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hidden: int = 64
    seed: int = 0
    device: Optional[str] = None      # the learner's; None -> the card


class PPO:
    """Algorithm driver (reference Algorithm.train() shape)."""

    def __init__(self, config: PPOConfig = PPOConfig()):
        self.config = config
        self.device = resolve_device(config.device)
        env = config.env_factory()
        key = _jaxrng.prng_key(config.seed)
        self.params = params_to(init_policy(
            key, env.observation_size, env.num_actions, config.hidden
        ), self.device)
        self.opt_state = adam_init(self.params)
        self.runners = [
            EnvRunner.remote(config.env_factory, config.seed + 100 + i)
            for i in range(config.num_env_runners)
        ]
        self._key = key
        self.iteration = 0

    def _sgd_step(self, params, opt_state, batch):
        """One minibatch step: (params, opt_state, loss, (pi_loss,
        vf_loss, entropy)), as the reference's jitted ``sgd_step``."""
        cfg = self.config

        def loss_fn(params):
            logits, values = policy_forward(params, batch["obs"])
            logp_all = F.log_softmax(logits, dim=-1)
            logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
            ratio = torch.exp(logp - batch["logp"])
            adv = batch["advantages"]
            surr = torch.minimum(
                ratio * adv,
                torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv,
            )
            pi_loss = -torch.mean(surr)
            vf_loss = torch.mean((values - batch["returns"]) ** 2)
            entropy = entropy_of(logp_all)
            total = (
                pi_loss
                + cfg.vf_coeff * vf_loss
                - cfg.entropy_coeff * entropy
            )
            return total, (pi_loss, vf_loss, entropy)

        return adam_step(params, opt_state, loss_fn, cfg.lr)

    def train(self) -> Dict[str, Any]:
        """One iteration: parallel rollouts → GAE → minibatch SGD epochs."""
        cfg = self.config
        self.iteration += 1
        host = host_copy(self.params)
        refs = [
            r.rollout.remote(host, cfg.rollout_steps)
            for r in self.runners
        ]
        segments = ray_tpu_torch.get(refs)

        obs, acts, logps, advs, rets, ep_returns = [], [], [], [], [], []
        for seg in segments:
            adv, ret = compute_gae(
                seg["rewards"], seg["values"], seg["dones"],
                seg["last_value"], cfg.gamma, cfg.gae_lambda,
            )
            obs.append(seg["obs"])
            acts.append(seg["actions"])
            logps.append(seg["logp"])
            advs.append(adv)
            rets.append(ret)
            ep_returns.extend(seg["episode_returns"].tolist())
        batch = {
            "obs": np.concatenate(obs),
            "actions": np.concatenate(acts),
            "logp": np.concatenate(logps),
            "advantages": np.concatenate(advs),
            "returns": np.concatenate(rets),
        }
        adv = batch["advantages"]
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)

        n = len(batch["obs"])
        rng = np.random.default_rng(cfg.seed + self.iteration)
        loss = pi_loss = vf_loss = entropy = 0.0
        for _ in range(cfg.num_sgd_epochs):
            order = rng.permutation(n)
            for i in range(0, n, cfg.minibatch_size):
                idx = order[i : i + cfg.minibatch_size]
                mb = {k: torch.from_numpy(v[idx]).to(self.device) for k, v in batch.items()}
                self.params, self.opt_state, loss, aux = self._sgd_step(
                    self.params, self.opt_state, mb
                )
                pi_loss, vf_loss, entropy = aux
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (
                float(np.mean(ep_returns)) if ep_returns else float("nan")
            ),
            "num_episodes": len(ep_returns),
            "num_env_steps": n,
            "total_loss": float(loss),
            "policy_loss": float(pi_loss),
            "vf_loss": float(vf_loss),
            "entropy": float(entropy),
        }

    def save(self, path: str):
        from ..train.checkpoint import Checkpoint

        return Checkpoint.from_state({"params": self.params}, path)

    def restore(self, path: str):
        from ..train.checkpoint import Checkpoint

        self.params = params_to(Checkpoint(path).load_state()["params"], self.device)
