"""IMPALA: asynchronous rollouts + V-trace off-policy correction.

Port of ``ray_tpu/rllib/impala.py`` (reference shape:
rllib/algorithms/impala/): actors stream rollouts collected under a stale
behavior policy while the learner updates continuously;
importance-weight clipping (V-trace, Espeholt et al. 2018) corrects the
off-policyness. Env-runner actors keep one rollout in flight each
(``ray_tpu_torch.wait`` drives the async loop). The reference's V-trace
is a reverse ``lax.scan`` inside its jitted update; its inputs are
stop-gradient values, so here it is a reverse loop under
``torch.no_grad()``, and the gradient flows only through the policy
loss's ``logp``, the value loss's ``values`` and the entropy.

Devices, as in ``ppo.py``: the learner on ``config.device`` (default the
card), the runners on the CPU with host copies of the parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch

from .. import _jaxrng
from .._device import resolve_device
from ..models.transformer import params_to
from ..train.programs import adam_init
from .cartpole import CartPoleEnv
from .ppo import adam_step, entropy_of, host_copy, init_policy, policy_forward


@ray_tpu_torch.remote
class ImpalaRunner:
    """Collects fixed-length segments under whatever params it was last
    handed (the learner may have moved on — that lag is the point)."""

    def __init__(self, env_factory: Callable, seed: int):
        self.env = env_factory()
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self.episode_return = 0.0

    def rollout(self, params, num_steps: int) -> Dict[str, np.ndarray]:
        obs_b, act_b, rew_b, done_b, blogp_b = [], [], [], [], []
        returns: List[float] = []
        for _ in range(num_steps):
            with torch.no_grad():
                logits, _ = policy_forward(params, torch.from_numpy(self.obs[None]))
            probs = torch.softmax(logits[0], dim=-1).numpy()
            action = int(self.rng.choice(len(probs), p=probs / probs.sum()))
            blogp = float(np.log(probs[action] + 1e-9))
            nobs, reward, term, trunc, _ = self.env.step(action)
            obs_b.append(self.obs)
            act_b.append(action)
            rew_b.append(reward)
            done_b.append(term or trunc)
            blogp_b.append(blogp)
            self.episode_return += reward
            if term or trunc:
                returns.append(self.episode_return)
                self.episode_return = 0.0
                self.obs, _ = self.env.reset()
            else:
                self.obs = nobs
        return {
            "obs": np.asarray(obs_b, np.float32),
            "actions": np.asarray(act_b, np.int32),
            "rewards": np.asarray(rew_b, np.float32),
            "dones": np.asarray(done_b, np.bool_),
            "behavior_logp": np.asarray(blogp_b, np.float32),
            "bootstrap_obs": np.asarray(self.obs, np.float32),
            "episode_returns": np.asarray(returns, np.float32),
        }


@dataclass
class ImpalaConfig:
    env_factory: Callable = CartPoleEnv
    num_env_runners: int = 2
    rollout_steps: int = 128
    gamma: float = 0.99
    lr: float = 3e-3
    rho_clip: float = 1.0       # V-trace importance-weight clip
    c_clip: float = 1.0
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hidden: int = 64
    seed: int = 0
    updates_per_iter: int = 4   # segments consumed per train() call
    device: Optional[str] = None  # the learner's; None -> the card


def vtrace(values, bootstrap_v, rewards, discounts, rho_c, c_c):
    """(vs, pg_adv) of V-trace over one segment, from stop-gradient
    values: ``vs_t = V_t + delta_t + discount_t * c_t * (vs_{t+1} -
    V_{t+1})``, run backwards from the segment's end."""
    with torch.no_grad():
        next_values = torch.cat([values[1:], bootstrap_v])
        deltas = rho_c * (rewards + discounts * next_values - values)
        acc = torch.zeros((), dtype=values.dtype, device=values.device)
        vs_minus_v = torch.empty_like(values)
        for t in range(values.shape[0] - 1, -1, -1):
            acc = deltas[t] + discounts[t] * c_c[t] * acc
            vs_minus_v[t] = acc
        vs = values + vs_minus_v
        next_vs = torch.cat([vs[1:], bootstrap_v])
        pg_adv = rho_c * (rewards + discounts * next_vs - values)
    return vs, pg_adv


class IMPALA:
    """Algorithm driver (reference Algorithm.train() shape) with an
    asynchronous rollout pipeline: every runner always has a segment in
    flight; train() consumes whichever finish first."""

    def __init__(self, config: ImpalaConfig = ImpalaConfig()):
        self.config = config
        self.device = resolve_device(config.device)
        env = config.env_factory()
        key = _jaxrng.prng_key(config.seed)
        self.params = params_to(init_policy(
            key, env.observation_size, env.num_actions, config.hidden
        ), self.device)
        self.opt_state = adam_init(self.params)
        self.runners = [
            ImpalaRunner.remote(config.env_factory, config.seed + 50 + i)
            for i in range(config.num_env_runners)
        ]
        self.iteration = 0
        self._in_flight: Dict[Any, Any] = {}  # ref -> runner

    def _update(self, params, opt_state, batch):
        """One learner update on a segment: (params, opt_state, loss,
        (pi_loss, vf_loss, entropy)), as the reference's jitted
        ``update``."""
        cfg = self.config

        def loss_fn(params):
            logits, values = policy_forward(params, batch["obs"])
            _, bootstrap_v = policy_forward(params, batch["bootstrap_obs"][None])
            logp_all = F.log_softmax(logits, dim=-1)
            logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
            rho = torch.exp(logp.detach() - batch["behavior_logp"])
            discounts = cfg.gamma * (1.0 - batch["dones"].to(torch.float32))
            vs, pg_adv = vtrace(
                values.detach(), bootstrap_v.detach(), batch["rewards"], discounts,
                torch.clamp(rho, max=cfg.rho_clip), torch.clamp(rho, max=cfg.c_clip),
            )
            pi_loss = -torch.mean(logp * pg_adv)
            vf_loss = torch.mean((values - vs) ** 2)
            entropy = entropy_of(logp_all)
            total = (
                pi_loss
                + cfg.vf_coeff * vf_loss
                - cfg.entropy_coeff * entropy
            )
            return total, (pi_loss, vf_loss, entropy)

        return adam_step(params, opt_state, loss_fn, cfg.lr)

    def _launch(self, runner) -> None:
        ref = runner.rollout.remote(host_copy(self.params), self.config.rollout_steps)
        self._in_flight[ref] = runner

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        self.iteration += 1
        for r in self.runners:
            if r not in self._in_flight.values():
                self._launch(r)
        ep_returns: List[float] = []
        loss = pi_loss = vf_loss = entropy = float("nan")
        consumed = 0
        while consumed < cfg.updates_per_iter:
            ready, _ = ray_tpu_torch.wait(
                list(self._in_flight), num_returns=1, timeout=120
            )
            if not ready:
                break
            ref = ready[0]
            runner = self._in_flight.pop(ref)
            seg = ray_tpu_torch.get(ref)
            self._launch(runner)  # keep the pipeline full
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in seg.items() if k != "episode_returns"}
            self.params, self.opt_state, loss_t, aux = self._update(
                self.params, self.opt_state, batch
            )
            loss = float(loss_t)
            pi_loss, vf_loss, entropy = (float(x) for x in aux)
            ep_returns.extend(seg["episode_returns"].tolist())
            consumed += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (
                float(np.mean(ep_returns)) if ep_returns else float("nan")
            ),
            "num_episodes": len(ep_returns),
            "num_env_steps": consumed * cfg.rollout_steps,
            "total_loss": loss,
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
        }

    def save(self, path: str):
        from ..train.checkpoint import Checkpoint

        return Checkpoint.from_state({"params": self.params}, path)

    def restore(self, path: str):
        from ..train.checkpoint import Checkpoint

        self.params = params_to(Checkpoint(path).load_state()["params"], self.device)
