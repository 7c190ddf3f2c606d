"""Self-contained CartPole-v1 (gymnasium API; no external dependency).

Port of ``ray_tpu/rllib/cartpole.py``: numpy only, copied.

Standard cart-pole dynamics (Barto-Sutton-Anderson), matching the classic
control task the reference's RLlib suites benchmark against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class CartPoleEnv:
    observation_size = 4
    num_actions = 2

    def __init__(self, seed: int = 0, max_steps: int = 500):
        self.rng = np.random.default_rng(seed)
        self.max_steps = max_steps
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4
        self.state: Optional[np.ndarray] = None
        self.steps = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state = self.rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        self.steps = 0
        return self.state.copy(), {}

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, bool, dict]:
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costh, sinth = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (
            force + polemass_length * theta_dot**2 * sinth
        ) / total_mass
        thetaacc = (self.gravity * sinth - costh * temp) / (
            self.length
            * (4.0 / 3.0 - self.masspole * costh**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costh / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array([x, x_dot, theta, theta_dot], dtype=np.float32)
        self.steps += 1
        terminated = bool(
            abs(x) > self.x_threshold or abs(theta) > self.theta_threshold
        )
        truncated = self.steps >= self.max_steps
        return self.state.copy(), 1.0, terminated, truncated, {}
