"""Replay buffer actor — the distributed experience store for off-policy
algorithms (reference: ray/rllib/utils/replay_buffers/, run as actors by
ApeX-style setups). A ring of preallocated numpy arrays; env runners add
transition batches, the learner samples uniformly.

Port of ``ray_tpu/rllib/replay.py``: numpy only, copied, as an
``@ray_tpu_torch.remote`` actor."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import ray_tpu_torch


@ray_tpu_torch.remote
class ReplayBuffer:
    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self._store: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0

    def add(self, batch: Dict[str, np.ndarray]) -> int:
        n = len(batch["obs"])
        if self._store is None:
            self._store = {
                k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in batch.items()
            }
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._store[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)
        return self._size

    def sample(self, batch_size: int) -> Optional[Dict[str, np.ndarray]]:
        if self._size < batch_size:
            return None
        idx = self.rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._store.items()}

    def size(self) -> int:
        return self._size
