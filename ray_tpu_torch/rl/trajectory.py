"""Trajectory plane for the online-RL loop.

Port of ``ray_tpu/rl/trajectory.py``, numpy and threading only, so the
same code with its imports rewritten; its block arrays are the
reference's, dtype for dtype (int32 tokens and lengths, int64 epochs and
seeds).

Rollout replicas emit epoch-stamped trajectories; the trainer pulls
fixed-size batches per step. Two properties carry the whole chaos
story:

- **Every trajectory is stamped with the weights epoch it was generated
  under.** The feed enforces the off-policy staleness window at batch
  formation: a trajectory whose epoch is older than ``committed - K``
  is dropped and counted (``dropped_stale``) — never silently trained
  on.
- **Batch formation is idempotent per trainer step.** ``take_for_step``
  caches the batch it formed for a step, so a gang reshape that replays
  the step (the elastic trainer replays
  its collectives under a new gang epoch) — or N ranks
  each asking for "the step-7 batch" — all see byte-identical data and
  nothing is double-counted. That is what makes the killed run's loss
  curve provably identical to the unkilled reference.

Accounting is conservation-law shaped so the chaos invariant can assert
zero loss anywhere in the pipe::

    emitted == trained + dropped_stale + in_flight   (unaccounted == 0)

Duplicates (a resumed rollout re-emitting a trajectory it already
delivered — the token-exact ``resume_from`` path makes this benign) are
deduplicated by trajectory id and counted separately; they never enter
``emitted``.

Blocks (``encode_block``/``decode_block``) are dicts of flat numpy
arrays — the shape the shuffle/object plane ships zero-copy, and what
``TrajectoryFeed.emit`` takes when it runs as a remote actor.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class Trajectory:
    """One rollout: prompt + generated tokens, stamped with provenance."""

    traj_id: str
    prompt: List[int]
    tokens: List[int]  # full sequence: prompt + generated
    weights_epoch: int
    rollout_id: str = ""
    seed: int = 0


def encode_block(trajs: List[Trajectory]) -> Dict[str, Any]:
    """Pack trajectories into flat arrays (padded token matrix + lengths
    + epoch stamps) — the zero-copy-friendly wire shape."""
    n = len(trajs)
    width = max((len(t.tokens) for t in trajs), default=1)
    toks = np.zeros((n, width), dtype=np.int32)
    lens = np.zeros((n,), dtype=np.int32)
    plens = np.zeros((n,), dtype=np.int32)
    epochs = np.zeros((n,), dtype=np.int64)
    seeds = np.zeros((n,), dtype=np.int64)
    for i, t in enumerate(trajs):
        toks[i, : len(t.tokens)] = t.tokens
        lens[i] = len(t.tokens)
        plens[i] = len(t.prompt)
        epochs[i] = t.weights_epoch
        seeds[i] = t.seed
    return {
        "tokens": toks,
        "lengths": lens,
        "prompt_lengths": plens,
        "epochs": epochs,
        "seeds": seeds,
        "traj_ids": [t.traj_id for t in trajs],
        "rollout_ids": [t.rollout_id for t in trajs],
    }


def decode_block(block: Dict[str, Any]) -> List[Trajectory]:
    out: List[Trajectory] = []
    toks = np.asarray(block["tokens"])
    lens = np.asarray(block["lengths"])
    plens = np.asarray(block["prompt_lengths"])
    epochs = np.asarray(block["epochs"])
    seeds = np.asarray(block["seeds"])
    for i, tid in enumerate(block["traj_ids"]):
        full = [int(x) for x in toks[i, : int(lens[i])]]
        out.append(
            Trajectory(
                traj_id=tid,
                prompt=full[: int(plens[i])],
                tokens=full,
                weights_epoch=int(epochs[i]),
                rollout_id=block["rollout_ids"][i],
                seed=int(seeds[i]),
            )
        )
    return out


@dataclass
class _Accounting:
    emitted: int = 0
    trained: int = 0
    dropped_stale: int = 0
    duplicates: int = 0

    def as_dict(self, in_flight: int) -> Dict[str, int]:
        return {
            "emitted": self.emitted,
            "trained": self.trained,
            "dropped_stale": self.dropped_stale,
            "in_flight": in_flight,
            "duplicates": self.duplicates,
            "unaccounted": self.emitted
            - self.trained
            - self.dropped_stale
            - in_flight,
        }


class TrajectoryFeed:
    """Buffer between rollout replicas and the trainer.

    Plain object locally; the same class runs as a ``ray_tpu_torch`` actor in
    cluster mode (every method takes/returns plain dicts and ints).
    """

    def __init__(self, staleness_window: Optional[int] = None):
        if staleness_window is None:
            from ray_tpu_torch.config import cfg

            staleness_window = int(cfg.rl_staleness_window)
        self.staleness_window = int(staleness_window)
        self._lock = threading.Lock()
        self._buf: List[Trajectory] = []
        self._seen: set = set()
        self._acct = _Accounting()
        # step -> formed batch (idempotent replay under gang reshape)
        self._step_cache: Dict[int, Dict[str, Any]] = {}
        # latest committed weights epoch the publisher told us about —
        # the staleness floor when the consumer doesn't pass one
        self._epoch = 0
        # consumer pacing override (None = consumer's own default):
        # lets a driver throttle the trainer while rollouts warm up or
        # sprint it once collection stops
        self._pace: Optional[float] = None
        # cooperative-stop latch + its per-step decision cache: every
        # rank asking "stop at step s?" gets the answer the FIRST asker
        # got, so a gang breaks out of its loop together (the same
        # idempotence contract as the step batches)
        self._stop = False
        self._stop_cache: Dict[int, bool] = {}

    # -- producer side -------------------------------------------------
    def emit(self, block: Dict[str, Any]) -> Dict[str, int]:
        """Ingest one encoded block; duplicate traj_ids (resumed rollout
        re-emits) are dropped and counted, not double-buffered."""
        trajs = decode_block(block)
        with self._lock:
            fresh = 0
            for t in trajs:
                if t.traj_id in self._seen:
                    self._acct.duplicates += 1
                    continue
                self._seen.add(t.traj_id)
                self._buf.append(t)
                self._acct.emitted += 1
                fresh += 1
            return {"accepted": fresh, "duplicates": len(trajs) - fresh}

    def note_epoch(self, epoch: int) -> int:
        """Record a committed weights epoch (monotonic); the default
        staleness floor for consumers that don't pass their own."""
        with self._lock:
            self._epoch = max(self._epoch, int(epoch))
            return self._epoch

    def latest_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def set_pace(self, seconds: Optional[float]) -> Optional[float]:
        """Override the consumer's per-step pacing (None restores the
        consumer's own default)."""
        with self._lock:
            self._pace = None if seconds is None else float(seconds)
            return self._pace

    def pace(self) -> Optional[float]:
        with self._lock:
            return self._pace

    def request_stop(self) -> bool:
        """Latch a cooperative stop: consumers that honour
        ``stop_for_step`` finish their current step and exit."""
        with self._lock:
            self._stop = True
            return self._stop

    def stop_for_step(self, step: int) -> bool:
        """Whether the consumer should stop after ``step`` — idempotent
        per step (first ask decides, replays see the same answer), so
        every rank of an elastic gang breaks at the same step even when
        ``request_stop`` races their reads."""
        with self._lock:
            s = int(step)
            if s not in self._stop_cache:
                self._stop_cache[s] = self._stop
            return self._stop_cache[s]

    # -- consumer side -------------------------------------------------
    def take_for_step(
        self,
        step: int,
        n: int,
        current_epoch: Optional[int] = None,
        staleness_window: Optional[int] = None,
    ) -> Optional[Dict[str, Any]]:
        """The batch for trainer step ``step`` (idempotent: the first
        call forms it, replays return the cached block verbatim).

        Formation first purges everything older than
        ``current_epoch - K`` from the buffer (counted
        ``dropped_stale``), then takes up to ``n`` trajectories in
        emission order (counted ``trained`` — a formed batch is always
        eventually trained: the elastic trainer replays the step until
        it lands). Returns None when the buffer is empty — and caches
        the None too, so a replayed step that originally found an empty
        buffer stays empty on replay instead of silently training data
        the recorded run never saw.
        """
        k = (
            self.staleness_window
            if staleness_window is None
            else int(staleness_window)
        )
        with self._lock:
            if step in self._step_cache:
                return self._step_cache[step]
            cur = self._epoch if current_epoch is None else int(current_epoch)
            floor = cur - k
            keep: List[Trajectory] = []
            for t in self._buf:
                if t.weights_epoch < floor:
                    self._acct.dropped_stale += 1
                else:
                    keep.append(t)
            self._buf = keep
            if not self._buf:
                self._step_cache[step] = None
                return None
            batch, self._buf = self._buf[:n], self._buf[n:]
            self._acct.trained += len(batch)
            block = encode_block(batch)
            self._step_cache[step] = block
            return block

    # -- introspection -------------------------------------------------
    def accounting(self) -> Dict[str, int]:
        with self._lock:
            return self._acct.as_dict(len(self._buf))

    def pending(self) -> int:
        with self._lock:
            return len(self._buf)
