"""Online-RL chaos workload: the triple-plane soak adapter.

Extends the serve-plane stream workload with the RL surfaces the
orchestrator's ``rollout_kill`` / ``trainer_rank_kill`` /
``head_kill_mid_publish`` faults need:

- **Epoch-aware verification.** Rollout streams are deterministic given
  the weights epoch, so each completed stream is verified against the
  reference sequence for the model it was SUBMITTED under (the driver
  registers one per published epoch). A mid-kill resume may neither
  duplicate nor drop an acked token — and a stream can never silently
  mix two epochs, because a mixed stream matches neither reference.
- **Trajectory emission.** Every verified stream becomes a trajectory
  (stamped with its epoch) emitted into the :class:`TrajectoryFeed`,
  so the conservation-law invariant covers the real rollout path.
- **The publish-hold kill window.** ``arm_publish_hold`` latches the
  publisher's ``between_phases`` hook: the next publish parks between
  seal and commit, the orchestrator SIGKILLs the leader inside that
  window, and ``release_publish_hold`` lets the publisher's retry land
  against the promoted standby.

Port of ``ray_tpu/chaos/rl.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import re
import threading
import zlib
from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.chaos.serve import ServeStreamWorkload

_EPOCH_RE = re.compile(r"epoch-(\d+)$")


def model_epoch(model_id: Optional[str]) -> int:
    """Published weights epoch encoded in a model id (``epoch-N``);
    0 for the base model."""
    m = _EPOCH_RE.search(model_id or "")
    return int(m.group(1)) if m else 0


class RLRolloutWorkload(ServeStreamWorkload):
    """Rollout streams through the serve router, verified per weights
    epoch, feeding trajectories to the trainer. Doubles as the
    orchestrator's ``rl_adapter``."""

    def __init__(
        self,
        router,
        payload: dict,
        expected_by_model: Dict[str, List[str]],
        *,
        publisher,
        feed,
        concurrency: int = 2,
        tenants: Optional[List[str]] = None,
        token_space: int = 65536,
    ):
        base_model = payload.get("model", "base")
        super().__init__(
            router,
            # pin the model id explicitly: replicas honor the pin via
            # _ensure_model, so a stream submitted (or RESUMED after a
            # kill) against a replica whose weights already moved swaps
            # back instead of silently serving the wrong epoch — without
            # the pin there is a broadcast→register window where fresh
            # streams verify against the old reference but run on new
            # weights
            {**payload, "model": base_model},
            expected_tokens=list(expected_by_model.get(base_model, [])),
            concurrency=concurrency,
            tenants=tenants,
        )
        self.publisher = publisher
        self.feed = feed
        # id range for hashed trajectory tokens — MUST be <= the trainer
        # model's vocab_size when the trajectories are actually trained
        # on (an out-of-vocab label NaNs the CE loss)
        self.token_space = int(token_space)
        self.trainer = None  # driver sets once the ElasticTrainer is up
        self._expected_by_model = {
            m: list(t) for m, t in expected_by_model.items()
        }
        self._traj_seq = 0
        # publish-hold latch (head_kill_mid_publish window)
        self._hold_requested = threading.Event()
        self._in_window = threading.Event()
        self._release = threading.Event()
        publisher.between_phases = self._between_phases

    # -- epoch-aware driver surface --------------------------------------
    def register_model(
        self, model_id: str, expected_tokens: List[str]
    ) -> None:
        """Register the reference sequence for a freshly published
        epoch's model, and route NEW streams to it."""
        with self._lock:
            self._expected_by_model[model_id] = list(expected_tokens)
            self.payload = {**self.payload, "model": model_id}

    def broadcast_weights(self, params, model_id: str, version: int):
        """Push published params to every live replica through the
        object plane (``swap_weights_ref``) — including replicas
        backfilled after a rollout kill, which start on base weights.
        Best-effort per replica; the convergence invariant is the
        judge."""
        ref = ray_tpu_torch.put(params)
        rs = self.router._rs
        with rs.lock:
            replicas = [r for r in rs.replicas if not r.draining]
        swapped = 0
        for r in replicas:
            try:
                ray_tpu_torch.get(
                    r.actor.swap_weights_ref.remote(
                        {
                            "model": model_id,
                            "version": int(version),
                            "params_ref": ref,
                        }
                    ),
                    timeout=60.0,
                )
                swapped += 1
            except Exception:  # noqa: BLE001 - dead replica: judged later
                pass
        return swapped

    # -- stream loop (epoch-aware verification + trajectory emission) ----
    def _loop(self, idx: int) -> None:  # noqa: C901
        from ray_tpu_torch.serve.router import ChannelClosed

        tenant = self.tenants[idx % len(self.tenants)]
        while not self._stop.is_set():
            got: List[str] = []
            stream = None
            sid = None
            with self._lock:
                payload = dict(self.payload)
                self._traj_seq += 1
                seq = self._traj_seq
            model = payload.get("model", "base")
            try:
                stream = self.router.stream(payload, tenant)
                sid = getattr(stream, "stream_id", None)
                with self._lock:
                    self._inflight[idx] = stream
                while True:
                    try:
                        got.append(stream.read(timeout=30.0))
                    except ChannelClosed:
                        break
            except Exception:  # noqa: BLE001 - hard failover exhaustion
                with self._lock:
                    self.stream_errors += 1
                    self._inflight.pop(idx, None)
                    if sid in self._watched:
                        self._watched[sid] = "error"
                import time as _time

                _time.sleep(0.2)
                continue
            finally:
                if stream is not None:
                    stream.close()
            with self._lock:
                expected = self._expected_by_model.get(model)
            ok = expected is not None and got == expected
            if not ok:
                exp_len = len(expected) if expected is not None else -1
                with self._lock:
                    self.verify_failures.append(
                        f"stream under {model!r} returned {len(got)} "
                        f"tokens, expected {exp_len} (token-exact resume "
                        "broken or epochs mixed mid-stream)"
                    )
            else:
                self._emit_trajectory(seq, payload, got, model)
                with self._lock:
                    self.completed += 1
            with self._lock:
                self._inflight.pop(idx, None)
                if sid in self._watched:
                    self._watched[sid] = "ok" if ok else "verify_fail"

    def _emit_trajectory(
        self, seq: int, payload: dict, tokens: List[str], model: str
    ) -> None:
        from ray_tpu_torch.rl.trajectory import Trajectory, encode_block

        traj = Trajectory(
            traj_id=f"stream:{seq}",
            prompt=[0],
            # token TEXTS hash to ids. crc32, not hash(): the builtin is
            # salted per process, and the loss-continuity oracle re-reads
            # these ids in other processes
            tokens=[0]
            + [
                zlib.crc32(t.encode("utf-8")) % self.token_space
                for t in tokens
            ],
            weights_epoch=model_epoch(model),
            rollout_id="serve",
            seed=int(payload.get("seed", 0)),
        )
        block = encode_block([traj])
        try:
            if hasattr(self.feed.emit, "remote"):
                ray_tpu_torch.get(self.feed.emit.remote(block), timeout=30.0)
            else:
                self.feed.emit(block)
        except Exception:  # noqa: BLE001 - feed actor mid-restart
            pass

    # -- orchestrator rl_adapter surface ---------------------------------
    def pick_rollout_pid(self, rng) -> Optional[int]:
        return self.pick_replica_pid(rng)

    def trainer_gang_ids(self) -> List[str]:
        gid = getattr(self.trainer, "gang_id", None)
        return [gid] if gid else []

    def published_epoch(self) -> int:
        return int(self.publisher.current_epoch()["committed"])

    def replica_epochs(self) -> List[int]:
        """Published weights epoch each live replica currently serves
        (parsed from its engine's model id)."""
        rs = self.router._rs
        with rs.lock:
            replicas = [r for r in rs.replicas if not r.draining]
        out: List[int] = []
        for r in replicas:
            try:
                stats = ray_tpu_torch.get(
                    r.actor.serve_stats.remote(), timeout=10.0
                )
            except Exception:  # noqa: BLE001 - dead replica: not "live"
                continue
            out.append(model_epoch(stats.get("model_id")))
        return out

    def trajectory_accounting(self) -> Dict[str, int]:
        if hasattr(self.feed.accounting, "remote"):
            return ray_tpu_torch.get(self.feed.accounting.remote(), timeout=30.0)
        return self.feed.accounting()

    # -- publish-hold kill window ----------------------------------------
    def _between_phases(self, epoch: int) -> None:
        if not self._hold_requested.is_set():
            return
        self._in_window.set()
        self._release.wait(timeout=60.0)

    def arm_publish_hold(self, timeout: float = 20.0) -> bool:
        """Latch the hold and wait for the next publish to park inside
        its seal->commit window. False if none arrives in time."""
        self._release.clear()
        self._in_window.clear()
        self._hold_requested.set()
        armed = self._in_window.wait(timeout)
        if not armed:
            self._hold_requested.clear()
        return armed

    def release_publish_hold(self) -> None:
        self._hold_requested.clear()
        self._release.set()
