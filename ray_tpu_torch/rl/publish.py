"""Weights publisher: the two-phase (seal → commit) epoch fence.

Port of ``ray_tpu/rl/publish.py`` on the port's ``cluster/rpc.py`` and
``serve/model_store.hub_from_node``. The version store keeps the tree it
was handed: the loop's updates build new tensors and never write a
published one in place, so an epoch's stored tree stays the one that was
published (where JAX's arrays are immutable by nature).

A publish makes new params visible to the rollout fleet under a
strictly increasing **weights epoch**, fenced exactly like gang
epochs. The protocol against the head (or the in-process ledger when
no cluster is running):

1. ``WeightsPublishSeal`` reserves ``committed + 1`` and WALs the seal
   phase (replicated to standbys before the reply returns).
2. The params land in the object plane under ``(model_id, epoch)`` —
   the shm/device-frame weights hub when one is reachable, a local
   version store otherwise. Data before fence: a reader that sees the
   committed epoch can always pull its params.
3. ``WeightsPublishCommit`` flips the sealed epoch to committed (its
   own WAL record).

A head killed between 1 and 3 leaves the successor showing the OLD
committed epoch with a dangling seal — readers never see a torn
publish, and the publisher's retry loop simply re-seals against the
promoted head (on the same port) and commits. A commit whose epoch is
not the currently sealed one is rejected ``stale`` and the publisher
restarts the cycle; the fence can only ever move forward.

``between_phases`` is the chaos injection hook: the soak's
``head_kill_mid_publish`` fault arms it to hold the publisher inside
the seal→commit window while the orchestrator kills the leader.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.util.metrics import Counter, Histogram

WEIGHTS_PUBLISHES = Counter(
    "rl_weights_publishes_total",
    "Committed weights-epoch publishes.",
    label_names=("deployment",),
)
WEIGHTS_PUBLISH_RETRIES = Counter(
    "rl_weights_publish_retries_total",
    "Publish cycles restarted (stale commit or head failover mid-phase).",
    label_names=("deployment",),
)
WEIGHTS_PUBLISH_MS = Histogram(
    "rl_weights_publish_ms",
    "Seal->commit wall time for one weights publish (ms).",
    boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000),
    label_names=("deployment",),
)


class LocalEpochLedger:
    """The head's weights-epoch state machine, in-process — identical
    replies, same seal/commit fencing, no RPC. Lets the loop (and the
    fast tests / bench) run headless while exercising the same
    two-phase protocol."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[str, dict] = {}

    def _row(self, dep: str) -> dict:
        return self._rows.setdefault(
            dep, {"committed": 0, "meta": {}, "sealed": None}
        )

    def call(self, method: str, req: dict, **_kw) -> dict:
        with self._lock:
            w = self._row(req["deployment"])
            if method == "WeightsPublishSeal":
                epoch = int(w["committed"]) + 1
                w["sealed"] = {
                    "epoch": epoch,
                    "meta": dict(req.get("meta") or {}),
                }
                return {"epoch": epoch, "committed": int(w["committed"])}
            if method == "WeightsPublishCommit":
                epoch = int(req["epoch"])
                sealed = w.get("sealed")
                if int(w["committed"]) >= epoch:
                    return {"committed": int(w["committed"]), "stale": False}
                if sealed is None or int(sealed["epoch"]) != epoch:
                    return {"committed": int(w["committed"]), "stale": True}
                w["committed"] = epoch
                w["meta"] = dict(sealed.get("meta", {}))
                w["sealed"] = None
                return {"committed": epoch, "stale": False}
            if method == "WeightsEpochGet":
                return {
                    "committed": int(w["committed"]),
                    "meta": dict(w.get("meta", {})),
                    "sealed": dict(w["sealed"]) if w.get("sealed") else None,
                }
            raise ValueError(f"unknown method {method!r}")

    def close(self) -> None:
        pass


class WeightsPublisher:
    """Publish params under the two-phase weights-epoch fence.

    ``head_address`` of None runs against a private
    :class:`LocalEpochLedger`. Params for each committed epoch are
    retained in a local version store (and pushed through the node's
    :class:`~ray_tpu_torch.serve.model_store.WeightsHub` when one is
    reachable) so rollout workers — and the chaos oracle — can fetch
    the exact tree behind any epoch.
    """

    def __init__(
        self,
        deployment: str,
        head_address: Optional[str] = None,
        model_id: str = "policy",
        use_hub: bool = False,
    ):
        self.deployment = deployment
        self.model_id = model_id
        if head_address is None:
            self._client = LocalEpochLedger()
        else:
            from ray_tpu_torch.cluster.rpc import RpcClient

            self._client = RpcClient(head_address)
        self._hub = None
        if use_hub:
            try:
                from ray_tpu_torch.serve.model_store import hub_from_node

                self._hub = hub_from_node(deployment)
            except Exception:  # noqa: BLE001 - hub is an optimisation
                self._hub = None
        self._versions: Dict[int, Any] = {}
        self._versions_lock = threading.Lock()
        # chaos hook: runs between seal and commit (the kill window)
        self.between_phases: Optional[Callable[[int], None]] = None

    # -- protocol ------------------------------------------------------
    def publish(self, params: Any, max_attempts: int = 8) -> int:
        """Run one full seal→stash→commit cycle; returns the committed
        epoch. Retries the WHOLE cycle on a stale commit or an RPC
        failure (head died mid-phase and a standby promoted on the same
        port) — each retry re-seals, so exactly one epoch ever lands."""
        from ray_tpu_torch.cluster.rpc import RpcError

        t0 = time.monotonic()
        last_err: Optional[Exception] = None
        for attempt in range(max_attempts):
            if attempt:
                WEIGHTS_PUBLISH_RETRIES.inc(
                    labels={"deployment": self.deployment}
                )
                time.sleep(min(0.2 * attempt, 1.0))
            try:
                sealed = self._client.call(
                    "WeightsPublishSeal",
                    {
                        "deployment": self.deployment,
                        "meta": {"model": self.model_id},
                    },
                    timeout=10.0,
                    retries=3,
                )
                epoch = int(sealed["epoch"])
                self._stash(epoch, params)
                if self.between_phases is not None:
                    self.between_phases(epoch)
                reply = self._client.call(
                    "WeightsPublishCommit",
                    {"deployment": self.deployment, "epoch": epoch},
                    timeout=10.0,
                    retries=3,
                )
            except RpcError as e:
                last_err = e
                continue
            if reply.get("stale"):
                last_err = RuntimeError(
                    f"stale commit for epoch {epoch} "
                    f"(committed={reply.get('committed')})"
                )
                continue
            WEIGHTS_PUBLISHES.inc(labels={"deployment": self.deployment})
            WEIGHTS_PUBLISH_MS.observe(
                (time.monotonic() - t0) * 1000.0,
                labels={"deployment": self.deployment},
            )
            return int(reply["committed"])
        raise RuntimeError(
            f"weights publish failed after {max_attempts} attempts"
        ) from last_err

    def _stash(self, epoch: int, params: Any) -> None:
        with self._versions_lock:
            self._versions[epoch] = params
        if self._hub is not None:
            # idempotent: an existing (model, epoch) entry means a prior
            # attempt of this same publish already sealed it
            self._hub.ensure(self.model_id, epoch, params)

    def params_for(self, epoch: int) -> Optional[Any]:
        with self._versions_lock:
            p = self._versions.get(int(epoch))
        if p is not None:
            return p
        if self._hub is not None:
            return self._hub.pull(self.model_id, int(epoch))
        return None

    def current_epoch(self) -> dict:
        return self._client.call(
            "WeightsEpochGet",
            {"deployment": self.deployment},
            timeout=10.0,
            retries=3,
        )

    def close(self) -> None:
        try:
            self._client.close()
        except Exception:  # noqa: BLE001
            pass
