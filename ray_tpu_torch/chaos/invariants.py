"""Post-fault invariant checks.

After every injected fault the orchestrator waits for the cluster to
converge and then asserts, in order:

1. **Membership** — every agent process that should be alive is ALIVE at
   the head (killed nodes excluded; partitioned nodes re-register after
   heal).
2. **No acked-object loss** — a sample of results the driver already
   observed still resolves to byte-identical values (lineage rebuilds
   dropped copies; a restarted head re-seeds its directory from agent
   store inventories).
3. **Actor recovery** — every restartable workload actor is ALIVE at the
   head AND answers a method call within the restart budget.
4. **Lease drain** — in-flight submissions either complete or fail with
   a definite exhausted-retry/dead-actor error; nothing hangs.
5. **Durable-state match** — after a head restart, the recovered KV
   entries and named-actor bindings equal the pre-fault snapshot.

Port of ``ray_tpu/chaos/invariants.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .workload import ChaosWorkload


@dataclass
class Snapshot:
    """Durable head state captured before a fault."""

    kv: Dict[str, bytes] = field(default_factory=dict)
    named_actors: Dict[str, str] = field(default_factory=dict)


@dataclass
class CheckResult:
    ok: bool
    failures: List[str] = field(default_factory=list)


class InvariantChecker:
    def __init__(
        self,
        cluster,
        workload: ChaosWorkload,
        actor_restart_budget_s: float = 60.0,
        object_timeout_s: float = 60.0,
    ):
        self.cluster = cluster
        self.workload = workload
        self.actor_restart_budget_s = actor_restart_budget_s
        self.object_timeout_s = object_timeout_s

    # -- pre-fault ------------------------------------------------------
    def snapshot(self) -> Snapshot:
        head = self.cluster.head
        with head._lock:
            return Snapshot(
                kv=dict(head._kv),
                named_actors=dict(head._named_actors),
            )

    # -- convergence ----------------------------------------------------
    def expected_alive(self) -> int:
        """Agent processes still running = nodes that must be ALIVE."""
        return sum(
            1 for p in self.cluster._agents.values() if p.poll() is None
        )

    def wait_membership(self, deadline: float) -> Optional[str]:
        want = self.expected_alive()
        while time.monotonic() < deadline:
            alive = sum(
                1 for n in self.cluster.head.nodes.values() if n.alive
            )
            if alive >= want:
                return None
            time.sleep(0.1)
        alive = sum(1 for n in self.cluster.head.nodes.values() if n.alive)
        return f"membership: {alive}/{want} nodes alive at the head"

    def wait_actors(self, deadline: float) -> List[str]:
        import ray_tpu_torch

        failures: List[str] = []
        for handle, aid in zip(
            self.workload.actors, self.workload.actor_ids
        ):
            recovered = False
            while time.monotonic() < deadline:
                info = self.cluster.head._actors.get(aid)
                state = info.state if info is not None else "UNKNOWN"
                if state == "ALIVE":
                    try:
                        budget = max(1.0, deadline - time.monotonic())
                        if (
                            ray_tpu_torch.get(
                                handle.ping.remote(), timeout=budget
                            )
                            == "pong"
                        ):
                            recovered = True
                            break
                    except Exception:  # noqa: BLE001 - retry until budget
                        pass
                elif state == "DEAD":
                    failures.append(
                        f"actor {aid[:8]} is DEAD (restart budget was "
                        "not exhausted by the plan)"
                    )
                    recovered = True  # definite, stop polling
                    break
                time.sleep(0.2)
            if not recovered:
                failures.append(
                    f"actor {aid[:8]} not responsive within the "
                    f"{self.actor_restart_budget_s}s restart budget"
                )
        return failures

    def check_leases_drained(self, timeout: float) -> List[str]:
        """Every pending submission resolves or fails definitively."""
        self.workload.ack(timeout=timeout)
        failures = [
            f"lease for object {ref.hex[:8]} hung (neither completed "
            "nor failed definitively)"
            for ref, _ in self.workload.pending
        ]
        # definite failures are legal ONLY as exhausted-retry /
        # dead-actor / cancelled errors
        for h, reason in self.workload.failed_pending:
            low = reason.lower()
            if not any(
                key in low
                for key in (
                    "retries exhausted",
                    "retry",
                    "died",
                    "dead",
                    "cancelled",
                    "unreachable",
                    "lost",
                )
            ):
                failures.append(
                    f"lease for object {h[:8]} failed with an "
                    f"unexpected error: {reason}"
                )
        self.workload.failed_pending.clear()
        return failures

    def wait_owner_reaped(self, cid: str, timeout: float) -> List[str]:
        """After an owner SIGKILL: within the budget the head must hold
        ZERO live non-detached actors, ZERO task-lease rows, and no
        session for that client — the full fate-sharing reap."""
        head = self.cluster.head
        deadline = time.monotonic() + timeout
        actors: List[str] = []
        leases: List[str] = []
        session = True
        while time.monotonic() < deadline:
            with head._lock:
                actors = [
                    a.actor_id
                    for a in head._actors.values()
                    if a.owner_client == cid
                    and a.lifetime != "detached"
                    and a.state != "DEAD"
                ]
                leases = [
                    lid
                    for lid, e in head._task_leases.items()
                    if e.get("client_id") == cid
                ]
                session = cid in head._owner_sessions
            if not actors and not leases and not session:
                return []
            time.sleep(0.2)
        out = []
        if actors:
            out.append(
                f"owner {cid[:8]} leaked {len(actors)} live actors "
                f"after death"
            )
        if leases:
            out.append(
                f"owner {cid[:8]} leaked {len(leases)} worker leases "
                f"after death"
            )
        if session:
            out.append(f"owner {cid[:8]} session never declared dead")
        return out

    def wait_standby_promoted(
        self, pre_epoch: int, timeout: float
    ) -> List[str]:
        """After a head_kill_promote: within the budget the cluster must
        have EXACTLY ONE leader — a promoted head whose epoch strictly
        exceeds the killed leader's — and every other head incarnation
        this cluster ever ran must be down or self-fenced (its writes
        provably rejected)."""
        from ray_tpu_torch.cluster.rpc import RpcClient

        deadline = time.monotonic() + timeout
        head = self.cluster.head
        while time.monotonic() < deadline:
            head = self.cluster.head
            if (
                getattr(head, "role", "leader") == "leader"
                and not getattr(head, "_fenced", False)
                and not getattr(head, "_shutdown", False)
                and head.cluster_epoch > pre_epoch
            ):
                # every prior incarnation provably inert: its listener
                # is down, or what still answers identifies as fenced
                # (self-fenced deposed leader, writes rejected)
                live_old_leaders = []
                for h in getattr(self.cluster, "_dead_heads", []):
                    probe = RpcClient(h.address)
                    try:
                        role = probe.call("HeadRole", {}, timeout=2.0)
                    except Exception:  # noqa: BLE001 - listener down: inert
                        continue
                    finally:
                        probe.close()
                    if (
                        isinstance(role, dict)
                        and role.get("role") == "leader"
                        and role.get("epoch") == h.cluster_epoch
                    ):
                        live_old_leaders.append(h.address)
                if not live_old_leaders:
                    return []
                return [
                    "split-brain: prior head(s) still answering as "
                    f"leader: {live_old_leaders}"
                ]
            time.sleep(0.05)
        return [
            "standby never promoted: head epoch "
            f"{getattr(head, 'cluster_epoch', 0)} vs pre-kill "
            f"{pre_epoch}, role={getattr(head, 'role', '?')}, "
            f"fenced={getattr(head, '_fenced', '?')} after {timeout:.0f}s"
        ]

    def wait_inflight_survive(self, adapter, timeout: float) -> List[str]:
        """After a failover: every lease wave submitted BEFORE the kill
        completes (or fails definitively) through the new leader with
        zero acked-object loss; active serve streams (when a serve
        adapter drives them) keep completing token-exact."""
        failures = self.check_leases_drained(timeout=timeout)
        failures += self.workload.verify_acked(timeout=timeout)
        if adapter is not None:
            failures += self.wait_streams_resume(adapter, timeout=timeout)
        return failures

    def wait_streams_resume(self, adapter, timeout: float) -> List[str]:
        """After a replica_kill: in-flight streams must fail over (or
        restart) and KEEP COMPLETING with byte-exact token sequences —
        any recorded verification failure means an acked token was
        duplicated or dropped, an immediate invariant breach."""
        if adapter is None:
            return ["replica_kill injected with no serve adapter"]
        deadline = time.monotonic() + timeout
        base = adapter.completed
        while time.monotonic() < deadline:
            if adapter.verify_failures:
                return list(adapter.verify_failures)
            if adapter.completed > base:
                return []
            time.sleep(0.2)
        if adapter.verify_failures:
            return list(adapter.verify_failures)
        return [
            f"no stream completed within {timeout:.0f}s after the "
            "replica kill (streams wedged instead of failing over)"
        ]

    def wait_streams_resume_cross_router(
        self, adapter, timeout: float
    ) -> List[str]:
        """After a router_kill: EVERY stream that was in flight on the
        killed router must complete token-exact on a sibling — the
        replicated delivered-count checkpoint plus the consumer-side
        skip window may neither duplicate nor drop one acked delta.
        A watched stream erroring out entirely is also a breach (the
        failover path wedged), unlike replica_kill where hard errors
        on unlucky double-kills are tolerated."""
        if adapter is None:
            return ["router_kill injected with no serve adapter"]
        watched = getattr(adapter, "watched_outcomes", None)
        if watched is None:
            return ["router_kill injected but adapter tracks no streams"]
        deadline = time.monotonic() + timeout
        outcomes: dict = {}
        while time.monotonic() < deadline:
            if adapter.verify_failures:
                return list(adapter.verify_failures)
            outcomes = watched()
            if outcomes and all(
                v != "pending" for v in outcomes.values()
            ):
                break
            if not outcomes:
                break  # kill landed with nothing in flight: nothing owed
            time.sleep(0.2)
        failures = []
        bad = sorted(
            sid for sid, v in outcomes.items() if v != "ok"
        )
        if bad:
            failures.append(
                f"{len(bad)}/{len(outcomes)} in-flight stream(s) did "
                "not resume token-exact on a sibling router after the "
                f"kill: {[f'{s[:8]}={outcomes[s]}' for s in bad]}"
            )
        # and the fleet keeps serving: fresh streams still complete
        failures += self.wait_streams_resume(
            adapter, timeout=max(1.0, deadline - time.monotonic())
        )
        return failures

    def wait_replica_backfilled(self, adapter, timeout: float) -> List[str]:
        """After a replica_kill the replica set must restore its desired
        count with replicas that actually answer calls."""
        if adapter is None:
            return []
        deadline = time.monotonic() + timeout
        live = 0
        while time.monotonic() < deadline:
            live = adapter.live_replicas()
            if live >= adapter.target_replicas():
                return []
            time.sleep(0.3)
        return [
            f"replica set not backfilled: {live}/"
            f"{adapter.target_replicas()} live replicas after "
            f"{timeout:.0f}s"
        ]

    def wait_prefill_backfilled(self, adapter, timeout: float) -> List[str]:
        """After a prefill_kill the prefill tier must restore its desired
        replica count with workers that actually answer calls. Adapters
        without a prefill surface owe nothing (monolithic deployment)."""
        if adapter is None or getattr(adapter, "prefill_rs", None) is None:
            return []
        deadline = time.monotonic() + timeout
        live = 0
        while time.monotonic() < deadline:
            live = adapter.live_prefill()
            if live >= adapter.target_prefill():
                return []
            time.sleep(0.3)
        return [
            f"prefill tier not backfilled: {live}/"
            f"{adapter.target_prefill()} live prefill workers after "
            f"{timeout:.0f}s"
        ]

    def arena_zombies(self) -> int:
        """Sum of deleted-with-outstanding-pins entries across every live
        node's arena (agent DebugState ``object_plane.arena_zombies``)."""
        from ray_tpu_torch.cluster.rpc import RpcClient

        total = 0
        head = self.cluster.head
        with head._lock:
            nodes = [
                (nid, n.address) for nid, n in head.nodes.items() if n.alive
            ]
        for nid, addr in nodes:
            client = RpcClient(addr)
            try:
                state = client.call("DebugState", timeout=10.0)
                total += int(
                    (state.get("object_plane") or {}).get("arena_zombies", 0)
                )
            except Exception:  # noqa: BLE001 - node mid-death
                pass
            finally:
                client.close()
        return total

    def wait_arena_zombies_zero(self, timeout: float = 15.0) -> int:
        """Poll until the cluster-wide zombie count reaches zero (frees
        may still be in flight right after the last fault); returns the
        final count (0 = invariant holds)."""
        deadline = time.monotonic() + timeout
        count = self.arena_zombies()
        while count > 0 and time.monotonic() < deadline:
            time.sleep(0.5)
            count = self.arena_zombies()
        return count

    def wait_gang_reshaped(
        self, prekill_epochs: Dict[str, int], timeout: float
    ) -> List[str]:
        """Elastic-training invariant after a rank_node_kill: every gang
        that had a member on the corpse either advances its epoch past
        the pre-kill value AND re-registers a membership whose nodes are
        all alive (the reshaped generation), or finishes and
        unregisters. Reads ``cluster.head`` each poll — the head object
        can be replaced by a failover mid-soak."""
        deadline = time.monotonic() + timeout
        failures: List[str] = []
        while time.monotonic() < deadline:
            head = self.cluster.head
            with head._lock:
                gangs = {
                    gid: {
                        "epoch": g["epoch"],
                        "members": dict(g["members"]),
                    }
                    for gid, g in head._gangs.items()
                }
                alive = {
                    nid for nid, n in head.nodes.items() if n.alive
                }
            failures = []
            for gid, pre_epoch in prekill_epochs.items():
                g = gangs.get(gid)
                if g is None:
                    continue  # finished + unregistered: converged
                if g["epoch"] <= pre_epoch:
                    failures.append(
                        f"gang {gid}: epoch {g['epoch']} never advanced "
                        f"past pre-kill {pre_epoch}"
                    )
                elif not set(g["members"].values()) <= alive:
                    failures.append(
                        f"gang {gid}: reshaped membership still names "
                        f"dead node(s) "
                        f"{sorted(set(g['members'].values()) - alive)}"
                    )
            if not failures:
                return []
            time.sleep(0.3)
        return failures

    def wait_weights_epoch_converged(
        self, rl_adapter, timeout: float
    ) -> List[str]:
        """Online-RL invariant: the fleet converges on the
        published weights epoch — live rollout replicas span at most ONE
        epoch between them and none sits below ``published - 1``. While
        the trainer keeps publishing, one swap is always legitimately in
        flight toward some replica (so demanding bit-equal epochs at a
        sampled instant would flake against a moving frontier); a swap
        that is actually LOST still trips this, because the dead
        replica falls ever further behind as publishes keep landing on
        its peers. Also asserts publish atomicity: the committed epoch
        the control plane reports never reads torn (a sealed-but-
        uncommitted phase must coexist with the OLD committed value)."""
        deadline = time.monotonic() + timeout
        failures: List[str] = []
        while time.monotonic() < deadline:
            failures = []
            try:
                published = int(rl_adapter.published_epoch())
                epochs = list(rl_adapter.replica_epochs())
            except Exception as e:  # noqa: BLE001 - control plane moving
                failures = [f"weights epoch state unreadable: {e!r}"]
                time.sleep(0.3)
                continue
            if not epochs:
                failures.append("no live rollout replica reported an epoch")
            elif max(epochs) - min(epochs) > 1:
                failures.append(
                    f"replica weights epochs diverged: {sorted(epochs)} "
                    f"(published={published})"
                )
            elif min(epochs) < published - 1:
                failures.append(
                    f"replica stuck {published - min(epochs)} epochs "
                    f"behind published {published}"
                )
            if not failures:
                return []
            time.sleep(0.3)
        return failures

    def wait_trajectory_accounting(
        self, rl_adapter, timeout: float
    ) -> List[str]:
        """Online-RL conservation law: every emitted trajectory is
        trained, dropped stale, or still in flight — zero unaccounted.
        A trajectory silently lost (or silently trained twice) breaks
        ``emitted == trained + dropped_stale + in_flight``."""
        deadline = time.monotonic() + timeout
        failures: List[str] = []
        while time.monotonic() < deadline:
            try:
                acct = dict(rl_adapter.trajectory_accounting())
            except Exception as e:  # noqa: BLE001
                failures = [f"trajectory accounting unreadable: {e!r}"]
                time.sleep(0.3)
                continue
            if acct.get("unaccounted", None) == 0:
                return []
            failures = [f"trajectory accounting does not balance: {acct}"]
            time.sleep(0.3)
        return failures

    def check_durable_state(self, pre: Snapshot) -> List[str]:
        head = self.cluster.head
        failures: List[str] = []
        with head._lock:
            kv = dict(head._kv)
            named = dict(head._named_actors)
        for key, value in pre.kv.items():
            if kv.get(key) != value:
                failures.append(
                    f"durable kv {key!r} diverged after recovery"
                )
        for name, aid in pre.named_actors.items():
            if named.get(name) != aid:
                failures.append(
                    f"named actor {name!r} lost its binding after recovery"
                )
        return failures

    def check_convergence(self, pre: Snapshot) -> CheckResult:
        deadline = time.monotonic() + self.actor_restart_budget_s
        failures: List[str] = []
        miss = self.wait_membership(deadline)
        if miss:
            failures.append(miss)
        failures.extend(self.wait_actors(deadline))
        failures.extend(
            self.check_leases_drained(timeout=self.object_timeout_s)
        )
        failures.extend(
            self.workload.verify_acked(timeout=self.object_timeout_s)
        )
        failures.extend(self.check_durable_state(pre))
        return CheckResult(ok=not failures, failures=failures)
