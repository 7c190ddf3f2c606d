"""Deterministic chaos orchestrator.

Executes a seeded :class:`~ray_tpu_torch.chaos.plan.ChaosPlan` against a live
:class:`~ray_tpu_torch.cluster.cluster_utils.Cluster`, interleaving faults with
a verifiable workload and asserting invariant convergence after every
injection. Fault kinds:

- ``kill_node``      — SIGKILL an agent process; a replacement node joins
                       so capacity (and actor restart targets) survive a
                       long soak.
- ``head_restart``   — restart the head mid-flight on the same port
                       (requires a persist_path so durable state recovers).
- ``partition``      — per-peer RPC blackhole from the control plane to
                       one node for a bounded hold, then heal. Long holds
                       open the circuit breaker into the health path;
                       short holds exercise retry/spillback only.
- ``straggler``      — delay ramp on one node's RPC path (injected
                       latency rises, holds, falls back to zero).
- ``object_drop``    — destroy every stored copy of an acked object and
                       drop its directory entries; lineage must rebuild
                       it.

- ``owner_kill``      — SIGKILL a sacrificial OWNER process (a real
                       driver in its own process, ``owner_proc.py``);
                       the head must notice purely through missed owner
                       heartbeats and reap its actors/leases/objects
                       with nothing leaked.
- ``zygote_kill``     — SIGKILL one node's fork-server (taking its
                       forked workers with it); worker spawns must keep
                       succeeding (zygote restart or cold spawn).
- ``replica_kill``    — SIGKILL a serving replica's worker mid-stream
                       (requires a registered ``serve_adapter``);
                       in-flight streams must fail over with no
                       duplicated/dropped acked tokens and the replica
                       set must backfill to its desired count.
- ``prefill_kill``    — SIGKILL a PREFILL-tier worker of a disaggregated
                       serving deployment mid-KV-handoff; decode
                       replicas must fall back to local re-prefill
                       (token-exact — generation is seed-deterministic),
                       streams keep completing, and the prefill tier
                       backfills to its desired count.
- ``rank_node_kill``  — SIGKILL a node hosting elastic training gang
                       ranks (picked from the head's gang table); the
                       gang must fence its epoch, reshape to the
                       surviving topology, and resume from object-plane
                       seals with no disk restore.

Every fault records recovery latency = time from injection until all
invariants are green again; the run result carries p50/p95 plus objects
reconstructed and the post-soak arena zombie count, for the bench chaos
tier.

Port of ``ray_tpu/chaos/orchestrator.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import json
import logging
import os
import random
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.util.metrics import Counter as _Counter
from ray_tpu_torch.util.metrics import Histogram as _Histogram

from .invariants import InvariantChecker
from .plan import ChaosPlan, FaultSpec
from .workload import ChaosWorkload

logger = logging.getLogger("ray_tpu_torch.chaos")

CHAOS_FAULTS = _Counter(
    "chaos_faults_injected_total",
    "Faults injected by the chaos orchestrator.",
    label_names=("kind",),
)
CHAOS_INVARIANT_FAILURES = _Counter(
    "chaos_invariant_failures_total",
    "Invariant checks that failed after a fault converged.",
    label_names=("kind",),
)
CHAOS_RECOVERY = _Histogram(
    "chaos_recovery_seconds",
    "Time from fault injection to all invariants green.",
)


@dataclass
class FaultResult:
    spec: FaultSpec
    ok: bool
    recovery_s: float
    failures: List[str] = field(default_factory=list)
    detail: str = ""


@dataclass
class ChaosRunResult:
    seed: int
    faults: List[FaultResult] = field(default_factory=list)
    objects_reconstructed: int = 0
    objects_acked: int = 0
    # deleted-with-outstanding-pins arena entries still alive after the
    # soak settled: any nonzero value is a reader-pin leak
    arena_zombies_after: int = 0
    owners_killed: int = 0

    @property
    def ok(self) -> bool:
        return all(f.ok for f in self.faults)

    def recovery_percentiles(self) -> Dict[str, float]:
        lat = sorted(f.recovery_s for f in self.faults)
        if not lat:
            return {"p50": 0.0, "p95": 0.0}
        return {
            "p50": lat[len(lat) // 2],
            "p95": lat[min(len(lat) - 1, int(len(lat) * 0.95))],
        }

    def summary(self) -> dict:
        counts: Dict[str, int] = {}
        for f in self.faults:
            counts[f.spec.kind] = counts.get(f.spec.kind, 0) + 1
        return {
            "seed": self.seed,
            "ok": self.ok,
            "faults_injected": len(self.faults),
            "fault_counts": counts,
            "objects_acked": self.objects_acked,
            "objects_reconstructed": self.objects_reconstructed,
            "arena_zombies_after": self.arena_zombies_after,
            "owners_killed": self.owners_killed,
            "recovery_latency_s": self.recovery_percentiles(),
            "failures": [
                {"fault": f.spec.index, "kind": f.spec.kind, "why": f.failures}
                for f in self.faults
                if not f.ok
            ],
        }


class ChaosOrchestrator:
    def __init__(
        self,
        cluster,
        workload: ChaosWorkload,
        plan: ChaosPlan,
        *,
        node_resources: Optional[dict] = None,
        workers_per_node: int = 2,
        tasks_per_step: int = 4,
        partition_hold_s: float = 1.0,
        straggler_peak_s: float = 0.3,
        convergence_budget_s: float = 60.0,
        serve_adapter=None,
        rl_adapter=None,
    ):
        self.cluster = cluster
        self.workload = workload
        self.plan = plan
        self.node_resources = dict(node_resources or {"CPU": 2.0})
        self.workers_per_node = workers_per_node
        self.tasks_per_step = tasks_per_step
        self.partition_hold_s = partition_hold_s
        self.straggler_peak_s = straggler_peak_s
        self.convergence_budget_s = float(convergence_budget_s)
        self.checker = InvariantChecker(
            cluster,
            workload,
            actor_restart_budget_s=convergence_budget_s,
            object_timeout_s=convergence_budget_s,
        )
        # runtime randomness (victim picks among equivalent live nodes)
        # derives from the plan seed too: full-run determinism modulo
        # scheduler placement
        self._rng = random.Random(plan.seed ^ 0x5EED)
        # sacrificial owner process (owner_kill): pre-spawned so the kill
        # never pays setup latency inside a fault's recovery window
        self._owner_proc: Optional[subprocess.Popen] = None
        self._owner_info_path: Optional[str] = None
        self._killed_owner: Optional[dict] = None
        # serving-plane adapter (chaos/serve.py ServeStreamWorkload):
        # victim selection + stream/replica invariants for replica_kill
        self.serve_adapter = serve_adapter
        self._killed_replica: Optional[int] = None
        self._killed_prefill: Optional[int] = None
        # online-RL adapter: rollout victim selection, the
        # publish-hold kill window, and the epoch/accounting invariants
        self.rl_adapter = rl_adapter
        self._killed_rollout: Optional[int] = None
        self._killed_trainer_gangs: Optional[Dict[str, int]] = None
        self._head_killed_mid_publish = False

    # -- sacrificial owner ----------------------------------------------
    def _spawn_owner_proc(self) -> None:
        """Start (or replace) the sacrificial owner driver, async — the
        info file appears once its actors are ALIVE."""
        if self._owner_proc is not None:
            # replacing after an owner_kill: reap the corpse and drop its
            # info file, or a long soak leaks one of each per kill
            self._stop_owner_proc()
        fd, path = tempfile.mkstemp(prefix="ray_tpu_chaos_owner_")
        os.close(fd)
        os.unlink(path)  # owner_proc writes it atomically when ready
        self._owner_info_path = path
        self._owner_proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "ray_tpu_torch.chaos.owner_proc",
                "--head",
                self.cluster.address,
                "--info-file",
                path,
                "--actors",
                "1",
            ]
        )

    def _owner_info(self) -> Optional[dict]:
        if self._owner_info_path is None:
            return None
        try:
            with open(self._owner_info_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _stop_owner_proc(self) -> None:
        if self._owner_proc is not None and self._owner_proc.poll() is None:
            self._owner_proc.kill()
            self._owner_proc.wait(timeout=10)
        if self._owner_info_path:
            try:
                os.unlink(self._owner_info_path)
            except OSError:
                pass

    # -- node selection -------------------------------------------------
    def _live_nodes(self) -> List[str]:
        return sorted(
            nid
            for nid, info in self.cluster.head.nodes.items()
            if info.alive
            and self.cluster._agents.get(nid) is not None
            and self.cluster._agents[nid].poll() is None
        )

    def _pick_node(self, spec: FaultSpec) -> Optional[str]:
        live = self._live_nodes()
        if not live:
            return None
        return live[spec.target % len(live)]

    # -- fault injection ------------------------------------------------
    def _inject(self, spec: FaultSpec) -> str:
        kind = spec.kind
        CHAOS_FAULTS.inc(labels={"kind": kind})
        if kind == "kill_node":
            nid = self._pick_node(spec)
            if nid is None:
                return "skipped: no live node to kill"
            self.cluster.kill_node(nid)
            # backfill so capacity and restart targets survive the soak
            self.cluster.add_node(
                dict(self.node_resources),
                num_workers=self.workers_per_node,
                wait=False,
            )
            return f"killed {nid}, replacement joining"
        if kind == "head_restart":
            if not self.cluster._persist_path:
                return "skipped: no persist_path (head restart needs one)"
            self.cluster.restart_head()
            return "head restarted on the same port"
        if kind == "head_kill_promote":
            standby = getattr(self.cluster, "standby", None)
            if standby is None or standby.promoted is not None:
                return "skipped: no armed warm standby"
            self._pre_kill_epoch = self.cluster.head.cluster_epoch
            self._head_killed = True
            self.cluster.kill_head()
            if not standby.auto_promote:
                self.cluster.promote()
            return (
                "SIGKILLed the leader (epoch "
                f"{self._pre_kill_epoch}); standby promoting"
            )
        if kind == "partition":
            nid = self._pick_node(spec)
            if nid is None:
                return "skipped: no live node to partition"
            hold = self.partition_hold_s * (0.5 + spec.magnitude)
            self.cluster.partition_node(nid)
            time.sleep(hold)
            self.cluster.heal_node(nid)
            return f"partitioned {nid} for {hold:.2f}s"
        if kind == "straggler":
            nid = self._pick_node(spec)
            if nid is None:
                return "skipped: no live node to slow down"
            peak = self.straggler_peak_s * (0.5 + spec.magnitude)
            # ramp up, hold, ramp down — a drifting slow node, not a cliff
            for frac in (0.33, 0.66, 1.0):
                self.cluster.set_node_delay(nid, peak * frac)
                time.sleep(0.1)
            time.sleep(0.2)
            self.cluster.set_node_delay(nid, 0.0)
            return f"straggler ramp on {nid} peaking at {peak:.2f}s"
        if kind == "object_drop":
            ref = self.workload.sample_acked_ref(self._rng)
            if ref is None:
                return "skipped: nothing acked to drop yet"
            if not self.cluster.head.chaos_drop_object(ref.hex):
                return f"skipped: {ref.hex[:8]} not droppable (inline?)"
            self._dropped_hex = ref.hex
            return f"dropped all copies of {ref.hex[:8]}"
        if kind == "owner_kill":
            proc = self._owner_proc
            info = self._owner_info()
            if proc is None or proc.poll() is not None or info is None:
                return "skipped: sacrificial owner not ready yet"
            proc.kill()  # SIGKILL: no DisconnectClient, no atexit
            proc.wait(timeout=10)
            self._killed_owner = info
            return (
                f"SIGKILLed owner {info['client_id'][:8]} "
                f"(pid {info['pid']}, {len(info['actor_ids'])} actors)"
            )
        if kind == "replica_kill":
            if self.serve_adapter is None:
                return "skipped: no serve workload registered"
            pid = self.serve_adapter.pick_replica_pid(self._rng)
            if pid is None:
                return "skipped: no live replica to kill"
            import signal as _signal

            try:
                os.kill(pid, _signal.SIGKILL)
            except OSError:
                return f"skipped: replica pid {pid} already gone"
            self._killed_replica = pid
            return f"SIGKILLed serve replica worker pid {pid}"
        if kind == "prefill_kill":
            # SIGKILL a prefill-tier worker mid-KV-handoff: any handoff
            # it was sealing dies with it, so decode replicas must fall
            # back to local re-prefill (seed-deterministic, hence
            # token-exact) and the router keeps admitting while the
            # prefill tier backfills
            if self.serve_adapter is None:
                return "skipped: no serve workload registered"
            pick = getattr(self.serve_adapter, "pick_prefill_pid", None)
            if pick is None:
                return "skipped: serve workload has no prefill tier"
            pid = pick(self._rng)
            if pid is None:
                return "skipped: no live prefill worker to kill"
            import signal as _signal

            try:
                os.kill(pid, _signal.SIGKILL)
            except OSError:
                return f"skipped: prefill pid {pid} already gone"
            self._killed_prefill = pid
            return f"SIGKILLed prefill worker pid {pid} mid-handoff"
        if kind == "router_kill":
            # abruptly kill one ingress router of the fleet: its push
            # endpoint vanishes and its in-flight streams FAIL; the
            # siblings inheriting the hash ranges must resume every one
            # token-exact from the replicated delivered checkpoints
            if self.serve_adapter is None:
                return "skipped: no serve workload registered"
            kill = getattr(self.serve_adapter, "kill_router", None)
            if kill is None:
                return "skipped: serve workload is not fleet-aware"
            rid = kill(self._rng)
            if rid is None:
                return "skipped: no killable router (fleet of one?)"
            self._killed_router = rid
            return f"killed ingress router {rid} mid-stream"
        if kind == "peer_conn_drop":
            # sever every data socket one node is SERVING mid-transfer:
            # pullers' in-flight stripes fail and must RESUME (only the
            # lost stripes re-fetch — zero acked loss, no duplicate
            # bytes), which the invariant checker asserts afterwards
            nid = self._pick_node(spec)
            if nid is None:
                return "skipped: no live node"
            addr = self.cluster.agent_address(nid)
            if addr is None:
                return "skipped: node has no address"
            from ray_tpu_torch.cluster.rpc import RpcClient, RpcError

            client = RpcClient(addr)
            try:
                reply = client.call("ChaosDropPeerConn", timeout=10.0)
            except RpcError:
                return f"skipped: agent {nid} unreachable"
            finally:
                client.close()
            return (
                f"severed {reply.get('dropped', 0)} data socket(s) "
                f"served by {nid}"
            )
        if kind == "rank_node_kill":
            # SIGKILL a node hosting elastic gang ranks, chosen from the
            # head's gang table: the gang-epoch protocol must fence the
            # dead generation, reshape to the surviving topology, and
            # resume from object-plane seals (no disk restore)
            head = self.cluster.head
            with head._lock:
                gangs = {
                    gid: {
                        "epoch": g["epoch"],
                        "members": dict(g["members"]),
                    }
                    for gid, g in head._gangs.items()
                }
            live = set(self._live_nodes())
            hosts = sorted(
                {
                    n
                    for g in gangs.values()
                    for n in g["members"].values()
                    if n in live
                }
            )
            if not hosts:
                return "skipped: no live node hosts an elastic gang rank"
            nid = hosts[spec.target % len(hosts)]
            self._killed_gang_nodes = {
                gid: g["epoch"]
                for gid, g in gangs.items()
                if nid in g["members"].values()
            }
            self.cluster.kill_node(nid)
            # backfill so the gang can grow back during the soak
            self.cluster.add_node(
                dict(self.node_resources),
                num_workers=self.workers_per_node,
                wait=False,
            )
            return (
                f"SIGKILLed rank node {nid} "
                f"({len(self._killed_gang_nodes)} gang(s) fencing)"
            )
        if kind == "node_drain":
            # cooperative drain-ahead retire: head zeroes the
            # node's advertised capacity, preemptively migrates leased
            # work off it before the deadline, then terminates the agent.
            # Unlike kill_node the work is moved, not lost — retryable
            # leases must land elsewhere with zero attempts burned.
            live = self._live_nodes()
            if len(live) < 2:
                return "skipped: need >=2 live nodes to drain one"
            nid = live[spec.target % len(live)]
            drain = getattr(self.cluster, "drain_node", None)
            if drain is None:
                return "skipped: cluster has no drain support"
            deadline = 5.0 + 10.0 * spec.magnitude
            drained = drain(nid, deadline_s=deadline)
            # backfill so capacity survives the soak
            self.cluster.add_node(
                dict(self.node_resources),
                num_workers=self.workers_per_node,
                wait=False,
            )
            return (
                f"drained {nid} ({'clean' if drained else 'deadline'}) "
                f"within {deadline:.1f}s, replacement joining"
            )
        if kind == "rollout_kill":
            # SIGKILL a rollout replica mid-trajectory: its in-flight
            # streams fail over token-exact via resume_from, and the
            # re-emitted trajectories dedup by id in the feed — the
            # accounting invariant stays balanced
            if self.rl_adapter is None:
                return "skipped: no RL workload registered"
            pid = self.rl_adapter.pick_rollout_pid(self._rng)
            if pid is None:
                return "skipped: no live rollout replica to kill"
            import signal as _signal

            try:
                os.kill(pid, _signal.SIGKILL)
            except OSError:
                return f"skipped: rollout pid {pid} already gone"
            self._killed_rollout = pid
            return f"SIGKILLed rollout replica pid {pid} mid-trajectory"
        if kind == "trainer_rank_kill":
            # SIGKILL a node hosting ranks of the RL TRAINER's gang
            # mid-step: the gang reshapes and the replayed step
            # pulls the identical batch from the feed's step cache, so
            # the loss curve stays continuous vs the unkilled reference
            if self.rl_adapter is None:
                return "skipped: no RL workload registered"
            gang_ids = set(self.rl_adapter.trainer_gang_ids())
            if not gang_ids:
                return "skipped: RL trainer gang not registered yet"
            head = self.cluster.head
            with head._lock:
                gangs = {
                    gid: {
                        "epoch": g["epoch"],
                        "members": dict(g["members"]),
                    }
                    for gid, g in head._gangs.items()
                    if gid in gang_ids
                }
            live = set(self._live_nodes())
            hosts = sorted(
                {
                    n
                    for g in gangs.values()
                    for n in g["members"].values()
                    if n in live
                }
            )
            if not hosts:
                return "skipped: no live node hosts an RL trainer rank"
            nid = hosts[spec.target % len(hosts)]
            self._killed_trainer_gangs = {
                gid: g["epoch"]
                for gid, g in gangs.items()
                if nid in g["members"].values()
            }
            self.cluster.kill_node(nid)
            self.cluster.add_node(
                dict(self.node_resources),
                num_workers=self.workers_per_node,
                wait=False,
            )
            return (
                f"SIGKILLed RL trainer rank node {nid} "
                f"({len(self._killed_trainer_gangs)} gang(s) fencing)"
            )
        if kind == "head_kill_mid_publish":
            # kill the leader INSIDE the seal->commit window of a
            # two-phase weights publish: the adapter holds the publisher
            # between phases, we SIGKILL the head there, the standby
            # promotes, and the release lets the publisher's retry land
            # against the new leader — either the old or the new epoch
            # becomes visible, never a torn in-between
            if self.rl_adapter is None:
                return "skipped: no RL workload registered"
            standby = getattr(self.cluster, "standby", None)
            if standby is None or standby.promoted is not None:
                return "skipped: no armed warm standby"
            # how long a publish cycle can take under chaos scales with
            # the same recovery envelope the convergence budget models —
            # a fixed small window skips the fault whenever the trainer
            # is mid-recovery from an earlier kill
            arm_s = min(60.0, max(20.0, self.convergence_budget_s / 3.0))
            if not self.rl_adapter.arm_publish_hold(timeout=arm_s):
                return "skipped: no publish entered the seal window"
            try:
                self._pre_kill_epoch = self.cluster.head.cluster_epoch
                self._head_killed = True
                self._head_killed_mid_publish = True
                self.cluster.kill_head()
                if not standby.auto_promote:
                    self.cluster.promote()
            finally:
                self.rl_adapter.release_publish_hold()
            return (
                "SIGKILLed the leader inside a seal->commit window "
                f"(epoch {self._pre_kill_epoch}); standby promoting"
            )
        if kind == "zygote_kill":
            nid = self._pick_node(spec)
            if nid is None:
                return "skipped: no live node"
            addr = self.cluster.agent_address(nid)
            if addr is None:
                return "skipped: node has no address"
            from ray_tpu_torch.cluster.rpc import RpcClient, RpcError

            client = RpcClient(addr)
            try:
                reply = client.call("ChaosKillZygote", timeout=10.0)
            except RpcError:
                return f"skipped: agent {nid} unreachable"
            finally:
                client.close()
            if not reply.get("killed"):
                return f"skipped: {reply.get('reason')}"
            return f"killed zygote pid {reply['pid']} on {nid}"
        raise ValueError(f"unknown fault kind {kind!r}")

    # -- the run --------------------------------------------------------
    def run(self) -> ChaosRunResult:
        result = ChaosRunResult(seed=self.plan.seed)
        if any(f.kind == "owner_kill" for f in self.plan.faults):
            self._spawn_owner_proc()
        try:
            for spec in self.plan.faults:
                self.workload.step(self.tasks_per_step)
                time.sleep(spec.delay_s)
                pre = self.checker.snapshot()
                t0 = time.monotonic()
                self._dropped_hex: Optional[str] = None
                self._killed_owner = None
                self._killed_replica = None
                self._killed_prefill = None
                self._killed_router: Optional[str] = None
                self._killed_gang_nodes: Optional[Dict[str, int]] = None
                self._head_killed = False
                self._pre_kill_epoch = 0
                self._killed_rollout = None
                self._killed_trainer_gangs = None
                self._head_killed_mid_publish = False
                detail = self._inject(spec)
                logger.info(
                    "chaos #%d %s: %s", spec.index, spec.kind, detail
                )
                if not self._head_killed:
                    # flight recorder: snapshot the head's
                    # events/spans/metrics while the fault is fresh
                    # (head faults dump from the promotion path instead
                    # — this head is the corpse)
                    try:
                        self.cluster.head._dump_crash_bundle(
                            f"chaos-{spec.kind}"
                        )
                    except Exception:  # noqa: BLE001 - best-effort
                        pass
                promote_failures: List[str] = []
                if self._head_killed:
                    # the promotion must land BEFORE the generic
                    # convergence pass (which reads cluster.head): epoch
                    # strictly increased, exactly one unfenced leader,
                    # then every in-flight wave started before the kill
                    # completes with zero acked loss
                    promote_failures = self.checker.wait_standby_promoted(
                        self._pre_kill_epoch,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    promote_failures += self.checker.wait_inflight_survive(
                        self.serve_adapter,
                        timeout=self.checker.object_timeout_s,
                    )
                check = self.checker.check_convergence(pre)
                if promote_failures:
                    check.ok = False
                    check.failures = promote_failures + check.failures
                if self._head_killed:
                    # re-arm a fresh standby so later faults in the soak
                    # can fail over again (the promoted one is consumed)
                    standby = self.cluster.standby
                    try:
                        self.cluster.start_standby(
                            auto_promote=(
                                standby.auto_promote
                                if standby is not None
                                else True
                            )
                        )
                    except Exception:  # noqa: BLE001 - judged above
                        logger.exception("could not re-arm a standby")
                if self._dropped_hex is not None:
                    # the drop's specific victim must rebuild (the sampled
                    # acked sweep may not have included it)
                    miss = self.workload.verify_ref(
                        self._dropped_hex,
                        timeout=self.checker.object_timeout_s,
                    )
                    if miss:
                        check.ok = False
                        check.failures.append(miss)
                if self._killed_owner is not None:
                    # nothing of the dead owner's may outlive the liveness
                    # window: no ALIVE actors, no lease rows, no session
                    result.owners_killed += 1
                    owner_fail = self.checker.wait_owner_reaped(
                        self._killed_owner["client_id"],
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    if owner_fail:
                        check.ok = False
                        check.failures.extend(owner_fail)
                    # pre-warm the next sacrificial owner off the clock
                    self._spawn_owner_proc()
                if self._killed_gang_nodes:
                    # elastic-training invariant: every gang that had a
                    # rank on the corpse advances its epoch (the dead
                    # generation is fenced) and re-registers a healthy
                    # membership — or finishes and unregisters
                    gang_fail = self.checker.wait_gang_reshaped(
                        self._killed_gang_nodes,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    if gang_fail:
                        check.ok = False
                        check.failures.extend(gang_fail)
                if self._killed_replica is not None:
                    # serving invariants: in-flight streams fail over or
                    # restart with no duplicated/dropped acked tokens,
                    # and the replica set backfills to its target
                    serve_fail = self.checker.wait_streams_resume(
                        self.serve_adapter,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    serve_fail += self.checker.wait_replica_backfilled(
                        self.serve_adapter,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    if serve_fail:
                        check.ok = False
                        check.failures.extend(serve_fail)
                if self._killed_prefill is not None:
                    # disaggregated-serving invariants: streams keep
                    # completing token-exact (decode falls back to local
                    # re-prefill when the handoff producer died) and the
                    # prefill tier backfills to its desired count
                    pre_fail = self.checker.wait_streams_resume(
                        self.serve_adapter,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    pre_fail += self.checker.wait_prefill_backfilled(
                        self.serve_adapter,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    if pre_fail:
                        check.ok = False
                        check.failures.extend(pre_fail)
                if self._killed_router is not None:
                    # router-fleet invariant: every stream that was in
                    # flight on the corpse completes token-exact on a
                    # sibling (zero duplicated/dropped acked deltas),
                    # and fresh streams keep completing after the kill
                    fleet_fail = (
                        self.checker.wait_streams_resume_cross_router(
                            self.serve_adapter,
                            timeout=self.checker.actor_restart_budget_s,
                        )
                    )
                    if fleet_fail:
                        check.ok = False
                        check.failures.extend(fleet_fail)
                if self._killed_rollout is not None:
                    # online-RL rollout death: in-flight streams resume
                    # token-exact, the replica set backfills, the fleet
                    # reconverges on one weights epoch, and no
                    # trajectory goes unaccounted (resume re-emits dedup)
                    rl_fail = self.checker.wait_streams_resume(
                        self.rl_adapter,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    rl_fail += self.checker.wait_replica_backfilled(
                        self.rl_adapter,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    rl_fail += self.checker.wait_weights_epoch_converged(
                        self.rl_adapter,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    rl_fail += self.checker.wait_trajectory_accounting(
                        self.rl_adapter,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    if rl_fail:
                        check.ok = False
                        check.failures.extend(rl_fail)
                if self._killed_trainer_gangs:
                    # RL trainer rank death: the gang fences + reshapes,
                    # and the conservation law still balances (replayed
                    # steps re-read the cached batch, nothing double-
                    # counts)
                    rl_fail = self.checker.wait_gang_reshaped(
                        self._killed_trainer_gangs,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    rl_fail += self.checker.wait_trajectory_accounting(
                        self.rl_adapter,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    if rl_fail:
                        check.ok = False
                        check.failures.extend(rl_fail)
                if self._head_killed_mid_publish:
                    # publish atomicity across the promotion: the
                    # publisher's retry resolved to exactly one epoch on
                    # the new leader and the fleet converged on it
                    rl_fail = self.checker.wait_weights_epoch_converged(
                        self.rl_adapter,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    rl_fail += self.checker.wait_trajectory_accounting(
                        self.rl_adapter,
                        timeout=self.checker.actor_restart_budget_s,
                    )
                    if rl_fail:
                        check.ok = False
                        check.failures.extend(rl_fail)
                recovery = time.monotonic() - t0
                CHAOS_RECOVERY.observe(recovery)
                if not check.ok:
                    CHAOS_INVARIANT_FAILURES.inc(
                        len(check.failures), labels={"kind": spec.kind}
                    )
                    logger.error(
                        "chaos #%d %s invariants FAILED (seed=%d): %s",
                        spec.index,
                        spec.kind,
                        self.plan.seed,
                        check.failures,
                    )
                if (
                    spec.kind == "object_drop"
                    and detail.startswith("dropped")
                    and check.ok
                ):
                    # every copy was destroyed and the invariant pass
                    # re-got the value: lineage rebuilt exactly one object
                    result.objects_reconstructed += 1
                result.faults.append(
                    FaultResult(
                        spec=spec,
                        ok=check.ok,
                        recovery_s=recovery,
                        failures=check.failures,
                        detail=detail,
                    )
                )
        finally:
            self.cluster.heal_all()
            self._stop_owner_proc()
        result.objects_acked = self.workload.objects_acked
        # post-soak leak audit: every reader released (or died and had its
        # pin log replayed) — deleted-with-pins entries must be zero. A
        # short settle loop tolerates frees still in flight.
        result.arena_zombies_after = self.checker.wait_arena_zombies_zero(
            timeout=15.0
        )
        return result
