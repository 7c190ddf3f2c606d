"""Deterministic fault plans.

The reference validates fault tolerance with a chaos release suite
(node-killer actors injected while invariant checks run,
release/nightly_tests chaos_test/* and python/ray/_private/test_utils.py
RayletKiller). Ours is deterministic end-to-end: a plan is a pure
function of ``(seed, num_faults, mix)`` — replaying the same seed
reproduces the exact same fault schedule, so any soak failure is
replayable with ``RAY_TPU_CHAOS_SEED``.

Targets are drawn as raw integers at plan time and resolved modulo the
live node set at injection time: the schedule stays fixed even though
cluster membership changes as faults kill and replace nodes.

Port of ``ray_tpu/chaos/plan.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

# fault kind -> default mix weight
DEFAULT_MIX: Tuple[Tuple[str, float], ...] = (
    ("partition", 3.0),
    ("straggler", 3.0),
    ("object_drop", 3.0),
    ("kill_node", 2.0),
    ("owner_kill", 1.5),
    ("zygote_kill", 1.5),
    ("head_restart", 1.0),
)

# serving-plane mix: adds replica_kill (SIGKILL a serve replica's worker
# mid-stream) and prefill_kill (SIGKILL a PREFILL-tier worker of a
# disaggregated deployment mid-handoff; decode replicas must fall back
# to local re-prefill and every stream must stay token-exact). Not in
# DEFAULT_MIX — the generic soak runs no serve workload, and keeping the
# default mix stable preserves seed-for-seed schedule reproducibility
# across versions. Plans that drive a serve workload pass this mix (or
# an explicit allow list over it); monolithic serve workloads without a
# prefill tier report prefill_kill faults as skipped.
SERVE_MIX: Tuple[Tuple[str, float], ...] = DEFAULT_MIX + (
    ("replica_kill", 2.0),
    ("prefill_kill", 1.5),
)

# cross-node transport mix: adds peer_conn_drop (sever one node's data
# sockets mid-transfer; in-flight striped pulls must resume, not
# restart). Not in DEFAULT_MIX for the same seed-stability reason as
# replica_kill — plans that drive cross-node transfers pass this mix.
NET_MIX: Tuple[Tuple[str, float], ...] = DEFAULT_MIX + (
    ("peer_conn_drop", 2.0),
)

# replicated-control-plane mix: adds head_kill_promote (SIGKILL the
# leader, a pre-armed warm standby must detect + promote, and in-flight
# work must complete with zero acked loss). Not in DEFAULT_MIX — the
# generic soak arms no standby, and the default schedule must stay
# seed-stable; plans built by the failover soak pass this mix.
FAILOVER_MIX: Tuple[Tuple[str, float], ...] = DEFAULT_MIX + (
    ("head_kill_promote", 1.0),
)

# elastic-training mix: adds rank_node_kill (SIGKILL a node HOSTING
# elastic gang ranks, chosen from the head's gang table). The gang must
# fence its epoch, reshape to the surviving topology, and resume from
# object-plane seals — no disk restore. Not in DEFAULT_MIX for the same
# seed-stability reason; plans that drive an elastic training workload
# pass this mix.
TRAIN_MIX: Tuple[Tuple[str, float], ...] = DEFAULT_MIX + (
    ("rank_node_kill", 2.0),
)

# elasticity-plane mix: adds node_drain (cooperative drain-ahead of a
# live node — the head zeroes its advertised capacity, preemptively
# migrates leased work off it BEFORE the deadline, then retires it; all
# retryable work must land elsewhere with zero attempts burned). Not in
# DEFAULT_MIX for the same seed-stability reason — plans that exercise
# the unified elasticity controller pass this mix.
ELASTIC_MIX: Tuple[Tuple[str, float], ...] = DEFAULT_MIX + (
    ("node_drain", 2.0),
)

# router-fleet mix: adds router_kill on top of the serve mix (abruptly
# kill one ingress router of a fleet mid-stream; the sibling inheriting
# the hash range must resume every in-flight stream token-exact from
# the replicated delivered-count checkpoints). Not in DEFAULT_MIX or
# SERVE_MIX for the same seed-stability reason — plans that drive a
# multi-router fleet pass this mix.
ROUTER_MIX: Tuple[Tuple[str, float], ...] = SERVE_MIX + (
    ("router_kill", 2.0),
)

# online-RL mix: the triple-plane soak. rollout_kill SIGKILLs
# a rollout replica mid-trajectory (token-exact resume via resume_from),
# trainer_rank_kill SIGKILLs a node hosting elastic-gang ranks of the RL
# trainer mid-step (gang reshape, loss-curve continuity vs reference),
# and head_kill_mid_publish kills the leader INSIDE the seal->commit
# window of a two-phase weights publish (standby promotes; the epoch is
# either fully old or fully new, never torn). Not in DEFAULT_MIX for the
# same seed-stability reason — plans that drive the online-RL workload
# pass this mix.
RL_MIX: Tuple[Tuple[str, float], ...] = DEFAULT_MIX + (
    ("rollout_kill", 2.0),
    ("trainer_rank_kill", 2.0),
    ("head_kill_mid_publish", 1.0),
)

KINDS = tuple(k for k, _ in ROUTER_MIX) + (
    "peer_conn_drop",
    "head_kill_promote",
    "rank_node_kill",
    "node_drain",
    "rollout_kill",
    "trainer_rank_kill",
    "head_kill_mid_publish",
)


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault. ``target`` picks a node (modulo the live set
    at injection time); ``magnitude`` in [0,1) scales kind-specific
    parameters (partition hold, straggler delay peak); ``delay_s`` is the
    pause after the previous fault converges."""

    index: int
    kind: str
    delay_s: float
    target: int
    magnitude: float


@dataclass
class ChaosPlan:
    seed: int
    faults: List[FaultSpec] = field(default_factory=list)

    def counts(self) -> dict:
        out: dict = {}
        for f in self.faults:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out


def make_plan(
    seed: int,
    num_faults: int,
    mix: Sequence[Tuple[str, float]] = DEFAULT_MIX,
    allow: Optional[Sequence[str]] = None,
    min_delay_s: float = 0.05,
    max_delay_s: float = 0.5,
) -> ChaosPlan:
    """Deterministic plan: same arguments -> identical schedule."""
    pairs = [
        (k, w) for k, w in mix if allow is None or k in allow
    ]
    if not pairs:
        raise ValueError("fault mix is empty after applying allow-list")
    kinds = [k for k, _ in pairs]
    weights = [w for _, w in pairs]
    rng = random.Random(seed)
    faults = [
        FaultSpec(
            index=i,
            kind=rng.choices(kinds, weights=weights)[0],
            delay_s=rng.uniform(min_delay_s, max_delay_s),
            target=rng.randrange(1 << 30),
            magnitude=rng.random(),
        )
        for i in range(num_faults)
    ]
    return ChaosPlan(seed=seed, faults=faults)
