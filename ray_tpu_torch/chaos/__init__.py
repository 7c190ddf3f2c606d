"""Deterministic chaos engineering for the distributed runtime.

A seeded fault plan (kills, head restarts, partitions, stragglers,
object drops) executes against a live cluster interleaved with a
verifiable workload; an invariant checker asserts convergence after
every fault. The same seed replays the exact same schedule
(``RAY_TPU_CHAOS_SEED``); see chaos/plan.py.

Port of ``ray_tpu/chaos/__init__.py``, copied with its imports rewritten.
"""
from ray_tpu_torch.config import cfg

from .invariants import CheckResult, InvariantChecker, Snapshot  # noqa: F401
from .orchestrator import (  # noqa: F401
    ChaosOrchestrator,
    ChaosRunResult,
    FaultResult,
)
from .plan import (  # noqa: F401
    DEFAULT_MIX,
    FAILOVER_MIX,
    KINDS,
    NET_MIX,
    RL_MIX,
    ROUTER_MIX,
    SERVE_MIX,
    ChaosPlan,
    FaultSpec,
    make_plan,
)
from .rl import RLRolloutWorkload  # noqa: F401
from .serve import ServeStreamWorkload  # noqa: F401
from .workload import ChaosCounter, ChaosWorkload  # noqa: F401


def chaos_seed(default: int = 0) -> int:
    """The run's chaos seed: ``RAY_TPU_CHAOS_SEED`` env (via config) or
    ``default``. Print it in any failure report — it replays the exact
    fault schedule."""
    env = cfg.chaos_seed
    return int(env) if env else int(default)
