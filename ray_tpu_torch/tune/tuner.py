"""Tuner: trial lifecycle + ASHA / PBT schedulers.

Port of ``ray_tpu/tune/tuner.py``, over the port's runtime: the trials
are actors of the local runtime (the trial registry is in-process, as in
the reference), and a checkpoint is the port's ``train.Checkpoint``.

Reference shape: Tuner (Ray's python/ray/tune/tuner.py:43), ASHA
(tune/schedulers/async_hyperband.py), PBT (tune/schedulers/pbt.py). Each
trial is an actor; tune.report() streams metrics to the controller, which
applies scheduler decisions (early-stop rungs for ASHA, exploit/explore with
checkpoint copying for PBT).

Unlike the reference, a scheduler's decisions do not depend on when the
controller polls: the controller hands every result to the scheduler in
the order it was reported, each at its own iteration (the reference hands
the newest value to every rung a trial skipped past between two polls),
and under a scheduler ``report`` returns only once the controller has
decided on that result, as Ray's function trainables wait for theirs.
"""
from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from .search import expand_param_space

# ---------------------------------------------------------------------------
# in-process trial session (registry shared between controller and actors)
# ---------------------------------------------------------------------------

_registry: Dict[str, "_TrialState"] = {}
_registry_lock = threading.Lock()
_session = threading.local()


@dataclass
class _TrialState:
    trial_id: str
    config: Dict[str, Any]
    metrics: List[Dict[str, Any]] = field(default_factory=list)
    stop_event: threading.Event = field(default_factory=threading.Event)
    latest_checkpoint: Optional[Checkpoint] = None
    restore_checkpoint: Optional[Checkpoint] = None
    status: str = "PENDING"  # RUNNING | TERMINATED | STOPPED | ERROR
    error: Optional[str] = None
    lock: threading.Lock = field(default_factory=threading.Lock)
    # under a scheduler, report() waits until the controller has decided
    # on every result up to its own (``decided``)
    synchronous: bool = False
    decided: float = 0
    decision: threading.Condition = field(default_factory=threading.Condition)

    def mark_decided(self, it: float) -> None:
        with self.decision:
            self.decided = it
            self.decision.notify_all()

    @property
    def iterations(self) -> int:
        with self.lock:
            return len(self.metrics)

    def last_metric(self, name: str) -> Optional[float]:
        with self.lock:
            for m in reversed(self.metrics):
                if name in m:
                    return float(m[name])
        return None


class _StopTrial(Exception):
    pass


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    """tune.report parity; raises internally when the scheduler stopped the
    trial (cooperative early stopping, like ray.tune session)."""
    trial_id = getattr(_session, "trial_id", None)
    if trial_id is None:
        raise RuntimeError("tune.report() called outside a trial")
    state = _registry[trial_id]
    with state.lock:
        state.metrics.append(dict(metrics))
        it = len(state.metrics)
        if checkpoint is not None:
            state.latest_checkpoint = checkpoint
    if state.synchronous:
        with state.decision:
            state.decision.wait_for(lambda: state.decided >= it)
    if state.stop_event.is_set():
        raise _StopTrial()


def get_checkpoint() -> Optional[Checkpoint]:
    trial_id = getattr(_session, "trial_id", None)
    if trial_id is None:
        return None
    return _registry[trial_id].restore_checkpoint


@ray_tpu_torch.remote
class _TrialActor:
    def run(self, fn: Callable, trial_id: str, config: Dict[str, Any]) -> str:
        _session.trial_id = trial_id
        state = _registry[trial_id]
        state.status = "RUNNING"
        try:
            fn(dict(config))
            state.status = "TERMINATED"
        except _StopTrial:
            state.status = "STOPPED"
        except BaseException as exc:  # noqa: BLE001
            state.status = "ERROR"
            state.error = repr(exc)
        finally:
            _session.trial_id = None
        return state.status


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------


class ASHAScheduler:
    """Asynchronous successive halving (async_hyperband.py semantics):
    at rungs grace_period * reduction_factor^k, a trial continues only if its
    metric is in the top 1/reduction_factor of results recorded at that rung.
    """

    def __init__(
        self,
        *,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
    ):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self._rungs: Dict[int, List[float]] = {}

    def on_result(
        self, state: _TrialState, value: float, it: int, prev_it: int = None
    ) -> str:
        if it >= self.max_t:
            return "STOP"
        if prev_it is None:
            prev_it = it - 1
        rung = self.grace
        decision = "CONTINUE"
        # Evaluate every rung crossed since the last observation — the
        # controller may observe iteration jumps (fast reporting between
        # polls), and a skipped rung must still be recorded and decided.
        while rung <= it:
            if rung > prev_it:
                recorded = self._rungs.setdefault(rung, [])
                recorded.append(value)
                k = max(1, len(recorded) // self.rf)
                top = sorted(recorded, reverse=(self.mode == "max"))[:k]
                worst_top = top[-1]
                good = (
                    value >= worst_top
                    if self.mode == "max"
                    else value <= worst_top
                )
                if not good:
                    decision = "STOP"
            rung *= self.rf
        return decision


class MedianStoppingRule:
    """Median stopping (median_stopping_rule.py semantics): after the
    grace period, a trial stops when its best result so far is worse than
    the median of other trials' RUNNING AVERAGES at the same iteration
    count (the Vizier rule the reference implements)."""

    def __init__(
        self,
        *,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.min_samples = min_samples_required
        # trial id -> (sum, count, best) of reported values
        self._stats: Dict[int, List[float]] = {}

    def on_result(
        self, state: _TrialState, value: float, it: int, prev_it: int = None
    ) -> str:
        sid = id(state)
        s = self._stats.setdefault(sid, [0.0, 0.0, value])
        s[0] += value
        s[1] += 1
        better = max if self.mode == "max" else min
        s[2] = better(s[2], value)
        if it < self.grace:
            return "CONTINUE"
        others = [
            st[0] / st[1]
            for k, st in self._stats.items()
            if k != sid and st[1] > 0
        ]
        if len(others) < self.min_samples:
            return "CONTINUE"
        others.sort()
        median = others[len(others) // 2]
        good = s[2] >= median if self.mode == "max" else s[2] <= median
        return "CONTINUE" if good else "STOP"


class PopulationBasedTraining:
    """PBT (pbt.py semantics): every perturbation_interval reports, trials in
    the bottom quartile clone the config+checkpoint of a top-quartile trial
    and perturb hyperparameters (x1.2 / x0.8 or resample)."""

    def __init__(
        self,
        *,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        perturbation_interval: int = 4,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        seed: int = 0,
    ):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = np.random.default_rng(seed)
        self._last_perturb: Dict[str, int] = {}

    def maybe_exploit(
        self, state: _TrialState, all_states: List[_TrialState]
    ) -> Optional[Dict[str, Any]]:
        """Returns a new (config, checkpoint) to restart with, or None."""
        it = state.iterations
        if it - self._last_perturb.get(state.trial_id, 0) < self.interval:
            return None
        self._last_perturb[state.trial_id] = it
        scored = [
            (s, s.last_metric(self.metric))
            for s in all_states
            if s.last_metric(self.metric) is not None
        ]
        if len(scored) < 4:
            return None
        scored.sort(key=lambda x: x[1], reverse=(self.mode == "max"))
        n_q = max(1, int(len(scored) * self.quantile))
        top = [s for s, _ in scored[:n_q]]
        bottom = {s.trial_id for s, _ in scored[-n_q:]}
        if state.trial_id not in bottom:
            return None
        donor = top[int(self.rng.integers(0, len(top)))]
        new_config = dict(donor.config)
        for k, domain in self.mutations.items():
            if hasattr(domain, "sample") and self.rng.random() < 0.25:
                new_config[k] = domain.sample(self.rng)
            elif isinstance(new_config.get(k), (int, float)):
                factor = 1.2 if self.rng.random() < 0.5 else 0.8
                new_config[k] = type(new_config[k])(new_config[k] * factor)
        return {
            "config": new_config,
            "checkpoint": donor.latest_checkpoint,
        }


# ---------------------------------------------------------------------------
# Tuner
# ---------------------------------------------------------------------------


@dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    scheduler: Any = None
    # model-based searcher (e.g. search.TPESearcher): suggests configs
    # sequentially from completed results instead of sampling up front
    search_alg: Any = None
    max_concurrent_trials: Optional[int] = None
    seed: int = 0


@dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    status: str
    checkpoint: Optional[Checkpoint]
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def error(self):
        return _registry[self.trial_id].error


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: str, mode: str):
        self._results = results
        self.metric = metric
        self.mode = mode

    def __iter__(self):
        return iter(self._results)

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i):
        return self._results[i]

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> TrialResult:
        metric = metric or self.metric
        mode = mode or self.mode
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return (
            max(scored, key=lambda r: r.metrics[metric])
            if mode == "max"
            else min(scored, key=lambda r: r.metrics[metric])
        )


class Tuner:
    def __init__(
        self,
        trainable: Callable[[Dict[str, Any]], None],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Any = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        scheduler = tc.scheduler
        if scheduler is not None:
            scheduler.metric = scheduler.metric or tc.metric
            scheduler.mode = scheduler.mode or tc.mode
        searcher = tc.search_alg
        states: List[_TrialState] = []
        pending: List[tuple] = []  # (state, restore_ckpt)
        to_suggest = 0
        if searcher is not None:
            # sequential model-based search: configs come one at a time,
            # each informed by every completed result so far
            searcher.metric = searcher.metric or tc.metric
            searcher.mode = searcher.mode or tc.mode
            searcher.set_space(self.param_space)
            to_suggest = tc.num_samples
        else:
            configs = expand_param_space(
                self.param_space, tc.num_samples, tc.seed
            )
            for cfg in configs:
                tid = f"trial_{uuid.uuid4().hex[:8]}"
                state = _TrialState(trial_id=tid, config=cfg)
                with _registry_lock:
                    _registry[tid] = state
                states.append(state)
                pending.append((state, None))

        running: Dict[str, Any] = {}  # trial_id -> (actor, ref)
        seen_iters: Dict[str, int] = {}
        # model-based search defaults to SEQUENTIAL trials: launching the
        # whole budget up-front would mean every suggestion is drawn with
        # zero observations — i.e. silently random
        max_conc = tc.max_concurrent_trials or (
            1 if searcher is not None else max(1, len(states))
        )

        try:
            while pending or running or to_suggest > 0:
                while to_suggest > 0 and len(pending) + len(running) < max_conc:
                    cfg = searcher.suggest()
                    to_suggest -= 1
                    tid = f"trial_{uuid.uuid4().hex[:8]}"
                    state = _TrialState(trial_id=tid, config=cfg)
                    with _registry_lock:
                        _registry[tid] = state
                    states.append(state)
                    pending.append((state, None))
                while pending and len(running) < max_conc:
                    state, restore = pending.pop(0)
                    state.restore_checkpoint = restore
                    state.stop_event.clear()
                    state.synchronous = scheduler is not None
                    actor = _TrialActor.remote()
                    ref = actor.run.remote(
                        self.trainable, state.trial_id, state.config
                    )
                    running[state.trial_id] = (actor, ref)

                done, _ = ray_tpu_torch.wait(
                    [ref for _, ref in running.values()],
                    num_returns=1,
                    timeout=0.05,
                )
                # scheduler pass over fresh metrics
                for state in states:
                    if state.trial_id not in running or scheduler is None:
                        continue
                    it = state.iterations
                    prev_it = seen_iters.get(state.trial_id, 0)
                    if it <= prev_it:
                        continue
                    seen_iters[state.trial_id] = it
                    if isinstance(scheduler, (ASHAScheduler, MedianStoppingRule)):
                        with state.lock:
                            fresh = state.metrics[prev_it:it]
                        for i, m in enumerate(fresh, prev_it + 1):
                            if scheduler.metric not in m:
                                continue
                            value = float(m[scheduler.metric])
                            if scheduler.on_result(state, value, i, i - 1) == "STOP":
                                state.stop_event.set()
                                break
                    elif (isinstance(scheduler, PopulationBasedTraining)
                          and state.last_metric(scheduler.metric) is not None):
                        exploit = scheduler.maybe_exploit(state, states)
                        if exploit is not None:
                            state.stop_event.set()
                            new_state = _TrialState(
                                trial_id=f"trial_{uuid.uuid4().hex[:8]}",
                                config=exploit["config"],
                            )
                            with _registry_lock:
                                _registry[new_state.trial_id] = new_state
                            states.append(new_state)
                            pending.append((new_state, exploit["checkpoint"]))
                    state.mark_decided(it)
                # reap finished trials
                finished = [
                    tid
                    for tid, (_, ref) in running.items()
                    if ray_tpu_torch.wait([ref], num_returns=1, timeout=0)[0]
                ]
                for tid in finished:
                    actor, ref = running.pop(tid)
                    try:
                        ray_tpu_torch.get(ref)
                    except Exception:  # noqa: BLE001 - status captured in state
                        pass
                    ray_tpu_torch.kill(actor)
                    if searcher is not None:
                        st = _registry[tid]
                        searcher.report(st.config, st.last_metric(tc.metric))
        finally:
            # a trial waiting in report() must not outlive a controller
            # that raised
            for state in states:
                state.mark_decided(float("inf"))

        results = [
            TrialResult(
                trial_id=s.trial_id,
                config=s.config,
                metrics=s.metrics[-1] if s.metrics else {},
                status=s.status,
                checkpoint=s.latest_checkpoint,
                metrics_history=list(s.metrics),
            )
            for s in states
        ]
        return ResultGrid(results, tc.metric, tc.mode)
