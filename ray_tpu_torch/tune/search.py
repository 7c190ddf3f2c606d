"""Search-space primitives (ray.tune.search parity: tune.choice etc.).

Port of ``ray_tpu/tune/search.py``, copied: it is numpy only, so the same
seed gives the same samples and suggestions in both packages."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np


@dataclass(frozen=True)
class Domain:
    kind: str
    args: tuple

    def sample(self, rng: np.random.Generator) -> Any:
        if self.kind == "choice":
            return self.args[0][int(rng.integers(0, len(self.args[0])))]
        if self.kind == "uniform":
            lo, hi = self.args
            return float(rng.uniform(lo, hi))
        if self.kind == "loguniform":
            lo, hi = self.args
            return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        if self.kind == "randint":
            lo, hi = self.args
            return int(rng.integers(lo, hi))
        raise ValueError(self.kind)


def choice(options: List[Any]) -> Domain:
    return Domain("choice", (list(options),))


def uniform(low: float, high: float) -> Domain:
    return Domain("uniform", (low, high))


def loguniform(low: float, high: float) -> Domain:
    return Domain("loguniform", (low, high))


def randint(low: int, high: int) -> Domain:
    return Domain("randint", (low, high))


@dataclass(frozen=True)
class GridSearch:
    values: tuple


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(tuple(values))


def expand_param_space(
    space: Dict[str, Any], num_samples: int, seed: int = 0
) -> List[Dict[str, Any]]:
    """Materialize configs: cartesian product of grid axes × num_samples
    random draws of Domain axes (tune.run semantics)."""
    rng = np.random.default_rng(seed)
    grids = {k: v.values for k, v in space.items() if isinstance(v, GridSearch)}
    grid_combos: List[Dict[str, Any]] = [{}]
    for k, values in grids.items():
        grid_combos = [
            {**combo, k: val} for combo in grid_combos for val in values
        ]
    configs = []
    for _ in range(num_samples):
        for combo in grid_combos:
            cfg = dict(combo)
            for k, v in space.items():
                if isinstance(v, GridSearch):
                    continue
                cfg[k] = v.sample(rng) if isinstance(v, Domain) else v
            configs.append(cfg)
    return configs


# ---------------------------------------------------------------------------
# Model-based search: a native Tree-structured Parzen Estimator
# ---------------------------------------------------------------------------


class TPESearcher:
    """Native model-based searcher over the Domain types — the in-spirit
    equivalent of the reference's optuna/hyperopt integrations
    (python/ray/tune/search/optuna/, hyperopt/) without the external
    dependency.

    Design (TPE family, tuned for small trial budgets): completed trials
    are ranked and the best ``gamma`` fraction forms the "good" set; each
    suggestion samples from a Parzen (kernel-density) model of the good
    set using a JOINT center — one good configuration anchors every
    dimension, preserving cross-dimension correlation — with a per-dim
    Gaussian kernel whose bandwidth shrinks as evidence accumulates
    (log-space for loguniform). An ``epsilon`` fraction of suggestions
    stays uniform so the whole domain remains reachable. The classic
    good/bad density RATIO is deliberately omitted: at <=50-trial budgets
    it measurably over-explores the frontier of the bad set (validated
    against random search on seeded quadratic objectives in
    tests/test_libraries.py). Choice dimensions sample from smoothed
    good-set frequencies."""

    def __init__(
        self,
        metric: str | None = None,
        mode: str | None = None,
        *,
        gamma: float = 0.2,
        epsilon: float = 0.15,
        min_observations: int = 6,
        seed: int = 0,
    ):
        self.metric = metric
        self.mode = mode
        self.gamma = gamma
        self.epsilon = epsilon
        self.min_observations = min_observations
        self.rng = np.random.default_rng(seed)
        self._space: Dict[str, Any] = {}
        self._obs: List[tuple] = []  # (config, value)

    def set_space(self, space: Dict[str, Any]) -> None:
        for k, v in space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    "TPESearcher models Domain axes; use tune.choice(...) "
                    f"instead of grid_search for {k!r}"
                )
        self._space = space

    def report(self, config: Dict[str, Any], value: float) -> None:
        if value is not None and np.isfinite(value):
            self._obs.append((config, float(value)))

    # -- internals ------------------------------------------------------
    def _to_unit(self, dom: Domain, v):
        if dom.kind == "uniform":
            lo, hi = dom.args
            return (v - lo) / (hi - lo)
        if dom.kind == "loguniform":
            lo, hi = dom.args
            return (np.log(v) - np.log(lo)) / (np.log(hi) - np.log(lo))
        if dom.kind == "randint":
            lo, hi = dom.args
            return (v - lo) / max(1, hi - 1 - lo)
        raise ValueError(dom.kind)

    def _from_unit(self, dom: Domain, u: float):
        u = float(np.clip(u, 0.0, 1.0))
        if dom.kind == "uniform":
            lo, hi = dom.args
            return lo + u * (hi - lo)
        if dom.kind == "loguniform":
            lo, hi = dom.args
            return float(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))))
        if dom.kind == "randint":
            lo, hi = dom.args
            return int(round(lo + u * max(0, hi - 1 - lo)))
        raise ValueError(dom.kind)

    def _random(self) -> Dict[str, Any]:
        return {
            k: (v.sample(self.rng) if isinstance(v, Domain) else v)
            for k, v in self._space.items()
        }

    def suggest(self) -> Dict[str, Any]:
        if (
            len(self._obs) < self.min_observations
            or self.rng.random() < self.epsilon
        ):
            return self._random()
        sign = -1.0 if (self.mode or "min") == "max" else 1.0
        ranked = sorted(self._obs, key=lambda cv: sign * cv[1])
        n_good = min(
            len(ranked), max(2, int(np.ceil(self.gamma * len(ranked))))
        )
        good = ranked[:n_good]
        center = good[int(self.rng.integers(len(good)))][0]
        out: Dict[str, Any] = {}
        for k, dom in self._space.items():
            if not isinstance(dom, Domain):
                out[k] = dom
                continue
            if dom.kind == "choice":
                options = dom.args[0]
                idx = {repr(o): i for i, o in enumerate(options)}
                freq = np.ones(len(options))  # Laplace smoothing
                for cfg, _ in good:
                    # observed values outside the domain (e.g. PBT numeric
                    # perturbations of a choice axis) just don't vote
                    i = idx.get(repr(cfg.get(k)))
                    if i is not None:
                        freq[i] += 1
                p = freq / freq.sum()
                out[k] = options[int(self.rng.choice(len(options), p=p))]
                continue
            g = np.array(
                [
                    np.clip(self._to_unit(dom, cfg[k]), 0.0, 1.0)
                    for cfg, _ in good
                    if k in cfg
                ]
            )
            if g.size == 0:
                out[k] = dom.sample(self.rng)
                continue
            bw = max(0.02, float(g.std()) * len(g) ** -0.25)
            if k in center:
                u = np.clip(
                    self._to_unit(dom, center[k]), 0.0, 1.0
                ) + self.rng.normal(0.0, bw)
            else:
                u = float(self.rng.choice(g)) + self.rng.normal(0.0, bw)
            out[k] = self._from_unit(dom, u)
        return out
