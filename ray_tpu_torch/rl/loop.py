"""Online-RL continuous-learning loop.

Port of ``ray_tpu/rl/loop.py``. The closed cycle::

    rollout replicas ──trajectories──▶ TrajectoryFeed ──batches──▶ trainer
         ▲                                                            │
         └────── hot-swap (swap_params) ◀── two-phase publish ◀───────┘

Rollout replicas are :class:`~ray_tpu_torch.llm.continuous.
ContinuousBatchingEngine` instances generating deterministically
(greedy or per-request seeded), so every trajectory is reproducible
from ``(params-epoch, prompt, seed)``; on the card their decode steps
launch the paged-attention kernel. The trainer takes real causal-LM
gradient steps (``tfm.loss_fn``, backward, then SGD ``p - lr * g``) on
the SAME model the rollouts run, so a published epoch genuinely changes
rollout behaviour; on the card ``loss_fn`` reaches ``flash_attention``,
so a step launches the flash forward, dQ and dK/dV kernels once a layer.

Where the reference leans on JAX's immutable arrays, the port builds new
tensors: the SGD step returns a new tree and never writes a parameter in
place, so the tree a worker was handed at a publish (and the publisher's
version store) keeps the published weights while training goes on. The
SGD step runs in the parameters' dtype with ``lr`` rounded to it first,
as JAX's weakly typed scalar is.

:class:`OnlineRLLoop` is the in-process driver (the fast tests and
``chip_smoke.py``'s ``phase_rl``); it runs on ``device`` (default the
card). For the cluster soak the module exports
``elastic_rl_init``/``elastic_rl_step``: an
:class:`~ray_tpu_torch.train.ElasticTrainer` loop body that pulls its
batches from a :class:`TrajectoryFeed` actor by step index; the feed's
idempotent per-step batches are what keep the loss curve identical
across gang reshapes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.llm.continuous import ContinuousBatchingEngine
from ray_tpu_torch.llm.engine import GenerationConfig
from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.rl.publish import WeightsPublisher
from ray_tpu_torch.rl.trajectory import Trajectory, TrajectoryFeed, encode_block
from ray_tpu_torch.train import programs, pytree


def make_prompt(
    seed: int, step: int, worker: int, i: int, length: int, vocab: int
) -> List[int]:
    """Deterministic synthetic prompt — same (seed, step, worker, i)
    always yields the same tokens, so reruns and resumed rollouts are
    comparable token-for-token. Token 0 is reserved for padding."""
    base = seed * 9973 + step * 131 + worker * 31 + i * 17
    return [((base + j * 7) % (vocab - 1)) + 1 for j in range(length)]


def sgd_step(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: tfm.ModelConfig, lr: float
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(loss, new params) of one SGD step on ``tfm.loss_fn``: ``p - lr * g``
    as a new tree, ``params`` untouched, in each parameter's dtype with
    ``lr`` rounded to it first (JAX's weakly typed scalar)."""
    loss, grads = programs.value_and_grad(lambda p: tfm.loss_fn(p, tokens, cfg), params)
    leaves, treedef = pytree.flatten(params)
    return loss.detach(), pytree.unflatten(treedef, [
        p - torch.tensor(lr, dtype=p.dtype, device=p.device) * g
        for p, g in zip(leaves, grads)])


def _tokens(block: Dict[str, Any], device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(block["tokens"])).to(device=device, dtype=torch.int64)


class RolloutWorker:
    """One rollout replica: a continuous-batching engine plus the
    published weights epoch it currently serves. ``set_weights`` is the
    hot-swap edge — epoch-fenced drain via ``swap_params``, so no
    in-flight stream ever mixes weights epochs."""

    def __init__(
        self,
        model_cfg: tfm.ModelConfig,
        params: Any,
        rollout_id: str,
        *,
        max_batch: int = 2,
        page_size: int = 8,
        n_pages: int = 64,
        device: DeviceLike = None,
    ):
        self.rollout_id = rollout_id
        self.model_cfg = model_cfg
        self.engine = ContinuousBatchingEngine(
            model_cfg,
            params,
            max_batch=max_batch,
            page_size=page_size,
            n_pages=n_pages,
            model_id="epoch-0",
            device=device,
        )
        self.weights_epoch = 0

    def set_weights(self, epoch: int, params: Any) -> int:
        """Hot-swap to a published epoch (idempotent; stale epochs are
        no-ops — a replica never moves backwards)."""
        if int(epoch) <= self.weights_epoch:
            return self.weights_epoch
        self.engine.swap_params(params, model_id=f"epoch-{int(epoch)}")
        self.weights_epoch = int(epoch)
        return self.weights_epoch

    def rollout(
        self,
        specs: List[Dict[str, Any]],
        max_new_tokens: int,
        temperature: float = 0.0,
    ) -> Dict[str, Any]:
        """Generate one trajectory per spec (``{"traj_id", "prompt",
        "seed"}``), all stamped with the CURRENT weights epoch, returned
        as an encoded block ready for ``TrajectoryFeed.emit``."""
        epoch = self.weights_epoch
        ids = []
        for s in specs:
            gen = GenerationConfig(
                max_new_tokens=max_new_tokens,
                temperature=temperature,
                seed=int(s.get("seed", 0)),
            )
            ids.append(self.engine.submit(list(s["prompt"]), gen))
        while any(r not in self.engine.results for r in ids):
            self.engine.step()
        trajs = []
        for s, rid in zip(specs, ids):
            out = self.engine.results.pop(rid)
            prompt = list(s["prompt"])
            trajs.append(
                Trajectory(
                    traj_id=s["traj_id"],
                    prompt=prompt,
                    tokens=prompt + list(out),
                    weights_epoch=epoch,
                    rollout_id=self.rollout_id,
                    seed=int(s.get("seed", 0)),
                )
            )
        return encode_block(trajs)

    def probe_first_token(self) -> None:
        """One greedy token end-to-end — the 'first serving token on the
        new weights' the publish-latency metric measures."""
        self.engine.generate_ids(
            [[1, 2, 3]], GenerationConfig(max_new_tokens=1)
        )


@dataclass
class RLLoopConfig:
    n_rollout_workers: int = 2
    prompts_per_step: int = 2  # per worker
    prompt_len: int = 8
    max_new_tokens: int = 8
    batch_size: int = 4
    lr: float = 1e-2
    total_steps: int = 12
    seed: int = 0
    temperature: float = 0.0
    staleness_window: Optional[int] = None  # None -> cfg.rl_staleness_window
    publish_interval: Optional[int] = None  # None -> cfg.rl_publish_interval_steps


class OnlineRLLoop:
    """In-process rollout→train→publish driver on ``device`` (default
    the card; raises without one).

    ``head_address`` of None fences epochs through a local ledger —
    same two-phase protocol, no cluster. Everything downstream of the
    seed is deterministic, so two loops built from identical inputs
    produce identical loss curves (the continuity oracle)."""

    def __init__(
        self,
        model_cfg: tfm.ModelConfig,
        init_params: Any,
        loop_cfg: RLLoopConfig,
        head_address: Optional[str] = None,
        deployment: str = "rl-policy",
        use_hub: bool = False,
        device: DeviceLike = None,
    ):
        from ray_tpu_torch.config import cfg

        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.lc = loop_cfg
        self.staleness_window = (
            int(cfg.rl_staleness_window)
            if loop_cfg.staleness_window is None
            else int(loop_cfg.staleness_window)
        )
        self.publish_interval = (
            int(cfg.rl_publish_interval_steps)
            if loop_cfg.publish_interval is None
            else int(loop_cfg.publish_interval)
        )
        self.publisher = WeightsPublisher(
            deployment, head_address, use_hub=use_hub
        )
        self.feed = TrajectoryFeed(self.staleness_window)
        self.params = tfm.params_to(init_params, self.device)
        self.epoch = 0
        self.workers = [
            RolloutWorker(
                model_cfg,
                self.params,
                f"r{i}",
                max_batch=max(2, loop_cfg.prompts_per_step),
                device=self.device,
            )
            for i in range(loop_cfg.n_rollout_workers)
        ]
        self.losses: List[float] = []
        self.publish_ms: List[float] = []
        self.publish_to_first_token_ms: List[float] = []
        self.samples_trained = 0

    # -- one cycle -----------------------------------------------------
    def _collect(self, step: int) -> None:
        vocab = self.model_cfg.vocab_size
        for wi, w in enumerate(self.workers):
            specs = [
                {
                    "traj_id": f"{w.rollout_id}:s{step}:p{i}",
                    "prompt": make_prompt(
                        self.lc.seed, step, wi, i, self.lc.prompt_len, vocab
                    ),
                    "seed": self.lc.seed * 1000 + step * 10 + i,
                }
                for i in range(self.lc.prompts_per_step)
            ]
            self.feed.emit(
                w.rollout(specs, self.lc.max_new_tokens, self.lc.temperature)
            )

    def _train_step(self, step: int) -> Optional[float]:
        block = self.feed.take_for_step(
            step, self.lc.batch_size, self.epoch, self.staleness_window
        )
        if block is None:
            return None
        tokens = _tokens(block, self.device)
        loss, self.params = sgd_step(self.params, tokens, self.model_cfg, self.lc.lr)
        self.samples_trained += int(tokens.shape[0])
        return float(loss)

    def _publish(self) -> None:
        t0 = time.monotonic()
        self.epoch = self.publisher.publish(self.params)
        self.feed.note_epoch(self.epoch)
        self.publish_ms.append((time.monotonic() - t0) * 1000.0)
        for w in self.workers:
            w.set_weights(self.epoch, self.params)
        self.workers[0].probe_first_token()
        self.publish_to_first_token_ms.append(
            (time.monotonic() - t0) * 1000.0
        )

    def run(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        for step in range(self.lc.total_steps):
            self._collect(step)
            loss = self._train_step(step)
            if loss is not None:
                self.losses.append(loss)
            if (step + 1) % self.publish_interval == 0:
                self._publish()
        wall = max(time.monotonic() - t0, 1e-9)
        acct = self.feed.accounting()
        return {
            "steps": self.lc.total_steps,
            "losses": list(self.losses),
            "weights_epoch": self.epoch,
            "samples_trained": self.samples_trained,
            "samples_per_s": self.samples_trained / wall,
            "publish_ms": list(self.publish_ms),
            "publish_to_first_token_ms": list(
                self.publish_to_first_token_ms
            ),
            "accounting": acct,
            "stale_dropped_frac": (
                acct["dropped_stale"] / acct["emitted"]
                if acct["emitted"]
                else 0.0
            ),
            "wall_s": wall,
        }

    def close(self) -> None:
        self.publisher.close()


# ---------------------------------------------------------------------------
# ElasticTrainer loop body (cluster soak): batches come from a
# TrajectoryFeed actor keyed by step index — idempotent across gang
# reshapes, so the killed run's loss curve matches the reference.
# ---------------------------------------------------------------------------
def model_config_to_dict(cfg: tfm.ModelConfig) -> Dict[str, Any]:
    """The config's fields, with the dtype by the name JAX writes
    (``"bfloat16"``, ``"float32"``)."""
    d = dict(cfg.__dict__)
    d["dtype"] = str(cfg.dtype).rpartition(".")[2]
    return d


def model_config_from_dict(d: Dict[str, Any]) -> tfm.ModelConfig:
    return programs.model_config({"model": d})


def elastic_rl_init(config: Dict[str, Any]) -> Dict[str, Any]:
    """``config``: ``model`` (``model_config_to_dict``), ``seed`` and
    ``device`` (default the card). Every rank draws the same weights
    from a CPU generator seeded with ``seed``."""
    mc = model_config_from_dict(config["model"])
    gen = torch.Generator().manual_seed(int(config["seed"]))
    return {"params": tfm.init_params(mc, gen, config.get("device"))}


def elastic_rl_step(state, step, gang, config):
    """One elastic RL trainer step: pull the (idempotent) step batch
    from the feed actor, take a real CE gradient step, and run one
    epoch-fenced collective so membership changes surface here exactly
    like any SPMD loop."""
    import ray_tpu_torch

    mc = model_config_from_dict(config["model"])
    feed = ray_tpu_torch.get_actor(config["feed_actor"])
    # pacing: the feed's live override wins (lets a soak driver throttle
    # the trainer through a fault schedule, then sprint the tail),
    # falling back to the static config knob
    pace = float(config.get("step_sleep", 0.0))
    try:
        live = ray_tpu_torch.get(feed.pace.remote(), timeout=30.0)
        if live is not None:
            pace = float(live)
    except Exception:  # noqa: BLE001 - feed actor mid-restart
        pass
    if pace > 0:
        time.sleep(pace)
    block = ray_tpu_torch.get(
        feed.take_for_step.remote(step, int(config["batch_size"]))
    )
    params = state["params"]
    leaf0 = pytree.leaves(params)[0]
    params_finite = bool(torch.isfinite(leaf0.sum()))
    tok_max = -1
    loss_val = float("nan")
    if block is not None:
        tokens = _tokens(block, leaf0.device)
        tok_max = int(tokens.max())
        loss, params = sgd_step(params, tokens, mc, float(config["lr"]))
        loss_val = float(loss)
    # the collective every step: a rank killed mid-step is detected by
    # the gang's epoch fence, the survivors reshape, and this step
    # replays — pulling the SAME batch from the feed's step cache
    partials = {v: {"one": np.ones(1)} for v in gang.owned_shards()}
    gang.allreduce_shards(partials)
    # cooperative stop: the feed's per-step-idempotent flag means every
    # rank sees the same answer for the same step, so the whole gang
    # breaks out of its loop together (a diverging rank would wedge the
    # next collective and take a needless reshape)
    stop = False
    try:
        stop = bool(ray_tpu_torch.get(feed.stop_for_step.remote(step), timeout=30.0))
    except Exception:  # noqa: BLE001 - feed actor mid-restart
        pass
    return (
        {"params": params},
        {
            "step": step,
            "loss": loss_val,
            "world": gang.world,
            "stop": stop,
            # provenance for the soak's loss-continuity oracle: which
            # trajectories this rank actually trained on (empty batch
            # == the feed had nothing for this step)
            "traj_ids": list(block["traj_ids"]) if block is not None else None,
            "params_finite": params_finite,
            "tok_max": tok_max,
        },
    )
