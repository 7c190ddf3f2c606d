"""The port's training and tuning libraries (``ray_tpu_torch.train``'s
``TorchTrainer`` and checkpoints, ``ray_tpu_torch.tune``) on the CPU.

Mirrors the train and tune cases of ``tests/test_libraries.py`` on
``ray_tpu_torch`` with the same assertions (``TorchTrainer`` in place of
``JaxTrainer``, a torch loop in place of the jax one), then holds the port
against the JAX package on the same inputs: ``Checkpoint.from_state``
writes the same ``checkpoint_meta.json`` and the same ``.npz`` leaves for
the same numpy state; bf16 tensors and an optimizer's ``state_dict()``
round-trip exactly; ``expand_param_space`` and the TPE searcher give the
same trials for the same seed and history; ASHA and the median rule make
the same stop decisions on the same report streams; and a trainer loop that
fails and restores reports the losses of an uninterrupted run.

Every case runs the port's local runtime with its scheduler on the CPU
(``RAY_TPU_SCHED_PLATFORM=cpu``).
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch


@pytest.fixture(autouse=True)
def _cpu_scheduler(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")


@pytest.fixture()
def rt(_cpu_scheduler):
    rt = ray_tpu_torch.init(
        num_nodes=2,
        resources_per_node={"CPU": 8, "memory": float(1 << 30)},
    )
    yield rt
    ray_tpu_torch.shutdown()


# -- train ------------------------------------------------------------------


def test_jax_trainer_end_to_end(rt, tmp_path):
    from ray_tpu_torch import train
    from ray_tpu_torch.train import Checkpoint, RunConfig, ScalingConfig, TorchTrainer

    def loop(config):
        ctx = train.get_context()
        assert ctx.get_world_size() == 2
        g = torch.Generator().manual_seed(ctx.get_world_rank())
        w = torch.zeros(4, requires_grad=True)
        x = torch.randn(32, 4, generator=g)
        y = x @ torch.tensor([1.0, -2.0, 0.5, 3.0])
        opt = torch.optim.SGD([w], lr=0.1)

        for epoch in range(config["epochs"]):
            loss = torch.mean((x @ w - y) ** 2)
            loss.backward()
            opt.step()
            opt.zero_grad()
            ckpt_dir = os.path.join(
                ctx.trial_dir, f"checkpoint_{epoch:03d}_r{ctx.get_world_rank()}"
            )
            ckpt = Checkpoint.from_state({"w": w.detach()}, ckpt_dir)
            train.report({"loss": loss.item(), "epoch": epoch}, checkpoint=ckpt)

    trainer = TorchTrainer(
        loop,
        train_loop_config={"epochs": 3},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="t0", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["epoch"] == 2
    assert len(result.metrics_history) == 3
    state = result.checkpoint.load_state()
    assert state["w"].shape == (4,)


def test_trainer_failure_then_restore(rt, tmp_path):
    from ray_tpu_torch import train
    from ray_tpu_torch.train import (
        Checkpoint,
        FailureConfig,
        RunConfig,
        ScalingConfig,
        TorchTrainer,
    )

    def loop(config):
        ctx = train.get_context()
        start = 0
        if ctx.get_checkpoint() is not None:
            start = ctx.get_checkpoint().load_state()["epoch"] + 1
        for epoch in range(start, 4):
            ckpt = Checkpoint.from_state(
                {"epoch": epoch},
                os.path.join(ctx.trial_dir, f"checkpoint_{epoch:03d}"),
            )
            train.report({"epoch": epoch}, checkpoint=ckpt)
            if epoch == 1 and ctx.get_checkpoint() is None:
                raise RuntimeError("injected failure")

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="t1",
            storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    result = trainer.fit()
    assert result.error is None
    # restored from epoch-1 checkpoint, resumed at 2, finished at 3
    assert result.metrics["epoch"] == 3


# -- tune -------------------------------------------------------------------


def test_tuner_grid_and_best(rt):
    from ray_tpu_torch import tune

    def trainable(config):
        tune.report({"score": -((config["x"] - 3) ** 2)})

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4])},
        tune_config=tune.TuneConfig(metric="score", mode="max", num_samples=1),
    )
    grid = tuner.fit()
    assert len(grid) == 5
    assert grid.get_best_result().config["x"] == 3


def test_tuner_asha_stops_bad_trials(rt):
    from ray_tpu_torch import tune

    def trainable(config):
        for it in range(40):
            tune.report({"loss": config["lr"] * (40 - it)})
            time.sleep(0.02)

    tuner = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.1, 1.0, 10.0, 100.0])},
        tune_config=tune.TuneConfig(
            metric="loss",
            mode="min",
            scheduler=tune.ASHAScheduler(
                max_t=40, grace_period=2, reduction_factor=2
            ),
        ),
    )
    grid = tuner.fit()
    statuses = [r.status for r in grid]
    assert "STOPPED" in statuses  # at least one trial early-stopped
    best = grid.get_best_result()
    assert best.config["lr"] == 0.1


def test_tuner_median_stopping_rule(rt):
    from ray_tpu_torch import tune

    def trainable(config):
        for it in range(30):
            tune.report({"loss": config["lr"] * (30 - it)})
            time.sleep(0.02)

    tuner = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.1, 0.2, 5.0, 50.0])},
        tune_config=tune.TuneConfig(
            metric="loss",
            mode="min",
            scheduler=tune.MedianStoppingRule(
                grace_period=3, min_samples_required=2
            ),
        ),
    )
    grid = tuner.fit()
    statuses = [r.status for r in grid]
    assert "STOPPED" in statuses  # below-median trials stop early
    assert grid.get_best_result().config["lr"] == 0.1


def test_tpe_searcher_beats_random(rt):
    """Native TPE-family searcher: across several seeds, sequential
    model-based search finds a better optimum than the same budget of
    random sampling on a smooth objective (median comparison)."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import TPESearcher, TuneConfig, Tuner

    def objective(config):
        loss = (config["x"] - 0.7) ** 2 + (config["y"] + 0.3) ** 2
        tune.report({"loss": loss})

    space = {"x": tune.uniform(-2.0, 2.0), "y": tune.uniform(-2.0, 2.0)}
    n, seeds = 36, (1, 2, 3, 4)

    def best(search_alg, seed):
        return (
            Tuner(
                objective,
                param_space=space,
                tune_config=TuneConfig(
                    num_samples=n,
                    seed=seed,
                    search_alg=search_alg,
                    # sequential: every suggestion sees all prior results
                    max_concurrent_trials=1 if search_alg else None,
                ),
            )
            .fit()
            .get_best_result("loss", "min")
            .metrics["loss"]
        )

    rand = sorted(best(None, s) for s in seeds)
    tpe = sorted(best(TPESearcher(seed=s), s) for s in seeds)
    rand_med = (rand[1] + rand[2]) / 2
    tpe_med = (tpe[1] + tpe[2]) / 2
    assert tpe_med < rand_med, (tpe, rand)
    assert tpe_med < 0.1, tpe  # converged near (0.7, -0.3)


def test_tpe_searcher_choice_and_loguniform(rt):
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import TPESearcher, TuneConfig, Tuner

    def objective(config):
        penalty = 0.0 if config["opt"] == "adam" else 1.0
        loss = penalty + abs(np.log10(config["lr"]) + 2.0)  # best lr=1e-2
        tune.report({"loss": loss})

    space = {
        "opt": tune.choice(["sgd", "adam", "rmsprop"]),
        "lr": tune.loguniform(1e-5, 1e0),
    }
    res = Tuner(
        objective,
        param_space=space,
        tune_config=TuneConfig(
            num_samples=30,
            search_alg=TPESearcher(seed=3, min_observations=6),
            max_concurrent_trials=3,
        ),
    ).fit()
    best = res.get_best_result("loss", "min")
    assert best.config["opt"] == "adam"
    assert best.metrics["loss"] < 0.8


# -- parity with the JAX package ----------------------------------------------


def _numpy_state(seed=5):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "dense": {
                "kernel": rng.standard_normal((8, 4)).astype(np.float32),
                "bias": np.zeros(4, np.float32),
            },
            "blocks": [rng.integers(0, 9, (3, 2)), (np.float64(1.5), np.arange(5))],
            "scale": np.float32(2.0),
            "unused": None,
        },
        "step": rng.integers(0, 100, ()),
        "meta": {"epoch": 3, "name": "run"},
    }


def test_checkpoint_layout_equals_the_reference(tmp_path):
    """The same numpy state: the same meta json, and .npz files that hold
    the same leaf names with byte-equal arrays in JAX's leaf order."""
    from ray_tpu.train import Checkpoint as JaxCheckpoint

    from ray_tpu_torch.train import Checkpoint

    state = _numpy_state()
    ref = JaxCheckpoint.from_state(state, str(tmp_path / "ref"))
    got = Checkpoint.from_state(state, str(tmp_path / "port"))
    metas = [
        json.loads((tmp_path / d / "checkpoint_meta.json").read_text())
        for d in ("ref", "port")
    ]
    assert metas[0] == metas[1] == {
        "params": "pytree", "step": "pytree", "meta": "pickle"
    }
    assert sorted(os.listdir(ref.path)) == sorted(os.listdir(got.path))
    for name, kind in metas[0].items():
        if kind != "pytree":
            continue
        a = np.load(os.path.join(ref.path, f"{name}.npz"))
        b = np.load(os.path.join(got.path, f"{name}.npz"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()
    back_ref, back = ref.load_state(), got.load_state()
    assert back["meta"] == back_ref["meta"] == state["meta"]
    import jax

    ref_leaves = jax.tree.leaves(back_ref["params"])
    from ray_tpu_torch.train import pytree

    port_leaves = pytree.leaves(back["params"])
    assert len(ref_leaves) == len(port_leaves) == 6
    for a, b in zip(ref_leaves, port_leaves):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert back["params"]["unused"] is None
    assert type(back["params"]["blocks"][1]) is tuple


def test_checkpoint_bf16_and_optimizer_state_roundtrip(tmp_path):
    """A bf16 tensor comes back with its bits and dtype, and an Adam
    state_dict (int keys, tensor ``step``, bf16 moments) loads into a
    fresh optimizer whose next step equals the original's bit for bit."""
    from ray_tpu_torch.train import Checkpoint

    g = torch.Generator().manual_seed(3)
    w = torch.randn(16, 8, generator=g).to(torch.bfloat16).requires_grad_()
    b = torch.randn(8, generator=g).requires_grad_()
    opt = torch.optim.Adam([w, b], lr=1e-2)
    for _ in range(2):
        ((w.float() ** 2).sum() + b.sum()).backward()
        opt.step()
        opt.zero_grad()
    ckpt = Checkpoint.from_state(
        {"params": {"w": w.detach(), "b": b.detach()}, "opt": opt.state_dict()},
        str(tmp_path / "c"),
    )
    back = ckpt.load_state()
    assert back["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["w"].view(torch.int16), w.detach().view(torch.int16))
    assert torch.equal(back["params"]["b"], b.detach())
    st = back["opt"]["state"]
    assert sorted(st) == [0, 1]
    assert isinstance(st[0]["step"], torch.Tensor) and float(st[0]["step"]) == 2.0
    assert st[0]["exp_avg"].dtype == torch.bfloat16
    # the restored optimizer takes the next step exactly as the original
    w2 = back["params"]["w"].clone().requires_grad_()
    b2 = back["params"]["b"].clone().requires_grad_()
    opt2 = torch.optim.Adam([w2, b2], lr=1e-2)
    opt2.load_state_dict(back["opt"])
    for p, o in (((w, b), opt), ((w2, b2), opt2)):
        ((p[0].float() ** 2).sum() + p[1].sum()).backward()
        o.step()
    assert torch.equal(w2.detach().view(torch.int16), w.detach().view(torch.int16))
    assert torch.equal(b2.detach(), b.detach())


def test_param_space_and_tpe_suggestions_equal_the_reference():
    from ray_tpu import tune as jtune
    from ray_tpu.tune.search import expand_param_space as jexpand

    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import expand_param_space

    def space(m):
        return {
            "lr": m.loguniform(1e-5, 1e-1),
            "wd": m.uniform(0.0, 0.3),
            "layers": m.randint(1, 9),
            "opt": m.choice(["sgd", "adam", "rmsprop"]),
            "bs": m.grid_search([16, 32]),
            "fixed": 7,
        }

    for seed in (0, 1, 5):
        assert expand_param_space(space(tune), 4, seed) == jexpand(space(jtune), 4, seed)

    def suggestions(m, seed):
        s = {k: v for k, v in space(m).items() if k != "bs"}
        tpe = m.TPESearcher(seed=seed, min_observations=4)
        tpe.set_space(s)
        out = []
        for i in range(14):
            cfg = tpe.suggest()
            out.append(cfg)
            # a deterministic history: loss from the config itself
            tpe.report(cfg, abs(np.log10(cfg["lr"]) + 3) + cfg["wd"] + 0.1 * cfg["layers"]
                       + (0.0 if cfg["opt"] == "adam" else 0.5))
        return out

    for seed in (0, 3):
        assert suggestions(tune, seed) == suggestions(jtune, seed)


def _decisions(scheduler, state_cls, streams):
    """Feed per-trial report streams round-robin, as the controller
    observes them; return each trial's decision per report."""
    states = [state_cls(trial_id=f"t{i}", config={}) for i in range(len(streams))]
    out = [[] for _ in streams]
    for it in range(1, max(len(s) for s in streams) + 1):
        for i, s in enumerate(streams):
            if it <= len(s):
                out[i].append(scheduler.on_result(states[i], s[it - 1], it, it - 1))
    return out


def test_asha_and_median_decisions_equal_the_reference():
    from ray_tpu.tune import tuner as jtuner

    from ray_tpu_torch.tune import tuner

    rng = np.random.default_rng(9)
    streams = [list(lr * np.linspace(20, 1, 20) + rng.uniform(0, 1, 20))
               for lr in (0.1, 0.3, 1.0, 3.0, 10.0, 0.5)]
    for make in (
        lambda m: m.ASHAScheduler(metric="loss", mode="min", max_t=16,
                                  grace_period=2, reduction_factor=2),
        lambda m: m.ASHAScheduler(metric="loss", mode="max", max_t=20,
                                  grace_period=1, reduction_factor=3),
        lambda m: m.MedianStoppingRule(metric="loss", mode="min", grace_period=3,
                                       min_samples_required=2),
    ):
        got = _decisions(make(tuner), tuner._TrialState, streams)
        want = _decisions(make(jtuner), jtuner._TrialState, streams)
        assert got == want
        assert any("STOP" in d for d in got)


def test_asha_decides_on_each_result_not_on_the_poll(rt):
    """Trials that report faster than the controller polls, one at a time:
    each stops at the report where ASHA, handed every result in order at
    its own iteration, first says STOP, as a replay of the same streams
    through a fresh scheduler says. (The reference's controller handed the
    newest value to every rung a trial skipped past and let the trial run
    on, so which trial stopped, and when, followed the poll.)"""
    from ray_tpu_torch import tune

    rng = np.random.default_rng(4)
    streams = {lr: list(lr * np.linspace(12, 1, 12) + rng.uniform(0, 0.1, 12))
               for lr in (1.0, 0.5, 4.0, 0.25, 2.0)}

    def trainable(config):
        for v in streams[config["lr"]]:
            tune.report({"loss": v})

    def make():
        return tune.ASHAScheduler(metric="loss", mode="min", max_t=12,
                                  grace_period=2, reduction_factor=2)

    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search(list(streams))},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1, scheduler=make()),
    ).fit()
    replay, want = make(), {}
    for lr, stream in streams.items():
        state = tune.tuner._TrialState(trial_id=str(lr), config={})
        want[lr] = next((it for it, v in enumerate(stream, 1)
                         if replay.on_result(state, v, it, it - 1) == "STOP"), len(stream))
    got = {r.config["lr"]: len(r.metrics_history) for r in grid}
    assert got == want
    assert min(want.values()) < 12  # some trial stopped early
    assert {r.config["lr"]: r.status for r in grid} == {lr: "STOPPED" for lr in streams}
    assert grid.get_best_result().config["lr"] == 0.25


def _linear_loop(config):
    """A torch regression trained for 6 steps, a checkpoint every step;
    with ``fail_at`` set, the first attempt raises after that step."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import Checkpoint

    ctx = train.get_context()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 8, generator=g)
    y = x @ torch.randn(8, generator=g)
    w = torch.zeros(8, requires_grad=True)
    opt = torch.optim.Adam([w], lr=0.05)
    start = 0
    ckpt = ctx.get_checkpoint()
    if ckpt is not None:
        state = ckpt.load_state()
        with torch.no_grad():
            w.copy_(state["params"]["w"])
        opt.load_state_dict(state["opt"])
        start = int(state["step"])
    for step in range(start, 6):
        loss = torch.mean((x @ w - y) ** 2)
        loss.backward()
        opt.step()
        opt.zero_grad()
        ckpt = Checkpoint.from_state(
            {"params": {"w": w.detach()}, "opt": opt.state_dict(), "step": step + 1},
            os.path.join(ctx.trial_dir, f"checkpoint_{step + 1:03d}"),
        )
        train.report({"step": step, "loss": loss.item()}, checkpoint=ckpt)
        if step + 1 == config["fail_at"] and ctx.get_checkpoint() is None:
            raise RuntimeError("injected failure")


def test_trainer_restore_reports_the_uninterrupted_losses(rt, tmp_path):
    from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig, TorchTrainer

    def fit(name, fail_at):
        return TorchTrainer(
            _linear_loop,
            train_loop_config={"fail_at": fail_at},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name=name, storage_path=str(tmp_path),
                                 failure_config=FailureConfig(max_failures=1)),
        ).fit()

    whole, resumed = fit("whole", 0), fit("resumed", 3)
    assert whole.error is None and resumed.error is None
    assert [m["step"] for m in whole.metrics_history] == list(range(6))
    # the second attempt resumed after step 3: its history is steps 3-5
    assert [m["step"] for m in resumed.metrics_history] == [3, 4, 5]
    assert [m["loss"] for m in resumed.metrics_history] == [
        m["loss"] for m in whole.metrics_history[3:]
    ]
    a = whole.checkpoint.load_state()["params"]["w"]
    b = resumed.checkpoint.load_state()["params"]["w"]
    assert torch.equal(a, b)
