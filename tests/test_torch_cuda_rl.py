"""Online RL and rllib on the card: ``OnlineRLLoop`` in f32 on the card
(the rollouts on the paged kernel, the trainer on the flash forward, dQ and
dK/dV kernels) against the same loop on the CPU's plain path, token for
token; the trainer's gradients at the loop's 12-token rows, which the
flash wrapper pads to its block, against the CPU; and PPO's learner on the
card, its SGD step against the CPU's and its runners handed host tensors.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor ray_tpu, so it runs where only the port's dependencies
are installed; there, skip the jax-importing tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_rl.py
"""
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.ops import flash_attention as flash
from ray_tpu_torch.ops import paged_attention as paged
from ray_tpu_torch.train import pytree

pytestmark = pytest.mark.cuda

LOOP = dict(n_rollout_workers=2, prompts_per_step=2, prompt_len=6, max_new_tokens=6,
            batch_size=4, total_steps=2, seed=3, publish_interval=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _loop_run(cfg, params, device):
    from ray_tpu_torch.rl import OnlineRLLoop, RLLoopConfig

    loop = OnlineRLLoop(cfg, params, RLLoopConfig(**LOOP), device=device)
    try:
        res = loop.run()
    finally:
        loop.close()
    tokens = [np.asarray(loop.feed._step_cache[s]["tokens"]) for s in sorted(loop.feed._step_cache)]
    return res, tokens, loop


def test_rl_loop_on_the_card_equals_the_cpu(cuda):
    cfg = T.ModelConfig(dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    paged_before = paged.paged_attention_decode.launches
    fwd_before = flash.flash_attention_forward.launches
    res, tokens, loop = _loop_run(cfg, params, cuda)
    assert paged.paged_attention_decode.launches > paged_before
    # one forward, dQ and dK/dV launch a layer a train step
    assert flash.flash_attention_forward.launches - fwd_before == cfg.n_layers * 2
    assert all(t.is_cuda for t in pytree.leaves(loop.params))
    ref, ref_tokens, _ = _loop_run(cfg, params, "cpu")
    assert len(tokens) == len(ref_tokens) == 2
    for a, b in zip(tokens, ref_tokens):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=0, atol=1e-4)
    assert res["weights_epoch"] == ref["weights_epoch"] == 1
    assert res["accounting"] == ref["accounting"]


def test_trainer_gradients_at_short_rows_equal_the_cpu(cuda):
    """12-token rows (11 positions after the shift): the flash wrapper
    pads T to its block; the padded rows change neither loss nor
    gradients."""
    from ray_tpu_torch.train.programs import value_and_grad

    cfg = T.ModelConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                        d_ff=256, max_seq_len=64, dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(1, 512, (4, 12)))
    before = flash.flash_attention_bwd_dq.launches
    loss, grads = value_and_grad(lambda p: T.loss_fn(p, tokens.to(cuda), cfg),
                                 T.params_to(params, cuda))
    assert flash.flash_attention_bwd_dq.launches - before == cfg.n_layers
    ref_loss, ref_grads = value_and_grad(lambda p: T.loss_fn(p, tokens, cfg), params)
    assert abs(float(loss) - float(ref_loss)) < 1e-5
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g.cpu(), r, rtol=0, atol=1e-4)


def test_ppo_learner_on_the_card(cuda):
    from ray_tpu_torch.rllib import PPO, PPOConfig
    from ray_tpu_torch.rllib.ppo import host_copy

    rng = np.random.default_rng(5)
    adv = rng.normal(size=128).astype(np.float32)
    batch = {"obs": rng.normal(size=(128, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, 128).astype(np.int32),
             "logp": np.log(rng.uniform(0.3, 0.7, 128)).astype(np.float32),
             "advantages": (adv - adv.mean()) / (adv.std() + 1e-8),
             "returns": rng.normal(size=128).astype(np.float32)}
    out = {}
    for dev in ("cuda", "cpu"):
        algo = PPO(PPOConfig(num_env_runners=0, seed=3, device=dev))
        mb = {k: torch.from_numpy(v).to(algo.device) for k, v in batch.items()}
        out[dev] = algo._sgd_step(algo.params, algo.opt_state, mb)
    (p, o, loss, aux), (rp, ro, rloss, raux) = out["cuda"], out["cpu"]
    assert all(t.is_cuda for t in pytree.leaves(p) + pytree.leaves(o))
    np.testing.assert_allclose([float(loss), *map(float, aux)],
                               [float(rloss), *map(float, raux)], rtol=0, atol=1e-5)
    for a, b in zip(pytree.leaves(p) + pytree.leaves(o), pytree.leaves(rp) + pytree.leaves(ro)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)

    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4})
    try:
        algo = PPO(PPOConfig(num_env_runners=1, rollout_steps=64, seed=3))
        assert algo.device.type == "cuda"
        assert all(t.device.type == "cpu" for t in pytree.leaves(host_copy(algo.params)))
        r = algo.train()
        assert np.isfinite(r["total_loss"])
        assert all(t.is_cuda for t in pytree.leaves(algo.params) + pytree.leaves(algo.opt_state))
    finally:
        ray_tpu_torch.shutdown()
