"""The port's data layer feeding the card: a shuffled dataset's batches
landed on the card, ``TorchTrainer(datasets=...)`` training on the flash
kernels from its shards, and ``LLMProcessor`` over a dataset on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor ray_tpu, so it runs where only the port's dependencies
are installed; there, skip the jax-importing tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_data.py
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.data as rd
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.ops import flash_attention as flash

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=256,
             max_seq_len=128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rt = ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4.0, "GPU": 1.0})
    assert rt.device_state.device.type == "cuda"
    yield torch.device("cuda")
    ray_tpu_torch.shutdown()


def _replay(blocks, seed):
    from ray_tpu_torch.data.shuffle import _partition_block, _reduce_shuffled

    n = len(blocks)
    maps = [_partition_block._fn(b, n, "random", None, None, seed + i) for i, b in enumerate(blocks)]
    return np.concatenate([_reduce_shuffled._fn(seed, *[m[p] for m in maps]) for p in range(n)])


def test_cuda_shuffled_batches_land_on_the_card(cuda):
    n = 200_000
    ds = rd.from_numpy_blocks(np.arange(n, dtype=np.float64), override_num_blocks=8)
    ds = ds.random_shuffle(seed=3)
    landed = torch.cat([torch.tensor(b["data"], device=cuda)
                        for b in ds.iter_batches(batch_size=10_000, prefetch_batches=2)])
    assert landed.is_cuda
    assert torch.equal(torch.sort(landed).values, torch.arange(n, dtype=torch.float64, device=cuda))
    assert landed.sum().item() == n * (n - 1) / 2
    want = _replay(np.array_split(np.arange(n, dtype=np.float64), 8), 3)
    assert torch.equal(landed.cpu(), torch.from_numpy(want))


def _steps(batches, seed):
    cfg = T.ModelConfig(**SMALL)
    dev = torch.device("cuda")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    leaves = [x.requires_grad_() for x in T.param_leaves(params)]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    step = T.make_train_step(cfg, opt)
    losses, digests = [], []
    for b in batches:
        digests += [hashlib.sha1(r.tobytes()).hexdigest() for r in b["data"]]
        tokens = torch.tensor(b["data"], device=dev).long()
        assert tokens.is_cuda and all(x.is_cuda for x in leaves)
        losses.append(step(params, tokens).item())
    return losses, digests


def _loop(config):
    from ray_tpu_torch import train

    rank = train.get_context().get_world_rank()
    losses, digests = _steps(train.get_dataset_shard("train").iter_batches(batch_size=4), 5)
    with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as f:
        json.dump(dict(losses=losses, digests=digests), f)
    train.report({"steps": len(losses)})


def test_cuda_trainer_ingest_on_the_flash_kernels(cuda, tmp_path):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    table = np.random.default_rng(9).integers(0, SMALL["vocab_size"], (48, 65), dtype=np.int32)
    ds = rd.from_numpy_blocks(table, override_num_blocks=4).random_shuffle(seed=2)
    flash.flash_attention_forward.launches = 0
    flash.flash_attention_bwd_dq.launches = flash.flash_attention_bwd_dkv.launches = 0
    res = TorchTrainer(
        _loop, train_loop_config={"out": str(tmp_path)},
        scaling_config=ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1.0, "GPU": 0.5}),
        run_config=RunConfig(name="cuda-data", storage_path=str(tmp_path)),
        datasets={"train": ds},
    ).fit()
    assert res.error is None, res.error
    launches = (flash.flash_attention_forward.launches, flash.flash_attention_bwd_dq.launches,
                flash.flash_attention_bwd_dkv.launches)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    steps = sum(len(r["losses"]) for r in ranks)
    assert launches == (SMALL["n_layers"] * steps,) * 3
    seen = [set(r["digests"]) for r in ranks]
    assert not seen[0] & seen[1]
    assert seen[0] | seen[1] == {hashlib.sha1(r.tobytes()).hexdigest() for r in table}
    for r, shard in zip(ranks, ds.split(2)):
        losses, digests = _steps(shard.iter_batches(batch_size=4), 5)
        assert digests == r["digests"] and losses == r["losses"]


def test_cuda_processor_over_a_dataset(cuda):
    pytest.importorskip("pyarrow")
    from ray_tpu_torch.llm import GenerationConfig, LLMEngine, LLMProcessor

    cfg = T.ModelConfig(**dict(SMALL, vocab_size=260), dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(4), cuda)
    prompts = [f"prompt {i}" for i in range(6)]
    gen = GenerationConfig(max_new_tokens=6)
    rows = LLMProcessor(cfg, params, generation=gen, batch_size=3, max_len=64,
                        device="cuda").process(
        rd.from_items([{"prompt": p} for p in prompts], override_num_blocks=2)).take_all()
    want = LLMEngine(cfg, params, max_len=64, device="cuda").generate(prompts, gen)
    assert {r["prompt"]: r["generated_text"] for r in rows} == dict(zip(prompts, want))
