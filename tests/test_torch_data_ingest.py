"""Real ingest into the port's libraries on the CPU: ``Dataset`` pipelines,
``TorchTrainer(datasets=...)`` with its ``DataIterator``, and
``LLMProcessor`` over a ``Dataset``.

Mirrors the data cases of ``tests/test_libraries.py`` and
``tests/test_llm.py::test_batch_processor_over_dataset`` on
``ray_tpu_torch`` with the same assertions, then holds the port against the
JAX package on the same inputs: a trainer's rank reads the same rows in the
same order as ``JaxTrainer``'s, ``DataIterator`` asks for the same prefetch
depth (``cfg.data_prefetch_batches``), and the processor's texts equal
``LLMEngine.generate``'s on the same prompts.
"""
import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.data as rdata


@pytest.fixture(autouse=True)
def _cpu_scheduler(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")


@pytest.fixture()
def rt(_cpu_scheduler):
    rt = ray_tpu_torch.init(num_nodes=2, resources_per_node={"CPU": 8, "memory": float(1 << 30)})
    yield rt
    ray_tpu_torch.shutdown()


def test_dataset_pipeline(rt):
    ds = rdata.range(100, override_num_blocks=8).map(lambda x: x * 2).filter(lambda x: x % 8 == 0)
    got = sorted(ds.take_all())
    assert got == sorted(x * 2 for x in range(100) if (x * 2) % 8 == 0)
    assert ds.count() == len(got)


def test_dataset_map_batches_numpy(rt):
    ds = rdata.range(64, override_num_blocks=4).map_batches(
        lambda batch: {"data": batch["data"] + 1}, batch_size=16)
    assert sorted(ds.take_all()) == list(range(1, 65))


def test_dataset_split_and_batches(rt):
    ds = rdata.from_items([{"x": i, "y": i * i} for i in range(32)])
    shards = ds.split(4)
    assert sum(s.count() for s in shards) == 32
    batches = list(ds.iter_batches(batch_size=8))
    assert len(batches) == 4
    assert batches[0]["x"].shape == (8,)


def _ingest_loop(config):
    """Each rank reads its shard through ``get_dataset_shard`` at the
    default prefetch depth and reports the rows in the order it saw them."""
    import importlib

    train = importlib.import_module(config["pkg"] + ".train")
    rows = []
    for batch in train.get_dataset_shard("train").iter_batches(batch_size=48):
        rows += np.asarray(batch["data"]).tolist()
    train.report({"rows": rows, "rank": train.get_context().get_world_rank()})


def _fit(pkg_name, mod, trainer_name):
    import importlib

    data = importlib.import_module(pkg_name + ".data")
    train = importlib.import_module(pkg_name + ".train")
    mod.init(num_nodes=2, resources_per_node={"CPU": 4})
    try:
        ds = data.from_numpy_blocks(
            np.random.default_rng(5).standard_normal(1000), override_num_blocks=6
        ).random_shuffle(seed=4)
        res = getattr(train, trainer_name)(
            _ingest_loop, train_loop_config={"pkg": pkg_name},
            scaling_config=train.ScalingConfig(num_workers=2), datasets={"train": ds},
        ).fit()
        assert res.error is None, res.error
        return res.metrics
    finally:
        mod.shutdown()


def test_trainer_shard_rows_equal_the_reference():
    import ray_tpu

    got = _fit("ray_tpu_torch", ray_tpu_torch, "TorchTrainer")
    want = _fit("ray_tpu", ray_tpu, "JaxTrainer")
    assert got["rank"] == want["rank"] == 0
    assert 0 < len(got["rows"]) < 1000
    assert got["rows"] == want["rows"]


class _Shard:
    """Records what ``DataIterator`` asks of its shard."""

    def iter_batches(self, **kw):
        self.kw = kw
        return iter(())


@pytest.mark.parametrize("env", [None, "0", "5"])
def test_data_iterator_prefetch_equals_the_reference(monkeypatch, env):
    from ray_tpu.train.session import DataIterator as RefIterator

    from ray_tpu_torch.train.session import DataIterator

    if env is not None:
        monkeypatch.setenv("RAY_TPU_DATA_PREFETCH_BATCHES", env)
    got, want = _Shard(), _Shard()
    DataIterator(got).iter_batches(batch_size=7)
    RefIterator(want).iter_batches(batch_size=7)
    assert got.kw == want.kw
    assert got.kw["prefetch_batches"] == (2 if env is None else int(env))


def test_batch_processor_over_dataset(rt):
    from ray_tpu_torch.llm import GenerationConfig, LLMEngine, LLMProcessor
    from ray_tpu_torch.models import transformer as tfm

    cfg = tfm.ModelConfig(vocab_size=258, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_ff=64, max_seq_len=128, dtype=torch.float32)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = [f"item {i}" for i in range(8)]
    ds = rdata.from_items([{"prompt": p} for p in prompts], override_num_blocks=2)
    gen = GenerationConfig(max_new_tokens=4)
    proc = LLMProcessor(cfg, params, generation=gen, batch_size=4, max_len=64, device="cpu")
    rows = proc.process(ds).take_all()
    assert len(rows) == 8
    assert all("generated_text" in r for r in rows)
    want = LLMEngine(cfg, params, max_len=64, device="cpu").generate(prompts, gen)
    # blocks stream back in the order their tasks finish: match rows by prompt
    assert sorted(r["prompt"] for r in rows) == sorted(prompts)
    assert {r["prompt"]: r["generated_text"] for r in rows} == dict(zip(prompts, want))
