"""Serving on the card: ``build_llm_deployment`` on the local runtime with
its continuous replica on the card, held token for token against the same
engine on the CPU (f32, TF32 off), the replica's paged launches counted in
its own process; the weights hub's CUDA leaves sealed as device frames and
landed on the caller's device; a replica's variants moved to the card once,
a swap installing them with no copy and publishing them as device frames;
and the replicas' default device, the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor ray_tpu, so it runs where only the port's dependencies
are installed; there, skip the jax-importing tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_serve.py
"""
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.llm import ContinuousBatchingEngine, GenerationConfig
from ray_tpu_torch.models import transformer as T

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=258, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256,
             max_seq_len=256, dtype=torch.float32)
ENGINE = dict(max_batch=2, page_size=8, n_pages=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture
def rt(cuda):
    runtime = ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4, "GPU": 1})
    yield runtime
    import ray_tpu_torch.serve as serve

    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_deployment_streams_on_the_card_equal_the_cpu_engine(rt):
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.llm import build_llm_deployment

    cfg = T.ModelConfig(**SMALL)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    handle = serve.run(build_llm_deployment(cfg, params, name="cuda-llm", engine="continuous",
                                            **ENGINE))
    router = serve.get_router("cuda-llm")
    ray_tpu_torch.get(handle.kernel_launches.remote(True), timeout=60)
    cpu = ContinuousBatchingEngine(cfg, params, device="cpu", **ENGINE)
    for prompt in ("hello there", "a longer prompt that spans a few pages of keys"):
        got = list(router.stream({"prompt": prompt, "max_new_tokens": 16}))
        ids = cpu.stream_ids(cpu.tokenizer.encode(prompt), GenerationConfig(max_new_tokens=16))
        assert got == [cpu.tokenizer.decode([int(t)]) for t in ids]
    launches = ray_tpu_torch.get(handle.kernel_launches.remote(), timeout=60)
    assert launches["paged_attention_decode"] > 0


def test_weights_hub_lands_cuda_leaves_on_the_callers_device(cuda):
    from ray_tpu_torch.serve.model_store import WeightsHub
    from ray_tpu_torch.serve.prefix_cache import node_store

    hub = WeightsHub(node_store(), "cuda-hub")
    g = torch.Generator().manual_seed(5)
    params = {"w": torch.randn(64, 32, generator=g).to(cuda, torch.bfloat16),
              "b": torch.randn(32, generator=g)}
    assert hub.publish("m", 1, params)
    got = hub.pull("m", 1, cuda)
    assert got["w"].is_cuda and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], params["w"])
    assert got["b"].is_cuda and torch.equal(got["b"].cpu(), params["b"])
    hub._evict_locked()


def test_default_device_is_the_card(cuda):
    from ray_tpu_torch.llm.serving import build_llm_deployment

    app = build_llm_deployment(T.ModelConfig(**SMALL), engine="continuous", **ENGINE)
    server = app.deployment.func_or_class()
    assert server.engine.device.type == "cuda"


def test_a_replica_swaps_to_variants_it_holds_on_the_card(cuda):
    from ray_tpu_torch.llm.serving import build_llm_deployment

    cfg = T.ModelConfig(**SMALL)
    base = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    alt = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    app = build_llm_deployment(cfg, base, name="cuda-swap", engine="continuous",
                               variants={"m1": alt}, base_model_id="m0", **ENGINE)
    server = app.deployment.func_or_class()
    try:
        held = T.param_leaves(server._variants["m1"])
        assert all(x.is_cuda for x in held)
        assert server.swap_weights({"model": "m1"})["swapped"]
        live = T.param_leaves(server.engine.params)
        assert [x.data_ptr() for x in live] == [x.data_ptr() for x in held]
        if server._hub is not None:  # the publish sealed device frames
            pulled = T.param_leaves(server._hub.pull("m1", 0))
            assert all(x.is_cuda for x in pulled)
            assert all(torch.equal(a, b) for a, b in zip(pulled, held))
        cpu = ContinuousBatchingEngine(cfg, alt, device="cpu", **ENGINE)
        eng = server.engine
        prompt = "a prompt on the variant"
        got = eng.stream_ids(eng.tokenizer.encode(prompt), GenerationConfig(max_new_tokens=16))
        want = cpu.stream_ids(cpu.tokenizer.encode(prompt), GenerationConfig(max_new_tokens=16))
        assert list(got) == list(want)
    finally:
        if server._hub is not None:
            server._hub._evict_locked()
