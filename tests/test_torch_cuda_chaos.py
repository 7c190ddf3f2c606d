"""The chaos harness on the card: ``chip_smoke.py``'s ``phase_chaos_serve``
replica-kill plan alone, at a small width. A ``Cluster`` whose head
schedules on the card and whose two agents share it, a continuous
``build_llm_deployment`` of 2 f32 replicas on the card (TF32 off),
``ServeStreamWorkload`` streams held token for token against the same
engine on the CPU, and ``make_plan(11, 2, SERVE_MIX,
allow=("replica_kill",))`` under ``ChaosOrchestrator``: the run ``ok``,
every stream exact, the replica set backfilled to 2, each backfilled
replica launching the paged kernel in its own process, no arena zombie.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor ray_tpu, so it runs where only the port's dependencies
are installed; there, skip the jax-importing tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_chaos.py
"""
import time

import pytest
import torch

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=258, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256,
             max_seq_len=256, dtype=torch.float32)
ENGINE = dict(max_batch=2, page_size=8, n_pages=64)


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"{what}: not within {timeout:.0f} s"
        time.sleep(0.2)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.delenv("RAY_TPU_SCHED_PLATFORM", raising=False)  # the card
    monkeypatch.setenv("NVIDIA_TF32_OVERRIDE", "0")  # the replicas' f32 stays f32
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def test_replica_kills_mid_stream_recover_on_the_card(cuda):
    import ray_tpu_torch
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.chaos import (
        SERVE_MIX,
        ChaosOrchestrator,
        ChaosWorkload,
        ServeStreamWorkload,
        make_plan,
    )
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.llm import ContinuousBatchingEngine, GenerationConfig, build_llm_deployment
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.serve.deployment import _apps

    cfg = T.ModelConfig(**SMALL)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt, max_new = "chaos stream", 10
    eng = ContinuousBatchingEngine(cfg, params, device="cpu", **ENGINE)
    gen = GenerationConfig(max_new_tokens=max_new, temperature=0.0, seed=0)
    expected = [eng.tokenizer.decode([int(t)])
                for t in eng.stream_ids(eng.tokenizer.encode(prompt), gen)]
    c = Cluster()
    assert c.head.device_state.device.type == "cuda"
    c.add_node({"CPU": 4.0, "GPU": 1.0}, num_workers=3, wait=False)
    c.add_node({"CPU": 4.0, "GPU": 1.0}, num_workers=3, wait=False)
    c.wait_for_nodes(2)
    rt = c.client()
    set_runtime(rt)
    workload = None
    try:
        serve.run(build_llm_deployment(cfg, params, name="chaos-card", num_replicas=2,
                                       engine="continuous", ray_actor_options={"num_gpus": 0.25},
                                       **ENGINE))
        router = serve.get_router("chaos-card")

        def replicas():
            rs = _apps["chaos-card"]
            with rs.lock:
                return [r.actor for r in rs.replicas]

        first = {a._actor_id for a in replicas()}
        workload = ServeStreamWorkload(router, {"prompt": prompt, "max_new_tokens": max_new},
                                       expected, concurrency=2)
        workload.start()
        _wait(lambda: workload.completed >= 2 or workload.verify_failures, 180.0, "warm streams")
        assert not workload.verify_failures, workload.verify_failures
        plan = make_plan(seed=11, num_faults=2, mix=SERVE_MIX, allow=("replica_kill",),
                         min_delay_s=0.5, max_delay_s=1.0)
        assert plan.counts() == {"replica_kill": 2}
        orch = ChaosOrchestrator(c, ChaosWorkload(rt, payload_bytes=150_000, num_actors=1),
                                 plan, node_resources={"CPU": 4.0}, convergence_budget_s=120.0,
                                 serve_adapter=workload)
        result = orch.run()
        assert result.ok, result.summary()
        assert not workload.verify_failures, workload.verify_failures
        assert workload.completed >= 3
        assert workload.live_replicas() == 2
        fresh = [a for a in replicas() if a._actor_id not in first]
        assert fresh, "no replica was backfilled"

        def launched():
            return all(ray_tpu_torch.get(a.kernel_launches.remote(False), timeout=60)
                       ["paged_attention_decode"] > 0 for a in fresh)

        _wait(launched, 60.0, "a backfilled replica launching the paged kernel")
        assert result.arena_zombies_after == 0
    finally:
        if workload is not None:
            workload.stop()
        serve.shutdown()
        set_runtime(None)
        rt.shutdown()
        c.shutdown()
