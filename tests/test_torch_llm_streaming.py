"""Token streaming on the port: the engine's incremental generation and
cross-process streaming through a ``Channel`` from a serving actor and
through an ``ObjectRefGenerator``.

Mirror of ``tests/test_llm_streaming.py``'s four cases on
``ray_tpu_torch``: the same small model made from ``PRNGKey(2)`` by the
JAX package, its weights carried across with ``params_from_jax``, and each
stream held token-exact against the JAX engine's batch generation of the
same prompt. Runtimes and clusters schedule on the CPU
(``RAY_TPU_SCHED_PLATFORM=cpu``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.llm.continuous import ContinuousBatchingEngine as JEngine
from ray_tpu.llm.engine import GenerationConfig as JGen
from ray_tpu.models import transformer as J
from ray_tpu_torch.llm.continuous import ContinuousBatchingEngine
from ray_tpu_torch.llm.engine import GenerationConfig
from ray_tpu_torch.models import transformer as T

SMALL = dict(vocab_size=64, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96,
             max_seq_len=96)
ENGINE = dict(max_batch=2, page_size=8, n_pages=32)


@pytest.fixture(scope="module")
def small():
    cj = J.ModelConfig(dtype=jnp.float32, **SMALL)
    pj = J.init_params(cj, jax.random.PRNGKey(2))
    ct = T.ModelConfig(dtype=torch.float32, **SMALL)
    pt = T.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return cj, pj, ct, pt


@pytest.fixture()
def sched_on_cpu(monkeypatch):
    # the port's runtime and heads bring their scheduler up on cuda and
    # raise without it (agents and workers inherit the environment)
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")


def jax_greedy(small, prompt, n):
    """The JAX engine's batch generation of ``prompt``: the reference's
    tokens."""
    cj, pj, _, _ = small
    return JEngine(cj, pj, **ENGINE).generate_ids([prompt], JGen(max_new_tokens=n,
                                                                 temperature=0.0))[0]


def port_engine(small):
    _, _, ct, pt = small
    return ContinuousBatchingEngine(ct, pt, device="cpu", **ENGINE)


def test_stream_matches_batch_generation(small):
    eng = port_engine(small)
    gen = GenerationConfig(max_new_tokens=12, temperature=0.0)
    want = eng.generate_ids([[3, 5, 7]], gen)[0]
    streamed = list(eng.stream_ids([3, 5, 7], gen))
    assert streamed == want
    assert streamed == jax_greedy(small, [3, 5, 7], 12)


def test_stream_interleaves_with_other_requests(small):
    """A streaming request shares decode steps with a concurrent batch
    request: continuous batching, not exclusive occupancy."""
    eng = port_engine(small)
    gen = GenerationConfig(max_new_tokens=10, temperature=0.0)
    other = eng.submit([9, 9], gen)
    streamed = list(eng.stream_ids([1, 2, 3], gen))
    assert len(streamed) == 10
    # the other request completed during the same stepping
    assert other in eng.results
    assert streamed == jax_greedy(small, [1, 2, 3], 10)
    assert eng.results.pop(other) == jax_greedy(small, [9, 9], 10)


def test_stream_through_channel_from_actor(small, sched_on_cpu):
    """Serving pattern: an actor hosts the engine and streams token ids
    through a Channel; the caller consumes them incrementally."""
    from ray_tpu_torch.experimental import Channel

    _, _, ct, pt = small
    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4})
    ch = Channel(buffer_size_bytes=1 << 16)
    try:

        @ray_tpu_torch.remote
        class LLMServer:
            def __init__(self):
                self.engine = ContinuousBatchingEngine(ct, pt, device="cpu", **ENGINE)

            def stream_to(self, writer, prompt, max_new):
                gen = GenerationConfig(max_new_tokens=max_new, temperature=0.0)
                n = 0
                for tok in self.engine.stream_ids(list(prompt), gen):
                    writer.write(int(tok))
                    n += 1
                writer.close_channel()
                return n

        server = LLMServer.remote()
        ref = server.stream_to.remote(ch.writer, [4, 2], 8)
        tokens = list(ch.reader)
        assert len(tokens) == 8
        assert ray_tpu_torch.get(ref, timeout=120) == 8
        assert tokens == jax_greedy(small, [4, 2], 8)
    finally:
        ch.destroy()
        ray_tpu_torch.shutdown()


def test_stream_tokens_via_object_ref_generator(small, sched_on_cpu):
    """Generator-based token streaming (num_returns="streaming"): a
    cluster actor hosting the engine yields decoded tokens, each sealed
    as its own object and consumed through an ObjectRefGenerator."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    _, _, ct, pt = small

    class Engine:
        def __init__(self):
            self.engine = ContinuousBatchingEngine(ct, pt, device="cpu", **ENGINE)

        def stream(self, prompt, n):
            g = GenerationConfig(max_new_tokens=n, temperature=0.0)
            for tok in self.engine.stream_ids(prompt, g):
                yield int(tok)

        def batch(self, prompt, n):
            g = GenerationConfig(max_new_tokens=n, temperature=0.0)
            return self.engine.generate_ids([prompt], g)[0]

    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        a = ray_tpu_torch.remote(Engine).options(num_cpus=1.0).remote()
        want = ray_tpu_torch.get(a.batch.remote([3, 5, 7], 10), timeout=300)
        gen = a.stream.options(num_returns="streaming").remote([3, 5, 7], 10)
        toks = [ray_tpu_torch.get(r, timeout=300) for r in gen]
        assert toks == want
        assert toks == jax_greedy(small, [3, 5, 7], 10)
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()
