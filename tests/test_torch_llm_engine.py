"""The port's dense-cache ``LLMEngine`` and ``LLMProcessor`` against the
JAX package's on the CPU: from the same weights (``params_from_jax``) and
prompts, greedy, temperature and ``top_k`` streams are token-exact over
variable-length batches, for dense and MoE models (f32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.engine import GenerationConfig as JGen
from ray_tpu.llm.engine import LLMEngine as JEngine
from ray_tpu.llm.processor import LLMProcessor as JProcessor
from ray_tpu.models import transformer as J
from ray_tpu_torch.llm import GenerationConfig, LLMEngine, LLMProcessor
from ray_tpu_torch.models import transformer as T

SMALL = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)
PROMPTS = [[1, 5, 9, 2], [3, 3, 7], [11, 12, 13, 14, 15, 16, 17], [2]]


def pair(seed=7, max_len=64, **over):
    kw = dict(SMALL, **over)
    cj = J.ModelConfig(dtype=jnp.float32, **kw)
    ct = T.ModelConfig(dtype=torch.float32, **kw)
    pj = J.init_params(cj, jax.random.PRNGKey(seed))
    pt = T.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return (JEngine(cj, pj, max_len=max_len),
            LLMEngine(ct, pt, max_len=max_len, device="cpu"))


@pytest.fixture(scope="module")
def dense():
    return pair()


@pytest.fixture(scope="module")
def moe():
    return pair(seed=3, n_experts=4)


CASES = [dict(max_new_tokens=12),
         dict(max_new_tokens=12, temperature=0.8, seed=3),
         dict(max_new_tokens=10, temperature=1.3, seed=2**32 - 7),
         dict(max_new_tokens=12, temperature=0.9, top_k=5, seed=11),
         dict(max_new_tokens=8, temperature=0.7, top_k=1, seed=1)]
IDS = ["greedy", "t0.8", "t1.3-big-seed", "top_k5", "top_k1"]


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_dense_streams_match_jax(dense, kw):
    je, te = dense
    want = je.generate_ids(PROMPTS, JGen(**kw))
    got = te.generate_ids(PROMPTS, GenerationConfig(**kw))
    assert got == want
    assert all(len(o) == kw["max_new_tokens"] for o in got)


@pytest.mark.parametrize("kw", CASES[:2] + CASES[3:4], ids=["greedy", "t0.8", "top_k5"])
def test_moe_streams_match_jax(moe, kw):
    je, te = moe
    assert te.generate_ids(PROMPTS, GenerationConfig(**kw)) == je.generate_ids(PROMPTS,
                                                                              JGen(**kw))


def test_one_prompt_and_eos(dense):
    je, te = dense
    full = te.generate_ids([PROMPTS[2]], GenerationConfig(max_new_tokens=12))[0]
    eos = full[5]
    kw = dict(max_new_tokens=12, eos_token=eos)
    got = te.generate_ids([PROMPTS[2]], GenerationConfig(**kw))
    assert got == je.generate_ids([PROMPTS[2]], JGen(**kw))
    assert got[0] == full[: full.index(eos)]


def test_max_len_caps_the_steps():
    """Generation stops at the cache's length: max_len - longest prompt - 1
    decode steps, as in the reference."""
    je, te = pair(max_len=12)
    kw = dict(max_new_tokens=20)
    got = te.generate_ids(PROMPTS, GenerationConfig(**kw))
    assert got == je.generate_ids(PROMPTS, JGen(**kw))
    assert all(len(o) == 12 - 7 for o in got)


def test_text_generate_matches_jax():
    je, te = pair(vocab_size=260)  # the byte tokenizer's ids reach 257
    kw = dict(max_new_tokens=6, temperature=0.5, seed=4)
    texts = ["hi", "hello there"]
    assert te.generate(texts, GenerationConfig(**kw)) == je.generate(texts, JGen(**kw))


def test_processor_matches_jax(monkeypatch):
    """Both processors over their own package's ``Dataset`` of the same
    rows (each on its own local runtime): the same texts, row order kept."""
    import ray_tpu
    import ray_tpu.data as jdata

    import ray_tpu_torch
    import ray_tpu_torch.data as tdata

    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
    kw = dict(SMALL, vocab_size=260)
    cj = J.ModelConfig(dtype=jnp.float32, **kw)
    ct = T.ModelConfig(dtype=torch.float32, **kw)
    pj = J.init_params(cj, jax.random.PRNGKey(9))
    pt = T.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    rows = [{"prompt": p, "id": i} for i, p in enumerate(["a", "bc", "def", "ghij", "k"])]
    gen = dict(max_new_tokens=5, temperature=0.6, seed=2)
    ray_tpu.init(num_nodes=1, resources_per_node={"CPU": 4})
    try:
        want = JProcessor(cj, pj, generation=JGen(**gen), batch_size=2, max_len=32).process(
            jdata.from_items(rows, override_num_blocks=2)).take_all()
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4})
    try:
        got = LLMProcessor(ct, pt, generation=GenerationConfig(**gen), batch_size=2, max_len=32,
                           device="cpu").process(tdata.from_items(rows, override_num_blocks=2))
        got = got.take_all()
    finally:
        ray_tpu_torch.shutdown()
    # blocks stream back in the order their tasks finish: match rows by id
    got, want = (sorted(r, key=lambda row: row["id"]) for r in (got, want))
    assert [r["id"] for r in got] == list(range(5))
    assert [r["generated_text"] for r in got] == [r["generated_text"] for r in want]


def test_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(T.ModelConfig(dtype=torch.float32, **SMALL))
